"""Healthcheck helper (``pkg/healthcheck/helper.go``).

The port's own copy of the reference's
``testground_tpu/healthcheck/helper.py`` (ROADMAP's copy policy);
``tests/test_torch_cli.py`` pins it against the original.
"""

from __future__ import annotations

from typing import Callable

from ..rpc import OutputWriter, discard_writer

from .report import ABORTED, FAILED, OK, OMITTED, CheckResult, Report

__all__ = ["Helper"]

# A Checker returns (ok: bool, message: str). A Fixer returns a message and
# raises on failure.
Checker = Callable[[], tuple[bool, str]]
Fixer = Callable[[], str]


class Helper:
    def __init__(self):
        self._items: list[tuple[str, Checker, Fixer | None]] = []

    def enlist(self, name: str, checker: Checker, fixer: Fixer | None = None) -> None:
        """(``helper.go:55-60`` Enlist)."""
        self._items.append((name, checker, fixer))

    def run_checks(self, fix: bool, ow: OutputWriter | None = None) -> Report:
        """Evaluate all checks; when ``fix`` is set, run the fixer for failed
        checks and re-check (``helper.go:61-110`` RunChecks)."""
        ow = ow or discard_writer()
        report = Report()
        for name, checker, fixer in self._items:
            try:
                ok, msg = checker()
            except Exception as e:  # noqa: BLE001
                ok, msg = False, str(e)
            if ok:
                report.checks.append(CheckResult(name, OK, msg))
                report.fixes.append(CheckResult(name, OMITTED, "check passed"))
                continue
            report.checks.append(CheckResult(name, FAILED, msg))
            if not fix:
                report.fixes.append(CheckResult(name, OMITTED, "fix not requested"))
                continue
            if fixer is None:
                report.fixes.append(CheckResult(name, ABORTED, "no fixer"))
                continue
            try:
                fix_msg = fixer()
            except Exception as e:  # noqa: BLE001
                report.fixes.append(CheckResult(name, FAILED, str(e)))
                continue
            # re-check after fixing
            try:
                ok2, msg2 = checker()
            except Exception as e:  # noqa: BLE001
                ok2, msg2 = False, str(e)
            status = OK if ok2 else FAILED
            report.fixes.append(CheckResult(name, status, fix_msg or msg2))
            if ok2:
                report.checks[-1] = CheckResult(name, OK, "fixed")
            ow.infof("healthcheck %s: fixed=%s", name, ok2)
        return report
