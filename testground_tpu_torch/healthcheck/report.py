"""Healthcheck report types (``pkg/api/healthcheck.go:17-56``).

The port's own copy of the reference's
``testground_tpu/healthcheck/report.py`` (ROADMAP's copy policy);
``tests/test_torch_cli.py`` pins it against the original.
"""

from __future__ import annotations

from dataclasses import dataclass, field

__all__ = ["CheckResult", "Report"]

# check statuses
OK = "ok"
FAILED = "failed"
ABORTED = "aborted"
OMITTED = "omitted"


@dataclass
class CheckResult:
    name: str
    status: str
    message: str = ""

    def to_dict(self) -> dict:
        return {"name": self.name, "status": self.status, "message": self.message}


@dataclass
class Report:
    checks: list[CheckResult] = field(default_factory=list)
    fixes: list[CheckResult] = field(default_factory=list)

    def ok(self) -> bool:
        return all(c.status == OK for c in self.checks) and all(
            f.status in (OK, OMITTED) for f in self.fixes
        )

    def to_dict(self) -> dict:
        return {
            "checks": [c.to_dict() for c in self.checks],
            "fixes": [f.to_dict() for f in self.fixes],
        }

    def __str__(self) -> str:
        lines = []
        for c in self.checks:
            lines.append(f"check {c.name}: {c.status} {c.message}".rstrip())
        for f in self.fixes:
            lines.append(f"fix   {f.name}: {f.status} {f.message}".rstrip())
        return "\n".join(lines)
