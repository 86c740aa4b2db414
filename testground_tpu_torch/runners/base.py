"""Runner interface — the port's copy of the reference's
``testground_tpu/runners/base.py`` (``pkg/api/runner.go:17-34``), without
``RunnerOutcomeError``, which only the ``local:exec`` runner raises."""

from __future__ import annotations

import abc
import threading
from typing import BinaryIO

from ..api import CollectionInput, RunInput, RunOutput
from ..rpc import OutputWriter

__all__ = ["HealthcheckedRunner", "Runner", "Terminatable"]


class Runner(abc.ABC):
    """A runner takes a test plan in executable form and schedules a run of a
    particular test case within it."""

    @abc.abstractmethod
    def id(self) -> str:
        """Canonical identifier, e.g. ``sim:torch``."""

    @abc.abstractmethod
    def run(
        self, job: RunInput, ow: OutputWriter, cancel: threading.Event
    ) -> RunOutput:
        """Run a test case. ``cancel`` is set on kill/timeout; runners must
        poll it (the Python analog of the reference's ctx cancellation)."""

    @abc.abstractmethod
    def compatible_builders(self) -> list[str]:
        """Builder IDs whose artifacts this runner can work with."""

    def config_type(self) -> type | None:
        """Dataclass type for this runner's config, or None."""
        return None

    def collect_outputs(
        self, inp: CollectionInput, w: BinaryIO, ow: OutputWriter
    ) -> None:
        """Gather outputs from a run into a tar.gz written to ``w``
        (default layout collection lives in ``runners.outputs``)."""
        from .outputs import collect_run_outputs

        collect_run_outputs(inp.env.dirs.outputs(), inp.run_id, w)


class Terminatable(abc.ABC):
    """Optional runner capability (``pkg/api/runner.go:117-121``)."""

    @abc.abstractmethod
    def terminate_all(self, ow: OutputWriter) -> None: ...


class HealthcheckedRunner(abc.ABC):
    """Optional runner capability (``pkg/api/engine.go`` Healthchecker)."""

    @abc.abstractmethod
    def healthcheck(self, fix: bool, ow: OutputWriter, env=None, config=None):
        """Returns a healthcheck report (``pkg/api/healthcheck.go:17-56``).
        ``env`` is the engine's EnvConfig — checks must validate the home
        the runs will actually use, not re-resolve $TESTGROUND_HOME.
        ``config`` is the run's coalesced runner config when a run asks,
        so the checks probe what that run will use; None outside a run."""
