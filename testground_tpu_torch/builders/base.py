"""Builder interface (``pkg/api/builder.go:14-26``) — the port's copy of
the reference's ``testground_tpu/builders/base.py``, without
``snapshot_plan_sources``, which only the ``exec:*`` builders use, and the
``Precompiler`` capability, since the reference's precompile fills XLA's
compile cache and the port has no such cache."""

from __future__ import annotations

import abc
import os
import re
import shutil
import threading

from ..api import BuildInput, BuildOutput
from ..rpc import OutputWriter
from ..runners.base import Terminatable

__all__ = ["Builder", "purge_snapshots"]


def purge_snapshots(prefix: str, testplan: str, ow: OutputWriter, env) -> int:
    """Delete every ``<work>/<prefix>--<testplan>-<build-id>`` snapshot —
    the shared artifact naming of the snapshot builders. Returns the count
    removed; a missing env (interface parity callers) removes nothing."""
    if env is None:
        return 0
    work = env.dirs.work()
    if not os.path.isdir(work):
        return 0
    # exact plan match: build ids are 20-char xids (engine/task.py), with
    # an optional per-group suffix — a bare prefix match would also claim
    # plans whose names extend this one (net vs net-v2)
    pat = re.compile(
        rf"^{re.escape(prefix)}--{re.escape(testplan)}"
        rf"-[a-z0-9]{{20}}(-\d+)?$"
    )
    removed = 0
    for name in os.listdir(work):
        if not pat.match(name):
            continue
        path = os.path.join(work, name)
        try:
            shutil.rmtree(path)
        except OSError as e:
            ow.warn("could not purge %s: %s", name, e)
            continue
        ow.infof("purged %s", name)
        removed += 1
    return removed


class Builder(Terminatable, abc.ABC):
    """A builder takes a test plan and builds it into executable form so it
    can be scheduled by a runner.

    Builders are Terminatable so ``tg terminate --builder`` succeeds (the
    reference's DoTerminate accepts builders, ``engine.go:285-311``); the
    snapshot builders run synchronously inside the worker with no external
    jobs, so the default terminate is a no-op report — mirroring the
    runners' no-op implementations."""

    def terminate_all(self, ow: OutputWriter) -> None:
        ow.infof("builder %s has no external jobs to terminate", self.id())

    @abc.abstractmethod
    def id(self) -> str: ...

    @abc.abstractmethod
    def build(
        self, inp: BuildInput, ow: OutputWriter, cancel: threading.Event
    ) -> BuildOutput: ...

    def purge(self, testplan: str, ow: OutputWriter, env=None) -> None:
        """Drop cached artifacts for one plan (``api.Builder.Purge``,
        ``pkg/api/builder.go:14-26``). ``env`` is the engine's EnvConfig —
        builders locate their snapshots under its work dir."""

    def config_type(self) -> type | None:
        return None
