"""Builder interface (``pkg/api/builder.go:14-26``) — the port's copy of
the reference's ``testground_tpu/builders/base.py``, with its
``Precompiler`` capability: an explicit build task also warms what the run
will need (``builders/sim_plan.py``), BuildKey-deduped by a marker."""

from __future__ import annotations

import abc
import os
import re
import shutil
import threading

from ..api import BuildInput, BuildOutput
from ..rpc import OutputWriter
from ..runners.base import Terminatable

__all__ = ["Builder", "Precompiler", "purge_snapshots", "snapshot_plan_sources"]

# Paths never copied into a build snapshot (caches, VCS, fixtures).
_SNAPSHOT_IGNORE = ("__pycache__", "*.pyc", ".git", "_compositions")


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


def snapshot_plan_sources(src: str | None, dest: str) -> None:
    """Copy plan sources into an immutable build snapshot at ``dest``
    (replacing any previous snapshot), so later source edits don't mutate
    queued runs. Shared by the exec:* builders."""
    if not src or not os.path.isdir(src):
        raise ValueError(f"plan sources not found: {src!r}")
    if os.path.exists(dest):
        shutil.rmtree(dest)
    shutil.copytree(
        src, dest, ignore=shutil.ignore_patterns(*_SNAPSHOT_IGNORE)
    )


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


class Precompiler(abc.ABC):
    """A builder whose artifact includes a warmed program.

    The reference's expensive artifact production happens at *build* time,
    BuildKey-deduped (``pkg/engine/supervisor.go:359-364``; go-build cache
    ``pkg/build/docker_go.go:266-283``). The port's one compiled artifact
    is the kernel library (``sim/cuda_transport.py``): an explicit build
    task builds it, and steps each of the composition's programs once on
    the run's device, so that a later run of the same composition starts
    warm; a marker per program (``<compile cache>/precompiled/<key>.json``)
    makes a rebuild a cache hit."""

    @abc.abstractmethod
    def precompile(
        self,
        comp,
        manifest,
        env,
        ow: OutputWriter,
        cancel: threading.Event,
    ) -> None: ...
