"""``sim:plan`` builder: snapshot a plan's simulation program for the
``sim:torch`` runner — the port's copy of ``build`` and ``purge`` of the
reference's ``testground_tpu/builders/sim_plan.py``.

The runner executes plans as per-tick state machines over torch tensors,
not processes, so the "artifact" is a snapshot of the plan source dir
(``<work>/sim-plan--<plan>-<build_id>``), which the executor loads with
``load_sim_testcases`` as it loads the package's own plan directory (the
port's plans import ``testground_tpu_torch`` absolutely). Queued runs are
immune to source edits.

``_source_digest`` is the reference's digest of a plan snapshot's Python
sources, the part of a checkpoint's ``build_key`` that refuses a resume
after a plan edit (``sim/checkpoint.py``).
"""

from __future__ import annotations

import hashlib
import os
import shutil
import threading

from ..api import BuildInput, BuildOutput
from ..rpc import OutputWriter
from .base import Builder, purge_snapshots

__all__ = ["SimPlanBuilder"]


def _source_digest(artifact_dir: str) -> str:
    """Digest of the snapshot's Python sources (path + contents)
    (``builders/sim_plan.py:27-40`` of the reference)."""
    h = hashlib.sha256()
    for root, dirs, files in os.walk(artifact_dir):
        dirs.sort()
        for name in sorted(files):
            if not name.endswith(".py"):
                continue
            path = os.path.join(root, name)
            h.update(os.path.relpath(path, artifact_dir).encode())
            with open(path, "rb") as f:
                h.update(f.read())
    return h.hexdigest()


class SimPlanBuilder(Builder):
    def id(self) -> str:
        return "sim:plan"

    def build(
        self, inp: BuildInput, ow: OutputWriter, cancel: threading.Event
    ) -> BuildOutput:
        src = inp.unpacked_plan_dir
        if not src or not os.path.isdir(src):
            raise ValueError(f"plan sources not found: {src!r}")
        if not (
            os.path.isfile(os.path.join(src, "sim.py"))
            or os.path.isfile(os.path.join(src, "main.py"))
        ):
            raise ValueError(
                f"plan has neither sim.py nor main.py entry point: {src}"
            )
        work = inp.env.dirs.work()
        dest = os.path.join(work, f"sim-plan--{inp.test_plan}-{inp.build_id}")
        if os.path.exists(dest):
            shutil.rmtree(dest)
        shutil.copytree(
            src,
            dest,
            ignore=shutil.ignore_patterns(
                "__pycache__", "*.pyc", ".git", "_compositions"
            ),
        )
        ow.infof("sim:plan built %s -> %s", inp.test_plan, dest)
        return BuildOutput(builder_id=self.id(), artifact_path=dest)

    def purge(self, testplan: str, ow: OutputWriter, env=None) -> None:
        removed = purge_snapshots("sim-plan", testplan, ow, env)
        ow.infof("sim:plan purge: removed %d snapshot(s)", removed)
