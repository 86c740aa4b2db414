"""Run-output collection — the port's copy of the reference's
``testground_tpu/runners/outputs.py``.

Twin of ``pkg/runner/common.go:42-116``: walk
``<outputs>/<plan>/<run-id>`` and stream it as a gzipped tarball. The on-disk
layout written by runners is ``<outputs>/<plan>/<run-id>/<group>/<instance>/``
with ``run.out`` / ``run.err`` / ``metrics.out`` files
(``local_docker.go:258-267``).
"""

from __future__ import annotations

import os
import tarfile
from typing import BinaryIO

__all__ = ["collect_run_outputs", "instance_output_dir", "find_run_dir"]


def instance_output_dir(
    outputs_root: str, plan: str, run_id: str, group: str, instance: int
) -> str:
    return os.path.join(outputs_root, plan, run_id, group, str(instance))


def find_run_dir(outputs_root: str, run_id: str) -> str | None:
    """Locate ``<outputs>/<plan>/<run-id>`` without knowing the plan."""
    if not os.path.isdir(outputs_root):
        return None
    for plan in sorted(os.listdir(outputs_root)):
        cand = os.path.join(outputs_root, plan, run_id)
        if os.path.isdir(cand):
            return cand
    return None


def collect_run_outputs(outputs_root: str, run_id: str, w: BinaryIO) -> None:
    """Write a tar.gz of the run's output tree to ``w``. Entries are rooted
    at ``<run-id>/...`` so extraction produces one directory per run."""
    run_dir = find_run_dir(outputs_root, run_id)
    if run_dir is None:
        raise FileNotFoundError(f"no outputs found for run {run_id}")
    with tarfile.open(fileobj=w, mode="w:gz") as tar:
        tar.add(run_dir, arcname=run_id)
