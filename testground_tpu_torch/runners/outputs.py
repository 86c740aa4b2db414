"""The per-instance outputs layout — the port's copy of the reference's
``instance_output_dir`` (``testground_tpu/runners/outputs.py``): a run
writes ``<outputs>/<plan>/<run-id>/<group>/<instance>/`` with ``run.out``
and ``metrics.out`` (``local_docker.go:258-267``)."""

from __future__ import annotations

import os

__all__ = ["instance_output_dir"]


def instance_output_dir(
    outputs_root: str, plan: str, run_id: str, group: str, instance: int
) -> str:
    return os.path.join(outputs_root, plan, run_id, group, str(instance))
