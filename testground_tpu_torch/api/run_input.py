"""One group's slice of a run — the port's own copy of the reference
``RunGroup`` (``testground_tpu/api/run_input.py``), without the fields that
need the composition types (``resources``)."""

from __future__ import annotations

from dataclasses import dataclass, field

__all__ = ["RunGroup"]


@dataclass
class RunGroup:
    """One group's slice of a run (``pkg/api/runner.go:65-85``)."""

    id: str
    instances: int
    artifact_path: str = ""
    builder: str = ""
    parameters: dict[str, str] = field(default_factory=dict)
    profiles: dict[str, str] = field(default_factory=dict)
    faults: list = field(default_factory=list)
    trace: dict = field(default_factory=dict)
    slo: list = field(default_factory=list)
