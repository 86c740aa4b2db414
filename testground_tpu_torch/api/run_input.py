"""Run and build inputs and outputs — the port's own copies of the
reference's ``RunGroup``, ``RunInput``, ``RunOutput``, ``BuildInput`` and
``BuildOutput`` and ``CollectionInput`` (``testground_tpu/api/run_input.py``).

``RunInput.env`` is the port's :class:`~testground_tpu_torch.config.EnvConfig`
when a run comes through the runner; a library caller may pass anything
whose ``dirs.outputs()`` names the outputs root (:class:`OutputsEnv` is the
smallest such thing, with no Influx endpoint). A run then writes
``<root>/<plan>/<run_id>``, the reference's layout.
"""

from __future__ import annotations

import types
from dataclasses import dataclass, field
from typing import Any

from .composition import Resources

__all__ = [
    "BuildInput",
    "BuildOutput",
    "CollectionInput",
    "OutputsEnv",
    "RunGroup",
    "RunInput",
    "RunOutput",
]


@dataclass
class RunGroup:
    """One group's slice of a run (``pkg/api/runner.go:65-85``)."""

    id: str
    instances: int
    artifact_path: str = ""
    builder: str = ""
    parameters: dict[str, str] = field(default_factory=dict)
    profiles: dict[str, str] = field(default_factory=dict)
    resources: Resources = field(default_factory=Resources)
    faults: list = field(default_factory=list)
    trace: dict = field(default_factory=dict)
    slo: list = field(default_factory=list)

    def to_dict(self) -> dict:
        return {
            "id": self.id,
            "instances": self.instances,
            "artifact_path": self.artifact_path,
            "builder": self.builder,
            "parameters": dict(self.parameters),
            "profiles": dict(self.profiles),
            "resources": self.resources.to_dict(),
            "faults": [dict(f) for f in self.faults],
            "trace": dict(self.trace),
            "slo": [dict(s) for s in self.slo],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "RunGroup":
        return cls(
            id=d["id"],
            instances=int(d["instances"]),
            artifact_path=d.get("artifact_path", ""),
            builder=d.get("builder", ""),
            parameters=dict(d.get("parameters", {})),
            profiles=dict(d.get("profiles", {})),
            resources=Resources.from_dict(d.get("resources", {})),
            faults=[dict(f) for f in d.get("faults", [])],
            trace=dict(d.get("trace", {})),
            slo=[dict(s) for s in d.get("slo", [])],
        )


@dataclass
class RunInput:
    """Input options for running one test run (``pkg/api/runner.go:36-63``)."""

    run_id: str
    test_plan: str
    test_case: str
    total_instances: int
    groups: list[RunGroup] = field(default_factory=list)
    runner_config: Any = None
    disable_metrics: bool = False
    # run-global fault schedule, flight-recorder table and SLO rules
    # ([[global.run.faults]], [global.run.trace], [[global.run.slo]])
    faults: list = field(default_factory=list)
    trace: dict = field(default_factory=dict)
    slo: list = field(default_factory=list)
    # lifecycle trace context ({"trace_id", "parent_id", "task_id",
    # "traceparent"}) for the spans
    trace_ctx: dict = field(default_factory=dict)
    # EnvConfig, or anything with ``dirs.outputs()``; None runs without an
    # outputs dir
    env: Any = None
    # the fleet controller's preemption signal (engine/controller.py): a
    # threading.Event the supervisor arms to stop the run at a chunk
    # boundary for a live migration. Process-local, like env
    preempt: Any = None

    def to_dict(self) -> dict:
        """The wire form (the runner config, env and preempt are not part
        of it)."""
        return {
            "run_id": self.run_id,
            "test_plan": self.test_plan,
            "test_case": self.test_case,
            "total_instances": self.total_instances,
            "groups": [g.to_dict() for g in self.groups],
            "disable_metrics": self.disable_metrics,
            "faults": [dict(f) for f in self.faults],
            "trace": dict(self.trace),
            "slo": [dict(s) for s in self.slo],
            "trace_ctx": dict(self.trace_ctx),
        }


@dataclass
class RunOutput:
    """Output from a run (``pkg/api/runner.go:87-102``)."""

    run_id: str
    composition: Any = None
    result: Any = None


@dataclass
class CollectionInput:
    """Input for collecting a run's outputs (``pkg/api/runner.go:104-114``)."""

    run_id: str
    runner_id: str
    runner_config: Any = None
    env: Any = None


@dataclass
class BuildInput:
    """Input options for building a test plan (``pkg/api/builder.go:29-58``)."""

    build_id: str
    test_plan: str
    unpacked_plan_dir: str = ""
    unpacked_sdk_dir: str = ""
    selectors: list[str] = field(default_factory=list)
    dependencies: dict[str, tuple[str, str]] = field(default_factory=dict)
    build_config: Any = None
    env: Any = None


@dataclass
class BuildOutput:
    """Output from a build (``pkg/api/builder.go:60-75``)."""

    builder_id: str
    artifact_path: str
    dependencies: dict[str, str] = field(default_factory=dict)


class OutputsEnv:
    """The smallest ``RunInput.env``: an outputs root and nothing else
    (no Influx endpoint)."""

    def __init__(self, outputs_root: str):
        root = str(outputs_root)
        self.dirs = types.SimpleNamespace(outputs=lambda: root)
