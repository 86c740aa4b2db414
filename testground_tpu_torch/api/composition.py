"""Composition spec types.

A composition describes *what to run*: the test plan and case, the instance
groups that participate (with build and run configuration), and one or more
runs combining those groups. Behavioral twin of the reference's
``pkg/api/composition.go:18-503``; the TOML schema (table names, key names,
trickle-down semantics) is preserved so reference compositions parse
unchanged.

The port's own copy of the reference's ``testground_tpu/api/composition.py``
(ROADMAP's copy policy); ``tests/test_torch_composition.py`` pins it against
the original.
"""

from __future__ import annotations

import json
import tomllib
from dataclasses import dataclass, field
from typing import Any

__all__ = [
    "Build",
    "Composition",
    "CompositionRunGroup",
    "Dependency",
    "Global",
    "Group",
    "Instances",
    "Metadata",
    "Resources",
    "Run",
    "RunParams",
]


def _merge_missing(dst: dict, src: dict | None) -> dict:
    """Fill keys absent from ``dst`` with values from ``src`` (non-destructive
    merge — the semantics the reference gets from mergo.Merge on maps)."""
    if src:
        for k, v in src.items():
            if k not in dst:
                dst[k] = v
    return dst


@dataclass
class Metadata:
    """Optional composition metadata (``pkg/api/composition.go:77-83``)."""

    name: str = ""
    author: str = ""

    @classmethod
    def from_dict(cls, d: dict) -> "Metadata":
        return cls(name=d.get("name", ""), author=d.get("author", ""))

    def to_dict(self) -> dict:
        return {"name": self.name, "author": self.author}


@dataclass
class Resources:
    """Per-instance resource requests, honored by cluster runners
    (``pkg/api/composition.go:85-88``)."""

    memory: str = ""
    cpu: str = ""

    @classmethod
    def from_dict(cls, d: dict) -> "Resources":
        return cls(memory=d.get("memory", ""), cpu=d.get("cpu", ""))

    def to_dict(self) -> dict:
        return {"memory": self.memory, "cpu": self.cpu}

    def merge_from(self, other: "Resources") -> None:
        if not self.memory:
            self.memory = other.memory
        if not self.cpu:
            self.cpu = other.cpu


@dataclass
class Instances:
    """Instance count for a group: exact ``count`` XOR fraction
    ``percentage`` of the run's total (``pkg/api/composition.go:169-180``)."""

    count: int = 0
    percentage: float = 0.0

    @classmethod
    def from_dict(cls, d: dict) -> "Instances":
        return cls(
            count=int(d.get("count", 0)),
            percentage=float(d.get("percentage", 0.0)),
        )

    def to_dict(self) -> dict:
        return {"count": self.count, "percentage": self.percentage}

    def is_zero(self) -> bool:
        return self.count == 0 and self.percentage == 0.0

    def merge_from(self, other: "Instances") -> None:
        if self.count == 0:
            self.count = other.count
        if self.percentage == 0.0:
            self.percentage = other.percentage


@dataclass
class Dependency:
    """Upstream dependency override for a build
    (``pkg/api/composition.go:302-311``)."""

    module: str
    version: str
    target: str = ""

    @classmethod
    def from_dict(cls, d: dict) -> "Dependency":
        return cls(
            module=d.get("module", ""),
            version=d.get("version", ""),
            target=d.get("target", ""),
        )

    def to_dict(self) -> dict:
        return {"module": self.module, "version": self.version, "target": self.target}


def apply_dependency_defaults(
    deps: list[Dependency], defaults: list[Dependency]
) -> list[Dependency]:
    """Append default dependency overrides for modules not explicitly set
    (``pkg/api/composition.go:251-273``). If no explicit overrides exist, the
    defaults are used as-is."""
    if not deps:
        return list(defaults)
    have = {d.module for d in deps}
    out = list(deps)
    for d in defaults:
        if d.module not in have:
            out.append(Dependency(module=d.module, version=d.version, target=d.target))
    return out


@dataclass
class Build:
    """Build directives: source selectors (build tags for Go; extras markers
    for Python plans) and dependency overrides
    (``pkg/api/composition.go:184-192``)."""

    selectors: list[str] = field(default_factory=list)
    dependencies: list[Dependency] = field(default_factory=list)

    @classmethod
    def from_dict(cls, d: dict) -> "Build":
        return cls(
            selectors=list(d.get("selectors", [])),
            dependencies=[Dependency.from_dict(x) for x in d.get("dependencies", [])],
        )

    def to_dict(self) -> dict:
        return {
            "selectors": list(self.selectors),
            "dependencies": [d.to_dict() for d in self.dependencies],
        }

    def build_key(self) -> str:
        """Canonical key over sorted selectors + sorted dependency overrides
        (``pkg/api/composition.go:220-241``; deviation: the reference keys
        only module:version, so two groups overriding the same module at
        different local targets would wrongly share one artifact — we
        include the target)."""
        selectors = ",".join(sorted(self.selectors))
        deps = sorted(self.dependencies, key=lambda d: d.module)
        # target is part of the key: two groups overriding the same
        # module at different local paths must NOT share an artifact
        # (the runner consumes targets from the built snapshot's
        # deps.json at launch time)
        dep_str = "".join(
            f"{d.module}:{d.version}:{d.target}|" for d in deps
        )
        return f"selectors={selectors};dependencies={dep_str}"


@dataclass
class RunParams:
    """Run directives for a group: a pre-built artifact to reuse, test
    parameters, profile capture spec (``pkg/api/composition.go:282-300``),
    and — beyond the reference — a declarative fault schedule
    (``[[groups.run.faults]]`` / ``[[global.run.faults]]``): a list of
    chaos events the ``sim:jax`` runner lowers into its deterministic
    fault-injection plane (docs/FAULTS.md), plus a flight-recorder
    sampling table (``[groups.run.trace]`` / ``[global.run.trace]``,
    docs/OBSERVABILITY.md) selecting which instances the sim engine
    records per-tick lifecycle events for, and run-health SLO
    assertions (``[[groups.run.slo]]`` / ``[[global.run.slo]]``,
    docs/OBSERVABILITY.md "Run health plane"): metric/comparator/
    threshold rules the sim engine evaluates per chunk while the run is
    in flight. Entries are kept as raw tables here; validation happens
    at lowering, where the group layout is known."""

    artifact: str = ""
    test_params: dict[str, str] = field(default_factory=dict)
    profiles: dict[str, str] = field(default_factory=dict)
    faults: list = field(default_factory=list)
    trace: dict = field(default_factory=dict)
    slo: list = field(default_factory=list)

    @classmethod
    def from_dict(cls, d: dict) -> "RunParams":
        return cls(
            artifact=d.get("artifact", ""),
            test_params={str(k): str(v) for k, v in d.get("test_params", {}).items()},
            profiles=dict(d.get("profiles", {})),
            faults=[dict(f) for f in d.get("faults", [])],
            trace=dict(d.get("trace", {})),
            slo=[dict(s) for s in d.get("slo", [])],
        )

    def to_dict(self) -> dict:
        out = {
            "artifact": self.artifact,
            "test_params": dict(self.test_params),
            "profiles": dict(self.profiles),
        }
        # omit when empty: keeps serialized compositions byte-stable for
        # the (vast) majority that declare no chaos schedule, trace, or
        # SLO rules
        if self.faults:
            out["faults"] = [dict(f) for f in self.faults]
        if self.trace:
            out["trace"] = dict(self.trace)
        if self.slo:
            out["slo"] = [dict(s) for s in self.slo]
        return out


@dataclass
class Global:
    """Composition-wide defaults that trickle down to groups
    (``pkg/api/composition.go:33-75``)."""

    plan: str = ""
    case: str = ""
    total_instances: int = 0
    concurrent_builds: int = 0
    builder: str = ""
    build_config: dict[str, Any] = field(default_factory=dict)
    build: Build | None = None
    runner: str = ""
    run_config: dict[str, Any] = field(default_factory=dict)
    run: RunParams | None = None
    disable_metrics: bool = False

    @classmethod
    def from_dict(cls, d: dict) -> "Global":
        return cls(
            plan=d.get("plan", ""),
            case=d.get("case", ""),
            total_instances=int(d.get("total_instances", 0)),
            concurrent_builds=int(d.get("concurrent_builds", 0)),
            builder=d.get("builder", ""),
            build_config=dict(d.get("build_config", {})),
            build=Build.from_dict(d["build"]) if "build" in d else None,
            runner=d.get("runner", ""),
            run_config=dict(d.get("run_config", {})),
            run=RunParams.from_dict(d["run"]) if "run" in d else None,
            disable_metrics=bool(d.get("disable_metrics", False)),
        )

    def to_dict(self) -> dict:
        out: dict[str, Any] = {
            "plan": self.plan,
            "case": self.case,
            "total_instances": self.total_instances,
            "concurrent_builds": self.concurrent_builds,
            "builder": self.builder,
            "build_config": dict(self.build_config),
            "runner": self.runner,
            "run_config": dict(self.run_config),
            "disable_metrics": self.disable_metrics,
        }
        if self.build is not None:
            out["build"] = self.build.to_dict()
        if self.run is not None:
            out["run"] = self.run.to_dict()
        return out


@dataclass
class Group:
    """An instance group: who builds it, how many instances, what params
    (``pkg/api/composition.go:90-115``)."""

    id: str = ""
    builder: str = ""
    build_config: dict[str, Any] = field(default_factory=dict)
    build: Build = field(default_factory=Build)
    resources: Resources = field(default_factory=Resources)
    instances: Instances = field(default_factory=Instances)
    run: RunParams = field(default_factory=RunParams)
    # cached by recalculate_instance_counts; mirrors calculatedInstanceCnt.
    calculated_instance_count: int = 0

    @classmethod
    def from_dict(cls, d: dict) -> "Group":
        return cls(
            id=d.get("id", ""),
            builder=d.get("builder", ""),
            build_config=dict(d.get("build_config", {})),
            build=Build.from_dict(d.get("build", {})),
            resources=Resources.from_dict(d.get("resources", {})),
            instances=Instances.from_dict(d.get("instances", {})),
            run=RunParams.from_dict(d.get("run", {})),
        )

    def to_dict(self) -> dict:
        return {
            "id": self.id,
            "builder": self.builder,
            "build_config": dict(self.build_config),
            "build": self.build.to_dict(),
            "resources": self.resources.to_dict(),
            "instances": self.instances.to_dict(),
            "run": self.run.to_dict(),
        }

    def build_key(self) -> str:
        """Composite key identifying this build for deduplication
        (``pkg/api/composition.go:196-216``). Requires a prepared group (the
        builder must have trickled down already)."""
        if not self.builder:
            raise ValueError("group must have a builder (composition not prepared)")
        data = {
            "builder": self.builder,
            "build_config": self.build_config,
            "build_as_key": self.build.build_key(),
        }
        return json.dumps(data, sort_keys=True, separators=(",", ":"))

    def default_run_group(self) -> "CompositionRunGroup":
        """Synthesize the run group used when a composition has no explicit
        ``[[runs]]`` (``pkg/api/composition.go:461-470``)."""
        return CompositionRunGroup(
            id=self.id,
            group_id=self.id,
            resources=Resources(**self.resources.to_dict()),
            instances=Instances(**self.instances.to_dict()),
            test_params=dict(self.run.test_params),
            profiles=dict(self.run.profiles),
            faults=[dict(f) for f in self.run.faults],
            trace=dict(self.run.trace),
            slo=[dict(s) for s in self.run.slo],
        )


@dataclass
class CompositionRunGroup:
    """A group's participation in one run (``pkg/api/composition.go:135-167``)."""

    id: str = ""
    group_id: str = ""
    resources: Resources = field(default_factory=Resources)
    instances: Instances = field(default_factory=Instances)
    test_params: dict[str, str] = field(default_factory=dict)
    profiles: dict[str, str] = field(default_factory=dict)
    # fault schedule for this group's slice of the run (see RunParams):
    # declared inline on the run group, or inherited from the backing
    # group's [[groups.run.faults]] when unset
    faults: list = field(default_factory=list)
    # flight-recorder sampling table, same inheritance rule as faults
    trace: dict = field(default_factory=dict)
    # SLO assertion tables, same inheritance rule as faults
    slo: list = field(default_factory=list)
    calculated_instance_count: int = 0

    @classmethod
    def from_dict(cls, d: dict) -> "CompositionRunGroup":
        return cls(
            id=d.get("id", ""),
            group_id=d.get("group_id", ""),
            resources=Resources.from_dict(d.get("resources", {})),
            instances=Instances.from_dict(d.get("instances", {})),
            test_params={str(k): str(v) for k, v in d.get("test_params", {}).items()},
            profiles=dict(d.get("profiles", {})),
            faults=[dict(f) for f in d.get("faults", [])],
            trace=dict(d.get("trace", {})),
            slo=[dict(s) for s in d.get("slo", [])],
        )

    def to_dict(self) -> dict:
        out = {
            "id": self.id,
            "group_id": self.group_id,
            "resources": self.resources.to_dict(),
            "instances": self.instances.to_dict(),
            "test_params": dict(self.test_params),
            "profiles": dict(self.profiles),
        }
        if self.faults:
            out["faults"] = [dict(f) for f in self.faults]
        if self.trace:
            out["trace"] = dict(self.trace)
        if self.slo:
            out["slo"] = [dict(s) for s in self.slo]
        return out

    def effective_group_id(self) -> str:
        """``group_id`` when set, else ``id`` (``pkg/api/composition.go:275-280``)."""
        return self.group_id or self.id

    def merge_group(self, g: Group) -> None:
        """Fill unset fields from the backing group
        (``pkg/api/composition.go:472-489``). The fault schedule fills
        only when this run group declares none of its own (fill-if-empty,
        like the artifact field) — list concatenation would double-fire
        events when preparation runs more than once — and fills ONLY from
        the backing group, never from ``Global.run``: run-global faults
        stay on the global and reach the runner as ``RunInput.faults``,
        scoped to the whole run rather than copied into every group."""
        self.resources.merge_from(g.resources)
        self.instances.merge_from(g.instances)
        self.merge_run(g.run)
        if not self.faults and g.run.faults:
            self.faults = [dict(f) for f in g.run.faults]
        # trace follows the faults rule exactly: fill-if-empty from the
        # backing group; [global.run.trace] reaches the runner as
        # RunInput.trace, scoped to the whole run
        if not self.trace and g.run.trace:
            self.trace = dict(g.run.trace)
        # slo follows the same rule: fill-if-empty from the backing
        # group; [[global.run.slo]] reaches the runner as RunInput.slo
        if not self.slo and g.run.slo:
            self.slo = [dict(s) for s in g.run.slo]

    def merge_run(self, rp: RunParams) -> None:
        """Fill missing test params / profiles from ``rp``
        (``pkg/api/composition.go:491-503``)."""
        _merge_missing(self.test_params, rp.test_params)
        _merge_missing(self.profiles, rp.profiles)


@dataclass
class Run:
    """One run of the composition: a total instance budget plus per-run group
    overrides (``pkg/api/composition.go:117-131``)."""

    id: str = ""
    test_params: dict[str, str] = field(default_factory=dict)
    total_instances: int = 0
    groups: list[CompositionRunGroup] = field(default_factory=list)

    @classmethod
    def from_dict(cls, d: dict) -> "Run":
        return cls(
            id=d.get("id", ""),
            test_params={str(k): str(v) for k, v in d.get("test_params", {}).items()},
            total_instances=int(d.get("total_instances", 0)),
            groups=[CompositionRunGroup.from_dict(x) for x in d.get("groups", [])],
        )

    def to_dict(self) -> dict:
        return {
            "id": self.id,
            "test_params": dict(self.test_params),
            "total_instances": self.total_instances,
            "groups": [g.to_dict() for g in self.groups],
        }

    def recalculate_instance_counts(self) -> None:
        """Resolve count/percentage per group and reconcile against the run
        total (``pkg/api/composition_preparation.go:172-196``).

        Percentages require an explicit total; an explicit total must match
        the computed sum exactly.
        """
        has_total = self.total_instances != 0
        computed = 0
        for g in self.groups:
            if g.instances.percentage > 0 and not has_total:
                raise ValueError(
                    "groups count percentage requires a total_instance configuration"
                )
            cnt = g.instances.count
            if cnt == 0:
                # Go math.Round: half away from zero. round() in Python is
                # banker's rounding, so do it explicitly.
                x = g.instances.percentage * float(self.total_instances)
                cnt = int(x + 0.5)
            g.calculated_instance_count = cnt
            computed += cnt
        if has_total and computed != self.total_instances:
            raise ValueError(
                f"total instances mismatch: computed: {computed} != "
                f"configured: {self.total_instances}"
            )
        self.total_instances = computed


@dataclass
class Composition:
    """The full run description (``pkg/api/composition.go:18-31``)."""

    metadata: Metadata = field(default_factory=Metadata)
    global_: Global = field(default_factory=Global)
    groups: list[Group] = field(default_factory=list)
    runs: list[Run] = field(default_factory=list)

    # ------------------------------------------------------------------ I/O

    @classmethod
    def from_dict(cls, d: dict) -> "Composition":
        return cls(
            metadata=Metadata.from_dict(d.get("metadata", {})),
            global_=Global.from_dict(d.get("global", {})),
            groups=[Group.from_dict(x) for x in d.get("groups", [])],
            runs=[Run.from_dict(x) for x in d.get("runs", [])],
        )

    @classmethod
    def from_toml(cls, text: str) -> "Composition":
        return cls.from_dict(tomllib.loads(text))

    @classmethod
    def load_file(cls, path) -> "Composition":
        with open(path, "rb") as f:
            return cls.from_dict(tomllib.load(f))

    def to_dict(self) -> dict:
        return {
            "metadata": self.metadata.to_dict(),
            "global": self.global_.to_dict(),
            "groups": [g.to_dict() for g in self.groups],
            "runs": [r.to_dict() for r in self.runs],
        }

    def to_toml(self) -> str:
        from ..utils.toml_writer import dumps

        return dumps(self.to_dict())

    def write_file(self, path) -> None:
        """Persist as TOML (``pkg/api/composition.go:440-459``)."""
        with open(path, "w") as f:
            f.write(self.to_toml())

    def clone(self) -> "Composition":
        return Composition.from_dict(self.to_dict())

    # ------------------------------------------------------------- accessors

    def list_builders(self) -> list[str]:
        """Distinct builders used by groups, with the global default standing
        in for unset ones (``pkg/api/composition.go:313-332``)."""
        builders = set()
        for g in self.groups:
            builders.add(g.builder or self.global_.builder)
        return sorted(builders)

    def get_group(self, group_id: str) -> Group:
        for g in self.groups:
            if g.id == group_id:
                return g
        raise KeyError(f"unknown group id {group_id}")

    def get_run(self, run_id: str) -> Run:
        for r in self.runs:
            if r.id == run_id:
                return r
        raise KeyError(f"unknown run id {run_id}")

    def frame_for_runs(self, *run_ids: str) -> "Composition":
        """Clone retaining only the given runs and the groups they reference
        (``pkg/api/composition.go:353-388``)."""
        c = self.clone()
        runs = []
        required: dict[str, bool] = {}
        for rid in run_ids:
            r = c.get_run(rid)
            for g in r.groups:
                required[g.effective_group_id()] = True
            runs.append(r)
        c.groups = [c.get_group(gid) for gid in required]
        c.runs = runs
        return c
