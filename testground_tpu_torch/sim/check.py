"""The rules engine behind ``tg check`` — the port's copy of the reference's
``testground_tpu/sim/check.py``, evaluated for the ``sim:torch`` runner.

Every composition-level refusal the port's executor makes is catalogued as
a typed :class:`Rule` and evaluated statically against a composition, its
coalesced runner config and a device count; every finding is reported in
one pass instead of the run dying on the first, and the daemon refuses a
run at submit when any error fires (``Engine.admission_findings``).

Drift discipline, as in the reference: the checker does not re-implement
the gates, it calls the functions the port's executor calls
(``fault_specs_of`` / ``trace_specs_of`` / ``slo_specs_of``,
``build_fault_schedule``, ``build_trace_plan``, ``build_slo_plan``,
``meshplan.parse_mesh_shape``, ``_parse_hosts``, and the executor's own
gates ``transport_knob``, ``check_mesh_lanes`` and
``_precheck_cohort_spec_size``),
and catches their refusals; the refusals the executor states inline take
their text from the message helpers below, which the executor imports
back. So an error finding is the executor's refusal, word for word, and
the executor refuses exactly the compositions the checker reports an error
for (``tests/test_torch_check.py`` pins both directions).

Where the port diverges from the reference's catalog:

- The cohort rules fire as the reference's: ``*.cohort-disabled``
  (``checkpoint.cohort-disabled`` and ``buckets.cohort-disabled`` among
  them), ``checkpoint.resume-cohort``, ``debug.nan-guard-cohort`` and
  ``cohort.spec-oversize`` (the executor's own
  ``_precheck_cohort_spec_size``). Under a cohort the peer shards are the
  processes (one device each), where the reference's checker counts none.
- ``transport.mesh-indivisible`` is an error, not a warn, and fires for
  ``pallas`` only: there the port refuses with the reference engine's
  message, where the reference falls back to its XLA transport. Under
  ``xla`` and ``auto`` the port pads the last group with dead lanes, as
  the reference's XLA transport pads its lane axis, and nothing fires.
- ``run-cfg.unknown-key`` names the ``sim:torch`` runner and the
  ``SimTorchConfig`` fields.
- Layers 2 and 3 (``check_composition(..., trace_plans=True)``, ``tg
  check --trace-plans``) build each run's program on the **meta device**
  where the reference traces under ``jax.eval_shape`` and ``make_jaxpr``:
  every tensor has its shape and dtype and no storage, so nothing is
  allocated on any device and no kernel launches. The checker loads the
  plan, builds the program at the composition's exact shapes, sizes the
  carry, and runs the plan's part of two ticks: an inbox of the shapes
  ``net.deliver`` pops, then ``SimProgram._step_phase``. The rest of the
  tick (the transport's kernels, the fault phase) reads the card on the
  host by design and is not run. How each ``plan.*`` rule maps:

  - ``plan.load-failed``: ``executor.load_and_specialize`` raises.
  - ``plan.memory``: the carry's bytes (``engine.carry_footprint``, shapes
    only) against the executor's own ``_precheck_device_memory``, with the
    card the composition's ``device`` names (none without a card and
    without ``memory_limit_bytes``: no budget), word for word. A
    pack-opted run counts the widest pack's stacked carry, per device of
    the calendar mesh a meshed pack splits over (``pack.sub_shard_mesh``).
  - ``plan.traced-int``: a plan frame reads a device value on the host
    (``int()``, ``bool()``, ``.item()``, ``.tolist()``, ``.cpu()``), which
    raises on meta — the same plan logic that fails the reference's trace
    with ``TracerIntegerConversionError``. A read from engine code is the
    engine's own (PERF.md §7) and no finding.
  - ``plan.while-loop`` (warn): that read's line is a ``while`` — an
    unbounded loop over device values needs such a read in eager torch.
  - ``plan.trace-error``: any other failure of the build or the step (a
    data-dependent shape, ``nonzero``, mask indexing, a shape error), or
    a step plane whose shape or dtype is not what ``enqueue``,
    ``apply_net_updates`` and ``update_sync`` take.
  - ``plan.host-callback`` (warn): the reference's host callbacks in the
    tick; here, host data made into a device tensor (``torch.tensor``,
    ``as_tensor``, ``asarray``, ``from_numpy``, and ``broadcast_shapes``,
    whose first call imports sympy) by the plan's files or ``sim/api.py``
    during the second step — one host copy and wait each, every tick. The
    first step may fill a cache. ``sys.monitoring`` CALL events watch that
    one step only; nothing of it is installed on a run's path.
  - ``plan.weak-type`` (warn): a state leaf whose dtype after two steps
    differs from its dtype after ``init`` (a Python float promoting an
    ``int32`` leaf) — the port's recompile-hazard twin: the tick then
    runs other kernels than its first.

  Every finding names the deepest frame in the plan's own files (else
  the plan's ``step``). A bucketed run is built at its padded shapes with
  the exact counts as 0-d meta tensors (the reference's ``bucketed=True``
  variant): a plan that turns a count into a Python int reads a meta
  tensor on the host, ``plan.traced-int`` — the traced-count contract's
  teeth. Admission at submit stays layer 1, as in the reference.
- ``devices=0`` counts the visible cards (``torch.cuda.device_count()``),
  1 without one; a run whose ``device`` is not a card meshes nothing
  unless ``mesh`` says so, as the executor does.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import sys
import threading
import traceback
import types

__all__ = [
    "CheckContext",
    "Finding",
    "Rule",
    "RULES",
    "check_composition",
    "findings_payload",
    "netmatrix_requires_telemetry_message",
    "resume_cohort_message",
    "pallas_lanes_message",
    "render_findings",
    "rule_by_id",
    "slo_requires_telemetry_message",
    "unknown_transport_message",
]

RUNNER = "sim:torch"


# --------------------------------------------------------------- catalog


@dataclasses.dataclass(frozen=True)
class Rule:
    """One catalogued admission rule: a stable id, the severity the port's
    executor enforces it at (``error`` = the run is refused, ``warn`` =
    the executor runs on), the knob layer it guards, and a one-line
    summary."""

    id: str
    severity: str  # "error" | "warn"
    layer: str
    summary: str


RULES: tuple[Rule, ...] = (
    # ---- composition structure
    Rule("composition.invalid", "error", "composition",
         "composition fails structural validation / preparation"),
    Rule("run-cfg.unknown-key", "warn", "run-cfg",
         "runner-config key matches no SimJaxConfig field (silently ignored)"),
    # ---- transport
    Rule("transport.unknown", "error", "transport",
         "transport knob is not xla|pallas|auto"),
    # an error in the port: it refuses what the reference falls back from
    Rule("transport.mesh-indivisible", "error", "transport",
         "pallas/auto lanes do not divide across the mesh peer shards; "
         "resolves to xla"),
    # ---- mesh layout
    Rule("mesh.shape-invalid", "error", "mesh",
         "mesh knob is not N or AxB (e.g. '4' or '2x4')"),
    # ---- shape buckets
    Rule("buckets.mode-invalid", "error", "buckets",
         "bucket knob is not off|auto|<n>"),
    Rule("buckets.ladder-invalid", "error", "buckets",
         "bucket_ladder is not a positive instance-count list"),
    Rule("buckets.cohort-disabled", "warn", "buckets",
         "bucketing disabled under a cohort config"),
    Rule("buckets.mesh-indivisible", "warn", "buckets",
         "a padded rung does not divide across the mesh peer shards; "
         "runs exact shapes"),
    Rule("buckets.over-ladder", "warn", "buckets",
         "a group exceeds the ladder coverage; runs exact shapes"),
    Rule("buckets.filter-rules", "warn", "buckets",
         "filter_rules shaping with multiple groups disables bucketing"),
    # ---- faults / flight recorder
    Rule("faults.invalid", "error", "faults",
         "a [[run.faults]] table fails validation/lowering"),
    Rule("trace.invalid", "error", "trace",
         "a [run.trace] table fails validation/lowering"),
    Rule("trace.bucket-disabled", "warn", "trace",
         "flight recorder disabled under shape bucketing"),
    Rule("trace.cohort-disabled", "warn", "trace",
         "flight recorder disabled under a cohort config"),
    # ---- telemetry / SLO
    Rule("telemetry.cohort-disabled", "warn", "telemetry",
         "telemetry plane disabled under a cohort config"),
    # ---- traffic matrix
    Rule("netmatrix.needs-telemetry", "error", "netmatrix",
         "netmatrix = true but the telemetry plane is off"),
    Rule("netmatrix.cohort-disabled", "warn", "netmatrix",
         "traffic matrix disabled under a cohort config"),
    Rule("slo.invalid", "error", "slo",
         "a [[run.slo]] table fails validation"),
    Rule("slo.needs-telemetry", "error", "slo",
         "SLO rules declared but the telemetry plane is off"),
    Rule("slo.cohort-disabled", "warn", "slo",
         "SLO assertions disabled under a cohort config"),
    # ---- checkpoint / resume
    Rule("checkpoint.cohort-disabled", "warn", "checkpoint",
         "checkpointing disabled under a cohort config"),
    Rule("checkpoint.resume-cohort", "error", "checkpoint",
         "resume_from is not supported under a multi-host cohort"),
    Rule("checkpoint.resume-multi-runs", "error", "checkpoint",
         "resume_from on a multi-[[runs]] composition is ambiguous"),
    # ---- debug knobs
    Rule("debug.nan-guard-cohort", "warn", "debug",
         "nan_guard disabled under a cohort config"),
    # ---- cohort
    Rule("cohort.spec-oversize", "error", "cohort",
         "cohort job spec exceeds the broadcast byte bound"),
    # ---- run packing
    Rule("pack.solo", "warn", "pack",
         "pack=true but the composition must run solo"),
    # ---- abstract plan tracing (--trace-plans: the meta device)
    Rule("plan.load-failed", "error", "plan",
         "plan sources fail to import/specialize for this composition"),
    Rule("plan.traced-int", "error", "plan",
         "python int()/len()/control flow on a traced count "
         "(the traced-count contract, docs/WRITING_PLANS.md)"),
    Rule("plan.trace-error", "error", "plan",
         "the testcase fails to trace at the composition's shapes"),
    Rule("plan.memory", "error", "plan",
         "estimated carry footprint exceeds the device memory budget"),
    Rule("plan.host-callback", "warn", "plan",
         "host callback (pure_callback/io_callback/debug_print) in the "
         "jitted tick"),
    Rule("plan.while-loop", "warn", "plan",
         "while loop in the jitted tick (unbounded per-tick work)"),
    Rule("plan.weak-type", "warn", "plan",
         "weak-typed leaf in the instance state (recompile hazard)"),
)

_RULE_INDEX = {r.id: r for r in RULES}


def rule_by_id(rule_id: str) -> Rule:
    return _RULE_INDEX[rule_id]


@dataclasses.dataclass
class Finding:
    """One rule firing against one composition: the rule id, its
    severity/layer (denormalized for the JSON surface), the executor's
    message, and where it fired (``run`` = the [[runs]] entry id, when
    attributable; ``plan_file`` for the plan-tracing layer)."""

    rule: str
    severity: str
    layer: str
    message: str
    run: str = ""
    plan_file: str = ""

    def to_dict(self) -> dict:
        out = {
            "rule": self.rule,
            "severity": self.severity,
            "layer": self.layer,
            "message": self.message,
        }
        if self.run:
            out["run"] = self.run
        if self.plan_file:
            out["plan_file"] = self.plan_file
        return out


# ------------------------------------------------- shared message helpers
# The executor imports these back, so the refusal it raises and the
# finding the checker reports are the same string by construction.


def slo_requires_telemetry_message(count: int, disable_metrics: bool) -> str:
    """The SLO-without-telemetry refusal (executor + checker)."""
    return (
        f"composition declares {count} SLO rule(s) but the telemetry "
        "plane is off"
        + (
            " (disable_metrics = true wins over everything)"
            if disable_metrics
            else " — set telemetry = true in the runner config "
            "(--run-cfg telemetry=true)"
        )
        + "; refusing to run with unenforceable SLOs"
    )


def netmatrix_requires_telemetry_message(disable_metrics: bool) -> str:
    """The netmatrix-without-telemetry refusal (executor + checker)."""
    return (
        "netmatrix = true but the telemetry plane is off"
        + (
            " (disable_metrics = true wins over everything)"
            if disable_metrics
            else " — the traffic matrix rides the telemetry chunk "
            "flush; set telemetry = true in the runner config "
            "(--run-cfg telemetry=true)"
        )
        + "; refusing to run with an unobservable matrix plane"
    )


def unknown_transport_message(requested: str) -> str:
    """The unknown-transport refusal, the reference's text
    (``transport_model.py:208-212``)."""
    return (
        f"unknown transport {requested!r} in runner config: expected "
        "'xla', 'pallas', or 'auto' (--run-cfg transport=pallas)"
    )


def resume_cohort_message() -> str:
    """The resume-under-cohort refusal (executor + checker), the
    reference's text (``check.py:380-386``)."""
    return (
        "resume_from is not supported under a multi-host cohort "
        "(checkpoints are leader-local reads of a cross-process "
        "carry); run the resumed composition single-host"
    )


def pallas_lanes_message(n: int, hosts: int, shards: int) -> str:
    """An indivisible lane count under ``transport=pallas``: the
    reference engine's own rule and message (``engine.py:406-422``)."""
    return (
        f"transport=pallas on a mesh needs the lane count to "
        f"divide across the peer shards: {n + hosts} "
        f"lane(s) ({n} instances + {hosts} "
        f"host(s)) do not divide by {shards} — pad the "
        "instance counts (shape bucketing does this), drop "
        "the hosts, or use transport=xla"
    )


# ---------------------------------------------------------------- context


def _layout(mesh) -> tuple[int, ...] | None:
    """The explicit ``mesh`` knob's extents; None when unset or malformed
    (``mesh.shape-invalid`` reports that refusal)."""
    from .meshplan import parse_mesh_shape

    if not mesh:
        return None
    try:
        return parse_mesh_shape(mesh)
    except ValueError:
        return None


@dataclasses.dataclass
class CheckContext:
    """Everything one check pass evaluates against: the prepared
    composition, the coalesced runner config, and the device count
    (``devices``: how many cards the run would see; overridable so a
    host can check what a host of eight cards would refuse)."""

    comp: object  # api.Composition, post prepare_for_run
    cfg: object  # SimTorchConfig
    devices: int = 1
    trace_plans: bool = False
    plan_sources: str = ""
    raw_run_config: dict = dataclasses.field(default_factory=dict)
    # the env's [runners."sim:torch"] layer, as pack admission reads it
    raw_env_layer: dict = dataclasses.field(default_factory=dict)

    @property
    def cohort(self) -> bool:
        return bool(getattr(self.cfg, "coordinator_address", ""))

    @property
    def peer_shards(self) -> int:
        """The peer shards the executor would split the calendar over: a
        cohort's processes (one device each); else the explicit layout's
        last extent, else every card when ``shard`` is on and the run's
        device is a card, else 1."""
        if self.cohort and int(getattr(self.cfg, "num_processes", 1)) > 1:
            return int(self.cfg.num_processes)
        dims = _layout(getattr(self.cfg, "mesh", ""))
        if dims is not None:
            return int(dims[-1])
        device = getattr(self.cfg, "device", None)
        if not getattr(self.cfg, "shard", True) or (
            device is not None and not str(device).startswith("cuda")
        ):
            return 1
        return max(int(self.devices), 1)


def _group_layout(run_groups):
    """The resolved per-run group layout the lowering gates resolve
    selectors against — the construction of ``sim/engine.build_groups``
    (the gates only read ``id``/``index``/``offset``/``count``/``params``)."""
    specs = []
    off = 0
    for i, rg in enumerate(run_groups):
        count = int(rg.calculated_instance_count)
        specs.append(
            types.SimpleNamespace(
                id=rg.id, index=i, offset=off, count=count,
                params=dict(rg.test_params),
            )
        )
        off += count
    return tuple(specs)


# ------------------------------------------------------------ rule passes


def _add(findings, rule_id, message, run="", plan_file=""):
    r = rule_by_id(rule_id)
    findings.append(
        Finding(rule=r.id, severity=r.severity, layer=r.layer, message=message,
                run=run, plan_file=plan_file)
    )


def _check_run_cfg_keys(ctx, findings) -> None:
    """Unknown runner-config keys: ``coalesce_into`` silently drops them,
    so a typo'd knob (``trasnport=pallas``) configures nothing."""
    from .executor import SimTorchConfig

    known = {f.name for f in dataclasses.fields(SimTorchConfig)}
    # "enabled" is the manifest's runner toggle (prepare_for_run folds
    # manifest runner defaults into run_config), the rest are consumed by
    # the engine/runner layer before the executor
    known |= {"enabled", "pack", "sync_service"}
    for key in sorted(ctx.raw_run_config or {}):
        if key not in known:
            _add(
                findings,
                "run-cfg.unknown-key",
                f"runner config key {key!r} matches no {RUNNER} option and "
                "is silently ignored — known options: "
                f"{', '.join(sorted(known))}",
            )


def _check_pack(ctx, findings) -> None:
    """Pack-admission preview (``check.py:861-874``): when the composition
    opts into packing but would run solo, name the cause — the same
    classification the engine journals as ``sim.pack.solo_reason``."""
    from ..engine.pack import solo_reason_for_composition

    reason = solo_reason_for_composition(ctx.comp.to_dict(), dict(ctx.raw_env_layer))
    if reason is not None:
        _add(
            findings,
            "pack.solo",
            f"pack=true but this composition runs solo: {reason}",
        )


def _check_resume_multi_runs(ctx, findings) -> None:
    """``resume_from`` with several ``[[runs]]`` is ambiguous: each run has
    its own outputs dir (``check.py:877-891``)."""
    if str(getattr(ctx.cfg, "resume_from", "") or "") and len(ctx.comp.runs) > 1:
        _add(
            findings,
            "checkpoint.resume-multi-runs",
            f"resume_from is set on a multi-[[runs]] composition "
            f"({len(ctx.comp.runs)} runs) — every run would resume from "
            "the same snapshot dir; resume one run at a time "
            "(--run-ids <id>)",
        )


def _check_mesh(ctx, findings) -> None:
    """An explicit ``mesh`` knob that fails the layout grammar — the
    executor's ``parse_mesh_shape`` refusal, reported statically."""
    from .meshplan import parse_mesh_shape

    mesh = getattr(ctx.cfg, "mesh", "")
    if not mesh:
        return
    try:
        parse_mesh_shape(mesh)
    except ValueError as e:
        _add(findings, "mesh.shape-invalid", str(e))


def _check_transport(ctx, findings) -> None:
    """The transport knob, then the lane count of each run against the
    peer shards — the executor's ``transport_knob`` and
    ``check_mesh_lanes`` gates."""
    from .executor import _parse_hosts, check_mesh_lanes, resolve_buckets, transport_knob

    try:
        transport = transport_knob(ctx.cfg)
    except ValueError as e:
        _add(findings, "transport.unknown", str(e))
        return
    shards = ctx.peer_shards
    hosts = _parse_hosts(getattr(ctx.cfg, "additional_hosts", None))
    for run in ctx.comp.runs:
        counts = [int(rg.calculated_instance_count) for rg in run.groups]
        try:  # a bucketed run's lanes are its padded counts
            bp = resolve_buckets(ctx.cfg, counts, mesh=_bucket_mesh(ctx))
        except ValueError:
            bp = None  # buckets.* reports the refusal
        n = sum(bp.padded_counts if bp is not None else counts)
        try:
            check_mesh_lanes(transport, n, len(hosts), shards)
        except (NotImplementedError, ValueError) as e:
            _add(findings, "transport.mesh-indivisible", str(e), run=run.id)


def _bucket_mesh(ctx):
    """What ``resolve_buckets`` divides the padded counts by: a stand-in
    for the executor's mesh with the checked peer shards (None for one)."""
    shards = ctx.peer_shards
    return types.SimpleNamespace(shape={"i": shards}) if shards > 1 else None


def _check_buckets(ctx, run, findings):
    """The run's BucketPlan (or None) — the plan layer needs it — with the
    gate's refusals and warnings as findings (``check.py:621-650``): the
    executor's ``resolve_buckets`` on the same counts and shards."""
    from .executor import resolve_buckets

    counts = [rg.calculated_instance_count for rg in run.groups]
    lines: list[str] = []

    def warn(fmt, *args):
        lines.append(fmt % args if args else fmt)

    try:
        plan = resolve_buckets(ctx.cfg, counts, mesh=_bucket_mesh(ctx), warn=warn)
    except ValueError as e:
        msg = str(e)
        rule = "buckets.ladder-invalid" if "bucket_ladder" in msg else "buckets.mode-invalid"
        _add(findings, rule, msg, run=run.id)
        return None
    for line in lines:
        if "cohort" in line:
            rule = "buckets.cohort-disabled"
        elif "divide" in line:
            rule = "buckets.mesh-indivisible"
        else:
            rule = "buckets.over-ladder"
        _add(findings, rule, line, run=run.id)
    return plan


def _run_specs(ctx, run):
    """The three spec dicts the executor collects for one run — built from
    the SAME ``*_specs_of`` helpers on the same layout."""
    from .executor import fault_specs_of, slo_specs_of, trace_specs_of

    run_global = ctx.comp.global_.run
    return (
        fault_specs_of(run.groups, run_global.faults if run_global else None),
        trace_specs_of(run.groups, run_global.trace if run_global else None),
        slo_specs_of(run.groups, run_global.slo if run_global else None),
    )


def _check_run(ctx, run, findings) -> dict:
    """All config-layer rules for one [[runs]] entry. Returns what the plan
    layer builds the run's program with: the planes' switches, and the
    fault and trace specs where they lower (None where they do not)."""
    from .faults import build_fault_schedule
    from .slo import build_slo_plan
    from .trace import build_trace_plan

    vgroups = _group_layout(run.groups)
    fault_specs, trace_specs, slo_specs = _run_specs(ctx, run)
    bucket_plan = _check_buckets(ctx, run, findings)
    try:
        build_fault_schedule(vgroups, fault_specs, ctx.cfg.tick_ms)
    except ValueError as e:
        _add(findings, "faults.invalid", str(e), run=run.id)
        fault_specs = None
    trace_plan = None
    try:
        trace_plan = build_trace_plan(vgroups, trace_specs)
    except ValueError as e:
        _add(findings, "trace.invalid", str(e), run=run.id)
        trace_specs = None

    disable_metrics = bool(ctx.comp.global_.disable_metrics)
    if trace_plan is not None and not disable_metrics and bucket_plan is not None:
        _add(
            findings,
            "trace.bucket-disabled",
            "flight recorder disabled under shape bucketing (trace "
            "lanes are exact-layout selectors baked into the program; "
            "run with bucket=off to trace)",
            run=run.id,
        )
        trace_specs = None
    # the cohort gates: the executor's, in its order and words
    if trace_plan is not None and not disable_metrics and trace_specs and ctx.cohort:
        _add(
            findings,
            "trace.cohort-disabled",
            "flight recorder disabled for the cohort config (per-chunk "
            "leader-local device reads are not symmetric across "
            "processes)",
            run=run.id,
        )
        trace_specs = None
    telemetry_on = bool(getattr(ctx.cfg, "telemetry", False)) and not disable_metrics
    if telemetry_on and ctx.cohort:
        _add(
            findings,
            "telemetry.cohort-disabled",
            "telemetry disabled for the cohort config (per-chunk "
            "leader-local device reads are not symmetric across "
            "processes)",
            run=run.id,
        )
        telemetry_on = False
    netmatrix_on = bool(getattr(ctx.cfg, "netmatrix", False))
    if netmatrix_on and ctx.cohort:
        _add(
            findings,
            "netmatrix.cohort-disabled",
            "traffic matrix disabled for the cohort config (per-chunk "
            "leader-local delta reads are not symmetric across "
            "processes)",
            run=run.id,
        )
        netmatrix_on = False
    if netmatrix_on and not telemetry_on:
        _add(findings, "netmatrix.needs-telemetry",
             netmatrix_requires_telemetry_message(disable_metrics), run=run.id)
        netmatrix_on = False

    slo_plan = None
    try:
        slo_plan = build_slo_plan(vgroups, slo_specs)
    except ValueError as e:
        _add(findings, "slo.invalid", str(e), run=run.id)
    if slo_plan is not None and ctx.cohort:
        _add(
            findings,
            "slo.cohort-disabled",
            "SLO assertions disabled for the cohort config (the "
            "telemetry plane they evaluate is leader-local and runs "
            "off under a cohort)",
            run=run.id,
        )
        slo_plan = None
    if slo_plan is not None and not telemetry_on:
        _add(findings, "slo.needs-telemetry",
             slo_requires_telemetry_message(slo_plan.count, disable_metrics),
             run=run.id)

    if ctx.cohort:
        _check_cohort_gates(ctx, run, findings)
    return {
        "telemetry_on": telemetry_on,
        # the executor refuses the matrix without telemetry (reported
        # above); the plan layer then builds without it
        "netmatrix_on": netmatrix_on,
        "fault_specs": fault_specs,
        "trace_specs": None if disable_metrics else trace_specs,
        "bucket_plan": bucket_plan,
    }


def _check_cohort_gates(ctx, run, findings) -> None:
    """The cohort's checkpoint, resume and debug gates, then the
    broadcast-bound precheck through the executor's OWN function on a job
    shaped like the one the engine would build (``check.py:780-857``)."""
    from ..api import RunGroup
    from .executor import _precheck_cohort_spec_size

    if str(getattr(ctx.cfg, "resume_from", "") or ""):
        _add(findings, "checkpoint.resume-cohort", resume_cohort_message(),
             run=run.id)
    if int(getattr(ctx.cfg, "checkpoint_chunks", 0) or 0) > 0:
        _add(
            findings,
            "checkpoint.cohort-disabled",
            "checkpointing disabled for the cohort config (a "
            "leader-local read of the cross-process-sharded carry is "
            "not symmetric)",
            run=run.id,
        )
    if bool(getattr(ctx.cfg, "nan_guard", False)):
        _add(
            findings,
            "debug.nan-guard-cohort",
            "nan_guard disabled for the cohort config (a leader-local "
            "read of the cross-process-sharded carry is not symmetric, "
            "and raises on non-addressable shards)",
            run=run.id,
        )
    run_global = ctx.comp.global_.run
    job = types.SimpleNamespace(
        test_plan=ctx.comp.global_.plan,
        test_case=ctx.comp.global_.case,
        run_id=run.id,
        groups=[
            RunGroup(id=rg.id, instances=rg.calculated_instance_count,
                     parameters=dict(rg.test_params),
                     faults=[dict(f) for f in getattr(rg, "faults", [])])
            for rg in run.groups
        ],
        faults=[dict(f) for f in (run_global.faults if run_global is not None else [])],
    )
    try:
        _precheck_cohort_spec_size(job, ctx.cfg)
    except ValueError as e:
        _add(findings, "cohort.spec-oversize", str(e), run=run.id)


# ---------------------------------------------- plan layer (--trace-plans)
# The reference traces each plan under jax.eval_shape and make_jaxpr; the
# port builds the run's program on the meta device, where every tensor has
# a shape and a dtype and no storage, and runs the plan's part of two
# ticks there. Nothing is allocated on any device and nothing launches.

# what an eager read of a device value raises on the meta device: the
# traced-count contract's failure in torch (the reference's
# TracerIntegerConversionError and kin)
_META_READS = (
    (RuntimeError, "cannot be called on meta tensors"),
    (NotImplementedError, "Cannot copy out of meta tensor"),
)

# the host→device factories the host-callback lint counts; the last is no
# copy, but its first call imports sympy (seconds) and it runs on the host
_HOST_FACTORIES = (
    "tensor", "as_tensor", "asarray", "from_numpy", "broadcast_shapes",
)


def _in_roots(filename: str, roots, cache: dict) -> bool:
    hit = cache.get(filename)
    if hit is None:
        hit = cache[filename] = os.path.realpath(filename).startswith(roots)
    return hit


def _plan_frame(tb, roots) -> tuple[str, int, str] | None:
    """The deepest frame of a traceback in the plan's own files:
    (file, line, source line)."""
    cache: dict = {}
    frame = None
    for fs in traceback.extract_tb(tb):
        if _in_roots(fs.filename, roots, cache):
            frame = (fs.filename, fs.lineno or 0, (fs.line or "").strip())
    return frame


def _where(frame, plan_sources: str) -> str:
    """``<plan dir>/<file>:<line>`` of a plan frame."""
    base = os.path.dirname(os.path.realpath(plan_sources))
    return f"{os.path.relpath(os.path.realpath(frame[0]), base)}:{frame[1]}"


def _step_site(testcase) -> tuple[str, int, str]:
    """The plan's ``step`` definition, for a finding no plan frame raised."""
    code = type(testcase).step.__code__
    return (code.co_filename, code.co_firstlineno, "")


def _classify(e, roots, site) -> tuple[list[str], tuple | None]:
    """A failure of the meta program → (rule ids, plan frame). A device
    value read on the host from a plan frame is ``plan.traced-int``, and
    also ``plan.while-loop`` when that line is a ``while``; a read with no
    plan frame is the engine's own (PERF.md §7) and no finding; anything
    else, a data-dependent shape included, is ``plan.trace-error`` at the
    deepest plan frame, else at ``site``."""
    from .engine import HOST_READ_ERROR

    frame = _plan_frame(e.__traceback__, roots)
    # a padded program's first step refuses a host read before the meta
    # tensor can (SimProgram under bucketing)
    read = any(isinstance(e, t) and m in str(e)
               for t, m in _META_READS + ((TypeError, HOST_READ_ERROR),))
    if read:
        if frame is None:
            return [], None
        rules = ["plan.traced-int"]
        if frame[2].startswith(("while ", "while(")):
            rules.append("plan.while-loop")
        return rules, frame
    return ["plan.trace-error"], frame or site


class _HostCopies:
    """Counts, on the calling thread, the calls of ``_HOST_FACTORIES`` whose
    data is not a tensor, made from the plan's files or from ``sim/api.py``
    (the helpers a step calls), while it is entered: ``sys.monitoring``
    CALL events, installed for the one step the lint watches and removed
    after it. Each hit is (factory, the deepest plan frame's file and
    line)."""

    def __init__(self, roots):
        import torch

        from . import api

        self.roots = tuple(roots)
        self.watch = self.roots + (os.path.realpath(api.__file__),)
        self.targets = {id(getattr(torch, n)): n for n in _HOST_FACTORIES}
        self._tensor = torch.Tensor
        self.hits: list[tuple[str, str, int]] = []
        self._files: dict = {}
        self._plan_files: dict = {}
        self._tool = None

    def __enter__(self):
        mon = sys.monitoring
        free = [i for i in range(6) if mon.get_tool(i) is None]
        if not free:
            return self  # every tool id is taken: the lint sees nothing
        self._tool = free[-1]
        self._thread = threading.get_ident()
        mon.use_tool_id(self._tool, "tg-check")
        mon.register_callback(self._tool, mon.events.CALL, self._on_call)
        mon.set_events(self._tool, mon.events.CALL)
        return self

    def __exit__(self, *exc):
        if self._tool is not None:
            mon = sys.monitoring
            mon.set_events(self._tool, 0)
            mon.register_callback(self._tool, mon.events.CALL, None)
            mon.free_tool_id(self._tool)
            # re-arm the locations this tool disabled (DISABLE outlives
            # the tool id)
            mon.restart_events()
            self._tool = None
        return False

    def _on_call(self, code, offset, fn, arg0):
        watched = _in_roots(code.co_filename, self.watch, self._files)
        if not watched:
            return sys.monitoring.DISABLE  # a file's calls never matter
        name = self.targets.get(id(fn))
        if name is None or threading.get_ident() != self._thread:
            return None
        if name != "broadcast_shapes" and isinstance(arg0, self._tensor):
            return None
        f = sys._getframe(1)
        while f is not None and not _in_roots(
            f.f_code.co_filename, self.roots, self._plan_files
        ):
            f = f.f_back
        if f is not None:
            self.hits.append((name, f.f_code.co_filename, f.f_lineno))
        return None


def _meta_inbox(cal, device):
    """An inbox of the shapes and dtypes ``net.deliver`` pops from ``cal``."""
    import torch

    from .api import Inbox

    slots = cal.slots
    n = cal.payload[0].shape[-1] // slots
    return Inbox(
        payload=torch.empty((cal.width, slots, n), dtype=cal.payload[0].dtype,
                            device=device),
        src=torch.empty((slots, n), dtype=torch.int32, device=device),
        valid=torch.empty((slots, n), dtype=torch.bool, device=device),
    )


def _step_contract(prog) -> dict:
    """What ``net.enqueue``, ``apply_net_updates`` and ``update_sync`` take
    of a step: plane name → (shape, dtype)."""
    import torch

    cls = type(prog.tc)
    i32, f32, b = torch.int32, torch.float32, torch.bool
    n, lanes = prog.n, prog.n_lanes
    rows = max(cls.OUT_MSGS, cls.IN_MSGS) if prog.hosts else cls.OUT_MSGS
    s, tt, pw = len(cls.STATES), len(cls.TOPICS), cls.PUB_WIDTH
    out = {
        "status": ((lanes,), i32),
        "finished_at": ((lanes,), i32),
        "dst": ((rows, lanes), i32),
        "payload": ((rows, cls.MSG_WIDTH, lanes), i32),
        "valid": ((rows, lanes), b),
        "signals": ((s, n), i32),
        "pub_payload": ((tt, pw, n), i32),
        "pub_valid": ((tt, n), b),
        "sub_consume": ((tt, n), i32),
        "net_shape": ((7, lanes), f32),
        "net_shape_valid": ((lanes,), b),
        "net_filters": ((prog.n_regions, lanes), i32),
        "net_filters_valid": ((lanes,), b),
        "net_region": ((lanes,), i32),
        "net_region_valid": ((lanes,), b),
    }
    if "filter_rules" in cls.SHAPING and cls.FILTER_RULES > 0:
        out["net_rules"] = ((cls.FILTER_RULES, 3, lanes), i32)
        out["net_rules_valid"] = ((lanes,), b)
    return out


def _state_dtypes(states) -> dict:
    """State leaf → dtype, named as ``jax.tree_util.keystr`` names the
    reference's leaves (``[group]['key']``)."""
    return {
        f"[{gi}][{k!r}]": v.dtype
        for gi, st in enumerate(states)
        for k, v in st.items()
    }


def _check_device(cfg):
    """The card a run of ``cfg`` would use, for the memory budget; None
    where this host has none (no budget, as in the executor)."""
    import torch

    dev = getattr(cfg, "device", None)
    d = torch.device("cuda" if dev is None else dev)
    if d.type != "cuda" or not torch.cuda.is_available():
        return None
    return d


def _pack_calendar_mesh(ctx, width: int):
    """The calendar mesh a pack of ``width`` members would split over on
    the cards (``pack.sub_shard_mesh`` of the executor's mesh, the cards
    named, not opened: only its distinct devices are read). None where the
    pack keeps one device: no mesh, or a virtual one off the cards."""
    import torch

    from .meshplan import make_mesh
    from .pack import sub_shard_mesh

    device = getattr(ctx.cfg, "device", None)
    if device is not None and not str(device).startswith("cuda"):
        return None
    dims = _layout(getattr(ctx.cfg, "mesh", ""))
    if dims is None:
        if not getattr(ctx.cfg, "shard", True) or ctx.devices <= 1:
            return None
        dims = (int(ctx.devices),)
    need = 1
    for d in dims:
        need *= int(d)
    mesh = make_mesh(dims, devices=[torch.device("cuda", i) for i in range(need)])
    return None if mesh is None else sub_shard_mesh(mesh, width)


def _trace_one_program(ctx, run, resolved, findings) -> None:
    """Layers 2 and 3 for one run: build the run's program on the meta
    device at the shapes the run would have — the composition's exact
    shapes, or a bucketed run's padded ones with its exact counts as 0-d
    meta tensors (the reference's ``bucketed=True`` variant, no faults and
    no trace plan there) — size its carry against the device budget, and
    run the plan's part of two ticks (an inbox of ``deliver``'s shapes,
    then ``SimProgram._step_phase``), then hold the step's planes against
    what the transport and the sync fold take and lint the tick."""
    import dataclasses as _dc

    import torch

    from ..api import RunGroup
    from ..rpc import discard_writer
    from .engine import carry_footprint
    from .executor import (
        _parse_hosts,
        _precheck_device_memory,
        load_and_specialize,
        make_sim_program,
    )
    from .faults import build_fault_schedule
    from .trace import build_trace_plan

    plan_file = ctx.plan_sources or ctx.comp.global_.plan
    label = f"{ctx.comp.global_.plan}:{ctx.comp.global_.case}"
    roots = (os.path.realpath(ctx.plan_sources) + os.sep,)
    meta = torch.device("meta")
    bucket_plan = resolved["bucket_plan"]
    counts = (
        list(bucket_plan.padded_counts) if bucket_plan is not None
        else [int(rg.calculated_instance_count) for rg in run.groups]
    )
    shape_note = (
        f"padded shapes {tuple(counts)}" if bucket_plan is not None else "exact shapes"
    )

    def add(rule, msg):
        _add(findings, rule, f"{label}: {msg}", run=run.id, plan_file=plan_file)

    def failed(e, stage, site):
        rules, frame = _classify(e, roots, site)
        where = "" if frame is None else f" at {_where(frame, ctx.plan_sources)}"
        for rule in rules:
            add(rule, f"{stage} failed on the meta device at {shape_note}"
                f"{where} ({type(e).__name__}): {e}")
        return None

    try:
        testcase, groups = load_and_specialize(
            ctx.plan_sources,
            ctx.comp.global_.case,
            [RunGroup(id=rg.id, instances=c, parameters=dict(rg.test_params))
             for rg, c in zip(run.groups, counts)],
            ctx.cfg.tick_ms,
        )
    except Exception as e:  # noqa: BLE001 — import/specialize failures
        add("plan.load-failed",
            f"plan failed to load/specialize at {shape_note}: {e}")
        return
    site = _step_site(testcase)
    if (bucket_plan is not None and "filter_rules" in type(testcase).SHAPING
            and len(groups) > 1):
        _add(
            findings,
            "buckets.filter-rules",
            "shape bucketing disabled — 'filter_rules' shaping with "
            "multiple groups addresses the exact layout (rule ranges "
            "cannot survive per-group padding); running exact shapes",
            run=run.id,
            plan_file=plan_file,
        )
        return

    try:
        faults = trace = None
        if bucket_plan is not None:
            pass  # the padded variant builds without either, as the reference's
        elif resolved["fault_specs"] is not None:
            faults = build_fault_schedule(groups, resolved["fault_specs"],
                                          ctx.cfg.tick_ms)
        if resolved["trace_specs"] is not None and bucket_plan is None:
            trace = build_trace_plan(groups, resolved["trace_specs"])
        prog = make_sim_program(
            testcase,
            groups,
            test_plan=ctx.comp.global_.plan,
            test_case=ctx.comp.global_.case,
            test_run="check",
            tick_ms=ctx.cfg.tick_ms,
            chunk=ctx.cfg.chunk,
            hosts=_parse_hosts(getattr(ctx.cfg, "additional_hosts", None)),
            validate=bool(getattr(ctx.cfg, "validate", False)),
            telemetry=resolved["telemetry_on"],
            faults=faults,
            trace=trace,
            netmatrix=resolved["netmatrix_on"],
            device=meta,
            mesh=None,
            live_counts=None if bucket_plan is None else bucket_plan.live_counts,
        )
        carry = prog.init_carry(int(ctx.cfg.seed))
    except Exception as e:  # noqa: BLE001 — build-time refusals
        return failed(e, "program build", site)

    # the executor's capacity precheck, the same function on the same bytes;
    # a pack-opted run may share the card with the widest pack its claim
    # builds, whose carry is every member's side by side
    need = carry_footprint(carry)
    spread = None
    if bool(getattr(ctx.cfg, "pack", False)):
        from .pack import pack_width

        pack_max = int(getattr(ctx.cfg, "pack_max", 8) or 8)
        width = pack_width(pack_max, pack_max)
        need *= width
        spread = _pack_calendar_mesh(ctx, width)
    try:
        _precheck_device_memory(prog, need, ctx.cfg,
                                discard_writer(), _check_device(ctx.cfg), mesh=spread)
    except RuntimeError as e:
        add("plan.memory", str(e))

    before = _state_dtypes(carry.states)
    inbox = _meta_inbox(carry.cal, meta)
    copies = _HostCopies(roots)
    step = None
    try:
        for tick in range(2):
            # the first tick may fill a cache; the lint watches the second
            with copies if tick == 1 else contextlib.nullcontext():
                step = prog._step_phase(carry, inbox, carry.t)
            carry = _dc.replace(carry, states=step["states"], status=step["status"],
                                finished_at=step["finished_at"], t=carry.t + 1)
    except Exception as e:  # noqa: BLE001 — the plan's step on meta
        return failed(e, f"tick {tick}", site)

    bad = []
    for name, (shape, dtype) in _step_contract(prog).items():
        x = step.get(name)
        if x is None:
            continue
        if tuple(x.shape) != shape or x.dtype != dtype:
            bad.append(f"{name} {tuple(x.shape)} {x.dtype} (expected "
                       f"{shape} {dtype})")
    if bad:
        add("plan.trace-error",
            f"the step's planes at {_where(site, ctx.plan_sources)} do not "
            f"match what the transport takes: {'; '.join(bad)}")

    if copies.hits:
        sites = sorted({f"torch.{n} at {_where((f, ln), ctx.plan_sources)}"
                        for n, f, ln in copies.hits})
        add("plan.host-callback",
            f"{len(copies.hits)} host→device cop(ies) inside the step on "
            f"the second traced tick ({', '.join(sites)}) — each waits on "
            "the host every tick; build constants once per program (the "
            "first step may fill a cache) and keep per-tick values on the "
            "device")
    after = _state_dtypes(carry.states)
    drift = [f"{k} {before[k]} → {after[k]}" for k in before
             if after.get(k, before[k]) != before[k]]
    if drift:
        shown = ", ".join(drift[:4]) + ("…" if len(drift) > 4 else "")
        add("plan.weak-type",
            f"{len(drift)} state leaf/leaves change dtype over two ticks "
            f"({shown}) — a Python literal promoted the leaf; give it an "
            "explicit dtype (torch.tensor(0.0, dtype=torch.float32), "
            ".to(torch.int32)) so every tick runs the same kernels")


# ------------------------------------------------------------ entry point


def _visible_cards() -> int:
    import torch

    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def check_composition(
    comp,
    manifest,
    *,
    env_layer: dict | None = None,
    devices: int = 0,
    trace_plans: bool = False,
    plan_sources: str = "",
) -> list[Finding]:
    """Evaluate every catalogued rule against one composition.

    ``comp`` is an ``api.Composition`` (pre-preparation — this function
    prepares its own clone, as the engine does); ``manifest`` its plan
    manifest; ``env_layer`` the env's ``[runners."sim:torch"]`` layer
    (coalesced under the composition's run_config, the executor's
    precedence); ``devices`` the device count (0 = the visible cards, 1
    without one); ``trace_plans`` adds the plan layer (layers 2 and 3, on
    the meta device) against the plan directory ``plan_sources``.

    Returns ALL findings, error and warn, in evaluation order — the caller
    decides presentation and exit codes."""
    from ..api import prepare_for_run, validate_for_run
    from ..config import CoalescedConfig
    from .executor import SimTorchConfig

    findings: list[Finding] = []
    try:
        validate_for_run(comp)
        prepared = prepare_for_run(comp, manifest)
    except Exception as e:  # noqa: BLE001 — structural refusals
        _add(findings, "composition.invalid", str(e))
        return findings

    if (prepared.global_.runner or "") != RUNNER:
        # the catalog guards the sim:torch admission surface; other
        # runners only get the structural validation above
        return findings

    raw_cfg = dict(prepared.global_.run_config or {})
    cfg = CoalescedConfig().append(env_layer).append(raw_cfg).coalesce_into(
        SimTorchConfig
    )
    if devices <= 0:
        devices = max(_visible_cards(), 1)
    ctx = CheckContext(comp=prepared, cfg=cfg, devices=devices,
                       trace_plans=trace_plans, plan_sources=plan_sources,
                       raw_run_config=raw_cfg, raw_env_layer=dict(env_layer or {}))

    _check_run_cfg_keys(ctx, findings)
    _check_mesh(ctx, findings)
    _check_transport(ctx, findings)
    _check_pack(ctx, findings)
    _check_resume_multi_runs(ctx, findings)
    for run in prepared.runs:
        resolved = _check_run(ctx, run, findings)
        if trace_plans and plan_sources:
            _trace_one_program(ctx, run, resolved, findings)
    return findings


# ------------------------------------------------------------- rendering


def render_findings(path: str, findings: list[Finding]) -> str:
    """Human-readable report for one composition file — one line per
    finding, errors first (stable within severity)."""
    errors = [f for f in findings if f.severity == "error"]
    warns = [f for f in findings if f.severity != "error"]
    if not findings:
        return f"{path}: ok (no findings)"
    lines = [f"{path}: {len(errors)} error(s), {len(warns)} warning(s)"]
    for f in errors + warns:
        where = f" (run {f.run})" if f.run else ""
        lines.append(f"  [{f.severity:5}] {f.rule}{where}: {f.message}")
    return "\n".join(lines)


def findings_payload(results: list[tuple[str, list[Finding]]]) -> dict:
    """The ``tg check --json`` document (schema version 1, the
    reference's)."""
    comps = [
        {
            "file": path,
            "findings": [f.to_dict() for f in fs],
            "errors": sum(1 for f in fs if f.severity == "error"),
            "warnings": sum(1 for f in fs if f.severity != "error"),
        }
        for path, fs in results
    ]
    return {
        "version": 1,
        "compositions": comps,
        "errors": sum(c["errors"] for c in comps),
        "warnings": sum(c["warnings"] for c in comps),
    }
