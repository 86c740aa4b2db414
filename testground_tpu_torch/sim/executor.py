"""The host side of a run of the port: a :class:`RunInput` in, a run
directory, a journal and an :class:`Outcome` out — the port of the
reference's ``execute_sim_run`` (``testground_tpu/sim/executor.py:735-2460``)
for one unbucketed run, on one device or on a mesh of peer shards.

The executor loads the port's plan (``testground_tpu_torch/plans/<plan>/``
unless a group names another ``artifact_path``), lowers the composition's
fault schedule, flight-recorder table and SLO rules, builds one
:class:`~testground_tpu_torch.sim.engine.SimProgram` on the run's device
(the card unless the runner config names another), steps it to completion
and writes what the reference writes under ``<outputs>/<plan>/<run_id>``:

- ``run_spans.jsonl`` (the run span and its build / execute / collect
  phases), ``sim_timeseries.jsonl``, ``sim_latency.jsonl``,
  ``sim_netmatrix.jsonl``, ``sim_trace.jsonl`` with ``trace_events.json``,
  ``sim_slo.jsonl`` and ``timeseries.jsonl``, each where its plane is on;
- one ``<group>/<instance>/`` directory per instance with ``run.out`` and
  ``metrics.out``, up to ``write_outputs_max`` instances;
- ``sim_perf.jsonl``, the perf ledger's row a chunk (``sim/perf.py``),
  on by default (``perf``) unless ``disable_metrics``, and a
  ``torch.profiler`` Chrome trace under ``profiles/`` with ``profile``
  (or a group's ``profiles``), of the whole run or of ``profile_chunks``
  chunks after the first;
- ``sim_phases.jsonl`` and the journal's ``sim.phases`` block with
  ``phases`` (``sim/phases.py``: the per-phase ledger of one tick on a
  fresh carry after the run, and with ``phases_measure = K`` each phase's
  ms over K ticks);
- the journal's ``sim`` (with ``sim.perf``), ``telemetry``, ``trace``,
  ``slo``, ``metrics``, ``timeseries``, ``profile`` and ``events``
  blocks.

The per-chunk sinks take the host numpy blocks that ``SimProgram.run``
already copied behind the done flag's wait: none of them reads the device.
The metric recorder reads the carry every ``timeseries_every`` ticks, as
the reference does.

With ``[daemon] influxdb_endpoint`` set in the env, the plan-metric rows,
the ``sim.*`` telemetry series (in their own bounded batches), the
``sim.latency.*`` rows and the ``sim.perf.*`` rows are mirrored to
InfluxDB as the reference mirrors them; the journal's ``influx``,
``influx_telemetry``, ``influx_latency`` and ``influx_perf`` blocks record
each push.

``transport = "auto"`` with ``transport_probe = K`` times the resolved
arm's ``deliver`` and ``net_commit`` over K ticks before the run and
journals the reading under ``sim.transport.scores``; the port has one arm
per device, so the probe measures and does not choose.

``checkpoint_chunks = K`` snapshots the run every K chunks into
``<run>/checkpoints/ckpt-<tick>.npz`` in the reference's archive format
(``sim/checkpoint.py``; ``checkpoint_keep`` bounds retention) and journals
``sim.checkpoint``; ``resume_from = <run id>`` seeds the run from that
run's newest snapshot (a run that already holds newer snapshots of its own
continues from those), with the streams, the SLO evaluator, the metric
recorder and the planes' accumulators continued where the snapshot left
them. A ``RunInput.preempt`` event stops the run at the next chunk
boundary after a forced snapshot there, and the run raises
``engine.controller.TaskPreemptedError`` for the supervisor to requeue.

Run packs (``pack = true``, ``pack_max``): ``execute_packed_sim_runs``
runs the members a pack claim gathered (``engine/pack.py``) as one program
over a run axis (``sim/pack.py``); each member keeps its run directory,
streams, SLO evaluation, perf rows, journal (with the reference's
``sim.pack`` block) and result, and equals its isolated run. A solo run
with ``pack = true`` runs as any run. On a mesh the pack's calendar is split
over the peer shards (the reference's bucket gate and unmeshed fallback,
and its ``pallas`` → ``xla`` override), and each member's journal has the
pack-shared ``sim.mesh`` block.

Multi-process cohorts (``coordinator_address``, ``num_processes``,
``process_id``; ``executor.py:650-842, 1068-1112, 3081-3255`` of the
reference): the engine never joins the cohort itself — the leader half
runs in a child process (``sim/cohort.py``) that calls this function again
with ``isolate_cohort`` off, joins the ``torch.distributed`` job
(``sim/distributed.py``), broadcasts the job spec (``_cohort_job_spec``,
its size prechecked before any process spawns) and runs the program over
the global mesh, while each ``tg sim-worker`` (:func:`run_sim_worker`)
runs the same program from the spec. A cohort config turns off, each with
the reference's warning, telemetry, the traffic matrix, the flight
recorder, the SLO plane, checkpointing, buckets, ``nan_guard`` and the
perf ledger (and the phase ledger, the time-series samples and the
transport probe, which read the leader alone); ``resume_from`` is refused.

Shape buckets (``bucket = off|auto|<n>``, ``bucket_ladder``;
``resolve_buckets``, ``executor.py:395-452, 846-965``): a bucketed run's
groups are padded to the ladder, the plan is specialized against the
padded layout, the fault schedule is lowered in the exact layout and
remapped, the flight recorder is off, and the journal's ``sim.bucket``
block is the reference's. Its ``compile_cache`` verdict is the port's
cold start (:func:`compile_cache_verdict`): ``"miss"`` when this process
ran nvcc for the kernels the run launched, ``"hit"`` when the library was
already built, ``"unknown"`` on a resumed run and ``"off"`` on the CPU or
with the cache disabled. Every result, stream and total stays exact-N.

A mesh (``mesh="4"``, ``mesh="2x4"``, or ``shard`` on a host with several
cards) splits the calendar over the peer shards (``sim/meshplan.py``; a
solo run on a 2-D mesh over row 0's); on a mesh of several parts (one a
card) each part holds and steps its own lanes of the whole carry, one
host thread a part (``sim/engine.py`` ``PartedCarry``), and every plane,
the SLO plane, the ledgers, checkpoints and resume read it whole; the
journal's ``sim.mesh`` block is the reference's. A lane count that does not divide
across the shards runs under ``xla`` and ``auto`` with dead lanes that the
engine keeps to itself (``SimProgram.mesh_pad``); ``pallas`` refuses it,
as the reference's engine does.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib.util
import json
import os
import sys
import threading
import time
import uuid

import numpy as np
import torch

from ..api import RunInput, RunOutput
from ..engine.task import Outcome
from ..rpc import OutputWriter
from ..runners.outputs import instance_output_dir
from ..runners.result import Result
from .meshplan import (
    cross_shard_bytes_est,
    layout_str,
    make_mesh,
    parse_mesh_shape,
    plan_for,
)

__all__ = [
    "SimTorchConfig",
    "check_mesh_lanes",
    "execute_packed_sim_runs",
    "execute_sim_run",
    "fault_specs_of",
    "instantiate_testcase",
    "load_and_specialize",
    "load_sim_testcases",
    "make_sim_program",
    "plan_dir",
    "slo_specs_of",
    "trace_specs_of",
    "run_sim_worker",
    "sim_worker_loop",
    "transport_knob",
]

PLANS_ROOT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "plans"
)

# Map sim status codes → lifecycle event names (pretty.go:163-175).
_STATUS_NAME = {0: "incomplete", 1: "success", 2: "failure", 3: "crash"}


@dataclasses.dataclass
class SimTorchConfig:
    """Runner config of the port: the fields and defaults of the
    reference's ``SimJaxConfig`` (``executor.py:44-246``; each field means
    what it means there), plus ``device``."""

    tick_ms: float = 1.0  # simulated ms per tick
    max_ticks: int = 100_000  # sim-time budget
    chunk: int = 128  # ticks between host callbacks
    seed: int = 0
    # shard over every visible card (the reference's default): no mesh
    # on a host with one card or on the CPU
    shard: bool = True
    # explicit mesh, 1-D peers ("4") or 2-D runs x peers ("2x4"), over the
    # visible cards, or virtual on the CPU; wins over shard
    mesh: str = ""
    write_outputs_max: int = 2048  # cap on per-instance output dirs
    keep_outputs: bool = True
    # metric time-series cadence in ticks (0 disables); each sample reads
    # the plan states off the device
    timeseries_every: int = 1024
    validate: bool = False  # direct-slot collision detection
    # wall-clock watchdog per chunk from the third chunk on (0 disables)
    chunk_timeout_secs: float = 0.0
    nan_guard: bool = False  # scan the carry for NaN/Inf after each chunk
    debug_chunk_sleep_ms: float = 0.0  # synthetic host slowdown per chunk
    telemetry: bool = False
    netmatrix: bool = False  # needs telemetry
    # the perf ledger: sim_perf.jsonl and the journal's sim.perf block
    perf: bool = True
    # a torch.profiler trace of the whole run under <run>/profiles
    profile: bool = False
    # > 0: the profiler captures only this many chunks after the first
    profile_chunks: int = 0
    # the phase ledger (sim/phases.py) after the run: sim.phases and
    # sim_phases.jsonl; disable_metrics wins
    phases: bool = False
    # > 0 (with phases): each phase's measured ms/tick over this many ticks
    phases_measure: int = 0
    # "xla", "pallas" or "auto": on the card every value runs K1/K2, on
    # the CPU their plain versions; the journal records what ran
    transport: str = "xla"
    # > 0 with transport "auto": time the resolved arm's deliver and
    # net_commit over this many ticks before the run (sim.transport.scores)
    transport_probe: int = 0
    # shape buckets: "off", "auto" (the ladder) or an explicit count
    bucket: str = "off"
    bucket_ladder: str = ""  # "" = buckets.DEFAULT_LADDER
    # run packs: claim queued compatible runs into one program
    pack: bool = False
    pack_max: int = 8  # the widest pack a claim builds
    # the sim:plan builder warms the bucket ladder (tg build --buckets)
    build_buckets: bool = False
    # > 0: a snapshot every this many chunks (sim/checkpoint.py)
    checkpoint_chunks: int = 0
    checkpoint_keep: int = 3  # newest snapshots kept
    resume_from: str = ""  # a run id of this plan to resume from
    additional_hosts: list = dataclasses.field(default_factory=list)
    # per-run device-memory precheck: 0 = the card's total memory (no
    # check on the CPU), -1 = off, > 0 = an explicit budget in bytes
    memory_limit_bytes: int = 0
    # a multi-process cohort (sim/distributed.py): this engine leads it,
    # and num_processes - 1 `tg sim-worker` processes join the coordinator
    coordinator_address: str = ""
    num_processes: int = 1
    process_id: int = 0
    # run the leader half in a killable child process so member death
    # fails the task, not the engine (sim/cohort.py); stripped on the hop
    isolate_cohort: bool = True
    # the run's device: None is the card (raises without one), "cpu" runs
    # the plain versions of the kernels
    device: str | None = None


_TRANSPORTS = ("xla", "pallas", "auto")


def transport_knob(cfg) -> str:
    """The ``transport`` knob, lowercased as the reference reads it;
    anything but xla, pallas or auto is refused with the reference's
    message."""
    from .check import unknown_transport_message

    requested = str(getattr(cfg, "transport", "xla") or "xla").lower()
    if requested not in _TRANSPORTS:
        raise ValueError(unknown_transport_message(requested))
    return requested


def check_mesh_lanes(transport: str, n: int, hosts: int, shards: int) -> None:
    """Refuse a lane count (instances + hosts) that does not divide across
    ``shards`` peer shards under ``transport=pallas``, with the reference
    engine's message. Under xla and auto the engine pads the last group
    with dead lanes (``SimProgram.mesh_pad``), as the reference's XLA
    transport pads the lane axis."""
    from .check import pallas_lanes_message

    lanes = n + hosts
    if shards <= 1 or lanes % shards == 0:
        return
    if transport == "pallas":
        raise ValueError(pallas_lanes_message(n, hosts, shards))


def resolve_buckets(cfg, counts, mesh=None, warn=None):
    """The one shape-bucketing gate (``executor.py:395-452``, its rules and
    messages): validate the ``bucket``/``bucket_ladder`` knobs and apply
    the structural bounds. Returns a ``buckets.BucketPlan`` or None (exact
    shapes). Shared by the executor, the sim:plan ladder warm and ``tg
    check``. ``warn`` is a ``(fmt, *args)`` callable for loud fallbacks."""
    from .buckets import parse_bucket_mode, parse_ladder, plan_buckets

    mode = parse_bucket_mode(getattr(cfg, "bucket", "off"))
    if mode == "off":
        return None
    if getattr(cfg, "coordinator_address", ""):
        if warn is not None:
            warn(
                "shape bucketing disabled for the cohort config (the "
                "runtime-N carry input is leader-local state a follower "
                "cannot reproduce symmetrically)"
            )
        return None
    ladder = parse_ladder(getattr(cfg, "bucket_ladder", "") or None)
    plan = plan_buckets(counts, mode, ladder)
    if plan is not None and mesh is not None:
        # a bucketed run shards the PADDED instance axis: every rung's
        # padded count must divide across the peer shards
        from .meshplan import indivisible_counts, peer_shards

        shards = peer_shards(mesh)
        bad = indivisible_counts(plan.padded_counts, shards)
        if bad:
            if warn is not None:
                warn(
                    "shape bucketing skipped on this mesh: padded "
                    "count(s) %s do not divide across %d peer shard(s) "
                    "— running exact shapes; pick a bucket ladder whose "
                    "rungs are multiples of the shard count",
                    ",".join(str(c) for c in bad),
                    shards,
                )
            return None
    if plan is None:
        if warn is not None:
            warn(
                "shape bucketing skipped: a group's %s instances exceed "
                "the bucket coverage (ladder %s) — running exact shapes; "
                "raise bucket_ladder to bucket runs this large",
                max(counts),
                ",".join(str(r) for r in ladder)
                if mode == "auto"
                else mode,
            )
        return None
    return plan


def compile_cache_verdict(device: torch.device, cache_on: bool, resumed: bool,
                          nvcc_builds: int) -> str:
    """A bucketed run's ``sim.bucket.compile_cache`` (the reference's
    ``executor.py:1836-1846``, read off the port's one compiled artifact,
    the kernel library): ``"off"`` when the compile cache is disabled or the
    run is on the CPU (nothing is compiled), ``"unknown"`` for a resumed
    run, else ``"miss"`` when ``nvcc_builds`` (the builds this run claimed,
    ``cuda_transport.claim_kernel_builds``) is not 0 and ``"hit"`` when the
    library was already built."""
    if not cache_on or device.type != "cuda":
        return "off"
    if resumed:
        return "unknown"
    return "miss" if nvcc_builds > 0 else "hit"


def _cache_on(job) -> bool:
    """Whether the compile cache is on for ``job``'s home
    (``utils/compile_cache.compile_cache_dir``; a job without an env's
    home resolves the default one)."""
    from ..utils.compile_cache import compile_cache_dir

    return compile_cache_dir(getattr(getattr(job.env, "dirs", None), "home", None)) is not None


def _refuse_malformed(cfg) -> None:
    """Raise for a malformed ``mesh`` and an unknown transport."""
    mesh = getattr(cfg, "mesh", "")
    if mesh:
        parse_mesh_shape(mesh)
    transport_knob(cfg)


# ------------------------------------------------------------ plan loading


def plan_dir(plan: str) -> str:
    """The port's directory of plan ``plan`` (e.g. ``"network"``)."""
    return os.path.join(PLANS_ROOT, plan)


def load_sim_testcases(artifact_path: str) -> dict:
    """Import the plan's sim module and return its ``sim_testcases`` map."""
    entry = None
    for name in ("sim.py", "main.py"):
        cand = os.path.join(artifact_path, name)
        if os.path.isfile(cand):
            entry = cand
            break
    if entry is None:
        raise FileNotFoundError(f"no sim.py/main.py entry point in {artifact_path}")
    modname = f"tg_torch_plan_{uuid.uuid4().hex[:8]}"
    spec = importlib.util.spec_from_file_location(modname, entry)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[modname] = mod
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.modules.pop(modname, None)
    cases = getattr(mod, "sim_testcases", None)
    if not isinstance(cases, dict) or not cases:
        raise ValueError(
            f"plan module {entry} does not export a non-empty `sim_testcases` dict"
        )
    return cases


def instantiate_testcase(factory, groups, tick_ms: float):
    """Specialize-then-instantiate a testcase factory (one path for every
    caller, so the same run always builds the same shapes)."""
    if isinstance(factory, type):
        return factory.specialize(groups, tick_ms=tick_ms)()
    return factory


def load_and_specialize(artifact_path, test_case, run_groups, tick_ms):
    """Plan sources → specialized testcase + group layout
    (``executor.py:286-301``)."""
    from .engine import build_groups

    cases = load_sim_testcases(artifact_path)
    factory = cases.get(test_case)
    if factory is None:
        raise ValueError(
            f"unknown sim test case {test_case!r}; plan exposes {sorted(cases)}"
        )
    groups = build_groups(run_groups)
    return instantiate_testcase(factory, groups, tick_ms), groups


def make_sim_program(
    testcase,
    groups,
    *,
    test_plan,
    test_case,
    test_run,
    tick_ms,
    chunk,
    hosts,
    validate,
    telemetry,
    faults,
    trace,
    netmatrix,
    device,
    mesh,
    live_counts=None,
    lane_multiple=1,
):
    """The one construction site for a run's SimProgram
    (``executor.py:304-346``): every program-shaping option is a required
    keyword but ``live_counts`` (a bucket plan's exact counts) and
    ``lane_multiple`` (a meshed pack's peer shards). On a mesh the
    program's leaves live on its primary device."""
    from .engine import SimProgram

    return SimProgram(
        testcase,
        groups,
        test_plan=test_plan,
        test_case=test_case,
        test_run=test_run,
        tick_ms=tick_ms,
        chunk=chunk,
        hosts=hosts,
        validate=validate,
        telemetry=telemetry,
        faults=faults,
        trace=trace,
        netmatrix=netmatrix,
        device=None if mesh is not None else device,
        mesh=mesh,
        live_counts=live_counts,
        lane_multiple=lane_multiple,
    )


# ------------------------------------------------------ declaration tables


def fault_specs_of(run_groups, global_faults=None) -> dict:
    """{group_id: [raw fault dicts]}, run-global declarations under ``""``
    (``executor.py:454-466``)."""
    specs = {
        g.id: [dict(f) for f in (getattr(g, "faults", None) or [])]
        for g in run_groups
    }
    specs[""] = [dict(f) for f in (global_faults or [])]
    return {k: v for k, v in specs.items() if v}


def trace_specs_of(run_groups, global_trace=None) -> dict:
    """{group_id: raw trace table}, the run-global one under ``""``
    (``executor.py:469-480``)."""
    specs = {g.id: dict(getattr(g, "trace", None) or {}) for g in run_groups}
    specs[""] = dict(global_trace or {})
    return {k: v for k, v in specs.items() if v}


def slo_specs_of(run_groups, global_slo=None) -> dict:
    """{group_id: [raw slo dicts]}, run-global rules under ``""``
    (``executor.py:483-497``)."""
    specs = {
        g.id: [dict(s) for s in (getattr(g, "slo", None) or [])]
        for g in run_groups
    }
    specs[""] = [dict(s) for s in (global_slo or [])]
    return {k: v for k, v in specs.items() if v}


class _SloRunCancel:
    """OR of the task's cancel event with a run-local signal
    (``executor.py:500-520``). ``set()`` keeps the task-level meaning (the
    stall watchdog calls it); the SLO evaluator cancels through
    ``run_local``: a fail-severity breach fails the run, not the task."""

    def __init__(self, task_cancel: threading.Event):
        self._task = task_cancel
        self.run_local = threading.Event()

    def set(self) -> None:
        self._task.set()

    def is_set(self) -> bool:
        return self.run_local.is_set() or self._task.is_set()


class _PreemptRunCancel:
    """OR of the fleet controller's preemption signal with the run's cancel
    object (``executor.py:522-540``): the loop stops at the next chunk
    boundary when either is set, after the preempt observer forced a
    snapshot at that boundary. ``set()`` keeps the task-level meaning."""

    def __init__(self, inner, preempt):
        self._inner = inner
        self._preempt = preempt

    def set(self) -> None:
        self._inner.set()

    def is_set(self) -> bool:
        return self._preempt.is_set() or self._inner.is_set()


def _parse_hosts(raw) -> tuple[str, ...]:
    """The additional_hosts config: a list, or a comma-separated string."""
    if not raw:
        return ()
    if isinstance(raw, str):
        raw = raw.split(",")
    return tuple(s for s in (str(h).strip() for h in raw) if s)


def _make_mesh(shard: bool, shape: str, device: torch.device):
    """The executor's mesh gate (``executor.py:554-565``): an explicit
    ``mesh="4"`` wins over the boolean ``shard`` (every visible card, 1-D).
    A single device, and ``shard`` on the CPU, give None. An explicit
    shape on the CPU is a virtual mesh there."""
    if shape:
        return make_mesh(shape, device=device)
    if not shard:
        return None
    return make_mesh(None, device=device)


# K1's default stream tile in the reference (pallas_transport.py:123): the
# tile-padded stream sizes the modeled exchange
_COMMIT_TILE = 4096


def _stream_bytes_per_tick(testcase, groups, hosts) -> int:
    """Bytes of the tile-padded sorted stream one commit consumes, the
    (2+W) int32 words (key, occupancy value, payload) per message
    (``transport_model.py:379-391``)."""
    cls = type(testcase)
    n_lanes = sum(g.count for g in groups) + len(hosts)
    m2 = cls.OUT_MSGS * n_lanes * (2 if "duplicate" in cls.SHAPING else 1)
    m2p = -(-max(m2, 1) // _COMMIT_TILE) * _COMMIT_TILE
    return (2 + int(cls.MSG_WIDTH)) * m2p * 4


def _mesh_journal_block(mesh, testcase, groups, hosts):
    """The ``sim.mesh`` journal block (``executor.py:568-600``): the layout
    string, the shard extents, the rule table and the modeled per-commit
    exchange bytes. None without a mesh."""
    if mesh is None:
        return None
    plan = plan_for(mesh)
    return {
        "axes": layout_str(mesh),
        "shards": plan.shards,
        "runs": plan.runs,
        "layout_table": plan.layout_table(),
        "cross_shard_bytes_est": int(
            cross_shard_bytes_est(
                stream_bytes=_stream_bytes_per_tick(testcase, groups, hosts),
                shards=plan.shards,
            )
        ),
    }


# headroom over the exact carry footprint (``executor.py:603-607``)
_MEM_HEADROOM = 2.5


def _precheck_device_memory(prog, carry: int, cfg, ow, device, mesh=None,
                            per_device: bool = False) -> None:
    """Refuse an oversized composition before its first tick
    (``executor.py:610-647``): the carry footprint × headroom, divided
    across the mesh's distinct devices, against the memory of ``device``
    (the run's card), or an explicit ``memory_limit_bytes``. ``device`` is
    the run's device, not the program's: ``tg check`` builds the program
    on the meta device and passes the card the run would use, or None
    where it has none. ``mesh`` is the mesh the carry spreads over where it
    is not the program's: a run pack's calendar mesh (``sim/pack.py``).
    ``per_device``: ``carry`` is already the bytes one device holds (a
    placed pack's part, checked against its own card)."""
    limit = int(getattr(cfg, "memory_limit_bytes", 0) or 0)
    if limit < 0:
        return
    if limit == 0:
        if device is None or device.type != "cuda":
            return  # no device budget to check against
        limit = torch.cuda.get_device_properties(device).total_memory
    mesh = prog.mesh if mesh is None else mesh
    n_dev = 1 if mesh is None or per_device else len(set(mesh.devices))
    need = int(carry * _MEM_HEADROOM / n_dev)
    if need > limit:
        raise RuntimeError(
            f"composition needs ~{need / 2**30:.2f} GiB per device "
            f"(carry {carry / 2**30:.2f} GiB × {_MEM_HEADROOM} headroom "
            f"/ {n_dev} device(s)) but the device budget is "
            f"{limit / 2**30:.2f} GiB — shrink the composition "
            "(instances, IN_MSGS/MSG_WIDTH, MAX_LINK_TICKS, TOPIC_CAP) "
            "or run on more devices; set runner config "
            "memory_limit_bytes = -1 to override this precheck"
        )
    ow.infof(
        "memory precheck: ~%.2f GiB/device of %.2f GiB budget (carry "
        "%.2f GiB on %d device(s))",
        need / 2**30, limit / 2**30, carry / 2**30, n_dev,
    )


def _transport_block(cfg, device: torch.device, mesh=None) -> dict:
    """The ``sim.transport`` journal block: what the config asked for and
    what ran."""
    if device.type == "cuda":
        resolved = "cuda"
        reason = ("K1 commit_k and K2 pop_vec_k/pop_scalar_k "
                  "(csrc/transport.cu) on the card")
        if mesh is not None:
            reason = ("sharded K1 commit_k and K2 pop_shard_vec_k/"
                      "pop_shard_scalar_k (csrc/transport.cu), one launch "
                      "per device of the mesh")
    else:
        resolved = "plain"
        reason = f"the plain torch versions of K1 and K2 on {device.type}"
        if mesh is not None:
            reason = ("the plain torch versions of the sharded K1 and K2 on "
                      f"{device.type}")
    return {"requested": cfg.transport, "resolved": resolved, "reason": reason}


def _probe_transport(prog, block: dict, reps: int, seed: int) -> dict:
    """The ``transport_probe`` reading under ``transport = "auto"``: the
    resolved arm's ``deliver`` + ``net_commit`` ms per tick over ``reps``
    ticks on a fresh carry (``sim/phases.measure_phases``). The reference
    times two arms and picks the faster
    (``testground_tpu/sim/transport_model.py:447-511``); the port has one
    arm per device and never runs the plain version on a CUDA tensor, so
    the resolution stays and the reading is journaled."""
    from .phases import measure_phases

    arm, backend = block["resolved"], prog.device.type
    note = ("the port has one arm per device (K1 and K2 on the card, their "
            "plain versions on the CPU): the probe measures the resolved arm "
            "and does not choose")
    try:
        ms = measure_phases(prog, reps, seed=seed)
        per_tick = ms["deliver"] + ms["net_commit"]
    except Exception as e:  # noqa: BLE001 — the probe is best-effort
        return {**block,
                "reason": f"measured probe failed on the {arm} arm ({e}); {note}",
                "scores": {"source": "measured", "backend": backend}}
    return {
        **block,
        "reason": (f"measured probe: {arm} {per_tick:.3f} ms per tick over "
                   f"{reps} rep(s) on {backend}; {note}"),
        "scores": {"source": "measured", "backend": backend,
                   f"{arm}_ms_per_tick": round(per_tick, 6), "reps": reps},
    }


# ------------------------------------------------------------- the cohort


def _cohort_job_spec(job: RunInput, cfg, *, hosts, telemetry, transport, faults) -> dict:
    """The cohort job spec (``executor.py:650-687``) — the ONE dict shape both
    the leader's ``broadcast_json`` and the pre-spawn size check build.
    Every program-shaping option must reach the followers, so gated values
    (telemetry post its cohort gate) are passed in by the caller; cohorts
    run trace-free and SLO-free, kept explicit as the reference keeps them."""
    return {
        "plan": job.test_plan,
        "case": job.test_case,
        "run_id": job.run_id,
        "groups": [
            {"id": g.id, "instances": g.instances, "parameters": dict(g.parameters)}
            for g in job.groups
        ],
        "tick_ms": cfg.tick_ms,
        "chunk": cfg.chunk,
        "seed": cfg.seed,
        "max_ticks": cfg.max_ticks,
        "hosts": list(hosts),
        "validate": bool(getattr(cfg, "validate", False)),
        "telemetry": bool(telemetry),
        "transport": str(transport),
        "faults": faults,
        "trace": {},
        "slo": [],
    }


def _precheck_cohort_spec_size(job: RunInput, cfg) -> None:
    """Refuse a cohort job spec over the broadcast bound BEFORE any process
    is spawned or collective entered (``executor.py:690-733``, its bound
    and message): the spec the leader would broadcast, with the values a
    cohort always broadcasts (telemetry off, transport xla)."""
    from .distributed import SPEC_BYTES

    spec = _cohort_job_spec(
        job, cfg, hosts=_parse_hosts(getattr(cfg, "additional_hosts", None)),
        telemetry=False, transport="xla",
        faults=fault_specs_of(job.groups, getattr(job, "faults", None)),
    )
    raw = len(json.dumps(spec).encode()) + 8  # the length prefix
    if raw > SPEC_BYTES:
        biggest = max(job.groups, key=lambda g: len(json.dumps(dict(g.parameters))),
                      default=None)
        hint = (
            f" (largest parameter blob: group {biggest.id!r}, "
            f"{len(json.dumps(dict(biggest.parameters)))} bytes)"
            if biggest is not None else ""
        )
        raise ValueError(
            f"cohort job spec is {raw:,} bytes, over the {SPEC_BYTES:,}-"
            "byte broadcast bound — shrink the composition's group "
            f"parameters or fault tables{hint}; refused before spawning "
            "the cohort (the broadcast inside the collective would fail "
            "anyway, stranding every joined worker)"
        )


def _join_cohort(cfg) -> bool:
    """Join the cohort of a config with ``coordinator_address`` (before
    anything of the run touches a collective); True when it has several
    processes. Refuses a join that reports one process where several were
    asked for (``executor.py:820-842``)."""
    from .distributed import init_distributed, is_multiprocess

    init_distributed(cfg.coordinator_address, cfg.num_processes, cfg.process_id)
    multi = is_multiprocess()
    if int(getattr(cfg, "num_processes", 1)) > 1 and not multi:
        raise RuntimeError(
            f"runner config requested a {cfg.num_processes}-process "
            "cohort but the distributed runtime reports a single "
            "process — the torch.distributed group did not join "
            "(environment mismatch between cohort members?); refusing to "
            "run on the wrong topology"
        )
    return multi


def sim_worker_loop(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    plans_dir: str,
    once: bool = False,
    log=print,
    connect_attempts: int = 3,
    connect_timeout_secs: float = 60.0,
    device=None,
    on_result=None,
) -> None:
    """Follower half of a cohort (the ``tg sim-worker`` verb,
    ``executor.py:3081-3203``).

    Joins the cohort, then for each job spec the leader broadcasts: load
    the same plan from this process's plans dir, build the identical
    program over the global mesh on ``device`` (None: the card), and run
    it to completion. The leader owns reporting. ``once`` serves at most
    one job, then keeps taking part in the spec broadcast until the
    leader's shutdown sentinel arrives — leaving early would desync the
    cohort (a second job spec in once mode is skipped via the readiness
    vote). ``on_result(spec, results, carry)`` sees each run's results and
    this process's final carry; ``results['carry_digest']`` is the digest
    of the whole carry gathered from every process
    (``SimProgram.carry_digest``), the leader's."""
    from ..api import RunGroup
    from .distributed import (
        CohortCancel,
        broadcast_json,
        cohort_agree,
        global_mesh,
        init_distributed,
        shutdown,
    )
    from .engine import resolve_device
    from .faults import build_fault_schedule
    from .trace import build_trace_plan

    dev = resolve_device(device)
    # a worker routinely starts before the leader: join with the bounded
    # retry budget (a readable failure naming the coordinator)
    init_distributed(
        coordinator_address, num_processes, process_id,
        connect_attempts=connect_attempts,
        connect_timeout_seconds=connect_timeout_secs,
    )
    import torch.distributed as dist

    log(f"sim-worker: process {dist.get_rank()}/{dist.get_world_size()} "
        f"joined, {dist.get_world_size()} global devices")
    served = False
    while True:
        spec = broadcast_json(None)
        if spec.get("shutdown"):
            log("sim-worker: shutdown")
            # leave the process groups now: torn down by the interpreter's
            # exit instead, gloo's threads can abort the process
            shutdown()
            return
        # readiness vote BEFORE any program collective: if this (or any)
        # process cannot build the job, the whole cohort skips it
        try:
            if once and served:
                raise RuntimeError("once-mode worker already served a job")
            testcase, groups = load_and_specialize(
                os.path.join(plans_dir, spec["plan"]),
                spec["case"],
                [RunGroup(id=d["id"], instances=d["instances"],
                          parameters=d["parameters"]) for d in spec["groups"]],
                spec["tick_ms"],
            )
            ok = True
        except Exception as e:  # noqa: BLE001 — voted, not raised
            log(f"sim-worker: cannot satisfy {spec['plan']}:{spec['case']}: {e}")
            ok = False
        if not cohort_agree(ok):
            log(f"sim-worker: cohort skipped run {spec['run_id']}")
            continue
        prog = make_sim_program(
            testcase,
            groups,
            test_plan=spec["plan"],
            test_case=spec["case"],
            test_run=spec["run_id"],
            tick_ms=spec["tick_ms"],
            chunk=spec["chunk"],
            hosts=tuple(spec.get("hosts", ())),
            validate=bool(spec.get("validate", False)),
            telemetry=bool(spec.get("telemetry", False)),
            # the same spec dict lowers to the same event tensors on every
            # process, so the cohort runs one program
            faults=build_fault_schedule(groups, spec.get("faults") or {},
                                        spec["tick_ms"]),
            trace=build_trace_plan(groups, spec.get("trace") or {}),
            # cohorts run matrix-free and bucket-free (the leader's gates)
            netmatrix=False,
            device=dev,
            mesh=global_mesh(dev),
        )
        final = {}
        res = prog.run(
            seed=spec["seed"], max_ticks=spec["max_ticks"],
            cancel=CohortCancel(None),
            observer=lambda ticks, carry: final.update(carry=carry),
        )
        # the whole carry's digest, gathered in the leader's lockstep
        res["carry_digest"] = prog.carry_digest(final["carry"])
        if on_result is not None:
            on_result(spec, res, final.get("carry"))
        log(f"sim-worker: run {spec['run_id']} done — {res['ticks']} ticks")
        served = True


def _launch_counts() -> dict:
    """The transport kernels' launch counters of this process (each
    wrapper's, ``cuda_transport``): what a harness reads off a cohort
    member's log to show its run went through the kernels."""
    from . import cuda_transport as ct

    return {k: getattr(ct, k).launches for k in (
        "commit_calendar", "pop_bucket", "commit_calendar_sharded", "pop_bucket_sharded")}


def run_sim_worker(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    plans_dir: str,
    once: bool = False,
    log=print,
    _exit=os._exit,
    connect_attempts: int = 3,
    connect_timeout_secs: float = 60.0,
    device=None,
    on_result=None,
) -> int:
    """The ``tg sim-worker`` entry (``executor.py:3206-3255``):
    :func:`sim_worker_loop` wrapped so a DEAD LEADER ends the worker with
    one readable line and an immediate exit, classified with the cohort
    child's typed-first rule (``cohort._is_cohort_fatal``); the exit skips
    the process group's teardown, which would wait on the dead member.
    Other exceptions re-raise unchanged; ``_exit`` is injectable for
    tests."""
    try:
        sim_worker_loop(
            coordinator_address, num_processes, process_id, plans_dir,
            once=once, log=log, connect_attempts=connect_attempts,
            connect_timeout_secs=connect_timeout_secs, device=device,
            on_result=on_result,
        )
    except KeyboardInterrupt:
        raise
    except BaseException as e:  # noqa: BLE001 — classified below
        from .cohort import _is_cohort_fatal

        if _is_cohort_fatal(e):
            log(
                "sim-worker: cohort lost (leader or member died: "
                f"{type(e).__name__}) — exiting cleanly; restart every "
                "sim-worker to form a new cohort"
            )
            sys.stdout.flush()
            _exit(1)
            return 1  # only reached when _exit is a test stub
        raise
    return 0


# ------------------------------------------------------------------ the run


def execute_sim_run(
    job: RunInput, ow: OutputWriter, cancel: threading.Event
) -> RunOutput:
    """Run ``job`` through the port and write its run directory
    (``executor.py:735-793``). ``cancel`` (a ``threading.Event``) stops the
    run at the next chunk's end; the outcome is then CANCELED."""
    cfg = job.runner_config or SimTorchConfig()
    _refuse_malformed(cfg)
    # oversized cohort specs are refused HERE — before the leader child is
    # spawned and before any process joins
    if getattr(cfg, "coordinator_address", ""):
        _precheck_cohort_spec_size(job, cfg)
        if str(getattr(cfg, "resume_from", "") or ""):
            # shared with the static checker (rule checkpoint.resume-cohort)
            from .check import resume_cohort_message

            raise ValueError(resume_cohort_message())
    # the engine NEVER joins the cohort in-process: the leader half runs in
    # a killable child that calls this function again with isolate_cohort
    # off, so a member's death fails the task and not the engine
    if getattr(cfg, "coordinator_address", "") and getattr(cfg, "isolate_cohort", True):
        from .cohort import run_in_cohort_child

        return run_in_cohort_child(job, cfg, ow, cancel)
    from .engine import resolve_device

    device = resolve_device(getattr(cfg, "device", None))
    outputs_root = job.env.dirs.outputs() if job.env is not None else None
    run_dir = None
    if outputs_root is not None:
        run_dir = os.path.join(outputs_root, job.test_plan, job.run_id)
        os.makedirs(run_dir, exist_ok=True)
    from .telemetry import SPAN_FILE, SpanTracer

    spans = SpanTracer(
        os.path.join(run_dir, SPAN_FILE)
        if run_dir is not None and not job.disable_metrics
        else None,
        ctx=getattr(job, "trace_ctx", None),
    )
    spans.start("run", run_id=job.run_id, plan=job.test_plan, case=job.test_case)
    try:
        return _execute_sim_run(job, cfg, device, ow, cancel, outputs_root,
                                run_dir, spans)
    except BaseException as e:
        # failed runs keep their span record; a preemption is no failure
        from ..engine.controller import TaskPreemptedError

        outcome = "preempted" if isinstance(e, TaskPreemptedError) else "error"
        spans.end("run", outcome=outcome, error=str(e)[:200])
        raise
    finally:
        spans.close()


def _execute_sim_run(job, cfg, device, ow, cancel, outputs_root, run_dir, spans):
    from . import netmatrix as _netmatrix
    from .check import (
        netmatrix_requires_telemetry_message,
        slo_requires_telemetry_message,
    )
    from .faults import build_fault_schedule
    from .slo import SLO_FILE, SloBreachError, SloEvaluator, build_slo_plan
    from .telemetry import (
        LATENCY_FILE,
        NETMATRIX_FILE,
        SIM_SERIES_FILE,
        latency_percentiles,
    )
    from .trace import build_trace_plan

    cohort = bool(getattr(cfg, "coordinator_address", ""))
    # the cohort join precedes anything of the run that could touch a
    # collective
    multi = _join_cohort(cfg) if cohort else False
    artifact = job.groups[0].artifact_path or plan_dir(job.test_plan)
    spans.start("build")
    # a cohort's mesh is the global one, built once every member has voted
    mesh = None if multi else _make_mesh(bool(getattr(cfg, "shard", True)),
                                         getattr(cfg, "mesh", ""), device)
    # shape buckets: resolved before specialization — the padded layout is
    # what the testcase specializes against, while every lowering that
    # addresses instances (fault selectors, SLO scoping, reporting) works
    # in the EXACT layout and is remapped or demuxed at the edges
    bucket_plan = resolve_buckets(cfg, [g.instances for g in job.groups], mesh=mesh,
                                  warn=ow.warn)
    padded_in = job.groups
    if bucket_plan is not None:
        padded_in = [dataclasses.replace(g, instances=p)
                     for g, p in zip(job.groups, bucket_plan.padded_counts)]
    testcase, groups = load_and_specialize(
        artifact, job.test_case, padded_in, cfg.tick_ms
    )
    if (bucket_plan is not None and "filter_rules" in type(testcase).SHAPING
            and len(groups) > 1):
        ow.warn(
            "sim:torch %s: shape bucketing disabled — 'filter_rules' "
            "shaping with multiple groups addresses the exact layout "
            "(rule ranges cannot survive per-group padding); running "
            "exact shapes",
            job.run_id,
        )
        bucket_plan = None
        testcase, groups = load_and_specialize(
            artifact, job.test_case, job.groups, cfg.tick_ms
        )
    from .engine import build_groups

    # the EXACT layout every host-side surface reports in
    vgroups = build_groups(job.groups) if bucket_plan is not None else groups
    n = sum(g.count for g in vgroups)
    if bucket_plan is not None:
        ow.infof("sim:torch %s: shape bucket — %s", job.run_id, bucket_plan.summary())
    hosts = _parse_hosts(getattr(cfg, "additional_hosts", None))

    # fault plane: the composition's chaos schedule, lowered in the exact
    # layout the operator declared it in
    fault_specs = fault_specs_of(job.groups, getattr(job, "faults", None))
    fault_schedule = build_fault_schedule(vgroups, fault_specs, cfg.tick_ms)
    # which group pairs the schedule degrades (journal
    # sim.net_matrix.faulted_pairs), read before any bucket remap
    nm_faulted = None
    if fault_schedule is not None and bool(getattr(cfg, "netmatrix", False)):
        nm_faulted = _netmatrix.faulted_pairs(fault_schedule, vgroups)
    if fault_schedule is not None and bucket_plan is not None:
        from .faults import remap_schedule

        fault_schedule = remap_schedule(
            fault_schedule, bucket_plan.index_map(), bucket_plan.padded_n
        )
    if fault_schedule is not None:
        ow.infof("sim:torch %s: fault schedule armed — %s", job.run_id,
                 fault_schedule.summary())

    # flight recorder: disable_metrics wins, and bucketing turns it off
    trace_specs = trace_specs_of(job.groups, getattr(job, "trace", None))
    trace_plan = build_trace_plan(vgroups, trace_specs)
    if trace_plan is not None and job.disable_metrics:
        trace_plan = None
    if trace_plan is not None and bucket_plan is not None:
        ow.warn(
            "sim:torch %s: flight recorder disabled under shape bucketing "
            "(trace lanes are exact-layout selectors baked into the "
            "program; run with bucket=off to trace)",
            job.run_id,
        )
        trace_plan = None
    # a cohort config (even a degenerate one-process one) runs without the
    # planes whose per-chunk reads are the leader's alone: the reference's
    # gates and warnings
    if trace_plan is not None and cohort:
        ow.warn(
            "sim:torch %s: flight recorder disabled for the cohort config "
            "(per-chunk leader-local device reads are not symmetric "
            "across processes)",
            job.run_id,
        )
        trace_plan = None
    if trace_plan is not None:
        ow.infof("sim:torch %s: flight recorder armed — %s", job.run_id,
                 trace_plan.summary())

    # telemetry plane: disable_metrics wins over the runner config; the
    # traffic matrix and the SLO rules need it, and are refused loudly
    # without it (the reference's messages)
    telemetry_on = bool(getattr(cfg, "telemetry", False)) and not job.disable_metrics
    if telemetry_on and cohort:
        ow.warn(
            "sim:torch %s: telemetry disabled for the cohort config "
            "(per-chunk leader-local device reads are not symmetric "
            "across processes)",
            job.run_id,
        )
        telemetry_on = False
    netmatrix_on = bool(getattr(cfg, "netmatrix", False))
    if netmatrix_on and cohort:
        ow.warn(
            "sim:torch %s: traffic matrix disabled for the cohort config "
            "(it rides the telemetry plane, which cohorts run without)",
            job.run_id,
        )
        netmatrix_on = False
    if netmatrix_on and not telemetry_on:
        raise ValueError(netmatrix_requires_telemetry_message(job.disable_metrics))
    slo_specs = slo_specs_of(job.groups, getattr(job, "slo", None))
    slo_plan = build_slo_plan(vgroups, slo_specs)
    if slo_plan is not None and cohort:
        ow.warn(
            "sim:torch %s: SLO assertions disabled for the cohort config "
            "(the telemetry plane they evaluate is leader-local and runs "
            "off under a cohort)",
            job.run_id,
        )
        slo_plan = None
    if slo_plan is not None and not telemetry_on:
        raise ValueError(
            slo_requires_telemetry_message(slo_plan.count, job.disable_metrics)
        )
    if slo_plan is not None:
        ow.infof("sim:torch %s: run health plane armed — %s", job.run_id,
                 slo_plan.summary())
    if bool(getattr(cfg, "nan_guard", False)) and cohort:
        ow.warn(
            "sim:torch %s: nan_guard disabled for the cohort config "
            "(a leader-local read of the cross-process-sharded carry "
            "is not symmetric, and raises on non-addressable shards)",
            job.run_id,
        )

    if multi:
        from .distributed import (
            backend,
            broadcast_json,
            cohort_agree,
            global_mesh,
        )

        # followers build the identical program from this spec
        broadcast_json(_cohort_job_spec(
            job, cfg, hosts=hosts, telemetry=telemetry_on,
            transport=transport_knob(cfg), faults=fault_specs,
        ))
        # readiness vote: a worker whose plans dir cannot satisfy the job
        # votes False and everyone skips in lockstep (a worker dying
        # mid-program would strand the cohort inside a collective)
        if not cohort_agree(True):
            raise RuntimeError(
                "a cohort member cannot satisfy this job (missing or "
                "stale plan sources on a worker host) — run aborted "
                "before any program collective"
            )
        mesh = global_mesh(device)  # cfg.shard has no meaning in a cohort
        ow.infof(
            "multi-host: %d processes, %d global devices, leader=%d, "
            "collectives over %s",
            len(set(mesh.ranks)), mesh.size, mesh.rank, backend(),
        )

    check_mesh_lanes(transport_knob(cfg), sum(g.count for g in groups), len(hosts),
                     1 if mesh is None else mesh.shards)
    ow.infof(
        "sim:torch run %s: plan=%s case=%s instances=%d groups=%d "
        "tick=%.3fms device=%s devices=%d",
        job.run_id, job.test_plan, job.test_case, n, len(groups), cfg.tick_ms,
        device, 1 if mesh is None else mesh.size,
    )
    if hosts:
        ow.infof("additional hosts: %s", ",".join(hosts))

    prog = make_sim_program(
        testcase,
        groups,
        test_plan=job.test_plan,
        test_case=job.test_case,
        test_run=job.run_id,
        tick_ms=cfg.tick_ms,
        chunk=cfg.chunk,
        hosts=hosts,
        validate=bool(getattr(cfg, "validate", False)),
        telemetry=telemetry_on,
        faults=fault_schedule,
        trace=trace_plan,
        netmatrix=netmatrix_on,
        device=device,
        mesh=mesh,
        live_counts=bucket_plan.live_counts if bucket_plan is not None else None,
    )
    if prog.mesh_pad:
        ow.infof("sim:torch %s: %d dead lane(s) pad the last group so the "
                 "lanes divide across %d peer shards", job.run_id, prog.mesh_pad,
                 mesh.shards)
    # the carry is built here, not from its shapes on the meta device: a
    # process's first meta op imports torch's meta kernels, which takes
    # seconds; the run then starts from this carry
    carry0 = prog.init_carry(cfg.seed)
    carry_bytes = prog.footprint(carry0)
    _precheck_device_memory(prog, carry_bytes, cfg, ow, device)
    ow.infof(
        "sim:torch %s: device carry footprint %.2f MiB (%d bytes)",
        job.run_id, carry_bytes / 2**20, carry_bytes,
    )
    spans.end("build", carry_bytes=carry_bytes, instances=n)
    influx_endpoint = getattr(getattr(job.env, "daemon", None),
                              "influxdb_endpoint", "")

    # the checkpoint plane (executor.py:1173-1306): not program-shaping,
    # and inert at checkpoint_chunks = 0 without resume_from. The identity
    # is what a snapshot's manifest is validated against on resume
    ckpt_every = int(getattr(cfg, "checkpoint_chunks", 0) or 0)
    resume_from = str(getattr(cfg, "resume_from", "") or "")
    if ckpt_every > 0 and cohort:
        ow.warn(
            "sim:torch %s: checkpointing disabled for the cohort config "
            "(a leader-local read of the cross-process-sharded carry "
            "is not symmetric)",
            job.run_id,
        )
        ckpt_every = 0
    if resume_from and run_dir is None:
        raise ValueError(
            "resume_from requires a run outputs dir (no env attached "
            "to this run input)"
        )
    if ckpt_every > 0 and run_dir is None:
        ow.warn("sim:torch %s: checkpointing disabled — no run outputs dir "
                "to hold snapshots", job.run_id)
        ckpt_every = 0
    resume_state = resume_info = identity = None
    if ckpt_every > 0 or resume_from:
        from .checkpoint import (
            CheckpointError,
            list_snapshots,
            prepare_resume,
            run_identity,
        )

        identity = run_identity(
            job, cfg, telemetry=telemetry_on, transport=transport_knob(cfg),
            fault_specs=fault_specs,
            # a trace plan nulled by disable_metrics shapes nothing
            trace_specs=trace_specs if trace_plan is not None else {},
            hosts=hosts,
            # the padded layout shapes every carry leaf: a snapshot from
            # one bucket refuses to seed another
            bucket=bucket_plan.padded_counts if bucket_plan is not None else None,
            netmatrix=netmatrix_on,
        )
        source_run = None
        t_load = time.perf_counter()
        own_snaps = list_snapshots(run_dir) if run_dir is not None else []
        if resume_from:
            src_dir = os.path.join(outputs_root, job.test_plan, resume_from)
            src_snaps = list_snapshots(src_dir) if os.path.isdir(src_dir) else []
            # a restarted resume prefers its own newer progress: rolling
            # back to the source's older snapshot would discard the ticks
            # this run already re-earned and overwrite its streams
            if own_snaps and (not src_snaps or own_snaps[-1][0] >= src_snaps[-1][0]):
                resume_state = prepare_resume(run_dir, run_dir, identity)
                source_run = job.run_id
            else:
                if not src_snaps:
                    raise CheckpointError(
                        f"no snapshots for {resume_from!r} under "
                        f"{os.path.join(outputs_root, job.test_plan)} — "
                        "nothing to resume from"
                    )
                resume_state = prepare_resume(src_dir, run_dir, identity)
                source_run = resume_from
        elif ckpt_every > 0 and own_snaps:
            # a task requeued or rehydrated under the same id continues
            # from its own snapshots instead of replaying from tick 0
            resume_state = prepare_resume(run_dir, run_dir, identity)
            source_run = job.run_id
        if resume_state is not None:
            load_ms = (time.perf_counter() - t_load) * 1000.0
            resume_info = {
                "from_tick": resume_state.tick,
                "from_run": source_run,
                "snapshot": os.path.basename(resume_state.path),
            }
            fb = resume_state.manifest.get("_fallback")
            if fb:
                # newer snapshots were unloadable: the resume continues
                # from an older tick, and says so everywhere
                resume_info["fallback"] = dict(fb)
                ow.warn("sim:torch %s: newest snapshot(s) unloadable (%s) — "
                        "falling back to %s: %s", job.run_id,
                        ", ".join(fb.get("skipped", [])),
                        resume_info["snapshot"], fb.get("error", ""))
            ow.infof("sim:torch %s: resuming from snapshot %s (tick %d, run %s)",
                     job.run_id, resume_info["snapshot"], resume_state.tick,
                     resume_info["from_run"])
    resume_aux = resume_state.aux if resume_state is not None else {}

    # durations on the monotonic clock; the wall-clock anchor only where a
    # real timestamp is needed (the Influx base_ns)
    t0_wall = time.time()
    t0 = time.monotonic()
    last_report = [t0]
    # bounded SLO warn lines: the first breach of each rule (and every
    # fail) reaches the log; the full record stream is the jsonl
    slo_warned: set[str] = set()
    slo_eval = None

    def on_chunk(ticks: int) -> None:
        spans.point("chunk", ticks=ticks, wall_secs=round(time.monotonic() - t0, 6))
        if chunk_profiler is not None:
            # starts after the warm-up chunk, stops after its window
            chunk_profiler.on_chunk(ticks)
        if slo_eval is not None:
            # after the loop handed over this chunk's telemetry rows and
            # latency delta (their callbacks run before on_chunk)
            for breach in slo_eval.evaluate():
                first = breach["rule"] not in slo_warned
                slo_warned.add(breach["rule"])
                if first or breach["severity"] == "fail":
                    spans.point("slo_breach", **breach)
                    ow.warn(
                        "sim:torch %s: SLO breach (%s): %s — %s = %g "
                        "violates %s %g at tick %d%s",
                        job.run_id, breach["severity"], breach["rule"],
                        breach["metric"], breach["observed"], breach["op"],
                        breach["threshold"], breach["tick"],
                        " — canceling the run"
                        if breach["severity"] == "fail" else "",
                    )
        now = time.monotonic()
        if now - last_report[0] >= 5.0:
            last_report[0] = now
            ow.infof(
                "sim:torch %s: %d ticks (%.1f sim-s) in %.1fs wall",
                job.run_id, ticks, ticks * cfg.tick_ms / 1000.0, now - t0,
            )

    # no outputs dir → nowhere to keep samples; disable_metrics opts out; a
    # cohort samples nothing mid-run (a leader-local read)
    ts_enabled = outputs_root is not None and not job.disable_metrics and not multi
    recorder = _TimeSeriesRecorder(
        testcase, vgroups,
        getattr(cfg, "timeseries_every", 0) if ts_enabled else 0, ow,
        # a padded carry's samples slice each group's live span out
        phys_groups=prog.groups if prog.live_counts is not None else None,
    )
    row_ident = {"run": job.run_id, "plan": job.test_plan, "case": job.test_case}
    transport_block = _transport_block(cfg, prog.device, mesh)
    probe_reps = int(getattr(cfg, "transport_probe", 0) or 0)
    if multi and probe_reps > 0:
        ow.warn("sim:torch %s: transport probe disabled for the cohort config "
                "(it runs ticks on the leader alone)", job.run_id)
        probe_reps = 0
    if transport_block["requested"].lower() == "auto" and probe_reps > 0:
        transport_block = _probe_transport(prog, transport_block, probe_reps,
                                           cfg.seed)
        ow.infof("sim:torch %s: transport — %s", job.run_id,
                 transport_block["reason"])
    # the perf ledger: host-side only, so not program-shaping; disable_metrics
    # wins, as over the telemetry plane, and cohorts run ledger-free (the
    # per-chunk walls are the leader's alone)
    perf_ledger = None
    if bool(getattr(cfg, "perf", True)) and not job.disable_metrics and not cohort:
        from .perf import PERF_FILE, PerfLedger

        perf_ledger = PerfLedger(
            n, cfg.chunk, ident=row_ident,
            path=os.path.join(run_dir, PERF_FILE) if run_dir is not None else None,
            # one warm-up chunk on a mesh too: the port has no sharding
            # retrace (the reference keeps a second one out there)
            warmup=1,
            transport=transport_block["resolved"],
            device=prog.device,
            # the padded size rides beside the exact N as an annotation
            bucket=bucket_plan.padded_n if bucket_plan is not None else None,
        )
    # the profiler: any group's profiles or the profile flag record a
    # torch.profiler trace (host and device activity) into the run dir
    profile_dir = None
    chunk_profiler = None
    if run_dir is not None and (any(g.profiles for g in job.groups)
                                or bool(getattr(cfg, "profile", False))):
        profile_dir = os.path.join(run_dir, "profiles")
        os.makedirs(profile_dir, exist_ok=True)
        n_prof_chunks = int(getattr(cfg, "profile_chunks", 0) or 0)
        if n_prof_chunks > 0:
            chunk_profiler = _ChunkedProfiler(profile_dir, n_prof_chunks, prog.device)
            ow.infof("capturing torch.profiler trace to %s (%d chunk(s) after warmup)",
                     profile_dir, n_prof_chunks)
        else:
            ow.infof("capturing torch.profiler trace to %s", profile_dir)
    # a resumed run's writers append past the prefix that prepare_resume
    # aligned to the snapshot's tick, their counters continuing from it
    resumed = resume_state is not None
    tele_writer = (
        _SimTelemetryWriter(
            tuple(g.id for g in vgroups), row_ident,
            os.path.join(run_dir, SIM_SERIES_FILE) if run_dir is not None else None,
            append=resumed,
            rows_offset=int(resume_aux.get("telemetry_rows", 0) or 0),
        )
        if telemetry_on else None
    )
    netmatrix_writer = (
        _SimNetMatrixWriter(
            prog, row_ident,
            os.path.join(run_dir, NETMATRIX_FILE) if run_dir is not None else None,
            append=resumed,
            chunks_offset=int(resume_aux.get("netmatrix_chunks", 0) or 0),
        )
        if netmatrix_on else None
    )
    trace_writer = (
        _SimTraceWriter(vgroups, row_ident, run_dir, cfg.tick_ms, trace_plan,
                        resume=resume_aux.get("trace") if resumed else None)
        if trace_plan is not None else None
    )
    run_cancel = cancel
    if multi:
        # cancellation is a cohort decision: the leader's local event is
        # broadcast once a chunk so every process stops in lockstep
        from .distributed import CohortCancel

        run_cancel = CohortCancel(cancel)
    if slo_plan is not None:
        # a fail-severity breach cancels the run, never the task
        run_cancel = _SloRunCancel(cancel)
        slo_eval = SloEvaluator(
            slo_plan, vgroups, cfg.tick_ms, cfg.chunk, ident=row_ident,
            path=os.path.join(run_dir, SLO_FILE) if run_dir is not None else None,
            cancel=run_cancel.run_local,
            append=resumed,
        )
        if resumed and resume_aux.get("slo"):
            # windowed rules judge the same history as an uninterrupted run
            slo_eval.load_state(resume_aux["slo"])
    # the fleet controller's preemption (executor.py:1560-1567): the loop
    # stops at the next chunk boundary and the tail raises
    # TaskPreemptedError for the supervisor to requeue
    # Not armed under a cohort: checkpointing is off there, and the cancel
    # must stay a lockstep cohort decision
    preempt_ev = None if multi else getattr(job, "preempt", None)
    if preempt_ev is not None:
        run_cancel = _PreemptRunCancel(run_cancel, preempt_ev)

    def on_stall(last_tick: int, chunk_index: int) -> None:
        spans.point(
            "stall", last_tick=last_tick, chunk_index=chunk_index,
            timeout_secs=float(getattr(cfg, "chunk_timeout_secs", 0.0)),
        )
        ow.warn(
            "sim:torch %s: chunk %d stalled past the %.1fs wall-clock "
            "watchdog (last completed tick %d) — canceling the run",
            job.run_id, chunk_index,
            float(getattr(cfg, "chunk_timeout_secs", 0.0)), last_tick,
        )

    # one decode of each chunk's rows, two consumers
    if slo_eval is not None:

        def _tele_cb(block):
            slo_eval.on_rows(tele_writer.on_block(block))

    else:
        _tele_cb = tele_writer.on_block if tele_writer else None

    # the checkpoint plane's write side rides the observer hook, after the
    # chunk's plane callbacks, so the stream offsets it records are
    # flush-exact (executor.py:1603-1724)
    checkpointer = None
    if ckpt_every > 0:
        from .checkpoint import RunCheckpointer
        from .trace import TRACE_FILE

        def _size_of(path):
            try:
                return os.path.getsize(path)
            except OSError:
                return None

        def _ckpt_aux() -> dict:
            """The host state beside the carry that a resumed run needs to
            be an uninterrupted one: stream byte offsets, writer counters,
            the SLO evaluator's windows and the recorder's rows."""
            aux: dict = {}
            streams: dict = {}
            for name, writer in ((SIM_SERIES_FILE, tele_writer),
                                 (SLO_FILE, slo_eval),
                                 (TRACE_FILE, trace_writer),
                                 (NETMATRIX_FILE, netmatrix_writer)):
                if writer is not None and writer.path is not None:
                    size = _size_of(writer.path)
                    if size is not None:
                        streams[name] = size
            if tele_writer is not None:
                aux["telemetry_rows"] = tele_writer.rows_written
            if slo_eval is not None:
                aux["slo"] = slo_eval.state_dict()
            if trace_writer is not None:
                aux["trace"] = {"events": trace_writer.events_written,
                                "truncated": trace_writer.truncated}
            if netmatrix_writer is not None:
                aux["netmatrix_chunks"] = netmatrix_writer.chunks_written
            if recorder.enabled:
                aux["recorder"] = recorder.state_dict()
            aux["streams"] = streams
            return aux

        checkpointer = RunCheckpointer(
            run_dir, every_chunks=ckpt_every,
            keep=int(getattr(cfg, "checkpoint_keep", 3) or 3), chunk=cfg.chunk,
            identity=identity, ident=row_ident, aux_cb=_ckpt_aux, spans=spans,
            warn=ow.warn, telemetry=telemetry_on, resumed_from=resume_info,
            export=prog.lane_export(),
        )
        ow.infof("sim:torch %s: checkpointing every %d chunk(s) (%d ticks), "
                 "keeping newest %d", job.run_id, ckpt_every,
                 ckpt_every * cfg.chunk, checkpointer.keep)

    # restore the carry and the host state the snapshot holds
    start_carry, start_ticks = carry0, 0
    if resume_state is not None:
        from .checkpoint import restore_carry

        if recorder.enabled and resume_aux.get("recorder"):
            recorder.load_state(resume_aux["recorder"])
        if checkpointer is not None:
            checkpointer.seed_lat_hist(resume_state.lat_hist)
            checkpointer.seed_net_matrix(resume_state.net_matrix)
        t_restore = time.perf_counter()
        start_carry = restore_carry(
            prog, cfg.seed, resume_state.manifest, resume_state.leaves,
            transport=identity["transport"], template=carry0,
        )
        if prog.device.type == "cuda":
            torch.cuda.synchronize(prog.device)
        start_ticks = resume_state.tick
        # the snapshot's read (load_ms: find, unzip, validate the identity,
        # align the streams) and its restore onto the device, apart
        spans.point(
            "resume",
            **{k: v for k, v in resume_info.items() if k != "fallback"},
            fallback_skipped=len((resume_info.get("fallback") or {}).get("skipped", [])),
            load_ms=round(load_ms, 3),
            restore_ms=round((time.perf_counter() - t_restore) * 1000.0, 3),
        )
    del carry0

    observers = [o for o in (
        recorder.observe if recorder.enabled else None,
        checkpointer.observe if checkpointer is not None else None,
    ) if o is not None]
    if preempt_ev is not None and checkpointer is not None:
        # the forced snapshot at the stopping boundary: the observer runs
        # before the loop's cancel check, so the snapshot and the stop
        # fall on the same boundary and the resumed run replays nothing

        def _preempt_observe(ticks, carry):
            if preempt_ev.is_set() and checkpointer.last_tick != int(ticks):
                checkpointer.snapshot(int(ticks), carry)

        observers.append(_preempt_observe)
    final = {}
    if multi:
        # the final carry, for the digest a harness holds each follower's
        # against ("sim-worker: run ... carry digest"): every process's
        # digest is the whole carry's
        observers.append(lambda ticks, carry: final.update(carry=carry))
    # the run loop calls these only where their plane is on
    lat_cbs = [cb for cb in (
        slo_eval.on_lat_delta if slo_eval else None,
        checkpointer.on_lat_delta if checkpointer is not None else None,
    ) if cb is not None]
    nm_cbs = [cb for cb in (
        netmatrix_writer.on_delta if netmatrix_writer else None,
        checkpointer.on_net_matrix_delta if checkpointer is not None else None,
    ) if cb is not None]

    spans.start("execute")
    run = functools.partial(
        prog.run,
        seed=cfg.seed,
        resume_carry=start_carry,
        resume_ticks=start_ticks,
        lat_hist_init=resume_state.lat_hist if resume_state is not None else None,
        net_mat_init=resume_state.net_matrix if resume_state is not None else None,
        max_ticks=cfg.max_ticks,
        cancel=run_cancel,
        on_chunk=on_chunk,
        observer=_fan_out(observers),
        telemetry_cb=_tele_cb,
        lat_hist_cb=_fan_out(lat_cbs),
        trace_cb=trace_writer.on_block if trace_writer else None,
        netmatrix_cb=_fan_out(nm_cbs),
        chunk_timeout=float(getattr(cfg, "chunk_timeout_secs", 0.0)),
        chunk_sleep_ms=float(getattr(cfg, "debug_chunk_sleep_ms", 0.0)),
        on_stall=on_stall,
        nan_guard=bool(getattr(cfg, "nan_guard", False)) and not multi,
        perf=perf_ledger,
    )
    if profile_dir is not None and chunk_profiler is None:
        res = _profiled_run(run, profile_dir, prog.device)
    else:
        try:
            res = run()
        finally:
            # a run ending inside the window still closes the trace
            if chunk_profiler is not None:
                chunk_profiler.close()
    wall = time.monotonic() - t0
    # the nvcc builds since the last run or build precompile claimed one:
    # this run's cold start, claimed whether or not it is bucketed
    from .cuda_transport import claim_kernel_builds

    nvcc_builds = claim_kernel_builds()
    if final:
        # the whole carry gathered from every process, in lockstep with
        # each follower's (sim_worker_loop)
        ow.infof("multi-host: carry digest %d, launches %s",
                 prog.carry_digest(final.pop("carry")), json.dumps(_launch_counts()))
    spans.point("compile", wall_secs=round(res.get("compile_secs", 0.0), 6))
    spans.end("execute", ticks=res["ticks"])
    status = res["status"]
    # the bucket block: results are already demuxed to the exact layout
    bucket_block = None
    if bucket_plan is not None:
        bucket_block = {
            "instances": bucket_plan.live_n,
            "padded_instances": bucket_plan.padded_n,
            "dead_lanes": bucket_plan.padded_n - bucket_plan.live_n,
            "per_group": {
                g.id: {"live": lv, "padded": pv}
                for g, lv, pv in zip(vgroups, bucket_plan.live_counts,
                                     bucket_plan.padded_counts)
            },
            # the port's cold start: whether this process ran nvcc for
            # the kernels this run launched
            "compile_cache": compile_cache_verdict(
                device, _cache_on(job), resume_state is not None, nvcc_builds),
        }
        ow.infof("sim:torch %s: bucket %d (live %d) — compile cache %s", job.run_id,
                 bucket_plan.padded_n, bucket_plan.live_n, bucket_block["compile_cache"])
    ow.infof(
        "sim:torch %s: done — %d ticks in %.2fs wall (%.0f instance·ticks/s)",
        job.run_id, res["ticks"], wall, n * res["ticks"] / max(wall, 1e-9),
    )
    if fault_schedule is not None:
        ow.infof(
            "sim:torch %s: fault plane — crashed=%d restarted=%d "
            "fault_dropped=%d message(s)",
            job.run_id, res["faults_crashed"], res["faults_restarted"],
            res["fault_dropped"],
        )
    if res["collisions"] > 0:
        # a direct-mode contract violation under validate: the data is
        # corrupt, so no plan-level outcome is reported from it
        c_dst, c_slot = res["collision_where"]
        raise RuntimeError(
            f"direct slot-mode collision: {res['collisions']} conflicting "
            f"writes detected (first at receiver {c_dst}, inbox slot "
            f"{c_slot}) — the plan violates the ≤1 sender per (receiver, "
            "slot, tick) contract; use SLOT_MODE='sorted' or fix the "
            "traffic pattern"
        )
    if res["bw_rate_change_backlogged"] > 0:
        ow.warn(
            "sim:torch %s: bandwidth changed under a standing egress "
            "backlog %d time(s) — the bandwidth_queue occupancy bound "
            "values standing busy time at the current rate, so tail-drop "
            "thresholds around those ticks are approximate (pacing and "
            "FIFO order are unaffected)",
            job.run_id, res["bw_rate_change_backlogged"],
        )
    if res["latency_clamped"] > 0:
        ow.warn(
            "sim:torch %s: %d deliveries exceeded the calendar horizon and "
            "were clamped to MAX_LINK_TICKS-1 — a shaped latency/jitter/"
            "backlog does not fit the calendar; raise MAX_LINK_TICKS "
            "(results arrive EARLIER than configured)",
            job.run_id, res["latency_clamped"],
        )

    # ------------------------------------------------ outcomes + outputs
    spans.start("collect")
    result = Result.for_input(job)
    result.journal["events"] = {}
    write_outputs = outputs_root is not None and n <= cfg.write_outputs_max
    if outputs_root is not None and not write_outputs:
        ow.warn(
            "sim:torch %s: %d instances > write_outputs_max=%d — skipping "
            "per-instance output dirs (group metric aggregates are in the "
            "journal)",
            job.run_id, n, cfg.write_outputs_max,
        )
        result.journal["outputs_skipped"] = {
            "instances": n, "write_outputs_max": cfg.write_outputs_max,
        }

    metrics = {}
    collect = getattr(testcase, "collect_metrics", None)
    if callable(collect):
        for gi, g in enumerate(vgroups):
            try:
                metrics[g.id] = collect(
                    g, res["states"][gi], status[g.offset : g.offset + g.count]
                )
            except Exception as e:  # noqa: BLE001 — metrics are best-effort
                ow.warn("collect_metrics failed for group %s: %s", g.id, e)
    if metrics:
        result.journal["metrics"] = {
            gid: _aggregate_metrics(m) for gid, m in metrics.items()
        }

    # the journal's totals equal the streamed rows' sums
    if tele_writer is not None:
        tele_writer.close()
        result.journal["telemetry"] = {
            "rows": tele_writer.rows_written,
            **({"file": SIM_SERIES_FILE} if tele_writer.path is not None else {}),
            "totals": {
                "delivered": res["msgs_delivered"],
                "sent": res["msgs_sent"],
                "enqueued": res["msgs_enqueued"],
                "dropped": res["msgs_dropped"],
                "rejected": res["msgs_rejected"],
                "in_flight": res["cal_depth"],
                "fault_dropped": res["fault_dropped"],
            },
        }

    # network topology plane: the matrix, its exact conservation verdict,
    # the bounded top-K pair view and the statically faulted pairs
    net_matrix_block = None
    if netmatrix_writer is not None:
        netmatrix_writer.close()
    if netmatrix_on and res.get("net_matrix") is not None:
        nm_mat = np.asarray(res["net_matrix"], np.int64)
        nm_labels = [g.id for g in vgroups]
        if nm_mat.shape[1] > len(nm_labels):
            nm_labels.append("hosts")
        nm_pairs, nm_elided = _netmatrix.top_pairs(nm_mat, 16)
        nm_mismatches = _netmatrix.reconcile(nm_mat, res)
        if nm_mismatches:
            ow.warn("sim:torch %s: traffic matrix failed conservation — %s",
                    job.run_id, "; ".join(nm_mismatches))
        net_matrix_block = {
            "labels": nm_labels,
            "matrix": nm_mat.tolist(),
            "totals": _netmatrix.matrix_totals(nm_mat),
            "bytes_total": int(_netmatrix.matrix_bytes(nm_mat).sum()),
            "top_pairs": nm_pairs,
            "elided_pairs": nm_elided,
            "mismatches": nm_mismatches,
            **(
                {"bw_queue_hiwater": res["net_bw_hiwater"]}
                if res.get("net_bw_hiwater") is not None else {}
            ),
            **(
                {"faulted_pairs": nm_faulted.tolist()}
                if nm_faulted is not None else {}
            ),
            **(
                {"file": NETMATRIX_FILE,
                 "chunks": netmatrix_writer.chunks_written}
                if netmatrix_writer.path is not None else {}
            ),
        }

    # per-receiver-group delivery-latency percentiles off the histograms
    lat_rows: list[dict] = []
    latency: dict = {}
    if res.get("lat_hist") is not None:
        latency = {
            g.id: latency_percentiles(res["lat_hist"][gi], cfg.tick_ms)
            for gi, g in enumerate(vgroups)
        }
        for gid, pct in latency.items():
            for q in ("p50", "p95", "p99"):
                if f"{q}_ms" not in pct:
                    continue
                v = pct[f"{q}_ms"]
                lat_rows.append({
                    **row_ident, "tick": res["ticks"], "group_id": gid,
                    "name": f"sim.latency.{q}", "count": pct["count"],
                    "mean": v, "min": v, "max": v,
                })
        if run_dir is not None and lat_rows:
            try:
                with open(os.path.join(run_dir, LATENCY_FILE), "w") as f:
                    for row in lat_rows:
                        f.write(json.dumps(row) + "\n")
            except OSError:  # observability never fails the run
                pass

    if trace_writer is not None:
        trace_writer.close()
        result.journal["trace"] = trace_writer.journal()

    # present whenever rules were armed: "no breaches" is a verdict too
    if slo_eval is not None:
        slo_eval.close()
        result.journal["slo"] = slo_eval.journal()

    # the perf ledger's block, and one log line of its throughput
    perf_summary = None
    if perf_ledger is not None:
        perf_ledger.close()
        perf_summary = perf_ledger.summary()
        ex = perf_summary.get("execute", {})
        if ex:
            ow.infof(
                "sim:torch %s: perf — %.0f peer·ticks/s over %d chunk(s)%s",
                job.run_id,
                ex.get("steady_peer_ticks_per_sec", ex.get("peer_ticks_per_sec", 0.0)),
                ex.get("chunks", 0),
                ", hbm peak %.2f MiB" % (perf_summary["hbm"]["peak_bytes"] / 2**20)
                if perf_summary.get("hbm") else "",
            )
    # the phase ledger, after the run on its own carry: gated like the
    # telemetry plane (disable_metrics wins) and best-effort, so it never
    # fails the run it measures
    phases_block = None
    if bool(getattr(cfg, "phases", False)) and not job.disable_metrics and not cohort:
        from .phases import PHASES_FILE, build_phase_ledger, write_phase_rows

        spans.start("phases")
        try:
            phases_block = build_phase_ledger(
                prog, measure=int(getattr(cfg, "phases_measure", 0) or 0),
                seed=cfg.seed, transport=transport_block["resolved"],
            )
        except Exception as e:  # noqa: BLE001 — attribution is best-effort
            ow.warn("sim:torch %s: phase attribution failed: %s", job.run_id, e)
            phases_block = None
        if phases_block is not None:
            rows_written = (
                write_phase_rows(os.path.join(run_dir, PHASES_FILE), row_ident,
                                 phases_block)
                if run_dir is not None else 0
            )
            if rows_written:
                phases_block["series"] = {"rows": rows_written, "file": PHASES_FILE}
            cov = (phases_block.get("coverage") or {}).get("bytes_frac")
            ow.infof(
                "sim:torch %s: phase attribution — %d phase(s), transport=%s%s",
                job.run_id, len(phases_block.get("phases") or []),
                phases_block.get("transport"),
                ", bytes coverage x%.2f of the whole tick" % cov if cov else "",
            )
        spans.end("phases")
    # the capture window is part of the run record
    if profile_dir is not None:
        result.journal["profile"] = (
            chunk_profiler.journal() if chunk_profiler is not None
            else {"dir": "profiles", "mode": "full"}
        )

    # final metric sample at the last tick, then the run's series
    if recorder.enabled:
        recorder.sample(res["ticks"], res["states"], status)
    full_rows: list[dict] = []
    if run_dir is not None and recorder.rows:
        full_rows = [{**row_ident, **row} for row in recorder.rows]
        with open(os.path.join(run_dir, "timeseries.jsonl"), "w") as f:
            for row in full_rows:
                f.write(json.dumps(row) + "\n")
        result.journal["timeseries"] = {
            "samples": len(recorder.rows), "every_ticks": recorder.every,
        }

    # the optional Influx mirror (executor.py:2231-2290), best-effort:
    # base_ns is the run's start, stable per run, so a re-push is
    # idempotent and batches never collide
    base_ns = int(t0_wall * 1e9)
    if influx_endpoint and full_rows:
        from ..metrics.influx import push_rows

        result.journal["influx"] = push_rows(influx_endpoint, full_rows,
                                             base_ns=base_ns)
    if (influx_endpoint and tele_writer is not None
            and tele_writer.path is not None and tele_writer.rows_written > 0):
        # the sim.* family in its own bounded batches: one oversized POST
        # must not also lose the small plan-metric batch above
        result.journal["influx_telemetry"] = _push_sim_series(
            influx_endpoint, tele_writer.iter_rows(), base_ns)
    if influx_endpoint and lat_rows:
        from ..metrics.influx import push_rows

        result.journal["influx_latency"] = push_rows(influx_endpoint, lat_rows,
                                                     base_ns=base_ns)
    if (influx_endpoint and perf_ledger is not None and perf_ledger.path is not None
            and perf_ledger.rows_written > 0):
        # the sim.perf.* family, one row a chunk: one small batch
        from ..metrics.influx import push_rows
        from ..metrics.viewer import expand_perf_row
        from .telemetry import iter_jsonl

        result.journal["influx_perf"] = push_rows(
            influx_endpoint,
            [r for row in iter_jsonl(perf_ledger.path) for r in expand_perf_row(row)],
            base_ns=base_ns,
        )

    for gi, g in enumerate(vgroups):
        st = status[g.offset : g.offset + g.count]
        ok = int(np.sum(st == 1))
        result.outcomes[g.id].ok = ok
        counts = {name: int(np.sum(st == code)) for code, name in _STATUS_NAME.items()}
        result.journal["events"][g.id] = counts
        ow.infof("group %s: %d/%d ok (%s)", g.id, ok, g.count,
                 ", ".join(f"{k}={v}" for k, v in counts.items() if v))
        if write_outputs:
            _write_instance_outputs(outputs_root, job, g, st, res, metrics.get(g.id))

    # the checkpoint plane's block: whenever snapshots were armed or the
    # run resumed (tg stats and the tg_checkpoint_* family read it)
    checkpoint_block = None
    if checkpointer is not None:
        checkpoint_block = checkpointer.journal()
        if checkpointer.count:
            ow.infof(
                "sim:torch %s: checkpoint plane — %d snapshot(s), last at "
                "tick %d (%.2f MiB, %.1f ms write)",
                job.run_id, checkpointer.count, checkpointer.last_tick,
                checkpointer.last_bytes / 2**20, checkpointer.last_write_ms,
            )
    elif resume_info is not None:
        checkpoint_block = {"every_chunks": 0, "count": 0, "resumed": resume_info}

    mesh_block = _mesh_journal_block(mesh, testcase, vgroups, hosts)
    result.journal["sim"] = {
        "ticks": res["ticks"],
        "tick_ms": cfg.tick_ms,
        "wall_secs": wall,
        "processes": len(set(mesh.ranks)) if multi else 1,
        "compile_secs": round(res.get("compile_secs", 0.0), 3),
        "devices": 1 if mesh is None else mesh.size,
        "transport": transport_block,
        "pub_dropped": res["pub_dropped"].tolist(),
        "latency_clamped": res["latency_clamped"],
        "bw_queue_dropped": res["bw_queue_dropped"],
        "bw_rate_change_backlogged": res["bw_rate_change_backlogged"],
        "msgs_delivered": res["msgs_delivered"],
        "msgs_sent": res["msgs_sent"],
        "msgs_enqueued": res["msgs_enqueued"],
        "msgs_dropped": res["msgs_dropped"],
        "msgs_rejected": res["msgs_rejected"],
        "msgs_in_flight": res["cal_depth"],
        "faults_crashed": res["faults_crashed"],
        "faults_restarted": res["faults_restarted"],
        "msgs_fault_dropped": res["fault_dropped"],
        "carry_bytes": res["carry_bytes"],
        **({"latency": latency} if latency else {}),
        **({"perf": perf_summary} if perf_summary else {}),
        **({"phases": phases_block} if phases_block else {}),
        **({"net_matrix": net_matrix_block} if net_matrix_block else {}),
        **({"checkpoint": checkpoint_block} if checkpoint_block else {}),
        # present when the run was padded to a bucket; every total above
        # stays exact-N
        **({"bucket": bucket_block} if bucket_block else {}),
        **({"mesh": mesh_block} if mesh_block else {}),
    }
    result.update_outcome()
    if cancel.is_set():
        result.outcome = Outcome.CANCELED
    spans.end("collect")
    # fail-severity SLO breach: the loop was canceled run-locally; the
    # assembled result rides the error. An operator cancel wins.
    if slo_eval is not None and slo_eval.fatal is not None and not cancel.is_set():
        result.outcome = Outcome.FAILURE
        err = SloBreachError(slo_eval.fatal)
        result.journal["slo"]["error"] = str(err)
        err.run_output = RunOutput(run_id=job.run_id, result=result)
        raise err
    # the fleet controller's preemption: after the SLO block (a condemned
    # run does not launder its failure into a migration) and only without
    # an operator cancel (a kill stays CANCELED)
    if preempt_ev is not None and preempt_ev.is_set() and not cancel.is_set():
        from ..engine.controller import TaskPreemptedError

        resumable = checkpointer is not None and checkpointer.count > 0
        snapshot_tick = int(checkpointer.last_tick) if resumable else 0
        spans.point("preempt", tick=int(res["ticks"]), snapshot_tick=snapshot_tick,
                    resumable=resumable)
        # execute_sim_run closes the run span with outcome="preempted"
        raise TaskPreemptedError(
            job.run_id, tick=int(res["ticks"]), snapshot_tick=snapshot_tick,
            snapshots=int(checkpointer.count) if checkpointer is not None else 0,
            resumable=resumable,
        )
    spans.end("run", outcome=result.outcome.value, ticks=res["ticks"])
    return RunOutput(run_id=job.run_id, result=result)


def execute_packed_sim_runs(jobs: list, ows: list, cancels: list) -> list:
    """Execute N compatible sim runs as ONE program over a run axis on the
    card (``executor.py:2463-2686``; the device half is ``sim/pack.py``).
    Every job keeps its own task identity: run directory, telemetry, SLO
    and perf streams, journal (with the ``sim.pack`` block) and Result,
    demuxed from the pack's ``[.., R, ..]`` blocks each chunk.

    The engine's pack admission (``engine/pack.py``) guarantees the jobs
    share a program (same plan, case, parameters, bucket layout, gates and
    device; no faults, trace, hosts, cohort or checkpoint); this function
    asserts the essentials and returns one ``RunOutput`` OR ``Exception``
    per job (a member's failure is its own task's failure, never the
    pack's). On a mesh the pack's calendar is split over the peer shards
    (``PackRunner(prog, width, mesh=)``), and on a mesh of several parts
    each part holds and steps its own members' lanes; every member's
    ``sim.bucket.compile_cache`` is the pack's one verdict
    (:func:`compile_cache_verdict`)."""
    from .engine import build_groups as _build_groups
    from .engine import resolve_device
    from .pack import PackMember, PackRunner, pack_width
    from .telemetry import SIM_SERIES_FILE, SPAN_FILE, SpanTracer

    assert len(jobs) == len(ows) == len(cancels) and len(jobs) >= 2
    job0, cfg = jobs[0], jobs[0].runner_config or SimTorchConfig()
    _refuse_malformed(cfg)
    device = resolve_device(getattr(cfg, "device", None))
    outputs_root = job0.env.dirs.outputs() if job0.env is not None else None

    # ---------------------------------------------------- shared program
    # The run axis is laid out by the pack, but the INSTANCE axis may still
    # shard: the inner program is built unmeshed and PackRunner splits the
    # pack's calendar over the mesh's peer shards (one sub-shard a member
    # and shard), or, on a mesh of several parts, places every lane leaf
    # over the parts (sim/pack.py). The bucket gate sees the pack's real mesh so padded
    # counts divide the peer shards; when they do not, the pack falls back
    # to the unmeshed single-device world rather than breaking the
    # admission signature's bucketed promise (the reference's gate).
    pack_mesh = _make_mesh(bool(getattr(cfg, "shard", True)), getattr(cfg, "mesh", ""),
                           device)
    counts = [g.instances for g in job0.groups]
    bucket_plan = resolve_buckets(cfg, counts, mesh=pack_mesh, warn=ows[0].warn)
    if bucket_plan is None and pack_mesh is not None:
        unmeshed_plan = resolve_buckets(cfg, counts, mesh=None)
        if unmeshed_plan is not None:
            ows[0].warn(
                "pack runs on a single device: the bucket ladder does "
                "not divide across the mesh peer shards"
            )
            pack_mesh = None
            bucket_plan = unmeshed_plan
    if bucket_plan is None:
        for j in jobs[1:]:
            if [g.instances for g in j.groups] != counts:
                raise ValueError(
                    "pack admission bug: unbucketed members with "
                    "different instance counts share a pack"
                )
    padded_in = job0.groups
    if bucket_plan is not None:
        padded_in = [dataclasses.replace(g, instances=p)
                     for g, p in zip(job0.groups, bucket_plan.padded_counts)]
    artifact = job0.groups[0].artifact_path or plan_dir(job0.test_plan)
    testcase, groups = load_and_specialize(artifact, job0.test_case, padded_in,
                                           cfg.tick_ms)
    telemetry_on = bool(getattr(cfg, "telemetry", False)) and not any(
        j.disable_metrics for j in jobs
    )
    transport_block = _transport_block(
        cfg, device if pack_mesh is None else pack_mesh.primary, pack_mesh)
    transport = transport_knob(cfg)
    if transport == "pallas" and pack_mesh is not None:
        # the reference's override, warning and journal reason; on the card
        # the port's xla arm runs the sharded K1 and K2 all the same
        ows[0].warn(
            "transport=pallas on a packed mesh resolves to xla (the "
            "vmapped kernels cannot shard over the run axis and the "
            "mesh at once)"
        )
        transport_block["reason"] += (
            " — overridden: a packed mesh run uses the XLA transport")
        transport = "xla"
    prog = make_sim_program(
        testcase,
        groups,
        test_plan=job0.test_plan,
        test_case=job0.test_case,
        test_run=job0.run_id,
        tick_ms=cfg.tick_ms,
        chunk=cfg.chunk,
        hosts=(),
        validate=bool(getattr(cfg, "validate", False)),
        telemetry=telemetry_on,
        faults=None,
        trace=None,
        # the matrix plane is a pack exclusion (engine/pack.py): a member
        # asking for netmatrix runs solo
        netmatrix=False,
        device=device if pack_mesh is None else pack_mesh.primary,
        mesh=None,
        live_counts=bucket_plan.live_counts if bucket_plan is not None else None,
        # exact shapes that do not divide across the peer shards get the
        # solo meshed run's dead lanes
        lane_multiple=1 if pack_mesh is None else pack_mesh.shards,
    )
    width = pack_width(len(jobs), int(getattr(cfg, "pack_max", 8) or 8))
    runner = PackRunner(prog, width, mesh=pack_mesh, transport=transport)
    # the stacked carry: every member's leaves side by side, the calendar
    # split over the pack mesh's devices; placed over the mesh's parts,
    # each part's own bytes against its own card
    member0 = prog.init_carry(0)
    if runner.placed:
        for q, part_bytes in zip(runner.parts, runner.part_bytes_estimate(member0)):
            _precheck_device_memory(prog, part_bytes, cfg, ows[0],
                                    q.device if device.type == "cuda" else device,
                                    per_device=True)
    else:
        _precheck_device_memory(prog, prog.footprint(member0) * width, cfg, ows[0],
                                device, mesh=runner.cal_mesh)
    del member0
    mesh_block = _mesh_journal_block(pack_mesh, testcase, groups, ())

    # ------------------------------------------------ per-member plumbing
    members: list = []
    contexts: list[dict] = []
    for idx, (job, ow, cancel) in enumerate(zip(jobs, ows, cancels)):
        jcfg = job.runner_config or cfg
        run_dir = None
        if outputs_root is not None:
            run_dir = os.path.join(outputs_root, job.test_plan, job.run_id)
            os.makedirs(run_dir, exist_ok=True)
        spans = SpanTracer(
            os.path.join(run_dir, SPAN_FILE)
            if run_dir is not None and not job.disable_metrics else None,
            ctx=getattr(job, "trace_ctx", None),
        )
        spans.start("run", run_id=job.run_id, plan=job.test_plan, case=job.test_case,
                    pack_index=idx)
        vgroups = _build_groups(job.groups)
        member_bucket = (
            resolve_buckets(jcfg, [g.instances for g in job.groups])
            if bucket_plan is not None else None
        )
        n_live = sum(g.count for g in vgroups)
        row_ident = {"run": job.run_id, "plan": job.test_plan, "case": job.test_case}
        tele_writer = (
            _SimTelemetryWriter(
                tuple(g.id for g in vgroups), row_ident,
                os.path.join(run_dir, SIM_SERIES_FILE) if run_dir is not None else None,
            )
            if telemetry_on else None
        )
        slo_eval = slo_cancel = None
        from .slo import build_slo_plan

        slo_plan = build_slo_plan(vgroups, slo_specs_of(job.groups,
                                                        getattr(job, "slo", None)))
        if slo_plan is not None and not telemetry_on:
            raise ValueError(
                f"pack member {job.run_id} declares SLO rules but the "
                "pack's telemetry plane is off"
            )
        if slo_plan is not None:
            from .slo import SLO_FILE, SloEvaluator

            slo_cancel = _SloRunCancel(cancel)
            slo_eval = SloEvaluator(
                slo_plan, vgroups, cfg.tick_ms, cfg.chunk, ident=row_ident,
                path=os.path.join(run_dir, SLO_FILE) if run_dir is not None else None,
                cancel=slo_cancel.run_local,
            )
        perf_ledger = None
        if bool(getattr(jcfg, "perf", True)) and not job.disable_metrics:
            from .perf import PERF_FILE, PerfLedger

            perf_ledger = PerfLedger(
                n_live, cfg.chunk, ident=row_ident,
                path=os.path.join(run_dir, PERF_FILE) if run_dir is not None else None,
                warmup=1,
                transport=transport_block["resolved"],
                device=prog.device,
                bucket=bucket_plan.padded_n if bucket_plan is not None else None,
            )

        def _tele_cb(block, _w=tele_writer, _s=slo_eval):
            rows = _w.on_block(block) if _w is not None else []
            if _s is not None:
                _s.on_rows(rows)

        def _on_chunk(ticks, _s=slo_eval, _ow=ow, _r=job.run_id):
            # judged after this chunk's rows and latency delta landed
            for breach in _s.evaluate():
                _ow.warn(
                    "sim:torch %s: SLO breach (%s): %s — %s = %g violates %s %g at "
                    "tick %d%s",
                    _r, breach["severity"], breach["rule"], breach["metric"],
                    breach["observed"], breach["op"], breach["threshold"],
                    breach["tick"],
                    " — stopping this pack member" if breach["severity"] == "fail"
                    else "",
                )

        # eviction (engine/controller.py) rides the cancel path: the member
        # stops at the next chunk boundary and collect raises
        # TaskPreemptedError
        preempt_ev = getattr(job, "preempt", None)

        def _cancel_check(_c=cancel, _sc=slo_cancel, _p=preempt_ev):
            return (_c.is_set() or (_sc is not None and _sc.run_local.is_set())
                    or (_p is not None and _p.is_set()))

        ow.infof(
            "sim:torch %s: packed run %d/%d (width %d) — plan=%s case=%s "
            "instances=%d%s",
            job.run_id, idx + 1, len(jobs), width, job.test_plan, job.test_case,
            n_live,
            f", bucket {bucket_plan.padded_n}" if bucket_plan is not None else "",
        )
        members.append(PackMember(
            seed=int(getattr(jcfg, "seed", 0) or 0),
            live_counts=member_bucket.live_counts if member_bucket is not None else None,
            max_ticks=int(getattr(jcfg, "max_ticks", 10_000)),
            telemetry_cb=_tele_cb if telemetry_on else None,
            lat_hist_cb=slo_eval.on_lat_delta if slo_eval is not None else None,
            on_chunk=_on_chunk if slo_eval is not None else None,
            cancel_check=_cancel_check,
            perf=perf_ledger,
        ))
        contexts.append({
            "job": job, "ow": ow, "cancel": cancel, "spans": spans,
            "vgroups": vgroups, "run_dir": run_dir, "tele_writer": tele_writer,
            "slo_eval": slo_eval, "perf": perf_ledger, "bucket": member_bucket,
            "n": n_live, "testcase": testcase, "leader_run": job0.run_id,
        })

    # ---------------------------------------------------- one program
    t0 = time.monotonic()
    for ctx in contexts:
        ctx["spans"].start("execute")
    try:
        pack_results = runner.run(members)
    except BaseException as e:  # noqa: BLE001 — whole-pack failure
        for ctx in contexts:
            ctx["spans"].end("execute", outcome="error")
            ctx["spans"].end("run", outcome="error", error=str(e)[:200])
            ctx["spans"].close()
        raise
    wall = time.monotonic() - t0
    # the pack's cold start, one verdict for every member (a pack never
    # resumes)
    from .cuda_transport import claim_kernel_builds

    verdict = compile_cache_verdict(device, _cache_on(job0), False,
                                    claim_kernel_builds())
    for ctx in contexts:
        ctx["compile_cache"] = verdict

    # ------------------------------------------------- per-member collect
    from ..engine.controller import TaskPreemptedError

    outs: list = []
    for idx, (ctx, m, res) in enumerate(zip(contexts, members, pack_results)):
        spans = ctx["spans"]
        try:
            outs.append(_collect_pack_member(
                idx, ctx, m, res, width, len(jobs), wall, transport_block,
                bucket_plan, outputs_root, mesh_block,
            ))
        except Exception as e:  # noqa: BLE001 — member-local failure
            outcome = "preempted" if isinstance(e, TaskPreemptedError) else "error"
            spans.end("run", outcome=outcome, error=str(e)[:200])
            outs.append(e)
        finally:
            spans.close()
    return outs


def _collect_pack_member(idx, ctx, member, res, width, n_members, wall,
                         transport_block, bucket_plan, outputs_root, mesh_block):
    """One pack member's RunOutput (``executor.py:2689-3080``): outcomes,
    metrics, journal (the sim block with ``sim.pack``, ``sim.bucket`` and,
    on a mesh, the pack-shared ``sim.mesh``), instance outputs."""
    from .telemetry import latency_percentiles

    job, ow, spans, cancel = ctx["job"], ctx["ow"], ctx["spans"], ctx["cancel"]
    groups = res["groups"]
    status = res["status"]
    n = ctx["n"]
    spans.end("execute", ticks=res["ticks"])
    spans.start("collect")
    result = Result.for_input(job)
    result.journal["events"] = {}
    if member.canceled and cancel.is_set():
        ow.warn("sim:torch %s: pack member canceled", job.run_id)

    metrics: dict = {}
    collect = getattr(ctx["testcase"], "collect_metrics", None)
    if callable(collect):
        for gi, g in enumerate(groups):
            try:
                metrics[g.id] = collect(g, res["states"][gi],
                                        status[g.offset : g.offset + g.count])
            except Exception as e:  # noqa: BLE001 — best-effort
                ow.warn("collect_metrics failed for group %s: %s", g.id, e)
    if metrics:
        result.journal["metrics"] = {
            gid: _aggregate_metrics(m) for gid, m in metrics.items()
        }
    tw = ctx["tele_writer"]
    if tw is not None:
        tw.close()
        result.journal["telemetry"] = {
            "rows": tw.rows_written,
            **({"file": "sim_timeseries.jsonl"} if tw.path is not None else {}),
            "totals": {
                "delivered": res["msgs_delivered"],
                "sent": res["msgs_sent"],
                "enqueued": res["msgs_enqueued"],
                "dropped": res["msgs_dropped"],
                "rejected": res["msgs_rejected"],
                "in_flight": res["cal_depth"],
                "fault_dropped": res.get("fault_dropped", 0),
            },
        }
    latency = {}
    if res.get("lat_hist") is not None:
        latency = {
            g.id: latency_percentiles(res["lat_hist"][gi], res["tick_ms"])
            for gi, g in enumerate(groups)
        }
    if ctx["slo_eval"] is not None:
        ctx["slo_eval"].close()
        result.journal["slo"] = ctx["slo_eval"].journal()
    perf_summary = None
    if ctx["perf"] is not None:
        ctx["perf"].close()
        perf_summary = ctx["perf"].summary()

    write_outputs = outputs_root is not None and n <= int(
        getattr(job.runner_config, "write_outputs_max", 2048)
        if job.runner_config is not None else 2048
    )
    for gi, g in enumerate(groups):
        st = status[g.offset : g.offset + g.count]
        result.outcomes[g.id].ok = int(np.sum(st == 1))
        result.journal["events"][g.id] = {
            name: int(np.sum(st == code)) for code, name in _STATUS_NAME.items()
        }
        if write_outputs:
            _write_instance_outputs(outputs_root, job, g, st, res, metrics.get(g.id))

    bucket_block = None
    if bucket_plan is not None and ctx["bucket"] is not None:
        mb = ctx["bucket"]
        bucket_block = {
            "instances": mb.live_n,
            "padded_instances": mb.padded_n,
            "dead_lanes": mb.padded_n - mb.live_n,
            "per_group": {
                g.id: {"live": lv, "padded": pv}
                for g, lv, pv in zip(ctx["vgroups"], mb.live_counts, mb.padded_counts)
            },
            "compile_cache": ctx["compile_cache"],
        }
    result.journal["sim"] = {
        "ticks": res["ticks"],
        "tick_ms": res["tick_ms"],
        "wall_secs": wall,
        "processes": 1,
        "compile_secs": round(res.get("compile_secs", 0.0), 3),
        "devices": (
            int(mesh_block["shards"]) * int(mesh_block["runs"]) if mesh_block else 1
        ),
        "pub_dropped": res["pub_dropped"].tolist(),
        "latency_clamped": res.get("latency_clamped", 0),
        "bw_queue_dropped": res.get("bw_queue_dropped", 0),
        "bw_rate_change_backlogged": res.get("bw_rate_change_backlogged", 0),
        "msgs_delivered": res.get("msgs_delivered", 0),
        "msgs_sent": res.get("msgs_sent", 0),
        "msgs_enqueued": res.get("msgs_enqueued", 0),
        "msgs_dropped": res.get("msgs_dropped", 0),
        "msgs_rejected": res.get("msgs_rejected", 0),
        "msgs_in_flight": res.get("cal_depth", 0),
        "faults_crashed": res.get("faults_crashed", 0),
        "faults_restarted": res.get("faults_restarted", 0),
        "msgs_fault_dropped": res.get("fault_dropped", 0),
        "carry_bytes": res.get("carry_bytes", 0),
        # the pack-shared transport (one resolution per pack)
        "transport": transport_block,
        # this member's slot in the shared program
        "pack": {
            "width": width,
            "members": n_members,
            "index": idx,
            "leader_run": ctx["leader_run"],
        },
        **({"latency": latency} if latency else {}),
        **({"perf": perf_summary} if perf_summary else {}),
        **({"bucket": bucket_block} if bucket_block else {}),
        # the pack-shared mesh layout, where the pack's calendar is split
        **({"mesh": mesh_block} if mesh_block else {}),
    }
    result.update_outcome()
    if member.canceled and cancel.is_set():
        result.outcome = Outcome.CANCELED
    slo_eval = ctx["slo_eval"]
    if slo_eval is not None and slo_eval.fatal is not None and not cancel.is_set():
        from .slo import SloBreachError

        result.outcome = Outcome.FAILURE
        err = SloBreachError(slo_eval.fatal)
        result.journal["slo"]["error"] = str(err)
        err.run_output = RunOutput(run_id=job.run_id, result=result)
        spans.end("collect")
        spans.end("run", outcome=result.outcome.value, ticks=res["ticks"])
        raise err
    preempt_ev = getattr(job, "preempt", None)
    if (member.canceled and preempt_ev is not None and preempt_ev.is_set()
            and not cancel.is_set()):
        from ..engine.controller import TaskPreemptedError

        # an evicted member: its lanes stopped at the chunk boundary, and a
        # pack member writes no snapshots, so it reruns from scratch. After
        # the SLO raise: a fatal breach wins over eviction
        spans.point("preempt", tick=int(res["ticks"]), snapshot_tick=0,
                    resumable=False)
        spans.end("collect")
        raise TaskPreemptedError(job.run_id, tick=int(res["ticks"]), resumable=False)
    ow.infof("sim:torch %s: packed run done — %d ticks, %s", job.run_id, res["ticks"],
             result.outcome.value)
    spans.end("collect")
    spans.end("run", outcome=result.outcome.value, ticks=res["ticks"])
    return RunOutput(run_id=job.run_id, result=result)


def _fan_out(callbacks: list):
    """One callback calling each of ``callbacks`` in turn; None for none."""
    if not callbacks:
        return None
    if len(callbacks) == 1:
        return callbacks[0]

    def call(*args):
        for cb in callbacks:
            cb(*args)

    return call


# ------------------------------------------------------------ profiler

PROFILE_TRACE_FILE = "trace.json"


def _profiler(device):
    """A ``torch.profiler`` session over the host and, on a card, the
    device."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def _export(prof, profile_dir) -> None:
    try:
        prof.export_chrome_trace(os.path.join(profile_dir, PROFILE_TRACE_FILE))
    except Exception:  # noqa: BLE001 — capture is best-effort
        pass


def _profiled_run(run, profile_dir, device):
    """``run()`` under a profiler session of the whole run, its Chrome
    trace written into ``profile_dir``; a profiler that does not start
    leaves the run unprofiled, never failed."""
    try:
        prof = _profiler(device)
        prof.start()
    except Exception:  # noqa: BLE001 — capture is best-effort
        return run()
    try:
        return run()
    finally:
        try:
            prof.stop()
        except Exception:  # noqa: BLE001
            pass
        else:
            _export(prof, profile_dir)


class _ChunkedProfiler:
    """Bounded capture (``profile_chunks=N``, ``executor.py:3308-3377``):
    ``on_chunk(ticks)`` fires at every chunk's end; the first call (the
    warm-up chunk just completed) starts a profiler session, and once N
    more chunks have completed it stops and writes the Chrome trace. A
    profiler failure ends the capture, never the run."""

    def __init__(self, profile_dir: str, chunks: int, device):
        self.dir = profile_dir
        self.chunks = max(1, int(chunks))
        self.device = device
        self.started = False
        self.done = False
        self.from_tick: int | None = None
        self.to_tick: int | None = None
        self.captured = 0
        self._prof = None

    def on_chunk(self, ticks: int) -> None:
        if self.done:
            return
        if not self.started:
            try:
                self._prof = _profiler(self.device)
                self._prof.start()
            except Exception:  # noqa: BLE001 — capture is best-effort
                self.done = True
                return
            self.started = True
            self.from_tick = int(ticks)
            return
        self.captured += 1
        self.to_tick = int(ticks)
        if self.captured >= self.chunks:
            self._stop()

    def _stop(self) -> None:
        try:
            self._prof.stop()
        except Exception:  # noqa: BLE001
            pass
        else:
            _export(self._prof, self.dir)
        self.done = True

    def close(self) -> None:
        if self.started and not self.done:
            self._stop()

    def journal(self) -> dict:
        out: dict = {"dir": "profiles", "mode": "chunks", "chunks": self.captured}
        if self.from_tick is not None:
            out["from_tick"] = self.from_tick
        if self.to_tick is not None:
            out["to_tick"] = self.to_tick
        if self.started and not self.captured:
            # the run ended inside the warm-up chunk: the trace holds no
            # steady-state chunk
            out["note"] = (
                "run ended before any post-warmup chunk completed — the "
                "capture is empty; use profile_chunks=0 (whole-run) for "
                "runs this short"
            )
        return out


# ------------------------------------------------------- per-chunk sinks


class _SimTelemetryWriter:
    """Streams each chunk's ``[chunk, K]`` telemetry block to the run's
    series file as it arrives (``executor.py:3381-3456``): host memory is
    bounded by one chunk, and a crashed run keeps every row written so
    far. Without an outputs dir the writer only counts rows."""

    def __init__(self, group_ids: tuple, ident: dict, path: str | None,
                 append: bool = False, rows_offset: int = 0):
        self.group_ids = group_ids
        self.ident = ident
        self.path = path
        # a resumed run continues the series: the file was truncated to the
        # snapshot's offset, and the row count continues from its count
        self.rows_written = int(rows_offset)
        self._f = None
        if path is not None:
            try:
                self._f = open(path, "a" if append else "w")
            except OSError:
                self.path = None  # observe best-effort, never fail the run

    def on_block(self, block) -> list:
        """Decode and stream one chunk's block; returns the decoded rows
        for the SLO evaluator."""
        from .telemetry import rows_from_blocks

        rows = rows_from_blocks([block], self.group_ids)
        self.rows_written += len(rows)
        if self._f is not None:
            try:
                for row in rows:
                    self._f.write(json.dumps({**self.ident, **row}) + "\n")
                self._f.flush()
            except (OSError, ValueError):
                _close_quietly(self._f)
                self._f = None
                self.path = None
        return rows

    def close(self) -> None:
        if self._f is not None:
            try:
                self._f.close()
            except OSError:
                self.path = None
            finally:
                self._f = None

    def iter_rows(self):
        """Re-read the written series (for the Influx mirror): the rows
        were streamed out, not retained."""
        from .telemetry import iter_jsonl

        if self.path is None:
            return
        yield from iter_jsonl(self.path)


# Influx lines per POST for the sim telemetry family — far under
# InfluxDB's default 25 MB body cap (a line is ~100 bytes) while still
# amortizing the HTTP round trip.
_INFLUX_BATCH_LINES = 5000


def _push_sim_series(endpoint: str, rows_iter, base_ns: int) -> dict:
    """Expand streamed sim telemetry rows to viewer shape and push them in
    bounded batches (``executor.py:3271-3306``). Returns one merged journal
    dict ({pushed, ok, batches, error?, aborted?}); a failed batch (already
    retried by ``push_rows``) aborts the rest of the mirror."""
    from ..metrics.influx import push_rows
    from ..metrics.viewer import expand_sim_row

    journal: dict = {"pushed": 0, "ok": True, "batches": 0}

    def push(batch: list) -> bool:
        j = push_rows(endpoint, batch, base_ns=base_ns)
        journal["pushed"] += j.get("pushed", 0)
        journal["batches"] += 1
        if not j.get("ok"):
            journal["ok"] = False
            journal.setdefault("error", j.get("error", "push failed"))
            journal["aborted"] = True  # remaining batches not attempted
            return False
        return True

    batch: list = []
    for row in rows_iter:
        batch.extend(expand_sim_row(row))
        if len(batch) >= _INFLUX_BATCH_LINES:
            if not push(batch):
                return journal
            batch = []
    if batch:
        push(batch)
    return journal


class _SimNetMatrixWriter:
    """Streams each chunk's traffic-matrix delta to
    ``sim_netmatrix.jsonl`` (``executor.py:3459-3520``): one row a chunk,
    nonzero cells only."""

    def __init__(self, prog, ident: dict, path: str | None, append: bool = False,
                 chunks_offset: int = 0):
        self.chunk = int(prog.chunk)
        self.ident = ident
        self.path = path
        self.chunks_written = int(chunks_offset)
        self._f = None
        if path is not None:
            try:
                self._f = open(path, "a" if append else "w")
            except OSError:
                self.path = None

    def on_delta(self, delta) -> None:
        from .netmatrix import delta_row

        idx = self.chunks_written
        self.chunks_written += 1
        if self._f is None:
            return
        row = delta_row(delta, tick=(idx + 1) * self.chunk, chunk=idx,
                        ident=self.ident)
        try:
            self._f.write(json.dumps(row) + "\n")
            self._f.flush()
        except (OSError, ValueError):
            _close_quietly(self._f)
            self._f = None
            self.path = None

    def close(self) -> None:
        if self._f is not None:
            try:
                self._f.close()
            except OSError:
                self.path = None
            finally:
                self._f = None


class _SimTraceWriter:
    """Streams each chunk's ``[chunk, R, 5]`` flight-recorder block into
    ``sim_trace.jsonl`` (``executor.py:3523-3681``), and buffers the
    decoded events, up to the plan's ``events`` cap, for the Chrome trace
    export written at :meth:`close`; past the cap ``truncated`` counts
    what the export lost."""

    def __init__(self, groups, ident: dict, run_dir, tick_ms: float, plan,
                 resume: dict | None = None):
        from .trace import TRACE_EVENTS_FILE, TRACE_FILE

        self.plan = plan
        self.ident = ident
        self.tick_ms = float(tick_ms)
        # a resumed run continues the stream: the counters come from the
        # snapshot, the export buffer from the truncated jsonl prefix
        self.events_written = int((resume or {}).get("events", 0) or 0)
        self.truncated = int((resume or {}).get("truncated", 0) or 0)
        self._buffer: list[dict] = []
        # lane → (group id, group-relative seq) for the traced lanes only
        self._lane_group = {}
        for lane in plan.lanes:
            lane = int(lane)
            g = next((g for g in groups if g.offset <= lane < g.offset + g.count),
                     None)
            self._lane_group[lane] = (g.id, lane - g.offset) if g is not None else ("", -1)
        self._gid_of = {lane: gid for lane, (gid, _) in self._lane_group.items()}
        self.path = os.path.join(run_dir, TRACE_FILE) if run_dir is not None else None
        self.events_path = (
            os.path.join(run_dir, TRACE_EVENTS_FILE) if run_dir is not None else None
        )
        self._f = None
        if self.path is not None:
            if resume is not None:
                self._seed_buffer_from_file()
            try:
                self._f = open(self.path, "a" if resume is not None else "w")
            except OSError:
                self.path = None

    def _seed_buffer_from_file(self) -> None:
        """Re-read the truncated jsonl prefix into the export buffer, up to
        the plan's ``events`` cap, so a resumed run's ``trace_events.json``
        covers the whole run; best-effort."""
        from .telemetry import iter_jsonl

        drop = set(self.ident)
        try:
            for row in iter_jsonl(self.path):
                if len(self._buffer) >= self.plan.events_cap:
                    break
                self._buffer.append({k: v for k, v in row.items() if k not in drop})
        except OSError:
            pass

    def on_block(self, block) -> None:
        from .trace import events_from_blocks

        events = events_from_blocks([block], lambda i: self._gid_of.get(i, ""))
        self.events_written += len(events)
        room = self.plan.events_cap - len(self._buffer)
        if room > 0:
            self._buffer.extend(events[:room])
        self.truncated += max(0, len(events) - max(room, 0))
        if self._f is not None:
            try:
                for ev in events:
                    self._f.write(json.dumps({**self.ident, **ev}) + "\n")
                self._f.flush()
            except (OSError, ValueError):
                _close_quietly(self._f)
                self._f = None
                self.path = None

    def close(self) -> None:
        from .trace import chrome_trace

        if self._f is not None:
            try:
                self._f.close()
            except OSError:
                self.path = None
            finally:
                self._f = None
        if self.events_path is None:
            return
        lane_names = {
            lane: f"{gid}[{seq}] i{lane}"
            for lane, (gid, seq) in self._lane_group.items()
        }
        try:
            with open(self.events_path, "w") as f:
                json.dump(chrome_trace(self._buffer, self.plan.lanes, lane_names,
                                       self.tick_ms), f)
        except (OSError, ValueError):
            self.events_path = None

    def journal(self) -> dict:
        from .trace import TRACE_EVENTS_FILE, TRACE_FILE

        out: dict = {"events": self.events_written, "instances": self.plan.count}
        if self.path is not None:
            out["file"] = TRACE_FILE
        if self.events_path is not None:
            out["events_file"] = TRACE_EVENTS_FILE
        if self.truncated:
            out["truncated"] = self.truncated
        return out


class _TimeSeriesRecorder:
    """Periodic per-group metric reductions over the live carry
    (``executor.py:3684-3779``): every ``every`` ticks the plan's
    ``collect_metrics`` runs on the states read off the device, and the
    per-group reductions become ``timeseries.jsonl`` rows."""

    def __init__(self, testcase, groups, every: int, ow: OutputWriter,
                 phys_groups=None):
        self._collect = getattr(testcase, "collect_metrics", None)
        # ``groups`` is the exact layout the rows report in, ``phys_groups``
        # the padded one of a padded carry (None without padding)
        self.groups = groups
        self._phys = phys_groups
        self.every = int(every or 0)
        self._next_at = self.every
        self._last_tick = -1
        self.rows: list[dict] = []
        self.ow = ow
        self._warned: set[str] = set()

    @property
    def enabled(self) -> bool:
        return callable(self._collect) and self.every > 0

    # the sampled rows ride a run's snapshots, so a resumed run's
    # timeseries.jsonl still covers the whole run
    def state_dict(self) -> dict:
        return {"rows": list(self.rows), "next_at": self._next_at,
                "last_tick": self._last_tick}

    def load_state(self, state: dict) -> None:
        self.rows = [dict(r) for r in state.get("rows", [])]
        self._next_at = int(state.get("next_at", self.every))
        self._last_tick = int(state.get("last_tick", -1))

    def observe(self, ticks: int, carry) -> None:
        if ticks < self._next_at:
            return
        self._next_at = ticks + self.every
        # the sampled read: the reference's own cost, once per cadence
        states = tuple(
            {k: v.detach().cpu().numpy() for k, v in s.items()} for s in carry.states
        )
        status = carry.status.detach().cpu().numpy()
        if self._phys is not None:
            # a padded carry: each group's live span only
            states = tuple({k: v[: g.count] for k, v in st.items()}
                           for st, g in zip(states, self.groups))
            status = np.concatenate([status[pg.offset : pg.offset + g.count]
                                     for pg, g in zip(self._phys, self.groups)])
        self.sample(ticks, states, status)

    def sample(self, tick: int, states, status) -> None:
        if tick == self._last_tick:  # final sample on a cadence boundary
            return
        self._last_tick = tick
        for gi, g in enumerate(self.groups):
            try:
                m = self._collect(
                    g, {k: np.asarray(v) for k, v in states[gi].items()},
                    status[g.offset : g.offset + g.count],
                )
            except Exception as e:  # noqa: BLE001 — sampling is best-effort
                if g.id not in self._warned:
                    self._warned.add(g.id)
                    self.ow.warn("timeseries sample failed for group %s: %s", g.id, e)
                continue
            for name, agg in _aggregate_metrics(m).items():
                self.rows.append({"tick": int(tick), "group_id": g.id, "name": name,
                                  **agg})


def _close_quietly(f) -> None:
    try:
        f.close()
    except OSError:
        pass


def _aggregate_metrics(group_metrics: dict) -> dict:
    """Per-group reductions of the per-instance metric arrays
    (``executor.py:3782-3801``); NaN entries are excluded."""
    agg = {}
    for name, arr in group_metrics.items():
        a = np.asarray(arr, np.float64).reshape(-1)
        a = a[~np.isnan(a)]
        if a.size == 0:
            agg[name] = {"count": 0}
            continue
        agg[name] = {
            "count": int(a.size),
            "mean": float(a.mean()),
            "min": float(a.min()),
            "max": float(a.max()),
        }
    return agg


def _write_instance_outputs(outputs_root, job, g, st, res, group_metrics) -> None:
    """The reference's outputs layout (``local_docker.go:258-267``): one
    dir per instance with run.out / metrics.out."""
    for i in range(g.count):
        d = instance_output_dir(outputs_root, job.test_plan, job.run_id, g.id, i)
        os.makedirs(d, exist_ok=True)
        name = _STATUS_NAME.get(int(st[i]), "incomplete")
        fin = int(res["finished_at"][g.offset + i])
        with open(os.path.join(d, "run.out"), "w") as f:
            f.write(json.dumps({
                "ts": time.time_ns(),
                "event": {
                    "type": name if name != "incomplete" else "message",
                    **({"message": "incomplete (max_ticks reached)"}
                       if name == "incomplete" else {}),
                },
                "group_id": g.id,
                "finished_at_tick": fin,
            }) + "\n")
        if group_metrics:
            with open(os.path.join(d, "metrics.out"), "w") as f:
                for mname, arr in group_metrics.items():
                    f.write(json.dumps({
                        "ts": time.time_ns(),
                        "name": mname,
                        "value": float(np.asarray(arr)[i]),
                        "type": "point",
                    }) + "\n")
