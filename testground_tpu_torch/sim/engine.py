"""The sim engine over torch: steps a (testcase × groups) configuration to
completion, one tick at a time.

Port of ``testground_tpu/sim/engine.py`` for the main path: a tick is
deliver → plan step → shaped enqueue → sync fold → network reconfig
(``engine.py:1516-1706``), and ticks run in chunks with the reference's
chunk semantics exactly (``engine.py:1807-1870, 2063-2141``):

- a tick after global completion is a no-op: the tick counter, keys and
  calendar stop where the last real tick left them;
- ``results()['ticks']`` advances by ``chunk`` per chunk dispatched.

A Python loop replaces ``lax.scan``. The done flag is read on the host
once per tick (the reference reads it once per chunk and masks the rest
on the device): the read is a device sync, overlapped with the tail of
the tick by copying the flag right after the step phase, before the
commit's launches are queued.

Cumulative flow totals are int64 tensors (the reference keeps 2-limb
int32 pairs because jax runs without x64); ``results()`` returns the same
Python ints. The link-model key advances on the host (two uint32 lanes;
evaluating that threefry on the card would cost ~100 kernel launches a
tick), the per-instance keys live on the run's device.

Additional hosts are echo lanes past the instance axis (``hosts``): their
traffic rides the transport's control routes, they never terminate, and
``results()`` slices them off. A fault schedule (``faults``, lowered by
``sim/faults.py``) adds a phase at tick start — restarts, then crashes
with the purge of the victims' in-flight rows — and send-time kills in the
transport. The schedule's ticks are known on the host, so the re-init and
the purge run only on the ticks it names (the reference gates both behind
``lax.cond`` on the device). Without hosts and a schedule, the tick is the
one it was before either existed.

The observability planes (``engine.py:1465-1514, 1562-1579, 1659-1673,
1708-1780, 1833-1870``) are options of the program, each off by default:

- ``telemetry``: a ``[K]`` int32 counter row a tick
  (``telemetry.TELEMETRY_FIXED_COLUMNS`` and one live count per group),
  written into the chunk's ``[chunk, K]`` block on the device, and the
  per-group delivery-latency histogram, read off the etick plane that K1
  writes, accumulated in ``carry.lat_hist``;
- ``netmatrix`` (needs ``telemetry``): the ``[6, GH, GH]`` src-group ×
  dst-group flow counts in ``carry.net_mat``, crash purges included, and
  under ``bandwidth_queue`` the per-group queue high-water;
- ``trace``: a ``trace.TracePlan``; its lanes' event rows go into a
  ``[chunk, R, 5]`` block.

A chunk's blocks and its histogram and matrix deltas are copied to the
host once per chunk, on the chunk's last tick, and the done flag's event
is recorded behind those copies: the wait the loop makes for the flag
covers them, so the planes add no host wait. Ticks after global
completion leave their rows at -1, as the reference's padding does. The
histogram and the matrix are zeroed at every flush (the host sums the
deltas in int64), so the device counters never wrap. With every plane
off the tick enters no plane code and issues no plane op.

``run`` has the reference's loop hooks (``cancel``, ``on_chunk``, the
stall watchdog, ``nan_guard``, the perf ledger's ``perf``), all at a
chunk's end. The reference's admission refusals of incompatible
declarations are kept, with the same messages.

Shape buckets (``live_counts``, ``sim/buckets.py``, ``engine.py:636-940,
2156-2234``): ``groups`` is the padded layout, ``live_counts`` the exact
per-group counts. The dead lanes are CRASH from tick 0; the plans see the
exact layout's counts as 0-d tensors; virtual destinations translate to
physical lanes, delivered senders back, and the shaping dice hash the
exact run's message indices; live lane v gets the exact run's key v. The
maps are static (the counts are fixed for the run), so each is one
lookup tensor built with the program and one gather a tick. ``results()``
demuxes to the exact layout: every result is the exact run's, bit for bit.

``mesh`` (a ``meshplan.TorchMesh``) splits the calendar's lane axis over
the mesh's peer shards (row 0's on a 2-D mesh): each shard's planes live
on its device, the
commit and the pop are the sharded kernels, and every other carry leaf
stays on the mesh's primary device (shard 0's). A lane count that does
not divide across the shards gets dead lanes at the end of its last group
(the same machinery, the counts as Python ints), which nothing outside
the program sees: results, snapshots (:class:`LaneExport`) and the
footprint keep the caller's layout. Every result is the unmeshed run's,
bit for bit.

A cohort mesh (``sim/distributed.global_mesh``) spans processes: every
process builds the same program, keeps the whole instance state on its
own device and steps it identically, holding only its own cells'
calendar shards. ``run`` reads the done flag off each process's own
replica, and the caller passes a ``distributed.CohortCancel`` so the
chunk-boundary cancel check is one vote of the cohort; ``results()`` reads
the leader's replica through ``distributed.to_host``.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import itertools
import math
import threading
import time
from typing import Any, Callable

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

from . import prng
from .api import (
    CRASH,
    RUNNING,
    GroupSpec,
    Inbox,
    Outbox,
    SimEnv,
    SimTestcase,
    StepOut,
    SyncView,
)
from .net import (
    BANDWIDTH,
    MSG_BYTES,
    Calendar,
    LinkState,
    apply_net_updates,
    deliver,
    enqueue,
    latency_histogram,
    make_link_state,
    purge_dst,
    purge_dst_matrix,
    spread_offsets,
)
from .faults import DeviceFaults
from .meshplan import plan_for
from .netmatrix import (
    NM_CHANNELS,
    NM_DELIVERED,
    NM_DROPPED,
    NM_ENQUEUED,
    NM_FAULT,
    NM_REJECTED,
    NM_SENT,
)
from .sync_kernel import (
    SyncState,
    live_per_group,
    make_sub_window,
    make_sync_state,
    sync_occupancy,
    update_sync,
)
from .telemetry import LATENCY_BINS, TELEMETRY_FIXED_COLUMNS
from .trace import EV_DELIVER, EV_SEND, EV_SIGNAL, EV_STATUS

__all__ = [
    "MAX_FILTER_CELLS",
    "SimCarry",
    "SimProgram",
    "SimStallError",
    "build_groups",
    "carry_digest",
    "carry_footprint",
    "device_context",
    "resolve_device",
]

# what a plan's step may not do to a tensor under bucketing: read its value
# on the host (a device sync every tick on a card)
_HOST_READS = frozenset(
    ("__int__", "__index__", "__bool__", "__float__", "__complex__", "item", "tolist",
     "numpy")
)
HOST_READ_ERROR = "a plan's step read a device value on the host under shape bucketing"


class _NoHostReads(TorchFunctionMode):
    """A padded program's first step: a plan that reads a tensor's value
    on the host (``int(env.test_instance_count)``, a ``while`` on a count)
    raises, as the reference's trace of the step raises
    ``ConcretizationTypeError`` on its traced counts. On a card such a read
    would be a device sync every tick."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if getattr(func, "__name__", None) in _HOST_READS:
            raise TypeError(
                f"{HOST_READ_ERROR} ({func.__name__}): the counts, offsets and "
                "global_seq a padded run hands its plan are 0-d device tensors; "
                "compute with them on the device, or run with bucket=off"
            )
        return func(*args, **(kwargs or {}))


class SimStallError(RuntimeError):
    """A chunk outlasted the wall-clock watchdog (``chunk_timeout``): the
    caller is released with a diagnostic instead of waiting forever on
    the device. The reference's class, with its message."""

    def __init__(self, ticks: int, chunk_index: int, timeout: float):
        self.ticks = ticks
        self.chunk_index = chunk_index
        self.timeout = timeout
        super().__init__(
            f"sim chunk {chunk_index} did not complete within "
            f"{timeout:g}s wall (last completed tick {ticks}) — device "
            "hang or a pathologically slow dispatch; the cancel event "
            "was set and the dispatch abandoned"
        )


def _check_carry_finite(carry, tick_lo: int, tick_hi: int) -> None:
    """The ``nan_guard`` scan (``engine.py:133-158``): every float leaf of
    the carry, failing on the first NaN or Inf with its path and the
    chunk's tick range."""

    def walk(x, path):
        if isinstance(x, torch.Tensor):
            if x.is_floating_point() and not bool(torch.isfinite(x).all()):
                kind = "NaN" if bool(torch.isnan(x).any()) else "Inf"
                raise FloatingPointError(
                    f"nan_guard: {kind} in carry leaf 'carry{path}' after "
                    f"ticks ({tick_lo}, {tick_hi}] — the plan's arithmetic "
                    "(or a shaping input) produced a non-finite value in "
                    "that tick range"
                )
        elif isinstance(x, dict):
            for k, v in x.items():
                walk(v, f"{path}[{k!r}]")
        elif isinstance(x, (tuple, list)):
            for i, v in enumerate(x):
                walk(v, f"{path}[{i}]")
        elif dataclasses.is_dataclass(x):
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name), f"{path}.{f.name}")

    walk(carry, "")


# Budget for the dense [R, N] per-region filter table, in int32 cells
# (2**28 = 1 GiB), as in the reference.
MAX_FILTER_CELLS = 2**28


def device_context(dev: torch.device):
    """``dev`` made the calling thread's current CUDA device, where it is a
    card. The kernels of ``cuda_transport`` launch on the current device
    with the stream of their tensors' device, and the current device is per
    host thread: a thread that runs on another card than its current one
    (a daemon's worker, a run on ``cuda:1``) enters this first."""
    if dev is not None and dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def resolve_device(device=None) -> torch.device:
    """The run's device: CUDA unless the caller names another. Without a
    GPU, ``device=None`` raises — the port never drops to the CPU on its
    own."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on the GPU unless the caller "
                "passes device='cpu'"
            )
        return torch.device("cuda")
    return torch.device(device)


@dataclasses.dataclass
class SimCarry:
    """Everything that evolves across ticks (see the reference
    ``SimCarry``). Scalars are 0-d tensors on the run's device, except the
    link key, which advances on the host."""

    states: tuple  # per-group dicts of [count, ...] tensors
    status: torch.Tensor  # [N + H] int32 (H additional hosts)
    finished_at: torch.Tensor  # [N + H] int32 (-1 if never terminal)
    cal: Calendar  # over N + H lanes
    link: LinkState  # over N + H lanes
    sync: SyncState  # over the N instances
    rejected: torch.Tensor  # [N + H] int32 — REJECT feedback from last tick
    keys: torch.Tensor  # [N, 2] per-instance keys (uint32 words in int64)
    net_key: tuple  # link-model key: two uint32 words as Python ints
    t: torch.Tensor  # int32 current tick
    clamped: torch.Tensor
    bw_dropped: torch.Tensor
    bw_rate_changed: torch.Tensor
    collisions: torch.Tensor
    collision_where: torch.Tensor  # [2] int32
    msgs_delivered: torch.Tensor  # int64 totals
    msgs_sent: torch.Tensor
    msgs_enqueued: torch.Tensor
    msgs_dropped: torch.Tensor
    msgs_rejected: torch.Tensor
    cal_depth: torch.Tensor  # int32 in-flight occupancy
    faults_crashed: torch.Tensor
    faults_restarted: torch.Tensor
    fault_dropped: torch.Tensor  # int64
    # [G, LATENCY_BINS] int32 delivery-latency bin counts since the last
    # chunk flush (telemetry only)
    lat_hist: torch.Tensor | None = None
    # [G] int32 exact per-group counts (shape bucketing only; the
    # reference's leaf, threaded through unchanged)
    live_counts: torch.Tensor | None = None
    # [NM_CHANNELS, GH, GH] int32 flow counts since the last chunk flush
    # (netmatrix only)
    net_mat: torch.Tensor | None = None
    # [GH] float32 per-src-group HTB backlog high-water, never flushed
    # (netmatrix with bandwidth_queue only)
    net_bw_hiwater: torch.Tensor | None = None


def build_groups(run_groups, parameters_of=None) -> tuple[GroupSpec, ...]:
    """Lay groups out contiguously on the instance axis."""
    specs = []
    off = 0
    for i, g in enumerate(run_groups):
        params = dict(g.parameters) if parameters_of is None else parameters_of(g)
        specs.append(
            GroupSpec(id=g.id, index=i, offset=off, count=g.instances, params=params)
        )
        off += g.instances
    return tuple(specs)


_PY_CAST = {torch.bool: bool, torch.int32: int, torch.float32: float}
_PY_SCALARS = (bool, int, float)


def _plane(x, shape, dtype, device, consts: dict) -> torch.Tensor:
    """A StepOut field as a plane of ``shape``: broadcasts tensors and
    [.., 1] fields, casts to the plane's dtype. A Python scalar is a
    constant plane filled on the device once and kept in ``consts`` (a
    host→device copy would wait on the host every tick); consumers never
    write into a plane."""
    if isinstance(x, _PY_SCALARS):
        v = _PY_CAST[dtype](x)
        key = (v, tuple(shape), dtype)
        if key not in consts:
            consts[key] = torch.full(shape, v, dtype=dtype, device=device)
        return consts[key]
    return torch.as_tensor(x, device=device).to(dtype).broadcast_to(shape)


class SimProgram:
    def __init__(
        self,
        testcase: SimTestcase,
        groups: tuple[GroupSpec, ...],
        *,
        test_plan: str = "plan",
        test_case: str = "case",
        test_run: str = "run",
        tick_ms: float = 1.0,
        chunk: int = 128,
        device=None,
        hosts: tuple[str, ...] = (),
        validate: bool = False,
        faults=None,
        telemetry: bool = False,
        netmatrix: bool = False,
        trace=None,
        mesh=None,
        live_counts=None,
        lane_multiple: int = 1,
    ):
        cls = type(testcase)
        # Shape bucketing (sim/buckets.py, the reference's rules and
        # messages, engine.py:340-378): ``groups`` is the PADDED layout and
        # ``live_counts`` the exact per-group sizes
        if live_counts is not None:
            live_counts = tuple(int(c) for c in live_counts)
            if len(live_counts) != len(groups):
                raise ValueError(
                    f"live_counts has {len(live_counts)} entries for "
                    f"{len(groups)} group(s) — the bucket plan must be "
                    "built from the same group layout"
                )
            for lc, g in zip(live_counts, groups):
                if not (0 < lc <= g.count):
                    raise ValueError(
                        f"group {g.id!r}: live count {lc} outside "
                        f"(0, {g.count}] — padding only ever adds lanes"
                    )
            if trace is not None:
                raise ValueError(
                    "the flight recorder is not supported with shape "
                    "bucketing (trace lanes are virtual-layout selectors "
                    "baked into the program) — run with bucket=off to "
                    "trace"
                )
            if "filter_rules" in cls.SHAPING and len(groups) > 1:
                raise ValueError(
                    "shape bucketing with multiple groups is incompatible "
                    "with 'filter_rules' shaping: rule ranges address the "
                    "exact (virtual) instance layout, and multi-group "
                    "padding shifts physical ids non-contiguously — run "
                    "with bucket=off or a single group"
                )
        if mesh is not None and mesh.runs is not None:
            # a solo run on a 2-D mesh: its lanes split over row 0's peer
            # shards (the reference shards i and replicates over runs)
            mesh = mesh.row(0)
        if mesh is None:
            self.device = resolve_device(device)
        else:
            # every leaf but the calendar's planes lives on shard 0's device
            want = None if device is None else torch.device(device)
            if want is not None and (
                want.type != mesh.primary.type
                or want.index not in (None, mesh.primary.index)
            ):
                raise ValueError(
                    f"device {device} is not the mesh's primary device "
                    f"{mesh.primary}: a meshed run keeps its other leaves there"
                )
            self.device = mesh.primary
        self.mesh = mesh
        self.meshplan = plan_for(mesh)
        self.tc = testcase
        groups = tuple(groups)
        # echo lanes past the instance axis (SimEnv.host_index)
        self.hosts = tuple(hosts)
        # every shard holds an equal contiguous block of lanes: a lane
        # count that does not divide across the shards gets dead lanes at
        # the end of its last group (the reference's GSPMD pads its lane
        # axis internally). Like the bucket's, they are CRASH from tick
        # 0; unlike the bucket's, nothing outside the program sees them —
        # results, snapshots and the footprint keep the caller's layout
        n_in = sum(g.count for g in groups)
        self.bucketed = live_counts is not None
        # ``lane_multiple``: the peer shards of the mesh an unmeshed run
        # pack's program is laid over (``sim/pack.py``), padded the same way
        shards = max(1 if self.meshplan is None else self.meshplan.shards,
                     int(lane_multiple))
        self.mesh_pad = -(n_in + len(self.hosts)) % shards
        if self.mesh_pad:
            if live_counts is None:
                live_counts = tuple(g.count for g in groups)
            last = groups[-1]
            groups = groups[:-1] + (
                dataclasses.replace(last, count=last.count + self.mesh_pad),
            )
            if faults is not None and faults.n == n_in:
                from .faults import remap_schedule

                faults = remap_schedule(faults, np.arange(n_in), n_in + self.mesh_pad)
            if trace is not None and trace.n == n_in:
                trace = dataclasses.replace(
                    trace, n=n_in + self.mesh_pad,
                    mask=np.concatenate([trace.mask, np.zeros(self.mesh_pad, bool)]),
                )
        self.groups = groups
        self.n = sum(g.count for g in groups)
        self.n_lanes = self.n + len(self.hosts)
        # the exact per-group counts where the layout is padded (None
        # otherwise), and whether plans see them as 0-d tensors: under
        # bucketing they do (the traced-count contract), under the mesh
        # padding alone as Python ints
        self.live_counts = live_counts
        self._virt = _Virtual(self) if live_counts is not None else None
        # the reference traces the step once per compile with the counts as
        # traced scalars; the port watches the plan's first step instead
        self._watch_host_reads = self.bucketed
        self.tick_ms = float(tick_ms)
        self.chunk = int(chunk)
        self.validate = bool(validate)
        self.meta = dict(test_plan=test_plan, test_case=test_case, test_run=test_run)
        self.telemetry = bool(telemetry)
        self._tele_k = len(TELEMETRY_FIXED_COLUMNS) + len(groups) if telemetry else 0
        self.netmatrix = bool(netmatrix)
        if self.netmatrix and not self.telemetry:
            raise ValueError(
                "the traffic-matrix plane rides the telemetry chunk "
                "flush: enable telemetry or drop netmatrix"
            )
        # one hosts row past the groups, so echo traffic stays accounted
        self._nm_gh = len(groups) + (1 if self.hosts else 0)
        self.faults = faults
        if faults is not None and faults.n != self.n:
            raise ValueError(
                f"fault schedule lowered for {faults.n} instance(s) but "
                f"the program has {self.n} — the schedule must be built "
                "from the same group layout"
            )
        self.trace = trace
        if trace is not None and trace.n != self.n:
            raise ValueError(
                f"trace plan lowered for {trace.n} instance(s) but the "
                f"program has {self.n} — the plan must be built from "
                "the same group layout"
            )
        # the schedule's masks on the device, once per program
        self._faults = (
            DeviceFaults.lower(faults, self.device, self.n_lanes)
            if faults is not None
            else None
        )
        jitter_ms = cls.DEFAULT_LINK[1] if "jitter" in cls.SHAPING else 0.0
        base_ticks = int(np.ceil((cls.DEFAULT_LINK[0] + jitter_ms) / tick_ms))
        if base_ticks > cls.MAX_LINK_TICKS - 1:
            raise ValueError(
                f"DEFAULT_LINK latency+jitter ({cls.DEFAULT_LINK[0]}+"
                f"{jitter_ms} ms = {base_ticks} ticks at {tick_ms} ms/tick) "
                "exceeds the calendar horizon MAX_LINK_TICKS-1 = "
                f"{cls.MAX_LINK_TICKS - 1}; raise MAX_LINK_TICKS or the tick "
                "duration"
            )
        _check_declarations(cls, self.hosts)
        self.n_states = len(cls.STATES)
        self.n_topics = len(cls.TOPICS)
        self.n_regions = cls.N_REGIONS if cls.N_REGIONS > 0 else len(groups)
        cells = self.n_regions * self.n_lanes
        if cells > MAX_FILTER_CELLS:
            raise ValueError(
                f"filter table [R={self.n_regions}, N={self.n}] needs "
                f"{cells:,} cells ({cells * 4 / 2**30:.1f} GiB int32), "
                f"over the MAX_FILTER_CELLS budget of {MAX_FILTER_CELLS:,} "
                f"({MAX_FILTER_CELLS * 4 / 2**30:.1f} GiB) — coarsen "
                "N_REGIONS (per-instance granularity is practical to ~8k "
                "instances, see PERF.md) or raise "
                "testground_tpu_torch.sim.engine.MAX_FILTER_CELLS"
            )
        self._build_layout(self.device)
        self._carry_bytes = None
        self._consts = {}  # constant StepOut planes on the device (_plane)
        if self.telemetry or self.trace is not None:
            self._build_plane_statics(cls)

    def _build_layout(self, dev) -> None:
        """The static per-lane group map and per-group index planes on
        ``dev``, built once."""
        groups = self.groups
        self._group_of = torch.repeat_interleave(
            torch.arange(len(groups), dtype=torch.int32, device=dev),
            torch.tensor([g.count for g in groups], device=dev),
            output_size=self.n,
        )
        self._gseq = [
            torch.arange(g.count, dtype=torch.int32, device=dev) for g in groups
        ]
        self._gs = [s + g.offset for s, g in zip(self._gseq, groups)]
        if self._virt is not None:
            self._virt = self._virt.built(self, dev)

    def _build_plane_statics(self, cls) -> None:
        """The planes' static index tensors on the run's device, built once
        per program (``engine.py:473-486, 602-617``)."""
        dev = self.device
        n_g = len(self.groups)
        i64 = torch.int64
        # lane → group for the histogram and the matrix rows: host lanes
        # map to row G (the histogram's trash row, the matrix's hosts row)
        group_of = torch.cat([
            self._group_of.to(i64),
            torch.full((len(self.hosts),), n_g, dtype=i64, device=dev),
        ])
        self._plane_group_of = group_of
        self._zero = torch.zeros((), dtype=torch.int32, device=dev)
        # post-host-merge outbox rows (the outbox grows to the echo slots)
        o_rows = max(cls.OUT_MSGS, cls.IN_MSGS) if self.hosts else cls.OUT_MSGS
        if self.netmatrix:
            gh = self._nm_gh
            # the tick's delta is counted privatised (net.spread_offsets):
            # lane j adds into copy j mod P, folded by one sum
            self._nm_copies, spread = spread_offsets(
                group_of.shape[0], NM_CHANNELS * gh * gh, dev
            )
            # message m's sender lane is m mod n_lanes
            self._nm_src_cell = (group_of * gh + spread).repeat(o_rows)
            self._nm_del_cell = (NM_DELIVERED * gh * gh + group_of + spread)[None, :]
            # by which flow channels are present (rejected and fault-killed
            # may be absent): the present channels' offsets
            chans = (NM_SENT, NM_ENQUEUED, NM_REJECTED, NM_FAULT)
            self._nm_flow_chan = {
                have: torch.tensor([c for c, h in zip(chans, have) if h], dtype=i64,
                                   device=dev)[:, None] * (gh * gh)
                for have in itertools.product((True,), (True,), (False, True), (False, True))
            }
        self._trace_nrows = 0
        if self.trace is not None:
            lanes = torch.as_tensor(self.trace.lanes, dtype=i64, device=dev)
            n_l = lanes.shape[0]
            s = len(cls.STATES)
            self._trace_lanes = lanes
            self._trace_nrows = n_l * (1 + s + o_rows + cls.IN_MSGS)
            # per row: its lane, and its event kind when the slot is hit
            counts = (1, s, o_rows, cls.IN_MSGS)
            kinds = (EV_STATUS, EV_SIGNAL, EV_SEND, EV_DELIVER)
            i32 = torch.int32
            self._trace_lane_col = lanes.to(i32).repeat(sum(counts))
            self._trace_kind = torch.cat([
                torch.full((c * n_l,), k, dtype=i32, device=dev)
                for c, k in zip(counts, kinds)
            ])
            self._trace_sid = torch.arange(s, dtype=i32, device=dev).repeat_interleave(n_l)
            self._trace_zeros = torch.zeros(
                max(s, cls.IN_MSGS) * n_l, dtype=i32, device=dev
            )

    # ---------------------------------------------------------------- init

    def _env_for(self, g: GroupSpec, keys, tick=None) -> SimEnv:
        v = self._virt
        if v is not None:
            # a padded layout: the plan sees the exact layout's counts,
            # offsets and global_seq (engine.py:787-817), and its tensors
            # are the group's physical length (group_lanes)
            return SimEnv(
                test_plan=self.meta["test_plan"],
                test_case=self.meta["test_case"],
                test_run=self.meta["test_run"],
                test_instance_count=v.test_instance_count,
                tick_ms=self.tick_ms,
                groups=v.groups,
                group=v.groups[g.index],
                global_seq=v.global_seq[g.index],
                group_seq=self._gseq[g.index],
                device=self.device,
                hosts=self.hosts,
                group_lanes=g.count,
                base_keys=keys,
                tick=tick,
            )
        return SimEnv(
            test_plan=self.meta["test_plan"],
            test_case=self.meta["test_case"],
            test_run=self.meta["test_run"],
            test_instance_count=self.n,
            tick_ms=self.tick_ms,
            groups=self.groups,
            group=g,
            global_seq=self._gs[g.index],
            group_seq=self._gseq[g.index],
            device=self.device,
            hosts=self.hosts,
            group_lanes=g.count,
            base_keys=keys,
            tick=tick,
        )

    def _init_states(self, keys) -> tuple:
        """``testcase.init`` of every group under the instances' root keys
        (at tick 0, and again for a restart)."""
        return tuple(
            self.tc.init(self._env_for(g, keys[g.offset : g.offset + g.count]))
            for g in self.groups
        )

    def init_carry(self, seed: int = 0, live_counts=None) -> SimCarry:
        """The run's carry at tick 0. ``live_counts`` is the reference's
        argument: under bucketing the program's own counts (the default),
        refused on a program without a bucket plan and when they differ
        (the port builds its virtual maps once per program). A padded
        layout's dead lanes are CRASH from tick 0 (``engine.py:819-940``)."""
        if live_counts is not None:
            if self.live_counts is None:
                raise ValueError(
                    "init_carry live_counts must be provided exactly when "
                    "the program was built with a bucket plan"
                )
            if tuple(int(c) for c in live_counts) != tuple(self.live_counts):
                raise ValueError(
                    f"init_carry live_counts {tuple(live_counts)} differ from "
                    f"the program's bucket plan {self.live_counts}: the port "
                    "builds its virtual maps once per program"
                )
        cls = type(self.tc)
        dev = self.device
        # the root split on the host: the link key stays there, and the
        # instance root crosses once
        net_key, inst_root = prng.split(prng.key(seed))
        inst_root = inst_root.to(dev)
        if self._virt is None:
            keys = prng.split(inst_root, self.n)
        else:
            # live lane v gets the exact run's key v (the port's split
            # hashes the counter pair (0, v) alone, prng.py), the dead
            # lanes the counters from ln up
            y1, y2 = prng.threefry2x32(inst_root[0], inst_root[1], 0, self._virt.key_ctr)
            keys = torch.stack([y1, y2], dim=-1)
        states = self._init_states(keys)
        lanes = self.n_lanes
        # host lanes sit past the instance axis: region 0 (their traffic
        # bypasses filters anyway), default egress, no sync participation
        region_of = torch.clamp(self._group_of, max=self.n_regions - 1)
        if self.hosts:
            region_of = torch.cat(
                [region_of, torch.zeros(len(self.hosts), dtype=torch.int32, device=dev)]
            )

        def z(dtype=torch.int32):
            return torch.zeros((), dtype=dtype, device=dev)

        status = torch.full((lanes,), RUNNING, dtype=torch.int32, device=dev)
        if self._virt is not None:
            status[: self.n].masked_fill_(self._virt.dead, CRASH)
        return SimCarry(
            states=states,
            status=status,
            finished_at=torch.full((lanes,), -1, dtype=torch.int32, device=dev),
            cal=Calendar.empty(
                cls.MAX_LINK_TICKS,
                lanes,
                cls.IN_MSGS,
                cls.MSG_WIDTH,
                # the matrix attributes deliveries and purges to senders,
                # so it forces the provenance plane on (the plan is still
                # served all-zero src when it opted out)
                track_src=cls.TRACK_SRC or self.netmatrix,
                # the enqueue-tick plane feeds the latency histogram
                track_etick=self.telemetry,
                device=dev,
                mesh=self.mesh,
            ),
            link=make_link_state(
                lanes,
                self.n_regions,
                cls.DEFAULT_LINK,
                region_of=region_of,
                track_backlog="bandwidth_queue" in cls.SHAPING,
                n_rules=cls.FILTER_RULES if "filter_rules" in cls.SHAPING else 0,
                device=dev,
            ),
            sync=make_sync_state(
                self.n,
                self.n_states,
                self.n_topics,
                cls.TOPIC_CAP,
                cls.PUB_WIDTH,
                device=dev,
            ),
            rejected=torch.zeros(lanes, dtype=torch.int32, device=dev),
            keys=keys,
            net_key=(int(net_key[0]), int(net_key[1])),
            t=z(),
            clamped=z(),
            bw_dropped=z(),
            bw_rate_changed=z(),
            collisions=z(),
            collision_where=torch.zeros(2, dtype=torch.int32, device=dev),
            msgs_delivered=z(torch.int64),
            msgs_sent=z(torch.int64),
            msgs_enqueued=z(torch.int64),
            msgs_dropped=z(torch.int64),
            msgs_rejected=z(torch.int64),
            cal_depth=z(),
            faults_crashed=z(),
            faults_restarted=z(),
            fault_dropped=z(torch.int64),
            lat_hist=(
                torch.zeros((len(self.groups), LATENCY_BINS), dtype=torch.int32,
                            device=dev)
                if self.telemetry
                else None
            ),
            # threaded through unchanged, never written
            live_counts=self._virt.live_counts if self.bucketed else None,
            net_mat=(
                torch.zeros((NM_CHANNELS, self._nm_gh, self._nm_gh),
                            dtype=torch.int32, device=dev)
                if self.netmatrix
                else None
            ),
            net_bw_hiwater=(
                torch.zeros(self._nm_gh, dtype=torch.float32, device=dev)
                if self.netmatrix and "bandwidth_queue" in cls.SHAPING
                else None
            ),
        )

    def estimate_carry_bytes(self) -> int:
        """The reference's footprint of the run's carry
        (``estimate_carry_bytes``, ``engine.py:1784-1803``; see
        :func:`carry_footprint`), computed from the shapes alone: the carry
        is built once on the meta device, so nothing is allocated. A
        process's first use of the meta device imports torch's meta
        kernels, which takes seconds; :func:`carry_footprint` of a built
        carry gives the same number at no cost."""
        if self._carry_bytes is None:
            self._carry_bytes = carry_footprint(self.meta_carry())
        return self._carry_bytes

    def footprint(self, carry: SimCarry) -> int:
        """:func:`carry_footprint` of this program's ``carry`` in the
        caller's layout: a mesh padding's dead lanes are not counted (the
        reference's meshed footprint has the exact shapes)."""
        out = carry_footprint(carry)
        if self.mesh_pad:
            out -= LaneExport(self).dead_bytes(carry)
        if self.mesh is not None and self.mesh.cohort:
            # a cohort process holds its own cells' calendar shards: the
            # footprint counts every process's, as the reference's global
            # arrays do
            held = sum(s1 - s0 for _, s0, s1 in self.mesh.parts)
            out += carry_bytes(carry.cal) * (self.mesh.size - held) // held
        return out

    def lane_export(self) -> "LaneExport | None":
        """How a snapshot of this program cuts the mesh padding's dead
        lanes out (None without them)."""
        return LaneExport(self) if self.mesh_pad else None

    def meta_carry(self) -> SimCarry:
        """The run's carry built on the meta device: every leaf's shape and
        dtype, no storage (the checkpoint plane validates a snapshot
        against it before a byte reaches the card)."""
        meta = copy.copy(self)
        meta.device = torch.device("meta")
        meta.mesh = None if self.mesh is None else self.mesh.on(meta.device)
        meta._consts = {}
        meta._build_layout(meta.device)
        return meta.init_carry(0)

    # ---------------------------------------------------------------- tick

    def _normalize(self, out: StepOut, n_g: int) -> dict:
        """One group's StepOut as full planes (instance axis last)."""
        cls = type(self.tc)
        dev = self.device
        i32, f32, b = torch.int32, torch.float32, torch.bool
        s, tt = len(cls.STATES), len(cls.TOPICS)
        o, w, pw = cls.OUT_MSGS, cls.MSG_WIDTH, cls.PUB_WIDTH
        ob = out.outbox or Outbox.empty(o, w, n_g, dev)

        def plane(x, shape, dtype):
            return _plane(0 if x is None else x, shape, dtype, dev, self._consts)

        filters = out.net_filters
        if filters is None:
            filters = torch.zeros((0, n_g), dtype=i32, device=dev)
        rules = out.net_rules
        return {
            "state": out.state,
            "status": plane(out.status, (n_g,), i32),
            "dst": plane(ob.dst, (o, n_g), i32),
            "payload": plane(ob.payload, (o, w, n_g), i32),
            "valid": plane(ob.valid, (o, n_g), b),
            "signals": plane(out.signals, (s, n_g), i32),
            "pub_payload": plane(out.pub_payload, (tt, pw, n_g), i32),
            "pub_valid": plane(out.pub_valid, (tt, n_g), b),
            "sub_consume": plane(out.sub_consume, (tt, n_g), i32),
            "net_shape": plane(out.net_shape, (7, n_g), f32),
            "net_shape_valid": plane(out.net_shape_valid, (n_g,), b),
            "net_filters": plane(filters, (filters.shape[0], n_g), i32),
            "net_filters_valid": plane(out.net_filters_valid, (n_g,), b),
            # None when the group emits no rules (most plans): no planes
            "net_rules": None if rules is None
            else plane(rules, (rules.shape[0], 3, n_g), i32),
            "net_rules_valid": None if rules is None
            else plane(out.net_rules_valid, (n_g,), b),
            "region": plane(out.region, (n_g,), i32),
            "region_valid": plane(out.region_valid, (n_g,), b),
        }

    def _step_phase(self, carry: SimCarry, inbox_all: Inbox, t) -> dict:
        """Per-group ``testcase.step`` over the batched group slices,
        terminal-instance freezing, and the per-group output planes
        concatenated along the instance axis."""
        cls = type(self.tc)
        live_g = live_per_group(carry.status, self.groups)
        sub_payload, sub_valid = make_sub_window(carry.sync, cls.SUB_K)
        outs = []
        for g in self.groups:
            lo, hi = g.offset, g.offset + g.count
            inbox_g = Inbox(
                payload=inbox_all.payload[:, :, lo:hi],
                src=inbox_all.src[:, lo:hi],
                valid=inbox_all.valid[:, lo:hi],
            )
            sync_g = SyncView(
                counts=carry.sync.counts,
                last_seq=carry.sync.last_seq[:, lo:hi],
                sub_payload=sub_payload[..., lo:hi],
                sub_valid=sub_valid[..., lo:hi],
                rejected=carry.rejected[lo:hi],
                dropped=carry.sync.dropped,
                live=live_g,
            )
            env = self._env_for(g, carry.keys[lo:hi], tick=t)
            if self._watch_host_reads:
                with _NoHostReads():
                    out = self.tc.step(env, carry.states[g.index], inbox_g, sync_g, t)
            else:
                out = self.tc.step(env, carry.states[g.index], inbox_g, sync_g, t)
            outs.append(self._normalize(out, g.count))
        self._watch_host_reads = False

        n = self.n
        active = carry.status[:n] == RUNNING  # [N]; host lanes echo below

        def freeze(old, new, a):
            a = a.reshape(a.shape + (1,) * (new.dim() - 1))
            return torch.where(a, new, old)

        new_states = tuple(
            {
                k: freeze(
                    carry.states[gi][k],
                    outs[gi]["state"][k],
                    active[g.offset : g.offset + g.count],
                )
                for k in carry.states[gi]
            }
            for gi, g in enumerate(self.groups)
        )

        def cat(name, dim=-1):
            if len(outs) == 1:
                return outs[0][name]
            return torch.cat([o[name] for o in outs], dim=dim)

        status_new = cat("status")
        status = torch.where(active, status_new, carry.status[:n])
        finished_at = torch.where(
            active & (status_new != RUNNING), t, carry.finished_at[:n]
        )
        active_i = active.to(torch.int32)
        net_filters, net_filters_valid = self._merge_reconfig(
            outs, "net_filters", (self.n_regions,), active
        )
        n_rules = cls.FILTER_RULES if "filter_rules" in cls.SHAPING else 0
        net_rules, net_rules_valid = (None, None)
        if n_rules > 0 and any(_emits(o, "net_rules", (n_rules, 3)) for o in outs):
            net_rules, net_rules_valid = self._merge_reconfig(
                outs, "net_rules", (n_rules, 3), active
            )
        step = {
            "states": new_states,
            "status": status,
            "finished_at": finished_at,
            "dst": cat("dst"),
            "payload": cat("payload"),
            "valid": cat("valid") & active[None, :],
            "signals": cat("signals") * active_i[None, :],
            "pub_payload": cat("pub_payload"),
            "pub_valid": cat("pub_valid") & active[None, :],
            "sub_consume": cat("sub_consume") * active_i[None, :],
            "net_shape": cat("net_shape"),
            "net_shape_valid": cat("net_shape_valid") & active,
            "net_filters": net_filters,
            "net_filters_valid": net_filters_valid,
            "net_rules": net_rules,
            "net_rules_valid": net_rules_valid,
            "net_region": cat("region"),
            "net_region_valid": cat("region_valid") & active,
        }
        if self.hosts:
            self._merge_hosts(step, carry, inbox_all)
        return step

    def _merge_hosts(self, step: dict, carry: SimCarry, inbox_all: Inbox) -> None:
        """Append the host lanes to a step's planes (``engine.py:1206-1237,
        1292-1309``): their status and finished_at carry over; the echo
        service sends every message delivered to a host lane straight back
        to its sender, payload verbatim (the outbox grows to max(OUT_MSGS,
        IN_MSGS) rows); and the reconfiguration planes get valid=False
        columns, since hosts never reconfigure."""
        n, h = self.n, len(self.hosts)
        step["status"] = torch.cat([step["status"], carry.status[n:]])
        step["finished_at"] = torch.cat([step["finished_at"], carry.finished_at[n:]])
        h_dst = inbox_all.src[:, n:]  # [SLOTS, H]
        h_val = inbox_all.valid[:, n:]
        h_pay = inbox_all.payload[:, :, n:].transpose(0, 1)  # [SLOTS, W, H]
        rows = max(step["dst"].shape[0], h_dst.shape[0])

        def pad_rows(x):
            if x.shape[0] >= rows:
                return x
            pad = torch.zeros((rows - x.shape[0],) + x.shape[1:], dtype=x.dtype,
                              device=x.device)
            return torch.cat([x, pad])

        for name, hx in (("dst", h_dst), ("payload", h_pay), ("valid", h_val)):
            step[name] = torch.cat([pad_rows(step[name]), pad_rows(hx)], dim=-1)

        def pad_cols(x, fill=0):
            pad = torch.full(x.shape[:-1] + (h,), fill, dtype=x.dtype, device=x.device)
            return torch.cat([x, pad], dim=-1)

        for name in ("net_shape", "net_filters", "net_region", "net_rules"):
            if step[name] is not None:
                step[name] = pad_cols(step[name])
                step[name + "_valid"] = pad_cols(step[name + "_valid"], False)

    def _merge_reconfig(self, outs, name, lead, active):
        """Concatenate an optional reconfiguration plane (``lead + (n_g,)``)
        along the instance axis: a group that emits none contributes zero
        columns that are never applied (valid = False)."""
        dev = self.device
        emits = [_emits(o, name, lead) for o in outs]
        plane = torch.cat([
            o[name] if e
            else torch.zeros(lead + (g.count,), dtype=torch.int32, device=dev)
            for o, g, e in zip(outs, self.groups, emits)
        ], dim=-1)
        valid = torch.cat([
            o[name + "_valid"] if e
            else torch.zeros(g.count, dtype=torch.bool, device=dev)
            for o, g, e in zip(outs, self.groups, emits)
        ]) & active
        return plane, valid

    def _fault_phase(self, carry: SimCarry, tick: int):
        """The fault plane's point events at tick START
        (``engine.py:974-1091``): scheduled restarts revive CRASHED slots —
        ``testcase.init`` re-run under the instance's original key, its
        sync history kept — then scheduled crashes flip RUNNING slots to
        CRASH and purge the in-flight rows toward them. Only the ticks the
        schedule names do either. Returns ``(carry, crashed_t, restarted_t,
        purged_t, dead)``: the counts are None on a tick with no event;
        ``dead`` is the post-event CRASH mask over every lane."""
        f = self._faults
        t = carry.t
        status, finished_at = carry.status, carry.finished_at
        states, cal = carry.states, carry.cal
        crashed_t = restarted_t = purged_t = None
        rmask = f.restart_at(tick)
        if rmask is not None:
            revive = rmask & (status == CRASH)  # host lanes: never in a mask
            restarted_t = revive.sum(dtype=torch.int32)
            fresh = self._init_states(carry.keys)

            def sel(new, old, rv):  # rv over the leaf's leading axis
                rv = rv.reshape(rv.shape + (1,) * (new.dim() - 1))
                return torch.where(rv, new, old)

            states = tuple(
                {
                    k: sel(fresh[g.index][k], v, revive[g.offset : g.offset + g.count])
                    for k, v in states[g.index].items()
                }
                for g in self.groups
            )
            status = torch.where(revive, RUNNING, status)
            finished_at = torch.where(revive, -1, finished_at)
        cmask = f.crash_at(tick)
        net_mat = carry.net_mat
        if cmask is not None:
            kill = cmask & (status == RUNNING)
            crashed_t = kill.sum(dtype=torch.int32)
            if self.netmatrix:
                # the purge charges each lost message to its (sender group,
                # crashed receiver group) cell of the fault channel
                cal, purged_t, pmat = purge_dst_matrix(
                    cal, kill, self._plane_group_of, self._nm_gh
                )
                net_mat = net_mat.clone()
                net_mat[NM_FAULT] += pmat
            else:
                cal, purged_t = purge_dst(cal, kill)
            status = torch.where(kill, CRASH, status)
            finished_at = torch.where(kill, t, finished_at)
        carry = dataclasses.replace(
            carry, states=states, status=status, finished_at=finished_at, cal=cal,
            net_mat=net_mat,
        )
        return carry, crashed_t, restarted_t, purged_t, status == CRASH

    def _tick(self, carry: SimCarry, timer=None, done_out=None,
              tick: int | None = None, blocks=None, row: int = 0) -> SimCarry:
        """One simulated tick. ``timer.mark(name)`` (optional) is called at
        the tick's start ("tick") and at the end of each stretch of it,
        naming the stretch: "faults" (with a schedule), "deliver" (the pop
        and the delivered count), "netmatrix" (the matrix's receiver
        cells), "lat_hist" (with telemetry), "step", "commit" (enqueue and
        the link updates), "sync" (the sync fold), "carry" (the flow
        accounting, the matrix's send cells and the new carry), and, with
        ``blocks``, "trace" and "telemetry" (the planes' rows). Every mark
        sits behind ``timer is not None``: a tick without a timer runs no
        code of them.
        ``done_out`` (optional) is a ``(flag, event)`` pair: the host bool
        tensor ``flag`` receives this tick's all-done flag by a non-blocking
        copy queued right after the step phase, and ``event`` (a CUDA
        event, or None) is recorded behind it, so the caller can wait for
        the flag without waiting for the commit. ``tick`` is ``carry.t`` as
        the host knows it; a run with a fault schedule reads it off
        ``carry.t`` when it is not given. ``blocks`` (a :class:`_Blocks`)
        receives this tick's telemetry and trace rows at index ``row``."""
        cls = type(self.tc)
        t = carry.t
        if timer is not None:
            timer.mark("tick")
        # the flight recorder's status events see scheduled crashes and
        # restarts too: its snapshot precedes the fault phase
        status_prev = carry.status
        crashed_t = restarted_t = purged_t = dead = None
        if self._faults is not None:
            if tick is None:
                tick = int(t)
            carry, crashed_t, restarted_t, purged_t, dead = self._fault_phase(
                carry, tick
            )
            if timer is not None:
                timer.mark("faults")
        cal, inbox = deliver(carry.cal, t)
        delivered_t = inbox.valid.sum(dtype=torch.int32)
        if timer is not None:
            timer.mark("deliver")
        nm = lat_hist = None
        if self.netmatrix:
            # receiver-side cells from the physical provenance; a plan that
            # opted out of provenance is then served the all-zero src of a
            # valid-plane calendar, so it runs as it does with the plane off
            nm = self._netmatrix_delivered(inbox)
            if not cls.TRACK_SRC:
                inbox = Inbox(payload=inbox.payload, src=torch.zeros_like(inbox.src),
                              valid=inbox.valid)
            if timer is not None:
                timer.mark("netmatrix")
        virt = self._virt
        if virt is not None and cls.TRACK_SRC:
            # delivered provenance back to virtual ids: plans reply to
            # inbox.src, so it must hold the exact run's values
            inbox = Inbox(payload=inbox.payload, src=virt.src(inbox.src),
                          valid=inbox.valid)
        if self.telemetry:
            lat_hist = carry.lat_hist + latency_histogram(
                cal, inbox, t, self._plane_group_of, len(self.groups), LATENCY_BINS
            )
            if timer is not None:
                timer.mark("lat_hist")
        step = self._step_phase(carry, inbox, t)
        if done_out is not None:
            flag, event = done_out
            flag.copy_((step["status"][: self.n] != RUNNING).all(), non_blocking=True)
            if event is not None:
                event.record()
        if timer is not None:
            timer.mark("step")
        net_key, k_msg = prng.split_host(carry.net_key)
        dst, dice_idx = step["dst"], None
        if virt is not None:
            # plan-emitted virtual destinations → physical lanes, and the
            # shaping dice hash the exact run's message indices
            dst, dice_idx = virt.dst(dst), virt.dice_idx
        cal, fb = enqueue(
            cal,
            carry.link,
            dst,
            step["payload"],
            step["valid"],
            t,
            self.tick_ms,
            k_msg,
            slot_mode=cls.SLOT_MODE,
            features=tuple(cls.SHAPING),
            control_start=self.n if self.hosts else None,
            stacking=cls.CROSS_TICK_STACKING,
            bw_queue_cap=cls.BW_QUEUE_MSGS,
            validate=self.validate,
            faults=self._faults,
            dead=dead,
            tick=tick,
            want_fate=self.trace is not None,
            want_flow=self.netmatrix,
            dice_idx=dice_idx,
        )
        link = apply_net_updates(
            carry.link,
            step["net_shape"],
            step["net_shape_valid"],
            step["net_filters"],
            step["net_filters_valid"],
            step["net_region"],
            step["net_region_valid"],
            step["net_rules"],
            step["net_rules_valid"],
        )
        bw_rate_changed = carry.bw_rate_changed
        if fb.backlog is not None:
            # HTB queue depths advance each tick; a rate change under a
            # standing backlog is where the queue bound is approximate, so
            # those (src, tick) events are counted (engine.py:1451-1462)
            changed = (link.egress[BANDWIDTH] != carry.link.egress[BANDWIDTH]) & (
                fb.backlog > 0
            )
            bw_rate_changed = bw_rate_changed + changed.sum(dtype=torch.int32)
            link = dataclasses.replace(link, backlog=fb.backlog)
        collisions, collision_where = carry.collisions, carry.collision_where
        if self.validate:  # fb.collisions is 0 without validate
            collisions = collisions + fb.collisions
            # the first collision wins: keep the earliest (dst, slot)
            collision_where = torch.where(
                (carry.collisions == 0) & (fb.collisions > 0),
                fb.collision_where,
                collision_where,
            )
        if timer is not None:
            timer.mark("commit")
        sync = update_sync(
            carry.sync,
            step["signals"],
            step["pub_payload"],
            step["pub_valid"],
            step["sub_consume"],
        )
        if timer is not None:
            timer.mark("sync")
        rejected_t = fb.rejected.sum(dtype=torch.int32)
        dropped_t = fb.sent - fb.enqueued - rejected_t - fb.fault_dropped
        # flow accounting (engine.py:1608-1619): crash purges move already
        # enqueued messages from the in-flight depth into fault_dropped, so
        # sent = delivered + in-flight + dropped + rejected + fault_dropped
        # stays exact
        fault_dropped_t = fb.fault_dropped
        cal_depth = carry.cal_depth + fb.enqueued - delivered_t
        if purged_t is not None:
            fault_dropped_t = fault_dropped_t + purged_t
            cal_depth = cal_depth - purged_t
        net_mat = net_bw_hiwater = None
        if self.netmatrix:
            nm = self._netmatrix_send(nm, fb.flow, dst)
            net_mat = carry.net_mat + nm.view(NM_CHANNELS, self._nm_gh, self._nm_gh)
            net_bw_hiwater = carry.net_bw_hiwater
            if net_bw_hiwater is not None:
                # monotone max of each sender group's HTB backlog
                net_bw_hiwater = net_bw_hiwater.scatter_reduce(
                    0, self._plane_group_of, link.backlog, "amax"
                )
        new = SimCarry(
            states=step["states"],
            status=step["status"],
            finished_at=step["finished_at"],
            cal=cal,
            link=link,
            sync=sync,
            rejected=fb.rejected,
            keys=carry.keys,
            net_key=net_key,
            t=t + 1,
            clamped=carry.clamped + fb.clamped,
            bw_dropped=carry.bw_dropped + fb.bw_dropped,
            bw_rate_changed=bw_rate_changed,
            collisions=collisions,
            collision_where=collision_where,
            msgs_delivered=carry.msgs_delivered + delivered_t,
            msgs_sent=carry.msgs_sent + fb.sent,
            msgs_enqueued=carry.msgs_enqueued + fb.enqueued,
            msgs_dropped=carry.msgs_dropped + dropped_t,
            msgs_rejected=carry.msgs_rejected + rejected_t,
            cal_depth=cal_depth,
            faults_crashed=(
                carry.faults_crashed if crashed_t is None
                else carry.faults_crashed + crashed_t
            ),
            faults_restarted=(
                carry.faults_restarted if restarted_t is None
                else carry.faults_restarted + restarted_t
            ),
            fault_dropped=carry.fault_dropped + fault_dropped_t,
            lat_hist=lat_hist,
            live_counts=carry.live_counts,
            net_mat=net_mat,
            net_bw_hiwater=net_bw_hiwater,
        )
        if timer is not None:
            timer.mark("carry")
        if blocks is None:
            return new
        if self.trace is not None:
            self._trace_rows(
                blocks.trace[row], t, status_prev, step["status"], step["signals"],
                step["dst"], step["valid"], fb.fate, inbox,
            )
            if timer is not None:
                timer.mark("trace")
        if self.telemetry:
            self._telemetry_row(
                blocks.tele[row], t, step["status"], sync, delivered_t, fb.sent,
                fb.enqueued, dropped_t, rejected_t, cal_depth, crashed_t,
                restarted_t, fault_dropped_t,
            )
            if timer is not None:
                timer.mark("telemetry")
        return new

    def _netmatrix_delivered(self, inbox: Inbox) -> torch.Tensor:
        """A fresh ``[P, NM_CHANNELS·GH·GH]`` privatised matrix delta
        holding this tick's deliveries per (sender group, receiver group)
        cell (``engine.py:1365-1382``), read off the physical provenance:
        column j is receiver lane j, host echoes land in the hosts
        row/column."""
        gh = self._nm_gh
        nm = torch.zeros(self._nm_copies * NM_CHANNELS * gh * gh, dtype=torch.int32,
                         device=self.device)
        srcg = self._plane_group_of[inbox.src.clamp(0, self.n_lanes - 1)]
        idx = srcg * gh + self._nm_del_cell
        nm.scatter_add_(0, idx.reshape(-1), inbox.valid.reshape(-1).to(torch.int32))
        return nm

    def _netmatrix_send(self, nm: torch.Tensor, flow: tuple,
                        dst: torch.Tensor) -> torch.Tensor:
        """Add one tick's send-side channels to the privatised delta ``nm``
        and fold it (``engine.py:1331-1363``); returns the flat
        ``[NM_CHANNELS·GH·GH]`` delta. The transport's per-message flow
        channels (sent, enqueued, and rejected and fault-killed where a
        feature can fill them) land at (sender group, physical destination
        group), an invalid destination charged to its clipped lane's group.
        The dropped channel is what the other four leave, cell by cell: the
        reference's per-message residual, summed."""
        gh = self._nm_gh
        cells = NM_CHANNELS * gh * gh
        cell = self._nm_src_cell + self._plane_group_of[
            dst.reshape(-1).clamp(0, self.n_lanes - 1)
        ]
        chan = self._nm_flow_chan[tuple(c is not None for c in flow)]
        nm.scatter_add_(0, (chan + cell[None, :]).reshape(-1),
                        torch.stack([c for c in flow if c is not None]).reshape(-1))
        nm = nm.view(self._nm_copies, cells).sum(0, dtype=torch.int32)
        ch = nm.view(NM_CHANNELS, gh * gh)
        ch[NM_DROPPED] = ch[NM_SENT] - ch[NM_ENQUEUED] - ch[NM_REJECTED] - ch[NM_FAULT]
        return nm

    def _telemetry_row(self, out, t, status, sync, delivered_t, sent_t,
                       enqueued_t, dropped_t, rejected_t, cal_depth, crashed_t,
                       restarted_t, fault_dropped_t) -> None:
        """Write the tick's counter row into ``out`` ([K] int32,
        ``engine.py:1465-1514``): TELEMETRY_FIXED_COLUMNS from scalars the
        tick already holds, then the live (RUNNING) instances per group in
        one scatter. ``bytes_enqueued`` is an int32 multiply, as in the
        reference."""
        zero = self._zero
        sig_occ, pub_occ = sync_occupancy(sync)
        fixed = [
            t, delivered_t, sent_t, enqueued_t, dropped_t, rejected_t,
            enqueued_t * int(MSG_BYTES), cal_depth, sig_occ, pub_occ,
            zero if crashed_t is None else crashed_t,
            zero if restarted_t is None else restarted_t,
            fault_dropped_t,
        ]
        running = status[: self.n] == RUNNING
        if len(self.groups) == 1:
            torch.stack(fixed + [running.sum(dtype=torch.int32)], out=out)
            return
        nf = len(fixed)
        torch.stack(fixed, out=out[:nf])
        out[nf:].zero_().index_add_(
            0, self._plane_group_of[: self.n], running.to(torch.int32)
        )

    def _trace_rows(self, out, t, status_prev, status_new, signals, dst, valid,
                    fate, inbox) -> None:
        """Write the tick's flight-recorder rows into ``out`` ([R, 5] int32,
        columns tick, lane, kind, a, b; ``engine.py:1708-1780``): per traced
        lane one status slot, one per sync state, one per post-merge outbox
        row and one per inbox slot, in that order; an unused slot has kind
        -1 and keeps its a and b values, as in the reference."""
        lanes = self._trace_lanes
        n_l = lanes.shape[0]
        sp, sn = status_prev[lanes], status_new[lanes]
        hits = [sp != sn]
        a = [sn]
        b = [sp]
        if signals.shape[0] > 0:
            sig = signals[:, lanes]
            hits.append((sig > 0).reshape(-1))
            a.append(self._trace_sid)
            b.append(self._trace_zeros[: sig.numel()])
        hits += [valid[:, lanes].reshape(-1), inbox.valid[:, lanes].reshape(-1)]
        a += [dst[:, lanes].reshape(-1), inbox.src[:, lanes].reshape(-1)]
        b += [fate.view(dst.shape)[:, lanes].reshape(-1),
              self._trace_zeros[: inbox.valid.shape[0] * n_l]]
        kind = torch.where(torch.cat(hits), self._trace_kind, -1)
        torch.stack(
            [t.expand(self._trace_nrows), self._trace_lane_col, kind, torch.cat(a),
             torch.cat(b)],
            dim=1, out=out,
        )

    # ----------------------------------------------------------- execution

    def _all_done(self, carry: SimCarry) -> bool:
        """Host lanes never terminate: only plan instances gate done. With
        a fault schedule the run must also outlive its last event (an
        all-crashed fleet with a restart to come is paused, not done)."""
        done = bool((carry.status[: self.n] != RUNNING).all())
        if self._faults is not None:
            done = done and int(carry.t) > self._faults.last_event_tick
        return done

    def telemetry_schema(self) -> tuple[str, ...]:
        """Column names of the per-tick counter block, in device order
        (``engine.py:1877-1883``): the fixed flow/occupancy counters, then
        one ``live_<group id>`` column per group."""
        return TELEMETRY_FIXED_COLUMNS + tuple(f"live_{g.id}" for g in self.groups)

    def run(
        self,
        seed: int = 0,
        max_ticks: int = 10_000,
        observer: Callable[[int, SimCarry], None] | None = None,
        resume_carry: SimCarry | None = None,
        resume_ticks: int = 0,
        timer=None,
        telemetry_cb: Callable[[np.ndarray], None] | None = None,
        lat_hist_cb: Callable[[np.ndarray], None] | None = None,
        trace_cb: Callable[[np.ndarray], None] | None = None,
        netmatrix_cb: Callable[[np.ndarray], None] | None = None,
        lat_hist_init=None,
        net_mat_init=None,
        cancel=None,
        on_chunk: Callable[[int], None] | None = None,
        chunk_timeout: float = 0.0,
        chunk_sleep_ms: float = 0.0,
        on_stall: Callable[[int, int], None] | None = None,
        nan_guard: bool = False,
        perf=None,
        live_counts=None,
    ) -> dict[str, Any]:
        """Step to completion (or ``max_ticks``, rounded up to whole
        chunks, as the reference does). ``observer(ticks, carry)`` is
        called after every chunk with the live carry (its planes are
        updated in place by the next chunk). ``resume_carry`` /
        ``resume_ticks`` continue a run from a carry (e.g. one built by
        ``carry_io.carry_from_numpy``). ``timer`` receives per-phase marks
        (see :meth:`_tick`).

        The observability planes' callbacks, called after every chunk in
        the reference's order and before ``on_chunk`` and ``observer``
        (``engine.py:2118-2137``): ``telemetry_cb(block)`` gets the chunk's
        ``[chunk, K]`` int32 counter block, ``lat_hist_cb(delta)`` its
        ``[G, LATENCY_BINS]`` int64 histogram delta, ``netmatrix_cb(delta)``
        its ``[NM_CHANNELS, GH, GH]`` int64 matrix delta and
        ``trace_cb(block)`` its ``[chunk, R, 5]`` int32 event block, all as
        host numpy. The deltas also sum into ``results()['lat_hist']`` and
        ``['net_matrix']``, seeded by ``lat_hist_init`` / ``net_mat_init``
        on a resumed run.

        The reference's loop hooks (``engine.py:1928-1948``), all at the
        chunk's end, where the done flag has already been waited on, so
        none adds a host read to the tick: ``on_chunk(ticks)`` after the
        planes' callbacks; ``cancel`` (anything with ``is_set()``) checked
        after ``observer``; ``chunk_timeout`` > 0 arms the wall-clock
        watchdog from the third chunk on — a chunk that outlasts it sets
        ``cancel``, calls ``on_stall(last_tick, chunk_index)`` and raises
        :class:`SimStallError`; ``chunk_sleep_ms`` sleeps on the host in
        each chunk (a synthetic slowdown for tests); ``nan_guard`` reads
        every float leaf of the carry after each chunk and raises on a
        NaN or Inf (a debug flag: the read waits on the device).

        ``perf`` (a ``sim/perf.PerfLedger``) gets ``on_chunk(index, ticks,
        ticks_delta, wall_secs)`` once per chunk, ``wall_secs`` the
        chunk's host-clock wall from its first launch to the return of the
        wait on its last done event (``chunk_sleep_ms`` inside it, as in
        the reference): no launch and no device read of its own.
        ``live_counts`` is :meth:`init_carry`'s."""
        t0 = time.perf_counter()
        if resume_carry is not None:
            carry, ticks = resume_carry, int(resume_ticks)
        else:
            carry, ticks = self.init_carry(seed, live_counts), 0
        start_ticks = ticks
        cuda = self.device.type == "cuda"
        done_out = (
            torch.zeros((), dtype=torch.bool, pin_memory=cuda),
            torch.cuda.Event() if cuda else None,
        )
        blocks = None
        if self.telemetry or self.trace is not None:
            blocks = _Blocks(self, cuda)
        lat_acc = nm_acc = None
        if self.telemetry:
            lat_acc = (
                np.asarray(lat_hist_init, np.int64).copy()
                if lat_hist_init is not None
                else np.zeros((len(self.groups), LATENCY_BINS), np.int64)
            )
        if self.netmatrix:
            gh = self._nm_gh
            nm_acc = (
                np.asarray(net_mat_init, np.int64).copy()
                if net_mat_init is not None
                else np.zeros((NM_CHANNELS, gh, gh), np.int64)
            )
        # the host's copy of carry.t: a fault schedule resolves its events
        # and windows against it, and its done gate reads it
        last_event = None
        tick = None
        if self._faults is not None:
            last_event = self._faults.last_event_tick
            tick = int(carry.t)
        state = {"carry": carry, "done": self._all_done(carry), "tick": tick}

        def chunk() -> None:
            carry, done, tick = state["carry"], state["done"], state["tick"]
            flushed = False
            if blocks is not None:
                blocks.reset()
            for i in range(self.chunk):
                if done:
                    break  # post-completion ticks are no-ops
                # the chunk's last tick flushes the planes' blocks; the
                # flag's event is recorded behind those copies instead
                last = blocks is not None and i == self.chunk - 1
                carry = self._tick(
                    carry, timer=timer,
                    done_out=(done_out[0], None) if last else done_out,
                    tick=tick, blocks=blocks, row=i,
                )
                if last:
                    carry = blocks.flush(carry, done_out[1])
                    flushed = True
                if cuda:
                    done_out[1].synchronize()
                done = bool(done_out[0])
                if tick is not None:
                    tick += 1
                    done = done and tick > last_event
            if blocks is not None and not flushed:
                # the run ended inside the chunk: its last rows were
                # written after the flag's event
                carry = blocks.flush(carry, done_out[1])
                if cuda:
                    done_out[1].synchronize()
            state.update(carry=carry, done=done, tick=tick)

        setup_secs = 0.0
        while ticks < max_ticks:
            watch = chunk_timeout and chunk_timeout > 0 and (
                ticks >= start_ticks + 2 * self.chunk
            )
            t_chunk = time.perf_counter()
            if watch:
                self._chunk_watched(chunk, ticks, chunk_timeout, cancel, on_stall)
            else:
                with device_context(self.device):
                    chunk()
            carry = state["carry"]
            ticks += self.chunk
            if chunk_sleep_ms > 0:
                time.sleep(chunk_sleep_ms / 1000.0)
            if perf is not None:
                perf.on_chunk(ticks // self.chunk - 1, ticks, self.chunk,
                              time.perf_counter() - t_chunk)
            if nan_guard:
                _check_carry_finite(carry, ticks - self.chunk, ticks)
            if setup_secs == 0.0:
                setup_secs = time.perf_counter() - t0
            if self.telemetry:
                if telemetry_cb is not None:
                    telemetry_cb(blocks.host["tele"].numpy().copy())
                delta = blocks.host["lat_hist"].numpy().astype(np.int64)
                lat_acc += delta
                if lat_hist_cb is not None:
                    lat_hist_cb(delta)
            if self.netmatrix:
                nm_delta = blocks.host["net_mat"].numpy().astype(np.int64)
                nm_acc += nm_delta
                if netmatrix_cb is not None:
                    netmatrix_cb(nm_delta)
            if self.trace is not None and trace_cb is not None:
                trace_cb(blocks.host["trace"].numpy().copy())
            if on_chunk is not None:
                on_chunk(ticks)
            if observer is not None:
                observer(ticks, carry)
            if state["done"]:
                break
            if cancel is not None and cancel.is_set():
                break
        res = self.results(carry, ticks)
        res["compile_secs"] = setup_secs
        if lat_acc is not None:
            # Σ over bins == delivered plan messages (host lanes excluded)
            res["lat_hist"] = lat_acc.tolist()
        if nm_acc is not None:
            # per channel, Σ cells == the flow total
            res["net_matrix"] = nm_acc.tolist()
        return res

    def _chunk_watched(self, chunk, ticks: int, timeout: float, cancel,
                       on_stall) -> None:
        """Run one chunk under the wall-clock watchdog
        (``engine.py:1885-1924``): the chunk runs in a daemon thread joined
        with ``timeout``; on expiry ``cancel`` is set, ``on_stall`` fires
        and :class:`SimStallError` releases the caller — the abandoned
        thread dies with the process."""
        box: dict[str, Any] = {}
        dev = self.device

        def work():
            try:
                with device_context(dev):
                    chunk()
            except BaseException as e:  # noqa: BLE001 — re-raised below
                box["err"] = e

        th = threading.Thread(target=work, daemon=True, name="sim-chunk-dispatch")
        th.start()
        th.join(timeout)
        if th.is_alive():
            chunk_index = ticks // self.chunk
            if cancel is not None:
                cancel.set()
            if on_stall is not None:
                try:
                    on_stall(ticks, chunk_index)
                except Exception:  # noqa: BLE001 — diagnostics only
                    pass
            raise SimStallError(ticks, chunk_index, timeout)
        if "err" in box:
            raise box["err"]

    def virtual_groups(self) -> tuple[GroupSpec, ...]:
        """The exact (virtual) group layout of a padded program as Python
        ints (``engine.py:2156-2176``); ``groups`` itself without padding."""
        if self.live_counts is None:
            return self.groups
        out, off = [], 0
        for g, lv in zip(self.groups, self.live_counts):
            out.append(dataclasses.replace(g, offset=off, count=int(lv)))
            off += int(lv)
        return tuple(out)

    def results(self, carry: SimCarry, ticks: int,
                carry_bytes: int | None = None) -> dict[str, Any]:
        """The run's results from ``carry`` after ``ticks``. ``carry_bytes``
        (a run pack's member, whose carry holds only the leaves read here)
        replaces the carry's footprint."""

        from .distributed import to_host as host

        status = host(carry.status[: self.n])
        finished_at = host(carry.finished_at[: self.n])
        states = tuple({k: host(v) for k, v in s.items()} for s in carry.states)
        if carry_bytes is None:
            carry_bytes = self.footprint(carry)
        if self.live_counts is not None:
            # a padded run: demux to the exact layout (engine.py:2187-2225);
            # no caller ever sees a dead lane
            keep = self._virt.live
            status, finished_at = status[keep], finished_at[keep]
            states = tuple(
                {k: v[: int(lv)] for k, v in st.items()}
                for st, lv in zip(states, self.live_counts)
            )
        return {
            "ticks": ticks,
            "tick_ms": self.tick_ms,
            "sync_counts": host(carry.sync.counts),
            "pub_dropped": host(carry.sync.dropped),
            "latency_clamped": int(carry.clamped),
            "bw_queue_dropped": int(carry.bw_dropped),
            "bw_rate_change_backlogged": int(carry.bw_rate_changed),
            "collisions": int(carry.collisions),
            "collision_where": host(carry.collision_where).tolist(),
            "msgs_delivered": int(carry.msgs_delivered),
            "msgs_sent": int(carry.msgs_sent),
            "msgs_enqueued": int(carry.msgs_enqueued),
            "msgs_dropped": int(carry.msgs_dropped),
            "msgs_rejected": int(carry.msgs_rejected),
            "cal_depth": int(carry.cal_depth),
            "faults_crashed": int(carry.faults_crashed),
            "faults_restarted": int(carry.faults_restarted),
            "fault_dropped": int(carry.fault_dropped),
            **(
                {"net_bw_hiwater": host(carry.net_bw_hiwater).tolist()}
                if carry.net_bw_hiwater is not None
                else {}
            ),
            "carry_bytes": carry_bytes,
            # host lanes are internal plumbing — plan instances only
            "status": status,
            "finished_at": finished_at,
            "states": states,
            "groups": self.virtual_groups(),
        }


class _Virtual:
    """The exact (virtual) layout of a padded program — its maps to and
    from the physical lanes, all static, so each is built once per
    program and each tick pays one gather a map (the reference rebuilds
    them from the carry's traced counts every tick, ``engine.py:636-817``).

    Lane ids: the live lanes of group g are the first ``live_counts[g]``
    of its physical span, then the dead ones; the host lanes follow the
    instances in both layouts (``ln + h`` virtual, ``n + h`` physical)."""

    def __init__(self, prog: SimProgram):
        groups, lc = prog.groups, np.asarray(prog.live_counts, np.int64)
        h, n = len(prog.hosts), prog.n
        self.voff = np.concatenate([[0], np.cumsum(lc)]).astype(np.int64)
        self.ln = int(self.voff[-1])
        self.n_vlanes = self.ln + h
        gseq = np.concatenate([np.arange(g.count) for g in groups])
        gi = np.repeat(np.arange(len(groups)), [g.count for g in groups])
        live = gseq < lc[gi]
        vid = self.voff[gi] + gseq
        hosts_p = n + np.arange(h)
        self.live = live
        # virtual lane → physical, then one past the lanes (a destination
        # past the virtual ones stays past the physical ones) and -1
        self.dst_np = np.concatenate(
            [np.flatnonzero(live), hosts_p, [n + h, -1]]).astype(np.int32)
        # physical sender → virtual (a dead lane never sends), then -1 for
        # the empty slot's src = -1 (a negative index reads the last entry)
        self.src_np = np.concatenate(
            [np.where(live, vid, self.n_vlanes + np.arange(n)),
             self.ln + np.arange(h), [-1]]).astype(np.int32)
        # the keys: live lane v hashes counter v, as in the exact run's
        # split; the dead lanes take the counters from ln up
        self.key_np = np.where(live, vid, self.ln + np.cumsum(~live) - 1).astype(np.int64)
        # the shaping dice's message source (net.enqueue ``dice_idx``,
        # engine.py:750-784): live and host lanes their virtual ids, dead
        # lanes ids past the virtual lanes; message o·lanes + src hashes
        # o·n_vlanes + its source's, its index in the exact run's outbox
        self.dice_np = np.concatenate(
            [np.where(live, vid, self.n_vlanes + np.arange(n)),
             self.ln + np.arange(h)]).astype(np.int32)

    def built(self, prog: SimProgram, dev) -> "_Virtual":
        """A copy with the device tables and the plan-facing values on
        ``dev``: under bucketing the counts, offsets and ``global_seq`` as
        0-d / [n_g] int32 tensors (the reference's traced scalars), under
        the mesh padding alone as the exact layout's Python ints."""
        out = copy.copy(self)
        out.dst_tbl = torch.from_numpy(self.dst_np).to(dev)
        out.src_tbl = torch.from_numpy(self.src_np).to(dev)
        out.key_ctr = torch.from_numpy(self.key_np).to(dev)
        # the dead lanes' mask and the carry's live_counts leaf: built here
        # so that init_carry copies nothing from the host (a wait on a card)
        out.dead = torch.from_numpy(~self.live).to(dev)
        out.live_counts = torch.tensor(prog.live_counts, dtype=torch.int32, device=dev)
        # the outbox's rows (grown to the echo slots with hosts)
        cls = type(prog.tc)
        rows = max(cls.OUT_MSGS, cls.IN_MSGS) if prog.hosts else cls.OUT_MSGS
        o = np.arange(rows, dtype=np.int64)[:, None]
        out.dice_idx = torch.from_numpy(
            (o * self.n_vlanes + self.dice_np[None, :]).reshape(-1).astype(np.int32)
        ).to(dev)
        groups = prog.groups
        lc = prog.live_counts
        if prog.bucketed:
            both = torch.tensor(
                [self.ln, *lc, *self.voff[:-1].tolist()], dtype=torch.int32, device=dev
            )
            g_n = len(groups)
            out.test_instance_count = both[0]
            counts, offs = both[1 : 1 + g_n], both[1 + g_n :]
            out.groups = tuple(
                dataclasses.replace(g, count=counts[i], offset=offs[i])
                for i, g in enumerate(groups)
            )
            out.global_seq = [offs[i] + prog._gseq[i] for i in range(g_n)]
        else:
            out.test_instance_count = self.ln
            out.groups = tuple(
                dataclasses.replace(g, count=int(c), offset=int(o))
                for g, c, o in zip(groups, lc, self.voff[:-1].tolist())
            )
            out.global_seq = [
                s + int(o) for s, o in zip(prog._gseq, self.voff[:-1].tolist())
            ]
        return out

    def dst(self, dst: torch.Tensor) -> torch.Tensor:
        """Plan-emitted virtual destinations → physical lanes; one past the
        virtual lanes and below 0 stay out of range (``_translate_dst``)."""
        return self.dst_tbl[dst.clamp(-1, self.n_vlanes)]

    def src(self, src: torch.Tensor) -> torch.Tensor:
        """Delivered physical provenance → virtual (``_translate_src``)."""
        return self.src_tbl[src]



class LaneExport:
    """A mesh-padded program's snapshot leaves in the caller's layout: the
    dead lanes at the end of the last group are taken out of every leaf
    with a lane axis on the way out (:meth:`take`), and put back from a
    fresh carry of the program on the way in (:meth:`put`) — a dead lane
    never changes after tick 0. The leaves are the exchange format's
    (``sim/carry_io.py``; calendar planes ``[L, SLOTS·N]`` or flat), so a
    snapshot has the shapes of the reference's meshed run, whose padding
    is internal too. The senders the calendar records past the instances
    (the host lanes) shift with the cut."""

    def __init__(self, prog: SimProgram):
        self.pad = prog.mesh_pad
        self.n = prog.n
        self.n_exp = prog.n - self.pad
        self.slots = type(prog.tc).IN_MSGS
        h = len(prog.hosts)
        self.last = len(prog.groups) - 1
        keep = {
            "lanes": np.concatenate([np.arange(self.n_exp), self.n + np.arange(h)]),
            "inst": np.arange(self.n_exp),
            "group": np.arange(prog.groups[-1].count - self.pad),
        }
        self._keep = keep
        self.lanes = self.n + h  # the physical lane axis

    _AXES = {
        "status": ("lanes", 0), "finished_at": ("lanes", 0), "rejected": ("lanes", 0),
        "link.region_of": ("lanes", 0), "link.backlog": ("lanes", 0),
        "link.egress": ("lanes", 1), "link.filters": ("lanes", 1),
        "link.rules": ("lanes", 2), "sync.last_seq": ("inst", 1),
        "sync.cursors": ("inst", 1), "keys": ("inst", 0),
    }

    def _axis(self, path: str):
        if path.startswith("cal."):
            return "lanes", 2
        if path.startswith("states."):
            return ("group", 0) if int(path.split(".")[1]) == self.last else None
        return self._AXES.get(path)

    def _view(self, path: str, data: np.ndarray) -> np.ndarray:
        if path.startswith("cal."):
            return data.reshape(-1, self.slots, self.lanes)
        return data

    def shape(self, path: str, shape: list) -> list:
        """The exported leaf's shape for the program's leaf ``shape``."""
        ax = self._axis(path)
        out = list(shape)
        if ax is not None:
            kept = len(self._keep[ax[0]])
            if path.startswith("cal."):
                out[-1] = out[-1] // self.lanes * kept
            else:
                out[ax[1]] = kept
        return out

    def dead_bytes(self, carry: SimCarry) -> int:
        """The footprint bytes (:func:`carry_footprint`) the dead lanes
        hold: each leaf's, as the reference stores it, past its exported
        shape."""
        from .checkpoint import _expected, leaf_paths

        out = 0
        for path in leaf_paths(carry):
            if self._axis(path) is None:
                continue
            meta = _expected(carry, path, flat=False)
            cut = math.prod(meta["shape"]) - math.prod(self.shape(path, meta["shape"]))
            out += cut * np.dtype(meta["dtype"]).itemsize
        return out

    def take(self, path: str, data: np.ndarray) -> np.ndarray:
        ax = self._axis(path)
        if ax is None:
            return data
        out = np.take(self._view(path, data), self._keep[ax[0]], axis=ax[1])
        if path == "cal.src":
            out = np.where(out > self.n_exp, out - self.pad, out).astype(out.dtype)
        if path.startswith("cal."):
            out = out.reshape(data.shape[0], -1) if data.ndim == 2 else out.reshape(-1)
        return np.ascontiguousarray(out)

    def put(self, path: str, template: np.ndarray, data: np.ndarray) -> np.ndarray:
        ax = self._axis(path)
        if ax is None:
            return data
        out = np.array(self._view(path, template))
        if path.startswith("cal."):
            lanes = len(self._keep["lanes"])
            data = data.reshape(out.shape[0], self.slots, lanes)
            if path == "cal.src":
                data = np.where(data > self.n_exp, data + self.pad, data).astype(data.dtype)
        idx = [slice(None)] * out.ndim
        idx[ax[1]] = self._keep[ax[0]]
        out[tuple(idx)] = data
        return out.reshape(template.shape)


class _Blocks:
    """The observability planes' per-chunk buffers: the device blocks the
    tick writes its rows into (``tele`` [chunk, K], ``trace`` [chunk, R,
    5]; -1 until written), and the host buffers (pinned on CUDA) that a
    chunk's flush copies them to, with the chunk's histogram and matrix
    deltas."""

    def __init__(self, prog: SimProgram, cuda: bool):
        dev, chunk = prog.device, prog.chunk
        i32 = torch.int32
        shapes = {}
        if prog.telemetry:
            shapes["tele"] = (chunk, prog._tele_k)
            shapes["lat_hist"] = (len(prog.groups), LATENCY_BINS)
        if prog.netmatrix:
            shapes["net_mat"] = (NM_CHANNELS, prog._nm_gh, prog._nm_gh)
        if prog.trace is not None:
            shapes["trace"] = (chunk, prog._trace_nrows, 5)
        self.tele = (
            torch.empty(shapes["tele"], dtype=i32, device=dev) if "tele" in shapes else None
        )
        self.trace = (
            torch.empty(shapes["trace"], dtype=i32, device=dev)
            if "trace" in shapes
            else None
        )
        self.cuda = cuda
        self.host = {
            k: torch.empty(v, dtype=i32, pin_memory=cuda) for k, v in shapes.items()
        }

    def reset(self) -> None:
        """Rows of ticks that never run (after global completion) stay -1."""
        for b in (self.tele, self.trace):
            if b is not None:
                b.fill_(-1)

    def flush(self, carry: SimCarry, event) -> SimCarry:
        """Queue the copies of the blocks and of the histogram and matrix
        deltas to the host, zero the deltas in the carry, and record
        ``event`` (a CUDA event, or None) behind the copies."""
        src = {"tele": self.tele, "trace": self.trace, "lat_hist": carry.lat_hist,
               "net_mat": carry.net_mat}
        for k, h in self.host.items():
            h.copy_(src[k], non_blocking=self.cuda)
        carry = dataclasses.replace(
            carry,
            lat_hist=None if carry.lat_hist is None else torch.zeros_like(carry.lat_hist),
            net_mat=None if carry.net_mat is None else torch.zeros_like(carry.net_mat),
        )
        if event is not None:
            event.record()
        return carry


def _emits(out: dict, name: str, lead: tuple) -> bool:
    """Whether a group's normalized step output carries reconfiguration
    plane ``name`` with leading shape ``lead``."""
    x = out[name]
    return x is not None and tuple(x.shape[: len(lead)]) == lead


def _check_declarations(cls, hosts=()) -> None:
    """The reference's static refusals of incompatible plan declarations
    (``engine.py:504-573``), with its messages."""
    shaping = cls.SHAPING
    if "filter_rules" in shaping:
        if "filters" in shaping:
            raise ValueError(
                "declare either 'filters' (dense per-dst-region table) or "
                "'filter_rules' (per-instance range-rule lists), not both — "
                "two granularity models for the same Accept/Reject/Drop "
                "semantics"
            )
        if cls.FILTER_RULES <= 0:
            raise ValueError(
                "'filter_rules' shaping needs FILTER_RULES > 0 (the max "
                "rules per instance)"
            )
    if "bandwidth_queue" in shaping:
        if "bandwidth" in shaping:
            raise ValueError(
                "declare either 'bandwidth' (admission-cap drop) or "
                "'bandwidth_queue' (HTB queueing), not both — they are two "
                "semantics for the same LinkShape knob"
            )
        if cls.SLOT_MODE == "direct":
            raise ValueError(
                "bandwidth_queue is incompatible with SLOT_MODE='direct': "
                "queue deferral makes two sends from one outbox slot land "
                "on the same (receiver, slot, tick) and silently collide"
            )
        if "duplicate" in shaping:
            raise ValueError(
                "bandwidth_queue is incompatible with duplicate shaping: "
                "second copies would bypass the egress queue (tc shapes "
                "netem duplicates through the HTB class; the transport "
                "creates copies after queue metering) — PARITY BOUND, use "
                "admission-cap 'bandwidth' with duplicate instead"
            )
    if not cls.CROSS_TICK_STACKING:
        for feat, why in (
            ("duplicate", "second copies land one tick later"),
            ("jitter", "per-message delay varies with the jitter draw"),
            ("reorder", "reordered messages jump to the 1-tick floor"),
            (
                "bandwidth_queue",
                "queued messages defer by a backlog-dependent delay",
            ),
        ):
            if feat in shaping:
                raise ValueError(
                    f"CROSS_TICK_STACKING=False is incompatible with {feat} "
                    f"shaping ({why}, so one calendar bucket fills from "
                    "multiple send ticks)"
                )
        if hosts:
            raise ValueError(
                "CROSS_TICK_STACKING=False is incompatible with "
                "additional_hosts (control lanes ride the 1-tick floor "
                "while plan traffic rides the shaped latency)"
            )
    if hosts:
        if not cls.TRACK_SRC:
            raise ValueError(
                "additional_hosts need TRACK_SRC=True (the echo replies "
                "to the inbox src)"
            )
        if cls.SLOT_MODE == "direct":
            raise ValueError(
                "additional_hosts need SLOT_MODE='sorted' (host fan-in "
                "violates the direct mode contract)"
            )


def carry_footprint(carry: SimCarry) -> int:
    """The reference's footprint of ``carry``: the bytes of every tensor
    leaf, with the per-instance keys counted as the reference stores them
    (uint32 pairs, 8 B a lane, where the port holds each word in int64)
    and 8 B for the link key, which the port keeps on the host."""
    return carry_bytes(carry) - carry.keys.numel() * 4 + 8


def carry_digest(carry: SimCarry) -> int:
    """The sum, as int64, of every byte of every leaf of ``carry`` but the
    calendar's planes (a cohort process holds only its own shards of
    those): every member of a cohort holds the same replica, so every
    member reads the same digest."""
    total = 0

    def add(x):
        nonlocal total
        if isinstance(x, torch.Tensor):
            flat = x.detach().contiguous().view(-1).view(torch.uint8)
            for lo in range(0, flat.numel(), 1 << 26):
                total += int(flat[lo : lo + (1 << 26)].sum(dtype=torch.int64))
        elif isinstance(x, dict):
            for v in x.values():
                add(v)
        elif isinstance(x, (tuple, list)):
            for v in x:
                add(v)
        elif dataclasses.is_dataclass(x) and not isinstance(x, Calendar):
            for f in dataclasses.fields(x):
                add(getattr(x, f.name))

    add(carry)
    return total


def carry_bytes(carry: SimCarry) -> int:
    """Device-resident bytes of the carry's tensors."""
    total = 0

    def add(x):
        nonlocal total
        if isinstance(x, torch.Tensor):
            total += x.numel() * x.element_size()
        elif isinstance(x, dict):
            for v in x.values():
                add(v)
        elif isinstance(x, (tuple, list)):
            for v in x:
                add(v)
        elif dataclasses.is_dataclass(x):
            for f in dataclasses.fields(x):
                add(getattr(x, f.name))

    add(carry)
    return total
