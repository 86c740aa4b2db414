"""Run packs on one card: several compatible runs stepped as ONE program
over a run axis — the port of ``testground_tpu/sim/pack.py``.

A small run on the card is launch-bound: a tick issues a few hundred
small kernels whatever the lane count. A pack of R runs issues about the
same kernels for all R at once, each over R times the lanes. The
reference lifts its jitted tick over the run axis with ``jax.vmap``; the
port's tick is eager and launches K1 and K2 through ``ctypes``, which no
``torch.func.vmap`` passes through, so the run axis is laid out by hand:

- **Lanes.** The R members share one padded layout of N lanes (the
  admission key guarantees it: same plan, case, parameters and bucket).
  The pack's lane axis is ``[R·N]``, run-major: member r owns lanes
  ``[r·N, (r+1)·N)``. Every per-lane leaf (status, keys, link state, the
  calendar's positions ``slot·R·N + lane``, sync cursors and sequence
  numbers) is the isolated run's, laid side by side. A member's lanes
  never message another member's, so the stable sort of the one
  calendar commit gives every destination the ranks its own run gives
  it, and K1 and K2 run once a tick for the whole pack.
- **Run-axis leaves.** What a run holds once gets a leading ``[R]`` axis:
  sync counters and topic streams, the flow totals, the histogram, and
  the link-model keys, which advance on the host for all R at once and
  reach the device as one ``[chunk, R]`` table of hash salts a chunk.
  ``net.enqueue(runs=R)`` and ``sync_kernel.update_sync(runs=R)`` fold
  per run with one launch per op.
- **The plan step** runs under one vmap level over the members
  (``torch.func.vmap``'s machinery, called without its wrapper's pytree
  walks), so each member sees its own env (its seed's keys and,
  bucketed, its own exact counts as 0-d tensors), as in the reference's
  vmap, and the plans stay as they are. The vmap fallback (a per-member
  loop for an op without a batching rule) is switched off around the
  step: such an op raises instead of multiplying the step's launches by
  R.
- **Virtual ids.** Each bucketed member has its own live counts, so its
  own destination, sender and dice maps; the pack concatenates them
  into one table each, and a tick pays one gather a map as a solo
  bucketed run does.

**On a mesh** (``PackRunner(prog, width, mesh=)``, 1-D or 2-D ``"RxP"``)
the program stays unmeshed, as the reference's inner program does. On a
mesh of one part only the pack's calendar is split: one sub-shard of
``n_loc = N / P`` lanes for each (member, peer shard), in the pack's lane
order — sub-shard ``r·P + s`` holds member r's lanes ``[s·n_loc,
(s+1)·n_loc)`` (:func:`sub_shard_mesh`). So the pack's calendar is the
sharded calendar of ``sim/net.py`` over ``W·P`` shards, with its
shard-major sort key, its sharded K1 and K2 (one launch a tick) and its pop
straight into the step's run-major lanes; every other leaf stays on the
mesh's primary device. A member whose lanes do not divide across the peer
shards is padded with the solo meshed run's dead lanes
(``SimProgram(lane_multiple=P)``).

**On a mesh of several parts** (several cards, explicit ``parts``, or the
rows of a 2-D mesh, which are parts even on one device) the pack is placed,
as the reference's ``constrain_carry(carry, meshplan, lead="runs")``
places its stacked carry: the members split into the rows in contiguous
groups, and the part holding cells ``[s0, s1)`` of row g owns its row's
members' lanes ``[s0·n_loc, s1·n_loc)`` (``meshplan.pack_parts``) of every
leaf ``MeshPlan.lane_axis`` names — the status rows, the link state, the
plan states, the keys, the sync cursors and sequence numbers — laid out
member-major (``[R_g, lanes_p]``), and its sub-shards of the calendar, in
one tensor: the calendar's sub-shards go owner by owner, so an owner's
lanes are one span. The
run-axis leaves (the counters, the sync counts and streams, the histogram)
are replicated on every part. Each part steps its own block on a host
thread of its own (``engine.on_parts``), its members' plan step vmapped
over ``[R_g, lanes_p]`` with the groups' own spans, as a cohort's ranks
step theirs; the parts meet at the tick's collectives
(``distributed.PartGroup``): ``net.enqueue`` hands each message to its
destination's part (its dice hashing its member's own run's index, ties
in its commit broken by its place in its member's own order, so the
survivors are the one-part pack's), and one gather a tick sums every
part's per-run counts, sync totals, RUNNING instances and histogram delta,
so the replicas stay equal and the sync fold numbers and appends each
run's signals and publishes after the lower parts'. A member's done flag is
the summed RUNNING count; its snapshot gathers its lanes from every part
(a collective at the tick its flag rises). A part whose row holds no member
holds nothing. Every result is the one-part pack's, bit for bit.

**Stragglers and freezes.** The host reads the R done flags of a tick in
one copy. A member whose flag rises is snapshotted right after that tick
(the leaves its results read, and its histogram delta since the chunk's
flush): its lanes are all terminal and send nothing, but in-flight
messages still arrive, so its later counters move on the device and are
never read. Its telemetry rows after its finish are masked to -1 on the
host, as the isolated run pads them. A member whose own budget ends, or
that is canceled (operator kill, fail-severity SLO, preemption), is
snapshotted at the chunk boundary where that is seen, as in the
reference. Dead dummy runs fill the width to a power of two: all CRASH
from tick 0, they send nothing and receive nothing.

Every member's result equals its isolated run's, bit for bit: status,
finished_at, every state leaf, the flow totals, the sync counters, the
telemetry rows and the latency histogram.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch
from torch._C._functorch import (
    _add_batch_dim,
    _remove_batch_dim,
    _vmap_decrement_nesting,
    _vmap_increment_nesting,
)

from .api import CRASH, RUNNING, Inbox
from .meshplan import TorchMesh, _indexed, pack_parts, plan_for
from .engine import (
    SimCarry,
    _NoHostReads,
    _Virtual,
    carry_bytes,
    device_context,
    on_parts,
)
from .net import (
    BANDWIDTH,
    MSG_BYTES,
    Calendar,
    LinkState,
    RunLanes,
    apply_net_updates,
    deliver,
    enqueue,
    latency_histogram,
)
from .sync_kernel import RankTotals, SyncState, live_per_group, update_sync
from .telemetry import LATENCY_BINS

__all__ = [
    "PACK_MIN_MEMBERS",
    "PackMember",
    "PackRunner",
    "pack_width",
    "sub_shard_mesh",
]

# a pack of one is just a run — the admission layer never builds one
PACK_MIN_MEMBERS = 2

# the carry's per-run counters: [R] (collision_where [R, 2]) in a pack
_RUN_COUNTERS = ("clamped", "bw_dropped", "bw_rate_changed", "collisions",
                 "collision_where", "msgs_delivered", "msgs_sent", "msgs_enqueued",
                 "msgs_dropped", "msgs_rejected", "cal_depth", "faults_crashed",
                 "faults_restarted", "fault_dropped")


def pack_width(members: int, pack_max: int) -> int:
    """Canonical run-axis width: the smallest power of two holding
    ``members``, clamped to ``pack_max`` (the reference's ladder of
    widths)."""
    members = max(1, int(members))
    w = 1
    while w < members:
        w *= 2
    return max(PACK_MIN_MEMBERS, min(w, max(int(pack_max), members)))


@dataclasses.dataclass
class PackMember:
    """One run riding the pack: its runtime inputs and host-side hooks.
    Callbacks mirror ``SimProgram.run``'s, already demuxed to this
    member's slice."""

    seed: int
    live_counts: tuple | None = None  # exact per-group counts (bucketed)
    max_ticks: int = 10_000
    telemetry_cb: Callable | None = None
    lat_hist_cb: Callable | None = None
    on_chunk: Callable | None = None  # on_chunk(ticks)
    # polled each chunk: True stops THIS member (operator cancel, an SLO
    # fail or a preemption) — the pack continues for everyone else
    cancel_check: Callable[[], bool] | None = None
    perf: Any = None  # PerfLedger hook (on_chunk only)

    # --- filled by PackRunner.run
    ticks: int = 0
    canceled: bool = False
    done: bool = False


@contextlib.contextmanager
def no_vmap_fallback():
    """Make an op without a vmap batching rule raise, instead of running
    once per member (which would multiply the plan step's launches)."""
    fn = torch._C._functorch
    fn._set_vmap_fallback_enabled(False)
    try:
        yield
    finally:
        fn._set_vmap_fallback_enabled(True)


_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_SPLIT_CTR = np.asarray([0, 1], np.uint32)


def _threefry_u32(k0, k1, x0, x1):
    """``prng.threefry2x32`` over numpy uint32 arrays, whose arithmetic
    wraps as the masked int64 one does: one ufunc an operation for every
    run at once."""
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    a = x0 + ks[0]
    b = x1 + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = a + b
            b = ((b << np.uint32(r)) | (b >> np.uint32(32 - r))) ^ a
        a = a + ks[(i + 1) % 3]
        b = b + ks[(i + 2) % 3] + np.uint32(i + 1)
    return a, b


def _split_salts(k0: np.ndarray, k1: np.ndarray, ticks: int):
    """Advance R link keys ``ticks`` times on the host, vectorised over the
    runs (``prng.split_host`` per run and tick, both counters in one
    evaluation): returns the ``[ticks, R]`` int64 hash salts of the
    per-tick message keys (``net._hash_salt``) and the keys (uint32)
    after the last tick."""
    k0 = np.asarray(k0, np.uint32)[:, None]
    k1 = np.asarray(k1, np.uint32)[:, None]
    salts = np.empty((ticks, k0.shape[0]), np.int64)
    with np.errstate(over="ignore"):
        for i in range(ticks):
            a, b = _threefry_u32(k0, k1, np.uint32(0), _SPLIT_CTR)
            salts[i] = a[:, 1] ^ (b[:, 1] * np.uint32(0x9E3779B9))
            k0, k1 = a[:, :1], b[:, :1]
    return salts, k0[:, 0], k1[:, 0]


def sub_shard_mesh(mesh, width: int):
    """The calendar mesh of a pack of ``width`` members on ``mesh``: one
    sub-shard of ``n_loc`` lanes for each (member, peer shard), in the
    pack's lane order, so sub-shard ``r·P + s`` holds member r's lanes
    ``[s·n_loc, (s+1)·n_loc)``. On a 2-D mesh of Rm rows the members split
    into Rm contiguous groups of ``ceil(width / Rm)`` (the reference's
    run-axis sharding, uneven where Rm does not divide the width), and
    member r's sub-shards sit on its group's row. Consecutive sub-shards
    on one device form one part; a mesh cut into parts by hand keeps its
    cuts in every member."""
    rows = mesh.shape.get("runs", 1)
    per_row = -(-width // rows)
    devs, parts, cut = [], [], False
    for r in range(width):
        row = mesh.row(r // per_row)
        cut = cut or row.parts != TorchMesh(row.devices).parts
        base = len(devs)
        devs.extend(row.devices)
        parts.extend((d, base + a, base + b) for d, a, b in row.parts)
    return TorchMesh(tuple(devs), parts=tuple(parts) if cut else None)


class _BatchedVirt:
    """The exact layout a bucketed member's plan sees, built inside the
    vmapped step from the member's row of the pack's count table:
    ``test_instance_count``, the groups' counts and offsets and
    ``global_seq`` as the member's 0-d / ``[n_g]`` tensors."""

    def __init__(self, both, prog):
        g_n = len(prog.groups)
        self.test_instance_count = both[0]
        counts, offs = both[1 : 1 + g_n], both[1 + g_n :]
        self.groups = tuple(
            dataclasses.replace(g, count=counts[i], offset=offs[i])
            for i, g in enumerate(prog.groups)
        )
        self.global_seq = [offs[i] + prog._gseq[i] for i in range(g_n)]


@dataclasses.dataclass(eq=False)
class _Layout:
    """What one stepper of a pack holds and its static maps: the whole
    pack, or one part of a mesh of several parts (``part`` set). It steps
    members ``[first, first + runs)`` and ``n`` lanes of each, member-major
    (the whole pack: run-major, every lane)."""

    runs: int
    n: int
    first: int
    device: Any
    view: Any  # the plan step's program
    group_of: torch.Tensor  # [n] the held lanes' groups
    lat_group_of: torch.Tensor  # [runs·n] the histogram's row of each lane
    dst_tbl: torch.Tensor
    dst_base: torch.Tensor
    nv_max: int
    src_tbl: torch.Tensor
    dice_idx: torch.Tensor
    msg_run: torch.Tensor
    both: torch.Tensor | None
    first_step: bool
    out_keys: list | None = None
    # a part of several: its index, its view of the calendar's mesh, where
    # the calendar's lanes lie, and the RUNNING instances per (run, group)
    # after the last tick (what the plans see as ``sync.live``)
    part: int | None = None
    mesh: Any = None
    run_lanes: RunLanes | None = None
    live: torch.Tensor | None = None

    @property
    def lanes(self) -> int:
        return self.runs * self.n


class _PackBlocks:
    """The pack's per-chunk telemetry buffers: the device block ``[chunk,
    R, K]`` (-1 until written) and the pinned host copies of it and of the
    chunk's ``[R, G, LATENCY_BINS]`` histogram delta."""

    def __init__(self, runner: "PackRunner", cuda: bool):
        prog = runner.prog
        shape = (prog.chunk, runner.width, prog._tele_k)
        self.tele = torch.empty(shape, dtype=torch.int32, device=prog.device)
        self.cuda = cuda
        self.host = {
            "tele": torch.empty(shape, dtype=torch.int32, pin_memory=cuda),
            "lat_hist": torch.empty(
                (runner.width, len(prog.groups), LATENCY_BINS), dtype=torch.int32,
                pin_memory=cuda),
        }

    def reset(self) -> None:
        self.tele.fill_(-1)

    def flush(self, carry: SimCarry, event) -> SimCarry:
        self.host["tele"].copy_(self.tele, non_blocking=self.cuda)
        self.host["lat_hist"].copy_(carry.lat_hist, non_blocking=self.cuda)
        carry = dataclasses.replace(carry, lat_hist=torch.zeros_like(carry.lat_hist))
        if event is not None:
            event.record()
        return carry


# the carry's leaves a placed pack splits by lane, and their lane axis in a
# member's own carry (the plan states: their group's lanes, axis 0), as
# ``MeshPlan.lane_axis`` places them
_LANE_LEAVES = (("status", -1), ("finished_at", -1), ("rejected", -1), ("keys", 0),
                ("link.egress", -1), ("link.filters", -1), ("link.region_of", -1),
                ("link.backlog", -1), ("link.rules", -1), ("sync.last_seq", -1),
                ("sync.cursors", -1))


# the leaves a pack stacks on its run axis, every part holding each whole
_RUN_LEAVES = (*_RUN_COUNTERS, "sync.counts", "sync.stream", "sync.stream_len",
               "sync.dropped", "lat_hist", "live_counts")


def _get(carry, path):
    obj = carry
    for name in path.split("."):
        obj = getattr(obj, name)
    return obj


class PackRunner:
    """R compatible runs over ONE :class:`~.engine.SimProgram` (``prog``,
    the members' shared padded layout), stepped as one program over a run
    axis of ``width`` members (dead dummies past the live ones).

    The program must be trace-free, fault-free, host-free and matrix-free
    (the admission key guarantees it). ``prog.live_counts`` decides
    whether members carry per-run exact counts (shape bucketing) — when
    set, every member's ``live_counts`` must be provided.

    On a mesh of several parts (``mesh.parts``: several cards, explicit
    cuts, or the rows of a 2-D mesh) the pack is placed (``parts``, from
    ``meshplan.pack_parts``): each part holds its members' own lanes of
    every leaf ``MeshPlan.lane_axis`` names, member-major, and its
    sub-shards of the calendar, and a replica of every run-axis leaf; it
    steps them on a host thread of its own, the parts meeting at the
    tick's collectives (``distributed.PartGroup``)."""

    def __init__(self, prog, width: int, mesh=None, transport: str = "xla"):
        self.prog = prog
        self.width = int(width)
        if prog.trace is not None or prog.faults is not None:
            raise ValueError(
                "run packing requires a trace-free, fault-free program "
                "(pack admission must refuse these compositions)"
            )
        if prog.hosts or prog.netmatrix:
            raise ValueError(
                "run packing requires a program without additional hosts "
                "or the traffic matrix (pack admission must refuse these "
                "compositions)"
            )
        if prog.mesh is not None:
            raise ValueError(
                "the pack's inner program must be built unmeshed "
                "(mesh=None): PackRunner places the stacked carry "
                "through the rule table outside the vmap — pass the "
                "mesh to PackRunner instead"
            )
        self.meshplan = plan_for(mesh)
        if self.meshplan is not None and str(transport).lower() == "pallas":
            raise ValueError(
                "a packed mesh run cannot use transport=pallas (the "
                "vmapped single-device kernels do not partition over "
                "the mesh; the shard_map variant is the solo path) — "
                "the transport gate resolves this to xla"
            )
        self.cls = type(prog.tc)
        self.n = prog.n  # lanes a member holds
        self.lanes = self.width * self.n
        # the calendar's sub-shards on a mesh (None without one), and a
        # mesh of several parts' owners (None: one stepper holds the pack)
        self.cal_mesh = None
        self.parts = None
        if mesh is not None:
            if mesh.primary != _indexed(prog.device):
                raise ValueError(
                    f"the pack's program lives on {prog.device}, not on the "
                    f"mesh's primary device {mesh.primary}: a meshed pack "
                    "builds its carry from there"
                )
            if self.n % mesh.shards:
                raise ValueError(
                    f"a member's {self.n} lanes do not divide across the "
                    f"mesh's {mesh.shards} peer shards"
                )
            if len(mesh.parts) > 1:
                self.parts = pack_parts(mesh, self.width)
                self.n_loc = self.n // mesh.shards
                # the calendar's sub-shards owner by owner, each owner's
                # members one after another, each member's own peer shards
                # in order: an owner's lanes are one span, member-major
                owners = tuple(i for i, q in enumerate(self.parts)
                               for _ in range(q.runs * (q.s1 - q.s0)))
                cells = tuple(self.parts[i].device for i in owners)
                bounds = [i for i in range(1, len(owners)) if owners[i] != owners[i - 1]]
                self._cal_owners = owners
                self.cal_mesh = TorchMesh(cells, parts=tuple(
                    (cells[a], a, b) for a, b in zip([0, *bounds], [*bounds, len(owners)])))
            else:
                self.cal_mesh = sub_shard_mesh(mesh, self.width)
        self._members_cache: dict = {}
        # the plan step's program: the member's virtual layout is set per
        # call (bucketed), and host reads are watched on the first step
        self._view = copy.copy(prog)
        self._view._watch_host_reads = False

    @property
    def placed(self) -> bool:
        """Whether each part of the mesh holds and steps its own lanes."""
        return self.parts is not None

    # ------------------------------------------------------------ members

    def _member_program(self, live_counts):
        """``prog`` with a member's own live counts: its virtual maps,
        keys and dead lanes (the program itself when unbucketed)."""
        prog = self.prog
        if not prog.bucketed:
            return prog
        lc = tuple(int(c) for c in live_counts)
        m = self._members_cache.get(lc)
        if m is None:
            m = copy.copy(prog)
            m.live_counts = lc
            m._virt = _Virtual(m).built(m, prog.device)
            m._carry_bytes = None
            m._watch_host_reads = False
            self._members_cache[lc] = m
        return m

    def _tables(self, mprogs, first, runs, lo, hi, cal_lane, dev, view) -> _Layout:
        """The static maps of a stepper holding members ``[first, first +
        runs)``, lanes ``[lo, hi)`` of each, built once per run: the
        destination, sender and dice tables, each message's run, the lane →
        (run, group) map of the histogram and, bucketed, the members'
        exact-count rows. ``cal_lane[r, l]`` is member r's lane l's lane in
        the calendar."""
        prog, cls = self.prog, self.cls
        r_n, n = self.width, self.n
        i64 = torch.int64
        g_n = len(prog.groups)
        held = hi - lo
        group_of = prog._group_of.to(i64)[lo:hi].to(dev)
        mine = torch.arange(first, first + runs, dtype=i64, device=dev)
        # the histogram's rows: run r's group g is row r·G + g
        lat_group_of = (mine[:, None] * g_n + group_of[None, :]).reshape(-1)
        o = cls.OUT_MSGS
        if prog.live_counts is None:
            nv = [n] * r_n
            phys = [np.arange(n)] * r_n
            src_loc = [np.arange(n)] * r_n
            dice = [np.arange(n)] * r_n
        else:
            nv = [m._virt.n_vlanes for m in mprogs]
            phys = [m._virt.dst_np[: m._virt.n_vlanes] for m in mprogs]
            src_loc = [m._virt.src_np[:n] for m in mprogs]
            dice = [m._virt.dice_np[:n] for m in mprogs]
        # destinations: a member's virtual id v (clamped to [-1, nv_max])
        # reads row r's entry 1 + v; -1 and every id at or past the
        # member's own virtual lanes stay out of range (-1, R·N)
        nv_max = max(nv)
        width = nv_max + 2
        tbl = np.full((runs, width), self.lanes, np.int64)
        tbl[:, 0] = -1
        for k in range(runs):
            r = first + k
            tbl[k, 1 : 1 + nv[r]] = cal_lane[r, np.asarray(phys[r], np.int64)]
        dst_tbl = torch.from_numpy(tbl.reshape(-1).astype(np.int32)).to(dev)
        dst_base = torch.from_numpy(
            np.repeat(np.arange(runs, dtype=np.int64) * width + 1, held).astype(np.int32)
        ).to(dev)
        # delivered senders (calendar lanes) back to each member's ids; the
        # empty slot's src = -1 reads the trailing -1
        src = np.full(self.lanes + 1, -1, np.int64)
        for r in range(r_n):
            src[cal_lane[r]] = np.asarray(src_loc[r], np.int64)
        src_tbl = torch.from_numpy(src.astype(np.int32)).to(dev)
        # message o·R·N + r·N + p hashes the index its member's run hashes
        rows = np.arange(o, dtype=np.int64)[:, None, None]
        d = np.stack([np.asarray(dice[first + k], np.int64)[lo:hi]
                      for k in range(runs)])[None, :, :]
        nvv = np.asarray(nv[first : first + runs], np.int64)[None, :, None]
        dice_idx = torch.from_numpy((rows * nvv + d).reshape(-1).astype(np.int32)).to(dev)
        msg_run = mine.repeat_interleave(held).repeat(o)
        both = None
        if prog.bucketed:
            both = torch.tensor(
                [[m._virt.ln, *m.live_counts, *m._virt.voff[:-1].tolist()]
                 for m in mprogs[first : first + runs]],
                dtype=torch.int32, device=dev)
        return _Layout(runs=runs, n=held, first=first, device=dev, view=view,
                       group_of=group_of, lat_group_of=lat_group_of, dst_tbl=dst_tbl,
                       dst_base=dst_base, nv_max=nv_max, src_tbl=src_tbl,
                       dice_idx=dice_idx, msg_run=msg_run, both=both,
                       first_step=prog.bucketed)

    def _init(self, mprogs, seeds, live_run) -> tuple[SimCarry, int]:
        """Each member's tick-0 carry (its program's ``init_carry``), laid
        side by side; dead dummies all CRASH. Returns the packed carry and
        the isolated carry's footprint."""
        prog, dev = self.prog, self.prog.device
        r_n, n = self.width, self.n
        carries = [m.init_carry(s) for m, s in zip(mprogs, seeds)]
        footprint = mprogs[0].footprint(carries[0])
        c0 = carries[0]

        def lanes(get, dim=-1):
            return torch.cat([get(c) for c in carries], dim=dim)

        def stack(get):
            return torch.stack([get(c) for c in carries])

        status = lanes(lambda c: c.status)
        for r, live in enumerate(live_run):
            if not live:
                status[r * n : (r + 1) * n] = CRASH
        cls = self.cls
        link = c0.link
        out = SimCarry(
            states=tuple(
                {k: stack(lambda c, gi=gi, k=k: c.states[gi][k]) for k in c0.states[gi]}
                for gi in range(len(prog.groups))
            ),
            status=status,
            finished_at=lanes(lambda c: c.finished_at),
            cal=Calendar.empty(
                cls.MAX_LINK_TICKS, self.lanes, cls.IN_MSGS, cls.MSG_WIDTH,
                track_src=cls.TRACK_SRC, track_etick=prog.telemetry, device=dev,
                mesh=self.cal_mesh,
            ),
            link=LinkState(
                egress=lanes(lambda c: c.link.egress),
                filters=lanes(lambda c: c.link.filters),
                region_of=lanes(lambda c: c.link.region_of),
                backlog=None if link.backlog is None else lanes(lambda c: c.link.backlog),
                rules=None if link.rules is None else lanes(lambda c: c.link.rules),
            ),
            sync=SyncState(
                counts=stack(lambda c: c.sync.counts),
                last_seq=lanes(lambda c: c.sync.last_seq),
                stream=stack(lambda c: c.sync.stream),
                stream_len=stack(lambda c: c.sync.stream_len),
                cursors=lanes(lambda c: c.sync.cursors),
                dropped=stack(lambda c: c.sync.dropped),
            ),
            rejected=lanes(lambda c: c.rejected),
            keys=lanes(lambda c: c.keys, dim=0),
            net_key=(
                np.asarray([c.net_key[0] for c in carries], np.uint32),
                np.asarray([c.net_key[1] for c in carries], np.uint32),
            ),
            t=c0.t,
            **{f: stack(lambda c, f=f: getattr(c, f)) for f in _RUN_COUNTERS},
            lat_hist=None if c0.lat_hist is None else stack(lambda c: c.lat_hist),
            live_counts=None if c0.live_counts is None else stack(lambda c: c.live_counts),
        )
        return out, footprint

    def member_carry(self, carry: SimCarry, r: int, clone: bool = False) -> SimCarry:
        """Member ``r``'s slice of the leaves its results read (copies with
        ``clone``: a snapshot the later ticks do not move)."""
        n = self.n

        def take(x):
            return x.clone() if clone else x

        def run(x):
            return take(x[r])

        def lanes(x):
            return take(x.view(self.width, n)[r])

        return SimCarry(
            states=tuple({k: run(v) for k, v in s.items()} for s in carry.states),
            status=lanes(carry.status),
            finished_at=lanes(carry.finished_at),
            cal=None,
            link=None,
            sync=SyncState(counts=run(carry.sync.counts), last_seq=None, stream=None,
                           stream_len=None, cursors=None,
                           dropped=run(carry.sync.dropped)),
            rejected=None,
            keys=None,
            net_key=None,
            t=carry.t,
            **{f: run(getattr(carry, f)) for f in _RUN_COUNTERS},
            lat_hist=None if carry.lat_hist is None else run(carry.lat_hist),
            live_counts=None if carry.live_counts is None else run(carry.live_counts),
        )

    # ------------------------------------------------------------- placed

    def _part_layouts(self, mprogs) -> list[_Layout]:
        """Each part's stepper: its members' lanes member-major, its
        program over its own lanes on its device (the plans step the
        groups' own spans, as a cohort's ranks do), its view of the
        calendar's mesh and where the calendar's lanes lie."""
        from .distributed import PartGroup

        prog, n, n_loc = self.prog, self.n, self.n_loc
        self._group = PartGroup(len(self.parts))
        # member r's lane l in the calendar: owner by owner, member-major
        cal_lane = np.empty((self.width, n), np.int64)
        base = 0
        for q in self.parts:
            held = (q.s1 - q.s0) * n_loc
            for k in range(q.runs):
                cal_lane[q.first + k, q.s0 * n_loc : q.s1 * n_loc] = (
                    base + k * held + np.arange(held))
            base += q.runs * held
        run_of = np.empty(self.lanes, np.int64)
        lane_of = np.empty(self.lanes, np.int64)
        run_of[cal_lane] = np.arange(self.width)[:, None]
        lane_of[cal_lane] = np.arange(n)[None, :]
        lays = []
        for i, q in enumerate(self.parts):
            dev = _indexed(q.device)
            lo, hi = q.s0 * n_loc, q.s1 * n_loc
            view = copy.copy(self._view)
            view.device = dev
            view.placed = True
            view._consts = {}
            view._set_own(lo, hi)
            view._build_layout(dev)
            lay = self._tables(mprogs, q.first, q.runs, lo, hi, cal_lane, dev, view)
            lay.part = i
            lay.mesh = TorchMesh(self.cal_mesh.devices, ranks=self._cal_owners, rank=i,
                                 group=self._group)
            lay.run_lanes = RunLanes(run=torch.from_numpy(run_of).to(dev),
                                     lane=torch.from_numpy(lane_of).to(dev))
            lays.append(lay)
        return lays

    def _init_placed(self, lays, mprogs, seeds, live_run):
        """Each part's tick-0 carry: of each of its members the isolated
        tick-0 carry's own lanes (dead dummies all CRASH), member-major, its
        sub-shards of the calendar, and every member's run-axis leaves.
        One member's whole carry is built at a time. Returns the parts'
        carries, the members' link keys and the isolated footprint."""
        prog, cls = self.prog, self.cls
        held = [[] for _ in lays]
        runs_of: dict = {}
        live, keys0, keys1 = [], [], []
        footprint = None
        for r, (m, seed) in enumerate(zip(mprogs, seeds)):
            c = m.init_carry(seed)
            if footprint is None:
                footprint = m.footprint(c)
            if not live_run[r]:
                c.status.fill_(CRASH)
            live.append(live_per_group(c.status, prog.groups))
            keys0.append(c.net_key[0])
            keys1.append(c.net_key[1])
            for f in _RUN_LEAVES:
                runs_of.setdefault(f, []).append(_get(c, f))
            for i, lay in enumerate(lays):
                if lay.first <= r < lay.first + lay.runs:
                    held[i].append(self._own_lanes(lay, c))
            del c
        live = torch.stack(live)
        out = []
        for lay, mine in zip(lays, held):
            dev = lay.device

            def stack(f, dev=dev):
                xs = runs_of[f]
                return None if xs[0] is None else torch.stack(xs).to(dev)

            def lanes(path, mine=mine, dev=dev):
                xs = [x[path] for x in mine]
                if xs[0] is None:
                    return None
                return torch.cat(xs, dim=0 if path == "keys" else -1).to(dev)

            out.append(SimCarry(
                states=tuple(
                    {k: torch.stack([x["states"][g][k] for x in mine]).to(dev)
                     for k in mine[0]["states"][g]}
                    for g in range(len(prog.groups))),
                status=lanes("status"),
                finished_at=lanes("finished_at"),
                cal=Calendar.empty(
                    cls.MAX_LINK_TICKS, self.lanes, cls.IN_MSGS, cls.MSG_WIDTH,
                    track_src=cls.TRACK_SRC, track_etick=prog.telemetry, device=dev,
                    mesh=lay.mesh),
                link=LinkState(**{f: lanes("link." + f) for f in
                                  ("egress", "filters", "region_of", "backlog", "rules")}),
                sync=SyncState(counts=stack("sync.counts"), last_seq=lanes("sync.last_seq"),
                               stream=stack("sync.stream"),
                               stream_len=stack("sync.stream_len"),
                               cursors=lanes("sync.cursors"),
                               dropped=stack("sync.dropped")),
                rejected=lanes("rejected"),
                keys=lanes("keys"),
                net_key=None,
                t=torch.zeros((), dtype=torch.int32, device=dev),
                **{f: stack(f) for f in _RUN_COUNTERS},
                lat_hist=stack("lat_hist"),
                live_counts=stack("live_counts"),
            ))
            lay.live = live.to(dev)
        net_key = (np.asarray(keys0, np.uint32), np.asarray(keys1, np.uint32))
        return out, net_key, footprint

    def _own_lanes(self, lay, c) -> dict:
        """A part's own lanes of one member's whole carry ``c``."""
        lo, hi = lay.view._lo, lay.view._hi
        out = {}
        for path, axis in _LANE_LEAVES:
            x = _get(c, path)
            out[path] = None if x is None else x.narrow(axis, lo, hi - lo)
        out["states"] = tuple(
            {k: v[sp.start : sp.start + sp.count] for k, v in st.items()}
            for st, sp in zip(c.states, lay.view._gown))
        return out

    def part_bytes(self, carry) -> list[int]:
        """Each part's device-resident carry bytes, in part order (one
        entry for a pack that one stepper holds)."""
        if isinstance(carry, list):
            return [carry_bytes(c) for c in carry]
        return [carry_bytes(carry)]

    def part_bytes_estimate(self, member: SimCarry) -> list[int]:
        """Each part's carry bytes, read off one member's tick-0 carry
        ``member`` (``prog.init_carry``) before any part is built: every
        run-axis leaf ``width`` times and the tick once, and of every lane
        leaf, plan state and calendar plane the part's members' own lanes —
        what :meth:`part_bytes` reads off the built carry. One entry (the
        whole pack) where one stepper holds it."""

        def nbytes(x):
            return 0 if x is None else x.numel() * x.element_size()

        n = self.n
        rep = self.width * sum(nbytes(_get(member, f)) for f in _RUN_LEAVES)
        rep += nbytes(member.t)
        lane = sum(nbytes(_get(member, p)) for p, _ in _LANE_LEAVES)
        lane += carry_bytes(member.cal)
        spans = ([(0, self.width, 0, n)] if not self.placed else
                 [(q.first, q.runs, q.s0 * self.n_loc, q.s1 * self.n_loc)
                  for q in self.parts])
        out = []
        for _, runs, lo, hi in spans:
            own = lane * (hi - lo) // n
            for g, st in zip(self.prog.groups, member.states):
                held = max(0, min(hi, g.offset + g.count) - max(lo, g.offset))
                own += sum(nbytes(v) // g.count * held for v in st.values())
            out.append(rep + runs * own)
        return out

    def _member_placed(self, lays, carries, r, gather=None) -> SimCarry:
        """Member ``r``'s snapshot of a placed pack: its lanes from every part
        that holds them, in lane order, and its run-axis leaves from part
        0's replicas. From the calling thread between chunks (the parts'
        carries read directly); or, with ``gather`` (a part's layout, its
        carry the only one given), from inside the part's tick, a collective
        every part takes in turn (``all_gather_cat``: a part that does not
        hold the member adds no lane)."""
        from .distributed import all_gather_cat

        dev0 = lays[0].device

        def block(lay, x, k):
            """Member k's own block of a lane leaf (flat) or a state."""
            return x.view(lay.runs, -1)[k] if x.dim() == 1 else x[k]

        if gather is not None:
            lay, carry = gather, carries[0]
            k = r - lay.first
            mine = 0 <= k < lay.runs

            def lanes(get):
                x = get(carry)
                return all_gather_cat(block(lay, x, k) if mine else block(lay, x, 0)[:0],
                                      lay.mesh)

            src = carry
        else:
            holders = [(lay, c) for lay, c in zip(lays, carries)
                       if lay.first <= r < lay.first + lay.runs]

            def lanes(get):
                return torch.cat([block(lay, get(c), r - lay.first).to(dev0)
                                  for lay, c in holders])

            src = carries[0]

        def run(x):
            return x[r].clone()

        return SimCarry(
            states=tuple({k: lanes(lambda c, g=g, k=k: c.states[g][k]) for k in st}
                         for g, st in enumerate(src.states)),
            status=lanes(lambda c: c.status),
            finished_at=lanes(lambda c: c.finished_at),
            cal=None,
            link=None,
            sync=SyncState(counts=run(src.sync.counts), last_seq=None, stream=None,
                           stream_len=None, cursors=None, dropped=run(src.sync.dropped)),
            rejected=None,
            keys=None,
            net_key=None,
            t=src.t,
            **{f: run(getattr(src, f)) for f in _RUN_COUNTERS},
            lat_hist=None if src.lat_hist is None else run(src.lat_hist),
            live_counts=None if src.live_counts is None else run(src.live_counts),
        )

    def _part_sums(self, lay, carry, step, fb, delivered_t, bw_changed, lat_d):
        """A placed part's tick gather: every part's per-run sync totals
        (signals and publishes, for the fold's exclusive sums) and partial
        counts (delivered, rejected, the HTB rate changes, the RUNNING
        instances per group after the step, the histogram's delta), each
        part's runs at their rows of one ``[R, K]`` block, every part
        summing the same gathered blocks (``engine._cohort_sums`` over a run
        axis). Returns the fold's :class:`RankTotals`, the summed running
        counts, delivered, rejected and rate changes, and the histogram."""
        from .distributed import all_gather

        i32 = torch.int32
        r_n, n, w = lay.runs, lay.n, self.width
        prog = self.prog
        n_s, n_t, g_n = prog.n_states, prog.n_topics, len(prog.groups)
        running = (step["status"].view(r_n, n) == RUNNING).to(i32)
        running = torch.zeros((r_n, g_n), dtype=i32, device=lay.device).index_add_(
            1, lay.group_of, running)
        cols = [step["signals"].view(n_s, r_n, n).sum(2, dtype=i32).t(),
                step["pub_valid"].view(n_t, r_n, n).sum(2, dtype=i32).t(),
                delivered_t[:, None], fb.rejected.view(r_n, n).sum(1, dtype=i32)[:, None],
                (torch.zeros(r_n, dtype=i32, device=lay.device) if bw_changed is None
                 else bw_changed)[:, None],
                running]
        mine = torch.cat(cols, dim=1)
        block = torch.zeros((w, mine.shape[1]), dtype=i32, device=lay.device)
        block[lay.first : lay.first + r_n] = mine
        if lat_d is not None:
            block = torch.cat([block, lat_d.view(w, -1)], dim=1)
        every = all_gather(block, lay.mesh)  # [P, R, K]
        ranks = RankTotals(sig=every[:, :, :n_s], pub=every[:, :, n_s : n_s + n_t],
                           rank=lay.part, mesh=lay.mesh, runs=(lay.first, r_n))
        tot = every[:, :, n_s + n_t :].sum(0, dtype=i32)
        lat_hist = None
        if lat_d is not None:
            lat_hist = carry.lat_hist + tot[:, 3 + g_n :].view(w, g_n, LATENCY_BINS)
        return ranks, tot[:, 3 : 3 + g_n], tot[:, 0], tot[:, 1], tot[:, 2], lat_hist

    # --------------------------------------------------------------- tick

    def _member_step(self, lay, state_keys, args, t):
        """One member's plan step (``SimProgram._step_phase``) on its batched
        leaves: the state leaves (``state_keys`` per group), then the fixed
        leaves of :meth:`_step`. Returns the step's tensors flat and sets
        ``lay.out_keys`` to the names of its planes."""
        n_state = sum(len(k) for k in state_keys)
        it = iter(args[:n_state])
        states = tuple({k: next(it) for k in keys} for keys in state_keys)
        (status, finished_at, rejected, keys, counts, last_seq, stream, stream_len,
         cursors, dropped, pay, src, valid, both, live) = args[n_state:]
        view = lay.view
        if view.bucketed:
            view._virt = _BatchedVirt(both, view)
        carry = SimCarry(
            states=states, status=status, finished_at=finished_at, cal=None,
            link=None,
            sync=SyncState(counts=counts, last_seq=last_seq, stream=stream,
                           stream_len=stream_len, cursors=cursors, dropped=dropped),
            rejected=rejected, keys=keys, net_key=None, t=t, clamped=None,
            bw_dropped=None, bw_rate_changed=None, collisions=None,
            collision_where=None, msgs_delivered=None, msgs_sent=None,
            msgs_enqueued=None, msgs_dropped=None, msgs_rejected=None,
            cal_depth=None, faults_crashed=None, faults_restarted=None,
            fault_dropped=None,
        )
        step = view._step_phase(carry, Inbox(payload=pay, src=src, valid=valid), t,
                                live=live)
        out = [v for st in step.pop("states") for v in st.values()]
        lay.out_keys = [k for k, v in step.items() if v is not None]
        return out + [step[k] for k in lay.out_keys]

    def _vmapped(self, r_n, fn, args, dims):
        """``fn(batched args)`` under one vmap level over ``r_n`` runs, its
        flat tensor outputs with the run axis leading: ``torch.func.vmap``
        without its wrapper's pytree walks, which cost more host time a
        tick than the step's batched ops."""
        level = _vmap_increment_nesting(r_n, "error")
        try:
            batched = [a if d is None else _add_batch_dim(a, d, level)
                       for a, d in zip(args, dims)]
            return [_remove_batch_dim(o, level, r_n, 0) for o in fn(batched)]
        finally:
            _vmap_decrement_nesting()

    def _step(self, lay, carry: SimCarry, inbox: Inbox, t) -> dict:
        """The plan step of every member ``lay`` holds in one vmapped call,
        its planes laid back on the ``[.., runs·n]`` lane axis."""
        r_n, n = lay.runs, lay.n
        sync = carry.sync
        s_n, t_n = sync.last_seq.shape[0], sync.cursors.shape[0]
        w, slots = inbox.payload.shape[0], inbox.payload.shape[1]
        state_keys = [list(st) for st in carry.states]
        flat = [v for st in carry.states for v in st.values()]
        counts, stream, stream_len, dropped = (sync.counts, sync.stream, sync.stream_len,
                                               sync.dropped)
        live = None
        if lay.part is not None:  # the run-axis leaves: this part's runs
            mine = slice(lay.first, lay.first + r_n)
            counts, stream, stream_len, dropped = (counts[mine], stream[mine],
                                                   stream_len[mine], dropped[mine])
            live = lay.live[mine]
        args = flat + [
            carry.status.view(r_n, n), carry.finished_at.view(r_n, n),
            carry.rejected.view(r_n, n), carry.keys.view(r_n, n, 2), counts,
            sync.last_seq.view(s_n, r_n, n), stream, stream_len,
            sync.cursors.view(t_n, r_n, n), dropped,
            inbox.payload.view(w, slots, r_n, n), inbox.src.view(slots, r_n, n),
            inbox.valid.view(slots, r_n, n), lay.both, live,
        ]
        dims = [0] * len(flat) + [0, 0, 0, 0, 0, 1, 0, 0, 1, 0, 2, 1, 1,
                                  None if lay.both is None else 0,
                                  None if live is None else 0]

        def member(batched):
            return self._member_step(lay, state_keys, batched, t)

        with no_vmap_fallback():
            if lay.first_step:
                # a padded run's plan may not read a count on the host
                with _NoHostReads():
                    out = self._vmapped(r_n, member, args, dims)
                lay.first_step = False
            else:
                out = self._vmapped(r_n, member, args, dims)
        it = iter(out)
        step = {"states": tuple({k: next(it) for k in keys} for keys in state_keys)}
        for k in lay.out_keys:
            v = next(it)
            # [R, ..., N] → [..., R·N]
            step[k] = v.movedim(0, -2).reshape(v.shape[1:-1] + (lay.lanes,))
        for k in ("net_rules", "net_rules_valid"):
            step.setdefault(k, None)
        return step

    def _tick(self, lay, carry: SimCarry, salts, done_out, blocks, row: int) -> SimCarry:
        """One tick of every member ``lay`` holds (``SimProgram._tick`` over
        the run axis). ``salts`` is this tick's ``[R]`` int64 hash salts on
        the device; ``done_out`` the ``(flag [R], event)`` pair the members'
        done flags are copied into: right after the step, or on a placed
        part after the tick's gather, where every part's lanes are counted."""
        prog, cls = self.prog, self.cls
        r_n, n = lay.runs, lay.n
        placed = lay.part is not None
        i32 = torch.int32
        t = carry.t
        cal, inbox = deliver(carry.cal, t)
        delivered_t = inbox.valid.view(cls.IN_MSGS, r_n, n).sum(dim=(0, 2), dtype=i32)
        if cls.TRACK_SRC:
            inbox = Inbox(payload=inbox.payload, src=lay.src_tbl[inbox.src],
                          valid=inbox.valid)
        lat_hist = lat_d = None
        if prog.telemetry:
            g_n = len(prog.groups)
            lat_d = latency_histogram(
                cal, inbox, t, lay.lat_group_of, self.width * g_n, LATENCY_BINS
            ).view(self.width, g_n, LATENCY_BINS)
            if not placed:
                lat_hist = carry.lat_hist + lat_d
        step = self._step(lay, carry, inbox, t)
        flag, event = done_out
        if not placed:
            flag.copy_((step["status"].view(r_n, n) != RUNNING).all(dim=1),
                       non_blocking=True)
            if event is not None:
                event.record()
        dst = lay.dst_tbl[step["dst"].clamp(-1, lay.nv_max) + lay.dst_base]
        cal, fb = enqueue(
            cal,
            carry.link,
            dst,
            step["payload"],
            step["valid"],
            t,
            prog.tick_ms,
            salts[lay.msg_run],
            slot_mode=cls.SLOT_MODE,
            features=tuple(cls.SHAPING),
            stacking=cls.CROSS_TICK_STACKING,
            bw_queue_cap=cls.BW_QUEUE_MSGS,
            validate=prog.validate,
            dice_idx=lay.dice_idx,
            runs=self.width,
            run_lanes=lay.run_lanes,
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
        bw_changed = None
        if fb.backlog is not None:
            changed = (link.egress[BANDWIDTH] != carry.link.egress[BANDWIDTH]) & (
                fb.backlog > 0
            )
            bw_changed = changed.view(r_n, n).sum(1, dtype=i32)
            link = dataclasses.replace(link, backlog=fb.backlog)
        ranks = running = None
        if placed:
            (ranks, running, delivered_t, rejected_t, bw_tot,
             lat_hist) = self._part_sums(lay, carry, step, fb, delivered_t, bw_changed,
                                         lat_d)
            if bw_changed is not None:
                bw_changed = bw_tot
            lay.live = running
            flag.copy_(running.sum(1) == 0, non_blocking=True)
            if event is not None:
                event.record()
        else:
            rejected_t = fb.rejected.view(r_n, n).sum(1, dtype=i32)
        if bw_changed is not None:
            bw_rate_changed = bw_rate_changed + bw_changed
        collisions, collision_where = carry.collisions, carry.collision_where
        if prog.validate:
            collisions = collisions + fb.collisions
            collision_where = torch.where(
                ((carry.collisions == 0) & (fb.collisions > 0))[:, None],
                fb.collision_where,
                collision_where,
            )
        sync = update_sync(
            carry.sync,
            step["signals"],
            step["pub_payload"],
            step["pub_valid"],
            step["sub_consume"],
            runs=self.width,
            ranks=ranks,
        )
        dropped_t = fb.sent - fb.enqueued - rejected_t - fb.fault_dropped
        cal_depth = carry.cal_depth + fb.enqueued - delivered_t
        new = SimCarry(
            states=step["states"],
            status=step["status"],
            finished_at=step["finished_at"],
            cal=cal,
            link=link,
            sync=sync,
            rejected=fb.rejected,
            keys=carry.keys,
            net_key=carry.net_key,
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
            faults_crashed=carry.faults_crashed,
            faults_restarted=carry.faults_restarted,
            fault_dropped=carry.fault_dropped + fb.fault_dropped,
            lat_hist=lat_hist,
            live_counts=carry.live_counts,
        )
        if blocks is not None:
            self._telemetry_rows(
                lay, blocks.tele[row], t, step["status"], sync, delivered_t, fb.sent,
                fb.enqueued, dropped_t, rejected_t, cal_depth, fb.fault_dropped, running,
            )
        return new

    def _telemetry_rows(self, lay, out, t, status, sync, delivered_t, sent_t, enqueued_t,
                        dropped_t, rejected_t, cal_depth, fault_dropped_t,
                        running=None) -> None:
        """Every member's counter row of the tick into ``out`` ([R, K]
        int32; ``SimProgram._telemetry_row`` per run); a placed part's
        RUNNING counts are the gathered ``running``."""
        r_n, n = self.width, self.n
        i32 = torch.int32
        zero = torch.zeros(r_n, dtype=i32, device=out.device)
        fixed = [
            t.expand(r_n), delivered_t, sent_t, enqueued_t, dropped_t, rejected_t,
            enqueued_t * int(MSG_BYTES), cal_depth, sync.counts.sum(1, dtype=i32),
            sync.stream_len.sum(1, dtype=i32), zero, zero, fault_dropped_t,
        ]
        nf = len(fixed)
        out[:, :nf] = torch.stack(fixed, dim=1)
        if running is not None:
            out[:, nf:] = running
            return
        running = (status.view(r_n, n) == RUNNING).to(i32)
        out[:, nf:] = torch.zeros((r_n, len(self.prog.groups)), dtype=i32,
                                  device=out.device).index_add_(1, lay.group_of, running)

    # ---------------------------------------------------------------- run

    def run(self, members: list[PackMember]) -> list[dict]:
        """Step every member to completion (or its cancel or budget) as one
        program — one launch per op for the whole pack, or for each part's
        block of it — and return per-member results dicts (the
        ``SimProgram.run`` shape)."""
        if not (0 < len(members) <= self.width):
            raise ValueError(
                f"{len(members)} member(s) for a width-{self.width} pack"
            )
        prog = self.prog
        chunk = prog.chunk
        n_live = len(members)
        width = self.width
        dev = prog.device
        cuda = dev.type == "cuda"
        t0 = time.perf_counter()
        if prog.bucketed:
            for m in members:
                if m.live_counts is None:
                    raise ValueError("bucketed pack members must carry live_counts")
            fill = members[0].live_counts
            lcs = [m.live_counts for m in members] + [fill] * (width - n_live)
        else:
            lcs = [None] * width
        seeds = [int(m.seed) for m in members] + [0] * (width - n_live)
        live_run = [True] * n_live + [False] * (width - n_live)
        mprogs = [self._member_program(lc) for lc in lcs]
        lays = None
        with device_context(dev):
            if self.placed:
                lays = self._part_layouts(mprogs)
                carry, net_key, footprint = self._init_placed(lays, mprogs, seeds, live_run)
            else:
                lay = self._tables(mprogs, 0, width, 0, self.n,
                                   np.arange(self.lanes).reshape(width, self.n), dev,
                                   self._view)
                carry, footprint = self._init(mprogs, seeds, live_run)
                net_key = carry.net_key
        flags = [(torch.zeros(width, dtype=torch.bool, pin_memory=cuda),
                  torch.cuda.Event() if cuda else None)
                 for _ in (lays if lays is not None else [None])]
        blocks = _PackBlocks(self, cuda) if prog.telemetry else None
        lat_acc = None
        if prog.telemetry:
            lat_acc = np.zeros((n_live, len(prog.groups), LATENCY_BINS), np.int64)
        max_ticks = max(m.max_ticks for m in members)
        ticks = 0
        compile_secs = 0.0
        active = [True] * n_live  # still watched (not done, stopped or stashed)
        done = [False] * n_live
        stashes: list[Any] = [None] * n_live

        def ticks_of(lay, carry, salts, done_run, blocks, flag, finished, snap):
            """One chunk of one stepper: up to ``chunk`` ticks, while a
            watched member runs; ``done_run`` (updated in place) the members
            seen done, and per member that finished inside it, ``finished[r]
            = (row, its histogram delta up to the finish or None when the
            chunk's flush holds exactly that)``, its snapshot ``snap(carry,
            r)`` (None: not this stepper's to keep)."""
            flag, event = flag
            flushed = False
            if blocks is not None:
                blocks.reset()
            for i in range(chunk):
                pending = [r for r in range(n_live) if active[r] and not done_run[r]]
                if not pending:
                    break  # every watched member is done: no-op ticks
                last = prog.telemetry and i == chunk - 1
                carry = self._tick(lay, carry, salts[i], (flag, None if last else event),
                                   blocks, i)
                if last:
                    carry = self._flush(carry, blocks, event)
                    flushed = True
                if cuda:
                    event.synchronize()
                f = flag.numpy()
                for r in pending:
                    if f[r]:
                        done_run[r] = True
                        got = snap(carry, r)
                        if got is not None:
                            stashes[r] = got
                            finished[r] = (
                                i,
                                None if last or carry.lat_hist is None else got.lat_hist,
                            )
            if prog.telemetry and not flushed:
                carry = self._flush(carry, blocks, event)
                if cuda:
                    event.synchronize()
            return carry

        def chunk_run(carry, net_key):
            """One chunk; returns the carry, the link keys after it and the
            members that finished inside it (``ticks_of``)."""
            finished: dict[int, tuple] = {}
            salts_np, k0, k1 = _split_salts(net_key[0], net_key[1], chunk)
            salts = torch.from_numpy(salts_np)
            if lays is None:
                carry = ticks_of(lay, carry, salts.to(dev), done, blocks, flags[0], finished,
                                 lambda c, r: self.member_carry(c, r, clone=True))
                return dataclasses.replace(carry, net_key=(k0, k1)), (k0, k1), finished
            seen = list(done)
            out = list(carry)

            def work(i):
                part = lays[i]

                def snap(c, r):
                    got = self._member_placed(lays, [c], r, gather=part)
                    return got if i == 0 else None

                # every part reads the same flags: each keeps its own copy
                done_run = done if i == 0 else list(seen)
                out[i] = ticks_of(part, carry[i], salts.to(part.device), done_run,
                                  blocks if i == 0 else None, flags[i], finished, snap)

            on_parts(self._group, [q.device for q in lays], work)
            return out, (k0, k1), finished

        while ticks < max_ticks and any(active):
            t_chunk = time.perf_counter()
            with device_context(dev):
                carry, net_key, finished = chunk_run(carry, net_key)
            ticks += chunk
            wall = time.perf_counter() - t_chunk
            if compile_secs == 0.0:
                compile_secs = time.perf_counter() - t0
            tele_host = lat_delta = None
            if prog.telemetry:
                tele_host = blocks.host["tele"].numpy()  # [chunk, R, K]
                lat_delta = blocks.host["lat_hist"].numpy().astype(np.int64)
            for i, m in enumerate(members):
                if not active[i]:
                    continue
                block = delta = None
                if prog.telemetry:
                    block = tele_host[:, i].copy()
                    delta = lat_delta[i]
                    if i in finished:
                        row, lat_stash = finished[i]
                        # the isolated run stopped at its finish: later
                        # rows are its padding, its delta ends there
                        block[row + 1 :] = -1
                        if lat_stash is not None:
                            delta = lat_stash.cpu().numpy().astype(np.int64)
                    lat_acc[i] += delta
                if m.perf is not None:
                    m.perf.on_chunk(ticks // chunk - 1, ticks, chunk, wall)
                if prog.telemetry:
                    if m.telemetry_cb is not None:
                        m.telemetry_cb(block)
                    if m.lat_hist_cb is not None:
                        m.lat_hist_cb(delta)
                if m.on_chunk is not None:
                    m.on_chunk(ticks)
                if done[i]:
                    m.done = True
                    m.ticks = ticks
                    active[i] = False
                elif ticks >= m.max_ticks:
                    # this member's own budget is spent (another member
                    # may run longer): its snapshot is this boundary
                    m.ticks = ticks
                    active[i] = False
                    stashes[i] = self._member(lays, carry, i, clone=True)
                elif m.cancel_check is not None and m.cancel_check():
                    m.canceled = True
                    m.ticks = ticks
                    active[i] = False
                    stashes[i] = self._member(lays, carry, i, clone=True)

        for i, m in enumerate(members):
            if active[i]:  # the pack's budget ran out while it ran
                m.ticks = ticks
                active[i] = False

        self.last_part_bytes = self.part_bytes(carry)
        results: list[dict] = []
        for i, m in enumerate(members):
            src = stashes[i] if stashes[i] is not None else self._member(lays, carry, i)
            res = mprogs[i].results(src, m.ticks, carry_bytes=footprint)
            res["compile_secs"] = compile_secs
            if lat_acc is not None:
                res["lat_hist"] = lat_acc[i].tolist()
            results.append(res)
        return results

    def _member(self, lays, carry, r, clone=False) -> SimCarry:
        """Member ``r``'s snapshot between chunks."""
        if lays is None:
            return self.member_carry(carry, r, clone=clone)
        return self._member_placed(lays, carry, r)

    @staticmethod
    def _flush(carry, blocks, event) -> SimCarry:
        """The chunk's end: the pack's blocks to the host (a placed part
        other than the first holds none, and zeroes its histogram replica
        alike), the done flag's event recorded behind."""
        if blocks is not None:
            return blocks.flush(carry, event)
        carry = dataclasses.replace(carry, lat_hist=torch.zeros_like(carry.lat_hist))
        if event is not None:
            event.record()
        return carry
