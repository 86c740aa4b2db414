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
the program stays unmeshed, as the reference's inner program does, and
only the pack's calendar is split: one sub-shard of ``n_loc = N / P`` lanes
for each (member, peer shard), in the pack's lane order — sub-shard
``r·P + s`` holds member r's lanes ``[s·n_loc, (s+1)·n_loc)``
(:func:`sub_shard_mesh`). So the pack's calendar is the sharded calendar of
``sim/net.py`` over ``W·P`` shards, with its shard-major sort key, its
sharded K1 and K2 (one launch per part: once a tick on one card) and its
pop straight into the step's run-major lanes. On a 2-D mesh the members
split into contiguous groups, one per row, and a member's sub-shards sit
on its row's devices. Every other leaf stays on the mesh's primary device.
A member whose lanes do not divide across the peer shards is padded with
the solo meshed run's dead lanes (``SimProgram(lane_multiple=P)``).

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
from .meshplan import TorchMesh, _indexed, plan_for
from .engine import (
    SimCarry,
    _NoHostReads,
    _Virtual,
    device_context,
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
)
from .sync_kernel import SyncState, update_sync
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


class PackRunner:
    """R compatible runs over ONE :class:`~.engine.SimProgram` (``prog``,
    the members' shared padded layout), stepped as one program over a run
    axis of ``width`` members (dead dummies past the live ones).

    The program must be trace-free, fault-free, host-free and matrix-free
    (the admission key guarantees it). ``prog.live_counts`` decides
    whether members carry per-run exact counts (shape bucketing) — when
    set, every member's ``live_counts`` must be provided."""

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
        # the calendar's sub-shards on a mesh (None without one)
        self.cal_mesh = None
        if mesh is not None:
            if mesh.primary != _indexed(prog.device):
                raise ValueError(
                    f"the pack's program lives on {prog.device}, not on the "
                    f"mesh's primary device {mesh.primary}: a meshed pack "
                    "keeps every leaf but the calendar there"
                )
            if self.n % mesh.shards:
                raise ValueError(
                    f"a member's {self.n} lanes do not divide across the "
                    f"mesh's {mesh.shards} peer shards"
                )
            self.cal_mesh = sub_shard_mesh(mesh, self.width)
        self._members_cache: dict = {}
        # the plan step's program: the member's virtual layout is set per
        # call (bucketed), and host reads are watched on the first step
        self._view = copy.copy(prog)
        self._view._watch_host_reads = False
        self._first_step = prog.bucketed

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

    def _tables(self, mprogs) -> None:
        """The pack's static maps for this membership, built once per run:
        the destination, sender and dice tables, each message's run, the
        lane → (run, group) map of the histogram and, bucketed, the
        members' exact-count rows."""
        prog, cls, dev = self.prog, self.cls, self.prog.device
        r_n, n, lanes = self.width, self.n, self.lanes
        i64 = torch.int64
        g_n = len(prog.groups)
        group_of = prog._group_of.to(i64)
        runs = torch.arange(r_n, dtype=i64, device=dev)
        # the histogram's rows: run r's group g is row r·G + g
        self._lat_group_of = (runs[:, None] * g_n + group_of[None, :]).reshape(-1)
        self._group_of = group_of
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
        self._nv_max = max(nv)
        width = self._nv_max + 2
        tbl = np.full((r_n, width), lanes, np.int64)
        tbl[:, 0] = -1
        for r in range(r_n):
            tbl[r, 1 : 1 + nv[r]] = r * n + np.asarray(phys[r], np.int64)
        self._dst_tbl = torch.from_numpy(tbl.reshape(-1).astype(np.int32)).to(dev)
        self._dst_base = torch.from_numpy(
            np.repeat(np.arange(r_n, dtype=np.int64) * width + 1, n).astype(np.int32)
        ).to(dev)
        # delivered senders (global lanes) back to each member's ids; the
        # empty slot's src = -1 reads the trailing -1
        src = np.concatenate([np.asarray(s, np.int64) for s in src_loc] + [[-1]])
        self._src_tbl = torch.from_numpy(src.astype(np.int32)).to(dev)
        # message o·R·N + r·N + p hashes the index its member's run hashes
        rows = np.arange(o, dtype=np.int64)[:, None, None]
        d = np.stack([np.asarray(x, np.int64) for x in dice])[None, :, :]
        nvv = np.asarray(nv, np.int64)[None, :, None]
        self._dice_idx = torch.from_numpy(
            (rows * nvv + d).reshape(-1).astype(np.int32)).to(dev)
        self._msg_run = torch.arange(r_n, dtype=i64, device=dev).repeat_interleave(
            n).repeat(o)
        self._both = None
        if prog.bucketed:
            both = [
                [m._virt.ln, *m.live_counts, *m._virt.voff[:-1].tolist()]
                for m in mprogs
            ]
            self._both = torch.tensor(both, dtype=torch.int32, device=dev)

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

    # --------------------------------------------------------------- tick

    def _member_step(self, state_keys, args, t):
        """One member's plan step (``SimProgram._step_phase``) on its batched
        leaves: the state leaves (``state_keys`` per group), then the fixed
        leaves of :meth:`_step`. Returns the step's tensors flat and sets
        ``_out_keys`` to the names of its planes."""
        n_state = sum(len(k) for k in state_keys)
        it = iter(args[:n_state])
        states = tuple({k: next(it) for k in keys} for keys in state_keys)
        (status, finished_at, rejected, keys, counts, last_seq, stream, stream_len,
         cursors, dropped, pay, src, valid, both) = args[n_state:]
        view = self._view
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
        step = view._step_phase(carry, Inbox(payload=pay, src=src, valid=valid), t)
        out = [v for st in step.pop("states") for v in st.values()]
        self._out_keys = [k for k, v in step.items() if v is not None]
        return out + [step[k] for k in self._out_keys]

    def _vmapped(self, fn, args, dims):
        """``fn(batched args)`` under one vmap level over the run axis, its
        flat tensor outputs with the run axis leading: ``torch.func.vmap``
        without its wrapper's pytree walks, which cost more host time a
        tick than the step's batched ops."""
        r_n = self.width
        level = _vmap_increment_nesting(r_n, "error")
        try:
            batched = [a if d is None else _add_batch_dim(a, d, level)
                       for a, d in zip(args, dims)]
            return [_remove_batch_dim(o, level, r_n, 0) for o in fn(batched)]
        finally:
            _vmap_decrement_nesting()

    def _step(self, carry: SimCarry, inbox: Inbox, t) -> dict:
        """The plan step of every member in one vmapped call, its planes
        laid back on the pack's ``[.., R·N]`` lane axis."""
        r_n, n = self.width, self.n
        sync = carry.sync
        s_n, t_n = sync.last_seq.shape[0], sync.cursors.shape[0]
        w, slots = inbox.payload.shape[0], inbox.payload.shape[1]
        state_keys = [list(st) for st in carry.states]
        flat = [v for st in carry.states for v in st.values()]
        args = flat + [
            carry.status.view(r_n, n), carry.finished_at.view(r_n, n),
            carry.rejected.view(r_n, n), carry.keys.view(r_n, n, 2), sync.counts,
            sync.last_seq.view(s_n, r_n, n), sync.stream, sync.stream_len,
            sync.cursors.view(t_n, r_n, n), sync.dropped,
            inbox.payload.view(w, slots, r_n, n), inbox.src.view(slots, r_n, n),
            inbox.valid.view(slots, r_n, n), self._both,
        ]
        dims = [0] * len(flat) + [0, 0, 0, 0, 0, 1, 0, 0, 1, 0, 2, 1, 1,
                                  None if self._both is None else 0]

        def member(batched):
            return self._member_step(state_keys, batched, t)

        with no_vmap_fallback():
            if self._first_step:
                # a padded run's plan may not read a count on the host
                with _NoHostReads():
                    out = self._vmapped(member, args, dims)
                self._first_step = False
            else:
                out = self._vmapped(member, args, dims)
        it = iter(out)
        step = {"states": tuple({k: next(it) for k in keys} for keys in state_keys)}
        for k in self._out_keys:
            v = next(it)
            # [R, ..., N] → [..., R·N]
            step[k] = v.movedim(0, -2).reshape(v.shape[1:-1] + (self.lanes,))
        for k in ("net_rules", "net_rules_valid"):
            step.setdefault(k, None)
        return step

    def _tick(self, carry: SimCarry, salts, done_out, blocks, row: int) -> SimCarry:
        """One tick of every member (``SimProgram._tick`` over the run
        axis). ``salts`` is this tick's ``[R]`` int64 hash salts on the
        device; ``done_out`` the ``(flag [R], event)`` pair the members'
        done flags are copied into right after the step."""
        prog, cls = self.prog, self.cls
        r_n, n = self.width, self.n
        i32 = torch.int32
        t = carry.t
        cal, inbox = deliver(carry.cal, t)
        delivered_t = inbox.valid.view(cls.IN_MSGS, r_n, n).sum(dim=(0, 2), dtype=i32)
        if cls.TRACK_SRC:
            inbox = Inbox(payload=inbox.payload, src=self._src_tbl[inbox.src],
                          valid=inbox.valid)
        lat_hist = None
        if prog.telemetry:
            g_n = len(prog.groups)
            lat_hist = carry.lat_hist + latency_histogram(
                cal, inbox, t, self._lat_group_of, r_n * g_n, LATENCY_BINS
            ).view(r_n, g_n, LATENCY_BINS)
        step = self._step(carry, inbox, t)
        flag, event = done_out
        flag.copy_((step["status"].view(r_n, n) != RUNNING).all(dim=1), non_blocking=True)
        if event is not None:
            event.record()
        dst = self._dst_tbl[step["dst"].clamp(-1, self._nv_max) + self._dst_base]
        cal, fb = enqueue(
            cal,
            carry.link,
            dst,
            step["payload"],
            step["valid"],
            t,
            prog.tick_ms,
            salts[self._msg_run],
            slot_mode=cls.SLOT_MODE,
            features=tuple(cls.SHAPING),
            stacking=cls.CROSS_TICK_STACKING,
            bw_queue_cap=cls.BW_QUEUE_MSGS,
            validate=prog.validate,
            dice_idx=self._dice_idx,
            runs=r_n,
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
            changed = (link.egress[BANDWIDTH] != carry.link.egress[BANDWIDTH]) & (
                fb.backlog > 0
            )
            bw_rate_changed = bw_rate_changed + changed.view(r_n, n).sum(1, dtype=i32)
            link = dataclasses.replace(link, backlog=fb.backlog)
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
            runs=r_n,
        )
        rejected_t = fb.rejected.view(r_n, n).sum(1, dtype=i32)
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
                blocks.tele[row], t, step["status"], sync, delivered_t, fb.sent,
                fb.enqueued, dropped_t, rejected_t, cal_depth, fb.fault_dropped,
            )
        return new

    def _telemetry_rows(self, out, t, status, sync, delivered_t, sent_t, enqueued_t,
                        dropped_t, rejected_t, cal_depth, fault_dropped_t) -> None:
        """Every member's counter row of the tick into ``out`` ([R, K]
        int32; ``SimProgram._telemetry_row`` per run)."""
        r_n, n = self.width, self.n
        i32 = torch.int32
        zero = torch.zeros(r_n, dtype=i32, device=out.device)
        fixed = [
            t.expand(r_n), delivered_t, sent_t, enqueued_t, dropped_t, rejected_t,
            enqueued_t * int(MSG_BYTES), cal_depth, sync.counts.sum(1, dtype=i32),
            sync.stream_len.sum(1, dtype=i32), zero, zero, fault_dropped_t,
        ]
        running = (status.view(r_n, n) == RUNNING).to(i32)
        nf = len(fixed)
        out[:, :nf] = torch.stack(fixed, dim=1)
        out[:, nf:] = torch.zeros((r_n, len(self.prog.groups)), dtype=i32,
                                  device=out.device).index_add_(1, self._group_of, running)

    # ---------------------------------------------------------------- run

    def run(self, members: list[PackMember]) -> list[dict]:
        """Step every member to completion (or its cancel or budget) as one
        program — one launch per op for the whole pack — and return
        per-member results dicts (the ``SimProgram.run`` shape)."""
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
        with device_context(dev):
            self._tables(mprogs)
            carry, footprint = self._init(mprogs, seeds, live_run)
        flag = torch.zeros(width, dtype=torch.bool, pin_memory=cuda)
        event = torch.cuda.Event() if cuda else None
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

        def chunk_run(carry):
            """One chunk; returns the carry and, per member that finished
            inside it, ``(row, its histogram delta up to the finish or
            None when the chunk's flush holds exactly that)``."""
            finished: dict[int, tuple] = {}
            salts_np, k0, k1 = _split_salts(carry.net_key[0], carry.net_key[1], chunk)
            salts = torch.from_numpy(salts_np).to(dev)
            carry = dataclasses.replace(carry, net_key=(k0, k1))
            flushed = False
            if blocks is not None:
                blocks.reset()
            for i in range(chunk):
                pending = [r for r in range(n_live) if active[r] and not done[r]]
                if not pending:
                    break  # every watched member is done: no-op ticks
                last = blocks is not None and i == chunk - 1
                carry = self._tick(carry, salts[i], (flag, None if last else event),
                                   blocks, i)
                if last:
                    carry = blocks.flush(carry, event)
                    flushed = True
                if cuda:
                    event.synchronize()
                f = flag.numpy()
                for r in pending:
                    if f[r]:
                        done[r] = True
                        stashes[r] = self.member_carry(carry, r, clone=True)
                        finished[r] = (
                            i,
                            None if last or carry.lat_hist is None
                            else stashes[r].lat_hist,
                        )
            if blocks is not None and not flushed:
                carry = blocks.flush(carry, event)
                if cuda:
                    event.synchronize()
            return carry, finished

        while ticks < max_ticks and any(active):
            t_chunk = time.perf_counter()
            with device_context(dev):
                carry, finished = chunk_run(carry)
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
                    stashes[i] = self.member_carry(carry, i, clone=True)
                elif m.cancel_check is not None and m.cancel_check():
                    m.canceled = True
                    m.ticks = ticks
                    active[i] = False
                    stashes[i] = self.member_carry(carry, i, clone=True)

        for i, m in enumerate(members):
            if active[i]:  # the pack's budget ran out while it ran
                m.ticks = ticks
                active[i] = False

        results: list[dict] = []
        for i, m in enumerate(members):
            src = stashes[i] if stashes[i] is not None else self.member_carry(carry, i)
            res = mprogs[i].results(src, m.ticks, carry_bytes=footprint)
            res["compile_secs"] = compile_secs
            if lat_acc is not None:
                res["lat_hist"] = lat_acc[i].tolist()
            results.append(res)
        return results
