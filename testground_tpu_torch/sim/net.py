"""The simulated data network over torch: link shaping + calendar transport.

Port of ``testground_tpu/sim/net.py`` (read its module docstring for the
model). In-flight messages live in a calendar queue of ``[L, N·SLOTS]``
planes indexed by arrival tick mod L, with positions ``slot·N + dst``; the
``LinkShape`` knobs are arithmetic applied at send time.

What this module ports: the 2-D plane form of :class:`Calendar` (the flat
form is an XLA:TPU layout choice), :class:`LinkState`,
:class:`NetFeedback`, :func:`make_link_state`, :func:`deliver`,
:func:`enqueue` in both slot modes (sorted, and direct with its
``validate`` collision check) with every LinkShape feature (latency,
jitter, bandwidth as an admission cap or an HTB queue, loss, corrupt,
reorder, duplicate, the dense filter table and per-instance range rules),
control lanes (``control_start``), the fault plane's send-time terms
(``faults``, ``dead``), the per-message fate and flow (``want_fate``,
``want_flow``), :func:`purge_dst` and :func:`purge_dst_matrix`,
:func:`latency_histogram` (with :func:`spread_offsets`), and
:func:`apply_net_updates`. The commit of
the sorted stream and the delivery pop go through the kernels of
``sim/cuda_transport.py`` (plain versions on the CPU). Direct mode's write, the purges, the fault windows
and the observability planes' scatters are plain torch ops: in the
reference too they are plain XLA, outside any Pallas kernel.

On a mesh of S peer shards (``Calendar.mesh``, a ``meshplan.TorchMesh``)
shard s owns lanes ``[s·n_loc, (s+1)·n_loc)`` and its own ``[L,
SLOTS·n_loc]`` planes, and a device holds its shards as one ``[S_d, L,
SLOTS·n_loc]`` tensor per plane. The sorted stream then carries the
reference's SHARD-major key (``net.py:1174-1183``), the commit and the pop
are the sharded kernels, and the direct write, the purges and the latency
histogram address each shard's planes. Every result is the unmeshed run's.
On a cohort mesh (``sim/distributed.py``; a part view of a several-part
mesh likewise, "process" and "rank" below reading "part") a process
holds only its own lanes: its shards' planes, and its own columns of the
link state, the outbox and every per-lane row the functions here take or
return. Its pop
and its etick row are its own lanes' (nothing crosses processes). Its
enqueue shapes its own senders' messages, the dice hashing the single
run's message indices, then hands each message to the rank of its
destination (:func:`_exchange`): every rank receives the messages of its
own destinations from every sender rank and commits them with the sharded
kernel in the single run's order (each sorted by key, ties by global
message index). The survival of each message goes back to its sender
only where the fate or the flow asks for it; the feedback's counts are
summed over the ranks. What the shaping reads at a destination — its
region, its fault-plane death — is read off a per-tick copy of the whole
row gathered from the ranks (:func:`_all_lanes`), or off the fault
schedule's whole masks. The purges' counts are summed.

Bit-equality with the reference rests on three rules:

- integer hashing in int64 masked to 32 bits (torch's ``>>`` on int32 is
  arithmetic, the reference's is logical);
- floor division/modulo (``torch.div(..., rounding_mode="floor")``,
  ``torch.remainder``);
- float32 arithmetic with Python scalars, as JAX's weak typing does — no
  float64 anywhere on the path.
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from .api import FILTER_ACCEPT, FILTER_REJECT, Inbox
from .cuda_transport import (
    commit_calendar,
    commit_calendar_sharded,
    pop_bucket,
    pop_bucket_sharded,
)
from .faults import DeviceFaults

__all__ = [
    "FULL_SHAPING",
    "SHAPING_NO_DUPLICATE",
    "Calendar",
    "LinkState",
    "NetFeedback",
    "RunLanes",
    "apply_net_updates",
    "deliver",
    "enqueue",
    "from_shards",
    "latency_histogram",
    "make_link_state",
    "purge_dst",
    "purge_dst_matrix",
    "spread_offsets",
    "to_shards",
]

# LinkShape plane indices (``pkg/sidecar/link.go:155-183``).
LATENCY, JITTER, BANDWIDTH, LOSS, CORRUPT, REORDER, DUPLICATE = range(7)

# Assumed wire size per message for bandwidth accounting (bytes).
MSG_BYTES = 256.0

FULL_SHAPING = (
    "latency",
    "jitter",
    "bandwidth",
    "loss",
    "corrupt",
    "reorder",
    "duplicate",
    "filters",
)
SHAPING_NO_DUPLICATE = tuple(f for f in FULL_SHAPING if f != "duplicate")

_M32 = 0xFFFFFFFF


@dataclasses.dataclass
class LinkState:
    """Per-instance egress shaping + per-(instance, dst-region) filters:
    ``egress [7, N]`` float32, ``filters [R, N]`` int32, ``region_of [N]``
    int32, ``backlog [N]`` float32 (the HTB queue's standing busy time in
    ticks; None unless "bandwidth_queue" is declared) and ``rules [K, 3,
    N]`` int32 (per-instance range rules; None unless "filter_rules" is
    declared). See the reference ``LinkState``."""

    egress: torch.Tensor
    filters: torch.Tensor
    region_of: torch.Tensor
    backlog: torch.Tensor | None = None
    rules: torch.Tensor | None = None


@dataclasses.dataclass
class NetFeedback:
    """Per-tick transport feedback from :func:`enqueue` (the reference
    ``NetFeedback``, field for field)."""

    rejected: torch.Tensor  # [N] int32
    clamped: torch.Tensor  # int32
    bw_dropped: torch.Tensor  # int32
    backlog: torch.Tensor | None  # [N] float32, next tick's HTB backlog
    collisions: torch.Tensor  # int32
    collision_where: torch.Tensor  # [2] int32
    sent: torch.Tensor  # int32
    enqueued: torch.Tensor  # int32
    fault_dropped: torch.Tensor  # int32
    fate: torch.Tensor | None = None  # [M] int32 (want_fate only)
    # want_flow only: the four [M] int32 channels sent, enqueued, rejected,
    # fault-killed; None for a channel no declared feature can fill
    flow: tuple | None = None


@dataclasses.dataclass(frozen=True)
class RunLanes:
    """Where the lanes of a run pack placed over the parts of a mesh lie
    (``sim/pack.py``): calendar lane l belongs to run ``run[l]`` and is lane
    ``lane[l]`` of that run's own layout (both ``[N]`` int64 on the owner's
    device)."""

    run: torch.Tensor
    lane: torch.Tensor


@dataclasses.dataclass
class Calendar:
    """The in-flight message store, bucketed by arrival tick mod L.

    payload: tuple of W planes, each [L, N·SLOTS] int32
    src:     [L, N·SLOTS] int32 — sender index +1, 0 = empty (None when
             the plan sets TRACK_SRC=False)
    valid:   [L, N·SLOTS] bool — the occupancy plane when src is None
    etick:   [L, N·SLOTS] int32 — enqueue tick per message (None unless
             the telemetry plane is built)
    mesh:    None, or the ``meshplan.TorchMesh`` whose shards split the
             lane axis: each plane is then a tuple with one ``[S_d, L,
             SLOTS·n_loc]`` tensor per mesh part (see :func:`to_shards`)
    """

    payload: tuple
    src: torch.Tensor | None
    valid: torch.Tensor | None
    etick: torch.Tensor | None = None
    slots: int = 4
    mesh: object = None

    @staticmethod
    def empty(
        horizon: int,
        n: int,
        slots: int,
        width: int,
        track_src: bool = True,
        track_etick: bool = False,
        *,
        device,
        mesh=None,
    ) -> "Calendar":
        if mesh is None:

            def z(dtype):
                return torch.zeros((horizon, n * slots), dtype=dtype, device=device)

        else:
            n_loc = n // mesh.size

            def z(dtype):
                return tuple(
                    torch.zeros((s1 - s0, horizon, slots * n_loc), dtype=dtype, device=d)
                    for d, s0, s1 in mesh.parts
                )

        return Calendar(
            payload=tuple(z(torch.int32) for _ in range(width)),
            src=z(torch.int32) if track_src else None,
            valid=None if track_src else z(torch.bool),
            etick=z(torch.int32) if track_etick else None,
            slots=slots,
            mesh=mesh,
        )

    @property
    def width(self) -> int:
        return len(self.payload)

    @property
    def occupancy_plane(self):
        return self.src if self.src is not None else self.valid

    @property
    def horizon(self) -> int:
        occ = self.occupancy_plane
        return occ.shape[0] if self.mesh is None else occ[0].shape[1]

    @property
    def n_loc(self) -> int:
        """Lanes a shard owns (all of them without a mesh)."""
        occ = self.occupancy_plane
        return (occ if self.mesh is None else occ[0]).shape[-1] // self.slots

    @property
    def lanes(self) -> int:
        return self.n_loc * (1 if self.mesh is None else self.mesh.size)

    def part(self, i: int) -> "Calendar":
        """Mesh part ``i``'s planes as an unmeshed calendar of ``[S_d·L,
        SLOTS·n_loc]`` views (writes land in this calendar)."""

        def v(planes):
            return None if planes is None else planes[i].view(-1, planes[i].shape[-1])

        return Calendar(
            payload=tuple(v(p) for p in self.payload),
            src=v(self.src),
            valid=v(self.valid),
            etick=v(self.etick),
            slots=self.slots,
        )


def to_shards(plane: torch.Tensor, mesh, slots: int) -> tuple:
    """A global ``[L, SLOTS·N]`` plane as a mesh's per-part ``[S_d, L,
    SLOTS·n_loc]`` tensors: shard s's local plane is the global
    ``[L, SLOTS, N][:, :, s·n_loc:(s+1)·n_loc]``, laid out slot-major."""
    horizon, ns = plane.shape
    n = ns // slots
    n_loc = n // mesh.size
    x = plane.reshape(horizon, slots, mesh.size, n_loc).permute(2, 0, 1, 3)
    return tuple(
        x[s0:s1].to(d).reshape(s1 - s0, horizon, slots * n_loc).contiguous()
        for d, s0, s1 in mesh.parts
    )


def from_shards(parts, slots: int, device=None) -> torch.Tensor:
    """The inverse of :func:`to_shards`: the global ``[L, SLOTS·N]`` plane
    on ``device`` (the first part's by default)."""
    dev = parts[0].device if device is None else device
    x = torch.cat([p.to(dev) for p in parts])
    s, horizon, w = x.shape
    n_loc = w // slots
    return x.reshape(s, horizon, slots, n_loc).permute(1, 2, 0, 3).reshape(
        horizon, slots * s * n_loc
    )


def _lane_blocks(cal: Calendar, plane) -> list:
    """Each part of ``plane`` as ``(view [S_d, L·SLOTS, n_loc], lo, hi)``,
    the part's lanes being ``[lo, hi)`` (one block without a mesh)."""
    n_loc = cal.n_loc
    if cal.mesh is None:
        return [(plane.view(1, -1, n_loc), 0, n_loc)]
    return [
        (p.view(p.shape[0], -1, n_loc), s0 * n_loc, s1 * n_loc)
        for p, (_, s0, s1) in zip(plane, cal.mesh.parts)
    ]


def _own_lo(cal: Calendar) -> int:
    """The first lane a per-lane row of this process holds: its own first
    lane on a cohort, 0 otherwise."""
    if cal.mesh is None or not cal.mesh.cohort:
        return 0
    return cal.mesh.own_lanes(cal.lanes)[0]


def _all_lanes(x: torch.Tensor, mesh) -> torch.Tensor:
    """A cohort's placed ``[n_own]`` lane row as the whole ``[N]`` row:
    every rank's, in rank order (one ``all_gather``)."""
    from .distributed import all_gather_cat

    if x.dtype == torch.bool:  # gloo has no bool: its bytes cross
        return all_gather_cat(x.view(torch.uint8), mesh).view(torch.bool)
    return all_gather_cat(x, mesh)


def _row_at(cal: Calendar, plane, t: torch.Tensor) -> torch.Tensor:
    """Row ``t mod L`` of ``plane`` as the global ``[SLOTS, N]`` inbox
    layout (a cohort process: its own lanes'), without a host read."""
    b = torch.remainder(t.reshape(1), cal.horizon)
    if cal.mesh is None:
        return plane.index_select(0, b).view(cal.slots, -1)
    dev0 = cal.mesh.primary
    rows = [
        p.index_select(1, b.to(p.device))
        .view(p.shape[0], cal.slots, -1)
        .permute(1, 0, 2)
        .reshape(cal.slots, -1)
        .to(dev0)
        for p in plane
    ]
    return rows[0] if len(rows) == 1 else torch.cat(rows, dim=1)


def make_link_state(
    n: int,
    n_regions: int,
    default_shape,
    region_of=None,
    track_backlog: bool = False,
    n_rules: int = 0,
    *,
    device,
) -> LinkState:
    egress = (
        torch.tensor(default_shape, dtype=torch.float32, device=device)
        .reshape(-1, 1)
        .repeat(1, n)
    )
    if region_of is None:
        region_of = torch.zeros(n, dtype=torch.int32, device=device)
    return LinkState(
        egress=egress,
        filters=torch.full(
            (n_regions, n), FILTER_ACCEPT, dtype=torch.int32, device=device
        ),
        region_of=region_of.to(device=device, dtype=torch.int32),
        backlog=(
            torch.zeros(n, dtype=torch.float32, device=device)
            if track_backlog
            else None
        ),
        # all-zero = every rule unset (start 0 >= end 0): accept everything
        rules=(
            torch.zeros((n_rules, 3, n), dtype=torch.int32, device=device)
            if n_rules > 0
            else None
        ),
    )


def deliver(cal: Calendar, t: torch.Tensor) -> tuple[Calendar, Inbox]:
    """Pop the bucket arriving at tick ``t`` → inbox planes (payload
    [W, SLOTS, N], src/valid [SLOTS, N]). The bucket's occupancy row is
    zeroed for reuse at t+L (payload stays stale, masked). With provenance
    on, invalid slots read src = -1; without it, src = 0."""
    slots = cal.slots
    pop = pop_bucket if cal.mesh is None else pop_bucket_sharded
    cal, occ_row, pay_rows = pop(cal, t)
    n = occ_row.shape[0] // slots
    if cal.src is not None:
        row_v = occ_row != 0
        row_s = occ_row - 1
    else:
        row_v = occ_row
        row_s = torch.zeros_like(occ_row, dtype=torch.int32)
    inbox = Inbox(
        payload=torch.stack([r.reshape(slots, n) for r in pay_rows]),
        src=row_s.reshape(slots, n),
        valid=row_v.reshape(slots, n),
    )
    return cal, inbox


def _hash_salt(key) -> int:
    """``kd[0] ^ (kd[-1] * 0x9E3779B9)`` of the per-tick key (two uint32
    words as ints), as the uint32 bits of the reference's int32 salt
    (``net.py:697-698``)."""
    k0, k1 = (int(x) & _M32 for x in key)
    return (k0 ^ ((k1 * 0x9E3779B9) & _M32)) & _M32


def _mix(x: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer over uint32 values held in int64. The multipliers
    are the int32 forms of 0x85EBCA6B and 0xC2B2AE35: |x·c| < 2^63, so the
    int64 product never overflows, and its low 32 bits are the wrapped
    uint32 product."""
    x = x ^ (x >> 16)
    x = (x * -2048144789) & _M32
    x = x ^ (x >> 13)
    x = (x * -1028477387) & _M32
    return x ^ (x >> 16)


def purge_dst(cal: Calendar, dst_mask: torch.Tensor) -> tuple[Calendar, torch.Tensor]:
    """Remove every in-flight calendar entry destined to a masked lane —
    a crashed instance's socket buffers vanish with it
    (``testground_tpu/sim/net.py:416-448``). ``dst_mask`` is [N] bool over
    the receiver axis (a cohort process: over its own lanes). Only the
    occupancy plane is cleared, in place (payload words stay stale, like a
    bucket after ``deliver``); on a mesh each shard against its own lanes.
    Returns ``(cal, purged)``, ``purged`` the int32 count of entries
    removed (summed over a cohort's processes)."""
    purged = None
    base = _own_lo(cal)
    # positions are slot-major (slot·n_loc + lane): [S_d, L·SLOTS, n_loc]
    for view, lo, hi in _lane_blocks(cal, cal.occupancy_plane):
        mask = dst_mask[lo - base : hi - base].to(view.device).view(view.shape[0], 1, -1)
        kill = (view != 0) & mask
        k = kill.sum(dtype=torch.int32).to(dst_mask.device)
        purged = k if purged is None else purged + k
        view.masked_fill_(kill, 0)
    return cal, _cohort_sum(cal, purged)


def _cohort_sum(cal: Calendar, x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over a cohort's processes (itself otherwise)."""
    if cal.mesh is None or not cal.mesh.cohort:
        return x
    from .distributed import all_reduce_sum

    return all_reduce_sum(x, cal.mesh)


def purge_dst_matrix(
    cal: Calendar, dst_mask: torch.Tensor, group_of: torch.Tensor, gh: int
) -> tuple[Calendar, torch.Tensor, torch.Tensor]:
    """:func:`purge_dst` with per-(src group, dst group) attribution for the
    traffic-matrix plane (``testground_tpu/sim/net.py:450-490``): every
    purged message is charged to its (sender group, crashed receiver
    group) cell, the sender read as the global ``src - 1`` off the
    provenance plane. ``group_of`` is the [N] lane → matrix row map (host
    lanes on the hosts row; the whole map on a cohort, whose ``dst_mask``
    is over its own lanes), ``gh`` the matrix side. Returns ``(cal,
    purged, mat [gh, gh] int32)``, both summed over a cohort's processes;
    the occupancy plane is cleared in place."""
    if cal.src is None:
        raise ValueError("purge_dst_matrix needs a Calendar built with track_src=True")
    n = cal.lanes
    g = group_of.to(torch.int64)
    mat = torch.zeros(gh * gh, dtype=torch.int32, device=dst_mask.device)
    purged = None
    base = _own_lo(cal)
    for view, lo, hi in _lane_blocks(cal, cal.src):
        dev = view.device
        mask = dst_mask[lo - base : hi - base].to(dev).view(view.shape[0], 1, -1)
        kill = (view != 0) & mask
        k = kill.sum(dtype=torch.int32).to(dst_mask.device)
        purged = k if purged is None else purged + k
        gd = g.to(dev)
        # every cell gets an in-range index; only killed ones add 1
        idx = gd[(view - 1).clamp(0, n - 1)] * gh + gd[lo:hi].view(view.shape[0], 1, -1)
        m = mat if dev == mat.device else torch.zeros_like(mat, device=dev)
        m.scatter_add_(0, idx.reshape(-1), kill.reshape(-1).to(torch.int32))
        if m is not mat:
            mat += m.to(mat.device)
        view.masked_fill_(kill, 0)
    if cal.mesh is not None and cal.mesh.cohort:
        both = _cohort_sum(cal, torch.cat([purged.reshape(1), mat]))
        purged, mat = both[0], both[1:]
    return cal, purged, mat.view(gh, gh)


# cells a privatised count spreads over (see spread_offsets)
_SPREAD_CELLS = 8192


@functools.lru_cache(maxsize=8)
def spread_offsets(n: int, n_cells: int, device) -> tuple[int, torch.Tensor]:
    """A privatised count of an ``[..., n]`` index plane into ``n_cells``
    cells: element j adds into copy ``j mod P`` of the ``[P, n_cells]``
    buffer, so the atomic adds of a few hot cells spread over P addresses
    each, and one sum over the copies folds them. Returns ``(P, [n] int64
    offsets (j mod P)·n_cells)``, built once per shape and device. Integer
    adds are exact in any order."""
    p = max(1, min(n, _SPREAD_CELLS // n_cells))
    return p, torch.remainder(torch.arange(n, device=device), p) * n_cells


@functools.lru_cache(maxsize=8)
def _bin_edges(n_bins: int, device: str) -> torch.Tensor:
    """Lower edges of bins 1.. of the delivery-latency histogram, 2^1 ..
    2^(n_bins-1) ticks, built once per device."""
    return torch.tensor([1 << e for e in range(1, n_bins)], dtype=torch.int32,
                        device=device)


def latency_histogram(
    cal: Calendar,
    inbox: Inbox,
    t: torch.Tensor,
    group_of: torch.Tensor,
    n_groups: int,
    n_bins: int,
) -> torch.Tensor:
    """Per-receiver-group histogram of the delivery latency of the bucket
    delivered at tick ``t`` → ``[n_groups, n_bins]`` int32
    (``testground_tpu/sim/net.py:493-542``).

    Latency = ``t - etick`` of the delivered row; bin b counts delays in
    [2^b, 2^(b+1)) ticks by integer edge compares, the last bin open-ended.
    ``group_of`` is the [N] receiver lane → group map: a lane mapped to
    ``n_groups`` (an additional host) counts into a trash row that is
    sliced off, and invalid inbox slots add 0, so ``sum(hist)`` is exactly
    the plan messages delivered. ``deliver`` clears only the occupancy
    plane, so the etick row may be read before or after it. On a cohort
    the inbox, the map and the histogram are the process's own lanes'."""
    if cal.etick is None:
        raise ValueError("latency_histogram needs a Calendar built with track_etick=True")
    n = inbox.valid.shape[-1]
    t1 = t.reshape(1)
    row = _row_at(cal, cal.etick, t)
    binidx = torch.bucketize(t1 - row, _bin_edges(n_bins, str(row.device)),
                             out_int32=True, right=True)
    cells = (n_groups + 1) * n_bins
    p, spread = spread_offsets(n, cells, str(row.device))
    idx = (group_of.to(torch.int64) * n_bins + spread)[None, :] + binidx
    hist = torch.zeros(p * cells, dtype=torch.int32, device=row.device)
    hist.scatter_add_(0, idx.reshape(-1), inbox.valid.reshape(-1).to(torch.int32))
    hist = hist.view(p, cells).sum(0, dtype=torch.int32)
    return hist[: n_groups * n_bins].view(n_groups, n_bins)


def enqueue(
    cal: Calendar,
    link: LinkState,
    dst: torch.Tensor,  # [O, N] int32
    payload: torch.Tensor,  # [O, W, N] int32
    valid: torch.Tensor,  # [O, N] bool
    t: torch.Tensor,  # one-element int32, on the planes' device
    tick_ms: float,
    key: tuple[int, int],
    slot_mode: str = "sorted",
    features: tuple = FULL_SHAPING,
    control_start: int | None = None,
    stacking: bool = True,
    bw_queue_cap: int = 128,
    validate: bool = False,
    faults=None,
    dead: torch.Tensor | None = None,
    tick: int | None = None,
    want_fate: bool = False,
    want_flow: bool = False,
    dice_idx: torch.Tensor | None = None,
    runs: int = 1,
    run_lanes: RunLanes | None = None,
) -> tuple[Calendar, NetFeedback]:
    """Shape + schedule this tick's sends (message m = o·N + src) into the
    calendar; returns ``(cal, NetFeedback)`` with the planes updated in
    place. ``key`` is the per-tick link key (two uint32 words). Semantics
    and argument meanings are the reference ``enqueue``'s
    (``testground_tpu/sim/net.py:545``):

    - ``control_start``: lanes at indices ≥ it are control-route endpoints
      (additional hosts); traffic to or from them bypasses filters, every
      shaping feature and every fault, and rides the 1-tick floor.
    - ``faults``: a :class:`~.faults.FaultSchedule`, or its
      :class:`~.faults.DeviceFaults` lowering (the engine lowers once per
      program); its windows are resolved at ``tick``, the host's copy of
      ``t`` (read off ``t`` when not given).
    - ``dead``: [N] bool, lanes crashed by the fault plane; traffic to or
      from them is killed and counted in ``fault_dropped``.
    - ``want_fate``: also return ``NetFeedback.fate``, the per-message
      transport fate in outbox order (-1 not sent, 0 enqueued, 1
      rejected, 2 fault-dropped, 3 dropped).
    - ``want_flow``: also return ``NetFeedback.flow``, the traffic-matrix
      plane's per-message counts in outbox order, the rows of the
      reference's ``[4, M]``: copies sent, copies enqueued (a duplicate and
      its original add up), rejected, fault-dropped. The last two are None
      when no filter, respectively no fault term or dead mask, is given:
      they would be all zero.
    - ``dice_idx``: ``[O·N]`` int32 message indices the shaping dice hash
      in place of the flat index (shape bucketing: the exact run's
      indices, so every stochastic draw matches an unpadded run's). The
      slot ranks, the fate and the flow keep the flat index.
    - ``runs``: a run pack's run axis (``sim/pack.py``). The lanes are
      ``runs`` equal blocks laid out run-major, no message crosses a
      block, and ``key`` is then an ``[O·N]`` int64 tensor of per-message
      hash salts (each message's run's link key). Every count of the
      feedback (``sent``, ``enqueued``, ``clamped``, ``bw_dropped``,
      ``fault_dropped``, ``collisions``) is then ``[runs]`` int32 and
      ``collision_where`` ``[runs, 2]``, each run's as its own run would
      count it. Ranks are unchanged: a destination's senders all belong
      to its run and keep their relative order in the flat index.
    - ``run_lanes``: a run pack placed over a mesh's parts, on a part's
      calendar (:class:`RunLanes`): its lanes are no longer run-major
      blocks, so each count is summed by the run its lane names, a filter
      rule reads its destination's lane within its run, and the first
      collision of a run is its run's least over every part.

    On a cohort's calendar the outbox, ``link``, ``dead`` and ``dice_idx``
    are this process's own senders' (``[O, n_own]``, ``[n_own]``,
    ``[O·n_own]``) and so are the feedback's ``rejected``, ``backlog``,
    ``fate`` and ``flow``; its counts and ``collision_where`` are the
    whole cohort's. Every process calls it in lockstep."""
    width = cal.width
    horizon, n = cal.horizon, cal.lanes
    o, n_src = valid.shape
    placed = cal.mesh is not None and cal.mesh.cohort
    lo, hi = cal.mesh.own_lanes(n) if placed else (0, n)
    n_own = hi - lo
    if n_src != n_own:
        raise ValueError(f"outbox lane count {n_src} != calendar lanes {n_own}")
    if placed and runs != 1 and run_lanes is None:
        raise ValueError("a run pack's enqueue on a placed calendar needs its run_lanes")
    dev = valid.device
    i32 = torch.int32

    midx = torch.arange(o * n_own, dtype=i32, device=dev)
    src_l = midx if o == 1 else torch.remainder(midx, n_own)
    slot_in_src = torch.div(midx, n_own, rounding_mode="floor")
    # message m = o·N + src, its sender global: on a cohort the single
    # run's index of each of this process's messages
    src_f, gidx = src_l, midx
    if placed:
        if 2 * o * n >= 2**31:
            raise ValueError(
                f"a cohort's message index {2 * o * n:,} overflows int32"
            )
        src_f = src_l + lo
        gidx = slot_in_src * n + src_f
    dst_f = dst.reshape(-1)
    pay_w = [payload[:, w, :].reshape(-1) for w in range(width)]
    val_f = valid.reshape(-1)
    val0 = val_f
    m = val_f.shape[0]
    n_run = n // runs
    # a placed pack's own senders' runs, per message row
    run_src = run_lanes.run[lo:hi] if placed and runs != 1 else None

    def count(x):
        """A per-message (or per-lane) mask's total, per run of a pack."""
        if runs == 1:
            return x.sum(dtype=i32)
        if run_src is not None:
            rows = run_src.repeat(x.shape[0] // n_own)
            return torch.zeros(runs, dtype=i32, device=dev).index_add_(0, rows, x.to(i32))
        return x.view(-1, runs, n_run).sum(dim=(0, 2), dtype=i32)

    sent = count(val_f)
    sent_m = val0.to(i32) if want_flow else None

    def srow(row):  # src-indexed [N] row → per message: an o-fold tile
        return row if o == 1 else row.repeat(o)

    def eg(plane):
        return srow(link.egress[plane])

    # per-feature dice: murmur3 finalizer of (message index, per-tick key
    # salt, feature id), exactly the reference's int32 hash (net.py:
    # 696-736) computed on uint32 values in int64
    salt = key if isinstance(key, torch.Tensor) else _hash_salt(key)
    iota_m = gidx if dice_idx is None else dice_idx
    h0 = (iota_m.to(torch.int64) * 0x9E3779B1 + salt) & _M32

    def uhash_id(fid):
        # feature ids 1..len(FULL_SHAPING) are the shaping knobs; the
        # fault plane's loss bursts draw from the ids past that range
        return _mix((h0 + ((fid * 0x9E3779B9) & _M32)) & _M32)

    def uhash(feat):
        return uhash_id(1 + FULL_SHAPING.index(feat))

    def u(feat):
        return (uhash(feat) >> 8).to(torch.float32) * (2.0**-24)

    dst_safe = dst_f.clamp(0, n - 1)
    val_f = val_f & (dst_f >= 0) & (dst_f < n)

    # --- control routes: host-lane traffic is exempt from everything below
    is_ctrl = None
    if control_start is not None:
        is_ctrl = (dst_safe >= control_start) | (src_f >= control_start)

    # --- filters: per-(src instance, dst region) dense table, or
    # per-src range-rule lists over dst indices (first match wins)
    action = None
    if "filters" in features:
        n_regions = link.filters.shape[0]
        # the destinations' regions: a cohort's whole row, gathered
        region_of = None
        if n_regions > 1:
            region_of = _all_lanes(link.region_of, cal.mesh) if placed else link.region_of
        if n_regions == 1:
            action = srow(link.filters[0])
        elif n_regions <= 4:
            region = region_of[dst_safe]
            action = torch.zeros(m, dtype=i32, device=dev)
            for r in range(n_regions):
                action = torch.where(region == r, srow(link.filters[r]), action)
        else:
            flat_idx = region_of[dst_safe].to(torch.int64) * n_own + src_l
            action = link.filters.reshape(-1)[flat_idx]
    elif "filter_rules" in features:
        if link.rules is None:
            raise ValueError(
                "filter_rules shaping needs a LinkState built with n_rules>0"
            )
        action = torch.full((m,), FILTER_ACCEPT, dtype=i32, device=dev)
        matched = torch.zeros(m, dtype=torch.bool, device=dev)
        # a pack's rules address their own run's lanes
        if runs == 1:
            dst_rule = dst_safe
        elif run_src is not None:
            dst_rule = run_lanes.lane[dst_safe]
        else:
            dst_rule = torch.remainder(dst_safe, n_run)
        for k in range(link.rules.shape[0]):
            # unset rules (start >= end) can never hit
            hit = (
                ~matched
                & (dst_rule >= srow(link.rules[k, 0]))
                & (dst_rule < srow(link.rules[k, 1]))
            )
            action = torch.where(hit, srow(link.rules[k, 2]), action)
            matched = matched | hit
    rej_m = None
    if action is not None:
        accept = action == FILTER_ACCEPT
        rejected_msg = val_f & (action == FILTER_REJECT)
        if is_ctrl is not None:
            accept = accept | is_ctrl
            rejected_msg = rejected_msg & ~is_ctrl
        val_f = val_f & accept
        rej_m = rejected_msg
        rejected = rejected_msg.reshape(o, n_own).sum(dim=0, dtype=i32)
    else:
        rejected = torch.zeros(n_own, dtype=i32, device=dev)

    # --- fault plane (net.py:817-863): scheduled kills after the filters
    # (the REJECT feedback a sender sees is fault-independent) and before
    # the shaping losses, so every fault kill lands in fault_dropped.
    # Only the windows open at this tick are evaluated: a closed window
    # contributes nothing to the reference's OR.
    zero = torch.zeros(() if runs == 1 else (runs,), dtype=i32, device=dev)
    fault_dropped = zero
    fault_m = None
    if faults is not None and not isinstance(faults, DeviceFaults):
        faults = DeviceFaults.lower(faults, dev, n, own=(lo, hi))
    if faults is not None and tick is None:
        tick = int(t)
    if faults is not None or dead is not None:
        if dead is not None:
            # the destinations' deaths: a cohort's whole row, gathered
            kill = srow(dead) | (_all_lanes(dead, cal.mesh) if placed else dead)[dst_safe]
        else:
            kill = torch.zeros(m, dtype=torch.bool, device=dev)
        if faults is not None:
            for e in faults.drops_at(tick):
                # a sender's own rows; a destination's off the whole masks
                a, b = faults.drop_a[e], faults.drop_b[e]
                hit = srow(faults.own(a)) & b[dst_safe]
                if faults.sched.drop_sym[e]:
                    hit = hit | (srow(faults.own(b)) & a[dst_safe])
                kill = kill | hit
            for e in faults.losses_at(tick):
                # independent dice per loss window (ids past the shaping
                # range); the same murmur3 finalizer as the netem draws
                uf = (uhash_id(1 + len(FULL_SHAPING) + int(e)) >> 8).to(
                    torch.float32
                ) * (2.0**-24)
                lossy = uf * 100.0 < float(faults.sched.loss_pct[e])
                kill = kill | (lossy & srow(faults.loss_masks[e]))
        if is_ctrl is not None:
            kill = kill & ~is_ctrl
        fault_m = val_f & kill
        fault_dropped = count(fault_m)
        val_f = val_f & ~fault_m

    # --- bandwidth, admission-cap semantics (the HTB queue below
    # supersedes it when declared)
    if "bandwidth" in features and "bandwidth_queue" not in features:
        bw = eg(BANDWIDTH)
        cap = torch.where(
            bw <= 0.0,
            torch.full_like(bw, float(o)),
            torch.floor(bw * (tick_ms / 1000.0) / MSG_BYTES),
        )
        admit = slot_in_src.to(torch.float32) < cap
        val_f = val_f & (admit if is_ctrl is None else admit | is_ctrl)

    # --- loss
    if "loss" in features:
        keep = u("loss") * 100.0 >= eg(LOSS)
        val_f = val_f & (keep if is_ctrl is None else keep | is_ctrl)

    # --- corrupt: flip one random bit of payload word 0
    if "corrupt" in features:
        hc = uhash("corrupt")
        corrupt = (hc >> 8).to(torch.float32) * (2.0**-24) * 100.0 < eg(
            CORRUPT
        )
        if is_ctrl is not None:
            corrupt = corrupt & ~is_ctrl
        bit = torch.remainder(hc & 0xFF, 31).to(i32)
        flipped = pay_w[0] ^ torch.bitwise_left_shift(torch.ones_like(bit), bit)
        pay_w[0] = torch.where(corrupt, flipped, pay_w[0])

    # --- latency + jitter → delay in ticks; reorder = skip the queue
    delay_ms = eg(LATENCY)
    if "jitter" in features:
        delay_ms = delay_ms + eg(JITTER) * u("jitter")
    spikes = faults.latency_at(tick) if faults is not None else ()
    if len(spikes):
        # latency_spike windows: additive egress delay on the targeted
        # senders, summed in float32 in event order. The reference adds
        # 0.0 for each closed window, which changes no bit, so only the
        # open ones are added here
        extra = torch.zeros(n_own, dtype=torch.float32, device=dev)
        for e in spikes:
            extra = extra + torch.where(
                faults.lat_masks[e], float(faults.sched.lat_ms[e]), 0.0
            )
        per_msg = srow(extra)
        if is_ctrl is not None:
            per_msg = torch.where(is_ctrl, 0.0, per_msg)
        delay_ms = delay_ms + per_msg
    delay = torch.ceil(delay_ms / tick_ms).to(i32).clamp_min(1)
    if "reorder" in features:
        reorder = u("reorder") * 100.0 < eg(REORDER)
        delay = torch.where(reorder, torch.ones_like(delay), delay)

    # --- bandwidth, HTB-queue semantics (net.py:924-986): each src's
    # egress is a FIFO served at B·tick_s/MSG_BYTES msgs/tick; a message
    # deferred k service-ticks arrives k ticks later, and only a full
    # queue (bw_queue_cap messages) tail-drops. The float32 expressions
    # keep the reference's order of operations.
    bw_dropped = zero
    new_backlog = link.backlog
    if "bandwidth_queue" in features:
        if link.backlog is None:
            raise ValueError(
                "bandwidth_queue shaping needs a LinkState built with "
                "track_backlog=True"
            )
        bw = eg(BANDWIDTH)
        rate = bw * (tick_ms / 1000.0) / MSG_BYTES
        safe_rate = rate.clamp_min(1e-9)
        queued = val_f & (bw > 0.0)
        if is_ctrl is not None:
            queued = queued & ~is_ctrl
        qmask = queued.reshape(o, n_own).to(torch.float32)
        ahead = (torch.cumsum(qmask, dim=0) - qmask).reshape(-1)
        backlog_m = srow(link.backlog)
        q_msgs = backlog_m * rate + ahead
        overflow_q = queued & (q_msgs >= float(bw_queue_cap))
        bw_dropped = count(overflow_q)
        val_f = val_f & ~overflow_q
        queued = queued & ~overflow_q
        dt = torch.floor(backlog_m + ahead / safe_rate + 1e-4).to(i32)
        delay = delay + torch.where(queued, dt, torch.zeros_like(dt))
        admitted = queued.reshape(o, n_own).to(torch.float32).sum(dim=0)
        bw_src = link.egress[BANDWIDTH]
        rate_src = (bw_src * (tick_ms / 1000.0) / MSG_BYTES).clamp_min(1e-9)
        new_backlog = torch.where(
            bw_src <= 0.0,
            torch.zeros_like(bw_src),
            (link.backlog + admitted / rate_src - 1.0).clamp_min(0.0),
        )

    if is_ctrl is not None:  # control routes ride at the 1-tick floor
        delay = torch.where(is_ctrl, torch.ones_like(delay), delay)

    # --- calendar-horizon overflow is counted, then clamped
    clamped = count(val_f & (delay > horizon - 1))
    delay = delay.clamp(1, horizon - 1)

    def fate_of(survived):
        """Per-message fate in outbox order (net.py:998-1013): dropped by
        default, overridden by fault kills, then rejects, then survival."""
        if not want_fate:
            return None
        f = torch.full((m,), 3, dtype=i32, device=dev)
        if fault_m is not None:
            f = torch.where(fault_m, 2, f)
        if rej_m is not None:
            f = torch.where(rej_m, 1, f)
        f = torch.where(survived, 0, f)
        return torch.where(val0, f, -1).to(i32)

    def flow_of(enq_m):
        """Per-message flow counts in outbox order (net.py:1015-1029);
        ``enq_m`` holds each message's enqueued copies (0/1, or 0-2 with
        duplicates)."""
        if not want_flow:
            return None
        return (sent_m, enq_m.to(i32),
                None if rej_m is None else rej_m.to(i32),
                None if fault_m is None else fault_m.to(i32))

    def feedback(enqueued, fate, flow=None, collisions=None, where=None):
        counts = (clamped, bw_dropped, sent, enqueued, fault_dropped,
                  zero if collisions is None else collisions)
        if placed:  # this process's counts, summed over the cohort
            from .distributed import all_reduce_sum

            counts = all_reduce_sum(torch.stack(counts), cal.mesh).unbind(0)
        return NetFeedback(
            rejected=rejected,
            clamped=counts[0],
            bw_dropped=counts[1],
            backlog=new_backlog,
            collisions=counts[5],
            collision_where=(
                torch.zeros(zero.shape + (2,), dtype=i32, device=dev)
                if where is None else where
            ),
            sent=counts[2],
            enqueued=counts[3],
            fault_dropped=counts[4],
            fate=fate,
            flow=flow,
        )

    if slot_mode == "direct":
        buck = torch.remainder(t.reshape(()) + delay, horizon)
        occ_vals = src_f + 1
        count_in = count
        if placed:  # the messages of this process's destinations
            got, _ = _exchange(cal, val_f, dst_safe, [dst_safe, buck, gidx, occ_vals, *pay_w])
            dst_safe, buck, gm, occ_vals = got[:4].unbind(0)
            pay_w = list(got[4:].unbind(0))
            slot_in_src = torch.div(gm, n, rounding_mode="floor")
            val_in = torch.ones_like(dst_safe, dtype=torch.bool)
            if run_src is not None:  # a received message counts for its run

                def count_in(x, run=run_lanes.run[dst_safe]):
                    return torch.zeros(runs, dtype=i32, device=dev).index_add_(
                        0, run, x.to(i32))
        else:
            val_in = val_f
        enq, collisions, where = _commit_direct(
            cal, t, buck, val_in, slot_in_src, dst_safe, occ_vals, pay_w, o, validate,
            count_in, runs, run_lanes if run_src is not None else None,
        )
        return cal, feedback(enq, fate_of(val_f), flow_of(val_f), collisions, where)

    # --- duplicate: a second copy one tick later (clipped at the horizon,
    # and counted as clamped when that shortens its delay); a copy shares
    # its original's index for the fate and the flow
    orig = midx
    if "duplicate" in features:
        dup = val_f & (u("duplicate") * 100.0 < eg(DUPLICATE))
        if is_ctrl is not None:
            dup = dup & ~is_ctrl
        if want_fate or want_flow:
            orig = torch.cat([midx, midx])
        if placed:  # a copy's global index follows every original's
            gidx = torch.cat([gidx, gidx + o * n])
        sent = sent + count(dup)
        if want_flow:
            sent_m = sent_m + dup.to(i32)
        clamped = clamped + count(dup & (delay >= horizon - 1))
        dst_safe = torch.cat([dst_safe, dst_safe])
        pay_w = [torch.cat([p, p]) for p in pay_w]
        src_f = torch.cat([src_f, src_f])
        val_f = torch.cat([val_f, dup])
        delay = torch.cat([delay, (delay + 1).clamp(1, horizon - 1)])

    bucket = torch.remainder(t.reshape(()) + delay, horizon)

    # --- slot assignment: one stable sort by (bucket, dst); invalid
    # messages carry the key L·N and sort last. The commit (rank within
    # equal-key runs + the bucket's pre-tick fill, then every plane
    # write) is the K1 kernel. On a mesh the key is SHARD-major, (dst
    # shard, bucket, local dst): its equal-key classes are the
    # bucket-major key's, so the stable sort assigns the same slots, and
    # L·N is still one past its largest value.
    big = horizon * n
    if placed:
        cal, surv, enqueued = _commit_placed(
            cal, t, bucket, val_f, dst_safe, gidx, src_f, pay_w, stacking,
            want_fate or want_flow, 2 * o * n if "duplicate" in features else o * n,
            None if run_src is None else (runs, run_lanes.run),
        )
        fate = flow = None
        if surv is not None:
            surv = torch.zeros(m, dtype=i32, device=dev).scatter_add_(
                0, orig.to(torch.int64), surv)
            fate, flow = fate_of(surv > 0), flow_of(surv)
        return cal, feedback(enqueued, fate, flow)
    if cal.mesh is None:
        key = bucket * n + dst_safe
        commit = commit_calendar
    else:
        n_loc = cal.n_loc
        key = (
            torch.div(dst_safe, n_loc, rounding_mode="floor") * (horizon * n_loc)
            + bucket * n_loc
            + torch.remainder(dst_safe, n_loc)
        )
        commit = commit_calendar_sharded
    sort_key = torch.where(val_f, key, torch.full_like(dst_safe, big))
    sk, order = torch.sort(sort_key, stable=True)
    src_s = src_f[order]
    pay_s = [p[order].contiguous() for p in pay_w]
    occ_vals = src_s + 1 if cal.src is not None else torch.ones_like(src_s)
    cal, survived = commit(
        cal, sk.contiguous(), occ_vals.contiguous(), pay_s, t, stacking=stacking
    )
    fate = flow = None
    if want_fate or want_flow:
        # sorted survival back to outbox order. The flow counts copies
        # (add); the fate needs only "either copy made it", which the
        # count answers too, so one scatter serves both
        surv = torch.zeros(m, dtype=i32, device=dev).scatter_add_(
            0, orig[order].to(torch.int64), survived
        )
        fate = fate_of(surv > 0)
        flow = flow_of(surv)
    if runs == 1:
        enqueued = survived.sum(dtype=i32)
    else:
        # a sorted key's destination names its run; an invalid message's
        # key (L·N) names run 0 (the shard-major key: the last run) and
        # adds its zero survival there. A run's shards are consecutive in
        # the shard-major key, so its keys are one block of L·n_run
        if cal.mesh is None:
            run_of = torch.div(torch.remainder(sk, n), n_run, rounding_mode="floor")
        else:
            run_of = torch.div(sk, horizon * n_run, rounding_mode="floor").clamp_max(
                runs - 1)
        enqueued = torch.zeros(runs, dtype=i32, device=dev).index_add_(
            0, run_of, survived)
    return cal, feedback(enqueued, fate, flow)


def _exchange(cal: Calendar, val_f, dst_safe, cols: list) -> tuple:
    """A cohort's message exchange: this process's valid messages (``cols``,
    int32 columns over its outbox order) grouped by the rank of their
    destination, one count matrix gathered (a host read), then one padded
    ``all_gather``; returns ``(got [F, k], back)``: the messages of this
    process's destinations, sender rank by sender rank, each rank's in
    its outbox order, and ``back(x)``, which hands one int32 value per
    received message back to its sender (a ``[k_own]`` tensor over this
    process's messages, in ``cols`` order)."""
    from .distributed import all_gather, all_reduce_sum, gather_blocks

    mesh = cal.mesh
    bounds = mesh.rank_lanes(cal.lanes)
    procs = len(bounds)
    me = mesh.rank
    per = bounds[0][1]
    if all(hi - lo == per for lo, hi in bounds):
        drank = torch.div(dst_safe, per, rounding_mode="floor")
    else:  # a several-part mesh's parts may hold unequal lanes
        drank = torch.zeros_like(dst_safe)
        for lo, _ in bounds[1:]:
            drank += dst_safe >= lo
    drank = torch.where(val_f, drank, procs)
    _, perm = torch.sort(drank, stable=True)
    cnt = torch.bincount(drank, minlength=procs + 1)[:procs]
    every_cnt = all_gather(cnt, mesh).tolist()  # [sender][destination]
    sent = [sum(row) for row in every_cnt]
    sel = perm[: sent[me]]
    block = torch.stack([c[sel] for c in cols], dim=1)
    if max(sent) == 0:  # nothing crosses this tick
        every = block.new_zeros((procs, 0, len(cols)))
    else:
        every, _ = gather_blocks(block, sent, mesh)
    at = [sum(every_cnt[r][:me]) for r in range(procs)]
    got = torch.cat([every[r, at[r] : at[r] + every_cnt[r][me]] for r in range(procs)])

    def back(x: torch.Tensor) -> torch.Tensor:
        out = torch.zeros(val_f.shape[0], dtype=torch.int32, device=x.device)
        if max(sent) == 0:
            return out
        ret = torch.zeros(every.shape[:2], dtype=torch.int32, device=x.device)
        off = 0
        for r in range(procs):
            k = every_cnt[r][me]
            ret[r, at[r] : at[r] + k] = x[off : off + k]
            off += k
        all_reduce_sum(ret, mesh)
        return out.index_copy_(0, sel, ret[me, : sent[me]])

    return got.t(), back


def _commit_placed(cal, t, bucket, val_f, dst_safe, gidx, src_f, pay_w, stacking,
                   want_surv, m_all, runs=None):
    """A cohort's sorted commit: the messages of this process's
    destinations (:func:`_exchange`) sorted by the shard-major key, ties by
    global message index — the order the single run's stable sort gives
    them — and committed by the sharded K1 into this process's shards.
    Returns ``(cal, survived, enqueued)``: ``survived`` each of this
    process's messages' survival (0/1, None unless ``want_surv``),
    ``enqueued`` this process's destinations' count (a placed pack's,
    ``runs = (R, run of each calendar lane)``: per run)."""
    occ = src_f + 1 if cal.src is not None else torch.ones_like(src_f)
    got, back = _exchange(cal, val_f, dst_safe, [dst_safe, bucket, gidx, occ, *pay_w])
    d, bk, gm = got[0], got[1], got[2]
    n_loc, horizon = cal.n_loc, cal.horizon
    key = (torch.div(d, n_loc, rounding_mode="floor") * (horizon * n_loc)
           + bk * n_loc + torch.remainder(d, n_loc))
    # global message indices are distinct: one sort of (key, index)
    _, order = torch.sort(key.to(torch.int64) * m_all + gm.to(torch.int64))
    rows = got[:, order]
    cal, survived = commit_calendar_sharded(
        cal, key[order].contiguous(),
        rows[3].contiguous(), [r.contiguous() for r in rows[4:]], t, stacking=stacking,
    )
    if runs is None:
        enqueued = survived.sum(dtype=torch.int32)
    else:
        enqueued = torch.zeros(runs[0], dtype=torch.int32, device=survived.device).index_add_(
            0, runs[1][rows[0]], survived)
    if not want_surv:
        return cal, None, enqueued
    mine = torch.empty_like(survived).index_copy_(0, order, survived)
    return cal, back(mine), enqueued


def _commit_direct(cal, t, buck, val_f, slot_in_src, dst_safe, occ_vals, pay_w,
                   o, validate, count, runs=1, run_lanes=None):
    """Direct slot mode's write (``net.py:1031-1111``): slot = the sender's
    outbox index, one write per message, no sort and no duplicate pass.
    The reference drops an invalid message by scattering it to the
    out-of-range bucket ``horizon``; here it is masked out of the write.
    ``buck`` is each message's arrival bucket and ``occ_vals`` its
    occupancy mark (its sender + 1). On a cohort the messages are those of
    this process's destinations (:func:`_exchange`, ``val_f`` all set):
    its counts are its own (summed by the caller) and the first collision
    the cohort's least.
    Under ``validate``, same-tick duplicate targets and writes onto a
    still-occupied slot are counted, with the first colliding (dst, slot);
    which of two colliding writes lands is undefined on both backends.
    On a mesh message m lands in shard ``dst // n_loc`` at row bucket,
    position ``slot·n_loc + dst mod n_loc``; a device that holds several
    shards takes one write per plane. Returns ``(enqueued, collisions,
    collision_where)``, the last two None without ``validate``; ``count``
    totals a mask per run of a pack (``runs``), whose first collision is
    each run's own, its receiver run-local (a placed pack's, with its
    ``run_lanes``: the least over every part)."""
    slots = cal.slots
    horizon, n = cal.horizon, cal.lanes
    ns = n * slots
    i32 = torch.int32
    if o > slots:
        raise ValueError(
            f"direct slot mode needs OUT_MSGS ({o}) <= IN_MSGS ({slots})"
        )
    pos = slot_in_src * n + dst_safe
    if cal.mesh is not None:
        # the shard's [S_d·L, SLOTS·n_loc] plane: row s·L + bucket
        n_loc = cal.n_loc
        shard = torch.div(dst_safe, n_loc, rounding_mode="floor")
        row = shard * horizon + buck
        col = slot_in_src * n_loc + torch.remainder(dst_safe, n_loc)
    collisions = where = None
    if validate:
        big = horizon * ns
        lin = torch.where(val_f, buck.to(torch.int64) * ns + pos, big)
        # a stable argsort (jnp.argsort's default) maps sorted-adjacent
        # duplicates back to their messages, so a message that both
        # duplicates a key and lands on an occupied slot counts once
        ks, perm = torch.sort(lin, stable=True)
        dup = torch.zeros_like(val_f)
        dup[perm[1:]] = (ks[1:] == ks[:-1]) & (ks[1:] < big)
        if cal.mesh is None:
            occ = cal.occupancy_plane.reshape(-1)[lin.clamp_max(big - 1)] != 0
        else:
            occ = torch.zeros_like(val_f)
            for i, (dev, s0, s1) in enumerate(cal.mesh.parts):
                flat = cal.part(i).occupancy_plane.reshape(-1)
                idx = (row.to(torch.int64) - s0 * horizon) * (slots * n_loc) + col
                hit = flat[idx.clamp(0, flat.shape[0] - 1).to(dev)] != 0
                occ = occ | (hit.to(occ.device) & (shard >= s0) & (shard < s1))
        conflict = dup | (occ & val_f)
        collisions = count(conflict)
        first = torch.where(conflict, lin, big)
        if runs == 1:
            first = first.min() if first.numel() else torch.tensor(big, device=lin.device)
            if cal.mesh is not None and cal.mesh.cohort:
                from .distributed import all_reduce_min

                first = all_reduce_min(first.reshape(1), cal.mesh).reshape(())
        elif run_lanes is None:
            first = first.view(-1, runs, n // runs).amin(dim=(0, 2))
        else:
            from .distributed import all_reduce_min

            first = torch.full((runs,), big, dtype=first.dtype, device=first.device
                               ).scatter_reduce_(0, run_lanes.run[dst_safe], first, "amin")
            first = all_reduce_min(first, cal.mesh)
        p = torch.remainder(first, ns)
        lane = (torch.remainder(p, n // runs) if run_lanes is None
                else run_lanes.lane[torch.remainder(p, n)])
        where = torch.stack([lane, torch.div(p, n, rounding_mode="floor")], dim=-1).to(i32)
    keep = val_f.nonzero().squeeze(1)  # the write's one host sync
    if cal.mesh is None:
        writes = [(cal, keep, buck[keep], pos[keep])]
    else:
        parts = cal.mesh.parts
        writes = []
        for i, (dev, s0, s1) in enumerate(parts):
            sel = keep
            # a cohort process writes its own shards' messages only
            if len(parts) > 1 or cal.mesh.cohort:  # one more host sync a part
                sk = shard[keep]
                sel = keep[(sk >= s0) & (sk < s1)]
            writes.append((cal.part(i), sel, row[sel] - s0 * horizon, col[sel]))
    for part, sel, b, p in writes:
        dev = part.occupancy_plane.device
        b, p = b.to(dev, torch.int64), p.to(dev, torch.int64)
        for plane, vals in zip(part.payload, pay_w):
            plane.index_put_((b, p), vals[sel].to(dev))
        if part.src is not None:  # src+1 doubles as the occupancy mark
            part.src.index_put_((b, p), occ_vals[sel].to(dev))
        else:
            part.valid.index_put_((b, p), torch.ones_like(b, dtype=torch.bool))
        if part.etick is not None:
            part.etick.index_put_((b, p), t.reshape(()).to(dev, i32).expand(b.shape[0]))
    return count(val_f), collisions, where


def apply_net_updates(
    link: LinkState,
    net_shape: torch.Tensor,  # [7, N]
    net_shape_valid: torch.Tensor,  # [N]
    net_filters: torch.Tensor,  # [R, N]
    net_filters_valid: torch.Tensor,  # [N]
    net_region: torch.Tensor | None = None,  # [N] int32
    net_region_valid: torch.Tensor | None = None,  # [N]
    net_rules: torch.Tensor | None = None,  # [K, 3, N] int32
    net_rules_valid: torch.Tensor | None = None,  # [N]
) -> LinkState:
    """Apply per-instance network reconfigurations emitted by steps, with
    one-tick turnaround (``pkg/sidecar/sidecar_handler.go:49-82``). A valid
    rule emission replaces the instance's whole rule list; the HTB backlog
    has no reconfiguration surface and carries over."""
    egress = torch.where(net_shape_valid[None, :], net_shape, link.egress)
    filters = link.filters
    if link.filters.shape[0] > 0 and net_filters.shape[0] > 0:
        filters = torch.where(net_filters_valid[None, :], net_filters, filters)
    region_of = link.region_of
    if net_region is not None and net_region_valid is not None:
        region_of = torch.where(net_region_valid, net_region, region_of)
    rules = link.rules
    if net_rules is not None and net_rules_valid is not None:
        if rules is None:
            raise ValueError(
                "net_rules update against a LinkState without rule planes "
                "(n_rules=0) — declare 'filter_rules' shaping"
            )
        if net_rules.shape[0] != rules.shape[0]:
            raise ValueError(
                f"net_rules K={net_rules.shape[0]} != LinkState K={rules.shape[0]}"
            )
        rules = torch.where(net_rules_valid[None, None, :], net_rules, rules)
    return dataclasses.replace(
        link, egress=egress, filters=filters, region_of=region_of, rules=rules
    )
