"""The simulated data network over torch: link shaping + calendar transport.

Port of ``testground_tpu/sim/net.py`` (read its module docstring for the
model). In-flight messages live in a calendar queue of ``[L, N·SLOTS]``
planes indexed by arrival tick mod L, with positions ``slot·N + dst``; the
``LinkShape`` knobs are arithmetic applied at send time.

What this module ports: the 2-D plane form of :class:`Calendar` (the flat
form is an XLA:TPU layout choice), :class:`LinkState`,
:class:`NetFeedback`, :func:`make_link_state`, :func:`deliver`, the sorted
path of :func:`enqueue` with the latency, jitter, bandwidth (admission
cap), loss, corrupt, reorder and filters features, and
:func:`apply_net_updates`. The commit of the sorted stream and the
delivery pop go through the kernels of ``sim/cuda_transport.py`` (plain
versions on the CPU). Everything else raises ``NotImplementedError``
naming the ROADMAP item that ports it.

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

import torch

from .api import FILTER_ACCEPT, FILTER_REJECT, Inbox
from .cuda_transport import commit_calendar, pop_bucket

__all__ = [
    "FULL_SHAPING",
    "SHAPING_NO_DUPLICATE",
    "Calendar",
    "LinkState",
    "NetFeedback",
    "apply_net_updates",
    "deliver",
    "enqueue",
    "make_link_state",
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

# Shaping features whose port is still to come, with their ROADMAP item.
UNPORTED_SHAPING = {
    "duplicate": "ROADMAP queue 1 item 4 (duplicate)",
    "bandwidth_queue": "ROADMAP queue 1 item 4 (filter_rules and bandwidth_queue)",
    "filter_rules": "ROADMAP queue 1 item 4 (filter_rules and bandwidth_queue)",
}

_M32 = 0xFFFFFFFF


@dataclasses.dataclass
class LinkState:
    """Per-instance egress shaping + per-(instance, dst-region) filters:
    ``egress [7, N]`` float32, ``filters [R, N]`` int32, ``region_of [N]``
    int32 (see the reference ``LinkState``)."""

    egress: torch.Tensor
    filters: torch.Tensor
    region_of: torch.Tensor


@dataclasses.dataclass
class NetFeedback:
    """Per-tick transport feedback from :func:`enqueue` (the reference
    ``NetFeedback`` minus the planes this slice does not build)."""

    rejected: torch.Tensor  # [N] int32
    clamped: torch.Tensor  # int32
    bw_dropped: torch.Tensor  # int32
    collisions: torch.Tensor  # int32
    collision_where: torch.Tensor  # [2] int32
    sent: torch.Tensor  # int32
    enqueued: torch.Tensor  # int32
    fault_dropped: torch.Tensor  # int32


@dataclasses.dataclass
class Calendar:
    """The in-flight message store, bucketed by arrival tick mod L.

    payload: tuple of W planes, each [L, N·SLOTS] int32
    src:     [L, N·SLOTS] int32 — sender index +1, 0 = empty (None when
             the plan sets TRACK_SRC=False)
    valid:   [L, N·SLOTS] bool — the occupancy plane when src is None
    etick:   [L, N·SLOTS] int32 — enqueue tick per message (None unless
             the telemetry plane is built)
    """

    payload: tuple
    src: torch.Tensor | None
    valid: torch.Tensor | None
    etick: torch.Tensor | None = None
    slots: int = 4

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
    ) -> "Calendar":
        shape = (horizon, n * slots)

        def z(dtype):
            return torch.zeros(shape, dtype=dtype, device=device)

        return Calendar(
            payload=tuple(z(torch.int32) for _ in range(width)),
            src=z(torch.int32) if track_src else None,
            valid=None if track_src else z(torch.bool),
            etick=z(torch.int32) if track_etick else None,
            slots=slots,
        )

    @property
    def width(self) -> int:
        return len(self.payload)

    @property
    def occupancy_plane(self) -> torch.Tensor:
        return self.src if self.src is not None else self.valid


def make_link_state(
    n: int, n_regions: int, default_shape, region_of=None, *, device
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
    )


def deliver(cal: Calendar, t: torch.Tensor) -> tuple[Calendar, Inbox]:
    """Pop the bucket arriving at tick ``t`` → inbox planes (payload
    [W, SLOTS, N], src/valid [SLOTS, N]). The bucket's occupancy row is
    zeroed for reuse at t+L (payload stays stale, masked). With provenance
    on, invalid slots read src = -1; without it, src = 0."""
    slots = cal.slots
    cal, occ_row, pay_rows = pop_bucket(cal, t)
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
) -> tuple[Calendar, NetFeedback]:
    """Shape + schedule this tick's sends (message m = o·N + src) into the
    calendar; returns ``(cal, NetFeedback)`` with the planes updated in
    place. ``key`` is the per-tick link key (two uint32 words). Semantics
    and argument meanings are the reference ``enqueue``'s
    (``testground_tpu/sim/net.py:545``), sorted slot path."""
    if slot_mode != "sorted":
        raise NotImplementedError(
            "SLOT_MODE='direct' is not ported yet: ROADMAP queue 1 item 4 "
            "(direct slot mode with validate)"
        )
    for feat, item in UNPORTED_SHAPING.items():
        if feat in features:
            raise NotImplementedError(
                f"{feat!r} shaping is not ported yet: {item}"
            )
    if control_start is not None:
        raise NotImplementedError(
            "control lanes (additional hosts) are not ported yet: ROADMAP "
            "queue 1 item 4 (control lanes)"
        )
    slots = cal.slots
    width = cal.width
    horizon, ns = cal.occupancy_plane.shape
    n = ns // slots
    o, n_src = valid.shape
    if n_src != n:
        raise ValueError(f"outbox lane count {n_src} != calendar lanes {n}")
    dev = valid.device
    i32 = torch.int32

    midx = torch.arange(o * n, dtype=i32, device=dev)
    src_f = midx if o == 1 else torch.remainder(midx, n)
    slot_in_src = torch.div(midx, n, rounding_mode="floor")
    dst_f = dst.reshape(-1)
    pay_w = [payload[:, w, :].reshape(-1) for w in range(width)]
    val_f = valid.reshape(-1)
    m = val_f.shape[0]
    sent = val_f.sum(dtype=i32)

    def eg(plane):  # per-message egress attribute: an o-fold tile
        row = link.egress[plane]
        return row if o == 1 else row.repeat(o)

    # per-feature dice: murmur3 finalizer of (message index, per-tick key
    # salt, feature id), exactly the reference's int32 hash (net.py:
    # 696-736) computed on uint32 values in int64
    salt = _hash_salt(key)
    h0 = (midx.to(torch.int64) * 0x9E3779B1 + salt) & _M32

    def uhash(feat):
        fid_mix = ((1 + FULL_SHAPING.index(feat)) * 0x9E3779B9) & _M32
        return _mix((h0 + fid_mix) & _M32)

    def u(feat):
        return (uhash(feat) >> 8).to(torch.float32) * (2.0**-24)

    dst_safe = dst_f.clamp(0, n - 1)
    val_f = val_f & (dst_f >= 0) & (dst_f < n)

    # --- filters: per-(src instance, dst region) dense table
    if "filters" in features:
        n_regions = link.filters.shape[0]
        if n_regions == 1:
            action = link.filters[0] if o == 1 else link.filters[0].repeat(o)
        elif n_regions <= 4:
            region = link.region_of[dst_safe]
            action = torch.zeros(m, dtype=i32, device=dev)
            for r in range(n_regions):
                row = link.filters[r] if o == 1 else link.filters[r].repeat(o)
                action = torch.where(region == r, row, action)
        else:
            flat_idx = link.region_of[dst_safe].to(torch.int64) * n + src_f
            action = link.filters.reshape(-1)[flat_idx]
        rejected_msg = val_f & (action == FILTER_REJECT)
        val_f = val_f & (action == FILTER_ACCEPT)
        rejected = rejected_msg.reshape(o, n).sum(dim=0, dtype=i32)
    else:
        rejected = torch.zeros(n, dtype=i32, device=dev)

    # --- bandwidth, admission-cap semantics
    if "bandwidth" in features:
        bw = eg(BANDWIDTH)
        cap = torch.where(
            bw <= 0.0,
            torch.full_like(bw, float(o)),
            torch.floor(bw * (tick_ms / 1000.0) / MSG_BYTES),
        )
        val_f = val_f & (slot_in_src.to(torch.float32) < cap)

    # --- loss
    if "loss" in features:
        val_f = val_f & (u("loss") * 100.0 >= eg(LOSS))

    # --- corrupt: flip one random bit of payload word 0
    if "corrupt" in features:
        hc = uhash("corrupt")
        corrupt = (hc >> 8).to(torch.float32) * (2.0**-24) * 100.0 < eg(
            CORRUPT
        )
        bit = torch.remainder(hc & 0xFF, 31).to(i32)
        flipped = pay_w[0] ^ torch.bitwise_left_shift(torch.ones_like(bit), bit)
        pay_w[0] = torch.where(corrupt, flipped, pay_w[0])

    # --- latency + jitter → delay in ticks; reorder = skip the queue
    delay_ms = eg(LATENCY)
    if "jitter" in features:
        delay_ms = delay_ms + eg(JITTER) * u("jitter")
    delay = torch.ceil(delay_ms / tick_ms).to(i32).clamp_min(1)
    if "reorder" in features:
        reorder = u("reorder") * 100.0 < eg(REORDER)
        delay = torch.where(reorder, torch.ones_like(delay), delay)

    # --- calendar-horizon overflow is counted, then clamped
    clamped = (val_f & (delay > horizon - 1)).sum(dtype=i32)
    delay = delay.clamp(1, horizon - 1)

    bucket = torch.remainder(t.reshape(()) + delay, horizon)

    # --- slot assignment: one stable sort by (bucket, dst); invalid
    # messages carry the key L·N and sort last. The commit (rank within
    # equal-key runs + the bucket's pre-tick fill, then every plane
    # write) is the K1 kernel.
    big = horizon * n
    sort_key = torch.where(val_f, bucket * n + dst_safe, torch.full_like(dst_safe, big))
    sk, order = torch.sort(sort_key, stable=True)
    src_s = src_f[order]
    pay_s = [p[order].contiguous() for p in pay_w]
    occ_vals = src_s + 1 if cal.src is not None else torch.ones_like(src_s)
    cal, survived = commit_calendar(
        cal, sk.contiguous(), occ_vals.contiguous(), pay_s, t, stacking=stacking
    )
    zero = torch.zeros((), dtype=i32, device=dev)
    return cal, NetFeedback(
        rejected=rejected,
        clamped=clamped,
        bw_dropped=zero,
        collisions=zero,
        collision_where=torch.zeros(2, dtype=i32, device=dev),
        sent=sent,
        enqueued=survived.sum(dtype=i32),
        fault_dropped=zero,
    )


def apply_net_updates(
    link: LinkState,
    net_shape: torch.Tensor,  # [7, N]
    net_shape_valid: torch.Tensor,  # [N]
    net_filters: torch.Tensor,  # [R, N]
    net_filters_valid: torch.Tensor,  # [N]
    net_region: torch.Tensor | None = None,  # [N] int32
    net_region_valid: torch.Tensor | None = None,  # [N]
) -> LinkState:
    """Apply per-instance network reconfigurations emitted by steps, with
    one-tick turnaround (``pkg/sidecar/sidecar_handler.go:49-82``)."""
    egress = torch.where(net_shape_valid[None, :], net_shape, link.egress)
    filters = link.filters
    if link.filters.shape[0] > 0 and net_filters.shape[0] > 0:
        filters = torch.where(net_filters_valid[None, :], net_filters, filters)
    region_of = link.region_of
    if net_region is not None and net_region_valid is not None:
        region_of = torch.where(net_region_valid, net_region, region_of)
    return LinkState(egress=egress, filters=filters, region_of=region_of)
