"""The fault-injection plane: declared chaos schedules lowered to static
event tables.

The port's copy of ``testground_tpu/sim/faults.py`` (read its module
docstring for the model). A composition declares fault events — each with
a kind, a target selector and a start/duration in simulated milliseconds
— and :func:`build_fault_schedule` lowers them once, at program build,
into small numpy tables:

- ``crash`` / ``restart`` → (tick, [N] mask) point events applied at tick
  start (``sim/engine.py``): crash forces status CRASH, purges the
  instance's in-flight calendar rows and kills its future traffic;
  restart re-runs ``testcase.init`` for the slot and revives it.
- ``partition`` / ``link_flap`` / ``latency_spike`` / ``loss_burst`` →
  piecewise-constant windows layered over the link model at send time
  (``sim/net.py``).

Validation, lowering and its error messages are the reference's, line for
line. What differs is where a window is resolved. The reference evaluates
``crash_mask_at(t)`` and its siblings on the device against a traced tick;
here the tick is known on the host, so :class:`FaultSchedule`'s accessors
take a Python ``int`` and answer in numpy, and :class:`DeviceFaults` holds
the schedule's masks as bool tensors on the run's device, padded to the
lane count, built once per program. On a tick the schedule does not name,
nothing of the plane reaches the device.

A plan with no faults lowers to ``None``, and the engine then runs exactly
the program it runs without the plane.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = [
    "FAULT_KINDS",
    "DeviceFaults",
    "FaultSchedule",
    "build_fault_schedule",
    "parse_fault",
    "remap_schedule",
]

# Every supported nemesis kind. Point events (crash/restart) fire once at
# start_ms; window events hold for [start_ms, start_ms + duration_ms).
FAULT_KINDS = (
    "crash",
    "restart",
    "partition",
    "link_flap",
    "latency_spike",
    "loss_burst",
)
_WINDOW_KINDS = ("partition", "link_flap", "latency_spike", "loss_burst")

# Keys a fault table may carry — anything else is a typo'd schedule, and
# a silently-ignored key is a nemesis that never fires, so refuse loudly.
_KNOWN_KEYS = {
    "kind",
    "group",
    "instances",
    "fraction",
    "seed",
    "start_ms",
    "duration_ms",
    "latency_ms",
    "loss",
    "period_ms",
    "duty",
    "to_group",
    "to_instances",
    "bidirectional",
}


@dataclasses.dataclass(frozen=True)
class _Selector:
    """A resolved target selector: which instances a fault applies to."""

    group: str = ""  # group id; "" = whole run
    instances: str = ""  # half-open "lo:hi" range, group-relative
    fraction: float = 0.0  # seeded fraction of the candidate set
    seed: int = 0


def _parse_range(spec: str, what: str) -> tuple[int, int]:
    try:
        lo_s, hi_s = spec.split(":")
        lo, hi = int(lo_s), int(hi_s)
    except ValueError:
        raise ValueError(
            f"{what} range {spec!r} is not 'lo:hi' (half-open ints)"
        ) from None
    if lo < 0 or hi <= lo:
        raise ValueError(f"{what} range {spec!r} is empty or negative")
    return lo, hi


def _resolve_mask(sel: _Selector, groups, n: int, what: str) -> np.ndarray:
    """Selector → [N] bool mask over the global instance axis: the named
    group's slots (or all N), narrowed by an ``instances`` range
    (group-relative when a group is named), then a seeded ``fraction``
    (round half-up). A selection that is empty is refused."""
    mask = np.zeros((n,), bool)
    if sel.group:
        g = next((g for g in groups if g.id == sel.group), None)
        if g is None:
            raise ValueError(
                f"{what} targets unknown group {sel.group!r}; run "
                f"groups are {[g.id for g in groups]}"
            )
        lo, hi = g.offset, g.offset + g.count
    else:
        lo, hi = 0, n
    if sel.instances:
        rlo, rhi = _parse_range(sel.instances, what)
        if rhi > hi - lo:
            raise ValueError(
                f"{what} range {sel.instances!r} exceeds the "
                f"{hi - lo} instance(s) of its target"
            )
        lo, hi = lo + rlo, lo + rhi
    mask[lo:hi] = True
    if sel.fraction:
        idx = np.flatnonzero(mask)
        k = int(np.floor(sel.fraction * idx.size + 0.5))
        if k <= 0:
            raise ValueError(
                f"{what}: fraction {sel.fraction} of {idx.size} "
                "instance(s) selects nobody — raise the fraction or "
                "widen the target"
            )
        rng = np.random.default_rng(sel.seed)
        keep = rng.choice(idx, size=min(k, idx.size), replace=False)
        mask = np.zeros((n,), bool)
        mask[keep] = True
    if not mask.any():
        raise ValueError(f"{what} selects no instances")
    return mask


@dataclasses.dataclass(frozen=True)
class _Fault:
    """One validated fault event, still in milliseconds (pre-lowering)."""

    kind: str
    sel: _Selector
    start_ms: float
    duration_ms: float
    latency_ms: float = 0.0
    loss: float = 0.0
    period_ms: float = 0.0
    duty: float = 0.0
    to_sel: _Selector | None = None
    bidirectional: bool = True


def parse_fault(d: dict, default_group: str = "") -> _Fault:
    """Validate one raw ``[[...faults]]`` table → :class:`_Fault`.
    ``default_group`` scopes group-level declarations to their own group
    when no explicit ``group`` key is given; global declarations pass
    ``""`` (whole run)."""
    if not isinstance(d, dict):
        raise ValueError(f"fault entry must be a table, got {type(d).__name__}")
    unknown = set(d) - _KNOWN_KEYS
    if unknown:
        raise ValueError(
            f"fault entry has unknown key(s) {sorted(unknown)}; known "
            f"keys: {sorted(_KNOWN_KEYS)}"
        )
    kind = d.get("kind", "")
    if kind not in FAULT_KINDS:
        raise ValueError(
            f"unknown fault kind {kind!r}; kinds: {list(FAULT_KINDS)}"
        )
    start_ms = float(d.get("start_ms", -1.0))
    if start_ms < 0:
        raise ValueError(f"fault {kind}: start_ms is required and must be >= 0")
    duration_ms = float(d.get("duration_ms", 0.0))
    if kind in _WINDOW_KINDS and duration_ms <= 0:
        raise ValueError(
            f"fault {kind}: duration_ms > 0 is required (window fault)"
        )
    if kind not in _WINDOW_KINDS and duration_ms:
        raise ValueError(
            f"fault {kind}: duration_ms does not apply (point event — "
            "declare a matching restart/second event instead)"
        )
    fraction = float(d.get("fraction", 0.0))
    if fraction and not (0.0 < fraction <= 1.0):
        raise ValueError(f"fault {kind}: fraction {fraction} not in (0, 1]")
    sel = _Selector(
        group=str(d.get("group", "") or default_group),
        instances=str(d.get("instances", "")),
        fraction=fraction,
        seed=int(d.get("seed", 0)),
    )
    latency_ms = float(d.get("latency_ms", 0.0))
    loss = float(d.get("loss", 0.0))
    period_ms = float(d.get("period_ms", 0.0))
    duty = float(d.get("duty", 0.0))
    to_sel = None
    if kind == "latency_spike" and latency_ms <= 0:
        raise ValueError("fault latency_spike: latency_ms > 0 is required")
    if kind == "loss_burst" and not (0.0 < loss <= 100.0):
        raise ValueError("fault loss_burst: loss must be in (0, 100] percent")
    if kind == "link_flap":
        if period_ms < 0 or (period_ms > 0 and not (0.0 <= duty < 1.0)):
            raise ValueError(
                "fault link_flap: period_ms >= 0 and duty (fraction of "
                "each period the link is UP) in [0, 1) — period 0 means "
                "down for the whole window"
            )
    if kind == "partition":
        if not (d.get("to_group") or d.get("to_instances")):
            raise ValueError(
                "fault partition: the other side needs to_group and/or "
                "to_instances"
            )
        to_sel = _Selector(
            group=str(d.get("to_group", "")),
            instances=str(d.get("to_instances", "")),
        )
    return _Fault(
        kind=kind,
        sel=sel,
        start_ms=start_ms,
        duration_ms=duration_ms,
        latency_ms=latency_ms,
        loss=loss,
        period_ms=period_ms,
        duty=duty,
        to_sel=to_sel,
        bidirectional=bool(d.get("bidirectional", True)),
    )


@dataclasses.dataclass(frozen=True)
class FaultSchedule:
    """The lowered schedule: numpy event tables, one family per mechanism
    (field for field the reference's). Ticks are absolute; masks are over
    the plan instance axis [N] (host lanes never fault). ``drop_*`` unifies
    partition and link_flap: a message is killed while an entry is active
    and ``a[src] & b[dst]`` (plus the symmetric pair when ``sym``);
    flapping entries are active only in the DOWN phase of each period."""

    n: int
    crash_ticks: np.ndarray  # [Ec] int32
    crash_masks: np.ndarray  # [Ec, N] bool
    restart_ticks: np.ndarray  # [Er] int32
    restart_masks: np.ndarray  # [Er, N] bool
    drop_t0: np.ndarray  # [Ed] int32 (window start, inclusive)
    drop_t1: np.ndarray  # [Ed] int32 (window end, exclusive)
    drop_a: np.ndarray  # [Ed, N] bool
    drop_b: np.ndarray  # [Ed, N] bool
    drop_sym: tuple  # [Ed] bools
    drop_period: np.ndarray  # [Ed] int32 — 0: down all window
    drop_up: np.ndarray  # [Ed] int32 — ticks UP at each period start
    lat_t0: np.ndarray  # [El] int32
    lat_t1: np.ndarray  # [El] int32
    lat_masks: np.ndarray  # [El, N] bool (src side)
    lat_ms: np.ndarray  # [El] float32 additive egress latency
    loss_t0: np.ndarray  # [Eo] int32
    loss_t1: np.ndarray  # [Eo] int32
    loss_masks: np.ndarray  # [Eo, N] bool (src side)
    loss_pct: np.ndarray  # [Eo] float32
    last_event_tick: int  # run must not report done before this tick

    @property
    def has_crashes(self) -> bool:
        return self.crash_ticks.size > 0

    @property
    def has_restarts(self) -> bool:
        return self.restart_ticks.size > 0

    @property
    def has_drops(self) -> bool:
        return self.drop_t0.size > 0

    @property
    def has_latency(self) -> bool:
        return self.lat_t0.size > 0

    @property
    def has_loss(self) -> bool:
        return self.loss_t0.size > 0

    def summary(self) -> str:
        return (
            f"{self.crash_ticks.size} crash, {self.restart_ticks.size} "
            f"restart, {self.drop_t0.size} drop-window, "
            f"{self.lat_t0.size} latency-window, {self.loss_t0.size} "
            f"loss-window event(s), last at tick {self.last_event_tick}"
        )

    # -------------------------------------- per-tick resolution, on the host

    def crash_mask_at(self, t: int) -> np.ndarray:
        """[N] bool — instances whose crash event fires at tick ``t``."""
        hit = self.crash_ticks == t
        return np.any(self.crash_masks & hit[:, None], axis=0)

    def restart_mask_at(self, t: int) -> np.ndarray:
        hit = self.restart_ticks == t
        return np.any(self.restart_masks & hit[:, None], axis=0)

    def drop_active_at(self, t: int) -> np.ndarray:
        """[Ed] bool — which drop windows are killing traffic at tick
        ``t`` (window open, and in the DOWN phase for flapping entries)."""
        act = (t >= self.drop_t0) & (t < self.drop_t1)
        phase = np.mod(t - self.drop_t0, np.maximum(self.drop_period, 1))
        down = np.where(self.drop_period > 0, phase >= self.drop_up, True)
        return act & down

    def window_active_at(self, t: int, t0, t1) -> np.ndarray:
        return (t >= t0) & (t < t1)


def remap_schedule(
    sched: FaultSchedule, index_map: np.ndarray, n_phys: int
) -> FaultSchedule:
    """Re-target a schedule lowered over the exact (virtual) layout onto a
    padded physical instance axis: every per-lane mask scatters through
    ``index_map`` (virtual lane → physical lane), so selectors keep hitting
    the same instances and pad lanes are never selected. Ticks and window
    parameters pass through unchanged."""
    index_map = np.asarray(index_map, np.int32)
    if sched.n != index_map.size:
        raise ValueError(
            f"fault schedule lowered for {sched.n} instance(s) but the "
            f"bucket plan maps {index_map.size} — remap must run on the "
            "virtual-layout schedule"
        )

    def remap(masks: np.ndarray) -> np.ndarray:
        masks = np.asarray(masks, bool)
        out = np.zeros((masks.shape[0], n_phys), bool)
        if masks.size:
            out[:, index_map] = masks
        return out

    return dataclasses.replace(
        sched,
        n=n_phys,
        crash_masks=remap(sched.crash_masks),
        restart_masks=remap(sched.restart_masks),
        drop_a=remap(sched.drop_a),
        drop_b=remap(sched.drop_b),
        lat_masks=remap(sched.lat_masks),
        loss_masks=remap(sched.loss_masks),
    )


def _ticks(ms: float, tick_ms: float) -> int:
    # half-up (like the instance-percentage resolution), not banker's:
    # a 5 ms window at 2 ms/tick is 3 ticks, not 2
    return int(np.floor(ms / tick_ms + 0.5))


def build_fault_schedule(
    groups, faults_by_group: dict, tick_ms: float
) -> FaultSchedule | None:
    """Validate and lower every declared fault into one schedule.
    ``groups`` is the run's :class:`~testground_tpu_torch.sim.api.GroupSpec`
    layout; ``faults_by_group`` maps group id → list of raw fault tables
    (the key ``""`` holds run-global declarations). Returns ``None`` when
    nothing is declared."""
    n = sum(g.count for g in groups)
    parsed: list[_Fault] = []
    for gid, entries in sorted(faults_by_group.items()):
        for d in entries or ():
            parsed.append(parse_fault(d, default_group=gid))
    if not parsed:
        return None
    if tick_ms <= 0:
        raise ValueError(f"tick_ms must be positive, got {tick_ms}")

    crash_ticks, crash_masks = [], []
    restart_ticks, restart_masks = [], []
    drop_t0, drop_t1, drop_a, drop_b, drop_sym = [], [], [], [], []
    drop_period, drop_up = [], []
    lat_t0, lat_t1, lat_masks, lat_ms = [], [], [], []
    loss_t0, loss_t1, loss_masks, loss_pct = [], [], [], []
    last = 0
    for f in parsed:
        mask = _resolve_mask(f.sel, groups, n, f"fault {f.kind}")
        t0 = _ticks(f.start_ms, tick_ms)
        t1 = t0 + max(_ticks(f.duration_ms, tick_ms), 1)
        if f.kind == "crash":
            crash_ticks.append(t0)
            crash_masks.append(mask)
            last = max(last, t0)
        elif f.kind == "restart":
            restart_ticks.append(t0)
            restart_masks.append(mask)
            last = max(last, t0)
        elif f.kind == "partition":
            other = _resolve_mask(f.to_sel, groups, n, "fault partition:to")
            if (mask & other).any():
                raise ValueError(
                    "fault partition: the two sides overlap — an instance "
                    "cannot be partitioned from itself"
                )
            drop_t0.append(t0)
            drop_t1.append(t1)
            drop_a.append(mask)
            drop_b.append(other)
            drop_sym.append(f.bidirectional)
            drop_period.append(0)
            drop_up.append(0)
            last = max(last, t1)
        elif f.kind == "link_flap":
            drop_t0.append(t0)
            drop_t1.append(t1)
            drop_a.append(mask)
            # any traffic touching a flapped instance drops while down
            drop_b.append(np.ones((n,), bool))
            drop_sym.append(True)
            period = _ticks(f.period_ms, tick_ms) if f.period_ms else 0
            drop_period.append(max(period, 0))
            drop_up.append(int(np.floor(f.duty * period)) if period > 0 else 0)
            last = max(last, t1)
        elif f.kind == "latency_spike":
            lat_t0.append(t0)
            lat_t1.append(t1)
            lat_masks.append(mask)
            lat_ms.append(f.latency_ms)
            last = max(last, t1)
        elif f.kind == "loss_burst":
            loss_t0.append(t0)
            loss_t1.append(t1)
            loss_masks.append(mask)
            loss_pct.append(f.loss)
            last = max(last, t1)

    def arr(x, dtype):
        return np.asarray(x, dtype)

    def masks(x):
        return np.asarray(x, bool) if x else np.zeros((0, n), bool)

    # a restart landing on the same tick as a crash of the same instance
    # would be silently lost (restarts apply before crashes, and the slot
    # is still RUNNING when the restart mask is evaluated) — refuse it
    for ci, ct in enumerate(crash_ticks):
        for ri, rt in enumerate(restart_ticks):
            if ct == rt and (crash_masks[ci] & restart_masks[ri]).any():
                raise ValueError(
                    f"a crash and a restart both land on tick {ct} for "
                    "overlapping instances (start_ms values quantize to "
                    f"the same tick at tick_ms={tick_ms}) — separate "
                    "them by at least one tick; the restart would "
                    "otherwise be lost (crash wins within a tick)"
                )

    return FaultSchedule(
        n=n,
        crash_ticks=arr(crash_ticks, np.int32),
        crash_masks=masks(crash_masks),
        restart_ticks=arr(restart_ticks, np.int32),
        restart_masks=masks(restart_masks),
        drop_t0=arr(drop_t0, np.int32),
        drop_t1=arr(drop_t1, np.int32),
        drop_a=masks(drop_a),
        drop_b=masks(drop_b),
        drop_sym=tuple(drop_sym),
        drop_period=arr(drop_period, np.int32),
        drop_up=arr(drop_up, np.int32),
        lat_t0=arr(lat_t0, np.int32),
        lat_t1=arr(lat_t1, np.int32),
        lat_masks=masks(lat_masks),
        lat_ms=arr(lat_ms, np.float32),
        loss_t0=arr(loss_t0, np.int32),
        loss_t1=arr(loss_t1, np.int32),
        loss_masks=masks(loss_masks),
        loss_pct=arr(loss_pct, np.float32),
        last_event_tick=last,
    )


@dataclasses.dataclass(frozen=True)
class DeviceFaults:
    """A :class:`FaultSchedule` with its masks on the run's device, padded
    with False to ``n_lanes`` (host lanes never fault), built once per
    program by :meth:`lower`. Event times stay on the host: each accessor
    takes the tick as a Python ``int`` and returns what fires or is open
    then, so a tick outside every event costs no device work."""

    sched: FaultSchedule
    n_lanes: int
    crash: dict  # tick → [n_lanes] bool, the OR of that tick's crash masks
    restart: dict  # tick → [n_lanes] bool
    drop_a: tuple  # Ed × [n_lanes] bool
    drop_b: tuple
    lat_masks: tuple  # El × [n_lanes] bool
    loss_masks: tuple  # Eo × [n_lanes] bool

    @staticmethod
    def lower(sched: FaultSchedule, device, n_lanes: int) -> "DeviceFaults":
        if n_lanes < sched.n:
            raise ValueError(
                f"fault schedule over {sched.n} instance(s) on {n_lanes} lanes"
            )

        def dev(mask: np.ndarray) -> torch.Tensor:
            padded = np.zeros((n_lanes,), bool)
            padded[: sched.n] = mask
            return torch.from_numpy(padded).to(device)

        def by_tick(ticks, mask_at):
            return {int(t): dev(mask_at(int(t))) for t in np.unique(ticks)}

        return DeviceFaults(
            sched=sched,
            n_lanes=n_lanes,
            crash=by_tick(sched.crash_ticks, sched.crash_mask_at),
            restart=by_tick(sched.restart_ticks, sched.restart_mask_at),
            drop_a=tuple(dev(m) for m in sched.drop_a),
            drop_b=tuple(dev(m) for m in sched.drop_b),
            lat_masks=tuple(dev(m) for m in sched.lat_masks),
            loss_masks=tuple(dev(m) for m in sched.loss_masks),
        )

    @property
    def last_event_tick(self) -> int:
        return self.sched.last_event_tick

    def crash_at(self, t: int) -> torch.Tensor | None:
        """The crash mask firing at tick ``t``, or None."""
        return self.crash.get(t)

    def restart_at(self, t: int) -> torch.Tensor | None:
        return self.restart.get(t)

    def drops_at(self, t: int) -> np.ndarray:
        """Indices of the drop windows killing traffic at tick ``t``."""
        return np.flatnonzero(self.sched.drop_active_at(t))

    def latency_at(self, t: int) -> np.ndarray:
        s = self.sched
        return np.flatnonzero(s.window_active_at(t, s.lat_t0, s.lat_t1))

    def losses_at(self, t: int) -> np.ndarray:
        s = self.sched
        return np.flatnonzero(s.window_active_at(t, s.loss_t0, s.loss_t1))
