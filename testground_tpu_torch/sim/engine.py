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

The reference's admission refusals of incompatible declarations are kept,
with the same messages. Not ported yet — each refused with
``NotImplementedError`` naming its ROADMAP item: meshes, shape buckets,
the flight recorder, telemetry and the traffic matrix.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

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
    Calendar,
    LinkState,
    apply_net_updates,
    deliver,
    enqueue,
    make_link_state,
    purge_dst,
)
from .faults import DeviceFaults
from .sync_kernel import (
    SyncState,
    live_per_group,
    make_sub_window,
    make_sync_state,
    update_sync,
)

__all__ = [
    "MAX_FILTER_CELLS",
    "SimCarry",
    "SimProgram",
    "build_groups",
    "resolve_device",
]

# Options of the reference SimProgram that the port refuses, with the
# ROADMAP queue-1 item that ports each.
_UNPORTED_OPTIONS = {
    "mesh": "item 15 (multi-GPU)",
    "live_counts": "item 13 (buckets, packs and checkpoint)",
    "trace": "item 12 (SLO, trace and traffic-matrix planes)",
    "telemetry": "item 10 (telemetry and latency planes)",
    "netmatrix": "item 12 (SLO, trace and traffic-matrix planes)",
}

# Budget for the dense [R, N] per-region filter table, in int32 cells
# (2**28 = 1 GiB), as in the reference.
MAX_FILTER_CELLS = 2**28


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


def _plane(x, shape, dtype, device) -> torch.Tensor:
    """A StepOut field as a contiguous plane of ``shape``: broadcasts
    scalars and [.., 1] fields, casts to the plane's dtype."""
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
        **unported,
    ):
        cls = type(testcase)
        if (
            unported.get("live_counts") is not None
            and "filter_rules" in cls.SHAPING
            and len(groups) > 1
        ):
            raise ValueError(
                "shape bucketing with multiple groups is incompatible "
                "with 'filter_rules' shaping: rule ranges address the "
                "exact (virtual) instance layout, and multi-group "
                "padding shifts physical ids non-contiguously — run "
                "with bucket=off or a single group"
            )
        for name, value in unported.items():
            if name not in _UNPORTED_OPTIONS:
                raise TypeError(f"SimProgram got an unexpected option {name!r}")
            if value not in (None, False, (), []):
                raise NotImplementedError(
                    f"SimProgram option {name!r} is not ported yet: ROADMAP "
                    f"queue 1 {_UNPORTED_OPTIONS[name]}"
                )
        self.device = resolve_device(device)
        self.tc = testcase
        self.groups = groups
        self.n = sum(g.count for g in groups)
        # echo lanes past the instance axis (SimEnv.host_index)
        self.hosts = tuple(hosts)
        self.n_lanes = self.n + len(self.hosts)
        self.tick_ms = float(tick_ms)
        self.chunk = int(chunk)
        self.validate = bool(validate)
        self.meta = dict(test_plan=test_plan, test_case=test_case, test_run=test_run)
        self.faults = faults
        if faults is not None and faults.n != self.n:
            raise ValueError(
                f"fault schedule lowered for {faults.n} instance(s) but "
                f"the program has {self.n} — the schedule must be built "
                "from the same group layout"
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
        dev = self.device
        self._group_of = torch.repeat_interleave(
            torch.arange(len(groups), dtype=torch.int32, device=dev),
            torch.tensor([g.count for g in groups], device=dev),
        )
        # static per-group index planes, built once
        self._gseq = [
            torch.arange(g.count, dtype=torch.int32, device=dev) for g in groups
        ]
        self._gs = [s + g.offset for s, g in zip(self._gseq, groups)]

    # ---------------------------------------------------------------- init

    def _env_for(self, g: GroupSpec, keys, tick=None) -> SimEnv:
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

    def init_carry(self, seed: int = 0) -> SimCarry:
        cls = type(self.tc)
        dev = self.device
        root = prng.key(seed, device=dev)
        net_key, inst_root = prng.split(root)
        keys = prng.split(inst_root, self.n)
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

        return SimCarry(
            states=states,
            status=torch.full((lanes,), RUNNING, dtype=torch.int32, device=dev),
            finished_at=torch.full((lanes,), -1, dtype=torch.int32, device=dev),
            cal=Calendar.empty(
                cls.MAX_LINK_TICKS,
                lanes,
                cls.IN_MSGS,
                cls.MSG_WIDTH,
                track_src=cls.TRACK_SRC,
                device=dev,
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
            net_key=tuple(int(x) for x in net_key.tolist()),
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
        )

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
            return _plane(0 if x is None else x, shape, dtype, dev)

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
            out = self.tc.step(env, carry.states[g.index], inbox_g, sync_g, t)
            outs.append(self._normalize(out, g.count))

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
        if cmask is not None:
            kill = cmask & (status == RUNNING)
            crashed_t = kill.sum(dtype=torch.int32)
            cal, purged_t = purge_dst(cal, kill)
            status = torch.where(kill, CRASH, status)
            finished_at = torch.where(kill, t, finished_at)
        carry = dataclasses.replace(
            carry, states=states, status=status, finished_at=finished_at, cal=cal
        )
        return carry, crashed_t, restarted_t, purged_t, status == CRASH

    def _tick(self, carry: SimCarry, timer=None, done_out=None,
              tick: int | None = None) -> SimCarry:
        """One simulated tick. ``timer.mark(name)`` (optional) is called at
        the tick's start ("tick") and after each phase ("deliver", "step",
        "commit", "sync"). ``done_out`` (optional) is a ``(flag, event)``
        pair: the host bool tensor ``flag`` receives this tick's all-done
        flag by a non-blocking copy queued right after the step phase, and
        ``event`` (a CUDA event, or None on the CPU) is recorded behind it,
        so the caller can wait for the flag without waiting for the
        commit. ``tick`` is ``carry.t`` as the host knows it; a run with a
        fault schedule reads it off ``carry.t`` when it is not given."""
        cls = type(self.tc)
        t = carry.t
        if timer is not None:
            timer.mark("tick")
        crashed_t = restarted_t = purged_t = dead = None
        if self._faults is not None:
            if tick is None:
                tick = int(t)
            carry, crashed_t, restarted_t, purged_t, dead = self._fault_phase(
                carry, tick
            )
        cal, inbox = deliver(carry.cal, t)
        delivered_t = inbox.valid.sum(dtype=torch.int32)
        if timer is not None:
            timer.mark("deliver")
        step = self._step_phase(carry, inbox, t)
        if done_out is not None:
            flag, event = done_out
            flag.copy_((step["status"][: self.n] != RUNNING).all(), non_blocking=True)
            if event is not None:
                event.record()
        if timer is not None:
            timer.mark("step")
        net_key, k_msg = prng.split_host(carry.net_key)
        cal, fb = enqueue(
            cal,
            carry.link,
            step["dst"],
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
        )
        if timer is not None:
            timer.mark("sync")
        return new

    # ----------------------------------------------------------- execution

    def _all_done(self, carry: SimCarry) -> bool:
        """Host lanes never terminate: only plan instances gate done. With
        a fault schedule the run must also outlive its last event (an
        all-crashed fleet with a restart to come is paused, not done)."""
        done = bool((carry.status[: self.n] != RUNNING).all())
        if self._faults is not None:
            done = done and int(carry.t) > self._faults.last_event_tick
        return done

    def run(
        self,
        seed: int = 0,
        max_ticks: int = 10_000,
        observer: Callable[[int, SimCarry], None] | None = None,
        resume_carry: SimCarry | None = None,
        resume_ticks: int = 0,
        timer=None,
    ) -> dict[str, Any]:
        """Step to completion (or ``max_ticks``, rounded up to whole
        chunks, as the reference does). ``observer(ticks, carry)`` is
        called after every chunk with the live carry (its planes are
        updated in place by the next chunk). ``resume_carry`` /
        ``resume_ticks`` continue a run from a carry (e.g. one built by
        ``carry_io.carry_from_numpy``). ``timer`` receives per-phase marks
        (see :meth:`_tick`)."""
        t0 = time.perf_counter()
        if resume_carry is not None:
            carry, ticks = resume_carry, int(resume_ticks)
        else:
            carry, ticks = self.init_carry(seed), 0
        cuda = self.device.type == "cuda"
        done_out = (
            torch.zeros((), dtype=torch.bool, pin_memory=cuda),
            torch.cuda.Event() if cuda else None,
        )
        done = self._all_done(carry)
        # the host's copy of carry.t: a fault schedule resolves its events
        # and windows against it, and its done gate reads it
        last_event = None
        tick = None
        if self._faults is not None:
            last_event = self._faults.last_event_tick
            tick = int(carry.t)
        setup_secs = 0.0
        while ticks < max_ticks:
            for _ in range(self.chunk):
                if done:
                    break  # post-completion ticks are no-ops
                carry = self._tick(carry, timer=timer, done_out=done_out, tick=tick)
                if cuda:
                    done_out[1].synchronize()
                done = bool(done_out[0])
                if tick is not None:
                    tick += 1
                    done = done and tick > last_event
            ticks += self.chunk
            if setup_secs == 0.0:
                setup_secs = time.perf_counter() - t0
            if observer is not None:
                observer(ticks, carry)
            if done:
                break
        res = self.results(carry, ticks)
        res["compile_secs"] = setup_secs
        return res

    def results(self, carry: SimCarry, ticks: int) -> dict[str, Any]:
        def host(x):
            return x.detach().cpu().numpy()

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
            "carry_bytes": carry_bytes(carry),
            # host lanes are internal plumbing — plan instances only
            "status": host(carry.status[: self.n]),
            "finished_at": host(carry.finished_at[: self.n]),
            "states": tuple(
                {k: host(v) for k, v in s.items()} for s in carry.states
            ),
            "groups": self.groups,
        }


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
