"""The port's fault plane against the JAX package on the CPU, bit for bit:

- ``build_fault_schedule`` lowers every fault kind, the chaos smoke
  composition's schedule and a fraction selector to the same tables, and
  refuses every bad spec with the same message; its host-side accessors
  agree with the reference's device-side ones at every tick;
- ``remap_schedule`` and ``purge_dst`` agree with the reference's;
- ``enqueue`` with a schedule, a dead mask, control lanes and the
  per-message fate agrees with the reference's, plane for plane;
- one whole run per fault kind (the runs of ``tests/test_sim_faults.py``'s
  ``TestCrashRestart``, ``TestNetWindows`` and ``TestBarrierDegradation``,
  and ``tests/test_transport_pallas.py``'s chaos schedule) agrees leaf for
  leaf, with the flow totals closing over ``fault_dropped``;
- a run resumed from a JAX carry taken mid-schedule agrees too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_sim_faults import (
    _Barrier as JBarrier,
    _Counter as JCounter,
    _Pinger as JPinger,
    _SlowPinger as JSlowPinger,
)
from test_torch_engine import assert_carries_equal, assert_results_equal, run_capturing
from test_torch_net_features import _inputs, _jax_state, _port_state
from test_transport_pallas import _ChaosBarrierTraffic as JChaosTraffic
from testground_tpu.api import RunGroup as JRunGroup
from testground_tpu.sim import faults as jfaults
from testground_tpu.sim import net as jnet
from testground_tpu.sim.engine import SimProgram as JSimProgram
from testground_tpu.sim.engine import build_groups as jbuild
from testground_tpu_torch.api import RunGroup
from testground_tpu_torch.sim import api as papi
from testground_tpu_torch.sim import faults as pfaults
from testground_tpu_torch.sim import net as pnet
from testground_tpu_torch.sim.carry_io import carry_from_numpy
from testground_tpu_torch.sim.engine import SimProgram, build_groups

# ------------------------------------------------------------ testcases


class _Pinger(papi.SimTestcase):
    """Twin of ``test_sim_faults._Pinger``: one message to (me+1) mod n
    every tick; counts arrivals and the tick of the first."""

    MSG_WIDTH = 1
    OUT_MSGS = 1
    IN_MSGS = 4
    MAX_LINK_TICKS = 16
    SHAPING = ("latency",)

    def init(self, env):
        n_g = env.group.count
        return {"got": torch.zeros(n_g, dtype=torch.int32),
                "first_got_at": torch.full((n_g,), -1, dtype=torch.int32)}

    def step(self, env, state, inbox, sync, t):
        got = inbox.count
        return self.out(
            {"got": state["got"] + got,
             "first_got_at": torch.where((got > 0) & (state["first_got_at"] < 0), t,
                                         state["first_got_at"])},
            outbox=papi.Outbox.single(
                torch.remainder(env.global_seq + 1, env.test_instance_count), [0],
                True, 1, 1),
        )


class _SlowPinger(_Pinger):
    DEFAULT_LINK = (4.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0)


class _Counter(papi.SimTestcase):
    """Twin of ``test_sim_faults._Counter``: SUCCESS after 20 ticks."""

    MSG_WIDTH = 1
    OUT_MSGS = 1
    IN_MSGS = 4
    MAX_LINK_TICKS = 8
    SHAPING = ("latency",)

    def init(self, env):
        return {"c": torch.zeros(env.group.count, dtype=torch.int32)}

    def step(self, env, state, inbox, sync, t):
        c = state["c"] + 1
        return self.out({"c": c}, status=torch.where(c >= 20, papi.SUCCESS, papi.RUNNING))


class _Barrier(papi.SimTestcase):
    """Twin of ``test_sim_faults._Barrier``: a live-degraded barrier that
    instance 0 blocks until tick 100."""

    STATES = ["go"]
    MSG_WIDTH = 1
    OUT_MSGS = 1
    IN_MSGS = 4
    MAX_LINK_TICKS = 8
    SHAPING = ("latency",)

    def init(self, env):
        return {"live_seen": torch.full((env.group.count,), -1, dtype=torch.int32)}

    def step(self, env, state, inbox, sync, t):
        ready = (env.global_seq > 0) | (t >= 100)
        already = sync.last_seq[self.state_id("go")] > 0
        counts = sync.counts[self.state_id("go")]
        live_total = sync.live.sum()
        passed = (counts > 0) & (counts >= live_total)
        return self.out(
            {"live_seen": torch.where(passed, live_total, state["live_seen"]).to(torch.int32)},
            status=torch.where(passed, papi.SUCCESS, papi.RUNNING),
            signals=self.signal("go", when=ready & ~already),
        )


class _ChaosTraffic(papi.SimTestcase):
    """Twin of ``test_transport_pallas._ChaosBarrierTraffic``: signal, a
    live-degraded barrier, then rotating ring traffic for 24 ticks."""

    STATES = ["go"]
    MSG_WIDTH = 1
    OUT_MSGS = 1
    IN_MSGS = 8
    MAX_LINK_TICKS = 8
    SHAPING = ("latency",)

    def init(self, env):
        n_g = env.group_lanes
        return {"k": torch.zeros(n_g, dtype=torch.int32),
                "passed": torch.zeros(n_g, dtype=torch.bool)}

    def step(self, env, state, inbox, sync, t):
        n = env.test_instance_count
        already = sync.last_seq[self.state_id("go")] > 0
        counts = sync.counts[self.state_id("go")]
        passed = state["passed"] | ((counts > 0) & (counts >= sync.live.sum()))
        k = torch.where(passed, state["k"] + 1, state["k"])
        return self.out(
            {"k": k, "passed": passed},
            status=torch.where(k >= 24, papi.SUCCESS, papi.RUNNING),
            outbox=papi.Outbox.single(torch.remainder(env.global_seq + 1 + t, n), [0],
                                      passed, 1, 1),
            signals=self.signal("go", when=~already),
        )


# --------------------------------------------------------------- lowering

EVERY_KIND = [
    {"kind": "crash", "start_ms": 1, "instances": "0:1"},
    {"kind": "restart", "start_ms": 5, "instances": "0:1"},
    {"kind": "partition", "start_ms": 2, "duration_ms": 4, "instances": "0:2",
     "to_instances": "2:4"},
    {"kind": "link_flap", "start_ms": 2, "duration_ms": 8, "period_ms": 4, "duty": 0.5},
    {"kind": "latency_spike", "start_ms": 3, "duration_ms": 3, "latency_ms": 5.0},
    {"kind": "loss_burst", "start_ms": 4, "duration_ms": 2, "loss": 100.0},
]


def _smoke_tables():
    import os
    import tomllib

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "plans", "chaos", "_compositions", "smoke.toml")
    with open(path, "rb") as f:
        comp = tomllib.load(f)
    return {g["id"]: g["run"]["faults"] for g in comp["groups"]}


# name: (group layout [(id, count)], tables by group id, tick_ms)
SCHEDULES = {
    "every-kind": ([("g0", 4)], {"": EVERY_KIND}, 1.0),
    "every-kind-2ms": ([("g0", 4)], {"": EVERY_KIND}, 2.0),
    "chaos-smoke": ([("all", 8)], _smoke_tables(), 1.0),
    "groups-and-fractions": (
        [("a", 3), ("b", 5)],
        {"b": [{"kind": "crash", "start_ms": 1}],
         "": [{"kind": "loss_burst", "start_ms": 0, "duration_ms": 9, "loss": 40.0,
               "fraction": 0.5, "seed": 7},
              {"kind": "partition", "start_ms": 3, "duration_ms": 5, "group": "a",
               "to_group": "b", "bidirectional": False},
              {"kind": "link_flap", "start_ms": 1, "duration_ms": 6, "group": "b",
               "instances": "1:3"},
              {"kind": "latency_spike", "start_ms": 2, "duration_ms": 4,
               "latency_ms": 0.3, "group": "a"},
              {"kind": "latency_spike", "start_ms": 4, "duration_ms": 4,
               "latency_ms": 0.7}]},
        1.0),
}

_FIELDS = ("n", "crash_ticks", "crash_masks", "restart_ticks", "restart_masks", "drop_t0",
           "drop_t1", "drop_a", "drop_b", "drop_sym", "drop_period", "drop_up", "lat_t0",
           "lat_t1", "lat_masks", "lat_ms", "loss_t0", "loss_t1", "loss_masks", "loss_pct",
           "last_event_tick")


def _both_groups(layout, params=None):
    jg = jbuild([JRunGroup(id=i, instances=c, parameters=dict(params or {}))
                 for i, c in layout])
    pg = build_groups([RunGroup(id=i, instances=c, parameters=dict(params or {}))
                       for i, c in layout])
    return jg, pg


def _assert_schedules_equal(js, ps):
    for f in _FIELDS:
        a, b = getattr(js, f), getattr(ps, f)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a), err_msg=f)
    assert ps.summary() == js.summary()


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedule_lowers_like_reference(name):
    layout, tables, tick_ms = SCHEDULES[name]
    jg, pg = _both_groups(layout)
    js = jfaults.build_fault_schedule(jg, tables, tick_ms)
    ps = pfaults.build_fault_schedule(pg, tables, tick_ms)
    _assert_schedules_equal(js, ps)
    for flag in ("has_crashes", "has_restarts", "has_drops", "has_latency", "has_loss"):
        assert getattr(ps, flag) == getattr(js, flag), flag
    # the host-side accessors against the reference's traced ones
    for t in range(ps.last_event_tick + 3):
        tj = jnp.int32(t)
        for acc in ("crash_mask_at", "restart_mask_at", "drop_active_at"):
            np.testing.assert_array_equal(getattr(ps, acc)(t),
                                          np.asarray(getattr(js, acc)(tj)),
                                          err_msg=f"{acc} t={t}")
        for t0, t1 in (("lat_t0", "lat_t1"), ("loss_t0", "loss_t1")):
            np.testing.assert_array_equal(
                ps.window_active_at(t, getattr(ps, t0), getattr(ps, t1)),
                np.asarray(js.window_active_at(tj, getattr(js, t0), getattr(js, t1))),
                err_msg=f"{t0} t={t}")


def test_empty_schedule_lowers_to_none():
    _, pg = _both_groups([("g0", 4)])
    assert pfaults.build_fault_schedule(pg, {}, 1.0) is None
    assert pfaults.build_fault_schedule(pg, {"g0": []}, 1.0) is None
    assert pfaults.FAULT_KINDS == jfaults.FAULT_KINDS


BAD_SPECS = {
    "unknown-kind": [{"kind": "meteor", "start_ms": 1}],
    "unknown-key": [{"kind": "crash", "start_ms": 1, "when": 2}],
    "not-a-table": ["crash"],
    "no-start": [{"kind": "crash"}],
    "window-no-duration": [{"kind": "partition", "start_ms": 0, "to_group": "g0"}],
    "point-with-duration": [{"kind": "crash", "start_ms": 0, "duration_ms": 5}],
    "spike-no-latency": [{"kind": "latency_spike", "start_ms": 0, "duration_ms": 5}],
    "loss-out-of-range": [{"kind": "loss_burst", "start_ms": 0, "duration_ms": 5,
                           "loss": 250.0}],
    "partition-one-side": [{"kind": "partition", "start_ms": 0, "duration_ms": 5}],
    "flap-duty": [{"kind": "link_flap", "start_ms": 0, "duration_ms": 5, "period_ms": 2,
                   "duty": 1.5}],
    "bad-fraction": [{"kind": "crash", "start_ms": 0, "fraction": 1.5}],
    "fraction-selects-nobody": [{"kind": "crash", "start_ms": 0, "fraction": 0.01}],
    "unknown-group": [{"kind": "crash", "start_ms": 0, "group": "nope"}],
    "range-exceeds": [{"kind": "crash", "start_ms": 0, "instances": "2:9"}],
    "range-syntax": [{"kind": "crash", "start_ms": 0, "instances": "2-3"}],
    "range-empty": [{"kind": "crash", "start_ms": 0, "instances": "3:3"}],
    "partition-overlap": [{"kind": "partition", "start_ms": 0, "duration_ms": 4,
                           "instances": "0:3", "to_instances": "2:4"}],
    "crash-restart-same-tick": [
        {"kind": "crash", "start_ms": 1000, "instances": "0:2"},
        {"kind": "restart", "start_ms": 1040, "instances": "0:2"}],
}


@pytest.mark.parametrize("name", list(BAD_SPECS))
def test_bad_spec_refused_with_reference_message(name):
    tick_ms = 100.0 if name == "crash-restart-same-tick" else 1.0
    jg, pg = _both_groups([("g0", 4)])
    with pytest.raises(ValueError) as jerr:
        jfaults.build_fault_schedule(jg, {"": BAD_SPECS[name]}, tick_ms)
    with pytest.raises(ValueError) as perr:
        pfaults.build_fault_schedule(pg, {"": BAD_SPECS[name]}, tick_ms)
    assert str(perr.value) == str(jerr.value)


def test_remap_schedule_matches_reference():
    jg, pg = _both_groups([("g0", 4)])
    js = jfaults.build_fault_schedule(jg, {"": EVERY_KIND}, 1.0)
    ps = pfaults.build_fault_schedule(pg, {"": EVERY_KIND}, 1.0)
    index_map = np.array([0, 2, 5, 6], np.int32)
    _assert_schedules_equal(jfaults.remap_schedule(js, index_map, 8),
                            pfaults.remap_schedule(ps, index_map, 8))
    with pytest.raises(ValueError, match="remap must run"):
        pfaults.remap_schedule(ps, index_map[:3], 8)


def test_device_lowering_pads_host_lanes_and_keys_events_by_tick():
    _, pg = _both_groups([("g0", 4)])
    ps = pfaults.build_fault_schedule(pg, {"": EVERY_KIND}, 1.0)
    df = pfaults.DeviceFaults.lower(ps, "cpu", 6)
    assert sorted(df.crash) == [1] and sorted(df.restart) == [5]
    assert df.crash_at(1).tolist() == [True, False, False, False, False, False]
    assert df.crash_at(2) is None
    assert all(m.shape == (6,) and not m[4:].any()
               for m in (*df.drop_a, *df.drop_b, *df.lat_masks, *df.loss_masks))
    assert df.drops_at(2).tolist() == [0] and df.drops_at(4).tolist() == [0, 1]
    with pytest.raises(ValueError):
        pfaults.DeviceFaults.lower(ps, "cpu", 3)


# ------------------------------------------------------------------ purge


@pytest.mark.parametrize("track_src", [True, False], ids=["int32-occ", "bool-occ"])
def test_purge_dst_matches_reference(track_src):
    x = _inputs(3, n=16, fill=0.4, track_src=track_src)
    mask = np.random.default_rng(3).random(16) < 0.3
    jcal, _ = _jax_state(x)
    pcal, _ = _port_state(x)
    jcal, jp = jnet.purge_dst(jcal, jnp.asarray(mask))
    pcal, pp = pnet.purge_dst(pcal, torch.from_numpy(mask))
    assert int(pp) == int(jp) > 0
    np.testing.assert_array_equal(pcal.occupancy_plane.numpy(),
                                  np.asarray(jcal.occupancy_plane))


# ------------------------------------------------- enqueue with the plane

# every sorted-path feature, two transport shapes, a window open at each tick
ENQUEUE_CASES = {
    "all-but-duplicate": (jnet.SHAPING_NO_DUPLICATE, {}),
    "duplicate": (("latency", "jitter", "loss", "duplicate"), {}),
    "bandwidth-queue": (("latency", "reorder", "bandwidth_queue"), {"bw_queue_cap": 6}),
    "filter-rules": (("latency", "loss", "filter_rules"), {}),
}

ENQUEUE_SPECS = [
    {"kind": "partition", "start_ms": 3, "duration_ms": 6, "instances": "0:5",
     "to_instances": "9:14"},
    {"kind": "partition", "start_ms": 2, "duration_ms": 9, "instances": "5:8",
     "to_instances": "0:2", "bidirectional": False},
    {"kind": "link_flap", "start_ms": 4, "duration_ms": 8, "period_ms": 3, "duty": 0.34,
     "instances": "10:12"},
    {"kind": "latency_spike", "start_ms": 2, "duration_ms": 8, "latency_ms": 2.6,
     "instances": "0:7"},
    {"kind": "latency_spike", "start_ms": 5, "duration_ms": 8, "latency_ms": 0.35,
     "instances": "3:14"},
    {"kind": "loss_burst", "start_ms": 3, "duration_ms": 7, "loss": 35.0,
     "instances": "2:12"},
    {"kind": "loss_burst", "start_ms": 6, "duration_ms": 4, "loss": 80.0,
     "instances": "8:14"},
]


@pytest.mark.parametrize("tick", [2, 6, 8])
@pytest.mark.parametrize("case", list(ENQUEUE_CASES))
@pytest.mark.parametrize("hosts", [0, 2], ids=["no-hosts", "2-hosts"])
def test_enqueue_with_faults_dead_and_control_lanes_matches_jax(case, hosts, tick):
    """Windows resolved at ``tick``, a dead mask, control lanes past
    instance 14 of 16 lanes, and the per-message fate; the latency
    spikes overlap, so their float32 sum is compared too (through the
    delays, i.e. the planes)."""
    features, kw = ENQUEUE_CASES[case]
    n_inst = 16 - hosts
    x = _inputs(20 + tick, n=16, o=3, w=2, n_rules=2 if "filter_rules" in features else 0)
    x["dst"][:, ::5] = 14  # traffic toward the host lanes (or instance 14)
    rng = np.random.default_rng(tick)
    dead = rng.random(16) < 0.2
    dead[n_inst:] = False
    groups = _both_groups([("g0", n_inst)])
    js = jfaults.build_fault_schedule(groups[0], {"": ENQUEUE_SPECS}, 1.0)
    ps = pfaults.build_fault_schedule(groups[1], {"": ENQUEUE_SPECS}, 1.0)
    backlog = "bandwidth_queue" in features
    ctrl = n_inst if hosts else None
    key = jax.random.key(tick)
    jcal, jfb = jnet.enqueue(
        *_jax_state(x, backlog), jnp.asarray(x["dst"]), jnp.asarray(x["payload"]),
        jnp.asarray(x["valid"]), jnp.int32(tick), 1.0, key, features=features,
        control_start=ctrl, faults=js, dead=jnp.asarray(dead), want_fate=True, **kw)
    kd = tuple(int(v) for v in np.asarray(jax.random.key_data(key)))
    pcal, pfb = pnet.enqueue(
        *_port_state(x, backlog), torch.from_numpy(x["dst"]),
        torch.from_numpy(x["payload"]), torch.from_numpy(x["valid"]),
        torch.tensor(tick, dtype=torch.int32), 1.0, kd, features=features,
        control_start=ctrl, faults=ps, dead=torch.from_numpy(dead), want_fate=True, **kw)
    np.testing.assert_array_equal(pcal.occupancy_plane.numpy(),
                                  np.asarray(jcal.occupancy_plane))
    for a, b in zip(jcal.payload, pcal.payload):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    for f in ("rejected", "clamped", "bw_dropped", "sent", "enqueued", "fault_dropped",
              "fate"):
        np.testing.assert_array_equal(getattr(pfb, f).numpy(), np.asarray(getattr(jfb, f)),
                                      err_msg=f)
    if backlog:
        np.testing.assert_array_equal(pfb.backlog.numpy(), np.asarray(jfb.backlog))
    assert int(pfb.fault_dropped) > 0


def test_enqueue_control_lanes_direct_mode_and_fate_match_jax():
    """Direct slots with a control lane (the engine refuses the pair, the
    transport takes it) and the fate of a sorted duplicate stream without
    any fault term."""
    x = _inputs(5, n=16, o=2, fill=0.0)
    x["dst"] = np.stack([np.random.default_rng(5).permutation(16),
                         np.full(16, 15)]).astype(np.int32)
    key = jax.random.key(5)
    kd = tuple(int(v) for v in np.asarray(jax.random.key_data(key)))
    for mode, features in (("direct", ("latency", "loss")),
                           ("sorted", ("latency", "loss", "duplicate"))):
        jcal, jfb = jnet.enqueue(
            *_jax_state(x), jnp.asarray(x["dst"]), jnp.asarray(x["payload"]),
            jnp.asarray(x["valid"]), jnp.int32(7), 1.0, key, slot_mode=mode,
            features=features, control_start=15 if mode == "direct" else None,
            want_fate=True)
        pcal, pfb = pnet.enqueue(
            *_port_state(x), torch.from_numpy(x["dst"]), torch.from_numpy(x["payload"]),
            torch.from_numpy(x["valid"]), torch.tensor(7, dtype=torch.int32), 1.0, kd,
            slot_mode=mode, features=features,
            control_start=15 if mode == "direct" else None, want_fate=True)
        np.testing.assert_array_equal(pcal.occupancy_plane.numpy(),
                                      np.asarray(jcal.occupancy_plane), err_msg=mode)
        np.testing.assert_array_equal(pfb.fate.numpy(), np.asarray(jfb.fate), err_msg=mode)
        assert (pfb.fate >= 0).any()


# ---------------------------------------------------------------- whole runs


def _crash(at, rng=None):
    d = {"kind": "crash", "start_ms": at}
    return {**d, "instances": rng} if rng else d


def _restart(at, rng=None):
    d = {"kind": "restart", "start_ms": at}
    return {**d, "instances": rng} if rng else d


_WINDOW_PART = {"kind": "partition", "start_ms": 5, "duration_ms": 5, "instances": "0:2",
                "to_instances": "2:4"}

# name: (JAX testcase, port testcase, n, fault tables, run kwargs)
RUNS = {
    "crash-kills-purges-and-counts": (JSlowPinger, _SlowPinger, 4,
                                      [_crash(10, "1:2")], dict(max_ticks=32)),
    "restart-reinits-and-revives": (JCounter, _Counter, 3,
                                    [_crash(5, "0:1"), _restart(12, "0:1")],
                                    dict(max_ticks=64)),
    "restart-only-revives-crashed": (JCounter, _Counter, 2, [_restart(4, "0:1")],
                                     dict(max_ticks=64)),
    "done-waits-for-last-event": (JCounter, _Counter, 2, [_crash(3), _restart(40)],
                                  dict(max_ticks=256)),
    "partition": (JPinger, _Pinger, 4, [_WINDOW_PART], dict(max_ticks=16)),
    "partition-one-way": (JPinger, _Pinger, 4, [{**_WINDOW_PART, "bidirectional": False}],
                          dict(max_ticks=16)),
    "link-flap-duty-cycle": (JPinger, _Pinger, 4,
                             [{"kind": "link_flap", "start_ms": 8, "duration_ms": 8,
                               "period_ms": 4, "duty": 0.5, "instances": "1:2"}],
                             dict(max_ticks=24)),
    "latency-spike": (JPinger, _Pinger, 2,
                      [{"kind": "latency_spike", "start_ms": 0, "duration_ms": 3,
                        "latency_ms": 5.0, "instances": "0:1"}], dict(max_ticks=12)),
    "loss-burst-100": (JPinger, _Pinger, 4,
                       [{"kind": "loss_burst", "start_ms": 5, "duration_ms": 5,
                         "loss": 100.0, "instances": "0:2"}], dict(max_ticks=16)),
    "loss-burst-40": (JPinger, _Pinger, 8,
                      [{"kind": "loss_burst", "start_ms": 2, "duration_ms": 20,
                        "loss": 40.0}], dict(max_ticks=32)),
    "barrier-degrades-on-crash": (JBarrier, _Barrier, 4, [_crash(5, "0:1")],
                                  dict(max_ticks=512)),
    "chaos-schedule": (
        JChaosTraffic, _ChaosTraffic, 6,
        [{"kind": "crash", "instances": "2:4", "start_ms": 4.0},
         {"kind": "restart", "instances": "2:3", "start_ms": 9.0},
         {"kind": "partition", "instances": "0:2", "to_instances": "4:6",
          "start_ms": 3.0, "duration_ms": 6.0, "bidirectional": True},
         {"kind": "loss_burst", "instances": "0:6", "start_ms": 6.0, "duration_ms": 8.0,
          "loss": 50.0}],
        dict(max_ticks=2048, seed=7)),
}

# two groups: a group-scoped crash and restart (the re-init selects per
# group slice) and a partition between the groups
RUNS["restart-in-second-group"] = (
    JCounter, _Counter, [("a", 3), ("b", 4)],
    {"b": [_crash(2, "1:3"), _restart(9, "1:3")],
     "": [{"kind": "partition", "start_ms": 1, "duration_ms": 6, "group": "a",
           "to_group": "b"}]},
    dict(max_ticks=64))
RUNS["pinger-two-groups"] = (
    JSlowPinger, _SlowPinger, [("a", 3), ("b", 4)],
    {"a": [_crash(3, "0:2"), _restart(11, "0:1")],
     "": [{"kind": "link_flap", "start_ms": 5, "duration_ms": 9, "period_ms": 3,
           "duty": 0.34, "group": "b", "instances": "2:4"},
          {"kind": "latency_spike", "start_ms": 2, "duration_ms": 12, "latency_ms": 3.5,
           "group": "b"},
          {"kind": "loss_burst", "start_ms": 8, "duration_ms": 6, "loss": 60.0}]},
    dict(max_ticks=40))

# what the reference's own tests assert of each run
EXPECT = {
    "crash-kills-purges-and-counts": dict(fault_dropped=26, faults_crashed=1,
                                          status=[0, 3, 0, 0]),
    "restart-reinits-and-revives": dict(faults_restarted=1, finished_at=[31, 19, 19]),
    "restart-only-revives-crashed": dict(faults_restarted=0, finished_at=[19, 19]),
    "done-waits-for-last-event": dict(faults_restarted=2, finished_at=[59, 59]),
    "partition": dict(fault_dropped=10),
    "partition-one-way": dict(fault_dropped=5),
    "link-flap-duty-cycle": dict(fault_dropped=8),
    "latency-spike": dict(fault_dropped=0),
    "loss-burst-100": dict(fault_dropped=10),
    "barrier-degrades-on-crash": dict(status=[3, 1, 1, 1]),
    "restart-in-second-group": dict(faults_crashed=2, faults_restarted=2,
                                    finished_at=[19, 19, 19, 19, 28, 28, 19]),
}


def _run_programs(name, chunk=8):
    jtc, ptc, n, specs, _ = RUNS[name]
    layout = n if isinstance(n, list) else [("all", n)]
    tables = specs if isinstance(specs, dict) else {"": specs}
    jg, pg = _both_groups(layout)
    js = jfaults.build_fault_schedule(jg, tables, 1.0)
    ps = pfaults.build_fault_schedule(pg, tables, 1.0)
    return (JSimProgram(jtc(), jg, chunk=chunk, faults=js),
            SimProgram(ptc(), pg, chunk=chunk, device="cpu", faults=ps))


def _conserved(res):
    return res["msgs_sent"] == (res["msgs_delivered"] + res["cal_depth"]
                                + res["msgs_dropped"] + res["msgs_rejected"]
                                + res["fault_dropped"])


@pytest.mark.parametrize("name", list(RUNS))
def test_faulted_run_matches_jax(name):
    kw = RUNS[name][4]
    jprog, pprog = _run_programs(name, chunk=16 if name == "chaos-schedule" else 8)
    res_j, (flat_j, _) = run_capturing(jprog, **kw)
    res_p, (flat_p, _) = run_capturing(pprog, **kw)
    assert_results_equal(res_j, res_p, name)
    assert_carries_equal(flat_j, pprog, flat_p, name)
    assert _conserved(res_p)
    for key, want in EXPECT.get(name, {}).items():
        got = res_p[key]
        assert (got.tolist() if hasattr(got, "tolist") else got) == want, key
    if name == "chaos-schedule":
        assert res_p["faults_crashed"] > 0 and res_p["msgs_delivered"] > 0


@pytest.mark.parametrize("k", [6, 8])
def test_resume_from_jax_carry_mid_schedule(k):
    """JAX runs k ticks of the chaos schedule (after the crash, inside the
    partition and loss windows, before the restart); its carry crosses
    into the port, which resolves the rest of the schedule from the
    carry's tick; both run to the end and agree leaf for leaf."""
    jprog, pprog = _run_programs("chaos-schedule", chunk=2)
    _, (flat_mid, jcarry) = run_capturing(jprog, seed=7, max_ticks=k)
    assert int(flat_mid["t"]) == k and int(flat_mid["faults_crashed"]) == 2
    res_j, (flat_j, _) = run_capturing(jprog, seed=7, max_ticks=2048,
                                       resume_carry=jcarry, resume_ticks=k)
    res_p, (flat_p, _) = run_capturing(pprog, max_ticks=2048,
                                       resume_carry=carry_from_numpy(flat_mid, pprog),
                                       resume_ticks=k)
    assert res_p["faults_restarted"] == 1
    assert_results_equal(res_j, res_p, f"resume at {k}")
    assert_carries_equal(flat_j, pprog, flat_p, f"resume at {k}")


def test_schedule_for_another_layout_refused_like_reference():
    jg8, pg8 = _both_groups([("g0", 8)])
    jg4, pg4 = _both_groups([("g0", 4)])
    spec = {"": [{"kind": "crash", "start_ms": 1}]}
    with pytest.raises(ValueError) as jerr:
        JSimProgram(JPinger(), jg4, faults=jfaults.build_fault_schedule(jg8, spec, 1.0))
    with pytest.raises(ValueError) as perr:
        SimProgram(_Pinger(), pg4, device="cpu",
                   faults=pfaults.build_fault_schedule(pg8, spec, 1.0))
    assert str(perr.value) == str(jerr.value)


def test_without_a_schedule_the_tick_is_unchanged(monkeypatch):
    """The zero-overhead contract: with no schedule, no fault phase runs
    and enqueue gets no fault terms."""
    _, pg = _both_groups([("g0", 4)])
    prog = SimProgram(_Pinger(), pg, chunk=4, device="cpu")
    seen = []
    real = pnet.enqueue

    def spy(*a, **kw):
        seen.append((kw["faults"], kw["dead"], kw["tick"], kw["control_start"]))
        return real(*a, **kw)

    import testground_tpu_torch.sim.engine as eng

    monkeypatch.setattr(eng, "enqueue", spy)
    monkeypatch.setattr(prog, "_fault_phase", lambda *a: pytest.fail("fault phase ran"))
    prog.run(max_ticks=8)
    assert seen and all(s == (None, None, None, None) for s in seen)
