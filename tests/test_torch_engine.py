"""The port's main path against the JAX package, on the CPU, bit for bit:
``SimProgram.run`` of ``network:ping-pong`` (n = 8, and n = 7 with its solo
lane) and ``network:pingpong-sustained`` (n = 16 with a reshape mid-run,
and a two-group layout) through both packages' library entry points,
comparing every ``results()`` key, every state leaf and the final carry
(calendar planes included) through ``carry_io``; one resume: JAX runs k
ticks, the carry crosses over with ``carry_from_numpy``, and both run on;
the sync fold with live topics; the options the port builds (control
lanes and fault schedules among them); and the refusals of what the port
does not run yet, or refuses as the reference does."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from testground_tpu.sim import api as japi
from testground_tpu_torch.api import RunGroup
from testground_tpu_torch.sim import api as papi
from testground_tpu_torch.sim import net as pnet
from testground_tpu_torch.sim.carry_io import carry_from_numpy, carry_to_numpy
from testground_tpu_torch.sim.engine import SimProgram, build_groups
from testground_tpu_torch.sim.executor import (
    instantiate_testcase,
    load_sim_testcases,
    plan_dir,
)

RESULT_KEYS = (
    "status", "finished_at", "ticks", "sync_counts", "pub_dropped",
    "latency_clamped", "bw_queue_dropped", "bw_rate_change_backlogged",
    "collisions", "msgs_delivered", "msgs_sent", "msgs_enqueued",
    "msgs_dropped", "msgs_rejected", "cal_depth", "faults_crashed",
    "faults_restarted", "fault_dropped", "carry_bytes",
)

CASES = {
    "ping-pong-8": ("ping-pong", 8,
                    {"latency_ms": "4", "latency2_ms": "2", "tolerance_ms": "15"}, 8),
    "ping-pong-7-solo": ("ping-pong", 7, {"latency_ms": "10", "latency2_ms": "3"}, 16),
    "sustained-16": ("pingpong-sustained", 16,
                     {"duration_ticks": "64", "reshape_every": "24"}, 16),
    # two groups with their own latencies: per-group steps, two filter
    # regions, and pairs that straddle the group boundary (4 + 5 lanes)
    "sustained-2-groups": ("pingpong-sustained",
                           [(5, {"duration_ticks": "40", "latency_ms": "3"}),
                            (6, {"duration_ticks": "48", "latency_ms": "5",
                                 "latency2_ms": "1", "reshape_every": "16"})],
                           None, 8),
}


def _run_groups(n, params, group_cls):
    """One group of ``n`` instances, or the ``[(count, params), ...]``
    layout of a multi-group case."""
    layout = [(n, params)] if isinstance(n, int) else n
    return [group_cls(id=f"g{i}", instances=c, parameters=dict(p))
            for i, (c, p) in enumerate(layout)]


def jax_program(case, n, params, chunk):
    from testground_tpu.api import RunGroup as JRunGroup
    from testground_tpu.sim.engine import SimProgram as JSimProgram
    from testground_tpu.sim.engine import build_groups as jbuild
    from testground_tpu.sim.executor import instantiate_testcase as jinst
    from testground_tpu.sim.executor import load_sim_testcases as jload

    factory = jload(os.path.join(os.path.dirname(ge.__file__), "plans", "network"))[case]
    groups = jbuild(_run_groups(n, params, JRunGroup))
    return JSimProgram(jinst(factory, groups, 1.0), groups, test_plan="network",
                       test_case=case, tick_ms=1.0, chunk=chunk)


def jax_flat_carry(carry) -> dict:
    """The JAX carry as numpy leaves under dotted paths (key arrays as
    their raw uint32 words) — the exchange format of ``carry_io``."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(carry)[0]:
        parts = []
        for p in path:
            parts.append(str(getattr(p, "name", getattr(p, "idx", getattr(p, "key", p)))))
        if jax.dtypes.issubdtype(leaf.dtype, jax.dtypes.prng_key):
            leaf = jax.random.key_data(leaf)
        out[".".join(parts)] = np.asarray(leaf)
    return out


def port_program(case, n, params, chunk, device="cpu"):
    factory = load_sim_testcases(plan_dir("network"))[case]
    groups = build_groups(_run_groups(n, params, RunGroup))
    tc = instantiate_testcase(factory, groups, tick_ms=1.0)
    return SimProgram(tc, groups, test_plan="network", test_case=case,
                      tick_ms=1.0, chunk=chunk, device=device)


def run_capturing(prog, **kw):
    """Run and keep the final carry (flattened at each chunk: the JAX
    chunk donates its input carry)."""
    last = {}
    flat = jax_flat_carry if not isinstance(prog, SimProgram) else carry_to_numpy
    res = prog.run(observer=lambda k, c: last.__setitem__("c", (flat(c), c)), **kw)
    return res, last["c"]


def assert_results_equal(res_j, res_p, label):
    for key in RESULT_KEYS:
        np.testing.assert_array_equal(
            np.asarray(res_p[key]), np.asarray(res_j[key]), err_msg=f"{label} {key}")
    assert len(res_j["states"]) == len(res_p["states"])
    for sj, sp in zip(res_j["states"], res_p["states"]):
        assert sorted(sj) == sorted(sp), label
        for k in sj:
            assert sp[k].dtype == np.asarray(sj[k]).dtype, f"{label} state {k} dtype"
            np.testing.assert_array_equal(sp[k], np.asarray(sj[k]), err_msg=f"{label} {k}")


def assert_carries_equal(flat_j, port_prog, flat_p, label):
    want = carry_to_numpy(carry_from_numpy(flat_j, port_prog))
    assert sorted(want) == sorted(flat_p), label
    for k in want:
        np.testing.assert_array_equal(flat_p[k], want[k], err_msg=f"{label} carry {k}")


@pytest.fixture(scope="module")
def jax_runs():
    """Each JAX program built and run once per module."""
    out = {}
    for name, (case, n, params, chunk) in CASES.items():
        prog = jax_program(case, n, params, chunk)
        res, (flat, _) = run_capturing(prog, seed=3, max_ticks=4096)
        out[name] = (res, flat)
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_run_matches_jax(name, jax_runs):
    case, n, params, chunk = CASES[name]
    res_j, flat_j = jax_runs[name]
    prog = port_program(case, n, params, chunk)
    res_p, (flat_p, _) = run_capturing(prog, seed=3, max_ticks=4096)
    assert (res_p["status"] == papi.SUCCESS).all(), name
    assert res_p["msgs_sent"] > 0
    assert_results_equal(res_j, res_p, name)
    assert_carries_equal(flat_j, prog, flat_p, name)


def test_resume_from_jax_carry_matches_jax():
    """JAX runs 24 ticks; its carry crosses into the port; both run on to
    completion from there and agree leaf for leaf."""
    case, n, params, chunk = CASES["sustained-16"]
    k = 24
    jprog = jax_program(case, n, params, 8)
    _, (flat_mid, jcarry) = run_capturing(jprog, seed=5, max_ticks=k)
    assert int(flat_mid["t"]) == k
    res_j, (flat_j, _) = run_capturing(
        jprog, seed=5, max_ticks=4096, resume_carry=jcarry, resume_ticks=k)

    pprog = port_program(case, n, params, 8)
    res_p, (flat_p, _) = run_capturing(
        pprog, max_ticks=4096,
        resume_carry=carry_from_numpy(flat_mid, pprog), resume_ticks=k)
    assert_results_equal(res_j, res_p, "resume")
    assert_carries_equal(flat_j, pprog, flat_p, "resume")


def test_port_constants_match_reference():
    for name in ("RUNNING", "SUCCESS", "FAILURE", "CRASH",
                 "FILTER_ACCEPT", "FILTER_REJECT", "FILTER_DROP"):
        assert getattr(papi, name) == getattr(japi, name), name
    for name in ("STATES", "TOPICS", "N_REGIONS", "FILTER_RULES", "MSG_WIDTH",
                 "OUT_MSGS", "IN_MSGS", "PUB_WIDTH", "SUB_K", "TOPIC_CAP",
                 "MAX_LINK_TICKS", "TRACK_SRC", "CROSS_TICK_STACKING",
                 "SLOT_MODE", "BW_QUEUE_MSGS", "SHAPING", "DEFAULT_LINK"):
        assert getattr(papi.SimTestcase, name) == getattr(japi.SimTestcase, name), name
    from testground_tpu.sim import net as jnet

    assert pnet.FULL_SHAPING == jnet.FULL_SHAPING
    assert pnet.MSG_BYTES == jnet.MSG_BYTES


def test_plan_statics_match_reference():
    from testground_tpu.api import RunGroup as JRunGroup
    from testground_tpu.sim.engine import build_groups as jbuild
    from testground_tpu.sim.executor import load_sim_testcases as jload

    jcases = jload(os.path.join(os.path.dirname(ge.__file__), "plans", "network"))
    pcases = load_sim_testcases(plan_dir("network"))
    for name, pcls in pcases.items():
        jcls = jcases[name]
        for attr in ("STATES", "MSG_WIDTH", "OUT_MSGS", "IN_MSGS", "MAX_LINK_TICKS",
                     "SHAPING", "TRACK_SRC", "SLOT_MODE", "DEFAULT_LINK"):
            assert getattr(pcls, attr) == getattr(jcls, attr), (name, attr)
        for lat in ("4", "100", "300"):
            layout = [(4, {"latency_ms": lat})]
            jt = jcls.specialize(jbuild(_run_groups(layout, None, JRunGroup)), 1.0)
            pt = pcls.specialize(build_groups(_run_groups(layout, None, RunGroup)), 1.0)
            assert jt.MAX_LINK_TICKS == pt.MAX_LINK_TICKS, (name, lat)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sync_fold_with_topics_matches_jax(seed):
    """``update_sync`` and ``make_sub_window`` with live topics (the
    network plans declare none): signals, publishes past a full topic,
    cursor advances, three ticks in a row."""
    from testground_tpu.sim import sync_kernel as jsync
    from testground_tpu_torch.sim import sync_kernel as psync

    rng = np.random.default_rng(seed)
    n, s, t, cap, pw, k = 9, 2, 3, 5, 2, 3
    js = jsync.make_sync_state(n, s, t, cap, pw)
    ps = psync.make_sync_state(n, s, t, cap, pw, device="cpu")
    for _ in range(3):
        args = [rng.integers(0, 2, (s, n)).astype(np.int32),
                rng.integers(0, 99, (t, pw, n)).astype(np.int32),
                rng.random((t, n)) < 0.4,
                rng.integers(-1, 3, (t, n)).astype(np.int32)]
        js = jsync.update_sync(js, *[jnp.asarray(a) for a in args])
        ps = psync.update_sync(ps, *[torch.from_numpy(a) for a in args])
        for f in ("counts", "last_seq", "stream", "stream_len", "cursors", "dropped"):
            np.testing.assert_array_equal(
                getattr(ps, f).numpy(), np.asarray(getattr(js, f)), err_msg=f)
        jp, jv = jsync.make_sub_window(js, k)  # [N, T, K, PW], [N, T, K]
        pp, pv = psync.make_sub_window(ps, k)  # [T, K, PW, N], [T, K, N]
        np.testing.assert_array_equal(pp.permute(3, 0, 1, 2).numpy(), np.asarray(jp))
        np.testing.assert_array_equal(pv.permute(2, 0, 1).numpy(), np.asarray(jv))
    assert int(ps.dropped.sum()) > 0  # a topic filled up


class _Direct(papi.SimTestcase):
    SLOT_MODE = "direct"


class _Dup(papi.SimTestcase):
    SHAPING = ("latency", "duplicate")


class _Rules(papi.SimTestcase):
    SHAPING = ("latency", "filter_rules")
    FILTER_RULES = 2


def _groups(n=4):
    return build_groups([RunGroup(id="all", instances=n)])


@pytest.mark.parametrize(
    "tc,kw,item",
    [
        (papi.SimTestcase, {"live_counts": (4,)}, "item 13"),
    ],
)
def test_unported_options_refuse_loudly(tc, kw, item):
    """``live_counts``, refused until shape buckets were ported: the
    program builds with the bucket leaf, and what the port still refuses of
    it — other live counts at ``init_carry`` than the program's, and live
    counts on a program without a bucket plan — refuses loudly."""
    prog = SimProgram(tc(), _groups(8), device="cpu", **kw)
    carry = prog.init_carry(1)
    assert carry.live_counts.tolist() == [4] and prog.virtual_groups()[0].count == 4
    assert (carry.status == papi.CRASH).sum() == 4  # the dead lanes
    with pytest.raises(ValueError, match="differ from the program's bucket plan"):
        prog.init_carry(1, (3,))
    with pytest.raises(ValueError, match="exactly when the program was built"):
        SimProgram(tc(), _groups(), device="cpu").init_carry(1, (4,))


def _crash_schedule():
    from testground_tpu_torch.sim.faults import build_fault_schedule

    return build_fault_schedule(_groups(), {"": [{"kind": "crash", "start_ms": 2}]}, 1.0)


_HOST = {"hosts": ("http-echo",)}


@pytest.mark.parametrize(
    "tc,kw",
    [(papi.SimTestcase, {"validate": True}), (_Direct, {}), (_Dup, {}), (_Rules, {}),
     (papi.SimTestcase, _HOST), (papi.SimTestcase, {"validate": True, **_HOST}),
     (_Dup, _HOST), (_Rules, _HOST), (papi.SimTestcase, {"faults": "crash"}),
     (_Rules, {"faults": "crash", **_HOST}), (papi.SimTestcase, {"telemetry": True}),
     (_Direct, {"telemetry": True, "netmatrix": True}),
     (papi.SimTestcase, {"trace": "0:2", "faults": "crash", **_HOST}),
     (_Dup, {"telemetry": True, "netmatrix": True, "trace": "0:2", **_HOST})],
    ids=["validate", "direct", "duplicate", "filter_rules", "hosts", "validate+hosts",
         "duplicate+hosts", "filter_rules+hosts", "faults", "filter_rules+faults+hosts",
         "telemetry", "direct+telemetry+netmatrix", "trace+faults+hosts",
         "every-plane+duplicate+hosts"],
)
def test_ported_options_build(tc, kw):
    if kw.get("faults") == "crash":
        kw = {**kw, "faults": _crash_schedule()}
    if kw.get("trace") == "0:2":
        from testground_tpu_torch.sim.trace import build_trace_plan

        kw = {**kw, "trace": build_trace_plan(_groups(), {"": {"instances": "0:2"}})}
    prog = SimProgram(tc(), _groups(), device="cpu", **kw)
    carry = prog.init_carry(seed=1)
    assert (carry.link.rules is not None) == (tc is _Rules)
    lanes = 4 + len(kw.get("hosts", ()))
    assert carry.status.shape == carry.link.region_of.shape == (lanes,)
    assert carry.cal.occupancy_plane.shape[1] == lanes * tc.IN_MSGS
    assert carry.sync.last_seq.shape[1] == 4 and carry.keys.shape[0] == 4
    assert (carry.cal.etick is not None) == (carry.lat_hist is not None) == bool(
        kw.get("telemetry"))
    assert (carry.net_mat is not None) == bool(kw.get("netmatrix"))
    if kw.get("netmatrix"):
        assert carry.cal.src is not None  # the matrix forces provenance on


def _declaring(**statics):
    return statics


REFUSALS = {
    "filters+filter_rules": _declaring(SHAPING=("latency", "filters", "filter_rules"),
                                       FILTER_RULES=2),
    "filter_rules-without-K": _declaring(SHAPING=("latency", "filter_rules")),
    "bandwidth+bandwidth_queue": _declaring(SHAPING=("bandwidth", "bandwidth_queue")),
    "bandwidth_queue+direct": _declaring(SHAPING=("latency", "bandwidth_queue"),
                                         SLOT_MODE="direct"),
    "bandwidth_queue+duplicate": _declaring(SHAPING=("bandwidth_queue", "duplicate")),
    "nostack+duplicate": _declaring(SHAPING=("latency", "duplicate"),
                                    CROSS_TICK_STACKING=False),
    "nostack+bandwidth_queue": _declaring(SHAPING=("latency", "bandwidth_queue"),
                                          CROSS_TICK_STACKING=False),
}


@pytest.mark.parametrize("name", list(REFUSALS))
def test_admission_refusals_match_reference(name):
    """The reference's refusals of incompatible declarations, with its
    messages (``engine.py:504-562``)."""
    from testground_tpu.api import RunGroup as JRunGroup
    from testground_tpu.sim.engine import SimProgram as JSimProgram
    from testground_tpu.sim.engine import build_groups as jbuild

    statics = REFUSALS[name]
    jcls = type("J", (japi.SimTestcase,), dict(statics))
    pcls = type("P", (papi.SimTestcase,), dict(statics))
    with pytest.raises(ValueError) as jerr:
        JSimProgram(jcls(), jbuild([JRunGroup(id="all", instances=4)]))
    with pytest.raises(ValueError) as perr:
        SimProgram(pcls(), _groups(), device="cpu")
    assert str(perr.value) == str(jerr.value)


def test_bucketed_filter_rules_with_groups_refusal_matches_reference():
    from testground_tpu.api import RunGroup as JRunGroup
    from testground_tpu.sim.engine import SimProgram as JSimProgram
    from testground_tpu.sim.engine import build_groups as jbuild

    layout = [("a", 2), ("b", 2)]
    jg = jbuild([JRunGroup(id=i, instances=c) for i, c in layout])
    pg = build_groups([RunGroup(id=i, instances=c) for i, c in layout])
    with pytest.raises(ValueError) as jerr:
        JSimProgram(type("J", (japi.SimTestcase,), dict(SHAPING=("latency", "filter_rules"),
                                                        FILTER_RULES=1))(),
                    jg, live_counts=(2, 2))
    with pytest.raises(ValueError) as perr:
        SimProgram(_Rules(), pg, device="cpu", live_counts=(2, 2))
    assert str(perr.value) == str(jerr.value)


def test_env_key_is_lazy_and_matches_jax_fold():
    """``env.key`` is the tick folded into each instance key — computed
    only when a plan reads it."""
    prog = port_program("pingpong-sustained", 4, {}, 8)
    carry = prog.init_carry(seed=2)
    env = prog._env_for(prog.groups[0], carry.keys, tick=torch.tensor(9, dtype=torch.int32))
    assert env._key is None
    keys = jax.random.split(jax.random.split(jax.random.key(2))[1], 4)
    want = jax.random.key_data(jax.vmap(jax.random.fold_in)(keys, np.full(4, 9, np.int32)))
    np.testing.assert_array_equal(env.key.numpy(), np.asarray(want).astype(np.int64))
