"""Control lanes (additional hosts) in the port against the JAX package on
the CPU, bit for bit: ``SimEnv.host_index``, the reference's refusals of
hosts with incompatible declarations, whole runs of the
``additional_hosts`` plan (one group and two, odd counts), an inline echo
workload with every shaping feature on (the control route bypasses all of
it), hosts under a fault schedule (host lanes never fault), and a resume
from a JAX carry with host lanes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_engine import assert_carries_equal, assert_results_equal, run_capturing
from test_torch_plans import _ref_plan
from testground_tpu.api import RunGroup as JRunGroup
from testground_tpu.sim import api as japi
from testground_tpu.sim.engine import SimProgram as JSimProgram
from testground_tpu.sim.engine import build_groups as jbuild
from testground_tpu.sim.executor import instantiate_testcase as jinst
from testground_tpu.sim.executor import load_sim_testcases as jload
from testground_tpu.sim.faults import build_fault_schedule as jfaults
from testground_tpu_torch.api import RunGroup
from testground_tpu_torch.sim import api as papi
from testground_tpu_torch.sim.carry_io import carry_from_numpy
from testground_tpu_torch.sim.engine import SimProgram, build_groups
from testground_tpu_torch.sim.executor import (
    instantiate_testcase,
    load_sim_testcases,
    plan_dir,
)
from testground_tpu_torch.sim.faults import build_fault_schedule as pfaults
from testground_tpu_torch.sim.net import FULL_SHAPING

HOSTS = ("http-echo",)


def _layouts(layout):
    """``[(id, count, params)]`` → (JAX groups, port groups)."""
    return (jbuild([JRunGroup(id=i, instances=c, parameters=dict(p)) for i, c, p in layout]),
            build_groups([RunGroup(id=i, instances=c, parameters=dict(p))
                          for i, c, p in layout]))


def _env_pair(n=5, hosts=("a", "b")):
    jg, pg = _layouts([("g", n, {})])
    jenv = japi.SimEnv(test_plan="p", test_case="c", test_run="r", test_instance_count=n,
                       tick_ms=1.0, groups=jg, group=jg[0], global_seq=jnp.int32(0),
                       group_seq=jnp.int32(0), key=None, hosts=hosts)
    penv = papi.SimEnv(test_plan="p", test_case="c", test_run="r", test_instance_count=n,
                       tick_ms=1.0, groups=pg, group=pg[0], global_seq=None,
                       group_seq=None, device=torch.device("cpu"), hosts=hosts)
    return jenv, penv


def test_host_index_matches_reference():
    jenv, penv = _env_pair()
    assert [penv.host_index(h) for h in ("a", "b")] == [jenv.host_index(h)
                                                        for h in ("a", "b")] == [5, 6]
    with pytest.raises(KeyError) as jerr:
        jenv.host_index("c")
    with pytest.raises(KeyError) as perr:
        penv.host_index("c")
    assert str(perr.value) == str(jerr.value)


REFUSALS = {
    "no-stacking": dict(CROSS_TICK_STACKING=False),
    "no-src": dict(TRACK_SRC=False),
    "direct": dict(SLOT_MODE="direct"),
}


@pytest.mark.parametrize("name", list(REFUSALS))
def test_hosts_refusals_match_reference(name):
    jg, pg = _layouts([("all", 4, {})])
    jcls = type("J", (japi.SimTestcase,), dict(REFUSALS[name], SHAPING=("latency",)))
    pcls = type("P", (papi.SimTestcase,), dict(REFUSALS[name], SHAPING=("latency",)))
    with pytest.raises(ValueError) as jerr:
        JSimProgram(jcls(), jg, hosts=HOSTS)
    with pytest.raises(ValueError) as perr:
        SimProgram(pcls(), pg, device="cpu", hosts=HOSTS)
    assert str(perr.value) == str(jerr.value)
    # without hosts the same declarations build
    SimProgram(pcls(), pg, device="cpu")


def test_filter_cell_budget_counts_host_lanes(monkeypatch):
    import testground_tpu_torch.sim.engine as eng

    _, pg = _layouts([("all", 4, {})])
    monkeypatch.setattr(eng, "MAX_FILTER_CELLS", 4)  # one region × 4 lanes fits
    SimProgram(papi.SimTestcase(), pg, device="cpu")
    with pytest.raises(ValueError, match="MAX_FILTER_CELLS budget"):
        SimProgram(papi.SimTestcase(), pg, device="cpu", hosts=HOSTS)


# ------------------------------------------------------------ whole runs


def _plan_pair(case, layout, chunk=8, faults=None, hosts=HOSTS):
    jg, pg = _layouts(layout)
    jtc = jinst(jload(_ref_plan("additional_hosts"))[case], jg, 1.0)
    ptc = instantiate_testcase(load_sim_testcases(plan_dir("additional_hosts"))[case], pg,
                               1.0)
    kw = dict(tick_ms=1.0, chunk=chunk, hosts=hosts)
    return (JSimProgram(jtc, jg, faults=faults and jfaults(jg, faults, 1.0), **kw),
            SimProgram(ptc, pg, device="cpu", faults=faults and pfaults(pg, faults, 1.0),
                       **kw))


class _JEcho(japi.SimTestcase):
    """Ring traffic in slot 0 and a request to the echo host in slot 1,
    over links with every shaping knob on and an admission cap of one
    message a tick; odd instances DROP the data plane from tick 1. Only
    the control route survives all of it."""

    SHAPING = FULL_SHAPING
    MSG_WIDTH = 2
    OUT_MSGS = 2
    IN_MSGS = 8
    MAX_LINK_TICKS = 16
    DEFAULT_LINK = (3.0, 2.0, 256_000.0, 30.0, 20.0, 20.0, 30.0)

    def init(self, env):
        return {"echoes": jnp.int32(0), "ring": jnp.int32(0)}

    def step(self, env, state, inbox, sync, t):
        host = env.host_index("echo")
        n = env.test_instance_count
        from_host = inbox.valid & (inbox.src == host)
        send = t < 12
        return self.out(
            {"echoes": state["echoes"] + jnp.sum(from_host.astype(jnp.int32)),
             "ring": state["ring"] + jnp.sum((inbox.valid & ~from_host).astype(jnp.int32))},
            status=jnp.where(t >= 24, japi.SUCCESS, japi.RUNNING),
            outbox=japi.Outbox(
                dst=jnp.stack([jnp.mod(env.global_seq + 1, n), jnp.int32(host)]),
                payload=jnp.stack([jnp.stack([jnp.int32(2), t]),
                                   jnp.stack([jnp.int32(1), env.global_seq])]),
                valid=jnp.stack([send, send])),
            net_filters=jnp.full((1,), japi.FILTER_DROP, jnp.int32),
            net_filters_valid=(t == 1) & (env.global_seq % 2 == 1),
        )


class _PEcho(papi.SimTestcase):
    """Twin of :class:`_JEcho`."""

    SHAPING = FULL_SHAPING
    MSG_WIDTH = 2
    OUT_MSGS = 2
    IN_MSGS = 8
    MAX_LINK_TICKS = 16
    DEFAULT_LINK = (3.0, 2.0, 256_000.0, 30.0, 20.0, 20.0, 30.0)

    def init(self, env):
        z = torch.zeros(env.group.count, dtype=torch.int32)
        return {"echoes": z, "ring": z.clone()}

    def step(self, env, state, inbox, sync, t):
        host = env.host_index("echo")
        n = env.test_instance_count
        seq = env.global_seq
        from_host = inbox.valid & (inbox.src == host)
        send = (t < 12).expand(seq.shape)
        return self.out(
            {"echoes": state["echoes"] + from_host.sum(dim=0, dtype=torch.int32),
             "ring": state["ring"] + (inbox.valid & ~from_host).sum(dim=0, dtype=torch.int32)},
            status=torch.where(t >= 24, papi.SUCCESS, papi.RUNNING),
            outbox=papi.Outbox(
                dst=torch.stack([torch.remainder(seq + 1, n), torch.full_like(seq, host)]),
                payload=torch.stack([torch.stack([torch.full_like(seq, 2), t + 0 * seq]),
                                     torch.stack([torch.ones_like(seq), seq])]),
                valid=torch.stack([send, send])),
            net_filters=torch.full((1, 1), papi.FILTER_DROP, dtype=torch.int32),
            net_filters_valid=(t == 1) & (torch.remainder(seq, 2) == 1),
        )


def _echo_pair(n=8, chunk=8):
    jg, pg = _layouts([("all", n, {})])
    kw = dict(tick_ms=1.0, chunk=chunk, hosts=("echo",))
    return JSimProgram(_JEcho(), jg, **kw), SimProgram(_PEcho(), pg, device="cpu", **kw)


# name: (make (JAX program, port program), max_ticks)
RUNS = {
    "one-group-7": (lambda: _plan_pair("additional_hosts", [("all", 7, {})]), 1024),
    "two-groups-drop": (lambda: _plan_pair("additional_hosts_drop",
                                           [("a", 3, {}), ("b", 4, {})]), 1024),
    "one-instance": (lambda: _plan_pair("additional_hosts", [("all", 1, {})]), 64),
    "under-faults": (lambda: _plan_pair(
        "additional_hosts", [("all", 8, {})],
        # instances 6 and 7 send at ticks 4 and 5, after their restart;
        # the windows hit requests, which the control route exempts
        faults={"": [{"kind": "crash", "start_ms": 1, "instances": "6:8"},
                     {"kind": "restart", "start_ms": 3, "instances": "6:8"},
                     {"kind": "loss_burst", "start_ms": 2, "duration_ms": 3,
                      "loss": 100.0, "instances": "2:4"},
                     {"kind": "partition", "start_ms": 2, "duration_ms": 6,
                      "instances": "4:6", "to_instances": "6:8"}]}), 1024),
    "echo-through-every-shaping-feature": (_echo_pair, 64),
}


@pytest.mark.parametrize("name", list(RUNS))
def test_hosts_run_matches_jax(name):
    make, max_ticks = RUNS[name]
    jprog, pprog = make()
    res_j, (flat_j, _) = run_capturing(jprog, seed=3, max_ticks=max_ticks)
    res_p, (flat_p, _) = run_capturing(pprog, seed=3, max_ticks=max_ticks)
    assert (res_p["status"] == papi.SUCCESS).all(), (name, res_p["status"])
    assert res_p["status"].shape == (pprog.n,)
    assert_results_equal(res_j, res_p, name)
    assert_carries_equal(flat_j, pprog, flat_p, name)
    assert res_p["msgs_sent"] == (res_p["msgs_delivered"] + res_p["cal_depth"]
                                  + res_p["msgs_dropped"] + res_p["msgs_rejected"]
                                  + res_p["fault_dropped"])
    if name == "echo-through-every-shaping-feature":
        # every request and every echo made it; the ring lost messages
        assert (res_p["states"][0]["echoes"] == 12).all()
        assert res_p["msgs_dropped"] > 0
    if name == "under-faults":
        assert res_p["faults_crashed"] == 2 and res_p["faults_restarted"] == 2


def test_resume_from_jax_carry_with_host_lanes():
    jprog, pprog = _echo_pair(chunk=4)
    k = 8
    _, (flat_mid, jcarry) = run_capturing(jprog, seed=5, max_ticks=k)
    assert flat_mid["status"].shape == (9,) and flat_mid["cal.src"].size == 16 * 9 * 8
    res_j, (flat_j, _) = run_capturing(jprog, seed=5, max_ticks=256,
                                       resume_carry=jcarry, resume_ticks=k)
    res_p, (flat_p, _) = run_capturing(pprog, max_ticks=256,
                                       resume_carry=carry_from_numpy(flat_mid, pprog),
                                       resume_ticks=k)
    assert_results_equal(res_j, res_p, "hosts resume")
    assert_carries_equal(flat_j, pprog, flat_p, "hosts resume")
    np.testing.assert_array_equal(flat_p["status"][8:], [papi.RUNNING])
