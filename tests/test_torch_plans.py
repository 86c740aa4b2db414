"""Whole runs of the port's ``benchmarks`` plan (all seven cases) and the
``network`` plan's four ``traffic-*`` cases against the JAX package, on
the CPU, bit for bit: every ``results()`` key, every state leaf, the
final carry through ``carry_io`` and the plans' ``collect_metrics``. The
JAX side is built by ``__graft_entry__._plan_program``; flood/direct and
storm/random-graph take the parameters of the reference's transport
matrix (``tests/test_transport_pallas.py``). Inline workloads cover what
no shipped plan leaves on: a duplicate ring and a range-ruled ring (twins
of ``__graft_entry__``'s), an HTB ring whose rate changes under a standing
backlog, and direct slots under ``validate`` with forced collisions. Two
resumes carry a JAX carry holding ``link.backlog`` / ``link.rules`` into
the port."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from test_torch_engine import (
    assert_carries_equal,
    assert_results_equal,
    run_capturing,
)
from testground_tpu.api import RunGroup as JRunGroup
from testground_tpu.sim import api as japi
from testground_tpu.sim.engine import SimProgram as JSimProgram
from testground_tpu.sim.engine import build_groups as jbuild
from testground_tpu_torch.api import RunGroup
from testground_tpu_torch.sim import api as papi
from testground_tpu_torch.sim.carry_io import carry_from_numpy
from testground_tpu_torch.sim.engine import SimProgram, build_groups
from testground_tpu_torch.sim.executor import (
    instantiate_testcase,
    load_sim_testcases,
    plan_dir,
)

# name: (plan, case, n, params, max_ticks)
PLAN_CASES = {
    "flood/direct": ("benchmarks", "pingpong-flood", 8,
                     {"duration_ticks": "64", "latency_ms": "4"}, 512),
    "flood-7-solo": ("benchmarks", "pingpong-flood", 7,
                     {"duration_ticks": "40", "latency_ms": "3"}, 512),
    "storm/random-graph": ("benchmarks", "storm", 16,
                           {"conn_outgoing": "3", "conn_delay_ticks": "8",
                            "data_size_kb": "16"}, 512),
    "storm-k8": ("benchmarks", "storm", 12,
                              {"conn_outgoing": "8", "conn_delay_ticks": "2",
                               "data_size_kb": "12"}, 512),
    "barrier": ("benchmarks", "barrier", 8, {"barrier_iterations": "2"}, 512),
    "netinit": ("benchmarks", "netinit", 8, {}, 64),
    "netlinkshape": ("benchmarks", "netlinkshape", 8, {"latency_ms": "20"}, 256),
    "subtree": ("benchmarks", "subtree", 8, {"subtree_iterations": "4"}, 512),
    "startup": ("benchmarks", "startup", 8, {}, 64),
    "traffic-allowed": ("network", "traffic-allowed", 8, {"wait_ticks": "10"}, 256),
    "traffic-blocked": ("network", "traffic-blocked", 8, {"wait_ticks": "10"}, 256),
    "traffic-shaped": ("network", "traffic-shaped", 8,
                       {"burst": "12", "rate": "1.5"}, 256),
    "traffic-ruled": ("network", "traffic-ruled", 8, {}, 256),
}


def _ref_plan(plan):
    """The JAX package's directory of ``plan``."""
    return os.path.join(os.path.dirname(ge.__file__), "plans", plan)


def _port_plan_program(plan, case, n, params, chunk=8, **kw):
    factory = load_sim_testcases(plan_dir(plan))[case]
    groups = build_groups([RunGroup(id="all", instances=n, parameters=dict(params))])
    return SimProgram(instantiate_testcase(factory, groups, 1.0), groups,
                      test_plan=plan, test_case=case, tick_ms=1.0, chunk=chunk,
                      device="cpu", **kw)


def _metrics(prog, res):
    tc = prog.tc
    return tc.collect_metrics(prog.groups[0], res["states"][0], res["status"])


@pytest.mark.parametrize("name", list(PLAN_CASES))
def test_plan_case_matches_jax(name):
    plan, case, n, params, max_ticks = PLAN_CASES[name]
    jprog = ge._plan_program(plan, case, n, params, chunk=8)
    res_j, (flat_j, _) = run_capturing(jprog, seed=3, max_ticks=max_ticks)
    pprog = _port_plan_program(plan, case, n, params)
    res_p, (flat_p, _) = run_capturing(pprog, seed=3, max_ticks=max_ticks)
    assert (res_p["status"] == papi.SUCCESS).all(), name
    assert_results_equal(res_j, res_p, name)
    assert_carries_equal(flat_j, pprog, flat_p, name)
    if hasattr(jprog.tc, "collect_metrics"):
        mj, mp = _metrics(jprog, res_j), _metrics(pprog, res_p)
        assert sorted(mj) == sorted(mp), name
        for k in mj:
            np.testing.assert_array_equal(np.asarray(mp[k]), np.asarray(mj[k]), err_msg=k)


def test_storm_fan_in_overflow_matches_jax_and_shows_in_dropped():
    """Fan-in past IN_MSGS in one tick drops, counted in ``msgs_dropped``
    so that the flow totals still close. At test scale the Poisson tail
    never passes 16, so both packages' storm runs with IN_MSGS = 4."""
    from testground_tpu.sim.engine import SimProgram as JProg
    from testground_tpu.sim.executor import load_sim_testcases as jload

    params = {"conn_outgoing": "6", "conn_delay_ticks": "4", "data_size_kb": "16"}
    jstorm = jload(_ref_plan("benchmarks"))["storm"]
    pstorm = load_sim_testcases(plan_dir("benchmarks"))["storm"]
    jgroups = jbuild([JRunGroup(id="all", instances=12, parameters=params)])
    pgroups = build_groups([RunGroup(id="all", instances=12, parameters=params)])
    jcls = type("S4", (jstorm.specialize(jgroups),), {"IN_MSGS": 4})
    pcls = type("S4", (pstorm.specialize(pgroups),), {"IN_MSGS": 4})
    jprog = JProg(jcls(), jgroups, tick_ms=1.0, chunk=8)
    pprog = SimProgram(pcls(), pgroups, tick_ms=1.0, chunk=8, device="cpu")
    res_j, (flat_j, _) = run_capturing(jprog, seed=3, max_ticks=512)
    res_p, (flat_p, _) = run_capturing(pprog, seed=3, max_ticks=512)
    assert_results_equal(res_j, res_p, "storm IN_MSGS=4")
    assert_carries_equal(flat_j, pprog, flat_p, "storm IN_MSGS=4")
    assert res_p["msgs_dropped"] > 0
    assert res_p["msgs_sent"] == (res_p["msgs_delivered"] + res_p["cal_depth"]
                                  + res_p["msgs_dropped"] + res_p["msgs_rejected"])


def test_benchmarks_statics_match_reference():
    from testground_tpu.sim.executor import load_sim_testcases as jload

    jcases = jload(_ref_plan("benchmarks"))
    pcases = load_sim_testcases(plan_dir("benchmarks"))
    assert sorted(jcases) == sorted(pcases)
    jnet_cases = jload(_ref_plan("network"))
    assert sorted(jnet_cases) == sorted(load_sim_testcases(plan_dir("network")))
    for name, pcls in pcases.items():
        jcls = jcases[name]
        for attr in ("STATES", "TOPICS", "MSG_WIDTH", "OUT_MSGS", "IN_MSGS",
                     "PUB_WIDTH", "SUB_K", "TOPIC_CAP", "MAX_LINK_TICKS", "SHAPING",
                     "TRACK_SRC", "SLOT_MODE", "CROSS_TICK_STACKING", "DEFAULT_LINK"):
            assert getattr(pcls, attr) == getattr(jcls, attr), (name, attr)
    for k in ("1", "3", "5", "8", "12"):
        layout = {"conn_outgoing": k}
        jt = jcases["storm"].specialize(jbuild([JRunGroup("g", 4, parameters=layout)]))
        pt = pcases["storm"].specialize(build_groups([RunGroup("g", 4, parameters=layout)]))
        assert jt.OUT_MSGS == pt.OUT_MSGS, k


# ------------------------------------------------------ inline workloads


class _DupRing(papi.SimTestcase):
    """Twin of ``__graft_entry__._dup_ring_testcase``: a ring where every
    link duplicates 50% of messages."""

    SHAPING = ("latency", "duplicate")
    MSG_WIDTH = 1
    OUT_MSGS = 1
    IN_MSGS = 8
    MAX_LINK_TICKS = 8
    DEFAULT_LINK = (2.0, 0.0, 0.0, 0.0, 0.0, 0.0, 50.0)

    def init(self, env):
        return {"received": torch.zeros(env.group_lanes, dtype=torch.int32)}

    def step(self, env, state, inbox, sync, t):
        n = env.test_instance_count
        dst = torch.remainder(env.global_seq + 1, n)
        return self.out(
            {"received": state["received"] + inbox.count},
            status=torch.where(t >= 40, papi.SUCCESS, papi.RUNNING),
            outbox=papi.Outbox.single(dst, [1], t < 32, 1, 1),
        )


class _RuledRing(papi.SimTestcase):
    """Twin of ``__graft_entry__._ruled_ring_testcase``: odd instances
    install a REJECT range rule over their successor at tick 8."""

    SHAPING = ("latency", "filter_rules")
    FILTER_RULES = 2
    MSG_WIDTH = 1
    OUT_MSGS = 1
    IN_MSGS = 4
    MAX_LINK_TICKS = 8
    DEFAULT_LINK = (2.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0)

    def init(self, env):
        z = torch.zeros(env.group_lanes, dtype=torch.int32)
        return {"received": z, "rejected": z.clone()}

    def step(self, env, state, inbox, sync, t):
        n = env.test_instance_count
        seq = env.global_seq
        succ = torch.remainder(seq + 1, n)
        odd = torch.remainder(seq, 2) == 1
        received = state["received"] + inbox.count
        rejected = state["rejected"] + sync.rejected
        pred_odd = torch.remainder(torch.remainder(seq - 1, n), 2) == 1
        ok = (received == torch.where(pred_odd, 9, 24)) & (
            rejected == torch.where(odd, 15, 0)
        )
        return self.out(
            {"received": received, "rejected": rejected},
            status=torch.where((t >= 32) & ok, papi.SUCCESS, papi.RUNNING),
            outbox=papi.Outbox.single(succ, [1], t < 24, 1, 1),
            net_rules=self.filter_rules((succ, succ + 1, papi.FILTER_REJECT)),
            net_rules_valid=(t == 8) & odd,
        )


def _rate_change_pair():
    """An HTB ring (4 messages a tick for 6 ticks at 1 msg/tick, queue
    bound 8) whose even instances double their rate at tick 3 under a
    standing backlog — the ``bw_rate_change_backlogged`` count and the
    queue's tail drops — as a JAX testcase and its torch twin."""
    shaping = ("latency", "bandwidth_queue")
    link = (1.0, 0.0, 256_000.0, 0.0, 0.0, 0.0, 0.0)
    statics = dict(SHAPING=shaping, MSG_WIDTH=1, OUT_MSGS=4, IN_MSGS=8,
                   MAX_LINK_TICKS=32, BW_QUEUE_MSGS=8, DEFAULT_LINK=link)

    class J(japi.SimTestcase):
        locals().update(statics)

        def init(self, env):
            return {"received": jnp.int32(0)}

        def step(self, env, state, inbox, sync, t):
            n = env.test_instance_count
            succ = jnp.mod(env.global_seq + 1, n)
            even = env.global_seq % 2 == 0
            return self.out(
                {"received": state["received"] + inbox.count},
                status=jnp.where(t >= 30, japi.SUCCESS, japi.RUNNING),
                outbox=japi.Outbox(dst=jnp.full((4,), succ, jnp.int32),
                                   payload=jnp.ones((4, 1), jnp.int32),
                                   valid=jnp.full((4,), t < 6, bool)),
                net_shape=self.link_shape(1.0, 0.0, 512_000.0),
                net_shape_valid=(t == 3) & even,
            )

    class P(papi.SimTestcase):
        locals().update(statics)

        def init(self, env):
            return {"received": torch.zeros(env.group_lanes, dtype=torch.int32)}

        def step(self, env, state, inbox, sync, t):
            n = env.test_instance_count
            succ = torch.remainder(env.global_seq + 1, n)
            even = torch.remainder(env.global_seq, 2) == 0
            return self.out(
                {"received": state["received"] + inbox.count},
                status=torch.where(t >= 30, papi.SUCCESS, papi.RUNNING),
                outbox=papi.Outbox(dst=succ[None, :].expand(4, -1),
                                   payload=torch.ones((4, 1, 1), dtype=torch.int32),
                                   valid=(t < 6).reshape(1, 1).expand(4, 1)),
                net_shape=self.link_shape(1.0, 0.0, 512_000.0, device=env.device)[:, None],
                net_shape_valid=(t == 3) & even,
            )

    return J, P


def _collide_pair():
    """Direct slots with fan-in every fourth tick (everyone sends to
    instance 0 or 1), run under ``validate``: the collisions and the first
    (dst, slot) are counted. Plans see only inbox counts, so the undefined
    winner of a collision never reaches a state."""
    statics = dict(SHAPING=("latency",), SLOT_MODE="direct", TRACK_SRC=False,
                   MSG_WIDTH=1, OUT_MSGS=1, IN_MSGS=2, MAX_LINK_TICKS=4)

    class J(japi.SimTestcase):
        locals().update(statics)

        def init(self, env):
            return {"received": jnp.int32(0)}

        def step(self, env, state, inbox, sync, t):
            n = env.test_instance_count
            dst = jnp.where(t % 4 == 3, env.global_seq % 2, jnp.mod(env.global_seq + 1, n))
            return self.out(
                {"received": state["received"] + inbox.count},
                status=jnp.where(t >= 20, japi.SUCCESS, japi.RUNNING),
                outbox=japi.Outbox.single(dst, jnp.asarray([7]), t < 16, 1, 1),
            )

    class P(papi.SimTestcase):
        locals().update(statics)

        def init(self, env):
            return {"received": torch.zeros(env.group.count, dtype=torch.int32)}

        def step(self, env, state, inbox, sync, t):
            n = env.test_instance_count
            seq = env.global_seq
            dst = torch.where(torch.remainder(t, 4) == 3, torch.remainder(seq, 2),
                              torch.remainder(seq + 1, n))
            return self.out(
                {"received": state["received"] + inbox.count},
                status=torch.where(t >= 20, papi.SUCCESS, papi.RUNNING),
                outbox=papi.Outbox.single(dst, [7], t < 16, 1, 1),
            )

    return J, P


INLINE = {
    "ring/duplicate": (ge._dup_ring_testcase, lambda: _DupRing, 8, {}),
    "ruled-ring/filter-rules": (ge._ruled_ring_testcase, lambda: _RuledRing, 8, {}),
    "htb-rate-change": (lambda: _rate_change_pair()[0], lambda: _rate_change_pair()[1], 8, {}),
    "direct-validate-collisions": (lambda: _collide_pair()[0], lambda: _collide_pair()[1],
                                   8, {"validate": True}),
}


def _inline_programs(name, chunk=8):
    jfac, pfac, n, kw = INLINE[name]
    jcls, pcls = jfac(), pfac()
    jprog = JSimProgram(jcls(), jbuild([JRunGroup(id="all", instances=n)]),
                        tick_ms=1.0, chunk=chunk, **kw)
    pprog = SimProgram(pcls(), build_groups([RunGroup(id="all", instances=n)]),
                       tick_ms=1.0, chunk=chunk, device="cpu", **kw)
    return jprog, pprog


@pytest.mark.parametrize("name", list(INLINE))
def test_inline_workload_matches_jax(name):
    jprog, pprog = _inline_programs(name)
    res_j, (flat_j, _) = run_capturing(jprog, seed=3, max_ticks=128)
    res_p, (flat_p, _) = run_capturing(pprog, seed=3, max_ticks=128)
    assert (res_p["status"] == papi.SUCCESS).all(), name
    assert_results_equal(res_j, res_p, name)
    assert res_p["collision_where"] == list(res_j["collision_where"])
    if name == "direct-validate-collisions":
        # the winner of a collision is undefined: payload planes may differ
        assert int(flat_p["collisions"]) > 0
        drop = [k for k in flat_j if k.startswith("cal.payload.")]
        assert_carries_equal({k: v for k, v in flat_j.items() if k not in drop}, pprog,
                             {k: v for k, v in flat_p.items() if k not in drop}, name)
        return
    assert_carries_equal(flat_j, pprog, flat_p, name)
    if name == "htb-rate-change":
        assert res_p["bw_rate_change_backlogged"] > 0
        assert res_p["bw_queue_dropped"] > 0
    if name == "ring/duplicate":
        assert res_p["msgs_sent"] > 8 * 32  # copies count as sent


# ---------------------------------------------------------------- resumes


RESUMES = {
    # (JAX program, port program, ticks before the crossing)
    "traffic-shaped/backlog": (
        lambda: ge._plan_program("network", "traffic-shaped", 8,
                                 {"burst": "12", "rate": "1.5"}, chunk=4),
        lambda: _port_plan_program("network", "traffic-shaped", 8,
                                   {"burst": "12", "rate": "1.5"}, chunk=4),
        4, "link.backlog"),
    "ruled-ring/rules": (
        lambda: _inline_programs("ruled-ring/filter-rules", chunk=4)[0],
        lambda: _inline_programs("ruled-ring/filter-rules", chunk=4)[1],
        12, "link.rules"),
}


@pytest.mark.parametrize("name", list(RESUMES))
def test_resume_from_jax_carry_with_new_link_leaves(name):
    """JAX runs k ticks; its carry, holding the HTB backlog or the rule
    planes, crosses into the port; both run on to completion and agree
    leaf for leaf."""
    make_j, make_p, k, leaf = RESUMES[name]
    jprog = make_j()
    _, (flat_mid, jcarry) = run_capturing(jprog, seed=5, max_ticks=k)
    assert leaf in flat_mid and np.asarray(flat_mid[leaf]).any(), leaf
    res_j, (flat_j, _) = run_capturing(jprog, seed=5, max_ticks=512,
                                       resume_carry=jcarry, resume_ticks=k)
    pprog = make_p()
    res_p, (flat_p, _) = run_capturing(
        pprog, max_ticks=512, resume_carry=carry_from_numpy(flat_mid, pprog),
        resume_ticks=k)
    assert (res_p["status"] == papi.SUCCESS).all()
    assert_results_equal(res_j, res_p, name)
    assert_carries_equal(flat_j, pprog, flat_p, name)


# ----------------------------------------- placebo, verify, splitbrain,
# additional_hosts and chaos


def _smoke_faults():
    """The fault tables of ``plans/chaos/_compositions/smoke.toml``."""
    import tomllib

    with open(os.path.join(_ref_plan("chaos"), "_compositions", "smoke.toml"), "rb") as f:
        comp = tomllib.load(f)
    return {g["id"]: g["run"]["faults"] for g in comp["groups"]}


# name: (plan, case, n, params, max_ticks, options, expected status)
# options: {"hosts": (...)} and/or {"faults": tables by group id}
NEW_PLAN_CASES = {
    "placebo/ok": ("placebo", "ok", 4, {}, 16, {}, papi.SUCCESS),
    "placebo/abort": ("placebo", "abort", 4, {}, 16, {}, papi.FAILURE),
    "placebo/panic": ("placebo", "panic", 4, {}, 16, {}, papi.CRASH),
    "placebo/stall": ("placebo", "stall", 4, {}, 24, {}, papi.RUNNING),
    "placebo/silent": ("placebo", "silent", 4, {}, 24, {}, papi.RUNNING),
    "placebo/optional-failure": ("placebo", "optional-failure", 4,
                                 {"should_fail": "true"}, 16, {}, papi.FAILURE),
    "placebo/optional-success": ("placebo", "optional-failure", 4, {}, 16, {},
                                 papi.SUCCESS),
    "placebo/metrics": ("placebo", "metrics", 4, {}, 32, {}, papi.SUCCESS),
    "verify/uses-data-network": ("verify", "uses-data-network", 6, {"pings": "3"},
                                 256, {}, papi.SUCCESS),
    "verify/uses-data-network-drop": ("verify", "uses-data-network-drop", 6,
                                      {"pings": "3"}, 256, {}, papi.SUCCESS),
    "splitbrain/accept": ("splitbrain", "accept", 9, {}, 512, {}, papi.SUCCESS),
    "splitbrain/drop": ("splitbrain", "drop", 9, {}, 512, {}, papi.SUCCESS),
    # the reference's 9-workload matrix row (tests/test_transport_pallas.py)
    "splitbrain/filters+regions": ("splitbrain", "reject", 15, {}, 2048, {},
                                   papi.SUCCESS),
    # the matrix row's control lanes, and the DROP-all data plane
    "additional-hosts/control-lanes": ("additional_hosts", "additional_hosts", 8, {},
                                       1024, {"hosts": ("http-echo",)}, papi.SUCCESS),
    "additional-hosts/drop": ("additional_hosts", "additional_hosts_drop", 8, {},
                              1024, {"hosts": ("http-echo",)}, papi.SUCCESS),
    "chaos/smoke": ("chaos", "chaos-barrier", 8, {}, 512, {"faults": "smoke"},
                    papi.SUCCESS),
    # a restart revives plan-crashed slots too; they panic again
    "placebo/panic-restarted": ("placebo", "panic", 4, {}, 16,
                                {"faults": {"all": [{"kind": "restart", "start_ms": 3,
                                                     "instances": "1:3"}]}},
                                papi.CRASH),
}


def _new_plan_programs(name, chunk=16):
    """The JAX package's program and the port's for one NEW_PLAN_CASES
    entry, each with its own package's fault schedule."""
    from testground_tpu.sim.executor import instantiate_testcase as jinst
    from testground_tpu.sim.executor import load_sim_testcases as jload
    from testground_tpu.sim.faults import build_fault_schedule as jfaults
    from testground_tpu_torch.sim.faults import build_fault_schedule as pfaults

    plan, case, n, params, _, opts, _ = NEW_PLAN_CASES[name]
    tables = opts.get("faults", {})
    if tables == "smoke":
        tables = _smoke_faults()
    hosts = opts.get("hosts", ())
    jgroups = jbuild([JRunGroup(id="all", instances=n, parameters=dict(params))])
    pgroups = build_groups([RunGroup(id="all", instances=n, parameters=dict(params))])
    jtc = jinst(jload(_ref_plan(plan))[case], jgroups, 1.0)
    ptc = instantiate_testcase(load_sim_testcases(plan_dir(plan))[case], pgroups, 1.0)
    meta = dict(test_plan=plan, test_case=case, tick_ms=1.0, chunk=chunk, hosts=hosts)
    jprog = JSimProgram(jtc, jgroups, faults=jfaults(jgroups, tables, 1.0), **meta)
    pprog = SimProgram(ptc, pgroups, faults=pfaults(pgroups, tables, 1.0),
                       device="cpu", **meta)
    return jprog, pprog


@pytest.mark.parametrize("name", list(NEW_PLAN_CASES))
def test_new_plan_case_matches_jax(name):
    """Every case of the five plan twins against the JAX plan: the
    expected terminal status on every instance, every ``results()`` key,
    every state leaf, the final carry and ``collect_metrics``."""
    max_ticks, want = NEW_PLAN_CASES[name][4], NEW_PLAN_CASES[name][6]
    jprog, pprog = _new_plan_programs(name)
    res_j, (flat_j, _) = run_capturing(jprog, seed=3, max_ticks=max_ticks)
    res_p, (flat_p, _) = run_capturing(pprog, seed=3, max_ticks=max_ticks)
    assert (res_p["status"] == want).all(), (name, res_p["status"])
    assert_results_equal(res_j, res_p, name)
    assert_carries_equal(flat_j, pprog, flat_p, name)
    if hasattr(jprog.tc, "collect_metrics"):
        mj, mp = _metrics(jprog, res_j), _metrics(pprog, res_p)
        assert sorted(mj) == sorted(mp), name
        for k in mj:
            np.testing.assert_array_equal(np.asarray(mp[k]), np.asarray(mj[k]), err_msg=k)
    if name == "placebo/panic-restarted":
        assert res_p["faults_restarted"] == 2
        assert res_p["finished_at"].tolist() == [0, 3, 3, 0]
    if name == "chaos/smoke":
        assert res_p["faults_crashed"] == 2 and res_p["faults_restarted"] == 2
        assert res_p["fault_dropped"] > 0
        assert res_p["msgs_sent"] == (
            res_p["msgs_delivered"] + res_p["cal_depth"] + res_p["msgs_dropped"]
            + res_p["msgs_rejected"] + res_p["fault_dropped"])
    if name.startswith("additional-hosts"):
        assert res_p["status"].shape == (8,)  # the host lane is sliced off
        assert res_p["msgs_delivered"] == 16  # 8 requests + 8 echoes


@pytest.mark.parametrize("plan", ["placebo", "verify", "splitbrain", "additional_hosts",
                                  "chaos"])
def test_new_plan_statics_match_reference(plan):
    from testground_tpu.sim.executor import load_sim_testcases as jload

    jcases = jload(_ref_plan(plan))
    pcases = load_sim_testcases(plan_dir(plan))
    assert sorted(jcases) == sorted(pcases)
    for name, pcls in pcases.items():
        jcls = jcases[name]
        for attr in ("STATES", "TOPICS", "N_REGIONS", "MSG_WIDTH", "OUT_MSGS", "IN_MSGS",
                     "PUB_WIDTH", "SUB_K", "TOPIC_CAP", "MAX_LINK_TICKS", "SHAPING",
                     "TRACK_SRC", "SLOT_MODE", "CROSS_TICK_STACKING", "DEFAULT_LINK"):
            assert getattr(pcls, attr) == getattr(jcls, attr), (name, attr)
        for attr in ("ACTION", "DROP_ALL", "DRAIN_TICKS"):
            assert getattr(pcls, attr, None) == getattr(jcls, attr, None), (name, attr)
