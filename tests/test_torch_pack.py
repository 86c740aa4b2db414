"""Run packs on the port (``testground_tpu_torch/sim/pack.py``) against the
JAX package, on the CPU:

- the width ladder, across both packages;
- the acceptance pin: every port plan case that admits packing, as a pack
  of members with different seeds (equal counts) and as a bucketed pack
  (different exact counts in one bucket), with telemetry: each member
  equals the reference's isolated EXACT-N run (ROADMAP R1, R2: never its
  packed or bucketed runs) under both transport knobs, and the port's
  isolated run — status, finished_at, every state leaf, every flow total,
  the sync counters, the telemetry stream row for row and the histogram;
- stragglers: members finishing at different ticks, a member whose own
  budget ends first, a member stopped by ``cancel_check``; each freezes at
  the reference's boundary;
- the run axis is real: the plan step issues the same ops at R = 2 and
  R = 8, and an op without a vmap batching rule raises;
- the refusals that remain: a trace, faults, hosts, a meshed inner
  program and ``transport = "pallas"`` on a meshed pack.
"""

import numpy as np
import pytest
import torch

from test_torch_engine import assert_results_equal
from test_torch_plans import INLINE, _ref_plan
from testground_tpu.api import RunGroup as JRunGroup
from testground_tpu.sim import pack as jpack
from testground_tpu.sim.engine import SimProgram as JSimProgram
from testground_tpu.sim.engine import build_groups as jbuild
from testground_tpu.sim.executor import instantiate_testcase as jinst
from testground_tpu.sim.executor import load_sim_testcases as jload
from testground_tpu_torch.api import RunGroup
from testground_tpu_torch.sim import api as papi
from testground_tpu_torch.sim import buckets as pb
from testground_tpu_torch.sim import pack as ppack
from testground_tpu_torch.sim.engine import SimProgram, build_groups
from testground_tpu_torch.sim.executor import (
    instantiate_testcase,
    load_sim_testcases,
    plan_dir,
)
from testground_tpu_torch.sim.pack import PackMember, PackRunner, pack_width

LADDER = (32, 64)
PP = {"latency_ms": "4", "latency2_ms": "2", "tolerance_ms": "15"}

# label: (plan, case, n, params, max_ticks, chunk, program kwargs); plan
# None is an inline twin of tests/test_torch_plans.py
PACKABLE = {
    "ping-pong": ("network", "ping-pong", 8, PP, 128, 8, {}),
    "sustained": ("network", "pingpong-sustained", 16,
                  {"duration_ticks": "40", "reshape_every": "16"}, 128, 16, {}),
    "traffic-shaped": ("network", "traffic-shaped", 8, {"burst": "12", "rate": "1.5"},
                       256, 8, {}),
    "traffic-allowed": ("network", "traffic-allowed", 8, {}, 256, 16, {}),
    "flood": ("benchmarks", "pingpong-flood", 8,
              {"duration_ticks": "24", "latency_ms": "3"}, 128, 8, {}),
    "storm": ("benchmarks", "storm", 16,
              {"conn_outgoing": "3", "conn_delay_ticks": "8", "data_size_kb": "16"},
              512, 8, {}),
    "barrier": ("benchmarks", "barrier", 8, {"barrier_iterations": "2"}, 512, 8, {}),
    "subtree": ("benchmarks", "subtree", 8, {"subtree_iterations": "4"}, 512, 8, {}),
    "placebo": ("placebo", "ok", 4, {}, 64, 8, {}),
    "verify": ("verify", "uses-data-network", 8, {}, 512, 16, {}),
    "splitbrain": ("splitbrain", "reject", 12, {}, 2048, 64, {}),
    "dup-ring": (None, "ring/duplicate", 8, {}, 128, 8, {}),
    "ruled-ring": (None, "ruled-ring/filter-rules", 8, {}, 64, 8, {}),
    "collisions": (None, "direct-validate-collisions", 8, {}, 128, 8, {"validate": True}),
}
SEEDS = (3, 7, 11)
# the barrier plan reads its counts on the host (int(n * p)): a padded run
# refuses it (engine.HOST_READ_ERROR); the inline collision twin sizes its
# state with the live count. Both pack with equal counts only
UNBUCKETABLE = {"barrier", "collisions"}
MODES = [(label, b) for label in PACKABLE for b in (False, True)
         if not (b and label in UNBUCKETABLE)]


def _sizes(label, bucketed):
    n = PACKABLE[label][2]
    return (n, n, n) if not bucketed else (n, n - 1, n - 3)


def _program(pkg, label, n, live=None, telemetry=True, transport="xla"):
    plan, case, _, params, _, chunk, kw = PACKABLE[label]
    if pkg == "jax":
        groups = jbuild([JRunGroup(id="all", instances=n, parameters=dict(params))])
        tc = INLINE[case][0]()() if plan is None else jinst(
            jload(_ref_plan(plan))[case], groups, 1.0)
        return JSimProgram(tc, groups, test_plan=plan or "inline", test_case=case,
                           tick_ms=1.0, chunk=chunk, telemetry=telemetry,
                           transport=transport, **kw)
    groups = build_groups([RunGroup(id="all", instances=n, parameters=dict(params))])
    tc = INLINE[case][1]()() if plan is None else instantiate_testcase(
        load_sim_testcases(plan_dir(plan))[case], groups, 1.0)
    return SimProgram(tc, groups, test_plan=plan or "inline", test_case=case, tick_ms=1.0,
                      chunk=chunk, telemetry=telemetry, device="cpu", live_counts=live,
                      **kw)


def _record(prog, seed, max_ticks):
    blocks = []
    res = prog.run(seed=seed, max_ticks=max_ticks,
                   telemetry_cb=lambda b: blocks.append(np.asarray(b).copy()))
    return res, blocks


_CACHE: dict = {}


def _packed(label, bucketed):
    """The pack of one workload (three members, width 4: one dead dummy),
    run once per module: ``(results, telemetry blocks per member)``."""
    key = ("pack", label, bucketed)
    if key not in _CACHE:
        sizes, max_ticks = _sizes(label, bucketed), PACKABLE[label][4]
        if bucketed:
            plans = [pb.plan_buckets([n], "auto", LADDER) for n in sizes]
            prog = _program("torch", label, plans[0].padded_n, live=plans[0].live_counts)
            lcs = [p.live_counts for p in plans]
        else:
            prog = _program("torch", label, sizes[0])
            lcs = [None] * len(sizes)
        tele = [[] for _ in sizes]
        members = [
            PackMember(seed=s, live_counts=lc, max_ticks=max_ticks,
                       telemetry_cb=lambda b, i=i: tele[i].append(np.asarray(b).copy()))
            for i, (s, lc) in enumerate(zip(SEEDS, lcs))
        ]
        runner = PackRunner(prog, pack_width(len(members), 8))
        assert runner.width == 4
        _CACHE[key] = (runner.run(members), tele)
    return _CACHE[key]


def _isolated(label, bucketed, i):
    """The port's isolated run of member ``i`` (padded when bucketed)."""
    key = ("iso", label, bucketed, i)
    if key not in _CACHE:
        n, max_ticks = _sizes(label, bucketed)[i], PACKABLE[label][4]
        if bucketed:
            bp = pb.plan_buckets([n], "auto", LADDER)
            prog = _program("torch", label, bp.padded_n, live=bp.live_counts)
        else:
            prog = _program("torch", label, n)
        _CACHE[key] = _record(prog, SEEDS[i], max_ticks)
    return _CACHE[key]


def _assert_member_equal(want, got, label, same_layout=True):
    (res_w, tele_w), (res_g, tele_g) = want, got
    if not same_layout:
        res_g = dict(res_g, carry_bytes=res_w["carry_bytes"])
    assert_results_equal(res_w, res_g, label)
    assert res_g["collision_where"] == list(res_w["collision_where"]), label
    assert res_g["lat_hist"] == [list(map(int, r)) for r in res_w["lat_hist"]], label
    assert len(tele_g) == len(tele_w), label
    for c, (a, b) in enumerate(zip(tele_w, tele_g)):
        assert b.dtype == a.dtype, (label, c)
        np.testing.assert_array_equal(b, a, err_msg=f"{label} telemetry chunk {c}")


# ------------------------------------------------------------------ units


@pytest.mark.parametrize("members,pack_max", [(1, 8), (2, 8), (3, 8), (5, 8), (8, 8),
                                              (9, 8), (3, 2), (6, 4)])
def test_pack_width_matches_jax(members, pack_max):
    assert pack_width(members, pack_max) == jpack.pack_width(members, pack_max)
    assert ppack.PACK_MIN_MEMBERS == jpack.PACK_MIN_MEMBERS


def test_split_salts_match_the_hosts_split():
    """The vectorised link-key advance is ``prng.split_host`` per run."""
    from testground_tpu_torch.sim import prng
    from testground_tpu_torch.sim.net import _hash_salt

    keys = [tuple(int(x) for x in prng.split(prng.key(s))[0]) for s in (0, 3, 9)]
    salts, k0, k1 = ppack._split_salts(np.asarray([k[0] for k in keys], np.uint64),
                                       np.asarray([k[1] for k in keys], np.uint64), 5)
    for r, k in enumerate(keys):
        for i in range(5):
            k, msg = prng.split_host(k)
            assert salts[i, r] == _hash_salt(msg)
        assert (int(k0[r]), int(k1[r])) == k


# ------------------------------------------------------- the acceptance pin


@pytest.mark.parametrize("label,bucketed", MODES,
                         ids=[f"{lb}-{'bucketed' if b else 'exact'}" for lb, b in MODES])
def test_packed_member_equals_the_ports_isolated_run(label, bucketed):
    packed, tele = _packed(label, bucketed)
    for i in range(len(SEEDS)):
        iso = _isolated(label, bucketed, i)
        _assert_member_equal(iso, (packed[i], tele[i]), f"{label}[{i}] vs port")
        assert packed[i]["groups"] == iso[0]["groups"]


REF_MODES = [(label, b) for label, b in MODES
             if label in ("ping-pong", "sustained", "flood", "storm", "subtree",
                          "traffic-shaped", "dup-ring", "collisions")]


@pytest.mark.parametrize("transport", ["xla", "pallas"])
@pytest.mark.parametrize("label,bucketed", REF_MODES,
                         ids=[f"{lb}-{'bucketed' if b else 'exact'}" for lb, b in REF_MODES])
def test_packed_member_equals_the_references_exact_run(label, bucketed, transport):
    packed, tele = _packed(label, bucketed)
    max_ticks = PACKABLE[label][4]
    for i, n in enumerate(_sizes(label, bucketed)):
        ref = _record(_program("jax", label, n, transport=transport), SEEDS[i], max_ticks)
        _assert_member_equal(ref, (packed[i], tele[i]), f"{label}[{i}] vs jax",
                             same_layout=not bucketed)
        assert [(g.id, g.offset, g.count) for g in packed[i]["groups"]] == [
            (g.id, g.offset, g.count) for g in ref[0]["groups"]]


@pytest.mark.parametrize("label", ["barrier", "placebo", "verify", "splitbrain",
                                   "traffic-allowed", "ruled-ring"])
def test_packed_member_equals_the_references_exact_run_more_plans(label):
    """The other packable cases, bucketed (with equal counts where the plan
    reads its counts on the host), against the reference's exact-N runs
    under the xla knob."""
    bucketed = label not in UNBUCKETABLE
    packed, tele = _packed(label, bucketed)
    max_ticks = PACKABLE[label][4]
    for i, n in enumerate(_sizes(label, bucketed)):
        ref = _record(_program("jax", label, n), SEEDS[i], max_ticks)
        _assert_member_equal(ref, (packed[i], tele[i]), f"{label}[{i}] vs jax",
                             same_layout=not bucketed)


# ----------------------------------------------------------- stragglers


class _SeedClock(papi.SimTestcase):
    """The finish tick depends on the run's seed (the reference test's
    ``_SeedClock``): members of a pack finish in different chunks."""

    SHAPING = ("latency",)
    MSG_WIDTH = 1
    OUT_MSGS = 1
    IN_MSGS = 2
    MAX_LINK_TICKS = 4

    def init(self, env):
        from testground_tpu_torch.sim import prng

        until = 8 + prng.randint(env.key[:1], (), 0, 40)
        return {"until": until.reshape(1).expand(env.group_lanes).to(torch.int32)}

    def step(self, env, state, inbox, sync, t):
        nxt = torch.remainder(env.global_seq + 1, env.test_instance_count)
        return self.out(
            state,
            status=torch.where(t >= state["until"], papi.SUCCESS, papi.RUNNING),
            outbox=papi.Outbox.single(nxt, [1], t < state["until"], 1, 1),
        )


def _clock(n=6, chunk=8, telemetry=True):
    groups = build_groups([RunGroup(id="all", instances=n)])
    return SimProgram(_SeedClock(), groups, chunk=chunk, telemetry=telemetry,
                      device="cpu")


def _pack_vs_isolated(members, iso_ticks=()):
    tele = [[] for _ in members]
    for i, m in enumerate(members):
        m.telemetry_cb = lambda b, i=i: tele[i].append(np.asarray(b).copy())
    runner = PackRunner(_clock(), pack_width(len(members), 8))
    packed = runner.run(members)
    for i, m in enumerate(members):
        # a member stopped at a boundary equals the run whose budget ends there
        iso = _record(_clock(), m.seed, dict(iso_ticks).get(i, m.max_ticks))
        _assert_member_equal(iso, (packed[i], tele[i]), f"member {i}")
    return packed


def test_early_finishers_freeze_and_report_their_own_tick():
    members = [PackMember(seed=s, max_ticks=256) for s in (0, 1, 2, 5)]
    packed = _pack_vs_isolated(members)
    fins = [int(np.max(r["finished_at"])) for r in packed]
    assert len(set(fins)) > 1, fins  # they did finish apart
    assert all(m.done for m in members)
    assert [m.ticks for m in members] == [r["ticks"] for r in packed]


def test_a_members_own_budget_ends_first():
    members = [PackMember(seed=0, max_ticks=16), PackMember(seed=6, max_ticks=256)]
    packed = _pack_vs_isolated(members)
    assert members[0].ticks == 16 and not members[0].done
    assert members[1].done and packed[1]["ticks"] > 16


def test_a_canceled_member_stops_at_its_boundary():
    calls = {"n": 0}

    def cancel():
        calls["n"] += 1
        return calls["n"] >= 2  # seen at the second chunk boundary

    members = [PackMember(seed=0, max_ticks=256, cancel_check=cancel),
               PackMember(seed=6, max_ticks=256)]
    packed = _pack_vs_isolated(members, iso_ticks=[(0, 16)])
    assert members[0].canceled and members[0].ticks == 16
    assert packed[0]["ticks"] == 16


# ------------------------------------------------------------- run axis


def _step_ops(width):
    from test_torch_telemetry import _CountOps

    prog = _program("torch", "sustained", 16, telemetry=False)
    runner = PackRunner(prog, width)
    counts = []
    real = runner._step

    def counted(*a, **k):
        mode = _CountOps()
        with mode:
            out = real(*a, **k)
        counts.append(sum(mode.counts.values()))
        return out

    runner._step = counted
    runner.run([PackMember(seed=s, max_ticks=16) for s in range(width)])
    return counts


def test_the_plan_step_issues_the_same_ops_at_every_width():
    """One launch per op for the whole pack: the vmapped step's op count
    does not grow with the run axis."""
    two, eight = _step_ops(2), _step_ops(8)
    assert two == eight and len(two) == 16


def test_an_op_without_a_batching_rule_raises():
    """The vmap fallback would loop over the members: it is switched off."""

    class Fallback(_SeedClock):
        def step(self, env, state, inbox, sync, t):
            # no batching rule: a per-member loop under the fallback
            torch.ops.aten._test_functorch_fallback(inbox.src.float(), inbox.src.float())
            return super().step(env, state, inbox, sync, t)

    groups = build_groups([RunGroup(id="all", instances=4)])
    prog = SimProgram(Fallback(), groups, chunk=8, device="cpu")
    with pytest.raises(RuntimeError, match="fallback"):
        PackRunner(prog, 2).run([PackMember(seed=0, max_ticks=8),
                                 PackMember(seed=1, max_ticks=8)])


def test_refusals_that_remain():
    from testground_tpu_torch.sim.meshplan import make_mesh
    from testground_tpu_torch.sim.trace import build_trace_plan

    groups = build_groups([RunGroup(id="all", instances=4)])
    tc = _SeedClock()
    traced = SimProgram(tc, groups, device="cpu",
                        trace=build_trace_plan(groups, {"all": {"instances": "0:2"}}))
    with pytest.raises(ValueError, match="trace-free, fault-free"):
        PackRunner(traced, 2)
    with pytest.raises(ValueError, match="additional hosts"):
        PackRunner(SimProgram(tc, groups, device="cpu", telemetry=True, netmatrix=True), 2)
    with pytest.raises(ValueError, match="additional hosts"):
        PackRunner(SimProgram(tc, groups, device="cpu", hosts=("echo",)), 2)
    with pytest.raises(ValueError, match="cannot use transport=pallas"):
        PackRunner(SimProgram(tc, groups, device="cpu"), 2,
                   mesh=make_mesh("2", device="cpu"), transport="pallas")
    meshed = SimProgram(tc, groups, device="cpu", mesh=make_mesh("2", device="cpu"))
    with pytest.raises(ValueError, match="built unmeshed"):
        PackRunner(meshed, 2)
