"""Shape buckets on the port (``testground_tpu_torch/sim/buckets.py`` and
the engine's padded layout) against the JAX package, on the CPU:

- the units across the packages: ladder and mode parsing, ``resolve_rung``,
  ``bucketed_counts``, the ``BucketPlan`` maps, ``remap_lane_masks`` and
  ``resolve_buckets``' gates with their warnings, the same on both sides;
- the acceptance pin: every workload of the feature matrix (sorted
  transport, filters and regions, direct slots, control lanes over two
  groups, duplicate, the bandwidth queue, filter rules, storm), padded into
  a test ladder, equals the reference's EXACT-N run under both transport
  knobs and the port's exact run — status, finished_at, every state leaf,
  every flow total, the sync counters — and reports the exact groups. The
  reference's own bucketed runs derive their keys another way (ROADMAP
  R1), so the port is never held against them where a plan reads its keys;
- the keys: a padded program's live lanes get ``jax.random.split``'s keys;
- chaos: a remapped crash + restart + partition + loss-burst schedule over
  a padded run equals the exact run, telemetry stream and histograms
  included, and a hypothesis arm on the port alone;
- the executor: the journal's ``bucket`` block is the reference's bucketed
  run's (``compile_cache`` aside: the port has none), the perf ledger
  divides by the live N, the readers render the block as the reference's,
  and the fallbacks warn with the reference's messages;
- the checkpoint plane: a bucketed run's identity is the reference's but
  ``sources``, ``live_counts`` sits at the reference's leaf, a bucketed
  snapshot resumes across the packages both ways (the keys ride in the
  carry, so R1 does not arise), and another bucket's snapshot refuses;
- the mesh padding: an indivisible lane count under ``xla`` on a CPU mesh
  cut into parts equals the unmeshed run, and its snapshot has the exact
  shapes of the reference's meshed snapshot;
- the zero-overhead contract: ``bucket = "off"`` dispatches the ops of a
  run without the key, and a bucketed run reads the host no more often a
  tick than the exact run (counted with a ``TorchDispatchMode``);
- ``build --buckets`` and a bucketed ``run single`` through both CLIs.
"""

import dataclasses
import json
import os
import threading

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import __graft_entry__ as ge
from test_torch_engine import RESULT_KEYS, assert_results_equal
from test_torch_faults import _ChaosTraffic
from test_torch_plans import INLINE
from test_torch_telemetry import (
    _HOST_READS,
    WORKLOADS,
    _CountOps,
    _layout,
    programs,
    run_recording,
)
from testground_tpu.api import RunGroup as JRunGroup
from testground_tpu.sim import buckets as jb
from testground_tpu.sim import executor as jexec
from testground_tpu_torch.api import OutputsEnv, RunGroup, RunInput
from testground_tpu_torch.rpc import discard_writer
from testground_tpu_torch.sim import api as papi
from testground_tpu_torch.sim import buckets as pb
from testground_tpu_torch.sim import checkpoint as pck
from testground_tpu_torch.sim import executor as pexec
from testground_tpu_torch.sim.engine import SimProgram, build_groups
from testground_tpu_torch.sim.executor import (
    instantiate_testcase,
    load_sim_testcases,
    plan_dir,
)
from testground_tpu_torch.sim.faults import build_fault_schedule, remap_schedule

REF_PLANS = os.path.join(os.path.dirname(ge.__file__), "plans")
# the test ladder: every workload (n <= 16) pads into a rung with dead lanes
LADDER = (32, 64)
BOTH = {"jax": jb, "torch": pb}


# ------------------------------------------------------------------ units


@pytest.mark.parametrize("pkg", list(BOTH))
def test_parse_ladder_and_mode(pkg):
    b = BOTH[pkg]
    assert b.parse_ladder(None) == b.DEFAULT_LADDER == jb.DEFAULT_LADDER
    assert b.parse_ladder("") == b.DEFAULT_LADDER
    assert b.parse_ladder("64,32,64") == (32, 64)
    assert b.parse_ladder([128, 32]) == (32, 128)
    assert b.parse_ladder(32) == (32,)
    for bad, msg in (("a,b", "bucket_ladder"), ("0,32", "positive")):
        with pytest.raises(ValueError, match=msg):
            b.parse_ladder(bad)
    assert b.parse_bucket_mode(None) == "off"
    assert b.parse_bucket_mode("off") == "off"
    assert b.parse_bucket_mode(False) == "off"
    assert b.parse_bucket_mode("auto") == "auto"
    assert b.parse_bucket_mode(True) == "auto"
    assert b.parse_bucket_mode("4096") == 4096
    for bad, msg in (("huge", "unknown bucket mode"), ("-4", "positive")):
        with pytest.raises(ValueError, match=msg) as e:
            b.parse_bucket_mode(bad)
        with pytest.raises(ValueError) as je:
            jb.parse_bucket_mode(bad)
        assert str(e.value) == str(je.value)


@pytest.mark.parametrize("pkg", list(BOTH))
def test_resolve_rung_counts_and_plan_maps(pkg):
    b = BOTH[pkg]
    assert b.resolve_rung(1, (32, 64)) == 32
    assert b.resolve_rung(33, (32, 64)) == 64
    assert b.resolve_rung(65, (32, 64)) is None
    assert b.bucketed_counts([5, 40], "auto", (32, 64)) == (32, 64)
    assert b.bucketed_counts([5], "off", (32,)) is None
    assert b.bucketed_counts([5, 100], "auto", (32, 64)) is None
    assert b.bucketed_counts([5, 7], 16, (32,)) == (16, 16)
    assert b.bucketed_counts([20], 16, (32,)) is None
    bp = b.plan_buckets([3, 2], "auto", (4, 8))
    assert bp.live_n == 5 and bp.padded_n == 8
    assert bp.virt_offsets == (0, 3) and bp.phys_offsets == (0, 4)
    assert bp.index_map().tolist() == [0, 1, 2, 4, 5]
    assert bp.summary() == jb.plan_buckets([3, 2], "auto", (4, 8)).summary()
    assert b.plan_buckets([3], "off") is None


@pytest.mark.parametrize("pkg", list(BOTH))
def test_remap_lane_masks(pkg):
    b = BOTH[pkg]
    bp = b.plan_buckets([3, 2], "auto", (4, 8))
    masks = b.remap_lane_masks(
        np.asarray([[True, False, True, False, True], [False] * 5]), bp.index_map(), 8)
    assert masks.tolist() == [[True, False, True, False, False, True, False, False],
                              [False] * 8]
    assert b.remap_lane_masks(np.zeros((0, 5), bool), bp.index_map(), 8).shape == (0, 8)


def _gate(pkg, bucket, ladder="", coordinator="", counts=(5,), shards=0):
    """``resolve_buckets`` of one package: (padded counts or None, warnings)."""
    cfg = dataclasses.make_dataclass(
        "Cfg", [("bucket", str), ("bucket_ladder", str), ("coordinator_address", str)]
    )(bucket, ladder, coordinator)
    warned = []
    if pkg == "jax":
        fn = jexec.resolve_buckets
        mesh = (jax.sharding.Mesh(np.asarray(jax.devices()[:shards]), ("i",))
                if shards else None)
    else:
        fn = pexec.resolve_buckets
        mesh = pexec._make_mesh(False, str(shards), torch.device("cpu")) if shards else None
    plan = fn(cfg, list(counts), mesh=mesh, warn=lambda fmt, *a: warned.append(fmt % a))
    return (None if plan is None else plan.padded_counts), warned


GATES = {
    "off": dict(bucket="off"),
    "auto": dict(bucket="auto", ladder="32,64"),
    "explicit": dict(bucket="16", counts=(5, 7)),
    "cohort": dict(bucket="auto", ladder="32", coordinator="host:1234"),
    "mesh-divisible": dict(bucket="auto", ladder="32", shards=2),
    "mesh-indivisible": dict(bucket="auto", ladder="33", shards=2),
    "over-coverage": dict(bucket="auto", ladder="32", counts=(100,)),
    "explicit-over": dict(bucket="16", counts=(20,)),
}


@pytest.mark.parametrize("name", list(GATES))
def test_resolve_buckets_gates_match_jax(name):
    """The same plan or None, and the same warning text, in both packages."""
    ref, port = _gate("jax", **GATES[name]), _gate("torch", **GATES[name])
    assert port == ref
    if name in ("cohort", "mesh-indivisible", "over-coverage", "explicit-over"):
        assert port[0] is None and len(port[1]) == 1


# ------------------------------------------------- padded equivalence

# the feature matrix: (label, workload of test_torch_telemetry.WORKLOADS or
# a tuple of its form)
FEATURES = {
    "ping-pong/sorted": "ping-pong",
    "splitbrain/filters+regions": ("splitbrain", "reject", 15, {}, 2048, 64, {}, {}),
    "flood/direct": "flood",
    "additional-hosts/control-lanes": "additional-hosts",
    "ring/duplicate": "dup-ring",
    "traffic-shaped/bandwidth-queue": "traffic-shaped",
    "ruled-ring/filter-rules": (None, "ruled-ring/filter-rules", 8, {}, 64, 8, {}, {}),
    "storm/random-graph": "storm",
}


def _spec(workload):
    return WORKLOADS[workload] if isinstance(workload, str) else workload


def bucketed_program(workload, ladder=LADDER, faults=None, telemetry=False,
                     netmatrix=False, **kw):
    """The port's program of a workload padded to ``ladder`` (faults, given
    as tables, lowered in the exact layout and remapped)."""
    plan, case, n, params, _, chunk, opts, _ = _spec(workload)
    layout = _layout(n)
    bp = pb.plan_buckets([c for _, c in layout], "auto", ladder)
    groups = build_groups([RunGroup(id=i, instances=p, parameters=dict(params))
                           for (i, _), p in zip(layout, bp.padded_counts)])
    tc = (INLINE[case][1]()() if plan is None else
          instantiate_testcase(load_sim_testcases(plan_dir(plan))[case], groups, 1.0))
    sched = None
    if faults:
        exact = build_groups([RunGroup(id=i, instances=c, parameters=dict(params))
                              for i, c in layout])
        sched = remap_schedule(build_fault_schedule(exact, faults, 1.0), bp.index_map(),
                               bp.padded_n)
    return SimProgram(tc, groups, test_plan=plan or "inline", test_case=case, tick_ms=1.0,
                      chunk=chunk, hosts=opts.get("hosts", ()), telemetry=telemetry,
                      netmatrix=netmatrix, faults=sched, device="cpu",
                      live_counts=bp.live_counts, **kw)


def assert_padded_equal(exact, padded, label):
    """Every result of the exact run, the footprint aside (the padded
    carry's is the padded layout's, as in the reference)."""
    assert_results_equal(exact, dict(padded, carry_bytes=exact["carry_bytes"]), label)
    assert [(g.id, g.offset, g.count) for g in padded["groups"]] == [
        (g.id, g.offset, g.count) for g in exact["groups"]], label


_PORT_RUNS: dict = {}


def _port_runs(label):
    """The port's exact and padded runs of a feature workload, once."""
    if label not in _PORT_RUNS:
        workload = FEATURES[label]
        max_ticks = _spec(workload)[4]
        exact = programs(workload)[1].run(seed=3, max_ticks=max_ticks)
        padded = bucketed_program(workload).run(seed=3, max_ticks=max_ticks)
        _PORT_RUNS[label] = (exact, padded)
    return _PORT_RUNS[label]


@pytest.mark.parametrize("transport", ["xla", "pallas"])
@pytest.mark.parametrize("label", list(FEATURES))
def test_padded_run_equals_the_references_exact_run(label, transport):
    workload = FEATURES[label]
    jprog = programs(workload, transport=transport)[0]
    ref = jprog.run(seed=3, max_ticks=_spec(workload)[4])
    exact, padded = _port_runs(label)
    n = sum(c for _, c in _layout(_spec(workload)[2]))
    assert int((np.asarray(ref["status"]) == papi.SUCCESS).sum()) == n, label
    assert ref["msgs_delivered"] > 0 or label.startswith("ruled"), label
    assert padded["status"].shape == (n,)
    assert_padded_equal(ref, padded, f"{label} vs the reference ({transport})")
    assert_padded_equal(exact, padded, f"{label} vs the port's exact run")


# ---------------------------------------------------------------- keys


@pytest.mark.parametrize("n", [1, 2, 5, 8, 14, 31])
def test_live_lane_keys_match_jax_random_split(n):
    """The reference's own derivation fails this (ROADMAP R1); the port's
    split hashes the counter pair (0, i) alone, so live lane v takes
    counter v and the keys are ``jax.random.split``'s by construction."""
    bp = pb.plan_buckets([n], "auto", LADDER)
    groups = build_groups([RunGroup(id="all", instances=bp.padded_counts[0])])
    prog = SimProgram(papi.SimTestcase(), groups, device="cpu", live_counts=(n,))
    carry = prog.init_carry(42)
    _, inst_root = jax.random.split(jax.random.key(42))
    want = np.asarray(jax.random.key_data(jax.random.split(inst_root, n)))
    got = carry.keys.numpy().astype(np.uint32)
    assert np.array_equal(got[:n], want)
    # the dead lanes draw counters past the live ones: no key repeats
    assert len({tuple(k) for k in got}) == got.shape[0]


# --------------------------------------------------------------- chaos

CHAOS_EVENTS = [
    {"kind": "crash", "instances": "2:4", "start_ms": 4.0},
    {"kind": "restart", "instances": "2:3", "start_ms": 9.0},
    {"kind": "partition", "instances": "0:2", "to_instances": "4:6", "start_ms": 3.0,
     "duration_ms": 6.0, "bidirectional": True},
    {"kind": "loss_burst", "instances": "0:6", "start_ms": 6.0, "duration_ms": 8.0,
     "loss": 50.0},
]


def _chaos_run(n, bucket, events, max_ticks=256, seed=7):
    exact = build_groups([RunGroup(id="all", instances=n)])
    faults = build_fault_schedule(exact, {"all": events}, 1.0)
    groups, live = exact, None
    if bucket:
        bp = pb.plan_buckets([n], "auto", LADDER)
        groups = build_groups([RunGroup(id="all", instances=bp.padded_counts[0])])
        faults = remap_schedule(faults, bp.index_map(), bp.padded_n)
        live = bp.live_counts
    prog = SimProgram(_ChaosTraffic(), groups, chunk=16, telemetry=True, faults=faults,
                      device="cpu", live_counts=live)
    blocks, lat = [], []
    res = prog.run(seed=seed, max_ticks=max_ticks, telemetry_cb=blocks.append,
                   lat_hist_cb=lat.append)
    return res, np.concatenate(blocks), np.stack(lat)


def _jax_chaos_run(n, events, max_ticks=256, seed=7):
    from test_transport_pallas import _ChaosBarrierTraffic
    from testground_tpu.sim.engine import SimProgram as JSimProgram
    from testground_tpu.sim.engine import build_groups as jbuild
    from testground_tpu.sim.faults import build_fault_schedule as jfaults

    groups = jbuild([JRunGroup(id="all", instances=n)])
    prog = JSimProgram(_ChaosBarrierTraffic(), groups, chunk=16, telemetry=True,
                       faults=jfaults(groups, {"all": events}, 1.0))
    blocks = []
    res = prog.run(seed=seed, max_ticks=max_ticks,
                   telemetry_cb=lambda b: blocks.append(np.asarray(b)))
    return res, np.concatenate(blocks)


def test_remapped_chaos_schedule_equals_the_exact_run():
    """Results, the telemetry stream and the latency histograms: the port's
    padded run, its exact run and the reference's exact run."""
    exact, stream_x, lat_x = _chaos_run(6, False, CHAOS_EVENTS)
    padded, stream_p, lat_p = _chaos_run(6, True, CHAOS_EVENTS)
    ref, stream_r = _jax_chaos_run(6, CHAOS_EVENTS)
    assert exact["faults_crashed"] > 0 and exact["msgs_delivered"] > 0
    assert exact["fault_dropped"] > 0
    assert_padded_equal(exact, padded, "chaos padded")
    assert np.array_equal(stream_x, stream_p)
    assert np.array_equal(lat_x, lat_p) and exact["lat_hist"] == padded["lat_hist"]
    for key in RESULT_KEYS:
        if key != "carry_bytes":
            assert np.array_equal(np.asarray(ref[key]), np.asarray(padded[key])), key
    assert np.array_equal(stream_r, stream_p)
    assert ref["lat_hist"] == padded["lat_hist"]


_KINDS = st.sampled_from(["crash", "restart", "partition", "link_flap", "loss_burst"])


@st.composite
def _schedules(draw):
    n = draw(st.integers(min_value=4, max_value=10))
    events = []
    for _ in range(draw(st.integers(min_value=1, max_value=3))):
        kind = draw(_KINDS)
        lo = draw(st.integers(min_value=0, max_value=n - 2))
        hi = draw(st.integers(min_value=lo + 1, max_value=n - 1))
        ev = {"kind": kind, "instances": f"{lo}:{hi}",
              "start_ms": float(draw(st.integers(min_value=1, max_value=24)))}
        if kind == "partition":
            ev["to_instances"] = f"{hi}:{n}"
            ev["duration_ms"] = float(draw(st.integers(min_value=1, max_value=16)))
        elif kind in ("link_flap", "loss_burst"):
            ev["duration_ms"] = float(draw(st.integers(min_value=1, max_value=16)))
            if kind == "loss_burst":
                ev["loss"] = float(draw(st.integers(min_value=10, max_value=90)))
        events.append(ev)
    return n, events


@settings(max_examples=8, deadline=None)
@given(_schedules())
def test_padding_mixed_with_chaos_stays_equal(case):
    """The reference's fuzz arm on the port alone: any small schedule over
    any small n, padded, equals the exact run."""
    n, events = case
    try:
        exact, stream_x, lat_x = _chaos_run(n, False, events, max_ticks=128)
    except ValueError:
        return  # a schedule the lowering refuses: the exact path's contract
    padded, stream_p, lat_p = _chaos_run(n, True, events, max_ticks=128)
    assert_padded_equal(exact, padded, f"n={n} {events}")
    assert np.array_equal(stream_x, stream_p) and np.array_equal(lat_x, lat_p)


# --------------------------------------------------------------- executor


def _jobs(tmp_path, n=10, plan="network", case="ping-pong", groups=None, trace=None,
          **cfg):
    """The reference's and the port's RunInput of one run; ``groups`` a
    list of (id, n)."""
    from testground_tpu.api import RunInput as JRunInput
    from testground_tpu.config import EnvConfig

    layout = groups or [("all", n)]
    common = dict(run_id="run-b", test_plan=plan, test_case=case,
                  total_instances=sum(c for _, c in layout))
    cfg = {"chunk": 16, **cfg}
    jjob = JRunInput(
        groups=[JRunGroup(id=i, instances=c, artifact_path=f"{REF_PLANS}/{plan}",
                          trace=dict(trace or {})) for i, c in layout],
        env=EnvConfig.load(home=str(tmp_path / "jax")),
        runner_config=jexec.SimJaxConfig(shard=False, **cfg), **common)
    pjob = RunInput(groups=[RunGroup(id=i, instances=c, artifact_path=plan_dir(plan),
                                     trace=dict(trace or {})) for i, c in layout],
                    env=OutputsEnv(tmp_path / "torch"),
                    runner_config=pexec.SimTorchConfig(device="cpu", **cfg), **common)
    return jjob, pjob


def _execute_both(tmp_path, **kw):
    """Both packages' executors on one run: (reference journal, port
    journal, the port's warnings)."""
    from testground_tpu.rpc import discard_writer as jdiscard

    jjob, pjob = _jobs(tmp_path, **kw)
    jout = jexec.execute_sim_run(jjob, jdiscard(), threading.Event())
    lines = []
    pw = discard_writer()
    pw.warn = lambda fmt, *a: lines.append(fmt % a if a else fmt)
    pout = pexec.execute_sim_run(pjob, pw, threading.Event())
    return jout.result.journal, pout.result.journal, lines


def test_bucket_block_and_perf_ledger_match_the_reference(tmp_path):
    """The ``sim.bucket`` block equals the reference's bucketed run's on
    every key but ``compile_cache`` (``"off"``: no compile cache), the
    events are exact-N, and the perf ledger divides by the live N with the
    padded size beside it."""
    jj, pj, _ = _execute_both(tmp_path, n=10, bucket="auto", bucket_ladder="32,64",
                              telemetry=True)
    jb_, pb_ = jj["sim"]["bucket"], pj["sim"]["bucket"]
    assert pb_["compile_cache"] == "off"
    assert {k: v for k, v in pb_.items() if k != "compile_cache"} == {
        k: v for k, v in jb_.items() if k != "compile_cache"}
    assert pb_["padded_instances"] == 32 and pb_["dead_lanes"] == 22
    assert pj["events"] == jj["events"] == {"all": {
        "incomplete": 0, "success": 10, "failure": 0, "crash": 0}}
    perf = pj["sim"]["perf"]
    assert perf["instances"] == 10 and perf["bucket"] == 32 == jj["sim"]["perf"]["bucket"]
    ex = perf["execute"]
    assert ex["peer_ticks_per_sec"] == pytest.approx(
        10 * ex["ticks"] / ex["wall_secs"], rel=1e-3)
    assert pj["telemetry"]["totals"] == jj["telemetry"]["totals"]


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_perf_ledger_normalizes_by_live_n(pkg):
    if pkg == "jax":
        from testground_tpu.sim.perf import PerfLedger
    else:
        from testground_tpu_torch.sim.perf import PerfLedger
    led = PerfLedger(7, 16, bucket=32)
    led.on_chunk(0, 16, 16, 0.5)
    led.on_chunk(1, 32, 16, 0.5)
    s = led.summary()
    assert s["instances"] == 7 and s["bucket"] == 32
    assert s["execute"]["peer_ticks_per_sec"] == pytest.approx(7 * 32 / 1.0)
    plain = PerfLedger(7, 16)
    plain.on_chunk(0, 16, 16, 0.5)
    assert "bucket" not in plain.summary()


def test_readers_render_a_port_bucket_as_the_reference(tmp_path):
    """The ``pretty`` bucket line and the Prometheus families of a port
    bucketed journal: what the reference renders of the same journal."""
    from testground_tpu.engine.task import DatedState as JDated
    from testground_tpu.engine.task import State as JState
    from testground_tpu.engine.task import Task as JTask
    from testground_tpu.engine.task import TaskType as JType
    from testground_tpu.metrics.prometheus import render_prometheus as jprom
    from testground_tpu.runners.pretty import render_perf_summary as jpretty
    from testground_tpu_torch.engine.task import DatedState, State, Task, TaskType
    from testground_tpu_torch.metrics.prometheus import render_prometheus as pprom
    from testground_tpu_torch.runners.pretty import render_perf_summary as ppretty

    _, pj, _ = _execute_both(tmp_path, n=10, bucket="auto", bucket_ladder="32,64")
    doc = {"plan": "network", "case": "ping-pong", "perf": pj["sim"]["perf"],
           "sim": pj["sim"]}
    out = ppretty(doc)
    assert out == jpretty(doc)
    assert "10 live instance(s) padded to 32" in out and "compile cache off" in out
    tasks = []
    for T, D, S, K in ((JTask, JDated, JState, JType), (Task, DatedState, State, TaskType)):
        tasks.append(T(id="t1", type=K.RUN, plan="network", case="ping-pong",
                       runner="sim:torch", states=[D(state=S.COMPLETE, created=1.0)],
                       result={"outcome": "success", "journal": pj}))
    jtext, ptext = jprom([tasks[0]]), pprom([tasks[1]])
    fams = ("tg_bucket_padded_instances", "tg_compile_bucket_hit", "tg_compile_bucket_miss")
    for fam in fams:
        jl = [ln for ln in jtext.splitlines() if ln.startswith(fam + "{")]
        pl = [ln for ln in ptext.splitlines() if ln.startswith(fam + "{")]
        assert pl == jl and pl, fam
    assert [ln for ln in ptext.splitlines()
            if ln.startswith("tg_bucket_padded_instances{")][0].endswith(" 32")


def test_run_diff_of_a_bucketed_run_against_its_exact_run(tmp_path):
    """``analysis.diff`` over the port's exact and bucketed journals of one
    composition: every exact-plane counter matches but the footprint (the
    padded carry's), and the reference's ``build_run_diff`` gives the same
    document on the same snapshots."""
    from testground_tpu.analysis.diff import build_run_diff as jdiff
    from testground_tpu.analysis.diff import task_snapshot as jsnap
    from testground_tpu_torch.analysis.diff import build_run_diff, task_snapshot

    snaps = []
    for i, cfg in enumerate(({}, {"bucket": "auto", "bucket_ladder": "32,64"})):
        _, pjob = _jobs(tmp_path / str(i), n=10, telemetry=True, **cfg)
        out = pexec.execute_sim_run(pjob, discard_writer(), threading.Event())
        snaps.append({"id": f"t{i}", "plan": "network", "case": "ping-pong",
                      "outcome": "success", "result": {"journal": out.result.journal}})
    doc = build_run_diff(task_snapshot(snaps[0]), task_snapshot(snaps[1]))
    assert [r["name"] for r in doc["counters"]["rows"] if not r["equal"]] == [
        "sim.carry_bytes"]
    assert doc["counters"]["compared"] > 1
    assert doc == jdiff(jsnap(snaps[0]), jsnap(snaps[1]))


FALLBACKS = {
    # filter rules over two groups: the reference's message, exact shapes
    "filter-rules": dict(plan="network", case="traffic-ruled", groups=[("a", 4), ("b", 4)],
                         bucket="auto", bucket_ladder="32"),
    # a trace plan: the recorder is off under bucketing
    "trace": dict(n=6, trace={"instances": "0:2"}, bucket="auto", bucket_ladder="32"),
}


@pytest.mark.parametrize("name", list(FALLBACKS))
def test_fallbacks_warn_with_the_references_message(name, tmp_path):
    from testground_tpu.rpc import discard_writer as jdiscard

    jjob, pjob = _jobs(tmp_path, **FALLBACKS[name])
    jw = jdiscard()
    jlines = []
    jw.warn = lambda fmt, *a: jlines.append(fmt % a if a else fmt)
    jout = jexec.execute_sim_run(jjob, jw, threading.Event())
    pw = discard_writer()
    plines = []
    pw.warn = lambda fmt, *a: plines.append(fmt % a if a else fmt)
    pout = pexec.execute_sim_run(pjob, pw, threading.Event())
    want = [ln.replace("sim:jax", "sim:torch") for ln in jlines
            if "bucket" in ln or "recorder" in ln]
    assert want and [ln for ln in plines if "bucket" in ln or "recorder" in ln] == want
    pj, jj = pout.result.journal, jout.result.journal
    assert ("bucket" in pj["sim"]) == ("bucket" in jj["sim"])
    assert "trace" not in pj and pj["events"] == jj["events"]


# ------------------------------------------------------------ checkpoint


def _identity(pkg, **kw):
    if pkg == "jax":
        from testground_tpu.api import RunInput as R
        from testground_tpu.sim.checkpoint import run_identity

        G, C, art = JRunGroup, jexec.SimJaxConfig, f"{REF_PLANS}/network"
    else:
        R, G, C, art = RunInput, RunGroup, pexec.SimTorchConfig, plan_dir("network")
        run_identity = pck.run_identity
    job = R(run_id="r", test_plan="network", test_case="ping-pong", total_instances=10,
            groups=[G(id="g0", instances=10, artifact_path=art)])
    return run_identity(job, C(chunk=16, seed=3), telemetry=True, transport="xla",
                        fault_specs={}, trace_specs={}, hosts=(), **kw)


def test_bucketed_identity_matches_the_reference_but_sources():
    jid, pid = _identity("jax", bucket=(32,)), _identity("torch", bucket=(32,))
    assert set(pid) == set(jid) and pid["bucket"] == [32]
    assert {k for k in jid if jid[k] != pid[k]} == {"sources"}
    assert "bucket" not in _identity("torch")  # keyed only when bucketed


CUT = 48
PP_PARAMS = {"latency_ms": "30", "latency2_ms": "20"}


def _jax_bucketed():
    from testground_tpu.sim.engine import SimProgram as JSimProgram
    from testground_tpu.sim.engine import build_groups as jbuild
    from testground_tpu.sim.executor import load_sim_testcases as jload

    groups = jbuild([JRunGroup(id="g0", instances=32, parameters=dict(PP_PARAMS))])
    tc = jload(f"{REF_PLANS}/network")["ping-pong"].specialize(groups, tick_ms=1.0)()
    return JSimProgram(tc, groups, chunk=16, telemetry=True, live_counts=(10,))


def _port_bucketed(live=(10,), padded=32):
    groups = build_groups([RunGroup(id="g0", instances=padded, parameters=dict(PP_PARAMS))])
    tc = instantiate_testcase(load_sim_testcases(plan_dir("network"))["ping-pong"],
                              groups, 1.0)
    return SimProgram(tc, groups, chunk=16, telemetry=True, device="cpu",
                      live_counts=live)


def _capture(prog, snap, **kw):
    got = {}

    def obs(ticks, carry):
        got["end"] = snap(carry)
        if ticks == CUT:
            got["cut"] = got["end"]

    return prog.run(seed=3, observer=obs, **kw), got


@pytest.fixture(scope="module")
def bucketed_runs():
    """The reference's and the port's uninterrupted bucketed runs of one
    composition, with their snapshots at the cut."""
    from testground_tpu.sim.checkpoint import snapshot_carry as jsnap

    jres, jgot = _capture(_jax_bucketed(), jsnap, max_ticks=512)
    pres, pgot = _capture(_port_bucketed(), lambda c: pck.snapshot_carry(c, "xla"),
                          max_ticks=512)
    return jres, jgot, pres, pgot


def _lat_at_cut(prog):
    return np.asarray(prog.run(seed=3, max_ticks=CUT)["lat_hist"], np.int64)


def test_live_counts_leaf_sits_at_the_references_index(bucketed_runs):
    _, jgot, _, pgot = bucketed_runs
    jmetas, pmetas = jgot["cut"][1], pgot["cut"][1]
    carry = _port_bucketed().init_carry(3)
    i = pck.leaf_paths(carry).index("live_counts")
    assert len(pmetas) == len(jmetas)
    assert pmetas[i] == jmetas[i] == {"kind": "array", "shape": [1], "dtype": "int32"}
    assert pgot["cut"][0][i].tolist() == jgot["cut"][0][i].tolist() == [10]
    for k, (a, b) in enumerate(zip(jmetas, pmetas)):  # the padded shapes throughout
        assert a["shape"] == b["shape"], k


def test_reference_bucketed_snapshot_resumes_on_the_port(bucketed_runs, tmp_path):
    from testground_tpu.sim.checkpoint import save_snapshot as jsave

    jres, jgot, _, _ = bucketed_runs
    leaves, metas = jgot["cut"]
    jsave(str(tmp_path), {"version": 1, "tick": CUT, "leaves": metas, "aux": {},
                          "transport": "xla"}, leaves)
    manifest, got = pck.load_latest(str(tmp_path))[:2]
    prog = _port_bucketed()
    carry = pck.restore_carry(prog, 3, manifest, got)
    res = prog.run(seed=3, max_ticks=512, resume_carry=carry, resume_ticks=CUT,
                   lat_hist_init=_lat_at_cut(_port_bucketed()))
    assert_padded_equal(jres, dict(res, carry_bytes=jres["carry_bytes"]), "ref→port")


def test_port_bucketed_snapshot_resumes_on_the_reference(bucketed_runs, tmp_path):
    from testground_tpu.sim.checkpoint import load_snapshot as jload
    from testground_tpu.sim.checkpoint import restore_carry as jrestore

    _, _, pres, pgot = bucketed_runs
    leaves, metas = pgot["cut"]
    path, _, _ = pck.save_snapshot(str(tmp_path), {"version": 1, "tick": CUT,
                                                   "leaves": metas, "aux": {},
                                                   "transport": "xla"}, leaves)
    manifest, got = jload(path)
    jprog = _jax_bucketed()
    carry = jrestore(jprog, 3, manifest, got)
    res = jprog.run(seed=3, max_ticks=512, resume_carry=carry, resume_ticks=CUT,
                    lat_hist_init=_lat_at_cut(_port_bucketed()))
    assert_padded_equal(pres, dict(res, carry_bytes=pres["carry_bytes"]), "port→ref")


def test_a_snapshot_from_another_bucket_refuses(bucketed_runs, tmp_path):
    """Restore refuses another bucket's leaves with the reference's
    message, and the executor's identity keys the bucket."""
    _, _, _, pgot = bucketed_runs
    leaves, metas = pgot["cut"]
    with pytest.raises(pck.CheckpointError, match="different composition") as e:
        pck.restore_carry(_port_bucketed(padded=64), 3, {"leaves": metas}, leaves,
                          transport="xla")
    assert "[64]" in str(e.value) or "64" in str(e.value)
    a = _identity("torch", bucket=(32,))
    b = _identity("torch", bucket=(64,))
    assert pck.identity_hash(a) != pck.identity_hash(b)
    with pytest.raises(pck.CheckpointError):
        pck.validate_manifest({"identity": a, "composition_hash": pck.identity_hash(
            a, drop=("sources",)), "build_key": pck.identity_hash(a)}, b)


# ----------------------------------------------------------- the mesh


def _split_mesh(shards):
    from testground_tpu_torch.sim import meshplan as pmp

    cpu = torch.device("cpu")
    return pmp.TorchMesh(devices=(cpu,) * shards, parts=((cpu, 0, 1), (cpu, 1, shards)))


def test_indivisible_mesh_equals_the_unmeshed_run_with_exact_snapshots():
    """14 instances and a host on a 4-shard mesh cut into two parts: one
    dead lane. The run is the unmeshed run's; its snapshot has the exact
    shapes and equals the reference's meshed snapshot (xla, 4 virtual
    devices) leaf for leaf; restored, it runs on to the same end."""
    from testground_tpu.sim.checkpoint import snapshot_carry as jsnap
    from testground_tpu.sim.meshplan import make_mesh as jmake_mesh

    from testground_tpu.sim.engine import SimProgram as JSimProgram

    workload = ("network", "pingpong-sustained", 14,
                {"duration_ticks": "40", "reshape_every": "16"}, 256, 16,
                {"hosts": ("http-echo",)}, {})
    jprog, uprog = programs(workload, telemetry=True)
    mprog = SimProgram(uprog.tc, uprog.groups, test_plan="network",
                       test_case="pingpong-sustained", chunk=16, telemetry=True,
                       hosts=("http-echo",), mesh=_split_mesh(4))
    assert mprog.mesh_pad == 1 and mprog.n_lanes == 16
    jprog = JSimProgram(jprog.tc, jprog.groups, test_plan="network",
                        test_case="pingpong-sustained", chunk=16, telemetry=True,
                        hosts=("http-echo",), mesh=jmake_mesh("4"))
    snap, cut = {}, 32

    def grab(pkg, fn):
        def obs(ticks, carry):
            if ticks == cut:
                snap[pkg] = fn(carry)
        return obs

    res_u, rec_u, _, _ = run_recording(uprog, seed=3, max_ticks=256)
    res_m = mprog.run(seed=3, max_ticks=256, observer=grab(
        "torch", lambda c: pck.snapshot_carry(c, "xla", export=mprog.lane_export())))
    jprog.run(seed=3, max_ticks=cut, observer=grab("jax", jsnap))
    assert_results_equal(res_u, res_m, "meshed with a dead lane")
    assert (res_m["status"] == papi.SUCCESS).all() and res_m["msgs_delivered"] > 0
    (pl, pm), (jl, jm) = snap["torch"], snap["jax"]
    assert pm == jm
    for i, (a, b) in enumerate(zip(jl, pl)):
        assert a.dtype == b.dtype and a.shape == b.shape, (i, jm[i])
        assert np.array_equal(a, b), (i, jm[i])
    carry = pck.restore_carry(mprog, 3, {"leaves": pm}, pl, transport="xla")
    lat = np.asarray(uprog.run(seed=3, max_ticks=cut)["lat_hist"], np.int64)
    res_r = mprog.run(seed=3, max_ticks=256, resume_carry=carry, resume_ticks=cut,
                      lat_hist_init=lat)
    assert_results_equal(res_u, res_r, "meshed resumed")


# ------------------------------------------------------- zero overhead


def _count_run(tmp_path, name, **cfg):
    job = RunInput(run_id=name, test_plan="network", test_case="pingpong-sustained",
                   total_instances=12,
                   groups=[RunGroup(id="all", instances=12,
                                    parameters={"duration_ticks": "40"})],
                   env=OutputsEnv(tmp_path),
                   runner_config=pexec.SimTorchConfig(device="cpu", chunk=16,
                                                      max_ticks=64, perf=False, **cfg))
    mode = _CountOps()
    with mode:
        out = pexec.execute_sim_run(job, discard_writer(), threading.Event())
    return mode.counts, out.result.journal


def test_bucket_off_dispatches_the_ops_of_a_run_without_the_key(tmp_path):
    without, jw = _count_run(tmp_path, "without")
    off, jo = _count_run(tmp_path, "off", bucket="off", bucket_ladder="32,64")
    assert off == without
    assert "bucket" not in jo["sim"] and jo["events"] == jw["events"]


def test_bucketed_run_reads_the_host_as_often_as_the_exact_run(tmp_path):
    """The syncs a tick: each read a host read of the same tensor; and the
    ops a bucketed tick adds over the exact one."""
    exact, je = _count_run(tmp_path, "exact")
    padded, jp = _count_run(tmp_path, "padded", bucket="auto", bucket_ladder="32")
    assert je["events"] == jp["events"] and jp["sim"]["bucket"]["dead_lanes"] == 20
    assert {k: padded.get(k, 0) for k in _HOST_READS} == {
        k: exact.get(k, 0) for k in _HOST_READS}
    ticks = je["sim"]["ticks"]
    added = (sum(padded.values()) - sum(exact.values())) / ticks
    # the two translations (a clamp and a gather, a gather) and the
    # plan-side arithmetic on 0-d counts; init and build aside
    assert 0 < added < 12, added


# ------------------------------------------------------------------ CLI


def test_build_buckets_writes_the_references_marker(tmp_path):
    from test_torch_cli import PORT_ENV, REF_ENV, _cli, _make_home, jmain, pmain

    argv = ["build", "single", "network:ping-pong", "--buckets", "--run-cfg",
            "bucket_ladder=32,64"]
    got = {}
    for pkg, main, env in (("jax", jmain, REF_ENV), ("torch", pmain, PORT_ENV)):
        home = _make_home(tmp_path, pkg, env, ("network",))
        rc, out, err = _cli(main, home, argv)
        assert rc == 0 and "(outcome: success)" in out, (pkg, err)
        found = [os.path.join(d, f) for d, _, fs in os.walk(home / "data") for f in fs
                 if f == "buckets-network-ping-pong.json"]
        assert len(found) == 1, (pkg, found)
        with open(found[0]) as f:
            got[pkg] = json.load(f)
    assert set(got["torch"]) == set(got["jax"])
    assert [sorted(b) for b in got["torch"]["buckets"]] == [
        sorted(b) for b in got["jax"]["buckets"]]
    assert {k: v for k, v in got["torch"].items() if k != "buckets"} == {
        k: v for k, v in got["jax"].items() if k != "buckets"}
    assert [b["bucket"] for b in got["torch"]["buckets"]] == [32, 64]


def test_bucketed_run_single_gives_the_references_outcome(tmp_path):
    from test_torch_cli import PORT_ENV, REF_ENV, _cli, _make_home, _task_id, jmain, pmain

    argv = ["run", "single", "network:ping-pong", "-i", "20", "--run-cfg", "bucket=auto",
            "--run-cfg", "bucket_ladder=32,64"]
    got = {}
    for pkg, main, env in (("jax", jmain, REF_ENV), ("torch", pmain, PORT_ENV)):
        home = _make_home(tmp_path, pkg, env, ("network",))
        rc, out, err = _cli(main, home, argv)
        got[pkg] = (rc, [ln for ln in out.splitlines() if "outcome" in ln][-1:])
        tid = _task_id(out)
        if pkg == "torch":
            from testground_tpu_torch.engine import TaskStorage

            tsk = TaskStorage(str(home / "tasks.db")).get(tid)
            journal = tsk.result["journal"]
            assert journal["events"] == {"single": {"incomplete": 0, "success": 20,
                                                    "failure": 0, "crash": 0}}
            assert journal["sim"]["bucket"]["padded_instances"] == 32
    assert got["torch"][0] == got["jax"][0] == 0
    assert got["torch"][1] == [ln.replace(ln.split("ID: ")[1].split()[0], x)
                               for ln, x in zip(got["jax"][1], [
                                   got["torch"][1][0].split("ID: ")[1].split()[0]])]


def test_padded_carry_estimate_matches_the_references():
    """``estimate_carry_bytes`` (the meta device) of a bucketed program is
    the reference's bucketed estimate and the footprint of the carry it
    builds: the padded shapes throughout."""
    prog = _port_bucketed()
    est = prog.estimate_carry_bytes()
    from testground_tpu_torch.sim.engine import carry_footprint

    assert est == carry_footprint(prog.init_carry(3)) == _jax_bucketed().estimate_carry_bytes()
    assert est > _port_bucketed(live=(10,), padded=10).estimate_carry_bytes()


# ------------------------------------------------- host reads of a count

BARRIER_PARAMS = {"barrier_iterations": "2"}


def _barrier(pkg, live):
    """benchmarks:barrier (``max(1, int(n * p))`` of the instance count) at
    32 lanes, padded with ``live`` live ones, or exact without."""
    if pkg == "jax":
        from testground_tpu.sim.engine import SimProgram as JSimProgram
        from testground_tpu.sim.engine import build_groups as jbuild
        from testground_tpu.sim.executor import load_sim_testcases as jload

        groups = jbuild([JRunGroup(id="g0", instances=32, parameters=BARRIER_PARAMS)])
        tc = jload(f"{REF_PLANS}/benchmarks")["barrier"].specialize(groups, tick_ms=1.0)()
        return JSimProgram(tc, groups, chunk=16, live_counts=live)
    groups = build_groups([RunGroup(id="g0", instances=32, parameters=BARRIER_PARAMS)])
    tc = instantiate_testcase(load_sim_testcases(plan_dir("benchmarks"))["barrier"],
                              groups, 1.0)
    return SimProgram(tc, groups, chunk=16, device="cpu", live_counts=live)


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_a_plan_reading_a_count_on_the_host_refuses_under_bucketing(pkg):
    """A padded run of a plan that turns the instance count into a Python
    int fails at its first step in both packages (the reference's trace
    raises ``ConcretizationTypeError``, a ``TypeError``), on every run of
    the program; the same plan at exact shapes runs."""
    from testground_tpu_torch.sim.engine import HOST_READ_ERROR

    prog = _barrier(pkg, live=(10,))
    for _ in range(2):
        with pytest.raises(TypeError) as e:
            prog.run(seed=0, max_ticks=32)
        if pkg == "torch":
            assert HOST_READ_ERROR in str(e.value) and "__int__" in str(e.value)
    res = _barrier(pkg, live=None).run(seed=0, max_ticks=32)
    assert int(res["ticks"]) > 0
