"""The port's run executor against the JAX package's, on the CPU: the same
``RunInput`` goes through ``testground_tpu.sim.executor.execute_sim_run``
(JAX on the CPU, ``shard=False``, ``transport="xla"``) and through
``testground_tpu_torch.sim.executor.execute_sim_run`` (``device="cpu"``),
each into its own outputs root, and the two run directories, journals and
outcomes must be equal:

- every jsonl file and ``trace_events.json``, row for row, and every
  per-instance ``run.out`` / ``metrics.out``, once the fields of
  :data:`VARYING_FIELDS` are dropped;
- the whole journal, with :data:`SIM_SKIPPED` left out of its ``sim``
  block;
- the outcome and the per-group outcomes.

Both run with the perf ledger on, their default: ``sim_perf.jsonl`` is
compared row for row by its identifying fields and its keys
(:data:`PERF_ROW_FIELDS`), its timings and the reference's compile-derived
gauges aside (``tests/test_torch_perf.py`` holds the ``sim.perf`` block).
The workloads: ``network:ping-pong`` with
telemetry and the traffic matrix, ``placebo`` ``ok`` and ``abort``, the
chaos smoke composition (``plans/chaos/_compositions/smoke.toml``, built
here by hand) with its warn SLO and again with ``severity = "fail"``, a
plan with ``collect_metrics`` sampled into ``timeseries.jsonl``,
``disable_metrics`` over ``telemetry``, a cancel set before the run, and
``additional_hosts`` with an echo host under the traffic matrix.
Then the refusals: each unported setting names its ROADMAP item, and no
device without a GPU raises. Last, ``SimProgram.run``'s loop hooks that the
executor uses (the callbacks' order, the cancel, the stall watchdog, the
NaN guard and the refused options), and the footprint the build journals,
``SimProgram.estimate_carry_bytes``."""

import json
import os
import socket
import threading

import pytest
import torch

import __graft_entry__ as ge
from testground_tpu.api import RunGroup as JRunGroup
from testground_tpu.api import RunInput as JRunInput
from testground_tpu.config import EnvConfig
from testground_tpu.rpc import discard_writer as jdiscard
from testground_tpu.sim import executor as jexec
from testground_tpu.sim.slo import SloBreachError as JSloBreachError
from testground_tpu_torch.api import OutputsEnv, RunGroup, RunInput
from testground_tpu_torch.rpc import discard_writer
from testground_tpu_torch.sim import api as papi
from testground_tpu_torch.sim import executor as pexec
from testground_tpu_torch.sim.cohort import shutdown_leader_child
from testground_tpu_torch.sim.engine import SimProgram, build_groups
from testground_tpu_torch.sim.slo import SloBreachError
from test_torch_engine import CASES as ENGINE_CASES
from test_torch_engine import jax_program, port_program

REF_PLANS = os.path.join(os.path.dirname(ge.__file__), "plans")

# Fields that differ between any two runs, the reference's with itself
# too: wall-clock stamps and durations (span and row ``ts``, ``wall_ns``,
# ``wall_secs``, ``compile_secs``) and the spans' random W3C ids. Dropped
# wherever they appear, and nothing else is.
VARYING_FIELDS = frozenset(
    {"ts", "wall_ns", "wall_secs", "compile_secs", "trace_id", "span_id", "parent_id"}
)

# keys of the journal's ``sim`` block that describe the machine and not
# the run: wall times, the process count, the transport record (what ran
# where) and the perf ledger's timings (tests/test_torch_perf.py compares
# its keys and counts)
SIM_SKIPPED = frozenset({"wall_secs", "compile_secs", "transport", "processes", "perf"})

# the perf ledger's row fields that are the run's and not the machine's;
# the rest are timings, the transport that ran and, in the reference only,
# the gauges of its compile pass (COMPILE_DERIVED), which the port has not
PERF_ROW_FIELDS = ("run", "plan", "case", "tick", "chunk")
COMPILE_DERIVED = frozenset({"compile", "flops_per_sec", "bytes_per_sec",
                             "est_flops_per_sec", "est_bytes_per_sec"})

CHAOS_PARAMS = {"slow_count": "2", "slow_tick": "30", "heal_tick": "44",
                "deadline": "120"}
CHAOS_FAULTS = [
    {"kind": "crash", "instances": "0:2", "start_ms": 6.0},
    {"kind": "link_flap", "instances": "2:4", "start_ms": 8.0,
     "duration_ms": 8.0, "period_ms": 4.0, "duty": 0.5},
    {"kind": "restart", "instances": "0:2", "start_ms": 20.0},
    {"kind": "partition", "instances": "0:4", "to_instances": "4:8",
     "start_ms": 24.0, "duration_ms": 16.0},
]
CHAOS_SLO = {"name": "fleet-mostly-alive", "metric": "crashed_fraction", "op": "<",
             "threshold": 0.2, "severity": "warn"}
CHAOS_CFG = {"telemetry": True, "chunk": 16, "max_ticks": 512}

# name: (plan, case, instances, group params, group faults, runner config,
#        run-global fields, cancel set before the run)
WORKLOADS = {
    "ping-pong-planes": ("network", "ping-pong", 8, {}, [],
                         {"telemetry": True, "netmatrix": True, "chunk": 16}, {}, False),
    "placebo-ok": ("placebo", "ok", 4, {}, [], {"chunk": 8}, {}, False),
    "placebo-abort": ("placebo", "abort", 4, {}, [], {"chunk": 8}, {}, False),
    "chaos-smoke": ("chaos", "chaos-barrier", 8, CHAOS_PARAMS, CHAOS_FAULTS,
                    {**CHAOS_CFG, "netmatrix": True},
                    {"trace": {"instances": "0:3"}, "slo": [CHAOS_SLO]}, False),
    "chaos-fail": ("chaos", "chaos-barrier", 8, CHAOS_PARAMS, CHAOS_FAULTS, CHAOS_CFG,
                   {"trace": {"instances": "0:3"},
                    "slo": [{**CHAOS_SLO, "severity": "fail"}]}, False),
    "timeseries": ("placebo", "metrics", 4, {}, [],
                   {"chunk": 4, "timeseries_every": 4}, {}, False),
    "no-metrics": ("placebo", "metrics", 4, {}, [],
                   {"chunk": 4, "telemetry": True, "timeseries_every": 4},
                   {"disable_metrics": True}, False),
    "canceled": ("network", "ping-pong", 8, {}, [],
                 {"telemetry": True, "chunk": 16}, {}, True),
    "additional-hosts": ("additional_hosts", "additional_hosts", 8, {}, [],
                         {"telemetry": True, "netmatrix": True, "chunk": 16,
                          "additional_hosts": ["http-echo"]}, {}, False),
}


def _jobs(name, jroot, proot):
    plan, case, n, params, faults, cfg, extra, _ = WORKLOADS[name]
    run_id = f"run-{name}"
    jgroup = JRunGroup(id="all", instances=n, parameters=dict(params),
                       artifact_path=os.path.join(REF_PLANS, plan), faults=list(faults))
    pgroup = RunGroup(id="all", instances=n, parameters=dict(params),
                      artifact_path=pexec.plan_dir(plan), faults=list(faults))
    common = dict(run_id=run_id, test_plan=plan, test_case=case, total_instances=n)
    jjob = JRunInput(groups=[jgroup], env=EnvConfig.load(home=str(jroot)),
                     runner_config=jexec.SimJaxConfig(shard=False, transport="xla",
                                                      **cfg),
                     **common, **extra)
    pjob = RunInput(groups=[pgroup], env=OutputsEnv(proot),
                    runner_config=pexec.SimTorchConfig(device="cpu", **cfg),
                    **common, **extra)
    return jjob, pjob


def _execute(execute, job, writer, cancel):
    """The run's output, or the run output a SloBreachError carried."""
    try:
        return execute(job, writer, cancel), None
    except (JSloBreachError, SloBreachError) as e:
        return e.run_output, e


def _strip(x):
    if isinstance(x, dict):
        return {k: _strip(v) for k, v in x.items() if k not in VARYING_FIELDS}
    if isinstance(x, list):
        return [_strip(v) for v in x]
    return x


def perf_row(row: dict) -> dict:
    """A ``sim_perf.jsonl`` row as both packages must agree on it: its
    identifying fields and its keys, the compile-derived ones aside."""
    return {"keys": sorted(set(row) - COMPILE_DERIVED),
            **{k: row[k] for k in PERF_ROW_FIELDS}}


def _read_tree(run_dir) -> dict:
    """Every file under the run directory, parsed and stripped:
    ``.jsonl``/``.out`` row by row, ``.json`` whole, the perf ledger's rows
    by :func:`perf_row`."""
    out = {}
    for root, _, names in os.walk(run_dir):
        for fname in names:
            path = os.path.join(root, fname)
            rel = os.path.relpath(path, run_dir)
            with open(path) as f:
                if fname.endswith(".json"):
                    out[rel] = _strip(json.load(f))
                elif fname == "sim_perf.jsonl":
                    out[rel] = [perf_row(json.loads(line)) for line in f if line.strip()]
                else:
                    out[rel] = [_strip(json.loads(line)) for line in f if line.strip()]
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each workload run once through both executors, on first use."""
    cache = {}

    def get(name):
        if name not in cache:
            base = tmp_path_factory.mktemp(name)
            jroot, proot = base / "jax", base / "torch"
            jjob, pjob = _jobs(name, jroot, proot)
            pre_cancel = WORKLOADS[name][-1]
            both = []
            for execute, job, writer in ((jexec.execute_sim_run, jjob, jdiscard()),
                                         (pexec.execute_sim_run, pjob, discard_writer())):
                cancel = threading.Event()
                if pre_cancel:
                    cancel.set()
                out, err = _execute(execute, job, writer, cancel)
                run_dir = os.path.join(job.env.dirs.outputs(), job.test_plan, job.run_id)
                both.append((out, err, _read_tree(run_dir)))
            cache[name] = both
        return cache[name]

    return get


def _journal(out) -> dict:
    j = json.loads(json.dumps(out.result.journal))
    j["sim"] = {k: v for k, v in j["sim"].items() if k not in SIM_SKIPPED}
    return j


@pytest.mark.parametrize("name", list(WORKLOADS))
def test_run_directory_matches_jax(name, runs):
    (_, _, jtree), (_, _, ptree) = runs(name)
    assert sorted(ptree) == sorted(jtree), name
    for rel in jtree:
        assert ptree[rel] == jtree[rel], f"{name}: {rel}"


@pytest.mark.parametrize("name", list(WORKLOADS))
def test_journal_and_outcome_match_jax(name, runs):
    (jout, jerr, _), (pout, perr, _) = runs(name)
    assert (jerr is None) == (perr is None), name
    if jerr is not None:
        assert str(perr) == str(jerr)
    assert pout.run_id == jout.run_id
    assert pout.result.outcome.value == jout.result.outcome.value, name
    assert ({k: v.to_dict() for k, v in pout.result.outcomes.items()}
            == {k: v.to_dict() for k, v in jout.result.outcomes.items()})
    assert _journal(pout) == _journal(jout), name


# name: (outcome, journal keys that must be there, files that must be there)
EXPECTED = {
    "ping-pong-planes": ("success", {"telemetry"},
                         {"sim_timeseries.jsonl", "sim_netmatrix.jsonl",
                          "sim_latency.jsonl", "run_spans.jsonl", "all/0/run.out",
                          "sim_perf.jsonl"}),
    "placebo-ok": ("success", set(), {"all/3/run.out", "sim_perf.jsonl"}),
    "placebo-abort": ("failure", set(), {"all/3/run.out"}),
    "chaos-smoke": ("success", {"telemetry", "trace", "slo", "metrics"},
                    {"sim_trace.jsonl", "trace_events.json", "sim_slo.jsonl"}),
    "chaos-fail": ("failure", {"slo"}, {"sim_slo.jsonl"}),
    "timeseries": ("success", {"timeseries", "metrics"},
                   {"timeseries.jsonl", "all/0/metrics.out"}),
    "no-metrics": ("success", {"metrics"}, set()),
    "canceled": ("canceled", {"telemetry"}, {"sim_timeseries.jsonl"}),
    "additional-hosts": ("success", {"telemetry"}, {"sim_netmatrix.jsonl"}),
}


@pytest.mark.parametrize("name", list(WORKLOADS))
def test_workload_covers_what_it_is_for(name, runs):
    """The equalities above are not vacuous: each workload reaches the
    outcome, journal blocks and files it is there for."""
    _, (pout, _, ptree) = runs(name)
    outcome, keys, files = EXPECTED[name]
    assert pout.result.outcome.value == outcome, name
    assert keys <= set(pout.result.journal), name
    assert files <= set(ptree), name


def test_chaos_breaches_fall_in_the_crash_window(runs):
    _, (pout, _, ptree) = runs("chaos-smoke")
    slo = pout.result.journal["slo"]
    assert slo["breaches"] > 0 and "error" not in slo
    ticks = [r["tick"] for r in ptree["sim_slo.jsonl"]]
    assert ticks and all(6 <= t <= 32 for t in ticks), ticks  # crash at 6, restart at 20


def test_fail_severity_cancels_the_run_at_the_reference_tick(runs):
    (jout, _, _), (pout, perr, _) = runs("chaos-fail")
    assert isinstance(perr, SloBreachError)
    assert perr.run_output is pout
    assert pout.result.journal["slo"]["error"] == str(perr)
    # canceled at the end of the chunk that breached, not run to the end
    assert pout.result.journal["sim"]["ticks"] == jout.result.journal["sim"]["ticks"]
    assert pout.result.journal["sim"]["ticks"] < runs("chaos-smoke")[1][0].result.journal[
        "sim"]["ticks"]


def test_disable_metrics_writes_no_series_and_no_spans(runs):
    _, (pout, _, ptree) = runs("no-metrics")
    assert "telemetry" not in pout.result.journal
    assert "timeseries" not in pout.result.journal
    assert not {"run_spans.jsonl", "sim_timeseries.jsonl", "timeseries.jsonl"} & set(ptree)


def test_telemetry_totals_equal_the_series(runs):
    _, (pout, _, ptree) = runs("chaos-smoke")
    rows = ptree["sim_timeseries.jsonl"]
    totals = pout.result.journal["telemetry"]["totals"]
    for col, key in (("delivered", "delivered"), ("sent", "sent"),
                     ("fault_dropped", "fault_dropped")):
        assert sum(r[col] for r in rows) == totals[key], col
    assert pout.result.journal["sim"]["net_matrix"]["mismatches"] == []


def test_outputs_over_the_cap_are_skipped(tmp_path):
    job = RunInput(run_id="capped", test_plan="placebo", test_case="ok",
                   total_instances=4, groups=[RunGroup(id="all", instances=4)],
                   env=OutputsEnv(tmp_path),
                   runner_config=pexec.SimTorchConfig(device="cpu", chunk=8,
                                                      write_outputs_max=3))
    out = pexec.execute_sim_run(job, discard_writer(), threading.Event())
    assert out.result.journal["outputs_skipped"] == {"instances": 4,
                                                     "write_outputs_max": 3}
    assert not os.path.isdir(tmp_path / "placebo" / "capped" / "all")


# name: (value, the ROADMAP item that refuses it; None for the settings of
# shape buckets, run packs, the 2-D mesh and the cohort, refused until they
# were ported, which now run; the coordinator's value is a free port at
# run time)
REFUSED = {
    "bucket": ("auto", None),
    "bucket_ladder": ("32,64", None),
    "build_buckets": (True, None),
    "pack": (True, None),
    "pack_max": (4, None),
    "mesh": ("2x4", None),
    "coordinator_address": ("127.0.0.1:<free>", None),
    "num_processes": (2, None),
    "process_id": (1, None),
}


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _placebo_job(tmp_path, **cfg):
    return RunInput(run_id="refused", test_plan="placebo", test_case="ok",
                    total_instances=2, groups=[RunGroup(id="all", instances=2)],
                    env=OutputsEnv(tmp_path),
                    runner_config=pexec.SimTorchConfig(**{"device": "cpu", **cfg}))


@pytest.mark.parametrize("name", ["checkpoint_chunks", "resume_from"])
def test_checkpoint_setting_runs(name, tmp_path):
    """The checkpoint plane's settings, refused until it was ported: a run
    with ``checkpoint_chunks`` keeps its snapshots, and ``resume_from``
    that run continues it from its newest one."""
    first = pexec.execute_sim_run(_placebo_job(tmp_path, checkpoint_chunks=1, chunk=8),
                                  discard_writer(), threading.Event())
    block = first.result.journal["sim"]["checkpoint"]
    assert block["count"] >= 1 and os.listdir(tmp_path / "placebo" / "refused" / "checkpoints")
    if name == "resume_from":
        job = _placebo_job(tmp_path, resume_from="refused", chunk=8)
        job.run_id = "resumed"
        out = pexec.execute_sim_run(job, discard_writer(), threading.Event())
        assert out.result.journal["sim"]["checkpoint"]["resumed"] == {
            "from_tick": block["last_tick"], "from_run": "refused",
            "snapshot": f"ckpt-{block['last_tick']:012d}.npz"}
        assert out.result.journal["events"] == first.result.journal["events"]


@pytest.mark.parametrize("name", list(REFUSED))
def test_unported_setting_is_refused_naming_its_item(name, tmp_path):
    value, item = REFUSED[name]
    if name == "coordinator_address":
        value = f"127.0.0.1:{_free_port()}"
    if item is None:
        # a bucket, pack, mesh or cohort setting: the run goes through,
        # exact-N, and a bucketed one journals its bucket block (a run
        # alone is no pack: the pack block is the supervisor's,
        # engine/pack.py), a 2-D meshed one its mesh block (its lanes split
        # over row 0's peer shards). A coordinator alone is a one-process
        # cohort, run by the leader child under the cohort's gates (no perf
        # ledger); a process count or id without one means nothing, as in
        # the reference
        try:
            out = pexec.execute_sim_run(_placebo_job(tmp_path, **{name: value}),
                                        discard_writer(), threading.Event())
        finally:
            shutdown_leader_child()
        assert out.result.journal["events"]["all"]["success"] == 2
        assert out.result.journal["sim"]["processes"] == 1
        assert ("perf" in out.result.journal["sim"]) == (name != "coordinator_address")
        assert "pack" not in out.result.journal["sim"]
        if name == "mesh":
            mesh = out.result.journal["sim"]["mesh"]
            assert (mesh["axes"], mesh["runs"], mesh["shards"]) == ("2x4", 2, 4)
            assert out.result.journal["sim"]["devices"] == 8
        bucket = out.result.journal["sim"].get("bucket")
        if name == "bucket":
            assert bucket["instances"] == 2 and bucket["padded_instances"] == 4096
        else:
            assert bucket is None  # neither knob pads without bucket=auto
        return
    with pytest.raises(NotImplementedError, match=f"{name}=.*ROADMAP queue 1 {item}"):
        pexec.execute_sim_run(_placebo_job(tmp_path, **{name: value}),
                              discard_writer(), threading.Event())
    assert not os.path.exists(tmp_path / "placebo")  # refused before any output


# the settings of the phase plane and the transport probe, refused until
# they were ported: each now runs, and journals what it asked for
PHASE_PLANE = {
    "phases": dict(phases=True),
    "phases_measure": dict(phases=True, phases_measure=3),
    "transport_probe": dict(transport="auto", transport_probe=2),
}


@pytest.mark.parametrize("name", list(PHASE_PLANE))
def test_phase_plane_setting_runs(name, tmp_path):
    out = pexec.execute_sim_run(_placebo_job(tmp_path, **PHASE_PLANE[name]),
                                discard_writer(), threading.Event())
    sim = out.result.journal["sim"]
    assert out.result.outcome.value == "success"
    if name == "transport_probe":
        assert "phases" not in sim
        assert sim["transport"]["scores"]["source"] == "measured"
        assert sim["transport"]["scores"]["reps"] == 2
        assert sim["transport"]["resolved"] == "plain"
        return
    assert [r["phase"] for r in sim["phases"]["phases"]] == [
        "deliver", "step", "sync", "net_commit"]
    assert (tmp_path / "placebo" / "refused" / "sim_phases.jsonl").exists()
    measured = [r.get("measured_reps") for r in sim["phases"]["phases"]]
    assert measured == ([3] * 4 if name == "phases_measure" else [None] * 4)


def test_without_a_gpu_no_device_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    job = _placebo_job(tmp_path, device=None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pexec.execute_sim_run(job, discard_writer(), threading.Event())
    assert not os.path.exists(tmp_path / "placebo")


@pytest.mark.parametrize("flag", ["netmatrix", "slo"])
def test_planes_without_telemetry_refused_like_reference(flag, tmp_path):
    extra = {"netmatrix": True} if flag == "netmatrix" else {}
    msgs = []
    for execute, job_cls, cfg, group, env, w in (
        (jexec.execute_sim_run, JRunInput, jexec.SimJaxConfig(shard=False, perf=False,
                                                              **extra),
         JRunGroup(id="all", instances=2, artifact_path=os.path.join(REF_PLANS, "placebo")),
         EnvConfig.load(home=str(tmp_path / "jax")), jdiscard()),
        (pexec.execute_sim_run, RunInput, pexec.SimTorchConfig(device="cpu", **extra),
         RunGroup(id="all", instances=2), OutputsEnv(tmp_path / "torch"), discard_writer()),
    ):
        job = job_cls(run_id="r", test_plan="placebo", test_case="ok", total_instances=2,
                      groups=[group], env=env, runner_config=cfg,
                      slo=[CHAOS_SLO] if flag == "slo" else [])
        with pytest.raises(ValueError) as e:
            execute(job, w, threading.Event())
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# ------------------------------------------------ SimProgram.run's loop hooks


class _Slow(papi.SimTestcase):
    """Runs forever; each step sleeps ``SLEEP_S`` on the host and, from
    tick ``NAN_AT`` on, writes a NaN into its float state."""

    MSG_WIDTH = 1
    MAX_LINK_TICKS = 4
    SLEEP_S = 0.0
    NAN_AT = 10**9

    def init(self, env):
        return {"x": torch.zeros(env.group.count, dtype=torch.float32, device=env.device)}

    def step(self, env, state, inbox, sync, t):
        import time as _time

        _time.sleep(self.SLEEP_S)
        x = torch.where(t >= self.NAN_AT, torch.full_like(state["x"], float("nan")),
                        state["x"] + 1)
        return self.out({"x": x}, status=torch.zeros_like(env.group_seq))


def _slow_program(**cls_attrs):
    groups = build_groups([RunGroup(id="all", instances=2)])
    tc = type("SlowCase", (_Slow,), cls_attrs)()
    return SimProgram(tc, groups, chunk=4, device="cpu")


def test_hooks_run_in_the_reference_order_and_cancel_ends_at_the_chunk():
    """Per chunk: the planes' callbacks, then ``on_chunk``, then
    ``observer``; a cancel set in ``on_chunk`` stops the loop after that
    chunk's observer (``engine.py:2118-2148``)."""
    groups = build_groups([RunGroup(id="all", instances=4)])
    factory = pexec.load_sim_testcases(pexec.plan_dir("placebo"))["stall"]
    prog = SimProgram(pexec.instantiate_testcase(factory, groups, 1.0), groups, chunk=4,
                      device="cpu", telemetry=True)
    calls, cancel = [], threading.Event()

    def on_chunk(ticks):
        calls.append(("on_chunk", ticks))
        if ticks == 8:
            cancel.set()

    res = prog.run(max_ticks=64, cancel=cancel, on_chunk=on_chunk,
                   telemetry_cb=lambda b: calls.append(("telemetry", len(b))),
                   lat_hist_cb=lambda d: calls.append(("lat_hist", d.shape)),
                   observer=lambda k, c: calls.append(("observer", k)))
    assert res["ticks"] == 8
    assert [c[0] for c in calls] == ["telemetry", "lat_hist", "on_chunk", "observer"] * 2


def test_watchdog_cancels_and_raises_on_a_stalled_chunk():
    from testground_tpu_torch.sim.engine import SimStallError

    prog = _slow_program(SLEEP_S=0.05)
    cancel, stalls = threading.Event(), []
    with pytest.raises(SimStallError, match="did not complete within 0.1s"):
        prog.run(max_ticks=64, cancel=cancel, chunk_timeout=0.1,
                 on_stall=lambda tick, idx: stalls.append((tick, idx)))
    assert cancel.is_set()
    assert stalls == [(8, 2)]  # armed from the third chunk on


def test_nan_guard_names_the_leaf_and_the_ticks():
    with pytest.raises(FloatingPointError,
                       match=r"NaN in carry leaf 'carry.states\[0\]\['x'\]' after ticks \(4, 8\]"):
        _slow_program(NAN_AT=5).run(max_ticks=64, nan_guard=True)
    assert _slow_program(NAN_AT=5).run(max_ticks=16)["ticks"] == 16  # off: runs on


@pytest.mark.parametrize("option,item", [("live_counts", "item 13")])
def test_unported_run_options_are_refused(option, item):
    """``run(live_counts=)``, refused until shape buckets were ported, is
    the reference's: on a program without a bucket plan it refuses with
    the reference's message."""
    with pytest.raises(ValueError, match=f"init_carry {option} must be provided exactly"):
        _slow_program().run(max_ticks=4, **{option: (1,)})


@pytest.mark.parametrize("name", list(ENGINE_CASES))
def test_carry_estimate_from_shapes_matches_jax(name):
    """``SimProgram.estimate_carry_bytes`` (the shapes alone, on the meta
    device) is the reference's ``estimate_carry_bytes`` on the engine
    parity cases, whose ``results()['carry_bytes']`` ``RESULT_KEYS``
    checks."""
    case, n, params, chunk = ENGINE_CASES[name]
    assert (port_program(case, n, params, chunk).estimate_carry_bytes()
            == jax_program(case, n, params, chunk).estimate_carry_bytes())


# ------------------------------------------------- packs on a mesh


def _pack_jobs(tmp_path, pkg, cfg, sizes=(5, 9, 13)):
    """One pack's jobs of each package: ping-pong members of ``sizes``,
    seeds 0.., each its own run."""
    out = []
    for i, n in enumerate(sizes):
        common = dict(run_id=f"member-{i}", test_plan="network", test_case="ping-pong",
                      total_instances=n)
        if pkg == "jax":
            out.append(JRunInput(
                groups=[JRunGroup(id="all", instances=n,
                                  artifact_path=os.path.join(REF_PLANS, "network"))],
                env=EnvConfig.load(home=str(tmp_path / "jax")),
                runner_config=jexec.SimJaxConfig(seed=i, **cfg), **common))
        else:
            out.append(RunInput(
                groups=[RunGroup(id="all", instances=n,
                                 artifact_path=pexec.plan_dir("network"))],
                env=OutputsEnv(tmp_path / "torch"),
                runner_config=pexec.SimTorchConfig(device="cpu", seed=i, **cfg), **common))
    return out


def _run_pack(tmp_path, pkg, cfg):
    """The pack through the package's ``execute_packed_sim_runs``: the
    outputs and the first member's log lines."""
    import io

    from testground_tpu.rpc import OutputWriter as JOutputWriter
    from testground_tpu_torch.rpc import OutputWriter

    jobs = _pack_jobs(tmp_path, pkg, cfg)
    sink = io.StringIO()
    mod, writer = (jexec, JOutputWriter) if pkg == "jax" else (pexec, OutputWriter)
    ows = [writer(None, echo=sink)] + [writer(None) for _ in jobs[1:]]
    outs = mod.execute_packed_sim_runs(jobs, ows, [threading.Event() for _ in jobs])
    return outs, sink.getvalue().splitlines()


PACK_MESH_CFG = {"pack": True, "bucket": "auto", "telemetry": True, "chunk": 16,
                 "max_ticks": 256}


@pytest.mark.parametrize("mesh", ["2x2", "4"])
def test_each_packed_member_journals_the_references_mesh_block(mesh, tmp_path):
    cfg = dict(PACK_MESH_CFG, mesh=mesh, bucket_ladder="32")
    jouts, _ = _run_pack(tmp_path, "jax", cfg)
    pouts, _ = _run_pack(tmp_path, "torch", cfg)
    for jo, po in zip(jouts, pouts):
        assert not isinstance(po, Exception), po
        js, ps = jo.result.journal["sim"], po.result.journal["sim"]
        assert ps["mesh"] == js["mesh"] and ps["mesh"]["axes"] == mesh
        assert ps["devices"] == js["devices"] == 4
        assert ps["pack"] == js["pack"]
        assert po.result.journal["events"]["all"]["success"] == \
            jo.result.journal["events"]["all"]["success"]


def test_unmeshed_fallback_warns_as_the_reference(tmp_path):
    """A bucket rung (14) that does not divide the 4 peer shards: the pack
    falls back to one device with the reference's two warnings and no
    mesh block."""
    cfg = dict(PACK_MESH_CFG, mesh="4", bucket_ladder="14")
    (jouts, jwarns), (pouts, pwarns) = (_run_pack(tmp_path, "jax", cfg),
                                        _run_pack(tmp_path, "torch", cfg))
    fallback = ("pack runs on a single device: the bucket ladder does not divide "
                "across the mesh peer shards")
    for warns in (jwarns, pwarns):
        assert any(fallback in w for w in warns), warns
        assert any("shape bucketing skipped on this mesh" in w for w in warns), warns
    for jo, po in zip(jouts, pouts):
        ps = po.result.journal["sim"]
        assert "mesh" not in ps and "mesh" not in jo.result.journal["sim"]
        assert ps["devices"] == 1 and ps["bucket"]["padded_instances"] == 14


def test_pallas_on_a_packed_mesh_is_overridden_as_the_reference(tmp_path):
    cfg = dict(PACK_MESH_CFG, mesh="2", bucket_ladder="32", transport="pallas")
    (jouts, jwarns), (pouts, pwarns) = (_run_pack(tmp_path, "jax", cfg),
                                        _run_pack(tmp_path, "torch", cfg))
    override = ("transport=pallas on a packed mesh resolves to xla (the vmapped "
                "kernels cannot shard over the run axis and the mesh at once)")
    assert any(override in w for w in jwarns) and any(override in w for w in pwarns)
    suffix = " — overridden: a packed mesh run uses the XLA transport"
    for jo, po in zip(jouts, pouts):
        jt, pt = jo.result.journal["sim"]["transport"], po.result.journal["sim"]["transport"]
        assert jt["reason"].endswith(suffix) and pt["reason"].endswith(suffix)
        assert pt["requested"] == jt["requested"] == "pallas"
        assert po.result.journal["sim"]["mesh"] == jo.result.journal["sim"]["mesh"]
