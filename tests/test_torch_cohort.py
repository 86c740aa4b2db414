"""Multi-process cohorts of the port (``sim/distributed.py``,
``sim/cohort.py``, the executor's cohort path and ``tg sim-worker``) on the
CPU, gloo over loopback, against the reference (``tests/test_multihost.py``,
``tests/test_cohort_guards.py``):

- with no process: the copy of ``sync/errors.py``, the typed-first fatal
  classifier, the spec-size precheck, the job spec, the sim-worker's
  dead-leader exit, and each cohort gate's warning and ``tg check``
  finding, each against the reference's;
- real cohorts: a leader (``execute_sim_run`` with ``coordinator_address``,
  through the leader child) and ``python -m testground_tpu_torch.cli
  sim-worker --once --device cpu`` followers. Each result equals the
  port's single-process run and the reference's, per instance (status,
  ``finished_at``, ``metrics.out``), in the journal's metrics and in every
  flow total, and each follower's carry digest equals the leader's; the
  lockstep skip, member death, cancel and the engine's drain behave as
  the reference's tests require.

Every child has a timeout and is killed in ``finally``; a cohort's leader
runs in a thread while the single-process runs it is held against run in
this process.
"""

import io
import json
import os
import re
import signal
import socket
import subprocess
import sys
import threading
import time

import pytest

from testground_tpu.api import RunGroup as JRunGroup
from testground_tpu.api import RunInput as JRunInput
from testground_tpu.config import EnvConfig as JEnvConfig
from testground_tpu.rpc import discard_writer as jdiscard
from testground_tpu.sim import cohort as jcohort
from testground_tpu.sim import executor as jexec
from testground_tpu.sync import errors as jerrors
from testground_tpu_torch.api import OutputsEnv, RunGroup, RunInput
from testground_tpu_torch.rpc import OutputWriter, discard_writer
from testground_tpu_torch.sim import cohort as pcohort
from testground_tpu_torch.sim import executor as pexec
from testground_tpu_torch.sync import errors as perrors

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_PLANS = os.path.join(REPO, "testground_tpu_torch", "plans")
REF_PLANS = os.path.join(REPO, "plans")

# flow totals of the journal's sim block: the cohort's, the single run's
# and the reference's are the same numbers
FLOW = ("msgs_delivered", "msgs_sent", "msgs_enqueued", "msgs_dropped",
        "msgs_rejected", "msgs_in_flight", "msgs_fault_dropped", "latency_clamped",
        "bw_queue_dropped", "bw_rate_change_backlogged", "pub_dropped",
        "faults_crashed", "faults_restarted", "ticks")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _clean_env():
    """A clean environment for each child (the reference's ``_clean_env``):
    nothing of the calling process's accelerator or relay settings leaks
    in."""
    return {
        "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
        "HOME": os.environ.get("HOME", os.path.expanduser("~")),
        "PYTHONPATH": REPO,
    }


def _worker(coord, n_procs, pid, plans=PORT_PLANS):
    return subprocess.Popen(
        [sys.executable, "-m", "testground_tpu_torch.cli", "sim-worker",
         "--coordinator", coord, "--num-processes", str(n_procs),
         "--process-id", str(pid), "--plans", plans, "--once", "--device", "cpu"],
        env=_clean_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )


def _kill_all(procs) -> None:
    for p in procs:
        if p is not None and p.poll() is None:
            p.kill()
            p.wait()


class _Sink(io.StringIO):
    """An OutputWriter sink whose progress lines a test can read while the
    run goes on."""

    def progress(self) -> str:
        return "".join(json.loads(ln).get("p", "") for ln in self.getvalue().splitlines()
                       if ln.startswith("{"))


def _job(root, spec, **cfg):
    plan, n = spec["plan"], spec["instances"]
    return RunInput(
        run_id=spec["run_id"], test_plan=plan, test_case=spec["case"], total_instances=n,
        groups=[RunGroup(id="all", instances=n, parameters=dict(spec.get("params", {})),
                         artifact_path=os.path.join(PORT_PLANS, plan),
                         faults=list(spec.get("faults", [])))],
        runner_config=pexec.SimTorchConfig(device="cpu", chunk=spec.get("chunk", 64),
                                           validate=spec.get("validate", False), **cfg),
        env=OutputsEnv(root),
    )


def _ref_run(home, spec):
    plan, n = spec["plan"], spec["instances"]
    job = JRunInput(
        run_id=spec["run_id"], test_plan=plan, test_case=spec["case"], total_instances=n,
        groups=[JRunGroup(id="all", instances=n, parameters=dict(spec.get("params", {})),
                          artifact_path=os.path.join(REF_PLANS, plan),
                          faults=list(spec.get("faults", [])))],
        runner_config=jexec.SimJaxConfig(shard=False, transport="xla", perf=False,
                                         chunk=spec.get("chunk", 64),
                                         validate=spec.get("validate", False)),
        env=JEnvConfig.load(home=str(home)),
    )
    out = jexec.execute_sim_run(job, jdiscard(), threading.Event())
    return out.result, os.path.join(str(home), "data", "outputs", plan, spec["run_id"])


def _instance_digest(run_dir):
    """Per-instance (status, finished_at, metrics) off the outputs layout —
    the reference's ``_instance_digest`` (``tests/test_multihost.py``)."""
    digest = {}
    for group in sorted(os.listdir(run_dir)):
        gdir = os.path.join(run_dir, group)
        if not os.path.isdir(gdir) or not os.path.isfile(os.path.join(gdir, "0", "run.out")):
            continue
        for inst in sorted(os.listdir(gdir), key=int):
            d = os.path.join(gdir, inst)
            with open(os.path.join(d, "run.out")) as f:
                evt = json.loads(f.readline())
            entry = {"status": evt["event"]["type"], "finished_at": evt["finished_at_tick"]}
            mpath = os.path.join(d, "metrics.out")
            if os.path.isfile(mpath):
                with open(mpath) as f:
                    entry["metrics"] = {row["name"]: row["value"] for row in map(json.loads, f)}
            digest[(group, int(inst))] = entry
    return digest


def _cohort(root, spec, n_procs, plans=PORT_PLANS, during=None, on_progress=None, **cfg):
    """Run ``spec`` as a cohort of ``n_procs``: the leader through
    ``execute_sim_run`` (its child) in a thread, ``n_procs - 1`` sim-worker
    processes. ``during()`` runs here meanwhile; ``on_progress(sink,
    workers, cancel)`` is polled until the leader ends. Returns (the
    leader's result or exception, its progress text, the workers' output,
    their exit codes, what ``during`` returned)."""
    coord = f"127.0.0.1:{_free_port()}"
    job = _job(root, spec, coordinator_address=coord, num_processes=n_procs, **cfg)
    sink, cancel, box = _Sink(), threading.Event(), {}

    def lead():
        try:
            box["out"] = pexec.execute_sim_run(job, OutputWriter(sink=sink), cancel)
        except Exception as e:  # noqa: BLE001 — handed to the test
            box["out"] = e

    workers = []
    leader = threading.Thread(target=lead, daemon=True)
    try:
        leader.start()
        workers = [_worker(coord, n_procs, pid, plans) for pid in range(1, n_procs)]
        got = during() if during is not None else None
        deadline = time.time() + 60
        while leader.is_alive() and time.time() < deadline:
            if on_progress is not None:
                on_progress(sink, workers, cancel)
            leader.join(0.1)
        assert not leader.is_alive(), "the cohort's leader did not finish in 60 s"
        pcohort.shutdown_leader_child()  # the sentinel releases --once workers
        outs = [w.communicate(timeout=60)[0] for w in workers]
        return box["out"], sink.progress(), outs, [w.returncode for w in workers], got
    finally:
        pcohort.shutdown_leader_child()
        _kill_all(workers)


# ---------------------------------------------------------------- no process


def test_sync_errors_copy_matches_the_reference():
    for mod in (perrors, jerrors):
        e = mod.SyncLostError("gone", address=("h", 1), attempts=3, elapsed_secs=1.5)
        assert isinstance(e, ConnectionError)
        assert (str(e), e.address, e.attempts, e.elapsed_secs) == ("gone", ("h", 1), 3, 1.5)
        assert mod.__all__ == ["SyncLostError"]
    assert [k.__name__ for k in perrors.SyncLostError.__mro__] == [
        k.__name__ for k in jerrors.SyncLostError.__mro__]


def _gloo_error(text):
    return RuntimeError(f"[../third_party/gloo/gloo/transport/tcp/pair.cc:534] {text}")


# label: (exception, fatal); the reference's four cases with torch's types
FATAL_CASES = {
    "plan-valueerror-mentioning-barrier": (
        lambda: ValueError("plan failed: barrier 'go' timed out at t=32"), False),
    "plan-runtimeerror-unavailable": (
        lambda: RuntimeError("sync service unavailable for group 'all'"), False),
    "backend-error-closed-by-peer": (
        lambda: __import__("torch").distributed.DistBackendError(
            "Connection closed by peer [127.0.0.1]:4242"), True),
    "network-error-reset": (
        lambda: __import__("torch").distributed.DistNetworkError(
            "Connection reset by peer"), True),
    "gloo-runtime-error": (lambda: _gloo_error("Connection closed by peer [::1]:1"), True),
    "backend-error-out-of-memory": (
        lambda: __import__("torch").distributed.DistBackendError(
            "CUDA out of memory"), False),
    "type-name-dist-error": (
        lambda: type("DistError", (RuntimeError,), {})("heartbeat lost"), True),
    "sync-lost": (lambda: perrors.SyncLostError("sync service gone"), True),
}


@pytest.mark.parametrize("label", list(FATAL_CASES))
def test_is_cohort_fatal_is_typed_first(label):
    make, fatal = FATAL_CASES[label]
    assert pcohort._is_cohort_fatal(make()) is fatal
    if label.startswith("plan-"):  # plain Python errors: the same verdict
        assert jcohort._is_cohort_fatal(make()) is fatal


def _spec_job(pkg, params, **cfg):
    run_input, group = ((RunInput, RunGroup) if pkg == "torch"
                        else (JRunInput, JRunGroup))
    config = (pexec.SimTorchConfig if pkg == "torch" else jexec.SimJaxConfig)(**cfg)
    return run_input(run_id="specsize", test_plan="network", test_case="ping-pong",
                     total_instances=4,
                     groups=[group(id="all", instances=4, parameters=params,
                                   faults=[{"kind": "crash", "instances": "0:1",
                                            "start_ms": 2.0}])],
                     runner_config=config)


def test_oversized_spec_fails_fast_and_as_the_reference():
    big = {"blob": "x" * (70 * 1024)}
    job = _spec_job("torch", big, coordinator_address="127.0.0.1:1", device="cpu")
    t0 = time.monotonic()
    with pytest.raises(ValueError) as port:
        pexec.execute_sim_run(job, discard_writer(), threading.Event())
    assert time.monotonic() - t0 < 5.0  # refused without touching the address
    msg = str(port.value)
    assert "65,536" in msg and "group 'all'" in msg and "before spawning" in msg
    with pytest.raises(ValueError) as ref:
        jexec._precheck_cohort_spec_size(
            _spec_job("jax", big, coordinator_address="127.0.0.1:1"),
            jexec.SimJaxConfig(coordinator_address="127.0.0.1:1"))
    assert msg == str(ref.value)


def test_in_bound_spec_passes_the_precheck():
    cfg = pexec.SimTorchConfig(coordinator_address="127.0.0.1:1")
    pexec._precheck_cohort_spec_size(_spec_job("torch", {"latency_ms": "4"}), cfg)


@pytest.mark.parametrize("hosts", [(), ("http-echo",)], ids=["plain", "hosts"])
def test_cohort_job_spec_is_the_references(hosts):
    params = {"latency_ms": "4"}
    kw = dict(chunk=32, seed=7, max_ticks=900, validate=True, tick_ms=2.0)
    pjob = _spec_job("torch", params, **kw)
    jjob = _spec_job("jax", params, **kw)
    faults = pexec.fault_specs_of(pjob.groups)
    port = pexec._cohort_job_spec(pjob, pjob.runner_config, hosts=hosts, telemetry=False,
                                  transport="xla", faults=faults)
    ref = jexec._cohort_job_spec(jjob, jjob.runner_config, hosts=hosts, telemetry=False,
                                 transport="xla", faults=jexec.fault_specs_of(jjob.groups))
    assert port == ref
    assert json.dumps(port) == json.dumps(ref)  # the same bytes on the wire


class TestSimWorkerDeadLeaderExit:
    """The reference's ``TestSimWorkerDeadLeaderExit``: a dead leader ends
    a sim-worker with ONE readable line and an immediate exit; plan errors
    still raise."""

    def _invoke(self, monkeypatch, exc):
        def boom(*a, **kw):
            raise exc

        monkeypatch.setattr(pexec, "sim_worker_loop", boom)
        lines, exits = [], []
        rc = pexec.run_sim_worker("127.0.0.1:1", 2, 1, "/nonexistent-plans",
                                  log=lines.append, _exit=exits.append)
        return rc, lines, exits

    def test_dead_leader_is_one_clean_line(self, monkeypatch):
        import torch.distributed as dist

        rc, lines, exits = self._invoke(
            monkeypatch, dist.DistBackendError("Connection closed by peer [127.0.0.1]:1"))
        assert exits == [1] and rc == 1 and len(lines) == 1
        line = lines[0]
        assert line.startswith("sim-worker: cohort lost")
        assert "exiting cleanly" in line and "restart" in line

    def test_plan_error_still_raises_normally(self, monkeypatch):
        with pytest.raises(ValueError, match="barrier"):
            self._invoke(monkeypatch, ValueError("plan failed: barrier 'go' timed out"))

    def test_keyboard_interrupt_passes_through(self, monkeypatch):
        with pytest.raises(KeyboardInterrupt):
            self._invoke(monkeypatch, KeyboardInterrupt())

    def test_healthy_loop_returns_zero(self, monkeypatch):
        monkeypatch.setattr(pexec, "sim_worker_loop", lambda *a, **kw: None)
        assert pexec.run_sim_worker("127.0.0.1:1", 2, 1, "/plans", log=lambda s: None) == 0


def _reference_gate_warnings() -> list:
    """The reference executor's cohort-gate warnings, in source order: each
    ``ow.warn`` whose text names the cohort config, its format string."""
    import ast

    with open(jexec.__file__) as f:
        tree = ast.parse(f.read())
    found = []
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "warn" and node.args
                and isinstance(node.args[0], ast.Constant)
                and "for the cohort config" in str(node.args[0].value)):
            found.append((node.lineno, node.args[0].value))
    return [text for _, text in sorted(found)]


def test_each_cohort_gate_warns_as_the_reference(tmp_path):
    """A one-process cohort (the leader child, a coordinator of its own)
    with every gated plane asked for: each gate's warning, in the
    reference's words and order, and the run goes on without them."""
    spec = {"plan": "placebo", "case": "ok", "instances": 2, "run_id": "gates", "chunk": 8}
    job = _job(str(tmp_path), spec, coordinator_address=f"127.0.0.1:{_free_port()}",
               telemetry=True, netmatrix=True, nan_guard=True, checkpoint_chunks=1,
               bucket="auto", max_ticks=16)
    job.groups[0].trace = {"instances": "0:1"}
    job.slo = [{"metric": "drop_rate", "op": "<", "threshold": 0.5}]
    sink = _Sink()
    try:
        out = pexec.execute_sim_run(job, OutputWriter(sink=sink), threading.Event())
    finally:
        pcohort.shutdown_leader_child()
    lines = [ln for ln in sink.progress().splitlines() if "cohort config" in ln]
    want = [w % "gates" for w in _reference_gate_warnings()]
    bucket = [ln for ln in lines if ln.startswith("shape bucketing")]
    jwarned = []
    jexec.resolve_buckets(jexec.SimJaxConfig(coordinator_address="x:1", bucket="auto"),
                          [2], warn=lambda fmt, *a: jwarned.append(fmt % a))
    assert bucket == jwarned
    assert [ln for ln in lines if ln not in bucket] == [
        w.replace("sim:jax", "sim:torch") for w in want]
    sim = out.result.journal["sim"]
    assert out.result.outcome.value == "success"
    assert not {"perf", "checkpoint", "bucket", "latency", "net_matrix"} & set(sim)
    assert "trace" not in out.result.journal and "slo" not in out.result.journal


# the cohort compositions of ``tg check``: (make_comp kwargs)
CHECK_CASES = {
    "gates": dict(run_cfg={"coordinator_address": "127.0.0.1:1", "num_processes": 2,
                           "telemetry": True, "netmatrix": True, "nan_guard": True,
                           "checkpoint_chunks": 2, "bucket": "auto"},
                  trace={"instances": "0:1"},
                  slo=[{"metric": "drop_rate", "op": "<", "threshold": 0.5}]),
    "resume": dict(run_cfg={"coordinator_address": "127.0.0.1:1", "resume_from": "x"}),
    "spec-oversize": dict(run_cfg={"coordinator_address": "127.0.0.1:1"},
                          params={"blob": "x" * (70 * 1024)}),
    "clean": dict(run_cfg={"coordinator_address": "127.0.0.1:1", "num_processes": 2}),
}


@pytest.mark.parametrize("label", list(CHECK_CASES))
def test_check_cohort_findings_are_the_references(label):
    from test_torch_check import findings

    kw = CHECK_CASES[label]
    port, ref = findings("torch", **kw), findings("jax", **kw)
    assert port == ref
    assert bool(port) == (label != "clean")


# --------------------------------------------------------- bit-equality


# label: (spec, processes); the reference's cases (tests/test_multihost.py)
EQUAL_CASES = {
    "placebo-2": ({"plan": "placebo", "case": "ok", "instances": 8, "chunk": 8}, 2),
    "placebo-3": ({"plan": "placebo", "case": "ok", "instances": 8, "chunk": 8}, 3),
    "ping-pong-2": ({"plan": "network", "case": "ping-pong", "instances": 8,
                     "params": {"latency_ms": "100", "latency2_ms": "10",
                                "tolerance_ms": "15"}}, 2),
    "splitbrain-reject-3": ({"plan": "splitbrain", "case": "reject", "instances": 9}, 3),
    "splitbrain-drop-4": ({"plan": "splitbrain", "case": "drop", "instances": 12}, 4),
    "direct-validate-2": ({"plan": "benchmarks", "case": "pingpong-flood", "instances": 8,
                           "params": {"duration_ticks": "64", "latency_ms": "4"},
                           "validate": True}, 2),
    "traffic-shaped-2": ({"plan": "network", "case": "traffic-shaped", "instances": 8,
                          "params": {"burst": "6", "rate": "1.5"}}, 2),
    "storm-16-2": ({"plan": "benchmarks", "case": "storm", "instances": 16,
                    "params": {"conn_outgoing": "5", "conn_delay_ticks": "8",
                               "data_size_kb": "64"}}, 2),
    # a fault schedule of every kind: the crash purge's counts summed over
    # the processes, the faults lowered alike on each from the spec
    "chaos-faults-2": ({"plan": "chaos", "case": "chaos-barrier", "instances": 8,
                        "chunk": 16, "params": {"slow_count": "2", "slow_tick": "30",
                                                "heal_tick": "44", "deadline": "120"},
                        "faults": [
                            {"kind": "crash", "instances": "0:2", "start_ms": 6.0},
                            {"kind": "link_flap", "instances": "2:4", "start_ms": 8.0,
                             "duration_ms": 8.0, "period_ms": 4.0, "duty": 0.5},
                            {"kind": "restart", "instances": "0:2", "start_ms": 20.0},
                            {"kind": "partition", "instances": "0:4",
                             "to_instances": "4:8", "start_ms": 24.0,
                             "duration_ms": 16.0}]}, 2),
    # steady traffic, and a crash of lanes the follower's shard holds: the
    # purge's counts must be summed for the leader to see them
    "sustained-crash-2": ({"plan": "network", "case": "pingpong-sustained",
                           "instances": 8, "chunk": 16,
                           "params": {"duration_ticks": "96", "latency_ms": "4",
                                      "latency2_ms": "2", "reshape_every": "32"},
                           "faults": [
                               {"kind": "crash", "instances": "5:7", "start_ms": 10.0},
                               {"kind": "restart", "instances": "5:7",
                                "start_ms": 30.0}]}, 2),
}


@pytest.mark.parametrize("label", list(EQUAL_CASES))
def test_cohort_equals_single_process_runs(label, tmp_path):
    spec, n_procs = EQUAL_CASES[label]
    spec = {**spec, "run_id": f"mh-{label}"}

    def singles():
        single = pexec.execute_sim_run(_job(str(tmp_path / "single"), spec),
                                       discard_writer(), threading.Event())
        ref, ref_dir = _ref_run(tmp_path / "ref", spec)
        return single.result, ref, ref_dir

    out, progress, outs, rcs, (single, ref, ref_dir) = _cohort(
        str(tmp_path / "cohort"), spec, n_procs, during=singles)
    assert not isinstance(out, Exception), out
    assert rcs == [0] * (n_procs - 1), outs
    res = out.result
    assert res.outcome.value == single.outcome.value == ref.outcome.value == "success"
    sim = res.journal["sim"]
    assert (sim["processes"], sim["devices"]) == (n_procs, n_procs)
    assert sim["mesh"]["shards"] == n_procs
    assert f"multi-host: {n_procs} processes, {n_procs} global devices, leader=0, " \
           "collectives over gloo" in progress
    # journal metrics, flow totals, per-instance records
    assert res.journal.get("metrics") == single.journal.get("metrics") \
        == ref.journal.get("metrics")
    for key in FLOW:
        assert sim[key] == single.journal["sim"][key] == ref.journal["sim"][key], key
    digest = _instance_digest(str(tmp_path / "cohort" / spec["plan"] / spec["run_id"]))
    assert digest == _instance_digest(
        str(tmp_path / "single" / spec["plan"] / spec["run_id"]))
    assert digest == _instance_digest(ref_dir)
    assert len(digest) == spec["instances"]
    # every follower's replica ends where the leader's does
    lead = re.findall(r"multi-host: carry digest (\d+)", progress)
    assert len(lead) == 1
    for text in outs:
        assert re.findall(rf"run {spec['run_id']} carry digest (\d+)", text) == lead
        assert f"sim-worker: run {spec['run_id']} done" in text


# a cohort of the library: both processes build the program on the global
# mesh with every plane on (the executor's gates keep them off a cohort
# run; the library does not), so the etick row's gather and the matrix
# purge's sums cross processes; rank 0 prints its results
PLANES_SCRIPT = r"""
import json, sys
import torch
from testground_tpu_torch.api import RunGroup
from testground_tpu_torch.sim import distributed
from testground_tpu_torch.sim.engine import SimProgram, build_groups, carry_digest
from testground_tpu_torch.sim.executor import instantiate_testcase, load_sim_testcases, plan_dir
from testground_tpu_torch.sim.faults import build_fault_schedule

coord, pid, spec = sys.argv[1], int(sys.argv[2]), json.loads(sys.argv[3])
distributed.init_distributed(coord, 2, pid)
groups = build_groups([RunGroup(id="all", instances=spec["n"], parameters=spec["params"])])
tc = instantiate_testcase(load_sim_testcases(plan_dir("network"))["pingpong-sustained"],
                          groups, 1.0)
prog = SimProgram(tc, groups, chunk=16, device="cpu", telemetry=True, netmatrix=True,
                  faults=build_fault_schedule(groups, {"all": spec["faults"]}, 1.0),
                  mesh=distributed.global_mesh("cpu"))
last = {}
res = prog.run(seed=0, max_ticks=512, cancel=distributed.CohortCancel(None),
               observer=lambda t, c: last.update(c=c))
print(json.dumps({"status": res["status"].tolist(), "lat_hist": res["lat_hist"],
                  "net_matrix": res["net_matrix"], "fault_dropped": res["fault_dropped"],
                  "digest": carry_digest(last["c"])}), flush=True)
distributed.shutdown()
"""


def test_library_cohort_with_every_plane_equals_the_single_program(tmp_path):
    """The latency histogram (its etick row gathered over the processes)
    and the traffic matrix (the crash purge's matrix summed) of a
    two-process cohort of ``SimProgram``s equal the single program's."""
    import torch  # noqa: F401 — the single program runs here

    from testground_tpu_torch.api import RunGroup as PGroup
    from testground_tpu_torch.sim.engine import SimProgram, build_groups, carry_digest
    from testground_tpu_torch.sim.faults import build_fault_schedule

    crash = EQUAL_CASES["sustained-crash-2"][0]
    spec = {"n": 8, "params": crash["params"], "faults": crash["faults"]}
    coord = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen([sys.executable, "-c", PLANES_SCRIPT, coord, str(pid),
                               json.dumps(spec)], env=_clean_env(),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for pid in (0, 1)]
    try:
        outs = [p.communicate(timeout=60)[0] for p in procs]
    finally:
        _kill_all(procs)
    assert [p.returncode for p in procs] == [0, 0], outs
    got = [json.loads(next(ln for ln in out.splitlines() if ln.startswith("{")))
           for out in outs]
    groups = build_groups([PGroup(id="all", instances=8, parameters=spec["params"])])
    tc = pexec.instantiate_testcase(
        pexec.load_sim_testcases(pexec.plan_dir("network"))["pingpong-sustained"], groups,
        1.0)
    prog = SimProgram(tc, groups, chunk=16, device="cpu", telemetry=True, netmatrix=True,
                      faults=build_fault_schedule(groups, {"all": spec["faults"]}, 1.0))
    last = {}
    res = prog.run(seed=0, max_ticks=512, observer=lambda t, c: last.update(c=c))
    want = {"status": res["status"].tolist(), "lat_hist": res["lat_hist"],
            "net_matrix": res["net_matrix"], "fault_dropped": res["fault_dropped"],
            "digest": carry_digest(last["c"])}
    assert want["fault_dropped"] > 0 and sum(map(sum, want["lat_hist"])) > 0
    from testground_tpu_torch.sim.netmatrix import NM_FAULT

    assert sum(map(sum, want["net_matrix"][NM_FAULT])) > 0  # the purge's cells
    assert got[0] == got[1] == want


# one direct-mode enqueue under validate on a cohort's calendar: fan-in
# onto lanes of the follower's shard of a pre-filled calendar, so only the
# follower's probe sees the occupied slots; rank 0 prints what it counted
ENQUEUE_SCRIPT = r"""
import json, sys
import numpy as np
import torch
from testground_tpu_torch.sim import distributed, net

coord, pid, seed = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
distributed.init_distributed(coord, 2, pid)
mesh = distributed.global_mesh("cpu")
n, L, slots = 8, 8, 4
rng = np.random.default_rng(seed)
valid = torch.from_numpy(rng.random((L, slots * n)) < 0.3)
pay = torch.from_numpy(rng.integers(0, 9, (L, slots * n)).astype(np.int32))
cal = net.Calendar(payload=(net.to_shards(pay, mesh, slots),), src=None,
                   valid=net.to_shards(valid, mesh, slots), slots=slots, mesh=mesh)
link = net.make_link_state(n, 1, [2.0, 0, 0, 0, 0, 0, 0], device="cpu")
dst = torch.from_numpy(rng.integers(5, 8, (2, n)).astype(np.int32))
cal, fb = net.enqueue(cal, link, dst, torch.zeros((2, 1, n), dtype=torch.int32),
                      torch.ones((2, n), dtype=torch.bool), torch.tensor([3], dtype=torch.int32),
                      1.0, (1, 2), slot_mode="direct", features=("latency",), validate=True)
print("RESULT", json.dumps([int(fb.collisions), fb.collision_where.tolist(),
                           int(fb.enqueued)]), flush=True)
distributed.shutdown()
"""


def test_validate_probe_on_a_cohort_counts_the_followers_collisions():
    """``validate``'s occupancy probe ORed over the processes: a fan-in onto
    the follower's occupied slots counts the same collisions, with the same
    first (receiver, slot), as the single calendar's."""
    import numpy as np
    import torch

    from testground_tpu_torch.sim import net

    seed = 3  # three of the six target slots of row 5 occupied
    coord = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen([sys.executable, "-c", ENQUEUE_SCRIPT, coord, str(pid),
                               str(seed)], env=_clean_env(), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for pid in (0, 1)]
    try:
        outs = [p.communicate(timeout=60)[0] for p in procs]
    finally:
        _kill_all(procs)
    assert [p.returncode for p in procs] == [0, 0], outs
    got = [json.loads(next(ln for ln in out.splitlines() if ln.startswith("RESULT "))[7:])
           for out in outs]
    n, L, slots = 8, 8, 4
    rng = np.random.default_rng(seed)
    valid = torch.from_numpy(rng.random((L, slots * n)) < 0.3)
    pay = torch.from_numpy(rng.integers(0, 9, (L, slots * n)).astype(np.int32))
    cal = net.Calendar(payload=(pay,), src=None, valid=valid, slots=slots)
    link = net.make_link_state(n, 1, [2.0, 0, 0, 0, 0, 0, 0], device="cpu")
    dst = torch.from_numpy(rng.integers(5, 8, (2, n)).astype(np.int32))
    _, fb = net.enqueue(cal, link, dst, torch.zeros((2, 1, n), dtype=torch.int32),
                        torch.ones((2, n), dtype=torch.bool),
                        torch.tensor([3], dtype=torch.int32), 1.0, (1, 2),
                        slot_mode="direct", features=("latency",), validate=True)
    want = [int(fb.collisions), fb.collision_where.tolist(), int(fb.enqueued)]
    assert want[0] > 0
    assert got[0] == got[1] == want


# ------------------------------------------------------- lockstep, death


def test_unsatisfiable_job_is_skipped_in_lockstep(tmp_path):
    """A worker whose plans dir lacks the plan votes not-ready; the whole
    cohort skips the job before any program collective: the leader gets
    the reference's error, the worker exits cleanly."""
    empty = tmp_path / "empty-plans"
    empty.mkdir()
    spec = {"plan": "placebo", "case": "ok", "instances": 4, "run_id": "mhrun", "chunk": 8}
    out, _, outs, rcs, _ = _cohort(str(tmp_path), spec, 2, plans=str(empty))
    assert isinstance(out, RuntimeError) and "cohort member cannot satisfy" in str(out)
    assert rcs == [0] and "cohort skipped run mhrun" in outs[0]


SUSTAINED = {"plan": "network", "case": "pingpong-sustained", "instances": 8, "chunk": 8,
             "params": {"duration_ticks": "1000000", "latency_ms": "4",
                        "latency2_ms": "2", "reshape_every": "1000"}}


def _chunked(root, run_id):
    """Whether the run's span file shows a chunk: the loop runs."""
    try:
        with open(os.path.join(root, "network", run_id, "run_spans.jsonl")) as f:
            return '"chunk"' in f.read()
    except OSError:
        return False


@pytest.mark.parametrize("n_procs,kill_idx", [(2, 0), (3, 1)], ids=["two", "three"])
def test_member_death_fails_the_task_and_the_engine_survives(n_procs, kill_idx, tmp_path):
    """A follower SIGKILLed mid-run fails the leader's task readably (the
    message names the cohort member and the sim-worker remedy) within 60 s,
    and this process — the engine — goes on running single-process runs."""
    spec = {**SUSTAINED, "run_id": "deathrun"}
    root = str(tmp_path)
    state = {}

    def kill_mid_run(sink, workers, cancel):
        if "t_kill" not in state and _chunked(root, "deathrun"):
            workers[kill_idx].send_signal(signal.SIGKILL)
            state["t_kill"] = time.time()

    out, _, outs, rcs, _ = _cohort(root, spec, n_procs, on_progress=kill_mid_run,
                                   max_ticks=10_000_000)
    assert "t_kill" in state, "the run never reached its chunk loop"
    elapsed = time.time() - state["t_kill"]
    assert isinstance(out, pcohort.CohortBrokenError), out
    assert "cohort member" in str(out).lower() and "sim-worker" in str(out)
    assert elapsed < 60, f"failure took {elapsed:.1f}s"
    assert rcs[kill_idx] == -signal.SIGKILL
    after = pexec.execute_sim_run(_job(root, {"plan": "placebo", "case": "ok",
                                              "instances": 2, "run_id": "after",
                                              "chunk": 8}),
                                  discard_writer(), threading.Event())
    assert after.result.outcome.value == "success"


def test_cancel_stops_the_cohort_in_lockstep(tmp_path):
    """The task's cancel goes through the leader child and the cohort's
    chunk-boundary vote: the task ends CANCELED, the follower serves the
    shutdown sentinel, and both exit cleanly."""
    spec = {**SUSTAINED, "run_id": "cancelrun"}
    root = str(tmp_path)

    def cancel_mid_run(sink, workers, cancel):
        if _chunked(root, "cancelrun"):
            cancel.set()

    out, _, outs, rcs, _ = _cohort(root, spec, 2, on_progress=cancel_mid_run,
                                   max_ticks=10_000_000)
    assert not isinstance(out, Exception), out
    assert out.result.outcome.value == "canceled"
    assert rcs == [0] and "sim-worker: shutdown" in outs[0]


def test_engine_runs_a_cohort_task_and_stop_drains_it(tmp_path):
    """A cohort task queued on the port's Engine runs through the leader
    child; ``Engine.stop`` drains the worker through the child's shutdown
    broadcast, and this process never joins the cohort."""
    import torch.distributed as dist

    from testground_tpu_torch.api import (
        Composition, Global, Group, Instances, TestPlanManifest, generate_default_run)
    from testground_tpu_torch.builders import SimPlanBuilder
    from testground_tpu_torch.config import EnvConfig
    from testground_tpu_torch.engine import Engine, EngineConfig, Outcome, State
    from testground_tpu_torch.sim.runner import SimTorchRunner

    home = tmp_path / "home"
    home.mkdir()
    env = EnvConfig.load(home=str(home))
    env.daemon.scheduler.workers = 1
    engine = Engine(EngineConfig(env=env, builders=[SimPlanBuilder()],
                                 runners=[SimTorchRunner()]))
    engine.start_workers()
    coord = f"127.0.0.1:{_free_port()}"
    follower = None
    try:
        comp = generate_default_run(Composition(
            global_=Global(plan="network", case="ping-pong", builder="sim:plan",
                           runner="sim:torch",
                           run_config={"coordinator_address": coord, "num_processes": 2,
                                       "process_id": 0, "chunk": 8, "device": "cpu"}),
            groups=[Group(id="all", instances=Instances(count=8))],
        ))
        manifest = TestPlanManifest.load_file(os.path.join(PORT_PLANS, "network",
                                                           "manifest.toml"))
        tid = engine.queue_run(comp, manifest,
                               sources_dir=os.path.join(PORT_PLANS, "network"))
        follower = _worker(coord, 2, 1)
        deadline = time.time() + 60
        t = None
        while time.time() < deadline:
            t = engine.get_task(tid)
            if t is not None and t.state().state in (State.COMPLETE, State.CANCELED):
                break
            time.sleep(0.2)
        assert t.outcome() == Outcome.SUCCESS, t.error
        assert t.result["outcomes"]["all"]["ok"] == 8
        assert not dist.is_initialized()  # the engine never joined
        # `tg stats` renders the cohort's journal as the reference renders
        # it: two devices, two processes
        from testground_tpu.runners.pretty import render_telemetry_summary as jrender
        from testground_tpu_torch.runners.pretty import render_telemetry_summary

        stats = {"plan": "network", "case": "ping-pong", "task_id": tid,
                 "outcome": "success", **{k: t.result["journal"].get(k)
                                          for k in ("sim", "events")}}
        text = render_telemetry_summary(stats)
        assert text == jrender(stats)
        assert "on 2 device(s) / 2 process(es)" in text
        engine.stop()
        fout, _ = follower.communicate(timeout=60)
        assert follower.returncode == 0, fout[-3000:]
        assert "sim-worker: shutdown" in fout
    finally:
        engine.stop()
        _kill_all([follower])
