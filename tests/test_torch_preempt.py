"""The port's fleet controller (``engine/controller.py``, the engine's
preemption, eviction and drain, the supervisor's requeue) against the
reference's ``tests/test_preempt.py``, on the CPU:

- the eviction policy, case for case against the reference's
  ``pick_eviction_victim``;
- a preempted run requeues with ``resume_from`` at its own snapshots and
  completes, the journal holding ``task.preempt_requested``,
  ``task.preempted`` and ``task.migrated`` in causal order; a double
  preempt is idempotent, a preempt before the claim is not lost;
- drain preempts the running work, parks the workers and is idempotent;
- snapshot loads retry with bounded exponential backoff and fall back
  loudly past a corrupt newest snapshot;
- ``tg_fleet_preemptions_total``/``evictions``, ``tg top``'s PRE column and
  DRAINING banner, the new event types over HTTP;
- the executor's preemption contract: a forced snapshot at the stopping
  boundary, the typed error, and the ordering (an operator cancel wins, a
  fail-severity SLO breach wins);
- bit-equality with real port runs: a preempted, a doubly preempted and an
  evicted run each end equal to the port's uninterrupted run and to the
  reference's (pack-member preemption: ``tests/test_torch_pack_engine.py``);
- the drain waits for a task claimed before its worker registers (F5).
"""

import json
import os
import threading
import time

import numpy as np
import pytest

from testground_tpu_torch.api import (
    Composition,
    Global,
    Group,
    Instances,
    RunGroup,
    RunInput,
    RunOutput,
    TestPlanManifest,
    generate_default_run,
)
from testground_tpu_torch.api.manifest import InstanceConstraints, TestCase
from testground_tpu_torch.api.run_input import BuildOutput, OutputsEnv
from testground_tpu_torch.builders.base import Builder
from testground_tpu_torch.config import EnvConfig
from testground_tpu_torch.engine import Engine, EngineConfig, Outcome, State
from testground_tpu_torch.engine.controller import TaskPreemptedError, pick_eviction_victim
from testground_tpu_torch.rpc import OutputWriter
from testground_tpu_torch.runners.base import Runner
from testground_tpu_torch.runners.result import Result
from testground_tpu_torch.sim import checkpoint as pck
from testground_tpu_torch.sim.executor import SimTorchConfig, execute_sim_run, plan_dir


# ------------------------------------------------------- eviction policy


def _c(cid, priority=0, started=0.0, checkpointed=False):
    return {"id": cid, "priority": priority, "started": started,
            "checkpointed": checkpointed}


EVICTION_CASES = {
    "equal-priority": ([_c("a", 5)], 5),
    "higher-priority": ([_c("a", 7)], 5),
    "none": ([], 5),
    "lower-priority": ([_c("a", 4)], 5),
    "lowest-first": ([_c("a", 3), _c("b", 0), _c("c", 1)], 5),
    "checkpointed-first": ([_c("plain", 0, started=10.0),
                            _c("ckpt", 0, started=5.0, checkpointed=True)], 5),
    "most-recent-first": ([_c("old", 0, started=5.0), _c("new", 0, started=9.0)], 5),
}
EVICTION_WANT = {"equal-priority": None, "higher-priority": None, "none": None,
                 "lower-priority": "a", "lowest-first": "b",
                 "checkpointed-first": "ckpt", "most-recent-first": "new"}


@pytest.mark.parametrize("name", list(EVICTION_CASES))
def test_eviction_policy_matches_jax(name):
    from testground_tpu.engine.controller import pick_eviction_victim as jpick

    cands, prio = EVICTION_CASES[name]
    got, ref = pick_eviction_victim(cands, prio), jpick(cands, prio)
    assert got == ref
    assert (got or {}).get("id") == EVICTION_WANT[name]


def test_preempted_error_reads_as_the_references():
    from testground_tpu.engine.controller import TaskPreemptedError as JError

    for kw in ({"tick": 32, "snapshot_tick": 32, "snapshots": 2, "resumable": True},
               {"tick": 7}):
        assert str(TaskPreemptedError("r1", **kw)) == str(JError("r1", **kw))


# ------------------------------------------------ fake-runner preemption


class FakeBuilder(Builder):
    def id(self):
        return "fake:builder"

    def build(self, inp, ow, cancel):
        return BuildOutput(builder_id="fake:builder", artifact_path="artifact")


class PreemptOnceRunner(Runner):
    """The executor's preemption contract without a sim: the first run
    waits for its RunInput's preempt event, then raises
    TaskPreemptedError; later runs succeed at once."""

    def __init__(self, resumable=True, wait_secs=10.0):
        self.jobs = []
        self.resumable = resumable
        self.wait_secs = wait_secs

    def id(self):
        return "fake:runner"

    def compatible_builders(self):
        return ["fake:builder"]

    def run(self, job, ow, cancel):
        self.jobs.append(job)
        if len(self.jobs) == 1:
            ev = job.preempt
            assert ev is not None, "solo RunInput carries no preempt event"
            if not ev.wait(timeout=self.wait_secs):
                raise RuntimeError("preempt event never fired")
            raise TaskPreemptedError(job.run_id, tick=32, snapshot_tick=32, snapshots=2,
                                     resumable=self.resumable)
        r = Result.for_input(job)
        for g in job.groups:
            r.outcomes[g.id].ok = g.instances
        r.update_outcome()
        return RunOutput(run_id=job.run_id, result=r)


def make_engine(runner=None, workers=None):
    env = EnvConfig.load()
    if workers is not None:
        env.daemon.scheduler.workers = workers
    return Engine(EngineConfig(env=env, builders=[FakeBuilder()],
                               runners=[runner or PreemptOnceRunner()]))


def simple_comp():
    return generate_default_run(Composition(
        global_=Global(plan="testplan", case="ok", builder="fake:builder",
                       runner="fake:runner"),
        groups=[Group(id="all", instances=Instances(count=2))]))


def simple_manifest():
    return TestPlanManifest(
        name="testplan", builders={"fake:builder": {}}, runners={"fake:runner": {}},
        testcases=[TestCase(name="ok", instances=InstanceConstraints(minimum=1,
                                                                     maximum=100))])


def _wait_state(engine, tid, state, timeout=10.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        t = engine.get_task(tid)
        if t is not None and t.state().state == state:
            return t
        time.sleep(0.01)
    raise TimeoutError(f"task {tid} never reached {state}")


def _wait_done(engine, tid, timeout=60.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        t = engine.get_task(tid)
        if t.state().state in (State.COMPLETE, State.CANCELED):
            return t
        time.sleep(0.02)
    raise TimeoutError(f"task {tid} not done in {timeout}s")


def _journal_rows(engine, tid=None):
    with open(engine.events.path) as f:
        rows = [json.loads(line) for line in f]
    return rows if tid is None else [r for r in rows if r.get("task") == tid]


def test_preempt_requeues_resumes_and_journals(tg_home):
    runner = PreemptOnceRunner(resumable=True)
    engine = make_engine(runner)
    engine.start_workers()
    try:
        tid = engine.queue_run(simple_comp(), simple_manifest())
        _wait_state(engine, tid, State.PROCESSING)
        assert engine.preempt(tid) == {"ok": True, "queued": False}
        assert engine.preempt(tid)["ok"] is True  # idempotent
        t = _wait_done(engine, tid)
        assert t.outcome() == Outcome.SUCCESS, t.error
        assert int(t.trace["preemptions"]) == 1
        assert t.composition["global"]["run_config"]["resume_from"] == tid
        types = [r["type"] for r in _journal_rows(engine, tid)]
        assert types.count("task.preempt_requested") == 1
        order = ["task.scheduled", "task.claimed", "task.preempt_requested",
                 "task.preempted", "task.migrated", "task.finished"]
        idx = [types.index(x) for x in order]
        assert idx == sorted(idx), types
        assert types.count("task.claimed") == 2
        last_claim = len(types) - 1 - types[::-1].index("task.claimed")
        assert types.index("task.migrated") < last_claim < types.index("task.finished")
        rows = _journal_rows(engine, tid)
        assert next(r for r in rows if r["type"] == "task.migrated")["resume_from"] == tid
        pre = next(r for r in rows if r["type"] == "task.preempted")
        assert pre["resumable"] is True and pre["preemptions"] == 1
        assert engine.fleet_info()["preemptions"] == 1
        assert len(runner.jobs) == 2
    finally:
        engine.stop()


def test_non_resumable_reruns_without_rewriting_composition(tg_home):
    engine = make_engine(PreemptOnceRunner(resumable=False))
    engine.start_workers()
    try:
        comp = simple_comp()
        comp.global_.run_config["resume_from"] = "user-chose-this"
        tid = engine.queue_run(comp, simple_manifest())
        _wait_state(engine, tid, State.PROCESSING)
        engine.preempt(tid)
        t = _wait_done(engine, tid)
        assert t.outcome() == Outcome.SUCCESS, t.error
        assert t.composition["global"]["run_config"]["resume_from"] == "user-chose-this"
        mig = next(r for r in _journal_rows(engine, tid) if r["type"] == "task.migrated")
        assert mig["resume_from"] == ""
    finally:
        engine.stop()


def test_preempt_before_claim_is_not_lost(tg_home):
    engine = make_engine(PreemptOnceRunner(resumable=True, wait_secs=0.5))
    try:
        tid = engine.queue_run(simple_comp(), simple_manifest())
        engine.register_preempt(tid).set()
        engine.start_workers()
        t = _wait_done(engine, tid)
        assert t.outcome() == Outcome.SUCCESS, t.error
        assert int(t.trace["preemptions"]) == 1
    finally:
        engine.stop()


def test_preempt_refusals(tg_home):
    engine = make_engine()
    try:
        tid = engine.queue_run(simple_comp(), simple_manifest())
        assert engine.preempt(tid) == {"ok": True, "queued": True}
        assert engine.get_task(tid).state().state == State.SCHEDULED
        assert engine.preempt("nope") == {"ok": False, "error": "unknown task nope"}
        engine.kill(tid)
        res = engine.preempt(tid)
        assert res["ok"] is False and "only running" in res["error"]
    finally:
        engine.stop()


def test_drain_preempts_running_and_parks(tg_home):
    engine = make_engine(PreemptOnceRunner(resumable=True))
    engine.start_workers()
    try:
        tid = engine.queue_run(simple_comp(), simple_manifest())
        _wait_state(engine, tid, State.PROCESSING)
        res = engine.drain(timeout_secs=10.0)
        assert res["drained"] is True and res["preempted"] == [tid]
        t = engine.get_task(tid)
        assert t.state().state == State.SCHEDULED and int(t.trace["preemptions"]) == 1
        time.sleep(0.3)
        assert engine.get_task(tid).state().state == State.SCHEDULED  # not reclaimed
        assert engine.draining() and engine.fleet_info()["draining"]
        assert engine.fleet_payload()["draining"]
        assert "daemon.drain" in [r["type"] for r in _journal_rows(engine)]
    finally:
        engine.stop()


def test_drain_waits_for_a_task_claimed_before_its_worker_registers(tg_home,
                                                                     monkeypatch):
    """The window between a worker's pop (the task is PROCESSING) and its
    entry in the worker map, held open: the drain must not report drained
    while the claimed run has yet to start, and it preempts that run."""
    from testground_tpu_torch.engine import supervisor

    held, release = threading.Event(), threading.Event()
    real = supervisor._note_claim

    def held_claim(engine, idx, pack):
        held.set()
        release.wait(10.0)
        real(engine, idx, pack)

    monkeypatch.setattr(supervisor, "_note_claim", held_claim)
    engine = make_engine(PreemptOnceRunner(resumable=False))
    engine.start_workers()
    try:
        tid = engine.queue_run(simple_comp(), simple_manifest())
        assert held.wait(10.0)
        assert engine.get_task(tid).state().state == State.PROCESSING
        out = {}
        th = threading.Thread(target=lambda: out.update(engine.drain(timeout_secs=10.0)))
        th.start()
        time.sleep(0.5)
        assert not out, "drain reported before the claimed task was parked"
        assert engine.get_task(tid).state().state == State.PROCESSING
        release.set()
        th.join(15.0)
        assert out["drained"] is True and out["preempted"] == [tid]
        t = engine.get_task(tid)
        assert t.state().state == State.SCHEDULED and int(t.trace["preemptions"]) == 1
    finally:
        release.set()
        engine.stop()


def test_preempt_between_pop_and_claim_journals_after_the_claim(tg_home,
                                                                monkeypatch):
    """A preemption landing between a worker's pop (the task is already
    PROCESSING) and its journaled claim, held open: ``task.claimed`` still
    comes before ``task.preempt_requested``, the run is preempted once,
    requeues and succeeds."""
    from testground_tpu_torch.engine import supervisor

    held, release = threading.Event(), threading.Event()
    real = supervisor._note_claim
    first = []

    def held_claim(engine, idx, pack):
        if not first:
            first.append(True)
            held.set()
            release.wait(10.0)
        real(engine, idx, pack)

    monkeypatch.setattr(supervisor, "_note_claim", held_claim)
    engine = make_engine(PreemptOnceRunner(resumable=True))
    engine.start_workers()
    try:
        tid = engine.queue_run(simple_comp(), simple_manifest())
        assert held.wait(10.0)
        assert engine.get_task(tid).state().state == State.PROCESSING
        out = {}
        th = threading.Thread(target=lambda: out.update(engine.preempt(tid)))
        th.start()
        time.sleep(0.3)
        release.set()
        th.join(15.0)
        assert out == {"ok": True, "queued": False}
        t = _wait_done(engine, tid)
        assert t.outcome() == Outcome.SUCCESS, t.error
        assert int(t.trace["preemptions"]) == 1
        types = [r["type"] for r in _journal_rows(engine, tid)]
        assert types.count("task.preempt_requested") == 1
        order = ["task.scheduled", "task.claimed", "task.preempt_requested",
                 "task.preempted", "task.migrated", "task.finished"]
        idx = [types.index(x) for x in order]
        assert idx == sorted(idx), types
    finally:
        release.set()
        engine.stop()


def test_drain_idle_is_immediate_and_idempotent(tg_home):
    engine = make_engine()
    try:
        assert engine.drain(timeout_secs=1.0) == {"drained": True, "preempted": [],
                                                  "canceled": []}
        assert engine.drain(timeout_secs=1.0)["drained"] is True
        drains = [r for r in _journal_rows(engine) if r["type"] == "daemon.drain"]
        assert [d["already_draining"] for d in drains] == [False, True]
    finally:
        engine.stop()


# ------------------------------------------------------ resume hardening


def _mk_snapshot(run_dir, tick):
    return pck.save_snapshot(run_dir, {"tick": tick, "marker": f"snap-{tick}",
                                       "version": pck.FORMAT_VERSION,
                                       "leaves": [{"i": 0}]},
                             [np.arange(4) + tick])[0]


def _truncate(path):
    with open(path, "r+b") as f:
        f.truncate(os.path.getsize(path) // 3)


def test_retry_backoff_is_bounded_exponential(tmp_path, monkeypatch):
    path = _mk_snapshot(str(tmp_path), 16)
    _truncate(path)
    delays = []
    monkeypatch.setattr(pck.time, "sleep", delays.append)
    monkeypatch.setattr(pck, "_RETRY_JITTER_SECS", 0.0)
    with pytest.raises(pck.CheckpointError):
        pck._load_snapshot_retrying(path)
    assert delays == [pck._RETRY_BASE_SECS * 2**i for i in range(pck._RETRY_ATTEMPTS - 1)]


def test_corrupt_newest_falls_back_loudly(tmp_path, monkeypatch):
    monkeypatch.setattr(pck, "_RETRY_BASE_SECS", 0.001)
    monkeypatch.setattr(pck, "_RETRY_JITTER_SECS", 0.0)
    _mk_snapshot(str(tmp_path), 16)
    newest = _mk_snapshot(str(tmp_path), 32)
    _truncate(newest)
    manifest, leaves, _ = pck.load_latest(str(tmp_path))
    assert manifest["marker"] == "snap-16" and np.array_equal(leaves[0], np.arange(4) + 16)
    assert manifest["_fallback"]["skipped"] == [os.path.basename(newest)]
    assert manifest["_fallback"]["error"]


def test_all_corrupt_refuses_loudly(tmp_path, monkeypatch):
    monkeypatch.setattr(pck, "_RETRY_BASE_SECS", 0.001)
    monkeypatch.setattr(pck, "_RETRY_JITTER_SECS", 0.0)
    for tick in (16, 32):
        _truncate(_mk_snapshot(str(tmp_path), tick))
    with pytest.raises(pck.CheckpointError, match="refusing to resume"):
        pck.load_latest(str(tmp_path))


# --------------------------------------------------------- observability


def test_preempt_counters_render_prometheus(tg_home):
    from testground_tpu_torch.metrics.prometheus import render_prometheus

    engine = make_engine()
    try:
        engine.fleet_note_preemption()
        engine.fleet_note_preemption()
        with engine._fleet_lock:
            engine._fleet_evictions += 1
        text = render_prometheus([], fleet=engine.fleet_info())
        assert "tg_fleet_preemptions_total 2" in text
        assert "tg_fleet_evictions_total 1" in text
    finally:
        engine.stop()


def test_render_fleet_pre_column_and_draining_banner(tg_home):
    from testground_tpu_torch.runners.pretty import render_fleet

    engine = make_engine()
    try:
        engine.queue_run(simple_comp(), simple_manifest())
        out = render_fleet(engine.fleet_payload())
        assert "PRE" in out and "DRAINING" not in out
        engine._draining.set()
        assert "DRAINING" in render_fleet(engine.fleet_payload())
        solo = render_fleet({"tasks": [{"id": "t", "state": "processing",
                                        "preemptions": 3}]})
        assert "PRE" in solo and "3" in solo
    finally:
        engine.stop()


def test_events_carry_new_types_over_http(tg_home):
    from testground_tpu_torch.client import Client
    from testground_tpu_torch.daemon import Daemon

    d = Daemon(env=EnvConfig.load(), listen="127.0.0.1:0")
    d.start()
    try:
        d.engine.events.emit("task.preempted", task="x" * 20)
        d.engine.events.emit("task.evicted", task="x" * 20)
        types = [r["type"] for r in Client(d.address).events()]
        assert "task.preempted" in types and "task.evicted" in types
        assert Client(d.address).preempt("nope") == {"ok": False,
                                                     "error": "unknown task nope"}
    finally:
        d.stop()


# ------------------------------------------------ the executor's contract


SUSTAINED = {"duration_ticks": "160"}


def _sustained_job(env, run_id, preempt=None, **cfg):
    cfg = {"device": "cpu", "chunk": 16, "seed": 5, "max_ticks": 512, "telemetry": True,
           **cfg}
    return RunInput(run_id=run_id, test_plan="network", test_case="pingpong-sustained",
                    total_instances=16,
                    groups=[RunGroup(id="all", instances=16, artifact_path=plan_dir("network"),
                                     parameters=dict(SUSTAINED))],
                    runner_config=SimTorchConfig(**cfg), env=env, preempt=preempt)


def _preempt_at_read(k):
    """A preempt event that sets itself at its ``k``-th read: the run reads
    it twice at a chunk boundary (the forced-snapshot observer, then the
    loop's cancel check), so k = 3 sets it at the second boundary, between
    the two reads there, as another thread would."""
    ev = threading.Event()
    n = [0]

    class Hook:
        def is_set(self):
            n[0] += 1
            if n[0] >= k:
                ev.set()
            return ev.is_set()

    return ev, Hook()


def test_executor_snapshots_at_the_stopping_boundary(tmp_path):
    """A preempted run stops at the boundary where the signal was seen,
    after a forced snapshot there (no periodic one falls on it), and
    raises the typed error; its requeued resume ends equal to an
    uninterrupted run."""
    env = OutputsEnv(tmp_path)
    full = execute_sim_run(_sustained_job(env, "full"), OutputWriter(sink=None),
                           threading.Event())
    ev, hook = _preempt_at_read(3)
    job = _sustained_job(env, "mig", preempt=hook, checkpoint_chunks=4)
    with pytest.raises(TaskPreemptedError) as e:
        execute_sim_run(job, OutputWriter(sink=None), threading.Event())
    assert e.value.resumable and e.value.tick == e.value.snapshot_tick == 32
    assert e.value.snapshots == 1
    assert [t for t, _ in pck.list_snapshots(str(tmp_path / "network" / "mig"))] == [32]
    with open(tmp_path / "network" / "mig" / "run_spans.jsonl") as f:
        ends = [json.loads(ln)["event"] for ln in f]
    assert [x["outcome"] for x in ends if x["type"] == "span_end"
            and x["span"] == "run"] == ["preempted"]
    res = execute_sim_run(_sustained_job(env, "mig", checkpoint_chunks=4, resume_from="mig"),
                          OutputWriter(sink=None), threading.Event())
    for key in ("ticks", "msgs_delivered", "msgs_sent", "msgs_in_flight"):
        assert res.result.journal["sim"][key] == full.result.journal["sim"][key], key
    assert res.result.journal["telemetry"] == full.result.journal["telemetry"]


def test_operator_cancel_wins_over_preemption(tmp_path):
    env = OutputsEnv(tmp_path)
    cancel = threading.Event()
    ev, hook = _preempt_at_read(2)

    class Both:
        def is_set(self):
            if hook.is_set():
                cancel.set()
            return ev.is_set()

    out = execute_sim_run(_sustained_job(env, "k", preempt=Both(), checkpoint_chunks=1),
                          OutputWriter(sink=None), cancel)
    assert out.result.outcome == Outcome.CANCELED


def test_fail_slo_wins_over_preemption(tmp_path):
    from testground_tpu_torch.sim.slo import SloBreachError

    env = OutputsEnv(tmp_path)
    ev = threading.Event()
    ev.set()
    job = _sustained_job(env, "s", preempt=ev, checkpoint_chunks=1)
    job.slo = [{"name": "never", "metric": "delivered_per_tick", "op": ">=",
                "threshold": 1e9, "severity": "fail"}]
    with pytest.raises(SloBreachError):
        execute_sim_run(job, OutputWriter(sink=None), threading.Event())


# ----------------------------------------------- bit-equality (real runs)


_COMPARE_KEYS = ("ticks", "msgs_delivered", "msgs_sent", "msgs_enqueued",
                 "msgs_dropped", "msgs_in_flight")


def _queue_sustained(engine, priority=0, **extra):
    cfg = {"chunk": 16, "seed": 5, "max_ticks": 512, "telemetry": True,
           "checkpoint_chunks": 1, "checkpoint_keep": 3, "debug_chunk_sleep_ms": 15,
           **extra}
    comp = generate_default_run(Composition(
        global_=Global(plan="network", case="pingpong-sustained", builder="sim:plan",
                       runner="sim:torch", run_config=cfg),
        groups=[Group(id="all", instances=Instances(count=16))]))
    comp.runs[0].groups[0].test_params.update(SUSTAINED)
    manifest = TestPlanManifest.load_file(os.path.join(plan_dir("network"),
                                                       "manifest.toml"))
    return engine.queue_run(comp, manifest, sources_dir=plan_dir("network"),
                            priority=priority)


def _stream_rows(engine, tid):
    path = os.path.join(engine.env.dirs.outputs(), "network", tid, "sim_timeseries.jsonl")
    with open(path) as f:
        return [{k: v for k, v in json.loads(ln).items() if k != "run"} for ln in f]


@pytest.fixture(scope="module")
def fleet_runs(tmp_path_factory):
    """One single-worker engine on the CPU: the uninterrupted run, a
    preempted one, one preempted twice and an evicted one."""
    home = tmp_path_factory.mktemp("fleet")
    (home / ".env.toml").write_text('[runners."sim:torch"]\ndevice = "cpu"\n')
    from testground_tpu_torch.builders import SimPlanBuilder
    from testground_tpu_torch.sim.runner import SimTorchRunner

    env = EnvConfig.load(home=str(home))
    env.daemon.scheduler.workers = 1
    engine = Engine(EngineConfig(env=env, builders=[SimPlanBuilder()],
                                 runners=[SimTorchRunner()]))
    engine.start_workers()
    try:
        out = {"engine": engine}
        out["base"] = _wait_done(engine, _queue_sustained(engine))

        mig = _queue_sustained(engine)
        _wait_state(engine, mig, State.PROCESSING, timeout=30)
        assert engine.preempt(mig)["ok"]
        out["migrated"] = _wait_done(engine, mig)

        soak = _queue_sustained(engine)
        _wait_state(engine, soak, State.PROCESSING, timeout=30)
        assert engine.preempt(soak)["ok"]
        deadline, second = time.time() + 30, False
        while time.time() < deadline:
            t = engine.get_task(soak)
            if t.state().state == State.COMPLETE:
                break
            if t.state().state == State.PROCESSING and int(t.trace.get("preemptions", 0)) == 1:
                second = engine.preempt(soak).get("ok", False)
                if second:
                    break
            time.sleep(0.01)
        out["soak_second"] = second
        out["soak"] = _wait_done(engine, soak)

        victim = _queue_sustained(engine)
        _wait_state(engine, victim, State.PROCESSING, timeout=30)
        deadline = time.time() + 30
        while time.time() < deadline:
            w = engine.fleet_info()["workers"]
            if w["busy"] >= w["total"]:
                break
            time.sleep(0.01)
        hi = _queue_sustained(engine, priority=5, checkpoint_chunks=0,
                              debug_chunk_sleep_ms=0)
        out["hi"] = _wait_done(engine, hi)
        out["victim"] = _wait_done(engine, victim)
        yield out
    finally:
        engine.stop()


def _assert_sim_equal(engine, base, other):
    jb, jo = base.result["journal"]["sim"], other.result["journal"]["sim"]
    for key in _COMPARE_KEYS:
        assert jo.get(key) == jb.get(key), (key, jo.get(key), jb.get(key))
    assert _stream_rows(engine, other.id) == _stream_rows(engine, base.id)


def test_baseline_succeeds(fleet_runs):
    base = fleet_runs["base"]
    assert base.outcome() == Outcome.SUCCESS, base.error
    assert int(base.trace.get("preemptions", 0)) == 0


def test_baseline_equals_the_references_run(fleet_runs, tmp_path):
    """The port's uninterrupted run is the reference's, so each resumed run
    held against it below is held against the reference's too."""
    from testground_tpu.api import RunGroup as JRunGroup
    from testground_tpu.api import RunInput as JRunInput
    from testground_tpu.config import EnvConfig as JEnvConfig
    from testground_tpu.rpc import OutputWriter as JOutputWriter
    from testground_tpu.sim.executor import SimJaxConfig
    from testground_tpu.sim.executor import execute_sim_run as jexec

    import __graft_entry__ as ge

    jenv = JEnvConfig.load(home=str(tmp_path))
    out = jexec(JRunInput(
        run_id="ref", test_plan="network", test_case="pingpong-sustained",
        total_instances=16,
        groups=[JRunGroup(id="all", instances=16, parameters=dict(SUSTAINED),
                          artifact_path=os.path.join(os.path.dirname(ge.__file__),
                                                     "plans", "network"))],
        runner_config=SimJaxConfig(chunk=16, seed=5, max_ticks=512, telemetry=True,
                                   shard=False),
        env=jenv), JOutputWriter(sink=None), threading.Event())
    jb = fleet_runs["base"].result["journal"]["sim"]
    for key in _COMPARE_KEYS:
        assert out.result.journal["sim"][key] == jb[key], key
    with open(os.path.join(jenv.dirs.outputs(), "network", "ref",
                           "sim_timeseries.jsonl")) as f:
        ref_rows = [{k: v for k, v in json.loads(ln).items() if k != "run"} for ln in f]
    assert ref_rows == _stream_rows(fleet_runs["engine"], fleet_runs["base"].id)


def test_migrated_run_is_bit_equal(fleet_runs):
    engine, mig = fleet_runs["engine"], fleet_runs["migrated"]
    assert mig.outcome() == Outcome.SUCCESS, mig.error
    assert int(mig.trace["preemptions"]) == 1
    resumed = mig.result["journal"]["sim"]["checkpoint"]["resumed"]
    assert resumed["from_run"] == mig.id and resumed["from_tick"] > 0
    _assert_sim_equal(engine, fleet_runs["base"], mig)
    types = [r["type"] for r in _journal_rows(engine, mig.id)]
    assert "task.preempted" in types and "task.migrated" in types


def test_double_preempt_soak_is_bit_equal(fleet_runs):
    engine, soak = fleet_runs["engine"], fleet_runs["soak"]
    assert soak.outcome() == Outcome.SUCCESS, soak.error
    assert int(soak.trace["preemptions"]) == (2 if fleet_runs["soak_second"] else 1)
    _assert_sim_equal(engine, fleet_runs["base"], soak)


def test_eviction_victim_resumes_bit_equal(fleet_runs):
    engine, hi, victim = fleet_runs["engine"], fleet_runs["hi"], fleet_runs["victim"]
    assert hi.outcome() == Outcome.SUCCESS, hi.error
    assert victim.outcome() == Outcome.SUCCESS, victim.error
    assert int(victim.trace["preemptions"]) >= 1
    _assert_sim_equal(engine, fleet_runs["base"], victim)
    ev = next(r for r in _journal_rows(engine, victim.id) if r["type"] == "task.evicted")
    assert ev["by"] == hi.id and ev["victim_priority"] == 0
    assert engine.fleet_info()["evictions"] == 1
