"""Run packs through the port's engine (``engine/pack.py``, the queue's
``claim_matching``, the supervisor's pack claim and ``process_task_pack``,
the executor's ``execute_packed_sim_runs``) against the JAX package's, on
the CPU:

- admission: tasks pack together in the port exactly when they do in the
  reference, with the same solo reasons; ``claim_matching`` keeps heap
  order and its limit;
- the same queue through both packages' engines: the members run as one
  pack, each journal's ``sim.pack`` block, ``task.claimed`` /
  ``pack.admitted`` rows, the fleet payload and the ``/metrics`` pack
  families are the reference's; the members share one claim span;
- an SLO-failing member fails alone; a solo ``pack = true`` run journals
  the reference's solo reason;
- a preempted member reruns from scratch equal to its uninterrupted
  sibling; a drain preempts every member of a running pack;
- ``build --buckets`` with ``pack = true`` warms the pack widths, on a
  mesh meshed;
- the same queue with ``mesh = "2x2"`` (virtual on the CPU) runs as one
  meshed pack: each member equals its unmeshed-pack twin, and the
  ``sim.mesh`` block, the ``task.claimed`` / ``pack.admitted`` rows and
  the fleet pack counters are the reference's.
"""

import json
import os
import shutil
import time

import pytest

from testground_tpu.engine import pack as jpack
from testground_tpu_torch.engine import pack as ppack

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PLANS = {"jax": os.path.join(REPO, "plans"),
         "torch": os.path.join(REPO, "testground_tpu_torch", "plans")}
RUNNER = {"jax": "sim:jax", "torch": "sim:torch"}
# what each package's run needs on the CPU: the reference runs unsharded
# (its virtual CPU devices would shard it), the port names the CPU
CPU_CFG = {"jax": {"shard": False}, "torch": {"device": "cpu"}}

PACK_CFG = {
    "pack": True,
    "bucket": "auto",
    "bucket_ladder": "32,64",
    "telemetry": True,
    "max_ticks": 512,
}


def _mods(pkg):
    if pkg == "jax":
        from testground_tpu import api, engine
        from testground_tpu.config import EnvConfig
        from testground_tpu.engine import queue, storage, task
    else:
        from testground_tpu_torch import api, engine
        from testground_tpu_torch.config import EnvConfig
        from testground_tpu_torch.engine import queue, storage, task
    return api, engine, EnvConfig, queue, storage, task


def _run_task(pkg, run_config, n=5, plan="network", case="ping-pong", typ=None):
    """A queued RUN task of each package (the reference test's
    ``_run_task``)."""
    api, _, _, _, _, task = _mods(pkg)
    comp = api.generate_default_run(api.Composition(
        global_=api.Global(plan=plan, case=case, builder="sim:plan", runner=RUNNER[pkg],
                           run_config=dict(run_config)),
        groups=[api.Group(id="all", instances=api.Instances(count=n))],
    ))
    return task.Task(
        id=f"tk-{time.monotonic_ns()}", type=typ or task.TaskType.RUN, plan=plan,
        case=case, runner=RUNNER[pkg], composition=comp.to_dict(),
        input={"manifest": {}, "sources_dir": "/plans/network"},
        states=[task.DatedState(state=task.State.SCHEDULED, created=time.time())],
    )


def _mutate(t, how):
    comp = t.composition
    if how == "run-faults":
        comp["runs"][0]["groups"][0]["faults"] = [{"kind": "crash", "start_ms": 1.0}]
    elif how == "group-faults":
        comp["groups"][0]["run"]["faults"] = [{"kind": "crash", "start_ms": 1.0}]
    elif how == "global-trace":
        comp["global"].setdefault("run", {})["trace"] = {"instances": "0:1"}
    elif how == "backing-params":
        comp["groups"][0]["run"]["test_params"] = {"latency_ms": "9"}
    elif how == "two-runs":
        comp["runs"].append(dict(comp["runs"][0], id="second"))
    elif how == "percent":
        comp["runs"][0]["groups"][0]["instances"] = {"percentage": 0.5}
        comp["groups"][0]["instances"] = {"percentage": 0.5}
    return t


# label: (run config, n, case, mutation)
ADMISSION = {
    "bucketed-5": (dict(PACK_CFG, seed=1), 5, "ping-pong", None),
    "bucketed-29": (dict(PACK_CFG, seed=9), 29, "ping-pong", None),
    "bucketed-40": (dict(PACK_CFG, seed=2), 40, "ping-pong", None),
    "exact-5": ({k: v for k, v in PACK_CFG.items() if k != "bucket"}, 5, "ping-pong", None),
    "exact-6": ({k: v for k, v in PACK_CFG.items() if k != "bucket"}, 6, "ping-pong", None),
    "other-case": (PACK_CFG, 5, "traffic-shaped", None),
    "not-opted": ({"bucket": "auto"}, 5, "ping-pong", None),
    "cohort": (dict(PACK_CFG, coordinator_address="h:1"), 5, "ping-pong", None),
    "resume": (dict(PACK_CFG, resume_from="t1"), 5, "ping-pong", None),
    "checkpoint": (dict(PACK_CFG, checkpoint_chunks=2), 5, "ping-pong", None),
    "profile": (dict(PACK_CFG, profile=True), 5, "ping-pong", None),
    "phases": (dict(PACK_CFG, phases=True), 5, "ping-pong", None),
    "netmatrix": (dict(PACK_CFG, netmatrix=True), 5, "ping-pong", None),
    "hosts": (dict(PACK_CFG, additional_hosts=["echo"]), 5, "ping-pong", None),
    "bad-bucket": (dict(PACK_CFG, bucket="sideways"), 5, "ping-pong", None),
    "run-faults": (PACK_CFG, 5, "ping-pong", "run-faults"),
    "group-faults": (PACK_CFG, 5, "ping-pong", "group-faults"),
    "global-trace": (PACK_CFG, 5, "ping-pong", "global-trace"),
    "backing-params": (PACK_CFG, 5, "ping-pong", "backing-params"),
    "two-runs": (PACK_CFG, 5, "ping-pong", "two-runs"),
    "percent": (PACK_CFG, 5, "ping-pong", "percent"),
    "pallas": (dict(PACK_CFG, transport="pallas"), 5, "ping-pong", None),
    "max-ticks": (dict(PACK_CFG, max_ticks=2048), 5, "ping-pong", None),
    "pack-max": (dict(PACK_CFG, pack_max=4), 5, "ping-pong", None),
}


def _admission(pkg):
    mod = jpack if pkg == "jax" else ppack
    out = {}
    for label, (cfg, n, case, how) in ADMISSION.items():
        t = _mutate(_run_task(pkg, cfg, n=n, case=case), how)
        out[label] = (mod.pack_signature(t), mod.pack_solo_reason(t),
                      mod.solo_reason_for_composition(t.composition, {}, t.input))
    return out


def test_tasks_pack_together_exactly_as_in_the_reference():
    """Every pair of tasks shares a signature in the port iff it does in
    the reference, and every solo reason is the reference's, word for
    word."""
    ref, port = _admission("jax"), _admission("torch")
    for label in ADMISSION:
        assert (port[label][0] is None) == (ref[label][0] is None), label
        assert port[label][1:] == ref[label][1:], label
    labels = list(ADMISSION)
    for a in labels:
        for b in labels:
            same_ref = ref[a][0] is not None and ref[a][0] == ref[b][0]
            same_port = port[a][0] is not None and port[a][0] == port[b][0]
            assert same_port == same_ref, (a, b)


def test_the_device_joins_the_signature():
    a = ppack.pack_signature(_run_task("torch", dict(PACK_CFG, device="cpu")))
    b = ppack.pack_signature(_run_task("torch", dict(PACK_CFG, device="cuda:1")))
    assert a is not None and b is not None and a != b
    assert ppack.pack_signature(_run_task("torch", PACK_CFG)) != a
    # a task of another runner never packs
    assert ppack.pack_signature(_run_task("jax", PACK_CFG)) is None


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_claim_matching_pops_in_priority_order(pkg, tg_home):
    _, _, _, queue, storage, task = _mods(pkg)
    mod = jpack if pkg == "jax" else ppack
    q = queue.TaskQueue(storage.TaskStorage(":memory:"), 16)
    lo = _run_task(pkg, {**PACK_CFG, "seed": 1})
    hi = _run_task(pkg, {**PACK_CFG, "seed": 2})
    hi.priority = 5
    other = _run_task(pkg, {**PACK_CFG, "seed": 3}, case="traffic-shaped")
    for t in (lo, hi, other):
        q.push(t)
    sig = mod.pack_signature(lo)
    claimed = q.claim_matching(lambda t: mod.pack_signature(t) == sig, limit=8)
    assert [t.id for t in claimed] == [hi.id, lo.id]
    assert all(t.state().state == task.State.PROCESSING for t in claimed)
    assert len(q) == 1 and q.pop().id == other.id
    q2 = queue.TaskQueue(storage.TaskStorage(":memory:"), 16)
    for i in range(4):
        q2.push(_run_task(pkg, {**PACK_CFG, "seed": i}))
    assert len(q2.claim_matching(lambda t: True, limit=2)) == 2 and len(q2) == 2
    assert q2.claim_matching(lambda t: True, limit=0) == []


# ------------------------------------------------------------ engine e2e


def _engine(pkg, home, workers=1):
    _, engine, EnvConfig, _, _, _ = _mods(pkg)
    os.makedirs(home / "plans", exist_ok=True)
    shutil.copytree(os.path.join(PLANS[pkg], "network"), home / "plans" / "network",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = EnvConfig.load(home=str(home))
    env.daemon.scheduler.workers = workers
    return engine.Engine.new_default(env)


def _queue(pkg, e, n, seed, extra=None, slo=None, case="ping-pong"):
    api = _mods(pkg)[0]
    comp = api.generate_default_run(api.Composition(
        global_=api.Global(plan="network", case=case, builder="sim:plan",
                           runner=RUNNER[pkg],
                           run_config={**PACK_CFG, "seed": seed, "chunk": 16,
                                       **CPU_CFG[pkg], **(extra or {})}),
        groups=[api.Group(id="all", instances=api.Instances(count=n))],
    ))
    if slo is not None:
        comp.global_.run = comp.global_.run or api.RunParams()
        comp.global_.run.slo = slo
    plans = e.env.dirs.plans()
    manifest = api.TestPlanManifest.load_file(
        os.path.join(plans, "network", "manifest.toml"))
    return e.queue_run(comp, manifest, sources_dir=os.path.join(plans, "network"))


def _wait_all(e, tids, budget=180):
    deadline = time.time() + budget
    while time.time() < deadline:
        tasks = [e.get_task(t) for t in tids]
        if all(t.state().state.value in ("complete", "canceled") for t in tasks):
            return tasks
        time.sleep(0.05)
    raise TimeoutError(f"tasks not done in {budget}s")


def _wait_idle(e, budget=60):
    """Until the worker has let go of its pack: both packages archive a
    pack's members before the worker drops the pack from the fleet's
    running packs, so a payload read right after the last archive may
    still show it."""
    deadline = time.time() + budget
    while e.fleet_payload()["pack"]["running"]:
        if time.time() > deadline:
            raise TimeoutError(f"a pack still running after {budget}s")
        time.sleep(0.05)


def _events(e, types=None):
    with open(e.events.path) as f:
        rows = [json.loads(line) for line in f]
    return [r for r in rows if types is None or r["type"] in types]


def _sim(t):
    return ((t.result or {}).get("journal") or {}).get("sim") or {}


SIZES = (5, 9, 13)


@pytest.fixture(scope="module")
def twin_packs(tmp_path_factory):
    """The same queue — three pack-opted ping-pong runs, one worker — through
    both packages' engines, once per module."""
    out = {}
    for pkg in ("jax", "torch"):
        e = _engine(pkg, tmp_path_factory.mktemp(pkg))
        try:
            tids = [_queue(pkg, e, n, i) for i, n in enumerate(SIZES)]
            e.start_workers()
            tasks = _wait_all(e, tids)
            _wait_idle(e)
            fleet = e.fleet_info()
            payload = e.fleet_payload()
            events = _events(e)
        finally:
            e.stop()
        out[pkg] = {"tasks": tasks, "fleet": fleet, "payload": payload,
                    "events": events, "env": e.env}
    return out


def test_queued_runs_execute_as_one_pack(twin_packs):
    for pkg in ("jax", "torch"):
        for i, (tsk, n) in enumerate(zip(twin_packs[pkg]["tasks"], SIZES)):
            assert tsk.outcome().value == "success", (pkg, tsk.error)
            sim = _sim(tsk)
            assert sim["pack"] == {"width": 4, "members": 3, "index": i,
                                   "leader_run": twin_packs[pkg]["tasks"][0].id}
            assert tsk.result["journal"]["events"]["all"]["success"] == n
            assert sim["perf"]["instances"] == n and sim["perf"]["bucket"] == 32
    for jt, pt in zip(twin_packs["jax"]["tasks"], twin_packs["torch"]["tasks"]):
        js, ps = _sim(jt), _sim(pt)
        assert ps["bucket"] == dict(js["bucket"], compile_cache="off")
        for key in ("ticks", "msgs_delivered", "msgs_sent", "msgs_enqueued",
                    "msgs_dropped", "msgs_rejected", "msgs_in_flight", "pub_dropped",
                    "latency"):
            assert ps[key] == js[key], key
        assert pt.result["journal"]["telemetry"] == jt.result["journal"]["telemetry"]


def test_members_share_one_claim_span_and_journal_the_references_rows(twin_packs):
    shapes = {}
    for pkg in ("jax", "torch"):
        tasks = twin_packs[pkg]["tasks"]
        claims = {t.trace["claim_span_id"] for t in tasks}
        assert len(claims) == 1
        assert len({t.trace["execute_span_id"] for t in tasks}) == 3
        assert all(t.trace["pack_leader"] == tasks[0].id and t.trace["pack_width"] == 3
                   for t in tasks)
        rows = [r for r in twin_packs[pkg]["events"]
                if r["type"] in ("task.claimed", "pack.admitted", "task.started")]
        shapes[pkg] = [
            (r["type"], r.get("pack_width"), r.get("width"), len(r.get("members", [])),
             sorted(k for k in r if k not in ("ts", "ts_wall_ns")))
            for r in rows
        ]
        admitted = [r for r in rows if r["type"] == "pack.admitted"]
        assert admitted[0]["members"] == [t.id for t in tasks]
    assert shapes["torch"] == shapes["jax"]


def test_fleet_counters_and_metrics_families_match(twin_packs):
    from testground_tpu.metrics.prometheus import render_prometheus as jrender
    from testground_tpu_torch.metrics.prometheus import render_prometheus as prender

    assert twin_packs["torch"]["fleet"]["pack"] == twin_packs["jax"]["fleet"]["pack"] == {
        "packed": 1, "packed_runs": 3, "solo": {}}
    assert twin_packs["torch"]["payload"]["pack"] == twin_packs["jax"]["payload"]["pack"]

    def families(render, pkg):
        text = render(twin_packs[pkg]["tasks"], fleet=twin_packs[pkg]["fleet"])
        lines = [ln for ln in text.splitlines()
                 if ln.startswith(("tg_pack_", "tg_fleet_pack_", "# HELP tg_pack",
                                   "# TYPE tg_pack", "# HELP tg_fleet_pack",
                                   "# TYPE tg_fleet_pack"))]
        ids = [t.id for t in twin_packs[pkg]["tasks"]]
        for i, tid in enumerate(ids):
            lines = [ln.replace(tid, f"task{i}") for ln in lines]
        return lines

    port, ref = families(prender, "torch"), families(jrender, "jax")
    assert any(ln.startswith("tg_pack_width") for ln in port)
    assert port == ref


def test_fleet_payload_shows_the_running_pack(tmp_path):
    """While a pack runs, ``/fleet`` shows it under ``pack.running`` and
    each member's row carries the pack's width, as the reference's."""
    e = _engine("torch", tmp_path)
    try:
        tids = [_queue("torch", e, n, i, extra={"max_ticks": 100_000,
                                                "debug_chunk_sleep_ms": 50})
                for i, n in enumerate((5, 9))]
        e.start_workers()
        deadline = time.time() + 60
        while time.time() < deadline:
            p = e.fleet_payload()
            if p["pack"]["running"]:
                break
            time.sleep(0.02)
        assert p["pack"]["running"] == {tids[0]: 2}
        for tid in tids:
            e.kill(tid)
        _wait_all(e, tids)
        assert e.fleet_payload()["pack"]["running"] == {}
    finally:
        e.stop()


def test_slo_fail_member_fails_alone(tmp_path):
    e = _engine("torch", tmp_path)
    try:
        bad = _queue("torch", e, 5, 0, slo=[{
            "name": "impossible", "metric": "delivered_per_tick", "op": ">",
            "threshold": 1e9, "severity": "fail"}])
        good = _queue("torch", e, 9, 1)
        e.start_workers()
        tasks = _wait_all(e, [bad, good])
    finally:
        e.stop()
    assert all(_sim(t)["pack"]["members"] == 2 for t in tasks)
    assert tasks[0].outcome().value == "failure"
    assert "impossible" in (tasks[0].error or "")
    assert tasks[1].outcome().value == "success", tasks[1].error
    assert tasks[1].result["journal"]["events"]["all"]["success"] == 9


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_a_solo_pack_run_journals_the_references_reason(pkg, tmp_path):
    e = _engine(pkg, tmp_path)
    try:
        tid = _queue(pkg, e, 5, 0, extra={"profile": True, "bucket": "off"})
        e.start_workers()
        tsk = _wait_all(e, [tid])[0]
        solo = [r for r in _events(e) if r["type"] == "pack.solo"]
        fleet = e.fleet_info()["pack"]
    finally:
        e.stop()
    reason = "profiler capture is a per-run device session"
    assert tsk.outcome().value == "success", tsk.error
    assert _sim(tsk)["pack"] == {"requested": True, "packed": False,
                                 "solo_reason": reason}
    assert [r["solo_reason"] for r in solo] == [reason]
    assert fleet == {"packed": 0, "packed_runs": 0, "solo": {reason: 1}}


# ------------------------------------------------------- member preemption


_COMPARE = ("ticks", "msgs_delivered", "msgs_sent", "msgs_enqueued", "msgs_dropped",
            "msgs_in_flight", "pub_dropped")


def test_preempted_pack_member_reruns_equal(tmp_path):
    """Evicting one member of a running pack stops it at the next chunk
    boundary, never resumable, and requeues it; the rerun from scratch
    lands on its identically configured sibling's totals."""
    _preempt_a_member(tmp_path, {})


def test_preempted_meshed_pack_member_reruns_equal(tmp_path):
    """The same on a ``"2x2"`` mesh: the member stops, reruns from scratch
    alone on the mesh (row 0), and lands on its sibling's totals."""
    _preempt_a_member(tmp_path, {"mesh": "2x2"})


def _preempt_a_member(tmp_path, extra):
    e = _engine("torch", tmp_path)
    cfg = {"debug_chunk_sleep_ms": 20, "max_ticks": 1024, **extra}
    try:
        ids = [_queue("torch", e, 16, 5, extra=cfg, case="pingpong-sustained")
               for _ in range(2)]
        e.start_workers()
        deadline = time.time() + 60
        while not all(e.get_task(t).state().state.value == "processing" for t in ids):
            assert time.time() < deadline
            time.sleep(0.01)
        assert e.preempt(ids[1])["ok"]
        sibling, member = _wait_all(e, ids, budget=240)
        rows = _events(e)
    finally:
        e.stop()
    for t in (sibling, member):
        assert t.outcome().value == "success", (t.id, t.error)
    assert int(member.trace["preemptions"]) == 1
    pre = next(r for r in rows if r["type"] == "task.preempted"
               and r["task"] == member.id)
    assert pre["resumable"] is False
    assert _sim(sibling)["pack"]["members"] == 2
    assert "pack" not in _sim(member) or _sim(member)["pack"]["packed"] is False
    for key in _COMPARE:
        assert _sim(member)[key] == _sim(sibling)[key], key
    assert member.result["journal"]["events"] == sibling.result["journal"]["events"]
    if extra:
        assert _sim(member)["mesh"] == _sim(sibling)["mesh"]
        assert _sim(member)["mesh"]["axes"] == extra["mesh"]


def test_drain_preempts_every_member_of_a_running_pack(tmp_path):
    e = _engine("torch", tmp_path)
    try:
        ids = [_queue("torch", e, n, i, extra={"max_ticks": 100_000,
                                               "debug_chunk_sleep_ms": 20})
               for i, n in enumerate((5, 9, 13))]
        e.start_workers()
        deadline = time.time() + 60
        while not e.fleet_payload()["pack"]["running"]:
            assert time.time() < deadline
            time.sleep(0.01)
        res = e.drain(timeout_secs=60.0)
        tasks = [e.get_task(t) for t in ids]
    finally:
        e.stop()
    assert res["drained"] is True and sorted(res["preempted"]) == sorted(ids)
    for t in tasks:
        assert t.state().state.value == "scheduled", t.id
        assert int(t.trace["preemptions"]) == 1


# ------------------------------------------------------------ the build


def test_build_buckets_warms_the_pack_widths(tmp_path):
    """``build --buckets`` with ``pack = true`` writes a marker row per
    warmed pack width under the reference's keys, at the reference's path
    (``<compile cache>/precompiled/buckets-<plan>-<case>.json``)."""
    from testground_tpu_torch.api import (
        Composition, Global, Group, Instances, TestPlanManifest, generate_default_run,
    )
    from testground_tpu_torch.builders.sim_plan import (
        SimPlanBuilder,
        bucket_marker_path,
    )
    from testground_tpu_torch.config import EnvConfig
    from testground_tpu_torch.rpc import discard_writer
    from testground_tpu_torch.utils.compile_cache import compile_cache_dir

    env = EnvConfig.load(home=str(tmp_path))
    comp = generate_default_run(Composition(
        global_=Global(plan="network", case="ping-pong", builder="sim:plan",
                       runner="sim:torch",
                       run_config={"build_buckets": True, "bucket_ladder": "16,32",
                                   "pack": True, "pack_max": 4, "device": "cpu",
                                   "chunk": 8}),
        groups=[Group(id="all", instances=Instances(count=6))],
    ))
    for g in comp.groups:
        g.run.artifact = os.path.join(PLANS["torch"], "network")
    manifest = TestPlanManifest.load_file(
        os.path.join(PLANS["torch"], "network", "manifest.toml"))
    import threading

    SimPlanBuilder().precompile(comp, manifest, env, discard_writer(), threading.Event())
    cache = compile_cache_dir(env.dirs.home)
    assert bucket_marker_path(cache, "network", "ping-pong") == os.path.join(
        str(tmp_path), "data", "compile-cache", "precompiled",
        "buckets-network-ping-pong.json")
    with open(bucket_marker_path(cache, "network", "ping-pong")) as f:
        rows = json.load(f)["buckets"]
    assert [(r["bucket"], r.get("pack_width")) for r in rows] == [
        (16, None), (16, 2), (16, 4), (32, None), (32, 2)]


def test_build_buckets_warms_the_meshed_pack_widths(tmp_path):
    """``build --buckets`` with ``pack = true`` on ``mesh = "2"``: the
    marker's keys and its bucket rows are the reference's; the port warms
    each pack width meshed, its rows under the reference's pack-row keys
    with the layout (``"mesh"``), where the reference's own pack warm
    refuses its meshed program and writes no pack row."""
    from test_torch_cli import PORT_ENV, REF_ENV, _cli, _make_home, jmain, pmain

    argv = ["build", "single", "network:ping-pong", "--buckets", "--run-cfg",
            "bucket_ladder=32,64", "--run-cfg", "pack=true", "--run-cfg", "mesh=2",
            "--run-cfg", "chunk=8"]
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
    port, ref = got["torch"], got["jax"]
    assert {k: v for k, v in port.items() if k != "buckets"} == {
        k: v for k, v in ref.items() if k != "buckets"}
    assert [sorted(b) for b in ref["buckets"]] == [["bucket", "compile_secs"]] * 2
    assert [sorted(b) for b in port["buckets"] if "pack_width" not in b] == [
        sorted(b) for b in ref["buckets"]]
    assert [(b["bucket"], b.get("pack_width"), b.get("mesh")) for b in port["buckets"]] == [
        (32, None, None), (32, 2, "2"), (32, 4, "2"), (32, 8, "2"),
        (64, None, None), (64, 2, "2"), (64, 4, "2")]


@pytest.fixture(scope="module")
def twin_mesh_packs(tmp_path_factory):
    """The queue of ``twin_packs`` on ``mesh = "2x2"``, through both
    packages' engines, once per module."""
    out = {}
    for pkg in ("jax", "torch"):
        e = _engine(pkg, tmp_path_factory.mktemp(f"{pkg}-mesh"))
        try:
            tids = [_queue(pkg, e, n, i, extra={"mesh": "2x2"})
                    for i, n in enumerate(SIZES)]
            e.start_workers()
            tasks = _wait_all(e, tids, budget=300)
            _wait_idle(e)
            fleet = e.fleet_info()
            events = _events(e)
        finally:
            e.stop()
        out[pkg] = {"tasks": tasks, "fleet": fleet, "events": events}
    return out


def test_queued_runs_execute_as_one_meshed_pack(twin_mesh_packs, twin_packs):
    """Each member of the meshed pack equals its unmeshed-pack twin, and
    journals the reference's ``sim.mesh`` block and device count."""
    for i, (pt, ut, jt) in enumerate(zip(twin_mesh_packs["torch"]["tasks"],
                                         twin_packs["torch"]["tasks"],
                                         twin_mesh_packs["jax"]["tasks"])):
        assert pt.outcome().value == "success", pt.error
        ps, us, js = _sim(pt), _sim(ut), _sim(jt)
        assert ps["pack"] == {"width": 4, "members": 3, "index": i,
                              "leader_run": twin_mesh_packs["torch"]["tasks"][0].id}
        assert ps["mesh"] == js["mesh"] and ps["mesh"]["axes"] == "2x2"
        assert ps["devices"] == js["devices"] == 4
        assert ps["bucket"] == us["bucket"]
        for key in ("ticks", "msgs_delivered", "msgs_sent", "msgs_enqueued",
                    "msgs_dropped", "msgs_rejected", "msgs_in_flight", "pub_dropped",
                    "latency"):
            assert ps[key] == us[key], key
        assert pt.result["journal"]["events"] == ut.result["journal"]["events"]
        assert pt.result["journal"]["telemetry"] == ut.result["journal"]["telemetry"]


def test_meshed_pack_claims_and_fleet_counters_match(twin_mesh_packs):
    shapes = {}
    for pkg in ("jax", "torch"):
        rows = [r for r in twin_mesh_packs[pkg]["events"]
                if r["type"] in ("task.claimed", "pack.admitted", "task.started")]
        shapes[pkg] = [
            (r["type"], r.get("pack_width"), r.get("width"), len(r.get("members", [])),
             sorted(k for k in r if k not in ("ts", "ts_wall_ns")))
            for r in rows
        ]
    assert shapes["torch"] == shapes["jax"]
    assert twin_mesh_packs["torch"]["fleet"]["pack"] == twin_mesh_packs["jax"]["fleet"][
        "pack"] == {"packed": 1, "packed_runs": 3, "solo": {}}


def test_readers_render_a_meshed_pack_member_as_the_reference(twin_mesh_packs):
    """``tg stats`` and ``tg perf`` of a meshed pack member, and the mesh
    and pack families of ``/metrics``, line for line as the reference
    renders its own, numbers aside."""
    from testground_tpu.metrics.prometheus import render_prometheus as jrender
    from testground_tpu.runners import pretty as jpretty
    from testground_tpu_torch.metrics.prometheus import render_prometheus as prender
    from testground_tpu_torch.runners import pretty as ppretty

    views = {}
    for pkg, pretty, render in (("jax", jpretty, jrender), ("torch", ppretty, prender)):
        tasks = twin_mesh_packs[pkg]["tasks"]
        lines = []
        for t in tasks:
            for text in (pretty.render_telemetry_summary(t.stats_payload()),
                         pretty.render_perf_summary(t.perf_payload())):
                lines += [ln for ln in _normalized(text, tasks).splitlines()
                          if "mesh" in ln or "pack" in ln]
        prom = _normalized(render(tasks, fleet=twin_mesh_packs[pkg]["fleet"]), tasks)
        lines += [ln for ln in prom.splitlines()
                  if ln.split(" ")[0].split("{")[0].startswith(
                      ("tg_mesh_", "tg_pack_", "tg_fleet_pack_", "tg_run_devices"))]
        views[pkg] = lines
    # numbers normalized: the 2x2 layout reads "#x#"
    assert any(ln.startswith("mesh") and "#x#" in ln for ln in views["torch"])
    assert any(ln.startswith("tg_mesh_shards") for ln in views["torch"])
    assert views["torch"] == views["jax"]


def _normalized(text, tasks, i0=0):
    """Task ids and wall-clock figures out of a rendered view."""
    import re

    for i, t in enumerate(tasks):
        text = text.replace(t.id, f"task{i0 + i}")
    return re.sub(r"\d+(\.\d+)?", "#", text)


def test_readers_render_a_port_pack_as_the_reference(twin_packs):
    """``tg stats``, ``tg perf`` and ``tg top`` render a port pack member's
    journal (and the pack's fleet payload) line for line as the reference
    renders its own, numbers aside."""
    from testground_tpu.runners import pretty as jpretty
    from testground_tpu_torch.runners import pretty as ppretty

    views = {}
    for pkg, pretty in (("jax", jpretty), ("torch", ppretty)):
        tasks = twin_packs[pkg]["tasks"]
        out = []
        for t in tasks:
            stats = pretty.render_telemetry_summary(t.stats_payload())
            assert "member" in stats and "width-4 pack" in stats, stats
            out.append(_normalized(stats, tasks))
            perf = pretty.render_perf_summary(t.perf_payload())
            assert "3-member pack" in perf, perf
            out.append(_normalized(perf, tasks))
        views[pkg] = out
    assert [ln for v in views["torch"] for ln in v.splitlines()
            if "pack" in ln] == [ln for v in views["jax"] for ln in v.splitlines()
                                 if "pack" in ln]
    jtop = jpretty.render_fleet(twin_packs["jax"]["payload"])
    ptop = ppretty.render_fleet(twin_packs["torch"]["payload"])
    assert _normalized(ptop, twin_packs["torch"]["tasks"]) == _normalized(
        jtop, twin_packs["jax"]["tasks"])


def test_dashboard_viewer_reads_a_pack_member_as_the_reference(twin_packs):
    """The dashboard's ``Viewer`` over a pack member's run directory: the
    port's and the reference's read it alike, and the port's members'
    telemetry series are the reference's members'."""
    from testground_tpu.config import EnvConfig as JEnvConfig
    from testground_tpu.metrics import Viewer as JViewer
    from testground_tpu_torch.config import EnvConfig
    from testground_tpu_torch.metrics import Viewer

    series = {}
    for pkg in ("jax", "torch"):
        home = twin_packs[pkg]["env"].dirs.home
        port = Viewer(EnvConfig.load(home=home))
        ref = JViewer(JEnvConfig.load(home=home))
        series[pkg] = []
        for t in twin_packs[pkg]["tasks"]:
            got = {k: [r.to_dict() for r in v]
                   for k, v in port.get_all_data("network", "ping-pong", t.id).items()}
            want = {k: [r.to_dict() for r in v]
                    for k, v in ref.get_all_data("network", "ping-pong", t.id).items()}
            assert got == want
            # a pack member journals its latency, but writes no
            # sim_latency.jsonl, in both packages
            assert {"sim.delivered", "sim.live"} <= set(got)
            series[pkg].append([{k: v for k, v in r.items() if k != "run"}
                                for r in got["sim.delivered"]])
    assert series["torch"] == series["jax"]
