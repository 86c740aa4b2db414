"""The port's task store and its neighbours against the JAX package's, on
the CPU: the ``Task`` model and its JSON round trip (of a real run's result
too), the sqlite ``TaskStorage``, the priority ``TaskQueue`` with its
branch dedup and rehydration, the daemon's ``EventJournal`` and its tail,
``tracectx``, the lifecycle span tree (``engine/tracetree.py``), the
Slack and GitHub status posts (``engine/notify.py``, against a local
capture server) and the rpc ``Chunk`` codec. Each scenario runs the same
operations through both packages' modules and compares what they leave.
Mirrors the reference's ``tests/test_engine.py`` and ``test_notify.py``.
"""

import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from testground_tpu import tracectx as jtracectx
from testground_tpu.config import EnvConfig as JEnvConfig
from testground_tpu.engine import events as jevents
from testground_tpu.engine import notify as jnotify
from testground_tpu.engine import queue as jqueue
from testground_tpu.engine import storage as jstorage
from testground_tpu.engine import task as jtask
from testground_tpu.engine import tracetree as jtracetree
from testground_tpu.rpc import chunk as jchunk
from testground_tpu_torch import tracectx as ptracectx
from testground_tpu_torch.config import EnvConfig as PEnvConfig
from testground_tpu_torch.engine import events as pevents
from testground_tpu_torch.engine import notify as pnotify
from testground_tpu_torch.engine import queue as pqueue
from testground_tpu_torch.engine import storage as pstorage
from testground_tpu_torch.engine import task as ptask
from testground_tpu_torch.engine import tracetree as ptracetree
from testground_tpu_torch.rpc import chunk as pchunk

PKGS = {
    "jax": (jtask, jstorage, jqueue),
    "torch": (ptask, pstorage, pqueue),
}

T0 = 1_700_000_000.0


def _task(mod, tid, created=T0, priority=0, states=("scheduled",), ci=None, **kw):
    """A task of ``mod`` with its states one second apart."""
    return mod.Task(
        id=tid, type=mod.TaskType.RUN, priority=priority, plan="network",
        case="ping-pong", runner="sim:x",
        states=[mod.DatedState(state=mod.State(s), created=created + i)
                for i, s in enumerate(states)],
        created_by=mod.CreatedBy(user="u", repo=ci[0], branch=ci[1], commit="c1")
        if ci else mod.CreatedBy(),
        **kw,
    )


# ------------------------------------------------------------------ task


TASK_CASES = {
    "scheduled": dict(states=("scheduled",)),
    "success": dict(states=("scheduled", "processing", "complete"),
                    result={"outcome": "success", "journal": {"events": {"a": 1}}}),
    "failure-error": dict(states=("scheduled", "processing", "complete"),
                          result={"outcome": "success"}, error="boom"),
    "canceled": dict(states=("scheduled", "processing", "canceled"), error="task canceled"),
    "bad-outcome": dict(states=("scheduled", "processing", "complete"),
                        result={"outcome": "sideways"}),
    "ci-priority": dict(states=("scheduled", "processing"), priority=7,
                        ci=("org/r", "main"), trace={"trace_id": "t" * 32}),
}


@pytest.mark.parametrize("name", list(TASK_CASES))
def test_task_model_matches_jax(name):
    """``to_dict``, the round trip through JSON and ``from_dict``, and the
    derived fields (outcome, took, queued wait, CI identity)."""
    got = {}
    for pkg, (mod, _, _) in PKGS.items():
        t = _task(mod, "tsk" + name, **TASK_CASES[name])
        back = mod.Task.from_dict(json.loads(json.dumps(t.to_dict())))
        assert back == t
        got[pkg] = (t.to_dict(), t.outcome().value, t.took(), t.name(),
                    t.created_by_ci(), t.is_canceled(),
                    round(t.queued_secs(), 3) if len(t.states) > 1 else None)
    assert got["torch"] == got["jax"]


def test_task_ids_lead_with_the_time_as_jax():
    """The ID's first 7 characters are the creation second, as the
    reference's, so IDs of different seconds sort by creation."""
    for _ in range(3):
        p, j = ptask.new_task_id(), jtask.new_task_id()
        if p[:7] == j[:7]:
            break
    assert p[:7] == j[:7] and len(p) == len(j) == 20


# --------------------------------------------------------------- storage


def _store_ops(pkg, path):
    """One lifecycle of four tasks through a store: what it lists after
    each step."""
    mod, smod, _ = PKGS[pkg]
    st = smod.TaskStorage(path)
    tasks = [_task(mod, f"t{i}", created=T0 + 10 * i, states=("scheduled",))
             for i in range(4)]
    for t in tasks:
        st.persist_scheduled(t)
    out = [[t.id for t in st.scheduled()]]
    for t in tasks[:2]:
        t.states.append(mod.DatedState(state=mod.State.PROCESSING, created=T0 + 100))
        st.persist_processing(t)
    t = tasks[0]
    t.states.append(mod.DatedState(state=mod.State.COMPLETE, created=T0 + 200))
    t.result = {"outcome": "success"}
    st.archive(t)

    def ids(ts):
        return [t.id for t in ts]

    out += [ids(st.scheduled()), ids(st.processing()), ids(st.archived()),
            ids(st.filter()), ids(st.filter(states=["complete"])),
            ids(st.filter(states=["scheduled", "processing"])),
            ids(st.filter(types=["build"])), ids(st.filter(before=T0 + 15)),
            ids(st.filter(after=T0 + 15)), ids(st.filter(limit=2)),
            st.get("t0").to_dict(), st.get("nope")]
    out.append(st.delete("t3"))
    out.append(st.delete("t3"))
    # the processing task comes back scheduled, as a restarted daemon sees it
    out.append([t.to_dict() for t in st.recover_processing()])
    out += [ids(st.scheduled()), ids(st.processing())]
    st.close()
    return out


@pytest.mark.parametrize("where", ["memory", "disk"])
def test_storage_lifecycle_matches_jax(where, tmp_path):
    got = {pkg: _store_ops(pkg, ":memory:" if where == "memory" else
                           str(tmp_path / f"{pkg}.db"))
           for pkg in PKGS}
    assert got["torch"] == got["jax"]
    assert got["torch"][3] == ["t0"] and got["torch"][-2] == ["t1", "t2"]


# ----------------------------------------------------------------- queue


def _queue_ops(pkg, tmp_path):
    mod, smod, qmod = PKGS[pkg]
    out = []
    # priority desc, then FIFO by creation
    q = qmod.TaskQueue(smod.TaskStorage(), 100)
    for i, p in enumerate((0, 5, 0, 9, 5)):
        q.push(_task(mod, f"p{i}", created=T0 + i, priority=p))
    out.append([q.pop().id for _ in range(5)])
    try:
        q.pop()
    except qmod.QueueEmptyError as e:
        out.append(type(e).__name__)
    # bounded
    q = qmod.TaskQueue(smod.TaskStorage(), 2)
    q.push(_task(mod, "b0"))
    q.push(_task(mod, "b1"))
    try:
        q.push(_task(mod, "b2"))
    except qmod.QueueFullError as e:
        out.append(str(e))
    out.append(len(q))
    # per-branch dedup: a CI task cancels the queued ones of its branch
    st = smod.TaskStorage()
    q = qmod.TaskQueue(st, 100)
    q.push_unique_by_branch(_task(mod, "c0", created=T0, ci=("org/r", "main")))
    q.push_unique_by_branch(_task(mod, "c1", created=T0 + 1, ci=("org/r", "dev")))
    q.push_unique_by_branch(_task(mod, "c2", created=T0 + 2, ci=("org/r", "main")))
    out.append([t.id for t in st.archived()])
    out.append(st.get("c0").state().state.value)
    out.append([q.pop().id for _ in range(len(q))])
    # cancel a queued task; a second cancel finds nothing
    q.push(_task(mod, "k0"))
    out += [q.cancel_queued("k0"), q.cancel_queued("k0"), len(q),
            st.get("k0").outcome().value]
    # requeue a claimed task past the bound
    q = qmod.TaskQueue(st2 := smod.TaskStorage(), 1)
    q.push(_task(mod, "r0"))
    t = q.pop()
    t.states.append(mod.DatedState(state=mod.State.SCHEDULED, created=T0 + 5))
    q.push(_task(mod, "r1", created=T0 + 1))
    q.requeue(t)
    out += [len(q), [x.id for x in st2.processing()], sorted(x.id for x in st2.scheduled())]
    # rehydration from disk: scheduled and interrupted-processing tasks
    path = str(tmp_path / f"{pkg}-q.db")
    q = qmod.TaskQueue(smod.TaskStorage(path), 100)
    for i in range(3):
        q.push(_task(mod, f"h{i}", created=T0 + i))
    q.pop()  # h0 is processing when the daemon dies
    q2 = qmod.TaskQueue(smod.TaskStorage(path), 100)
    out.append([(t.id, t.state().state.value) for t in
                (q2.pop() for _ in range(len(q2)))])
    return out


def test_queue_matches_jax(tmp_path):
    got = {pkg: _queue_ops(pkg, tmp_path) for pkg in PKGS}
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == ["p3", "p1", "p4", "p0", "p2"]
    assert got["torch"][4] == ["c0"] and got["torch"][6] == ["c1", "c2"]
    assert got["torch"][-1] == [("h0", "processing"), ("h1", "processing"),
                                ("h2", "processing")]


# ---------------------------------------------------------------- events


def _journal_rows(mod, tmp_path, max_bytes):
    path = str(tmp_path / "daemon_events.jsonl")
    j = mod.EventJournal(path, max_bytes=max_bytes)
    tr = {"trace_id": "a" * 32, "root_span_id": "r" * 16, "queued_span_id": "q" * 16}
    j.emit("task.scheduled", task="t1", trace=tr, state="scheduled", priority=2)
    j.emit("task.claimed", task="t1", trace={**tr, "claim_span_id": "c" * 16}, worker=0)
    j.emit("daemon.note", odd=object())  # not JSON: str() of it, never raises
    j2 = mod.EventJournal(path, max_bytes=max_bytes)  # a restart resumes seq
    j2.emit("task.finished", task="t1", outcome="success")
    rows = []
    for p in (path + ".1", path):
        if os.path.exists(p):
            with open(p) as f:
                rows.append([json.loads(ln) for ln in f])
    for part in rows:
        for r in part:
            assert r.pop("ts_wall_ns") > 0 and r.pop("ts_mono_ns") > 0
            if r["type"] == "daemon.note":
                r["odd"] = r["odd"].split(" at ")[0]
    return rows


@pytest.mark.parametrize("max_bytes", [1 << 20, 400])
def test_event_journal_rows_match_jax(max_bytes, tmp_path):
    """The same emits: the same rows (their clocks aside), the same seq
    across a restart, the same rotation into ``.1``."""
    got = {}
    for pkg, mod in (("jax", jevents), ("torch", pevents)):
        got[pkg] = _journal_rows(mod, tmp_path / pkg, max_bytes)
    assert got["torch"] == got["jax"]
    flat = [r for part in got["torch"] for r in part]
    assert [r["seq"] for r in flat] == [1, 2, 3, 4][-len(flat):]
    assert flat[-1]["type"] == "task.finished"
    assert (len(got["torch"]) == 2) == (max_bytes == 400)


def test_journal_tail_reads_whole_lines(tmp_path):
    """The port's copy of the reference's byte-offset tail: complete lines
    only, from an offset, resumable."""
    from testground_tpu.engine.stream import _Tail

    path = tmp_path / "j.jsonl"
    path.write_text('{"a": 1}\nnoise\n{"b": 2}\n{"c": ')
    tails = {"jax": _Tail(str(path)), "torch": pevents.JournalTail(str(path))}
    first = {k: (list(t.read_new()), t.offset) for k, t in tails.items()}
    with open(path, "a") as f:
        f.write('3}\n')
    second = {k: (list(t.read_new()), t.offset) for k, t in tails.items()}
    assert first["torch"] == first["jax"] == ([{"a": 1}, {"b": 2}], 24)
    assert second["torch"] == second["jax"] == ([{"c": 3}], 33)


# -------------------------------------------------------------- tracectx


@pytest.mark.parametrize("header", [
    "00-" + "a" * 32 + "-" + "b" * 16 + "-01",
    "00-" + "A" * 32 + "-" + "B" * 16 + "-00",
    " 00-" + "a" * 32 + "-" + "b" * 16 + "-01 ",
    "00-" + "0" * 32 + "-" + "b" * 16 + "-01",
    "00-" + "a" * 32 + "-" + "0" * 16 + "-01",
    "00-" + "a" * 31 + "-" + "b" * 16 + "-01",
    "garbage", "", None,
])
def test_traceparent_matches_jax(header):
    got = {}
    for pkg, mod in (("jax", jtracectx), ("torch", ptracectx)):
        ctx = mod.TraceContext.from_traceparent(header)
        got[pkg] = (mod.parse_traceparent(header),
                    None if ctx is None else (ctx.trace_id, ctx.span_id,
                                              ctx.to_traceparent()))
        if ctx is not None:
            child = ctx.child()
            assert child.trace_id == ctx.trace_id and child.parent_id == ctx.span_id
    assert got["torch"] == got["jax"]
    minted = ptracectx.TraceContext.mint()
    assert ptracectx.parse_traceparent(minted.to_traceparent()) == (
        minted.trace_id, minted.span_id)


# ------------------------------------------------------------ span tree

SPAN_TASKS = {
    "complete": ("scheduled", "processing", "complete"),
    "queued-only": ("scheduled", "canceled"),
    "requeued": ("scheduled", "processing", "scheduled", "processing", "complete"),
}


@pytest.mark.parametrize("name", list(SPAN_TASKS))
def test_lifecycle_spans_and_export_match_jax(name, tmp_path):
    """``lifecycle_spans`` of the same task, and ``export_task_trace`` over
    a run directory with executor spans (one left open, as a crashed run
    leaves it): the same records and the same Perfetto document."""
    trace = {"trace_id": "1" * 32, "root_span_id": "2" * 16,
             "queued_span_id": "3" * 16, "claim_span_id": "4" * 16,
             "execute_span_id": "5" * 16}
    if name == "requeued":
        trace["prior_attempts"] = [{"claim": "6" * 16, "execute": "7" * 16}]
    if name == "queued-only":
        trace = {k: v for k, v in trace.items() if "claim" not in k and "execute" not in k}
    run_rows = [
        {"ts": 1, "event": {"type": "span_start", "span": "run", "trace_id": "1" * 32,
                            "span_id": "8" * 16, "parent_id": "5" * 16,
                            "wall_ns": int((T0 + 1.5) * 1e9), "plan": "network"}},
        {"ts": 2, "event": {"type": "point", "span": "chunk", "trace_id": "1" * 32,
                            "span_id": "9" * 16, "parent_id": "8" * 16,
                            "wall_ns": int((T0 + 1.7) * 1e9), "ticks": 16}},
        {"ts": 3, "event": {"type": "span_end", "span": "run", "span_id": "8" * 16,
                            "wall_ns": int((T0 + 1.9) * 1e9), "outcome": "success"}},
        {"ts": 4, "event": {"type": "span_start", "span": "lost", "trace_id": "1" * 32,
                            "span_id": "a" * 16, "parent_id": "8" * 16,
                            "wall_ns": int((T0 + 1.8) * 1e9)}},
    ]
    got = {}
    for pkg, mod, tmod in (("jax", jtask, jtracetree), ("torch", ptask, ptracetree)):
        t = _task(mod, "tsk1", states=SPAN_TASKS[name], trace=dict(trace),
                  result={"outcome": "success"})
        root = tmp_path / pkg
        run_dir = root / t.plan / t.id
        run_dir.mkdir(parents=True)
        with open(run_dir / "run_spans.jsonl", "w") as f:
            f.writelines(json.dumps(r) + "\n" for r in run_rows)
        path = tmod.export_task_trace(str(root), t)
        with open(run_dir / tmod.TASK_TRACE_FILE) as f:
            got[pkg] = (tmod.lifecycle_spans(t), tmod.load_task_spans(path), json.load(f),
                        os.path.basename(path))
    assert got["torch"] == got["jax"]
    spans = got["torch"][1]
    ids = {s["span_id"] for s in spans}
    if name != "queued-only":  # never claimed: its run spans have no execute span
        assert all(s["parent_id"] in ids for s in spans if s["parent_id"])
    names = [s["name"] for s in got["torch"][0]]
    assert names[0] == "submit" and names[-1] == "archive"


def test_export_without_trace_ids_writes_nothing(tmp_path):
    t = _task(ptask, "tsk2", states=("scheduled", "processing", "complete"))
    assert ptracetree.lifecycle_spans(t) == []
    assert ptracetree.export_task_trace(str(tmp_path), t) is None
    assert not os.listdir(tmp_path)


# ----------------------------------------------------------------- notify


@pytest.fixture()
def sink():
    """A local HTTP server recording every (path, headers, body) POST."""
    received = []

    class Handler(BaseHTTPRequestHandler):
        def do_POST(self):
            n = int(self.headers.get("Content-Length") or 0)
            received.append((self.path, {k: v for k, v in self.headers.items()
                                         if k in ("Authorization", "Accept",
                                                  "Content-Type")},
                             json.loads(self.rfile.read(n) or b"{}")))
            self.send_response(200)
            self.send_header("Content-Length", "0")
            self.end_headers()

        def log_message(self, *a):
            pass

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}", received
    httpd.shutdown()
    httpd.server_close()


NOTIFY_CASES = {
    "success": ("complete", "success", "", True),
    "failure": ("complete", "success", "boom", True),
    "canceled": ("canceled", "canceled", "killed", True),
    "processing": ("processing", None, "", True),
    "not-ci": ("complete", "success", "", False),
    "unknown": ("complete", None, "", True),
}


@pytest.mark.parametrize("name", list(NOTIFY_CASES))
def test_status_posts_match_jax(name, sink, tmp_path):
    """The Slack and GitHub posts of one task through both packages: the
    same paths, headers and bodies at the capture server."""
    url, received = sink
    final, outcome, error, ci = NOTIFY_CASES[name]
    posts = {}
    for pkg, mod, nmod, env_cls in (("jax", jtask, jnotify, JEnvConfig),
                                    ("torch", ptask, pnotify, PEnvConfig)):
        env = env_cls.load(home=str(tmp_path / pkg))
        env.daemon.slack_webhook_url = url + "/slack"
        env.daemon.github_repo_status_token = "tok"
        env.daemon.root_url = "http://dash:8042/"
        t = _task(mod, "tsk3", states=("scheduled", "processing", final)[
            : 2 if final == "processing" else 3], error=error,
            result={"outcome": outcome} if outcome else {},
            ci=("org/proj", "main") if ci else None)
        if final == "processing":
            t.states = t.states[:2]
        received.clear()
        nmod.post_status_to_slack(env, t)
        nmod.post_status_to_github(env, t, api_base=url + "/gh")
        nmod.notify_task_started(env, t)  # the pending status, without an api_base
        posts[pkg] = list(received)
    assert posts["torch"] == posts["jax"]


def test_unreachable_endpoint_is_swallowed(tmp_path):
    env = PEnvConfig.load(home=str(tmp_path))
    env.daemon.slack_webhook_url = "http://127.0.0.1:9/hook"
    t = _task(ptask, "tsk4", states=("scheduled", "processing", "complete"),
              result={"outcome": "success"})
    pnotify.notify_task_finished(env, t)  # logs, never raises


# ------------------------------------------------------------------ chunk


@pytest.mark.parametrize("chunk", [
    ("p", "line\n", None), ("r", {"task_id": "x", "n": [1, 2]}, None),
    ("e", None, "it broke"), ("b", "AAEC", None),
])
def test_chunk_codec_matches_jax(chunk):
    lines = {}
    for pkg, mod in (("jax", jchunk), ("torch", pchunk)):
        c = mod.Chunk(*chunk)
        line = c.to_json()
        assert mod.Chunk.from_json(line) == c
        lines[pkg] = (line, list(mod.parse_chunks([line + "\n", b"\n", line.encode()])))
    assert lines["torch"][0] == lines["jax"][0]
    assert [vars(c) for c in lines["torch"][1]] == [vars(c) for c in lines["jax"][1]]


# ---------------------------------------------- a real run's stored result


def test_stored_result_of_a_real_run_equals_the_in_memory_one(tmp_path, monkeypatch):
    """The trap of a JSON store: a numpy scalar or a 0-d tensor left in a
    result fails ``json.dumps`` or comes back another type. A telemetry run
    of ``network:ping-pong`` through the port's engine, queue and worker:
    the result the supervisor returned equals the one the store gives
    back, and the JAX package's engine keeps the same keys."""
    from testground_tpu.engine import Engine as JEngine
    from testground_tpu.engine import supervisor as jsup
    from testground_tpu_torch.api import load_composition
    from testground_tpu_torch.engine import Engine
    from testground_tpu_torch.engine import supervisor as psup

    comp_text = """[global]
plan = "network"
case = "ping-pong"
builder = "sim:plan"
runner = "{runner}"
[global.run_config]
chunk = 16
telemetry = true
netmatrix = true
{extra}
[[groups]]
id = "all"
[groups.instances]
count = 8
"""
    results = {}
    for pkg, eng_cls, sup, env_cls, runner, extra in (
            ("torch", Engine, psup, PEnvConfig, "sim:torch", 'device = "cpu"'),
            ("jax", JEngine, jsup, JEnvConfig, "sim:jax", "shard = false\nperf = false")):
        home = tmp_path / pkg
        from test_torch_cli import PORT_PLANS, REF_PLANS
        import shutil

        shutil.copytree(os.path.join(PORT_PLANS if pkg == "torch" else REF_PLANS,
                                     "network"), home / "plans" / "network",
                        ignore=shutil.ignore_patterns("__pycache__"))
        env = env_cls.load(home=str(home))
        env.daemon.scheduler.task_repo_type = "disk"
        returned = []
        plain = sup.do_run

        def recording(*a, _plain=plain, _returned=returned, **kw):
            _returned.append(_plain(*a, **kw))
            return _returned[-1]

        monkeypatch.setattr(sup, "do_run", recording)
        e = eng_cls.new_default(env)
        e.start_workers()
        try:
            if pkg == "torch":
                comp = load_composition_text(load_composition, home, comp_text.format(
                    runner=runner, extra=extra))
                from testground_tpu_torch.cli.commands import _resolve_plan
            else:
                from testground_tpu.api import load_composition as jload
                from testground_tpu.cli.commands import _resolve_plan

                comp = load_composition_text(jload, home, comp_text.format(
                    runner=runner, extra=extra))
            src, manifest = _resolve_plan(env, "network")
            tid = e.queue_run(comp, manifest, sources_dir=src)
            deadline = time.monotonic() + 60
            while e.get_task(tid).state().state.value not in ("complete", "canceled"):
                assert time.monotonic() < deadline, "run did not finish"
                time.sleep(0.05)
            stored = e.get_task(tid)
        finally:
            e.stop()
        assert stored.outcome().value == "success", stored.error
        assert len(returned) == 1
        assert stored.result == returned[0]
        assert json.loads(json.dumps(returned[0])) == returned[0]
        results[pkg] = stored.result
    assert set(results["torch"]) == set(results["jax"])
    assert set(results["torch"]["journal"]) == set(results["jax"]["journal"])
    assert set(results["torch"]["perf"]) == set(results["jax"]["perf"])


def load_composition_text(load, home, text):
    path = home / "comp.toml"
    path.write_text(text)
    return load(str(path))


def test_log_follow_streams_the_lines_written_as_the_task_ends(tmp_path):
    """A task's last log lines can land between the follow's read at the
    end of its log and its read of the task's state (a build's ``group …
    built`` line, written just before the task completes). Forced into
    that window, they are still streamed: the follow reads the log to its
    end once more after the task is done."""
    import types

    from testground_tpu_torch.engine.engine import Engine

    path = tmp_path / "t1.out"
    path.write_text("first\n")

    class Stub:
        def task_log_path(self, task_id):
            return str(path)

        def get_task(self, task_id):
            # the window: the task writes its last line, then completes
            with open(path, "a") as f:
                f.write("group single built: artifact a\n")
            done = types.SimpleNamespace(state=ptask.State.COMPLETE)
            return types.SimpleNamespace(state=lambda: done)

    got = list(Engine.logs(Stub(), "t1", follow=True))
    assert got == ["first\n", "group single built: artifact a\n"]
