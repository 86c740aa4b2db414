"""The port's daemon and client against the JAX package's, on the CPU:
both packages' ``Daemon`` (an engine behind a stdlib HTTP server on
``127.0.0.1:0``, ``sim:jax`` with ``shard = false`` against ``sim:torch``
with ``device = "cpu"``, both with the perf ledger on) take the same compositions
from their CLIs with ``--endpoint``, from a client home that holds no
plans. Then the exit codes, the printed lines of ``run``, ``status``,
``logs`` and ``tasks``, the task fields (less IDs and times) and the run
directories, lifecycle span tree included, must be equal. Also: bearer
auth, the path-traversal guards, the observability routes (``/journal``,
``/stats``, ``/perf``, ``/diff``, ``/stream``, ``/trace``, ``/artifact``,
``/fleet``) answering as the reference's, the fleet controller's routes
(``/preempt`` and ``/drain``) answering as the reference's, ``--detach``,
``--collect-file``, ``terminate`` of each component type, ``/kill`` of a
running task, the ``/events`` tail, two workers at once, ``SIGTERM`` of a
daemon process (which drains it), and a run on a fake
``cuda:1`` whose worker thread makes that card current before the first
kernel launch. Mirrors the reference's ``tests/test_daemon.py`` and
``test_cli_e2e.py``. Every wait has a deadline.
"""

import contextlib
import json
import os
import re
import subprocess
import sys
import tarfile
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

from test_torch_cli import (
    PORT_ENV,
    REF_ENV,
    REPO,
    _cli,
    _make_home,
    _norm,
    _run_tree,
    _strip,
    jmain,
    pmain,
)
from testground_tpu.client import Client as JClient
from testground_tpu.config import EnvConfig as JEnvConfig
from testground_tpu.daemon import Daemon as JDaemon
from testground_tpu_torch.client import Client, DaemonError
from testground_tpu_torch.config import EnvConfig
from testground_tpu_torch.daemon import Daemon
from test_torch_perf import perf_view

PKGS = {"jax": (JDaemon, JEnvConfig, JClient, jmain, REF_ENV, "sim:jax"),
        "torch": (Daemon, EnvConfig, Client, pmain, PORT_ENV, "sim:torch")}

PING_PONG = """[metadata]
name = "ping-pong"

[global]
plan = "network"
case = "ping-pong"
builder = "sim:plan"
runner = "{runner}"

[global.run_config]
chunk = 16
telemetry = true

[[groups]]
id = "all"
[groups.instances]
count = 8
[groups.run.test_params]
latency_ms = "4"
latency2_ms = "2"
"""

# long enough to kill mid-run: a sustained window of 100k ticks, each
# chunk of 16 ticks slowed by 20 ms on the host
SLOW = PING_PONG.replace('case = "ping-pong"', 'case = "pingpong-sustained"').replace(
    "telemetry = true", "telemetry = true\nmax_ticks = 100000\ndebug_chunk_sleep_ms = 20"
).replace('latency_ms = "4"', 'duration_ticks = "100000"\nlatency_ms = "4"')


def _wait(predicate, what, timeout=30.0):
    deadline = time.monotonic() + timeout
    while True:
        got = predicate()
        if got:
            return got
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.05)


def _done(client, task_id):
    t = client.status(task_id)
    return t if t["states"][-1]["state"] in ("complete", "canceled") else None


def _start(pkg, home, **env_kw):
    daemon_cls, env_cls = PKGS[pkg][:2]
    env = env_cls.load(home=str(home))
    for k, v in env_kw.items():
        setattr(env.daemon, k, v) if k == "tokens" else setattr(env.daemon.scheduler, k, v)
    d = daemon_cls(env=env, listen="127.0.0.1:0")
    d.start()
    return d


@pytest.fixture(scope="module")
def daemons(tmp_path_factory):
    """One daemon of each package, in homes holding the plans, and a client
    home of each holding none; stopped in teardown."""
    root = tmp_path_factory.mktemp("daemons")
    out = {}
    try:
        for pkg in PKGS:
            home = _make_home(root / "daemon", pkg, PKGS[pkg][4],
                              ("placebo", "network"))
            client_home = _make_home(root / "client", pkg, "", ())
            runner = PKGS[pkg][5]
            (client_home / "ping-pong.toml").write_text(PING_PONG.format(runner=runner))
            (client_home / "slow.toml").write_text(SLOW.format(runner=runner))
            out[pkg] = {"daemon": _start(pkg, home), "home": home,
                        "client_home": client_home, "runner": runner}
            out[pkg]["ep"] = out[pkg]["daemon"].address
            out[pkg]["client"] = PKGS[pkg][2](out[pkg]["ep"])
        yield out
    finally:
        for d in out.values():
            d["daemon"].stop()


def _call(d, pkg, argv):
    """The package's CLI with ``--endpoint`` at its daemon, from the client
    home; ``{runner}`` and ``{home}`` (the client home) filled in."""
    argv = [a.format(runner=d["runner"], home=d["client_home"]) for a in argv]
    return _cli(PKGS[pkg][3], d["client_home"], ["--endpoint", d["ep"], *argv])


def _task_id(out):
    m = re.search(r"run is queued with ID: (\S+)", out)
    assert m, out
    return m[1]


# the lines of `logs` that both packages' executors print alike
LOG_PREFIXES = ("sim:plan built", "group ", "executing run")


def _through_daemon(pkg, d, argv):
    """A run through the daemon and what the verbs then print of it."""
    rc, out, err = _call(d, pkg, argv)
    tid = _task_id(out)
    task = d["client"].status(tid)
    home = d["home"]
    _, status, _ = _call(d, pkg, ["status", "-t", tid])
    _, logs, _ = _call(d, pkg, ["logs", "-t", tid])
    _, tasks, _ = _call(d, pkg, ["tasks", "-n", "1"])
    run_dir = os.path.join(home, "data", "outputs", task["plan"], tid)
    result = task["result"]
    rec = {
        "rc": rc,
        "lines": [ln for ln in out.splitlines() if ln.startswith(("run is", "finished"))],
        "status": [ln for ln in status.splitlines() if not ln.startswith("Queued:")],
        "logs": sorted(ln for ln in logs.splitlines() if ln.startswith(LOG_PREFIXES)),
        # ID, name, state, type, preemptions, outcome (not the clocks)
        "tasks": [ln.split()[:1] + ln.split()[3:4] + ln.split()[6:]
                  for ln in tasks.splitlines()],
        "task": {k: v for k, v in task.items()
                 if k not in ("states", "result", "trace", "input", "composition")},
        "states": [s["state"] for s in task["states"]],
        "trace": sorted(task["trace"]),
        "result": {k: v for k, v in result.items() if k not in ("journal", "perf")},
        "perf": sorted(result["perf"]),
        "sim_perf": perf_view(result["journal"]["sim"]),
        "journal_keys": sorted(result["journal"]),
        "run_dir": _run_tree(run_dir),
    }
    return _norm(rec, tid, home), tid


CASES = {
    "placebo": ["run", "single", "placebo:ok", "-i", "4", "--builder", "sim:plan",
                "--runner", "{runner}"],
    "ping-pong": ["run", "composition", "-f", "{home}/ping-pong.toml"],
}


@pytest.mark.parametrize("name", list(CASES))
def test_run_through_daemon_matches_jax(name, daemons):
    got = {pkg: _through_daemon(pkg, daemons[pkg], CASES[name])[0] for pkg in PKGS}
    port, ref = got["torch"], got["jax"]
    for key in ref:
        if key != "run_dir":
            assert port[key] == ref[key], key
    assert sorted(port["run_dir"]) == sorted(ref["run_dir"])
    for rel in ref["run_dir"]:
        assert port["run_dir"][rel] == ref["run_dir"][rel], rel
    # not vacuous
    assert port["rc"] == 0 and port["states"] == ["scheduled", "processing", "complete"]
    assert {"task_spans.jsonl", "task_trace.json", "run_spans.jsonl"} <= set(port["run_dir"])
    assert "Outcome: success" in port["status"]
    assert port["tasks"][0][0] == "<task>" and port["tasks"][0][-1] == "success"
    assert any(ln.startswith("executing run <task>") for ln in port["logs"])
    assert port["perf"] == ["queued_secs", "runner_wall_secs"]
    assert port["sim_perf"]["series"]["rows"] == port["sim_perf"]["chunks"] > 0
    assert "sim_perf.jsonl" in port["run_dir"]


def test_in_process_run_is_read_from_another_process(tmp_path):
    """An in-process ``run`` keeps its task in the home's disk store:
    ``status``, ``logs`` and ``tasks`` of it work from a fresh process."""
    home = _make_home(tmp_path, "torch", PORT_ENV, ("placebo",))
    rc, out, _ = _cli(pmain, home, CASES["placebo"][:-2] + ["--runner", "sim:torch"])
    assert rc == 0
    tid = _task_id(out)
    env = {**os.environ, "TESTGROUND_HOME": str(home), "PYTHONPATH": REPO}
    script = ("import sys; from testground_tpu_torch.cli.main import main\n"
              "for argv in (['status', '-t', sys.argv[1]], ['logs', '-t', sys.argv[1]],"
              " ['tasks']):\n    assert main(argv) == 0\n")
    proc = subprocess.run([sys.executable, "-c", script, tid], env=env, cwd=str(tmp_path),
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    assert f"ID:      {tid}" in proc.stdout and "Outcome: success" in proc.stdout
    assert f"executing run {tid}" in proc.stdout
    assert re.search(rf"^{tid} .* complete +run +0 +success$", proc.stdout, re.M)


# ------------------------------------------------------ flags and verbs


def test_detach_then_status_until_complete(daemons):
    """``--detach`` returns once the task is queued; the task then completes
    on the daemon and is read back by ``status``."""
    for pkg, d in daemons.items():
        rc, out, err = _call(d, pkg, CASES["placebo"] + ["--detach"])
        assert rc == 0 and "finished run" not in out, pkg
        tid = _task_id(out)
        t = _wait(lambda: _done(d["client"], tid), f"{pkg} detached task")
        assert t["outcome"] == "success", pkg
        _, status, _ = _call(d, pkg, ["status", "-t", tid])
        assert "State:   complete" in status


def test_collect_file_matches_jax(daemons):
    members = {}
    for pkg, d in daemons.items():
        dest = d["client_home"] / "out.tgz"
        rc, out, _ = _call(d, pkg, ["run", "composition", "-f", "{home}/ping-pong.toml",
                                    "--collect-file", str(dest)])
        tid = _task_id(out)
        assert rc == 0 and f"downloaded outputs to {dest}" in out, out
        with tarfile.open(dest) as tar:
            members[pkg] = sorted(n.replace(tid, "<task>") for n in tar.getnames())
        # `collect` of the same run, through the default runner
        # (local:exec) and through the run's own: the same members
        for extra in ([], ["--runner", d["runner"]]):
            again = d["client_home"] / "again.tgz"
            rc, out, err = _call(d, pkg, ["collect", tid, "-o", str(again), *extra])
            assert rc == 0 and "downloaded outputs" in out, err
            with tarfile.open(again) as tar:
                got = sorted(n.replace(tid, "<task>") for n in tar.getnames())
            assert got == members[pkg], extra
    assert members["torch"] == members["jax"]
    assert "<task>/task_spans.jsonl" in members["torch"]


@pytest.mark.parametrize("kind", ["runner", "builder"])
def test_terminate_each_component_type_matches_jax(kind, daemons):
    got = {}
    for pkg, d in daemons.items():
        ref = d["runner"] if kind == "runner" else "sim:plan"
        rc, out, err = _call(d, pkg, ["terminate", f"--{kind}", ref])
        got[pkg] = (rc, out.replace(d["runner"], "<runner>"), err)
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == 0 and "all jobs terminated on component" in got["torch"][1]
    for pkg, d in daemons.items():  # an unknown component is an error
        rc, _, err = _call(d, pkg, ["terminate", f"--{kind}", "nope:x"])
        assert rc == 1 and "unknown component: nope:x" in err


def test_build_and_purge_through_daemon_match_jax(daemons):
    """``build single`` of a daemon-hosted plan (its manifest fetched by
    ``/describe``) and ``build purge`` over ``/build/purge``. The build's
    ``group … built`` log line, the task's last, is the port's always; the
    reference's log follow drops it when it lands between the follow's
    read at the end of the log and its read of the task's state (ROADMAP
    R16), so the lines compared are the CLI's own."""
    got = {}
    for pkg, d in daemons.items():
        rc, out, _ = _call(d, pkg, ["build", "single", "placebo", "--builder", "sim:plan"])
        tid = re.search(r"build is queued with ID: (\S+)", out)[1]
        if pkg == "torch":
            assert re.search(r"^group single built: artifact \S+$", out, re.M), out
        lines = [ln for ln in out.splitlines()
                 if ln.startswith(("build is queued", "finished build", "group "))
                 and " built: " not in ln]
        work = d["home"] / "data" / "work"
        assert any(tid in p.name for p in work.iterdir())
        prc, pout, _ = _call(d, pkg, ["build", "purge", "-b", "sim:plan", "-p", "placebo"])
        assert not any(tid in p.name for p in work.iterdir())
        got[pkg] = _norm({"rc": rc, "lines": lines, "purge": prc,
                          "purged": "purged sim:plan cache for plan placebo" in pout},
                         tid, d["home"])
    assert got["torch"] == got["jax"]
    assert got["torch"]["rc"] == 0 and got["torch"]["purged"]


def test_healthcheck_and_unknown_tasks_match_jax(daemons):
    got = {}
    for pkg, d in daemons.items():
        rc, out, _ = _call(d, pkg, ["healthcheck", "--runner", d["runner"]])
        assert rc == 0 and "outputs-dir-writable" in out, out
        c = d["client"]
        errs = []
        for fn in (lambda: c.status("nope"), lambda: list(c.logs("nope")),
                   lambda: c.delete("nope")):
            try:
                errs.append(("ok", fn()))
            except DaemonError if pkg == "torch" else Exception as e:
                errs.append(("error", str(e)))
        got[pkg] = errs
    assert got["torch"] == got["jax"]


def test_delete_and_describe(daemons):
    for pkg, d in daemons.items():
        c = d["client"]
        _, out, _ = _call(d, pkg, CASES["placebo"])
        tid = _task_id(out)
        assert c.describe_plan("placebo").name == "placebo"
        assert c.delete(tid) is True and c.delete(tid) is False
        assert c.tasks(states=["complete"]) is not None
        assert tid not in [t["id"] for t in c.tasks()]


# ------------------------------------------------------------- guards


def _http(ep, method, route, body=None, token=""):
    req = urllib.request.Request(ep + route, method=method,
                                 data=json.dumps(body).encode() if body is not None else None)
    if token:
        req.add_header("Authorization", f"Bearer {token}")
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


@pytest.mark.parametrize("pkg", list(PKGS))
def test_token_required_when_configured(pkg, tmp_path):
    d = _start(pkg, _make_home(tmp_path, pkg, PKGS[pkg][4], ()), tokens=["sekrit"])
    try:
        client = PKGS[pkg][2]
        with pytest.raises(Exception, match="unauthorized"):
            client(d.address).tasks()
        assert client(d.address, token="sekrit").tasks() == []
        assert _http(d.address, "GET", "/tasks")[0] == 401
        assert _http(d.address, "GET", "/tasks", token="wrong")[0] == 401
    finally:
        d.stop()


TRAVERSALS = {
    "run-plan": ("POST", "/run", {"composition": {
        "global": {"plan": "../../etc", "case": "ok", "builder": "sim:plan",
                   "runner": "{runner}", "total_instances": 1},
        "groups": [{"id": "all", "instances": {"count": 1}}]}}),
    "describe-plan": ("GET", "/describe?plan=..", None),
    "outputs-run-id": ("POST", "/outputs", {"runner": "{runner}", "run_id": "../placebo"}),
    "get-outputs-run-id": ("GET", "/outputs?runner={runner}&run_id=..", None),
}


@pytest.mark.parametrize("name", list(TRAVERSALS))
def test_path_traversal_is_refused_as_jax(name, daemons):
    method, route, body = TRAVERSALS[name]
    got = {}
    for pkg, d in daemons.items():
        b = json.loads(json.dumps(body).replace("{runner}", d["runner"])) if body else None
        code, data = _http(d["ep"], method, route.replace("{runner}", d["runner"]), b)
        got[pkg] = (code, json.loads(data)["error"].replace(d["runner"], "<runner>"))
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == 400 and "invalid" in got["torch"][1]


# the fleet controller's routes (501 until they were ported): each call's
# status and body in both packages' daemons, on an idle daemon
FLEET_ROUTES = {
    "/preempt": [("POST", {"task_id": "nope"}), ("POST", {}), ("GET", None)],
    "/drain": [("POST", {"timeout_secs": 1})],
}


@pytest.mark.parametrize("route", list(FLEET_ROUTES))
def test_fleet_route_answers_as_jax(route, tmp_path):
    got = {}
    for pkg in PKGS:
        d = _start(pkg, _make_home(tmp_path / pkg, pkg, PKGS[pkg][4], ()))
        try:
            got[pkg] = [(code, json.loads(data)) for code, data in
                        (_http(d.address, m, route, b) for m, b in FLEET_ROUTES[route])]
            if route == "/drain":
                # the drained daemon stops itself after it answered
                _wait(lambda: d._stopped, "the drained daemon to stop", timeout=10)
                with open(d.engine.events.path) as f:
                    got[pkg].append([json.loads(ln)["type"] for ln in f])
        finally:
            d.stop()
    assert got["torch"] == got["jax"]
    if route == "/preempt":
        assert got["torch"][0] == (200, {"ok": False, "error": "unknown task nope"})
        assert got["torch"][1][0] == 400 and got["torch"][2][0] == 404
    else:
        assert got["torch"][0] == (200, {"drained": True, "preempted": [], "canceled": []})
        assert "daemon.drain" in got["torch"][1]


# the routes of the observability verbs, each held against the reference's
OBSERVE_ROUTES = ("/journal", "/stats", "/perf", "/diff", "/stream", "/trace",
                  "/artifact", "/fleet")

TRACED = PING_PONG.replace("count = 8", "count = 8\n[groups.run.trace]\ninstances = \"0:2\"")


@pytest.fixture(scope="module")
def observed(daemons):
    """Two runs of one traced composition on each package's daemon."""
    out = {}
    for pkg, d in daemons.items():
        (d["client_home"] / "traced.toml").write_text(TRACED.format(runner=d["runner"]))
        tids = []
        for _ in range(2):
            rc, stdout, _ = _call(d, pkg, ["run", "composition", "-f", "{home}/traced.toml"])
            assert rc == 0, stdout
            tids.append(_task_id(stdout))
        out[pkg] = tids
    return out


def _get_json(d, route):
    code, data = _http(d["ep"], "GET", route)
    return code, json.loads(data) if data.strip().startswith(b"{") else data


def _observe(route, d, a, b):
    """What ``route`` answers about runs ``a`` and ``b``, as both packages
    must agree on it: wall clocks, IDs and the machine's own blocks aside."""
    if route == "/journal":
        code, got = _get_json(d, f"/journal?task_id={a}")
        j = got["journal"]
        return code, sorted(got), sorted(j), j["events"], j["telemetry"]["totals"]
    if route == "/stats":
        code, got = _get_json(d, f"/stats?task_id={a}")
        return (code, sorted(got), got["state"], got["outcome"], got["events"],
                got["telemetry"]["totals"], got["trace"]["events"])
    if route == "/perf":
        code, got = _get_json(d, f"/perf?task_id={a}")
        return (code, sorted(got), got["outcome"], perf_view(got["sim"] | {"perf": got["perf"]}),
                got["phases"], sorted(got["task"]))
    if route == "/diff":
        code, got = _get_json(d, f"/diff?a={a}&b={b}&planes=counters,latency")
        return (code, sorted(got), got["verdict"], got["setup"], got["findings"],
                [(p, got[p]["compared"], got[p]["mismatched"]) for p in ("counters", "latency")],
                _get_json(d, f"/diff?a={a}&b={b}&planes=vibes")[0])
    if route == "/stream":
        code, data = _http(d["ep"], "GET", f"/stream?task_id={a}&follow=0")
        rows = [json.loads(ln) for ln in data.decode().splitlines() if ln.strip()]
        fams = sorted({r["stream"] for r in rows})
        tele = [_strip(r) for r in rows if r["stream"] == "telemetry"]
        return (code, fams, _norm(tele, a, d["home"]),
                _http(d["ep"], "GET", f"/stream?task_id={a}&families=nope")[0])
    if route == "/trace":
        code, got = _get_json(d, f"/trace?task_id={a}&limit=7")
        return (code, sorted(got), _norm(got["events"], a, d["home"]), got.get("truncated"),
                got["trace"]["events"])
    if route == "/artifact":
        code, data = _http(d["ep"], "GET", f"/artifact?task_id={a}&name=sim_trace.jsonl")
        bad = _http(d["ep"], "GET", f"/artifact?task_id={a}&name=../../etc/passwd")[0]
        return code, _norm([json.loads(ln) for ln in data.decode().splitlines()], a,
                           d["home"]), bad
    code, got = _get_json(d, "/fleet")
    return (code, sorted(got), sorted(got["workers"]), sorted(got["queue"]),
            got["draining"], got["pack"], got["tasks"])


@pytest.mark.parametrize("route", OBSERVE_ROUTES)
def test_observability_route_answers_as_jax(route, daemons, observed):
    got = {pkg: _observe(route, d, *observed[pkg]) for pkg, d in daemons.items()}
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == 200
    for pkg, d in daemons.items():  # an unknown task is a 404 on each
        if route not in ("/fleet", "/diff"):
            assert _http(d["ep"], "GET", f"{route}?task_id=nope")[0] == 404, (pkg, route)


def test_fleet_shows_a_running_task_as_jax(daemons):
    """``/fleet`` while a run is on the card: its row carries the keys of
    the reference's, its live ticks/s off the perf ledger's last row."""
    got = {}
    for pkg, d in daemons.items():
        c = d["client"]
        _, out, _ = _call(d, pkg, ["run", "composition", "-f", "{home}/slow.toml",
                                   "--detach"])
        tid = _task_id(out)
        perf = d["home"] / "data" / "outputs" / "network" / tid / "sim_perf.jsonl"
        _wait(lambda: perf.exists() and perf.stat().st_size > 0, "the first perf row")
        fleet = c.fleet()
        assert c.kill(tid) is True
        _wait(lambda: _done(c, tid), "the killed task", timeout=20)
        rows = [r for r in fleet["tasks"] if r["id"] == tid]
        assert len(rows) == 1 and rows[0]["state"] == "processing", fleet
        got[pkg] = (sorted(rows[0]), rows[0]["pack_width"], rows[0]["preemptions"],
                    rows[0]["breaches"], rows[0]["ticks_per_sec"] > 0,
                    fleet["workers"]["busy"] >= 1)
    assert got["torch"] == got["jax"]


# ------------------------------------------------------- kill and events


def test_kill_stops_a_running_task_as_jax(daemons):
    """``/kill`` of a running task after its first chunk's telemetry row:
    the run stops at the next chunk's end and the task ends as the
    reference's does. The run's own outcome is canceled; the task's, which
    counts every run that did not succeed as a failure, is failure."""
    got = {}
    for pkg, d in daemons.items():
        c = d["client"]
        _, out, _ = _call(d, pkg, ["run", "composition", "-f", "{home}/slow.toml",
                                   "--detach"])
        tid = _task_id(out)
        rows = d["home"] / "data" / "outputs" / "network" / tid / "sim_timeseries.jsonl"
        _wait(lambda: rows.exists() and rows.stat().st_size > 0, "the first chunk")
        assert c.kill(tid) is True
        t = _wait(lambda: _done(c, tid), "the killed task", timeout=20)
        assert c.kill(tid) is False  # nothing left to kill
        events = [r for r in c.events() if r.get("task") == tid]
        types = [r["type"] for r in events]
        assert types.index("task.cancel_requested") < types.index("task.finished")
        run = t["result"]
        got[pkg] = (t["states"][-1]["state"], t["outcome"], t["error"],
                    run["journal"]["events"], events[-1]["outcome"])
        assert 0 < run["journal"]["sim"]["ticks"] < 100_000
    assert got["torch"] == got["jax"]
    assert got["torch"][:3] == ("complete", "failure", "")


def test_events_route_tails_the_journal_as_jax(daemons):
    got = {}
    for pkg, d in daemons.items():
        c = d["client"]
        _, out, _ = _call(d, pkg, CASES["placebo"])
        tid = _task_id(out)
        rows = list(c.events(since=0))
        tail = rows[-1]
        assert tail["type"] == "_tail" and tail["offset"] > 0
        assert [r for r in c.events(since=tail["offset"]) if r["type"] != "_tail"] == []
        mine = [r for r in rows if r.get("task") == tid]
        got[pkg] = [(r["type"], sorted(r)) for r in mine]
        assert all(r["trace_id"] == mine[0]["trace_id"] for r in mine)
    assert got["torch"] == got["jax"]
    assert [t for t, _ in got["torch"]] == ["task.scheduled", "task.claimed",
                                            "task.started", "task.finished"]


def test_two_workers_run_two_tasks_at_once(tmp_path):
    """With ``scheduler.workers = 2`` two queued runs are claimed at once,
    each by its own worker, and each ends as it does alone."""
    home = _make_home(tmp_path, "torch", PORT_ENV, ("network",))
    (home / "slow.toml").write_text(SLOW.format(runner="sim:torch").replace(
        '"100000"', '"64"').replace("max_ticks = 100000", "max_ticks = 96"))
    d = _start("torch", home, workers=2)
    try:
        c = Client(d.address)
        from testground_tpu_torch.api import load_composition

        comp = load_composition(str(home / "slow.toml")).to_dict()
        ids = [c.run(comp) for _ in range(2)]
        done = [_wait(lambda i=i: _done(c, i), "two tasks") for i in ids]
        claims = [r for r in c.events() if r["type"] == "task.claimed"]
        assert sorted(r["worker"] for r in claims) == [0, 1]
        assert all(t["outcome"] == "success" for t in done)
        starts = [t["states"][1]["created"] for t in done]
        ends = [t["states"][2]["created"] for t in done]
        assert max(starts) < min(ends)  # they overlapped
        flows = [{k: v for k, v in t["result"]["journal"]["sim"].items()
                  if k.startswith("msgs_")} for t in done]
        assert flows[0] == flows[1] and flows[0]["msgs_delivered"] > 0
    finally:
        d.stop()


def test_sigterm_stops_the_daemon_process(tmp_path):
    """``python -m testground_tpu_torch.cli daemon``: it answers, and a
    SIGTERM stops it within a deadline."""
    home = _make_home(tmp_path, "torch", PORT_ENV, ())
    env = {**os.environ, "TESTGROUND_HOME": str(home), "PYTHONPATH": REPO}
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    proc = subprocess.Popen([sys.executable, "-m", "testground_tpu_torch.cli", "daemon",
                             "--listen", f"127.0.0.1:{port}"], env=env, cwd=str(tmp_path),
                            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    try:
        c = Client(f"127.0.0.1:{port}")

        def answers():
            assert proc.poll() is None, "the daemon exited early"
            with contextlib.suppress(OSError):
                return c.tasks() == []

        _wait(answers, "the daemon to answer", timeout=60)
        proc.terminate()
        assert proc.wait(timeout=20) == 0
        # SIGTERM drained the daemon before it stopped
        with open(home / "data" / "daemon" / "daemon_events.jsonl") as f:
            assert "daemon.drain" in [json.loads(ln)["type"] for ln in f]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)


# ----------------------------------------- the device-current fault (F3)


def test_worker_makes_the_runs_card_current_before_the_first_launch(tmp_path, monkeypatch):
    """A run on ``cuda:1`` (a fake card: its tensors live on the CPU) in a
    daemon worker: the worker thread enters ``torch.cuda.device`` for index
    1 before every launch of K1 and K2. Before the repair the kernels
    launched with card 1's stream while card 0 was current."""
    from testground_tpu_torch.sim import cuda_transport as ct
    from testground_tpu_torch.sim import engine as pengine
    from testground_tpu_torch.sim import net as pnet
    current = threading.local()
    entered = []

    class FakeDevice:
        def __init__(self, dev):
            self.idx = torch.device(dev).index

        def __enter__(self):
            current.stack = getattr(current, "stack", []) + [self.idx]
            entered.append((threading.current_thread().name, self.idx))

        def __exit__(self, *exc):
            current.stack.pop()

    def on_card():
        stack = getattr(current, "stack", [])
        return (threading.current_thread().name, stack[-1] if stack else None)

    launches = []
    plain_resolve = pengine.resolve_device
    monkeypatch.setattr(torch.cuda, "device", FakeDevice)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "a card")
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda d=None: 0)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d=None: type("P", (), {"total_memory": 2**30})())
    # the fake card's tensors live on the CPU
    monkeypatch.setattr(pengine, "resolve_device",
                        lambda d=None: plain_resolve("cpu" if str(d) == "cuda:1" else d))
    for mod in (ct, pnet):
        for name in ("commit_calendar", "pop_bucket"):
            plain = getattr(ct, name)

            def wrapper(*a, _plain=plain, _name=name, **kw):
                launches.append((_name, *on_card()))
                return _plain(*a, **kw)

            monkeypatch.setattr(mod, name, wrapper)
    home = _make_home(tmp_path, "torch", '[runners."sim:torch"]\ndevice = "cuda:1"\n',
                      ("network",))
    d = _start("torch", home)
    try:
        c = Client(d.address)
        _, out, _ = _call({"runner": "sim:torch", "client_home": home, "ep": d.address},
                          "torch", ["run", "single", "network:ping-pong", "-i", "4",
                                    "--run-cfg", "chunk=8"])
        t = c.status(_task_id(out))
    finally:
        d.stop()
    assert t["outcome"] == "success", t["error"]
    assert {k for k, _, _ in launches} == {"commit_calendar", "pop_bucket"}
    assert all(th.startswith("tg-worker-") and idx == 1 for _, th, idx in launches), \
        launches[:4]
    assert entered and all(idx == 1 for _, idx in entered)


def test_kernel_check_launches_on_the_card_it_checks(monkeypatch):
    """The healthcheck's K2 check on ``cuda:1`` builds, then launches with
    card 1 current."""
    from testground_tpu_torch.sim import cuda_transport as ct
    from testground_tpu_torch.sim import runner as prunner

    seen = []

    class FakeDevice:
        def __init__(self, dev):
            self.idx = torch.device(dev).index

        def __enter__(self):
            seen.append(("enter", self.idx))

        def __exit__(self, *exc):
            seen.append(("exit", self.idx))

    monkeypatch.setattr(torch.cuda, "device", FakeDevice)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "a card")
    monkeypatch.setattr(prunner, "_kernel_check_ok", {})
    monkeypatch.setattr(ct, "build_kernels", lambda: (seen.append("build") or "/x/t.so",
                                                      0.0, ""))
    monkeypatch.setattr(prunner, "_pop_check", lambda dev: seen.append(("pop", dev)) or True)
    ok, msg = prunner._kernel_check(torch.device("cuda:1"))
    assert ok and "bit-equal" in msg
    assert seen == ["build", ("enter", 1), ("pop", torch.device("cuda:1")), ("exit", 1)]


# ------------------------------------------------------ admission at submit


def _ping_pong(d, edit=None) -> dict:
    """``PING_PONG`` as the package's composition dict, ``edit`` applied."""
    path = os.path.join(d["client_home"], "ping-pong.toml")
    if d["runner"] == "sim:jax":
        from testground_tpu.api import load_composition
    else:
        from testground_tpu_torch.api import load_composition
    comp = load_composition(path).to_dict()
    if edit is not None:
        edit(comp)
    return comp


def _cfg(**kw):
    return lambda c: c["global"]["run_config"].update(kw)


def _slo_without_telemetry(c):
    c["global"]["run_config"]["telemetry"] = False
    c["global"]["run"] = {"slo": [{"metric": "drop_rate", "op": "<", "threshold": 0.5}]}


def _inverted_window(c):
    # a partition whose window ends before it starts
    c["groups"][0]["run"]["faults"] = [{"kind": "partition", "instances": "0:4",
                                        "to_instances": "4:8", "start_ms": 10.0,
                                        "duration_ms": -5.0}]


# name: (edit, the rule ids the 422 names)
REFUSED_AT_SUBMIT = {
    "slo-needs-telemetry": (_slo_without_telemetry, ["slo.needs-telemetry"]),
    "transport-unknown": (_cfg(transport="bogus"), ["transport.unknown"]),
    "faults-inverted-window": (_inverted_window, ["faults.invalid"]),
    "netmatrix-needs-telemetry": (_cfg(netmatrix=True, telemetry=False),
                                  ["netmatrix.needs-telemetry"]),
    "two-findings": (lambda c: (_cfg(transport="bogus")(c), _inverted_window(c)),
                     ["transport.unknown", "faults.invalid"]),
}


def _refusals(client) -> list:
    try:
        rows = list(client.events())
    except Exception as e:  # noqa: BLE001 — either package's DaemonError
        assert "no events journal yet" in str(e)
        rows = []
    return [{k: r.get(k) for k in ("type", "task", "task_type", "plan", "case", "rules")}
            for r in rows if r["type"] == "task.refused"]


def _submit(d, comp):
    """POST /run of ``comp``: the status, the error body, the tasks and
    refusals it added. The new tasks are those created after the POST
    began, by ID: a listing walks the store's buckets one by one, so a
    task a worker moves from one to the next meanwhile can be listed twice
    or not at all."""
    client = d["client"]
    refused = len(_refusals(client))
    t0 = time.time()
    status, body = _http(d["ep"], "POST", "/run", {"composition": comp})
    return {"status": status, "body": json.loads(body) if status != 200 else None,
            "new_tasks": len({t["id"] for t in client.tasks(after=t0)}),
            "refusals": _refusals(client)[refused:]}


@pytest.mark.parametrize("name", list(REFUSED_AT_SUBMIT))
def test_bad_composition_refused_at_submit_like_jax(name, daemons):
    """The same bad composition posted to both daemons: the same 422 and
    body naming the rules, one ``task.refused`` with the same fields each,
    and no task queued."""
    edit, rules = REFUSED_AT_SUBMIT[name]
    got = {pkg: _submit(daemons[pkg], _ping_pong(daemons[pkg], edit)) for pkg in PKGS}
    assert got["torch"] == got["jax"]
    port = got["torch"]
    assert port["status"] == 422 and port["new_tasks"] == 0
    msg = port["body"]["error"]
    assert msg.startswith("composition refused at submit (tg check): [")
    assert re.findall(r"\[([a-z.-]+)\] ", msg) == rules
    assert port["refusals"] == [{"type": "task.refused", "task": "", "task_type": "run",
                                 "plan": "network", "case": "ping-pong", "rules": rules}]


def test_client_reports_the_refusal(daemons):
    with pytest.raises(DaemonError, match=r"refused at submit.*\[transport.unknown\]"):
        daemons["torch"]["client"].run(_ping_pong(daemons["torch"], _cfg(transport="bogus")))


def test_unported_setting_refused_at_submit(daemons):
    """A cohort config, refused at submit as ``port.not-ported`` until the
    cohort was ported, is admitted by the reference's rules: one that
    resumes is refused as ``checkpoint.resume-cohort`` by both daemons
    alike. ``pack = true`` alone and on a mesh, a 2-D mesh and ``bucket =
    "auto"``, refused here until run packs, packs on a mesh and shape
    buckets were ported, are queued."""
    cohort = _cfg(coordinator_address="127.0.0.1:1", num_processes=2,
                  resume_from="earlier")
    got = {pkg: _submit(daemons[pkg], _ping_pong(daemons[pkg], cohort)) for pkg in PKGS}
    assert got["torch"] == got["jax"]
    assert got["torch"]["status"] == 422 and got["torch"]["new_tasks"] == 0
    assert "[checkpoint.resume-cohort] resume_from is not supported under a " \
           "multi-host cohort" in got["torch"]["body"]["error"]
    assert got["torch"]["refusals"][0]["rules"] == ["checkpoint.resume-cohort"]
    for cfg in (_cfg(pack=True), _cfg(pack=True, mesh="2"), _cfg(mesh="2x2"),
                _cfg(bucket="auto", bucket_ladder="16")):
        got = _submit(daemons["torch"], _ping_pong(daemons["torch"], cfg))
        assert got["status"] == 200 and got["new_tasks"] == 1 and got["refusals"] == []


def test_clean_composition_is_still_queued_and_builds_are_not_checked(daemons):
    for pkg in PKGS:
        d = daemons[pkg]
        got = _submit(d, _ping_pong(d))
        assert got["status"] == 200 and got["new_tasks"] == 1 and got["refusals"] == []
        # a build of a composition a run would refuse is queued all the same
        status, _ = _http(d["ep"], "POST", "/build",
                          {"composition": _ping_pong(d, _cfg(transport="bogus"))})
        assert status == 200
        deadline = time.monotonic() + 60
        while any(t["states"][-1]["state"] not in ("complete", "canceled")
                  for t in d["client"].tasks()):
            assert time.monotonic() < deadline, "queued tasks did not finish"
            time.sleep(0.05)
