"""The read side of the port's observability plane against the reference's,
on the CPU:

- ``engine/stream.py``: ``stream_task_rows`` over a port run's directory
  yields what the reference's yields over the same directory — a whole
  replay, a family subset, a partial trailing line left unread until its
  newline lands, and a scripted queued → running → done lifecycle;
- ``Task.stats_payload`` and ``perf_payload`` are the reference's on the
  same task;
- every copied renderer of ``runners/pretty.py`` prints the reference's
  bytes on payloads from port runs (telemetry, the traffic matrix, a
  trace, an SLO rule and the phase ledger on);
- every verb (``stats``, ``perf`` with ``--phases``/``--measure``/
  ``--compare``/``--follow``, ``trace`` and ``--lifecycle``, ``watch``,
  ``netmap``, ``diff``, ``top``, ``status --telemetry``) runs in process
  and through ``--endpoint`` against a daemon on the CPU, and reads
  nothing of the card;
- ``tg diff`` of two runs of one seed finds no mismatch in the counter
  planes.
"""

import contextlib
import io
import json
import os
import re
import shutil
import threading

import pytest

from testground_tpu.analysis import diff as jdiff
from testground_tpu.engine import stream as jstream
from testground_tpu.engine.task import Task as JTask
from testground_tpu.runners import pretty as jpretty
from testground_tpu.sim import netmatrix as jnetmatrix
from testground_tpu_torch.analysis import diff as pdiff
from testground_tpu_torch.cli.main import main as pmain
from testground_tpu_torch.config import EnvConfig
from testground_tpu_torch.daemon import Daemon
from testground_tpu_torch.engine import stream as pstream
from testground_tpu_torch.engine import Engine
from testground_tpu_torch.engine.task import Task
from testground_tpu_torch.engine.tracetree import TASK_SPANS_FILE, load_task_spans
from testground_tpu_torch.runners import pretty as ppretty
from testground_tpu_torch.sim import netmatrix as pnetmatrix
from testground_tpu_torch.sim.executor import plan_dir

COMPOSITION = """[global]
plan = "network"
case = "pingpong-sustained"
builder = "sim:plan"
runner = "sim:torch"

[global.run_config]
chunk = 8
telemetry = true
netmatrix = true
phases = true
phases_measure = 2

[global.run]
[[global.run.slo]]
metric = "delivered_per_tick"
op = ">"
threshold = 1000

[[groups]]
id = "left"
[groups.instances]
count = 6
[groups.run.test_params]
duration_ticks = "32"
[groups.run.trace]
instances = "0:2"

[[groups]]
id = "right"
[groups.instances]
count = 6
[groups.run.test_params]
duration_ticks = "32"
"""


def _cli(home, argv):
    out, err = io.StringIO(), io.StringIO()
    old = os.environ.get("TESTGROUND_HOME")
    os.environ["TESTGROUND_HOME"] = str(home)
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = pmain(argv)
    finally:
        if old is None:
            os.environ.pop("TESTGROUND_HOME", None)
        else:
            os.environ["TESTGROUND_HOME"] = old
    return rc, out.getvalue(), err.getvalue()


def _task_id(stdout):
    m = re.search(r"run is queued with ID: (\S+)", stdout)
    assert m, stdout
    return m[1]


@pytest.fixture(scope="module")
def site(tmp_path_factory):
    """A home holding the network plan with two in-process runs of one
    composition, and a daemon on another home with two runs through
    ``--endpoint``; the daemon is stopped in teardown."""
    root = tmp_path_factory.mktemp("observe")
    homes = {}
    for name in ("local", "daemon", "client"):
        home = root / name
        home.mkdir()
        if name != "client":
            shutil.copytree(plan_dir("network"), home / "plans" / "network",
                            ignore=shutil.ignore_patterns("__pycache__"))
            (home / ".env.toml").write_text('[runners."sim:torch"]\ndevice = "cpu"\n')
        homes[name] = home
    comp = root / "comp.toml"
    comp.write_text(COMPOSITION)
    daemon = Daemon(env=EnvConfig.load(home=str(homes["daemon"])), listen="127.0.0.1:0")
    daemon.start()
    try:
        tasks = {"local": [], "remote": []}
        for mode, home, pre in (("local", homes["local"], []),
                                ("remote", homes["client"], ["--endpoint", daemon.address])):
            for _ in range(2):
                rc, out, err = _cli(home, [*pre, "run", "composition", "-f", str(comp)])
                assert rc == 0, err
                tasks[mode].append(_task_id(out))
        yield {"homes": homes, "daemon": daemon, "tasks": tasks, "root": root}
    finally:
        daemon.stop()


def _local_task(site, i=0) -> Task:
    env = EnvConfig.load(home=str(site["homes"]["local"]))
    env.daemon.scheduler.task_repo_type = "disk"
    e = Engine.new_default(env)
    try:
        return e.get_task(site["tasks"]["local"][i])
    finally:
        e.stop()


def _outputs(site):
    return str(site["homes"]["local"] / "data" / "outputs")


# ---------------------------------------------------------------- stream


@pytest.mark.parametrize("families", [None, ("perf",), ("telemetry", "slo", "spans"),
                                      ("phases", "netmatrix")])
def test_stream_replay_matches_jax(site, families):
    tid = site["tasks"]["local"][0]
    got = {}
    for mod in (pstream, jstream):
        got[mod] = list(mod.stream_task_rows(_outputs(site), "network", tid, lambda: True,
                                             follow=False, families=families))
    assert got[pstream] == got[jstream]
    fams = {r["stream"] for r in got[pstream]}
    assert fams == set(families or {"telemetry", "netmatrix", "perf", "phases", "slo",
                                    "spans"})
    assert pstream.STREAM_FAMILIES == jstream.STREAM_FAMILIES
    assert pstream._POLL_SECS == jstream._POLL_SECS == 0.15
    assert pstream._READ_CHUNK == jstream._READ_CHUNK == 4 << 20


def _scripted_lifecycle(src_dir, root):
    """An ``is_done`` that moves a run through its lifecycle, one step per
    sweep: queued (no run dir), a run dir with a partial trailing line,
    the line completed with more rows and a second run, then done."""
    rows = {f: open(os.path.join(src_dir, f)).read().splitlines(keepends=True)
            for f in ("sim_timeseries.jsonl", "sim_perf.jsonl", "run_spans.jsonl")}
    tid = "task"
    state = {"step": 0}

    def write(run, f, text, mode="a"):
        d = os.path.join(root, "network", run)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, f), mode) as fh:
            fh.write(text)

    def is_done():
        step = state["step"]
        state["step"] += 1
        if step == 1:
            for f, lines in rows.items():
                write(tid, f, "".join(lines[:2]) + lines[2][:7], "w")
        elif step == 2:
            for f, lines in rows.items():
                write(tid, f, "".join([lines[2][7:]] + lines[3:]))
            write(tid + "-r2", "sim_perf.jsonl", "".join(rows["sim_perf.jsonl"]), "w")
        return step >= 3

    return tid, is_done


def test_stream_lifecycle_matches_jax(site, tmp_path):
    src = os.path.join(_outputs(site), "network", site["tasks"]["local"][0])
    got = {}
    for mod in (pstream, jstream):
        root = tmp_path / mod.__name__
        tid, is_done = _scripted_lifecycle(src, str(root))
        got[mod] = list(mod.stream_task_rows(str(root), "network", tid, is_done,
                                             follow=True, poll_secs=0.0))
    assert got[pstream] == got[jstream]
    # every row once, the partial line read once and whole, in its place;
    # the second run's perf rows after the first's
    n_perf = len(open(os.path.join(src, "sim_perf.jsonl")).readlines())
    perf = [r["chunk"] for r in got[pstream] if r["stream"] == "perf"]
    assert perf == list(range(n_perf)) * 2
    n_tele = len(open(os.path.join(src, "sim_timeseries.jsonl")).readlines())
    tele = [r["tick"] for r in got[pstream] if r["stream"] == "telemetry"]
    assert tele == sorted(tele) and len(tele) == n_tele


# -------------------------------------------------------------- payloads


def test_stats_and_perf_payloads_match_jax(site):
    t = _local_task(site)
    j = JTask.from_dict(json.loads(json.dumps(t.to_dict())))
    assert t.stats_payload() == j.stats_payload()
    assert t.perf_payload() == j.perf_payload()
    assert sorted(t.perf_payload()) == ["case", "outcome", "perf", "phases", "plan", "sim",
                                        "state", "task", "task_id"]
    assert t.perf_payload()["phases"]["transport"] == "plain"


# ------------------------------------------------------------- renderers


def _payloads(site):
    t = _local_task(site)
    stats, perf = t.stats_payload(), t.perf_payload()
    block = stats["sim"]["net_matrix"]
    return t, stats, perf, block


def test_summary_renderers_match_jax(site):
    t, stats, perf, _ = _payloads(site)
    for payload in (stats, {}, {"sim": {"ticks": "x"}}):
        assert (ppretty.render_telemetry_summary(payload)
                == jpretty.render_telemetry_summary(payload))
    for payload in (perf, {}, {"perf": {"execute": {"chunks": None}}}):
        assert ppretty.render_perf_summary(payload) == jpretty.render_perf_summary(payload)
        assert ppretty.render_phase_table(payload) == jpretty.render_phase_table(payload)
    assert "net_commit" in ppretty.render_phase_table(perf)


def test_netmap_renderers_match_jax(site):
    t, _, _, block = _payloads(site)
    ident = f"network:pingpong-sustained  ({t.id})"
    assert ppretty.render_netmap(block, ident) == jpretty.render_netmap(block, ident)
    assert ppretty.render_netmap({}, "") == jpretty.render_netmap({}, "")
    import numpy as np

    mat = np.asarray(block["matrix"], np.int64)
    for shards in (1, 2):
        rec = pnetmatrix.cut_advisor(pnetmatrix.matrix_bytes(mat), shards,
                                     labels=block["labels"])
        assert rec == jnetmatrix.cut_advisor(jnetmatrix.matrix_bytes(mat), shards,
                                             labels=block["labels"])
        assert ppretty.render_netmap_cut(rec, shards) == jpretty.render_netmap_cut(rec, shards)


def test_run_diff_renderer_matches_jax(site):
    env = EnvConfig.load(home=str(site["homes"]["local"]))
    env.daemon.scheduler.task_repo_type = "disk"
    e = Engine.new_default(env)
    try:
        a, b = site["tasks"]["local"]
        doc = e.diff_tasks(a, b)
        snaps = [jdiff.task_snapshot(e.get_task(x).to_dict(),
                                     list(e.stream_rows(x, follow=False, families=("perf",))))
                 for x in (a, b)]
    finally:
        e.stop()
    assert doc == jdiff.build_run_diff(*snaps)
    assert ppretty.render_run_diff(doc) == jpretty.render_run_diff(doc)
    assert doc["counters"]["mismatched"] == 0 and doc["findings"] == []


def test_fleet_and_lifecycle_renderers_match_jax(site):
    t = _local_task(site)
    env = EnvConfig.load(home=str(site["homes"]["local"]))
    env.daemon.scheduler.task_repo_type = "disk"
    e = Engine.new_default(env)
    try:
        fleet = e.fleet_payload()
    finally:
        e.stop()
    running = {**fleet, "tasks": [{"id": "x", "name": "network:pingpong-sustained",
                                   "type": "run", "state": "processing", "priority": 2,
                                   "queued_secs": 0.5, "running_secs": 3.25,
                                   "pack_width": 0, "ticks_per_sec": 1234.5,
                                   "breaches": 1, "trace_id": "", "preemptions": 0}]}
    for payload in (fleet, running, {}):
        assert ppretty.render_fleet(payload) == jpretty.render_fleet(payload)
    spans = load_task_spans(os.path.join(_outputs(site), "network", t.id, TASK_SPANS_FILE))
    assert spans
    assert ppretty.render_lifecycle_tree(spans) == jpretty.render_lifecycle_tree(spans)
    assert ppretty.render_lifecycle_tree([]) == jpretty.render_lifecycle_tree([])


# ----------------------------------------------------------------- verbs

# verb: (argv with {a}, {b} and {cmp}, what the output holds)
VERBS = {
    "stats": (["stats", "{a}"], "messages"),
    "stats-json": (["stats", "{a}", "--json"], '"telemetry"'),
    "perf-phases": (["perf", "{a}", "--phases", "--measure"], "net_commit"),
    "perf-compare": (["perf", "{a}", "--compare", "{cmp}"], "peer·ticks/s"),
    "perf-follow": (["perf", "{a}", "-f"], "-- run finished: outcome success --"),
    "trace": (["trace", "{a}", "-n", "4"], "trace: "),
    "trace-lifecycle": (["trace", "{a}", "--lifecycle"], "execute"),
    "watch": (["watch", "{a}"], "breaches"),
    "watch-json": (["watch", "{a}", "--json", "--no-follow"], '"stream": "phases"'),
    "netmap": (["netmap", "{a}", "--cut", "2"], "cut advisor"),
    "diff": (["diff", "{a}", "{b}"], "clean"),
    "top": (["top", "--no-follow"], "workers"),
    "top-json": (["top", "--json", "--no-follow"], '"counts"'),
    "status-telemetry": (["status", "-t", "{a}", "--telemetry"], "Telemetry:"),
}


@pytest.mark.parametrize("mode", ["local", "remote"])
@pytest.mark.parametrize("verb", list(VERBS))
def test_verb_runs_in_process_and_through_the_daemon(verb, mode, site, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "init", lambda: pytest.fail("a verb touched the card"))
    argv, want = VERBS[verb]
    a, b = site["tasks"][mode]
    cmp_file = site["root"] / f"perf-{mode}.json"
    if not cmp_file.exists():
        home = site["homes"]["local" if mode == "local" else "client"]
        pre = [] if mode == "local" else ["--endpoint", site["daemon"].address]
        rc, out, _ = _cli(home, [*pre, "perf", b, "--json"])
        assert rc == 0
        cmp_file.write_text(out)
    argv = [x.format(a=a, b=b, cmp=cmp_file) for x in argv]
    if mode == "remote":
        home, argv = site["homes"]["client"], ["--endpoint", site["daemon"].address, *argv]
    else:
        home = site["homes"]["local"]
    rc, out, err = _cli(home, argv)
    assert rc == 0, err
    assert want in out, out


@pytest.mark.parametrize("mode", ["local", "remote"])
def test_diff_of_one_seed_finds_no_mismatch(mode, site):
    a, b = site["tasks"][mode]
    home = site["homes"]["local" if mode == "local" else "client"]
    pre = [] if mode == "local" else ["--endpoint", site["daemon"].address]
    rc, out, err = _cli(home, [*pre, "diff", a, b, "--json"])
    assert rc == 0, err
    doc = json.loads(out)
    assert doc["setup"]["identical"] and doc["findings"] == []
    for plane in ("counters", "latency", "slo", "netmatrix", "phases"):
        assert doc[plane]["mismatched"] == 0, plane
    assert doc["counters"]["compared"] > 10
    rc, _, err = _cli(home, [*pre, "diff", a, b, "--planes", "vibes"])
    assert rc == 2 and "unknown diff plane" in err


def test_fleet_counters_match_jax(site, tmp_path):
    """The daemon's fleet counters: each claim in the histograms, each
    refusal counted, and the reference's keys; packs, preemptions and
    drain stay at zero until they are ported."""
    from testground_tpu.config import EnvConfig as JEnvConfig
    from testground_tpu.engine import Engine as JEngine
    from testground_tpu_torch.api import load_composition

    engine = site["daemon"].engine
    info = engine.fleet_info()
    assert sum(info["queue_wait_bins"]) == sum(info["claim_latency_bins"]) == 2
    assert info["workers"] == {"total": 2, "busy": 0}
    refused = info["refused"]
    comp = load_composition(str(site["root"] / "comp.toml"))
    engine.note_refused(comp, ["slo.invalid"])
    assert engine.fleet_info()["refused"] == refused + 1
    jengine = JEngine.new_default(JEnvConfig.load(home=str(tmp_path / "jax")))
    try:
        jinfo = jengine.fleet_info()
        assert sorted(info) == sorted(jinfo)
        assert {k: info[k] for k in ("pack", "preemptions", "evictions", "draining")} == {
            k: jinfo[k] for k in ("pack", "preemptions", "evictions", "draining")}
        fleet, jfleet = engine.fleet_payload(), jengine.fleet_payload()
        assert sorted(fleet) == sorted(jfleet)
        assert (fleet["pack"], fleet["draining"]) == (jfleet["pack"], jfleet["draining"])
        assert fleet["counts"] == {"complete": 2} and fleet["tasks"] == []
    finally:
        jengine.stop()
