"""The port's control plane against the JAX package's, on the CPU: the CLI
(``python -m testground_tpu_torch.cli``) end to end through the in-process
engine (its queue, its disk store and a worker), the ``sim:torch``
runner's healthcheck, the queue and daemon flags, the refusals, and the
executor's Influx mirror.

CLI cases run the reference's ``tg`` (``testground_tpu.cli.main``, runner
``sim:jax`` with ``shard = false`` in its ``.env.toml``: one device) and
the port's, both with the perf ledger on, their default, each in its own ``$TESTGROUND_HOME`` whose ``plans/``
holds its package's plan directories and whose ``.env.toml`` (the port's
sets ``device = "cpu"``) selects the CPU. Then the exit codes, the outcome
lines, the ``--result-file`` CSV rows, every run directory and the task
results (journal, outcome, composition) must be equal, once the task ID,
the home directory, the runner's name and the fields that differ between
any two runs (``test_torch_executor.VARYING_FIELDS``) are normalized. The
lifecycle span tree each engine writes into a run directory
(``task_spans.jsonl``, ``task_trace.json``) is compared span by span, each
with its parent's name in place of the ids and without its clocks.
"""

import contextlib
import csv
import http.server
import io
import json
import os
import re
import shutil
import tarfile
import threading

import pytest
import torch

import __graft_entry__ as ge
from test_torch_executor import COMPILE_DERIVED, SIM_SKIPPED, _read_tree, _strip
from test_torch_perf import perf_view
from testground_tpu.cli.main import main as jmain
from testground_tpu.config import EnvConfig as JEnvConfig
from testground_tpu.engine import Engine as JEngine
from testground_tpu.sim import executor as jexec
from testground_tpu_torch.cli import commands as pcommands
from testground_tpu_torch.cli.main import main as pmain
from testground_tpu_torch.config import EnvConfig
from testground_tpu_torch.engine import Engine, TaskStorage
from testground_tpu_torch.sim import cuda_transport as ct
from testground_tpu_torch.sim import executor as pexec
from testground_tpu_torch.sim import runner as prunner
from testground_tpu_torch.sim.runner import SimTorchRunner

REPO = os.path.dirname(os.path.abspath(ge.__file__))
REF_PLANS = os.path.join(REPO, "plans")
PORT_PLANS = os.path.join(REPO, "testground_tpu_torch", "plans")

REF_ENV = '[runners."sim:jax"]\nshard = false\n'
PORT_ENV = '[runners."sim:torch"]\ndevice = "cpu"\n'

# what an engine writes into a run directory at the end of a task: its
# lifecycle span tree (engine/tracetree.py)
ENGINE_FILES = frozenset({"task_spans.jsonl", "task_trace.json"})

# one run that passes and one that aborts: its fault table names no
# fault kind, so the run raises while it is lowered, and the next one runs
TWO_RUNS = """[global]
plan = "placebo"
case = "optional-failure"
builder = "sim:plan"
runner = "{runner}"

[global.run_config]
chunk = 8

[[groups]]
id = "all"
[groups.instances]
count = 4

[[runs]]
id = "passes"
[[runs.groups]]
id = "all"

[[runs]]
id = "aborts"
[runs.test_params]
should_fail = "true"
[[runs.groups]]
id = "all"
[[runs.groups.faults]]
kind = "meteor"
instances = "0:1"
start_ms = 2.0
"""


def _make_home(root, pkg, env_toml, plans):
    home = root / pkg
    home.mkdir(parents=True, exist_ok=True)
    src = REF_PLANS if pkg == "jax" else PORT_PLANS
    for p in plans:
        shutil.copytree(os.path.join(src, p), home / "plans" / p,
                        ignore=shutil.ignore_patterns("__pycache__"))
    (home / ".env.toml").write_text(env_toml)
    return home


@contextlib.contextmanager
def _home_env(home):
    old = os.environ.get("TESTGROUND_HOME")
    os.environ["TESTGROUND_HOME"] = str(home)
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("TESTGROUND_HOME", None)
        else:
            os.environ["TESTGROUND_HOME"] = old


def _cli(main, home, argv):
    """``(exit code, stdout, stderr)`` of one in-process CLI call."""
    out, err = io.StringIO(), io.StringIO()
    with _home_env(home), contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def _task_id(stdout):
    m = re.search(r"run is queued with ID: (\S+)", stdout)
    assert m, stdout
    return m.group(1)


def _jax_task(home, task_id):
    """The reference's archived task, from its on-disk store."""
    with _home_env(home):
        env = JEnvConfig.load()
        env.daemon.scheduler.task_repo_type = "disk"
        e = JEngine.new_default(env)
        try:
            return e.get_task(task_id)
        finally:
            e.stop()


def _port_task(home, task_id):
    """The port's archived task, from its on-disk store."""
    return TaskStorage(os.path.join(home, "tasks.db")).get(task_id)


def _engine_file(run_dir, name):
    """``task_spans.jsonl`` or ``task_trace.json`` made comparable across
    two runs: each span (or trace event) with its parent's name in place of
    the ids and without its clocks, in an order of their own. Every parent
    must resolve: the tree is connected."""
    with open(os.path.join(run_dir, name)) as f:
        if name == "task_spans.jsonl":
            rows = [json.loads(ln) for ln in f if ln.strip()]
            names = {r["span_id"]: r["name"] for r in rows}
            assert all(r["parent_id"] in names for r in rows if r["parent_id"]), name
            rows = [{**{k: v for k, v in r.items() if k not in ("start_ns", "end_ns")},
                     "parent": names.get(r["parent_id"], "")} for r in rows]
            head = {}
        else:
            doc = json.load(f)
            rows = [{k: v for k, v in e.items() if k not in ("ts", "dur")}
                    for e in doc["traceEvents"]]
            head = {k: v for k, v in doc.items() if k != "traceEvents"}
    return {**head, "spans": sorted((_strip(r) for r in rows),
                                    key=lambda r: json.dumps(r, sort_keys=True))}


def _run_tree(run_dir):
    """A run directory as ``_read_tree`` reads it, its span tree as
    ``_engine_file`` does."""
    tree = _read_tree(run_dir)
    for name in ENGINE_FILES & set(tree):
        tree[name] = _engine_file(run_dir, name)
    return tree


def _norm(x, task_id, home):
    """Strip the varying fields and name the task, the home and the runner
    the same way in both packages' records."""
    text = json.dumps(_strip(x))
    for old, new in ((task_id, "<task>"), (str(home), "<home>"), ("sim:jax", "sim:torch")):
        text = text.replace(old, new)
    return json.loads(text)


def _journal(result):
    j = json.loads(json.dumps(result.get("journal", {})))
    if "sim" in j:
        j["sim"] = {k: v for k, v in j["sim"].items() if k not in SIM_SKIPPED}
    return j


def _record(pkg, home, rc, stdout, stderr, result_file):
    """What a CLI call left: its lines, CSV rows, run directories and task."""
    task_id = _task_id(stdout)
    t = (_jax_task if pkg == "jax" else _port_task)(home, task_id)
    result = t.result
    runs = result.get("runs")
    results = ({rid: r for rid, r in runs.items()} if runs else {None: result})
    run_dirs = {}
    outputs = os.path.join(home, "data", "outputs", t.plan)
    for rid in results:
        run_id = task_id if rid is None else f"{task_id}-{rid}"
        d = os.path.join(outputs, run_id)
        run_dirs[rid] = _run_tree(d) if os.path.isdir(d) else None
    if runs:
        # a composition of several runs: the task's own directory holds its
        # span tree
        run_dirs["task"] = _run_tree(os.path.join(outputs, task_id))
    rows = []
    if result_file and os.path.exists(result_file):
        with open(result_file) as f:
            rows = list(csv.reader(f))
    lines = [ln for ln in stdout.splitlines()
             if ln.startswith(("finished run with ID", "  run "))]
    errors = [ln for ln in stderr.splitlines() if ln.startswith("error: ")]
    return _norm({
        "rc": rc, "lines": lines, "errors": errors, "csv": rows,
        "run_dirs": run_dirs,
        "outcome": t.outcome().value,
        "error": t.error,
        # the task-level perf block holds wall times (and, in the
        # reference, the queue wait)
        "results": {str(rid): {**{k: v for k, v in r.items()
                                  if k not in ("journal", "perf", "composition")},
                               "journal": _journal(r),
                               # the perf ledger's keys and counts
                               "sim_perf": (perf_view(r["journal"]["sim"])
                                            if "perf" in r.get("journal", {}).get("sim", {})
                                            else None)}
                    for rid, r in results.items()},
        "composition": result.get("composition"),
    }, task_id, home)


# name: (plans to copy, argv with {home} and {runner}, writes a result file)
CLI_CASES = {
    "sustained-smoke": (("network",), ["run", "composition", "-f",
                                       "{home}/plans/network/_compositions/sustained-smoke.toml",
                                       "--result-file", "{home}/results.csv"]),
    "chaos-smoke": (("chaos",), ["run", "composition", "-f",
                                 "{home}/plans/chaos/_compositions/smoke.toml",
                                 "--result-file", "{home}/results.csv"]),
    "two-runs": (("placebo",), ["run", "composition", "-f", "{home}/two-runs.toml",
                                "--result-file", "{home}/results.csv"]),
    "single-placebo": (("placebo",), ["run", "single", "placebo:ok", "-i", "4",
                                      "--builder", "sim:plan", "--runner", "{runner}"]),
    "single-run-cfg": (("network",), ["run", "single", "network:ping-pong", "-i", "8",
                                      "--runner", "{runner}", "--run-cfg", "chunk=32",
                                      "--run-cfg", "telemetry=true", "--run-cfg", "mesh=4",
                                      "-tp", "tolerance_ms=20"]),
}


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """Each CLI case run once through both CLIs, on first use."""
    cache = {}

    def get(name):
        if name not in cache:
            plans, argv = CLI_CASES[name]
            base = tmp_path_factory.mktemp(name)
            both = {}
            for pkg, main, env, runner in (("jax", jmain, REF_ENV, "sim:jax"),
                                           ("torch", pmain, PORT_ENV, "sim:torch")):
                home = _make_home(base, pkg, env, plans)
                (home / "two-runs.toml").write_text(TWO_RUNS.format(runner=runner))
                args = [a.format(home=home, runner=runner) for a in argv]
                rc, out, err = _cli(main, home, args)
                result_file = str(home / "results.csv")
                both[pkg] = (_record(pkg, home, rc, out, err, result_file), out, err)
                both[f"{pkg}-task"] = (_jax_task if pkg == "jax" else _port_task)(
                    home, _task_id(out))
            cache[name] = both
        return cache[name]

    return get


@pytest.mark.parametrize("name", list(CLI_CASES))
def test_cli_run_matches_jax(name, cli_runs):
    both = cli_runs(name)
    (port, pout, perr), (ref, _, _) = both["torch"], both["jax"]
    for key in ("rc", "lines", "errors", "csv", "outcome", "error", "composition"):
        assert port[key] == ref[key], f"{name}: {key}\n{pout}\n{perr}"
    assert sorted(port["results"]) == sorted(ref["results"])
    for rid in ref["results"]:
        assert port["results"][rid] == ref["results"][rid], f"{name}: run {rid}"
    assert sorted(port["run_dirs"]) == sorted(ref["run_dirs"])
    for rid, tree in ref["run_dirs"].items():
        assert (tree is None) == (port["run_dirs"][rid] is None), rid
        if tree is not None:
            assert sorted(port["run_dirs"][rid]) == sorted(tree), rid
            for rel in tree:
                assert port["run_dirs"][rid][rel] == tree[rel], f"{name}: {rid}/{rel}"


# name: (exit code, outcome lines, CSV rows past the header, files in a run dir)
EXPECTED = {
    "sustained-smoke": (0, ["finished run with ID: <task> (outcome: success)"],
                        [["<task>", "network:pingpong-sustained", "success", ""]],
                        {"sim_timeseries.jsonl", "sim_latency.jsonl", "sim_slo.jsonl",
                         "timeseries.jsonl", "run_spans.jsonl", "pairs/7/run.out",
                         "task_spans.jsonl", "task_trace.json", "sim_perf.jsonl"}),
    "chaos-smoke": (0, ["finished run with ID: <task> (outcome: success)"],
                    [["<task>", "chaos:chaos-barrier", "success", ""]],
                    {"sim_trace.jsonl", "trace_events.json", "sim_slo.jsonl"}),
    "two-runs": (1, ["finished run with ID: <task> (outcome: failure)",
                     "  run passes: outcome: success", "  run aborts: outcome: failure"],
                 None, {"all/3/run.out"}),
    "single-placebo": (0, ["finished run with ID: <task> (outcome: success)"], [],
                       {"single/3/run.out"}),
    "single-run-cfg": (0, ["finished run with ID: <task> (outcome: success)"], [],
                       {"sim_timeseries.jsonl", "single/7/metrics.out"}),
}


@pytest.mark.parametrize("name", list(CLI_CASES))
def test_cli_run_covers_what_it_is_for(name, cli_runs):
    """The equalities above are not vacuous."""
    port, _, _ = cli_runs(name)["torch"]
    rc, lines, rows, files = EXPECTED[name]
    assert port["rc"] == rc and port["lines"] == lines
    if rows is not None:
        assert port["csv"][1:] == rows
    trees = [t for t in port["run_dirs"].values() if t is not None]
    assert trees and all(files <= set(t) for t in trees[:1]), name
    spans = {s["name"] for s in trees[-1]["task_spans.jsonl"]["spans"]}
    assert {"submit", "queued", "claim", "execute", "archive", "run"} <= spans, spans
    if name == "two-runs":
        rows = port["csv"][1:]
        assert [r[0] for r in rows] == ["<task>-passes", "<task>-aborts"]
        assert rows[0][3] == "" and "meteor" in rows[1][3]
        assert port["errors"] == [f"error: run aborts failed: {rows[1][3]}"]
        assert port["run_dirs"]["aborts"] is not None  # its run span was kept
    if name == "single-run-cfg":
        sim = port["results"]["None"]["journal"]["sim"]
        assert sim["mesh"]["shards"] == 4 and sim["devices"] == 4
        assert port["composition"]["global"]["run_config"]["mesh"] == 4
        assert port["composition"]["runs"][0]["groups"][0]["test_params"][
            "tolerance_ms"] == "20"


def test_cli_journal_names_the_plain_transport_on_the_cpu(cli_runs):
    runs = cli_runs("sustained-smoke")
    port, _, _ = runs["torch"]
    assert port["composition"]["global"]["runner"] == "sim:torch"
    task = runs["torch-task"]
    assert (task.plan, task.case, task.runner) == ("network", "pingpong-sustained", "sim:torch")
    assert task.result["journal"]["sim"]["transport"]["resolved"] == "plain"
    # the task-level timings: the queue wait and the runner's wall, as in
    # the reference
    assert set(task.result["perf"]) == {"runner_wall_secs", "queued_secs"}
    assert set(task.result["perf"]) == set(runs["jax-task"].result["perf"])
    assert 0 <= task.result["perf"]["queued_secs"] < 5


def test_write_artifacts_and_reuse(tmp_path):
    """``--write-artifacts`` writes the snapshot into the composition file;
    a second run reuses it and builds nothing."""
    home = _make_home(tmp_path, "torch", PORT_ENV, ("placebo",))
    comp = home / "comp.toml"
    comp.write_text(TWO_RUNS.format(runner="sim:torch").split("[[runs]]")[0])
    rc, out, _ = _cli(pmain, home, ["run", "composition", "-f", str(comp),
                                    "--write-artifacts"])
    assert rc == 0 and "sim:plan built placebo" in out
    assert "wrote artifacts into composition" in out
    text = comp.read_text()
    assert "sim-plan--placebo-" in text
    rc, out, _ = _cli(pmain, home, ["run", "composition", "-f", str(comp)])
    assert rc == 0 and "built" not in out
    rc, out, _ = _cli(pmain, home, ["run", "composition", "-f", str(comp),
                                    "--ignore-artifacts", "--run-ids", "default"])
    assert rc == 0 and "sim:plan built placebo" in out


# the lines a build prints in both packages (the reference's precompile
# into XLA's cache has no counterpart in the port)
BUILD_LINES = ("build is queued", "sim:plan built", "group ", "finished build",
               "wrote artifacts")

# name: (argv with {home}; plans to copy)
BUILD_RUN_CFG = {
    "composition": (["build", "composition", "-f", "{home}/comp.toml", "--run-cfg",
                     "chunk=32", "--run-cfg", "telemetry=true", "--write-artifacts"],
                    ("placebo",)),
    "single": (["build", "single", "network:ping-pong", "--run-cfg", "chunk=32"],
               ("network",)),
}


@pytest.mark.parametrize("mode", list(BUILD_RUN_CFG))
def test_build_run_cfg_matches_jax(mode, tmp_path):
    """``build composition|single --run-cfg k=v`` merges the overrides into
    the composition's ``global.run_config`` as the reference does: the same
    exit code and lines, the same build task composition and the same
    written composition file (``[[runs]]``' ``total_instances`` aside, which
    the reference's precompile pass fills in as it validates)."""
    argv, plans = BUILD_RUN_CFG[mode]
    got = {}
    for pkg, main, env, runner in (("jax", jmain, REF_ENV, "sim:jax"),
                                   ("torch", pmain, PORT_ENV, "sim:torch")):
        home = _make_home(tmp_path, pkg, env, plans)
        comp = home / "comp.toml"
        comp.write_text(TWO_RUNS.format(runner=runner).split("[[runs]]")[0])
        rc, out, err = _cli(main, home, [a.format(home=home) for a in argv])
        tid = re.search(r"build is queued with ID: (\S+)", out).group(1)
        task = (_jax_task if pkg == "jax" else _port_task)(home, tid)
        written = None
        if mode == "composition":
            from testground_tpu_torch.api import Composition

            written = Composition.load_file(str(comp)).to_dict()
            for run in written["runs"]:
                run.pop("total_instances")
        got[pkg] = _norm({
            "rc": rc, "outcome": task.outcome().value,
            "lines": [ln for ln in out.splitlines() if ln.startswith(BUILD_LINES)],
            "run_config": task.composition["global"]["run_config"],
            "written": written,
        }, tid, home)
    assert got["torch"] == got["jax"]
    assert got["torch"]["rc"] == 0 and got["torch"]["outcome"] == "success"
    assert got["torch"]["run_config"]["chunk"] == 32
    if mode == "composition":
        assert got["torch"]["written"]["global"]["run_config"] == {"chunk": 32,
                                                                   "telemetry": True}
        assert got["torch"]["lines"][-1].startswith("wrote artifacts into composition")


# ------------------------------------------------------------- refusals


def test_disabled_runner_is_refused_like_jax(tmp_path):
    msgs = {}
    for pkg, main, runner in (("jax", jmain, "sim:jax"), ("torch", pmain, "sim:torch")):
        home = _make_home(tmp_path, pkg, f'[runners."{runner}"]\ndisabled = true\n',
                          ("placebo",))
        rc, out, err = _cli(main, home, ["run", "single", "placebo:ok", "-i", "2",
                                         "--builder", "sim:plan", "--runner", runner])
        assert rc == 1 and "(outcome: failure)" in out
        msgs[pkg] = [ln for ln in err.splitlines() if ln.startswith("error: ")]
    assert msgs["torch"] == ["error: runner sim:torch is disabled in .env.toml"]
    assert msgs["torch"] == [m.replace("sim:jax", "sim:torch") for m in msgs["jax"]]


# the setting, and the ROADMAP item that refuses it; None for bucket=auto
# and num_processes=2, refused until shape buckets and the cohort were
# ported, which now run (a process count without a coordinator means
# nothing, as in the reference)
@pytest.mark.parametrize("setting,item", [("bucket=auto", None),
                                          ("num_processes=2", None)],
                         ids=["bucket=auto-item 13", "num_processes=2-cohort"])
def test_unported_runner_setting_reaches_the_user(setting, item, tmp_path):
    home = _make_home(tmp_path, "torch", PORT_ENV, ("placebo",))
    rc, out, err = _cli(pmain, home, ["run", "single", "placebo:ok", "-i", "2",
                                      "--run-cfg", setting])
    if item is None:
        assert rc == 0 and "(outcome: success)" in out, err
        return
    assert rc == 1 and "(outcome: failure)" in out
    errors = [ln for ln in err.splitlines() if ln.startswith("error: ")]
    assert len(errors) == 1 and f"ROADMAP queue 1 {item}" in errors[0], err


def test_checkpoint_run_cfg_writes_snapshots_as_jax(tmp_path):
    """``--run-cfg checkpoint_chunks=2`` (refused until the checkpoint plane
    was ported) runs, and both packages keep the same snapshot files and
    journal the same ``sim.checkpoint`` block, the timings aside."""
    got = {}
    for pkg, main, runner, env in (("jax", jmain, "sim:jax", REF_ENV),
                                   ("torch", pmain, "sim:torch", PORT_ENV)):
        home = _make_home(tmp_path, pkg, env, ("placebo",))
        rc, out, err = _cli(main, home, ["run", "single", "placebo:ok", "-i", "2",
                                         "--builder", "sim:plan", "--runner", runner,
                                         "--run-cfg", "checkpoint_chunks=1",
                                         "--run-cfg", "chunk=8"])
        assert rc == 0, err
        tid = _task_id(out)
        run_dir = os.path.join(home, "data", "outputs", "placebo", tid)
        t = (_jax_task if pkg == "jax" else _port_task)(home, tid)
        block = dict(t.result["journal"]["sim"]["checkpoint"])
        for k in ("write_ms", "total_write_ms", "bytes"):
            assert block.pop(k) > 0, (pkg, k)
        got[pkg] = (sorted(os.listdir(os.path.join(run_dir, "checkpoints"))), block)
    assert got["torch"] == got["jax"]
    assert got["torch"][1]["count"] >= 1


def test_phases_run_cfg_writes_the_phase_rows_as_jax(tmp_path):
    """``--run-cfg phases=true`` (refused until the phase plane was
    ported) runs, and both packages' ``sim_phases.jsonl`` hold the same
    rows: the phases, then residual and total, with the same fields."""
    got = {}
    for pkg, main, runner, env in (("jax", jmain, "sim:jax", REF_ENV),
                                   ("torch", pmain, "sim:torch", PORT_ENV)):
        home = _make_home(tmp_path, pkg, env, ("placebo",))
        rc, out, err = _cli(main, home, ["run", "single", "placebo:ok", "-i", "2",
                                         "--builder", "sim:plan", "--runner", runner,
                                         "--run-cfg", "phases=true"])
        assert rc == 0, err
        tid = _task_id(out)
        rows = [json.loads(ln) for ln in open(os.path.join(
            home, "data", "outputs", "placebo", tid, "sim_phases.jsonl"))]
        got[pkg] = [(r["phase"], r["run"] == tid, sorted(set(r) & {"phase", "run", "plan",
                                                                    "case", "transport"}))
                    for r in rows]
    assert got["torch"] == got["jax"]
    assert [p for p, _, _ in got["torch"]] == ["deliver", "step", "sync", "net_commit",
                                               "residual", "total"]


# the queue and daemon flags, with {home} and {runner}; the port refused
# them until it had a task store and a daemon
ONE_RUN = "{home}/one-run.toml"
SINGLE = ["run", "single", "placebo:ok", "-i", "2", "--builder", "sim:plan",
          "--runner", "{runner}"]
DAEMON_FLAGS = {
    "endpoint": ["--endpoint", "http://127.0.0.1:9", *SINGLE],
    "detach": [*SINGLE, "--detach"],
    "collect": [*SINGLE, "--collect"],
    "collect-file": ["run", "composition", "-f", ONE_RUN, "--collect-file", "{home}/o.tgz"],
    "priority": ["run", "composition", "-f", ONE_RUN, "--priority", "3"],
    "metadata": [*SINGLE, "--metadata-repo", "org/repo", "--metadata-branch", "main",
                 "--metadata-commit", "abc123"],
    "resume": ["run", "resume", "sometask"],
    "client-endpoint": ["healthcheck", "--runner", "{runner}"],
}


def _flag_record(pkg, home, rc, out, err):
    """What a CLI call with a queue or daemon flag left: its exit code, its
    report lines, the task's queue fields and the files it collected."""
    m = re.search(r"run is queued with ID: (\S+)", out)
    task_id = m[1] if m else "<none>"
    rec = {"rc": rc,
           "lines": [ln for ln in out.splitlines()
                     if ln.startswith(("run is queued", "finished run", "downloaded"))],
           "errors": [ln for ln in err.splitlines() if ln.startswith(("error: ", "warning: "))]}
    if m:
        t = (_jax_task if pkg == "jax" else _port_task)(home, task_id)
        rec["task"] = {"priority": t.priority, "created_by": t.created_by.to_dict(),
                       "state": t.state().state.value, "outcome": t.outcome().value}
        for tgz in (home / f"{task_id}.tgz", home / "o.tgz"):
            if tgz.exists():
                with tarfile.open(tgz) as tar:
                    rec["collected"] = sorted(tar.getnames())
    return _norm(rec, task_id, home)


@pytest.mark.parametrize("name", list(DAEMON_FLAGS))
def test_daemon_only_flag_is_refused_naming_its_item(name, tmp_path, monkeypatch):
    """The flags the port refused while it had no task store and no daemon
    now do what the reference's do: the same exit code, lines, queue fields
    of the task and collected files. ``run resume`` seeds a run from a
    checkpoint, and is still refused, naming its item (13)."""
    got = {}
    for pkg, main, env, runner in (("jax", jmain, REF_ENV, "sim:jax"),
                                   ("torch", pmain, PORT_ENV, "sim:torch")):
        if name == "client-endpoint":
            env += '[client]\nendpoint = "http://127.0.0.1:9"\n'
        home = _make_home(tmp_path, pkg, env, ("placebo",))
        (home / "one-run.toml").write_text(TWO_RUNS.format(runner=runner).split("[[runs]]")[0])
        monkeypatch.chdir(home)  # --collect writes <task>.tgz into the working dir
        argv = [a.format(home=home, runner=runner) for a in DAEMON_FLAGS[name]]
        got[pkg] = _flag_record(pkg, home, *_cli(main, home, argv))
    port = got["torch"]
    assert port == got["jax"]
    if name == "resume":
        # a task this home never ran: refused as the reference refuses it
        assert port["rc"] == 1 and "unknown task sometask" in port["errors"][0], port
        return
    if name in ("endpoint", "client-endpoint"):
        # nothing listens there: the call fails, and nothing runs in process
        assert port["rc"] == 1 and "Connection refused" in port["errors"][0], port
        assert not os.path.exists(tmp_path / "torch" / "data" / "outputs" / "placebo")
        return
    assert port["rc"] == 0 and port["task"]["outcome"] == "success", port
    if name == "detach":
        # without a daemon the in-process engine waits, with the warning
        assert port["errors"][0].startswith("warning: --detach without --endpoint")
    if name.startswith("collect"):
        assert {"<task>/task_spans.jsonl", "<task>/task_trace.json",
                "<task>/run_spans.jsonl"} <= set(port["collected"]), port
    if name == "priority":
        assert port["task"]["priority"] == 3
    if name == "metadata":
        assert port["task"]["created_by"] == {"user": "", "repo": "org/repo",
                                              "branch": "main", "commit": "abc123"}


# ----------------------------------------------------------- healthcheck


def _report_lines(stdout):
    return {m.group(1): m.group(2) for m in re.finditer(r"check (\S+): (\S+)", stdout)}


def test_healthcheck_on_the_cpu_passes(tmp_path):
    home = _make_home(tmp_path, "torch", PORT_ENV, ())
    rc, out, _ = _cli(pmain, home, ["healthcheck", "--runner", "sim:torch"])
    assert rc == 0
    assert _report_lines(out) == dict.fromkeys(
        ("torch-importable", "device-available", "kernel-buildable", "device-memory",
         "outputs-dir-writable"), "ok")


def test_healthcheck_without_a_card_fails_and_does_not_fall_back(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    home = _make_home(tmp_path, "torch", "", ("placebo",))
    rc, out, _ = _cli(pmain, home, ["healthcheck", "--runner", "sim:torch", "--fix"])
    assert rc == 1
    checks = _report_lines(out)
    assert checks["device-available"] == "failed" and checks["torch-importable"] == "ok"
    assert "no CUDA device" in out
    # a run fails with the reference's healthcheck error and runs nothing
    rc, out, err = _cli(pmain, home, ["run", "single", "placebo:ok", "-i", "2"])
    assert rc == 1 and "(outcome: failure)" in out
    assert "error: runner sim:torch failed healthcheck" in err
    # the task's directory holds its span tree and nothing of a run
    outputs = home / "data" / "outputs" / "placebo"
    assert [set(os.listdir(outputs / d)) for d in os.listdir(outputs)] == [ENGINE_FILES]


def test_run_cfg_device_cpu_passes_the_healthcheck_without_a_card(tmp_path, monkeypatch):
    """The healthcheck checks the run's device, coalesced from the
    composition (here ``--run-cfg``), not the env's layer alone."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    home = _make_home(tmp_path, "torch", "", ("placebo",))
    rc, out, err = _cli(pmain, home, ["run", "single", "placebo:ok", "-i", "2",
                                      "--run-cfg", "device=cpu"])
    assert rc == 0 and "(outcome: success)" in out, out + err
    assert "check device-available: ok" not in out  # the report prints only on failure
    task = _port_task(home, _task_id(out))
    assert task.result["journal"]["sim"]["transport"]["resolved"] == "plain"


def _fake_card(monkeypatch, allocated=0, total=80 * 2**30):
    """A card as the healthcheck reads it, with no CUDA call reaching torch."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "a card")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda d=None: allocated)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d=None: type("Props", (), {"total_memory": total})())
    # the whole card held by the caching allocator and other processes
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda d=None: (0, total))


def test_healthcheck_checks_the_device_the_run_config_names(tmp_path, monkeypatch):
    """On a card host, a run set to ``device = "cpu"`` builds no kernel and
    reads no card memory: its checks are on the CPU."""
    _fake_card(monkeypatch)

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(ct, "build_kernels", no_nvcc)
    env = EnvConfig.load(home=str(tmp_path))
    ow = pcommands.OutputWriter(None)
    on_cpu = SimTorchRunner().healthcheck(fix=False, ow=ow, env=env,
                                          config=pexec.SimTorchConfig(device="cpu"))
    assert on_cpu.ok(), str(on_cpu)
    msgs = {c.name: c.message for c in on_cpu.checks}
    assert "cpu" in msgs["kernel-buildable"] and "cpu" in msgs["device-memory"]
    on_card = SimTorchRunner().healthcheck(fix=False, ow=ow, env=env,
                                           config=pexec.SimTorchConfig())
    assert not on_card.ok()
    assert "nvcc not found" in {c.name: c.message for c in on_card.checks}["kernel-buildable"]


@pytest.mark.parametrize("allocated,status", [(2**30, "ok"), (79 * 2**30, "failed")])
def test_device_memory_counts_live_allocations(allocated, status, tmp_path, monkeypatch):
    """``device-memory`` counts the live allocations, as the reference's
    ``bytes_in_use``: a card whose memory the cache or other processes
    hold passes, one this process has filled past 95% fails."""
    _fake_card(monkeypatch, allocated=allocated)
    monkeypatch.setattr(prunner, "_kernel_check", lambda dev: (True, "built"))
    env = EnvConfig.load(home=str(tmp_path))
    report = SimTorchRunner().healthcheck(fix=False, ow=pcommands.OutputWriter(None), env=env)
    check = {c.name: c for c in report.checks}["device-memory"]
    assert check.status == status, check.message
    assert f"{allocated}/{80 * 2**30} bytes in use" in check.message


def test_kernel_that_does_not_build_fails_the_healthcheck(tmp_path, monkeypatch):
    def no_nvcc():
        raise RuntimeError("nvcc not found: the transport kernels are built with "
                           "the CUDA toolkit")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "a card")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(ct, "build_kernels", no_nvcc)
    monkeypatch.setattr(prunner, "_kernel_check_ok", {})
    env = EnvConfig.load(home=str(tmp_path))
    report = SimTorchRunner().healthcheck(fix=True, ow=pcommands.OutputWriter(None), env=env)
    by_name = {c.name: c for c in report.checks}
    assert by_name["device-available"].status == "ok"
    assert by_name["kernel-buildable"].status == "failed"
    assert "nvcc not found" in by_name["kernel-buildable"].message
    assert not report.ok() and prunner._kernel_check_ok == {}


def test_runner_identity_and_registry(tmp_path):
    r = SimTorchRunner()
    assert r.id() == "sim:torch" and r.compatible_builders() == ["sim:plan"]
    assert r.config_type() is pexec.SimTorchConfig
    reg = Engine.new_default(EnvConfig.load(home=str(tmp_path)))
    assert reg.list_builders() == ["sim:plan"] and reg.list_runners() == ["sim:torch"]
    with pytest.raises(ValueError, match="unknown runner: sim:jax"):
        reg.do_healthcheck("sim:jax", False, None)


def test_version():
    rc, out, _ = _cli(pmain, ".", ["version"])
    assert rc == 0 and out.startswith("testground-tpu-torch ")


# ------------------------------------------------------------ Influx mirror


class _Capture(http.server.BaseHTTPRequestHandler):
    def do_POST(self):
        n = int(self.headers["Content-Length"])
        self.server.posts.append((self.path, self.rfile.read(n).decode("utf-8")))
        self.send_response(204)
        self.end_headers()

    def log_message(self, *args):
        pass


@pytest.fixture()
def capture():
    srv = http.server.HTTPServer(("127.0.0.1", 0), _Capture)
    srv.posts = []
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield srv
    srv.shutdown()
    srv.server_close()


def _rebased(body):
    """Each line's timestamp as ``base+tick``: every line of one run shares
    its base (the run's start), which differs between two runs."""
    bases, out = set(), []
    for line in body.splitlines():
        head, ts = line.rsplit(" ", 1)
        tick = int(re.search(r"(?:^|,| )tick=(-?\d+)i", head).group(1))
        bases.add(int(ts) - tick)
        out.append(f"{head} base+{tick}")
    assert len(bases) == 1, bases
    return out, bases.pop()


def _measurements(body) -> list:
    """The measurement of each line of a line-protocol body, the compile
    pass's gauges of the reference aside."""
    names = [line.split(",", 1)[0] for line in body.splitlines()]
    return sorted(n for n in names if n.rsplit(".", 1)[-1] not in COMPILE_DERIVED)


@pytest.mark.parametrize("batch", [5000, 7])
def test_influx_mirror_posts_the_reference_bodies(batch, capture, tmp_path, monkeypatch):
    """The same run through both executors with an Influx endpoint: the
    capture server receives the same line-protocol bodies, timestamps
    rebased to each run's start, and the journals' influx blocks agree.
    The perf ledger's family (the last POST) holds timings: its
    measurements agree, less the reference's compile-pass gauges."""
    from testground_tpu.api import RunGroup as JRunGroup
    from testground_tpu.api import RunInput as JRunInput
    from testground_tpu.rpc import discard_writer as jdiscard
    from testground_tpu_torch.api import RunGroup, RunInput
    from testground_tpu_torch.rpc import discard_writer

    monkeypatch.setattr(jexec, "_INFLUX_BATCH_LINES", batch)
    monkeypatch.setattr(pexec, "_INFLUX_BATCH_LINES", batch)
    endpoint = f"http://127.0.0.1:{capture.server_port}"
    cfg = {"telemetry": True, "chunk": 16, "timeseries_every": 16}
    common = dict(run_id="influx", test_plan="network", test_case="ping-pong",
                  total_instances=8)
    posts, journals = {}, {}
    for pkg in ("jax", "torch"):
        if pkg == "jax":
            env = JEnvConfig.load(home=str(tmp_path / pkg))
            job = JRunInput(groups=[JRunGroup(id="all", instances=8, artifact_path=os.path.join(
                REF_PLANS, "network"))], env=env,
                runner_config=jexec.SimJaxConfig(shard=False, **cfg), **common)
            execute, writer = jexec.execute_sim_run, jdiscard()
        else:
            env = EnvConfig.load(home=str(tmp_path / pkg))
            job = RunInput(groups=[RunGroup(id="all", instances=8)], env=env,
                           runner_config=pexec.SimTorchConfig(device="cpu", **cfg),
                           **common)
            execute, writer = pexec.execute_sim_run, discard_writer()
        env.daemon.influxdb_endpoint = endpoint
        capture.posts.clear()
        out = execute(job, writer, threading.Event())
        posts[pkg] = list(capture.posts)
        journals[pkg] = {k: v for k, v in out.result.journal.items()
                         if k.startswith("influx")}
    assert [p for p, _ in posts["torch"]] == [p for p, _ in posts["jax"]]
    assert all(p == "/write?db=testground" for p, _ in posts["torch"])
    bases = set()
    for (_, pbody), (_, jbody) in zip(posts["torch"][:-1], posts["jax"][:-1]):
        plines, pbase = _rebased(pbody)
        jlines, _ = _rebased(jbody)
        assert plines == jlines
        bases.add(pbase)
    (_, pperf), (_, jperf) = posts["torch"][-1], posts["jax"][-1]
    assert _measurements(pperf) == _measurements(jperf)
    assert "results.network-ping-pong.sim.perf.peer_ticks_per_sec" in pperf
    bases.add(_rebased(pperf)[1])
    assert len(bases) == 1  # one base for the run's every family
    pperf_j, jperf_j = journals["torch"].pop("influx_perf"), journals["jax"].pop("influx_perf")
    assert pperf_j["ok"] and jperf_j["ok"]
    assert pperf_j["pushed"] == len(pperf.splitlines())
    assert journals["torch"] == journals["jax"]
    assert set(journals["torch"]) == {"influx", "influx_telemetry", "influx_latency"}
    assert all(j["ok"] for j in journals["torch"].values())
    assert len(posts["torch"]) >= 4
    if batch == 7:
        assert journals["torch"]["influx_telemetry"]["batches"] > 1
    text = "".join(b for _, b in posts["torch"])
    assert "results.network-ping-pong.sim.latency.p50" in text
    assert "results.network-ping-pong.sim.delivered" in text


def test_influx_mirror_failure_is_journaled_not_fatal(tmp_path, monkeypatch):
    """An endpoint that refuses every POST: the run still succeeds, and
    each family's block records the failure as the reference's does."""
    from testground_tpu_torch.api import RunGroup, RunInput
    from testground_tpu_torch.metrics import influx
    from testground_tpu_torch.rpc import discard_writer

    monkeypatch.setattr(influx, "_RETRY_BASE_SECS", 0.0)
    monkeypatch.setattr(influx, "_RETRY_JITTER_SECS", 0.0)
    env = EnvConfig.load(home=str(tmp_path))
    env.daemon.influxdb_endpoint = "http://127.0.0.1:9"  # nothing listens there
    job = RunInput(run_id="down", test_plan="network", test_case="ping-pong",
                   total_instances=4, groups=[RunGroup(id="all", instances=4)], env=env,
                   runner_config=pexec.SimTorchConfig(device="cpu", telemetry=True,
                                                      chunk=16, timeseries_every=16))
    out = pexec.execute_sim_run(job, discard_writer(), threading.Event())
    assert out.result.outcome.value == "success"
    j = out.result.journal
    assert not j["influx"]["ok"] and j["influx"]["attempts"] == 3
    assert j["influx_telemetry"]["aborted"] and j["influx_telemetry"]["batches"] == 1
    assert not j["influx_perf"]["ok"]


# --------------------------------------------------- helpers' copies


@pytest.mark.parametrize("fix", [False, True])
def test_healthcheck_helper_matches_jax(fix, tmp_path):
    """The same checks through both packages' ``Helper``: the same report."""
    from testground_tpu.healthcheck import Helper as JHelper
    from testground_tpu.healthcheck import checkers as jcheckers
    from testground_tpu.healthcheck import fixers as jfixers
    from testground_tpu_torch.healthcheck import Helper, checkers, fixers

    reports = []
    for helper, chk, fx, pkg in ((JHelper, jcheckers, jfixers, "jax"),
                                 (Helper, checkers, fixers, "torch")):
        missing = str(tmp_path / pkg / "outputs")
        h = helper()
        h.enlist("passes", lambda: (True, "fine"))
        h.enlist("fixable", chk.check_dir_writable(missing), fx.create_directory(missing))
        h.enlist("manual", lambda: (False, "broken"), fx.requires_manual_fixing("call x"))
        h.enlist("no-fixer", lambda: (False, "broken too"))

        def raises():
            raise OSError("probe failed")

        h.enlist("raises", raises)
        r = h.run_checks(fix)
        reports.append((r.ok(), json.loads(json.dumps(r.to_dict()).replace(pkg, "<pkg>")),
                        str(r).replace(pkg, "<pkg>")))
    assert reports[1] == reports[0]
    assert reports[1][0] is False


def test_trace_context_and_task_ids_match_jax(tmp_path):
    """A run task's lifecycle trace ids and its ID have the reference's
    forms: a 32-hex trace, 16-hex spans and 20 base32hex characters."""
    from testground_tpu import tracectx as jtrace
    from testground_tpu.engine.task import new_task_id as jnew_task_id
    from testground_tpu_torch.api import load_composition
    from testground_tpu_torch.engine.task import new_task_id
    from testground_tpu_torch.sim import telemetry as ptel

    for pmake, jmake in ((ptel.new_trace_id, jtrace.new_trace_id),
                         (ptel.new_span_id, jtrace.new_span_id)):
        got, want = pmake(), jmake()
        assert re.fullmatch(r"[0-9a-f]+", got) and len(got) == len(want)
    home = _make_home(tmp_path, "torch", PORT_ENV, ("placebo",))
    comp = home / "one-run.toml"
    comp.write_text(TWO_RUNS.format(runner="sim:torch").split("[[runs]]")[0])
    env = EnvConfig.load(home=str(home))
    manifest = pcommands._resolve_plan(env, "placebo")[1]
    engine = Engine.new_default(env)
    tsk = engine.get_task(engine.queue_run(load_composition(str(comp)), manifest))
    assert set(tsk.trace) == {"trace_id", "root_span_id", "queued_span_id"}
    assert re.fullmatch(r"[0-9a-f]{32}", tsk.trace["trace_id"])
    assert all(re.fullmatch(r"[0-9a-f]{16}", tsk.trace[k])
               for k in ("root_span_id", "queued_span_id"))
    for make in (new_task_id, jnew_task_id):
        ids = [make() for _ in range(50)]
        assert len(set(ids)) == 50
        assert all(re.fullmatch(r"[0-9a-v]{20}", i) for i in ids)


# ------------------------------------------------------------ build verbs

BUILD_CASES = {
    "composition": ["build", "composition", "-f", "{home}/one-run.toml", "--write-artifacts"],
    "single": ["build", "single", "placebo", "--builder", "sim:plan"],
    "single-case": ["build", "single", "placebo:ok", "--builder", "sim:plan"],
}


@pytest.mark.parametrize("name", list(BUILD_CASES))
def test_build_verbs_match_jax(name, tmp_path):
    """``build composition|single`` queue a build task, and ``build purge``
    removes its snapshots, as the reference's do: the same exit codes and
    lines, and the artifacts in the same places of each home."""
    got = {}
    for pkg, main, env, runner in (("jax", jmain, REF_ENV, "sim:jax"),
                                   ("torch", pmain, PORT_ENV, "sim:torch")):
        home = _make_home(tmp_path, pkg, env, ("placebo",))
        (home / "one-run.toml").write_text(TWO_RUNS.format(runner=runner).split("[[runs]]")[0])
        argv = [a.format(home=home) for a in BUILD_CASES[name]]
        rc, out, err = _cli(main, home, argv)
        m = re.search(r"build is queued with ID: (\S+)", out)
        assert m, out + err
        work = home / "data" / "work"
        built = sorted(p.name.replace(m[1], "<task>") for p in work.iterdir())
        written = "sim-plan--placebo-" in (home / "one-run.toml").read_text()
        prc, pout, _ = _cli(main, home, ["build", "purge", "-b", "sim:plan", "-p", "placebo"])
        left = sorted(p.name for p in work.iterdir())
        # the reference's build task also lints and precompiles into XLA's
        # cache, and logs both; the port has no such cache
        lines = [ln for ln in out.splitlines() if ln.startswith(
            ("build is queued", "sim:plan built", "group ", "finished build", "wrote"))]
        got[pkg] = _norm({"rc": rc, "lines": lines, "built": built,
                          "written": written, "purge": (prc, pout.splitlines()),
                          "left": left}, m[1], home)
    assert got["torch"] == got["jax"]
    port = got["torch"]
    assert port["rc"] == 0 and port["built"] == ["sim-plan--placebo-<task>-0"]
    assert "finished build with ID: <task> (outcome: success)" in port["lines"]
    assert port["purge"][0] == 0 and port["left"] == []
    assert port["written"] == (name == "composition")


# argv, and the ROADMAP item that refuses it; None for build --buckets,
# refused until shape buckets were ported, which now warms the ladder
UNPORTED_FLAGS = {
    "build-buckets": (["build", "single", "placebo:ok", "--buckets", "--run-cfg",
                       "bucket_ladder=4,8"], None),
    "collect-local-exec": (["collect", "sometask"], "item 16"),
}

# the fleet controller's verbs, refused until they were ported: what both
# packages print and exit with, in process
FLEET_VERBS = {
    "terminate-drain": ["terminate", "--drain"],
    "terminate-drain-with-runner": ["terminate", "--drain", "--runner", "{runner}"],
    "preempt": ["preempt", "sometask"],
}


@pytest.mark.parametrize("name", list(FLEET_VERBS))
def test_fleet_verb_matches_jax(name, tmp_path):
    got = {}
    for pkg, main, env, runner in (("jax", jmain, REF_ENV, "sim:jax"),
                                   ("torch", pmain, PORT_ENV, "sim:torch")):
        home = _make_home(tmp_path, pkg, env, ("placebo",))
        argv = [a.format(runner=runner) for a in FLEET_VERBS[name]]
        rc, out, err = _cli(main, home, argv)
        # the stderr lines past the log records (each package's logger)
        err = "".join(ln for ln in err.splitlines(True)
                      if not re.match(r"\d\d:\d\d:\d\d\t", ln))
        got[pkg] = (rc, out, err.replace("sim:jax", "sim:torch"))
    assert got["torch"] == got["jax"]
    rc, out, err = got["torch"]
    if name == "terminate-drain":
        assert rc == 0 and out.startswith("daemon drained: True"), out
    elif name == "preempt":
        assert rc == 1 and "preempt refused: unknown task sometask" in err, err
    else:
        assert rc == 1 and "takes no --runner/--builder" in err, err


@pytest.mark.parametrize("name", list(UNPORTED_FLAGS))
def test_unported_flag_is_refused_naming_its_item(name, tmp_path):
    argv, item = UNPORTED_FLAGS[name]
    home = _make_home(tmp_path, "torch", PORT_ENV, ("placebo",))
    rc, out, err = _cli(pmain, home, argv)
    if item is None:
        assert rc == 0 and "(outcome: success)" in out, err
        marker = home / "data" / "precompiled" / "buckets-placebo-ok.json"
        got = json.loads(marker.read_text())
        assert [b["bucket"] for b in got["buckets"]] == [4, 8] and got["ladder"] == [4, 8]
        return
    assert rc == 1 and err.startswith("error: ") and f"ROADMAP queue 1 {item}" in err, err
    assert not (home / "data" / "work").exists() or not os.listdir(home / "data" / "work")


# the reference's sim-worker flags, every one away from its default
SIM_WORKER_ARGV = ["sim-worker", "--coordinator", "10.0.0.1:4000", "--num-processes", "3",
                   "--process-id", "2", "--plans", "/plans", "--once",
                   "--connect-attempts", "5", "--connect-timeout", "7.5"]


# the reference's sync-service and sync-stats flags, every one away from
# its default
SYNC_ARGV = {
    "sync-service": ["sync-service", "--host", "0.0.0.0", "--port", "9042",
                     "--backend", "python", "--idle-timeout", "5",
                     "--evict-grace", "0.5", "--shards", "2",
                     "--metrics-port", "0", "--stats-interval", "0"],
    "sync-stats": ["sync-stats", "127.0.0.1:9042", "--json", "--timeout", "2",
                   "--watch", "0.5", "--watch-count", "3"],
}


@pytest.mark.parametrize("verb", ["sim-worker", "sync-service", "sync-stats"])
def test_unported_verb_is_refused_by_the_parser(verb, tmp_path, capsys):
    """The verbs argparse refused until they were ported parse the
    reference's flags into the reference's values: ``sim-worker`` (the
    cohort), plus ``--device`` (the card by default), and ``sync-service``
    and ``sync-stats`` (the sync service, item 17)."""
    from testground_tpu.cli.main import build_parser as jparser
    from testground_tpu_torch.cli.main import build_parser as pparser

    argv = SIM_WORKER_ARGV if verb == "sim-worker" else SYNC_ARGV[verb]
    ref, port = (vars(p().parse_args(argv)) for p in (jparser, pparser))
    if verb == "sim-worker":
        assert port.pop("device") is None
    assert {k: v for k, v in port.items() if k != "func"} == {
        k: v for k, v in ref.items() if k != "func"}
    assert port["func"].__name__ == ref["func"].__name__ == (
        verb.replace("-", "_") + "_cmd")


# the observability verbs on two runs of one composition in each package's
# home: what both print, the run IDs named alike; the trace and the
# matrix are the runs', so those views match line for line
OBSERVED = TWO_RUNS.split("[[runs]]")[0].replace(
    'case = "optional-failure"', 'case = "ok"').replace(
    "chunk = 8", "chunk = 8\ntelemetry = true\nnetmatrix = true").replace(
    "count = 4", 'count = 4\n[groups.run.trace]\ninstances = "0:2"')
OBS_VERBS = {
    "stats": ["stats", "{a}"],
    "perf": ["perf", "{a}"],
    "trace": ["trace", "{a}"],
    "watch": ["watch", "{a}", "--no-follow"],
    "netmap": ["netmap", "{a}", "--cut", "1"],
    "diff": ["diff", "{a}", "{b}", "--planes", "counters,latency,slo,netmatrix"],
    "top": ["top", "--no-follow"],
}
EXACT_VERBS = ("trace", "netmap")


@pytest.fixture(scope="module")
def observed_homes(tmp_path_factory):
    root = tmp_path_factory.mktemp("observed")
    out = {}
    for pkg, main, runner, env in (("jax", jmain, "sim:jax", REF_ENV),
                                   ("torch", pmain, "sim:torch", PORT_ENV)):
        home = _make_home(root, pkg, env, ("placebo",))
        (home / "obs.toml").write_text(OBSERVED.format(runner=runner))
        tids = []
        for _ in range(2):
            rc, out_, err = _cli(main, home, ["run", "composition", "-f",
                                              str(home / "obs.toml")])
            assert rc == 0, err
            tids.append(_task_id(out_))
        out[pkg] = (main, home, tids)
    return out


@pytest.mark.parametrize("verb", list(OBS_VERBS))
def test_observability_verb_prints_as_jax(verb, observed_homes):
    got = {}
    for pkg, (main, home, (a, b)) in observed_homes.items():
        argv = [x.format(a=a, b=b) for x in OBS_VERBS[verb]]
        rc, out, err = _cli(main, home, argv)
        text = out.replace(a, "<a>").replace(b, "<b>")
        lines = text.splitlines()
        got[pkg] = (rc, lines if verb in EXACT_VERBS else
                    [ln.split()[0] for ln in lines if ln.strip()
                     # the rows of the reference's compile pass, which the
                     # port has not (sim/perf.py)
                     and ln.split()[0] not in ("cost", "program")])
    assert got["torch"] == got["jax"]
    assert got["torch"][0] == 0 and got["torch"][1]
