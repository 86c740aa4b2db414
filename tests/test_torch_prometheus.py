"""The port's Prometheus exposition (``metrics/prometheus.py``) against the
reference's, on the CPU: one composition runs through each package's CLI
(the reference's ``tg`` with ``sim:jax``, the port's with ``sim:torch`` on
the CPU), both archived tasks go into each package's own task store, and
each package's ``render_prometheus`` of its store must be the same text,
byte for byte. Then the per-task bound and its elision gauge, the guard
that keeps NaN and Inf out of the text, the fleet conservation (Σ
``tg_fleet_tasks`` = ``tg_scrape_tasks_total``) and the flow identity of a
port run (``sent = delivered + in_flight + dropped + rejected +
fault_dropped``).
"""

import json
import math
import re

import pytest

from test_torch_cli import PORT_ENV, REF_ENV, _cli, _jax_task, _make_home, _port_task, jmain, pmain
from testground_tpu.engine import Task as JTask
from testground_tpu.engine import TaskStorage as JTaskStorage
from testground_tpu.metrics.prometheus import render_prometheus as jrender
from testground_tpu_torch.engine import Task, TaskStorage
from testground_tpu_torch.metrics.prometheus import CONTENT_TYPE, render_prometheus

# telemetry, the traffic matrix and one SLO rule, so the flow, SLO and
# net-pair families all render; the port's run also carries the phase
# ledger (tg_phase_*)
COMP = """[global]
plan = "network"
case = "ping-pong"
builder = "sim:plan"
runner = "{runner}"

[global.run_config]
chunk = 16
telemetry = true
netmatrix = true
{extra}

[[global.run.slo]]
name = "delivers"
metric = "delivered_per_tick"
op = ">="
threshold = 0.0
window_ticks = 16
severity = "warn"

[[groups]]
id = "all"
[groups.instances]
count = 8
[groups.run.test_params]
latency_ms = "4"
latency2_ms = "2"
"""

# one family line: name{labels} value (format 0.0.4)
LINE = re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})? (\S+)$')

# a fleet snapshot with every key Engine.fleet_info gives, the histogram
# bins filled
FLEET = {
    "workers": {"total": 2, "busy": 1},
    "queue_wait_bins": [0, 1, 2, 0],
    "queue_wait_total_us": 17.5,
    "claim_latency_bins": [1, 0, 0, 3],
    "claim_latency_total_us": 9,
    "pack": {"packed": 0, "packed_runs": 0, "solo": {}},
    "preemptions": 0,
    "evictions": 0,
    "refused": 3,
    "draining": False,
}


@pytest.fixture(scope="module")
def tasks(tmp_path_factory):
    """Each package's archived task of one run of COMP, as a dict."""
    root = tmp_path_factory.mktemp("prom")
    out = {}
    for pkg, main, env, runner, extra in (
        ("jax", jmain, REF_ENV, "sim:jax", ""),
        ("torch", pmain, PORT_ENV, "sim:torch", "phases = true"),
    ):
        home = _make_home(root, pkg, env, ("network",))
        (home / "comp.toml").write_text(COMP.format(runner=runner, extra=extra))
        rc, stdout, err = _cli(main, home, ["run", "composition", "-f", str(home / "comp.toml")])
        assert rc == 0, err
        tid = re.search(r"run is queued with ID: (\S+)", stdout)[1]
        get = _jax_task if pkg == "jax" else _port_task
        out[pkg] = get(home, tid).to_dict()
    return out


def _families(text):
    """The exposition parsed: family → [(labels, value)]; every line is a
    HELP, a TYPE or a sample with a finite value."""
    fams = {}
    for ln in text.splitlines():
        if ln.startswith(("# HELP ", "# TYPE ")) or not ln:
            continue
        m = LINE.match(ln)
        assert m, ln
        v = float(m[3])
        assert math.isfinite(v), ln
        fams.setdefault(m[1], []).append((m[2] or "", v))
    return fams


def _stored(pkg, tmp_path, task_dicts):
    """The tasks put into the package's own store, read back newest first."""
    cls, storage = (JTask, JTaskStorage) if pkg == "jax" else (Task, TaskStorage)
    store = storage(str(tmp_path / f"{pkg}.db"))
    for d in task_dicts:
        store.archive(cls.from_dict(d))
    return store.archived()


@pytest.mark.parametrize("fleet", [None, FLEET], ids=["no-fleet", "fleet"])
def test_render_matches_jax_byte_for_byte(fleet, tasks, tmp_path):
    rows = [tasks["jax"], tasks["torch"]]
    port = render_prometheus(_stored("torch", tmp_path, rows), per_task_limit=200, fleet=fleet)
    ref = jrender(_stored("jax", tmp_path, rows), per_task_limit=200, fleet=fleet)
    assert port == ref
    fams = _families(port)
    # not vacuous: both tasks' flow, SLO, matrix and (port) phase series
    assert len({lbl for lbl, _ in fams["tg_run_msgs_total"]}) == 2 * 7
    assert {"tg_slo_breaches_total", "tg_net_pair_msgs_total", "tg_phase_bytes_accessed",
            "tg_run_peer_ticks_per_second", "tg_transport_resolved"} <= set(fams)
    assert ("tg_fleet_queue_wait_seconds_bucket" in port) == (fleet is not None)
    assert CONTENT_TYPE == "text/plain; version=0.0.4; charset=utf-8"


def test_flow_identity_of_a_port_run(tasks):
    text = render_prometheus([Task.from_dict(tasks["torch"])])
    flows = {re.search(r'flow="(\w+)"', lbl)[1]: v
             for lbl, v in _families(text)["tg_run_msgs_total"]}
    assert flows["sent"] > 0
    assert flows["sent"] == (flows["delivered"] + flows["in_flight"] + flows["dropped"]
                             + flows["rejected"] + flows["fault_dropped"])


@pytest.mark.parametrize("limit", [0, 1, 2, 5])
def test_per_task_limit_elides_loudly(limit, tasks, tmp_path):
    rows = [tasks["torch"]] * 3
    stored = [Task.from_dict({**d, "id": f"t{i}"}) for i, d in enumerate(rows)]
    got = {pkg: fn(stored if pkg == "torch" else
                   [JTask.from_dict(t.to_dict()) for t in stored], per_task_limit=limit)
           for pkg, fn in (("torch", render_prometheus), ("jax", jrender))}
    assert got["torch"] == got["jax"]
    fams = _families(got["torch"])
    shown = min(limit, 3)
    assert fams["tg_scrape_tasks_total"] == [("", 3.0)]
    assert fams["tg_scrape_tasks_elided"] == [("", float(3 - shown))]
    tasks_seen = {re.search(r'task="(\w+)"', lbl)[1]
                  for lbl, _ in fams.get("tg_run_msgs_total", [])}
    assert tasks_seen == {f"t{i}" for i in range(shown)}
    # the aggregate counts cover the whole store, whatever the bound
    assert sum(v for _, v in fams["tg_tasks"]) == 3


@pytest.mark.parametrize("bad", [math.nan, math.inf, -math.inf, "12", None])
def test_non_finite_values_never_reach_the_text(bad, tasks):
    d = json.loads(json.dumps(tasks["torch"]))
    sim = d["result"]["journal"]["sim"]
    sim["msgs_sent"] = bad
    sim["wall_secs"] = bad
    d["result"]["perf"]["queued_secs"] = bad
    text = render_prometheus([Task.from_dict(d)], fleet={**FLEET, "refused": bad})
    assert text == jrender([JTask.from_dict(d)], fleet={**FLEET, "refused": bad})
    for token in ("nan", "inf", "NaN", "Inf"):
        assert not re.search(rf" -?{token}$", text, re.M | re.I)
    fams = _families(text)
    assert 'flow="sent"' not in "".join(lbl for lbl, _ in fams["tg_run_msgs_total"])
    assert "tg_run_wall_seconds" not in fams and "tg_task_queued_seconds" not in fams
    assert "tg_fleet_refused_total" not in fams


def test_fleet_conservation(tasks, tmp_path):
    """Σ tg_fleet_tasks over the states = tg_scrape_tasks_total, over the
    whole store even where the per-task series are cut."""
    stored = [Task.from_dict({**tasks[pkg], "id": f"{pkg}{i}"})
              for i in range(3) for pkg in ("jax", "torch")]
    text = render_prometheus(stored, per_task_limit=1, fleet=FLEET)
    fams = _families(text)
    assert sum(v for _, v in fams["tg_fleet_tasks"]) == fams["tg_scrape_tasks_total"][0][1] == 6
    assert fams["tg_fleet_workers"] == [('{state="busy"}', 1.0), ('{state="idle"}', 1.0)]


def test_empty_store_renders_the_scrape_gauges_only():
    assert render_prometheus([]) == jrender([])
    assert set(_families(render_prometheus([]))) == {"tg_scrape_tasks_total",
                                                     "tg_scrape_tasks_elided"}
