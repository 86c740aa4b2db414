"""The port's dashboard tier against the reference's, on the CPU: the
``metrics.Viewer`` over a run directory of each package, and the daemon
routes ``/``, ``/dashboard``, ``/dashboard?task_id=``, ``/data`` and
``/metrics`` of both packages' daemons over twin homes (one home copied:
the same task store and run outputs, holding a run of each package). The
pages must be equal byte for byte; the only difference between the homes
is their path, which no page shows.
"""

import json
import os
import re
import shutil
import urllib.error
import urllib.request

import pytest

from test_torch_cli import PORT_ENV, REF_ENV, _cli, _jax_task, _make_home, jmain, pmain
from testground_tpu.config import EnvConfig as JEnvConfig
from testground_tpu.daemon import Daemon as JDaemon
from testground_tpu.metrics import Viewer as JViewer
from testground_tpu_torch.config import EnvConfig
from testground_tpu_torch.daemon import Daemon
from testground_tpu_torch.engine import TaskStorage
from testground_tpu_torch.metrics import Viewer

COMP = """[global]
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


def _run(main, home, runner):
    (home / "comp.toml").write_text(COMP.format(runner=runner))
    rc, out, err = _cli(main, home, ["run", "composition", "-f", str(home / "comp.toml")])
    assert rc == 0, err
    return re.search(r"run is queued with ID: (\S+)", out)[1]


@pytest.fixture(scope="module")
def site(tmp_path_factory):
    """A port home holding a run of each package (the reference's task and
    run directory moved in), its twin, and a daemon of each package on one
    of them; stopped in teardown."""
    root = tmp_path_factory.mktemp("dash")
    ref_home = _make_home(root, "jax", REF_ENV, ("network",))
    jtid = _run(jmain, ref_home, "sim:jax")
    home = _make_home(root, "torch", PORT_ENV, ("network",))
    ptid = _run(pmain, home, "sim:torch")
    shutil.copytree(ref_home / "data" / "outputs" / "network" / jtid,
                    home / "data" / "outputs" / "network" / jtid)
    store = TaskStorage(str(home / "tasks.db"))
    from testground_tpu_torch.engine import Task

    store.archive(Task.from_dict(_jax_task(ref_home, jtid).to_dict()))
    store.close()
    twin = root / "twin"
    shutil.copytree(home, twin)
    daemons = {}
    try:
        daemons["torch"] = Daemon(env=EnvConfig.load(home=str(home)), listen="127.0.0.1:0")
        daemons["jax"] = JDaemon(env=JEnvConfig.load(home=str(twin)), listen="127.0.0.1:0")
        for d in daemons.values():
            d.start()
        yield {"home": home, "ref_home": ref_home, "tids": {"jax": jtid, "torch": ptid},
               "ep": {k: d.address for k, d in daemons.items()}}
    finally:
        for d in daemons.values():
            d.stop()


def _get(ep, route):
    """(status, content type, body) of a GET, redirects not followed."""

    class NoRedirect(urllib.request.HTTPRedirectHandler):
        def redirect_request(self, *a, **k):
            return None

    opener = urllib.request.build_opener(NoRedirect)
    try:
        with opener.open(ep + route, timeout=30) as r:
            return r.status, r.headers.get("Content-Type"), r.headers.get("Location"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.headers.get("Location"), e.read()


@pytest.mark.parametrize("run_of", ["jax", "torch"])
def test_viewer_matches_jax(run_of, site):
    """The Viewer's measurements, tags and rows over one run directory of
    each package."""
    home = site["ref_home"] if run_of == "jax" else site["home"]
    tid = site["tids"][run_of]
    port = Viewer(EnvConfig.load(home=str(home)))
    ref = JViewer(JEnvConfig.load(home=str(home)))
    for run_id in (None, tid):
        ms = port.get_measurements("network", "ping-pong", run_id=run_id, limit=100)
        assert ms == ref.get_measurements("network", "ping-pong", run_id=run_id, limit=100)
        got = {k: [r.to_dict() for r in v]
               for k, v in port.get_all_data("network", "ping-pong", run_id).items()}
        want = {k: [r.to_dict() for r in v]
                for k, v in ref.get_all_data("network", "ping-pong", run_id).items()}
        assert got == want
    assert port.get_tags(ms[0]) == ref.get_tags(ms[0]) == []
    # not vacuous: the plan metrics, the counters, the latency and the perf rows
    names = set(got)
    assert {"sim.delivered", "sim.live", "sim.latency.p50"} <= names
    assert any(n.startswith("sim.perf.") for n in names)
    assert [r.to_dict() for r in port.get_data("network", "ping-pong", "sim.delivered", tid)] \
        == got["sim.delivered"]


def _routes(site):
    routes = ["/", "/dashboard", "/dashboard?task_id=nope", "/metrics",
              "/data?task_id=nope&metric=sim.delivered"]
    for tid in site["tids"].values():
        routes += [f"/dashboard?task_id={tid}",
                   f"/data?task_id={tid}&metric=sim.delivered",
                   f"/data?task_id={tid}&metric=results.network-ping-pong.sim.live",
                   f"/data?task_id={tid}&metric="]
    return routes


def test_pages_match_jax_byte_for_byte(site):
    for route in _routes(site):
        got = {pkg: _get(ep, route) for pkg, ep in site["ep"].items()}
        assert got["torch"] == got["jax"], route
    code, _, where, body = _get(site["ep"]["torch"], "/")
    assert (code, where, body) == (302, "/dashboard", b"")
    code, ctype, _, page = _get(site["ep"]["torch"], "/dashboard")
    assert code == 200 and ctype == "text/html; charset=utf-8"
    assert all(f"/dashboard?task_id={t}" in page.decode() for t in site["tids"].values())
    assert _get(site["ep"]["torch"], "/dashboard?task_id=nope")[0] == 404


@pytest.mark.parametrize("run_of", ["jax", "torch"])
def test_task_page_and_data_rows_read_the_viewer(run_of, site):
    tid = site["tids"][run_of]
    ep = site["ep"]["torch"]
    code, _, _, page = _get(ep, f"/dashboard?task_id={tid}")
    page = page.decode()
    assert code == 200 and "<h2>results.network-ping-pong.sim.delivered</h2>" in page
    assert f'/artifact?task_id={tid}&amp;run={tid}&amp;name=sim_timeseries.jsonl' in page
    viewer = Viewer(EnvConfig.load(home=str(site["home"])))
    for metric in ("sim.delivered", "sim.latency.p95"):
        code, _, _, body = _get(ep, f"/data?task_id={tid}&metric={metric}")
        doc = json.loads(body)
        assert code == 200 and doc["measurement"] == f"results.network-ping-pong.{metric}"
        want = [r.to_dict() for r in viewer.get_data("network", "ping-pong", metric, tid)]
        assert doc["rows"] == want and want
    assert _get(ep, f"/data?task_id={tid}&metric=")[0] == 400


@pytest.mark.parametrize("limit", [0, 1, -4])
def test_metrics_honours_metrics_task_limit_as_jax(limit, site, tmp_path):
    """``[daemon] metrics_task_limit`` in each twin's ``.env.toml``: 0 and a
    negative limit take the 200-task default, 1 elides one task."""
    got = {}
    for pkg, cls, env_cls in (("torch", Daemon, EnvConfig), ("jax", JDaemon, JEnvConfig)):
        home = tmp_path / pkg
        shutil.copytree(site["home"], home)
        with open(home / ".env.toml", "a") as f:
            f.write(f"[daemon]\nmetrics_task_limit = {limit}\n")
        env = env_cls.load(home=str(home))
        assert env.daemon.metrics_task_limit == max(0, limit)
        d = cls(env=env, listen="127.0.0.1:0")
        d.start()
        try:
            got[pkg] = _get(d.address, "/metrics")
        finally:
            d.stop()
    assert got["torch"] == got["jax"]
    text = got["torch"][3].decode()
    assert "tg_scrape_tasks_total 2" in text
    assert f"tg_scrape_tasks_elided {1 if limit == 1 else 0}" in text
    assert len(set(re.findall(r'tg_run_ticks\{task="(\w+)"', text))) == (1 if limit == 1 else 2)


def test_home_paths_never_reach_a_page(site):
    for route in _routes(site):
        assert str(site["home"]).encode() not in _get(site["ep"]["torch"], route)[3], route
    assert os.path.isdir(site["home"] / "data" / "outputs" / "network" / site["tids"]["jax"])
