"""The network plan's exec edition and the benchmarks plan's last files on
the port, on the CPU, against the reference:

- ``network:ping-pong`` as real processes (``exec:py`` / ``local:exec``):
  real TCP between the instances, their addresses exchanged through the
  sync service, at 2, 4 and 3 instances on each package's engine with its
  own plan copy, with equal results; the dialer's two ``round N rtt``
  lines; a sim-only case failing cleanly; and ping-pong at 2 in the 2 × 2
  mix of runner and plan copy;
- ``benchmarks/_compositions/flood-bucketed.toml`` on ``sim:torch``
  (buckets and a pack of one) against the reference's exact-N run of the
  same groups (a bucketed or packed reference run is no oracle: ROADMAP
  R1, R2);
- ``benchmarks/grafana-dashboard/dashboard.json``: every measurement it
  queries is one the port's ``measurement_name`` gives a benchmarks case.

The copies themselves are pinned in ``test_torch_sdk.py``.
"""

import io
import json
import os
import re
import tarfile
import threading

import pytest

from test_torch_local_exec import PKG, PLANS, _mod, engines, make_engine, run  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PYTHON_SYNC = {"sync_service": "python"}
RTT = re.compile(r"round (\d) rtt: ([0-9.]+) ms")


def _run_outs(engine, task) -> dict:
    """Each instance's ``run.out`` from the run's ``collect`` tarball."""
    buf = io.BytesIO()
    engine.do_collect_outputs("local:exec", task.id, buf, None)
    buf.seek(0)
    out = {}
    with tarfile.open(fileobj=buf, mode="r:gz") as tar:
        for m in tar.getmembers():
            if m.name.endswith("run.out"):
                out[m.name.split("/", 1)[1]] = tar.extractfile(m).read().decode()
    return out


def _ping_pong(engine, pkg, n, plan_pkg=None, case="ping-pong"):
    task = run(engine, pkg, "network", case, [("all", n, "exec:py")], plan_pkg=plan_pkg,
               run_config=PYTHON_SYNC)
    outs = _run_outs(engine, task)
    rounds = sorted(int(r) for text in outs.values() for r, _ in RTT.findall(text))
    rtts = [float(ms) for text in outs.values() for _, ms in RTT.findall(text)]
    return task, {"outcome": task.outcome().value, "outcomes": task.result["outcomes"],
                  "instances": sorted(outs), "rounds": rounds}, rtts


@pytest.mark.parametrize("n", [2, 4, 3])
def test_ping_pong_on_real_sockets_equals_the_reference(engines, n):  # noqa: F811
    """Real TCP ping-pong between ``n`` processes: both packages' runs
    succeed alike, each dialer measures two rounds (a third, odd instance
    runs solo)."""
    got = {}
    for pkg, (engine, _) in engines.items():
        task, got[pkg], rtts = _ping_pong(engine, pkg, n)
        assert got[pkg]["outcome"] == "success", task.error
        assert all(0.0 < ms < 5000.0 for ms in rtts), rtts
    assert got["torch"] == got["jax"]
    assert got["torch"]["outcomes"] == {"all": {"total": n, "ok": n}}
    assert got["torch"]["instances"] == [f"all/{i}/run.out" for i in range(n)]
    # one dialer a pair, two rounds each
    assert got["torch"]["rounds"] == sorted([1, 2] * (n // 2))


def test_the_dialer_prints_two_rtt_lines(engines):  # noqa: F811
    engine, _ = engines["torch"]
    task, _, rtts = _ping_pong(engine, "torch", 2)
    assert task.outcome().value == "success", task.error
    text = "".join(_run_outs(engine, task).values())
    assert [r for r, _ in RTT.findall(text)] == ["1", "2"]
    assert len(rtts) == 2


@pytest.mark.parametrize("case", ["traffic-allowed", "pingpong-sustained"])
def test_a_sim_only_case_fails_cleanly_on_local_exec(engines, case):  # noqa: F811
    """A case the exec edition has no code for fails with its pointer,
    as the reference's does, never with exit 2."""
    got = {}
    for pkg, (engine, _) in engines.items():
        task, got[pkg], _ = _ping_pong(engine, pkg, 2, case=case)
        assert got[pkg]["outcome"] == "failure", task.error
        text = "".join(_run_outs(engine, task).values())
        assert "has no exec edition" in text
    assert got["torch"] == got["jax"]
    assert got["torch"]["outcomes"] == {"all": {"total": 2, "ok": 0}}


@pytest.fixture(scope="module")
def mix_engines(tmp_path_factory):
    homes = {pkg: tmp_path_factory.mktemp(f"netmix-{pkg}") for pkg in PKG}
    got = {pkg: make_engine(pkg, home) for pkg, home in homes.items()}
    yield got
    for e in got.values():
        e.stop()


@pytest.mark.parametrize("plan_pkg", ["jax", "torch"])
@pytest.mark.parametrize("runner_pkg", ["jax", "torch"])
def test_ping_pong_on_every_runner_and_plan_copy(mix_engines, runner_pkg, plan_pkg):
    """Either package's runner runs either package's plan copy: an
    instance of either SDK against the sync service either runner
    booted."""
    task, got, rtts = _ping_pong(mix_engines[runner_pkg], runner_pkg, 2, plan_pkg=plan_pkg)
    assert got["outcome"] == "success", task.error
    assert got["outcomes"] == {"all": {"total": 2, "ok": 2}}
    assert got["rounds"] == [1, 2] and len(rtts) == 2


def test_the_port_manifest_enables_the_exec_edition():
    from testground_tpu_torch.api import TestPlanManifest

    m = TestPlanManifest.load_file(os.path.join(PLANS["torch"], "network", "manifest.toml"))
    assert m.defaults == {"builder": "sim:plan", "runner": "sim:torch"}
    assert set(m.builders) == {"sim:plan", "exec:py"}
    assert set(m.runners) == {"sim:torch", "local:exec"}


# ------------------------------------------------ flood-bucketed on sim:torch


def test_flood_bucketed_composition_equals_the_references_exact_run(tmp_path):
    """The checked-in bucketed flood composition (buckets, a pack of one,
    telemetry) on ``sim:torch`` gives the reference's exact-N results of
    the same groups: every instance's outcome, the flow totals and the
    telemetry stream's totals."""
    from testground_tpu.api import RunGroup as JRunGroup
    from testground_tpu.api import RunInput as JRunInput
    from testground_tpu.config import EnvConfig
    from testground_tpu.rpc import discard_writer as jdiscard
    from testground_tpu.sim import executor as jexec
    from testground_tpu_torch.api import OutputsEnv, RunGroup, RunInput, load_composition
    from testground_tpu_torch.rpc import discard_writer
    from testground_tpu_torch.sim import executor as pexec

    comp = load_composition(os.path.join(PLANS["torch"], "benchmarks", "_compositions",
                                         "flood-bucketed.toml"))
    assert comp.global_.runner == "sim:torch"
    cfg = dict(comp.global_.run_config)
    assert (cfg["bucket"], cfg["pack"], cfg["bucket_ladder"]) == ("auto", True, "64,256")
    run0 = comp.runs[0]
    layout = [(g.id, g.instances.count, dict(run0.groups[i].test_params))
              for i, g in enumerate(comp.groups)]
    common = dict(run_id="run-fb", test_plan=comp.global_.plan, test_case=comp.global_.case,
                  total_instances=sum(n for _, n, _ in layout))
    exact = {k: v for k, v in cfg.items()
             if k not in ("bucket", "bucket_ladder", "pack")}
    jjob = JRunInput(
        groups=[JRunGroup(id=i, instances=n, parameters=p,
                          artifact_path=os.path.join(PLANS["jax"], "benchmarks"))
                for i, n, p in layout],
        env=EnvConfig.load(home=str(tmp_path / "jax")),
        runner_config=jexec.SimJaxConfig(**exact), **common)
    pjob = RunInput(
        groups=[RunGroup(id=i, instances=n, parameters=p,
                         artifact_path=pexec.plan_dir("benchmarks")) for i, n, p in layout],
        env=OutputsEnv(tmp_path / "torch"),
        runner_config=pexec.SimTorchConfig(device="cpu", **cfg), **common)
    jout = jexec.execute_sim_run(jjob, jdiscard(), threading.Event())
    pout = pexec.execute_sim_run(pjob, discard_writer(), threading.Event())
    jj, pj = jout.result.journal, pout.result.journal
    assert pj["sim"]["bucket"]["padded_instances"] == 64
    assert pj["sim"]["bucket"]["instances"] == 10
    assert pout.result.outcome == jout.result.outcome
    assert pj["events"] == jj["events"] == {"pairs": {
        "incomplete": 0, "success": 10, "failure": 0, "crash": 0}}
    assert pj["telemetry"]["totals"] == jj["telemetry"]["totals"]
    for key in ("msgs_sent", "msgs_delivered", "msgs_enqueued", "msgs_dropped",
                "msgs_rejected", "ticks"):
        assert pj["sim"][key] == jj["sim"][key], key
    assert pj["sim"]["msgs_delivered"] > 0


# ------------------------------------------------------- the Grafana dashboard


def _emitted_measurements():
    """Every measurement name the port's benchmarks cases give through the
    InfluxDB mirror (``tests/test_grafana_dashboard.py``'s list, named by
    the port's ``measurement_name``)."""
    from testground_tpu_torch.metrics.viewer import measurement_name
    from testground_tpu_torch.plans.benchmarks.sim import SUBTREE_SIZES

    per_case = {
        "barrier": [f"barrier_time_{p}_percent" for p in (20, 40, 60, 80, 100)],
        "netinit": ["time_to_network_init_ticks"],
        "netlinkshape": ["time_to_shape_network_ticks", "shaped_latency_ticks"],
        "subtree": [f"subtree_time_{s}_bytes_{d}_ticks"
                    for s in SUBTREE_SIZES for d in ("publish", "receive")],
        "storm": ["storm.bytes_sent", "storm.bytes_read"],
        "pingpong-flood": ["flood.rounds"],
    }
    return {measurement_name("benchmarks", case, m)
            for case, metrics in per_case.items() for m in metrics}


def test_the_port_dashboard_queries_only_measurements_the_port_emits():
    from testground_tpu.metrics.viewer import measurement_name as jname
    from testground_tpu_torch.metrics.viewer import measurement_name as pname

    path = os.path.join(PLANS["torch"], "benchmarks", "grafana-dashboard", "dashboard.json")
    with open(path) as f:
        dash = json.load(f)
    assert dash["panels"]
    queried = {m for panel in dash["panels"] for target in panel.get("targets", [])
               for m in re.findall(r'FROM\s+"([^"]+)"', target.get("query", ""))}
    assert queried
    emitted = _emitted_measurements()
    assert queried <= emitted, queried - emitted
    assert all(pname("benchmarks", "storm", m) == jname("benchmarks", "storm", m)
               for m in ("storm.bytes_sent", "x"))
