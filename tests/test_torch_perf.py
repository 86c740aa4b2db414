"""The port's perf ledger and profiler capture (``sim/perf.py``, the
executor's ``perf``, ``profile`` and ``profile_chunks``) against the JAX
package's, on the CPU:

- the ledger itself: its rows sum to ``execute.wall_secs``, the steady
  window leaves the warm-up chunks out, ``series.rows`` counts the rows,
  an unwritable path never fails the run, the CPU has no ``hbm`` block,
  and the memory probe reads the card's allocator counters (a fake card
  here) and never raises;
- ``SimProgram.run``'s hook: the same ``on_chunk`` calls as the
  reference's engine makes;
- parity: a placebo run and a 64-instance sustained run through both
  executors with their default ``perf``: the ``sim.perf`` blocks have the
  same keys (the reference's compile pass aside: the port has none) and
  the same host-side counts, ``sim_perf.jsonl`` the same rows and keys,
  and the log line its count of chunks; ``perf = false`` and
  ``disable_metrics`` write neither;
- no added sync and no added op: with the ledger on, a run dispatches the
  same ops and reads tensors on the host as often as with it off (the
  zero-overhead harness of ``tests/test_torch_telemetry.py``);
- the profiler: ``profile`` (the whole run) and ``profile_chunks`` write a
  Chrome trace under ``profiles/`` and a ``profile`` journal block with the
  reference's keys and ticks.
"""

import json
import os
import re
import threading

import pytest
import torch

from test_torch_engine import jax_program, port_program
from test_torch_executor import COMPILE_DERIVED, PERF_ROW_FIELDS, REF_PLANS
from test_torch_telemetry import _CountOps
from testground_tpu.api import RunGroup as JRunGroup
from testground_tpu.api import RunInput as JRunInput
from testground_tpu.config import EnvConfig
from testground_tpu.sim import executor as jexec
from testground_tpu_torch.api import OutputsEnv, RunGroup, RunInput
from testground_tpu_torch.sim import executor as pexec
from testground_tpu_torch.sim.engine import SimProgram, build_groups
from testground_tpu_torch.sim.perf import PERF_FILE, PerfLedger, device_memory_stats


def perf_view(sim: dict) -> dict:
    """The journal's ``sim.perf`` block as both packages must agree on it:
    its keys and each nested block's, the compile pass's aside; its
    host-side counts; and its transport, which must be the one the run's
    ``sim.transport`` block says ran. On a mesh the steady window is left
    out: the reference keeps a second chunk out of it there (its sharding
    retrace), the port, which has none, one."""
    perf = sim["perf"]
    ex = perf.get("execute", {})
    view = {
        "keys": {k: sorted(set(v) - COMPILE_DERIVED) if isinstance(v, dict) else None
                 for k, v in perf.items() if k not in COMPILE_DERIVED},
        "instances": perf["instances"], "chunk": perf["chunk"],
        "transport_ran": perf["transport"] == sim["transport"]["resolved"],
        "chunks": ex.get("chunks"), "ticks": ex.get("ticks"),
        "steady_chunks": ex.get("steady_chunks"),
        "series": perf["series"],
    }
    if "mesh" in sim:
        view["keys"]["execute"] = [k for k in view["keys"]["execute"]
                                   if not k.startswith("steady_")]
        del view["steady_chunks"]
    return view


# ------------------------------------------------------------- the ledger


def test_rows_sum_to_the_execute_wall_and_the_steady_window_skips_warmup(tmp_path):
    path = tmp_path / PERF_FILE
    ledger = PerfLedger(4, 10, ident={"run": "r"}, path=str(path), warmup=1)
    walls = [1.0, 0.5, 0.25, 0.25]
    for i, w in enumerate(walls):
        ledger.on_chunk(i, 10 * (i + 1), 10, w)
    ledger.close()
    s = ledger.summary()
    rows = [json.loads(ln) for ln in path.read_text().splitlines()]
    assert len(rows) == s["series"]["rows"] == s["execute"]["chunks"] == 4
    assert abs(sum(r["wall_secs"] for r in rows) - s["execute"]["wall_secs"]) < 1e-5 * 4
    assert s["execute"]["ticks"] == 40
    assert s["execute"]["steady_chunks"] == 3 and s["execute"]["steady_wall_secs"] == 1.0
    assert s["execute"]["steady_ticks_per_sec"] == 30.0
    assert s["execute"]["steady_peer_ticks_per_sec"] == 120.0
    assert s["series"]["file"] == PERF_FILE
    assert rows[1] == {"run": "r", "tick": 20, "chunk": 1, "transport": "plain",
                       "wall_secs": 0.5, "ticks_per_sec": 20.0, "peer_ticks_per_sec": 80.0}


def test_warmup_only_run_has_no_steady_window():
    ledger = PerfLedger(4, 10, warmup=1)
    ledger.on_chunk(0, 10, 10, 0.5)
    ex = ledger.summary()["execute"]
    assert ex["chunks"] == 1 and "steady_chunks" not in ex


def test_unwritable_path_never_fails_and_only_counts(tmp_path):
    ledger = PerfLedger(2, 8, path=str(tmp_path / "missing" / PERF_FILE))
    ledger.on_chunk(0, 8, 8, 0.1)
    ledger.close()
    s = ledger.summary()
    assert ledger.path is None and s["series"] == {"rows": 1}


def test_no_hbm_block_on_the_cpu():
    ledger = PerfLedger(2, 8, device=torch.device("cpu"))
    ledger.on_chunk(0, 8, 8, 0.1)
    s = ledger.summary()
    assert "hbm" not in s and device_memory_stats("cpu") == {}
    assert device_memory_stats(object()) == {}  # never raises


def test_memory_probe_reads_the_card_allocator(monkeypatch):
    """On a card the probe reads the caching allocator's host-side
    counters and the card's total memory, with the reference's keys; the
    ledger keeps the peak and the limit."""
    stats = {"allocated_bytes.all.current": 3 << 20, "allocated_bytes.all.peak": 5 << 20}
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda d=None: dict(stats))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d=None: type("P", (), {"total_memory": 80 << 30})())
    card = torch.device("cuda", 0)
    assert device_memory_stats(card) == {"bytes_in_use": 3 << 20,
                                         "peak_bytes_in_use": 5 << 20,
                                         "bytes_limit": 80 << 30}
    ledger = PerfLedger(2, 8, device=card, transport="cuda")
    ledger.on_chunk(0, 8, 8, 0.1)
    assert ledger.summary()["hbm"] == {"peak_bytes": 5 << 20, "bytes_limit": 80 << 30}


class _Recorder:
    """A ledger stand-in recording each call (``wants_aot`` off: the
    reference's engine then skips its compile pass)."""

    wants_aot = False

    def __init__(self):
        self.calls = []

    def on_chunk(self, index, ticks, ticks_delta, wall_secs):
        assert wall_secs > 0
        self.calls.append((index, ticks, ticks_delta))


@pytest.mark.parametrize("chunk", [8, 16])
def test_run_hook_calls_match_jax(chunk):
    """``SimProgram.run(perf=...)`` calls ``on_chunk`` once a chunk with the
    reference's index, ticks and delta."""
    calls = []
    for prog in (jax_program("pingpong-sustained", 8, {"duration_ticks": "40"}, chunk),
                 port_program("pingpong-sustained", 8, {"duration_ticks": "40"}, chunk)):
        rec = _Recorder()
        prog.run(seed=0, max_ticks=64, perf=rec)
        calls.append(rec.calls)
    assert calls[1] == calls[0] and len(calls[0]) > 2


# ------------------------------------------------- parity with the reference

# name: (plan, case, instances, params, runner config)
PARITY = {
    "placebo": ("placebo", "ok", 4, {}, {"chunk": 8}),
    "sustained": ("network", "pingpong-sustained", 64, {"duration_ticks": "64"},
                  {"chunk": 16, "telemetry": True}),
}


class _Lines:
    """An output writer recording its rendered info lines."""

    def __init__(self):
        self.lines = []

    def infof(self, fmt, *args):
        self.lines.append(fmt % args if args else fmt)

    def warn(self, fmt, *args):
        self.infof(fmt, *args)

    def write_error(self, msg):
        pass


def _run_both(root, name, disable_metrics=False, **cfg):
    plan, case, n, params, base = PARITY[name]
    cfg = {**base, **cfg}
    common = dict(run_id=f"perf-{name}", test_plan=plan, test_case=case, total_instances=n,
                  disable_metrics=disable_metrics)
    jjob = JRunInput(groups=[JRunGroup(id="all", instances=n, parameters=dict(params),
                                       artifact_path=os.path.join(REF_PLANS, plan))],
                     env=EnvConfig.load(home=str(root / "jax")),
                     runner_config=jexec.SimJaxConfig(shard=False, **cfg), **common)
    pjob = RunInput(groups=[RunGroup(id="all", instances=n, parameters=dict(params))],
                    env=OutputsEnv(root / "torch"),
                    runner_config=pexec.SimTorchConfig(device="cpu", **cfg), **common)
    out = {}
    for pkg, execute, job in (("jax", jexec.execute_sim_run, jjob),
                              ("torch", pexec.execute_sim_run, pjob)):
        ow = _Lines()
        res = execute(job, ow, threading.Event())
        run_dir = os.path.join(job.env.dirs.outputs(), plan, job.run_id)
        path = os.path.join(run_dir, PERF_FILE)
        rows = ([json.loads(ln) for ln in open(path)] if os.path.exists(path) else None)
        out[pkg] = {"journal": res.result.journal, "rows": rows, "lines": ow.lines,
                    "run_dir": run_dir}
    return out


@pytest.fixture(scope="module")
def parity_runs(tmp_path_factory):
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = _run_both(tmp_path_factory.mktemp(name), name)
        return cache[name]

    return get


@pytest.mark.parametrize("name", list(PARITY))
def test_perf_block_matches_jax(name, parity_runs):
    got = parity_runs(name)
    j, p = got["jax"]["journal"]["sim"], got["torch"]["journal"]["sim"]
    assert perf_view(p) == perf_view(j)
    perf = p["perf"]
    assert perf["transport"] == "plain" and "hbm" not in perf and "compile" not in perf
    assert perf["series"]["rows"] == perf["execute"]["chunks"] > 0
    assert perf["execute"]["ticks"] == p["ticks"]
    assert perf["instances"] == PARITY[name][2]


@pytest.mark.parametrize("name", list(PARITY))
def test_perf_rows_match_jax(name, parity_runs):
    got = parity_runs(name)
    jrows, prows = got["jax"]["rows"], got["torch"]["rows"]
    assert len(prows) == len(jrows) == got["torch"]["journal"]["sim"]["perf"]["series"][
        "rows"]
    for j, p in zip(jrows, prows):
        assert sorted(p) == sorted(set(j) - COMPILE_DERIVED)
        assert {k: p[k] for k in PERF_ROW_FIELDS} == {k: j[k] for k in PERF_ROW_FIELDS}
        assert p["transport"] == "plain"
    wall = got["torch"]["journal"]["sim"]["perf"]["execute"]["wall_secs"]
    assert abs(sum(r["wall_secs"] for r in prows) - wall) <= 1e-5 * len(prows)


@pytest.mark.parametrize("name", list(PARITY))
def test_perf_log_line_matches_jax(name, parity_runs):
    got = parity_runs(name)
    pat = r"sim:(?:jax|torch) perf-\S+: perf — \d+ peer·ticks/s over (\d+) chunk\(s\)"
    chunks = {}
    for pkg in ("jax", "torch"):
        found = [m for ln in got[pkg]["lines"] if (m := re.match(pat, ln))]
        assert len(found) == 1, got[pkg]["lines"]
        chunks[pkg] = found[0].group(1)
    assert chunks["torch"] == chunks["jax"]
    assert not any("perf ledger not ported" in ln for ln in got["torch"]["lines"])


@pytest.mark.parametrize("how", ["perf-false", "disable-metrics"])
def test_ledger_off_writes_no_block_and_no_file(how, tmp_path):
    if how == "perf-false":
        got = _run_both(tmp_path, "placebo", perf=False)
    else:
        got = _run_both(tmp_path, "placebo", disable_metrics=True)
    for pkg in ("jax", "torch"):
        assert "perf" not in got[pkg]["journal"]["sim"], pkg
        assert got[pkg]["rows"] is None, pkg


# ---------------------------------------------- no added sync and no added op


def _counted(perf, faults=False):
    from test_torch_plans import _smoke_faults
    from testground_tpu_torch.sim.executor import (
        instantiate_testcase,
        load_sim_testcases,
        plan_dir,
    )
    from testground_tpu_torch.sim.faults import build_fault_schedule

    plan, case, params = (("chaos", "chaos-barrier", {}) if faults else
                          ("network", "pingpong-sustained", {"duration_ticks": "40"}))
    groups = build_groups([RunGroup(id="all", instances=8, parameters=params)])
    tc = instantiate_testcase(load_sim_testcases(plan_dir(plan))[case], groups, 1.0)
    prog = SimProgram(tc, groups, chunk=16, device="cpu", telemetry=True,
                      faults=build_fault_schedule(groups, _smoke_faults(), 1.0)
                      if faults else None)
    ledger = PerfLedger(8, 16, device=prog.device) if perf else None
    mode = _CountOps()
    with mode:
        prog.run(seed=3, max_ticks=64, perf=ledger)
    return dict(sorted(mode.counts.items())), ledger


@pytest.mark.parametrize("faults", [False, True])
def test_ledger_adds_no_op_and_no_host_read(faults):
    _counted(False, faults)  # a process's first run builds tables it then keeps
    off, _ = _counted(False, faults)
    on, ledger = _counted(True, faults)
    assert on == off
    assert off.get("_local_scalar_dense", 0) > 0  # the done flag's read is counted
    s = ledger.summary()
    assert s["series"]["rows"] == s["execute"]["chunks"] >= 2


def test_executor_ledger_adds_no_op(tmp_path):
    """The same through ``execute_sim_run``: the ledger and its file are
    host-side only."""
    counts = {}
    for perf in (False, True):
        job = RunInput(run_id=f"ops-{perf}", test_plan="network",
                       test_case="pingpong-sustained", total_instances=8,
                       groups=[RunGroup(id="all", instances=8,
                                        parameters={"duration_ticks": "40"})],
                       env=OutputsEnv(tmp_path),
                       runner_config=pexec.SimTorchConfig(device="cpu", chunk=16,
                                                          perf=perf, timeseries_every=0))
        mode = _CountOps()
        with mode:
            out = pexec.execute_sim_run(job, _Lines(), threading.Event())
        counts[perf] = dict(sorted(mode.counts.items()))
        assert ("perf" in out.result.journal["sim"]) == perf
    assert counts[True] == counts[False]


# -------------------------------------------------------------- the profiler

# name: (runner config, instances, duration): a whole run, two chunks after
# the first, and a run over before its second chunk
PROFILES = {
    "full": ({"profile": True}, 8, "40"),
    "chunks": ({"profile": True, "profile_chunks": 2}, 8, "40"),
    "short": ({"profile": True, "profile_chunks": 1}, 8, "4"),
}


@pytest.mark.parametrize("name", list(PROFILES))
def test_profile_capture_matches_jax(name, tmp_path):
    cfg, n, duration = PROFILES[name]
    journals = {}
    for pkg in ("jax", "torch"):
        common = dict(run_id=f"prof-{name}", test_plan="network",
                      test_case="pingpong-sustained", total_instances=n)
        params = {"duration_ticks": duration}
        if pkg == "jax":
            job = JRunInput(groups=[JRunGroup(id="all", instances=n, parameters=params,
                                              artifact_path=os.path.join(REF_PLANS,
                                                                         "network"))],
                            env=EnvConfig.load(home=str(tmp_path / pkg)),
                            runner_config=jexec.SimJaxConfig(shard=False, chunk=8, **cfg),
                            **common)
            out = jexec.execute_sim_run(job, _Lines(), threading.Event())
        else:
            job = RunInput(groups=[RunGroup(id="all", instances=n, parameters=params)],
                           env=OutputsEnv(tmp_path / pkg),
                           runner_config=pexec.SimTorchConfig(device="cpu", chunk=8, **cfg),
                           **common)
            out = pexec.execute_sim_run(job, _Lines(), threading.Event())
        journals[pkg] = out.result.journal["profile"]
    assert journals["torch"] == journals["jax"]
    trace = tmp_path / "torch" / "network" / f"prof-{name}" / "profiles" / pexec.PROFILE_TRACE_FILE
    doc = json.loads(trace.read_text())
    assert doc["traceEvents"], "an empty Chrome trace"
    if name == "chunks":
        assert journals["torch"]["chunks"] == 2 and "note" not in journals["torch"]


def test_group_profiles_turn_the_capture_on(tmp_path):
    """A group's ``profiles`` (the composition's pprof analog) captures the
    whole run, as the runner-config flag does."""
    job = RunInput(run_id="prof-group", test_plan="placebo", test_case="ok",
                   total_instances=2,
                   groups=[RunGroup(id="all", instances=2, profiles={"cpu": "1s"})],
                   env=OutputsEnv(tmp_path),
                   runner_config=pexec.SimTorchConfig(device="cpu", chunk=8))
    out = pexec.execute_sim_run(job, _Lines(), threading.Event())
    assert out.result.journal["profile"] == {"dir": "profiles", "mode": "full"}
    assert (tmp_path / "placebo" / "prof-group" / "profiles"
            / pexec.PROFILE_TRACE_FILE).exists()


def test_profiler_that_does_not_start_leaves_the_run_whole(tmp_path, monkeypatch):
    def broken(device):
        raise RuntimeError("no profiler here")

    monkeypatch.setattr(pexec, "_profiler", broken)
    for cfg in ({"profile": True}, {"profile": True, "profile_chunks": 1}):
        job = RunInput(run_id=f"prof-broken-{len(cfg)}", test_plan="placebo",
                       test_case="ok", total_instances=2,
                       groups=[RunGroup(id="all", instances=2)], env=OutputsEnv(tmp_path),
                       runner_config=pexec.SimTorchConfig(device="cpu", chunk=8, **cfg))
        out = pexec.execute_sim_run(job, _Lines(), threading.Event())
        assert out.result.outcome.value == "success"
        assert out.result.journal["profile"]["dir"] == "profiles"
