"""The port's phase plane (``testground_tpu_torch/sim/phases.py``) and the
transport probe, on the CPU:

- ``phase_rows``, ``write_phase_rows`` and ``render_phase_table`` give
  the reference's output, byte for byte, on the same blocks;
- the port's ledger of a 16-instance sustained program (telemetry off and
  on, and under a crash schedule) holds the rows the reference's
  ``build_phase_ledger`` holds for the same program, in its order;
- Σ phases + residual == whole_per_tick exactly, two builds give
  identical static rows, and ``phases_measure`` adds each row's measured
  ms;
- the ledger leaves the run alone: with ``phases = true`` the run's
  flows, journal and files are those of the run without it, and the run
  dispatches the same ops; the program's carry after a run is untouched
  by a ledger built after it;
- a ledger that raises leaves the run ok;
- ``transport = "auto"`` with ``transport_probe = 2`` journals a measured
  score and keeps the resolved arm;
- the closed forms of the kernels' bytes, which the ledger adds on the
  card, are ``chip_smoke.py``'s.
"""

import json
import os
import threading

import numpy as np
import pytest
import torch

from testground_tpu.api import RunGroup as JRunGroup
from testground_tpu.runners import pretty as jpretty
from testground_tpu.sim import phases as jphases
from testground_tpu.sim.engine import SimProgram as JSimProgram
from testground_tpu.sim.engine import build_groups as jbuild
from testground_tpu.sim.executor import instantiate_testcase as jinst
from testground_tpu.sim.executor import load_sim_testcases as jload
from testground_tpu.sim.faults import build_fault_schedule as jfaults
from testground_tpu_torch.api import OutputsEnv, RunGroup, RunInput
from testground_tpu_torch.rpc import discard_writer
from testground_tpu_torch.runners import pretty as ppretty
from testground_tpu_torch.sim import cuda_transport as ct
from testground_tpu_torch.sim import executor as pexec
from testground_tpu_torch.sim import phases as pphases
from testground_tpu_torch.sim.carry_io import carry_to_numpy
from testground_tpu_torch.sim.engine import SimProgram, build_groups
from testground_tpu_torch.sim.faults import build_fault_schedule as pfaults
from test_torch_executor import REF_PLANS

PARAMS = {"duration_ticks": "48", "reshape_every": "16"}
CRASH = [{"kind": "crash", "instances": "0:4", "start_ms": 3.0}]

# variant: (telemetry, fault table)
VARIANTS = {"plain": (False, None), "telemetry": (True, None), "crash": (False, CRASH)}


def port_program(telemetry=False, faults=None, n=16, chunk=8):
    factory = pexec.load_sim_testcases(pexec.plan_dir("network"))["pingpong-sustained"]
    groups = build_groups([RunGroup(id="g", instances=n, parameters=dict(PARAMS))])
    return SimProgram(
        pexec.instantiate_testcase(factory, groups, 1.0), groups, test_plan="network",
        test_case="pingpong-sustained", tick_ms=1.0, chunk=chunk, device="cpu",
        telemetry=telemetry,
        faults=pfaults(groups, {"g": faults}, 1.0) if faults else None)


def jax_program(telemetry=False, faults=None, n=16, chunk=8):
    factory = jload(os.path.join(REF_PLANS, "network"))["pingpong-sustained"]
    groups = jbuild([JRunGroup(id="g", instances=n, parameters=dict(PARAMS))])
    return JSimProgram(
        jinst(factory, groups, 1.0), groups, test_plan="network",
        test_case="pingpong-sustained", tick_ms=1.0, chunk=chunk, telemetry=telemetry,
        faults=jfaults(groups, {"g": faults}, 1.0) if faults else None)


@pytest.fixture(scope="module")
def ledgers():
    """The port's ledger of each variant (two builds, the second measured)
    and the reference's."""
    out = {}
    for name, (tele, faults) in VARIANTS.items():
        prog = port_program(tele, faults)
        out[name] = {
            "port": pphases.build_phase_ledger(prog),
            "again": pphases.build_phase_ledger(prog, measure=2),
            "ref": jphases.build_phase_ledger(jax_program(tele, faults)),
        }
    return out


# --------------------------------------------------------------- rows


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_phase_set_matches_the_reference(variant, ledgers):
    got = ledgers[variant]
    rows = [r["phase"] for r in got["port"]["phases"]]
    assert rows == [r["phase"] for r in got["ref"]["phases"]]
    want = {"plain": ["deliver", "step", "sync", "net_commit"],
            "telemetry": ["deliver", "lat_hist", "step", "sync", "net_commit", "telemetry"],
            "crash": ["faults", "deliver", "step", "sync", "net_commit"]}[variant]
    assert rows == want
    block = got["port"]
    assert (block["transport"], block["chunk"], block["instances"]) == ("plain", 8, 16)
    assert sorted(block) == sorted(set(got["ref"]) - {"transcendentals"})


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_residual_closes_the_whole_tick_exactly(variant, ledgers):
    block = ledgers[variant]["port"]
    whole = block["whole_per_tick"]
    assert set(whole) == {"bytes_accessed"}  # no op of the tick has a flop formula
    for key, total in whole.items():
        assert isinstance(total, int) and total > 0
        parts = sum(r[key] for r in block["phases"]) + block["residual"][key]
        assert parts == total
        assert all(r[key] > 0 for r in block["phases"] if r["phase"] != "faults")
    assert block["coverage"]["bytes_frac"] == round(
        sum(r["bytes_accessed"] for r in block["phases"]) / whole["bytes_accessed"], 4)
    assert "kernel_bytes" not in block  # the plain versions are counted op by op


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_two_builds_give_identical_static_rows(variant, ledgers):
    a, b = ledgers[variant]["port"], ledgers[variant]["again"]
    static = [{k: v for k, v in r.items() if not k.startswith("measured")}
              for r in b["phases"]]
    assert static == a["phases"]
    assert (a["whole_per_tick"], a["residual"]) == (b["whole_per_tick"], b["residual"])
    for r in b["phases"]:
        assert r["measured_reps"] == 2 and r["measured_ms"] >= 0


# ------------------------------------------------- copied row helpers


def _blocks(ledgers):
    return [ledgers[v][k] for v in VARIANTS for k in ("port", "again")] + [
        {}, {"phases": [{"phase": "deliver"}, "junk"], "residual": {"flops": None}},
        {"transport": "cuda", "phases": [], "whole_per_tick": {"bytes_accessed": 5}}]


def test_phase_rows_and_table_match_jax(ledgers):
    for block in _blocks(ledgers):
        assert pphases.phase_rows(block) == jphases.phase_rows(block)
        for payload in ({"phases": block}, {"sim": {"phases": block}}, {}):
            assert (ppretty.render_phase_table(payload)
                    == jpretty.render_phase_table(payload))
    assert pphases.TICK_PHASES == jphases.TICK_PHASES
    assert pphases.PHASES_FILE == jphases.PHASES_FILE


def test_write_phase_rows_matches_jax(ledgers, tmp_path):
    ident = {"run": "r", "plan": "network", "case": "pingpong-sustained"}
    for i, block in enumerate(_blocks(ledgers)):
        p, j = tmp_path / f"p{i}.jsonl", tmp_path / f"j{i}.jsonl"
        assert pphases.write_phase_rows(str(p), ident, block) == jphases.write_phase_rows(
            str(j), ident, block)
        assert (p.read_bytes() if p.exists() else None) == (
            j.read_bytes() if j.exists() else None)
    assert pphases.write_phase_rows(str(tmp_path / "no" / "dir.jsonl"), ident,
                                    _blocks(ledgers)[0]) == 0


# ------------------------------------------------ the run is left alone


def test_ledger_leaves_the_programs_carry_alone():
    prog = port_program(telemetry=True, faults=CRASH)
    last = {}
    res = prog.run(max_ticks=24, observer=lambda k, c: last.update(c=c))
    before = carry_to_numpy(last["c"])
    pphases.build_phase_ledger(prog, measure=2)
    after = carry_to_numpy(last["c"])
    assert sorted(before) == sorted(after)
    for k in before:
        np.testing.assert_array_equal(after[k], before[k], err_msg=k)
    again = port_program(telemetry=True, faults=CRASH).run(max_ticks=24)
    for k in ("msgs_sent", "msgs_delivered", "faults_crashed", "fault_dropped"):
        assert again[k] == res[k]


def _counting_ops(monkeypatch):
    """Count the aten ops each ``SimProgram.run`` dispatches."""
    from torch.utils._python_dispatch import TorchDispatchMode

    counts = []

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            counts[-1] += 1
            return func(*args, **(kwargs or {}))

    run = SimProgram.run

    def counted(self, *a, **kw):
        counts.append(0)
        with Count():
            return run(self, *a, **kw)

    monkeypatch.setattr(SimProgram, "run", counted)
    return counts


def _job(root, run_id, faults=CRASH, **cfg):
    return RunInput(
        run_id=run_id, test_plan="network", test_case="pingpong-sustained",
        total_instances=16,
        groups=[RunGroup(id="all", instances=16, parameters=dict(PARAMS))],
        env=OutputsEnv(root),
        runner_config=pexec.SimTorchConfig(device="cpu", chunk=8, telemetry=True,
                                           netmatrix=True, **cfg),
        faults=list(faults or []))


def _tree(run_dir):
    out = {}
    for dirpath, _, files in os.walk(run_dir):
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), run_dir)
            if f.endswith(".jsonl") and f not in ("run_spans.jsonl", "sim_perf.jsonl"):
                rows = [json.loads(ln) for ln in open(os.path.join(dirpath, f))]
                out[rel] = [{k: v for k, v in r.items() if k not in ("run", "ts")}
                            for r in rows]
            else:
                out[rel] = None
    return out


def test_phases_on_runs_the_run_of_phases_off(tmp_path, monkeypatch):
    counts = _counting_ops(monkeypatch)
    outs = {}
    for name, cfg in (("off", {}), ("on", {"phases": True, "phases_measure": 2})):
        outs[name] = pexec.execute_sim_run(_job(str(tmp_path), name, **cfg),
                                           discard_writer(), threading.Event())
    assert counts[0] == counts[1] > 0  # the same ops dispatched by the run
    off, on = (outs[k].result.journal for k in ("off", "on"))
    sim_on = {k: v for k, v in on["sim"].items() if k != "phases"}
    skip = ("wall_secs", "compile_secs", "perf")
    assert ({k: v for k, v in sim_on.items() if k not in skip}
            == {k: v for k, v in off["sim"].items() if k not in skip})
    assert {k: v for k, v in on.items() if k != "sim"} == {
        k: v for k, v in off.items() if k != "sim"}
    t_off, t_on = _tree(tmp_path / "network" / "off"), _tree(tmp_path / "network" / "on")
    assert set(t_on) - set(t_off) == {"sim_phases.jsonl"}
    assert {k: v for k, v in t_on.items() if k != "sim_phases.jsonl"} == t_off
    # seven phases (a schedule and telemetry), then residual and total
    assert on["sim"]["phases"]["series"] == {"rows": 9, "file": "sim_phases.jsonl"}
    spans = [json.loads(ln)["event"] for ln in
             open(tmp_path / "network" / "on" / "run_spans.jsonl")]
    assert [e["type"] for e in spans if e.get("span") == "phases"] == [
        "span_start", "span_end"]


def test_a_ledger_that_raises_leaves_the_run_ok(tmp_path, monkeypatch):
    def boom(*a, **kw):
        raise RuntimeError("ledger broke")

    monkeypatch.setattr(pphases, "build_phase_ledger", boom)
    lines = []

    class Writer:
        def infof(self, fmt, *a):
            lines.append(("info", fmt % a))

        def warn(self, fmt, *a):
            lines.append(("warn", fmt % a))

    out = pexec.execute_sim_run(_job(str(tmp_path), "boom", faults=None, phases=True),
                                Writer(), threading.Event())
    assert out.result.outcome.value == "success"
    assert "phases" not in out.result.journal["sim"]
    assert not (tmp_path / "network" / "boom" / "sim_phases.jsonl").exists()
    assert ("warn", "sim:torch boom: phase attribution failed: ledger broke") in lines


def test_transport_probe_journals_a_measured_score(tmp_path):
    out = pexec.execute_sim_run(_job(str(tmp_path), "probe", transport="auto",
                                     transport_probe=2),
                                discard_writer(), threading.Event())
    tr = out.result.journal["sim"]["transport"]
    assert (tr["requested"], tr["resolved"]) == ("auto", "plain")
    assert set(tr["scores"]) == {"source", "backend", "plain_ms_per_tick", "reps"}
    assert tr["scores"]["source"] == "measured" and tr["scores"]["backend"] == "cpu"
    assert tr["scores"]["reps"] == 2 and tr["scores"]["plain_ms_per_tick"] > 0
    assert tr["reason"].startswith("measured probe: plain ")
    assert "one arm per device" in tr["reason"]
    # away from auto the probe is ignored, as in the reference
    out = pexec.execute_sim_run(_job(str(tmp_path), "xla", transport_probe=2),
                                discard_writer(), threading.Event())
    assert "scores" not in out.result.journal["sim"]["transport"]


def test_measure_phases_names_every_phase():
    prog = port_program(telemetry=True, faults=CRASH)
    ms = pphases.measure_phases(prog, 2)
    assert set(TICK := pphases.TICK_PHASES) <= set(ms) and "residual" in ms
    assert all(ms[p] >= 0 for p in TICK)


# -------------------------------------------------- the kernels' bytes


def test_closed_forms_of_the_kernels_bytes():
    # K1: 10 keys, W=2, SLOTS=4, int32 occupancy, stacking, etick; 3 runs, 6 survive
    assert ct.commit_bytes(10, 2, 4, False, True, True, 3, 6) == (
        10 * (8 + 8) + 10 * 4 + 3 * 4 * 4 + 6 * (4 + 8 + 4))
    assert ct.commit_bytes(10, 1, 4, True, False, False, 3, 6) == (
        10 * 12 + 40 + 6 * (1 + 4))
    # K2: a 400-cell row, W=1: occupancy and payload in and out, occupancy cleared
    assert ct.pop_bytes(400, 1, False) == 400 * 8 * 2 + 400 * 4
    assert ct.pop_bytes(400, 2, True) == 400 * 9 * 2 + 400


def test_the_observer_is_per_thread_and_lazy():
    seen, other = [], []
    with ct.observe_launches(lambda name, measure: seen.append((name, measure()))):
        ct._report_pop("pop_bucket", _Cal(), 100)
        t = threading.Thread(target=lambda: other.append(
            getattr(ct._OBSERVED, "fn", None)))
        t.start()
        t.join()
    ct._report_pop("pop_bucket", _Cal(), 100)  # no observer: nothing reported
    assert seen == [("pop_bucket", ct.pop_bytes(100, 1, False))]
    assert other == [None]


class _Cal:
    width, slots, mesh = 1, 4, None
    occupancy_plane = torch.zeros(2, 2, dtype=torch.int32)
