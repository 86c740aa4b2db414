"""The port's analysis plane (``testground_tpu_torch/analysis/``) against the
JAX package's (``testground_tpu/analysis/``), on the CPU: every function of
the copied ``diff.py`` and ``bench_history.py`` gives the reference's output
on the same inputs — samples and rows made from a seed with numpy, the
bench line of ``BENCH_r06.json``, and the journals and ``sim_perf.jsonl``
rows of port runs through ``execute_sim_run`` (16 instances). Only
``env_fingerprint`` differs: it reads torch, never jax, and banks into the
port's own ``BENCH_HISTORY_TORCH.jsonl``."""

import json
import math
import os
import threading

import numpy as np
import pytest

from testground_tpu.analysis import bench_history as jbank
from testground_tpu.analysis import diff as jdiff
from testground_tpu.sim import perf as jperf
from testground_tpu_torch.analysis import bench_history as pbank
from testground_tpu_torch.analysis import diff as pdiff
from testground_tpu_torch.api import OutputsEnv, RunGroup, RunInput
from testground_tpu_torch.rpc import discard_writer
from testground_tpu_torch.sim import executor as pexec
from testground_tpu_torch.sim import perf as pperf

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _samples(seed, n, scale=1.0, shift=0.0):
    rng = np.random.default_rng(seed)
    return (rng.lognormal(0.0, 0.3, n) * scale + shift).tolist()


# ----------------------------------------------------- shared numerics

NUMS = [0, 1, -2.5, 1e6, 1.5e9, 3.2e12, float("nan"), float("inf"), None, "7", "x",
        True, [1], {"a": 1}]


@pytest.mark.parametrize("v", NUMS, ids=[repr(v) for v in NUMS])
def test_num_and_fmt_rate_match_jax(v):
    assert pdiff.num(v) == jdiff.num(v) or (
        pdiff.num(v) is not None and math.isnan(pdiff.num(v)))
    assert pdiff.num(v, 3) == jdiff.num(v, 3) or math.isnan(jdiff.num(v, 3))
    assert pdiff.fmt_rate(v) == jdiff.fmt_rate(v)
    assert pdiff.fmt_rate(v, missing="-") == jdiff.fmt_rate(v, missing="-")


# (seed, n_a, n_b, scale of b, shift of b)
SAMPLE_CASES = {
    "same": (1, 12, 12, 1.0, 0.0),
    "slower": (2, 20, 20, 0.7, 0.0),
    "faster": (3, 9, 14, 1.6, 0.0),
    "ties": (4, 6, 6, 0.0, 5.0),
    "few": (5, 3, 2, 1.2, 0.0),
    "one-empty": (6, 8, 0, 1.0, 0.0),
}


@pytest.mark.parametrize("label", list(SAMPLE_CASES))
def test_mann_whitney_and_judge_samples_match_jax(label):
    seed, na, nb, scale, shift = SAMPLE_CASES[label]
    xs = _samples(seed, na)
    ys = _samples(seed + 100, nb, scale, shift)
    if xs and ys:
        assert pdiff.mann_whitney_u(xs, ys) == jdiff.mann_whitney_u(xs, ys)
    for higher in (True, False):
        assert (pdiff.judge_samples(xs, ys, higher_is_better=higher)
                == jdiff.judge_samples(xs, ys, higher_is_better=higher))


def _bench_line():
    with open(os.path.join(REPO, "BENCH_r06.json")) as f:
        return json.loads(f.read().strip().splitlines()[-1])


def test_perf_compare_against_bench_r06_matches_jax(port_runs):
    bench = _bench_line()
    current = {"perf": port_runs[0]["journal"]["sim"]["perf"],
               "sim": port_runs[0]["journal"]["sim"]}
    for cur, base in ((current, bench), (bench, current), (bench, bench),
                      ({"tail": "noise\n" + json.dumps(bench)}, bench), ({}, bench)):
        assert pdiff.extract_ledger_metrics(cur) == jdiff.extract_ledger_metrics(cur)
        assert pdiff.ledger_scalars(cur, base) == jdiff.ledger_scalars(cur, base)
        assert (pdiff.perf_compare(cur, base, label="BENCH_r06.json")
                == jdiff.perf_compare(cur, base, label="BENCH_r06.json"))
    # sim/perf.py re-exports the one implementation, as the reference's does
    assert pperf.perf_compare is pdiff.perf_compare
    assert pperf.perf_compare(current, bench) == jperf.perf_compare(current, bench)
    assert pdiff.perf_compare(current, bench)[0].startswith("peer·ticks/s")


# ------------------------------------------------------------ the run diff


def _run(root, run_id, seed=0, phases=True):
    job = RunInput(
        run_id=run_id, test_plan="network", test_case="pingpong-sustained",
        total_instances=16,
        groups=[RunGroup(id="all", instances=16,
                         parameters={"duration_ticks": "40", "reshape_every": "16"})],
        env=OutputsEnv(root),
        runner_config=pexec.SimTorchConfig(device="cpu", chunk=8, seed=seed,
                                           telemetry=True, netmatrix=True,
                                           phases=phases),
        slo=[{"metric": "drop_rate", "op": "<", "threshold": 0.5}],
    )
    out = pexec.execute_sim_run(job, discard_writer(), threading.Event())
    run_dir = os.path.join(root, "network", run_id)
    with open(os.path.join(run_dir, "sim_perf.jsonl")) as f:
        rows = [{"stream": "perf", **json.loads(ln)} for ln in f]
    return {"journal": out.result.journal, "outcome": out.result.outcome.value,
            "perf_rows": rows}


def _task(run_id, run, seed=0):
    """A task's ``to_dict`` shape around one run's journal."""
    return {
        "id": run_id, "plan": "network", "case": "pingpong-sustained",
        "states": [{"state": "scheduled", "created": 1.0},
                   {"state": "complete", "created": 2.0}],
        "outcome": run["outcome"], "error": "",
        "result": {"journal": run["journal"], "outcome": run["outcome"]},
        "composition": {"global": {"plan": "network", "case": "pingpong-sustained",
                                   "run_config": {"seed": seed, "chunk": 8}},
                        "groups": [{"id": "all", "instances": {"count": 16}}]},
    }


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("runs"))
    return [_run(root, "a"), _run(root, "b"), _run(root, "c", seed=7)]


# (a, b, planes); "c" ran another seed under the same composition text
DIFF_CASES = {
    "same-seed": ("a", "b", None),
    "other-seed": ("a", "c", None),
    "counters-only": ("a", "c", "counters"),
    "phases-perf": ("b", "a", ["phases", "perf"]),
}


@pytest.mark.parametrize("label", list(DIFF_CASES))
def test_build_run_diff_matches_jax(label, port_runs):
    a, b, planes = DIFF_CASES[label]
    runs = dict(zip("abc", port_runs))
    seeds = {"a": 0, "b": 0, "c": 7}
    snaps = {}
    for mod in (pdiff, jdiff):
        snaps[mod] = [mod.task_snapshot(_task(x, runs[x], seeds[x]), runs[x]["perf_rows"])
                      for x in (a, b)]
    assert snaps[pdiff] == snaps[jdiff]
    doc = pdiff.build_run_diff(*snaps[pdiff], planes=planes)
    assert doc == jdiff.build_run_diff(*snaps[jdiff], planes=planes)
    if label == "same-seed":
        assert doc["setup"]["identical"] and doc["findings"] == []
        assert doc["counters"]["compared"] > 0 and doc["counters"]["mismatched"] == 0
        assert doc["netmatrix"]["mismatched"] == 0 and doc["latency"]["mismatched"] == 0
    if label == "other-seed":
        assert not doc["setup"]["identical"]


def test_validate_planes_matches_jax():
    for planes in (None, "", "counters,perf", ["phases", "phases"], "  slo , "):
        assert pdiff.validate_planes(planes) == jdiff.validate_planes(planes)
    for bad in ("vibes", ["counters", "nope"]):
        with pytest.raises(ValueError) as pe:
            pdiff.validate_planes(bad)
        with pytest.raises(ValueError) as je:
            jdiff.validate_planes(bad)
        assert str(pe.value) == str(je.value)
    assert pdiff.DIFF_PLANES == jdiff.DIFF_PLANES


# ------------------------------------------------------------- the bank


def _bank_rows(seed):
    """Seeded bank rows over a few keys, with corrupt lines between."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(24):
        w = ("sustained", "flood", "storm")[i % 3]
        rows.append({
            "workload": w, "instances": int(rng.choice([4096, 100_000])),
            "transport": str(rng.choice(["cuda", "plain"])), "mesh": "" if i % 5 else "4",
            "value": float(rng.lognormal(16, 0.4)) if i % 7 else None,
            "fingerprint": {"backend": "cuda", "device_kind": "NVIDIA H100 80GB HBM3"},
            "ts": i,
        })
    return rows


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sentinel_report_matches_jax(seed):
    rows = _bank_rows(seed)
    for tol in (2.5, 1.0, 1.1):
        assert pbank.sentinel_report(rows, tolerance=tol) == jbank.sentinel_report(
            rows, tolerance=tol)
    assert [pbank.history_key(r) for r in rows] == [jbank.history_key(r) for r in rows]


def test_bank_round_trips_a_row(tmp_path):
    path = tmp_path / pbank.HISTORY_FILE
    assert pbank.HISTORY_FILE == "BENCH_HISTORY_TORCH.jsonl" != jbank.HISTORY_FILE
    row = {"workload": "sustained", "instances": 16, "transport": "plain", "value": 1.5e6,
           "fingerprint": pbank.env_fingerprint()}
    written = pbank.bank_row(str(path), row)
    with open(path, "a") as f:
        f.write('{"half": \n')  # a corrupt line from a crashed writer
    pbank.bank_row(str(path), {**row, "value": 1.0e6})
    got = pbank.load_history(str(path))
    assert got == jbank.load_history(str(path)) == [written, {**row, "value": 1.0e6}]
    assert pbank.sentinel_report(got) == jbank.sentinel_report(got)


def test_env_fingerprint_reads_torch_not_jax():
    import torch

    fp = pbank.env_fingerprint()
    assert fp["torch"] == torch.__version__ and "jax" not in fp
    assert fp["backend"] == ("cuda" if torch.cuda.is_available() else "cpu")
    assert fp["devices"] == (torch.cuda.device_count() if torch.cuda.is_available() else 0)
    assert {"python", "platform", "cpu_count"} <= set(fp)
    assert set(jbank.env_fingerprint()) - set(fp) <= {"jax", "device_kind"}
