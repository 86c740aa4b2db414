"""The port's copy of the run health plane (``testground_tpu_torch/sim/slo.py``)
against its original, ``testground_tpu/sim/slo.py``:

- the code below the module docstring is the original's, line for line;
- ``parse_slo`` and ``build_slo_plan`` give the same rules, and refuse the
  same tables with the same message, over the rule tables of
  ``tests/test_sim_slo.py``;
- an ``SloEvaluator`` of each package, fed the same telemetry rows and
  latency deltas chunk by chunk, gives the same breaches, records
  (``sim_slo.jsonl``), journal, state, fatal breach and cancel.
"""

import dataclasses
import inspect
import json
import threading
import types

import numpy as np
import pytest

from testground_tpu.sim import slo as jslo
from testground_tpu_torch.sim import slo as pslo
from testground_tpu_torch.sim.telemetry import LATENCY_BINS


def _body(mod) -> str:
    src = inspect.getsource(mod)
    return src[src.index("from __future__ import annotations"):]


def test_the_copy_is_the_original_below_its_docstring():
    assert _body(pslo) == _body(jslo)
    assert sorted(pslo.__all__) == sorted(jslo.__all__)
    assert pslo.SLO_FILE == jslo.SLO_FILE
    assert pslo.SLO_METRICS == jslo.SLO_METRICS
    assert sorted(pslo.SLO_OPS) == sorted(jslo.SLO_OPS)


def gspec(gid, count):
    return types.SimpleNamespace(id=gid, count=count)


def _rule(**kw):
    return {"metric": "drop_rate", "op": "<", "threshold": 1, **kw}


# name: (table, default_group); the tables of tests/test_sim_slo.py
PARSE = {
    "minimal": ({"metric": "drop_rate", "op": "<=", "threshold": 0.01}, ""),
    "unknown-key": (_rule(oops=2), ""),
    "unknown-metric": ({"metric": "p99", "op": "<", "threshold": 1}, ""),
    "unknown-op": ({"metric": "drop_rate", "op": "!=", "threshold": 1}, ""),
    "no-threshold": ({"metric": "drop_rate", "op": "<"}, ""),
    "text-threshold": ({"metric": "drop_rate", "op": "<", "threshold": "lots"}, ""),
    "bad-severity": (_rule(severity="panic"), ""),
    "negative-window": (_rule(window_ticks=-5), ""),
    "fractional-window": (_rule(window_ticks=512.7), ""),
    "bool-window": (_rule(window_ticks=True), ""),
    "text-window": (_rule(window_ticks="soon"), ""),
    "group-on-run-global": (_rule(group="clients"), ""),
    "latency-defaults-to-group": ({"metric": "latency_p99_ticks", "op": "<",
                                   "threshold": 8}, "clients"),
    "run-global-in-group": ({"metric": "drop_rate", "op": "<", "threshold": 0.5},
                            "clients"),
    "windowed-fail": ({"name": "rate", "metric": "delivered_per_tick", "op": ">=",
                       "threshold": 2.0, "window_ticks": 48, "severity": "fail"}, ""),
    "crashed": ({"metric": "crashed_fraction", "op": "<", "threshold": 0.2,
                 "window_ticks": 16}, ""),
}


def _outcome(fn, *args, **kw):
    try:
        return "ok", fn(*args, **kw)
    except ValueError as e:
        return "refused", str(e)


@pytest.mark.parametrize("name", list(PARSE))
def test_parse_slo_matches(name):
    table, default_group = PARSE[name]
    kj, vj = _outcome(jslo.parse_slo, dict(table), default_group=default_group)
    kp, vp = _outcome(pslo.parse_slo, dict(table), default_group=default_group)
    assert kp == kj
    if kj == "ok":
        assert dataclasses.asdict(vp) == dataclasses.asdict(vj)
    else:
        assert vp == vj


LAYOUT = [gspec("a", 4), gspec("b", 4)]
# name: tables by group id
PLANS = {
    "nothing": {},
    "empty-group": {"a": []},
    "unknown-group": {"": [{"metric": "latency_p99_ticks", "op": "<", "threshold": 8,
                            "group": "ghost"}]},
    "duplicate-names": {"": [_rule(name="x"), _rule(name="x")]},
    "shape": {"": [{"metric": "drop_rate", "op": "<", "threshold": 0.1,
                    "window_ticks": 100}],
              "a": [{"metric": "latency_p95_ticks", "op": "<", "threshold": 8,
                     "severity": "fail"}]},
}


@pytest.mark.parametrize("name", list(PLANS))
def test_build_slo_plan_matches(name):
    kj, vj = _outcome(jslo.build_slo_plan, LAYOUT, PLANS[name])
    kp, vp = _outcome(pslo.build_slo_plan, LAYOUT, PLANS[name])
    assert kp == kj
    if kj == "refused":
        assert vp == vj
    elif vj is None:
        assert vp is None
    else:
        assert [dataclasses.asdict(r) for r in vp.rules] == [
            dataclasses.asdict(r) for r in vj.rules]
        assert (vp.count, vp.has_fail(), vp.max_window_ticks(), vp.summary()) == (
            vj.count, vj.has_fail(), vj.max_window_ticks(), vj.summary())


# every metric, per group and over the run, windowed and whole-run, warn
# and fail
RULES = [
    {"name": "rate", "metric": "delivered_per_tick", "op": ">=", "threshold": 3.0,
     "window_ticks": 32},
    {"name": "drops", "metric": "drop_rate", "op": "<", "threshold": 0.1},
    {"name": "crashed", "metric": "crashed_fraction", "op": "<", "threshold": 0.2,
     "window_ticks": 16},
    {"name": "a-p99", "metric": "latency_p99_ticks", "op": "<", "threshold": 4.0,
     "group": "a"},
    {"name": "all-p50", "metric": "latency_p50_ticks", "op": "<", "threshold": 6.0,
     "window_ticks": 48},
    {"name": "p95-fail", "metric": "latency_p95_ticks", "op": "<=", "threshold": 40.0,
     "severity": "fail"},
]


def _chunks(seed, n_chunks=8, chunk=16):
    """Random telemetry rows and latency deltas, one chunk at a time."""
    rng = np.random.default_rng(seed)
    out = []
    for c in range(n_chunks):
        rows = []
        for i in range(chunk):
            sent = int(rng.integers(0, 12))
            dropped = int(rng.integers(0, sent + 1)) if rng.random() < 0.3 else 0
            rows.append({
                "tick": c * chunk + i, "sent": sent, "dropped": dropped,
                "delivered": int(rng.integers(0, 8)),
                "fault_dropped": int(rng.integers(0, 2)),
                "faults_crashed": int(rng.random() < 0.05) * 2,
                "faults_restarted": int(rng.random() < 0.05) * 2,
            })
        lat = rng.integers(0, 6, size=(len(LAYOUT), LATENCY_BINS)).astype(np.int64)
        lat[:, int(rng.integers(0, LATENCY_BINS))] += int(rng.integers(0, 30))
        out.append((rows, lat))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_evaluator_matches(seed, tmp_path):
    runs = []
    for mod in (jslo, pslo):
        plan = mod.build_slo_plan(LAYOUT, {"": [dict(r) for r in RULES]})
        cancel = threading.Event()
        path = tmp_path / f"{mod.__name__}.jsonl"
        ev = mod.SloEvaluator(plan, LAYOUT, tick_ms=0.5, chunk=16,
                              ident={"run": "r", "plan": "p", "case": "c"},
                              path=str(path), cancel=cancel)
        breaches = []
        for rows, lat in _chunks(seed):
            ev.on_rows([dict(r) for r in rows])
            ev.on_lat_delta(lat.copy())
            breaches.append(ev.evaluate())
        state = json.loads(json.dumps(ev.state_dict()))
        ev.close()
        runs.append((breaches, ev.journal(), state, ev.fatal, cancel.is_set(),
                     path.read_text()))
    assert runs[1] == runs[0]
    assert any(runs[0][0]), "the rules breach somewhere"


def test_breach_error_matches():
    fatal = {"rule": "p95-fail", "metric": "latency_p95_ticks", "op": "<=",
             "threshold": 40.0, "observed": 41.0, "tick": 96, "severity": "fail",
             "window": [0, 95]}
    assert str(pslo.SloBreachError(dict(fatal))) == str(jslo.SloBreachError(dict(fatal)))
