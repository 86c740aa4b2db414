"""The port's flight recorder against the JAX package on the CPU, bit for
bit:

- the copied host module ``sim/trace.py`` (``parse_trace`` and its
  refusals, ``build_trace_plan``, ``events_from_blocks``, ``chrome_trace``,
  ``read_trace_events``, the event and fate codes) against its original;
- whole runs with every plane on (``telemetry``, ``netmatrix`` and a
  trace plan) over the workloads of ``test_torch_telemetry.WORKLOADS``:
  every ``trace_cb`` block (unused slots and padding rows included), and
  with them every counter block, histogram and matrix delta, result and
  carry leaf; the events decode, scheduled crashes and restarts show as
  status events, barrier entries as signals, and every send names its
  transport fate.
"""

import json

import numpy as np
import pytest

from test_torch_faults import _both_groups
from test_torch_telemetry import WORKLOADS, check_telemetry, run_both
from testground_tpu.sim import api as japi
from testground_tpu.sim import trace as jtrace
from testground_tpu.sim.engine import SimProgram as JSimProgram
from testground_tpu_torch.sim import api as papi
from testground_tpu_torch.sim import netmatrix as pnm
from testground_tpu_torch.sim import trace as ptrace
from testground_tpu_torch.sim.engine import SimProgram

# ------------------------------------------------------- the host module


def test_trace_constants_pinned():
    for name in ("EVENT_KINDS", "FATE_NAMES", "MAX_TRACE_LANES", "TRACE_FILE",
                 "TRACE_EVENTS_FILE", "EV_STATUS", "EV_SIGNAL", "EV_SEND", "EV_DELIVER",
                 "DEFAULT_EVENTS_CAP"):
        assert getattr(ptrace, name) == getattr(jtrace, name), name
    assert sorted(ptrace.__all__) == sorted(jtrace.__all__)


BAD_TABLES = {
    "unknown-key": {"lanes": "0:2"},
    "not-a-table": "0:2",
    "fraction-out-of-range": {"fraction": 1.5},
    "negative-cap": {"events": -1},
}


@pytest.mark.parametrize("name", list(BAD_TABLES))
def test_parse_trace_refusals_match(name):
    with pytest.raises(ValueError) as jerr:
        jtrace.parse_trace(BAD_TABLES[name])
    with pytest.raises(ValueError) as perr:
        ptrace.parse_trace(BAD_TABLES[name])
    assert str(perr.value) == str(jerr.value)


# name: (layout, tables by group id)
PLANS = {
    "range": ([("all", 16)], {"": {"instances": "3:9", "events": 50}}),
    "group-scoped": ([("a", 5), ("b", 7)], {"b": {"instances": "1:4"}}),
    "union": ([("a", 5), ("b", 7)], {"a": {"instances": "0:2"},
                                     "": {"group": "b", "instances": "5:7"}}),
    "seeded-fraction": ([("all", 40)], {"": {"fraction": 0.3, "seed": 11}}),
    "whole-group": ([("a", 3), ("b", 4)], {"a": {"fraction": 1.0}}),
    "nothing": ([("all", 4)], {"all": {}}),
}


@pytest.mark.parametrize("name", list(PLANS))
def test_build_trace_plan_matches(name):
    layout, tables = PLANS[name]
    jg, pg = _both_groups(layout)
    jp, pp = jtrace.build_trace_plan(jg, tables), ptrace.build_trace_plan(pg, tables)
    assert (jp is None) == (pp is None) == (name == "nothing")
    if jp is None:
        return
    assert pp.n == jp.n and pp.events_cap == jp.events_cap and pp.count == jp.count
    for f in ("mask", "lanes"):
        a, b = getattr(jp, f), getattr(pp, f)
        assert b.dtype == a.dtype
        np.testing.assert_array_equal(b, a)
    assert pp.summary() == jp.summary()


@pytest.mark.parametrize("tables", [{"": {"group": "nope"}}, {"": {"instances": "2:40"}}])
def test_bad_selectors_refused_like_reference(tables):
    jg, pg = _both_groups([("all", 8)])
    with pytest.raises(ValueError) as jerr:
        jtrace.build_trace_plan(jg, tables)
    with pytest.raises(ValueError) as perr:
        ptrace.build_trace_plan(pg, tables)
    assert str(perr.value) == str(jerr.value)


def test_oversized_selection_refused_like_reference(monkeypatch):
    monkeypatch.setattr(jtrace, "MAX_TRACE_LANES", 4)
    monkeypatch.setattr(ptrace, "MAX_TRACE_LANES", 4)
    jg, pg = _both_groups([("all", 8)])
    with pytest.raises(ValueError) as jerr:
        jtrace.build_trace_plan(jg, {"": {"instances": "0:5"}})
    with pytest.raises(ValueError) as perr:
        ptrace.build_trace_plan(pg, {"": {"instances": "0:5"}})
    assert str(perr.value) == str(jerr.value)


def test_plan_for_another_layout_refused_like_reference():
    jg8, pg8 = _both_groups([("all", 8)])
    jg4, pg4 = _both_groups([("all", 4)])
    with pytest.raises(ValueError) as jerr:
        JSimProgram(japi.SimTestcase(), jg4,
                    trace=jtrace.build_trace_plan(jg8, {"": {"instances": "0:2"}}))
    with pytest.raises(ValueError) as perr:
        SimProgram(papi.SimTestcase(), pg4, device="cpu",
                   trace=ptrace.build_trace_plan(pg8, {"": {"instances": "0:2"}}))
    assert str(perr.value) == str(jerr.value)


def _blocks(seed):
    """Random [chunk, R, 5] blocks over every event kind, with unused
    slots and padding rows."""
    rng = np.random.default_rng(seed)
    out = []
    for c in range(3):
        b = np.stack([
            np.full((6, 10), 8 * c) + np.arange(6)[:, None],
            rng.integers(0, 5, (6, 10)),
            rng.integers(-1, 4, (6, 10)),
            rng.integers(-1, 9, (6, 10)),
            rng.integers(-1, 4, (6, 10)),
        ], axis=-1).astype(np.int32)
        if c == 2:
            b[4:] = -1
        out.append(b)
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_events_and_chrome_trace_match(seed):
    blocks = _blocks(seed)

    def group(i):
        return "a" if i < 2 else "b"

    ev_p = ptrace.events_from_blocks(blocks, group)
    ev_j = jtrace.events_from_blocks(blocks, group)
    assert ev_p == ev_j and len(ev_p) > 20
    names = {0: "first", 3: "fourth"}
    assert ptrace.chrome_trace(ev_p, [0, 1, 3], names, 0.5) == \
        jtrace.chrome_trace(ev_j, [0, 1, 3], names, 0.5)


def test_read_trace_events_matches(tmp_path):
    for run in ("task1", "task1-r2", "task2"):
        d = tmp_path / "plan" / run
        d.mkdir(parents=True)
        (d / ptrace.TRACE_FILE).write_text(
            "\n".join(json.dumps({"tick": i, "run": run}) for i in range(4)) + "\n{trunc")
    for limit in (0, 3, 6):
        got = ptrace.read_trace_events(str(tmp_path), "plan", "task1", limit)
        assert got == jtrace.read_trace_events(str(tmp_path), "plan", "task1", limit)
    assert len(ptrace.read_trace_events(str(tmp_path), "plan", "task1")) == 8
    assert ptrace.read_trace_events(str(tmp_path), "nope", "task1") == []


# ------------------------------------------------------------ whole runs


@pytest.mark.parametrize("name", list(WORKLOADS))
def test_run_with_every_plane_matches_jax(name):
    res, rec, prog = run_both(name, telemetry=True, netmatrix=True, trace=True)
    check_telemetry(res, rec, prog, name)
    assert pnm.reconcile(np.asarray(res["net_matrix"]), res) == []
    blocks = rec["trace"]
    assert len(blocks) == len(rec["tele"])
    assert all(b.shape == (prog.chunk, prog._trace_nrows, 5) for b in blocks)
    lanes = set(prog.trace.lanes.tolist())
    gid = {i: g.id for g in prog.groups for i in range(g.offset, g.offset + g.count)}
    events = ptrace.events_from_blocks(blocks, gid.__getitem__)
    assert events and {e["instance"] for e in events} <= lanes
    kinds = {e["event"] for e in events}
    sends = [e for e in events if e["event"] == "send"]
    assert {e["fate"] for e in sends} <= set(ptrace.FATE_NAMES)
    # a terminal status change of every traced lane that finished
    done = {e["instance"] for e in events
            if e["event"] == "status" and e["status"] != "running"}
    assert done == {i for i in lanes if res["status"][i] != papi.RUNNING}
    if name == "chaos":
        crashed = [e for e in events if e["event"] == "status" and e["status"] == "crash"]
        revived = [e for e in events if e["event"] == "status" and e["prev"] == "crash"]
        assert crashed and revived  # the schedule's crash and restart
        assert {"fault_dropped", "enqueued"} <= {e["fate"] for e in sends}
    if name == "additional-hosts":
        host = prog.n
        assert any(e["event"] == "deliver" and e["src"] == host for e in events)
    if name in ("barrier", "subtree"):  # sync traffic only
        assert "signal" in kinds and "send" not in kinds
    elif name != "placebo-mid-chunk":
        assert {"send", "deliver"} <= kinds


@pytest.mark.parametrize("name", ["chaos", "additional-hosts", "flood"])
def test_run_with_the_recorder_alone_matches_jax(name):
    """A trace plan without telemetry: the recorder has its own flush, and
    no other plane's block or result appears."""
    res, rec, prog = run_both(name, trace=True)
    assert rec["trace"] and not rec["tele"] and not rec["lat"] and not rec["nm"]
    assert "lat_hist" not in res and "net_matrix" not in res
    assert prog._tele_k == 0 and ptrace.events_from_blocks(rec["trace"], str)
