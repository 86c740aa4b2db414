"""The port's traffic-matrix plane against the JAX package on the CPU, bit
for bit:

- the copied host module ``sim/netmatrix.py`` (channels, rows, totals,
  ``reconcile``, ``top_pairs``, ``faulted_pairs``, ``cut_advisor``)
  against its original on the same inputs;
- ``purge_dst_matrix``, and ``enqueue(want_flow=True)`` (alone and with
  the fate) under every sorted-path feature, direct slots, control lanes
  and a fault schedule;
- whole runs with ``telemetry=True, netmatrix=True`` over the workloads
  of ``test_torch_telemetry.WORKLOADS``: every ``netmatrix_cb`` delta,
  ``results()['net_matrix']`` and ``['net_bw_hiwater']`` and every carry
  leaf, the matrix reconciling with the flow totals, crash purges in the
  fault cells and echo traffic in the hosts row;
- the matrix perturbs nothing: a plan that opted out of provenance runs
  as it does without the plane.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_faults import ENQUEUE_SPECS, EVERY_KIND, _both_groups
from test_torch_net_features import _inputs, _jax_state, _port_state
from test_torch_plans import _smoke_faults
from test_torch_telemetry import check_telemetry, programs, run_both, run_recording
from testground_tpu.sim import faults as jfaults
from testground_tpu.sim import net as jnet
from testground_tpu.sim import netmatrix as jnm
from testground_tpu_torch.sim import faults as pfaults
from testground_tpu_torch.sim import net as pnet
from testground_tpu_torch.sim import netmatrix as pnm
from testground_tpu_torch.sim.engine import SimProgram

# ------------------------------------------------------- the host module


def test_netmatrix_constants_pinned():
    for name in ("NM_CHANNELS", "NM_CHANNEL_NAMES", "NM_SENT", "NM_ENQUEUED",
                 "NM_DELIVERED", "NM_DROPPED", "NM_REJECTED", "NM_FAULT", "NM_MSG_BYTES"):
        assert getattr(pnm, name) == getattr(jnm, name), name
    assert pnm.NM_MSG_BYTES == pnet.MSG_BYTES == jnet.MSG_BYTES
    assert sorted(pnm.__all__) == sorted(jnm.__all__)


def _matrix(rng, gh=4):
    mat = rng.integers(0, 50, (pnm.NM_CHANNELS, gh, gh)) * (rng.random((1, gh, gh)) < 0.6)
    return mat.astype(np.int64)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_matrix_rows_totals_and_pairs_match(seed, tmp_path):
    rng = np.random.default_rng(seed)
    deltas = [_matrix(rng) for _ in range(3)]
    rows = [pnm.delta_row(d, 8 * (i + 1), 8, {"run": "r"}) for i, d in enumerate(deltas)]
    assert rows == [jnm.delta_row(d, 8 * (i + 1), 8, {"run": "r"})
                    for i, d in enumerate(deltas)]
    assert pnm.delta_cells(deltas[0]) == jnm.delta_cells(deltas[0])
    mat = pnm.matrix_from_rows(rows, 4)
    np.testing.assert_array_equal(mat, jnm.matrix_from_rows(rows, 4))
    np.testing.assert_array_equal(mat, sum(deltas))
    assert pnm.matrix_totals(mat) == jnm.matrix_totals(mat)
    np.testing.assert_array_equal(pnm.matrix_bytes(mat), jnm.matrix_bytes(mat))
    flows = {"msgs_sent": int(mat[0].sum()), "msgs_enqueued": int(mat[1].sum()) + seed,
             "msgs_delivered": 0, "fault_dropped": int(mat[5].sum())}
    assert pnm.reconcile(mat, flows) == jnm.reconcile(mat, flows)
    for k in (0, 2, 5, 100):
        assert pnm.top_pairs(mat, k) == jnm.top_pairs(mat, k)
    path = tmp_path / "nm.jsonl"
    path.write_text("\n".join(__import__("json").dumps(r) for r in rows) + "\n{trunc")
    assert list(pnm.iter_rows(str(path))) == list(jnm.iter_rows(str(path)))


@pytest.mark.parametrize("layout,tables", [
    ([("g0", 4)], {"": EVERY_KIND}),
    ([("all", 8)], "smoke"),
    ([("a", 3), ("b", 5)], {"": [
        {"kind": "partition", "start_ms": 3, "duration_ms": 5, "group": "a",
         "to_group": "b", "bidirectional": False},
        {"kind": "loss_burst", "start_ms": 0, "duration_ms": 9, "loss": 40.0, "group": "b"}]}),
], ids=["every-kind", "chaos-smoke", "two-groups"])
def test_faulted_pairs_match(layout, tables):
    jg, pg = _both_groups(layout)
    tables = _smoke_faults() if tables == "smoke" else tables
    js = jfaults.build_fault_schedule(jg, tables, 1.0)
    ps = pfaults.build_fault_schedule(pg, tables, 1.0)
    np.testing.assert_array_equal(pnm.faulted_pairs(ps, pg), jnm.faulted_pairs(js, jg))
    np.testing.assert_array_equal(pnm.faulted_pairs(None, pg), jnm.faulted_pairs(None, jg))


@pytest.mark.parametrize("g_n,shards,seed", [(6, 2, 0), (9, 3, 1), (24, 4, 2), (5, 8, 3)])
def test_cut_advisor_matches(g_n, shards, seed):
    rng = np.random.default_rng(seed)
    traffic = rng.integers(0, 1000, (g_n, g_n)) * (rng.random((g_n, g_n)) < 0.4)
    labels = [f"g{i}" for i in range(g_n)]
    assert pnm.cut_advisor(traffic, shards, labels) == jnm.cut_advisor(traffic, shards, labels)
    assert pnm.cut_advisor(np.zeros((g_n, g_n)), shards) == \
        jnm.cut_advisor(np.zeros((g_n, g_n)), shards)


@pytest.mark.parametrize("args", [(np.zeros((2, 3)), 2), (np.zeros((2, 2)), 0),
                                  (np.zeros((2, 2)), 2, ["a"])])
def test_cut_advisor_refusals_match(args):
    with pytest.raises(ValueError) as jerr:
        jnm.cut_advisor(*args)
    with pytest.raises(ValueError) as perr:
        pnm.cut_advisor(*args)
    assert str(perr.value) == str(jerr.value)


# ------------------------------------------------------- device halves


@pytest.mark.parametrize("hosts", [0, 3], ids=["no-hosts", "3-hosts"])
@pytest.mark.parametrize("seed", [1, 2])
def test_purge_dst_matrix_matches_jax(seed, hosts):
    """Each purged message charged to (sender group, crashed receiver
    group); host lanes on the hosts row."""
    x = _inputs(seed, n=16, fill=0.5)
    rng = np.random.default_rng(seed)
    mask = rng.random(16) < 0.3
    mask[16 - hosts:] = False
    n_g = 3
    group_of = np.concatenate([np.sort(rng.integers(0, n_g, 16 - hosts)),
                               np.full(hosts, n_g)]).astype(np.int32)
    gh = n_g + (1 if hosts else 0)
    jcal, _ = _jax_state(x)
    pcal, _ = _port_state(x)
    jcal, jp, jmat = jnet.purge_dst_matrix(jcal, jnp.asarray(mask), group_of, gh)
    pcal, pp, pmat = pnet.purge_dst_matrix(pcal, torch.from_numpy(mask),
                                           torch.from_numpy(group_of), gh)
    assert int(pp) == int(jp) == int(pmat.sum()) > 0
    assert pmat.dtype == torch.int32 and pmat.shape == (gh, gh)
    np.testing.assert_array_equal(pmat.numpy(), np.asarray(jmat))
    np.testing.assert_array_equal(pcal.src.numpy(), np.asarray(jcal.src))


def test_purge_dst_matrix_needs_provenance():
    x = _inputs(1, track_src=False)
    pcal, _ = _port_state(x)
    with pytest.raises(ValueError, match="track_src"):
        pnet.purge_dst_matrix(pcal, torch.ones(16, dtype=torch.bool),
                              torch.zeros(16, dtype=torch.int32), 1)


# every sorted-path feature and the transport shapes the plans reach
FLOW_CASES = {
    "all-but-duplicate": (jnet.SHAPING_NO_DUPLICATE, {}, {}),
    "full-shaping": (jnet.FULL_SHAPING, {}, {}),
    "duplicate-nostack": (("latency", "duplicate", "loss", "filters"), {}, {"stacking": False}),
    "bandwidth-queue": (("latency", "jitter", "loss", "bandwidth_queue", "filters"),
                        {"backlog": True}, {"bw_queue_cap": 6}),
    "filter-rules": (("latency", "loss", "filter_rules"), {"n_rules": 2}, {}),
    "bool-occupancy": (("latency", "duplicate", "loss"), {"track_src": False}, {}),
}


def dense_flow(fb) -> np.ndarray:
    """The port's flow channels as the reference's ``[4, M]``: an absent
    channel (no filter, no fault term) is all zero there."""
    m = fb.flow[0].shape[0]
    return np.stack([np.zeros(m, np.int32) if c is None else c.numpy() for c in fb.flow])


def _flow_both(x, t, seed, features, backlog=False, **kw):
    key = jax.random.key(seed)
    jcal, jfb = jnet.enqueue(
        *_jax_state(x, backlog), jnp.asarray(x["dst"]), jnp.asarray(x["payload"]),
        jnp.asarray(x["valid"]), jnp.int32(t), 1.0, key, features=features, **kw)
    kd = tuple(int(v) for v in np.asarray(jax.random.key_data(key)))
    pcal, pfb = pnet.enqueue(
        *_port_state(x, backlog), torch.from_numpy(x["dst"]),
        torch.from_numpy(x["payload"]), torch.from_numpy(x["valid"]),
        torch.tensor(t, dtype=torch.int32), 1.0, kd, features=features, **kw)
    np.testing.assert_array_equal(pcal.occupancy_plane.numpy(),
                                  np.asarray(jcal.occupancy_plane))
    for f in ("fate", "sent", "enqueued", "fault_dropped"):
        a, b = getattr(jfb, f), getattr(pfb, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert b.dtype == torch.int32, f
            np.testing.assert_array_equal(b.numpy(), np.asarray(a), err_msg=f)
    assert (jfb.flow is None) == (pfb.flow is None)
    if pfb.flow is not None:
        assert all(c is None or c.dtype == torch.int32 for c in pfb.flow)
        np.testing.assert_array_equal(dense_flow(pfb), np.asarray(jfb.flow))
    return pfb


@pytest.mark.parametrize("fate", [False, True], ids=["flow", "flow+fate"])
@pytest.mark.parametrize("case", list(FLOW_CASES))
def test_enqueue_flow_matches_jax(case, fate):
    """The ``[4, M]`` flow: duplicate copies add up where the fate takes
    the max; per message and in total, sent = enqueued + rejected +
    fault-dropped + dropped closes. Without faults the fault-killed channel
    is absent, and so is the rejected one without a filter feature."""
    features, state, kw = FLOW_CASES[case]
    x = _inputs(7, o=3, n_rules=state.get("n_rules", 0),
                track_src=state.get("track_src", True))
    fb = _flow_both(x, 5, 7, features, backlog=state.get("backlog", False),
                    want_flow=True, want_fate=fate, **kw)
    assert fb.flow[3] is None
    assert (fb.flow[2] is None) == ("filters" not in features
                                    and "filter_rules" not in features)
    flow = dense_flow(fb)
    assert flow.shape == (4, x["valid"].size)
    assert int(flow[0].sum()) == int(fb.sent) and int(flow[1].sum()) == int(fb.enqueued)
    assert (flow[0] - flow[1] - flow[2] - flow[3] >= 0).all()
    if "duplicate" in features:
        assert flow[0].max() == 2 and flow[1].max() == 2


@pytest.mark.parametrize("hosts", [0, 2], ids=["no-hosts", "2-hosts"])
def test_enqueue_flow_with_faults_dead_and_control_lanes_matches_jax(hosts):
    n_inst = 16 - hosts
    x = _inputs(26, n=16, o=3, w=2)
    x["dst"][:, ::5] = 14
    dead = np.random.default_rng(6).random(16) < 0.2
    dead[n_inst:] = False
    jg, pg = _both_groups([("g0", n_inst)])
    # each package lowers its own schedule
    key = jax.random.key(6)
    kw = dict(features=jnet.FULL_SHAPING, control_start=n_inst if hosts else None,
              want_flow=True, want_fate=True)
    jcal, jfb = jnet.enqueue(
        *_jax_state(x), jnp.asarray(x["dst"]), jnp.asarray(x["payload"]),
        jnp.asarray(x["valid"]), jnp.int32(6), 1.0, key, dead=jnp.asarray(dead),
        faults=jfaults.build_fault_schedule(jg, {"": ENQUEUE_SPECS}, 1.0), **kw)
    kd = tuple(int(v) for v in np.asarray(jax.random.key_data(key)))
    pcal, pfb = pnet.enqueue(
        *_port_state(x), torch.from_numpy(x["dst"]), torch.from_numpy(x["payload"]),
        torch.from_numpy(x["valid"]), torch.tensor(6, dtype=torch.int32), 1.0, kd,
        dead=torch.from_numpy(dead),
        faults=pfaults.build_fault_schedule(pg, {"": ENQUEUE_SPECS}, 1.0), **kw)
    np.testing.assert_array_equal(pfb.fate.numpy(), np.asarray(jfb.fate))
    np.testing.assert_array_equal(dense_flow(pfb), np.asarray(jfb.flow))
    np.testing.assert_array_equal(pcal.src.numpy(), np.asarray(jcal.src))
    assert int(pfb.flow[3].sum()) == int(pfb.fault_dropped) > 0


@pytest.mark.parametrize("track_src", [True, False], ids=["int32-occ", "bool-occ"])
def test_enqueue_flow_direct_mode_matches_jax(track_src):
    x = _inputs(3, o=2, track_src=track_src, fill=0.0)
    rng = np.random.default_rng(3)
    x["dst"] = np.stack([rng.permutation(16), rng.permutation(16)]).astype(np.int32)
    x["dst"][0, :2] = [-1, 16]
    fb = _flow_both(x, 4, 3, ("latency", "loss"), slot_mode="direct", want_flow=True,
                    want_fate=True)
    assert int(fb.flow[1].sum()) == int(fb.enqueued) > 0


# ------------------------------------------------------------ whole runs


def _check_matrix(res, prog, label):
    mat = np.asarray(res["net_matrix"])
    gh = len(prog.groups) + (1 if prog.hosts else 0)
    assert mat.shape == (pnm.NM_CHANNELS, gh, gh)
    assert pnm.reconcile(mat, res) == [], label
    return mat


@pytest.mark.parametrize("name", [
    "sustained", "ping-pong", "storm", "flood", "barrier", "dup-ring", "subtree",
    "traffic-shaped", "chaos", "additional-hosts", "placebo-mid-chunk",
])
def test_run_with_the_matrix_matches_jax(name):
    res, rec, prog = run_both(name, telemetry=True, netmatrix=True)
    check_telemetry(res, rec, prog, name)
    mat = _check_matrix(res, prog, name)
    np.testing.assert_array_equal(sum(rec["nm"]), mat)
    assert ("net_bw_hiwater" in res) == (name == "traffic-shaped")
    if name == "traffic-shaped":
        assert max(res["net_bw_hiwater"]) > 0
    if name == "chaos":
        # every crash purge lands in a fault cell toward the crashed group
        assert res["faults_crashed"] > 0 and mat[pnm.NM_FAULT].sum() == res["fault_dropped"] > 0
    if name == "additional-hosts":
        # the echo traffic: requests to the hosts column, echoes from the hosts row
        assert mat[pnm.NM_DELIVERED][:2, 2].sum() > 0
        assert mat[pnm.NM_DELIVERED][2, :2].sum() > 0
    if name == "dup-ring":
        # copies count as sent, in the sender's cell as in the total
        assert mat[pnm.NM_SENT].sum() == res["msgs_sent"] > 8 * 32


@pytest.mark.parametrize("name", ["storm", "flood", "chaos"])
def test_the_matrix_perturbs_nothing(name):
    """With the matrix forcing the provenance plane on, a plan that opted
    out of it is served all-zero src: every result and state equals the
    run without the plane."""
    _, plain = programs(name, telemetry=True)
    _, nm = programs(name, telemetry=True, netmatrix=True)
    a = run_recording(plain, seed=3, max_ticks=512)
    b = run_recording(nm, seed=3, max_ticks=512)
    for k in a[0]:
        if k in ("groups", "states", "compile_secs", "carry_bytes", "net_matrix"):
            continue
        np.testing.assert_array_equal(np.asarray(b[0][k]), np.asarray(a[0][k]), err_msg=k)
    for sa, sb in zip(a[0]["states"], b[0]["states"]):
        for k in sa:
            np.testing.assert_array_equal(sb[k], sa[k], err_msg=k)
    for x, y in zip(a[1]["tele"], b[1]["tele"]):
        np.testing.assert_array_equal(y, x)
    assert ("cal.src" in b[2]) and (name == "chaos" or "cal.valid" in a[2])


def test_matrix_without_telemetry_refused_like_reference():
    with pytest.raises(ValueError) as jerr:
        programs("sustained", netmatrix=True)
    _, pprog = programs("sustained", telemetry=True)
    with pytest.raises(ValueError) as perr:
        SimProgram(pprog.tc, pprog.groups, device="cpu", netmatrix=True)
    assert "telemetry" in str(jerr.value)
    assert str(perr.value) == str(jerr.value)
