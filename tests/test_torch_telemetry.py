"""The port's telemetry and latency planes against the JAX package on the
CPU, bit for bit:

- the copied host module ``sim/telemetry.py`` (schema, bins, file names,
  percentiles, row decoding, totals, the jsonl reader, the span tracer)
  against its original on the same inputs;
- ``sync_occupancy`` and ``latency_histogram`` (delays at every power of
  two and past the open last bin, host lanes out of range);
- whole runs with ``telemetry=True``: every ``telemetry_cb`` block, every
  ``lat_hist_cb`` delta, ``results()['lat_hist']`` and every carry leaf,
  over the workloads of :data:`WORKLOADS`, and one run against the JAX
  package's ``transport="pallas"`` (its kernels in interpret mode);
- a resume from a JAX carry taken mid-run with every plane on;
- the zero-overhead contract: with every plane off a run enters no plane
  code and issues no plane op, and with every plane on it reads tensors
  on the host no more often (ops counted with a ``TorchDispatchMode``).

This module also holds the run harness of ``test_torch_netmatrix.py`` and
``test_torch_trace.py``: :data:`WORKLOADS`, :func:`programs`,
:func:`run_recording` and :func:`assert_planes_equal`.
"""

import collections
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from test_torch_engine import (
    assert_carries_equal,
    assert_results_equal,
    jax_flat_carry,
)
from test_torch_plans import INLINE, _ref_plan, _smoke_faults
from testground_tpu.api import RunGroup as JRunGroup
from testground_tpu.sim import net as jnet
from testground_tpu.sim import sync_kernel as jsync
from testground_tpu.sim import telemetry as jtele
from testground_tpu.sim.api import Inbox as JInbox
from testground_tpu.sim.engine import SimProgram as JSimProgram
from testground_tpu.sim.engine import build_groups as jbuild
from testground_tpu.sim.executor import instantiate_testcase as jinst
from testground_tpu.sim.executor import load_sim_testcases as jload
from testground_tpu.sim.faults import build_fault_schedule as jfaults
from testground_tpu.sim.trace import build_trace_plan as jtrace
from testground_tpu_torch.api import RunGroup
from testground_tpu_torch.sim import net as pnet
from testground_tpu_torch.sim import sync_kernel as psync
from testground_tpu_torch.sim import telemetry as ptele
from testground_tpu_torch.sim.api import Inbox as PInbox
from testground_tpu_torch.sim.carry_io import carry_from_numpy, carry_to_numpy
from testground_tpu_torch.sim.engine import SimProgram, build_groups
from testground_tpu_torch.sim.executor import (
    instantiate_testcase,
    load_sim_testcases,
    plan_dir,
)
from testground_tpu_torch.sim.faults import build_fault_schedule as pfaults
from testground_tpu_torch.sim.netmatrix import NM_DELIVERED
from testground_tpu_torch.sim.trace import build_trace_plan as ptrace

# ------------------------------------------------------------ harness

# name: (plan, case, n or [(group id, n)], params, max_ticks, chunk, options,
#        trace tables by group id). Options: "hosts", and "faults" (tables by
# group id, or "smoke" for the chaos plan's smoke composition).
WORKLOADS = {
    "sustained": ("network", "pingpong-sustained", 16,
                  {"duration_ticks": "40", "reshape_every": "16"}, 128, 16, {},
                  {"": {"instances": "0:4"}}),
    "ping-pong": ("network", "ping-pong", 8,
                  {"latency_ms": "4", "latency2_ms": "2", "tolerance_ms": "15"}, 128, 8,
                  {}, {"": {"instances": "2:5"}}),
    # fan-in into IN_MSGS = 16 slots, bool occupancy (TRACK_SRC=False)
    "storm": ("benchmarks", "storm", 16,
              {"conn_outgoing": "3", "conn_delay_ticks": "8", "data_size_kb": "16"}, 512,
              8, {}, {"": {"fraction": 0.25, "seed": 3}}),
    # direct slots, TRACK_SRC=False
    "flood": ("benchmarks", "pingpong-flood", 8,
              {"duration_ticks": "24", "latency_ms": "3"}, 128, 8, {},
              {"": {"instances": "0:2"}}),
    # sync signals only (barrier entry events)
    "barrier": ("benchmarks", "barrier", 8, {"barrier_iterations": "2"}, 512, 8, {},
                {"": {"instances": "5:8"}}),
    # duplicate copies: a ring whose links duplicate half the messages
    # (the inline twins of test_torch_plans)
    "dup-ring": (None, "ring/duplicate", 8, {}, 128, 8, {}, {"": {"instances": "0:3"}}),
    # publishes and subscriptions
    "subtree": ("benchmarks", "subtree", 8, {"subtree_iterations": "4"}, 512, 8, {},
                {"": {"instances": "0:3"}}),
    # the HTB bandwidth_queue: the per-group backlog high-water
    "traffic-shaped": ("network", "traffic-shaped", 8, {"burst": "12", "rate": "1.5"}, 256,
                       8, {}, {"": {"instances": "0:8"}}),
    # crashes (purge attribution, status events), restarts, partitions
    "chaos": ("chaos", "chaos-barrier", 8, {}, 512, 16, {"faults": "smoke"},
              {"": {"instances": "0:8"}}),
    # two groups and a hosts row; host lanes fall out of the histogram
    "additional-hosts": ("additional_hosts", "additional_hosts", [("a", 3), ("b", 4)], {},
                         1024, 16, {"hosts": ("http-echo",)},
                         {"b": {"instances": "1:3"}, "a": {"instances": "0:1"}}),
    # done after 10 ticks, inside the second chunk: padding rows
    "placebo-mid-chunk": ("placebo", "ok", 4, {}, 64, 8, {}, {"": {"instances": "0:4"}}),
}


def _layout(n):
    return [("all", n)] if isinstance(n, int) else n


def programs(name, telemetry=False, netmatrix=False, trace=False, transport="xla",
             chunk=None, shards=None):
    """The JAX package's program and the port's for one workload, with the
    planes asked for (``trace=True`` lowers the workload's trace tables
    with each package's own ``build_trace_plan``); ``shards`` runs both on
    a mesh of that many peer shards (the JAX package's virtual CPU
    devices, the port's virtual CPU mesh). ``name`` may also be a
    workload tuple of the :data:`WORKLOADS` form."""
    spec = WORKLOADS[name] if isinstance(name, str) else name
    plan, case, n, params, _, wchunk, opts, tables = spec
    layout = _layout(n)
    jg = jbuild([JRunGroup(id=i, instances=c, parameters=dict(params)) for i, c in layout])
    pg = build_groups([RunGroup(id=i, instances=c, parameters=dict(params))
                       for i, c in layout])
    faults = opts.get("faults")
    if faults == "smoke":
        faults = _smoke_faults()
    kw = dict(test_plan=plan or "inline", test_case=case, tick_ms=1.0,
              chunk=chunk or wchunk, hosts=opts.get("hosts", ()), telemetry=telemetry,
              netmatrix=netmatrix)
    jmesh = pmesh = None
    if shards:
        from testground_tpu.sim.meshplan import make_mesh as jmake_mesh
        from testground_tpu_torch.sim.meshplan import make_mesh

        jmesh, pmesh = jmake_mesh(str(shards)), make_mesh(str(shards), device="cpu")
    if plan is None:
        jtc, ptc = INLINE[case][0]()(), INLINE[case][1]()()
    else:
        jtc = jinst(jload(_ref_plan(plan))[case], jg, 1.0)
        ptc = instantiate_testcase(load_sim_testcases(plan_dir(plan))[case], pg, 1.0)
    jprog = JSimProgram(jtc, jg, faults=jfaults(jg, faults, 1.0) if faults else None,
                        trace=jtrace(jg, tables) if trace else None, transport=transport,
                        mesh=jmesh, **kw)
    pprog = SimProgram(ptc, pg, faults=pfaults(pg, faults, 1.0) if faults else None,
                       trace=ptrace(pg, tables) if trace else None, device="cpu",
                       mesh=pmesh, **kw)
    return jprog, pprog


def run_recording(prog, **kw):
    """Run with every plane callback recording; returns ``(results,
    {"tele", "lat", "nm", "trace"}: per-chunk arrays, flat carry, carry)``.
    The carry is flattened at each chunk (the JAX chunk donates it)."""
    rec = {k: [] for k in ("tele", "lat", "nm", "trace")}
    last = {}
    flat = carry_to_numpy if isinstance(prog, SimProgram) else jax_flat_carry
    res = prog.run(
        telemetry_cb=lambda b: rec["tele"].append(np.asarray(b)),
        lat_hist_cb=lambda d: rec["lat"].append(np.asarray(d)),
        netmatrix_cb=lambda d: rec["nm"].append(np.asarray(d)),
        trace_cb=lambda b: rec["trace"].append(np.asarray(b)),
        observer=lambda k, c: last.__setitem__("c", (flat(c), c)),
        **kw)
    return res, rec, last["c"][0], last["c"][1]


def assert_planes_equal(j, p, label):
    """Every recorded block and delta, dtype included, and the planes'
    ``results()`` keys."""
    (res_j, rec_j), (res_p, rec_p) = j, p
    for k in rec_j:
        assert len(rec_p[k]) == len(rec_j[k]), (label, k)
        for i, (a, b) in enumerate(zip(rec_j[k], rec_p[k])):
            assert b.dtype == a.dtype, (label, k, i)
            np.testing.assert_array_equal(b, a, err_msg=f"{label} {k} chunk {i}")
    for k in ("lat_hist", "net_matrix", "net_bw_hiwater"):
        assert (k in res_p) == (k in res_j), (label, k)
        if k in res_j:
            assert res_p[k] == res_j[k], (label, k)


def run_both(name, seed=3, **planes):
    """Run one workload through both packages with the planes asked for;
    assert every result, block, delta and carry leaf equal; return the
    port's ``(results, recorded, program)``."""
    jprog, pprog = programs(name, **planes)
    max_ticks = WORKLOADS[name][4]
    res_j, rec_j, flat_j, _ = run_recording(jprog, seed=seed, max_ticks=max_ticks)
    res_p, rec_p, flat_p, _ = run_recording(pprog, seed=seed, max_ticks=max_ticks)
    assert_results_equal(res_j, res_p, name)
    assert_planes_equal((res_j, rec_j), (res_p, rec_p), name)
    assert_carries_equal(flat_j, pprog, flat_p, name)
    return res_p, rec_p, pprog


def flow_totals(res) -> dict:
    return {k: res[k] for k in ("msgs_sent", "msgs_enqueued", "msgs_delivered",
                                "msgs_dropped", "msgs_rejected", "fault_dropped")}


def check_telemetry(res, rec, prog, label):
    """What the reference's own tests hold of the telemetry plane: the rows
    sum to the flow totals, Σ lat_hist equals the plan messages delivered
    (host lanes out), padding rows are -1 throughout."""
    rows = ptele.rows_from_blocks(rec["tele"], tuple(g.id for g in prog.groups))
    totals = ptele.telemetry_totals(rows)
    assert totals == {
        "delivered": res["msgs_delivered"], "sent": res["msgs_sent"],
        "enqueued": res["msgs_enqueued"], "dropped": res["msgs_dropped"],
        "rejected": res["msgs_rejected"], "fault_dropped": res["fault_dropped"],
    }, label
    blocks = np.concatenate(rec["tele"])
    pad = blocks[:, 0] < 0
    assert (blocks[pad] == -1).all(), label
    assert [r["tick"] for r in rows] == list(range(len(rows))), label
    hist = np.asarray(res["lat_hist"])
    assert hist.shape == (len(prog.groups), ptele.LATENCY_BINS)
    host_deliveries = 0
    if "net_matrix" in res:
        host_deliveries = int(np.asarray(res["net_matrix"])[NM_DELIVERED][:, len(
            prog.groups):].sum())
    elif prog.hosts:
        return
    assert int(hist.sum()) == res["msgs_delivered"] - host_deliveries, label
    assert int(sum(d.sum() for d in rec["lat"])) == int(hist.sum())


# ---------------------------------------------------- the host module


def test_telemetry_constants_pinned():
    for name in ("LATENCY_BINS", "TELEMETRY_FIXED_COLUMNS", "SIM_SERIES_FILE", "SPAN_FILE",
                 "LATENCY_FILE", "PERF_FILE", "PHASES_FILE", "NETMATRIX_FILE"):
        assert getattr(ptele, name) == getattr(jtele, name), name
    assert ptele.latency_bin_edges() == jtele.latency_bin_edges()
    assert sorted(ptele.__all__) == sorted(jtele.__all__)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_latency_percentiles_match(seed):
    rng = np.random.default_rng(seed)
    hist = rng.integers(0, 50, jtele.LATENCY_BINS) * (rng.random(jtele.LATENCY_BINS) < 0.6)
    for tick_ms in (1.0, 0.25, 7.5):
        for q in ((0.5, 0.95, 0.99), (0.1, 0.5), (1.0,)):
            assert ptele.latency_percentiles(hist, tick_ms, q) == \
                jtele.latency_percentiles(hist, tick_ms, q)
    assert ptele.latency_percentiles([0] * 12, 1.0) == jtele.latency_percentiles([0] * 12, 1.0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rows_from_blocks_and_totals_match(seed):
    rng = np.random.default_rng(seed)
    k = len(jtele.TELEMETRY_FIXED_COLUMNS) + 3
    blocks = [rng.integers(0, 99, (8, k)).astype(np.int32) for _ in range(3)]
    blocks[-1][5:] = -1  # padding rows
    gids = ("a", "b", "c")
    rows = ptele.rows_from_blocks(blocks, gids)
    assert rows == jtele.rows_from_blocks(blocks, gids)
    assert len(rows) == 21
    assert ptele.telemetry_totals(rows) == jtele.telemetry_totals(rows)


def test_iter_jsonl_matches(tmp_path):
    path = tmp_path / "x.jsonl"
    path.write_text('{"a": 1}\n\nnot json\n{"b": [2, 3]}\n{"trunc')
    assert list(ptele.iter_jsonl(str(path))) == list(jtele.iter_jsonl(str(path)))
    assert list(ptele.iter_jsonl(str(tmp_path / "missing"))) == []


def _span_lines(mod, path):
    tr = mod.SpanTracer(str(path), ctx={"trace_id": "t" * 32, "parent_id": "p" * 16})
    tr.start("run", plan="x")
    tr.start("chunk", i=0)
    tr.point("progress", ticks=8)
    tr.end("chunk", wall_secs=0.5)
    tr.end("run")
    tr.end("never-started")
    tr.close()
    events = [json.loads(line)["event"] for line in open(path)]
    ids = {}
    for e in events:  # the random ids, mapped to their order of appearance
        for key in ("span_id", "parent_id"):
            if e[key] and e[key] != "p" * 16:
                e[key] = ids.setdefault(e[key], len(ids))
        e.pop("wall_ns")
        if e["span"] == "run" and e["type"] == "span_end":
            e.pop("wall_secs")
    return events


def test_span_tracer_lines_match(tmp_path):
    assert _span_lines(ptele, tmp_path / "p") == _span_lines(jtele, tmp_path / "j")
    assert not ptele.SpanTracer(None).enabled
    assert len(ptele.new_trace_id()) == 32 and len(ptele.new_span_id()) == 16


# ------------------------------------------------------- device halves


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sync_occupancy_matches_jax(seed):
    rng = np.random.default_rng(seed)
    n, s, t, cap, pw = 9, 2, 3, 5, 2
    js = jsync.make_sync_state(n, s, t, cap, pw)
    ps = psync.make_sync_state(n, s, t, cap, pw, device="cpu")
    for _ in range(3):
        args = [rng.integers(0, 2, (s, n)).astype(np.int32),
                rng.integers(0, 99, (t, pw, n)).astype(np.int32),
                rng.random((t, n)) < 0.4,
                rng.integers(-1, 3, (t, n)).astype(np.int32)]
        js = jsync.update_sync(js, *[jnp.asarray(a) for a in args])
        ps = psync.update_sync(ps, *[torch.from_numpy(a) for a in args])
        for a, b in zip(jsync.sync_occupancy(js), psync.sync_occupancy(ps)):
            assert b.dtype == torch.int32 and b.shape == ()
            assert int(b) == int(a)
    assert int(psync.sync_occupancy(ps)[1]) > 0


# (lanes, slots, groups, host lanes, horizon, t)
HIST_CASES = {
    "every-power-of-two": (1100, 4, 3, 0, 8, 5000),
    "host-lanes": (37, 4, 2, 5, 16, 3000),
    "one-slot-one-group": (64, 1, 1, 0, 4, 70),
    "sixteen-slots": (50, 16, 2, 2, 8, 9000),
}


@pytest.mark.parametrize("name", list(HIST_CASES))
def test_latency_histogram_matches_jax(name):
    """Delays run over 0..L·N·SLOTS (every power of two, its neighbours, and
    past the open last bin's 2^11); lanes past the groups (hosts) and
    invalid slots fall out; ``sum(hist)`` is the valid slots of plan
    lanes."""
    lanes, slots, n_groups, hosts, horizon, t = HIST_CASES[name]
    rng = np.random.default_rng(lanes)
    ns = lanes * slots
    etick = rng.integers(0, t, (horizon, ns)).astype(np.int32)
    b = t % horizon
    etick[b] = t - np.arange(ns) % (t + 1)  # delays 0, 1, 2, ... in the row
    valid = rng.random((slots, lanes)) < 0.8
    group_of = np.concatenate([np.sort(rng.integers(0, n_groups, lanes - hosts)),
                               np.full(hosts, n_groups)]).astype(np.int32)
    occ = np.zeros((horizon, ns), np.int32)
    jcal = jnet.Calendar(payload=(jnp.asarray(occ),), src=jnp.asarray(occ), valid=None,
                         etick=jnp.asarray(etick), slots=slots, flat=False,
                         horizon=horizon)
    pcal = pnet.Calendar(payload=(torch.from_numpy(occ),), src=torch.from_numpy(occ),
                         valid=None, etick=torch.from_numpy(etick), slots=slots)
    jin = JInbox(payload=jnp.zeros((1, slots, lanes), jnp.int32),
                 src=jnp.zeros((slots, lanes), jnp.int32), valid=jnp.asarray(valid))
    pin = PInbox(payload=torch.zeros((1, slots, lanes), dtype=torch.int32),
                 src=torch.zeros((slots, lanes), dtype=torch.int32),
                 valid=torch.from_numpy(valid))
    want = np.asarray(jnet.latency_histogram(jcal, jin, jnp.int32(t), group_of, n_groups,
                                             jtele.LATENCY_BINS))
    got = pnet.latency_histogram(pcal, pin, torch.tensor(t, dtype=torch.int32),
                                 torch.from_numpy(group_of), n_groups, ptele.LATENCY_BINS)
    assert got.dtype == torch.int32 and got.shape == (n_groups, ptele.LATENCY_BINS)
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got.sum()) == int((valid & (group_of < n_groups)[None, :]).sum())
    if name == "every-power-of-two":
        assert (want.sum(axis=0) > 0).all()  # every bin hit, the open last one too


def test_latency_histogram_needs_the_etick_plane():
    cal = pnet.Calendar.empty(4, 3, 2, 1, device="cpu")
    inbox = PInbox(payload=torch.zeros((1, 2, 3), dtype=torch.int32),
                   src=torch.zeros((2, 3), dtype=torch.int32),
                   valid=torch.zeros((2, 3), dtype=torch.bool))
    with pytest.raises(ValueError, match="track_etick"):
        pnet.latency_histogram(cal, inbox, torch.tensor(1, dtype=torch.int32),
                               torch.zeros(3, dtype=torch.int32), 1, 12)


# ------------------------------------------------------------ whole runs


@pytest.mark.parametrize("name", list(WORKLOADS))
def test_run_with_telemetry_matches_jax(name):
    res, rec, prog = run_both(name, telemetry=True)
    check_telemetry(res, rec, prog, name)
    assert "net_matrix" not in res and not rec["nm"] and not rec["trace"]
    assert len(rec["tele"]) == res["ticks"] // prog.chunk
    if name == "placebo-mid-chunk":
        assert (np.concatenate(rec["tele"])[:, 0] < 0).any()


def test_run_with_every_plane_matches_jax_pallas_interpret():
    """The reference's Pallas transport (its kernels in interpret mode on
    the CPU) writes the etick plane inside its commit kernel; the port's
    plain K1 matches it."""
    jprog, pprog = programs("ping-pong", telemetry=True, netmatrix=True, trace=True,
                            transport="pallas")
    res_j, rec_j, flat_j, _ = run_recording(jprog, seed=4, max_ticks=64)
    res_p, rec_p, flat_p, _ = run_recording(pprog, seed=4, max_ticks=64)
    assert_results_equal(res_j, res_p, "pallas")
    assert_planes_equal((res_j, rec_j), (res_p, rec_p), "pallas")
    assert_carries_equal(flat_j, pprog, flat_p, "pallas")
    assert sum(res_p["lat_hist"][0]) > 0


@pytest.mark.parametrize("k", [8, 16])
def test_resume_from_jax_carry_with_every_plane(k):
    """The JAX run stops at tick k (inside the schedule) with every plane
    on; its carry (etick plane, flushed histogram and matrix) and its
    accumulated histogram and matrix cross into the port; both run on and
    agree in every block, delta, result and leaf."""
    jprog, pprog = programs("chaos", telemetry=True, netmatrix=True, trace=True, chunk=8)
    res_mid, _, flat_mid, jcarry = run_recording(jprog, seed=5, max_ticks=k)
    assert "cal.etick" in flat_mid and "net_mat" in flat_mid and "lat_hist" in flat_mid
    init = dict(lat_hist_init=res_mid["lat_hist"], net_mat_init=res_mid["net_matrix"])
    j = run_recording(jprog, seed=5, max_ticks=512, resume_carry=jcarry, resume_ticks=k,
                      **init)
    p = run_recording(pprog, max_ticks=512, resume_carry=carry_from_numpy(flat_mid, pprog),
                      resume_ticks=k, **init)
    assert_results_equal(j[0], p[0], f"resume at {k}")
    assert_planes_equal(j[:2], p[:2], f"resume at {k}")
    assert_carries_equal(j[2], pprog, p[2], f"resume at {k}")
    assert p[0]["faults_restarted"] > 0


def test_telemetry_schema_matches_jax():
    jprog, pprog = programs("additional-hosts", telemetry=True)
    assert pprog.telemetry_schema() == jprog.telemetry_schema()
    assert pprog.telemetry_schema()[-2:] == ("live_a", "live_b")


# -------------------------------------------------------- zero overhead


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[func.overloadpacket.__name__] += 1
        return func(*args, **(kwargs or {}))


# (plan, case, n, params, options, max_ticks): the runs the zero-overhead
# contract is held on
_OFF_RUNS = {
    "sustained": ("network", "pingpong-sustained", 16,
                  {"duration_ticks": "40", "reshape_every": "16"}, {}, 64),
    "storm": ("benchmarks", "storm", 16,
              {"conn_outgoing": "3", "conn_delay_ticks": "8", "data_size_kb": "16"}, {}, 64),
    "flood": ("benchmarks", "pingpong-flood", 8, {"duration_ticks": "40"}, {}, 64),
    "chaos": ("chaos", "chaos-barrier", 8, {}, {"faults": "smoke"}, 128),
    "hosts": ("additional_hosts", "additional_hosts", 8, {}, {"hosts": ("http-echo",)}, 64),
}
# ops that only the planes issue on these runs: the histogram's bins, the
# privatised counts and their folds, the high-water, the live counts
_PLANE_OPS = {"bucketize", "scatter_add", "scatter_add_", "scatter_reduce",
              "scatter_reduce_", "index_add", "index_add_"}
# ops that read a tensor on the host: on a card each is a wait
_HOST_READS = {"_local_scalar_dense", "nonzero", "item"}


def _off_counts(name, **planes):
    plan, case, n, params, opts, max_ticks = _OFF_RUNS[name]
    groups = build_groups([RunGroup(id="all", instances=n, parameters=params)])
    tc = instantiate_testcase(load_sim_testcases(plan_dir(plan))[case], groups, 1.0)
    faults = pfaults(groups, _smoke_faults(), 1.0) if opts.get("faults") else None
    if planes.get("trace"):
        planes["trace"] = ptrace(groups, {"all": {"instances": "0:2"}})
    prog = SimProgram(tc, groups, chunk=16, device="cpu", faults=faults,
                      hosts=opts.get("hosts", ()), **planes)
    mode = _CountOps()
    with mode:
        prog.run(seed=3, max_ticks=max_ticks)
    return dict(sorted(mode.counts.items()))


def _refuse(*a, **k):
    raise AssertionError("plane code ran with every plane off")


@pytest.mark.parametrize("name", list(_OFF_RUNS))
def test_planes_off_enter_no_plane_code(name, monkeypatch):
    """The zero-overhead contract (the reference pins it by jaxpr
    equality): with telemetry, the matrix and the recorder off, a run
    enters no plane code, asks the transport for no fate or flow, and
    issues no op that only the planes issue."""
    from testground_tpu_torch.sim import engine as peng

    for fn in ("latency_histogram", "purge_dst_matrix", "sync_occupancy"):
        monkeypatch.setattr(peng, fn, _refuse)
    for meth in ("_netmatrix_delivered", "_netmatrix_send", "_telemetry_row",
                 "_trace_rows"):
        monkeypatch.setattr(peng.SimProgram, meth, _refuse)
    real_enqueue = peng.enqueue

    def enqueue(*a, want_fate=False, want_flow=False, **k):
        assert not (want_fate or want_flow), "the transport was asked for a plane"
        return real_enqueue(*a, **k)

    monkeypatch.setattr(peng, "enqueue", enqueue)
    counts = _off_counts(name)
    assert not _PLANE_OPS & set(counts), sorted(_PLANE_OPS & set(counts))
    assert counts.get("sort", 0) + counts.get("nonzero", 0) > 0  # the transport ran


@pytest.mark.parametrize("name", list(_OFF_RUNS))
def test_planes_on_read_nothing_more_on_the_host(name):
    """No host wait added: with every plane on a run reads tensors on the
    host exactly as often as with every plane off (the chunk flush rides
    the done flag's read)."""
    off = _off_counts(name)
    on = _off_counts(name, telemetry=True, netmatrix=True, trace=True)
    assert {k: on.get(k, 0) for k in _HOST_READS} == {k: off.get(k, 0) for k in _HOST_READS}
    assert _PLANE_OPS & set(on)
