"""The port's mesh path against the JAX package's, on the CPU, bit for bit,
under the conftest's virtual 8-device CPU mesh (the JAX side) and the
port's virtual CPU mesh (every shard on the CPU):

- ``sim/meshplan.py`` against the reference's answers: shapes, axis
  names, layout strings, every rule of the table (with the lead and rank
  clamps), peer shards, divisibility, exchange bytes, and the refusals;
- ``commit_calendar_sharded_plain`` against ``_commit_calendar_sharded``
  and ``pop_bucket_sharded_plain`` against ``_pop_bucket_sharded`` (the
  Pallas kernels in interpret mode, under ``shard_map``), over shard
  counts, stacking, bool and int32 occupancy, the etick plane and SLOTS;
  and the shard-major key's claim: its equal-key classes are the
  bucket-major key's, so a stream with fan-in past SLOTS lands in the same
  slots either way;
- ``SimProgram(mesh=...)`` runs against the reference's meshed runs and
  against the port's own unmeshed runs: every ``results()`` key, carry
  leaf, counter block, histogram, matrix delta and trace block;
- the divisibility refusal, and ``execute_sim_run`` with ``mesh="4"``: its
  journal (the ``sim.mesh`` block) and run directory.

Inputs are made from a seed with numpy and handed to both packages.
"""

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from test_torch_engine import (
    assert_carries_equal,
    assert_results_equal,
    port_program,
    run_capturing,
)
from test_torch_executor import REF_PLANS, _execute, _journal, _read_tree
from test_torch_telemetry import (
    WORKLOADS,
    assert_planes_equal,
    programs,
    run_recording,
)
from testground_tpu.sim import meshplan as jmp
from testground_tpu.sim import net as jnet
from testground_tpu.sim.pallas_transport import (
    _commit_calendar_sharded,
    _pop_bucket_sharded,
)
from testground_tpu_torch.api import OutputsEnv, RunGroup, RunInput
from testground_tpu_torch.rpc import discard_writer
from testground_tpu_torch.sim import cuda_transport as ct
from testground_tpu_torch.sim import executor as pexec
from testground_tpu_torch.sim import meshplan as pmp
from testground_tpu_torch.sim import net as pnet
from testground_tpu_torch.sim.carry_io import carry_to_numpy
from testground_tpu_torch.sim.engine import SimProgram, build_groups

CPU = torch.device("cpu")


def _cpu_mesh(shards):
    return pmp.make_mesh(str(shards), device="cpu")


def _split_mesh(shards):
    """The several-part layout on one device: shard 0 alone, the rest in
    one or two tensors."""
    cuts = sorted({0, 1, max(2, shards // 2), shards})
    return pmp.TorchMesh((CPU,) * shards,
                         parts=tuple((CPU, a, b) for a, b in zip(cuts, cuts[1:])))


# ------------------------------------------------------------- meshplan


@pytest.mark.parametrize("text", ["4", "2x4", "2×4", "1", 8, "nope", "", "2x2x2", "0",
                                  "-1x2"])
def test_parse_mesh_shape_matches(text):
    try:
        want = jmp.parse_mesh_shape(text)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            pmp.parse_mesh_shape(text)
        assert str(got.value) == str(e)
    else:
        assert pmp.parse_mesh_shape(text) == want


def test_axis_names_layouts_and_peer_shards_match():
    for ndim in (1, 2):
        assert pmp.mesh_axis_names(ndim) == jmp.mesh_axis_names(ndim)
    assert pmp.layout_str(None) == jmp.layout_str(None) == "1"
    assert pmp.peer_shards(None) == jmp.peer_shards(None) == 1
    for shape in ("4", 4, "8", "2"):
        pm, jm = _cpu_mesh(shape), jmp.make_mesh(shape)
        assert pmp.layout_str(pm) == jmp.layout_str(jm)
        assert pmp.peer_shards(pm) == jmp.peer_shards(jm)
        assert pmp.MeshPlan(pm).shards == jmp.MeshPlan(jm).shards
        assert pmp.MeshPlan(pm).runs == jmp.MeshPlan(jm).runs
        assert pmp.MeshPlan(pm).devices == jmp.MeshPlan(jm).devices
    assert pmp.make_mesh("1", device="cpu") is None and jmp.make_mesh("1") is None
    assert pmp.make_mesh(1, device="cpu") is None
    # `tg check`'s stand-in exposes only devices.size
    fake = dataclasses.make_dataclass("F", [("devices", object)])(np.zeros(4))
    assert pmp.peer_shards(fake) == jmp.peer_shards(fake) == 4
    assert pmp.layout_str(fake) == jmp.layout_str(fake) == "4"
    assert pmp.plan_for(None) is None


def test_make_mesh_devices():
    # a virtual mesh: one part on one device
    m = _cpu_mesh(4)
    assert m.devices == (CPU,) * 4 and m.parts == ((CPU, 0, 4),) and m.primary == CPU
    assert pmp.make_mesh(None, device="cpu") is None  # the CPU pool is one device
    # an explicit devices list may repeat a device
    m = pmp.make_mesh("2", devices=["cpu", "cpu", "cpu"])
    assert m.size == 2 and m.parts == ((CPU, 0, 2),)
    assert pmp.make_mesh(None, devices=["cpu", "cpu"]).size == 2
    # the reference's rule and message where devices are counted
    with pytest.raises(ValueError) as jerr:
        jmp.make_mesh("4", devices=jax.devices()[:2])
    with pytest.raises(ValueError) as perr:
        pmp.make_mesh("4", devices=["cpu", "cpu"])
    assert str(perr.value) == str(jerr.value)
    for parts in (((CPU, 0, 1), (CPU, 2, 4)), ((CPU, 0, 4), (CPU, 4, 4))):
        with pytest.raises(ValueError, match="do not tile"):
            pmp.TorchMesh((CPU,) * 4, parts=parts)


def test_mesh_refusals(monkeypatch):
    # a 2-D mesh, refused until packs on a mesh were ported: rows of peers
    m = pmp.make_mesh("2x4", device="cpu")
    assert (m.runs, m.shards, m.size) == (2, 4, 8)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pmp.make_mesh("4")


PATHS = ("status", "finished_at", "rejected", "cal.payload", "cal.payload.0",
         "cal.payload.12", "cal.src", "cal.valid", "cal.etick", "cal.flat",
         "link.egress", "link.filters", "link.region_of", "link.backlog", "link.rules",
         "link.rules.0", "sync.counts", "t", "keys", "states.0.phase", "")


@pytest.mark.parametrize("lead,ndim", [(None, None), ("runs", None), ("runs", 2),
                                       (None, 1), ("i", 1), (None, 0)])
def test_rule_table_resolves_every_path_as_the_reference(lead, ndim):
    pplan, jplan = pmp.MeshPlan(_cpu_mesh(4)), jmp.MeshPlan(jmp.make_mesh("4"))
    for path in PATHS:
        got = pplan.spec_for(path, lead=lead, ndim=ndim)
        assert tuple(got) == tuple(jplan.spec_for(path, lead=lead, ndim=ndim)), path
    assert pplan.layout_table() == jplan.layout_table()
    assert [r[:2] for r in pmp.DEFAULT_RULES] == [r[:2] for r in jmp.DEFAULT_RULES]


@pytest.mark.parametrize("counts,shards", [((32, 64), 4), ((32, 33), 4), ((5,), 1),
                                           ((7, 9, 16), 8), ((), 3)])
def test_divisibility_and_exchange_bytes_match(counts, shards):
    assert pmp.indivisible_counts(counts, shards) == jmp.indivisible_counts(counts, shards)
    for stream in (0, 1024, 12_345, 4_915_200):
        got = pmp.cross_shard_bytes_est(stream_bytes=stream, shards=shards)
        assert got == jmp.cross_shard_bytes_est(stream_bytes=stream, shards=shards)


# ------------------------------------------------- the sharded kernels


def _jax_cal(planes, slots):
    occ, pays, et = planes
    occ = jnp.asarray(occ)
    return jnet.Calendar(
        payload=tuple(jnp.asarray(p) for p in pays),
        src=None if occ.dtype == jnp.bool_ else occ,
        valid=occ if occ.dtype == jnp.bool_ else None,
        etick=None if et is None else jnp.asarray(et),
        slots=slots, flat=False, horizon=occ.shape[0],
    )


def _port_cal(planes, slots, mesh):
    occ, pays, et = planes

    def sh(a):
        x = torch.from_numpy(np.array(a))
        return x if mesh is None else pnet.to_shards(x, mesh, slots)

    return pnet.Calendar(
        payload=tuple(sh(p) for p in pays),
        src=None if occ.dtype == bool else sh(occ),
        valid=sh(occ) if occ.dtype == bool else None,
        etick=None if et is None else sh(et),
        slots=slots, mesh=mesh,
    )


def _port_planes(cal):
    planes = [cal.occupancy_plane, *cal.payload]
    if cal.etick is not None:
        planes.append(cal.etick)
    if cal.mesh is not None:
        planes = [pnet.from_shards(p, cal.slots) for p in planes]
    return [p.numpy() for p in planes]


def _jax_planes(cal):
    planes = [cal.occupancy_plane, *cal.payload]
    if cal.etick is not None:
        planes.append(cal.etick)
    return [np.asarray(p) for p in planes]


def _messages(seed, shards, slots, stream, n_loc=8, horizon=4, m=160, width=2):
    """Pre-filled planes and one tick's messages: ``fanin`` sends 40% of
    them to lanes 0-2 (equal-key runs past SLOTS); ``one-shard`` keeps
    every message in the last shard; ``empty-shard`` leaves shard 1 with
    none. Returns the planes (global layout), and per message its bucket,
    dst, validity, occupancy mark and payload words."""
    rng = np.random.default_rng(seed)
    n = shards * n_loc
    ns = n * slots
    fill = rng.random((horizon, ns)) < 0.3
    occ = np.where(fill, rng.integers(1, n + 1, (horizon, ns)), 0).astype(np.int32)
    pays = [rng.integers(-1000, 1000, (horizon, ns)).astype(np.int32) for _ in range(width)]
    et = rng.integers(0, 50, (horizon, ns)).astype(np.int32)
    dst = rng.integers(0, n, m)
    if stream == "fanin":
        dst = np.where(rng.random(m) < 0.4, rng.integers(0, 3, m), dst)
    elif stream == "one-shard":
        dst = (shards - 1) * n_loc + rng.integers(0, n_loc, m)
    elif stream == "empty-shard":
        dst = np.where(dst // n_loc == 1, dst + n_loc, dst) % n
    bucket = rng.integers(0, horizon, m)
    val = rng.random(m) < 0.9
    msg = dict(bucket=bucket, dst=dst, val=val,
               occ=rng.integers(1, n + 1, m).astype(np.int32),
               pay=[rng.integers(-99, 99, m).astype(np.int32) for _ in range(width)])
    return (occ, pays, et), msg, n_loc


def _sorted_stream(msg, horizon, n, n_loc, shard_major):
    """The stable sort by the bucket-major or the shard-major key."""
    d, b = msg["dst"], msg["bucket"]
    key = (d // n_loc) * horizon * n_loc + b * n_loc + d % n_loc if shard_major else b * n + d
    key = np.where(msg["val"], key, horizon * n)
    order = np.argsort(key, kind="stable")
    return (key[order].astype(np.int32), msg["occ"][order],
            [p[order] for p in msg["pay"]], order)


# (shards, slots, stacking, occ_bool, etick, width, stream)
SHARDED_CASES = [
    (2, 4, True, False, False, 2, "fanin"),
    (4, 4, True, True, True, 2, "fanin"),
    (8, 4, True, False, True, 1, "random"),
    (8, 1, True, False, True, 2, "fanin"),
    (4, 16, False, True, False, 1, "fanin"),
    (8, 16, True, False, False, 2, "random"),
    (2, 1, False, False, True, 1, "random"),
    (4, 4, True, False, False, 8, "one-shard"),
    (4, 4, True, True, False, 2, "empty-shard"),
]


@pytest.fixture(scope="module")
def jax_sharded():
    """The reference's sharded commit and pop, one jitted call each per
    case (the smallest stream tile keeps the interpreter's stream short)."""
    cache = {}

    def run(case, planes, stream, slots):
        if case not in cache:
            shards, _, stacking = case[:3]
            mesh = jmp.make_mesh(str(shards))
            sk, ov, pv = stream
            cal, surv = jax.jit(lambda c, a, o, p, t: _commit_calendar_sharded(
                c, a, o, p, t, stacking=stacking, tile=128, mesh=mesh))(
                _jax_cal(planes, slots), jnp.asarray(sk), jnp.asarray(ov),
                [jnp.asarray(p) for p in pv], jnp.int32(7))
            committed = _jax_planes(cal)
            cal, row, rows = jax.jit(lambda c, t: _pop_bucket_sharded(c, t, mesh))(
                cal, jnp.int32(6))
            cache[case] = (np.asarray(surv), committed,
                           [np.asarray(r) for r in (row, *rows)], _jax_planes(cal))
        return cache[case]

    return run


@pytest.mark.parametrize("case", SHARDED_CASES, ids=lambda c: "-".join(map(str, c)))
def test_sharded_commit_and_pop_match_jax(case, jax_sharded):
    """The plain sharded commit and pop on the virtual mesh, and on the
    same shards held in three tensors, against the reference's."""
    shards, slots, stacking, occ_bool, etick, width, stream = case
    planes, msg, n_loc = _messages(len(SHARDED_CASES) + shards, shards, slots, stream,
                                   width=width)
    occ, pays, et = planes
    planes = (occ != 0 if occ_bool else occ, pays, et if etick else None)
    horizon, n = occ.shape[0], shards * n_loc
    sk, ov, pv, _ = _sorted_stream(msg, horizon, n, n_loc, shard_major=True)
    want_surv, want_commit, want_rows, want_popped = jax_sharded(
        case, planes, (sk, ov, pv), slots)
    assert 0 < want_surv.sum() < len(sk)
    t = torch.tensor(7, dtype=torch.int32)
    for mesh in (_cpu_mesh(shards), _split_mesh(shards)):
        cal = _port_cal(planes, slots, mesh)
        cal, surv = ct.commit_calendar_sharded_plain(
            cal, torch.from_numpy(sk), torch.from_numpy(ov),
            [torch.from_numpy(p) for p in pv], t, stacking=stacking)
        label = f"{case} parts={len(mesh.parts)}"
        np.testing.assert_array_equal(surv.numpy(), want_surv, err_msg=label)
        for got, want in zip(_port_planes(cal), want_commit):
            np.testing.assert_array_equal(got, want, err_msg=label)
        cal, row, rows = ct.pop_bucket_sharded_plain(cal, torch.tensor(6, dtype=torch.int32))
        for got, want in zip((row, *rows), want_rows):
            np.testing.assert_array_equal(got.numpy(), want, err_msg=label)
        for got, want in zip(_port_planes(cal), want_popped):
            np.testing.assert_array_equal(got, want, err_msg=label)


@pytest.mark.parametrize("slots,stacking", [(1, True), (4, True), (4, False), (16, False)])
def test_shard_major_key_assigns_the_bucket_major_slots(slots, stacking):
    """A fan-in stream (equal-key runs past SLOTS) committed unsharded in
    bucket-major order and on a 4-shard mesh in shard-major order: the
    same planes, and each message's survival the same."""
    planes, msg, n_loc = _messages(slots, 4, slots, "fanin", m=400)
    horizon, n = planes[0].shape[0], 4 * n_loc
    t = torch.tensor(3, dtype=torch.int32)
    out = []
    for shard_major, mesh in ((False, None), (True, _cpu_mesh(4))):
        sk, ov, pv, order = _sorted_stream(msg, horizon, n, n_loc, shard_major)
        assert np.bincount(sk[sk < horizon * n]).max() > slots
        cal = _port_cal(planes, slots, mesh)
        commit = ct.commit_calendar_sharded_plain if mesh else ct.commit_calendar_plain
        cal, surv = commit(cal, torch.from_numpy(sk), torch.from_numpy(ov),
                           [torch.from_numpy(p) for p in pv], t, stacking=stacking)
        by_msg = np.zeros(len(order), np.int32)
        by_msg[order] = surv.numpy()
        out.append((_port_planes(cal), by_msg))
    (pa, sa), (pb, sb) = out
    np.testing.assert_array_equal(sb, sa)
    for a, b in zip(pa, pb):
        np.testing.assert_array_equal(b, a)


# ------------------------------------------------------------ whole runs


def _pingpong_port(n, mesh):
    return port_program("ping-pong", n, {"latency_ms": "4", "latency2_ms": "2",
                                          "tolerance_ms": "15"}, 8) if mesh is None else \
        _meshed(port_program, mesh, "ping-pong", n,
                {"latency_ms": "4", "latency2_ms": "2", "tolerance_ms": "15"}, 8)


def _meshed(make, mesh, case, n, params, chunk):
    """``make``'s program rebuilt on ``mesh`` (same testcase and groups)."""
    prog = make(case, n, params, chunk)
    return SimProgram(prog.tc, prog.groups, test_plan="network", test_case=case,
                      tick_ms=1.0, chunk=chunk, mesh=mesh)


@pytest.mark.parametrize("transport", ["xla", "pallas"])
def test_pingpong_mesh_matches_jax_mesh_and_unmeshed(transport):
    """As the reference's ``test_sim_mesh.py:161-185``: ping-pong at 32 on a
    4-shard mesh, against the reference's meshed run on that transport and
    the port's unmeshed run."""
    res_j, (flat_j, _) = run_capturing(
        ge._pingpong_program(32, mesh=jmp.make_mesh("4"), transport=transport),
        max_ticks=512)
    prog_m = _pingpong_port(32, _cpu_mesh(4))
    res_m, (flat_m, _) = run_capturing(prog_m, max_ticks=512)
    res_u, (flat_u, _) = run_capturing(_pingpong_port(32, None), max_ticks=512)
    assert int((res_m["status"] == 1).sum()) == 32
    assert_results_equal(res_j, res_m, f"jax mesh {transport}")
    assert_carries_equal(flat_j, prog_m, flat_m, f"jax mesh {transport}")
    assert_results_equal(res_u, res_m, "unmeshed")
    assert sorted(flat_u) == sorted(flat_m)
    for k in flat_u:
        np.testing.assert_array_equal(flat_m[k], flat_u[k], err_msg=k)


# sustained at 16 under every fault kind, in the form of
# test_torch_telemetry.WORKLOADS
FAULTED_SUSTAINED = (
    "network", "pingpong-sustained", 16, {"duration_ticks": "40", "reshape_every": "16"},
    128, 16,
    {"faults": {"": [
        {"kind": "crash", "start_ms": 6, "instances": "0:2"},
        {"kind": "restart", "start_ms": 20, "instances": "0:2"},
        {"kind": "link_flap", "start_ms": 8, "duration_ms": 12, "period_ms": 4,
         "duty": 0.5, "instances": "2:4"},
        {"kind": "partition", "start_ms": 24, "duration_ms": 10, "instances": "0:8",
         "to_instances": "8:16"},
        {"kind": "latency_spike", "start_ms": 10, "duration_ms": 20, "latency_ms": 2.0,
         "instances": "4:6"},
        {"kind": "loss_burst", "start_ms": 30, "duration_ms": 10, "loss": 30.0,
         "instances": "6:8"}]}},
    {"": {"instances": "0:4"}},
)

# name: (telemetry workload, planes)
MESH_RUNS = {
    "sustained": ("sustained", {}),
    "flood": ("flood", {}),
    "storm": ("storm", {}),
    "faulted-sustained-matrix": (FAULTED_SUSTAINED, {"telemetry": True,
                                                     "netmatrix": True}),
    "chaos-trace": ("chaos", {"telemetry": True, "trace": True}),
}


@pytest.mark.parametrize("name", list(MESH_RUNS))
def test_meshed_run_matches_jax_mesh_and_unmeshed(name):
    """A 4-shard run of each workload against the reference's 4-shard run
    and the port's unmeshed run: results, carry leaves, and every counter
    block, histogram, matrix delta and trace block."""
    workload, planes = MESH_RUNS[name]
    jprog, pprog = programs(workload, shards=4, **planes)
    _, uprog = programs(workload, **planes)
    assert pprog.mesh is not None and uprog.mesh is None
    max_ticks = (WORKLOADS[workload] if isinstance(workload, str) else workload)[4]
    res_j, rec_j, flat_j, _ = run_recording(jprog, seed=3, max_ticks=max_ticks)
    res_m, rec_m, flat_m, _ = run_recording(pprog, seed=3, max_ticks=max_ticks)
    res_u, rec_u, flat_u, _ = run_recording(uprog, seed=3, max_ticks=max_ticks)
    assert_results_equal(res_j, res_m, name)
    assert_planes_equal((res_j, rec_j), (res_m, rec_m), name)
    assert_carries_equal(flat_j, pprog, flat_m, name)
    assert_results_equal(res_u, res_m, f"{name} unmeshed")
    assert_planes_equal((res_u, rec_u), (res_m, rec_m), f"{name} unmeshed")
    assert sorted(flat_u) == sorted(flat_m)
    for k in flat_u:
        np.testing.assert_array_equal(flat_m[k], flat_u[k], err_msg=f"{name} {k}")
    assert res_m["msgs_delivered"] > 0
    if name == "faulted-sustained-matrix":
        assert res_m["faults_crashed"] > 0 and res_m["fault_dropped"] > 0
        assert any(d[5].sum() for d in rec_m["nm"])  # the crash purge's cells
    if planes.get("trace"):
        assert any((b >= 0).any() for b in rec_m["trace"])


def test_several_parts_run_matches_the_virtual_mesh():
    """The same run with the four shards held in three tensors (the
    several-device layout, on one device): every carry leaf equal."""
    case, n, params = "pingpong-sustained", 16, {"duration_ticks": "40",
                                                 "reshape_every": "16"}
    out = []
    for mesh in (_cpu_mesh(4), _split_mesh(4)):
        prog = _meshed(port_program, mesh, case, n, params, 8)
        out.append(run_capturing(prog, seed=2, max_ticks=256))
    (ra, (fa, _)), (rb, (fb, _)) = out
    assert_results_equal(ra, rb, "parts")
    for k in fa:
        np.testing.assert_array_equal(fb[k], fa[k], err_msg=k)


def test_meshed_footprint_equals_the_unmeshed_one():
    case, n, params = "pingpong-sustained", 16, {"duration_ticks": "8"}
    mprog = _meshed(port_program, _cpu_mesh(4), case, n, params, 8)
    uprog = port_program(case, n, params, 8)
    carry = mprog.init_carry(0)
    assert isinstance(carry.cal.src, tuple) and carry.cal.src[0].shape == (4, 8, 4 * 4)
    assert (mprog.estimate_carry_bytes() == uprog.estimate_carry_bytes()
            == mprog.run(max_ticks=8)["carry_bytes"])


def test_indivisible_lanes_refused_with_the_reference_message():
    """Under ``transport=pallas`` the executor's gate refuses an
    indivisible lane count with the reference engine's message; the port's
    engine itself, which runs K1/K2 under every knob, pads such a layout
    with dead lanes (refused until then) and runs the unmeshed run."""
    with pytest.raises(ValueError) as jerr:
        ge._pingpong_program(30, mesh=jmp.make_mesh("4"), transport="pallas")
    with pytest.raises(ValueError) as perr:
        pexec.check_mesh_lanes("pallas", 30, 0, 4)
    assert str(perr.value) == str(jerr.value)
    prog = _pingpong_port(30, _cpu_mesh(4))
    assert prog.mesh_pad == 2 and prog.n == 32
    res_m, _ = run_capturing(prog, seed=1, max_ticks=64)
    res_u, _ = run_capturing(_pingpong_port(30, None), seed=1, max_ticks=64)
    assert_results_equal(res_u, res_m, "padded mesh")
    assert (res_m["status"] == 1).all()
    groups = build_groups([RunGroup(id="all", instances=8)])
    with pytest.raises(ValueError, match="not the mesh's primary device"):
        SimProgram(port_program("ping-pong", 8, {}, 8).tc, groups, mesh=_cpu_mesh(4),
                   device="meta")


# ------------------------------------------------------------ executor


def _mesh_jobs(tmp_path, mesh, transport="xla", n=8):
    from testground_tpu.api import RunGroup as JRunGroup
    from testground_tpu.api import RunInput as JRunInput
    from testground_tpu.config import EnvConfig
    from testground_tpu.sim import executor as jexec

    cfg = {"telemetry": True, "chunk": 16, "mesh": mesh, "transport": transport}
    common = dict(run_id="run-mesh", test_plan="network", test_case="ping-pong",
                  total_instances=n)
    jjob = JRunInput(
        groups=[JRunGroup(id="all", instances=n,
                          artifact_path=f"{REF_PLANS}/network")],
        env=EnvConfig.load(home=str(tmp_path / "jax")),
        runner_config=jexec.SimJaxConfig(**cfg), **common)
    pjob = RunInput(groups=[RunGroup(id="all", instances=n,
                                     artifact_path=pexec.plan_dir("network"))],
                    env=OutputsEnv(tmp_path / "torch"),
                    runner_config=pexec.SimTorchConfig(device="cpu", **cfg), **common)
    return jjob, jexec.execute_sim_run, pjob


def test_execute_sim_run_on_a_mesh_matches_jax(tmp_path):
    """``mesh="4"`` on the CPU: the journal (its ``sim.mesh`` block and
    ``devices`` included) and the run directory equal the reference's."""
    from testground_tpu.rpc import discard_writer as jdiscard

    jjob, jexecute, pjob = _mesh_jobs(tmp_path, "4")
    both = []
    for execute, job, writer in ((jexecute, jjob, jdiscard()),
                                 (pexec.execute_sim_run, pjob, discard_writer())):
        out, err = _execute(execute, job, writer, threading.Event())
        assert err is None
        both.append((out, _read_tree(f"{job.env.dirs.outputs()}/network/run-mesh")))
    (jout, jtree), (pout, ptree) = both
    assert _journal(pout) == _journal(jout)
    assert pout.result.journal["sim"]["mesh"]["shards"] == 4
    assert pout.result.journal["sim"]["devices"] == 4
    assert pout.result.journal["sim"]["transport"]["reason"].startswith(
        "the plain torch versions of the sharded")
    assert sorted(ptree) == sorted(jtree)
    for rel in jtree:
        assert ptree[rel] == jtree[rel], rel


def test_executor_mesh_gate(tmp_path):
    """``shard`` on the CPU gives no mesh; an explicit shape a virtual one;
    an indivisible lane count under the XLA transport (refused until the
    mesh padding was ported) runs, its journal and run directory the
    reference's; under pallas it is refused with the reference's message."""
    from testground_tpu.rpc import discard_writer as jdiscard

    assert pexec._make_mesh(True, "", CPU) is None
    assert pexec._make_mesh(False, "4", CPU).size == 4
    jjob, jexecute, pjob = _mesh_jobs(tmp_path, "4", n=6)
    both = []
    for execute, job, writer in ((jexecute, jjob, jdiscard()),
                                 (pexec.execute_sim_run, pjob, discard_writer())):
        out, err = _execute(execute, job, writer, threading.Event())
        assert err is None
        both.append((out, _read_tree(f"{job.env.dirs.outputs()}/network/run-mesh")))
    (jout, jtree), (pout, ptree) = both
    assert _journal(pout) == _journal(jout)
    assert pout.result.journal["events"]["all"]["success"] == 6
    assert sorted(ptree) == sorted(jtree)
    for rel in jtree:
        assert ptree[rel] == jtree[rel], rel
    _, _, pjob = _mesh_jobs(tmp_path, "4", transport="pallas", n=6)
    with pytest.raises(ValueError, match="divide across the peer shards"):
        pexec.execute_sim_run(pjob, discard_writer(), threading.Event())


def test_meshed_carry_round_trips_through_the_global_layout():
    """``carry_to_numpy`` joins the shards into the reference's ``[L,
    N·SLOTS]`` planes, and ``carry_from_numpy`` cuts them again."""
    from testground_tpu_torch.sim.carry_io import carry_from_numpy

    case, n, params = "pingpong-sustained", 16, {"duration_ticks": "40"}
    mprog = _meshed(port_program, _cpu_mesh(4), case, n, params, 8)
    uprog = port_program(case, n, params, 8)
    _, (flat_m, carry_m) = run_capturing(mprog, seed=1, max_ticks=16)
    _, (flat_u, _) = run_capturing(uprog, seed=1, max_ticks=16)
    assert flat_m["cal.src"].shape == (8, 16 * 4)
    for k in flat_u:
        np.testing.assert_array_equal(flat_m[k], flat_u[k], err_msg=k)
    again = carry_to_numpy(carry_from_numpy(flat_m, mprog))
    for k in flat_m:
        np.testing.assert_array_equal(again[k], flat_m[k], err_msg=k)
    assert carry_from_numpy(flat_m, mprog).cal.src[0].shape == (4, 8, 4 * 4)


# ------------------------------------------------------------- 2-D mesh


@pytest.mark.parametrize("shape", ["2x4", "2x2", "4x1"])
def test_solo_run_on_a_2d_mesh_equals_the_unmeshed_run(shape):
    """A solo run on a 2-D mesh splits its lanes over row 0's peer shards
    (the reference shards ``i`` and replicates over ``runs``): every
    result and carry leaf is the unmeshed run's."""
    mesh = pmp.make_mesh(shape, device="cpu")
    prog = _pingpong_port(32, mesh)
    assert prog.mesh == mesh.row(0) and prog.meshplan.shards == mesh.shards
    res_m, (flat_m, _) = run_capturing(prog, seed=2, max_ticks=256)
    res_u, (flat_u, _) = run_capturing(_pingpong_port(32, None), seed=2, max_ticks=256)
    assert_results_equal(res_u, res_m, shape)
    for k in flat_u:
        np.testing.assert_array_equal(flat_m[k], flat_u[k], err_msg=k)


@pytest.mark.parametrize("shape", ["2x4", "2x2"])
def test_execute_sim_run_on_a_2d_mesh_matches_jax(shape, tmp_path):
    """``mesh="2x4"`` on the CPU: the journal (its ``sim.mesh`` block —
    layout ``"RxP"``, runs, shards — and ``devices``) and the run
    directory equal the reference's."""
    from testground_tpu.rpc import discard_writer as jdiscard

    jjob, jexecute, pjob = _mesh_jobs(tmp_path, shape)
    both = []
    for execute, job, writer in ((jexecute, jjob, jdiscard()),
                                 (pexec.execute_sim_run, pjob, discard_writer())):
        out, err = _execute(execute, job, writer, threading.Event())
        assert err is None
        both.append((out, _read_tree(f"{job.env.dirs.outputs()}/network/run-mesh")))
    (jout, jtree), (pout, ptree) = both
    assert _journal(pout) == _journal(jout)
    runs, shards = (int(x) for x in shape.split("x"))
    mesh = pout.result.journal["sim"]["mesh"]
    assert (mesh["axes"], mesh["runs"], mesh["shards"]) == (shape, runs, shards)
    assert pout.result.journal["sim"]["devices"] == runs * shards
    assert sorted(ptree) == sorted(jtree)
    for rel in jtree:
        assert ptree[rel] == jtree[rel], rel


def test_a_2d_meshed_run_resumes_from_its_snapshot_as_the_reference_runs(tmp_path):
    """Cut on a 2-D mesh by its budget with snapshots on, then resumed from
    them (``resume_from``): the resumed run's outcome, events, totals and
    ``sim.mesh`` block are the reference's uninterrupted run's."""
    import dataclasses as dc

    from testground_tpu.rpc import discard_writer as jdiscard

    jjob, jexecute, pjob = _mesh_jobs(tmp_path, "2x4")
    jout, err = _execute(jexecute, jjob, jdiscard(), threading.Event())
    assert err is None
    full = pjob.runner_config
    pjob.runner_config = dc.replace(full, checkpoint_chunks=1, max_ticks=32)
    cut = pexec.execute_sim_run(pjob, discard_writer(), threading.Event())
    assert cut.result.journal["sim"]["checkpoint"]["count"] >= 1
    assert cut.result.journal["sim"]["ticks"] == 32
    pjob.runner_config = dc.replace(full, resume_from="run-mesh")
    pjob.run_id = "run-resumed"
    out = pexec.execute_sim_run(pjob, discard_writer(), threading.Event())
    js, ps = jout.result.journal["sim"], out.result.journal["sim"]
    assert ps["checkpoint"]["resumed"]["from_tick"] == 32
    assert ps["mesh"] == js["mesh"] and ps["devices"] == js["devices"] == 8
    assert out.result.journal["events"] == jout.result.journal["events"]
    for key in ("ticks", "msgs_delivered", "msgs_sent", "msgs_enqueued", "msgs_dropped",
                "msgs_in_flight", "latency"):
        assert ps[key] == js[key], key
