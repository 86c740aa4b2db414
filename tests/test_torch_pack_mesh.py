"""Run packs on a mesh and the 2-D ``"RxP"`` mesh on the port
(``testground_tpu_torch/sim/pack.py``, ``sim/meshplan.py``) against the
JAX package, on the CPU, every mesh virtual (every cell on the CPU):

- ``meshplan`` on a 2-D mesh against the reference's answers: shapes, axis
  names, layout strings, peer shards, ``MeshPlan.runs``/``shards``, the
  rule table with the run-axis lead and the rank clamp, and the device
  rule; the calendar's sub-shard layout (``sub_shard_mesh``);
- the acceptance pin: every port plan case that admits packing, as a pack
  of three members (width 4: one dead dummy) with telemetry, with equal
  counts and bucketed, on a 1-D (``"4"``) and a 2-D (``"2x4"``) mesh. Each
  member equals the port's unmeshed pack and the port's isolated run, and
  the reference's isolated EXACT-N run under both transport knobs (ROADMAP
  R1, R2: never the reference's packed or bucketed runs) — status,
  finished_at, every state leaf, every flow total, the sync counters, the
  telemetry stream row for row and the histogram;
- the other layouts: ``"2"``, ``"2x2"``, ``"4x1"`` (a width below the
  rows), a mesh cut into several parts on one device (one launch per part
  a tick), dead dummies that fill a whole row, and members whose lanes do
  not divide across the peer shards (the solo meshed run's dead lanes);
- stragglers, budgets and cancels on a meshed pack: each member freezes at
  the reference's boundary;
- the refusals: ``transport = "pallas"`` on a meshed pack (the
  reference's message), and a program off the mesh's primary device.
"""

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as ge
from test_torch_pack import (
    LADDER,
    MODES,
    PACKABLE,
    REF_MODES,
    SEEDS,
    UNBUCKETABLE,
    _assert_member_equal,
    _clock,
    _isolated,
    _packed,
    _program,
    _record,
    _sizes,
)
from testground_tpu.sim import meshplan as jmp
from testground_tpu.sim import pack as jpack
from testground_tpu_torch.api import RunGroup
from testground_tpu_torch.sim import buckets as pb
from testground_tpu_torch.sim import meshplan as pmp
from testground_tpu_torch.sim import net as pnet
from testground_tpu_torch.sim.engine import SimProgram, build_groups
from testground_tpu_torch.sim.pack import PackMember, PackRunner, pack_width, sub_shard_mesh

CPU = torch.device("cpu")
SHAPES_2D = ("2x4", "2x2", "4x1", "1x4")


def _split(shape):
    """``shape`` on one device, each row cut into two parts (cell 0 alone,
    then the rest of the row)."""
    dims = pmp.parse_mesh_shape(shape)
    rows, width = (1, dims[0]) if len(dims) == 1 else dims
    parts = []
    for g in range(rows):
        lo = g * width
        parts += [(CPU, lo, lo + 1), (CPU, lo + 1, lo + width)]
    return pmp.TorchMesh((CPU,) * (rows * width), parts=tuple(parts),
                         runs=None if len(dims) == 1 else rows)


MESHES = {
    "4": lambda: pmp.make_mesh("4", device="cpu"),
    "2x4": lambda: pmp.make_mesh("2x4", device="cpu"),
    "2": lambda: pmp.make_mesh("2", device="cpu"),
    "2x2": lambda: pmp.make_mesh("2x2", device="cpu"),
    "4x1": lambda: pmp.make_mesh("4x1", device="cpu"),
    "4-parts": lambda: _split("4"),
    "2x4-parts": lambda: _split("2x4"),
}


# ------------------------------------------------------------- meshplan


@pytest.mark.parametrize("shape", SHAPES_2D)
def test_2d_layouts_match_the_reference(shape):
    pm, jm = pmp.make_mesh(shape, device="cpu"), jmp.make_mesh(shape)
    assert pm.axis_names == tuple(jm.axis_names) == pmp.mesh_axis_names(2)
    assert pm.shape == dict(jm.shape)
    assert pmp.layout_str(pm) == jmp.layout_str(jm) == shape
    assert pmp.peer_shards(pm) == jmp.peer_shards(jm)
    pplan, jplan = pmp.MeshPlan(pm), jmp.MeshPlan(jm)
    assert (pplan.runs, pplan.shards, pplan.devices) == (jplan.runs, jplan.shards,
                                                        jplan.devices)


PATHS = ("status", "finished_at", "rejected", "cal.payload.0", "cal.src", "cal.etick",
         "link.egress", "link.region_of", "link.rules", "sync.counts", "t", "")


@pytest.mark.parametrize("lead,ndim", [(None, None), ("runs", None), ("runs", 2),
                                       ("runs", 1), (None, 1)])
def test_2d_rule_table_with_lead_and_clamp_matches(lead, ndim):
    pplan = pmp.MeshPlan(pmp.make_mesh("2x4", device="cpu"))
    jplan = jmp.MeshPlan(jmp.make_mesh("2x4"))
    for path in PATHS:
        got = pplan.spec_for(path, lead=lead, ndim=ndim)
        assert tuple(got) == tuple(jplan.spec_for(path, lead=lead, ndim=ndim)), path
    assert pplan.spec_for("status", lead="runs") == pmp.PartitionSpec("runs", "i")
    assert pplan.spec_for("cal.payload.0", lead="runs", ndim=2) == pmp.PartitionSpec(
        "runs", None)


def test_2d_mesh_devices_rows_and_parts():
    m = pmp.make_mesh("2x4", devices=["cpu"] * 8)
    assert m.runs == 2 and m.shards == 4 and m.size == 8 and m.primary == CPU
    # a part never spans a row: one part a row on one device
    assert m.parts == ((CPU, 0, 4), (CPU, 4, 8))
    assert m.row(1).devices == (CPU,) * 4 and m.row(1).parts == ((CPU, 0, 4),)
    assert _split("2x4").row(1).parts == ((CPU, 0, 1), (CPU, 1, 4))
    with pytest.raises(ValueError, match="spans other devices"):
        pmp.TorchMesh((CPU,) * 8, parts=((CPU, 0, 6), (CPU, 6, 8)), runs=2)
    with pytest.raises(ValueError, match="do not make 3 mesh rows"):
        pmp.TorchMesh((CPU,) * 8, runs=3)
    assert m.on("meta").shape == m.shape
    # the reference's rule and message where devices are counted
    with pytest.raises(ValueError) as jerr:
        jmp.make_mesh("4x4")
    with pytest.raises(ValueError) as perr:
        pmp.make_mesh("4x4", devices=["cpu"] * len(jax.devices()))
    assert str(perr.value) == str(jerr.value)


@pytest.mark.parametrize("shape,width,rows", [("4", 4, [0, 0, 0, 0]),
                                              ("2x4", 4, [0, 0, 1, 1]),
                                              ("2x2", 8, [0] * 4 + [1] * 4),
                                              ("4x1", 2, [0, 1]),
                                              ("4x1", 8, [0, 0, 1, 1, 2, 2, 3, 3])])
def test_sub_shard_mesh_places_each_member_on_its_row(shape, width, rows):
    """Sub-shard ``r·P + s`` is member r's peer shard s, on its row's cell:
    the members split into contiguous groups of ``ceil(width / rows)``."""
    mesh = pmp.make_mesh(shape, devices=[torch.device("cuda", i) for i in range(8)])
    sub = sub_shard_mesh(mesh, width)
    p = mesh.shards
    assert sub.size == width * p and sub.runs is None
    for r in range(width):
        assert sub.devices[r * p:(r + 1) * p] == mesh.row(rows[r]).devices
    # on one device every sub-shard is one part: one launch a tick
    assert sub_shard_mesh(MESHES[shape](), width).parts == ((CPU, 0, width * p),)
    # a mesh cut by hand keeps its cuts in every member
    if shape in ("4", "2x4"):
        assert len(sub_shard_mesh(_split(shape), width).parts) == 2 * width


# ------------------------------------------------------- the acceptance pin


_CACHE: dict = {}


def _meshed(label, bucketed, mesh_key, members=3, width=None):
    """The pack of one workload on a mesh (as ``test_torch_pack._packed``:
    three members at width 4), once per module."""
    key = (label, bucketed, mesh_key, members, width)
    if key not in _CACHE:
        sizes, max_ticks = _sizes(label, bucketed), PACKABLE[label][4]
        sizes = (sizes * 2)[:members]
        seeds = (SEEDS * 2)[:members]
        if bucketed:
            plans = [pb.plan_buckets([n], "auto", LADDER) for n in sizes]
            prog = _program("torch", label, plans[0].padded_n, live=plans[0].live_counts)
            lcs = [p.live_counts for p in plans]
        else:
            prog = _program("torch", label, sizes[0])
            lcs = [None] * members
        tele = [[] for _ in sizes]
        ms = [PackMember(seed=s, live_counts=lc, max_ticks=max_ticks,
                         telemetry_cb=lambda b, i=i: tele[i].append(np.asarray(b).copy()))
              for i, (s, lc) in enumerate(zip(seeds, lcs))]
        runner = PackRunner(prog, width or pack_width(members, 8), mesh=MESHES[mesh_key]())
        _CACHE[key] = (runner.run(ms), tele)
    return _CACHE[key]


PIN = [(label, b, m) for label, b in MODES for m in ("4", "2x4")]


@pytest.mark.parametrize("label,bucketed,mesh", PIN,
                         ids=[f"{lb}-{'bucketed' if b else 'exact'}-{m}" for lb, b, m in PIN])
def test_meshed_member_equals_the_unmeshed_pack_and_the_isolated_run(label, bucketed,
                                                                     mesh):
    meshed, tele_m = _meshed(label, bucketed, mesh)
    packed, tele_p = _packed(label, bucketed)
    for i in range(len(SEEDS)):
        _assert_member_equal((packed[i], tele_p[i]), (meshed[i], tele_m[i]),
                             f"{label}[{i}] on {mesh} vs the unmeshed pack")
        _assert_member_equal(_isolated(label, bucketed, i), (meshed[i], tele_m[i]),
                             f"{label}[{i}] on {mesh} vs port")


def _ref_run(label, n, transport, seed):
    """The reference's isolated exact-N run, its program compiled once per
    size and transport in this module."""
    pkey = ("ref-prog", label, n, transport)
    if pkey not in _CACHE:
        _CACHE[pkey] = _program("jax", label, n, transport=transport)
    return _record(_CACHE[pkey], seed, PACKABLE[label][4])


def _against_the_reference(label, bucketed, transport, i):
    n = _sizes(label, bucketed)[i]
    ref = _ref_run(label, n, transport, SEEDS[i])
    for mesh in ("4", "2x4"):
        meshed, tele = _meshed(label, bucketed, mesh)
        _assert_member_equal(ref, (meshed[i], tele[i]), f"{label}[{i}] on {mesh} vs jax",
                             same_layout=not bucketed)
        assert [(g.id, g.offset, g.count) for g in meshed[i]["groups"]] == [
            (g.id, g.offset, g.count) for g in ref[0]["groups"]]


REF_PIN = [(label, b, i) for label, b in REF_MODES for i in range(len(SEEDS))]


@pytest.mark.parametrize("transport", ["xla", "pallas"])
@pytest.mark.parametrize("label,bucketed,i", REF_PIN,
                         ids=[f"{lb}-{'bucketed' if b else 'exact'}-{i}"
                              for lb, b, i in REF_PIN])
def test_meshed_member_equals_the_references_exact_run(label, bucketed, i, transport):
    _against_the_reference(label, bucketed, transport, i)


MORE = [(label, i) for label in ("barrier", "placebo", "verify", "splitbrain",
                                 "traffic-allowed", "ruled-ring") for i in range(len(SEEDS))]


@pytest.mark.parametrize("label,i", MORE, ids=[f"{lb}-{i}" for lb, i in MORE])
def test_meshed_member_equals_the_references_exact_run_more_plans(label, i):
    """The other packable cases, bucketed where the plan allows, against
    the reference's exact-N runs under the xla knob."""
    _against_the_reference(label, label not in UNBUCKETABLE, "xla", i)


# ---------------------------------------------------- the calendar itself


def _random_calendar(rng, horizon, lanes, slots, width):
    occ = rng.integers(0, lanes + 1, (horizon, slots * lanes)).astype(np.int32)
    occ[rng.random(occ.shape) < 0.5] = 0
    planes = [torch.from_numpy(occ)] + [
        torch.from_numpy(rng.integers(0, 2**31, occ.shape).astype(np.int32))
        for _ in range(width)]
    etick = torch.from_numpy(rng.integers(0, 64, occ.shape).astype(np.int32))
    return planes, etick


def _cal(planes, etick, slots, mesh):
    def sh(x):
        return x.clone() if mesh is None else pnet.to_shards(x, mesh, slots)

    return pnet.Calendar(payload=tuple(sh(p) for p in planes[1:]), src=sh(planes[0]),
                         valid=None, etick=sh(etick), slots=slots, mesh=mesh)


def _global(cal, plane):
    return plane if cal.mesh is None else pnet.from_shards(plane, cal.slots)


@pytest.mark.parametrize("shape,width", [("4", 4), ("2x2", 4), ("2x4", 2), ("4-parts", 2)])
def test_sub_shard_calendar_ops_equal_the_unmeshed_ones(shape, width):
    """On a pack's sub-shard calendar (``width`` members of 8 lanes):
    ``to_shards``/``from_shards`` round-trip, and ``deliver``,
    ``purge_dst``, ``latency_histogram`` and ``enqueue(runs=)`` — the
    shard-major key, the per-run counters — give the unmeshed answers."""
    rng = np.random.default_rng(7)
    n, horizon, slots, o = 8, 8, 4, 2
    lanes = width * n
    mesh = sub_shard_mesh(MESHES[shape](), width)
    planes, etick = _random_calendar(rng, horizon, lanes, slots, 1)
    cal_u, cal_m = _cal(planes, etick, slots, None), _cal(planes, etick, slots, mesh)
    for pu, pm in zip((cal_u.src, *cal_u.payload, cal_u.etick),
                      (cal_m.src, *cal_m.payload, cal_m.etick)):
        np.testing.assert_array_equal(_global(cal_m, pm).numpy(), pu.numpy())
    t = torch.tensor([5], dtype=torch.int32)
    group_of = torch.arange(lanes) // n
    hists, inboxes = [], []
    for cal in (cal_u, cal_m):
        cal, inbox = pnet.deliver(cal, t)
        inboxes.append(inbox)
        hists.append(pnet.latency_histogram(cal, inbox, t, group_of, width, 8))
    for a, b in zip(inboxes[0].__dict__.values(), inboxes[1].__dict__.values()):
        np.testing.assert_array_equal(b.numpy(), a.numpy())
    np.testing.assert_array_equal(hists[1].numpy(), hists[0].numpy())
    mask = torch.from_numpy(rng.random(lanes) < 0.3)
    _, pu = pnet.purge_dst(cal_u, mask)
    _, pm = pnet.purge_dst(cal_m, mask)
    assert int(pu) == int(pm) > 0
    np.testing.assert_array_equal(_global(cal_m, cal_m.src).numpy(), cal_u.src.numpy())
    # one tick's sends: each member's lanes message only its own lanes
    local = torch.from_numpy(rng.integers(-1, n + 1, (o, lanes)).astype(np.int32))
    run = torch.arange(lanes) // n
    dst = torch.where((local >= 0) & (local < n), local + run * n, local.clamp_max(-1))
    dst = torch.where(local == n, torch.full_like(dst, lanes), dst)
    payload = torch.from_numpy(rng.integers(0, 2**31, (o, 1, lanes)).astype(np.int32))
    valid = torch.from_numpy(rng.random((o, lanes)) < 0.7)
    link = pnet.make_link_state(lanes, 1, [3.0, 2.0, 0.0, 10.0, 0.0, 5.0, 0.0],
                                device="cpu")
    salts = torch.from_numpy(rng.integers(0, 2**32, o * lanes).astype(np.int64))
    fbs = []
    for cal in (cal_u, cal_m):
        _, fb = pnet.enqueue(cal, link, dst, payload, valid, t, 1.0, salts,
                             features=pnet.SHAPING_NO_DUPLICATE, runs=width)
        fbs.append(fb)
    for k in ("sent", "enqueued", "clamped", "rejected"):
        np.testing.assert_array_equal(getattr(fbs[1], k).numpy(),
                                      getattr(fbs[0], k).numpy(), err_msg=k)
    assert fbs[0].enqueued.shape == (width,) and bool((fbs[0].enqueued > 0).all())
    for pu, pm in zip((cal_u.src, *cal_u.payload, cal_u.etick),
                      (cal_m.src, *cal_m.payload, cal_m.etick)):
        np.testing.assert_array_equal(_global(cal_m, pm).numpy(), pu.numpy())


# ---------------------------------------------------------- other layouts


LAYOUTS = [(label, b, m) for label, b in (("ping-pong", False), ("sustained", True),
                                          ("dup-ring", False), ("collisions", False),
                                          ("traffic-shaped", True))
           for m in ("2", "2x2", "4x1", "4-parts", "2x4-parts")]


@pytest.mark.parametrize("label,bucketed,mesh", LAYOUTS,
                         ids=[f"{lb}-{'bucketed' if b else 'exact'}-{m}"
                              for lb, b, m in LAYOUTS])
def test_other_layouts_equal_the_unmeshed_pack(label, bucketed, mesh):
    meshed, tele_m = _meshed(label, bucketed, mesh)
    packed, tele_p = _packed(label, bucketed)
    for i in range(len(SEEDS)):
        _assert_member_equal((packed[i], tele_p[i]), (meshed[i], tele_m[i]),
                             f"{label}[{i}] on {mesh}")


@pytest.mark.parametrize("mesh,parts", [("2x2", 1), ("4-parts", 8), ("2x4-parts", 8)])
def test_one_sharded_launch_a_tick_per_part(mesh, parts, monkeypatch):
    """The meshed pack commits and pops its whole calendar through the
    sharded K1 and K2: one launch per part a tick (the plain versions are
    counted here), once a tick on one device."""
    calls = {"commit": 0, "pop": 0}
    real_commit, real_pop = pnet.commit_calendar_sharded, pnet.pop_bucket_sharded

    def commit(cal, *a, **k):
        calls["commit"] += len(cal.mesh.parts)
        return real_commit(cal, *a, **k)

    def pop(cal, *a, **k):
        calls["pop"] += len(cal.mesh.parts)
        return real_pop(cal, *a, **k)

    monkeypatch.setattr(pnet, "commit_calendar_sharded", commit)
    monkeypatch.setattr(pnet, "pop_bucket_sharded", pop)
    prog = _program("torch", "ping-pong", 8, telemetry=False)
    runner = PackRunner(prog, 4, mesh=MESHES[mesh]())
    assert len(runner.cal_mesh.parts) == parts
    ticks, tick = [], runner._tick

    def counted(*a, **k):
        ticks.append(1)
        return tick(*a, **k)

    runner._tick = counted
    runner.run([PackMember(seed=s, max_ticks=16) for s in (1, 2, 3)])
    assert ticks and calls == {"commit": len(ticks) * parts, "pop": len(ticks) * parts}


@pytest.mark.parametrize("members", [3, 2])
def test_dead_dummies_that_fill_a_row_move_nothing(members):
    """Width 4 on ``"2x2"``: with 3 members row 1 holds member 2 and a
    dummy; with 2 it holds two dummies and nothing else. No live member's
    counter moves, ``cal_depth`` included."""
    for bucketed in (False, True):
        meshed, tele_m = _meshed("sustained", bucketed, "2x2", members=members, width=4)
        for i in range(members):
            _assert_member_equal(_isolated("sustained", bucketed, i), (meshed[i], tele_m[i]),
                                 f"member {i} of {members}")


@pytest.mark.parametrize("mesh", ["4", "2x4"])
def test_members_that_do_not_divide_get_dead_lanes(mesh):
    """Six lanes a member on four peer shards: the inner program carries
    the solo meshed run's dead lanes (``lane_multiple``), and every member
    equals its exact isolated run."""
    groups = build_groups([RunGroup(id="all", instances=6)])
    padded = SimProgram(_clock().tc, groups, chunk=8, telemetry=True, device="cpu",
                        lane_multiple=4)
    assert padded.mesh_pad == 2 and padded.n == 8
    with pytest.raises(ValueError, match="do not divide across the mesh's 4 peer"):
        PackRunner(_clock(), 4, mesh=MESHES[mesh]())
    tele = [[], [], []]
    members = [PackMember(seed=s, max_ticks=256,
                          telemetry_cb=lambda b, i=i: tele[i].append(np.asarray(b).copy()))
               for i, s in enumerate((0, 1, 5))]
    packed = PackRunner(padded, 4, mesh=MESHES[mesh]()).run(members)
    for i, m in enumerate(members):
        _assert_member_equal(_record(_clock(), m.seed, 256), (packed[i], tele[i]),
                             f"member {i}")


# ----------------------------------------------------------- stragglers


def _meshed_vs_isolated(members, mesh, iso_ticks=()):
    tele = [[] for _ in members]
    for i, m in enumerate(members):
        m.telemetry_cb = lambda b, i=i: tele[i].append(np.asarray(b).copy())
    runner = PackRunner(_clock(), pack_width(len(members), 8), mesh=MESHES[mesh]())
    packed = runner.run(members)
    for i, m in enumerate(members):
        iso = _record(_clock(), m.seed, dict(iso_ticks).get(i, m.max_ticks))
        _assert_member_equal(iso, (packed[i], tele[i]), f"member {i} on {mesh}")
    return packed


@pytest.mark.parametrize("mesh", ["2", "2x2"])
def test_early_finishers_on_a_mesh_freeze_at_their_own_tick(mesh):
    members = [PackMember(seed=s, max_ticks=256) for s in (0, 1, 2, 5)]
    packed = _meshed_vs_isolated(members, mesh)
    assert len({int(np.max(r["finished_at"])) for r in packed}) > 1
    assert all(m.done for m in members)


@pytest.mark.parametrize("mesh", ["2", "2x2"])
def test_a_members_own_budget_ends_first_on_a_mesh(mesh):
    members = [PackMember(seed=0, max_ticks=16), PackMember(seed=6, max_ticks=256)]
    packed = _meshed_vs_isolated(members, mesh)
    assert members[0].ticks == 16 and not members[0].done
    assert members[1].done and packed[1]["ticks"] > 16


@pytest.mark.parametrize("mesh", ["2", "2x2"])
def test_a_canceled_member_on_a_mesh_stops_at_its_boundary(mesh):
    calls = {"n": 0}

    def cancel():
        calls["n"] += 1
        return calls["n"] >= 2

    members = [PackMember(seed=0, max_ticks=256, cancel_check=cancel),
               PackMember(seed=6, max_ticks=256)]
    packed = _meshed_vs_isolated(members, mesh, iso_ticks=[(0, 16)])
    assert members[0].canceled and packed[0]["ticks"] == 16


# ------------------------------------------------------------ refusals


def test_pallas_on_a_meshed_pack_is_refused_with_the_reference_message():
    with pytest.raises(ValueError) as jerr:
        jpack.PackRunner(ge._pingpong_program(32, transport="pallas"), 4,
                         mesh=jmp.make_mesh("4"))
    with pytest.raises(ValueError) as perr:
        PackRunner(_program("torch", "ping-pong", 8), 4, mesh=MESHES["4"](),
                   transport="pallas")
    assert str(perr.value) == str(jerr.value)
    # unmeshed, the knob changes nothing on the port
    PackRunner(_program("torch", "ping-pong", 8), 4, transport="pallas")


def test_the_program_lives_on_the_mesh_primary_device():
    meta = pmp.make_mesh("2x2", devices=["meta"] * 4)
    with pytest.raises(ValueError, match="mesh's primary device meta"):
        PackRunner(_program("torch", "ping-pong", 8), 4, mesh=meta)
