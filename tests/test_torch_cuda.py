"""The port's CUDA kernels on the card: each against its plain version on
the same CUDA tensors (the main path's shapes among them; the sharded
kernels on virtual meshes on card 0), and short runs on the GPU against
the same runs on the CPU, the observability planes' blocks and meshed runs
included. Every test is marked ``cuda`` and takes the ``cuda`` fixture,
which skips it where there is no GPU. This file imports no jax, so on a
machine with the GPU and without jax it runs as

    python -m pytest --noconftest tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from testground_tpu_torch.api import RunGroup
from testground_tpu_torch.sim import cuda_transport as ct
from testground_tpu_torch.sim import net
from testground_tpu_torch.sim.carry_io import carry_to_numpy
from testground_tpu_torch.sim.engine import SimProgram, build_groups
from testground_tpu_torch.sim.executor import (
    instantiate_testcase,
    load_sim_testcases,
    plan_dir,
)

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU form)")
    return torch.device("cuda")


def _cal(rng, horizon, n, slots, width, occ_bool, etick, device):
    ns = n * slots
    fill = rng.random((horizon, ns)) < 0.25
    occ = fill if occ_bool else np.where(fill, rng.integers(1, n + 1, (horizon, ns)), 0)
    occ = torch.from_numpy(occ.astype(bool if occ_bool else np.int32)).to(device)
    return net.Calendar(
        payload=tuple(
            torch.from_numpy(rng.integers(0, 999, (horizon, ns)).astype(np.int32)).to(device)
            for _ in range(width)),
        src=None if occ_bool else occ,
        valid=occ if occ_bool else None,
        etick=(torch.from_numpy(rng.integers(0, 9, (horizon, ns)).astype(np.int32)).to(device)
               if etick else None),
        slots=slots,
    )


def _planes(cal):
    return [cal.occupancy_plane, *cal.payload] + ([cal.etick] if cal.etick is not None else [])


def _copy(cal):
    return net.Calendar(
        payload=tuple(p.clone() for p in cal.payload),
        src=None if cal.src is None else cal.src.clone(),
        valid=None if cal.valid is None else cal.valid.clone(),
        etick=None if cal.etick is None else cal.etick.clone(),
        slots=cal.slots,
    )


TILE = ct.COMMIT_TILE


def _stream_keys(rng, kind, m2, horizon, n, slots):
    """Sorted keys (bucket·N + dst; dead ≥ L·N or < 0) of one stream kind:
    ``random`` draws with a dead tail; ``poisson`` puts every message in
    one bucket at a uniform dst, with a few runs of 20-40 planted;
    ``dup`` is a stream and its duplicate copies one bucket later, the
    copies not drawn dead; ``straddle`` lays a run of SLOTS+3
    across every odd tile boundary and a run of exactly SLOTS ending at
    every even one, with short runs between; ``fanin`` puts every message
    on one (bucket, dst); ``dead`` holds dead keys only."""
    big = horizon * n
    if kind == "random":
        return np.minimum(np.sort(rng.integers(0, big + 200, m2)), big)
    if kind == "fanin":
        return np.full(m2, int(rng.integers(0, big)))
    if kind == "poisson":
        keys = 3 * n + rng.integers(0, n, m2)
        keys[: 5 * 30] = 3 * n + np.repeat(rng.integers(0, n, 5), 30)
        return np.sort(keys)
    if kind == "dup":
        m = m2 // 2
        orig = rng.integers(2, 4, m) * n + rng.integers(0, n, m)
        copy = np.where(rng.random(m) < 0.5, orig + n, big)
        return np.sort(np.concatenate([orig, copy]))
    if kind == "dead":
        return np.sort(np.concatenate([rng.integers(-50, 0, m2 // 3),
                                       rng.integers(big, big + 50, m2 - m2 // 3)]))
    assert kind == "straddle"
    lengths, pos, k = [], 0, 1
    while pos < m2:
        start, run = (k * TILE - 2, slots + 3) if k % 2 else (k * TILE - slots, slots)
        while pos < start:
            lengths.append(min(start - pos, int(rng.integers(1, 4))))
            pos += lengths[-1]
        lengths.append(run)
        pos += run
        k += 1
    keys = np.sort(rng.choice(big, len(lengths), replace=False))
    return np.repeat(keys, lengths)[:m2]


# (occ_bool, stacking, etick, width, slots, m2, stream)
_COMMIT_CASES = [
    (False, True, False, 1, 4, 3000, "random"),
    (False, True, True, 3, 4, 3000, "random"),
    (True, False, True, 2, 4, 3000, "random"),
    (True, True, False, 1, 4, 3000, "random"),
    # runs across a block's tile boundary, and runs of SLOTS ending at one
    (False, True, True, 2, 4, 4 * TILE + 37, "straddle"),
    (True, False, False, 1, 3, 4 * TILE + 37, "straddle"),
    (False, True, False, 1, 1, 4 * TILE + 37, "straddle"),
    # heavy fan-in: every message on one (bucket, dst)
    (False, True, False, 1, 4, 3000, "fanin"),
    (True, False, True, 1, 2, 3000, "fanin"),
    # stream lengths at the tile's edges
    (False, True, False, 1, 4, 0, "random"),
    (False, True, False, 1, 4, 1, "random"),
    (False, True, True, 1, 4, 3, "random"),
    (False, True, False, 2, 4, TILE - 1, "random"),
    (True, True, False, 1, 4, TILE + 1, "random"),
    (False, True, False, 2, 4, 3000, "dead"),
    # every SLOTS up to 4, and the widest payload
    (False, True, False, 1, 1, 3000, "random"),
    (False, True, True, 1, 2, 3000, "random"),
    (True, True, False, 2, 3, 3000, "random"),
    (False, True, True, 8, 4, 3000, "random"),
    # storm's shape: SLOTS=16, bool occupancy, no stacking, Poisson fan-in
    # with runs past 16 (ranks >= SLOTS read survived = 0)
    (True, False, False, 1, 16, 5000, "poisson"),
    (True, False, False, 1, 16, 4 * TILE + 37, "straddle"),
    # a duplicate-doubled stream: copies one bucket later, half dead
    (False, True, False, 1, 4, 4000, "dup"),
    (True, True, False, 2, 4, 4000, "dup"),
]


@pytest.mark.parametrize("occ_bool,stacking,etick,width,slots,m2,stream", _COMMIT_CASES)
def test_commit_kernel_matches_plain(cuda, occ_bool, stacking, etick, width, slots,
                                     m2, stream):
    rng = np.random.default_rng(width + 10 * slots + m2)
    horizon, n = 8, 1000
    cal = _cal(rng, horizon, n, slots, width, occ_bool, etick, cuda)
    keys = _stream_keys(rng, stream, m2, horizon, n, slots)
    sk = torch.from_numpy(keys.astype(np.int32)).to(cuda)
    occ_vals = torch.from_numpy(rng.integers(1, n, m2).astype(np.int32)).to(cuda)
    pay = [torch.from_numpy(rng.integers(0, 99, m2).astype(np.int32)).to(cuda)
           for _ in range(width)]
    t = torch.tensor(3, dtype=torch.int32, device=cuda)
    a, b = _copy(cal), _copy(cal)
    before = ct.commit_calendar.launches
    _, sa = ct.commit_calendar(a, sk, occ_vals, pay, t, stacking=stacking)
    _, sb = ct.commit_calendar_plain(b, sk, occ_vals, pay, t, stacking=stacking)
    torch.cuda.synchronize()
    assert ct.commit_calendar.launches == before + (m2 > 0)
    assert torch.equal(sa, sb)
    for x, y in zip(_planes(a), _planes(b)):
        assert torch.equal(x, y)


# (occ_bool, n, slots, width, horizon, t)
_POP_CASES = [
    (False, 1000, 4, 2, 16, 37),
    (True, 1000, 4, 2, 16, 37),
    (False, 333, 3, 2, 16, 37),
    (False, 1000, 4, 8, 16, 37),
    (True, 333, 3, 2, 16, 37),  # bool row of 999 cells
    (True, 1002, 4, 1, 16, 37),  # bool row of 4008 cells: not a multiple of 16
    (False, 1000, 4, 2, 1, 37),
    (False, 1000, 4, 2, 16, 2**20 + 1),
    (True, 1000, 1, 1, 8, 37),  # flood's shape: SLOTS=1, bool
    (True, 1000, 16, 1, 8, 37),  # storm's shape: SLOTS=16, bool
    (True, 1000, 1, 1, 256, 300),  # netlinkshape's 256-row horizon
]


@pytest.mark.parametrize("occ_bool,n,slots,width,horizon,t", _POP_CASES)
def test_pop_kernel_matches_plain(cuda, occ_bool, n, slots, width, horizon, t):
    rng = np.random.default_rng(n + width + horizon)
    cal = _cal(rng, horizon, n, slots, width, occ_bool, False, cuda)
    t = torch.tensor(t, dtype=torch.int32, device=cuda)
    a, b = _copy(cal), _copy(cal)
    before = ct.pop_bucket.launches
    _, ra, pa = ct.pop_bucket(a, t)
    _, rb, pb = ct.pop_bucket_plain(b, t)
    torch.cuda.synchronize()
    assert ct.pop_bucket.launches == before + 1
    for x, y in zip([ra, *pa, *_planes(a)], [rb, *pb, *_planes(b)]):
        assert torch.equal(x, y)


GPU_RUNS = {
    "sustained": ("network", "pingpong-sustained",
                  {"duration_ticks": "40", "reshape_every": "16"}, {}),
    "flood": ("benchmarks", "pingpong-flood", {"duration_ticks": "40"}, {}),
    "flood-validate": ("benchmarks", "pingpong-flood", {"duration_ticks": "40"},
                       {"validate": True}),
    "storm": ("benchmarks", "storm", {"conn_delay_ticks": "8", "data_size_kb": "32"}, {}),
    "barrier": ("benchmarks", "barrier", {"barrier_iterations": "2"}, {}),
    "traffic-shaped": ("network", "traffic-shaped", {"burst": "12", "rate": "1.5"}, {}),
    "traffic-ruled": ("network", "traffic-ruled", {}, {}),
}


@pytest.mark.parametrize("name", list(GPU_RUNS))
def test_gpu_run_matches_cpu_run(cuda, name):
    plan, case, params, kw = GPU_RUNS[name]
    factory = load_sim_testcases(plan_dir(plan))[case]
    groups = build_groups([RunGroup(id="all", instances=64, parameters=params)])
    out = []
    for device in ("cpu", cuda):
        prog = SimProgram(instantiate_testcase(factory, groups, 1.0), groups,
                          chunk=16, device=device, **kw)
        last = {}
        res = prog.run(seed=1, max_ticks=256,
                       observer=lambda k, c: last.__setitem__("c", carry_to_numpy(c)))
        out.append((res, last["c"]))
    (rc, cc), (rg, cg) = out
    assert (rc["status"] == 1).all()
    for k in ("ticks", "msgs_sent", "msgs_delivered", "cal_depth", "msgs_dropped",
              "msgs_rejected", "collisions", "bw_queue_dropped"):
        assert rc[k] == rg[k], k
    for k in cc:
        np.testing.assert_array_equal(cg[k], cc[k], err_msg=k)


def _faults_for(groups, n):
    """Every fault kind over a 64-instance run, windows inside 48 ticks."""
    from testground_tpu_torch.sim.faults import build_fault_schedule

    q = n // 8
    return build_fault_schedule(groups, {"": [
        {"kind": "crash", "start_ms": 6, "instances": f"0:{q}"},
        {"kind": "restart", "start_ms": 20, "instances": f"0:{q}"},
        {"kind": "link_flap", "start_ms": 8, "duration_ms": 12, "period_ms": 4,
         "duty": 0.5, "instances": f"{q}:{2 * q}"},
        {"kind": "partition", "start_ms": 24, "duration_ms": 10,
         "instances": f"0:{n // 2}", "to_instances": f"{n // 2}:{n}"},
        {"kind": "latency_spike", "start_ms": 10, "duration_ms": 20, "latency_ms": 2.0,
         "instances": f"{2 * q}:{3 * q}"},
        {"kind": "loss_burst", "start_ms": 30, "duration_ms": 10, "loss": 30.0,
         "instances": f"{3 * q}:{4 * q}"},
    ]}, 1.0)


# name: (plan, case, params, options)
GPU_FAULT_RUNS = {
    "sustained-faulted": ("network", "pingpong-sustained",
                          {"duration_ticks": "48", "reshape_every": "16"}, {"faults": True}),
    "chaos": ("chaos", "chaos-barrier",
              {"heal_tick": "108", "deadline": "184"}, {"faults": True}),
    "additional-hosts": ("additional_hosts", "additional_hosts", {},
                         {"hosts": ("http-echo",)}),
    "additional-hosts-faulted": ("additional_hosts", "additional_hosts_drop", {},
                                 {"hosts": ("http-echo",), "faults": True}),
}


@pytest.mark.parametrize("name", list(GPU_FAULT_RUNS))
def test_gpu_faulted_and_hosts_run_matches_cpu_run(cuda, name):
    """A fault schedule and control lanes at 64 instances: the GPU run
    (kernels) against the CPU run (plain versions), every carry leaf."""
    plan, case, params, opts = GPU_FAULT_RUNS[name]
    factory = load_sim_testcases(plan_dir(plan))[case]
    groups = build_groups([RunGroup(id="all", instances=64, parameters=params)])
    faults = _faults_for(groups, 64) if opts.get("faults") else None
    out = []
    for device in ("cpu", cuda):
        prog = SimProgram(instantiate_testcase(factory, groups, 1.0), groups, chunk=16,
                          device=device, faults=faults, hosts=opts.get("hosts", ()))
        last = {}
        res = prog.run(seed=1, max_ticks=512,
                       observer=lambda k, c: last.__setitem__("c", carry_to_numpy(c)))
        out.append((res, last["c"]))
    (rc, cc), (rg, cg) = out
    if faults is not None:
        assert rc["faults_crashed"] > 0
    for k in ("ticks", "msgs_sent", "msgs_delivered", "cal_depth", "msgs_dropped",
              "msgs_rejected", "fault_dropped", "faults_crashed", "faults_restarted"):
        assert rc[k] == rg[k], k
    np.testing.assert_array_equal(rg["status"], rc["status"])
    for k in cc:
        np.testing.assert_array_equal(cg[k], cc[k], err_msg=k)


def test_enqueue_with_control_lanes_sharing_buckets_matches_cpu(cuda):
    """Host echo rows (the 1-tick floor) and plan rows shaped to one tick
    land in the same (bucket, dst) as messages already there (a
    pre-filled calendar), under a fault schedule and a dead mask: K1 on
    the card against the plain commit on the CPU."""
    from testground_tpu_torch.sim.faults import build_fault_schedule

    n, h, o, slots, horizon = 1000, 3, 4, 4, 8
    lanes = n + h
    rng = np.random.default_rng(4)
    groups = build_groups([RunGroup(id="all", instances=n)])
    faults = build_fault_schedule(groups, {"": [
        {"kind": "partition", "start_ms": 0, "duration_ms": 9, "instances": "0:300",
         "to_instances": "300:600"},
        {"kind": "loss_burst", "start_ms": 0, "duration_ms": 9, "loss": 20.0},
        {"kind": "latency_spike", "start_ms": 0, "duration_ms": 9, "latency_ms": 0.5,
         "instances": "600:700"}]}, 1.0)
    egress = np.zeros((7, lanes), np.float32)
    egress[0] = rng.uniform(0.1, 1.0, lanes)  # every plan row: a one-tick delay
    egress[5] = 25.0  # reorder: the floor again
    dst = rng.integers(0, 40, (o, lanes)).astype(np.int32)  # heavy fan-in
    dead = rng.random(lanes) < 0.05
    dead[n:] = False
    occ = np.where(rng.random((horizon, lanes * slots)) < 0.3,
                   rng.integers(1, lanes + 1, (horizon, lanes * slots)), 0).astype(np.int32)
    payload = rng.integers(0, 99, (o, 1, lanes)).astype(np.int32)
    valid = rng.random((o, lanes)) < 0.9
    outs = []
    for device in ("cpu", cuda):
        def d(a):
            return torch.from_numpy(np.array(a)).to(device)

        cal = net.Calendar(payload=(d(occ * 7),), src=d(occ), valid=None, slots=slots)
        link = net.make_link_state(lanes, 1, (1.0,) * 7, device=device)
        link.egress = d(egress)
        before = ct.commit_calendar.launches
        cal, fb = net.enqueue(cal, link, d(dst), d(payload), d(valid),
                              torch.tensor(4, dtype=torch.int32, device=device), 1.0,
                              (7, 9), features=("latency", "reorder", "filters"),
                              control_start=n, faults=faults, dead=d(dead),
                              want_fate=True)
        if torch.device(device).type == "cuda":
            assert ct.commit_calendar.launches == before + 1
        outs.append([cal.src.cpu(), cal.payload[0].cpu(), fb.enqueued.cpu(),
                     fb.fault_dropped.cpu(), fb.fate.cpu()])
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    assert int(outs[0][3]) > 0


def test_commit_kernel_at_sustained_shape_with_etick(cuda):
    """K1 as the telemetry plane runs it on sustained@100k: L=8, N=100k,
    SLOTS=4, W=1, int32 occupancy, the etick plane written, m2=200k."""
    rng = np.random.default_rng(41)
    horizon, n, slots, m2 = 8, 100_000, 4, 200_000
    cal = _cal(rng, horizon, n, slots, 1, False, True, cuda)
    keys = np.sort(rng.integers(0, horizon * n + 20_000, m2))
    keys = np.minimum(keys, horizon * n)
    sk = torch.from_numpy(keys.astype(np.int32)).to(cuda)
    occ_vals = torch.from_numpy(rng.integers(1, n, m2).astype(np.int32)).to(cuda)
    pay = [torch.from_numpy(rng.integers(0, 99, m2).astype(np.int32)).to(cuda)]
    t = torch.tensor(11, dtype=torch.int32, device=cuda)
    a, b = _copy(cal), _copy(cal)
    _, sa = ct.commit_calendar(a, sk, occ_vals, pay, t)
    _, sb = ct.commit_calendar_plain(b, sk, occ_vals, pay, t)
    torch.cuda.synchronize()
    assert torch.equal(sa, sb) and int(sa.sum()) > 0
    for x, y in zip(_planes(a), _planes(b)):
        assert torch.equal(x, y)
    assert int((a.etick == 11).sum()) >= int(sa.sum())


def test_pop_kernel_at_flood_shape_with_int32_occupancy(cuda):
    """K2 as flood runs under the traffic matrix (provenance forced on):
    SLOTS=1, L=8, N=100k, int32 occupancy."""
    rng = np.random.default_rng(42)
    cal = _cal(rng, 8, 100_000, 1, 1, False, False, cuda)
    t = torch.tensor(13, dtype=torch.int32, device=cuda)
    a, b = _copy(cal), _copy(cal)
    _, ra, pa = ct.pop_bucket(a, t)
    _, rb, pb = ct.pop_bucket_plain(b, t)
    torch.cuda.synchronize()
    assert ra.dtype == torch.int32
    for x, y in zip([ra, *pa, *_planes(a)], [rb, *pb, *_planes(b)]):
        assert torch.equal(x, y)


def test_gpu_run_with_every_plane_matches_cpu_run(cuda):
    """Sustained at 4,096 instances with telemetry, the traffic matrix and
    a 64-lane trace plan: every block, histogram and matrix delta, result
    and carry leaf equal, CPU (plain versions) against GPU (kernels)."""
    from testground_tpu_torch.sim.trace import build_trace_plan

    factory = load_sim_testcases(plan_dir("network"))["pingpong-sustained"]
    groups = build_groups([RunGroup(id="all", instances=4096, parameters={
        "duration_ticks": "60", "reshape_every": "24"})])
    out = []
    for device in ("cpu", cuda):
        prog = SimProgram(instantiate_testcase(factory, groups, 1.0), groups, chunk=16,
                          device=device, telemetry=True, netmatrix=True,
                          trace=build_trace_plan(groups, {"": {"instances": "0:64"}}))
        rec = {k: [] for k in ("tele", "lat", "nm", "trace")}
        last = {}
        res = prog.run(seed=1, max_ticks=256,
                       telemetry_cb=rec["tele"].append, lat_hist_cb=rec["lat"].append,
                       netmatrix_cb=rec["nm"].append, trace_cb=rec["trace"].append,
                       observer=lambda k, c: last.__setitem__("c", carry_to_numpy(c)))
        out.append((res, rec, last["c"]))
    (rc, recc, cc), (rg, recg, cg) = out
    assert (rc["status"] == 1).all() and sum(map(sum, rc["lat_hist"])) > 0
    for k in ("ticks", "msgs_sent", "msgs_delivered", "lat_hist", "net_matrix"):
        assert rc[k] == rg[k], k
    for k in recc:
        assert len(recc[k]) == len(recg[k]) > 0, k
        for x, y in zip(recc[k], recg[k]):
            np.testing.assert_array_equal(y, x, err_msg=k)
    for k in cc:
        np.testing.assert_array_equal(cg[k], cc[k], err_msg=k)


def _syncs_over(prog, ticks) -> int:
    """Synchronizing CUDA calls that sync debug mode reports over one run
    of ``ticks`` ticks, set-up included."""
    import warnings

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            prog.run(seed=0, max_ticks=ticks)
            torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


@pytest.mark.parametrize("planes", ["off", "every-plane"])
def test_sustained_tick_makes_no_host_sync(cuda, planes):
    """The sustained tick waits on no host copy (the Python-scalar StepOut
    fields are fills on the card, the link shape's scalar fields too, and
    the plan's latencies are device constants): a run of 64 ticks makes
    exactly the synchronizing calls of a run of 32 (chunk 16, so both span
    chunk flushes), with the planes off and with every plane on."""
    from testground_tpu_torch.sim.trace import build_trace_plan

    factory = load_sim_testcases(plan_dir("network"))["pingpong-sustained"]
    groups = build_groups([RunGroup(id="all", instances=512, parameters={
        "duration_ticks": "500", "reshape_every": "24"})])
    kw = {}
    if planes == "every-plane":
        kw = dict(telemetry=True, netmatrix=True,
                  trace=build_trace_plan(groups, {"": {"instances": "0:64"}}))
    prog = SimProgram(instantiate_testcase(factory, groups, 1.0), groups, chunk=16,
                      device=cuda, **kw)
    prog.run(seed=0, max_ticks=16)  # the kernels built and loaded
    assert _syncs_over(prog, 32) == _syncs_over(prog, 64)



# ------------------------------------------------------------ the mesh


def _virtual_mesh(shards, parts=None):
    """``shards`` peer shards on card 0; ``parts`` (shard cuts) holds them
    in several tensors."""
    from testground_tpu_torch.sim.meshplan import TorchMesh

    dev = torch.device("cuda", 0)
    cuts = (0, *(parts or ()), shards)
    return TorchMesh((dev,) * shards,
                     parts=tuple((dev, a, b) for a, b in zip(cuts, cuts[1:])))


def _meshed(cal, mesh):
    def sh(x):
        return None if x is None else net.to_shards(x, mesh, cal.slots)

    return net.Calendar(payload=tuple(sh(p) for p in cal.payload), src=sh(cal.src),
                        valid=sh(cal.valid), etick=sh(cal.etick), slots=cal.slots,
                        mesh=mesh)


def _copy_meshed(cal):
    def c(x):
        return None if x is None else tuple(p.clone() for p in x)

    return net.Calendar(payload=tuple(c(p) for p in cal.payload), src=c(cal.src),
                        valid=c(cal.valid), etick=c(cal.etick), slots=cal.slots,
                        mesh=cal.mesh)


def _global_planes(cal):
    return [net.from_shards(p, cal.slots) for p in _planes(cal)]


def _to_shard_major(keys, horizon, n, n_loc):
    live = (keys >= 0) & (keys < horizon * n)
    b, d = keys // n, keys % n
    sm = (d // n_loc) * horizon * n_loc + b * n_loc + d % n_loc
    return np.sort(np.where(live, sm, horizon * n), kind="stable")


# (shards, parts, occ_bool, stacking, etick, width, slots, m2, stream)
_SHARDED_COMMIT_CASES = [
    (4, None, False, True, False, 1, 4, 3000, "random"),
    (8, None, False, True, True, 2, 4, 3000, "random"),
    (2, None, True, False, True, 2, 4, 3000, "random"),
    (4, (1,), False, True, True, 2, 4, 3000, "random"),
    (4, (1, 3), True, True, False, 1, 4, 3000, "random"),
    (4, None, False, True, True, 2, 4, 4 * TILE + 37, "straddle"),
    (4, None, False, True, False, 1, 4, 3000, "fanin"),
    (4, None, True, False, False, 1, 16, 5000, "poisson"),
    (4, None, False, True, False, 1, 1, 3000, "random"),
    (8, None, False, True, True, 8, 4, 3000, "random"),
    (4, None, False, True, False, 2, 4, 4000, "dup"),
    (4, None, False, True, False, 1, 4, 0, "random"),
    (4, (2,), False, True, False, 1, 4, 1, "random"),
    (4, None, False, True, False, 2, 4, 3000, "dead"),
]


@pytest.mark.parametrize("shards,parts,occ_bool,stacking,etick,width,slots,m2,stream",
                         _SHARDED_COMMIT_CASES)
def test_sharded_commit_kernel_matches_plain(cuda, shards, parts, occ_bool, stacking, etick,
                                             width, slots, m2, stream):
    rng = np.random.default_rng(shards + width + 10 * slots + m2)
    horizon, n = 8, 1000
    mesh = _virtual_mesh(shards, parts)
    cal = _meshed(_cal(rng, horizon, n, slots, width, occ_bool, etick, cuda), mesh)
    keys = _to_shard_major(_stream_keys(rng, stream, m2, horizon, n, slots), horizon, n,
                           n // shards)
    sk = torch.from_numpy(keys.astype(np.int32)).to(cuda)
    occ_vals = torch.from_numpy(rng.integers(1, n, m2).astype(np.int32)).to(cuda)
    pay = [torch.from_numpy(rng.integers(0, 99, m2).astype(np.int32)).to(cuda)
           for _ in range(width)]
    t = torch.tensor(3, dtype=torch.int32, device=cuda)
    a, b = _copy_meshed(cal), _copy_meshed(cal)
    before = ct.commit_calendar_sharded.launches
    _, sa = ct.commit_calendar_sharded(a, sk, occ_vals, pay, t, stacking=stacking)
    _, sb = ct.commit_calendar_sharded_plain(b, sk, occ_vals, pay, t, stacking=stacking)
    torch.cuda.synchronize()
    assert ct.commit_calendar_sharded.launches == before + (len(mesh.parts) if m2 else 0)
    assert torch.equal(sa, sb)
    for x, y in zip(_global_planes(a), _global_planes(b)):
        assert torch.equal(x, y)


# (shards, parts, occ_bool, n, slots, width, horizon, t)
_SHARDED_POP_CASES = [
    (4, None, False, 1000, 4, 2, 16, 37),
    (4, None, True, 1000, 4, 2, 16, 37),
    (8, None, False, 1000, 4, 8, 16, 37),
    (4, None, False, 4 * 333, 3, 2, 16, 37),  # n_loc = 333: the scalar kernel
    (4, None, True, 4 * 1001, 4, 1, 16, 37),
    (4, None, True, 24, 2, 1, 8, 5),  # n_loc = 6
    (4, (1,), False, 1000, 4, 2, 16, 2**20 + 1),
    (4, (1, 2), True, 4 * 333, 1, 1, 8, 37),
    (4, None, True, 1000, 16, 1, 8, 37),  # storm's shape
    (4, None, True, 1000, 1, 1, 256, 300),  # flood's SLOTS=1, a 256-row horizon
    # bool occupancy in 8-byte items (n_loc = 1000: % 8 == 0, % 16 != 0)
    # and in 4-byte words (n_loc = 1004: % 4 == 0, % 8 != 0)
    (4, None, True, 4 * 1000, 4, 2, 8, 37),
    (4, None, True, 4 * 1004, 4, 1, 8, 37),
    # bool occupancy in 16-byte vectors (n_loc = 1024), int32 alongside
    (4, None, True, 4 * 1024, 4, 2, 8, -5),
    (4, (2,), False, 4 * 1024, 2, 3, 8, 37),
    # segments of several chunks, the last one ragged (n_loc = 2500 at
    # W = 1, 3; n_loc = 1023 in the scalar kernel)
    (4, None, False, 4 * 2500, 4, 1, 8, 37),
    (2, None, True, 2 * 2500, 4, 3, 8, 37),
    (4, None, False, 4 * 1023, 2, 1, 8, 37),
    # S_d·SLOTS = 65,600 segments, and SLOTS = 65,540 past the grid's y
    # limit, folded into x (vector and scalar kernels)
    (4, None, False, 16, 16400, 1, 2, 37),
    (2, None, False, 8, 65540, 1, 2, 37),
    (2, None, True, 6, 65540, 2, 2, 37),
    # W = 8 in the vector kernel, int32 and bool-vector occupancy
    (4, None, False, 4 * 1000, 4, 8, 8, 37),
    (4, None, True, 4 * 1024, 2, 8, 8, 37),
]


@pytest.mark.parametrize("shards,parts,occ_bool,n,slots,width,horizon,t",
                         _SHARDED_POP_CASES)
def test_sharded_pop_kernel_matches_plain(cuda, shards, parts, occ_bool, n, slots, width,
                                          horizon, t):
    rng = np.random.default_rng(n + width + horizon)
    mesh = _virtual_mesh(shards, parts)
    cal = _meshed(_cal(rng, horizon, n, slots, width, occ_bool, False, cuda), mesh)
    t = torch.tensor(t, dtype=torch.int32, device=cuda)
    a, b = _copy_meshed(cal), _copy_meshed(cal)
    before = ct.pop_bucket_sharded.launches
    _, ra, pa = ct.pop_bucket_sharded(a, t)
    _, rb, pb = ct.pop_bucket_sharded_plain(b, t)
    torch.cuda.synchronize()
    assert ct.pop_bucket_sharded.launches == before + len(mesh.parts)
    for x, y in zip([ra, *pa, *_global_planes(a)], [rb, *pb, *_global_planes(b)]):
        assert torch.equal(x, y)


@pytest.mark.parametrize("name", ["sustained", "flood", "storm"])
def test_gpu_meshed_run_matches_cpu_runs(cuda, name):
    """A 4-shard virtual mesh on card 0 against the same mesh on the CPU and
    the unmeshed CPU run: every carry leaf; the sharded kernels launched
    and the unsharded ones not."""
    from testground_tpu_torch.sim.meshplan import make_mesh

    plan, case, params, kw = GPU_RUNS[name]
    factory = load_sim_testcases(plan_dir(plan))[case]
    groups = build_groups([RunGroup(id="all", instances=64, parameters=params)])
    out = []
    for device, mesh in (("cpu", None), ("cpu", make_mesh("4", device="cpu")),
                         (None, _virtual_mesh(4))):
        prog = SimProgram(instantiate_testcase(factory, groups, 1.0), groups, chunk=16,
                          device=device, mesh=mesh, **kw)
        before = (ct.commit_calendar.launches, ct.pop_bucket.launches,
                  ct.pop_bucket_sharded.launches)
        last = {}
        res = prog.run(seed=1, max_ticks=256,
                       observer=lambda k, c: last.__setitem__("c", carry_to_numpy(c)))
        after = (ct.commit_calendar.launches, ct.pop_bucket.launches,
                 ct.pop_bucket_sharded.launches)
        out.append((res, last["c"]))
    assert after[:2] == before[:2] and after[2] > before[2]
    (ru, cu), (rm, cm), (rg, cg) = out
    assert (ru["status"] == 1).all()
    for k in ("ticks", "msgs_sent", "msgs_delivered", "cal_depth", "carry_bytes"):
        assert ru[k] == rm[k] == rg[k], k
    for k in cu:
        np.testing.assert_array_equal(cm[k], cu[k], err_msg=k)
        np.testing.assert_array_equal(cg[k], cu[k], err_msg=k)


def test_cli_runs_a_composition_on_the_card_as_on_the_cpu(cuda, tmp_path, monkeypatch,
                                                          capsys):
    """``run composition`` of the port's chaos smoke composition through the
    CLI, in a home whose ``.env.toml`` names no device (the card) and in one
    that sets ``device = "cpu"``: both succeed, the card's run launches K1
    and K2 and journals them, and the run directories are equal once the
    run ID and the wall-clock fields are dropped. The perf ledger's rows
    and block are compared by what is the run's (ticks, chunks, rows), not
    by its timings or the card's bytes in use."""
    import json
    import os
    import shutil

    import re

    from testground_tpu_torch.cli.main import main
    from testground_tpu_torch.engine import TaskStorage

    # the span tree's clocks too (task_spans.jsonl, task_trace.json)
    varying = {"ts", "wall_ns", "wall_secs", "compile_secs", "trace_id", "span_id",
               "parent_id", "transport", "start_ns", "end_ns", "dur"}

    def strip(x, run_id):
        if isinstance(x, dict):
            return {k: strip(v, run_id) for k, v in x.items() if k not in varying}
        if isinstance(x, list):
            return [strip(v, run_id) for v in x]
        return x.replace(run_id, "<run>") if isinstance(x, str) else x

    trees = {}
    for dev, env in (("cuda", ""), ("cpu", '[runners."sim:torch"]\ndevice = "cpu"\n')):
        home = tmp_path / dev
        shutil.copytree(os.path.join(plan_dir("chaos")), home / "plans" / "chaos",
                        ignore=shutil.ignore_patterns("__pycache__"))
        (home / ".env.toml").write_text(env)
        monkeypatch.setenv("TESTGROUND_HOME", str(home))
        before = (ct.commit_calendar.launches, ct.pop_bucket.launches)
        comp = home / "plans" / "chaos" / "_compositions" / "smoke.toml"
        capsys.readouterr()
        assert main(["run", "composition", "-f", str(comp)]) == 0
        after = (ct.commit_calendar.launches, ct.pop_bucket.launches)
        task_id = re.search(r"run is queued with ID: (\S+)", capsys.readouterr().out)[1]
        task = TaskStorage(str(home / "tasks.db")).get(task_id)
        assert task.outcome().value == "success"
        sim = task.result["journal"]["sim"]
        assert sim["transport"]["resolved"] == ("cuda" if dev == "cuda" else "plain")
        if dev == "cuda":
            assert all(a > b for a, b in zip(after, before))
        else:
            assert after == before
        run_dir = home / "data" / "outputs" / "chaos" / task.id
        tree = {}
        for root, _, names in os.walk(run_dir):
            for name in names:
                path = os.path.join(root, name)
                with open(path) as f:
                    rows = ([json.load(f)] if name.endswith(".json") else
                            [json.loads(ln) for ln in f if ln.strip()])
                # the span tree's rows in an order of their own, not by clock
                rows = strip(rows, task.id)
                if name == "task_trace.json":
                    rows = [{**r, "traceEvents": sorted(r["traceEvents"], key=json.dumps)}
                            for r in rows]
                elif name.startswith("task_"):
                    rows = sorted(rows, key=json.dumps)
                elif name == "sim_perf.jsonl":
                    rows = [{k: r[k] for k in ("run", "plan", "case", "tick", "chunk")}
                            for r in rows]
                tree[os.path.relpath(path, run_dir)] = rows
        journal = strip(task.result["journal"], task.id)
        perf = journal["sim"].pop("perf")
        counts = {"instances": perf["instances"], "chunk": perf["chunk"],
                  "chunks": perf["execute"]["chunks"], "ticks": perf["execute"]["ticks"],
                  "series": perf["series"]}
        trees[dev] = (tree, journal, counts)
    assert sorted(trees["cuda"][0]) == sorted(trees["cpu"][0])
    assert "sim_perf.jsonl" in trees["cpu"][0]
    for rel in trees["cpu"][0]:
        assert trees["cuda"][0][rel] == trees["cpu"][0][rel], rel
    assert trees["cuda"][1] == trees["cpu"][1]
    assert trees["cuda"][2] == trees["cpu"][2]


def test_phase_ledger_counts_the_kernels_bytes(cuda):
    """On the card K1 and K2 launch through ctypes, out of the dispatch
    counter's sight: the ledger adds their closed-form bytes to the deliver
    and net_commit rows, and the residual still closes the tick exactly."""
    from testground_tpu_torch.sim.phases import build_phase_ledger

    factory = load_sim_testcases(plan_dir("network"))["pingpong-sustained"]
    groups = build_groups([RunGroup(id="all", instances=64,
                                    parameters={"duration_ticks": "40"})])
    prog = SimProgram(instantiate_testcase(factory, groups, 1.0), groups, chunk=16,
                      device=cuda, telemetry=True)
    block = build_phase_ledger(prog, measure=3)
    rows = {r["phase"]: r for r in block["phases"]}
    occ = prog.init_carry(0).cal.occupancy_plane
    pop = ct.pop_bytes(occ.shape[1], prog.init_carry(0).cal.width,
                       occ.dtype == torch.bool)
    assert block["transport"] == "cuda"
    assert block["kernel_bytes"]["deliver"] == {"pop_bucket": pop}
    assert block["kernel_bytes"]["net_commit"]["commit_calendar"] > 0
    assert rows["deliver"]["bytes_accessed"] >= pop
    assert rows["net_commit"]["bytes_accessed"] >= (
        block["kernel_bytes"]["net_commit"]["commit_calendar"])
    whole = block["whole_per_tick"]["bytes_accessed"]
    assert sum(r["bytes_accessed"] for r in rows.values()) + block["residual"][
        "bytes_accessed"] == whole
    assert all(r["measured_reps"] == 3 for r in rows.values())
    assert build_phase_ledger(prog)["phases"] == [
        {k: v for k, v in r.items() if not k.startswith("measured")}
        for r in block["phases"]]


def test_snapshot_on_the_card_equals_the_cpus_and_resumes_there(cuda):
    """The checkpoint plane on the card: a snapshot read through the pinned
    buffers of a reused stage (the live carry read before the next chunk
    updates it) equals the CPU run's at the same tick, and the CPU's
    snapshot restored on the card ends as the card's uninterrupted run."""
    from testground_tpu_torch.sim.checkpoint import _HostStage, restore_carry, snapshot_carry

    factory = load_sim_testcases(plan_dir("network"))["pingpong-sustained"]
    groups = build_groups([RunGroup(id="all", instances=64, parameters={
        "duration_ticks": "40", "reshape_every": "16"})])

    def prog(device):
        return SimProgram(instantiate_testcase(factory, groups, 1.0), groups, chunk=16,
                          telemetry=True, device=device)

    got = {}
    for device, stage in (("cpu", None), (cuda, _HostStage())):
        snaps = {}

        def obs(k, c, snaps=snaps, stage=stage):
            leaves, metas = snapshot_carry(c, "xla", stage)
            snaps[k] = ([x.copy() for x in leaves], metas)

        res = prog(device).run(seed=1, max_ticks=256, observer=obs)
        got[str(device)] = (res, snaps)
    (rc, sc), (rg, sg) = got["cpu"], got[str(cuda)]
    assert sorted(sc) == sorted(sg) and 32 in sc
    for k in sc:
        assert sc[k][1] == sg[k][1]
        for a, b in zip(sc[k][0], sg[k][0]):
            np.testing.assert_array_equal(a, b, err_msg=str(k))
    card = prog(cuda)
    carry = restore_carry(card, 1, {"leaves": sc[32][1]}, sc[32][0], transport="xla")
    assert carry.status.device.type == "cuda"
    end = {}
    res = card.run(seed=1, max_ticks=256, resume_carry=carry, resume_ticks=32,
                   observer=lambda k, c: end.__setitem__("c", snapshot_carry(c, "xla")))
    for k in ("ticks", "msgs_sent", "msgs_delivered", "cal_depth", "msgs_dropped"):
        assert res[k] == rg[k], k
    last = max(sg)
    for a, b in zip(end["c"][0], sg[last][0]):
        np.testing.assert_array_equal(a, b)


# name: (plan, case, instances, params, options): padded runs on the card
PADDED_GPU_RUNS = {
    # 60 instances padded into a 128-lane bucket, under every fault kind
    "sustained-bucketed-faulted": ("network", "pingpong-sustained", 60,
                                   {"duration_ticks": "48", "reshape_every": "16"},
                                   {"bucket": 128, "faults": True}),
    # two groups and a host lane padded to 64 each
    "hosts-bucketed": ("additional_hosts", "additional_hosts", (20, 24), {},
                       {"bucket": 64, "hosts": ("http-echo",)}),
    # 62 instances on a 4-shard virtual mesh on the card: two dead lanes
    "sustained-mesh-padded": ("network", "pingpong-sustained", 62,
                              {"duration_ticks": "48", "reshape_every": "16"},
                              {"mesh": 4}),
}


@pytest.mark.parametrize("name", list(PADDED_GPU_RUNS))
def test_gpu_padded_run_matches_exact_and_cpu_runs(cuda, name):
    """A run with dead lanes (a bucket's, or a mesh's padding) on the card:
    every result equal to the same padded run on the CPU and to the exact
    run on the card."""
    from testground_tpu_torch.sim.faults import remap_schedule
    from testground_tpu_torch.sim.meshplan import TorchMesh

    plan, case, n, params, opts = PADDED_GPU_RUNS[name]
    counts = (n,) if isinstance(n, int) else n
    factory = load_sim_testcases(plan_dir(plan))[case]
    exact = build_groups([RunGroup(id=f"g{i}", instances=c, parameters=params)
                          for i, c in enumerate(counts)])
    faults = _faults_for(exact, sum(counts)) if opts.get("faults") else None
    padded, live = exact, None
    if opts.get("bucket"):
        padded = build_groups([RunGroup(id=f"g{i}", instances=opts["bucket"],
                                        parameters=params) for i in range(len(counts))])
        live = counts
        if faults is not None:
            index = np.concatenate([np.arange(c) + i * opts["bucket"]
                                    for i, c in enumerate(counts)])
            faults_p = remap_schedule(faults, index, sum(g.count for g in padded))
    out = {}
    for label, device, groups, lc in (("exact", cuda, exact, None),
                                      ("cpu", "cpu", padded, live),
                                      ("card", cuda, padded, live)):
        kw = {"hosts": opts.get("hosts", ())}
        if faults is not None:
            kw["faults"] = faults if lc is None else faults_p
        if opts.get("mesh") and label != "exact":
            dev = torch.device(device)
            kw["mesh"] = TorchMesh(devices=(dev,) * opts["mesh"])
            device = None
        prog = SimProgram(instantiate_testcase(factory, groups, 1.0), groups, chunk=16,
                          device=device, live_counts=lc, **kw)
        out[label] = prog.run(seed=1, max_ticks=512)
    ref = out["exact"]
    assert (ref["status"] == 1).all()
    for label in ("cpu", "card"):
        res = out[label]
        for k in ("ticks", "msgs_sent", "msgs_delivered", "cal_depth", "msgs_dropped",
                  "msgs_rejected", "fault_dropped", "faults_crashed", "faults_restarted"):
            assert res[k] == ref[k], (label, k)
        np.testing.assert_array_equal(res["status"], ref["status"])
        np.testing.assert_array_equal(res["finished_at"], ref["finished_at"])
        for sr, sp in zip(ref["states"], res["states"]):
            for k in sr:
                np.testing.assert_array_equal(sp[k], sr[k], err_msg=f"{label} {k}")


# name: (plan, case, exact counts of the members, params, bucket): run packs
PACKED_GPU_RUNS = {
    # four bucketed tenants (one dead dummy pads the width to 4)
    "sustained-bucketed": ("network", "pingpong-sustained", (60, 50, 40),
                           {"duration_ticks": "48", "reshape_every": "16"}, 64),
    # equal counts, direct slots
    "flood": ("benchmarks", "pingpong-flood", (64, 64), {"duration_ticks": "40"}, None),
    # TRACK_SRC off, SLOTS=16, the sync plane's publishes
    "subtree-bucketed": ("benchmarks", "subtree", (30, 20, 17, 9),
                         {"subtree_iterations": "4"}, 32),
}


@pytest.mark.parametrize("name", list(PACKED_GPU_RUNS))
def test_gpu_packed_run_matches_cpu_run(cuda, name):
    """A pack on the card equals the same pack on the CPU, member by member
    (results, telemetry blocks), with K1 and K2 launched once a tick for
    the whole pack."""
    from testground_tpu_torch.sim.pack import PackMember, PackRunner, pack_width

    plan, case, counts, params, bucket = PACKED_GPU_RUNS[name]
    factory = load_sim_testcases(plan_dir(plan))[case]
    n = bucket or counts[0]
    groups = build_groups([RunGroup(id="all", instances=n, parameters=params)])
    out = {}
    for device in ("cpu", cuda):
        prog = SimProgram(instantiate_testcase(factory, groups, 1.0), groups, chunk=16,
                          device=device, telemetry=True,
                          live_counts=(counts[0],) if bucket else None)
        tele = [[] for _ in counts]
        members = [PackMember(seed=i, live_counts=(c,) if bucket else None, max_ticks=512,
                              telemetry_cb=lambda b, i=i: tele[i].append(b.copy()))
                   for i, c in enumerate(counts)]
        before = (ct.commit_calendar.launches, ct.pop_bucket.launches)
        res = PackRunner(prog, pack_width(len(counts), 8)).run(members)
        torch.cuda.synchronize()
        launched = (ct.commit_calendar.launches - before[0],
                    ct.pop_bucket.launches - before[1])
        out[str(device)] = (res, tele, launched)
    (rc, tc, lc), (rg, tg, lg) = out["cpu"], out[str(cuda)]
    assert lc == (0, 0) and lg[1] > 0  # one pop a tick for the whole pack
    ticks = max(int(r["ticks"]) for r in rg)
    assert lg[1] <= ticks
    for i, c in enumerate(counts):
        assert rc[i]["status"].shape == (c,) and (rc[i]["status"] == 1).all()
        for k in ("ticks", "msgs_sent", "msgs_delivered", "cal_depth", "msgs_dropped",
                  "msgs_rejected", "carry_bytes"):
            assert rg[i][k] == rc[i][k], (i, k)
        np.testing.assert_array_equal(rg[i]["status"], rc[i]["status"])
        np.testing.assert_array_equal(rg[i]["finished_at"], rc[i]["finished_at"])
        np.testing.assert_array_equal(rg[i]["sync_counts"], rc[i]["sync_counts"])
        for sc, sg in zip(rc[i]["states"], rg[i]["states"]):
            for k in sc:
                np.testing.assert_array_equal(sg[k], sc[k], err_msg=f"{i} {k}")
        assert rg[i]["lat_hist"] == rc[i]["lat_hist"]
        assert len(tg[i]) == len(tc[i])
        for a, b in zip(tc[i], tg[i]):
            np.testing.assert_array_equal(b, a)


# name: (PACKED_GPU_RUNS entry, mesh shape, cut the rows into parts)
MESHED_PACK_GPU_RUNS = {
    "sustained-bucketed-4": ("sustained-bucketed", "4", False),
    "sustained-bucketed-2x4": ("sustained-bucketed", "2x4", False),
    "flood-2x2-parts": ("flood", "2x2", True),
    "subtree-bucketed-2x4": ("subtree-bucketed", "2x4", False),
}


@pytest.mark.parametrize("name", list(MESHED_PACK_GPU_RUNS))
def test_gpu_meshed_pack_matches_cpu_run(cuda, name):
    """A pack on a virtual mesh of card 0 equals the same meshed pack on
    the CPU and the unmeshed pack on the card, member by member, with the
    sharded K1 and K2 launched once a tick per part."""
    from testground_tpu_torch.sim.meshplan import TorchMesh, make_mesh
    from testground_tpu_torch.sim.pack import PackMember, PackRunner, pack_width

    run, shape, cut = MESHED_PACK_GPU_RUNS[name]
    plan, case, counts, params, bucket = PACKED_GPU_RUNS[run]
    factory = load_sim_testcases(plan_dir(plan))[case]
    n = bucket or counts[0]
    groups = build_groups([RunGroup(id="all", instances=n, parameters=params)])

    def mesh_on(dev):
        m = make_mesh(shape, devices=[dev] * 8)
        if not cut:
            return m
        p = m.shards
        parts = [(dev, a, a + 1) for a in range(0, m.size, p)]
        parts = sorted(parts + [(dev, a + 1, a + p) for _, a, _ in parts],
                       key=lambda x: x[1])
        return TorchMesh(m.devices, parts=tuple(parts), runs=m.runs)

    out = {}
    for label, device, meshed in (("cpu", "cpu", True), ("card", cuda, True),
                                  ("unmeshed", cuda, False)):
        prog = SimProgram(instantiate_testcase(factory, groups, 1.0), groups, chunk=16,
                          device=device, telemetry=True,
                          live_counts=(counts[0],) if bucket else None)
        tele = [[] for _ in counts]
        members = [PackMember(seed=i, live_counts=(c,) if bucket else None, max_ticks=512,
                              telemetry_cb=lambda b, i=i: tele[i].append(b.copy()))
                   for i, c in enumerate(counts)]
        runner = PackRunner(prog, pack_width(len(counts), 8),
                            mesh=mesh_on(torch.device(device)) if meshed else None)
        before = (ct.commit_calendar_sharded.launches, ct.pop_bucket_sharded.launches)
        res = runner.run(members)
        if device != "cpu":
            torch.cuda.synchronize()
        launched = (ct.commit_calendar_sharded.launches - before[0],
                    ct.pop_bucket_sharded.launches - before[1])
        parts = len(runner.cal_mesh.parts) if meshed else 0
        out[label] = (res, tele, launched, parts)
    ticks = max(int(r["ticks"]) for r in out["card"][0])
    _, _, lg, parts = out["card"]
    assert out["cpu"][2] == (0, 0) and out["unmeshed"][2] == (0, 0)
    assert 0 < lg[1] <= ticks * parts and lg[1] % parts == 0
    rc, tc = out["cpu"][:2]
    for other in ("card", "unmeshed"):
        rg, tg = out[other][:2]
        for i in range(len(counts)):
            for k in ("ticks", "msgs_sent", "msgs_delivered", "cal_depth", "msgs_dropped",
                      "msgs_rejected", "carry_bytes"):
                assert rg[i][k] == rc[i][k], (other, i, k)
            np.testing.assert_array_equal(rg[i]["status"], rc[i]["status"])
            np.testing.assert_array_equal(rg[i]["finished_at"], rc[i]["finished_at"])
            np.testing.assert_array_equal(rg[i]["sync_counts"], rc[i]["sync_counts"])
            for sc, sg in zip(rc[i]["states"], rg[i]["states"]):
                for k in sc:
                    np.testing.assert_array_equal(sg[k], sc[k], err_msg=f"{other} {i} {k}")
            assert rg[i]["lat_hist"] == rc[i]["lat_hist"]
            assert len(tg[i]) == len(tc[i])
            for a, b in zip(tc[i], tg[i]):
                np.testing.assert_array_equal(b, a)


# a cohort on the card: (plan, case, instances, params, chunk, validate)
COHORT_GPU_RUNS = {
    "ping-pong": ("network", "ping-pong", 64, {"latency_ms": "100", "latency2_ms": "10",
                                              "tolerance_ms": "15"}, 64, False),
    "flood-validate": ("benchmarks", "pingpong-flood", 64,
                       {"duration_ticks": "64", "latency_ms": "4"}, 32, True),
}


@pytest.mark.parametrize("name", list(COHORT_GPU_RUNS))
def test_two_process_cohort_on_one_card_equals_its_single_run(cuda, name, tmp_path):
    """A two-process cohort on card 0 (the leader child and a ``tg-torch
    sim-worker`` on the same card, so its collectives go over gloo) gives
    the single-process run's result on the card: outcome, journal metrics,
    flow totals, and the follower's carry digest equals the leader's."""
    import json
    import re
    import socket
    import subprocess
    import sys
    import threading

    from testground_tpu_torch.api import OutputsEnv, RunInput
    from testground_tpu_torch.rpc import OutputWriter, discard_writer
    from testground_tpu_torch.sim.cohort import shutdown_leader_child
    from testground_tpu_torch.sim.executor import (
        PLANS_ROOT,
        SimTorchConfig,
        execute_sim_run,
    )

    plan, case, n, params, chunk, validate = COHORT_GPU_RUNS[name]
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        coord = f"127.0.0.1:{s.getsockname()[1]}"

    def job(run_id, **cfg):
        return RunInput(run_id=run_id, test_plan=plan, test_case=case, total_instances=n,
                        groups=[RunGroup(id="all", instances=n, parameters=dict(params),
                                         artifact_path=plan_dir(plan))],
                        runner_config=SimTorchConfig(chunk=chunk, validate=validate, **cfg),
                        env=OutputsEnv(str(tmp_path)))

    chunks = []

    class Sink:
        def write(self, text):
            chunks.append(text)

        def flush(self):
            pass

    worker = subprocess.Popen(
        [sys.executable, "-m", "testground_tpu_torch.cli", "sim-worker", "--coordinator",
         coord, "--num-processes", "2", "--process-id", "1", "--plans", PLANS_ROOT,
         "--once"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        box = {}
        th = threading.Thread(target=lambda: box.update(out=execute_sim_run(
            job("cohort", coordinator_address=coord, num_processes=2),
            OutputWriter(sink=Sink()), threading.Event())), daemon=True)
        th.start()
        th.join(120)
        assert "out" in box, "the cohort run did not finish"
        shutdown_leader_child()
        wout, _ = worker.communicate(timeout=60)
    finally:
        shutdown_leader_child()
        if worker.poll() is None:
            worker.kill()
    single = execute_sim_run(job("single"), discard_writer(), threading.Event()).result
    got = box["out"].result
    assert got.outcome.value == single.outcome.value == "success"
    assert got.journal.get("metrics") == single.journal.get("metrics")
    for k in ("msgs_sent", "msgs_delivered", "msgs_in_flight", "msgs_dropped",
              "msgs_rejected", "ticks"):
        assert got.journal["sim"][k] == single.journal["sim"][k], k
    log = "".join(json.loads(c).get("p", "") for c in "".join(chunks).splitlines()
                  if c.startswith("{"))
    assert "collectives over gloo" in log
    lead = re.findall(r"multi-host: carry digest (\d+)", log)
    assert lead and re.findall(r"run cohort carry digest (\d+)", wout) == lead
