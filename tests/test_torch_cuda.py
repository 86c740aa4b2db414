"""The port's CUDA kernels on the card: each against its plain version on
the same CUDA tensors, and a short run on the GPU against the same run on
the CPU. Every test takes the ``cuda`` fixture, which skips it where
there is no GPU. This file imports no jax, so on a machine with the GPU
and without jax it runs as

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


@pytest.mark.parametrize("occ_bool,stacking,etick,width", [
    (False, True, False, 1), (False, True, True, 3),
    (True, False, True, 2), (True, True, False, 1)])
def test_commit_kernel_matches_plain(cuda, occ_bool, stacking, etick, width):
    rng = np.random.default_rng(width)
    horizon, n, slots, m2 = 8, 1000, 4, 3000
    cal = _cal(rng, horizon, n, slots, width, occ_bool, etick, cuda)
    keys = np.sort(rng.integers(0, horizon * n + 200, m2))
    sk = torch.from_numpy(np.minimum(keys, horizon * n).astype(np.int32)).to(cuda)
    occ_vals = torch.from_numpy(rng.integers(1, n, m2).astype(np.int32)).to(cuda)
    pay = [torch.from_numpy(rng.integers(0, 99, m2).astype(np.int32)).to(cuda)
           for _ in range(width)]
    t = torch.tensor(3, dtype=torch.int32, device=cuda)
    a, b = _copy(cal), _copy(cal)
    before = ct.commit_calendar.launches
    _, sa = ct.commit_calendar(a, sk, occ_vals, pay, t, stacking=stacking)
    _, sb = ct.commit_calendar_plain(b, sk, occ_vals, pay, t, stacking=stacking)
    torch.cuda.synchronize()
    assert ct.commit_calendar.launches == before + 1
    assert torch.equal(sa, sb)
    for x, y in zip(_planes(a), _planes(b)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("occ_bool,n,slots", [(False, 1000, 4), (True, 1000, 4),
                                              (False, 333, 3)])
def test_pop_kernel_matches_plain(cuda, occ_bool, n, slots):
    rng = np.random.default_rng(n)
    cal = _cal(rng, 16, n, slots, 2, occ_bool, False, cuda)
    t = torch.tensor(37, dtype=torch.int32, device=cuda)
    a, b = _copy(cal), _copy(cal)
    _, ra, pa = ct.pop_bucket(a, t)
    _, rb, pb = ct.pop_bucket_plain(b, t)
    torch.cuda.synchronize()
    for x, y in zip([ra, *pa, *_planes(a)], [rb, *pb, *_planes(b)]):
        assert torch.equal(x, y)


def test_gpu_run_matches_cpu_run(cuda):
    factory = load_sim_testcases(plan_dir("network"))["pingpong-sustained"]
    groups = build_groups([RunGroup(id="all", instances=64,
                                    parameters={"duration_ticks": "40",
                                                "reshape_every": "16"})])
    out = []
    for device in ("cpu", cuda):
        prog = SimProgram(instantiate_testcase(factory, groups, 1.0), groups,
                          chunk=16, device=device)
        last = {}
        res = prog.run(seed=1, max_ticks=256,
                       observer=lambda k, c: last.__setitem__("c", carry_to_numpy(c)))
        out.append((res, last["c"]))
    (rc, cc), (rg, cg) = out
    assert (rc["status"] == 1).all()
    for k in ("ticks", "msgs_sent", "msgs_delivered", "cal_depth", "msgs_dropped"):
        assert rc[k] == rg[k], k
    for k in cc:
        np.testing.assert_array_equal(cg[k], cc[k], err_msg=k)
