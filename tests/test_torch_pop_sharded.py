"""The sharded pop's segment geometry on the CPU. The kernel
(``pop_shard_vec_k`` / ``pop_shard_scalar_k``) walks the runs that
``cuda_transport.pop_segments`` describes and nothing else; here those
runs are applied with plain torch indexing and held bit for bit against
``pop_bucket_sharded_plain`` (itself held against the JAX package in
``test_torch_mesh.py``), at small n, over the shapes ``chip_smoke.py``'s
``kernels`` phase gives the kernel. No jax.
"""

import numpy as np
import pytest
import torch

from testground_tpu_torch.sim import cuda_transport as ct
from testground_tpu_torch.sim import net
from testground_tpu_torch.sim.meshplan import TorchMesh

CPU = torch.device("cpu")


def _meshed_calendar(rng, shards, parts, horizon, n, slots, width, occ_bool):
    cuts = (0, *parts, shards)
    mesh = TorchMesh((CPU,) * shards,
                     parts=tuple((CPU, a, b) for a, b in zip(cuts, cuts[1:])))
    fill = rng.random((horizon, n * slots)) < 0.25
    occ = fill if occ_bool else np.where(fill, rng.integers(1, n + 1, fill.shape), 0)
    occ = torch.from_numpy(occ.astype(bool if occ_bool else np.int32))
    pay = [torch.from_numpy(rng.integers(-(2**31), 2**31, fill.shape, dtype=np.int64)
                            .astype(np.int32)) for _ in range(width)]

    def sh(x):
        return None if x is None else net.to_shards(x, mesh, slots)

    return net.Calendar(payload=tuple(sh(p) for p in pay),
                        src=None if occ_bool else sh(occ), valid=sh(occ) if occ_bool else None,
                        slots=slots, mesh=mesh)


def _copy(cal):
    def c(x):
        return None if x is None else tuple(p.clone() for p in x)

    return net.Calendar(payload=tuple(c(p) for p in cal.payload), src=c(cal.src),
                        valid=c(cal.valid), slots=cal.slots, mesh=cal.mesh)


def _runs(seg, b):
    """The ``[shards, slots, length]`` source and destination cells of
    ``seg``'s runs at bucket row ``b``, flattened."""
    s = torch.arange(seg.shards)[:, None, None]
    slot = torch.arange(seg.slots)[None, :, None]
    cells = torch.arange(seg.length)
    src = s * seg.src_shard + slot * seg.src_slot + b * seg.src_row + cells
    dst = seg.dst0 + s * seg.dst_shard + slot * seg.dst_slot + cells
    return src.reshape(-1), dst.reshape(-1)


def _pop_by_segments(cal, t, non_home=()):
    """The sharded pop as the kernel walks it, one part at a time; the
    parts in ``non_home`` take the local-row geometry and are copied
    home, as the wrapper does for a part off the primary device."""
    slots, n_loc, n = cal.slots, cal.n_loc, cal.lanes
    b = int(t) % cal.horizon
    occ_parts = cal.occupancy_plane
    row_occ = torch.zeros(slots * n, dtype=occ_parts[0].dtype)
    rows = [torch.zeros(slots * n, dtype=torch.int32) for _ in range(cal.width)]
    written = torch.zeros(slots * n, dtype=torch.int64)
    for i, (_, s0, s1) in enumerate(cal.mesh.parts):
        part = cal.part(i)
        home = i not in non_home
        seg = ct.pop_segments(cal, i, home)
        src, dst = _runs(seg, b)
        assert int(src.max()) < part.occupancy_plane.numel()
        cells = seg.shards * seg.slots * seg.length
        out = [row_occ, *rows] if home else [
            torch.zeros(cells, dtype=r.dtype) for r in (row_occ, *rows)]
        for plane, row in zip([part.occupancy_plane, *part.payload], out):
            row[dst] = plane.reshape(-1)[src]
        part.occupancy_plane.view(-1)[src] = 0
        if home:
            written[dst] += 1
        else:
            assert sorted(dst.tolist()) == list(range(cells))
            for glob, loc in zip([row_occ, *rows], out):
                glob.view(slots, n)[:, s0 * n_loc:s1 * n_loc] = loc.view(slots, -1)
            written.view(slots, n)[:, s0 * n_loc:s1 * n_loc] += 1
    # every cell of the global rows is written exactly once
    assert bool((written == 1).all())
    return row_occ, rows


# (shards, parts, horizon, n, slots, width, occ_bool, t, non_home): the
# kernels phase's sharded-pop cases at small n
_CASES = {
    "flagship": (4, (), 8, 64, 4, 1, False, 11, ()),
    "flagship-S8": (8, (), 8, 64, 4, 1, False, 11, ()),
    "pingpong": (4, (), 128, 64, 4, 2, False, 131, ()),
    "storm": (4, (), 8, 64, 16, 1, True, 11, ()),
    "flood": (4, (), 8, 64, 1, 1, True, 11, ()),
    "width-8": (4, (), 16, 64, 4, 8, False, 19, ()),
    "n_loc-odd": (4, (), 16, 4 * 7, 3, 2, False, 19, ()),
    "n_loc-odd-bool": (4, (), 16, 4 * 7, 4, 1, True, 19, ()),
    "n_loc-6-bool": (4, (), 16, 24, 2, 1, True, 19, ()),
    "bool-words": (4, (), 8, 4 * 12, 4, 2, True, 11, ()),
    "bool-16": (4, (), 8, 4 * 16, 4, 2, True, 11, ()),
    "many-segments": (4, (), 2, 8, 16400, 1, False, 3, ()),
    "slots-past-the-grid": (2, (), 2, 4, 65540, 1, True, 3, ()),
    "parts-1+3": (4, (1,), 8, 64, 4, 1, False, 11, ()),
    "parts-1+3-local": (4, (1,), 8, 64, 4, 2, True, 11, (1,)),
    "parts-1+2+1-local": (4, (1, 3), 8, 4 * 6, 3, 1, False, 11, (0, 2)),
    "negative-t": (4, (), 8, 64, 4, 1, False, -13, ()),
}


@pytest.mark.parametrize("case", list(_CASES))
def test_segment_geometry_pops_what_the_plain_version_pops(case):
    shards, parts, horizon, n, slots, width, occ_bool, t, non_home = _CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    cal = _meshed_calendar(rng, shards, parts, horizon, n, slots, width, occ_bool)
    a, b = _copy(cal), _copy(cal)
    tick = torch.tensor(t, dtype=torch.int32)
    _, want_occ, want_pay = ct.pop_bucket_sharded_plain(a, tick)
    got_occ, got_pay = _pop_by_segments(b, tick, non_home)
    for got, want in zip([got_occ, *got_pay], [want_occ, *want_pay]):
        assert got.dtype == want.dtype and torch.equal(got, want)
    for got, want in zip(b.occupancy_plane, a.occupancy_plane):
        assert torch.equal(got, want)
