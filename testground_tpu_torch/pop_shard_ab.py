"""Device time of the sharded delivery pop, and of K2 at the same shapes,
in the checkout at DIR, for comparing two commits on one card:

    python3 testground_tpu_torch/pop_shard_ab.py DIR LABEL

At four shapes of ``chip_smoke.py``'s kernels phase (flagship, storm,
ping-pong and flood at N = 100k, the sharded pop on a 4-shard virtual
mesh), each kernel's own device time from ``torch.profiler``, the mean
of 50 calls: with the L2 cache as the previous call left it ("hot") and
with 256 MB written between calls ("cold"). Each pop is held bit-equal to
its plain version first. Then the main path: sustained@100k's first
chunk, meshed and unmeshed, under the profiler, and the transport
kernels' device time a launch. It drives DIR's own ``chip_smoke.py``
helpers and kernels, so the same command times a parent checkout
(unpacked with ``git archive``) and the change; run the two in
alternating order, in one call. Prints one JSON line.
"""

import json
import os
import subprocess
import sys

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

KERNELS = ("commit_k", "pop_vec_k", "pop_scalar_k", "pop_shard_")
# name: (L, N, SLOTS, W, bool occupancy)
SHAPES = {"flagship": (8, 100_000, 4, 1, False), "storm": (8, 100_000, 16, 1, True),
          "pingpong": (128, 100_000, 4, 2, False), "flood": (8, 100_000, 1, 1, True)}


def kernel_ms(prof) -> dict:
    """Device ms a launch of each transport kernel in ``prof``."""
    out = {}
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA") and e.key.startswith(KERNELS):
            us = getattr(e, "self_device_time_total", None)
            us = us if us is not None else e.self_cuda_time_total
            out[e.key.split("(")[0]] = us / 1e3 / e.count
    return out


def main(argv) -> int:
    d, label = argv[0], argv[1]
    sys.path.insert(0, os.path.abspath(d))
    os.chdir(d)
    import chip_smoke as cs
    from testground_tpu_torch.sim import cuda_transport as ct
    from testground_tpu_torch.sim import net

    dev = torch.device("cuda")
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)
    row = {"who": label, "kernels": {}}
    for shape, (L, N, slots, W, occ_bool) in SHAPES.items():
        cal_u = cs._calendar(net, L, N, slots, W, occ_bool, False,
                             np.random.default_rng(7), dev)
        t = torch.tensor(L + 3, dtype=torch.int32, device=dev)
        b = (L + 3) % L
        got = {}
        for name, c0, pop, plain in (
            ("K2", cal_u, ct.pop_bucket, ct.pop_bucket_plain),
            ("pop_shard", cs._sharded(net, cal_u, cs.card_mesh(4)), ct.pop_bucket_sharded,
             ct.pop_bucket_sharded_plain),
        ):
            ck, cp = cs._clone_cal(net, c0), cs._clone_cal(net, c0)
            _, rk, pk = pop(ck, t)
            _, rp, pp = plain(cp, t)
            err = cs._max_err([*cs._planes(ck), rk, *pk], [*cs._planes(cp), rp, *pp])
            if err:
                raise RuntimeError(f"{shape} {name}: kernel disagrees with plain ({err})")
            work = cs._clone_cal(net, c0)
            occ0, occw = c0.occupancy_plane, work.occupancy_plane
            pairs = [(occw, occ0)] if name == "K2" else list(zip(occw, occ0))
            for cache in ("hot", "cold"):
                def restore():
                    for w, o in pairs:
                        w.select(-2, b).copy_(o.select(-2, b))
                    if cache == "cold":
                        flush.add_(1)

                for _ in range(3):
                    restore()
                    pop(work, t)
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    for _ in range(50):
                        restore()
                        pop(work, t)
                    torch.cuda.synchronize()
                got.setdefault(cache, {}).update({name: kernel_ms(prof)})
        row["kernels"][shape] = got
    row["main"] = {}
    for kind, mesh in (("unmeshed", None), ("mesh", 4)):
        prog = cs.program("pingpong-sustained", 100_000, cs.SUSTAINED, chunk=250, mesh=mesh)
        prog.run(seed=0, max_ticks=16)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            prog.run(seed=0, max_ticks=64)
            torch.cuda.synchronize()
        row["main"][kind] = kernel_ms(prof)
    row["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
