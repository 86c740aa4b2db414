"""Device kernels and device µs a call of a padded program's two lane
translations (``engine._Virtual.dst`` and ``.src``) on the card, beside
the variants that would take a kernel out of them:

    python3 testground_tpu_torch/translate_ab.py

The program is sustained@100k under the default ladder (131,072 lanes),
built with ``chip_smoke.program``; the inputs have the tick's shapes: the
plan's int32 destinations (one row of the outbox, with out-of-range values
and -1 mixed in) and the calendar's int32 provenance (``[SLOTS, lanes]``,
-1 in the empty slots). Each variant is profiled over 50 calls
(``torch.profiler``, device activity only). Prints one JSON line.
"""

import json
import os
import sys

REPS = 50


def main() -> int:
    sys.path.insert(0, os.getcwd())
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from testground_tpu_torch.sim.buckets import DEFAULT_LADDER

    prog = cs.program("pingpong-sustained", 100_000, cs.SUSTAINED, chunk=64,
                      ladder=DEFAULT_LADDER)
    virt, dev = prog._virt, torch.device("cuda")
    lanes = prog.n_lanes
    g = torch.Generator(device=dev).manual_seed(0)
    dst = torch.randint(-1, virt.n_vlanes + 3, (lanes,), generator=g, device=dev,
                        dtype=torch.int32)
    src = torch.randint(-1, lanes, (type(prog.tc).IN_MSGS, lanes), generator=g,
                        device=dev, dtype=torch.int32)
    dst64, src64 = dst.clamp(-1, virt.n_vlanes).long(), src.long()
    dst_nn = dst.clamp(0, virt.n_vlanes)
    variants = {
        # as the engine runs them
        "dst": lambda: virt.dst(dst),
        "src": lambda: virt.src(src),
        # the int32 → int64 index conversion taken out (an int64 input)
        "dst_index_int64_clamped": lambda: virt.dst_tbl[dst64],
        "src_index_int64": lambda: virt.src_tbl[src64],
        # index_select takes an int32 index, but no negative one
        "dst_index_select_nonneg": lambda: torch.index_select(virt.dst_tbl, 0, dst_nn),
        "dst_clamp_index_select": lambda: torch.index_select(
            virt.dst_tbl, 0, dst.clamp(0, virt.n_vlanes)),
    }
    out = {"lanes": lanes, "n_vlanes": virt.n_vlanes, "reps": REPS, "variants": {}}
    for name, fn in variants.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(REPS):
                fn()
            torch.cuda.synchronize()
        rows = [r for r in cs._device_rows(prof) if r[1] > 0]
        out["variants"][name] = {
            "kernels_per_call": sum(r[2] for r in rows) / REPS,
            "device_us_per_call": sum(r[1] for r in rows) / REPS,
            "kernels": sorted({r[0][:60] for r in rows}),
        }
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
