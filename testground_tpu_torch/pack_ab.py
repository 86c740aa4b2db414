"""Wall ms/tick of a width-8 pack of sustained tenants against one member
alone, on the library path (``PackRunner.run`` and ``SimProgram.run``, no
executor), and where each spends its host time:

    python3 testground_tpu_torch/pack_ab.py DIR LABEL [--profile]
        [--mesh 4,2x4] [--turns N]

The pack is ``chip_smoke.py``'s pack8@sustained (eight tenants at 24,000 …
31,000 instances, 32,768 lanes each, telemetry, chunk 250); the member
alone is the first tenant. One warm-up run of each, then ``--turns`` (3)
timed runs of each in rotated order (ms/tick of the whole run, and of its
steady chunks: every chunk after the first, timed on the host at the chunk
boundary). ``--mesh`` puts the same pack on each listed virtual mesh of
card 0 in place of the member alone (``PackRunner(..., mesh=make_mesh(
shape, devices=[card 0] * k))``), against the unmeshed pack.
``--profile`` adds a ``cProfile`` of one more run of each: the top
functions by own time. It drives DIR's own ``chip_smoke.py`` helpers,
so the same command times a parent checkout and the change in one call.
Prints one JSON line.
"""

import cProfile
import io
import json
import os
import pstats
import statistics
import sys
import time


def main(argv) -> int:
    d, label = argv[0], argv[1]
    opts = argv[2:]
    profile = "--profile" in opts
    meshes = opts[opts.index("--mesh") + 1].split(",") if "--mesh" in opts else []
    turns = int(opts[opts.index("--turns") + 1]) if "--turns" in opts else 3
    sys.path.insert(0, os.path.abspath(d))
    os.chdir(d)
    import torch

    import chip_smoke as cs
    from testground_tpu_torch.sim.buckets import DEFAULT_LADDER, plan_buckets
    from testground_tpu_torch.sim.meshplan import make_mesh, parse_mesh_shape
    from testground_tpu_torch.sim.pack import PackMember, PackRunner

    sizes = cs.PACK_SIZES

    def prog():
        return cs.program("pingpong-sustained", sizes[0], cs.SUSTAINED, chunk=250,
                          telemetry=True, ladder=DEFAULT_LADDER)

    lcs = [plan_buckets([n], "auto", DEFAULT_LADDER).live_counts for n in sizes]
    pack_prog, member_prog = prog(), prog()
    runner = PackRunner(pack_prog, len(sizes))

    def timed(fn):
        """(ms/tick over the run, ms/tick over its chunks after the first)."""
        marks = []

        def on_chunk(ticks):
            torch.cuda.synchronize()
            marks.append((ticks, time.perf_counter()))

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ticks = fn(on_chunk)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        (k0, s0), (k1, s1) = marks[0], marks[-1]
        steady = (s1 - s0) / max(min(k1, ticks) - k0, 1) * 1e3
        return wall / ticks * 1e3, steady

    def pack_of(pack_runner):
        def run_pack(on_chunk):
            members = [PackMember(seed=k, live_counts=lc, max_ticks=10_000)
                       for k, lc in enumerate(lcs)]
            members[0].on_chunk = on_chunk
            res = pack_runner.run(members)
            return max(int(r["finished_at"].max()) + 1 for r in res)

        return run_pack

    def run_member(on_chunk):
        res = member_prog.run(seed=0, max_ticks=10_000, on_chunk=on_chunk)
        return int(res["finished_at"].max()) + 1

    ways = {"pack": pack_of(runner)}
    card0 = torch.device("cuda", 0)
    for shape in meshes:
        cells = 1
        for extent in parse_mesh_shape(shape):
            cells *= extent
        ways[f"mesh-{shape}"] = pack_of(PackRunner(
            prog(), len(sizes), mesh=make_mesh(shape, devices=[card0] * cells)))
    if not meshes:
        ways["member"] = run_member
    for fn in ways.values():
        timed(fn)
    got = {w: [] for w in ways}
    order = list(ways)
    for i in range(turns):
        for w in order[i % len(order):] + order[: i % len(order)]:
            got[w].append(timed(ways[w]))
    row = {"who": label, "sizes": list(sizes)}
    for w, runs in got.items():
        row[w] = {"wall_ms_per_tick": [r[0] for r in runs],
                  "steady_ms_per_tick": [r[1] for r in runs]}
    if "member" in got:
        p, m = (statistics.median(r[1] for r in got[w]) for w in ("pack", "member"))
        row["steady_aggregate_ratio"] = len(sizes) * m / p
    if profile:
        for w, fn in ways.items():
            prof = cProfile.Profile()
            prof.enable()
            fn(lambda ticks: None)
            torch.cuda.synchronize()
            prof.disable()
            out = io.StringIO()
            pstats.Stats(prof, stream=out).sort_stats("tottime").print_stats(25)
            row[f"{w}_profile"] = out.getvalue().splitlines()[6:40]
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
