"""Wall ms/tick and host syncs a tick of the plan cases whose steps built a
device constant from host data every tick, in the checkout at DIR, for
comparing two commits on one card:

    python3 testground_tpu_torch/steps_ab.py DIR LABEL

Cases, at ``chip_smoke.py``'s parameters and 100,000 instances:
``benchmarks:pingpong-flood`` (500 ticks, chunk 500), ``barrier``,
``netinit``, ``netlinkshape``, ``subtree`` and ``startup`` (to all
SUCCESS, chunk 64) and ``network:ping-pong`` (to all SUCCESS, chunk 64).
Each case: one warm-up run, then two timed runs, then the sync-debug count
of a chunk-16 twin over 32 ticks. It drives DIR's own ``chip_smoke.py``
helpers, so the same command times a parent checkout (unpacked with ``git
archive``) and the change; run the two in alternating order, in one call.
Prints one JSON line.
"""

import json
import os
import sys

CASES = {  # label: (plan, case, params, chunk, max_ticks)
    "flood": ("benchmarks", "pingpong-flood",
              {"duration_ticks": "500", "latency_ms": "4"}, 500, 10_000),
    **{c: ("benchmarks", c, {}, 64, 4096)
       for c in ("barrier", "netinit", "netlinkshape", "subtree", "startup")},
    "ping-pong": ("network", "ping-pong",
                  {"latency_ms": "100", "latency2_ms": "10", "tolerance_ms": "15"},
                  64, 4096),
}


def main(argv) -> int:
    d, label = argv[0], argv[1]
    sys.path.insert(0, os.path.abspath(d))
    os.chdir(d)
    import chip_smoke as cs

    row = {"who": label, "cases": {}}
    for name, (plan, case, params, chunk, max_ticks) in CASES.items():
        prog = cs.program(case, 100_000, params, chunk=chunk, plan=plan)
        cs.run_timed(prog, max_ticks=max_ticks)
        walls = []
        for _ in range(2):
            res, wall, ticks, _ = cs.run_timed(prog, max_ticks=max_ticks)
            cs.check(bool((res["status"] == 1).all()), f"{name}: not every instance SUCCESS")
            walls.append(wall / ticks * 1e3)
        twin = cs.program(case, 100_000, params, chunk=16, plan=plan)
        row["cases"][name] = {"wall_ms_per_tick": walls, "ticks": ticks,
                              "host_syncs_32": cs.host_syncs(twin, 32)}
        del prog, twin
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
