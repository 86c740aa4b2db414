"""Wall ms/tick of sustained@100k with every plane off, in the checkout at
DIR, for comparing two commits on one card:

    python3 testground_tpu_torch/sustained_ab.py DIR LABEL            # steady
    python3 testground_tpu_torch/sustained_ab.py DIR LABEL --first    # first runs

Default: one warm-up run, then three timed runs of ``chip_smoke.py``'s
sustained program (500 ticks, chunk 250), then the sync-debug counts of a
chunk-16 twin at 32 and 64 ticks. ``--first``: three timed runs in the
fresh process, the first included (what a process's first run pays).
It drives DIR's own ``chip_smoke.py`` helpers, so the same command times
a parent checkout (unpacked with ``git archive``) and the change; run the
two in alternating order, in one call. Prints one JSON line.
"""

import json
import os
import sys


def main(argv) -> int:
    d, label = argv[0], argv[1]
    first = "--first" in argv[2:]
    sys.path.insert(0, os.path.abspath(d))
    os.chdir(d)
    import chip_smoke as cs

    prog = cs.program("pingpong-sustained", 100_000, cs.SUSTAINED, chunk=250)
    if not first:
        cs.run_timed(prog, max_ticks=10_000)
    walls = []
    for _ in range(3):
        _, wall, ticks, _ = cs.run_timed(prog, max_ticks=10_000)
        walls.append(wall / ticks * 1e3)
    row = {"who": label, "wall_ms_per_tick": walls, "ticks": ticks,
           "launches": cs.read_launches()}
    if not first:
        twin = cs.program("pingpong-sustained", 100_000, cs.SUSTAINED, chunk=16)
        row["host_syncs"] = {k: cs.host_syncs(twin, k) for k in (32, 64)}
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
