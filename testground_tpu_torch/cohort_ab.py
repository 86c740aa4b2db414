"""Each rank's peak device bytes, its collectives and its wall of a
two-rank library cohort of ``chip_smoke.py``'s sustained program on card 0,
against the same program alone, in the checkout at DIR:

    python3 testground_tpu_torch/cohort_ab.py DIR LABEL [--n 100000[,1000000]]
        [--ticks 64] [--device cuda]

Both ranks are processes on card 0 (``SimProgram`` on
``distributed.global_mesh``; the tick's collectives over gloo), each
importing the package from DIR, so the same command measures a parent
checkout (unpacked with ``git archive``) and the change: run them in one
call. A rank reports ``torch.cuda.max_memory_allocated`` over its carry's
build and its run (less what the process held before), its carry's bytes, the wall of each of the run's two
chunks (``ticks / 2`` each), and, where DIR's ``sim/distributed.py``
counts them, its collectives' calls, bytes sent and host ms a tick; the
ranks take each size of ``--n`` in turn. The program alone then runs in
this process: its peak bytes and its wall. Prints one JSON line a size.
``--device cpu`` rehearses the script on the CPU (no device bytes).
"""

import json
import os
import socket
import subprocess
import sys
import time

SUSTAINED = {"duration_ticks": "500", "reshape_every": "250", "latency_ms": "4",
             "latency2_ms": "2"}


def _program(n, ticks, device, mesh=None):
    from testground_tpu_torch.api import RunGroup
    from testground_tpu_torch.sim.engine import SimProgram, build_groups
    from testground_tpu_torch.sim.executor import (
        instantiate_testcase,
        load_sim_testcases,
        plan_dir,
    )

    groups = build_groups([RunGroup(id="all", instances=n, parameters=SUSTAINED)])
    tc = instantiate_testcase(
        load_sim_testcases(plan_dir("network"))["pingpong-sustained"], groups, 1.0)
    return SimProgram(tc, groups, chunk=ticks // 2, device=None if mesh else device,
                      mesh=mesh)


def _measure(prog, ticks, cancel=None) -> dict:
    """Build the carry and run ``ticks``: peak bytes, carry bytes and each
    chunk's ms a tick."""
    import torch

    from testground_tpu_torch.sim.engine import carry_bytes

    cuda = prog.device.type == "cuda"
    base = 0
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    carry = prog.init_carry(0)
    held = carry_bytes(carry)
    chunks = []

    class Perf:
        def on_chunk(self, index, ticks_now, delta, wall):
            chunks.append(wall / delta * 1e3)

    kw = {} if cancel is None else {"cancel": cancel}
    prog.run(seed=0, max_ticks=ticks, resume_carry=carry, perf=Perf(), **kw)
    if cuda:
        torch.cuda.synchronize()
    return {"peak_bytes": torch.cuda.max_memory_allocated() - base if cuda else None,
            "carry_bytes": held,
            "footprint": prog.footprint(carry), "chunk_ms_per_tick": chunks}


def _rank(coord: str, rank: int, sizes: list, ticks: int, device: str) -> None:
    from testground_tpu_torch.sim import distributed

    distributed.init_distributed(coord, 2, rank)
    stats = getattr(distributed, "collective_stats", None)
    for n in sizes:
        prog = _program(n, ticks, device, mesh=distributed.global_mesh(device))
        if stats is not None:
            stats(reset=True)
        row = _measure(prog, ticks, distributed.CohortCancel(None))
        if stats is not None:
            row["collectives_per_tick"] = {
                op: {"calls": v["calls"] / ticks, "bytes": v["bytes"] / ticks,
                     "ms": v["secs"] * 1e3 / ticks}
                for op, v in stats().items()}
        print("RANK " + json.dumps({"n": n, "rank": rank, **row}), flush=True)
        del prog
    distributed.shutdown()


def ranks(d: str, sizes: list, ticks: int, device: str = "cuda") -> dict:
    """The two rank processes of checkout ``d`` over ``sizes`` in turn:
    ``{n: [rank 0's row, rank 1's row]}``."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        coord = f"127.0.0.1:{s.getsockname()[1]}"
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--rank", coord,
                               str(r), ",".join(map(str, sizes)), str(ticks), device],
                              env=dict(os.environ, PYTHONPATH=d), cwd=d,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in (0, 1)]
    try:
        outs = [p.communicate(timeout=900)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode != 0 for p in procs):
        raise RuntimeError("a cohort rank failed:\n" + "\n".join(o[-3000:] for o in outs))
    rows = [json.loads(ln[5:]) for o in outs for ln in o.splitlines()
            if ln.startswith("RANK ")]
    return {n: sorted((r for r in rows if r["n"] == n), key=lambda r: r["rank"])
            for n in sizes}


def alone(n: int, ticks: int, device: str = "cuda") -> dict:
    """The same program alone, in this process."""
    return _measure(_program(n, ticks, device), ticks)


def main(argv) -> int:
    if argv[0] == "--rank":
        _rank(argv[1], int(argv[2]), [int(x) for x in argv[3].split(",")], int(argv[4]),
              argv[5])
        return 0
    d, label = os.path.abspath(argv[0]), argv[1]
    opts = dict(zip(argv[2::2], argv[3::2]))
    sizes = [int(x) for x in opts.get("--n", "100000").split(",")]
    ticks, device = int(opts.get("--ticks", 64)), opts.get("--device", "cuda")
    t0 = time.perf_counter()
    by_n = ranks(d, sizes, ticks, device)
    cohort_s = time.perf_counter() - t0
    sys.path.insert(0, d)
    for n in sizes:
        print(json.dumps({"who": label, "n": n, "ticks": ticks, "ranks": by_n[n],
                          "alone": alone(n, ticks, device), "cohort_s": cohort_s}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
