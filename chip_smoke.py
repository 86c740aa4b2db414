"""Smoke test of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py            # every phase (needs one CUDA device)
    python3 chip_smoke.py --phases device,build,kernels

Builds the transport kernels from ``testground_tpu_torch/csrc`` with nvcc,
holds each kernel against its plain PyTorch version on the card (bit-equal)
and drives the port's main path through the library entry points
(``build_groups`` → ``instantiate_testcase`` → ``SimProgram.run``):

1. device   — the card's name and power limit (nvidia-smi)
2. build    — nvcc for sm_90a, with its wall seconds
3. kernels  — K1 commit and K2 pop against their plain versions at the
              flagship shape (L=8, N=100k, SLOTS=4, W=1, m2=200k), the
              ping-pong shape (L=128, W=2), storm's shape (SLOTS=16, bool
              occupancy, no stacking, a 500k Poisson fan-in stream with
              runs past 16), a duplicate-doubled stream, flood's K2
              (SLOTS=1, bool), storm's K2 (a 1.6M-cell bool row), the
              256-row horizon of netlinkshape, and small variants (bool
              occupancy, no stacking, etick, runs straddling a commit
              tile, heavy fan-in, SLOTS=1, W=8), K1 at the flagship shape
              with the etick plane (the telemetry plane's commit) and
              flood's K2 with int32 occupancy (flood under the traffic
              matrix); the sharded K1 and K2 on virtual meshes on card 0
              (the flagship at S=4 and S=8, ping-pong, storm, etick, a
              stream wholly in one shard, an empty shard, W=8, runs
              straddling a tile, fan-in, pops with n_loc % 4 != 0, bool
              pops in 4-byte words and 16-byte vectors, segments of many
              chunks, 65,600 segments, SLOTS past the grid's y limit, and
              the shards held in two tensors); kernel, plain and library
              times (CUDA events, median of 25 after warm-up), the
              events' floor (an empty kernel timed the same way) and the
              memory bound at 3.35 TB/s. Last of all, after every
              wall-clocked phase, the kernel's and the library call's own
              device time (``torch.profiler`` over 25 calls), the
              floor's, and the share of the bound the kernel's device
              time reaches
4. sustained — network:pingpong-sustained at 100k instances, 500 ticks
              (reshape every 250, chunk 250): all SUCCESS, both kernels
              launched, flow conservation exact; peer·ticks/s and
              per-phase ms/tick
5. pingpong — network:ping-pong at 100k instances (100/10 ms): all SUCCESS
6. flood    — benchmarks:pingpong-flood at 100k instances, 500 ticks,
              4 ms (chunk 500): direct slots, K2 only; all SUCCESS,
              conservation, rounds > 0
7. storm    — benchmarks:storm at 100k instances (5 connections, 32-tick
              dial delays, 512 KiB each, chunk 64) to all SUCCESS: a 500k
              message stream a tick through K1 at SLOTS=16; bytes read > 0
8. benchmarks — barrier, netinit, netlinkshape, subtree and startup at
              100k instances, each to all SUCCESS
9. scale    — pingpong-sustained at 1M instances for 64 ticks, and the
              run's peak device bytes over what was allocated before it
10. faults  — sustained@100k at phase 4's parameters, 500 ticks, under a
              fault schedule of every kind (crash and restart of 10k
              instances, a link flap, a partition into halves, a latency
              spike, a loss burst), beside the same sustained run without
              one: fault counters, wall and device ms/tick, busy share and
              kernels a tick of both; all SUCCESS and the flow totals
              closing over fault_dropped
11. telemetry — sustained@100k at phase 4's parameters, 500 ticks, four
              ways in one turn (wall deltas paired against the same
              turn's planes-off run, resolved past the off runs' quartiles): every observability plane off, telemetry,
              telemetry + the traffic matrix, and those two + a 64-lane
              trace plan; wall and device ms/tick, busy share, kernels a
              tick, host waits a tick and sync-debug counts at 32 and 64
              ticks of each; the counter block sums to the flow totals,
              the latency histogram to the messages delivered, the matrix
              reconciles and the trace events decode. Then the faulted
              sustained@100k of phase ``faults`` with telemetry + matrix:
              the crash purge in the fault cells, the matrix reconciled
12. plans   — placebo's seven cases at 100k, and verify, splitbrain,
              additional_hosts (one echo host) and chaos (the smoke
              composition's schedule, instance ranges scaled) at 256:
              each to its expected terminal status
13. executor — execute_sim_run: sustained@100k with every plane and a warn
              rule against SimProgram.run (one turn), faults@100k and chaos
              at 256 with SLO rules, CPU vs GPU at 4,096
14. mesh    — sustained@100k at phase 4's parameters on a 4-shard virtual
              mesh on card 0, in one turn with the same run unmeshed:
              all SUCCESS, each sharded kernel launched once a tick, flow
              conservation exact, every carry leaf equal to the unmeshed
              run's; wall and device ms/tick, kernels a tick, busy share
              of both, sync-debug counts at 32 and 64 ticks; ping-pong@100k
              and flood@100k on the mesh to all SUCCESS; step ``parts``:
              sustained@100k (500 ticks) and @1M (64 ticks) unmeshed, on
              the mesh of one part and on the mesh cut into 4 parts, each
              part holding and stepping its own lanes: equal carry
              digests, each part's carry bytes the predicted replicated +
              placed ÷ 4, the card's peak, kernels a tick and wall ms/tick
              (see ``mesh_parts_step``)
15. cli     — the port's CLI (``testground_tpu_torch.cli.main.main`` in
              process) in temporary homes holding the port's plans:
              ``healthcheck --runner sim:torch``; the sustained smoke
              composition (telemetry files, K1 and K2 journaled and
              launched); the build's precompile pass (``build composition
              --write-artifacts`` of sustained@100k bucketed on a rung of
              100,000: its marker, its warm tick's launches as the builder
              logs them, ``total_instances``; a rebuild's cache hit with
              no launch; a run of the built composition journaling
              ``compile_cache: "hit"``); sustained@100k as a composition in one turn
              against ``execute_sim_run`` of the ``RunInput`` the CLI
              lowered, after a warm-up run (the CLI's host cost per run
              and per tick; then kernels a tick and device ms/tick of both,
              profiled); ``run single network:ping-pong -i 100000`` to all
              SUCCESS; the chaos smoke composition on the card and, from a
              home with ``device = "cpu"``, on the CPU: run directories and
              task results equal; and a run mirrored to a local Influx
              capture server (the plan-metric, ``sim.*``,
              ``sim.latency.*`` and ``sim.perf.*`` families)
16. daemon  — the daemon as a process with the verbs against it, then an
              in-process daemon: sustained@100k through its client in one
              turn against the in-process CLI, two runs at once, a kill, chaos
              smoke CPU ↔ card (see ``phase_daemon``)
17. admit   — an in-process daemon on the card refuses five bad variants
              of cli@100k's composition at submit (422, no task, one
              ``task.refused``, no device memory) and admits the composition
              itself, whose run journals ``sim.perf``; ``execute_sim_run``
              with the perf ledger on and off, one pair (ms/tick; syncs,
              launches and ops a tick equal); a one-chunk
              ``profile_chunks`` capture naming K1 and K2; ``tg check`` as
              a process (see ``phase_admit``)
18. observe — the phase ledger of cli@100k's composition (its rows, the
              exact residual, K1's and K2's closed-form bytes, measured ms
              beside a PhaseTimer; the ops a tick with it on and off), the
              transport probe, the daemon's runs alone, under a ``tg
              watch`` and under a ``tg top`` process (ms/tick; the rows the
              watcher saw), the read-side verbs through ``--endpoint`` and
              one banked row (see ``phase_observe``)
19. surface — ``tg check --trace-plans`` as processes (with and without a
              visible card) and in process, allocating nothing on the card
              and launching nothing, with sustained@1M refused by
              ``plan.memory``; plan import, ``plan list``, ``describe`` and
              a run of the imported plan through a daemon process;
              ``/metrics``, ``/dashboard`` and ``/data``; and cli@100k's
              runs alone, under a ``/metrics`` poller and under a
              dashboard poller (see ``phase_surface``)
20. resume  — the checkpoint plane and the fleet controller: sustained@100k
              through ``execute_sim_run`` with a snapshot every chunk (bytes,
              D2H and write ms of each) against the knob at 0 in one
              turn (ms/tick; with the knob at 0 ops and syncs a
              tick equal to a run without the key), a run cut at tick 250
              and resumed, the faulted sustained at 4,096 snapshotted on the
              CPU and resumed on the card, each equal to the uninterrupted
              card run (journal, telemetry stream, final carry); an
              in-process daemon's ``/preempt``, priority eviction and
              ``/drain``; sustained@1M's snapshot and restore (see
              ``phase_resume``)
21. buckets — shape buckets: sustained@100k exact against ``bucket =
              "auto"`` (131,072 lanes) through ``execute_sim_run`` in
              one turn, equal; ``build --buckets`` and a
              bucketed ``run single`` through the CLI; ops and syncs a
              tick; ping-pong@100k and the faulted sustained at 4,000
              padded (CPU ↔ card); 100,002 instances on a 4-shard mesh
              (two dead lanes) with an exact-shape snapshot; 1M padded to
              1,048,576 (peak bytes); a bucketed ``tg check
              --trace-plans``; every plan case's syncs, exact against
              padded; device ms and kernels a tick last (see
              ``phase_buckets``)
22. packs   — run packs: eight sustained tenants at 24,000 … 31,000
              instances (32,768 lanes each) through an in-process daemon
              with one worker, against the same eight one after another
              through ``execute_sim_run``, one turn, each member
              equal to its serial run; the reference's ping-pong pack
              smoke at 5 … 29 instances against CPU runs; a straggler and
              an SLO-canceled member against their isolated runs; the
              eight on a 4-shard virtual mesh against the unmeshed pack,
              one turn, each member equal; 64 ticks of the eight placed
              over three meshes of several parts on card 0 ("4" cut into
              four, "2x4", "2x4" cut into four), each member equal to the
              unmeshed pack's and each part's bytes its own; the
              pack against one member alone and the meshed packs, peak
              bytes and a profiled first chunk last (see ``phase_packs``)
23. cohort  — sustained@100k at phase 4's parameters as a two-process
              cohort on card 0 (``execute_sim_run`` with
              ``coordinator_address`` through the leader child, one
              ``tg-torch sim-worker``; the collectives over gloo) against
              the same composition alone: bit-equal outcome, per-group
              outcomes, metrics, flow totals and carry digests; wall
              ms/tick of both, a profiled twin's kernels and collectives a
              tick, join and first-chunk seconds, and a follower SIGKILLed
              mid-run failing the task readably (see ``phase_cohort``)
24. sync    — the sync service on the card's host (no card): the port's
              ``tg-syncsvc`` and ``tg-fanin-driver`` built with g++, then
              native@1,000, python@1,000 and native@10,000 clients, each on
              a fresh ``tg-torch sync-service`` process through the
              driver's connect, flood, barrier storm and pubsub; op
              counters conserved, ``/metrics`` reconciled, no CUDA context
              in a service process (see ``phase_sync``)
25. exec    — the ``local:exec`` runner on the card's host, through the CLI:
              ``placebo:ok`` at 64 instances on ``exec:py`` (native sync
              service), ``example:sync`` at 16, ``network:ping-pong`` at 2
              and 4 (real TCP, each dialer's two RTT lines printed),
              ``example-cpp:sync`` at 16
              on ``exec:bin`` (g++) and the ``polyglot`` rendezvous (with
              perl), each to all SUCCESS with its ``collect`` tarball, and
              ``placebo:ok`` at 64 on ``sim:torch`` on the card with the same
              outcome; no instance maps ``libcuda`` or is a compute app;
              instances/s and seconds to all outcomes (see ``phase_exec``)
26. parity  — sustained, flood and storm at 4,096 instances, the faulted
              sustained at 4,096, and chaos and additional_hosts at 64,
              on the CPU (plain versions) and on the card (kernels), every
              carry leaf and results() key, and with the planes on:
              sustained at 4,096 with every plane, the faulted sustained
              at 4,096 with the matrix, chaos at 64 with a trace plan,
              traffic-shaped at 4,096 with the matrix (the HTB queue) —
              every counter block, histogram and matrix delta, backlog
              high-water and trace block too; fully shaped enqueues (every
              sorted-path feature; duplicate with the HTB queue; range
              rules; control lanes sharing buckets with plan rows under a
              fault schedule) and one direct-mode enqueue under validate
              with forced collisions (counts and first collision):
              bit-equal; and sustained, flood, storm and the faulted
              sustained with the matrix on a 4-shard virtual mesh, CPU vs
              GPU and each against its unmeshed twin

Each phase prints one JSON line (the main-path phases with their
wall seconds; the kernel cases after the last phase, with their device
times). Then the card's ``name, power.limit``
line, the ``{"kernels": [...]}`` line and, last, ``{"ok": true, "device":
...}``. Any failure raises, so the script exits non-zero and prints no
result. It imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12  # HBM3 rate of one H100 SXM (data sheet)
PHASES = ("device", "build", "kernels", "sustained", "pingpong", "flood", "storm",
          "benchmarks", "scale", "faults", "telemetry", "plans", "executor", "mesh",
          "cli", "daemon", "admit", "observe", "surface", "resume", "buckets", "packs",
          "cohort", "sync", "exec", "parity")
# the benchmarks cases besides flood and storm, run at their defaults
BENCH_OTHERS = ("barrier", "netinit", "netlinkshape", "subtree", "startup")
# bench.py's sustained (bench.py:56-69) as phase 4 runs it, 500 ticks
SUSTAINED = {"duration_ticks": "500", "reshape_every": "250",
             "latency_ms": "4", "latency2_ms": "2"}


def sustained_fault_tables(n: int) -> dict:
    """The faults phase's schedule over ``n`` instances, ranges in tenths
    of n (at 100k: 0:10000 is the first tenth): crash the first tenth at
    100 ms and restart it at 250 ms; a link flap on the second tenth,
    120-200 ms, period 8 ms, duty 0.5; a bidirectional partition into
    halves, 300-380 ms; +2 ms on the third tenth, 150-250 ms; a 30% loss
    burst on the fourth, 400-450 ms."""
    def r(lo, hi):
        return f"{lo * n // 10}:{hi * n // 10}"

    return {"": [
        {"kind": "crash", "start_ms": 100, "instances": r(0, 1)},
        {"kind": "restart", "start_ms": 250, "instances": r(0, 1)},
        {"kind": "link_flap", "start_ms": 120, "duration_ms": 80, "period_ms": 8,
         "duty": 0.5, "instances": r(1, 2)},
        {"kind": "partition", "start_ms": 300, "duration_ms": 80, "bidirectional": True,
         "instances": r(0, 5), "to_instances": r(5, 10)},
        {"kind": "latency_spike", "start_ms": 150, "duration_ms": 100, "latency_ms": 2.0,
         "instances": r(2, 3)},
        {"kind": "loss_burst", "start_ms": 400, "duration_ms": 50, "loss": 30.0,
         "instances": r(3, 4)},
    ]}


def chaos_setup(n: int) -> tuple[dict, dict]:
    """The chaos plan's parameters and fault tables at ``n`` instances:
    ``plans/chaos/_compositions/smoke.toml``'s schedule (written for 8)
    with its instance ranges scaled by n/8 and its times unchanged. The
    probe sweep takes n-1 ticks, so heal_tick and deadline move past it
    by n; slow_tick keeps its 30 (after the restart at 20)."""
    def r(lo, hi):
        return f"{lo * n // 8}:{hi * n // 8}"

    params = {"slow_tick": "30", "heal_tick": str(44 + n), "deadline": str(120 + n)}
    return params, {"all": [
        {"kind": "crash", "instances": r(0, 2), "start_ms": 6.0},
        {"kind": "link_flap", "instances": r(2, 4), "start_ms": 8.0, "duration_ms": 8.0,
         "period_ms": 4.0, "duty": 0.5},
        {"kind": "restart", "instances": r(0, 2), "start_ms": 20.0},
        {"kind": "partition", "instances": r(0, 4), "to_instances": r(4, 8),
         "start_ms": 24.0, "duration_ms": 16.0},
    ]}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def time_ms(fn, restore, reps: int = 25, warm: int = 3) -> float:
    """Median device time of ``fn`` over ``reps`` calls (CUDA events
    around the call only); ``restore`` resets the inputs before each. A
    ~1 ms spin kernel queued ahead of the start event keeps the device
    busy while the host issues the call, so the window holds device time,
    not the wrapper's Python overhead, even on a slow host (a call that
    synchronises inside, as the plain K1 does, still pays its own
    stalls)."""
    times = []
    for i in range(warm + reps):
        restore()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        if i >= warm:
            times.append(start.elapsed_time(end))
    return statistics.median(times)


# the transport kernels' names as the profiler reports them
TRANSPORT_KERNELS = ("commit_k", "pop_vec_k", "pop_scalar_k", "pop_shard_")


def _device_rows(prof) -> list:
    """``(name, self device µs, count)`` of the profiler's device-side
    events (kernels, memcpy/memset): a CPU op's self device time would
    count its kernels a second time."""
    def dev_us(e):
        v = getattr(e, "self_device_time_total", None)
        return v if v is not None else getattr(e, "self_cuda_time_total", 0)

    return [(e.key, dev_us(e), e.count) for e in prof.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA")]


def device_events(fn, restore=lambda: None, reps: int = 25, warm: int = 3,
                  tries: int = 3, want=None) -> tuple:
    """``({name: [device µs, events kept, most events one window kept]},
    windows)`` of the device events of ``fn``, from ``torch.profiler``'s
    self device time over up to ``tries`` windows of ``reps`` calls,
    ``restore`` before each call inside the window, each window opened by
    a warm-up step of ``warm`` calls whose events are dropped. No spin kernel and no CUDA
    events: the profiler reads each kernel's own start and end. The
    profiler keeps a varying share of a short window's events (on the H100
    anywhere from all to none, more often after earlier sessions), so a
    reading pools every kept event; ``want`` = (name prefixes, events a
    call) stops the tries once one window kept all of those."""
    from torch.profiler import ProfilerActivity, profile, schedule

    def calls(n):
        for _ in range(n):
            restore()
            fn()
        torch.cuda.synchronize()

    got: dict = {}
    for windows in range(1, tries + 1):
        with profile(activities=[ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            calls(warm)
            prof.step()
            calls(reps)
            prof.step()
        for name, us, n in _device_rows(prof):
            g = got.setdefault(name, [0.0, 0, 0])
            g[0], g[1], g[2] = g[0] + us, g[1] + n, max(g[2], n)
        if want and sum(g[2] for k, g in got.items()
                        if k.startswith(want[0])) >= want[1] * reps:
            break
    return got, windows


def per_call_ms(got, reps: int = 25):
    """Device ms a call of the events in ``got``: each name's mean an
    event times its events a call (the most one window kept, rounded up);
    None where nothing was kept."""
    ms = sum(us / n * -(-most // reps) for us, n, most in got.values() if n) / 1e3
    return ms or None


def _launches_of(fn, restore) -> int:
    """Kernel launches one call of ``fn`` makes, by the wrappers' counts."""
    from testground_tpu_torch.sim import cuda_transport as ct

    def count():
        return sum(getattr(ct, k).launches for k in KERNELS + SHARDED_KERNELS)

    restore()
    before = count()
    fn()
    return count() - before


def device_pass(rows) -> float | None:
    """Each kernel case's device times, after every wall-clocked phase (a
    profiler session slows every later launch on the host):
    ``kernel_device_ms``, the kernel's own events a call (their mean a
    launch times the launches a call the wrappers count;
    ``kernel_device_kept``, the share of its launches the profiler kept);
    ``library_device_ms``, the device events of a call of the library
    window less those of a window of ``restore`` alone; and
    ``bound_share`` = bound ÷ kernel device time. Returns the launch
    floor's device time (an empty kernel, the same reps)."""
    for r in rows:
        fn, restore, library = r.pop("_timed")
        per_call = _launches_of(fn, restore)
        got, windows = device_events(fn, restore, want=(TRANSPORT_KERNELS, per_call))
        got = [g for k, g in got.items() if k.startswith(TRANSPORT_KERNELS)]
        us, kept = sum(g[0] for g in got), sum(g[1] for g in got)
        r["kernel_device_ms"] = us / kept * per_call / 1e3 if kept else None
        r["kernel_device_kept"] = kept / (per_call * 25 * windows) if per_call else None
        r["bound_share"] = (r["bound_ms"] / r["kernel_device_ms"]
                            if r["kernel_device_ms"] else None)
        r["library_device_ms"] = None
        if library is not None:
            lib = per_call_ms(device_events(library, restore)[0])
            alone = per_call_ms(device_events(lambda: None, restore)[0])
            if lib is not None:
                r["library_device_ms"] = lib - (alone or 0.0)
    return per_call_ms(device_events(lambda: torch.cuda._sleep(0))[0])


# ------------------------------------------------------------ kernels


def _calendar(net, L, N, slots, W, occ_bool, etick, rng, dev):
    ns = N * slots
    fill = rng.random((L, ns)) < 0.15
    if occ_bool:
        occ = torch.from_numpy(fill).to(dev)
    else:
        occ = torch.from_numpy(
            np.where(fill, rng.integers(1, N + 1, (L, ns)), 0).astype(np.int32)
        ).to(dev)
    cal = net.Calendar(
        payload=tuple(
            torch.from_numpy(
                rng.integers(-(2**31), 2**31, (L, ns), dtype=np.int64).astype(np.int32)
            ).to(dev)
            for _ in range(W)
        ),
        src=None if occ_bool else occ,
        valid=occ if occ_bool else None,
        etick=(
            torch.from_numpy(rng.integers(0, 50, (L, ns)).astype(np.int32)).to(dev)
            if etick
            else None
        ),
        slots=slots,
    )
    return cal


def _clone_cal(net, cal):
    def c(x):
        if x is None:
            return None
        return tuple(p.clone() for p in x) if isinstance(x, tuple) else x.clone()

    return net.Calendar(
        payload=tuple(c(p) for p in cal.payload),
        src=c(cal.src), valid=c(cal.valid), etick=c(cal.etick),
        slots=cal.slots, mesh=cal.mesh,
    )


def _planes(cal):
    """Every plane tensor of ``cal``; a meshed calendar's parts one by one."""
    planes = [cal.occupancy_plane, *cal.payload] + (
        [cal.etick] if cal.etick is not None else []
    )
    return [q for p in planes for q in (p if isinstance(p, tuple) else (p,))]


def card_mesh(shards, device="cuda", parts=None):
    """A virtual mesh of ``shards`` peer shards, every one on card 0 (or on
    the CPU); ``parts`` (shard cuts) holds them in several tensors."""
    from testground_tpu_torch.sim.meshplan import TorchMesh, make_mesh

    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", 0)
    if parts is None:
        return make_mesh(str(shards), devices=[dev] * shards)
    cuts = (0, *parts, shards)
    return TorchMesh((dev,) * shards,
                     parts=tuple((dev, a, b) for a, b in zip(cuts, cuts[1:])))


def _sharded(net, cal, mesh):
    """A global calendar's planes cut into ``mesh``'s shards."""
    def sh(x):
        return None if x is None else net.to_shards(x, mesh, cal.slots)

    return net.Calendar(payload=tuple(sh(p) for p in cal.payload), src=sh(cal.src),
                        valid=sh(cal.valid), etick=sh(cal.etick), slots=cal.slots,
                        mesh=mesh)


def _shard_major(keys, L, N, n_loc, dst_map=None):
    """Bucket-major keys (b·N + dst, dead ≥ L·N) as the sorted shard-major
    stream of the same messages (``dst_map`` moves their destinations)."""
    live = (keys >= 0) & (keys < L * N)
    b, d = keys // N, keys % N
    if dst_map is not None:
        d = dst_map(d)
    sm = (d // n_loc) * L * n_loc + b * n_loc + d % n_loc
    return np.sort(np.where(live, sm, L * N), kind="stable")


def _max_err(a_list, b_list) -> int:
    return max(
        int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) if a.numel() else 0
        for a, b in zip(a_list, b_list)
    )


def _stream_keys(kind, rng, m2, L, N, slots, t_host, tile):
    """Sorted keys of one stream kind. ``main`` is the main path's stream:
    every message lands a few ticks ahead (shaped latencies), destinations
    collide, a tenth are dead keys. ``straddle`` lays a run of SLOTS+3
    across every odd commit-tile boundary and a run of exactly SLOTS
    ending at every even one, with short runs between. ``fanin`` puts
    every message on one (bucket, dst). ``poisson`` is storm's stream: 5
    messages a sender to uniform destinations, all in the next bucket
    (Poisson(5) fan-in), with a few runs of 20-40 planted so that ranks
    pass SLOTS=16. ``dup`` is the main stream and its duplicate copies one
    bucket later, the copies not drawn dead."""
    if kind == "main":
        bucket = (t_host + rng.choice([2, 4], m2)) % L
        keys = bucket.astype(np.int64) * N + rng.integers(0, N, m2)
        keys[rng.random(m2) < 0.1] = L * N
        return np.sort(keys, kind="stable")
    if kind == "fanin":
        return np.full(m2, ((t_host + 2) % L) * N + int(rng.integers(0, N)))
    if kind == "poisson":
        keys = ((t_host + 1) % L) * N + rng.integers(0, N, m2)
        heavy = rng.integers(0, N, 8)
        keys[: 8 * 30] = ((t_host + 1) % L) * N + np.repeat(heavy, 30)
        return np.sort(keys)
    if kind == "dup":
        m = m2 // 2
        orig = _stream_keys("main", rng, m, L, N, slots, t_host, tile)
        live = orig < L * N
        copy = np.where(live & (rng.random(m) < 0.3), orig + N, L * N)
        copy = np.where(copy >= L * N, L * N, copy)  # no wrap past row L-1
        return np.sort(np.concatenate([orig, copy]), kind="stable")
    check(kind == "straddle", f"unknown stream kind {kind}")
    lengths, pos, k = [], 0, 1
    while pos < m2:
        start, run = (k * tile - 2, slots + 3) if k % 2 else (k * tile - slots, slots)
        while pos < start:
            lengths.append(min(start - pos, int(rng.integers(1, 4))))
            pos += lengths[-1]
        lengths.append(run)
        pos += run
        k += 1
    keys = np.sort(rng.choice(L * N, len(lengths), replace=False))
    return np.repeat(keys, lengths)[:m2]


def commit_case(label, L, N, slots, W, m2, occ_bool, stacking, etick, seed,
                stream="main"):
    from testground_tpu_torch.sim import cuda_transport as ct
    from testground_tpu_torch.sim import net

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    cal0 = _calendar(net, L, N, slots, W, occ_bool, etick, rng, dev)
    t_host = 5
    keys = _stream_keys(stream, rng, m2, L, N, slots, t_host, ct.COMMIT_TILE)
    sk = torch.from_numpy(keys.astype(np.int32)).to(dev)
    occ_vals = torch.from_numpy(
        (np.ones(m2) if occ_bool else rng.integers(1, N + 1, m2)).astype(np.int32)
    ).to(dev)
    pay = [
        torch.from_numpy(rng.integers(0, 2**31, m2).astype(np.int32)).to(dev)
        for _ in range(W)
    ]
    t = torch.tensor(t_host, dtype=torch.int32, device=dev)

    cal_k, cal_p = _clone_cal(net, cal0), _clone_cal(net, cal0)
    _, surv_k = ct.commit_calendar(cal_k, sk, occ_vals, pay, t, stacking=stacking)
    _, surv_p = ct.commit_calendar_plain(cal_p, sk, occ_vals, pay, t, stacking=stacking)
    torch.cuda.synchronize()
    err = _max_err([*_planes(cal_k), surv_k], [*_planes(cal_p), surv_p])
    check(err == 0, f"K1 {label}: kernel disagrees with plain (max err {err})")

    work = _clone_cal(net, cal0)

    def restore():
        for dst, src in zip(_planes(work), _planes(cal0)):
            dst.copy_(src)

    def kernel():
        ct.commit_calendar(work, sk, occ_vals, pay, t, stacking=stacking)

    kernel_ms = time_ms(kernel, restore)
    plain_ms = time_ms(
        lambda: ct.commit_calendar_plain(work, sk, occ_vals, pay, t, stacking=stacking),
        restore,
    )
    live = keys < L * N
    runs = int(np.unique(keys[live]).size)
    survivors = int(surv_p.sum())
    nbytes = ct.commit_bytes(m2, W, slots, occ_bool, stacking, etick, runs, survivors)
    return {
        "kernel": "commit_calendar",
        "case": label,
        "shape": dict(L=L, N=N, slots=slots, W=W, m2=m2, occ_bool=occ_bool,
                      stacking=stacking, etick=etick, stream=stream),
        "survivors": survivors,
        "max_abs_err": err,
        "kernel_ms": kernel_ms,
        "plain_ms": plain_ms,
        "library_ms": None,
        "bound_ms": nbytes / H100_BYTES_PER_S * 1e3,
        "bound_bytes": nbytes,
        "_timed": (kernel, restore, None),
    }


def pop_case(label, L, N, slots, W, occ_bool, seed):
    from testground_tpu_torch.sim import cuda_transport as ct
    from testground_tpu_torch.sim import net

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    cal0 = _calendar(net, L, N, slots, W, occ_bool, False, rng, dev)
    t = torch.tensor(L + 3, dtype=torch.int32, device=dev)
    cal_k, cal_p = _clone_cal(net, cal0), _clone_cal(net, cal0)
    _, row_k, pay_k = ct.pop_bucket(cal_k, t)
    _, row_p, pay_p = ct.pop_bucket_plain(cal_p, t)
    torch.cuda.synchronize()
    err = _max_err(
        [*_planes(cal_k), row_k, *pay_k], [*_planes(cal_p), row_p, *pay_p]
    )
    check(err == 0, f"K2 {label}: kernel disagrees with plain (max err {err})")

    work = _clone_cal(net, cal0)
    b = (L + 3) % L
    bidx = torch.tensor([b], dtype=torch.int64, device=dev)

    def restore():
        work.occupancy_plane[b].copy_(cal0.occupancy_plane[b])

    def library():
        for p in (work.occupancy_plane, *work.payload):
            torch.index_select(p, 0, bidx)
        work.occupancy_plane.index_fill_(0, bidx, 0)

    def kernel():
        ct.pop_bucket(work, t)

    kernel_ms = time_ms(kernel, restore)
    plain_ms = time_ms(lambda: ct.pop_bucket_plain(work, t), restore)
    library_ms = time_ms(library, restore)
    nbytes = ct.pop_bytes(N * slots, W, occ_bool)  # rows in, rows out, clear
    return {
        "kernel": "pop_bucket",
        "case": label,
        "shape": dict(L=L, N=N, slots=slots, W=W, occ_bool=occ_bool),
        "max_abs_err": err,
        "kernel_ms": kernel_ms,
        "plain_ms": plain_ms,
        "library_ms": library_ms,
        "bound_ms": nbytes / H100_BYTES_PER_S * 1e3,
        "bound_bytes": nbytes,
        "_timed": (kernel, restore, library),
    }


def sharded_commit_case(label, S, L, N, slots, W, m2, occ_bool, stacking, etick, seed,
                        stream="main", dst="any", parts=None):
    """The sharded K1 on a virtual mesh of S shards on card 0 against its
    plain version, on the main path's stream in shard-major order.
    ``dst`` "one-shard" sends every message into the last shard,
    "empty-shard" none into shard 1; ``parts`` holds the shards in
    several tensors (one launch each, masks summed)."""
    from testground_tpu_torch.sim import cuda_transport as ct
    from testground_tpu_torch.sim import net

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    mesh = card_mesh(S, parts=parts)
    n_loc = N // S
    cal0 = _sharded(net, _calendar(net, L, N, slots, W, occ_bool, etick, rng, dev), mesh)
    t_host = 5
    dst_map = {"any": None,
               "one-shard": lambda d: (S - 1) * n_loc + d % n_loc,
               "empty-shard": lambda d: np.where(d // n_loc == 1, d + n_loc, d)}[dst]
    keys = _shard_major(_stream_keys(stream, rng, m2, L, N, slots, t_host, ct.COMMIT_TILE),
                        L, N, n_loc, dst_map)
    sk = torch.from_numpy(keys.astype(np.int32)).to(dev)
    occ_vals = torch.from_numpy(
        (np.ones(m2) if occ_bool else rng.integers(1, N + 1, m2)).astype(np.int32)
    ).to(dev)
    pay = [torch.from_numpy(rng.integers(0, 2**31, m2).astype(np.int32)).to(dev)
           for _ in range(W)]
    t = torch.tensor(t_host, dtype=torch.int32, device=dev)

    cal_k, cal_p = _clone_cal(net, cal0), _clone_cal(net, cal0)
    _, surv_k = ct.commit_calendar_sharded(cal_k, sk, occ_vals, pay, t, stacking=stacking)
    _, surv_p = ct.commit_calendar_sharded_plain(cal_p, sk, occ_vals, pay, t,
                                                 stacking=stacking)
    torch.cuda.synchronize()
    err = _max_err([*_planes(cal_k), surv_k], [*_planes(cal_p), surv_p])
    check(err == 0, f"sharded K1 {label}: kernel disagrees with plain (max err {err})")
    work = _clone_cal(net, cal0)

    def restore():
        for d_, s_ in zip(_planes(work), _planes(cal0)):
            d_.copy_(s_)

    def kernel():
        ct.commit_calendar_sharded(work, sk, occ_vals, pay, t, stacking=stacking)

    kernel_ms = time_ms(kernel, restore)
    plain_ms = time_ms(lambda: ct.commit_calendar_sharded_plain(
        work, sk, occ_vals, pay, t, stacking=stacking), restore)
    live = keys < L * N
    runs = int(np.unique(keys[live]).size)
    survivors = int(surv_p.sum())
    nbytes = ct.commit_bytes(m2, W, slots, occ_bool, stacking, etick, runs, survivors)
    return {
        "kernel": "commit_calendar_sharded", "case": label,
        "shape": dict(S=S, parts=len(mesh.parts), L=L, N=N, slots=slots, W=W, m2=m2,
                      occ_bool=occ_bool, stacking=stacking, etick=etick, stream=stream,
                      dst=dst),
        "survivors": survivors, "max_abs_err": err,
        "kernel_ms": kernel_ms, "plain_ms": plain_ms, "library_ms": None,
        "bound_ms": nbytes / H100_BYTES_PER_S * 1e3, "bound_bytes": nbytes,
        "_timed": (kernel, restore, None),
    }


def sharded_pop_case(label, S, L, N, slots, W, occ_bool, seed, parts=None):
    """The sharded K2 on a virtual mesh of S shards on card 0 against its
    plain version; the library yardstick is ``index_select`` of each
    shard's row and ``index_copy_`` into the strided global row, and
    ``index_fill_`` of the occupancy rows."""
    from testground_tpu_torch.sim import cuda_transport as ct
    from testground_tpu_torch.sim import net

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    mesh = card_mesh(S, parts=parts)
    n_loc = N // S
    cal0 = _sharded(net, _calendar(net, L, N, slots, W, occ_bool, False, rng, dev), mesh)
    t = torch.tensor(L + 3, dtype=torch.int32, device=dev)
    cal_k, cal_p = _clone_cal(net, cal0), _clone_cal(net, cal0)
    _, row_k, pay_k = ct.pop_bucket_sharded(cal_k, t)
    _, row_p, pay_p = ct.pop_bucket_sharded_plain(cal_p, t)
    torch.cuda.synchronize()
    err = _max_err([*_planes(cal_k), row_k, *pay_k], [*_planes(cal_p), row_p, *pay_p])
    check(err == 0, f"sharded K2 {label}: kernel disagrees with plain (max err {err})")
    work = _clone_cal(net, cal0)
    b = (L + 3) % L
    bidx = torch.tensor([b], dtype=torch.int64, device=dev)
    occ0, occw = cal0.occupancy_plane, work.occupancy_plane

    def restore():
        for d_, s_ in zip(occw, occ0):
            d_[:, b].copy_(s_[:, b])

    shard_idx = [torch.arange(s1 - s0, device=dev) + s0 for _, s0, s1 in mesh.parts]
    rows = [torch.empty(N * slots, dtype=p[0].dtype, device=dev)
            for p in (occw, *work.payload)]

    def library():
        for row, plane in zip(rows, (occw, *work.payload)):
            for part, idx in zip(plane, shard_idx):
                got = part.index_select(1, bidx).view(-1, slots, n_loc).transpose(0, 1)
                row.view(slots, S, n_loc).index_copy_(1, idx, got)
        for part in occw:
            part.index_fill_(1, bidx, 0)

    def kernel():
        ct.pop_bucket_sharded(work, t)

    kernel_ms = time_ms(kernel, restore)
    plain_ms = time_ms(lambda: ct.pop_bucket_sharded_plain(work, t), restore)
    library_ms = time_ms(library, restore)
    nbytes = ct.pop_bytes(N * slots, W, occ_bool)
    return {
        "kernel": "pop_bucket_sharded", "case": label,
        "shape": dict(S=S, parts=len(mesh.parts), L=L, N=N, n_loc=n_loc, slots=slots,
                      W=W, occ_bool=occ_bool),
        "max_abs_err": err, "kernel_ms": kernel_ms, "plain_ms": plain_ms,
        "library_ms": library_ms,
        "bound_ms": nbytes / H100_BYTES_PER_S * 1e3, "bound_bytes": nbytes,
        "_timed": (kernel, restore, library),
    }


# ------------------------------------------------------------ main path


class PhaseTimer:
    """CUDA events at each engine phase mark; per-tick device ms by
    phase, and the gap between one tick's end and the next one's start."""

    def __init__(self):
        self.marks = []

    def mark(self, name):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        self.marks.append((name, e))

    def per_tick_ms(self) -> dict:
        torch.cuda.synchronize()
        sums: dict[str, float] = {}
        ticks = 0
        prev = None
        for name, e in self.marks:
            key = "gap" if name == "tick" else name
            if name == "tick":
                ticks += 1
            if prev is not None:
                sums[key] = sums.get(key, 0.0) + prev.elapsed_time(e)
            prev = e
        return {k: v / max(ticks, 1) for k, v in sums.items()}


def program(case, n, params, chunk, device="cuda", plan="network", fault_tables=None,
            trace=None, mesh=None, ladder=None, parts=None, **kw):
    """A port SimProgram of one group; ``fault_tables`` (fault tables by
    group id) are lowered by the port's ``build_fault_schedule``, ``trace``
    (an instance range, "lo:hi") by its ``build_trace_plan``; ``mesh`` (a
    shard count) runs it on a virtual mesh on ``device``, cut into several
    parts at the shard cuts ``parts`` (each part then holding and stepping
    its own lanes). ``ladder`` (a
    bucket ladder) pads the group to its rung as the executor does under
    ``bucket = "auto"``: the plan specialized at the padded count, the
    fault schedule lowered in the exact layout and remapped."""
    from testground_tpu_torch.api import RunGroup
    from testground_tpu_torch.sim.engine import SimProgram, build_groups
    from testground_tpu_torch.sim.executor import (
        instantiate_testcase,
        load_sim_testcases,
        plan_dir,
    )

    factory = load_sim_testcases(plan_dir(plan))[case]
    exact = build_groups([RunGroup(id="all", instances=n, parameters=params)])
    groups, bp = exact, None
    if ladder:
        from testground_tpu_torch.sim.buckets import plan_buckets

        bp = plan_buckets([n], "auto", tuple(ladder))
        groups = build_groups([RunGroup(id="all", instances=bp.padded_counts[0],
                                        parameters=params)])
        kw["live_counts"] = bp.live_counts
    tc = instantiate_testcase(factory, groups, tick_ms=1.0)
    if fault_tables:
        from testground_tpu_torch.sim.faults import build_fault_schedule, remap_schedule

        kw["faults"] = build_fault_schedule(exact, fault_tables, 1.0)
        if bp is not None:
            kw["faults"] = remap_schedule(kw["faults"], bp.index_map(), bp.padded_n)
    if trace:
        from testground_tpu_torch.sim.trace import build_trace_plan

        kw["trace"] = build_trace_plan(groups, {"": {"instances": trace}})
    if mesh:
        kw["mesh"] = card_mesh(mesh, device, parts)
    return SimProgram(
        tc, groups, test_plan=plan, test_case=case, tick_ms=1.0,
        chunk=chunk, device=device, **kw,
    )


KERNELS = ("commit_calendar", "pop_bucket")
SHARDED_KERNELS = ("commit_calendar_sharded", "pop_bucket_sharded")


def reset_launches():
    from testground_tpu_torch.sim import cuda_transport as ct

    for k in KERNELS + SHARDED_KERNELS:
        getattr(ct, k).launches = 0


def read_launches(kernels=KERNELS) -> dict:
    from testground_tpu_torch.sim import cuda_transport as ct

    return {k: getattr(ct, k).launches for k in kernels}


def run_timed(prog, max_ticks, timer=None):
    """One wall-clocked run (its launches counted from zero: read them
    with ``read_launches`` right after)."""
    reset_launches()
    last = {}

    def keep(ticks, carry):
        last["carry"] = carry

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = prog.run(seed=0, max_ticks=max_ticks, observer=keep, timer=timer)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    real_ticks = int(last["carry"].t)
    return res, wall, real_ticks, last["carry"]


def conserved(res) -> bool:
    """sent = delivered + in-flight + dropped + rejected + fault_dropped
    (the last is 0 without a fault schedule)."""
    return res["msgs_sent"] == (
        res["msgs_delivered"] + res["cal_depth"] + res["msgs_dropped"]
        + res["msgs_rejected"] + res["fault_dropped"]
    )


def flows(res) -> dict:
    return {k: res[k] for k in ("msgs_sent", "msgs_delivered", "cal_depth",
                                "msgs_dropped", "msgs_rejected", "fault_dropped")}


def phase_sustained(card) -> dict:
    n = 100_000
    prog = program("pingpong-sustained", n, SUSTAINED, chunk=250)
    res, wall, ticks, _ = run_timed(prog, max_ticks=10_000)
    launches = read_launches()
    check(bool((res["status"] == 1).all()), "sustained: not every instance SUCCESS")
    check(all(v > 0 for v in launches.values()), f"sustained: launches {launches}")
    check(conserved(res), f"sustained: flow conservation {flows(res)}")
    timer = PhaseTimer()
    prog.run(seed=0, max_ticks=10_000, timer=timer)
    row = {
        "phase": "sustained", "n": n, "ticks": ticks, "results_ticks": res["ticks"],
        "wall_s": wall, "wall_ms_per_tick": wall / ticks * 1e3,
        "peer_ticks_per_s": n * ticks / wall,
        "launches": launches, "flows": flows(res),
        "rounds_min": int(res["states"][0]["rounds"].min()),
        "phase_ms_per_tick": timer.per_tick_ms(),
        # a chunk-64 twin's first 64 ticks (the chunk-250 program's
        # profile covered 250)
        **profile_twin(n, wall / ticks * 1e3),
        "card": card,
    }
    # sync-debug counts on a chunk-16 twin, so 32 and 64 ticks differ by
    # 32 ticks (the chunk-250 program runs 250 ticks for both)
    twin = program("pingpong-sustained", n, SUSTAINED, chunk=16)
    twin.run(seed=0, max_ticks=16)
    row["host_syncs"] = {k: host_syncs(twin, k) for k in (32, 64)}
    return row


def host_syncs(prog, ticks, sites=None) -> int:
    """Synchronizing CUDA calls that ``torch.cuda.set_sync_debug_mode``
    reports over one run of ``ticks`` ticks, set-up included: the runs of
    32 and 64 ticks differ by 32 ticks' worth when the program's chunk
    divides 32 (``max_ticks`` rounds up to whole chunks). ``sites``, a
    dict, receives the count of each calling line ("file:line")."""
    return counted_syncs(lambda: prog.run(seed=0, max_ticks=ticks), sites)[1]


def dispatched_ops(fn) -> tuple:
    """``(fn(), the aten ops it dispatched)``, counted on the host by a
    ``TorchDispatchMode`` (exact, unlike a profiler's device events); on
    the card each op launches its kernels."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            return func(*args, **(kwargs or {}))

    mode = Count()
    with mode:
        out = fn()
    return out, mode.n


def counted_syncs(fn, sites=None) -> tuple:
    """``(fn(), synchronizing CUDA calls it made)``, as ``host_syncs``
    counts them."""
    import warnings

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn()
            torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in caught if "synchroniz" in str(w.message)]
    if sites is not None:
        for w in syncs:
            key = f"{os.path.relpath(w.filename)}:{w.lineno}"
            sites[key] = sites.get(key, 0) + 1
    return out, len(syncs)


def device_profile(prog, ticks, wall_ms_per_tick, by_name=False) -> dict:
    """Device kernel time per tick from ``torch.profiler`` over the first
    chunk of a run (at least ``ticks`` ticks; the real count is read off
    the carry), its top kernels, the transport kernels' device time per
    launch, and the device's busy share of the unprofiled wall time per
    tick. Where the profiler reports no device time, the share is "not
    measured" (None). It records device activity only: host activity,
    which none of these figures reads, cost the host most of a window's
    time; ``by_name`` adds each device event's count a tick."""
    from torch.profiler import ProfilerActivity, profile

    last = {}
    acts = [ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        prog.run(seed=0, max_ticks=ticks,
                 observer=lambda k, c: last.__setitem__("t", int(c.t)))
        torch.cuda.synchronize()
    ticks = last["t"]
    rows = [r for r in _device_rows(prof) if r[1] > 0]
    total_ms = sum(r[1] for r in rows) / 1e3 / ticks
    top = sorted(rows, key=lambda r: -r[1])[:10]
    named = {}
    if by_name:
        per = named["kernels_per_tick_by_name"] = {}
        for k, _, calls in rows:
            per[k[:80]] = per.get(k[:80], 0) + calls / ticks
    return {
        **named,
        "profiled_ticks": ticks,
        "device_ms_per_tick": total_ms if rows else None,
        "device_busy_share": total_ms / wall_ms_per_tick if rows else None,
        "kernels_per_tick": sum(r[2] for r in rows) / ticks if rows else None,
        "top_device_ms_per_tick": {k[:60]: us / 1e3 / ticks for k, us, _ in top},
        # the transport kernels' own device time per launch on this path
        "transport_kernel_ms": {k.split("(")[0]: us / 1e3 / calls for k, us, calls in rows
                                if k.startswith(TRANSPORT_KERNELS)},
    }


def profile_twin(n, wall_ms_per_tick, ticks=64, **kw) -> dict:
    """``device_profile`` of sustained@n at phase 4's parameters over its
    first ``ticks`` ticks, through a twin of that chunk (``kw``:
    ``program``'s planes, faults and mesh) after a warm-up run that builds
    its constants. A run stops at whole chunks, and a profiled tick costs
    the host ~0.1 s: profiling a chunk-250 program's first 64 ticks
    profiles 250."""
    twin = program("pingpong-sustained", n, SUSTAINED, chunk=ticks, **kw)
    twin.run(seed=0, max_ticks=ticks)
    return device_profile(twin, ticks=ticks, wall_ms_per_tick=wall_ms_per_tick)


def phase_pingpong(card) -> dict:
    n = 100_000
    params = {"latency_ms": "100", "latency2_ms": "10", "tolerance_ms": "15"}
    prog = program("ping-pong", n, params, chunk=64)
    res, wall, ticks, carry = run_timed(prog, max_ticks=4096)
    launches = read_launches()
    check(bool((res["status"] == 1).all()), "ping-pong: not every instance SUCCESS")
    check(all(v > 0 for v in launches.values()), f"ping-pong: launches {launches}")
    check(conserved(res), f"ping-pong: flow conservation {flows(res)}")
    cal_bytes = sum(p.numel() * p.element_size() for p in _planes(carry.cal))
    return {
        "phase": "pingpong", "n": n, "ticks": ticks, "results_ticks": res["ticks"],
        "wall_s": wall, "peer_ticks_per_s": n * ticks / wall,
        "launches": launches, "calendar_bytes": cal_bytes,
        "rtt1_ticks": sorted(set(res["states"][0]["rtt1"].tolist()))[:4],
        "rtt2_ticks": sorted(set(res["states"][0]["rtt2"].tolist()))[:4],
        "card": card,
    }


def phase_flood(card) -> dict:
    """bench.py's flood (``bench.py:70-77``): direct slots, so K2 is the
    only kernel on its path."""
    n = 100_000
    params = {"duration_ticks": "500", "latency_ms": "4"}
    prog = program("pingpong-flood", n, params, chunk=500, plan="benchmarks")
    res, wall, ticks, carry = run_timed(prog, max_ticks=10_000)
    launches = read_launches()
    metrics = prog.tc.collect_metrics(prog.groups[0], res["states"][0], res["status"])
    check(bool((res["status"] == 1).all()), "flood: not every instance SUCCESS")
    check(launches["pop_bucket"] > 0, f"flood: launches {launches}")
    check(conserved(res), f"flood: flow conservation {flows(res)}")
    check(int(metrics["flood.rounds"].min()) > 0, "flood: an instance made no round")
    return {
        "phase": "flood", "n": n, "ticks": ticks, "results_ticks": res["ticks"],
        "wall_s": wall, "wall_ms_per_tick": wall / ticks * 1e3,
        "peer_ticks_per_s": n * ticks / wall, "launches": launches,
        "flows": flows(res), "rounds_min": int(metrics["flood.rounds"].min()),
        "calendar_bytes": sum(p.numel() * p.element_size() for p in _planes(carry.cal)),
        # a chunk-64 twin's first 64 ticks (the chunk-500 program's
        # profile covered 500)
        **device_profile(_flood_twin(n, params), ticks=64,
                         wall_ms_per_tick=wall / ticks * 1e3),
        "card": card,
    }


def _flood_twin(n, params):
    twin = program("pingpong-flood", n, params, chunk=64, plan="benchmarks")
    twin.run(seed=0, max_ticks=64)
    return twin


def phase_storm(card) -> dict:
    """bench.py's storm (``bench.py:78-87``) to all SUCCESS: OUT_MSGS=5,
    SLOTS=16, bool occupancy, no stacking; the profile covers its first
    128 ticks, about 94 of them flooding."""
    n = 100_000
    params = {"conn_outgoing": "5", "conn_delay_ticks": "32", "data_size_kb": "512"}
    prog = program("storm", n, params, chunk=64, plan="benchmarks")
    res, wall, ticks, carry = run_timed(prog, max_ticks=4096)
    launches = read_launches()
    metrics = prog.tc.collect_metrics(prog.groups[0], res["states"][0], res["status"])
    check(bool((res["status"] == 1).all()), "storm: not every instance SUCCESS")
    check(all(v > 0 for v in launches.values()), f"storm: launches {launches}")
    check(conserved(res), f"storm: flow conservation {flows(res)}")
    check(int(metrics["storm.bytes_read"].sum()) > 0, "storm: no bytes read")
    return {
        "phase": "storm", "n": n, "ticks": ticks, "results_ticks": res["ticks"],
        "wall_s": wall, "wall_ms_per_tick": wall / ticks * 1e3,
        "peer_ticks_per_s": n * ticks / wall, "launches": launches,
        "flows": flows(res),
        "bytes_read_sum": int(metrics["storm.bytes_read"].sum()),
        "bytes_sent_sum": int(metrics["storm.bytes_sent"].sum()),
        "calendar_bytes": sum(p.numel() * p.element_size() for p in _planes(carry.cal)),
        **device_profile(prog, ticks=128, wall_ms_per_tick=wall / ticks * 1e3),
        "card": card,
    }


def phase_benchmarks(card) -> dict:
    """The other five benchmarks cases at 100k, each to all SUCCESS;
    netlinkshape also holds every pair's one-way delay to its shaped
    250 ms (the plan fails an instance otherwise)."""
    n = 100_000
    runs, launches = {}, {"commit_calendar": 0, "pop_bucket": 0}
    for case in BENCH_OTHERS:
        prog = program(case, n, {}, chunk=64, plan="benchmarks")
        res, wall, ticks, _ = run_timed(prog, max_ticks=4096)
        got = read_launches()
        check(bool((res["status"] == 1).all()), f"{case}: not every instance SUCCESS")
        check(got["pop_bucket"] > 0, f"{case}: launches {got}")
        check(conserved(res), f"{case}: flow conservation {flows(res)}")
        for k, v in got.items():
            launches[k] += v
        runs[case] = {"ticks": ticks, "wall_s": wall, "launches": got,
                      "msgs_sent": res["msgs_sent"]}
    return {"phase": "benchmarks", "n": n, "runs": runs, "launches": launches,
            "card": card}


def phase_scale(card) -> dict:
    n = 1_000_000
    prog = program("pingpong-sustained", n, {"duration_ticks": "10000"}, chunk=64)
    # the run's own peak: the kernel cases stay allocated until the device pass
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    res, wall, ticks, _ = run_timed(prog, max_ticks=64)
    launches = read_launches()
    check(ticks == 64, f"scale: ran {ticks} ticks")
    check(conserved(res), f"scale: flow conservation {flows(res)}")
    return {
        "phase": "scale", "n": n, "ticks": ticks, "wall_s": wall,
        "peer_ticks_per_s": n * ticks / wall, "launches": launches,
        "max_memory_allocated": torch.cuda.max_memory_allocated() - held,
        "card": card,
    }


def phase_faults(card) -> dict:
    """The slice's full-width path: sustained@100k under a schedule of
    every fault kind, beside the same run without one. Both runs are
    timed on the wall clock first, then profiled over the first ticks of a
    chunk-64 twin: the faulted one over 128 (its crash and purge at tick
    100 inside), the unfaulted one over 64
    (``profile_twin``)."""
    n = 100_000
    runs, progs, launches = {}, {}, {"commit_calendar": 0, "pop_bucket": 0}
    for label, tables in (("unfaulted", None), ("faulted", sustained_fault_tables(n))):
        prog = program("pingpong-sustained", n, SUSTAINED, chunk=250,
                       fault_tables=tables)
        res, wall, ticks, _ = run_timed(prog, max_ticks=10_000)
        got = read_launches()
        for k, v in got.items():
            launches[k] += v
        check(bool((res["status"] == 1).all()), f"faults {label}: not all SUCCESS")
        check(all(v > 0 for v in got.values()), f"faults {label}: launches {got}")
        check(conserved(res), f"faults {label}: flow totals {flows(res)}")
        progs[label] = prog
        runs[label] = {
            "ticks": ticks, "wall_s": wall, "wall_ms_per_tick": wall / ticks * 1e3,
            "peer_ticks_per_s": n * ticks / wall, "launches": got, "flows": flows(res),
            "faults_crashed": res["faults_crashed"],
            "faults_restarted": res["faults_restarted"],
            "fault_dropped": res["fault_dropped"],
        }
    twin = program("pingpong-sustained", n, SUSTAINED, chunk=64,
                   fault_tables=sustained_fault_tables(n))
    twin.run(seed=0, max_ticks=64)
    runs["faulted"].update(device_profile(twin, ticks=128,
                                          wall_ms_per_tick=runs["faulted"]["wall_ms_per_tick"]))
    del twin
    runs["unfaulted"].update(profile_twin(n, runs["unfaulted"]["wall_ms_per_tick"]))
    f = runs["faulted"]
    f["purge"] = purge_timing(n, f["device_ms_per_tick"])
    check(f["faults_crashed"] == n // 10 and f["faults_restarted"] == n // 10,
          f"faults: crashed {f['faults_crashed']}, restarted {f['faults_restarted']}")
    check(f["fault_dropped"] > 0, "faults: nothing fault-dropped")
    check(runs["unfaulted"]["fault_dropped"] == 0, "faults: unfaulted run fault-dropped")
    return {"phase": "faults", "n": n, "schedule": sustained_fault_tables(n)[""],
            "runs": runs, "launches": launches, "card": card}


# the mesh phase: peer shards of its virtual mesh on card 0, and turns of
# the meshed and unmeshed sustained@100k it times
MESH_SHARDS = 4
# one turn (three once, then two), for the script's time limit
MESH_TURNS = 1


def phase_mesh(card) -> dict:
    """The mesh path at full width: sustained@100k at phase 4's parameters
    on a 4-shard virtual mesh on card 0, in turns with the same run
    unmeshed (wall ms/tick of each turn), both to all SUCCESS with exact
    flow conservation and every carry leaf equal; the meshed run launches
    each sharded kernel once a tick and the unsharded ones never. Then
    device ms/tick, kernels a tick and busy share of both (over a chunk-32
    twin's first 32 ticks), sync-debug counts of the meshed run at 32 and
    64 ticks (chunk 16: no sync a tick), ping-pong@100k and flood@100k
    (direct slots) on the mesh to all SUCCESS, and step ``parts``
    (:func:`mesh_parts_step`)."""
    from testground_tpu_torch.sim.carry_io import carry_to_numpy

    n = 100_000
    progs = {"unmeshed": program("pingpong-sustained", n, SUSTAINED, chunk=250),
             "mesh": program("pingpong-sustained", n, SUSTAINED, chunk=250,
                             mesh=MESH_SHARDS)}
    launches = dict.fromkeys(KERNELS + SHARDED_KERNELS, 0)
    walls = {k: [] for k in progs}
    runs, carries = {}, {}
    for turn in range(MESH_TURNS):
        order = ("unmeshed", "mesh") if turn % 2 == 0 else ("mesh", "unmeshed")
        for label in order:
            res, wall, ticks, carry = run_timed(progs[label], max_ticks=10_000)
            got = read_launches(KERNELS + SHARDED_KERNELS)
            for k, v in got.items():
                launches[k] += v
            check(bool((res["status"] == 1).all()), f"mesh {label}: not all SUCCESS")
            check(conserved(res), f"mesh {label}: flow conservation {flows(res)}")
            if label == "mesh":
                check(got["commit_calendar_sharded"] == got["pop_bucket_sharded"] == ticks
                      and got["commit_calendar"] == got["pop_bucket"] == 0,
                      f"mesh: launches {got} over {ticks} ticks")
            else:
                check(got["commit_calendar"] > 0 and got["pop_bucket"] > 0,
                      f"mesh unmeshed: launches {got}")
            walls[label].append(wall / ticks * 1e3)
            if turn == 0:
                carries[label] = carry_to_numpy(carry)
                runs[label] = {"ticks": ticks, "launches": got, "flows": flows(res),
                               "carry_bytes": res["carry_bytes"],
                               "digest": progs[label].carry_digest(carry),
                               "device_bytes": progs[label].part_bytes(carry)[0]}
    um, me = carries["unmeshed"], carries["mesh"]
    diff = [k for k in um if not np.array_equal(um[k], me[k])]
    check(not diff, f"mesh: carry leaves differ from the unmeshed run: {diff}")
    check(runs["mesh"]["carry_bytes"] == runs["unmeshed"]["carry_bytes"],
          "mesh: footprint differs from the unmeshed one")
    for label, row in runs.items():
        row["wall_ms_per_tick"] = walls[label]
        row["wall_ms_per_tick_median"] = statistics.median(walls[label])
        row["peer_ticks_per_s"] = n * 1e3 / row["wall_ms_per_tick_median"]
        # a chunk-32 twin: a run stops at whole chunks (the chunk-250
        # programs' profiles covered 250 ticks)
        row.update(profile_twin(n, row["wall_ms_per_tick_median"], ticks=32,
                                **({"mesh": MESH_SHARDS} if label == "mesh" else {})))
    twin = program("pingpong-sustained", n, SUSTAINED, chunk=16, mesh=MESH_SHARDS)
    twin.run(seed=0, max_ticks=16)  # its first step builds the plan's constants
    sites: dict = {}
    runs["mesh"]["host_syncs"] = {k: host_syncs(twin, k, sites if k == 64 else None)
                                  for k in (32, 64)}
    check(runs["mesh"]["host_syncs"][32] == runs["mesh"]["host_syncs"][64],
          f"mesh: a host sync a tick {runs['mesh']['host_syncs']} at {sites}")
    others = {}
    for name, (case, plan, params, chunk) in {
        "pingpong": ("ping-pong", "network",
                     {"latency_ms": "100", "latency2_ms": "10", "tolerance_ms": "15"}, 64),
        "flood": ("pingpong-flood", "benchmarks",
                  {"duration_ticks": "500", "latency_ms": "4"}, 500),
    }.items():
        prog = program(case, n, params, chunk=chunk, plan=plan, mesh=MESH_SHARDS)
        res, wall, ticks, _ = run_timed(prog, max_ticks=10_000)
        got = read_launches(KERNELS + SHARDED_KERNELS)
        for k, v in got.items():
            launches[k] += v
        check(bool((res["status"] == 1).all()), f"mesh {name}: not all SUCCESS")
        check(conserved(res), f"mesh {name}: flow conservation {flows(res)}")
        check(got["pop_bucket_sharded"] == ticks and got["pop_bucket"] == 0,
              f"mesh {name}: launches {got} over {ticks} ticks")
        others[name] = {"ticks": ticks, "wall_s": wall,
                        "wall_ms_per_tick": wall / ticks * 1e3,
                        "peer_ticks_per_s": n * ticks / wall, "launches": got,
                        "flows": flows(res)}
    parts = mesh_parts_step(runs)
    for k, v in parts.pop("launches").items():
        launches[k] += v
    return {"phase": "mesh", "n": n, "shards": MESH_SHARDS, "turns": MESH_TURNS,
            "runs": runs, "others": others, "parts": parts, "launches": launches,
            "card": card}


# step ``parts`` of phase mesh: (instances, max ticks, chunk) of sustained;
# at 100k the run goes to completion, as the phase's own turns do
PARTS_RUNS = ((100_000, 10_000, 250), (1_000_000, 64, 64))


def mesh_parts_step(phase_runs: dict) -> dict:
    """Phase mesh's step ``parts``: sustained at phase 4's parameters at
    each of :data:`PARTS_RUNS` on card 0 three ways: unmeshed, on the
    4-shard mesh of one part, and on the same mesh cut into 4 explicit
    parts, each part holding and stepping its own lanes (one thread a
    part). At 100k the first two are the phase's own turn-0 runs
    (``phase_runs``), so only the parts run is made there. The three carry
    digests are equal; each part's carry bytes are the replicated bytes
    plus the placed bytes ÷ 4 (the prediction, held exactly), whose sum is
    the run alone's; the card's peak allocated bytes during each run made
    here, less what the process held before it (the program's build
    included); wall ms a tick; each part pops once a tick and commits on the
    ticks that bring its lanes messages. At 100k a chunk-16 twin of the
    parts run gives its kernels and device ms a tick over 16 ticks."""
    from testground_tpu_torch.sim.checkpoint import _source, leaf_paths

    launches = dict.fromkeys(KERNELS + SHARDED_KERNELS, 0)
    ways = {"unmeshed": {}, "one-part": {"mesh": MESH_SHARDS},
            "parts": {"mesh": MESH_SHARDS, "parts": (1, 2, 3)}}
    out = {}
    for n, max_ticks, chunk in PARTS_RUNS:
        row = {}
        if n == PARTS_RUNS[0][0]:
            for label, key in (("unmeshed", "unmeshed"), ("one-part", "mesh")):
                got = phase_runs[key]
                row[label] = {"ticks": got["ticks"], "digest": got["digest"],
                              "carry_bytes": [got["device_bytes"]],
                              "wall_ms_per_tick": got["wall_ms_per_tick"][0]}
        for label, kw in ways.items():
            if label in row:
                continue
            prog = program("pingpong-sustained", n, SUSTAINED, chunk=chunk, **kw)
            check(prog.parted == (label == "parts"), f"mesh parts: {label} parted")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            # the bytes the process held before the run (the program's own
            # build included) are not the run's
            held = torch.cuda.memory_allocated()
            res, wall, ticks, carry = run_timed(prog, max_ticks=max_ticks)
            got = read_launches(KERNELS + SHARDED_KERNELS)
            for k, v in got.items():
                launches[k] += v
            check(conserved(res), f"mesh parts {label}@{n}: flow conservation {flows(res)}")
            row[label] = {"ticks": ticks, "wall_ms_per_tick": wall / ticks * 1e3,
                          "peak_bytes": torch.cuda.max_memory_allocated() - held,
                          "carry_bytes": prog.part_bytes(carry), "launches": got,
                          "flows": flows(res), "digest": prog.carry_digest(carry)}
            if label == "parts":
                # each part pops its rows every tick and commits on the
                # ticks that bring its own lanes messages
                check(got["pop_bucket_sharded"] == MESH_SHARDS * ticks
                      and 0 < got["commit_calendar_sharded"] <= got["pop_bucket_sharded"]
                      and got["commit_calendar"] == got["pop_bucket"] == 0,
                      f"mesh parts@{n}: launches {got} over {ticks} ticks")
                placed = replicated = 0
                for c in carry.parts:
                    for path in leaf_paths(c):
                        x = _source(c, path)
                        if path.startswith("cal."):
                            placed += sum(p.numel() * p.element_size() for p in x)
                        elif isinstance(x, torch.Tensor) and _placed(path):
                            placed += x.numel() * x.element_size()
                        elif isinstance(x, torch.Tensor) and c is carry.parts[0]:
                            replicated += x.numel() * x.element_size()
                row["placed_bytes"], row["replicated_bytes"] = placed, replicated
                row["predicted_part_bytes"] = replicated + placed // MESH_SHARDS
                check(row[label]["carry_bytes"] == [row["predicted_part_bytes"]] * MESH_SHARDS,
                      f"mesh parts@{n}: part bytes {row[label]['carry_bytes']}, predicted "
                      f"{row['predicted_part_bytes']}")
                if n == PARTS_RUNS[0][0]:
                    # 16 ticks: a profiled tick of four parts costs the host
                    # ~4× a tick of one
                    prof = profile_twin(n, row[label]["wall_ms_per_tick"], ticks=16, **kw)
                    row[label]["kernels_per_tick"] = prof["kernels_per_tick"]
                    row[label]["device_ms_per_tick"] = prof["device_ms_per_tick"]
            del prog, carry, res
        digests = {label: r["digest"] for label, r in row.items() if label in ways}
        check(len(set(digests.values())) == 1, f"mesh parts@{n}: carry digests {digests}")
        check(row["placed_bytes"] + row["replicated_bytes"] == row["unmeshed"]["carry_bytes"][0],
              f"mesh parts@{n}: placed + replicated != the run alone's carry bytes")
        print(f"chip_smoke mesh parts@{n}: digest {digests['parts']} (one-part and unmeshed "
              f"equal), part bytes {row['parts']['carry_bytes']} against "
              f"{row['unmeshed']['carry_bytes'][0]} alone (predicted "
              f"{row['predicted_part_bytes']}), peak {row['parts']['peak_bytes']} B, "
              f"{row['parts']['wall_ms_per_tick']:.3f} ms/tick against "
              f"{row['one-part']['wall_ms_per_tick']:.3f} on one part", flush=True)
        out[str(n)] = row
    out["launches"] = launches
    return out


def _placed(path: str) -> bool:
    """Whether a several-part program places the carry leaf at ``path``
    (``MeshPlan.lane_axis``)."""
    from testground_tpu_torch.sim.meshplan import MeshPlan

    return MeshPlan(None).lane_axis(path) is not None


# the telemetry phase's four ways to run sustained@100k, and how many
# turns of the four it times: host speed drifts within a call by more
# than a plane's wall cost, so pairs against the planes-off run (six
# once, then three, then two, now one: every phase that timed turns times
# one but `observe`, whose verbs compare two runs, so that the script stays
# inside its time limit on a slow host)
TURNS = 1
PLANE_SETS = {
    "off": {},
    "telemetry": {"telemetry": True},
    "telemetry+matrix": {"telemetry": True, "netmatrix": True},
    "telemetry+matrix+trace": {"telemetry": True, "netmatrix": True, "trace": "0:64"},
}


def record_planes(prog, **kw):
    """``prog.run`` with every plane callback recording; returns
    ``(results, {"tele", "lat", "nm", "trace"}: per-chunk arrays, last
    carry)``."""
    rec = {k: [] for k in ("tele", "lat", "nm", "trace")}
    last = {}
    res = prog.run(telemetry_cb=rec["tele"].append, lat_hist_cb=rec["lat"].append,
                   netmatrix_cb=rec["nm"].append, trace_cb=rec["trace"].append,
                   observer=lambda k, c: last.__setitem__("carry", c), **kw)
    return res, rec, last["carry"]


def run_planes(prog, max_ticks):
    """``run_timed`` with the planes' callbacks recording, and the host's
    waits on CUDA events counted (the done flag's, once a tick)."""
    reset_launches()
    waits = [0]
    real = torch.cuda.Event.synchronize

    def counted(self):
        waits[0] += 1
        return real(self)

    torch.cuda.Event.synchronize = counted
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res, rec, carry = record_planes(prog, seed=0, max_ticks=max_ticks)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        torch.cuda.Event.synchronize = real
    return res, wall, int(carry.t), rec, waits[0]


def check_planes(label, prog, res, rec) -> dict:
    """The planes' own invariants on one run: the counter rows sum to the
    flow totals, the latency histogram to the messages delivered (no host
    lanes here), the matrix reconciles with the flow totals, the trace
    events decode onto the traced lanes."""
    from testground_tpu_torch.sim import netmatrix as nm
    from testground_tpu_torch.sim import telemetry as tele
    from testground_tpu_torch.sim import trace as tr

    out = {}
    if prog.telemetry:
        rows = tele.rows_from_blocks(rec["tele"], tuple(g.id for g in prog.groups))
        totals = tele.telemetry_totals(rows)
        want = {"delivered": res["msgs_delivered"], "sent": res["msgs_sent"],
                "enqueued": res["msgs_enqueued"], "dropped": res["msgs_dropped"],
                "rejected": res["msgs_rejected"], "fault_dropped": res["fault_dropped"]}
        check(totals == want, f"{label}: counter rows {totals} != flow totals {want}")
        hist = np.asarray(res["lat_hist"])
        check(int(hist.sum()) == res["msgs_delivered"],
              f"{label}: histogram {int(hist.sum())} != delivered {res['msgs_delivered']}")
        out.update(rows=len(rows), lat_hist=hist.tolist(),
                   latency=tele.latency_percentiles(hist.sum(axis=0), prog.tick_ms))
    if prog.netmatrix:
        mat = np.asarray(res["net_matrix"])
        mism = nm.reconcile(mat, res)
        check(not mism, f"{label}: matrix does not reconcile: {mism}")
        out["matrix_totals"] = nm.matrix_totals(mat)
    if prog.trace is not None:
        events = tr.events_from_blocks(rec["trace"], lambda i: prog.groups[0].id)
        lanes = set(prog.trace.lanes.tolist())
        check(events and {e["instance"] for e in events} <= lanes,
              f"{label}: trace events do not decode onto the traced lanes")
        kinds = {}
        for e in events:
            kinds[e["event"]] = kinds.get(e["event"], 0) + 1
        check({"send", "deliver"} <= set(kinds), f"{label}: trace kinds {kinds}")
        out["trace_events"] = kinds
    return out


def phase_telemetry(card) -> dict:
    """The observability planes on the full-width main path: sustained@100k
    at phase 4's parameters four ways, timed in TURNS turns (each way once
    a turn, every other turn in reverse order; each way's wall ms/tick
    against the planes-off run of the same turn gives its paired deltas),
    then profiled over the first 32 ticks of a chunk-32 twin each
    (``profile_twin``);
    the sync-debug counts at 32 and 64 ticks use chunk-16 twins, so that
    both runs span chunk boundaries. Then the faulted sustained of phase
    ``faults`` with telemetry and the matrix."""
    from testground_tpu_torch.sim import netmatrix as nm

    n = 100_000
    progs = {k: program("pingpong-sustained", n, SUSTAINED, chunk=250, **kw)
             for k, kw in PLANE_SETS.items()}
    runs = {k: {"wall_ms_per_tick": []} for k in PLANE_SETS}
    launches = {"commit_calendar": 0, "pop_bucket": 0}
    order = list(PLANE_SETS)
    for label in [k for i in range(TURNS) for k in (order if i % 2 == 0 else order[::-1])]:
        prog = progs[label]
        res, wall, ticks, rec, waits = run_planes(prog, 10_000)
        got = read_launches()
        for k, v in got.items():
            launches[k] += v
        check(bool((res["status"] == 1).all()), f"telemetry {label}: not all SUCCESS")
        check(all(v > 0 for v in got.values()), f"telemetry {label}: launches {got}")
        check(conserved(res), f"telemetry {label}: flow totals {flows(res)}")
        row = runs[label]
        row["wall_ms_per_tick"].append(wall / ticks * 1e3)
        row.update(ticks=ticks, launches=got, flows=flows(res), host_event_waits=waits,
                   **check_planes(f"telemetry {label}", prog, res, rec))
    off_walls = runs["off"]["wall_ms_per_tick"]
    q1, _, q3 = (statistics.quantiles(off_walls, n=4) if len(off_walls) > 1
                 else off_walls * 3)
    for label, row in runs.items():
        walls = row["wall_ms_per_tick"]
        wall_ms = statistics.median(walls)
        deltas = [w - o for w, o in zip(walls, off_walls)]
        diff = wall_ms - statistics.median(off_walls)
        # a wall cost is resolved only past the planes-off runs' own spread
        # (the distance between their quartiles)
        row.update(wall_ms_median=wall_ms, wall_ms_range=[min(walls), max(walls)],
                   wall_ms_delta_vs_off=deltas,
                   wall_ms_delta_median=statistics.median(deltas),
                   wall_ms_vs_off=diff, off_iqr_ms=q3 - q1,
                   wall_resolved=abs(diff) > q3 - q1,
                   turns_slower_than_off=sum(d > 0 for d in deltas))
        row.update(profile_twin(n, wall_ms, ticks=32, **PLANE_SETS[label]))
        twin = program("pingpong-sustained", n, SUSTAINED, chunk=16, **PLANE_SETS[label])
        # one warm-up run: a program's first step builds its constants
        twin.run(seed=0, max_ticks=16)
        sites = {32: {}, 64: {}}
        row["host_syncs"] = {k: host_syncs(twin, k, sites[k]) for k in (32, 64)}
        # the lines whose syncs grow with the ticks run: per tick
        row["sync_sites_per_tick"] = {
            key: (sites[64][key] - sites[32].get(key, 0)) / 32
            for key in sites[64] if sites[64][key] != sites[32].get(key, 0)
        }
    off = runs["off"]
    for label, row in runs.items():
        # no sync a tick, planes off or on: 32 more ticks add none
        growth = row["host_syncs"][64] - row["host_syncs"][32]
        check(growth == 0, f"telemetry {label}: {growth} syncs over 32 more ticks")
        check(row["host_event_waits"] <= row["ticks"] + 1,
              f"telemetry {label}: {row['host_event_waits']} waits in {row['ticks']} ticks")
    check(off["host_event_waits"] == off["ticks"], f"telemetry off: {off['host_event_waits']}")

    # the faulted run: the crash purge in the fault cells
    prog = program("pingpong-sustained", n, SUSTAINED, chunk=250,
                   fault_tables=sustained_fault_tables(n), telemetry=True, netmatrix=True)
    res, wall, ticks, rec, waits = run_planes(prog, 10_000)
    got = read_launches()
    for k, v in got.items():
        launches[k] += v
    check(bool((res["status"] == 1).all()), "telemetry faulted: not all SUCCESS")
    planes = check_planes("telemetry faulted", prog, res, rec)
    from testground_tpu_torch.sim import telemetry as tele

    rows = tele.rows_from_blocks(rec["tele"], ("all",))
    crash = [i for i, r in enumerate(rows) if r["faults_crashed"] > 0]
    check(len(crash) == 1 and crash[0] > 0, f"telemetry faulted: crash rows {crash}")
    r, prev = rows[crash[0]], rows[crash[0] - 1]
    purged = prev["cal_depth"] + r["enqueued"] - r["delivered"] - r["cal_depth"]
    fault_cells = np.asarray(res["net_matrix"])[nm.NM_FAULT]
    check(purged > 0 and r["fault_dropped"] >= purged,
          f"telemetry faulted: purge {purged}, tick's fault_dropped {r['fault_dropped']}")
    check(int(fault_cells.sum()) == res["fault_dropped"],
          f"telemetry faulted: fault cells {fault_cells.tolist()}")
    faulted = {"ticks": ticks, "wall_s": wall, "wall_ms_per_tick": wall / ticks * 1e3,
               "launches": got, "flows": flows(res), "host_event_waits": waits,
               "crash_tick": r["tick"], "purged": purged,
               "crash_tick_fault_dropped": r["fault_dropped"],
               "fault_cells": fault_cells.tolist(), **planes}
    return {"phase": "telemetry", "n": n, "runs": runs, "faulted": faulted,
            "launches": launches, "card": card}


def purge_timing(n, device_ms_per_tick) -> dict:
    """``purge_dst`` at the faults phase's crash: sustained's calendar (L=8,
    SLOTS=4, int32 occupancy, a fifth full) and a tenth of the lanes
    crashing. Device ms per call (CUDA events), and its share of a crash
    tick's device time (the mean faulted tick plus the purge)."""
    from testground_tpu_torch.sim import net

    dev = torch.device("cuda")
    rng = np.random.default_rng(21)
    cal0 = _calendar(net, 8, n, 4, 1, False, False, rng, dev)
    mask = torch.zeros(n, dtype=torch.bool, device=dev)
    mask[: n // 10] = True
    work = _clone_cal(net, cal0)
    ms = time_ms(lambda: net.purge_dst(work, mask),
                 lambda: work.src.copy_(cal0.src))
    return {"ms": ms, "share_of_crash_tick": (
        ms / (device_ms_per_tick + ms) if device_ms_per_tick else None)}


# (plan, case, n, params, max_ticks, chunk, options, expected status)
# the sweep plans take ~n ticks by design: 256 instances (1,024 once),
# part of the cut that pays for phase cohort's time
SWEEP_N = 256
PLAN_RUNS = {
    **{f"placebo/{c}": ("placebo", c, 100_000, {}, 64, 64, {}, want)
       for c, want in (("ok", 1), ("abort", 2), ("panic", 3), ("stall", 0),
                       ("silent", 0), ("optional-failure", 1), ("metrics", 1))},
    # pings cut from 8 to 2: each pinger pings once every n ticks
    **{f"verify/{c}": ("verify", c, SWEEP_N, {"pings": "2"}, 8192, 256, {}, 1)
       for c in ("uses-data-network", "uses-data-network-drop")},
    **{f"splitbrain/{c}": ("splitbrain", c, SWEEP_N, {}, 8192, 256, {}, 1)
       for c in ("accept", "drop", "reject")},
    **{f"additional_hosts/{c}": ("additional_hosts", c, SWEEP_N, {}, 8192, 256,
                                 {"hosts": ("http-echo",)}, 1)
       for c in ("additional_hosts", "additional_hosts_drop")},
    "chaos/chaos-barrier": ("chaos", "chaos-barrier", SWEEP_N, chaos_setup(SWEEP_N)[0],
                            8192, 256, {"fault_tables": chaos_setup(SWEEP_N)[1]}, 1),
}


def phase_plans(card) -> dict:
    """Every plan the slice adds, through the library entry points, to its
    expected terminal status on every instance."""
    runs, launches = {}, {"commit_calendar": 0, "pop_bucket": 0}
    for label, (plan, case, n, params, max_ticks, chunk, opts, want) in PLAN_RUNS.items():
        prog = program(case, n, params, chunk=chunk, plan=plan, **opts)
        res, wall, ticks, _ = run_timed(prog, max_ticks=max_ticks)
        got = read_launches()
        for k, v in got.items():
            launches[k] += v
        status = np.bincount(res["status"], minlength=4).tolist()
        check(status[want] == n, f"plans {label}: status counts {status}, want {want}")
        check(got["pop_bucket"] > 0, f"plans {label}: launches {got}")
        check(conserved(res), f"plans {label}: flow totals {flows(res)}")
        row = {"n": n, "ticks": ticks, "wall_s": wall, "status_counts": status,
               "launches": got, "flows": flows(res)}
        if hasattr(prog.tc, "collect_metrics"):
            m = prog.tc.collect_metrics(prog.groups[0], res["states"][0], res["status"])
            row["metrics_sum"] = {k: int(np.asarray(v).sum()) for k, v in m.items()}
        if plan == "chaos":
            check(res["faults_crashed"] == n // 4 and res["faults_restarted"] == n // 4,
                  f"plans chaos: {res['faults_crashed']} crashed")
            check(res["fault_dropped"] > 0, "plans chaos: nothing fault-dropped")
            row.update(params=params, faults=opts["fault_tables"]["all"],
                       faults_crashed=res["faults_crashed"],
                       faults_restarted=res["faults_restarted"],
                       note="heal_tick and deadline raised by n past the n-1 tick "
                            "probe sweep; slow_tick kept at 30")
        if plan == "placebo" and case == "metrics":
            check(row["metrics_sum"]["placebo.counter"] == 10 * n, "placebo metrics")
        runs[label] = row
    return {"phase": "plans", "runs": runs, "launches": launches, "card": card}


def _enqueue_inputs(rng, n, o, w, L, slots, occ_bool=False):
    """A pre-filled calendar, a link state with every shaping knob at
    nonzero rates (three filter regions, an HTB backlog, two range rules a
    sender) and one tick's outbox, from a numpy seed."""
    ns = n * slots
    occ = np.where(rng.random((L, ns)) < 0.2, rng.integers(1, n + 1, (L, ns)), 0)
    egress = np.stack([
        rng.uniform(1, 9, n), rng.uniform(0, 5, n),
        np.where(rng.random(n) < 0.5, 0.0, rng.uniform(0, 8e5, n)),
        rng.uniform(0, 30, n), rng.uniform(0, 30, n), rng.uniform(0, 30, n),
        rng.uniform(0, 60, n),
    ]).astype(np.float32)
    start = rng.integers(0, n, (2, n))
    rules = np.stack([start, start + rng.integers(-1, 64, (2, n)),
                      rng.integers(0, 3, (2, n))], axis=1)
    return dict(
        occ=(occ != 0) if occ_bool else occ.astype(np.int32),
        pays=[rng.integers(0, 1000, (L, ns)).astype(np.int32) for _ in range(w)],
        egress=egress,
        filters=rng.integers(0, 3, (3, n)).astype(np.int32),
        region_of=rng.integers(0, 3, n).astype(np.int32),
        backlog=np.where(rng.random(n) < 0.5, 0.0, rng.uniform(0, 6, n)).astype(np.float32),
        rules=rules.astype(np.int32),
        dst=rng.integers(-2, n + 2, (o, n)).astype(np.int32),
        payload=rng.integers(0, 2**31, (o, w, n)).astype(np.int32),
        valid=rng.random((o, n)) < 0.8,
        slots=slots, occ_bool=occ_bool,
    )


def _enqueue_on(x, device, features, **kw):
    """One ``net.enqueue`` of ``x`` on ``device``; returns the calendar's
    planes and every feedback field, on the host."""
    from testground_tpu_torch.sim import net

    def d(a):
        return torch.from_numpy(np.array(a)).to(device)

    occ = d(x["occ"])
    cal = net.Calendar(payload=tuple(d(p) for p in x["pays"]),
                       src=None if x["occ_bool"] else occ,
                       valid=occ if x["occ_bool"] else None, slots=x["slots"])
    link = net.LinkState(egress=d(x["egress"]), filters=d(x["filters"]),
                         region_of=d(x["region_of"]), backlog=d(x["backlog"]),
                         rules=d(x["rules"]))
    t = torch.tensor(21, dtype=torch.int32, device=device)
    if "dead" in x:
        kw = dict(kw, dead=d(x["dead"]))
    cal, fb = net.enqueue(cal, link, d(x["dst"]), d(x["payload"]), d(x["valid"]), t,
                          1.0, (12345, 678910), features=features, **kw)
    fields = [fb.rejected, fb.clamped, fb.bw_dropped, fb.collisions,
              fb.collision_where, fb.sent, fb.enqueued, fb.backlog, fb.fault_dropped,
              fb.fate]
    return [p.cpu() for p in _planes(cal)], [None if f is None else f.cpu() for f in fields]


def _control_lane_inputs(n, hosts):
    """Control lanes past ``n - hosts`` whose echo rows (the 1-tick floor)
    share buckets and destinations with plan rows shaped to one tick (and
    reordered to it), onto a pre-filled calendar; a dead mask; and a
    schedule with a window of every send-time kind open at tick 21."""
    from testground_tpu_torch.api import RunGroup
    from testground_tpu_torch.sim.engine import build_groups
    from testground_tpu_torch.sim.faults import build_fault_schedule

    rng = np.random.default_rng(14)
    x = _enqueue_inputs(rng, n, o=4, w=2, L=8, slots=4)
    inst = n - hosts
    x["egress"][0] = rng.uniform(0.1, 1.0, n)  # one tick
    x["egress"][1] = 0.0  # no jitter
    x["dst"] = rng.integers(0, inst // 8, (4, n)).astype(np.int32)  # fan-in
    x["dst"][:, ::7] = inst + rng.integers(0, hosts, (4, n))[:, ::7]  # to the hosts
    x["dead"] = np.concatenate([rng.random(inst) < 0.05, np.zeros(hosts, bool)])
    q = inst // 10
    groups = build_groups([RunGroup(id="all", instances=inst)])
    faults = build_fault_schedule(groups, {"": [
        {"kind": "partition", "start_ms": 20, "duration_ms": 5, "instances": f"0:{3 * q}",
         "to_instances": f"{3 * q}:{6 * q}"},
        {"kind": "link_flap", "start_ms": 18, "duration_ms": 8, "period_ms": 4,
         "duty": 0.25, "instances": f"{6 * q}:{7 * q}"},
        {"kind": "latency_spike", "start_ms": 20, "duration_ms": 4, "latency_ms": 0.75,
         "instances": f"0:{5 * q}"},
        {"kind": "loss_burst", "start_ms": 21, "duration_ms": 2, "loss": 25.0},
    ]}, 1.0)
    return x, {"control_start": inst, "faults": faults, "want_fate": True}


def _shaped_parity() -> dict:
    """Each enqueue on the CPU and on the card; the max error over planes
    and feedback (the backlog is float32, compared bit for bit too)."""
    from testground_tpu_torch.sim import net

    n = 4096
    cases = {
        "sorted-all-features": (dict(o=2, w=2, L=16, slots=4),
                                net.SHAPING_NO_DUPLICATE, {}),
        "duplicate+bandwidth_queue": (dict(o=3, w=1, L=32, slots=8),
                                      ("latency", "jitter", "loss", "duplicate",
                                       "bandwidth_queue"), {"bw_queue_cap": 6}),
        "filter_rules": (dict(o=2, w=1, L=16, slots=4),
                         ("latency", "loss", "filter_rules"), {}),
        "control-lanes+faults": ("control-lanes",
                                 ("latency", "jitter", "loss", "corrupt", "reorder",
                                  "duplicate", "filters"), {}),
    }
    out = {}
    for name, (shape, features, kw) in cases.items():
        if shape == "control-lanes":
            x, kw = _control_lane_inputs(n, hosts=3)
        else:
            x = _enqueue_inputs(np.random.default_rng(11), n, **shape)
        pc, fc = _enqueue_on(x, "cpu", features, **kw)
        pg, fg = _enqueue_on(x, "cuda", features, **kw)
        err = max(_max_err(pc, pg), max(
            float((a.double() - b.double()).abs().max()) if a.numel() else 0.0
            for a, b in zip(fc, fg) if a is not None))
        check(err == 0, f"parity: {name} enqueue CPU vs GPU max err {err}")
        out[name] = err
        if shape == "control-lanes":
            check(int(fc[8]) > 0, "parity: control-lane enqueue fault-dropped nothing")
            out[name] = {"max_err": err, "fault_dropped": int(fc[8]),
                         "enqueued": int(fc[6])}
    # direct slots under validate, with fan-in onto a pre-filled calendar:
    # which colliding write lands is undefined, so compare the counts,
    # the first collision and the bool occupancy plane
    x = _enqueue_inputs(np.random.default_rng(12), n, o=2, w=1, L=8, slots=2,
                        occ_bool=True)
    x["dst"] = np.random.default_rng(13).integers(0, 64, (2, n)).astype(np.int32)
    pc, fc = _enqueue_on(x, "cpu", ("latency", "loss"), slot_mode="direct", validate=True)
    pg, fg = _enqueue_on(x, "cuda", ("latency", "loss"), slot_mode="direct", validate=True)
    check(torch.equal(pc[0], pg[0]), "parity: direct occupancy CPU vs GPU")
    for a, b in zip(fc[:7], fg[:7]):
        check(torch.equal(a, b), "parity: direct-mode feedback CPU vs GPU")
    check(int(fc[3]) > 0, "parity: the forced collisions were not counted")
    out["direct-validate"] = {"collisions": int(fc[3]),
                              "collision_where": fc[4].tolist()}
    return out


PARITY_RUNS = {  # name: (plan, case, n, params, chunk, max_ticks, options)
    "sustained": ("network", "pingpong-sustained", 4096,
                  {"reshape_every": "32", "latency_ms": "4", "latency2_ms": "2"}, 64, 128,
                  {}),
    "flood": ("benchmarks", "pingpong-flood", 4096, {"duration_ticks": "128"}, 64, 256,
              {}),
    "storm": ("benchmarks", "storm", 4096,
              {"conn_delay_ticks": "8", "data_size_kb": "64"}, 64, 256, {}),
    "sustained-faulted": ("network", "pingpong-sustained", 4096, SUSTAINED, 250, 1000,
                          {"fault_tables": sustained_fault_tables(4096)}),
    "chaos": ("chaos", "chaos-barrier", 64, chaos_setup(64)[0], 64, 1024,
              {"fault_tables": chaos_setup(64)[1]}),
    "additional_hosts": ("additional_hosts", "additional_hosts", 64, {}, 64, 256,
                         {"hosts": ("http-echo",)}),
    # the observability planes
    "sustained+planes": ("network", "pingpong-sustained", 4096,
                         {"reshape_every": "32", "latency_ms": "4", "latency2_ms": "2"}, 64,
                         128, {"telemetry": True, "netmatrix": True, "trace": "0:64"}),
    "sustained-faulted+matrix": ("network", "pingpong-sustained", 4096, SUSTAINED, 250, 1000,
                                 {"fault_tables": sustained_fault_tables(4096),
                                  "telemetry": True, "netmatrix": True}),
    "chaos+trace": ("chaos", "chaos-barrier", 64, chaos_setup(64)[0], 64, 1024,
                    {"fault_tables": chaos_setup(64)[1], "trace": "0:64"}),
    # the HTB queue's backlog high-water under the matrix
    "traffic-shaped+matrix": ("network", "traffic-shaped", 4096,
                              {"burst": "12", "rate": "1.5"}, 64, 512,
                              {"telemetry": True, "netmatrix": True}),
}
# the mesh path: the same runs on a 4-shard virtual mesh (on the CPU, and on
# card 0), each also held against its unmeshed twin above
for _twin in ("sustained", "flood", "storm", "sustained-faulted+matrix"):
    *_spec, _opts = PARITY_RUNS[_twin]
    PARITY_RUNS[f"{_twin}+mesh"] = (*_spec, {**_opts, "mesh": MESH_SHARDS})


def phase_parity(card) -> dict:
    from testground_tpu_torch.sim.carry_io import carry_to_numpy

    runs, cpu_carries = {}, {}
    for label, (plan, case, n, params, chunk, max_ticks, opts) in PARITY_RUNS.items():
        out = {}
        for dev in ("cpu", "cuda"):
            prog = program(case, n, params, chunk=chunk, device=dev, plan=plan, **opts)
            res, rec, carry = record_planes(prog, seed=7, max_ticks=max_ticks)
            out[dev] = (res, rec, carry_to_numpy(carry))
        (res_c, rec_c, car_c), (res_g, rec_g, car_g) = out["cpu"], out["cuda"]
        mism = [k for k in res_c if k not in ("groups", "states", "compile_secs")
                and not np.array_equal(np.asarray(res_c[k]), np.asarray(res_g[k]))]
        mism += [k for k in car_c if not np.array_equal(car_c[k], car_g[k])]
        mism += [k for k in rec_c if len(rec_c[k]) != len(rec_g[k]) or not all(
            np.array_equal(a, b) for a, b in zip(rec_c[k], rec_g[k]))]
        check(not mism, f"parity {label}: CPU vs GPU differ in {mism}")
        check(res_c["msgs_sent"] > 0, f"parity {label}: nothing sent")
        cpu_carries[label] = car_c
        if opts.get("mesh"):
            twin = cpu_carries[label.removesuffix("+mesh")]
            diff = [k for k in twin if not np.array_equal(twin[k], car_c[k])]
            check(not diff, f"parity {label}: differs from the unmeshed run in {diff}")
        runs[label] = {"n": n, "ticks": int(car_c["t"]), "leaves_compared": len(car_c),
                       "msgs_sent": res_c["msgs_sent"],
                       "fault_dropped": res_c["fault_dropped"],
                       "all_success": bool((res_c["status"] == 1).all()),
                       "blocks_compared": {k: len(v) for k, v in rec_c.items() if v}}
        if opts.get("telemetry") or opts.get("trace"):
            check(runs[label]["blocks_compared"], f"parity {label}: no plane block")
            runs[label].update(check_planes(f"parity {label}", prog, res_c, rec_c))
        if label == "traffic-shaped+matrix":
            check(max(res_c["net_bw_hiwater"]) > 0, "parity: no HTB backlog high-water")
            runs[label]["net_bw_hiwater"] = res_c["net_bw_hiwater"]
    check(runs["sustained"]["ticks"] == runs["sustained+planes"]["ticks"] == 128,
          "parity: a sustained run ended early")
    short = [k for k in runs if k not in ("sustained", "sustained+planes", "sustained+mesh")
             and not runs[k]["all_success"]]
    check(not short, f"parity: {short} did not reach all SUCCESS")
    check(all(runs[k]["fault_dropped"] > 0 for k in (
        "sustained-faulted", "chaos", "sustained-faulted+matrix", "chaos+trace")),
          "parity: the schedules dropped nothing")
    return {"phase": "parity", "runs": runs, "enqueue": _shaped_parity(), "card": card}


# ------------------------------------------------------------ executor

# fields that differ between any two runs (wall clock, random span ids),
# and the journal's sim keys that describe the machine, not the run: both
# dropped before the CPU ↔ GPU comparison, as tests/test_torch_executor.py
# drops them against the JAX package
VARYING_FIELDS = frozenset(
    {"ts", "wall_ns", "wall_secs", "compile_secs", "trace_id", "span_id", "parent_id"}
)
SIM_SKIPPED = frozenset({"wall_secs", "compile_secs", "transport", "processes", "perf"})
# the perf ledger's row fields that are the run's: the rest are timings,
# the transport that ran and, on a card, the device bytes in use
PERF_ROW_FIELDS = ("run", "plan", "case", "tick", "chunk")
# one turn (three once, then two), for the script's time limit
EXEC_TURNS = 1


def exec_job(run_id, root, plan, case, n, params, device="cuda", faults=None,
             group_faults=None, trace=None, slo=None, **cfg):
    """A ``RunInput`` of one group for the port's ``execute_sim_run``."""
    from testground_tpu_torch.api import OutputsEnv, RunGroup, RunInput
    from testground_tpu_torch.sim.executor import SimTorchConfig, plan_dir

    group = RunGroup(id="all", instances=n, parameters=dict(params),
                     artifact_path=plan_dir(plan), faults=list(group_faults or []))
    return RunInput(run_id=run_id, test_plan=plan, test_case=case, total_instances=n,
                    groups=[group], env=OutputsEnv(root),
                    runner_config=SimTorchConfig(device=device, **cfg),
                    faults=list(faults or []), trace=dict(trace or {}),
                    slo=list(slo or []))


def run_exec(job):
    """One wall-clocked ``execute_sim_run`` (launches counted from zero);
    returns ``(RunOutput, wall seconds, run dir)``."""
    import threading

    from testground_tpu_torch.rpc import discard_writer
    from testground_tpu_torch.sim.executor import execute_sim_run

    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = execute_sim_run(job, discard_writer(), threading.Event())
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, os.path.join(
        job.env.dirs.outputs(), job.test_plan, job.run_id)


def _strip(x):
    if isinstance(x, dict):
        return {k: _strip(v) for k, v in x.items() if k not in VARYING_FIELDS}
    if isinstance(x, list):
        return [_strip(v) for v in x]
    return x


# the engine's lifecycle span tree in a run directory, and its clocks
SPAN_TREE_FILES = ("task_spans.jsonl", "task_trace.json")
SPAN_CLOCKS = frozenset({"start_ns", "end_ns", "ts", "dur"})


def read_run_dir(run_dir) -> dict:
    """Every file of a run directory, parsed, the varying fields dropped;
    the span tree's rows without their clocks, in an order of their own;
    the perf ledger's rows by their PERF_ROW_FIELDS."""
    out = {}
    for root, _, names in os.walk(run_dir):
        for fname in names:
            path = os.path.join(root, fname)
            with open(path) as f:
                rel = os.path.relpath(path, run_dir)
                out[rel] = (_strip(json.load(f)) if fname.endswith(".json") else
                            [_strip(json.loads(ln)) for ln in f if ln.strip()])
            if fname == "sim_perf.jsonl":
                out[rel] = [{k: r[k] for k in PERF_ROW_FIELDS} for r in out[rel]]
            if fname in SPAN_TREE_FILES:
                rows = out[rel]["traceEvents"] if fname.endswith(".json") else out[rel]
                out[rel] = sorted(({k: v for k, v in r.items() if k not in SPAN_CLOCKS}
                                   for r in rows), key=lambda r: json.dumps(r, sort_keys=True))
    return out


def check_exec_run(label, out, run_dir, n) -> dict:
    """The run directory against its journal: the telemetry totals are the
    series' sums, the matrix reconciles, the flow totals close."""
    j = out.result.journal
    sim = j["sim"]
    check(out.result.outcome.value == "success", f"{label}: outcome {out.result.outcome}")
    rows = [json.loads(ln) for ln in open(os.path.join(run_dir, "sim_timeseries.jsonl"))]
    totals = j["telemetry"]["totals"]
    for col in ("delivered", "sent", "enqueued", "dropped", "rejected", "fault_dropped"):
        got = sum(r[col] for r in rows)
        check(got == totals[col], f"{label}: Σ {col} {got} != journal {totals[col]}")
    check(rows[-1]["cal_depth"] == totals["in_flight"], f"{label}: in-flight")
    check(j["telemetry"]["rows"] == len(rows), f"{label}: rows")
    check(sim["net_matrix"]["mismatches"] == [],
          f"{label}: reconcile {sim['net_matrix']['mismatches']}")
    check(sim["msgs_sent"] == sim["msgs_delivered"] + sim["msgs_in_flight"]
          + sim["msgs_dropped"] + sim["msgs_rejected"] + sim["msgs_fault_dropped"],
          f"{label}: flow conservation")
    if n > 2048:
        check(j.get("outputs_skipped", {}).get("instances") == n, f"{label}: outputs")
    return {"ticks": sim["ticks"], "rows": len(rows), "carry_bytes": sim["carry_bytes"],
            "transport": sim["transport"]["resolved"], "slo_breaches": j["slo"]["breaches"],
            "trace_events": j.get("trace", {}).get("events"),
            "files": sorted(os.listdir(run_dir))}


def slo_ticks(run_dir) -> list:
    from testground_tpu_torch.sim.slo import SLO_FILE

    path = os.path.join(run_dir, SLO_FILE)
    return [json.loads(ln)["tick"] for ln in open(path)] if os.path.exists(path) else []


def phase_executor(card, n=100_000, m=4096, chaos_n=SWEEP_N) -> dict:
    """The port's ``execute_sim_run`` on the card, into a temporary
    outputs root: sustained@100k with every plane and a warn SLO rule
    (checked against its run directory, and timed in turns against
    ``SimProgram.run`` of the same planes: the executor's host cost),
    faults@100k with a crashed-fraction rule (its breaches inside the crash
    window), the chaos smoke composition at 256, and the faulted
    sustained at 4,096 with every plane on the CPU and on the card, whose
    run directories and journals must be equal."""
    import shutil
    import tempfile

    root = tempfile.mkdtemp(prefix="chip_smoke_exec_")
    launches = {"commit_calendar": 0, "pop_bucket": 0}

    def count(got, label):
        check(all(v > 0 for v in got.values()), f"executor {label}: launches {got}")
        for k, v in got.items():
            launches[k] += v

    planes = {"telemetry": True, "netmatrix": True}
    rule = {"name": "drops-under-1pct", "metric": "drop_rate", "op": "<",
            "threshold": 0.01, "severity": "warn"}
    try:
        # sustained@100k in turns: the executor, then the bare program
        prog = program("pingpong-sustained", n, SUSTAINED, chunk=250, trace="0:64",
                       **planes)
        # a warm-up run, so that no turn pays the process's first run; and
        # the footprint from the shapes alone, timed
        run_timed(prog, max_ticks=10_000)
        t0 = time.perf_counter()
        estimate = prog.estimate_carry_bytes()
        estimate_s = time.perf_counter() - t0
        walls = {"execute_sim_run": [], "SimProgram.run": []}
        sustained = None
        order = ("execute_sim_run", "SimProgram.run")
        for i in range(EXEC_TURNS):
            for way in (order if i % 2 == 0 else order[::-1]):
                if way == "SimProgram.run":
                    res, wall, ticks, _ = run_timed(prog, max_ticks=10_000)
                    check(conserved(res), "executor: bare run flow totals")
                else:
                    out, wall, run_dir = run_exec(exec_job(
                        f"sustained-{i}", root, "network", "pingpong-sustained", n,
                        SUSTAINED, trace={"instances": "0:64"}, slo=[rule], chunk=250,
                        max_ticks=10_000, **planes))
                    # the ticks that ran (one counter row each), not the
                    # journal's ticks, which round up to whole chunks
                    ticks = out.result.journal["telemetry"]["rows"]
                    if sustained is None:
                        sustained = check_exec_run("executor sustained", out, run_dir, n)
                        check(sustained["carry_bytes"] == estimate,
                              f"executor: carry_bytes {sustained['carry_bytes']} != "
                              f"estimate {estimate}")
                        sustained["estimate_carry_bytes_s"] = estimate_s
                        sustained["run_wall_ms_per_tick"] = (
                            out.result.journal["sim"]["wall_secs"] / ticks * 1e3)
                    shutil.rmtree(run_dir)
                count(read_launches(), way)
                walls[way].append(wall / ticks * 1e3)
        timing = {way: {"wall_ms_per_tick": w, "median": statistics.median(w)}
                  for way, w in walls.items()}
        timing["host_cost_ms_per_tick"] = [
            e - r for e, r in zip(walls["execute_sim_run"], walls["SimProgram.run"])]

        # faults@100k: a crashed fraction of 0.1 from the crash at 100 ms
        # to the restart at 250 ms breaches a 0.05 rule in those chunks
        crash_rule = {"name": "crashed-under-5pct", "metric": "crashed_fraction",
                      "op": "<", "threshold": 0.05, "severity": "warn"}
        out, wall, run_dir = run_exec(exec_job(
            "faults", root, "network", "pingpong-sustained", n, SUSTAINED,
            faults=sustained_fault_tables(n)[""], slo=[crash_rule], chunk=50,
            max_ticks=10_000, **planes))
        count(read_launches(), "faults")
        faults = check_exec_run("executor faults", out, run_dir, n)
        ticks = slo_ticks(run_dir)
        check(ticks and all(100 <= t < 250 for t in ticks),
              f"executor faults: breach ticks {ticks} outside the crash window")
        faults.update(wall_s=wall, breach_ticks=ticks,
                      faults_crashed=out.result.journal["sim"]["faults_crashed"])

        # the chaos smoke composition at SWEEP_N instances
        params, tables = chaos_setup(chaos_n)
        smoke_rule = {"name": "fleet-mostly-alive", "metric": "crashed_fraction",
                      "op": "<", "threshold": 0.2, "severity": "warn"}
        out, wall, run_dir = run_exec(exec_job(
            "chaos", root, "chaos", "chaos-barrier", chaos_n, params,
            group_faults=tables["all"], trace={"instances": "0:3"}, slo=[smoke_rule],
            telemetry=True, chunk=16, max_ticks=8192))
        count(read_launches(), "chaos")
        j = out.result.journal
        check(out.result.outcome.value == "success", f"executor chaos: {out.result.outcome}")
        ticks = slo_ticks(run_dir)
        check(ticks and all(6 <= t < 20 + 16 for t in ticks),
              f"executor chaos: breach ticks {ticks}")
        chaos = {"ticks": j["sim"]["ticks"], "wall_s": wall, "breach_ticks": ticks,
                 "trace_events": j["trace"]["events"], "events": j["events"]}

        # CPU ↔ GPU: the faulted sustained at 4,096 with every plane
        trees = {}
        for dev in ("cpu", "cuda"):
            out, wall, run_dir = run_exec(exec_job(
                "parity", os.path.join(root, dev), "network", "pingpong-sustained", m,
                SUSTAINED, device=dev, faults=sustained_fault_tables(m)[""],
                trace={"instances": "0:64"}, slo=[crash_rule], chunk=250, max_ticks=1000,
                **planes))
            journal = json.loads(json.dumps(out.result.journal))
            journal["sim"] = {k: v for k, v in journal["sim"].items()
                              if k not in SIM_SKIPPED}
            trees[dev] = (read_run_dir(run_dir), journal, out.result.outcome.value)
        count(read_launches(), "parity")  # the card's run, the last
        (tc, jc, oc), (tg, jg, og) = trees["cpu"], trees["cuda"]
        diff = sorted(set(tc) ^ set(tg)) + [k for k in tc if k in tg and tc[k] != tg[k]]
        diff += [k for k in jc if jc.get(k) != jg.get(k)] + ([] if oc == og else ["outcome"])
        check(not diff, f"executor parity: CPU vs GPU differ in {diff}")
        parity = {"n": m, "files_compared": len(tc), "journal_keys": sorted(jc),
                  "ticks": jc["sim"]["ticks"], "slo_breaches": jc["slo"]["breaches"]}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"phase": "executor", "n": n, "sustained": sustained, "timing": timing,
            "faults": faults, "chaos": chaos, "parity": parity, "launches": launches,
            "card": card}


# ------------------------------------------------------------ the CLI

# one turn (three once, then two), for the script's time limit
CLI_TURNS = 1
# sustained@100k as a composition: bench.py's sustained cut as phase 4
# cuts it, through `run composition` at full width
SUSTAINED_COMPOSITION = """[metadata]
name = "sustained-100k"

[global]
plan = "network"
case = "pingpong-sustained"
builder = "sim:plan"
runner = "sim:torch"

[global.run_config]
chunk = 250
max_ticks = 10000
telemetry = true

[[groups]]
id = "all"

[groups.instances]
count = 100000

[groups.run.test_params]
{params}
"""


def cli_home(root, name, env_toml="") -> str:
    """A ``$TESTGROUND_HOME`` under ``root`` whose ``plans/`` holds copies
    of the port's plan directories and whose ``.env.toml`` is ``env_toml``."""
    import shutil

    from testground_tpu_torch.sim.executor import PLANS_ROOT

    home = os.path.join(root, name)
    for plan in sorted(os.listdir(PLANS_ROOT)):
        src = os.path.join(PLANS_ROOT, plan)
        if os.path.isfile(os.path.join(src, "manifest.toml")):
            shutil.copytree(src, os.path.join(home, "plans", plan),
                            ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(home, ".env.toml"), "w") as f:
        f.write(env_toml)
    return home


def cli_call(home, argv) -> dict:
    """One in-process call of the port's CLI with ``$TESTGROUND_HOME`` =
    ``home``, wall-clocked (the card synchronised on both sides): its exit
    code, output, wall seconds and task."""
    import contextlib
    import io
    import re

    from testground_tpu_torch.cli.main import main as cli_main
    from testground_tpu_torch.engine import TaskStorage

    out, err = io.StringIO(), io.StringIO()
    old = os.environ.get("TESTGROUND_HOME")
    os.environ["TESTGROUND_HOME"] = home
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = cli_main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        if old is None:
            os.environ.pop("TESTGROUND_HOME", None)
        else:
            os.environ["TESTGROUND_HOME"] = old
    m = re.search(r"run is queued with ID: (\S+)", out.getvalue())
    # the in-process engine's disk store; through a daemon, its store
    db = os.path.join(home, "tasks.db")
    task = TaskStorage(db).get(m.group(1)) if m and os.path.exists(db) else None
    return {"rc": rc, "out": out.getvalue(), "err": err.getvalue(), "wall": wall,
            "task": task}


def cli_run(label, home, argv, launches) -> dict:
    """A CLI run of the main path: its launches counted from zero and added
    to ``launches``; it must exit 0 with outcome success and launch both
    kernels."""
    reset_launches()
    got = cli_call(home, argv)
    check(got["rc"] == 0 and "(outcome: success)" in got["out"],
          f"cli {label}: exit {got['rc']}: {got['out'][-1500:]} {got['err'][-1500:]}")
    counts = read_launches()
    check(all(v > 0 for v in counts.values()), f"cli {label}: launches {counts}")
    for k, v in counts.items():
        launches[k] += v
    got["launches"] = counts
    return got


def _run_dir(home, task, run_id=None):
    return os.path.join(home, "data", "outputs", task.plan, run_id or task.id)


def _norm_task(task, home) -> dict:
    """A task's result with its run ID, its home and the machine's fields
    (SIM_SKIPPED, VARYING_FIELDS) made the same on every device."""
    result = json.loads(json.dumps(task.result))
    result.pop("perf", None)
    result["journal"]["sim"] = {k: v for k, v in result["journal"]["sim"].items()
                                if k not in SIM_SKIPPED}
    text = json.dumps(_strip(result)).replace(task.id, "<task>").replace(home, "<home>")
    return json.loads(text)


def _profiled(fn) -> tuple:
    """``(device ms, kernels)`` of the device events of one call of ``fn``
    (``torch.profiler``, device activity only)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [r for r in _device_rows(prof) if r[1] > 0]
    return sum(r[1] for r in rows) / 1e3, sum(r[2] for r in rows)


def precompile_step(root, home, path, launches) -> dict:
    """The build's precompile pass on the card, in phase ``cli``'s home:
    ``build composition --write-artifacts`` of the sustained@100k
    composition at ``path`` bucketed on a one-rung ladder of 100,000 (the
    exact run's shapes, with the journal's bucket block). The build must log "precompiled run" and launch, in its warm
    tick, exactly the kernels its log line names (K2 at least); its marker
    must hold the spec (the card, the kernel library's digest) and a
    ``perf`` block whose ``carry_bytes`` is the run's journaled carry
    bytes and whose ``peak_bytes`` is the card's; the written
    composition's run must count 100,000 instances. A rebuild must log the
    cache hit and launch nothing, and the built composition's run must
    journal ``compile_cache: "hit"``."""
    import re

    from testground_tpu_torch.api import Composition
    from testground_tpu_torch.sim import cuda_transport as ct

    built = os.path.join(root, "sustained-100k-built.toml")
    with open(path) as f, open(built, "w") as g:
        g.write(f.read().replace(
            "max_ticks = 10000",
            'max_ticks = 10000\nbucket = "auto"\nbucket_ladder = "100000"'))
    argv = ["build", "composition", "-f", built]
    reset_launches()
    got = cli_call(home, argv + ["--write-artifacts"])
    counts = read_launches()
    out = got["out"]
    check(got["rc"] == 0 and "(outcome: success)" in out
          and "sim:plan precompiled run default into " in out,
          f"cli precompile: build: {out[-2000:]} {got['err'][-1500:]}")
    said = re.search(r"warm tick of run default on \S+ launched (\{.*\})", out)
    check(said is not None, f"cli precompile: no warm-tick line: {out[-2000:]}")
    predicted = json.loads(said.group(1))
    check(counts == {k: predicted.get(k, 0) for k in KERNELS}
          and counts["pop_bucket"] >= 1,
          f"cli precompile: launches {counts}, the builder said {predicted}")
    key = re.search(r"precompiled run default into \S+ in \S+ \(key (\w+)\)", out).group(1)
    with open(os.path.join(home, "data", "compile-cache", "precompiled",
                           f"{key}.json")) as f:
        marker = json.load(f)
    perf = marker["perf"]
    check(marker["device"] == "cuda" and marker["kernels"] == ct.kernel_digest()
          and marker["groups"][0]["instances"] == 100_000
          and marker["bucket"] == [100_000]
          and marker["device_name"] == torch.cuda.get_device_name(0),
          f"cli precompile: marker spec {marker}")
    check(sorted(perf) == ["carry_bytes", "kernel_build_secs", "peak_bytes", "warm_secs"]
          and perf["carry_bytes"] > 0 and isinstance(perf["peak_bytes"], int)
          and perf["peak_bytes"] >= perf["carry_bytes"],
          f"cli precompile: marker perf {perf}")
    runs = Composition.load_file(built).runs
    check([r.total_instances for r in runs] == [100_000],
          f"cli precompile: written total_instances {[r.total_instances for r in runs]}")
    reset_launches()
    again = cli_call(home, argv)
    check(again["rc"] == 0 and f"cache hit for run default (key {key})" in again["out"]
          and "precompiled run" not in again["out"]
          and all(v == 0 for v in read_launches().values()),
          f"cli precompile: rebuild {again['out'][-1500:]} {read_launches()}")
    torch.cuda.reset_peak_memory_stats()
    ran = cli_run("sustained@100k built", home, ["run", "composition", "-f", built],
                  launches)
    run_peak = torch.cuda.max_memory_allocated()
    sim = ran["task"].result["journal"]["sim"]
    check(sim["bucket"]["compile_cache"] == "hit" and sim["bucket"]["dead_lanes"] == 0,
          f"cli precompile: run bucket {sim.get('bucket')}")
    check(sim["carry_bytes"] == perf["carry_bytes"],
          f"cli precompile: carry {perf['carry_bytes']} against the run's "
          f"{sim['carry_bytes']}")
    return {"build_wall_s": got["wall"], "rebuild_wall_s": again["wall"],
            "compile_secs": marker["compile_secs"], "perf": perf,
            "build_launches": counts, "builder_said": predicted,
            "run_wall_s": ran["wall"], "run_ticks": sim["ticks"],
            "run_first_chunk_s": sim["compile_secs"], "run_peak_bytes": run_peak,
            "peak_vs_run": perf["peak_bytes"] / run_peak,
            "compile_cache": sim["bucket"]["compile_cache"]}


def phase_cli(card) -> dict:
    """The port's CLI on the card (``testground_tpu_torch.cli.main.main``
    in process, so that the kernels' launch counts are visible), in
    temporary ``$TESTGROUND_HOME``s whose ``plans/`` hold copies of the
    port's plan directories: the healthcheck; the sustained smoke
    composition; sustained@100k as a composition in turns against
    ``execute_sim_run`` of the ``RunInput`` the CLI lowered (the CLI's host
    cost per run and per tick), then both profiled (kernels a tick, device
    ms/tick); ``run single network:ping-pong -i 100000``; the chaos smoke
    composition on the card and, from a home that sets ``device = "cpu"``,
    on the CPU, whose run directories and task results must be equal; and a
    run mirrored to a local Influx capture server."""
    import dataclasses
    import http.server
    import shutil
    import tempfile
    import threading

    from testground_tpu_torch.rpc import discard_writer
    from testground_tpu_torch.sim.executor import execute_sim_run
    from testground_tpu_torch.sim.runner import SimTorchRunner

    root = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    launches = dict.fromkeys(KERNELS, 0)
    row = {"phase": "cli", "card": card, "step_s": {}}
    t_step = [time.perf_counter()]

    def step(name):
        now = time.perf_counter()
        row["step_s"][name] = now - t_step[0]
        t_step[0] = now

    try:
        home = cli_home(root, "card")

        # the healthcheck, first: its K2 check is cached for the runs after
        got = cli_call(home, ["healthcheck", "--runner", "sim:torch"])
        report = [ln for ln in got["out"].splitlines() if ln.startswith(("check ", "fix "))]
        print("\n".join(report), flush=True)
        check(got["rc"] == 0 and len(report) == 10
              and all(": ok " in ln or ": omitted " in ln for ln in report),
              f"cli healthcheck: {got['out'][-2000:]}")
        row["healthcheck"] = {"wall_s": got["wall"], "report": report}
        step("healthcheck")

        # the sustained smoke composition
        comp = os.path.join(home, "plans", "network", "_compositions",
                            "sustained-smoke.toml")
        got = cli_run("sustained-smoke", home, ["run", "composition", "-f", comp],
                      launches)
        task = got["task"]
        sim = task.result["journal"]["sim"]
        files = set(os.listdir(_run_dir(home, task)))
        want = {"run_spans.jsonl", "sim_timeseries.jsonl", "sim_latency.jsonl",
                "sim_slo.jsonl", "timeseries.jsonl"}
        check(want <= files, f"cli sustained-smoke: files {sorted(files)}")
        check(sim["transport"]["resolved"] == "cuda"
              and "commit_k" in sim["transport"]["reason"]
              and "pop_vec_k" in sim["transport"]["reason"],
              f"cli sustained-smoke: transport {sim['transport']}")
        row["sustained_smoke"] = {"wall_s": got["wall"], "ticks": sim["ticks"],
                                  "launches": got["launches"], "files": sorted(files)}
        step("sustained_smoke")

        path = os.path.join(root, "sustained-100k.toml")
        with open(path, "w") as f:
            f.write(SUSTAINED_COMPOSITION.format(params="\n".join(
                f'{k} = "{v}"' for k, v in SUSTAINED.items())))
        row["precompile"] = precompile_step(root, home, path, launches)
        step("precompile")

        # sustained@100k as a composition: a warm-up run through the CLI,
        # recording the RunInput the supervisor lowered; then turns of the
        # CLI against execute_sim_run of that same RunInput
        argv = ["run", "composition", "-f", path]
        lowered = []
        plain_run = SimTorchRunner.run

        def recording(self, job, ow, cancel):
            lowered.append(job)
            return plain_run(self, job, ow, cancel)

        SimTorchRunner.run = recording
        try:
            warm = cli_run("sustained@100k warm-up", home, argv, launches)
        finally:
            SimTorchRunner.run = plain_run
        # the first chunk of the unbucketed warm-up, beside the built run's
        row["precompile"]["warm_up_first_chunk_s"] = (
            warm["task"].result["journal"]["sim"]["compile_secs"])
        print("cli precompile: " + json.dumps(row["precompile"]), flush=True)
        check(len(lowered) == 1, "cli sustained@100k: no RunInput lowered")
        job0 = lowered[0]

        def exec_run(i):
            job = dataclasses.replace(job0, run_id=f"exec-{i}")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = execute_sim_run(job, discard_writer(), threading.Event())
            torch.cuda.synchronize()
            return out, time.perf_counter() - t0

        step("sustained_100k_warm_up")
        walls = {"cli": [], "execute_sim_run": []}
        per_tick = {"cli": [], "execute_sim_run": []}
        # the CLI's wall outside the runner's run, within the same call
        # (the supervisor's runner_wall_secs): no turn-to-turn spread
        outside_ms = []
        ticks = None
        for i in range(CLI_TURNS):
            for way in (("cli", "execute_sim_run") if i % 2 == 0
                        else ("execute_sim_run", "cli")):
                if way == "cli":
                    got = cli_run(f"sustained@100k turn {i}", home, argv, launches)
                    journal, wall = got["task"].result["journal"], got["wall"]
                    check(got["task"].result["outcome"] == "success",
                          "cli sustained@100k: outcome")
                    runner_s = got["task"].result["perf"]["runner_wall_secs"]["default"]
                    outside_ms.append((wall - runner_s) * 1e3)
                else:
                    reset_launches()
                    out, wall = exec_run(i)
                    for k, v in read_launches().items():
                        launches[k] += v
                    journal = out.result.journal
                    check(out.result.outcome.value == "success",
                          "cli sustained@100k: executor outcome")
                s = journal["sim"]
                check(s["msgs_sent"] == s["msgs_delivered"] + s["msgs_in_flight"]
                      + s["msgs_dropped"] + s["msgs_rejected"] + s["msgs_fault_dropped"],
                      f"cli sustained@100k {way}: flow conservation")
                # the ticks that ran (one counter row each)
                ticks = journal["telemetry"]["rows"]
                walls[way].append(wall)
                per_tick[way].append(wall / ticks * 1e3)
        cost_ms = [(c - e) * 1e3 for c, e in zip(walls["cli"], walls["execute_sim_run"])]
        row["sustained_100k"] = {
            "n": 100_000, "ticks": ticks, "turns": CLI_TURNS,
            "wall_s": walls, "wall_ms_per_tick": per_tick,
            "host_cost_ms_per_run": cost_ms,
            "host_cost_ms_per_tick": [c / ticks for c in cost_ms],
            "host_cost_ms_per_run_median": statistics.median(cost_ms),
            "outside_runner_ms_per_run": outside_ms,
        }
        step("sustained_100k_turns")

        # ping-pong@100k through `run single`, with its RTT assertions
        got = cli_run("ping-pong@100k", home,
                      ["run", "single", "network:ping-pong", "-i", "100000"], launches)
        sim = got["task"].result["journal"]["sim"]
        check(got["task"].result["journal"]["events"]["single"]["success"] == 100_000,
              "cli ping-pong@100k: not every instance SUCCESS")
        row["pingpong_100k"] = {"wall_s": got["wall"], "ticks": sim["ticks"],
                                "launches": got["launches"]}
        step("pingpong_100k")

        # the chaos smoke composition on the card and on the CPU
        cpu_home = cli_home(root, "cpu", '[runners."sim:torch"]\ndevice = "cpu"\n')
        runs = {}
        for dev, h in (("cuda", home), ("cpu", cpu_home)):
            comp = os.path.join(h, "plans", "chaos", "_compositions", "smoke.toml")
            if dev == "cuda":
                got = cli_run("chaos-smoke", h, ["run", "composition", "-f", comp],
                              launches)
            else:
                got = cli_call(h, ["run", "composition", "-f", comp])
                check(got["rc"] == 0, f"cli chaos-smoke cpu: {got['err'][-1500:]}")
            task = got["task"]
            tree = json.loads(json.dumps(read_run_dir(_run_dir(h, task)))
                              .replace(task.id, "<task>").replace(h, "<home>"))
            runs[dev] = (tree, _norm_task(task, h),
                         task.result["journal"]["sim"]["transport"]["resolved"])
        (tg, jg, rg), (tc, jc, rc_) = runs["cuda"], runs["cpu"]
        diff = sorted(set(tc) ^ set(tg)) + [k for k in tc if k in tg and tc[k] != tg[k]]
        diff += [k for k in jc if jc.get(k) != jg.get(k)]
        check(not diff and (rg, rc_) == ("cuda", "plain"),
              f"cli chaos-smoke: CPU vs GPU differ in {diff} ({rg}, {rc_})")
        row["chaos_parity"] = {"files_compared": len(tc), "result_keys": sorted(jc),
                               "ticks": jc["journal"]["sim"]["ticks"]}
        step("chaos_parity")

        # the Influx mirror, to a capture server on this host
        posts = []

        class Capture(http.server.BaseHTTPRequestHandler):
            def do_POST(self):
                n = int(self.headers["Content-Length"])
                posts.append((self.path, self.rfile.read(n)))
                self.send_response(204)
                self.end_headers()

            def log_message(self, *args):
                pass

        srv = http.server.HTTPServer(("127.0.0.1", 0), Capture)
        thread = threading.Thread(target=srv.serve_forever, daemon=True)
        thread.start()
        try:
            influx_home = cli_home(root, "influx", '[daemon]\ninfluxdb_endpoint = '
                                   f'"http://127.0.0.1:{srv.server_port}"\n')
            got = cli_run("influx", influx_home,
                          ["run", "single", "network:ping-pong", "-i", "64",
                           "--run-cfg", "telemetry=true", "--run-cfg", "chunk=16",
                           "--run-cfg", "timeseries_every=16"], launches)
        finally:
            srv.shutdown()
            srv.server_close()
        journal = got["task"].result["journal"]
        blocks = {k: v for k, v in journal.items() if k.startswith("influx")}
        body = b"".join(b for _, b in posts).decode()
        check(set(blocks) == {"influx", "influx_telemetry", "influx_latency", "influx_perf"}
              and all(b["ok"] for b in blocks.values()),
              f"cli influx: journal blocks {blocks}")
        check(all(p == "/write?db=testground" for p, _ in posts)
              and ".sim.delivered" in body and ".sim.latency.p50" in body
              and ".pingpong.rtt1_ticks" in body and ".sim.perf.peer_ticks_per_sec" in body,
              f"cli influx: {len(posts)} posts")
        row["influx"] = {"posts": len(posts), "lines": body.count("\n"),
                         "journal": blocks}
        step("influx")

        # kernels a tick and device ms/tick of the CLI's run and of the
        # executor's over one chunk of 64 ticks (a chunk-64 twin, not the
        # run's chunk of 250), profiled last (a profiler session slows later
        # launches)
        first = os.path.join(root, "sustained-100k-first-chunk.toml")
        with open(path) as f, open(first, "w") as g:
            g.write(f.read().replace("max_ticks = 10000", "max_ticks = 64")
                    .replace("chunk = 250", "chunk = 64"))
        job0 = dataclasses.replace(
            job0, runner_config=dataclasses.replace(job0.runner_config, max_ticks=64,
                                                    chunk=64))
        prof = {}
        for way, fn in (("cli", lambda: cli_call(home, ["run", "composition", "-f", first])),
                        ("execute_sim_run", lambda: exec_run("profiled"))):
            ms, kernels = _profiled(fn)
            prof[way] = {"ticks": 64, "device_ms_per_tick": ms / 64,
                         "kernels_per_tick": kernels / 64}
        row["sustained_100k"]["profiled"] = prof
        step("profiled")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    row["launches"] = launches
    return row


# ---------------------------------------------------------------- daemon

# one turn (three once, then two), for the script's time limit
DAEMON_TURNS = 1
# the profiled first chunk of phase daemon: a chunk-64 twin of 64 ticks
DAEMON_PROFILE_TICKS = 64
# a composition of one group, with {n}, {chunk}, {max_ticks}, {cfg} (more
# run-config lines), {params} and {faults} ([[global.run.faults]] blocks)
DAEMON_COMPOSITION = """[metadata]
name = "{name}"

[global]
plan = "network"
case = "pingpong-sustained"
builder = "sim:plan"
runner = "sim:torch"

[global.run_config]
chunk = {chunk}
max_ticks = {max_ticks}
telemetry = true
{cfg}

[[groups]]
id = "all"

[groups.instances]
count = {n}

[groups.run.test_params]
{params}
{faults}
"""


def daemon_composition(root, name, n, params, chunk=250, max_ticks=10000, cfg="",
                       faults=()) -> str:
    """A sustained composition file under ``root``; returns its path."""
    blocks = "\n".join("[[global.run.faults]]\n" + "\n".join(
        f"{k} = {json.dumps(v)}" for k, v in f.items()) for f in faults)
    path = os.path.join(root, f"{name}.toml")
    with open(path, "w") as f:
        f.write(DAEMON_COMPOSITION.format(
            name=name, n=n, chunk=chunk, max_ticks=max_ticks, cfg=cfg, faults=blocks,
            params="\n".join(f'{k} = "{v}"' for k, v in params.items())))
    return path


def _wait_done(client, task_id, deadline_s, poll_s=0.01) -> dict:
    """``status`` until the task is complete or canceled, within a deadline."""
    t_end = time.monotonic() + deadline_s
    while True:
        t = client.status(task_id)
        if t["states"][-1]["state"] in ("complete", "canceled"):
            return t
        check(time.monotonic() < t_end, f"daemon: task {task_id} not done in {deadline_s}s")
        time.sleep(poll_s)


def _sim_flows(task) -> dict:
    """A task's flow counters, its per-group events and its outcome."""
    j = task["result"]["journal"]
    return {"outcome": task["outcome"], "events": j["events"],
            "flows": {k: v for k, v in j["sim"].items() if k.startswith("msgs_")},
            "ticks": j["sim"]["ticks"]}


def phase_daemon(card) -> dict:
    """The daemon on the card: ``python -m testground_tpu_torch.cli daemon``
    as a process of its own, driven by the CLI with ``--endpoint``
    (``healthcheck``, two detached runs claimed at once by its two workers
    on their first kernel launch, ``run composition`` of the sustained
    smoke, ``tasks``, ``status``, ``logs``, ``collect`` against the same
    composition run by the in-process CLI, ``terminate``) and stopped by
    SIGTERM; then an in-process ``Daemon`` (its workers' launches counted
    here): sustained@100k through its client in turns against the in-process
    CLI (queue wait, wall outside the runner; kernels a tick and device
    ms/tick of both, a chunk-64 twin's 64 ticks profiled, last); two runs at once on its
    two workers, each equal to its run alone; ``/kill`` of a 10,000-tick
    run after its first chunk; the chaos smoke on the CPU and on the card
    through it, equal."""
    import re
    import shutil
    import signal
    import socket
    import tarfile
    import tempfile

    from testground_tpu_torch.api import load_composition
    from testground_tpu_torch.client import Client
    from testground_tpu_torch.config import EnvConfig
    from testground_tpu_torch.daemon import Daemon

    root = tempfile.mkdtemp(prefix="chip_smoke_daemon_")
    launches = dict.fromkeys(KERNELS, 0)
    row = {"phase": "daemon", "card": card, "step_s": {}}
    t_step = [time.perf_counter()]

    def step(name):
        now = time.perf_counter()
        row["step_s"][name] = now - t_step[0]
        t_step[0] = now

    def ids_out(x, task_id, home):
        return json.loads(json.dumps(x).replace(task_id, "<task>").replace(home, "<home>"))

    smoke_rel = os.path.join("plans", "network", "_compositions", "sustained-smoke.toml")
    try:
        # 1. the daemon process, as its users start it
        home = cli_home(root, "daemon")
        client_home = cli_home(root, "client")
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        ep = f"http://127.0.0.1:{port}"
        log_path = os.path.join(root, "daemon.log")
        here = os.path.dirname(os.path.abspath(__file__))
        with open(log_path, "w") as log:
            proc = subprocess.Popen(
                [sys.executable, "-m", "testground_tpu_torch.cli", "daemon",
                 "--listen", f"127.0.0.1:{port}"],
                cwd=here, stdout=log, stderr=subprocess.STDOUT,
                env={**os.environ, "TESTGROUND_HOME": home, "PYTHONPATH": here})
        client = Client(ep)

        def log_tail():
            with open(log_path) as f:
                return f.read()[-3000:]

        try:
            t_end = time.monotonic() + 120
            while True:
                check(proc.poll() is None, f"daemon exited early: {log_tail()}")
                try:
                    client.tasks()
                    break
                except OSError:
                    check(time.monotonic() < t_end, f"daemon did not answer: {log_tail()}")
                    time.sleep(0.2)
            row["answers_s"] = 120 - (t_end - time.monotonic())
            step("daemon_answers")

            def remote(argv):
                return cli_call(client_home, ["--endpoint", ep, *argv])

            # two detached runs, claimed at once by the two workers: both
            # reach the kernels' first launch (the build, K2's check) together
            smoke = os.path.join(client_home, smoke_rel)
            detached = []
            for _ in range(2):
                got = remote(["run", "composition", "-f", smoke, "--detach"])
                check(got["rc"] == 0 and "finished run" not in got["out"],
                      f"daemon --detach: {got['out'][-1000:]} {got['err'][-1000:]}")
                detached.append(re.search(r"run is queued with ID: (\S+)", got["out"])[1])
            done = [_wait_done(client, tid, 120, poll_s=0.1) for tid in detached]
            check(all(t["outcome"] == "success" for t in done),
                  f"daemon detached runs: {[t['error'] for t in done]}")
            check(_sim_flows(done[0]) == _sim_flows(done[1]), "daemon: detached runs differ")
            starts = [t["states"][1]["created"] for t in done]
            ends = [t["states"][2]["created"] for t in done]
            row["detached"] = {"overlap_s": min(ends) - max(starts),
                               "queued_secs": [t["result"]["perf"]["queued_secs"]
                                               for t in done]}
            step("detached_pair")

            got = remote(["healthcheck", "--runner", "sim:torch"])
            report = [ln for ln in got["out"].splitlines()
                      if ln.startswith(("check ", "fix "))]
            check(got["rc"] == 0 and len(report) == 10
                  and all(": ok " in ln or ": omitted " in ln for ln in report),
                  f"daemon healthcheck: {got['out'][-2000:]}")
            row["healthcheck"] = report

            got = remote(["run", "composition", "-f", smoke])
            check(got["rc"] == 0 and "(outcome: success)" in got["out"],
                  f"daemon run: {got['out'][-1500:]} {got['err'][-1500:]}")
            tid = re.search(r"run is queued with ID: (\S+)", got["out"])[1]
            task = client.status(tid)
            sim = task["result"]["journal"]["sim"]
            check(sim["transport"]["resolved"] == "cuda"
                  and "commit_k" in sim["transport"]["reason"],
                  f"daemon run: transport {sim['transport']}")
            verbs = {}
            for verb, argv in (("tasks", ["tasks"]), ("status", ["status", "-t", tid]),
                               ("logs", ["logs", "-t", tid])):
                got = remote(argv)
                check(got["rc"] == 0 and tid in got["out"] if verb != "logs"
                      else got["rc"] == 0 and f"executing run {tid}" in got["out"],
                      f"daemon {verb}: {got['out'][-1000:]} {got['err'][-1000:]}")
                verbs[verb] = len(got["out"].splitlines())
            check("Outcome: success" in remote(["status", "-t", tid])["out"],
                  "daemon status: outcome")
            tgz = os.path.join(root, "collected.tgz")
            got = remote(["collect", tid, "--runner", "sim:torch", "-o", tgz])
            check(got["rc"] == 0 and os.path.getsize(tgz) > 0, f"daemon collect: {got['err']}")
            unpacked = os.path.join(root, "collected")
            with tarfile.open(tgz) as tar:
                tar.extractall(unpacked, filter="data")
            remote_tree = ids_out(read_run_dir(os.path.join(unpacked, tid)), tid, home)
            # the same composition through the in-process CLI
            got = cli_run("daemon sustained-smoke in process", client_home,
                          ["run", "composition", "-f", smoke], launches)
            local = got["task"]
            local_tree = ids_out(read_run_dir(_run_dir(client_home, local)), local.id,
                                 client_home)
            diff = sorted(set(local_tree) ^ set(remote_tree)) + [
                k for k in local_tree if k in remote_tree and local_tree[k] != remote_tree[k]]
            check(not diff and "task_spans.jsonl" in local_tree,
                  f"daemon collect: differs from the in-process run in {diff}")
            got = remote(["terminate", "--runner", "sim:torch"])
            check(got["rc"] == 0 and "all jobs terminated" in got["out"],
                  f"daemon terminate: {got['out']} {got['err']}")
            row["process"] = {"verbs_lines": verbs, "files_compared": len(local_tree),
                              "ticks": sim["ticks"]}
            step("verbs")
        finally:
            proc.send_signal(signal.SIGTERM)
            try:
                rc = proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=10)
                rc = None
        check(rc == 0, f"daemon: SIGTERM exit {rc}: {log_tail()}")
        step("sigterm")

        # 2. an in-process daemon: its workers' launches count here
        env = EnvConfig.load(home=cli_home(root, "inproc"))
        env.daemon.scheduler.workers = 2
        daemon = Daemon(env=env, listen="127.0.0.1:0")
        daemon.start()
        client = Client(daemon.address)
        try:
            path = daemon_composition(root, "sustained-100k", 100_000, SUSTAINED)
            comp = load_composition(path).to_dict()

            def daemon_run(c, max_s=300, whole=True, poll_s=0.1):
                reset_launches()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                tid = client.run(c)
                # polled as the reference's client waits (`tg` follows the
                # log, its tests poll status), every 0.1 s
                t = _wait_done(client, tid, max_s, poll_s=poll_s)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                counts = read_launches()
                # a run cut to its first chunk ends before the plan does
                check(t["outcome"] == "success" or not whole,
                      f"daemon run {tid}: {t['error']}")
                check(all(v > 0 for v in counts.values()), f"daemon run: launches {counts}")
                for k, v in counts.items():
                    launches[k] += v
                return t, wall, counts

            daemon_run(comp)  # warm-up
            step("sustained_100k_warm_up")
            turns = {"daemon": [], "cli": [], "daemon_polled_10ms": []}
            ways = [("daemon", "cli") if i % 2 == 0 else ("cli", "daemon")
                    for i in range(DAEMON_TURNS)]
            # last, a daemon run whose client polls status every 10 ms from
            # this process: what a busy poller costs a run beside it
            for i, way in enumerate([w for pair in ways for w in pair]
                                    + ["daemon_polled_10ms"]):
                if way.startswith("daemon"):
                    t, wall, counts = daemon_run(
                        comp, poll_s=0.01 if way == "daemon_polled_10ms" else 0.1)
                    perf, journal = t["result"]["perf"], t["result"]["journal"]
                    states = [s["created"] for s in t["states"]]
                else:
                    got = cli_run(f"daemon sustained@100k cli turn {i}", client_home,
                                  ["run", "composition", "-f", path], launches)
                    perf, journal = got["task"].result["perf"], got["task"].result["journal"]
                    states = [s.created for s in got["task"].states]
                    wall, counts = got["wall"], got["launches"]
                runner_s = perf["runner_wall_secs"]["default"]
                ticks = journal["telemetry"]["rows"]  # the ticks that ran
                turns[way].append({
                    "wall_s": wall, "queued_secs": perf["queued_secs"],
                    # submit to the status that saw it complete
                    "outside_runner_ms": (wall - runner_s) * 1e3,
                    # the store's own stamps: scheduled to complete
                    "outside_runner_in_store_ms": (states[-1] - states[0] - runner_s) * 1e3,
                    "wall_ms_per_tick": wall / ticks * 1e3,
                    "ticks": ticks, "launches": counts})
            row["sustained_100k"] = {"n": 100_000, "turns": turns}
            step("sustained_100k_turns")

            # 3. two runs at once on the two workers, each as it runs alone
            faulted = load_composition(daemon_composition(
                root, "faulted-4096", 4096, SUSTAINED,
                faults=sustained_fault_tables(4096)[""])).to_dict()
            smoke_comp = load_composition(os.path.join(client_home, smoke_rel)).to_dict()
            alone = [_sim_flows(daemon_run(c)[0]) for c in (smoke_comp, faulted)]
            reset_launches()
            pair_ids = [client.run(c) for c in (smoke_comp, faulted)]
            pair = [_wait_done(client, tid, 300) for tid in pair_ids]
            for k, v in read_launches().items():
                launches[k] += v
            together = [_sim_flows(t) for t in pair]
            check(together == alone, f"daemon pair: {together} != alone {alone}")
            check(alone[1]["flows"]["msgs_fault_dropped"] > 0, "daemon pair: no fault drops")
            starts = [t["states"][1]["created"] for t in pair]
            ends = [t["states"][2]["created"] for t in pair]
            row["pair"] = {"overlap_s": min(ends) - max(starts),
                           "ticks": [f["ticks"] for f in together]}
            step("pair")

            # 4. /kill of a 10,000-tick run after its first chunk's row
            long_path = daemon_composition(
                root, "sustained-10k", 100_000,
                {**SUSTAINED, "duration_ticks": "10000"}, max_ticks=10_000)
            tid = client.run(load_composition(long_path).to_dict())
            rows = os.path.join(env.dirs.outputs(), "network", tid, "sim_timeseries.jsonl")
            t_end = time.monotonic() + 120
            while not (os.path.exists(rows) and os.path.getsize(rows) > 0):
                check(time.monotonic() < t_end, "daemon kill: no first chunk")
                time.sleep(0.01)
            with open(rows) as f:
                at_kill = sum(1 for _ in f)
            check(client.kill(tid), "daemon kill: not killed")
            t = _wait_done(client, tid, 120)
            ticks = t["result"]["journal"]["sim"]["ticks"]
            check(ticks < 10_000 and ticks - at_kill <= 2 * 250,
                  f"daemon kill: ran {ticks} ticks, {at_kill} rows at the kill")
            after = daemon_run(smoke_comp)[0]
            row["kill"] = {"rows_at_kill": at_kill, "ticks": ticks,
                           "state": t["states"][-1]["state"], "outcome": t["outcome"],
                           "run_outcome": t["result"]["journal"]["events"],
                           "next_run": after["outcome"]}
            step("kill")

            # 5. the chaos smoke on the CPU and on the card, through the daemon
            chaos = os.path.join(client_home, "plans", "chaos", "_compositions",
                                 "smoke.toml")
            runs = {}
            for dev in ("cuda", "cpu"):
                c = load_composition(chaos).to_dict()
                if dev == "cpu":
                    c["global"]["run_config"]["device"] = "cpu"
                tid = client.run(c)
                t = _wait_done(client, tid, 300)
                check(t["outcome"] == "success", f"daemon chaos {dev}: {t['error']}")
                rd = os.path.join(env.dirs.outputs(), "chaos", tid)
                res = dict(t["result"])
                res.pop("perf", None)
                res.pop("composition", None)
                res["journal"]["sim"] = {k: v for k, v in res["journal"]["sim"].items()
                                         if k not in SIM_SKIPPED}
                runs[dev] = (ids_out(read_run_dir(rd), tid, env.dirs.home),
                             ids_out(_strip(res), tid, env.dirs.home))
            (tg, jg), (tc, jc) = runs["cuda"], runs["cpu"]
            diff = sorted(set(tc) ^ set(tg)) + [k for k in tc if k in tg and tc[k] != tg[k]]
            diff += [k for k in jc if jc.get(k) != jg.get(k)]
            check(not diff, f"daemon chaos: CPU vs GPU differ in {diff}")
            row["chaos_parity"] = {"files_compared": len(tc)}
            step("chaos_parity")

            # kernels a tick and device ms/tick over the first chunk of a
            # chunk-64 twin (a run stops at whole chunks), through the daemon
            # and through the in-process CLI; profiled last
            first = daemon_composition(root, "sustained-100k-first", 100_000, SUSTAINED,
                                       chunk=DAEMON_PROFILE_TICKS,
                                       max_ticks=DAEMON_PROFILE_TICKS)
            first_comp = load_composition(first).to_dict()
            prof = {}
            for way, fn in (("daemon", lambda: daemon_run(first_comp, whole=False)),
                            ("cli", lambda: cli_call(client_home,
                                                     ["run", "composition", "-f", first]))):
                ms, kernels = _profiled(fn)
                prof[way] = {"ticks": DAEMON_PROFILE_TICKS,
                             "device_ms_per_tick": ms / DAEMON_PROFILE_TICKS,
                             "kernels_per_tick": kernels / DAEMON_PROFILE_TICKS}
            row["sustained_100k"]["profiled"] = prof
            step("profiled")
        finally:
            daemon.stop()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    row["launches"] = launches
    return row


# ---------------------------------------------------------------- admit

# one on/off pair (two once): part of the cut that pays for phase
# cohort's time
ADMIT_TURNS = 1
# the bad compositions of phase admit: cli@100k's composition with one
# change each, and the rule its 422 names
ADMIT_REFUSED = {
    "slo-without-telemetry": ("slo.needs-telemetry",
                              lambda c: (c["global"]["run_config"].update(telemetry=False),
                                         c["global"].update(run={"slo": [{
                                             "name": "keeps-delivering",
                                             "metric": "delivered_per_tick", "op": ">=",
                                             "threshold": 0.5}]}))),
    "transport-bogus": ("transport.unknown",
                        lambda c: c["global"]["run_config"].update(transport="bogus")),
    # a partition whose window ends before it starts
    "fault-inverted-window": ("faults.invalid",
                              lambda c: c["groups"][0]["run"].update(faults=[{
                                  "kind": "partition", "instances": "0:50000",
                                  "to_instances": "50000:100000", "start_ms": 100.0,
                                  "duration_ms": -50.0}])),
    # a cohort that resumes (the reference's checkpoint.resume-cohort); a
    # bucket mode the gate refuses
    "cohort-resume": ("checkpoint.resume-cohort",
                      lambda c: c["global"]["run_config"].update(
                          coordinator_address="127.0.0.1:1", num_processes=2,
                          resume_from="earlier")),
    "bucket-sideways": ("buckets.mode-invalid",
                        lambda c: c["global"]["run_config"].update(bucket="sideways")),
}


def _post(address, route, body) -> tuple:
    """``(status, parsed body)`` of one POST to a daemon on this host
    (``address`` as ``Daemon.address`` gives it, ``http://host:port``)."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(address + route, method="POST",
                                 data=json.dumps(body).encode())
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _refused_events(client) -> list:
    try:
        return [r for r in client.events() if r["type"] == "task.refused"]
    except Exception as e:  # noqa: BLE001 — a fresh daemon has no journal yet
        check("no events journal yet" in str(e), f"admit: events: {e}")
        return []


def phase_admit(card) -> dict:
    """Admission at submit and the perf ledger on the card: (a) an
    in-process ``Daemon`` on the card with one worker refuses cli@100k's
    composition with an SLO and no telemetry, an unknown transport, an
    inverted fault window, a two-process cohort that sets ``resume_from``
    and ``bucket = "sideways"``: a 422 naming the rule,
    no task, one ``task.refused`` event, no device memory allocated; (b)
    admits cli@100k's own composition, which launches K1 and K2 every tick
    and journals ``sim.perf`` (rows = chunks, Σ row walls = the execute
    wall, 100,000 instances, the transport that ran, the device peak above
    the carry and within the card); (c) ``execute_sim_run`` of its
    ``RunInput`` in turns with ``perf`` on and off: ms/tick, sync-debug
    syncs and launches a tick of each turn, then ops a tick of each
    (counted on the host) and kernels and device ms a tick
    (``torch.profiler``) — syncs, launches and ops equal; (d)
    ``profile_chunks = 1``: a Chrome trace naming the kernels; (e) ``tg
    check`` as a process on the port's smoke compositions, and
    ``check_composition`` in process."""
    import shutil
    import tempfile

    from testground_tpu_torch.api import load_composition
    from testground_tpu_torch.client import Client
    from testground_tpu_torch.config import EnvConfig
    from testground_tpu_torch.daemon import Daemon
    from testground_tpu_torch.sim.perf import PERF_FILE

    root = tempfile.mkdtemp(prefix="chip_smoke_admit_")
    launches = dict.fromkeys(KERNELS, 0)
    row = {"phase": "admit", "card": card, "step_s": {}}
    t_step = [time.perf_counter()]

    def step(name):
        now = time.perf_counter()
        row["step_s"][name] = now - t_step[0]
        t_step[0] = now

    def count(got, label):
        check(all(v > 0 for v in got.values()), f"admit {label}: launches {got}")
        for k, v in got.items():
            launches[k] += v

    try:
        # the healthcheck's K2 check (a launch compared with the plain
        # version, cached per card) made here, outside the counts
        from testground_tpu_torch.sim.runner import _kernel_check

        check(_kernel_check(torch.device("cuda", 0))[0], "admit: the K2 check")
        env = EnvConfig.load(home=cli_home(root, "daemon"))
        env.daemon.scheduler.workers = 1
        daemon = Daemon(env=env, listen="127.0.0.1:0")
        daemon.start()
        client = Client(daemon.address)
        path = daemon_composition(root, "sustained-100k", 100_000, SUSTAINED)
        try:
            # (a) five bad compositions, each refused before a queue slot
            refused = {}
            for name, (rule, edit) in ADMIT_REFUSED.items():
                comp = load_composition(path).to_dict()
                edit(comp)
                tasks, events = len(client.tasks()), len(_refused_events(client))
                torch.cuda.synchronize()
                mem = torch.cuda.memory_allocated()
                t0 = time.perf_counter()
                status, body = _post(daemon.address, "/run", {"composition": comp})
                rtt = time.perf_counter() - t0
                mem_after = torch.cuda.memory_allocated()
                new = _refused_events(client)[events:]
                check(status == 422 and f"[{rule}] " in body.get("error", ""),
                      f"admit {name}: {status} {body}")
                check(len(client.tasks()) == tasks, f"admit {name}: a task was queued")
                check(len(new) == 1 and new[0]["rules"][0] == rule,
                      f"admit {name}: task.refused {new}")
                check(mem_after == mem, f"admit {name}: {mem_after - mem} device bytes")
                refused[name] = {"status": status, "rules": new[0]["rules"],
                                 "round_trip_ms": rtt * 1e3, "device_bytes_added": 0}
            row["refused"] = refused
            step("refused")

            # (b) cli@100k's own composition: admitted, run, ledgered
            reset_launches()
            tid = client.run(load_composition(path).to_dict())
            t = _wait_done(client, tid, 300)
            got = read_launches()
            check(t["outcome"] == "success", f"admit run: {t['error']}")
            j = t["result"]["journal"]
            sim, perf = j["sim"], j["sim"].get("perf")
            ticks = j["telemetry"]["rows"]  # the ticks that ran
            check(perf is not None, f"admit run: no sim.perf in {sorted(sim)}")
            check(all(v == ticks for v in got.values()),
                  f"admit run: launches {got} over {ticks} ticks")
            count(got, "run")
            ex = perf["execute"]
            rows = [json.loads(ln) for ln in open(os.path.join(
                env.dirs.outputs(), "network", tid, PERF_FILE))]
            row_walls = sum(r["wall_secs"] for r in rows)
            check(perf["series"]["rows"] == ex["chunks"] == len(rows),
                  f"admit run: rows {perf['series']} chunks {ex['chunks']} file {len(rows)}")
            check(abs(row_walls - ex["wall_secs"]) <= 1e-5 * len(rows),
                  f"admit run: Σ row walls {row_walls} != {ex['wall_secs']}")
            check(perf["instances"] == 100_000
                  and perf["transport"] == sim["transport"]["resolved"] == "cuda",
                  f"admit run: {perf['instances']} {perf['transport']}")
            hbm = perf.get("hbm", {})
            check(sim["carry_bytes"] < hbm.get("peak_bytes", 0) <= hbm.get("bytes_limit", 0),
                  f"admit run: hbm {hbm} carry {sim['carry_bytes']}")
            row["admitted"] = {"ticks": ticks, "launches": got, "perf": perf,
                               "carry_bytes": sim["carry_bytes"],
                               "rows_wall_s": row_walls}
            step("admitted")
        finally:
            daemon.stop()

        # (c) the ledger on and off, in turns: syncs and kernels equal
        def exec_turn(perf_on, run_id):
            job = exec_job(run_id, root, "network", "pingpong-sustained", 100_000,
                           SUSTAINED, chunk=250, max_ticks=10_000, telemetry=True,
                           perf=perf_on)
            (out, wall, _), syncs = counted_syncs(lambda: run_exec(job))
            got = read_launches()
            count(got, f"perf={perf_on}")
            n_ticks = out.result.journal["telemetry"]["rows"]
            check(("perf" in out.result.journal["sim"]) == perf_on,
                  f"admit perf={perf_on}: sim.perf present")
            return {"perf": perf_on, "ticks": n_ticks, "wall_s": wall,
                    "ms_per_tick": wall / n_ticks * 1e3, "host_syncs": syncs,
                    "launches_per_tick": {k: v / n_ticks for k, v in got.items()}}

        turns = []
        for i in range(ADMIT_TURNS):
            order = (True, False) if i % 2 == 0 else (False, True)
            for perf_on in order:
                turns.append(exec_turn(perf_on, f"turn-{i}-{int(perf_on)}"))
        by = {on: [t for t in turns if t["perf"] is on] for on in (True, False)}
        check(len({t["host_syncs"] for t in turns}) == 1,
              f"admit: host syncs differ {[(t['perf'], t['host_syncs']) for t in turns]}")
        check(len({json.dumps(t["launches_per_tick"], sort_keys=True) for t in turns}) == 1,
              "admit: launches a tick differ")
        # kernels a tick: the ops each run dispatches, counted exactly on the
        # host, and the device's kernels as the profiler sees them (it
        # loses a varying few of a window's events, PERF.md §7)
        kernels = {}
        for perf_on in (True, False):
            def job(label):
                # two chunks of 32 ticks: the counts a tick do not need more
                return exec_job(f"{label}-{int(perf_on)}", root, "network",
                                "pingpong-sustained", 100_000, SUSTAINED, chunk=32,
                                max_ticks=64, telemetry=True, perf=perf_on)

            (out, _, _), n_ops = dispatched_ops(lambda: run_exec(job("ops")))
            count(read_launches(), f"ops perf={perf_on}")
            box = {}
            ms, n_kernels = _profiled(lambda: box.__setitem__("run", run_exec(job("prof"))))
            count(read_launches(), f"profiled perf={perf_on}")
            n_ticks = out.result.journal["telemetry"]["rows"]
            kernels[perf_on] = {"ticks": n_ticks, "ops_per_tick": n_ops / n_ticks,
                                "profiled_kernels_per_tick": n_kernels / n_ticks,
                                "device_ms_per_tick": ms / n_ticks}
        check(kernels[True]["ops_per_tick"] == kernels[False]["ops_per_tick"],
              f"admit: ops a tick differ {kernels}")
        row["perf_on_off"] = {
            "turns": turns,
            "ms_per_tick": {("on" if on else "off"): [t["ms_per_tick"] for t in by[on]]
                            for on in (True, False)},
            "median_ms_per_tick": {("on" if on else "off"):
                                   statistics.median(t["ms_per_tick"] for t in by[on])
                                   for on in (True, False)},
            "host_syncs": turns[0]["host_syncs"],
            "profiled": {("on" if on else "off"): kernels[on] for on in (True, False)},
        }
        step("perf_on_off")

        # (d) a bounded profiler capture names the kernels
        job = exec_job("profiled-chunk", root, "network", "pingpong-sustained", 100_000,
                       SUSTAINED, chunk=25, max_ticks=50, telemetry=True, profile=True,
                       profile_chunks=1)
        out, wall, run_dir = run_exec(job)
        count(read_launches(), "profile")
        from testground_tpu_torch.sim.executor import PROFILE_TRACE_FILE

        trace_path = os.path.join(run_dir, "profiles", PROFILE_TRACE_FILE)
        with open(trace_path) as f:
            names = {e.get("name", "") for e in json.load(f).get("traceEvents", [])}
        has = {k: any(k in nm for nm in names) for k in ("commit_k", "pop_vec_k",
                                                         "pop_scalar_k")}
        check(has["commit_k"] and (has["pop_vec_k"] or has["pop_scalar_k"]),
              f"admit profile: kernels {has} in {len(names)} event names")
        row["profile"] = {"journal": out.result.journal["profile"], "kernels": has,
                          "trace_bytes": os.path.getsize(trace_path), "wall_s": wall}
        step("profile")

        # (e) tg check: as a process on the smoke compositions, and in process
        here = os.path.dirname(os.path.abspath(__file__))
        from testground_tpu_torch.sim.executor import PLANS_ROOT

        smokes = [os.path.join(PLANS_ROOT, "network", "_compositions", "sustained-smoke.toml"),
                  os.path.join(PLANS_ROOT, "chaos", "_compositions", "smoke.toml")]
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "testground_tpu_torch.cli", "check", *smokes],
            cwd=here, capture_output=True, text=True, timeout=120,
            env={**os.environ, "PYTHONPATH": here,
                 "TESTGROUND_HOME": os.path.join(root, "check-home")})
        process_ms = (time.perf_counter() - t0) * 1e3
        check(proc.returncode == 0 and proc.stdout.count("ok (no findings)") == 2,
              f"admit check: exit {proc.returncode}: {proc.stdout} {proc.stderr[-2000:]}")
        from testground_tpu_torch.api import TestPlanManifest
        from testground_tpu_torch.sim.check import check_composition

        manifest = TestPlanManifest.load_file(os.path.join(PLANS_ROOT, "network",
                                                           "manifest.toml"))
        comp = load_composition(path)
        in_ms = []
        for _ in range(20):
            t0 = time.perf_counter()
            fs = check_composition(comp, manifest)
            in_ms.append((time.perf_counter() - t0) * 1e3)
        check(fs == [], f"admit check_composition: {fs}")
        row["check"] = {"process_ms": process_ms, "lines": proc.stdout.splitlines(),
                        "check_composition_ms": statistics.median(in_ms),
                        "check_composition_ms_range": [min(in_ms), max(in_ms)]}
        step("check")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    row["launches"] = launches
    return row


# ------------------------------------------------------------ observe

OBSERVE_TURNS = 2
# the phase ledger's extra ticks on the card: one warm-up, one counted,
# then phases_measure measured ones
OBSERVE_MEASURE = 30
OBSERVE_WAYS = ("alone", "watch", "top")

# `tg watch --json` against a daemon, in a process of its own, for each
# task ID it reads on its standard input; a marker line ends each
WATCHER = (
    "import sys\n"
    "from testground_tpu_torch.cli.main import main\n"
    "print('@@ready', flush=True)\n"
    "for line in sys.stdin:\n"
    "    rc = main(['--endpoint', sys.argv[1], 'watch', line.strip(), '--json'])\n"
    "    print(f'@@done {rc}', flush=True)\n"
)


def _lines(path) -> list:
    with open(path) as f:
        return f.read().splitlines()


def _wait_for(pred, what, deadline_s=120.0):
    t_end = time.monotonic() + deadline_s
    while not pred():
        check(time.monotonic() < t_end, f"observe: timed out waiting for {what}")
        time.sleep(0.05)


def run_ops(job) -> tuple:
    """``(run_exec(job), aten ops dispatched inside SimProgram.run)``: the
    run's own ticks only, not what the executor does after it."""
    from testground_tpu_torch.sim.engine import SimProgram

    orig = SimProgram.run
    box = {}

    def counted(self, *a, **kw):
        res, box["ops"] = dispatched_ops(lambda: orig(self, *a, **kw))
        return res

    SimProgram.run = counted
    try:
        out = run_exec(job)
    finally:
        SimProgram.run = orig
    return out, box["ops"]


def phase_observe(card) -> dict:
    """The read side of the observability plane on the card: (a)
    cli@100k's composition through ``execute_sim_run`` with ``phases =
    true, phases_measure = 30``: the rows of the reference's phases with
    telemetry, Σ phases + residual = whole exactly, K2's closed-form bytes
    in ``deliver`` and K1's in ``net_commit``, each phase's measured ms
    beside a ``PhaseTimer`` reading of the same program, a phases-off twin
    dispatching the same ops a tick, and the run again under ``transport =
    "auto", transport_probe = 30`` (its journaled scores); (b) the
    composition submitted to an in-process ``Daemon`` in turns alone, with
    a ``tg watch --json`` process following ``/stream`` (the rows it saw =
    the run directory's) and with a ``tg top --interval 2`` process on
    ``/fleet``: wall ms/tick of each; (c) the verbs through ``--endpoint``
    (``stats``, ``perf --phases``, ``perf --compare``, ``netmap``,
    ``trace``, ``status --telemetry``, ``top``, and ``diff`` of two of
    (b)'s runs with no mismatch in the counter planes), each exit 0 and
    allocating nothing on the card; (d) one row of (a) banked into
    ``chiprun_out/`` with its fingerprint."""
    import shutil
    import tempfile

    from testground_tpu_torch.api import load_composition
    from testground_tpu_torch.client import Client
    from testground_tpu_torch.config import EnvConfig
    from testground_tpu_torch.daemon import Daemon
    from testground_tpu_torch.engine.stream import STREAM_FAMILIES
    from testground_tpu_torch.sim import cuda_transport as ct

    here = os.path.dirname(os.path.abspath(__file__))
    root = tempfile.mkdtemp(prefix="chip_smoke_observe_")
    launches = dict.fromkeys(KERNELS, 0)
    row = {"phase": "observe", "card": card, "step_s": {}}
    t_step = [time.perf_counter()]

    def step(name):
        now = time.perf_counter()
        row["step_s"][name] = now - t_step[0]
        t_step[0] = now

    def count(got, label, ticks=None):
        check(all(v > 0 for v in got.values()), f"observe {label}: launches {got}")
        check(ticks is None or all(v == ticks for v in got.values()),
              f"observe {label}: launches {got} over {ticks} ticks")
        for k, v in got.items():
            launches[k] += v

    try:
        # (a) the phase ledger of cli@100k's composition
        job = exec_job("phases", root, "network", "pingpong-sustained", 100_000,
                       SUSTAINED, chunk=250, max_ticks=10_000, telemetry=True,
                       phases=True, phases_measure=OBSERVE_MEASURE)
        out, wall, run_dir = run_exec(job)
        sim = out.result.journal["sim"]
        ticks = out.result.journal["telemetry"]["rows"]
        count(read_launches(), "phases run", ticks + 2 + OBSERVE_MEASURE)
        block = sim["phases"]
        rows = {r["phase"]: r for r in block["phases"]}
        check(list(rows) == ["deliver", "lat_hist", "step", "sync", "net_commit",
                             "telemetry"], f"observe phases: rows {list(rows)}")
        for key, total in block["whole_per_tick"].items():
            parts = sum(r.get(key, 0) for r in rows.values()) + block["residual"][key]
            check(parts == total, f"observe phases: {key} Σ {parts} != whole {total}")
        prog = program("pingpong-sustained", 100_000, SUSTAINED, 250, telemetry=True)
        cal = prog.init_carry(0).cal
        occ = cal.occupancy_plane
        pop = ct.pop_bytes(occ.shape[1], cal.width, occ.dtype == torch.bool)
        kb = block.get("kernel_bytes", {})
        commit = kb.get("net_commit", {}).get("commit_calendar", 0)
        check(kb.get("deliver") == {"pop_bucket": pop},
              f"observe phases: K2 bytes {kb} against {pop}")
        check(commit > 0 and rows["net_commit"]["bytes_accessed"] >= commit
              and rows["deliver"]["bytes_accessed"] >= pop,
              f"observe phases: K1 bytes {kb}, rows {rows}")
        check(all(r["measured_reps"] == OBSERVE_MEASURE for r in rows.values()),
              f"observe phases: measured {rows}")
        timer = PhaseTimer()
        _, t_wall, t_ticks, _ = run_timed(prog, 250, timer=timer)
        count(read_launches(), "phase timer", t_ticks)
        del prog, cal, occ
        row["phases"] = {
            "block": block, "ticks": ticks, "wall_s": wall,
            "measured_ms": {p: r["measured_ms"] for p, r in rows.items()},
            "phase_timer_ms": timer.per_tick_ms(), "phase_timer_ticks": t_ticks,
            "phase_timer_wall_ms_per_tick": t_wall / t_ticks * 1e3,
            "pop_bytes": pop, "commit_bytes": commit,
        }
        step("phases")

        # the run's ops a tick with the ledger on and off (250 ticks each)
        ops = {}
        for on in (True, False):
            job = exec_job(f"ops-{int(on)}", root, "network", "pingpong-sustained",
                           100_000, SUSTAINED, chunk=125, max_ticks=250, telemetry=True,
                           phases=on)
            (out, _, _), n_ops = run_ops(job)
            n_ticks = out.result.journal["telemetry"]["rows"]
            count(read_launches(), f"ops phases={on}")
            check(("phases" in out.result.journal["sim"]) == on,
                  f"observe ops: sim.phases present {on}")
            ops[on] = n_ops / n_ticks
        check(ops[True] == ops[False], f"observe: ops a tick differ {ops}")
        row["ops_per_tick"] = {"phases_on": ops[True], "phases_off": ops[False]}
        step("ops")

        # the probe under transport = "auto"
        job = exec_job("probe", root, "network", "pingpong-sustained", 100_000, SUSTAINED,
                       chunk=250, max_ticks=250, telemetry=True, transport="auto",
                       transport_probe=OBSERVE_MEASURE)
        out, _, _ = run_exec(job)
        tr = out.result.journal["sim"]["transport"]
        count(read_launches(), "probe")
        check(tr["resolved"] == "cuda" and tr["scores"]["source"] == "measured"
              and tr["scores"]["reps"] == OBSERVE_MEASURE
              and tr["scores"].get("cuda_ms_per_tick", 0) > 0,
              f"observe probe: {tr}")
        row["probe"] = tr
        step("probe")

        # (b) the daemon alone, under a watcher and under top, in turns;
        # the healthcheck's K2 check (one launch compared with the plain
        # version, cached per card) made here, outside the counts
        from testground_tpu_torch.sim.engine import resolve_device
        from testground_tpu_torch.sim.runner import _kernel_check

        # the key the runner's healthcheck looks it up by: its run device
        check(_kernel_check(resolve_device(None))[0], "observe: the K2 check")
        env = EnvConfig.load(home=cli_home(root, "daemon"))
        env.daemon.scheduler.workers = 1
        daemon = Daemon(env=env, listen="127.0.0.1:0")
        daemon.start()
        client = Client(daemon.address)
        client_home = os.path.join(root, "client")
        os.makedirs(client_home)
        penv = {**os.environ, "PYTHONPATH": here, "TESTGROUND_HOME": client_home}
        watch_log = os.path.join(root, "watch.log")
        watcher = subprocess.Popen(
            [sys.executable, "-c", WATCHER, daemon.address], cwd=here, env=penv,
            stdin=subprocess.PIPE, stdout=open(watch_log, "w"),
            stderr=subprocess.STDOUT, text=True)
        procs = [watcher]
        try:
            path = daemon_composition(root, "sustained-100k", 100_000, SUSTAINED)
            comp = load_composition(path).to_dict()
            _wait_for(lambda: "@@ready" in _lines(watch_log), "the watcher to start")

            def turn(way, k):
                top = None
                if way == "top":
                    top_log = os.path.join(root, f"top-{k}.log")
                    top = subprocess.Popen(
                        [sys.executable, "-m", "testground_tpu_torch.cli", "--endpoint",
                         daemon.address, "top", "--interval", "2"], cwd=here, env=penv,
                        stdout=open(top_log, "w"), stderr=subprocess.STDOUT)
                    procs.append(top)
                    _wait_for(lambda: "workers" in "".join(_lines(top_log)),
                              "top's first view")
                reset_launches()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                tid = client.run(comp)
                if way == "watch":
                    watcher.stdin.write(tid + "\n")
                    watcher.stdin.flush()
                t = _wait_done(client, tid, 300, poll_s=0.1)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                check(t["outcome"] == "success", f"observe {way}: {t['error']}")
                j = t["result"]["journal"]
                n_ticks = j["telemetry"]["rows"]
                count(read_launches(), f"{way} turn", n_ticks)
                got = {"task": tid, "ticks": n_ticks, "wall_s": wall,
                       "wall_ms_per_tick": wall / n_ticks * 1e3,
                       "run_ms_per_tick": j["sim"]["wall_secs"] / n_ticks * 1e3}
                if way == "top":
                    top.terminate()
                    top.wait(timeout=30)
                    got["views"] = "".join(_lines(top_log)).count("workers")
                if way == "watch":
                    _wait_for(lambda: sum(ln.startswith("@@done")
                                          for ln in _lines(watch_log)) == k + 1,
                              "the watcher's end")
                return got

            turns = {w: [] for w in OBSERVE_WAYS}
            watched = 0
            for i in range(OBSERVE_TURNS):
                # the second turn runs alone only: the verbs' diff reads two
                # alone runs
                for way in OBSERVE_WAYS if i == 0 else ("alone",):
                    turns[way].append(turn(way, watched if way == "watch" else i))
                    watched += way == "watch"
            watcher.stdin.close()
            watcher.wait(timeout=60)
            check(watcher.returncode == 0, f"observe: watcher exit {watcher.returncode}")

            # the rows the watcher saw are the run directory's
            seen, k = {}, 0
            for ln in _lines(watch_log):
                if ln.startswith("@@done"):
                    check(ln == "@@done 0", f"observe: watch exit {ln}")
                    k += 1
                elif ln.startswith("{"):
                    r = json.loads(ln)
                    seen.setdefault(turns["watch"][k]["task"], []).append(r)
            for w in turns["watch"]:
                tid = w["task"]
                rdir = os.path.join(env.dirs.outputs(), "network", tid)
                n_rows = 0
                for fam, fname in STREAM_FAMILIES:
                    want = ([{"run": tid, **json.loads(ln)}
                             for ln in _lines(os.path.join(rdir, fname))]
                            if os.path.exists(os.path.join(rdir, fname)) else [])
                    got = [{k2: v for k2, v in r.items() if k2 != "stream"}
                           for r in seen.get(tid, []) if r["stream"] == fam]
                    check(got == want, f"observe watch {tid} {fam}: {len(got)} rows "
                          f"seen, {len(want)} in the run directory")
                    n_rows += len(want)
                w["rows_seen"] = n_rows
            med = {w: statistics.median(t["run_ms_per_tick"] for t in turns[w])
                   for w in OBSERVE_WAYS}
            spread = {w: [min(t["run_ms_per_tick"] for t in turns[w]),
                          max(t["run_ms_per_tick"] for t in turns[w])]
                      for w in OBSERVE_WAYS}
            row["pollers"] = {
                "turns": turns, "median_run_ms_per_tick": med, "range": spread,
                # a delta is resolved when the poller's turns all lie past
                # the alone turns' range
                "resolved": {w: (spread[w][0] > spread["alone"][1]
                                 or spread[w][1] < spread["alone"][0])
                             for w in ("watch", "top")},
            }
            step("pollers")

            # (c) the verbs through --endpoint
            obs = daemon_composition(root, "observed-100k", 100_000,
                                     {**SUSTAINED, "duration_ticks": "250"},
                                     cfg="netmatrix = true\nphases = true")
            with open(obs, "a") as f:
                f.write('\n[groups.run.trace]\ninstances = "0:64"\n')
            reset_launches()
            tid = client.run(load_composition(obs).to_dict())
            t = _wait_done(client, tid, 300, poll_s=0.1)
            check(t["outcome"] == "success", f"observe verbs run: {t['error']}")
            count(read_launches(), "verbs run")
            a, b = turns["alone"][0]["task"], turns["alone"][1]["task"]
            cmp_file = os.path.join(root, "perf-b.json")
            got = cli_call(client_home, ["--endpoint", daemon.address, "perf", b, "--json"])
            check(got["rc"] == 0, f"observe perf --json: {got['err']}")
            with open(cmp_file, "w") as f:
                f.write(got["out"])
            verbs = {
                "stats": (["stats", tid], "messages"),
                "perf --phases": (["perf", tid, "--phases"], "net_commit"),
                "perf --compare": (["perf", a, "--compare", cmp_file], "peer·ticks/s"),
                "netmap": (["netmap", tid], "conservation"),
                "trace": (["trace", tid, "-n", "20"], "trace: "),
                "status --telemetry": (["status", "-t", tid, "--telemetry"], "Telemetry:"),
                "top": (["top", "--no-follow"], "workers"),
                "diff": (["diff", a, b, "--json"], '"verdict"'),
            }
            verb_rows = {}
            for name, (argv, want) in verbs.items():
                torch.cuda.synchronize()
                mem = torch.cuda.memory_allocated()
                got = cli_call(client_home, ["--endpoint", daemon.address, *argv])
                check(got["rc"] == 0 and want in got["out"],
                      f"observe {name}: exit {got['rc']}: {got['out'][-800:]} "
                      f"{got['err'][-800:]}")
                check(torch.cuda.memory_allocated() == mem,
                      f"observe {name}: device bytes allocated")
                verb_rows[name] = {"ms": got["wall"] * 1e3,
                                   "lines": len(got["out"].splitlines())}
                if name == "diff":
                    doc = json.loads(got["out"])
                    for plane in ("counters", "latency"):
                        check(doc[plane]["mismatched"] == 0,
                              f"observe diff: {plane} {doc[plane]}")
                    check(doc["setup"]["identical"] and not doc["findings"],
                          f"observe diff: {doc['setup']} {doc['findings']}")
                    verb_rows[name].update(verdict=doc["verdict"],
                                           compared=doc["counters"]["compared"])
            row["verbs"] = verb_rows
            step("verbs")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait(timeout=10)
            daemon.stop()

        # (d) one row of (a) in the port's bench bank
        from testground_tpu_torch.analysis.bench_history import (
            HISTORY_FILE,
            bank_row,
            env_fingerprint,
        )

        fp = env_fingerprint()
        check(fp.get("device_kind") == card["name"] and "jax" not in fp,
              f"observe bank: fingerprint {fp}")
        os.makedirs(os.path.join(here, "chiprun_out"), exist_ok=True)
        banked = bank_row(os.path.join(here, "chiprun_out", HISTORY_FILE), {
            "workload": "cli@100k", "instances": 100_000, "transport": "cuda", "mesh": "",
            # the ticks that ran over the run's wall: the perf ledger's
            # steady rate counts whole chunks, and this run ends one tick
            # into its third
            "metric": "peer_ticks_per_sec", "value": 100_000 * ticks / sim["wall_secs"],
            "ts": time.time(), "fingerprint": fp,
            "phases_measured_ms": row["phases"]["measured_ms"],
        })
        print("bank fingerprint: " + json.dumps(banked["fingerprint"], sort_keys=True),
              flush=True)
        row["bank"] = {"file": f"chiprun_out/{HISTORY_FILE}", "row": banked}
        step("bank")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    row["launches"] = launches
    return row


# ------------------------------------------------------------ surface

# one turn (three once, then two), for the script's time limit
SURFACE_TURNS = 1
SURFACE_WAYS = ("alone", "metrics", "dashboard")
# the sustained plan at 1M instances under a 512 MiB budget: its carry
# (321 MiB) × the executor's 2.5 headroom does not fit
SURFACE_LIMIT = 512 * 2**20

# a poller of the daemon at `address`, in a process of its own: while the
# control file holds a task ID it GETs its route every second (/metrics, or
# that task's dashboard page) and logs each answer; "exit" ends it
POLLER = (
    "import json, sys, time, urllib.request\n"
    "address, kind, ctl, log = sys.argv[1:5]\n"
    "out = open(log, 'a')\n"
    "print('@@ready', file=out, flush=True)\n"
    "while True:\n"
    "    tid = open(ctl).read().strip()\n"
    "    if tid == 'exit':\n"
    "        break\n"
    "    if not tid:\n"
    "        time.sleep(0.05)\n"
    "        continue\n"
    "    route = '/metrics' if kind == 'metrics' else '/dashboard?task_id=' + tid\n"
    "    t0 = time.perf_counter()\n"
    "    with urllib.request.urlopen(address + route, timeout=60) as r:\n"
    "        code, size = r.status, len(r.read())\n"
    "    ms = (time.perf_counter() - t0) * 1e3\n"
    "    print(json.dumps({'task': tid, 'code': code, 'bytes': size, 'ms': ms}),\n"
    "          file=out, flush=True)\n"
    "    time.sleep(max(0.0, 1.0 - ms / 1e3))\n"
)


def _scrape(address) -> tuple:
    """``(ms, text, families)`` of one GET /metrics; every line is a HELP, a
    TYPE or a ``name{labels} value`` sample with a finite value (format
    0.0.4)."""
    import math
    import re
    import urllib.request

    t0 = time.perf_counter()
    with urllib.request.urlopen(address + "/metrics", timeout=60) as r:
        ctype = r.headers.get("Content-Type")
        text = r.read().decode()
    ms = (time.perf_counter() - t0) * 1e3
    check(ctype == "text/plain; version=0.0.4; charset=utf-8", f"surface: /metrics {ctype}")
    fams = {}
    for ln in text.splitlines():
        if not ln or ln.startswith(("# HELP ", "# TYPE ")):
            continue
        m = re.match(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})? (\S+)$', ln)
        check(m is not None and math.isfinite(float(m[3])), f"surface: /metrics line {ln!r}")
        fams.setdefault(m[1], []).append((m[2] or "", float(m[3])))
    return ms, text, fams


def _get(address, route) -> tuple:
    """``(status, location, body, ms)`` of one GET, redirects not followed."""
    import urllib.error
    import urllib.request

    class NoRedirect(urllib.request.HTTPRedirectHandler):
        def redirect_request(self, *a, **k):
            return None

    t0 = time.perf_counter()
    try:
        with urllib.request.build_opener(NoRedirect).open(address + route, timeout=60) as r:
            got = (r.status, r.headers.get("Location"), r.read())
    except urllib.error.HTTPError as e:
        got = (e.code, e.headers.get("Location"), e.read())
    return (*got, (time.perf_counter() - t0) * 1e3)


def phase_surface(card) -> dict:
    """The user-facing surfaces of the daemon and ``tg check`` on the card:
    (a) ``tg check --trace-plans`` as processes — the smoke compositions and
    cli@100k's with the card visible (exit 0, no ``plan.*`` finding), and
    with no card visible plus sustained@1M under a 512 MiB
    ``memory_limit_bytes`` (exit 1, ``plan.memory`` alone, the executor's
    words) — and the same in process: the allocator's counters unchanged,
    K1 and K2 never launched; (b) ``python -m testground_tpu_torch.cli
    daemon`` in an empty home: ``plan import`` of the port's network plan
    under a new name through ``--endpoint`` (a tar.gz to ``/plan/import``),
    ``plan list --testcases``, ``describe``, ``run single
    network-imported:ping-pong -i 100000`` to all SUCCESS on the card (its
    journal's transport ``cuda``; its phase ledger holds K1's and K2's
    closed-form bytes, which only a launch reports), ``plan rm``; (c) that
    daemon's ``/metrics`` (format 0.0.4, the run's flow identity, Σ
    ``tg_fleet_tasks`` = ``tg_scrape_tasks_total``), ``/``, ``/dashboard``,
    the run's page and ``/data`` (its rows = the viewer's); (d) cli@100k's
    composition through an in-process ``Daemon`` (one worker) in two
    rotated turns alone, under a process GETting ``/metrics`` every second
    and under one GETting the run's dashboard page every second: run
    ms/tick of each; then a turn's page and ``/data`` rows against the
    viewer's over its run directory."""
    import re
    import shutil
    import signal
    import socket
    import tempfile

    from testground_tpu_torch.api import TestPlanManifest, load_composition
    from testground_tpu_torch.client import Client
    from testground_tpu_torch.config import EnvConfig
    from testground_tpu_torch.daemon import Daemon
    from testground_tpu_torch.metrics import Viewer
    from testground_tpu_torch.sim.check import check_composition
    from testground_tpu_torch.sim.engine import resolve_device
    from testground_tpu_torch.sim.executor import PLANS_ROOT
    from testground_tpu_torch.sim.runner import _kernel_check

    here = os.path.dirname(os.path.abspath(__file__))
    root = tempfile.mkdtemp(prefix="chip_smoke_surface_")
    launches = dict.fromkeys(KERNELS, 0)
    row = {"phase": "surface", "card": card, "step_s": {}}
    t_step = [time.perf_counter()]

    def step(name):
        now = time.perf_counter()
        row["step_s"][name] = now - t_step[0]
        t_step[0] = now

    procs = []
    daemon = None
    try:
        # the in-process daemon of (d) and its two pollers, idle until a
        # turn names its task: they start while (a)-(c) run
        check(_kernel_check(resolve_device(None))[0], "surface: the K2 check")
        env = EnvConfig.load(home=cli_home(root, "inproc"))
        env.daemon.scheduler.workers = 1
        daemon = Daemon(env=env, listen="127.0.0.1:0")
        daemon.start()
        penv = {**os.environ, "PYTHONPATH": here}
        pollers = {}
        for way in SURFACE_WAYS[1:]:
            ctl, log = (os.path.join(root, f"{way}.{x}") for x in ("ctl", "log"))
            open(ctl, "w").close()
            open(log, "w").close()
            procs.append(subprocess.Popen(
                [sys.executable, "-c", POLLER, daemon.address, way, ctl, log], cwd=here,
                env=penv, stdout=subprocess.DEVNULL, stderr=open(log + ".err", "w")))
            pollers[way] = (ctl, log)

        # (a) tg check --trace-plans, as processes and in process. The
        # processes, and (b)'s daemon process, start together: the first
        # meta op of each pays torch's meta kernels' import
        from concurrent.futures import ThreadPoolExecutor

        smokes = [os.path.join(PLANS_ROOT, "network", "_compositions", "sustained-smoke.toml"),
                  os.path.join(PLANS_ROOT, "chaos", "_compositions", "smoke.toml")]
        cli100k = daemon_composition(root, "sustained-100k", 100_000, SUSTAINED)
        big = daemon_composition(root, "sustained-1m", 1_000_000, SUSTAINED, max_ticks=64,
                                 cfg=f"memory_limit_bytes = {SURFACE_LIMIT}")
        # layer 2 wants no card: a process that sees one never initialises it
        probe = ("import sys, torch\n"
                 "from testground_tpu_torch.api import load_composition, TestPlanManifest\n"
                 "from testground_tpu_torch.sim.check import check_composition\n"
                 "comp = load_composition(sys.argv[1])\n"
                 "m = TestPlanManifest.load_file(sys.argv[2] + '/manifest.toml')\n"
                 "fs = check_composition(comp, m, trace_plans=True, plan_sources=sys.argv[2])\n"
                 "print([f.rule for f in fs], torch.cuda.is_initialized())\n")
        calls = {
            "card": ["-m", "testground_tpu_torch.cli", "check", "--trace-plans", "--json",
                     *smokes, cli100k],
            "no-card": ["-m", "testground_tpu_torch.cli", "check", "--trace-plans", "--json",
                        *smokes, cli100k, big],
            "no-context": ["-c", probe, big, os.path.join(PLANS_ROOT, "network")],
        }

        def timed(name):
            t0 = time.perf_counter()
            got = subprocess.run(
                [sys.executable, *calls[name]], cwd=here, capture_output=True, text=True,
                timeout=180, env={**penv, "TESTGROUND_HOME": cli_home(root, f"check-{name}"),
                                  **({"CUDA_VISIBLE_DEVICES": ""} if name == "no-card"
                                     else {})})
            return got, time.perf_counter() - t0

        # (b)'s daemon, in an empty home
        home = os.path.join(root, "daemon")
        os.makedirs(home)
        open(os.path.join(home, ".env.toml"), "w").close()
        client_home = os.path.join(root, "client")
        os.makedirs(client_home)
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        ep = f"http://127.0.0.1:{port}"
        log_path = os.path.join(root, "daemon.log")
        proc = subprocess.Popen(
            [sys.executable, "-m", "testground_tpu_torch.cli", "daemon", "--listen",
             f"127.0.0.1:{port}"], cwd=here, stdout=open(log_path, "w"),
            stderr=subprocess.STDOUT, env={**penv, "TESTGROUND_HOME": home})
        procs.append(proc)
        with ThreadPoolExecutor(len(calls)) as pool:
            futures = {name: pool.submit(timed, name) for name in calls}
            in_proc = {}
            manifests = {p: TestPlanManifest.load_file(
                os.path.join(PLANS_ROOT, p, "manifest.toml")) for p in ("network", "chaos")}
            for path in smokes + [cli100k, big]:
                comp = load_composition(path)
                plan = comp.global_.plan
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                mem = torch.cuda.memory_allocated()
                reset_launches()
                t0 = time.perf_counter()
                fs = check_composition(comp, manifests[plan], trace_plans=True,
                                       plan_sources=os.path.join(PLANS_ROOT, plan))
                ms = (time.perf_counter() - t0) * 1e3
                torch.cuda.synchronize()
                check(torch.cuda.memory_allocated() == mem
                      and torch.cuda.max_memory_allocated() == mem,
                      f"surface check {path}: device bytes allocated")
                check(read_launches() == dict.fromkeys(KERNELS, 0),
                      f"surface check {path}: launches {read_launches()}")
                check([f.rule for f in fs] == (["plan.memory"] if path == big else []),
                      f"surface check {path}: {fs}")
                in_proc[os.path.basename(path)] = ms
            done = {name: f.result() for name, f in futures.items()}
        checks = {}
        for name, (got, wall) in done.items():
            want_rc = 1 if name == "no-card" else 0
            check(got.returncode == want_rc,
                  f"surface check {name}: exit {got.returncode}: {got.stdout[-2000:]} "
                  f"{got.stderr[-2000:]}")
            checks[name] = {"wall_s": wall}
            if name == "no-context":
                check(got.stdout.strip() == "['plan.memory'] False",
                      f"surface check: the no-context probe: {got.stdout}")
                continue
            doc = json.loads(got.stdout)
            found = {c["file"]: [f["rule"] for f in c["findings"]] for c in doc["compositions"]}
            check(all(v == [] for f, v in found.items() if f != big),
                  f"surface check {name}: findings {found}")
            checks[name]["files"] = len(found)
            if big in found:
                fs = [f for c in doc["compositions"] if c["file"] == big
                      for f in c["findings"]]
                check([f["rule"] for f in fs] == ["plan.memory"]
                      and "composition needs ~" in fs[0]["message"]
                      and "but the device budget is 0.50 GiB" in fs[0]["message"],
                      f"surface check {name}: {fs}")
                row["memory_finding"] = fs[0]["message"]
        row["check"] = {"process": checks, "in_process_ms": in_proc}
        step("check")

        # (b) plan import through the daemon process
        client = Client(ep)
        _wait_for(lambda: _answers(client, proc, log_path), "the daemon process", 120)

        def remote(argv, want_rc=0):
            got = cli_call(client_home, ["--endpoint", ep, *argv])
            check(got["rc"] == want_rc, f"surface {argv[:2]}: exit {got['rc']}: "
                  f"{got['out'][-1500:]} {got['err'][-1500:]}")
            return got

        verbs = {}
        got = remote(["plan", "import", "--from", os.path.join(PLANS_ROOT, "network"),
                      "--name", "network-imported"])
        check(got["out"].strip() == f"imported plan network-imported into daemon at {ep}",
              f"surface import: {got['out']}")
        verbs["plan import"] = got["wall"] * 1e3
        got = cli_call(home, ["plan", "list", "--testcases"])
        check(got["rc"] == 0 and "network-imported:pingpong-sustained" in got["out"],
              f"surface plan list: {got['out']}")
        verbs["plan list"] = got["wall"] * 1e3
        got = remote(["describe", "network-imported:pingpong-sustained"])
        check("pingpong-sustained" in got["out"], f"surface describe: {got['out']}")
        verbs["describe"] = got["wall"] * 1e3
        got = remote(["run", "single", "network-imported:ping-pong", "-i", "100000",
                      "--run-cfg", "telemetry=true", "--run-cfg", "phases=true"])
        tid = re.search(r"run is queued with ID: (\S+)", got["out"])[1]
        task = client.status(tid)
        sim = task["result"]["journal"]["sim"]
        check(task["outcome"] == "success" and sim["transport"]["resolved"] == "cuda",
              f"surface run: {task['outcome']} {sim.get('transport')} {task['error']}")
        # the phase ledger's kernel bytes: the K1 and K2 wrappers report them
        # only where they launch their kernel, never from the plain versions
        kb = sim["phases"].get("kernel_bytes", {})
        has = {"commit_calendar": kb.get("net_commit", {}).get("commit_calendar", 0),
               "pop_bucket": kb.get("deliver", {}).get("pop_bucket", 0)}
        check(all(v > 0 for v in has.values()), f"surface run: kernel bytes {kb}")
        row["imported_run"] = {"task": tid, "ticks": sim["ticks"], "wall_s": got["wall"],
                               "transport": sim["transport"], "kernels": has,
                               "instances": task["result"]["journal"]["events"]}
        step("import_run")

        # (c) the scrape and the pages of that daemon
        scrapes = [_scrape(ep) for _ in range(5)]
        _, text, fams = scrapes[-1]
        flows = {re.search(r'flow="(\w+)"', lbl)[1]: v
                 for lbl, v in fams["tg_run_msgs_total"] if f'task="{tid}"' in lbl}
        check(flows["sent"] > 0 and flows["sent"] == flows["delivered"]
              + flows["in_flight"] + flows["dropped"] + flows["rejected"]
              + flows["fault_dropped"], f"surface /metrics: flows {flows}")
        total = fams["tg_scrape_tasks_total"][0][1]
        check(sum(v for _, v in fams["tg_fleet_tasks"]) == total,
              f"surface /metrics: fleet {fams['tg_fleet_tasks']} against {total}")
        row["scrape"] = {"ms": [s[0] for s in scrapes], "tasks": total,
                         "families": len(fams), "bytes": len(text), "flows": flows}
        pages = {}
        code, where, body, ms = _get(ep, "/")
        check(code == 302 and where == "/dashboard", f"surface /: {code} {where}")
        pages["/"] = ms
        for route in ("/dashboard", f"/dashboard?task_id={tid}"):
            code, _, body, ms = _get(ep, route)
            check(code == 200 and tid.encode() in body, f"surface {route}: {code}")
            pages[route.split("=")[0]] = ms
        # a plan imported under another name runs under its manifest's
        # name (as in the reference): the run directory is outputs/network/,
        # the task's page and /data read outputs/network-imported/, empty
        code, _, body, ms = _get(ep, f"/data?task_id={tid}&metric=sim.delivered")
        want = [r.to_dict() for r in Viewer(EnvConfig.load(home=home)).get_data(
            "network-imported", "ping-pong", "sim.delivered", run_id=tid)]
        check(code == 200 and json.loads(body)["rows"] == want,
              f"surface /data: {code} {body[:300]}")
        pages["/data"] = ms
        row["pages_ms"] = pages
        row["verbs_ms"] = verbs
        got = cli_call(home, ["plan", "rm", "network-imported"])
        check(got["rc"] == 0 and not os.path.exists(os.path.join(home, "plans",
                                                                 "network-imported")),
              f"surface plan rm: {got['out']} {got['err']}")
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=60)
        step("scrape_pages")

        # (d) what the pollers cost a run
        for way, (_, log) in pollers.items():
            _wait_for(lambda: "@@ready" in _lines(log), f"the {way} poller", 120)
        comp = load_composition(cli100k).to_dict()
        dclient = Client(daemon.address)

        def turn(way):
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tid = dclient.run(comp)
            if way in pollers:
                with open(pollers[way][0], "w") as f:
                    f.write(tid)
            t = _wait_done(dclient, tid, 300, poll_s=0.1)
            if way in pollers:
                open(pollers[way][0], "w").close()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            check(t["outcome"] == "success", f"surface {way}: {t['error']}")
            j = t["result"]["journal"]
            n_ticks = j["telemetry"]["rows"]
            got = read_launches()
            check(all(v == n_ticks for v in got.values()),
                  f"surface {way}: launches {got} over {n_ticks} ticks")
            for k, v in got.items():
                launches[k] += v
            out = {"task": tid, "ticks": n_ticks, "wall_s": wall,
                   "run_ms_per_tick": j["sim"]["wall_secs"] / n_ticks * 1e3}
            if way in pollers:
                gets = [json.loads(ln) for ln in _lines(pollers[way][1])
                        if ln.startswith("{") and json.loads(ln)["task"] == tid]
                check(gets and all(g["code"] == 200 for g in gets),
                      f"surface {way}: poller answers {gets[-3:]}")
                out["gets"] = len(gets)
                out["get_ms"] = statistics.median(g["ms"] for g in gets)
            return out

        turns = {w: [] for w in SURFACE_WAYS}
        for i in range(SURFACE_TURNS):
            for way in SURFACE_WAYS[i:] + SURFACE_WAYS[:i]:
                turns[way].append(turn(way))
        med = {w: statistics.median(t["run_ms_per_tick"] for t in turns[w])
               for w in SURFACE_WAYS}
        spread = {w: [min(t["run_ms_per_tick"] for t in turns[w]),
                      max(t["run_ms_per_tick"] for t in turns[w])] for w in SURFACE_WAYS}
        row["pollers"] = {
            "turns": turns, "median_run_ms_per_tick": med, "range": spread,
            "delta_pct": {w: (med[w] / med["alone"] - 1) * 100 for w in SURFACE_WAYS[1:]},
            # resolved: every turn of the poller past the alone turns' range
            "resolved": {w: (spread[w][0] > spread["alone"][1]
                             or spread[w][1] < spread["alone"][0])
                         for w in SURFACE_WAYS[1:]},
        }
        ms, _, fams = _scrape(daemon.address)
        row["scrape_inproc"] = {"ms": ms, "tasks": fams["tg_scrape_tasks_total"][0][1]}
        # the pages of a run with every series: the last turn alone
        tid = turns["alone"][-1]["task"]
        code, _, body, ms = _get(daemon.address, f"/dashboard?task_id={tid}")
        check(code == 200 and b"<h2>results.network-pingpong-sustained.sim.delivered</h2>"
              in body, f"surface task page: {code}")
        pages = {"/dashboard?task_id": ms, "bytes": len(body)}
        viewer = Viewer(env)
        for metric in ("sim.delivered", "sim.perf.peer_ticks_per_sec"):
            code, _, body, ms = _get(daemon.address, f"/data?task_id={tid}&metric={metric}")
            want = [r.to_dict() for r in viewer.get_data("network", "pingpong-sustained",
                                                          metric, run_id=tid)]
            check(code == 200 and json.loads(body)["rows"] == want and want,
                  f"surface /data {metric}: {code} {body[:300]}")
            pages[f"/data {metric}"] = ms
        row["pages_inproc_ms"] = pages
        step("pollers")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
        if daemon is not None:
            daemon.stop()
        shutil.rmtree(root, ignore_errors=True)
    row["launches"] = launches
    return row


def _answers(client, proc, log_path) -> bool:
    """The daemon process answers ``/tasks`` (it must not have exited)."""
    if proc.poll() is not None:
        with open(log_path) as f:
            check(False, f"surface: the daemon exited: {f.read()[-3000:]}")
    try:
        client.tasks()
        return True
    except OSError:
        return False


# ---------------------------------------------------------------- resume

# one turn (three once, then two), for the script's time limit
RESUME_TURNS = 1


def _run_points(run_dir) -> list:
    """The ``checkpoint`` and ``resume`` span points of a run directory."""
    with open(os.path.join(run_dir, "run_spans.jsonl")) as f:
        events = [json.loads(ln)["event"] for ln in f if ln.strip()]
    return [e for e in events
            if e["type"] == "point" and e["span"] in ("checkpoint", "resume")]


def _series(run_dir) -> list:
    with open(os.path.join(run_dir, "sim_timeseries.jsonl")) as f:
        return [{k: v for k, v in json.loads(ln).items() if k != "run"} for ln in f]


def _same_end(label, full, full_dir, other, other_dir) -> int:
    """``other`` ended as ``full`` did: the journal's flow totals, latency,
    matrix and telemetry blocks, the telemetry stream row for row, and the
    final carry (each run's newest snapshot is taken at its last chunk's
    end) leaf for leaf. Returns the leaves compared."""
    from testground_tpu_torch.sim.checkpoint import load_latest

    jf, jo = full.result.journal, other.result.journal
    keys = [k for k in jf["sim"] if k.startswith("msgs_") or k.startswith("faults_")]
    diff = [k for k in keys + ["ticks", "latency", "net_matrix"]
            if jf["sim"].get(k) != jo["sim"].get(k)]
    diff += [k for k in ("telemetry", "events") if jf.get(k) != jo.get(k)]
    check(not diff, f"resume {label}: the journal differs in {diff}")
    check(_series(full_dir) == _series(other_dir), f"resume {label}: telemetry stream")
    mf, lf, _ = load_latest(full_dir)
    mo, lo, _ = load_latest(other_dir)
    check(mf["tick"] == mo["tick"] and len(lf) == len(lo)
          and all(a.dtype == b.dtype and np.array_equal(a, b) for a, b in zip(lf, lo)),
          f"resume {label}: the final carry differs")
    return len(lf)


def phase_resume(card) -> dict:
    """The checkpoint plane and the fleet controller on the card:

    1. sustained@100k at phase 4's parameters through ``execute_sim_run``
       (telemetry on): with ``checkpoint_chunks = 1`` each snapshot's bytes,
       D2H ms and write ms and no write error; ms/tick with the knob at 1
       and at 0, one turn; with the knob at 0 the ops and the
       sync-debug syncs of a chunk equal a run's without the key;
    2. a run cut at tick 250 and resumed from its snapshot equal to the
       uninterrupted card run (journal, telemetry stream, final carry),
       with the resume's load and restore ms;
    3. the faulted sustained at 4,096 (phase ``parity``'s) snapshotted on
       the CPU at tick 250 and resumed on the card, equal to the card's
       uninterrupted run;
    4. an in-process daemon with one worker and cli@100k's composition with
       ``checkpoint_chunks = 1``: ``POST /preempt`` after its first
       snapshot (ms to the requeue and to completion), a priority-1
       arrival evicting a priority-0 run, ``POST /drain`` of a running
       task (preempted and parked) and of an idle daemon; each resumed run
       equal to the uninterrupted one;
    5. sustained@1M, 64 ticks, chunk 32, ``checkpoint_chunks = 1``: snapshot
       bytes, D2H and write ms, and the restore ms of a resume."""
    import shutil
    import tempfile

    from testground_tpu_torch.api import load_composition
    from testground_tpu_torch.client import Client
    from testground_tpu_torch.config import EnvConfig
    from testground_tpu_torch.daemon import Daemon
    from testground_tpu_torch.sim.checkpoint import list_snapshots, load_latest

    root = tempfile.mkdtemp(prefix="chip_smoke_resume_")
    launches = dict.fromkeys(KERNELS, 0)
    row = {"phase": "resume", "card": card, "step_s": {}}
    t_step = [time.perf_counter()]

    def step(name):
        now = time.perf_counter()
        row["step_s"][name] = now - t_step[0]
        t_step[0] = now

    def counted(label, ran=True):
        counts = read_launches()
        check(not ran or all(v > 0 for v in counts.values()),
              f"resume {label}: launches {counts}")
        for k, v in counts.items():
            launches[k] += v

    def sustained(run_id, n=100_000, params=SUSTAINED, device="cuda", ran=True, **cfg):
        cfg = {"chunk": 250, "max_ticks": 10_000, "telemetry": True, **cfg}
        out, wall, rd = run_exec(exec_job(run_id, root, "network", "pingpong-sustained",
                                          n, params, device=device, **cfg))
        if device == "cuda":
            counted(run_id, ran)
        return out, wall, rd

    def snapshots_of(rd) -> dict:
        pts = [p for p in _run_points(rd) if p["span"] == "checkpoint"]
        return {"ticks": [p["tick"] for p in pts], "bytes": [p["bytes"] for p in pts],
                "d2h_ms": [p["d2h_ms"] for p in pts], "write_ms": [p["write_ms"] for p in pts]}

    def resume_point(rd) -> dict:
        pts = [p for p in _run_points(rd) if p["span"] == "resume"]
        check(len(pts) == 1, f"resume: {rd} has {len(pts)} resume points")
        return {k: pts[0][k] for k in ("from_tick", "from_run", "load_ms", "restore_ms")}

    try:
        # 1. the snapshot's cost on sustained@100k
        sustained("warm-up")
        step("warm_up")
        ms = {"off": [], "on": []}
        full = None
        for i in range(RESUME_TURNS):
            for way in (("off", "on") if i % 2 == 0 else ("on", "off")):
                rid = f"{way}-{i}"
                out, wall, rd = sustained(rid, **({"checkpoint_chunks": 1} if way == "on"
                                                  else {}))
                check(out.result.outcome.value == "success", f"resume {rid}: outcome")
                ms[way].append(wall / out.result.journal["telemetry"]["rows"] * 1e3)
                if way == "on":
                    ck = out.result.journal["sim"]["checkpoint"]
                    check(ck["count"] >= 2 and "errors" not in ck,
                          f"resume {rid}: sim.checkpoint {ck}")
                    if full is None:
                        full = (out, rd)
                        row["snapshots_100k"] = snapshots_of(rd)
                    else:
                        shutil.rmtree(rd)
        row["ms_per_tick_100k"] = {
            **ms, "median_off": statistics.median(ms["off"]),
            "median_on": statistics.median(ms["on"]),
            "delta": statistics.median(ms["on"]) - statistics.median(ms["off"]),
        }
        step("turns")

        def ops_syncs(rid, **cfg):
            job = exec_job(rid, root, "network", "pingpong-sustained", 100_000, SUSTAINED,
                           chunk=250, max_ticks=250, telemetry=True, **cfg)
            ((_, _, _), ops), syncs = counted_syncs(lambda: dispatched_ops(
                lambda: run_exec(job)))
            counted(rid)
            return ops / 250, syncs / 250

        absent = ops_syncs("key-absent")
        zero = ops_syncs("key-zero", checkpoint_chunks=0)
        check(absent == zero, f"resume: knob at 0 {zero} != no key {absent}")
        row["knob_0"] = {"ops_per_tick": zero[0], "syncs_per_tick": zero[1],
                         "absent": {"ops_per_tick": absent[0], "syncs_per_tick": absent[1]}}
        step("zero_overhead")

        # 2. cut at 250 and resumed, on the card
        sustained("cut", checkpoint_chunks=1, max_ticks=250)
        res, _, res_rd = sustained("res", checkpoint_chunks=1, resume_from="cut")
        row["cut_resume_100k"] = {
            **resume_point(res_rd),
            "leaves_compared": _same_end("100k", *full, res, res_rd)}
        step("cut_resume")

        # 3. snapshotted on the CPU, resumed on the card
        faults = sustained_fault_tables(4096)[""]
        kw = dict(n=4096, faults=faults, max_ticks=1000, netmatrix=True,
                  checkpoint_chunks=1)
        f_full = sustained("f-card", **kw)
        sustained("f-cpu", device="cpu", **{**kw, "max_ticks": 250})
        f_res = sustained("f-res", resume_from="f-cpu", **kw)
        check(f_full[0].result.journal["sim"]["faults_crashed"] > 0, "resume: no crash")
        row["cpu_to_card_4096"] = {**resume_point(f_res[2]),
                                   "leaves_compared": _same_end("cpu→card", f_full[0],
                                                                f_full[2], f_res[0],
                                                                f_res[2])}
        step("cpu_to_card")

        # 4. the daemon: preempt, evict, drain
        env = EnvConfig.load(home=cli_home(root, "daemon"))
        env.daemon.scheduler.workers = 1
        outputs = env.dirs.outputs()
        daemon = Daemon(env=env, listen="127.0.0.1:0")
        daemon.start()
        client = Client(daemon.address)
        path = daemon_composition(root, "cli-100k-ckpt", 100_000, SUSTAINED,
                                  cfg="checkpoint_chunks = 1")
        comp = load_composition(path).to_dict()
        base = full[0].result.journal["sim"]

        def first_snapshot(tid):
            _wait_for(lambda: list_snapshots(os.path.join(outputs, "network", tid)),
                      f"the first snapshot of {tid}")

        _, full_leaves, _ = load_latest(full[1])

        def equal_flows(label, t):
            """The daemon's run ended as the uninterrupted executor run: its
            flow totals, and its final carry (its newest snapshot)."""
            sim = t["result"]["journal"]["sim"]
            diff = [k for k in base if (k.startswith("msgs_") or k == "ticks")
                    and sim.get(k) != base[k]]
            check(t["outcome"] == "success" and not diff,
                  f"resume daemon {label}: {t['outcome']} {t['error']} {diff}")
            if sim.get("checkpoint", {}).get("count"):
                _, leaves, _ = load_latest(os.path.join(outputs, "network", t["id"]))
                check(all(np.array_equal(a, b) for a, b in zip(leaves, full_leaves)),
                      f"resume daemon {label}: the final carry differs")

        stopped = False
        try:
            reset_launches()
            tid = client.run(comp)
            first_snapshot(tid)
            t_pre = time.time()
            check(client.preempt(tid) == {"ok": True, "queued": False}, "resume: /preempt")
            t = _wait_done(client, tid, 300)
            equal_flows("preempted", t)
            states = [(s["state"], s["created"]) for s in t["states"]]
            check([s for s, _ in states] == ["scheduled", "processing", "scheduled",
                                             "processing", "complete"],
                  f"resume daemon: states {states}")
            resumed = t["result"]["journal"]["sim"]["checkpoint"]["resumed"]
            check(resumed["from_run"] == tid and resumed["from_tick"] >= 250,
                  f"resume daemon: resumed {resumed}")
            row["daemon_preempt"] = {
                "preempt_to_requeue_ms": (states[2][1] - t_pre) * 1e3,
                "preempt_to_done_ms": (states[-1][1] - t_pre) * 1e3,
                "resumed_from_tick": resumed["from_tick"],
                "preemptions": t["trace"]["preemptions"]}
            step("daemon_preempt")

            victim = client.run(comp)
            first_snapshot(victim)
            hi = client.run(comp, priority=1)
            t_hi, t_v = _wait_done(client, hi, 300), _wait_done(client, victim, 300)
            equal_flows("evicting", t_hi)
            equal_flows("evicted", t_v)
            evicted = [e for e in client.events() if e["type"] == "task.evicted"]
            check(len(evicted) == 1 and evicted[0]["task"] == victim
                  and evicted[0]["by"] == hi, f"resume daemon: evictions {evicted}")
            row["daemon_evict"] = {
                "victim_preemptions": t_v["trace"]["preemptions"],
                "victim_resumed_from_tick":
                    t_v["result"]["journal"]["sim"]["checkpoint"]["resumed"]["from_tick"]}
            step("daemon_evict")

            parked = client.run(comp)
            first_snapshot(parked)
            t0 = time.perf_counter()
            drained = client.drain(timeout_secs=120)
            row["daemon_drain"] = {"busy_drain_ms": (time.perf_counter() - t0) * 1e3}
            check(drained["drained"] and drained["preempted"] == [parked],
                  f"resume daemon: /drain {drained}")
            _wait_for(lambda: daemon._stopped, "the drained daemon to stop")
            stopped = True
            kept = daemon.engine.storage.get(parked)
            check(kept.state().state.value == "scheduled"
                  and kept.trace.get("preemptions") == 1
                  and kept.composition["global"]["run_config"]["resume_from"] == parked,
                  "resume daemon: the drained task is not parked")
            counted("daemon")
            idle = Daemon(env=EnvConfig.load(home=cli_home(root, "idle")),
                          listen="127.0.0.1:0")
            idle.start()
            t0 = time.perf_counter()
            got = Client(idle.address).drain(timeout_secs=10)
            row["daemon_drain"]["idle_drain_ms"] = (time.perf_counter() - t0) * 1e3
            check(got == {"drained": True, "preempted": [], "canceled": []},
                  f"resume: idle /drain {got}")
            _wait_for(lambda: idle._stopped, "the idle daemon to stop")
            step("daemon_drain")
        finally:
            if not stopped:
                daemon.stop()

        # 5. sustained@1M
        n1, p1 = 1_000_000, {"duration_ticks": "10000"}
        _, wall, rd = sustained("1m", n=n1, params=p1, chunk=32, max_ticks=64,
                                checkpoint_chunks=1)
        _, _, rd_res = sustained("1m-res", n=n1, params=p1, chunk=32, max_ticks=64,
                                 checkpoint_chunks=1, resume_from="1m", ran=False)
        row["scale_1m"] = {"ms_per_tick": wall / 64 * 1e3, **snapshots_of(rd),
                           **resume_point(rd_res)}
        step("scale_1m")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    row["launches"] = launches
    return row


# ------------------------------------------------------------ main


# ---------------------------------------------------------------- buckets

# one turn (three once, then two), for the script's time limit
BUCKET_TURNS = 1
# the phase's sizes: sustained@100k and its rung under the default ladder,
# 1M and its rung, the faulted sustained, the plan cases' sweep
BUCKET_SIZES = {"n": 100_000, "padded": 131_072, "big": 1_000_000,
                "big_padded": 1_048_576, "faulted": 4000, "faulted_padded": 4096,
                "sweep": 1000}
# the build's ladder: the rungs a composition of the default 2 instances
# fits in, up to sustained@100k's
BUILD_LADDER = "4096,32768,131072"
# result keys a padded run must reproduce (the footprint is the padded
# carry's, as in the reference)
SAME_KEYS = ("ticks", "status", "finished_at", "sync_counts", "pub_dropped",
             "latency_clamped", "bw_queue_dropped", "collisions", "msgs_delivered",
             "msgs_sent", "msgs_enqueued", "msgs_dropped", "msgs_rejected", "cal_depth",
             "faults_crashed", "faults_restarted", "fault_dropped")


def same_results(label, a, b) -> None:
    """``b`` reproduces ``a``: every key of SAME_KEYS, every state leaf, the
    planes' accumulators, and the exact group layout."""
    for k in SAME_KEYS:
        check(np.array_equal(np.asarray(a[k]), np.asarray(b[k])), f"{label}: {k} differs")
    for sa, sb in zip(a["states"], b["states"]):
        check(sorted(sa) == sorted(sb), f"{label}: state keys")
        for k in sa:
            check(sa[k].dtype == sb[k].dtype and np.array_equal(sa[k], sb[k]),
                  f"{label}: state {k} differs")
    for k in ("lat_hist", "net_matrix"):
        check(a.get(k) == b.get(k), f"{label}: {k} differs")
    check([(g.id, g.offset, g.count) for g in a["groups"]]
          == [(g.id, g.offset, g.count) for g in b["groups"]], f"{label}: groups")


def phase_buckets(card) -> dict:
    """Shape buckets on the card (the ladder's dead lanes, exact-N results):

    1. sustained@100k at phase 4's parameters through ``execute_sim_run``
       with telemetry, exact against ``bucket = "auto"`` (131,072 lanes)
       in one turn: wall ms/tick; the journals, the telemetry
       streams and the latency blocks equal;
    2. ``build single network:pingpong-sustained --buckets`` with the
       ladder 4096,32768,131072 through the CLI (seconds a rung, the
       marker), then ``run single ... -i 100000 --run-cfg bucket=auto``;
    3. the same two programs through ``SimProgram.run``: results, every
       counter block and histogram delta equal; ops (counted on the host)
       and sync-debug syncs a tick of each, the syncs equal;
    4. ping-pong@100k under the default ladder to all SUCCESS, equal to
       exact; the faulted sustained at 4,000 (padded to 4,096) on the CPU
       and the card and exact on the card, equal;
    5. sustained at 100,002 on a 4-shard virtual mesh (two dead lanes),
       equal to the unmeshed run; snapshotted at tick 250 with the exact
       shapes, restored and run on, equal again;
    6. sustained@1M under the default ladder (1,048,576 lanes), 64 ticks:
       peak device bytes against the exact 1M run;
    7. ``tg check --trace-plans`` of a bucketed sustained@100k composition
       in process: 0 launches, 0 device bytes;
    8. every port plan case at 1,000 instances (padded to 4,096): sync-
       debug syncs over 16 and 32 ticks, exact against padded, equal; a
       plan that reads a count on the host (barrier) refuses padded;
    9. last, after every wall clock: phase 3's programs profiled over a
       64-tick first chunk (device ms and kernels a tick, K1 and K2 ms a
       launch at the padded shape)."""
    import shutil
    import tempfile

    from testground_tpu_torch.sim.buckets import DEFAULT_LADDER
    from testground_tpu_torch.sim.checkpoint import restore_carry, snapshot_carry

    root = tempfile.mkdtemp(prefix="chip_smoke_buckets_")
    launches = dict.fromkeys(KERNELS + SHARDED_KERNELS, 0)
    row = {"phase": "buckets", "card": card, "step_s": {}}
    t_step = [time.perf_counter()]
    sz = BUCKET_SIZES
    n = sz["n"]

    def step(name):
        now = time.perf_counter()
        row["step_s"][name] = now - t_step[0]
        t_step[0] = now

    def counted(label, kernels=KERNELS):
        got = read_launches(KERNELS + SHARDED_KERNELS)
        check(all(got[k] > 0 for k in kernels), f"buckets {label}: launches {got}")
        for k, v in got.items():
            launches[k] += v
        return got

    def run_counted(label, prog, kernels=KERNELS, **kw):
        reset_launches()
        res = prog.run(seed=0, **kw)
        torch.cuda.synchronize()
        counted(label, kernels)
        return res

    try:
        # 1. exact against auto through the executor, rotated turns
        def sustained(rid, **cfg):
            out, wall, rd = run_exec(exec_job(rid, root, "network", "pingpong-sustained",
                                              n, SUSTAINED, chunk=250, max_ticks=10_000,
                                              telemetry=True, **cfg))
            counted(rid)
            check(out.result.outcome.value == "success", f"buckets {rid}: outcome")
            return out, wall, rd

        sustained("warm-up", bucket="auto")
        ms = {"exact": [], "auto": []}
        first = {}
        for i in range(BUCKET_TURNS):
            for way in (("exact", "auto") if i % 2 == 0 else ("auto", "exact")):
                out, wall, rd = sustained(f"{way}-{i}",
                                          **({"bucket": "auto"} if way == "auto" else {}))
                ms[way].append(wall / out.result.journal["telemetry"]["rows"] * 1e3)
                if way not in first:
                    first[way] = (out.result.journal, rd)
        (jx, dx), (ja, da) = first["exact"], first["auto"]
        bucket = ja["sim"]["bucket"]
        check(bucket["padded_instances"] == sz["padded"] and bucket["instances"] == n
              and "bucket" not in jx["sim"], f"buckets: bucket block {bucket}")
        keys = [k for k in jx["sim"] if k.startswith(("msgs_", "faults_"))]
        diff = [k for k in keys + ["ticks", "latency"] if jx["sim"].get(k) != ja["sim"].get(k)]
        diff += [k for k in ("telemetry", "events") if jx.get(k) != ja.get(k)]
        check(not diff, f"buckets: the padded journal differs in {diff}")
        check(_series(dx) == _series(da), "buckets: the telemetry streams differ")
        row["sustained_100k"] = {
            "wall_ms_per_tick": ms, "median_exact": statistics.median(ms["exact"]),
            "median_auto": statistics.median(ms["auto"]),
            "delta": statistics.median(ms["auto"]) - statistics.median(ms["exact"]),
            "resolved": (min(ms["auto"]) > max(ms["exact"])
                         or max(ms["auto"]) < min(ms["exact"])),
            "bucket": bucket, "ticks": ja["telemetry"]["rows"],
            "perf_instances": ja["sim"]["perf"]["instances"],
            "perf_bucket": ja["sim"]["perf"].get("bucket"),
        }
        step("turns")

        # 2. build --buckets, then a bucketed run single, through the CLI
        home = cli_home(root, "cli")
        got = cli_call(home, ["build", "single", "network:pingpong-sustained", "--buckets",
                              "--run-cfg", f"bucket_ladder={BUILD_LADDER}"])
        check(got["rc"] == 0 and "(outcome: success)" in got["out"],
              f"buckets build: {got['out'][-1500:]} {got['err'][-1500:]}")
        with open(os.path.join(home, "data", "compile-cache", "precompiled",
                               "buckets-network-pingpong-sustained.json")) as f:
            marker = json.load(f)
        check([b["bucket"] for b in marker["buckets"]]
              == [int(r) for r in BUILD_LADDER.split(",")]
              and sorted(marker) == ["buckets", "case", "ladder", "plan"],
              f"buckets build: marker {marker}")
        ran = cli_run("bucketed run single", home,
                      ["run", "single", "network:pingpong-sustained", "-i", str(n),
                       "-tp", "duration_ticks=500", "-tp", "reshape_every=250",
                       "--run-cfg", "bucket=auto"], launches)
        rj = ran["task"].result["journal"]
        check(rj["events"]["single"]["success"] == n
              and rj["sim"]["bucket"]["padded_instances"] == sz["padded"]
              and rj["sim"]["bucket"]["compile_cache"] == "hit",
              f"buckets run single: {rj['events']} {rj['sim'].get('bucket')}")
        row["cli"] = {"build_wall_s": got["wall"], "marker": marker,
                      "run_wall_s": ran["wall"], "run_ticks": rj["sim"]["ticks"],
                      "run_launches": ran["launches"]}
        step("cli")

        # 3. the two programs directly: equal, ops and syncs a tick
        progs = {
            "exact": program("pingpong-sustained", n, SUSTAINED, chunk=250, telemetry=True),
            "auto": program("pingpong-sustained", n, SUSTAINED, chunk=250, telemetry=True,
                            ladder=DEFAULT_LADDER),
        }
        check(progs["auto"].n == sz["padded"], "buckets: the padded program's lanes")
        rec = {}
        for way, prog in progs.items():
            reset_launches()
            res, blocks, _ = record_planes(prog, seed=0, max_ticks=10_000)
            torch.cuda.synchronize()
            rec[way] = (res, blocks, counted(f"sustained {way}"))
        (rx, bx, lx), (ra, ba, la) = rec["exact"], rec["auto"]
        same_results("buckets sustained", rx, ra)
        for k in ("tele", "lat"):
            check(len(bx[k]) == len(ba[k]) and all(
                np.array_equal(u, v) for u, v in zip(bx[k], ba[k])),
                f"buckets sustained: {k} blocks differ")
        check(lx == la, f"buckets sustained: launches {lx} against {la}")
        per_tick = {}
        for way, prog in progs.items():
            reset_launches()
            (_, ops), syncs = counted_syncs(lambda p=prog: dispatched_ops(
                lambda: p.run(seed=0, max_ticks=250)))
            torch.cuda.synchronize()
            counted(f"ops {way}")
            per_tick[way] = {"ops": ops / 250, "syncs": syncs / 250}
        check(per_tick["auto"]["syncs"] == per_tick["exact"]["syncs"],
              f"buckets: syncs a tick {per_tick}")
        row["direct_100k"] = {"ticks": int(rx["ticks"]), "per_tick": per_tick,
                              "ops_added_per_tick": per_tick["auto"]["ops"]
                              - per_tick["exact"]["ops"],
                              "launches": la, "flows": flows(ra)}
        step("direct")

        # 4. ping-pong@100k; the faulted sustained at 4,000 on CPU and card
        pp = {"latency_ms": "100", "latency2_ms": "10", "tolerance_ms": "15"}
        res_x = run_counted("ping-pong exact", program("ping-pong", n, pp, chunk=64),
                            max_ticks=10_000)
        res_a = run_counted("ping-pong auto", program("ping-pong", n, pp, chunk=64,
                                                      ladder=DEFAULT_LADDER),
                            max_ticks=10_000)
        check(bool((res_a["status"] == 1).all()), "buckets ping-pong: not all SUCCESS")
        same_results("buckets ping-pong", res_x, res_a)
        m = sz["faulted"]
        ft = sustained_fault_tables(m)
        fx = run_counted("faulted exact", program("pingpong-sustained", m, SUSTAINED,
                                                  chunk=250, fault_tables=ft),
                         max_ticks=1000)
        fa = run_counted("faulted auto", program("pingpong-sustained", m, SUSTAINED,
                                                 chunk=250, fault_tables=ft,
                                                 ladder=DEFAULT_LADDER), max_ticks=1000)
        fc = program("pingpong-sustained", m, SUSTAINED, chunk=250, fault_tables=ft,
                     ladder=DEFAULT_LADDER, device="cpu").run(seed=0, max_ticks=1000)
        check(fa["faults_crashed"] > 0 and fa["fault_dropped"] > 0,
              f"buckets faulted: {flows(fa)}")
        same_results("buckets faulted card", fx, fa)
        same_results("buckets faulted cpu", fc, fa)
        row["pingpong_100k"] = {"ticks": int(res_a["ticks"]), "flows": flows(res_a)}
        row["faulted_4000"] = {"padded": sz["faulted_padded"], "ticks": int(fa["ticks"]),
                               "flows": flows(fa)}
        step("pingpong_faulted")

        # 5. an indivisible lane count on a 4-shard virtual mesh
        odd = n + 2
        meshed = program("pingpong-sustained", odd, SUSTAINED, chunk=250,
                         mesh=MESH_SHARDS)
        check(meshed.mesh_pad == 2 and meshed.n == odd + 2,
              f"buckets mesh: pad {meshed.mesh_pad}")
        flat = program("pingpong-sustained", odd, SUSTAINED, chunk=250)
        res_u = run_counted("mesh unmeshed", flat, max_ticks=10_000)
        export = meshed.lane_export()
        cut = {}

        def grab(ticks, carry):
            if ticks == 250:
                cut["snap"] = snapshot_carry(carry, "xla", export=export)

        reset_launches()
        res_m = meshed.run(seed=0, max_ticks=10_000, observer=grab)
        torch.cuda.synchronize()
        counted("mesh", SHARDED_KERNELS)
        same_results("buckets mesh", res_u, res_m)
        leaves, metas = cut["snap"]
        check(any(mt["shape"] == [odd] for mt in metas)
              and not any(odd + 2 in mt["shape"] for mt in metas),
              f"buckets mesh: snapshot shapes {[mt['shape'] for mt in metas]}")
        carry = restore_carry(meshed, 0, {"leaves": metas}, leaves, transport="xla")
        reset_launches()
        res_r = meshed.run(seed=0, max_ticks=10_000, resume_carry=carry, resume_ticks=250)
        torch.cuda.synchronize()
        counted("mesh resumed", SHARDED_KERNELS)
        same_results("buckets mesh resumed", res_u, res_r)
        row["mesh_100002"] = {"shards": MESH_SHARDS, "dead_lanes": meshed.mesh_pad,
                              "ticks": int(res_m["ticks"]), "snapshot_leaves": len(leaves),
                              "carry_bytes": res_m["carry_bytes"]}
        step("mesh")

        # 6. sustained@1M under the default ladder: peak bytes
        big = sz["big"]
        peaks = {}
        for way, lad in (("exact", None), ("auto", DEFAULT_LADDER)):
            prog = program("pingpong-sustained", big, {"duration_ticks": "10000"},
                           chunk=64, ladder=lad)
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            res = run_counted(f"1M {way}", prog, max_ticks=64)
            peaks[way] = torch.cuda.max_memory_allocated() - held
            check(conserved(res), f"buckets 1M {way}: flows")
            del prog, res
        row["scale_1m"] = {"peak_bytes": peaks, "padded": sz["big_padded"],
                           "ratio": peaks["auto"] / peaks["exact"]}
        step("scale")

        # 7. tg check --trace-plans of a bucketed composition
        from testground_tpu_torch.api import TestPlanManifest, load_composition
        from testground_tpu_torch.sim.check import check_composition
        from testground_tpu_torch.sim.executor import plan_dir

        path = daemon_composition(root, "bucketed-100k", n, SUSTAINED,
                                  cfg='bucket = "auto"\n')
        manifest = TestPlanManifest.load_file(os.path.join(plan_dir("network"),
                                                           "manifest.toml"))
        torch.cuda.synchronize()
        mem = torch.cuda.memory_allocated()
        reset_launches()
        t0 = time.perf_counter()
        fs = check_composition(load_composition(path), manifest, trace_plans=True,
                               plan_sources=plan_dir("network"))
        check_ms = (time.perf_counter() - t0) * 1e3
        got = read_launches(KERNELS + SHARDED_KERNELS)
        torch.cuda.synchronize()
        check(not [f for f in fs if f.severity == "error"], f"buckets check: {fs}")
        check(sum(got.values()) == 0 and torch.cuda.memory_allocated() == mem,
              f"buckets check: launches {got}, bytes {torch.cuda.memory_allocated() - mem}")
        row["check"] = {"ms": check_ms, "findings": [f.rule for f in fs], "launches": 0,
                        "device_bytes": 0}
        step("check")

        # 8. every port sim plan case (a plan with a sim.py; the exec-only
        # plans run as processes): syncs over 32 and 64 ticks, exact and padded
        from testground_tpu_torch.sim.executor import PLANS_ROOT

        from testground_tpu_torch.sim.engine import HOST_READ_ERROR

        sweep, refused = {}, []
        for plan in sorted(os.listdir(PLANS_ROOT)):
            mpath = os.path.join(PLANS_ROOT, plan, "manifest.toml")
            if not (os.path.isfile(mpath)
                    and os.path.isfile(os.path.join(PLANS_ROOT, plan, "sim.py"))):
                continue
            for tc in TestPlanManifest.load_file(mpath).testcases:
                kw = {"hosts": ("http-echo",)} if plan == "additional_hosts" else {}
                growth = {}
                for way, lad in (("exact", None), ("auto", DEFAULT_LADDER)):
                    prog = program(tc.name, sz["sweep"], {}, chunk=16, plan=plan,
                                   ladder=lad, **kw)
                    try:
                        prog.run(seed=0, max_ticks=16)  # a step's constants, built once
                    except TypeError as e:
                        # a plan that reads a count on the host refuses at
                        # its first padded step, as the reference's trace
                        check(way == "auto" and HOST_READ_ERROR in str(e),
                              f"buckets sweep {plan}:{tc.name} {way}: {e}")
                        refused.append(f"{plan}:{tc.name}")
                        break
                    growth[way] = host_syncs(prog, 32) - host_syncs(prog, 16)
                else:
                    sweep[f"{plan}:{tc.name}"] = growth
        reading = {k: v for k, v in sweep.items() if v["auto"] != v["exact"]}
        check(not reading, f"buckets sweep: syncs differ {reading}")
        # the one case whose bucketed --trace-plans is plan.traced-int in
        # both packages (barrier's max(1, int(n * p)))
        check(refused == ["benchmarks:barrier"], f"buckets sweep: refused {refused}")
        row["sync_sweep"] = {"cases": len(sweep), "per_16_ticks": sweep,
                             "refused": refused}
        step("sweep")

        # 9. phase 3's programs profiled over a first chunk of 64 ticks, last
        prof = {}
        for way, lad in (("exact", None), ("auto", DEFAULT_LADDER)):
            twin = program("pingpong-sustained", n, SUSTAINED, chunk=64, telemetry=True,
                           ladder=lad)
            prof[way] = device_profile(twin, ticks=64, wall_ms_per_tick=statistics.median(
                ms[way]), by_name=True)
        # the device events a padded tick adds or drops, by kernel name
        names = {w: prof[w].pop("kernels_per_tick_by_name") for w in prof}
        row["profiled"] = prof
        row["kernels_added_per_tick"] = {
            k: names["auto"].get(k, 0) - names["exact"].get(k, 0)
            for k in sorted(set(names["auto"]) | set(names["exact"]))
            if names["auto"].get(k, 0) != names["exact"].get(k, 0)}
        step("profiled")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    row["launches"] = launches
    return row


# phase packs: eight sustained tenants, one bucket of the default ladder
# (32,768 lanes each, 262,144 in the pack, 16% of them dead)
PACK_SIZES = (24_000, 25_000, 26_000, 27_000, 28_000, 29_000, 30_000, 31_000)
# one turn (three once, then two), for the script's time limit
PACK_TURNS = 1
# the virtual mesh of card 0 a pack runs on to its end (phase packs, step
# 4), and the meshes of several parts on card 0 it is placed over (step 5):
# "4" cut into four parts, "2x4" (its two rows) and "2x4" cut into four
PACK_MESHES = ("4",)
PACK_PLACED = {"4-cut-4": ("4", (1, 2, 3)), "2x4": ("2x4", ()), "2x4-cut-4": ("2x4", (2,))}
# the ticks of a placed way's run and of its profiled twin
PACK_PLACED_TICKS = 64
PACK_PROFILE_TICKS = 32
# the reference's pack smoke: eight ping-pong tenants in one rung of 32
PACK_SMOKE_SIZES = (5, 9, 13, 17, 21, 25, 29, 24)
PACK_SMOKE_LADDER = (32, 64)
PACK_PINGPONG = {"latency_ms": "4", "latency2_ms": "2", "tolerance_ms": "15"}


def pack_profile(prog, members, wall_ms_per_tick, mesh=None) -> dict:
    """``device_profile`` of a pack: device kernel time and kernels a tick
    over one chunk of ``PackRunner(prog, len(members), mesh=mesh)``, the
    busy share against ``wall_ms_per_tick`` and the transport kernels' ms a
    launch at the packed shape."""
    from torch.profiler import ProfilerActivity, profile

    from testground_tpu_torch.sim.pack import PackRunner

    runner = PackRunner(prog, len(members), mesh=mesh)
    ticks = prog.chunk
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        runner.run(members)
        torch.cuda.synchronize()
    rows = [r for r in _device_rows(prof) if r[1] > 0]
    total_ms = sum(r[1] for r in rows) / 1e3 / ticks
    return {
        "profiled_ticks": ticks,
        "device_ms_per_tick": total_ms if rows else None,
        "device_busy_share": total_ms / wall_ms_per_tick if rows else None,
        "kernels_per_tick": sum(r[2] for r in rows) / ticks if rows else None,
        "transport_kernel_ms": {k.split("(")[0]: us / 1e3 / calls for k, us, calls in rows
                                if k.startswith(TRANSPORT_KERNELS)},
    }


def phase_packs(card) -> dict:
    """Run packs on the card (``sim/pack.py``, ``engine/pack.py``):

    1. pack8@sustained: eight ``network:pingpong-sustained`` tenants at
       24,000 … 31,000 instances (phase 4's parameters, ``bucket =
       "auto"``: 32,768 lanes each, ``pack = true``, telemetry, chunk 250)
       submitted to an in-process daemon with one worker while a CPU run
       holds it, so one claim takes all eight; against the same eight runs
       one after another through ``execute_sim_run``, in one turn.
       Every member's journal (flow totals, latency, telemetry and
       events blocks) and telemetry stream equals its serial run's, and
       journals ``sim.pack.members`` = 8. Wall ms/tick of the pack (the
       run loop's ``sim.wall_secs``), and aggregate live peer·ticks/s of
       the pack against the serial eight;
    2. the reference's pack smoke on the card: eight ping-pong tenants at
       5 … 29 instances in one rung of 32, each SUCCESS at its exact N and
       equal to its CPU run;
    3. a straggler: two sustained tenants at 4,000 instances, the first
       one's own budget ending after one chunk, each equal to its isolated
       card run with that budget; an SLO cancel: two tenants
       through ``execute_packed_sim_runs``, one of them with a
       fail-severity rule, which fails alone equal to its isolated run's
       breach;
    4. pack8@sustained's eight on a 4-shard virtual mesh of card 0
       (``PackRunner(..., mesh=make_mesh("4", devices=[card 0] * 4))``: a
       composition cannot name a virtual mesh on CUDA) against the
       unmeshed pack, one turn on the library path: wall ms/tick and
       launches; every meshed member equals its unmeshed-pack run;
    5. last, after every wall clock: 64 ticks of the pack, of one member
       alone, of the 4-shard mesh and of the pack placed over each mesh of
       several parts on card 0 (``PACK_PLACED``: each part holds its
       members' own lanes and steps them on a thread of its own): the
       peak device bytes, each placed way's wall ms/tick, its sharded K1
       and K2 launches (one a part a tick) and each part's carry bytes,
       equal to the replicated plus its own placed bytes
       (``PackRunner.part_bytes_estimate``); every placed member equals its
       member of the unmeshed pack's 64 ticks. Then a first chunk of 32
       ticks profiled, the pack against one member alone, the 4-shard mesh
       and the placed ways: device ms and kernels a tick, the busy share,
       K1's and K2's (or their sharded forms') ms a launch at the packed
       (a placed way: each part's) shape."""
    import shutil
    import tempfile
    import threading

    from testground_tpu_torch.api import load_composition
    from testground_tpu_torch.client import Client
    from testground_tpu_torch.config import EnvConfig
    from testground_tpu_torch.daemon import Daemon
    from testground_tpu_torch.rpc import discard_writer
    from testground_tpu_torch.sim.buckets import DEFAULT_LADDER
    from testground_tpu_torch.sim.executor import execute_packed_sim_runs
    from testground_tpu_torch.sim.pack import PackMember, PackRunner
    from testground_tpu_torch.sim.slo import SloBreachError

    root = tempfile.mkdtemp(prefix="chip_smoke_packs_")
    launches = dict.fromkeys(KERNELS + SHARDED_KERNELS, 0)
    row = {"phase": "packs", "card": card, "step_s": {}}
    t_step = [time.perf_counter()]

    def step(name):
        now = time.perf_counter()
        row["step_s"][name] = now - t_step[0]
        t_step[0] = now

    def counted(label):
        got = read_launches(KERNELS + SHARDED_KERNELS)
        check(all(got[k] > 0 for k in KERNELS), f"packs {label}: launches {got}")
        for k, v in got.items():
            launches[k] += v
        return got

    def same_journal(label, ja, jb):
        keys = [k for k in ja["sim"] if k.startswith(("msgs_", "faults_"))]
        diff = [k for k in keys + ["ticks", "latency", "pub_dropped"]
                if ja["sim"].get(k) != jb["sim"].get(k)]
        diff += [k for k in ("telemetry", "events") if ja.get(k) != jb.get(k)]
        check(not diff, f"packs {label}: the journals differ in {diff}")

    env = EnvConfig.load(home=cli_home(root, "daemon"))
    env.daemon.scheduler.workers = 1
    daemon = Daemon(env=env, listen="127.0.0.1:0")
    daemon.start()
    client = Client(daemon.address)
    try:
        # 1. pack8@sustained through the daemon against the serial eight
        def blocker(i):
            # a CPU run holds the one worker while the eight are queued: it
            # launches no kernel, so the counts below are the pack's alone
            comp = load_composition(daemon_composition(
                root, f"hold-{i}", 1000, SUSTAINED,
                cfg='device = "cpu"\ndebug_chunk_sleep_ms = 500\n')).to_dict()
            return client.run(comp)

        def pack_turn(i):
            hold = blocker(i)
            reset_launches()
            tids = []
            for k, n in enumerate(PACK_SIZES):
                comp = load_composition(daemon_composition(
                    root, f"pack-{i}-{k}", n, SUSTAINED,
                    cfg=f'bucket = "auto"\npack = true\nseed = {k}\n')).to_dict()
                tids.append(client.run(comp))
            # polled every 0.25 s: a 10 ms poller's HTTP thread takes the
            # GIL from the launching worker (phase daemon's daemon_polled_10ms)
            _wait_done(client, hold, 120, poll_s=0.25)
            for tid in tids:
                _wait_done(client, tid, 600, poll_s=0.25)
            torch.cuda.synchronize()
            got = counted(f"pack turn {i}")
            tasks = [daemon.engine.get_task(t) for t in tids]
            for t, n in zip(tasks, PACK_SIZES):
                check(t.outcome().value == "success", f"packs member {t.id}: {t.error}")
                sim = t.result["journal"]["sim"]
                check(sim["pack"]["members"] == 8 and sim["pack"]["width"] == 8,
                      f"packs: member {t.id} pack block {sim['pack']}")
                check(t.result["journal"]["events"]["all"]["success"] == n,
                      f"packs: member {t.id} events {t.result['journal']['events']}")
            journals = [t.result["journal"] for t in tasks]
            claimed = [t.states[1].created for t in tasks]
            ended = [t.states[-1].created for t in tasks]
            dirs = [os.path.join(env.dirs.outputs(), "network", t) for t in tids]
            return {"journals": journals, "dirs": dirs,
                    "wall": journals[0]["sim"]["wall_secs"],
                    "ticks": [j["telemetry"]["rows"] for j in journals], "launches": got,
                    # the claim to the last archive, in the store's stamps
                    "claim_to_done_s": max(ended) - min(claimed),
                    "steady": [j["sim"]["perf"]["execute"]["steady_peer_ticks_per_sec"]
                               for j in journals]}

        def serial_turn(i):
            journals, dirs, walls, ticks = [], [], [], []
            for k, n in enumerate(PACK_SIZES):
                out, _, rd = run_exec(exec_job(
                    f"serial-{i}-{k}", root, "network", "pingpong-sustained", n, SUSTAINED,
                    chunk=250, max_ticks=10_000, telemetry=True, bucket="auto", seed=k))
                counted(f"serial {i}-{k}")
                check(out.result.outcome.value == "success", f"packs serial {k}: outcome")
                journals.append(out.result.journal)
                dirs.append(rd)
                walls.append(out.result.journal["sim"]["wall_secs"])
                ticks.append(out.result.journal["telemetry"]["rows"])
            return {"journals": journals, "dirs": dirs, "wall": sum(walls),
                    "walls": walls, "ticks": ticks,
                    "steady": [j["sim"]["perf"]["execute"]["steady_peer_ticks_per_sec"]
                               for j in journals]}

        turns = {"pack": [], "serial": []}
        for i in range(PACK_TURNS):
            for way in (("pack", "serial") if i % 2 == 0 else ("serial", "pack")):
                turns[way].append(pack_turn(i) if way == "pack" else serial_turn(i))
        for p, q in zip(turns["pack"], turns["serial"]):
            for k in range(len(PACK_SIZES)):
                same_journal(f"member {k}", q["journals"][k], p["journals"][k])
                check(_series(q["dirs"][k]) == _series(p["dirs"][k]),
                      f"packs member {k}: the telemetry streams differ")
        live = np.asarray(PACK_SIZES, np.float64)

        def rate(t):
            return float((live * np.asarray(t["ticks"])).sum() / t["wall"])

        def steady_rate(t, packed):
            # the perf ledger's rate over each run's chunks after its first:
            # a pack's members share its chunk walls; the serial eight take
            # one another's time
            if packed:
                return float(sum(t["steady"]))
            return float((live * np.asarray(t["ticks"])).sum() / sum(
                n * tk / r for n, tk, r in zip(live, t["ticks"], t["steady"])))

        pack_rates = [rate(t) for t in turns["pack"]]
        serial_rates = [rate(t) for t in turns["serial"]]
        pack_steady = [steady_rate(t, True) for t in turns["pack"]]
        serial_steady = [steady_rate(t, False) for t in turns["serial"]]
        pack_ms = [t["wall"] / max(t["ticks"]) * 1e3 for t in turns["pack"]]
        member_ms = [w / tk * 1e3 for t in turns["serial"]
                     for w, tk in zip(t["walls"], t["ticks"])]
        padded = turns["pack"][0]["journals"][0]["sim"]["bucket"]["padded_instances"]
        row["pack8_sustained"] = {
            "sizes": list(PACK_SIZES), "lanes": len(PACK_SIZES) * padded,
            "ticks": turns["pack"][0]["ticks"],
            "pack_wall_ms_per_tick": pack_ms,
            "median_pack_wall_ms_per_tick": statistics.median(pack_ms),
            "serial_member_wall_ms_per_tick": statistics.median(member_ms),
            "pack_live_peer_ticks_per_s": pack_rates,
            "serial_live_peer_ticks_per_s": serial_rates,
            "aggregate_ratio": statistics.median(pack_rates) / statistics.median(
                serial_rates),
            "resolved": min(pack_rates) > max(serial_rates),
            "pack_steady_peer_ticks_per_s": pack_steady,
            "serial_steady_peer_ticks_per_s": serial_steady,
            "steady_ratio": statistics.median(pack_steady) / statistics.median(
                serial_steady),
            "pack_claim_to_done_s": [t["claim_to_done_s"] for t in turns["pack"]],
            "pack_launches": turns["pack"][0]["launches"],
        }
        check(row["pack8_sustained"]["aggregate_ratio"] > 1.0,
              f"packs: the pack is no faster {row['pack8_sustained']}")
        step("pack8")

        # 2. the reference's pack smoke: ping-pong tenants at 5 … 29
        prog = program("ping-pong", 32, PACK_PINGPONG, chunk=32, telemetry=True,
                       ladder=PACK_SMOKE_LADDER)
        from testground_tpu_torch.sim.buckets import plan_buckets

        lcs = [plan_buckets([n], "auto", PACK_SMOKE_LADDER).live_counts
               for n in PACK_SMOKE_SIZES]
        reset_launches()
        packed = PackRunner(prog, 8).run([
            PackMember(seed=k, live_counts=lc, max_ticks=2048) for k, lc in enumerate(lcs)])
        torch.cuda.synchronize()
        counted("ping-pong pack")
        for k, (n, res) in enumerate(zip(PACK_SMOKE_SIZES, packed)):
            check(res["status"].shape == (n,) and bool((res["status"] == 1).all()),
                  f"packs ping-pong member {k}: status {res['status']}")
            cpu = program("ping-pong", n, PACK_PINGPONG, chunk=32, telemetry=True,
                          ladder=PACK_SMOKE_LADDER, device="cpu").run(seed=k,
                                                                      max_ticks=2048)
            same_results(f"packs ping-pong member {k}", cpu, res)
        row["pingpong_smoke"] = {"sizes": list(PACK_SMOKE_SIZES),
                                 "ticks": [int(r["ticks"]) for r in packed]}
        step("smoke")

        # 3. a straggler (its own budget ends first) and an SLO cancel
        m = 4000
        sprog = program("pingpong-sustained", m, SUSTAINED, chunk=250, telemetry=True,
                        ladder=DEFAULT_LADDER)
        lc = plan_buckets([m], "auto", DEFAULT_LADDER).live_counts
        budgets = (250, 10_000)
        reset_launches()
        packed = PackRunner(sprog, 2).run([PackMember(seed=k, live_counts=lc, max_ticks=b)
                                           for k, b in enumerate(budgets)])
        torch.cuda.synchronize()
        counted("straggler pack")
        for k, (b, res) in enumerate(zip(budgets, packed)):
            iso = program("pingpong-sustained", m, SUSTAINED, chunk=250, telemetry=True,
                          ladder=DEFAULT_LADDER).run(seed=k, max_ticks=b)
            same_results(f"packs straggler member {k}", iso, res)
        check(packed[0]["ticks"] == 250 and packed[1]["ticks"] > 250,
              f"packs straggler: ticks {[r['ticks'] for r in packed]}")
        slo = [{"name": "impossible", "metric": "delivered_per_tick", "op": ">",
                "threshold": 1e9, "severity": "fail"}]

        def slo_job(rid, k, rules):
            return exec_job(rid, root, "network", "pingpong-sustained", m, SUSTAINED,
                            chunk=250, max_ticks=10_000, telemetry=True, bucket="auto",
                            pack=True, seed=k, slo=rules)

        reset_launches()
        jobs = [slo_job("slo-pack-0", 0, slo), slo_job("slo-pack-1", 1, None)]
        outs = execute_packed_sim_runs(jobs, [discard_writer()] * 2,
                                       [threading.Event(), threading.Event()])
        torch.cuda.synchronize()
        counted("slo pack")
        check(isinstance(outs[0], SloBreachError)
              and outs[1].result.outcome.value == "success",
              f"packs slo: {outs}")
        try:
            run_exec(slo_job("slo-solo-0", 0, slo))
            check(False, "packs slo: the isolated run did not breach")
        except SloBreachError as e:
            iso = e
        counted("slo solo")
        same_journal("slo member", iso.run_output.result.journal,
                     outs[0].run_output.result.journal)
        check(iso.run_output.result.journal["slo"]["breaches"]
              == outs[0].run_output.result.journal["slo"]["breaches"],
              "packs slo: the breaches differ")
        slo_dirs = [os.path.join(jobs[0].env.dirs.outputs(), "network", r)
                    for r in ("slo-solo-0", "slo-pack-0")]
        check(_series(slo_dirs[0]) == _series(slo_dirs[1]),
              "packs slo: the telemetry streams differ")
        row["straggler"] = {"budgets": list(budgets),
                            "ticks": [int(r["ticks"]) for r in packed]}
        row["slo_cancel"] = {"ticks": outs[0].run_output.result.journal["sim"]["ticks"],
                             "other_ticks": outs[1].result.journal["sim"]["ticks"]}
        step("straggler_slo")

        # 4. the eight on a 4-shard virtual mesh of card 0, against the
        # unmeshed pack, one turn (library path)
        from testground_tpu_torch.sim.meshplan import TorchMesh, make_mesh

        lc8 = [plan_buckets([n], "auto", DEFAULT_LADDER).live_counts for n in PACK_SIZES]

        def pack_prog(chunk):
            return program("pingpong-sustained", PACK_SIZES[0], SUSTAINED, chunk=chunk,
                           telemetry=True, ladder=DEFAULT_LADDER)

        def members(ticks):
            return [PackMember(seed=k, live_counts=lc, max_ticks=ticks)
                    for k, lc in enumerate(lc8)]

        card0 = torch.device("cuda", 0)

        def pack_mesh(way):
            if way == "unmeshed":
                return None
            if way in PACK_PLACED:  # a mesh of card 0 cut into parts
                shape, cuts = PACK_PLACED[way]
                mesh = make_mesh(shape, devices=[card0] * 8)
                rows, p = mesh.shape.get("runs", 1), mesh.shards
                bounds = (0, *cuts, p)
                return TorchMesh(mesh.devices[: rows * p], runs=mesh.runs, parts=tuple(
                    (card0, g * p + a, g * p + b) for g in range(rows)
                    for a, b in zip(bounds, bounds[1:])))
            dims = [int(d) for d in way.split("x")]
            return make_mesh(way, devices=[card0] * int(np.prod(dims)))

        def mesh_turn(way):
            runner = PackRunner(pack_prog(250), 8, mesh=pack_mesh(way))
            stepped, tick = [], runner._tick

            def counted_tick(*a, **k):
                stepped.append(1)
                return tick(*a, **k)

            runner._tick = counted_tick
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = runner.run(members(10_000))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            got = read_launches(KERNELS + SHARDED_KERNELS)
            for k, v in got.items():
                launches[k] += v
            ticks = len(stepped)
            kern = SHARDED_KERNELS if way != "unmeshed" else KERNELS
            check(all(got[k] == ticks for k in kern),
                  f"packs mesh {way}: launches {got} over {ticks} ticks")
            return res, wall / ticks * 1e3, got, ticks

        ways = ("unmeshed", *PACK_MESHES)
        mesh_runs = {w: [] for w in ways}
        for i in range(PACK_TURNS):
            for way in (ways if i % 2 == 0 else ways[::-1]):
                mesh_runs[way].append(mesh_turn(way))
        base = mesh_runs["unmeshed"][0][0]
        for way in ways:
            for res, *_ in mesh_runs[way]:
                for k in range(len(PACK_SIZES)):
                    same_results(f"packs mesh {way} member {k}", base[k], res[k])
        row["pack8_meshes"] = {
            way: {"wall_ms_per_tick": [t[1] for t in mesh_runs[way]],
                  "ticks": mesh_runs[way][0][3], "launches": mesh_runs[way][0][2]}
            for way in ways}
        step("meshes")

        # 5. last: 64 ticks of each way (peak bytes; the placed ways' wall,
        # launches and part bytes), then the first 32 ticks profiled
        peaks, placed, walls, base = {}, {}, {}, None
        for way in ("pack", "member", *PACK_MESHES, *PACK_PLACED):
            runner = res = None
            prog = pack_prog(PACK_PLACED_TICKS)
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            t0 = time.perf_counter()
            if way == "member":
                prog.run(seed=0, max_ticks=PACK_PLACED_TICKS)
            else:
                runner = PackRunner(prog, 8, mesh=None if way == "pack" else pack_mesh(way))
                res = runner.run(members(PACK_PLACED_TICKS))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            # the 64 ticks' wall, the run's setup (the members' carries, a
            # placed pack's parts) included
            walls[way] = wall / PACK_PLACED_TICKS * 1e3
            got = read_launches(KERNELS + SHARDED_KERNELS)
            for k, v in got.items():
                launches[k] += v
            peaks[way] = torch.cuda.max_memory_allocated() - held
            if way == "pack":
                base = res
            elif way in PACK_PLACED:
                for k in range(len(PACK_SIZES)):
                    same_results(f"packs placed {way} member {k}", base[k], res[k])
                # each part pops once a tick, and commits on the ticks that
                # bring its own lanes messages
                parts = len(runner.parts)
                most = PACK_PLACED_TICKS * parts
                check(got["pop_bucket_sharded"] == most
                      and 0 < got["commit_calendar_sharded"] <= most,
                      f"packs placed {way}: launches {got} over {PACK_PLACED_TICKS} "
                      f"ticks on {parts} parts")
                estimate = runner.part_bytes_estimate(prog.init_carry(0))
                check(runner.last_part_bytes == estimate,
                      f"packs placed {way}: part bytes {runner.last_part_bytes}, "
                      f"predicted {estimate}")
                placed[way] = {
                    "parts": [(q.row, q.first, q.runs, q.s0, q.s1) for q in runner.parts],
                    "part_bytes": runner.last_part_bytes,
                    "wall_ms_per_tick": wall / PACK_PLACED_TICKS * 1e3,
                    "launches": got}
        p8 = row["pack8_sustained"]
        # one chunk of 32 ticks each
        ticks = PACK_PROFILE_TICKS
        prof = {
            "pack": pack_profile(pack_prog(ticks), members(ticks),
                                 p8["median_pack_wall_ms_per_tick"]),
            "member": device_profile(pack_prog(ticks), ticks=ticks, wall_ms_per_tick=p8[
                "serial_member_wall_ms_per_tick"]),
            **{way: pack_profile(pack_prog(ticks), members(ticks), statistics.median(
                row["pack8_meshes"][way]["wall_ms_per_tick"]), mesh=pack_mesh(way))
               for way in PACK_MESHES},
            **{way: pack_profile(pack_prog(ticks), members(ticks),
                                 placed[way]["wall_ms_per_tick"], mesh=pack_mesh(way))
               for way in PACK_PLACED},
        }
        kp, km = prof["pack"]["kernels_per_tick"], prof["member"]["kernels_per_tick"]
        row["profiled"] = prof
        row["placed"] = placed
        row["wall_ms_per_tick_64"] = walls
        row["peak_bytes"] = {**peaks, "ratio": peaks["pack"] / peaks["member"]}
        row["kernels_ratio"] = kp / km if kp and km else None
        row["mesh_kernels_added"] = {
            way: (prof[way]["kernels_per_tick"] - kp
                  if prof[way]["kernels_per_tick"] and kp else None)
            for way in (*PACK_MESHES, *PACK_PLACED)}
        step("profiled")
    finally:
        daemon.stop()
        shutil.rmtree(root, ignore_errors=True)
    row["launches"] = launches
    return row


# ---------------------------------------------------------------- cohort

# the leader's program: the tick's collectives as the profiler names them
COHORT_COLLECTIVES = ("all_reduce", "allreduce", "all_gather", "allgather", "broadcast")


class _Follower:
    """A ``tg-torch sim-worker`` process on card 0, its output lines read as
    they come with their arrival time (seconds after the spawn)."""

    def __init__(self, coord, once=True):
        import threading

        argv = [sys.executable, "-m", "testground_tpu_torch.cli", "sim-worker",
                "--coordinator", coord, "--num-processes", "2", "--process-id", "1",
                "--plans", os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                        "testground_tpu_torch", "plans")]
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(argv + (["--once"] if once else []),
                                     stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                     text=True)
        self.lines = []
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()

    def _read(self):
        for line in self.proc.stdout:
            self.lines.append((time.perf_counter() - self.t0, line.rstrip("\n")))

    def at(self, needle):
        """(seconds after the spawn, line) of the first line holding
        ``needle``, or None."""
        return next(((t, ln) for t, ln in self.lines if needle in ln), None)

    def done(self, timeout=60.0):
        try:
            self.proc.wait(timeout=timeout)
        finally:
            self.kill()
        self._reader.join(timeout=5)
        return self.proc.returncode

    def kill(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()

    def text(self):
        return "\n".join(ln for _, ln in self.lines)


def _spans(run_dir) -> list:
    path = os.path.join(run_dir, "run_spans.jsonl")
    return [json.loads(ln)["event"] | {"ts": json.loads(ln)["ts"]}
            for ln in _lines(path)] if os.path.exists(path) else []


def _leader_line(text, prefix):
    import re

    m = re.search(re.escape(prefix) + r" (\d+), launches (\{[^}]*\})", text)
    check(m is not None, f"cohort: no '{prefix}' line in the leader's log")
    return int(m.group(1)), json.loads(m.group(2))


def _cohort_trace(run_dir, ticks) -> dict:
    """Kernels, device ms and each collective's host ms a tick off the
    leader's ``profile_chunks`` Chrome trace (``<run>/profiles``), and the
    transport kernels' device ms a launch."""
    paths = [os.path.join(r, f) for r, _, fs in os.walk(os.path.join(run_dir, "profiles"))
             for f in fs if f.endswith(".json")]
    check(bool(paths), f"cohort: no profiler trace under {run_dir}")
    with open(paths[0]) as f:
        events = [e for e in json.load(f).get("traceEvents", []) if e.get("ph") == "X"]
    dev = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    coll = {}
    for e in events:
        name = str(e.get("name", ""))
        if e.get("cat") in ("cpu_op", "user_annotation") and any(
                c in name.lower() for c in COHORT_COLLECTIVES):
            coll[name] = coll.get(name, 0.0) + float(e.get("dur", 0.0)) / 1e3
    kernels, kernel_ms = {}, {}
    for e in dev:
        if e.get("cat") == "kernel":
            k = str(e.get("name", "")).split("(")[0][:40]
            kernels[k] = kernels.get(k, 0) + 1
            kernel_ms[k] = kernel_ms.get(k, 0.0) + float(e.get("dur", 0.0)) / 1e3
    return {
        "profiled_ticks": ticks,
        "kernels_per_tick": len(dev) / ticks,
        "device_ms_per_tick": sum(float(e.get("dur", 0.0)) for e in dev) / 1e3 / ticks,
        "collective_ms_per_tick": {k: v / ticks for k, v in coll.items()},
        "transport_kernels_per_tick": {k: v / ticks for k, v in kernels.items()
                                       if k.startswith(TRANSPORT_KERNELS)},
        "transport_device_ms_per_launch": {k: kernel_ms[k] / v for k, v in kernels.items()
                                           if k.startswith(TRANSPORT_KERNELS)},
    }


def phase_cohort(card) -> dict:
    """A two-process cohort on card 0 (both ranks on one card: the
    collectives go over gloo): sustained@100k at phase 4's parameters (501
    ticks, chunk 250) through ``execute_sim_run`` with ``coordinator_address``
    (the leader child) and one ``tg-torch sim-worker`` process; then, in
    the same cohort, a 128-tick twin (chunk 64) whose second chunk the
    leader profiles (kernels, device ms and the collectives' ms a tick).
    Then a 10,000-tick cohort whose follower is SIGKILLed after its first
    chunk: the task fails with ``CohortBrokenError``'s text within 60 s.
    Then the same composition without a coordinator on the card (it runs
    after the death), and its carry through ``SimProgram.run``: outcome,
    per-group outcomes, journal metrics and flow totals equal to the
    cohort's, and its carry digest equal to the leader's and the
    follower's digest of the whole carry gathered from both ranks. Between
    them, the placed carry (``testground_tpu_torch/cohort_ab.py``: two
    rank processes of a library cohort, the program alone here) at 100k
    and 1M, 64 ticks: each rank's peak device bytes and carry bytes
    against the program alone (a rank must hold under 3/4 of them; the
    footprint, the reference's global bytes, equal), its collectives'
    bytes and host ms a tick. Reports wall ms/tick of both, join and
    first-chunk seconds of each process, the backend."""
    import socket
    import tempfile
    import threading

    from testground_tpu_torch import cohort_ab
    from testground_tpu_torch.rpc import OutputWriter, discard_writer
    from testground_tpu_torch.sim.cohort import CohortBrokenError, shutdown_leader_child
    from testground_tpu_torch.sim.engine import carry_digest
    from testground_tpu_torch.sim.executor import execute_sim_run

    n = 100_000
    root = tempfile.mkdtemp(prefix="chip_smoke_cohort_")
    row = {"phase": "cohort", "n": n, "card": card, "step_s": {}}
    t_step = [time.perf_counter()]

    def step(name):
        now = time.perf_counter()
        row["step_s"][name] = now - t_step[0]
        t_step[0] = now

    def free_coord():
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            return f"127.0.0.1:{sock.getsockname()[1]}"

    class Sink:
        def __init__(self):
            self.chunks = []

        def write(self, text):
            self.chunks.append(text)

        def flush(self):
            pass

        def text(self):
            return "".join(json.loads(c).get("p", "") for c in "".join(
                self.chunks).splitlines() if c.startswith("{"))

    def lead(job, sink, cancel=None):
        t0 = time.perf_counter()
        try:
            out = execute_sim_run(job, OutputWriter(sink=sink), cancel or threading.Event())
        except Exception as e:  # noqa: BLE001 — the death step expects one
            out = e
        return out, time.perf_counter() - t0

    ticks = 501  # max_ticks: the run ends at its own tick
    flow_keys = ("ticks", "msgs_sent", "msgs_delivered", "msgs_enqueued", "msgs_dropped",
                 "msgs_rejected", "msgs_in_flight", "msgs_fault_dropped", "latency_clamped",
                 "bw_queue_dropped", "pub_dropped", "carry_bytes")
    follower = None
    try:
        # (a) the cohort: the timed run, then its profiled twin
        coord = free_coord()
        cfg = dict(chunk=250, max_ticks=ticks, coordinator_address=coord, num_processes=2)
        follower = _Follower(coord, once=False)
        sink = Sink()
        t_lead = time.perf_counter()
        out, lead_wall = lead(exec_job("cohort", root, "network", "pingpong-sustained", n,
                                       SUSTAINED, device=None, **cfg), sink)
        check(not isinstance(out, Exception), f"cohort: the run failed: {out}")
        log = sink.text()
        sim = out.result.journal["sim"]
        check(out.result.outcome.value == "success", f"cohort: outcome {out.result.outcome}")
        check((sim["processes"], sim["devices"]) == (2, 2), f"cohort: {sim['processes']}")
        check("multi-host: 2 processes, 2 global devices, leader=0, collectives over gloo"
              in log, "cohort: the multi-host line")
        check("perf" not in sim, "cohort: a perf ledger under a cohort")
        digest, lead_launches = _leader_line(log, "multi-host: carry digest")
        _wait_for(lambda: follower.at("run cohort carry digest"), "the follower's digest",
                  60)
        f_digest = int(follower.at("run cohort carry digest")[1].split("carry digest ")[1]
                       .split(",")[0])
        f_line = follower.at("run cohort carry digest")[1]
        f_launches = json.loads(f_line.split("launches ")[1].split(", first chunk")[0])
        check(f_digest == digest, f"cohort: follower digest {f_digest} != leader {digest}")
        # one sharded K2 a tick on each rank and one sharded K1 a tick that
        # brings the rank messages of its own lanes, no unmeshed launch:
        # the pops count the ticks that ran
        real = lead_launches["pop_bucket_sharded"]
        for who, got in (("leader", lead_launches), ("follower", f_launches)):
            check(got["pop_bucket_sharded"] == real > 0
                  and 0 < got["commit_calendar_sharded"] <= real
                  and got["commit_calendar"] == got["pop_bucket"] == 0,
                  f"cohort: {who} launches {got}")
        spans = _spans(os.path.join(root, "network", "cohort"))
        starts = {e["span"]: e["ts"] for e in spans if e["type"] == "span_start"}
        row["cohort"] = {
            "ticks": real, "wall_s": sim["wall_secs"],
            "wall_ms_per_tick": sim["wall_secs"] / real * 1e3,
            "steady_ms_per_tick": (sim["wall_secs"] - sim["compile_secs"])
            / (real - 250) * 1e3,
            "call_s": lead_wall, "leader_join_s": (starts["build"] - starts["run"]) / 1e9,
            "leader_first_chunk_s": sim["compile_secs"],
            # from the follower's spawn (its interpreter and torch import too)
            "follower_joined_after_spawn_s": follower.at("joined")[0],
            "follower_spawn_before_leader_s": t_lead - follower.t0,
            "follower_first_chunk_s": float(f_line.split("first chunk ")[1].split(" s")[0]),
            "digest": digest, "leader_launches": lead_launches,
            "follower_launches": f_launches, "mesh": sim["mesh"],
        }
        step("cohort")
        out2, _ = lead(exec_job("cohort-prof", root, "network", "pingpong-sustained", n,
                                SUSTAINED, device=None, **{**cfg, "chunk": 64,
                                                            "max_ticks": 128},
                                profile=True, profile_chunks=1), Sink())
        check(not isinstance(out2, Exception), f"cohort: the profiled run failed: {out2}")
        row["profiled"] = _cohort_trace(os.path.join(root, "network", "cohort-prof"), 64)
        shutdown_leader_child()  # the sentinel ends the follower
        check(follower.done() == 0, f"cohort: follower exit {follower.proc.returncode}")
        check(follower.at("sim-worker: shutdown") is not None, "cohort: no shutdown")
        launches = {"commit_calendar_sharded": lead_launches["commit_calendar_sharded"],
                    "pop_bucket_sharded": lead_launches["pop_bucket_sharded"]}
        step("profiled")

        # (a') the placed carry: each rank's peak device bytes, its carry's
        # bytes against the program alone, its collectives' bytes and host
        # ms a tick, at 100k and at 1M (a library cohort of 64 ticks)
        row["placed"] = {}
        here = os.path.dirname(os.path.abspath(__file__))
        for size, ranks in cohort_ab.ranks(here, [n, 1_000_000], 64).items():
            one = cohort_ab.alone(size, 64)
            for r in ranks:
                check(r["footprint"] == one["footprint"],
                      f"cohort: rank {r['rank']} footprint {r['footprint']} at {size}")
                check(r["carry_bytes"] < 0.75 * one["carry_bytes"],
                      f"cohort: rank {r['rank']} holds {r['carry_bytes']} of "
                      f"{one['carry_bytes']} bytes at {size}")
            row["placed"][str(size)] = {"ranks": ranks, "alone": one}
        row["collective_bytes_per_tick"] = {
            op: v["bytes"] for op, v in
            row["placed"][str(n)]["ranks"][0]["collectives_per_tick"].items()}
        step("placed")

        # (b) a member's death after the first chunk of a 10,000-tick run
        coord = free_coord()
        follower = _Follower(coord)
        dparams = dict(SUSTAINED, duration_ticks="10000")
        djob = exec_job("death", root, "network", "pingpong-sustained", n, dparams,
                        device=None, chunk=250, max_ticks=10_000,
                        coordinator_address=coord, num_processes=2)
        box = {}
        th = threading.Thread(target=lambda: box.update(r=lead(djob, Sink())), daemon=True)
        th.start()
        _wait_for(lambda: any(e["span"] == "chunk" for e in
                              _spans(os.path.join(root, "network", "death"))),
                  "the death run's first chunk", 120)
        follower.proc.send_signal(9)
        t_kill = time.perf_counter()
        th.join(90)
        died_s = time.perf_counter() - t_kill
        check(not th.is_alive(), "cohort: the leader did not fail within 90 s")
        err = box["r"][0]
        check(isinstance(err, CohortBrokenError), f"cohort: death gave {err!r}")
        check("cohort member" in str(err).lower() and "sim-worker" in str(err),
              f"cohort: death message {err}")
        check(died_s < 60, f"cohort: the task failed {died_s:.1f} s after the kill")
        follower.done(10)
        row["death"] = {"fail_s": died_s, "error": str(err)[:300]}
        shutdown_leader_child()
        step("death")

        # (c) the same composition alone on the card, after the death
        out1, wall1 = lead(exec_job("single", root, "network", "pingpong-sustained", n,
                                    SUSTAINED, device=None, chunk=250, max_ticks=ticks),
                           Sink())
        check(not isinstance(out1, Exception), f"cohort: the single run failed: {out1}")
        single = out1.result.journal["sim"]
        check(out1.result.outcome == out.result.outcome, "cohort: outcomes differ")
        check({k: v.to_dict() for k, v in out1.result.outcomes.items()}
              == {k: v.to_dict() for k, v in out.result.outcomes.items()},
              "cohort: per-group outcomes differ")
        check(out1.result.journal.get("metrics") == out.result.journal.get("metrics")
              and out1.result.journal["events"] == out.result.journal["events"],
              "cohort: journal metrics differ")
        for k in flow_keys:
            check(single[k] == sim[k], f"cohort: {k} {single[k]} != {sim[k]}")
        prog = program("pingpong-sustained", n, SUSTAINED, chunk=250)
        _, _, _, carry = run_timed(prog, max_ticks=ticks)
        one = carry_digest(carry)
        check(one == digest, f"cohort: single digest {one} != leader {digest}")
        row["single"] = {
            "ticks": real, "wall_s": single["wall_secs"],
            "wall_ms_per_tick": single["wall_secs"] / real * 1e3,
            "steady_ms_per_tick": (single["wall_secs"] - single["compile_secs"])
            / (real - 250) * 1e3,
            "first_chunk_s": single["compile_secs"], "call_s": wall1,
        }
        row["wall_ratio"] = row["cohort"]["wall_ms_per_tick"] / row["single"]["wall_ms_per_tick"]
        row["backend"] = "gloo"
        row["launches"] = launches
        step("single")
    finally:
        if follower is not None:
            follower.kill()
        shutdown_leader_child()
    return row


# the sync service's rungs (backend, clients): 1,000 on both backends, and
# the native server at 10k (the fan-in bench's top rung); each client
# sends SYNC_SIGNAL_OPS signals (the bench sends 20; 4 keep the phase
# inside its share of the script), joins one barrier as wide as the rung,
# and all but one subscribe to SYNC_PUB_ENTRIES publishes
SYNC_RUNGS = (("native", 1000), ("python", 1000), ("native", 10_000))
SYNC_SIGNAL_OPS = 4
SYNC_PUB_ENTRIES = 5


def _fanin(driver, port, clients, timeout=120.0) -> list:
    """The port's ``tg-fanin-driver`` (``native/fanin_driver.cc``) through
    its four phases: one ``go`` line each on its stdin, one JSON record
    each on its stdout (connect, flood, storm, pubsub)."""
    proc = subprocess.Popen(
        [driver, "--host", "127.0.0.1", "--port", str(port), "--clients",
         str(clients), "--total", str(clients), "--signal-ops",
         str(SYNC_SIGNAL_OPS), "--pub-subs", str(clients - 1), "--pub-entries",
         str(SYNC_PUB_ENTRIES), "--timeout", str(timeout)],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
    try:
        recs = []
        for _ in range(4):
            proc.stdin.write("go\n")
            proc.stdin.flush()
            line = proc.stdout.readline()
            check(bool(line), f"fan-in driver died after {len(recs)} phases")
            recs.append(json.loads(line))
        proc.stdin.close()
        check(proc.wait(timeout=60) == 0, "fan-in driver exit code")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    return recs


def _sync_stats_json(addr) -> dict:
    """``tg-torch sync-stats ADDR --json``: the port's CLI entry point, in
    process."""
    import contextlib
    import io

    from testground_tpu_torch.cli.main import main as cli_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(["sync-stats", addr, "--json", "--timeout", "10"])
    check(rc == 0, f"sync-stats {addr} exited {rc}")
    return json.loads(buf.getvalue())


def _scrape_sync(url) -> dict:
    """The counters of a ``/metrics`` scrape of the sync service: the
    ``tg_sync_ops_total`` series by op and the connection accepts."""
    import re
    import urllib.request

    text = urllib.request.urlopen(url, timeout=10).read().decode()
    ops = {m.group(1): int(float(m.group(2))) for m in re.finditer(
        r'^tg_sync_ops_total\{op="([a-z_]+)"\} (\S+)$', text, re.M)}
    acc = re.search(r"^tg_sync_conn_accepts_total (\S+)$", text, re.M)
    return {"ops": ops, "accepts": int(float(acc.group(1))) if acc else None}


def _process_tree(pid) -> list:
    """``pid`` and its descendants (``/proc/<pid>/task/*/children``)."""
    out, todo = [], [pid]
    while todo:
        p = todo.pop()
        out.append(p)
        try:
            for task in os.listdir(f"/proc/{p}/task"):
                with open(f"/proc/{p}/task/{task}/children") as f:
                    todo += [int(c) for c in f.read().split()]
        except OSError:
            pass
    return out


def _maps_cuda(pid) -> bool:
    """Whether the process has the CUDA driver library mapped."""
    try:
        with open(f"/proc/{pid}/maps") as f:
            return "libcuda.so" in f.read()
    except OSError:
        return False


def _compute_pids() -> list:
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return [int(x) for x in out.split() if x.strip().isdigit()]


def phase_sync(card) -> dict:
    """The sync service on the card's host, through the port only: the
    port's ``tg-syncsvc`` and ``tg-fanin-driver`` built with g++ side by
    side (wall seconds), then for each rung of ``SYNC_RUNGS`` a fresh
    ``tg-torch sync-service`` process on the rung's backend (``--backend
    native`` or ``python``, ``--metrics-port 0``) and against it the
    fan-in driver's connect, flood, barrier storm as wide as the clients
    and pubsub (the
    soft ``RLIMIT_NOFILE`` raised toward the hard one for the 10k rung;
    a hard limit too low for it runs the rung it allows, and says so).
    Checks: no driver error; the server's op counters, read with
    ``tg-torch sync-stats --json`` before and after, grew by exactly the
    operations driven; a ``/metrics`` scrape between two such reads
    reconciles with both; no service process holds a CUDA context. Prints
    connects/s, flood ops/s with p50/p99, barrier p50/p99 and pubsub
    deliveries/s for each rung."""
    import resource
    import shutil
    import signal
    import tempfile
    import threading

    from testground_tpu_torch.native import (
        build_fanin_driver,
        build_syncsvc,
        native_available,
    )

    check(native_available(), "no g++ for the native sync service")
    here = os.path.dirname(os.path.abspath(__file__))
    root = tempfile.mkdtemp(prefix="chip_smoke_sync_")
    home = os.path.join(root, "home")
    bin_dir = os.path.join(home, "data", "work", "bin")
    row = {"phase": "sync", "card": card, "launches": {}, "rungs": []}

    # 1. both binaries at once, into the bin dir the CLI's boot reads
    built, errs = {}, []

    def build(name, fn):
        t = time.perf_counter()
        try:
            built[name] = (fn(bin_dir), time.perf_counter() - t)
        except Exception as e:  # noqa: BLE001 — re-raised below
            errs.append(f"{name}: {e}")

    t0 = time.perf_counter()
    threads = [threading.Thread(target=build, args=a) for a in
               (("tg-syncsvc", build_syncsvc), ("tg-fanin-driver", build_fanin_driver))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    check(not errs and len(built) == 2, f"native builds failed: {errs}")
    row["build_s"] = {k: v[1] for k, v in built.items()}
    row["build_wall_s"] = time.perf_counter() - t0
    driver = built["tg-fanin-driver"][0]

    # the 10k rung needs that many sockets in the driver and in the server
    soft0, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    need = max(n for _, n in SYNC_RUNGS) + 512
    soft = max(soft0, need)
    if hard != resource.RLIM_INFINITY:
        soft = min(soft, hard)
    if soft > soft0:
        resource.setrlimit(resource.RLIMIT_NOFILE, (soft, hard))
    row["nofile"] = {"soft_before": soft0, "soft": soft,
                     "hard": None if hard == resource.RLIM_INFINITY else hard}
    rungs = [(b, n if n + 512 <= soft else soft - 512) for b, n in SYNC_RUNGS]
    if rungs != list(SYNC_RUNGS):
        row["nofile"]["cut"] = f"RLIMIT_NOFILE {soft}: rungs {rungs}"
        print(f"chip_smoke sync: RLIMIT_NOFILE hard limit {hard} allows "
              f"rungs {rungs}, not {list(SYNC_RUNGS)}", flush=True)

    def start(backend, n):
        err = open(os.path.join(root, f"{backend}-{n}.err"), "w")
        proc = subprocess.Popen(
            [sys.executable, "-m", "testground_tpu_torch.cli", "sync-service",
             "--backend", backend, "--port", "0", "--metrics-port", "0",
             "--stats-interval", "0"],
            cwd=here, stdout=subprocess.PIPE, stderr=err, text=True,
            env={**os.environ, "TESTGROUND_HOME": home, "PYTHONPATH": here})
        service[:] = [proc, err]
        lines = [proc.stdout.readline().strip() for _ in range(2)]
        listen = [ln.split() for ln in lines if ln.startswith("LISTENING ")]
        metrics = [ln.split()[1] for ln in lines if ln.startswith("METRICS ")]
        check(bool(listen and metrics), f"sync-service {backend} printed {lines}")
        return f"127.0.0.1:{listen[0][2]}", metrics[0]

    def stop():
        proc, err = service
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        err.close()
        service.clear()
        return proc.returncode

    service = []  # [process, its stderr file] of the rung's service
    row["exit"], row["service_pids"], row["compute_app_pids"] = [], [], []
    try:
        # 2.-6. each rung on a fresh service process (the driver's barrier
        # state and pubsub topic are the same names every rung): its
        # conservation and the scrape around it
        for backend, n in rungs:
            t = time.perf_counter()
            addr, metrics_url = start(backend, n)
            up_s = time.perf_counter() - t
            before = _sync_stats_json(addr)
            recs = _fanin(driver, int(addr.rsplit(":", 1)[1]), n)
            after = _sync_stats_json(addr)
            scrape = _scrape_sync(metrics_url)
            last = _sync_stats_json(addr)
            # 7. the service never opens a CUDA context
            pids = _process_tree(service[0].pid)
            on_card = set(_compute_pids())
            row["service_pids"].append(pids)
            row["compute_app_pids"].append(sorted(on_card))
            check(not on_card & set(pids), f"a service process is a compute app: {pids}")
            check(not any(_maps_cuda(p) for p in pids), "a service process maps libcuda")
            row["exit"].append(stop())
            errors = [e for r in recs for e in r.get("errors", [])]
            check(not errors, f"{backend}@{n}: driver errors {errors[:5]}")
            connect, flood, storm, pubsub = recs
            check(connect["connected"] == n, f"{backend}@{n}: {connect['connected']} connected")
            check(len(flood["lats_ms"]) == n * SYNC_SIGNAL_OPS, f"{backend}@{n}: flood replies")
            check(len(storm["lats_ms"]) == n, f"{backend}@{n}: barrier replies")
            check(pubsub.get("delivered") == (n - 1) * SYNC_PUB_ENTRIES,
                  f"{backend}@{n}: pubsub delivered {pubsub.get('delivered')}")
            # the driven ops, and the after-read's own sync_stats
            driven = {"signal_entry": n * SYNC_SIGNAL_OPS, "signal_and_wait": n,
                      "subscribe": n - 1, "publish": SYNC_PUB_ENTRIES, "sync_stats": 1}
            delta = {op: after["ops"][op] - before["ops"][op] for op in after["ops"]}
            check(delta == {op: driven.get(op, 0) for op in after["ops"]},
                  f"{backend}@{n}: op counters grew {delta}, driven {driven}")
            # the scrape's own fetch counts itself, and the last read too
            bump = {"sync_stats": after["ops"]["sync_stats"] + 1}
            check(scrape["ops"] == {**after["ops"], **bump},
                  f"{backend}@{n}: /metrics ops {scrape['ops']} vs {after['ops']}")
            check(scrape["accepts"] == after["conn"]["accepts"] + 1,
                  f"{backend}@{n}: /metrics accepts")
            check(last["ops"] == {**after["ops"],
                                  "sync_stats": after["ops"]["sync_stats"] + 2},
                  f"{backend}@{n}: ops after the scrape")
            lat_f, lat_s = flood["lats_ms"], storm["lats_ms"]
            row["rungs"].append({
                "backend": backend, "clients": n, "service_up_s": up_s,
                "connects_per_s": n / connect["wall"] if connect["wall"] else None,
                "flood_ops_per_s": len(lat_f) / flood["wall"] if flood["wall"] else None,
                "flood_p50_ms": float(np.percentile(lat_f, 50)),
                "flood_p99_ms": float(np.percentile(lat_f, 99)),
                "barrier_p50_ms": float(np.percentile(lat_s, 50)),
                "barrier_p99_ms": float(np.percentile(lat_s, 99)),
                "barrier_wall_s": storm["wall"],
                "pubsub_delivered": pubsub["delivered"],
                "pubsub_delivered_per_s": (pubsub["delivered"] / pubsub["wall"]
                                           if pubsub["wall"] else None),
                "ops_driven": sum(driven.values()) - 1,
                "ops_conserved": True, "metrics_reconciled": True,
                "seconds": time.perf_counter() - t,
            })
        row["cuda_context"] = False
    finally:
        if service:
            row["exit"].append(stop())
        if soft > soft0:
            resource.setrlimit(resource.RLIMIT_NOFILE, (soft0, hard))
        shutil.rmtree(root, ignore_errors=True)
    check(row["exit"] == [0] * len(rungs), f"sync-service exits {row['exit']}")
    return row


# phase exec: the local:exec runs (plan, case or composition, instances,
# builder, groups whose instances write run.out), placebo:ok's instance
# count and the home's runner config (the native sync service: the card's
# host has g++)
EXEC_N = 64
EXEC_ENV = '[runners."local:exec"]\nsync_service = "native"\n'
POLYGLOT_TOML = """[metadata]
name = "polyglot-rendezvous"

[global]
plan = "polyglot"
case = "rendezvous"
builder = "exec:py"
runner = "local:exec"

[[groups]]
id = "pythons"
builder = "exec:py"
[groups.instances]
count = 4

[[groups]]
id = "perls"
builder = "exec:bin"
[groups.instances]
count = 4
"""


class _InstanceWatch:
    """Samples this process's children while the ``local:exec`` runs go:
    each instance process (its command line names a build snapshot,
    ``exec-py--`` or ``exec-bin--``) and each sync server (``tg-syncsvc``)
    is read once it has exec'd: whether it maps ``libcuda``, and whether
    ``nvidia-smi --query-compute-apps`` lists it."""

    def __init__(self):
        import threading

        self.seen, self.cuda, self.on_card = {}, set(), set()
        self.smi_calls = 0
        self._stop = threading.Event()
        self._threads = [threading.Thread(target=self._maps, daemon=True),
                         threading.Thread(target=self._smi, daemon=True)]

    def _ours(self):
        me, out = os.getpid(), {}
        for pid in _process_tree(me):
            if pid == me:
                continue
            try:
                with open(f"/proc/{pid}/cmdline", "rb") as f:
                    cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
            except OSError:
                continue
            if "exec-py--" in cmd or "exec-bin--" in cmd:
                out[pid] = "instance"
            elif "tg-syncsvc" in cmd:
                out[pid] = "sync-service"
        return out

    def _maps(self):
        while not self._stop.is_set():
            for pid, kind in self._ours().items():
                self.seen.setdefault(pid, kind)
                if _maps_cuda(pid):
                    self.cuda.add(pid)
            time.sleep(0.02)

    def _smi(self):
        while not self._stop.is_set():
            ours = self._ours()
            self.on_card |= set(_compute_pids()) & set(ours)
            self.smi_calls += 1
            self._stop.wait(0.2)

    def __enter__(self):
        for t in self._threads:
            t.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        for t in self._threads:
            t.join()
        return False

    def counts(self) -> dict:
        kinds = list(self.seen.values())
        return {"instances": kinds.count("instance"),
                "sync_services": kinds.count("sync-service")}


def phase_exec(card) -> dict:
    """The ``local:exec`` runner on the card's host, through the port's CLI
    (in process, a temporary ``TESTGROUND_HOME`` whose ``.env.toml`` picks
    the native sync service): ``placebo:ok`` at 64 instances on
    ``exec:py``, ``example:sync`` at 16, ``network:ping-pong`` at 2 and 4
    (real TCP between the instances, their addresses exchanged through the
    sync service; each dialer prints its two ``round N rtt`` lines),
    ``example-cpp:sync`` at 16 on ``exec:bin`` (its ``build.sh`` runs g++)
    and, with perl, the ``polyglot`` rendezvous of four Python and four
    Perl instances; each to all SUCCESS, and ``collect`` of each, whose
    tarball holds every instance directory (and each Python instance's
    ``run.out``). The same
    ``placebo:ok`` at 64 on ``sim:torch`` on the card gives the same
    outcome. No instance or sync-server process maps ``libcuda`` or is a
    compute app, read while they run. Prints instances/s and the runner's
    wall seconds to all outcomes of each run."""
    import re
    import shutil
    import tarfile
    import tempfile
    import threading

    from testground_tpu_torch.native import build_syncsvc, native_available

    check(native_available(), "no g++ for the native sync service and example-cpp")
    root = tempfile.mkdtemp(prefix="chip_smoke_exec_")
    home = cli_home(root, "home", EXEC_ENV)
    comp = os.path.join(root, "polyglot.toml")
    with open(comp, "w") as f:
        f.write(POLYGLOT_TOML)
    row = {"phase": "exec", "card": card, "launches": {}, "runs": {}}
    runs = [("placebo:ok", ["run", "single", "placebo:ok", "-i", str(EXEC_N), "--builder",
                            "exec:py", "--runner", "local:exec"], {"single": EXEC_N}, True),
            ("example:sync", ["run", "single", "example:sync", "-i", "16", "--builder",
                              "exec:py", "--runner", "local:exec"], {"single": 16}, True),
            *((f"network:ping-pong@{k}", ["run", "single", "network:ping-pong", "-i",
                                          str(k), "--builder", "exec:py", "--runner",
                                          "local:exec"], {"single": k}, True)
              for k in (2, 4)),
            ("example-cpp:sync", ["run", "single", "example-cpp:sync", "-i", "16",
                                  "--builder", "exec:bin", "--runner", "local:exec"],
             {"single": 16}, False)]
    if shutil.which("perl"):
        runs.append(("polyglot:rendezvous", ["run", "composition", "-f", comp],
                     {"pythons": 4, "perls": 4}, None))
    else:
        row["polyglot"] = "skipped: no perl on this host"
    try:
        # the native server built while the card runs placebo:ok on sim:torch
        built = {}

        def build():
            t = time.perf_counter()
            built["path"] = build_syncsvc(os.path.join(home, "data", "work", "bin"))
            built["s"] = time.perf_counter() - t

        builder = threading.Thread(target=build)
        builder.start()
        reset_launches()
        sim = cli_call(home, ["run", "single", "placebo:ok", "-i", str(EXEC_N),
                              "--builder", "sim:plan", "--runner", "sim:torch"])
        row["launches"] = read_launches(KERNELS + SHARDED_KERNELS)
        builder.join()
        check("path" in built, "tg-syncsvc did not build")
        row["syncsvc_build_s"] = built["s"]
        check(sim["rc"] == 0 and "(outcome: success)" in sim["out"],
              f"exec: sim:torch placebo:ok: {sim['out'][-1500:]} {sim['err'][-1500:]}")
        row["sim"] = {"wall_s": sim["wall"],
                      "runner_wall_s": sim["task"].result["perf"]["runner_wall_secs"]["default"],
                      "outcomes": sim["task"].result["outcomes"]}
        with _InstanceWatch() as watch:
            for label, argv, groups, py_out in runs:
                got = cli_call(home, argv)
                check(got["rc"] == 0 and "(outcome: success)" in got["out"],
                      f"exec {label}: exit {got['rc']}: {got['out'][-1500:]} "
                      f"{got['err'][-1500:]}")
                task = got["task"]
                want = {g: {"total": n, "ok": n} for g, n in groups.items()}
                check(task.result["outcomes"] == want,
                      f"exec {label}: outcomes {task.result['outcomes']}")
                tgz = os.path.join(root, f"{task.id}.tgz")
                col = cli_call(home, ["collect", task.id, "-o", tgz])
                check(col["rc"] == 0, f"exec {label}: collect exit {col['rc']}: {col['err']}")
                with tarfile.open(tgz) as tar:
                    names = set(tar.getnames())
                    outs = [tar.extractfile(m).read().decode() for m in tar.getmembers()
                            if m.name.endswith("/run.out")]
                for g, n in groups.items():
                    for i in range(n):
                        inst = f"{task.id}/{g}/{i}"
                        check(inst in names, f"exec {label}: {inst} not collected")
                        if py_out or (py_out is None and g == "pythons"):
                            check(f"{inst}/run.out" in names,
                                  f"exec {label}: {inst}/run.out not collected")
                n = sum(groups.values())
                runner_wall = task.result["perf"]["runner_wall_secs"]["default"]
                row["runs"][label] = {
                    "instances": n, "wall_s": got["wall"], "runner_wall_s": runner_wall,
                    "instances_per_s": n / runner_wall, "collect_s": col["wall"],
                    "tarball_members": len(names)}
                if label.startswith("network:"):
                    rtts = [m.group(0) for text in outs
                            for m in re.finditer(r"round \d rtt: [0-9.]+ ms", text)]
                    check(len(rtts) == 2 * (n // 2),
                          f"exec {label}: {len(rtts)} rtt lines, want two a dialer")
                    row["runs"][label]["rtt_lines"] = rtts
                    for ln in rtts:
                        print(f"chip_smoke exec: {label}: {ln}", flush=True)
                print(f"chip_smoke exec: {label} at {n} instances: "
                      f"{n / runner_wall:.1f} instances/s, {runner_wall:.3f} s to all "
                      f"outcomes ({got['wall']:.3f} s through the CLI)", flush=True)
        check(row["sim"]["outcomes"] == {"single": {"total": EXEC_N, "ok": EXEC_N}},
              f"exec: sim:torch outcomes {row['sim']['outcomes']}")
        row["watch"] = {**watch.counts(), "smi_calls": watch.smi_calls}
        check(row["watch"]["instances"] > 0 and watch.smi_calls > 0,
              f"exec: no instance process was seen running: {row['watch']}")
        check(not watch.cuda, f"exec: processes mapping libcuda: {sorted(watch.cuda)}")
        check(not watch.on_card, f"exec: processes on the card: {sorted(watch.on_card)}")
        row["cuda_context"] = False
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES))
    args = ap.parse_args(argv)
    phases = args.phases.split(",")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    # the port itself; in a directory without it this import fails
    from testground_tpu_torch.sim import cuda_transport as ct

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    card = {"name": name, "smi": smi}
    emit({"phase": "device", "name": name, "count": torch.cuda.device_count(),
          "smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda})

    path, build_s, log = ct.build_kernels()
    emit({"phase": "build", "library": path.rsplit("/", 1)[-1],
          "seconds": build_s, "log": log[-2000:]})

    kernel_rows = []
    if "kernels" in phases:
        t0 = time.perf_counter()
        N = 100_000
        cases = [
            commit_case("flagship", 8, N, 4, 1, 2 * N, False, True, False, 1),
            commit_case("pingpong", 128, N, 4, 2, 2 * N, False, True, False, 2),
            commit_case("bool-nostack-etick", 16, 4096, 4, 2, 8192, True, False, True, 3),
            commit_case("int-etick", 16, 4096, 2, 3, 8192, False, True, True, 4),
            commit_case("straddling-run", 16, 4096, 4, 2, 8192, False, True, True, 9,
                        stream="straddle"),
            commit_case("heavy-fan-in", 16, 4096, 4, 1, 8192, False, True, False, 10,
                        stream="fanin"),
            commit_case("slots-1", 8, N, 1, 1, 2 * N, False, True, False, 11),
            commit_case("width-8", 16, 4096, 4, 8, 8192, False, True, True, 12),
            commit_case("storm", 8, N, 16, 1, 5 * N, True, False, False, 14,
                        stream="poisson"),
            commit_case("duplicate", 8, N, 4, 1, 4 * N, False, True, False, 15,
                        stream="dup"),
            pop_case("flagship", 8, N, 4, 1, False, 5),
            pop_case("pingpong", 128, N, 4, 2, False, 6),
            pop_case("bool", 16, 4096, 4, 2, True, 7),
            pop_case("odd-row", 16, 4095, 3, 1, False, 8),
            pop_case("width-8", 16, 4096, 4, 8, False, 13),
            pop_case("flood", 8, N, 1, 1, True, 16),
            pop_case("storm", 8, N, 16, 1, True, 17),
            pop_case("horizon-256", 256, N, 1, 1, True, 18),
            # additional_hosts at 1,024 instances: 1,025 lanes, L=4, W=2
            commit_case("hosts-lanes", 4, 1025, 4, 2, 4 * 1025, False, True, False, 19),
            pop_case("hosts-lanes", 4, 1025, 4, 2, False, 20),
            # the telemetry plane's commit on sustained (the etick plane),
            # and flood's pop under the traffic matrix (int32 occupancy)
            commit_case("flagship-etick", 8, N, 4, 1, 2 * N, False, True, True, 21),
            pop_case("flood-int32", 8, N, 1, 1, False, 22),
            # the mesh path: the sharded K1 and K2 on virtual meshes on card 0
            sharded_commit_case("flagship", 4, 8, N, 4, 1, 2 * N, False, True, False, 31),
            sharded_commit_case("flagship-S8", 8, 8, N, 4, 1, 2 * N, False, True, False,
                                32),
            sharded_commit_case("pingpong", 4, 128, N, 4, 2, 2 * N, False, True, False, 33),
            sharded_commit_case("storm", 4, 8, N, 16, 1, 5 * N, True, False, False, 34,
                                stream="poisson"),
            sharded_commit_case("flagship-etick", 4, 8, N, 4, 1, 2 * N, False, True, True,
                                35),
            sharded_commit_case("one-shard", 4, 16, 4096, 4, 2, 8192, False, True, True,
                                36, dst="one-shard"),
            sharded_commit_case("empty-shard", 4, 16, 4096, 4, 2, 8192, True, True, False,
                                37, dst="empty-shard"),
            sharded_commit_case("width-8", 4, 16, 4096, 4, 8, 8192, False, True, True, 38),
            sharded_commit_case("straddling-run", 4, 16, 4096, 4, 2, 8192, False, True,
                                True, 39, stream="straddle"),
            sharded_commit_case("heavy-fan-in", 8, 16, 4096, 4, 1, 8192, False, True,
                                False, 40, stream="fanin"),
            sharded_commit_case("parts-1+3", 4, 8, N, 4, 1, 2 * N, False, True, True, 41,
                                parts=(1,)),
            sharded_pop_case("flagship", 4, 8, N, 4, 1, False, 51),
            sharded_pop_case("flagship-S8", 8, 8, N, 4, 1, False, 52),
            sharded_pop_case("pingpong", 4, 128, N, 4, 2, False, 53),
            sharded_pop_case("storm", 4, 8, N, 16, 1, True, 54),
            sharded_pop_case("flood", 4, 8, N, 1, 1, True, 55),
            sharded_pop_case("width-8", 4, 16, 4096, 4, 8, False, 56),
            sharded_pop_case("n_loc-odd", 4, 16, 4 * 1023, 3, 2, False, 57),
            sharded_pop_case("n_loc-odd-bool", 4, 16, 4 * 1023, 4, 1, True, 58),
            sharded_pop_case("n_loc-6-bool", 4, 16, 24, 2, 1, True, 59),
            sharded_pop_case("parts-1+3", 4, 8, N, 4, 1, False, 60, parts=(1,)),
            # each branch of the segment-copy design: bool occupancy in
            # 4-byte words (n_loc % 8 != 0) and in 16-byte vectors,
            # segments of many chunks with a ragged last one, S_d·SLOTS =
            # 65,600 segments, SLOTS past the grid's 65,535 folded into x
            # (vector and scalar), W=8 vectors
            sharded_pop_case("bool-words", 4, 16, 4 * 1004, 4, 2, True, 61),
            sharded_pop_case("bool-16", 4, 16, 4 * 1024, 4, 2, True, 62),
            sharded_pop_case("long-segment", 2, 8, 2 * 10_000, 4, 3, False, 63),
            sharded_pop_case("many-segments", 4, 2, 16, 16_400, 1, False, 64),
            sharded_pop_case("y-fold", 2, 2, 8, 65_540, 1, False, 65),
            sharded_pop_case("y-fold-scalar", 2, 2, 6, 65_540, 2, True, 66),
            sharded_pop_case("width-8-bool-16", 4, 16, 4 * 1024, 4, 8, True, 67),
            # pack8@sustained on a 4-shard mesh: 32 sub-shards of 8,192 lanes
            # (eight members × four peer shards), one part
            sharded_commit_case("packed-mesh", 32, 8, 32 * 8192, 4, 1, 2 * 32 * 8192,
                                False, True, True, 68),
            sharded_pop_case("packed-mesh", 32, 8, 32 * 8192, 4, 1, False, 69),
            # the pack placed over the parts of a mesh: each part's own
            # sub-shards in one tensor, 8 of them ("4" cut into four, "2x4"
            # cut into four) or 16 ("2x4": a row's four members)
            sharded_commit_case("placed-8-sub-shards", 32, 8, 32 * 8192, 4, 1,
                                2 * 32 * 8192, False, True, True, 72, parts=(8, 16, 24)),
            sharded_pop_case("placed-8-sub-shards", 32, 8, 32 * 8192, 4, 1, False, 73,
                             parts=(8, 16, 24)),
            sharded_commit_case("placed-16-sub-shards", 32, 8, 32 * 8192, 4, 1,
                                2 * 32 * 8192, False, True, True, 74, parts=(16,)),
            sharded_pop_case("placed-16-sub-shards", 32, 8, 32 * 8192, 4, 1, False, 75,
                             parts=(16,)),
            # pack8@sustained unmeshed: 262,144 lanes, a 524k-message stream
            # with the etick plane, a 1M-cell row; one launch a tick each
            commit_case("packed", 8, 8 * 32768, 4, 1, 2 * 8 * 32768, False, True, True,
                        70),
            pop_case("packed", 8, 8 * 32768, 4, 1, False, 71),
        ]
        # the harness's own floor: an empty kernel timed the same way
        floor = {"phase": "kernels", "case": "launch-floor",
                 "kernel_ms": time_ms(lambda: torch.cuda._sleep(0), lambda: None),
                 "phase_s": time.perf_counter() - t0, "card": card}
        kernel_rows = cases

    # launches on the main paths: each phase counts its own run from zero
    launches = dict.fromkeys(KERNELS + SHARDED_KERNELS, 0)
    for ph, fn in (("sustained", phase_sustained), ("pingpong", phase_pingpong),
                   ("flood", phase_flood), ("storm", phase_storm),
                   ("benchmarks", phase_benchmarks), ("scale", phase_scale),
                   ("faults", phase_faults), ("telemetry", phase_telemetry),
                   ("plans", phase_plans), ("executor", phase_executor),
                   ("mesh", phase_mesh), ("cli", phase_cli), ("daemon", phase_daemon),
                   ("admit", phase_admit), ("observe", phase_observe),
                   ("surface", phase_surface), ("resume", phase_resume),
                   ("buckets", phase_buckets), ("packs", phase_packs),
                   ("cohort", phase_cohort), ("sync", phase_sync),
                   ("exec", phase_exec)):
        if ph in phases:
            t0 = time.perf_counter()
            row = fn(card)
            row["phase_s"] = time.perf_counter() - t0
            for k, v in row["launches"].items():
                launches[k] += v
            emit(row)
    if "parity" in phases:
        t0 = time.perf_counter()
        row = phase_parity(card)
        row["phase_s"] = time.perf_counter() - t0
        emit(row)
    if kernel_rows:
        # the kernels' own device times, last: see device_pass
        t0 = time.perf_counter()
        floor["device_ms"] = device_pass(kernel_rows)
        floor["device_pass_s"] = time.perf_counter() - t0
        for c in kernel_rows:
            emit({"phase": "kernels", **c, "card": card})
        emit(floor)

    def kernel_entry(kname, replaces):
        # the flagship row of each kernel (its sharded form at S=4)
        flag = [c for c in kernel_rows if c["kernel"] == kname and c["case"] == "flagship"]
        c = flag[0] if flag else {}
        return {
            "name": kname, "route": "cuda",
            "source": "testground_tpu_torch/csrc/transport.cu",
            "replaces": replaces, "launches": launches[kname],
            "max_abs_err": max((r["max_abs_err"] for r in kernel_rows
                                if r["kernel"] == kname), default=None),
            "ms": c.get("kernel_ms"), "device_ms": c.get("kernel_device_ms"),
            "plain_ms": c.get("plain_ms"), "bound_ms": c.get("bound_ms"),
            "bound_share": c.get("bound_share"), "bound_by": "bytes",
            "library_ms": c.get("library_ms"),
        }

    print(smi, flush=True)
    emit({"kernels": [
        kernel_entry("commit_calendar", "testground_tpu/sim/pallas_transport.py:340"),
        kernel_entry("pop_bucket", "testground_tpu/sim/pallas_transport.py:713"),
        kernel_entry("commit_calendar_sharded",
                     "testground_tpu/sim/pallas_transport.py:513"),
        kernel_entry("pop_bucket_sharded", "testground_tpu/sim/pallas_transport.py:754"),
    ]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
