"""Tick phase attribution plane: the per-phase device cost ledger — the
card's design of the reference's ``testground_tpu/sim/phases.py``.

The reference lowers each tick phase standalone and harvests XLA's
``cost_analysis()``. The port has no XLA, so it builds the same
``sim.phases`` block from ticks it runs itself, after the run, on a
FRESH carry from ``init_carry(seed)`` (the reference also times concrete
inputs from init):

- **static rows** — one tick (tick 1, after an uncounted tick 0 that
  warms what a plan's first step caches) through ``SimProgram._tick``
  with a counter as its ``timer``. The tick calls ``timer.mark(name)``
  at the end of each stretch (``sim/engine.py``); a
  ``TorchDispatchMode`` sums over
  every aten op the bytes of its tensor inputs plus its outputs (an
  in-place op counts its destination twice, a scatter its whole
  destination, as XLA's ``bytes accessed`` does; views and ``empty``
  allocations move nothing and count nothing) and the flops that
  ``torch.utils.flop_counter`` knows for it, and each stretch's sums go
  to the phase its mark names. K1 and K2 launch through ``ctypes``,
  which the dispatch mode never sees: their bytes come from the same
  closed forms that ``chip_smoke.py`` holds the kernels' times against
  (``cuda_transport.commit_bytes`` / ``pop_bytes``, reported by
  ``cuda_transport.observe_launches``), into the phase that launched
  them. The block's ``kernel_bytes`` says how many bytes of which
  phase came from which kernel. ``whole_per_tick`` is the same count
  over the whole tick and ``residual`` = whole − Σ phases, exactly
  (integers): the stretches with no phase of the reference's own — the
  traffic matrix's cells, the flight recorder's rows, the flow
  accounting that builds the new carry — land there. ``transcendentals``
  is left out, and so is a zero flop count, as the reference leaves out
  an absent field.
- **measured calibration** (``measure=K``) — K further ticks with a
  timer that records a CUDA event at each mark (``perf_counter`` on the
  CPU), each tick waited for as the run's loop waits for its done flag:
  ``measured_ms`` is a phase's mean over the K ticks. The marks are
  ``chip_smoke.py``'s ``PhaseTimer``.

Rows follow the reference's :data:`TICK_PHASES` order and names even
though the port's tick commits before it syncs; the row set is the
reference's for the same program: ``lat_hist`` and ``telemetry`` only
with telemetry, ``faults`` only with an armed schedule. Two builds on
one composition and seed give identical static rows (``tg diff``
compares them exactly).

Like every observability plane the ledger shapes no part of the run: it
runs after it, on its own carry and blocks, and a tick without a timer
runs none of the marks. :func:`phase_rows` and :func:`write_phase_rows`
are the reference's, copied.
"""

from __future__ import annotations

import json
import time
from typing import Any

from ..analysis.diff import num
from .telemetry import PHASES_FILE

__all__ = [
    "PHASES_FILE",
    "TICK_PHASES",
    "build_phase_ledger",
    "measure_phases",
    "phase_rows",
    "write_phase_rows",
]

# Canonical phase order — the reference tick's dataflow order. A program
# variant holds a subset: lat_hist/telemetry only under telemetry=true,
# faults only with an armed schedule.
TICK_PHASES = (
    "faults",
    "deliver",
    "lat_hist",
    "step",
    "sync",
    "net_commit",
    "telemetry",
)

# the tick's mark names that close a stretch of a reference phase; every
# other mark ("tick", "netmatrix", "carry", "trace") closes residual
_MARK_PHASE = {
    "faults": "faults",
    "deliver": "deliver",
    "lat_hist": "lat_hist",
    "step": "step",
    "commit": "net_commit",
    "sync": "sync",
    "telemetry": "telemetry",
}

def _phases_of(prog) -> tuple:
    """The phases the program holds, in :data:`TICK_PHASES` order."""
    skip = set()
    if prog._faults is None:
        skip.add("faults")
    if not prog.telemetry:
        skip |= {"lat_hist", "telemetry"}
    return tuple(p for p in TICK_PHASES if p not in skip)


def _op_counter():
    """A ``TorchDispatchMode`` that sums the bytes and flops of every aten
    op dispatched under it (see the module docstring); ``paused`` stops
    the count."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves
    from torch.utils.flop_counter import flop_registry

    aten = torch.ops.aten
    no_traffic = {aten.empty.memory_format, aten.empty_strided.default,
                  aten.empty_like.default}

    def nbytes(tree) -> int:
        return sum(x.numel() * x.element_size() for x in tree_leaves(tree)
                   if isinstance(x, torch.Tensor))

    class OpCounter(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.bytes = 0
            self.flops = 0
            self.paused = False

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            if self.paused or func in no_traffic or func.is_view:
                return out
            self.bytes += nbytes((args, kwargs)) + nbytes(out)
            formula = flop_registry.get(func._overloadpacket)
            if formula is not None:
                self.flops += int(formula(*args, **kwargs, out_val=out))
            return out

    return OpCounter()


class _StaticCounter:
    """The static tick's timer: at each mark, the bytes and flops counted
    since the previous mark go to the mark's stretch; as its launch
    observer it adds a kernel's closed-form bytes to the count."""

    def __init__(self, mode):
        self.mode = mode
        self.by_mark: dict[str, list[int]] = {}
        self.kernels: dict[str, dict[str, int]] = {}
        self._pending: dict[str, int] = {}
        self._last = (0, 0)

    def mark(self, name: str) -> None:
        b, f = self.mode.bytes, self.mode.flops
        acc = self.by_mark.setdefault(name, [0, 0])
        acc[0] += b - self._last[0]
        acc[1] += f - self._last[1]
        self._last = (b, f)
        if self._pending:
            into = self.kernels.setdefault(_MARK_PHASE.get(name, "residual"), {})
            for k, v in self._pending.items():
                into[k] = into.get(k, 0) + v
            self._pending = {}

    def on_launch(self, name: str, measure) -> None:
        self.mode.paused = True
        try:
            nb = int(measure())
        finally:
            self.mode.paused = False
        self.mode.bytes += nb
        self._pending[name] = self._pending.get(name, 0) + nb


class _MarkTimer:
    """A CUDA event (or ``perf_counter`` on the CPU) at every mark; the
    interval up to a mark is its stretch's."""

    def __init__(self, cuda: bool):
        self.cuda = cuda
        self.marks: list = []

    def mark(self, name: str) -> None:
        if self.cuda:
            import torch

            e = torch.cuda.Event(enable_timing=True)
            e.record()
        else:
            e = time.perf_counter()
        self.marks.append((name, e))

    def ms_by_mark(self) -> dict[str, float]:
        sums: dict[str, float] = {}
        prev = None
        for name, e in self.marks:
            if prev is not None:
                ms = prev.elapsed_time(e) if self.cuda else (e - prev) * 1e3
                sums[name] = sums.get(name, 0.0) + ms
            prev = e
        return sums


def _tick_state(prog, seed: int, carry=None):
    """A fresh carry (or ``carry``) and what the run's loop hands each tick:
    the blocks when a plane writes rows, the done flag and its event, and
    the host's tick under a fault schedule."""
    import torch

    from .engine import _Blocks

    cuda = prog.device.type == "cuda"
    if carry is None:
        carry = prog.init_carry(seed)
    blocks = (_Blocks(prog, cuda)
              if prog.telemetry or prog.trace is not None else None)
    done_out = (torch.zeros((), dtype=torch.bool, pin_memory=cuda),
                torch.cuda.Event() if cuda else None)
    tick = int(carry.t) if prog._faults is not None else None
    return carry, blocks, done_out, tick


def _run_ticks(prog, carry, blocks, done_out, tick, reps: int, timer):
    """``reps`` ticks of ``prog`` from ``carry`` with ``timer``, each
    waited for as the run's loop waits for its done flag."""
    for i in range(reps):
        if blocks is not None and i % prog.chunk == 0:
            blocks.reset()
        carry = prog._tick(carry, timer=timer, done_out=done_out, tick=tick,
                           blocks=blocks, row=i % prog.chunk)
        if done_out[1] is not None:
            done_out[1].synchronize()
        if tick is not None:
            tick += 1
    return carry, tick


def measure_phases(prog, reps: int, seed: int = 0, state=None) -> dict[str, float]:
    """Mean ms per tick of each phase over ``reps`` ticks of ``prog``
    (:data:`TICK_PHASES` names, plus ``residual`` for the stretches of no
    phase), from a fresh carry unless ``state`` (a :func:`_tick_state`)
    is given. One untimed tick goes first. A several-part program is
    measured stepped in one thread (``SimProgram.single``)."""
    from .engine import device_context

    prog = prog.single()
    reps = max(int(reps), 1)
    with device_context(prog.device):
        carry, blocks, done_out, tick = state or _tick_state(prog, seed)
        if state is None:
            carry, tick = _run_ticks(prog, carry, blocks, done_out, tick, 1, None)
        timer = _MarkTimer(prog.device.type == "cuda")
        _run_ticks(prog, carry, blocks, done_out, tick, reps, timer)
        if timer.cuda:
            import torch

            torch.cuda.synchronize(prog.device)
        out: dict[str, float] = {}
        for name, ms in timer.ms_by_mark().items():
            phase = _MARK_PHASE.get(name, "residual")
            out[phase] = out.get(phase, 0.0) + ms / reps
    return out


def build_phase_ledger(prog, measure: int = 0, seed: int = 0,
                       transport: str = "") -> dict:
    """Build the ``sim.phases`` journal block for one program (an
    ``engine.SimProgram``) on a fresh carry. ``measure > 0`` adds the
    measured ms/tick calibration over that many ticks. ``transport`` is
    the run's resolved transport (``cuda`` or ``plain``; by default from
    the program's device).

    Block shape (the reference's, plus ``kernel_bytes``)::

        {transport, chunk, instances,
         phases: [{phase, flops?, bytes_accessed, flops_frac?, bytes_frac?,
                   measured_ms?, measured_reps?}],
         whole_per_tick: {flops?, bytes_accessed},
         residual: {flops?, bytes_accessed},
         coverage: {flops_frac?, bytes_frac?},
         kernel_bytes: {phase: {kernel: bytes}}}   # launches on the card

    For every field of ``whole_per_tick``, Σ phases + residual ==
    whole_per_tick exactly. A several-part program's ledger is its tick
    stepped in one thread (``SimProgram.single``: the calendar split over
    the parts, every other leaf on the primary device), as a mesh of one
    part steps it."""
    from .cuda_transport import observe_launches
    from .engine import device_context

    prog = prog.single()
    with device_context(prog.device):
        carry, blocks, done_out, tick = _tick_state(prog, seed)
        # tick 0 untimed and uncounted: a plan's first step may build and
        # cache constants, which no later tick of the run pays for
        carry, tick = _run_ticks(prog, carry, blocks, done_out, tick, 1, None)
        mode = _op_counter()
        counter = _StaticCounter(mode)
        with mode, observe_launches(counter.on_launch):
            carry = prog._tick(carry, timer=counter, done_out=done_out,
                               tick=tick, blocks=blocks, row=0)
        if done_out[1] is not None:
            done_out[1].synchronize()
        if tick is not None:
            tick += 1
        measured = (measure_phases(prog, measure,
                                   state=(carry, blocks, done_out, tick))
                    if measure > 0 else {})
    # each phase's [bytes, flops], summed over the stretches its marks close
    cost = {p: [0, 0] for p in _phases_of(prog)}
    for name, (b, f) in counter.by_mark.items():
        if _MARK_PHASE.get(name) in cost:
            cost[_MARK_PHASE[name]][0] += b
            cost[_MARK_PHASE[name]][1] += f
    rows: list[dict[str, Any]] = [
        {"phase": p, **({"flops": f} if f else {}), "bytes_accessed": b}
        for p, (b, f) in cost.items()
    ]
    sums = {"bytes_accessed": sum(b for b, _ in cost.values()),
            "flops": sum(f for _, f in cost.values())}
    whole_tick = {**({"flops": mode.flops} if mode.flops else {}),
                  "bytes_accessed": mode.bytes}
    residual = {k: whole_tick[k] - sums[k] for k in whole_tick}
    for r in rows:
        for key, frac in (("flops", "flops_frac"), ("bytes_accessed", "bytes_frac")):
            if whole_tick.get(key) and r.get(key) is not None:
                r[frac] = round(float(r[key]) / whole_tick[key], 4)
        if r["phase"] in measured:
            r["measured_ms"] = round(measured[r["phase"]], 6)
            r["measured_reps"] = int(measure)
    coverage = {}
    for key, frac in (("flops", "flops_frac"), ("bytes_accessed", "bytes_frac")):
        if whole_tick.get(key):
            coverage[frac] = round(sums[key] / whole_tick[key], 4)
    block = {
        "transport": transport or ("cuda" if prog.device.type == "cuda" else "plain"),
        "chunk": int(prog.chunk),
        "instances": int(prog.n),
        "phases": rows,
        "whole_per_tick": whole_tick,
        "residual": residual,
        "coverage": coverage,
    }
    if counter.kernels:
        block["kernel_bytes"] = counter.kernels
    return block


def phase_rows(block: dict) -> list[dict]:
    """Flatten a ``sim.phases`` block into uniform per-row dicts — one
    per phase, plus the synthesized ``residual`` and ``total`` rows —
    the ONE row shape behind the jsonl artifact, the ``tg_phase_*``
    Prometheus gauges, and the console table. Shape-tolerant: a foreign
    or truncated block yields what it holds, never raises."""
    if not isinstance(block, dict):
        return []
    rows: list[dict] = []
    transport = block.get("transport", "xla")
    for r in block.get("phases") or []:
        if isinstance(r, dict) and r.get("phase"):
            rows.append({"transport": transport, **r})
    for name, key in (("residual", "residual"), ("total", "whole_per_tick")):
        src = block.get(key)
        if isinstance(src, dict) and src:
            rows.append(
                {
                    "transport": transport,
                    "phase": name,
                    **{
                        k: v
                        for k, v in src.items()
                        if num(v) is not None
                    },
                }
            )
    return rows


def write_phase_rows(path: str, ident: dict, block: dict) -> int:
    """Write the block's rows as ``sim_phases.jsonl`` (one row per phase
    + residual + total, each carrying the run identity). Best-effort
    like every observability writer: IO failure writes nothing and
    returns 0 — the journal block remains the durable copy."""
    rows = phase_rows(block)
    if not rows:
        return 0
    try:
        with open(path, "w") as f:
            for row in rows:
                f.write(json.dumps({**ident, **row}) + "\n")
    except (OSError, ValueError):
        return 0
    return len(rows)
