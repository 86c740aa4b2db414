"""Sim telemetry plane: host-side half of the per-tick counter block.

The port's copy of ``testground_tpu/sim/telemetry.py``: the column schema,
the latency-histogram bins, the per-run file names, the row decoding and
the run-span tracer, line for line, so that both packages agree on every
block they hand to a host consumer.

The device-side half lives in the tick (``sim/engine.py``): every tick
writes one fixed-shape int32 counter row into the chunk's ``[chunk, K]``
block on the device, and the host reads the block once per chunk. The read
rides the wait the run loop already makes for the done flag (the chunk's
last tick records the flag's event behind the block's copy to the host),
so the block adds no host wait.

This module owns everything about the block the host needs to agree on
with the device: the column schema, the row decoding, and the run-span
tracer that wraps the host-side phases (run → build → compile → chunk[i]
→ collect) in ``sdk/events.py``-style JSON lines.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Iterable

__all__ = [
    "LATENCY_BINS",
    "LATENCY_FILE",
    "NETMATRIX_FILE",
    "PERF_FILE",
    "PHASES_FILE",
    "SIM_SERIES_FILE",
    "SPAN_FILE",
    "TELEMETRY_FIXED_COLUMNS",
    "SpanTracer",
    "iter_jsonl",
    "latency_bin_edges",
    "latency_percentiles",
    "rows_from_blocks",
    "telemetry_totals",
]

# Per-run output file names (under <outputs>/<plan>/<run_id>/).
SIM_SERIES_FILE = "sim_timeseries.jsonl"
SPAN_FILE = "run_spans.jsonl"
# Per-group delivery-latency summary rows (viewer-shaped: run/plan/case/
# tick/group_id/name + count/mean/min/max) — the ``sim.latency.*``
# measurement family the dashboard and the Influx mirror consume.
LATENCY_FILE = "sim_latency.jsonl"
# Per-chunk performance-ledger rows (sim/perf.py: dispatch wall, ticks/s,
# peer·ticks/s, achieved FLOP/s and bytes/s, device bytes-in-use) — the
# ``sim.perf.*`` measurement family.
PERF_FILE = "sim_perf.jsonl"
# Per-phase tick attribution rows (sim/phases.py: per-phase XLA cost
# analysis + optional measured ms/tick, one row per phase plus the
# residual and whole-program rows) — the ``tg perf --phases`` backend.
PHASES_FILE = "sim_phases.jsonl"
# Per-chunk traffic-matrix deltas (sim/netmatrix.py: sparse nonzero
# src-group × dst-group cells per chunk) — the ``sim.netmatrix.*``
# measurement family and the ``tg netmap`` backend.
NETMATRIX_FILE = "sim_netmatrix.jsonl"

# Delivery-latency histogram schema, shared by the device accumulator
# (``sim/net.py::latency_histogram``) and every host-side consumer. Bins
# are log2-spaced in TICKS: bin b counts deliveries whose (delivery tick
# - enqueue tick) lies in [2^b, 2^(b+1)); the LAST bin is open-ended
# (delays past 2^(LATENCY_BINS-1) ticks clamp into it). Fixed and
# log-spaced so the device-side cost is a handful of compares per
# delivered message and the host can estimate stable p50/p95/p99 without
# per-message state — the shape every serving/training stack converges
# on for cheap always-on latency observability.
LATENCY_BINS = 12


def latency_bin_edges() -> tuple[int, ...]:
    """Lower edge (inclusive, in ticks) of each histogram bin."""
    return tuple(1 << b for b in range(LATENCY_BINS))


def latency_percentiles(
    hist, tick_ms: float, quantiles=(0.50, 0.95, 0.99)
) -> dict:
    """Estimate latency quantiles in milliseconds from one group's bin
    counts (``[LATENCY_BINS]`` ints). Linear interpolation inside the
    hit bin (the standard histogram-quantile estimator); the open last
    bin is valued at its lower edge, so a tail that escaped the bin
    range under-reports rather than inventing precision. Returns
    ``{count, p50_ms, p95_ms, p99_ms}`` (``count`` only when empty)."""
    counts = [int(c) for c in hist]
    total = sum(counts)
    out: dict = {"count": total}
    if total == 0:
        return out
    edges = latency_bin_edges()
    cum = 0
    targets = [(q, q * total) for q in quantiles]
    ti = 0
    for b, c in enumerate(counts):
        prev = cum
        cum += c
        while ti < len(targets) and cum >= targets[ti][1]:
            q, rank = targets[ti]
            lo = float(edges[b])
            hi = float(edges[b] * 2) if b < LATENCY_BINS - 1 else lo
            frac = (rank - prev) / c if c else 0.0
            ticks = lo + frac * (hi - lo)
            out[f"p{int(q * 100)}_ms"] = round(ticks * tick_ms, 6)
            ti += 1
        if ti >= len(targets):
            break
    return out

# Fixed leading columns of the device-side counter vector, in order.
# Columns after these are one live-instance count per group (schema key
# ``live`` in the decoded row, a {group_id: count} map). A padding row
# (ticks scanned after global completion) carries tick = -1 and is
# dropped by the decoder.
#
#   tick            the tick this row describes (scan-local, absolute)
#   delivered       messages popped from the calendar into inboxes
#   sent            outbox messages entering the transport (duplicate-
#                   shaping copies count: conservation must close)
#   enqueued        messages actually scattered into the calendar
#   dropped         sent - enqueued - rejected (loss, DROP filters,
#                   bandwidth, inbox-slot overflow, bad dst)
#   rejected        messages suppressed by REJECT filters (fed back to
#                   senders next tick)
#   bytes_enqueued  enqueued × MSG_BYTES — the bandwidth-accounting wire
#                   bytes admitted onto links this tick
#   cal_depth       in-flight messages in the calendar AFTER this tick
#                   (cumulative enqueued - delivered; no O(L·N) rescan)
#   sync_signals    Σ of all sync state counters (barrier occupancy)
#   sync_pubs       Σ of stored topic-stream entries (publish occupancy)
#   faults_crashed  instances crashed by the fault plane this tick
#   faults_restarted  instances revived by a scheduled restart this tick
#   fault_dropped   messages killed by faults this tick: send-time kills
#                   (partition/flap windows, loss bursts, dead targets)
#                   plus in-flight messages purged by a crash — the term
#                   that closes flow conservation under chaos (sent =
#                   delivered + in-flight + dropped + rejected + this).
#                   All three are constant 0 without a fault schedule.
TELEMETRY_FIXED_COLUMNS = (
    "tick",
    "delivered",
    "sent",
    "enqueued",
    "dropped",
    "rejected",
    "bytes_enqueued",
    "cal_depth",
    "sync_signals",
    "sync_pubs",
    "faults_crashed",
    "faults_restarted",
    "fault_dropped",
)


def iter_jsonl(path: str) -> Iterable[dict]:
    """Tolerant jsonl reader shared by every observability consumer
    (viewer, trace reader, influx re-read): blank lines and unparseable
    lines — e.g. the partially-written tail of a still-streaming file —
    are skipped, IO errors end the stream. One implementation, so a
    future hardening cannot drift across surfaces."""
    try:
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    yield json.loads(line)
                except json.JSONDecodeError:
                    continue
    except OSError:
        return


def rows_from_blocks(blocks: Iterable, group_ids: tuple) -> list[dict]:
    """Decode flushed ``[chunk, K]`` counter blocks into jsonl-ready row
    dicts (fixed columns flat, per-group live counts nested under
    ``live``). Padding rows (tick < 0) are dropped."""
    nfix = len(TELEMETRY_FIXED_COLUMNS)
    rows: list[dict] = []
    for block in blocks:
        for vec in block:
            tick = int(vec[0])
            if tick < 0:  # post-completion padding inside the chunk
                continue
            row: dict[str, Any] = {
                name: int(vec[i])
                for i, name in enumerate(TELEMETRY_FIXED_COLUMNS)
            }
            row["live"] = {
                gid: int(vec[nfix + gi]) for gi, gid in enumerate(group_ids)
            }
            rows.append(row)
    return rows


def telemetry_totals(rows: list[dict]) -> dict[str, int]:
    """Sum the per-tick flow counters — what must equal the run's final
    ``results()`` cumulative totals (the acceptance invariant the smoke
    target and tests check)."""
    return {
        k: sum(int(r.get(k, 0)) for r in rows)
        for k in (
            "delivered",
            "sent",
            "enqueued",
            "dropped",
            "rejected",
            "fault_dropped",
        )
    }


def new_trace_id() -> str:
    """128-bit random trace id as 32 lowercase hex chars (the reference's
    ``tracectx.new_trace_id``)."""
    return os.urandom(16).hex()


def new_span_id() -> str:
    """64-bit random span id as 16 lowercase hex chars (the reference's
    ``tracectx.new_span_id``)."""
    return os.urandom(8).hex()


class SpanTracer:
    """Structured run-span events as ``sdk/events.py``-style JSON lines.

    Every line is ``{"ts": <ns>, "event": {"type": ..., "span": ...}}``
    so ``sdk.events.parse_event_line`` reads them back. Types:

    - ``span_start`` / ``span_end`` — a named phase; ``span_end`` carries
      ``wall_secs`` plus any attrs given at close (e.g. the build span
      ends with ``carry_bytes``)
    - ``point`` — an instant event (per-chunk progress, compile timing)

    A ``SpanTracer(None)`` is a no-op sink so call sites need no
    conditionals; failures are swallowed (observability must never fail
    the run it observes).

    Every row carries the lifecycle-trace vocabulary (W3C trace ids):
    ``trace_id`` (the task's trace when ``ctx`` is given, else a fresh
    one), a per-span ``span_id``, ``parent_id`` (the innermost open
    span, or the context's parent — the supervisor's execute span — at
    top level), and ``wall_ns``, so run spans and the archive-time
    lifecycle spans merge into one Perfetto timeline without post-hoc
    clock alignment.
    """

    def __init__(self, path: str | None, ctx: dict | None = None):
        ctx = ctx or {}
        self._path = path
        self._f = None
        self._trace_id = ctx.get("trace_id") or new_trace_id()
        self._root_parent = ctx.get("parent_id", "")
        # span name -> (monotonic t0, span_id, parent_id); plus a stack
        # of open span names so children parent to the innermost span
        self._open: dict[str, tuple[float, str, str]] = {}
        self._stack: list[str] = []
        if path is not None:
            try:
                self._f = open(path, "a", encoding="utf-8")
            except OSError:
                self._f = None

    @property
    def enabled(self) -> bool:
        return self._f is not None

    def _emit(self, event: dict) -> None:
        if self._f is None:
            return
        try:
            self._f.write(
                json.dumps({"ts": time.time_ns(), "event": event}) + "\n"
            )
            self._f.flush()
        except (OSError, ValueError):
            pass

    def _parent(self) -> str:
        if self._stack:
            rec = self._open.get(self._stack[-1])
            if rec is not None:
                return rec[1]
        return self._root_parent

    def start(self, span: str, **attrs) -> None:
        # durations come from the monotonic clock — a wall-clock step
        # (NTP slew, operator date change) mid-span must not produce a
        # negative or wildly wrong wall_secs; the emitted line keeps the
        # wall-clock ts for cross-host correlation
        parent = self._parent()
        sid = new_span_id()
        self._open[span] = (time.monotonic(), sid, parent)
        self._stack.append(span)
        self._emit(
            {
                "type": "span_start",
                "span": span,
                "trace_id": self._trace_id,
                "span_id": sid,
                "parent_id": parent,
                "wall_ns": time.time_ns(),
                **attrs,
            }
        )

    def end(self, span: str, **attrs) -> None:
        rec = self._open.pop(span, None)
        sid = parent = ""
        if rec is not None:
            t0, sid, parent = rec
            attrs.setdefault(
                "wall_secs", round(time.monotonic() - t0, 6)
            )
            for i in range(len(self._stack) - 1, -1, -1):
                if self._stack[i] == span:
                    del self._stack[i]
                    break
        self._emit(
            {
                "type": "span_end",
                "span": span,
                "trace_id": self._trace_id,
                "span_id": sid,
                "parent_id": parent,
                "wall_ns": time.time_ns(),
                **attrs,
            }
        )

    def point(self, name: str, **attrs) -> None:
        self._emit(
            {
                "type": "point",
                "span": name,
                "trace_id": self._trace_id,
                "span_id": new_span_id(),
                "parent_id": self._parent(),
                "wall_ns": time.time_ns(),
                **attrs,
            }
        )

    def close(self) -> None:
        if self._f is not None:
            try:
                self._f.close()
            finally:
                self._f = None
