"""Run performance ledger: per-chunk throughput gauges and device memory —
the port's copy of ``PerfLedger`` (``testground_tpu/sim/perf.py:179-362``)
and its memory probe.

The run loop (``SimProgram.run``) calls ``on_chunk(index, ticks,
ticks_delta, wall_secs)`` once per chunk, with the host-clock wall of
that chunk: from its first launch to the point where the loop has already
waited on the chunk's last done event. Each call becomes one
``sim_perf.jsonl`` row (ticks/s, peer·ticks/s, device bytes in use on a
card), and :meth:`PerfLedger.summary` renders the journal's ``sim.perf``
block with the reference's keys.

No compile pass: the port has no ahead-of-time program and no
lower/compile split, so nothing calls ``on_compile``, there is no
``compile`` block, and no ``flops_per_sec`` / ``bytes_per_sec`` /
``est_*`` keys — the reference's own shape with ``aot=False``
(``executor.py:1490-1494``).

Everything here is host-side bookkeeping on state the run loop already
has: the ledger adds no launch and no device→host read (the memory probe
reads the caching allocator's host-side counters), and, like every
observability writer, it never fails the run it observes.
"""

from __future__ import annotations

import json
from typing import Any

# the comparison codepath lives in the cross-run analysis plane
# (analysis/diff.py, stdlib-only, shared with `tg diff`); re-exported here
# as the reference's sim/perf.py re-exports it, so there is ONE
# implementation
from ..analysis.diff import fmt_rate, num, perf_compare  # noqa: F401 — re-exports
from .telemetry import PERF_FILE

__all__ = ["PERF_FILE", "PerfLedger", "device_memory_stats", "fmt_rate", "num",
           "perf_compare"]


def device_memory_stats(device=None) -> dict:
    """The device-memory probe, with the reference's keys:
    ``bytes_in_use`` and ``peak_bytes_in_use`` (the caching allocator's
    ``allocated_bytes.all.current`` and ``.peak``) and ``bytes_limit``
    (the card's total memory). ``device`` None is the current card.
    Returns ``{}`` on the CPU or without a card, and never raises."""
    try:
        import torch

        if device is None:
            if not torch.cuda.is_available():
                return {}
            device = torch.device("cuda", torch.cuda.current_device())
        device = torch.device(device)
        if device.type != "cuda":
            return {}
        stats = torch.cuda.memory_stats(device)
        out = {}
        for key, name in (("allocated_bytes.all.current", "bytes_in_use"),
                          ("allocated_bytes.all.peak", "peak_bytes_in_use")):
            if key in stats:
                out[name] = int(stats[key])
        out["bytes_limit"] = int(torch.cuda.get_device_properties(device).total_memory)
        return out
    except Exception:  # noqa: BLE001 — observability never raises
        return {}


class PerfLedger:
    """Per-run performance ledger (see module docstring).

    Streams one jsonl row per chunk to ``path`` (``None`` only counts),
    aggregates host-side, and renders the ``journal["sim"]["perf"]``
    block via :meth:`summary`. ``device`` is the run's device, whose
    memory the rows sample (none on the CPU)."""

    def __init__(
        self,
        instances: int,
        chunk: int,
        ident: dict | None = None,
        path: str | None = None,
        warmup: int = 1,
        transport: str = "plain",
        device=None,
        bucket: int | None = None,
    ):
        # the exact live count, never the padded bucket size: peer·ticks/s
        # divide real work, so a padded run never reports inflated
        # throughput (the bucket size rides beside it as an annotation)
        self.instances = int(instances)
        self.bucket = int(bucket) if bucket else None
        self.chunk = int(chunk)
        # the transport that ran: every row and the summary name it, so
        # ledgers of different backends are never cross-attributed
        self.transport = str(transport)
        # chunks excluded from the steady_* window: the first carries the
        # set-up (the kernels' first launch, the allocator's first blocks)
        self.warmup = max(0, int(warmup))
        self.ident = dict(ident or {})
        self.path = path
        self.device = device
        self.rows_written = 0
        self._chunk_walls: list[float] = []
        self._ticks = 0
        self._hbm_peak = 0
        self._hbm_limit = 0
        self._f = None
        if path is not None:
            try:
                self._f = open(path, "w")
            except OSError:  # observe best-effort, never fail the run
                self.path = None

    def on_chunk(self, index: int, ticks: int, ticks_delta: int, wall_secs: float) -> None:
        wall = max(float(wall_secs), 1e-9)
        self._chunk_walls.append(wall)
        self._ticks = int(ticks)
        row: dict[str, Any] = {
            "tick": int(ticks),
            "chunk": int(index),
            "transport": self.transport,
            "wall_secs": round(wall, 6),
            "ticks_per_sec": round(ticks_delta / wall, 3),
            "peer_ticks_per_sec": round(self.instances * ticks_delta / wall, 3),
        }
        if self.bucket:
            row["bucket"] = self.bucket
        mem = device_memory_stats(self.device) if self.device is not None else {}
        if "bytes_in_use" in mem:
            row["bytes_in_use"] = mem["bytes_in_use"]
        self._hbm_peak = max(self._hbm_peak, mem.get("peak_bytes_in_use", 0),
                             mem.get("bytes_in_use", 0))
        self._hbm_limit = mem.get("bytes_limit", self._hbm_limit)
        self.rows_written += 1
        if self._f is not None:
            try:
                self._f.write(json.dumps({**self.ident, **row}) + "\n")
                self._f.flush()
            except (OSError, ValueError):
                try:
                    self._f.close()
                except OSError:
                    pass
                self._f = None
                self.path = None

    def close(self) -> None:
        if self._f is not None:
            try:
                self._f.close()
            except OSError:
                self.path = None
            finally:
                self._f = None

    def summary(self) -> dict:
        """The ``sim.perf`` journal block. ``execute.wall_secs`` is the sum
        of the per-chunk walls (what the jsonl rows sum to); ``steady_*``
        excludes the ``warmup`` leading chunks."""
        out: dict[str, Any] = {
            "instances": self.instances,
            "chunk": self.chunk,
            "transport": self.transport,
        }
        if self.bucket:
            out["bucket"] = self.bucket
        if self._chunk_walls:
            wall = sum(self._chunk_walls)
            ex: dict[str, Any] = {
                "chunks": len(self._chunk_walls),
                "ticks": self._ticks,
                "wall_secs": round(wall, 6),
                "ticks_per_sec": round(self._ticks / wall, 3),
                "peer_ticks_per_sec": round(self.instances * self._ticks / wall, 3),
            }
            steady = self._chunk_walls[self.warmup:]
            if steady:
                s_wall = sum(steady)
                s_ticks = len(steady) * self.chunk
                ex["steady_chunks"] = len(steady)
                ex["steady_wall_secs"] = round(s_wall, 6)
                ex["steady_ticks_per_sec"] = round(s_ticks / s_wall, 3)
                ex["steady_peer_ticks_per_sec"] = round(
                    self.instances * s_ticks / s_wall, 3)
            out["execute"] = ex
        if self._hbm_peak:
            hbm = {"peak_bytes": self._hbm_peak}
            if self._hbm_limit:
                hbm["bytes_limit"] = self._hbm_limit
            out["hbm"] = hbm
        series: dict[str, Any] = {"rows": self.rows_written}
        if self.path is not None:
            series["file"] = PERF_FILE
        out["series"] = series
        return out
