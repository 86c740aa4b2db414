"""Live observability stream: tail a task's per-run jsonl families — the
port's copy of the reference's ``testground_tpu/engine/stream.py``.

Every observability writer in the sim executor streams append-only jsonl
— per-tick telemetry (``sim_timeseries.jsonl``), per-chunk perf rows
(``sim_perf.jsonl``), SLO breach records (``sim_slo.jsonl``), host-side
run spans (``run_spans.jsonl``) — flushed once per chunk. This module is
the read side: a generator that tails those files as they grow and
yields each complete line as a dict tagged with its family, across the
whole queued → running → done lifecycle:

- **queued**: the run dir does not exist yet — with ``follow`` the
  generator polls until it appears (or the task finishes first);
- **running**: new rows stream out within a poll interval of the
  writer's flush, partial trailing lines are never consumed (the writer
  may be mid-``write``);
- **done**: one final sweep after the task reports finished, then the
  stream closes. Following an already-finished task replays the full
  history and closes — the ``engine.logs`` follow contract.

The daemon's ``GET /stream`` route, ``Client.stream`` and ``tg watch``
all sit on this one generator, so the surfaces cannot drift. Import-
light (stdlib + the telemetry/slo file-name constants): no torch.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Iterator

from ..sim.slo import SLO_FILE
from ..sim.telemetry import (
    NETMATRIX_FILE,
    PERF_FILE,
    PHASES_FILE,
    SIM_SERIES_FILE,
    SPAN_FILE,
)
from .events import JournalTail

__all__ = ["STREAM_FAMILIES", "stream_task_rows"]

# family name → per-run file it tails. Ordered: within one sweep,
# telemetry rows precede the perf/slo rows of the same chunk so a
# consumer folding "counters, then the chunk line" sees them in causal
# order (the executor writes them in this order too).
STREAM_FAMILIES = (
    ("telemetry", SIM_SERIES_FILE),
    # traffic-matrix chunk deltas (sim/netmatrix.py) — one sparse row
    # per chunk, the `tg netmap -f` live feed
    ("netmatrix", NETMATRIX_FILE),
    ("perf", PERF_FILE),
    # phase attribution rows (sim/phases.py) — written once at collect
    # time, so a follow replays them right before the task closes
    ("phases", PHASES_FILE),
    ("slo", SLO_FILE),
    ("spans", SPAN_FILE),
)

_POLL_SECS = 0.15

# bytes per read while draining a backlog: a multi-day soak's replay
# (GET /stream on a finished task) must not land its whole multi-GB
# jsonl in one allocation — rows stream out chunk by chunk instead
_READ_CHUNK = 4 << 20


def stream_task_rows(
    outputs_root: str,
    plan: str,
    task_id: str,
    is_done: Callable[[], bool],
    follow: bool = True,
    cancel=None,
    families=None,
    poll_secs: float = _POLL_SECS,
    heartbeat_secs: float = 0.0,
) -> Iterator[dict]:
    """Yield a task's observability rows, each as
    ``{"stream": <family>, "run": <run id>, ...row}``.

    A task's runs live under ``<outputs>/<plan>/<task_id>`` (single run)
    or ``<task_id>-<run_id>`` (multi-``[[runs]]``); every matching run
    dir contributes, tagged with its run id (rows that already carry a
    ``run`` key keep it — it is the same id). ``is_done()`` is the
    task-finished probe (COMPLETE/CANCELED); without ``follow`` the
    generator performs one sweep of everything written so far and
    closes. ``families`` narrows to a subset of
    :data:`STREAM_FAMILIES` names (e.g. ``("perf",)`` for ``tg perf
    -f``). ``heartbeat_secs`` > 0 yields ``None`` whenever that long
    passes with no rows — the daemon turns it into a blank ndjson line
    so an idle follow (queued task, long compile, quiet soak) cannot
    trip a client's socket read timeout."""
    fams = [
        (name, fname)
        for name, fname in STREAM_FAMILIES
        if families is None or name in families
    ]
    root = os.path.join(outputs_root, plan)
    tails: dict[tuple[str, str], JournalTail] = {}

    def sweep() -> Iterator[dict]:
        run_ids = []
        try:
            run_ids = sorted(
                rid
                for rid in os.listdir(root)
                if rid == task_id or rid.startswith(task_id + "-")
            )
        except OSError:
            return
        for rid in run_ids:
            for fam, fname in fams:
                path = os.path.join(root, rid, fname)
                key = (rid, fam)
                tail = tails.get(key)
                if tail is None:
                    if not os.path.isfile(path):
                        continue
                    tail = tails[key] = JournalTail(path, read_chunk=_READ_CHUNK)
                for row in tail.read_new():
                    yield {"stream": fam, "run": rid, **row}

    last_row = time.monotonic()
    while True:
        done = is_done()  # probe BEFORE the sweep: rows written before
        # the probe are guaranteed to be in this (or a prior) sweep, so
        # a done task never closes with unread rows
        for row in sweep():
            last_row = time.monotonic()
            yield row
        if not follow or done:
            return
        if cancel is not None and cancel.is_set():
            return
        if heartbeat_secs and time.monotonic() - last_row >= heartbeat_secs:
            last_row = time.monotonic()
            yield None
        time.sleep(poll_secs)
