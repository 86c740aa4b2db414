"""Sampled flight recorder: per-instance message-lifecycle event traces.

The port's copy of ``testground_tpu/sim/trace.py``, line for line. The
telemetry plane answers *how much* — counter rows and latency histograms.
This module answers *what happened to instance i*: a composition samples
instances via ``[global.run.trace]`` / ``[groups.run.trace]`` (range /
seeded-fraction selectors, the same machinery as the fault plane's target
selectors), and for those lanes the tick writes fixed-shape event rows —
status transitions, sync signals (barrier entry), per-message sends with
their transport fate, deliveries with provenance — into the chunk's
``[chunk, R, 5]`` block on the device. The block reaches the host with the
counter block, in the wait the run loop already makes, so tracing adds no
host wait; with no ``[run.trace]`` declared the plan lowers to ``None`` and
the engine runs the tick it runs without the plane.

Host-side, the flushed blocks decode into ``sim_trace.jsonl`` (one JSON
event per line) and export as Chrome trace-event JSON
(``trace_events.json``, one Perfetto/chrome://tracing track per traced
instance).

Event rows are ``[R, 5]`` int32 per tick with columns
``(tick, lane, kind, a, b)``; ``kind == -1`` marks an unused slot (the
decoder drops them). R is static: one status slot + one slot per sync
state + one per outbox slot + one per inbox slot, per traced lane — a
bounded ring per tick, so a fully quiet traced instance costs R rows of
-1 and nothing else.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# The trace plane reuses the fault plane's validated target selectors
# (group / "lo:hi" range / seeded fraction) — one selector grammar for
# "which instances does this declaration touch", whether it kills them
# or records them.
from .faults import _Selector, _resolve_mask

__all__ = [
    "EVENT_KINDS",
    "FATE_NAMES",
    "MAX_TRACE_LANES",
    "TRACE_EVENTS_FILE",
    "TRACE_FILE",
    "TracePlan",
    "build_trace_plan",
    "chrome_trace",
    "events_from_blocks",
    "parse_trace",
    "read_trace_events",
]

# Per-run output file names (under <outputs>/<plan>/<run_id>/).
TRACE_FILE = "sim_trace.jsonl"
TRACE_EVENTS_FILE = "trace_events.json"

# Event kind codes (column 2 of a device row; -1 = unused slot).
EV_STATUS, EV_SIGNAL, EV_SEND, EV_DELIVER = range(4)
EVENT_KINDS = ("status", "signal", "send", "deliver")

# Transport fate codes for a traced send (column ``b`` of an EV_SEND
# row) — where the message landed in the flow-conservation identity.
FATE_NAMES = ("enqueued", "rejected", "fault_dropped", "dropped")

# Status code names (sim/api.py RUNNING/SUCCESS/FAILURE/CRASH).
_STATUS_NAMES = ("running", "success", "failure", "crash")

# Refuse schedules that trace an unbounded slice of a big run: every
# traced lane emits (1 + S + O + IN) rows per tick through the scan
# output, so tracing is a SAMPLING tool — a full-fleet trace of a 100k
# run would dwarf the calendar itself. Loud static refusal, same policy
# as MAX_FILTER_CELLS.
MAX_TRACE_LANES = 4096

# Keys a [run.trace] table may carry — an unknown key is a typo'd
# selector, and a silently-ignored selector records the wrong instances.
_KNOWN_KEYS = {"group", "instances", "fraction", "seed", "events"}

# Default host-side cap on decoded events kept for the Chrome export
# (sim_trace.jsonl streams unbounded; the in-memory export buffer must
# not). Overridable per composition via the ``events`` key.
DEFAULT_EVENTS_CAP = 200_000


@dataclasses.dataclass(frozen=True)
class TracePlan:
    """The lowered trace declaration: which lanes to record, statically.

    ``mask`` is [N] bool over the plan instance axis; ``lanes`` its
    sorted nonzero indices (the static gather index the engine bakes
    into the traced tick). ``events_cap`` bounds the host-side Chrome
    export buffer."""

    n: int
    mask: np.ndarray  # [N] bool
    lanes: np.ndarray  # [L] int32, sorted
    events_cap: int = DEFAULT_EVENTS_CAP

    @property
    def count(self) -> int:
        return int(self.lanes.size)

    def summary(self) -> str:
        shown = ", ".join(str(i) for i in self.lanes[:8])
        if self.count > 8:
            shown += ", …"
        return f"{self.count} traced instance(s) [{shown}]"


def parse_trace(d: dict, default_group: str = "") -> tuple[_Selector, int]:
    """Validate one raw ``[run.trace]`` table → (selector, events cap).

    ``default_group`` scopes a group-level declaration to its own group
    when no explicit ``group`` key is given (run-global tables pass
    ``""``) — the same scoping rule as ``faults.parse_fault``."""
    if not isinstance(d, dict):
        raise ValueError(
            f"trace entry must be a table, got {type(d).__name__}"
        )
    unknown = set(d) - _KNOWN_KEYS
    if unknown:
        raise ValueError(
            f"trace entry has unknown key(s) {sorted(unknown)}; known "
            f"keys: {sorted(_KNOWN_KEYS)}"
        )
    fraction = float(d.get("fraction", 0.0))
    if fraction and not (0.0 < fraction <= 1.0):
        raise ValueError(f"trace: fraction {fraction} not in (0, 1]")
    events = int(d.get("events", 0))
    if events < 0:
        raise ValueError(f"trace: events cap {events} must be >= 0")
    sel = _Selector(
        group=str(d.get("group", "") or default_group),
        instances=str(d.get("instances", "")),
        fraction=fraction,
        seed=int(d.get("seed", 0)),
    )
    return sel, events


def build_trace_plan(groups, trace_by_group: dict) -> TracePlan | None:
    """Validate + lower every declared trace table into one static plan.

    ``groups`` is the resolved ``GroupSpec`` layout; ``trace_by_group``
    maps group id → raw ``[groups.run.trace]`` table (key ``""`` holds
    the run-global ``[global.run.trace]``). Returns ``None`` when
    nothing is declared — the engine then compiles the identical
    no-trace program (the zero-overhead contract)."""
    n = sum(g.count for g in groups)
    mask = np.zeros((n,), bool)
    cap = 0
    declared = False
    for gid, table in sorted((trace_by_group or {}).items()):
        if not table:
            continue
        declared = True
        sel, events = parse_trace(table, default_group=gid)
        mask |= _resolve_mask(sel, groups, n, "trace")
        cap = max(cap, events)
    if not declared:
        return None
    lanes = np.flatnonzero(mask).astype(np.int32)
    if lanes.size > MAX_TRACE_LANES:
        raise ValueError(
            f"trace selects {lanes.size} instances, over the "
            f"MAX_TRACE_LANES budget of {MAX_TRACE_LANES} — the flight "
            "recorder is a sampling tool (every traced lane emits event "
            "rows each tick); narrow the range or use a fraction"
        )
    return TracePlan(
        n=n, mask=mask, lanes=lanes, events_cap=cap or DEFAULT_EVENTS_CAP
    )


def read_trace_events(
    outputs_root: str, plan: str, task_id: str, limit: int = 0
) -> list[dict]:
    """Read a task's recorded ``sim_trace.jsonl`` events back from the
    outputs tree — the ONE resolver behind ``tg trace`` (in-process) and
    the daemon's ``GET /trace`` route, so the two surfaces cannot drift.
    A task's runs live under ``<outputs>/<plan>/<task_id>`` (single run)
    or ``<task_id>-<run_id>`` (multi-``[[runs]]`` compositions); events
    from every matching run dir are returned in file order, each tagged
    with its ``run``. ``limit`` > 0 truncates."""
    import os

    from .telemetry import iter_jsonl

    root = os.path.join(outputs_root, plan)
    if not os.path.isdir(root):
        return []
    events: list[dict] = []
    for run_id in sorted(os.listdir(root)):
        if run_id != task_id and not run_id.startswith(task_id + "-"):
            continue
        path = os.path.join(root, run_id, TRACE_FILE)
        if not os.path.isfile(path):
            continue
        for ev in iter_jsonl(path):
            events.append(ev)
            if limit and len(events) >= limit:
                return events
    return events


# --------------------------------------------------------------- decoding


def events_from_blocks(blocks, group_of_instance) -> list[dict]:
    """Decode flushed ``[chunk, R, 5]`` trace blocks into jsonl-ready
    event dicts, dropping unused (kind < 0) and post-completion padding
    rows. ``group_of_instance(i)`` resolves an instance index to its
    group id for the ``group`` field."""
    out: list[dict] = []
    for block in blocks:
        arr = np.asarray(block).reshape(-1, 5)
        # vectorized prefilter: a quiet traced lane still emits its full
        # static row budget as kind = -1 padding, so the Python loop
        # must only ever see actual events, not the (much larger) blank
        # slot space
        arr = arr[(arr[:, 2] >= 0) & (arr[:, 0] >= 0)]
        for tick, lane, kind, a, b in arr:
            kind = int(kind)
            ev: dict = {
                "tick": int(tick),
                "instance": int(lane),
                "group": group_of_instance(int(lane)),
                "event": EVENT_KINDS[kind],
            }
            if kind == EV_STATUS:
                ev["status"] = _STATUS_NAMES[int(a) % 4]
                ev["prev"] = _STATUS_NAMES[int(b) % 4]
            elif kind == EV_SIGNAL:
                ev["state"] = int(a)
            elif kind == EV_SEND:
                ev["dst"] = int(a)
                ev["fate"] = FATE_NAMES[int(b) % 4]
            elif kind == EV_DELIVER:
                ev["src"] = int(a)
            out.append(ev)
    return out


def chrome_trace(events, lanes, lane_names: dict, tick_ms: float) -> dict:
    """Events → Chrome trace-event JSON (the ``trace_events.json``
    payload): one metadata-named track (tid) per traced instance, one
    instant event per recorded row, timestamps in microseconds of
    simulated time. Loads in Perfetto / chrome://tracing unchanged."""
    te: list[dict] = [
        {
            "name": "process_name",
            "ph": "M",
            "pid": 0,
            "tid": 0,
            "args": {"name": "tpu-testground sim"},
        }
    ]
    for lane in lanes:
        lane = int(lane)
        te.append(
            {
                "name": "thread_name",
                "ph": "M",
                "pid": 0,
                "tid": lane,
                "args": {"name": lane_names.get(lane, f"instance {lane}")},
            }
        )
    us_per_tick = tick_ms * 1000.0
    for ev in events:
        kind = ev["event"]
        if kind == "status":
            name = f"status→{ev['status']}"
        elif kind == "signal":
            name = f"signal s{ev['state']}"
        elif kind == "send":
            name = f"send→{ev['dst']} ({ev['fate']})"
        else:
            name = f"deliver←{ev.get('src', '?')}"
        args = {k: v for k, v in ev.items() if k not in ("tick", "instance")}
        te.append(
            {
                "name": name,
                "cat": kind,
                "ph": "i",
                "s": "t",  # thread-scoped instant
                "pid": 0,
                "tid": ev["instance"],
                "ts": ev["tick"] * us_per_tick,
                "args": args,
            }
        )
    return {"traceEvents": te, "displayTimeUnit": "ms"}
