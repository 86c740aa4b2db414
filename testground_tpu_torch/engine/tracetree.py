"""Archive-time assembly of a task's lifecycle span tree — the port's
copy of the reference's ``testground_tpu/engine/tracetree.py``.

The control plane stamps ids as the task moves (``Task.trace``: trace_id
plus root/queued/claim/execute span ids) and the executor's
``SpanTracer`` writes run-phase spans with the same vocabulary
(``run_spans.jsonl`` rows carry trace_id/span_id/parent_id/wall_ns).
Nobody holds the whole tree in memory — this module derives it once,
when the task archives, from the state timestamps + those files:

- ``task_spans.jsonl`` — one JSON record per span:
  ``{"name", "trace_id", "span_id", "parent_id", "start_ns",
  "end_ns", "kind": "lifecycle" | "run" | "point", ...attrs}``.
  Every parent_id resolves to another record's span_id (or "" for the
  root ``submit`` span) — the connectivity contract tests pin.
- ``task_trace.json`` — the same tree as Chrome/Perfetto trace-event
  JSON ("X" complete events, µs timestamps), so ``chrome://tracing``
  or ui.perfetto.dev opens a task's submit→archive timeline directly.

Both land in the task's run output dir, ``tg collect`` carries them,
``GET /artifact`` serves them and ``tg trace --lifecycle`` renders the
tree. Export is best-effort: a failure here must never fail the task it
describes.
"""

from __future__ import annotations

import glob
import json
import os

from ..sim.telemetry import SPAN_FILE, iter_jsonl

from .task import State, Task

__all__ = [
    "TASK_SPANS_FILE",
    "TASK_TRACE_FILE",
    "export_task_trace",
    "load_task_spans",
    "lifecycle_spans",
]

TASK_SPANS_FILE = "task_spans.jsonl"
TASK_TRACE_FILE = "task_trace.json"

_NS = 1_000_000_000


def lifecycle_spans(tsk: Task) -> list[dict]:
    """The control-plane half of the tree, derived from ``Task.trace``
    ids and the persisted state timestamps. Returns [] when the task
    has no trace ids (pre-upgrade rows) — the export then skips."""
    tr = tsk.trace or {}
    trace_id = tr.get("trace_id", "")
    root = tr.get("root_span_id", "")
    if not trace_id or not root or not tsk.states:
        return []
    t0 = int(tsk.states[0].created * _NS)
    t_final = int(tsk.states[-1].created * _NS)
    # PROCESSING episodes: a preempted task re-queues (SCHEDULED) and is
    # claimed again, so one task can hold several [claim..requeue) spans
    episodes: list[tuple[int, int]] = []
    ep_start = None
    for ds in tsk.states[1:]:
        ts = int(ds.created * _NS)
        if ds.state == State.PROCESSING:
            if ep_start is not None:
                episodes.append((ep_start, ts))
            ep_start = ts
        elif ds.state == State.SCHEDULED and ep_start is not None:
            episodes.append((ep_start, ts))
            ep_start = None
    if ep_start is not None:
        episodes.append((ep_start, t_final))
    t_proc = episodes[0][0] if episodes else None

    def span(name, sid, parent, start, end, kind="lifecycle", **attrs):
        return {
            "name": name,
            "trace_id": trace_id,
            "span_id": sid,
            "parent_id": parent,
            "start_ns": start,
            "end_ns": end,
            "kind": kind,
            **attrs,
        }

    out = [
        span(
            "submit",
            root,
            "",
            t0,
            t_final,
            task=tsk.id,
            plan=tsk.plan,
            case=tsk.case,
            task_type=tsk.type.value,
            state=tsk.states[-1].state.value,
            outcome=tsk.outcome().value,
        )
    ]
    queued = tr.get("queued_span_id", "")
    if queued:
        out.append(
            span("queued", queued, root, t0, t_proc or t_final,
                 priority=tsk.priority)
        )
    claim = tr.get("claim_span_id", "")
    if claim and t_proc is not None:
        attrs = {}
        if tr.get("pack_leader"):
            attrs["pack_leader"] = tr["pack_leader"]
            attrs["pack_width"] = tr.get("pack_width", 0)
        if tr.get("solo_reason"):
            attrs["solo_reason"] = tr["solo_reason"]
        # one claim/execute pair per attempt — earlier (preempted)
        # attempts kept their span ids in trace["prior_attempts"] so
        # the executor spans they parented still join the tree
        attempts = list(tr.get("prior_attempts") or [])
        attempts.append(
            {"claim": claim, "execute": tr.get("execute_span_id", "")}
        )
        eps = episodes[-len(attempts):]
        while len(eps) < len(attempts):
            eps.insert(0, (t_proc, t_final))
        for i, (att, (ep_s, ep_e)) in enumerate(zip(attempts, eps)):
            last = i == len(attempts) - 1
            a = dict(attrs) if last else {"preempted": True}
            if len(attempts) > 1:
                a["attempt"] = i + 1
            out.append(
                span(
                    "claim", att.get("claim", ""), queued or root,
                    ep_s, ep_e, **a,
                )
            )
            if att.get("execute"):
                out.append(
                    span(
                        "execute", att["execute"], att.get("claim", ""),
                        ep_s, ep_e,
                    )
                )
    out.append(
        span(
            "archive",
            tr.get("archive_span_id") or root + "-archive",
            root,
            t_final,
            t_final,
            kind="point",
        )
    )
    return out


def _run_span_rows(run_dir: str) -> list[dict]:
    """Executor spans for this task, read back from run_spans.jsonl in
    the task's run dir plus any multi-[[runs]] sibling dirs
    (``<task>-<run>``). start/end rows pair by span_id; an unmatched
    start (crashed run) closes at its own timestamp; points become
    zero-length spans."""
    paths = [os.path.join(run_dir, SPAN_FILE)]
    paths += sorted(
        glob.glob(os.path.join(run_dir + "-*", SPAN_FILE))
    )
    open_spans: dict[str, dict] = {}
    out: list[dict] = []
    for path in paths:
        for line in iter_jsonl(path):
            ev = line.get("event")
            if not isinstance(ev, dict):
                continue
            sid = ev.get("span_id", "")
            wall = int(ev.get("wall_ns") or line.get("ts") or 0)
            typ = ev.get("type")
            attrs = {
                k: v
                for k, v in ev.items()
                if k
                not in (
                    "type",
                    "span",
                    "trace_id",
                    "span_id",
                    "parent_id",
                    "wall_ns",
                )
            }
            if typ == "span_start" and sid:
                open_spans[sid] = {
                    "name": ev.get("span", ""),
                    "trace_id": ev.get("trace_id", ""),
                    "span_id": sid,
                    "parent_id": ev.get("parent_id", ""),
                    "start_ns": wall,
                    "end_ns": wall,
                    "kind": "run",
                    **attrs,
                }
            elif typ == "span_end":
                rec = open_spans.pop(sid, None) if sid else None
                if rec is None:
                    # ends without a matched start (legacy rows with no
                    # span_id): skip rather than invent a node
                    continue
                rec["end_ns"] = wall
                rec.update(attrs)
                out.append(rec)
            elif typ == "point" and sid:
                out.append(
                    {
                        "name": ev.get("span", ""),
                        "trace_id": ev.get("trace_id", ""),
                        "span_id": sid,
                        "parent_id": ev.get("parent_id", ""),
                        "start_ns": wall,
                        "end_ns": wall,
                        "kind": "point",
                        **attrs,
                    }
                )
    # crashed runs leave spans open — close them at their start so the
    # tree stays connected and Perfetto still renders them
    out.extend(open_spans.values())
    return out


def _perfetto_events(spans: list[dict]) -> list[dict]:
    events = []
    for s in spans:
        ts_us = s["start_ns"] / 1000.0
        dur_us = max(0.0, (s["end_ns"] - s["start_ns"]) / 1000.0)
        args = {
            k: v
            for k, v in s.items()
            if k not in ("name", "start_ns", "end_ns", "kind")
        }
        if s["kind"] == "point":
            events.append(
                {
                    "name": s["name"],
                    "cat": s["kind"],
                    "ph": "i",
                    "s": "t",
                    "ts": ts_us,
                    "pid": 1,
                    "tid": 1 if s["kind"] == "lifecycle" else 2,
                    "args": args,
                }
            )
        else:
            events.append(
                {
                    "name": s["name"],
                    "cat": s["kind"],
                    "ph": "X",
                    "ts": ts_us,
                    "dur": dur_us,
                    "pid": 1,
                    "tid": 1 if s["kind"] == "lifecycle" else 2,
                    "args": args,
                }
            )
    return events


def export_task_trace(outputs_root: str, tsk: Task) -> str | None:
    """Write ``task_spans.jsonl`` + ``task_trace.json`` for an archived
    task into its run output dir. Returns the spans path, or None when
    the task carries no trace ids or the write fails (best-effort — the
    archive itself already succeeded)."""
    try:
        life = lifecycle_spans(tsk)
        if not life:
            return None
        run_dir = os.path.join(outputs_root, tsk.plan, tsk.id)
        os.makedirs(run_dir, exist_ok=True)
        spans = life + _run_span_rows(run_dir)
        spans.sort(key=lambda s: (s["start_ns"], s["span_id"]))
        spans_path = os.path.join(run_dir, TASK_SPANS_FILE)
        with open(spans_path, "w", encoding="utf-8") as f:
            for s in spans:
                f.write(json.dumps(s, default=str) + "\n")
        trace = {
            "displayTimeUnit": "ms",
            "traceEvents": _perfetto_events(spans),
        }
        with open(
            os.path.join(run_dir, TASK_TRACE_FILE), "w", encoding="utf-8"
        ) as f:
            json.dump(trace, f)
        return spans_path
    except (OSError, ValueError, TypeError, KeyError):
        return None


def load_task_spans(path: str) -> list[dict]:
    """Read a ``task_spans.jsonl`` back (tolerant, like every other
    observability reader)."""
    return [r for r in iter_jsonl(path) if isinstance(r, dict)]
