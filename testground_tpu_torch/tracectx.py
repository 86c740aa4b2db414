"""Causal trace context for the control plane — the port's copy of the
reference's ``testground_tpu/tracectx.py``.

A task's journey — ``tg run`` submit → daemon HTTP → queue → supervisor
claim → executor run loop → sync service — crosses four processes and
two wire protocols. This module is the one shared vocabulary for the ids
that tie that journey together: a 128-bit ``trace_id`` minted once at
submit, and a 64-bit ``span_id`` per lifecycle phase, carried between
processes as a W3C-traceparent-shaped header string
(``00-<32 hex trace>-<16 hex span>-01``).

Deliberately tiny and stdlib-only: no propagation framework, no
sampling, no baggage. The daemon stores the ids on the ``Task`` row,
the supervisor threads them into ``RunInput.trace_ctx``, the executor's
``SpanTracer`` stamps them onto every ``run_spans.jsonl`` row, and the
sync client sends the task id in ``hello`` — everything else (tree
assembly, Perfetto export) happens at archive time from those ids.

Reference lineage: W3C Trace Context (traceparent) for the wire shape;
the reference testground daemon has no causal ids at all — task logs
are correlated by grep — which is precisely the gap this closes.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass, field

__all__ = [
    "TraceContext",
    "new_span_id",
    "new_trace_id",
    "parse_traceparent",
]

_TRACEPARENT_RE = re.compile(
    r"^[0-9a-f]{2}-([0-9a-f]{32})-([0-9a-f]{16})-[0-9a-f]{2}$"
)


def new_trace_id() -> str:
    """128-bit random trace id as 32 lowercase hex chars."""
    return os.urandom(16).hex()


def new_span_id() -> str:
    """64-bit random span id as 16 lowercase hex chars."""
    return os.urandom(8).hex()


def parse_traceparent(header: str) -> tuple[str, str] | None:
    """Parse a traceparent header into ``(trace_id, span_id)``.

    Returns ``None`` for anything malformed (wrong field count, bad hex,
    all-zero ids) — an invalid incoming header means "start a new
    trace", never an error, per the W3C spec's restart semantics.
    """
    m = _TRACEPARENT_RE.match((header or "").strip().lower())
    if m is None:
        return None
    trace_id, span_id = m.group(1), m.group(2)
    if trace_id == "0" * 32 or span_id == "0" * 16:
        return None
    return trace_id, span_id


@dataclass
class TraceContext:
    """One node's view of a trace: the shared trace id plus this
    process's current span. ``child()`` mints the next hop."""

    trace_id: str = field(default_factory=new_trace_id)
    span_id: str = field(default_factory=new_span_id)
    parent_id: str = ""

    @classmethod
    def mint(cls) -> "TraceContext":
        """A fresh root context (new trace, root span, no parent)."""
        return cls()

    @classmethod
    def from_traceparent(cls, header: str) -> "TraceContext | None":
        """Adopt an incoming traceparent: same trace, the header's span
        becomes this context's span (i.e. the parent for children minted
        here). ``None`` if the header is absent or malformed."""
        parsed = parse_traceparent(header)
        if parsed is None:
            return None
        trace_id, span_id = parsed
        return cls(trace_id=trace_id, span_id=span_id)

    def child(self) -> "TraceContext":
        """A new span in the same trace, parented to this one."""
        return TraceContext(
            trace_id=self.trace_id,
            span_id=new_span_id(),
            parent_id=self.span_id,
        )

    def to_traceparent(self) -> str:
        """The W3C wire form: version 00, sampled flag set."""
        return f"00-{self.trace_id}-{self.span_id}-01"
