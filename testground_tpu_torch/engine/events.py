"""Daemon event journal: the control plane's append-only audit log — the
port's copy of the reference's ``testground_tpu/engine/events.py``.

Every task state transition, claim, pack admission, SLO cancel,
operator cancel, checkpoint and sync eviction lands here as one JSON
line in ``daemon_events.jsonl`` (under the daemon state dir, next to
``tasks.db``). Records carry both clocks — wall ns for cross-host
correlation, monotonic ns for intra-daemon ordering that survives NTP
slew — plus the task's trace ids so the journal joins the lifecycle
span tree.

This is the audit stream a fleet controller consumes to answer "why did
the daemon do that": admission decisions, preemptions and migrations
become replayable from the journal alone. Served live by
``GET /events?since=<byte offset>`` (daemon/server.py) through
:class:`JournalTail`, the reference's byte-offset tail
(``engine/stream.py`` ``_Tail``, which the port's ``engine/stream.py``
also tails the run outputs with).

Bounded by size-based rotation: when the journal exceeds ``max_bytes``
it is renamed to ``daemon_events.jsonl.1`` (replacing any previous
rotation) and a fresh file begins — the journal is an operational
tail, not an unbounded archive. Emission never raises: observability
must not fail the daemon it observes.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Iterator

__all__ = ["EVENTS_FILE", "EventJournal", "JournalTail"]

EVENTS_FILE = "daemon_events.jsonl"

# bytes one tail read takes at a time (the reference's _READ_CHUNK)
_READ_CHUNK = 1 << 20

# Rotation threshold. 4 MiB of ~250-byte records is ~16k events — hours
# of busy-daemon history, small enough to tail over HTTP in one read.
_MAX_BYTES_DEFAULT = 4 << 20


class EventJournal:
    """Thread-safe append-only jsonl journal with single-slot rotation.

    Record shape (every record, extra keys per event type):

    ``{"seq": n, "ts_wall_ns": ..., "ts_mono_ns": ..., "type": "...",
    "task": "<task id>", "trace_id": "...", "span_id": "...", ...}``

    ``seq`` increases monotonically for the journal's lifetime (it does
    NOT reset on rotation), so consumers detect gaps after a rotation
    they slept through.
    """

    def __init__(self, path: str, max_bytes: int = _MAX_BYTES_DEFAULT):
        self.path = path
        self.max_bytes = max(1, int(max_bytes))
        self._lock = threading.Lock()
        self._seq = 0
        self._size = 0
        try:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._size = os.path.getsize(path)
        except OSError:
            self._size = 0
        # resume seq from the existing journal so a daemon restart
        # keeps the file monotonic (consumers detect gaps, not resets)
        if self._size:
            try:
                with open(path, "rb") as f:
                    f.seek(max(0, self._size - 8192))
                    tail = f.read().decode("utf-8", "replace")
                for line in reversed(tail.splitlines()):
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        self._seq = int(json.loads(line).get("seq", 0))
                        break
                    except (ValueError, TypeError):
                        continue
            except OSError:
                pass

    def emit(
        self,
        type_: str,
        task: str = "",
        trace: dict | None = None,
        **attrs,
    ) -> None:
        """Append one event. ``trace`` is a Task.trace-shaped dict; its
        trace_id and the most specific span id minted so far are copied
        onto the record. Never raises."""
        trace = trace or {}
        rec = {
            "seq": 0,  # patched under the lock
            "ts_wall_ns": time.time_ns(),
            "ts_mono_ns": time.monotonic_ns(),
            "type": type_,
            "task": task,
            "trace_id": trace.get("trace_id", ""),
            "span_id": (
                trace.get("claim_span_id")
                or trace.get("queued_span_id")
                or trace.get("root_span_id", "")
            ),
        }
        rec.update(attrs)
        try:
            with self._lock:
                self._seq += 1
                rec["seq"] = self._seq
                line = json.dumps(rec, default=str) + "\n"
                if self._size + len(line) > self.max_bytes:
                    self._rotate_locked()
                with open(self.path, "a", encoding="utf-8") as f:
                    f.write(line)
                self._size += len(line)
        except (OSError, ValueError, TypeError):
            pass

    def _rotate_locked(self) -> None:
        try:
            os.replace(self.path, self.path + ".1")
        except OSError:
            pass
        self._size = 0


class JournalTail:
    """Byte-offset tail over one jsonl file: yields complete lines only
    (the trailing partial line of an in-flight write stays unconsumed
    until its newline lands) — the reference's ``engine/stream.py``
    ``_Tail``, reading ``read_chunk`` bytes at a time."""

    def __init__(self, path: str, read_chunk: int = _READ_CHUNK):
        self.path = path
        self.offset = 0
        self.read_chunk = read_chunk

    def read_new(self) -> Iterator[dict]:
        """Yield the rows appended since the last call, reading in
        bounded chunks (memory stays O(read_chunk) however large the
        backlog)."""
        try:
            size = os.path.getsize(self.path)
            if size <= self.offset:
                return
            with open(self.path, "rb") as f:
                while self.offset < size:
                    f.seek(self.offset)
                    data = f.read(min(self.read_chunk, size - self.offset))
                    if not data:
                        return
                    end = data.rfind(b"\n")
                    # a single line longer than the chunk: keep reading
                    # until its newline (degenerate, rows are ~100 B)
                    while end < 0 and self.offset + len(data) < size:
                        more = f.read(
                            min(self.read_chunk, size - self.offset - len(data))
                        )
                        if not more:
                            return
                        data += more
                        end = data.rfind(b"\n")
                    if end < 0:
                        return  # no complete line yet
                    self.offset += end + 1
                    for line in data[: end + 1].splitlines():
                        line = line.strip()
                        if not line:
                            continue
                        try:
                            yield json.loads(line)
                        except json.JSONDecodeError:
                            continue  # foreign noise — tolerant reader
        except OSError:
            return
