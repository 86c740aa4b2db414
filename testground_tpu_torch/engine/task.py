"""The task model — the port's copy of what the in-process CLI needs of the
reference's ``testground_tpu/engine/task.py`` (``pkg/task/task.go``): a
task moves through scheduled → processing → complete (or canceled),
carries its composition and input, and ends with an outcome.

The task store, the queue and their payloads (``stats_payload``,
``perf_payload``, ``to_dict``) come with the engine (ROADMAP queue 1 item
9e).
"""

from __future__ import annotations

import enum
import os
import secrets
import threading
import time
from dataclasses import dataclass, field
from typing import Any

__all__ = [
    "DatedState",
    "Outcome",
    "State",
    "Task",
    "TaskType",
    "new_task_id",
]


class State(str, enum.Enum):
    """(``task.go:13-20``)."""

    SCHEDULED = "scheduled"
    PROCESSING = "processing"
    COMPLETE = "complete"
    CANCELED = "canceled"


class Outcome(str, enum.Enum):
    """(``task.go:22-29``)."""

    UNKNOWN = "unknown"
    SUCCESS = "success"
    FAILURE = "failure"
    CANCELED = "canceled"


class TaskType(str, enum.Enum):
    """(``task.go:31-40``)."""

    BUILD = "build"
    RUN = "run"


# xid-style ids: 20 lowercase base32hex chars, time-prefixed so they sort by
# creation (the reference uses rs/xid; integration_tests/header.sh asserts
# run-id length == 20).
_B32HEX = "0123456789abcdefghijklmnopqrstuv"
_counter = [secrets.randbelow(1 << 24)]
_counter_lock = threading.Lock()


def _b32(n: int, width: int) -> str:
    out = []
    for _ in range(width):
        out.append(_B32HEX[n & 31])
        n >>= 5
    return "".join(reversed(out))


def new_task_id() -> str:
    with _counter_lock:
        _counter[0] = (_counter[0] + 1) & 0xFFFFFF
        cnt = _counter[0]
    ts = int(time.time())
    rnd = (os.getpid() & 0xFFFF) ^ secrets.randbelow(1 << 16)
    # 7 chars time + 4 chars pid/random + 4 chars random + 5 chars counter = 20
    return (
        _b32(ts, 7) + _b32(rnd, 4) + _b32(secrets.randbelow(1 << 20), 4) + _b32(cnt, 5)
    )


@dataclass
class DatedState:
    """A state with a timestamp (``task.go:43-46``)."""

    state: State
    created: float  # unix seconds


@dataclass
class Task:
    """(``task.go:55-74``), without the priority, version and creator the
    queue reads."""

    id: str
    type: TaskType
    runner: str = ""
    plan: str = ""
    case: str = ""
    states: list[DatedState] = field(default_factory=list)
    composition: Any = None  # dict form of the composition
    input: Any = None
    result: Any = None
    error: str = ""
    # causal lifecycle-trace ids: trace_id plus the span ids of the
    # lifecycle phases minted so far
    trace: dict = field(default_factory=dict)

    def state(self) -> DatedState:
        if not self.states:
            raise ValueError("task must have a state")
        return self.states[-1]

    def name(self) -> str:
        if self.type == TaskType.BUILD:
            return "build"
        return f"{self.plan}:{self.case}"

    def outcome(self) -> Outcome:
        """Map task state + result to an outcome — the semantics of
        ``pkg/data/result.go:17-51``."""
        st = self.state().state
        if st == State.CANCELED:
            return Outcome.CANCELED
        if st != State.COMPLETE:
            return Outcome.UNKNOWN
        if self.error:
            return Outcome.FAILURE
        if isinstance(self.result, dict) and "outcome" in self.result:
            try:
                return Outcome(self.result["outcome"])
            except ValueError:
                return Outcome.UNKNOWN
        return Outcome.UNKNOWN
