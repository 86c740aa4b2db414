"""Task model: the unit of scheduled work — the port's copy of the
reference's ``testground_tpu/engine/task.py`` (``pkg/task/task.go``): a
task moves through scheduled → processing → complete (or canceled), carries
its composition and input, and ends with an outcome
(unknown/success/failure/canceled).

``stats_payload`` and ``perf_payload`` are the observability payloads of
``tg stats`` / ``GET /stats`` and ``tg perf`` / ``GET /perf``.
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
    "CreatedBy",
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

    def to_dict(self) -> dict:
        return {"state": self.state.value, "created": self.created}

    @classmethod
    def from_dict(cls, d: dict) -> "DatedState":
        return cls(state=State(d["state"]), created=float(d["created"]))


@dataclass
class CreatedBy:
    """Who created the task (``task.go:48-53``)."""

    user: str = ""
    repo: str = ""
    branch: str = ""
    commit: str = ""

    def to_dict(self) -> dict:
        return {
            "user": self.user,
            "repo": self.repo,
            "branch": self.branch,
            "commit": self.commit,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "CreatedBy":
        return cls(
            user=d.get("user", ""),
            repo=d.get("repo", ""),
            branch=d.get("branch", ""),
            commit=d.get("commit", ""),
        )


@dataclass
class Task:
    """(``task.go:55-74``)."""

    id: str
    type: TaskType
    priority: int = 0
    version: int = 0
    runner: str = ""
    plan: str = ""
    case: str = ""
    states: list[DatedState] = field(default_factory=list)
    composition: Any = None  # dict form of the composition
    input: Any = None
    result: Any = None
    error: str = ""
    created_by: CreatedBy = field(default_factory=CreatedBy)
    # Causal lifecycle-trace ids (tracectx.py): trace_id plus the span
    # ids of the lifecycle phases minted so far (root/queued/claim/
    # execute). Not the flight recorder, which lives in the result
    # journal under "trace"; this keyspace is control-plane only.
    trace: dict = field(default_factory=dict)

    def created(self) -> float:
        if not self.states:
            raise ValueError("task must have a state")
        return self.states[0].created

    def state(self) -> DatedState:
        if not self.states:
            raise ValueError("task must have a state")
        return self.states[-1]

    def is_canceled(self) -> bool:
        return self.state().state == State.CANCELED

    def name(self) -> str:
        if self.type == TaskType.BUILD:
            return "build"
        return f"{self.plan}:{self.case}"

    def took(self) -> float:
        """Seconds from creation to last state transition (``task.go:98-100``)."""
        return self.state().created - self.created()

    def queued_secs(self) -> float:
        """Seconds the task spent (or has spent so far) in the queue:
        scheduled → first PROCESSING transition, or scheduled → now for
        a task still waiting. The same quantity the supervisor reports
        in the perf payload, computable for every task in the store."""
        if not self.states:
            return 0.0
        t0 = self.states[0].created
        for ds in self.states[1:]:
            if ds.state == State.PROCESSING:
                return max(0.0, ds.created - t0)
        if self.states[-1].state == State.SCHEDULED:
            return max(0.0, time.time() - t0)
        return 0.0

    def created_by_ci(self) -> bool:
        cb = self.created_by
        return bool(cb.repo and cb.commit and cb.branch)

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

    def stats_payload(self) -> dict:
        """The telemetry-summary payload (``tg stats`` / GET /stats):
        identity plus the result journal's sim/telemetry/events sections.
        ONE builder for the daemon route and the in-process CLI, so the
        two surfaces cannot drift."""
        journal = (
            self.result.get("journal", {})
            if isinstance(self.result, dict)
            else {}
        )
        return {
            "task_id": self.id,
            "plan": self.plan,
            "case": self.case,
            "state": self.state().state.value,
            "outcome": self.outcome().value,
            "sim": journal.get("sim", {}),
            "telemetry": journal.get("telemetry", {}),
            # flight-recorder summary (docs/OBSERVABILITY.md) — the
            # events themselves are served by `tg trace` / GET /trace
            "trace": journal.get("trace", {}),
            # run health plane (docs/OBSERVABILITY.md "Run health
            # plane"): rule verdicts + bounded breach records
            "slo": journal.get("slo", {}),
            "events": journal.get("events", {}),
        }

    def perf_payload(self) -> dict:
        """The performance-ledger payload (``tg perf`` / GET /perf):
        identity, the journal's sim block, its nested perf ledger
        (surfaced at top level for consumers), and the supervisor's
        task-level timings (queue wait, per-run runner wall). ONE
        builder for the daemon route and the in-process CLI — same rule
        as :meth:`stats_payload`."""
        result = self.result if isinstance(self.result, dict) else {}
        journal = result.get("journal", {})
        if not isinstance(journal, dict):
            journal = {}
        sim = journal.get("sim", {})
        if not isinstance(sim, dict):
            sim = {}
        return {
            "task_id": self.id,
            "plan": self.plan,
            "case": self.case,
            "state": self.state().state.value,
            "outcome": self.outcome().value,
            "sim": {
                k: v for k, v in sim.items() if k not in ("perf", "phases")
            },
            "perf": sim.get("perf", {}),
            # phase attribution plane (sim/phases.py) — surfaced at top
            # level beside the ledger for `tg perf --phases` consumers
            "phases": sim.get("phases", {}),
            "task": result.get("perf", {})
            if isinstance(result.get("perf"), dict)
            else {},
        }

    def to_dict(self) -> dict:
        return {
            "version": self.version,
            "priority": self.priority,
            "id": self.id,
            "type": self.type.value,
            "runner": self.runner,
            "plan": self.plan,
            "case": self.case,
            "states": [s.to_dict() for s in self.states],
            "composition": self.composition,
            "input": self.input,
            "result": self.result,
            "error": self.error,
            "outcome": self.outcome().value,
            "created_by": self.created_by.to_dict(),
            "trace": dict(self.trace),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Task":
        return cls(
            id=d["id"],
            type=TaskType(d["type"]),
            priority=int(d.get("priority", 0)),
            version=int(d.get("version", 0)),
            runner=d.get("runner", ""),
            plan=d.get("plan", ""),
            case=d.get("case", ""),
            states=[DatedState.from_dict(s) for s in d.get("states", [])],
            composition=d.get("composition"),
            input=d.get("input"),
            result=d.get("result"),
            error=d.get("error", ""),
            created_by=CreatedBy.from_dict(d.get("created_by", {})),
            trace=dict(d.get("trace") or {}),
        )
