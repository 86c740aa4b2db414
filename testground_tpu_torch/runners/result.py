"""Run result types — the port's copy of the reference's ``Result``
(``testground_tpu/runners/result.py``; ``pkg/runner/common_result.go``)."""

from __future__ import annotations

from dataclasses import dataclass, field

from ..api import RunInput
from ..engine.task import Outcome

__all__ = ["GroupOutcome", "Result"]


@dataclass
class GroupOutcome:
    total: int = 0
    ok: int = 0

    def to_dict(self) -> dict:
        return {"total": self.total, "ok": self.ok}


@dataclass
class Result:
    """(``common_result.go:8-31``)."""

    outcome: Outcome = Outcome.UNKNOWN
    outcomes: dict[str, GroupOutcome] = field(default_factory=dict)
    journal: dict = field(default_factory=dict)

    @classmethod
    def for_input(cls, inp: RunInput) -> "Result":
        r = cls(journal={"events": {}, "pods_statuses": {}})
        for g in inp.groups:
            r.outcomes[g.id] = GroupOutcome(total=g.instances, ok=0)
        return r

    def update_outcome(self) -> None:
        """All-ok ⇒ success, else failure (``common_result.go:52-59``)."""
        for g in self.outcomes.values():
            if g.total != g.ok:
                self.outcome = Outcome.FAILURE
                return
        self.outcome = Outcome.SUCCESS

    def to_dict(self) -> dict:
        return {
            "outcome": self.outcome.value,
            "outcomes": {k: v.to_dict() for k, v in self.outcomes.items()},
            "journal": self.journal,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Result":
        """Inverse of :meth:`to_dict`: a Result across the cohort-leader
        child boundary (``sim/cohort.py``)."""
        return cls(
            outcome=Outcome(d.get("outcome", Outcome.UNKNOWN.value)),
            outcomes={
                k: GroupOutcome(total=int(v.get("total", 0)), ok=int(v.get("ok", 0)))
                for k, v in d.get("outcomes", {}).items()
            },
            journal=dict(d.get("journal", {})),
        )
