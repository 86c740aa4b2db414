"""The fleet controller's decisions — the port's copy of the reference's
``testground_tpu/engine/controller.py``: the typed preemption of a run
(:class:`TaskPreemptedError`, raised by the executor at a chunk boundary
and caught by the supervisor, which requeues the task to resume from its
newest snapshot) and the priority-eviction policy
(:func:`pick_eviction_victim`). Stdlib only, so the supervisor catches
the error without importing torch.
"""

from __future__ import annotations

__all__ = ["TaskPreemptedError", "pick_eviction_victim"]


class TaskPreemptedError(RuntimeError):
    """A run stopped at a chunk boundary because its preemption signal was
    set. Not a failure: the supervisor requeues the task to resume from its
    newest snapshot (``resumable``) or to rerun from tick 0 (no snapshot).

    The executor's ordering (``sim/executor.py``'s tail): an operator
    cancel wins over a preemption, and so does a fail-severity SLO
    breach."""

    def __init__(self, run_id: str, *, tick: int = 0, snapshot_tick: int = 0,
                 snapshots: int = 0, resumable: bool = False):
        self.run_id = run_id
        self.tick = int(tick)
        self.snapshot_tick = int(snapshot_tick)
        self.snapshots = int(snapshots)
        self.resumable = bool(resumable)
        super().__init__(
            f"run {run_id} preempted at tick {tick}"
            + (
                f" (snapshot at tick {snapshot_tick}, will resume)"
                if resumable
                else " (no snapshot — will rerun from scratch)"
            )
        )


def pick_eviction_victim(candidates: list[dict], arriving_priority: int) -> dict | None:
    """The running task a higher-priority arrival evicts, or None.

    ``candidates`` rows: ``{"id", "priority", "started" (epoch secs),
    "checkpointed" (bool)}``. Only a lower priority than the arrival's is
    evictable (never a lateral move); the lowest priority loses first,
    then a checkpointed task (it resumes from its snapshot), then the most
    recently started (the least work lost)."""
    evictable = [c for c in candidates
                 if int(c.get("priority", 0)) < int(arriving_priority)]
    if not evictable:
        return None
    return min(
        evictable,
        key=lambda c: (
            int(c.get("priority", 0)),
            not bool(c.get("checkpointed")),
            -float(c.get("started", 0.0)),
        ),
    )
