"""Persistent priority queue for tasks — the port's copy of the reference's
``testground_tpu/engine/queue.py``, with ``claim_matching``, the run packs'
claim.

Twin of ``pkg/task/queue.go``: an in-memory heap ordered by
priority (descending) then creation time (FIFO), write-through to storage, a
bounded size, rehydration from storage on restart, and CI dedup via
``push_unique_by_branch``.
"""

from __future__ import annotations

import heapq
import threading
import time

from .storage import TaskStorage
from .task import DatedState, State, Task

__all__ = ["QueueFullError", "QueueEmptyError", "TaskQueue"]


class QueueFullError(Exception):
    """(``queue.go:15``)."""


class QueueEmptyError(Exception):
    """(``queue.go:14``)."""


class _Entry:
    """Heap entry: priority desc, then FIFO by creation time
    (``queue.go:178-189``)."""

    __slots__ = ("task",)

    def __init__(self, task: Task):
        self.task = task

    def __lt__(self, other: "_Entry") -> bool:
        a, b = self.task, other.task
        if a.priority != b.priority:
            return a.priority > b.priority
        return a.created() < b.created()


class TaskQueue:
    """Thread-safe bounded priority queue, write-through persisted."""

    def __init__(self, storage: TaskStorage, max_size: int):
        self._storage = storage
        self._max = max_size
        self._lock = threading.Lock()
        self._heap: list[_Entry] = []
        # Rehydrate scheduled + interrupted-processing tasks from storage
        # (``queue.go:18-31``).
        for tsk in storage.recover_processing():
            heapq.heappush(self._heap, _Entry(tsk))
        for tsk in storage.scheduled():
            if not any(e.task.id == tsk.id for e in self._heap):
                heapq.heappush(self._heap, _Entry(tsk))

    def __len__(self) -> int:
        with self._lock:
            return len(self._heap)

    def push(self, tsk: Task) -> None:
        """(``queue.go:52-76``)."""
        with self._lock:
            self._push_locked(tsk)

    def _push_locked(self, tsk: Task) -> None:
        if len(self._heap) >= self._max:
            raise QueueFullError("queue full")
        self._storage.persist_scheduled(tsk)
        heapq.heappush(self._heap, _Entry(tsk))

    def requeue(self, tsk: Task) -> None:
        """Put a claimed (PROCESSING) task back on the queue — the fleet
        controller's preempt/drain/evict path (``engine.py``). Bypasses
        the size bound: the task already held a queue slot once, and a
        full queue must never strand a checkpointed evictee in limbo.
        The caller appends the SCHEDULED state first; storage moves the
        record current → queue atomically."""
        with self._lock:
            self._storage.persist_rescheduled(tsk)
            heapq.heappush(self._heap, _Entry(tsk))

    def push_unique_by_branch(self, tsk: Task) -> None:
        """Cancel queued tasks from the same repo+branch, then push
        (``queue.go:79-96``)."""
        with self._lock:
            if tsk.created_by.repo and tsk.created_by.branch:
                self._remove_existing_locked(
                    tsk.created_by.branch, tsk.created_by.repo
                )
            self._push_locked(tsk)

    def _remove_existing_locked(self, branch: str, repo: str) -> None:
        keep: list[_Entry] = []
        for e in self._heap:
            cb = e.task.created_by
            if cb.repo == repo and cb.branch == branch:
                self._cancel_locked(e.task)
            else:
                keep.append(e)
        self._heap = keep
        heapq.heapify(self._heap)

    def _cancel_locked(self, tsk: Task) -> None:
        """(``queue.go:146-170``)."""
        tsk.states.append(DatedState(state=State.CANCELED, created=time.time()))
        self._storage.archive(tsk)

    def pop(self) -> Task:
        """Pop highest-priority task and mark it processing in storage
        (``queue.go:101-117``)."""
        with self._lock:
            if not self._heap:
                raise QueueEmptyError("queue empty")
            tsk = heapq.heappop(self._heap).task
            tsk.states.append(
                DatedState(state=State.PROCESSING, created=time.time())
            )
            self._storage.persist_processing(tsk)
            return tsk

    def claim_matching(self, match, limit: int) -> list[Task]:
        """Pop up to ``limit`` queued tasks satisfying ``match(task)``, in
        heap order (priority desc, then FIFO) — the pack-admission claim
        (``engine/pack.py``). Each claimed task transitions to PROCESSING
        exactly like :meth:`pop`; the caller owns its lifecycle from here."""
        if limit <= 0:
            return []
        claimed: list[Task] = []
        with self._lock:
            keep: list[_Entry] = []
            # heap order = sorted entries (priority desc, FIFO)
            for e in sorted(self._heap):
                if len(claimed) < limit and match(e.task):
                    e.task.states.append(
                        DatedState(state=State.PROCESSING, created=time.time())
                    )
                    self._storage.persist_processing(e.task)
                    claimed.append(e.task)
                else:
                    keep.append(e)
            if claimed:
                self._heap = keep
                heapq.heapify(self._heap)
        return claimed

    def cancel_queued(self, task_id: str) -> bool:
        """Cancel a still-queued task by id (used by the engine's kill path
        for tasks that never started)."""
        with self._lock:
            for i, e in enumerate(self._heap):
                if e.task.id == task_id:
                    del self._heap[i]
                    heapq.heapify(self._heap)
                    self._cancel_locked(e.task)
                    return True
        return False
