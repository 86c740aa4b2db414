"""Task storage — the port's copy of the reference's
``testground_tpu/engine/storage.py``.

Twin of ``pkg/task/storage.go`` (LevelDB with ``queue`` /
``current`` / ``archive`` prefixes) on sqlite3: one table keyed by
(bucket, task id), with date-ordered iteration for filtering. A ``:memory:``
path gives the reference's in-memory storage mode.
"""

from __future__ import annotations

import json
import sqlite3
import threading

from .task import DatedState, State, Task

__all__ = ["TaskStorage"]

BUCKET_QUEUE = "queue"
BUCKET_CURRENT = "current"
BUCKET_ARCHIVE = "archive"

_SCHEMA = """
CREATE TABLE IF NOT EXISTS tasks (
    bucket  TEXT NOT NULL,
    id      TEXT NOT NULL,
    created REAL NOT NULL,
    data    TEXT NOT NULL,
    PRIMARY KEY (bucket, id)
);
CREATE INDEX IF NOT EXISTS tasks_by_created ON tasks (bucket, created);
"""


class TaskStorage:
    """Persist tasks through their lifecycle. Thread-safe."""

    def __init__(self, path: str = ":memory:"):
        self.path = path
        self._lock = threading.Lock()
        self._db = sqlite3.connect(path, check_same_thread=False)
        with self._lock:
            self._db.executescript(_SCHEMA)
            self._db.commit()

    def close(self) -> None:
        with self._lock:
            self._db.close()

    # -------------------------------------------------------------- persists

    def _move(self, tsk: Task, to_bucket: str, from_buckets: tuple[str, ...]) -> None:
        """Atomically move a task between buckets: one transaction, so a
        concurrent ``get()`` never observes the task in no bucket."""
        with self._lock:
            for b in from_buckets:
                self._db.execute(
                    "DELETE FROM tasks WHERE bucket = ? AND id = ?", (b, tsk.id)
                )
            self._db.execute(
                "INSERT OR REPLACE INTO tasks (bucket, id, created, data) "
                "VALUES (?, ?, ?, ?)",
                (to_bucket, tsk.id, tsk.created(), json.dumps(tsk.to_dict())),
            )
            self._db.commit()

    def _delete(self, bucket: str, task_id: str) -> None:
        with self._lock:
            self._db.execute(
                "DELETE FROM tasks WHERE bucket = ? AND id = ?", (bucket, task_id)
            )
            self._db.commit()

    def persist_scheduled(self, tsk: Task) -> None:
        """Task entered the queue (``storage.go:140-145``)."""
        self._move(tsk, BUCKET_QUEUE, ())

    def persist_processing(self, tsk: Task) -> None:
        """Task moved queue → current (``storage.go:147-151``)."""
        self._move(tsk, BUCKET_CURRENT, (BUCKET_QUEUE,))

    def persist_rescheduled(self, tsk: Task) -> None:
        """A requeued task moved current → queue (the fleet controller's
        preempt/drain path, ``supervisor._requeue_preempted``). Clearing the CURRENT row
        in the same transaction matters: ``get()`` prefers CURRENT over
        QUEUE, so a plain ``persist_scheduled`` would leave a stale
        PROCESSING record shadowing the requeued one."""
        self._move(tsk, BUCKET_QUEUE, (BUCKET_CURRENT,))

    def update_current(self, tsk: Task) -> None:
        self._move(tsk, BUCKET_CURRENT, ())

    def archive(self, tsk: Task) -> None:
        """Task finished; move current → archive (``storage.go:153-158``)."""
        self._move(tsk, BUCKET_ARCHIVE, (BUCKET_QUEUE, BUCKET_CURRENT))

    # ---------------------------------------------------------------- reads

    def get(self, task_id: str) -> Task | None:
        """Look up a task in any bucket (archive > current > queue wins so the
        most-final record is returned)."""
        with self._lock:
            rows = self._db.execute(
                "SELECT bucket, data FROM tasks WHERE id = ?", (task_id,)
            ).fetchall()
        by_bucket = {b: d for b, d in rows}
        for bucket in (BUCKET_ARCHIVE, BUCKET_CURRENT, BUCKET_QUEUE):
            if bucket in by_bucket:
                return Task.from_dict(json.loads(by_bucket[bucket]))
        return None

    def list_bucket(self, bucket: str, newest_first: bool = True) -> list[Task]:
        order = "DESC" if newest_first else "ASC"
        with self._lock:
            rows = self._db.execute(
                f"SELECT data FROM tasks WHERE bucket = ? ORDER BY created {order}",
                (bucket,),
            ).fetchall()
        return [Task.from_dict(json.loads(r[0])) for r in rows]

    def scheduled(self) -> list[Task]:
        return self.list_bucket(BUCKET_QUEUE, newest_first=False)

    def processing(self) -> list[Task]:
        return self.list_bucket(BUCKET_CURRENT, newest_first=False)

    def archived(self) -> list[Task]:
        return self.list_bucket(BUCKET_ARCHIVE)

    def filter(
        self,
        types: list[str] | None = None,
        states: list[str] | None = None,
        before: float | None = None,
        after: float | None = None,
        limit: int = 0,
    ) -> list[Task]:
        """Date-range + type/state filtered listing, newest first
        (``storage.go:188-232`` semantics)."""
        out: list[Task] = []
        for bucket, state in (
            (BUCKET_QUEUE, State.SCHEDULED),
            (BUCKET_CURRENT, State.PROCESSING),
            (BUCKET_ARCHIVE, State.COMPLETE),
        ):
            if states and state.value not in states:
                continue
            for tsk in self.list_bucket(bucket):
                if types and tsk.type.value not in types:
                    continue
                if before is not None and tsk.created() >= before:
                    continue
                if after is not None and tsk.created() <= after:
                    continue
                out.append(tsk)
        out.sort(key=lambda t: t.created(), reverse=True)
        if limit:
            out = out[:limit]
        return out

    def delete(self, task_id: str) -> bool:
        """Remove a task's records from every bucket (the reference daemon's
        GET ``/delete`` surface, ``pkg/daemon/daemon.go:88``). Returns True
        if anything was deleted."""
        with self._lock:
            cur = self._db.execute(
                "DELETE FROM tasks WHERE id = ?", (task_id,)
            )
            self._db.commit()
            return cur.rowcount > 0

    # ------------------------------------------------------------- recovery

    def recover_processing(self) -> list[Task]:
        """Tasks that were mid-processing when the daemon died; the engine
        re-queues them on boot (``queue.go:18-31`` rehydration covers queue +
        current)."""
        tasks = self.processing()
        for tsk in tasks:
            tsk.states.append(
                DatedState(state=State.SCHEDULED, created=tsk.state().created)
            )
            self._move(tsk, BUCKET_QUEUE, (BUCKET_CURRENT,))
        return tasks
