"""The scheduler core: task model, persistent priority queue, worker
supervisor, and the engine facade tying builders/runners together — the
port's copy of the reference's ``testground_tpu/engine``
(``pkg/engine`` + ``pkg/task``)."""

from .task import (
    CreatedBy,
    DatedState,
    Outcome,
    State,
    Task,
    TaskType,
    new_task_id,
)
from .storage import TaskStorage
from .queue import QueueFullError, TaskQueue
from .engine import Engine, EngineConfig

__all__ = [
    "CreatedBy",
    "DatedState",
    "Engine",
    "EngineConfig",
    "Outcome",
    "QueueFullError",
    "State",
    "Task",
    "TaskQueue",
    "TaskStorage",
    "TaskType",
    "new_task_id",
]
