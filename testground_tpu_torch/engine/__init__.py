"""The port's in-process engine: task types and the supervisor's build and
run lowering (copies of the reference's ``testground_tpu/engine``
definitions). The task queue, the store and the daemon come with ROADMAP
queue 1 item 9e."""

from .task import DatedState, Outcome, State, Task, TaskType, new_task_id

__all__ = ["DatedState", "Outcome", "State", "Task", "TaskType", "new_task_id"]
