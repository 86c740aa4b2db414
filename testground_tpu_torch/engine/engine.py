"""The engine: builder/runner registries, task queue, worker pool, and the
task APIs the daemon exposes — the port's copy of the reference's
``testground_tpu/engine/engine.py`` (``pkg/engine/engine.go``: registries,
storage/queue init, worker threads, queue/kill/logs) with the supervisor
loop in ``supervisor.py``.

``admission_findings`` and ``note_refused`` are the daemon's admission at
submit: the ``tg check`` rules engine (``sim/check.py``) before a run
takes a queue slot, and the ``task.refused`` event of a refusal.

Left out, with the ROADMAP queue 1 item that ports each: the fleet
counters (``_fleet_refused`` among them), ``fleet_payload``,
``diff_tasks`` and ``stream_rows`` (item 9f), preemption, eviction and
``drain`` (item 13: a preempted run resumes from a checkpoint) and run
packs (item 13).
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Iterator

from ..api import Composition, TestPlanManifest, validate_for_run
from ..config import EnvConfig
from ..logging_ import S
from ..tracectx import TraceContext, new_span_id, new_trace_id
from .events import EVENTS_FILE, EventJournal
from .queue import TaskQueue
from .storage import TaskStorage
from .task import CreatedBy, DatedState, State, Task, TaskType, new_task_id

__all__ = ["Engine", "EngineConfig"]


@dataclass
class EngineConfig:
    """(``pkg/engine/engine.go:65-77`` EngineConfig)."""

    env: EnvConfig
    builders: list = field(default_factory=list)
    runners: list = field(default_factory=list)


class Engine:
    """Singleton scheduler (``engine.go:41-63``)."""

    def __init__(self, cfg: EngineConfig):
        self.env = cfg.env
        self._builders = {b.id(): b for b in cfg.builders}
        self._runners = {r.id(): r for r in cfg.runners}

        sch = self.env.daemon.scheduler
        if sch.task_repo_type == "disk":
            db_path = os.path.join(self.env.dirs.home, "tasks.db")
        else:
            db_path = ":memory:"
        self.storage = TaskStorage(db_path)
        self.queue = TaskQueue(self.storage, sch.queue_size)

        # per-task cancel signals (``engine.go:59-62``)
        self._cancel_lock = threading.Lock()
        self._cancels: dict[str, threading.Event] = {}

        self._stop = threading.Event()
        self._queue_kick = threading.Event()
        self._workers: list[threading.Thread] = []

        # the append-only daemon event journal (events.py)
        self.events = EventJournal(
            os.path.join(self.env.dirs.daemon(), EVENTS_FILE)
        )

    # ---------------------------------------------------------------- wiring

    @classmethod
    def new_default(cls, env: EnvConfig | None = None) -> "Engine":
        """The engine with the port's builder and runner registered
        (``engine.go:127-160`` NewDefaultEngine): ``sim:plan`` and
        ``sim:torch``."""
        from ..builders import SimPlanBuilder
        from ..sim.runner import SimTorchRunner

        env = env or EnvConfig.load()
        return cls(
            EngineConfig(
                env=env,
                builders=[SimPlanBuilder()],
                runners=[SimTorchRunner()],
            )
        )

    def start_workers(self) -> None:
        """(``engine.go:120-122``)."""
        from .supervisor import worker

        n = self.env.daemon.scheduler.workers
        for i in range(n):
            t = threading.Thread(
                target=worker, args=(self, i), daemon=True, name=f"tg-worker-{i}"
            )
            t.start()
            self._workers.append(t)

    def stop(self) -> None:
        self._stop.set()
        self._queue_kick.set()
        for t in self._workers:
            t.join(timeout=5)

    # ------------------------------------------------------------- registries

    def builder_by_name(self, name: str):
        return self._builders.get(name)

    def runner_by_name(self, name: str):
        return self._runners.get(name)

    def list_builders(self) -> list[str]:
        return sorted(self._builders)

    def list_runners(self) -> list[str]:
        return sorted(self._runners)

    # -------------------------------------------------------------- queueing

    def _check_run_compat(self, comp: Composition, manifest: TestPlanManifest):
        """Runner exists + every group's builder is compatible with it
        (``engine.go:216-219``)."""
        runner = self.runner_by_name(comp.global_.runner)
        if runner is None:
            raise ValueError(f"unknown runner: {comp.global_.runner}")
        compatible = set(runner.compatible_builders())
        for b in comp.list_builders():
            if b and b not in compatible:
                raise ValueError(
                    f"builder {b} is incompatible with runner "
                    f"{comp.global_.runner} (compatible: {sorted(compatible)})"
                )

    def queue_run(
        self,
        comp: Composition,
        manifest: TestPlanManifest,
        sources_dir: str = "",
        priority: int = 0,
        created_by: CreatedBy | None = None,
        trace_parent: str = "",
    ) -> str:
        """Queue a run task (``engine.go:203-249`` QueueRun)."""
        validate_for_run(comp)
        self._check_run_compat(comp, manifest)
        return self._queue_task(
            TaskType.RUN,
            comp,
            manifest,
            sources_dir,
            priority,
            created_by,
            trace_parent,
        )

    def queue_build(
        self,
        comp: Composition,
        manifest: TestPlanManifest,
        sources_dir: str = "",
        priority: int = 0,
        created_by: CreatedBy | None = None,
        trace_parent: str = "",
    ) -> str:
        """Queue a build task (``engine.go:162-201`` QueueBuild)."""
        return self._queue_task(
            TaskType.BUILD,
            comp,
            manifest,
            sources_dir,
            priority,
            created_by,
            trace_parent,
        )

    def _queue_task(
        self,
        typ: TaskType,
        comp: Composition,
        manifest: TestPlanManifest,
        sources_dir: str,
        priority: int,
        created_by: CreatedBy | None,
        trace_parent: str = "",
    ) -> str:
        # Lifecycle trace ids (tracectx.py): adopt the submitter's
        # traceparent when one arrived (its span becomes the task's
        # root "submit" span), else mint a fresh trace here — every
        # task has a complete id set from birth so the archive-time
        # span tree always connects.
        ctx = TraceContext.from_traceparent(trace_parent)
        if ctx is not None:
            trace = {"trace_id": ctx.trace_id, "root_span_id": ctx.span_id}
        else:
            trace = {"trace_id": new_trace_id(), "root_span_id": new_span_id()}
        trace["queued_span_id"] = new_span_id()
        tsk = Task(
            id=new_task_id(),
            type=typ,
            priority=priority,
            plan=comp.global_.plan,
            case=comp.global_.case,
            runner=comp.global_.runner,
            composition=comp.to_dict(),
            input={
                "manifest": manifest.to_dict(),
                "sources_dir": sources_dir,
            },
            states=[DatedState(state=State.SCHEDULED, created=time.time())],
            created_by=created_by or CreatedBy(),
            trace=trace,
        )
        if tsk.created_by_ci():
            self.queue.push_unique_by_branch(tsk)
        else:
            self.queue.push(tsk)
        self._queue_kick.set()
        self.events.emit(
            "task.scheduled",
            task=tsk.id,
            trace=tsk.trace,
            state=State.SCHEDULED.value,
            task_type=typ.value,
            plan=tsk.plan,
            case=tsk.case,
            priority=priority,
        )
        S().info("queued task %s (%s)", tsk.id, tsk.name())
        return tsk.id

    # ------------------------------------------------------------ cancel/kill

    def admission_findings(
        self, comp: Composition, manifest: TestPlanManifest
    ) -> list:
        """Server-side ``tg check``: the error-severity findings of the
        rules engine (``sim/check.py``) against a composition; the daemon
        refuses the submit when any fires, with the rule ids ``tg check``
        reports (``engine.py:471-482``)."""
        from ..sim.check import check_composition

        findings = check_composition(
            comp, manifest,
            env_layer=self.env.runners.get(comp.global_.runner) or {},
        )
        return [f for f in findings if f.severity == "error"]

    def note_refused(
        self, comp: Composition, rules: list[str], kind: str = "run"
    ) -> None:
        """Journal one composition refused at submit (``engine.py:484-494``;
        its fleet counter waits for item 9f)."""
        self.events.emit(
            "task.refused",
            task_type=kind,
            plan=comp.global_.plan,
            case=comp.global_.case,
            rules=list(rules),
        )

    def register_cancel(self, task_id: str) -> threading.Event:
        # idempotent: the worker registers at claim time (before the
        # claim bookkeeping) so kill() never races the pop→process
        # window; the later process_task call must return the SAME
        # event or an operator cancel landing in between would be lost
        with self._cancel_lock:
            ev = self._cancels.get(task_id)
            if ev is None:
                ev = threading.Event()
                self._cancels[task_id] = ev
        return ev

    def drop_cancel(self, task_id: str) -> None:
        with self._cancel_lock:
            self._cancels.pop(task_id, None)

    def kill(self, task_id: str) -> bool:
        """Cancel a queued or running task (``engine.go:419-427`` Kill)."""
        if self.queue.cancel_queued(task_id):
            S().info("canceled queued task %s", task_id)
            tsk = self.storage.get(task_id)
            trace = tsk.trace if tsk is not None else None
            self.events.emit(
                "task.cancel_requested", task=task_id, trace=trace, queued=True
            )
            # a queued cancel IS the terminal transition — no worker
            # will ever touch this task, so journal it here
            self.events.emit(
                "task.canceled",
                task=task_id,
                trace=trace,
                state=State.CANCELED.value,
                by="operator",
            )
            return True
        with self._cancel_lock:
            ev = self._cancels.get(task_id)
        if ev is not None:
            ev.set()
            tsk = self.storage.get(task_id)
            self.events.emit(
                "task.cancel_requested",
                task=task_id,
                trace=tsk.trace if tsk is not None else None,
                queued=False,
            )
            return True
        return False

    def delete_task(self, task_id: str) -> bool:
        """Delete a FINISHED task's record + log file (the daemon's GET
        ``/delete`` surface, ``pkg/daemon/daemon.go:88``). Live tasks must
        be killed first — deleting a record out from under a worker would
        orphan its cancel channel."""
        tsk = self.storage.get(task_id)
        if tsk is None:
            return False
        if tsk.state().state not in (State.COMPLETE, State.CANCELED):
            raise ValueError(
                f"task {task_id} is {tsk.state().state.value}; kill it "
                "before deleting"
            )
        deleted = self.storage.delete(task_id)
        try:
            os.unlink(self.task_log_path(task_id))
        except FileNotFoundError:
            pass
        return deleted

    # ------------------------------------------------------------------ info

    def get_task(self, task_id: str) -> Task | None:
        return self.storage.get(task_id)

    def tasks(self, **filters: Any) -> list[Task]:
        return self.storage.filter(**filters)

    def task_log_path(self, task_id: str) -> str:
        """Per-task output file (``engine.go:461-558`` Logs tails
        ``<daemon-dir>/<task-id>.out``)."""
        return os.path.join(self.env.dirs.daemon(), f"{task_id}.out")

    def logs(
        self, task_id: str, follow: bool = False, cancel: threading.Event | None = None
    ) -> Iterator[str]:
        """Stream a task's log file; with ``follow``, tail until the task
        completes (``engine.go:461-558``)."""
        path = self.task_log_path(task_id)
        # wait for the file to appear if the task is still queued
        while not os.path.exists(path):
            tsk = self.get_task(task_id)
            if tsk is None:
                raise FileNotFoundError(f"unknown task {task_id}")
            if not follow or tsk.state().state in (State.COMPLETE, State.CANCELED):
                return
            if cancel is not None and cancel.is_set():
                return
            time.sleep(0.1)
        with open(path, "r") as f:
            while True:
                line = f.readline()
                if line:
                    yield line
                    continue
                tsk = self.get_task(task_id)
                done = tsk is None or tsk.state().state in (
                    State.COMPLETE,
                    State.CANCELED,
                )
                if not follow or done:
                    return
                if cancel is not None and cancel.is_set():
                    return
                time.sleep(0.1)

    # -------------------------------------------------------------- actions

    def do_collect_outputs(self, runner_id: str, run_id: str, w, ow) -> None:
        """(``engine.go:251-`` DoCollectOutputs)."""
        from ..api import CollectionInput

        runner = self.runner_by_name(runner_id)
        if runner is None:
            raise ValueError(f"unknown runner: {runner_id}")
        runner.collect_outputs(
            CollectionInput(run_id=run_id, runner_id=runner_id, env=self.env), w, ow
        )

    def do_terminate(self, ref: str, ow, ctype: str = "runner") -> None:
        """Terminate all jobs of a runner OR a builder (the reference's
        DoTerminate takes a component type, ``engine.go:285-311``)."""
        from ..runners.base import Terminatable

        if ctype == "runner":
            component = self.runner_by_name(ref)
        elif ctype == "builder":
            component = self.builder_by_name(ref)
        else:
            raise ValueError(f"unknown component type: {ctype}")
        if component is None:
            raise ValueError(f"unknown component: {ref} (type: {ctype})")
        if not isinstance(component, Terminatable):
            raise ValueError(f"{ctype} {ref} is not terminatable")
        component.terminate_all(ow)
        ow.infof("all jobs terminated on component: %s", ref)

    def do_healthcheck(self, runner_id: str, fix: bool, ow):
        from ..runners.base import HealthcheckedRunner

        runner = self.runner_by_name(runner_id)
        if runner is None:
            raise ValueError(f"unknown runner: {runner_id}")
        if not isinstance(runner, HealthcheckedRunner):
            raise ValueError(f"runner {runner_id} does not support healthchecks")
        return runner.healthcheck(fix, ow, env=self.env)

    def do_build_purge(self, builder_id: str, testplan: str, ow) -> None:
        builder = self.builder_by_name(builder_id)
        if builder is None:
            raise ValueError(f"unknown builder: {builder_id}")
        builder.purge(testplan, ow, env=self.env)
