"""The engine: builder/runner registries, task queue, worker pool, and the
task APIs the daemon exposes — the port's copy of the reference's
``testground_tpu/engine/engine.py`` (``pkg/engine/engine.go``: registries,
storage/queue init, worker threads, queue/kill/logs) with the supervisor
loop in ``supervisor.py``.

``admission_findings`` and ``note_refused`` are the daemon's admission at
submit: the ``tg check`` rules engine (``sim/check.py``) before a run
takes a queue slot, and the ``task.refused`` event of a refusal.

The read side of the observability verbs: ``stream_rows`` (``GET
/stream``, ``tg watch``), ``diff_tasks`` (``GET /diff``, ``tg diff``),
and the fleet counters with ``fleet_payload`` (``GET /fleet``, ``tg top``)
and ``fleet_info`` (the counter snapshot that the ``/metrics`` exposition,
``metrics/prometheus.py``, renders as the ``tg_fleet_*`` family).

The fleet controller (``engine.py:348-535``): ``preempt`` (a running run
checkpoints at its next chunk boundary and requeues to resume from its
snapshot), priority eviction at queue time (``_maybe_evict_for``, policy
``controller.pick_eviction_victim``) and ``drain`` (stop claiming, preempt
the running runs, cancel the builds, wait for the workers to park), with
their counters in ``fleet_info`` and ``fleet_payload``.

Run packs (``engine/pack.py``, ``supervisor.process_task_pack``): the
fleet's pack counters (``fleet_note_pack``, ``fleet_note_solo``,
``fleet_pack_done``) feed ``fleet_info``'s ``pack`` block (the
``tg_fleet_pack_*`` families) and ``fleet_payload``'s running packs and
per-task ``pack_width``.
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
from .controller import pick_eviction_victim
from .events import EVENTS_FILE, EventJournal
from .stream import stream_task_rows
from .queue import TaskQueue
from .storage import TaskStorage
from .task import CreatedBy, DatedState, State, Task, TaskType, new_task_id

# the fleet's queue-wait and claim-latency histograms use the sync plane's
# log2 µs bins (sync/stats.py imports only the stdlib)
from ..sync.stats import TIME_BINS, time_bin

__all__ = ["Engine", "EngineConfig"]

# distinct solo reasons the fleet counts before folding the rest into
# "other" (a bounded label set for tg_fleet_pack_solo_total)
_FLEET_SOLO_REASONS_MAX = 32


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
        # per-task preemption signals: a preempted run checkpoints at its
        # next chunk boundary and requeues instead of archiving CANCELED
        self._preempts: dict[str, threading.Event] = {}
        # held by a worker from its queue pop to the journaled claim, and by
        # preempt() while it reads the task's state: a task it finds
        # PROCESSING has its task.claimed row written
        self._claim_lock = threading.Lock()
        # drain flag: workers stop claiming while it is set
        self._draining = threading.Event()

        self._stop = threading.Event()
        self._queue_kick = threading.Event()
        self._workers: list[threading.Thread] = []

        # the append-only daemon event journal (events.py) plus the
        # in-memory fleet counters behind GET /fleet: they cover the
        # daemon's lifetime, not the task store's
        self.events = EventJournal(
            os.path.join(self.env.dirs.daemon(), EVENTS_FILE)
        )
        self._fleet_lock = threading.Lock()
        self._worker_task: dict[int, str] = {}  # worker idx -> task id ("" idle)
        self._queue_wait_bins = [0] * TIME_BINS
        self._queue_wait_total_us = 0
        self._claim_latency_bins = [0] * TIME_BINS
        self._claim_latency_total_us = 0
        self._pack_packed_total = 0  # admissions that packed >= 2 runs
        self._pack_packed_runs_total = 0  # member runs admitted via packs
        self._pack_solo: dict[str, int] = {}  # solo_reason -> count
        self._running_packs: dict[str, int] = {}  # leader task id -> width
        self._fleet_refused = 0  # compositions refused at submit
        self._fleet_preemptions = 0  # preempted runs requeued
        self._fleet_evictions = 0  # preemptions caused by priority arrivals

    # ---------------------------------------------------------------- wiring

    @classmethod
    def new_default(cls, env: EnvConfig | None = None) -> "Engine":
        """The engine with the port's builders and runners registered
        (``engine.go:127-160`` NewDefaultEngine): ``exec:py``,
        ``exec:bin`` and ``sim:plan``; ``local:exec`` and ``sim:torch``."""
        from ..builders import ExecBinBuilder, ExecPyBuilder, SimPlanBuilder
        from ..runners.local_exec import LocalExecRunner
        from ..sim.runner import SimTorchRunner

        env = env or EnvConfig.load()
        return cls(
            EngineConfig(
                env=env,
                builders=[ExecPyBuilder(), ExecBinBuilder(), SimPlanBuilder()],
                runners=[LocalExecRunner(), SimTorchRunner()],
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
        # a leader engine drains its cohort's sim-workers on the way out:
        # through the leader child when one exists (sim/cohort.py), or
        # directly if a cohort was joined in this process
        # (isolate_cohort=False)
        try:
            from ..sim.cohort import shutdown_leader_child
            from ..sim.distributed import broadcast_shutdown_if_leader

            shutdown_leader_child()
            broadcast_shutdown_if_leader()
        except Exception as e:  # noqa: BLE001 — shutdown is best-effort
            S().warning("cohort shutdown broadcast failed: %s", e)

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
        # a high-priority run that finds no idle worker evicts the
        # lowest-value running task instead of queueing behind it
        if typ == TaskType.RUN and priority > 0:
            try:
                self._maybe_evict_for(tsk)
            except Exception as e:  # noqa: BLE001 — never fails the submit
                S().warning("eviction check failed for %s: %s", tsk.id, e)
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
        """Journal and count one composition refused at submit
        (``engine.py:484-494``)."""
        with self._fleet_lock:
            self._fleet_refused += 1
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

    # -------------------------------------------------- fleet controller

    def register_preempt(self, task_id: str) -> threading.Event:
        """Idempotent get-or-create of a task's preemption signal, as
        :meth:`register_cancel`: a ``preempt()`` landing between the queue
        pop and the claim finds the event the worker adopts."""
        with self._cancel_lock:
            ev = self._preempts.get(task_id)
            if ev is None:
                ev = threading.Event()
                self._preempts[task_id] = ev
        return ev

    def drop_preempt(self, task_id: str) -> None:
        with self._cancel_lock:
            self._preempts.pop(task_id, None)

    def preempt_requested(self, task_id: str) -> bool:
        with self._cancel_lock:
            ev = self._preempts.get(task_id)
        return ev is not None and ev.is_set()

    def preempt(self, task_id: str) -> dict:
        """Ask a running RUN task to checkpoint at its next chunk boundary,
        requeue and resume from its newest snapshot. Idempotent; a task
        still queued is a no-op success. Returns ``{"ok", "queued"}``, or
        ``{"ok": False, "error"}``. A task popped but not yet journaled
        as claimed is waited for, so ``task.preempt_requested`` always
        follows its ``task.claimed``."""
        with self._claim_lock:
            tsk = self.storage.get(task_id)
        if tsk is None:
            return {"ok": False, "error": f"unknown task {task_id}"}
        st = tsk.state().state
        if st == State.SCHEDULED:
            return {"ok": True, "queued": True}
        if st != State.PROCESSING:
            return {
                "ok": False,
                "error": (
                    f"task {task_id} is {st.value}; only running tasks "
                    "can be preempted"
                ),
            }
        if tsk.type != TaskType.RUN:
            return {
                "ok": False,
                "error": (
                    "build tasks are not preemptible (a build has no "
                    "carry to checkpoint — kill it instead)"
                ),
            }
        ev = self.register_preempt(task_id)
        first = not ev.is_set()
        ev.set()
        if first:
            self.events.emit("task.preempt_requested", task=task_id, trace=tsk.trace)
        return {"ok": True, "queued": False}

    def _maybe_evict_for(self, tsk: Task) -> None:
        """Priority preemption: when ``tsk`` (a RUN just queued with
        priority > 0) finds every worker busy, preempt the lowest-value
        running run (``controller.pick_eviction_victim``)."""
        with self._fleet_lock:
            busy = sum(1 for t in self._worker_task.values() if t)
            total = max(len(self._workers), len(self._worker_task))
        if total == 0 or busy < total:
            return  # an idle worker claims the arrival anyway
        candidates = []
        for cur in self.storage.processing():
            if cur.type != TaskType.RUN or cur.id == tsk.id:
                continue  # builds are not preemptible
            cfg = dict(self.env.runners.get(cur.runner) or {})
            cfg.update((cur.composition.get("global") or {}).get("run_config") or {})
            candidates.append({
                "id": cur.id,
                "priority": cur.priority,
                "started": cur.state().created,
                "checkpointed": int(cfg.get("checkpoint_chunks") or 0) > 0,
            })
        victim = pick_eviction_victim(candidates, tsk.priority)
        if victim is None:
            return
        if not self.preempt(victim["id"]).get("ok"):
            return
        with self._fleet_lock:
            self._fleet_evictions += 1
        vt = self.storage.get(victim["id"])
        self.events.emit(
            "task.evicted",
            task=victim["id"],
            trace=vt.trace if vt is not None else None,
            by=tsk.id,
            arriving_priority=tsk.priority,
            victim_priority=int(victim["priority"]),
            checkpointed=bool(victim["checkpointed"]),
        )
        S().info("evicted task %s (priority %d) for arrival %s (priority %d)",
                 victim["id"], victim["priority"], tsk.id, tsk.priority)

    def fleet_note_preemption(self) -> None:
        """Supervisor hook: one preempted run was requeued."""
        with self._fleet_lock:
            self._fleet_preemptions += 1

    def draining(self) -> bool:
        return self._draining.is_set()

    def drain(self, timeout_secs: float = 30.0) -> dict:
        """Graceful drain: stop claiming, preempt the running RUN tasks (a
        checkpointed one requeues to resume, the rest to rerun), cancel
        the running builds, then wait — bounded — until no task is claimed
        and every worker is parked. Idempotent; journals ``daemon.drain``."""
        already = self._draining.is_set()
        self._draining.set()
        self._queue_kick.set()
        preempted: list[str] = []
        canceled: list[str] = []
        seen: set[str] = set()

        def stop_claimed() -> bool:
            """Preempt or cancel every claimed task not yet seen; True
            while any is still claimed. A worker's pop stamps its task
            PROCESSING before the worker enters ``_worker_task`` (and a
            pack claims its members in between), so the store's current
            bucket, not the worker map, is the record of what is
            claimed; a pop that raced the drain flag shows up here too."""
            claimed = self.storage.processing()
            for tsk in claimed:
                if tsk.id in seen:
                    continue
                seen.add(tsk.id)
                if tsk.type == TaskType.RUN:
                    if self.preempt(tsk.id).get("ok"):
                        preempted.append(tsk.id)
                elif self.kill(tsk.id):
                    canceled.append(tsk.id)
            return bool(claimed)

        stop_claimed()
        deadline = time.monotonic() + max(0.0, timeout_secs)
        drained = False
        while True:
            with self._fleet_lock:
                busy = any(t for t in self._worker_task.values())
            if not stop_claimed() and not busy:
                drained = True
                break
            if time.monotonic() >= deadline:
                break
            time.sleep(0.05)
        self.events.emit("daemon.drain", preempted=preempted, canceled=canceled,
                         drained=drained, already_draining=already)
        S().info("drain: %d run(s) preempted, %d build(s) canceled, workers %s",
                 len(preempted), len(canceled),
                 "idle" if drained else "still busy at timeout")
        return {"drained": drained, "preempted": preempted, "canceled": canceled}

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
        completes (``engine.go:461-558``), then read the file to its end
        once more: the task's last lines may land between a read at the
        end of the file and the read of its state."""
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
                if not follow:
                    return
                if done:
                    yield from f
                    return
                if cancel is not None and cancel.is_set():
                    return
                time.sleep(0.1)

    def stream_rows(
        self,
        task_id: str,
        follow: bool = True,
        cancel: threading.Event | None = None,
        families=None,
        heartbeat_secs: float = 0.0,
    ) -> Iterator[dict]:
        """Stream a task's live observability rows (telemetry / perf /
        SLO breaches / run spans) from its run outputs dirs — the
        backend of the daemon's ``GET /stream`` and ``tg watch``
        (docs/OBSERVABILITY.md "Run health plane"). With ``follow``,
        tails across the queued→running→done lifecycle and closes after
        a final sweep once the task finishes; on an already-finished
        task it replays the full history, then closes (the ``logs``
        follow contract)."""
        tsk = self.get_task(task_id)
        if tsk is None:
            raise FileNotFoundError(f"unknown task {task_id}")

        def is_done() -> bool:
            t = self.get_task(task_id)
            return t is None or t.state().state in (
                State.COMPLETE,
                State.CANCELED,
            )

        yield from stream_task_rows(
            self.env.dirs.outputs(),
            tsk.plan,
            task_id,
            is_done,
            follow=follow,
            cancel=cancel,
            families=families,
            heartbeat_secs=heartbeat_secs,
        )

    def diff_tasks(self, a: str, b: str, planes=None) -> dict:
        """Differential run analysis (docs/OBSERVABILITY.md "Run diff"):
        load both tasks' journals + swept ``sim_perf.jsonl`` chunk rows
        and build the RunDiff document — deterministic counters compared
        exactly, throughput judged from the per-chunk samples
        (``analysis/diff.py``). Works on ARCHIVED tasks: everything read
        here (task store + run outputs) survives daemon restarts.

        Raises ``FileNotFoundError`` for an unknown task and
        ``ValueError`` for an unknown plane — the daemon route maps
        these to 404/400; backend of ``tg diff`` and ``Client.diff``.
        """
        from ..analysis.diff import (
            build_run_diff,
            task_snapshot,
            validate_planes,
        )

        planes = validate_planes(planes)
        snaps = []
        for tid in (a, b):
            tsk = self.get_task(tid)
            if tsk is None:
                raise FileNotFoundError(f"unknown task {tid}")
            try:
                rows = [
                    r
                    for r in self.stream_rows(
                        tid, follow=False, families=("perf",)
                    )
                    if isinstance(r, dict)
                ]
            except FileNotFoundError:
                rows = []
            snaps.append(task_snapshot(tsk.to_dict(), rows))
        return build_run_diff(snaps[0], snaps[1], planes=planes)

    # ----------------------------------------------------------------- fleet

    def fleet_worker_state(self, idx: int, task_id: str) -> None:
        """Supervisor hook: worker ``idx`` is now busy on ``task_id``
        ("" = idle). Feeds tg_fleet_workers and GET /fleet."""
        with self._fleet_lock:
            self._worker_task[idx] = task_id

    def fleet_note_claim(
        self, queue_wait_secs: float, claim_latency_secs: float
    ) -> None:
        """Supervisor hook: one task left the queue. Records log2
        histograms of how long it waited (scheduled → PROCESSING) and
        how long the claim itself took (PROCESSING stamp → worker
        dispatch, i.e. pack admission + prep overhead)."""
        wait_us = max(0.0, queue_wait_secs) * 1e6
        claim_us = max(0.0, claim_latency_secs) * 1e6
        with self._fleet_lock:
            self._queue_wait_bins[time_bin(wait_us)] += 1
            self._queue_wait_total_us += int(wait_us)
            self._claim_latency_bins[time_bin(claim_us)] += 1
            self._claim_latency_total_us += int(claim_us)

    def fleet_note_pack(self, leader_id: str, width: int) -> None:
        """Supervisor hook: a pack claim admitted ``width`` runs."""
        with self._fleet_lock:
            self._pack_packed_total += 1
            self._pack_packed_runs_total += width
            self._running_packs[leader_id] = width

    def fleet_note_solo(self, reason: str) -> None:
        """Supervisor hook: a pack-eligible run went solo; count by
        reason (bounded label set)."""
        reason = reason or "none"
        with self._fleet_lock:
            if (
                reason not in self._pack_solo
                and len(self._pack_solo) >= _FLEET_SOLO_REASONS_MAX
            ):
                reason = "other"
            self._pack_solo[reason] = self._pack_solo.get(reason, 0) + 1

    def fleet_pack_done(self, leader_id: str) -> None:
        with self._fleet_lock:
            self._running_packs.pop(leader_id, None)

    def fleet_info(self) -> dict:
        """Counter snapshot for the Prometheus ``tg_fleet_*`` family
        (metrics/prometheus.py renders it; task-store gauges are
        computed there from the FULL task list)."""
        with self._fleet_lock:
            busy = sum(1 for t in self._worker_task.values() if t)
            total = max(len(self._workers), len(self._worker_task))
            return {
                "workers": {"total": total, "busy": busy},
                "queue_wait_bins": list(self._queue_wait_bins),
                "queue_wait_total_us": self._queue_wait_total_us,
                "claim_latency_bins": list(self._claim_latency_bins),
                "claim_latency_total_us": self._claim_latency_total_us,
                "pack": {
                    "packed": self._pack_packed_total,
                    "packed_runs": self._pack_packed_runs_total,
                    "solo": dict(self._pack_solo),
                },
                "preemptions": self._fleet_preemptions,
                "evictions": self._fleet_evictions,
                "refused": self._fleet_refused,
                "draining": self._draining.is_set(),
            }

    @staticmethod
    def _tail_last_row(path: str, tail_bytes: int = 8192) -> dict:
        """Last parseable JSON line of a jsonl file, reading only the
        tail — bounded no matter how long a run has been ticking."""
        try:
            with open(path, "rb") as f:
                f.seek(0, os.SEEK_END)
                size = f.tell()
                f.seek(max(0, size - tail_bytes))
                chunk = f.read().decode("utf-8", "replace")
        except OSError:
            return {}
        import json as _json

        for line in reversed(chunk.splitlines()):
            line = line.strip()
            if not line:
                continue
            try:
                row = _json.loads(line)
            except ValueError:
                continue
            if isinstance(row, dict):
                return row
        return {}

    @staticmethod
    def _count_lines_bounded(path: str, max_bytes: int = 256 << 10) -> int:
        """Line count of a jsonl file, reading at most ``max_bytes``
        from the head — exact for every sane breach stream, a floor for
        a pathological one (the fleet view needs "how bad", not an
        audit-grade total)."""
        try:
            with open(path, "rb") as f:
                return f.read(max_bytes).count(b"\n")
        except OSError:
            return 0

    def fleet_payload(self) -> dict:
        """The ``GET /fleet`` summary: worker slots, queue depth, pack
        occupancy, and one row per queued/running task with live
        ticks/s (sim_perf.jsonl tail) and SLO breach counts. Counts
        cover the FULL task store; the per-task list is naturally
        bounded by what is actually queued or running."""
        now = time.time()
        all_tasks = self.storage.filter()
        counts: dict[str, int] = {}
        by_priority: dict[int, int] = {}
        rows: list[dict] = []
        outputs = self.env.dirs.outputs()
        with self._fleet_lock:
            worker_task = dict(self._worker_task)
            running_packs = dict(self._running_packs)
            n_workers = max(len(self._workers), len(self._worker_task))
        for tsk in all_tasks:
            st = tsk.state().state
            counts[st.value] = counts.get(st.value, 0) + 1
            if st == State.SCHEDULED:
                by_priority[tsk.priority] = by_priority.get(tsk.priority, 0) + 1
            if st not in (State.SCHEDULED, State.PROCESSING):
                continue
            row = {
                "id": tsk.id,
                "name": tsk.name(),
                "type": tsk.type.value,
                "state": st.value,
                "priority": tsk.priority,
                "queued_secs": round(tsk.queued_secs(), 3),
                "trace_id": tsk.trace.get("trace_id", ""),
                # how many times the fleet controller migrated this
                # task (rides Task.trace)
                "preemptions": int(tsk.trace.get("preemptions", 0) or 0),
            }
            if st == State.PROCESSING:
                row["running_secs"] = round(
                    max(0.0, now - tsk.state().created), 3
                )
                row["pack_width"] = running_packs.get(tsk.id, 0)
                run_dir = os.path.join(outputs, tsk.plan, tsk.id)
                perf = self._tail_last_row(
                    os.path.join(run_dir, "sim_perf.jsonl")
                )
                if perf:
                    row["ticks_per_sec"] = perf.get("ticks_per_sec", 0)
                row["breaches"] = self._count_lines_bounded(
                    os.path.join(run_dir, "sim_slo.jsonl")
                )
            rows.append(row)
        rows.sort(key=lambda r: (r["state"], -r["priority"], r["id"]))
        busy = sum(1 for t in worker_task.values() if t)
        return {
            "ts_wall_ns": time.time_ns(),
            "workers": {
                "total": n_workers,
                "busy": busy,
                "idle": max(0, n_workers - busy),
            },
            "draining": self._draining.is_set(),
            "queue": {
                "depth": counts.get(State.SCHEDULED.value, 0),
                "by_priority": {str(k): v for k, v in by_priority.items()},
            },
            "counts": counts,
            "tasks_total": len(all_tasks),
            "pack": {"running": running_packs},
            "tasks": rows,
        }

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
