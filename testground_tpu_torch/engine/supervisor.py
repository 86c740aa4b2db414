"""The worker loop: pops tasks off the queue and executes builds and runs —
the port's copy of the reference's ``testground_tpu/engine/supervisor.py``
(``pkg/engine/supervisor.go``): state transitions are persisted at each
step, builds are deduplicated by ``Group.build_key()``, config coalesces
with precedence composition > .env.toml > manifest, runs are dispatched to
the runner, and the result is archived.

A worker is a host thread, and the CUDA current device is per host thread:
``do_run`` makes the run's device current for its healthcheck and its runs
(``sim.engine.device_context``), so a preempted run requeued and claimed
by another worker thread launches on its card there too.

A preempted run (``engine.controller.TaskPreemptedError``) is requeued by
``_requeue_preempted`` pointing at its own snapshots; a draining engine's
workers stop claiming.

Run packs (``engine/pack.py``, ``sim/pack.py``): a popped task that opted
into packing claims every queued compatible run (``claim_pack``), and the
pack runs as one program on the card (``process_task_pack``). Each member
keeps its own log, cancel event, timer, result and archive; a member whose
preparation or collection fails fails alone, and a pack that shrinks below
two members runs its survivor solo. A preempted or evicted member stops at
the next chunk boundary and is requeued to rerun from scratch (a pack
writes no snapshots).

Left out: the build task's precompile, which fills the reference's XLA
compile cache (the port has no such cache; ``build --buckets`` warms the
bucket ladder and the pack widths on the run's device instead).
"""

from __future__ import annotations

import concurrent.futures
import threading
import time
import traceback

from ..api import (
    BuildInput,
    Composition,
    RunGroup,
    RunInput,
    TestPlanManifest,
    prepare_for_build,
    prepare_for_run,
    validate_for_build,
    validate_for_run,
)
from ..config import CoalescedConfig
from ..logging_ import S
from ..rpc import OutputWriter
from ..sim.engine import device_context
from ..sim.slo import SloBreachError
from ..tracectx import new_span_id, new_trace_id
from .controller import TaskPreemptedError
from .engine import Engine
from .notify import notify_task_finished, notify_task_started
from .pack import _truthy
from .queue import QueueEmptyError
from .task import DatedState, Outcome, State, Task, TaskType
from .tracetree import export_task_trace

__all__ = [
    "do_build",
    "do_build_task",
    "do_run",
    "process_task",
    "process_task_pack",
    "worker",
]

DEFAULT_TASK_TIMEOUT_SECS = 10 * 60  # supervisor.go:49-52


def worker(engine: Engine, idx: int) -> None:
    """One worker loop (``supervisor.go:47-190``). A popped task that opted
    into run packing (``--run-cfg pack=true``) also claims every queued
    compatible run; the whole pack then runs as one program
    (``engine/pack.py``, ``sim/pack.py``)."""
    from .pack import claim_pack

    S().debug("supervisor worker %d started", idx)
    while not engine._stop.is_set():
        # a draining engine stops claiming: queued and requeued tasks stay
        # parked for a restarted daemon to rehydrate
        if engine._draining.is_set():
            engine._queue_kick.wait(timeout=0.2)
            engine._queue_kick.clear()
            continue
        # the pop stamps PROCESSING before the claim is journaled; holding
        # the claim lock until it is makes the two one step for preempt(),
        # so a preemption can never journal ahead of task.claimed
        with engine._claim_lock:
            try:
                tsk = engine.queue.pop()
            except QueueEmptyError:
                tsk = None
            if tsk is not None:
                pack = claim_pack(engine, tsk)
                # close the kill()/preempt() race before any claim
                # bookkeeping: the tasks are already stamped PROCESSING
                # (queue.pop, claim_matching), so an operator cancel or a
                # preemption arriving now must find a registered event
                for member in pack:
                    engine.register_cancel(member.id)
                    engine.register_preempt(member.id)
                _note_claim(engine, idx, pack)
        if tsk is None:
            engine._queue_kick.wait(timeout=0.2)
            engine._queue_kick.clear()
            continue
        engine.fleet_worker_state(idx, tsk.id)
        try:
            if len(pack) > 1:
                process_task_pack(engine, pack)
            else:
                process_task(engine, tsk)
        finally:
            engine.fleet_worker_state(idx, "")
            if len(pack) > 1:
                engine.fleet_pack_done(tsk.id)


def _note_claim(engine: Engine, idx: int, pack: list[Task]) -> None:
    """Claim bookkeeping for a freshly-popped task (or pack): mint the
    claim and execute span ids — the pack-claim span is minted once and
    shared by every member, so each member's tree hangs off the same
    span — feed the fleet claim histograms, and journal the claims. Tasks
    pushed straight into the queue (tests) get trace ids filled in here
    so every archive still exports a connected tree."""
    now = time.time()
    claim_sid = new_span_id()
    leader = pack[0]
    for tsk in pack:
        tr = tsk.trace
        tr.setdefault("trace_id", new_trace_id())
        tr.setdefault("root_span_id", new_span_id())
        tr.setdefault("queued_span_id", new_span_id())
        if tr.get("claim_span_id") and tr.get("execute_span_id"):
            # a re-claim (preemption requeue or restart rehydration): keep
            # the prior attempt's ids so the executor spans it parented
            # still resolve in the archived tree (bounded)
            prior = tr.setdefault("prior_attempts", [])
            prior.append(
                {"claim": tr["claim_span_id"], "execute": tr["execute_span_id"]}
            )
            del prior[:-16]
        tr["claim_span_id"] = claim_sid
        tr["execute_span_id"] = new_span_id()
        if len(pack) > 1:
            tr["pack_leader"] = leader.id
            tr["pack_width"] = len(pack)
        queue_wait = (
            max(0.0, tsk.states[-1].created - tsk.states[0].created)
            if len(tsk.states) >= 2
            else 0.0
        )
        claim_latency = max(0.0, now - tsk.states[-1].created) if tsk.states else 0.0
        engine.fleet_note_claim(queue_wait, claim_latency)
        engine.events.emit(
            "task.claimed",
            task=tsk.id,
            trace=tr,
            state=State.PROCESSING.value,
            worker=idx,
            queue_wait_secs=round(queue_wait, 6),
            pack_width=len(pack),
        )
    if len(pack) > 1:
        engine.fleet_note_pack(leader.id, len(pack))
        engine.events.emit(
            "pack.admitted",
            task=leader.id,
            trace=leader.trace,
            width=len(pack),
            members=[t.id for t in pack],
        )


def _run_trace_ctx(tsk: Task) -> dict:
    """The RunInput.trace_ctx the executor carries: the task's trace with
    the execute span as parent, plus the ready-made traceparent."""
    tr = tsk.trace or {}
    trace_id = tr.get("trace_id", "")
    if not trace_id:
        return {}
    parent = (
        tr.get("execute_span_id")
        or tr.get("claim_span_id")
        or tr.get("root_span_id", "")
    )
    return {
        "trace_id": trace_id,
        "parent_id": parent,
        "task_id": tsk.id,
        "traceparent": f"00-{trace_id}-{parent}-01",
    }


def _post_run_events(engine: Engine, tsk: Task) -> None:
    """Journal the run-derived control-plane events an archived result
    reveals: checkpoint/resume activity and sync-service evictions.
    Best-effort — a malformed result journal must not fail the task."""
    try:
        result = tsk.result if isinstance(tsk.result, dict) else {}
        journal = result.get("journal")
        if not isinstance(journal, dict):
            return
        sim = journal.get("sim")
        if isinstance(sim, dict) and isinstance(sim.get("checkpoint"), dict):
            ck = sim["checkpoint"]
            if ck.get("count"):
                engine.events.emit(
                    "task.checkpoint",
                    task=tsk.id,
                    trace=tsk.trace,
                    count=int(ck.get("count", 0)),
                    last_tick=int(ck.get("last_tick", 0) or 0),
                )
            if ck.get("resumed"):
                engine.events.emit(
                    "task.resumed",
                    task=tsk.id,
                    trace=tsk.trace,
                    resumed=ck["resumed"],
                )
                fb = (
                    ck["resumed"].get("fallback")
                    if isinstance(ck["resumed"], dict)
                    else None
                )
                if isinstance(fb, dict):
                    engine.events.emit(
                        "task.resume_fallback",
                        task=tsk.id,
                        trace=tsk.trace,
                        skipped=list(fb.get("skipped", [])),
                        error=str(fb.get("error", ""))[:200],
                    )
        sync = journal.get("sync")
        if isinstance(sync, dict) and sync.get("evicted"):
            engine.events.emit(
                "task.sync_evicted",
                task=tsk.id,
                trace=tsk.trace,
                count=int(sync["evicted"]),
            )
    except (TypeError, ValueError):
        pass


def _finish_task(engine: Engine, tsk: Task) -> None:
    """The archive-time tail: journal the terminal transition plus
    run-derived events, then export the task's span tree
    (task_spans.jsonl + task_trace.json)."""
    _post_run_events(engine, tsk)
    engine.events.emit(
        "task.finished",
        task=tsk.id,
        trace=tsk.trace,
        state=tsk.states[-1].state.value,
        outcome=tsk.outcome().value,
        error=tsk.error[:200] if tsk.error else "",
    )
    export_task_trace(engine.env.dirs.outputs(), tsk)


def _requeue_preempted(engine: Engine, tsk: Task, e: TaskPreemptedError) -> None:
    """A live migration's requeue (``supervisor.py:245-291``): the task
    goes back on the queue pointing at its own newest snapshot, with no
    terminal state, archive or webhook. A preemption without a snapshot
    leaves the composition as it was, and the rerun from tick 0 is
    bit-equal by determinism."""
    if e.resumable:
        glob = tsk.composition.setdefault("global", {})
        rc = glob.setdefault("run_config", {})
        # its own snapshots are newer even if this run resumed another's
        rc["resume_from"] = tsk.id
    tsk.trace["preemptions"] = int(tsk.trace.get("preemptions", 0) or 0) + 1
    tsk.error = ""
    tsk.result = None
    tsk.states.append(DatedState(state=State.SCHEDULED, created=time.time()))
    engine.queue.requeue(tsk)
    engine.fleet_note_preemption()
    engine.events.emit(
        "task.preempted",
        task=tsk.id,
        trace=tsk.trace,
        tick=e.tick,
        snapshot_tick=e.snapshot_tick,
        snapshots=e.snapshots,
        resumable=e.resumable,
        preemptions=int(tsk.trace["preemptions"]),
    )
    engine.events.emit(
        "task.migrated",
        task=tsk.id,
        trace=tsk.trace,
        resume_from=tsk.id if e.resumable else "",
        from_tick=e.snapshot_tick if e.resumable else 0,
    )
    engine._queue_kick.set()
    S().info("task %s preempted at tick %d (%s) — requeued", tsk.id, e.tick,
             f"resume from tick {e.snapshot_tick}" if e.resumable else "rerun")


def process_task(engine: Engine, tsk: Task) -> None:
    """Execute one task end-to-end, with timeout and cancellation
    (``supervisor.go:192-291``)."""
    timeout = engine.env.daemon.scheduler.task_timeout_min * 60 or (
        DEFAULT_TASK_TIMEOUT_SECS
    )
    cancel = engine.register_cancel(tsk.id)
    timer = threading.Timer(timeout, cancel.set)
    timer.daemon = True
    timer.start()

    log_path = engine.task_log_path(tsk.id)
    preempted: TaskPreemptedError | None = None
    try:
        with open(log_path, "w") as log_file:
            ow = OutputWriter(sink=log_file)
            try:
                engine.storage.update_current(tsk)
                # pending commit status for CI tasks (supervisor.go:213-215)
                notify_task_started(engine.env, tsk)
                engine.events.emit(
                    "task.started",
                    task=tsk.id,
                    trace=tsk.trace,
                    state=State.PROCESSING.value,
                    task_type=tsk.type.value,
                )
                if tsk.type == TaskType.RUN:
                    result = do_run(engine, tsk, ow, cancel)
                elif tsk.type == TaskType.BUILD:
                    result = do_build_task(engine, tsk, ow, cancel)
                else:
                    raise ValueError(f"unsupported task type {tsk.type}")
                tsk.result = result
            except TaskPreemptedError as e:
                # no failure: the run stopped at a chunk boundary, and the
                # finally branch requeues it
                preempted = e
                ow.infof("%s", e)
            except Exception as e:  # noqa: BLE001 — task errors become results
                S().error("task %s failed: %s", tsk.id, e)
                ow.write_error(str(e))
                tsk.error = str(e)
                tsk.result = {
                    "outcome": (
                        Outcome.CANCELED.value
                        if cancel.is_set()
                        else Outcome.FAILURE.value
                    )
                }
                S().debug("%s", traceback.format_exc())
            else:
                ow.write_result(tsk.result)
    finally:
        timer.cancel()
        engine.drop_cancel(tsk.id)
        engine.drop_preempt(tsk.id)
        if preempted is not None:
            _requeue_preempted(engine, tsk, preempted)
        else:
            final = State.CANCELED if cancel.is_set() and tsk.error else State.COMPLETE
            tsk.states.append(DatedState(state=final, created=time.time()))
            # journal + span-tree export BEFORE the archive makes the
            # terminal state visible: a client polling for COMPLETE must
            # find task_spans.jsonl already on disk
            _finish_task(engine, tsk)
            engine.storage.archive(tsk)
            # status webhooks: log-and-continue, never affect the task
            # (supervisor.go:176-183)
            notify_task_finished(engine.env, tsk)
            S().info("task %s finished: %s", tsk.id, tsk.outcome().value)


def _prepare_pack_run_input(
    engine: Engine, tsk: Task, ow: OutputWriter, cancel: threading.Event
) -> RunInput:
    """The head of :func:`do_run` for a single-[[runs]] pack member
    (``supervisor.py:371-444``): build missing artifacts (BuildKey-deduped,
    so the members of one pack build once), prepare + validate, coalesce
    the runner config, and assemble the RunInput. Raises on any refusal —
    the member then fails alone and the pack continues without it."""
    comp = Composition.from_dict(tsk.composition)
    manifest = TestPlanManifest.from_dict(tsk.input["manifest"])
    sources_dir = tsk.input.get("sources_dir", "")
    runner_id = comp.global_.runner
    if engine.env.runner_is_disabled(runner_id):
        raise ValueError(f"runner {runner_id} is disabled in .env.toml")
    if any(not g.run.artifact for g in comp.groups):
        comp = do_build(engine, comp, manifest, sources_dir, tsk.id, ow, cancel)
        tsk.composition = comp.to_dict()
        engine.storage.update_current(tsk)
    comp = prepare_for_run(comp, manifest)
    validate_for_run(comp)
    coalesced = CoalescedConfig().append(engine.env.runners.get(runner_id)).append(
        comp.global_.run_config
    )
    runner = engine.runner_by_name(runner_id)
    cfg_type = runner.config_type()
    runner_cfg = (
        coalesced.coalesce_into(cfg_type)
        if cfg_type is not None
        else coalesced.flatten()
    )
    run = comp.runs[0]
    artifacts = {g.id: g.run.artifact for g in comp.groups}
    groups = []
    for rg in run.groups:
        backing = comp.get_group(rg.effective_group_id())
        groups.append(
            RunGroup(
                id=rg.id,
                instances=rg.calculated_instance_count,
                artifact_path=artifacts[backing.id],
                builder=backing.builder or comp.global_.builder,
                parameters=dict(rg.test_params),
                profiles=dict(rg.profiles),
                resources=rg.resources,
                slo=[dict(x) for x in rg.slo],
            )
        )
    grun = comp.global_.run
    return RunInput(
        run_id=tsk.id,
        test_plan=comp.global_.plan,
        test_case=comp.global_.case,
        total_instances=run.total_instances,
        groups=groups,
        runner_config=runner_cfg,
        disable_metrics=comp.global_.disable_metrics,
        slo=[dict(x) for x in (grun.slo if grun is not None else [])],
        trace_ctx=_run_trace_ctx(tsk),
        env=engine.env,
        # eviction of a pack member stops its lanes at the next chunk
        # boundary, as a cancel does; the requeued member reruns from
        # scratch (a pack writes no snapshots, engine/pack.py)
        preempt=engine.register_preempt(tsk.id),
    )


def process_task_pack(engine: Engine, tasks: list[Task]) -> None:
    """Execute a claimed pack end-to-end (``supervisor.py:446-643``): each
    task keeps its own log file, cancel event, timeout timer, result and
    archive record — only the device program is shared (``sim/pack.py``).
    A member whose preparation or collection fails fails ALONE; if the
    pack shrinks below two members the survivor runs the ordinary solo
    path."""
    timeout = engine.env.daemon.scheduler.task_timeout_min * 60 or (
        DEFAULT_TASK_TIMEOUT_SECS
    )
    ctxs = []
    for tsk in tasks:
        cancel = engine.register_cancel(tsk.id)
        timer = threading.Timer(timeout, cancel.set)
        timer.daemon = True
        timer.start()
        log_file = open(engine.task_log_path(tsk.id), "w")
        ctxs.append({
            "tsk": tsk, "cancel": cancel, "timer": timer, "log": log_file,
            "ow": OutputWriter(sink=log_file), "result": None, "error": "",
            "preempted": None,
        })
        engine.storage.update_current(tsk)
        notify_task_started(engine.env, tsk)
        engine.events.emit(
            "task.started",
            task=tsk.id,
            trace=tsk.trace,
            state=State.PROCESSING.value,
            task_type=tsk.type.value,
            pack_width=len(tasks),
        )

    def failed(ctx, err: str) -> None:
        ctx["ow"].write_error(err)
        ctx["error"] = err
        ctx["result"] = {
            "outcome": (
                Outcome.CANCELED.value if ctx["cancel"].is_set()
                else Outcome.FAILURE.value
            )
        }

    try:
        ready = []
        for ctx in ctxs:
            try:
                ctx["job"] = _prepare_pack_run_input(
                    engine, ctx["tsk"], ctx["ow"], ctx["cancel"]
                )
                ready.append(ctx)
            except Exception as e:  # noqa: BLE001 — member-local failure
                S().error("pack member %s failed: %s", ctx["tsk"].id, e)
                ctx["ow"].write_error(str(e))
                ctx["error"] = str(e)
                ctx["result"] = {"outcome": Outcome.FAILURE.value}

        if len(ready) >= 2:
            from ..sim.executor import execute_packed_sim_runs

            try:
                with device_context(_run_device(ready[0]["job"].runner_config)):
                    outs = execute_packed_sim_runs(
                        [c["job"] for c in ready],
                        [c["ow"] for c in ready],
                        [c["cancel"] for c in ready],
                    )
            except Exception as e:  # noqa: BLE001 — whole-pack failure
                S().error("pack execution failed: %s", e)
                S().debug("%s", traceback.format_exc())
                for ctx in ready:
                    failed(ctx, str(e))
            else:
                for ctx, out in zip(ready, outs):
                    comp_dict = ctx["tsk"].composition
                    if isinstance(out, SloBreachError):
                        bo = out.run_output
                        rd = (
                            bo.result.to_dict()
                            if bo is not None and hasattr(bo.result, "to_dict")
                            else {"outcome": Outcome.FAILURE.value}
                        )
                        ctx["ow"].write_error(str(out))
                        ctx["error"] = str(out)
                        ctx["result"] = {**rd, "outcome": Outcome.FAILURE.value,
                                         "composition": comp_dict}
                    elif isinstance(out, TaskPreemptedError):
                        # an evicted member: the finally loop requeues it
                        # instead of archiving (never resumable)
                        ctx["preempted"] = out
                        ctx["ow"].infof("%s", out)
                    elif isinstance(out, Exception):
                        ctx["ow"].write_error(str(out))
                        ctx["error"] = str(out)
                        ctx["result"] = {"outcome": Outcome.FAILURE.value,
                                         "composition": comp_dict}
                    else:
                        rd = (
                            out.result.to_dict()
                            if hasattr(out.result, "to_dict")
                            else (out.result or {})
                        )
                        ctx["result"] = {
                            **rd,
                            "outcome": rd.get("outcome", Outcome.FAILURE.value),
                            "composition": comp_dict,
                        }
        elif len(ready) == 1:
            # the pack shrank to one — the ordinary solo path, so the
            # member loses nothing
            ctx = ready[0]
            try:
                ctx["result"] = do_run(engine, ctx["tsk"], ctx["ow"], ctx["cancel"])
            except TaskPreemptedError as e:
                ctx["preempted"] = e
                ctx["ow"].infof("%s", e)
            except Exception as e:  # noqa: BLE001
                failed(ctx, str(e))
    finally:
        for ctx in ctxs:
            tsk = ctx["tsk"]
            ctx["timer"].cancel()
            engine.drop_cancel(tsk.id)
            engine.drop_preempt(tsk.id)
            if ctx["preempted"] is not None:
                _requeue_preempted(engine, tsk, ctx["preempted"])
                _close_quietly(ctx["log"])
                continue
            tsk.result = ctx["result"] or {"outcome": Outcome.FAILURE.value}
            if ctx["error"]:
                tsk.error = ctx["error"]
            else:
                try:
                    ctx["ow"].write_result(tsk.result)
                except Exception:  # noqa: BLE001 — log-only
                    pass
            final = (
                State.CANCELED if ctx["cancel"].is_set() and tsk.error
                else State.COMPLETE
            )
            tsk.states.append(DatedState(state=final, created=time.time()))
            # the solo path's ordering contract: spans on disk before
            # COMPLETE is observable
            _finish_task(engine, tsk)
            engine.storage.archive(tsk)
            notify_task_finished(engine.env, tsk)
            _close_quietly(ctx["log"])
            S().info("task %s finished: %s (packed)", tsk.id, tsk.outcome().value)


def _close_quietly(f) -> None:
    try:
        f.close()
    except OSError:
        pass


# ----------------------------------------------------------------- builds


def do_build(
    engine: Engine,
    comp: Composition,
    manifest: TestPlanManifest,
    sources_dir: str,
    build_id: str,
    ow: OutputWriter,
    cancel: threading.Event,
) -> Composition:
    """Build all groups, deduplicating by build key; returns a clone with
    per-group ``run.artifact`` filled in (``supervisor.go:298-493``)."""
    comp = prepare_for_build(comp, manifest)
    validate_for_build(comp)

    # dedup groups by BuildKey (supervisor.go:359-364)
    by_key: dict[str, list[int]] = {}
    for i, g in enumerate(comp.groups):
        if g.run.artifact:
            continue  # reuse previously built artifact
        by_key.setdefault(g.build_key(), []).append(i)

    limit = comp.global_.concurrent_builds or 4
    results: dict[str, str] = {}

    def build_one(key: str, group_idx: int) -> tuple[str, str]:
        g = comp.groups[group_idx]
        builder = engine.builder_by_name(g.builder)
        if builder is None:
            raise ValueError(f"unknown builder: {g.builder}")
        cfg = (
            CoalescedConfig()
            .append(engine.env.builders.get(g.builder))
            .append(g.build_config)
        )
        inp = BuildInput(
            build_id=f"{build_id}-{group_idx}",
            test_plan=comp.global_.plan,
            unpacked_plan_dir=sources_dir,
            selectors=list(g.build.selectors),
            dependencies={
                d.module: (d.target, d.version) for d in g.build.dependencies
            },
            build_config=cfg.flatten(),
            env=engine.env,
        )
        out = builder.build(inp, ow, cancel)
        return key, out.artifact_path

    if by_key:
        with concurrent.futures.ThreadPoolExecutor(max_workers=limit) as pool:
            futs = [
                pool.submit(build_one, key, idxs[0]) for key, idxs in by_key.items()
            ]
            for fut in concurrent.futures.as_completed(futs):
                key, artifact = fut.result()
                results[key] = artifact

    for g in comp.groups:
        if not g.run.artifact:
            g.run.artifact = results[g.build_key()]
            ow.infof("group %s built: artifact %s", g.id, g.run.artifact)
    return comp


def do_build_task(
    engine: Engine, tsk: Task, ow: OutputWriter, cancel: threading.Event
) -> dict:
    """A build task (``tg build``, ``supervisor.go:298-493``): the groups'
    artifacts, without the reference's precompile into XLA's compile
    cache; with ``build_buckets`` (``tg build --buckets``) the shape-bucket
    ladder is warmed on the run's device after them
    (``builders/sim_plan.warm_bucket_ladder``), best-effort like the
    reference's precompile."""
    comp = Composition.from_dict(tsk.composition)
    manifest = TestPlanManifest.from_dict(tsk.input["manifest"])
    built = do_build(
        engine, comp, manifest, tsk.input.get("sources_dir", ""), tsk.id, ow, cancel
    )
    if "sim:plan" in built.list_builders() and not cancel.is_set():
        from ..builders.sim_plan import warm_bucket_ladder

        try:
            warm_bucket_ladder(built, manifest, engine.env, ow, cancel)
        except Exception as e:  # noqa: BLE001 — the artifacts above stand
            ow.warn("sim:plan bucket-ladder warmup failed (build still ok): %s", e)
    return {
        "outcome": Outcome.SUCCESS.value,
        "artifacts": {g.id: g.run.artifact for g in built.groups},
        "composition": built.to_dict(),
    }


# ------------------------------------------------------------------- runs


def do_run(
    engine: Engine, tsk: Task, ow: OutputWriter, cancel: threading.Event
) -> dict:
    """(``supervisor.go:494-656``)."""
    comp = Composition.from_dict(tsk.composition)
    manifest = TestPlanManifest.from_dict(tsk.input["manifest"])
    sources_dir = tsk.input.get("sources_dir", "")

    # refuse disabled runners (supervisor.go:568-571)
    runner_id = comp.global_.runner
    if engine.env.runner_is_disabled(runner_id):
        raise ValueError(f"runner {runner_id} is disabled in .env.toml")
    runner = engine.runner_by_name(runner_id)
    if runner is None:
        raise ValueError(f"unknown runner: {runner_id}")

    # build any groups missing artifacts (supervisor.go:495-518)
    needs_build = any(not g.run.artifact for g in comp.groups)
    if needs_build:
        comp = do_build(engine, comp, manifest, sources_dir, tsk.id, ow, cancel)
        tsk.composition = comp.to_dict()
        engine.storage.update_current(tsk)

    comp = prepare_for_run(comp, manifest)
    validate_for_run(comp)

    # coalesce runner config: composition > .env.toml > manifest-applied
    # defaults already in run_config (supervisor.go:563-581). The reference
    # coalesces after the healthcheck; here it comes first, so that the
    # checks probe the device the run will use.
    coalesced = CoalescedConfig().append(engine.env.runners.get(runner_id)).append(
        comp.global_.run_config
    )
    cfg_type = runner.config_type()
    runner_cfg = (
        coalesced.coalesce_into(cfg_type)
        if cfg_type is not None
        else coalesced.flatten()
    )

    # the run's device made current in this (worker) thread for the
    # healthcheck's kernel check and every run: the kernels launch on the
    # current device with the stream of their tensors' device
    with device_context(_run_device(runner_cfg)):
        return _run_composition(engine, tsk, comp, runner, runner_cfg, ow, cancel)


def _run_device(runner_cfg):
    """The card a run's coalesced config names (its ``device``, or the
    card when it names none and there is one); None for a host device."""
    import torch

    name = getattr(runner_cfg, "device", None)
    if name is None:
        return torch.device("cuda") if torch.cuda.is_available() else None
    dev = torch.device(name)
    return dev if dev.type == "cuda" else None


def _run_composition(engine: Engine, tsk: Task, comp: Composition, runner,
                     runner_cfg, ow: OutputWriter, cancel: threading.Event) -> dict:
    """The healthcheck and each ``[[runs]]`` entry of a prepared
    composition (``supervisor.go:541-656``)."""
    runner_id = comp.global_.runner
    cfg_type = runner.config_type()

    # healthcheck with fix (supervisor.go:541-553)
    from ..runners.base import HealthcheckedRunner

    if isinstance(runner, HealthcheckedRunner):
        report = runner.healthcheck(fix=True, ow=ow, env=engine.env,
                                    config=runner_cfg if cfg_type is not None else None)
        if report is not None and not report.ok():
            raise RuntimeError(f"runner {runner_id} failed healthcheck: {report}")

    # Execute each run in the composition sequentially; the task result
    # aggregates per-run results (multi-run [[runs]] support).
    run_results: dict[str, dict] = {}
    outcome = Outcome.SUCCESS
    artifacts_by_group = {g.id: g.run.artifact for g in comp.groups}
    # task-level timings: the queue wait and per-run runner wall are only
    # visible HERE — the executor measures inside a run (scheduled →
    # processing is appended by queue.pop, so the state timestamps carry
    # the wait)
    task_perf: dict = {"runner_wall_secs": {}}
    if len(tsk.states) >= 2:
        task_perf["queued_secs"] = round(
            max(0.0, tsk.states[-1].created - tsk.states[0].created), 3
        )

    for run in comp.runs:
        if cancel.is_set():
            raise RuntimeError("task canceled")
        run_id = tsk.id if len(comp.runs) == 1 else f"{tsk.id}-{run.id}"
        groups = []
        for rg in run.groups:
            backing = comp.get_group(rg.effective_group_id())
            groups.append(
                RunGroup(
                    id=rg.id,
                    instances=rg.calculated_instance_count,
                    artifact_path=artifacts_by_group[backing.id],
                    builder=backing.builder or comp.global_.builder,
                    parameters=dict(rg.test_params),
                    profiles=dict(rg.profiles),
                    resources=rg.resources,
                    faults=[dict(f) for f in rg.faults],
                    trace=dict(rg.trace or {}),
                    slo=[dict(s) for s in rg.slo],
                )
            )
        grun = comp.global_.run
        rinput = RunInput(
            run_id=run_id,
            test_plan=comp.global_.plan,
            test_case=comp.global_.case,
            total_instances=run.total_instances,
            groups=groups,
            runner_config=runner_cfg,
            disable_metrics=comp.global_.disable_metrics,
            # the run-global chaos schedule, flight-recorder table and SLO
            # rules; the per-group ones ride on each RunGroup above
            faults=[dict(f) for f in (grun.faults if grun is not None else [])],
            trace=dict(grun.trace if grun is not None else {}),
            slo=[dict(s) for s in (grun.slo if grun is not None else [])],
            trace_ctx=_run_trace_ctx(tsk),
            env=engine.env,
            # a live migration stops a single-[[runs]] task only: a
            # multi-run task's partial results have no requeue story
            preempt=engine.register_preempt(tsk.id) if len(comp.runs) == 1 else None,
        )
        ow.infof(
            "executing run %s: plan=%s case=%s instances=%d runner=%s",
            run_id,
            comp.global_.plan,
            comp.global_.case,
            run.total_instances,
            runner_id,
        )
        t_run = time.monotonic()
        try:
            out = runner.run(rinput, ow, cancel)
        except TaskPreemptedError:
            # armed for single-[[runs]] tasks only; process_task requeues
            raise
        except SloBreachError as e:
            # a fail-severity SLO canceled the run at a chunk boundary; the
            # error carries the assembled RunOutput, journal included, so
            # the task keeps the failed run's record. Later [[runs]] still
            # execute (the task's cancel event was not set).
            ow.write_error(f"run {run.id} failed: {e}")
            engine.events.emit(
                "task.slo_canceled",
                task=tsk.id,
                trace=tsk.trace,
                run=run.id,
                rule=e.breach.get("rule", ""),
                metric=e.breach.get("metric", ""),
                observed=e.breach.get("observed"),
            )
            bo = e.run_output
            result_dict = (
                bo.result.to_dict()
                if bo is not None and hasattr(bo.result, "to_dict")
                else {"outcome": Outcome.FAILURE.value}
            )
            run_results[run.id] = {**result_dict, "error": str(e)}
            outcome = Outcome.FAILURE
            continue
        except Exception as e:  # noqa: BLE001 — per-run isolation
            # single run: the exception is the task error. Several
            # [[runs]]: record it on this run and go on (run.go:281-336).
            # A cancel re-raises, so the task ends CANCELED.
            if len(comp.runs) == 1 or cancel.is_set():
                raise
            ow.write_error(f"run {run.id} failed: {e}")
            run_results[run.id] = {
                "outcome": Outcome.FAILURE.value,
                "error": str(e),
            }
            outcome = Outcome.FAILURE
            continue
        finally:
            task_perf["runner_wall_secs"][run.id] = round(
                time.monotonic() - t_run, 3
            )
        result = out.result if out is not None else None
        result_dict = (
            result.to_dict() if hasattr(result, "to_dict") else (result or {})
        )
        run_results[run.id] = result_dict
        if result_dict.get("outcome") != Outcome.SUCCESS.value:
            outcome = Outcome.FAILURE

    # run packing requested but executed solo: this is the solo path
    # (packed tasks run through process_task_pack), so the journal says
    # why it did not pack — the classification tg check previews as rule
    # pack.solo (supervisor.py:940-973)
    if runner_id == "sim:torch" and _truthy(getattr(runner_cfg, "pack", False)):
        from .pack import pack_solo_reason

        solo_reason = (
            pack_solo_reason(tsk, engine.env.runners.get(runner_id) or {})
            or "no compatible queued run to pack with at claim time"
        )
        tsk.trace["solo_reason"] = solo_reason
        engine.fleet_note_solo(solo_reason)
        engine.events.emit(
            "pack.solo",
            task=tsk.id,
            trace=tsk.trace,
            solo_reason=solo_reason,
        )
        for rres in run_results.values():
            journal = rres.get("journal") if isinstance(rres, dict) else None
            if isinstance(journal, dict) and isinstance(journal.get("sim"), dict):
                journal["sim"]["pack"] = {
                    "requested": True,
                    "packed": False,
                    "solo_reason": solo_reason,
                }

    base = (
        run_results[comp.runs[0].id]
        if len(comp.runs) == 1
        else {"runs": run_results}
    )
    return {
        **base,
        "outcome": outcome.value,
        "composition": comp.to_dict(),
        "perf": task_perf,
    }
