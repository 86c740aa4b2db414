"""Builds and runs a task in process — the port's copy of ``do_build`` and
``do_run`` of the reference's ``testground_tpu/engine/supervisor.py``
(``supervisor.go``), and of the error handling of its ``process_task``.

The reference's ``engine`` argument becomes an explicit :class:`Registry`:
the env, and the builders and runners by ID. Builds are deduplicated by
``Group.build_key()``; the runner config coalesces the env's runner layer
under the composition's; each ``[[runs]]`` entry becomes one ``RunInput``.
The task queue, the store, the event journal, preemption and run packs
come with the engine (ROADMAP queue 1 item 9e; packs item 13).
"""

from __future__ import annotations

import concurrent.futures
import threading
import time
import traceback
from dataclasses import dataclass, field

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
from ..config import CoalescedConfig, EnvConfig
from ..logging_ import S
from ..rpc import OutputWriter
from ..sim.slo import SloBreachError
from ..sim.telemetry import new_span_id, new_trace_id
from .task import DatedState, Outcome, State, Task, TaskType, new_task_id

__all__ = ["Registry", "do_build", "do_run", "new_run_task", "process_task"]

DEFAULT_TASK_TIMEOUT_SECS = 10 * 60  # supervisor.go:49-52


@dataclass
class Registry:
    """What the supervisor reads of the reference's ``Engine``: the env,
    and the builders and runners by ID."""

    env: EnvConfig
    builders: dict = field(default_factory=dict)
    runners: dict = field(default_factory=dict)

    @classmethod
    def new_default(cls, env: EnvConfig) -> "Registry":
        """The port's one builder and one runner (``engine.go:25-38``)."""
        from ..builders import SimPlanBuilder
        from ..sim.runner import SimTorchRunner

        return cls(env=env, builders={"sim:plan": SimPlanBuilder()},
                   runners={"sim:torch": SimTorchRunner()})

    def builder_by_name(self, name: str):
        return self.builders.get(name)

    def runner_by_name(self, name: str):
        return self.runners.get(name)

    def do_healthcheck(self, runner_id: str, fix: bool, ow):
        from ..runners.base import HealthcheckedRunner

        runner = self.runner_by_name(runner_id)
        if runner is None:
            raise ValueError(f"unknown runner: {runner_id}")
        if not isinstance(runner, HealthcheckedRunner):
            raise ValueError(f"runner {runner_id} does not support healthchecks")
        return runner.healthcheck(fix, ow, env=self.env)


def new_run_task(
    engine: Registry,
    comp: Composition,
    manifest: TestPlanManifest,
    sources_dir: str = "",
) -> Task:
    """A scheduled run task (``engine.go:203-249`` QueueRun without the
    queue): the composition validated, the runner known and every group's
    builder compatible with it, a fresh lifecycle trace rooted at the
    submit (the reference adopts a submitter's traceparent, which crosses
    the daemon's wire hop: item 9e)."""
    validate_for_run(comp)
    runner = engine.runner_by_name(comp.global_.runner)
    if runner is None:
        raise ValueError(f"unknown runner: {comp.global_.runner}")
    compatible = set(runner.compatible_builders())
    for b in comp.list_builders():
        if b and b not in compatible:
            raise ValueError(
                f"builder {b} is incompatible with runner "
                f"{comp.global_.runner} (compatible: {sorted(compatible)})"
            )
    trace = {"trace_id": new_trace_id(), "root_span_id": new_span_id(),
             "queued_span_id": new_span_id()}
    return Task(
        id=new_task_id(),
        type=TaskType.RUN,
        plan=comp.global_.plan,
        case=comp.global_.case,
        runner=comp.global_.runner,
        composition=comp.to_dict(),
        input={"manifest": manifest.to_dict(), "sources_dir": sources_dir},
        states=[DatedState(state=State.SCHEDULED, created=time.time())],
        trace=trace,
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


def process_task(
    engine: Registry, tsk: Task, ow: OutputWriter, cancel: threading.Event
) -> None:
    """Execute one task to its end, with its timeout (``supervisor.go:
    192-291``): a task error becomes the task's error and a FAILURE (or
    CANCELED) result, never an exception."""
    timeout = engine.env.daemon.scheduler.task_timeout_min * 60 or (
        DEFAULT_TASK_TIMEOUT_SECS
    )
    timer = threading.Timer(timeout, cancel.set)
    timer.daemon = True
    timer.start()
    tsk.states.append(DatedState(state=State.PROCESSING, created=time.time()))
    tsk.trace.setdefault("claim_span_id", new_span_id())
    tsk.trace.setdefault("execute_span_id", new_span_id())
    try:
        if tsk.type != TaskType.RUN:
            raise ValueError(f"unsupported task type {tsk.type}")
        tsk.result = do_run(engine, tsk, ow, cancel)
    except Exception as e:  # noqa: BLE001 — task errors become results
        S().error("task %s failed: %s", tsk.id, e)
        ow.write_error(str(e))
        tsk.error = str(e)
        tsk.result = {
            "outcome": (
                Outcome.CANCELED.value if cancel.is_set() else Outcome.FAILURE.value
            )
        }
        S().debug("%s", traceback.format_exc())
    else:
        ow.write_result(tsk.result)
    finally:
        timer.cancel()
    final = State.CANCELED if cancel.is_set() and tsk.error else State.COMPLETE
    tsk.states.append(DatedState(state=final, created=time.time()))


# ----------------------------------------------------------------- builds


def do_build(
    engine: Registry,
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


# ------------------------------------------------------------------- runs


def do_run(
    engine: Registry, tsk: Task, ow: OutputWriter, cancel: threading.Event
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
    # the queue wait (queued_secs) comes with the task queue (item 9e)
    task_perf: dict = {"runner_wall_secs": {}}

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
        except SloBreachError as e:
            # a fail-severity SLO canceled the run at a chunk boundary; the
            # error carries the assembled RunOutput, journal included, so
            # the task keeps the failed run's record. Later [[runs]] still
            # execute (the task's cancel event was not set).
            ow.write_error(f"run {run.id} failed: {e}")
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
