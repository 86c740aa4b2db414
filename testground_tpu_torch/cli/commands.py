"""CLI command implementations — the port's copy of the reference's
``testground_tpu/cli/commands.py`` (``pkg/cmd/{run,build,collect,terminate,
healthcheck,tasks,status,logs,daemon}.go``) for the verbs the port serves:
``run composition|single``, ``build composition|single|purge``, ``tasks``,
``status`` (with ``--telemetry``), ``logs``, ``collect``, ``healthcheck``,
``terminate``, ``daemon``, ``check`` (with ``--trace-plans``), ``plan
list|import|rm|create``, ``describe``, ``version``, and the read side of
the observability plane: ``stats``, ``perf`` (``--compare``, ``--phases``,
``--measure``, ``--follow``), ``trace`` (``--lifecycle``), ``watch``,
``netmap``, ``diff`` and ``top``. These read the task store, the result
journals and the run outputs, and never touch the card.

Every verb goes through an engine: a ``RemoteEngine`` over the daemon's
HTTP API when ``--endpoint`` (or ``[client] endpoint``) names one, else an
in-process ``Engine`` whose task store is on disk, so that ``status``,
``logs`` and ``tasks`` of a run work from a fresh process. Output phrasing
matches the reference ("run is queued with ID", the task log, "finished
run with ID"), and so does the ``--result-file`` CSV.

The fleet controller's verbs: ``run resume`` (a checkpointed task queued
again with ``resume_from`` at its own run), ``preempt`` and ``terminate
--drain``.

Runs go to either of the port's runners: ``local:exec`` (one host process
per instance, on the ``exec:py`` and ``exec:bin`` builders) or
``sim:torch``. ``build`` precompiles: the check pass, then each distinct
run shape warmed on the run's device under a BuildKey marker
(``builders/sim_plan.SimPlanBuilder.precompile``); ``build --buckets`` also
warms the shape-bucket ladder (``builders/sim_plan.warm_bucket_ladder``),
and with ``pack`` the pack widths of each rung. ``sim-worker`` joins a cohort as a follower
(``sim/executor.run_sim_worker``), with the reference's flags and a
``--device`` (the card unless it names another). ``sync-service`` boots
the sync service (``sync/boot.py``: the native C++ server or the Python
one) and serves it until SIGTERM; ``sync-stats`` reads a running
service's stats plane. Neither touches the card.
"""

from __future__ import annotations

import os
import shutil
import sys
import time

from ..api import (
    Composition,
    Global,
    Group,
    Instances,
    TestPlanManifest,
    generate_default_run,
    load_composition,
    validate_for_run,
)
from ..config import EnvConfig
from ..engine import Engine, Outcome, State
from ..rpc import OutputWriter
from ..utils.conv import parse_key_values

# --------------------------------------------------------------- plumbing


def _engine(args):
    """The engine behind every verb: in-process by default, or an
    Engine-shaped HTTP client when ``--endpoint`` (or the .env.toml
    ``[client] endpoint``) points at a daemon — the client↔daemon hop is
    transport, not semantics (``pkg/client/client.go:43-513``).

    In-process task state must survive across CLI invocations
    (status/logs/tasks run in fresh processes), so the memory default
    upgrades to disk unless .env.toml explicitly chose memory."""
    env = EnvConfig.load()
    endpoint = _endpoint(args, env)
    if endpoint:
        from ..client import Client, RemoteEngine

        return RemoteEngine(Client(endpoint, token=env.client.token), env)
    if not env.task_repo_explicit:
        env.daemon.scheduler.task_repo_type = "disk"
    engine = Engine.new_default(env)
    engine.start_workers()
    return engine


def _print_chunk_line(line: str, raw_fallback: bool = True) -> None:
    """Decode one task-log chunk line to the console (shared by run-follow
    and ``logs``)."""
    from ..rpc import Chunk

    try:
        c = Chunk.from_json(line)
    except Exception:  # noqa: BLE001 — non-chunk lines pass through
        if raw_fallback:
            sys.stdout.write(line)
        return
    if c.type == "p" and isinstance(c.payload, str):
        sys.stdout.write(c.payload)
    elif c.type == "e" and c.error:
        print(f"error: {c.error}", file=sys.stderr)


def _resolve_plan(env: EnvConfig, plan: str) -> tuple[str, TestPlanManifest]:
    """Resolve a plan name/path to (source dir, manifest): the plan as a
    path, then ``$TESTGROUND_HOME/plans/<plan>`` (``pkg/cmd/run.go:181``)."""
    candidates = [
        plan,
        os.path.join(env.dirs.plans(), plan),
    ]
    for c in candidates:
        manifest_path = os.path.join(c, "manifest.toml")
        if os.path.isfile(manifest_path):
            return os.path.abspath(c), TestPlanManifest.load_file(manifest_path)
    raise FileNotFoundError(
        f"plan {plan!r} not found (searched: {candidates}); "
        f"import it with `tg plan import --from <dir>`"
    )


def _created_by(args, env: EnvConfig):
    """CreatedBy from the --metadata-* flags (+ [client] user) — the CI
    identity that drives per-branch queue dedup (``pkg/cmd/run.go:62-70``,
    ``queue.go:80-97``). None when no metadata was given."""
    from ..engine.task import CreatedBy

    repo = getattr(args, "metadata_repo", "")
    branch = getattr(args, "metadata_branch", "")
    commit = getattr(args, "metadata_commit", "")
    if not (repo or branch or commit or env.client.user):
        return None
    return CreatedBy(
        user=env.client.user, repo=repo, branch=branch, commit=commit
    )


def _endpoint(args, env: EnvConfig) -> str:
    """Daemon endpoint precedence: --endpoint flag > .env.toml [client]."""
    return getattr(args, "endpoint", "") or env.client.endpoint


def _resolve_manifest(env: EnvConfig, args, plan: str) -> TestPlanManifest:
    """Resolve a plan's manifest: locally, or from the daemon when
    ``--endpoint`` points at one (GET /describe) — plans live daemon-side,
    so a remote CLI need not hold a local copy."""
    try:
        return _resolve_plan(env, plan)[1]
    except FileNotFoundError:
        endpoint = _endpoint(args, env)
        if not endpoint:
            raise
        from ..client import Client

        return Client(endpoint, token=env.client.token).describe_plan(plan)


def _wait_task(engine: Engine, task_id: str, follow_logs: bool = True):
    if follow_logs:
        for line in engine.logs(task_id, follow=True):
            _print_chunk_line(line, raw_fallback=False)
    while True:
        t = engine.get_task(task_id)
        if t is not None and t.state().state in (State.COMPLETE, State.CANCELED):
            return t
        time.sleep(0.1)


def _collect_to_file(engine: Engine, runner_id: str, run_id: str, dest: str):
    from ..rpc import discard_writer

    with open(dest, "wb") as f:
        engine.do_collect_outputs(runner_id, run_id, f, discard_writer())
    print(f"downloaded outputs to {dest}")


def _help_func(parser):
    """Default func for command groups invoked bare: print usage, exit 2."""

    def fn(args):
        parser.print_help()
        return 2

    return fn


def _add_metadata_flags(p) -> None:
    """CI metadata flags (``pkg/cmd/run.go:62-70``; also on build)."""
    p.add_argument("--metadata-repo", default="", help="source repo (CI)")
    p.add_argument("--metadata-branch", default="", help="source branch (CI)")
    p.add_argument("--metadata-commit", default="", help="source commit (CI)")


def _add_priority_flag(p) -> None:
    p.add_argument(
        "--priority",
        type=int,
        default=0,
        help="queue priority (higher runs first)",
    )


# ------------------------------------------------------------------- run


def register_run(sub) -> None:
    p = sub.add_parser("run", help="(builds and) runs a composition or single test case")
    p.set_defaults(func=_help_func(p))
    psub = p.add_subparsers(dest="run_mode")

    pc = psub.add_parser("composition", help="run a composition file")
    pc.add_argument("-f", "--file", required=True, help="composition TOML file")
    pc.add_argument("--collect", action="store_true", help="collect outputs after run")
    pc.add_argument("--collect-file", default="", help="write outputs tgz here")
    pc.add_argument(
        "--write-artifacts",
        action="store_true",
        help="write built artifacts back into the composition file",
    )
    pc.add_argument(
        "--ignore-artifacts",
        action="store_true",
        help="ignore artifacts in the composition; rebuild",
    )
    pc.add_argument("--run-ids", default="", help="only run these [[runs]] ids (csv)")
    pc.add_argument(
        "--result-file", default="", help="append run results as CSV rows"
    )
    pc.add_argument(
        "--detach",
        action="store_true",
        help="queue the task and exit without waiting (the reference's "
        "non---wait mode; follow later with `logs -f`)",
    )
    _add_priority_flag(pc)
    _add_metadata_flags(pc)
    pc.set_defaults(func=run_composition_cmd)

    ps = psub.add_parser("single", help="run a single plan/case")
    ps.add_argument("plan_case", help="<plan>:<case>")
    ps.add_argument("--builder", default="")
    ps.add_argument("--runner", default="")
    ps.add_argument("-i", "--instances", type=int, default=0)
    ps.add_argument(
        "-tp",
        "--test-param",
        action="append",
        default=[],
        help="test param k=v (repeatable)",
    )
    ps.add_argument("--collect", action="store_true")
    ps.add_argument(
        "-ub",
        "--use-build",
        default="",
        help="build artifact from a previous build (skips the build step)",
    )
    ps.add_argument(
        "--run-cfg",
        action="append",
        default=[],
        help="override runner configuration k=v (repeatable)",
    )
    ps.add_argument(
        "--disable-metrics",
        action="store_true",
        help="disable metrics batching",
    )
    ps.add_argument(
        "--detach",
        action="store_true",
        help="queue the task and exit without waiting",
    )
    _add_priority_flag(ps)
    _add_metadata_flags(ps)
    ps.set_defaults(func=run_single_cmd)

    pr = psub.add_parser(
        "resume",
        help="resume an interrupted checkpointed run from its newest "
        "snapshot (docs/CHECKPOINT.md): re-queues the task's own "
        "composition with runner config resume_from=<task>, so the new "
        "run seeds its carry from the snapshot and continues "
        "bit-identically",
    )
    pr.add_argument("task", help="task id of the checkpointed run")
    pr.add_argument(
        "--run-cfg",
        action="append",
        default=[],
        help="override runner configuration k=v on the resumed run "
        "(repeatable) — e.g. max_ticks=10000000 to extend a "
        "budget-interrupted soak; program-shaping options still "
        "validate against the snapshot manifest",
    )
    pr.add_argument(
        "--detach",
        action="store_true",
        help="queue the resumed task and exit without waiting",
    )
    _add_priority_flag(pr)
    _add_metadata_flags(pr)
    pr.set_defaults(func=run_resume_cmd)


def run_resume_cmd(args) -> int:
    """``tg run resume <task>`` (``commands.py:275-312``): the interrupted
    task's own composition, its artifacts already resolved, queued again
    with ``resume_from`` naming the old run."""
    engine = _engine(args)
    try:
        t = engine.get_task(args.task)
        if t is None:
            raise KeyError(f"unknown task {args.task}")
        if not t.composition:
            raise ValueError(f"task {args.task} carries no composition to resume")
        comp = Composition.from_dict(t.composition)
        if len(comp.runs) > 1:
            # a multi-[[runs]] task writes one outputs dir per run
            # (<task>-<run id>), and one resume_from cannot name them all
            raise ValueError(
                f"task {t.id} is a multi-[[runs]] composition "
                f"({len(comp.runs)} runs) — resume one run at a time by "
                "re-running the composition framed to that run "
                "(--run-ids <id>) with run config "
                f"resume_from = \"{t.id}-<run id>\""
            )
        comp.global_.run_config = dict(comp.global_.run_config or {})
        comp.global_.run_config.update(parse_key_values(getattr(args, "run_cfg", [])))
        comp.global_.run_config["resume_from"] = t.id
        print(f"resuming task {t.id} ({t.name()}) from its newest snapshot")
    finally:
        engine.stop()
    return _run(args, comp)


def run_composition_cmd(args) -> int:
    comp = load_composition(args.file)
    if args.ignore_artifacts:
        for g in comp.groups:
            g.run.artifact = ""
    # validate before frame_for_runs so a bad composition is rejected even
    # when --run-ids selects a subset (queue_run re-validates the framed
    # composition; reference order is the same, run.go:157 → FrameForRuns)
    validate_for_run(comp)
    if args.run_ids:
        comp = comp.frame_for_runs(*args.run_ids.split(","))
    return _run(args, comp, write_artifacts_to=args.file if args.write_artifacts else "")


def run_single_cmd(args) -> int:
    """(``pkg/cmd/run.go`` runSingleCmd + createSingletonComposition)."""
    plan, _, case = args.plan_case.partition(":")
    if not case:
        raise ValueError("expected <plan>:<case>")
    env = EnvConfig.load()
    manifest = _resolve_manifest(env, args, plan)
    builder = args.builder or manifest.defaults.get("builder", "")
    runner = args.runner or manifest.defaults.get("runner", "")
    tc = manifest.testcase_by_name(case)
    instances = args.instances or (tc.instances.default if tc else 1) or 1
    comp = Composition(
        global_=Global(
            plan=plan,
            case=case,
            builder=builder,
            runner=runner,
            # --run-cfg k=v overrides (run.go:104-107)
            run_config=parse_key_values(args.run_cfg),
            disable_metrics=args.disable_metrics,
        ),
        groups=[Group(id="single", instances=Instances(count=instances))],
    )
    comp.groups[0].run.test_params = {
        k: str(v) for k, v in parse_key_values(args.test_param).items()
    }
    if args.use_build:
        # --use-build: reuse a prior build's artifact, skipping the build
        # step entirely (run.go:119-123)
        comp.groups[0].run.artifact = args.use_build
    comp = generate_default_run(comp)
    print(
        'created a synthetic composition file for this job; all instances '
        'will run under singleton group "single"'
    )
    return _run(args, comp)


def _run(args, comp: Composition, write_artifacts_to: str = "") -> int:
    """Queue ``comp`` and follow the task to its end
    (``commands.py:374-497``): through a daemon, or through the in-process
    engine's queue and a worker."""
    from ..client import RemoteEngine
    from ..tracectx import TraceContext

    engine = _engine(args)
    try:
        created_by = _created_by(args, engine.env)
        # the submit span roots the task's lifecycle trace: the CLI mints
        # the trace id here so the causal chain starts at the submitter,
        # and the daemon/engine parents every later span under it
        # (engine/tracetree.py)
        submit_ctx = TraceContext.mint()
        priority = int(getattr(args, "priority", 0) or 0)
        if isinstance(engine, RemoteEngine):
            # the daemon resolves the plan from ITS $TESTGROUND_HOME/plans
            task_id = engine.queue_run(
                comp,
                priority=priority,
                created_by=created_by,
                trace_parent=submit_ctx.to_traceparent(),
            )
        else:
            src_dir, manifest = _resolve_plan(engine.env, comp.global_.plan)
            task_id = engine.queue_run(
                comp,
                manifest,
                sources_dir=src_dir,
                priority=priority,
                created_by=created_by,
                trace_parent=submit_ctx.to_traceparent(),
            )
        print(f"run is queued with ID: {task_id}")
        if getattr(args, "detach", False):
            # queue-only mode (the reference without --wait, run.go:348):
            # in-process engines must keep running the task, so detach is
            # only meaningful against a daemon
            if not isinstance(engine, RemoteEngine):
                print(
                    "warning: --detach without --endpoint queues into an "
                    "in-process engine that exits with the CLI; waiting "
                    "instead",
                    file=sys.stderr,
                )
            else:
                dropped = [
                    flag
                    for flag, attr in (
                        ("--collect", "collect"),
                        ("--collect-file", "collect_file"),
                        ("--result-file", "result_file"),
                        ("--write-artifacts", "write_artifacts"),
                    )
                    if getattr(args, attr, None)
                ]
                if dropped:
                    print(
                        "warning: --detach does not wait for the task, so "
                        f"{', '.join(dropped)} will be ignored",
                        file=sys.stderr,
                    )
                return 0
        t = _wait_task(engine, task_id)
        outcome = t.outcome()
        print(f"finished run with ID: {task_id} (outcome: {outcome.value})")

        # per-run breakdown for multi-[[runs]] compositions (run.go:281-336)
        run_results = (
            t.result.get("runs", {}) if isinstance(t.result, dict) else {}
        )
        for rid, rres in run_results.items():
            print(
                f"  run {rid}: outcome: "
                f"{rres.get('outcome', Outcome.UNKNOWN.value)}"
            )

        if write_artifacts_to and isinstance(t.result, dict):
            comp_out = t.result.get("composition")
            if comp_out:
                Composition.from_dict(comp_out).write_file(write_artifacts_to)
                print(f"wrote artifacts into composition {write_artifacts_to}")

        collect_file = getattr(args, "collect_file", "")
        if getattr(args, "collect", False) or collect_file:
            dest = collect_file or f"{task_id}.tgz"
            _collect_to_file(engine, comp.global_.runner, task_id, dest)

        result_file = getattr(args, "result_file", "")
        if result_file:
            import csv

            new = not os.path.exists(result_file)
            with open(result_file, "a", newline="") as f:
                w = csv.writer(f)
                if new:
                    w.writerow(["task_id", "plan_case", "outcome", "error"])
                if run_results:
                    # one row per [[runs]] entry, each with its own error
                    for rid, rres in run_results.items():
                        w.writerow([
                            f"{t.id}-{rid}",
                            t.name(),
                            rres.get("outcome", Outcome.UNKNOWN.value),
                            rres.get("error", ""),
                        ])
                else:
                    w.writerow([t.id, t.name(), outcome.value, t.error])

        return 0 if outcome == Outcome.SUCCESS else 1
    finally:
        engine.stop()


# ------------------------------------------------------------------ build


def register_build(sub) -> None:
    p = sub.add_parser("build", help="builds a composition or single plan")
    p.set_defaults(func=_help_func(p))
    psub = p.add_subparsers(dest="build_mode")
    pc = psub.add_parser("composition")
    pc.add_argument("-f", "--file", required=True)
    pc.add_argument("--write-artifacts", action="store_true")
    pc.add_argument(
        "--buckets",
        action="store_true",
        help="also warm every bucket of the shape-bucket ladder (bucket_ladder) "
        "for this composition; runs default to bucket=auto",
    )
    pc.add_argument(
        "--run-cfg",
        action="append",
        default=[],
        help="override runner configuration k=v (repeatable); merged into "
        "global.run_config, which --write-artifacts writes out",
    )
    _add_metadata_flags(pc)
    pc.set_defaults(func=build_composition_cmd)
    ps = psub.add_parser("single")
    ps.add_argument("plan", help="<plan> or <plan>:<case>")
    ps.add_argument("--builder", default="")
    ps.add_argument(
        "--buckets",
        action="store_true",
        help="also warm every bucket of the shape-bucket ladder (bucket_ladder) "
        "for this composition; runs default to bucket=auto",
    )
    ps.add_argument(
        "--run-cfg",
        action="append",
        default=[],
        help="override runner configuration k=v (repeatable)",
    )
    _add_metadata_flags(ps)
    ps.set_defaults(func=build_single_cmd)

    pp = psub.add_parser(
        "purge", help="purge the cache for a builder and testplan"
    )
    pp.add_argument("-b", "--builder", required=True)
    pp.add_argument("-p", "--plan", required=True)
    pp.set_defaults(func=build_purge_cmd)


def _apply_build_run_cfg(comp, args) -> None:
    """``build --run-cfg k=v`` and ``--buckets``: merge the overrides into
    the composition's ``global.run_config``, and ask for the ladder warm
    there (``build_buckets``; bucketed runs default to ``bucket=auto``),
    as the reference's ``_apply_bucket_build_flags`` does
    (``commands.py:555-568``)."""
    overrides = parse_key_values(getattr(args, "run_cfg", []) or [])
    if overrides:
        comp.global_.run_config = dict(comp.global_.run_config or {})
        comp.global_.run_config.update(overrides)
    if not getattr(args, "buckets", False):
        return
    comp.global_.run_config = dict(comp.global_.run_config or {})
    comp.global_.run_config["build_buckets"] = True
    comp.global_.run_config.setdefault("bucket", "auto")


def _queue_build(engine, comp, args, manifest=None, src_dir="") -> str:
    from ..client import RemoteEngine
    from ..tracectx import TraceContext

    created_by = _created_by(args, engine.env)
    submit_ctx = TraceContext.mint()
    if isinstance(engine, RemoteEngine):
        return engine.queue_build(
            comp,
            created_by=created_by,
            trace_parent=submit_ctx.to_traceparent(),
        )
    return engine.queue_build(
        comp,
        manifest,
        sources_dir=src_dir,
        created_by=created_by,
        trace_parent=submit_ctx.to_traceparent(),
    )


def build_composition_cmd(args) -> int:
    from ..client import RemoteEngine

    comp = load_composition(args.file)
    _apply_build_run_cfg(comp, args)
    engine = _engine(args)
    try:
        if isinstance(engine, RemoteEngine):
            task_id = _queue_build(engine, comp, args)
        else:
            src_dir, manifest = _resolve_plan(engine.env, comp.global_.plan)
            task_id = _queue_build(engine, comp, args, manifest, src_dir)
        print(f"build is queued with ID: {task_id}")
        t = _wait_task(engine, task_id)
        print(f"finished build with ID: {task_id} (outcome: {t.outcome().value})")
        if args.write_artifacts and isinstance(t.result, dict):
            comp_out = t.result.get("composition")
            if comp_out:
                Composition.from_dict(comp_out).write_file(args.file)
                print(f"wrote artifacts into composition {args.file}")
        return 0 if t.outcome() == Outcome.SUCCESS else 1
    finally:
        engine.stop()


def build_purge_cmd(args) -> int:
    """(``build.go:91-110`` purge — drop a builder's cached artifacts for
    one plan)."""
    engine = _engine(args)
    try:
        ow = OutputWriter(sink=None, echo=sys.stdout)
        engine.do_build_purge(args.builder, args.plan, ow)
        print(f"purged {args.builder} cache for plan {args.plan}")
        return 0
    finally:
        engine.stop()


def build_single_cmd(args) -> int:
    from ..client import RemoteEngine

    plan, _, case = args.plan.partition(":")
    engine = _engine(args)
    try:
        try:
            src_dir, manifest = _resolve_plan(engine.env, plan)
        except FileNotFoundError:
            # daemon-hosted plan: the daemon resolves its own sources
            src_dir = ""
            manifest = _resolve_manifest(engine.env, args, plan)
        builder = args.builder or manifest.defaults.get("builder", "")
        # with a case the instance count and runner default from the
        # manifest, matching what a default `run single` would execute
        instances = 1
        runner = ""
        if case:
            tc = manifest.testcase_by_name(case)
            if tc is None:
                raise ValueError(f"test case {case} not found in plan {plan}")
            instances = tc.instances.default or tc.instances.minimum or 1
            runner = manifest.defaults.get("runner", "")
        comp = Composition(
            global_=Global(plan=plan, case=case, builder=builder, runner=runner),
            groups=[Group(id="single", instances=Instances(count=instances))],
        )
        _apply_build_run_cfg(comp, args)
        if isinstance(engine, RemoteEngine):
            task_id = _queue_build(engine, comp, args)
        else:
            task_id = _queue_build(engine, comp, args, manifest, src_dir)
        print(f"build is queued with ID: {task_id}")
        t = _wait_task(engine, task_id)
        print(f"finished build with ID: {task_id} (outcome: {t.outcome().value})")
        if isinstance(t.result, dict):
            for gid, artifact in t.result.get("artifacts", {}).items():
                # printed so a later `run single --use-build <artifact>`
                # can reuse it (run.go:119-123)
                print(f"group {gid} artifact: {artifact}")
        return 0 if t.outcome() == Outcome.SUCCESS else 1
    finally:
        engine.stop()


# ------------------------------------------------------------------ check


def register_check(sub) -> None:
    p = sub.add_parser(
        "check",
        help="statically analyze composition file(s) against the sim:torch "
        "admission rules — every refusal the executor would raise, reported "
        "in one pass before anything queues",
    )
    p.add_argument(
        "compositions",
        nargs="+",
        help="composition TOML file(s); the plan resolves from "
        "$TESTGROUND_HOME/plans, a plans/ dir beside the composition "
        "(plans/<plan>/_compositions/x.toml layout), or ./plans/<plan>",
    )
    p.add_argument(
        "--json",
        action="store_true",
        help="emit the machine-readable findings document (schema "
        "version 1; exit codes unchanged)",
    )
    p.add_argument(
        "--trace-plans",
        action="store_true",
        help="also build each referenced plan on the meta device at the "
        "composition's shapes (no device memory, no kernel launch) and run "
        "two ticks of its step: load, build, memory and step errors, and "
        "the tick's lints (per-tick host copies, while loops on device "
        "values, state leaves whose dtype drifts)",
    )
    p.add_argument(
        "--run-cfg",
        action="append",
        default=[],
        help="override runner configuration k=v for the analysis "
        "(repeatable) — check what a different knob combination would "
        "do without editing the file",
    )
    p.add_argument(
        "--devices",
        type=int,
        default=0,
        help="device-context override: evaluate the mesh-bound rules as "
        "if the run had N cards (0 = this host's visible cards)",
    )
    p.set_defaults(func=check_cmd)


def _resolve_plan_for_check(env: EnvConfig, comp_path: str, plan: str):
    """Plan resolution for ``check`` (``commands.py:935-962``): the run
    verbs' search paths plus the repo layouts a checked-in composition
    lives in — ``plans/<plan>/_compositions/x.toml`` resolves its own plan
    dir, and ``./plans/<plan>`` covers compositions checked from a repo
    root."""
    try:
        return _resolve_plan(env, plan)
    except FileNotFoundError:
        pass
    comp_dir = os.path.dirname(os.path.abspath(comp_path))
    candidates = [
        os.path.dirname(comp_dir),  # plans/<plan>/_compositions/x.toml
        os.path.join(os.getcwd(), "plans", plan),
        os.path.join(comp_dir, plan),
    ]
    for c in candidates:
        manifest_path = os.path.join(c, "manifest.toml")
        if os.path.isfile(manifest_path):
            m = TestPlanManifest.load_file(manifest_path)
            if m.name == plan:
                return os.path.abspath(c), m
    raise FileNotFoundError(
        f"plan {plan!r} for {comp_path} not found (searched "
        f"$TESTGROUND_HOME/plans and {candidates}); import it with "
        "`tg plan import --from <dir>` or run check from the repo root"
    )


def check_cmd(args) -> int:
    """(``commands.py:965-1012``): findings of every composition, in one
    pass each; exit 2 when a file cannot be checked, 1 on any error
    finding, else 0."""
    import json

    from ..sim.check import (
        Finding,
        check_composition,
        findings_payload,
        render_findings,
        rule_by_id,
    )

    env = EnvConfig.load()
    overrides = parse_key_values(getattr(args, "run_cfg", []) or [])
    results = []
    load_failures = 0
    for path in args.compositions:
        try:
            comp = load_composition(path)
            if overrides:
                comp.global_.run_config = dict(comp.global_.run_config or {})
                comp.global_.run_config.update(overrides)
            plan_dir, manifest = _resolve_plan_for_check(
                env, path, comp.global_.plan
            )
            findings = check_composition(
                comp,
                manifest,
                env_layer=env.runners.get(comp.global_.runner or "sim:torch"),
                devices=getattr(args, "devices", 0) or 0,
                trace_plans=getattr(args, "trace_plans", False),
                plan_sources=plan_dir,
            )
        except Exception as e:  # noqa: BLE001 — per-file isolation: the
            # failure lands in the findings document, not on stderr only
            load_failures += 1
            r = rule_by_id("composition.invalid")
            findings = [Finding(rule=r.id, severity=r.severity, layer=r.layer,
                                message=f"cannot check: {e}")]
        results.append((path, findings))
    if getattr(args, "json", False):
        print(json.dumps(findings_payload(results), indent=2, sort_keys=True))
    else:
        for path, findings in results:
            print(render_findings(path, findings))
    errors = sum(1 for _, fs in results for f in fs if f.severity == "error")
    if load_failures:
        return 2
    return 1 if errors else 0


# ---------------------------------------------------- tasks / status / logs


def register_tasks(sub) -> None:
    p = sub.add_parser("tasks", help="list tasks")
    p.add_argument("--state", action="append", default=[], help="filter by state")
    p.add_argument("--type", action="append", default=[], help="filter by type")
    p.add_argument(
        "--before", default="", help="created before (YYYY-MM-DD[ HH:MM:SS])"
    )
    p.add_argument(
        "--after", default="", help="created after (YYYY-MM-DD[ HH:MM:SS])"
    )
    p.add_argument("-n", "--limit", type=int, default=0)
    p.set_defaults(func=tasks_cmd)


def _parse_when(text: str) -> float | None:
    """YYYY-MM-DD[ HH:MM:SS] → epoch seconds (local time)."""
    if not text:
        return None
    for fmt in ("%Y-%m-%d %H:%M:%S", "%Y-%m-%d"):
        try:
            return time.mktime(time.strptime(text, fmt))
        except ValueError:
            continue
    raise ValueError(
        f"cannot parse time {text!r}; use YYYY-MM-DD or 'YYYY-MM-DD HH:MM:SS'"
    )


def tasks_cmd(args) -> int:
    # validate the date flags before spinning up an engine
    before, after = _parse_when(args.before), _parse_when(args.after)
    engine = _engine(args)
    try:
        tasks = engine.tasks(
            states=args.state or None,
            types=args.type or None,
            before=before,
            after=after,
            limit=args.limit,
        )
        # ID / DATE / PLAN:CASE / QUEUED / DURATION / STATE / TYPE / PRE +
        # outcome — the reference's columns (tasks.go:50-54, plus the
        # queue-wait and preemption columns)
        for t in tasks:
            created = time.strftime(
                "%Y-%m-%d %H:%M:%S", time.localtime(t.created())
            )
            preemptions = int(t.trace.get("preemptions", 0) or 0)
            print(
                f"{t.id}  {created}  {t.name():24}  "
                f"{t.queued_secs():6.1f}s  {t.took():7.1f}s  "
                f"{t.state().state.value:10}  {t.type.value:5}  "
                f"{preemptions:3}  "
                f"{t.outcome().value}"
            )
        return 0
    finally:
        engine.stop()


def register_stats(sub) -> None:
    p = sub.add_parser(
        "stats",
        help="show a completed task's sim telemetry summary "
        "(message flow, latency, timings, memory — docs/OBSERVABILITY.md)",
    )
    p.add_argument("task", help="task id")
    p.add_argument(
        "--json",
        action="store_true",
        help="dump the raw stats payload as JSON (machine-readable; the "
        "same shape as GET /stats)",
    )
    p.add_argument(
        "-f",
        "--follow",
        action="store_true",
        help="follow the task live first (per-chunk telemetry + SLO "
        "breaches via GET /stream, like `tg logs -f`), then print the "
        "final summary table",
    )
    p.set_defaults(func=stats_cmd)


def stats_cmd(args) -> int:
    import json

    from ..client import RemoteEngine
    from ..runners.pretty import render_telemetry_summary

    engine = _engine(args)
    try:
        if getattr(args, "follow", False):
            # under --json the live view goes to stderr — stdout stays
            # the machine-readable payload (the --json contract)
            _follow_stream(
                engine,
                args.task,
                families=("telemetry", "slo", "spans"),
                out=sys.stderr if getattr(args, "json", False) else None,
            )
        if isinstance(engine, RemoteEngine):
            data = engine.task_stats(args.task)
        else:
            t = engine.get_task(args.task)
            if t is None:
                raise KeyError(f"unknown task {args.task}")
            data = t.stats_payload()
        if getattr(args, "json", False):
            print(json.dumps(data, indent=2, sort_keys=True))
        else:
            print(render_telemetry_summary(data))
        return 0
    finally:
        engine.stop()


def register_perf(sub) -> None:
    p = sub.add_parser(
        "perf",
        help="show a task's performance ledger (compile/execute split, "
        "peer·ticks/s, HBM high-water mark, XLA cost estimates — "
        "docs/OBSERVABILITY.md)",
    )
    p.add_argument("task", help="task id")
    p.add_argument(
        "--json",
        action="store_true",
        help="dump the raw perf payload as JSON (machine-readable; the "
        "same shape as GET /perf)",
    )
    p.add_argument(
        "--compare",
        default="",
        metavar="FILE",
        help="print throughput deltas against a baseline JSON file — a "
        "BENCH_rNN.json line, a prior `tg perf --json` dump, or a "
        "journal sim block (written to stderr under --json so stdout "
        "stays parseable)",
    )
    p.add_argument(
        "--phases",
        action="store_true",
        help="print the per-phase tick attribution table (flops/bytes "
        "per phase + residual + whole-program rows; requires the run "
        "to have recorded it — --run-cfg phases=true)",
    )
    p.add_argument(
        "--measure",
        action="store_true",
        help="with --phases: insist on the measured ms/tick calibration "
        "column (recorded with --run-cfg phases_measure=K) — prints a "
        "hint when the run only holds the static cost rows",
    )
    p.add_argument(
        "-f",
        "--follow",
        action="store_true",
        help="follow the task live first (per-chunk throughput rows + "
        "SLO breaches via GET /stream, like `tg logs -f`), then print "
        "the final ledger table",
    )
    p.set_defaults(func=perf_cmd)


def perf_cmd(args) -> int:
    import json

    from ..client import RemoteEngine
    from ..runners.pretty import render_perf_summary
    from ..sim.perf import perf_compare

    engine = _engine(args)
    try:
        if getattr(args, "follow", False):
            _follow_stream(
                engine,
                args.task,
                families=("perf", "slo", "spans"),
                out=sys.stderr if getattr(args, "json", False) else None,
            )
        if isinstance(engine, RemoteEngine):
            data = engine.task_perf(args.task)
        else:
            t = engine.get_task(args.task)
            if t is None:
                raise KeyError(f"unknown task {args.task}")
            data = t.perf_payload()
        if getattr(args, "json", False):
            print(json.dumps(data, indent=2, sort_keys=True))
        else:
            print(render_perf_summary(data))
        if getattr(args, "phases", False):
            from ..runners.pretty import render_phase_table

            # with --json, stdout stays the parseable payload (the
            # phases block is inside it) — the table goes to stderr
            out = sys.stderr if getattr(args, "json", False) else sys.stdout
            print("-- phases --", file=out)
            print(render_phase_table(data), file=out)
            if getattr(args, "measure", False):
                # same block resolution as render_phase_table (top-level
                # payload or journal sim shape) — the hint and the table
                # must never disagree about the same payload
                block = (
                    data.get("phases")
                    or (data.get("sim") or {}).get("phases")
                    or {}
                )
                rows = block.get("phases") or []
                if not any(
                    isinstance(r, dict) and r.get("measured_ms") is not None
                    for r in rows
                ):
                    print(
                        "no measured calibration recorded — re-run with "
                        "--run-cfg phases=true phases_measure=30 for "
                        "measured ms/tick per phase",
                        file=out,
                    )
        if getattr(args, "compare", ""):
            with open(args.compare) as f:
                # BENCH_rNN.json files are one JSON object per line
                # (possibly with comment noise) — take the LAST line
                # that parses (the newest round, matching the bench
                # tail unwrapping in sim/perf.py); a whole-file JSON
                # document also parses
                text = f.read()
            try:
                baseline = json.loads(text)
            except ValueError:
                baseline = None
                for line in reversed(text.splitlines()):
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        baseline = json.loads(line)
                        break
                    except ValueError:
                        continue
                if baseline is None:
                    raise ValueError(
                        f"{args.compare} holds no parseable JSON"
                    ) from None
            # with --json, stdout is the machine-readable payload — the
            # human-facing delta lines go to stderr so `| jq` keeps working
            out = sys.stderr if getattr(args, "json", False) else sys.stdout
            label = os.path.basename(args.compare)
            print(f"-- vs {label} --", file=out)
            for line in perf_compare(data, baseline, label=label):
                print(line, file=out)
        return 0
    finally:
        engine.stop()


def register_trace(sub) -> None:
    p = sub.add_parser(
        "trace",
        help="show a task's flight-recorder events (per-instance "
        "message-lifecycle timeline — docs/OBSERVABILITY.md); enable "
        "recording with [global.run.trace] / [groups.run.trace]",
    )
    p.add_argument("task", help="task id")
    p.add_argument(
        "-n",
        "--limit",
        type=int,
        default=0,
        help="print at most N events (default: all)",
    )
    p.add_argument(
        "--json",
        action="store_true",
        help="dump the raw events as JSON lines (the sim_trace.jsonl "
        "rows) instead of the aligned timeline",
    )
    p.add_argument(
        "--lifecycle",
        action="store_true",
        help="render the task's causal lifecycle span tree "
        "(task_spans.jsonl: submit → queued → claim → execute → run "
        "spans) instead of the flight-recorder timeline; the sibling "
        "task_trace.json opens in Perfetto",
    )
    p.set_defaults(func=trace_cmd)


def _render_trace_event(ev: dict) -> str:
    kind = ev.get("event", "?")
    who = f"{ev.get('group', '?')}/i{ev.get('instance', '?')}"
    if kind == "status":
        what = f"status {ev.get('prev', '?')} → {ev.get('status', '?')}"
    elif kind == "signal":
        what = f"signal state {ev.get('state', '?')}"
    elif kind == "send":
        what = f"send → i{ev.get('dst', '?')} ({ev.get('fate', '?')})"
    elif kind == "deliver":
        what = f"deliver ← i{ev.get('src', '?')}"
    else:
        what = kind
    return f"t={ev.get('tick', '?'):>6}  {who:<16}  {what}"


def trace_cmd(args) -> int:
    import json

    from ..client import RemoteEngine

    engine = _engine(args)
    try:
        if getattr(args, "lifecycle", False):
            return _trace_lifecycle(engine, args)
        if isinstance(engine, RemoteEngine):
            data = engine.task_trace(args.task, limit=args.limit)
            summary, events = data.get("trace", {}), data.get("events", [])
        else:
            t = engine.get_task(args.task)
            if t is None:
                raise KeyError(f"unknown task {args.task}")
            from ..sim.trace import read_trace_events

            journal = (
                t.result.get("journal", {})
                if isinstance(t.result, dict)
                else {}
            )
            summary = journal.get("trace", {})
            events = read_trace_events(
                engine.env.dirs.outputs(), t.plan, t.id, limit=args.limit
            )
        if not summary and not events:
            # same message AND exit code with or without --json — a CI
            # pipe must not read an empty stream as a recorded trace
            print(
                f"no flight-recorder trace for task {args.task} — enable "
                "it with [global.run.trace] in the composition "
                "(docs/OBSERVABILITY.md)",
                file=sys.stderr,
            )
            return 1
        if isinstance(engine, RemoteEngine) and data.get("truncated"):
            print(
                f"warning: daemon capped the response at "
                f"{data.get('limit')} events — fetch the full stream "
                "via GET /artifact?name=sim_trace.jsonl",
                file=sys.stderr,
            )
        if getattr(args, "json", False):
            for ev in events:
                print(json.dumps(ev))
            return 0
        print(
            "trace: {e} event(s) from {i} instance(s)".format(
                e=summary.get("events", len(events)),
                i=summary.get("instances", "?"),
            )
            + (
                f" — {summary['events_file']} loads in Perfetto"
                if summary.get("events_file")
                else ""
            )
        )
        for ev in events:
            print(_render_trace_event(ev))
        return 0
    finally:
        engine.stop()


def _trace_lifecycle(engine, args) -> int:
    """``tg trace <task> --lifecycle``: load the archived lifecycle span
    tree (task_spans.jsonl — engine/tracetree.py) and render it as an
    indented tree; --json dumps the raw span rows. Works identically
    in-process (outputs dir) and remote (GET /artifact)."""
    import json

    from ..client import RemoteEngine
    from ..engine.tracetree import (
        TASK_SPANS_FILE,
        load_task_spans,
    )
    from ..runners.pretty import render_lifecycle_tree

    if isinstance(engine, RemoteEngine):
        try:
            raw = engine.task_artifact(args.task, TASK_SPANS_FILE)
        except Exception as e:  # noqa: BLE001 — 404 → readable hint below
            raw = b""
            reason = f" ({e})"
        else:
            reason = ""
        spans = []
        for line in raw.decode(errors="replace").splitlines():
            try:
                spans.append(json.loads(line))
            except ValueError:
                continue
    else:
        t = engine.get_task(args.task)
        if t is None:
            raise KeyError(f"unknown task {args.task}")
        reason = ""
        spans = load_task_spans(
            os.path.join(
                engine.env.dirs.outputs(), t.plan, t.id, TASK_SPANS_FILE
            )
        )
    if not spans:
        # same message AND exit code with or without --json, like the
        # flight-recorder branch above
        print(
            f"no lifecycle trace for task {args.task}{reason} — the span "
            "tree is assembled when the task archives "
            "(docs/OBSERVABILITY.md 'Control plane')",
            file=sys.stderr,
        )
        return 1
    if getattr(args, "json", False):
        for s in spans:
            print(json.dumps(s))
        return 0
    print(render_lifecycle_tree(spans))
    return 0


# ------------------------------------------------------------------ watch


def _breach_line(row: dict, color: bool) -> str:
    """One highlighted SLO-breach line (the run health plane's live
    surface — docs/OBSERVABILITY.md "Run health plane")."""
    sev = row.get("severity", "warn")
    text = (
        f"!! SLO breach ({sev}) {row.get('rule', '?')}: "
        f"{row.get('metric', '?')} = {row.get('observed', '?')} "
        f"violates {row.get('op', '?')} {row.get('threshold', '?')} "
        f"at tick {row.get('tick', '?')}"
    )
    if color:
        code = "\033[31;1m" if sev == "fail" else "\033[33m"
        return f"{code}{text}\033[0m"
    return text


def _follow_stream(engine, task_id: str, families, out=None, follow=True) -> None:
    """Follow a task's observability stream and render one line per
    chunk (plus immediate SLO-breach lines) until the task finishes —
    the shared live view behind ``tg watch``, ``tg stats -f`` and
    ``tg perf -f``. ``families`` must include ``spans`` for the chunk
    clock unless ``perf`` rows (one per chunk) are streamed; with
    ``follow=False`` (``tg watch --no-follow``) one replay sweep of
    what exists is rendered instead of waiting for the task."""
    from ..sim.netmatrix import NM_MSG_BYTES
    from ..sim.perf import fmt_rate, num

    out = out or sys.stdout
    color = hasattr(out, "isatty") and out.isatty()
    use_spans_clock = "spans" in families
    header = (
        f"{'tick':>8}  {'wall':>8}  {'ticks/s':>9}  {'peer·t/s':>9}"
        f"  {'delivered':>9}  {'dropped':>8}  {'in-flight':>9}"
        f"  {'infl-KiB':>8}  breaches"
    )
    printed_header = False
    # telemetry deltas accumulated since the last chunk line
    acc = {"delivered": 0, "dropped": 0, "fault_dropped": 0}
    last_tele: dict = {}
    last_perf: dict = {}
    breaches = 0

    def chunk_line(tick, wall) -> str:
        d = acc["delivered"]
        x = acc["dropped"] + acc["fault_dropped"]
        acc.update(delivered=0, dropped=0, fault_dropped=0)
        # in-flight wire bytes: calendar occupancy × the fixed message
        # size (the traffic matrix's bytes accounting) — "?" when the
        # telemetry row has no finite depth yet
        depth = num(last_tele.get("cal_depth"))
        infl = f"{depth * NM_MSG_BYTES / 1024:.1f}" if depth is not None else "?"
        return (
            f"{tick:>8}  {wall:>8.2f}  "
            f"{fmt_rate(last_perf.get('ticks_per_sec')):>9}  "
            f"{fmt_rate(last_perf.get('peer_ticks_per_sec')):>9}  "
            f"{d:>9}  {x:>8}  "
            f"{last_tele.get('cal_depth', '?'):>9}  {infl:>8}  {breaches}"
        )

    for row in engine.stream_rows(
        task_id, follow=follow, families=families
    ):
        if not row:
            continue  # heartbeat / blank keepalive
        fam = row.get("stream")
        if fam == "telemetry":
            for k in acc:
                acc[k] += int(row.get(k, 0) or 0)
            last_tele = row
        elif fam == "perf":
            last_perf = row
            if not use_spans_clock:  # perf rows ARE the chunk clock
                if not printed_header:
                    printed_header = True
                    print(header, file=out)
                print(
                    chunk_line(
                        row.get("tick", "?"), row.get("wall_secs", 0.0)
                    ),
                    file=out,
                )
        elif fam == "slo":
            breaches += 1
            print(_breach_line(row, color), file=out)
        elif fam == "spans":
            ev = row.get("event") or {}
            span, typ = ev.get("span"), ev.get("type")
            if typ == "point" and span == "chunk" and use_spans_clock:
                if not printed_header:
                    printed_header = True
                    print(header, file=out)
                print(
                    chunk_line(
                        ev.get("ticks", "?"), ev.get("wall_secs", 0.0)
                    ),
                    file=out,
                )
            elif typ == "span_start" and span == "run":
                run = row.get("run", "")
                tag = f" [{run}]" if run and run != task_id else ""
                print(f"-- run started{tag} --", file=out)
            elif typ == "span_end" and span == "run":
                print(
                    "-- run finished: outcome "
                    f"{ev.get('outcome', ev.get('error', '?'))} --",
                    file=out,
                )
        try:
            out.flush()
        except OSError:
            pass


def register_watch(sub) -> None:
    p = sub.add_parser(
        "watch",
        help="live one-row-per-chunk view of a task (telemetry deltas, "
        "throughput, SLO-breach highlighting), across the queued→"
        "running→done lifecycle — docs/OBSERVABILITY.md 'Run health "
        "plane'",
    )
    p.add_argument("task", help="task id")
    p.add_argument(
        "--json",
        action="store_true",
        help="dump the raw ndjson rows (the GET /stream payload) "
        "instead of the rendered view",
    )
    p.add_argument(
        "--no-follow",
        action="store_true",
        help="replay what exists and exit instead of waiting for the "
        "task to finish",
    )
    p.set_defaults(func=watch_cmd)


def watch_cmd(args) -> int:
    import json

    engine = _engine(args)
    try:
        follow = not getattr(args, "no_follow", False)
        if getattr(args, "json", False):
            for row in engine.stream_rows(args.task, follow=follow):
                print(json.dumps(row))
                sys.stdout.flush()
        else:
            if follow:
                print(f"watching task {args.task} (ctrl-c to stop)")
            _follow_stream(
                engine,
                args.task,
                families=("telemetry", "perf", "slo", "spans"),
                follow=follow,
            )
            if follow:
                t = engine.get_task(args.task)
                if t is not None:
                    print(
                        f"task {args.task}: outcome {t.outcome().value}"
                    )
        return 0
    finally:
        engine.stop()


def register_netmap(sub) -> None:
    p = sub.add_parser(
        "netmap",
        help="show a task's group-to-group traffic matrix (sent heatmap, "
        "lossy pairs, link-shaping observables) and recommend a "
        "cross-traffic-minimizing group partition with --cut — "
        "docs/OBSERVABILITY.md 'Traffic matrix'; record with "
        "--run-cfg telemetry=true netmatrix=true",
    )
    p.add_argument("task", help="task id")
    p.add_argument(
        "--json",
        action="store_true",
        help="dump the raw sim.net_matrix journal block as JSON "
        "(machine-readable; the same shape as in GET /stats)",
    )
    p.add_argument(
        "-f",
        "--follow",
        action="store_true",
        help="follow the per-chunk matrix deltas live first (the "
        "netmatrix family of GET /stream), then print the final "
        "heatmap",
    )
    p.add_argument(
        "--cut",
        type=int,
        default=0,
        metavar="N",
        help="recommend a balanced N-shard group partition minimizing "
        "cross-cut traffic bytes (measured, not guessed — the "
        "instance-axis → mesh-axis placement advisor)",
    )
    p.set_defaults(func=netmap_cmd)


def netmap_cmd(args) -> int:
    import json

    from ..client import RemoteEngine
    from ..runners.pretty import (
        render_netmap,
        render_netmap_cut,
    )

    engine = _engine(args)
    try:
        as_json = bool(getattr(args, "json", False))
        # under --json every human-facing line goes to stderr — stdout
        # stays the machine-readable payload (the --json contract)
        hout = sys.stderr if as_json else sys.stdout
        if getattr(args, "follow", False):
            print(
                f"following task {args.task} traffic deltas "
                "(ctrl-c to stop)",
                file=hout,
            )
            for row in engine.stream_rows(
                args.task, follow=True, families=("netmatrix",)
            ):
                if not row or row.get("stream") != "netmatrix":
                    continue
                cells = row.get("cells") or []
                sent = sum(
                    int(c[2]) for c in cells if len(c) > 2
                )
                lost = sum(
                    int(c[5]) + int(c[6]) + int(c[7])
                    for c in cells
                    if len(c) > 7
                )
                line = (
                    f"tick {row.get('tick', '?'):>8}  "
                    f"{len(cells)} active pair(s)  sent {sent}"
                )
                if lost:
                    line += f"  LOST {lost}"
                print(line, file=hout)
                try:
                    hout.flush()
                except OSError:
                    pass
        if isinstance(engine, RemoteEngine):
            data = engine.task_stats(args.task)
        else:
            t = engine.get_task(args.task)
            if t is None:
                raise KeyError(f"unknown task {args.task}")
            data = t.stats_payload()
        block = (data.get("sim") or {}).get("net_matrix") or {}
        if as_json:
            print(json.dumps(block, indent=2, sort_keys=True))
        if not block:
            print(
                "no traffic matrix recorded for this task — run with "
                "--run-cfg telemetry=true netmatrix=true (cohorts and "
                "disable_metrics run matrix-free)",
                file=hout,
            )
            return 1
        if not as_json:
            ident = (
                f"{data.get('plan', '?')}:{data.get('case', '?')}"
                f"  ({args.task})"
            )
            print(render_netmap(block, ident))
        if getattr(args, "cut", 0):
            import numpy as np

            from ..sim.netmatrix import (
                cut_advisor,
                matrix_bytes,
            )

            mat = np.asarray(block.get("matrix") or [], np.int64)
            rec = cut_advisor(
                matrix_bytes(mat),
                int(args.cut),
                labels=block.get("labels") or None,
            )
            print("", file=hout)
            print(render_netmap_cut(rec, int(args.cut)), file=hout)
        return 0
    finally:
        engine.stop()


def register_diff(sub) -> None:
    p = sub.add_parser(
        "diff",
        help="differential run analysis of two tasks: deterministic "
        "counters compared exactly (a mismatch between identically-"
        "seeded runs is a correctness finding), throughput judged "
        "from per-chunk samples with noise-robust statistics "
        "(median ratio + Mann-Whitney U) — docs/OBSERVABILITY.md "
        "'Run diff'. Exit 1 on correctness findings.",
    )
    p.add_argument("task_a", help="baseline task id (A)")
    p.add_argument("task_b", help="candidate task id (B)")
    p.add_argument(
        "--planes",
        default="",
        metavar="P1,P2",
        help="comma-separated plane subset "
        "(counters,perf,latency,phases,slo,netmatrix; default all)",
    )
    p.add_argument(
        "--json",
        action="store_true",
        help="dump the full RunDiff document as JSON (machine-readable; "
        "the same shape as GET /diff)",
    )
    p.set_defaults(func=diff_cmd)


def diff_cmd(args) -> int:
    import json

    from ..analysis.diff import validate_planes
    from ..runners.pretty import render_run_diff

    # validate the plane selection client-side so an unknown plane is
    # the same usage error (exit 2) in-process and remote — a daemon
    # 400 would otherwise surface as a generic DaemonError (exit 1)
    try:
        validate_planes(args.planes or None)
    except ValueError as e:
        print(f"tg diff: {e}", file=sys.stderr)
        return 2
    engine = _engine(args)
    try:
        # in-process and remote engines expose the same diff_tasks verb
        # (the document is always built by Engine.diff_tasks — ONE
        # comparison codepath, daemon-side when remote)
        try:
            doc = engine.diff_tasks(
                args.task_a, args.task_b, planes=args.planes or None
            )
        except ValueError as e:  # unknown plane — usage error
            print(f"tg diff: {e}", file=sys.stderr)
            return 2
        if getattr(args, "json", False):
            print(json.dumps(doc, indent=2, sort_keys=True))
        else:
            print(render_run_diff(doc))
        # correctness findings gate (exit 1); perf verdicts inform but
        # never fail `tg diff` itself — the bench sentinel gates perf
        return 1 if doc.get("findings") else 0
    finally:
        engine.stop()


def register_top(sub) -> None:
    p = sub.add_parser(
        "top",
        help="live fleet view: worker occupancy, queue depth, per-state "
        "task counts over the FULL store, and one row per queued/"
        "running task (GET /fleet — docs/OBSERVABILITY.md 'Control "
        "plane')",
    )
    p.add_argument(
        "--json",
        action="store_true",
        help="dump the raw fleet payload as ndjson (one object per "
        "refresh) instead of the rendered view",
    )
    p.add_argument(
        "--no-follow",
        action="store_true",
        help="print one snapshot and exit instead of refreshing",
    )
    p.add_argument(
        "-i",
        "--interval",
        type=float,
        default=2.0,
        help="refresh interval in seconds (default: 2)",
    )
    p.set_defaults(func=top_cmd)


def top_cmd(args) -> int:
    import json

    from ..runners.pretty import render_fleet

    engine = _engine(args)
    try:
        follow = not getattr(args, "no_follow", False)
        interval = max(0.1, getattr(args, "interval", 2.0))
        clear = follow and sys.stdout.isatty() and not args.json
        while True:
            payload = engine.fleet_payload()
            if getattr(args, "json", False):
                print(json.dumps(payload, sort_keys=True))
            else:
                if clear:
                    # home + clear-to-end, not full clear: no flicker
                    sys.stdout.write("\033[H\033[J")
                print(render_fleet(payload))
            sys.stdout.flush()
            if not follow:
                return 0
            time.sleep(interval)
    finally:
        engine.stop()


# ------------------------------------------------------------------- plan


def register_plan(sub) -> None:
    p = sub.add_parser("plan", help="manage test plans in $TESTGROUND_HOME/plans")
    p.set_defaults(func=_help_func(p))
    psub = p.add_subparsers(dest="plan_mode")

    pl = psub.add_parser("list", help="list known plans")
    pl.add_argument("--testcases", action="store_true", help="also list testcases")
    pl.set_defaults(func=plan_list_cmd)

    pi = psub.add_parser("import", help="import a plan directory or git repo")
    pi.add_argument(
        "--from",
        dest="source",
        required=True,
        help="source dir, or a git URL with --git",
    )
    pi.add_argument("--name", default="", help="rename the plan on import")
    pi.add_argument(
        "--git",
        action="store_true",
        help="git-clone the source (any scheme git supports)",
    )
    pi.add_argument(
        "--force", action="store_true", help="overwrite an existing plan"
    )
    pi.set_defaults(func=plan_import_cmd)

    pr = psub.add_parser("rm", help="remove an imported plan")
    pr.add_argument("plan")
    pr.set_defaults(func=plan_rm_cmd)

    pc = psub.add_parser(
        "create", help="scaffold a new plan (an exec:py plan on local:exec)"
    )
    pc.add_argument("plan")
    pc.set_defaults(func=plan_create_cmd)


def plan_list_cmd(args) -> int:
    env = EnvConfig.load()
    root = env.dirs.plans()
    for name in sorted(os.listdir(root)) if os.path.isdir(root) else []:
        manifest_path = os.path.join(root, name, "manifest.toml")
        if not os.path.isfile(manifest_path):
            continue
        print(name)
        if args.testcases:
            m = TestPlanManifest.load_file(manifest_path)
            for tc in m.testcases:
                print(f"  {name}:{tc.name}")
    return 0


def plan_import_cmd(args) -> int:
    env = EnvConfig.load()
    tmp_ctx = None
    try:
        if args.git:
            # clone through the git binary — any scheme git supports, like
            # the reference's go-git clone path (``plan.go:210-214``) —
            # into a tempdir, then fall through to the shared import tail
            # so validation happens BEFORE any existing plan is replaced
            import subprocess
            import tempfile

            name = args.name or os.path.basename(
                args.source.rstrip("/").removesuffix(".git")
            )
            if name in ("", ".", ".."):
                raise ValueError(
                    f"cannot derive a plan name from {args.source!r}; "
                    "pass --name"
                )
            tmp_ctx = tempfile.TemporaryDirectory(dir=env.dirs.work())
            src = os.path.join(tmp_ctx.name, "clone")
            res = subprocess.run(
                ["git", "clone", "--depth", "1", args.source, src],
                capture_output=True,
                text=True,
            )
            if res.returncode != 0:
                raise RuntimeError(f"git clone failed: {res.stderr.strip()}")
        else:
            name = args.name or os.path.basename(
                os.path.abspath(args.source).rstrip("/")
            )
            src = os.path.abspath(args.source)
        if not os.path.isfile(os.path.join(src, "manifest.toml")):
            raise FileNotFoundError(
                f"{args.source} has no manifest.toml at its root"
            )
        endpoint = _endpoint(args, env)
        if endpoint:
            from ..client import Client

            name = Client(endpoint, token=env.client.token).import_plan(
                src, name=name
            )
            print(f"imported plan {name} into daemon at {endpoint}")
            return 0
        dest = os.path.join(env.dirs.plans(), name)
        if os.path.exists(dest):
            if not args.force:
                raise FileExistsError(
                    f"plan {name} already exists at {dest}; "
                    "pass --force to replace"
                )
            shutil.rmtree(dest)
        shutil.copytree(
            src, dest, ignore=shutil.ignore_patterns("__pycache__", ".git")
        )
        print(f"imported plan {name} -> {dest}")
        return 0
    finally:
        if tmp_ctx is not None:
            tmp_ctx.cleanup()


def plan_rm_cmd(args) -> int:
    env = EnvConfig.load()
    dest = os.path.join(env.dirs.plans(), args.plan)
    if not os.path.isdir(dest):
        raise FileNotFoundError(f"no such plan: {args.plan}")
    shutil.rmtree(dest)
    print(f"removed plan {args.plan}")
    return 0


# the reference's scaffold, importing the port's plan SDK
_PLAN_TEMPLATE = '''"""{name}: a testground-tpu plan."""

from testground_tpu_torch.sdk import invoke_map


def ok(runenv):
    runenv.record_message("hello from {name}")


if __name__ == "__main__":
    invoke_map({{"ok": ok}})
'''

_MANIFEST_TEMPLATE = """name = "{name}"

[defaults]
builder = "exec:py"
runner = "local:exec"

[builders."exec:py"]
enabled = true

[runners."local:exec"]
enabled = true

[[testcases]]
name = "ok"
instances = {{ min = 1, max = 100, default = 1 }}
"""


def plan_create_cmd(args) -> int:
    env = EnvConfig.load()
    dest = os.path.join(env.dirs.plans(), args.plan)
    if os.path.exists(dest):
        raise FileExistsError(f"plan {args.plan} already exists")
    os.makedirs(dest)
    with open(os.path.join(dest, "main.py"), "w") as f:
        f.write(_PLAN_TEMPLATE.format(name=args.plan))
    with open(os.path.join(dest, "manifest.toml"), "w") as f:
        f.write(_MANIFEST_TEMPLATE.format(name=args.plan))
    print(f"created plan {args.plan} at {dest}")
    return 0


# --------------------------------------------------------------- describe


def register_describe(sub) -> None:
    p = sub.add_parser("describe", help="describe a plan or test case")
    p.add_argument("plan", help="<plan> or <plan>:<case>")
    p.set_defaults(func=describe_cmd)


def describe_cmd(args) -> int:
    env = EnvConfig.load()
    plan, _, case = args.plan.partition(":")
    manifest = _resolve_manifest(env, args, plan)
    if case:
        tc = manifest.testcase_by_name(case)
        if tc is None:
            raise KeyError(f"test case {case} not found in plan {plan}")
        print(tc.describe())
    else:
        print(manifest.describe())
        for tc in manifest.testcases:
            print(tc.describe())
    return 0


def register_status(sub) -> None:
    p = sub.add_parser("status", help="get task status")
    p.add_argument("-t", "--task", required=True, help="task id")
    p.add_argument("--extended", action="store_true")
    p.add_argument(
        "--telemetry",
        action="store_true",
        help="also render the sim telemetry summary table",
    )
    p.set_defaults(func=status_cmd)


def status_cmd(args) -> int:
    engine = _engine(args)
    try:
        t = engine.get_task(args.task)
        if t is None:
            raise KeyError(f"unknown task {args.task}")
        print(f"ID:      {t.id}")
        print(f"Name:    {t.name()}")
        print(f"Type:    {t.type.value}")
        print(f"State:   {t.state().state.value}")
        print(f"Outcome: {t.outcome().value}")
        print(f"Queued:  {t.queued_secs():.1f}s")
        cb = t.created_by
        if cb.user or cb.repo or cb.branch or cb.commit:
            parts = [cb.user or "-"]
            if cb.repo or cb.branch:
                parts.append(f"{cb.repo}@{cb.branch}" if cb.branch else cb.repo)
            if cb.commit:
                parts.append(cb.commit[:12])
            print(f"By:      {' '.join(parts)}")
        if t.error:
            print(f"Error:   {t.error}")
        mj = (
            t.result.get("journal", {}).get("metrics")
            if isinstance(t.result, dict)
            else None
        )
        if mj:
            print("Metrics:")
            for gid, names in mj.items():
                for name, agg in names.items():
                    if agg.get("count"):
                        print(
                            f"  {gid}/{name}: mean={agg['mean']:.3f} "
                            f"min={agg['min']:.3f} max={agg['max']:.3f} "
                            f"n={agg['count']}"
                        )
        if getattr(args, "telemetry", False):
            from ..runners.pretty import render_telemetry_summary

            print("Telemetry:")
            summary = render_telemetry_summary(t.stats_payload())
            print("\n".join(f"  {line}" for line in summary.splitlines()))
        if args.extended:
            import json

            print(json.dumps(t.to_dict(), indent=2))
        return 0
    finally:
        engine.stop()


def register_logs(sub) -> None:
    p = sub.add_parser("logs", help="print task logs")
    p.add_argument("-t", "--task", required=True)
    p.add_argument("-f", "--follow", action="store_true")
    p.set_defaults(func=logs_cmd)


def logs_cmd(args) -> int:
    engine = _engine(args)
    try:
        for line in engine.logs(args.task, follow=args.follow):
            _print_chunk_line(line)
        return 0
    finally:
        engine.stop()


# ---------------------------------------------------------------- collect


def register_collect(sub) -> None:
    p = sub.add_parser("collect", help="collect run outputs into a tgz")
    p.add_argument("run_id")
    p.add_argument("--runner", default="local:exec")
    p.add_argument("-o", "--output", default="")
    p.set_defaults(func=collect_cmd)


def collect_cmd(args) -> int:
    engine = _engine(args)
    try:
        dest = args.output or f"{args.run_id}.tgz"
        _collect_to_file(engine, args.runner, args.run_id, dest)
        return 0
    finally:
        engine.stop()


# ------------------------------------------- healthcheck / terminate / misc


def register_healthcheck(sub) -> None:
    p = sub.add_parser("healthcheck", help="check a runner's environment")
    p.add_argument("--runner", required=True)
    p.add_argument("--fix", action="store_true")
    p.set_defaults(func=healthcheck_cmd)


def healthcheck_cmd(args) -> int:
    engine = _engine(args)
    try:
        ow = OutputWriter(sink=None, echo=sys.stdout)
        report = engine.do_healthcheck(args.runner, args.fix, ow)
        print(report)
        return 0 if report.ok() else 1
    finally:
        engine.stop()


def register_terminate(sub) -> None:
    p = sub.add_parser(
        "terminate",
        help="terminate all jobs and supporting processes of a runner or builder",
    )
    p.add_argument("--runner", default="")
    p.add_argument("--builder", default="")
    p.add_argument(
        "--drain",
        action="store_true",
        help="gracefully drain the daemon instead: stop claiming, "
        "checkpoint + requeue running runs (they resume on restart), "
        "cancel builds, then shut the daemon down",
    )
    p.set_defaults(func=terminate_cmd)


def register_preempt(sub) -> None:
    p = sub.add_parser(
        "preempt",
        help="checkpoint-and-requeue a running task at its next chunk "
        "boundary (the fleet controller's live-migration verb); a "
        "checkpointed run resumes bit-identically when re-claimed",
    )
    p.add_argument("task", help="task id")
    p.set_defaults(func=preempt_cmd)


def preempt_cmd(args) -> int:
    """``tg preempt <task>`` (``commands.py:2013-2040``)."""
    engine = _engine(args)
    try:
        res = engine.preempt(args.task)
        if not res.get("ok"):
            print(f"preempt refused: {res.get('error', 'unknown')}", file=sys.stderr)
            return 1
        if res.get("queued"):
            print(f"task {args.task} is still queued — nothing to preempt")
        else:
            print(f"task {args.task} will checkpoint and requeue at its "
                  "next chunk boundary")
        return 0
    finally:
        engine.stop()


def terminate_cmd(args) -> int:
    if getattr(args, "drain", False):
        # the whole daemon (commands.py:2055-2085)
        if args.runner or args.builder:
            print("--drain drains the whole daemon; it takes no "
                  "--runner/--builder", file=sys.stderr)
            return 1
        engine = _engine(args)
        try:
            res = engine.drain()
            print(
                "daemon drained: {drained} worker(s) idle, "
                "{preempted} task(s) preempted, "
                "{canceled} build(s) canceled".format(
                    drained=res.get("drained"),
                    preempted=res.get("preempted", 0),
                    canceled=res.get("canceled", 0),
                )
            )
            return 0 if res.get("drained") else 1
        finally:
            engine.stop()
    # one component at a time, like the reference (terminate.go:38-45)
    if bool(args.runner) == bool(args.builder):
        print("specify exactly one of --runner or --builder", file=sys.stderr)
        return 1
    engine = _engine(args)
    try:
        ow = OutputWriter(sink=None, echo=sys.stdout)
        if args.runner:
            engine.do_terminate(args.runner, ow, ctype="runner")
        else:
            engine.do_terminate(args.builder, ow, ctype="builder")
        return 0
    finally:
        engine.stop()


def register_daemon(sub) -> None:
    p = sub.add_parser("daemon", help="run the testground daemon")
    p.add_argument(
        "--listen",
        default="",
        help="listen address host:port (default: .env.toml daemon.listen "
        "or localhost:8042)",
    )
    p.set_defaults(func=daemon_cmd)


def daemon_cmd(args) -> int:
    from ..daemon.server import serve

    return serve(listen=args.listen)


def register_sync_service(sub) -> None:
    p = sub.add_parser(
        "sync-service",
        help="run a standalone network-reachable sync service (the "
        "shared coordination plane of a cross-host local:exec run — "
        "docs/CROSSHOST.md); prints 'LISTENING <host> <port>' once "
        "bound and serves until SIGTERM",
    )
    p.add_argument(
        "--host",
        default="127.0.0.1",
        help="bind address (0.0.0.0 serves other hosts; default loopback)",
    )
    p.add_argument(
        "--port", type=int, default=0, help="bind port (0 = ephemeral)"
    )
    p.add_argument(
        "--backend",
        choices=("auto", "python", "native"),
        default="auto",
        help="native C++ event-loop server when a toolchain exists "
        "(auto), or force one implementation",
    )
    p.add_argument(
        "--idle-timeout",
        type=float,
        default=30.0,
        help="evict connections silent for this many seconds "
        "(heartbeating clients are never idle; 0 disables)",
    )
    p.add_argument(
        "--evict-grace",
        type=float,
        default=2.0,
        help="window an abnormally-disconnected instance has to "
        "reconnect before its eviction event is published",
    )
    p.add_argument(
        "--shards",
        type=int,
        default=0,
        help="event-loop shards (0 = backend auto: native picks "
        "min(4, cores), python runs one loop — docs/CROSSHOST.md "
        "'Server architecture')",
    )
    p.add_argument(
        "--metrics-port",
        type=int,
        default=-1,
        help="also serve a Prometheus text exposition of the tg_sync_* "
        "family at http://127.0.0.1:<port>/metrics (0 = ephemeral, "
        "printed; default off) — docs/OBSERVABILITY.md 'Sync plane'",
    )
    p.add_argument(
        "--stats-interval",
        type=float,
        default=60.0,
        help="log a one-line stats heartbeat (conns/waiters/subs/ops-"
        "per-sec) to stderr every N seconds so a detached service is "
        "debuggable from its log alone (0 disables; default 60)",
    )
    p.set_defaults(func=sync_service_cmd)


def sync_service_cmd(args) -> int:
    import threading

    from ..sync.boot import boot_sync_service
    from ..sync.server import serve_until_signal
    from ..sync.stats import (
        SyncMetricsExporter,
        run_stats_heartbeat,
    )

    try:
        svc = boot_sync_service(
            mode=args.backend,
            host=args.host,
            port=args.port,
            idle_timeout=args.idle_timeout,
            evict_grace=args.evict_grace,
            bin_dir=os.path.join(EnvConfig.load().dirs.work(), "bin"),
            log=lambda msg: print(msg, file=sys.stderr),
            shards=args.shards,
        )
    except Exception as e:  # noqa: BLE001 — boot failures exit readably
        print(f"sync-service: {e}", file=sys.stderr)
        return 1
    # the service binds args.host, but the sidecars dial it locally —
    # a wildcard bind is reachable on loopback
    local = ("127.0.0.1" if args.host in ("0.0.0.0", "") else args.host,
             svc.address[1])
    exporter = None
    if args.metrics_port >= 0:
        try:
            exporter = SyncMetricsExporter(
                local, port=args.metrics_port
            ).start()
            print(
                f"METRICS http://127.0.0.1:{exporter.port}/metrics",
                flush=True,
            )
        except OSError as e:
            print(f"sync-service: metrics port: {e}", file=sys.stderr)
            svc.stop()
            return 1
    hb_stop = threading.Event()
    if args.stats_interval > 0:
        threading.Thread(
            target=run_stats_heartbeat,
            args=(local, args.stats_interval, hb_stop),
            daemon=True,
            name="tg-sync-heartbeat",
        ).start()
    try:
        return serve_until_signal(svc)
    finally:
        hb_stop.set()
        if exporter is not None:
            exporter.stop()


def register_sync_stats(sub) -> None:
    p = sub.add_parser(
        "sync-stats",
        help="query a live sync service's stats plane: op counters + "
        "service-time percentiles, barrier fan-in timelines, pubsub "
        "depth, connection churn (docs/OBSERVABILITY.md 'Sync plane'); "
        "works against either backend, v1 or v2",
    )
    p.add_argument(
        "address",
        help="host:port of a running sync service (`tg sync-service` "
        "prints it as LISTENING; a local:exec run's service address is "
        "in the instances' SYNC_SERVICE_HOST/PORT env)",
    )
    p.add_argument(
        "--json",
        action="store_true",
        help="dump the raw sync_stats reply as JSON (machine-readable; "
        "the wire payload minus the correlation id)",
    )
    p.add_argument(
        "--timeout",
        type=float,
        default=5.0,
        help="connect + reply timeout in seconds",
    )
    p.add_argument(
        "--watch",
        type=float,
        default=0.0,
        metavar="N",
        help="refresh every N seconds (an operator's live view of a "
        "ramp without Prometheus; each refresh is the exporter's same "
        "one-shot fetch; Ctrl-C exits; under --json one payload line "
        "per refresh)",
    )
    p.add_argument(
        "--watch-count",
        type=int,
        default=0,
        help="stop after this many --watch refreshes (0 = until "
        "Ctrl-C; for scripting)",
    )
    p.set_defaults(func=sync_stats_cmd)


def sync_stats_cmd(args) -> int:
    import json
    import time

    from ..runners.pretty import render_sync_stats
    from ..sync.stats import fetch_sync_stats

    host, _, port = args.address.rpartition(":")
    if not host or not port.isdigit():
        print(
            f"sync-stats: expected <host>:<port>, got {args.address!r}",
            file=sys.stderr,
        )
        return 2
    watch = max(0.0, getattr(args, "watch", 0.0) or 0.0)
    as_json = getattr(args, "json", False)
    shown = 0
    while True:
        try:
            stats = fetch_sync_stats(host, int(port), timeout=args.timeout)
        except (OSError, ValueError) as e:
            print(
                f"sync-stats: sync service at {args.address} "
                f"unreachable: {e}",
                file=sys.stderr,
            )
            # one-shot: unreachable is an error; watching: a live ramp's
            # service may restart — keep watching unless it never answered
            if not watch or shown == 0:
                return 1
        else:
            if as_json:
                print(
                    json.dumps(
                        stats,
                        indent=None if watch else 2,
                        sort_keys=True,
                    ),
                    flush=True,
                )
            else:
                if watch and shown and sys.stdout.isatty():
                    print("\x1b[2J\x1b[H", end="")  # clear between frames
                header = (
                    f"--- {args.address} @ {time.strftime('%H:%M:%S')} "
                    f"(refresh {watch:g}s, Ctrl-C to exit) ---"
                )
                if watch:
                    print(header)
                print(render_sync_stats(stats), flush=True)
            shown += 1
        if not watch:
            return 0
        if args.watch_count and shown >= args.watch_count:
            return 0
        try:
            time.sleep(watch)
        except KeyboardInterrupt:
            return 0


def register_sim_worker(sub) -> None:
    p = sub.add_parser(
        "sim-worker",
        help="join a multi-process sim:torch cohort as a follower process "
        "(the cluster-node analog; the leader is the engine whose runner "
        "config sets coordinator_address)",
    )
    p.add_argument("--coordinator", required=True,
                   help="the cohort's coordinator host:port (process 0's store)")
    p.add_argument("--num-processes", type=int, required=True)
    p.add_argument("--process-id", type=int, required=True)
    p.add_argument(
        "--plans", default="",
        help="plans dir holding the same plan sources as the leader "
        "(default: $TESTGROUND_HOME/plans)",
    )
    p.add_argument("--once", action="store_true", help="exit after one job (tests)")
    p.add_argument(
        "--connect-attempts", type=int, default=3,
        help="bounded retries joining the coordinator (a worker commonly "
        "races the leader's startup)",
    )
    p.add_argument("--connect-timeout", type=float, default=60.0,
                   help="per-attempt coordinator join timeout in seconds")
    p.add_argument(
        "--device", default=None,
        help="this process's device (default: the card; 'cpu' runs the "
        "plain versions of the kernels, as the leader's device = \"cpu\")",
    )
    p.set_defaults(func=sim_worker_cmd)


def sim_worker_cmd(args) -> int:
    import json

    from ..sim.executor import _launch_counts, run_sim_worker

    plans_dir = args.plans or EnvConfig.load().dirs.plans()

    def on_result(spec, res, carry):
        # the digest of the whole carry gathered from every process, for a
        # harness to hold against the leader's ("multi-host: carry digest"
        # in its log), this process's kernel launches and its first
        # chunk's seconds
        print(f"sim-worker: run {spec['run_id']} carry digest {res['carry_digest']}, "
              f"launches {json.dumps(_launch_counts())}, "
              f"first chunk {res['compile_secs']:.3f} s", flush=True)

    # the wrapper turns a dead leader into a one-line clean exit
    return run_sim_worker(
        args.coordinator, args.num_processes, args.process_id, plans_dir,
        once=args.once, connect_attempts=args.connect_attempts,
        connect_timeout_secs=args.connect_timeout, device=args.device,
        on_result=on_result,
    )


def register_version(sub) -> None:
    sub.add_parser("version", help="print version")
