"""CLI command implementations — the port's copy of ``run composition``,
``run single``, ``healthcheck`` and ``version`` of the reference's
``testground_tpu/cli/commands.py`` (``pkg/cmd/{run,healthcheck}.go``).

A run is lowered and executed in this process (``engine/supervisor.py``),
its task log printed as it is written. The output phrasing matches the
reference's ("run is queued with ID", the task log, "finished run with
ID"), and so does the ``--result-file`` CSV. The flags that need the task
store or a daemon (``--endpoint``, ``--detach``, ``--collect``,
``--collect-file``, ``--priority``, ``--metadata-*``) and ``run resume``
are parsed and refused, naming the ROADMAP item that ports them: such a
user must not get a silent in-process run.
"""

from __future__ import annotations

import json
import os
import sys
import threading

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
from ..engine import Outcome, Task
from ..rpc import OutputWriter
from ..utils.conv import parse_key_values

ITEM_9E = ("ROADMAP queue 1 item 9e (the engine, the task queue and storage, "
           "the daemon and its client)")

# the last task this process ran, for in-process callers that read its
# result (main returns only the exit code); the task store is item 9e
LAST_TASK: Task | None = None

# --------------------------------------------------------------- plumbing


class _ConsoleSink:
    """A task log sink that prints each chunk as the reference's CLI prints
    a followed task log (``_print_chunk_line``): progress to stdout, the
    error chunk as ``error: …`` to stderr, the result chunk not at all."""

    def write(self, text: str) -> None:
        for line in text.splitlines():
            if not line.strip():
                continue
            chunk = json.loads(line)
            if chunk.get("t") == "p" and isinstance(chunk.get("p"), str):
                sys.stdout.write(chunk["p"])
            elif chunk.get("t") == "e" and chunk.get("e"):
                print(f"error: {chunk['e']['m']}", file=sys.stderr)

    def flush(self) -> None:
        sys.stdout.flush()


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
        f"plan {plan!r} not found (searched: {candidates}); copy the port's "
        "plan directory (testground_tpu_torch/plans/<plan>) into "
        "$TESTGROUND_HOME/plans"
    )


def _refuse_daemon_flags(args, env: EnvConfig) -> None:
    """Refuse every flag that needs the task store or a daemon."""
    endpoint = getattr(args, "endpoint", "") or env.client.endpoint
    if endpoint:
        raise NotImplementedError(
            f"daemon endpoint {endpoint!r}: the daemon is not ported yet: {ITEM_9E}"
        )
    for flag, attr in (
        ("--detach", "detach"),
        ("--collect", "collect"),
        ("--collect-file", "collect_file"),
        ("--priority", "priority"),
        ("--metadata-repo", "metadata_repo"),
        ("--metadata-branch", "metadata_branch"),
        ("--metadata-commit", "metadata_commit"),
    ):
        if getattr(args, attr, None):
            raise NotImplementedError(
                f"{flag} needs the task store or a daemon, which are not "
                f"ported yet: {ITEM_9E}"
            )


def _help_func(parser):
    """Default func for command groups invoked bare: print usage, exit 2."""

    def fn(args):
        parser.print_help()
        return 2

    return fn


def _add_daemon_flags(p) -> None:
    """The reference's queue and CI flags (``pkg/cmd/run.go:62-70``):
    parsed, and refused by :func:`_refuse_daemon_flags`."""
    p.add_argument("--priority", type=int, default=0,
                   help=f"queue priority (refused: {ITEM_9E})")
    p.add_argument("--metadata-repo", default="", help="source repo (refused)")
    p.add_argument("--metadata-branch", default="", help="source branch (refused)")
    p.add_argument("--metadata-commit", default="", help="source commit (refused)")
    p.add_argument("--detach", action="store_true",
                   help=f"queue and exit without waiting (refused: {ITEM_9E})")


# ------------------------------------------------------------------- run


def register_run(sub) -> None:
    p = sub.add_parser("run", help="(builds and) runs a composition or single test case")
    p.set_defaults(func=_help_func(p))
    psub = p.add_subparsers(dest="run_mode")

    pc = psub.add_parser("composition", help="run a composition file")
    pc.add_argument("-f", "--file", required=True, help="composition TOML file")
    pc.add_argument("--collect", action="store_true",
                    help=f"collect outputs after run (refused: {ITEM_9E})")
    pc.add_argument("--collect-file", default="",
                    help=f"write outputs tgz here (refused: {ITEM_9E})")
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
    _add_daemon_flags(pc)
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
    ps.add_argument("--collect", action="store_true",
                    help=f"collect outputs after run (refused: {ITEM_9E})")
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
    _add_daemon_flags(ps)
    ps.set_defaults(func=run_single_cmd)

    pr = psub.add_parser(
        "resume",
        help=f"resume a checkpointed run (refused: the task store is {ITEM_9E}, "
        "checkpoints ROADMAP queue 1 item 13)",
    )
    pr.add_argument("task", help="task id of the checkpointed run")
    pr.add_argument("--run-cfg", action="append", default=[])
    _add_daemon_flags(pr)
    pr.set_defaults(func=run_resume_cmd)


def run_resume_cmd(args) -> int:
    raise NotImplementedError(
        f"run resume reads the task store, which is not ported yet: {ITEM_9E}; "
        "checkpoints are ROADMAP queue 1 item 13"
    )


def run_composition_cmd(args) -> int:
    _refuse_daemon_flags(args, EnvConfig.load())
    comp = load_composition(args.file)
    if args.ignore_artifacts:
        for g in comp.groups:
            g.run.artifact = ""
    # validate before frame_for_runs so a bad composition is rejected even
    # when --run-ids selects a subset (run.go:157 → FrameForRuns)
    validate_for_run(comp)
    if args.run_ids:
        comp = comp.frame_for_runs(*args.run_ids.split(","))
    return _run(args, comp, write_artifacts_to=args.file if args.write_artifacts else "")


def run_single_cmd(args) -> int:
    """(``pkg/cmd/run.go`` runSingleCmd + createSingletonComposition)."""
    env = EnvConfig.load()
    _refuse_daemon_flags(args, env)
    plan, _, case = args.plan_case.partition(":")
    if not case:
        raise ValueError("expected <plan>:<case>")
    manifest = _resolve_plan(env, plan)[1]
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
    """Lower and execute ``comp`` in this process (the reference's queue,
    worker and wait, ``commands.py:374-496``), then report like the
    reference's CLI."""
    from ..engine.supervisor import Registry, new_run_task, process_task

    global LAST_TASK
    env = EnvConfig.load()
    engine = Registry.new_default(env)
    src_dir, manifest = _resolve_plan(env, comp.global_.plan)
    tsk = LAST_TASK = new_run_task(engine, comp, manifest, sources_dir=src_dir)
    print(f"run is queued with ID: {tsk.id}")
    process_task(engine, tsk, OutputWriter(sink=_ConsoleSink()), threading.Event())
    outcome = tsk.outcome()
    print(f"finished run with ID: {tsk.id} (outcome: {outcome.value})")

    # per-run breakdown for multi-[[runs]] compositions (run.go:281-336)
    run_results = tsk.result.get("runs", {}) if isinstance(tsk.result, dict) else {}
    for rid, rres in run_results.items():
        print(f"  run {rid}: outcome: {rres.get('outcome', Outcome.UNKNOWN.value)}")

    if write_artifacts_to and isinstance(tsk.result, dict):
        comp_out = tsk.result.get("composition")
        if comp_out:
            Composition.from_dict(comp_out).write_file(write_artifacts_to)
            print(f"wrote artifacts into composition {write_artifacts_to}")

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
                        f"{tsk.id}-{rid}",
                        tsk.name(),
                        rres.get("outcome", Outcome.UNKNOWN.value),
                        rres.get("error", ""),
                    ])
            else:
                w.writerow([tsk.id, tsk.name(), outcome.value, tsk.error])

    return 0 if outcome == Outcome.SUCCESS else 1


# ------------------------------------------------------------ healthcheck


def register_healthcheck(sub) -> None:
    p = sub.add_parser("healthcheck", help="check a runner's environment")
    p.add_argument("--runner", required=True)
    p.add_argument("--fix", action="store_true")
    p.set_defaults(func=healthcheck_cmd)


def healthcheck_cmd(args) -> int:
    from ..engine.supervisor import Registry

    env = EnvConfig.load()
    _refuse_daemon_flags(args, env)
    ow = OutputWriter(sink=None, echo=sys.stdout)
    report = Registry.new_default(env).do_healthcheck(args.runner, args.fix, ow)
    print(report)
    return 0 if report.ok() else 1


def register_version(sub) -> None:
    sub.add_parser("version", help="print version")
