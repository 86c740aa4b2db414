"""The port's ``tg`` CLI entry point — the reference's
``testground_tpu/cli/main.py`` with the verbs the port honours: ``run``,
``build``, ``tasks``, ``status``, ``logs``, ``collect``, ``healthcheck``,
``terminate``, ``preempt``, ``daemon``, ``sync-service``, ``sync-stats``,
``sim-worker``, ``check``, ``plan``, ``describe``, ``version``, and the
observability verbs ``stats``, ``perf``, ``trace``, ``watch``, ``netmap``, ``diff`` and
``top``. The engine runs in-process unless ``--endpoint`` points at a
daemon (the reference's client↔daemon hop is transport, not semantics);
either way a run goes through the task queue, a worker and the
``sim:torch`` runner:

    python -m testground_tpu_torch.cli run composition -f X.toml
    python -m testground_tpu_torch.cli daemon --listen 127.0.0.1:8042
    python -m testground_tpu_torch.cli --endpoint 127.0.0.1:8042 run ...
    python -m testground_tpu_torch.cli check X.toml [--json] [--trace-plans]
    python -m testground_tpu_torch.cli plan import --from DIR [--name N]
"""

from __future__ import annotations

import argparse
import sys

from .. import __version__
from ..logging_ import set_level


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tg-torch",
        description=(
            "testground-tpu's PyTorch/CUDA port: runs Testground compositions "
            "as a vectorized network simulation on one CUDA device"
        ),
    )
    p.add_argument("-v", "--verbose", action="store_true", help="verbose logging")
    p.add_argument(
        "--endpoint",
        default="",
        help="daemon endpoint (default: in-process engine)",
    )
    sub = p.add_subparsers(dest="command")

    from . import commands

    commands.register_run(sub)
    commands.register_build(sub)
    commands.register_tasks(sub)
    commands.register_status(sub)
    commands.register_stats(sub)
    commands.register_perf(sub)
    commands.register_trace(sub)
    commands.register_watch(sub)
    commands.register_netmap(sub)
    commands.register_diff(sub)
    commands.register_top(sub)
    commands.register_plan(sub)
    commands.register_describe(sub)
    commands.register_logs(sub)
    commands.register_collect(sub)
    commands.register_healthcheck(sub)
    commands.register_terminate(sub)
    commands.register_preempt(sub)
    commands.register_daemon(sub)
    commands.register_sync_service(sub)
    commands.register_sync_stats(sub)
    commands.register_sim_worker(sub)
    commands.register_check(sub)
    commands.register_version(sub)
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    if args.verbose:
        set_level("debug")
    if args.command is None:
        build_parser().print_help()
        return 0
    if args.command == "version":
        print(f"testground-tpu-torch {__version__}")
        return 0
    try:
        return args.func(args) or 0
    except KeyboardInterrupt:
        return 130
    except BrokenPipeError:
        # downstream pager/head closed the pipe; exit quietly
        try:
            sys.stdout.close()
        except Exception:  # noqa: BLE001
            pass
        return 0
    except Exception as e:  # noqa: BLE001 — CLI boundary
        print(f"error: {e}", file=sys.stderr)
        if args.verbose:
            raise
        return 1


if __name__ == "__main__":
    sys.exit(main())
