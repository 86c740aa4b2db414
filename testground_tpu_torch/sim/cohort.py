"""Killable cohort-leader child: multi-process runs survive member death.

Port of ``testground_tpu/sim/cohort.py``. The reference's cluster runner
fails a run cleanly when an instance pod dies (``cluster_k8s.go:696``
``watchRunPods``). A ``torch.distributed`` cohort cannot offer that
in-process: a process that joined the cohort keeps its process groups for
its life, a member's death poisons them, and their teardown may wait on
the dead member. An engine daemon that joined the cohort in-process would
be left with a broken group and no way to form a new one.

So the engine never joins the cohort. The leader half (process 0) runs in
a CHILD process this module spawns and supervises:

- parent → child (stdin, one JSON per line): ``{"job": {run_input, cfg,
  home, outputs}}``, ``{"cancel": true}``, ``{"shutdown": true}``;
- child → parent (stdout): the run's OutputWriter progress chunks
  verbatim, then one terminal line —
  ``{"t": "cohort_result", "result": ...}`` (run finished; cohort
  healthy, child keeps serving jobs),
  ``{"t": "cohort_error", "error": ...}`` (run failed before any program
  collective — e.g. the lockstep readiness-vote skip; cohort healthy), or
  ``{"t": "cohort_fatal", "error": ...}`` (a member died / the process
  group is poisoned; the child exits immediately WITHOUT tearing the
  group down, which could wait on the dead member).

On a fatal the parent fails the task with a readable error within seconds
of the death, marks the cohort generation broken, and stays alive — the
daemon keeps serving single-process runs, and a later cohort run spawns a
fresh child (every worker must be restarted too, as a lost pod fails the
reference's whole run).

The child runs the UNCHANGED ``execute_sim_run`` cohort path
(``cfg.isolate_cohort`` is stripped for the hop), so outputs layout and
journal are those of an in-process leader.
"""

from __future__ import annotations

import atexit
import dataclasses
import json
import os
import queue
import subprocess
import sys
import threading
import time

__all__ = [
    "CohortBrokenError",
    "CohortLeader",
    "run_in_cohort_child",
    "shutdown_leader_child",
]

# grace between asking the child to stop (cancel/shutdown) and killing it
_GRACE_SECS = 60.0


class CohortBrokenError(RuntimeError):
    """A cohort member died; the generation is unusable."""


class CohortLeader:
    """Parent-side handle on the long-lived leader child (one cohort
    generation). The child joins the cohort once and serves every
    subsequent cohort job."""

    def __init__(self):
        self._proc: subprocess.Popen | None = None
        self._key: tuple | None = None
        self._lock = threading.Lock()
        # lines arrive via a reader thread: a select()+readline() loop
        # would strand lines that coalesced into one pipe read inside the
        # TextIOWrapper buffer
        self._lines: queue.Queue | None = None

    # ------------------------------------------------------------ lifecycle

    def _ensure(self, cfg) -> subprocess.Popen:
        key = (cfg.coordinator_address, int(cfg.num_processes))
        if self._proc is not None and self._proc.poll() is None:
            if self._key != key:
                raise RuntimeError(
                    f"cohort leader already running for {self._key}; "
                    f"cannot also join {key} — one cohort per engine"
                )
            return self._proc
        self._proc = subprocess.Popen(
            [sys.executable, "-u", "-m", "testground_tpu_torch.sim.cohort"],
            stdin=subprocess.PIPE,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,  # gloo/torch chatter → log
            text=True,
        )
        self._key = key
        self._lines = queue.Queue()

        def pump(proc, lines):
            for line in proc.stdout:
                lines.put(line)

        threading.Thread(
            target=pump, args=(self._proc, self._lines), daemon=True,
            name="cohort-stdout",
        ).start()
        return self._proc

    def _send(self, proc, obj) -> None:
        proc.stdin.write(json.dumps(obj) + "\n")
        proc.stdin.flush()

    # ------------------------------------------------------------------ run

    def run(self, job, cfg, ow, cancel):
        from ..api import RunOutput
        from ..runners.result import Result

        with self._lock:
            proc = self._ensure(cfg)
            cfg_d = dataclasses.asdict(cfg)
            cfg_d["isolate_cohort"] = False  # the hop happens once
            env = job.env
            self._send(proc, {"job": {
                "run_input": job.to_dict(),
                "cfg": cfg_d,
                "home": getattr(getattr(env, "dirs", None), "home", "") or "",
                "outputs": env.dirs.outputs() if env is not None else "",
            }})
            lines = self._lines
            cancel_sent_at = None
            while True:
                if cancel.is_set() and cancel_sent_at is None:
                    try:
                        self._send(proc, {"cancel": True})
                    except OSError:
                        pass  # child gone — poll below reports it
                    cancel_sent_at = time.monotonic()
                if (
                    cancel_sent_at is not None
                    and time.monotonic() - cancel_sent_at > _GRACE_SECS
                ):
                    proc.kill()
                    raise CohortBrokenError(
                        "cohort did not stop within "
                        f"{_GRACE_SECS:.0f}s of cancellation — leader "
                        "child killed; restart the sim-workers to form a "
                        "new cohort"
                    )
                try:
                    line = lines.get(timeout=0.2)
                except queue.Empty:
                    # drain any already-queued lines before concluding
                    # the child is gone
                    if proc.poll() is not None and lines.empty():
                        raise CohortBrokenError(
                            "cohort leader child exited unexpectedly "
                            f"(code {proc.returncode}) — a cohort member "
                            "likely died mid-run and the process group "
                            "took the leader down; restart every "
                            "`tg sim-worker` to form a new cohort"
                        ) from None
                    continue
                msg = _parse(line)
                if msg is None:  # raw runtime chatter (gloo, torch warnings)
                    ow.write_progress(line)
                    continue
                t = msg.get("t")
                if t == "p":
                    ow.write_progress(msg.get("p", ""))
                elif t == "cohort_result":
                    return RunOutput(run_id=job.run_id,
                                     result=Result.from_dict(msg["result"]))
                elif t == "cohort_error":
                    raise RuntimeError(msg.get("error", "cohort run failed"))
                elif t == "cohort_fatal":
                    try:
                        proc.kill()
                    except OSError:
                        pass
                    raise CohortBrokenError(
                        "cohort member failure: "
                        + msg.get("error", "unknown")
                        + " — the run is aborted and this cohort "
                        "generation is unusable; restart every "
                        "`tg sim-worker` to form a new one"
                    )
                else:
                    ow.write_progress(line)

    # ------------------------------------------------------------- shutdown

    def shutdown(self) -> None:
        """Drain the cohort: the child broadcasts the shutdown sentinel to
        the workers, leaves the process group, and exits."""
        with self._lock:
            proc = self._proc
            self._proc = None
            if proc is None or proc.poll() is not None:
                return
            try:
                self._send(proc, {"shutdown": True})
                proc.wait(timeout=_GRACE_SECS)
            except (OSError, subprocess.TimeoutExpired):
                proc.kill()


def _parse(line: str):
    line = line.strip()
    if not line.startswith("{"):
        return None
    try:
        return json.loads(line)
    except ValueError:
        return None


_leader = CohortLeader()


def run_in_cohort_child(job, cfg, ow, cancel):
    """Module-level entry the executor delegates cohort runs to."""
    return _leader.run(job, cfg, ow, cancel)


def shutdown_leader_child() -> None:
    _leader.shutdown()


atexit.register(shutdown_leader_child)


# --------------------------------------------------------------------------
# child half (python -m testground_tpu_torch.sim.cohort)
# --------------------------------------------------------------------------

# error-text markers of a poisoned process group: a member died and
# collectives can never succeed again in this generation. The last two are
# gloo's words for a peer whose connection closed ("Connection closed by
# peer"; "Read error ...: Connection reset by peer").
_FATAL_MARKERS = (
    "gloo",
    "connection closed",
    "connection reset",
    "heartbeat",
    "coordination",
    "barrier",
    "preempt",
    "distributed service",
    "unavailable",
    "closed by peer",
    "read error",
)

# exception type names of torch.distributed's error layer — the only layer
# whose failures can poison the process group
_RUNTIME_TYPE_NAMES = (
    "DistError",
    "DistBackendError",
    "DistNetworkError",
    "DistStoreError",
)


def _is_runtime_error(exc: BaseException) -> bool:
    """True when ``exc`` was raised by ``torch.distributed``'s runtime layer
    — one of its error types, or a gloo ``RuntimeError`` (which names its
    source file under ``gloo/``) — rather than by plan or framework Python
    code."""
    for klass in type(exc).__mro__:
        if klass.__name__ in _RUNTIME_TYPE_NAMES:
            return True
    return isinstance(exc, RuntimeError) and "gloo/" in str(exc)


def _is_cohort_fatal(exc: BaseException) -> bool:
    """Typed-first classification: only a runtime-layer exception whose
    text carries a poisoned-group marker is fatal. A plan-authored
    ``ValueError`` that happens to mention "barrier" (plans use barriers!)
    is an ordinary run failure — killing the cohort generation for it
    would force a needless fleet-wide sim-worker restart.

    A :class:`~testground_tpu_torch.sync.errors.SyncLostError` IS fatal:
    the host-side coordination plane is gone past its reconnect budget."""
    from ..sync.errors import SyncLostError

    if isinstance(exc, SyncLostError):
        return True
    if not _is_runtime_error(exc):
        return False
    text = f"{type(exc).__name__}: {exc}".lower()
    return any(m in text for m in _FATAL_MARKERS)


def _child_main() -> int:
    from ..api import OutputsEnv, RunGroup, RunInput
    from ..config import EnvConfig
    from ..rpc import OutputWriter

    out = sys.stdout
    ow = OutputWriter(sink=out)
    # terminal lines share the writer's sink lock so they can never
    # interleave with a progress chunk mid-line
    emit = ow._emit

    msgs: list[dict] = []
    msgs_ready = threading.Condition()
    cancel = threading.Event()

    def reader():
        for line in sys.stdin:
            msg = _parse(line)
            if msg is None:
                continue
            if msg.get("cancel"):
                cancel.set()
                continue
            with msgs_ready:
                msgs.append(msg)
                msgs_ready.notify()
        # parent died: there is nobody to report to — leave, completing
        # no further collectives (workers fail on the closed connections)
        os._exit(2)

    threading.Thread(target=reader, daemon=True, name="cohort-stdin").start()

    while True:
        with msgs_ready:
            while not msgs:
                msgs_ready.wait()
            msg = msgs.pop(0)
        if msg.get("shutdown"):
            _child_shutdown()
            return 0
        job_d = msg.get("job")
        if not job_d:
            continue
        cancel.clear()
        ri = job_d["run_input"]
        from .executor import SimTorchConfig, execute_sim_run

        cfg = SimTorchConfig(**job_d["cfg"])
        if job_d.get("home"):
            env = EnvConfig.load(job_d["home"])
        elif job_d.get("outputs"):
            env = OutputsEnv(job_d["outputs"])
        else:
            env = None
        job = RunInput(
            run_id=ri["run_id"],
            test_plan=ri["test_plan"],
            test_case=ri["test_case"],
            total_instances=ri["total_instances"],
            groups=[RunGroup.from_dict(g) for g in ri["groups"]],
            runner_config=cfg,
            disable_metrics=ri.get("disable_metrics", False),
            # run-global faults and trace survive the hop (tracing is then
            # gated off by the cohort rule in the executor)
            faults=[dict(f) for f in ri.get("faults", [])],
            trace=dict(ri.get("trace", {})),
            slo=[dict(s) for s in ri.get("slo", [])],
            trace_ctx=dict(ri.get("trace_ctx", {})),
            env=env,
        )
        try:
            result = execute_sim_run(job, ow, cancel)
        except BaseException as e:  # noqa: BLE001 — classified below
            if _is_cohort_fatal(e):
                emit({"t": "cohort_fatal", "error": f"{type(e).__name__}: {e}"})
                # skip the group teardown AND interpreter atexit: both
                # could wait on the dead member
                out.flush()
                os._exit(3)
            emit({"t": "cohort_error", "error": f"{type(e).__name__}: {e}"})
            continue
        emit({"t": "cohort_result", "result": result.result.to_dict()})


def _child_shutdown() -> None:
    """Broadcast the shutdown sentinel so looping workers exit, then leave
    the process group."""
    from .distributed import broadcast_shutdown_if_leader, shutdown

    try:
        broadcast_shutdown_if_leader()
    except Exception:  # noqa: BLE001 — shutdown is best-effort
        pass
    try:
        shutdown()
    except Exception:  # noqa: BLE001
        pass


if __name__ == "__main__":
    sys.exit(_child_main())
