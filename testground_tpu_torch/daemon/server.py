"""Daemon HTTP server — the port's copy of the reference's
``testground_tpu/daemon/server.py`` (``pkg/daemon/daemon.go``).

A long-lived process owning ONE engine (worker pool + task store) that any
number of CLI clients talk to over HTTP, with the reference's bearer-token
auth (``daemon.go:49-70``) and these of its routes:

    POST /run /build /tasks /status /logs /outputs /terminate
         /healthcheck /kill /delete /build/purge /plan/import
    GET  / /tasks /logs /outputs /kill /delete /describe /events
         /journal /stats /perf /diff /stream /trace /artifact /fleet
         /metrics /dashboard /data

``/kill`` and ``/delete`` mutate on GET exactly like the reference's
(``daemon.go:87-88``). The read side of the observability verbs answers
as the reference's: a task's journal, its stats and perf payloads
(``Task.stats_payload``/``perf_payload``), the RunDiff of two tasks
(``Engine.diff_tasks``), the ndjson stream of its run rows
(``Engine.stream_rows``), its flight-recorder events, one whitelisted run
artifact, and the fleet view (``Engine.fleet_payload``). ``/metrics`` is
the Prometheus exposition (``metrics/prometheus.py``), ``/`` redirects to
the HTML dashboard (``/dashboard``: the task list, or one task's
measurement tables over the ``metrics.Viewer``), ``/data`` serves one
measurement's rows, and ``/plan/import`` takes a plan directory as a
tar.gz body. ``/preempt`` checkpoints and requeues one running task
(``Engine.preempt``), ``/drain`` drains the daemon (``Engine.drain``) and
then stops it, and SIGTERM drains before the daemon exits.

Transport notes (as the reference's):

- requests are plain JSON bodies; plan sources reach the daemon through its
  own ``$TESTGROUND_HOME/plans``;
- ``/run`` and ``/build`` respond over the rpc chunk protocol (progress
  chunks + a result chunk holding the task id), like the reference; a run
  whose composition ``tg check`` refuses (``Engine.admission_findings``)
  is answered 422 with the rule ids and messages before it takes a queue
  slot, and journaled as ``task.refused``;
- ``/logs`` streams the task's chunk-lines until completion when
  ``follow`` is set (``engine.go:461-558`` semantics);
- ``/outputs`` streams the run's tar.gz bytes directly with a gzip
  content type.

The server is a stdlib ``ThreadingHTTPServer`` — every connection gets a
thread; the engine's own locks make the shared state safe. The engine's
workers run the tasks, each in its own host thread, on the card the run's
config names (``engine/supervisor.py``).
"""

from __future__ import annotations

import io
import json
import os
import shutil
import signal
import tarfile
import tempfile
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from ..api import Composition, TestPlanManifest, generate_default_run
from ..config import EnvConfig
from ..engine import Engine
from ..logging_ import S
from ..rpc import OutputWriter

__all__ = ["Daemon", "serve"]


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    daemon_ref: "Daemon" = None  # bound per-daemon via a subclass

    # ------------------------------------------------------------ plumbing

    def log_message(self, fmt, *args):  # route http.server logs into ours
        S().debug("daemon http: " + fmt, *args)

    @property
    def engine(self) -> Engine:
        return self.daemon_ref.engine

    def _authed(self) -> bool:
        """Bearer-token middleware (``daemon.go:49-70``): with no tokens
        configured the daemon is open, like the reference's default."""
        tokens = self.daemon_ref.tokens
        if not tokens:
            return True
        hdr = self.headers.get("Authorization", "")
        return hdr.startswith("Bearer ") and hdr[len("Bearer ") :] in tokens

    def _json_body(self) -> dict:
        n = int(self.headers.get("Content-Length") or 0)
        raw = self.rfile.read(n) if n else b"{}"
        return json.loads(raw or b"{}")

    def _send_json(self, obj, code: int = 200) -> None:
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_error_json(self, msg: str, code: int = 400) -> None:
        self._send_json({"error": msg}, code)

    def _start_stream(self, content_type: str = "application/x-ndjson"):
        self.send_response(200)
        self.send_header("Content-Type", content_type)
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()

    def _write_chunked(self, data: bytes) -> None:
        self.wfile.write(f"{len(data):X}\r\n".encode() + data + b"\r\n")

    def _end_chunked(self) -> None:
        self.wfile.write(b"0\r\n\r\n")

    # ------------------------------------------------------------- routing

    def do_GET(self):  # noqa: N802 — stdlib naming
        if not self._authed():
            return self._send_error_json("unauthorized", 401)
        from urllib.parse import parse_qs, urlparse

        url = urlparse(self.path)
        # states/types are list-valued filters (storage.filter uses `in`
        # membership — a scalar string would substring-match); every other
        # key is a scalar and takes the first occurrence, matching the
        # reference's mux.Vars semantics.
        q = {
            k: (v if k in ("states", "types") else v[0])
            for k, v in parse_qs(url.query).items()
        }
        handlers = {
            "/": self._root_redirect,
            "/tasks": lambda: self._tasks(q),
            "/journal": lambda: self._journal(q),
            "/stats": lambda: self._stats(q),
            "/perf": lambda: self._perf(q),
            "/diff": lambda: self._diff(q),
            "/stream": lambda: self._stream(q),
            "/metrics": lambda: self._metrics(q),
            "/trace": lambda: self._trace(q),
            "/artifact": lambda: self._artifact(q),
            "/data": lambda: self._data(q),
            "/dashboard": lambda: self._dashboard(q),
            "/describe": lambda: self._describe(q),
            # the reference serves kill/delete/logs/outputs on GET too
            # (daemon.go:85-91, dashboard links); the POST forms carry the
            # same semantics
            "/kill": lambda: self._kill(q),
            "/delete": lambda: self._delete(q),
            "/logs": lambda: self._get_logs(q),
            "/outputs": lambda: self._get_outputs(q),
            # control plane: fleet summary for `tg top`, daemon
            # event-journal tail
            "/fleet": lambda: self._fleet(q),
            "/events": lambda: self._events(q),
        }
        h = handlers.get(url.path)
        if h is None:
            return self._send_error_json("not found", 404)
        try:
            return h()
        except BrokenPipeError:
            pass
        except Exception as e:  # noqa: BLE001 — HTTP boundary
            S().warning("daemon GET %s failed: %s", url.path, e)
            try:
                self._send_error_json(str(e), 500)
            except Exception:  # noqa: BLE001 — response already started
                pass

    def do_POST(self):  # noqa: N802
        if not self._authed():
            return self._send_error_json("unauthorized", 401)
        route = self.path.split("?")[0]
        handlers = {
            "/run": self._run,
            "/build": self._build,
            "/tasks": self._tasks,
            "/status": self._status,
            "/logs": self._logs,
            "/outputs": self._outputs,
            "/terminate": self._terminate,
            "/healthcheck": self._healthcheck,
            "/kill": self._kill,
            # the fleet controller: checkpoint and requeue a running task,
            # drain the whole daemon
            "/preempt": self._preempt,
            "/drain": self._drain,
            "/delete": self._delete,
            "/build/purge": self._build_purge,
        }
        try:
            if route == "/plan/import":
                return self._plan_import()
            if route not in handlers:
                return self._send_error_json("not found", 404)
            return handlers[route](self._json_body())
        except BrokenPipeError:
            pass
        except Exception as e:  # noqa: BLE001 — HTTP boundary
            S().warning("daemon %s failed: %s", route, e)
            try:
                self._send_error_json(str(e), 500)
            except Exception:  # noqa: BLE001 — response already started
                pass

    # ------------------------------------------------------------- handlers

    def _safe_plan_dir(self, name: str) -> str:
        """Resolve a plan name inside the daemon's plans dir, rejecting
        anything that is not a single path component — otherwise a client
        could point plan resolution (manifest read + sources_dir) at
        arbitrary daemon-readable paths."""
        if (
            not name
            or name != os.path.basename(name)
            or name in (".", "..")
        ):
            raise ValueError(f"invalid plan name {name!r}")
        # a single path component cannot escape the plans dir lexically;
        # no realpath comparison so operator-made symlinked plans keep working
        return os.path.join(self.engine.env.dirs.plans(), name)

    def _load_plan_manifest(self, plan: str):
        """Resolve a daemon-hosted plan → (plan_dir, manifest), or None
        after sending the 400/404 error response. Shared by /run, /build,
        and /describe so the resolution rules cannot drift."""
        try:
            plan_dir = self._safe_plan_dir(plan)
        except ValueError as e:
            self._send_error_json(str(e), 400)
            return None
        manifest_path = os.path.join(plan_dir, "manifest.toml")
        if not os.path.isfile(manifest_path):
            self._send_error_json(
                f"plan {plan!r} not found on the daemon; "
                "import it with `tg plan import` against --endpoint",
                404,
            )
            return None
        return plan_dir, TestPlanManifest.load_file(manifest_path)

    def _queue(self, body: dict, kind: str) -> None:
        comp = Composition.from_dict(body["composition"])
        if kind == "run":
            # server-side run preparation: a raw-client composition may
            # arrive without [[runs]]; synthesize the default run like the
            # reference daemon does during PrepareForRun
            # (composition_preparation.go:93-110 via supervisor.go:494-518)
            comp = generate_default_run(comp)
        resolved = self._load_plan_manifest(comp.global_.plan)
        if resolved is None:
            return
        plan_dir, manifest = resolved
        if kind == "run":
            # admission at submit: the `tg check` rules engine runs here,
            # before the task takes a queue slot, and a refused
            # composition never reaches a worker or the card. Daemon
            # boundary only: the in-process engine queues anything
            findings = self.engine.admission_findings(comp, manifest)
            if findings:
                self.engine.note_refused(
                    comp, [f.rule for f in findings], kind=kind
                )
                return self._send_error_json(
                    "composition refused at submit (tg check): "
                    + "; ".join(f"[{f.rule}] {f.message}" for f in findings),
                    422,
                )
        queue = (
            self.engine.queue_run if kind == "run" else self.engine.queue_build
        )
        created_by = None
        if isinstance(body.get("created_by"), dict):
            from ..engine.task import CreatedBy

            created_by = CreatedBy.from_dict(body["created_by"])
        task_id = queue(
            comp,
            manifest,
            sources_dir=plan_dir,
            priority=int(body.get("priority", 0)),
            created_by=created_by,
            # lifecycle tracing (tracectx.py): adopt the submitter's
            # traceparent so the task's span tree roots at the client's
            # submit span; absent/malformed → the engine mints fresh
            trace_parent=self.headers.get("traceparent", ""),
        )
        # chunked rpc response: progress line + result chunk (the wire
        # shape the reference's ParseRunResponse expects, client.go:402)
        self._start_stream()
        ow = OutputWriter(sink=_ChunkSink(self))
        ow.infof("%s is queued with ID: %s", kind, task_id)
        ow.write_result({"task_id": task_id})
        self._end_chunked()

    def _run(self, body: dict) -> None:
        self._queue(body, "run")

    def _build(self, body: dict) -> None:
        self._queue(body, "build")

    def _tasks(self, body: dict) -> None:
        def when(key):
            v = body.get(key)
            if v is None:
                return None
            try:
                return float(v)
            except (TypeError, ValueError):
                raise ValueError(f"invalid {key}: {v!r}") from None

        try:
            before, after = when("before"), when("after")
        except ValueError as e:
            return self._send_error_json(str(e), 400)

        def listy(key):
            # POST bodies carry JSON lists; a bare string (hand-rolled
            # client) must become a one-element list, not a substring
            # matcher inside storage.filter's `in` membership test.
            v = body.get(key)
            if not v:
                return None
            return [v] if isinstance(v, str) else list(v)

        tasks = self.engine.tasks(
            states=listy("states"),
            types=listy("types"),
            before=before,
            after=after,
            limit=int(body.get("limit") or 0),
        )
        self._send_json({"tasks": [t.to_dict() for t in tasks]})

    def _status(self, body: dict) -> None:
        t = self.engine.get_task(body["task_id"])
        if t is None:
            return self._send_error_json(f"unknown task {body['task_id']}", 404)
        self._send_json({"task": t.to_dict()})

    def _root_redirect(self) -> None:
        """GET / → the dashboard (``daemon.go:91`` redirect)."""
        self.send_response(302)
        self.send_header("Location", "/dashboard")
        # explicit empty body: keep-alive clients (curl, browsers) would
        # otherwise read until timeout waiting for an unframed body
        self.send_header("Content-Length", "0")
        self.end_headers()

    def _get_logs(self, q: dict) -> None:
        if "task_id" not in q:
            return self._send_error_json("task_id is required", 400)
        # never follow on GET: a dashboard link must terminate
        self._logs({"task_id": q["task_id"]})

    def _get_outputs(self, q: dict) -> None:
        if "runner" not in q or "run_id" not in q:
            return self._send_error_json(
                "runner and run_id are required", 400
            )
        self._outputs({"runner": q["runner"], "run_id": q["run_id"]})

    def _logs(self, body: dict) -> None:
        task_id = body["task_id"]
        follow = bool(body.get("follow"))
        # resolve the task BEFORE starting the chunked stream — once chunking
        # begins, a later error response would be written onto the same
        # keep-alive connection as protocol garbage
        if self.engine.get_task(task_id) is None:
            return self._send_error_json(f"unknown task {task_id}", 404)
        self._start_stream()
        try:
            for line in self.engine.logs(task_id, follow=follow):
                self._write_chunked(line.encode())
        finally:
            self._end_chunked()

    def _outputs(self, body: dict) -> None:
        runner = body["runner"]
        run_id = body["run_id"]
        # run ids are single path components (xid-style, engine/task.py);
        # anything else could walk the collection root out of the outputs
        # tree and exfiltrate arbitrary directories as a tgz
        if (
            run_id != os.path.basename(run_id)
            or run_id in ("", ".", "..")
            or "/" in run_id
            or "\\" in run_id
        ):
            return self._send_error_json(
                f"invalid run id {run_id!r}", 400
            )
        # spool to a temp file so HTTP status can still signal failure
        with tempfile.TemporaryFile() as spool:
            from ..rpc import discard_writer

            self.engine.do_collect_outputs(
                runner, run_id, spool, discard_writer()
            )
            size = spool.tell()
            spool.seek(0)
            self.send_response(200)
            self.send_header("Content-Type", "application/gzip")
            self.send_header("Content-Length", str(size))
            self.end_headers()
            shutil.copyfileobj(spool, self.wfile)

    def _terminate(self, body: dict) -> None:
        buf = io.StringIO()
        if body.get("builder"):
            ref, ctype = body["builder"], "builder"
        elif body.get("runner"):
            ref, ctype = body["runner"], "runner"
        else:
            return self._send_error_json(
                "specify exactly one of runner or builder", 400
            )
        self.engine.do_terminate(
            ref, OutputWriter(sink=None, echo=buf), ctype=ctype
        )
        self._send_json({"output": buf.getvalue()})

    def _healthcheck(self, body: dict) -> None:
        buf = io.StringIO()
        report = self.engine.do_healthcheck(
            body["runner"], bool(body.get("fix")), OutputWriter(sink=None, echo=buf)
        )
        self._send_json({"report": report.to_dict(), "output": buf.getvalue()})

    def _kill(self, body: dict) -> None:
        task_id = body.get("task_id")
        if not task_id:  # also reachable from the GET form's URL bar
            return self._send_error_json("task_id param required", 400)
        ok = self.engine.kill(task_id)
        self._send_json({"killed": bool(ok)})

    def _preempt(self, body: dict) -> None:
        """Checkpoint and requeue one running task (``server.py:444-452``);
        the run stops at its next chunk boundary."""
        task_id = body.get("task_id")
        if not task_id:
            return self._send_error_json("task_id param required", 400)
        self._send_json(self.engine.preempt(task_id))

    def _drain(self, body: dict) -> None:
        """Drain, answer with the drain's result, then stop the daemon from
        a timer thread (``httpd.shutdown()`` from this handler's thread
        would close the socket under this very response)."""
        timeout = float(body.get("timeout_secs", 30.0) or 30.0)
        res = self.engine.drain(timeout_secs=timeout)
        self._send_json(res)
        t = threading.Timer(0.2, self.daemon_ref.stop)
        t.daemon = True
        t.start()

    def _describe(self, q: dict) -> None:
        """GET /describe?plan= — the daemon-side manifest, so a remote CLI
        can fill composition defaults for plans that exist only on the
        daemon."""
        resolved = self._load_plan_manifest(q.get("plan", ""))
        if resolved is None:
            return
        self._send_json({"manifest": resolved[1].to_dict()})

    def _delete(self, body: dict) -> None:
        """Delete a finished task's record + log (``daemon.go:88``)."""
        task_id = body.get("task_id")
        if not task_id:
            return self._send_error_json("task_id param required", 400)
        try:
            ok = self.engine.delete_task(task_id)
        except ValueError as e:  # task still live
            return self._send_error_json(str(e), 409)
        self._send_json({"deleted": bool(ok)})

    def _build_purge(self, body: dict) -> None:
        buf = io.StringIO()
        self.engine.do_build_purge(
            body["builder"], body.get("testplan", ""), OutputWriter(sink=None, echo=buf)
        )
        self._send_json({"output": buf.getvalue()})

    # ------------------------------------------------- dashboard tier (GET)

    def _send_html(self, body: str, code: int = 200) -> None:
        data = body.encode()
        self.send_response(code)
        self.send_header("Content-Type", "text/html; charset=utf-8")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _journal(self, q: dict) -> None:
        """GET /journal?task_id= — the task's result journal
        (``daemon.go:90`` getJournalHandler)."""
        task_id = q.get("task_id", "")
        t = self.engine.get_task(task_id)
        if t is None:
            return self._send_error_json(f"unknown task {task_id}", 404)
        journal = (
            t.result.get("journal", {}) if isinstance(t.result, dict) else {}
        )
        self._send_json({"task_id": task_id, "journal": journal})

    def _stats(self, q: dict) -> None:
        """GET /stats?task_id= — the task's sim telemetry summary (the
        ``tg stats`` backend; docs/OBSERVABILITY.md): identity + the
        journal's sim/telemetry/events sections, i.e. everything the
        console table needs in one round trip. The payload shape is
        Task.stats_payload — shared with the in-process CLI."""
        task_id = q.get("task_id", "")
        t = self.engine.get_task(task_id)
        if t is None:
            return self._send_error_json(f"unknown task {task_id}", 404)
        self._send_json(t.stats_payload())

    def _diff(self, q: dict) -> None:
        """GET /diff?a=&b=[&planes=p1,p2] — the differential run
        analysis document (the ``tg diff`` backend; docs/OBSERVABILITY.md
        "Run diff"): deterministic counters compared exactly, throughput
        judged from per-chunk samples. Built by Engine.diff_tasks — the
        one codepath shared with the in-process CLI — so it works
        against archived tasks over HTTP."""
        a, b = q.get("a", ""), q.get("b", "")
        if not a or not b:
            return self._send_error_json("a and b task params required", 400)
        try:
            doc = self.engine.diff_tasks(a, b, planes=q.get("planes"))
        except FileNotFoundError as e:
            return self._send_error_json(str(e), 404)
        except ValueError as e:
            return self._send_error_json(str(e), 400)
        self._send_json(doc)

    def _perf(self, q: dict) -> None:
        """GET /perf?task_id= — the task's performance-ledger payload
        (the ``tg perf`` backend; docs/OBSERVABILITY.md): identity, the
        journal's sim block, the sim.perf ledger, and the supervisor's
        task-level timings. Payload shape is Task.perf_payload — shared
        with the in-process CLI."""
        task_id = q.get("task_id", "")
        t = self.engine.get_task(task_id)
        if t is None:
            return self._send_error_json(f"unknown task {task_id}", 404)
        self._send_json(t.perf_payload())

    def _stream(self, q: dict) -> None:
        """GET /stream?task_id=[&follow=0][&families=perf,slo] — ndjson
        stream of a task's live observability rows (telemetry / perf /
        SLO breaches / run spans), tailed from the run outputs as they
        are appended: the ``tg watch`` backend (docs/OBSERVABILITY.md
        "Run health plane"). Follows by default — an already-finished
        task replays its full history, then the stream closes; a
        running task streams until it completes."""
        task_id = q.get("task_id", "") or q.get("task", "")
        if not task_id:
            return self._send_error_json("task_id is required", 400)
        # resolve BEFORE starting the chunked stream (the /logs rule)
        if self.engine.get_task(task_id) is None:
            return self._send_error_json(f"unknown task {task_id}", 404)
        follow = q.get("follow", "1") not in ("0", "false", "no")
        families = None
        if q.get("families"):
            from ..engine.stream import STREAM_FAMILIES

            families = tuple(
                f.strip() for f in q["families"].split(",") if f.strip()
            )
            known = {name for name, _ in STREAM_FAMILIES}
            unknown = sorted(set(families) - known)
            if unknown or not families:
                # a typo'd (or all-blank, e.g. "families=,") family list
                # would otherwise follow silently, row-less, for the
                # task's whole lifetime
                return self._send_error_json(
                    f"unknown stream families {unknown}; families: "
                    f"{sorted(known)}",
                    400,
                )
        self._start_stream()
        try:
            # heartbeat: a blank ndjson line at least every 15 s of
            # idle, so a queued task / long compile / quiet soak cannot
            # trip a follower's socket read timeout
            for row in self.engine.stream_rows(
                task_id, follow=follow, families=families, heartbeat_secs=15.0
            ):
                self._write_chunked(
                    b"\n"
                    if row is None
                    else (json.dumps(row) + "\n").encode()
                )
        finally:
            self._end_chunked()

    # Task-label cardinality bound for one /metrics scrape (most recent
    # first — a scraper watches the daemon's working set, not history).
    # The default; .env.toml ``[daemon] metrics_task_limit`` overrides.
    _METRICS_TASKS_MAX = 200

    def _metrics(self, q: dict) -> None:
        """GET /metrics — Prometheus text exposition (format 0.0.4):
        task gauges, cumulative flow counters, performance-ledger and
        SLO gauges for the most recent tasks, and the fleet gauges, so
        any standard scraper can watch a daemon. Truncation is never
        silent: ``tg_scrape_tasks_total`` / ``tg_scrape_tasks_elided``
        report how much of the task store one scrape covered."""
        from ..metrics.prometheus import CONTENT_TYPE, render_prometheus

        limit = (
            int(self.daemon_ref.env.daemon.metrics_task_limit or 0)
            or self._METRICS_TASKS_MAX
        )
        body = render_prometheus(
            self.engine.tasks(), per_task_limit=limit,
            fleet=self.engine.fleet_info(),
        ).encode()
        self.send_response(200)
        self.send_header("Content-Type", CONTENT_TYPE)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _fleet(self, q: dict) -> None:
        """GET /fleet — the daemon-wide summary behind ``tg top``:
        worker slots, queue depth by priority, per-state counts over
        the FULL task store, pack occupancy, and one row per
        queued/running task with live ticks/s and breach counts."""
        self._send_json(self.engine.fleet_payload())

    def _events(self, q: dict) -> None:
        """GET /events?since=<byte offset>[&follow=1] — tail the daemon
        event journal (engine/events.py) as ndjson. One-shot by
        default: replays complete lines from ``since`` to EOF, then
        sends a ``{"type": "_tail", "offset": N}`` marker whose offset
        resumes the next call. With ``follow=1``, keeps tailing
        (heartbeat blank line every 15 s of idle) until the client
        disconnects. 404 while the journal does not exist yet."""
        from ..engine.events import JournalTail

        path = self.engine.events.path
        try:
            since = int(q.get("since") or 0)
        except (TypeError, ValueError):
            return self._send_error_json("invalid since", 400)
        if not os.path.exists(path):
            return self._send_error_json("no events journal yet", 404)
        follow = q.get("follow", "0") not in ("0", "false", "no", "")
        tail = JournalTail(path)
        tail.offset = max(0, since)
        self._start_stream()
        try:
            last_data = time.monotonic()
            while True:
                wrote = False
                for row in tail.read_new():
                    self._write_chunked(
                        (json.dumps(row) + "\n").encode()
                    )
                    wrote = True
                if wrote:
                    last_data = time.monotonic()
                if not follow:
                    self._write_chunked(
                        (
                            json.dumps(
                                {"type": "_tail", "offset": tail.offset}
                            )
                            + "\n"
                        ).encode()
                    )
                    break
                if time.monotonic() - last_data >= 15.0:
                    self._write_chunked(b"\n")  # heartbeat
                    last_data = time.monotonic()
                time.sleep(0.15)
        finally:
            self._end_chunked()


    # ---------------------------------------------- flight recorder, artifacts

    # Event cap for one /trace JSON response (sim_trace.jsonl itself is
    # unbounded; the full file streams via /artifact).
    _TRACE_EVENTS_MAX = 50_000

    def _trace(self, q: dict) -> None:
        """GET /trace?task_id=[&limit=] — the task's flight-recorder
        events (``sim_trace.jsonl``, read back from the outputs tree —
        every run dir of a multi-``[[runs]]`` task contributes) plus the
        journal's trace summary: the ``tg trace`` backend
        (docs/OBSERVABILITY.md). Responses cap at ``_TRACE_EVENTS_MAX``
        events; fetch the whole stream via ``/artifact``."""
        from ..sim.trace import read_trace_events

        task_id = q.get("task_id", "")
        t = self.engine.get_task(task_id)
        if t is None:
            return self._send_error_json(f"unknown task {task_id}", 404)
        journal = (
            t.result.get("journal", {}) if isinstance(t.result, dict) else {}
        )
        try:
            limit = int(q.get("limit") or 0)
        except (TypeError, ValueError):
            return self._send_error_json("invalid limit", 400)
        # a JSON response must stay bounded — sim_trace.jsonl is not
        # (see /artifact, which streams the whole file): an absent/0
        # limit gets the server-side default instead of a full slurp
        limit = (
            self._TRACE_EVENTS_MAX
            if limit <= 0
            else min(limit, self._TRACE_EVENTS_MAX)
        )
        # read one past the limit so an exactly-limit-sized stream is
        # not falsely reported as truncated
        events = read_trace_events(
            self.engine.env.dirs.outputs(), t.plan, task_id, limit=limit + 1
        )
        payload = {
            "task_id": task_id,
            "trace": journal.get("trace", {}),
            "events": events[:limit],
        }
        if len(events) > limit:
            # never silently incomplete: a capped response says so, and
            # points at the full stream
            payload["truncated"] = True
            payload["limit"] = limit
        self._send_json(payload)

    # Observability artifacts a dashboard task page may link: file names
    # are a closed whitelist (never client paths) and the run dir must
    # belong to the task, so the route cannot read outside the task's
    # outputs.
    _ARTIFACT_FILES = (
        "timeseries.jsonl",
        "sim_timeseries.jsonl",
        "sim_netmatrix.jsonl",
        "sim_latency.jsonl",
        "sim_perf.jsonl",
        "sim_phases.jsonl",
        "sim_slo.jsonl",
        "run_spans.jsonl",
        "sim_trace.jsonl",
        "trace_events.json",
        # lifecycle span tree (engine/tracetree.py): assembled at
        # archive time; task_trace.json opens in Perfetto directly
        "task_spans.jsonl",
        "task_trace.json",
    )
    # the torch.profiler capture (``profile = true``) lands at
    # profiles/trace.json under the run dir — served so a remote `tg`
    # session can fetch it. The reference's per-instance cProfile dumps
    # (item 16) and xplane captures have no counterpart in the port's run
    # outputs.
    _PROFILE_FILES = ("profiles/trace.json",)
    # snapshots (sim/checkpoint.py) at checkpoints/ckpt-<tick>.npz, served
    # so an operator can migrate a run between machines; exact depth and
    # name shape, every component validated
    _CHECKPOINT_PREFIX = "checkpoints"
    _CHECKPOINT_NAME = ("ckpt-", ".npz")

    @classmethod
    def _artifact_relpath(cls, name: str) -> str | None:
        """Validate an artifact name → safe run-dir-relative path, or
        None: the flat whitelist, or the profiler capture."""
        if name in cls._ARTIFACT_FILES:
            return name
        if name in cls._PROFILE_FILES:
            return os.path.join(*name.split("/"))
        parts = name.split("/")
        if (
            len(parts) == 2
            and parts[0] == cls._CHECKPOINT_PREFIX
            and parts[1].startswith(cls._CHECKPOINT_NAME[0])
            and parts[1].endswith(cls._CHECKPOINT_NAME[1])
            and all(p and p not in (".", "..") and p == os.path.basename(p)
                    and "\\" not in p for p in parts)
        ):
            return os.path.join(*parts)
        return None

    def _artifact(self, q: dict) -> None:
        """GET /artifact?task_id=&name=[&run=] — serve one whitelisted
        observability artifact from a task's run outputs dir (the
        dashboard's trace/telemetry/profile links)."""
        task_id = q.get("task_id", "")
        t = self.engine.get_task(task_id)
        if t is None:
            return self._send_error_json(f"unknown task {task_id}", 404)
        name = q.get("name", "")
        rel = self._artifact_relpath(name)
        if rel is None:
            return self._send_error_json(
                f"unknown artifact {name!r}; serving only "
                f"{list(self._ARTIFACT_FILES + self._PROFILE_FILES)}",
                400,
            )
        rid = q.get("run", task_id)
        if rid != os.path.basename(rid) or not (
            rid == task_id or rid.startswith(task_id + "-")
        ):
            return self._send_error_json(f"invalid run id {rid!r}", 400)
        path = os.path.join(
            self.engine.env.dirs.outputs(), t.plan, rid, rel
        )
        if not os.path.isfile(path):
            return self._send_error_json(
                f"artifact {name} not found for run {rid}", 404
            )
        # stream, never slurp: sim_trace.jsonl is unbounded by design (a
        # long traced run can reach GBs) and the daemon owns every
        # running task — one dashboard click must not balloon its RSS.
        # Copy EXACTLY the declared length: the file may still be
        # growing (a RUNNING traced task flushes every chunk), and extra
        # bytes past Content-Length would corrupt the keep-alive
        # connection's framing for the next pipelined response.
        size = os.path.getsize(path)
        self.send_response(200)
        self.send_header(
            "Content-Type",
            "application/json"
            if name.endswith(".json")
            else "application/octet-stream"
            if name.endswith((".pstats", ".pb", ".npz"))
            else "application/x-ndjson",
        )
        self.send_header("Content-Length", str(size))
        self.end_headers()
        with open(path, "rb") as f:
            remaining = size
            while remaining > 0:
                chunk = f.read(min(1 << 16, remaining))
                if not chunk:  # file truncated underneath us: pad out
                    self.wfile.write(b" " * remaining)
                    break
                self.wfile.write(chunk)
                remaining -= len(chunk)

    def _data(self, q: dict) -> None:
        """GET /data?task_id=&metric= — one measurement's sampled rows
        (``daemon.go:83`` dataHandler; rows are the InfluxDB-table analog).
        ``metric`` accepts the bare metric name or the full
        ``results.<plan>-<case>.<metric>`` measurement string."""
        from ..metrics import Viewer, measurement_name

        task_id = q.get("task_id", "")
        t = self.engine.get_task(task_id)
        if t is None:
            return self._send_error_json(f"unknown task {task_id}", 404)
        metric = q.get("metric", "")
        prefix = measurement_name(t.plan, t.case, "")
        if metric.startswith(prefix):
            metric = metric[len(prefix) :]
        if not metric:
            return self._send_error_json("metric query param required", 400)
        rows = Viewer(self.engine.env).get_data(
            t.plan, t.case, metric, run_id=task_id
        )
        self._send_json(
            {
                "measurement": measurement_name(t.plan, t.case, metric),
                "rows": [r.to_dict() for r in rows],
            }
        )

    def _dashboard(self, q: dict) -> None:
        """GET /dashboard[?task_id=] — HTML: the task list (``tmpl/
        tasks.html`` analog) or one task's measurement tables
        (``dashboard.go:44-75`` + ``tmpl/measurements.html``)."""
        import html as _html

        from ..metrics import Viewer, measurement_name

        esc = _html.escape
        task_id = q.get("task_id", "")
        if not task_id:
            rows = []
            for t in self.engine.tasks(limit=100):
                rows.append(
                    "<tr>"
                    f'<td><a href="/dashboard?task_id={esc(t.id)}">{esc(t.id)}</a></td>'
                    f"<td>{esc(t.plan)}:{esc(t.case)}</td>"
                    f"<td>{esc(t.type.value)}</td>"
                    f"<td>{esc(t.state().state.value)}</td>"
                    f"<td>{esc(t.outcome().value)}</td>"
                    "</tr>"
                )
            return self._send_html(
                _page(
                    "testground tasks",
                    "<table><tr><th>task</th><th>plan:case</th><th>type</th>"
                    "<th>state</th><th>outcome</th></tr>"
                    + "".join(rows)
                    + "</table>",
                )
            )

        t = self.engine.get_task(task_id)
        if t is None:
            return self._send_html(_page("not found", "Cannot get task"), 404)
        viewer = Viewer(self.engine.env)
        all_data = viewer.get_all_data(t.plan, t.case, run_id=task_id)
        sections = []
        for metric in sorted(all_data):
            m = measurement_name(t.plan, t.case, metric)
            rows = all_data[metric]
            body = "".join(
                "<tr>"
                f"<td>{r.tick}</td><td>{esc(r.group_id)}</td>"
                f"<td>{r.fields.get('count', '')}</td>"
                f"<td>{_fmt(r.fields.get('mean'))}</td>"
                f"<td>{_fmt(r.fields.get('min'))}</td>"
                f"<td>{_fmt(r.fields.get('max'))}</td>"
                "</tr>"
                for r in rows
            )
            sections.append(
                f"<h2>{esc(m)}</h2>"
                "<table><tr><th>tick</th><th>group</th><th>count</th>"
                "<th>mean</th><th>min</th><th>max</th></tr>" + body + "</table>"
            )
        if not sections:
            sections = ["<p>No measurements for this test plan.</p>"]
        # multi-[[runs]] tasks store outputs under <task_id>-<run_id> dirs
        # (supervisor run_id framing); one link per run, else one for the
        # single-run task
        output_links = ""
        artifact_links = ""
        if t.runner:  # build tasks have no run outputs
            run_results = (
                t.result.get("runs") if isinstance(t.result, dict) else None
            )
            if isinstance(run_results, dict) and run_results:
                links = [
                    (f"outputs[{esc(rid)}]", f"{task_id}-{rid}")
                    for rid in run_results
                ]
            else:
                links = [("outputs", task_id)]
            output_links = "".join(
                f' · <a href="/outputs?runner={esc(t.runner)}&amp;run_id='
                f'{esc(rid)}">{label}</a>'
                for label, rid in links
            )
            # telemetry / trace artifacts and the profiler capture actually
            # present in the run dir(s) — served by /artifact (whitelisted
            # names). The reference's per-instance profiles (item 16) and
            # xplane captures have no counterpart in the port's outputs
            per_run = []
            for _, rid in links:
                run_dir = os.path.join(
                    self.engine.env.dirs.outputs(), t.plan, rid
                )
                present = [
                    name
                    for name in self._ARTIFACT_FILES + self._PROFILE_FILES
                    if os.path.isfile(os.path.join(run_dir, *name.split("/")))
                ]
                if not present:
                    continue
                tag = (
                    f" [{esc(rid)}]"
                    if rid != task_id
                    else ""
                )
                per_run.append(
                    " · ".join(
                        f'<a href="/artifact?task_id={esc(task_id)}'
                        f"&amp;run={esc(rid)}&amp;name={esc(name)}\">"
                        f"{esc(name)}</a>"
                        for name in present
                    )
                    + tag
                )
            if per_run:
                artifact_links = (
                    "<p>artifacts: " + " &nbsp;|&nbsp; ".join(per_run) + "</p>"
                )
        header = (
            f"<p>task <code>{esc(task_id)}</code> — "
            f"{esc(t.plan)}:{esc(t.case)} — state {esc(t.state().state.value)}, "
            f"outcome {esc(t.outcome().value)} — "
            f'<a href="/journal?task_id={esc(task_id)}">journal</a> · '
            f'<a href="/stats?task_id={esc(task_id)}">stats</a> · '
            f'<a href="/perf?task_id={esc(task_id)}">perf</a> · '
            f'<a href="/trace?task_id={esc(task_id)}">trace</a> · '
            f'<a href="/logs?task_id={esc(task_id)}">logs</a>'
            + output_links
            + "</p>"
            + artifact_links
        )
        self._send_html(
            _page(f"{t.plan}:{t.case}", header + "".join(sections))
        )

    def _plan_import(self) -> None:
        """POST /plan/import[?name=] — body: the raw tar.gz of a plan
        directory. Members that would land outside the extraction dir
        (absolute paths, ``..``, links out) are refused by the tarfile
        ``data`` filter, and a plan name must be a single path component;
        both answer 400."""
        from urllib.parse import parse_qs, urlparse

        q = parse_qs(urlparse(self.path).query)
        n = int(self.headers.get("Content-Length") or 0)
        raw = self.rfile.read(n)
        with tempfile.TemporaryDirectory() as td:
            try:
                with tarfile.open(fileobj=io.BytesIO(raw), mode="r:gz") as tar:
                    tar.extractall(td, filter="data")
            except (tarfile.TarError, OSError, EOFError) as e:
                return self._send_error_json(f"bad plan archive: {e}", 400)
            entries = [e for e in os.listdir(td) if not e.startswith(".")]
            if len(entries) == 1 and os.path.isdir(os.path.join(td, entries[0])):
                src = os.path.join(td, entries[0])
                default_name = entries[0]
            else:
                src = td
                default_name = ""
            name = (q.get("name") or [default_name])[0]
            if not name:
                return self._send_error_json("plan name required", 400)
            if not os.path.isfile(os.path.join(src, "manifest.toml")):
                return self._send_error_json("archive has no manifest.toml", 400)
            try:
                dest = self._safe_plan_dir(name)
            except ValueError as e:
                return self._send_error_json(str(e), 400)
            if os.path.exists(dest):
                shutil.rmtree(dest)
            shutil.copytree(src, dest)
        self._send_json({"imported": name})


def _fmt(v) -> str:
    return f"{v:.3f}" if isinstance(v, (int, float)) else ""


def _page(title: str, body: str) -> str:
    """Minimal self-contained page shell (the tmpl/*.html + bootstrap
    analog, without the static asset tree). The title is escaped here (it
    can carry client-supplied plan/case strings); the body is the caller's
    already-escaped markup."""
    import html as _html

    title = _html.escape(title)
    return (
        "<!doctype html><html><head><meta charset='utf-8'>"
        f"<title>{title}</title>"
        "<style>body{font-family:sans-serif;margin:2rem}"
        "table{border-collapse:collapse;margin:1rem 0}"
        "td,th{border:1px solid #999;padding:.3rem .6rem;text-align:left}"
        "th{background:#eee}</style></head>"
        f"<body><h1>{title}</h1>{body}</body></html>"
    )


class _ChunkSink:
    """File-like adapter: OutputWriter lines → HTTP chunked frames."""

    def __init__(self, handler: _Handler):
        self.h = handler

    def write(self, s: str) -> int:
        self.h._write_chunked(s.encode())
        return len(s)

    def flush(self) -> None:
        pass


class Daemon:
    """Owns the HTTP server + the engine (``daemon.New``,
    ``daemon.go:34-118``)."""

    def __init__(self, env: EnvConfig | None = None, listen: str = ""):
        self.env = env or EnvConfig.load()
        if not self.env.task_repo_explicit:
            self.env.daemon.scheduler.task_repo_type = "disk"
        self.engine = Engine.new_default(self.env)
        self.tokens = list(self.env.daemon.tokens)
        addr = listen or self.env.daemon.listen or "localhost:8042"
        host, _, port = addr.rpartition(":")
        handler = type("BoundHandler", (_Handler,), {"daemon_ref": self})
        self.httpd = ThreadingHTTPServer(
            (host or "localhost", int(port)), handler
        )
        self._thread: threading.Thread | None = None
        self._stop_lock = threading.Lock()
        self._stopped = False

    @property
    def address(self) -> str:
        h, p = self.httpd.server_address[:2]
        return f"http://{h}:{p}"

    def start(self) -> None:
        """Start workers + serve in a background thread (for tests)."""
        self.engine.start_workers()
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True
        )
        self._thread.start()

    def serve_forever(self) -> None:
        self.engine.start_workers()
        S().info("daemon listening on %s", self.address)

        def _on_sigterm(signum, frame):  # noqa: ARG001
            # graceful drain: checkpoint and requeue the running work,
            # journal daemon.drain, exit 0. A thread, because the handler
            # runs ON the serving thread — httpd.shutdown() here would
            # deadlock serve_forever
            threading.Thread(target=self._drain_and_stop, daemon=True).start()

        try:
            signal.signal(signal.SIGTERM, _on_sigterm)
        except ValueError:
            pass  # not the main thread (embedded use) — no SIGTERM hook
        try:
            self.httpd.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            self.stop()

    def _drain_and_stop(self) -> None:
        try:
            self.engine.drain()
        except Exception as e:  # noqa: BLE001 — still shut down
            S().warning("drain on SIGTERM failed: %s", e)
        self.stop()

    def stop(self) -> None:
        # idempotent: SIGTERM's drain, /drain's timer and serve_forever's
        # finally may all reach here
        with self._stop_lock:
            if self._stopped:
                return
            self._stopped = True
        self.httpd.shutdown()
        self.httpd.server_close()
        self.engine.stop()


def serve(listen: str = "") -> int:
    Daemon(listen=listen).serve_forever()
    return 0
