"""HTTP client for the daemon — the port's copy of the reference's
``testground_tpu/client/client.py`` (``pkg/client/client.go``), for the
routes the port's daemon serves, ``preempt`` and ``drain`` among them.

Two layers:

- :class:`Client` — thin typed wrappers over the daemon routes
  (``Client.Run/Build/Tasks/Status/Logs/CollectOutputs/Terminate/
  Healthcheck``, ``client.go:43-513``), stdlib ``http.client`` only, with
  bearer-token auth and streaming reads for /logs and /outputs.
- :class:`RemoteEngine` — an adapter exposing the subset of the Engine
  surface the CLI uses, so every verb works identically against
  ``--endpoint`` (the reference's client↔daemon hop is transport, not
  semantics).
"""

from __future__ import annotations

import io
import json
import os
import tarfile
from typing import Iterator
from urllib.parse import quote, urlparse

from ..engine import Task
from ..healthcheck.report import CheckResult, Report

__all__ = ["Client", "DaemonError", "RemoteEngine"]


class DaemonError(RuntimeError):
    pass


class Client:
    def __init__(self, endpoint: str, token: str = ""):
        if "//" not in endpoint:
            endpoint = "http://" + endpoint
        u = urlparse(endpoint)
        self.host = u.hostname or "localhost"
        self.port = u.port or 8042
        self.token = token

    # ------------------------------------------------------------ transport

    def _conn(self):
        import http.client

        return http.client.HTTPConnection(self.host, self.port, timeout=600)

    def _headers(self, content_type="application/json"):
        h = {"Content-Type": content_type}
        if self.token:
            h["Authorization"] = f"Bearer {self.token}"
        return h

    def _post(self, route: str, body: dict):
        """POST a JSON body; return the http response (caller reads)."""
        conn = self._conn()
        conn.request("POST", route, json.dumps(body), self._headers())
        resp = conn.getresponse()
        return conn, resp

    @staticmethod
    def _read_json_response(conn, resp) -> dict:
        """Read a JSON body; raise DaemonError on HTTP errors (including
        non-JSON error bodies)."""
        try:
            data = resp.read()
            try:
                obj = json.loads(data or b"{}")
            except ValueError:
                obj = {"error": data.decode(errors="replace")[:500]}
            if resp.status >= 400:
                raise DaemonError(obj.get("error") or f"HTTP {resp.status}")
            return obj
        finally:
            conn.close()

    def _post_json(self, route: str, body: dict) -> dict:
        conn, resp = self._post(route, body)
        return self._read_json_response(conn, resp)

    def _post_stream(self, route: str, body: dict) -> Iterator[str]:
        """POST; yield response lines (chunked ndjson streams)."""
        conn, resp = self._post(route, body)
        yield from self._read_stream(conn, resp)

    @staticmethod
    def _read_stream(conn, resp) -> Iterator[str]:
        """Yield a chunked response's complete lines — the ONE reader
        behind both streaming verbs (error decode + line split)."""
        try:
            if resp.status >= 400:
                data = resp.read()
                try:
                    msg = json.loads(data).get("error")
                except Exception:  # noqa: BLE001
                    msg = data.decode(errors="replace")
                raise DaemonError(msg or f"HTTP {resp.status}")
            buf = b""
            while True:
                chunk = resp.read1(65536)
                if not chunk:
                    break
                buf += chunk
                while b"\n" in buf:
                    line, buf = buf.split(b"\n", 1)
                    yield line.decode(errors="replace") + "\n"
            if buf:
                yield buf.decode(errors="replace")
        finally:
            conn.close()

    def _get_json(self, route: str, params: dict) -> dict:
        from urllib.parse import urlencode

        conn = self._conn()
        conn.request(
            "GET", f"{route}?{urlencode(params)}", headers=self._headers()
        )
        return self._read_json_response(conn, conn.getresponse())

    def _get_stream(self, route: str, params: dict) -> Iterator[str]:
        """GET; yield response lines (chunked ndjson streams — the GET
        twin of :meth:`_post_stream`)."""
        from urllib.parse import urlencode

        conn = self._conn()
        conn.request(
            "GET", f"{route}?{urlencode(params)}", headers=self._headers()
        )
        yield from self._read_stream(conn, conn.getresponse())

    # -------------------------------------------------------------- verbs

    def _queue(
        self,
        route: str,
        composition: dict,
        priority: int = 0,
        created_by: dict | None = None,
        trace_parent: str = "",
    ) -> str:
        """POST /run or /build; parse the chunked rpc response for the
        task id (``ParseRunResponse``, ``client.go:402``). A non-empty
        ``trace_parent`` rides the standard ``traceparent`` header so
        the daemon roots the task's lifecycle span tree at the
        submitter's span (tracectx.py)."""
        from ..rpc import Chunk

        body = {"composition": composition, "priority": priority}
        if created_by:
            body["created_by"] = created_by
        task_id = ""
        conn = self._conn()
        headers = self._headers()
        if trace_parent:
            headers["traceparent"] = trace_parent
        conn.request("POST", route, json.dumps(body), headers)
        for line in self._read_stream(conn, conn.getresponse()):
            try:
                c = Chunk.from_json(line)
            except Exception:  # noqa: BLE001 — ignore non-chunk noise
                continue
            if c.type == "e" and c.error:
                raise DaemonError(c.error)
            if c.type == "r" and isinstance(c.payload, dict):
                task_id = c.payload.get("task_id", "")
        if not task_id:
            raise DaemonError(f"daemon {route} returned no task id")
        return task_id

    def run(
        self,
        composition: dict,
        priority: int = 0,
        created_by: dict | None = None,
        trace_parent: str = "",
    ) -> str:
        return self._queue(
            "/run", composition, priority, created_by, trace_parent
        )

    def build(
        self,
        composition: dict,
        priority: int = 0,
        created_by: dict | None = None,
        trace_parent: str = "",
    ) -> str:
        return self._queue(
            "/build", composition, priority, created_by, trace_parent
        )

    def tasks(
        self, states=None, types=None, before=None, after=None, limit=0
    ) -> list[dict]:
        return self._post_json(
            "/tasks",
            {
                "states": states,
                "types": types,
                "before": before,
                "after": after,
                "limit": limit,
            },
        )["tasks"]

    def status(self, task_id: str) -> dict:
        return self._post_json("/status", {"task_id": task_id})["task"]

    def stats(self, task_id: str) -> dict:
        """GET /stats — a task's sim telemetry summary (the ``tg stats``
        backend): identity + the journal's sim/telemetry/events sections."""
        return self._get_json("/stats", {"task_id": task_id})

    def perf(self, task_id: str) -> dict:
        """GET /perf — a task's performance-ledger payload (the ``tg
        perf`` backend): identity + the journal's sim block + the
        sim.perf ledger + task-level queue/runner timings."""
        return self._get_json("/perf", {"task_id": task_id})

    def diff(self, a: str, b: str, planes=None) -> dict:
        """GET /diff — the differential run analysis of two tasks (the
        ``tg diff`` backend; docs/OBSERVABILITY.md "Run diff"): exact
        counter comparison + noise-aware throughput verdicts, built
        daemon-side so archived tasks diff over HTTP."""
        params = {"a": a, "b": b}
        if planes:
            params["planes"] = (
                planes if isinstance(planes, str) else ",".join(planes)
            )
        return self._get_json("/diff", params)

    def fleet(self) -> dict:
        """GET /fleet — the daemon's live fleet snapshot (the ``tg top``
        backend): per-state counts over the FULL task store, queue
        depth by priority, worker occupancy, and live task rows."""
        return self._get_json("/fleet", {})

    def metrics(self) -> str:
        """GET /metrics — the daemon's Prometheus text exposition
        (task gauges, flow counters, perf gauges)."""
        conn = self._conn()
        conn.request("GET", "/metrics", headers=self._headers())
        resp = conn.getresponse()
        try:
            data = resp.read()
            if resp.status >= 400:
                raise DaemonError(
                    data.decode(errors="replace")[:500]
                    or f"HTTP {resp.status}"
                )
            return data.decode(errors="replace")
        finally:
            conn.close()

    def events(self, since: int = 0, follow: bool = False) -> Iterator[dict]:
        """GET /events — tail the daemon's control-plane event journal
        (``daemon_events.jsonl``) as ndjson dicts. One-shot by default
        (the server appends a ``{"type": "_tail", "offset": N}`` trailer
        for resume); ``follow=True`` keeps the stream open."""
        params = {"since": str(since), "follow": "1" if follow else "0"}
        for line in self._get_stream("/events", params):
            line = line.strip()
            if not line:
                continue  # follow-mode heartbeat
            try:
                yield json.loads(line)
            except ValueError:
                continue  # tolerant-reader rule: skip foreign noise

    def artifact(self, task_id: str, name: str, run: str = "") -> bytes:
        """GET /artifact — fetch one whitelisted run-outputs file (e.g.
        ``task_spans.jsonl`` for ``tg trace --lifecycle`` against a
        remote daemon) as raw bytes."""
        from urllib.parse import urlencode

        params = {"task_id": task_id, "name": name}
        if run:
            params["run"] = run
        conn = self._conn()
        conn.request(
            "GET", f"/artifact?{urlencode(params)}", headers=self._headers()
        )
        resp = conn.getresponse()
        try:
            data = resp.read()
            if resp.status >= 400:
                try:
                    msg = json.loads(data).get("error")
                except Exception:  # noqa: BLE001
                    msg = data.decode(errors="replace")[:500]
                raise DaemonError(msg or f"HTTP {resp.status}")
            return data
        finally:
            conn.close()

    def trace(self, task_id: str, limit: int = 0) -> dict:
        """GET /trace — a task's flight-recorder events (the ``tg trace``
        backend): the journal's trace summary plus the recorded
        ``sim_trace.jsonl`` events (``limit`` > 0 truncates)."""
        params = {"task_id": task_id}
        if limit:
            params["limit"] = str(limit)
        return self._get_json("/trace", params)

    def stream(
        self, task_id: str, follow: bool = True, families=None
    ) -> Iterator[dict]:
        """GET /stream — follow a task's live observability rows
        (telemetry / perf / SLO breaches / run spans) as ndjson: the
        ``tg watch`` backend (docs/OBSERVABILITY.md "Run health
        plane"). Yields one dict per row; the stream closes when the
        task finishes (an already-finished task replays its history,
        then closes)."""
        params: dict = {"task_id": task_id, "follow": "1" if follow else "0"}
        if families:
            params["families"] = ",".join(families)
        for line in self._get_stream("/stream", params):
            line = line.strip()
            if not line:
                continue
            try:
                yield json.loads(line)
            except ValueError:
                continue  # tolerant-reader rule: skip foreign noise

    def logs(self, task_id: str, follow: bool = False) -> Iterator[str]:
        return self._post_stream(
            "/logs", {"task_id": task_id, "follow": follow}
        )

    def collect_outputs(self, runner: str, run_id: str, sink) -> None:
        conn, resp = self._post("/outputs", {"runner": runner, "run_id": run_id})
        try:
            if resp.status >= 400:
                data = resp.read()
                try:
                    msg = json.loads(data).get("error")
                except Exception:  # noqa: BLE001
                    msg = data.decode(errors="replace")
                raise DaemonError(msg or f"HTTP {resp.status}")
            while True:
                chunk = resp.read1(1 << 16)
                if not chunk:
                    break
                sink.write(chunk)
        finally:
            conn.close()

    def terminate(self, runner: str = "", builder: str = "") -> str:
        body = {"builder": builder} if builder else {"runner": runner}
        return self._post_json("/terminate", body)["output"]

    def healthcheck(self, runner: str, fix: bool = False) -> tuple[Report, str]:
        obj = self._post_json("/healthcheck", {"runner": runner, "fix": fix})
        rep = Report(
            checks=[CheckResult(**c) for c in obj["report"].get("checks", [])],
            fixes=[CheckResult(**f) for f in obj["report"].get("fixes", [])],
        )
        return rep, obj.get("output", "")

    def kill(self, task_id: str) -> bool:
        return bool(self._post_json("/kill", {"task_id": task_id})["killed"])

    def preempt(self, task_id: str) -> dict:
        """POST /preempt — checkpoint and requeue a running task
        (``client.py:367-375``)."""
        return self._post_json("/preempt", {"task_id": task_id})

    def drain(self, timeout_secs: float = 30.0) -> dict:
        """POST /drain — stop claiming, checkpoint and requeue the running
        runs, then shut the daemon down."""
        return self._post_json("/drain", {"timeout_secs": timeout_secs})

    def delete(self, task_id: str) -> bool:
        """Delete a finished task's record + log (``daemon.go:88``)."""
        return bool(
            self._post_json("/delete", {"task_id": task_id})["deleted"]
        )

    def describe_plan(self, plan: str):
        """Fetch a daemon-hosted plan's manifest (GET /describe)."""
        from ..api import TestPlanManifest

        obj = self._get_json("/describe", {"plan": plan})
        return TestPlanManifest.from_dict(obj["manifest"])

    def build_purge(self, builder: str, testplan: str = "") -> str:
        return self._post_json(
            "/build/purge", {"builder": builder, "testplan": testplan}
        )["output"]

    def import_plan(self, source_dir: str, name: str = "") -> str:
        """Tar.gz the plan dir and POST it to /plan/import (the reference
        ships sources as tars inside /run requests, ``client.go:84-228``);
        returns the name the daemon imported it under."""
        buf = io.BytesIO()
        base = os.path.basename(os.path.abspath(source_dir).rstrip("/"))
        with tarfile.open(fileobj=buf, mode="w:gz") as tar:
            tar.add(
                source_dir,
                arcname=base,
                filter=lambda ti: None
                if "__pycache__" in ti.name or "/.git" in ti.name
                else ti,
            )
        conn = self._conn()
        route = "/plan/import" + (f"?name={quote(name, safe='')}" if name else "")
        conn.request(
            "POST",
            route,
            buf.getvalue(),
            self._headers("application/gzip"),
        )
        obj = self._read_json_response(conn, conn.getresponse())
        return obj["imported"]


class RemoteEngine:
    """Engine-shaped facade over :class:`Client` for the CLI."""

    def __init__(self, client: Client, env):
        self.client = client
        self.env = env

    # -- queueing: manifest/sources resolve on the daemon side
    def queue_run(
        self, comp, manifest=None, sources_dir="", priority=0,
        created_by=None, trace_parent="", **_,
    ):
        return self.client.run(
            comp.to_dict(), priority,
            created_by.to_dict() if created_by else None,
            trace_parent=trace_parent,
        )

    def queue_build(
        self, comp, manifest=None, sources_dir="", priority=0,
        created_by=None, trace_parent="", **_,
    ):
        return self.client.build(
            comp.to_dict(), priority,
            created_by.to_dict() if created_by else None,
            trace_parent=trace_parent,
        )

    def get_task(self, task_id: str) -> Task | None:
        try:
            return Task.from_dict(self.client.status(task_id))
        except DaemonError:
            return None

    def task_stats(self, task_id: str) -> dict:
        """One round trip to the daemon's /stats route (the remote half
        of ``tg stats``; in-process engines assemble the same payload
        via Task.stats_payload)."""
        return self.client.stats(task_id)

    def task_perf(self, task_id: str) -> dict:
        """One round trip to the daemon's /perf route (the remote half
        of ``tg perf``; in-process engines assemble the same payload
        via Task.perf_payload)."""
        return self.client.perf(task_id)

    def task_trace(self, task_id: str, limit: int = 0) -> dict:
        """One round trip to the daemon's /trace route (the remote half
        of ``tg trace``; in-process engines read the run outputs via
        sim.trace.read_trace_events)."""
        return self.client.trace(task_id, limit=limit)

    def diff_tasks(self, a: str, b: str, planes=None) -> dict:
        """One round trip to the daemon's /diff route, named like
        Engine.diff_tasks so ``tg diff`` works identically in-process
        and remote (the document is built daemon-side by the same
        engine method)."""
        return self.client.diff(a, b, planes=planes)

    def fleet_payload(self) -> dict:
        """The daemon's /fleet route, shaped like Engine.fleet_payload
        so ``tg top`` works identically in-process and remote."""
        return self.client.fleet()

    def event_rows(self, since: int = 0, follow: bool = False):
        """The daemon's /events route (control-plane journal tail)."""
        return self.client.events(since=since, follow=follow)

    def task_artifact(self, task_id: str, name: str, run: str = "") -> bytes:
        """One whitelisted run-outputs file as raw bytes (the remote
        half of ``tg trace --lifecycle``; in-process engines read the
        outputs dir directly)."""
        return self.client.artifact(task_id, name, run=run)

    def stream_rows(
        self, task_id: str, follow: bool = True, cancel=None, families=None
    ) -> Iterator[dict]:
        """The daemon's /stream route, shaped like Engine.stream_rows so
        ``tg watch`` / ``-f`` followers work identically in-process and
        remote."""
        return self.client.stream(task_id, follow=follow, families=families)

    def tasks(
        self, states=None, types=None, before=None, after=None, limit=0, **_
    ) -> list[Task]:
        return [
            Task.from_dict(d)
            for d in self.client.tasks(
                states=states,
                types=types,
                before=before,
                after=after,
                limit=limit,
            )
        ]

    def logs(self, task_id: str, follow: bool = False, **_) -> Iterator[str]:
        return self.client.logs(task_id, follow=follow)

    def do_collect_outputs(self, runner_id, run_id, w, ow) -> None:
        self.client.collect_outputs(runner_id, run_id, w)

    def do_terminate(self, ref, ow, ctype: str = "runner") -> None:
        if ctype == "builder":
            out = self.client.terminate(builder=ref)
        else:
            out = self.client.terminate(runner=ref)
        if out:
            print(out, end="")

    def do_healthcheck(self, runner_id, fix, ow):
        report, out = self.client.healthcheck(runner_id, fix)
        if out:
            print(out, end="")
        return report

    def do_build_purge(self, builder_id, testplan, ow) -> None:
        out = self.client.build_purge(builder_id, testplan)
        if out:
            print(out, end="")

    def kill(self, task_id: str) -> bool:
        return self.client.kill(task_id)

    def preempt(self, task_id: str) -> dict:
        return self.client.preempt(task_id)

    def drain(self, timeout_secs: float = 30.0) -> dict:
        return self.client.drain(timeout_secs=timeout_secs)

    def delete_task(self, task_id: str) -> bool:
        return self.client.delete(task_id)

    def stop(self) -> None:  # no engine owned client-side
        pass
