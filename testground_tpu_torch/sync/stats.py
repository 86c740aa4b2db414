"""Sync-plane stats: the coordination plane's observability tier.

The sim side has six telemetry tiers (docs/OBSERVABILITY.md); until this
module the sync plane — a standalone network deployment unit since
``tg sync-service`` — exposed three occupancy integers. This is the
shared accounting core behind the wire-versioned ``sync_stats`` **v2**
op (docs/INSTANCE_PROTOCOL.md §4.2):

- **per-op counters** for every protocol op (``SYNC_OPS``), counted at
  dispatch so a ``sync_stats`` reply includes itself deterministically;
- **service-time log2 histograms** per op (µs bins; for ``barrier`` /
  ``signal_and_wait`` the recorded time is the full fan-in wait — that
  IS the latency a client observes);
- **barrier lifecycle timing**: per-waiter parked/released/timed-out/
  canceled counters plus per-episode armed→release wall time keyed by
  the fan-in target's pow2 bucket (bounded label space);
- **pubsub depth**: published entries, live topic/entry gauges, topic
  depth + subscriber high-water marks;
- **connection churn**: accepts/closes/idle-evictions + concurrent
  high-water mark;
- **idempotency-dedup hits** (signal/publish token replays).

Everything is a python int under one lock — the instrumentation is
always-on and cheap (the fan-in bench's instrumented-vs-uninstrumented
A/B is the receipt, PERF.md "Sync fan-in"); the native C++ server
(``testground_tpu_torch/native/syncsvc.cc``) mirrors the **counter-level**
fields of this schema field-for-field (pinned by
``tests/test_sync_stats.py``), while the histogram/episode richness is
python-server-only.

Also hosted here because every consumer is sync-plane-shaped and must
stay import-light (the standalone service should not drag jax in):

- :func:`fetch_sync_stats` — one-shot raw-socket ``sync_stats`` query
  (the CLI verb, the heartbeat, and the metrics exporter all use it, so
  it works identically against either backend, local or remote);
- :func:`heartbeat_line` / :func:`run_stats_heartbeat` — the
  ``tg sync-service --stats-interval`` one-line log heartbeat;
- :class:`SyncMetricsExporter` — the ``--metrics-port`` Prometheus
  endpoint (rendering via ``testground_tpu_torch/metrics/prometheus.py``).

The port's copy of the reference's ``testground_tpu/sync/stats.py``
(ROADMAP's copy policy); only its imports name the port's own modules.
"""

from __future__ import annotations

import json
import socket
import threading
import time

__all__ = [
    "SYNC_OPS",
    "TIME_BINS",
    "PARITY_FIELDS",
    "SyncStats",
    "time_bin",
    "bin_edge_us",
    "hist_quantile_us",
    "target_bucket",
    "fetch_sync_stats",
    "heartbeat_line",
    "run_stats_heartbeat",
    "SyncMetricsExporter",
]

# every wire op, in protocol-doc order (docs/INSTANCE_PROTOCOL.md §4.2)
SYNC_OPS = (
    "signal_entry",
    "counter",
    "barrier",
    "signal_and_wait",
    "publish",
    "subscribe",
    "ping",
    "hello",
    "bye",
    "sync_stats",
)

# log2 service-time bins: bin i covers [2^i, 2^(i+1)) µs, bin 0 also
# catches sub-µs, the last bin is open — 20 bins span 1µs … ≥0.5s
TIME_BINS = 20

# barrier fan-in targets bucket to their pow2 ceiling, capped so the
# label space stays bounded however big a cohort gets
MAX_TARGET_BUCKET = 1 << 20

# the counter-level v2 fields BOTH backends must expose with identical
# semantics — the wire-parity contract tests/test_sync_stats.py pins
# (histograms and barrier episodes are python-server-only richness)
PARITY_FIELDS = {
    "ops": list(SYNC_OPS),
    "conn": ["accepts", "closes", "evictions"],
    "barriers": ["parked", "released", "timed_out", "canceled"],
    "pubsub": ["published", "topics", "entries", "depth_hwm"],
    "dedup": ["signal_hits", "publish_hits"],
}


def time_bin(us: float) -> int:
    """Histogram bin for a service time in µs (log2 bins, clamped)."""
    n = int(us)
    if n < 1:
        return 0
    return min(TIME_BINS - 1, n.bit_length() - 1)


def bin_edge_us(i: int) -> float:
    """Upper edge (exclusive) of bin ``i`` in µs; inf for the open bin."""
    if i >= TIME_BINS - 1:
        return float("inf")
    return float(1 << (i + 1))


def hist_quantile_us(bins: list, q: float) -> float:
    """Interpolated quantile (µs) from log2 bins; 0.0 when empty. The
    last (open) bin answers with its lower edge — a clamped floor, the
    same open-bin rule the delivery-latency histograms use."""
    total = sum(bins)
    if total <= 0:
        return 0.0
    rank = q * total
    cum = 0.0
    for i, c in enumerate(bins):
        if c <= 0:
            continue
        lo = float(1 << i) if i else 0.0
        hi = bin_edge_us(i)
        if cum + c >= rank:
            if hi == float("inf"):
                return lo
            frac = (rank - cum) / c
            return lo + frac * (hi - lo)
        cum += c
    return float(1 << (TIME_BINS - 1))


def target_bucket(target: int) -> int:
    """Pow2 ceiling of a barrier fan-in target (bounded label space)."""
    t = max(1, int(target))
    b = 1 << (t - 1).bit_length()
    return min(b, MAX_TARGET_BUCKET)


# maximum concurrently-armed (state, target) episodes remembered; a
# barrier that never releases must not leak its arm record forever
_MAX_ARMED = 4096

# distinct task ids remembered by the hello-attribution counters; a
# long-lived service must not grow the map with every run that ever
# connected (overflow aggregates under the "" key so Σ still conserves)
_MAX_TASKS = 64


class SyncStats:
    """Thread-safe sync-plane accounting (one lock, python-int adds).

    The server wires the hooks; :meth:`snapshot` renders the v2 blocks.
    ``clock`` is injectable for deterministic timing tests.
    """

    def __init__(self, clock=time.monotonic):
        self._lock = threading.Lock()
        self._clock = clock
        self._start = clock()
        self.ops: dict[str, int] = {op: 0 for op in SYNC_OPS}
        self._op_bins: dict[str, list[int]] = {}
        self._op_total_us: dict[str, int] = {}
        self._op_max_us: dict[str, int] = {}
        # connection churn
        self.accepts = 0
        self.closes = 0
        self.evictions = 0
        self.conns_hwm = 0
        # occupancy high-water (waiters/subs gauges live server-side)
        self.waiters_hwm = 0
        self.subs_hwm = 0
        # barrier lifecycle (per-waiter counters + per-episode timing)
        self.bar_parked = 0
        self.bar_released = 0
        self.bar_timed_out = 0
        self.bar_canceled = 0
        self.episodes_armed = 0
        self.episodes_released = 0
        self._armed: dict[tuple[str, int], float] = {}
        # {pow2 target bucket: [count, total_ms, max_ms]}
        self._by_target: dict[int, list] = {}
        # pubsub
        self.published = 0
        self.depth_hwm = 0
        # idempotency dedup
        self.dedup_signal = 0
        self.dedup_publish = 0
        # hello attribution: ops per task (run) id, bounded — overflow
        # aggregates under "" so totals still conserve
        self._task_ops: dict[str, int] = {}

    # ------------------------------------------------------------- ops

    def count_op(self, op: str) -> None:
        if op not in self.ops:
            return
        with self._lock:
            self.ops[op] += 1

    def _record_time_locked(self, op: str, us: float) -> None:
        """THE one histogram write (lock held): clamp, bin, total, max."""
        n = max(0, int(us))
        bins = self._op_bins.get(op)
        if bins is None:
            bins = self._op_bins[op] = [0] * TIME_BINS
            self._op_total_us[op] = 0
            self._op_max_us[op] = 0
        bins[time_bin(n)] += 1
        self._op_total_us[op] += n
        if n > self._op_max_us[op]:
            self._op_max_us[op] = n

    def op_done(self, op: str, us: float) -> None:
        """Count + service-time in ONE lock acquisition — the hot path
        for inline-answered ops (the server calls this just before the
        reply hits the socket, so a reply a client has seen is always
        already counted)."""
        if op not in self.ops:
            return
        with self._lock:
            self.ops[op] += 1
            self._record_time_locked(op, us)

    def time_op(self, op: str, us: float) -> None:
        if op not in self.ops:
            return
        with self._lock:
            self._record_time_locked(op, us)

    # ------------------------------------------------------ batched hooks
    # The event-loop servers drain MANY ready ops per wake; these flush
    # a whole drain's accounting under ONE lock acquisition instead of
    # one per op (the hot-path half of the <5% instrumentation budget).

    def op_done_batch(self, items: list) -> None:
        """Count + time a batch of completed inline ops in one lock
        acquisition; ``items`` is ``[(op, us), ...]``."""
        if not items:
            return
        with self._lock:
            for op, us in items:
                if op not in self.ops:
                    continue
                self.ops[op] += 1
                self._record_time_locked(op, us)

    def time_op_batch(self, items: list) -> None:
        """Service-time-only batch (ops already counted at dispatch —
        the parked barrier/signal_and_wait path); ``[(op, us), ...]``."""
        if not items:
            return
        with self._lock:
            for op, us in items:
                if op in self.ops:
                    self._record_time_locked(op, us)

    def task_ops_batch(self, items: dict) -> None:
        """Fold one drain's per-task op counts (``{task: n}`` — hello
        attribution, docs/CROSSHOST.md) under one lock acquisition. The
        map is bounded: once ``_MAX_TASKS`` distinct ids are tracked,
        new ids aggregate under ``""`` so Σ over tasks still equals the
        attributed-op total."""
        if not items:
            return
        with self._lock:
            for task, n in items.items():
                key = task
                if key not in self._task_ops and len(
                    self._task_ops
                ) >= _MAX_TASKS:
                    key = ""
                self._task_ops[key] = self._task_ops.get(key, 0) + int(n)

    # ----------------------------------------------------- connections

    def conn_open(self) -> None:
        with self._lock:
            self.accepts += 1
            live = self.accepts - self.closes
            if live > self.conns_hwm:
                self.conns_hwm = live

    def conn_close(self) -> None:
        with self._lock:
            self.closes += 1

    def conn_evicted(self) -> None:
        with self._lock:
            self.evictions += 1

    def note_occupancy(self, waiters: int, subs: int) -> None:
        with self._lock:
            if waiters > self.waiters_hwm:
                self.waiters_hwm = waiters
            if subs > self.subs_hwm:
                self.subs_hwm = subs

    # --------------------------------------------------------- barriers

    def barrier_parked(self, state: str, target: int) -> None:
        with self._lock:
            self.bar_parked += 1
            key = (state, int(target))
            if key not in self._armed and len(self._armed) < _MAX_ARMED:
                self._armed[key] = self._clock()
                self.episodes_armed += 1

    def _close_episode_locked(
        self, state: str, target: int, released: bool
    ) -> None:
        """ANY terminal outcome closes the episode's arm record (lock
        held) — a timed-out/canceled episode must not pin (state,
        target) armed forever (it would block re-arming AND leak toward
        _MAX_ARMED); only a release records armed→release timing."""
        t0 = self._armed.pop((state, int(target)), None)
        if not released or t0 is None:
            return  # non-release outcome, or a later waiter of an
            # already-closed episode
        wall_ms = max(0.0, (self._clock() - t0) * 1e3)
        self.episodes_released += 1
        rec = self._by_target.setdefault(target_bucket(target), [0, 0.0, 0.0])
        rec[0] += 1
        rec[1] += wall_ms
        if wall_ms > rec[2]:
            rec[2] = wall_ms

    def _barrier_done(self, counter: str, state: str, target: int) -> None:
        with self._lock:
            setattr(self, counter, getattr(self, counter) + 1)
            self._close_episode_locked(
                state, target, counter == "bar_released"
            )

    def barrier_released(self, state: str, target: int) -> None:
        self._barrier_done("bar_released", state, target)

    def barrier_released_batch(self, state: str, target: int, n: int) -> None:
        """Coalesced barrier release: ``n`` waiters of one (state,
        target) episode released in one fan-out pass — one lock, one
        episode close (the wall recorded once, as the first releaser
        would have)."""
        if n <= 0:
            return
        with self._lock:
            self.bar_released += n
            self._close_episode_locked(state, target, True)

    def barrier_timed_out(self, state: str, target: int) -> None:
        self._barrier_done("bar_timed_out", state, target)

    def barrier_canceled(self, state: str, target: int) -> None:
        self._barrier_done("bar_canceled", state, target)

    # ----------------------------------------------------------- pubsub

    def pubsub_published(self, depth: int) -> None:
        with self._lock:
            self.published += 1
            if depth > self.depth_hwm:
                self.depth_hwm = depth

    def dedup_hit(self, kind: str) -> None:
        with self._lock:
            if kind == "signal":
                self.dedup_signal += 1
            else:
                self.dedup_publish += 1

    # --------------------------------------------------------- snapshot

    def snapshot(self, topics: int = 0, entries: int = 0) -> dict:
        """The v2 extension blocks (the server adds the v1 occupancy
        fields + ``boot`` around this). ``topics``/``entries`` are live
        pubsub gauges the caller reads from the service."""
        with self._lock:
            op_time = {
                op: {
                    "count": sum(bins),
                    "total_us": self._op_total_us[op],
                    "max_us": self._op_max_us[op],
                    "bins": list(bins),
                }
                for op, bins in self._op_bins.items()
            }
            return {
                "v": 2,
                "uptime_secs": round(self._clock() - self._start, 3),
                "ops": dict(self.ops),
                "conn": {
                    "accepts": self.accepts,
                    "closes": self.closes,
                    "evictions": self.evictions,
                    "hwm": self.conns_hwm,
                },
                "barriers": {
                    "parked": self.bar_parked,
                    "released": self.bar_released,
                    "timed_out": self.bar_timed_out,
                    "canceled": self.bar_canceled,
                    "episodes": {
                        "armed": self.episodes_armed,
                        "released": self.episodes_released,
                        "by_target": {
                            str(b): {
                                "count": rec[0],
                                "total_ms": round(rec[1], 3),
                                "max_ms": round(rec[2], 3),
                            }
                            for b, rec in sorted(self._by_target.items())
                        },
                    },
                },
                "pubsub": {
                    "published": self.published,
                    "topics": int(topics),
                    "entries": int(entries),
                    "depth_hwm": self.depth_hwm,
                    "subs_hwm": self.subs_hwm,
                },
                "dedup": {
                    "signal_hits": self.dedup_signal,
                    "publish_hits": self.dedup_publish,
                },
                "hwm": {
                    "waiters": self.waiters_hwm,
                    "subs": self.subs_hwm,
                },
                "op_time_us": op_time,
                # additive block (NOT in PARITY_FIELDS): per-task op
                # attribution from hello's `task` field — old clients
                # never send it, the native server never renders it, and
                # readers treat an absent block as "no attribution"
                "tasks": {
                    t: n for t, n in sorted(self._task_ops.items())
                },
            }


# ------------------------------------------------------------- one-shot IO


def fetch_sync_stats(
    host: str, port: int, timeout: float = 5.0
) -> dict:
    """One-shot ``sync_stats`` query over a fresh connection — works
    against either backend, v1 or v2 (the version negotiation rule:
    a reply carrying ``"v": 2`` has the stats blocks; one without is an
    old server and only the occupancy integers exist). Raises OSError-
    family errors when the service is unreachable."""
    with socket.create_connection((host, int(port)), timeout=timeout) as s:
        s.settimeout(timeout)
        s.sendall(b'{"id": 1, "op": "sync_stats"}\n')
        buf = b""
        while b"\n" not in buf:
            chunk = s.recv(65536)
            if not chunk:
                raise ConnectionError(
                    f"sync service {host}:{port} closed during sync_stats"
                )
            buf += chunk
    msg = json.loads(buf.split(b"\n", 1)[0])
    return {k: v for k, v in msg.items() if k != "id"}


def heartbeat_line(prev: dict | None, cur: dict, dt: float) -> str:
    """One log line a detached ``tg sync-service`` is debuggable from:
    occupancy + ops/s over the interval (+ cumulative eviction count)."""
    ops_now = sum((cur.get("ops") or {}).values())
    ops_prev = sum(((prev or {}).get("ops") or {}).values())
    rate = (ops_now - ops_prev) / dt if dt > 0 else 0.0
    bar = cur.get("barriers") or {}
    conn = cur.get("conn") or {}
    return (
        f"sync-stats: conns={cur.get('conns', '?')} "
        f"waiters={cur.get('waiters', '?')} subs={cur.get('subs', '?')} "
        f"ops/s={rate:.1f} ops_total={ops_now} "
        f"barriers={bar.get('released', '?')}/{bar.get('parked', '?')} "
        f"evictions={conn.get('evictions', '?')}"
    )


def run_stats_heartbeat(
    address: tuple[str, int],
    interval: float,
    stop: threading.Event,
    out=None,
) -> None:
    """Loop body of the ``--stats-interval`` heartbeat thread: every
    ``interval`` seconds query the service and print one
    :func:`heartbeat_line` (to stderr by default). Unreachability is a
    line too, not an exception — the service may be shutting down."""
    import sys

    out = out if out is not None else sys.stderr
    prev: dict | None = None
    last = time.monotonic()
    while not stop.wait(interval):
        now = time.monotonic()
        try:
            cur = fetch_sync_stats(address[0], address[1], timeout=5.0)
        except (OSError, ValueError) as e:
            print(f"sync-stats: unreachable ({e})", file=out, flush=True)
            continue
        print(heartbeat_line(prev, cur, now - last), file=out, flush=True)
        prev, last = cur, now


# ----------------------------------------------------- Prometheus exporter


class SyncMetricsExporter:
    """``tg sync-service --metrics-port``: a tiny HTTP endpoint serving
    the ``tg_sync_*`` Prometheus family at ``GET /metrics``.

    Backend-agnostic by construction: every scrape issues a one-shot
    ``sync_stats`` against the service address (python or native, local
    or remote), so the exporter never reaches into server internals and
    a scrape can never block the event loop."""

    def __init__(
        self,
        service_address: tuple[str, int],
        port: int = 0,
        host: str = "127.0.0.1",
    ):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        svc_addr = service_address

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 — stdlib handler contract
                if self.path.split("?", 1)[0] not in ("/metrics", "/"):
                    self.send_error(404)
                    return
                from ..metrics.prometheus import (
                    CONTENT_TYPE,
                    render_sync_prometheus,
                )

                try:
                    stats = fetch_sync_stats(*svc_addr, timeout=5.0)
                except (OSError, ValueError) as e:
                    self.send_error(503, explain=f"sync service: {e}")
                    return
                body = render_sync_prometheus(stats).encode("utf-8")
                self.send_response(200)
                self.send_header("Content-Type", CONTENT_TYPE)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # quiet: scrapes are periodic
                pass

        self._httpd = ThreadingHTTPServer((host, int(port)), _Handler)
        self._httpd.daemon_threads = True
        self._thread: threading.Thread | None = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self) -> "SyncMetricsExporter":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            daemon=True,
            name="tg-sync-metrics",
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread:
            self._thread.join(timeout=2)
