"""TCP sync service.

The ``local:exec`` runner's infra piece: the analog of the reference's
Redis-backed sync-service container (``pkg/runner/local_common.go:77-104``),
implemented as a newline-delimited-JSON TCP server over
:class:`InMemSyncService`.

Wire protocol (one JSON object per line):

    request:  {"id": N, "op": <op>, ...args}
    reply:    {"id": N, ...result}            exactly one, except:
    subscribe streams {"id": N, "entry": payload, "seq": i} frames until the
    connection closes.

Ops: ``signal_entry(state[, token])``, ``barrier(state, target)``,
``signal_and_wait(state, target[, token])``, ``publish(topic, payload[,
token])``, ``subscribe(topic)``, ``counter(state)``, plus the liveness/
identity plane (docs/CROSSHOST.md):

- ``ping`` → ``{"pong": true, "boot": <id>}`` — heartbeat + boot-id probe
  (a changed boot id tells a reconnecting client the service restarted
  and lost its state);
- ``hello(events_topic, group, instance)`` — registers the connection's
  instance identity; an ABNORMAL disconnect (anything but ``bye``)
  publishes ``{"type": "evicted", ...}`` to ``events_topic`` so runners
  and surviving instances observe the death;
- ``bye`` — clean-shutdown marker (no eviction event);
- ``sync_stats`` → the wire-versioned stats plane (v2, ``"v": 2``):
  the v1 live-occupancy fields ``{"conns", "waiters", "subs"}`` (the
  observable that pins "a dead client's barrier occupancy is
  released") plus per-op counters, service-time log2 histograms,
  barrier lifecycle timing, pubsub depth/high-water marks, connection
  churn and idempotency-dedup hit counts (``sync/stats.py``,
  docs/INSTANCE_PROTOCOL.md §4.2).

``token`` is an idempotency key: reconnecting clients re-send unacked
mutations with the original token and the service replies with the
original seq instead of mutating twice.

Architecture (the 10k fan-in rewrite — docs/CROSSHOST.md "Server
architecture"): a ``selectors``-based EVENT LOOP, not thread-per-
connection. The r1 fan-in bench measured the old
``socketserver.ThreadingTCPServer`` + per-op-thread design collapsing at
10k clients (10k accept threads + one thread per parked barrier: accepts
everything, then stops servicing). Now:

- every connection is a non-blocking socket with its own read buffer and
  a BOUNDED outbound queue (``outq_limit``, default 16 MiB — parity with
  the native server's ``--max-wbuf``): a slow or stalled reader is shed
  (dropped + counted as an eviction) the moment its backlog trips the
  bound, and can never wedge any other peer;
- parked barriers and subscriptions are RECORDS, not threads; each drain
  of ready sockets dispatches every complete line, applies mutations,
  then runs ONE coalesced release pass (one
  ``InMemSyncService.counters_snapshot`` for all touched states, every
  satisfiable waiter fanned out in one sweep) and ONE fanout pass per
  touched topic (entries fetched once, payload JSON encoded once,
  streamed to every subscriber cursor);
- replies are buffered per connection and flushed once per drain via
  ``socket.sendmsg`` (writev) — many frames, one syscall;
- barrier deadlines, evict-grace windows and the idle sweep ride a
  hashed TIMER WHEEL owned by the loop (the old per-disconnect
  ``threading.Timer`` spray is gone);
- connections can optionally be SHARDED across N loops (``shards``;
  cross-shard releases ride per-loop inboxes + a wakeup pipe). The
  default is one loop — under the GIL extra Python loops buy little,
  the knob exists for symmetry with the native server and for
  experiments off-GIL.

The server binds ``host`` (default loopback; ``0.0.0.0`` opens it to
other hosts — the ``cluster_k8s.go:302`` network-citizen analog) and,
when ``idle_timeout`` is set, sweeps connections that have sent nothing
(not even a heartbeat) for that long: a SIGSTOPped or half-open peer is
evicted, its parked barrier/subscribe waiters released, and its eviction
published, rather than leaking occupancy forever.

This Python server is the behavioral spec; a wire-compatible native C++
implementation (sharded epoll loops) lives at
``testground_tpu_torch/native/syncsvc.cc`` and is what the local:exec runner
boots by default when a toolchain is available (runner config
``sync_service``, default "auto").

Runnable standalone (the cross-host deployment unit, also wrapped by
``tg sync-service``)::

    python -m testground_tpu_torch.sync.server --host 0.0.0.0 --port 9042

prints ``LISTENING <host> <port>`` once bound and serves until
SIGTERM/SIGINT.

The port's copy of the reference's ``testground_tpu/sync/server.py``
(ROADMAP's copy policy); only its imports name the port's own modules.
"""

from __future__ import annotations

import itertools
import json
import selectors
import socket
import threading
import time
import uuid
from collections import deque

from ..logging_ import S

from .inmem import InMemSyncService
from .stats import SyncStats

__all__ = ["SyncServiceServer"]

# bounded per-peer outbound queue: a reader this far behind has stopped
# reading (or is partitioned with an open window) — shedding it beats
# wedging memory/fairness for everyone else; parity with the native
# server's kMaxWbuf default
DEFAULT_OUTQ_LIMIT = 16 << 20

_RECV_SIZE = 262144
_WRITEV_SEGS = 64  # segments per sendmsg flush


class _TimerWheel:
    """Hashed timer wheel: O(1) arm/cancel, fired in batches by the
    owning event loop — replaces the per-waiter ``wait_for`` timeouts
    and per-disconnect ``threading.Timer`` spray of the threaded server.
    Granularity is coarse (50 ms) on purpose: barrier deadlines, grace
    windows and idle sweeps are second-scale contracts."""

    __slots__ = ("_g", "_buckets")

    def __init__(self, granularity: float = 0.05):
        self._g = granularity
        self._buckets: dict[int, list] = {}

    def arm(self, now: float, delay: float, fn) -> list:
        """Schedule ``fn`` after ``delay``; returns a cancel handle."""
        slot = int((now + max(0.0, delay)) / self._g) + 1
        handle = [fn]
        self._buckets.setdefault(slot, []).append(handle)
        return handle

    @staticmethod
    def cancel(handle: list) -> None:
        handle[0] = None

    def next_due(self, now: float) -> float | None:
        """Seconds until the nearest armed slot, or None when empty."""
        if not self._buckets:
            return None
        return max(0.0, min(self._buckets) * self._g - now)

    def fire(self, now: float) -> None:
        if not self._buckets:
            return
        cur = int(now / self._g)
        due = [s for s in self._buckets if s <= cur]
        for s in sorted(due):
            for handle in self._buckets.pop(s):
                fn = handle[0]
                if fn is not None:
                    fn()


class _Conn:
    __slots__ = (
        "sock",
        "fd",
        "loop",
        "rbuf",
        "out",
        "out_bytes",
        "want_write",
        "last_activity",
        "hello",
        "clean",
        "dead",
        "waiters",
        "subs",
    )

    def __init__(self, sock: socket.socket, loop: "_EventLoop"):
        self.sock = sock
        self.fd = sock.fileno()
        self.loop = loop
        self.rbuf = bytearray()
        self.out: deque[bytes] = deque()
        self.out_bytes = 0
        self.want_write = False
        self.last_activity = time.monotonic()
        self.hello: dict | None = None
        self.clean = False
        self.dead = False
        self.waiters: list[_Waiter] = []
        self.subs: list[_SubRec] = []


class _Waiter:
    """A parked barrier / signal_and_wait record (no thread)."""

    __slots__ = ("conn", "rid", "state", "target", "seq", "t0", "timer",
                 "alive")

    def __init__(self, conn, rid, state, target, seq, t0):
        self.conn = conn
        self.rid = rid
        self.state = state
        self.target = target
        self.seq = seq  # None for plain barrier; echoed for signal_and_wait
        self.t0 = t0  # dispatch stamp: release records the FULL fan-in wait
        self.timer = None
        self.alive = True


class _SubRec:
    __slots__ = ("conn", "rid", "topic", "cursor", "alive")

    def __init__(self, conn, rid, topic):
        self.conn = conn
        self.rid = rid
        self.topic = topic
        self.cursor = 0
        self.alive = True


class _Occupancy:
    """Live waiter/subscriber accounting exposed via ``sync_stats``."""

    def __init__(self, stats: SyncStats | None = None):
        self._lock = threading.Lock()
        self.stats = stats
        self.waiters = 0
        self.subs = 0

    def inc(self, kind: str) -> None:
        with self._lock:
            setattr(self, kind, getattr(self, kind) + 1)
            w, s = self.waiters, self.subs
        if self.stats is not None:  # high-water marks
            self.stats.note_occupancy(w, s)

    def dec(self, kind: str, n: int = 1) -> None:
        with self._lock:
            setattr(self, kind, getattr(self, kind) - n)


class _EventLoop(threading.Thread):
    """One selector loop owning a shard of the connections.

    Drain cycle: select → read every ready socket and dispatch all
    complete lines (mutations applied, touched states/topics recorded)
    → fire due timers → ONE coalesced release pass + fanout pass →
    flush every dirty connection with sendmsg (writev)."""

    def __init__(self, server: "SyncServiceServer", index: int):
        super().__init__(daemon=True, name=f"tg-sync-loop-{index}")
        self.server = server
        self.index = index
        self.sel = selectors.DefaultSelector()
        self.conns: dict[int, _Conn] = {}
        self.waiters_by_state: dict[str, list[_Waiter]] = {}
        self.subs_by_topic: dict[str, list[_SubRec]] = {}
        self.wheel = _TimerWheel()
        self._inbox: deque = deque()
        self._inbox_lock = threading.Lock()
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._wake_w.setblocking(False)
        self.sel.register(self._wake_r, selectors.EVENT_READ, "wake")
        # per-drain scratch (reset each cycle); foreign = forwarded by
        # another loop's pass — processed here but NEVER re-broadcast
        # (re-forwarding would ping-pong touches between loops forever)
        self._touched_states: set[str] = set()
        self._touched_topics: set[str] = set()
        self._foreign_states: set[str] = set()
        self._foreign_topics: set[str] = set()
        self._dirty: set[_Conn] = set()
        self._op_done: list = []  # (op, us) — inline ops, batch-flushed
        self._op_timed: list = []  # (op, us) — released parked ops
        self._task_ops: dict = {}  # task → ops this drain (hello attr.)
        self._compact_states: set[str] = set()
        self._compact_topics: set[str] = set()

    # ----------------------------------------------------- cross-thread

    def post(self, item) -> None:
        with self._inbox_lock:
            self._inbox.append(item)
        try:
            self._wake_w.send(b"\x00")
        except (BlockingIOError, OSError):
            pass  # wake byte already pending (or loop gone)

    # -------------------------------------------------------------- run

    def run(self) -> None:
        srv = self.server
        if self.index == 0:
            self.sel.register(srv._listener, selectors.EVENT_READ, "accept")
        if srv.idle_timeout > 0:
            self._arm_idle_sweep()
        while not srv._stop.is_set():
            # a late mutation (e.g. an eviction published from a flush-
            # time drop) can leave touched keys behind after the passes
            # ran — spin one zero-timeout cycle rather than sleeping on
            # undelivered releases
            if (
                self._touched_states
                or self._touched_topics
                or self._foreign_states
                or self._foreign_topics
            ):
                timeout = 0.0
            else:
                timeout = self.wheel.next_due(time.monotonic())
            try:
                events = self.sel.select(timeout)
            except OSError:
                continue
            now = time.monotonic()
            for key, mask in events:
                tag = key.data
                if tag == "wake":
                    try:
                        while self._wake_r.recv(4096):
                            pass
                    except (BlockingIOError, OSError):
                        pass
                elif tag == "accept":
                    self._accept_ready()
                else:
                    conn: _Conn = tag
                    if conn.dead:
                        continue
                    if mask & selectors.EVENT_WRITE:
                        self._flush(conn)
                    if mask & selectors.EVENT_READ and not conn.dead:
                        self._on_readable(conn, now)
            self._drain_inbox()
            # release BEFORE the wheel fires: a barrier satisfied by a
            # signal in this same drain must release, not time out (the
            # native server and the old wait_for both check the
            # predicate first); timers that publish (evict-grace) leave
            # touched keys behind and the zero-timeout spin above
            # delivers them next cycle
            self._release_pass()
            self._fanout_pass()
            self.wheel.fire(now)
            self._compact()
            if self._op_done and srv.stats is not None:
                srv.stats.op_done_batch(self._op_done)
            if self._op_timed and srv.stats is not None:
                srv.stats.time_op_batch(self._op_timed)
            if self._task_ops and srv.stats is not None:
                srv.stats.task_ops_batch(self._task_ops)
            self._op_done = []
            self._op_timed = []
            self._task_ops = {}
            dirty, self._dirty = self._dirty, set()
            for conn in dirty:
                if not conn.dead:
                    self._flush(conn)
        # shutdown: close this shard's connections
        for conn in list(self.conns.values()):
            try:
                conn.sock.close()
            except OSError:
                pass
        self.sel.close()
        try:
            self._wake_r.close()
            self._wake_w.close()
        except OSError:
            pass

    # ----------------------------------------------------------- accept

    def _accept_ready(self) -> None:
        srv = self.server
        while True:
            try:
                sock, _ = srv._listener.accept()
            except (BlockingIOError, OSError):
                return
            try:
                sock.setblocking(False)
                sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            except OSError:
                sock.close()
                continue
            loop = srv._loops[srv._next_shard]
            srv._next_shard = (srv._next_shard + 1) % len(srv._loops)
            if loop is self:
                self._adopt(sock)
            else:
                loop.post(("conn", sock))

    def _adopt(self, sock: socket.socket) -> None:
        conn = _Conn(sock, self)
        self.conns[conn.fd] = conn
        try:
            self.sel.register(sock, selectors.EVENT_READ, conn)
        except (ValueError, OSError):
            conn.dead = True
            self.conns.pop(conn.fd, None)
            sock.close()
            return
        st = self.server.stats
        if st is not None:
            st.conn_open()

    def _drain_inbox(self) -> None:
        if not self._inbox:
            return
        with self._inbox_lock:
            items, self._inbox = self._inbox, deque()
        for item in items:
            kind = item[0]
            if kind == "conn":
                self._adopt(item[1])
            elif kind == "touch":
                self._foreign_states.update(item[1])
                self._foreign_topics.update(item[2])

    # ------------------------------------------------------------- read

    def _on_readable(self, conn: _Conn, now: float) -> None:
        try:
            data = conn.sock.recv(_RECV_SIZE)
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            self._drop(conn)
            return
        if not data:
            self._drop(conn)
            return
        conn.last_activity = now
        buf = conn.rbuf
        buf += data
        start = 0
        while True:
            nl = buf.find(b"\n", start)
            if nl < 0:
                break
            line = bytes(buf[start:nl])
            start = nl + 1
            if line:
                self._dispatch(conn, line)
                if conn.dead:
                    return
        if start:
            del buf[:start]

    # --------------------------------------------------------- dispatch

    def _dispatch(self, conn: _Conn, line: bytes) -> None:
        srv = self.server
        svc = srv.service
        stats = srv.stats
        perf = time.perf_counter
        t_op = perf()
        try:
            req = json.loads(line)
        except (json.JSONDecodeError, UnicodeDecodeError):
            req = None
        if not isinstance(req, dict):  # `5` / `null` are lines too
            self._send_json(conn, {"id": -1, "error": "malformed request"})
            return
        rid = req.get("id", -1)
        op = req.get("op")
        # hello attribution (docs/CROSSHOST.md): every op from a
        # connection that introduced itself with a task id counts toward
        # that task — accumulated per drain, batch-flushed like _op_done
        # so the hot path takes no stats lock
        if stats is not None and conn.hello:
            _task = conn.hello.get("task", "")
            if _task:
                self._task_ops[_task] = self._task_ops.get(_task, 0) + 1
        out: dict | None = None
        try:
            if op == "signal_entry":
                out = {
                    "id": rid,
                    "seq": svc.signal_entry(
                        req["state"], token=req.get("token")
                    ),
                }
                self._touched_states.add(req["state"])
            elif op == "counter":
                out = {"id": rid, "count": svc.counter(req["state"])}
            elif op == "publish":
                out = {
                    "id": rid,
                    "seq": svc.publish(
                        req["topic"], req["payload"], token=req.get("token")
                    ),
                }
                self._touched_topics.add(req["topic"])
            elif op == "ping":
                out = {"id": rid, "pong": True, "boot": srv.boot_id}
            elif op == "hello":
                hello = {
                    "events_topic": req.get("events_topic", ""),
                    "group": req.get("group", ""),
                    "instance": req.get("instance", -1),
                    # run-id attribution for per-task op counters; ""
                    # from old clients that don't send it (wire-compat:
                    # the field is additive in both directions)
                    "task": req.get("task", ""),
                }
                _ident_retag(srv, conn.hello, hello)
                conn.hello = hello
                out = {"id": rid, "ok": True, "boot": srv.boot_id}
            elif op == "bye":
                conn.clean = True
                out = {"id": rid, "ok": True}
            elif op == "sync_stats":
                payload = {
                    "id": rid,
                    "conns": sum(len(lp.conns) for lp in srv._loops),
                    "waiters": srv.occupancy.waiters,
                    "subs": srv.occupancy.subs,
                    "boot": srv.boot_id,
                }
                if stats is not None:  # v2: v1 fields preserved
                    # flush this drain's accounting, then count this
                    # very query BEFORE snapshotting — the conservation
                    # contract: a sync_stats reply includes itself
                    if self._op_done:
                        stats.op_done_batch(self._op_done)
                        self._op_done = []
                    if self._op_timed:
                        stats.time_op_batch(self._op_timed)
                        self._op_timed = []
                    if self._task_ops:
                        stats.task_ops_batch(self._task_ops)
                        self._task_ops = {}
                    stats.op_done(op, (perf() - t_op) * 1e6)
                    topics, entries = svc.pubsub_gauges()
                    payload.update(
                        stats.snapshot(topics=topics, entries=entries)
                    )
                self._send_json(conn, payload)
                return
            elif op == "barrier" or op == "signal_and_wait":
                if stats is not None:  # parked ops count at dispatch
                    stats.count_op(op)
                # validate EVERY field before any mutation or parking: a
                # malformed request must produce exactly one error reply
                # — never a parked waiter that later answers a second
                # time, nor a half-applied signal
                state = req["state"]
                target = int(req["target"])
                timeout = req.get("timeout")
                delay = None if timeout is None else max(0.0, float(timeout))
                seq = None
                if op == "signal_and_wait":
                    seq = svc.signal_entry(state, token=req.get("token"))
                if stats is not None:
                    stats.barrier_parked(state, target)
                w = _Waiter(conn, rid, state, target, seq, t_op)
                conn.waiters.append(w)
                self.waiters_by_state.setdefault(state, []).append(w)
                srv.occupancy.inc("waiters")
                if delay is not None:
                    # an EXPLICIT 0 is an immediate non-blocking check:
                    # unmet after this drain's release pass → timed out
                    w.timer = self.wheel.arm(
                        time.monotonic(),
                        delay,
                        lambda w=w: self._expire_waiter(w),
                    )
                    if delay == 0.0:
                        self._touched_states.add(state)
                        self._release_pass()
                        if w.alive:
                            self._expire_waiter(w)
                        return
                self._touched_states.add(state)
            elif op == "subscribe":
                topic = req["topic"]
                rec = _SubRec(conn, rid, topic)
                conn.subs.append(rec)
                self.subs_by_topic.setdefault(topic, []).append(rec)
                srv.occupancy.inc("subs")
                if stats is not None:
                    self._op_done.append((op, (perf() - t_op) * 1e6))
                self._touched_topics.add(topic)
            else:
                self._send_json(
                    conn, {"id": rid, "error": f"unknown op {op!r}"}
                )
            if out is not None:
                if stats is not None:
                    self._op_done.append((op, (perf() - t_op) * 1e6))
                self._send_json(conn, out)
        except KeyError as e:
            # the op still counts: the native server counts at dispatch
            # before field extraction, so a malformed request must not
            # diverge the backends' op counters
            if stats is not None and out is None and op not in (
                "barrier", "signal_and_wait",
            ):
                stats.count_op(op)
            self._send_json(conn, {"id": rid, "error": f"missing field {e}"})
        except (TypeError, ValueError) as e:
            self._send_json(conn, {"id": rid, "error": str(e)})

    # --------------------------------------------- release/fanout passes

    def _release_pass(self) -> None:
        local = self._touched_states
        states = local | self._foreign_states
        if not states:
            return
        self._touched_states = set()
        self._foreign_states = set()
        srv = self.server
        if local and len(srv._loops) > 1:
            # forward only LOCALLY-originated touches so other loops'
            # waiters see them; forwarded ones are terminal here
            for lp in srv._loops:
                if lp is not self:
                    lp.post(("touch", tuple(local), ()))
        counts = srv.service.counters_snapshot(states)
        stats = srv.stats
        for state in states:
            lst = self.waiters_by_state.get(state)
            if not lst:
                continue
            count = counts.get(state, 0)
            keep: list[_Waiter] = []
            released: dict[int, int] = {}  # target -> n (episode batch)
            n_released = 0
            for w in lst:
                if not w.alive:
                    continue
                if w.target <= count:
                    self._reply_waiter(w)
                    n_released += 1
                    released[w.target] = released.get(w.target, 0) + 1
                    if stats is not None:
                        op = (
                            "signal_and_wait" if w.seq is not None
                            else "barrier"
                        )
                        self._op_timed.append(
                            (op, (time.perf_counter() - w.t0) * 1e6)
                        )
                else:
                    keep.append(w)
            if stats is not None:
                for target, n in released.items():
                    stats.barrier_released_batch(state, target, n)
            if n_released:
                srv.occupancy.dec("waiters", n_released)
            if keep:
                self.waiters_by_state[state] = keep
            else:
                self.waiters_by_state.pop(state, None)

    def _reply_waiter(self, w: _Waiter) -> None:
        w.alive = False
        if w.timer is not None:
            _TimerWheel.cancel(w.timer)
        rid = w.rid
        if isinstance(rid, int):
            if w.seq is not None:
                frame = b'{"id": %d, "seq": %d, "ok": true}\n' % (rid, w.seq)
            else:
                frame = b'{"id": %d, "ok": true}\n' % rid
            self._enqueue(w.conn, frame)
        else:
            obj = {"id": rid, "ok": True}
            if w.seq is not None:
                obj["seq"] = w.seq
            self._send_json(w.conn, obj)
        try:
            w.conn.waiters.remove(w)
        except ValueError:
            pass

    def _expire_waiter(self, w: _Waiter) -> None:
        if not w.alive:
            return
        w.alive = False
        stats = self.server.stats
        if stats is not None:
            stats.barrier_timed_out(w.state, w.target)
            self._op_timed.append(
                (
                    "signal_and_wait" if w.seq is not None else "barrier",
                    (time.perf_counter() - w.t0) * 1e6,
                )
            )
        self.server.occupancy.dec("waiters")
        self._send_json(
            w.conn,
            {
                "id": w.rid,
                "error": f"barrier {w.state} (target {w.target}) timed out",
            },
        )
        try:
            w.conn.waiters.remove(w)
        except ValueError:
            pass
        self._compact_states.add(w.state)

    def _fanout_pass(self) -> None:
        local = self._touched_topics
        topics = local | self._foreign_topics
        if not topics:
            return
        self._touched_topics = set()
        self._foreign_topics = set()
        srv = self.server
        if local and len(srv._loops) > 1:
            for lp in srv._loops:
                if lp is not self:
                    lp.post(("touch", (), tuple(local)))
        svc = srv.service
        for topic in topics:
            subs = self.subs_by_topic.get(topic)
            if not subs:
                continue
            live = [s for s in subs if s.alive]
            if not live:
                continue
            mn = min(s.cursor for s in live)
            total, entries = svc.entries_since(topic, mn)
            if total == 0:
                continue
            encoded: list[bytes | None] = [None] * len(entries)
            for s in live:
                while s.cursor < total:
                    idx = s.cursor - mn
                    enc = encoded[idx]
                    if enc is None:
                        enc = encoded[idx] = json.dumps(
                            entries[idx]
                        ).encode("utf-8")
                    s.cursor += 1
                    if isinstance(s.rid, int):
                        frame = (
                            b'{"id": %d, "entry": ' % s.rid
                            + enc
                            + b', "seq": %d}\n' % s.cursor
                        )
                    else:
                        frame = (
                            json.dumps(
                                {
                                    "id": s.rid,
                                    "entry": entries[idx],
                                    "seq": s.cursor,
                                }
                            ).encode("utf-8")
                            + b"\n"
                        )
                    self._enqueue(s.conn, frame)
                    if s.conn.dead:
                        break

    def _compact(self) -> None:
        """Purge dead waiter/sub records from the per-key indexes (the
        per-drain batch form of the threaded server's thread exits)."""
        if self._compact_states:
            for state in self._compact_states:
                lst = self.waiters_by_state.get(state)
                if lst is None:
                    continue
                lst = [w for w in lst if w.alive]
                if lst:
                    self.waiters_by_state[state] = lst
                else:
                    self.waiters_by_state.pop(state, None)
            self._compact_states = set()
        if self._compact_topics:
            for topic in self._compact_topics:
                lst = self.subs_by_topic.get(topic)
                if lst is None:
                    continue
                lst = [s for s in lst if s.alive]
                if lst:
                    self.subs_by_topic[topic] = lst
                else:
                    self.subs_by_topic.pop(topic, None)
            self._compact_topics = set()

    # ------------------------------------------------------------ write

    def _send_json(self, conn: _Conn, obj: dict) -> None:
        self._enqueue(conn, json.dumps(obj).encode("utf-8") + b"\n")

    def _enqueue(self, conn: _Conn, data: bytes) -> None:
        if conn.dead:
            return
        conn.out.append(data)
        conn.out_bytes += len(data)
        if conn.out_bytes > self.server.outq_limit:
            # backpressure: the peer stopped reading — shed it rather
            # than let its backlog starve every other connection
            st = self.server.stats
            if st is not None:
                st.conn_evicted()
            S().debug(
                "sync service: shedding slow reader (%d bytes queued)",
                conn.out_bytes,
            )
            self._drop(conn)
            return
        self._dirty.add(conn)

    def _flush(self, conn: _Conn) -> None:
        out = conn.out
        sock = conn.sock
        while out:
            try:
                n = sock.sendmsg(list(itertools.islice(out, _WRITEV_SEGS)))
            except (BlockingIOError, InterruptedError):
                break
            except OSError:
                self._drop(conn)
                return
            conn.out_bytes -= n
            while out and n >= len(out[0]):
                n -= len(out[0])
                out.popleft()
            if n and out:
                out[0] = out[0][n:]
        need_write = bool(out)
        if need_write != conn.want_write:
            conn.want_write = need_write
            events = selectors.EVENT_READ | (
                selectors.EVENT_WRITE if need_write else 0
            )
            try:
                self.sel.modify(sock, events, conn)
            except (KeyError, ValueError, OSError):
                pass

    # ------------------------------------------------------- disconnect

    def _drop(self, conn: _Conn) -> None:
        """The ONE disconnect path (EOF, reset, idle eviction, slow-
        reader shed, write error): release occupancy promptly, then run
        the identity/eviction-event bookkeeping."""
        if conn.dead:
            return
        conn.dead = True
        srv = self.server
        self.conns.pop(conn.fd, None)
        try:
            self.sel.unregister(conn.sock)
        except (KeyError, ValueError, OSError):
            pass
        try:
            conn.sock.close()
        except OSError:
            pass
        st = srv.stats
        if st is not None:
            st.conn_close()
        n_waiters = 0
        for w in conn.waiters:
            if w.alive:
                w.alive = False
                n_waiters += 1
                if w.timer is not None:
                    _TimerWheel.cancel(w.timer)
                if st is not None:
                    st.barrier_canceled(w.state, w.target)
                self._compact_states.add(w.state)
        conn.waiters = []
        if n_waiters:
            srv.occupancy.dec("waiters", n_waiters)
        n_subs = 0
        for s in conn.subs:
            if s.alive:
                s.alive = False
                n_subs += 1
                self._compact_topics.add(s.topic)
        conn.subs = []
        if n_subs:
            srv.occupancy.dec("subs", n_subs)
        conn.out.clear()
        conn.out_bytes = 0
        self._dirty.discard(conn)
        if conn.hello and not srv._stop.is_set():
            _note_disconnect(srv, self, conn.hello, conn.clean)

    # ------------------------------------------------------- idle sweep

    def _arm_idle_sweep(self) -> None:
        interval = max(0.1, self.server.idle_timeout / 4.0)
        self.wheel.arm(time.monotonic(), interval, self._idle_sweep)

    def _idle_sweep(self) -> None:
        srv = self.server
        if srv._stop.is_set():
            return
        now = time.monotonic()
        stale = [
            c
            for c in self.conns.values()
            if now - c.last_activity > srv.idle_timeout
        ]
        for conn in stale:
            S().debug(
                "sync service: evicting idle connection (%.1fs silent)",
                now - conn.last_activity,
            )
            if srv.stats is not None:
                srv.stats.conn_evicted()
            self._drop(conn)
        self._arm_idle_sweep()


def _ident_key(hello: dict) -> tuple:
    return (
        hello.get("events_topic", ""),
        hello.get("group", ""),
        hello.get("instance", -1),
    )


def _ident_retag(server, old: dict | None, new: dict) -> None:
    """Track live connection count per instance identity (hello)."""
    with server.ident_lock:
        if old is not None:
            k = _ident_key(old)
            n = server.identities.get(k, 0) - 1
            if n <= 0:
                server.identities.pop(k, None)
            else:
                server.identities[k] = n
        k = _ident_key(new)
        server.identities[k] = server.identities.get(k, 0) + 1


def _note_disconnect(server, loop: _EventLoop, hello: dict, clean: bool) -> None:
    """Identity bookkeeping + GRACE-windowed eviction: an abnormal
    disconnect only becomes an ``evicted`` event if no connection with
    the same identity is back within ``evict_grace`` seconds — a client
    dropping its socket to RECONNECT (heartbeat force-close, partition
    heal) must not be announced dead to the run. The grace window rides
    the owning loop's timer wheel."""
    key = _ident_key(hello)
    with server.ident_lock:
        n = server.identities.get(key, 0) - 1
        if n <= 0:
            server.identities.pop(key, None)
        else:
            server.identities[key] = n
    if clean or n > 0 or not hello.get("events_topic"):
        return

    def fire() -> None:
        if server._stop.is_set():
            return
        with server.ident_lock:
            if server.identities.get(key, 0) > 0:
                return  # the instance came back inside the grace window
        try:
            server.service.publish(
                hello["events_topic"],
                {
                    "type": "evicted",
                    "group": hello.get("group", ""),
                    "instance": hello.get("instance", -1),
                    "error": "connection lost (killed, partitioned, or "
                    "idle-evicted)",
                },
            )
        except Exception:  # noqa: BLE001 — eviction is best-effort
            return
        loop._touched_topics.add(hello["events_topic"])

    grace = float(getattr(server, "evict_grace", 0.0))
    if grace <= 0:
        fire()
        return
    loop.wheel.arm(time.monotonic(), grace, fire)


class SyncServiceServer:
    """Lifecycle wrapper; bind to an ephemeral port with ``port=0``.

    ``host`` is the bind address (default loopback — pass ``"0.0.0.0"``
    to serve other hosts); ``idle_timeout`` (seconds, 0 = disabled)
    evicts connections that have been silent for that long (heartbeating
    clients — the SDK's default — are never idle while alive, so only
    dead/partitioned peers trip the sweep); ``shards`` is the event-loop
    count (default 1; see the module docstring); ``outq_limit`` bounds
    each peer's outbound queue in bytes — a reader that far behind is
    shed instead of wedging the loop's memory and fairness.
    """

    def __init__(
        self,
        service: InMemSyncService | None = None,
        port: int = 0,
        host: str = "127.0.0.1",
        idle_timeout: float = 0.0,
        evict_grace: float = 2.0,
        stats: bool = True,
        shards: int = 1,
        outq_limit: int = DEFAULT_OUTQ_LIMIT,
    ):
        self.service = service or InMemSyncService()
        self.idle_timeout = float(idle_timeout)
        self.evict_grace = float(evict_grace)
        self.outq_limit = int(outq_limit)
        # the sync-plane stats recorder (always on by default — batched
        # python-int adds; stats=False exists for the fan-in bench's
        # instrumented-vs-uninstrumented A/B and doubles as the old-
        # server emulation for client version-tolerance tests: with it
        # off, sync_stats answers the v1 shape, no "v" field)
        self.stats: SyncStats | None = SyncStats() if stats else None
        self.service.stats = self.stats
        self.occupancy = _Occupancy(self.stats)
        self.boot_id = uuid.uuid4().hex
        # hello'd-identity → live connection count; disconnects below a
        # count of zero arm the evict_grace timer (see _note_disconnect)
        self.identities: dict = {}
        self.ident_lock = threading.Lock()
        self._stop = threading.Event()
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        # the old socketserver default backlog of 5 overflowed instantly
        # under a 1k-10k connect storm; match the native listen depth
        self._listener.listen(1024)
        self._listener.setblocking(False)
        self._next_shard = 0
        self._loops = [
            _EventLoop(self, i) for i in range(max(1, int(shards)))
        ]

    @property
    def address(self) -> tuple[str, int]:
        return self._listener.getsockname()

    def start(self) -> "SyncServiceServer":
        for loop in self._loops:
            loop.start()
        S().debug("sync service listening on %s:%d", *self.address)
        return self

    def stop(self) -> None:
        self._stop.set()
        for loop in self._loops:
            loop.post(("stop",))
        try:
            self._listener.close()
        except OSError:
            pass
        for loop in self._loops:
            loop.join(timeout=2)


def _main(argv: list[str] | None = None) -> int:
    """``python -m testground_tpu_torch.sync.server``: the standalone,
    cross-host deployment unit (also behind ``tg sync-service``)."""
    import argparse

    ap = argparse.ArgumentParser(
        prog="testground_tpu_torch.sync.server",
        description="standalone sync service (JSON-lines TCP)",
    )
    ap.add_argument("--host", default="127.0.0.1", help="bind address")
    ap.add_argument("--port", type=int, default=0, help="bind port (0=ephemeral)")
    ap.add_argument(
        "--idle-timeout",
        type=float,
        default=0.0,
        help="evict connections silent for this many seconds (0=off)",
    )
    ap.add_argument(
        "--evict-grace",
        type=float,
        default=2.0,
        help="window an abnormally-disconnected instance has to "
        "reconnect before its eviction is published (0=immediate)",
    )
    ap.add_argument(
        "--shards",
        type=int,
        default=1,
        help="event loops to shard connections across (default 1; "
        "under the GIL extra loops buy little — the knob mirrors the "
        "native server's)",
    )
    ap.add_argument(
        "--outq-limit",
        type=int,
        default=DEFAULT_OUTQ_LIMIT,
        help="per-connection outbound-queue bound in bytes; a reader "
        "this far behind is shed (slow-reader backpressure)",
    )
    ap.add_argument(
        "--no-stats",
        action="store_true",
        help="disable the sync-stats plane (sync_stats answers the v1 "
        "occupancy shape) — exists for the fan-in bench's "
        "instrumented-vs-uninstrumented A/B, not for production",
    )
    args = ap.parse_args(argv)

    srv = SyncServiceServer(
        port=args.port,
        host=args.host,
        idle_timeout=args.idle_timeout,
        evict_grace=args.evict_grace,
        stats=not args.no_stats,
        shards=args.shards,
        outq_limit=args.outq_limit,
    ).start()
    return serve_until_signal(srv)


def serve_until_signal(svc) -> int:
    """Announce ``LISTENING <host> <port>`` and serve until
    SIGTERM/SIGINT — the one serve loop behind both ``python -m
    testground_tpu_torch.sync.server`` and ``tg sync-service``. ``svc`` is any
    backend exposing ``.address``/``.stop()``."""
    import signal
    import sys

    host, port = svc.address
    print(f"LISTENING {host} {port}", flush=True)

    done = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: done.set())
    done.wait()
    svc.stop()
    print("sync service stopped", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(_main())
