"""Blocking sync-service client used by the SDK inside instances.

The analog of sdk-go's ``sync.Client`` (``SignalEntry``, ``SignalAndWait``,
``Barrier``, ``Publish``, ``Subscribe``, ``PublishSubscribe`` — usage:
``plans/network/pingpong.go:54,180,225``). Speaks the JSON-lines protocol of
:mod:`testground_tpu_torch.sync.server`.

Failure hardening (docs/CROSSHOST.md):

- **Bounded reconnect.** Initial connects AND mid-run drops retry with
  exponential backoff + jitter under a configurable attempt/deadline
  budget (:class:`SyncRetry`). When the budget is exhausted every
  blocked caller gets a typed :class:`SyncLostError` (address, attempt
  count) instead of hanging forever.
- **Resume semantics.** After a reconnect the client re-subscribes every
  live topic and discards the replayed prefix up to the last seq it
  delivered, re-arms in-flight barriers, and re-sends unacked mutations
  with their original idempotency token — the service deduplicates, so
  at-least-once wire delivery stays exactly-once in effect.
- **Restart detection.** Every connection handshake reads the server's
  boot id; a changed boot id means the service restarted and lost its
  coordination state, which surfaces as :class:`SyncLostError` rather
  than silently resuming against an empty world.
- **Heartbeats.** A background pinger keeps the connection visibly live
  (feeding the server's idle sweep) and detects half-open connections —
  a partitioned server that still has an ESTABLISHED socket — by pong
  timeout, forcing the drop/reconnect path.

The port's copy of the reference's ``testground_tpu/sync/client.py``
(ROADMAP's copy policy); only its imports name the port's own modules.
"""

from __future__ import annotations

import json
import queue
import random
import socket
import threading
import time
import uuid
from dataclasses import dataclass
from typing import Any, Iterator

from .errors import SyncLostError

__all__ = ["SyncClient", "SyncRetry"]


@dataclass
class SyncRetry:
    """Connect/reconnect budget (threaded from runner config through
    ``RunParams`` — see ``sdk/runparams.py``)."""

    # per-attempt TCP connect + ping-handshake timeout (was a hardcoded
    # 30 s create_connection timeout)
    connect_timeout: float = 30.0
    # per-outage budget: give up after this many connection attempts...
    attempts: int = 8
    # ...or this much wall clock, whichever comes first
    deadline_secs: float = 60.0
    backoff_base: float = 0.1
    backoff_cap: float = 2.0
    # liveness pings (0 disables); also what keeps the server's idle
    # sweep from evicting a healthy-but-quiet instance
    heartbeat_secs: float = 5.0
    # missing-pong window before the connection is declared half-open;
    # 0 → max(2 * heartbeat_secs, 1.0)
    pong_timeout: float = 0.0

    def effective_pong_timeout(self) -> float:
        return self.pong_timeout or max(2.0 * self.heartbeat_secs, 1.0)


@dataclass
class _Pending:
    op: str
    args: dict
    q: queue.Queue


@dataclass
class _Sub:
    topic: str  # already namespaced
    q: queue.Queue
    delivered: int = 0  # last topic seq handed to the consumer


class SyncClient:
    def __init__(
        self,
        host: str,
        port: int,
        namespace: str = "",
        retry: SyncRetry | None = None,
        identity: dict | None = None,
        connect_timeout: float | None = None,
    ):
        """``namespace`` scopes all states/topics, normally
        ``run:<run_id>:`` (the reference scopes keys by run).

        ``identity`` (optional) is sent as a ``hello`` so the service can
        publish an eviction event if this client dies abnormally:
        ``{"events_topic": ..., "group": ..., "instance": ...}``.

        ``connect_timeout`` is a convenience override of
        ``retry.connect_timeout`` for callers that only care about the
        legacy knob.
        """
        self._ns = namespace
        self._addr = (host, port)
        self._retry = retry or SyncRetry()
        if connect_timeout is not None:
            self._retry.connect_timeout = float(connect_timeout)
        self._identity = dict(identity) if identity else None

        self._lock = threading.Lock()  # client state (never held during I/O)
        self._wlock = threading.Lock()  # serializes socket writes
        self._pending: dict[int, _Pending] = {}
        self._subs: dict[int, _Sub] = {}
        self._next_id = 0
        self._epoch = 0
        self._connected = False
        self._closed = False
        self._lost: SyncLostError | None = None
        self._boot: str | None = None
        self._sock: socket.socket | None = None
        self._wfile = None
        self._hb_wake = threading.Event()

        parts = self._connect_with_budget(initial=True)
        with self._lock:
            epoch, resend = self._install_locked(parts)
        self._replay(resend, epoch)

        self._heartbeat: threading.Thread | None = None
        if self._retry.heartbeat_secs > 0:
            self._heartbeat = threading.Thread(
                target=self._heartbeat_loop, daemon=True, name="tg-sync-hb"
            )
            self._heartbeat.start()

    # --------------------------------------------------------- connection

    def _connect_once(self):
        """One TCP connect + ping handshake (+ hello); raises OSError-ish
        on any failure, including a server that accepted but won't answer
        (half-open / stopped)."""
        host, port = self._addr
        sock = socket.create_connection(
            (host, port), timeout=self._retry.connect_timeout
        )
        try:
            sock.settimeout(self._retry.connect_timeout)
            wfile = sock.makefile("w", encoding="utf-8")
            rfile = sock.makefile("r", encoding="utf-8")
            wfile.write(json.dumps({"id": 0, "op": "ping"}) + "\n")
            wfile.flush()
            line = rfile.readline()
            if not line:
                raise ConnectionError("closed during handshake")
            msg = json.loads(line)
            if not msg.get("pong"):
                raise ConnectionError(f"bad handshake reply: {line.strip()!r}")
            boot = msg.get("boot", "")
            if self._identity is not None:
                wfile.write(
                    json.dumps({"id": 0, "op": "hello", **self._identity})
                    + "\n"
                )
                wfile.flush()
                if not rfile.readline():
                    raise ConnectionError("closed during hello")
            sock.settimeout(None)
            return sock, rfile, wfile, boot
        except BaseException:
            try:
                sock.close()
            except OSError:
                pass
            raise

    def _connect_with_budget(self, initial: bool):
        """Attempt/deadline-bounded connect loop with exponential backoff
        + jitter; raises :class:`SyncLostError` naming the address."""
        r = self._retry
        max_attempts = max(1, r.attempts) if initial else r.attempts
        start = time.monotonic()
        deadline = start + r.deadline_secs
        attempt = 0
        last_err: BaseException | None = None
        while True:
            if self._closed:
                raise SyncLostError(
                    f"sync client closed while connecting to "
                    f"{self._addr[0]}:{self._addr[1]}",
                    address=self._addr,
                    attempts=attempt,
                    elapsed_secs=time.monotonic() - start,
                )
            if attempt < max_attempts and time.monotonic() < deadline:
                attempt += 1
                try:
                    return self._connect_once()
                except (OSError, ValueError, ConnectionError) as e:
                    last_err = e
            else:
                elapsed = time.monotonic() - start
                raise SyncLostError(
                    f"sync service at {self._addr[0]}:{self._addr[1]} "
                    f"unreachable after {attempt} attempt(s) over "
                    f"{elapsed:.1f}s: {last_err}",
                    address=self._addr,
                    attempts=attempt,
                    elapsed_secs=elapsed,
                )
            backoff = min(r.backoff_cap, r.backoff_base * (2 ** (attempt - 1)))
            sleep = backoff * (0.5 + random.random() / 2)  # jitter
            if time.monotonic() + sleep >= deadline and attempt >= 1:
                # sleeping past the deadline can't help; fail fast on the
                # next loop iteration
                sleep = max(0.0, deadline - time.monotonic())
            time.sleep(sleep)

    def _install_locked(self, parts) -> tuple[int, list[dict]]:
        """Adopt a fresh connection (lock held): boot-id check, re-key
        live subscriptions and unacked calls, start the new reader
        thread. Returns the replay requests for the caller to send
        AFTER releasing the lock — the master lock is never held across
        socket I/O (a stalled peer blocking a replay write must not
        wedge the heartbeat that exists to detect exactly that)."""
        sock, rfile, wfile, boot = parts
        if self._boot is not None and boot and boot != self._boot:
            try:
                sock.close()
            except OSError:
                pass
            raise SyncLostError(
                f"sync service at {self._addr[0]}:{self._addr[1]} restarted "
                "(boot id changed); coordination state was lost",
                address=self._addr,
            )
        if boot:
            self._boot = boot
        self._sock = sock
        self._wfile = wfile
        self._epoch += 1
        self._connected = True
        epoch = self._epoch

        # re-key live subscriptions and pending calls onto fresh request
        # ids; the caller replays them once the lock is released
        resend: list[dict] = []
        subs, self._subs = self._subs, {}
        for sub in subs.values():
            rid = self._next_rid_locked()
            self._subs[rid] = sub
            resend.append({"id": rid, "op": "subscribe", "topic": sub.topic})
        pending, self._pending = self._pending, {}
        for p in pending.values():
            if p.op == "bye":
                continue
            rid = self._next_rid_locked()
            self._pending[rid] = p
            resend.append({"id": rid, "op": p.op, **p.args})

        threading.Thread(
            target=self._read_loop,
            args=(epoch, rfile),
            daemon=True,
            name="tg-sync-client",
        ).start()
        return epoch, resend

    def _replay(self, resend: list[dict], epoch: int) -> None:
        # pinned to the epoch the requests were re-keyed for: if yet
        # another reconnect supersedes it mid-replay, ITS replay owns
        # the re-send (double-sending would leak server-side waiters)
        for req in resend:
            self._send(req, epoch=epoch)

    # ------------------------------------------------------------- plumbing

    def _next_rid_locked(self) -> int:
        self._next_id += 1
        return self._next_id

    def _send(
        self,
        req: dict,
        wait_secs: float | None = None,
        epoch: int | None = None,
    ) -> bool:
        """Best-effort send OUTSIDE the state lock; returns whether the
        bytes were written. A failed or skipped write leaves the request
        parked in ``_pending``/``_subs`` for the reconnect replay (the
        reader/heartbeat notices the dead socket and drives
        reconnection).

        Socket writes can block indefinitely when the peer stalls with a
        full send buffer (a SIGSTOPped server), so the write lock is
        acquired with a bound: if another writer is wedged on it, this
        request simply stays pending — and the WEDGED writer is released
        when the heartbeat force-closes the socket. The client's master
        lock is never held across socket I/O."""
        with self._lock:
            if epoch is not None and epoch != self._epoch:
                # the connection this request was registered against is
                # gone; the reconnect replay owns (or owned) the re-send
                return False
            wfile = self._wfile if self._connected else None
        if wfile is None:
            return False
        timeout = (
            wait_secs if wait_secs is not None else self._retry.connect_timeout
        )
        if not self._wlock.acquire(timeout=timeout):
            return False
        try:
            wfile.write(json.dumps(req) + "\n")
            wfile.flush()
            return True
        except (OSError, ValueError):
            return False
        finally:
            self._wlock.release()

    def _read_loop(self, epoch: int, rfile) -> None:
        try:
            for line in rfile:
                try:
                    msg = json.loads(line)
                except json.JSONDecodeError:
                    continue
                rid = msg.get("id")
                with self._lock:
                    if epoch != self._epoch:
                        return  # superseded connection
                    p = self._pending.get(rid)
                    sub = self._subs.get(rid)
                if p is not None and "entry" not in msg:
                    with self._lock:
                        self._pending.pop(rid, None)
                    p.q.put(msg)
                elif sub is not None:
                    if "entry" in msg:
                        seq = int(msg.get("seq", 0))
                        deliver = False
                        with self._lock:
                            if seq > sub.delivered:
                                sub.delivered = seq
                                deliver = True
                        if deliver:  # replayed prefix after reconnect: skip
                            sub.q.put(msg)
                    else:
                        sub.q.put(msg)
        except (OSError, ValueError):
            pass
        self._conn_lost(epoch)

    def _conn_lost(self, epoch: int) -> None:
        """Reader exit path: poison on user close, otherwise reconnect
        within budget (in this thread — it has nothing else to do)."""
        with self._lock:
            if self._closed or self._lost is not None:
                self._poison_locked({"error": "connection closed"})
                return
            if epoch != self._epoch:
                return
            self._connected = False
            self._close_sock_locked()
        try:
            parts = self._connect_with_budget(initial=False)
            with self._lock:
                if self._closed:
                    try:
                        parts[0].close()
                    except OSError:
                        pass
                    self._poison_locked({"error": "connection closed"})
                    return
                epoch, resend = self._install_locked(parts)
            self._replay(resend, epoch)
        except SyncLostError as e:
            with self._lock:
                self._lost = e
                self._poison_locked({"sync_lost": str(e)})

    def _poison_locked(self, msg: dict) -> None:
        for p in self._pending.values():
            p.q.put(dict(msg))
        for sub in self._subs.values():
            sub.q.put(dict(msg))
        self._pending.clear()

    def _close_sock_locked(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None
            self._wfile = None

    def _heartbeat_loop(self) -> None:
        interval = self._retry.heartbeat_secs
        pong = self._retry.effective_pong_timeout()
        # consecutive rounds whose ping could not even be WRITTEN (write
        # lock held by a possibly-wedged writer): one busy round is
        # normal under write load and must not kill a healthy
        # connection, but a persistently unavailable write path means a
        # writer is wedged on a stalled socket — force the drop then.
        unsent_rounds = 0
        while not self._hb_wake.wait(interval):
            with self._lock:
                if self._closed or self._lost is not None:
                    return
                if not self._connected:
                    unsent_rounds = 0
                    continue  # reconnect in progress
                sock = self._sock
                rid = self._next_rid_locked()
                hb_epoch = self._epoch
                q: queue.Queue = queue.Queue()
                self._pending[rid] = _Pending(op="ping", args={}, q=q)
            # short write-lock bound: a wedged writer must not delay the
            # detector that exists to un-wedge it
            sent = self._send(
                {"id": rid, "op": "ping"}, wait_secs=0.2, epoch=hb_epoch
            )
            if not sent:
                with self._lock:
                    self._pending.pop(rid, None)
                unsent_rounds += 1
                if unsent_rounds < 3:
                    continue  # transient write-lock contention
            else:
                unsent_rounds = 0
                try:
                    q.get(timeout=pong)
                    continue  # healthy
                except queue.Empty:
                    with self._lock:
                        self._pending.pop(rid, None)
            # no pong (half-open / stopped server) or persistently
            # unwritable socket: force the drop so the reader runs the
            # reconnect path (and any wedged writer gets an OSError)
            unsent_rounds = 0
            with self._lock:
                if self._connected and self._sock is sock and sock:
                    try:
                        sock.shutdown(socket.SHUT_RDWR)
                    except OSError:
                        pass
                    try:
                        sock.close()
                    except OSError:
                        pass

    def _call(
        self, op: str, _send_wait: float | None = None, **args: Any
    ) -> queue.Queue:
        q: queue.Queue = queue.Queue()
        with self._lock:
            if self._lost is not None:
                raise SyncLostError(
                    str(self._lost),
                    address=self._lost.address,
                    attempts=self._lost.attempts,
                    elapsed_secs=self._lost.elapsed_secs,
                )
            if self._closed:
                raise RuntimeError("sync client is closed")
            rid = self._next_rid_locked()
            epoch = self._epoch
            if op == "subscribe":
                self._subs[rid] = _Sub(topic=args["topic"], q=q)
            else:
                self._pending[rid] = _Pending(op=op, args=dict(args), q=q)
        self._send(
            {"id": rid, "op": op, **args}, wait_secs=_send_wait, epoch=epoch
        )
        return q

    def _call_one(
        self,
        op: str,
        timeout: float | None = None,
        _send_wait: float | None = None,
        **args: Any,
    ) -> dict:
        q = self._call(op, _send_wait=_send_wait, **args)
        try:
            msg = q.get(timeout=timeout)
        except queue.Empty:
            with self._lock:  # forget the call: don't replay it later
                for rid, p in list(self._pending.items()):
                    if p.q is q:
                        del self._pending[rid]
            raise TimeoutError(
                f"sync op {op} timed out "
                f"(service {self._addr[0]}:{self._addr[1]})"
            ) from None
        if "sync_lost" in msg:
            raise SyncLostError(
                msg["sync_lost"], address=self._addr
            )
        if "error" in msg:
            raise RuntimeError(f"sync op {op} failed: {msg['error']}")
        return msg

    def _key(self, name: str) -> str:
        return self._ns + name

    # ------------------------------------------------------------------ API

    @property
    def address(self) -> tuple[str, int]:
        return self._addr

    def ping(self, timeout: float | None = None) -> str:
        """Liveness probe; returns the server's boot id."""
        return self._call_one("ping", timeout=timeout).get("boot", "")

    def sync_stats(self, timeout: float | None = None) -> dict:
        """The server's stats plane (docs/INSTANCE_PROTOCOL.md §4.2).

        Version negotiation is by reply shape, so this client tolerates
        old servers: a reply carrying ``"v": 2`` has the full stats
        blocks — per-op counters (``ops``), connection churn (``conn``),
        barrier lifecycle (``barriers``, incl. armed→release episode
        timing by fan-in target on the python server), pubsub depth
        (``pubsub``), idempotency-dedup hits (``dedup``) and per-op
        service-time histograms (``op_time_us``, python server only) —
        while a reply without ``v`` is a pre-stats v1 server and only
        the live-occupancy fields ``{"conns", "waiters", "subs",
        "boot"}`` (present in both versions) exist."""
        msg = self._call_one("sync_stats", timeout=timeout)
        return {k: v for k, v in msg.items() if k != "id"}

    def signal_entry(self, state: str) -> int:
        return self._call_one(
            "signal_entry", state=self._key(state), token=uuid.uuid4().hex
        )["seq"]

    def counter(self, state: str) -> int:
        return self._call_one("counter", state=self._key(state))["count"]

    def barrier(self, state: str, target: int, timeout: float | None = None) -> None:
        self._call_one(
            "barrier", state=self._key(state), target=target, timeout=timeout
        )

    def signal_and_wait(
        self, state: str, target: int, timeout: float | None = None
    ) -> int:
        return self._call_one(
            "signal_and_wait",
            state=self._key(state),
            target=target,
            timeout=timeout,
            token=uuid.uuid4().hex,
        )["seq"]

    def publish(self, topic: str, payload: Any) -> int:
        return self._call_one(
            "publish",
            topic=self._key(topic),
            payload=payload,
            token=uuid.uuid4().hex,
        )["seq"]

    def subscribe(self, topic: str, timeout: float | None = None) -> Iterator[Any]:
        """Yield every entry of the topic in order (all entries from the
        beginning, like the reference's Subscribe). Raises
        :class:`SyncLostError` if the service is lost mid-stream; a
        deliberate ``close()`` ends the iterator normally.

        The subscription is unregistered when the iterator exits for ANY
        reason (timeout, error, the consumer abandoning it) — an
        abandoned subscription must not keep accumulating entries and
        being replayed on every reconnect."""
        q = self._call("subscribe", topic=self._key(topic))
        try:
            while True:
                try:
                    msg = q.get(timeout=timeout)
                except queue.Empty:
                    raise TimeoutError(
                        f"subscribe {topic} timed out"
                    ) from None
                if "sync_lost" in msg:
                    raise SyncLostError(msg["sync_lost"], address=self._addr)
                if "error" in msg:
                    return
                yield msg["entry"]
        finally:
            with self._lock:
                # by queue identity: reconnects re-key the rid
                for rid, sub in list(self._subs.items()):
                    if sub.q is q:
                        del self._subs[rid]

    def publish_subscribe(
        self, topic: str, payload: Any, timeout: float | None = None
    ) -> tuple[int, Iterator[Any]]:
        seq = self.publish(topic, payload)
        return seq, self.subscribe(topic, timeout=timeout)

    def close(self) -> None:
        """Clean shutdown: tells the server (``bye``) so no eviction
        event is published, then drops the connection."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._hb_wake.set()
            was_connected = self._connected
        if was_connected:
            self._send({"id": 0, "op": "bye"}, wait_secs=0.5)
        with self._lock:
            self._close_sock_locked()
            self._poison_locked({"error": "connection closed"})
