"""In-memory sync service.

Semantics (matching the reference sync service as used by
``plans/network/pingpong.go``, ``plans/example/sync.go``,
``plans/benchmarks/benchmarks.go``):

- ``signal_entry(state) -> seq``: atomic counter increment returning the
  1-based sequence number of this signaller.
- ``barrier(state, target)``: block until the state's counter >= target.
- ``signal_and_wait(state, target)``: both, returning the seq.
- ``publish(topic, payload) -> seq``: append to an ordered topic stream.
- ``subscribe(topic)``: iterator over ALL entries of the topic from the
  beginning — every subscriber sees every entry, in order.

The port's copy of the reference's ``testground_tpu/sync/inmem.py``
(ROADMAP's copy policy); only its imports name the port's own modules.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Any, Iterator

__all__ = ["InMemSyncService"]

# FIFO bound on remembered idempotency tokens: only a reconnecting
# client's unacked window (seconds of traffic) ever replays, so the cap
# bounds memory over week-long runs without a realistic double-apply.
MAX_TOKENS = 65536


class InMemSyncService:
    """Thread-safe coordination state for one or more runs.

    Keys are namespaced by run id by callers (the SDK prefixes
    ``run:<run_id>:``), matching the reference's key scoping.
    """

    def __init__(self):
        self._lock = threading.Condition()
        # optional sync-plane stats sink (sync/stats.py SyncStats): the
        # TCP server wires it so dedup hits, pubsub depth and barrier
        # lifecycle are accounted at the layer that owns the semantics;
        # None (the default) keeps this class dependency- and cost-free
        self.stats = None
        self._counters: dict[str, int] = {}
        self._topics: dict[str, list[Any]] = {}
        # idempotency tokens: a reconnecting client re-sends unacked
        # mutations with the token of the original attempt, and the
        # service answers with the original result instead of mutating
        # twice (at-least-once wire delivery → exactly-once effect);
        # FIFO-bounded at MAX_TOKENS entries each
        self._sig_tokens: dict[tuple[str, str], int] = {}
        self._sig_token_order: deque[tuple[str, str]] = deque()
        self._pub_tokens: dict[tuple[str, str], int] = {}
        self._pub_token_order: deque[tuple[str, str]] = deque()

    @staticmethod
    def _remember(tokens: dict, order: deque, key: tuple, seq: int) -> None:
        if key in tokens:
            return
        tokens[key] = seq
        order.append(key)
        while len(order) > MAX_TOKENS:
            tokens.pop(order.popleft(), None)

    # ------------------------------------------------------------- signals

    def signal_entry(self, state: str, token: str | None = None) -> int:
        with self._lock:
            if token is not None:
                prev = self._sig_tokens.get((state, token))
                if prev is not None:
                    if self.stats is not None:
                        self.stats.dedup_hit("signal")
                    return prev
            self._counters[state] = self._counters.get(state, 0) + 1
            seq = self._counters[state]
            if token is not None:
                self._remember(
                    self._sig_tokens, self._sig_token_order, (state, token), seq
                )
            self._lock.notify_all()
            return seq

    def counter(self, state: str) -> int:
        with self._lock:
            return self._counters.get(state, 0)

    def counters_snapshot(self, states) -> dict[str, int]:
        """Batched counter read for the event-loop server's coalesced
        release pass: after a drain touches many states, ONE lock
        acquisition answers all of them (the release decision then fans
        out every satisfiable waiter in one sweep)."""
        with self._lock:
            get = self._counters.get
            return {s: get(s, 0) for s in states}

    def barrier(
        self,
        state: str,
        target: int,
        timeout: float | None = None,
        cancel: threading.Event | None = None,
    ) -> None:
        """Block until ``counter(state) >= target``."""
        st = self.stats
        if st is not None:
            st.barrier_parked(state, target)
        with self._lock:
            ok = self._lock.wait_for(
                lambda: self._counters.get(state, 0) >= target
                or (cancel is not None and cancel.is_set()),
                timeout=timeout,
            )
        if cancel is not None and cancel.is_set():
            if st is not None:
                st.barrier_canceled(state, target)
            raise InterruptedError(f"barrier {state} canceled")
        if not ok:
            if st is not None:
                st.barrier_timed_out(state, target)
            raise TimeoutError(f"barrier {state} (target {target}) timed out")
        if st is not None:
            st.barrier_released(state, target)

    def signal_and_wait(
        self,
        state: str,
        target: int,
        timeout: float | None = None,
        cancel: threading.Event | None = None,
        token: str | None = None,
    ) -> int:
        seq = self.signal_entry(state, token=token)
        self.barrier(state, target, timeout=timeout, cancel=cancel)
        return seq

    # -------------------------------------------------------------- pub/sub

    def publish(self, topic: str, payload: Any, token: str | None = None) -> int:
        with self._lock:
            if token is not None:
                prev = self._pub_tokens.get((topic, token))
                if prev is not None:
                    if self.stats is not None:
                        self.stats.dedup_hit("publish")
                    return prev
            entries = self._topics.setdefault(topic, [])
            entries.append(payload)
            if self.stats is not None:
                self.stats.pubsub_published(len(entries))
            if token is not None:
                self._remember(
                    self._pub_tokens,
                    self._pub_token_order,
                    (topic, token),
                    len(entries),
                )
            self._lock.notify_all()
            return len(entries)

    def topic_len(self, topic: str) -> int:
        with self._lock:
            return len(self._topics.get(topic, []))

    def pubsub_gauges(self) -> tuple[int, int]:
        """Live (non-empty topics, total entries) for ``sync_stats`` v2.
        Non-empty so both backends agree: the C++ server's topic map
        grows an empty record on subscribe, this one does not."""
        with self._lock:
            nonempty = sum(1 for v in self._topics.values() if v)
            entries = sum(len(v) for v in self._topics.values())
        return nonempty, entries

    def get_entries(self, topic: str, start: int = 0) -> list[Any]:
        with self._lock:
            return list(self._topics.get(topic, [])[start:])

    def entries_since(self, topic: str, start: int) -> tuple[int, list[Any]]:
        """(topic length, entries[start:]) in one lock acquisition — the
        event-loop server's fanout pass reads each touched topic once
        per drain and distributes to every subscriber cursor from it."""
        with self._lock:
            entries = self._topics.get(topic)
            if not entries:
                return 0, []
            return len(entries), list(entries[start:])

    def subscribe(
        self,
        topic: str,
        timeout: float | None = None,
        cancel: threading.Event | None = None,
    ) -> Iterator[Any]:
        """Yield every entry of the topic from the beginning, then block for
        new ones. Terminates when ``cancel`` is set (or ``timeout`` elapses
        between entries)."""
        cursor = 0
        while True:
            with self._lock:
                ok = self._lock.wait_for(
                    lambda: len(self._topics.get(topic, [])) > cursor
                    or (cancel is not None and cancel.is_set()),
                    timeout=timeout,
                )
                if cancel is not None and cancel.is_set():
                    return
                if not ok:
                    raise TimeoutError(f"subscribe {topic} timed out")
                entries = self._topics[topic][cursor:]
                cursor = len(self._topics[topic])
            yield from entries

    def publish_subscribe(
        self,
        topic: str,
        payload: Any,
        timeout: float | None = None,
        cancel: threading.Event | None = None,
    ) -> tuple[int, Iterator[Any]]:
        seq = self.publish(topic, payload)
        return seq, self.subscribe(topic, timeout=timeout, cancel=cancel)

    # --------------------------------------------------------------- admin

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._topics.clear()
            self._sig_tokens.clear()
            self._sig_token_order.clear()
            self._pub_tokens.clear()
            self._pub_token_order.clear()
            self._lock.notify_all()
