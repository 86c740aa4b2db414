"""The port's sync service on the wire, against the JAX package's, on the
CPU.

- **Parity matrix.** One scripted session of three clients (and a raw
  socket) runs on every pairing of client × server: {the reference's
  ``SyncClient``, the port's} × {the reference's Python server, its native
  one, the port's Python server, its native one}. Every reply equals the
  reference client's on the reference server of the same backend, and the
  final ``sync_stats`` does too, less its times; across backends the
  ``PARITY_FIELDS`` blocks and the occupancy are equal field for field.
- **Hardening twins** of ``tests/test_sync_hardening.py`` and
  ``test_sync_backpressure.py`` on the port's two backends with the port's
  client: a SIGKILLed server raises the port's ``SyncLostError``, a
  partition heals, a half-open client is swept and its eviction published,
  a stalled subscriber never delays barriers.
- **300 clients** (``test_sync_stress.py``'s envelope) held on each of the
  port's backends by the port's ``tg-fanin-driver``, whose operations the
  server's op counters conserve.
"""

import importlib
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from test_torch_sync import native_bins, no_new_sync_threads  # noqa: F401
from testground_tpu_torch.sync import SyncClient, SyncLostError, SyncRetry
from testground_tpu_torch.sync.stats import PARITY_FIELDS, fetch_sync_stats

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF, PORT = "testground_tpu", "testground_tpu_torch"


def _start(pkg, backend, bins, **kw):
    """A server of either package and backend (``.address``/``.stop()``)."""
    if backend == "python":
        server = importlib.import_module(f"{pkg}.sync.server")
        if "max_wbuf" in kw:
            kw["outq_limit"] = kw.pop("max_wbuf")
        return server.SyncServiceServer(**kw).start()
    native = importlib.import_module(f"{pkg}.native")
    return native.NativeSyncService(bins["ref" if pkg == REF else "port"], **kw)


# ------------------------------------------------------ the session


def _call(sock, rfile, req):
    sock.sendall((json.dumps(req) + "\n").encode())
    reply = json.loads(rfile.readline())
    if "boot" in reply:
        reply["boot"] = bool(reply["boot"])  # a fresh id per server
    return reply


def _raw(addr):
    """Replies of one raw connection: the server's own words, errors
    included (a client turns them into exceptions)."""
    sock = socket.create_connection(addr, timeout=10)
    rfile = sock.makefile("r", encoding="utf-8")
    reqs = [
        {"id": 1, "op": "ping"},
        {"id": 2, "op": "signal_entry", "state": "raw:x", "token": "t1"},
        {"id": 3, "op": "signal_entry", "state": "raw:x", "token": "t1"},
        {"id": 4, "op": "counter", "state": "raw:x"},
        {"id": 5, "op": "publish", "topic": "raw:T", "payload": [1, "a"],
         "token": "p1"},
        {"id": 6, "op": "publish", "topic": "raw:T", "payload": [1, "a"],
         "token": "p1"},
        {"id": 7, "op": "barrier", "state": "raw:never", "target": 4,
         "timeout": 0.1},
        {"id": 8, "op": "signal_and_wait", "state": "raw:one", "target": 1,
         "timeout": 5},
        {"id": 9, "op": "nonsense"},
        {"id": 10, "op": "counter"},
    ]
    out = [_call(sock, rfile, r) for r in reqs]
    sock.sendall(b"5\n")
    out.append(json.loads(rfile.readline()))
    rfile.close()
    sock.close()
    return out


def _settle(client):
    """Polls ``sync_stats`` until the server has processed the raw
    connection's close (it lands on the server's loop after the client's
    last reply; on a sharded server, on a loop of its own). Returns the
    last snapshot with its own polls taken out of ``ops.sync_stats``.

    ``SyncClient.close()`` sends ``bye`` but leaves the socket open while
    its reader thread holds the socket's file (the reference's client
    does so too: ROADMAP R11), so the session's three clients stay
    connected until the server stops."""
    deadline = time.monotonic() + 10
    polls = 0
    while True:
        snap = client.sync_stats(timeout=5)
        polls += 1
        if (snap["conn"]["closes"] >= 1 and snap["conns"] == 3) or \
                time.monotonic() > deadline:
            break
        time.sleep(0.05)
    assert snap["ops"]["sync_stats"] == polls
    snap["ops"]["sync_stats"] = 0
    return snap


def _session(pkg, addr):
    """One scripted session through ``pkg``'s ``SyncClient``; returns
    (replies, final sync_stats). Its traffic comes from a numpy seed."""
    sync = importlib.import_module(f"{pkg}.sync")
    retry = sync.SyncRetry(heartbeat_secs=0.0, connect_timeout=10)
    ns = "run:w:"

    def ident(i):
        return {"events_topic": ns + sync.RUN_EVENTS_TOPIC, "group": "g",
                "instance": i, "task": "task-w"}

    a = sync.SyncClient(*addr, namespace=ns, retry=retry)
    b = sync.SyncClient(*addr, namespace=ns, retry=retry, identity=ident(1))
    c = sync.SyncClient(*addr, namespace=ns, retry=retry, identity=ident(2))
    clients = [a, b, c]
    rec = [("ping", bool(a.ping(timeout=5)))]
    try:
        rng = np.random.default_rng(11)
        published = {"t0": 0, "t1": 0}
        rec.append(("signal", b.signal_entry("s0")))
        for i in range(30):
            cl = clients[int(rng.integers(3))]
            if rng.random() < 0.55:
                st = f"s{int(rng.integers(3))}"
                rec.append(("signal", st, cl.signal_entry(st)))
            else:
                tp = f"t{int(rng.integers(2))}"
                payload = {"i": i, "r": int(rng.integers(1000)),
                           "f": float(rng.random())}
                rec.append(("publish", tp, cl.publish(tp, payload)))
                published[tp] += 1
        rec += [("counter", st, a.counter(st)) for st in ("s0", "s1", "s2", "z")]
        rec.append(("barrier", a.barrier("s0", a.counter("s0"), timeout=10)))
        try:
            # the client keeps this timeout for itself and sends none, so
            # the waiter stays parked on the server
            b.barrier("never", 3, timeout=0.2)
            rec.append(("barrier-timeout", None))
        except TimeoutError:
            rec.append(("barrier-timeout", "raised"))
        got = []
        t = threading.Thread(
            target=lambda: got.append(a.signal_and_wait("gate", 2, timeout=15)),
            daemon=True)
        t.start()
        time.sleep(0.1)
        got.append(b.signal_and_wait("gate", 2, timeout=15))
        t.join(15)
        rec.append(("signal_and_wait", sorted(got)))
        sub = a.subscribe("t0", timeout=10)
        rec.append(("subscribe", [next(sub) for _ in range(published["t0"])]))
        seq, it = c.publish_subscribe("t1", {"last": True}, timeout=10)
        rec.append(("publish_subscribe", seq,
                    [next(it) for _ in range(published["t1"] + 1)]))
        rec.append(("raw", _raw(addr)))
        c.close()
        snap = _settle(a)
    finally:
        for cl in clients:
            cl.close()
    return rec, snap


def _timeless(snap):
    """A ``sync_stats`` snapshot less what moves with time: the uptime and
    boot id, the service-time sums and bins, the episodes' wall times."""
    out = json.loads(json.dumps(snap))
    out.pop("uptime_secs", None)
    out.pop("boot", None)
    if "op_time_us" in out:
        out["op_time_us"] = {op: r["count"] for op, r in out["op_time_us"].items()}
    ep = out.get("barriers", {}).get("episodes")
    if ep:
        ep["by_target"] = {k: r["count"] for k, r in ep["by_target"].items()}
    return out


def _parity(snap):
    return ({b: {f: snap[b][f] for f in fs} for b, fs in PARITY_FIELDS.items()},
            {k: snap[k] for k in ("conns", "waiters", "subs")})


@pytest.fixture(scope="module")
def baselines(native_bins):  # noqa: F811
    """The reference client on the reference server, per backend."""
    out = {}
    for backend in ("python", "native"):
        srv = _start(REF, backend, native_bins)
        try:
            out[backend] = _session(REF, srv.address)
        finally:
            srv.stop()
    return out


def test_session_covers_every_op(baselines):
    rec, snap = baselines["python"]
    assert snap["v"] == 2
    for op in ("ping", "signal_entry", "counter", "barrier", "signal_and_wait",
               "publish", "subscribe", "hello", "bye"):
        assert snap["ops"][op] > 0, op
    assert snap["dedup"] == {"signal_hits": 1, "publish_hits": 1}
    assert snap["barriers"]["timed_out"] == 1  # the raw barrier's
    assert (snap["waiters"], snap["subs"]) == (1, 2)
    assert snap["tasks"]  # hello's task attribution
    assert ("signal_and_wait", [1, 2]) in rec
    assert ("barrier-timeout", "raised") in rec


def test_backends_agree_on_the_parity_fields(baselines):
    (rec_py, py), (rec_nat, nat) = baselines["python"], baselines["native"]
    assert _parity(py) == _parity(nat)

    def no_error_text(rec):
        """The replies less the servers' error texts, and less the reply
        to a ``counter`` with no state: the Python server refuses it
        (missing field), the native one counts the empty state (0), in
        both packages."""
        out = []
        for step in rec:
            if step[0] == "raw":
                step = ("raw", [{k: ("…" if k == "error" else v)
                                 for k, v in r.items()}
                                for r in step[1] if r["id"] != 10])
            out.append(step)
        return out

    assert no_error_text(rec_py) == no_error_text(rec_nat)


@pytest.mark.parametrize("backend", ["python", "native"])
@pytest.mark.parametrize("server_pkg", [REF, PORT], ids=["ref-server", "port-server"])
@pytest.mark.parametrize("client_pkg", [REF, PORT], ids=["ref-client", "port-client"])
def test_wire_parity_matrix(no_new_sync_threads, baselines, native_bins,  # noqa: F811
                            client_pkg, server_pkg, backend):
    srv = _start(server_pkg, backend, native_bins)
    try:
        rec, snap = _session(client_pkg, srv.address)
    finally:
        srv.stop()
    want_rec, want = baselines[backend]
    assert rec == want_rec
    assert _parity(snap) == _parity(want)
    assert _timeless(snap) == _timeless(want)


# ------------------------------------------------------ hardening twins


def _fast_retry(**over) -> SyncRetry:
    kw = dict(connect_timeout=0.5, attempts=3, deadline_secs=3.0,
              backoff_base=0.05, backoff_cap=0.3, heartbeat_secs=0.2)
    kw.update(over)
    return SyncRetry(**kw)


def _spawn(backend, bins, port=0):
    """A killable server process of the port's; returns (proc, host, port)."""
    if backend == "python":
        code = ("from testground_tpu_torch.sync.server import _main; "
                f"_main(['--port', '{port}'])")
        argv = [sys.executable, "-c", code]
    else:
        argv = [bins["port"], "--port", str(port)]
    proc = subprocess.Popen(argv, cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.DEVNULL, text=True,
                            env={**os.environ, "PYTHONPATH": REPO})
    parts = proc.stdout.readline().split()
    if not parts or parts[0] != "LISTENING":
        proc.kill()
        proc.wait(10)
        pytest.fail(f"{backend} server printed {parts}")
    # the Python server prints LISTENING host port, the native one
    # LISTENING port
    return proc, "127.0.0.1", int(parts[-1])


@pytest.fixture(params=["python", "native"])
def killable(request, native_bins):  # noqa: F811
    proc, host, port = _spawn(request.param, native_bins)
    yield proc, host, port
    if proc.poll() is None:
        proc.kill()
    proc.wait(timeout=10)


@pytest.fixture(params=["python", "native"])
def idle_server(request, native_bins):  # noqa: F811
    srv = _start(PORT, request.param, native_bins, idle_timeout=0.8,
                 evict_grace=0.3)
    yield srv
    srv.stop()


def _wait_stats(client, key, value, timeout=8.0):
    deadline = time.time() + timeout
    s = {}
    while time.time() < deadline:
        s = client.sync_stats(timeout=2)
        if s.get(key) == value:
            return s
        time.sleep(0.05)
    raise AssertionError(f"sync_stats never reached {key}={value}: {s}")


def test_sigkill_mid_barrier_raises_the_ports_sync_lost(no_new_sync_threads,  # noqa: F811
                                                        killable):
    proc, host, port = killable
    c = SyncClient(host, port, retry=_fast_retry(attempts=2, deadline_secs=2))
    got = []

    def park():
        try:
            c.barrier("never", 5, timeout=60)
        except BaseException as e:  # noqa: BLE001
            got.append(e)

    t = threading.Thread(target=park, daemon=True)
    t.start()
    time.sleep(0.3)
    start = time.time()
    proc.kill()
    proc.wait(timeout=10)
    t.join(timeout=15)
    c.close()
    assert not t.is_alive(), "barrier waiter hung past the budget"
    assert got and type(got[0]) is SyncLostError, got
    assert f"{host}:{port}" in str(got[0])
    assert time.time() - start < 12


def test_partition_heal_rearms_barrier_and_resumes_subscribe(
        no_new_sync_threads, killable):  # noqa: F811
    proc, host, port = killable
    c = SyncClient(host, port, namespace="run:z:",
                   retry=_fast_retry(attempts=60, deadline_secs=30))
    helper = SyncClient(host, port, namespace="run:z:",
                        retry=_fast_retry(attempts=60, deadline_secs=30))
    try:
        c.publish("topic", "a")
        sub = c.subscribe("topic", timeout=25)
        assert next(sub) == "a"
        got = []
        t = threading.Thread(
            target=lambda: got.append(c.signal_and_wait("gate", 2, timeout=25)),
            daemon=True)
        t.start()
        time.sleep(0.3)
        os.kill(proc.pid, signal.SIGSTOP)
        time.sleep(1.5)  # the heartbeat declares the connection half-open
        os.kill(proc.pid, signal.SIGCONT)
        helper.publish("topic", "b")
        assert next(sub) == "b"  # no replayed "a", no lost "b"
        seq = helper.signal_and_wait("gate", 2, timeout=15)
        t.join(timeout=15)
        assert got and sorted([got[0], seq]) == [1, 2]
    finally:
        c.close()
        helper.close()


def test_half_open_client_swept_and_its_eviction_published(
        no_new_sync_threads, idle_server):  # noqa: F811
    host, port = idle_server.address
    topic = "run:r:__run_events__"
    watcher = SyncClient(host, port, retry=_fast_retry())
    silent = SyncClient(
        host, port, namespace="run:r:",
        retry=_fast_retry(heartbeat_secs=0.0, attempts=0, deadline_secs=0.5),
        identity={"events_topic": topic, "group": "g2", "instance": 3})
    try:
        events = watcher.subscribe(topic, timeout=15)
        got = []

        def park():
            try:
                silent.barrier("never", 9, timeout=30)
            except BaseException as e:  # noqa: BLE001
                got.append(e)

        t = threading.Thread(target=park, daemon=True)
        t.start()
        _wait_stats(watcher, "waiters", 1)
        evt = next(events)  # the idle sweep evicts the silent client
        assert evt["type"] == "evicted"
        assert evt["group"] == "g2" and evt["instance"] == 3
        _wait_stats(watcher, "waiters", 0)
        t.join(timeout=15)
        assert got and type(got[0]) is SyncLostError, got
        assert watcher.sync_stats()["conn"]["evictions"] >= 1
    finally:
        watcher.close()
        silent.close()


def test_sigkilled_client_releases_occupancy_and_publishes(
        no_new_sync_threads, idle_server):  # noqa: F811
    host, port = idle_server.address
    watcher = SyncClient(host, port, retry=_fast_retry())
    events = watcher.subscribe("run:r:__run_events__", timeout=15)
    victim_code = f"""
from testground_tpu_torch.sync import SyncClient, SyncRetry
c = SyncClient({host!r}, {port}, namespace="run:r:",
               retry=SyncRetry(heartbeat_secs=0.2),
               identity={{"events_topic": "run:r:__run_events__",
                          "group": "g", "instance": 5}})
print("READY", flush=True)
c.barrier("never", 9, timeout=60)
"""
    victim = subprocess.Popen(
        [sys.executable, "-c", victim_code], cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.DEVNULL, text=True,
        env={**os.environ, "PYTHONPATH": REPO})
    try:
        assert victim.stdout.readline().strip() == "READY"
        _wait_stats(watcher, "waiters", 1)
        victim.kill()
        victim.wait(timeout=10)
        evt = next(events)
        assert evt["type"] == "evicted"
        assert evt["group"] == "g" and evt["instance"] == 5
        _wait_stats(watcher, "waiters", 0)
    finally:
        if victim.poll() is None:
            victim.kill()
            victim.wait(10)
        watcher.close()


OUTQ_BOUND = 65536


@pytest.fixture(params=["python", "native"])
def bounded_server(request, native_bins):  # noqa: F811
    srv = _start(PORT, request.param, native_bins, max_wbuf=OUTQ_BOUND)
    yield srv.address, request.param
    srv.stop()


def test_stalled_subscriber_never_delays_barriers(no_new_sync_threads,  # noqa: F811
                                                  bounded_server):
    """A subscriber that stops reading while a topic floods is shed at the
    outbound bound (an eviction); barriers between others stay prompt."""
    (host, port), backend = bounded_server
    retry = SyncRetry(connect_timeout=2.0, attempts=2, deadline_secs=3.0,
                      heartbeat_secs=0.0)
    evict0 = fetch_sync_stats(host, port)["conn"]["evictions"]
    stalled = socket.socket()
    stalled.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 8192)
    stalled.connect((host, port))
    stalled.sendall(b'{"id": 1, "op": "subscribe", "topic": "hot"}\n')
    publisher = SyncClient(host, port, retry=retry)
    a = SyncClient(host, port, namespace="bp:", retry=retry)
    b = SyncClient(host, port, namespace="bp:", retry=retry)
    payload = {"blob": "x" * 8192}
    try:
        for round_ in range(10):
            for _ in range(60):
                publisher.publish("hot", payload)
            got = {}
            t = threading.Thread(
                target=lambda i=round_: got.update(
                    b=b.signal_and_wait(f"gate-{i}", 2, timeout=10)),
                daemon=True)
            t0 = time.monotonic()
            t.start()
            a.signal_and_wait(f"gate-{round_}", 2, timeout=10)
            t.join(timeout=10)
            wall = time.monotonic() - t0
            assert got.get("b") in (1, 2)
            assert wall < 5.0, f"{backend}: barrier round {round_} took {wall:.1f}s"
        deadline = time.monotonic() + 10
        evictions = evict0
        while time.monotonic() < deadline and evictions <= evict0:
            evictions = fetch_sync_stats(host, port)["conn"]["evictions"]
            time.sleep(0.1)
        assert evictions > evict0, f"{backend}: the stalled reader was never shed"
        assert publisher.counter("nothing") == 0
        assert a.signal_entry("still-alive") == 1
    finally:
        stalled.close()
        publisher.close()
        a.close()
        b.close()


# ------------------------------------------------------ 300 clients


def drive_fanin(driver, addr, clients, signal_ops, pub_subs, pub_entries,
                timeout=60.0):
    """Runs the port's ``tg-fanin-driver`` through its four phases
    (connect, flood, a barrier storm as wide as the clients, pubsub);
    returns their records. One "go" line per phase on stdin, one JSON
    record per phase on stdout."""
    proc = subprocess.Popen(
        [driver, "--host", addr[0], "--port", str(addr[1]), "--clients",
         str(clients), "--total", str(clients), "--signal-ops",
         str(signal_ops), "--pub-subs", str(pub_subs), "--pub-entries",
         str(pub_entries), "--timeout", str(timeout)],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
    records = []
    try:
        for _ in range(4):
            proc.stdin.write("go\n")
            proc.stdin.flush()
            records.append(json.loads(proc.stdout.readline()))
        proc.stdin.close()
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(10)
    return records


@pytest.mark.parametrize("backend", ["python", "native"])
def test_300_clients_held_and_their_ops_conserved(no_new_sync_threads,  # noqa: F811
                                                  native_bins, backend):
    n, signal_ops, subs, entries = 300, 4, 299, 3
    srv = _start(PORT, backend, native_bins)
    try:
        before = fetch_sync_stats(*srv.address)
        recs = drive_fanin(native_bins["driver"], srv.address, n, signal_ops,
                           subs, entries)
        after = fetch_sync_stats(*srv.address)
    finally:
        srv.stop()
    connect, flood, storm, pubsub = recs
    for rec in recs:
        assert rec["errors"] == [], rec
    assert connect["connected"] == n
    assert len(flood["lats_ms"]) == n * signal_ops
    assert len(storm["lats_ms"]) == n
    assert pubsub["delivered"] == subs * entries
    driven = {"signal_entry": n * signal_ops, "signal_and_wait": n,
              "subscribe": subs, "publish": entries, "sync_stats": 1}
    delta = {op: after["ops"][op] - before["ops"][op] for op in after["ops"]}
    assert delta == {op: driven.get(op, 0) for op in after["ops"]}
    assert after["conn"]["accepts"] - before["conn"]["accepts"] == n + 1
    assert after["barriers"]["released"] - before["barriers"]["released"] == n
