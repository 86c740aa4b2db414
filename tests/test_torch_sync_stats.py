"""The port's sync stats plane against the JAX package's, on the CPU: the
bin math over a seeded sweep, ``SyncStats.snapshot()`` after one seeded
event sequence under an injected clock, ``render_sync_prometheus``,
``render_sync_stats`` and ``heartbeat_line`` byte-equal on v1 and v2
snapshots taken from both of the port's backends, the
``SyncMetricsExporter`` (a scrape, a 404, the 503 of an unreachable
service), and the CLI: ``tg-torch sync-service`` as a process on each
backend, ``tg-torch sync-stats`` against it beside the reference's ``tg
sync-stats``, ``--watch``, and the refusals.
"""

import json
import os
import re
import shutil
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import testground_tpu.cli.main as ref_cli
import testground_tpu.metrics.prometheus as ref_prom
import testground_tpu.runners.pretty as ref_pretty
import testground_tpu.sync.stats as ref_stats
import testground_tpu_torch.cli.main as port_cli
import testground_tpu_torch.metrics.prometheus as port_prom
import testground_tpu_torch.runners.pretty as port_pretty
import testground_tpu_torch.sync.stats as port_stats
from test_torch_sync import native_bins, no_new_sync_threads  # noqa: F401
from testground_tpu_torch.native import NativeSyncService
from testground_tpu_torch.sync import SyncServiceServer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# ------------------------------------------------------ bin math


def test_bin_math_equals_the_reference_over_a_seeded_sweep():
    rng = np.random.default_rng(3)
    us = np.concatenate([rng.uniform(0, 4, 200), rng.lognormal(5, 4, 400),
                         [0, 0.5, 1, 2, 3, 2 ** 19 - 1, 2 ** 19, 2 ** 40, -5]])
    for v in us.tolist() + [int(x) for x in us[:100]]:
        assert port_stats.time_bin(v) == ref_stats.time_bin(v), v
    for i in range(port_stats.TIME_BINS):
        assert port_stats.bin_edge_us(i) == ref_stats.bin_edge_us(i)
    for _ in range(300):
        bins = [int(x) for x in rng.integers(0, 5, port_stats.TIME_BINS)
                * (rng.random(port_stats.TIME_BINS) < 0.4)]
        q = float(rng.choice([0.0, 0.5, 0.9, 0.99, 1.0, rng.random()]))
        assert port_stats.hist_quantile_us(bins, q) == \
            ref_stats.hist_quantile_us(bins, q), (bins, q)
    targets = [int(x) for x in rng.integers(-3, 1 << 22, 300)]
    targets += [0, 1, 2, 3, 1 << 20, (1 << 20) + 1, 50_000_000]
    for t in targets:
        assert port_stats.target_bucket(t) == ref_stats.target_bucket(t), t


def _events(seed, n=500):
    """A seeded sequence of stats events with the arguments each hook
    takes (op names include one the recorder ignores)."""
    rng = np.random.default_rng(seed)
    ops = list(ref_stats.SYNC_OPS) + ["nonsense"]
    states = ["s0", "s1", "s2"]
    out = []
    for _ in range(n):
        k = int(rng.integers(16))
        op = ops[int(rng.integers(len(ops)))]
        st, tg = states[int(rng.integers(3))], int(rng.integers(1, 40))
        us = float(rng.lognormal(4, 3))
        out.append((k, op, st, tg, us, int(rng.integers(0, 9)),
                    float(rng.uniform(0, 0.3))))
    return out


def _replay(mod, events):
    now = [1000.0]
    st = mod.SyncStats(clock=lambda: now[0])
    for k, op, state, target, us, n, dt in events:
        now[0] += dt
        if k == 0:
            st.count_op(op)
        elif k == 1:
            st.op_done(op, us)
        elif k == 2:
            st.time_op(op, us)
        elif k == 3:
            st.op_done_batch([(op, us), ("ping", us / 2)])
        elif k == 4:
            st.time_op_batch([(op, us)] * n)
        elif k == 5:
            st.task_ops_batch({f"task-{n}": n + 1, "": 1})
        elif k == 6:
            st.conn_open()
        elif k == 7:
            st.conn_close()
        elif k == 8:
            st.conn_evicted()
        elif k == 9:
            st.note_occupancy(n, target % 5)
        elif k == 10:
            st.barrier_parked(state, target)
        elif k == 11:
            st.barrier_released(state, target)
        elif k == 12:
            st.barrier_released_batch(state, target, n)
        elif k == 13:
            st.barrier_timed_out(state, target)
        elif k == 14:
            st.barrier_canceled(state, target)
        else:
            st.pubsub_published(n)
            st.dedup_hit("signal" if n % 2 else "publish")
    return st.snapshot(topics=3, entries=17)


@pytest.mark.parametrize("seed", [0, 5])
def test_syncstats_snapshot_equals_the_reference(seed):
    events = _events(seed)
    ref, port = _replay(ref_stats, events), _replay(port_stats, events)
    assert port == ref
    assert ref["barriers"]["episodes"]["by_target"]
    assert sum(r["count"] for r in ref["op_time_us"].values()) > 0


# ------------------------------------------------------ snapshots


def _mk(addr):
    s = socket.create_connection(addr, timeout=10)
    return s, s.makefile("r", encoding="utf-8")


def _call(s, rf, req):
    s.sendall((json.dumps(req) + "\n").encode())
    return json.loads(rf.readline())


def _drive(addr):
    """The reference stats tests' scripted traffic (signals with a token
    replay, a counter, publishes with a replay, a ping, a two-party
    signal_and_wait, a met barrier, a subscribe, a barrier timeout);
    returns the sync_stats snapshot after it."""
    a, arf = _mk(addr)
    _call(a, arf, {"id": 1, "op": "signal_entry", "state": "x", "token": "t1"})
    _call(a, arf, {"id": 2, "op": "signal_entry", "state": "x", "token": "t1"})
    _call(a, arf, {"id": 3, "op": "counter", "state": "x"})
    for rid in (4, 5):
        _call(a, arf, {"id": rid, "op": "publish", "topic": "T",
                       "payload": {"k": 1}, "token": "p1"})
    _call(a, arf, {"id": 6, "op": "ping"})
    b, brf = _mk(addr)
    got = {}
    t = threading.Thread(target=lambda: got.update(b=_call(b, brf, {
        "id": 7, "op": "signal_and_wait", "state": "bar", "target": 2,
        "timeout": 15})), daemon=True)
    t.start()
    time.sleep(0.1)
    _call(a, arf, {"id": 8, "op": "signal_and_wait", "state": "bar",
                   "target": 2, "timeout": 15})
    t.join(15)
    assert got["b"]["ok"] is True
    _call(a, arf, {"id": 9, "op": "barrier", "state": "bar", "target": 2,
                   "timeout": 15})
    _call(a, arf, {"id": 10, "op": "subscribe", "topic": "T"})
    _call(a, arf, {"id": 11, "op": "barrier", "state": "never", "target": 9,
                   "timeout": 0.1})
    stats = _call(a, arf, {"id": 12, "op": "sync_stats"})
    stats.pop("id")
    for f in (arf, a, brf, b):
        f.close()
    return stats


@pytest.fixture(scope="module")
def snapshots(native_bins):  # noqa: F811
    """v2 snapshots (two fetches around a ping, for the heartbeat) from the
    port's Python and native servers, and their v1 answers (stats off)."""
    out = {}
    for backend in ("python", "native"):
        srv = (SyncServiceServer().start() if backend == "python"
               else NativeSyncService(native_bins["port"]))
        try:
            first = _drive(srv.address)
            s, rf = _mk(srv.address)
            _call(s, rf, {"id": 1, "op": "ping"})
            rf.close()
            s.close()
            second = port_stats.fetch_sync_stats(*srv.address)
        finally:
            srv.stop()
        out[backend] = (first, second)
    srv = SyncServiceServer(stats=False).start()
    try:
        out["python-v1"] = (port_stats.fetch_sync_stats(*srv.address),) * 2
    finally:
        srv.stop()
    proc = subprocess.Popen([native_bins["port"], "--port", "0", "--stats", "0"],
                            stdout=subprocess.PIPE, text=True)
    try:
        port = int(proc.stdout.readline().split()[1])
        out["native-v1"] = (port_stats.fetch_sync_stats("127.0.0.1", port),) * 2
    finally:
        proc.terminate()
        proc.wait(10)
    return out


SOURCES = ["python", "native", "python-v1", "native-v1"]


@pytest.mark.parametrize("source", SOURCES)
def test_renderers_byte_equal_the_reference(snapshots, source):
    first, second = snapshots[source]
    for snap in (first, second):
        assert port_prom.render_sync_prometheus(snap) == \
            ref_prom.render_sync_prometheus(snap)
        assert port_pretty.render_sync_stats(snap) == \
            ref_pretty.render_sync_stats(snap)
    for prev in (None, first):
        for dt in (0.0, 0.5, 10.0):
            assert port_stats.heartbeat_line(prev, second, dt) == \
                ref_stats.heartbeat_line(prev, second, dt)
    if source.endswith("v1"):
        assert "v" not in first
        assert "v1 server" in port_pretty.render_sync_stats(first)
    else:
        assert first["v"] == 2
        text = port_prom.render_sync_prometheus(first)
        assert f'tg_sync_ops_total{{op="signal_entry"}} 2' in text


def test_backends_snapshots_agree_on_the_parity_fields(snapshots):
    py, nat = snapshots["python"][0], snapshots["native"][0]
    for block, fields in port_stats.PARITY_FIELDS.items():
        for f in fields:
            assert py[block][f] == nat[block][f], (block, f)
    assert set(snapshots["python-v1"][0]) == set(snapshots["native-v1"][0]) \
        == {"conns", "waiters", "subs", "boot"}


# ------------------------------------------------------ exporter


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_metrics_exporter_scrapes_and_refuses(no_new_sync_threads):  # noqa: F811
    srv = SyncServiceServer().start()
    exporter = port_stats.SyncMetricsExporter(srv.address).start()
    try:
        _drive(srv.address)
        url = f"http://127.0.0.1:{exporter.port}"
        resp = urllib.request.urlopen(url + "/metrics", timeout=10)
        assert resp.headers["Content-Type"] == port_prom.CONTENT_TYPE
        text = resp.read().decode()
        assert re.search(r"^tg_sync_conns \d+$", text, re.M)
        assert 'tg_sync_ops_total{op="signal_entry"} 2' in text
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(url + "/nope", timeout=10)
        assert ei.value.code == 404
    finally:
        exporter.stop()
        srv.stop()


def test_metrics_exporter_503_when_the_service_is_unreachable(
        no_new_sync_threads):  # noqa: F811
    dead = ("127.0.0.1", _free_port())
    codes = []
    for mod in (ref_stats, port_stats):
        exporter = mod.SyncMetricsExporter(dead).start()
        try:
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(
                    f"http://127.0.0.1:{exporter.port}/metrics", timeout=10)
            codes.append((ei.value.code, ei.value.read()))
        finally:
            exporter.stop()
    assert codes[1] == codes[0]
    assert codes[0][0] == 503


# ------------------------------------------------------ the CLI


def _home(tmp_path, bins=None):
    """A ``TESTGROUND_HOME`` whose bin dir holds the already built native
    server, so that a native boot finds it instead of building it again."""
    home = tmp_path / "home"
    bin_dir = home / "data" / "work" / "bin"
    bin_dir.mkdir(parents=True)
    if bins:
        shutil.copy(bins["port"], bin_dir)
    return home


class _Service:
    """``tg-torch sync-service`` as a process: reads ``LISTENING`` and
    ``METRICS`` off its stdout; stderr goes to a file (the heartbeat)."""

    def __init__(self, home, backend, stats_interval="0.2"):
        self.err_path = home / "service.err"
        self._err = open(self.err_path, "w")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "testground_tpu_torch.cli", "sync-service",
             "--port", "0", "--backend", backend, "--metrics-port", "0",
             "--stats-interval", stats_interval],
            cwd=REPO, stdout=subprocess.PIPE, stderr=self._err, text=True,
            env={**os.environ, "TESTGROUND_HOME": str(home),
                 "PYTHONPATH": REPO})
        try:
            # the exporter starts before the serve loop announces the
            # service, so METRICS comes first, as in the reference
            self.lines = [self.proc.stdout.readline().strip() for _ in range(2)]
            assert re.fullmatch(r"METRICS http://127\.0\.0\.1:\d+/metrics",
                                self.lines[0]), self.lines
            self.metrics_url = self.lines[0].split()[1]
            listening = self.lines[1].split()
            assert listening[:2] == ["LISTENING", "127.0.0.1"], self.lines
            self.address = f"127.0.0.1:{listening[2]}"
        except BaseException:
            self.stop()
            raise

    def stop(self):
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(10)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait(10)
        self._err.close()
        return self.err_path.read_text()


def _cli(mod, argv, capsys):
    rc = mod.main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


# keys of a sync_stats reply that move between two fetches: the uptime,
# and what each fetch adds itself (its sync_stats op, its service time,
# its connection's accept and close)
MOVING = ("uptime_secs", "ops.sync_stats", "op_time_us.sync_stats",
          "conn.accepts", "conn.closes")


def _steady(doc):
    doc = json.loads(json.dumps(doc))
    for key in MOVING:
        *path, last = key.split(".")
        d = doc
        for p in path:
            d = d.get(p, {})
        d.pop(last, None)
    return doc


@pytest.mark.parametrize("backend", ["python", "native"])
def test_sync_service_process_and_sync_stats_equal_the_reference(
        tmp_path, capsys, native_bins, backend):  # noqa: F811
    svc = _Service(_home(tmp_path, native_bins), backend)
    try:
        host, port = svc.address.rsplit(":", 1)
        _drive((host, int(port)))
        rc_ref, ref_json, _ = _cli(ref_cli, ["sync-stats", svc.address, "--json"],
                                   capsys)
        rc_port, port_json, _ = _cli(port_cli, ["sync-stats", svc.address,
                                                "--json"], capsys)
        assert rc_ref == rc_port == 0
        ref_doc, port_doc = json.loads(ref_json), json.loads(port_json)
        assert port_doc["v"] == 2 and port_doc["ops"]["signal_entry"] == 2
        assert _steady(port_doc) == _steady(ref_doc)
        # the table: equal but for the numbers that moved
        _, ref_table, _ = _cli(ref_cli, ["sync-stats", svc.address], capsys)
        _, port_table, _ = _cli(port_cli, ["sync-stats", svc.address], capsys)
        assert "stats v2" in port_table and "signal_entry" in port_table
        mask = re.compile(r"\d+(\.\d+)?")
        assert mask.sub("N", port_table) == mask.sub("N", ref_table)
        body = urllib.request.urlopen(svc.metrics_url, timeout=10).read().decode()
        assert 'tg_sync_ops_total{op="signal_entry"} 2' in body
        time.sleep(0.5)  # a heartbeat or two
    finally:
        err = svc.stop()
    beats = [ln for ln in err.splitlines() if ln.startswith("sync-stats: conns=")]
    assert beats, err
    assert "sync service stopped" in err
    if backend == "native":
        assert "sync service: native (" in err


class _Canned:
    """A one-reply service: answers every ``sync_stats`` with the same
    snapshot, so two CLIs' fetches read the same bytes."""

    def __init__(self, snap):
        self._sock = socket.socket()
        self._sock.bind(("127.0.0.1", 0))
        self._sock.listen(8)
        self.address = "127.0.0.1:%d" % self._sock.getsockname()[1]
        reply = (json.dumps({"id": 1, **snap}) + "\n").encode()

        def serve():
            while True:
                try:
                    conn, _ = self._sock.accept()
                except OSError:
                    return
                with conn:
                    conn.recv(4096)
                    conn.sendall(reply)

        self._thread = threading.Thread(target=serve, daemon=True)
        self._thread.start()

    def close(self):
        self._sock.shutdown(socket.SHUT_RDWR)  # wakes the blocked accept
        self._sock.close()
        self._thread.join(5)
        assert not self._thread.is_alive()


@pytest.mark.parametrize("source", SOURCES)
def test_sync_stats_prints_what_the_reference_prints(snapshots, capsys, source):
    canned = _Canned(snapshots[source][0])
    try:
        for argv in (["sync-stats", canned.address],
                     ["sync-stats", canned.address, "--json"],
                     ["sync-stats", canned.address, "--json", "--watch",
                      "0.05", "--watch-count", "2"]):
            ref = _cli(ref_cli, argv, capsys)
            port = _cli(port_cli, argv, capsys)
            assert port == ref, argv
            assert ref[0] == 0
        # --watch's table frames carry a wall-clock header
        rc, out, _ = _cli(port_cli, ["sync-stats", canned.address, "--watch",
                                     "0.05", "--watch-count", "2"], capsys)
        assert rc == 0 and out.count("(refresh 0.05s, Ctrl-C to exit) ---") == 2
    finally:
        canned.close()


def test_watch_prints_two_payloads_from_a_live_service(capsys,
                                                       no_new_sync_threads):  # noqa: F811
    srv = SyncServiceServer().start()
    try:
        addr = "%s:%d" % srv.address
        rc, out, _ = _cli(port_cli, ["sync-stats", addr, "--watch", "0.1",
                                     "--watch-count", "2"], capsys)
        assert rc == 0 and out.count("stats v2") == 2
        rc, out, _ = _cli(port_cli, ["sync-stats", addr, "--json", "--watch",
                                     "0.1", "--watch-count", "2"], capsys)
        lines = [ln for ln in out.splitlines() if ln.strip()]
        assert rc == 0 and len(lines) == 2
        assert [json.loads(ln)["v"] for ln in lines] == [2, 2]
    finally:
        srv.stop()


@pytest.mark.parametrize(
    "argv,rc",
    [(["sync-stats", "nonsense"], 2), (["sync-stats", "h:x"], 2),
     (["sync-stats", ":80"], 2), (["sync-stats", "DEAD", "--timeout", "2"], 1),
     (["sync-stats", "DEAD", "--timeout", "1", "--watch", "0.1"], 1)])
def test_sync_stats_refusals_equal_the_reference(capsys, argv, rc):
    argv = [a.replace("DEAD", f"127.0.0.1:{_free_port()}") for a in argv]
    ref = _cli(ref_cli, argv, capsys)
    port = _cli(port_cli, argv, capsys)
    assert port == ref
    assert ref[0] == rc
    assert ("unreachable" if rc == 1 else "expected <host>:<port>") in ref[2]


def test_help_lists_the_sync_verbs():
    out = subprocess.run([sys.executable, "-m", "testground_tpu_torch.cli",
                          "--help"], cwd=REPO, capture_output=True, text=True,
                         env={**os.environ, "PYTHONPATH": REPO}, timeout=60)
    assert out.returncode == 0
    for verb in ("sync-service", "sync-stats"):
        assert verb in out.stdout
    for verb, flags in (("sync-service", ("--host", "--port", "--backend",
                                          "--idle-timeout", "--evict-grace",
                                          "--shards", "--metrics-port",
                                          "--stats-interval")),
                        ("sync-stats", ("--json", "--timeout", "--watch",
                                        "--watch-count"))):
        sub = port_cli.build_parser()._subparsers._group_actions[0].choices[verb]
        ref = ref_cli.build_parser()._subparsers._group_actions[0].choices[verb]
        opts = {a.dest: (a.option_strings, a.default, getattr(a, "choices", None))
                for a in sub._actions}
        assert opts == {a.dest: (a.option_strings, a.default,
                                 getattr(a, "choices", None))
                        for a in ref._actions}
        for flag in flags:
            assert any(flag in o[0] for o in opts.values()), flag
