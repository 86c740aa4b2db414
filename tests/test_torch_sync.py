"""The port's sync service against the JAX package's, on the CPU: the
copies pinned (the native sources, the stats constants, the Python
modules and the sync renderers, less their imports and the copy note),
``parse_hostport`` and ``advertise_host`` on a table of addresses, one
seeded schedule through both packages' ``InMemSyncService`` (return
values, exceptions, final state and the attached ``SyncStats`` under an
injected clock), ``boot_sync_service``'s three modes, and the engine's
fleet histograms binning with the sync plane's own ``time_bin``.

The shared helpers of the ``test_torch_sync*`` files live here: the
native binaries are built once per test process into one directory
(``native_bins``), and ``no_new_sync_threads`` fails a test that leaves a
``tg-sync*`` thread behind.
"""

import inspect
import os
import re
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import testground_tpu.native.syncsvc as ref_native
import testground_tpu.sync as ref_sync
import testground_tpu.sync.addr as ref_addr
import testground_tpu.sync.boot as ref_boot
import testground_tpu.sync.inmem as ref_inmem
import testground_tpu.sync.stats as ref_stats
import testground_tpu_torch.native.syncsvc as port_native
import testground_tpu_torch.sync as port_sync
import testground_tpu_torch.sync.addr as port_addr
import testground_tpu_torch.sync.boot as port_boot
import testground_tpu_torch.sync.inmem as port_inmem
import testground_tpu_torch.sync.stats as port_stats

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_DIR = os.path.join(REPO, "testground_tpu")
PORT_DIR = os.path.join(REPO, "testground_tpu_torch")

# ------------------------------------------------------ shared helpers


def _sync_threads() -> set:
    return {t for t in threading.enumerate() if t.name.startswith("tg-sync")}


@pytest.fixture
def no_new_sync_threads():
    """Fails the test if a ``tg-sync*`` thread it started outlives it (a
    server loop, a client's reader or heartbeat, an exporter). A client's
    reader ends when its socket closes, so the check allows a grace."""
    before = _sync_threads()
    yield
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline:
        left = _sync_threads() - before
        if not left:
            return
        time.sleep(0.05)
    pytest.fail(f"threads left behind: {sorted(t.name for t in left)}")


@pytest.fixture(scope="module")
def native_bins(tmp_path_factory):
    """``{"ref": …, "port": …, "driver": …}``: both packages'
    ``tg-syncsvc`` and the port's ``tg-fanin-driver``, built once per
    test process (each build caches by source hash in one directory)."""
    if not (ref_native.native_available() and port_native.native_available()):
        pytest.skip("no C++ toolchain (g++) for the native sync service")
    bin_dir = str(tmp_path_factory.getbasetemp() / "tg-sync-bin")
    return {
        "ref": ref_native.build_syncsvc(bin_dir),
        "port": port_native.build_syncsvc(bin_dir),
        "driver": port_native.build_fanin_driver(bin_dir),
    }


# ------------------------------------------------------ the copies


def _lines(path: str) -> list:
    with open(path) as f:
        return f.read().splitlines()


@pytest.mark.parametrize(
    "rel,comment",
    [("native/syncsvc.cc", "//"), ("native/fanin_driver.cc", "//"),
     ("native/tsan.supp", "#")],
)
def test_native_sources_equal_the_reference_but_comment_lines(rel, comment):
    ref = _lines(os.path.join(REF_DIR, rel))
    port = _lines(os.path.join(PORT_DIR, rel))
    assert len(ref) == len(port)
    for i, (a, b) in enumerate(zip(ref, port)):
        if a != b:
            assert a.lstrip().startswith(comment), (rel, i + 1, a)
            assert b.lstrip().startswith(comment), (rel, i + 1, b)


def test_stats_constants_equal_the_reference():
    for name in ("SYNC_OPS", "TIME_BINS", "MAX_TARGET_BUCKET", "PARITY_FIELDS"):
        assert getattr(port_stats, name) == getattr(ref_stats, name), name
    assert port_inmem.MAX_TOKENS == ref_inmem.MAX_TOKENS
    from testground_tpu.sync.server import DEFAULT_OUTQ_LIMIT as ref_outq
    from testground_tpu_torch.sync.server import DEFAULT_OUTQ_LIMIT

    assert DEFAULT_OUTQ_LIMIT == ref_outq
    assert port_sync.RUN_EVENTS_TOPIC == ref_sync.RUN_EVENTS_TOPIC
    assert port_sync.__all__ == ref_sync.__all__


_NOTE = re.compile(
    r"\n\nThe port's copy of the reference's\s+``testground_tpu/[a-z_/]+\.py``"
    r"\s+\(ROADMAP's\s+copy\s+policy\);\s+only\s+its\s+imports\s+name\s+the"
    r"\s+port's\s+own\s+modules\.\n"
)


def _as_reference(src: str) -> str:
    """The port's copy with its copy note dropped, its relative imports of
    port modules and its module paths put back to the reference's."""
    src = _NOTE.sub("\n", src)
    for mod in ("logging_", "native", "metrics", "sync"):
        src = src.replace(f"from ..{mod}", f"from testground_tpu.{mod}")
    return src.replace("testground_tpu_torch", "testground_tpu")


@pytest.mark.parametrize(
    "rel",
    ["sync/addr.py", "sync/inmem.py", "sync/stats.py", "sync/server.py",
     "sync/client.py", "sync/boot.py", "native/syncsvc.py"],
)
def test_python_copies_equal_the_reference_but_imports(rel):
    with open(os.path.join(REF_DIR, rel)) as f:
        ref = f.read()
    with open(os.path.join(PORT_DIR, rel)) as f:
        port = f.read()
    assert _as_reference(port).splitlines() == ref.splitlines()


def test_sync_renderers_and_cli_verbs_equal_the_reference():
    import testground_tpu.cli.commands as ref_cmd
    import testground_tpu.metrics.prometheus as ref_prom
    import testground_tpu.runners.pretty as ref_pretty
    import testground_tpu_torch.cli.commands as port_cmd
    import testground_tpu_torch.metrics.prometheus as port_prom
    import testground_tpu_torch.runners.pretty as port_pretty

    pairs = [(ref_prom, port_prom, "render_sync_prometheus"),
             (ref_pretty, port_pretty, "_fmt_us"),
             (ref_pretty, port_pretty, "render_sync_stats")]
    pairs += [(ref_cmd, port_cmd, n) for n in (
        "register_sync_service", "sync_service_cmd",
        "register_sync_stats", "sync_stats_cmd")]
    for ref_mod, port_mod, name in pairs:
        ref = inspect.getsource(getattr(ref_mod, name))
        port = inspect.getsource(getattr(port_mod, name))
        for pkg in ("sync", "runners", "metrics"):
            port = port.replace(f"from ..{pkg}", f"from testground_tpu.{pkg}")
        assert port == ref, name


def test_engine_bins_with_the_sync_planes_time_bin():
    from testground_tpu_torch.engine import engine

    assert engine.TIME_BINS is port_stats.TIME_BINS
    assert engine.time_bin is port_stats.time_bin


# ------------------------------------------------------ addresses


def _outcome(fn, *a, **k):
    try:
        return ("ok", fn(*a, **k))
    except Exception as e:  # noqa: BLE001 — compared, type and message
        return ("err", type(e).__name__, str(e))


ADDRESSES = [
    ("127.0.0.1:9042", 0), ("localhost", 7), ("localhost", 0),
    ("  sync.local:1  ", 0), ("h:", 5), (":80", 0), ("", 0), ("   ", 3),
    ("h:x", 0), ("h:70000", 0), ("h:-1", 0), ("h:65535", 0), ("h:0", 9),
    ("[::1]:5", 0), ("::1", 0), ("a:b:c", 0), ("h: 12", 0), ("h:1e3", 0),
    ("host", 65536),
]


@pytest.mark.parametrize("address,default_port", ADDRESSES)
def test_parse_hostport_equals_the_reference(address, default_port):
    assert _outcome(port_addr.parse_hostport, address, default_port) == \
        _outcome(ref_addr.parse_hostport, address, default_port)


class _Route:
    """A stand-in for the UDP socket ``advertise_host`` asks for the
    outbound interface: it answers without touching the network."""

    ip = None

    def __init__(self, *a):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False

    def connect(self, addr):
        if self.ip is None:
            raise OSError("Network is unreachable")

    def getsockname(self):
        return (self.ip, 40000)


@pytest.mark.parametrize("route", [None, "192.0.2.7"])
@pytest.mark.parametrize(
    "bind,explicit",
    [("127.0.0.1", ""), ("10.1.2.3", ""), ("0.0.0.0", "sync.example"),
     ("", "h"), ("0.0.0.0", ""), ("", ""), ("::", ""), ("myhost", "other")],
)
def test_advertise_host_equals_the_reference(monkeypatch, bind, explicit, route):
    monkeypatch.setattr(_Route, "ip", route)
    assert port_addr.socket is ref_addr.socket
    monkeypatch.setattr(port_addr.socket, "socket", _Route)
    assert _outcome(port_addr.advertise_host, bind, explicit) == \
        _outcome(ref_addr.advertise_host, bind, explicit)


# ------------------------------------------------------ in-memory service


def _schedule(seed: int, n: int = 600):
    """A seeded op schedule over a few states and topics: tokened and
    plain signals and publishes (tokens from a small pool, so replays
    happen), counters, barriers met and unmet (timeout 0), signal_and_wait,
    reads of the topics and gauges, subscriptions read to their end, and
    a rare reset."""
    rng = np.random.default_rng(seed)
    states, topics = ["a", "b", "c"], ["t0", "t1"]
    kinds = ["signal", "publish", "counter", "barrier", "saw", "since",
             "snapshot", "gauges", "len", "get", "subscribe", "pubsub",
             "reset"]
    p = np.array([18, 16, 6, 10, 6, 6, 4, 4, 4, 4, 6, 5, 1], dtype=float)
    ops = []
    for _ in range(n):
        kind = kinds[int(rng.choice(len(kinds), p=p / p.sum()))]
        st = states[int(rng.integers(len(states)))]
        tp = topics[int(rng.integers(len(topics)))]
        tok = None if rng.random() < 0.4 else f"k{int(rng.integers(24))}"
        ops.append((kind, st, tp, tok, int(rng.integers(0, 12)),
                    int(rng.integers(0, 1000))))
    return ops


def _run_inmem(mod, stats_mod, ops):
    tick = [0.0]

    def clock():
        tick[0] += 0.001
        return tick[0]

    svc = mod.InMemSyncService()
    svc.stats = stats_mod.SyncStats(clock=clock)
    out = []
    for kind, st, tp, tok, k, payload in ops:
        if kind == "signal":
            r = _outcome(svc.signal_entry, st, token=tok)
        elif kind == "publish":
            r = _outcome(svc.publish, tp, {"v": payload, "st": st}, token=tok)
        elif kind == "counter":
            r = _outcome(svc.counter, st)
        elif kind == "barrier":
            r = _outcome(svc.barrier, st, k, timeout=0)
        elif kind == "saw":
            r = _outcome(svc.signal_and_wait, st, k, timeout=0, token=tok)
        elif kind == "since":
            r = _outcome(svc.entries_since, tp, k)
        elif kind == "snapshot":
            r = _outcome(svc.counters_snapshot, [st, "zz", "a"])
        elif kind == "gauges":
            r = _outcome(svc.pubsub_gauges)
        elif kind == "len":
            r = _outcome(svc.topic_len, tp)
        elif kind == "get":
            r = _outcome(svc.get_entries, tp, k)
        elif kind in ("subscribe", "pubsub"):
            if kind == "subscribe":
                it = svc.subscribe(tp, timeout=0)
            else:
                seq, it = svc.publish_subscribe(tp, payload, timeout=0)
                out.append(("seq", seq))
            got = []
            r = _outcome(lambda: [got.append(e) for e in it])
            r = (r[0], got) + r[2:]
        else:
            r = _outcome(svc.reset)
        out.append(r)
    state = (svc._counters, svc._topics, svc._sig_tokens,
             list(svc._sig_token_order), svc._pub_tokens,
             list(svc._pub_token_order))
    return out, state, svc.stats.snapshot(*svc.pubsub_gauges())


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_inmem_schedule_equals_the_reference(seed):
    ops = _schedule(seed)
    ref = _run_inmem(ref_inmem, ref_stats, ops)
    port = _run_inmem(port_inmem, port_stats, ops)
    assert port[0] == ref[0]
    assert port[1] == ref[1]
    assert port[2] == ref[2]
    # the schedule reached every outcome it is meant to cover
    kinds = {r[0] for r in ref[0]}
    assert {"ok", "err", "seq"} <= kinds
    assert ref[2]["dedup"]["signal_hits"] and ref[2]["dedup"]["publish_hits"]
    assert ref[2]["barriers"]["timed_out"] and ref[2]["barriers"]["released"]


def test_inmem_tokens_past_max_tokens_equal_the_reference():
    """Past ``MAX_TOKENS`` remembered tokens the oldest are forgotten: a
    replay of an evicted token applies again, a recent one deduplicates."""
    n = ref_inmem.MAX_TOKENS + 40
    results = []
    for mod in (ref_inmem, port_inmem):
        svc = mod.InMemSyncService()
        seqs = [svc.signal_entry("big", token=f"k{i}") for i in range(n)]
        pubs = [svc.publish("T", i, token=f"p{i}") for i in range(n)]
        replays = [svc.signal_entry("big", token="k0"),
                   svc.signal_entry("big", token=f"k{n - 1}"),
                   svc.publish("T", -1, token="p3"),
                   svc.publish("T", -2, token=f"p{n - 5}")]
        results.append((seqs[-1], pubs[-1], replays, svc.counter("big"),
                        svc.topic_len("T"), len(svc._sig_tokens),
                        len(svc._pub_tokens), list(svc._sig_token_order)[:3],
                        svc.entries_since("T", n - 2)))
        svc.reset()
        results[-1] += (svc.counter("big"), svc.pubsub_gauges())
    assert results[1] == results[0]
    assert results[0][2] == [n + 1, n, n + 1, n - 4]


def test_inmem_barrier_waits_across_threads_like_the_reference():
    """A parked barrier releases when the count reaches its target, and a
    timed-out one raises the same error, in both packages."""
    for mod in (ref_inmem, port_inmem):
        svc = mod.InMemSyncService()
        done = threading.Event()
        t = threading.Thread(
            target=lambda: (svc.barrier("go", 2, timeout=5), done.set()),
            daemon=True)
        t.start()
        svc.signal_entry("go")
        assert not done.wait(0.1)
        svc.signal_entry("go")
        assert done.wait(5)
        t.join(5)
    assert _outcome(port_inmem.InMemSyncService().barrier, "n", 1, 0.05) == \
        _outcome(ref_inmem.InMemSyncService().barrier, "n", 1, 0.05)


# ------------------------------------------------------ boot


def _boot(mod, mode, bin_dir, logs):
    return mod.boot_sync_service(mode, "127.0.0.1", 0, 0.0, 2.0, bin_dir,
                                 log=logs.append)


def test_boot_unknown_mode_raises_as_the_reference(tmp_path):
    outs = [_outcome(_boot, mod, "fast", str(tmp_path), [])
            for mod in (ref_boot, port_boot)]
    assert outs[0] == outs[1]
    assert outs[1][:2] == ("err", "ValueError")


def test_boot_without_gpp(tmp_path, monkeypatch, no_new_sync_threads):
    """No ``g++`` on ``PATH``: a forced native boot raises the reference's
    error; auto falls back to the Python server without a log line, as the
    reference's does."""
    monkeypatch.setenv("PATH", str(tmp_path))
    outs = [_outcome(_boot, mod, "native", str(tmp_path), [])
            for mod in (ref_boot, port_boot)]
    assert outs[0] == outs[1]
    assert outs[1][:2] == ("err", "RuntimeError")
    logs = {"ref": [], "port": []}
    for key, mod in (("ref", ref_boot), ("port", port_boot)):
        svc = _boot(mod, "auto", str(tmp_path), logs[key])
        try:
            assert type(svc).__module__ == f"{mod.__name__.rsplit('.', 1)[0]}.server"
            assert svc.address[1] > 0
        finally:
            svc.stop()
    assert logs["ref"] == logs["port"] == []


def test_boot_auto_falls_back_with_the_references_line(
        tmp_path, monkeypatch, no_new_sync_threads):
    """A ``g++`` that fails: auto logs the reference's fallback line and
    serves the Python server; a forced native boot raises the build's
    error."""
    fake = tmp_path / "g++"
    fake.write_text("#!/bin/sh\nexit 1\n")
    fake.chmod(0o755)
    monkeypatch.setenv("PATH", f"{tmp_path}:{os.environ['PATH']}")
    monkeypatch.delenv("TG_NATIVE_SANITIZE", raising=False)
    line = re.compile(r"^native sync service unavailable \(Command .*'g\+\+'.* "
                      r"returned non-zero exit status 1\.\); falling back to "
                      r"python$")
    for mod in (ref_boot, port_boot):
        logs = []
        svc = _boot(mod, "auto", str(tmp_path / "bin"), logs)
        svc.stop()
        assert len(logs) == 1 and line.match(logs[0]), logs
        err = _outcome(_boot, mod, "native", str(tmp_path / "bin"), [])
        assert err[:2] == ("err", "CalledProcessError")


def test_boot_native_serves_and_logs_its_binary(native_bins, tmp_path):
    import shutil

    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    shutil.copy(native_bins["port"], bin_dir)
    logs = []
    svc = _boot(port_boot, "native", str(bin_dir), logs)
    try:
        assert isinstance(svc, port_native.NativeSyncService)
        cached = bin_dir / os.path.basename(native_bins["port"])
        assert logs == [f"sync service: native ({cached})"]
        assert port_stats.fetch_sync_stats(*svc.address)["v"] == 2
    finally:
        svc.stop()
    assert svc._proc.poll() is not None


# ------------------------------------------------------ sanitize modes


@pytest.mark.parametrize(
    "raw", ["", "off", "thread", "address,undefined", "undefined , address",
            "thread,address", "memory", "THREAD"])
def test_sanitize_mode_and_env_equal_the_reference(monkeypatch, raw):
    monkeypatch.setenv("TG_NATIVE_SANITIZE", raw)
    monkeypatch.setenv("TSAN_OPTIONS", "verbosity=1")
    ref = _outcome(ref_native.sanitize_mode)
    assert _outcome(port_native.sanitize_mode) == ref
    if ref[0] == "ok":
        base = {"ASAN_OPTIONS": "x=1"}
        ref_env = ref_native.sanitizer_env(base)
        port_env = port_native.sanitizer_env(base)
        if ref_env is None:
            assert port_env is None
        else:
            # each names its own package's suppressions file
            assert port_env.pop("TSAN_OPTIONS", "").replace(
                port_native._TSAN_SUPP, "S") == ref_env.pop(
                "TSAN_OPTIONS", "").replace(ref_native._TSAN_SUPP, "S")
            assert port_env == ref_env


def test_server_main_prints_the_references_listening_line():
    """``python -c "from testground_tpu_torch.sync.server import _main;
    _main([...])"`` announces ``LISTENING host port`` and stops on
    SIGTERM, as the reference's does."""
    code = ("from testground_tpu_torch.sync.server import _main; "
            "_main(['--port', '0', '--idle-timeout', '0'])")
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        parts = proc.stdout.readline().split()
        assert parts[0] == "LISTENING" and parts[1] == "127.0.0.1"
        assert port_stats.fetch_sync_stats("127.0.0.1", int(parts[2]))["v"] == 2
        proc.terminate()
        _, err = proc.communicate(timeout=10)
        assert proc.returncode == 0
        assert "sync service stopped" in err
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(10)
