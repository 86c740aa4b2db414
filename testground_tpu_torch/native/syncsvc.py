"""Build + lifecycle wrapper for the native sync service (syncsvc.cc).

The local:exec runner's per-run sync infrastructure can be served by the
C++ event-loop server instead of the in-process Python one — the native
analog of the reference deploying its Go sync-service container
(``pkg/runner/local_common.go:77-104``). The binary is compiled once from
the packaged source with the system ``g++`` and cached by source hash in
``$TESTGROUND_HOME/work/bin``; hosts without a toolchain silently fall
back to the Python server (runner config ``sync_service = "auto"``).

Sanitizer builds (docs/CHECKING.md "Sanitizer builds"): setting
``TG_NATIVE_SANITIZE=thread`` (or ``address``, ``undefined``, or a
comma list like ``address,undefined``) compiles every native binary
with the matching ``-fsanitize=`` instrumentation at ``-O1 -g``. The
binary name embeds the sanitize mode beside the source hash, so
instrumented and production binaries never collide in the cache, and
the spawned server inherits ``TSAN_OPTIONS``/``ASAN_OPTIONS`` pointing
at the checked-in suppressions file (``native/tsan.supp``) with
``halt_on_error=1`` — a race aborts the server loudly mid-test instead
of scrolling past. CI runs the sync suites against the TSAN build
(the ``tsan-sync`` job).

The port's copy of the reference's ``testground_tpu/native/syncsvc.py``
(ROADMAP's copy policy); only its imports name the port's own modules.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import signal
import subprocess
import uuid

from ..logging_ import S

__all__ = [
    "NativeSyncService",
    "SANITIZERS",
    "build_syncsvc",
    "build_fanin_driver",
    "native_available",
    "sanitize_mode",
]

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "syncsvc.cc")
_DRIVER_SRC = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "fanin_driver.cc"
)
# Checked-in ThreadSanitizer suppressions (docs/CHECKING.md documents
# the policy: the file ships EMPTY of active entries; any suppression
# added must name the report and justify why it is benign).
_TSAN_SUPP = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "tsan.supp"
)

# Supported TG_NATIVE_SANITIZE components → compile flags. "undefined"
# composes with "address" the way upstream recommends
# (-fsanitize=address,undefined); "thread" is mutually exclusive with
# "address" at the compiler level and refused readably below.
SANITIZERS = ("thread", "address", "undefined")


def sanitize_mode() -> tuple[str, ...]:
    """The parsed ``TG_NATIVE_SANITIZE`` build mode: a sorted tuple of
    sanitizer names, empty when unset. Unknown names and the
    thread+address combination (refused by g++ itself) raise a readable
    ValueError instead of a cryptic compile failure."""
    raw = os.environ.get("TG_NATIVE_SANITIZE", "").strip().lower()
    if not raw or raw in ("0", "off", "none", "false"):
        return ()
    parts = tuple(sorted({p.strip() for p in raw.split(",") if p.strip()}))
    unknown = [p for p in parts if p not in SANITIZERS]
    if unknown:
        raise ValueError(
            f"TG_NATIVE_SANITIZE={raw!r}: unknown sanitizer(s) {unknown}; "
            f"supported: {', '.join(SANITIZERS)} (comma-separated)"
        )
    if "thread" in parts and "address" in parts:
        raise ValueError(
            "TG_NATIVE_SANITIZE cannot combine 'thread' with 'address' "
            "(g++ refuses -fsanitize=thread,address); run two builds"
        )
    return parts


def sanitizer_env(base: dict | None = None) -> dict | None:
    """Child-process environment for a sanitized binary: the inherited
    env plus ``TSAN_OPTIONS``/``ASAN_OPTIONS`` wiring the checked-in
    suppressions file and ``halt_on_error=1`` (a detected race must
    abort the server — and so the test — instead of scrolling past an
    ignored stderr). Returns None (inherit untouched) when no sanitize
    mode is active. Operator-set options are preserved and win (appended
    last — later flags override earlier ones in sanitizer runtimes)."""
    mode = sanitize_mode()
    if not mode:
        return None
    env = dict(base if base is not None else os.environ)
    if "thread" in mode:
        opts = f"suppressions={_TSAN_SUPP} halt_on_error=1"
        prior = env.get("TSAN_OPTIONS", "")
        env["TSAN_OPTIONS"] = f"{opts} {prior}".strip()
    if "address" in mode:
        prior = env.get("ASAN_OPTIONS", "")
        env["ASAN_OPTIONS"] = f"halt_on_error=1 {prior}".strip()
    if "undefined" in mode:
        prior = env.get("UBSAN_OPTIONS", "")
        env["UBSAN_OPTIONS"] = (
            f"halt_on_error=1 print_stacktrace=1 {prior}".strip()
        )
    return env


def native_available() -> bool:
    return shutil.which("g++") is not None and os.path.isfile(_SRC)


def _build_native(src: str, name: str, bin_dir: str) -> str:
    """Compile (or reuse) a native binary; returns its path. The binary
    name embeds the source hash — and the active sanitize mode — so
    edits rebuild, stale caches never serve, and an instrumented build
    never shadows the production one (or vice versa)."""
    mode = sanitize_mode()
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    tag = f"-{'-'.join(mode)}" if mode else ""
    os.makedirs(bin_dir, exist_ok=True)
    out = os.path.join(bin_dir, f"{name}-{digest}{tag}")
    if os.path.isfile(out):
        return out
    if mode:
        # -O1 -g with frame pointers: the sanitizer runtimes want
        # debuggable frames, and -O2 can optimize away the exact
        # interleavings TSAN exists to catch
        flags = ["-O1", "-g", "-fno-omit-frame-pointer"] + [
            f"-fsanitize={s}" for s in mode
        ]
    else:
        flags = ["-O2"]
    # unique per builder — including threads within one engine process
    # (DEFAULT_WORKERS=2 can race here on a cold cache)
    tmp = f"{out}.tmp.{os.getpid()}.{uuid.uuid4().hex[:8]}"
    subprocess.run(
        ["g++", *flags, "-std=c++17", "-pthread", "-o", tmp, src],
        check=True,
        capture_output=True,
        text=True,
    )
    os.replace(tmp, out)  # atomic install; last writer wins with same bits
    S().debug("built native binary: %s%s", out, f" [{','.join(mode)}]" if mode else "")
    return out


def build_syncsvc(bin_dir: str) -> str:
    """Compile (or reuse) the sync-server binary; returns its path."""
    return _build_native(_SRC, "tg-syncsvc", bin_dir)


def build_fanin_driver(bin_dir: str) -> str:
    """Compile (or reuse) the fan-in bench's mini-client fleet driver
    (``fanin_driver.cc``, used by ``tools/bench_sync_fanin.py``)."""
    return _build_native(_DRIVER_SRC, "tg-fanin-driver", bin_dir)


class NativeSyncService:
    """Drop-in lifecycle twin of ``SyncServiceServer``: ``.address`` and
    ``.stop()``; the server is a child process.

    ``host`` is the bind address (default loopback; ``0.0.0.0`` serves
    other hosts); ``idle_timeout`` (seconds, 0 = off) evicts silent
    connections server-side (docs/CROSSHOST.md)."""

    def __init__(
        self,
        bin_path: str,
        host: str = "127.0.0.1",
        port: int = 0,
        idle_timeout: float = 0.0,
        evict_grace: float = 2.0,
        shards: int = 0,
        max_wbuf: int = 0,
    ):
        argv = [
            bin_path,
            "--port",
            str(int(port)),
            "--host",
            host,
            "--evict-grace",
            str(float(evict_grace)),
        ]
        if idle_timeout > 0:
            argv += ["--idle-timeout", str(float(idle_timeout))]
        if shards > 0:  # 0 = server-side auto (docs/CROSSHOST.md)
            argv += ["--shards", str(int(shards))]
        if max_wbuf > 0:  # slow-reader outbound-queue bound, bytes
            argv += ["--max-wbuf", str(int(max_wbuf))]
        # sanitized builds: wire the suppressions/halt-on-error options
        # and INHERIT stderr — a TSAN/ASAN report must land in the test
        # log, not a devnull (production builds keep the quiet stderr)
        san_env = sanitizer_env()
        self._proc = subprocess.Popen(
            argv,
            stdout=subprocess.PIPE,
            stderr=None if san_env is not None else subprocess.DEVNULL,
            env=san_env,
            text=True,
        )
        line = self._proc.stdout.readline().strip()
        if not line.startswith("LISTENING "):
            self._proc.kill()
            raise RuntimeError(
                f"native sync service failed to start (got {line!r})"
            )
        self.address = (host, int(line.split()[1]))

    @property
    def pid(self) -> int:
        return self._proc.pid

    def start(self) -> "NativeSyncService":
        return self  # already serving (constructor handshake)

    def stop(self) -> None:
        if self._proc.poll() is None:
            self._proc.send_signal(signal.SIGTERM)
            try:
                self._proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                self._proc.kill()
