"""The one sync-service backend-selection policy.

Both consumers of "start me a sync service" — the ``local:exec``
runner's per-run server and the standalone ``tg sync-service`` — boot
through this helper, so the auto/native/python selection, the toolchain
probe, and the fallback semantics cannot diverge.

The port's copy of the reference's ``testground_tpu/sync/boot.py``
(ROADMAP's copy policy); only its imports name the port's own modules.
"""

from __future__ import annotations

from typing import Callable

__all__ = ["boot_sync_service"]


def boot_sync_service(
    mode: str,
    host: str,
    port: int,
    idle_timeout: float,
    evict_grace: float,
    bin_dir: str,
    log: Callable[[str], None] | None = None,
    shards: int = 0,
):
    """Start a sync service and return it (``.address`` / ``.stop()``).

    ``mode``: ``"native"`` = the C++ event-loop server (built on demand
    into ``bin_dir``), ``"python"`` = the in-process server, ``"auto"``
    = native when a toolchain is available, falling back to python with
    a ``log`` notice. A forced native mode raises instead of falling
    back. ``shards`` is the event-loop count (0 = backend auto:
    native picks min(4, cores), python runs one loop)."""
    if mode not in ("auto", "python", "native"):
        raise ValueError(f"unknown sync_service mode {mode!r}")
    if mode in ("auto", "native"):
        from ..native import (
            NativeSyncService,
            build_syncsvc,
            native_available,
        )

        if native_available():
            try:
                path = build_syncsvc(bin_dir)
                svc = NativeSyncService(
                    path,
                    host=host,
                    port=port,
                    idle_timeout=idle_timeout,
                    evict_grace=evict_grace,
                    shards=shards,
                )
                if log:
                    log(f"sync service: native ({path})")
                return svc
            except Exception as e:  # noqa: BLE001 — auto falls back
                if mode == "native":
                    raise
                if log:
                    log(
                        f"native sync service unavailable ({e}); "
                        "falling back to python"
                    )
        elif mode == "native":
            raise RuntimeError(
                "sync_service='native' but no C++ toolchain (g++) found"
            )
    from .server import SyncServiceServer

    return SyncServiceServer(
        host=host,
        port=port,
        idle_timeout=idle_timeout,
        evict_grace=evict_grace,
        shards=max(1, shards),
    ).start()
