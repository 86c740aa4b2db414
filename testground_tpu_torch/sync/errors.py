"""Typed sync-plane errors: a copy of ``testground_tpu/sync/errors.py``.

The failure-hardening contract (docs/CROSSHOST.md): a client whose
connection to the sync service cannot be (re)established within the
configured attempt/deadline budget raises :class:`SyncLostError` — a
typed, catchable signal that the host-side control plane is gone —
instead of hanging a barrier or pub/sub waiter indefinitely.
"""

from __future__ import annotations

__all__ = ["SyncLostError"]


class SyncLostError(ConnectionError):
    """The sync service is unreachable (or restarted and lost its state)
    and the client's reconnect budget is exhausted.

    Carries the service address and the attempt history so operators can
    tell *which* endpoint died from the message alone. Classified as
    cohort-fatal by ``sim/cohort.py`` — losing the coordination plane
    poisons a cross-host run the same way a dead ``torch.distributed``
    member does.
    """

    def __init__(
        self,
        message: str,
        *,
        address: tuple[str, int] | None = None,
        attempts: int = 0,
        elapsed_secs: float = 0.0,
    ):
        super().__init__(message)
        self.address = address
        self.attempts = attempts
        self.elapsed_secs = elapsed_secs
