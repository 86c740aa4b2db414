"""The sync plane's shared pieces. Only the typed errors are here so far
(``errors.py``, a copy of ``testground_tpu/sync/errors.py``); the sync
service itself is ROADMAP item 17."""

from .errors import SyncLostError

__all__ = ["SyncLostError"]
