"""A run's outcome — the port's copy of the reference's ``Outcome``
(``testground_tpu/engine/task.py``; ``pkg/task/task.go:22-29``)."""

from __future__ import annotations

import enum

__all__ = ["Outcome"]


class Outcome(str, enum.Enum):
    """(``task.go:22-29``)."""

    UNKNOWN = "unknown"
    SUCCESS = "success"
    FAILURE = "failure"
    CANCELED = "canceled"
