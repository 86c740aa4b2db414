"""Task types the port's executor reports with (copies of the reference's
``testground_tpu/engine`` definitions it needs)."""

from .task import Outcome

__all__ = ["Outcome"]
