"""Run-input types the port's library surface takes (copies of the
reference's stdlib-only definitions)."""

from .run_input import RunGroup

__all__ = ["RunGroup"]
