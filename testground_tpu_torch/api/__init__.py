"""Run-input types the port's library surface takes (copies of the
reference's stdlib-only definitions)."""

from .run_input import OutputsEnv, RunGroup, RunInput, RunOutput

__all__ = ["OutputsEnv", "RunGroup", "RunInput", "RunOutput"]
