"""The fixers the ``sim:torch`` runner uses of the reference's
``testground_tpu/healthcheck/fixers.py`` (``pkg/healthcheck/fixers.go``).

Fixers return a message on success and raise on failure.
"""

from __future__ import annotations

import os
from typing import Callable

Fixer = Callable[[], str]

__all__ = ["create_directory", "requires_manual_fixing"]


def create_directory(path: str) -> Fixer:
    def fix() -> str:
        os.makedirs(path, exist_ok=True)
        return f"created directory {path}"

    return fix


def requires_manual_fixing(hint: str = "") -> Fixer:
    def fix() -> str:
        raise RuntimeError(f"requires manual fixing: {hint}" if hint else
                           "requires manual fixing")

    return fix
