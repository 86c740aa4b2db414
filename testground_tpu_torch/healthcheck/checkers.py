"""The checker the ``sim:torch`` runner uses of the reference's
``testground_tpu/healthcheck/checkers.py`` (``pkg/healthcheck/checkers.go``).

Checkers return ``(ok, message)``.
"""

from __future__ import annotations

import os
import uuid
from typing import Callable

Checker = Callable[[], tuple[bool, str]]

__all__ = ["check_dir_writable"]


def check_dir_writable(path: str) -> Checker:
    """Directory exists AND a file can actually be created in it (catches
    read-only mounts and permission problems, not just absence)."""

    def check() -> tuple[bool, str]:
        if not os.path.isdir(path):
            return False, f"directory missing: {path}"
        # unique probe name: concurrent healthchecks (one per scheduler
        # worker) must not race on the same file
        probe = os.path.join(
            path, f".tg-healthcheck-{os.getpid()}-{uuid.uuid4().hex[:8]}"
        )
        try:
            with open(probe, "w") as f:
                f.write("ok")
            os.unlink(probe)
        except OSError as e:
            return False, f"directory not writable: {path}: {e}"
        return True, f"directory writable: {path}"

    return check
