"""Logging singleton (twin of ``pkg/logging/log.go``): a process-wide
structured logger with an adjustable level and console-style output.

The port's own copy of the reference's ``testground_tpu/logging_.py``
(ROADMAP's copy policy), logging as ``testground_tpu_torch``.
"""

from __future__ import annotations

import logging
import sys

__all__ = ["S", "set_level"]

_logger: logging.Logger | None = None


def _build() -> logging.Logger:
    logger = logging.getLogger("testground_tpu_torch")
    if not logger.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(
            logging.Formatter(
                "%(asctime)s\t%(levelname)s\t%(name)s\t%(message)s",
                datefmt="%H:%M:%S",
            )
        )
        logger.addHandler(h)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    return logger


def S() -> logging.Logger:
    """The process-wide logger (``logging.S()`` in the reference)."""
    global _logger
    if _logger is None:
        _logger = _build()
    return _logger


def set_level(level: str) -> None:
    S().setLevel(getattr(logging, level.upper(), logging.INFO))
