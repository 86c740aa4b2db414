"""Where the build's precompile pass keeps its BuildKey markers — the
directory logic of the reference's ``testground_tpu/utils/compile_cache.py``
(``:33-49``), without XLA's cache configuration and event counts: the port
compiles no XLA program. Its one compiled artifact is the kernel library
(``sim/cuda_transport.py``, cached by source digest under ``_build/``); the
markers under ``<cache dir>/precompiled/`` record what a build warmed.

``TESTGROUND_COMPILE_CACHE`` overrides the location; the values
``off``/``0``/``none``/``false`` disable the precompile pass (and a run's
bucket block then journals ``compile_cache: "off"``).
"""

from __future__ import annotations

import os

__all__ = ["compile_cache_dir"]

_DISABLE = ("off", "0", "none", "false")


def compile_cache_dir(home: str | None = None) -> str | None:
    """Resolve the cache directory: env override > ``$TESTGROUND_HOME``
    layout > default home (``~/testground``). None means disabled."""
    env = os.environ.get("TESTGROUND_COMPILE_CACHE", "")
    if env:
        return None if env.lower() in _DISABLE else env
    if not home:
        home = os.environ.get("TESTGROUND_HOME") or os.path.join(
            os.path.expanduser("~"), "testground"
        )
    return os.path.join(home, "data", "compile-cache")
