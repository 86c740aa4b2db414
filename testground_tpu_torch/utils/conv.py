"""Value conversions (``pkg/conv/conversions.go``).

The port's own copy of the reference's ``testground_tpu/utils/conv.py``
(ROADMAP's copy policy); ``tests/test_torch_composition.py`` pins it against
the original.
"""

from __future__ import annotations

import json
from typing import Any

__all__ = [
    "env_list_to_map",
    "infer_typed",
    "map_to_env_list",
    "parse_key_values",
]


def env_list_to_map(env: list[str]) -> dict[str, str]:
    """``["K=V", ...] -> {K: V}`` (``conversions.go:12-22``)."""
    out: dict[str, str] = {}
    for kv in env:
        k, _, v = kv.partition("=")
        out[k] = v
    return out


def map_to_env_list(m: dict[str, str]) -> list[str]:
    return [f"{k}={v}" for k, v in m.items()]


def infer_typed(v: str) -> Any:
    """Infer a typed value from a string: JSON literal if it parses, else the
    raw string (the reference's typed-map inference, ``conversions.go:24-50``)."""
    try:
        return json.loads(v)
    except (json.JSONDecodeError, ValueError):
        return v


def parse_key_values(pairs: list[str]) -> dict[str, Any]:
    """``["k=v", ...]`` with typed-value inference; used by CLI
    ``--run-param``/``--build-param`` style flags."""
    out: dict[str, Any] = {}
    for kv in pairs:
        k, _, v = kv.partition("=")
        out[k] = infer_typed(v)
    return out
