"""Minimal TOML emitter.

The stdlib ships ``tomllib`` (read-only); this module provides the write half
needed for persisting compositions (``pkg/api/composition.go:440-459``) and
``--write-artifacts`` round-trips. Supports the subset of TOML the framework
emits: tables, arrays of tables, inline scalars, lists, and nested dicts.
Round-trips with ``tomllib.loads``.

The port's own copy of the reference's
``testground_tpu/utils/toml_writer.py`` (ROADMAP's copy policy);
``tests/test_torch_composition.py`` pins it against the original.
"""

from __future__ import annotations

from typing import Any

__all__ = ["dumps"]


def _format_scalar(v: Any) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float)):
        return repr(v)
    if isinstance(v, str):
        escaped = (
            v.replace("\\", "\\\\")
            .replace('"', '\\"')
            .replace("\n", "\\n")
            .replace("\t", "\\t")
            .replace("\r", "\\r")
        )
        return f'"{escaped}"'
    if isinstance(v, list):
        return "[" + ", ".join(_format_scalar(x) for x in v) + "]"
    raise TypeError(f"cannot TOML-encode value of type {type(v)!r}: {v!r}")


def _needs_quoting(key: str) -> bool:
    return not key.replace("-", "").replace("_", "").isalnum() or key == ""


def _format_key(key: str) -> str:
    return _format_scalar(key) if _needs_quoting(key) else key


def _is_table_array(v: Any) -> bool:
    return (
        isinstance(v, list) and len(v) > 0 and all(isinstance(x, dict) for x in v)
    )


def _emit(d: dict, prefix: list[str], lines: list[str]) -> None:
    scalars = {
        k: v for k, v in d.items() if not isinstance(v, dict) and not _is_table_array(v)
    }
    tables = {k: v for k, v in d.items() if isinstance(v, dict)}
    table_arrays = {k: v for k, v in d.items() if _is_table_array(v)}

    for k, v in scalars.items():
        lines.append(f"{_format_key(k)} = {_format_scalar(v)}")

    for k, v in tables.items():
        path = prefix + [k]
        lines.append("")
        lines.append("[" + ".".join(_format_key(p) for p in path) + "]")
        _emit(v, path, lines)

    for k, arr in table_arrays.items():
        path = prefix + [k]
        for item in arr:
            lines.append("")
            lines.append("[[" + ".".join(_format_key(p) for p in path) + "]]")
            _emit(item, path, lines)


def dumps(d: dict) -> str:
    lines: list[str] = []
    _emit(d, [], lines)
    return "\n".join(lines).lstrip("\n") + "\n"
