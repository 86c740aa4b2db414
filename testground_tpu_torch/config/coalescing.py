"""Config coalescing (``pkg/config/coalescing.go``).

Layers of untyped config maps merge left-to-right (later layers win) and
coalesce into a typed config object. The reference round-trips through TOML to
get typed decoding; here dataclass field introspection gives the same effect
without serialization.

The port's own copy of the reference's
``testground_tpu/config/coalescing.py`` (ROADMAP's copy policy);
``tests/test_torch_composition.py`` pins it against the original.
"""

from __future__ import annotations

import dataclasses
import typing
from typing import Any, Type, TypeVar

T = TypeVar("T")


class CoalescedConfig:
    """An ordered stack of config maps; later appends take precedence."""

    def __init__(self, *layers: dict[str, Any] | None):
        self._layers: list[dict[str, Any]] = [l for l in layers if l]

    def append(self, layer: dict[str, Any] | None) -> "CoalescedConfig":
        c = CoalescedConfig()
        c._layers = list(self._layers)
        if layer:
            c._layers.append(layer)
        return c

    def flatten(self) -> dict[str, Any]:
        out: dict[str, Any] = {}
        for layer in self._layers:
            out.update(layer)
        return out

    def coalesce_into(self, typ: Type[T]) -> T:
        """Build a ``typ`` dataclass from the flattened map; unknown keys are
        ignored and nested dataclass fields are constructed recursively
        (mirrors TOML round-trip decoding semantics of ``CoalesceIntoType``,
        ``coalescing.go:11-39``)."""
        return _into_dataclass(typ, self.flatten())


def _into_dataclass(typ: Type[T], data: dict[str, Any]) -> T:
    if not dataclasses.is_dataclass(typ):
        raise TypeError(f"{typ} is not a dataclass")
    # Resolve string annotations (PEP 563 modules) to real types.
    try:
        hints = typing.get_type_hints(typ)
    except Exception:
        hints = {}
    kwargs: dict[str, Any] = {}
    for f in dataclasses.fields(typ):
        if f.name not in data:
            continue
        v = data[f.name]
        ftype = hints.get(f.name, f.type if isinstance(f.type, type) else None)
        if ftype is not None and dataclasses.is_dataclass(ftype) and isinstance(v, dict):
            v = _into_dataclass(ftype, v)
        kwargs[f.name] = v
    return typ(**kwargs)
