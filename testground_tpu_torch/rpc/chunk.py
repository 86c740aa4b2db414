"""Chunk wire format — the port's copy of the reference's
``testground_tpu/rpc/chunk.py`` (``pkg/rpc/chunk.go``).

For a given request, clients should expect 0..n ``progress`` chunks and
exactly one ``result`` or ``error`` chunk before EOF. Binary payloads are
base64-encoded strings.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Any, Iterator

CHUNK_PROGRESS = "p"
CHUNK_BINARY = "b"
CHUNK_RESULT = "r"
CHUNK_ERROR = "e"


@dataclass
class Chunk:
    type: str
    payload: Any = None
    error: str | None = None

    def to_json(self) -> str:
        d: dict = {"t": self.type}
        if self.payload is not None:
            d["p"] = self.payload
        if self.error is not None:
            d["e"] = {"m": self.error}
        return json.dumps(d)

    @classmethod
    def from_json(cls, line: str) -> "Chunk":
        d = json.loads(line)
        err = d.get("e")
        return cls(
            type=d["t"],
            payload=d.get("p"),
            error=err["m"] if err else None,
        )


def parse_chunks(stream) -> Iterator[Chunk]:
    """Parse newline-delimited chunks from a text-line iterable."""
    for line in stream:
        if isinstance(line, bytes):
            line = line.decode("utf-8")
        line = line.strip()
        if line:
            yield Chunk.from_json(line)
