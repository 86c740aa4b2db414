"""Streaming response protocol between daemon and client (the port's copy
of the reference's ``testground_tpu/rpc``): newline-delimited JSON chunks
typed ``p`` (progress), ``b`` (binary, base64), ``r`` (result), ``e``
(error)."""

from .chunk import (
    CHUNK_BINARY,
    CHUNK_ERROR,
    CHUNK_PROGRESS,
    CHUNK_RESULT,
    Chunk,
    parse_chunks,
)
from .writer import OutputWriter, discard_writer

__all__ = [
    "CHUNK_BINARY",
    "CHUNK_ERROR",
    "CHUNK_PROGRESS",
    "CHUNK_RESULT",
    "Chunk",
    "OutputWriter",
    "discard_writer",
    "parse_chunks",
]
