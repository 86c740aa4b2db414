"""OutputWriter: simultaneously a logger and a chunk emitter — the port's
copy of the reference's ``testground_tpu/rpc/writer.py``
(``pkg/rpc/writer.go``).

Progress output (human log lines) is emitted as ``p`` chunks; binary streams
(e.g. collected-outputs tarballs) as base64 ``b`` chunks; and the terminal
result/error as a single ``r``/``e`` chunk.
"""

from __future__ import annotations

import base64
import json
import threading
from typing import Any, BinaryIO, TextIO

from .chunk import CHUNK_BINARY, CHUNK_ERROR, CHUNK_PROGRESS, CHUNK_RESULT

__all__ = ["OutputWriter", "discard_writer"]


class OutputWriter:
    """Thread-safe chunked writer.

    ``sink`` is a text stream receiving newline-delimited JSON chunks (an
    HTTP response body or a file). ``echo`` optionally mirrors progress
    lines to a local console stream.
    """

    def __init__(self, sink: TextIO | None, echo: TextIO | None = None):
        self._sink = sink
        self._echo = echo
        self._lock = threading.Lock()

    def _emit(self, obj: dict) -> None:
        if self._sink is None:
            return
        with self._lock:
            self._sink.write(json.dumps(obj) + "\n")
            self._sink.flush()

    def _log(self, level: str, msg: str, *args: Any) -> None:
        text = (msg % args) if args else msg
        if self._echo is not None:
            with self._lock:
                self._echo.write(text + "\n")
                self._echo.flush()
        self._emit({"t": CHUNK_PROGRESS, "p": f"{text}\n"})

    def info(self, msg: str, *args: Any) -> None:
        self._log("info", msg, *args)

    def infof(self, msg: str, *args: Any) -> None:
        self._log("info", msg, *args)

    def warn(self, msg: str, *args: Any) -> None:
        self._log("warn", msg, *args)

    def error(self, msg: str, *args: Any) -> None:
        self._log("error", msg, *args)

    def debug(self, msg: str, *args: Any) -> None:
        self._log("debug", msg, *args)

    def write_progress(self, data: str) -> None:
        self._emit({"t": CHUNK_PROGRESS, "p": data})

    def write_binary(self, reader: BinaryIO, chunk_size: int = 1 << 16) -> None:
        """Stream binary data as base64 ``b`` chunks (``writer.go`` binary
        writer)."""
        while True:
            buf = reader.read(chunk_size)
            if not buf:
                break
            self._emit(
                {"t": CHUNK_BINARY, "p": base64.b64encode(buf).decode("ascii")}
            )

    def write_result(self, result: Any) -> None:
        self._emit({"t": CHUNK_RESULT, "p": result})

    def write_error(self, msg: str) -> None:
        self._emit({"t": CHUNK_ERROR, "e": {"m": msg}})


def discard_writer() -> OutputWriter:
    """An OutputWriter that drops everything (``rpc.Discard()``)."""
    return OutputWriter(sink=None, echo=None)
