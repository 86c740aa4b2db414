"""Builder interface (``pkg/api/builder.go:14-26``) — the port's copy of
the reference's ``testground_tpu/builders/base.py``, with ``build`` alone:
``terminate_all`` and ``purge`` come with the verbs that call them (ROADMAP
queue 1 item 9e), and the ``Precompiler`` capability is not ported, since
the reference's precompile fills XLA's compile cache and the port has no
such cache."""

from __future__ import annotations

import abc
import threading

from ..api import BuildInput, BuildOutput
from ..rpc import OutputWriter

__all__ = ["Builder"]


class Builder(abc.ABC):
    """A builder takes a test plan and builds it into executable form so it
    can be scheduled by a runner."""

    @abc.abstractmethod
    def id(self) -> str: ...

    @abc.abstractmethod
    def build(
        self, inp: BuildInput, ow: OutputWriter, cancel: threading.Event
    ) -> BuildOutput: ...

    def config_type(self) -> type | None:
        return None
