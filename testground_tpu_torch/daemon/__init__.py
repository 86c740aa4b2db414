"""The daemon: one engine behind an HTTP server (the port's copy of the
reference's ``testground_tpu/daemon``; ``pkg/daemon``)."""

from .server import Daemon, serve

__all__ = ["Daemon", "serve"]
