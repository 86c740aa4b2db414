"""HTTP client for the daemon (the port's copy of the reference's
``testground_tpu/client``; ``pkg/client``)."""

from .client import Client, DaemonError, RemoteEngine

__all__ = ["Client", "DaemonError", "RemoteEngine"]
