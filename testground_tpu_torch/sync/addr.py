"""Sync-service address plumbing for cross-host runs.

The reference injects the sync service's cluster-reachable address into
every pod (``cluster_k8s.go:302``); the local analog needs two small
pieces of address logic:

- :func:`parse_hostport` — split the ``host:port`` strings runner
  configs declare (``sync_service_address = "10.0.0.5:9042"``);
- :func:`advertise_host` — turn a *bind* host into the address other
  hosts should *dial*: binding ``0.0.0.0`` (all interfaces) must not
  advertise ``0.0.0.0`` to instances on another machine.

The port's copy of the reference's ``testground_tpu/sync/addr.py``
(ROADMAP's copy policy); only its imports name the port's own modules.
"""

from __future__ import annotations

import socket

__all__ = ["advertise_host", "parse_hostport"]

# bind hosts that mean "all interfaces" and are therefore not dialable
WILDCARD_HOSTS = ("", "0.0.0.0", "::")


def parse_hostport(address: str, default_port: int = 0) -> tuple[str, int]:
    """``"host:port"`` → ``(host, port)``; a bare host gets
    ``default_port``. Refuses empty hosts loudly."""
    address = address.strip()
    host, sep, port_s = address.rpartition(":")
    if not sep:
        host, port_s = address, ""
    if not host:
        raise ValueError(f"sync service address {address!r} has no host")
    if port_s:
        try:
            port = int(port_s)
        except ValueError:
            raise ValueError(
                f"sync service address {address!r} has a non-numeric port"
            ) from None
    else:
        port = default_port
    if not 0 <= port <= 65535:
        raise ValueError(f"sync service address {address!r}: bad port {port}")
    return host, port


def advertise_host(bind_host: str, explicit: str = "") -> str:
    """The host other machines should dial for a service bound to
    ``bind_host``. An ``explicit`` advertise host (runner config) always
    wins; a concrete bind host advertises itself; a wildcard bind
    resolves this machine's primary outbound interface (the UDP-connect
    trick — no packet is sent), falling back to loopback when the host
    has no route at all."""
    if explicit:
        return explicit
    if bind_host not in WILDCARD_HOSTS:
        return bind_host
    try:
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            s.connect(("10.255.255.255", 1))  # RFC1918: never actually sent
            return s.getsockname()[0]
    except OSError:
        return "127.0.0.1"
