"""Coordination service: Signal/Barrier/Publish/Subscribe primitives.

Twin of the reference's external sync service (Redis-backed
``iptestground/sync-service`` consumed through sdk-go — SURVEY.md §2.6):

- :class:`InMemSyncService` — in-process implementation, the functional twin
  of ``sync.NewInmemClient()`` (``pkg/sidecar/mock.go``); shared by unit
  tests and the runners' host-side coordination.
- :class:`SyncServiceServer` — TCP JSON-lines server exposing the same
  primitives to real-process instances (the ``local:exec`` runner's infra).
- :class:`SyncClient` — blocking socket client used by the SDK inside
  instances.

Event streams (instance lifecycle Success/Failure/Crash consumed by runners
via ``SubscribeEvents``) ride the same pub/sub as a reserved per-run topic.

The port's copy of the reference's ``testground_tpu/sync/`` (ROADMAP's
copy policy), module for module under the same names. The sim plans keep
their in-sim sync (``sim/sync_kernel.py``); this package is the service
that process instances talk to over TCP.
"""

from .addr import advertise_host, parse_hostport
from .errors import SyncLostError
from .inmem import InMemSyncService
from .client import SyncClient, SyncRetry
from .server import SyncServiceServer

__all__ = [
    "InMemSyncService",
    "SyncClient",
    "SyncLostError",
    "SyncRetry",
    "SyncServiceServer",
    "advertise_host",
    "parse_hostport",
]

# Reserved topic carrying instance lifecycle events for a run; the runner
# subscribes to it to collect outcomes (``local_docker.go:217-256``).
RUN_EVENTS_TOPIC = "__run_events__"
