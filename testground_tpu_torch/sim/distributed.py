"""Multi-process cohorts over ``torch.distributed``.

Port of ``testground_tpu/sim/distributed.py``. A run scales past one
process as a cohort: every process joins one ``torch.distributed`` job
whose store the leader hosts at the coordinator address, the instance
axis's calendar splits over the union of the processes' devices, and
every process runs the identical program in the identical order (the
reference's multi-controller contract).

Topology of a run, as in the reference:

- the **leader** (process 0) is the process whose engine executes the
  task: it broadcasts the job spec (plan, case, shapes, seed) to the
  cohort, runs the program, and owns outputs and journal;
- **followers** (``tg sim-worker``) join the coordinator, receive each job
  spec, run the SAME program over the same global mesh, and loop for the
  next job.

What the port keeps on each process: the whole instance state, replicated
and stepped identically, on the process's own device, and the calendar
shards of its own mesh cells (``meshplan.TorchMesh.ranks``). What crosses
processes each tick is the calendar's: the sorted commit's survival mask
(:func:`all_reduce_sum`) and the popped rows (:func:`all_gather`); see
``sim/cuda_transport.py`` and ``sim/net.py``. Sums of int32 are exact, so
the replicated state cannot drift.

Process groups. The job spec, the readiness vote, the cancel vote and the
shutdown sentinel are host-side and go over gloo: the spec over a *lobby*
group whose timeout is long (a follower waits there between jobs), the
votes over the default group, whose timeout (``heartbeat_timeout_seconds``)
bounds how long a hung member can stall the others. A member that dies
closes its connections, and the survivors' next collective fails at once.
The tick's tensors go over NCCL where every rank holds a card of its own,
and over gloo where two ranks share a card (NCCL refuses that) or the run
is on the CPU; :func:`global_mesh` makes that choice from what every rank
reports, so all ranks choose alike, and :func:`backend` names it.

Plan sources must be present on every process at the same plan name, and
every process takes exactly one device: its run's device (``cpu``, a card
named ``cuda:<k>``, or the current card). So the reference's requirement,
the same local device count on every host, holds by construction.
"""

from __future__ import annotations

import datetime
import json
import socket

import numpy as np
import torch
import torch.distributed as dist

__all__ = [
    "SPEC_BYTES",
    "CohortCancel",
    "all_gather",
    "all_reduce_sum",
    "backend",
    "broadcast_json",
    "broadcast_shutdown_if_leader",
    "cohort_agree",
    "global_mesh",
    "init_distributed",
    "is_leader",
    "is_multiprocess",
    "shutdown",
    "to_host",
]

# Fixed wire size for the job-spec broadcast, the reference's bound. Public
# name: the executor prechecks a composition's spec against it BEFORE any
# cohort process spawns (executor._precheck_cohort_spec_size).
SPEC_BYTES = 65536
_SPEC_BYTES = SPEC_BYTES

# a follower waits in the lobby between jobs for as long as it serves
_LOBBY_TIMEOUT = datetime.timedelta(days=365)

_joined: dict = {}  # key, lobby group, and the tensor group per mesh


# error-text markers of a coordinator that is not (yet) reachable — the
# retryable class of join failures (a worker racing the leader's start)
_CONNECT_MARKERS = (
    "deadline",
    "unavailable",
    "connection refused",
    "failed to connect",
    "timed out",
    "timeout",
    "connection reset",
)


def _is_connect_error(exc: BaseException) -> bool:
    return any(m in str(exc).lower() for m in _CONNECT_MARKERS)


def _split_address(address: str) -> tuple[str, int]:
    host, sep, port = str(address).rpartition(":")
    if not sep or not host or not port.isdigit():
        raise ValueError(
            f"coordinator address {address!r} is not host:port"
        )
    return host.strip("[]"), int(port)


def init_distributed(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    heartbeat_timeout_seconds: int = 30,
    connect_attempts: int = 3,
    connect_timeout_seconds: float = 60.0,
) -> None:
    """Join the cohort (idempotent): a ``TCPStore`` at the coordinator,
    hosted by process 0, then a gloo process group over it.

    ``heartbeat_timeout_seconds`` is the default group's collective
    timeout: the bound on how long a hung (not dead) member stalls the
    others; a dead member's closed connections fail the survivors' next
    collective at once. Joining retries connect-class failures (refused /
    timed out) up to ``connect_attempts`` times with backoff inside a
    per-attempt ``connect_timeout_seconds`` budget, then fails with an
    error that names the coordinator address. A process that already
    joined another group refuses to join."""
    import time

    key = (str(coordinator_address), int(num_processes), int(process_id))
    if _joined.get("key") == key:
        return
    if _joined or dist.is_initialized():
        raise RuntimeError(
            "cannot join a multi-host cohort: this process already joined "
            "a torch.distributed process group"
            + (f" (cohort {_joined['key'][0]}, {_joined['key'][1]} "
               "processes)" if _joined else "")
            + ". Multi-host jobs need a fresh engine process whose FIRST "
            "sim run carries the coordinator_address config."
        )
    host, port = _split_address(coordinator_address)
    attempts = max(1, int(connect_attempts))
    budget = datetime.timedelta(seconds=float(connect_timeout_seconds))
    for attempt in range(1, attempts + 1):
        try:
            store = dist.TCPStore(
                host, port, int(num_processes), int(process_id) == 0,
                timeout=budget,
            )
            dist.init_process_group(
                "gloo", store=store, rank=int(process_id),
                world_size=int(num_processes),
                timeout=datetime.timedelta(seconds=heartbeat_timeout_seconds),
            )
            break
        except Exception as e:  # noqa: BLE001 — torch's store/backend errors
            if not _is_connect_error(e):
                raise  # not a join problem — keep the original diagnosis
            if dist.is_initialized():
                dist.destroy_process_group()
            if attempt >= attempts:
                raise RuntimeError(
                    f"could not join cohort coordinator at "
                    f"{coordinator_address} after {attempts} attempt(s): {e}"
                ) from e
        time.sleep(min(5.0, 0.5 * (2 ** (attempt - 1))))
    _joined.update(
        key=key,
        store=store,
        lobby=dist.new_group(backend="gloo", timeout=_LOBBY_TIMEOUT),
        tensor={},
    )


def is_multiprocess() -> bool:
    return bool(_joined) and dist.get_world_size() > 1


def is_leader() -> bool:
    return not _joined or dist.get_rank() == 0


def _device_key(dev: torch.device) -> str:
    """What tells two ranks' devices apart across hosts: the host and the
    card's UUID (the CPU is never shared state)."""
    if dev.type != "cuda":
        return f"{socket.gethostname()}/{dev.type}"
    props = torch.cuda.get_device_properties(dev)
    return f"{socket.gethostname()}/{getattr(props, 'uuid', dev.index)}"


def global_mesh(device):
    """One mesh axis ``"i"`` over every process's device, in rank order: a
    1-D ``meshplan.TorchMesh`` whose cell ``r`` is rank r's, of which this
    process holds only its own (``mesh.parts``). Chooses the backend of
    the tick's collectives from what every rank reports: NCCL when every
    rank holds a card of its own, else gloo."""
    from .meshplan import TorchMesh, _indexed

    dev = _indexed(device)
    mine = (dev.type, dev.index, _device_key(dev))
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    kinds = sorted({t for t, _, _ in every})
    if len(kinds) != 1:
        raise RuntimeError(
            "cohort members run on different device types "
            f"({', '.join(kinds)}): every process of a cohort must run its "
            "share on the same kind of device — set the same device on "
            "the leader's runner config and each sim-worker"
        )
    devices = tuple(
        torch.device(t) if i is None else torch.device(t, i) for t, i, _ in every
    )
    own_cards = kinds == ["cuda"] and len({k for _, _, k in every}) == len(every)
    name = "nccl" if own_cards else "gloo"
    if name not in _joined["tensor"]:
        # every rank takes the same branch: the choice is a function of
        # the gathered list alone
        _joined["tensor"][name] = (
            dist.new_group(backend="nccl") if name == "nccl" else None
        )
    _joined["backend"] = name
    return TorchMesh(devices, ranks=tuple(range(len(every))), rank=dist.get_rank())


def backend() -> str:
    """The backend of the tick's collectives of the last global mesh."""
    return _joined.get("backend", "gloo")


def _tensor_group():
    return _joined["tensor"].get(backend())


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum ``x`` over the cohort, in place; returns ``x``. On the card the
    collective runs behind the work already queued on the current stream
    (NCCL and gloo both wait on it), so it reads what the kernels wrote."""
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=_tensor_group())
    return x


def all_gather(x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` stacked in rank order: ``[P, *x.shape]``."""
    out = torch.empty((dist.get_world_size(), *x.shape), dtype=x.dtype,
                      device=x.device)
    dist.all_gather(list(out.unbind(0)), x.contiguous(), group=_tensor_group())
    return out


def broadcast_json(obj: dict | None) -> dict:
    """Leader sends ``obj``; followers pass None and receive it. One
    fixed-size uint8 broadcast over the lobby group."""
    buf = torch.zeros(_SPEC_BYTES, dtype=torch.uint8)
    if obj is not None:
        raw = json.dumps(obj).encode()
        if len(raw) + 8 > _SPEC_BYTES:
            raise ValueError(
                f"job spec too large for broadcast: {len(raw)} bytes"
            )
        buf[:8] = torch.frombuffer(bytearray(len(raw).to_bytes(8, "little")),
                                   dtype=torch.uint8)
        buf[8 : 8 + len(raw)] = torch.frombuffer(bytearray(raw), dtype=torch.uint8)
    dist.broadcast(buf, src=0, group=_joined["lobby"])
    out = buf.numpy()
    size = int.from_bytes(out[:8].tobytes(), "little")
    return json.loads(out[8 : 8 + size].tobytes().decode())


def cohort_agree(ok: bool) -> bool:
    """All-processes AND over a local readiness bit (one MIN reduction).
    Run after receiving a job spec: a process whose plans dir cannot
    satisfy the job votes False and EVERY process skips the job in
    lockstep — otherwise the dead worker would strand the cohort
    mid-collective."""
    vote = torch.tensor([1 if ok else 0], dtype=torch.int32)
    dist.all_reduce(vote, op=dist.ReduceOp.MIN)
    return bool(int(vote[0]) == 1)


class CohortCancel:
    """Cancellation as a cohort decision: the leader broadcasts its local
    cancel state once per chunk and every process observes the same
    answer — a leader honoring a local Event alone would break out of the
    chunk loop and issue collectives the followers aren't running."""

    def __init__(self, local_event=None):
        self._local = local_event

    def set(self) -> None:
        """Mark the local half; the cohort observes it at the next
        ``is_set`` broadcast (the chunk-boundary vote)."""
        if self._local is not None:
            self._local.set()

    def is_set(self) -> bool:
        flag = 1 if (self._local is not None and self._local.is_set()) else 0
        out = torch.tensor([flag], dtype=torch.uint8)
        dist.broadcast(out, src=0)
        return bool(int(out[0]))


def broadcast_shutdown_if_leader() -> None:
    """Release any waiting sim-workers when a leader engine shuts down
    (their next broadcast receives the shutdown sentinel)."""
    if _joined and is_leader() and is_multiprocess():
        broadcast_json({"shutdown": True})


def shutdown() -> None:
    """Leave the cohort: destroy the process groups (a local teardown,
    no barrier)."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _joined.clear()


def to_host(x) -> np.ndarray:
    """``x`` on this process's host. A cohort's results come out of the
    replicated state every process holds, so this is a local read on every
    process, where the reference gathers its cross-host shards."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
