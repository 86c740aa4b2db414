"""Multi-process cohorts over ``torch.distributed``, and the parts of a
several-part mesh in one process.

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

What the port keeps on each process: its own lanes. Every process takes
exactly one cell of the mesh (``meshplan.TorchMesh.ranks``), so rank r
holds lanes ``[r·n_loc, (r+1)·n_loc)`` of every lane-placed leaf of the
carry (``meshplan.MeshPlan.lane_axis``: the instance rows, the link
planes, the plan states, the keys, the sync service's per-instance
planes and its calendar shard) and steps only those; the scalars, the
flow counters, the sync service's shared leaves and the planes'
accumulators are replicated and equal on every rank. What crosses
processes each tick (``sim/engine.py``, ``sim/net.py``,
``sim/sync_kernel.py``): the live counts and the transport's counts
(:func:`all_reduce_sum`), the senders' compacted message stream, grouped
by destination rank (:func:`gather_blocks`), every rank's sync totals and
partial counts in one :func:`all_gather` (each rank adds the lower ranks'
for its exclusive sums, every rank all of them), and the sync service's
publishes (:func:`gather_blocks`). Integer sums are
exact and every rank folds the same gathered values in the same order,
so the replicated leaves cannot drift. :func:`to_host` gathers a placed
leaf over the ranks in rank order, as the reference's
``process_allgather(tiled=True)`` does: it is collective, so every rank
calls it in lockstep.

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

The parts of one process. A mesh of several parts outside a cohort
(``meshplan.TorchMesh.part_view``) runs the same per-owner tick, one host
thread a part, and its parts meet at each collective through the mesh's
:class:`PartGroup` instead of ``torch.distributed``. The parts take
turns, in part order, from one collective to the next; the last folds
every part's tensor once, in part order, on part 0's device, and each
part takes the result onto its own device (a read of another part's
tensor is a ``.to(device)``, which orders the copy behind that part's
stream). So the replicated leaves are bit-equal on every part. Every
collective below takes the ``mesh`` it runs over and dispatches on it: a
mesh with a ``group`` folds in process, any other goes over the cohort's
process groups. A part that fails breaks the group
(:meth:`PartGroup.abort`), and every part waiting for its turn then
raises :class:`PartsBroken`.

Plan sources must be present on every process at the same plan name, and
every process takes exactly one device: its run's device (``cpu``, a card
named ``cuda:<k>``, or the current card). So the reference's requirement,
the same local device count on every host, holds by construction.
"""

from __future__ import annotations

import datetime
import json
import socket
import threading
import time

import numpy as np
import torch
import torch.distributed as dist

__all__ = [
    "PART_WAIT_SECS",
    "SPEC_BYTES",
    "CohortCancel",
    "PartGroup",
    "PartsBroken",
    "all_gather",
    "all_gather_cat",
    "all_reduce_max",
    "all_reduce_min",
    "all_reduce_sum",
    "backend",
    "broadcast_json",
    "broadcast_shutdown_if_leader",
    "cohort_agree",
    "collective_stats",
    "gather_blocks",
    "global_mesh",
    "init_distributed",
    "is_leader",
    "is_multiprocess",
    "shutdown",
    "to_host",
    "vote_all",
]

# Fixed wire size for the job-spec broadcast, the reference's bound. Public
# name: the executor prechecks a composition's spec against it BEFORE any
# cohort process spawns (executor._precheck_cohort_spec_size).
SPEC_BYTES = 65536
_SPEC_BYTES = SPEC_BYTES

# a follower waits in the lobby between jobs for as long as it serves
_LOBBY_TIMEOUT = datetime.timedelta(days=365)

_joined: dict = {}  # key, lobby group, and the tensor group per mesh

# the tick's collectives of this process: calls, bytes it sent and host
# seconds in each, per op (collective_stats)
_STATS: dict = {}


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


def _count(stats: dict, op: str, x: torch.Tensor, secs: float) -> None:
    st = stats.setdefault(op, [0, 0, 0.0])
    st[0] += 1
    st[1] += x.numel() * x.element_size()
    st[2] += secs


def _counted(op: str, x: torch.Tensor, call) -> None:
    t0 = time.perf_counter()
    call()
    _count(_STATS, op, x, time.perf_counter() - t0)


# the longest a part waits for its turn (a part that fails breaks the
# wait at once)
PART_WAIT_SECS = 600.0


class PartsBroken(RuntimeError):
    """Another part of the mesh failed (or outwaited ``PART_WAIT_SECS``)
    while this one waited for its turn."""


def _fold_sum(xs):
    out = xs[0].clone()
    for x in xs[1:]:
        out += x.to(out.device)
    return out


def _fold_with(fn):
    def fold(xs):
        out = xs[0]
        for x in xs[1:]:
            out = fn(out, x.to(out.device))
        return out

    return fold


def _fold_blocks(xs):
    dev, kmax = xs[0].device, max(x.shape[0] for x in xs)
    return torch.stack([
        x.to(dev) if x.shape[0] == kmax
        else torch.cat([x.to(dev), x.new_zeros((kmax - x.shape[0], *x.shape[1:]), device=dev)])
        for x in xs
    ])


_FOLDS = {
    "sum": _fold_sum,
    "max": _fold_with(torch.maximum),
    "min": _fold_with(torch.minimum),
    "gather": lambda xs: torch.stack([x.to(xs[0].device) for x in xs]),
    "cat": lambda xs: torch.cat([x.to(xs[0].device) for x in xs]),
    "blocks": _fold_blocks,
}


class PartGroup:
    """The parts of one process's several-part mesh, one host thread each,
    taking turns: one part runs at a time, up to its next collective, and
    hands the turn to the next part in part order; the last part to arrive
    folds every part's tensor once, in part order (on part 0's device), and
    hands the turn back to part 0, and each part then reads the one result.
    One runner at a time keeps the parts' host work from fighting over the
    interpreter lock and the CPU's op threads, while their devices' queued
    work overlaps. The parts call the same collectives in the same order
    (the tick's lockstep); a part whose collective differs, or that ended
    while the others met, fails the fold."""

    def __init__(self, size: int):
        self.size = int(size)
        self._lock = threading.Lock()
        self._stats: dict = {}
        self.reset()

    def reset(self) -> None:
        """Arm the group for a new dispatch: part 0 holds the turn."""
        self._turn = [threading.Semaphore(0) for _ in range(self.size)]
        self._put: list = [None] * self.size
        self._out = None
        self._broken = False

    def _fold(self) -> None:
        ops = {None if put is None else put[0] for put in self._put}
        if len(ops) != 1 or None in ops:
            raise RuntimeError(
                "the mesh's parts left lockstep: at one collective they called "
                + ", ".join(str(None if put is None else put[0]) for put in self._put)
                + " (None: the part had ended)"
            )
        self._out = _FOLDS[ops.pop()]([x for _, x in self._put])
        self._put = [None] * self.size

    def _check(self, rank: int, what: str) -> None:
        if self._broken:
            raise PartsBroken(
                f"mesh part {rank}: another part failed, or the parts did not "
                f"reach {what} within {PART_WAIT_SECS:g} s"
            )

    def _wait(self, rank: int, what: str) -> None:
        if not self._turn[rank].acquire(timeout=PART_WAIT_SECS):
            self.abort()
        self._check(rank, what)

    def start(self, rank: int) -> None:
        """Wait for part ``rank``'s first turn (part 0 holds it)."""
        if rank:
            self._wait(rank, "their start")

    def finish(self, rank: int) -> None:
        """Part ``rank`` ended its work: hand the turn on."""
        self._turn[(rank + 1) % self.size].release()

    def meet(self, rank: int, op: str, x: torch.Tensor):
        """Part ``rank``'s ``x`` folded with every other part's by ``op``
        (``sum``, ``max``, ``min``: elementwise; ``gather``: stacked;
        ``cat``: concatenated along dim 0; ``blocks``: padded to the
        longest and stacked): the one result, on part 0's device."""
        t0 = time.perf_counter()
        self._check(rank, f"a collective ({op})")
        self._put[rank] = (op, x)
        if rank == self.size - 1:
            self._fold()
        self._turn[(rank + 1) % self.size].release()
        self._wait(rank, f"a collective ({op})")
        out = self._out
        with self._lock:
            _count(self._stats, _OP_NAMES[op], x, time.perf_counter() - t0)
        return out

    def abort(self) -> None:
        """Break the group: every part waiting for its turn, and every part
        that waits for one, raises :class:`PartsBroken`."""
        self._broken = True
        for turn in self._turn:
            turn.release()

    def stats(self, reset: bool = False) -> dict:
        with self._lock:
            out = {op: {"calls": c, "bytes": b, "secs": t}
                   for op, (c, b, t) in self._stats.items()}
            if reset:
                self._stats.clear()
        return out


_OP_NAMES = {"sum": "all_reduce", "max": "all_reduce", "min": "all_reduce",
             "gather": "all_gather", "cat": "all_gather", "blocks": "all_gather"}


def _group(mesh) -> PartGroup | None:
    return None if mesh is None else mesh.group


def _reduce_in(mesh, op: str, x: torch.Tensor) -> torch.Tensor:
    """``x`` reduced over the mesh's parts, in place."""
    return x.copy_(mesh.group.meet(mesh.rank, op, x))


def _gather_in(mesh, op: str, x: torch.Tensor) -> torch.Tensor:
    out = mesh.group.meet(mesh.rank, op, x)
    return out if out.device == x.device else out.to(x.device)


def collective_stats(reset: bool = False, mesh=None) -> dict:
    """This process's tick collectives since the last reset, per op:
    ``{op: {"calls", "bytes", "secs"}}`` — the bytes it sent, the host
    seconds the calls took (a call on gloo returns when its data is in).
    With a several-part ``mesh``, its parts' (every part's calls)."""
    if _group(mesh) is not None:
        return mesh.group.stats(reset)
    out = {op: {"calls": c, "bytes": b, "secs": t} for op, (c, b, t) in _STATS.items()}
    if reset:
        _STATS.clear()
    return out


def all_reduce_sum(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """Sum ``x`` over the cohort (over ``mesh``'s parts where it has a
    group), in place; returns ``x``. On the card the collective runs behind
    the work already queued on the current stream (NCCL and gloo both wait
    on it), so it reads what the kernels wrote."""
    if _group(mesh) is not None:
        return _reduce_in(mesh, "sum", x)
    _counted("all_reduce", x, lambda: dist.all_reduce(
        x, op=dist.ReduceOp.SUM, group=_tensor_group()))
    return x


def all_reduce_max(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """The elementwise max of ``x`` over the cohort, in place."""
    if _group(mesh) is not None:
        return _reduce_in(mesh, "max", x)
    _counted("all_reduce", x, lambda: dist.all_reduce(
        x, op=dist.ReduceOp.MAX, group=_tensor_group()))
    return x


def all_reduce_min(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """The elementwise min of ``x`` over the cohort, in place."""
    if _group(mesh) is not None:
        return _reduce_in(mesh, "min", x)
    _counted("all_reduce", x, lambda: dist.all_reduce(
        x, op=dist.ReduceOp.MIN, group=_tensor_group()))
    return x


def all_gather(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """Every rank's ``x`` stacked in rank order: ``[P, *x.shape]``."""
    if _group(mesh) is not None:
        return _gather_in(mesh, "gather", x)
    out = torch.empty((dist.get_world_size(), *x.shape), dtype=x.dtype,
                      device=x.device)
    x = x.contiguous()
    _counted("all_gather", x, lambda: dist.all_gather(
        list(out.unbind(0)), x, group=_tensor_group()))
    return out


def all_gather_cat(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """Every rank's ``x`` concatenated along dim 0 in rank order (the
    ranks' lengths may differ on a several-part mesh; a cohort's are
    equal)."""
    if _group(mesh) is not None:
        return _gather_in(mesh, "cat", x)
    return all_gather(x).reshape(-1, *x.shape[1:])


def gather_blocks(x: torch.Tensor, counts: list[int] | None = None, mesh=None) -> tuple:
    """Every rank's ``x`` (``[k_r, ...]``, ``k_r`` free per rank), stacked
    in one padded ``all_gather``: returns ``(every [P, max k, ...],
    counts)``, rank r's block being ``every[r, :counts[r]]``. ``counts``
    (every rank's ``k``, the same list on every rank) is gathered first
    when not given: one one-int ``all_gather`` and a host read (the parts
    of one process read each other's ``k`` off the shapes)."""
    if x.dtype == torch.bool:  # gloo has no bool: its bytes cross
        every, counts = gather_blocks(x.view(torch.uint8), counts, mesh)
        return every.view(torch.bool), counts
    if _group(mesh) is not None:
        every = _gather_in(mesh, "blocks", x)
        if counts is None:
            k = torch.tensor([x.shape[0]], dtype=torch.int64)
            counts = mesh.group.meet(mesh.rank, "gather", k).view(-1).tolist()
        return every, counts
    if counts is None:
        k = torch.tensor([x.shape[0]], dtype=torch.int64, device=x.device)
        counts = all_gather(k).view(-1).tolist()
    kmax = max(counts)
    if x.shape[0] < kmax:
        x = torch.cat([x, x.new_zeros((kmax - x.shape[0], *x.shape[1:]))])
    return all_gather(x), counts


def vote_all(flag: torch.Tensor, mesh=None) -> bool:
    """Whether every rank's ``flag`` (a one-element bool or int tensor) is
    set: the cohort's done vote, one one-int ``all_reduce``."""
    v = flag.reshape(1).to(torch.int32)
    return bool(int(all_reduce_min(v, mesh)[0]) != 0)


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


def to_host(x, axis: int | None = None, mesh=None) -> np.ndarray:
    """``x`` on this process's host. ``axis`` names a lane-placed leaf's
    lane axis: on a cohort (or over ``mesh``'s parts) the leaf is gathered
    over the ranks along it, each rank's block in rank order
    (:func:`gather_blocks`; collective, so every rank calls it in
    lockstep). A replicated leaf (``axis`` None) and any leaf outside a
    cohort is a local read."""
    if not isinstance(x, torch.Tensor):
        return np.asarray(x)
    if axis is None or (_group(mesh) is None and not is_multiprocess()):
        return x.detach().cpu().numpy()
    lead = x.detach().movedim(axis, 0).contiguous()
    every, counts = gather_blocks(lead, mesh=mesh)
    glob = torch.cat([every[r, :k] for r, k in enumerate(counts)])
    return glob.movedim(0, axis).cpu().numpy()
