"""The sim-plan API over torch: plans as batched per-tick state machines.

The port's counterpart of ``testground_tpu/sim/api.py``. The contract is
the same (a per-instance ``init`` and a per-tick ``step``; signals,
barriers, pub/sub and network reconfiguration through ``StepOut``), with
one difference of form: there is no ``vmap``. ``init`` and ``step`` are
called once per group per tick with **batched** tensors whose instance
axis is LAST, in the plane layout the reference engine's ``out_axes=-1``
produces (``engine.py:1156-1172``):

- ``env.global_seq`` / ``env.group_seq``: ``[n_g]`` int32
- ``inbox.payload [W, IN_MSGS, n_g]``, ``inbox.src / valid [IN_MSGS, n_g]``
- ``sync.last_seq [S, n_g]``, ``sync.sub_payload [T, SUB_K, PW, n_g]``,
  ``sync.sub_valid [T, SUB_K, n_g]``, ``sync.rejected [n_g]``; the global
  ``sync.counts [S]``, ``sync.dropped [T]`` and ``sync.live [G]``
- state: a dict of tensors with leading axis ``n_g``
- ``t``: a 0-d int32 tensor on the run's device

``StepOut`` fields left ``None`` take the engine's defaults, and fields may
be given at any shape that broadcasts to their plane (``[O, n_g]``,
``[S, n_g]``, ``[7, n_g]`` …), so a plan writes only what it drives.
"""

from __future__ import annotations

import dataclasses
from typing import Any, ClassVar

import torch

from . import prng

__all__ = [
    "CRASH",
    "FAILURE",
    "FILTER_ACCEPT",
    "FILTER_DROP",
    "FILTER_REJECT",
    "RUNNING",
    "SUCCESS",
    "GroupSpec",
    "Inbox",
    "Outbox",
    "SimEnv",
    "SimTestcase",
    "StepOut",
    "SyncView",
]

# Instance status codes (``pkg/runner/pretty.go:163-175``).
RUNNING = 0
SUCCESS = 1
FAILURE = 2
CRASH = 3

# Per-(src instance, dst region) routing filter actions
# (``pkg/sidecar/link.go:187-217``).
FILTER_ACCEPT = 0
FILTER_REJECT = 1
FILTER_DROP = 2


@dataclasses.dataclass(frozen=True)
class GroupSpec:
    """Static layout of one group on the instance axis."""

    id: str
    index: int
    offset: int  # first global instance index
    count: int
    params: dict[str, str]


@dataclasses.dataclass
class SimEnv:
    """The batched view of one group handed to ``init``/``step``.

    ``key`` is each instance's PRNG key for this tick (``[n_g, 2]``; the
    reference folds the tick into every instance key, ``engine.py:1106``).
    It is computed on first access only: neither network plan reads it, and
    at 100k instances it would be 100k threefry evaluations a tick.

    ``group_lanes`` is the group's length on the instance axis: every
    ``[n_g]`` tensor the plan gets or returns is that long, so a plan
    sizes its tensors with it. Under shape bucketing (``sim/buckets.py``)
    it is the padded count, and ``test_instance_count``, ``group.count``,
    ``group.offset`` (of every group) and ``global_seq`` are the exact
    layout's values as 0-d int32 tensors on the run's device — what the
    plan means by a count, never a Python int (the traced-count
    contract: a plan that reads one on the host gets ``plan.traced-int``
    from ``tg check --trace-plans``). Without bucketing they are Python
    ints and ``group_lanes == group.count``.
    """

    test_plan: str
    test_case: str
    test_run: str
    test_instance_count: int | torch.Tensor
    tick_ms: float
    groups: tuple[GroupSpec, ...]
    group: GroupSpec
    global_seq: torch.Tensor  # [n_g] int32
    group_seq: torch.Tensor  # [n_g] int32
    device: torch.device
    hosts: tuple = ()
    group_lanes: int | None = None
    # the group's root keys [n_g, 2] and the tick folded into them (None
    # at init: init sees the unfolded keys, as in the reference)
    base_keys: torch.Tensor | None = None
    tick: torch.Tensor | None = None
    _key: torch.Tensor | None = dataclasses.field(default=None, repr=False)

    def __post_init__(self):
        if self.group_lanes is None:
            self.group_lanes = int(self.group.count)

    @property
    def key(self) -> torch.Tensor:
        if self._key is None:
            self._key = (
                self.base_keys
                if self.tick is None
                else prng.fold_in(self.base_keys, self.tick)
            )
        return self._key

    def string_param(self, name: str) -> str:
        v = self.group.params.get(name)
        if v is None:
            raise KeyError(f"missing param: {name}")
        return v

    def int_param(self, name: str) -> int:
        return int(self.string_param(name))

    def float_param(self, name: str) -> float:
        return float(self.string_param(name))

    def bool_param(self, name: str) -> bool:
        return self.string_param(name).lower() in ("true", "1", "yes")

    def group_index_of(self, group_id: str) -> int:
        for g in self.groups:
            if g.id == group_id:
                return g.index
        raise KeyError(f"unknown group: {group_id}")

    def group_offset_of(self, group_id: str) -> int:
        return self.groups[self.group_index_of(group_id)].offset

    def ms_to_ticks(self, ms: float) -> int:
        """Convert simulated milliseconds to whole ticks (≥1)."""
        return max(1, round(ms / self.tick_ms))

    def host_index(self, name: str) -> int:
        """Data-plane address of an additional host: its lane past the
        instance axis. Raises if the run does not list it — the analog of
        a DNS failure for a host missing from ADDITIONAL_HOSTS."""
        if name not in self.hosts:
            raise KeyError(
                f"host {name!r} not in additional_hosts {list(self.hosts)}"
            )
        return self.test_instance_count + self.hosts.index(name)


@dataclasses.dataclass
class Inbox:
    """Messages arriving this tick: ``payload [W, IN_MSGS, n]`` int32
    (word-major), ``src [IN_MSGS, n]`` int32, ``valid [IN_MSGS, n]``."""

    payload: torch.Tensor
    src: torch.Tensor
    valid: torch.Tensor

    def word(self, w: int) -> torch.Tensor:
        """Payload word ``w`` across slots: ``[IN_MSGS, n]`` int32."""
        return self.payload[w]

    @property
    def count(self) -> torch.Tensor:
        return self.valid.sum(dim=0, dtype=torch.int32)


def _broadcast_len(*sizes: int) -> int:
    """The length 1-D planes of ``sizes`` broadcast to (1 with none), as
    ``torch.broadcast_shapes`` gives it, on the host without it: its first
    call imports sympy, seconds on a cold process."""
    n = max(sizes, default=1)
    for m in sizes:
        if m not in (1, n):
            raise RuntimeError(
                f"Shape mismatch: objects cannot be broadcast to a single "
                f"shape: sizes {sizes}"
            )
    return n


@dataclasses.dataclass
class Outbox:
    """Messages emitted this tick: ``dst [OUT_MSGS, n]`` int32 (global
    instance index), ``payload [OUT_MSGS, W, n]`` int32, ``valid
    [OUT_MSGS, n]`` bool."""

    dst: torch.Tensor
    payload: torch.Tensor
    valid: torch.Tensor

    @staticmethod
    def empty(out_msgs: int, msg_width: int, n: int, device) -> "Outbox":
        return Outbox(
            dst=torch.zeros((out_msgs, n), dtype=torch.int32, device=device),
            payload=torch.zeros(
                (out_msgs, msg_width, n), dtype=torch.int32, device=device
            ),
            valid=torch.zeros((out_msgs, n), dtype=torch.bool, device=device),
        )

    @staticmethod
    def single(dst, payload, valid, out_msgs: int, msg_width: int) -> "Outbox":
        """An outbox whose slot 0 carries one message per instance (the
        reference ``Outbox.single``): ``dst`` and ``valid`` are ``[n]``
        tensors or 0-d, ``payload`` the message's first words, ``[w]`` or
        ``[w, n]`` (zero-padded to ``msg_width``). A message uniform over
        the group (every field 0-d or ``[w]``) yields planes with an
        instance axis of 1, which the engine broadcasts."""
        dst = torch.as_tensor(dst)
        dev = dst.device
        valid = torch.as_tensor(valid, device=dev)
        # a list of Python words is filled in on the device (zeros, the
        # nonzero words filled), so a constant payload waits on no host copy
        words = None
        if isinstance(payload, (list, tuple)) and not any(
            isinstance(x, torch.Tensor) for x in payload
        ):
            words = payload
        else:
            pay = torch.as_tensor(payload, device=dev).to(torch.int32)
        n = _broadcast_len(
            dst.numel() if dst.dim() else 1,
            valid.numel() if valid.dim() else 1,
            pay.shape[1] if words is None and pay.dim() > 1 else 1,
        )
        ob = Outbox.empty(out_msgs, msg_width, n, dev)
        # slot 0 joined to the empty slots out of place, so that a run
        # pack's vmapped step (sim/pack.py) may hand in per-member values
        ob.dst = torch.cat([dst.to(torch.int32).broadcast_to((1, n)), ob.dst[1:]])
        if words is None:
            pay = (pay if pay.dim() > 1 else pay[:, None]).broadcast_to((pay.shape[0], n))
            row = torch.cat([pay, ob.payload[0, pay.shape[0]:]])
            ob.payload = torch.cat([row[None], ob.payload[1:]])
        else:
            if len(words) > msg_width:
                raise ValueError(
                    f"payload of {len(words)} words > MSG_WIDTH={msg_width}"
                )
            for w, v in enumerate(words):
                if v != 0:
                    ob.payload[0, w].fill_(int(v))
        ob.valid = torch.cat([valid.to(torch.bool).broadcast_to((1, n)), ob.valid[1:]])
        return ob


@dataclasses.dataclass
class SyncView:
    """Coordination state at tick start (shapes in the module docstring;
    semantics as the reference ``SyncView``)."""

    counts: torch.Tensor
    last_seq: torch.Tensor
    sub_payload: torch.Tensor
    sub_valid: torch.Tensor
    rejected: torch.Tensor
    dropped: torch.Tensor
    live: torch.Tensor


@dataclasses.dataclass
class StepOut:
    """Everything a step may do; ``None`` = the engine default (status
    RUNNING, nothing sent, signalled, published or reconfigured)."""

    state: Any
    status: Any = RUNNING
    outbox: Outbox | None = None
    signals: torch.Tensor | None = None  # [S, n] int32 0/1
    pub_payload: torch.Tensor | None = None  # [T, PW, n] int32
    pub_valid: torch.Tensor | None = None  # [T, n] bool
    sub_consume: torch.Tensor | None = None  # [T, n] int32
    net_shape: torch.Tensor | None = None  # [7, n] float32
    net_shape_valid: Any = False  # [n] bool
    net_filters: torch.Tensor | None = None  # [R, n] int32
    net_filters_valid: Any = False  # [n] bool
    net_rules: torch.Tensor | None = None  # [K, 3, n] int32
    net_rules_valid: Any = False  # [n] bool
    region: Any = None  # [n] int32
    region_valid: Any = False  # [n] bool


class SimTestcase:
    """Base class for sim testcases — the same class statics as the
    reference ``SimTestcase`` (``testground_tpu/sim/api.py:283``), which
    size every tensor of the run."""

    STATES: ClassVar[list[str]] = []
    TOPICS: ClassVar[list[str]] = []
    N_REGIONS: ClassVar[int] = 0
    FILTER_RULES: ClassVar[int] = 0
    MSG_WIDTH: ClassVar[int] = 4
    OUT_MSGS: ClassVar[int] = 1
    IN_MSGS: ClassVar[int] = 4
    PUB_WIDTH: ClassVar[int] = 4
    SUB_K: ClassVar[int] = 4
    TOPIC_CAP: ClassVar[int] = 256
    MAX_LINK_TICKS: ClassVar[int] = 256
    TRACK_SRC: ClassVar[bool] = True
    CROSS_TICK_STACKING: ClassVar[bool] = True
    SLOT_MODE: ClassVar[str] = "sorted"
    BW_QUEUE_MSGS: ClassVar[int] = 128
    SHAPING: ClassVar[tuple] = (
        "latency",
        "jitter",
        "bandwidth",
        "loss",
        "corrupt",
        "reorder",
        "duplicate",
        "filters",
    )
    DEFAULT_LINK: ClassVar[tuple[float, ...]] = (
        1.0,  # latency ms
        0.0,  # jitter ms
        0.0,  # bandwidth, bytes/s (0 = unlimited)
        0.0,  # loss %
        0.0,  # corrupt %
        0.0,  # reorder %
        0.0,  # duplicate %
    )

    @classmethod
    def specialize(
        cls, groups: tuple[GroupSpec, ...], tick_ms: float = 1.0
    ) -> type:
        """Hook: return a (possibly narrowed) testcase class for this run;
        never mutate ``cls`` (see the reference hook)."""
        return cls

    def state_id(self, name: str) -> int:
        return type(self).STATES.index(name)

    def topic_id(self, name: str) -> int:
        return type(self).TOPICS.index(name)

    def init(self, env: SimEnv) -> Any:
        """Initial state: a dict of ``[n_g]``-leading tensors."""
        return {}

    def step(
        self,
        env: SimEnv,
        state: Any,
        inbox: Inbox,
        sync: SyncView,
        t: torch.Tensor,
    ) -> StepOut:
        raise NotImplementedError

    def out(self, state: Any, **fields) -> StepOut:
        """Build a StepOut; unset fields take the engine defaults."""
        return StepOut(state=state, **fields)

    def signal(self, *names: str, when: torch.Tensor) -> torch.Tensor:
        """Signals plane ``[S, *when.shape]`` int32: the named states'
        rows are ``when`` (a bool/int tensor), the others 0. A 0-d
        ``when`` yields ``[S, 1]``, which broadcasts over the group."""
        w = when.to(torch.int32).reshape(-1)
        # built out of place, so that a run pack's vmapped step
        # (sim/pack.py) may hand in a per-member ``when``
        rows = {self.state_id(name) for name in names}
        zero = torch.zeros(w.shape[0], dtype=torch.int32, device=w.device)
        return torch.stack([w if i in rows else zero
                            for i in range(len(type(self).STATES))])

    def device_constant(self, values, dtype, device) -> torch.Tensor:
        """``torch.tensor(values, dtype=dtype, device=device)`` built on the
        first call with these arguments and reused (``values`` hashable: a
        number or a tuple). A step that made it every tick would copy host
        data to the device, and wait, every tick. Consumers never write
        into it."""
        cache = self.__dict__.setdefault("_device_constants", {})
        key = (values, dtype, torch.device(device))
        if key not in cache:
            cache[key] = torch.tensor(values, dtype=dtype, device=device)
        return cache[key]

    def link_shape(
        self,
        latency_ms=0.0,
        jitter_ms=0.0,
        bandwidth=0.0,
        loss=0.0,
        corrupt=0.0,
        reorder=0.0,
        duplicate=0.0,
        *,
        device,
    ) -> torch.Tensor:
        """A LinkShape plane (``network.LinkShape`` field order,
        ``pkg/sidecar/link.go:155-183``): ``[7]`` for scalars, ``[7, n]``
        when any field is an ``[n]`` tensor. float32, like the reference.
        An all-scalar shape is a :meth:`device_constant`; a mixed shape is
        built on the device (zeros, the tensor fields copied in, nonzero
        scalars filled), so a shape that varies per tick waits on no host
        copy."""
        fields = (latency_ms, jitter_ms, bandwidth, loss, corrupt, reorder, duplicate)
        tensors = [x for x in fields if isinstance(x, torch.Tensor)]
        if not tensors:
            return self.device_constant(fields, torch.float32, device)
        # the ATen op: torch.broadcast_shapes imports sympy on first use
        shape = torch.broadcast_tensors(*tensors)[0].shape
        dev = tensors[0].device
        # stacked out of place, so that a run pack's vmapped step
        # (sim/pack.py) may hand in per-member fields
        zero = torch.zeros(shape, dtype=torch.float32, device=dev)
        return torch.stack([
            x.to(torch.float32).broadcast_to(shape) if isinstance(x, torch.Tensor)
            else torch.full(shape, float(x), dtype=torch.float32, device=dev)
            if x != 0 else zero
            for x in fields
        ])

    def filter_rules(self, *rules) -> torch.Tensor:
        """A ``[FILTER_RULES, 3, n]`` rule-list plane for
        ``StepOut.net_rules`` (the reference ``filter_rules``): each rule is
        ``(start, end, action)``, ints or ``[n]`` tensors, applying to sends
        whose dst lies in ``[start, end)``; first match wins, unmatched
        sends are accepted. Unused tail rules are the never-matching (0, 0,
        Accept). All-scalar rules give an instance axis of 1."""
        k = type(self).FILTER_RULES
        if len(rules) > k:
            raise ValueError(
                f"{len(rules)} rules > FILTER_RULES={k}; raise the declaration"
            )
        dev = next(
            (x.device for r in rules for x in r if isinstance(x, torch.Tensor)),
            torch.device("cpu"),
        )
        # built on the device: the tensor fields copied in, nonzero scalars
        # filled, so a rule list with scalar fields waits on no host copy
        n = _broadcast_len(
            *(x.numel() for r in rules for x in r if isinstance(x, torch.Tensor))
        )
        # stacked out of place, so that a run pack's vmapped step
        # (sim/pack.py) may hand in per-member fields
        zero = torch.zeros(n, dtype=torch.int32, device=dev)
        cells = [zero] * (k * 3)
        for i, rule in enumerate(rules):
            for j, x in enumerate(rule):
                if isinstance(x, torch.Tensor):
                    cells[i * 3 + j] = x.to(torch.int32).reshape(-1).broadcast_to((n,))
                elif x != 0:
                    cells[i * 3 + j] = torch.full((n,), int(x), dtype=torch.int32,
                                                  device=dev)
        return torch.stack(cells).view(k, 3, n)
