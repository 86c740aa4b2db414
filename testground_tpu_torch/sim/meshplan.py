"""The mesh of peer shards, and the one partition rule table.

Port of ``testground_tpu/sim/meshplan.py``. The instance (lane) axis is
cut into ``S`` equal contiguous shards on the mesh axis ``"i"``; shard
``s`` holds lanes ``[s·n_loc, (s+1)·n_loc)``. The rule table
(:data:`DEFAULT_RULES`, regex on a logical carry path → a
:class:`PartitionSpec`) is the reference's, entry for entry, so the
journal's ``sim.mesh`` block and every placement query answer as there.

What a :class:`TorchMesh` is: one torch device per mesh cell, row-major
over ``(runs, i)`` — a 1-D mesh is one row of peer shards, a 2-D ``"RxP"``
mesh is R rows of P. A device may repeat: consecutive shards of a row on
the same device form one *part*, whose calendar planes are held as one
``[S_d, L, SLOTS·n_loc]`` tensor and committed and popped by one kernel
launch. A mesh whose cells all sit on one device is a *virtual* mesh —
the port's analog of the reference's ``xla_force_host_platform_device_count``
— and is how the sharded path runs on the CPU and on a single card.

Which devices :func:`make_mesh` gives:

- an explicit ``devices=`` list, taken as it is (repeats allowed);
- on CUDA, the visible cards, one per cell, under the reference's rule: a
  shape needs that many cards, or it refuses with the reference's message;
- on the CPU (``device="cpu"``), every cell on the CPU.

Where the carry lives. A mesh of one part (a virtual mesh on one device,
or a pack's sub-shard calendar) splits only the calendar's planes per
shard; every other carry leaf stays on the mesh's primary device (part
0's). A mesh of several parts places the carry, and so does a *cohort*
mesh (``sim/distributed.global_mesh``), which spans processes: ``ranks``
names each cell's owner — a process of the cohort, or a part of a
several-part mesh in one process (:meth:`TorchMesh.part_view`) — and
``parts`` lists only the owner's cells. The owner holds only its own lanes
(:meth:`TorchMesh.own_lanes`) of every leaf :meth:`MeshPlan.lane_axis`
names — the table's lane-split paths, and the plan states, the keys and
the sync service's per-instance planes, which the reference's table
leaves to GSPMD's propagation — on its device, and one replica of the
others; ``primary`` is its device. The owners meet at the tick's
collectives: over ``torch.distributed`` in a cohort, over the mesh's
in-process ``group`` (``distributed.PartGroup``) for the parts of one
process. Every count of the mesh (``size``, ``shards``,
:func:`peer_shards`, :func:`layout_str`) is the global one. A solo run on
a 2-D mesh splits its lanes over row 0's peer shards (:meth:`TorchMesh.row`),
as the reference shards ``i`` and replicates over ``runs``. A run pack's
members split into the rows in contiguous groups, and each member's lanes
over its row's peer shards (``sim/pack.py``); on a mesh of several parts
each part holds its row's members' own lanes (:func:`pack_parts`, the
reference's ``constrain_carry(lead="runs")``).
"""

from __future__ import annotations

import dataclasses
import math
import re
from collections.abc import Mapping
from typing import Any, Sequence

import torch

__all__ = [
    "DEFAULT_RULES",
    "MeshPlan",
    "PLACED_BEYOND_RULES",
    "PackPart",
    "PartitionSpec",
    "TorchMesh",
    "cross_shard_bytes_est",
    "indivisible_counts",
    "layout_str",
    "make_mesh",
    "mesh_axis_names",
    "pack_owners",
    "pack_parts",
    "parse_mesh_shape",
    "peer_shards",
    "plan_for",
]


class PartitionSpec(tuple):
    """Which mesh axis each array axis is split over (None: not split) —
    ``jax.sharding.PartitionSpec`` as a plain tuple: ``P(None, "i")``."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec

# The reference's rule table (meshplan.py:64-78). First match wins; paths
# are the engine's logical carry-plane names.
DEFAULT_RULES: tuple[tuple[str, str, PartitionSpec], ...] = (
    # per-lane status rows: [N_lanes]
    ("instance-rows", r"^(status|finished_at|rejected)$", P("i")),
    # calendar planes: [L, slots*N] (payload tuple members included)
    ("calendar-planes", r"^cal\.(payload(\.\d+)?|src|valid|etick)$", P(None, "i")),
    # link lane planes: [E, N] egress targets / filters
    ("link-lane-planes", r"^link\.(egress|filters)$", P(None, "i")),
    # link per-node rows: [N]
    ("link-node-rows", r"^link\.(region_of|backlog)$", P("i")),
    # link shaping rules: [R, F, N]
    ("link-rules", r"^link\.rules$", P(None, None, "i")),
    # everything else is replicated
    ("replicated", r".*", P()),
)

# the leaves a cohort places besides the table's lane-split paths, with
# their lane axis: the plan states' [n_g, ...] leaves, the per-instance
# keys [N, 2] and the sync service's [S, N] / [T, N] per-instance planes
PLACED_BEYOND_RULES: tuple[tuple[str, int], ...] = (
    (r"^states\.\d+\..+$", 0),
    (r"^keys$", 0),
    (r"^sync\.(last_seq|cursors)$", 1),
)


def parse_mesh_shape(text: str) -> tuple[int, ...]:
    """``"4"`` → ``(4,)``; ``"2x4"`` → ``(2, 4)``. 1-D is (peers,); 2-D is
    (runs, peers). Anything else refuses, with the reference's messages."""
    parts = str(text).lower().replace("×", "x").split("x")
    try:
        dims = tuple(int(p) for p in parts)
    except ValueError:
        raise ValueError(
            f"mesh shape {text!r} is not N or AxB (e.g. '4' or '2x4')"
        ) from None
    if not (1 <= len(dims) <= 2) or any(d < 1 for d in dims):
        raise ValueError(
            f"mesh shape {text!r} must be 1-D (peers) or 2-D (runs x peers) "
            "with positive extents"
        )
    return dims


def mesh_axis_names(ndim: int) -> tuple[str, ...]:
    return ("i",) if ndim == 1 else ("runs", "i")


@dataclasses.dataclass(frozen=True)
class TorchMesh:
    """A 1-D ``("i",)`` mesh (``runs`` None): ``devices[s]`` holds peer
    shard ``s``; or a 2-D ``("runs", "i")`` mesh of ``runs`` rows: the
    devices row-major, ``devices[g·P + s]`` holding row g's shard s.

    ``parts`` lists ``(device, s0, s1)`` over the flat cells: cells ``[s0,
    s1)`` held in one tensor per plane on ``device``, never across a row.
    By default each run of consecutive equal devices in a row is one part;
    an explicit ``parts`` may cut a device's run finer (one tensor per part
    all the same), which lets the CPU tests drive the several-part path.

    A cohort mesh gives ``ranks`` (cell s belongs to owner ``ranks[s]``)
    and the owner's ``rank``: its parts are its own cells only. The owners
    are a cohort's processes, or with ``group`` (a
    ``distributed.PartGroup``) the parts of one process's several-part
    mesh, each stepped by a thread of its own (:meth:`part_view`)."""

    devices: tuple
    parts: tuple | None = None
    runs: int | None = None
    ranks: tuple | None = None
    rank: int = 0
    group: Any = dataclasses.field(default=None, compare=False, repr=False)

    def __post_init__(self):
        devs = tuple(_indexed(d) for d in self.devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        object.__setattr__(self, "devices", devs)
        rows = 1 if self.runs is None else int(self.runs)
        if rows < 1 or len(devs) % rows:
            raise ValueError(f"{len(devs)} devices do not make {rows} mesh rows")
        width = len(devs) // rows
        owner = (0,) * len(devs) if self.ranks is None else tuple(self.ranks)
        if len(owner) != len(devs):
            raise ValueError(f"{len(owner)} ranks for {len(devs)} mesh cells")
        if self.parts is None:
            parts, s0 = [], 0
            for s in range(1, len(devs) + 1):
                if (s == len(devs) or s % width == 0 or devs[s] != devs[s0]
                        or owner[s] != owner[s0]):
                    if owner[s0] == self.rank:
                        parts.append((devs[s0], s0, s))
                    s0 = s
            if not parts:
                raise ValueError(f"rank {self.rank} holds no cell of the mesh")
        else:
            parts = [(_indexed(d), int(a), int(b)) for d, a, b in self.parts]
            if (
                [a for _, a, _ in parts] != [0] + [b for _, _, b in parts[:-1]]
                or parts[-1][2] != len(devs)
                or any(a >= b for _, a, b in parts)
            ):
                raise ValueError(f"mesh parts {self.parts} do not tile {len(devs)} shards")
            for d, a, b in parts:
                if any(x != d for x in devs[a:b]) or a // width != (b - 1) // width:
                    raise ValueError(f"mesh part {(d, a, b)} spans other devices")
        object.__setattr__(self, "parts", tuple(parts))

    @property
    def axis_names(self) -> tuple[str, ...]:
        return mesh_axis_names(1 if self.runs is None else 2)

    @property
    def shape(self) -> dict[str, int]:
        if self.runs is None:
            return {"i": len(self.devices)}
        return {"runs": int(self.runs), "i": len(self.devices) // int(self.runs)}

    @property
    def size(self) -> int:
        """Every cell of the mesh (a 1-D mesh: its peer shards)."""
        return len(self.devices)

    @property
    def shards(self) -> int:
        """Extent of the peer (``i``) axis."""
        return self.shape["i"]

    @property
    def primary(self) -> torch.device:
        """Part 0's device: where a mesh of one part keeps every leaf but
        the calendar, and where a cohort's or a part view's owner keeps its
        own."""
        return self.parts[0][0]

    @property
    def cohort(self) -> bool:
        """Whether the cells belong to several owners, each holding its
        own lanes: a cohort's processes (``sim/distributed.py``), or the
        parts of a :meth:`part_view`."""
        return self.ranks is not None

    def own_lanes(self, n_lanes: int) -> tuple[int, int]:
        """This owner's lanes ``[lo, hi)`` of an ``n_lanes`` lane axis cut
        over the mesh's cells: its parts' cells, which an owner keeps
        contiguous (all of them without owners)."""
        n_loc = n_lanes // self.size
        return self.parts[0][1] * n_loc, self.parts[-1][2] * n_loc

    def rank_lanes(self, n_lanes: int) -> tuple[tuple[int, int], ...]:
        """Every owner's lanes ``[lo, hi)`` of an ``n_lanes`` lane axis, in
        rank order (one owner, all of them, without ``ranks``)."""
        n_loc = n_lanes // self.size
        span: dict = {}
        for s, r in enumerate(self.ranks or (0,) * self.size):
            lo, hi = span.get(r, (s, s + 1))
            span[r] = (min(lo, s), max(hi, s + 1))
        return tuple((span[r][0] * n_loc, span[r][1] * n_loc) for r in sorted(span))

    def part_view(self, p: int, group) -> "TorchMesh":
        """Part ``p`` of this one-process mesh as the owner of its own
        cells: the same cells, each part an owner, ``p`` this one, and the
        parts meeting at their collectives through ``group``."""
        owner = [0] * self.size
        for i, (_, s0, s1) in enumerate(self.parts):
            owner[s0:s1] = [i] * (s1 - s0)
        return TorchMesh(self.devices, runs=self.runs, ranks=tuple(owner), rank=p,
                         group=group)

    def row(self, g: int) -> "TorchMesh":
        """Row ``g``'s peer shards as a 1-D mesh, its parts kept."""
        if self.runs is None:
            if g != 0:
                raise IndexError(f"a 1-D mesh has one row, not row {g}")
            return self
        p = self.shards
        lo, hi = g * p, (g + 1) * p
        return TorchMesh(
            self.devices[lo:hi],
            parts=tuple((d, a - lo, b - lo) for d, a, b in self.parts if lo <= a < hi),
        )

    def on(self, device) -> "TorchMesh":
        """The same shape with every cell on ``device`` (one part a row), in
        this process: a cohort mesh's every cell."""
        return TorchMesh((torch.device(device),) * self.size, runs=self.runs)


def _indexed(device) -> torch.device:
    """``device`` with its card's index: ``"cuda"`` is the current card,
    as a tensor made there reports it."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def _visible_cards() -> list[torch.device]:
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: a mesh runs on the GPU unless the caller "
            "passes device='cpu' or an explicit devices list"
        )
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(
    shape: Sequence[int] | str | int | None = None,
    *,
    devices: Sequence[Any] | None = None,
    device=None,
) -> TorchMesh | None:
    """Build the peers mesh, or None for a single shard.

    With ``shape=None`` every device of the pool lands on a 1-D mesh (the
    reference's ``shard=true``); on the CPU that pool is one device, so the
    answer is None. An explicit shape (``"4"``, or ``"2x4"`` for 2 rows of
    4 peer shards) takes the first ``prod(shape)``
    devices of ``devices`` (which may repeat one device: a virtual mesh),
    or of the visible cards (``device`` None or CUDA; the reference's
    rule and message), or that many copies of a non-CUDA ``device``."""
    if isinstance(shape, str):
        shape = parse_mesh_shape(shape)
    elif isinstance(shape, int):
        # `--run-cfg mesh=4` coalesces as a bare int
        shape = (int(shape),)
    virtual = None
    if devices is not None:
        devs = [torch.device(d) for d in devices]
    elif device is not None and torch.device(device).type != "cuda":
        virtual = torch.device(device)
        devs = [virtual]
    else:
        devs = _visible_cards()
    if shape is None:
        return None if len(devs) <= 1 else TorchMesh(tuple(devs))
    shape = tuple(int(d) for d in shape)
    need = math.prod(shape)
    if need == 1:
        return None
    runs = shape[0] if len(shape) == 2 else None
    if virtual is not None:
        return TorchMesh((virtual,) * need, runs=runs)
    if need > len(devs):
        raise ValueError(
            f"mesh shape {shape} needs {need} devices, "
            f"only {len(devs)} visible"
        )
    return TorchMesh(tuple(devs[:need]), runs=runs)


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    """A mesh plus the partition-rule table resolved against it;
    :meth:`spec_for` is the one placement query."""

    mesh: Any
    rules: tuple[tuple[str, str, PartitionSpec], ...] = DEFAULT_RULES

    @property
    def shards(self) -> int:
        """Extent of the instance (``i``) axis."""
        return int(self.mesh.shape["i"])

    @property
    def runs(self) -> int:
        """Extent of the pack run axis (1 when the mesh is 1-D)."""
        return int(self.mesh.shape.get("runs", 1))

    @property
    def devices(self) -> int:
        return _device_count(self.mesh)

    def spec_for(
        self, path: str, *, lead: str | None = None, ndim: int | None = None
    ) -> PartitionSpec:
        """Resolve a logical carry path to its spec (``meshplan.py:165-197``):
        ``lead`` prepends the stacked run axis (mapped to ``runs`` when the
        mesh has one, else replicated); ``ndim`` keeps the leading entries
        at the leaf's rank."""
        for _name, pat, spec in self.rules:
            if re.match(pat, path):
                break
        else:  # unreachable: DEFAULT_RULES ends in a match-all
            spec = P()
        if lead is not None:
            lead_axis = lead if lead in self.mesh.shape else None
            spec = P(lead_axis, *tuple(spec))
        if ndim is not None and len(tuple(spec)) > ndim:
            spec = P(*tuple(spec)[:ndim])
        return spec

    def lane_axis(self, path: str, lead: str | None = None) -> int | None:
        """The axis of the carry leaf at ``path`` that a cohort places over
        its ranks (None: replicated): the table's ``"i"`` entry, else the
        plan states, keys and sync lane planes
        (:data:`PLACED_BEYOND_RULES`). The one placement query of a
        cohort's carry. ``lead="runs"`` asks for a run pack's carry
        (``sim/pack.py``): its lane leaves lay the members side by side on
        the same axis, and its plan states stack them on a leading run axis,
        so a state leaf's lanes move one axis in."""
        spec = tuple(self.spec_for(path))
        if "i" in spec:
            return spec.index("i")
        for pat, axis in PLACED_BEYOND_RULES:
            if re.match(pat, path):
                return axis + (lead is not None and path.startswith("states."))
        return None

    def layout_table(self) -> list[dict[str, str]]:
        """The rule table in journal form."""
        return [
            {"rule": name, "path": pat, "spec": _spec_str(spec)}
            for name, pat, spec in self.rules
        ]


@dataclasses.dataclass(frozen=True)
class PackPart:
    """One part of a run pack's mesh of several parts that holds members:
    on ``device``, row ``row``'s members ``[first, first + runs)``, and of
    each of them peer shards ``[s0, s1)``, that is lanes ``[s0·n_loc,
    s1·n_loc)``."""

    device: torch.device
    row: int
    first: int
    runs: int
    s0: int
    s1: int


def pack_parts(mesh: TorchMesh, width: int) -> tuple[PackPart, ...]:
    """The owners of a pack of ``width`` members on a mesh of several parts
    (the reference's ``constrain_carry(lead="runs")``): the members split
    into the rows in contiguous groups of ``ceil(width / rows)``, and each
    part of a row holds its peer shards of that row's every member. A part
    whose row holds no member (a width below the rows) holds nothing and is
    left out."""
    p = mesh.shards
    per_row = -(-width // mesh.shape.get("runs", 1))
    out = []
    for dev, c0, c1 in mesh.parts:
        g = c0 // p
        first = g * per_row
        runs = min(per_row, width - first)
        if runs > 0:
            out.append(PackPart(dev, g, first, runs, c0 - g * p, c1 - g * p))
    return tuple(out)


def pack_owners(parts: Sequence[PackPart], width: int, shards: int):
    """The (member, peer shard) → owning part table of :func:`pack_parts`,
    a ``[width, shards]`` list of lists."""
    out = [[-1] * shards for _ in range(width)]
    for i, q in enumerate(parts):
        for r in range(q.first, q.first + q.runs):
            out[r][q.s0 : q.s1] = [i] * (q.s1 - q.s0)
    return out


def _spec_str(spec: PartitionSpec) -> str:
    parts = []
    for ax in tuple(spec):
        if ax is None:
            parts.append("-")
        elif isinstance(ax, (tuple, list)):
            parts.append("+".join(str(a) for a in ax))
        else:
            parts.append(str(ax))
    return "(" + ",".join(parts) + ")" if parts else "replicated"


def _device_count(mesh: Any) -> int:
    devs = mesh.devices
    size = getattr(devs, "size", None)
    return int(size) if isinstance(size, int) else len(devs)


def plan_for(mesh) -> MeshPlan | None:
    return None if mesh is None else MeshPlan(mesh)


def layout_str(mesh) -> str:
    """Canonical mesh layout key: ``"1"`` single device, ``"4"`` 1-D,
    ``"2x4"`` 2-D."""
    if mesh is None:
        return "1"
    shape = getattr(mesh, "shape", None)
    if not isinstance(shape, Mapping):  # a device-count stand-in
        return str(_device_count(mesh))
    if "runs" in shape:
        return f"{int(shape['runs'])}x{int(shape['i'])}"
    return str(int(shape["i"]))


def peer_shards(mesh: Any) -> int:
    """Extent of the instance (``i``) axis; a stand-in exposing only its
    devices counts them."""
    if mesh is None:
        return 1
    shape = getattr(mesh, "shape", None)
    if isinstance(shape, Mapping) and "i" in shape:
        return int(shape["i"])
    return _device_count(mesh)


def indivisible_counts(counts: Sequence[int], shards: int) -> tuple[int, ...]:
    """The counts that do NOT divide across ``shards`` peer shards — empty
    means the layout is supported."""
    return tuple(int(c) for c in counts if int(c) % int(shards) != 0)


def cross_shard_bytes_est(
    *, stream_bytes: int, shards: int, payload_bytes_per_msg: int = 0
) -> int:
    """Modeled per-commit exchange traffic of the sharded commit: each
    shard receives the ``(shards-1)/shards`` of the sorted stream it does
    not hold (``meshplan.py:268-284``)."""
    if shards <= 1:
        return 0
    del payload_bytes_per_msg  # itemization handled by callers
    return int(stream_bytes) * (int(shards) - 1) // int(shards)
