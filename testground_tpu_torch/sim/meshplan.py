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

Only the calendar planes are split per shard; every other carry leaf stays
on the mesh's primary device (cell 0's), whatever the table says about
it. A *cohort* mesh (``sim/distributed.global_mesh``) spans processes:
``ranks`` names each cell's process, ``parts`` lists only this process's
cells, and ``primary`` is this process's device, where it keeps its own
replica of every other leaf. Every count of the mesh (``size``,
``shards``, :func:`peer_shards`, :func:`layout_str`) is the global one. A solo run on a 2-D mesh splits its lanes over row 0's peer shards
(:meth:`TorchMesh.row`), as the reference shards ``i`` and replicates over
``runs``. A run pack's members split into the rows in contiguous groups,
and each member's lanes over its row's peer shards (``sim/pack.py``).
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
    "PartitionSpec",
    "TorchMesh",
    "cross_shard_bytes_est",
    "indivisible_counts",
    "layout_str",
    "make_mesh",
    "mesh_axis_names",
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

    A cohort mesh gives ``ranks`` (cell s belongs to process ``ranks[s]``)
    and this process's ``rank``: its parts are its own cells only."""

    devices: tuple
    parts: tuple | None = None
    runs: int | None = None
    ranks: tuple | None = None
    rank: int = 0

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
        """This process's first cell's device (cell 0's outside a cohort):
        where every leaf but the calendar lives."""
        return self.parts[0][0]

    @property
    def cohort(self) -> bool:
        """Whether the cells span processes (``sim/distributed.py``)."""
        return self.ranks is not None

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

    def layout_table(self) -> list[dict[str, str]]:
        """The rule table in journal form."""
        return [
            {"rule": name, "path": pat, "spec": _spec_str(spec)}
            for name, pat, spec in self.rules
        ]


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
