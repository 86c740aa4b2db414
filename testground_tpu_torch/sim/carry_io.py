"""Carry a run's state across packages: numpy leaves under dotted paths.

The simulator has no weights; what a run carries is its ``SimCarry``. A
carry flattened to numpy under dotted leaf paths (``cal.src``,
``cal.payload.0``, ``cal.etick``, ``link.egress``, ``link.backlog``,
``link.rules``, ``sync.counts``, ``states.0.phase``, ``keys``, ``net_key``,
``msgs_sent``, ``lat_hist``, ``live_counts``, ``net_mat``,
``net_bw_hiwater`` …) is the
exchange format: the JAX
package's carry, flattened on its side, starts a port run from the same
mid-run state (:func:`carry_from_numpy`), and :func:`carry_to_numpy`
flattens a port carry the same way so two carries compare leaf by leaf.

Converted on the way in:

- the reference xla path's FLAT ``[L·N·SLOTS]`` calendar planes →
  ``[L, N·SLOTS]`` (on a mesh, cut into the shards' planes, and joined
  back on the way out: the exchange format is always the global layout);
- 2-limb int32 flow totals ``(hi, lo)`` with a 30-bit spill
  (``engine.py:114-131``) → int64;
- raw uint32 key data → the port's int64-held uint32 words (the link key
  → two host ints).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .engine import SimCarry, SimProgram
from .net import Calendar, LinkState, from_shards, to_shards
from .sync_kernel import SyncState

__all__ = ["carry_from_numpy", "carry_to_numpy"]

_LIMB_BITS = 30
_TOTALS = (
    "msgs_delivered",
    "msgs_sent",
    "msgs_enqueued",
    "msgs_dropped",
    "msgs_rejected",
    "fault_dropped",
)
_SCALARS = (
    "t",
    "clamped",
    "bw_dropped",
    "bw_rate_changed",
    "collisions",
    "cal_depth",
    "faults_crashed",
    "faults_restarted",
)
# the observability planes' leaves and shape bucketing's live counts
# (None when the plane is off, or the run is not bucketed)
_PLANES = (("lat_hist", torch.int32), ("live_counts", torch.int32),
           ("net_mat", torch.int32), ("net_bw_hiwater", torch.float32))


def _total(a: np.ndarray) -> int:
    a = np.asarray(a)
    if a.shape == (2,):  # (hi, lo) limb pair
        return (int(a[0]) << _LIMB_BITS) + int(a[1])
    return int(a)


def carry_from_numpy(arrays: dict[str, np.ndarray], prog: SimProgram) -> SimCarry:
    """Build a port carry on ``prog.device`` from numpy leaves keyed by
    dotted path (see the module docstring)."""
    dev = prog.device

    def t_(key, dtype=None):
        x = torch.from_numpy(np.array(arrays[key]))  # a private, writable copy
        return x.to(device=dev, dtype=dtype) if dtype else x.to(dev)

    cls = type(prog.tc)
    horizon = cls.MAX_LINK_TICKS
    ns = prog.n_lanes * cls.IN_MSGS  # host lanes included

    def plane(key, dtype):
        x = t_(key, dtype).reshape(horizon, ns).contiguous()
        return x if prog.mesh is None else to_shards(x, prog.mesh, cls.IN_MSGS)

    width = sum(1 for k in arrays if k.startswith("cal.payload."))
    cal = Calendar(
        payload=tuple(
            plane(f"cal.payload.{w}", torch.int32) for w in range(width)
        ),
        src=plane("cal.src", torch.int32) if "cal.src" in arrays else None,
        valid=plane("cal.valid", torch.bool) if "cal.valid" in arrays else None,
        etick=plane("cal.etick", torch.int32) if "cal.etick" in arrays else None,
        slots=cls.IN_MSGS,
        mesh=prog.mesh,
    )
    states = []
    for gi in range(len(prog.groups)):
        prefix = f"states.{gi}."
        states.append(
            {k[len(prefix):]: t_(k) for k in sorted(arrays) if k.startswith(prefix)}
        )
    i64 = torch.int64
    return SimCarry(
        states=tuple(states),
        status=t_("status", torch.int32),
        finished_at=t_("finished_at", torch.int32),
        cal=cal,
        link=LinkState(
            egress=t_("link.egress", torch.float32),
            filters=t_("link.filters", torch.int32),
            region_of=t_("link.region_of", torch.int32),
            backlog=(
                t_("link.backlog", torch.float32) if "link.backlog" in arrays else None
            ),
            rules=t_("link.rules", torch.int32) if "link.rules" in arrays else None,
        ),
        sync=SyncState(
            **{
                f.name: t_(f"sync.{f.name}", torch.int32)
                for f in dataclasses.fields(SyncState)
            }
        ),
        rejected=t_("rejected", torch.int32),
        keys=torch.from_numpy(np.asarray(arrays["keys"]).astype(np.int64)).to(dev),
        net_key=tuple(int(x) for x in np.asarray(arrays["net_key"]).reshape(-1)),
        collision_where=t_("collision_where", torch.int32),
        **{k: t_(k, torch.int32).reshape(()) for k in _SCALARS},
        **{
            k: torch.tensor(_total(arrays[k]), dtype=i64, device=dev)
            for k in _TOTALS
        },
        **{k: t_(k, dtype) if k in arrays else None for k, dtype in _PLANES},
    )


def carry_to_numpy(carry: SimCarry) -> dict[str, np.ndarray]:
    """Flatten a port carry to numpy leaves under the same dotted paths
    (calendar planes 2-D ``[L, N·SLOTS]``, a meshed calendar's shards
    joined; totals as int64 scalars, keys as uint32)."""
    out: dict[str, np.ndarray] = {}

    def host(x):
        return x.detach().cpu().numpy()

    for gi, s in enumerate(carry.states):
        for k, v in s.items():
            out[f"states.{gi}.{k}"] = host(v)
    cal = carry.cal

    def plane(x):
        return host(x if cal.mesh is None else from_shards(x, cal.slots, "cpu"))

    for w, p in enumerate(cal.payload):
        out[f"cal.payload.{w}"] = plane(p)
    for name in ("src", "valid", "etick"):
        if getattr(cal, name) is not None:
            out[f"cal.{name}"] = plane(getattr(cal, name))
    for f in dataclasses.fields(carry.link):
        if getattr(carry.link, f.name) is not None:
            out[f"link.{f.name}"] = host(getattr(carry.link, f.name))
    for f in dataclasses.fields(SyncState):
        out[f"sync.{f.name}"] = host(getattr(carry.sync, f.name))
    out["keys"] = host(carry.keys).astype(np.uint32)
    out["net_key"] = np.asarray(carry.net_key, dtype=np.uint32)
    for k in ("status", "finished_at", "rejected", "collision_where",
              *_SCALARS, *_TOTALS):
        out[k] = host(getattr(carry, k))
    for k, _ in _PLANES:
        if getattr(carry, k) is not None:
            out[k] = host(getattr(carry, k))
    return out
