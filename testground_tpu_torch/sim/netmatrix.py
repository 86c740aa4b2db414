"""The network-topology plane's host half: traffic-matrix schema,
conservation checks, top-K pair selection, and the ``tg netmap`` cut
advisor.

The port's copy of ``testground_tpu/sim/netmatrix.py``, line for line
(stdlib + numpy). The device half lives in the port's engine: a
``[NM_CHANNELS, GH, GH]`` int32 src-group × dst-group counter matrix rides
the carry (``SimCarry.net_mat``; GH = declared groups + one hosts row when
additional hosts are attached) and is flushed once per chunk beside the
telemetry block, with no host wait of its own; with the plane off the tick
runs exactly the ops it ran before the plane existed.

Channel semantics mirror the flow-conservation identity the telemetry
plane already pins, now CELL-WISE: per (src group, dst group) pair,
``sent = enqueued + dropped + rejected + fault_dropped`` at send time,
and cumulatively ``sent = delivered + in-flight + dropped + rejected +
fault_dropped``. Attribution rules (each kept exact so the sums close):

- send-side channels charge the (sender group, PHYSICAL destination
  group) cell; a message to an out-of-range destination is charged to
  the clipped lane's group (the same sent-then-dropped accounting the
  scalar counters apply);
- ``delivered`` charges the (calendar provenance, receiver lane) cell —
  host echo deliveries land in the hosts row/column, so the matrix total
  equals the engine's ``msgs_delivered`` exactly;
- crash purges charge ``fault_dropped`` at the (sender, crashed
  receiver) cell (``net.purge_dst_matrix`` recovers the sender from the
  occupancy plane's src+1 encoding).
"""

from __future__ import annotations

import itertools
import json
import math

import numpy as np

__all__ = [
    "NM_CHANNELS",
    "NM_CHANNEL_NAMES",
    "NM_DELIVERED",
    "NM_DROPPED",
    "NM_ENQUEUED",
    "NM_FAULT",
    "NM_MSG_BYTES",
    "NM_REJECTED",
    "NM_SENT",
    "cut_advisor",
    "delta_cells",
    "delta_row",
    "faulted_pairs",
    "matrix_bytes",
    "matrix_from_rows",
    "matrix_totals",
    "reconcile",
    "top_pairs",
]

# Channel order of the device matrix's leading axis — fixed schema, the
# jsonl cell rows and every host surface use the same order.
NM_SENT, NM_ENQUEUED, NM_DELIVERED, NM_DROPPED, NM_REJECTED, NM_FAULT = (
    range(6)
)
NM_CHANNELS = 6
NM_CHANNEL_NAMES = (
    "sent",
    "enqueued",
    "delivered",
    "dropped",
    "rejected",
    "fault_dropped",
)

# Wire size per message for the bytes view — MUST equal net.MSG_BYTES
# (pinned by tests; duplicated here so this module stays jax-free).
NM_MSG_BYTES = 256

# matrix channel → the engine's cumulative flow-total key it must sum
# back to, exactly (journal ``sim.telemetry.totals`` / results keys)
_FLOW_KEYS = (
    ("sent", "msgs_sent"),
    ("enqueued", "msgs_enqueued"),
    ("delivered", "msgs_delivered"),
    ("dropped", "msgs_dropped"),
    ("rejected", "msgs_rejected"),
    ("fault_dropped", "fault_dropped"),
)


# --------------------------------------------------------------- rows

def delta_cells(delta) -> list[list[int]]:
    """Sparse nonzero cells of one chunk's ``[NM_CHANNELS, GH, GH]``
    delta: ``[src, dst, sent, enqueued, delivered, dropped, rejected,
    fault_dropped]`` per touched pair, row-major. The sparse form keeps
    quiet topologies' jsonl rows tiny regardless of G²."""
    d = np.asarray(delta, np.int64)
    touched = np.argwhere(d.any(axis=0))
    return [
        [int(s), int(t)] + [int(d[c, s, t]) for c in range(NM_CHANNELS)]
        for s, t in touched
    ]


def delta_row(delta, tick: int, chunk: int, ident=None) -> dict:
    """One ``sim_netmatrix.jsonl`` row for a chunk's matrix delta:
    ``tick`` is the tick count at the END of the chunk, ``cells`` the
    sparse nonzero pairs (see :func:`delta_cells`)."""
    row = dict(ident or {})
    row.update(tick=int(tick), chunk=int(chunk), cells=delta_cells(delta))
    return row


def matrix_from_rows(rows, gh: int) -> np.ndarray:
    """Sum decoded jsonl rows (dicts with ``cells``) back into the dense
    ``[NM_CHANNELS, gh, gh]`` int64 cumulative matrix."""
    mat = np.zeros((NM_CHANNELS, gh, gh), np.int64)
    for row in rows:
        for cell in row.get("cells") or ():
            s, t = int(cell[0]), int(cell[1])
            for c in range(NM_CHANNELS):
                mat[c, s, t] += int(cell[2 + c])
    return mat


def iter_rows(path: str):
    """Best-effort jsonl reader (the writer's crash-truncated final line
    is skipped, matching the telemetry decoder's contract)."""
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                yield json.loads(line)
            except ValueError:
                continue


# ------------------------------------------------------------- totals

def matrix_totals(mat) -> dict[str, int]:
    """Σ over all cells per channel — the numbers that must equal the
    engine's cumulative flow totals exactly."""
    m = np.asarray(mat, np.int64)
    return {
        name: int(m[c].sum()) for c, name in enumerate(NM_CHANNEL_NAMES)
    }


def matrix_bytes(mat) -> np.ndarray:
    """[GH, GH] int64 bytes view: enqueued messages × the fixed wire
    size (the same bytes accounting as the telemetry ``bytes`` column)."""
    m = np.asarray(mat, np.int64)
    return m[NM_ENQUEUED] * NM_MSG_BYTES


def reconcile(mat, flow_totals: dict) -> list[str]:
    """Exact conservation check: per channel, Σ matrix cells vs the
    engine's cumulative flow total. Returns human-readable mismatch
    strings — empty means the matrix reconciles exactly."""
    totals = matrix_totals(mat)
    out = []
    for channel, key in _FLOW_KEYS:
        if key not in flow_totals:
            continue
        want = int(flow_totals[key])
        got = totals[channel]
        if got != want:
            out.append(
                f"{channel}: matrix sums to {got}, flow total "
                f"{key}={want} (Δ {got - want:+d})"
            )
    return out


def top_pairs(mat, k: int) -> tuple[list[dict], int]:
    """The top-``k`` (src, dst) pairs by sent volume plus the count of
    ELIDED nonzero pairs — the bounded-cardinality contract behind the
    ``tg_net_pair_*`` Prometheus gauges (≤ k series per channel plus one
    elision gauge, never raw G²)."""
    m = np.asarray(mat, np.int64)
    gh = m.shape[1]
    sent = m[NM_SENT]
    nz = np.argwhere(m.any(axis=0))
    order = sorted(
        (tuple(p) for p in nz),
        key=lambda p: (-int(sent[p[0], p[1]]), p[0], p[1]),
    )
    pairs = [
        {
            "src": int(s),
            "dst": int(t),
            **{
                name: int(m[c, s, t])
                for c, name in enumerate(NM_CHANNEL_NAMES)
            },
        }
        for s, t in order[: max(0, int(k))]
    ]
    del gh
    return pairs, max(0, len(order) - len(pairs))


# ------------------------------------------------------- fault windows

def faulted_pairs(schedule, groups) -> np.ndarray:
    """[G, G] int64 count of declared fault WINDOWS covering each group
    pair — the static link-shaping observable (which pairs a chaos
    schedule degrades), computed host-side from the lowered schedule's
    event masks: a partition/flap drop window charges its (src-mask
    group, dst-mask group) pairs (both directions when symmetric); a
    loss-burst window charges its source groups' whole rows."""
    g_n = len(groups)
    out = np.zeros((g_n, g_n), np.int64)
    if schedule is None:
        return out

    def gmask(mask_np) -> np.ndarray:
        m = np.asarray(mask_np, bool)
        return np.array(
            [
                bool(m[g.offset : g.offset + g.count].any())
                if g.offset < m.shape[0]
                else False
                for g in groups
            ]
        )

    if getattr(schedule, "has_drops", False):
        for e in range(schedule.drop_t0.size):
            a = gmask(schedule.drop_a[e])
            b = gmask(schedule.drop_b[e])
            out += np.outer(a, b).astype(np.int64)
            if schedule.drop_sym[e]:
                out += np.outer(b, a).astype(np.int64)
    if getattr(schedule, "has_loss", False):
        ones = np.ones((g_n,), bool)
        for e in range(schedule.loss_t0.size):
            a = gmask(schedule.loss_masks[e])
            out += np.outer(a, ones).astype(np.int64)
    return out


# --------------------------------------------------------- cut advisor

def _cut_of(assign, sym) -> float:
    """Cross-cut traffic of a group→shard assignment under the
    symmetrized matrix (each unordered pair counted once)."""
    a = np.asarray(assign)
    cross = a[:, None] != a[None, :]
    return float(sym[cross].sum()) / 2.0


def _canon(assign) -> list[int]:
    """Renumber shards in first-appearance order so equivalent
    assignments print identically."""
    remap: dict[int, int] = {}
    out = []
    for s in assign:
        if s not in remap:
            remap[s] = len(remap)
        out.append(remap[s])
    return out


def cut_advisor(
    traffic,
    shards: int,
    labels=None,
    exhaustive_limit: int = 20_000,
) -> dict:
    """Score group→shard assignments by cross-cut traffic from the
    measured matrix — the partition advisor behind ``tg netmap --cut N``
    (ROADMAP item 1's instance-axis → mesh-axis mapping, measured).

    ``traffic`` is any [G, G] volume matrix (use :func:`matrix_bytes`
    for the bytes view); direction is ignored (a cut severs both). The
    search minimizes cut volume subject to balance (no shard over
    ⌈G/N⌉ groups — an unconstrained minimum is the trivial everything-
    on-one-shard answer) and uses every shard when G ≥ N. Exhaustive
    enumeration when the assignment space is ≤ ``exhaustive_limit``
    (exact optimum, small G), else greedy agglomerative merging: every
    group starts alone and the pair of clusters with the heaviest
    inter-traffic merges first — heavy talkers co-locate, which is the
    clustered-composition structure the advisor exists to recover.

    Returns ``assignment`` (canonical [G] shard ids), ``shards`` (label
    lists per shard), ``cut``, ``total`` (cross-group volume), and
    ``cut_fraction = cut / total`` (0 when there is no cross-group
    traffic at all)."""
    w = np.asarray(traffic, np.float64)
    if w.ndim != 2 or w.shape[0] != w.shape[1]:
        raise ValueError(f"traffic matrix must be square, got {w.shape}")
    g_n = w.shape[0]
    shards = int(shards)
    if shards < 1:
        raise ValueError(f"--cut needs at least 1 shard, got {shards}")
    if labels is None:
        labels = [str(i) for i in range(g_n)]
    if len(labels) != g_n:
        raise ValueError(
            f"{len(labels)} labels for a {g_n}-group matrix"
        )
    sym = w + w.T
    np.fill_diagonal(sym, 0.0)  # intra-group volume never crosses a cut
    total = float(sym.sum()) / 2.0
    shards_eff = min(shards, g_n)
    cap = math.ceil(g_n / shards_eff)

    best: list[int] | None = None
    best_cut = math.inf
    if shards_eff**g_n <= exhaustive_limit:
        method = "exhaustive"
        for assign in itertools.product(range(shards_eff), repeat=g_n):
            sizes = np.bincount(assign, minlength=shards_eff)
            if sizes.max(initial=0) > cap or (sizes == 0).any():
                continue
            cut = _cut_of(assign, sym)
            if cut < best_cut - 1e-9:
                best_cut = cut
                best = list(assign)
    else:
        method = "greedy"
        clusters: list[list[int]] = [[i] for i in range(g_n)]
        inter = sym.copy()
        while len(clusters) > shards_eff:
            # heaviest mergeable pair first; if balance blocks every
            # pair, merge the lightest-traffic smallest pair so the
            # loop always terminates (the cap is advisory there)
            pick = None
            pick_w = -1.0
            fallback = None
            fallback_key = (math.inf, math.inf)
            for i in range(len(clusters)):
                for j in range(i + 1, len(clusters)):
                    wij = float(inter[i, j])
                    size = len(clusters[i]) + len(clusters[j])
                    if size <= cap and wij > pick_w:
                        pick, pick_w = (i, j), wij
                    key = (size, wij)
                    if key < fallback_key:
                        fallback, fallback_key = (i, j), key
            i, j = pick if pick is not None else fallback
            clusters[i] = clusters[i] + clusters[j]
            del clusters[j]
            inter[i, :] += inter[j, :]
            inter[:, i] += inter[:, j]
            inter = np.delete(np.delete(inter, j, axis=0), j, axis=1)
            inter[i, i] = 0.0
        assign_arr = [0] * g_n
        for s, members in enumerate(clusters):
            for gi in members:
                assign_arr[gi] = s
        best = assign_arr
        best_cut = _cut_of(best, sym)

    assert best is not None
    assignment = _canon(best)
    n_used = max(assignment) + 1
    return {
        "assignment": assignment,
        "shards": [
            [labels[i] for i in range(g_n) if assignment[i] == s]
            for s in range(n_used)
        ],
        "cut": best_cut,
        "total": total,
        "cut_fraction": (best_cut / total) if total > 0 else 0.0,
        "method": method,
    }
