"""In-sim coordination over torch: the sync service as device tensors.

Port of ``testground_tpu/sim/sync_kernel.py``: state counters with 1-based
per-signaller sequence numbers (a prefix sum over the instance axis),
bounded per-topic publish streams appended in instance order, and
per-instance subscribe cursors. Per-instance arrays keep the instance axis
last (``last_seq [S, N]``, ``cursors [T, N]``).
"""

from __future__ import annotations

import dataclasses

import torch

from .api import RUNNING

__all__ = [
    "SyncState",
    "live_per_group",
    "make_sub_window",
    "make_sync_state",
    "sync_occupancy",
    "update_sync",
]


@dataclasses.dataclass
class SyncState:
    """counts [S] int32, last_seq [S, N] int32, stream [T, CAP, PW] int32,
    stream_len [T] int32, cursors [T, N] int32, dropped [T] int32."""

    counts: torch.Tensor
    last_seq: torch.Tensor
    stream: torch.Tensor
    stream_len: torch.Tensor
    cursors: torch.Tensor
    dropped: torch.Tensor


def make_sync_state(
    n: int, n_states: int, n_topics: int, cap: int, pub_width: int, *, device
) -> SyncState:
    def z(*shape):
        return torch.zeros(shape, dtype=torch.int32, device=device)

    return SyncState(
        counts=z(n_states),
        last_seq=z(n_states, n),
        stream=z(n_topics, cap, pub_width),
        stream_len=z(n_topics),
        cursors=z(n_topics, n),
        dropped=z(n_topics),
    )


def update_sync(
    sync: SyncState,
    signals: torch.Tensor,  # [S, N] int32 0/1
    pub_payload: torch.Tensor,  # [T, PW, N] int32
    pub_valid: torch.Tensor,  # [T, N] bool
    sub_consume: torch.Tensor,  # [T, N] int32
    runs: int = 1,
) -> SyncState:
    """One tick's sync fold. ``runs`` > 1 folds a run pack's state
    (``sim/pack.py``): the lanes are ``runs`` run-major blocks and the
    shared leaves carry a leading run axis (``counts [R, S]``, ``stream
    [R, T, CAP, PW]``, ``stream_len``/``dropped [R, T]``); every prefix
    sum and append stays inside its run."""
    if runs > 1:
        return _update_sync_runs(sync, signals, pub_payload, pub_valid, sub_consume,
                                 runs)
    i32 = torch.int32
    n_topics, cap, pw = sync.stream.shape
    prefix = torch.cumsum(signals, dim=1, dtype=i32)
    seq = sync.counts[:, None] + prefix
    last_seq = torch.where(signals > 0, seq, sync.last_seq)
    counts = sync.counts + signals.sum(dim=1, dtype=i32)

    if n_topics == 0:
        return dataclasses.replace(sync, counts=counts, last_seq=last_seq)

    # Publish: stable append in instance order; entries past a full
    # topic's CAP are dropped (and counted), never written
    pv = pub_valid.to(i32)  # [T, N]
    offsets = sync.stream_len[:, None] + torch.cumsum(pv, dim=1, dtype=i32) - pv
    in_range = pub_valid & (offsets < cap)
    topic = torch.arange(n_topics, dtype=torch.int64, device=pv.device)[:, None]
    flat_idx = (topic * cap + offsets.to(torch.int64))[in_range]
    upd = pub_payload.permute(0, 2, 1)[in_range]  # [k, PW] in publish order
    stream = sync.stream.clone()
    stream.reshape(-1, pw)[flat_idx] = upd
    published = pv.sum(dim=1, dtype=i32)
    stored = in_range.sum(dim=1, dtype=i32)
    stream_len = torch.clamp(sync.stream_len + published, max=cap)
    dropped = sync.dropped + (published - stored)
    cursors = torch.minimum(
        sync.cursors + sub_consume.clamp_min(0), stream_len[:, None]
    )
    return SyncState(
        counts=counts,
        last_seq=last_seq,
        stream=stream,
        stream_len=stream_len,
        cursors=cursors,
        dropped=dropped,
    )


def _update_sync_runs(sync, signals, pub_payload, pub_valid, sub_consume, runs):
    """:func:`update_sync` over a pack's run axis, one launch per op for
    all runs."""
    i32, i64 = torch.int32, torch.int64
    n_states, lanes = signals.shape
    n = lanes // runs
    _, n_topics, cap, pw = sync.stream.shape
    sig = signals.view(n_states, runs, n)
    prefix = torch.cumsum(sig, dim=2, dtype=i32)
    seq = sync.counts.t()[:, :, None] + prefix
    last_seq = torch.where(signals > 0, seq.reshape(n_states, lanes), sync.last_seq)
    counts = sync.counts + sig.sum(dim=2, dtype=i32).t()

    if n_topics == 0:
        return dataclasses.replace(sync, counts=counts, last_seq=last_seq)

    pv = pub_valid.to(i32).view(n_topics, runs, n)  # [T, R, N]
    offsets = sync.stream_len.t()[:, :, None] + torch.cumsum(pv, dim=2, dtype=i32) - pv
    in_range = pub_valid.view(n_topics, runs, n) & (offsets < cap)
    dev = pv.device
    run = torch.arange(runs, dtype=i64, device=dev)[None, :, None]
    topic = torch.arange(n_topics, dtype=i64, device=dev)[:, None, None]
    flat_idx = ((run * n_topics + topic) * cap + offsets.to(i64))[in_range]
    upd = pub_payload.view(n_topics, pw, runs, n).permute(0, 2, 3, 1)[in_range]
    stream = sync.stream.clone()
    stream.reshape(-1, pw)[flat_idx] = upd
    published = pv.sum(dim=2, dtype=i32).t()  # [R, T]
    stored = in_range.sum(dim=2, dtype=i32).t()
    stream_len = torch.clamp(sync.stream_len + published, max=cap)
    dropped = sync.dropped + (published - stored)
    cursors = torch.minimum(
        (sync.cursors + sub_consume.clamp_min(0)).view(n_topics, runs, n),
        stream_len.t()[:, :, None],
    ).reshape(n_topics, lanes)
    return SyncState(
        counts=counts,
        last_seq=last_seq,
        stream=stream,
        stream_len=stream_len,
        cursors=cursors,
        dropped=dropped,
    )


def live_per_group(status: torch.Tensor, groups) -> torch.Tensor:
    """[G] int32 — RUNNING instances per group (the degraded-barrier
    denominator served as ``SyncView.live``)."""
    return torch.stack(
        [
            (status[g.offset : g.offset + g.count] == RUNNING).sum(
                dtype=torch.int32
            )
            for g in groups
        ]
    )


def sync_occupancy(sync: SyncState) -> tuple[torch.Tensor, torch.Tensor]:
    """The telemetry plane's occupancy of the sync service
    (``testground_tpu/sim/sync_kernel.py:172-178``): Σ state counters (every
    signal ever fired, the barrier occupancy) and Σ stored topic-stream
    entries (the publish occupancy), as int32 scalars."""
    return (
        sync.counts.sum(dtype=torch.int32),
        sync.stream_len.sum(dtype=torch.int32),
    )


def make_sub_window(
    sync: SyncState, sub_k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Each instance's next-SUB_K window into every topic stream, instance
    axis last: (sub_payload [T, K, PW, N], sub_valid [T, K, N])."""
    n_topics, n = sync.cursors.shape
    _, cap, pw = sync.stream.shape
    dev = sync.cursors.device
    if n_topics == 0:
        return (
            torch.zeros((0, sub_k, pw, n), dtype=torch.int32, device=dev),
            torch.zeros((0, sub_k, n), dtype=torch.bool, device=dev),
        )
    k = torch.arange(sub_k, dtype=torch.int32, device=dev)
    idx = sync.cursors[:, None, :] + k[None, :, None]  # [T, K, N]
    valid = idx < sync.stream_len[:, None, None]
    idx_c = idx.clamp(0, cap - 1).to(torch.int64)
    topic = torch.arange(n_topics, dtype=torch.int64, device=dev)[:, None, None]
    payload = sync.stream[topic, idx_c]  # [T, K, N, PW]
    return payload.permute(0, 1, 3, 2), valid
