"""Threefry-2x32 keys, bit-matching ``jax.random``'s default PRNG.

The reference draws every simulator key from ``jax.random`` (``key``,
``split``, a vmapped ``fold_in`` and ``key_data``: ``engine.py:826-832,
1106,1587``, ``net.py:697``), and the storm plan draws its random graph
with ``jax.random.split`` and ``jax.random.randint`` from each instance's
key (``plans/benchmarks/sim.py:546-561``). The port reproduces those bits
exactly so a run seeded the same way takes the same decisions.

Layout: jax 0.9 defaults to ``jax_threefry_partitionable=True``, under
which ``split(key, num)`` hashes the 64-bit counter ``i`` as the pair
(hi, lo) = (0, i) and returns ``(y1[i], y2[i])`` as key ``i``;
``fold_in(key, d)`` hashes the single pair (0, d). Both are therefore one
threefry evaluation per output key — NOT the older ``(k, k+n)`` split of
one flat iota. ``random_bits`` is jax's partitionable 32-bit draw: the
counters are the pairs (0, i) over the flat output index and the bits are
``y1 ^ y2``.

Keys are uint32 pairs stored as int64 values in ``[0, 2**32)`` (torch has
no arithmetic uint32): shape ``[..., 2]``. All arithmetic is int64 masked
to 32 bits, so the helpers work unchanged on Python ints, which is how the
engine advances its two-lane link key on the host.
"""

from __future__ import annotations

import torch

__all__ = [
    "fold_in",
    "key",
    "key_data",
    "randint",
    "random_bits",
    "split",
    "split_host",
    "threefry2x32",
]

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 with 20 rounds, as ``jax._src.prng`` lowers it.
    Operands are int64 tensors (or Python ints) holding uint32 values;
    returns the pair ``(y1, y2)`` in the same representation."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x1 + ks[0]) & MASK32
    x1_ = (x2 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1_) & MASK32
            x1_ = (((x1_ << r) | (x1_ >> (32 - r))) & MASK32) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1_ = (x1_ + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x0, x1_


def key(seed: int, device="cpu") -> torch.Tensor:
    """``jax.random.key(seed)`` → ``[2]`` key data (hi word, lo word)."""
    seed = int(seed)
    return torch.tensor(
        [(seed >> 32) & MASK32 if seed >= 0 else 0, seed & MASK32],
        dtype=torch.int64,
        device=device,
    )


def split(k: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(k, num)`` over a batch of keys ``[..., 2]`` →
    ``[..., num, 2]`` (one key ``[2]`` → ``[num, 2]``)."""
    lo = torch.arange(num, dtype=torch.int64, device=k.device)
    y1, y2 = threefry2x32(k[..., 0, None], k[..., 1, None], 0, lo)
    return torch.stack([y1, y2], dim=-1)


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in`` over a batch of keys ``[..., 2]`` with one
    datum (an int or a 0-d integer tensor, taken as uint32)."""
    if isinstance(data, torch.Tensor):
        d = data.to(torch.int64) & MASK32
    else:
        d = int(data) & MASK32
    y1, y2 = threefry2x32(keys[..., 0], keys[..., 1], 0, d)
    return torch.stack([y1, y2], dim=-1)


def random_bits(keys: torch.Tensor, shape: tuple) -> torch.Tensor:
    """``jax.random.bits(k, shape)`` (uint32) for every key of ``[..., 2]``
    → ``[..., *shape]`` uint32 values in int64: the counter of flat output
    index i is the pair (hi, lo) of i, and the bits are ``y1 ^ y2``
    (``jax._src.prng._threefry_random_bits_partitionable``)."""
    size = 1
    for d in shape:
        size *= int(d)
    i = torch.arange(size, dtype=torch.int64, device=keys.device)
    y1, y2 = threefry2x32(keys[..., 0, None], keys[..., 1, None], i >> 32, i & MASK32)
    return (y1 ^ y2).reshape(*keys.shape[:-1], *shape)


def _as_i64(x, device) -> torch.Tensor:
    return torch.as_tensor(x, device=device).to(torch.int64)


def _urem(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """uint32 remainder as XLA computes it: ``a mod 0`` is ``a``."""
    return torch.where(b == 0, a, torch.remainder(a, torch.where(b == 0, 1, b)))


def randint(keys: torch.Tensor, shape: tuple, minval, maxval) -> torch.Tensor:
    """``jax.random.randint(k, shape, minval, maxval)`` (dtype int32) for
    every key of ``[..., 2]`` → ``[..., *shape]`` int32, as
    ``jax._src.random._randint`` computes it: ``k1, k2 = split(k)``, high
    bits from k1, low bits from k2, ``span = uint32(maxval - minval)`` (1
    where ``maxval <= minval``), ``multiplier = (2^16 mod span)^2 mod
    span``, offset ``((hi mod span)·multiplier + lo mod span) mod span`` in
    uint32 arithmetic that wraps. ``minval``/``maxval`` (ints or tensors
    broadcasting to the result) are clipped to the int32 range first; a
    ``maxval`` past it widens the span by one."""
    dev = keys.device
    i32_min, i32_max = -(2**31), 2**31 - 1
    k12 = split(keys)
    hi = random_bits(k12[..., 0, :], shape)
    lo = random_bits(k12[..., 1, :], shape)
    mx_raw = _as_i64(maxval, dev)
    mn = _as_i64(minval, dev).clamp(i32_min, i32_max)
    mx = mx_raw.clamp(i32_min, i32_max)
    span = (mx - mn) & MASK32
    span = torch.where(mx <= mn, torch.ones_like(span), span)
    span = torch.where((mx_raw > i32_max) & (mx > mn), (span + 1) & MASK32, span)
    mult = _urem(torch.full_like(span, 1 << 16), span)
    mult = _urem((mult * mult) & MASK32, span)
    off = ((_urem(hi, span) * mult) & MASK32) + _urem(lo, span)
    off = _urem(off & MASK32, span)
    out = (mn + off) & MASK32
    return torch.where(out >= 2**31, out - 2**32, out).to(torch.int32)


def key_data(k: torch.Tensor) -> torch.Tensor:
    """``jax.random.key_data``: the raw uint32 words (already the stored
    form)."""
    return k


def split_host(k: tuple[int, int]) -> tuple[tuple[int, int], tuple[int, int]]:
    """``split(k)`` for one key held as two Python ints — the engine's
    per-tick link-key advance, evaluated on the host so the tick never
    spends ~100 kernel launches on a two-lane hash."""
    a = threefry2x32(k[0], k[1], 0, 0)
    b = threefry2x32(k[0], k[1], 0, 1)
    return a, b
