"""Shape bucketing: pad the instance axis to a canonical size ladder —
the port's copy of ``testground_tpu/sim/buckets.py``, function for
function (numpy and the stdlib only, like the reference's).

- every group's instance count is padded UP to a small canonical ladder
  (default 4k/32k/128k/1M, configurable via ``bucket_ladder``), so the
  physical run shapes take only a handful of values;
- the *exact* live counts ride the carry (``SimCarry.live_counts``): the
  engine serves plans a virtualized :class:`~testground_tpu_torch.sim.api.SimEnv`
  (``test_instance_count`` / ``group.count`` / ``global_seq`` as 0-d
  tensors), translates plan-emitted virtual destinations to physical
  lanes, and derives per-lane PRNG keys that bit-match an unpadded run;
- padded lanes are dead from tick 0 — status CRASH, frozen by the
  engine's terminal-instance masking — and contribute nothing to flow
  totals, telemetry, results, or sync state. Results are demuxed back
  to exact-N arrays, pinned bit-equal to an unpadded run by
  ``tests/test_torch_buckets.py``.

The reference pads to compile once per bucket; the port compiles nothing,
so on the card a padded run only pays for its dead lanes (PERF.md §6).
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = [
    "DEFAULT_LADDER",
    "BucketPlan",
    "parse_bucket_mode",
    "parse_ladder",
    "resolve_rung",
    "bucketed_counts",
    "plan_buckets",
    "remap_lane_masks",
]

# The canonical instance-count ladder (per group). Small compositions
# all land on the first rung; the top rung matches the 1M envelope
# PERF.md benches. Configurable per run (``bucket_ladder = "a,b,c"``)
# so tests can use tiny rungs.
DEFAULT_LADDER = (4096, 32768, 131072, 1048576)


def parse_ladder(raw) -> tuple[int, ...]:
    """``"4096,32768"`` (or a TOML list) → ascending unique int tuple."""
    if raw is None or raw == "":
        return DEFAULT_LADDER
    if isinstance(raw, str):
        parts = [p for p in (s.strip() for s in raw.split(",")) if p]
    elif isinstance(raw, int):
        # `--run-cfg bucket_ladder=32` (a single rung) coalesces as a
        # bare int, not a "32" string
        parts = [raw]
    else:
        parts = list(raw)
    try:
        rungs = sorted({int(p) for p in parts})
    except (TypeError, ValueError):
        raise ValueError(
            f"bucket_ladder {raw!r} is not a comma-separated list of "
            "instance counts"
        ) from None
    if not rungs or rungs[0] <= 0:
        raise ValueError(
            f"bucket_ladder {raw!r} must hold positive instance counts"
        )
    return tuple(rungs)


def parse_bucket_mode(raw) -> str | int:
    """The ``bucket`` runner-config knob: ``off`` (default), ``auto``
    (pad every group to the ladder), or an explicit ``<n>`` (pad every
    group to exactly n)."""
    if raw is None or raw == "" or raw is False:
        return "off"
    s = str(raw).strip().lower()
    if s in ("off", "false", "0", "none"):
        return "off"
    if s in ("auto", "true", "on"):
        return "auto"
    try:
        n = int(s)
    except ValueError:
        raise ValueError(
            f"unknown bucket mode {raw!r}: expected 'auto', 'off', or an "
            "explicit instance count (--run-cfg bucket=auto)"
        ) from None
    if n <= 0:
        raise ValueError(f"bucket={n} must be a positive instance count")
    return n


def resolve_rung(n: int, ladder: tuple[int, ...]) -> int | None:
    """Smallest ladder rung ≥ n, or None when n is above the top rung
    (the caller then runs unbucketed, loudly)."""
    for rung in ladder:
        if n <= rung:
            return rung
    return None


def bucketed_counts(
    counts, mode, ladder: tuple[int, ...]
) -> tuple[int, ...] | None:
    """Per-group padded counts for a composition, or None when bucketing
    does not apply (mode off, or a group exceeds the coverage). Pure
    count math — shared by the executor gate and the engine-side pack
    admission key."""
    if mode == "off":
        return None
    padded = []
    for c in counts:
        c = int(c)
        if isinstance(mode, int):
            if c > mode:
                return None
            padded.append(mode)
            continue
        rung = resolve_rung(c, ladder)
        if rung is None:
            return None
        padded.append(rung)
    return tuple(padded)


@dataclasses.dataclass(frozen=True)
class BucketPlan:
    """A resolved padding layout: physical (padded) per-group counts
    beside the exact live counts, plus the static virtual↔physical
    index maps the lowering helpers need."""

    live_counts: tuple[int, ...]  # exact per-group counts (virtual)
    padded_counts: tuple[int, ...]  # canonical per-group counts (physical)

    @property
    def live_n(self) -> int:
        return sum(self.live_counts)

    @property
    def padded_n(self) -> int:
        return sum(self.padded_counts)

    @property
    def virt_offsets(self) -> tuple[int, ...]:
        out, off = [], 0
        for c in self.live_counts:
            out.append(off)
            off += c
        return tuple(out)

    @property
    def phys_offsets(self) -> tuple[int, ...]:
        out, off = [], 0
        for c in self.padded_counts:
            out.append(off)
            off += c
        return tuple(out)

    def index_map(self) -> np.ndarray:
        """``[live_n] int32`` — virtual lane id → physical lane id (each
        group's live lanes are the first ``live`` of its padded span)."""
        segs = [
            np.arange(live, dtype=np.int32) + poff
            for live, poff in zip(self.live_counts, self.phys_offsets)
        ]
        return (
            np.concatenate(segs)
            if segs
            else np.zeros((0,), np.int32)
        )

    def summary(self) -> str:
        return (
            f"{self.live_n} live instance(s) padded to {self.padded_n} "
            "(per-group "
            + ", ".join(
                f"{l}→{p}"
                for l, p in zip(self.live_counts, self.padded_counts)
            )
            + f"; {self.padded_n - self.live_n} dead lane(s))"
        )


def plan_buckets(counts, mode, ladder=None) -> BucketPlan | None:
    """Resolve a composition's group counts against the knob + ladder.
    Returns None when bucketing does not apply — the caller runs the
    exact-shape program, as before this plane existed."""
    ladder = parse_ladder(ladder) if not isinstance(ladder, tuple) else ladder
    padded = bucketed_counts(counts, mode, ladder)
    if padded is None:
        return None
    return BucketPlan(
        live_counts=tuple(int(c) for c in counts), padded_counts=padded
    )


def remap_lane_masks(masks: np.ndarray, index_map: np.ndarray, n_phys: int):
    """Scatter ``[E, live_n]`` virtual-lane masks onto the padded
    physical axis (pad lanes never selected) — the fault-schedule
    remap: chaos selectors are declared over the composition's EXACT
    layout and must keep targeting the same instances after padding."""
    masks = np.asarray(masks, bool)
    out = np.zeros((masks.shape[0], n_phys), bool)
    if masks.size:
        out[:, index_map] = masks
    return out
