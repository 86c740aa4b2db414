"""Differential run analysis: the RunDiff document builder — the port's
copy of the reference's ``testground_tpu/analysis/diff.py``, its code
unchanged.

Two finished tasks' journals + jsonl streams load into ONE structured
document with two kinds of comparison, matched to what each number IS:

- **Deterministic counters compared exactly.** The sim is a
  seed-deterministic program: message-flow totals, fault counters,
  latency histograms (sim-time, not wall), SLO breach records and the
  traffic matrix must be IDENTICAL between two runs of the same
  composition + seed. A mismatch there is a correctness finding —
  never noise, never a tolerance band.
- **Throughput/wall judged statistically.** Chunk dispatch walls are
  host wall-clock on a noisy box, so single-number ratios lie. Verdicts
  come from the per-chunk rate samples already streamed into
  ``sim_perf.jsonl``: median ratio for effect size + a hand-rolled
  two-sided Mann-Whitney U (rank test — no distribution assumption,
  robust to the fat-tailed stalls a shared box produces) for
  significance, warmup chunks excluded exactly as the ledger's
  ``steady_*`` window excludes them. Each judged row carries its verdict
  (``improved|regressed|unchanged|inconclusive``), sample counts and
  p-value, so a reader can audit the call.

This module is stdlib-only (see the package docstring) and is the ONE
comparison codepath: ``Engine.diff_tasks`` / ``GET /diff`` / ``tg
diff`` build full RunDiff documents here, and ``tg perf --compare``
(``sim.perf.perf_compare``) delegates to :func:`ledger_scalars` /
:func:`perf_compare` below.
"""

from __future__ import annotations

import hashlib
import json
import math
from typing import Any, Iterable

__all__ = [
    "DIFF_PLANES",
    "build_run_diff",
    "extract_ledger_metrics",
    "fmt_rate",
    "judge_samples",
    "ledger_scalars",
    "mann_whitney_u",
    "num",
    "perf_compare",
    "task_snapshot",
    "validate_planes",
]

# one name per source surface: counters = journal flow totals (+ the
# telemetry stream's mirror), perf = sim_perf.jsonl chunk samples +
# ledger scalars, latency = sim.latency percentiles (sim-time),
# phases = sim.phases static cost rows, slo = journal rule verdicts,
# netmatrix = sim.net_matrix totals + cells
DIFF_PLANES = ("counters", "perf", "latency", "phases", "slo", "netmatrix")


# --------------------------------------------------------------- shared
# numeric hygiene + rate formatting: canonical implementations live here
# (stdlib-only) and sim/perf.py re-exports them, so ledger consumers and
# the diff engine format identically without analysis importing torch.


def num(v, default=None):
    """A finite number, or ``default`` — perf/stats payloads are decoded
    JSON from possibly foreign writers, so a null/NaN/string field must
    degrade gracefully, never TypeError. Shared by every ledger consumer
    (``runners/pretty.py`` tables, the Prometheus exposition)."""
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        return default
    if not math.isfinite(v):
        return default
    return v


def fmt_rate(v, missing: str = "?") -> str:
    """A rate with a G/M/k suffix (``?`` for absent/non-finite) — the one
    formatter behind the ``tg perf`` table, ``--compare`` lines and the
    ``tg diff`` throughput rows."""
    n = num(v)
    if n is None:
        return missing
    for div, suffix in ((1e9, "G"), (1e6, "M"), (1e3, "k")):
        if abs(n) >= div:
            return f"{n / div:.2f}{suffix}"
    return f"{n:.1f}"


# ---------------------------------------------------------- statistics


def mann_whitney_u(xs: Iterable, ys: Iterable) -> tuple[float, float]:
    """Two-sided Mann-Whitney U test via the normal approximation with
    tie correction and continuity correction. Returns ``(U₁, p)`` where
    U₁ is the statistic for ``xs``.

    Hand-rolled on purpose: scipy is not a dependency of this repo, the
    sample sizes here (chunks per run, typically 8-500) are square in
    the approximation's comfort zone, and a rank test needs no
    distribution assumption — exactly right for fat-tailed shared-box
    dispatch walls. Degenerate inputs (empty side, all values tied)
    return p=1.0: no evidence of a shift, never a crash.
    """
    xs = [float(v) for v in xs]
    ys = [float(v) for v in ys]
    n1, n2 = len(xs), len(ys)
    if n1 == 0 or n2 == 0:
        return 0.0, 1.0
    pooled = sorted(
        [(v, 0) for v in xs] + [(v, 1) for v in ys], key=lambda t: t[0]
    )
    n = n1 + n2
    ranks = [0.0] * n
    tie_term = 0.0
    i = 0
    while i < n:
        j = i
        while j + 1 < n and pooled[j + 1][0] == pooled[i][0]:
            j += 1
        avg_rank = (i + j) / 2.0 + 1.0
        for k in range(i, j + 1):
            ranks[k] = avg_rank
        t = j - i + 1
        tie_term += t * t * t - t
        i = j + 1
    r1 = sum(r for r, (_, side) in zip(ranks, pooled) if side == 0)
    u1 = r1 - n1 * (n1 + 1) / 2.0
    mean_u = n1 * n2 / 2.0
    var_u = 0.0
    if n > 1:
        var_u = (n1 * n2 / 12.0) * ((n + 1) - tie_term / (n * (n - 1)))
    if var_u <= 0.0:  # every value tied: no evidence either way
        return u1, 1.0
    # continuity correction toward the mean
    cc = 0.5 if u1 != mean_u else 0.0
    z = (abs(u1 - mean_u) - cc) / math.sqrt(var_u)
    p = math.erfc(max(z, 0.0) / math.sqrt(2.0))
    return u1, min(1.0, max(0.0, p))


def _median(xs: list[float]) -> float:
    s = sorted(xs)
    n = len(s)
    mid = n // 2
    return s[mid] if n % 2 else (s[mid - 1] + s[mid]) / 2.0


def judge_samples(
    a_samples: Iterable,
    b_samples: Iterable,
    *,
    alpha: float = 0.01,
    min_samples: int = 4,
    rel_epsilon: float = 0.10,
    higher_is_better: bool = True,
) -> dict:
    """Noise-aware verdict for one metric: B (candidate) vs A
    (baseline), judged from per-chunk samples.

    The defaults are deliberately conservative for the serving box's
    documented ±40% wall-clock noise (ROADMAP): a verdict needs BOTH
    rank-test significance at alpha=0.01 AND a ≥10% median shift, so
    two back-to-back identical runs judge clean while a real slowdown
    (p orders of magnitude below alpha) still flags. See PERF.md
    "Noise-aware comparison".

    Returns ``{verdict, n_a, n_b, median_a, median_b, ratio, p_value,
    reason}`` where verdict is one of:

    - ``improved`` / ``regressed`` — the shift is statistically
      significant (Mann-Whitney p < alpha) AND practically meaningful
      (median ratio outside ±rel_epsilon);
    - ``unchanged`` — no meaningful shift (either not significant and
      medians within the band, or significant but negligible effect);
    - ``inconclusive`` — too few samples to test, or an observed median
      shift the rank test cannot confirm at this noise level — the
      honest answer on a ±40% box, and what a gating consumer must
      treat as "do not block, do journal".
    """
    xs = [v for v in (num(s) for s in a_samples) if v is not None]
    ys = [v for v in (num(s) for s in b_samples) if v is not None]
    row: dict[str, Any] = {"n_a": len(xs), "n_b": len(ys)}
    if len(xs) < min_samples or len(ys) < min_samples:
        row.update(
            verdict="inconclusive",
            reason=(
                f"too few samples (n_a={len(xs)}, n_b={len(ys)}, "
                f"need {min_samples})"
            ),
        )
        if xs:
            row["median_a"] = _median(xs)
        if ys:
            row["median_b"] = _median(ys)
        return row
    med_a, med_b = _median(xs), _median(ys)
    row["median_a"], row["median_b"] = med_a, med_b
    ratio = med_b / med_a if med_a else math.inf
    row["ratio"] = round(ratio, 6) if math.isfinite(ratio) else None
    _, p = mann_whitney_u(xs, ys)
    row["p_value"] = round(p, 6)
    shifted = not (1.0 - rel_epsilon <= ratio <= 1.0 + rel_epsilon)
    significant = p < alpha
    if significant and shifted:
        better = ratio > 1.0
        if not higher_is_better:
            better = not better
        row["verdict"] = "improved" if better else "regressed"
        row["reason"] = (
            f"median ratio x{ratio:.3f}, p={p:.4g} < {alpha:g}"
        )
    elif shifted:
        row["verdict"] = "inconclusive"
        row["reason"] = (
            f"median ratio x{ratio:.3f} but p={p:.4g} >= {alpha:g} "
            "(shift not separable from noise)"
        )
    else:
        row["verdict"] = "unchanged"
        row["reason"] = f"median ratio x{ratio:.3f}, p={p:.4g}"
    return row


# -------------------------------------------------- ledger scalar diff
# (the `tg perf --compare` core, shared with the RunDiff perf plane)


def extract_ledger_metrics(obj: dict) -> dict:
    """Pull the comparable numbers out of any ledger-bearing shape:

    - a ``tg perf --json`` payload (``{"perf": {...}, "sim": {...}}``)
    - a journal ``sim`` block (``{"perf": {...}, "wall_secs": ...}``)
    - a bare ledger block (``{"compile": ..., "execute": ...}``)
    - a ``bench.py`` / BENCH_rNN.json line
      (``{"metric": "sim_peer_ticks_per_sec", "value": ..., "perf": ...}``)
    - a bench-trajectory wrapper (``{"tail":
      "<log>\\n{bench json line}"}``) — the embedded line is unwrapped

    Returns ``{peer_ticks_per_sec?, compile_secs?, lower_secs?,
    xla_compile_secs?, wall_secs?, ticks?}`` — only what the shape holds.
    """
    out: dict[str, float] = {}
    if not isinstance(obj, dict):
        return out
    if (
        isinstance(obj.get("tail"), str)
        and "metric" not in obj
        and "perf" not in obj
        and "sim" not in obj
    ):
        for line in reversed(obj["tail"].splitlines()):
            line = line.strip()
            if not line.startswith("{"):
                continue
            try:
                return extract_ledger_metrics(json.loads(line))
            except ValueError:
                continue
        return out
    perf = obj
    if isinstance(obj.get("perf"), dict):
        perf = obj["perf"]
    elif isinstance(obj.get("sim"), dict):
        perf = obj["sim"].get("perf", {})
    sim = obj.get("sim") if isinstance(obj.get("sim"), dict) else obj
    # the module-level finite coercion — json.loads admits NaN/Infinity
    # literals, and a hand-edited baseline must not print 'xnan' ratios
    ex = perf.get("execute") if isinstance(perf.get("execute"), dict) else {}
    co = perf.get("compile") if isinstance(perf.get("compile"), dict) else {}
    for key, src in (
        ("peer_ticks_per_sec", ex.get("steady_peer_ticks_per_sec")),
        ("peer_ticks_per_sec", ex.get("peer_ticks_per_sec")),
        ("wall_secs", ex.get("wall_secs")),
        ("ticks", ex.get("ticks")),
        ("lower_secs", co.get("lower_secs")),
        ("xla_compile_secs", co.get("compile_secs")),
    ):
        v = num(src)
        if v is not None and key not in out:
            out[key] = v
    # bench.py headline line (BENCH_rNN.json)
    if obj.get("metric") == "sim_peer_ticks_per_sec":
        v = num(obj.get("value"))
        if v is not None:
            out.setdefault("peer_ticks_per_sec", v)
        v = num(obj.get("compile_secs"))
        if v is not None:
            out.setdefault("compile_secs", v)
    # journal sim block fields
    if isinstance(sim, dict):
        for key, name in (("wall_secs", "wall_secs"), ("ticks", "ticks")):
            v = num(sim.get(key))
            if v is not None:
                out.setdefault(name, v)
        v = num(sim.get("compile_secs"))
        if v is not None:
            out.setdefault("compile_secs", v)
    return out


def ledger_scalars(current: dict, baseline: dict) -> list[dict]:
    """The comparable ledger scalars between two ledger-bearing dicts:
    ``[{metric, current, baseline, ratio}]`` (ratio = current/baseline).
    Summary numbers, one per run — informational effect sizes with no
    per-chunk samples behind them, so NO verdict is attached here (the
    RunDiff perf plane judges the sampled metrics; ``perf_compare``
    prints these as-is)."""
    cur, base = extract_ledger_metrics(current), extract_ledger_metrics(baseline)
    rows: list[dict] = []
    c, b = cur.get("peer_ticks_per_sec"), base.get("peer_ticks_per_sec")
    if c and b:
        rows.append(
            {
                "metric": "peer_ticks_per_sec",
                "current": c,
                "baseline": b,
                "ratio": c / b,
            }
        )
    c, b = cur.get("compile_secs"), base.get("compile_secs")
    if c is None:
        c = (cur.get("lower_secs") or 0) + (cur.get("xla_compile_secs") or 0) or None
    if b is None:
        b = (base.get("lower_secs") or 0) + (base.get("xla_compile_secs") or 0) or None
    if c and b:
        rows.append(
            {"metric": "compile_secs", "current": c, "baseline": b, "ratio": c / b}
        )
    c, b = cur.get("wall_secs"), base.get("wall_secs")
    if c and b:
        rows.append(
            {"metric": "wall_secs", "current": c, "baseline": b, "ratio": c / b}
        )
    return rows


def perf_compare(
    current: dict, baseline: dict, label: str = "baseline"
) -> list[str]:
    """Human-readable throughput deltas between two ledger-bearing
    dicts — the ``tg perf --compare`` body. Returns one line per
    comparable metric; a single explanatory line when nothing overlaps
    (never raises on shape mismatches — review-time tooling must not
    crash on a hand-edited baseline)."""
    lines: list[str] = []
    for row in ledger_scalars(current, baseline):
        c, b, ratio = row["current"], row["baseline"], row["ratio"]
        if row["metric"] == "peer_ticks_per_sec":
            lines.append(
                f"peer·ticks/s  {fmt_rate(c)} vs {fmt_rate(b)} {label} "
                f"(x{ratio:.3f})"
            )
        elif row["metric"] == "compile_secs":
            lines.append(
                f"compile       {c:.2f}s vs {b:.2f}s {label} (x{ratio:.3f})"
            )
        elif row["metric"] == "wall_secs":
            lines.append(
                f"wall          {c:.2f}s vs {b:.2f}s {label} (x{ratio:.3f})"
            )
    if not lines:
        lines.append(
            f"no comparable throughput fields between this task and {label} "
            "(expected a perf ledger, a journal sim block, or a bench.py "
            "JSON line)"
        )
    return lines


# ----------------------------------------------------------- snapshots


def _dict(v) -> dict:
    return v if isinstance(v, dict) else {}


def task_snapshot(task: dict, perf_rows: list[dict] | None = None) -> dict:
    """Normalize one task (its ``to_dict`` shape) + its swept
    ``sim_perf.jsonl`` rows into the snapshot :func:`build_run_diff`
    consumes. Defensive throughout: a half-archived or foreign task
    yields a sparse snapshot, never an exception — missing planes are
    reported as absent by the diff, not crashed on."""
    task = _dict(task)
    result = _dict(task.get("result"))
    journal = _dict(result.get("journal"))
    states = task.get("states") or []
    state = ""
    if isinstance(states, list) and states:
        state = str(_dict(states[-1]).get("state") or "")
    return {
        "task_id": str(task.get("id") or ""),
        "plan": str(task.get("plan") or ""),
        "case": str(task.get("case") or ""),
        "state": state,
        "outcome": str(task.get("outcome") or ""),
        "error": str(task.get("error") or ""),
        "sim": _dict(journal.get("sim")),
        "telemetry": _dict(journal.get("telemetry")),
        "slo": _dict(journal.get("slo")),
        "composition": _dict(task.get("composition")),
        "perf_rows": [r for r in (perf_rows or []) if isinstance(r, dict)],
    }


def validate_planes(planes) -> tuple[str, ...]:
    """Normalize a plane selection (``None``/empty → all) and raise
    ``ValueError`` naming the known planes on an unknown one — the 400
    the daemon route and the CLI surface."""
    if not planes:
        return DIFF_PLANES
    if isinstance(planes, str):
        planes = [p for p in planes.split(",") if p.strip()]
    out = []
    for p in planes:
        p = str(p).strip()
        if p not in DIFF_PLANES:
            raise ValueError(
                f"unknown diff plane {p!r} (known: {', '.join(DIFF_PLANES)})"
            )
        if p not in out:
            out.append(p)
    return tuple(out) or DIFF_PLANES


# ------------------------------------------------- setup identity


def _scrub_setup(obj):
    """The composition minus everything that does not shape results:
    display metadata and build artifact paths (two identical
    submissions build to cache-keyed — but potentially distinct —
    artifact paths). What remains IS the determinism identity: same
    scrubbed composition ⇒ the runs are identically seeded and every
    deterministic counter must match exactly."""
    if isinstance(obj, dict):
        return {
            k: _scrub_setup(v)
            for k, v in sorted(obj.items())
            if k not in ("metadata", "artifact")
        }
    if isinstance(obj, list):
        return [_scrub_setup(v) for v in obj]
    return obj


def _setup_diff_paths(a, b, prefix="", out=None, limit=16) -> list[str]:
    """Dotted paths where two scrubbed setups differ (bounded)."""
    if out is None:
        out = []
    if len(out) >= limit:
        return out
    if isinstance(a, dict) and isinstance(b, dict):
        for k in sorted(set(a) | set(b)):
            _setup_diff_paths(
                a.get(k), b.get(k), f"{prefix}.{k}" if prefix else str(k), out, limit
            )
        return out
    if isinstance(a, list) and isinstance(b, list) and len(a) == len(b):
        for i, (va, vb) in enumerate(zip(a, b)):
            _setup_diff_paths(va, vb, f"{prefix}[{i}]", out, limit)
        return out
    if a != b and len(out) < limit:
        out.append(prefix or "<root>")
    return out


# ------------------------------------------------- exact-counter planes

# the journal sim block's deterministic counters: seed-determined
# program outputs, never wall-clock (wall_secs/compile_secs live in the
# perf plane's scalar view)
SIM_COUNTER_KEYS = (
    "ticks",
    "tick_ms",
    "processes",
    "devices",
    "msgs_sent",
    "msgs_enqueued",
    "msgs_delivered",
    "msgs_dropped",
    "msgs_rejected",
    "msgs_in_flight",
    "msgs_fault_dropped",
    "faults_crashed",
    "faults_restarted",
    "latency_clamped",
    "bw_queue_dropped",
    "bw_rate_change_backlogged",
    "pub_dropped",
    "carry_bytes",
)

TELEMETRY_TOTAL_KEYS = (
    "delivered",
    "sent",
    "enqueued",
    "dropped",
    "rejected",
    "in_flight",
    "fault_dropped",
)


def _digest(v) -> dict:
    """Bounded stand-in for a large exact-compared object (the traffic
    matrix): cell count + sum + a content hash, so the row stays
    renderable while equality is still judged on the full object."""
    blob = json.dumps(v, sort_keys=True, default=str)
    total = 0

    def _sum(o):
        nonlocal total
        if isinstance(o, (int, float)) and not isinstance(o, bool):
            total += o
        elif isinstance(o, list):
            for x in o:
                _sum(x)

    _sum(v)
    return {
        "sum": total,
        "sha1": hashlib.sha1(blob.encode()).hexdigest()[:10],
    }


def _counter_rows(pairs: list[tuple[str, Any, Any]], digest_over=64) -> list[dict]:
    rows = []
    for name, va, vb in pairs:
        if va is None and vb is None:
            continue
        equal = va == vb
        if isinstance(va, list) and len(json.dumps(va, default=str)) > digest_over:
            va = _digest(va)
        if isinstance(vb, list) and len(json.dumps(vb, default=str)) > digest_over:
            vb = _digest(vb)
        rows.append({"name": name, "a": va, "b": vb, "equal": equal})
    return rows


def _flatten_numeric(prefix: str, obj, skip=()) -> list[tuple[str, Any]]:
    """Dotted (name, value) leaves of a journal sub-block, skipping
    key names in ``skip`` (the wall-clock fields of otherwise
    deterministic blocks)."""
    out: list[tuple[str, Any]] = []
    if isinstance(obj, dict):
        for k in sorted(obj):
            if k in skip:
                continue
            out.extend(_flatten_numeric(f"{prefix}.{k}", obj[k], skip))
    elif isinstance(obj, (int, float, str, bool)) or obj is None:
        out.append((prefix, obj))
    elif isinstance(obj, list):
        out.append((prefix, obj))
    return out


def _plane_counters(a: dict, b: dict) -> dict:
    sim_a, sim_b = _dict(a.get("sim")), _dict(b.get("sim"))
    tel_a = _dict(_dict(a.get("telemetry")).get("totals"))
    tel_b = _dict(_dict(b.get("telemetry")).get("totals"))
    if not sim_a and not sim_b and not tel_a and not tel_b:
        return {"absent": "neither run journaled a sim block"}
    pairs: list[tuple[str, Any, Any]] = []
    for k in SIM_COUNTER_KEYS:
        pairs.append((f"sim.{k}", sim_a.get(k), sim_b.get(k)))
    # the telemetry stream's cumulative mirror (present only when the
    # per-tick block was compiled in) — pinned separately so a stream/
    # journal divergence shows up as ITS own row
    for k in TELEMETRY_TOTAL_KEYS:
        pairs.append((f"telemetry.totals.{k}", tel_a.get(k), tel_b.get(k)))
    rows = _counter_rows(pairs)
    return {
        "compared": len(rows),
        "mismatched": sum(1 for r in rows if not r["equal"]),
        "rows": rows,
    }


def _plane_latency(a: dict, b: dict) -> dict:
    lat_a = _dict(_dict(a.get("sim")).get("latency"))
    lat_b = _dict(_dict(b.get("sim")).get("latency"))
    if not lat_a and not lat_b:
        return {"absent": "no latency block (telemetry off in both runs)"}
    # per-receiver-group {count, p50/p95/p99_ms}: SIM-time quantities
    # derived from deterministic device-side histograms — exact compare
    # is correct even though the unit is "ms"
    names = sorted(set(lat_a) | set(lat_b))
    pairs = []
    for g in names:
        ga, gb = _dict(lat_a.get(g)), _dict(lat_b.get(g))
        for k in sorted(set(ga) | set(gb)):
            pairs.append((f"latency.{g}.{k}", ga.get(k), gb.get(k)))
    rows = _counter_rows(pairs)
    return {
        "compared": len(rows),
        "mismatched": sum(1 for r in rows if not r["equal"]),
        "rows": rows,
    }


def _plane_slo(a: dict, b: dict) -> dict:
    slo_a, slo_b = _dict(a.get("slo")), _dict(b.get("slo"))
    if not slo_a and not slo_b:
        return {"absent": "no SLO rules armed in either run"}
    pairs: list[tuple[str, Any, Any]] = [
        ("slo.breaches", slo_a.get("breaches"), slo_b.get("breaches"))
    ]
    rules_a = {
        str(r.get("name")): r for r in slo_a.get("rules") or [] if isinstance(r, dict)
    }
    rules_b = {
        str(r.get("name")): r for r in slo_b.get("rules") or [] if isinstance(r, dict)
    }
    for name in sorted(set(rules_a) | set(rules_b)):
        ra, rb = _dict(rules_a.get(name)), _dict(rules_b.get(name))
        # breach counts/ticks/worst observations are sim-domain and
        # deterministic; rule shape (metric/op/threshold/severity) is
        # config — both compare exactly
        for k in (
            "metric",
            "op",
            "threshold",
            "window_ticks",
            "severity",
            "breaches",
            "first_tick",
            "last_tick",
            "worst",
            "last_observed",
        ):
            pairs.append((f"slo.{name}.{k}", ra.get(k), rb.get(k)))
    rows = _counter_rows(pairs)
    return {
        "compared": len(rows),
        "mismatched": sum(1 for r in rows if not r["equal"]),
        "rows": rows,
    }


def _plane_netmatrix(a: dict, b: dict) -> dict:
    nm_a = _dict(_dict(a.get("sim")).get("net_matrix"))
    nm_b = _dict(_dict(b.get("sim")).get("net_matrix"))
    if not nm_a and not nm_b:
        return {"absent": "no traffic matrix (netmatrix off in both runs)"}
    tot_a, tot_b = _dict(nm_a.get("totals")), _dict(nm_b.get("totals"))
    pairs: list[tuple[str, Any, Any]] = []
    for k in sorted(set(tot_a) | set(tot_b)):
        pairs.append((f"net_matrix.totals.{k}", tot_a.get(k), tot_b.get(k)))
    for k in ("labels", "bytes_total", "mismatches", "matrix"):
        pairs.append((f"net_matrix.{k}", nm_a.get(k), nm_b.get(k)))
    rows = _counter_rows(pairs)
    return {
        "compared": len(rows),
        "mismatched": sum(1 for r in rows if not r["equal"]),
        "rows": rows,
    }


def _plane_phases(a: dict, b: dict) -> dict:
    ph_a = _dict(_dict(a.get("sim")).get("phases"))
    ph_b = _dict(_dict(b.get("sim")).get("phases"))
    if not ph_a and not ph_b:
        return {"absent": "no phase ledger (phases off in both runs)"}
    # static XLA cost rows are build-deterministic; measured_ms/
    # measured_reps are wall-clock calibration — excluded from the
    # exact plane (they would need per-rep samples to judge honestly)
    noisy = ("measured_ms", "measured_reps")

    def rows_by_phase(block):
        return {
            str(r.get("phase")): r
            for r in block.get("rows") or []
            if isinstance(r, dict)
        }

    pa, pb = rows_by_phase(ph_a), rows_by_phase(ph_b)
    pairs: list[tuple[str, Any, Any]] = []
    for phase in sorted(set(pa) | set(pb)):
        ra, rb = _dict(pa.get(phase)), _dict(pb.get(phase))
        for k in sorted((set(ra) | set(rb)) - {"phase", *noisy}):
            pairs.append((f"phases.{phase}.{k}", ra.get(k), rb.get(k)))
    res_a = dict(_flatten_numeric("phases.residual", _dict(ph_a.get("residual"))))
    res_b = dict(_flatten_numeric("phases.residual", _dict(ph_b.get("residual"))))
    for name in sorted(set(res_a) | set(res_b)):
        pairs.append((name, res_a.get(name), res_b.get(name)))
    rows = _counter_rows(pairs)
    return {
        "compared": len(rows),
        "mismatched": sum(1 for r in rows if not r["equal"]),
        "rows": rows,
    }


# ------------------------------------------------------ perf plane


def _steady_samples(snapshot: dict, key: str) -> list[float]:
    """Per-chunk ``key`` samples from the swept sim_perf.jsonl rows,
    warmup dispatches excluded — the same window the ledger's
    ``steady_*`` summary uses (warmup count recovered from the journal:
    chunks − steady_chunks; 1 when the journal doesn't say)."""
    perf = _dict(_dict(snapshot.get("sim")).get("perf"))
    ex = _dict(perf.get("execute"))
    warmup = 1
    chunks, steady = num(ex.get("chunks")), num(ex.get("steady_chunks"))
    if chunks is not None and steady is not None:
        warmup = max(0, int(chunks) - int(steady))
    out: list[float] = []
    for row in snapshot.get("perf_rows") or []:
        if not isinstance(row, dict) or row.get("stream") not in (None, "perf"):
            continue
        idx = num(row.get("chunk"))
        v = num(row.get(key))
        if idx is None or v is None or int(idx) < warmup:
            continue
        out.append(float(v))
    return out


def _plane_perf(a: dict, b: dict) -> dict:
    out: dict[str, Any] = {}
    metrics: list[dict] = []
    # judged rows: per-chunk samples through the rank test. ticks/s is
    # the primary rate (higher better); the dispatch wall is its time-
    # domain view (lower better) — same ranks, so consistent verdicts
    for metric, key, higher in (
        ("chunk_ticks_per_sec", "ticks_per_sec", True),
        ("chunk_peer_ticks_per_sec", "peer_ticks_per_sec", True),
        ("chunk_wall_secs", "wall_secs", False),
    ):
        xs = _steady_samples(a, key)
        ys = _steady_samples(b, key)
        if not xs and not ys:
            continue
        row = judge_samples(xs, ys, higher_is_better=higher)
        row["metric"] = metric
        metrics.append(row)
    if metrics:
        out["metrics"] = metrics
    else:
        out["absent"] = (
            "no per-chunk perf samples in either run "
            "(sim_perf.jsonl missing or empty)"
        )
    # one-number ledger summaries: the same extraction `tg perf
    # --compare` prints — effect sizes only, no verdict (n=1)
    scalars = [
        {
            "metric": r["metric"],
            "a": r["baseline"],
            "b": r["current"],
            "ratio": round(r["ratio"], 6),
        }
        for r in ledger_scalars(
            {"sim": _dict(b.get("sim"))}, {"sim": _dict(a.get("sim"))}
        )
    ]
    if scalars:
        out["scalars"] = scalars
    return out


# ------------------------------------------------------ the document


def _run_ident(snapshot: dict) -> dict:
    sim = _dict(snapshot.get("sim"))
    rc = _dict(
        _dict(_dict(snapshot.get("composition")).get("global")).get("run_config")
    )
    ident = {
        "task_id": snapshot.get("task_id"),
        "plan": snapshot.get("plan"),
        "case": snapshot.get("case"),
        "state": snapshot.get("state"),
        "outcome": snapshot.get("outcome"),
        "seed": rc.get("seed", 0),
    }
    if num(sim.get("ticks")) is not None:
        ident["ticks"] = sim.get("ticks")
    if num(sim.get("wall_secs")) is not None:
        ident["wall_secs"] = sim.get("wall_secs")
    return ident


def build_run_diff(a: dict, b: dict, planes=None) -> dict:
    """Assemble the RunDiff document from two :func:`task_snapshot`
    results. Pure host-side arithmetic; never raises on sparse or
    corrupt snapshots (absent planes are reported, not crashed on).

    Document contract (docs/OBSERVABILITY.md "Run diff"): ``a`` is the
    baseline, ``b`` the candidate. ``setup.identical`` records whether
    the scrubbed compositions match — when True, every exact-plane
    mismatch lands in ``findings`` with severity ``correctness``; when
    False the mismatched rows are still reported but stay informational
    (different setups legitimately count differently). ``verdict`` is
    the roll-up: ``findings`` > ``mixed`` > ``regressed`` > ``improved``
    > ``clean``.
    """
    planes = validate_planes(planes)
    a, b = _dict(a), _dict(b)
    setup_a, setup_b = _scrub_setup(a.get("composition")), _scrub_setup(
        b.get("composition")
    )
    have_setups = bool(setup_a) and bool(setup_b)
    identical = have_setups and setup_a == setup_b
    setup: dict[str, Any] = {"identical": identical}
    if have_setups and not identical:
        setup["diffs"] = _setup_diff_paths(setup_a, setup_b)
    elif not have_setups:
        setup["note"] = "composition missing on one side; assuming different"
    doc: dict[str, Any] = {
        "a": _run_ident(a),
        "b": _run_ident(b),
        "planes": list(planes),
        "setup": setup,
    }
    builders = {
        "counters": _plane_counters,
        "perf": _plane_perf,
        "latency": _plane_latency,
        "phases": _plane_phases,
        "slo": _plane_slo,
        "netmatrix": _plane_netmatrix,
    }
    findings: list[dict] = []
    for plane in planes:
        try:
            block = builders[plane](a, b)
        except Exception as exc:  # noqa: BLE001 — analysis never crashes
            block = {"absent": f"plane failed to build: {exc}"}
        doc[plane] = block
        if plane == "perf":
            continue
        for row in block.get("rows") or []:
            if row["equal"]:
                continue
            if identical:
                # same scrubbed composition + seed ⇒ the program is
                # deterministic ⇒ this is a correctness finding
                findings.append(
                    {
                        "plane": plane,
                        "name": row["name"],
                        "a": row["a"],
                        "b": row["b"],
                        "severity": "correctness",
                    }
                )
    doc["findings"] = findings
    regressed: list[str] = []
    improved: list[str] = []
    for row in _dict(doc.get("perf")).get("metrics") or []:
        if row.get("verdict") == "regressed":
            regressed.append(row["metric"])
        elif row.get("verdict") == "improved":
            improved.append(row["metric"])
    doc["regressed"] = regressed
    doc["improved"] = improved
    if findings:
        doc["verdict"] = "findings"
    elif regressed and improved:
        doc["verdict"] = "mixed"
    elif regressed:
        doc["verdict"] = "regressed"
    elif improved:
        doc["verdict"] = "improved"
    else:
        doc["verdict"] = "clean"
    return doc
