"""Run health plane: SLO assertions evaluated once per chunk — the port's
copy of the reference's ``testground_tpu/sim/slo.py`` (numpy and the
telemetry schema only; ``tests/test_torch_slo.py`` pins it against the
original).

A composition declares service-level objectives in ``[[global.run.slo]]``
/ ``[[groups.run.slo]]`` tables (metric + comparator + threshold +
evaluation window + severity); they lower into a static :class:`SloPlan`,
and a host-side :class:`SloEvaluator` checks every rule once per chunk
against the telemetry blocks and latency-histogram deltas that
``SimProgram.run`` already copies to the host. The program is untouched
and no host read is added. Every metric derives from the telemetry plane,
so the executor refuses rules without it. Breaches stream to
``sim_slo.jsonl``, aggregate into the journal's ``slo`` block, and a
``severity = "fail"`` breach cancels the run through the chunk loop's
cancel path with a :class:`SloBreachError` that carries the assembled run
result.
"""

from __future__ import annotations

import dataclasses
import json
from collections import deque

import numpy as np

from .telemetry import latency_percentiles

__all__ = [
    "SLO_FILE",
    "SLO_METRICS",
    "SLO_OPS",
    "SloBreachError",
    "SloEvaluator",
    "SloPlan",
    "SloRule",
    "build_slo_plan",
    "parse_slo",
]

# Per-run breach-record stream (under <outputs>/<plan>/<run_id>/): one
# JSON line per breaching evaluation, appended the chunk it fires —
# survives a canceled/failed run, feeds GET /stream and `tg watch`.
SLO_FILE = "sim_slo.jsonl"

# Metrics a rule may assert, and where each is computed from:
#
#   latency_p50_ticks / latency_p95_ticks / latency_p99_ticks
#       delivery-latency percentile in TICKS, estimated from the
#       per-receiver-group log2 histograms (telemetry plane) summed over
#       the evaluation window; a ``group`` key scopes it to one
#       receiver group, else all groups aggregate. Skipped (no breach
#       possible) while the window holds zero deliveries.
#   delivered_per_tick
#       mean messages delivered per simulated tick over the window.
#   drop_rate
#       (dropped + fault_dropped) / sent over the window; skipped while
#       the window holds zero sends.
#   crashed_fraction
#       currently-crashed fraction of the fleet: cumulative
#       (faults_crashed - faults_restarted) / instances — a STATE
#       metric, so the window does not apply (the current value is
#       asserted each evaluation).
#
# delivered_per_tick / drop_rate / crashed_fraction are run-global (the
# counter block is run-global); only the latency metrics accept a
# ``group`` scope.
SLO_METRICS = (
    "latency_p50_ticks",
    "latency_p95_ticks",
    "latency_p99_ticks",
    "delivered_per_tick",
    "drop_rate",
    "crashed_fraction",
)
_LATENCY_METRICS = {
    "latency_p50_ticks": 0.50,
    "latency_p95_ticks": 0.95,
    "latency_p99_ticks": 0.99,
}

# Comparators state what must HOLD; a breach is the assertion failing.
SLO_OPS = {
    "<": lambda a, b: a < b,
    "<=": lambda a, b: a <= b,
    ">": lambda a, b: a > b,
    ">=": lambda a, b: a >= b,
}

_SEVERITIES = ("warn", "fail")

# Keys a [[run.slo]] table may carry — an unknown key is a typo'd rule,
# and a silently-ignored key is an SLO that never fires (the fault/trace
# plane's loud-refusal policy).
_KNOWN_KEYS = {
    "name",
    "metric",
    "op",
    "threshold",
    "window_ticks",
    "severity",
    "group",
}

# Bounded per-rule breach records kept in the journal (the jsonl stream
# keeps everything): a soak breaching every chunk for a week must not
# grow the task record unboundedly.
JOURNAL_RECORDS_CAP = 20


class SloBreachError(RuntimeError):
    """A ``severity = "fail"`` SLO breached: the run was canceled at the
    chunk boundary. ``breach`` is the structured record; ``run_output``
    (attached by the executor) carries the fully-assembled RunOutput —
    journal included — so the supervisor can archive the failed run's
    complete telemetry record instead of a bare error string."""

    def __init__(self, breach: dict):
        self.breach = dict(breach)
        self.run_output = None  # attached by the executor before raising
        super().__init__(
            "SLO breach ({severity}): {rule} — {metric} = {observed:g} "
            "violates {op} {threshold:g} over window ticks "
            "[{lo}, {hi}]".format(
                severity=breach.get("severity", "fail"),
                rule=breach.get("rule", "?"),
                metric=breach.get("metric", "?"),
                observed=float(breach.get("observed", float("nan"))),
                op=breach.get("op", "?"),
                threshold=float(breach.get("threshold", float("nan"))),
                lo=breach.get("window", [0, 0])[0],
                hi=breach.get("window", [0, 0])[1],
            )
        )


@dataclasses.dataclass(frozen=True)
class SloRule:
    """One validated SLO assertion (still declaration-shaped; the
    evaluator resolves groups/windows against the run layout)."""

    name: str
    metric: str
    op: str
    threshold: float
    window_ticks: int = 0  # 0 = whole run so far
    severity: str = "warn"
    group: str = ""  # latency metrics only; "" = all receiver groups

    def describe(self) -> str:
        win = (
            f"last {self.window_ticks} tick(s)"
            if self.window_ticks
            else "whole run"
        )
        return (
            f"{self.name}: {self.metric} {self.op} {self.threshold:g} "
            f"over {win} [{self.severity}]"
        )


@dataclasses.dataclass(frozen=True)
class SloPlan:
    """The lowered SLO declaration: a static rule tuple. ``None`` (from
    :func:`build_slo_plan`) means nothing declared — the run then pays
    nothing, not even the evaluator object."""

    rules: tuple  # tuple[SloRule, ...]

    @property
    def count(self) -> int:
        return len(self.rules)

    def max_window_ticks(self) -> int:
        """Longest finite window any rule needs — bounds the evaluator's
        per-chunk ring buffer. 0 when every rule is whole-run (the
        evaluator then keeps cumulative sums only)."""
        return max((r.window_ticks for r in self.rules), default=0)

    def has_fail(self) -> bool:
        return any(r.severity == "fail" for r in self.rules)

    def summary(self) -> str:
        shown = "; ".join(r.describe() for r in self.rules[:4])
        if self.count > 4:
            shown += "; …"
        return f"{self.count} rule(s): {shown}"


def parse_slo(d: dict, default_group: str = "", index: int = 0) -> SloRule:
    """Validate one raw ``[[...run.slo]]`` table → :class:`SloRule`.

    ``default_group`` scopes a group-level declaration of a *latency*
    metric to its own receiver group when no explicit ``group`` key is
    given (run-global tables pass ``""``) — the ``faults.parse_fault``
    scoping rule. Run-global metrics (delivered_per_tick / drop_rate /
    crashed_fraction) refuse BOTH an explicit ``group`` key and a
    group-level (``[[groups.run.slo]]``) placement: the counter block
    they derive from is run-global, and a silently ignored scope —
    written or implied — would assert something other than what the
    operator declared."""
    if not isinstance(d, dict):
        raise ValueError(
            f"slo entry must be a table, got {type(d).__name__}"
        )
    unknown = set(d) - _KNOWN_KEYS
    if unknown:
        raise ValueError(
            f"slo entry has unknown key(s) {sorted(unknown)}; known "
            f"keys: {sorted(_KNOWN_KEYS)}"
        )
    metric = str(d.get("metric", ""))
    if metric not in SLO_METRICS:
        raise ValueError(
            f"unknown slo metric {metric!r}; metrics: {list(SLO_METRICS)}"
        )
    op = str(d.get("op", ""))
    if op not in SLO_OPS:
        raise ValueError(
            f"unknown slo op {op!r}; ops: {sorted(SLO_OPS)}"
        )
    if "threshold" not in d or isinstance(d["threshold"], bool):
        raise ValueError(f"slo {metric}: a numeric threshold is required")
    try:
        threshold = float(d["threshold"])
    except (TypeError, ValueError):
        raise ValueError(
            f"slo {metric}: threshold {d['threshold']!r} is not a number"
        ) from None
    if not np.isfinite(threshold):
        raise ValueError(f"slo {metric}: threshold must be finite")
    wt_raw = d.get("window_ticks", 0)
    if isinstance(wt_raw, bool) or (
        isinstance(wt_raw, float) and not wt_raw.is_integer()
    ):
        raise ValueError(
            f"slo {metric}: window_ticks {wt_raw!r} must be a whole "
            "number of ticks"
        )
    try:
        window_ticks = int(wt_raw)
    except (TypeError, ValueError):
        raise ValueError(
            f"slo {metric}: window_ticks {wt_raw!r} is not an integer"
        ) from None
    if window_ticks < 0:
        raise ValueError(
            f"slo {metric}: window_ticks {window_ticks} must be >= 0 "
            "(0 = whole run)"
        )
    severity = str(d.get("severity", "warn"))
    if severity not in _SEVERITIES:
        raise ValueError(
            f"slo {metric}: severity {severity!r} must be one of "
            f"{list(_SEVERITIES)}"
        )
    explicit_group = str(d.get("group", ""))
    if metric in _LATENCY_METRICS:
        group = explicit_group or default_group
    else:
        if explicit_group or default_group:
            raise ValueError(
                f"slo {metric}: the metric is computed from run-global "
                "counters and cannot be scoped to group "
                f"{(explicit_group or default_group)!r} — declare it "
                "under [[global.run.slo]] (only the latency_* metrics "
                "are per receiver group)"
            )
        group = ""
    name = str(d.get("name", "")) or (
        f"{metric}{'@' + group if group else ''}#{index}"
    )
    return SloRule(
        name=name,
        metric=metric,
        op=op,
        threshold=threshold,
        window_ticks=window_ticks,
        severity=severity,
        group=group,
    )


def build_slo_plan(groups, slo_by_group: dict) -> SloPlan | None:
    """Validate + lower every declared SLO table into one static plan.

    ``groups`` is the resolved ``GroupSpec`` layout; ``slo_by_group``
    maps group id → list of raw ``[[groups.run.slo]]`` tables (key
    ``""`` holds the run-global ``[[global.run.slo]]`` list) — the exact
    shape of ``fault_specs_of``. Returns ``None`` when nothing is
    declared. Duplicate rule names are refused (a breach record must
    name its rule unambiguously)."""
    known = {g.id for g in groups}
    rules: list[SloRule] = []
    idx = 0
    for gid in sorted(slo_by_group or {}):
        for table in slo_by_group[gid] or []:
            rule = parse_slo(table, default_group=gid, index=idx)
            idx += 1
            if rule.group and rule.group not in known:
                raise ValueError(
                    f"slo {rule.name} targets unknown group "
                    f"{rule.group!r}; run groups are {sorted(known)}"
                )
            rules.append(rule)
    if not rules:
        return None
    names = [r.name for r in rules]
    dupes = sorted({n for n in names if names.count(n) > 1})
    if dupes:
        raise ValueError(
            f"duplicate slo rule name(s) {dupes}: give each rule a "
            "distinct 'name'"
        )
    return SloPlan(rules=tuple(rules))


class SloEvaluator:
    """Host-side per-chunk SLO evaluation over the run's own metric
    stream. Fed by the executor from state the run loop already holds:

    - :meth:`on_rows` — the chunk's decoded telemetry rows (the
      ``sim_timeseries.jsonl`` writer decodes them anyway);
    - :meth:`on_lat_delta` — the chunk's ``[G, LATENCY_BINS]``
      latency-histogram delta (flushed-and-zeroed each dispatch);
    - :meth:`evaluate` — once per chunk, after both: checks every rule,
      streams breach records to ``sim_slo.jsonl``, and on the first
      ``fail``-severity breach sets the run-cancel event so the chunk
      loop stops before the next dispatch.

    No device reads, no program shaping — pure python over numpy blocks
    that were already host-resident (the zero-overhead contract)."""

    def __init__(
        self,
        plan: SloPlan,
        groups,
        tick_ms: float,
        chunk: int,
        ident: dict | None = None,
        path: str | None = None,
        cancel=None,
        append: bool = False,
    ):
        self.plan = plan
        self.group_ids = tuple(g.id for g in groups)
        self.n_instances = int(sum(g.count for g in groups))
        self.tick_ms = float(tick_ms)
        self.chunk = max(int(chunk), 1)
        self.ident = dict(ident or {})
        self.path = path
        self._cancel = cancel
        self.fatal: dict | None = None
        self.records_written = 0
        # per-rule aggregation for the journal
        self._agg: dict[str, dict] = {
            r.name: {"breaches": 0, "worst": None, "last_observed": None}
            for r in plan.rules
        }
        self._records: list[dict] = []  # bounded (JOURNAL_RECORDS_CAP)
        # windowed state: ring of per-chunk summaries, sized by the
        # longest finite window (whole-run rules use cumulative sums)
        max_win = plan.max_window_ticks()
        self._ring_chunks = (
            -(-max_win // self.chunk) if max_win else 0
        )  # ceil
        self._ring: deque = deque()
        self._cum = {
            k: 0
            for k in (
                "ticks",
                "delivered",
                "sent",
                "dropped",
                "fault_dropped",
                "faults_crashed",
                "faults_restarted",
            )
        }
        self._cum_lat = None  # [G, LATENCY_BINS] int64 once fed
        self._pending_rows: list[dict] = []
        self._pending_lat = None
        self._last_tick = -1
        self._f = None
        if path is not None:
            try:
                # append mode: a resumed run (sim/checkpoint.py) continues
                # the record stream past the snapshot's truncated prefix
                self._f = open(path, "a" if append else "w")
            except OSError:  # observe best-effort, never fail the run
                self.path = None

    # ------------------------------------------------- checkpoint state
    # The evaluator's whole mutable state is JSON-able by construction
    # (python ints/floats + the int64 histogram arrays): it rides run
    # checkpoints so a resumed run judges windowed rules against the
    # same history an uninterrupted run would (docs/CHECKPOINT.md).

    def state_dict(self) -> dict:
        return {
            "agg": {k: dict(v) for k, v in self._agg.items()},
            "records": [dict(r) for r in self._records],
            "records_written": self.records_written,
            "cum": dict(self._cum),
            "cum_lat": (
                self._cum_lat.tolist() if self._cum_lat is not None else None
            ),
            "ring": [
                {
                    **{k: s[k] for k in s if k != "lat"},
                    "lat": (
                        s["lat"].tolist() if s["lat"] is not None else None
                    ),
                }
                for s in self._ring
            ],
            "last_tick": self._last_tick,
            "fatal": dict(self.fatal) if self.fatal is not None else None,
        }

    def load_state(self, state: dict) -> None:
        for name, agg in (state.get("agg") or {}).items():
            if name in self._agg:
                self._agg[name] = dict(agg)
        self._records = [dict(r) for r in state.get("records", [])]
        self.records_written = int(state.get("records_written", 0))
        for k in self._cum:
            self._cum[k] = int((state.get("cum") or {}).get(k, 0))
        cl = state.get("cum_lat")
        self._cum_lat = (
            np.asarray(cl, dtype=np.int64) if cl is not None else None
        )
        self._ring.clear()
        for s in state.get("ring") or []:
            lat = s.get("lat")
            self._ring.append(
                {
                    **{k: v for k, v in s.items() if k != "lat"},
                    "lat": (
                        np.asarray(lat, dtype=np.int64)
                        if lat is not None
                        else None
                    ),
                }
            )
        self._last_tick = int(state.get("last_tick", -1))
        fatal = state.get("fatal")
        self.fatal = dict(fatal) if fatal else None

    # ------------------------------------------------------------- feeding

    def on_rows(self, rows: list[dict]) -> None:
        """One chunk's decoded telemetry rows (padding already dropped)."""
        self._pending_rows.extend(rows)

    def on_lat_delta(self, delta) -> None:
        """One chunk's [G, LATENCY_BINS] histogram delta (host numpy)."""
        d = np.asarray(delta, dtype=np.int64)
        self._pending_lat = (
            d if self._pending_lat is None else self._pending_lat + d
        )

    # ---------------------------------------------------------- evaluation

    def _fold_chunk(self) -> dict:
        """Pending rows + lat delta → one chunk summary, folded into the
        cumulative sums and the window ring."""
        rows = self._pending_rows
        self._pending_rows = []
        lat = self._pending_lat
        self._pending_lat = None
        summ = {
            "ticks": len(rows),
            "delivered": sum(r.get("delivered", 0) for r in rows),
            "sent": sum(r.get("sent", 0) for r in rows),
            "dropped": sum(r.get("dropped", 0) for r in rows),
            "fault_dropped": sum(r.get("fault_dropped", 0) for r in rows),
            "faults_crashed": sum(r.get("faults_crashed", 0) for r in rows),
            "faults_restarted": sum(
                r.get("faults_restarted", 0) for r in rows
            ),
            "lat": lat,
        }
        if rows:
            self._last_tick = max(self._last_tick, rows[-1].get("tick", -1))
        for k in self._cum:
            self._cum[k] += summ[k]
        if lat is not None:
            self._cum_lat = (
                lat.copy() if self._cum_lat is None else self._cum_lat + lat
            )
        if self._ring_chunks:
            self._ring.append(summ)
            while len(self._ring) > self._ring_chunks:
                self._ring.popleft()
        return summ

    def _window(self, rule: SloRule) -> tuple[dict, "np.ndarray | None", int]:
        """(counter sums, summed lat histogram | None, window ticks) for
        one rule's evaluation window."""
        if not rule.window_ticks:
            return self._cum, self._cum_lat, self._cum["ticks"]
        need = -(-rule.window_ticks // self.chunk)  # ceil → whole chunks
        chunks = list(self._ring)[-need:]
        sums = {
            k: sum(c[k] for c in chunks) for k in self._cum
        }
        lats = [c["lat"] for c in chunks if c["lat"] is not None]
        lat = np.sum(lats, axis=0) if lats else None
        return sums, lat, sums["ticks"]

    def _observe(self, rule: SloRule):
        """``(observed value, window ticks)`` for a rule — the value is
        None when the window holds no evidence (zero deliveries / zero
        sends / zero ticks).

        A windowed rule is not evaluated until the run has produced a
        FULL window of history (the Prometheus ``for``-clause rule): a
        1024-tick window assessed after the first 256-tick chunk would
        judge warmup noise — a joins-and-sync first chunk could fail a
        perfectly healthy soak. State metrics (crashed_fraction) are
        window-exempt and evaluate from the first chunk."""
        if (
            rule.window_ticks
            and rule.metric != "crashed_fraction"
            and self._cum["ticks"] < rule.window_ticks
        ):
            return None, 0
        sums, lat, ticks = self._window(rule)
        if rule.metric in _LATENCY_METRICS:
            if lat is None:
                return None, ticks
            if rule.group:
                gi = self.group_ids.index(rule.group)
                hist = lat[gi]
            else:
                hist = lat.sum(axis=0)
            if int(hist.sum()) == 0:
                return None, ticks
            q = _LATENCY_METRICS[rule.metric]
            # tick_ms=1.0 → the "_ms" value IS ticks (one estimator for
            # the journal percentiles and the SLO plane)
            pct = latency_percentiles(hist, 1.0, quantiles=(q,))
            return pct.get(f"p{int(q * 100)}_ms"), ticks
        if rule.metric == "delivered_per_tick":
            if ticks <= 0:
                return None, ticks
            return sums["delivered"] / ticks, ticks
        if rule.metric == "drop_rate":
            if sums["sent"] <= 0:
                return None, ticks
            return (
                (sums["dropped"] + sums["fault_dropped"]) / sums["sent"],
                ticks,
            )
        if rule.metric == "crashed_fraction":
            # state metric: cumulative regardless of window
            crashed = (
                self._cum["faults_crashed"] - self._cum["faults_restarted"]
            )
            return crashed / max(self.n_instances, 1), ticks
        raise AssertionError(f"unhandled metric {rule.metric}")

    def evaluate(self) -> list[dict]:
        """Run every rule against the just-folded chunk; returns the new
        breach records (empty when everything holds)."""
        self._fold_chunk()
        breaches: list[dict] = []
        for rule in self.plan.rules:
            observed, win_ticks = self._observe(rule)
            agg = self._agg[rule.name]
            if observed is None:
                continue
            agg["last_observed"] = float(observed)
            if SLO_OPS[rule.op](observed, rule.threshold):
                continue  # the assertion holds
            breach = {
                "rule": rule.name,
                "metric": rule.metric,
                "op": rule.op,
                "threshold": rule.threshold,
                "observed": float(observed),
                "severity": rule.severity,
                "group": rule.group,
                "tick": int(self._last_tick),
                # inclusive tick bounds of the evidence window (clamped
                # at 0: ticks are 0-based, a whole-run window starts at
                # the first tick)
                "window": [
                    max(int(self._last_tick) - int(win_ticks) + 1, 0),
                    int(self._last_tick),
                ],
            }
            breaches.append(breach)
            agg["breaches"] += 1
            agg.setdefault("first_tick", breach["tick"])
            agg["last_tick"] = breach["tick"]
            # "worst" = farthest past the threshold, by the comparator's
            # own direction
            worst = agg["worst"]
            if worst is None or (
                abs(observed - rule.threshold) > abs(worst - rule.threshold)
            ):
                agg["worst"] = float(observed)
            if len(self._records) < JOURNAL_RECORDS_CAP:
                self._records.append(breach)
            self._write(breach)
            if rule.severity == "fail" and self.fatal is None:
                self.fatal = breach
                if self._cancel is not None:
                    self._cancel.set()
        return breaches

    # ------------------------------------------------------------- outputs

    def _write(self, breach: dict) -> None:
        self.records_written += 1
        if self._f is None:
            return
        try:
            self._f.write(json.dumps({**self.ident, **breach}) + "\n")
            self._f.flush()
        except (OSError, ValueError):
            try:
                self._f.close()
            except OSError:
                pass
            self._f = None
            self.path = None

    def close(self) -> None:
        if self._f is not None:
            try:
                self._f.close()
            except OSError:
                self.path = None
            finally:
                self._f = None

    def journal(self) -> dict:
        """The journal ``slo`` block: rule verdicts + bounded breach
        records (the jsonl stream keeps every record)."""
        total = sum(a["breaches"] for a in self._agg.values())
        out: dict = {
            "rules": [
                {
                    "name": r.name,
                    "metric": r.metric,
                    "op": r.op,
                    "threshold": r.threshold,
                    "window_ticks": r.window_ticks,
                    "severity": r.severity,
                    **({"group": r.group} if r.group else {}),
                    "breaches": self._agg[r.name]["breaches"],
                    **(
                        {
                            "first_tick": self._agg[r.name]["first_tick"],
                            "last_tick": self._agg[r.name]["last_tick"],
                            "worst": self._agg[r.name]["worst"],
                        }
                        if self._agg[r.name]["breaches"]
                        else {}
                    ),
                    **(
                        {
                            "last_observed": self._agg[r.name][
                                "last_observed"
                            ]
                        }
                        if self._agg[r.name]["last_observed"] is not None
                        else {}
                    ),
                }
                for r in self.plan.rules
            ],
            "breaches": total,
        }
        if self.path is not None:
            out["file"] = SLO_FILE
        if self._records:
            out["records"] = list(self._records)
            if total > len(self._records):
                out["records_truncated"] = total - len(self._records)
        return out
