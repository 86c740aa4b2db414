"""Measurement viewer behind the daemon's dashboard — the port's copy of
the reference's ``testground_tpu/metrics/viewer.py`` (``pkg/metrics/
viewer.go``: ``GetMeasurements`` / ``GetTags`` / ``GetData`` against
InfluxDB's ``results.<plan>-<case>.*`` measurements), with the row
expansions and measurement names the Influx mirror shares.

The viewer scans a run's files under ``<outputs>/<plan>/<run-id>/``: the
plan metrics the executor reduces per group on a tick cadence
(``timeseries.jsonl``), the telemetry plane's per-tick counters
(``sim_timeseries.jsonl``), the per-group latency summary
(``sim_latency.jsonl``) and the perf ledger's rows (``sim_perf.jsonl``).
Measurement names keep the reference's ``results.<plan>-<case>.<metric>``
shape, so dashboard URLs and labels look the same.

The telemetry counters surface as measurement ``sim.<counter>`` (group_id
``_run``, since the counters are run-global), and the per-group live
counts as ``sim.live`` dimensioned by group_id; the perf ledger's rows as
``sim.perf.<gauge>``. Counter rows carry the raw per-tick value in every
field slot (count/mean/min/max), so the dashboard's tables and the Influx
mirror render them unchanged.
"""

from __future__ import annotations

import dataclasses
import os

from ..config import EnvConfig
from ..sim.telemetry import LATENCY_FILE, PERF_FILE, SIM_SERIES_FILE, iter_jsonl

__all__ = [
    "Row",
    "Viewer",
    "clean",
    "expand_perf_row",
    "expand_sim_row",
    "measurement_name",
]

# Tag keys that identify rather than dimension a series — excluded from the
# dashboard's tag pickers like the reference's tagsIgnoreList
# (``viewer.go:13-22``).
TAGS_IGNORE = {"plan", "case", "group_id", "run"}

# Keys of a sim telemetry row that identify rather than measure.
_SIM_IDENTITY = {"run", "plan", "case", "tick"}
# ... and of a perf ledger row, which also carries its chunk index.
_PERF_IDENTITY = _SIM_IDENTITY | {"chunk"}


def expand_sim_row(row: dict, prefix: str = "sim", identity=None):
    """One open-format jsonl counter row → viewer-shaped rows, one per
    counter: measurement ``<prefix>.<counter>`` with the per-tick value
    in every field slot, and ``<prefix>.live`` per group from a nested
    live map. Non-numeric values are skipped (the jsonl is an open
    format)."""
    if identity is None:
        identity = _SIM_IDENTITY
    base = {k: row.get(k, "") for k in ("run", "plan", "case")}
    tick = row.get("tick", 0)
    for key, val in row.items():
        if key in identity:
            continue
        if key == "live" and isinstance(val, dict):
            for gid, v in val.items():
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    yield {
                        **base,
                        "tick": tick,
                        "group_id": str(gid),
                        "name": f"{prefix}.live",
                        "count": v,
                        "mean": v,
                        "min": v,
                        "max": v,
                    }
            continue
        if not isinstance(val, (int, float)) or isinstance(val, bool):
            continue
        yield {
            **base,
            "tick": tick,
            "group_id": "_run",
            "name": f"{prefix}.{key}",
            "count": val,
            "mean": val,
            "min": val,
            "max": val,
        }


def expand_perf_row(row: dict):
    """One sim_perf.jsonl row (the perf ledger, sim/perf.py) → the
    ``sim.perf.<gauge>`` measurement family (group_id ``_run``, like the
    counter family)."""
    yield from expand_sim_row(row, prefix="sim.perf", identity=_PERF_IDENTITY)


def clean(name: str) -> str:
    """Measurement-name sanitizer (``dashboard.go:112-118``)."""
    return name.replace("/", "-")


def measurement_name(plan: str, case: str, metric: str) -> str:
    return f"results.{clean(plan)}-{case}.{metric}"


@dataclasses.dataclass
class Row:
    """One sampled reduction (the viewer.go ``Row`` analog: Run + Timestamp
    + Fields, with simulated ticks standing in for wall timestamps)."""

    run: str
    tick: int
    group_id: str
    fields: dict  # count/mean/min/max

    def to_dict(self) -> dict:
        return {
            "run": self.run,
            "tick": self.tick,
            "group_id": self.group_id,
            **self.fields,
        }


class Viewer:
    def __init__(self, env: EnvConfig | None = None):
        self.env = env or EnvConfig.load()

    # ------------------------------------------------------------- scanning

    def _run_dirs(self, plan: str):
        """Yield (run_id, plan-metric series path | None, sim telemetry
        series path | None, latency summary path | None, perf ledger
        path | None) for every run dir carrying any of the four
        families."""
        root = os.path.join(self.env.dirs.outputs(), plan)
        if not os.path.isdir(root):
            return
        for run_id in sorted(os.listdir(root)):
            paths = [
                os.path.join(root, run_id, name)
                for name in (
                    "timeseries.jsonl",
                    SIM_SERIES_FILE,
                    LATENCY_FILE,
                    PERF_FILE,
                )
            ]
            present = [p if os.path.isfile(p) else None for p in paths]
            if any(present):
                yield (run_id, *present)

    @staticmethod
    def _read_jsonl(path: str):
        # the shared tolerant reader (sim/telemetry.py)
        yield from iter_jsonl(path)

    def _iter_rows(self, plan: str, case: str | None, run_id: str | None):
        for rid, ts_path, sim_path, lat_path, perf_path in self._run_dirs(
            plan
        ):
            # a task's runs are <task-id> (single run) or <task-id>-<run-id>
            # (multi-run [[runs]] compositions — supervisor run_id scheme),
            # so a task-scoped query matches both
            if (
                run_id is not None
                and rid != run_id
                and not rid.startswith(run_id + "-")
            ):
                continue
            if ts_path is not None:
                for row in self._read_jsonl(ts_path):
                    if case is not None and row.get("case") != case:
                        continue
                    yield row
            if sim_path is not None:
                for row in self._read_jsonl(sim_path):
                    if case is not None and row.get("case") != case:
                        continue
                    yield from expand_sim_row(row)
            if lat_path is not None:
                # latency rows are written viewer-shaped — no expansion
                for row in self._read_jsonl(lat_path):
                    if case is not None and row.get("case") != case:
                        continue
                    yield row
            if perf_path is not None:
                for row in self._read_jsonl(perf_path):
                    if case is not None and row.get("case") != case:
                        continue
                    yield from expand_perf_row(row)

    # ---------------------------------------------------------------- query

    def get_measurements(
        self, plan: str, case: str, run_id: str | None = None, limit: int = 20
    ) -> list[str]:
        """Distinct measurement names for a plan:case — ``SHOW MEASUREMENTS
        … =~ /results.<name>.*/ LIMIT 20`` (``viewer.go:45-55``)."""
        names: list[str] = []
        for row in self._iter_rows(plan, case, run_id):
            name = row.get("name")
            if name and name not in names:
                names.append(name)
                if len(names) >= limit:
                    break
        return [measurement_name(plan, case, n) for n in sorted(names)]

    def get_tags(self, measurement: str) -> list[str]:
        """Extra tag keys for a measurement (``viewer.go:78-107``): the
        identity tags are filtered like the reference's ignore list, and the
        sim pipeline produces no custom tags, so this is empty — kept for
        surface parity with dashboards that render tag pickers."""
        return []

    def get_data(
        self,
        plan: str,
        case: str,
        metric: str,
        run_id: str | None = None,
    ) -> list[Row]:
        """All sampled rows of one metric, tick-ordered per run."""
        return self.get_all_data(plan, case, run_id).get(metric, [])

    def get_all_data(
        self, plan: str, case: str, run_id: str | None = None
    ) -> dict[str, list[Row]]:
        """One pass over the run's series files: every metric's rows,
        tick-ordered per run — what the dashboard renders tables from."""
        out: dict[str, list[Row]] = {}
        for row in self._iter_rows(plan, case, run_id):
            name = row.get("name")
            if not name:
                continue
            # coerce field types: the jsonl is an open format (documented
            # for external writers), so rows must not smuggle arbitrary
            # values into consumers like the HTML dashboard
            try:
                fields = {}
                if "count" in row:
                    fields["count"] = int(row["count"])
                for k in ("mean", "min", "max"):
                    if k in row:
                        fields[k] = float(row[k])
            except (TypeError, ValueError):
                continue
            out.setdefault(name, []).append(
                Row(
                    run=row.get("run", ""),
                    tick=int(row.get("tick", 0)),
                    group_id=row.get("group_id", ""),
                    fields=fields,
                )
            )
        for rows in out.values():
            rows.sort(key=lambda r: (r.run, r.group_id, r.tick))
        return out
