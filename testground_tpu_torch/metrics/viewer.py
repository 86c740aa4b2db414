"""Row expansions and measurement names the Influx mirror needs — the
port's copy of ``expand_sim_row``, ``expand_perf_row``, ``clean`` and
``measurement_name`` of the reference's ``testground_tpu/metrics/viewer.py``
(``pkg/metrics/viewer.go``). The dashboard's viewer over the run files
comes with the dashboard (ROADMAP queue 1 item 9f-b).

The sim telemetry plane's per-tick counters (``sim_timeseries.jsonl``)
surface as measurement ``sim.<counter>`` (group_id ``_run``, since the
counters are run-global), and the per-group live counts as ``sim.live``
dimensioned by group_id; the perf ledger's rows (``sim_perf.jsonl``) as
``sim.perf.<gauge>``. Counter rows carry the raw per-tick value in every
field slot (count/mean/min/max), the shape the Influx mirror writes.
"""

from __future__ import annotations

__all__ = ["clean", "expand_perf_row", "expand_sim_row", "measurement_name"]

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
