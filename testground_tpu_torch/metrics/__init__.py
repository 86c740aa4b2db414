"""The metrics query layer — the port's copy of the reference's
``testground_tpu/metrics``: the dashboard's viewer over the per-run series
files, the Prometheus exposition behind ``GET /metrics``, and the Influx
mirror of a run's metric series."""

from .influx import push_rows, rows_to_lines
from .prometheus import render_prometheus
from .viewer import Row, Viewer, clean, expand_sim_row, measurement_name

__all__ = [
    "Row",
    "Viewer",
    "clean",
    "expand_sim_row",
    "measurement_name",
    "push_rows",
    "render_prometheus",
    "rows_to_lines",
]
