"""The Influx mirror of a run's metric series (the port's copy of what the
executor needs of the reference's ``testground_tpu/metrics``)."""

from .influx import push_rows, rows_to_lines
from .viewer import clean, expand_sim_row, measurement_name

__all__ = ["clean", "expand_sim_row", "measurement_name", "push_rows", "rows_to_lines"]
