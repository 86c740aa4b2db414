"""Run result types and the outputs layout (copies of the reference's
``testground_tpu/runners`` definitions the executor needs)."""

from .outputs import instance_output_dir
from .result import GroupOutcome, Result

__all__ = ["GroupOutcome", "Result", "instance_output_dir"]
