"""The runner interface, run result types and the outputs layout (copies
of the reference's ``testground_tpu/runners`` definitions). The port's one
runner is ``sim:torch`` (``testground_tpu_torch.sim.runner``)."""

from .base import HealthcheckedRunner, Runner, Terminatable
from .outputs import collect_run_outputs, find_run_dir, instance_output_dir
from .result import GroupOutcome, Result

__all__ = [
    "GroupOutcome",
    "HealthcheckedRunner",
    "Result",
    "Runner",
    "Terminatable",
    "collect_run_outputs",
    "find_run_dir",
    "instance_output_dir",
]
