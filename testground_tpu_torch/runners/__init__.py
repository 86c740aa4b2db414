"""The runner interface, run result types and the outputs layout (copies
of the reference's ``testground_tpu/runners`` definitions). The port's one
runner is ``sim:torch`` (``testground_tpu_torch.sim.runner``)."""

from .base import HealthcheckedRunner, Runner
from .outputs import instance_output_dir
from .result import GroupOutcome, Result

__all__ = [
    "GroupOutcome",
    "HealthcheckedRunner",
    "Result",
    "Runner",
    "instance_output_dir",
]
