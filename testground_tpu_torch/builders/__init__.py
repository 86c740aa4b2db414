"""Builder interface and the ``sim:plan`` builder (the port's copies of the
reference's ``testground_tpu/builders``; ``pkg/build``)."""

from .base import Builder, purge_snapshots
from .sim_plan import SimPlanBuilder

__all__ = ["Builder", "SimPlanBuilder", "purge_snapshots"]
