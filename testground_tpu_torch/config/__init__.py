"""Environment configuration: ``$TESTGROUND_HOME`` layout, ``.env.toml``
loading, and config coalescing (the port's copy of the reference's
``testground_tpu/config``)."""

from .coalescing import CoalescedConfig
from .dirs import Directories
from .env import (
    DEFAULT_TASK_TIMEOUT_MIN,
    RUNNER_DISABLED_FLAG,
    ClientConfig,
    DaemonConfig,
    EnvConfig,
    SchedulerConfig,
)

__all__ = [
    "CoalescedConfig",
    "ClientConfig",
    "DaemonConfig",
    "DEFAULT_TASK_TIMEOUT_MIN",
    "Directories",
    "EnvConfig",
    "RUNNER_DISABLED_FLAG",
    "SchedulerConfig",
]
