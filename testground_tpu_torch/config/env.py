"""Environment configuration (``pkg/config/env.go`` + ``loader.go``).

Populated by coalescing, in descending precedence:
1. environment variables (``TESTGROUND_HOME``),
2. ``$TESTGROUND_HOME/.env.toml``,
3. defaults.

The port's own copy of the reference's ``testground_tpu/config/env.py``
(ROADMAP's copy policy); ``tests/test_torch_composition.py`` pins it against
the original.
"""

from __future__ import annotations

import os
import tomllib
from dataclasses import dataclass, field

from .dirs import Directories

ENV_TESTGROUND_HOME = "TESTGROUND_HOME"

DEFAULT_TASK_TIMEOUT_MIN = 10

# Config flag marking a runner disabled in .env.toml
# (``pkg/config/env.go:63``, enforced by the supervisor).
RUNNER_DISABLED_FLAG = "disabled"


# Only the settings the port reads are kept; the daemon's listen address,
# tokens, webhooks, worker and queue sizes, task repo and client identity
# come with the daemon (ROADMAP queue 1 item 9e). Other keys are ignored.


@dataclass
class SchedulerConfig:
    task_timeout_min: int = 0


@dataclass
class DaemonConfig:
    scheduler: SchedulerConfig = field(default_factory=SchedulerConfig)
    influxdb_endpoint: str = ""


@dataclass
class ClientConfig:
    # read only to refuse it: the CLI has no daemon to talk to yet
    endpoint: str = ""


@dataclass
class EnvConfig:
    builders: dict[str, dict] = field(default_factory=dict)
    runners: dict[str, dict] = field(default_factory=dict)
    daemon: DaemonConfig = field(default_factory=DaemonConfig)
    client: ClientConfig = field(default_factory=ClientConfig)
    dirs: Directories = field(default_factory=lambda: Directories(""))

    @classmethod
    def load(
        cls, home: str | None = None, ensure_dirs: bool = True
    ) -> "EnvConfig":
        """Resolve the home dir, read ``.env.toml`` when present, apply
        defaults, and ensure the directory layout exists
        (``pkg/config/loader.go:32-110``). ``ensure_dirs=False`` skips the
        layout creation — for healthchecks, which must observe the
        environment rather than repair it as a side effect."""
        e = cls()
        if home is None:
            home = os.environ.get(ENV_TESTGROUND_HOME) or os.path.join(
                os.path.expanduser("~"), "testground"
            )
        e.dirs = Directories(home)

        env_toml = os.path.join(home, ".env.toml")
        if os.path.isfile(env_toml):
            try:
                with open(env_toml, "rb") as f:
                    e._apply_toml(tomllib.load(f))
            except tomllib.TOMLDecodeError as err:
                raise ValueError(
                    f"found .env.toml at {env_toml}, but failed to parse: {err}"
                ) from err

        sch = e.daemon.scheduler
        sch.task_timeout_min = sch.task_timeout_min or DEFAULT_TASK_TIMEOUT_MIN
        if ensure_dirs:
            for d in e.dirs.all():
                os.makedirs(d, exist_ok=True)
        return e

    def _apply_toml(self, d: dict) -> None:
        self.builders.update(d.get("builders", {}))
        self.runners.update(d.get("runners", {}))
        dm = d.get("daemon", {})
        self.daemon.influxdb_endpoint = dm.get(
            "influxdb_endpoint", self.daemon.influxdb_endpoint
        )
        sch = dm.get("scheduler", {})
        self.daemon.scheduler.task_timeout_min = int(sch.get("task_timeout_min", 0))
        cl = d.get("client", {})
        self.client.endpoint = cl.get("endpoint", self.client.endpoint)

    def runner_config(self, runner_id: str) -> dict:
        """The raw .env.toml config map for a runner (``{}`` when absent)
        — the layer healthchecks read to probe the CONFIGURED
        environment (e.g. the sync bind host) rather than defaults."""
        cfg = self.runners.get(runner_id, {})
        return dict(cfg) if isinstance(cfg, dict) else {}

    def runner_is_disabled(self, runner_id: str) -> bool:
        """Whether .env.toml marks the runner disabled
        (``pkg/engine/supervisor.go:568-571`` semantics)."""
        cfg = self.runners.get(runner_id, {})
        return bool(cfg.get(RUNNER_DISABLED_FLAG, False))
