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

DEFAULT_LISTEN_ADDR = "localhost:8042"
DEFAULT_TASK_REPO_TYPE = "memory"
DEFAULT_WORKERS = 2
DEFAULT_QUEUE_SIZE = 100
DEFAULT_TASK_TIMEOUT_MIN = 10

# Config flag marking a runner disabled in .env.toml
# (``pkg/config/env.go:63``, enforced by the supervisor).
RUNNER_DISABLED_FLAG = "disabled"


@dataclass
class SchedulerConfig:
    workers: int = 0
    queue_size: int = 0
    task_repo_type: str = ""
    task_timeout_min: int = 0


@dataclass
class DaemonConfig:
    listen: str = ""
    scheduler: SchedulerConfig = field(default_factory=SchedulerConfig)
    tokens: list[str] = field(default_factory=list)
    slack_webhook_url: str = ""
    github_repo_status_token: str = ""
    root_url: str = ""
    influxdb_endpoint: str = ""
    # per-scrape task-label cardinality bound for GET /metrics (0 = the
    # daemon's built-in default); truncation is reported via the
    # tg_scrape_tasks_total/_elided gauges, never silent
    metrics_task_limit: int = 0


@dataclass
class ClientConfig:
    endpoint: str = ""
    token: str = ""
    user: str = ""


@dataclass
class EnvConfig:
    builders: dict[str, dict] = field(default_factory=dict)
    runners: dict[str, dict] = field(default_factory=dict)
    daemon: DaemonConfig = field(default_factory=DaemonConfig)
    client: ClientConfig = field(default_factory=ClientConfig)
    dirs: Directories = field(default_factory=lambda: Directories(""))
    # whether .env.toml explicitly chose a task repo type; the in-process
    # CLI upgrades the "memory" default to "disk" so task state survives
    # across invocations
    task_repo_explicit: bool = False

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

        e._ensure_minimal()
        if ensure_dirs:
            for d in e.dirs.all():
                os.makedirs(d, exist_ok=True)
        return e

    def _apply_toml(self, d: dict) -> None:
        self.builders.update(d.get("builders", {}))
        self.runners.update(d.get("runners", {}))
        dm = d.get("daemon", {})
        self.daemon.listen = dm.get("listen", self.daemon.listen)
        self.daemon.tokens = list(dm.get("tokens", self.daemon.tokens))
        self.daemon.slack_webhook_url = dm.get(
            "slack_webhook_url", self.daemon.slack_webhook_url
        )
        self.daemon.github_repo_status_token = dm.get(
            "github_repo_status_token", self.daemon.github_repo_status_token
        )
        self.daemon.root_url = dm.get("root_url", self.daemon.root_url)
        self.daemon.influxdb_endpoint = dm.get(
            "influxdb_endpoint", self.daemon.influxdb_endpoint
        )
        # clamp: a negative limit would slice tasks[:-n] and export the
        # OLDEST tasks — treat anything < 1 as "use the built-in default"
        self.daemon.metrics_task_limit = max(
            0,
            int(dm.get("metrics_task_limit", self.daemon.metrics_task_limit)),
        )
        sch = dm.get("scheduler", {})
        self.daemon.scheduler.workers = int(sch.get("workers", 0))
        self.daemon.scheduler.queue_size = int(sch.get("queue_size", 0))
        self.daemon.scheduler.task_repo_type = sch.get("task_repo_type", "")
        self.daemon.scheduler.task_timeout_min = int(sch.get("task_timeout_min", 0))
        if sch.get("task_repo_type"):
            self.task_repo_explicit = True
        cl = d.get("client", {})
        self.client.endpoint = cl.get("endpoint", self.client.endpoint)
        self.client.token = cl.get("token", self.client.token)
        self.client.user = cl.get("user", self.client.user)

    def _ensure_minimal(self) -> None:
        """Apply fallback defaults (``pkg/config/loader.go:55-63``).

        Deviation: the reference defaults ``client.endpoint`` to
        localhost:8042 because its CLI can only talk to a daemon; here the
        CLI runs an in-process engine unless an endpoint is configured, so
        the endpoint stays empty."""
        self.daemon.listen = self.daemon.listen or DEFAULT_LISTEN_ADDR
        sch = self.daemon.scheduler
        sch.workers = sch.workers or DEFAULT_WORKERS
        sch.queue_size = sch.queue_size or DEFAULT_QUEUE_SIZE
        sch.task_repo_type = sch.task_repo_type or DEFAULT_TASK_REPO_TYPE
        sch.task_timeout_min = sch.task_timeout_min or DEFAULT_TASK_TIMEOUT_MIN

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
