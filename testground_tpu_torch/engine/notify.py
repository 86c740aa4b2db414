"""Task-status webhooks: Slack + GitHub commit statuses — the port's copy
of the reference's ``testground_tpu/engine/notify.py``.

Twin of the reference's ``pkg/engine/supervisor.go:192-296``
(``postStatusToGithub`` / ``postStatusToSlack``): when the daemon config
carries a Slack webhook URL or a GitHub repo-status token, every finished
task posts its outcome. Failures are logged, never raised — notifications
must not affect task processing (``supervisor.go:176-183``).

The endpoints are configurable (``root_url`` gives dashboard links; the
GitHub API base is overridable for tests) and requests use stdlib urllib
with a 10 s timeout, matching the reference's plain http.Client.
"""

from __future__ import annotations

import json
import urllib.request

from ..config import EnvConfig
from ..logging_ import S

from .task import Outcome, State, Task

__all__ = [
    "notify_task_finished",
    "notify_task_started",
    "post_status_to_github",
    "post_status_to_slack",
]

GITHUB_API = "https://api.github.com"
_TIMEOUT = 10.0


def _post(url: str, payload: dict, headers: dict | None = None) -> None:
    req = urllib.request.Request(
        url,
        data=json.dumps(payload).encode(),
        headers={
            "Content-Type": "application/json; charset=UTF-8",
            **(headers or {}),
        },
        method="POST",
    )
    with urllib.request.urlopen(req, timeout=_TIMEOUT):
        pass


def _task_url(env: EnvConfig, tsk: Task) -> str:
    root = env.daemon.root_url or f"http://{env.daemon.listen}"
    return f"{root.rstrip('/')}/dashboard?task_id={tsk.id}"


def post_status_to_slack(env: EnvConfig, tsk: Task) -> None:
    """(``supervisor.go:261-296``)."""
    url = env.daemon.slack_webhook_url
    if not url:
        return
    link = f"<{_task_url(env, tsk)}|{tsk.id}>"
    took = f"{tsk.took():.1f}s"
    outcome = tsk.outcome()
    if outcome == Outcome.SUCCESS:
        text = f"✅ {link} *{tsk.name()}* run succeeded ({took})"
    elif outcome == Outcome.CANCELED:
        text = f"⚪ {link} *{tsk.name()}* run canceled ({took}) ; {tsk.error}"
    elif outcome == Outcome.FAILURE:
        text = f"❌ {link} *{tsk.name()}* run failed ({took}) ; {tsk.error}"
    else:
        text = f"{link} *{tsk.name()}* run completed"
    _post(url, {"text": text})


def post_status_to_github(
    env: EnvConfig, tsk: Task, api_base: str | None = None
) -> None:
    """Commit status for CI-created tasks (``supervisor.go:192-258``)."""
    token = env.daemon.github_repo_status_token
    if not token or not tsk.created_by_ci():
        return
    parts = tsk.created_by.repo.split("/")
    if len(parts) != 2:
        S().warning(
            "github status: malformed repo %r", tsk.created_by.repo
        )
        return
    owner, repo = parts

    st = tsk.state().state
    if st == State.PROCESSING:
        state, msg = "pending", "testground is running your plan"
    elif st in (State.COMPLETE, State.CANCELED):
        outcome = tsk.outcome()
        if outcome == Outcome.SUCCESS:
            state, msg = "success", "Testplan run succeeded!"
        elif outcome == Outcome.CANCELED:
            state, msg = "failure", "Testplan run was canceled!"
        elif outcome == Outcome.FAILURE:
            state, msg = "failure", "Testplan run failed!"
        else:
            return
    else:
        return

    url = (
        f"{(api_base or GITHUB_API).rstrip('/')}/repos/{owner}/{repo}/"
        f"statuses/{tsk.created_by.commit}"
    )
    _post(
        url,
        {
            "state": state,
            "target_url": _task_url(env, tsk),
            "description": msg,
            "context": f"testground/{tsk.plan}/{tsk.case}",
        },
        headers={
            "Authorization": f"Basic {token}",
            "Accept": "application/vnd.github.v3+json",
        },
    )


def notify_task_started(env: EnvConfig, tsk: Task) -> None:
    """Pending commit status when a CI task enters PROCESSING — the
    'pending' branch of ``postStatusToGithub`` (``supervisor.go:213-215``).
    Log-and-continue on failure."""
    try:
        post_status_to_github(env, tsk)
    except Exception as e:  # noqa: BLE001 — notifications are best-effort
        S().error("could not post pending status to github: %s", e)


def notify_task_finished(env: EnvConfig, tsk: Task) -> None:
    """Post everywhere configured; log-and-continue on failure
    (``supervisor.go:176-183``)."""
    for poster, name in (
        (post_status_to_slack, "slack"),
        (post_status_to_github, "github"),
    ):
        try:
            poster(env, tsk)
        except Exception as e:  # noqa: BLE001 — notifications are best-effort
            S().error("could not post task status to %s: %s", name, e)
