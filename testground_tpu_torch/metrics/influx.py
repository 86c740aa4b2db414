"""Optional InfluxDB push for run metric time series — the port's copy of
the reference's ``testground_tpu/metrics/influx.py``;
``tests/test_torch_cli.py`` holds its bodies byte-equal to the reference's.

The reference SDK batches runtime metrics into InfluxDB 1.x
(``INFLUXDB_URL`` env, ``pkg/runner/local_docker.go:353``) and the
daemon's dashboard queries it (``pkg/metrics/viewer.go:35-80``). Here the
canonical store is the per-run ``timeseries.jsonl``; when ``[daemon]
influxdb_endpoint`` is configured in ``.env.toml`` the same rows are ALSO
pushed to InfluxDB's ``POST /write?db=<db>`` line-protocol endpoint so
existing Grafana/Influx setups keep working. Push is best-effort:
failures are logged and journaled, never fatal to the run.
"""

from __future__ import annotations

import math
import random
import time
import urllib.error
import urllib.parse
import urllib.request

from ..logging_ import S
from .viewer import measurement_name

__all__ = ["rows_to_lines", "push_rows", "escape_tag", "escape_measurement"]

DEFAULT_DB = "testground"

# Bounded retry policy for the write POST: transient failures (connection
# refused mid-restart, a 5xx from an overloaded server) get a few
# exponentially backed-off attempts with jitter (so a fleet of runs
# finishing together doesn't re-stampede the endpoint in lockstep);
# permanent rejections (4xx — malformed lines won't improve by waiting)
# fail immediately. Module constants so tests can shrink the waits.
_RETRY_ATTEMPTS = 3
_RETRY_BASE_SECS = 0.25
_RETRY_JITTER_SECS = 0.1


def escape_measurement(s: str) -> str:
    """Line-protocol measurement escaping (commas and spaces)."""
    return s.replace(",", r"\,").replace(" ", r"\ ")


def escape_tag(s: str) -> str:
    """Line-protocol tag key/value escaping (commas, equals, spaces)."""
    return (
        s.replace(",", r"\,").replace("=", r"\=").replace(" ", r"\ ")
    )


def _field_value(v) -> str | None:
    if isinstance(v, bool):  # bool is an int subclass — check first
        return "true" if v else "false"
    if isinstance(v, int):
        return f"{v}i"
    if isinstance(v, float):
        # inf/nan are invalid line protocol; one bad field would make
        # InfluxDB 400 the whole single-POST batch
        return repr(float(v)) if math.isfinite(v) else None
    return None


def rows_to_lines(
    rows, base_ns: int = 0, dropped: list[str] | None = None
) -> list[str]:
    """Serialize timeseries rows (the ``timeseries.jsonl`` dict shape:
    plan/case/run/group_id/name/tick + numeric fields) into InfluxDB line
    protocol. The measurement name keeps the reference's
    ``results.<plan>-<case>.<metric>`` shape (``dashboard.go:112-118``).

    Non-finite floats (NaN/Inf) are invalid line protocol — one such
    field would make InfluxDB 400 the whole single-POST batch — so they
    are dropped from the line; pass ``dropped`` to collect their
    ``<measurement>.<field>`` names (push_rows journals and warns about
    them instead of losing metrics silently).

    Timestamps are ``base_ns + tick`` nanoseconds: push_rows passes the
    wall-clock push time as ``base_ns`` so points land inside Grafana's
    default ``now-6h`` window (simulated ticks alone would put everything
    at ~1970), while the +tick offset keeps per-tick points distinct and
    ordered within a series. The simulated tick itself is preserved as an
    integer field so panels can plot against it."""

    lines: list[str] = []
    for row in rows:
        name = row.get("name")
        if not name:
            continue
        measurement = escape_measurement(
            measurement_name(
                str(row.get("plan", "")), str(row.get("case", "")), str(name)
            )
        )
        tags = ""
        for key in ("run", "group_id"):
            val = str(row.get(key, ""))
            if val:
                tags += f",{escape_tag(key)}={escape_tag(val)}"
        fields = []
        for k, v in row.items():
            if k in ("plan", "case", "run", "group_id", "name", "tick"):
                continue
            fv = _field_value(v)
            if fv is not None:
                fields.append(f"{escape_tag(k)}={fv}")
            elif (
                dropped is not None
                and isinstance(v, float)
                and not math.isfinite(v)
            ):
                # non-float non-values (strings, nested dicts) are simply
                # not fields; only NaN/Inf is a LOST metric worth flagging
                dropped.append(f"{measurement}.{k}")
        if not fields:
            continue
        tick = int(row.get("tick", 0))
        fields.append(f"tick={tick}i")
        lines.append(f"{measurement}{tags} {','.join(fields)} {base_ns + tick}")
    return lines


def push_rows(
    endpoint: str,
    rows,
    db: str = DEFAULT_DB,
    timeout: float = 5.0,
    base_ns: int | None = None,
) -> dict:
    """POST rows to ``<endpoint>/write?db=<db>``, with bounded retries
    (exponential backoff + jitter — see the module constants). Returns a
    journal dict ``{pushed, ok, attempts, error?}`` — callers record it
    and move on; a final failure is journaled and logged, never raised.

    ``base_ns`` must be stable per run (the executor passes the run's
    start wall-clock): a per-push ``time.time_ns()`` would interleave
    periodic flushes by push time instead of tick, write duplicate points
    on retry, and let base1+tick_a collide with base2+tick_b across
    batches, silently overwriting a point with an identical tagset. The
    per-call fallback exists only for standalone one-shot callers."""
    import time

    dropped: list[str] = []
    lines = rows_to_lines(
        rows,
        base_ns=time.time_ns() if base_ns is None else base_ns,
        dropped=dropped,
    )
    journal: dict = {"pushed": len(lines), "ok": False}
    if dropped:
        # journal the lost fields (deduped, bounded) AND warn — a NaN/Inf
        # metric must be visible somewhere, since the line protocol
        # cannot carry it
        uniq = sorted(set(dropped))
        journal["dropped_fields"] = uniq[:32]
        journal["dropped_field_count"] = len(dropped)
        S().warning(
            "influx push: dropped %d non-finite field value(s) (%s%s) — "
            "NaN/Inf is invalid line protocol",
            len(dropped),
            ", ".join(uniq[:5]),
            ", ..." if len(uniq) > 5 else "",
        )
    if not lines:
        journal["ok"] = True
        return journal
    url = endpoint.rstrip("/") + "/write?" + urllib.parse.urlencode({"db": db})
    body = ("\n".join(lines) + "\n").encode("utf-8")

    # bounded retries with exponential backoff + jitter: idempotent by
    # construction (stable base_ns means a re-push writes the same
    # points), so retrying a request whose response was lost is safe
    last_err = ""
    for attempt in range(1, _RETRY_ATTEMPTS + 1):
        journal["attempts"] = attempt
        req = urllib.request.Request(
            url,
            data=body,
            method="POST",
            headers={"Content-Type": "text/plain; charset=utf-8"},
        )
        try:
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                if 200 <= resp.status < 300:
                    journal["ok"] = True
                    journal.pop("error", None)
                    return journal
                last_err = f"http {resp.status}"
                if 400 <= resp.status < 500:
                    break  # permanent: bad request won't improve
        except urllib.error.HTTPError as e:
            last_err = f"http {e.code}"
            if 400 <= e.code < 500:
                break
        except (urllib.error.URLError, OSError, ValueError) as e:
            last_err = str(e)
        journal["error"] = last_err
        if attempt < _RETRY_ATTEMPTS:
            delay = _RETRY_BASE_SECS * (2 ** (attempt - 1)) + random.uniform(
                0.0, _RETRY_JITTER_SECS
            )
            S().warning(
                "influx push to %s failed (attempt %d/%d: %s) — retrying "
                "in %.2fs",
                endpoint,
                attempt,
                _RETRY_ATTEMPTS,
                last_err,
                delay,
            )
            time.sleep(delay)
    # the FINAL failure is journaled (attempts + error) and logged — the
    # run record shows exactly how hard the mirror was tried
    journal["error"] = last_err
    S().warning(
        "influx push to %s failed after %d attempt(s): %s — %d line(s) "
        "not mirrored",
        endpoint,
        journal["attempts"],
        last_err,
        len(lines),
    )
    return journal
