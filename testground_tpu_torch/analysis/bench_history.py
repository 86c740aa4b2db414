"""Banked bench history + the regression sentinel verdicts — the port's
copy of the reference's ``testground_tpu/analysis/bench_history.py``.

A bench run appends ONE env-fingerprinted row to an append-only
``BENCH_HISTORY_TORCH.jsonl``, the port's own bank: the JAX round's
``BENCH_HISTORY.jsonl`` holds TPU and CPU rows of the reference and is
never written here. Rows group by :func:`history_key` — (workload, rung,
backend, device kind, transport, mesh layout) — so numbers from
different machines, scales, or shardings never gate each other.

:func:`sentinel_report` turns the bank into a gate: the newest row per
key against the median of its banked predecessors, with a deliberately
GENEROUS tolerance (default 2.5×) because a single bench run is one
sample on a shared host — only a slowdown no plausible noise explains
fails. Anything slower-but-within-bound is journaled as
``inconclusive`` and passes.

Only :func:`env_fingerprint` differs from the reference: it reads torch
(its version and CUDA version, the backend, the card count and name)
and the card's power limit from ``nvidia-smi``, never jax. stdlib-only
at module scope (the package rule); torch, nvidia-smi and git are probed
lazily and best-effort inside :func:`env_fingerprint`.
"""

from __future__ import annotations

import json
import os
from typing import Any

from .diff import num

__all__ = [
    "HISTORY_FILE",
    "bank_row",
    "env_fingerprint",
    "history_key",
    "load_history",
    "sentinel_report",
]

HISTORY_FILE = "BENCH_HISTORY_TORCH.jsonl"


def env_fingerprint() -> dict:
    """Where this number was measured: the torch and CUDA versions, the
    backend (``cuda`` with a card, else ``cpu``), the card count and name,
    the card's power limit (``nvidia-smi``), host cpu count, platform, and
    the git sha of the tree that produced it. Every probe is best-effort —
    a fingerprint field missing (no git, no card, no nvidia-smi) must never
    fail a bench run. Reading the card's name initialises CUDA; nothing is
    allocated on it."""
    import platform

    fp: dict[str, Any] = {
        "python": platform.python_version(),
        "platform": platform.platform(),
        "cpu_count": os.cpu_count(),
    }
    try:
        import torch

        fp["torch"] = torch.__version__
        fp["cuda"] = torch.version.cuda
        cuda = torch.cuda.is_available()
        fp["backend"] = "cuda" if cuda else "cpu"
        fp["devices"] = torch.cuda.device_count() if cuda else 0
        if cuda:
            fp["device_kind"] = torch.cuda.get_device_name(0)
    except Exception:  # noqa: BLE001 — fingerprint is descriptive only
        pass
    try:
        import subprocess

        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True,
            text=True,
            timeout=10,
        )
        line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
        if smi.returncode == 0 and line:
            fp["nvidia_smi"] = line.strip()
            fp["power_limit"] = line.rsplit(",", 1)[-1].strip()
    except Exception:  # noqa: BLE001
        pass
    try:
        import subprocess

        sha = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            cwd=os.path.dirname(os.path.dirname(os.path.dirname(__file__))),
            capture_output=True,
            text=True,
            timeout=10,
        )
        if sha.returncode == 0 and sha.stdout.strip():
            fp["git_sha"] = sha.stdout.strip()
    except Exception:  # noqa: BLE001
        pass
    return fp


def history_key(row: dict) -> tuple:
    """The comparison group a banked row belongs to. Rows only gate
    rows measured at the same workload + rung on the same kind of
    hardware, transport, and mesh layout — a TPU number never judges a
    CPU number, and a 4-shard rung never judges an unmeshed one (a
    sharded program is a different machine, not noise). Pre-mesh rows
    carry no ``mesh`` field and default to the unmeshed group."""
    fp = row.get("fingerprint") if isinstance(row.get("fingerprint"), dict) else {}
    return (
        str(row.get("workload") or ""),
        int(num(row.get("instances"), 0)),
        str(fp.get("backend") or ""),
        str(fp.get("device_kind") or ""),
        str(row.get("transport") or ""),
        str(row.get("mesh") or ""),
    )


def bank_row(path: str, row: dict) -> dict:
    """Append one row to the bank (append-only by construction: the
    file is opened in ``a`` mode and rows are never rewritten). Returns
    the row as written."""
    row = dict(row)
    with open(path, "a") as f:
        f.write(json.dumps(row, sort_keys=True) + "\n")
    return row


def load_history(path: str) -> list[dict]:
    """Every parseable row, in file (= append) order. Corrupt lines are
    skipped — a half-written row from a crashed bench must not brick
    the sentinel."""
    rows: list[dict] = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    row = json.loads(line)
                except ValueError:
                    continue
                if isinstance(row, dict):
                    rows.append(row)
    except OSError:
        pass
    return rows


def _median(xs: list[float]) -> float:
    s = sorted(xs)
    n = len(s)
    mid = n // 2
    return s[mid] if n % 2 else (s[mid - 1] + s[mid]) / 2.0


def sentinel_report(
    rows: list[dict], tolerance: float = 2.5, rel_epsilon: float = 0.05
) -> dict:
    """Per-key verdicts over a loaded history. For each key group the
    NEWEST row is judged against the median headline value of its
    predecessors (median, not last: a one-off noisy bank must not move
    the baseline much):

    - ``regressed``   — newest < baseline/tolerance: slower than even
      the generous noise bound explains ⇒ the gate fails;
    - ``inconclusive`` — slower than the epsilon band but within the
      noise bound, or no predecessor to judge against ⇒ passes, but
      the row is journaled for a human;
    - ``improved`` / ``ok`` — faster than the band / within it.

    Returns ``{keys: [{key fields, verdict, value, baseline?, ratio?,
    samples, reason}], regressions: N, inconclusive: N}``.
    """
    tolerance = max(1.0, float(tolerance))
    groups: dict[tuple, list[dict]] = {}
    for row in rows:
        if num(row.get("value")) is None:
            continue
        groups.setdefault(history_key(row), []).append(row)
    out: dict[str, Any] = {"keys": [], "regressions": 0, "inconclusive": 0}
    for key in sorted(groups):
        series = groups[key]
        newest = series[-1]
        value = float(num(newest.get("value")))
        entry: dict[str, Any] = {
            "workload": key[0],
            "instances": key[1],
            "backend": key[2],
            "device_kind": key[3],
            "transport": key[4],
            "mesh": key[5],
            "value": value,
            "samples": len(series),
            "ts": newest.get("ts"),
        }
        prior = [float(num(r.get("value"))) for r in series[:-1]]
        if not prior:
            entry["verdict"] = "inconclusive"
            entry["reason"] = "no banked baseline yet (first row for this key)"
            out["inconclusive"] += 1
        else:
            baseline = _median(prior)
            entry["baseline"] = baseline
            ratio = value / baseline if baseline else float("inf")
            entry["ratio"] = round(ratio, 4)
            if ratio < 1.0 / tolerance:
                entry["verdict"] = "regressed"
                entry["reason"] = (
                    f"x{ratio:.3f} of the banked baseline — beyond the "
                    f"{tolerance:g}x noise bound"
                )
                out["regressions"] += 1
            elif ratio < 1.0 - rel_epsilon:
                entry["verdict"] = "inconclusive"
                entry["reason"] = (
                    f"x{ratio:.3f} slower, but within the {tolerance:g}x "
                    "noise bound — journaled, not gated"
                )
                out["inconclusive"] += 1
            elif ratio > 1.0 + rel_epsilon:
                entry["verdict"] = "improved"
                entry["reason"] = f"x{ratio:.3f} of the banked baseline"
            else:
                entry["verdict"] = "ok"
                entry["reason"] = f"x{ratio:.3f} of the banked baseline"
        out["keys"].append(entry)
    return out
