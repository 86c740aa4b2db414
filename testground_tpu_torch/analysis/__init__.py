"""Cross-run analysis plane — the port's copy of the reference's
``testground_tpu/analysis/`` package.

Everything under this package is deliberately import-light (stdlib
only, no torch or numpy at module scope): the diff engine runs against
ARCHIVED tasks — a ``tg diff`` of two finished runs, or the bench
sentinel over the port's bank — where paying a torch import for pure
host-side arithmetic would be wasted startup.

- :mod:`testground_tpu_torch.analysis.diff` — the RunDiff document
  builder: deterministic counters compared exactly, throughput judged
  from per-chunk samples with noise-robust statistics (median ratio +
  Mann-Whitney U). Backend of ``tg diff`` / ``GET /diff`` and the one
  comparison codepath behind ``tg perf --compare``.
- :mod:`testground_tpu_torch.analysis.bench_history` — the append-only
  env-fingerprinted bench bank (``BENCH_HISTORY_TORCH.jsonl``) and the
  regression sentinel verdicts.
"""
