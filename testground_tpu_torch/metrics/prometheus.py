"""Prometheus text exposition for the daemon's ``GET /metrics`` — the
port's copy of the reference's ``testground_tpu/metrics/prometheus.py``
(``render_prometheus`` and its helpers, code unchanged).

Format 0.0.4 (https://prometheus.io/docs/instrumenting/exposition_formats/):
``metric_name{label="value"} number`` lines with one ``# HELP`` /
``# TYPE`` header per family. Stdlib-only and dependency-free on purpose
— the daemon is a long-lived process any standard scraper should be able
to watch without this repo growing a client library.

Every family is derived from the engine's task store (no live engine
internals — a scrape never blocks a running task):

- **task gauges** — tasks by lifecycle state and type, plus per-task
  queue/exec timings from the supervisor's ledger (``result["perf"]``).
- **cumulative flow counters** — a finished sim run's message-flow
  totals (``journal["sim"]``), labeled by flow leg so conservation is
  checkable in PromQL.
- **perf gauges** — the run performance ledger
  (``journal["sim"]["perf"]``): throughput, compile split, device memory
  high-water mark.
- **SLO gauges** — the run health plane (``journal["slo"]``): per-rule
  breach counts, thresholds and last-observed values, plus a per-task
  failed flag.
- **fleet gauges** — ``tg_fleet_*`` over the whole store and the engine's
  counters (``Engine.fleet_info``).

Per-task label cardinality is bounded by ``per_task_limit`` (the daemon
exports series for its most recent tasks only — configurable via
``[daemon] metrics_task_limit``); the aggregate ``tg_tasks`` counts
always cover the full task store, and truncation is never silent:
``tg_scrape_tasks_total`` / ``tg_scrape_tasks_elided`` report how much
of the store this scrape's per-task series covered.

Some families read journal fields the port's runs never write; their code
stays, so that a reference journal renders the same, and on a port run
they are silent: ``tg_run_lower_seconds``, ``tg_run_xla_compile_seconds``,
``tg_run_est_flops_per_chunk`` and ``tg_run_est_bytes_accessed_per_chunk``
(no XLA compile or cost analysis). ``tg_compile_bucket_*`` counts a port
bucket's ``compile_cache`` verdict as the reference's: ``"hit"`` or
``"miss"`` on the card (whether the run's process ran nvcc for its kernel
library, ``sim/executor.compile_cache_verdict``); ``"off"`` on the CPU or
with the cache disabled, and ``"unknown"`` on a resumed run, count neither.
``tg_bucket_padded_instances`` renders a port bucketed
run's padded size, ``tg_pack_width``/``tg_pack_members`` a packed run's
``sim.pack`` block and ``tg_fleet_pack_*`` the engine's pack claims.

``render_sync_prometheus`` renders a sync service's ``sync_stats``
snapshot as the ``tg_sync_*`` family, the exposition of ``tg-torch
sync-service --metrics-port`` (``sync/stats.SyncMetricsExporter``).
"""

from __future__ import annotations

# the shared finite-number coercion every ledger consumer uses —
# NaN/Inf and non-numerics never reach the exposition (a scraper would
# reject the whole scrape)
from ..sim.perf import num as _num

__all__ = ["CONTENT_TYPE", "render_prometheus", "render_sync_prometheus"]

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

# flow legs of the conservation identity (docs/OBSERVABILITY.md):
# sent = delivered + in_flight + dropped + rejected + fault_dropped
_FLOWS = (
    ("sent", "msgs_sent"),
    ("delivered", "msgs_delivered"),
    ("enqueued", "msgs_enqueued"),
    ("dropped", "msgs_dropped"),
    ("rejected", "msgs_rejected"),
    ("in_flight", "msgs_in_flight"),
    ("fault_dropped", "msgs_fault_dropped"),
)


def _escape(value) -> str:
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


class _Exposition:
    def __init__(self):
        self._families: dict[str, tuple[str, str, list[str]]] = {}

    def add(self, name: str, mtype: str, help_: str, labels: dict, value):
        v = _num(value)
        if v is None:
            return
        if name not in self._families:
            self._families[name] = (mtype, help_, [])
        lbl = ",".join(
            f'{k}="{_escape(val)}"' for k, val in labels.items()
        )
        self._families[name][2].append(
            f"{name}{{{lbl}}} {v}" if lbl else f"{name} {v}"
        )

    def render(self) -> str:
        out = []
        for name, (mtype, help_, lines) in self._families.items():
            out.append(f"# HELP {name} {help_}")
            out.append(f"# TYPE {name} {mtype}")
            out.extend(lines)
        return "\n".join(out) + "\n" if out else "\n"


def render_sync_prometheus(stats: dict) -> str:
    """Render a ``sync_stats`` snapshot (v1 or v2) as the ``tg_sync_*``
    family — the ``tg sync-service --metrics-port`` exposition
    (docs/OBSERVABILITY.md "Sync plane").

    Label space is bounded by construction: ``op`` ranges over the fixed
    protocol op set, barrier ``target`` over pow2 buckets (capped at
    2^20 by the recorder), and the per-op duration histograms over the
    recorder's fixed log2 bin count — a scrape's cardinality cannot grow
    with traffic. A v1 snapshot (old server) renders just the occupancy
    gauges; reconciliation with ``tg sync-stats`` is pinned by
    ``tools/sync_fanin_smoke.py``."""
    exp = _Exposition()
    for name, key, help_ in (
        ("tg_sync_conns", "conns", "Open connections to the sync service."),
        ("tg_sync_waiters", "waiters", "Parked barrier waiters."),
        ("tg_sync_subs", "subs", "Open topic subscriptions."),
        (
            "tg_sync_uptime_seconds",
            "uptime_secs",
            "Seconds since the sync service started its stats plane.",
        ),
    ):
        exp.add(name, "gauge", help_, {}, stats.get(key))
    for op, count in sorted((stats.get("ops") or {}).items()):
        exp.add(
            "tg_sync_ops_total",
            "counter",
            "Requests dispatched, by protocol op.",
            {"op": op},
            count,
        )
    conn = stats.get("conn") if isinstance(stats.get("conn"), dict) else {}
    for name, key, help_ in (
        ("tg_sync_conn_accepts_total", "accepts", "Connections accepted."),
        ("tg_sync_conn_closes_total", "closes", "Connections closed."),
        (
            "tg_sync_conn_evictions_total",
            "evictions",
            "Connections evicted by the idle sweep (half-open peers).",
        ),
    ):
        exp.add(name, "counter", help_, {}, conn.get(key))
    exp.add(
        "tg_sync_conns_hwm",
        "gauge",
        "Concurrent-connection high-water mark.",
        {},
        conn.get("hwm"),
    )
    bar = stats.get("barriers") if isinstance(stats.get("barriers"), dict) else {}
    for name, key, help_ in (
        ("tg_sync_barrier_parked_total", "parked", "Barrier waiters parked."),
        (
            "tg_sync_barrier_released_total",
            "released",
            "Barrier waiters released (fan-in reached).",
        ),
        (
            "tg_sync_barrier_timed_out_total",
            "timed_out",
            "Barrier waiters that timed out.",
        ),
        (
            "tg_sync_barrier_canceled_total",
            "canceled",
            "Barrier waiters canceled (connection lost mid-wait).",
        ),
    ):
        exp.add(name, "counter", help_, {}, bar.get(key))
    episodes = (
        bar.get("episodes") if isinstance(bar.get("episodes"), dict) else {}
    )
    for bucket, rec in sorted(
        (episodes.get("by_target") or {}).items(),
        key=lambda kv: int(kv[0]),
    ):
        if not isinstance(rec, dict):
            continue
        lbl = {"target": str(bucket)}
        exp.add(
            "tg_sync_barrier_episodes_total",
            "counter",
            "Released barrier episodes, by pow2-bucketed fan-in target.",
            lbl,
            rec.get("count"),
        )
        exp.add(
            "tg_sync_barrier_release_ms_total",
            "counter",
            "Summed armed-to-release wall ms of barrier episodes, by "
            "pow2-bucketed fan-in target.",
            lbl,
            rec.get("total_ms"),
        )
        exp.add(
            "tg_sync_barrier_release_ms_max",
            "gauge",
            "Slowest armed-to-release wall ms observed, by "
            "pow2-bucketed fan-in target.",
            lbl,
            rec.get("max_ms"),
        )
    ps = stats.get("pubsub") if isinstance(stats.get("pubsub"), dict) else {}
    exp.add(
        "tg_sync_pubsub_published_total",
        "counter",
        "Entries appended to topics (dedup replays excluded).",
        {},
        ps.get("published"),
    )
    for name, key, help_ in (
        ("tg_sync_pubsub_topics", "topics", "Topics holding entries."),
        ("tg_sync_pubsub_entries", "entries", "Entries across all topics."),
        (
            "tg_sync_pubsub_depth_hwm",
            "depth_hwm",
            "Deepest single topic observed (queue-depth high-water).",
        ),
        (
            "tg_sync_pubsub_subs_hwm",
            "subs_hwm",
            "Concurrent-subscription high-water mark.",
        ),
    ):
        exp.add(name, "gauge", help_, {}, ps.get(key))
    dd = stats.get("dedup") if isinstance(stats.get("dedup"), dict) else {}
    for kind, key in (("signal", "signal_hits"), ("publish", "publish_hits")):
        exp.add(
            "tg_sync_dedup_hits_total",
            "counter",
            "Idempotency-token replays answered from the dedup map "
            "(reconnect at-least-once wire, exactly-once effect).",
            {"op": kind},
            dd.get(key),
        )
    out = exp.render()
    # per-op service-time histograms (python server only): proper
    # Prometheus histogram series, hand-assembled because the le-bucket
    # lines share one TYPE header with their _sum/_count — cumulative
    # buckets over the recorder's log2 µs bins, le in seconds
    op_time = (
        stats.get("op_time_us")
        if isinstance(stats.get("op_time_us"), dict)
        else {}
    )
    hist_lines = []
    for op in sorted(op_time):
        rec = op_time[op]
        bins = rec.get("bins") if isinstance(rec, dict) else None
        if not bins:
            continue
        cum = 0
        for i, c in enumerate(bins):
            cum += int(_num(c) or 0)
            le = (
                "+Inf"
                if i == len(bins) - 1
                else repr((1 << (i + 1)) / 1e6)
            )
            hist_lines.append(
                f'tg_sync_op_duration_seconds_bucket{{op="{_escape(op)}"'
                f',le="{le}"}} {cum}'
            )
        total_us = _num(rec.get("total_us")) or 0
        hist_lines.append(
            f'tg_sync_op_duration_seconds_sum{{op="{_escape(op)}"}} '
            f"{total_us / 1e6}"
        )
        hist_lines.append(
            f'tg_sync_op_duration_seconds_count{{op="{_escape(op)}"}} {cum}'
        )
    if hist_lines:
        out = out.rstrip("\n") + "\n" + "\n".join(
            [
                "# HELP tg_sync_op_duration_seconds Service time per op "
                "(barrier/signal_and_wait record the full fan-in wait).",
                "# TYPE tg_sync_op_duration_seconds histogram",
            ]
            + hist_lines
        ) + "\n"
    return out


def render_prometheus(
    tasks, per_task_limit: int | None = None, fleet: dict | None = None
) -> str:
    """Render the daemon's metric surface from a task list (most recent
    first). The fixed-cardinality ``tg_tasks`` aggregate counts EVERY
    task given; ``per_task_limit`` bounds only the task-labeled series
    (label cardinality), so counts stay honest on daemons whose history
    outgrows the per-task window. ``fleet`` is the engine's counter
    snapshot (``Engine.fleet_info()``): worker occupancy, queue-wait /
    claim-latency histogram bins, pack admission counters — rendered as
    the ``tg_fleet_*`` family alongside the fleet gauges this function
    computes over the FULL task list (never the truncated slice; the
    conservation contract Σ tg_fleet_tasks == tg_scrape_tasks_total is
    pinned by test)."""
    exp = _Exposition()

    by_state: dict[tuple[str, str], int] = {}
    for t in tasks:
        key = (t.state().state.value, t.type.value)
        by_state[key] = by_state.get(key, 0) + 1
    for (state, ttype), count in sorted(by_state.items()):
        exp.add(
            "tg_tasks",
            "gauge",
            "Tasks known to this daemon, by lifecycle state and type.",
            {"state": state, "type": ttype},
            count,
        )

    # ---------------------------------------------------------- fleet
    # Control-plane gauges over the FULL task store, computed BEFORE
    # the per-task truncation below (the fleet-total-blindness fix):
    # per-state depth (conservation: sums to the store count), queue
    # depth by priority, and compile-cache totals.
    fleet_states: dict[str, int] = {}
    fleet_prio: dict[int, int] = {}
    cache_totals = {"hit": 0, "miss": 0}
    for t in tasks:
        st = t.state().state.value
        fleet_states[st] = fleet_states.get(st, 0) + 1
        if st == "scheduled":
            fleet_prio[t.priority] = fleet_prio.get(t.priority, 0) + 1
        result = t.result if isinstance(t.result, dict) else {}
        journal = (
            result.get("journal")
            if isinstance(result.get("journal"), dict)
            else {}
        )
        sim = journal.get("sim") if isinstance(journal.get("sim"), dict) else {}
        bk = sim.get("bucket") if isinstance(sim.get("bucket"), dict) else {}
        verdict = bk.get("compile_cache")
        if verdict in cache_totals:
            cache_totals[verdict] += 1
    for state in sorted(fleet_states):
        exp.add(
            "tg_fleet_tasks",
            "gauge",
            "Tasks in the daemon's store by lifecycle state, over the "
            "FULL store (sums to tg_scrape_tasks_total).",
            {"state": state},
            fleet_states[state],
        )
    for prio in sorted(fleet_prio):
        exp.add(
            "tg_fleet_queue_depth",
            "gauge",
            "Queued (scheduled) tasks by priority, over the full store.",
            {"priority": str(prio)},
            fleet_prio[prio],
        )
    # an empty store renders only the scrape-coverage gauges (the
    # test_empty_task_list pin) — the zero-valued cache counters would
    # be noise on a daemon that has never run anything
    if tasks:
        for verdict in ("hit", "miss"):
            exp.add(
                "tg_fleet_compile_cache_total",
                "counter",
                "Bucketed runs served warm (hit) or paying a cold XLA "
                "compile (miss), totalled over the full task store.",
                {"verdict": verdict},
                cache_totals[verdict],
            )
    if fleet:
        workers = (
            fleet.get("workers") if isinstance(fleet.get("workers"), dict) else {}
        )
        busy = int(_num(workers.get("busy")) or 0)
        total_workers = int(_num(workers.get("total")) or 0)
        for state, value in (
            ("busy", busy),
            ("idle", max(0, total_workers - busy)),
        ):
            exp.add(
                "tg_fleet_workers",
                "gauge",
                "Supervisor worker slots by occupancy.",
                {"state": state},
                value,
            )
        pk = fleet.get("pack") if isinstance(fleet.get("pack"), dict) else {}
        exp.add(
            "tg_fleet_pack_admissions_total",
            "counter",
            "Pack claims that admitted >= 2 runs onto one device "
            "program since daemon start.",
            {},
            pk.get("packed", 0),
        )
        exp.add(
            "tg_fleet_pack_runs_total",
            "counter",
            "Member runs admitted via pack claims since daemon start.",
            {},
            pk.get("packed_runs", 0),
        )
        solo = pk.get("solo") if isinstance(pk.get("solo"), dict) else {}
        for reason in sorted(solo):
            exp.add(
                "tg_fleet_pack_solo_total",
                "counter",
                "Pack-requesting runs that executed solo, by cause.",
                {"reason": str(reason)[:120]},
                solo[reason],
            )
        # fleet controller counters (docs/FLEET.md): preempt/evict/refuse
        # decisions since daemon start
        exp.add(
            "tg_fleet_preemptions_total",
            "counter",
            "Running tasks checkpointed and requeued by the fleet "
            "controller (operator preempt, eviction, or drain) since "
            "daemon start.",
            {},
            fleet.get("preemptions", 0),
        )
        exp.add(
            "tg_fleet_evictions_total",
            "counter",
            "Running tasks preempted to admit a higher-priority arrival "
            "since daemon start.",
            {},
            fleet.get("evictions", 0),
        )
        exp.add(
            "tg_fleet_refused_total",
            "counter",
            "Compositions refused at submit by the admission rules "
            "engine (tg check server-side) since daemon start.",
            {},
            fleet.get("refused", 0),
        )

    # truncation is NEVER silent (the render_prometheus contract): a
    # scraper can alert on elided > 0 instead of trusting an invisibly
    # windowed task list
    total = len(tasks)
    if per_task_limit is not None:
        tasks = tasks[:per_task_limit]
    exp.add(
        "tg_scrape_tasks_total",
        "gauge",
        "Tasks in the daemon's store at scrape time.",
        {},
        total,
    )
    exp.add(
        "tg_scrape_tasks_elided",
        "gauge",
        "Tasks whose per-task series were elided from this scrape by the "
        "per-task cardinality bound ([daemon] metrics_task_limit).",
        {},
        total - len(tasks),
    )
    for t in tasks:
        ident = {"task": t.id, "plan": t.plan, "case": t.case}
        result = t.result if isinstance(t.result, dict) else {}
        # supervisor ledger: queue wait + per-run runner wall
        tperf = result.get("perf") if isinstance(result.get("perf"), dict) else {}
        exp.add(
            "tg_task_queued_seconds",
            "gauge",
            "Seconds a task waited in the queue before processing.",
            ident,
            tperf.get("queued_secs"),
        )
        for rid, wall in sorted(
            (tperf.get("runner_wall_secs") or {}).items()
        ):
            exp.add(
                "tg_task_runner_wall_seconds",
                "gauge",
                "Wall seconds the runner spent executing one run of a task.",
                {**ident, "run": rid},
                wall,
            )
        journal = (
            result.get("journal") if isinstance(result.get("journal"), dict)
            else {}
        )
        # run health plane (journal["slo"]): per-rule verdicts — checked
        # BEFORE the sim-block gate because a fail-fast SLO run archives
        # its journal through the typed-error path too
        slo = journal.get("slo") if isinstance(journal.get("slo"), dict) else {}
        rules = slo.get("rules") if isinstance(slo.get("rules"), list) else []
        if rules:
            exp.add(
                "tg_slo_rules",
                "gauge",
                "SLO rules the run declared (run health plane).",
                ident,
                len(rules),
            )
            exp.add(
                "tg_slo_failed",
                "gauge",
                "1 when a severity=fail SLO breached and canceled the run.",
                ident,
                1 if slo.get("error") else 0,
            )
            for r in rules:
                if not isinstance(r, dict):
                    continue
                rident = {
                    **ident,
                    "rule": r.get("name", "?"),
                    "metric": r.get("metric", "?"),
                    "severity": r.get("severity", "warn"),
                }
                exp.add(
                    "tg_slo_breaches_total",
                    "counter",
                    "Breaching evaluations of one SLO rule across the run.",
                    rident,
                    r.get("breaches"),
                )
                exp.add(
                    "tg_slo_threshold",
                    "gauge",
                    "Declared threshold of one SLO rule.",
                    rident,
                    r.get("threshold"),
                )
                exp.add(
                    "tg_slo_observed",
                    "gauge",
                    "Last observed value of one SLO rule's metric (the "
                    "final evaluation before the run ended).",
                    rident,
                    r.get("last_observed"),
                )
        sim = journal.get("sim") if isinstance(journal.get("sim"), dict) else {}
        if not sim:
            continue
        for flow, key in _FLOWS:
            exp.add(
                "tg_run_msgs_total",
                "counter",
                "Cumulative message-flow totals of a finished sim run, "
                "by conservation leg.",
                {**ident, "flow": flow},
                sim.get(key),
            )
        for name, key, help_ in (
            ("tg_run_ticks", "ticks", "Simulated ticks the run executed."),
            (
                "tg_run_wall_seconds",
                "wall_secs",
                "Wall seconds of the run's execute phase.",
            ),
            (
                "tg_run_compile_seconds",
                "compile_secs",
                "Init + first-dispatch seconds (trace/lower + XLA compile "
                "or persistent-cache read).",
            ),
            ("tg_run_devices", "devices", "Devices the run's mesh spanned."),
            (
                "tg_run_carry_bytes",
                "carry_bytes",
                "Device-resident carry footprint in bytes (eval_shape-exact).",
            ),
        ):
            exp.add(name, "gauge", help_, ident, sim.get(key))
        perf = sim.get("perf") if isinstance(sim.get("perf"), dict) else {}
        ex = perf.get("execute") if isinstance(perf.get("execute"), dict) else {}
        co = perf.get("compile") if isinstance(perf.get("compile"), dict) else {}
        hbm = perf.get("hbm") if isinstance(perf.get("hbm"), dict) else {}
        exp.add(
            "tg_run_peer_ticks_per_second",
            "gauge",
            "Steady-state instance*ticks per wall second (performance "
            "ledger; first dispatch excluded when more than one ran).",
            ident,
            ex.get("steady_peer_ticks_per_sec", ex.get("peer_ticks_per_sec")),
        )
        exp.add(
            "tg_run_lower_seconds",
            "gauge",
            "Trace+lower seconds of the chunk program (AOT accounting pass).",
            ident,
            co.get("lower_secs"),
        )
        exp.add(
            "tg_run_xla_compile_seconds",
            "gauge",
            "XLA compile (or persistent-cache read) seconds of the chunk "
            "program (AOT accounting pass).",
            ident,
            co.get("compile_secs"),
        )
        exp.add(
            "tg_run_est_flops_per_chunk",
            "gauge",
            "XLA cost-analysis FLOP estimate for one tick-chunk program.",
            ident,
            co.get("flops"),
        )
        exp.add(
            "tg_run_est_bytes_accessed_per_chunk",
            "gauge",
            "XLA cost-analysis bytes-accessed estimate for one tick-chunk "
            "program.",
            ident,
            co.get("bytes_accessed"),
        )
        exp.add(
            "tg_run_hbm_peak_bytes",
            "gauge",
            "Device memory high-water mark sampled across the run "
            "(absent when the backend exposes no memory stats).",
            ident,
            hbm.get("peak_bytes"),
        )
        # network topology plane (journal["sim"]["net_matrix"],
        # docs/OBSERVABILITY.md "Traffic matrix"): BOUNDED cardinality
        # by construction — only the journal's top-K pairs export as
        # tg_net_pair_* series (≤ K pairs × flow legs) plus one elision
        # gauge saying how many nonzero pairs did NOT make the page;
        # the raw G² matrix never reaches the scrape page (read it via
        # `tg netmap` or the sim_netmatrix.jsonl stream).
        nm = (
            sim.get("net_matrix")
            if isinstance(sim.get("net_matrix"), dict)
            else {}
        )
        if nm:
            from ..sim.netmatrix import NM_MSG_BYTES

            nm_labels = nm.get("labels") or []

            def _nm_group(i) -> str:
                try:
                    return str(nm_labels[int(i)])
                except (TypeError, ValueError, IndexError):
                    return str(i)

            for pr in nm.get("top_pairs") or []:
                if not isinstance(pr, dict):
                    continue
                pident = {
                    **ident,
                    "src": _nm_group(pr.get("src")),
                    "dst": _nm_group(pr.get("dst")),
                }
                for flow in (
                    "sent",
                    "delivered",
                    "dropped",
                    "rejected",
                    "fault_dropped",
                ):
                    exp.add(
                        "tg_net_pair_msgs_total",
                        "counter",
                        "Per-(src,dst) group-pair message counts of a "
                        "finished run's traffic matrix — top-K pairs by "
                        "sent volume only (bounded cardinality; see "
                        "tg_net_pairs_elided).",
                        {**pident, "flow": flow},
                        pr.get(flow),
                    )
                enq = _num(pr.get("enqueued"))
                exp.add(
                    "tg_net_pair_bytes_total",
                    "counter",
                    "Per-(src,dst) group-pair wire bytes (enqueued "
                    "messages x fixed message size) — top-K pairs only.",
                    pident,
                    None if enq is None else enq * NM_MSG_BYTES,
                )
            exp.add(
                "tg_net_pairs_elided",
                "gauge",
                "Nonzero traffic-matrix pairs NOT exported as "
                "tg_net_pair_* series (the bounded-cardinality "
                "remainder; full matrix via tg netmap).",
                ident,
                nm.get("elided_pairs", 0),
            )
            exp.add(
                "tg_net_conservation_mismatches",
                "gauge",
                "Traffic-matrix channels whose cell sum failed to "
                "reconcile with the run's flow totals (0 = exact; "
                "nonzero is an engine bug).",
                ident,
                len(nm.get("mismatches"))
                if isinstance(nm.get("mismatches"), list)
                else None,
            )
        # checkpoint/resume plane (journal["sim"]["checkpoint"],
        # docs/CHECKPOINT.md): snapshot progress gauges so a scraper can
        # alert on a soak whose last checkpoint is falling behind
        ck = (
            sim.get("checkpoint")
            if isinstance(sim.get("checkpoint"), dict)
            else {}
        )
        if ck:
            exp.add(
                "tg_checkpoint_count",
                "gauge",
                "Snapshots the run wrote (checkpoint plane).",
                ident,
                ck.get("count"),
            )
            exp.add(
                "tg_checkpoint_last_tick",
                "gauge",
                "Sim tick of the run's newest snapshot.",
                ident,
                ck.get("last_tick"),
            )
            exp.add(
                "tg_checkpoint_bytes",
                "gauge",
                "Size in bytes of the run's newest snapshot.",
                ident,
                ck.get("bytes"),
            )
            exp.add(
                "tg_checkpoint_write_ms",
                "gauge",
                "Wall milliseconds the newest snapshot took to write "
                "(fetch + serialize + fsync + rename).",
                ident,
                ck.get("write_ms"),
            )
        # shape bucketing (journal["sim"]["bucket"], PERF.md "Serving:
        # buckets + packing"): the hit/miss counter pair makes a cold
        # compile in production observable, not silent — alert when
        # misses move after a `tg build --buckets` warmup
        bk = (
            sim.get("bucket") if isinstance(sim.get("bucket"), dict) else {}
        )
        if bk:
            verdict = bk.get("compile_cache")
            exp.add(
                "tg_compile_bucket_hit",
                "counter",
                "Bucketed runs whose program was served by the warm "
                "persistent compile cache (1 per run; sum across tasks).",
                ident,
                1 if verdict == "hit" else 0,
            )
            exp.add(
                "tg_compile_bucket_miss",
                "counter",
                "Bucketed runs that paid a cold XLA compile — the "
                "bucket ladder was not warmed for this program "
                "(tg build --buckets).",
                ident,
                1 if verdict == "miss" else 0,
            )
            exp.add(
                "tg_bucket_padded_instances",
                "gauge",
                "Canonical padded instance count of the run's bucket "
                "(live exact count rides tg_task_info/sim totals).",
                ident,
                bk.get("padded_instances"),
            )
        # run packing (journal["sim"]["pack"]): pack width + member
        # index so a scraper can see batched tenancy per task
        pk = sim.get("pack") if isinstance(sim.get("pack"), dict) else {}
        if pk:
            exp.add(
                "tg_pack_width",
                "gauge",
                "Vmapped run-axis width of the pack this run executed "
                "in (dummy padding lanes included).",
                ident,
                pk.get("width"),
            )
            exp.add(
                "tg_pack_members",
                "gauge",
                "Live member runs batched into this run's pack.",
                ident,
                pk.get("members"),
            )
        # transport resolution (journal["sim"]["transport"]): an info
        # gauge — constant 1, the record rides the labels. Cardinality
        # is bounded: requested/resolved come from the 3-value knob and
        # source from the model's fixed evidence kinds
        tr = (
            sim.get("transport")
            if isinstance(sim.get("transport"), dict)
            else {}
        )
        # the mesh plane (journal["sim"]["mesh"], docs/OBSERVABILITY.md
        # "Mesh plane"): layout labels are bounded by real hardware
        # topologies ("1", "4", "2x4", ...), never free-form
        mh = sim.get("mesh") if isinstance(sim.get("mesh"), dict) else {}
        if tr.get("resolved"):
            exp.add(
                "tg_transport_resolved",
                "gauge",
                "Transport gate resolution for this run (info gauge, "
                "value always 1): requested knob, resolved backend, the "
                "cost model's evidence source under transport=auto, and "
                "the mesh layout the decision was scored against.",
                {
                    **ident,
                    "requested": str(tr.get("requested", "?")),
                    "resolved": str(tr.get("resolved", "?")),
                    "source": str(
                        (tr.get("scores") or {}).get("source", "explicit")
                    ),
                    "mesh": str(mh.get("axes") or "1"),
                },
                1,
            )
        if mh:
            exp.add(
                "tg_mesh_shards",
                "gauge",
                "Peer shards the run's carry planes partitioned across "
                "(the mesh's instance axis; absent on a single device).",
                {**ident, "mesh": str(mh.get("axes") or "?")},
                mh.get("shards"),
            )
            exp.add(
                "tg_mesh_cross_shard_bytes_est",
                "gauge",
                "Modeled per-commit ICI exchange bytes of the sharded "
                "transport (the sorted stream's cross-shard fraction).",
                {**ident, "mesh": str(mh.get("axes") or "?")},
                mh.get("cross_shard_bytes_est"),
            )
        # phase attribution plane (journal["sim"]["phases"],
        # docs/OBSERVABILITY.md "Phase attribution"): per-phase cost
        # gauges plus the synthesized residual/total rows — the phase
        # label space is the fixed TICK_PHASES set + {residual, total},
        # so cardinality stays bounded
        phases = (
            sim.get("phases") if isinstance(sim.get("phases"), dict) else {}
        )
        if phases:
            from ..sim.phases import phase_rows

            for row in phase_rows(phases):
                pident = {
                    **ident,
                    "phase": row.get("phase", "?"),
                    "transport": row.get("transport", "xla"),
                }
                exp.add(
                    "tg_phase_flops",
                    "gauge",
                    "XLA cost-analysis FLOP estimate for one tick of one "
                    "phase (phase=residual/total are the coverage rows).",
                    pident,
                    row.get("flops"),
                )
                exp.add(
                    "tg_phase_bytes_accessed",
                    "gauge",
                    "XLA cost-analysis bytes-accessed estimate for one "
                    "tick of one phase.",
                    pident,
                    row.get("bytes_accessed"),
                )
                exp.add(
                    "tg_phase_measured_ms",
                    "gauge",
                    "Measured wall ms per call of one phase jitted in "
                    "isolation (phases_measure calibration).",
                    pident,
                    row.get("measured_ms"),
                )
    out = exp.render()
    # fleet latency histograms (engine claim bookkeeping): proper
    # Prometheus histogram series over the engine's log2 µs bins,
    # hand-assembled because the le-bucket lines share one TYPE header
    # with their _sum/_count
    if fleet:
        hist_lines: list[str] = []
        for name, bins_key, sum_key, help_ in (
            (
                "tg_fleet_queue_wait_seconds",
                "queue_wait_bins",
                "queue_wait_total_us",
                "Time claimed tasks spent queued (scheduled -> "
                "processing), log2 buckets.",
            ),
            (
                "tg_fleet_claim_latency_seconds",
                "claim_latency_bins",
                "claim_latency_total_us",
                "Claim overhead (processing stamp -> worker dispatch, "
                "pack admission included), log2 buckets.",
            ),
        ):
            bins = fleet.get(bins_key)
            if not bins:
                continue
            cum = 0
            lines = []
            for i, c in enumerate(bins):
                cum += int(_num(c) or 0)
                le = (
                    "+Inf"
                    if i == len(bins) - 1
                    else repr((1 << (i + 1)) / 1e6)
                )
                lines.append(f'{name}_bucket{{le="{le}"}} {cum}')
            total_us = _num(fleet.get(sum_key)) or 0
            lines.append(f"{name}_sum {total_us / 1e6}")
            lines.append(f"{name}_count {cum}")
            hist_lines.extend(
                [f"# HELP {name} {help_}", f"# TYPE {name} histogram"]
                + lines
            )
        if hist_lines:
            out = out.rstrip("\n") + "\n" + "\n".join(hist_lines) + "\n"
    return out
