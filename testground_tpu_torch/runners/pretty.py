"""Console renderers of the observability payloads — the port's copy of
the renderers of the reference's ``testground_tpu/runners/pretty.py``
that ``tg stats``, ``perf`` (``--phases``, ``--compare``), ``trace
--lifecycle``, ``netmap``, ``diff``, ``top`` and ``status --telemetry``
print, with their helpers, unchanged.

``render_sync_stats`` is what ``tg-torch sync-stats`` prints;
``PrettyPrinter`` is the ``local:exec`` runner's event console: it renders
instance event streams and counts failures (``pkg/runner/pretty.go:113-180``).
"""

from __future__ import annotations

import threading
import time
from typing import IO

from ..rpc import OutputWriter
from ..sdk.events import parse_event_line

# the shared ledger-consumer helpers (stdlib-only module, safe here):
# null/NaN/string fields from foreign writers degrade to readable
# placeholders, not TypeErrors or misleading blanks
from ..analysis.diff import fmt_rate as _fmt_rate
from ..analysis.diff import num as _num

__all__ = [
    "PrettyPrinter",
    "render_fleet",
    "render_lifecycle_tree",
    "render_netmap",
    "render_netmap_cut",
    "render_perf_summary",
    "render_phase_table",
    "render_run_diff",
    "render_sync_stats",
    "render_telemetry_summary",
]


def _fmt(v, spec: str = "{:.2f}", missing: str = "?") -> str:
    n = _num(v)
    return missing if n is None else spec.format(n)


def _fmt_count(v, missing: str = "?") -> str:
    """An integral count rendered verbatim — ``'{:g}'`` would truncate
    counts >= 1e6 into scientific notation (format(1234567, 'g') ==
    '1.23457e+06'), and tick totals get there routinely."""
    n = _num(v)
    if n is None:
        return missing
    return str(int(n)) if float(n).is_integer() else str(n)


def _fmt_transport(tr: dict) -> str:
    """One-line render of a ``sim.transport`` resolution block: the
    resolved backend, the requested→resolved arrow when they differ (or
    when the cost model decided), and the human-readable reason."""
    req = tr.get("requested", "?")
    res = tr.get("resolved", "?")
    shown = res if req == res else f"{req} → {res}"
    if tr.get("reason") and (req == "auto" or req != res):
        shown += f" ({tr['reason']})"
    return shown


def render_telemetry_summary(stats: dict) -> str:
    """Render a completed task's telemetry summary as an aligned table —
    the console surface of the sim telemetry plane (``tg stats <task>``
    and ``tg status --telemetry``; docs/OBSERVABILITY.md).

    ``stats`` is the /stats payload shape: identity fields plus the
    journal's ``sim`` / ``telemetry`` / ``events`` sections (all
    optional — non-sim tasks render whatever they have)."""
    sim = stats.get("sim") or {}
    tele = stats.get("telemetry") or {}
    trace = stats.get("trace") or {}
    slo = stats.get("slo") or {}
    events = stats.get("events") or {}
    ident = f"{stats.get('plan', '?')}:{stats.get('case', '?')}"
    if stats.get("task_id"):
        ident += f"  ({stats['task_id']})"
    if not (sim or tele or trace or slo or events):
        # e.g. a build task, or a run that recorded nothing
        return f"task  {ident}\nno telemetry recorded for this task"
    rows: list[tuple[str, str]] = [("task", ident)]
    if stats.get("outcome"):
        rows.append(("outcome", str(stats["outcome"])))
    if sim:
        ticks = _num(sim.get("ticks"), 0)
        tick_ms = _num(sim.get("tick_ms"), 0.0)
        rows.append(
            (
                "ticks",
                f"{_fmt_count(ticks)} ({ticks * tick_ms / 1000.0:.2f} "
                f"sim-s at {tick_ms:g} ms/tick)",
            )
        )
        rows.append(
            (
                "wall",
                f"{_fmt(sim.get('wall_secs'))}s (compile "
                f"{_fmt(sim.get('compile_secs'))}s) on "
                f"{_fmt(sim.get('devices'), '{:g}', '1')} device(s) / "
                f"{_fmt(sim.get('processes'), '{:g}', '1')} process(es)",
            )
        )
        carry = _num(sim.get("carry_bytes"))
        if carry is not None:
            rows.append(
                ("carry", f"{carry / 2**20:.2f} MiB device-resident")
            )
        # the mesh plane (journal["sim"]["mesh"]): layout + shard
        # extents + the modeled ICI exchange the transport decision
        # priced — one line, the full rule table stays in the journal
        mh = sim.get("mesh") or {}
        if mh.get("axes"):
            xb = _num(mh.get("cross_shard_bytes_est"))
            rows.append(
                (
                    "mesh",
                    "{a} ({s} peer shard(s) x {r} run shard(s), "
                    "~{x} ICI exchange/commit)".format(
                        a=mh.get("axes"),
                        s=_fmt_count(mh.get("shards")),
                        r=_fmt_count(mh.get("runs"), "1"),
                        x=f"{xb / 2**10:.1f} KiB"
                        if xb is not None
                        else "?",
                    ),
                )
            )
        # transport resolution (journal["sim"]["transport"]): requested
        # vs resolved plus the cost model's reason — e.g. "auto → pallas
        # (commit+deliver bytes 2.1x the single-pass kernel estimate)"
        tr = sim.get("transport") or {}
        if tr.get("resolved"):
            rows.append(("transport", _fmt_transport(tr)))
        # run packing (journal["sim"]["pack"]): a packed member shows
        # its slot; a pack-opted run that executed SOLO shows why — the
        # supervisor journals solo_reason so the tenant never has to
        # guess what kept their run out of a pack
        pk = sim.get("pack") or {}
        if pk.get("solo_reason"):
            rows.append(("pack", f"solo — {pk['solo_reason']}"))
        elif pk.get("width"):
            rows.append(
                (
                    "pack",
                    "member {m}/{n} of a width-{w} pack "
                    "(leader {l})".format(
                        # journal index is 0-based; humans count from 1
                        m=_fmt_count(
                            (_num(pk.get("index"), 0) or 0) + 1, "?"
                        ),
                        n=_fmt_count(pk.get("members")),
                        w=_fmt_count(pk.get("width")),
                        l=pk.get("leader_run", "?"),
                    ),
                )
            )
        # one-line performance-ledger teaser (full view: `tg perf`)
        perf_ex = (sim.get("perf") or {}).get("execute") or {}
        rate = _num(perf_ex.get("steady_peer_ticks_per_sec")) or _num(
            perf_ex.get("peer_ticks_per_sec")
        )
        if rate:
            rows.append(
                ("perf", f"{rate:,.0f} peer·ticks/s (details: tg perf)")
            )
        rows.append(
            (
                "messages",
                "delivered={d} enqueued={e} dropped={x} rejected={r} "
                "in-flight={f}".format(
                    d=sim.get("msgs_delivered", 0),
                    e=sim.get("msgs_enqueued", 0),
                    x=sim.get("msgs_dropped", 0),
                    r=sim.get("msgs_rejected", 0),
                    f=sim.get("msgs_in_flight", 0),
                ),
            )
        )
        for key, label in (
            ("latency_clamped", "horizon-clamped"),
            ("bw_queue_dropped", "bw-queue-dropped"),
        ):
            if sim.get(key):
                rows.append((label, str(sim[key])))
        # fault-injection plane (docs/FAULTS.md): one line when any
        # counter is nonzero — a chaos run's verdict at a glance
        if any(
            sim.get(k)
            for k in (
                "faults_crashed",
                "faults_restarted",
                "msgs_fault_dropped",
            )
        ):
            rows.append(
                (
                    "faults",
                    "crashed={c} restarted={r} fault-dropped={d}".format(
                        c=sim.get("faults_crashed", 0),
                        r=sim.get("faults_restarted", 0),
                        d=sim.get("msgs_fault_dropped", 0),
                    ),
                )
            )
        # checkpoint/resume plane (docs/CHECKPOINT.md): last-snapshot
        # tick + resume provenance at a glance
        ck = sim.get("checkpoint") or {}
        if ck:
            parts = []
            if _num(ck.get("count"), 0):
                parts.append(
                    "{n} snapshot(s), last at tick {t} "
                    "({d}/, {b:.2f} MiB)".format(
                        n=_fmt_count(ck.get("count")),
                        t=_fmt_count(ck.get("last_tick")),
                        d=ck.get("dir", "checkpoints"),
                        b=(_num(ck.get("bytes"), 0) or 0) / 2**20,
                    )
                )
            elif _num(ck.get("every_chunks"), 0):
                parts.append("armed, none written")
            resumed = ck.get("resumed") or {}
            if resumed:
                parts.append(
                    "resumed from tick {t} of run {r}".format(
                        t=_fmt_count(resumed.get("from_tick")),
                        r=resumed.get("from_run", "?"),
                    )
                )
            if parts:
                rows.append(("checkpoint", "; ".join(parts)))
        # per-receiver-group delivery-latency percentiles (telemetry
        # plane histograms, docs/OBSERVABILITY.md) — one line per group
        for gid, pct in sorted((sim.get("latency") or {}).items()):
            if not _num(pct.get("count"), 0):
                rows.append((f"latency {gid}", "no deliveries"))
                continue
            rows.append(
                (
                    f"latency {gid}",
                    "p50={p50}ms p95={p95}ms p99={p99}ms (n={n})".format(
                        p50=pct.get("p50_ms", "?"),
                        p95=pct.get("p95_ms", "?"),
                        p99=pct.get("p99_ms", "?"),
                        n=pct["count"],
                    ),
                )
            )
    if tele:
        shown = f"{tele.get('rows', 0)} per-tick rows"
        if tele.get("file"):  # absent when no outputs dir held the series
            shown += f" ({tele['file']})"
        rows.append(("telemetry", shown))
    if trace:
        shown = (
            f"{trace.get('events', 0)} events from "
            f"{trace.get('instances', 0)} instance(s)"
        )
        files = [trace.get("file"), trace.get("events_file")]
        files = [f for f in files if f]
        if files:
            shown += f" ({', '.join(files)})"
        if trace.get("truncated"):
            shown += f" — {trace['truncated']} past the export cap"
        rows.append(("trace", shown))
    # run health plane (docs/OBSERVABILITY.md "Run health plane"): one
    # verdict line per rule — "ok" or the breach count with the worst
    # observed value, so a soak's health reads at a glance
    for r in slo.get("rules") or []:
        if not isinstance(r, dict):
            continue
        rule = (
            f"{r.get('metric', '?')} {r.get('op', '?')} "
            f"{_fmt(r.get('threshold'), '{:g}')}"
        )
        n = _num(r.get("breaches"), 0)
        if n:
            verdict = (
                f"{rule} — {_fmt_count(n)} breach(es) "
                f"[{r.get('severity', 'warn')}], worst "
                f"{_fmt(r.get('worst'), '{:g}')} "
                f"(ticks {r.get('first_tick', '?')}–{r.get('last_tick', '?')})"
            )
        else:
            verdict = rule + " — ok"
            if _num(r.get("last_observed")) is not None:
                verdict += f" (last {_fmt(r.get('last_observed'), '{:g}')})"
        rows.append((f"slo {r.get('name', '?')}", verdict))
    if slo.get("error"):
        rows.append(("slo FAILED", str(slo["error"])))
    for gid, counts in sorted(events.items()):
        if isinstance(counts, dict):
            shown = ", ".join(
                f"{k}={v}" for k, v in sorted(counts.items()) if v
            )
            rows.append((f"group {gid}", shown or "-"))
    width = max(len(k) for k, _ in rows)
    return "\n".join(f"{k:<{width}}  {v}" for k, v in rows)


def _fmt_us(v) -> str:
    """A µs duration with a readable unit (µs/ms/s)."""
    n = _num(v)
    if n is None:
        return "?"
    if n >= 1e6:
        return f"{n / 1e6:.2f}s"
    if n >= 1e3:
        return f"{n / 1e3:.2f}ms"
    return f"{n:.0f}µs"


def render_sync_stats(stats: dict) -> str:
    """Render a ``sync_stats`` snapshot as an aligned table — the
    console surface of the sync-plane stats tier (``tg sync-stats
    <host:port>``; docs/OBSERVABILITY.md "Sync plane").

    ``stats`` is the wire reply minus ``id`` (v1 or v2): a v1 server
    renders its three occupancy integers plus an upgrade hint; a v2
    server renders op counters with interpolated service-time
    percentiles, barrier lifecycle + release-vs-fan-in timing, pubsub
    depth and connection churn."""
    lines = []
    boot = str(stats.get("boot", "?"))
    head = f"sync service   boot {boot[:12]}"
    if stats.get("v"):
        up = _num(stats.get("uptime_secs"))
        head += f"   stats v{stats['v']}"
        if up is not None:
            head += f"   up {up:.0f}s"
    lines.append(head)
    lines.append(
        f"occupancy      conns {_fmt_count(stats.get('conns'))}   "
        f"waiters {_fmt_count(stats.get('waiters'))}   "
        f"subs {_fmt_count(stats.get('subs'))}"
    )
    if not stats.get("v"):
        lines.append(
            "(v1 server: occupancy only — op-level metrics need a "
            "server with the sync-stats plane)"
        )
        return "\n".join(lines)
    conn = stats.get("conn") or {}
    lines.append(
        f"conn churn     accepts {_fmt_count(conn.get('accepts'))}   "
        f"closes {_fmt_count(conn.get('closes'))}   "
        f"evictions {_fmt_count(conn.get('evictions'))}   "
        f"hwm {_fmt_count(conn.get('hwm'))}"
    )
    bar = stats.get("barriers") or {}
    lines.append(
        f"barriers       parked {_fmt_count(bar.get('parked'))}   "
        f"released {_fmt_count(bar.get('released'))}   "
        f"timed-out {_fmt_count(bar.get('timed_out'))}   "
        f"canceled {_fmt_count(bar.get('canceled'))}"
    )
    ps = stats.get("pubsub") or {}
    lines.append(
        f"pubsub         topics {_fmt_count(ps.get('topics'))}   "
        f"entries {_fmt_count(ps.get('entries'))}   "
        f"published {_fmt_count(ps.get('published'))}   "
        f"depth-hwm {_fmt_count(ps.get('depth_hwm'))}   "
        f"subs-hwm {_fmt_count(ps.get('subs_hwm'))}"
    )
    dd = stats.get("dedup") or {}
    lines.append(
        f"dedup hits     signal {_fmt_count(dd.get('signal_hits'))}   "
        f"publish {_fmt_count(dd.get('publish_hits'))}"
    )
    ops = stats.get("ops") or {}
    op_time = stats.get("op_time_us") or {}
    active = [(op, n) for op, n in ops.items() if _num(n)]
    if active:
        from ..sync.stats import hist_quantile_us

        lines.append("")
        lines.append(
            f"{'op':<16}{'count':>10}{'p50':>10}{'p95':>10}"
            f"{'p99':>10}{'max':>10}"
        )
        for op, n in sorted(active, key=lambda kv: -int(_num(kv[1]) or 0)):
            rec = op_time.get(op) or {}
            bins = rec.get("bins") or []
            if bins and sum(bins):
                # clamp to the observed max: log2-bin interpolation can
                # overshoot the slowest real sample inside the top bin
                cap = _num(rec.get("max_us")) or float("inf")
                p50, p95, p99 = (
                    _fmt_us(min(cap, hist_quantile_us(bins, q)))
                    for q in (0.50, 0.95, 0.99)
                )
                mx = _fmt_us(rec.get("max_us"))
            else:
                p50 = p95 = p99 = mx = "-"
            lines.append(
                f"{op:<16}{_fmt_count(n):>10}{p50:>10}{p95:>10}"
                f"{p99:>10}{mx:>10}"
            )
    by_target = ((bar.get("episodes") or {}).get("by_target")) or {}
    if by_target:
        lines.append("")
        lines.append("barrier release vs fan-in width (armed → release):")
        # bucket keys are strings in decoded JSON; a foreign
        # non-numeric key sorts last, never raises
        for bucket in sorted(
            by_target,
            key=lambda b: (
                int(b) if str(b).lstrip("-").isdigit() else float("inf")
            ),
        ):
            rec = by_target[bucket] or {}
            count = _num(rec.get("count")) or 0
            mean = (
                (_num(rec.get("total_ms")) or 0.0) / count if count else 0.0
            )
            lines.append(
                f"  target ≤{bucket:<8} episodes {int(count):<7} "
                f"mean {mean:.2f}ms   max "
                f"{_fmt(rec.get('max_ms'), '{:.2f}')}ms"
            )
    return "\n".join(lines)


def _fmt_bytes(v) -> str:
    n = _num(v)
    if n is None:
        return "?"
    for div, suffix in ((2**30, "GiB"), (2**20, "MiB"), (2**10, "KiB")):
        if abs(n) >= div:
            return f"{n / div:.2f} {suffix}"
    return f"{n:.0f} B"


def render_perf_summary(payload: dict) -> str:
    """Render a task's performance ledger as an aligned table — the
    console surface of the perf plane (``tg perf <task>``;
    docs/OBSERVABILITY.md "Performance ledger").

    ``payload`` is the /perf payload shape (Task.perf_payload): identity
    + ``sim`` + ``perf`` + ``task``, every field optional — absent, zero
    or NaN fields render as ``?`` lines or are dropped, never as
    misleading blanks."""
    sim = payload.get("sim") or {}
    perf = payload.get("perf") or {}
    task = payload.get("task") or {}
    ident = f"{payload.get('plan', '?')}:{payload.get('case', '?')}"
    if payload.get("task_id"):
        ident += f"  ({payload['task_id']})"
    rows: list[tuple[str, str]] = [("task", ident)]
    if payload.get("outcome"):
        rows.append(("outcome", str(payload["outcome"])))
    if not perf and not sim:
        # multi-run compositions journal per-run results (no top-level
        # sim block yet), and disable_metrics / cohorts / perf=false run
        # ledger-free — say so, but still render the scheduler timings
        # the supervisor recorded for exactly this surface
        rows.append(
            (
                "ledger",
                "no performance ledger recorded (a multi-run composition, "
                "disable_metrics, a cohort run, or runner config "
                "perf=false)",
            )
        )
    co = perf.get("compile") or {}
    ex = perf.get("execute") or {}
    if perf or sim:
        # the compile split: the journal's compile_secs (init + first
        # dispatch) beside the AOT pass's true lower-vs-XLA breakdown
        split = (
            f" (AOT lower {_fmt(co.get('lower_secs'))}s + "
            f"xla {_fmt(co.get('compile_secs'))}s)"
            if co
            else ""
        )
        rows.append(
            (
                "compile",
                f"{_fmt(sim.get('compile_secs'))}s first dispatch{split}",
            )
        )
        # the mesh the ledger's rates were measured on — a 4-shard run
        # and a single-device run are different machines, not noise
        mh = sim.get("mesh") or {}
        if mh.get("axes"):
            rows.append(
                (
                    "mesh",
                    f"{mh.get('axes')} "
                    f"({_fmt_count(mh.get('shards'))} peer shard(s))",
                )
            )
        # transport resolution — the backend this ledger measured, and
        # why the gate picked it (the cost model's reason under auto)
        tr = sim.get("transport") or {}
        if tr.get("resolved"):
            rows.append(("transport", _fmt_transport(tr)))
    # ``instances`` in the ledger is the EXACT live count — padded or
    # packed runs must never render inflated peer·ticks/s (the bucket
    # size is a separate annotation line below)
    n_inst = _num(perf.get("instances"), 0)
    bucket = perf.get("bucket") or (sim.get("bucket") or {}).get(
        "padded_instances"
    )
    if _num(bucket) and _num(bucket) != n_inst:
        # the bucket's compile_cache verdict: hit or miss on the card (the
        # kernel library's cold start), off on the CPU, unknown on a resume
        cache = (sim.get("bucket") or {}).get("compile_cache")
        rows.append(
            (
                "bucket",
                f"{_fmt_count(n_inst)} live instance(s) padded to "
                f"{_fmt_count(bucket)}"
                + (f" — compile cache {cache}" if cache else ""),
            )
        )
    pack = sim.get("pack") or {}
    if pack.get("solo_reason"):
        rows.append(("pack", f"solo — {pack['solo_reason']}"))
    elif _num(pack.get("width")):
        rows.append(
            (
                "pack",
                # journal index is 0-based; humans count from 1
                f"run {_fmt_count(_num(pack.get('index'), 0) + 1)} of a "
                f"{_fmt_count(pack.get('members'))}-member pack "
                f"(vmapped width {_fmt_count(pack.get('width'))})",
            )
        )
    if ex:
        rows.append(
            (
                "execute",
                f"{_fmt_count(ex.get('ticks'))} ticks in "
                f"{_fmt(ex.get('wall_secs'))}s — "
                f"{_fmt_rate(ex.get('ticks_per_sec'))} ticks/s, "
                f"{_fmt_rate(ex.get('peer_ticks_per_sec'))} peer·ticks/s "
                f"({_fmt_count(n_inst)} instance(s), "
                f"{_fmt_count(ex.get('chunks'))} chunk(s))",
            )
        )
        if _num(ex.get("steady_peer_ticks_per_sec")):
            rows.append(
                (
                    "steady",
                    f"{_fmt_rate(ex.get('steady_ticks_per_sec'))} ticks/s, "
                    f"{_fmt_rate(ex.get('steady_peer_ticks_per_sec'))} "
                    f"peer·ticks/s over "
                    f"{_fmt_count(ex.get('steady_chunks'))} steady "
                    "chunk(s)",
                )
            )
    flops = _num(co.get("flops"))
    if flops:
        achieved = (
            f" (achieved {_fmt_rate(ex.get('est_flops_per_sec'))} flop/s)"
            if _num(ex.get("est_flops_per_sec"))
            else ""
        )
        rows.append(
            (
                "cost",
                f"~{_fmt_rate(flops)} flops, "
                f"{_fmt_bytes(co.get('bytes_accessed'))} accessed "
                f"per chunk{achieved}",
            )
        )
    if _num(co.get("peak_bytes")) is not None:
        rows.append(
            (
                "program",
                f"args {_fmt_bytes(co.get('argument_bytes'))} + "
                f"temp {_fmt_bytes(co.get('temp_bytes'))} + "
                f"codegen {_fmt_bytes(co.get('generated_code_bytes'))} "
                f"= peak {_fmt_bytes(co.get('peak_bytes'))}",
            )
        )
    carry = _num(sim.get("carry_bytes"))
    if carry is not None:
        rows.append(("carry", f"{_fmt_bytes(carry)} device-resident"))
    hbm = perf.get("hbm") or {}
    if _num(hbm.get("peak_bytes")):
        limit = (
            f" of {_fmt_bytes(hbm['bytes_limit'])}"
            if _num(hbm.get("bytes_limit"))
            else ""
        )
        rows.append(
            ("hbm", f"high-water {_fmt_bytes(hbm['peak_bytes'])}{limit}")
        )
    elif perf:
        rows.append(("hbm", "no memory stats on this backend"))
    if task:
        bits = []
        if _num(task.get("queued_secs")) is not None:
            bits.append(f"queued {_fmt(task.get('queued_secs'))}s")
        for rid, wall in sorted((task.get("runner_wall_secs") or {}).items()):
            bits.append(f"run {rid} {_fmt(wall)}s")
        if bits:
            rows.append(("sched", ", ".join(bits)))
    series = perf.get("series") or {}
    if _num(series.get("rows")):
        shown = f"{_fmt_count(series['rows'])} per-chunk rows"
        if series.get("file"):
            shown += f" ({series['file']})"
        rows.append(("series", shown))
    width = max(len(k) for k, _ in rows)
    return "\n".join(f"{k:<{width}}  {v}" for k, v in rows)


def _fmt_diff_value(v) -> str:
    """One side of an exact-compared row: scalars verbatim, digested
    objects (the traffic matrix) as their bounded summary."""
    if isinstance(v, dict) and "sha1" in v:
        return f"Σ{_fmt_count(v.get('sum'))} #{v['sha1']}"
    if isinstance(v, float):
        return _fmt(v, "{:g}")
    if v is None:
        return "absent"
    return str(v)


def render_run_diff(doc: dict) -> str:
    """Render a RunDiff document as an aligned table — the console
    surface of the cross-run analysis plane (``tg diff <a> <b>``;
    docs/OBSERVABILITY.md "Run diff").

    Exact planes render their compared/mismatched counts with one line
    per MISMATCH (equality is the expected, quiet case); the perf plane
    renders every judged metric with its verdict, sample counts and
    p-value so the statistics stay auditable; the final line is the
    roll-up verdict."""
    a, b = doc.get("a") or {}, doc.get("b") or {}
    rows: list[tuple[str, str]] = []
    for side, ident in (("a", a), ("b", b)):
        shown = (
            f"{ident.get('plan', '?')}:{ident.get('case', '?')}  "
            f"({ident.get('task_id', '?')})  {ident.get('outcome', '?')}"
        )
        if _num(ident.get("ticks")) is not None:
            shown += f"  {_fmt_count(ident['ticks'])} ticks"
        if _num(ident.get("wall_secs")) is not None:
            shown += f" / {_fmt(ident['wall_secs'])}s"
        rows.append((side, shown))
    setup = doc.get("setup") or {}
    if setup.get("identical"):
        shown = (
            "identical composition + seed — every deterministic counter "
            "must match exactly"
        )
    else:
        diffs = setup.get("diffs") or []
        shown = "setups differ"
        if diffs:
            shown += f" ({', '.join(diffs[:6])}"
            shown += ", …)" if len(diffs) > 6 else ")"
        elif setup.get("note"):
            shown += f" ({setup['note']})"
        shown += " — counter deltas are informational"
    rows.append(("setup", shown))
    # ----- exact planes: compared/mismatched + one line per mismatch
    for plane in ("counters", "latency", "phases", "slo", "netmatrix"):
        block = doc.get(plane)
        if not isinstance(block, dict):
            continue
        if block.get("absent"):
            rows.append((plane, block["absent"]))
            continue
        compared = block.get("compared", 0)
        mismatched = block.get("mismatched", 0)
        verdict = (
            "exact equality"
            if not mismatched
            else f"{mismatched} MISMATCH(ES)"
        )
        rows.append((plane, f"{compared} compared — {verdict}"))
        for row in block.get("rows") or []:
            if row.get("equal"):
                continue
            rows.append(
                (
                    "",
                    f"  {row.get('name')}: "
                    f"a={_fmt_diff_value(row.get('a'))}  "
                    f"b={_fmt_diff_value(row.get('b'))}",
                )
            )
    # ----- perf plane: judged metrics with auditable statistics
    perf = doc.get("perf")
    if isinstance(perf, dict):
        if perf.get("absent"):
            rows.append(("perf", perf["absent"]))
        for m in perf.get("metrics") or []:
            shown = (
                f"{m.get('verdict', '?'):<12} "
                f"a~{_fmt_rate(m.get('median_a'))} "
                f"b~{_fmt_rate(m.get('median_b'))}"
            )
            if _num(m.get("ratio")) is not None:
                shown += f"  x{_fmt(m['ratio'], '{:.3f}')}"
            if _num(m.get("p_value")) is not None:
                shown += f"  p={_fmt(m['p_value'], '{:.4g}')}"
            shown += f"  (n={m.get('n_a', 0)}/{m.get('n_b', 0)})"
            rows.append((str(m.get("metric", "?")), shown))
        for s in perf.get("scalars") or []:
            rows.append(
                (
                    str(s.get("metric", "?")),
                    f"a={_fmt_rate(s.get('a'))} b={_fmt_rate(s.get('b'))} "
                    f"x{_fmt(s.get('ratio'), '{:.3f}')}  "
                    "(summary — one sample, no verdict)",
                )
            )
    # ----- roll-up
    findings = doc.get("findings") or []
    verdict = str(doc.get("verdict", "?"))
    if findings:
        verdict += (
            f" — {len(findings)} CORRECTNESS finding(s): deterministic "
            "counters diverged between identically-seeded runs"
        )
    elif doc.get("regressed"):
        verdict += f" — {', '.join(doc['regressed'])}"
    elif doc.get("improved"):
        verdict += f" — {', '.join(doc['improved'])}"
    rows.append(("verdict", verdict))
    width = max(len(k) for k, _ in rows)
    return "\n".join(
        f"{k:<{width}}  {v}" if k else f"{'':<{width}}  {v}"
        for k, v in rows
    )


def render_phase_table(payload: dict) -> str:
    """Render the phase attribution block as an aligned per-phase table
    (``tg perf --phases``; docs/OBSERVABILITY.md "Phase attribution").

    One row per tick phase (XLA cost-analysis flops / bytes accessed
    per tick, the byte share of the whole program, and the measured
    ms/tick when the run calibrated), then the explicit residual and
    whole-program rows — the rows sum to the whole-program cost BY
    CONSTRUCTION (residual := whole − Σ phases; a negative residual
    means the standalone phases lose fusion the whole program has).
    Shape-tolerant like every payload renderer: absent blocks render a
    hint, never a crash."""
    from ..sim.phases import phase_rows

    block = payload.get("phases") or (payload.get("sim") or {}).get(
        "phases"
    )
    if not isinstance(block, dict) or not block.get("phases"):
        return (
            "no phase attribution recorded — run with --run-cfg "
            "phases=true (and phases_measure=K for measured ms/tick); "
            "cohorts and disable_metrics run phase-free"
        )
    rows = phase_rows(block)
    measured = any(_num(r.get("measured_ms")) is not None for r in rows)
    head = ["phase", "flops/tick", "bytes/tick", "byte-share"]
    if measured:
        head.append("ms/tick")
    table = [head]
    for r in rows:
        share = _num(r.get("bytes_frac"))
        line = [
            str(r.get("phase", "?")),
            _fmt_rate(r.get("flops")),
            _fmt_bytes(r.get("bytes_accessed")),
            f"{share * 100:.1f}%" if share is not None else "",
        ]
        if measured:
            ms = _num(r.get("measured_ms"))
            line.append(f"{ms:.3f}" if ms is not None else "")
        table.append(line)
    widths = [
        max(len(row[i]) for row in table) for i in range(len(head))
    ]
    lines = [
        "  ".join(
            cell.ljust(w) if i == 0 else cell.rjust(w)
            for i, (cell, w) in enumerate(zip(row, widths))
        ).rstrip()
        for row in table
    ]
    meta = (
        f"transport={block.get('transport', '?')}  "
        f"chunk={block.get('chunk', '?')}  "
        f"instances={block.get('instances', '?')}"
    )
    cov = block.get("coverage") or {}
    if _num(cov.get("bytes_frac")) is not None:
        meta += f"  byte-coverage=x{cov['bytes_frac']:.2f}"
    return "\n".join([meta] + lines)


def _heat_shade(v, peak) -> str:
    """A 4-step intensity glyph for a heatmap cell — zero-safe (a peak
    of 0, None or NaN renders every cell cold, never divides)."""
    n = _num(v, 0) or 0
    p = _num(peak, 0) or 0
    if n <= 0 or p <= 0:
        return " "
    return "░▒▓█"[min(3, int(3 * n / p))]


def render_netmap(block: dict, ident: str = "") -> str:
    """Render a ``sim.net_matrix`` journal block as the ``tg netmap``
    screen: the src-group × dst-group sent-count heatmap, the per-pair
    problem lines (any drops / rejections / chaos losses), link-shaping
    observables, and the conservation verdict. Shape-tolerant like
    every payload renderer — absent/NaN fields degrade to readable
    placeholders, never a crash (``block`` is decoded JSON from a
    possibly foreign writer)."""
    from ..sim.netmatrix import (
        NM_CHANNEL_NAMES,
        NM_MSG_BYTES,
        NM_SENT,
    )

    labels = [str(g) for g in (block.get("labels") or [])]
    mat = block.get("matrix") or []
    gh = len(labels)
    if not gh or len(mat) <= NM_SENT:
        return "no traffic matrix in this block"

    def cell(c, s, t) -> int:
        try:
            return int(_num(mat[c][s][t], 0) or 0)
        except (IndexError, TypeError):
            return 0

    lines = []
    head = "traffic matrix"
    if ident:
        head += f"  {ident}"
    lines.append(head)
    totals = block.get("totals") or {}
    lines.append(
        "totals  "
        + " ".join(
            f"{name}={_fmt_count(totals.get(name), '0')}"
            for name in NM_CHANNEL_NAMES
        )
    )
    if _num(block.get("bytes_total")) is not None:
        lines.append(
            f"bytes   {_fmt_bytes(block['bytes_total'])} enqueued on the "
            f"wire ({NM_MSG_BYTES} B/message)"
        )
    mismatches = block.get("mismatches") or []
    for m in mismatches:
        lines.append(f"CONSERVATION FAILED: {m}")

    # --- the heatmap: sent counts, shaded against the hottest pair
    peak = max(
        (cell(NM_SENT, s, t) for s in range(gh) for t in range(gh)),
        default=0,
    )
    cells = [
        [
            (
                f"{_heat_shade(cell(NM_SENT, s, t), peak)}"
                f"{cell(NM_SENT, s, t)}"
                if cell(NM_SENT, s, t)
                else "·"
            )
            for t in range(gh)
        ]
        for s in range(gh)
    ]
    col_w = [
        max(len(labels[t]), max(len(cells[s][t]) for s in range(gh)))
        for t in range(gh)
    ]
    row_w = max(len("sent ↓src→dst"), max(len(x) for x in labels))
    lines.append("")
    lines.append(
        f"{'sent ↓src→dst':<{row_w}}  "
        + "  ".join(f"{labels[t]:>{col_w[t]}}" for t in range(gh))
    )
    for s in range(gh):
        lines.append(
            f"{labels[s]:<{row_w}}  "
            + "  ".join(f"{cells[s][t]:>{col_w[t]}}" for t in range(gh))
        )

    # --- problem pairs: anything that did not arrive, attributed
    problems = []
    for s in range(gh):
        for t in range(gh):
            lost = [
                (name, cell(c, s, t))
                for c, name in enumerate(NM_CHANNEL_NAMES)
                if name in ("dropped", "rejected", "fault_dropped")
                and cell(c, s, t)
            ]
            if lost:
                problems.append(
                    f"  {labels[s]}→{labels[t]}: "
                    + " ".join(f"{n}={v}" for n, v in lost)
                )
    if problems:
        lines.append("")
        lines.append("lossy pairs:")
        lines.extend(problems)

    # --- link-shaping observables
    hi = block.get("bw_queue_hiwater") or []
    if any((_num(v, 0) or 0) > 0 for v in hi):
        lines.append("")
        lines.append(
            "bandwidth-queue depth high-water (messages, per src group): "
            + "  ".join(
                f"{labels[i]}={_fmt(hi[i], '{:g}')}"
                for i in range(min(gh, len(hi)))
                if (_num(hi[i], 0) or 0) > 0
            )
        )
    fp = block.get("faulted_pairs") or []
    faulted = [
        f"{labels[s]}→{labels[t]} ({int(_num(fp[s][t], 0) or 0)} window(s))"
        for s in range(min(gh, len(fp)))
        for t in range(min(gh, len(fp[s])))
        if (_num(fp[s][t], 0) or 0) > 0
    ]
    if faulted:
        lines.append("")
        lines.append("chaos-degraded pairs: " + ", ".join(faulted))
    if not mismatches:
        lines.append("")
        lines.append("conservation: exact (Σ cells == flow totals)")
    if block.get("file"):
        lines.append(
            f"stream: {block['file']} "
            f"({_fmt_count(block.get('chunks'), '?')} chunk row(s))"
        )
    return "\n".join(lines)


def render_netmap_cut(rec: dict, shards: int) -> str:
    """Render a :func:`~testground_tpu_torch.sim.netmatrix.cut_advisor`
    recommendation (``tg netmap --cut N``): the group→shard assignment
    plus the cross-cut volume it costs — zero-safe when there is no
    cross-group traffic at all."""
    lines = [
        f"cut advisor — {shards} shard(s), "
        f"{rec.get('method', '?')} search"
    ]
    for i, members in enumerate(rec.get("shards") or []):
        lines.append(f"  shard {i}: {', '.join(str(m) for m in members)}")
    cut = _num(rec.get("cut"), 0) or 0
    total = _num(rec.get("total"), 0) or 0
    frac = _num(rec.get("cut_fraction"), 0) or 0
    lines.append(
        f"cross-cut traffic: {_fmt_bytes(cut)} of {_fmt_bytes(total)} "
        f"cross-group bytes ({frac * 100:.1f}%)"
        if total > 0
        else "cross-cut traffic: none (no cross-group traffic measured)"
    )
    return "\n".join(lines)


def render_fleet(payload: dict) -> str:
    """Render a ``GET /fleet`` snapshot (engine.fleet_payload) as the
    ``tg top`` screen: one header block (workers / queue / per-state
    counts over the FULL store) plus one row per live task.
    Shape-tolerant like every payload renderer."""
    workers = payload.get("workers") or {}
    queue = payload.get("queue") or {}
    counts = payload.get("counts") or {}
    lines = [
        "workers {busy}/{total} busy · queue depth {depth} · "
        "tasks {total_tasks} ({states})".format(
            busy=_fmt_count(workers.get("busy"), "0"),
            total=_fmt_count(workers.get("total"), "0"),
            depth=_fmt_count(queue.get("depth"), "0"),
            total_tasks=_fmt_count(payload.get("tasks_total"), "0"),
            states=" ".join(
                f"{k}={v}" for k, v in sorted(counts.items())
            )
            or "none",
        )
    ]
    if payload.get("draining"):
        # graceful drain in progress (docs/FLEET.md): workers park,
        # running tasks checkpoint + requeue
        lines.append("DRAINING — not claiming; running tasks checkpointing")
    by_prio = queue.get("by_priority") or {}
    if by_prio:
        lines.append(
            "queue by priority: "
            + "  ".join(
                f"p{p}={n}"
                for p, n in sorted(
                    by_prio.items(),
                    # priority keys are strings in decoded JSON; a
                    # foreign non-numeric key sorts last, never raises
                    key=lambda kv: -(
                        _num(
                            int(kv[0])
                            if str(kv[0]).lstrip("-").isdigit()
                            else None,
                            float("-inf"),
                        )
                    ),
                )
            )
        )
    packs = (payload.get("pack") or {}).get("running")
    if packs:
        lines.append(f"running packs: {_fmt_count(packs)}")
    rows = payload.get("tasks") or []
    if not rows:
        lines.append("(no queued or running tasks)")
        return "\n".join(lines)
    head = [
        "ID", "STATE", "PRIO", "QUEUED", "RUNNING", "TICKS/S",
        "PACK", "PRE", "BREACH", "NAME",
    ]
    table = [head]
    for r in rows:
        table.append(
            [
                str(r.get("id", "?")),
                str(r.get("state", "?")),
                _fmt_count(r.get("priority"), "0"),
                _fmt(r.get("queued_secs"), "{:.1f}s", "?"),
                _fmt(r.get("running_secs"), "{:.1f}s", ""),
                _fmt_rate(r.get("ticks_per_sec"))
                if r.get("ticks_per_sec") is not None
                else "",
                _fmt_count(r.get("pack_width"), ""),
                # PRE: times this task was preempted/migrated so far
                _fmt_count(r.get("preemptions"), ""),
                _fmt_count(r.get("breaches"), ""),
                str(r.get("name", "")),
            ]
        )
    widths = [max(len(row[i]) for row in table) for i in range(len(head))]
    lines += [
        "  ".join(
            cell.ljust(w) if i in (0, 1, 9) else cell.rjust(w)
            for i, (cell, w) in enumerate(zip(row, widths))
        ).rstrip()
        for row in table
    ]
    return "\n".join(lines)


def render_lifecycle_tree(spans: list) -> str:
    """Render a task's lifecycle span tree (``task_spans.jsonl`` rows —
    engine/tracetree.py) as an indented tree: every child under its
    parent_id, durations in ms, and the control-plane attributes that
    explain scheduling (pack width / solo reason / outcome). Orphan
    spans (parent_id missing from the file) render as extra roots so a
    broken tree is VISIBLE, not silently reshaped."""
    spans = [s for s in spans if isinstance(s, dict) and s.get("span_id")]
    if not spans:
        return "no lifecycle spans"
    by_id = {s["span_id"]: s for s in spans}
    children: dict[str, list] = {}
    roots = []
    for s in spans:
        parent = s.get("parent_id", "")
        if parent and parent in by_id:
            children.setdefault(parent, []).append(s)
        else:
            roots.append(s)
    for kids in children.values():
        kids.sort(key=lambda s: (s.get("start_ns", 0), s["span_id"]))
    roots.sort(key=lambda s: (s.get("start_ns", 0), s["span_id"]))

    _ATTR_SKIP = (
        "name", "trace_id", "span_id", "parent_id", "start_ns",
        "end_ns", "kind",
    )

    def line(s: dict, depth: int) -> str:
        # explicit nulls from a foreign writer must not TypeError here
        dur_ms = (
            max(
                0,
                (_num(s.get("end_ns"), 0) or 0)
                - (_num(s.get("start_ns"), 0) or 0),
            )
            / 1e6
        )
        text = f"{'  ' * depth}{s.get('name', '?')}"
        if s.get("kind") == "point":
            text += "  ·"
        else:
            text += f"  {dur_ms:.1f}ms"
        attrs = {
            k: v
            for k, v in s.items()
            if k not in _ATTR_SKIP and v not in ("", None)
        }
        if attrs:
            text += "  " + " ".join(
                f"{k}={v}" for k, v in sorted(attrs.items())
            )
        return text

    out: list[str] = []

    def walk(s: dict, depth: int) -> None:
        out.append(line(s, depth))
        for kid in children.get(s["span_id"], []):
            walk(kid, depth + 1)

    root_trace = roots[0].get("trace_id", "")
    if root_trace:
        out.append(f"trace {root_trace}")
    for i, r in enumerate(roots):
        if i:
            out.append("(orphan subtree — parent span missing)")
        walk(r, 0)
    return "\n".join(out)


_CLASS = {
    "error": "ERROR",
    "start": "START",
    "success": "OK",
    "failure": "FAIL",
    "crash": "CRASH",
    "incomplete": "INCOMPLETE",
    "message": "MESSAGE",
    "metric": "METRIC",
    "other": "OTHER",
    "internal_err": "INTERNAL_ERR",
}


class PrettyPrinter:
    def __init__(self, ow: OutputWriter):
        self._ow = ow
        self._start = time.time()
        self._lock = threading.Lock()
        self._failed = 0
        self._count = 0
        self._threads: list[threading.Thread] = []

    # ------------------------------------------------------------- internal

    def _print(self, idx: int, iid: str, cls: str, msg: str = "") -> None:
        elapsed = max(0.0, time.time() - self._start)
        self._ow.infof(
            "%9.4fs %12s << %s >> %s", elapsed, _CLASS.get(cls, "OTHER"), iid, msg
        )

    def _process_stdout(self, idx: int, iid: str, stream: IO[str]) -> None:
        ok = failed = False
        try:
            for line in stream:
                parsed = parse_event_line(line)
                if parsed is None:
                    if line.strip():
                        self._print(idx, iid, "other", line.rstrip())
                    continue
                _, evt = parsed
                typ = evt.get("type")
                if typ == "success":
                    ok = True
                    self._print(idx, iid, "success")
                elif typ == "failure":
                    failed = True
                    self._print(idx, iid, "failure", evt.get("error", ""))
                elif typ == "crash":
                    failed = True
                    self._print(
                        idx,
                        iid,
                        "crash",
                        f"{evt.get('error', '')} {evt.get('stacktrace', '')}",
                    )
                elif typ == "message":
                    self._print(idx, iid, "message", evt.get("message", ""))
                elif typ == "start":
                    self._print(idx, iid, "start", str(evt.get("runenv", "")))
                elif typ == "metric":
                    self._print(idx, iid, "metric", str(evt.get("metric", "")))
                elif typ in ("stage_start", "stage_end"):
                    pass
                else:
                    self._print(idx, iid, "internal_err", f"unknown event: {evt}")
        finally:
            if not ok and not failed:
                self._print(idx, iid, "incomplete")
            with self._lock:
                if not ok or failed:
                    self._failed += 1

    def _process_stderr(self, idx: int, iid: str, stream: IO[str]) -> None:
        for line in stream:
            if line.strip():
                self._print(idx, iid, "error", line.rstrip())

    # ------------------------------------------------------------------ API

    def fail_start(self, iid: str, message: str) -> None:
        """Report an instance that failed to start (``pretty.go:92-97``)."""
        with self._lock:
            self._count += 1
            idx = self._count - 1
            self._failed += 1
        self._print(idx, iid, "incomplete", f"failed to start: {message}")

    def manage(self, iid: str, stdout: IO[str], stderr: IO[str]) -> None:
        """Consume an instance's streams in the background."""
        with self._lock:
            self._count += 1
            idx = self._count - 1
        for target, stream in (
            (self._process_stdout, stdout),
            (self._process_stderr, stderr),
        ):
            t = threading.Thread(
                target=target, args=(idx, iid, stream), daemon=True
            )
            t.start()
            self._threads.append(t)

    def wait(self, timeout: float | None = None) -> int:
        """Wait for all streams to end; returns the failed count
        (``pretty.go:75-88``)."""
        deadline = None if timeout is None else time.time() + timeout
        for t in self._threads:
            t.join(
                timeout=None if deadline is None else max(0.0, deadline - time.time())
            )
        with self._lock:
            return self._failed

    def drained(self) -> bool:
        """True when every stream reader has exited (hit EOF). Callers
        must check this before closing the underlying pipe files —
        closing a file another thread is blocked reading deadlocks in
        CPython."""
        return not any(t.is_alive() for t in self._threads)
