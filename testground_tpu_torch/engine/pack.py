"""Pack admission: group queued compatible sim runs into one device
program — the port's copy of ``testground_tpu/engine/pack.py`` (the device
half is ``sim/pack.py``).

A worker that pops a pack-opted task (``--run-cfg pack=true``) asks the
queue for other QUEUED tasks with the same **pack signature** — the
host-side compatibility key over everything that shapes the program or
the deterministic loop:

- plan, case, group structure + parameters;
- the padded bucket layout when shape bucketing is on (members may then
  differ in EXACT instance count within a bucket — seeds and live
  counts are runtime inputs), or the exact counts when it is off;
- the program gates: transport, telemetry, validate, chunk, tick_ms,
  max_ticks, disable_metrics, and the run's ``device`` (members on
  different devices never share a program);
- and the structural exclusions: no faults, no flight recorder, no
  additional hosts, no cohort, no checkpoint/resume, no profiles —
  compositions carrying those run solo, with the reference's reasons
  word for word.

Claiming respects queue priority: candidates are taken in heap order
(priority desc, FIFO), so a high-priority tenant is packed first, never
skipped.

Import-light on purpose (stdlib and the port's ``sim/buckets.py``): the
worker thread decides admission without touching torch.
"""

from __future__ import annotations

import hashlib
import json

from ..logging_ import S

__all__ = [
    "claim_pack",
    "pack_signature",
    "pack_solo_reason",
    "solo_reason_for_composition",
]


def _cfg_get(run_config: dict, key: str, default=None):
    v = (run_config or {}).get(key, default)
    return default if v is None else v


def _truthy(v) -> bool:
    if isinstance(v, str):
        return v.strip().lower() in ("1", "true", "yes", "on")
    return bool(v)


# tenant-facing (journal sim.pack.solo_reason + the checker's pack.solo
# finding); the global-run and per-group chaos/trace exclusions share
# one wording
_CHAOS_TRACE_SOLO = (
    "a declared chaos schedule or flight-recorder table bakes "
    "per-program tensors a shared vmapped program cannot carry"
)


def pack_signature(tsk, env=None) -> str | None:
    """The compatibility key of a queued task, or None when the task
    must run solo. Works on the raw task record (composition dict +
    coalesced-ish run config) — no plan loading, no torch.

    The runner-level ``.env.toml`` layer is coalesced in by the caller
    passing ``env`` so two tasks differing only in where a knob was
    set (composition vs daemon config) still pack together.
    """
    from .task import TaskType

    if tsk.type != TaskType.RUN or tsk.runner != "sim:torch":
        return None
    sig, _ = _signature_or_reason(
        tsk.composition or {}, env, tsk.input or {}
    )
    return sig


def pack_solo_reason(tsk, env=None) -> str | None:
    """Why a pack-OPTED task runs solo, or None (pack not requested, or
    the task is packable — a packable task that still ran solo simply
    found no queued partner at claim time; the caller words that case).
    The journal's ``sim.pack.solo_reason`` and the checker's
    ``pack.solo`` finding both read this classification."""
    from .task import TaskType

    if tsk.type != TaskType.RUN or tsk.runner != "sim:torch":
        return None
    return solo_reason_for_composition(
        tsk.composition or {}, env, tsk.input or {}
    )


def solo_reason_for_composition(
    comp: dict, env=None, input_rec: dict | None = None
) -> str | None:
    """Composition-dict variant of :func:`pack_solo_reason` (the static
    checker has a composition, not a task). Returns the human-readable
    solo cause when ``pack=true`` was requested but admission would
    refuse a signature; None when pack was not requested or the
    composition is packable."""
    sig, reason = _signature_or_reason(comp or {}, env, input_rec or {})
    if sig is not None:
        return None
    return reason


def _signature_or_reason(
    comp: dict, env, input_rec: dict
) -> tuple[str | None, str | None]:
    """The ONE admission walk: returns ``(signature, None)`` for a
    packable composition, ``(None, reason)`` when pack was requested
    but the composition must run solo, and ``(None, None)`` when pack
    was not requested at all."""
    runs = comp.get("runs") or []
    glob = comp.get("global") or {}
    grun = glob.get("run") or {}
    cfgs = [dict(env or {}), dict(glob.get("run_config") or {})]
    cfg: dict = {}
    for layer in cfgs:
        cfg.update(layer)
    requested = _truthy(cfg.get("pack"))

    def solo(reason: str):
        return None, (reason if requested else None)

    if len(runs) != 1:
        # multi-[[runs]] compositions keep their own loop
        return solo(
            f"multi-[[runs]] composition ({len(runs)} runs — each "
            "[[runs]] entry keeps its own run loop)"
        )
    run = runs[0]
    # structural exclusions: program-shaping declarations that cannot
    # share a vmapped program (or whose host planes are per-run device
    # reads the pack cannot demux). Queued compositions are
    # PRE-preparation, so backing-group [groups.run] tables — which
    # merge_group only folds into the run groups at prepare time — must
    # be checked here too, or a group-level chaos/trace declaration
    # would slip past admission and silently never be injected.
    if grun.get("faults") or grun.get("trace"):
        return solo(_CHAOS_TRACE_SOLO)
    groups_decl = {g.get("id"): g for g in comp.get("groups") or []}
    backing_runs = {}
    for rg in run.get("groups") or []:
        decl = groups_decl.get(rg.get("group_id") or rg.get("id")) or {}
        brun = decl.get("run") or {}
        if (
            rg.get("faults")
            or rg.get("trace")
            or brun.get("faults")
            or brun.get("trace")
        ):
            return solo(_CHAOS_TRACE_SOLO)
        backing_runs[rg.get("id")] = brun
    if not requested:
        return None, None
    if cfg.get("coordinator_address"):
        return solo("a multi-host cohort config cannot join a pack")
    if cfg.get("resume_from"):
        return solo("resume_from seeds this run's own carry snapshot")
    if _truthy(cfg.get("profile")):
        return solo("profiler capture is a per-run device session")
    if _truthy(cfg.get("phases")):
        return solo("phase attribution lowers per-run programs")
    if _truthy(cfg.get("netmatrix")):
        return solo("the traffic matrix is a per-run device carry read")
    if cfg.get("additional_hosts"):
        return solo("additional_hosts adds per-program echo lanes")
    if int(cfg.get("checkpoint_chunks") or 0) > 0:
        return solo("checkpointing reads this run's own carry per chunk")

    # instance counts: the padded bucket layout when bucketing is on
    # (the shared-program identity), exact counts otherwise. Queued
    # compositions are pre-preparation, so resolve the explicit count
    # (run group, else backing group); percentage-based groups resolve
    # only at prepare time — those run solo.
    counts = []
    for rg in run.get("groups") or []:
        inst = rg.get("instances") or {}
        c = inst.get("count") if isinstance(inst, dict) else inst
        if not c:
            decl = groups_decl.get(
                rg.get("group_id") or rg.get("id"), {}
            )
            dinst = decl.get("instances") or {}
            c = (
                dinst.get("count")
                if isinstance(dinst, dict)
                else dinst
            )
        if not c:
            return solo(
                "percentage-based group instances resolve only at "
                "prepare time"
            )
        counts.append(int(c))
    from ..sim.buckets import (
        bucketed_counts,
        parse_bucket_mode,
        parse_ladder,
    )

    try:
        mode = parse_bucket_mode(cfg.get("bucket"))
        ladder = parse_ladder(cfg.get("bucket_ladder") or None)
    except ValueError:
        # a bad knob fails in the executor, readably
        return solo("invalid bucket/bucket_ladder knob")
    padded = (
        bucketed_counts(counts, mode, ladder)
        if mode != "off"
        else None
    )
    sig = {
        "plan": glob.get("plan"),
        "case": glob.get("case"),
        # plan identity: two tasks queued around a plan edit (different
        # manifest or sources snapshot) must not share a program
        "manifest": hashlib.sha256(
            json.dumps(
                (input_rec or {}).get("manifest") or {}, sort_keys=True
            ).encode()
        ).hexdigest()[:16],
        "sources_dir": (input_rec or {}).get("sources_dir") or "",
        "groups": [
            {
                "id": rg.get("id"),
                # the EFFECTIVE parameter view: prepare_for_run fills
                # missing run-group params from the backing group's
                # [groups.run] and the global [global.run] tables, so
                # all three layers key the signature — two tasks whose
                # merged params differ must never share a program
                "params": dict(rg.get("test_params") or {}),
                "backing_params": dict(
                    (backing_runs.get(rg.get("id")) or {}).get(
                        "test_params"
                    )
                    or {}
                ),
            }
            for rg in run.get("groups") or []
        ],
        "global_params": dict(grun.get("test_params") or {}),
        "counts": list(padded) if padded is not None else counts,
        "bucketed": padded is not None,
        "disable_metrics": bool(glob.get("disable_metrics")),
        # program gates — defaults mirror SimJaxConfig
        "tick_ms": float(cfg.get("tick_ms") or 1.0),
        "chunk": int(cfg.get("chunk") or 128),
        "max_ticks": int(cfg.get("max_ticks") or 100_000),
        "transport": str(cfg.get("transport") or "xla").lower(),
        "telemetry": _truthy(cfg.get("telemetry")),
        "validate": _truthy(cfg.get("validate")),
        "pack_max": int(cfg.get("pack_max") or 8),
        # the mesh layout shapes the packed program (the pack's calendar
        # splits over it — sim/pack.py), so meshed and unmeshed members
        # never share a pack
        "mesh": str(cfg.get("mesh") or ""),
        # the run's device: members on different cards (or the CPU) never
        # share a program
        "device": str(cfg.get("device") or ""),
    }
    return (
        hashlib.sha256(
            json.dumps(sig, sort_keys=True).encode()
        ).hexdigest()[:32],
        None,
    )


def claim_pack(engine, tsk) -> list:
    """Given a just-popped task, claim every queued compatible task (in
    priority order) up to ``pack_max`` and return the pack — ``[tsk]``
    alone when packing does not apply. Claimed tasks are marked
    processing exactly like a pop; the caller owns their lifecycle."""
    env_layer = engine.env.runners.get("sim:torch") or {}
    try:
        sig = pack_signature(tsk, env_layer)
    except Exception as e:  # noqa: BLE001 — admission must never wedge
        S().warning("pack admission failed for %s: %s", tsk.id, e)
        return [tsk]
    if sig is None:
        return [tsk]
    cfg = dict(env_layer)
    cfg.update((tsk.composition.get("global") or {}).get("run_config") or {})
    pack_max = max(2, int(cfg.get("pack_max") or 8))

    def match(other) -> bool:
        try:
            return pack_signature(other, env_layer) == sig
        except Exception:  # noqa: BLE001
            return False

    extras = engine.queue.claim_matching(match, pack_max - 1)
    if extras:
        S().info(
            "packed %d queued run(s) onto task %s (signature %s)",
            len(extras),
            tsk.id,
            sig[:8],
        )
    return [tsk] + extras
