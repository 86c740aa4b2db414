"""``sim:plan`` builder: snapshot a plan's simulation program for the
``sim:torch`` runner — the port's copy of ``build`` and ``purge`` of the
reference's ``testground_tpu/builders/sim_plan.py``.

The runner executes plans as per-tick state machines over torch tensors,
not processes, so the "artifact" is a snapshot of the plan source dir
(``<work>/sim-plan--<plan>-<build_id>``), which the executor loads with
``load_sim_testcases`` as it loads the package's own plan directory (the
port's plans import ``testground_tpu_torch`` absolutely). Queued runs are
immune to source edits.

``_source_digest`` is the reference's digest of a plan snapshot's Python
sources, the part of a checkpoint's ``build_key`` that refuses a resume
after a plan edit (``sim/checkpoint.py``).

``warm_bucket_ladder`` is ``tg build --buckets`` (``build_buckets = true``):
the reference's ``_warm_bucket_ladder`` (``builders/sim_plan.py:583-815``)
compiles every rung of the shape-bucket ladder into XLA's cache. The port
compiles nothing, so each rung runs ``init_carry`` and one chunk on the
run's device instead — the kernels' first launches and the allocator's
first blocks at that rung's shapes — and the rung's seconds go into the
reference's ``buckets-<plan>-<case>.json`` marker, with its keys.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import threading

from ..api import BuildInput, BuildOutput
from ..rpc import OutputWriter
from .base import Builder, purge_snapshots

__all__ = ["SimPlanBuilder", "bucket_marker_path", "warm_bucket_ladder"]


def _source_digest(artifact_dir: str) -> str:
    """Digest of the snapshot's Python sources (path + contents)
    (``builders/sim_plan.py:27-40`` of the reference)."""
    h = hashlib.sha256()
    for root, dirs, files in os.walk(artifact_dir):
        dirs.sort()
        for name in sorted(files):
            if not name.endswith(".py"):
                continue
            path = os.path.join(root, name)
            h.update(os.path.relpath(path, artifact_dir).encode())
            with open(path, "rb") as f:
                h.update(f.read())
    return h.hexdigest()


class SimPlanBuilder(Builder):
    def id(self) -> str:
        return "sim:plan"

    def build(
        self, inp: BuildInput, ow: OutputWriter, cancel: threading.Event
    ) -> BuildOutput:
        src = inp.unpacked_plan_dir
        if not src or not os.path.isdir(src):
            raise ValueError(f"plan sources not found: {src!r}")
        if not (
            os.path.isfile(os.path.join(src, "sim.py"))
            or os.path.isfile(os.path.join(src, "main.py"))
        ):
            raise ValueError(
                f"plan has neither sim.py nor main.py entry point: {src}"
            )
        work = inp.env.dirs.work()
        dest = os.path.join(work, f"sim-plan--{inp.test_plan}-{inp.build_id}")
        if os.path.exists(dest):
            shutil.rmtree(dest)
        shutil.copytree(
            src,
            dest,
            ignore=shutil.ignore_patterns(
                "__pycache__", "*.pyc", ".git", "_compositions"
            ),
        )
        ow.infof("sim:plan built %s -> %s", inp.test_plan, dest)
        return BuildOutput(builder_id=self.id(), artifact_path=dest)

    def purge(self, testplan: str, ow: OutputWriter, env=None) -> None:
        removed = purge_snapshots("sim-plan", testplan, ow, env)
        ow.infof("sim:plan purge: removed %d snapshot(s)", removed)


def bucket_marker_path(env, plan: str, case: str) -> str:
    """Where the ladder warm writes its marker: the reference's file name,
    under the home's ``data/precompiled`` (the port has no compile-cache
    directory to put it in)."""
    return os.path.join(env.dirs.home, "data", "precompiled",
                        f"buckets-{plan}-{case}.json")


def warm_bucket_ladder(comp, manifest, env, ow: OutputWriter,
                       cancel: threading.Event) -> list[dict]:
    """Warm the shape-bucket ladder for the composition's first [[runs]]
    entry, when its coalesced runner config asks for it
    (``build_buckets``): each rung the composition fits in, every group
    padded to it, built as the run builds it and driven through
    ``init_carry`` and one chunk on the run's device. The reference's
    skips apply: a cohort config, a rung below the composition's counts, a
    rung that does not divide across the mesh's peer shards, and a rung
    the memory precheck refuses (each rung is best-effort). With ``pack``
    each rung also warms the power-of-two pack widths up to ``pack_max``
    (``_warm_pack_widths``), on a mesh as the meshed pack runs: its
    unmeshed inner program under ``PackRunner(..., mesh=)``, each pack row
    keyed with the mesh layout (the reference's idiom for its BuildKey,
    ``"mesh"`` only when meshed). Returns the marker's ``buckets`` rows."""
    import json
    import time

    from ..api import RunGroup, prepare_for_run
    from ..config import CoalescedConfig
    from ..sim.buckets import parse_ladder
    from ..sim.engine import device_context, resolve_device
    from ..sim.executor import (
        SimTorchConfig,
        _make_mesh,
        _parse_hosts,
        _precheck_device_memory,
        load_and_specialize,
        make_sim_program,
    )
    from ..sim.meshplan import peer_shards

    if not comp.global_.case:
        return []
    comp = prepare_for_run(comp, manifest)
    cfg = (CoalescedConfig().append(env.runners.get("sim:torch") if env else None)
           .append(comp.global_.run_config).coalesce_into(SimTorchConfig))
    if not getattr(cfg, "build_buckets", False) or cancel.is_set():
        return []
    if getattr(cfg, "coordinator_address", ""):
        ow.warn("bucket-ladder warming skipped under a cohort config")
        return []
    device = resolve_device(getattr(cfg, "device", None))
    mesh = _make_mesh(bool(getattr(cfg, "shard", True)), getattr(cfg, "mesh", ""),
                      device)
    shards = peer_shards(mesh)
    hosts = _parse_hosts(getattr(cfg, "additional_hosts", None))
    telemetry = bool(getattr(cfg, "telemetry", False)) and not comp.global_.disable_metrics
    ladder = parse_ladder(getattr(cfg, "bucket_ladder", "") or None)
    pack_on = str(getattr(cfg, "pack", False)).strip().lower() in ("1", "true", "yes", "on")
    run = comp.runs[0]
    first = comp.get_group(run.groups[0].effective_group_id())
    counts = [rg.calculated_instance_count for rg in run.groups]
    warmed = []
    for rung in ladder:
        if cancel.is_set():
            return warmed
        if any(c > rung for c in counts):
            continue  # this rung cannot hold the composition
        if shards > 1 and rung % shards != 0:
            ow.warn(
                "bucket %d skipped: it does not divide across %d "
                "peer shard(s) — pick ladder rungs that are "
                "multiples of the shard count to warm them meshed",
                rung, shards,
            )
            continue
        t0 = time.perf_counter()
        try:
            testcase, groups = load_and_specialize(
                first.run.artifact, comp.global_.case,
                [RunGroup(id=rg.id, instances=rung, parameters=dict(rg.test_params))
                 for rg in run.groups],
                cfg.tick_ms,
            )
            prog = make_sim_program(
                testcase, groups, test_plan=comp.global_.plan,
                test_case=comp.global_.case, test_run="build", tick_ms=cfg.tick_ms,
                chunk=cfg.chunk, hosts=hosts,
                validate=bool(getattr(cfg, "validate", False)), telemetry=telemetry,
                faults=None, trace=None,
                netmatrix=telemetry and bool(getattr(cfg, "netmatrix", False)),
                device=device, mesh=mesh, live_counts=tuple(counts),
            )
            with device_context(prog.device):
                carry = prog.init_carry(cfg.seed)
                # the run's capacity precheck on the rung's carry (a carry
                # the card cannot hold fails its allocation: skipped too)
                _precheck_device_memory(prog, prog.footprint(carry), cfg, ow, device)
                prog.run(seed=cfg.seed, max_ticks=prog.chunk, resume_carry=carry)
                if prog.device.type == "cuda":
                    import torch

                    torch.cuda.synchronize(prog.device)
            del carry
        except Exception as e:  # noqa: BLE001 — per-rung best-effort
            ow.warn("bucket %d warmup failed (skipped): %s", rung, e)
            continue
        secs = round(time.perf_counter() - t0, 3)
        warmed.append({"bucket": rung, "compile_secs": secs})
        ow.infof("sim:plan bucket %d warmed in %.1fs (%s:%s)", rung, secs,
                 comp.global_.plan, comp.global_.case)
        if pack_on:
            pack_prog = prog
            if mesh is not None:
                # the inner program of a meshed pack is unmeshed
                pack_prog = make_sim_program(
                    testcase, groups, test_plan=comp.global_.plan,
                    test_case=comp.global_.case, test_run="build", tick_ms=cfg.tick_ms,
                    chunk=cfg.chunk, hosts=hosts,
                    validate=bool(getattr(cfg, "validate", False)), telemetry=telemetry,
                    faults=None, trace=None,
                    netmatrix=telemetry and bool(getattr(cfg, "netmatrix", False)),
                    device=mesh.primary, mesh=None, live_counts=tuple(counts),
                    lane_multiple=mesh.shards,
                )
            _warm_pack_widths(pack_prog, cfg, counts, rung, ladder, warmed, ow, mesh)
    if warmed:
        marker = bucket_marker_path(env, comp.global_.plan, comp.global_.case)
        os.makedirs(os.path.dirname(marker), exist_ok=True)
        with open(marker, "w") as f:
            json.dump({"plan": comp.global_.plan, "case": comp.global_.case,
                       "ladder": list(ladder), "buckets": warmed}, f)
    return warmed


def _warm_pack_widths(prog, cfg, counts, rung, ladder, warmed, ow, mesh=None) -> None:
    """Warm the pack-width ladder of one rung (``sim_plan.py:737-790``):
    each power-of-two width up to ``pack_max`` runs ``init`` and one chunk
    of the packed program on the run's device, bounded to packs whose lanes
    stay inside a full pack of the smallest rung (the serving envelope
    packs are for). Each width is best-effort, and each warmed width is a
    marker row with the reference's keys, and ``mesh`` (the layout) when
    the pack is meshed."""
    import time

    from ..sim.engine import device_context
    from ..sim.meshplan import layout_str
    from ..sim.pack import PackMember, PackRunner, pack_width

    pack_max = int(getattr(cfg, "pack_max", 8) or 8)
    lane_budget = pack_max * ladder[0]
    w = 2
    while w <= pack_width(pack_max, pack_max):
        if w * rung > lane_budget:
            break  # packed lanes past the serving envelope
        t1 = time.perf_counter()
        try:
            with device_context(prog.device):
                PackRunner(prog, w, mesh=mesh).run([
                    PackMember(seed=int(cfg.seed), live_counts=tuple(counts),
                               max_ticks=prog.chunk)
                    for _ in range(w)
                ])
                if prog.device.type == "cuda":
                    import torch

                    torch.cuda.synchronize(prog.device)
        except Exception as e:  # noqa: BLE001 — per-width best-effort
            ow.warn("bucket %d pack width %d warmup failed (skipped): %s",
                    rung, w, e)
            w *= 2
            continue
        psecs = round(time.perf_counter() - t1, 3)
        warmed.append({"bucket": rung, "pack_width": w, "compile_secs": psecs,
                       **({"mesh": layout_str(mesh)} if mesh is not None else {})})
        ow.infof("sim:plan bucket %d pack-width %d warmed in %.1fs", rung, w, psecs)
        w *= 2
