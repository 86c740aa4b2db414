"""``sim:plan`` builder: snapshot a plan's simulation program for the
``sim:torch`` runner, and precompile it — the port's copy of the
reference's ``testground_tpu/builders/sim_plan.py``.

The runner executes plans as per-tick state machines over torch tensors,
not processes, so the "artifact" is a snapshot of the plan source dir
(``<work>/sim-plan--<plan>-<build_id>``), which the executor loads with
``load_sim_testcases`` as it loads the package's own plan directory (the
port's plans import ``testground_tpu_torch`` absolutely). Queued runs are
immune to source edits.

``_source_digest`` is the reference's digest of a plan snapshot's Python
sources: the part of a precompile's BuildKey, and of a checkpoint's
``build_key`` (``sim/checkpoint.py``), that changes with a plan edit.

``SimPlanBuilder.precompile`` is the build task's precompile pass
(``builders/sim_plan.py:80-581`` of the reference): the static check pass,
then for each distinct ``[[runs]]`` shape a BuildKey marker under
``<compile cache>/precompiled/``. The reference compiles each program into
XLA's cache; the port's one compiled artifact is the kernel library, so a
miss builds it (on the card), then builds the run's program as the executor
does, runs ``init_carry``, the memory precheck and one tick on the run's
device. ``warm_bucket_ladder`` is ``tg build --buckets`` (``build_buckets
= true``, the reference's ``_warm_bucket_ladder``, ``:583-815``): each rung
runs ``init_carry`` and one chunk on the run's device, and the rungs'
seconds go into the reference's ``buckets-<plan>-<case>.json`` marker.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time

from ..api import BuildInput, BuildOutput
from ..rpc import OutputWriter
from .base import Builder, Precompiler, purge_snapshots

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


class SimPlanBuilder(Builder, Precompiler):
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

    # ------------------------------------------------------- build = warm

    def precompile(self, comp, manifest, env, ow, cancel) -> None:
        """Warm the composition's programs on the run's device and mark
        each with its BuildKey, in the reference's sequence and words: the
        two skips (cache disabled, no test case), the warn-only check pass,
        ``prepare_for_run`` before the config coalesces (it fills the
        manifest's runner-config defaults, and the written composition's
        ``total_instances``), then per distinct run shape a cache hit or a
        warm: the kernel library built on the card, the run's program
        (``make_sim_program``, as the executor builds it), ``init_carry``,
        the memory precheck and one tick. The marker holds the key's spec,
        ``compile_secs`` and a ``perf`` block (``kernel_build_secs``,
        ``warm_secs``, ``carry_bytes``, ``peak_bytes``: the card's peak, None
        on the CPU). The device is ``resolve_device(cfg.device)``: without a
        card and without ``device = "cpu"`` this raises, and the build
        warns. ``build_buckets`` then warms the bucket ladder."""
        from ..api import RunGroup, prepare_for_run
        from ..config import CoalescedConfig
        from ..utils.compile_cache import compile_cache_dir

        cache_dir = compile_cache_dir(env.dirs.home if env else None)
        if cache_dir is None:
            ow.infof("sim:plan precompile skipped: compile cache disabled")
            return
        if not comp.global_.case:
            # case-less `tg build single <plan>`: no composition to resolve
            # a program from — a snapshot-only build
            ow.infof(
                "sim:plan precompile skipped: no test case on this build"
            )
            return
        # the static check pass (sim/check.py): the rules `tg check` and
        # the daemon's admission evaluate, so a refusal the run would hit
        # shows in the build log. Warn-only: the snapshot stands
        try:
            from ..sim.check import check_composition

            for f in check_composition(
                comp,
                manifest,
                env_layer=env.runners.get("sim:torch") if env else None,
            ):
                ow.warn(
                    "check: [%s] %s: %s", f.severity, f.rule, f.message
                )
        except Exception as e:  # noqa: BLE001 — advisory pass only
            ow.warn("sim:plan static check pass failed: %s", e)
        import torch

        from ..sim import cuda_transport as ct
        from ..sim.engine import build_groups, resolve_device
        from ..sim.executor import (
            SimTorchConfig,
            _make_mesh,
            _parse_hosts,
            check_mesh_lanes,
            fault_specs_of,
            load_and_specialize,
            make_sim_program,
            resolve_buckets,
            slo_specs_of,
            trace_specs_of,
            transport_knob,
        )
        from ..sim.faults import build_fault_schedule, remap_schedule
        from ..sim.meshplan import layout_str
        from ..sim.trace import build_trace_plan

        artifacts = {g.id: g.run.artifact for g in comp.groups}
        # prepare BEFORE coalescing the runner config, as do_run does: a
        # manifest default fills run_config here, and a different order
        # would warm (and key) another program than the run steps
        comp = prepare_for_run(comp, manifest)
        cfg = (
            CoalescedConfig()
            .append(env.runners.get("sim:torch") if env else None)
            .append(comp.global_.run_config)
            .coalesce_into(SimTorchConfig)
        )
        device = resolve_device(getattr(cfg, "device", None))
        cuda = device.type == "cuda"
        hosts = _parse_hosts(getattr(cfg, "additional_hosts", None))
        # the executor's gates: disable_metrics and a cohort turn the
        # telemetry plane off, and the matrix rides it; a cohort builds no
        # mesh here (its mesh is the global one) and keys transport xla,
        # as the reference's build does
        cohort = bool(getattr(cfg, "coordinator_address", ""))
        telemetry = (
            bool(getattr(cfg, "telemetry", False))
            and not comp.global_.disable_metrics
            and not cohort
        )
        netmatrix = telemetry and bool(getattr(cfg, "netmatrix", False))
        mesh = None if cohort else _make_mesh(
            bool(getattr(cfg, "shard", True)), getattr(cfg, "mesh", ""), device
        )
        transport = "xla" if cohort else transport_knob(cfg)
        digests = {
            path: _source_digest(path) for path in set(artifacts.values())
        }
        # what the key holds in place of the reference's backend, device
        # count and jax version: the run's device, the torch build and, on
        # the card, the kernel library's digest
        device_key = {
            "device": device.type,
            **({"device_name": torch.cuda.get_device_name(device)}
               if cuda else {}),
            "devices": torch.cuda.device_count() if cuda else 1,
            "torch": torch.__version__,
            **({"kernels": ct.kernel_digest()} if cuda else {}),
        }
        global_run = comp.global_.run
        seen: set[str] = set()
        for run in comp.runs:
            run_fault_specs = fault_specs_of(
                run.groups, global_run.faults if global_run is not None else None
            )
            run_trace_specs = (
                trace_specs_of(
                    run.groups,
                    global_run.trace if global_run is not None else None,
                )
                if not comp.global_.disable_metrics and not cohort
                else {}
            )
            # SLO rules shape no program, but the run declares them; the
            # same gate as the telemetry plane they ride
            run_slo_specs = (
                slo_specs_of(
                    run.groups,
                    global_run.slo if global_run is not None else None,
                )
                if telemetry
                else {}
            )
            bucket_plan = resolve_buckets(
                cfg,
                [rg.calculated_instance_count for rg in run.groups],
                mesh=mesh,
                warn=ow.warn,
            )
            first = comp.get_group(run.groups[0].effective_group_id())
            run_groups_in = [
                RunGroup(
                    id=rg.id,
                    instances=rg.calculated_instance_count,
                    parameters=dict(rg.test_params),
                )
                for rg in run.groups
            ]
            padded_in = run_groups_in
            if bucket_plan is not None:
                padded_in = [
                    RunGroup(id=rg.id, instances=p, parameters=dict(rg.parameters))
                    for rg, p in zip(run_groups_in, bucket_plan.padded_counts)
                ]
            spec = {
                "sources": digests[artifacts[first.id]],
                "plan": comp.global_.plan,
                "case": comp.global_.case,
                "groups": [
                    {
                        "id": rg.id,
                        "instances": rg.calculated_instance_count,
                        "parameters": dict(rg.test_params),
                    }
                    for rg in run.groups
                ],
                "tick_ms": cfg.tick_ms,
                "chunk": cfg.chunk,
                "seed": cfg.seed,
                "shard": cfg.shard,
                "validate": bool(getattr(cfg, "validate", False)),
                "telemetry": telemetry,
                "transport": transport,
                "faults": run_fault_specs,
                "trace": run_trace_specs,
                "slo": run_slo_specs,
                "hosts": list(hosts),
                **device_key,
                # keyed only when bucketed, meshed or with the matrix on,
                # the reference's idiom
                **(
                    {"bucket": list(bucket_plan.padded_counts)}
                    if bucket_plan is not None
                    else {}
                ),
                **({"netmatrix": True} if netmatrix else {}),
                **({"mesh": layout_str(mesh)} if mesh is not None else {}),
            }
            key = hashlib.sha256(
                json.dumps(spec, sort_keys=True).encode()
            ).hexdigest()[:32]
            if key in seen:
                continue
            seen.add(key)
            marker = os.path.join(cache_dir, "precompiled", f"{key}.json")
            if os.path.exists(marker):
                ow.infof(
                    "sim:plan precompile: cache hit for run %s (key %s)",
                    run.id,
                    key,
                )
                continue
            if cancel.is_set():
                return
            t0 = time.perf_counter()
            testcase, groups = load_and_specialize(
                artifacts[first.id], comp.global_.case, padded_in, cfg.tick_ms
            )
            if (
                bucket_plan is not None
                and "filter_rules" in type(testcase).SHAPING
                and len(groups) > 1
            ):
                # the executor's fallback: this combination runs exact
                # shapes, so warm the exact program
                bucket_plan = None
                spec.pop("bucket", None)
                testcase, groups = load_and_specialize(
                    artifacts[first.id], comp.global_.case, run_groups_in,
                    cfg.tick_ms,
                )
            vgroups = (
                build_groups(run_groups_in) if bucket_plan is not None else groups
            )
            fault_schedule = build_fault_schedule(
                vgroups, run_fault_specs, cfg.tick_ms
            )
            if fault_schedule is not None and bucket_plan is not None:
                fault_schedule = remap_schedule(
                    fault_schedule, bucket_plan.index_map(), bucket_plan.padded_n
                )
            check_mesh_lanes(transport, sum(g.count for g in groups), len(hosts),
                             1 if mesh is None else mesh.shards)
            prog = make_sim_program(
                testcase,
                groups,
                test_plan=comp.global_.plan,
                test_case=comp.global_.case,
                test_run="build",
                tick_ms=cfg.tick_ms,
                chunk=cfg.chunk,
                hosts=hosts,
                validate=bool(getattr(cfg, "validate", False)),
                telemetry=telemetry,
                faults=fault_schedule,
                trace=(
                    build_trace_plan(vgroups, run_trace_specs)
                    if bucket_plan is None
                    else None
                ),
                netmatrix=netmatrix,
                device=device,
                mesh=mesh,
                live_counts=(
                    bucket_plan.live_counts if bucket_plan is not None else None
                ),
            )
            perf, launched = _warm_one_tick(prog, cfg, device, ow)
            secs = time.perf_counter() - t0
            os.makedirs(os.path.dirname(marker), exist_ok=True)
            with open(marker, "w") as f:
                json.dump(
                    {**spec, "compile_secs": round(secs, 3), "perf": perf}, f
                )
            ow.infof(
                "sim:plan precompile: the warm tick of run %s on %s launched %s",
                run.id,
                device,
                json.dumps(launched, sort_keys=True) if launched
                else "no kernel (the plain versions run off the card)",
            )
            ow.infof(
                "sim:plan precompiled run %s into %s in %.1fs (key %s)",
                run.id,
                cache_dir,
                secs,
                key,
            )

        # `tg build --buckets` (build_buckets): beyond the composition's
        # own rung, warm every rung of the ladder for this (plan, case,
        # params), each rung's seconds in the ladder's marker
        if getattr(cfg, "build_buckets", False) and not cancel.is_set():
            warm_bucket_ladder(comp, cfg, device, hosts, telemetry, cache_dir,
                               ow, cancel)


def _warm_one_tick(prog, cfg, device, ow) -> tuple[dict, dict]:
    """Build the kernel library (on the card), then ``init_carry``, the
    run's memory precheck and one tick of ``prog`` on its device, as the
    run's loop steps it (a several-part program stepped in one thread,
    ``SimProgram.single``). Returns the marker's ``perf`` block and the
    tick's kernel calls by wrapper (``observe_launches``; none on the
    CPU). The nvcc build this process made is claimed here, so the run
    that follows journals ``compile_cache: "hit"``."""
    import torch

    from ..sim import cuda_transport as ct
    from ..sim.engine import device_context
    from ..sim.executor import _precheck_device_memory
    from ..sim.phases import _run_ticks, _tick_state

    cuda = device.type == "cuda"
    nvcc_secs = ct.kernel_builds()[1]
    if cuda:
        ct.build_kernels()
    kernel_build_secs = ct.kernel_builds()[1] - nvcc_secs
    launched: dict[str, int] = {}

    def on_launch(name, _measure) -> None:
        launched[name] = launched.get(name, 0) + 1

    t0 = time.perf_counter()
    with device_context(prog.device):
        if cuda:
            torch.cuda.reset_peak_memory_stats(prog.device)
        carry = prog.init_carry(cfg.seed)
        carry_bytes = prog.footprint(carry)
        _precheck_device_memory(prog, carry_bytes, cfg, ow, device)
        stepper = prog.single()
        if stepper is not prog:
            del carry
            carry = stepper.init_carry(cfg.seed)
        state = _tick_state(stepper, cfg.seed, carry)
        with ct.observe_launches(on_launch):
            _run_ticks(stepper, *state, 1, None)
        del carry, state
        peak = None
        if cuda:
            torch.cuda.synchronize(prog.device)
            peak = int(torch.cuda.max_memory_allocated(prog.device))
    warm_secs = time.perf_counter() - t0
    ct.claim_kernel_builds()
    return {
        "kernel_build_secs": round(kernel_build_secs, 3),
        "warm_secs": round(warm_secs, 6),
        "carry_bytes": int(carry_bytes),
        "peak_bytes": peak,
    }, launched


def bucket_marker_path(cache_dir: str, plan: str, case: str) -> str:
    """Where the ladder warm writes its marker: the reference's file under
    the compile cache's ``precompiled/`` (``sim_plan.py:798-813``)."""
    return os.path.join(cache_dir, "precompiled", f"buckets-{plan}-{case}.json")


def warm_bucket_ladder(comp, cfg, device, hosts, telemetry, cache_dir,
                       ow: OutputWriter, cancel: threading.Event) -> list[dict]:
    """Warm the shape-bucket ladder for the composition's first [[runs]]
    entry (``comp`` prepared, ``cfg`` its coalesced runner config, as the
    precompile pass hands them over): each rung the composition fits in,
    every group padded to it, built as the run builds it and driven through
    ``init_carry`` and one chunk on the run's device. The reference's
    skips apply: a cohort config, a rung below the composition's counts, a
    rung that does not divide across the mesh's peer shards, and a rung
    the memory precheck refuses (each rung is best-effort). With ``pack``
    each rung also warms the power-of-two pack widths up to ``pack_max``
    (``_warm_pack_widths``), on a mesh as the meshed pack runs: its
    unmeshed inner program under ``PackRunner(..., mesh=)``, each pack row
    keyed with the mesh layout (the reference's idiom for its BuildKey,
    ``"mesh"`` only when meshed). Returns the marker's ``buckets`` rows."""
    from ..api import RunGroup
    from ..sim.buckets import parse_ladder
    from ..sim.engine import device_context
    from ..sim.executor import (
        _make_mesh,
        _precheck_device_memory,
        load_and_specialize,
        make_sim_program,
    )
    from ..sim.meshplan import peer_shards

    if getattr(cfg, "coordinator_address", ""):
        ow.warn("bucket-ladder warming skipped under a cohort config")
        return []
    mesh = _make_mesh(bool(getattr(cfg, "shard", True)), getattr(cfg, "mesh", ""),
                      device)
    shards = peer_shards(mesh)
    ladder = parse_ladder(getattr(cfg, "bucket_ladder", "") or None)
    pack_on = str(getattr(cfg, "pack", False)).strip().lower() in ("1", "true", "yes", "on")
    run = comp.runs[0]
    first = comp.get_group(run.groups[0].effective_group_id())
    counts = [rg.calculated_instance_count for rg in run.groups]
    netmatrix = telemetry and bool(getattr(cfg, "netmatrix", False))
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
                faults=None, trace=None, netmatrix=netmatrix,
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
                    faults=None, trace=None, netmatrix=netmatrix,
                    device=mesh.primary, mesh=None, live_counts=tuple(counts),
                    lane_multiple=mesh.shards,
                )
            _warm_pack_widths(pack_prog, cfg, counts, rung, ladder, warmed, ow, mesh)
    if warmed:
        marker = bucket_marker_path(cache_dir, comp.global_.plan, comp.global_.case)
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
