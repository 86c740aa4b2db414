"""Composition preparation pipeline.

Applies manifest/global defaults, synthesizes the default run, resolves
instance counts, and bounds-checks against the test case's constraints.
Behavioral twin of the reference's ``pkg/api/composition_preparation.go``.
All functions return prepared *clones*; inputs are never mutated.

The port's own copy of the reference's ``testground_tpu/api/preparation.py``
(ROADMAP's copy policy); ``tests/test_torch_composition.py`` pins it against
the original.
"""

from __future__ import annotations

from .composition import (
    Composition,
    CompositionRunGroup,
    Run,
    apply_dependency_defaults,
)
from .manifest import TestPlanManifest
from .template import compile_composition_template

__all__ = [
    "generate_default_run",
    "load_composition",
    "prepare_for_build",
    "prepare_for_run",
]


def load_composition(path) -> Composition:
    """Render a composition file through the template engine, parse it, and
    synthesize the default run when no ``[[runs]]`` are declared — the entry
    point CLI/load paths use, mirroring ``pkg/cmd/template.go:88-107``
    (template → parse → GenerateDefaultRun). Validation requires runs to
    exist, so loading and validating compose cleanly."""
    text = compile_composition_template(path)
    return generate_default_run(Composition.from_toml(text))


def prepare_for_build(
    c: Composition, manifest: TestPlanManifest
) -> Composition:
    """Verify builder compatibility and trickle down build configuration
    (``composition_preparation.go:63-89`` + per-group ``:16-56``).

    Precedence for each group's build_config key: group > global > manifest
    builder defaults. The global ``[global.build]`` selectors/dependencies
    fill in where the group sets none.
    """
    c = c.clone()
    # The server doesn't care about client-local plan paths; the manifest name
    # is canonical (composition_preparation.go:64-68).
    c.global_.plan = manifest.name

    if not manifest.builders:
        raise ValueError("plan supports no builders; review the manifest")

    for g in c.groups:
        if not g.builder:
            g.builder = c.global_.builder
        if not manifest.has_builder(g.builder):
            raise ValueError(
                f"plan does not support builder '{g.builder}'; "
                f"supported: {manifest.supported_builders()}"
            )
        for k, v in c.global_.build_config.items():
            g.build_config.setdefault(k, v)
        for k, v in manifest.builders.get(g.builder, {}).items():
            g.build_config.setdefault(k, v)
        if c.global_.build is not None:
            g.build.dependencies = apply_dependency_defaults(
                g.build.dependencies, c.global_.build.dependencies
            )
            if not g.build.selectors:
                g.build.selectors = list(c.global_.build.selectors)
    return c


def generate_default_run(c: Composition) -> Composition:
    """Synthesize a single ``default`` run covering all groups when the
    composition declares no ``[[runs]]``
    (``composition_preparation.go:93-110``)."""
    c = c.clone()
    if not c.runs:
        run = Run(
            id="default",
            total_instances=c.global_.total_instances,
            groups=[g.default_run_group() for g in c.groups],
        )
        c.runs = [run]
    return c


def _prepare_run_group(
    g: CompositionRunGroup,
    run: Run,
    c: Composition,
    manifest: TestPlanManifest,
) -> None:
    """Merge order for a run group's test params (missing-key fill at each
    step, so earlier sources win): run group > run > backing group > global
    run defaults > testcase defaults
    (``composition_preparation.go:232-281``)."""
    for k, v in run.test_params.items():
        g.test_params.setdefault(k, v)
    g.merge_group(c.get_group(g.effective_group_id()))
    if c.global_.run is not None:
        g.merge_run(c.global_.run)
        for k, v in c.global_.run.test_params.items():
            g.test_params.setdefault(k, v)
    for k, v in manifest.default_parameters(c.global_.case).items():
        g.test_params.setdefault(k, v)


def prepare_for_run(c: Composition, manifest: TestPlanManifest) -> Composition:
    """Full run preparation (``composition_preparation.go:118-169``):
    default-run synthesis, test-case existence, runner support, manifest
    runner config fill-in, per-run group merges, instance count resolution and
    bounds checks."""
    c = generate_default_run(c)
    c.global_.plan = manifest.name

    tcase = manifest.testcase_by_name(c.global_.case)
    if tcase is None:
        raise ValueError(
            f"test case {c.global_.case} not found in plan {manifest.name}"
        )
    if not manifest.runners:
        raise ValueError("plan supports no runners; review the manifest")
    if not manifest.has_runner(c.global_.runner):
        raise ValueError(
            f"plan does not support runner '{c.global_.runner}'; "
            f"supported: {manifest.supported_runners()}"
        )

    for k, v in manifest.runners.get(c.global_.runner, {}).items():
        c.global_.run_config.setdefault(k, v)

    for run in c.runs:
        for g in run.groups:
            _prepare_run_group(g, run, c, manifest)
        run.recalculate_instance_counts()
        t = run.total_instances
        if t < tcase.instances.minimum or t > tcase.instances.maximum:
            raise ValueError(
                f"total instance count ({t}) outside of allowable range "
                f"[{tcase.instances.minimum}, {tcase.instances.maximum}] "
                f"for test case {tcase.name}"
            )
    return c
