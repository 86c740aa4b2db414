"""Composition validation.

Behavioral twin of ``pkg/api/composition_validation.go``: structural checks
(required fields), group/run uniqueness and cross-references, the
count-XOR-percentage rule, and instance-count recalculation for runs.

The port's own copy of the reference's ``testground_tpu/api/validation.py``
(ROADMAP's copy policy); ``tests/test_torch_composition.py`` pins it against
the original.
"""

from __future__ import annotations

from .composition import Composition, Instances

__all__ = ["CompositionError", "validate_for_build", "validate_for_run"]


class CompositionError(ValueError):
    """Raised when a composition fails validation."""


def _validate_instances(inst: Instances, where: str) -> None:
    """Either count or percentage must be provided, not both
    (``composition_validation.go:114-123``)."""
    ok = (inst.count == 0 or inst.percentage == 0) and (
        float(inst.count) + inst.percentage > 0
    )
    if not ok:
        raise CompositionError(
            f"{where}: exactly one of instances.count / instances.percentage "
            f"must be set (got count={inst.count}, "
            f"percentage={inst.percentage})"
        )


def _validate_groups(c: Composition) -> None:
    """(``composition_validation.go:15-33``)."""
    seen: set[str] = set()
    for g in c.groups:
        if g.id in seen:
            raise CompositionError(
                f"group ids not unique; found duplicate: {g.id}"
            )
        seen.add(g.id)
    for g in c.groups:
        if not g.builder and not c.global_.builder:
            raise CompositionError(f"group {g.id} is missing a builder")


def _validate_runs(c: Composition) -> None:
    """(``composition_validation.go:35-75``)."""
    seen: set[str] = set()
    for r in c.runs:
        if r.id in seen:
            raise CompositionError(f"runs ids not unique; found duplicate: {r.id}")
        seen.add(r.id)
    for r in c.runs:
        for g in r.groups:
            try:
                c.get_group(g.effective_group_id())
            except KeyError:
                raise CompositionError(
                    f"run {r.id}:{g.id} references non-existent group "
                    f"{g.effective_group_id()}"
                ) from None
        run_group_ids: set[str] = set()
        for g in r.groups:
            if g.id in run_group_ids:
                raise CompositionError(
                    f"group ids not unique; found duplicate: {r.id}:{g.id}"
                )
            run_group_ids.add(g.id)
    for r in c.runs:
        for g in r.groups:
            # Zero instances is the inherit-from-backing-group pattern; the
            # merge during prepare_for_run fills it in. The reference's
            # Runs.Validate applies no per-run-group instances check at all.
            if not g.instances.is_zero():
                _validate_instances(g.instances, f"run {r.id} group {g.id}")
        try:
            r.recalculate_instance_counts()
        except ValueError as e:
            raise CompositionError(str(e)) from None


def validate_for_build(c: Composition) -> None:
    """Validate for a build: plan + groups required; case/runner/runs exempt
    (``composition_validation.go:78-90``)."""
    if not c.global_.plan:
        raise CompositionError("composition is missing global.plan")
    if not c.groups:
        raise CompositionError("composition has no groups")
    for g in c.groups:
        if not g.instances.is_zero():
            _validate_instances(g.instances, f"group {g.id}")
    _validate_groups(c)


def validate_for_run(c: Composition) -> None:
    """Validate for a run: everything, including runs
    (``composition_validation.go:93-110``)."""
    if not c.global_.plan:
        raise CompositionError("composition is missing global.plan")
    if not c.global_.case:
        raise CompositionError("composition is missing global.case")
    if not c.global_.runner:
        raise CompositionError("composition is missing global.runner")
    if not c.groups:
        raise CompositionError("composition has no groups")
    for g in c.groups:
        if not g.instances.is_zero():
            _validate_instances(g.instances, f"group {g.id}")
    _validate_groups(c)
    if not c.runs:
        raise CompositionError("composition has no runs")
    _validate_runs(c)
