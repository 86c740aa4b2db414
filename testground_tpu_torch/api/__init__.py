"""Spec types the port's control plane takes: compositions, manifests,
run and build input/output frames (the port's copies of the reference's
``testground_tpu/api``)."""

from .composition import (
    Build,
    Composition,
    CompositionRunGroup,
    Dependency,
    Global,
    Group,
    Instances,
    Metadata,
    Resources,
    Run,
    RunParams,
)
from .manifest import InstanceConstraints, Parameter, TestCase, TestPlanManifest
from .preparation import (
    generate_default_run,
    load_composition,
    prepare_for_build,
    prepare_for_run,
)
from .run_input import (
    BuildInput,
    BuildOutput,
    CollectionInput,
    OutputsEnv,
    RunGroup,
    RunInput,
    RunOutput,
)
from .template import TemplateError, compile_composition_template, render_template
from .validation import CompositionError, validate_for_build, validate_for_run

__all__ = [
    "Build",
    "BuildInput",
    "CollectionInput",
    "BuildOutput",
    "Composition",
    "CompositionError",
    "CompositionRunGroup",
    "Dependency",
    "Global",
    "Group",
    "InstanceConstraints",
    "Instances",
    "Metadata",
    "OutputsEnv",
    "Parameter",
    "Resources",
    "Run",
    "RunGroup",
    "RunInput",
    "RunOutput",
    "RunParams",
    "TemplateError",
    "TestCase",
    "TestPlanManifest",
    "compile_composition_template",
    "generate_default_run",
    "load_composition",
    "prepare_for_build",
    "prepare_for_run",
    "render_template",
    "validate_for_build",
    "validate_for_run",
]
