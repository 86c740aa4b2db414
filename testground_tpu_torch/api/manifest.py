"""Test-plan manifest types.

A plan's ``manifest.toml`` declares which builders and runners it supports
and its test cases with typed parameters and instance bounds. Behavioral twin
of the reference's ``pkg/api/manifest.go:14-162``; reference manifests parse
unchanged (same table/key names, including the ``instances = {min, max,
default}`` inline table).

The port's own copy of the reference's ``testground_tpu/api/manifest.py``
(ROADMAP's copy policy); ``tests/test_torch_composition.py`` pins it against
the original.
"""

from __future__ import annotations

import json
import tomllib
from dataclasses import dataclass, field
from typing import Any

__all__ = ["InstanceConstraints", "Parameter", "TestCase", "TestPlanManifest"]


@dataclass
class InstanceConstraints:
    """How many instances a test case may run
    (``pkg/api/manifest.go:45-49`` + the ``default`` key reference manifests
    carry, e.g. ``plans/placebo/manifest.toml``)."""

    minimum: int = 0
    maximum: int = 0
    default: int = 0

    @classmethod
    def from_dict(cls, d: dict) -> "InstanceConstraints":
        return cls(
            minimum=int(d.get("min", 0)),
            maximum=int(d.get("max", 0)),
            default=int(d.get("default", 0)),
        )

    def to_dict(self) -> dict:
        return {"min": self.minimum, "max": self.maximum, "default": self.default}


@dataclass
class Parameter:
    """Metadata about a test-case parameter (``pkg/api/manifest.go:37-43``)."""

    type: str = ""
    description: str = ""
    unit: str = ""
    default: Any = None

    @classmethod
    def from_dict(cls, d: dict) -> "Parameter":
        return cls(
            type=d.get("type", ""),
            description=d.get("desc", ""),
            unit=d.get("unit", ""),
            default=d.get("default"),
        )

    def to_dict(self) -> dict:
        out = {"type": self.type, "desc": self.description, "unit": self.unit}
        if self.default is not None:
            out["default"] = self.default
        return out


@dataclass
class TestCase:
    """A test case declared by a plan (``pkg/api/manifest.go:29-35``)."""

    __test__ = False  # not a pytest class despite the name

    name: str = ""
    instances: InstanceConstraints = field(default_factory=InstanceConstraints)
    parameters: dict[str, Parameter] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: dict) -> "TestCase":
        return cls(
            name=d.get("name", ""),
            instances=InstanceConstraints.from_dict(d.get("instances", {})),
            parameters={
                k: Parameter.from_dict(v) for k, v in d.get("params", {}).items()
            },
        )

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "instances": self.instances.to_dict(),
            "params": {k: p.to_dict() for k, p in self.parameters.items()},
        }

    def describe(self) -> str:
        lines = [
            f"- Test case: {self.name}",
            "  Instances:",
            f"    minimum: {self.instances.minimum}",
            f"    maximum: {self.instances.maximum}",
            "  Parameters:",
        ]
        for name, p in self.parameters.items():
            lines.append(
                f"    {name} | {p.type} | {p.description} | {p.unit} "
                f"| default: {p.default}"
            )
        return "\n".join(lines) + "\n"


@dataclass
class TestPlanManifest:
    """A test plan known to the system (``pkg/api/manifest.go:14-27``)."""

    __test__ = False  # not a pytest class despite the name

    name: str = ""
    builders: dict[str, dict] = field(default_factory=dict)
    runners: dict[str, dict] = field(default_factory=dict)
    testcases: list[TestCase] = field(default_factory=list)
    extra_sources: dict[str, list[str]] = field(default_factory=dict)
    # Reference manifests carry a [defaults] table (builder/runner) used by
    # `testground run single` and plan templates (plans/placebo/manifest.toml).
    defaults: dict[str, str] = field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: dict) -> "TestPlanManifest":
        return cls(
            name=d.get("name", ""),
            builders=dict(d.get("builders", {})),
            runners=dict(d.get("runners", {})),
            testcases=[TestCase.from_dict(x) for x in d.get("testcases", [])],
            extra_sources={
                k: list(v) for k, v in d.get("extra_sources", {}).items()
            },
            defaults=dict(d.get("defaults", {})),
        )

    @classmethod
    def from_toml(cls, text: str) -> "TestPlanManifest":
        return cls.from_dict(tomllib.loads(text))

    @classmethod
    def load_file(cls, path) -> "TestPlanManifest":
        with open(path, "rb") as f:
            return cls.from_dict(tomllib.load(f))

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "builders": dict(self.builders),
            "runners": dict(self.runners),
            "testcases": [tc.to_dict() for tc in self.testcases],
            "extra_sources": dict(self.extra_sources),
            "defaults": dict(self.defaults),
        }

    def testcase_by_name(self, name: str) -> TestCase | None:
        """(``pkg/api/manifest.go:52-59``)."""
        for tc in self.testcases:
            if tc.name == name:
                return tc
        return None

    def default_parameters(self, testcase_name: str) -> dict[str, str]:
        """Default test params for a case, JSON-encoding non-string defaults
        (``pkg/api/manifest.go:61-84``)."""
        tc = self.testcase_by_name(testcase_name)
        if tc is None:
            raise KeyError(f"test case {testcase_name} not found")
        out: dict[str, str] = {}
        for n, p in tc.parameters.items():
            if p.default is None:
                continue
            if isinstance(p.default, str):
                out[n] = p.default
            else:
                out[n] = json.dumps(p.default)
        return out

    def has_builder(self, name: str) -> bool:
        return name in self.builders

    def has_runner(self, name: str) -> bool:
        return name in self.runners

    def supported_builders(self) -> list[str]:
        return list(self.builders)

    def supported_runners(self) -> list[str]:
        return list(self.runners)

    def describe(self) -> str:
        """Human description (``pkg/api/manifest.go:120-146``)."""
        return (
            f'This test plan is called "{self.name}".\n\n'
            f"It can be built with strategies: {self.supported_builders()}.\n\n"
            f"It can be run with strategies: {self.supported_runners()}.\n\n"
            f"It has {len(self.testcases)} test cases.\n"
        )
