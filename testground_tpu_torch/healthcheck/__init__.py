"""Declarative healthcheck framework: check/fix pairs (the port's copy of
what the runner and the CLI use of the reference's
``testground_tpu/healthcheck``): a Helper enlists named (checker, fixer)
pairs; ``run_checks(fix=...)`` evaluates them and produces a report."""

from . import checkers, fixers
from .helper import Helper
from .report import CheckResult, Report

__all__ = ["CheckResult", "Helper", "Report", "checkers", "fixers"]
