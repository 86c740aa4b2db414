"""Plan loading for the port: the library half of the reference executor
(``testground_tpu/sim/executor.py:247-283``). Plans are the port's own
torch twins under ``testground_tpu_torch/plans/<plan>/``."""

from __future__ import annotations

import importlib.util
import os
import sys
import uuid

__all__ = ["instantiate_testcase", "load_sim_testcases", "plan_dir"]

PLANS_ROOT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "plans"
)


def plan_dir(plan: str) -> str:
    """The port's directory of plan ``plan`` (e.g. ``"network"``)."""
    return os.path.join(PLANS_ROOT, plan)


def load_sim_testcases(artifact_path: str) -> dict:
    """Import the plan's sim module and return its ``sim_testcases`` map."""
    entry = None
    for name in ("sim.py", "main.py"):
        cand = os.path.join(artifact_path, name)
        if os.path.isfile(cand):
            entry = cand
            break
    if entry is None:
        raise FileNotFoundError(f"no sim.py/main.py entry point in {artifact_path}")
    modname = f"tg_torch_plan_{uuid.uuid4().hex[:8]}"
    spec = importlib.util.spec_from_file_location(modname, entry)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[modname] = mod
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.modules.pop(modname, None)
    cases = getattr(mod, "sim_testcases", None)
    if not isinstance(cases, dict) or not cases:
        raise ValueError(
            f"plan module {entry} does not export a non-empty `sim_testcases` dict"
        )
    return cases


def instantiate_testcase(factory, groups, tick_ms: float):
    """Specialize-then-instantiate a testcase factory (one path for every
    caller, so the same run always builds the same shapes)."""
    if isinstance(factory, type):
        return factory.specialize(groups, tick_ms=tick_ms)()
    return factory
