"""placebo plan, torch edition: the twins of ``plans/placebo/sim.py``'s
do-nothing fixtures (ok / abort / panic / stall / silent /
optional-failure / metrics), the smallest testcases, which exercise the
engine's outcome plumbing: every terminal status, a run that never ends,
and a per-instance metric."""

import torch

from testground_tpu_torch.sim.api import (
    CRASH,
    FAILURE,
    RUNNING,
    SUCCESS,
    SimTestcase,
)


class Ok(SimTestcase):
    def step(self, env, state, inbox, sync, t):
        return self.out(state, status=SUCCESS)


class Abort(SimTestcase):
    """record_failure + error return."""

    def step(self, env, state, inbox, sync, t):
        return self.out(state, status=FAILURE)


class Panic(SimTestcase):
    def step(self, env, state, inbox, sync, t):
        return self.out(state, status=CRASH)


class Stall(SimTestcase):
    """Never terminates: the run ends at its tick budget."""

    def step(self, env, state, inbox, sync, t):
        return self.out(state, status=RUNNING)


class Silent(SimTestcase):
    """Never emits a terminal status: the run ends at its tick budget with
    the instance still RUNNING, judged incomplete."""

    def step(self, env, state, inbox, sync, t):
        return self.out(state, status=RUNNING)


class OptionalFailure(SimTestcase):
    """Fails when the group parameter ``should_fail`` is "true"."""

    def init(self, env):
        self.should_fail = env.group.params.get("should_fail", "") == "true"
        return {}

    def step(self, env, state, inbox, sync, t):
        return self.out(state, status=FAILURE if self.should_fail else SUCCESS)


class Metrics(SimTestcase):
    """Counts to 10 across ticks, then succeeds; the counter is each
    instance's metric."""

    def init(self, env):
        return {
            "counter": torch.zeros(env.group_lanes, dtype=torch.int32, device=env.device)
        }

    def step(self, env, state, inbox, sync, t):
        counter = state["counter"] + 1
        return self.out(
            {"counter": counter},
            status=torch.where(counter >= 10, SUCCESS, RUNNING).to(torch.int32),
        )

    def collect_metrics(self, group, final_state, status):
        return {"placebo.counter": final_state["counter"]}


sim_testcases = {
    "ok": Ok,
    "abort": Abort,
    "panic": Panic,
    "stall": Stall,
    "silent": Silent,
    "optional-failure": OptionalFailure,
    "metrics": Metrics,
}
