"""A cohort's placed carry (``sim/distributed.py``, ``sim/meshplan.py``
``MeshPlan.lane_axis``, the placed tick of ``sim/engine.py``, ``sim/net.py``
and ``sim/sync_kernel.py``) on the CPU, gloo over loopback:

- placement: on 2 and 3 ranks, and on 9 instances over 2 ranks (one dead
  lane pads the last group), each rank's carry holds exactly its
  ``n_loc`` lanes of every placed leaf (the table's lane-split paths, the
  plan states, the keys, the sync service's per-instance planes, the
  calendar shard), every replicated leaf is equal on every rank and to
  the single program's, a rank's ``carry_bytes`` is the replicated bytes
  plus the placed bytes ÷ P, the digest of the carry gathered from every
  rank is the single program's, and so are the planes' chunks (the
  telemetry rows, a trace of lanes on every rank, the histogram, the
  matrix);
- equality through the executor, on traffic that crosses ranks: storm's
  fan-in, a pub/sub plan, ``additional_hosts`` with its echo host on the
  last rank, a partition whose halves sit on different ranks, and a
  mid-run reshape of the follower's lanes — each cohort's result equals
  the port's single-process run's and the reference's, per instance, in
  the journal's metrics and flow totals, and every process's gathered
  carry digest equals the single run's;
- a layout the placed tick cannot take (a last rank with no instance
  lane) is refused, not replicated.

Every child has a timeout and is killed in ``finally``.
"""

import hashlib
import json
import os
import subprocess
import sys
import threading

import pytest
from test_torch_cohort import (
    FLOW,
    REF_PLANS,
    _clean_env,
    _cohort,
    _free_port,
    _instance_digest,
    _kill_all,
    _single_digest,
)

from testground_tpu.api import RunGroup as JRunGroup
from testground_tpu.api import RunInput as JRunInput
from testground_tpu.config import EnvConfig as JEnvConfig
from testground_tpu.rpc import discard_writer as jdiscard
from testground_tpu.sim import executor as jexec
from testground_tpu_torch.api import OutputsEnv, RunGroup, RunInput
from testground_tpu_torch.rpc import discard_writer
from testground_tpu_torch.sim import executor as pexec

SUSTAINED = {"duration_ticks": "96", "latency_ms": "4", "latency2_ms": "2",
             "reshape_every": "32"}

# ----------------------------------------------------------------- placement

# each rank: a few ticks of sustained with every plane on (a trace of lanes
# on both ranks), then every leaf of its carry — a placed leaf's lane
# extent, a replicated leaf's bytes' hash — its carry's bytes, the
# gathered carry's digest and the planes' chunks
PLACE_SCRIPT = r"""
import hashlib, json, sys
import torch
from testground_tpu_torch.api import RunGroup
from testground_tpu_torch.sim import distributed
from testground_tpu_torch.sim.checkpoint import _source, leaf_paths
from testground_tpu_torch.sim.engine import SimProgram, build_groups, carry_bytes
from testground_tpu_torch.sim.executor import instantiate_testcase, load_sim_testcases, plan_dir
from testground_tpu_torch.sim.trace import build_trace_plan

coord, pid, procs, n, params = (sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
                                int(sys.argv[4]), json.loads(sys.argv[5]))
distributed.init_distributed(coord, procs, pid)
groups = build_groups([RunGroup(id="all", instances=n, parameters=params)])
tc = instantiate_testcase(load_sim_testcases(plan_dir("network"))["pingpong-sustained"],
                          groups, 1.0)
prog = SimProgram(tc, groups, chunk=8, device="cpu", telemetry=True, netmatrix=True,
                  trace=build_trace_plan(groups, {"all": {"instances": f"1:{n - 1}"}}),
                  mesh=distributed.global_mesh("cpu"))
last, planes = {}, []
res = prog.run(seed=0, max_ticks=24, cancel=distributed.CohortCancel(None),
               observer=lambda t, c: last.update(c=c),
               telemetry_cb=lambda b: planes.append(b.tolist()),
               trace_cb=lambda b: planes.append(b.tolist()))
c = last["c"]
lanes, repl = {}, {}
for path in leaf_paths(c):
    x = _source(c, path)
    if path.startswith("cal."):
        lanes[path] = sum(p.shape[0] * p.shape[-1] for p in x) // c.cal.slots
    elif prog.meshplan.lane_axis(path) is not None:
        lanes[path] = x.shape[prog.meshplan.lane_axis(path)]
    elif isinstance(x, torch.Tensor):
        repl[path] = hashlib.sha1(x.contiguous().numpy().tobytes()).hexdigest()
print("RESULT " + json.dumps({"lanes": lanes, "repl": repl, "bytes": carry_bytes(c),
                              "digest": prog.carry_digest(c),
                              "planes": [planes, res["lat_hist"], res["net_matrix"]]}),
      flush=True)
distributed.shutdown()
"""


def _program(n, mesh=None):
    from testground_tpu_torch.sim.engine import SimProgram, build_groups
    from testground_tpu_torch.sim.trace import build_trace_plan

    groups = build_groups([RunGroup(id="all", instances=n, parameters=SUSTAINED)])
    tc = pexec.instantiate_testcase(
        pexec.load_sim_testcases(pexec.plan_dir("network"))["pingpong-sustained"],
        groups, 1.0)
    return SimProgram(tc, groups, chunk=8, device="cpu", telemetry=True, netmatrix=True,
                      trace=build_trace_plan(groups, {"all": {"instances": f"1:{n - 1}"}}),
                      mesh=mesh)


@pytest.mark.parametrize("n,procs", [(8, 2), (12, 3), (9, 2)],
                         ids=["8-over-2", "12-over-3", "9-over-2-padded"])
def test_each_rank_holds_its_own_lanes_and_equal_replicas(n, procs):
    import torch

    from testground_tpu_torch.sim.checkpoint import _source, leaf_paths
    from testground_tpu_torch.sim.engine import carry_bytes, carry_digest
    from testground_tpu_torch.sim.meshplan import make_mesh

    coord = f"127.0.0.1:{_free_port()}"
    cmd = [sys.executable, "-c", PLACE_SCRIPT, coord]
    ps = [subprocess.Popen(cmd + [str(pid), str(procs), str(n), json.dumps(SUSTAINED)],
                           env=_clean_env(), stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True) for pid in range(procs)]
    try:
        outs = [p.communicate(timeout=60)[0] for p in ps]
    finally:
        _kill_all(ps)
    assert [p.returncode for p in ps] == [0] * procs, outs
    got = [json.loads(next(ln for ln in o.splitlines() if ln.startswith("RESULT "))[7:])
           for o in outs]

    # the same padded layout in one process: a virtual mesh of P shards
    virt = _program(n, make_mesh(str(procs), device="cpu"))
    n_loc = virt.n_lanes // procs
    carry = virt.init_carry(0)
    placed_bytes = repl_bytes = 0
    placed_paths = set()
    for path in leaf_paths(carry):
        x = _source(carry, path)
        size = (sum(p.numel() * p.element_size() for p in x) if path.startswith("cal.")
                else x.numel() * x.element_size() if isinstance(x, torch.Tensor) else 0)
        if path.startswith("cal.") or virt.meshplan.lane_axis(path) is not None:
            placed_bytes += size
            placed_paths.add(path)
        else:
            repl_bytes += size
    assert placed_bytes % procs == 0
    assert carry_bytes(carry) == placed_bytes + repl_bytes
    # what the issue names placed: the table's rows and link planes, the
    # plan states, the keys, the sync lane planes, the calendar
    assert {"status", "finished_at", "rejected", "link.egress", "link.filters",
            "link.region_of", "keys", "sync.last_seq", "sync.cursors", "cal.src",
            "cal.etick"} <= placed_paths
    assert any(p.startswith("states.") for p in placed_paths)

    single = _program(n)
    last, planes = {}, []
    res = single.run(seed=0, max_ticks=24, observer=lambda t, c: last.update(c=c),
                     telemetry_cb=lambda b: planes.append(b.tolist()),
                     trace_cb=lambda b: planes.append(b.tolist()))
    # the telemetry rows, the traced lanes' rows (from both ranks), the
    # histogram and the matrix
    want_planes = [planes, res["lat_hist"], res["net_matrix"]]
    assert sum(map(sum, res["lat_hist"])) > 0
    want_repl = {}
    for path in leaf_paths(last["c"]):
        x = _source(last["c"], path)
        if path not in placed_paths and isinstance(x, torch.Tensor):
            want_repl[path] = hashlib.sha1(x.contiguous().numpy().tobytes()).hexdigest()

    for rank in got:
        assert set(rank["lanes"]) == placed_paths
        assert rank["lanes"] == {p: n_loc for p in placed_paths}
        assert rank["repl"] == want_repl
        assert rank["bytes"] == repl_bytes + placed_bytes // procs
        assert rank["digest"] == carry_digest(last["c"])
        assert rank["planes"] == want_planes


# ------------------------------------------------------------------ equality


def _groups_of(spec):
    return spec.get("groups") or [{"id": "all", "instances": spec["instances"],
                                   "params": spec.get("params", {}),
                                   "faults": spec.get("faults", [])}]


def _job(root, spec, **cfg):
    plan = spec["plan"]
    gs = _groups_of(spec)
    return RunInput(
        run_id=spec["run_id"], test_plan=plan, test_case=spec["case"],
        total_instances=sum(g["instances"] for g in gs),
        groups=[RunGroup(id=g["id"], instances=g["instances"], parameters=dict(g["params"]),
                         artifact_path=os.path.join(pexec.PLANS_ROOT, plan),
                         faults=list(g.get("faults", []))) for g in gs],
        runner_config=pexec.SimTorchConfig(device="cpu", chunk=spec.get("chunk", 64),
                                           **spec.get("cfg", {}), **cfg),
        env=OutputsEnv(root),
    )


def _ref_run(home, spec):
    plan = spec["plan"]
    gs = _groups_of(spec)
    job = JRunInput(
        run_id=spec["run_id"], test_plan=plan, test_case=spec["case"],
        total_instances=sum(g["instances"] for g in gs),
        groups=[JRunGroup(id=g["id"], instances=g["instances"], parameters=dict(g["params"]),
                          artifact_path=os.path.join(REF_PLANS, plan),
                          faults=list(g.get("faults", []))) for g in gs],
        runner_config=jexec.SimJaxConfig(shard=False, transport="xla", perf=False,
                                         chunk=spec.get("chunk", 64), **spec.get("cfg", {})),
        env=JEnvConfig.load(home=str(home)),
    )
    out = jexec.execute_sim_run(job, jdiscard(), threading.Event())
    return out.result, os.path.join(str(home), "data", "outputs", plan, spec["run_id"])


# label: (spec, processes); each case's traffic crosses the ranks
CROSS_CASES = {
    # 16 senders fanning in over both ranks' lanes
    "storm-fan-in-16-2": ({"plan": "benchmarks", "case": "storm", "instances": 16,
                           "params": {"conn_outgoing": "6", "conn_delay_ticks": "4",
                                      "data_size_kb": "32"}}, 2),
    # publishes appended after the lower rank's, read by every rank
    "subtree-pubsub-2": ({"plan": "benchmarks", "case": "subtree", "instances": 8,
                          "params": {"subtree_iterations": "4"},
                          "cfg": {"max_ticks": 512}}, 2),
    # 8 instances and one echo host pad to 10 lanes: the host on rank 1
    "additional-hosts-2": ({"plan": "additional_hosts", "case": "additional_hosts",
                            "instances": 8, "chunk": 16,
                            "cfg": {"additional_hosts": ["http-echo"]}}, 2),
    # a partition of rank 0's lanes from rank 1's, and a crash on rank 1's
    "partition-across-ranks-2": ({"plan": "network", "case": "pingpong-sustained",
                                  "instances": 8, "chunk": 16, "params": SUSTAINED,
                                  "faults": [
                                      {"kind": "partition", "instances": "0:4",
                                       "to_instances": "4:8", "start_ms": 12.0,
                                       "duration_ms": 24.0},
                                      {"kind": "crash", "instances": "6:7",
                                       "start_ms": 40.0}]}, 2),
    # group b, on the follower's lanes, reshapes its links every 8 ticks
    "reshape-follower-lanes-2": ({"plan": "network", "case": "pingpong-sustained",
                                  "chunk": 16, "groups": [
                                      {"id": "a", "instances": 6,
                                       "params": {**SUSTAINED, "reshape_every": "1000"}},
                                      {"id": "b", "instances": 6,
                                       "params": {**SUSTAINED, "reshape_every": "8"}}]},
                                 2),
}


@pytest.mark.parametrize("label", list(CROSS_CASES))
def test_cross_rank_traffic_equals_single_process_and_reference(label, tmp_path):
    spec, n_procs = CROSS_CASES[label]
    spec = {**spec, "run_id": f"rows-{label}"}
    hosts = spec.get("cfg", {}).get("additional_hosts", ())

    def singles():
        single = pexec.execute_sim_run(_job(str(tmp_path / "single"), spec),
                                       discard_writer(), threading.Event())
        ref, ref_dir = _ref_run(tmp_path / "ref", spec)
        return single.result, ref, ref_dir, _single_digest(
            {**spec, "groups": _groups_of(spec)}, hosts=hosts)

    out, progress, outs, rcs, (single, ref, ref_dir, one) = _cohort(
        str(tmp_path / "cohort"), spec, n_procs, during=singles, make=_job)
    assert not isinstance(out, Exception), out
    assert rcs == [0] * (n_procs - 1), outs
    res = out.result
    assert res.outcome.value == single.outcome.value == ref.outcome.value
    sim = res.journal["sim"]
    assert (sim["processes"], sim["devices"]) == (n_procs, n_procs)
    assert res.journal.get("metrics") == single.journal.get("metrics") \
        == ref.journal.get("metrics")
    for key in FLOW:
        assert sim[key] == single.journal["sim"][key] == ref.journal["sim"][key], key
    digest = _instance_digest(str(tmp_path / "cohort" / spec["plan"] / spec["run_id"]))
    assert digest == _instance_digest(
        str(tmp_path / "single" / spec["plan"] / spec["run_id"]))
    assert digest == _instance_digest(ref_dir)
    lead = [ln.split("carry digest ")[1].split(",")[0] for ln in progress.splitlines()
            if "multi-host: carry digest" in ln]
    assert lead == [str(one)]
    for text in outs:
        assert f"run {spec['run_id']} carry digest {one}," in text



def test_a_layout_the_placed_tick_cannot_take_is_refused():
    """The host lanes sit last and must fit on the last rank beside an
    instance lane: 2 instances and a host over 3 ranks leave rank 2 only
    the host, which the placed tick refuses rather than replicating."""
    import torch

    from testground_tpu_torch.sim.engine import SimProgram, build_groups
    from testground_tpu_torch.sim.meshplan import TorchMesh

    groups = build_groups([RunGroup(id="all", instances=2, parameters={})])
    tc = pexec.instantiate_testcase(
        pexec.load_sim_testcases(pexec.plan_dir("additional_hosts"))["additional_hosts"],
        groups, 1.0)
    mesh = TorchMesh((torch.device("cpu"),) * 3, ranks=(0, 1, 2), rank=2)
    with pytest.raises(ValueError, match="host lane.*must fit on the last process"):
        SimProgram(tc, groups, device="cpu", hosts=("http-echo",), mesh=mesh)
