"""A mesh of several parts in one process (``sim/engine.py`` ``PartedCarry``,
``sim/meshplan.py`` ``TorchMesh.part_view``, ``sim/distributed.py``
``PartGroup``) on the CPU, explicit parts on one device:

- placement: on 2, 3 and 4 parts, on parts of unequal size, on 9 instances
  over 2 parts (one dead lane pads the last group) and with a host lane on
  the last part, each part's carry holds exactly its lanes of every leaf
  ``MeshPlan.lane_axis`` names and its shards' calendar planes, every
  replicated leaf is equal on every part and to the unmeshed run's, a
  part's ``carry_bytes`` is the replicated bytes plus its placed bytes,
  the results, every plane's chunks and the carry digest are the
  one-part mesh's and (without padding) the unmeshed run's;
- equality through the executor, with every plane on (telemetry, the
  matrix, a trace, an SLO) on traffic that crosses parts: storm's fan-in,
  subtree pub/sub, ``additional_hosts`` with its echo host on the last
  part, a partition across parts with a crash, and a mid-run reshape of
  the last part's lanes: each run's metrics, flow totals, per-instance
  outcomes and plane streams equal the one-part mesh's, the unmeshed
  port run's and the reference's;
- through the executor on 2 parts, snapshots, a resumed run and the phase
  and perf ledgers, the resumed run equal to the uninterrupted one and to
  the one-part mesh's; a snapshot taken on 2 parts resumes bit-equal
  unmeshed, and an unmeshed snapshot resumes bit-equal on 2 parts;
- a failure forced in part 1 fails the run with its own error within a
  bounded time, leaves no part thread behind, and the program runs again;
- a mesh of one part issues the ops and host reads a tick of the code
  before the parts held their own lanes (counted).
"""

import collections
import hashlib
import json
import os
import threading
import time

import numpy as np
import pytest
import torch
from test_torch_cohort import FLOW, _instance_digest
from test_torch_cohort_rows import CROSS_CASES, SUSTAINED, _groups_of, _ref_run
from test_torch_engine import assert_results_equal
from torch.utils._python_dispatch import TorchDispatchMode

from testground_tpu_torch.api import OutputsEnv, RunGroup, RunInput
from testground_tpu_torch.rpc import discard_writer
from testground_tpu_torch.sim import executor as pexec
from testground_tpu_torch.sim.checkpoint import (
    _source,
    leaf_paths,
    restore_carry,
    snapshot_carry,
)
from testground_tpu_torch.sim.engine import (
    PartedCarry,
    SimProgram,
    build_groups,
    carry_bytes,
    carry_digest,
)
from testground_tpu_torch.sim.meshplan import TorchMesh, make_mesh
from testground_tpu_torch.sim.trace import build_trace_plan

CPU = torch.device("cpu")


def parts_mesh(cells, cuts):
    """``cells`` peer shards on the CPU cut into parts at ``cuts``."""
    bounds = (0, *cuts, cells)
    return TorchMesh((CPU,) * cells, parts=tuple((CPU, a, b) for a, b in zip(bounds,
                                                                              bounds[1:])))


def _program(plan, case, n, params, mesh=None, hosts=(), chunk=8):
    groups = build_groups([RunGroup(id="all", instances=n, parameters=params)])
    tc = pexec.instantiate_testcase(pexec.load_sim_testcases(pexec.plan_dir(plan))[case],
                                    groups, 1.0)
    return SimProgram(tc, groups, chunk=chunk, device="cpu", telemetry=True, netmatrix=True,
                      trace=build_trace_plan(groups,
                                             {"all": {"instances": f"1:{max(n - 1, 2)}"}}),
                      hosts=hosts, mesh=mesh)


def _record(prog, max_ticks=24):
    last, planes = {}, []
    res = prog.run(seed=0, max_ticks=max_ticks, observer=lambda t, c: last.update(c=c),
                   telemetry_cb=lambda b: planes.append(b.tolist()),
                   trace_cb=lambda b: planes.append(b.tolist()))
    return res, last["c"], [planes, res["lat_hist"], res["net_matrix"]]


def _hash(x):
    return hashlib.sha1(x.detach().contiguous().numpy().tobytes()).hexdigest()


# label: (plan, case, instances, params, hosts, cells, cuts)
PLACEMENTS = {
    "8-over-2": ("network", "pingpong-sustained", 8, SUSTAINED, (), 2, (1,)),
    "12-over-3": ("network", "pingpong-sustained", 12, SUSTAINED, (), 3, (1, 2)),
    "16-over-4": ("network", "pingpong-sustained", 16, SUSTAINED, (), 4, (1, 2, 3)),
    "16-over-1+3": ("network", "pingpong-sustained", 16, SUSTAINED, (), 4, (1,)),
    "9-over-2-padded": ("network", "pingpong-sustained", 9, SUSTAINED, (), 2, (1,)),
    "hosts-on-the-last-part": ("additional_hosts", "additional_hosts", 7, {},
                               ("http-echo",), 2, (1,)),
}


@pytest.mark.parametrize("label", list(PLACEMENTS))
def test_each_part_holds_its_own_lanes_and_equal_replicas(label):
    plan, case, n, params, hosts, cells, cuts = PLACEMENTS[label]
    mesh = parts_mesh(cells, cuts)
    prog = _program(plan, case, n, params, mesh, hosts)
    one = _program(plan, case, n, params, make_mesh(str(cells), device="cpu"), hosts)
    alone = _program(plan, case, n, params, hosts=hosts)
    assert prog.parted and not one.parted and len(prog._parts) == len(cuts) + 1
    res, carry, planes = _record(prog)
    res_one, carry_one, planes_one = _record(one)
    res_alone, carry_alone, planes_alone = _record(alone)
    assert isinstance(carry, PartedCarry)
    assert_results_equal(res_one, res, label)
    assert_results_equal(res_alone, res, label)
    assert planes == planes_one == planes_alone
    assert prog.carry_digest(carry) == one.carry_digest(carry_one)
    if not prog.mesh_pad:
        assert prog.carry_digest(carry) == carry_digest(carry_alone)
    assert prog.footprint(carry) == one.footprint(carry_one)

    n_loc = prog.n_lanes // cells
    whole = {path: _source(carry_one, path) for path in leaf_paths(carry_one)}
    placed_paths = set()
    for part, c, (_, s0, s1) in zip(prog._parts, carry.parts, mesh.parts):
        lo, hi = s0 * n_loc, s1 * n_loc
        assert (part._lo, part._hi) == (lo, hi)
        placed = replicated = 0
        for path in leaf_paths(c):
            x = _source(c, path)
            if not isinstance(x, torch.Tensor) and not path.startswith("cal."):
                continue
            axis = prog.meshplan.lane_axis(path)
            if path.startswith("cal."):
                # its shards' planes, whose columns are its lanes' slots
                (plane,) = x
                assert plane.shape[0] == s1 - s0
                assert plane.shape[-1] == c.cal.slots * n_loc
                placed += plane.numel() * plane.element_size()
                placed_paths.add(path)
                continue
            if axis is None:
                assert _hash(x) == _hash(_source(carry.parts[0], path)), (label, path)
                assert _hash(x) == _hash(whole[path].cpu()), (label, path)
                replicated += x.numel() * x.element_size()
                continue
            placed_paths.add(path)
            if path.startswith("states."):
                g = prog.groups[int(path.split(".")[1])]
                want = range(max(g.offset, lo), min(g.offset + g.count, hi))
                full = whole[path][[i - g.offset for i in want]]
            else:
                held = part._n_inst if path in ("keys", "sync.last_seq",
                                                "sync.cursors") else hi - lo
                full = whole[path].narrow(axis, lo, held)
            assert x.shape == full.shape, (label, path)
            assert torch.equal(x, full), (label, path)
            placed += x.numel() * x.element_size()
        assert carry_bytes(c) == placed + replicated
    assert {"status", "finished_at", "rejected", "link.egress", "link.filters",
            "link.region_of", "keys", "sync.last_seq", "sync.cursors", "cal.src",
            "cal.etick"} <= placed_paths
    assert any(p.startswith("states.") for p in placed_paths)
    if len(set(s1 - s0 for _, s0, s1 in mesh.parts)) == 1 and not hosts:
        # equal parts: replicated + placed ÷ P each
        sizes = prog.part_bytes(carry)
        assert len(set(sizes)) == 1


def test_a_layout_whose_last_part_holds_only_hosts_keeps_one_part_placement():
    """2 instances and a host over 3 parts leave the last part only the
    host lane: the program keeps the calendar split (every other leaf on
    the primary device) and runs as the unmeshed one."""
    mesh = parts_mesh(3, (1, 2))
    prog = _program("additional_hosts", "additional_hosts", 2, {}, mesh, ("http-echo",))
    alone = _program("additional_hosts", "additional_hosts", 2, {}, hosts=("http-echo",))
    assert not prog.parted
    res, carry, planes = _record(prog)
    res_alone, _, planes_alone = _record(alone)
    assert not isinstance(carry, PartedCarry)
    assert_results_equal(res_alone, res, "hosts alone on the last part")
    assert planes == planes_alone


# ------------------------------------------------------------ the executor

TRACE = {"instances": "0:3"}
SLO = [{"name": "fleet-mostly-alive", "metric": "crashed_fraction", "op": "<",
        "threshold": 0.5, "severity": "warn"}]
PLANE_FILES = ("sim_timeseries.jsonl", "sim_latency.jsonl", "sim_netmatrix.jsonl",
               "sim_trace.jsonl", "sim_slo.jsonl")


def _job(root, spec, **cfg):
    plan = spec["plan"]
    gs = _groups_of(spec)
    return RunInput(
        run_id=spec["run_id"], test_plan=plan, test_case=spec["case"],
        total_instances=sum(g["instances"] for g in gs),
        groups=[RunGroup(id=g["id"], instances=g["instances"], parameters=dict(g["params"]),
                         artifact_path=os.path.join(pexec.PLANS_ROOT, plan),
                         faults=list(g.get("faults", [])), trace=dict(TRACE))
                for g in gs],
        runner_config=pexec.SimTorchConfig(device="cpu", chunk=spec.get("chunk", 64),
                                           telemetry=True, netmatrix=True,
                                           **spec.get("cfg", {}), **cfg),
        env=OutputsEnv(root), slo=list(SLO),
    )


def _streams(run_dir):
    """The planes' streams of a run, its ID and wall-clock fields dropped."""
    out = {}
    for name in PLANE_FILES:
        path = os.path.join(run_dir, name)
        if os.path.isfile(path):
            with open(path) as f:
                out[name] = [{k: v for k, v in json.loads(ln).items()
                              if "wall" not in k and k not in ("ts", "time", "run")}
                             for ln in f if ln.strip()]
    return out


@pytest.mark.parametrize("label", list(CROSS_CASES))
def test_cross_part_traffic_equals_one_part_unmeshed_and_reference(label, tmp_path,
                                                                   monkeypatch):
    spec = {**CROSS_CASES[label][0], "run_id": f"parts-{label}"}
    runs = {}
    real = pexec._make_mesh
    for way in ("one-part", "parts", "unmeshed"):
        if way == "parts":
            # the executor's 4-shard mesh on the CPU, cut into 2 parts of 2
            monkeypatch.setattr(pexec, "_make_mesh", lambda *a: parts_mesh(4, (2,)))
        else:
            monkeypatch.setattr(pexec, "_make_mesh", real)
        cfg = {"mesh": "4"} if way != "unmeshed" else {}
        root = str(tmp_path / way)
        out = pexec.execute_sim_run(_job(root, spec, **cfg), discard_writer(),
                                    threading.Event())
        runs[way] = (out.result, os.path.join(root, spec["plan"], spec["run_id"]))
    ref, ref_dir = _ref_run(tmp_path / "ref", spec)
    res, run_dir = runs["parts"]
    one, one_dir = runs["one-part"]
    alone, alone_dir = runs["unmeshed"]
    assert res.outcome.value == one.outcome.value == alone.outcome.value \
        == ref.outcome.value
    assert res.journal["sim"]["mesh"] == one.journal["sim"]["mesh"]
    assert res.journal.get("metrics") == one.journal.get("metrics") \
        == alone.journal.get("metrics") == ref.journal.get("metrics")
    for key in FLOW:
        assert res.journal["sim"][key] == one.journal["sim"][key] \
            == alone.journal["sim"][key] == ref.journal["sim"][key], key
    digest = _instance_digest(run_dir)
    assert digest == _instance_digest(one_dir) == _instance_digest(alone_dir) \
        == _instance_digest(ref_dir)
    streams = _streams(run_dir)
    assert {"sim_timeseries.jsonl", "sim_netmatrix.jsonl", "sim_trace.jsonl"} <= set(streams)
    assert streams == _streams(one_dir) == _streams(alone_dir)
    assert res.journal["telemetry"]["totals"] == one.journal["telemetry"]["totals"] \
        == alone.journal["telemetry"]["totals"]


def _exec(run_id, env, **cfg):
    job = RunInput(run_id=run_id, test_plan="network", test_case="ping-pong",
                   total_instances=4,
                   groups=[RunGroup(id="single", instances=4,
                                    artifact_path=pexec.plan_dir("network"))],
                   runner_config=pexec.SimTorchConfig(device="cpu", chunk=32, telemetry=True,
                                                      netmatrix=True, seed=5, mesh="4",
                                                      **cfg),
                   env=env)
    return pexec.execute_sim_run(job, discard_writer(), threading.Event()).result.journal


def test_checkpoints_resume_and_ledgers_run_on_parts(tmp_path, monkeypatch):
    """Through the executor on 2 parts: snapshots every 2 chunks, a run cut
    at tick 64 resumed into another, the phase and perf ledgers; the
    resumed journal and streams equal the uninterrupted run's and the
    one-part mesh's."""
    env = OutputsEnv(tmp_path)
    real = pexec._make_mesh
    monkeypatch.setattr(pexec, "_make_mesh", lambda *a: parts_mesh(4, (2,)))
    full = _exec("full", env, max_ticks=256, checkpoint_chunks=2, phases=True)
    cut = _exec("cut", env, max_ticks=64, checkpoint_chunks=2)
    res = _exec("res", env, max_ticks=256, checkpoint_chunks=2, resume_from="cut")
    monkeypatch.setattr(pexec, "_make_mesh", real)
    one = _exec("one", env, max_ticks=256)
    assert cut["sim"]["checkpoint"]["last_tick"] == 64
    assert res["sim"]["checkpoint"]["resumed"]["from_tick"] == 64
    assert full["sim"]["phases"]["phases"] and full["sim"]["perf"]["instances"] == 4
    for key in FLOW:
        assert res["sim"][key] == full["sim"][key] == one["sim"][key], key
    assert res["telemetry"] == full["telemetry"] == one["telemetry"]
    assert res["events"] == full["events"] == one["events"]
    assert res["sim"]["net_matrix"]["matrix"] == full["sim"]["net_matrix"]["matrix"] \
        == one["sim"]["net_matrix"]["matrix"]
    root = os.path.join(env.dirs.outputs(), "network")
    assert _streams(os.path.join(root, "res")) == _streams(os.path.join(root, "full")) \
        == _streams(os.path.join(root, "one"))


# ------------------------------------------------------------- snapshots

CUT = 32


def _capture(prog, transport, **kw):
    got = {}

    def obs(ticks, carry):
        got["end"] = snapshot_carry(carry, transport, export=prog.lane_export())
        if ticks == CUT:
            got["cut"] = got["end"]

    res = prog.run(seed=3, observer=obs, **kw)
    return res, got


def _leaves_equal(a, b, label):
    (la, ma), (lb, mb) = a, b
    assert ma == mb, label
    for i, (x, y) in enumerate(zip(la, lb)):
        assert x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x, y), \
            (label, i, ma[i])


@pytest.mark.parametrize("n", [8, 9])
def test_a_two_part_snapshot_resumes_unmeshed_and_back(n):
    """A snapshot on 2 parts is the unmeshed run's (its ``pallas``
    layout, the global planes), and either resumes on the other to the
    uninterrupted run's end, bit for bit (9 instances: a dead lane the
    snapshot leaves out)."""
    params = {**SUSTAINED, "duration_ticks": "64"}

    def parted():
        return _program("network", "pingpong-sustained", n, params, parts_mesh(2, (1,)))

    def alone():
        return _program("network", "pingpong-sustained", n, params)

    res_a, snap_a = _capture(alone(), "pallas", max_ticks=256)
    res_p, snap_p = _capture(parted(), "xla", max_ticks=256)
    assert_results_equal(res_a, res_p, "parted")
    _leaves_equal(snap_a["cut"], snap_p["cut"], "cut")
    _leaves_equal(snap_a["end"], snap_p["end"], "end")
    lat = np.asarray(alone().run(seed=3, max_ticks=CUT)["lat_hist"], np.int64)
    nm = np.asarray(alone().run(seed=3, max_ticks=CUT)["net_matrix"], np.int64)
    for label, (make, transport, snap) in {
        "parts→unmeshed": (alone, "pallas", snap_p["cut"]),
        "unmeshed→parts": (parted, "xla", snap_a["cut"]),
    }.items():
        prog = make()
        leaves, metas = snap
        carry = restore_carry(prog, 3, {"leaves": metas}, leaves, transport=transport)
        assert isinstance(carry, PartedCarry) == prog.parted
        res, end = _capture(prog, transport, max_ticks=256, resume_carry=carry,
                            resume_ticks=CUT, lat_hist_init=lat, net_mat_init=nm)
        assert_results_equal(res_a, res, label)
        _leaves_equal(snap_a["end"], end["end"], label)


# --------------------------------------------------------------- failure


def test_a_failure_in_part_one_fails_the_run_readably_and_promptly():
    prog = _program("network", "pingpong-sustained", 12, SUSTAINED, parts_mesh(4, (1, 2, 3)))
    want = prog.run(seed=0, max_ticks=48)
    real = prog._parts[1]._tick
    calls = {"n": 0}

    def tick(*a, **k):
        calls["n"] += 1
        if calls["n"] == 10:
            raise RuntimeError("forced failure in part 1")
        return real(*a, **k)

    prog._parts[1]._tick = tick
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="forced failure in part 1"):
        prog.run(seed=0, max_ticks=48)
    assert time.monotonic() - t0 < 20.0
    assert not [t for t in threading.enumerate() if t.name.startswith("sim-part-")]
    prog._parts[1]._tick = real
    assert_results_equal(want, prog.run(seed=0, max_ticks=48), "after a failure")


def test_the_part_group_folds_every_collective_in_part_order_under_switching():
    """12 parts (more than the cores), each on a thread of its own, meet
    300 times with the interpreter switching threads every microsecond:
    every sum, max and gather is the fold of that round's values in part
    order, on every part, and no thread is left waiting."""
    import sys

    from testground_tpu_torch.sim.distributed import PartGroup

    size, rounds = 12, 300
    group = PartGroup(size)
    views = [parts_mesh(size, tuple(range(1, size))).part_view(p, group)
             for p in range(size)]
    got, errors = [[] for _ in range(size)], []

    def part(p):
        try:
            group.start(p)
            for k in range(rounds):
                x = torch.tensor([p * 1000 + k, k - p], dtype=torch.int64)
                op = ("sum", "max", "gather")[k % 3]
                out = group.meet(p, op, x)
                got[p].append(out.clone())
            group.finish(p)
        except BaseException as e:  # noqa: BLE001 — asserted below
            errors.append(e)
            group.abort()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=part, args=(p,), daemon=True)
                   for p in range(1, size)]
        for t in threads:
            t.start()
        part(0)
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not errors and not any(t.is_alive() for t in threads)
    assert views[3].group is group and views[3].own_lanes(size * 2) == (6, 8)
    for k in range(rounds):
        xs = torch.stack([torch.tensor([p * 1000 + k, k - p]) for p in range(size)])
        want = (xs.sum(0), xs.max(0).values, xs)[k % 3]
        for p in range(size):
            assert torch.equal(got[p][k], want), (p, k)


# ------------------------------------------------- one part: no new ops


class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[func.overloadpacket.__name__] += 1
        return func(*args, **(kwargs or {}))


_HOST_READS = {"_local_scalar_dense", "nonzero", "item"}
# (plan, case, n, params, planes, ticks): the ops and host reads of each
# run's ticks 4 to ``ticks`` on a 4-shard mesh of one part (chunk 4, after
# a warm-up run), counted on the code before the parts of a several-part
# mesh held their own lanes
ONE_PART = {
    "sustained-planes": (("network", "pingpong-sustained", 16,
                          {"duration_ticks": "40", "reshape_every": "16"}, True, 48),
                         (18045, 74)),
    "storm": (("benchmarks", "storm", 16,
               {"conn_outgoing": "3", "conn_delay_ticks": "8", "data_size_kb": "16"},
               False, 12), (2240, 16)),
    "flood": (("benchmarks", "pingpong-flood", 8, {"duration_ticks": "40"}, False, 48),
              (7770, 111)),
}


@pytest.mark.parametrize("name", list(ONE_PART))
def test_a_one_part_mesh_issues_the_ops_and_host_reads_it_did(name):
    (plan, case, n, params, planes, ticks), want = ONE_PART[name]
    groups = build_groups([RunGroup(id="all", instances=n, parameters=params)])
    tc = pexec.instantiate_testcase(pexec.load_sim_testcases(pexec.plan_dir(plan))[case],
                                    groups, 1.0)
    kw = dict(telemetry=True, netmatrix=True,
              trace=build_trace_plan(groups, {"all": {"instances": "0:4"}})) if planes else {}
    prog = SimProgram(tc, groups, chunk=4, device="cpu", mesh=make_mesh("4", device="cpu"),
                      **kw)
    assert not prog.parted
    prog.run(seed=3, max_ticks=4)  # a process's first run builds cached tables
    got = []
    for t in (4, ticks):
        mode = _Count()
        with mode:
            prog.run(seed=3, max_ticks=t)
        got.append((sum(mode.counts.values()),
                    sum(v for k, v in mode.counts.items() if k in _HOST_READS)))
    assert (got[1][0] - got[0][0], got[1][1] - got[0][1]) == want
