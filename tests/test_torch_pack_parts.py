"""A run pack placed over a mesh of several parts (``sim/pack.py``
``PackRunner`` on a mesh whose ``parts`` are several, ``sim/meshplan.py``
``pack_parts``, ``sim/net.py`` ``RunLanes``, ``sim/sync_kernel.py``'s
per-run fold over the parts) on the CPU, every part on the CPU:

- the owners: ``pack_parts`` and ``pack_owners`` on each layout, and the
  run lead's lane axis and partition specs (the reference's answers);
- the placed layouts — ``"4"`` cut into four parts, ``"2x4"`` (its two
  rows), ``"2x4"`` cut into four (two a row), uneven parts (``"4"`` cut
  1+3), a row of dead dummies (``"2x2"``, two members at width 4),
  ``"4x1"`` (two members: two rows hold none) and members whose lanes do
  not divide across the peer shards (the solo meshed run's dead lanes) —
  exact and bucketed, with telemetry (ping-pong, and a plan whose members
  finish at their seed's tick): every member equals the one-part
  pack's member and the port's isolated run (status, finished_at, every
  state leaf, the flow totals, the sync counters, the telemetry rows and
  the histogram), and on one layout the reference's isolated exact-N run
  (ROADMAP R1, R2: never its packed or bucketed runs); with stragglers, a
  member's own budget and a cancel, each member freezes where its one-part
  pack's and its isolated run's do;
- placement: each part holds its members' own lanes of every placed leaf
  and its own calendar sub-shards, nothing of another part's, and a
  replica of every run-axis leaf; its bytes are the replicated plus its
  placed bytes, as ``part_bytes_estimate`` predicts;
- a pack of one part issues the ops and host reads a tick it did before
  packs were placed (counted on that code);
- a failure forced in part 1 fails every member of the pack readably and
  leaves no part thread behind;
- ``execute_packed_sim_runs`` on explicit parts: each member's journal
  carries the reference's ``sim.mesh`` block and equals its one-part
  pack's.
"""

import collections
import io
import json
import threading

import numpy as np
import pytest
import torch
from test_torch_pack import (
    PACKABLE,
    SEEDS,
    _assert_member_equal,
    _program,
    _record,
    _ref_exact,
    _SeedClock,
    _shared,
    shared_runs,  # noqa: F401 — the runs below shared across workers
)
from torch.utils._python_dispatch import TorchDispatchMode

from testground_tpu.sim import meshplan as jmp
from testground_tpu_torch.api import OutputsEnv, RunGroup, RunInput
from testground_tpu_torch.rpc import OutputWriter
from testground_tpu_torch.sim import buckets as pb
from testground_tpu_torch.sim import executor as pexec
from testground_tpu_torch.sim import meshplan as pmp
from testground_tpu_torch.sim.engine import SimProgram, build_groups, carry_bytes
from testground_tpu_torch.sim.pack import (
    _LANE_LEAVES,
    _RUN_LEAVES,
    PackMember,
    PackRunner,
    _get,
)

CPU = torch.device("cpu")


def cut(shape, cuts=()):
    """``shape`` on the CPU, each row cut at ``cuts`` (its cells)."""
    dims = pmp.parse_mesh_shape(shape)
    rows, p = (1, dims[0]) if len(dims) == 1 else dims
    bounds = (0, *cuts, p)
    parts = tuple((CPU, g * p + a, g * p + b) for g in range(rows)
                  for a, b in zip(bounds, bounds[1:]))
    return pmp.TorchMesh((CPU,) * (rows * p), parts=parts,
                         runs=None if len(dims) == 1 else rows)


# name: (mesh, members, width, the parts' (row, first, runs, s0, s1))
LAYOUTS = {
    "4-cut-4": (lambda: cut("4", (1, 2, 3)), 3, 4,
                [(0, 0, 4, s, s + 1) for s in range(4)]),
    "2x4": (lambda: pmp.make_mesh("2x4", device="cpu"), 3, 4,
            [(0, 0, 2, 0, 4), (1, 2, 2, 0, 4)]),
    "2x4-cut-4": (lambda: cut("2x4", (2,)), 3, 4,
                  [(0, 0, 2, 0, 2), (0, 0, 2, 2, 4), (1, 2, 2, 0, 2), (1, 2, 2, 2, 4)]),
    "4-cut-1+3": (lambda: cut("4", (1,)), 3, 4, [(0, 0, 4, 0, 1), (0, 0, 4, 1, 4)]),
    "2x2-dummy-row": (lambda: pmp.make_mesh("2x2", device="cpu"), 2, 4,
                      [(0, 0, 2, 0, 2), (1, 2, 2, 0, 2)]),
    "4x1": (lambda: pmp.make_mesh("4x1", device="cpu"), 2, 2,
            [(0, 0, 1, 0, 1), (1, 1, 1, 0, 1)]),
}
MODES = ("exact", "bucketed")
# ping-pong at 8 instances: the members' exact counts, one rung of 8
SIZES = {"exact": (8, 8, 8), "bucketed": (8, 7, 5)}
RUNG = (8,)
LABEL = "ping-pong"


# ------------------------------------------------------------- owners


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_pack_parts_name_each_parts_members_and_shards(name):
    mesh_of, members, width, want = LAYOUTS[name]
    mesh = mesh_of()
    parts = pmp.pack_parts(mesh, width)
    assert [(q.row, q.first, q.runs, q.s0, q.s1) for q in parts] == want
    owners = pmp.pack_owners(parts, width, mesh.shards)
    for i, q in enumerate(parts):
        for r in range(q.first, q.first + q.runs):
            assert owners[r][q.s0 : q.s1] == [i] * (q.s1 - q.s0)
    # every (member, peer shard) has exactly one owner
    assert all(o >= 0 for row in owners for o in row)
    runner = PackRunner(_program("torch", LABEL, 8), width, mesh=mesh)
    assert runner.placed and len(runner.cal_mesh.parts) == len(parts)


def test_the_run_leads_lane_axis_and_specs():
    """Under the run lead a stacked plan state's lanes move one axis in;
    the lane rows lay the members side by side on their own axis; the
    specs are the reference's."""
    pplan = pmp.MeshPlan(pmp.make_mesh("2x4", device="cpu"))
    jplan = jmp.MeshPlan(jmp.make_mesh("2x4"))
    want = {"status": 0, "link.egress": 1, "link.rules": 2, "keys": 0,
            "sync.last_seq": 1, "sync.cursors": 1, "states.0.x": 1, "sync.counts": None,
            "sync.stream": None, "msgs_sent": None, "lat_hist": None}
    for path, axis in want.items():
        assert pplan.lane_axis(path, lead="runs") == axis, path
        assert tuple(pplan.spec_for(path, lead="runs")) == tuple(
            jplan.spec_for(path, lead="runs")), path
    assert pplan.lane_axis("states.0.x") == 0
    # the pack splits exactly the leaves the plan places, on their axis,
    # and stacks the others on its run axis but the tick and the link key
    # (which stays on the host)
    from testground_tpu_torch.sim.checkpoint import leaf_paths

    carry = _program("torch", LABEL, 8).init_carry(0)
    paths = [p for p in leaf_paths(carry) if not p.startswith(("cal.", "states."))]
    placed = {p: pplan.lane_axis(p) for p in paths if pplan.lane_axis(p) is not None}
    assert placed == {p: a % _get(carry, p).dim() for p, a in _LANE_LEAVES
                      if _get(carry, p) is not None}
    assert set(paths) - set(placed) == {f for f in _RUN_LEAVES
                                         if _get(carry, f) is not None} | {"t", "net_key"}


# -------------------------------------------------------- the placed pin


def _ping_pong(mode, members):
    """The program and the members' live counts (None exact) of
    ``members`` ping-pong runs."""
    sizes = SIZES[mode][:members]
    if mode == "exact":
        return _program("torch", LABEL, sizes[0]), [None] * members
    plans = [pb.plan_buckets([n], "auto", RUNG) for n in sizes]
    return (_program("torch", LABEL, plans[0].padded_n, live=plans[0].live_counts),
            [p.live_counts for p in plans])


def _pack(mode, name):
    """Ping-pong's pack on layout ``name`` (None: the one-part pack of its
    members and width), once per test run: results, telemetry blocks per
    member, each part's bytes and their estimate."""
    members, width = (LAYOUTS[name][1:3] if name in LAYOUTS else name)

    def make():
        prog, lcs = _ping_pong(mode, members)
        tele = [[] for _ in range(members)]
        ms = [PackMember(seed=s, live_counts=lc, max_ticks=PACKABLE[LABEL][4],
                         telemetry_cb=lambda b, i=i: tele[i].append(np.asarray(b).copy()))
              for i, (s, lc) in enumerate(zip(SEEDS, lcs))]
        runner = PackRunner(prog, width,
                            mesh=LAYOUTS[name][0]() if name in LAYOUTS else None)
        res = runner.run(ms)
        return res, tele, runner.last_part_bytes, runner.part_bytes_estimate(
            prog.init_carry(0))

    return _shared(("parts-pack", mode, name), make)


def _isolated(mode, i):
    def make():
        prog, lcs = _ping_pong(mode, i + 1)
        if lcs[i] is not None:
            prog = _program("torch", LABEL, prog.n, live=lcs[i])
        return _record(prog, SEEDS[i], PACKABLE[LABEL][4])

    return _shared(("parts-iso", mode, i), make)


PIN = [(name, mode) for name in LAYOUTS for mode in MODES]


@pytest.mark.parametrize("name,mode", PIN, ids=[f"{n}-{m}" for n, m in PIN])
def test_placed_members_equal_the_one_part_pack_and_the_isolated_run(name, mode):
    members, width = LAYOUTS[name][1:3]
    placed, tele, part_bytes, estimate = _pack(mode, name)
    one, tele_one, one_bytes, _ = _pack(mode, (members, width))
    for i in range(members):
        _assert_member_equal((one[i], tele_one[i]), (placed[i], tele[i]),
                             f"{name} member {i} vs the one-part pack")
        _assert_member_equal(_isolated(mode, i), (placed[i], tele[i]),
                             f"{name} member {i} vs port")
    assert part_bytes == estimate and len(part_bytes) == len(LAYOUTS[name][3])
    assert len(one_bytes) == 1


# -------------------------------------------- stragglers, budgets, cancels


def _clock_prog(n, live=None, lane_multiple=1):
    groups = build_groups([RunGroup(id="all", instances=n)])
    return SimProgram(_SeedClock(), groups, chunk=8, telemetry=True, device="cpu",
                      live_counts=live, lane_multiple=lane_multiple)


# a natural finisher, one whose own budget ends after two chunks, one
# canceled at the second boundary, another natural finisher
SPECS = (("natural", 0), ("budget", 6), ("cancel", 1), ("natural", 5))


def _members(k, counts, tele):
    out = []
    for i, (kind, seed) in enumerate(SPECS[:k]):
        calls = {"n": 0}

        def cancel(calls=calls):
            calls["n"] += 1
            return calls["n"] >= 2

        out.append(PackMember(
            seed=seed, max_ticks=16 if kind == "budget" else 256,
            live_counts=None if counts is None else (counts[i],),
            cancel_check=cancel if kind == "cancel" else None,
            telemetry_cb=lambda b, i=i: tele[i].append(np.asarray(b).copy())))
    return out


STRAGGLERS = [(name, mode) for name in (*LAYOUTS, "2x4-6-lanes", "4-cut-4-6-lanes")
              for mode in MODES]


def _clock_pack(n, mode, k, width, mesh):
    """``k`` members of ``SPECS`` on ``_SeedClock`` at ``n`` instances:
    the pack's results, telemetry blocks and members."""
    counts = None if mode == "exact" else (n, n - 1, n - 2, n - 3)
    prog = _clock_prog(n, live=None if counts is None else (n,), lane_multiple=4)
    tele = [[] for _ in range(k)]
    members = _members(k, counts, tele)
    res = PackRunner(prog, width, mesh=mesh).run(members)
    return res, tele, [(m.seed, m.ticks, m.done, m.canceled, m.live_counts)
                       for m in members]


@pytest.mark.parametrize("name,mode", STRAGGLERS, ids=[f"{n}-{m}" for n, m in STRAGGLERS])
def test_placed_stragglers_budgets_and_cancels(name, mode):
    """Members that finish apart, one whose own budget ends first and one
    canceled at a boundary: each equals its one-part pack's member and its
    isolated run with the budget it stopped at."""
    n = 6 if name.endswith("-6-lanes") else 8
    mesh_of, members, width, _ = LAYOUTS[name.replace("-6-lanes", "")]
    k = 2 if members == 2 else min(4, width)
    placed, tele, got = _clock_pack(n, mode, k, width, mesh_of())
    one, tele_one, _ = _shared(("parts-clock", n, mode, k, width),
                               lambda: _clock_pack(n, mode, k, width, None))
    for i, (seed, ticks, _, _, live) in enumerate(got):
        _assert_member_equal((one[i], tele_one[i]), (placed[i], tele[i]),
                             f"{name} member {i} vs the one-part pack")
        iso = _shared(("parts-clock-iso", n, seed, ticks, live),
                      lambda: _record(_clock_prog(n, live=live), seed, ticks))
        _assert_member_equal(iso, (placed[i], tele[i]), f"{name} member {i} vs port",
                             same_layout=live is None)
    kinds = [kind for kind, _ in SPECS[:k]]
    assert [m[2] for m in got] == [kind == "natural" for kind in kinds]
    assert [m[3] for m in got] == [kind == "cancel" for kind in kinds]
    assert all(m[1] == 16 for m, kind in zip(got, kinds) if kind != "natural")


# ------------------------------------------------------------ placement


@pytest.mark.parametrize("name", ["2x4-cut-4", "4-cut-1+3"])
def test_each_part_holds_its_own_block_and_the_replicas(name):
    """At tick 0 (and by the bytes after a run): each part's lane leaves are
    its members' own lanes, member-major, equal to the one-part pack's; its
    plan states its own spans of its members' groups; its calendar its own
    sub-shards only; every run-axis leaf a whole replica; its bytes the
    replicated plus its own placed bytes, as estimated."""
    mesh_of, members, width, _ = LAYOUTS[name]
    prog, lcs = _ping_pong("bucketed", members)
    runner = PackRunner(prog, width, mesh=mesh_of())
    one = PackRunner(prog, width)
    lcs = lcs + [lcs[0]] * (width - members)
    seeds = list(SEEDS[:members]) + [0] * (width - members)
    live = [True] * members + [False] * (width - members)
    mprogs = [runner._member_program(lc) for lc in lcs]
    lays = runner._part_layouts(mprogs)
    carries, _, _ = runner._init_placed(lays, mprogs, seeds, live)
    whole, _ = one._init(mprogs, seeds, live)
    n, w, n_loc = runner.n, width, runner.n_loc
    placed_total = 0
    estimate = runner.part_bytes_estimate(prog.init_carry(0))
    for q, lay, c, est in zip(runner.parts, lays, carries, estimate):
        lo, hi = q.s0 * n_loc, q.s1 * n_loc
        mine = slice(q.first, q.first + q.runs)
        placed = 0
        for path, axis in _LANE_LEAVES:
            got, full = _get(c, path), _get(whole, path)
            if full is None:
                assert got is None
                continue
            full = full.movedim(axis, -1)
            want = full.reshape(*full.shape[:-1], w, n)[..., mine, lo:hi]
            want = want.reshape(*full.shape[:-1], q.runs * (hi - lo)).movedim(-1, axis)
            assert got.device == CPU and torch.equal(got, want), (name, q, path)
            placed += got.numel() * got.element_size()
        for g, (st, sp) in enumerate(zip(c.states, lay.view._gown)):
            for key, v in st.items():
                want = whole.states[g][key][mine, sp.start : sp.start + sp.count]
                assert torch.equal(v, want), (name, q, key)
                placed += v.numel() * v.element_size()
        planes = [p for p in (c.cal.src, c.cal.valid, c.cal.etick, *c.cal.payload)
                  if p is not None]
        for p in planes:
            assert len(p) == 1 and p[0].shape[0] == q.runs * (q.s1 - q.s0)
            assert p[0].shape[-1] == c.cal.slots * n_loc
            placed += p[0].numel() * p[0].element_size()
        replicated = c.t.numel() * c.t.element_size()
        for f in _RUN_LEAVES:
            got, full = _get(c, f), _get(whole, f)
            if full is not None:
                assert torch.equal(got, full), (name, f)
                replicated += got.numel() * got.element_size()
        assert carry_bytes(c) == replicated + placed == est, (name, q)
        placed_total += placed
    # no lane is held twice: the parts' placed bytes are the pack's
    assert placed_total == carry_bytes(whole) - replicated


# -------------------------------------------------- one part: no new ops


class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[func.overloadpacket.__name__] += 1
        return func(*args, **(kwargs or {}))


_HOST_READS = {"_local_scalar_dense", "nonzero", "item"}
# (label, bucketed, mesh): the ops and host reads of ticks 4 to 16 of a
# pack of three members at width 4 (chunk 4), counted on the code before
# packs were placed over a mesh's parts
ONE_PART = {
    "sustained-bucketed-unmeshed": (("sustained", True, None), (6165, 12)),
    "collisions-on-2": (("collisions", False, "2"), (4209, 24)),
}


@pytest.mark.parametrize("name", list(ONE_PART))
def test_a_one_part_pack_issues_the_ops_and_host_reads_it_did(name):
    from test_torch_pack import INLINE, LADDER, PACKABLE, _sizes

    from testground_tpu_torch.sim.executor import (
        instantiate_testcase,
        load_sim_testcases,
        plan_dir,
    )

    (label, bucketed, mesh), want = ONE_PART[name]
    plan, case, n, params, _, _, kw = PACKABLE[label]
    lcs = [None] * 3
    if bucketed:
        plans = [pb.plan_buckets([m], "auto", LADDER) for m in _sizes(label, True)]
        n, lcs = plans[0].padded_n, [p.live_counts for p in plans]
    groups = build_groups([RunGroup(id="all", instances=n, parameters=dict(params))])
    tc = INLINE[case][1]()() if plan is None else instantiate_testcase(
        load_sim_testcases(plan_dir(plan))[case], groups, 1.0)
    prog = SimProgram(tc, groups, chunk=4, telemetry=True, device="cpu",
                      live_counts=lcs[0], **kw)

    def run(ticks):
        runner = PackRunner(prog, 4, mesh=None if mesh is None
                            else pmp.make_mesh(mesh, device="cpu"))
        assert not runner.placed
        runner.run([PackMember(seed=s, live_counts=lc, max_ticks=ticks)
                    for s, lc in zip((3, 7, 11), lcs)])

    run(4)  # a process's first run builds cached tables
    got = []
    for ticks in (4, 16):
        mode = _Count()
        with mode:
            run(ticks)
        got.append((sum(mode.counts.values()),
                    sum(v for k, v in mode.counts.items() if k in _HOST_READS)))
    assert (got[1][0] - got[0][0], got[1][1] - got[0][1]) == want


# ------------------------------------------------------ failure, executor


def _jobs(tmp_path, sizes=(5, 9, 13)):
    return [RunInput(
        groups=[RunGroup(id="all", instances=n, artifact_path=pexec.plan_dir("network"))],
        env=OutputsEnv(tmp_path), run_id=f"member-{i}", test_plan="network",
        test_case="ping-pong", total_instances=n,
        runner_config=pexec.SimTorchConfig(
            device="cpu", seed=i, pack=True, bucket="auto", bucket_ladder="16",
            telemetry=True, chunk=16, max_ticks=64, mesh="4"))
        for i, n in enumerate(sizes)]


def _execute(tmp_path, monkeypatch, mesh):
    real = pexec._make_mesh
    monkeypatch.setattr(pexec, "_make_mesh", lambda *a: real(*a) if mesh is None else mesh)
    jobs = _jobs(tmp_path)
    ows = [OutputWriter(None, echo=io.StringIO()) for _ in jobs]
    return pexec.execute_packed_sim_runs(jobs, ows, [threading.Event() for _ in jobs])


def test_execute_packed_sim_runs_on_explicit_parts(tmp_path, monkeypatch):
    """``mesh = "4"`` cut into two parts: the pack is placed, each member's
    journal carries the reference's ``sim.mesh`` block (the layout's, as
    the reference journals ``"4"``) and equals the one-part pack's."""
    from testground_tpu.sim import executor as jexec
    from testground_tpu.sim.engine import build_groups as jbuild
    from testground_tpu.api import RunGroup as JRunGroup
    from test_torch_plans import _ref_plan

    placed = _execute(tmp_path / "parts", monkeypatch, cut("4", (2,)))
    one = _execute(tmp_path / "one", monkeypatch, None)
    jgroups = jbuild([JRunGroup(id="all", instances=16)])
    jtc = jexec.instantiate_testcase(
        jexec.load_sim_testcases(_ref_plan("network"))["ping-pong"], jgroups, 1.0)
    want = jexec._mesh_journal_block(jmp.make_mesh("4"), jtc, jgroups, ())
    for p, o in zip(placed, one):
        assert not isinstance(p, Exception), p
        ps, os_ = p.result.journal["sim"], o.result.journal["sim"]
        assert ps["mesh"] == os_["mesh"] == json.loads(json.dumps(want))
        for key in [k for k in os_ if k.startswith("msgs_")] + ["ticks", "latency"]:
            assert ps[key] == os_[key], key
        assert p.result.journal["telemetry"] == o.result.journal["telemetry"]
        assert p.result.journal["events"] == o.result.journal["events"]


def test_a_failure_in_part_one_fails_every_member_readably(tmp_path, monkeypatch):
    real = PackRunner._tick
    seen = collections.Counter()

    def tick(self, lay, *a, **k):
        seen[lay.part] += 1
        if lay.part == 1 and seen[1] == 3:
            raise RuntimeError("part 1 broke at its third tick")
        return real(self, lay, *a, **k)

    monkeypatch.setattr(PackRunner, "_tick", tick)
    with pytest.raises(RuntimeError, match="part 1 broke at its third tick"):
        _execute(tmp_path, monkeypatch, cut("4", (2,)))
    assert not [t for t in threading.enumerate() if t.name.startswith("sim-part-")]
    for i in range(3):
        spans = (tmp_path / "network" / f"member-{i}" / "run_spans.jsonl").read_text()
        run_end = [e for e in (json.loads(x)["event"] for x in spans.splitlines())
                   if e["type"] == "span_end" and e["span"] == "run"]
        assert run_end[-1]["outcome"] == "error"
        assert "part 1 broke at its third tick" in run_end[-1]["error"]
    # the parts ran on: part 0 reached its third tick, part 1's third raised
    assert seen[0] >= 3 and seen[1] == 3


# ------------------------------------------------------------ reference



@pytest.mark.parametrize("mode", MODES)
def test_placed_members_equal_the_references_exact_run(mode):
    placed, tele, _, _ = _pack(mode, "2x4-cut-4")
    for i, n in enumerate(SIZES[mode]):
        ref = _ref_exact(LABEL, n, SEEDS[i])
        _assert_member_equal(ref, (placed[i], tele[i]), f"member {i} vs jax",
                             same_layout=mode == "exact")
