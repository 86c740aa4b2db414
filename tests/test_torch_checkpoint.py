"""The port's checkpoint plane (``testground_tpu_torch/sim/checkpoint.py``)
against the reference's (``testground_tpu/sim/checkpoint.py``), on the CPU:

- the archive format: the reference's ``TestSnapshotFormat`` and
  ``TestRestoreValidation`` cases on the port's functions, and a property
  test of the port's save → load with hypothesis (the reference's own fuzz
  tests fail, ROADMAP R3, so the port is held against itself there);
- the acceptance pin across the packages: ``network:ping-pong`` at n = 16,
  chunk 16, cut at tick 48, telemetry and the matrix on, under both
  transports — the port's snapshot leaves equal the reference's leaf for
  leaf, a reference snapshot resumed by the port and a port snapshot
  resumed by the reference each end bit-equal to the uninterrupted run,
  and the two run identities differ only in ``sources`` (so an
  ``execute_sim_run`` resume across the packages refuses, naming it);
- the executor: the reference's ``TestExecutorResume`` and
  ``TestSloStateRoundTrip`` on the port, held against the port's
  uninterrupted run; ``tg run resume`` through the port's CLI;
- zero overhead: with ``checkpoint_chunks = 0`` a run dispatches the same
  ops as without the key, and with it armed it reads the device on the
  host no more often.
"""

import collections
import json
import os
import threading

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from torch.utils._python_dispatch import TorchDispatchMode

import __graft_entry__ as ge
from testground_tpu_torch.api import RunGroup, RunInput
from testground_tpu_torch.api.run_input import OutputsEnv
from testground_tpu_torch.rpc import OutputWriter
from testground_tpu_torch.sim import checkpoint as pck
from testground_tpu_torch.sim.checkpoint import (
    CHECKPOINT_DIR,
    FORMAT_VERSION,
    CheckpointError,
    list_snapshots,
    load_latest,
    load_snapshot,
    prune_snapshots,
    restore_carry,
    save_snapshot,
    snapshot_carry,
)
from testground_tpu_torch.sim.engine import SimProgram, build_groups
from testground_tpu_torch.sim.executor import (
    SimTorchConfig,
    execute_sim_run,
    instantiate_testcase,
    load_sim_testcases,
    plan_dir,
)

REF_PLANS = os.path.join(os.path.dirname(ge.__file__), "plans")
RESULT_KEYS = (
    "status", "finished_at", "ticks", "sync_counts", "pub_dropped",
    "latency_clamped", "bw_queue_dropped", "collisions", "msgs_delivered",
    "msgs_sent", "msgs_enqueued", "msgs_dropped", "msgs_rejected", "cal_depth",
    "faults_crashed", "faults_restarted", "fault_dropped",
)


def port_prog(n=4, chunk=16, telemetry=True, netmatrix=False, case="ping-pong",
              plan="network", params=None):
    groups = build_groups([RunGroup(id="g0", instances=n, parameters=dict(params or {}))])
    tc = instantiate_testcase(load_sim_testcases(plan_dir(plan))[case], groups, 1.0)
    return SimProgram(tc, groups, test_plan=plan, test_case=case, chunk=chunk,
                      telemetry=telemetry, netmatrix=netmatrix, device="cpu")


def _manifest(metas, tick=8, **kw):
    return {"version": FORMAT_VERSION, "tick": tick, "leaves": metas, "aux": {}, **kw}


# ------------------------------------------------------------ file format


@pytest.fixture(scope="module")
def small_leaves():
    """A real port carry's leaves (two key leaves among them)."""
    return snapshot_carry(port_prog(n=2).init_carry(0))


def _format_case(name, tmp_path, leaves, metas):
    if name == "roundtrip-with-keys":
        assert [m["kind"] for m in metas].count("prng") == 2
        path, size, _ = save_snapshot(str(tmp_path), _manifest(metas, tick=32), leaves)
        assert os.path.basename(path) == "ckpt-000000000032.npz"
        assert size == os.path.getsize(path) and size > 0
        m2, leaves2 = load_snapshot(path)
        assert m2["tick"] == 32 and m2["leaves"] == metas
        for a, b in zip(leaves, leaves2):
            assert np.array_equal(a, b) and a.dtype == b.dtype
    elif name == "atomic-and-foreign-files":
        for tick in (64, 16, 48):
            save_snapshot(str(tmp_path), _manifest(metas, tick=tick), leaves)
        d = tmp_path / CHECKPOINT_DIR
        (d / "notes.txt").write_text("x")
        (d / "ckpt-000000000064.npz.tmp-999").write_text("partial")
        assert not [p for p in os.listdir(d) if p.endswith(f".tmp-{os.getpid()}")]
        assert [t for t, _ in list_snapshots(str(tmp_path))] == [16, 48, 64]
    elif name == "retention":
        for tick in (16, 32, 48, 64, 80):
            save_snapshot(str(tmp_path), _manifest(metas, tick=tick), leaves)
        assert prune_snapshots(str(tmp_path), keep=2) == 3
        assert [t for t, _ in list_snapshots(str(tmp_path))] == [64, 80]
    elif name == "truncated":
        path, size, _ = save_snapshot(str(tmp_path), _manifest(metas), leaves)
        with open(path, "r+b") as f:
            f.truncate(size // 2)
        with pytest.raises(CheckpointError, match="corrupt or truncated"):
            load_snapshot(path)
    elif name == "garbage-bytes":
        p = tmp_path / "ckpt-000000000001.npz"
        p.write_bytes(b"this is not a zip archive at all")
        with pytest.raises(CheckpointError):
            load_snapshot(str(p))
    elif name == "no-manifest":
        p = tmp_path / "ckpt-000000000002.npz"
        np.savez(str(p), leaf_00000=np.zeros(3))
        with pytest.raises(CheckpointError, match="no embedded manifest"):
            load_snapshot(str(p))
    elif name == "version-drift":
        path, _, _ = save_snapshot(
            str(tmp_path), _manifest(metas, version=FORMAT_VERSION + 1), leaves)
        with pytest.raises(CheckpointError, match="format version"):
            load_snapshot(path)
    elif name == "missing-leaf":
        extra = metas + [{"kind": "array", "shape": [1], "dtype": "int32"}]
        path, _, _ = save_snapshot(str(tmp_path), _manifest(extra), leaves)
        with pytest.raises(CheckpointError, match="missing carry leaf"):
            load_snapshot(path)
    elif name == "empty-dir":
        with pytest.raises(CheckpointError, match="no snapshots"):
            load_latest(str(tmp_path))
    elif name == "restore-wrong-composition":
        with pytest.raises(CheckpointError, match="refusing to resume"):
            restore_carry(port_prog(n=8), 0, {"leaves": metas}, leaves)
    elif name == "restore-cross-transport-layout":
        # xla keeps flat calendar planes, pallas 2-D rows
        with pytest.raises(CheckpointError):
            restore_carry(port_prog(n=2), 0, {"leaves": metas}, leaves,
                          transport="pallas")
    elif name == "restore-kind-drift":
        bad = [dict(m) for m in metas]
        next(m for m in bad if m["kind"] == "prng")["kind"] = "array"
        with pytest.raises(CheckpointError):
            restore_carry(port_prog(n=2), 0, {"leaves": bad}, leaves)
    else:
        raise AssertionError(name)


FORMAT_CASES = ("roundtrip-with-keys", "atomic-and-foreign-files", "retention",
                "truncated", "garbage-bytes", "no-manifest", "version-drift",
                "missing-leaf", "empty-dir", "restore-wrong-composition",
                "restore-cross-transport-layout", "restore-kind-drift")


@pytest.mark.parametrize("name", FORMAT_CASES)
def test_snapshot_format(name, tmp_path, small_leaves):
    """The reference's ``TestSnapshotFormat`` and ``TestRestoreValidation``
    cases (``tests/test_sim_checkpoint.py:121-290``) on the port."""
    leaves, metas = small_leaves
    _format_case(name, tmp_path, leaves, metas)


_DTYPES = ("int32", "float32", "bool", "uint8")


@st.composite
def _leaf_lists(draw):
    """Random leaf lists: arrays of a few dtypes and key leaves (uint32
    key data with a trailing 2), of shapes with zero-length axes too."""
    leaves, metas = [], []
    for _ in range(draw(st.integers(0, 5))):
        shape = tuple(draw(st.lists(st.integers(0, 4), max_size=3)))
        rng = np.random.default_rng(draw(st.integers(0, 2**16)))
        if draw(st.booleans()):
            data = rng.integers(0, 2**32, size=shape + (2,), dtype=np.uint32)
            metas.append({"kind": "prng", "impl": pck.KEY_IMPL,
                          "shape": list(data.shape), "dtype": "uint32"})
        else:
            dtype = draw(st.sampled_from(_DTYPES))
            data = rng.integers(0, 100, size=shape).astype(dtype)
            metas.append({"kind": "array", "shape": list(data.shape), "dtype": dtype})
        leaves.append(data)
    return leaves, metas


_FUZZ = settings(max_examples=20, deadline=2000,
                 suppress_health_check=[HealthCheck.function_scoped_fixture])


@_FUZZ
@given(case=_leaf_lists(), tick=st.integers(0, 10**6))
def test_save_load_is_the_identity(case, tick, tmp_path):
    leaves, metas = case
    d = tmp_path / f"t{tick}"
    path, _, _ = save_snapshot(str(d), _manifest(metas, tick=tick), leaves)
    m2, got = load_snapshot(path)
    assert m2["tick"] == tick and m2["leaves"] == metas
    assert len(got) == len(leaves)
    for a, b in zip(leaves, got):
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


@_FUZZ
@given(case=_leaf_lists(), frac=st.floats(0.0, 0.999))
def test_truncation_anywhere_refuses_typed(case, frac, tmp_path):
    leaves, metas = case
    d = tmp_path / f"f{frac}"
    path, size, _ = save_snapshot(str(d), _manifest(metas), leaves)
    with open(path, "r+b") as f:
        f.truncate(int(size * frac))
    with pytest.raises(CheckpointError):
        load_snapshot(path)


# --------------------------------------------- across the two packages


CUT = 48
PARAMS = {"latency_ms": "30", "latency2_ms": "20"}


def _jax_prog(transport):
    from testground_tpu.api import RunGroup as JRunGroup
    from testground_tpu.sim.engine import SimProgram as JSimProgram
    from testground_tpu.sim.engine import build_groups as jbuild
    from testground_tpu.sim.executor import load_sim_testcases as jload

    groups = jbuild([JRunGroup(id="g0", instances=16, parameters=dict(PARAMS))])
    tc = jload(os.path.join(REF_PLANS, "network"))["ping-pong"].specialize(
        groups, tick_ms=1.0)()
    return JSimProgram(tc, groups, chunk=16, telemetry=True, netmatrix=True,
                       transport=transport)


def _port_prog():
    return port_prog(n=16, netmatrix=True, params=PARAMS)


def _capture(prog, snap, **kw):
    """Run, keeping the snapshot of the carry at tick CUT and at the end."""
    got = {}

    def obs(ticks, carry):
        got["end"] = snap(carry)
        if ticks == CUT:
            got["cut"] = got["end"]

    res = prog.run(seed=3, observer=obs, **kw)
    return res, got


def _assert_results_equal(a, b, label):
    for key in RESULT_KEYS:
        assert np.array_equal(np.asarray(a[key]), np.asarray(b[key])), (label, key)
    for sa, sb in zip(a["states"], b["states"]):
        assert sorted(sa) == sorted(sb)
        for k in sa:
            assert np.array_equal(np.asarray(sa[k]), np.asarray(sb[k])), (label, k)
    assert a["lat_hist"] == b["lat_hist"] and a["net_matrix"] == b["net_matrix"], label


def _assert_leaves_equal(a, b, label):
    (la, ma), (lb, mb) = a, b
    assert ma == mb, label
    for i, (x, y) in enumerate(zip(la, lb)):
        assert x.dtype == y.dtype and x.shape == y.shape, (label, i)
        assert np.array_equal(x, y), (label, i, ma[i])


@pytest.fixture(scope="module", params=["xla", "pallas"])
def cross(request):
    """Both packages' uninterrupted runs, with their snapshots at the cut
    and at the end, under one transport knob."""
    from testground_tpu.sim.checkpoint import snapshot_carry as jsnap

    tr = request.param
    jres, jgot = _capture(_jax_prog(tr), jsnap, max_ticks=512)
    pres, pgot = _capture(_port_prog(), lambda c: snapshot_carry(c, tr), max_ticks=512)
    assert jres["ticks"] > CUT
    return tr, jres, jgot, pres, pgot


def test_port_snapshot_equals_the_references(cross):
    """(a) leaf for leaf in values, shapes, dtypes and metas — at the cut
    and at the end."""
    tr, jres, jgot, pres, pgot = cross
    _assert_results_equal(jres, pres, tr)
    _assert_leaves_equal(jgot["cut"], pgot["cut"], f"{tr} cut")
    _assert_leaves_equal(jgot["end"], pgot["end"], f"{tr} end")


def test_reference_snapshot_resumes_on_the_port(cross, tmp_path):
    """(b) the reference's archive, read by the port, restored and run on,
    ends bit-equal to the reference's uninterrupted run."""
    from testground_tpu.sim.checkpoint import save_snapshot as jsave

    tr, jres, jgot, _, _ = cross
    leaves, metas = jgot["cut"]
    jsave(str(tmp_path), {"version": 1, "tick": CUT, "leaves": metas, "aux": {},
                          "transport": tr}, leaves)
    manifest, got = load_latest(str(tmp_path))[:2]
    prog = _port_prog()
    carry = restore_carry(prog, 3, manifest, got)
    res, end = _capture(prog, lambda c: snapshot_carry(c, tr), max_ticks=512,
                        resume_carry=carry, resume_ticks=CUT,
                        lat_hist_init=np.asarray(_lat_at_cut(tr)[0]),
                        net_mat_init=np.asarray(_lat_at_cut(tr)[1]))
    _assert_results_equal(jres, res, f"{tr} ref→port")
    _assert_leaves_equal(jgot["end"], end["end"], f"{tr} ref→port end")


def test_port_snapshot_resumes_on_the_reference(cross, tmp_path):
    """(c) the port's archive, read by the reference, restored and run on,
    ends bit-equal to the port's uninterrupted run."""
    from testground_tpu.sim.checkpoint import load_snapshot as jload
    from testground_tpu.sim.checkpoint import restore_carry as jrestore
    from testground_tpu.sim.checkpoint import snapshot_carry as jsnap

    tr, _, _, pres, pgot = cross
    leaves, metas = pgot["cut"]
    path, _, _ = save_snapshot(str(tmp_path), _manifest(metas, tick=CUT, transport=tr),
                               leaves)
    manifest, got = jload(path)
    jprog = _jax_prog(tr)
    carry = jrestore(jprog, 3, manifest, got)
    lat, nm = _lat_at_cut(tr)
    res, end = _capture(jprog, jsnap, max_ticks=512, resume_carry=carry,
                        resume_ticks=CUT, lat_hist_init=lat, net_mat_init=nm)
    _assert_results_equal(pres, res, f"{tr} port→ref")
    _assert_leaves_equal(pgot["end"], end["end"], f"{tr} port→ref end")


def test_meshed_snapshot_is_the_unmeshed_pallas_layout_and_resumes():
    """On a mesh the archive holds the global ``[L, N·SLOTS]`` planes (the
    reference's meshed layout, its pallas one unmeshed), the shards
    joined; restored through the shard split, the meshed run ends as the
    unmeshed one."""
    from testground_tpu_torch.sim.meshplan import make_mesh

    def meshed():
        prog = _port_prog()
        return SimProgram(prog.tc, prog.groups, test_plan="network",
                          test_case="ping-pong", chunk=16, telemetry=True,
                          netmatrix=True, mesh=make_mesh("4", device="cpu"))

    flat_res, flat = _capture(_port_prog(), lambda c: snapshot_carry(c, "pallas"),
                              max_ticks=512)
    mesh_res, mesh = _capture(meshed(), lambda c: snapshot_carry(c, "xla"),
                              max_ticks=CUT)
    _assert_leaves_equal(flat["cut"], mesh["cut"], "mesh cut")
    prog = meshed()
    carry = restore_carry(prog, 3, {"leaves": mesh["cut"][1]}, mesh["cut"][0],
                          transport="xla")
    assert isinstance(carry.cal.payload[0], tuple)  # cut into the shards
    lat, nm = _lat_at_cut("xla")
    res, end = _capture(prog, lambda c: snapshot_carry(c, "xla"), max_ticks=512,
                        resume_carry=carry, resume_ticks=CUT, lat_hist_init=lat,
                        net_mat_init=nm)
    _assert_results_equal(flat_res, res, "mesh resumed")
    _assert_leaves_equal(flat["end"], end["end"], "mesh end")


@pytest.mark.parametrize("shape", ["2x4", "2x2"])
def test_2d_meshed_snapshot_resumes_bit_equal(shape):
    """A solo run on a 2-D mesh snapshots the global planes as a 1-D
    meshed run does, and resumed from its own snapshot on the same mesh it
    ends as the unmeshed run."""
    from testground_tpu_torch.sim.meshplan import make_mesh

    def meshed():
        prog = _port_prog()
        return SimProgram(prog.tc, prog.groups, test_plan="network",
                          test_case="ping-pong", chunk=16, telemetry=True,
                          netmatrix=True, mesh=make_mesh(shape, device="cpu"))

    flat_res, flat = _capture(_port_prog(), lambda c: snapshot_carry(c, "pallas"),
                              max_ticks=512)
    _, mesh = _capture(meshed(), lambda c: snapshot_carry(c, "xla"), max_ticks=CUT)
    _assert_leaves_equal(flat["cut"], mesh["cut"], f"{shape} cut")
    prog = meshed()
    carry = restore_carry(prog, 3, {"leaves": mesh["cut"][1]}, mesh["cut"][0],
                          transport="xla")
    assert isinstance(carry.cal.payload[0], tuple)
    lat, nm = _lat_at_cut("xla")
    res, end = _capture(prog, lambda c: snapshot_carry(c, "xla"), max_ticks=512,
                        resume_carry=carry, resume_ticks=CUT, lat_hist_init=lat,
                        net_mat_init=nm)
    _assert_results_equal(flat_res, res, f"{shape} resumed")
    _assert_leaves_equal(flat["end"], end["end"], f"{shape} end")


_LAT_CACHE: dict = {}


def _lat_at_cut(tr):
    """The host accumulators of the planes at the cut (what a snapshot's
    aux carries), from a port run to the cut."""
    if tr not in _LAT_CACHE:
        res = _port_prog().run(seed=3, max_ticks=CUT)
        _LAT_CACHE[tr] = (np.asarray(res["lat_hist"], np.int64),
                          np.asarray(res["net_matrix"], np.int64))
    return _LAT_CACHE[tr]


def _identity_args(pkg):
    if pkg == "jax":
        from testground_tpu.api import RunGroup as G
        from testground_tpu.api import RunInput as R
        from testground_tpu.sim.checkpoint import run_identity
        from testground_tpu.sim.executor import SimJaxConfig as C

        art = os.path.join(REF_PLANS, "network")
    else:
        G, R, C, run_identity = RunGroup, RunInput, SimTorchConfig, pck.run_identity
        art = plan_dir("network")
    job = R(run_id="r", test_plan="network", test_case="ping-pong", total_instances=16,
            groups=[G(id="g0", instances=16, artifact_path=art, parameters=dict(PARAMS))])
    cfg = C(chunk=16, seed=3)
    kw = dict(telemetry=True, transport="pallas", fault_specs={},
              trace_specs={"": {"instances": "0:2"}}, hosts=("http-echo",), netmatrix=True)
    return run_identity(job, cfg, **kw)


def test_run_identity_matches_the_reference_but_sources():
    """(d) every key but ``sources`` (each package digests its own plan
    copy), so the composition hash is the reference's."""
    from testground_tpu.sim.checkpoint import identity_hash as jhash

    jid, pid = _identity_args("jax"), _identity_args("torch")
    assert set(jid) == set(pid)
    assert {k for k in jid if jid[k] != pid[k]} == {"sources"}
    assert (pck.identity_hash(pid, drop=("sources",))
            == jhash(jid, drop=("sources",)))
    assert pck.identity_hash(pid) != jhash(jid)


def test_executor_resume_across_packages_refuses_naming_sources(tg_home):
    """A reference run's snapshots do not seed a port ``execute_sim_run``:
    the build key digests each package's own plan sources."""
    from testground_tpu.api import RunGroup as JRunGroup
    from testground_tpu.api import RunInput as JRunInput
    from testground_tpu.rpc import OutputWriter as JOutputWriter
    from testground_tpu.sim.executor import SimJaxConfig
    from testground_tpu.sim.executor import execute_sim_run as jexec

    from testground_tpu.config import EnvConfig as JEnvConfig

    jenv = JEnvConfig.load()
    env = OutputsEnv(jenv.dirs.outputs())
    jexec(JRunInput(run_id="ref", test_plan="network", test_case="ping-pong",
                    total_instances=4,
                    groups=[JRunGroup(id="single", instances=4,
                                      artifact_path=os.path.join(REF_PLANS, "network"))],
                    runner_config=SimJaxConfig(chunk=16, max_ticks=32, checkpoint_chunks=1, seed=5,
                                               shard=False),
                    env=jenv), JOutputWriter(sink=None), threading.Event())
    assert list_snapshots(os.path.join(jenv.dirs.outputs(), "network", "ref"))
    with pytest.raises(CheckpointError, match=r"mismatched field\(s\): \['sources'\]"):
        _exec("port", env=env, max_ticks=64, telemetry=False, netmatrix=False,
              resume_from="ref")


# --------------------------------------------------------------- executor


def _exec(run_id, env, cancel=None, **cfg_kw):
    cfg_kw.setdefault("chunk", 16)
    cfg_kw.setdefault("telemetry", True)
    cfg_kw.setdefault("netmatrix", True)
    cfg_kw.setdefault("seed", 5)
    job = RunInput(run_id=run_id, test_plan="network", test_case="ping-pong",
                   total_instances=4,
                   groups=[RunGroup(id="single", instances=4,
                                    artifact_path=plan_dir("network"))],
                   runner_config=SimTorchConfig(device="cpu", **cfg_kw), env=env)
    return execute_sim_run(job, OutputWriter(sink=None), cancel or threading.Event())


def _series_rows(env, run_id, name="sim_timeseries.jsonl"):
    with open(os.path.join(env.dirs.outputs(), "network", run_id, name)) as f:
        return [{k: v for k, v in json.loads(line).items() if k != "run"} for line in f]


@pytest.fixture(scope="module")
def resumed_runs(tmp_path_factory):
    """The uninterrupted run, a run cut at tick 64, its resume into another
    run and its resume in place (a task rehydrated under its own id)."""
    env = OutputsEnv(tmp_path_factory.mktemp("outputs"))
    out = {"env": env,
           "full": _exec("full", env, max_ticks=512, checkpoint_chunks=2),
           "cut": _exec("cut", env, max_ticks=64, checkpoint_chunks=2, checkpoint_keep=2)}
    out["res"] = _exec("res", env, max_ticks=512, checkpoint_chunks=2, resume_from="cut")
    out["auto"] = _exec("cut", env, max_ticks=512, checkpoint_chunks=2)
    return out


def test_cut_wrote_bounded_snapshots_and_journal(resumed_runs):
    env = resumed_runs["env"]
    jc = resumed_runs["cut"].result.journal["sim"]["checkpoint"]
    assert jc["every_chunks"] == 2 and jc["count"] >= 2
    assert jc["last_tick"] == 64 and jc["bytes"] > 0
    assert jc["write_ms"] > 0 and jc["dir"] == CHECKPOINT_DIR and "errors" not in jc
    names = sorted(os.listdir(os.path.join(env.dirs.outputs(), "network", "cut",
                                           CHECKPOINT_DIR)))
    assert all(n.startswith("ckpt-") and n.endswith(".npz") for n in names)
    assert len(names) <= 3


def test_resumed_journal_equals_uninterrupted(resumed_runs):
    jf = resumed_runs["full"].result.journal
    for label in ("res", "auto"):
        jr = resumed_runs[label].result.journal
        for key in ("ticks", "msgs_delivered", "msgs_sent", "msgs_enqueued",
                    "msgs_dropped", "msgs_rejected", "msgs_in_flight", "latency_clamped"):
            assert jr["sim"][key] == jf["sim"][key], (label, key)
        assert jr["sim"].get("latency") == jf["sim"].get("latency")
        assert jr["telemetry"] == jf["telemetry"]
        assert jr["events"] == jf["events"]
        nr, nf = jr["sim"]["net_matrix"], jf["sim"]["net_matrix"]
        for key in ("matrix", "totals", "bytes_total", "mismatches"):
            assert nr[key] == nf[key], (label, key)
        assert nf["mismatches"] == []


@pytest.mark.parametrize("name", ["sim_timeseries.jsonl", "sim_netmatrix.jsonl"])
def test_resumed_stream_is_byte_equal(name, resumed_runs):
    env = resumed_runs["env"]
    rows_full = _series_rows(env, "full", name)
    assert rows_full
    assert _series_rows(env, "res", name) == rows_full
    assert _series_rows(env, "cut", name) == rows_full  # in place


def test_resume_provenance_recorded(resumed_runs):
    jr = resumed_runs["res"].result.journal["sim"]["checkpoint"]
    assert jr["resumed"] == {"from_tick": 64, "from_run": "cut",
                             "snapshot": "ckpt-000000000064.npz"}
    assert resumed_runs["auto"].result.journal["sim"]["checkpoint"]["resumed"][
        "from_run"] == "cut"
    with open(os.path.join(resumed_runs["env"].dirs.outputs(), "network", "res",
                           "run_spans.jsonl")) as f:
        events = [json.loads(ln)["event"] for ln in f]
    points = [e for e in events if e["type"] == "point"
              and e["span"] in ("resume", "checkpoint")]
    assert points[0]["span"] == "resume" and len(points) > 1
    assert points[0]["load_ms"] > 0 and points[0]["restore_ms"] > 0
    assert all(p["d2h_ms"] >= 0 and p["write_ms"] > 0 for p in points[1:])


def test_restart_mid_resume_prefers_own_newer_progress(resumed_runs):
    env = resumed_runs["env"]
    rows_before = _series_rows(env, "res")
    out = _exec("res", env, max_ticks=512, checkpoint_chunks=2, resume_from="cut")
    ck = out.result.journal["sim"]["checkpoint"]
    assert ck["resumed"]["from_run"] == "res" and ck["resumed"]["from_tick"] > 64
    jf = resumed_runs["full"].result.journal
    for key in ("msgs_delivered", "msgs_sent", "msgs_enqueued"):
        assert out.result.journal["sim"][key] == jf["sim"][key]
    assert _series_rows(env, "res") == rows_before


def test_stats_table_and_prometheus_surface(resumed_runs):
    from testground_tpu_torch.engine.task import DatedState, State, Task, TaskType
    from testground_tpu_torch.metrics.prometheus import render_prometheus
    from testground_tpu_torch.runners.pretty import render_telemetry_summary

    t = Task(id="res", type=TaskType.RUN, plan="network", case="ping-pong",
             states=[DatedState(state=State.COMPLETE, created=0.0)],
             result=resumed_runs["res"].result.to_dict())
    table = render_telemetry_summary(t.stats_payload())
    assert "checkpoint" in table and "resumed from tick 64 of run cut" in table
    text = render_prometheus([t], per_task_limit=10)
    for gauge in ("tg_checkpoint_count{", "tg_checkpoint_last_tick{",
                  "tg_checkpoint_bytes{", "tg_checkpoint_write_ms{"):
        assert gauge in text, gauge


def test_artifact_whitelist_serves_snapshots_only_safely():
    from testground_tpu.daemon.server import _Handler as JHandler
    from testground_tpu_torch.daemon.server import _Handler

    for name in ("checkpoints/ckpt-000000000064.npz", "checkpoints/../secrets.npz",
                 "checkpoints/evil.npz", "checkpoints/ckpt-1/extra.npz",
                 "ckpt-000000000064.npz"):
        assert _Handler._artifact_relpath(name) == JHandler._artifact_relpath(name), name
    assert _Handler._artifact_relpath("checkpoints/ckpt-000000000064.npz") == \
        os.path.join("checkpoints", "ckpt-000000000064.npz")


def test_resume_from_unknown_run_refuses(resumed_runs):
    with pytest.raises(CheckpointError, match="nothing to resume"):
        _exec("res-none", resumed_runs["env"], max_ticks=64, resume_from="no-such-run")


def test_identity_mismatch_refuses(resumed_runs):
    with pytest.raises(CheckpointError, match=r"different run identity.*'seed'"):
        _exec("res-seed", resumed_runs["env"], max_ticks=512, resume_from="cut", seed=6)


def test_corrupted_snapshot_fallback_then_refusal(resumed_runs, monkeypatch):
    """Last of the module's uses of the cut run: it damages its snapshots.
    A corrupt newest snapshot falls back loudly to the one before; only
    when every snapshot is unloadable does the resume refuse."""
    monkeypatch.setattr(pck, "_RETRY_BASE_SECS", 0.001)
    monkeypatch.setattr(pck, "_RETRY_JITTER_SECS", 0.0)
    env = resumed_runs["env"]
    ckpt_dir = os.path.join(env.dirs.outputs(), "network", "cut", CHECKPOINT_DIR)
    names = sorted(os.listdir(ckpt_dir))
    assert len(names) >= 2
    newest = os.path.join(ckpt_dir, names[-1])
    with open(newest, "r+b") as f:
        f.truncate(os.path.getsize(newest) // 3)
    out = _exec("res-fb", env, max_ticks=512, resume_from="cut")
    ck = out.result.journal["sim"]["checkpoint"]
    fb = ck["resumed"]["fallback"]
    assert fb["skipped"] == [names[-1]] and fb["error"]
    assert ck["resumed"]["from_tick"] < int(names[-1][len("ckpt-"):-len(".npz")])
    full = resumed_runs["full"].result.journal["sim"]
    for key in ("ticks", "msgs_delivered", "msgs_sent"):
        assert out.result.journal["sim"][key] == full[key]
    for name in os.listdir(ckpt_dir):
        path = os.path.join(ckpt_dir, name)
        with open(path, "r+b") as f:
            f.truncate(os.path.getsize(path) // 3)
    with pytest.raises(CheckpointError, match="refusing to resume"):
        _exec("res-bad", env, max_ticks=512, resume_from="cut")


def test_slo_evaluator_state_roundtrips_exactly():
    """``TestSloStateRoundTrip`` on the port's evaluator."""
    from testground_tpu_torch.sim.slo import SloEvaluator, build_slo_plan

    groups = build_groups([RunGroup(id="g0", instances=4)])
    plan = build_slo_plan(groups, {"": [{"name": "rate", "metric": "delivered_per_tick",
                                          "op": ">=", "threshold": 1e9,
                                          "window_ticks": 32}]})
    ev = SloEvaluator(plan, groups, 1.0, 16)
    for tick0 in (0, 16, 32):
        ev.on_rows([{"tick": tick0 + i, "delivered": 3, "sent": 4} for i in range(16)])
        ev.evaluate()
    state = ev.state_dict()
    assert json.loads(json.dumps(state)) == state
    ev2 = SloEvaluator(plan, groups, 1.0, 16)
    ev2.load_state(state)
    assert ev2.journal() == ev.journal()
    for e in (ev, ev2):
        e.on_rows([{"tick": 48 + i, "delivered": 3, "sent": 4} for i in range(16)])
        e.evaluate()
    assert ev2.journal() == ev.journal()


def test_resumed_slo_and_trace_streams_are_byte_equal(tmp_path):
    """The SLO evaluator and the flight recorder continue across a resume:
    ``sim_slo.jsonl``, ``sim_trace.jsonl`` and the journal's ``slo`` and
    ``trace`` blocks equal the uninterrupted run's."""
    env = OutputsEnv(tmp_path)

    def run(rid, **kw):
        job = RunInput(run_id=rid, test_plan="network", test_case="ping-pong",
                       total_instances=4,
                       groups=[RunGroup(id="single", instances=4,
                                        artifact_path=plan_dir("network"),
                                        trace={"instances": "0:2"})],
                       slo=[{"name": "rate", "metric": "delivered_per_tick", "op": ">=",
                             "threshold": 1e9, "window_ticks": 32}],
                       runner_config=SimTorchConfig(device="cpu", chunk=16, seed=5,
                                                    telemetry=True, **kw), env=env)
        return execute_sim_run(job, OutputWriter(sink=None), threading.Event())

    full = run("full", max_ticks=512)
    run("cut", max_ticks=64, checkpoint_chunks=1)
    res = run("res", max_ticks=512, resume_from="cut")
    for block in ("slo", "trace"):
        assert res.result.journal[block] == full.result.journal[block], block
    for name in ("sim_slo.jsonl", "sim_trace.jsonl"):
        assert _series_rows(env, "res", name) == _series_rows(env, "full", name), name


# -------------------------------------------------------------- tg resume


def test_run_resume_continues_a_checkpointed_task(tg_home, capsys):
    from testground_tpu_torch.cli.main import main

    with open(tg_home / ".env.toml", "w") as f:
        f.write('[runners."sim:torch"]\ndevice = "cpu"\n')
    assert main(["plan", "import", "--from", plan_dir("network")]) == 0
    rc = main(["run", "single", "network:ping-pong", "-i", "4",
               "--run-cfg", "checkpoint_chunks=1", "--run-cfg", "chunk=16",
               "--run-cfg", "max_ticks=48", "--run-cfg", "telemetry=true"])
    out = capsys.readouterr().out
    task_id = out.split("run is queued with ID:")[1].split()[0].strip()
    assert rc == 1  # incomplete instances: FAILURE, by design
    assert main(["run", "resume", task_id, "--run-cfg", "max_ticks=512"]) == 0
    out2 = capsys.readouterr().out
    assert f"resuming task {task_id}" in out2 and "(outcome: success)" in out2


def test_run_resume_refuses_a_multi_runs_composition(monkeypatch, capsys):
    import time as _time

    from testground_tpu_torch.api import (
        Composition,
        Global,
        Group,
        Instances,
        generate_default_run,
    )
    from testground_tpu_torch.cli import commands
    from testground_tpu_torch.cli.main import main
    from testground_tpu_torch.engine.task import DatedState, State, Task, TaskType

    comp = generate_default_run(Composition(
        global_=Global(plan="network", case="ping-pong", builder="sim:plan",
                       runner="sim:torch"),
        groups=[Group(id="all", instances=Instances(count=2))]))
    d = comp.to_dict()
    d["runs"] = d["runs"] + [{**d["runs"][0], "id": "second"}]
    tsk = Task(id="multi1", type=TaskType.RUN, plan="network", case="ping-pong",
               states=[DatedState(state=State.COMPLETE, created=_time.time())],
               composition=d)

    class _Stub:
        def get_task(self, tid):
            return tsk if tid == "multi1" else None

        def stop(self):
            pass

    monkeypatch.setattr(commands, "_engine", lambda args: _Stub())
    assert main(["run", "resume", "multi1"]) == 1
    err = capsys.readouterr().err
    assert "multi-[[runs]]" in err and "--run-ids" in err and "multi1-" in err


# ---------------------------------------------------------- zero overhead


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[func.overloadpacket.__name__] += 1
        return func(*args, **(kwargs or {}))


_HOST_READS = {"_local_scalar_dense", "nonzero", "item"}


def test_zero_overhead_when_off(tmp_path):
    """With ``checkpoint_chunks = 0`` a run dispatches exactly the ops of a
    run without the key; armed, the snapshot adds no host read of a device
    value (the reference's pin is its jaxpr and its done-poll count)."""
    env = OutputsEnv(tmp_path)
    counts = {}
    for label, kw in (("absent", {}), ("zero", {"checkpoint_chunks": 0}),
                      ("armed", {"checkpoint_chunks": 1})):
        mode = _CountOps()
        with mode:
            _exec(label, env, max_ticks=128, **kw)
        counts[label] = mode.counts
    assert counts["zero"] == counts["absent"]
    reads = {k: {op: c.get(op, 0) for op in _HOST_READS} for k, c in counts.items()}
    assert reads["armed"] == reads["absent"]
    assert not list_snapshots(str(tmp_path / "network" / "zero"))
    assert list_snapshots(str(tmp_path / "network" / "armed"))


def test_key_impl_is_the_references():
    import jax

    assert pck.KEY_IMPL == str(jax.random.key_impl(jax.random.key(0)))
    assert torch.__version__  # the manifest's version key
