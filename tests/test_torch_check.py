"""Layer 1 of the port's rules engine (``testground_tpu_torch/sim/check.py``)
against the JAX package's (``testground_tpu/sim/check.py``), on the CPU.
Each composition is built once for each package, with runner ``sim:jax``
for the reference and ``sim:torch`` for the port:

- the catalog: the reference's rule ids, layers and summaries, and no
  other (the port's own ``port.not-ported`` went with the last refused
  settings, the cohort's);
- a matrix of bad compositions, one case each, and a clean one: the same
  findings (rule, severity, message, run) in both packages —
  ``run-cfg.unknown-key`` by its rule and key, since its message names
  each package's runner and options;
- each divergence the module docstring lists, by the port's finding;
- no drift: the port's checker reports an error exactly when the port's
  ``execute_sim_run`` (``device="cpu"``) refuses the composition, with the
  refusal's text among the errors, over the matrix, the settings that
  were refused until they were ported (the cohort's among them), a 2-D
  mesh and the indivisible lanes;
- ``tg check``: both CLIs give the same exit codes, lines (paths aside)
  and ``--json`` document, with ``--trace-plans`` too (the plan layer);
- the plan layer (layers 2 and 3, on the meta device): one fixture plan
  a rule fires its own rule, each naming the plan's file and line; the
  memory rule carries the executor's refusal word for word; every plan
  case of the port's plans is clean; and every tensor the layer made is
  on the meta device (the host's key split and index lists aside), with
  the lint's ``sys.monitoring`` hook gone after it.
"""

import json
import os
import socket
import sys
import threading

import pytest

from test_torch_cli import PORT_ENV, REF_ENV, _cli, _make_home, jmain, pmain
from test_torch_executor import REF_PLANS
from testground_tpu_torch.sim.cohort import shutdown_leader_child
from testground_tpu.api import Composition as JComposition
from testground_tpu.api import Global as JGlobal
from testground_tpu.api import Group as JGroup
from testground_tpu.api import Instances as JInstances
from testground_tpu.api import TestPlanManifest as JManifest
from testground_tpu.api import generate_default_run as jgenerate
from testground_tpu.api.composition import Run as JRun
from testground_tpu.api.composition import CompositionRunGroup as JCompRunGroup
from testground_tpu.api.composition import RunParams as JRunParams
from testground_tpu.sim import check as jcheck
from testground_tpu_torch.api import (
    Composition,
    Global,
    Group,
    Instances,
    RunGroup,
    RunInput,
    TestPlanManifest,
    generate_default_run,
    prepare_for_run,
    validate_for_run,
)
from testground_tpu_torch.api.composition import CompositionRunGroup, Run, RunParams
from testground_tpu_torch.config import CoalescedConfig
from testground_tpu_torch.rpc import discard_writer
from testground_tpu_torch.sim import check as pcheck
from testground_tpu_torch.sim import executor as pexec

PKG = {
    "jax": dict(Composition=JComposition, Global=JGlobal, Group=JGroup,
                Instances=JInstances, RunParams=JRunParams, Run=JRun,
                RunGroup=JCompRunGroup, generate=jgenerate, runner="sim:jax",
                manifest=lambda plan: JManifest.load_file(
                    os.path.join(REF_PLANS, plan, "manifest.toml")),
                check=jcheck.check_composition),
    "torch": dict(Composition=Composition, Global=Global, Group=Group,
                  Instances=Instances, RunParams=RunParams, Run=Run,
                  RunGroup=CompositionRunGroup, generate=generate_default_run,
                  runner="sim:torch",
                  manifest=lambda plan: TestPlanManifest.load_file(
                      os.path.join(pexec.plan_dir(plan), "manifest.toml")),
                  check=pcheck.check_composition),
}


def make_comp(pkg, plan="placebo", case="ok", count=2, run_cfg=None, slo=None,
              faults=None, trace=None, params=None, disable_metrics=False, runs=0):
    """One composition of ``pkg``'s api: a group ``all`` of ``count``, the
    run-global SLO rules, the group's faults, trace table and parameters;
    ``runs`` > 0 declares that many ``[[runs]]`` entries."""
    k = PKG[pkg]
    comp = k["Composition"](
        global_=k["Global"](plan=plan, case=case, builder="sim:plan", runner=k["runner"],
                            run_config=dict(run_cfg or {}),
                            disable_metrics=disable_metrics),
        groups=[k["Group"](id="all", instances=k["Instances"](count=count))],
    )
    if slo:
        comp.global_.run = k["RunParams"](slo=[dict(s) for s in slo])
    if faults:
        comp.groups[0].run.faults = [dict(f) for f in faults]
    if trace:
        comp.groups[0].run.trace = dict(trace)
    if params:
        comp.groups[0].run.test_params = dict(params)
    if runs:
        comp.runs = [k["Run"](id=f"r{i}", groups=[k["RunGroup"](id="all", group_id="all")])
                     for i in range(runs)]
    return k["generate"](comp)


def findings(pkg, devices=1, **kw) -> list:
    comp = make_comp(pkg, **kw)
    fs = PKG[pkg]["check"](comp, PKG[pkg]["manifest"](comp.global_.plan), devices=devices)
    return [(f.rule, f.severity, f.message, f.run) for f in fs]


# ---------------------------------------------------------------- catalog


@pytest.mark.parametrize("rule_id", [r.id for r in jcheck.RULES])
def test_catalog_holds_each_reference_rule(rule_id):
    ref, port = jcheck.rule_by_id(rule_id), pcheck.rule_by_id(rule_id)
    assert (port.layer, port.summary) == (ref.layer, ref.summary)
    # the one severity that differs: the port refuses what the reference
    # falls back from
    want = "error" if rule_id == "transport.mesh-indivisible" else ref.severity
    assert port.severity == want


def test_catalog_is_the_references():
    """The port's catalog holds the reference's rules and no other: its own
    ``port.not-ported`` went when the cohort, its last refused settings,
    was ported."""
    assert {r.id for r in pcheck.RULES} == {r.id for r in jcheck.RULES}
    assert len({r.id for r in pcheck.RULES}) == len(pcheck.RULES)
    with pytest.raises(KeyError):
        pcheck.rule_by_id("port.not-ported")


def test_findings_payload_and_rendering_match_jax():
    fs = {pkg: PKG[pkg]["check"](make_comp(pkg, run_cfg={"transport": "warp"},
                                           faults=[{"kind": "meteor", "start_ms": 1.0}]),
                                 PKG[pkg]["manifest"]("placebo"), devices=1)
          for pkg in PKG}
    port, ref = fs["torch"], fs["jax"]
    assert [f.to_dict() for f in port] == [f.to_dict() for f in ref]
    assert (pcheck.render_findings("x.toml", port)
            == jcheck.render_findings("x.toml", ref))
    assert (pcheck.findings_payload([("x.toml", port), ("y.toml", [])])
            == jcheck.findings_payload([("x.toml", ref), ("y.toml", [])]))
    assert pcheck.render_findings("y.toml", []) == "y.toml: ok (no findings)"


# ----------------------------------------------------------------- matrix

SLO_DROP = {"metric": "drop_rate", "op": "<", "threshold": 0.5}

# label: (make_comp kwargs, the rule that fires; None for a clean one)
MATRIX = {
    "unknown-case": (dict(case="nope"), "composition.invalid"),
    "too-many-instances": (dict(count=900), "composition.invalid"),
    "unknown-key": (dict(run_cfg={"trasnport": "pallas"}), "run-cfg.unknown-key"),
    "transport-unknown": (dict(run_cfg={"transport": "warp"}), "transport.unknown"),
    "mesh-shape": (dict(run_cfg={"mesh": "nope"}), "mesh.shape-invalid"),
    "mesh-shape-3d": (dict(run_cfg={"mesh": "2x2x2"}), "mesh.shape-invalid"),
    "fault-kind": (dict(faults=[{"kind": "meteor", "start_ms": 1.0}]), "faults.invalid"),
    "fault-range": (dict(faults=[{"kind": "crash", "instances": "0:99", "start_ms": 1.0}]),
                    "faults.invalid"),
    "fault-inverted-window": (dict(faults=[{"kind": "partition", "instances": "0:1",
                                            "to_instances": "1:2", "start_ms": 4.0,
                                            "duration_ms": -2.0}]), "faults.invalid"),
    "trace-fraction": (dict(trace={"fraction": 7.0}), "trace.invalid"),
    "slo-metric": (dict(slo=[{"metric": "vibes", "op": "<", "threshold": 1}],
                        run_cfg={"telemetry": True}), "slo.invalid"),
    "slo-no-telemetry": (dict(slo=[SLO_DROP]), "slo.needs-telemetry"),
    "slo-disable-metrics": (dict(slo=[SLO_DROP], run_cfg={"telemetry": True},
                                 disable_metrics=True), "slo.needs-telemetry"),
    "netmatrix-no-telemetry": (dict(run_cfg={"netmatrix": True}),
                               "netmatrix.needs-telemetry"),
    "netmatrix-disable-metrics": (dict(run_cfg={"netmatrix": True, "telemetry": True},
                                       disable_metrics=True), "netmatrix.needs-telemetry"),
    "clean": (dict(run_cfg={"max_ticks": 32}), None),
    # the checkpoint plane, divergences until it was ported
    "checkpoint-chunks": (dict(run_cfg={"checkpoint_chunks": 2}), None),
    "checkpoint-resume-multi-runs": (dict(run_cfg={"resume_from": "earlier"}, runs=2),
                                     "checkpoint.resume-multi-runs"),
    # the phase plane and the probe, divergences until they were ported
    "clean-phases-and-probe": (dict(run_cfg={"phases": True, "phases_measure": 2,
                                             "transport": "auto", "transport_probe": 2}),
                               None),
    "clean-kitchen-sink": (dict(case="stall", count=4,
                                run_cfg={"telemetry": True, "netmatrix": True,
                                         "max_ticks": 48, "chunk": 16},
                                faults=[{"kind": "crash", "instances": "0:1",
                                         "start_ms": 4.0}],
                                trace={"instances": "0:2"},
                                slo=[{"metric": "crashed_fraction", "op": "<=",
                                      "threshold": 1.0}]), None),
}


@pytest.mark.parametrize("label", list(MATRIX))
def test_findings_match_jax(label):
    kw, rule = MATRIX[label]
    ref, port = findings("jax", **kw), findings("torch", **kw)
    assert [f[0] for f in port] == ([rule] if rule else [])
    if rule == "run-cfg.unknown-key":
        # the message names each package's runner and its options
        assert [f[:2] + (f[3],) for f in port] == [f[:2] + (f[3],) for f in ref]
        assert "'trasnport'" in port[0][2] and "no sim:torch option" in port[0][2]
        assert "'trasnport'" in ref[0][2]
    else:
        assert port == ref


# ------------------------------------------------------------ divergences

# label: (make_comp kwargs, the port's findings, or REF where they are now
# the reference's); each divergence of the module docstring, and the
# bucket cases that were divergences until shape buckets were ported
REF = "the reference's findings"
DIVERGENCES = {
    "buckets-mode": (dict(run_cfg={"bucket": "sideways"}), REF),
    "buckets-ladder": (dict(run_cfg={"bucket": "auto", "bucket_ladder": "x,y"}), REF),
    "trace-bucket-disabled": (dict(trace={"instances": "0:1"},
                                   run_cfg={"bucket": "auto", "bucket_ladder": "16"}), REF),
    # pack.solo was port.not-ported until run packs were ported
    "pack-solo": (dict(run_cfg={"pack": True, "profile": True}), REF),
    # the cohort was port.not-ported until it was ported: the reference's
    # findings, its gates' warnings and the resume refusal
    "cohort": (dict(run_cfg={"coordinator_address": "127.0.0.1:1", "telemetry": True,
                             "nan_guard": True, "num_processes": 2,
                             "checkpoint_chunks": 2, "netmatrix": True,
                             "resume_from": "earlier"},
                    trace={"instances": "0:1"}, slo=[SLO_DROP]), REF),
    # a 2-D mesh and a pack on a mesh were port.not-ported until they were
    # ported: the reference's findings on the peer shards (the last extent)
    "mesh-2d": (dict(count=6, run_cfg={"mesh": "2x4", "bucket": "auto",
                                       "bucket_ladder": "6"}), REF),
    "mesh-2d-pack": (dict(count=6, run_cfg={"mesh": "2x2", "pack": True, "bucket": "auto",
                                            "bucket_ladder": "7"}), REF),
    "mesh-indivisible-pallas": (
        dict(count=6, run_cfg={"mesh": "4", "transport": "pallas"}),
        [("transport.mesh-indivisible", "error", pcheck.pallas_lanes_message(6, 0, 4),
          "default")]),
    # the dead lanes of the mesh padding: the port runs both, where the
    # reference runs xla and falls back from auto with a warn
    "mesh-indivisible-xla": (dict(count=6, run_cfg={"mesh": "4"}), []),
    "mesh-indivisible-auto-cards": (
        dict(count=6, run_cfg={"transport": "auto", "device": "cuda"}, devices=4), []),
}


@pytest.mark.parametrize("label", list(DIVERGENCES))
def test_divergence_is_the_ports_finding(label):
    kw, want = DIVERGENCES[label]
    got = findings("torch", **kw)
    if want == REF:
        want = findings("jax", **kw)
        assert got, label  # each of these fires a rule
    elif label == "mesh-indivisible-xla":
        assert findings("jax", **kw) == []  # the reference runs it too
    elif label == "mesh-indivisible-auto-cards":
        # the reference falls back from auto to xla with a warn
        assert ("transport.mesh-indivisible", "warn") in [
            f[:2] for f in findings("jax", **kw)]
    assert got == want


def test_mesh_indivisible_is_a_warn_in_the_reference():
    """The reference falls back to its XLA transport where the port
    refuses: the same rule, a warn there."""
    kw = DIVERGENCES["mesh-indivisible-pallas"][0]
    assert [f[:2] for f in findings("jax", **kw)] == [
        ("transport.mesh-indivisible", "warn")]


def test_devices_default_to_the_visible_cards(monkeypatch):
    """``devices=0`` counts the cards: none here, so 1 — and a run on the
    CPU meshes nothing unless ``mesh`` says so."""
    kw = dict(count=6, run_cfg={"transport": "pallas", "device": "cuda"})
    assert findings("torch", devices=0, **kw) == []
    monkeypatch.setattr(pcheck, "_visible_cards", lambda: 4)
    assert [f[0] for f in findings("torch", devices=0, **kw)] == [
        "transport.mesh-indivisible"]
    kw["run_cfg"]["device"] = "cpu"
    assert findings("torch", devices=0, **kw) == []


# -------------------------------------------------------------- no drift


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def drive_executor(comp):
    """The composition through the port's executor the way the engine runs
    it (validate → prepare → coalesce → RunInput → ``execute_sim_run``) on
    the CPU. Returns the refusal, or None when it ran."""
    try:
        validate_for_run(comp)
        prepared = prepare_for_run(comp, PKG["torch"]["manifest"](comp.global_.plan))
        cfg = CoalescedConfig().append(prepared.global_.run_config).coalesce_into(
            pexec.SimTorchConfig)
        cfg.device = "cpu"
        grun = prepared.global_.run
        for run in prepared.runs:
            job = RunInput(
                run_id=run.id, test_plan=prepared.global_.plan,
                test_case=prepared.global_.case, total_instances=run.total_instances,
                groups=[RunGroup(id=rg.id, instances=rg.calculated_instance_count,
                                 parameters=dict(rg.test_params),
                                 faults=[dict(f) for f in rg.faults],
                                 trace=dict(rg.trace or {}), slo=[dict(s) for s in rg.slo])
                        for rg in run.groups],
                runner_config=cfg, disable_metrics=prepared.global_.disable_metrics,
                faults=[dict(f) for f in (grun.faults if grun is not None else [])],
                trace=dict(grun.trace if grun is not None else {}),
                slo=[dict(s) for s in (grun.slo if grun is not None else [])])
            pexec.execute_sim_run(job, discard_writer(), threading.Event())
    except Exception as e:  # noqa: BLE001 — the refusal under test
        return e
    finally:
        # a cohort config's leader child serves its cohort until told to
        # stop: stop it, so the next case may lead another
        shutdown_leader_child()
    return None


_DEFAULTS = pexec.SimTorchConfig()
# a value away from its default for each setting of the cohort, refused
# until it was ported (their cases keep their labels): a degenerate
# one-process cohort through the leader child, and the process count and
# id, which mean nothing without a coordinator, as in the reference
_UNPORTED_VALUES = {"coordinator_address": f"127.0.0.1:{_free_port()}",
                    "num_processes": 2, "process_id": 1}
# refused until shape buckets and run packs were ported (their cases keep
# their labels)
_PORTED_BUCKET_VALUES = {"bucket": "auto", "bucket_ladder": "32,64",
                         "build_buckets": True, "pack": True, "pack_max": 4}

DRIFT = {
    # the resume-multi-runs rule judges the whole composition, where the
    # executor sees one run at a time (``tg run resume`` refuses the case)
    **{f"matrix-{k}": v[0] for k, v in MATRIX.items()
       if k != "checkpoint-resume-multi-runs"},
    **{f"unported-{k}": dict(run_cfg={k: v}) for k, v in _UNPORTED_VALUES.items()},
    **{f"unported-{k}": dict(run_cfg={k: v}) for k, v in _PORTED_BUCKET_VALUES.items()},
    # a pack on a mesh and a 2-D mesh, refused until they were ported:
    # neither the checker nor the executor refuses them
    "unported-pack-mesh": dict(count=8, run_cfg={"pack": True, "mesh": "2"}),
    "ported-bucket-ladder": dict(count=10, run_cfg={"bucket": "auto",
                                                    "bucket_ladder": "16"}),
    "buckets-mode-invalid": dict(run_cfg={"bucket": "sideways"}),
    # ported settings: neither the checker nor the executor refuses them
    **{f"ported-{k}": dict(run_cfg={k: v, "transport": "auto"})
       for k, v in {"phases": True, "phases_measure": 3, "transport_probe": 2}.items()},
    # the checkpoint plane's settings, refused until it was ported
    "ported-checkpoint_chunks": dict(run_cfg={"checkpoint_chunks": 2}),
    "ported-checkpoint_keep": dict(run_cfg={"checkpoint_chunks": 1, "checkpoint_keep": 1}),
    "mesh-2d": dict(run_cfg={"mesh": "2x4"}),
    "mesh-indivisible-xla": dict(count=6, run_cfg={"mesh": "4"}),
    "mesh-indivisible-pallas": dict(count=6, run_cfg={"mesh": "4", "transport": "pallas"}),
    "mesh-divisible": dict(count=8, run_cfg={"mesh": "4", "transport": "auto"}),
}


def test_drift_matrix_covers_every_cohort_setting():
    """Every setting of the cohort has its drift case, away from its
    default; and none is refused any more: the executor has no refusal
    table left."""
    assert set(_UNPORTED_VALUES) == {"coordinator_address", "num_processes",
                                     "process_id"}
    assert all(v != getattr(_DEFAULTS, k) for k, v in _UNPORTED_VALUES.items())
    assert not hasattr(pexec, "_UNPORTED_SETTINGS")


@pytest.mark.parametrize("label", list(DRIFT))
def test_checker_errors_exactly_when_the_executor_refuses(label):
    kw = {**DRIFT[label]}
    kw["run_cfg"] = {"max_ticks": 32, **kw.get("run_cfg", {})}
    fs = PKG["torch"]["check"](make_comp("torch", **kw),
                               PKG["torch"]["manifest"](kw.get("plan", "placebo")))
    errors = [f.message for f in fs if f.severity == "error"]
    exc = drive_executor(make_comp("torch", **kw))
    assert (exc is not None) == bool(errors), (label, exc, errors)
    if exc is not None:
        assert str(exc) in errors, (str(exc), errors)


# -------------------------------------------------------------- tg check

BAD = """[global]
plan = "network"
case = "ping-pong"
builder = "sim:plan"
runner = "{runner}"

[global.run_config]
chunk = 16
transport = "warp"

[[global.run.slo]]
metric = "drop_rate"
op = "<"
threshold = 0.5

[[groups]]
id = "all"
[groups.instances]
count = 8
"""

# name: (argv with {home})
CHECK_CASES = {
    "smokes": ["check", "{home}/plans/network/_compositions/sustained-smoke.toml",
               "{home}/plans/chaos/_compositions/smoke.toml"],
    "smokes-json": ["check", "--json",
                    "{home}/plans/network/_compositions/sustained-smoke.toml",
                    "{home}/plans/chaos/_compositions/smoke.toml"],
    "bad": ["check", "{home}/bad.toml"],
    "bad-json": ["check", "--json", "{home}/bad.toml",
                 "{home}/plans/chaos/_compositions/smoke.toml"],
    "run-cfg": ["check", "--run-cfg", "telemetry=false", "--run-cfg", "netmatrix=true",
                "{home}/plans/chaos/_compositions/smoke.toml"],
    "devices": ["check", "--devices", "8", "{home}/plans/chaos/_compositions/smoke.toml"],
    "unloadable": ["check", "{home}/missing.toml",
                   "{home}/plans/network/_compositions/sustained-smoke.toml"],
    "smokes-trace-plans": ["check", "--trace-plans",
                           "{home}/plans/network/_compositions/sustained-smoke.toml",
                           "{home}/plans/chaos/_compositions/smoke.toml"],
    "bad-trace-plans": ["check", "--trace-plans", "--json", "{home}/bad.toml"],
}


@pytest.fixture(scope="module")
def homes(tmp_path_factory):
    root = tmp_path_factory.mktemp("check")
    out = {}
    for pkg, env in (("jax", REF_ENV), ("torch", PORT_ENV)):
        home = _make_home(root, pkg, env, ("network", "chaos"))
        (home / "bad.toml").write_text(BAD.format(runner=PKG[pkg]["runner"]))
        out[pkg] = home
    return out


@pytest.mark.parametrize("name", list(CHECK_CASES))
def test_tg_check_matches_jax(name, homes):
    got = {}
    for pkg, main in (("jax", jmain), ("torch", pmain)):
        home = homes[pkg]
        rc, out, err = _cli(main, home, [a.format(home=home) for a in CHECK_CASES[name]])
        got[pkg] = (rc, out.replace(str(home), "<home>"))
    assert got["torch"] == got["jax"]
    rc, out = got["torch"]
    want_rc = {"smokes": 0, "smokes-json": 0, "bad": 1, "bad-json": 1, "run-cfg": 1,
               "devices": 0, "unloadable": 2, "smokes-trace-plans": 0,
               "bad-trace-plans": 1}[name]
    assert rc == want_rc, out
    if name.endswith("json"):
        doc = json.loads(out)
        assert doc["version"] == 1 and len(doc["compositions"]) == 2
    if name == "bad":
        assert "[error] transport.unknown" in out and "slo.needs-telemetry" in out


# ------------------------------------------------- the plan layer (meta)

FIXTURE_SIM = """import torch

from testground_tpu_torch.sim.api import RUNNING, SUCCESS, Outbox, SimTestcase


class Item(SimTestcase):
    def step(self, env, state, inbox, sync, t):
        if t.item() > 3:
            return self.out(state, status=SUCCESS)
        return self.out(state)


class While(SimTestcase):
    def step(self, env, state, inbox, sync, t):
        k = t.clone()
        while bool(k > 100):
            k = k - 1
        return self.out(state)


class Copy(SimTestcase):
    def step(self, env, state, inbox, sync, t):
        w = torch.tensor([1, 2, 3], dtype=torch.int32, device=env.device)
        return self.out(state, status=RUNNING + 0 * w[0])


class Cached(SimTestcase):
    def step(self, env, state, inbox, sync, t):
        if "w" not in self.__dict__:
            self.w = torch.tensor([1, 2, 3], dtype=torch.int32, device=env.device)
        return self.out(state, status=RUNNING + 0 * self.w[0])


class Promote(SimTestcase):
    def init(self, env):
        return {"x": torch.zeros(env.group.count, dtype=torch.int32, device=env.device)}

    def step(self, env, state, inbox, sync, t):
        return self.out({"x": state["x"] + 0.5})


class Nonzero(SimTestcase):
    def step(self, env, state, inbox, sync, t):
        torch.nonzero(inbox.valid)
        return self.out(state)


class BadPlane(SimTestcase):
    def step(self, env, state, inbox, sync, t):
        n = env.group.count
        dst = torch.zeros((1, n + 1), dtype=torch.int32, device=env.device)
        ob = Outbox(dst=dst, payload=torch.zeros((1, 4, n), dtype=torch.int32,
                                                 device=env.device),
                    valid=torch.zeros((1, n), dtype=torch.bool, device=env.device))
        return self.out(state, outbox=ob)


sim_testcases = {
    "item": Item, "while": While, "copy": Copy, "cached": Cached,
    "promote": Promote, "nonzero": Nonzero, "bad-plane": BadPlane,
}
"""

# case: (the rules it must fire, the line of sim.py they name)
FIXTURE_RULES = {
    "item": (["plan.traced-int"], 8),
    "while": (["plan.traced-int", "plan.while-loop"], 16),
    "copy": (["plan.host-callback"], 23),
    "cached": ([], 0),
    "promote": (["plan.weak-type"], 0),
    "nonzero": (["plan.trace-error"], 44),
    # the engine refuses the plane (no plan frame): the step's definition
    "bad-plane": (["plan.trace-error"], 49),
    "broken": (["plan.load-failed"], 0),
}


def _manifest(name, cases):
    return (f'name = "{name}"\n[defaults]\nbuilder = "sim:plan"\nrunner = "sim:torch"\n'
            '[builders."sim:plan"]\nenabled = true\n[runners."sim:torch"]\nenabled = true\n'
            + "".join(f'[[testcases]]\nname = "{c}"\ninstances = {{ min = 1, max = 64, '
                      'default = 1 }\n' for c in cases))


@pytest.fixture(scope="module")
def fixture_plans(tmp_path_factory):
    root = tmp_path_factory.mktemp("fixture-plans")
    (root / "fx").mkdir()
    (root / "fx" / "sim.py").write_text(FIXTURE_SIM)
    (root / "fx" / "manifest.toml").write_text(
        _manifest("fx", [c for c in FIXTURE_RULES if c != "broken"]))
    (root / "broken").mkdir()
    (root / "broken" / "sim.py").write_text("import no_such_module_anywhere\n")
    (root / "broken" / "manifest.toml").write_text(_manifest("broken", ["broken"]))
    return root


def _trace(plan_dir, case, count=4, **run_cfg):
    manifest = TestPlanManifest.load_file(os.path.join(plan_dir, "manifest.toml"))
    comp = generate_default_run(Composition(
        global_=Global(plan=manifest.name, case=case, builder="sim:plan",
                       runner="sim:torch", total_instances=count,
                       run_config={"device": "cpu", **run_cfg}),
        groups=[Group(id="all", instances=Instances(count=count))]))
    return pcheck.check_composition(comp, manifest, trace_plans=True,
                                    plan_sources=str(plan_dir))


@pytest.mark.parametrize("case", list(FIXTURE_RULES))
def test_fixture_plan_fires_its_rule(case, fixture_plans):
    rules, line = FIXTURE_RULES[case]
    plan = "broken" if case == "broken" else "fx"
    fs = _trace(fixture_plans / plan, case)
    assert [f.rule for f in fs] == rules, [(f.rule, f.message) for f in fs]
    for f in fs:
        assert f.layer == "plan" and f.run == "default"
        assert f.plan_file == str(fixture_plans / plan)
        assert f.message.startswith(f"{plan}:{case}: ")
        if line:
            assert f"{plan}/sim.py:{line}" in f.message, f.message
    if case == "promote":
        assert "[0]['x'] torch.int32 → torch.float32" in fs[0].message
    if case == "bad-plane":
        assert "The expanded size of the tensor (4) must match" in fs[0].message


def test_step_planes_are_held_against_what_the_transport_takes(monkeypatch):
    """A step plane of another dtype or shape than ``enqueue``,
    ``apply_net_updates`` and ``update_sync`` take is a trace error naming
    each plane (the engine's ``_normalize`` makes the plan's planes
    conform, so the step phase itself is bent here)."""
    from testground_tpu_torch.sim.engine import SimProgram

    step_phase = SimProgram._step_phase

    def bent(self, carry, inbox, t):
        out = step_phase(self, carry, inbox, t)
        return {**out, "dst": out["dst"].float(), "signals": out["signals"][:, :1]}

    monkeypatch.setattr(SimProgram, "_step_phase", bent)
    fs = _trace(pexec.plan_dir("placebo"), "ok")
    assert [f.rule for f in fs] == ["plan.trace-error"]
    assert "dst (1, 4) torch.float32 (expected (1, 4) torch.int32)" in fs[0].message
    assert "signals (0, 1) torch.int32 (expected (0, 4) torch.int32)" in fs[0].message
    assert "placebo/sim.py:" in fs[0].message


def test_layer_one_alone_never_traces(fixture_plans):
    manifest = TestPlanManifest.load_file(str(fixture_plans / "fx" / "manifest.toml"))
    comp = generate_default_run(Composition(
        global_=Global(plan="fx", case="item", builder="sim:plan", runner="sim:torch",
                       total_instances=2, run_config={"device": "cpu"}),
        groups=[Group(id="all", instances=Instances(count=2))]))
    assert pcheck.check_composition(comp, manifest) == []
    assert pcheck.check_composition(comp, manifest, trace_plans=True) == []


def test_memory_rule_carries_the_executors_refusal():
    """A carry over ``memory_limit_bytes``: the finding is the executor's
    own ``_precheck_device_memory`` refusal of the same composition."""
    kw = dict(plan="network", case="pingpong-sustained", count=16,
              run_cfg={"memory_limit_bytes": 4096, "max_ticks": 8})
    comp = make_comp("torch", **kw)
    fs = pcheck.check_composition(comp, PKG["torch"]["manifest"]("network"),
                                  trace_plans=True,
                                  plan_sources=pexec.plan_dir("network"))
    assert [f.rule for f in fs] == ["plan.memory"]
    exc = drive_executor(make_comp("torch", **kw))
    assert isinstance(exc, RuntimeError)
    assert fs[0].message == f"network:pingpong-sustained: {exc}"
    assert "but the device budget is 0.00 GiB" in fs[0].message
    # with no budget (no card, no limit) nothing is refused
    kw["run_cfg"] = {"max_ticks": 8}
    assert pcheck.check_composition(make_comp("torch", **kw),
                                    PKG["torch"]["manifest"]("network"), trace_plans=True,
                                    plan_sources=pexec.plan_dir("network")) == []


def _port_cases():
    for plan in sorted(os.listdir(pexec.PLANS_ROOT)):
        path = os.path.join(pexec.PLANS_ROOT, plan, "manifest.toml")
        if os.path.isfile(path):
            for tc in TestPlanManifest.load_file(path).testcases:
                yield f"{plan}:{tc.name}"


@pytest.mark.parametrize("label", list(_port_cases()))
def test_every_port_plan_case_is_clean(label):
    """No plan step of the port reads a device value on the host, copies
    host data to the card every tick or drifts a state leaf's dtype."""
    plan, case = label.split(":")
    run_cfg = {"additional_hosts": "http-echo"} if plan == "additional_hosts" else {}
    fs = _trace(pexec.plan_dir(plan), case, count=16, **run_cfg)
    assert fs == [], [(f.rule, f.message) for f in fs]


def test_the_plan_layer_makes_meta_tensors_only(fixture_plans):
    """Every op the plan layer dispatches, over the port's smoke
    compositions and a fixture, yields meta tensors; the only host tensors
    are the key split and the index lists the build copies in (a few
    words), and no tensor lands on another device. The lint's
    ``sys.monitoring`` tool is released after each check."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten

    from testground_tpu_torch.api import load_composition

    made = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            made.extend(x for x in tree_flatten(out)[0] if isinstance(x, torch.Tensor))
            return out

    with Record():
        for plan, rel in (("network", "sustained-smoke.toml"), ("chaos", "smoke.toml")):
            comp = load_composition(os.path.join(pexec.plan_dir(plan), "_compositions", rel))
            comp.global_.run_config["device"] = "cpu"
            assert pcheck.check_composition(comp, PKG["torch"]["manifest"](plan),
                                            trace_plans=True,
                                            plan_sources=pexec.plan_dir(plan)) == []
        assert [f.rule for f in _trace(fixture_plans / "fx", "copy")] == ["plan.host-callback"]
    meta = [x for x in made if x.device.type == "meta"]
    host = [x for x in made if x.device.type != "meta"]
    assert len(meta) > 100
    assert {x.device.type for x in host} <= {"cpu"}
    # the key split is a few words; the fault and trace lane lists a few
    # words a lane (8 lanes here)
    assert sum(x.numel() * x.element_size() for x in host) < 16384
    assert all(sys.monitoring.get_tool(i) != "tg-check" for i in range(6))


# ------------------------------------------- the padded variant (buckets)

_BUCKETED = {"bucket": "auto", "bucket_ladder": "32,64", "max_ticks": 8}


@pytest.mark.parametrize("label", list(_port_cases()))
def test_bucketed_trace_plans_match_jax(label):
    """``--trace-plans`` of a bucketed run traces the padded variant, the
    counts as 0-d meta tensors, in both packages: the same findings for
    every plan case (``benchmarks:barrier`` turns ``n * p`` into a Python
    int, ``plan.traced-int`` in both)."""
    plan, case = label.split(":")
    rc = dict(_BUCKETED)
    if plan == "additional_hosts":
        rc["additional_hosts"] = "http-echo"
    got = {}
    for pkg, src in (("jax", os.path.join(REF_PLANS, plan)), ("torch", pexec.plan_dir(plan))):
        comp = make_comp(pkg, plan=plan, case=case, count=16, run_cfg=rc)
        fs = PKG[pkg]["check"](comp, PKG[pkg]["manifest"](plan), trace_plans=True,
                               plan_sources=src)
        got[pkg] = [(f.rule, f.severity) for f in fs]
    assert got["torch"] == got["jax"]
    assert got["torch"] == ([("plan.traced-int", "error")] if label == "benchmarks:barrier"
                            else [])


_INT_OF_COUNT = {
    "jax": "from testground_tpu.sim.api import SimTestcase\n",
    "torch": "from testground_tpu_torch.sim.api import SimTestcase\n",
}
_INT_OF_COUNT_BODY = """

class Count(SimTestcase):
    def step(self, env, state, inbox, sync, t):
        if int(env.test_instance_count) > 1:
            return self.out(state)
        return self.out(state)


sim_testcases = {"count": Count}
"""


@pytest.mark.parametrize("bucket", ["auto", "off"])
def test_int_of_the_instance_count_is_traced_int_in_both(bucket, tmp_path):
    """The traced-count contract's teeth: a plan that calls ``int()`` on
    ``env.test_instance_count`` gets ``plan.traced-int`` under bucketing in
    both packages, and nothing at exact shapes, where the count is an
    int."""
    got = {}
    for pkg in ("jax", "torch"):
        d = tmp_path / pkg / "fxcount"
        d.mkdir(parents=True)
        (d / "sim.py").write_text(_INT_OF_COUNT[pkg] + _INT_OF_COUNT_BODY)
        runner = PKG[pkg]["runner"]
        (d / "manifest.toml").write_text(_manifest("fxcount", ["count"]).replace(
            "sim:torch", runner))
        manifest = (JManifest if pkg == "jax" else TestPlanManifest).load_file(
            str(d / "manifest.toml"))
        comp = make_comp(pkg, plan="fxcount", case="count", count=4,
                         run_cfg={"bucket": bucket, "bucket_ladder": "32", "max_ticks": 8})
        fs = PKG[pkg]["check"](comp, manifest, trace_plans=True, plan_sources=str(d))
        got[pkg] = [(f.rule, f.severity) for f in fs]
    assert got["torch"] == got["jax"]
    assert got["torch"] == ([("plan.traced-int", "error")] if bucket == "auto" else [])


# label: (make_comp kwargs, the bucket rule that fires; None for a clean one)
BUCKET_RULES = {
    "auto": (dict(run_cfg={"bucket": "auto", "bucket_ladder": "32"}), None),
    "explicit": (dict(run_cfg={"bucket": "16"}), None),
    "over-ladder": (dict(count=20, run_cfg={"bucket": "auto", "bucket_ladder": "16"}),
                    "buckets.over-ladder"),
    "explicit-over": (dict(count=20, run_cfg={"bucket": "8"}), "buckets.over-ladder"),
    "mesh-indivisible": (dict(count=8, run_cfg={"mesh": "4", "bucket": "auto",
                                                "bucket_ladder": "33"}),
                         "buckets.mesh-indivisible"),
    "mesh-divisible": (dict(count=8, run_cfg={"mesh": "4", "bucket": "auto",
                                              "bucket_ladder": "32"}), None),
    "mode-invalid": (dict(run_cfg={"bucket": "sideways"}), "buckets.mode-invalid"),
    "ladder-invalid": (dict(run_cfg={"bucket": "auto", "bucket_ladder": "0,4"}),
                       "buckets.ladder-invalid"),
}


@pytest.mark.parametrize("label", list(BUCKET_RULES))
def test_bucket_rules_match_jax(label):
    """The ``buckets.*`` rules fire as the reference's: the executor's
    ``resolve_buckets`` gate, its refusals and its warnings, word for
    word."""
    kw, rule = BUCKET_RULES[label]
    ref, port = findings("jax", **kw), findings("torch", **kw)
    assert port == ref
    assert [f[0] for f in port if f[0].startswith("buckets.")] == ([rule] if rule else [])
