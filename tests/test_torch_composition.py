"""The port's composition API against the JAX package's, on the same inputs:
the TOML writer and value conversions (``utils``), the env and config
coalescing (``config``), the template engine, composition loading,
validation and preparation (``api``), and the port's plan manifests and
compositions.

Each case feeds the same text (a composition, a template, a manifest, a
``.env.toml``) to both packages and demands the same result, or the same
error type and message: the port's modules are copies, and these cases
pin each copy to its original.
"""

import dataclasses
import glob
import os

import pytest

import __graft_entry__ as ge
from testground_tpu import api as japi
from testground_tpu import config as jconfig
from testground_tpu.sim.executor import SimJaxConfig
from testground_tpu.utils import conv as jconv
from testground_tpu.utils.toml_writer import dumps as jdumps
from testground_tpu_torch import api as papi
from testground_tpu_torch import config as pconfig
from testground_tpu_torch.sim.executor import SimTorchConfig, plan_dir
from testground_tpu_torch.utils import conv as pconv
from testground_tpu_torch.utils.toml_writer import dumps as pdumps

REPO = os.path.dirname(os.path.abspath(ge.__file__))
REF_PLANS = os.path.join(REPO, "plans")
PORT_PLANS = os.path.join(REPO, "testground_tpu_torch", "plans")
PORT_PLAN_NAMES = ("network", "benchmarks", "placebo", "verify", "splitbrain",
                   "additional_hosts", "chaos")


def _outcome(fn, *args):
    """``("ok", value)`` or ``("error", exception type name, message)``."""
    try:
        return ("ok", fn(*args))
    except Exception as e:  # noqa: BLE001 — the error is the result
        return ("error", type(e).__name__, str(e))


# ------------------------------------------------------------------ utils


TOML_DOCS = [
    {"a": 1, "b": "x", "c": True, "d": 1.5},
    {"t": {"nested": {"k": "v"}}, "top": "x"},
    {"arr": [1, 2, 3], "sarr": ["a", "b"]},
    {"groups": [{"id": "a", "n": 1}, {"id": "b", "n": 2}]},
    {"s": 'quote " backslash \\ newline \n tab \t'},
    {"weird key.with dots": {"inner": 1}},
    {"empty_list": [], "empty_table": {}},
    {"x": object()},
]


@pytest.mark.parametrize("i", range(len(TOML_DOCS)))
def test_toml_writer_matches_jax(i):
    def dumped(dumps):
        return _outcome(dumps, TOML_DOCS[i])

    got, want = dumped(pdumps), dumped(jdumps)
    if want[0] == "error":  # the message names the object's address
        assert got[:2] == want[:2]
    else:
        assert got == want


KEY_VALUES = [
    ["chunk=32", "telemetry=true", "mesh=4", "device=cpu"],
    ["tick_ms=0.5", "name=with=equals", "list=[1,2]", "empty=", "null=null"],
    ["bare", 'quoted="x"', "obj={\"a\": 1}"],
]


@pytest.mark.parametrize("i", range(len(KEY_VALUES)))
def test_parse_key_values_matches_jax(i):
    got, want = pconv.parse_key_values(KEY_VALUES[i]), jconv.parse_key_values(KEY_VALUES[i])
    assert got == want
    assert [type(v) for v in got.values()] == [type(v) for v in want.values()]


# ----------------------------------------------------------------- config


ENV_TOMLS = {
    "empty": "",
    "runners": '[runners."sim:torch"]\ndevice = "cpu"\nchunk = 64\n'
               '[runners."sim:jax"]\ndisabled = true\n'
               '[builders."sim:plan"]\nenabled = true\n',
    "daemon": '[daemon]\nlisten = ":9999"\ninfluxdb_endpoint = "http://127.0.0.1:8086"\n'
              'metrics_task_limit = -3\n[daemon.scheduler]\nworkers = 5\n'
              'task_repo_type = "disk"\ntask_timeout_min = 2\n'
              '[client]\nendpoint = "http://x:1"\nuser = "me"\n',
    "malformed": "[runners\n",
}


@pytest.mark.parametrize("name", list(ENV_TOMLS))
def test_env_config_load_matches_jax(name, tmp_path):
    homes = {}
    for pkg in ("jax", "torch"):
        home = tmp_path / pkg
        home.mkdir()
        (home / ".env.toml").write_text(ENV_TOMLS[name])
        homes[pkg] = str(home)

    def loaded(cls, home):
        e = cls.load(home=home)
        d = dataclasses.asdict(e)
        d["dirs"] = [os.path.relpath(p, home) for p in e.dirs.all()]
        d["disabled"] = {r: e.runner_is_disabled(r) for r in ("sim:torch", "sim:jax")}
        return d

    got = _outcome(loaded, pconfig.EnvConfig, homes["torch"])
    want = _outcome(loaded, jconfig.EnvConfig, homes["jax"])
    if got[0] == want[0] == "ok":
        # the whole [daemon] table, metrics_task_limit (GET /metrics) included
        assert set(want[1]["daemon"]) == set(got[1]["daemon"])
        assert set(got[1]["client"]) == set(want[1]["client"]) == {"endpoint", "token",
                                                                    "user"}
    assert got == tuple(w.replace(homes["jax"], homes["torch"])
                        if isinstance(w, str) else w for w in want)
    if got[0] == "ok":
        for d in got[1]["dirs"]:
            assert os.path.isdir(os.path.join(homes["torch"], d))


# layers as the supervisor stacks them: the env's runner table, then the
# composition's run_config (a manifest's runner table already in it)
LAYERS = {
    "run-cfg": [{"chunk": 64}, pconv.parse_key_values(
        ["chunk=32", "telemetry=true", "mesh=4", "device=cpu"])],
    "manifest-extras": [{}, {"enabled": True, "additional_hosts": ["http-echo"],
                             "max_ticks": 512, "tick_ms": 1}],
    "env-only": [{"shard": False, "transport": "pallas", "seed": 7}, {}],
    "floats-and-lists": [{"tick_ms": 0.25}, {"additional_hosts": "a,b",
                                              "memory_limit_bytes": -1}],
}


@pytest.mark.parametrize("name", list(LAYERS))
def test_coalesced_config_matches_jax_on_shared_fields(name):
    env_layer, comp_layer = LAYERS[name]
    got = pconfig.CoalescedConfig().append(env_layer).append(comp_layer).coalesce_into(
        SimTorchConfig)
    want = jconfig.CoalescedConfig().append(env_layer).append(comp_layer).coalesce_into(
        SimJaxConfig)
    shared = ({f.name for f in dataclasses.fields(SimTorchConfig)}
              & {f.name for f in dataclasses.fields(SimJaxConfig)})
    assert len(shared) > 30
    for f in sorted(shared):
        assert getattr(got, f) == getattr(want, f), f
        assert type(getattr(got, f)) is type(getattr(want, f)), f
    # no coercion: a value's type is what the layer gave it
    if name == "run-cfg":
        assert (got.chunk, got.telemetry, got.mesh, got.device) == (32, True, 4, "cpu")


# ---------------------------------------------------------- compositions


def _all_compositions():
    ref = sorted(glob.glob(os.path.join(REF_PLANS, "*", "_compositions", "*.toml")))
    port = sorted(glob.glob(os.path.join(PORT_PLANS, "*", "_compositions", "*.toml")))
    return [os.path.relpath(p, REPO) for p in ref + port]


def _loaded(api, path, env):
    old = dict(os.environ)
    os.environ.update(env)
    try:
        comp = api.load_composition(path)
        api.validate_for_run(comp)
        return comp.to_dict()
    finally:
        os.environ.clear()
        os.environ.update(old)


@pytest.mark.parametrize("rel", _all_compositions())
def test_checked_in_composition_loads_like_jax(rel):
    path = os.path.join(REPO, rel)
    got = _outcome(_loaded, papi, path, {})
    assert got[0] == "ok"
    assert got == _outcome(_loaded, japi, path, {})


def test_port_compositions_are_the_reference_ones_on_sim_torch():
    for plan, name in (("network", "sustained-smoke.toml"), ("chaos", "smoke.toml")):
        port = papi.load_composition(os.path.join(PORT_PLANS, plan, "_compositions", name))
        ref = japi.load_composition(os.path.join(REF_PLANS, plan, "_compositions", name))
        assert port.global_.runner == "sim:torch" and ref.global_.runner == "sim:jax"
        port.global_.runner = ref.global_.runner
        assert port.to_dict() == ref.to_dict()


_GROUP = '[[groups]]\nid = "{id}"\n[groups.instances]\ncount = {n}\n'
_GLOBAL = ('[global]\nplan = "{plan}"\ncase = "{case}"\nbuilder = "sim:plan"\n'
           'runner = "{runner}"\n')

# name: (composition text, env for the template, files beside it)
COMPOSITIONS = {
    "env-count": (
        _GLOBAL + "total_instances = {{{{ atoi .Env.TG_COUNT }}}}\n"
        '[[groups]]\nid = "all"\n[groups.instances]\ncount = {{{{ atoi .Env.TG_COUNT }}}}\n',
        {"TG_COUNT": "3"}, {}),
    "split-range": (
        _GLOBAL + '{{{{ range (split .Env.REGIONS) }}}}[[groups]]\nid = "{{{{ . }}}}"\n'
        "[groups.instances]\ncount = 2\n{{{{ end }}}}",
        {"REGIONS": "eu,us,ap"}, {}),
    "if-else": (
        _GLOBAL + '[[groups]]\nid = "all"\n[groups.instances]\n'
        "{{{{ if .Env.BIG }}}}count = 100{{{{ else }}}}count = 1{{{{ end }}}}\n",
        {"BIG": "y"}, {}),
    "load-resource-define": (
        '{{{{ define "partial" -}}}}\n[metadata]\nname = "{{{{ $.Env.NAME }}}}"\n'
        'author = "{{{{ .author }}}}"\n{{{{- end -}}}}\n'
        '{{{{ with (load_resource "./res.toml") }}}}{{{{ template "partial" (withEnv .) }}}}'
        "{{{{ end }}}}\n" + _GLOBAL + _GROUP.format(id="all", n=4),
        {"NAME": "templated"}, {"res.toml": 'author = "someone"\n'}),
    "pick-toml-index": (
        '{{{{ with (load_resource "./res.toml") }}}}{{{{ (pick . "metadata") | toml }}}}'
        "{{{{ end }}}}\n" + _GLOBAL + _GROUP.format(id="g0", n=2),
        {}, {"res.toml": 'other = 1\n[metadata]\nname = "picked"\n'}),
    "runs-and-tables": (
        _GLOBAL + "[global.run_config]\ntelemetry = true\nchunk = 16\n"
        '[global.run.test_params]\nshould_fail = "false"\n'
        '[[global.run.slo]]\nname = "r"\nmetric = "drop_rate"\nop = "<"\n'
        'threshold = 0.5\n' + _GROUP.format(id="a", n=2)
        + '[[groups.run.faults]]\nkind = "crash"\ninstances = "0:1"\nstart_ms = 3.0\n'
        + _GROUP.format(id="b", n=2)
        + '[[runs]]\nid = "first"\n[[runs.groups]]\nid = "a"\n'
        '[[runs]]\nid = "second"\ntotal_instances = 4\n[runs.test_params]\nx = "1"\n'
        '[[runs.groups]]\nid = "a"\n[runs.groups.instances]\npercentage = 0.5\n'
        '[[runs.groups]]\nid = "b"\n[runs.groups.instances]\npercentage = 0.5\n'
        '[runs.groups.trace]\ninstances = "0:1"\n',
        {}, {}),
    "group-percentages": (
        _GLOBAL.replace('runner = "{runner}"\n', 'runner = "{runner}"\ntotal_instances = 10\n')
        + '[[groups]]\nid = "x"\n[groups.instances]\npercentage = 0.3\n'
        '[[groups]]\nid = "y"\n[groups.instances]\npercentage = 0.7\n',
        {}, {}),
    "three-hundred": (_GLOBAL + _GROUP.format(id="all", n=300), {}, {}),
    # invalid ones
    "duplicate-groups": (_GLOBAL + _GROUP.format(id="a", n=1) + _GROUP.format(id="a", n=1),
                         {}, {}),
    "count-and-percentage": (
        _GLOBAL + '[[groups]]\nid = "a"\n[groups.instances]\ncount = 1\npercentage = 0.5\n',
        {}, {}),
    "run-unknown-group": (
        _GLOBAL + _GROUP.format(id="a", n=1) + '[[runs]]\nid = "r"\n[[runs.groups]]\n'
        'id = "zzz"\n[runs.groups.instances]\ncount = 1\n', {}, {}),
    "run-ids-not-unique": (
        _GLOBAL + _GROUP.format(id="a", n=1) + '[[runs]]\nid = "r"\n[[runs.groups]]\nid = "a"\n'
        '[[runs]]\nid = "r"\n[[runs.groups]]\nid = "a"\n', {}, {}),
    "percentage-without-total": (
        _GLOBAL + '[[groups]]\nid = "a"\n[groups.instances]\npercentage = 0.5\n', {}, {}),
    "total-mismatch": (
        _GLOBAL + "total_instances = 5\n" + _GROUP.format(id="a", n=2), {}, {}),
    "no-groups": (_GLOBAL, {}, {}),
    "missing-case": (_GLOBAL.replace('case = "{case}"\n', "") + _GROUP.format(id="a", n=1),
                     {}, {}),
    "missing-runner": (_GLOBAL.replace('runner = "{runner}"\n', "")
                       + _GROUP.format(id="a", n=1), {}, {}),
    "missing-builder": (_GLOBAL.replace('builder = "sim:plan"\n', "")
                        + _GROUP.format(id="a", n=1), {}, {}),
    "unknown-function": (_GLOBAL + "{{{{ frobnicate 1 }}}}\n", {}, {}),
    "unterminated-block": (_GLOBAL + "{{{{ with .Env }}}}no end\n", {}, {}),
    "atoi-bad-input": (_GLOBAL + 'x = {{{{ atoi "xyz" }}}}\n', {}, {}),
    "missing-resource": (_GLOBAL + '{{{{ with (load_resource "./nope.toml") }}}}{{{{ end }}}}\n',
                         {}, {}),
    "bad-toml": (_GLOBAL + "[[groups]\n", {}, {}),
}


def _write(tmp_path, name, runner, plan="placebo", case="optional-failure"):
    text, env, files = COMPOSITIONS[name]
    d = tmp_path / runner.replace(":", "-")
    d.mkdir(exist_ok=True)
    for fname, body in files.items():
        (d / fname).write_text(body)
    path = d / "comp.toml"
    path.write_text(text.format(plan=plan, case=case, runner=runner))
    return str(path), env


@pytest.mark.parametrize("name", list(COMPOSITIONS))
def test_composition_loads_and_validates_like_jax(name, tmp_path):
    ppath, env = _write(tmp_path, name, "sim:torch")
    jpath, _ = _write(tmp_path, name, "sim:jax")
    got = _outcome(_loaded, papi, ppath, env)
    want = _outcome(_loaded, japi, jpath, env)
    if want[0] == "ok":
        assert want[1]["global"]["runner"] == "sim:jax"
        want[1]["global"]["runner"] = "sim:torch"
        # the rendered toml of a templated table survives the round trip
        assert got[1] == want[1]
    assert got[0] == want[0]
    if got[0] == "error":
        assert got[1:] == (want[1], want[2].replace(jpath, ppath)
                           .replace(os.path.dirname(jpath), os.path.dirname(ppath)))


# ------------------------------------------------------------ preparation


def _prepared(api, comp_path, env, manifest_path):
    old = dict(os.environ)
    os.environ.update(env)
    try:
        comp = api.load_composition(comp_path)
    finally:
        os.environ.clear()
        os.environ.update(old)
    manifest = api.TestPlanManifest.load_file(manifest_path)
    api.validate_for_run(comp)
    built = api.prepare_for_build(comp, manifest)
    api.validate_for_build(built)
    return api.prepare_for_run(built, manifest).to_dict()


def _rename_runner(d):
    d["global"]["runner"] = "sim:torch"
    return d


@pytest.mark.parametrize("name", ["env-count", "split-range", "if-else",
                                  "load-resource-define", "pick-toml-index",
                                  "runs-and-tables", "group-percentages"])
def test_prepare_for_run_against_the_port_manifest_matches_jax(name, tmp_path):
    """The port's preparation against the port's manifest equals the
    reference's against the reference manifest, the runner name mapped."""
    ppath, env = _write(tmp_path, name, "sim:torch")
    jpath, _ = _write(tmp_path, name, "sim:jax")
    got = _prepared(papi, ppath, env, os.path.join(PORT_PLANS, "placebo", "manifest.toml"))
    want = _prepared(japi, jpath, env, os.path.join(REF_PLANS, "placebo", "manifest.toml"))
    assert got == _rename_runner(want)
    assert got["runs"] and all(r["total_instances"] > 0 for r in got["runs"])


# name: (runner, plan, case, composition) through preparation
REFUSALS = {
    "unknown-case": ("sim:torch", "placebo", "no-such-case", "env-count"),
    "instances-over-the-bound": ("sim:torch", "placebo", "ok", "three-hundred"),
    "runner-not-in-the-manifest": ("sim:jax", "placebo", "ok", "env-count"),
    "additional-hosts-runner-table": ("sim:torch", "additional_hosts",
                                      "additional_hosts", "group-percentages"),
}


@pytest.mark.parametrize("name", list(REFUSALS))
def test_preparation_refuses_like_jax(name, tmp_path):
    """The same composition against the port's manifest through both
    packages: the same verdict and, where refused, the reference's message
    (a ``sim:jax`` composition against a port manifest is refused with "plan
    does not support runner")."""
    runner, plan, case, text = REFUSALS[name]
    path, env = _write(tmp_path, text, runner, plan=plan, case=case)
    manifest = os.path.join(PORT_PLANS, plan, "manifest.toml")
    got = _outcome(_prepared, papi, path, env, manifest)
    want = _outcome(_prepared, japi, path, env, manifest)
    assert got == want
    if name == "additional-hosts-runner-table":
        # the manifest's [runners."sim:torch"] table lands in run_config
        assert got[1]["global"]["run_config"] == {"enabled": True,
                                                  "additional_hosts": ["http-echo"]}
    else:
        assert got[0] == "error" and got[1] == "ValueError"
    if name == "runner-not-in-the-manifest":
        assert "plan does not support runner 'sim:jax'" in got[2]


# ---------------------------------------------------------------- manifests


@pytest.mark.parametrize("plan", PORT_PLAN_NAMES)
def test_port_manifest_is_the_reference_one_on_sim_torch(plan):
    port = papi.TestPlanManifest.load_file(os.path.join(plan_dir(plan), "manifest.toml"))
    ref = japi.TestPlanManifest.load_file(os.path.join(REF_PLANS, plan, "manifest.toml"))
    assert port.name == ref.name == plan
    assert [tc.to_dict() for tc in port.testcases] == [tc.to_dict() for tc in ref.testcases]
    for tc in ref.testcases:
        assert port.default_parameters(tc.name) == ref.default_parameters(tc.name)
    assert port.defaults == {"builder": "sim:plan", "runner": "sim:torch"}
    assert port.builders == {"sim:plan": ref.builders["sim:plan"]}
    assert port.runners == {"sim:torch": ref.runners["sim:jax"]}
    assert port.extra_sources == ref.extra_sources
