"""The port's build precompile pass against the reference's, on the CPU
(``device = "cpu"`` in each port home's ``[runners."sim:torch"]``): the
compile-cache directory, the BuildKey markers a build writes and a rebuild
hits, the skip lines, the check pass's findings, a failing precompile that
leaves the build a success, and a bucketed run's ``compile_cache`` verdict.

The cases mirror the reference's ``tests/test_compile_cache.py``
(``TestCacheDirResolution`` and ``TestBuildPrecompiles``) through both
packages' CLIs in process (``test_torch_cli``'s homes and helpers), with
the port's ``placebo`` and ``network`` plans at a few instances.
"""

import json
import os
import re

import pytest
import torch

from test_torch_cli import PORT_ENV, REF_ENV, _cli, _make_home, _port_task, jmain, pmain
from testground_tpu.config.dirs import Directories as JDirectories
from testground_tpu.utils.compile_cache import compile_cache_dir as jcompile_cache_dir
from testground_tpu_torch.config.dirs import Directories
from testground_tpu_torch.sim import cuda_transport as ct
from testground_tpu_torch.sim.executor import compile_cache_verdict
from testground_tpu_torch.utils.compile_cache import compile_cache_dir

# one group of four placebo:ok instances, bucketed (so that a run journals
# the sim.bucket block), with {cfg} more run-config lines
PLACEBO = """[global]
plan = "placebo"
case = "ok"
builder = "sim:plan"
runner = "{runner}"

[global.run_config]
chunk = 8
bucket = "auto"
bucket_ladder = "8"
{cfg}

[[groups]]
id = "all"
[groups.instances]
count = 4
"""

# three [[runs]] of network:ping-pong, the first and the last of one shape
THREE_RUNS = """[global]
plan = "network"
case = "ping-pong"
builder = "sim:plan"
runner = "sim:torch"

[global.run_config]
chunk = 8

[[groups]]
id = "all"
[groups.instances]
count = 4
""" + "".join(f"""
[[runs]]
id = "{rid}"
[[runs.groups]]
id = "all"
[runs.groups.instances]
count = {n}
""" for rid, n in (("a", 4), ("b", 6), ("a2", 4)))


def _markers(home) -> list[str]:
    d = os.path.join(home, "data", "compile-cache", "precompiled")
    return sorted(os.listdir(d)) if os.path.isdir(d) else []


def _marker(home, name) -> dict:
    with open(os.path.join(home, "data", "compile-cache", "precompiled", name)) as f:
        return json.load(f)


def _build(main, home, argv) -> tuple[int, str, str]:
    rc, out, err = _cli(main, home, argv)
    m = re.search(r"build is queued with ID: (\S+)", out)
    assert m, out + err
    return rc, out, m.group(1)


def _lines(out, prefix) -> list[str]:
    return [ln for ln in out.splitlines() if ln.startswith(prefix)]


# ----------------------------------------------------------- the directory

CACHE_ENV = {
    "default": None,
    "override": "/elsewhere/cache",
    "off": "off",
    "0": "0",
    "none": "none",
    "false": "false",
    "OFF": "OFF",
}


@pytest.mark.parametrize("name", list(CACHE_ENV))
def test_compile_cache_dir_matches_jax(name, monkeypatch, tmp_path):
    """``compile_cache_dir`` resolves as the reference's: the override,
    each disable value (any case), and the default under the given home,
    ``$TESTGROUND_HOME`` or ``~/testground``; ``Directories.compile_cache``
    is the reference's."""
    value = CACHE_ENV[name]
    if value is None:
        monkeypatch.delenv("TESTGROUND_COMPILE_CACHE", raising=False)
    else:
        monkeypatch.setenv("TESTGROUND_COMPILE_CACHE", value)
    monkeypatch.setenv("TESTGROUND_HOME", str(tmp_path / "env-home"))
    for home in ("/x/home", None):
        assert compile_cache_dir(home) == jcompile_cache_dir(home)
    monkeypatch.delenv("TESTGROUND_HOME")
    monkeypatch.setenv("HOME", str(tmp_path / "user"))
    assert compile_cache_dir() == jcompile_cache_dir()
    got = compile_cache_dir("/x/home")
    if value is None:
        assert got == "/x/home/data/compile-cache"
        assert compile_cache_dir() == str(tmp_path / "user" / "testground" / "data"
                                          / "compile-cache")
    elif name == "override":
        assert got == value
    else:
        assert got is None
    assert Directories("/x/home").compile_cache() == JDirectories("/x/home").compile_cache()


# ------------------------------------------------------------ the markers


def test_build_then_run_then_rebuild(tmp_path):
    """A build writes one marker (the BuildKey spec, ``compile_secs`` and a
    ``perf`` block), its composition's ``total_instances`` filled in; the
    run that follows journals ``compile_cache: "off"`` (the CPU compiles
    nothing); a rebuild logs the cache hit and writes no other marker."""
    home = _make_home(tmp_path, "torch", PORT_ENV, ("placebo",))
    comp = home / "comp.toml"
    comp.write_text(PLACEBO.format(runner="sim:torch", cfg=""))
    rc, out, _ = _build(pmain, home, ["build", "composition", "-f", str(comp),
                                      "--write-artifacts"])
    assert rc == 0 and "(outcome: success)" in out, out
    assert len(_lines(out, "sim:plan precompiled run default into ")) == 1, out
    assert _lines(out, "sim:plan precompile: the warm tick of run default on cpu "
                  "launched no kernel"), out
    (name,) = _markers(home)
    marker = _marker(home, name)
    assert name == re.search(r"\(key (\w+)\)", out).group(1) + ".json"
    assert marker["plan"] == "placebo" and marker["case"] == "ok"
    assert marker["groups"] == [{"id": "all", "instances": 4, "parameters": {}}]
    assert marker["bucket"] == [8] and marker["device"] == "cpu"
    assert marker["torch"] == torch.__version__ and "kernels" not in marker
    perf = marker["perf"]
    assert sorted(perf) == ["carry_bytes", "kernel_build_secs", "peak_bytes", "warm_secs"]
    assert perf["carry_bytes"] > 0 and perf["peak_bytes"] is None
    assert perf["kernel_build_secs"] == 0.0 and marker["compile_secs"] > 0
    assert "total_instances = 4" in comp.read_text()

    rc, out, _ = _cli(pmain, home, ["run", "composition", "-f", str(comp)])
    assert rc == 0, out
    task = _port_task(home, re.search(r"run is queued with ID: (\S+)", out).group(1))
    assert task.result["journal"]["sim"]["bucket"]["compile_cache"] == "off"

    rc, out, _ = _build(pmain, home, ["build", "composition", "-f", str(comp)])
    assert rc == 0 and _lines(out, f"sim:plan precompile: cache hit for run default "
                                   f"(key {name[:-5]})"), out
    assert not _lines(out, "sim:plan precompiled run"), out
    assert _markers(home) == [name]


def test_multi_runs_precompile_one_marker_per_shape(tmp_path):
    """Three ``[[runs]]`` at 4, 6 and 4 instances: two markers, the third
    run a duplicate of the first within the build."""
    home = _make_home(tmp_path, "torch", PORT_ENV, ("network",))
    comp = home / "comp.toml"
    comp.write_text(THREE_RUNS)
    rc, out, _ = _build(pmain, home, ["build", "composition", "-f", str(comp)])
    assert rc == 0 and "(outcome: success)" in out, out
    assert [ln.split(" into ")[0] for ln in _lines(out, "sim:plan precompiled run")] == [
        "sim:plan precompiled run a", "sim:plan precompiled run b"]
    markers = _markers(home)
    assert len(markers) == 2
    assert sorted(_marker(home, m)["groups"][0]["instances"] for m in markers) == [4, 6]


def test_build_single_with_case_precompiles_via_cli(tmp_path):
    """``build single network:ping-pong`` resolves the case (its instance
    count from the manifest), so the build precompiles it."""
    home = _make_home(tmp_path, "torch", PORT_ENV, ("network",))
    rc, out, _ = _build(pmain, home, ["build", "single", "network:ping-pong"])
    assert rc == 0, out
    (name,) = _markers(home)
    assert _marker(home, name)["case"] == "ping-pong"


# ---------------------------------------------------- against the reference

SKIPS = {
    "cache-off": ["build", "single", "placebo:ok"],
    "case-less": ["build", "single", "placebo"],
}


@pytest.mark.parametrize("name", list(SKIPS))
def test_precompile_skips_like_jax(name, tmp_path, monkeypatch):
    """With ``TESTGROUND_COMPILE_CACHE=off``, and on a build without a test
    case, both packages log the same skip line and write no marker."""
    if name == "cache-off":
        monkeypatch.setenv("TESTGROUND_COMPILE_CACHE", "off")
    got = {}
    for pkg, main, env in (("jax", jmain, REF_ENV), ("torch", pmain, PORT_ENV)):
        home = _make_home(tmp_path, pkg, env, ("placebo",))
        rc, out, _ = _build(main, home, SKIPS[name] + ["--builder", "sim:plan"])
        assert rc == 0, (pkg, out)
        got[pkg] = _lines(out, "sim:plan precompile")
        assert not _markers(home), pkg
    assert got["torch"] == got["jax"]
    assert got["torch"] == [
        "sim:plan precompile skipped: compile cache disabled" if name == "cache-off"
        else "sim:plan precompile skipped: no test case on this build"]


# run-config lines that give a check finding (the matrix without the
# telemetry plane), and a memory budget no carry fits (the precheck fails)
FAULTY = {
    "check-finding": "netmatrix = true",
    "oversized": "memory_limit_bytes = 1",
}


@pytest.mark.parametrize("name", list(FAULTY))
def test_build_findings_and_failures_match_jax(name, tmp_path):
    """A composition with a check finding prints the same ``check:`` lines
    in both packages' builds; an oversized one gives both the "precompile
    failed (build still ok)" warning with the precheck's refusal, the build
    a success and no marker."""
    got = {}
    for pkg, main, env, runner in (("jax", jmain, REF_ENV, "sim:jax"),
                                   ("torch", pmain, PORT_ENV, "sim:torch")):
        home = _make_home(tmp_path, pkg, env, ("placebo",))
        comp = home / "comp.toml"
        comp.write_text(PLACEBO.format(runner=runner, cfg=FAULTY[name]))
        rc, out, _ = _build(main, home, ["build", "composition", "-f", str(comp)])
        assert rc == 0 and "(outcome: success)" in out, (pkg, out)
        failed = [ln.split(" — ")[0].split(" GiB per device")[0].rsplit("~", 1)[0]
                  for ln in _lines(out, "sim:plan precompile failed")]
        got[pkg] = {"check": _lines(out.replace("sim:jax", "sim:torch"), "check: "),
                    "failed": failed, "markers": len(_markers(home))}
    assert got["torch"] == got["jax"]
    if name == "check-finding":
        assert any("netmatrix" in ln for ln in got["torch"]["check"]), got
        assert got["torch"]["failed"] == [] and got["torch"]["markers"] == 1
    else:
        assert got["torch"]["failed"] == [
            "sim:plan precompile failed (build still ok): composition needs "], got
        assert got["torch"]["markers"] == 0


def test_precompile_without_a_card_fails_loudly(tmp_path, monkeypatch):
    """Without a card and without ``device = "cpu"`` the precompile warms
    nothing on the CPU: the build warns, naming the error, and stays a
    success, with no marker."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    home = _make_home(tmp_path, "torch", "", ("placebo",))
    rc, out, _ = _build(pmain, home, ["build", "single", "placebo:ok"])
    assert rc == 0 and "(outcome: success)" in out, out
    assert _lines(out, "sim:plan precompile failed (build still ok): no CUDA device"), out
    assert not _markers(home)


# ------------------------------------------------------------- the verdict

# (device, cache on, resumed, nvcc builds the record holds unclaimed) →
# the bucket block's compile_cache
VERDICTS = {
    "cuda-built-here": ("cuda", True, False, 1, "miss"),
    "cuda-found-built": ("cuda", True, False, 0, "hit"),
    "cuda-resumed": ("cuda", True, True, 1, "unknown"),
    "cuda-cache-off": ("cuda", False, False, 1, "off"),
    "cpu": ("cpu", True, False, 1, "off"),
}


@pytest.mark.parametrize("name", list(VERDICTS))
def test_compile_cache_verdict(name, monkeypatch):
    """The verdict from a stubbed kernel-build record: a run claims the
    nvcc builds no run or build claimed before it, and only once."""
    device, cache_on, resumed, unclaimed, want = VERDICTS[name]
    monkeypatch.setattr(ct, "_BUILDS", {"runs": 2 + unclaimed, "secs": 9.5,
                                        "claimed": 2})
    assert ct.kernel_builds() == (2 + unclaimed, 9.5)
    claimed = ct.claim_kernel_builds()
    assert claimed == unclaimed and ct.claim_kernel_builds() == 0
    assert compile_cache_verdict(torch.device(device), cache_on, resumed, claimed) == want
