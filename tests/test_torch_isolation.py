"""Guards that keep the port a port:

- no module of ``testground_tpu_torch/`` (plans included) and not
  ``chip_smoke.py`` imports jax, the JAX package ``testground_tpu`` or the
  JAX plans under ``plans/``;
- ``SimProgram`` with no ``device`` refuses to run without a GPU instead
  of carrying on on the CPU;
- a kernel wrapper handed a CUDA tensor goes to its kernel (or raises),
  never to the plain version.
"""

import ast
import os

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from testground_tpu_torch.sim import cuda_transport as ct
from testground_tpu_torch.sim import net as pnet

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_sources():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "testground_tpu_torch")):
        files += [os.path.join(root, f) for f in names if f.endswith(".py")]
    return sorted(os.path.relpath(f, REPO) for f in files)


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "testground_tpu", "plans")


@pytest.mark.parametrize("rel", _port_sources())
def test_port_module_imports_neither_jax_nor_the_jax_package(rel):
    with open(os.path.join(REPO, rel)) as f:
        tree = ast.parse(f.read(), filename=rel)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and _forbidden(node.module):
                bad.append(node.module)
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") in (
            "import_module", "__import__"
        ):
            bad += [a.value for a in node.args if isinstance(a, ast.Constant)
                    and isinstance(a.value, str) and _forbidden(a.value)]
    assert not bad, f"{rel} imports {bad}"


def test_the_scan_sees_the_whole_port():
    rels = _port_sources()
    for must in ("chip_smoke.py", "testground_tpu_torch/sim/engine.py",
                 "testground_tpu_torch/sim/faults.py",
                 *(f"testground_tpu_torch/sim/{m}.py"
                   for m in ("telemetry", "netmatrix", "trace", "executor", "slo",
                             "check", "meshplan", "distributed", "cohort")),
                 *(f"testground_tpu_torch/{m}.py"
                   for m in ("api/run_input", "engine/task", "runners/result",
                             "runners/outputs", "rpc/writer",
                             # the control plane above the executor
                             "utils/toml_writer", "utils/conv", "config/dirs",
                             "config/coalescing", "config/env", "api/template",
                             "api/composition", "api/manifest", "api/validation",
                             "api/preparation", "healthcheck/report",
                             "healthcheck/helper", "healthcheck/checkers",
                             "healthcheck/fixers", "runners/base", "builders/base",
                             "builders/sim_plan", "sim/runner", "engine/supervisor",
                             "logging_", "metrics/influx",
                             "metrics/viewer", "cli/main", "cli/__main__",
                             "cli/commands", "sync/errors", "sync/__init__",
                             # the sync service
                             "sync/addr", "sync/inmem", "sync/stats",
                             "sync/server", "sync/client", "sync/boot",
                             "native/__init__", "native/syncsvc",
                             # the local:exec runner, its builders and the SDK
                             "runners/local_exec", "runners/pretty",
                             "builders/exec_py", "builders/exec_bin",
                             *(f"sdk/{m}" for m in ("__init__", "events", "invoke",
                                                    "metrics_api", "network", "runenv",
                                                    "runparams")))),
                 *(f"testground_tpu_torch/plans/{p}/sim.py"
                   for p in ("network", "benchmarks", "placebo", "verify", "splitbrain",
                             "additional_hosts", "chaos")),
                 *(f"testground_tpu_torch/plans/{p}/main.py"
                   for p in ("placebo", "example", "polyglot", "network"))):
        assert must in rels


def test_simprogram_without_device_refuses_without_gpu(monkeypatch):
    from testground_tpu_torch.api import RunGroup
    from testground_tpu_torch.sim.api import SimTestcase
    from testground_tpu_torch.sim.engine import SimProgram, build_groups

    class Plain(SimTestcase):
        SHAPING = pnet.SHAPING_NO_DUPLICATE

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    groups = build_groups([RunGroup(id="all", instances=2)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SimProgram(Plain(), groups)
    assert SimProgram(Plain(), groups, device="cpu").device.type == "cpu"


def _cal(device):
    return pnet.Calendar.empty(4, 8, 2, 1, device=device)


class _KernelReached(Exception):
    pass


def _no_plain(*a, **k):
    raise AssertionError("plain version taken for a CUDA tensor")


def _kernel_sentinel():
    raise _KernelReached


def _launches():
    return (ct.commit_calendar.launches, ct.pop_bucket.launches,
            ct.commit_calendar_sharded.launches, ct.pop_bucket_sharded.launches)


@pytest.mark.parametrize("which", ["commit", "pop", "commit-sharded", "pop-sharded"])
def test_cuda_tensor_goes_to_the_kernel_never_the_plain_version(monkeypatch, which):
    for plain in ("commit_calendar_plain", "pop_bucket_plain",
                  "commit_calendar_sharded_plain", "pop_bucket_sharded_plain"):
        monkeypatch.setattr(ct, plain, _no_plain)
    monkeypatch.setattr(ct, "_lib", _kernel_sentinel)
    before = _launches()
    with FakeTensorMode():
        cal = _cal("cuda")
        if which.endswith("sharded"):
            # a virtual 4-shard mesh on card 0
            from testground_tpu_torch.sim.meshplan import make_mesh

            mesh = make_mesh("4", devices=[torch.device("cuda", 0)] * 4)
            cal = pnet.Calendar.empty(4, 8, 2, 1, device="cuda", mesh=mesh)
        t = torch.zeros((), dtype=torch.int32, device="cuda")
        sk = torch.zeros(5, dtype=torch.int32, device="cuda")
        with pytest.raises(_KernelReached):
            if which == "commit":
                ct.commit_calendar(cal, sk, sk.clone(), [sk.clone()], t)
            elif which == "pop":
                ct.pop_bucket(cal, t)
            elif which == "commit-sharded":
                ct.commit_calendar_sharded(cal, sk, sk.clone(), [sk.clone()], t)
            else:
                ct.pop_bucket_sharded(cal, t)
    assert _launches() == before


def test_cuda_tensor_without_a_toolkit_raises(monkeypatch):
    """Where there is no nvcc, a CUDA tensor makes the wrapper raise at
    the build — it does not fall back to the plain version."""
    monkeypatch.setattr(ct, "commit_calendar_plain", _no_plain)
    monkeypatch.setattr(ct.shutil, "which", lambda name: None)
    monkeypatch.setattr(ct.os.path, "isfile", lambda p: False)
    ct._lib.cache_clear()
    with FakeTensorMode():
        cal = _cal("cuda")
        t = torch.zeros((), dtype=torch.int32, device="cuda")
        sk = torch.zeros(5, dtype=torch.int32, device="cuda")
        with pytest.raises(RuntimeError, match="nvcc not found"):
            ct.commit_calendar(cal, sk, sk.clone(), [sk.clone()], t)


def test_other_devices_and_bad_operands_raise():
    cal = _cal("meta")
    t = torch.zeros((), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ct.pop_bucket(cal, t)
    with FakeTensorMode():
        cal = _cal("cuda")
        t = torch.zeros((), dtype=torch.int64, device="cuda")  # wrong dtype
        with pytest.raises(ValueError, match="one-element int32"):
            ct.pop_bucket(cal, t)
        sk = torch.zeros(5, dtype=torch.int64, device="cuda")  # wrong dtype
        with pytest.raises(ValueError, match="stream operands"):
            ct.commit_calendar(cal, sk, sk, [sk], torch.zeros((), dtype=torch.int32,
                                                              device="cuda"))
