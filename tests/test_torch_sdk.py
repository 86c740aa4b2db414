"""The port's plan SDK, ``PrettyPrinter`` and ``local:exec`` healthcheck
against the reference's, on the CPU: the copies pinned (the SDK, the
``exec:*`` builders, the runner, the healthcheck checkers and fixers, the
printer, and every plan copy under ``testground_tpu_torch/plans/``), then
from seeded inputs ``RunParams``' env contract, the event lines, the
metrics records, ``invoke_map`` run as a process, the printer fed the same
canned streams and the healthcheck on the same homes. An instance of the
port's SDK loads neither torch nor numpy.

Named differences: the port's runner's ``healthcheck`` takes the port's
runner-interface ``config`` argument (and does not read it); the port's
``placebo`` manifest keeps ``sim:plan``/``sim:torch`` as its defaults, its
``network`` manifest ``sim:torch`` for ``sim:jax``; the benchmarks plan's
``flood-bucketed`` composition names ``sim:torch``.
"""

import ast
import inspect
import io
import json
import os
import re
import shutil
import socket
import stat
import subprocess
import sys
import tomllib

import numpy as np
import pytest

import testground_tpu.builders.base as ref_base
import testground_tpu.runners.pretty as ref_pretty
import testground_tpu.runners.result as ref_result
import testground_tpu.sdk.events as ref_events
import testground_tpu.sdk.metrics_api as ref_metrics
import testground_tpu.sdk.runparams as ref_runparams
import testground_tpu_torch.builders.base as port_base
import testground_tpu_torch.runners.pretty as port_pretty
import testground_tpu_torch.runners.result as port_result
import testground_tpu_torch.sdk.events as port_events
import testground_tpu_torch.sdk.metrics_api as port_metrics
import testground_tpu_torch.sdk.runparams as port_runparams

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_DIR = os.path.join(REPO, "testground_tpu")
PORT_DIR = os.path.join(REPO, "testground_tpu_torch")
REF_PLANS = os.path.join(REPO, "plans")
PORT_PLANS = os.path.join(PORT_DIR, "plans")

# ------------------------------------------------------ the code copies


def _code(path: str, port: bool) -> ast.Module:
    """The module's code with its docstrings dropped and, in the port's
    copy, its relative imports of port packages put back to the
    reference's absolute ones (``from ..sync import`` →
    ``from testground_tpu.sync import``)."""
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
        if port and isinstance(node, ast.ImportFrom) and node.level == 2:
            node.module, node.level = f"testground_tpu.{node.module}", 0
    return tree


COPIES = ["sdk/__init__.py", "sdk/events.py", "sdk/invoke.py", "sdk/metrics_api.py",
          "sdk/network.py", "sdk/runenv.py", "sdk/runparams.py",
          "builders/exec_py.py", "builders/exec_bin.py", "runners/local_exec.py",
          "healthcheck/checkers.py", "healthcheck/fixers.py"]


@pytest.mark.parametrize("rel", COPIES)
def test_code_copies_equal_the_reference_but_imports(rel):
    ref = _code(os.path.join(REF_DIR, rel), port=False)
    port = _code(os.path.join(PORT_DIR, rel), port=True)
    if rel == "runners/local_exec.py":
        # the port's runner interface passes the run's config
        hc = [n for n in ast.walk(port)
              if isinstance(n, ast.FunctionDef) and n.name == "healthcheck"][0]
        assert [a.arg for a in hc.args.args][-1] == "config"
        hc.args.args.pop()
        hc.args.defaults.pop()
    assert ast.dump(port) == ast.dump(ref)


def test_shared_definitions_equal_the_reference():
    pairs = [(ref_base, port_base, "snapshot_plan_sources"),
             (ref_pretty, port_pretty, "PrettyPrinter"),
             (ref_result.Result, port_result.Result, "add_outcome"),
             (ref_result.Result, port_result.Result, "total_instances")]
    for ref_obj, port_obj, name in pairs:
        assert inspect.getsource(getattr(port_obj, name)) == \
            inspect.getsource(getattr(ref_obj, name)), name
    assert port_base._SNAPSHOT_IGNORE == ref_base._SNAPSHOT_IGNORE
    assert port_pretty._CLASS == ref_pretty._CLASS
    import testground_tpu.sdk as ref_sdk
    import testground_tpu_torch.sdk as port_sdk

    assert port_sdk.__all__ == ref_sdk.__all__


# ------------------------------------------------------ the plan copies


def _plan_files(root):
    out = []
    for dirpath, dirnames, files in os.walk(root):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        out += [os.path.relpath(os.path.join(dirpath, f), root) for f in files]
    return sorted(out)


EXEC_PLANS = ["example", "example-cpp", "example-js", "example-perl", "polyglot"]
# the reference's JS and Perl plans cite the testground project's own JS
# plan by a path on one machine; the copies cite it by project
UPSTREAM = (re.compile(r"\(/[a-z]+/reference/plans/"), "(the testground project's plans/")


# the files the port copied into a plan beside its sim edition, and the one
# line each may change
BESIDE_SIM = {
    "placebo": {"main.py": ("from testground_tpu.sdk import invoke_map",
                            "from testground_tpu_torch.sdk import invoke_map")},
    "network": {"main.py": ("from testground_tpu.sdk import invoke_map",
                            "from testground_tpu_torch.sdk import invoke_map")},
    "benchmarks": {"_compositions/flood-bucketed.toml": ('runner = "sim:jax"',
                                                         'runner = "sim:torch"'),
                   "grafana-dashboard/dashboard.json": None},
}


@pytest.mark.parametrize("plan", EXEC_PLANS + list(BESIDE_SIM))
def test_plan_copy_equals_its_original_but_the_import_line(plan):
    ref_root, port_root = os.path.join(REF_PLANS, plan), os.path.join(PORT_PLANS, plan)
    files = _plan_files(port_root)
    if plan in BESIDE_SIM:  # the exec edition and the files beside the port's sim.py
        assert set(BESIDE_SIM[plan]) <= set(files)
        files = sorted(BESIDE_SIM[plan])
    else:
        assert files == _plan_files(ref_root)
    assert files
    for rel in files:
        ref_p, port_p = os.path.join(ref_root, rel), os.path.join(port_root, rel)
        with open(ref_p, "rb") as f:
            ref = f.read()
        with open(port_p, "rb") as f:
            port = f.read()
        mode = stat.S_IMODE(os.stat(port_p).st_mode) & 0o111
        assert mode == stat.S_IMODE(os.stat(ref_p).st_mode) & 0o111, rel
        if rel == "manifest.toml":
            assert port == ref.replace(b"sim:jax", b"sim:torch"), rel
            continue
        ref_lines = UPSTREAM[0].sub(UPSTREAM[1], ref.decode()).splitlines()
        port_lines = port.decode().splitlines()
        assert len(ref_lines) == len(port_lines), rel
        diff = [(a, b) for a, b in zip(ref_lines, port_lines) if a != b]
        if plan in BESIDE_SIM:
            want = BESIDE_SIM[plan][rel]
            assert diff == ([] if want is None else [want]), rel
        else:
            assert diff == ([("from testground_tpu.sdk import invoke_map",
                              "from testground_tpu_torch.sdk import invoke_map")]
                            if rel == "main.py" else []), rel


def test_no_reference_plan_file_is_missing_from_the_port():
    """Every file of the reference's plans has its port counterpart."""
    for plan in sorted(os.listdir(REF_PLANS)):
        if os.path.isdir(os.path.join(REF_PLANS, plan)):
            missing = set(_plan_files(os.path.join(REF_PLANS, plan))) - set(
                _plan_files(os.path.join(PORT_PLANS, plan)))
            assert not missing, (plan, sorted(missing))


@pytest.mark.parametrize("plan", ["placebo", "network"])
def test_placebo_manifest_differs_from_the_reference_only_in_its_defaults(plan):
    def load(root):
        with open(os.path.join(root, plan, "manifest.toml"), "rb") as f:
            return tomllib.load(f)

    ref, port = load(REF_PLANS), load(PORT_PLANS)
    assert ref.pop("defaults") == {"placebo": {"builder": "exec:py", "runner": "local:exec"},
                                   "network": {"builder": "sim:plan", "runner": "sim:jax"}}[plan]
    assert port.pop("defaults") == {"builder": "sim:plan", "runner": "sim:torch"}
    ref["runners"]["sim:torch"] = ref["runners"].pop("sim:jax")
    assert port == ref


# ------------------------------------------------------ RunParams


def _seeded_params(mod, seed):
    rng = np.random.default_rng(seed)

    def word(k=6):
        return "".join(chr(97 + int(c)) for c in rng.integers(0, 26, k))

    return mod.RunParams(
        test_plan=word(), test_case=word(), test_run=word(20),
        test_instance_count=int(rng.integers(1, 10_000)), test_group_id=word(4),
        test_group_instance_count=int(rng.integers(1, 100)),
        test_instance_params={word(3): word(int(rng.integers(0, 5)))
                              for _ in range(int(rng.integers(0, 4)))},
        test_subnet=f"10.{int(rng.integers(256))}.0.0/16",
        test_sidecar=bool(rng.integers(2)), test_outputs_path="/o/" + word(),
        test_temp_path="/t/" + word(), test_start_time=float(rng.random() * 1e9),
        test_capture_profiles={"cpu": word()} if rng.integers(2) else {},
        test_disable_metrics=bool(rng.integers(2)),
        test_instance_seq=int(rng.integers(1000)), test_group_seq=int(rng.integers(100)),
        sync_service_host=f"127.0.0.{int(rng.integers(1, 255))}",
        sync_service_port=int(rng.integers(0, 65536)),
        sync_connect_timeout=float(rng.integers(1, 60)),
        sync_retry_attempts=int(rng.integers(1, 20)),
        sync_retry_deadline=float(rng.random() * 100),
        sync_heartbeat=float(rng.integers(0, 10)),
        test_traceparent=f"00-{word(32)}-{word(16)}-01" if rng.integers(2) else "",
    )


@pytest.mark.parametrize("seed", range(6))
def test_runparams_env_equals_the_reference_and_round_trips(seed):
    ref, port = _seeded_params(ref_runparams, seed), _seeded_params(port_runparams, seed)
    env = port.to_env()
    assert env == ref.to_env()
    assert list(env) == list(ref.to_env())
    assert port_runparams.RunParams.from_env(env) == port
    assert ref_runparams.RunParams.from_env(env) == ref
    assert port_runparams.RunParams.from_env({}) == port_runparams.RunParams()


# ------------------------------------------------------ events and metrics


def _masked(text):
    return [re.sub(r'"ts": \d+', '"ts": 0', ln) for ln in text.splitlines()]


def _emit_all(mod):
    buf, second = io.StringIO(), io.StringIO()
    e = mod.EventEmitter(buf, None, second)
    e.start({"plan": "p", "case": "c", "instances": 3})
    e.message("hello ✓")
    e.metric({"name": "m", "value": 1.5})
    e.stage_start("s1")
    e.stage_end("s1")
    e.failure("oops")
    e.crash("boom", "Traceback ...\n  line")
    e.success()
    e.emit({"type": "custom", "x": [1, 2]})
    assert buf.getvalue() == second.getvalue()
    return buf.getvalue()


PARSE_LINES = ['{"ts": 1500000000, "event": {"type": "success"}}',
               '{"event": {"type": "message", "message": "m"}}', "not json", "",
               '{"ts": 1, "other": {}}', '{"ts": 1, "event": "x"}',
               '{"ts": 1, "event": {"no": "type"}}', "[1, 2]", "3",
               '{"ts": "7", "event": {"type": "crash"}}']


def test_event_lines_and_their_parse_equal_the_reference():
    ref, port = _emit_all(ref_events), _emit_all(port_events)
    assert _masked(port) == _masked(ref) and len(_masked(port)) == 9
    for line in PARSE_LINES + port.splitlines():
        assert port_events.parse_event_line(line) == ref_events.parse_event_line(line)


def _record_all(mod, disabled=False):
    buf = io.StringIO()
    reg = mod.MetricsRegistry("results", buf, disabled=disabled)
    c, g, h, t = reg.counter("c"), reg.gauge("g"), reg.histogram("h"), reg.timer("t")
    rng = np.random.default_rng(7)
    for v in rng.normal(size=12):
        c.inc(2)
        g.update(float(v))
        h.update(float(v))
        t.update(abs(float(v)))
    reg.record_point("p", 42.0)
    reg.resetting_histogram("rh").update(3.0)
    assert reg.counter("c") is c and reg.new_uniform_sample(5) == 5
    mod.Point(reg, "pt").record(1.0)
    return buf.getvalue()


def test_metrics_records_equal_the_reference():
    port, ref = _record_all(port_metrics), _record_all(ref_metrics)
    assert _masked(port) == _masked(ref) and len(_masked(port)) == 12 * 4 + 3
    assert _record_all(port_metrics, disabled=True) == "" == \
        _record_all(ref_metrics, disabled=True)
    assert port_metrics.MetricsRegistry("d", None).record("x", "point", {}) is None


# ------------------------------------------------------ invoke_map as a process

PLAN = '''import sys
from {pkg}.sdk import invoke_map


def ok(runenv):
    runenv.record_message("fine %d", runenv.int_param("n"))
    runenv.R().counter("c").inc()


def fail(runenv):
    return "failing on purpose"


def crash(runenv):
    raise RuntimeError("crashing on purpose")


def init(runenv, initctx):
    assert initctx.sync_client is None and initctx.net_client is not None
    runenv.record_message("ip %s", initctx.net_client.get_data_network_ip())


def modules(runenv):
    loaded = sorted(m for m in ("torch", "numpy", "jax") if m in sys.modules)
    runenv.record_message("loaded %s", ",".join(loaded) or "none")


if __name__ == "__main__":
    invoke_map({{"ok": ok, "fail": fail, "crash": crash, "init": init,
                "modules": modules}})
'''


def _clean_env(**extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("TEST_", "SYNC_")) and k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    env["PYTHONPATH"] = REPO
    return {**env, **extra}


def _invoke(tmp_path, pkg, case, profile=False):
    plan = tmp_path / f"{pkg}_plan.py"
    plan.write_text(PLAN.format(pkg=pkg))
    out_dir = tmp_path / f"{pkg}-{case}-out"
    params = port_runparams.RunParams(
        test_plan="p", test_case=case, test_run="r1", test_instance_count=4,
        test_group_id="g", test_group_instance_count=4,
        test_instance_params={"n": "7"}, test_outputs_path=str(out_dir),
        test_capture_profiles={"cpu": "on"} if profile else {}, test_instance_seq=2,
        sync_service_port=0)
    proc = subprocess.run([sys.executable, str(plan)], capture_output=True, text=True,
                          env=_clean_env(**params.to_env()), cwd=tmp_path, timeout=60)
    events = [port_events.parse_event_line(ln) for ln in proc.stdout.splitlines()]
    run_out = out_dir / "run.out"
    return {"rc": proc.returncode,
            "stdout": [(e["type"], e.get("message", e.get("error", "")))
                       for _, e in filter(None, events)],
            "run.out": _masked(run_out.read_text()) if run_out.exists() else None,
            "files": sorted(os.listdir(out_dir)) if out_dir.exists() else [],
            "stderr_last": proc.stderr.strip().splitlines()[-1:]}


@pytest.mark.parametrize("case,profile", [("ok", False), ("fail", False), ("crash", False),
                                          ("init", False), ("ok", True), ("nope", False)])
def test_invoke_map_process_equals_the_reference(tmp_path, case, profile):
    port = _invoke(tmp_path, "testground_tpu_torch", case, profile)
    ref = _invoke(tmp_path, "testground_tpu", case, profile)
    if case != "crash":  # the traceback names each package's files
        assert port["run.out"] == ref["run.out"]
    assert {k: v for k, v in port.items() if k != "run.out"} == \
        {k: v for k, v in ref.items() if k != "run.out"}
    want_rc = {"ok": 0, "init": 0, "fail": 1, "crash": 1, "nope": 2}[case]
    assert port["rc"] == want_rc, port
    if case == "nope":
        assert port["stdout"] == [] and port["stderr_last"] == ["unknown test case: nope"]
        return
    types = [t for t, _ in port["stdout"]]
    assert types[0] == "start" and types[-1] == {"ok": "success", "init": "success",
                                                 "fail": "failure", "crash": "crash"}[case]
    if case == "init":
        assert ("message", "ip 127.1.0.4") in port["stdout"]
    assert ("profile-cpu.pstats" in port["files"]) == profile


def test_an_instance_of_the_port_sdk_loads_no_torch_and_no_numpy(tmp_path):
    probe = ("import sys, json; import testground_tpu_torch.sdk; "
             "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] in "
             "('torch', 'numpy', 'jax', 'testground_tpu'))))")
    proc = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                          env=_clean_env(), cwd=tmp_path, timeout=60)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout) == []
    # and a whole instance through invoke_map
    got = _invoke(tmp_path, "testground_tpu_torch", "modules")
    assert ("message", "loaded none") in got["stdout"] and got["rc"] == 0


# ------------------------------------------------------ the PrettyPrinter

CANNED = {
    "all[000]": (['{"ts": 1, "event": {"type": "start", "runenv": {"plan": "p"}}}',
                  '{"ts": 2, "event": {"type": "message", "message": "hi"}}',
                  '{"ts": 3, "event": {"type": "metric", "metric": {"v": 1}}}',
                  '{"ts": 4, "event": {"type": "stage_start", "stage": "s"}}',
                  '{"ts": 5, "event": {"type": "stage_end", "stage": "s"}}',
                  '{"ts": 6, "event": {"type": "success"}}'], []),
    "all[001]": (['{"ts": 1, "event": {"type": "start", "runenv": {}}}',
                  '{"ts": 2, "event": {"type": "failure", "error": "bad"}}'],
                 ["a warning", "", "another"]),
    "all[002]": (['{"ts": 1, "event": {"type": "crash", "error": "boom", '
                  '"stacktrace": "Traceback"}}', "plain text line", "   "], ["Traceback"]),
    "all[003]": (['{"ts": 1, "event": {"type": "start", "runenv": {}}}', "[1, 2]",
                  '{"ts": 1, "event": {"type": "weird"}}'], []),
    "all[004]": ([], []),
    "all[005]": (['{"ts": 1, "event": {"type": "success"}}',
                  '{"ts": 2, "event": {"type": "failure", "error": "late"}}'], []),
}


def _print_canned(rpc, pretty_mod):
    echo = io.StringIO()
    pp = pretty_mod.PrettyPrinter(rpc.OutputWriter(sink=None, echo=echo))
    for iid, (out, err) in CANNED.items():
        pp.manage(iid, io.StringIO("".join(ln + "\n" for ln in out)),
                  io.StringIO("".join(ln + "\n" for ln in err)))
    failed = pp.wait(timeout=10)
    assert pp.drained()
    pp.fail_start("all[006]", "exec format error")
    lines = [re.sub(r"^ *\d+\.\d{4}s", "<t>", ln) for ln in echo.getvalue().splitlines()]
    return {"failed": failed, "after_start": pp.wait(timeout=1),
            # stdout and stderr are read by two threads: each stream's own
            # order, and the multiset
            "by_instance": {iid: [ln for ln in lines if f"<< {iid} >>" in ln
                                  and "ERROR" not in ln] for iid in CANNED},
            "sorted": sorted(lines)}


def test_pretty_printer_writes_the_references_lines():
    import testground_tpu.rpc as ref_rpc
    import testground_tpu_torch.rpc as port_rpc

    port = _print_canned(port_rpc, port_pretty)
    assert port == _print_canned(ref_rpc, ref_pretty)
    assert port["failed"] == 5 and port["after_start"] == 6
    assert "<t>           OK << all[000] >> " in port["sorted"]
    assert "<t>   INCOMPLETE << all[006] >> failed to start: exec format error" in \
        port["sorted"]


# ------------------------------------------------------ the healthcheck


def _report(pkg, home, runner_cfg=None, squat=False, remove=False):
    if pkg == "jax":
        from testground_tpu.config import EnvConfig
        from testground_tpu.rpc import discard_writer
        from testground_tpu.runners.local_exec import LocalExecRunner
    else:
        from testground_tpu_torch.config import EnvConfig
        from testground_tpu_torch.rpc import discard_writer
        from testground_tpu_torch.runners.local_exec import LocalExecRunner
    env = EnvConfig.load(home=str(home))
    if remove or squat:
        shutil.rmtree(env.dirs.outputs())
    if squat:
        with open(env.dirs.outputs(), "w") as f:
            f.write("squatter")
    if runner_cfg is not None:
        env.runners["local:exec"] = dict(runner_cfg)
    got = []
    for fix in (False, True):
        r = LocalExecRunner().healthcheck(fix, discard_writer(), env=env)
        got.append({"ok": r.ok(),
                    "checks": [(c.name, c.status, c.message) for c in r.checks],
                    "fixes": [(c.name, c.status) for c in r.fixes]})
    text = json.dumps(got).replace(str(home), "<home>")
    return json.loads(re.sub(r"(bound 127\.0\.0\.1:)\d+", r"\1<port>", text))


def _chatty_listener():
    """A TCP listener that answers every connection with a line that is
    not the sync protocol's."""
    import threading

    lis = socket.socket()
    lis.bind(("127.0.0.1", 0))
    lis.listen(8)

    def serve():
        while True:
            try:
                conn, _ = lis.accept()
            except OSError:
                return
            with conn:
                conn.sendall(b"HTTP/1.0 400 Bad Request\n")

    threading.Thread(target=serve, daemon=True).start()
    return lis


def test_silent_listener_fails_the_ping_check_as_the_references():
    import testground_tpu.healthcheck.checkers as ref_checkers
    import testground_tpu_torch.healthcheck.checkers as port_checkers

    lis = socket.socket()
    lis.bind(("127.0.0.1", 0))
    lis.listen(1)
    try:
        host, port = lis.getsockname()
        got = [mod.check_sync_service(host, port, timeout=0.3)()
               for mod in (port_checkers, ref_checkers)]
    finally:
        lis.close()
    assert got[0] == got[1] and not got[0][0]


@pytest.mark.parametrize("case", ["healthy", "missing-dir", "squatted-dir", "unbindable",
                                  "remote-ok", "remote-dead", "remote-chatty",
                                  "remote-malformed"])
def test_healthcheck_equals_the_reference(tmp_path, case):
    from testground_tpu_torch.sync import SyncServiceServer

    srv = lis = None
    cfg, kw = None, {}
    try:
        if case in ("missing-dir", "squatted-dir"):
            kw = {"remove": True, "squat": case == "squatted-dir"}
        elif case == "unbindable":
            cfg = {"sync_bind_host": "192.0.2.1"}  # TEST-NET-1: never local
        elif case in ("remote-ok", "remote-dead"):
            srv = SyncServiceServer().start()
            cfg = {"sync_service_address": "%s:%d" % srv.address}
            if case == "remote-dead":
                srv.stop()
                srv = None
        elif case == "remote-chatty":
            lis = _chatty_listener()
            cfg = {"sync_service_address": "%s:%d" % lis.getsockname()}
        elif case == "remote-malformed":
            cfg = {"sync_service_address": "host:port"}
        got = {pkg: _report(pkg, tmp_path / pkg, cfg, **kw) for pkg in ("jax", "torch")}
    finally:
        if srv is not None:
            srv.stop()
        if lis is not None:
            lis.close()
    if case == "remote-ok":  # each answer names the server's boot id
        for rep in got.values():
            for run in rep:
                run["checks"] = [(n, s, re.sub(r" \(boot \w+\)", "", m))
                                 for n, s, m in run["checks"]]
    assert got["torch"] == got["jax"]
    names = [c[0] for c in got["torch"][0]["checks"]]
    assert names[:3] == ["outputs-dir-writable", "work-dir-writable",
                         "sync-service-port-bindable"]
    assert names[-1] == "python-interpreter-runs"
    status = {c[0]: c[1] for c in got["torch"][1]["checks"]}
    want_ok = case in ("healthy", "missing-dir", "remote-ok")
    assert got["torch"][1]["ok"] == want_ok, got["torch"]
    if case.startswith("remote"):
        assert status["sync-service-reachable"] == ("ok" if want_ok else "failed")


# ------------------------------------------------------ the daemon's artifacts

ARTIFACT_NAMES = ["single/0/profile-cpu.pstats", "g/1/profile-cpu.pstats",
                  "run/g/2/profile-cpu.pstats", "a/b/c/d/profile-cpu.pstats",
                  "../0/profile-cpu.pstats", "g/./profile-cpu.pstats", "g//profile-cpu.pstats",
                  "g/0/other.pstats", "profile-cpu.pstats", "g\\0/profile-cpu.pstats",
                  "run_spans.jsonl", "checkpoints/ckpt-250.npz"]


@pytest.mark.parametrize("name", ARTIFACT_NAMES)
def test_daemon_serves_instance_profiles_as_the_reference(name):
    """A ``local:exec`` instance's cProfile dump (``<group>/<i>/
    profile-cpu.pstats``) is an artifact the daemon serves, under the
    reference's rule for nested names."""
    from testground_tpu.daemon.server import _Handler as RefHandler
    from testground_tpu_torch.daemon.server import _Handler as PortHandler

    assert PortHandler._artifact_relpath(name) == RefHandler._artifact_relpath(name)
