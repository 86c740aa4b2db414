"""The port's ``plan list|import|rm|create`` and ``describe`` against the
reference's, on the CPU: each verb through both CLIs in twin homes (the
same printed lines, home path aside, and the same ``plans/`` tree), then
``plan import`` and ``describe`` through ``--endpoint`` at each package's
daemon (``POST /plan/import``, ``GET /describe``), and the archive guards
of ``/plan/import``.

Named differences:

- ``plan create``'s ``main.py`` imports the port's plan SDK
  (``testground_tpu_torch.sdk``) where the reference's imports its own;
  the ``manifest.toml`` is the reference's byte for byte.
- A tar member that escapes the extraction directory: the port answers
  400 naming the bad archive; the reference's ``tarfile`` refusal reaches
  its HTTP boundary as a 500.
"""

import io
import json
import os
import shutil
import subprocess
import tarfile
import urllib.error
import urllib.request

import pytest

from test_torch_cli import PORT_PLANS, _cli, _make_home, jmain, pmain
from testground_tpu.config import EnvConfig as JEnvConfig
from testground_tpu.daemon import Daemon as JDaemon
from testground_tpu_torch.config import EnvConfig
from testground_tpu_torch.daemon import Daemon

MAINS = {"jax": jmain, "torch": pmain}
SDK = {"jax": "testground_tpu.sdk", "torch": "testground_tpu_torch.sdk"}


def _tree(root):
    """Every file under ``root``: relative path → bytes."""
    out = {}
    for dirpath, dirnames, files in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        for f in files:
            p = os.path.join(dirpath, f)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


def _both(tmp_path, steps):
    """Run ``steps`` (argv lists, ``{src}`` = the port's plans dir, ``{home}``
    = the home) through each package's CLI in its own home; each call's
    (rc, stdout, stderr) with the home written ``<home>``, and the homes'
    plans trees."""
    got = {}
    for pkg, main in MAINS.items():
        home = _make_home(tmp_path, pkg, "", ())
        calls = []
        for argv in steps:
            argv = [a.format(src=PORT_PLANS, home=home) for a in argv]
            rc, out, err = _cli(main, home, argv)
            calls.append((rc, out.replace(str(home), "<home>"),
                          err.replace(str(home), "<home>")))
        got[pkg] = {"calls": calls, "tree": _tree(home / "plans")}
    return got


LIFECYCLE = [
    ["plan", "list"],
    ["plan", "import", "--from", "{src}/placebo"],
    ["plan", "import", "--from", "{src}/network", "--name", "net2"],
    ["plan", "import", "--from", "{src}/network", "--name", "net2"],
    ["plan", "import", "--from", "{src}/chaos", "--name", "net2", "--force"],
    ["plan", "import", "--from", "{home}"],
    ["plan", "list"],
    ["plan", "list", "--testcases"],
    ["describe", "placebo"],
    ["describe", "placebo:metrics"],
    ["describe", "net2:chaos-barrier"],
    ["describe", "placebo:nope"],
    ["describe", "nope"],
    ["plan", "rm", "net2"],
    ["plan", "rm", "net2"],
    ["plan", "list", "--testcases"],
]


def test_plan_lifecycle_matches_jax(tmp_path):
    got = _both(tmp_path, LIFECYCLE)
    assert got["torch"] == got["jax"]
    calls = dict(zip(map(tuple, LIFECYCLE), got["torch"]["calls"]))
    # not vacuous
    assert calls[("plan", "import", "--from", "{src}/placebo")] == (
        0, "imported plan placebo -> <home>/plans/placebo\n", "")
    assert calls[("plan", "import", "--from", "{src}/network", "--name", "net2")][0] == 1
    assert "pass --force to replace" in got["torch"]["calls"][3][2]
    assert "placebo:metrics" in got["torch"]["calls"][7][1]
    assert "chaos-barrier" in got["torch"]["calls"][10][1]  # net2 was replaced by chaos
    assert got["torch"]["calls"][5][0] == 1 and "no manifest.toml" in got["torch"]["calls"][5][2]
    assert calls[("describe", "placebo:nope")][0] == 1
    assert got["torch"]["calls"][-1][1].splitlines()[0] == "placebo"
    assert sorted({p.split("/")[0] for p in got["torch"]["tree"]}) == ["placebo"]


def test_plan_create_matches_jax_but_for_the_sdk(tmp_path):
    got = _both(tmp_path, [["plan", "create", "myplan"], ["plan", "create", "myplan"],
                           ["plan", "list", "--testcases"], ["describe", "myplan:ok"]])
    port, ref = got["torch"], got["jax"]
    assert port["calls"] == ref["calls"]
    assert port["calls"][0] == (0, "created plan myplan at <home>/plans/myplan\n", "")
    assert port["calls"][1][0] == 1 and "already exists" in port["calls"][1][2]
    assert port["calls"][2][1] == "myplan\n  myplan:ok\n"
    assert sorted(port["tree"]) == sorted(ref["tree"]) == ["myplan/main.py",
                                                             "myplan/manifest.toml"]
    assert port["tree"]["myplan/manifest.toml"] == ref["tree"]["myplan/manifest.toml"]
    main = {pkg: got[pkg]["tree"]["myplan/main.py"].decode() for pkg in got}
    assert f"from {SDK['torch']} import invoke_map" in main["torch"]
    assert main["torch"].replace(SDK["torch"], SDK["jax"]) == main["jax"]


def test_plan_import_from_git_matches_jax(tmp_path):
    """``--git`` clones with the git binary; a repository made here with
    ``git init`` is a local path, so nothing reaches a network."""
    repo = tmp_path / "repo" / "myplan.git"
    shutil.copytree(os.path.join(PORT_PLANS, "placebo"), repo)
    env = {**os.environ, "GIT_CONFIG_GLOBAL": os.devnull, "GIT_CONFIG_NOSYSTEM": "1"}
    for argv in (["init", "-q"], ["add", "-A"],
                 ["-c", "user.email=t@example.com", "-c", "user.name=t", "commit", "-qm", "p"]):
        subprocess.run(["git", "-C", str(repo), *argv], check=True, env=env,
                       capture_output=True)
    got = _both(tmp_path / "homes", [
        ["plan", "import", "--git", "--from", str(repo)],
        ["plan", "import", "--git", "--from", str(repo), "--name", "other"],
        ["plan", "import", "--git", "--from", str(tmp_path / "no-such-repo"), "--name", "x"],
        ["plan", "list"],
    ])
    assert got["torch"] == got["jax"]
    calls = got["torch"]["calls"]
    assert calls[0] == (0, "imported plan myplan -> <home>/plans/myplan\n", "")
    assert calls[2][0] == 1 and "git clone failed" in calls[2][2]
    assert calls[3][1] == "myplan\nother\n"
    assert not any(".git" in p.split("/") for p in got["torch"]["tree"])


@pytest.fixture(scope="module")
def daemons(tmp_path_factory):
    root = tmp_path_factory.mktemp("plan-daemons")
    out = {}
    try:
        for pkg, cls, env_cls in (("jax", JDaemon, JEnvConfig), ("torch", Daemon, EnvConfig)):
            home = _make_home(root / "daemon", pkg, "", ())
            d = cls(env=env_cls.load(home=str(home)), listen="127.0.0.1:0")
            d.start()
            out[pkg] = {"daemon": d, "home": home, "ep": d.address,
                        "client_home": _make_home(root / "client", pkg, "", ())}
        yield out
    finally:
        for d in out.values():
            d["daemon"].stop()


ENDPOINT_STEPS = [
    ["plan", "import", "--from", "{src}/network", "--name", "net-imported"],
    ["describe", "net-imported"],
    ["describe", "net-imported:pingpong-sustained"],
    ["plan", "import", "--from", "{src}/placebo"],
    ["describe", "placebo:ok"],
    ["describe", "nope"],
]


def test_plan_import_and_describe_through_endpoint_match_jax(daemons):
    got = {}
    for pkg, d in daemons.items():
        calls = []
        for argv in ENDPOINT_STEPS:
            argv = [a.format(src=PORT_PLANS) for a in argv]
            rc, out, err = _cli(MAINS[pkg], d["client_home"], ["--endpoint", d["ep"], *argv])
            calls.append((rc, out.replace(d["ep"], "<ep>"), err))
        got[pkg] = {"calls": calls, "tree": _tree(d["home"] / "plans"),
                    "client": _tree(d["client_home"] / "plans")}
    assert got["torch"] == got["jax"]
    calls = got["torch"]["calls"]
    assert calls[0] == (0, "imported plan net-imported into daemon at <ep>\n", "")
    assert "pingpong-sustained" in calls[1][1] and calls[2][0] == 0
    assert calls[5][0] == 1
    assert got["torch"]["client"] == {}
    assert got["torch"]["tree"] == {
        **{f"net-imported/{p}": b for p, b in _tree(os.path.join(PORT_PLANS, "network")).items()},
        **{f"placebo/{p}": b for p, b in _tree(os.path.join(PORT_PLANS, "placebo")).items()},
    }


def _tgz(members):
    """A tar.gz of (TarInfo kwargs, bytes or None) members."""
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w:gz") as tar:
        for kw, data in members:
            ti = tarfile.TarInfo(kw.pop("name"))
            for k, v in kw.items():
                setattr(ti, k, v)
            if data is not None:
                ti.size = len(data)
            tar.addfile(ti, io.BytesIO(data) if data is not None else None)
    return buf.getvalue()


MANIFEST = b'name = "p"\n'
ARCHIVES = {
    "escaping-member": ("", _tgz([({"name": "p/manifest.toml"}, MANIFEST),
                                  ({"name": "../escaped.txt"}, b"x")])),
    "absolute-member": ("", _tgz([({"name": "p/manifest.toml"}, MANIFEST),
                                  ({"name": "/tmp/escaped.txt"}, b"x")])),
    "link-out": ("", _tgz([({"name": "p/manifest.toml"}, MANIFEST),
                           ({"name": "p/out", "type": tarfile.SYMTYPE,
                             "linkname": "../../../etc"}, None)])),
    "name-with-separator": ("?name=a%2Fb", _tgz([({"name": "p/manifest.toml"}, MANIFEST)])),
    "name-dotdot": ("?name=..", _tgz([({"name": "p/manifest.toml"}, MANIFEST)])),
    "no-manifest": ("", _tgz([({"name": "p/sim.py"}, b"")])),
    "not-gzip": ("", b"not a tarball"),
}


def _post(ep, route, data):
    req = urllib.request.Request(ep + route, data=data, method="POST",
                                 headers={"Content-Type": "application/gzip"})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.mark.parametrize("name", list(ARCHIVES))
def test_plan_import_refuses_a_bad_archive(name, daemons):
    query, data = ARCHIVES[name]
    got = {pkg: _post(d["ep"], "/plan/import" + query, data) for pkg, d in daemons.items()}
    code, doc = got["torch"]
    assert code == 400 and doc["error"], doc
    # an absolute member is extracted under the directory (the data filter
    # strips its leading slash), so that archive holds no single plan dir
    if name in ("escaping-member", "link-out", "not-gzip"):
        # the port names the bad archive; the reference answers 500
        assert doc["error"].startswith("bad plan archive: ")
        assert got["jax"][0] == 500
    else:
        assert got["torch"] == got["jax"]
    for d in daemons.values():
        plans = d["home"] / "plans"
        assert not (plans.parent / "escaped.txt").exists()
        assert not os.path.lexists(plans / "p" / "out")
