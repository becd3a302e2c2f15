"""``info/`` and ``--version`` of the PyTorch port: the twin's
tests/test_version.py cases against the port's ``info/stamp.py`` and
``info/version.py``. The resolution order is the contract: a generated
``_build_info.py`` > ``TFD_VERSION``/``TFD_GIT_COMMIT`` > the defaults."""

import importlib
import os
import subprocess
import sys

import pytest

from gpu_feature_discovery_tpu.info import version as twin_version
from gpu_feature_discovery_tpu_torch.info import stamp, version

HERE = os.path.dirname(os.path.abspath(__file__))
REPO_ROOT = os.path.dirname(HERE)
PACKAGE = "gpu_feature_discovery_tpu_torch"


def _env(**extra):
    env = dict(os.environ)
    env.update(extra)
    env["PYTHONPATH"] = REPO_ROOT + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_stamp_renders_importable_module(tmp_path):
    out = tmp_path / "_build_info.py"
    stamp.main(["--version", "1.2.3", "--git-commit", "abc123-dirty", "--out", str(out)])
    scope: dict = {}
    exec(out.read_text(), scope)
    assert (scope["VERSION"], scope["GIT_COMMIT"]) == ("1.2.3", "abc123-dirty")


def test_describe_git_commit_in_this_checkout():
    commit = stamp.describe_git_commit(cwd=REPO_ROOT)
    if os.path.isdir(os.path.join(REPO_ROOT, ".git")):
        # The full sha, optionally -dirty: the reference's describe recipe.
        assert len(commit.split("-")[0]) == 40
    else:
        assert commit == ""


def test_describe_git_commit_outside_checkout(tmp_path):
    assert stamp.describe_git_commit(cwd=str(tmp_path)) == ""


def test_stamp_wins_over_env(tmp_path):
    """A stamped artifact's provenance is fixed: the environment cannot
    override it."""
    out = tmp_path / "_build_info.py"
    stamp.main(["--version", "9.9.9", "--git-commit", "deadbeef", "--out", str(out)])
    probe = (
        "import sys, importlib.util\n"
        f"spec = importlib.util.spec_from_file_location('{PACKAGE}.info._build_info', "
        f"{str(out)!r})\n"
        "mod = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(mod)\n"
        f"sys.modules['{PACKAGE}.info._build_info'] = mod\n"
        f"from {PACKAGE}.info.version import get_version_string\n"
        "print(get_version_string())\n"
    )
    got = subprocess.run(
        [sys.executable, "-c", probe], env=_env(TFD_VERSION="0.0.0-env",
                                                 TFD_GIT_COMMIT="envcommit"),
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    assert got == "9.9.9-deadbeef"


def test_env_fallback_without_stamp():
    code = (f"from {PACKAGE}.info.version import get_version_string; "
            "print(get_version_string())")
    got = subprocess.run([sys.executable, "-c", code],
                         env=_env(TFD_VERSION="7.7.7", TFD_GIT_COMMIT="cafe"),
                         capture_output=True, text=True, timeout=60, check=True)
    assert got.stdout.strip() == "7.7.7-cafe"


@pytest.fixture
def no_stale_stamp():
    path = os.path.join(REPO_ROOT, PACKAGE, "info", "_build_info.py")
    assert not os.path.exists(path), (
        f"stale build stamp {path}: `make stamp-torch` output must not be "
        "committed or left around for tests")
    yield


def test_version_module_reload_order(no_stale_stamp, monkeypatch):
    monkeypatch.setenv("TFD_VERSION", "5.5.5")
    monkeypatch.setenv("TFD_GIT_COMMIT", "")
    reloaded = importlib.reload(version)
    try:
        assert reloaded.VERSION == "5.5.5"
        assert reloaded.get_version_string() == "5.5.5"
    finally:
        monkeypatch.undo()
        importlib.reload(version)


def test_make_stamp_target_matches_module():
    """The Makefile target is the release entry point; its dry run calls
    this module, so the recipe cannot drift."""
    out = subprocess.run(["make", "-n", "stamp-torch"], cwd=REPO_ROOT,
                         capture_output=True, text=True, timeout=60, check=True).stdout
    assert f"{PACKAGE}.info.stamp" in out
    assert "--git-commit" in out


def test_version_string_is_formed_as_the_twins(monkeypatch):
    for commit in ("", "abc"):
        monkeypatch.setattr(version, "VERSION", "1.0.0")
        monkeypatch.setattr(twin_version, "VERSION", "1.0.0")
        monkeypatch.setattr(version, "GIT_COMMIT", commit)
        monkeypatch.setattr(twin_version, "GIT_COMMIT", commit)
        assert version.get_version_string() == twin_version.get_version_string()
    assert version.DEFAULT_VERSION == twin_version.DEFAULT_VERSION


def test_cli_version_prints_the_string_and_imports_no_torch():
    plain = subprocess.run([sys.executable, "-m", PACKAGE, "--version"], cwd=REPO_ROOT,
                           env=_env(TFD_VERSION="3.2.1", TFD_GIT_COMMIT="f00"),
                           capture_output=True, text=True, timeout=60)
    assert (plain.returncode, plain.stdout.strip()) == (0, "3.2.1-f00")
    probe = (
        "import runpy, sys\n"
        f"sys.argv = ['{PACKAGE}', '--version']\n"
        "try:\n"
        f"    runpy.run_module('{PACKAGE}', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    print('exit', e.code, sorted(m for m in ('torch', 'numpy') if m in sys.modules))\n"
    )
    got = subprocess.run([sys.executable, "-c", probe], cwd=REPO_ROOT, env=_env(),
                         capture_output=True, text=True, timeout=60, check=True)
    assert got.stdout.splitlines()[-1] == "exit 0 []"
