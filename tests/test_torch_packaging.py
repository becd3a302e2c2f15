"""Packaging of the PyTorch/CUDA port: the wheel its image installs
(deployments/torch/container/Dockerfile) must carry the kernel's CUDA
source and the console script, and run from its unpacked content.

Modelled on tests/test_packaging.py, but the wheel is built from a copy
of the port alone, as the image's build stage builds it. The image's
build stage prebuilds the kernel into a directory from the installed
copy's sources; the runtime looks the library up by a name that hashes
those bytes, so the unpacked copy must compute the checkout's name.
"""

import os
import shutil
import subprocess
import sys
import zipfile

import pytest

from gpu_feature_discovery_tpu_torch.info.version import get_version_string
from gpu_feature_discovery_tpu_torch.ops import kernel_cache
from torch_env_guard import resolved_cache_dir_restored  # noqa: F401 - autouse

HERE = os.path.dirname(os.path.abspath(__file__))
REPO_ROOT = os.path.dirname(HERE)
PORT = "gpu_feature_discovery_tpu_torch"


@pytest.fixture(scope="module")
def wheel(tmp_path_factory):
    # A copy, not the tree: an in-tree build drops build/ and .egg-info/
    # into the checkout, and a stale build/lib can resurrect deleted
    # modules into the wheel.
    src = tmp_path_factory.mktemp("src")
    for name in ("pyproject.toml", "README.md"):
        shutil.copy2(os.path.join(REPO_ROOT, name), src / name)
    shutil.copytree(os.path.join(REPO_ROOT, PORT), src / PORT,
                    ignore=shutil.ignore_patterns("__pycache__", "_build_info.py"))
    dist = tmp_path_factory.mktemp("dist")
    result = subprocess.run(
        [sys.executable, "-m", "pip", "wheel", "--no-deps", "--no-build-isolation",
         "--no-index", "-w", str(dist), str(src)],
        capture_output=True, text=True, timeout=300,
    )
    if result.returncode != 0:
        # Skip only for a missing tool; a failing build with the tools
        # present is the regression this file exists to catch.
        if "No module named" in result.stderr and any(
            tool in result.stderr for tool in ("pip", "setuptools", "wheel")
        ):
            pytest.skip(f"pip wheel unavailable: {result.stderr[-300:]}")
        pytest.fail(f"wheel build broke:\n{result.stderr[-2000:]}")
    (whl,) = dist.glob("*.whl")
    return whl


@pytest.fixture(scope="module")
def unpacked(wheel, tmp_path_factory):
    site = tmp_path_factory.mktemp("site")
    with zipfile.ZipFile(wheel) as z:
        z.extractall(site)
    return site


def _run(unpacked, code_or_args, cwd, **env_overrides):
    env = dict(os.environ)
    env.pop(kernel_cache.RESOLVED_CACHE_DIR_ENV, None)
    env["PYTHONPATH"] = str(unpacked)
    env.update(env_overrides)
    args = code_or_args if isinstance(code_or_args, list) else ["-c", code_or_args]
    return subprocess.run([sys.executable, *args], capture_output=True, text=True,
                          timeout=120, env=env, cwd=cwd)


def test_wheel_ships_the_kernel_source_and_the_console_script(wheel):
    with zipfile.ZipFile(wheel) as z:
        names = z.namelist()
        (entry_points,) = (n for n in names if n.endswith("entry_points.txt"))
        content = z.read(entry_points).decode()
    assert f"{PORT}/ops/csrc/hbm_stream_sum.cu" in names
    assert f"{PORT}/ops/kernel_cache.py" in names
    assert f"gpu-feature-discovery-torch = {PORT}.cmd.main:main" in content
    # The port alone: nothing of the JAX package rides along.
    assert not any(n.startswith("gpu_feature_discovery_tpu/") for n in names)


def test_wheel_ships_every_kernel_source(wheel):
    """Each source the kernel cache builds (and ``--prebuild`` ships), the
    burn-in's RMS epilogue among them, rides in the wheel."""
    with zipfile.ZipFile(wheel) as z:
        names = z.namelist()
    sources = [f"{PORT}/ops/csrc/{s.name}" for s in kernel_cache.KERNEL_SOURCES]
    assert f"{PORT}/ops/csrc/rms_epilogue.cu" in sources
    assert set(sources) <= set(names)


def test_version_runs_from_the_unpacked_wheel(unpacked, tmp_path):
    result = _run(unpacked, ["-m", PORT, "--version"], cwd=tmp_path)
    assert result.returncode == 0, result.stderr
    assert result.stdout.strip() == get_version_string()


def test_unpacked_copy_names_the_library_as_the_checkout_does(unpacked, tmp_path, monkeypatch):
    """The image prebuilds from its installed copy and the daemon looks
    the library up from the same copy: both must compute the checkout's
    name, so the digest covers the source's bytes and not its path."""
    directory = tmp_path / "kernels"
    result = _run(unpacked, (
        "from gpu_feature_discovery_tpu_torch.ops import kernel_cache as k\n"
        "print(k.__file__)\n"
        "print([str(k.library_path(s)) for s in k.KERNEL_SOURCES])\n"),
        cwd=tmp_path, **{kernel_cache.RESOLVED_CACHE_DIR_ENV: str(directory)})
    assert result.returncode == 0, result.stderr
    module_file, libraries = result.stdout.splitlines()
    assert module_file.startswith(str(unpacked))
    monkeypatch.setenv(kernel_cache.RESOLVED_CACHE_DIR_ENV, str(directory))
    assert libraries == str([str(kernel_cache.library_path(s))
                             for s in kernel_cache.KERNEL_SOURCES])


def test_prebuild_fails_cleanly_with_no_nvcc(unpacked, tmp_path):
    directory = tmp_path / "kernels"
    result = _run(unpacked, ["-m", f"{PORT}.ops.kernel_cache", "--prebuild", str(directory)],
                  cwd=tmp_path, PATH="", CUDA_HOME=str(tmp_path / "no-cuda"))
    assert result.returncode == 1
    assert result.stderr.startswith("prebuild failed: no nvcc")
    assert "Traceback" not in result.stderr
    assert result.stdout == ""
    assert not directory.exists()
