"""The kernel cache (gpu_feature_discovery_tpu_torch/ops/kernel_cache.py):
where the port's CUDA kernels are built and found, and the
``--compilation-cache-dir`` flag that names it, against the twin's flag
(gpu_feature_discovery_tpu/config/flags.py). On the CPU: no nvcc runs
here, a shell script stands in for it where a build must run."""

import os
import stat
from pathlib import Path

import pytest

from gpu_feature_discovery_tpu.config import new_config as twin_new_config
from gpu_feature_discovery_tpu.config.flags import (
    resolve_compilation_cache_dir as twin_resolve,
)
from gpu_feature_discovery_tpu_torch.cmd.main import start
from gpu_feature_discovery_tpu_torch.config.flags import (
    new_config,
    resolve_compilation_cache_dir,
)
from gpu_feature_discovery_tpu_torch.ops import hbm, kernel_cache

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture
def cache(tmp_path, monkeypatch):
    """A kernel cache directory of its own, and a toolchain with no nvcc
    (no CUDA_HOME/bin/nvcc, nothing on PATH)."""
    directory = tmp_path / "cache"
    monkeypatch.setenv(kernel_cache.RESOLVED_CACHE_DIR_ENV, str(directory))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path / "empty-bin"))
    return directory


@pytest.fixture
def source(tmp_path):
    path = tmp_path / "probe_kernel.cu"
    path.write_text("// a kernel\n")
    return path


def _fake_nvcc(tmp_path, monkeypatch, body: str) -> Path:
    """``$CUDA_HOME/bin/nvcc`` as a shell script: ``$out`` is its -o path."""
    home = tmp_path / "fake-cuda"
    (home / "bin").mkdir(parents=True)
    nvcc = home / "bin" / "nvcc"
    nvcc.write_text(
        "#!/bin/sh\n"
        'out=""; prev=""\n'
        'for a in "$@"; do [ "$prev" = "-o" ] && out="$a"; prev="$a"; done\n'
        f'echo "$0" >> "{tmp_path}/nvcc-calls"\n' + body
    )
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setenv("CUDA_HOME", str(home))
    return nvcc


def _calls(tmp_path) -> int:
    log = tmp_path / "nvcc-calls"
    return len(log.read_text().splitlines()) if log.exists() else 0


def test_build_without_nvcc_names_it_and_leaves_no_file(cache, source):
    with pytest.raises(kernel_cache.KernelBuildError, match="no nvcc"):
        kernel_cache.build_library(source)
    assert not cache.exists() or not list(cache.iterdir())


def test_failed_nvcc_leaves_no_partial_file(cache, source, tmp_path, monkeypatch):
    _fake_nvcc(tmp_path, monkeypatch,
               'echo partial > "$out"; echo "error: bad kernel" >&2; exit 2\n')
    with pytest.raises(kernel_cache.KernelBuildError,
                       match=r"(?s)nvcc failed \(2\).*bad kernel"):
        kernel_cache.build_library(source)
    assert _calls(tmp_path) == 1
    assert list(cache.iterdir()) == []


def test_unwritable_cache_directory_is_named(tmp_path, source, monkeypatch):
    # Root ignores permission bits: a path under a regular file cannot be
    # made by anyone.
    blocker = tmp_path / "a-file"
    blocker.write_text("")
    monkeypatch.setenv(kernel_cache.RESOLVED_CACHE_DIR_ENV, str(blocker / "cache"))
    _fake_nvcc(tmp_path, monkeypatch, 'echo lib > "$out"\n')
    with pytest.raises(kernel_cache.KernelBuildError, match="is not writable"):
        kernel_cache.build_library(source)
    assert _calls(tmp_path) == 0


def test_build_lands_under_its_key_once(cache, source, tmp_path, monkeypatch):
    _fake_nvcc(tmp_path, monkeypatch, 'echo lib > "$out"; echo "ptxas info" >&2\n')
    lib, log = kernel_cache.build_library(source)
    assert lib == kernel_cache.library_path(source)
    assert lib.parent == cache
    assert lib.name.startswith("libprobe_kernel-sm_90a-") and lib.suffix == ".so"
    assert lib.read_text() == "lib\n" and "ptxas info" in log
    assert [p.name for p in cache.iterdir()] == [lib.name]
    assert kernel_cache.build_library(source) == (lib, "")
    assert _calls(tmp_path) == 1
    # An edited source is another key: built again, the old one stays.
    source.write_text("// another kernel\n")
    assert kernel_cache.library_path(source) != lib


def test_prebuilt_library_loads_without_nvcc(cache):
    """An image without the toolkit copies the library under its key."""
    prebuilt = kernel_cache.library_path(hbm._CSRC)
    prebuilt.parent.mkdir(parents=True)
    prebuilt.write_bytes(b"\x7fELF prebuilt")
    with pytest.raises(kernel_cache.KernelBuildError):
        kernel_cache.find_nvcc()
    assert hbm.build_kernel() == (prebuilt, "")


def test_unresolved_cache_is_the_ignored_build_directory(monkeypatch):
    monkeypatch.delenv(kernel_cache.RESOLVED_CACHE_DIR_ENV, raising=False)
    assert kernel_cache.kernel_cache_dir() == REPO / "build" / "torch_kernels"
    assert "build/" in (REPO / ".gitignore").read_text().splitlines()


FLAG_CASES = {
    "auto-without-state-dir": ({}, {}),
    "auto-with-state-dir": ({"state-dir": "/var/lib/tfd"}, {}),
    "empty": ({"compilation-cache-dir": "", "state-dir": "/var/lib/tfd"}, {}),
    "path": ({"compilation-cache-dir": "/srv/kernels"}, {}),
    "env": ({"state-dir": "/var/lib/tfd"}, {"TFD_COMPILATION_CACHE_DIR": "/srv/k"}),
}


@pytest.mark.parametrize("case", sorted(FLAG_CASES))
def test_compilation_cache_dir_resolves_like_twin(case):
    cli, env = FLAG_CASES[case]
    want = twin_resolve(twin_new_config(cli_values=dict(cli), environ=dict(env)))
    got = resolve_compilation_cache_dir(new_config(cli_values=dict(cli), environ=dict(env)))
    # The twin's auto directory is <state-dir>/xla-cache; the port's holds
    # kernel libraries.
    assert got == want.replace("xla-cache", "kernel-cache")
    if case == "auto-with-state-dir":
        assert got == "/var/lib/tfd/kernel-cache"
    if case in ("auto-without-state-dir", "empty"):
        assert got == ""


def test_each_epoch_exports_the_resolved_directory(tmp_path, monkeypatch):
    """run() exports the resolution per config epoch; the broker worker
    inherits this process's environment (sandbox/probe.py)."""
    monkeypatch.setenv(kernel_cache.RESOLVED_CACHE_DIR_ENV, "stale")
    state = tmp_path / "state"
    argv = ["--oneshot", "--backends", "mock-gpu:1", "--output-file",
            str(tmp_path / "tfd")]
    assert start(argv + ["--state-dir", str(state)]) == 0
    assert os.environ[kernel_cache.RESOLVED_CACHE_DIR_ENV] == str(state / "kernel-cache")
    assert kernel_cache.kernel_cache_dir() == state / "kernel-cache"
    assert start(argv) == 0
    assert kernel_cache.RESOLVED_CACHE_DIR_ENV not in os.environ
