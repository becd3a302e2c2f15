"""Where the port's hand-written CUDA kernels are built and found (twin:
the persistent XLA compilation cache of
``gpu_feature_discovery_tpu/utils/jaxenv.py``).

The twin's Pallas kernel compiles inside the process through XLA and
needs no toolchain; ``--compilation-cache-dir`` only keeps the compiled
executables across restarts. A kernel of this port is CUDA C++ built by
``nvcc`` into a plain C library and loaded with ``ctypes``, so the same
flag names the directory the libraries live in:

- ``configure_kernel_cache`` (``cmd/main.run``, once per config epoch)
  exports the resolved ``--compilation-cache-dir``
  (``config/flags.py:resolve_compilation_cache_dir``) through
  RESOLVED_CACHE_DIR_ENV, never through the flag's own alias, which the
  next reload must read unpolluted. Every child (the broker worker, a
  probe child) inherits it.
- Unresolved (``auto`` without ``--state-dir``, or empty), libraries go
  to ``build/torch_kernels/`` at the repo root, which ``.gitignore``
  lists: where ``python3 chip_smoke.py`` builds them.
- A library's file name carries the target (``sm_90a``) and a digest of
  its source and the nvcc flags, so an edited source or a new flag set
  never loads a stale library.
- A library already present under that name loads without ``nvcc``: an
  image that ships no CUDA toolkit copies its prebuilt libraries there.
- A build that cannot run raises ``KernelBuildError`` naming what was
  missing (no ``nvcc``, an unwritable directory, or nvcc's own errors)
  and leaves no partial file behind.
- ``kernel_cache_usable`` is the value of ``tfd_compile_cache_enabled``
  (obs/metrics.py), which ``cmd/main.run`` sets once per epoch where the
  twin sets it: 1 while the directory exists and is writable, or already
  holds every kernel's library under its key.

This module imports no torch: the labeling process configures the
directory without loading CUDA.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Tuple

# The resolved directory, which this process and its children read (the
# flag's own alias, TFD_COMPILATION_CACHE_DIR, stays the operator's).
RESOLVED_CACHE_DIR_ENV = "TFD_RESOLVED_COMPILATION_CACHE_DIR"

# build/ at the repo root; .gitignore lists it.
DEFAULT_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"

# Every hand-written kernel the probe builds (ops/hbm.py).
HBM_STREAM_SUM_CU = Path(__file__).resolve().parent / "csrc" / "hbm_stream_sum.cu"
KERNEL_SOURCES = (HBM_STREAM_SUM_CU,)

TARGET = "sm_90a"
NVCC_FLAGS = (
    "-gencode", f"arch=compute_90a,code={TARGET}",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


class KernelBuildError(RuntimeError):
    """A kernel library could not be built: the message names what was
    missing."""


def configure_kernel_cache(path: str) -> bool:
    """Export the resolved ``--compilation-cache-dir`` to this process
    and its children; an empty path restores the default directory.
    Returns ``kernel_cache_usable()``."""
    path = (path or "").strip()
    if path:
        os.environ[RESOLVED_CACHE_DIR_ENV] = path
    else:
        os.environ.pop(RESOLVED_CACHE_DIR_ENV, None)
    return kernel_cache_usable()


def kernel_cache_usable() -> bool:
    """True while the directory exists and is writable (a build can land
    there), or already holds every kernel's library under its key (an
    image's prebuilt libraries load without a build). Creates nothing."""
    directory = kernel_cache_dir()
    if directory.is_dir() and os.access(directory, os.W_OK | os.X_OK):
        return True
    return all(library_path(src).exists() for src in KERNEL_SOURCES)


def kernel_cache_dir() -> Path:
    """The directory kernel libraries are built into and loaded from."""
    raw = os.environ.get(RESOLVED_CACHE_DIR_ENV, "").strip()
    return Path(raw) if raw else DEFAULT_BUILD_DIR


def library_path(source: Path) -> Path:
    """Where the library built from ``source`` lives: its name carries
    the target and the digest of the source and the flags."""
    source = Path(source)
    digest = hashlib.sha256(
        source.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return kernel_cache_dir() / f"lib{source.stem}-{TARGET}-{digest}.so"


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc`` (default ``/usr/local/cuda``), else the
    one on ``PATH``."""
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError(
            f"no nvcc: not in {cuda_home}/bin nor on PATH; install the CUDA "
            f"toolkit, or copy a prebuilt library to {kernel_cache_dir()}"
        )
    return found


def build_library(source: Path) -> Tuple[Path, str]:
    """The library of ``source``: the one already under its name, else a
    fresh nvcc build. Returns the path and nvcc's diagnostics (the ptxas
    register and shared-memory report; "" when nothing was built)."""
    source = Path(source)
    lib = library_path(source)
    if lib.exists():
        return lib, ""
    nvcc = find_nvcc()
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    try:
        lib.parent.mkdir(parents=True, exist_ok=True)
        tmp.touch()
    except OSError as e:
        raise KernelBuildError(
            f"kernel cache directory {lib.parent} is not writable: {e}"
        ) from e
    try:
        proc = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(source)],
            capture_output=True,
            text=True,
        )
        if proc.returncode != 0:
            raise KernelBuildError(
                f"nvcc failed ({proc.returncode}) on {source}:\n{proc.stderr}"
            )
        os.replace(tmp, lib)  # atomic against a concurrent build
    finally:
        tmp.unlink(missing_ok=True)
    return lib, proc.stderr
