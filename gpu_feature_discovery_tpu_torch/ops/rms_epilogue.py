"""The burn-in pass's RMS epilogue (ops/healthcheck.py ``burnin_step``):
after each product ``y = carry @ w`` in f32, ``rms = sqrt(mean(y^2) +
1e-6)`` and ``carry = (y / rms)`` in the matmul dtype, and after the last
layer the checksum ``carry.float().sum()``.

The twin writes these lines as plain jnp and leaves them to XLA's fusion;
plain PyTorch runs them as a pass over device memory each. On a CUDA
tensor this module runs them as two hand-written kernels per layer
(``csrc/rms_epilogue.cu``): a sum of squares whose last block writes the
device ``rms``, then a scale-and-cast that also folds the checksum into
the last layer. Both launch on PyTorch's current stream with no host sync,
so the burn-in graph captures them like the kernels they replace. The
library is built with ``nvcc`` for ``sm_90a`` at first use into the kernel
cache (``kernel_cache.py``) and loaded with ``ctypes``; nothing is built
or loaded at import.

``rms_epilogue`` on a CPU tensor computes the plain version,
``rms_epilogue_reference``; on a CUDA tensor it launches the kernels or
raises — it never falls back.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from pathlib import Path
from typing import Optional, Tuple

import torch

from gpu_feature_discovery_tpu_torch.ops import kernel_cache

EPS = 1e-6

# The kernels' launch shape (csrc/rms_epilogue.cu, checked at load): each
# thread takes vectors of VECTOR floats in a grid-stride loop, THREADS to
# a block, at most BLOCKS_PER_SM blocks per SM.
THREADS = 512
VECTOR = 8
BLOCKS_PER_SM = 2

_CSRC = kernel_cache.RMS_EPILOGUE_CU

_lib_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def build_kernel() -> Tuple[Path, str]:
    """The kernels' library, built with nvcc unless this exact source and
    flag set is already in the kernel cache (ops/kernel_cache.py). Returns
    the library path and nvcc's diagnostics ("" when nothing was built).
    Raises KernelBuildError when the build cannot run or fails."""
    return kernel_cache.build_library(_CSRC)


def _kernel_library() -> ctypes.CDLL:
    """Build (first use) and load the kernel library; one per process."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib_path, _ = build_kernel()
            lib = ctypes.CDLL(str(lib_path))
            shape = (lib.rms_epilogue_block_threads(), lib.rms_epilogue_vector_floats(),
                     lib.rms_epilogue_blocks_per_sm())
            if shape != (THREADS, VECTOR, BLOCKS_PER_SM):
                raise RuntimeError(
                    f"{lib_path.name} launches (threads, vector, blocks per SM) "
                    f"{shape}, the wrapper sizes {(THREADS, VECTOR, BLOCKS_PER_SM)}"
                )
            fn = lib.rms_epilogue_launch
            # Every pointer and the stream as c_void_p: an int would cut a
            # 64-bit address to 32 bits.
            fn.argtypes = [
                ctypes.c_void_p,    # y
                ctypes.c_longlong,  # n
                ctypes.c_int,       # num_blocks
                ctypes.c_void_p,    # partials
                ctypes.c_void_p,    # counter
                ctypes.c_void_p,    # rms
                ctypes.c_void_p,    # carry
                ctypes.c_void_p,    # checksum, or None
                ctypes.c_void_p,    # cudaStream_t
            ]
            fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def grid_blocks(numel: int, sms: int) -> int:
    """The persistent grid over ``numel`` elements on ``sms`` SMs: a
    thread per vector of VECTOR floats at most, BLOCKS_PER_SM blocks per
    SM at most, and always one block (for a tail shorter than a
    vector)."""
    vectors = numel // VECTOR
    return max(1, min(-(-vectors // THREADS), BLOCKS_PER_SM * sms))


@functools.lru_cache(maxsize=None)
def _device_sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


# (device, stream handle) -> (partials, counter); see launch_scratch.
_scratch: dict = {}
_scratch_lock = threading.Lock()


def launch_scratch(device: torch.device, stream: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernels' scratch for one (device, stream handle): an f64
    partial per block of the largest grid and the ticket counter, zeroed
    once here, taken by every block of a launch and set back to 0 by its
    last block. Launches that share them are ordered by their stream. A
    graph captures the pointers of its stream's scratch, so an entry is
    kept until reset_scratch (healthcheck.reset_probe_workspaces drops
    the graphs with it), and is never made inside a capture, where its
    zeroing would not run: the capturing code calls this first, outside
    the capture, with the capture's stream current."""
    key = (device, stream)
    with _scratch_lock:
        entry = _scratch.get(key)
        if entry is None:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    "rms_epilogue: no launch scratch for the capturing stream; call "
                    "rms_epilogue.launch_scratch(device, stream) before the capture"
                )
            entry = (
                torch.empty(BLOCKS_PER_SM * _device_sms(device), dtype=torch.float64,
                            device=device),
                torch.zeros(1, dtype=torch.int32, device=device),
            )
            _scratch[key] = entry
        return entry


def reset_scratch() -> None:
    """Drop every stream's scratch (after the graphs that captured it)."""
    with _scratch_lock:
        _scratch.clear()


def rms_epilogue_reference(
    y: torch.Tensor, dtype: torch.dtype, checksum: bool = False
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """The plain version: the lines ``burnin_step`` runs on the CPU.
    Returns ``(carry, rms, checksum)``, the checksum None unless asked
    for."""
    # RMS-normalise in f32, then return to the matmul dtype: keeps the
    # chain bounded at any depth.
    rms = torch.sqrt(torch.mean(torch.square(y)) + EPS)
    carry = (y / rms).to(dtype)
    return carry, rms, carry.float().sum() if checksum else None


def rms_epilogue(
    y: torch.Tensor, dtype: torch.dtype, checksum: bool = False
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """RMS-normalise ``y`` (a contiguous non-empty 2-D f32 tensor) into
    ``(carry, rms, checksum)``: ``carry`` in ``dtype``, ``rms`` a 0-d f32,
    ``checksum`` the 0-d f32 sum of the carry widened to f32 when
    ``checksum`` is set, else None. A CUDA tensor runs the two kernels
    (``dtype`` bfloat16 only; counted in ``rms_epilogue.launches``); a
    CPU tensor runs the plain version."""
    if y.ndim != 2 or y.numel() == 0:
        raise ValueError(f"y must be a non-empty 2-D tensor, got shape {tuple(y.shape)}")
    if y.dtype != torch.float32:
        raise ValueError(f"y must be float32, got {y.dtype}")
    if not y.is_contiguous():
        raise ValueError("y must be contiguous")
    if y.device.type == "cpu":
        return rms_epilogue_reference(y, dtype, checksum)
    if y.device.type != "cuda":
        raise ValueError(f"y must be on a CUDA device or the CPU, not {y.device}")
    if dtype != torch.bfloat16:
        raise ValueError(f"the kernel writes a bfloat16 carry, not {dtype}")
    return _launch(y, checksum)


def _launch(
    y: torch.Tensor, checksum: bool, sms: Optional[int] = None
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """rms_epilogue's launch on a checked CUDA tensor, counted in
    ``rms_epilogue.launches`` (two kernels a call). ``sms`` sizes the
    persistent grid for that many SMs instead of the device's (at most
    the device's): the grid a MIG device of that many SMs gives the
    kernels, which only the tests and the smoke script ask for."""
    if y.data_ptr() % 16:
        raise ValueError("y must be 16-byte aligned (vector loads)")
    device = y.device
    device_sms = _device_sms(device)
    if sms is None:
        sms = device_sms
    elif not 1 <= sms <= device_sms:
        raise ValueError(f"sms {sms} outside 1..the device's SM count")
    blocks = grid_blocks(y.numel(), sms)
    lib = _kernel_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        partials, counter = launch_scratch(device, stream)
        carry = torch.empty(y.shape, dtype=torch.bfloat16, device=device)
        rms = torch.empty((), dtype=torch.float32, device=device)
        total = torch.empty((), dtype=torch.float32, device=device) if checksum else None
        rc = lib.rms_epilogue_launch(
            y.data_ptr(),
            y.numel(),
            blocks,
            partials.data_ptr(),
            counter.data_ptr(),
            rms.data_ptr(),
            carry.data_ptr(),
            total.data_ptr() if checksum else None,
            stream,
        )
    if rc != 0:
        raise RuntimeError(f"rms_epilogue kernel launch failed: cudaError {rc}")
    rms_epilogue.launches += 2
    return carry, rms, total


rms_epilogue.launches = 0  # type: ignore[attr-defined]
