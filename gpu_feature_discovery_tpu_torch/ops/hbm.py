"""HBM read-bandwidth probe (twin: ``gpu_feature_discovery_tpu/ops/hbm.py``).

The second axis of device health next to the matmul burn-in
(healthcheck.py): degraded HBM shows up as low sustained read bandwidth
even while matmuls still produce finite numbers. The probe sums a
``(rows, 128)`` f32 buffer with a hand-written CUDA kernel
(``csrc/hbm_stream_sum.cu``, the port of the twin's Pallas
``_bandwidth_kernel``); the reduction consumes every byte, so no load can
be elided, and the buffer's per-chunk pattern makes the sum an exact
checksum.

The kernel is one launch on a persistent grid: a TMA ring per block over
its contiguous range of 32 KiB tiles (``tile_ranges``), and the last block
to finish adds the blocks' partials. It is compiled with ``nvcc`` for
``sm_90a`` at first use into the kernel cache (``kernel_cache.py``:
``--compilation-cache-dir``, by default ``build/torch_kernels/`` at the
repo root, which ``.gitignore`` lists) and loaded with ``ctypes``.
Nothing is built or loaded at import.

``hbm_stream_sum`` on a CPU tensor computes the plain version,
``hbm_stream_sum_reference``; on a CUDA tensor it launches the kernel or
raises — it never falls back.
"""

from __future__ import annotations

import ctypes
import functools
import statistics
import threading
import time
from pathlib import Path
from typing import Optional, Tuple

import torch

from gpu_feature_discovery_tpu_torch.ops import kernel_cache
from gpu_feature_discovery_tpu_torch.ops.device_timing import DeviceClock, plane_name

LANES = 128        # the buffer is always 128 floats wide
CHUNK_ROWS = 512   # (512, 128) f32 = 256 KiB per chunk

# Stream-buffer fill pattern: every element of chunk c holds
# ``1 + c % _PATTERN_PERIOD``, so the checksum detects a chunk read twice,
# skipped, or read from the wrong place — an all-ones buffer sums
# identically whichever chunk was read. Every partial sum stays an exact
# integer: chunk sums are k*2^16 with k <= 7 and the total is m*2^16 with
# m <= 7*num_chunks (7,168 at 256 MiB), far below the f32 mantissa bound.
_PATTERN_PERIOD = 7

# One TMA copy of the kernel moves one tile: (64, 128) f32 = 32 KiB, so a
# chunk holds eight and no tile straddles two chunks.
TILE_ROWS = 64
TILES_PER_CHUNK = CHUNK_ROWS // TILE_ROWS
TILE_BYTES = TILE_ROWS * LANES * 4
# Blocks per SM of the persistent grid: one block's 128 KiB ring leaves no
# room for a second.
BLOCKS_PER_SM = 1

# Name under which the device clock (device_timing.py) files the probe.
HBM_KERNEL_NAME = "hbm_probe"

_CSRC = kernel_cache.HBM_STREAM_SUM_CU

_lib_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def build_kernel() -> Tuple[Path, str]:
    """The kernel's library, built with nvcc unless this exact source and
    flag set is already in the kernel cache (ops/kernel_cache.py). Returns
    the library path and nvcc's diagnostics (ptxas register/shared-memory
    report; "" when nothing was built). Raises KernelBuildError when the
    build cannot run or fails."""
    return kernel_cache.build_library(_CSRC)


def _kernel_library() -> ctypes.CDLL:
    """Build (first use) and load the kernel library; one per process."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib_path, _ = build_kernel()
            lib = ctypes.CDLL(str(lib_path))
            lib.hbm_stream_sum_stage_bytes.restype = ctypes.c_int
            if lib.hbm_stream_sum_stage_bytes() != TILE_BYTES:
                raise RuntimeError(
                    f"{lib_path.name} copies {lib.hbm_stream_sum_stage_bytes()} B "
                    f"tiles, the wrapper partitions {TILE_BYTES} B ones"
                )
            fn = lib.hbm_stream_sum_launch
            # Every pointer and the stream as c_void_p: an int would cut a
            # 64-bit address to 32 bits.
            fn.argtypes = [
                ctypes.c_void_p,   # buf
                ctypes.c_longlong, # tiles_base
                ctypes.c_int,      # tiles_extra
                ctypes.c_int,      # num_blocks
                ctypes.c_void_p,   # partials
                ctypes.c_void_p,   # counter
                ctypes.c_void_p,   # out
                ctypes.c_void_p,   # cudaStream_t
            ]
            fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def grid_blocks(num_tiles: int, sms: int) -> int:
    """The persistent grid: BLOCKS_PER_SM blocks per SM, never more
    blocks than tiles."""
    return max(1, min(num_tiles, BLOCKS_PER_SM * sms))


def tile_ranges(num_tiles: int, num_blocks: int) -> list:
    """Block b's contiguous tiles, as ``range``s: ``base`` tiles each and
    one more for the first ``extra`` blocks, ``(base, extra) =
    divmod(num_tiles, num_blocks)``, so loads differ by at most one tile.
    The kernel computes the same ranges from ``base`` and ``extra``."""
    base, extra = divmod(num_tiles, num_blocks)
    ranges, first = [], 0
    for b in range(num_blocks):
        count = base + (1 if b < extra else 0)
        ranges.append(range(first, first + count))
        first += count
    return ranges


@functools.lru_cache(maxsize=None)
def _grid(device: torch.device, num_tiles: int) -> Tuple[int, int, int]:
    """(blocks, base, extra) of the kernel's launch over ``num_tiles`` on
    ``device``: the persistent grid and its tile_ranges partition."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    blocks = grid_blocks(num_tiles, sms)
    return (blocks, *divmod(num_tiles, blocks))


@functools.lru_cache(maxsize=16)
def launch_scratch(device: torch.device, stream: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's scratch for one (device, stream handle): a partial per
    block and the ticket counter, zeroed once here, taken by every block
    of a launch and set back to 0 by its last block. Launches that share
    them are ordered by their stream, so no two overlap: a handle names
    one CUDA stream at a time, and torch's pooled streams that share a
    handle are that one stream. The cache keeps the last 16 (the probe
    uses one stream per device): an evicted entry's memory returns to
    the caching allocator, which hands it out again only on the stream
    it was made on (the current one here), behind any launch in flight.
    healthcheck.reset_probe_workspaces drops them all."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return (
        torch.empty(BLOCKS_PER_SM * sms, dtype=torch.float64, device=device),
        torch.zeros(1, dtype=torch.int32, device=device),
    )


def hbm_stream_sum_reference(buf: torch.Tensor) -> torch.Tensor:
    """The plain version: the (1, 1) f32 sum, accumulated in f64."""
    return buf.double().sum().float().reshape(1, 1)


def hbm_stream_sum(buf: torch.Tensor) -> torch.Tensor:
    """Sum ``buf`` ((k*CHUNK_ROWS, LANES) contiguous f32, k >= 1) into a
    (1, 1) f32 tensor on the buffer's device. A CUDA buffer runs the
    kernel in one launch (and counts it in ``hbm_stream_sum.launches``); a
    CPU buffer runs the plain version."""
    if (
        buf.ndim != 2
        or buf.shape[1] != LANES
        or buf.shape[0] % CHUNK_ROWS
        or buf.shape[0] == 0
    ):
        raise ValueError(
            f"buffer must be (k*{CHUNK_ROWS}, {LANES}), got {tuple(buf.shape)}"
        )
    if buf.dtype != torch.float32:
        raise ValueError(f"buffer must be float32, got {buf.dtype}")
    if not buf.is_contiguous():
        raise ValueError("buffer must be contiguous")
    if buf.device.type == "cpu":
        return hbm_stream_sum_reference(buf)
    if buf.device.type != "cuda":
        raise ValueError(f"buffer must be on a CUDA device or the CPU, not {buf.device}")
    if buf.data_ptr() % 16:
        raise ValueError("buffer must be 16-byte aligned (TMA bulk copies)")
    lib = _kernel_library()
    device = buf.device
    blocks, base, extra = _grid(device, buf.shape[0] // TILE_ROWS)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        partials, counter = launch_scratch(device, stream)
        out = torch.empty((1, 1), dtype=torch.float32, device=device)
        rc = lib.hbm_stream_sum_launch(
            buf.data_ptr(),
            base,
            extra,
            blocks,
            partials.data_ptr(),
            counter.data_ptr(),
            out.data_ptr(),
            stream,
        )
    if rc != 0:
        raise RuntimeError(f"hbm_stream_sum kernel launch failed: cudaError {rc}")
    hbm_stream_sum.launches += 1
    return out


hbm_stream_sum.launches = 0  # type: ignore[attr-defined]


def stream_pattern(rows: int, device="cpu") -> torch.Tensor:
    """The (rows, LANES) per-chunk-distinct probe buffer: chunk index mod
    _PATTERN_PERIOD, plus one. The one construction behind every probe
    buffer, so expected_stream_sum can never disagree with the contents."""
    chunk = torch.arange(rows, dtype=torch.int64, device=device) // CHUNK_ROWS
    column = (1 + chunk % _PATTERN_PERIOD).to(torch.float32)
    return column.reshape(rows, 1).expand(rows, LANES).contiguous()


def expected_stream_sum(rows: int) -> float:
    """Exact f32 sum of stream_pattern(rows), in integer math on the
    host. The checksum gate for both timing paths."""
    num_chunks = rows // CHUNK_ROWS
    return float(
        sum(1 + c % _PATTERN_PERIOD for c in range(num_chunks)) * CHUNK_ROWS * LANES
    )


# Tile-granular check pattern: every element of tile t holds
# ``1 + t % _TILE_PATTERN_PERIOD``. The probe's pattern changes only per
# chunk, so a ring slip between two tiles of one chunk leaves its sum
# unchanged; this one catches it. Sums stay exact: a tile sums to
# k*2^13 with k <= 13, and the total m*2^13 has m <= 13*num_tiles
# (106,496 at 256 MiB), far below the f32 mantissa bound.
_TILE_PATTERN_PERIOD = 13


def tile_pattern(rows: int, device="cpu") -> torch.Tensor:
    """The (rows, LANES) buffer whose value changes every TILE_ROWS rows:
    tile index mod _TILE_PATTERN_PERIOD, plus one."""
    tile = torch.arange(rows, dtype=torch.int64, device=device) // TILE_ROWS
    column = (1 + tile % _TILE_PATTERN_PERIOD).to(torch.float32)
    return column.reshape(rows, 1).expand(rows, LANES).contiguous()


def expected_tile_pattern_sum(rows: int) -> float:
    """Exact f32 sum of tile_pattern(rows), in integer math on the host."""
    return float(
        sum(1 + t % _TILE_PATTERN_PERIOD for t in range(rows // TILE_ROWS))
        * TILE_ROWS * LANES
    )


@functools.lru_cache(maxsize=None)
def stream_workspace(device: torch.device, rows: int) -> torch.Tensor:
    """Per-device probe buffer, built on the device once per process and
    held resident: rebuilding it each cycle would spend a fill of the
    whole buffer per probe. healthcheck.reset_probe_workspaces drops it."""
    return stream_pattern(rows, device)


def probe_rows(total_mib: int) -> int:
    """Row count of the probe buffer covering ``total_mib`` (rounded down
    to whole chunks, minimum one chunk)."""
    return max(1, (total_mib * 1024 * 1024) // (LANES * 4) // CHUNK_ROWS) * CHUNK_ROWS


def measure_hbm_bandwidth(
    total_mib: int = 256, iters: int = 4, device=None
) -> dict:
    """Time the stream sum over a ``total_mib`` buffer and report the
    sustained read bandwidth in GiB/s (median of ``iters``).

    ``device`` defaults to the current CUDA device, timed by CUDA events
    around each call, one kernel launch (device_timing.py); a CPU device runs the
    plain version on the host clock, where ``gbps`` is not a hardware
    measurement (``interpreted`` is then True, as in the twin's
    interpret mode)."""
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    rows = probe_rows(total_mib)
    buf = stream_workspace(device, rows)
    total = hbm_stream_sum(buf)  # build + warm
    on_cuda = device.type == "cuda"
    if on_cuda:
        clock = DeviceClock()
        for _ in range(iters):
            clock.time(HBM_KERNEL_NAME, device, hbm_stream_sum, buf)
        samples = clock.durations()[HBM_KERNEL_NAME][plane_name(device)]
    else:
        samples = []
        for _ in range(iters):
            t0 = time.perf_counter()
            hbm_stream_sum(buf)
            samples.append(time.perf_counter() - t0)
    sec = statistics.median(samples)
    nbytes = buf.numel() * buf.element_size()
    return {
        "gbps": nbytes / sec / 2**30,
        "seconds": sec,
        "bytes": nbytes,
        "checksum_ok": float(total.item()) == expected_stream_sum(rows),
        "interpreted": not on_cuda,
    }
