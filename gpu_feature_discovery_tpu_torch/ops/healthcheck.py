"""Device health probes: matmul burn-in, HBM probe, per-device verdicts,
the collective probes and the slice train step (twin:
``gpu_feature_discovery_tpu/ops/healthcheck.py``).

The probe behind the health labeler (lm/health.py, gated by
--with-burnin):

- ``burnin_step`` chains bf16 matmuls with f32 output and an RMS
  normalisation after every layer, so "all outputs finite" is a
  meaningful health signal at any depth. The products are library calls
  (cuBLAS through ``torch.mm``), as the twin left them to XLA.
- The HBM probe is the hand-written stream-sum kernel (ops/hbm.py).
- ``sharded_chip_verdicts`` runs a capped burn-in on every local device
  and all-reduces the healthy count over the chip mesh — the twin's
  ``psum`` (ops/collectives.py: over one device its own count, with no
  NCCL, as the twin's psum over one chip; over several NCCL on CUDA and
  the host sum on the CPU).
- On a multi-GPU node, ``ici_allreduce_probe`` times an NCCL all-reduce
  of 32 MiB per device (``ici_gbps``), and ``ici_ring_sweep`` walks every
  ring link of the mesh with peer copies and all-reduces a checksum
  (``ici_ok``). The twin's names are kept: the links are NVLink or PCIe
  here, not ICI.
- ``make_slice_train_step`` is the twin's miniature data+tensor-parallel
  MLP step, its shards and seams written out by hand.

On CUDA the rates come from CUDA events (ops/device_timing.py) at the
2048x4 / 256 MiB geometry. The twin times one compiled XLA program, pure
device time; a pass of eager PyTorch launches about 40 kernels, and an
event pair around them would wait on the host queueing them. So the
timed burn-in pass is a CUDA graph, captured once per (device, size,
depth) during the warm-up and replayed between the event pair: the
window holds the device's work only. The all-reduce is timed behind a
spin that holds every stream until the host has queued it
(``device_timing.gated_windows``). On the CPU (tests,
``TFD_BURNIN_ALLOW_CPU``) the host clock times a 512x8 burn-in, there is
no HBM probe and ``ici_gbps`` stays None, as the twin splits TPU and
non-TPU devices.

Every function takes its devices explicitly; none initialises CUDA at
import.
"""

from __future__ import annotations

import functools
import logging
import math
import os
import re
import statistics
import time
from typing import Optional, Tuple

import numpy as np
import torch

from gpu_feature_discovery_tpu_torch.native import nvml
from gpu_feature_discovery_tpu_torch.utils import timing
from gpu_feature_discovery_tpu_torch.ops import device_timing
from gpu_feature_discovery_tpu_torch.ops.collectives import (
    DataParallelGrad,
    Mesh,
    RowParallelSum,
    all_reduce,
    axis_groups,
    ring_shift,
)
from gpu_feature_discovery_tpu_torch.ops.hbm import (
    HBM_KERNEL_NAME,
    LANES,
    expected_stream_sum,
    hbm_stream_sum,
    launch_scratch,
    probe_rows,
    stream_workspace,
)

log = logging.getLogger("tfd.ops")

BURNIN_KERNEL_NAME = "burnin_step"

# CUDA probe geometry: the twin's TPU geometry (a 2048-wide bf16 chain, 4
# layers deep) — large enough to keep the tensor cores busy rather than
# measure launch latency. CPU callers keep the small geometry: a number
# from a CPU is not a device measurement, so it must not cost seconds.
CUDA_PROBE_SIZE = 2048
CUDA_PROBE_DEPTH = 4
DEFAULT_PROBE_SIZE = 512
DEFAULT_PROBE_DEPTH = 8
# One HBM probe geometry: 256 MiB, five times the H100's 50 MB L2, so
# every pass is a device-memory read.
PROBE_HBM_MIB = 256
PROBE_HBM_ITERS = 3
# The burn-in's matmul input type on every probe path.
PROBE_DTYPE = torch.bfloat16

# chip.<i>.slow fault site: the injected straggler's measured throughput is
# scaled by this factor (a device cannot be made slower on demand).
SLOW_CHIP_FACTOR = 0.02

# The per-device verdict is non-finite detection, not a rate probe, so its
# geometry is capped: NaN propagates through any depth >= 1.
VERDICT_MAX_SIZE = 128
VERDICT_MAX_DEPTH = 2

# All-reduce probe payload per device: on CUDA large enough that the ring
# transfers dominate launch latency (the twin's real-device size);
# elsewhere the number is no device measurement, so the buffer stays
# small and the probe only proves the reduction sums.
ICI_ALLREDUCE_MIB_CUDA = 32
ICI_ALLREDUCE_MIB_DEFAULT = 1
ICI_ALLREDUCE_ITERS = 3

CHIP_MESH_AXIS = "chips"

# Hermetic-testing override for the probe geometry ("<size>x<depth>",
# e.g. "128x2"). Never set in production.
BURNIN_GEOMETRY_ENV = "TFD_BURNIN_GEOMETRY"


# ---------------------------------------------------------------------------
# Single-device burn-in
# ---------------------------------------------------------------------------

def _matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with an f32 result. On CUDA a bf16 product keeps bf16
    inputs and asks cuBLAS for f32 output (the twin's
    ``preferred_element_type=f32``); the CPU build has no kernel for that
    overload, so there the inputs are widened first."""
    if a.dtype == torch.float32:
        return torch.mm(a, b)
    if a.device.type == "cuda":
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


def burnin_step(
    x: torch.Tensor, ws: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One burn-in pass: chain ``x @ ws[i]`` for every layer of ``ws``.

    Returns ``(checksum, rms)`` as 0-d f32 tensors on the inputs' device;
    a healthy device yields finite values for both."""
    carry = x
    rms = torch.zeros((), dtype=torch.float32, device=x.device)
    for w in ws:
        y = _matmul_f32(carry, w)
        # RMS-normalise in f32, then return to the matmul dtype: keeps the
        # chain bounded at any depth.
        rms = torch.sqrt(torch.mean(torch.square(y)) + 1e-6)
        carry = (y / rms).to(x.dtype)
    return carry.float().sum(), rms


def burnin_flops(size: int, depth: int) -> float:
    """FLOPs of one burn-in pass (matmuls only: depth * 2 * size^3)."""
    return 2.0 * depth * size**3


def _burnin_input_arrays(size: int, depth: int, dtype, device):
    """THE probe input construction: a ``torch.Generator`` on ``device``
    seeded with 0, f32 standard normals cast to ``dtype``, weights scaled
    by 1/sqrt(size) in ``dtype``. The values differ from the twin's
    ``jax.random`` ones; the distribution is the same.

    The twin draws and casts inside one jitted program, so no f32 array
    exists. Here ``x`` and ``ws`` are views of one ``dtype`` allocation,
    filled a layer at a time from one (size, size) f32 scratch, which is
    then handed back to the device: the inputs leave nothing reserved
    beyond themselves."""
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    layers = torch.empty((1 + depth, size, size), dtype=dtype, device=device)
    scratch = torch.empty((size, size), dtype=torch.float32, device=device)
    for layer in layers:
        layer.copy_(scratch.normal_(generator=gen))
    x, ws = layers[0], layers[1:]
    scale = torch.tensor(math.sqrt(size), dtype=torch.float32, device=device)
    ws.div_(scale.to(dtype))
    del scratch
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return x, ws


@functools.lru_cache(maxsize=None)
def _burnin_workspace(device: torch.device, size: int, depth: int, dtype) -> tuple:
    """Per-device burn-in inputs, generated on the device once per process
    and held resident (about 40 MiB at the CUDA geometry)."""
    return _burnin_input_arrays(size, depth, dtype, device)


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure_chip_health(
    size: int = DEFAULT_PROBE_SIZE,
    depth: int = DEFAULT_PROBE_DEPTH,
    iters: int = 4,
    device=None,
    dtype=PROBE_DTYPE,
) -> dict:
    """Run the burn-in on one device and report health + achieved
    TFLOP/s (median of ``iters``, host clock around a synchronised call).
    ``device`` defaults to the current CUDA device."""
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    x, ws = _burnin_workspace(device, size, depth, dtype)
    checksum, rms = burnin_step(x, ws)  # warm
    _synchronize(device)
    samples = []
    for _ in range(iters):
        t0 = time.perf_counter()
        burnin_step(x, ws)
        _synchronize(device)
        samples.append(time.perf_counter() - t0)
    sec = statistics.median(samples)
    healthy = bool(torch.isfinite(checksum)) and bool(torch.isfinite(rms))
    return {
        "healthy": healthy,
        "tflops": burnin_flops(size, depth) / sec / 1e12,
        # Best iteration: the straggler detector's input (lm/health.py).
        "tflops_best": burnin_flops(size, depth) / min(samples) / 1e12,
        "seconds": sec,
    }


def health_pack(checksum, rms, hbm_total) -> torch.Tensor:
    """Pack one device's probe outputs into a (3,) f32 tensor, so the host
    reads each device back once."""
    return torch.stack(
        [
            checksum.float(),
            rms.float(),
            hbm_total.reshape(()).float(),
        ]
    )


# (devices, geometry) sets whose probes have run once outside any timed
# window — see _warm_probe_kernels.
_warmed_probe_keys: set = set()

# (device, size, depth) -> (graph, checksum, rms): one burn-in pass at the
# probe geometry captured as a CUDA graph, with its static outputs.
_burnin_graphs: dict = {}


def _burnin_graph(device: torch.device, size: int, depth: int) -> tuple:
    """The captured burn-in pass for ``device`` (captured on first use).
    Runs on whichever thread probes — the daemon's first probe runs off
    the labeling thread — so every CUDA call sits under an explicit
    device guard, and the capture checks only this thread's calls. A
    failed capture raises: the probe never falls back to an ungraphed
    window, which would time the host."""
    key = (device, size, depth)
    entry = _burnin_graphs.get(key)
    if entry is not None:
        return entry
    xb, wsb = _burnin_workspace(device, size, depth, PROBE_DTYPE)
    with torch.cuda.device(device):
        current = torch.cuda.current_stream(device)
        # The capture's stream, from torch's stream pool.
        side = torch.cuda.Stream(device)
        # One pass outside the capture, on the probe's own stream: cuBLAS
        # creates its handle, which a capture cannot, and its workspace
        # for this stream, which the verdicts then reuse. A warm-up on
        # another stream would keep a workspace that nothing runs on.
        burnin_step(xb, wsb)
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, stream=side, capture_error_mode="thread_local"):
                cs, rms = burnin_step(xb, wsb)
        except BaseException:
            # torch.cuda.graph leaves this thread on its capture stream
            # when ending a failed capture raises: the thread's own stream
            # comes back before anything else runs on it.
            torch.cuda.set_stream(current)
            raise
    entry = (graph, cs, rms)
    _burnin_graphs[key] = entry
    return entry


def reset_probe_workspaces() -> None:
    """Drop every per-device probe cache: the captured burn-in graphs,
    the resident burn-in inputs, the HBM stream buffers and the stream
    kernel's scratch, the all-reduce payloads, the timing gate's sizes
    and the warmed-probe memo."""
    _burnin_graphs.clear()
    stream_workspace.cache_clear()
    launch_scratch.cache_clear()
    _burnin_workspace.cache_clear()
    _allreduce_workspace.cache_clear()
    _warmed_probe_keys.clear()
    device_timing.gate_sizes.clear()


# What a probe's error says when it could not get device memory: the
# device is busy (a workload holds its memory), not sick. Besides
# torch.OutOfMemoryError (the caching allocator's) and DeviceBusy, only
# an error whose message holds one of these counts as busy:
BUSY_ERROR_TEXTS = (
    # A CUDA call's cudaErrorMemoryAllocation as torch words it; the
    # CUDA context's creation on a full device fails so.
    "CUDA error: out of memory",
    # The same error by its name.
    "cudaErrorMemoryAllocation",
    # cuBLAS could not allocate its handle or workspace.
    "CUBLAS_STATUS_ALLOC_FAILED",
    # The stream kernel's launch (ops/hbm.py) returned
    # cudaErrorMemoryAllocation.
    "hbm_stream_sum kernel launch failed: cudaError 2",
)
# A text must not run on into a digit ("cudaError 2" is not "cudaError 20").
_BUSY_ERROR = re.compile("|".join(re.escape(t) + r"(?!\d)" for t in BUSY_ERROR_TEXTS))


class DeviceBusy(RuntimeError):
    """A probe could not get the memory it needs on a device."""


def is_busy_error(exc) -> bool:
    """True when ``exc`` (an exception, or the text a probe process
    shipped of one), or an exception it was raised from or while
    handling, says the probe could not get device memory."""
    seen = set()
    while exc is not None and id(exc) not in seen:
        seen.add(id(exc))
        if isinstance(exc, (DeviceBusy, torch.OutOfMemoryError)):
            return True
        if _BUSY_ERROR.search(str(exc)):
            return True
        exc = getattr(exc, "__cause__", None) or getattr(exc, "__context__", None)
    return False


def release_probe_memory(error: Optional[BaseException] = None) -> None:
    """After a probe that could not get device memory: the failed
    attempt's tensors go back to the device, so the process holds little
    more than its CUDA context until the next attempt, which starts
    clean. ``error``'s tracebacks are cut first (their frames hold the
    attempt's tensors); then every probe cache is dropped, and cuBLAS's
    workspaces and the caching allocator's free blocks are released."""
    seen = set()
    while error is not None and id(error) not in seen:
        seen.add(id(error))
        error.__traceback__ = None
        error = error.__cause__ or error.__context__
    reset_probe_workspaces()
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        clear_workspaces = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
        if clear_workspaces is not None:
            clear_workspaces()
        torch.cuda.empty_cache()


def _warm_probe_kernels(devices: tuple, size: int, depth: int, per_chip: bool) -> float:
    """Build the HBM kernel, capture the burn-in graph and run every probe
    once outside the timed window; returns the wall ms spent (0.0 when
    already warm). The first call of each probe pays the kernel build,
    cuBLAS handle creation, the graph capture, the workspace fills and,
    on several devices, the NCCL communicator's set-up; none of that
    belongs in a measured rate or in ``probe-ms``. On several devices
    that includes the all-reduce probe at its real payload (under
    ``per_chip``) and the ring sweep's peer copies, as the probe will run
    them."""
    key = (devices, size, depth, per_chip)
    if key in _warmed_probe_keys:
        return 0.0
    t0 = time.perf_counter()
    rows = probe_rows(PROBE_HBM_MIB)
    # What takes device memory first, the buffers before cuBLAS, the graph
    # and NCCL load what no call frees, and the kernels last: on a device
    # a workload holds, an attempt that fails for want of memory launched
    # nothing, and the commonest failure (no room for the buffers) leaves
    # this process little more than its CUDA context once
    # release_probe_memory has run.
    for d in devices:
        _burnin_workspace(d, size, depth, PROBE_DTYPE)
        stream_workspace(d, rows)
    graphs = [_burnin_graph(d, size, depth) for d in devices]
    _warm_collectives(devices, size, depth, per_chip)
    for d, (graph, cs, rms) in zip(devices, graphs):
        with torch.cuda.device(d):
            graph.replay()
        total = hbm_stream_sum(stream_workspace(d, rows))
        health_pack(cs, rms, total).cpu()
    _warmed_probe_keys.add(key)
    return (time.perf_counter() - t0) * 1e3


# The device memory NCCL's communicator took, with a cuBLAS workspace,
# when an earlier probe built it over one device (chip_smoke.py busy, the
# footprint split's verdicts step less the verdicts' own inputs: 492-494
# MiB on an NVIDIA H100 80GB HBM3, 700 W). The probe now builds one only
# over several devices, whose room this guards per device; that need is
# not measured.
NCCL_COMM_MIB = 492
# What NCCL says when a CUDA call of its own fails, its allocations
# included: busy only while a device has less than NCCL_COMM_MIB free.
NCCL_CUDA_ERROR = "NCCL Error 1: unhandled cuda error"
# The device tuples whose communicator this process has built (torch
# keeps it for the process's life).
_nccl_built: set = set()


def _short_of_nccl(devices) -> list:
    """The CUDA devices with less than NCCL_COMM_MIB free, each as
    ``device: N MiB free`` (on the CPU the collectives are host sums)."""
    short = []
    for d in devices:
        if d.type != "cuda":
            continue
        free = torch.cuda.mem_get_info(d)[0] / 2**20
        if free < NCCL_COMM_MIB:
            short.append(f"{d}: {free:.0f} MiB free")
    return short


def _warm_collectives(devices: tuple, size: int, depth: int, per_chip: bool) -> None:
    """The probe's collectives, once each. Over one device that is the
    verdicts (under ``per_chip``) and nothing else: their reduction is
    the device's own count, with no NCCL. Over several, the first NCCL
    call builds the communicator over ``devices``. A device without room
    for it is busy, checked before the first build, since a build that
    fails for want of memory keeps what it had allocated, and again when
    NCCL's own CUDA call fails, since its error does not say why."""
    if len(devices) == 1:
        if per_chip:
            sharded_chip_verdicts(
                devices, min(size, VERDICT_MAX_SIZE), min(depth, VERDICT_MAX_DEPTH)
            )
        return
    if devices not in _nccl_built:
        short = _short_of_nccl(devices)
        if short:
            raise DeviceBusy(f"no room for NCCL's communicator (about {NCCL_COMM_MIB} "
                             f"MiB): {'; '.join(short)}")
    try:
        if per_chip:
            sharded_chip_verdicts(
                devices, min(size, VERDICT_MAX_SIZE), min(depth, VERDICT_MAX_DEPTH)
            )
            ici_allreduce_probe(devices, iters=1)
        ici_ring_sweep(chip_mesh(devices))
    except RuntimeError as e:
        short = _short_of_nccl(devices) if NCCL_CUDA_ERROR in str(e) else []
        if short:
            raise DeviceBusy(f"NCCL could not get device memory: {'; '.join(short)}") from e
        raise
    _nccl_built.add(devices)


def warm_probe_kernels_for(devices: tuple, per_chip: bool = True) -> float:
    """Warm the probes for ``devices`` at the geometry
    ``measure_node_health`` would pick for them (CUDA devices only: the
    CPU path runs no kernel worth warming). Returns the wall ms spent."""
    devices = tuple(devices)
    if not all(d.type == "cuda" for d in devices):
        return 0.0
    override = _probe_geometry_override()
    size, depth = override if override is not None else (
        CUDA_PROBE_SIZE, CUDA_PROBE_DEPTH
    )
    return _warm_probe_kernels(devices, size, depth, per_chip)


# ---------------------------------------------------------------------------
# Per-device verdicts (fault localisation)
# ---------------------------------------------------------------------------

def sharded_chip_verdicts(
    devices, size: int, depth: int, sick_chips=frozenset()
) -> Tuple[list, bool]:
    """Burn in every device at the capped geometry and all-reduce the
    healthy count across them; returns ``(ok_per_chip, allreduce_ok)``.

    A chip in ``sick_chips`` has its input NaN-poisoned, so the ordinary
    finite-verdict detects it. The per-device counts are summed over the
    chip mesh by ``collectives.all_reduce`` (over one device its own
    count, over several CUDA devices NCCL); ``allreduce_ok`` is True
    when every device's reduced count equals the host-side sum, so a
    failed or corrupt reduction shows as a disagreeing count."""
    devices = tuple(devices)
    sick = {int(i) for i in sick_chips}
    oks = []
    for i, d in enumerate(devices):
        x, ws = _burnin_workspace(d, size, depth, PROBE_DTYPE)
        poison = float("nan") if i in sick else 1.0
        cs, rms = burnin_step((x.float() * poison).to(x.dtype), ws)
        oks.append((torch.isfinite(cs) & torch.isfinite(rms)).to(torch.int32).reshape(1))
    verdicts = [bool(ok.item()) for ok in oks]
    healthy = sum(verdicts)
    reduced = [int(c.item()) for c in all_reduce(oks)]
    return verdicts, all(c == healthy for c in reduced)


# ---------------------------------------------------------------------------
# Collective probes over the chip mesh
# ---------------------------------------------------------------------------

def chip_mesh(devices) -> Mesh:
    """The named single-axis mesh over this host's local devices."""
    return Mesh(list(devices), (CHIP_MESH_AXIS,))


@functools.lru_cache(maxsize=None)
def _allreduce_workspace(devices: tuple, rows_per_chip: int) -> tuple:
    """Resident all-ones (rows, 128) f32 payloads, one per device, and
    the buffers the reduction writes (cleared by
    reset_probe_workspaces)."""
    ones = [torch.ones((rows_per_chip, LANES), dtype=torch.float32, device=d)
            for d in devices]
    return ones, [torch.empty_like(t) for t in ones]


def ici_allreduce_probe(
    devices, mib_per_chip: Optional[int] = None, iters: int = ICI_ALLREDUCE_ITERS
) -> dict:
    """Time an all-reduce over the chip mesh and report the sustained
    bandwidth in GiB/s per device (median of ``iters``; ring cost model —
    each device moves ``2*(n-1)/n`` of its shard per reduction, so a
    single device reads 0.0). ``checksum_ok`` verifies that the reduction
    summed every shard: ones in, n out, on every element of every device.

    On CUDA each reduction is timed on the devices' clocks, as the
    slowest device's window (``device_timing.gated_windows``); the first
    reduction outside the windows pays the communicator's set-up. On the
    CPU the host clock times the host sum, as the twin does off-TPU."""
    devices = tuple(torch.device(d) for d in devices)
    n = len(devices)
    on_cuda = all(d.type == "cuda" for d in devices)
    if mib_per_chip is None:
        mib_per_chip = ICI_ALLREDUCE_MIB_CUDA if on_cuda else ICI_ALLREDUCE_MIB_DEFAULT
    rows = max(1, (mib_per_chip << 20) // (LANES * 4))
    ones, out = _allreduce_workspace(devices, rows)
    all_reduce(ones, out=out)  # warm: the communicator, the payload
    if on_cuda:
        gate = device_timing.gated_windows(
            devices, lambda: all_reduce(ones, out=out), max(1, iters)
        )
        samples = gate.windows
        if not gate.held:
            log.warning("all-reduce probe: the host queued past the timing gate "
                        "(%.3f ms queued, %.3f ms gate); the windows may include "
                        "host time", gate.queued_s * 1e3, gate.gate_s * 1e3)
    else:
        samples = []
        for _ in range(max(1, iters)):
            t0 = time.perf_counter()
            all_reduce(ones, out=out)
            samples.append(time.perf_counter() - t0)
    sec = statistics.median(samples)
    checksum_ok = all(bool(torch.all(o == float(n))) for o in out)
    shard_bytes = rows * LANES * 4
    gbps = (
        shard_bytes * (2.0 * (n - 1) / n) / sec / 2**30 if n > 1 and sec > 0 else 0.0
    )
    return {
        "gbps": gbps,
        "seconds": sec,
        "bytes": shard_bytes,
        "checksum_ok": checksum_ok,
        "devices": n,
    }


def ici_ring_sweep(mesh: Mesh) -> dict:
    """Walk every ring link of every mesh axis and all-reduce a checksum.

    Every device holds its row-major linear rank from its mesh
    coordinates. Along each axis a ring shift (``collectives.ring_shift``,
    peer copies) delivers the left neighbour's rank, which must equal
    ``rank + (prev_idx - idx) * stride``, the stride being the axis's in
    row-major order: a dead or misrouted link shows as a wrong value. A
    final all-reduce over the whole mesh must give n(n-1)/2 everywhere.
    Returns per-link and reduction pass/fail."""
    axes = mesh.axis_names
    sizes = mesh.devices.shape
    n = mesh.size
    devices = mesh.flat_devices()
    strides = [int(np.prod(sizes[k + 1:], dtype=np.int64)) for k in range(len(axes))]
    coords = [np.unravel_index(i, sizes) for i in range(n)]
    ranks = [
        torch.tensor([sum(int(c) * s for c, s in zip(coords[i], strides))],
                     dtype=torch.int32, device=d)
        for i, d in enumerate(devices)
    ]
    oks = [torch.ones(1, dtype=torch.bool, device=d) for d in devices]
    for k, ax in enumerate(axes):
        size = sizes[k]
        for group in axis_groups(mesh, ax):
            got = ring_shift([ranks[i] for i in group], [devices[i] for i in group])
            for idx, i in enumerate(group):
                prev_idx = size - 1 if idx == 0 else idx - 1
                expect = ranks[i] + (prev_idx - idx) * strides[k]
                oks[i] &= got[idx] == expect
    totals = all_reduce(ranks)
    expected_total = n * (n - 1) // 2
    return {
        "links_ok": all(bool(ok.item()) for ok in oks),
        "allreduce_ok": all(int(t.item()) == expected_total for t in totals),
        "devices": n,
    }


# ---------------------------------------------------------------------------
# Miniature DP+TP train step for slice acceptance
# ---------------------------------------------------------------------------

SLICE_SEED = 7
SLICE_LR = 0.01


def _slice_layout(mesh: Mesh) -> tuple:
    """``(data size, model size, [(d, m) of each flat device])`` of a
    mesh with ``data`` and ``model`` axes."""
    if sorted(mesh.axis_names) != ["data", "model"]:
        raise ValueError(f"the slice step needs axes data and model, got {mesh.axis_names}")
    sizes = mesh.shape
    di, mi = mesh.axis_names.index("data"), mesh.axis_names.index("model")
    coords = [np.unravel_index(i, mesh.devices.shape) for i in range(mesh.size)]
    return sizes["data"], sizes["model"], [(int(c[di]), int(c[mi])) for c in coords]


def shard_slice_params(params: dict, mesh: Mesh) -> dict:
    """Whole ``{"w1": (d_model, d_hidden), "w2": (d_hidden, d_model)}``
    tensors to per-device shards in mesh order: W1 split by columns and
    W2 by rows over ``model``, each shard replicated over ``data``."""
    _, msize, coords = _slice_layout(mesh)
    w1 = params["w1"].chunk(msize, dim=1)
    w2 = params["w2"].chunk(msize, dim=0)
    devices = mesh.flat_devices()
    return {
        "w1": [w1[m].contiguous().to(dev) for (_, m), dev in zip(coords, devices)],
        "w2": [w2[m].contiguous().to(dev) for (_, m), dev in zip(coords, devices)],
    }


def shard_slice_batch(x: torch.Tensor, y: torch.Tensor, mesh: Mesh) -> tuple:
    """Whole (batch, d_model) x and y to per-device shards in mesh order:
    rows split over ``data``, replicated over ``model``."""
    dsize, _, coords = _slice_layout(mesh)
    devices = mesh.flat_devices()
    xs, ys = x.chunk(dsize, dim=0), y.chunk(dsize, dim=0)
    return (
        [xs[d].contiguous().to(dev) for (d, _), dev in zip(coords, devices)],
        [ys[d].contiguous().to(dev) for (d, _), dev in zip(coords, devices)],
    )


def gather_slice_params(params: dict, mesh: Mesh) -> dict:
    """The inverse of ``shard_slice_params``, on the CPU. Every data-axis
    replica of a shard must be equal to the bit; a replica that drifted
    raises ValueError."""
    _, msize, coords = _slice_layout(mesh)
    whole = {}
    for key, dim in (("w1", 1), ("w2", 0)):
        shards = [None] * msize
        for (_, m), t in zip(coords, params[key]):
            t = t.detach().cpu()
            if shards[m] is None:
                shards[m] = t
            elif not torch.equal(shards[m], t):
                raise ValueError(f"{key} shard {m}: data-axis replicas differ")
        whole[key] = torch.cat(shards, dim=dim)
    return whole


def _per_group(fn, tensors: list, groups: list) -> list:
    """Apply a seam ``fn`` (one entry per device of a group) to every
    group, keeping mesh order."""
    out = [None] * len(tensors)
    for group in groups:
        for i, t in zip(group, fn.apply(*[tensors[i] for i in group])):
            out[i] = t
    return out


def make_slice_train_step(
    mesh: Mesh,
    batch: int = 32,
    d_model: int = 128,
    d_hidden: int = 256,
    params: Optional[dict] = None,
    batch_xy: Optional[tuple] = None,
    generator: Optional[torch.Generator] = None,
):
    """Build the DP+TP MLP train step over ``mesh`` (axes ``data`` and
    ``model``), the twin's Megatron split written out by hand:

    - x and y rows sharded over ``data``;
    - W1 column-sharded and W2 row-sharded over ``model``;
    - forward ``relu(x_d @ W1_m) @ W2_m``, the partials summed over
      ``model`` by the row-parallel seam (``RowParallelSum``);
    - the loss the global ``mean((out - y)^2)``: each data shard's term
      is its sum of squares over the GLOBAL element count, so the terms
      add up to the twin's mean;
    - backward by autograd, the weight gradients all-reduced over
      ``data`` by ``DataParallelGrad``; SGD at lr 0.01.

    Returns ``(step, (params, x, y))`` with ``step(params, x, y) ->
    (new_params, loss)``: params ``{"w1": [...], "w2": [...]}`` and x, y
    as per-device lists in mesh order, loss a 0-d tensor on the mesh's
    first device. Without carried ``params`` / ``batch_xy`` they come
    from ``generator`` (a CPU ``torch.Generator`` seeded with 7 by
    default): standard normals, weights scaled by 1/sqrt(fan_in), drawn
    in the twin's order w1, w2, x, y. The products are plain
    ``torch.matmul`` in f32, with TF32 off during the step so the card's
    f32 is the CPU's."""
    dsize, msize, _ = _slice_layout(mesh)
    if batch % dsize or d_hidden % msize:
        raise ValueError(
            f"batch {batch} / d_hidden {d_hidden} do not split over a "
            f"{dsize}x{msize} mesh"
        )
    if params is None or batch_xy is None:
        gen = generator if generator is not None else torch.Generator().manual_seed(SLICE_SEED)
        w1 = torch.randn((d_model, d_hidden), generator=gen) / math.sqrt(d_model)
        w2 = torch.randn((d_hidden, d_model), generator=gen) / math.sqrt(d_hidden)
        x = torch.randn((batch, d_model), generator=gen)
        y = torch.randn((batch, d_model), generator=gen)
        if params is None:
            params = shard_slice_params({"w1": w1, "w2": w2}, mesh)
        if batch_xy is None:
            batch_xy = shard_slice_batch(x, y, mesh)
    data_groups = axis_groups(mesh, "data")
    model_groups = axis_groups(mesh, "model")
    scale = 1.0 / (batch * d_model)

    def step(p: dict, xs: list, ys: list):
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            leaves = {k: [t.detach().requires_grad_() for t in p[k]] for k in ("w1", "w2")}
            w1 = _per_group(DataParallelGrad, leaves["w1"], data_groups)
            w2 = _per_group(DataParallelGrad, leaves["w2"], data_groups)
            partial = [torch.matmul(torch.relu(torch.matmul(x, a)), b)
                       for x, a, b in zip(xs, w1, w2)]
            out = _per_group(RowParallelSum, partial, model_groups)
            terms = [torch.sum(torch.square(o - y)) * scale for o, y in zip(out, ys)]
            torch.autograd.backward(terms)
            with torch.no_grad():
                new = {k: [t - SLICE_LR * t.grad for t in leaves[k]] for k in leaves}
                # The global loss: the data shards' terms of model rank 0.
                loss = all_reduce([terms[i].detach().reshape(1) for i in data_groups[0]])
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
        return new, loss[0].reshape(())

    return step, (params, batch_xy[0], batch_xy[1])


def build_mesh(
    n_devices: int, devices: Optional[list] = None, axis_names=("data", "model")
) -> Mesh:
    """Factor ``n_devices`` into a 2-D (data, model) mesh: the widest
    model axis <= sqrt(n) that divides n, so both axes carry real
    collectives whenever n is composite (8 -> 4x2, 4 -> 2x2, 2 -> 2x1).
    ``devices`` defaults to every CUDA device; too few raise."""
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devices = [torch.device("cuda", i) for i in range(count)]
    devices = list(devices)[:n_devices]
    if len(devices) < n_devices:
        raise RuntimeError(f"need {n_devices} devices, have {len(devices)}")
    model = 1
    for cand in range(int(n_devices**0.5), 0, -1):
        if n_devices % cand == 0:
            model = cand
            break
    grid = np.empty(n_devices, dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(n_devices // model, model), axis_names)


def _probe_geometry_override() -> Optional[Tuple[int, int]]:
    """Parse BURNIN_GEOMETRY_ENV ("<size>x<depth>"); None when unset. A
    malformed value raises."""
    raw = os.environ.get(BURNIN_GEOMETRY_ENV, "").strip()
    if not raw:
        return None
    try:
        size_s, depth_s = raw.lower().split("x")
        size, depth = int(size_s), int(depth_s)
    except ValueError as e:
        raise ValueError(
            f"{BURNIN_GEOMETRY_ENV}={raw!r}: want <size>x<depth>, e.g. 128x2"
        ) from e
    if size < 1 or depth < 1:
        raise ValueError(f"{BURNIN_GEOMETRY_ENV}={raw!r}: size/depth must be >= 1")
    return size, depth


# ---------------------------------------------------------------------------
# Node probe
# ---------------------------------------------------------------------------

def _measure_node_health_traced(
    devices: list,
    size: int,
    depth: int,
    iters: int,
    per_chip: bool,
) -> dict:
    """Probe every CUDA device with device-clock timing: every burn-in
    pass (a replay of its CUDA graph) and every HBM stream sum runs
    between a CUDA event pair on its device's stream; nothing waits until
    every device has its work queued. Rates are median-of-iters per
    device, worst device published."""
    compile_ms = _warm_probe_kernels(tuple(devices), size, depth, per_chip)
    rows = probe_rows(PROBE_HBM_MIB)
    clock = device_timing.DeviceClock()
    t0 = time.perf_counter()
    packed = []
    for d in devices:
        graph, cs, rms = _burnin_graph(d, size, depth)
        buf = stream_workspace(d, rows)
        for _ in range(max(1, iters)):
            # The replay writes the pass's checksum and rms into the
            # graph's static outputs, read by health_pack below.
            clock.time(BURNIN_KERNEL_NAME, d, graph.replay)
        for _ in range(PROBE_HBM_ITERS):
            total = clock.time(HBM_KERNEL_NAME, d, hbm_stream_sum, buf)
        packed.append(health_pack(cs, rms, total))
    durs = clock.durations()
    packed = [p.cpu().tolist() for p in packed]  # one readback per device
    trace_ms = (time.perf_counter() - t0) * 1e3
    t1 = time.perf_counter()
    nbytes = rows * LANES * 4
    flops = burnin_flops(size, depth)
    planes = [device_timing.plane_name(d) for d in devices]
    burnin_ms = [statistics.median(durs[BURNIN_KERNEL_NAME][p]) * 1e3 for p in planes]
    burnin_best = [min(durs[BURNIN_KERNEL_NAME][p]) * 1e3 for p in planes]
    hbm_ms = [statistics.median(durs[HBM_KERNEL_NAME][p]) * 1e3 for p in planes]
    expected = expected_stream_sum(rows)
    per_chip_table = []
    for i, (cs_v, rms_v, total_v) in enumerate(packed):
        chip_sum_ok = total_v == expected
        per_chip_table.append(
            {
                "healthy": math.isfinite(cs_v) and math.isfinite(rms_v),
                "tflops": flops / (burnin_ms[i] / 1e3) / 1e12,
                "tflops_best": flops / (burnin_best[i] / 1e3) / 1e12,
                "hbm_gbps": (
                    nbytes / (hbm_ms[i] / 1e3) / 2**30 if chip_sum_ok else None
                ),
            }
        )
    checksum_ok = all(p[2] == expected for p in packed)
    return {
        "healthy": all(e["healthy"] for e in per_chip_table),
        "tflops": min(e["tflops"] for e in per_chip_table),
        "hbm_gbps": (
            min(nbytes / (ms / 1e3) / 2**30 for ms in hbm_ms) if checksum_ok else None
        ),
        "ici_ok": None,
        "chips": len(devices),
        "per_chip": per_chip_table,
        "timing": "device-profiler",
        "phases": {
            # compile_ms: the kernel build and first run of every probe
            # (first probe per geometry only; 0.0 thereafter).
            # trace_ms: queueing + device work + readback of the timed
            # probes. burnin_device_ms: one graph replay.
            "compile_ms": round(compile_ms, 3),
            "trace_ms": round(trace_ms, 3),
            "report_ms": round((time.perf_counter() - t1) * 1e3, 3),
            "burnin_device_ms": round(max(burnin_ms), 6),
            "hbm_device_ms": round(max(hbm_ms), 6),
        },
    }


def _measure_node_health_wall(devices: list, size: int, depth: int, iters: int) -> dict:
    """Host-clock probe for CPU devices: median-of-iters per device, no
    HBM probe."""
    t0 = time.perf_counter()
    reports = [
        measure_chip_health(size=size, depth=depth, iters=iters, device=d)
        for d in devices
    ]
    burnin_ms = (time.perf_counter() - t0) * 1e3
    per_chip = [
        {
            "healthy": bool(r["healthy"]),
            "tflops": float(r["tflops"]),
            "tflops_best": float(r["tflops_best"]),
            "hbm_gbps": None,
        }
        for r in reports
    ]
    return {
        "healthy": all(r["healthy"] for r in reports),
        "tflops": min(r["tflops"] for r in reports),
        "hbm_gbps": None,
        "ici_ok": None,
        "chips": len(reports),
        "per_chip": per_chip,
        "timing": "wall-clock",
        "phases": {"burnin_ms": round(burnin_ms, 3), "hbm_ms": 0.0},
    }


def device_uuids(devices) -> list:
    """Each device's UUID in ``nvml.normalize_uuid``'s spelling; None for
    a CPU device."""
    return [
        nvml.normalize_uuid(torch.cuda.get_device_properties(d.index).uuid)
        if d.type == "cuda" else None
        for d in devices
    ]


def measure_node_health(
    size: Optional[int] = None,
    depth: Optional[int] = None,
    iters: int = 4,
    ici: Optional[bool] = None,
    devices: Optional[list] = None,
    per_chip: bool = False,
    sick_chips=frozenset(),
    slow_chips=frozenset(),
    inventory_uuids=(),
) -> dict:
    """Burn in EVERY local device and aggregate: a node is healthy only if
    all of its devices are, and the published rate is the worst device's.

    ``devices`` defaults to every CUDA device (RuntimeError when there is
    none); pass ``[torch.device("cpu")]`` to probe on the CPU.
    ``per_chip=True`` (the daemon's default via --chip-probes) adds the
    per-device verdict program and the ``chips_allreduce_ok`` key, and on
    a multi-GPU CUDA node the timed all-reduce (``ici_gbps``); the
    ``sick_chips`` / ``slow_chips`` fault sites require it. ``ici`` (auto:
    multi-GPU CUDA nodes; True with one device raises ValueError) rings
    the devices with peer copies to check every link (``ici_ok``). A
    failed all-reduce check forces ``ici_ok`` False. ``size`` and
    ``depth`` default by platform (2048x4 on CUDA, 512x8 on the CPU)
    unless BURNIN_GEOMETRY_ENV overrides them.

    Each ``per_chip`` entry carries its device's ``uuid`` (None on the
    CPU), which joins it to the inventory's NVML index. ``inventory_uuids``
    lists the inventory's GPU UUIDs in NVML's order: when it has any, the
    fault indices name NVML's GPUs, as the labels do, and a GPU that no
    probed device joins cannot be hit.

    The report is plain JSON data (the broker worker ships it over a
    pipe). Its ``phases`` carry the ``hbm_stream_sum`` launches of this
    probe and of the whole process so far, so a caller in another process
    can count the kernel's launches."""
    t_total = time.perf_counter()
    t_prepare = timing.now_ns()
    launches_before = hbm_stream_sum.launches
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device; pass devices=[torch.device('cpu')]")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    on_cuda = all(d.type == "cuda" for d in devices)
    override = _probe_geometry_override()
    if override is not None:
        size = size if size is not None else override[0]
        depth = depth if depth is not None else override[1]
    if size is None:
        size = CUDA_PROBE_SIZE if on_cuda else DEFAULT_PROBE_SIZE
    if depth is None:
        depth = CUDA_PROBE_DEPTH if on_cuda else DEFAULT_PROBE_DEPTH
    if ici is None:
        ici = on_cuda and len(devices) > 1
    elif ici and len(devices) < 2:
        # An explicit request must fail loudly: one device has no ring.
        raise ValueError("ici sweep requested but only one local device")
    # The device window: the first launch (the warm-up's, when the probe
    # pays first use) to the last readback.
    t_launch = timing.now_ns()
    if on_cuda:
        report = _measure_node_health_traced(
            devices, size=size, depth=depth, iters=iters, per_chip=per_chip
        )
    else:
        report = _measure_node_health_wall(devices, size=size, depth=depth, iters=iters)
    for entry, uuid in zip(report["per_chip"], device_uuids(devices)):
        entry["uuid"] = uuid
    if per_chip:
        where = nvml.inventory_positions(
            inventory_uuids, [e["uuid"] for e in report["per_chip"]]
        )
        if where is not None:
            unlisted = sorted(
                int(i) for i in set(sick_chips) | set(slow_chips) if int(i) not in where
            )
            if unlisted:
                log.warning(
                    "injected chip fault index(es) %s name GPUs that no probed "
                    "device joins; the shot was consumed but cannot be enacted",
                    unlisted,
                )
            sick_chips = frozenset(where[int(i)] for i in sick_chips if int(i) in where)
            slow_chips = frozenset(where[int(i)] for i in slow_chips if int(i) in where)
        out_of_range = sorted(
            int(i)
            for i in set(sick_chips) | set(slow_chips)
            if not 0 <= int(i) < len(devices)
        )
        if out_of_range:
            log.warning(
                "injected chip fault index(es) %s outside the %d-device "
                "inventory; the shot was consumed but cannot be enacted",
                out_of_range,
                len(devices),
            )
        t1 = time.perf_counter()
        verdicts, allreduce_ok = sharded_chip_verdicts(
            tuple(devices),
            min(size, VERDICT_MAX_SIZE),
            min(depth, VERDICT_MAX_DEPTH),
            sick_chips=frozenset(sick_chips),
        )
        report["phases"]["sharded_verdict_ms"] = round(
            (time.perf_counter() - t1) * 1e3, 3
        )
        table = report["per_chip"]
        slow = {int(i) for i in slow_chips}
        for i, entry in enumerate(table):
            entry["id"] = i
            # Both detectors must agree the device is fine: its own timed
            # probe and the verdict program.
            entry["healthy"] = bool(entry["healthy"]) and verdicts[i]
            if i in slow:
                for rate_key in ("tflops", "tflops_best"):
                    if entry.get(rate_key) is not None:
                        entry[rate_key] = float(entry[rate_key]) * SLOW_CHIP_FACTOR
        report["healthy"] = bool(report["healthy"]) and all(
            e["healthy"] for e in table
        )
        rates = [e["tflops"] for e in table if e.get("tflops") is not None]
        if rates:
            report["tflops"] = min(rates)
        # The timed all-reduce rides the same chip mesh, on multi-GPU
        # CUDA nodes only: elsewhere its number is no device measurement
        # and the verdicts' reduction already proved the collective sums.
        report["ici_gbps"] = None
        if on_cuda and len(devices) > 1:
            t2 = time.perf_counter()
            allr = ici_allreduce_probe(devices)
            report["phases"]["ici_allreduce_ms"] = round(
                (time.perf_counter() - t2) * 1e3, 3
            )
            allreduce_ok = allreduce_ok and allr["checksum_ok"]
            if allr["checksum_ok"]:
                report["ici_gbps"] = allr["gbps"]
        report["chips_allreduce_ok"] = allreduce_ok
    if ici:
        t1 = time.perf_counter()
        sweep = ici_ring_sweep(chip_mesh(devices))
        report["ici_ok"] = sweep["links_ok"] and sweep["allreduce_ok"]
        report["phases"]["ici_ms"] = round((time.perf_counter() - t1) * 1e3, 3)
    # The last readback is behind: the device window ends here.
    t_device = timing.now_ns()
    if report.get("chips_allreduce_ok") is False:
        # A corrupt reduction is a collective fault: fold it into the
        # published verdict even when the sweep passed or did not run.
        report["ici_ok"] = False
    report["phases"]["total_ms"] = round((time.perf_counter() - t_total) * 1e3, 3)
    report["phases"]["hbm_stream_sum_launches"] = (
        hbm_stream_sum.launches - launches_before
    )
    report["phases"]["hbm_stream_sum_launches_process"] = hbm_stream_sum.launches
    timing.emit("probe.prepare", t_prepare, t_launch)
    timing.emit("probe.device", t_launch, t_device)
    timing.emit("probe.report", t_device, timing.now_ns())
    return report
