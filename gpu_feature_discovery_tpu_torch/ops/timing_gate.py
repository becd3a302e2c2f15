"""The multi-GPU all-reduce probe's timing gate (no twin: the JAX package
times its psum as one compiled program and needs none).

``device_timing.gated_windows`` holds every card's stream shut while the
host queues the timed calls, so no window times the host. The gate is a
hand-written kernel (``csrc/timing_gate.cu``): one thread a card that
polls an epoch word in pinned host memory and returns once the host has
stored the gate's epoch there, or after TIMEOUT_NS of its own time (its
watchdog, the length of the capped ``torch.cuda._sleep`` spin it
replaced: 2,000,000 cycles at the H100's 1.98 GHz). Each card writes
whether it was released or timed out to a word of its own beside it.

The kernel is compiled with ``nvcc`` for ``sm_90a`` at first use into
the kernel cache (``kernel_cache.py``) and loaded with ``ctypes``, as
``hbm.py``'s is. Nothing is built, loaded or allocated at import; the
host words are allocated once per process at the first gate, and hold
nothing on the card.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Optional, Tuple

from gpu_feature_discovery_tpu_torch.ops import kernel_cache

TIMEOUT_NS = 1_000_000
# Cards one gate holds: one outcome word each, after the epoch word.
MAX_DEVICES = 64
OUTCOMES = ("released", "timed_out")

_CSRC = kernel_cache.TIMING_GATE_CU

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_words: Optional["HostWords"] = None


def build_kernel() -> Tuple[Path, str]:
    """The gate's library, built with nvcc unless this exact source and
    flag set is already in the kernel cache: its path and nvcc's
    diagnostics ("" when nothing was built). Raises KernelBuildError when
    the build cannot run or fails."""
    return kernel_cache.build_library(_CSRC)


def _kernel_library() -> ctypes.CDLL:
    """Build (first use) and load the gate's library; one per process."""
    global _lib
    with _lock:
        if _lib is None:
            lib_path, _ = build_kernel()
            lib = ctypes.CDLL(str(lib_path))
            lib.timing_gate_released.restype = ctypes.c_int
            lib.timing_gate_timed_out.restype = ctypes.c_int
            lib.timing_gate_alloc.argtypes = [ctypes.c_int]
            lib.timing_gate_alloc.restype = ctypes.c_void_p
            # Every pointer and the stream as c_void_p: an int would cut a
            # 64-bit address to 32 bits.
            lib.timing_gate_open.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
            lib.timing_gate_open.restype = None
            lib.timing_gate_launch.argtypes = [
                ctypes.c_void_p,     # word
                ctypes.c_uint32,     # epoch
                ctypes.c_void_p,     # outcome
                ctypes.c_ulonglong,  # timeout_ns
                ctypes.c_void_p,     # cudaStream_t
            ]
            lib.timing_gate_launch.restype = ctypes.c_int
            _lib = lib
        return _lib


class HostWords:
    """The gate's host state: its block of pinned host words (word 0 the
    epoch the host opens, word 1 + i the outcome of a gate's i-th card),
    the last epoch handed out and the cards the kernel has run on."""

    def __init__(self, lib):
        self.lib = lib
        self.base = lib.timing_gate_alloc(1 + MAX_DEVICES)
        if not self.base:
            raise RuntimeError("cudaHostAlloc of the timing gate's host words failed")
        self.words = (ctypes.c_uint32 * (1 + MAX_DEVICES)).from_address(self.base)
        self.names = {lib.timing_gate_released(): "released",
                      lib.timing_gate_timed_out(): "timed_out"}
        self.epoch = 0
        self.loaded: set = set()

    def load(self, device, i: int, stream: int) -> None:
        """Run the kernel once on ``device`` before its first gate, with
        the last epoch, which the host has opened already: it returns at
        once. A card's first launch loads the kernel onto it, about a
        quarter of a millisecond of host time that would otherwise fall
        inside the first gate and time it out."""
        if device not in self.loaded:
            self.launch(i, self.epoch, stream)
            self.loaded.add(device)

    def next_epoch(self) -> int:
        """The next gate's epoch: one up, modulo 2**32, as the kernel
        compares it with the word."""
        self.epoch = (self.epoch + 1) & 0xFFFFFFFF
        return self.epoch

    def arm(self, cards: int) -> None:
        """Clear the outcome words of a gate over ``cards`` cards."""
        for i in range(cards):
            self.words[1 + i] = 0

    def launch(self, i: int, epoch: int, stream: int) -> None:
        """The gate of ``epoch`` for the gate's ``i``-th card, on
        ``stream`` (a handle of the current device's)."""
        if not 0 <= i < MAX_DEVICES:
            raise ValueError(f"a gate holds at most {MAX_DEVICES} cards")
        rc = self.lib.timing_gate_launch(
            self.base, epoch, self.base + 4 * (1 + i), TIMEOUT_NS, stream
        )
        if rc != 0:
            raise RuntimeError(f"timing gate launch failed: cudaError {rc}")

    def open(self, epoch: int) -> None:
        """Release every gate of ``epoch`` and before (a release store)."""
        self.lib.timing_gate_open(self.base, epoch)

    def outcomes(self, cards: int) -> Tuple[str, ...]:
        """Each card's outcome, read once the gate has returned on it. A
        word the kernel did not write reads 0: not released."""
        return tuple(self.names.get(self.words[1 + i], "timed_out") for i in range(cards))

    def reset(self) -> None:
        """The epoch and every word back to 0. The block stays: it holds
        nothing on the card, and a gate of a call that raised may still
        read it (it then waits out its watchdog)."""
        self.open(0)
        for i in range(1, 1 + MAX_DEVICES):
            self.words[i] = 0
        self.epoch = 0


def host_words() -> HostWords:
    """The process's gate state, made at the first gate."""
    global _words
    lib = _kernel_library()
    with _lock:
        if _words is None:
            _words = HostWords(lib)
        return _words


def reset() -> None:
    """Drop the gate's state, its epoch and words
    (healthcheck.reset_probe_workspaces)."""
    with _lock:
        if _words is not None:
            _words.reset()
