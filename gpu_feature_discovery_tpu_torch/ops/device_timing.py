"""On-device kernel timing (twin: ``gpu_feature_discovery_tpu/ops/device_timing.py``).

The twin reads each kernel's execution window off the JAX profiler's
device plane, because host wall-clock time includes dispatch and
transport latency. On a CUDA card the device's own clock is reachable
directly: a pair of ``torch.cuda.Event(enable_timing=True)`` recorded on
the device's current stream around a call measures the GPU time between
them, whatever the host was doing. So on this port the report's
``timing`` value "device-profiler" means CUDA events.

:class:`DeviceClock` returns durations shaped like the twin's
``DeviceDurations``: ``{kernel_name: {plane: [seconds, ...]}}`` with one
plane per device, named ``/device:CUDA:<index>``.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Tuple

import torch

DeviceDurations = Dict[str, Dict[str, List[float]]]  # name -> plane -> [sec]


def plane_name(device) -> str:
    return f"/device:CUDA:{device.index}"


class DeviceClock:
    """Records a CUDA event pair around every timed call; ``durations()``
    waits for the recorded events and returns the elapsed device times."""

    def __init__(self):
        self._pending: List[Tuple[str, str, Any, Any]] = []

    def time(self, name: str, device, fn: Callable[..., Any], *args) -> Any:
        """Run ``fn(*args)`` between two events on ``device``'s current
        stream (where every launch on that device's tensors goes); returns
        its result without waiting for the device."""
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            result = fn(*args)
            end.record(stream)
        self._pending.append((name, plane_name(device), start, end))
        return result

    def durations(self) -> DeviceDurations:
        """Wait for every recorded call and return its device time."""
        out: DeviceDurations = {}
        for name, plane, start, end in self._pending:
            end.synchronize()
            out.setdefault(name, {}).setdefault(plane, []).append(
                start.elapsed_time(end) / 1e3  # elapsed_time is in ms
            )
        self._pending.clear()
        return out


# The spin that holds every device's stream before a gated window opens:
# about 1 ms at the H100's 1.98 GHz boost clock, far longer than the host
# takes to queue a few collectives on eight devices.
GATE_CYCLES = 2_000_000


def gated_windows(devices, fn: Callable[[], Any], iters: int) -> Tuple[List[float], bool]:
    """Time ``iters`` back-to-back calls of ``fn`` (a collective that
    launches on every device of ``devices``) by a chain of CUDA events on
    each device's current stream.

    An event pair around one multi-device call would also time the host:
    the first device's window opens while the host still queues the
    others. So each stream first runs a spin of GATE_CYCLES, which holds
    the windows shut until the host has queued every call. Returns
    ``(seconds per call as the slowest device's window, whether the host
    finished queueing inside the spin)``."""
    devices = list(dict.fromkeys(devices))
    streams = [torch.cuda.current_stream(d) for d in devices]
    marks: List[List[Any]] = [[] for _ in devices]

    def mark():
        for i, (d, s) in enumerate(zip(devices, streams)):
            with torch.cuda.device(d):
                e = torch.cuda.Event(enable_timing=True)
                e.record(s)
            marks[i].append(e)

    t0 = time.perf_counter()
    mark()
    for d, s in zip(devices, streams):
        with torch.cuda.device(d), torch.cuda.stream(s):
            torch.cuda._sleep(GATE_CYCLES)
    mark()
    for _ in range(iters):
        fn()
        mark()
    queued_s = time.perf_counter() - t0
    for row in marks:
        row[-1].synchronize()
    gate_s = min(row[0].elapsed_time(row[1]) for row in marks) / 1e3
    windows = [
        max(row[k].elapsed_time(row[k + 1]) for row in marks) / 1e3
        for k in range(1, iters + 1)
    ]
    return windows, queued_s < gate_s
