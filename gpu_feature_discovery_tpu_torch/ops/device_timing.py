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
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

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


# The spin that holds every device's stream before a gated window opens
# is sized from what the last gate measured: three times the host's
# queueing time per timed call, times the calls to come (the host's
# queueing per call varies by up to 2x between gates), so a spin the
# host outran is at least doubled. It is never shorter than GATE_MIN_S,
# and never longer than the first spin, GATE_FIRST_CYCLES: that spin,
# the fixed one of old, calibrates the device's cycles per second, about
# 1-2 ms at the H100's 1-2 GHz SM clock. Where the host needs longer to
# queue (many devices), the windows open early and the gate reports it
# (``Gate.held``) rather than spend more device time than the fixed spin.
GATE_FIRST_CYCLES = 2_000_000
GATE_QUEUE_MULTIPLE = 3.0
GATE_MIN_S = 100e-6


class Gate(NamedTuple):
    """One gated timing: the per-call windows (seconds, slowest device),
    whether the host finished queueing inside the spin, the spin's own
    device time and the host's queueing time (seconds)."""

    windows: List[float]
    held: bool
    gate_s: float
    queued_s: float


def next_gate_s(queued_s: float, max_s: float) -> float:
    """The next spin's length from the host's last queueing time:
    GATE_QUEUE_MULTIPLE times it, within [GATE_MIN_S, max_s]. A spin the
    host outran (queued_s >= its length) is so at least doubled, up to
    ``max_s``."""
    return min(max_s, max(GATE_MIN_S, GATE_QUEUE_MULTIPLE * queued_s))


class GateSize:
    """The spin of one device set: its cycles per second as the last spin
    measured them, and the host's last queueing time per timed call, from
    which the next spin is sized for its own number of calls."""

    def __init__(self):
        self.cycles_per_s: Optional[float] = None
        self.queued_per_call_s: Optional[float] = None

    def cycles(self, iters: int) -> int:
        """Cycles of the next spin, ahead of ``iters`` timed calls:
        GATE_FIRST_CYCLES until calibrated, and never more."""
        if self.cycles_per_s is None or self.queued_per_call_s is None:
            return GATE_FIRST_CYCLES
        gate_s = next_gate_s(self.queued_per_call_s * iters,
                             GATE_FIRST_CYCLES / self.cycles_per_s)
        return max(1, min(GATE_FIRST_CYCLES, round(gate_s * self.cycles_per_s)))

    def record(self, cycles: int, gate_s: float, queued_s: float, iters: int) -> None:
        """Calibrate from a spin of ``cycles`` that lasted ``gate_s`` on
        the device, ahead of ``iters`` calls the host queued in
        ``queued_s``."""
        if gate_s > 0:
            self.cycles_per_s = cycles / gate_s
        self.queued_per_call_s = queued_s / max(1, iters)


# One GateSize per device set; healthcheck.reset_probe_workspaces clears it.
gate_sizes: Dict[tuple, GateSize] = {}


def gated_windows(devices, fn: Callable[[], Any], iters: int) -> Gate:
    """Time ``iters`` back-to-back calls of ``fn`` (a collective that
    launches on every device of ``devices``) by a chain of CUDA events on
    each device's current stream.

    An event pair around one multi-device call would also time the host:
    the first device's window opens while the host still queues the
    others. So each stream first spins, which holds the windows shut
    until the host has queued every call; the spin is sized by
    ``next_gate_s`` from the last gate on the same devices
    (``GateSize``)."""
    devices = list(dict.fromkeys(devices))
    size = gate_sizes.setdefault(tuple(devices), GateSize())
    cycles = size.cycles(iters)
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
            torch.cuda._sleep(cycles)
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
    size.record(cycles, gate_s, queued_s, iters)
    return Gate(windows, queued_s < gate_s, gate_s, queued_s)
