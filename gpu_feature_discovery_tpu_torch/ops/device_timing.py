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

import threading
import time
from collections import Counter
from typing import Any, Callable, Dict, List, NamedTuple, Tuple

import torch

from gpu_feature_discovery_tpu_torch.ops import timing_gate

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


class Gate(NamedTuple):
    """One gated timing: the per-call windows (seconds, slowest device),
    whether every device's gate was released by the host (none timed
    out), the gate's own device time and the host's queueing time
    (seconds), and each device's outcome (``timing_gate.OUTCOMES``)."""

    windows: List[float]
    held: bool
    gate_s: float
    queued_s: float
    outcomes: Tuple[str, ...]


# Gates per outcome, one count per device per gate, since the last
# drain_gate_outcomes: the probe's report carries them to the process
# that serves tfd_timing_gate_total.
gate_outcomes: Counter = Counter()
_outcomes_lock = threading.Lock()


def drain_gate_outcomes() -> Dict[str, int]:
    """Each outcome's count since the last drain (every outcome, 0 where
    none)."""
    with _outcomes_lock:
        counts = {name: gate_outcomes[name] for name in timing_gate.OUTCOMES}
        gate_outcomes.clear()
    return counts


def gated_windows(devices, fn: Callable[[], Any], iters: int) -> Gate:
    """Time ``iters`` back-to-back calls of ``fn`` (a collective that
    launches on every device of ``devices``) by a chain of CUDA events on
    each device's current stream.

    An event pair around one multi-device call would also time the host:
    the first device's window opens while the host still queues the
    others. So each stream first runs the gate kernel
    (``ops/timing_gate.py``), which holds the windows shut until the
    host, having queued every call and its marks, opens the gate with
    this gate's epoch: in a ``finally``, so a raising ``fn`` leaves no
    device to wait out the watchdog."""
    devices = list(dict.fromkeys(devices))
    gate = timing_gate.host_words()
    streams = [torch.cuda.current_stream(d) for d in devices]
    for i, (d, s) in enumerate(zip(devices, streams)):
        with torch.cuda.device(d):
            gate.load(d, i, s.cuda_stream)
    epoch = gate.next_epoch()
    marks: List[List[Any]] = [[] for _ in devices]

    def mark():
        for i, (d, s) in enumerate(zip(devices, streams)):
            with torch.cuda.device(d):
                e = torch.cuda.Event(enable_timing=True)
                e.record(s)
            marks[i].append(e)

    gate.arm(len(devices))
    t0 = time.perf_counter()
    try:
        mark()
        for i, (d, s) in enumerate(zip(devices, streams)):
            with torch.cuda.device(d):
                gate.launch(i, epoch, s.cuda_stream)
        mark()
        for _ in range(iters):
            fn()
            mark()
        queued_s = time.perf_counter() - t0
    finally:
        gate.open(epoch)
    for row in marks:
        row[-1].synchronize()
    outcomes = gate.outcomes(len(devices))
    with _outcomes_lock:
        gate_outcomes.update(outcomes)
    gate_s = min(row[0].elapsed_time(row[1]) for row in marks) / 1e3
    windows = [
        max(row[k].elapsed_time(row[k + 1]) for row in marks) / 1e3
        for k in range(1, iters + 1)
    ]
    return Gate(windows, all(o == "released" for o in outcomes), gate_s, queued_s, outcomes)
