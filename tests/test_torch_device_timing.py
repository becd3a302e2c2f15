"""The twin's on-device timing tier (``tests/test_device_timing.py``) held
against the port's ``ops/device_timing.py`` and the device-clock probe of
``ops/healthcheck.py``.

The twin reads each kernel's window off a profiler trace's device plane;
the port records a CUDA event pair around each call (``DeviceClock``), so
the trace parser's cases have no counterpart (``ROADMAP.md`` lists them).
What carries over:

- ``DeviceClock`` groups durations by kernel name and by device plane,
  ``{name: {"/device:CUDA:<i>": [seconds]}}``, the twin's
  ``DeviceDurations`` (CUDA's events are stood in for on the CPU);
- the methodology pin: TFLOP/s is the burn-in's flops over the median
  pass, GB/s the stream's bytes over the median stream, the worst device
  published, the phases in device ms; the same durations give the twin's
  numbers (the twin's arithmetic on the same inputs, ``pytest.approx``'s
  default relative 1e-6: both divide the same float64 values);
- a checksum slip suppresses the HBM rate, a non-finite pass is unhealthy;
- the warm-up runs before the first timed call;
- the twin's transient/permanent memo becomes the choice of clock by
  device type: CUDA devices are timed by events on every probe (an event
  pair cannot fail the way a profiler session can, so there is nothing
  to memoise), CPU devices by the wall clock."""

import contextlib
import math

import numpy as np
import pytest
import torch

from gpu_feature_discovery_tpu.ops import hbm as twin_hbm
from gpu_feature_discovery_tpu.ops import healthcheck as twin_healthcheck
from gpu_feature_discovery_tpu_torch.ops import device_timing, healthcheck, hbm
from gpu_feature_discovery_tpu_torch.ops.device_timing import DeviceClock, plane_name


class _FakeEvent:
    """A CUDA event on a scripted device clock (seconds)."""

    clock = [0.0]

    def __init__(self, enable_timing=False):
        self.t = None

    def record(self, stream=None):
        self.t = _FakeEvent.clock[0]

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3  # ms, as torch's


@pytest.fixture
def fake_cuda_events(monkeypatch):
    _FakeEvent.clock = [0.0]
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None: None)
    return _FakeEvent.clock


def _takes(clock, seconds, value=None):
    def fn(*args):
        clock[0] += seconds
        return value
    return fn


CUDA0, CUDA1 = torch.device("cuda", 0), torch.device("cuda", 1)


def test_clock_groups_durations_by_name_and_device_plane(fake_cuda_events):
    clock = DeviceClock()
    clock.time("burnin_step", CUDA0, _takes(fake_cuda_events, 10e-6))
    clock.time("burnin_step", CUDA0, _takes(fake_cuda_events, 12e-6))
    clock.time("hbm_probe", CUDA0, _takes(fake_cuda_events, 100e-6))
    durs = clock.durations()
    assert set(durs) == {"burnin_step", "hbm_probe"}
    assert durs["burnin_step"]["/device:CUDA:0"] == pytest.approx([10e-6, 12e-6])
    assert durs["hbm_probe"]["/device:CUDA:0"] == pytest.approx([100e-6])


def test_clock_handles_multiple_device_planes(fake_cuda_events):
    clock = DeviceClock()
    for d, s in ((CUDA0, 5e-6), (CUDA1, 7e-6)):
        clock.time("burnin_step", d, _takes(fake_cuda_events, s))
    durs = clock.durations()
    assert sorted(durs["burnin_step"]) == ["/device:CUDA:0", "/device:CUDA:1"]
    assert plane_name(CUDA1) == "/device:CUDA:1"


def test_clock_with_nothing_timed_returns_empty_and_drains(fake_cuda_events):
    clock = DeviceClock()
    assert clock.durations() == {}
    clock.time("k", CUDA0, _takes(fake_cuda_events, 1e-6))
    assert clock.durations() != {}
    assert clock.durations() == {}  # waited-for calls are not reported twice


def test_clock_passes_the_workload_result_through(fake_cuda_events):
    clock = DeviceClock()
    assert clock.time("k", CUDA0, lambda x: x + 1, 41) == 42


# ---------------------------------------------------------------------------
# the device-clock probe, on stand-ins for the device work
# ---------------------------------------------------------------------------

class _FakeClock:
    """DeviceClock with scripted durations: runs each call, reports what
    the script says (the twin's ``_fake_profile``)."""

    script = {}

    def __init__(self):
        self.calls = []

    def time(self, name, device, fn, *args):
        self.calls.append((name, plane_name(device)))
        return fn(*args)

    def durations(self):
        return {k: {p: list(v) for p, v in planes.items()}
                for k, planes in _FakeClock.script.items()}


class _Graph:
    def replay(self):
        pass


@pytest.fixture
def stand_in_devices(monkeypatch):
    """The probe's device work stood in for: the warm-up, the captured
    pass (its checksum and rms), the stream buffer and its sum."""
    state = {"cs": 1.0, "rms": 1.0, "sum_slip": 0.0, "order": []}

    def warm(*a, **k):
        state["order"].append("warm")
        return 123.0

    def graph(d, size, depth):
        return _Graph(), torch.tensor(state["cs"]), torch.tensor(state["rms"])

    def stream_sum(buf):
        state["order"].append("timed")
        return torch.tensor(float(hbm.expected_stream_sum(buf)) + state["sum_slip"])

    monkeypatch.setattr(healthcheck, "_warm_probe_kernels", warm)
    monkeypatch.setattr(healthcheck, "_burnin_graph", graph)
    monkeypatch.setattr(healthcheck, "stream_workspace", lambda d, rows: rows)
    monkeypatch.setattr(healthcheck, "hbm_stream_sum", stream_sum)
    monkeypatch.setattr(healthcheck, "expected_stream_sum", hbm.expected_stream_sum)
    monkeypatch.setattr(device_timing, "DeviceClock", _FakeClock)
    return state


def _two_device_script():
    # Device 1 is 2x slower on both kernels: it governs.
    return {
        "burnin_step": {"/device:CUDA:0": [10e-6, 12e-6, 11e-6],
                        "/device:CUDA:1": [22e-6, 24e-6, 23e-6]},
        "hbm_probe": {"/device:CUDA:0": [100e-6] * 3, "/device:CUDA:1": [200e-6] * 3},
    }


def test_traced_rates_are_bytes_and_flops_over_median(stand_in_devices):
    """The methodology pin, against the twin's arithmetic on the same
    durations: tflops = flops / median pass, gbps = bytes / median stream,
    median across iterations, the worst device wins."""
    _FakeClock.script = _two_device_script()
    report = healthcheck._measure_node_health_traced(
        [CUDA0, CUDA1], size=128, depth=2, iters=3, per_chip=False)
    rows = hbm.probe_rows(healthcheck.PROBE_HBM_MIB)
    assert report["timing"] == "device-profiler"
    assert report["healthy"] is True
    assert report["tflops"] == pytest.approx(twin_healthcheck.burnin_flops(128, 2) / 23e-6 / 1e12)
    assert healthcheck.burnin_flops(128, 2) == twin_healthcheck.burnin_flops(128, 2)
    assert report["hbm_gbps"] == pytest.approx(rows * hbm.LANES * 4 / 200e-6 / 2**30)
    assert report["phases"]["burnin_device_ms"] == pytest.approx(23e-3)
    assert report["phases"]["hbm_device_ms"] == pytest.approx(0.2)
    assert [e["tflops_best"] for e in report["per_chip"]] == pytest.approx(
        [healthcheck.burnin_flops(128, 2) / s / 1e12 for s in (10e-6, 22e-6)])


def test_traced_checksum_mismatch_suppresses_hbm(stand_in_devices):
    _FakeClock.script = {"burnin_step": {"/device:CUDA:0": [10e-6]},
                         "hbm_probe": {"/device:CUDA:0": [100e-6] * 3}}
    # The probe streams 256 MiB, whose sum (about 2**28) is held in f32
    # with a spacing of 32: the slip is one missing tile's worth, not 1.
    stand_in_devices["sum_slip"] = -float(hbm.TILE_ROWS * hbm.LANES)
    report = healthcheck._measure_node_health_traced([CUDA0], size=128, depth=2, iters=1,
                                                     per_chip=False)
    assert report["hbm_gbps"] is None
    assert report["per_chip"][0]["hbm_gbps"] is None
    assert report["tflops"] > 0


def test_traced_nonfinite_checksum_is_unhealthy(stand_in_devices):
    _FakeClock.script = {"burnin_step": {"/device:CUDA:0": [10e-6]},
                         "hbm_probe": {"/device:CUDA:0": [100e-6] * 3}}
    stand_in_devices["cs"] = math.nan
    report = healthcheck._measure_node_health_traced([CUDA0], size=128, depth=2, iters=1,
                                                     per_chip=False)
    assert report["healthy"] is False


def test_every_call_is_timed_once_on_its_own_device(stand_in_devices, monkeypatch):
    """The twin refuses a plane that captured fewer events than it
    dispatched (a partial export). Here each call records its own event
    pair on its own device, so the counts are exact by construction: the
    probe times ``iters`` passes and PROBE_HBM_ITERS streams per device."""
    clocks = []

    class Recording(_FakeClock):
        def __init__(self):
            super().__init__()
            clocks.append(self)

    monkeypatch.setattr(device_timing, "DeviceClock", Recording)
    _FakeClock.script = _two_device_script()
    healthcheck._measure_node_health_traced([CUDA0, CUDA1], size=128, depth=2, iters=3,
                                            per_chip=False)
    calls = clocks[0].calls
    for plane in ("/device:CUDA:0", "/device:CUDA:1"):
        assert calls.count(("burnin_step", plane)) == 3
        assert calls.count(("hbm_probe", plane)) == healthcheck.PROBE_HBM_ITERS


def test_warm_runs_before_the_timed_window(stand_in_devices):
    """The first use of every kernel happens before the first timed call,
    so the window the rates come from covers execution only (the twin's
    warm-before-trace)."""
    _FakeClock.script = {"burnin_step": {"/device:CUDA:0": [10e-6]},
                         "hbm_probe": {"/device:CUDA:0": [100e-6] * 3}}
    report = healthcheck._measure_node_health_traced([CUDA0], size=128, depth=2, iters=1,
                                                     per_chip=False)
    assert stand_in_devices["order"][0] == "warm"
    assert set(stand_in_devices["order"][1:]) == {"timed"}
    assert report["phases"]["compile_ms"] == 123.0


def test_cuda_devices_take_the_device_clock_on_every_probe(monkeypatch):
    """The twin memoises a failing profiler (transient up to a limit, then
    wall-clock for the process). CUDA events do not fail that way: every
    probe of CUDA devices is timed on the device, none falls back."""
    calls = []

    def traced(devices, size, depth, iters, per_chip):
        calls.append(len(devices))
        return {"healthy": True, "tflops": 1.0, "hbm_gbps": None, "ici_ok": None,
                "chips": len(devices), "per_chip": [
                    {"healthy": True, "tflops": 1.0, "tflops_best": 1.0, "hbm_gbps": None}
                    for _ in devices], "timing": "device-profiler", "phases": {}}

    monkeypatch.setattr(healthcheck, "_measure_node_health_traced", traced)
    monkeypatch.setattr(healthcheck, "_measure_node_health_wall",
                        lambda *a, **k: pytest.fail("a CUDA probe fell back to the wall clock"))
    monkeypatch.setattr(healthcheck, "device_uuids", lambda devices: [None] * len(devices))
    for _ in range(twin_healthcheck._TRACED_FAILURE_LIMIT + 2):
        report = healthcheck.measure_node_health(devices=[CUDA0], ici=False)
        assert report["timing"] == "device-profiler"
    assert calls == [1] * (twin_healthcheck._TRACED_FAILURE_LIMIT + 2)


def test_node_health_reports_wall_clock_on_cpu():
    report = healthcheck.measure_node_health(size=128, depth=2, iters=1,
                                             devices=[torch.device("cpu")])
    want = twin_healthcheck.measure_node_health(size=128, depth=2, iters=1)
    assert report["timing"] == want["timing"] == "wall-clock"
    assert "burnin_ms" in report["phases"] and "burnin_ms" in want["phases"]
    assert report["phases"]["total_ms"] > 0


@pytest.mark.parametrize("mib", [1, 64, 256])
def test_probe_rows_geometry(mib):
    rows = hbm.probe_rows(mib)
    assert rows == twin_hbm.probe_rows(mib)
    assert rows % hbm.CHUNK_ROWS == 0
    assert hbm.CHUNK_ROWS == twin_hbm.CHUNK_ROWS and hbm.LANES == twin_hbm.LANES
    assert rows * hbm.LANES * 4 <= mib * 2**20 or mib * 2**20 < hbm.CHUNK_ROWS * hbm.LANES * 4


@pytest.mark.parametrize("mib", [1, 3])
def test_expected_stream_sum_is_the_twins_and_the_buffers(mib):
    """The checksum gate's reference: the port's pattern sums to the
    twin's expected value, exactly (integers held in f32)."""
    rows = hbm.probe_rows(mib)
    assert hbm.expected_stream_sum(rows) == twin_hbm.expected_stream_sum(rows)
    buf = hbm.stream_pattern(rows)
    assert float(hbm.hbm_stream_sum_reference(buf)) == hbm.expected_stream_sum(rows)
    assert np.isfinite(hbm.expected_stream_sum(rows))
