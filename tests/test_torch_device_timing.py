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

import collections
import contextlib
import ctypes
import math
import types

import numpy as np
import pytest
import torch

from gpu_feature_discovery_tpu.ops import hbm as twin_hbm
from gpu_feature_discovery_tpu.ops import healthcheck as twin_healthcheck
from gpu_feature_discovery_tpu_torch.ops import device_timing, healthcheck, hbm, timing_gate
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


# ---------------------------------------------------------------------------
# the all-reduce's timing gate (ops/timing_gate.py, csrc/timing_gate.cu),
# its library's entry points stood in for. The twin times its psum as one
# program with no gate, so there is no twin to compare with: the rule
# itself, that no window opens before the host has queued every call.
# ---------------------------------------------------------------------------

class _FakeGateLibrary:
    """timing_gate.cu's entry points on the CPU. The host words are a
    ctypes block; a launched gate writes "released" once the host has
    opened its epoch or a later one (the kernel's signed 32-bit
    comparison), at once where it already has (a load), or "timed out" at
    once on a card the script times out."""

    RELEASED, TIMED_OUT = 1, 2

    def __init__(self, log):
        self.log = log
        self.timed_out = set()
        self.block = None
        self.pending = []   # (outcome address, epoch) not yet released
        self.launches = []  # (card, epoch, timeout_ns, stream) of the gates
        self.loads = []     # (card, epoch) of the launches that returned at once

    def timing_gate_released(self):
        return self.RELEASED

    def timing_gate_timed_out(self):
        return self.TIMED_OUT

    def timing_gate_alloc(self, words):
        self.block = (ctypes.c_uint32 * words)()
        return ctypes.addressof(self.block)

    def timing_gate_launch(self, word, epoch, outcome, timeout_ns, stream):
        card = (outcome - word) // 4 - 1
        if self._reached(ctypes.c_uint32.from_address(word).value, epoch):
            self.loads.append((card, epoch))
            self.log.append("load")
            ctypes.c_uint32.from_address(outcome).value = self.RELEASED
            return 0
        self.launches.append((card, epoch, timeout_ns, stream))
        self.log.append("gate")
        if card in self.timed_out:
            ctypes.c_uint32.from_address(outcome).value = self.TIMED_OUT
        else:
            self.pending.append((outcome, epoch))
        return 0

    def timing_gate_open(self, word, epoch):
        self.log.append(("open", epoch))
        ctypes.c_uint32.from_address(word).value = epoch
        still = []
        for outcome, want in self.pending:
            if self._reached(epoch, want):
                ctypes.c_uint32.from_address(outcome).value = self.RELEASED
            else:
                still.append((outcome, want))
        self.pending = still

    @staticmethod
    def _reached(word, epoch):
        return (word - epoch) & 0xFFFFFFFF < 2**31  # (int)(word - epoch) >= 0


@pytest.fixture
def fake_gate(fake_cuda_events, monkeypatch):
    log = []
    lib = _FakeGateLibrary(log)

    class LoggedEvent(_FakeEvent):
        def record(self, stream=None):
            super().record(stream)
            log.append("mark")

    monkeypatch.setattr(torch.cuda, "Event", LoggedEvent)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=7))
    monkeypatch.setattr(timing_gate, "_kernel_library", lambda: lib)
    monkeypatch.setattr(timing_gate, "_words", None)
    monkeypatch.setattr(device_timing, "gate_outcomes", collections.Counter())
    return lib


CARDS = [torch.device("cuda", i) for i in range(3)]


def _call(log, clock, raise_at=None):
    calls = []

    def fn():
        calls.append(1)
        log.append("call")
        clock[0] += 1e-3
        if len(calls) == raise_at:
            raise RuntimeError("the collective failed")
    return fn


@pytest.mark.parametrize("start", [0, 0xFFFFFFFE], ids=["first", "wrap"])
def test_gate_epochs_go_up_by_one_and_survive_the_wrap(fake_gate, fake_cuda_events, start):
    words = timing_gate.host_words()
    words.epoch = start
    words.open(start)  # as after a gate of epoch ``start``
    fake_gate.log.clear()
    gates = [device_timing.gated_windows(CARDS, _call(fake_gate.log, fake_cuda_events), 2)
             for _ in range(3)]
    want = [(start + k) % 2**32 for k in (1, 2, 3)]
    assert [e for _, e, _, _ in fake_gate.launches] == [e for e in want for _ in CARDS]
    assert [x[1] for x in fake_gate.log if isinstance(x, tuple)] == want
    assert all(g.held and g.outcomes == ("released",) * 3 for g in gates)
    assert {t for _, _, t, _ in fake_gate.launches} == {timing_gate.TIMEOUT_NS}
    assert {s for _, _, _, s in fake_gate.launches} == {7}
    assert fake_gate.loads == [(i, start) for i in range(3)]  # once a card, before its first gate


def test_gate_opens_after_the_last_call_and_its_mark(fake_gate, fake_cuda_events):
    gate = device_timing.gated_windows(CARDS[:2], _call(fake_gate.log, fake_cuda_events), 3)
    assert fake_gate.log == (["load"] * 2 + ["mark"] * 2 + ["gate"] * 2 + ["mark"] * 2
                             + ["call", "mark", "mark"] * 3 + [("open", 1)])
    assert gate.held and gate.windows == pytest.approx([1e-3] * 3)


@pytest.mark.parametrize("raise_at", [1, 3])
def test_gate_opens_even_when_the_collective_raises(fake_gate, fake_cuda_events, raise_at):
    with pytest.raises(RuntimeError, match="the collective failed"):
        device_timing.gated_windows(
            CARDS, _call(fake_gate.log, fake_cuda_events, raise_at=raise_at), 3)
    assert fake_gate.log[-1] == ("open", 1) and fake_gate.log.count("call") == raise_at
    assert fake_gate.pending == []  # no card waits out the watchdog


@pytest.mark.parametrize("timed_out", [(), (0,), (2,), (0, 1, 2)])
def test_gate_is_held_only_when_no_card_timed_out(fake_gate, fake_cuda_events, timed_out):
    fake_gate.timed_out = set(timed_out)
    gate = device_timing.gated_windows(CARDS, _call(fake_gate.log, fake_cuda_events), 3)
    assert gate.outcomes == tuple("timed_out" if i in timed_out else "released"
                                  for i in range(3))
    assert gate.held is (not timed_out)


def test_gate_counts_each_outcome_per_card(fake_gate, fake_cuda_events):
    device_timing.gated_windows(CARDS, _call(fake_gate.log, fake_cuda_events), 3)
    fake_gate.timed_out = {1}
    device_timing.gated_windows(CARDS, _call(fake_gate.log, fake_cuda_events), 3)
    assert device_timing.drain_gate_outcomes() == {"released": 5, "timed_out": 1}
    assert device_timing.drain_gate_outcomes() == {"released": 0, "timed_out": 0}


def test_gate_counts_reach_the_report_and_the_counter(monkeypatch):
    """The probe's report carries the gates since the last report (the
    broker worker's pre-warm's with its first), and the labeling process
    counts them in tfd_timing_gate_total, one per card per gate."""
    from gpu_feature_discovery_tpu_torch.config.flags import new_config
    from gpu_feature_discovery_tpu_torch.lm import health
    from gpu_feature_discovery_tpu_torch.obs import metrics as obs_metrics

    monkeypatch.setattr(device_timing, "gate_outcomes",
                        collections.Counter({"released": 7, "timed_out": 1}))
    cpu = [torch.device("cpu")]
    first = healthcheck.measure_node_health(size=128, depth=2, iters=1, devices=cpu)
    second = healthcheck.measure_node_health(size=128, depth=2, iters=1, devices=cpu)
    assert (first["phases"]["timing_gate_released"],
            first["phases"]["timing_gate_timed_out"]) == (7, 1)
    assert (second["phases"]["timing_gate_released"],
            second["phases"]["timing_gate_timed_out"]) == (0, 0)
    monkeypatch.setattr(health, "_spec_peaks", lambda manager: (989.0, 3350.0))
    before = {o: obs_metrics.TIMING_GATE.value(outcome=o) for o in timing_gate.OUTCOMES}
    health._labels_from_probe(health._BurninSchedule(), None,
                              new_config(cli_values={}, environ={}), first, None, 5.0)
    health._labels_from_probe(health._BurninSchedule(), None,
                              new_config(cli_values={}, environ={}), second, None, 5.0)
    after = {o: obs_metrics.TIMING_GATE.value(outcome=o) for o in timing_gate.OUTCOMES}
    assert {o: after[o] - before[o] for o in after} == {"released": 7, "timed_out": 1}


def test_reset_probe_workspaces_drops_the_gate_state(fake_gate, fake_cuda_events):
    for _ in range(2):
        device_timing.gated_windows(CARDS, _call(fake_gate.log, fake_cuda_events), 1)
    words = timing_gate.host_words()
    assert words.epoch == 2 and list(words.words[:4]) == [2, 1, 1, 1]
    healthcheck.reset_probe_workspaces()
    assert words.epoch == 0 and not any(words.words)
    gate = device_timing.gated_windows(CARDS, _call(fake_gate.log, fake_cuda_events), 1)
    assert gate.held and fake_gate.launches[-1][1] == 1
