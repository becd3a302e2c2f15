"""Health labels: the PyTorch port (gpu_feature_discovery_tpu_torch/lm/
health.py) against its JAX twin (gpu_feature_discovery_tpu/lm/health.py).

Both render the SAME report dict; their label maps must be equal after
the one allowed key translation, google.com/tpu. -> nvidia.com/gpu."""

import pytest

from gpu_feature_discovery_tpu.config import new_config as twin_new_config
from gpu_feature_discovery_tpu.lm import health as twin
from gpu_feature_discovery_tpu_torch.config.flags import new_config
from gpu_feature_discovery_tpu_torch.lm import health
from gpu_feature_discovery_tpu_torch.resource.cuda_backend import (
    CudaChip,
    StaticCudaManager,
)

PEAKS = (989.0, 3350.0)


def _translated(labels):
    return {k.replace("google.com/tpu.", "nvidia.com/gpu.", 1): v
            for k, v in labels.items()}


def _chip(tflops, hbm, healthy=True, best=None):
    return {"healthy": healthy, "tflops": tflops, "tflops_best": best or tflops,
            "hbm_gbps": hbm}


def _report(per_chip, timing="device-profiler", tflops=None, hbm=None):
    rated = [e["tflops"] for e in per_chip]
    return {
        "healthy": all(e["healthy"] for e in per_chip),
        "tflops": tflops if tflops is not None else min(rated),
        "hbm_gbps": hbm if hbm is not None else min(e["hbm_gbps"] for e in per_chip),
        "ici_ok": None,
        "chips": len(per_chip),
        "per_chip": [dict(e, id=i) for i, e in enumerate(per_chip)],
        "timing": timing,
        "phases": {"compile_ms": 0.0, "trace_ms": 1.0},
        "chips_allreduce_ok": True,
        "ici_gbps": None,
    }


REPORTS = {
    "healthy": _report([_chip(700.7, 2200.4)]),
    "implausible-rates": _report([_chip(5000.0, 9000.0)]),
    "host-clock-low-rate": _report([_chip(0.4, 0.5)], timing="wall-clock"),
    "sick-chip": _report(
        [_chip(650.0, 2100.0), _chip(600.0, 2000.0, healthy=False),
         _chip(640.0, 2050.0)]
    ),
}


@pytest.fixture
def same_peaks(monkeypatch):
    monkeypatch.setattr(twin, "_spec_peaks", lambda manager: PEAKS)
    monkeypatch.setattr(health, "_spec_peaks", lambda manager: PEAKS)


@pytest.mark.parametrize("name", sorted(REPORTS))
def test_labels_from_probe_match_twin(name, same_peaks):
    import copy

    want = twin._labels_from_probe(
        twin._BurninSchedule(), None, twin_new_config(cli_values={}, environ={}),
        copy.deepcopy(REPORTS[name]), None, 123.9,
    )
    got = health._labels_from_probe(
        health._BurninSchedule(), None, new_config(cli_values={}, environ={}),
        copy.deepcopy(REPORTS[name]), None, 123.9,
    )
    assert dict(got) == _translated(want)
    assert got[health.HEALTH_PROBE_MS] == "123"


def test_failed_probe_labels_match_twin(same_peaks):
    for _ in range(2):  # a second consecutive failure is cached by both
        want_sched, got_sched = twin._BurninSchedule(), health._BurninSchedule()
        want = twin._labels_from_probe(
            want_sched, None, twin_new_config(cli_values={}, environ={}),
            None, RuntimeError("boom"), 1.0,
        )
        got = health._labels_from_probe(
            got_sched, None, new_config(cli_values={}, environ={}),
            None, RuntimeError("boom"), 1.0,
        )
        assert dict(got) == _translated(want) == {health.HEALTH_OK: "false"}


def test_chip_probes_off_drops_per_chip_labels_like_twin(same_peaks):
    report = REPORTS["sick-chip"]
    want = twin._labels_from_probe(
        twin._BurninSchedule(), None,
        twin_new_config(cli_values={"chip-probes": "false"}, environ={}),
        dict(report), None, 5.0,
    )
    got = health._labels_from_probe(
        health._BurninSchedule(), None,
        new_config(cli_values={"chip-probes": "false"}, environ={}),
        dict(report), None, 5.0,
    )
    assert dict(got) == _translated(want)
    assert health.CHIPS_HEALTHY not in got


STRAGGLER_SEQUENCE = [
    [_chip(100, 1, best=100), _chip(100, 1, best=100), _chip(10, 1, best=10)],
    [_chip(100, 1, best=100), _chip(100, 1, best=100), _chip(10, 1, best=10)],
    [_chip(100, 1, best=100), _chip(10, 1, best=10), _chip(100, 1, best=100)],
    [_chip(100, 1, best=100), _chip(10, 1, best=10), _chip(100, 1, best=100)],
    [_chip(100, 1, best=100), _chip(100, 1, best=100), _chip(100, 1, best=100)],
    [_chip(100, 1, best=100), _chip(10, 1, best=10, healthy=False),
     _chip(100, 1, best=100)],
    [_chip(100, 1, best=100), _chip(15, 1, best=15)],
]


@pytest.mark.parametrize("confirm", [1, 2, 3])
def test_straggler_detector_sequence_matches_twin(confirm):
    want_det = twin.StragglerDetector(0.2, confirm=confirm)
    got_det = health.StragglerDetector(0.2, confirm=confirm)
    for table in STRAGGLER_SEQUENCE:
        assert health.detect_straggler(table, 0.2) == twin.detect_straggler(table, 0.2)
        assert got_det.observe(table) == want_det.observe(table)


def test_spec_peaks_match_on_device_name():
    h100 = StaticCudaManager("nvidia-h100-80gb-hbm3", 2, memory_mb=81079)
    h100.init()
    assert health._spec_peaks(h100) == PEAKS
    unknown = StaticCudaManager("mock-gpu", 1, memory_mb=0)
    unknown.init()
    assert health._spec_peaks(unknown) == (0.0, 0.0)
    assert CudaChip("nvidia-h100-pcie", 1).get_generation() == (0, 0)


def test_rate_plausible_matches_twin():
    for args in [(None, False, 10.0), (0.5, True, 0.0), (0.5, False, 0.0),
                 (16.0, False, 10.0), (14.0, True, 10.0)]:
        assert health._rate_plausible(*args) == twin._rate_plausible(*args)


# ---------------------------------------------------------------------------
# The burn-in schedule across daemon cycles: first probe off the labeling
# thread, cached cycles, abandon on an unacquirable gap, adoption after a
# reload. measure_node_health and device acquisition are stubbed in both
# packages; FIRST_PROBE_WAIT_S is cut to WAIT_S.
# ---------------------------------------------------------------------------

WAIT_S = 0.3


class _StubProbe:
    """measure_node_health stand-in: the first call blocks until released
    (a slow first probe), later calls return at once."""

    def __init__(self):
        import threading

        self.gate = threading.Event()
        self.threads = []

    def __call__(self, devices=None, per_chip=False, sick_chips=frozenset(),
                 slow_chips=frozenset()):
        import copy
        import threading

        self.threads.append(threading.current_thread().name)
        if len(self.threads) == 1:
            assert self.gate.wait(10), "test gate never released"
        return copy.deepcopy(REPORTS["healthy"])


class _Node:
    """A one-device manager stand-in (the schedule registry keys on it);
    its device is a full GPU outside MIG."""

    def get_chips(self):
        return [CudaChip("dev0", 16384)]


def _schedule_run(mod, conf, monkeypatch, script, oneshot=False):
    from gpu_feature_discovery_tpu.ops import healthcheck as twin_ops
    from gpu_feature_discovery_tpu_torch.ops import healthcheck as port_ops

    probe = _StubProbe()
    acquirable = {"on": True}
    acquire = "_acquire_tpu_devices" if mod is twin else "_acquire_devices"
    monkeypatch.setattr(mod, acquire, lambda: ["dev0"] if acquirable["on"] else None)
    monkeypatch.setattr(twin_ops if mod is twin else port_ops,
                        "measure_node_health", probe)
    monkeypatch.setattr(mod, "FIRST_PROBE_WAIT_S", WAIT_S)
    mod.reset_burnin_schedule()
    config = conf(cli_values={"with-burnin": "true", "burnin-interval": "3",
                              "oneshot": oneshot}, environ={})
    node = _Node()
    out = []
    for step in script:
        if step == "cycle":
            labels = _translated(mod.new_health_labeler(node, config).labels())
            if health.HEALTH_PROBE_MS in labels:
                labels[health.HEALTH_PROBE_MS] = "measured"
            out.append(labels)
        elif step == "release":
            probe.gate.set()
            inflight = mod._first_probe_inflight
            if inflight is not None:
                inflight.join(10)
        elif step in ("gone", "back"):
            acquirable["on"] = step == "back"
        elif step == "reload":
            mod.reset_burnin_schedule()
            node = _Node()
    probe.gate.set()
    return out, probe.threads


SCHEDULE_SCRIPTS = {
    "slow-first-probe-then-interval": ["cycle", "cycle", "release", "cycle", "cycle",
                                       "cycle", "cycle", "cycle"],
    "abandon-on-unacquirable-gap": ["cycle", "gone", "cycle", "back", "cycle",
                                    "release", "cycle", "cycle"],
    "adopt-after-reload": ["cycle", "reload", "cycle", "release", "cycle", "cycle"],
}


@pytest.mark.parametrize("name", sorted(SCHEDULE_SCRIPTS))
def test_daemon_schedule_matches_twin(name, same_peaks, monkeypatch):
    script = SCHEDULE_SCRIPTS[name]
    want, want_threads = _schedule_run(twin, twin_new_config, monkeypatch, script)
    got, got_threads = _schedule_run(health, new_config, monkeypatch, script)
    assert got == want
    assert got_threads == want_threads
    assert got_threads[0] == "tfd-burnin-first-probe"
    assert got[0] == {}  # base labels first, health later
    if name == "adopt-after-reload":
        assert len(got_threads) == 1  # adopted, not probed twice
        assert got[2][health.HEALTH_OK] == "true"
    if name == "abandon-on-unacquirable-gap":
        # The orphan's result is discarded; a fresh first probe follows it.
        assert got[1:3] == [{}, {}]
        assert got_threads[:2] == ["tfd-burnin-first-probe"] * 2


def test_oneshot_probes_synchronously_like_twin(same_peaks, monkeypatch):
    import threading

    for mod, conf in ((twin, twin_new_config), (health, new_config)):
        got, threads = _schedule_run(mod, conf, monkeypatch, ["release", "cycle"],
                                     oneshot=True)
        assert got[0][health.HEALTH_OK] == "true"
        assert threads == [threading.current_thread().name]
