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


# ---------------------------------------------------------------------------
# The rest of the twin's tests/test_health.py: gating, the schedule's
# cache and failure rules, plausibility, methodology and the compile
# metric. Each case runs in both packages (SIDES): the same manager shape,
# the same stubbed probe report, the same cycles; the twin's labels,
# translated, must equal the port's, and the probe counts must match.
# Where a case reads spec peaks, both sides are given the twin's v5e row
# (197 TFLOP/s, 819 GB/s) so the same report meets the same bounds.
# ---------------------------------------------------------------------------

from gpu_feature_discovery_tpu.resource import testing as twin_testing  # noqa: E402
from gpu_feature_discovery_tpu_torch.ops import healthcheck as port_ops  # noqa: E402
from gpu_feature_discovery_tpu_torch.resource import testing as port_testing  # noqa: E402
from torch_health_sides import SIDES, V5E_PEAKS  # noqa: E402


@pytest.fixture
def fresh_schedules():
    """The schedule is process-global in both packages; the first-probe
    join budget is pinned high so these cases stay synchronous, as the
    twin's fixture does."""
    saved = [(s.mod, s.mod.FIRST_PROBE_WAIT_S) for s in SIDES]
    for s in SIDES:
        s.mod.reset_burnin_schedule()
        s.mod._first_probe_inflight = None
        s.mod.FIRST_PROBE_WAIT_S = 300.0
    yield
    for mod, wait in saved:
        mod.FIRST_PROBE_WAIT_S = wait
        mod.reset_burnin_schedule()
        mod._first_probe_inflight = None


def _both(case):
    out = {s.name: case(s) for s in SIDES}
    assert out["port"] == out["twin"], out
    return out["port"]


def test_disabled_by_default(fresh_schedules):
    assert _both(lambda s: s.labels(s.manager(), s.cfg())) == {}


def test_empty_without_chips(fresh_schedules):
    assert _both(lambda s: s.labels(s.testing.MockManager(),
                                    s.cfg(**{"with-burnin": "true"}))) == {}


def test_no_devices_publishes_nothing(fresh_schedules):
    """The CPU test host is the no-accelerator case in both packages:
    neither ok=true (a CPU matmul is no device health) nor ok=false."""
    assert _both(lambda s: s.labels(s.manager(), s.cfg(**{"with-burnin": "true"}))) == {}


def test_acquisition_failure_publishes_nothing(fresh_schedules, monkeypatch):
    def case(s):
        monkeypatch.setattr(s.mod, s.acquire_attr, lambda: None)
        return s.labels(s.manager(), s.cfg(**{"with-burnin": "true"}))

    assert _both(case) == {}


def test_enabled_emits_health_labels(fresh_schedules, monkeypatch):
    """The real probe on the CPU (the twin's 8-device mesh, the port's one
    CPU device at a small geometry): ok=true; a rate, when it clears the
    1 TFLOP/s floor, is a plausible integer."""
    monkeypatch.setenv(port_ops.BURNIN_GEOMETRY_ENV, "128x2")
    for s in SIDES:
        s.pretend_devices(monkeypatch)
        labels = s.labels(s.manager(), s.cfg(**{"with-burnin": "true"}))
        assert labels[HEALTH_OK_KEY] == "true", s.name
        if health.HEALTH_TFLOPS in labels:
            assert int(labels[health.HEALTH_TFLOPS]) >= 1


HEALTH_OK_KEY = health.HEALTH_OK


def test_env_alias_enables(fresh_schedules, monkeypatch):
    def case(s):
        s.pretend_devices(monkeypatch)
        s.counting_measure(monkeypatch)
        config = s.conf(cli_values={}, environ={"TFD_WITH_BURNIN": "true"}, config_file=None)
        return HEALTH_OK_KEY in s.labels(s.manager(), config)

    assert _both(case) is True


def test_burnin_interval_caches_between_probes(fresh_schedules, monkeypatch):
    def case(s):
        s.pretend_devices(monkeypatch)
        calls = s.counting_measure(monkeypatch)
        manager, config = s.manager(), s.cfg(**{"with-burnin": "true", "burnin-interval": "5"})
        results = [s.labels(manager, config) for _ in range(10)]
        assert all(r[HEALTH_OK_KEY] == "true" for r in results)
        return calls["n"], [i for i, r in enumerate(results) if health.HEALTH_PROBE_MS in r]

    assert _both(case) == (2, [0, 5])


def test_burnin_interval_one_probes_every_cycle(fresh_schedules, monkeypatch):
    def case(s):
        s.pretend_devices(monkeypatch)
        calls = s.counting_measure(monkeypatch)
        manager, config = s.manager(), s.cfg(**{"with-burnin": "true", "burnin-interval": "1"})
        for _ in range(3):
            s.labels(manager, config)
        return calls["n"]

    assert _both(case) == 3


def test_acquisition_failure_drops_cache(fresh_schedules, monkeypatch):
    def case(s):
        s.pretend_devices(monkeypatch)
        calls = s.counting_measure(monkeypatch)
        manager, config = s.manager(), s.cfg(**{"with-burnin": "true", "burnin-interval": "2"})
        first = s.labels(manager, config)[HEALTH_OK_KEY]
        monkeypatch.setattr(s.mod, s.acquire_attr, lambda: None)
        return first, [s.labels(manager, config) for _ in range(3)], calls["n"]

    assert _both(case) == ("true", [{}, {}, {}], 1)


def _flaky(s, monkeypatch, fail_first_only):
    calls = {"n": 0}

    def measure(**kw):
        calls["n"] += 1
        if calls["n"] == 1 or not fail_first_only:
            raise RuntimeError("transient link hiccup")
        return {"healthy": True, "tflops": 10.0, "hbm_gbps": None, "ici_ok": None}

    monkeypatch.setattr(s.ops, "measure_node_health", measure)
    return calls


def test_transient_burnin_failure_reprobes_next_cycle(fresh_schedules, monkeypatch):
    def case(s):
        s.pretend_devices(monkeypatch)
        calls = _flaky(s, monkeypatch, fail_first_only=True)
        manager, config = s.manager(), s.cfg(**{"with-burnin": "true", "burnin-interval": "5"})
        return [s.labels(manager, config)[HEALTH_OK_KEY] for _ in range(2)], calls["n"]

    assert _both(case) == (["false", "true"], 2)


def test_persistent_burnin_failure_is_throttled(fresh_schedules, monkeypatch):
    def case(s):
        s.pretend_devices(monkeypatch)
        calls = _flaky(s, monkeypatch, fail_first_only=False)
        manager, config = s.manager(), s.cfg(**{"with-burnin": "true", "burnin-interval": "5"})
        results = [s.labels(manager, config)[HEALTH_OK_KEY] for _ in range(10)]
        return set(results), calls["n"]

    # Cycle 0 probes, cycle 1 retries at once, the failure is cached, and
    # cycle 5 is the next re-probe.
    assert _both(case) == ({"false"}, 3)


def test_two_managers_have_independent_schedules(fresh_schedules, monkeypatch):
    def case(s):
        s.pretend_devices(monkeypatch)
        calls = s.counting_measure(monkeypatch)
        m1, m2 = s.manager(), s.manager()
        config = s.cfg(**{"with-burnin": "true", "burnin-interval": "5"})
        seen = [s.labels(m1, config)[HEALTH_OK_KEY], calls["n"],
                s.labels(m2, config)[HEALTH_OK_KEY], calls["n"]]
        s.labels(m1, config)
        s.labels(m2, config)
        return seen + [calls["n"]]

    assert _both(case) == ["true", 1, "true", 2, 2]


@pytest.mark.parametrize("raw,valid", [("0", False), ("abc", False), ("7", True), (None, True)])
def test_burnin_interval_config_validation(raw, valid):
    from gpu_feature_discovery_tpu.config.spec import ConfigError as TwinConfigError
    from gpu_feature_discovery_tpu_torch.config.spec import ConfigError

    cli = {} if raw is None else {"burnin-interval": raw}
    for conf, error in ((twin_new_config, TwinConfigError), (new_config, ConfigError)):
        if not valid:
            with pytest.raises(error):
                conf(cli_values=cli, environ={})
        else:
            got = conf(cli_values=cli, environ={}).flags.tfd.burnin_interval
            assert got == (7 if raw else 10)


def test_async_first_probe_failure_keeps_failure_semantics(fresh_schedules, monkeypatch):
    def case(s):
        s.pretend_devices(monkeypatch)
        monkeypatch.setattr(s.ops, "measure_node_health",
                            lambda **kw: (_ for _ in ()).throw(RuntimeError("boom")))
        manager, config = s.manager(), s.cfg(**{"with-burnin": "true", "burnin-interval": "5"})
        first = s.labels(manager, config)
        sched = s.mod._schedule_for(manager)
        cached_after_first = sched.cached
        second = s.labels(manager, config)
        return first, cached_after_first, second, _translated(dict(sched.cached))

    off = {HEALTH_OK_KEY: "false"}
    assert _both(case) == (off, None, off, off)


def _fixed(s, monkeypatch, report):
    monkeypatch.setattr(s.ops, "measure_node_health", lambda **kw: dict(report))


def _rated(report, peaks=V5E_PEAKS):
    """The labels of one probe of ``report`` in both packages, the spec
    peaks of both sides set to ``peaks``."""
    def case(s):
        s.pretend_devices(case.monkeypatch)
        _fixed(s, case.monkeypatch, report)
        case.monkeypatch.setattr(s.mod, "_spec_peaks", lambda manager: peaks)
        return s.labels(s.manager(), s.cfg(**{"with-burnin": "true"}))
    return case


def test_timing_methodology_is_published(fresh_schedules, monkeypatch):
    case = _rated({"healthy": True, "tflops": 10.0, "hbm_gbps": 500.0, "ici_ok": None,
                   "timing": "device-profiler"})
    case.monkeypatch = monkeypatch
    assert _both(case)[health.HEALTH_TIMING] == "device-profiler"


def test_rates_at_spec_peak_publish(fresh_schedules, monkeypatch):
    case = _rated({"healthy": True, "tflops": 197.0, "hbm_gbps": 819.0, "ici_ok": None,
                   "timing": "device-profiler"})
    case.monkeypatch = monkeypatch
    labels = _both(case)
    assert labels[health.HEALTH_TFLOPS] == "197" and labels[health.HEALTH_HBM] == "819"
    # And on the port's own H100 row: 989 TFLOP/s and 3350 GB/s publish.
    monkeypatch.undo()
    s = SIDES[1]
    s.pretend_devices(monkeypatch)
    _fixed(s, monkeypatch, {"healthy": True, "tflops": 989.0, "hbm_gbps": 3350.0,
                            "ici_ok": None, "timing": "device-profiler"})
    health.reset_burnin_schedule()
    own = s.labels(s.manager(), s.cfg(**{"with-burnin": "true"}))
    assert own[health.HEALTH_TFLOPS] == "989" and own[health.HEALTH_HBM] == "3350"


def test_unknown_family_applies_no_upper_bound(fresh_schedules, monkeypatch):
    case = _rated({"healthy": True, "tflops": 5000.0, "hbm_gbps": 9000.0, "ici_ok": None,
                   "timing": "device-profiler"}, peaks=(0.0, 0.0))
    case.monkeypatch = monkeypatch
    labels = _both(case)
    assert labels[health.HEALTH_TFLOPS] == "5000" and labels[health.HEALTH_HBM] == "9000"


def test_device_clock_degraded_rates_publish(fresh_schedules, monkeypatch):
    case = _rated({"healthy": True, "tflops": 0.8, "hbm_gbps": 0.4, "ici_ok": None,
                   "timing": "device-profiler"})
    case.monkeypatch = monkeypatch
    labels = _both(case)
    assert labels[health.HEALTH_TFLOPS] == "0" and labels[health.HEALTH_HBM] == "0"


def test_mixed_node_bounds_by_fastest_family():
    """The twin's v5e + v5p node is bounded by v5p's row; the port's node
    of an H100 and a card with no row by the H100's."""
    twin_node = twin_testing.MockManager(chips=[twin_testing.MockChip(family="v5e"),
                                                twin_testing.MockChip(family="v5p")])
    assert twin._spec_peaks(twin_node) == (459.0, 2765.0)
    port_node = port_testing.MockManager(chips=[
        port_testing.MockChip(name="NVIDIA L4"),
        port_testing.MockChip(name="NVIDIA H100 80GB HBM3")])
    assert health._spec_peaks(port_node) == PEAKS


def test_first_probe_compile_metric_fed_from_report_phases(fresh_schedules, monkeypatch):
    def case(s):
        s.metrics.reset_for_tests()
        s.pretend_devices(monkeypatch)
        report = {"healthy": True, "tflops": 10.0, "hbm_gbps": 500.0, "ici_ok": None,
                  "timing": "device-profiler",
                  "phases": {"compile_ms": 8500.0, "trace_ms": 1100.0}}
        _fixed(s, monkeypatch, report)
        manager = s.manager()
        ok = s.labels(manager, s.cfg(**{"with-burnin": "true"}))[HEALTH_OK_KEY]
        first = s.metrics.FIRST_PROBE_COMPILE.value()
        _fixed(s, monkeypatch, dict(report, phases={"compile_ms": 0.0}))
        s.labels(manager, s.cfg(**{"with-burnin": "true", "burnin-interval": "1"}))
        return ok, first, s.metrics.FIRST_PROBE_COMPILE.value()

    assert _both(case) == ("true", pytest.approx(8.5), pytest.approx(8.5))
