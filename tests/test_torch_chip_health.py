"""The twin's per-chip fault localisation tier (``tests/test_chip_health.py``)
held against the port (``--chip-probes``): the per-device labels of
``lm/health.py``, ``detect_straggler``/``StragglerDetector``, the
``chip.<i>.sick``/``chip.<i>.slow`` shots of ``utils/faults.py`` and their
way through the broker's ``health`` RPC, and the real per-device probe
on the CPU.

The twin's mock shapes (1/4/8 chips x 3 topology strategies) become
``mock-gpu`` nodes of 1/4/8 GPUs under each ``--tpu-topology-strategy``
(GPUs outside MIG; the per-MIG-device fold is
``tests/test_torch_mig_probe.py``'s). The label cases run both packages
(``torch_health_sides.SIDES``) through the same stubbed reports and the
same cycles and want the twin's labels under the label rule. The real
probe runs the twin on its 8 virtual CPU devices and the port on 8 CPU
device entries."""

import queue
import random
import threading
import time

import jax
import pytest
import torch

from gpu_feature_discovery_tpu.cmd.main import run as twin_run
from gpu_feature_discovery_tpu.config.flags import DEFAULT_STRAGGLER_THRESHOLD as TWIN_THRESHOLD
from gpu_feature_discovery_tpu.lm.labeler import Empty as TwinEmpty
from gpu_feature_discovery_tpu.utils import faults as twin_faults
from gpu_feature_discovery_tpu_torch.cmd.main import run
from gpu_feature_discovery_tpu_torch.config.flags import DEFAULT_STRAGGLER_THRESHOLD
from gpu_feature_discovery_tpu_torch.lm import health
from gpu_feature_discovery_tpu_torch.lm.health import (
    CHIP_HBM_FMT,
    CHIP_OK_FMT,
    CHIP_TFLOPS_FMT,
    CHIPS_HEALTHY,
    CHIPS_SICK,
    HEALTH_ICI_GBPS,
    HEALTH_OK,
    STRAGGLER_CHIP,
    StragglerDetector,
    detect_straggler,
)
from gpu_feature_discovery_tpu_torch.lm.labeler import Empty
from gpu_feature_discovery_tpu_torch.ops import healthcheck
from gpu_feature_discovery_tpu_torch.sandbox import broker as broker_mod
from gpu_feature_discovery_tpu_torch.utils import faults
from torch_env_guard import resolved_cache_dir_restored  # noqa: F401 - autouse
from torch_health_sides import SIDES, V5E_PEAKS, translated

CPU = torch.device("cpu")
FAULTS = {"twin": twin_faults, "port": faults}


@pytest.fixture(autouse=True)
def fresh_schedules(monkeypatch):
    saved = [(s.mod, s.mod.FIRST_PROBE_WAIT_S) for s in SIDES]
    for s in SIDES:
        s.mod.reset_burnin_schedule()
        s.mod._first_probe_inflight = None
        s.mod.FIRST_PROBE_WAIT_S = 300.0
        # The twin's v5e row on both sides: one report, one bound.
        monkeypatch.setattr(s.mod, "_spec_peaks", lambda manager: V5E_PEAKS)
    yield
    for mod, wait in saved:
        mod.FIRST_PROBE_WAIT_S = wait
        mod.reset_burnin_schedule()
        mod._first_probe_inflight = None
    for f in FAULTS.values():
        f.reset()


def fixed_report(n, sick=(), rates=None, hbm=None, ici_gbps=None):
    """The twin's deterministic per-chip report."""
    sick = set(sick)
    rates = rates if rates is not None else [100.0 + i for i in range(n)]
    hbm = hbm if hbm is not None else [500.0 + i for i in range(n)]
    return {
        "healthy": not sick, "tflops": min(rates), "hbm_gbps": min(hbm), "ici_ok": None,
        "chips": n, "ici_gbps": ici_gbps, "timing": "device-profiler",
        "per_chip": [{"id": i, "healthy": i not in sick, "tflops": float(rates[i]),
                      "hbm_gbps": float(hbm[i])} for i in range(n)],
    }


def fake_measure(side, monkeypatch, report_fn):
    calls = {"n": 0, "kwargs": []}

    def fake(**kw):
        calls["n"] += 1
        calls["kwargs"].append(kw)
        return report_fn(calls["n"], kw)

    monkeypatch.setattr(side.ops, "measure_node_health", fake)
    return calls


def both(case):
    out = {s.name: case(s) for s in SIDES}
    assert out["port"] == out["twin"], out
    return out["port"]


def cfg(side, **cli):
    return side.cfg(**dict({"with-burnin": "true"}, **cli))


# ---------------------------------------------------------------------------
# per-chip golden label sets
# ---------------------------------------------------------------------------

def _file_labels(path):
    return dict(l.split("=", 1) for l in path.read_text().splitlines() if "=" in l)


@pytest.mark.parametrize("strategy", ["none", "single", "mixed"])
@pytest.mark.parametrize("n", [1, 4, 8])
def test_per_chip_golden_labels(tmp_path, monkeypatch, strategy, n):
    """The oneshot file carries the exact per-device family for every
    shape and strategy, the twin's for the same report."""
    out = {}
    for s in SIDES:
        s.pretend_devices(monkeypatch)
        fake_measure(s, monkeypatch, lambda c, kw: fixed_report(n))
        path = tmp_path / f"tfd-{s.name}"
        config = cfg(s, **{"oneshot": "true", "output-file": str(path),
                           "tpu-topology-strategy": strategy,
                           "machine-type-file": str(tmp_path / "missing")})
        manager = s.manager(n)
        if s.name == "twin":
            assert twin_run(manager, TwinEmpty(), config, queue.Queue()) is False
        else:
            assert run(manager, config, queue.Queue(), interconnect=Empty()) is False
        labels = translated(_file_labels(path))
        out[s.name] = {k: v for k, v in labels.items()
                       if ".chip." in k or ".chips." in k or k in (STRAGGLER_CHIP, HEALTH_OK)}
    assert out["port"] == out["twin"]
    expected = {CHIPS_HEALTHY: str(n), CHIPS_SICK: "0", HEALTH_OK: "true"}
    for i in range(n):
        expected.update({CHIP_OK_FMT % i: "true", CHIP_TFLOPS_FMT % i: str(100 + i),
                         CHIP_HBM_FMT % i: str(500 + i)})
    assert out["port"] == expected


def test_single_sick_chip_labels(monkeypatch):
    def case(s):
        s.pretend_devices(monkeypatch)
        fake_measure(s, monkeypatch, lambda c, kw: fixed_report(8, sick={3}))
        return s.labels(s.manager(8), cfg(s))

    labels = both(case)
    assert labels[CHIP_OK_FMT % 3] == "false"
    assert all(labels[CHIP_OK_FMT % i] == "true" for i in (0, 1, 2, 4, 5, 6, 7))
    assert (labels[CHIPS_HEALTHY], labels[CHIPS_SICK], labels[HEALTH_OK]) == ("7", "1", "false")


def test_chip_probes_off_reproduces_aggregate_labels_byte_identical(tmp_path, monkeypatch):
    """--chip-probes=off writes, byte for byte, what a report without a
    per-chip table writes, in the port as in the twin."""
    files = {}
    for s in SIDES:
        s.pretend_devices(monkeypatch)

        def run_to_bytes(name, chip_probes, with_table, s=s):
            s.mod.reset_burnin_schedule()
            s.mod._first_probe_inflight = None
            report = fixed_report(4)
            if not with_table:
                report.pop("per_chip")
                report.pop("ici_gbps")
            fake_measure(s, monkeypatch, lambda c, kw: dict(report))
            path = tmp_path / f"{s.name}-{name}"
            config = cfg(s, **{"oneshot": "true", "no-timestamp": "true",
                               "output-file": str(path),
                               "machine-type-file": str(tmp_path / "missing"),
                               "chip-probes": chip_probes})
            if s.name == "twin":
                twin_run(s.manager(4), TwinEmpty(), config, queue.Queue())
            else:
                run(s.manager(4), config, queue.Queue(), interconnect=Empty())
            return path.read_bytes()

        off, legacy = run_to_bytes("off", "off", True), run_to_bytes("legacy", "on", False)
        assert off == legacy and b".chip." not in off
        files[s.name] = off
    # The health family of the two files agrees under the label rule (the
    # device families differ by the mock's spec row).
    health_keys = [{k: v for k, v in translated(dict(
        l.split("=", 1) for l in files[name].decode().splitlines())).items()
        if ".health." in k and not k.endswith("probe-ms")} for name in ("twin", "port")]
    assert health_keys[1] == health_keys[0] and health_keys[1][HEALTH_OK] == "true"


def test_chip_rates_apply_plausibility_gates(monkeypatch):
    def case(s):
        s.pretend_devices(monkeypatch)

        def report(c, kw):
            r = fixed_report(3, rates=[0.004, 100.0, 69000.0], hbm=[500.0] * 3)
            r["timing"] = "wall-clock"
            return r

        fake_measure(s, monkeypatch, report)
        return s.labels(s.manager(3), cfg(s))

    labels = both(case)
    assert CHIP_TFLOPS_FMT % 0 not in labels
    assert labels[CHIP_TFLOPS_FMT % 1] == "100"
    assert CHIP_TFLOPS_FMT % 2 not in labels
    assert all(labels[CHIP_OK_FMT % i] == "true" for i in range(3))


# ---------------------------------------------------------------------------
# straggler detection
# ---------------------------------------------------------------------------

def _twin_health():
    return SIDES[0].mod


@pytest.mark.parametrize("rates,threshold,want", [
    ([100.0] * 7 + [10.0], 0.2, 7),
    ([100.0] * 7 + [10.0], 0.05, None),
])
def test_detect_straggler_fires_below_threshold(rates, threshold, want):
    table = fixed_report(8, rates=rates)["per_chip"]
    assert detect_straggler(table, threshold) == _twin_health().detect_straggler(
        table, threshold) == want


def test_detect_straggler_needs_three_rated_chips():
    table = fixed_report(2, rates=[100.0, 1.0])["per_chip"]
    assert detect_straggler(table, 0.2) is _twin_health().detect_straggler(table, 0.2) is None


def test_detect_straggler_ignores_sick_chips():
    table = fixed_report(4, sick={0}, rates=[0.1, 100.0, 101.0, 102.0])["per_chip"]
    assert detect_straggler(table, 0.5) is _twin_health().detect_straggler(table, 0.5) is None


def _sequence_labels(s, monkeypatch, sequence, gap_at=None, fail_at=None):
    s.pretend_devices(monkeypatch)

    def report(c, kw):
        if c == fail_at:
            raise RuntimeError("probe blew up")
        return fixed_report(8, rates=sequence[min(c, len(sequence)) - 1])

    fake_measure(s, monkeypatch, report)
    manager, config = s.manager(8), cfg(s, **{"burnin-interval": "1"})
    out = []
    for cycle in range(len(sequence) + (1 if gap_at is not None else 0)):
        if cycle == gap_at:
            monkeypatch.setattr(s.mod, s.acquire_attr, lambda: None)
            out.append(s.labels(manager, config))
            s.pretend_devices(monkeypatch)
            continue
        labels = s.labels(manager, config)
        out.append((labels.get(STRAGGLER_CHIP), labels.get(HEALTH_OK)))
    return out


SLOW = [100.0] * 7 + [10.0]
CLEAN = [100.0 + i for i in range(8)]


def test_straggler_requires_consecutive_confirmation(monkeypatch):
    got = both(lambda s: _sequence_labels(s, monkeypatch, [SLOW, SLOW, CLEAN]))
    assert [g[0] for g in got] == [None, "7", None]


def test_straggler_no_false_positives_across_50_jittered_cycles():
    rng = random.Random(1234)
    assert DEFAULT_STRAGGLER_THRESHOLD == TWIN_THRESHOLD
    port, twin = (StragglerDetector(DEFAULT_STRAGGLER_THRESHOLD),
                  _twin_health().StragglerDetector(TWIN_THRESHOLD))
    for _ in range(50):
        table = fixed_report(8, rates=[100.0 * rng.uniform(0.7, 1.3) for _ in range(8)])["per_chip"]
        assert port.observe(table) is twin.observe(table) is None


def test_straggler_streak_resets_across_unacquirable_gap(monkeypatch):
    got = both(lambda s: _sequence_labels(s, monkeypatch, [SLOW] * 3, gap_at=1))
    assert got == [(None, "true"), {}, (None, "true"), ("7", "true")]


def test_straggler_streak_resets_across_failed_probe(monkeypatch):
    got = both(lambda s: _sequence_labels(s, monkeypatch, [SLOW] * 4, fail_at=2))
    assert got == [(None, "true"), (None, "false"), (None, "true"), ("7", "true")]


def test_corrupt_allreduce_suppresses_gbps_label(monkeypatch):
    def case(s):
        s.pretend_devices(monkeypatch)

        def report(c, kw):
            r = fixed_report(8, ici_gbps=123.0)
            r["chips_allreduce_ok"] = False
            return r

        fake_measure(s, monkeypatch, report)
        return HEALTH_ICI_GBPS in s.labels(s.manager(8), cfg(s))

    assert both(case) is False


def test_measure_folds_allreduce_disagreement_into_ici_ok(monkeypatch):
    twin_ops = SIDES[0].ops
    devices = jax.local_devices()
    monkeypatch.setattr(twin_ops, "sharded_chip_verdicts", lambda *a, **k: ([True] * 8, False))
    monkeypatch.setattr(healthcheck, "sharded_chip_verdicts", lambda *a, **k: ([True] * 8, False))
    want = twin_ops.measure_node_health(per_chip=True, ici=False, devices=devices,
                                        size=64, depth=1, iters=1)
    got = healthcheck.measure_node_health(per_chip=True, ici=False, devices=[CPU] * 8,
                                          size=64, depth=1, iters=1)
    assert got["chips_allreduce_ok"] is want["chips_allreduce_ok"] is False
    assert got["ici_ok"] is want["ici_ok"] is False


def test_warm_skips_per_chip_programs_when_disabled(monkeypatch):
    """--chip-probes=off warms no per-device program. The port warms CUDA
    devices only (the CPU runs no kernel worth warming), so its warm-up
    is called with stand-in CUDA devices and its inner warm recorded."""
    calls = []
    monkeypatch.setattr(healthcheck, "_warm_probe_kernels",
                        lambda devices, size, depth, per_chip: calls.append(per_chip) or 0.0)
    cuda = (torch.device("cuda", 0), torch.device("cuda", 1))
    healthcheck.warm_probe_kernels_for(cuda, per_chip=False)
    healthcheck.warm_probe_kernels_for(cuda)
    assert calls == [False, True]
    assert healthcheck.warm_probe_kernels_for((CPU,)) == 0.0


def test_out_of_range_chip_fault_index_warns(caplog):
    import logging

    with caplog.at_level(logging.WARNING):
        report = healthcheck.measure_node_health(per_chip=True, ici=False, devices=[CPU] * 8,
                                                 size=64, depth=1, iters=1,
                                                 sick_chips=frozenset({99}))
        twin_report = SIDES[0].ops.measure_node_health(
            per_chip=True, ici=False, devices=jax.local_devices(), size=64, depth=1, iters=1,
            sick_chips=frozenset({99}))
    assert caplog.text.count("outside the") == 2
    assert all(e["healthy"] for e in report["per_chip"])
    assert all(e["healthy"] for e in twin_report["per_chip"])


@pytest.mark.parametrize("raw,valid", [("0", False), ("1.0", False), ("nope", False),
                                       ("0.4", True), (None, True)])
def test_straggler_threshold_flag_validation(raw, valid):
    from gpu_feature_discovery_tpu.config.spec import ConfigError as TwinConfigError
    from gpu_feature_discovery_tpu_torch.config.spec import ConfigError

    cli = {} if raw is None else {"straggler-threshold": raw}
    for s, error in zip(SIDES, (TwinConfigError, ConfigError)):
        if not valid:
            with pytest.raises(error):
                s.cfg(**cli)
        else:
            got = s.cfg(**cli).flags.tfd.straggler_threshold
            assert got == (0.4 if raw else DEFAULT_STRAGGLER_THRESHOLD)


# ---------------------------------------------------------------------------
# the chip.<i>.* fault sites and the broker RPC
# ---------------------------------------------------------------------------

def test_chip_faults_consumed_at_probe_launch(monkeypatch):
    def case(s):
        s.pretend_devices(monkeypatch)
        calls = fake_measure(s, monkeypatch,
                             lambda c, kw: fixed_report(8, sick=kw.get("sick_chips") or ()))
        FAULTS[s.name].load_fault_spec("chip.3.sick:fail:1,chip.5.slow:fail:1")
        manager, config = s.manager(8), cfg(s, **{"burnin-interval": "1"})
        first = s.labels(manager, config)[CHIP_OK_FMT % 3]
        second = s.labels(manager, config)[CHIP_OK_FMT % 3]
        kw0, kw1 = calls["kwargs"][0], calls["kwargs"][1]
        return (first, second, kw0["sick_chips"], kw0["slow_chips"], kw0["per_chip"],
                kw1["sick_chips"])

    assert both(case) == ("false", "true", frozenset({3}), frozenset({5}), True, frozenset())


def test_chip_faults_noop_with_chip_probes_off(monkeypatch):
    def case(s):
        s.pretend_devices(monkeypatch)
        calls = fake_measure(s, monkeypatch, lambda c, kw: fixed_report(4))
        reg = FAULTS[s.name].load_fault_spec("chip.1.sick:fail:1")
        s.labels(s.manager(4), cfg(s, **{"chip-probes": "off"}))
        kw = calls["kwargs"][0]
        return kw["per_chip"], kw.get("sick_chips", frozenset()), reg.armed_sites()

    assert both(case) == (False, frozenset(), ("chip.1.sick",))


def _broker_manager(s, outcomes, shipped, n=4):
    """A manager whose broker answers ``outcomes`` in turn, recording the
    sick indices each RPC shipped."""

    class FakeBroker:
        def health(self, per_chip=True, sick_chips=(), slow_chips=(), **kw):
            shipped.append(list(sick_chips))
            out = next(outcomes)
            if isinstance(out, Exception):
                raise out
            return out

        def kill_child(self):
            pass

    class FakeManager(s.testing.MockManager):
        broker = FakeBroker()

    return FakeManager(chips=[s.chip() for _ in range(n)])


def _ok(sick=()):
    return {"status": "ok", "report": fixed_report(4, sick=set(sick)), "probe_ms": 5.0}


def test_broker_health_rpc_carries_chip_faults():
    def case(s):
        shipped = []
        FAULTS[s.name].load_fault_spec("chip.2.sick:fail:1")
        manager = _broker_manager(s, iter([_ok(sick={2})]), shipped)
        labels = s.labels(manager, cfg(s))
        return shipped, labels[CHIP_OK_FMT % 2], labels[CHIPS_SICK]

    assert both(case) == ([[2]], "false", "1")


def test_broker_warming_cycles_do_not_burn_chip_shots():
    def case(s):
        shipped = []
        reg = FAULTS[s.name].load_fault_spec("chip.1.sick:fail:1,chip.3.sick:fail:1")
        manager = _broker_manager(
            s, iter([{"status": "warming"}, {"status": "warming"}, _ok()]), shipped)
        config = cfg(s, **{"burnin-interval": "1"})
        for _ in range(3):
            s.labels(manager, config)
        return shipped, reg.armed_sites()

    assert both(case) == ([[1, 3], [], []], ())


def test_broker_unacquirable_rearms_chip_fault_shots():
    def case(s):
        shipped = []
        reg = FAULTS[s.name].load_fault_spec("chip.2.sick:fail:1")
        manager = _broker_manager(s, iter([{"status": "unacquirable"}, _ok(sick={2})]), shipped)
        config = cfg(s, **{"burnin-interval": "1"})
        s.labels(manager, config)
        armed = reg.armed_sites()
        labels = s.labels(manager, config)
        return shipped, armed, labels[CHIP_OK_FMT % 2]

    assert both(case) == ([[2], [2]], ("chip.2.sick",), "false")


def test_broker_rpc_failure_rearms_chip_fault_shots():
    def case(s):
        shipped = []
        reg = FAULTS[s.name].load_fault_spec("chip.1.sick:fail:1")
        manager = _broker_manager(
            s, iter([RuntimeError("worker died mid-request"), _ok(sick={1})]), shipped)
        config = cfg(s, **{"burnin-interval": "1"})
        with pytest.raises(RuntimeError):
            s.labels(manager, config)
        armed = reg.armed_sites()
        pending = s.mod._schedule_for(manager).broker_probe_pending
        labels = s.labels(manager, config)
        return shipped, armed, pending, labels[CHIP_OK_FMT % 1]

    assert both(case) == ([[1], [1]], ("chip.1.sick",), False, "false")


def test_broker_death_after_warming_rearms_shipped_chip_shots():
    def case(s):
        shipped = []
        reg = FAULTS[s.name].load_fault_spec("chip.3.sick:fail:1")
        manager = _broker_manager(s, iter([{"status": "warming"},
                                           RuntimeError("worker died before collect"),
                                           _ok(sick={3})]), shipped)
        config = cfg(s, **{"burnin-interval": "1"})
        s.labels(manager, config)
        with pytest.raises(RuntimeError):
            s.labels(manager, config)
        sched = s.mod._schedule_for(manager)
        state = (reg.armed_sites(), sched.broker_probe_pending, sched.pending_chip_faults)
        labels = s.labels(manager, config)
        return shipped, state, labels[CHIP_OK_FMT % 3]

    assert both(case) == ([[3], [], [3]], (("chip.3.sick",), False, (frozenset(), frozenset())),
                          "false")


def test_per_device_rates_map_by_inventory_index_not_probe_order():
    """The twin maps profiler planes by the host-local ordinal, never the
    global id (``_plane_device_rates``). The port has no profiler plane:
    each device's rate is its own event window, and what must not slip is
    the join of a probed device to the inventory's NVML index, which
    rides its UUID (``_label_indices``, fault 5): a probe table in another
    order keeps each rate on its own GPU's labels."""
    from gpu_feature_discovery_tpu.ops.healthcheck import _plane_device_rates

    class Dev:
        def __init__(self, gid, local=None):
            self.id = gid
            if local is not None:
                self.local_hardware_id = local

    planes = {f"/device:TPU:{k}": float(10 + k) for k in range(8)}
    assert _plane_device_rates(planes, [Dev(8 + k, local=k) for k in range(8)]) == [
        float(10 + k) for k in range(8)]
    assert _plane_device_rates(planes, [Dev(8 + k) for k in range(8)]) == [
        float(10 + k) for k in range(8)]

    class Gpu(SIDES[1].testing.MockChip):
        def __init__(self, uuid):
            super().__init__(name="NVIDIA H100 80GB HBM3")
            self._uuid = uuid

        def get_uuid(self):
            return self._uuid

    uuids = [f"GPU-{k:08x}-0000-0000-0000-000000000000" for k in range(4)]
    manager = SIDES[1].testing.MockManager(chips=[Gpu(u) for u in uuids])
    table = fixed_report(4, rates=[10.0, 11.0, 12.0, 13.0])["per_chip"]
    for pos, entry in enumerate(table):
        entry["uuid"] = uuids[3 - pos]  # the probe saw NVML's GPUs in reverse
    assert health._label_indices(manager, table) == [3, 2, 1, 0]
    assert health._label_indices(SIDES[1].manager(4), table) == [0, 1, 2, 3]  # no UUIDs


def test_worker_health_probe_enacts_rpc_chip_faults(monkeypatch):
    seen = {}

    def measure(devices=None, **kw):
        seen.update(kw)
        return fixed_report(2, sick=kw.get("sick_chips") or ())

    monkeypatch.setattr(health, "_acquire_devices", lambda: ["dev"])
    monkeypatch.setattr(healthcheck, "measure_node_health", measure)
    probe = broker_mod._HealthProbe(threading.Lock())
    deadline = time.monotonic() + 10
    outcome = probe.request({"per_chip": True, "sick_chips": [1]})
    while outcome["status"] == "warming" and time.monotonic() < deadline:
        outcome = probe.request()
    assert outcome["status"] == "ok"
    assert seen["per_chip"] is True and seen["sick_chips"] == frozenset({1})
    assert outcome["report"]["per_chip"][1]["healthy"] is False


# ---------------------------------------------------------------------------
# the real per-device probe on the CPU
# ---------------------------------------------------------------------------

def test_acceptance_sick_chip_localized_on_real_8_device_probe(monkeypatch):
    monkeypatch.setenv("TFD_BURNIN_GEOMETRY", "128x2")
    out = {}
    for s in SIDES:
        devices = jax.local_devices() if s.name == "twin" else [CPU] * 8
        monkeypatch.setattr(s.mod, s.acquire_attr, lambda d=devices: d)
        FAULTS[s.name].load_fault_spec("chip.3.sick:fail:1")
        manager, config = s.manager(8), cfg(s, **{"oneshot": "true", "burnin-interval": "1"})
        keys = [CHIP_OK_FMT % i for i in range(8)] + [CHIPS_SICK, HEALTH_OK]
        first = s.labels(manager, config)
        second = s.labels(manager, config)
        out[s.name] = [[labels[k] for k in keys] for labels in (first, second)]
    assert out["port"] == out["twin"]
    assert out["port"][0] == ["true"] * 3 + ["false"] + ["true"] * 4 + ["1", "false"]
    assert out["port"][1] == ["true"] * 8 + ["0", "true"]


def test_real_probe_reports_allreduce_and_no_cpu_ici_rate():
    want = SIDES[0].ops.measure_node_health(size=128, depth=2, iters=1, ici=False,
                                            per_chip=True, devices=jax.local_devices())
    got = healthcheck.measure_node_health(size=128, depth=2, iters=1, ici=False,
                                          per_chip=True, devices=[CPU] * 8)
    for report in (want, got):
        assert report["chips_allreduce_ok"] is True
        assert report["ici_gbps"] is None
        assert len(report["per_chip"]) == 8
        assert all(e["healthy"] for e in report["per_chip"])
        assert "sharded_verdict_ms" in report["phases"]
        assert "ici_allreduce_ms" not in report["phases"]


def test_ici_allreduce_probe_direct():
    want = SIDES[0].ops.ici_allreduce_probe(jax.local_devices(), mib_per_chip=1, iters=2)
    got = healthcheck.ici_allreduce_probe([CPU] * 8, mib_per_chip=1, iters=2)
    assert got["checksum_ok"] is want["checksum_ok"] is True
    assert got["devices"] == want["devices"] == 8
    assert want["gbps"] > 0
    # The CPU's collective is the plain host sum: no link, no rate.
    assert got.get("gbps") is None or got["gbps"] >= 0
