"""The probe of a MIG node in the PyTorch port, on the CPU, against the
twin's contract: every device the inventory counts is probed (the plain
GPUs by the classic probe, each MIG device by a process pinned to it by
``CUDA_VISIBLE_DEVICES=<its MIG UUID>``), the node's verdict is ``all()``
over them and the per-device labels count what ``gpu.count`` counts
(resource/probe_targets.py has the table).

- MIG UUIDs from FakeNvml through the NVML decoding, the managers and
  the broker's snapshot;
- the probe targets of every ``LAYOUTS`` entry under every strategy,
  against ``gpu.count`` as the strategy labeler publishes it;
- the fold under a valid ``single`` against the twin's
  ``_labels_from_probe`` on the same seeded per-device tables (numpy),
  and under ``none``/``mixed`` the plain GPUs' labels against the twin's
  beside MIG GPUs that follow the table;
- the real pinned processes: one-shot children on both paths, each
  seeing one device, their hang and crash costing their own device only,
  none outliving its round, the cancel hook killing a round's children,
  and the two paths giving the same labels;
- no label key, metric family or flag that the twin lacks.

Fault 6, the ``half`` node and a hung or crashed worker through the
labeler are held in tests/test_torch_nvml.py beside the fake
``torch.cuda`` they need; a sick MIG device's way to ``slice.sick-chips``
and cordon advice in tests/test_torch_actuation.py.
"""

import json
import os
import re
import signal
import time

import numpy as np
import pytest

from gpu_feature_discovery_tpu.config.flags import FLAG_DEFS as TWIN_FLAG_DEFS
from gpu_feature_discovery_tpu.config.flags import new_config as twin_new_config
from gpu_feature_discovery_tpu.lm import health as twin_health
from gpu_feature_discovery_tpu.obs import metrics as twin_metrics
from gpu_feature_discovery_tpu_torch import sandbox
from gpu_feature_discovery_tpu_torch.config.flags import FLAG_DEFS, new_config
from gpu_feature_discovery_tpu_torch.lm import health
from gpu_feature_discovery_tpu_torch.lm.engine import LabelEngine
from gpu_feature_discovery_tpu_torch.lm.labelers import new_label_sources
from gpu_feature_discovery_tpu_torch.native import nvml
from gpu_feature_discovery_tpu_torch.obs import metrics as obs_metrics
from gpu_feature_discovery_tpu_torch.resource.nvml_backend import NvmlManager
from gpu_feature_discovery_tpu_torch.resource.probe_targets import probe_targets
from gpu_feature_discovery_tpu_torch.resource.testing import (
    LAYOUTS,
    FakeGpu,
    FakeNvml,
    fake_mig_uuid,
    fake_nvml,
    fake_uuid,
)
from gpu_feature_discovery_tpu_torch.sandbox import broker as broker_mod
from gpu_feature_discovery_tpu_torch.sandbox.snapshot import DeviceSnapshot, SnapshotManager
from gpu_feature_discovery_tpu_torch.utils import faults
from gpu_feature_discovery_tpu_torch.utils import logging as tfd_logging

STRATEGIES = ["none", "single", "mixed"]
GPU, TPU = "nvidia.com/gpu.", "google.com/tpu."
PER_DEVICE = re.compile(r"nvidia\.com/gpu\.(chip\.\d+\.|chips\.|straggler-chip$)")


def _inited(manager):
    manager.init()
    return manager


def _config(strategy="none", **cli):
    return new_config(cli_values={"tpu-topology-strategy": strategy, "with-burnin": "true",
                                  "burnin-interval": "1", "machine-type-file": "",
                                  **cli}, environ={})


def _device_labels(manager, strategy):
    config = new_config(cli_values={"tpu-topology-strategy": strategy,
                                    "machine-type-file": ""}, environ={})
    return dict(LabelEngine(parallel=False).generate(new_label_sources(manager, config)))


def _mig_gpu(n, profile="1g.10gb", mig_uuids=()):
    return FakeGpu(bus_id=None, mig_mode=nvml.NVML_DEVICE_MIG_ENABLE, mig=[profile] * n,
                   mig_uuids=mig_uuids)


# ---------------------------------------------------------------------------
# MIG UUIDs through FakeNvml and the snapshot
# ---------------------------------------------------------------------------

def test_mig_uuids_cross_fakenvml_the_managers_and_the_snapshot():
    fake = fake_nvml("mixed")
    inv = nvml.read_inventory(fake)
    for i, device in enumerate(inv.devices):
        populated = [slot for slot, p in enumerate(LAYOUTS["mixed"][i].mig) if p]
        assert [m.slot for m in device.mig_devices] == populated
        assert [m.uuid for m in device.mig_devices] == [fake_mig_uuid(i, s) for s in populated]
        assert all(m.uuid.startswith("MIG-") for m in device.mig_devices)
    assert fake.calls["nvmlDeviceGetUUID"] == 2 + 6
    manager = _inited(NvmlManager(fake_nvml("mixed")))
    want = [[m.uuid for m in d.mig_devices] for d in inv.devices]
    assert [[s.get_uuid() for s in c.get_slices()] for c in manager.get_chips()] == want
    # Across the broker's pipe: JSON, then the labeling process's manager.
    doc = json.loads(json.dumps(DeviceSnapshot.from_manager(manager).to_dict()))
    snap = SnapshotManager(DeviceSnapshot.from_dict(doc))
    assert [[s.get_uuid() for s in c.get_slices()] for c in snap.get_chips()] == want
    assert [c.get_uuid() for c in snap.get_chips()] == [fake_uuid(0), fake_uuid(1)]


def test_a_fake_gpu_names_its_mig_devices_by_the_given_uuids():
    """The card stand-in: MIG devices named by a real GPU's UUID."""
    card = "GPU-2b7f0c5a-91d3-4e8f-a2c1-6d0e9f3b4a57"
    (device,) = nvml.read_inventory(FakeNvml([_mig_gpu(3, mig_uuids=[card] * 3)])).devices
    assert [m.uuid for m in device.mig_devices] == [card] * 3
    targets = probe_targets(_inited(NvmlManager(FakeNvml([_mig_gpu(3, mig_uuids=[card] * 3)]))),
                            "single")
    assert [t.uuid for t in targets.mig] == [card] * 3
    assert len({t.key for t in targets.mig}) == 3, "one worker per device, not per UUID"


def test_normalize_uuid_takes_nvmls_mig_spelling():
    assert nvml.normalize_uuid("MIG-2B7F0C5A-91D3-4E8F-A2C1-6D0E9F3B4A57") == \
        "2b7f0c5a-91d3-4e8f-a2c1-6d0e9f3b4a57"
    assert nvml.normalize_uuid(" mig-abc ") == nvml.normalize_uuid("GPU-ABC") == "abc"


# ---------------------------------------------------------------------------
# The probe targets of every layout under every strategy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_probe_targets_count_what_gpu_count_counts(layout, strategy):
    """The label indices the targets give, against the strategy labeler's
    gpu.count on the same inventory. An empty MIG-enabled GPU (``empty``)
    is probed by nothing and counts as neither healthy nor sick; that is
    the one place where the per-device labels count less than gpu.count,
    as the reference's ``mixed`` ignores such a GPU."""
    manager = _inited(NvmlManager(fake_nvml(layout)))
    targets = probe_targets(manager, strategy)
    gpus = LAYOUTS[layout]
    mig_gpus = [i for i, g in enumerate(gpus) if g.mig_mode == nvml.NVML_DEVICE_MIG_ENABLE]
    if not mig_gpus:
        assert targets is None
        return
    count = int(_device_labels(manager, strategy)["nvidia.com/gpu.count"])
    devices = [(i, s) for i in mig_gpus for s in range(len([p for p in gpus[i].mig if p]))]
    assert [(t.gpu, t.slot) for t in targets.mig] == devices
    assert [t.uuid for t in targets.mig] == [
        u for i in mig_gpus for u in (m.uuid for m in nvml.read_inventory(
            fake_nvml(layout)).devices[i].mig_devices)]
    assert targets.plain == tuple(i for i in range(len(gpus)) if i not in mig_gpus)
    assert targets.gpu_uuids == tuple(fake_uuid(i) for i in range(len(gpus)))
    if strategy == "single" and count == 0:
        # INVALID: no per-device label at all.
        assert not targets.per_device and targets.problem
    elif strategy == "single":
        assert targets.per_mig_device and count == len(devices)
        assert [t.index for t in targets.mig] == list(range(count))
    else:
        assert targets.per_device and not targets.per_mig_device
        assert count == len(gpus)
        assert [t.index for t in targets.mig] == [t.gpu for t in targets.mig]
        indexed = set(targets.plain) | {t.gpu for t in targets.mig}
        empty = [i for i in mig_gpus if not [p for p in gpus[i].mig if p]]
        assert len(indexed) == count - len(empty)


def test_fault_shots_name_the_label_index():
    """Under a valid single, ``chip.<i>.*`` names the i-th MIG device;
    under none/mixed a plain GPU's index goes to the classic probe and a
    MIG GPU's to its first MIG device."""
    single = probe_targets(_inited(NvmlManager(fake_nvml("single"))), "single")
    classic, mig = single.route_faults({3}, {0, 9})
    assert classic == (frozenset(), frozenset())
    assert mig == {single.mig[3].key: (frozenset({3}), frozenset()),
                   single.mig[0].key: (frozenset(), frozenset({0}))}
    half = probe_targets(_inited(NvmlManager(fake_nvml("half"))), "none")
    classic, mig = half.route_faults({0, 1}, set())
    assert classic == (frozenset({1}), frozenset())
    assert mig == {half.mig[0].key: (frozenset({0}), frozenset())}


# ---------------------------------------------------------------------------
# The fold under a valid single against the twin
# ---------------------------------------------------------------------------

def _seeded_entries(seed, n):
    """n devices' per-device results, seeded: rates inside the H100's
    plausible band, a sick device now and then, one slow device."""
    rng = np.random.default_rng(seed)
    tflops = rng.uniform(150.0, 900.0, n)
    slow = int(rng.integers(n))
    if n >= 3:
        tflops[slow] = tflops.min() * 0.3
    return [{
        "healthy": bool(rng.random() > 0.2),
        "tflops": float(tflops[i]),
        "tflops_best": float(tflops[i] * rng.uniform(1.0, 1.05)),
        "hbm_gbps": float(rng.uniform(1500.0, 3100.0)),
    } for i in range(n)]


def _pinned_outcome(entry, uuid):
    """A pinned worker's outcome for its one device."""
    report = {"healthy": entry["healthy"], "tflops": entry["tflops"],
              "hbm_gbps": entry["hbm_gbps"], "ici_ok": None, "chips": 1,
              "per_chip": [dict(entry, uuid=uuid, id=0)], "timing": "device-profiler",
              "phases": {"compile_ms": 0.0}, "chips_allreduce_ok": True, "ici_gbps": None}
    return json.loads(json.dumps({"status": "ok", "report": report, "probe_ms": 7.0}))


def _twin_report(entries):
    """The twin's report on N chips with the same per-chip results, as
    its measure_node_health aggregates them."""
    return {"healthy": all(e["healthy"] for e in entries),
            "tflops": min(e["tflops"] for e in entries),
            "hbm_gbps": min(e["hbm_gbps"] for e in entries),
            "ici_ok": None, "chips": len(entries),
            "per_chip": [dict(e, id=i) for i, e in enumerate(entries)],
            "timing": "device-profiler", "phases": {"compile_ms": 0.0},
            "chips_allreduce_ok": True, "ici_gbps": None}


def _twin_config():
    return twin_new_config(cli_values={"with-burnin": "true", "oneshot": "true",
                                       "machine-type-file": ""}, environ={})


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("gpus,per_gpu", [(1, 1), (1, 3), (1, 7), (2, 7)])
def test_fold_under_single_gives_the_twins_labels_for_n_chips(gpus, per_gpu, seed):
    """N MIG devices of one profile (valid single) give the twin's labels
    for N chips, over two probes (the straggler's confirmation), integers
    exact, keys under the one translation."""
    fake = FakeNvml([_mig_gpu(per_gpu) for _ in range(gpus)])
    manager = _inited(NvmlManager(fake))
    targets = probe_targets(manager, "single")
    assert targets.per_mig_device and len(targets.mig) == gpus * per_gpu
    config = _config("single")
    sched, twin_sched = health._BurninSchedule(), twin_health._BurninSchedule()
    for probe in range(2):
        entries = _seeded_entries(seed * 10 + probe, len(targets.mig))
        outcomes = {t.key: _pinned_outcome(e, t.uuid) for t, e in zip(targets.mig, entries)}
        report = health._fold(targets, None, outcomes)
        got = health._labels_from_probe(sched, manager, config, report, None, 7.0)
        want = twin_health._labels_from_probe(
            twin_sched, None, _twin_config(), _twin_report(entries), None, 7.0)
        assert dict(got) == {k.replace(TPU, GPU, 1): v for k, v in dict(want).items()}
    assert int(got["nvidia.com/gpu.chips.healthy"]) + int(got["nvidia.com/gpu.chips.sick"]) \
        == int(_device_labels(manager, "single")["nvidia.com/gpu.count"])


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("strategy", ["none", "mixed"])
def test_fold_under_none_and_mixed_keeps_the_twins_plain_gpus(strategy, seed):
    """GPUs 0, 2, 3 plain and 1, 4 in MIG mode: the plain GPUs' labels
    are the twin's for those three chips (its chip p is NVML's plain[p]),
    listed by CUDA in a seeded order and joined by UUID; a MIG GPU's
    chip.<i>.ok is the all() of its devices, with no rate and never the
    straggler; health.ok covers every device, the rates the plain GPUs'."""
    gpus = [FakeGpu(), _mig_gpu(2), FakeGpu(), FakeGpu(), _mig_gpu(1, "7g.80gb")]
    manager = _inited(NvmlManager(FakeNvml(gpus)))
    targets = probe_targets(manager, strategy)
    assert targets.plain == (0, 2, 3) and [t.gpu for t in targets.mig] == [1, 1, 4]
    rng = np.random.default_rng(seed)
    sched, twin_sched = health._BurninSchedule(), twin_health._BurninSchedule()
    for probe in range(2):
        plain = _seeded_entries(seed * 10 + probe, 3)
        order = rng.permutation(3)
        classic = _twin_report([dict(plain[p], uuid=fake_uuid(targets.plain[p]))
                                for p in order])
        mig_ok = [bool(v) for v in rng.random(3) > 0.3]
        outcomes = {t.key: _pinned_outcome(dict(e, healthy=ok), t.uuid) for t, e, ok in
                    zip(targets.mig, _seeded_entries(seed + 50, 3), mig_ok)}
        got = dict(health._labels_from_probe(sched, manager, _config(strategy),
                                             health._fold(targets, classic, outcomes),
                                             None, 7.0))
        twin = {k.replace(TPU, GPU, 1): v for k, v in dict(twin_health._labels_from_probe(
            twin_sched, None, _twin_config(), _twin_report(plain), None, 7.0)).items()}
        want = {k: v for k, v in twin.items() if not PER_DEVICE.match(k)}
        for p, i in enumerate(targets.plain):
            for suffix in ("ok", "tflops", "hbm-gbps"):
                if f"{GPU}chip.{p}.{suffix}" in twin:
                    want[f"{GPU}chip.{i}.{suffix}"] = twin[f"{GPU}chip.{p}.{suffix}"]
        gpu_ok = {1: mig_ok[0] and mig_ok[1], 4: mig_ok[2]}
        for i, ok in gpu_ok.items():
            want[f"{GPU}chip.{i}.ok"] = str(ok).lower()
        want[GPU + "health.ok"] = str(twin[GPU + "health.ok"] == "true"
                                      and all(gpu_ok.values())).lower()
        want[GPU + "chips.healthy"] = str(int(twin[GPU + "chips.healthy"]) + sum(gpu_ok.values()))
        want[GPU + "chips.sick"] = str(int(twin[GPU + "chips.sick"]) + 2 - sum(gpu_ok.values()))
        if GPU + "straggler-chip" in twin:
            want[GPU + "straggler-chip"] = str(targets.plain[int(twin[GPU + "straggler-chip"])])
        assert got == want


def test_a_failed_mig_probe_is_its_own_devices_verdict_and_reprobes():
    """A worker that hung or crashed: its device is sick and unrated, the
    others keep their verdicts and rates; the next cycle probes again
    (the twin's first-failure rule), a second failure in a row does not."""
    manager = _inited(NvmlManager(FakeNvml([_mig_gpu(3)])))
    targets = probe_targets(manager, "single")
    entries = _seeded_entries(1, 3)
    for e in entries:
        e["healthy"] = True
    outcomes = {t.key: _pinned_outcome(e, t.uuid) for t, e in zip(targets.mig, entries)}
    outcomes[targets.mig[1].key] = {"status": "probe-failed", "error": "killed"}
    sched = health._BurninSchedule()
    labels = health._labels_from_probe(sched, manager, _config("single"),
                                       health._fold(targets, None, outcomes), None, 5.0)
    assert labels["nvidia.com/gpu.health.ok"] == "false"
    assert [labels.get(f"nvidia.com/gpu.chip.{i}.ok") for i in range(3)] == \
        ["true", "false", "true"]
    assert "nvidia.com/gpu.chip.1.tflops" not in labels
    assert labels["nvidia.com/gpu.chip.2.tflops"] == str(int(entries[2]["tflops"]))
    assert labels["nvidia.com/gpu.health.matmul-tflops"] == str(
        int(min(entries[0]["tflops"], entries[2]["tflops"])))
    assert "nvidia.com/gpu.health.hbm-gbps" not in labels  # one device unmeasured
    assert sched.reprobe and sched.cached is not None
    assert sched.due(10), "a first failure is probed again at once"
    health._labels_from_probe(sched, manager, _config("single"),
                              health._fold(targets, None, outcomes), None, 5.0)
    assert not sched.reprobe, "a repeated failure waits for the interval"


def test_invalid_single_publishes_the_verdict_without_per_device_labels(caplog):
    """``mixed``'s profiles under single: gpu.count=0, no chip.<i>.*; the
    node's verdict still covers every MIG device."""
    manager = _inited(NvmlManager(fake_nvml("mixed")))
    targets = probe_targets(manager, "single")
    assert not targets.per_device
    entries = _seeded_entries(3, len(targets.mig))
    outcomes = {t.key: _pinned_outcome(dict(e, healthy=i != 4), t.uuid)
                for i, (t, e) in enumerate(zip(targets.mig, entries))}
    tfd_logging.reset_warn_once()
    with caplog.at_level("WARNING", logger="tfd.lm"):
        labels = health._labels_from_probe(health._BurninSchedule(), manager, _config("single"),
                                           health._fold(targets, None, outcomes), None, 5.0)
    tfd_logging.reset_warn_once()
    assert labels["nvidia.com/gpu.health.ok"] == "false"
    assert not [k for k in labels if PER_DEVICE.match(k)]
    assert "nvidia.com/gpu.health.matmul-tflops" not in labels  # no plain GPU
    assert "topology strategy single is invalid" in caplog.text


def test_a_full_node_of_56_mig_devices_folds_every_verdict_under_thread_switching(
        monkeypatch):
    """Eight H100s of seven MIG devices each through the broker path: 56
    child threads (more than this host's cores) write one round's
    outcomes at once, the interpreter switching threads every
    microsecond; every device's verdict lands, device 13's sick."""
    import sys
    import threading

    manager = _MigNode(FakeNvml([_mig_gpu(7) for _ in range(8)]))
    targets = probe_targets(manager, "single")
    entries = {t.key: dict(e, healthy=t.index != 13) for t, e in
               zip(targets.mig, _seeded_entries(7, 56))}
    asked = []

    def child(target, config, request, pid_box=None):
        asked.append(target.key)
        time.sleep(0.001)
        return _pinned_outcome(entries[target.key], target.uuid)

    monkeypatch.setattr(health, "_probe_mig_in_child", child)
    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(5):
            health.reset_burnin_schedule()
            del asked[:]
            labels = health.new_health_labeler(manager, _config("single")).labels()
            assert sorted(asked) == sorted(entries)
            assert labels["nvidia.com/gpu.chips.healthy"] == "55"
            assert labels["nvidia.com/gpu.chips.sick"] == "1"
            assert [i for i in range(56)
                    if labels[f"nvidia.com/gpu.chip.{i}.ok"] == "false"] == [13]
    finally:
        sys.setswitchinterval(before)
        health.reset_burnin_schedule()
    assert threading.active_count() < 20, "a child thread outlived its round"


# ---------------------------------------------------------------------------
# No label key, metric family or flag beyond the twin's
# ---------------------------------------------------------------------------

def _twin_health_key_patterns():
    consts = [getattr(twin_health, n) for n in dir(twin_health)
              if n.isupper() and isinstance(getattr(twin_health, n), str)
              and getattr(twin_health, n).startswith(TPU)]
    return [re.compile(re.escape(c.replace(TPU, GPU, 1)).replace("%d", r"\d+") + "$")
            for c in consts]


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("layout", ["single", "mixed", "half", "empty"])
def test_no_label_key_metric_family_or_flag_beyond_the_twins(layout, strategy):
    manager = _inited(NvmlManager(fake_nvml(layout)))
    targets = probe_targets(manager, strategy)
    outcomes = {t.key: _pinned_outcome(e, t.uuid)
                for t, e in zip(targets.mig, _seeded_entries(5, len(targets.mig)))}
    classic = None
    if targets.plain:
        classic = _twin_report([dict(e, uuid=fake_uuid(i)) for i, e in zip(
            targets.plain, _seeded_entries(6, len(targets.plain)))])
    labels = health._labels_from_probe(health._BurninSchedule(), manager, _config(strategy),
                                       health._fold(targets, classic, outcomes), None, 5.0)
    patterns = _twin_health_key_patterns()
    assert all(any(p.match(k) for p in patterns) for k in labels), sorted(labels)
    # The parent's flags are the twin's less its two TPU-only ones; its
    # metric families the twin's and the port's three own (the span tree
    # and the fsync count).
    assert {f.name for f in FLAG_DEFS} == \
        {f.name for f in TWIN_FLAG_DEFS} - {"libtpu-path", "pjrt-create-options"}
    assert set(obs_metrics.REGISTRY.families()) == set(twin_metrics.REGISTRY.families()) | {
        "tfd_span_duration_seconds", "tfd_probe_gap_seconds", "tfd_fsyncs_total"}


# ---------------------------------------------------------------------------
# The real pinned processes, on CPU devices
# ---------------------------------------------------------------------------

class _Classic:
    """The classic worker's client on a node whose GPUs are all in MIG
    mode: it serves snapshots, and no health request reaches it."""

    def __init__(self, manager):
        self._manager = manager

    def snapshot(self):
        return DeviceSnapshot.from_manager(self._manager)

    def health(self, **_):
        raise AssertionError("no plain GPU: the classic worker probes nothing")

    def kill_child(self):
        pass


class _MigNode(SnapshotManager):
    """What the labeling process holds on a broker-path MIG node: the
    snapshot the classic worker shipped, and that worker's client."""

    def __init__(self, fake):
        nvml_manager = _inited(NvmlManager(fake))
        super().__init__(DeviceSnapshot.from_dict(json.loads(json.dumps(
            DeviceSnapshot.from_manager(nvml_manager).to_dict()))))
        self.broker = _Classic(nvml_manager)


@pytest.fixture
def cpu_probe_env(monkeypatch):
    """Pinned processes probe one CPU device at a small geometry; a broker
    path cycle does not wait for its children; faults, schedules and
    brokers are left clean."""
    monkeypatch.setattr(broker_mod, "HEALTH_WAIT_S", 0.0)
    monkeypatch.setenv("TFD_BURNIN_ALLOW_CPU", "1")
    monkeypatch.setenv("TFD_BURNIN_GEOMETRY", "64x1")
    monkeypatch.delenv("TFD_FAULT_SPEC", raising=False)
    faults.reset()
    health.reset_burnin_schedule()
    tfd_logging.reset_warn_once()
    yield
    sandbox.close_broker()
    faults.reset()
    health.reset_burnin_schedule()
    tfd_logging.reset_warn_once()


def _per_device(labels):
    return {k: v for k, v in labels.items()
            if k.startswith(GPU + "health.ok") or PER_DEVICE.match(k)}


def _cycle(engine, manager, config):
    return dict(engine.generate(new_label_sources(manager, config)))


def _until(engine, manager, config, cond, what, timeout=90):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        labels = _cycle(engine, manager, config)
        if cond(labels):
            return labels
        time.sleep(0.2)
    raise AssertionError(f"timed out waiting for {what}: {labels}")


def _two_mig_node():
    return FakeNvml([_mig_gpu(2, "3g.40gb")])


def _round_pids(manager, count, timeout=30.0):
    """The pids of the running MIG round's children, once all ``count``
    are spawned."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        rnd = health._schedule_for(manager).mig_round
        if rnd is not None and not rnd.cancelled and len(rnd.pids) == count:
            return list(rnd.pids)
        time.sleep(0.01)
    raise AssertionError(f"{count} children of the round not spawned")


def _gone(pid):
    """The pid is reaped (or a zombie nobody will wait for)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return ") Z " in f.read()
    except OSError:
        return True


def _environ(pid):
    with open(f"/proc/{pid}/environ", "rb") as f:
        return dict(kv.split(b"=", 1) for kv in f.read().split(b"\0") if b"=" in kv)


def _spawned_at(pid):
    """When the process started, on this process's monotonic clock (its
    start time in /proc against the system's uptime)."""
    with open(f"/proc/{pid}/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return time.monotonic() - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))


def test_pinned_broker_workers_see_one_device_and_contain_a_hang_and_a_crash(
        cpu_probe_env):
    """The broker path's one-shot children (real processes), two MIG
    devices, one pinned child each per round. A child stopped mid-probe
    is killed at --probe-timeout and a child killed mid-probe is found
    dead: each time its own device's verdict is false, the other's stays
    true, and the daemon's cycles go on."""
    manager = _MigNode(_two_mig_node())
    config = _config("single", **{"probe-timeout": "10s", "probe-broker": "on"})
    engine = LabelEngine(parallel=False)
    targets = probe_targets(manager, "single")
    first = _cycle(engine, manager, config)
    assert "nvidia.com/gpu.health.ok" not in first, "children run in the background"
    pids = _round_pids(manager, 2)
    assert len(set(pids)) == 2
    # Each child is pinned by its device's UUID (the round spawns them in
    # target order, each on its own thread: match by the environment).
    assert sorted(_environ(pid)[b"CUDA_VISIBLE_DEVICES"] for pid in pids) == \
        sorted(t.uuid.encode() for t in targets.mig)
    healthy = _until(engine, manager, config,
                     lambda l: l.get("nvidia.com/gpu.health.ok") == "true", "health labels")
    assert _per_device(healthy) == {
        "nvidia.com/gpu.health.ok": "true", "nvidia.com/gpu.chips.healthy": "2",
        "nvidia.com/gpu.chips.sick": "0", "nvidia.com/gpu.chip.0.ok": "true",
        "nvidia.com/gpu.chip.1.ok": "true"}

    def faulted(sig, what):
        """The next round with device 1's child hit by ``sig``: its labels
        and how long after its spawn the child was gone."""
        _cycle(engine, manager, config)
        victim = next(pid for pid in _round_pids(manager, 2) if _environ(pid)[
            b"CUDA_VISIBLE_DEVICES"] == targets.mig[1].uuid.encode())
        spawned = _spawned_at(victim)
        os.kill(victim, sig)
        deadline = time.monotonic() + 30.0
        while not _gone(victim) and time.monotonic() < deadline:
            time.sleep(0.05)
        lived = time.monotonic() - spawned
        labels = _until(engine, manager, config,
                        lambda l: l.get("nvidia.com/gpu.health.ok") == "false", what)
        return labels, lived

    hung, lived = faulted(signal.SIGSTOP, "the hung child's verdict")
    # Killed at its --probe-timeout (10 s from its spawn), not before.
    assert 9.5 < lived < 20.0, lived
    assert _per_device(hung) == {
        "nvidia.com/gpu.health.ok": "false", "nvidia.com/gpu.chips.healthy": "1",
        "nvidia.com/gpu.chips.sick": "1", "nvidia.com/gpu.chip.0.ok": "true",
        "nvidia.com/gpu.chip.1.ok": "false"}
    # A first failure is probed again at once: the next round is healthy.
    _until(engine, manager, config,
           lambda l: l.get("nvidia.com/gpu.health.ok") == "true", "the next round")

    crashed, _ = faulted(signal.SIGKILL, "the crashed child's verdict")
    assert _per_device(crashed)["nvidia.com/gpu.chip.1.ok"] == "false"
    assert _per_device(crashed)["nvidia.com/gpu.chip.0.ok"] == "true"
    assert crashed["nvidia.com/gpu.count"] == "2"


def test_a_round_leaves_no_child_alive(cpu_probe_env):
    """Each MIG device's child exits with its probe: once the round's
    labels are published, none of its children is alive, and nothing
    holds the device until the next round."""
    manager = _MigNode(_two_mig_node())
    config = _config("single", **{"probe-broker": "on"})
    engine = LabelEngine(parallel=False)
    _cycle(engine, manager, config)
    pids = _round_pids(manager, 2)
    labels = _until(engine, manager, config,
                    lambda l: l.get("nvidia.com/gpu.health.ok") == "true", "health labels")
    assert labels["nvidia.com/gpu.chips.healthy"] == "2"
    assert health._schedule_for(manager).mig_round is None
    assert all(_gone(pid) for pid in pids), [p for p in pids if not _gone(p)]


def test_the_cancel_hook_kills_a_rounds_running_children(cpu_probe_env):
    """The broker-routed health source's cancel hook (a missed labeler
    deadline, a reload) kills the running round's children; that round
    publishes nothing and gives its fault shots back, and the next cycle
    starts another, which delivers the shot."""
    manager = _MigNode(_two_mig_node())
    config = _config("single", **{"probe-broker": "on"})
    engine = LabelEngine(parallel=False)
    faults.load_fault_spec("chip.1.sick:fail:1")
    _cycle(engine, manager, config)
    pids = _round_pids(manager, 2)
    (health_source,) = [s for s in new_label_sources(manager, config) if s.name == "health"]
    assert health_source.cancel is not None
    health_source.cancel()
    deadline = time.monotonic() + 10
    while not all(_gone(p) for p in pids) and time.monotonic() < deadline:
        time.sleep(0.01)
    assert all(_gone(p) for p in pids)
    assert health._schedule_for(manager).mig_round.cancelled
    _cycle(engine, manager, config)
    assert not set(_round_pids(manager, 2)) & set(pids), "a new round, new children"
    labels = _until(engine, manager, config,
                    lambda l: "nvidia.com/gpu.health.ok" in l, "the next round")
    assert _per_device(labels) == {
        "nvidia.com/gpu.health.ok": "false", "nvidia.com/gpu.chips.healthy": "1",
        "nvidia.com/gpu.chips.sick": "1", "nvidia.com/gpu.chip.0.ok": "true",
        "nvidia.com/gpu.chip.1.ok": "false"}, "the shot came back for the next round"


def test_in_process_children_and_broker_workers_give_the_same_labels(cpu_probe_env):
    """The in-process path probes each MIG device in a one-shot pinned
    child (real processes); its labels equal the broker path's, and a
    ``chip.1.sick`` shot flips device 1 alone on both."""
    got = {}
    for path in ("in-process", "broker"):
        health.reset_burnin_schedule()
        faults.load_fault_spec("chip.1.sick:fail:1")
        manager = _MigNode(_two_mig_node())
        if path == "in-process":
            manager = SnapshotManager(manager.snapshot)
        config = _config("single", **{"probe-broker": "on" if path == "broker" else "off",
                                      "oneshot": "false" if path == "broker" else "true"})
        engine = LabelEngine(parallel=False)
        labels = _until(engine, manager, config,
                        lambda l: "nvidia.com/gpu.health.ok" in l, f"{path} health labels")
        got[path] = {k: v for k, v in labels.items() if k != "nvidia.com/gpu.health.probe-ms"}
        faults.reset()
        sandbox.close_broker()
    assert got["in-process"] == got["broker"]
    assert _per_device(got["broker"]) == {
        "nvidia.com/gpu.health.ok": "false", "nvidia.com/gpu.chips.healthy": "1",
        "nvidia.com/gpu.chips.sick": "1", "nvidia.com/gpu.chip.0.ok": "true",
        "nvidia.com/gpu.chip.1.ok": "false"}


def test_a_pinned_child_probes_exactly_its_one_device(cpu_probe_env):
    """The ``health`` probe op in a fresh child pinned to a MIG UUID: its
    environment names the device, and it probes one device."""
    from gpu_feature_discovery_tpu_torch.sandbox.probe import run_probe

    uuid = fake_mig_uuid(0, 0)
    result = run_probe("health", _config("single"), 60.0, pin=uuid,
                       request={"per_chip": True, "sick_chips": [0]})
    assert result.status == "ok", result
    assert result.payload["chips"] == 1 and len(result.payload["per_chip"]) == 1
    assert result.payload["healthy"] is False  # the shot reached its device
