"""NVML through ctypes (native/nvml.py), the NVML-only manager and the
CUDA manager over NVML, on the CPU over FakeNvml.

FakeNvml implements NVML's C entry points and writes into the same
ctypes structs, so the struct decoding, the NOT_SUPPORTED and NOT_FOUND
paths and the error mapping run here. The driver-version repair is held
against the twin's version grammar; the NVML path must never import
torch."""

import ctypes
import json
import os
import re
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

from gpu_feature_discovery_tpu.lm.versions import version_labels_for as twin_version_labels
from gpu_feature_discovery_tpu.resource.testing import MockManager as TwinMockManager
from gpu_feature_discovery_tpu_torch.config.flags import new_config
from gpu_feature_discovery_tpu_torch.lm.engine import LabelEngine
from gpu_feature_discovery_tpu_torch.lm.labelers import new_label_sources
from gpu_feature_discovery_tpu_torch.lm.versions import new_version_labeler
from gpu_feature_discovery_tpu_torch.native import nvml
from gpu_feature_discovery_tpu_torch.resource import cuda_backend
from gpu_feature_discovery_tpu_torch.resource.cuda_backend import CudaManager
from gpu_feature_discovery_tpu_torch.resource.nvml_backend import NvmlManager
from gpu_feature_discovery_tpu_torch.resource.slice_partition import MigPartition
from gpu_feature_discovery_tpu_torch.resource.testing import (
    H100_DRIVER_VERSION,
    H100_MIG_PROFILES,
    LAYOUTS,
    FakeGpu,
    FakeNvml,
    fake_mig_uuid,
    fake_nvml,
)
from gpu_feature_discovery_tpu_torch.resource.types import ResourceError
from gpu_feature_discovery_tpu_torch.sandbox.broker import BrokerManager
from gpu_feature_discovery_tpu_torch.sandbox.snapshot import DeviceSnapshot
from gpu_feature_discovery_tpu_torch.utils import faults
from gpu_feature_discovery_tpu_torch.utils import logging as tfd_logging
from torch_mig_fakes import MigWorkers

REPO = Path(__file__).parent.parent


def test_struct_layouts_are_pinned():
    """nvml.h's layouts: eight unsigned ints then the u64 memory size;
    the v3 PCI info with its 16- and 32-byte bus-id buffers."""
    assert ctypes.sizeof(nvml.NvmlDeviceAttributes) == 40
    assert nvml.NvmlDeviceAttributes.memorySizeMB.offset == 32
    assert nvml.NvmlDeviceAttributes.computeInstanceSliceCount.offset == 28
    assert ctypes.sizeof(nvml.NvmlPciInfo) == 68
    assert nvml.NvmlPciInfo.domain.offset == 16
    assert nvml.NvmlPciInfo.busId.offset == 36
    assert ctypes.sizeof(nvml.NvmlMemory) == 24


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_fake_inventory_decodes_every_layout(layout):
    fake = fake_nvml(layout)
    inv = nvml.read_inventory(fake)
    assert fake.initialized == 0, "nvmlShutdown not called"
    assert inv.driver_version == H100_DRIVER_VERSION and inv.cuda_driver_version == 13000
    assert len(inv.devices) == len(LAYOUTS[layout])
    for dev, spec in zip(inv.devices, LAYOUTS[layout]):
        assert dev.name == spec.name
        assert dev.memory_total_bytes == spec.memory_total_bytes
        assert dev.bus_id == (spec.bus_id and nvml.normalize_bus_id(spec.bus_id))
        assert dev.compute_capability == spec.compute_capability
        assert dev.mig_capable == (spec.mig_mode is not None)
        assert dev.mig_enabled == (spec.mig_mode == 1)
        assert [m.profile for m in dev.mig_devices] == [p for p in spec.mig if p]


@pytest.mark.parametrize("profile", sorted(H100_MIG_PROFILES))
def test_profile_name_is_the_references_rule(profile):
    """[<ci>c.]<gi>g.<ceil(memorySizeMB / 1024)>gb, read back through the
    struct."""
    fake = FakeNvml([FakeGpu(mig_mode=1, mig=[profile])])
    (dev,) = nvml.read_inventory(fake).devices
    (m,) = dev.mig_devices
    assert m.profile == profile
    assert m.attributes()["memory"] == H100_MIG_PROFILES[profile][-1]
    assert set(m.attributes()) == {
        "memory", "multiprocessors", "slices.gi", "slices.ci", "engines.copy",
        "engines.decoder", "engines.encoder", "engines.jpeg", "engines.ofa"}


def test_not_supported_mig_mode_means_not_capable():
    fake = fake_nvml("no-mig")
    (dev,) = nvml.read_inventory(fake).devices
    assert (dev.mig_capable, dev.mig_enabled, dev.mig_devices) == (False, False, ())
    assert fake.calls["nvmlDeviceGetMigMode"] == 1
    assert fake.calls["nvmlDeviceGetMaxMigDeviceCount"] == 0


def test_empty_mig_slots_are_skipped():
    fake = fake_nvml("single")
    dev = nvml.read_inventory(fake).devices[1]
    assert [m.slot for m in dev.mig_devices] == [0, 2]
    # Seven slots walked on each GPU, the NOT_FOUND ones included.
    assert fake.calls["nvmlDeviceGetMigDeviceHandleByIndex"] == 14
    assert fake.calls["nvmlDeviceGetAttributes_v2"] == 4


@pytest.mark.parametrize("entry,code", [
    ("nvmlInit_v2", 9),
    ("nvmlSystemGetDriverVersion", 999),
    ("nvmlDeviceGetMigMode", 4),
    ("nvmlDeviceGetMigDeviceHandleByIndex", 15),
    ("nvmlDeviceGetAttributes_v2", 3),
])
def test_failed_calls_raise_nvml_error_and_still_shut_down(entry, code):
    fake = fake_nvml("mixed")
    fake.fail[entry] = code
    with pytest.raises(nvml.NvmlError) as err:
        nvml.read_inventory(fake)
    assert isinstance(err.value, ResourceError)
    assert err.value.code == code and err.value.function == entry
    assert nvml.NVML_ERROR_NAMES[code] in str(err.value)
    assert fake.initialized == 0
    assert fake.calls["nvmlShutdown"] == (0 if entry == "nvmlInit_v2" else 1)


@pytest.mark.parametrize("raw,want", [
    ("00000000:19:00.0", "0000:19:00.0"),
    ("0000:9A:00.0", "0000:9a:00.0"),
    ("19:00.0", "0000:19:00.0"),
    ("00000001:C3:1F.7", "0001:c3:1f.7"),
])
def test_bus_ids_normalise_to_the_sysfs_spelling(raw, want):
    assert nvml.normalize_bus_id(raw) == want
    assert nvml.normalize_bus_id(want) == want


def test_bad_bus_id_raises():
    with pytest.raises(ValueError):
        nvml.normalize_bus_id("gpu0")


def test_load_library_tolerates_absence():
    assert nvml.load_library("libnvidia-ml-not-installed.so.1") is None
    assert nvml.load_library("libc.so.6") is None  # loads, lacks nvmlInit_v2
    if nvml.load_library() is None:  # no NVIDIA driver on this host
        with pytest.raises(ResourceError, match="not loadable"):
            nvml.read_inventory()


def test_mig_partition_keeps_the_twins_asymmetry():
    inv = nvml.read_inventory(fake_nvml("half"))
    chip = cuda_backend.nvml_chip(inv.devices[0])
    (part,) = chip.get_slices()
    assert isinstance(part, MigPartition)
    assert part.get_parent_chip() is chip and part.get_generation() == (9, 0)
    assert part.get_name() == "7g.80gb" and part.get_total_memory_mb() == 81152
    for method in ("is_slice_enabled", "is_slice_capable", "get_slices"):
        with pytest.raises(ResourceError):
            getattr(part, method)()
    for method in ("get_attributes", "get_parent_chip"):
        with pytest.raises(ResourceError):
            getattr(chip, method)()


def test_nvml_manager_needs_a_gpu():
    with pytest.raises(ResourceError, match="no GPUs"):
        NvmlManager(FakeNvml([])).init()


# ---------------------------------------------------------------------------
# CudaManager against NvmlManager on the same fake
# ---------------------------------------------------------------------------

TORCH_TOTAL_MIB = 81079  # what torch's total_memory reads on the H100


def _cuda_devices(fake, order=None):
    """The devices CUDA enumerates on a FakeNvml's node: each GPU outside
    MIG mode whole, fastest first (the reverse of NVML's PCI order here),
    and of the MIG devices only the first one, named after its profile
    and on its parent's bus (a CUDA process sees a single MIG device,
    per NVIDIA's MIG user guide). ``order`` lists the NVML indices CUDA
    lists instead, as ``CUDA_VISIBLE_DEVICES`` would. A process pinned to
    a MIG device (``CUDA_VISIBLE_DEVICES=<its MIG UUID>``) lists exactly
    that device."""
    pinned = os.environ.get("CUDA_VISIBLE_DEVICES", "")
    if pinned.startswith("MIG-"):
        for i, gpu in enumerate(fake.gpus):
            for slot, profile in enumerate(gpu.mig):
                uuid = gpu.mig_uuids[slot] if slot < len(gpu.mig_uuids) \
                    else fake_mig_uuid(i, slot)
                if profile and uuid == pinned:
                    return [(f"{gpu.name} MIG {profile}", H100_MIG_PROFILES[profile][-1],
                             gpu)]
        return []
    devices = []
    gpus = reversed(fake.gpus) if order is None else [fake.gpus[i] for i in order]
    for gpu in gpus:
        if gpu.mig_mode != nvml.NVML_DEVICE_MIG_ENABLE:
            devices.append((gpu.name, TORCH_TOTAL_MIB, gpu))
    mig = [(gpu, p) for gpu in fake.gpus
           if gpu.mig_mode == nvml.NVML_DEVICE_MIG_ENABLE for p in gpu.mig if p]
    if mig:
        gpu, profile = mig[0]
        devices.append((f"{gpu.name} MIG {profile}", H100_MIG_PROFILES[profile][-1], gpu))
    return devices


@pytest.fixture
def fake_torch_cuda(monkeypatch):
    """torch.cuda over a FakeNvml's node, as ``_cuda_devices`` lists it."""
    import torch

    def install(fake, order=None):
        def listed():
            # Read per call: a pinned process lists its one MIG device.
            return _cuda_devices(fake, order)

        def props(i):
            name, memory_mib, gpu = listed()[i]
            # Where NVML has no PCI info torch still has an address.
            domain, bus, devfn = (gpu.bus_id or "0000:db:00.0").split(":")
            return SimpleNamespace(
                name=name, major=gpu.compute_capability[0],
                minor=gpu.compute_capability[1], total_memory=memory_mib * 2**20,
                pci_domain_id=int(domain, 16), pci_bus_id=int(bus, 16),
                pci_device_id=int(devfn.split(".")[0], 16),
                # torch's _CUuuid prints the hex without NVML's prefix.
                uuid=gpu.uuid[len("GPU-"):].upper(),
            )

        monkeypatch.setattr(torch.cuda, "is_available", lambda: bool(listed()))
        monkeypatch.setattr(torch.cuda, "device_count", lambda: len(listed()))
        monkeypatch.setattr(torch.cuda, "get_device_name", lambda i: listed()[i][0])
        monkeypatch.setattr(torch.cuda, "get_device_properties", props)
        monkeypatch.setattr(cuda_backend, "cuda_driver_api_version", lambda: 13000)
        return listed()

    return install


def _labels(manager, strategy):
    config = new_config(cli_values={"tpu-topology-strategy": strategy,
                                    "machine-type-file": ""}, environ={})
    return dict(LabelEngine(parallel=False).generate(new_label_sources(manager, config)))


@pytest.mark.parametrize("strategy", ["none", "single", "mixed"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_nvml_manager_labels_equal_cuda_managers(layout, strategy, fake_torch_cuda):
    fake = fake_nvml(layout)
    fake_torch_cuda(fake)
    native = NvmlManager(fake_nvml(layout))
    cuda = CudaManager(nvml_lib=fake)
    got = _labels(cuda, strategy)
    assert got == _labels(native, strategy)
    if strategy != "single":  # single overloads memory with a MIG profile's
        # One memory source: NVML's memory.total, not torch's total_memory.
        assert got["nvidia.com/gpu.memory"] == str(
            LAYOUTS[layout][0].memory_total_bytes // 2**20)
        # Every GPU of the node, whatever CUDA enumerates under MIG.
        assert got["nvidia.com/gpu.count"] == str(len(LAYOUTS[layout]))
    assert got["nvidia.com/gpu.slice.capable"] == str(layout != "no-mig").lower()


@pytest.mark.parametrize("layout", ["single", "mixed", "half"])
def test_cuda_manager_takes_nvmls_gpus_not_cudas_mig_devices(layout, fake_torch_cuda):
    """Under MIG, CUDA lists one MIG device, not the GPUs: the chips are
    NVML's, in NVML's order, with their partitions."""
    fake = fake_nvml(layout)
    devices = fake_torch_cuda(fake)
    assert len(devices) < len(fake.gpus) or any(" MIG " in d[0] for d in devices)
    manager = CudaManager(nvml_lib=fake)
    manager.init()
    chips = manager.get_chips()
    assert [c.get_name() for c in chips] == ["nvidia-h100-80gb-hbm3"] * len(fake.gpus)
    assert [c.is_slice_enabled() for c in chips] == [g.mig_mode == 1 for g in fake.gpus]
    assert [[s.get_name() for s in c.get_slices()] for c in chips] == [
        [p for p in g.mig if p] for g in fake.gpus]
    assert manager.nvml_inventory.init_ms >= 0 and manager.nvml_inventory.enumerate_ms >= 0


def test_missing_pci_info_keeps_nvmls_facts(fake_torch_cuda, monkeypatch):
    """The card as recorded: NVML answers NOT_SUPPORTED for its PCI info.
    NVML's facts still apply, whatever CUDA_VISIBLE_DEVICES says."""
    fake = fake_nvml("recorded")
    (dev,) = nvml.read_inventory(fake).devices
    assert dev.bus_id is None and dev.mig_capable and not dev.mig_enabled
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0")
    fake_torch_cuda(fake)
    manager = CudaManager(nvml_lib=fake)
    manager.init()
    (chip,) = manager.get_chips()
    assert chip.is_slice_capable() and chip.get_total_memory_mb() == 81559


def test_driver_labels_are_the_kernel_driver_with_nvml(fake_torch_cuda):
    """The repair: with NVML, driver.* is nvmlSystemGetDriverVersion, in
    the twin's X.Y[.Z] grammar; runtime.* is the CUDA driver API's
    version. Before it, driver.* read the CUDA version (13.0)."""
    fake = fake_nvml("none")
    fake_torch_cuda(fake)
    manager = CudaManager(nvml_lib=fake)
    manager.init()
    got = dict(new_version_labeler(manager))
    want = twin_version_labels(
        TwinMockManager(driver_version=H100_DRIVER_VERSION, runtime_version=(13, 0)),
        "nvidia.com/gpu")
    assert got == dict(want)
    assert (got["nvidia.com/gpu.driver.major"], got["nvidia.com/gpu.driver.minor"],
            got["nvidia.com/gpu.driver.rev"]) == ("580", "159", "03")
    assert (got["nvidia.com/gpu.runtime.major"], got["nvidia.com/gpu.runtime.minor"]) \
        == ("13", "0")


def test_cuda_manager_without_nvml_warns_once_and_publishes_no_driver(
        fake_torch_cuda, monkeypatch, caplog):
    """Without NVML: torch's devices, slice-less, with torch's memory, and
    no driver labels (only NVML knows the kernel driver); the runtime
    labels stay."""
    fake_torch_cuda(fake_nvml("none"))
    monkeypatch.setattr(nvml, "load_library", lambda path=nvml.NVML_LIBRARY: None)
    tfd_logging.reset_warn_once()
    with caplog.at_level("WARNING", logger="tfd.resource"):
        for _ in range(2):
            manager = CudaManager()
            manager.init()
    assert sum("NVML unavailable" in r.message for r in caplog.records) == 1
    chips = manager.get_chips()
    assert len(chips) == 2 and chips[0].get_generation() == (9, 0)
    assert all(not c.is_slice_capable() and not c.get_slices() for c in chips)
    assert chips[0].get_total_memory_mb() == TORCH_TOTAL_MIB
    assert manager.get_driver_version() == ""
    assert dict(new_version_labeler(manager)) == {
        "nvidia.com/gpu.runtime.major": "13", "nvidia.com/gpu.runtime.minor": "0"}
    tfd_logging.reset_warn_once()


def test_nvml_path_never_imports_torch():
    code = (
        "import sys\n"
        "from gpu_feature_discovery_tpu_torch.cmd.main import start\n"
        "from gpu_feature_discovery_tpu_torch.config.flags import new_config\n"
        "from gpu_feature_discovery_tpu_torch.lm.engine import LabelEngine\n"
        "from gpu_feature_discovery_tpu_torch.lm.labelers import new_label_sources\n"
        "from gpu_feature_discovery_tpu_torch.resource.nvml_backend import NvmlManager\n"
        "from gpu_feature_discovery_tpu_torch.resource.testing import fake_nvml\n"
        "c = new_config(cli_values={'tpu-topology-strategy': 'mixed'}, environ={})\n"
        "labels = LabelEngine().generate(new_label_sources("
        "NvmlManager(fake_nvml('mixed')), c))\n"
        "assert labels['nvidia.com/mig-3g.40gb.count'] == '2', labels\n"
        f"assert start(['--oneshot', '--backends', 'mock-nvml:mixed', "
        f"'--output-file', sys.argv[1]]) == 0\n"
        "assert 'torch' not in sys.modules, 'torch imported'\n"
    )
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        proc = subprocess.run([sys.executable, "-c", code, f"{tmp}/tfd"], cwd=REPO,
                              capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


# ---------------------------------------------------------------------------
# Health labels under MIG: the classic probe measures the plain GPUs CUDA
# lists, a process pinned to each MIG device measures that device, and the
# per-device labels count what gpu.count counts, on the in-process path
# and through the broker.
# ---------------------------------------------------------------------------

PER_DEVICE_HEALTH = re.compile(r"nvidia\.com/gpu\.(chip\.\d+\.|chips\.|straggler-chip$)")


def _cuda_listed_devices():
    """A CPU device standing in for each device CUDA lists (the
    TFD_BURNIN_ALLOW_CPU way); the probe runs on them at the
    TFD_BURNIN_GEOMETRY the test sets."""
    import torch

    return [torch.device("cpu")] * torch.cuda.device_count()


class _FakeBrokerClient:
    """A broker client whose worker holds ``manager``: snapshots of it,
    and health requests answered by the probe on CUDA's devices."""

    def __init__(self, manager):
        self._manager = manager

    def snapshot(self):
        return DeviceSnapshot.from_manager(self._manager)

    def health(self, per_chip=True, sick_chips=(), slow_chips=(), inventory_uuids=()):
        from gpu_feature_discovery_tpu_torch.ops.healthcheck import measure_node_health
        from gpu_feature_discovery_tpu_torch.sandbox.broker import _classic_devices

        # The worker's own acquisition: on a MIG node, its plain GPUs.
        devices = _classic_devices(self._manager)()
        if devices is None:
            return {"status": "unacquirable"}
        report = measure_node_health(
            devices=devices, per_chip=per_chip, sick_chips=sick_chips,
            slow_chips=slow_chips, inventory_uuids=inventory_uuids)
        # The report crosses the worker's pipe as JSON.
        return json.loads(json.dumps(
            {"status": "ok", "report": report, "probe_ms": 1.0}))

    def kill_child(self):
        pass


def _listed_uuids(devices):
    """The UUIDs of the devices CUDA lists, for their CPU stand-ins."""
    import torch

    return [nvml.normalize_uuid(torch.cuda.get_device_properties(i).uuid)
            for i in range(len(devices))]


def _health_cycle(manager, oneshot, monkeypatch, cycles=1):
    """The labels of ``cycles`` label cycles, each of them probing."""
    from gpu_feature_discovery_tpu_torch.lm import health
    from gpu_feature_discovery_tpu_torch.ops import healthcheck

    monkeypatch.setattr(health, "_acquire_devices", _cuda_listed_devices)
    monkeypatch.setattr(healthcheck, "device_uuids", _listed_uuids)
    monkeypatch.setenv("TFD_BURNIN_GEOMETRY", "64x1")
    health.reset_burnin_schedule()
    tfd_logging.reset_warn_once()
    config = new_config(cli_values={"with-burnin": "true", "oneshot": oneshot,
                                    "burnin-interval": "1",
                                    "machine-type-file": ""}, environ={})
    try:
        engine = LabelEngine(parallel=False)
        for _ in range(cycles):
            labels = dict(engine.generate(new_label_sources(manager, config)))
        return labels
    finally:
        health.reset_burnin_schedule()
        tfd_logging.reset_warn_once()


@pytest.mark.parametrize("path", ["in-process", "broker"])
@pytest.mark.parametrize("layout", ["mixed", "half", "none"])
def test_health_labels_never_contradict_gpu_count_under_mig(
        layout, path, fake_torch_cuda, monkeypatch, caplog):
    """``mixed``: every GPU in MIG mode; ``half``: a plain GPU beside a
    MIG-enabled one. Every GPU gpu.count counts has its chip.<i>.ok, a
    MIG-enabled GPU's from its MIG devices' probes, with no rate label
    (a MIG device's rate is not its GPU's); with MIG off (``none``) the
    classic probe alone, as before."""
    fake = fake_nvml(layout)
    listed = fake_torch_cuda(fake)
    workers = MigWorkers(monkeypatch)
    cuda = CudaManager(nvml_lib=fake)
    cuda.init()
    manager = cuda if path == "in-process" else BrokerManager(_FakeBrokerClient(cuda))
    with caplog.at_level("WARNING", logger="tfd.lm"):
        labels = _health_cycle(manager, oneshot=path == "in-process",
                               monkeypatch=monkeypatch)
    count = int(labels["nvidia.com/gpu.count"])
    assert count == len(fake.gpus)
    assert labels["nvidia.com/gpu.health.ok"] == "true"
    assert labels["nvidia.com/gpu.health.timing"] == "wall-clock"
    per_device = sorted(k for k in labels if PER_DEVICE_HEALTH.match(k))
    assert int(labels["nvidia.com/gpu.chips.healthy"]) + int(
        labels["nvidia.com/gpu.chips.sick"]) == count
    # Exactly these per-device keys on every layout: no rate or straggler
    # label at this geometry, and none for a MIG-enabled GPU at all.
    assert per_device == sorted(
        ["nvidia.com/gpu.chips.healthy", "nvidia.com/gpu.chips.sick"]
        + [f"nvidia.com/gpu.chip.{i}.ok" for i in range(count)])
    mig_gpus = [i for i, g in enumerate(fake.gpus) if g.mig_mode == nvml.NVML_DEVICE_MIG_ENABLE]
    # One probe per MIG device, none for a plain GPU.
    assert sorted(w for w, _ in workers.requests) == sorted(
        (i, slot) for i in mig_gpus for slot, p in enumerate(
            [p for p in fake.gpus[i].mig if p]))
    assert not [r for r in caplog.records if "per-device" in r.message], caplog.text
    if layout == "none":
        assert len(listed) == count and not workers.requests


# ---------------------------------------------------------------------------
# The per-device labels are keyed by NVML's index: the probe's devices
# are CUDA's, joined to the inventory by UUID. CUDA may list the GPUs in
# another order (CUDA_VISIBLE_DEVICES=1,0, CUDA_DEVICE_ORDER) or only some
# of them (CUDA_VISIBLE_DEVICES=1).
# ---------------------------------------------------------------------------

def test_uuid_normalizer_joins_torchs_and_nvmls_spellings():
    nvml_form = "GPU-2B7F0C5A-91D3-4E8F-A2C1-6D0E9F3B4A57"
    torch_form = "2b7f0c5a-91d3-4e8f-a2c1-6d0e9f3b4a57"  # str(_CUuuid)
    assert nvml.normalize_uuid(nvml_form) == nvml.normalize_uuid(torch_form) == torch_form
    assert nvml.normalize_uuid(f"  {torch_form.upper()}\n") == torch_form
    assert nvml.normalize_uuid(None) == nvml.normalize_uuid("") == ""
    assert nvml.inventory_positions([nvml_form, "GPU-00"], [None, torch_form]) == {0: 1}
    assert nvml.inventory_positions(["", ""], [torch_form]) is None


def test_fake_nvml_gives_every_gpu_a_deterministic_uuid(fake_torch_cuda):
    uuids = [d.uuid for d in nvml.read_inventory(fake_nvml("none")).devices]
    assert uuids == [d.uuid for d in nvml.read_inventory(fake_nvml("none")).devices]
    assert len(set(uuids)) == 2 and all(u.startswith("GPU-") for u in uuids)
    fake_torch_cuda(fake_nvml("none"))
    cuda = CudaManager(nvml_lib=fake_nvml("none"))
    assert DeviceSnapshot.from_manager(_inited(cuda)).to_dict()["chips"][1]["uuid"] == uuids[1]


def _inited(manager):
    manager.init()
    return manager


def _fault_cycle(layout_gpus, order, spec, path, fake_torch_cuda, monkeypatch, caplog,
                 cycles=1):
    """The labels of ``cycles`` probing cycles on a FakeNvml node whose
    CUDA lists ``order``, under the fault ``spec``, and each probe's
    report as the labeler received it."""
    from gpu_feature_discovery_tpu_torch.lm import health
    from gpu_feature_discovery_tpu_torch.utils import faults

    reports = []
    real = health._labels_from_probe

    def spy(sched, manager, config, report, error, probe_ms):
        reports.append((json.loads(json.dumps(report)), probe_ms))
        return real(sched, manager, config, report, error, probe_ms)

    monkeypatch.setattr(health, "_labels_from_probe", spy)
    fake = FakeNvml(layout_gpus)
    fake_torch_cuda(fake, order)
    cuda = _inited(CudaManager(nvml_lib=fake))
    manager = cuda if path == "in-process" else BrokerManager(_FakeBrokerClient(cuda))
    faults.reset()
    faults.load_fault_spec(spec)
    try:
        with caplog.at_level("WARNING", logger="tfd.lm"):
            labels = _health_cycle(manager, oneshot=path == "in-process",
                                   monkeypatch=monkeypatch, cycles=cycles)
    finally:
        faults.reset()
    return labels, reports, [nvml.normalize_uuid(g.uuid) for g in fake.gpus]


def _unhealthy_uuids(report):
    return [e["uuid"] for e in report["per_chip"] if not e["healthy"]]


def _h100s(n):
    return [FakeGpu(bus_id=f"00000000:{0x19 + 0x20 * i:02X}:00.0") for i in range(n)]


@pytest.mark.parametrize("path", ["in-process", "broker"])
def test_permuted_cuda_order_keys_the_labels_by_nvml_index(
        path, fake_torch_cuda, monkeypatch, caplog):
    """CUDA lists NVML's GPUs as [1, 0] and NVML GPU 1 is sick: the label
    and the fault site both name NVML's 1, the GPU CUDA calls 0."""
    labels, [(report, _)], uuids = _fault_cycle(
        _h100s(2), [1, 0], "chip.1.sick:fail:1", path, fake_torch_cuda, monkeypatch, caplog)
    assert [e["uuid"] for e in report["per_chip"]] == [uuids[1], uuids[0]]
    assert _unhealthy_uuids(report) == [uuids[1]]
    assert labels["nvidia.com/gpu.count"] == "2"
    assert labels["nvidia.com/gpu.chip.1.ok"] == "false"
    assert labels["nvidia.com/gpu.chip.0.ok"] == "true"
    assert (labels["nvidia.com/gpu.chips.healthy"], labels["nvidia.com/gpu.chips.sick"]) == ("1", "1")
    assert labels["nvidia.com/gpu.health.ok"] == "false"


@pytest.mark.parametrize("path", ["in-process", "broker"])
def test_permuted_cuda_order_names_the_straggler_by_nvml_index(
        path, fake_torch_cuda, monkeypatch, caplog):
    """Three GPUs listed [1, 0, 2], NVML GPU 1 slow on two probes in a
    row: ``straggler-chip`` names 1 (CUDA's 0)."""
    labels, reports, uuids = _fault_cycle(
        _h100s(3), [1, 0, 2], "chip.1.slow:fail:2", path, fake_torch_cuda, monkeypatch,
        caplog, cycles=2)
    for report, _ in reports:
        slowest = min(report["per_chip"], key=lambda e: e["tflops_best"])
        assert slowest["uuid"] == uuids[1] == report["per_chip"][0]["uuid"]
    assert labels["nvidia.com/gpu.straggler-chip"] == "1"
    assert all(labels[f"nvidia.com/gpu.chip.{i}.ok"] == "true" for i in range(3))


@pytest.mark.parametrize("path", ["in-process", "broker"])
def test_cuda_subset_publishes_no_per_device_labels(
        path, fake_torch_cuda, monkeypatch, caplog):
    """CUDA lists only NVML GPU 1 of two (CUDA_VISIBLE_DEVICES=1): no
    per-device label, one warning, the node's health labels kept; the
    fault on NVML GPU 1 still reaches the one device CUDA lists."""
    labels, [(report, _)], uuids = _fault_cycle(
        _h100s(2), [1], "chip.1.sick:fail:1", path, fake_torch_cuda, monkeypatch, caplog)
    assert _unhealthy_uuids(report) == [uuids[1]]
    assert labels["nvidia.com/gpu.count"] == "2"
    assert not [k for k in labels if PER_DEVICE_HEALTH.match(k)]
    assert labels["nvidia.com/gpu.health.ok"] == "false"
    assert labels["nvidia.com/gpu.health.timing"] == "wall-clock"
    warned = [r.getMessage() for r in caplog.records if "one to one by UUID" in r.message]
    assert warned == [
        "CUDA lists 1 device(s) that are not the node's 2 GPU(s) one to one by "
        "UUID; publishing no per-device health labels"]


@pytest.mark.parametrize("path", ["in-process", "broker"])
def test_identity_cuda_order_gives_the_twins_labels(
        path, fake_torch_cuda, monkeypatch, caplog):
    """CUDA and NVML agree on the order: the health labels are the twin's
    byte for byte, on the twin's own inputs (its labeler over the same
    probe report, its keys under the one key rule)."""
    from gpu_feature_discovery_tpu.lm import health as twin_health

    labels, [(report, probe_ms)], uuids = _fault_cycle(
        _h100s(2), [0, 1], "chip.1.sick:fail:1", path, fake_torch_cuda, monkeypatch, caplog)
    assert _unhealthy_uuids(report) == [uuids[1]]
    port_health = {k: v for k, v in labels.items() if k.startswith(
        ("nvidia.com/gpu.health.", "nvidia.com/gpu.chip", "nvidia.com/gpu.straggler"))}
    twin_config = _twin_burnin_config()
    twin_health.reset_burnin_schedule()
    try:
        twin_labels = twin_health._labels_from_probe(
            twin_health._BurninSchedule(), None, twin_config, report, None, probe_ms)
    finally:
        twin_health.reset_burnin_schedule()
    assert port_health == {k.replace("google.com/tpu.", "nvidia.com/gpu.", 1): v
                           for k, v in dict(twin_labels).items()}
    assert labels["nvidia.com/gpu.chip.1.ok"] == "false"


def _twin_burnin_config():
    from gpu_feature_discovery_tpu.config.flags import new_config as twin_new_config

    return twin_new_config(cli_values={"with-burnin": "true", "oneshot": "true",
                                       "machine-type-file": ""}, environ={})


# ---------------------------------------------------------------------------
# Fault 6: under MIG the node's verdict covered one MIG device. Each MIG
# device is now probed by a process pinned to it (tests/torch_mig_fakes.py
# stands in for those processes here; tests/test_torch_mig_probe.py runs
# the real ones).
# ---------------------------------------------------------------------------

def _mig_cycle(layout, path, spec, fake_torch_cuda, monkeypatch, caplog, order=None,
               **workers_kw):
    fake = fake_nvml(layout)
    fake_torch_cuda(fake, order)
    workers = MigWorkers(monkeypatch, **workers_kw)
    cuda = _inited(CudaManager(nvml_lib=fake))
    manager = cuda if path == "in-process" else BrokerManager(_FakeBrokerClient(cuda))
    faults.reset()
    faults.load_fault_spec(spec)
    try:
        with caplog.at_level("WARNING", logger="tfd.lm"):
            labels = _health_cycle(manager, oneshot=path == "in-process",
                                   monkeypatch=monkeypatch)
    finally:
        faults.reset()
    return labels, workers


@pytest.mark.parametrize("path", ["in-process", "broker"])
def test_fault6_a_sick_mig_device_of_gpu1_turns_the_mixed_node_sick(
        path, fake_torch_cuda, monkeypatch, caplog):
    """Fault 6. On ``mixed`` a MIG device of GPU 1 is sick: the node reads
    health.ok=false with chips.sick=1 and chip.1.ok=false, as the twin's
    node with one sick chip does. A probe of the devices CUDA lists alone
    (one MIG device, GPU 0's) reads health.ok=true with no chips.sick."""
    labels, workers = _mig_cycle("mixed", path, "chip.1.sick:fail:1", fake_torch_cuda,
                                 monkeypatch, caplog)
    assert labels["nvidia.com/gpu.health.ok"] == "false"
    assert (labels["nvidia.com/gpu.chips.healthy"], labels["nvidia.com/gpu.chips.sick"]) \
        == ("1", "1")
    assert (labels["nvidia.com/gpu.chip.0.ok"], labels["nvidia.com/gpu.chip.1.ok"]) \
        == ("true", "false")
    # The shot hit GPU 1's first MIG device, through its pinned process.
    assert workers.asked((1, 0)) == [{"per_chip": True, "sick_chips": [0], "slow_chips": []}]
    assert all(r["sick_chips"] == [] for w, r in workers.requests if w != (1, 0))


@pytest.mark.parametrize("path", ["in-process", "broker"])
def test_a_half_node_whose_plain_gpu_cuda_does_not_list_publishes_no_health(
        path, fake_torch_cuda, monkeypatch, caplog):
    """``half`` where CUDA lists GPU 0's MIG device alone (as
    ``CUDA_VISIBLE_DEVICES=0`` would): the plain GPU's verdict is unknown,
    so no health label is published, as on a node without MIG whose
    devices are unacquirable. The MIG device's verdict never speaks for
    the node alone."""
    labels, _ = _mig_cycle("half", path, "", fake_torch_cuda, monkeypatch, caplog,
                           order=[0])
    assert labels["nvidia.com/gpu.count"] == "2"
    assert not [k for k in labels if k.startswith("nvidia.com/gpu.health.")
                or PER_DEVICE_HEALTH.match(k)], labels
    assert "none of the node's 1 GPU(s) outside MIG mode is acquirable" in caplog.text


@pytest.mark.parametrize("path", ["in-process", "broker"])
def test_a_busy_mig_device_beside_a_failed_plain_gpu_publishes_no_health(
        path, fake_torch_cuda, monkeypatch, caplog):
    """``half`` with GPU 0's MIG device busy and the plain GPU's probe
    failing (an illegal address): the busy device's verdict is unknown,
    so no verdict speaks for the node, on both paths alike; the failure
    is not published as health.ok=false."""
    from gpu_feature_discovery_tpu_torch.ops import healthcheck

    illegal = "CUDA error: an illegal memory access was encountered"

    def failing(**_):
        raise RuntimeError(illegal)

    monkeypatch.setattr(healthcheck, "measure_node_health", failing)
    monkeypatch.setattr(_FakeBrokerClient, "health", lambda self, **_: {
        "status": "probe-failed", "error": illegal, "probe_ms": 1.0})
    labels, workers = _mig_cycle("half", path, "", fake_torch_cuda, monkeypatch, caplog,
                                 busy={(0, 0)})
    assert workers.asked((0, 0)), "the MIG device was probed"
    assert labels["nvidia.com/gpu.count"] == "2"
    assert not [k for k in labels if k.startswith("nvidia.com/gpu.health.")
                or PER_DEVICE_HEALTH.match(k)], labels
    assert "a device is busy" in caplog.text


@pytest.mark.parametrize("failure", ["hang", "crash"])
def test_a_hung_or_crashed_mig_worker_costs_its_own_device_only(
        failure, fake_torch_cuda, monkeypatch, caplog):
    """Through the broker, GPU 1's second MIG device's worker is killed at
    its deadline (a hang) or found dead (a crash): GPU 1 alone reads
    sick, GPU 0's verdict stands, and the cycle publishes."""
    from gpu_feature_discovery_tpu_torch.sandbox.broker import BrokerCrash, BrokerTimeout

    error = BrokerTimeout("health request exceeded its budget; worker SIGKILLed") \
        if failure == "hang" else BrokerCrash("broker worker died to SIGSEGV")
    labels, _ = _mig_cycle("mixed", "broker", "", fake_torch_cuda, monkeypatch, caplog,
                           fail={(1, 1): error})
    assert labels["nvidia.com/gpu.count"] == "2"
    assert labels["nvidia.com/gpu.health.ok"] == "false"
    assert (labels["nvidia.com/gpu.chip.0.ok"], labels["nvidia.com/gpu.chip.1.ok"]) \
        == ("true", "false")
    assert str(error) in caplog.text


@pytest.mark.parametrize("path", ["in-process", "broker"])
def test_on_a_half_node_a_mig_gpus_shot_lands_on_its_mig_device(
        path, fake_torch_cuda, monkeypatch, caplog):
    """``half``: the plain GPU (NVML 1) is probed by the classic probe and
    keeps its chip.1.ok; GPU 0's verdict comes from its MIG device; a
    chip.0.sick shot lands on that device, not on the plain GPU."""
    labels, workers = _mig_cycle("half", path, "chip.0.sick:fail:1", fake_torch_cuda,
                                 monkeypatch, caplog)
    assert (labels["nvidia.com/gpu.chip.0.ok"], labels["nvidia.com/gpu.chip.1.ok"]) \
        == ("false", "true")
    assert workers.asked((0, 0))[0]["sick_chips"] == [0]
    assert labels["nvidia.com/gpu.health.ok"] == "false"
