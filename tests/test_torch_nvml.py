"""NVML through ctypes (native/nvml.py), the NVML-only manager and the
CUDA manager over NVML, on the CPU over FakeNvml.

FakeNvml implements NVML's C entry points and writes into the same
ctypes structs, so the struct decoding, the NOT_SUPPORTED and NOT_FOUND
paths and the error mapping run here. The driver-version repair is held
against the twin's version grammar; the NVML path must never import
torch."""

import ctypes
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
    fake_nvml,
)
from gpu_feature_discovery_tpu_torch.resource.types import ResourceError
from gpu_feature_discovery_tpu_torch.sandbox.broker import BrokerManager
from gpu_feature_discovery_tpu_torch.sandbox.snapshot import DeviceSnapshot
from gpu_feature_discovery_tpu_torch.utils import logging as tfd_logging

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


def _cuda_devices(fake):
    """The devices CUDA enumerates on a FakeNvml's node: each GPU outside
    MIG mode whole, fastest first (the reverse of NVML's PCI order here),
    and of the MIG devices only the first one, named after its profile
    and on its parent's bus (a CUDA process sees a single MIG device,
    per NVIDIA's MIG user guide)."""
    devices = []
    for gpu in reversed(fake.gpus):
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

    def install(fake):
        devices = _cuda_devices(fake)

        def props(i):
            name, memory_mib, gpu = devices[i]
            # Where NVML has no PCI info torch still has an address.
            domain, bus, devfn = (gpu.bus_id or "0000:db:00.0").split(":")
            return SimpleNamespace(
                name=name, major=gpu.compute_capability[0],
                minor=gpu.compute_capability[1], total_memory=memory_mib * 2**20,
                pci_domain_id=int(domain, 16), pci_bus_id=int(bus, 16),
                pci_device_id=int(devfn.split(".")[0], 16),
            )

        monkeypatch.setattr(torch.cuda, "is_available", lambda: bool(devices))
        monkeypatch.setattr(torch.cuda, "device_count", lambda: len(devices))
        monkeypatch.setattr(torch.cuda, "get_device_name", lambda i: devices[i][0])
        monkeypatch.setattr(torch.cuda, "get_device_properties", props)
        monkeypatch.setattr(cuda_backend, "cuda_driver_api_version", lambda: 13000)
        return devices

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
# Health labels under MIG: the probe measures the devices CUDA lists, the
# inventory counts NVML's GPUs. No per-device health label may contradict
# gpu.count, on the in-process path and through the broker.
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

    def health(self, per_chip=True, sick_chips=(), slow_chips=()):
        from gpu_feature_discovery_tpu_torch.ops.healthcheck import measure_node_health

        report = measure_node_health(devices=_cuda_listed_devices(), per_chip=per_chip)
        return {"status": "ok", "report": report, "probe_ms": 1.0}

    def kill_child(self):
        pass


def _health_cycle(manager, oneshot, monkeypatch):
    from gpu_feature_discovery_tpu_torch.lm import health

    monkeypatch.setattr(health, "_acquire_devices", _cuda_listed_devices)
    monkeypatch.setenv("TFD_BURNIN_GEOMETRY", "64x1")
    health.reset_burnin_schedule()
    tfd_logging.reset_warn_once()
    config = new_config(cli_values={"with-burnin": "true", "oneshot": oneshot,
                                    "machine-type-file": ""}, environ={})
    try:
        return dict(LabelEngine(parallel=False).generate(
            new_label_sources(manager, config)))
    finally:
        health.reset_burnin_schedule()
        tfd_logging.reset_warn_once()


@pytest.mark.parametrize("path", ["in-process", "broker"])
@pytest.mark.parametrize("layout", ["mixed", "half", "none"])
def test_health_labels_never_contradict_gpu_count_under_mig(
        layout, path, fake_torch_cuda, monkeypatch, caplog):
    """``mixed``: CUDA lists one MIG device of two GPUs; ``half``: the GPU
    outside MIG plus a MIG device of the other. Under MIG the per-device
    labels are left out with a warning and the node's health labels stay;
    with MIG off (``none``) every GPU has its chip.<i> labels."""
    fake = fake_nvml(layout)
    listed = fake_torch_cuda(fake)
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
    warned = [r.getMessage() for r in caplog.records if "MIG is enabled" in r.message]
    if layout == "none":
        assert len(listed) == count
        assert int(labels["nvidia.com/gpu.chips.healthy"]) + int(
            labels["nvidia.com/gpu.chips.sick"]) == count
        assert per_device == sorted(
            ["nvidia.com/gpu.chips.healthy", "nvidia.com/gpu.chips.sick"]
            + [f"nvidia.com/gpu.chip.{i}.ok" for i in range(count)])
        assert not warned
    else:
        assert not per_device, (
            f"{len(listed)} device(s) probed, gpu.count {count}: {per_device}")
        assert warned == [
            f"MIG is enabled on this node: the probe measures the {len(listed)} "
            "device(s) CUDA lists, not the node's GPUs; publishing no per-device "
            "health labels"]
