"""Mock backends and a fake NVML for hardware-free tests (twin:
``gpu_feature_discovery_tpu/resource/testing.py``).

- ``MockChip`` / ``MockSlice`` / ``MockManager``: the twin's call-recording
  mocks, generic over name, memory, generation and MIG partitions (the
  twin builds its chips from TPU spec tables instead).
- ``FakeNvml``: an object with NVML's C entry points (the subset
  native/nvml.py calls) that writes into the same ``ctypes`` structs, so
  the real decoding runs on the CPU. Its GPUs are an H100 80GB HBM3 as
  one reported itself through NVML (name, ``memory.total``, compute
  capability, MIG capable, driver 580.159.03 with CUDA 13.0; the
  ``recorded`` layout is that card whole, on a virtualised host whose
  NVML gives no PCI information), and its MIG devices carry the
  attributes of NVIDIA's published H100 80GB MIG profiles.
- ``LAYOUTS`` / ``fake_nvml``: named node layouts behind the
  ``mock-nvml:<layout>`` backend token (resource/factory.py), the
  counterpart of the twin's ``mock:`` fixtures for CLI tests on the CPU.
"""

from __future__ import annotations

import ctypes
from collections import Counter, defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from gpu_feature_discovery_tpu_torch.native import nvml
from gpu_feature_discovery_tpu_torch.resource.types import Chip, Manager, ResourceError

MOCK_DRIVER_VERSION = "1.9.0"
MOCK_RUNTIME_VERSION = (0, 51)


class MockSlice(Chip):
    """A MIG-partition mock: a name, whole-partition memory and an
    attribute dict."""

    def __init__(self, name: str, parent: "MockChip", memory_mb: int = 0,
                 attributes: Optional[Dict[str, object]] = None):
        self._name = name
        self._parent = parent
        self._memory_mb = memory_mb
        self._attributes = dict(attributes or {})
        self.calls: Dict[str, int] = defaultdict(int)

    def is_slice_enabled(self) -> bool:
        raise ResourceError("is_slice_enabled not supported for slice partitions")

    def is_slice_capable(self) -> bool:
        raise ResourceError("is_slice_capable not supported for slice partitions")

    def get_slices(self) -> List[Chip]:
        raise ResourceError("get_slices not supported for slice partitions")

    def get_attributes(self) -> Dict[str, object]:
        self.calls["get_attributes"] += 1
        return dict(self._attributes)

    def get_name(self) -> str:
        self.calls["get_name"] += 1
        return self._name

    def get_total_memory_mb(self) -> int:
        return self._memory_mb

    def get_parent_chip(self) -> Chip:
        self.calls["get_parent_chip"] += 1
        return self._parent

    def get_generation(self) -> Tuple[int, int]:
        return self._parent.get_generation()


@dataclass(frozen=True)
class SliceSpec:
    """What a MockSlice is built from."""

    name: str
    memory_mb: int = 0
    attributes: Dict[str, object] = field(default_factory=dict)


class MockChip(Chip):
    """A full-GPU mock."""

    def __init__(
        self,
        name: str = "mock-gpu",
        memory_mb: int = 16384,
        generation: Tuple[int, int] = (0, 0),
        slices: Sequence[SliceSpec] = (),
        slice_enabled: Optional[bool] = None,
        slice_capable: bool = True,
    ):
        self._name = name
        self._memory_mb = memory_mb
        self._generation = tuple(generation)
        self._slices = [MockSlice(s.name, self, s.memory_mb, s.attributes) for s in slices]
        self._slice_enabled = (
            slice_enabled if slice_enabled is not None else bool(self._slices)
        )
        self._slice_capable = slice_capable
        self.calls: Dict[str, int] = defaultdict(int)

    def is_slice_enabled(self) -> bool:
        self.calls["is_slice_enabled"] += 1
        return self._slice_enabled

    def is_slice_capable(self) -> bool:
        self.calls["is_slice_capable"] += 1
        return self._slice_capable

    def get_slices(self) -> List[Chip]:
        self.calls["get_slices"] += 1
        return list(self._slices)

    def get_attributes(self) -> Dict[str, object]:
        raise ResourceError("get_attributes only supported for slice partitions")

    def get_name(self) -> str:
        self.calls["get_name"] += 1
        return self._name

    def get_total_memory_mb(self) -> int:
        self.calls["get_total_memory_mb"] += 1
        return self._memory_mb

    def get_parent_chip(self) -> Chip:
        raise ResourceError("get_parent_chip only supported for slice partitions")

    def get_generation(self) -> Tuple[int, int]:
        self.calls["get_generation"] += 1
        return self._generation


class MockManager(Manager):
    """Manager mock with call recording and init error injection
    (manager_mock.go + WithErrorOnInit, resource-testing.go:128-134)."""

    def __init__(
        self,
        chips: Optional[List[Chip]] = None,
        driver_version: str = MOCK_DRIVER_VERSION,
        runtime_version: Tuple[int, int] = MOCK_RUNTIME_VERSION,
        init_error: Optional[Exception] = None,
    ):
        self._chips = chips or []
        self._driver_version = driver_version
        self._runtime_version = runtime_version
        self._init_error = init_error
        self.calls: Dict[str, int] = defaultdict(int)

    def init(self) -> None:
        self.calls["init"] += 1
        if self._init_error is not None:
            raise self._init_error

    def shutdown(self) -> None:
        self.calls["shutdown"] += 1

    def get_chips(self) -> List[Chip]:
        self.calls["get_chips"] += 1
        return list(self._chips)

    def get_driver_version(self) -> str:
        self.calls["get_driver_version"] += 1
        return self._driver_version

    def get_runtime_version(self) -> Tuple[int, int]:
        self.calls["get_runtime_version"] += 1
        return self._runtime_version


# ---------------------------------------------------------------------------
# Fake NVML
# ---------------------------------------------------------------------------

H100_NAME = "NVIDIA H100 80GB HBM3"
H100_MEMORY_BYTES = 81559 * 2**20
H100_DRIVER_VERSION = "580.159.03"
H100_CUDA_DRIVER_VERSION = 13000

# NVIDIA's H100 80GB MIG profiles (MIG user guide, "H100 MIG Profiles"):
# SMs of the 132-SM part, shared copy engines, NVDECs, NVENCs (none on
# H100), NVJPGs, OFAs, GPU- and compute-instance slices, and the
# profile's memory in MiB. nvml.MigDeviceInfo.profile turns each back
# into its published name.
H100_MIG_PROFILES: Dict[str, Tuple[int, ...]] = {
    #           SMs  CE  DEC ENC JPG OFA  GI  CI  memory MiB
    "1g.10gb": (16, 1, 1, 0, 1, 0, 1, 1, 9984),
    "1g.20gb": (16, 1, 1, 0, 1, 0, 1, 1, 20096),
    "2g.20gb": (32, 2, 2, 0, 2, 0, 2, 2, 20096),
    "3g.40gb": (60, 3, 3, 0, 3, 0, 3, 3, 40320),
    "4g.40gb": (64, 4, 4, 0, 4, 0, 4, 4, 40320),
    "7g.80gb": (132, 7, 7, 0, 7, 1, 7, 7, 81152),
    # A 1-slice compute instance inside a 3-slice GPU instance.
    "1c.3g.40gb": (20, 3, 3, 0, 3, 0, 3, 1, 40320),
}
MAX_MIG_DEVICES = 7


@dataclass
class FakeGpu:
    """One GPU of a FakeNvml. ``bus_id`` None = no PCI information
    (GetPciInfo answers NOT_SUPPORTED, as on some virtualised hosts);
    ``mig_mode`` None = not MIG-capable (GetMigMode answers
    NOT_SUPPORTED); ``mig`` lists the populated MIG slots' profiles, None
    for an empty slot."""

    name: str = H100_NAME
    memory_total_bytes: int = H100_MEMORY_BYTES
    bus_id: Optional[str] = "00000000:19:00.0"
    compute_capability: Tuple[int, int] = (9, 0)
    mig_mode: Optional[int] = 0
    mig: Sequence[Optional[str]] = ()


class _Entry:
    """One fake C entry point: callable, and takes ``argtypes`` and
    ``restype`` the way a ctypes function does."""

    def __init__(self, owner: "FakeNvml", name: str, fn):
        self._owner = owner
        self._name = name
        self._fn = fn
        self.argtypes = None
        self.restype = None

    def __call__(self, *args) -> int:
        self._owner.calls[self._name] += 1
        rc = self._owner.fail.get(self._name)
        if rc is not None:
            return rc
        if self._name != "nvmlInit_v2" and not self._owner.initialized:
            return 1  # NVML_ERROR_UNINITIALIZED
        return self._fn(*args)


def _put_string(buf, length: int, value: str) -> int:
    raw = value.encode()
    if len(raw) + 1 > length:
        return 7  # NVML_ERROR_INSUFFICIENT_SIZE
    ctypes.memmove(buf, raw + b"\0", len(raw) + 1)
    return nvml.NVML_SUCCESS


class FakeNvml:
    """NVML's entry points over a list of FakeGpus. ``calls`` counts the
    calls per entry point; ``fail`` maps an entry point to the
    nvmlReturn_t it answers instead."""

    def __init__(
        self,
        gpus: Sequence[FakeGpu],
        driver_version: str = H100_DRIVER_VERSION,
        cuda_driver_version: int = H100_CUDA_DRIVER_VERSION,
        fail: Optional[Dict[str, int]] = None,
    ):
        self.gpus = list(gpus)
        self.driver_version = driver_version
        self.cuda_driver_version = cuda_driver_version
        self.fail: Dict[str, int] = dict(fail or {})
        self.calls: Counter = Counter()
        self.initialized = 0
        for name in nvml.ENTRY_POINTS:
            setattr(self, name, _Entry(self, name, getattr(self, "_" + name)))

    # Handles: GPU i is 16*(i+1); its MIG slot j is 16*(i+1) + j + 1.
    def _gpu(self, handle) -> Tuple[Optional[FakeGpu], Optional[int]]:
        value = handle.value or 0
        i, j = divmod(value, 16)
        if not 1 <= i <= len(self.gpus):
            return None, None
        return self.gpus[i - 1], (j - 1 if j else None)

    def _nvmlInit_v2(self) -> int:
        self.initialized += 1
        return nvml.NVML_SUCCESS

    def _nvmlShutdown(self) -> int:
        self.initialized -= 1
        return nvml.NVML_SUCCESS

    def _nvmlSystemGetDriverVersion(self, buf, length) -> int:
        return _put_string(buf, length, self.driver_version)

    def _nvmlSystemGetCudaDriverVersion_v2(self, ptr) -> int:
        ptr.contents.value = self.cuda_driver_version
        return nvml.NVML_SUCCESS

    def _nvmlDeviceGetCount_v2(self, ptr) -> int:
        ptr.contents.value = len(self.gpus)
        return nvml.NVML_SUCCESS

    def _nvmlDeviceGetHandleByIndex_v2(self, index, ptr) -> int:
        if not 0 <= index < len(self.gpus):
            return 2  # NVML_ERROR_INVALID_ARGUMENT
        ptr.contents.value = 16 * (index + 1)
        return nvml.NVML_SUCCESS

    def _full_gpu(self, handle) -> Optional[FakeGpu]:
        gpu, slot = self._gpu(handle)
        return gpu if slot is None else None

    def _nvmlDeviceGetName(self, handle, buf, length) -> int:
        gpu = self._full_gpu(handle)
        if gpu is None:
            return 2
        return _put_string(buf, length, gpu.name)

    def _nvmlDeviceGetMemoryInfo(self, handle, ptr) -> int:
        gpu = self._full_gpu(handle)
        if gpu is None:
            return 2
        ptr.contents.total = gpu.memory_total_bytes
        ptr.contents.free = gpu.memory_total_bytes
        ptr.contents.used = 0
        return nvml.NVML_SUCCESS

    def _nvmlDeviceGetPciInfo_v3(self, handle, ptr) -> int:
        gpu = self._full_gpu(handle)
        if gpu is None:
            return 2
        if gpu.bus_id is None:
            return nvml.NVML_ERROR_NOT_SUPPORTED
        domain, bus, devfn = gpu.bus_id.split(":")
        dev = devfn.split(".")[0]
        pci = ptr.contents
        pci.busId = gpu.bus_id.encode()
        pci.busIdLegacy = nvml.normalize_bus_id(gpu.bus_id).upper().encode()
        pci.domain, pci.bus, pci.device = int(domain, 16), int(bus, 16), int(dev, 16)
        pci.pciDeviceId = 0x233010DE
        pci.pciSubSystemId = 0x16C110DE
        return nvml.NVML_SUCCESS

    def _nvmlDeviceGetCudaComputeCapability(self, handle, major, minor) -> int:
        gpu = self._full_gpu(handle)
        if gpu is None:
            return 2
        major.contents.value, minor.contents.value = gpu.compute_capability
        return nvml.NVML_SUCCESS

    def _nvmlDeviceGetMigMode(self, handle, current, pending) -> int:
        gpu = self._full_gpu(handle)
        if gpu is None:
            return 2
        if gpu.mig_mode is None:
            return nvml.NVML_ERROR_NOT_SUPPORTED
        current.contents.value = pending.contents.value = gpu.mig_mode
        return nvml.NVML_SUCCESS

    def _nvmlDeviceGetMaxMigDeviceCount(self, handle, ptr) -> int:
        gpu = self._full_gpu(handle)
        if gpu is None:
            return 2
        if gpu.mig_mode is None:
            return nvml.NVML_ERROR_NOT_SUPPORTED
        ptr.contents.value = MAX_MIG_DEVICES
        return nvml.NVML_SUCCESS

    def _nvmlDeviceGetMigDeviceHandleByIndex(self, handle, index, ptr) -> int:
        gpu = self._full_gpu(handle)
        if gpu is None or gpu.mig_mode != nvml.NVML_DEVICE_MIG_ENABLE:
            return 2
        if not 0 <= index < MAX_MIG_DEVICES:
            return 2
        slots = list(gpu.mig)
        if index >= len(slots) or slots[index] is None:
            return nvml.NVML_ERROR_NOT_FOUND
        ptr.contents.value = handle.value + index + 1
        return nvml.NVML_SUCCESS

    def _nvmlDeviceGetAttributes_v2(self, handle, ptr) -> int:
        gpu, slot = self._gpu(handle)
        if gpu is None:
            return 2
        if slot is None:
            return nvml.NVML_ERROR_NOT_SUPPORTED  # a full GPU has none
        a = ptr.contents
        (a.multiprocessorCount, a.sharedCopyEngineCount, a.sharedDecoderCount,
         a.sharedEncoderCount, a.sharedJpegCount, a.sharedOfaCount,
         a.gpuInstanceSliceCount, a.computeInstanceSliceCount,
         a.memorySizeMB) = H100_MIG_PROFILES[gpu.mig[slot]]
        return nvml.NVML_SUCCESS


def _h100s(*migs: Optional[Sequence[Optional[str]]]) -> List[FakeGpu]:
    """One H100 per argument on consecutive buses: None = MIG disabled,
    a list = MIG enabled with those slots."""
    return [
        FakeGpu(
            bus_id=f"00000000:{0x19 + 0x20 * i:02X}:00.0",
            mig_mode=0 if mig is None else nvml.NVML_DEVICE_MIG_ENABLE,
            mig=() if mig is None else mig,
        )
        for i, mig in enumerate(migs)
    ]


# Node layouts of the ``mock-nvml:<layout>`` token.
LAYOUTS: Dict[str, List[FakeGpu]] = {
    # The H100 as NVML reported it on a virtualised host: no PCI info.
    "recorded": [FakeGpu(bus_id=None)],
    # Two H100s, MIG capable and disabled.
    "none": _h100s(None, None),
    # Every GPU in MIG mode with one profile: the valid single case.
    "single": _h100s(["3g.40gb", "3g.40gb"], ["3g.40gb", None, "3g.40gb"]),
    # Several profiles across the node.
    "mixed": _h100s(["3g.40gb", "2g.20gb", "1g.10gb", None, "1g.10gb"],
                    ["4g.40gb", "3g.40gb"]),
    # One GPU in MIG mode with no MIG device, one in MIG mode populated.
    "empty": _h100s([], ["7g.80gb"]),
    # One GPU in MIG mode, one not.
    "half": _h100s(["7g.80gb"], None),
    # A GPU without MIG support (GetMigMode answers NOT_SUPPORTED).
    "no-mig": [FakeGpu(name="NVIDIA L4", memory_total_bytes=23034 * 2**20,
                       bus_id="00000000:3B:00.0", compute_capability=(8, 9),
                       mig_mode=None)],
}


def fake_nvml(layout: str) -> FakeNvml:
    """A FakeNvml over a copy of the named layout."""
    if layout not in LAYOUTS:
        raise KeyError(layout)
    return FakeNvml([FakeGpu(**vars(g)) for g in LAYOUTS[layout]])
