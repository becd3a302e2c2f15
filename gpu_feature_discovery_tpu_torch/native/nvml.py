"""NVML through ctypes (twin: ``gpu_feature_discovery_tpu/native/shim.py``).

The twin's native layer dlopens ``libtpu.so`` lazily, probes one symbol,
and reads facts without creating a runtime client. On a GPU node the
counterpart is NVML (``libnvidia-ml.so.1``, shipped with the kernel
driver): it enumerates devices, memory, PCI addresses, compute capability
and MIG partitions without a CUDA runtime and without creating a CUDA
context, so it neither takes device memory nor initialises CUDA in the
calling process.

Everything here tolerates absence: no library, or a library without the
probed symbol, is ``load_library() -> None``. An NVML call that fails
raises :class:`NvmlError` (a ``ResourceError``), with three exceptions:
``NVML_ERROR_NOT_SUPPORTED`` from ``nvmlDeviceGetMigMode`` means the
device is not MIG-capable, ``NVML_ERROR_NOT_FOUND`` for a MIG slot means
the slot is empty, and ``NVML_ERROR_NOT_SUPPORTED`` from
``nvmlDeviceGetPciInfo_v3`` means no PCI address.

:class:`Nvml` takes its library object as a parameter: the real ``CDLL``
or a fake that implements the same C entry points and writes into the
same ``ctypes`` structs (``resource/testing.py:FakeNvml``), so the struct
decoding below runs in the CPU tests.

PCI bus ids are normalised once, here, to the sysfs spelling
(``0000:19:00.0``): NVML and nvidia-smi give ``00000000:19:00.0``. Some
virtualised hosts give no PCI information at all
(``nvmlDeviceGetPciInfo_v3`` answers NOT_SUPPORTED, and nvidia-smi
prints ``[N/A]``); the bus id is then None.
"""

from __future__ import annotations

import ctypes
import logging
import time
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from gpu_feature_discovery_tpu_torch.resource.types import ResourceError

log = logging.getLogger("tfd.native")

NVML_LIBRARY = "libnvidia-ml.so.1"
PROBE_SYMBOL = "nvmlInit_v2"

# nvmlReturn_t values this module acts on or names (nvml.h).
NVML_SUCCESS = 0
NVML_ERROR_NOT_SUPPORTED = 3
NVML_ERROR_NOT_FOUND = 6
NVML_ERROR_NAMES: Dict[int, str] = {
    1: "NVML_ERROR_UNINITIALIZED",
    2: "NVML_ERROR_INVALID_ARGUMENT",
    3: "NVML_ERROR_NOT_SUPPORTED",
    4: "NVML_ERROR_NO_PERMISSION",
    5: "NVML_ERROR_ALREADY_INITIALIZED",
    6: "NVML_ERROR_NOT_FOUND",
    7: "NVML_ERROR_INSUFFICIENT_SIZE",
    9: "NVML_ERROR_DRIVER_NOT_LOADED",
    10: "NVML_ERROR_TIMEOUT",
    12: "NVML_ERROR_LIBRARY_NOT_FOUND",
    13: "NVML_ERROR_FUNCTION_NOT_FOUND",
    15: "NVML_ERROR_GPU_IS_LOST",
    999: "NVML_ERROR_UNKNOWN",
}
NVML_DEVICE_MIG_ENABLE = 1
SYSTEM_DRIVER_VERSION_BUFFER_SIZE = 80
DEVICE_NAME_BUFFER_SIZE = 96

nvmlDevice_t = ctypes.c_void_p


class NvmlMemory(ctypes.Structure):
    """nvmlMemory_t: bytes."""

    _fields_ = [
        ("total", ctypes.c_ulonglong),
        ("free", ctypes.c_ulonglong),
        ("used", ctypes.c_ulonglong),
    ]


class NvmlPciInfo(ctypes.Structure):
    """nvmlPciInfo_t as ``nvmlDeviceGetPciInfo_v3`` fills it."""

    _fields_ = [
        ("busIdLegacy", ctypes.c_char * 16),
        ("domain", ctypes.c_uint),
        ("bus", ctypes.c_uint),
        ("device", ctypes.c_uint),
        ("pciDeviceId", ctypes.c_uint),
        ("pciSubSystemId", ctypes.c_uint),
        ("busId", ctypes.c_char * 32),
    ]


class NvmlDeviceAttributes(ctypes.Structure):
    """nvmlDeviceAttributes_t: eight unsigned ints, then the memory size
    (an unsigned long long at offset 32)."""

    _fields_ = [
        ("multiprocessorCount", ctypes.c_uint),
        ("sharedCopyEngineCount", ctypes.c_uint),
        ("sharedDecoderCount", ctypes.c_uint),
        ("sharedEncoderCount", ctypes.c_uint),
        ("sharedJpegCount", ctypes.c_uint),
        ("sharedOfaCount", ctypes.c_uint),
        ("gpuInstanceSliceCount", ctypes.c_uint),
        ("computeInstanceSliceCount", ctypes.c_uint),
        ("memorySizeMB", ctypes.c_ulonglong),
    ]


_P = ctypes.POINTER
_UINT = ctypes.c_uint
# Every entry point this module calls, with its C argument types; all
# return nvmlReturn_t.
ENTRY_POINTS: Dict[str, Tuple] = {
    "nvmlInit_v2": (),
    "nvmlShutdown": (),
    "nvmlSystemGetDriverVersion": (ctypes.c_char_p, _UINT),
    "nvmlSystemGetCudaDriverVersion_v2": (_P(ctypes.c_int),),
    "nvmlDeviceGetCount_v2": (_P(_UINT),),
    "nvmlDeviceGetHandleByIndex_v2": (_UINT, _P(nvmlDevice_t)),
    "nvmlDeviceGetName": (nvmlDevice_t, ctypes.c_char_p, _UINT),
    "nvmlDeviceGetMemoryInfo": (nvmlDevice_t, _P(NvmlMemory)),
    "nvmlDeviceGetPciInfo_v3": (nvmlDevice_t, _P(NvmlPciInfo)),
    "nvmlDeviceGetCudaComputeCapability": (
        nvmlDevice_t, _P(ctypes.c_int), _P(ctypes.c_int)
    ),
    "nvmlDeviceGetMigMode": (nvmlDevice_t, _P(_UINT), _P(_UINT)),
    "nvmlDeviceGetMaxMigDeviceCount": (nvmlDevice_t, _P(_UINT)),
    "nvmlDeviceGetMigDeviceHandleByIndex": (nvmlDevice_t, _UINT, _P(nvmlDevice_t)),
    "nvmlDeviceGetAttributes_v2": (nvmlDevice_t, _P(NvmlDeviceAttributes)),
}


class NvmlError(ResourceError):
    """An NVML call that did not return NVML_SUCCESS."""

    def __init__(self, function: str, code: int):
        self.function = function
        self.code = code
        super().__init__(
            f"{function} failed: {NVML_ERROR_NAMES.get(code, 'NVML error')} ({code})"
        )


def normalize_bus_id(bus_id: str) -> str:
    """Any PCI address spelling → sysfs's ``dddd:bb:dd.f`` (lower case):
    ``00000000:19:00.0`` → ``0000:19:00.0``; a missing domain is 0."""
    parts = bus_id.strip().split(":")
    if len(parts) == 2:
        parts = ["0"] + parts
    try:
        domain, bus, devfn = parts
        dev, fn = devfn.split(".")
        return f"{int(domain, 16):04x}:{int(bus, 16):02x}:{int(dev, 16):02x}.{int(fn, 16):x}"
    except ValueError as e:
        raise ValueError(f"not a PCI bus id: {bus_id!r}") from e


@dataclass(frozen=True)
class MigDeviceInfo:
    """One MIG device, from ``nvmlDeviceGetAttributes_v2`` on its handle."""

    slot: int
    multiprocessors: int
    copy_engines: int
    decoders: int
    encoders: int
    jpeg: int
    ofa: int
    gi_slices: int
    ci_slices: int
    memory_mb: int

    @property
    def profile(self) -> str:
        """The reference's MIG device name (nvml-mig-device.go GetName):
        ``<gi>g.<gb>gb``, prefixed ``<ci>c.`` when the compute instance
        is smaller than its GPU instance; gb is memory rounded up."""
        gb = -(-self.memory_mb // 1024)
        base = f"{self.gi_slices}g.{gb}gb"
        if self.ci_slices == self.gi_slices:
            return base
        return f"{self.ci_slices}c.{base}"

    def attributes(self) -> Dict[str, int]:
        """The label attribute family of the reference's MIG device
        (nvml-mig-device.go GetAttributes)."""
        return {
            "memory": self.memory_mb,
            "multiprocessors": self.multiprocessors,
            "slices.gi": self.gi_slices,
            "slices.ci": self.ci_slices,
            "engines.copy": self.copy_engines,
            "engines.decoder": self.decoders,
            "engines.encoder": self.encoders,
            "engines.jpeg": self.jpeg,
            "engines.ofa": self.ofa,
        }


@dataclass(frozen=True)
class DeviceInfo:
    """One full GPU as NVML reports it."""

    index: int
    name: str
    memory_total_bytes: int
    bus_id: Optional[str]  # sysfs spelling; None where NVML has no PCI info
    compute_capability: Tuple[int, int]
    mig_capable: bool
    mig_enabled: bool
    mig_devices: Tuple[MigDeviceInfo, ...] = ()

    @property
    def memory_mb(self) -> int:
        return self.memory_total_bytes // 2**20


@dataclass(frozen=True)
class Inventory:
    """The node as NVML reports it, with the cost of reading it."""

    driver_version: str  # kernel driver, e.g. "580.159.03"
    cuda_driver_version: int  # CUDA driver API, 1000*major + 10*minor
    devices: Tuple[DeviceInfo, ...]
    init_ms: float
    enumerate_ms: float


def load_library(path: str = NVML_LIBRARY):
    """dlopen NVML and probe one entry point; None when absent (a node
    without the NVIDIA driver, or this sandbox)."""
    try:
        lib = ctypes.CDLL(path)
        getattr(lib, PROBE_SYMBOL)
    except (OSError, AttributeError) as e:
        log.debug("NVML not loadable from %s: %s", path, e)
        return None
    return lib


class Nvml:
    """Typed calls over an NVML library object (the real ``CDLL`` or a
    fake with the same C entry points)."""

    def __init__(self, lib):
        self._lib = lib
        for name, argtypes in ENTRY_POINTS.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int

    def _rc(self, name: str, *args) -> int:
        return int(getattr(self._lib, name)(*args))

    def _check(self, name: str, *args) -> None:
        rc = self._rc(name, *args)
        if rc != NVML_SUCCESS:
            raise NvmlError(name, rc)

    def init(self) -> None:
        self._check("nvmlInit_v2")

    def shutdown(self) -> None:
        self._check("nvmlShutdown")

    def driver_version(self) -> str:
        buf = ctypes.create_string_buffer(SYSTEM_DRIVER_VERSION_BUFFER_SIZE)
        self._check("nvmlSystemGetDriverVersion", buf, len(buf))
        return buf.value.decode(errors="replace")

    def cuda_driver_version(self) -> int:
        v = ctypes.c_int(0)
        self._check("nvmlSystemGetCudaDriverVersion_v2", ctypes.pointer(v))
        return v.value

    def device_count(self) -> int:
        n = ctypes.c_uint(0)
        self._check("nvmlDeviceGetCount_v2", ctypes.pointer(n))
        return n.value

    def handle(self, index: int) -> nvmlDevice_t:
        h = nvmlDevice_t()
        self._check("nvmlDeviceGetHandleByIndex_v2", index, ctypes.pointer(h))
        return h

    def name(self, h: nvmlDevice_t) -> str:
        buf = ctypes.create_string_buffer(DEVICE_NAME_BUFFER_SIZE)
        self._check("nvmlDeviceGetName", h, buf, len(buf))
        return buf.value.decode(errors="replace")

    def memory_info(self, h: nvmlDevice_t) -> NvmlMemory:
        mem = NvmlMemory()
        self._check("nvmlDeviceGetMemoryInfo", h, ctypes.pointer(mem))
        return mem

    def bus_id(self, h: nvmlDevice_t) -> Optional[str]:
        """The device's PCI address; None where NVML has no PCI info."""
        pci = NvmlPciInfo()
        rc = self._rc("nvmlDeviceGetPciInfo_v3", h, ctypes.pointer(pci))
        if rc == NVML_ERROR_NOT_SUPPORTED:
            return None
        if rc != NVML_SUCCESS:
            raise NvmlError("nvmlDeviceGetPciInfo_v3", rc)
        return normalize_bus_id(pci.busId.decode())

    def compute_capability(self, h: nvmlDevice_t) -> Tuple[int, int]:
        major, minor = ctypes.c_int(0), ctypes.c_int(0)
        self._check("nvmlDeviceGetCudaComputeCapability", h,
                    ctypes.pointer(major), ctypes.pointer(minor))
        return (major.value, minor.value)

    def mig_mode(self, h: nvmlDevice_t) -> Optional[int]:
        """The current MIG mode; None when the device is not MIG-capable."""
        current, pending = ctypes.c_uint(0), ctypes.c_uint(0)
        rc = self._rc("nvmlDeviceGetMigMode", h,
                      ctypes.pointer(current), ctypes.pointer(pending))
        if rc == NVML_ERROR_NOT_SUPPORTED:
            return None
        if rc != NVML_SUCCESS:
            raise NvmlError("nvmlDeviceGetMigMode", rc)
        return current.value

    def mig_devices(self, h: nvmlDevice_t) -> Tuple[MigDeviceInfo, ...]:
        """Every populated MIG slot of an MIG-enabled device."""
        n = ctypes.c_uint(0)
        self._check("nvmlDeviceGetMaxMigDeviceCount", h, ctypes.pointer(n))
        out = []
        for slot in range(n.value):
            mig = nvmlDevice_t()
            rc = self._rc("nvmlDeviceGetMigDeviceHandleByIndex", h, slot,
                          ctypes.pointer(mig))
            if rc == NVML_ERROR_NOT_FOUND:
                continue  # an empty slot
            if rc != NVML_SUCCESS:
                raise NvmlError("nvmlDeviceGetMigDeviceHandleByIndex", rc)
            a = NvmlDeviceAttributes()
            self._check("nvmlDeviceGetAttributes_v2", mig, ctypes.pointer(a))
            out.append(MigDeviceInfo(
                slot=slot,
                multiprocessors=a.multiprocessorCount,
                copy_engines=a.sharedCopyEngineCount,
                decoders=a.sharedDecoderCount,
                encoders=a.sharedEncoderCount,
                jpeg=a.sharedJpegCount,
                ofa=a.sharedOfaCount,
                gi_slices=a.gpuInstanceSliceCount,
                ci_slices=a.computeInstanceSliceCount,
                memory_mb=a.memorySizeMB,
            ))
        return tuple(out)

    def device_info(self, index: int) -> DeviceInfo:
        h = self.handle(index)
        mode = self.mig_mode(h)
        enabled = mode == NVML_DEVICE_MIG_ENABLE
        return DeviceInfo(
            index=index,
            name=self.name(h),
            memory_total_bytes=self.memory_info(h).total,
            bus_id=self.bus_id(h),
            compute_capability=self.compute_capability(h),
            mig_capable=mode is not None,
            mig_enabled=enabled,
            mig_devices=self.mig_devices(h) if enabled else (),
        )

    def inventory(self) -> Inventory:
        """init → system facts and every device → shutdown."""
        t0 = time.perf_counter()
        self.init()
        t1 = time.perf_counter()
        try:
            driver = self.driver_version()
            cuda = self.cuda_driver_version()
            devices = tuple(self.device_info(i) for i in range(self.device_count()))
        finally:
            self.shutdown()
        return Inventory(
            driver_version=driver,
            cuda_driver_version=cuda,
            devices=devices,
            init_ms=(t1 - t0) * 1e3,
            enumerate_ms=(time.perf_counter() - t1) * 1e3,
        )


def read_inventory(lib=None) -> Inventory:
    """The node's inventory through ``lib``, or through the system's NVML;
    a ResourceError when there is none."""
    if lib is None:
        lib = load_library()
        if lib is None:
            raise ResourceError(f"NVML not loadable ({NVML_LIBRARY})")
    return Nvml(lib).inventory()


def cuda_version_tuple(encoded: int) -> Tuple[int, int]:
    """13000 → (13, 0): the CUDA driver API's 1000*major + 10*minor."""
    return (encoded // 1000, (encoded % 1000) // 10)
