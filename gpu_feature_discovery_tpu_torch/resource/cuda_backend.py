"""CUDA device manager (twin: ``gpu_feature_discovery_tpu/resource/pjrt_backend.py``).

``CudaManager`` is the twin of ``PjrtManager``: the backend for a node
whose CUDA devices PyTorch can use (the burn-in runs on them). The
product name is the lower-cased device name made label-safe (the twin's
treatment of the PJRT device kind) and the generation is the compute
capability.

When NVML loads (native/nvml.py), the chips are NVML's, exactly as the
NVML-only manager (resource/nvml_backend.py) builds them: full GPUs with
their MIG mode and MIG partitions, ``memory.total``, and the kernel
driver's version for the ``driver`` labels. Torch's own enumeration
cannot stand in for it on a MIG node: there CUDA lists MIG devices, not
GPUs, and a process sees at most one of them. When NVML does not load,
the manager warns once, takes torch's devices (slice-less, with torch's
memory) and publishes no ``driver`` labels: only NVML knows the kernel
driver. The ``runtime`` labels are the CUDA driver API's version from
``cuDriverGetVersion`` in ``libcuda.so.1`` (13000 → 13.0), as the
reference splits driver and CUDA version (nvml.go:75-137).

``StaticCudaManager`` is the hardware-free fixture behind the
``mock-gpu:<n>`` backend token, with the constants of the twin's
``StaticPjrtManager.mock_gpu``.

Enumeration happens in ``init()``, never at import.
"""

from __future__ import annotations

import ctypes
import logging
from typing import List, Optional, Tuple

from gpu_feature_discovery_tpu_torch.lm.labels import label_safe_value
from gpu_feature_discovery_tpu_torch.native import nvml
from gpu_feature_discovery_tpu_torch.resource.slice_partition import MigPartition
from gpu_feature_discovery_tpu_torch.resource.types import Chip, Manager, ResourceError
from gpu_feature_discovery_tpu_torch.utils.logging import warn_once

log = logging.getLogger("tfd.resource")


class CudaChip(Chip):
    """One full GPU: its name, memory and compute capability, and its MIG
    partitions when NVML reported the device (none without NVML, the
    way a non-MIG GPU answers)."""

    def __init__(
        self,
        name: str,
        memory_mb: int,
        generation: Tuple[int, int] = (0, 0),
        nvml_device: Optional[nvml.DeviceInfo] = None,
    ):
        self._name = name
        self._uuid = nvml_device.uuid if nvml_device else ""
        self._memory_mb = memory_mb
        self._generation = tuple(generation)
        self._mig_capable = bool(nvml_device and nvml_device.mig_capable)
        self._mig_enabled = bool(nvml_device and nvml_device.mig_enabled)
        self._slices: List[Chip] = [
            MigPartition(m, self) for m in (nvml_device.mig_devices if nvml_device else ())
        ]

    def is_slice_enabled(self) -> bool:
        return self._mig_enabled

    def is_slice_capable(self) -> bool:
        return self._mig_capable

    def get_slices(self) -> List[Chip]:
        return list(self._slices)

    def get_attributes(self):
        raise ResourceError("get_attributes only supported for slice partitions")

    def get_name(self) -> str:
        return self._name

    def get_total_memory_mb(self) -> int:
        return self._memory_mb

    def get_parent_chip(self) -> Chip:
        raise ResourceError("get_parent_chip only supported for slice partitions")

    def get_generation(self) -> Tuple[int, int]:
        return self._generation

    def get_uuid(self) -> str:
        return self._uuid


def product_name(device_name: str) -> str:
    """"NVIDIA H100 80GB HBM3" → "nvidia-h100-80gb-hbm3"."""
    return label_safe_value(device_name.lower(), fallback="gpu")


def nvml_chip(device: nvml.DeviceInfo) -> CudaChip:
    """A full GPU from NVML's facts alone."""
    return CudaChip(
        product_name(device.name),
        device.memory_mb,
        device.compute_capability,
        nvml_device=device,
    )


class CudaManager(Manager):
    """The GPUs of a node whose CUDA devices torch can use: NVML's
    inventory when NVML loads, else torch's devices. Devices are
    enumerated once on first ``init()`` and held; ``shutdown()`` is free.
    ``nvml_inventory`` keeps what NVML reported (None without NVML)."""

    def __init__(self, nvml_lib=None):
        self._nvml_lib = nvml_lib
        self._chips: List[Chip] = []
        self._initialized = False
        self.nvml_inventory: Optional[nvml.Inventory] = None

    def init(self) -> None:
        if self._initialized:
            return
        import torch

        if not torch.cuda.is_available() or torch.cuda.device_count() == 0:
            raise ResourceError("no CUDA devices visible to torch")
        inventory = self._read_nvml()
        if inventory is not None:
            chips = [nvml_chip(d) for d in inventory.devices]
        else:
            chips = []
            for i in range(torch.cuda.device_count()):
                props = torch.cuda.get_device_properties(i)
                chips.append(CudaChip(product_name(torch.cuda.get_device_name(i)),
                                      props.total_memory // 2**20,
                                      (props.major, props.minor)))
        self._chips = chips
        self.nvml_inventory = inventory
        self._initialized = True

    def _read_nvml(self) -> Optional[nvml.Inventory]:
        try:
            return nvml.read_inventory(self._nvml_lib)
        except ResourceError as e:
            warn_once(log, "nvml-unavailable",
                      "NVML unavailable (%s): torch's devices without MIG "
                      "facts, and no driver labels", e)
            return None

    def shutdown(self) -> None:
        pass

    def get_chips(self) -> List[Chip]:
        return list(self._chips)

    def get_driver_version(self) -> str:
        """The kernel driver's version from NVML ("580.159.03"); "" without
        NVML (lm/versions.py then publishes no driver labels)."""
        if self.nvml_inventory is not None:
            return self.nvml_inventory.driver_version
        return ""

    def get_runtime_version(self) -> Tuple[int, int]:
        """(major, minor) of the CUDA driver API (``cuDriverGetVersion``)."""
        return nvml.cuda_version_tuple(cuda_driver_api_version())


def cuda_driver_api_version() -> int:
    """``cuDriverGetVersion``: 1000*major + 10*minor."""
    try:
        libcuda = ctypes.CDLL("libcuda.so.1")
    except OSError as e:
        raise ResourceError(f"cannot load libcuda.so.1: {e}") from e
    version = ctypes.c_int(0)
    libcuda.cuDriverGetVersion.argtypes = [ctypes.POINTER(ctypes.c_int)]
    libcuda.cuDriverGetVersion.restype = ctypes.c_int
    rc = libcuda.cuDriverGetVersion(ctypes.byref(version))
    if rc != 0:
        raise ResourceError(f"cuDriverGetVersion failed with CUresult {rc}")
    return version.value


def driver_version_string(encoded: int) -> str:
    """12040 → "12.4" (``cuDriverGetVersion`` encodes 1000*major +
    10*minor)."""
    major, minor = nvml.cuda_version_tuple(encoded)
    return f"{major}.{minor}"


class StaticCudaManager(Manager):
    """Deterministic fixture for the ``mock-gpu:<n>`` token; its constants
    are the twin's ``StaticPjrtManager.mock_gpu``."""

    MOCK_DRIVER_VERSION = "1.9.0"
    MOCK_RUNTIME_VERSION = (0, 51)

    def __init__(self, product: str, count: int, memory_mb: int):
        self._initialized = False
        self._chips = [CudaChip(product, memory_mb) for _ in range(count)]

    @classmethod
    def mock_gpu(cls, count: int) -> "StaticCudaManager":
        return cls("mock-gpu", count, memory_mb=16384)

    def init(self) -> None:
        self._initialized = True

    def shutdown(self) -> None:
        pass

    def get_chips(self) -> List[Chip]:
        if not self._initialized:
            return []
        return list(self._chips)

    def get_driver_version(self) -> str:
        return self.MOCK_DRIVER_VERSION

    def get_runtime_version(self) -> Tuple[int, int]:
        return self.MOCK_RUNTIME_VERSION
