"""NVML-only device manager (twin:
``gpu_feature_discovery_tpu/resource/native_backend.py``).

The twin's native manager enumerates through the PJRT C API when JAX is
unusable; this one enumerates through NVML (native/nvml.py) when torch or
CUDA cannot init. It reads devices, memory, compute capability, MIG
partitions and both versions from NVML alone: it never imports torch and
never creates a CUDA context, so it takes nothing from a workload on the
card. Reached through ``--backends native``, or the autodetect chain under
``--native-enumeration`` (resource/factory.py).

Its labels equal ``CudaManager``'s on the same node: with NVML loaded
that manager builds its chips from the same inventory (``nvml_chip``),
both publish the kernel driver as ``driver``, and the CUDA driver API's
version here (``nvmlSystemGetCudaDriverVersion_v2``) is the number
``cuDriverGetVersion`` gives there, the ``runtime``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from gpu_feature_discovery_tpu_torch.native import nvml
from gpu_feature_discovery_tpu_torch.resource.cuda_backend import nvml_chip
from gpu_feature_discovery_tpu_torch.resource.types import Chip, Manager, ResourceError


class NvmlManager(Manager):
    """GPUs from one NVML inventory read at ``init()``; ``nvml_lib`` is the
    library object (None: the system's ``libnvidia-ml.so.1``)."""

    def __init__(self, nvml_lib=None):
        self._nvml_lib = nvml_lib
        self.nvml_inventory: Optional[nvml.Inventory] = None
        self._chips: List[Chip] = []

    def init(self) -> None:
        if self.nvml_inventory is not None:
            return
        inventory = nvml.read_inventory(self._nvml_lib)
        if not inventory.devices:
            raise ResourceError("NVML enumerated no GPUs")
        self._chips = [nvml_chip(d) for d in inventory.devices]
        self.nvml_inventory = inventory

    def shutdown(self) -> None:
        # Each inventory read already ran nvmlShutdown.
        pass

    def get_chips(self) -> List[Chip]:
        return list(self._chips)

    def get_driver_version(self) -> str:
        if self.nvml_inventory is None:
            raise ResourceError("NVML manager not initialised")
        return self.nvml_inventory.driver_version

    def get_runtime_version(self) -> Tuple[int, int]:
        if self.nvml_inventory is None:
            raise ResourceError("NVML manager not initialised")
        return nvml.cuda_version_tuple(self.nvml_inventory.cuda_driver_version)
