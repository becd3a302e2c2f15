"""MIG partition device (twin:
``gpu_feature_discovery_tpu/resource/slice_partition.py``).

The reference's nvml-mig-device (internal/resource/nvml-mig-device.go):
one MIG device of a MIG-enabled GPU, named by its profile
(``[<ci>c.]<gi>g.<gb>gb``) and described by the attribute family NVML's
``nvmlDeviceGetAttributes_v2`` reports for it. It keeps the twin's
asymmetry: the attribute and parent methods work, the full-GPU methods
raise.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from gpu_feature_discovery_tpu_torch.native.nvml import MigDeviceInfo
from gpu_feature_discovery_tpu_torch.resource.types import Chip, ResourceError


class MigPartition(Chip):
    """One MIG device attached to its parent GPU."""

    def __init__(self, info: MigDeviceInfo, parent: Chip):
        self._info = info
        self._parent = parent

    def is_slice_enabled(self) -> bool:
        raise ResourceError("is_slice_enabled not supported for slice partitions")

    def is_slice_capable(self) -> bool:
        raise ResourceError("is_slice_capable not supported for slice partitions")

    def get_slices(self) -> List[Chip]:
        raise ResourceError("get_slices not supported for slice partitions")

    def get_attributes(self) -> Dict[str, object]:
        return dict(self._info.attributes())

    def get_name(self) -> str:
        return self._info.profile

    def get_total_memory_mb(self) -> int:
        return self._info.memory_mb

    def get_parent_chip(self) -> Chip:
        return self._parent

    def get_generation(self) -> Tuple[int, int]:
        return self._parent.get_generation()
