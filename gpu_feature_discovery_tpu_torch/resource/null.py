"""No-op backend for nodes without GPUs (twin:
``gpu_feature_discovery_tpu/resource/null.py``).

Reference: internal/resource/null.go:23-57 — zero devices, version getters
error. The version labeler is only reached when devices exist, so the
Null manager produces an empty device label set rather than bogus
versions.
"""

from __future__ import annotations

from typing import List, Tuple

from gpu_feature_discovery_tpu_torch.resource.types import Chip, Manager, ResourceError


class NullManager(Manager):
    def init(self) -> None:
        pass

    def shutdown(self) -> None:
        pass

    def get_chips(self) -> List[Chip]:
        return []

    def get_driver_version(self) -> str:
        raise ResourceError("cannot get driver version of null resource manager")

    def get_runtime_version(self) -> Tuple[int, int]:
        raise ResourceError("cannot get runtime version of null resource manager")
