"""The cpu label family's managers (twin: the cpu half of
``gpu_feature_discovery_tpu/resource/pjrt_backend.py``: ``PjrtManager``
for platform ``cpu`` and ``StaticPjrtManager.mock_cpu``).

``CpuManager`` is the host as one device of product ``cpu``, the way the
twin's PJRT cpu client enumerates it. Its driver version is the installed
torch distribution's version (the twin takes jaxlib's) and its runtime
version that version's (major, minor), both read with
``importlib.metadata``: the cpu family's broker worker never imports
torch, so it maps neither ``libcuda.so`` nor ``libnvidia-ml.so``. A local
version label (``2.11.0+cu128``) is dropped: it is not a version
component. No memory is reported, so the family publishes no memory
label, as the twin's cpu client reports none.

``StaticCpuManager`` is the ``mock-cpu[:<n>]`` fixture, with the twin's
constant versions.
"""

from __future__ import annotations

import importlib.metadata
import re
from typing import List, Tuple

from gpu_feature_discovery_tpu_torch.resource.types import Chip, Manager, ResourceError


class CpuChip(Chip):
    """One host device: no partitions, no generation."""

    def __init__(self, name: str, memory_mb: int = 0):
        self._name = name
        self._memory_mb = memory_mb

    def is_slice_enabled(self) -> bool:
        return False

    def is_slice_capable(self) -> bool:
        return False

    def get_slices(self) -> List[Chip]:
        return []

    def get_attributes(self):
        raise ResourceError("get_attributes only supported for slice partitions")

    def get_name(self) -> str:
        return self._name

    def get_total_memory_mb(self) -> int:
        return self._memory_mb

    def get_parent_chip(self) -> Chip:
        raise ResourceError("get_parent_chip only supported for slice partitions")

    def get_generation(self) -> Tuple[int, int]:
        return (0, 0)


def torch_version() -> str:
    """The installed torch distribution's public version ("2.11.0+cu128" →
    "2.11.0"), without importing torch; ResourceError when it is not
    installed."""
    try:
        version = importlib.metadata.version("torch")
    except importlib.metadata.PackageNotFoundError as e:
        raise ResourceError(f"cannot determine the torch distribution's version: {e}") from e
    return version.split("+", 1)[0]


class CpuManager(Manager):
    """The host's cpu as one device of product ``cpu``."""

    def __init__(self):
        self._chips: List[Chip] = []

    def init(self) -> None:
        if not self._chips:
            self._chips = [CpuChip("cpu")]

    def shutdown(self) -> None:
        pass

    def get_chips(self) -> List[Chip]:
        return list(self._chips)

    def get_driver_version(self) -> str:
        return torch_version()

    def get_runtime_version(self) -> Tuple[int, int]:
        version = torch_version()
        m = re.match(r"(\d+)\.(\d+)", version)
        if m is None:
            raise ResourceError(f"cannot parse the torch version {version!r}")
        return (int(m.group(1)), int(m.group(2)))


class StaticCpuManager(Manager):
    """Deterministic fixture for ``mock-cpu[:<n>]``; its constants are the
    twin's ``StaticPjrtManager.mock_cpu``."""

    MOCK_DRIVER_VERSION = "1.9.0"
    MOCK_RUNTIME_VERSION = (0, 51)

    def __init__(self, product: str, count: int):
        self._initialized = False
        self._chips = [CpuChip(product) for _ in range(count)]

    @classmethod
    def mock_cpu(cls, count: int) -> "StaticCpuManager":
        return cls("mock-cpu", count)

    def init(self) -> None:
        self._initialized = True

    def shutdown(self) -> None:
        pass

    def get_chips(self) -> List[Chip]:
        return list(self._chips) if self._initialized else []

    def get_driver_version(self) -> str:
        return self.MOCK_DRIVER_VERSION

    def get_runtime_version(self) -> Tuple[int, int]:
        return self.MOCK_RUNTIME_VERSION
