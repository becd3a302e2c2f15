"""Device-backend seam: the Manager/Chip interfaces (twin:
``gpu_feature_discovery_tpu/resource/types.py``).

The label layer (lm/) only sees these two abstractions, never torch or
CUDA types, so backends plug in beneath this line. A "chip" here is one
CUDA device; the slice methods answer the way a non-MIG GPU does.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Dict, List, Tuple


class ResourceError(Exception):
    """Raised by backends for probe failures."""


class Chip(ABC):
    """One device, or one partition when returned by get_slices()."""

    @abstractmethod
    def is_slice_enabled(self) -> bool: ...

    @abstractmethod
    def is_slice_capable(self) -> bool: ...

    @abstractmethod
    def get_slices(self) -> List["Chip"]: ...

    @abstractmethod
    def get_attributes(self) -> Dict[str, object]: ...

    @abstractmethod
    def get_name(self) -> str: ...

    @abstractmethod
    def get_total_memory_mb(self) -> int: ...

    @abstractmethod
    def get_parent_chip(self) -> "Chip": ...

    @abstractmethod
    def get_generation(self) -> Tuple[int, int]: ...

    def get_uuid(self) -> str:
        """The device's UUID: NVML's ``GPU-<hex>`` for a GPU, ``MIG-<hex>``
        for a MIG partition; "" where the backend has none (mocks)."""
        return ""


class Manager(ABC):
    """A device backend."""

    @abstractmethod
    def init(self) -> None: ...

    @abstractmethod
    def shutdown(self) -> None: ...

    @abstractmethod
    def get_chips(self) -> List[Chip]: ...

    @abstractmethod
    def get_driver_version(self) -> str:
        """Driver version string "X.Y[.Z]"."""

    @abstractmethod
    def get_runtime_version(self) -> Tuple[int, int]:
        """Runtime (major, minor)."""
