"""Serializable device snapshot and the Manager that serves it (twin:
``gpu_feature_discovery_tpu/sandbox/snapshot.py``).

A probe child or the broker worker cannot hand live backend objects to
the labeling process (a CUDA device belongs to the process that
initialised it), so the child walks the initialised manager into plain
data, exactly the facts the labelers read through the ``Manager``/
``Chip`` seam (resource/types.py), and ships it as JSON. The parent
builds a ``SnapshotManager`` over it; every labeler runs unchanged, and
``tests/test_torch_sandbox.py`` pins that the labels equal those of the
live manager.

MIG partitions cross the pipe too, as the twin's slice partitions do:
each GPU's ``SliceSnapshot`` list carries a partition's profile name,
memory, attribute family and ``MIG-`` UUID, so the strategy labels of a
brokered daemon equal those of the live manager, the health labeler can
pin a probe worker to each MIG device, and the labeling process never
calls NVML.

JSON rather than pickle: a child killed mid-write leaves a truncated
document, which fails parsing instead of executing bytes.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

from gpu_feature_discovery_tpu_torch.resource.types import Chip, Manager, ResourceError

SNAPSHOT_VERSION = 1


@dataclass
class SliceSnapshot:
    """One MIG partition: name (its profile), the attribute family, the
    whole-partition memory and its UUID."""

    name: str
    memory_mb: int
    generation: Tuple[int, int]
    attributes: Dict[str, object] = field(default_factory=dict)
    uuid: str = ""

    def to_dict(self) -> Dict[str, object]:
        return {
            "name": self.name,
            "memory_mb": self.memory_mb,
            "generation": list(self.generation),
            "attributes": dict(self.attributes),
            "uuid": self.uuid,
        }

    @staticmethod
    def from_dict(d: Dict[str, object]) -> "SliceSnapshot":
        return SliceSnapshot(
            name=str(d["name"]),
            memory_mb=int(d["memory_mb"]),
            generation=tuple(d["generation"]),  # type: ignore[arg-type]
            attributes=dict(d.get("attributes") or {}),
            uuid=str(d.get("uuid") or ""),
        )


@dataclass
class ChipSnapshot:
    """One enumerated GPU as the labelers see it."""

    name: str
    memory_mb: int
    generation: Tuple[int, int]
    slice_capable: bool
    slice_enabled: bool
    slices: List[SliceSnapshot] = field(default_factory=list)
    uuid: str = ""

    def to_dict(self) -> Dict[str, object]:
        return {
            "name": self.name,
            "memory_mb": self.memory_mb,
            "generation": list(self.generation),
            "slice_capable": self.slice_capable,
            "slice_enabled": self.slice_enabled,
            "slices": [s.to_dict() for s in self.slices],
            "uuid": self.uuid,
        }

    @staticmethod
    def from_dict(d: Dict[str, object]) -> "ChipSnapshot":
        return ChipSnapshot(
            name=str(d["name"]),
            memory_mb=int(d["memory_mb"]),
            generation=tuple(d["generation"]),  # type: ignore[arg-type]
            slice_capable=bool(d["slice_capable"]),
            slice_enabled=bool(d["slice_enabled"]),
            slices=[SliceSnapshot.from_dict(s) for s in d.get("slices") or []],
            uuid=str(d.get("uuid") or ""),
        )


@dataclass
class DeviceSnapshot:
    """Everything a labeling pass reads off a Manager, as plain data."""

    driver_version: str
    runtime_version: Tuple[int, int]
    chips: List[ChipSnapshot] = field(default_factory=list)
    version: int = SNAPSHOT_VERSION

    def to_dict(self) -> Dict[str, object]:
        return {
            "version": self.version,
            "driver_version": self.driver_version,
            "runtime_version": list(self.runtime_version),
            "chips": [c.to_dict() for c in self.chips],
        }

    @staticmethod
    def from_dict(d: Dict[str, object]) -> "DeviceSnapshot":
        version = int(d.get("version", 0))
        if version != SNAPSHOT_VERSION:
            raise ResourceError(
                f"device snapshot version {version} != {SNAPSHOT_VERSION} "
                "(parent and probe child must run the same code)"
            )
        return DeviceSnapshot(
            driver_version=str(d["driver_version"]),
            runtime_version=tuple(d["runtime_version"]),  # type: ignore[arg-type]
            chips=[ChipSnapshot.from_dict(c) for c in d.get("chips") or []],
        )

    @staticmethod
    def from_manager(manager: Manager) -> "DeviceSnapshot":
        """Walk an INITIALISED manager into a snapshot (in the child). No
        devices snapshot to an empty inventory, without the version
        probes, which may need a live device."""
        chips = manager.get_chips()
        if not chips:
            return DeviceSnapshot(driver_version="", runtime_version=(0, 0))
        return DeviceSnapshot(
            driver_version=manager.get_driver_version(),
            runtime_version=tuple(manager.get_runtime_version()),
            chips=[_snapshot_chip(chip) for chip in chips],
        )


def _snapshot_chip(chip: Chip) -> ChipSnapshot:
    slice_enabled = chip.is_slice_enabled()
    slices: List[SliceSnapshot] = []
    if slice_enabled:
        for sl in chip.get_slices():
            slices.append(
                SliceSnapshot(
                    name=sl.get_name(),
                    memory_mb=sl.get_total_memory_mb(),
                    generation=tuple(sl.get_generation()),
                    attributes=dict(sl.get_attributes()),
                    uuid=sl.get_uuid(),
                )
            )
    return ChipSnapshot(
        name=chip.get_name(),
        memory_mb=chip.get_total_memory_mb(),
        generation=tuple(chip.get_generation()),
        slice_capable=chip.is_slice_capable(),
        slice_enabled=slice_enabled,
        slices=slices,
        uuid=chip.get_uuid(),
    )


class SnapshotSlice(Chip):
    """A reconstructed MIG partition: pure data, the MigPartition
    contract (the full-GPU methods raise)."""

    def __init__(self, snap: SliceSnapshot, parent: "SnapshotChip"):
        self._snap = snap
        self._parent = parent

    def is_slice_enabled(self) -> bool:
        raise ResourceError("is_slice_enabled not supported for slice partitions")

    def is_slice_capable(self) -> bool:
        raise ResourceError("is_slice_capable not supported for slice partitions")

    def get_slices(self) -> List[Chip]:
        raise ResourceError("get_slices not supported for slice partitions")

    def get_attributes(self) -> Dict[str, object]:
        return dict(self._snap.attributes)

    def get_name(self) -> str:
        return self._snap.name

    def get_total_memory_mb(self) -> int:
        return self._snap.memory_mb

    def get_parent_chip(self) -> Chip:
        return self._parent

    def get_generation(self) -> Tuple[int, int]:
        return tuple(self._snap.generation)

    def get_uuid(self) -> str:
        return self._snap.uuid


class SnapshotChip(Chip):
    """A reconstructed full GPU."""

    def __init__(self, snap: ChipSnapshot):
        self._snap = snap
        self._slices = [SnapshotSlice(s, self) for s in snap.slices]

    def is_slice_enabled(self) -> bool:
        return self._snap.slice_enabled

    def is_slice_capable(self) -> bool:
        return self._snap.slice_capable

    def get_slices(self) -> List[Chip]:
        return list(self._slices)

    def get_attributes(self) -> Dict[str, object]:
        raise ResourceError("get_attributes only supported for slice partitions")

    def get_name(self) -> str:
        return self._snap.name

    def get_total_memory_mb(self) -> int:
        return self._snap.memory_mb

    def get_parent_chip(self) -> Chip:
        raise ResourceError("get_parent_chip only supported for slice partitions")

    def get_generation(self) -> Tuple[int, int]:
        return tuple(self._snap.generation)

    def get_uuid(self) -> str:
        return self._snap.uuid


class SnapshotManager(Manager):
    """A Manager over a completed probe's snapshot. init() and shutdown()
    are no-ops: the probing already happened, in the child."""

    def __init__(self, snapshot: DeviceSnapshot):
        self._snapshot = snapshot
        self._chips = [SnapshotChip(c) for c in snapshot.chips]

    @property
    def snapshot(self) -> DeviceSnapshot:
        return self._snapshot

    def init(self) -> None:
        pass

    def shutdown(self) -> None:
        pass

    def get_chips(self) -> List[Chip]:
        return list(self._chips)

    def get_driver_version(self) -> str:
        if not self._snapshot.driver_version:
            raise ResourceError("snapshot carries no driver version")
        return self._snapshot.driver_version

    def get_runtime_version(self) -> Tuple[int, int]:
        major, minor = self._snapshot.runtime_version
        return (int(major), int(minor))
