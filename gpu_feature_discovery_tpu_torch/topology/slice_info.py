"""GPUs grouped by MIG mode for the strategy engine (twin:
``gpu_feature_discovery_tpu/topology/slice_info.py``).

The reference's internal/mig package (mig.go:32-124): group the node's
GPUs by whether MIG is enabled, memoized so one label pass reads each
GPU's mode once.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from gpu_feature_discovery_tpu_torch.resource.types import Chip, Manager


class SliceInfo:
    """Per-pass view of the node's GPUs keyed by MIG mode
    (mig.DeviceInfo).

    The grouping memo is keyed by the manager's CURRENT chip list, not
    built-once-per-instance: a broker-backed manager re-enumerates every
    cycle (sandbox/broker.BrokerManager.init refreshes the snapshot), so
    an instance that outlives one label pass — or a pass that races a
    mid-epoch chip-count change — must never serve the previous
    enumeration's grouping. Same-list calls still probe each chip's
    MIG mode exactly once; only a changed list rebuilds."""

    def __init__(self, manager: Manager):
        self._manager = manager
        self._chips_map: Optional[Dict[bool, List[Chip]]] = None
        self._chips_key: Optional[tuple] = None

    def get_chips_map(self) -> Dict[bool, List[Chip]]:
        """Chips grouped by is_slice_enabled(); built on first use and
        invalidated when the manager's chip list changes (mig.go:41-64)."""
        chips = self._manager.get_chips()
        # id() keys cannot alias across invalidations: _chips_map keeps
        # the keyed chips referenced, and CPython never recycles a live
        # object's address — a fresh enumeration can only match the
        # cached key by BEING the cached objects.
        key = tuple(id(c) for c in chips)
        if self._chips_map is None or key != self._chips_key:
            grouped: Dict[bool, List[Chip]] = {True: [], False: []}
            for chip in chips:
                grouped[chip.is_slice_enabled()].append(chip)
            self._chips_map = grouped
            self._chips_key = key
        return self._chips_map

    def get_chips_with_slices_enabled(self) -> List[Chip]:
        return self.get_chips_map()[True]

    def get_chips_with_slices_disabled(self) -> List[Chip]:
        return self.get_chips_map()[False]

    def any_slice_enabled_chip_is_empty(self) -> bool:
        """True when some MIG-enabled GPU exposes no MIG device: an invalid
        configuration under strategy=single (mig.go:85-106; vacuously true
        for the empty set, as in the reference)."""
        enabled = self.get_chips_with_slices_enabled()
        if not enabled:
            return True
        return any(not chip.get_slices() for chip in enabled)

    def get_all_slices(self) -> List[Chip]:
        """Every MIG device across all MIG-enabled GPUs (mig.go:109-124)."""
        slices: List[Chip] = []
        for chip in self.get_chips_with_slices_enabled():
            slices.extend(chip.get_slices())
        return slices
