"""Fallback-to-null decorator (twin:
``gpu_feature_discovery_tpu/resource/fallback.py``).

Reference: internal/resource/fallback.go:23-64. Under
``--fail-on-init-error=false`` an init failure (no driver, a card held by
another process) swaps in the Null manager: the node publishes no device
labels instead of crash-looping. Oneshot wraps its manager in it; the
supervised daemon does not (its supervisor owns a richer policy:
degraded labels and retries).
"""

from __future__ import annotations

import logging
from typing import List, Tuple

from gpu_feature_discovery_tpu_torch.resource.null import NullManager
from gpu_feature_discovery_tpu_torch.resource.types import Chip, Manager

log = logging.getLogger("tfd.resource")


class FallbackToNullOnInitError(Manager):
    def __init__(self, manager: Manager):
        self._wraps = manager

    def init(self) -> None:
        try:
            self._wraps.init()
        except Exception as e:  # noqa: BLE001 - any backend failure falls back
            log.warning("failed to initialize resource manager: %s", e)
            self._wraps = NullManager()

    def shutdown(self) -> None:
        self._wraps.shutdown()

    def get_chips(self) -> List[Chip]:
        return self._wraps.get_chips()

    def get_driver_version(self) -> str:
        return self._wraps.get_driver_version()

    def get_runtime_version(self) -> Tuple[int, int]:
        return self._wraps.get_runtime_version()
