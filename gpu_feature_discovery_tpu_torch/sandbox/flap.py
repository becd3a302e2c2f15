"""Anti-flap hysteresis for published labels, ``--flap-window`` (twin:
``gpu_feature_discovery_tpu/sandbox/flap.py``).

A backend oscillating across cycles (a device that enumerates every other
init, a marginal probe blinking the health labels) turns into NFD label
churn and scheduler thrash. The damper requires a change to the published
label set to HOLD for ``--flap-window`` consecutive cycles before it goes
out; meanwhile the previous labels are re-served with
``nvidia.com/gpu.tfd.flapping=true``.

The comparison ignores the transient status markers and the timestamp:
they describe the cycle, not the inventory, and flow through
unsuppressed. ``--flap-window=1`` (the default) publishes every cycle
unchanged.
"""

from __future__ import annotations

import logging
from typing import Dict, Optional

from gpu_feature_discovery_tpu_torch.lm.labels import Labels
from gpu_feature_discovery_tpu_torch.obs import metrics as obs_metrics

log = logging.getLogger("tfd.sandbox")

FLAPPING_LABEL = "nvidia.com/gpu.tfd.flapping"

# Excluded from the change comparison; on a suppressed cycle the CURRENT
# cycle's values flow through.
_TRANSIENT_MARKERS = (
    FLAPPING_LABEL,
    "nvidia.com/gpu.tfd.stale-sources",
    "nvidia.com/gpu.tfd.unhealthy-cycles",
    "nvidia.com/gpu.tfd.restored",
    "google.com/tfd.timestamp",
)


def _normalize(labels: Dict[str, str]) -> Dict[str, str]:
    return {k: v for k, v in labels.items() if k not in _TRANSIENT_MARKERS}


class FlapDamper:
    """Per-epoch hysteresis over the composed label set. ``observe``
    takes the labels a cycle wants to publish and returns the labels that
    SHOULD be published."""

    def __init__(self, window: int = 1):
        self.window = max(1, int(window))
        self._published: Optional[Dict[str, str]] = None
        self._pending: Optional[Dict[str, str]] = None
        self._pending_count = 0

    @property
    def suppressing(self) -> bool:
        return self._pending is not None

    def observe(self, labels: Labels) -> Labels:
        candidate = _normalize(labels)
        if self._published is None or self.window <= 1:
            # An epoch's first labels have nothing to flap from.
            self._accept(candidate)
            return labels

        if candidate == self._published:
            if self._pending is not None:
                log.info(
                    "label change reverted before holding %d cycles; "
                    "suppressed flap never published",
                    self.window,
                )
            self._accept(candidate)
            return labels

        if self._pending == candidate:
            self._pending_count += 1
        else:
            self._pending = dict(candidate)
            self._pending_count = 1

        if self._pending_count >= self.window:
            log.info(
                "label change held for %d consecutive cycles; publishing",
                self._pending_count,
            )
            self._accept(candidate)
            return labels

        obs_metrics.FLAP_SUPPRESSED.inc()
        obs_metrics.FLAPPING.set(1)
        log.warning(
            "suppressing label change (%d/%d cycles held); re-serving "
            "previous labels with %s",
            self._pending_count,
            self.window,
            FLAPPING_LABEL,
        )
        served = Labels(self._published)
        for marker in _TRANSIENT_MARKERS:
            if marker in labels and marker != FLAPPING_LABEL:
                served[marker] = labels[marker]
        served[FLAPPING_LABEL] = "true"
        return served

    def _accept(self, candidate: Dict[str, str]) -> None:
        self._published = dict(candidate)
        self._pending = None
        self._pending_count = 0
        obs_metrics.FLAPPING.set(0)
