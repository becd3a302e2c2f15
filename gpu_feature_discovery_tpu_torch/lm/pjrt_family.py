"""The gpu family's namespace guard (twin:
``gpu_feature_discovery_tpu/lm/pjrt_family.py``).

The gpu family owns the ``nvidia.com/gpu.`` namespace, the one the twin
grants it, and ``nvidia.com/mig-``, the MIG resources of the mixed
strategy (the reference's and the NVIDIA device plugin's resource
names). ``family_guard`` drops (with a once-per-key warning) every label
a source emits outside them.
"""

from __future__ import annotations

import logging
from typing import Dict, Tuple

from gpu_feature_discovery_tpu_torch.lm.labels import Labels
from gpu_feature_discovery_tpu_torch.utils.logging import warn_once

log = logging.getLogger("tfd.lm")

FAMILY_NAMESPACES: Dict[str, Tuple[str, ...]] = {
    "gpu": ("nvidia.com/gpu.", "nvidia.com/mig-"),
}


def family_guard(family: str, labels: Labels) -> Labels:
    """Keep only the labels inside the family's own namespace."""
    allowed = FAMILY_NAMESPACES[family]
    out = Labels()
    for key, value in labels.items():
        if key.startswith(allowed):
            out[key] = value
        else:
            warn_once(
                log,
                f"family-collision:{family}:{key}",
                "backend family %r emitted out-of-namespace label %r; "
                "dropped (cross-family key-collision guard)",
                family,
                key,
            )
    return out
