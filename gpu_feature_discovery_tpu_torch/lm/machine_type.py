"""Machine-type labeler (twin: ``gpu_feature_discovery_tpu/lm/machine_type.py``).

Reference: internal/lm/machine-type.go:30-51: read the DMI product name
(``/sys/class/dmi/id/product_name`` by default, ``--machine-type-file``),
make it label-safe, warn once and publish "unknown" on failure; never
fail the pass.
"""

from __future__ import annotations

import logging

from gpu_feature_discovery_tpu_torch.lm.labels import Labels, label_safe_value
from gpu_feature_discovery_tpu_torch.utils.logging import warn_once

log = logging.getLogger("tfd.lm")

MACHINE_TYPE_UNKNOWN = "unknown"
MACHINE_TYPE_LABEL = "nvidia.com/gpu.machine"


def new_machine_type_labeler(machine_type_path: str) -> Labels:
    try:
        machine_type = _get_machine_type(machine_type_path)
    except (OSError, UnicodeDecodeError) as e:
        # A missing DMI file is stable across cycles: once per epoch.
        warn_once(
            log,
            f"machine-type:{machine_type_path}",
            "error getting machine type from %s: %s",
            machine_type_path,
            e,
        )
        machine_type = MACHINE_TYPE_UNKNOWN
    return Labels(
        {MACHINE_TYPE_LABEL: label_safe_value(machine_type, MACHINE_TYPE_UNKNOWN)}
    )


def _get_machine_type(path: str) -> str:
    if not path:
        return MACHINE_TYPE_UNKNOWN
    with open(path) as f:
        return f.read().strip()
