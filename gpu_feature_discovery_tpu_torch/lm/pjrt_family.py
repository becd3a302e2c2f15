"""Per-family label tables, the namespace guard and the cpu family's
sources (twin: ``gpu_feature_discovery_tpu/lm/pjrt_family.py``).

Each backend family owns a disjoint key namespace:

    gpu   nvidia.com/gpu.*, nvidia.com/mig-*   (the classic device list,
                                                the twin's tpu family)
    cpu   node.features/cpu.*

``family_guard`` drops (with a once-per-key warning) every label a source
emits outside its family's namespace; with the registry's one token per
family (resource/registry.py) this makes cross-family collisions
impossible. The gpu family's sources are lm/gpu.py's; the cpu family's
are here: product, count, replicas (and memory, when reported) off the
Manager seam plus the driver and runtime version facts. While a family's
backend cannot init, only that family carries its degraded marker; the
others keep publishing fresh.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Tuple

from gpu_feature_discovery_tpu_torch.config.spec import Config
from gpu_feature_discovery_tpu_torch.lm.engine import LabelSource
from gpu_feature_discovery_tpu_torch.lm.labels import Labels
from gpu_feature_discovery_tpu_torch.lm.resource_labeler import ResourceLabeler
from gpu_feature_discovery_tpu_torch.resource.types import Manager
from gpu_feature_discovery_tpu_torch.utils.logging import warn_once

log = logging.getLogger("tfd.lm")

# Extended-resource name each family labels under.
FAMILY_RESOURCES: Dict[str, str] = {
    "gpu": "nvidia.com/gpu",
    "cpu": "node.features/cpu",
}

# Key namespaces a family may emit into (the guard's allowlist). The gpu
# family's MIG resources of the mixed strategy are nvidia.com/mig-*.
FAMILY_NAMESPACES: Dict[str, Tuple[str, ...]] = {
    "gpu": ("nvidia.com/gpu.", "nvidia.com/mig-"),
    "cpu": ("node.features/cpu.",),
}

# Published while the named family's backend cannot init. The gpu entry
# is the supervisor's DEGRADED_LABEL (cmd/supervisor.py).
FAMILY_DEGRADED_LABELS: Dict[str, str] = {
    "gpu": "nvidia.com/gpu.tfd.degraded",
    "cpu": "node.features/cpu.tfd.degraded",
}

# The device-carrying key per family: the supervisor persists last-good
# state only for sets that inventory at least one device family.
FAMILY_COUNT_KEYS: Dict[str, str] = {
    "gpu": "nvidia.com/gpu.count",
    "cpu": "node.features/cpu.count",
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


def _family_device_labels(manager: Manager, family: str, config: Config) -> Labels:
    """The family's device labels off the initialised Manager: version
    facts, then product, count, replicas and memory."""
    from gpu_feature_discovery_tpu_torch.lm.versions import version_labels_for

    resource = FAMILY_RESOURCES[family]
    chips = manager.get_chips()
    if not chips:
        return Labels()
    labels = version_labels_for(manager, resource)
    names = sorted({c.get_name() for c in chips})
    if len(names) > 1:
        log.warning("Multiple %s device models detected: %s", family, names)
    rl = ResourceLabeler(resource, config.sharing)
    labels.update(rl.base_labels(len(chips), chips[0].get_name()))
    memory_mb = chips[0].get_total_memory_mb()
    if memory_mb:
        labels.update(rl.single("memory", memory_mb))
    return labels


def pjrt_family_sources(manager: Manager, family: str, config: Config) -> List[LabelSource]:
    """The family's label sources, gated on devices (none → nothing
    published). Calls ``manager.init()`` (idempotent: the acquisition ran
    it) so the group keeps the init-before-sources contract."""
    manager.init()
    if not manager.get_chips():
        return []
    return [
        # In-memory math against the held backend: inline.
        LabelSource(
            f"device@{family}",
            lambda: family_guard(family, _family_device_labels(manager, family, config)),
            offload=False,
            group=family,
        ),
    ]
