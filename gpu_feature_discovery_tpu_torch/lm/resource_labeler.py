"""Per-resource label families (twin:
``gpu_feature_discovery_tpu/lm/resource_labeler.py``).

Reference: internal/lm/resource.go — the resourceLabeler helper (:113-226)
and the two resource labeler constructors (:36-111). A "resource" is a
Kubernetes extended-resource name (``nvidia.com/gpu``,
``nvidia.com/mig-3g.40gb``) and its label family is
``<resource>.product/count/replicas/...``.

Sharing semantics are the twin's (resource.go:155-226): a resource listed
under sharing.timeSlicing with replicas > 1 publishes its replica count
and a ``-SHARED`` product suffix unless renamed; a ``None`` sharing config
means sharing is structurally disabled (replicas 0), which is how
MIG-enabled GPUs' full-GPU labels are published
(NewGPUResourceLabelerWithoutSharing, resource.go:29-33).

No GPU family has a spec row of core counts, so the architecture labels
are family and generation only: the twin's ``spec is None`` branch.
"""

from __future__ import annotations

from typing import Dict, Optional

from gpu_feature_discovery_tpu_torch.config.spec import Sharing
from gpu_feature_discovery_tpu_torch.lm.labeler import Empty, Labeler
from gpu_feature_discovery_tpu_torch.lm.labels import Labels
from gpu_feature_discovery_tpu_torch.models.chips import family_for_generation
from gpu_feature_discovery_tpu_torch.resource.types import Chip

FULL_GPU_RESOURCE = "nvidia.com/gpu"
SLICE_PRODUCT_INFIX = "MIG"


class ResourceLabeler:
    """Label-key factory and sharing logic for one resource name
    (resourceLabeler struct, resource.go:113-226)."""

    def __init__(self, resource_name: str, sharing: Optional[Sharing] = None):
        self.resource_name = resource_name
        self.sharing = sharing

    # -- key/value helpers ---------------------------------------------------
    def key(self, suffix: str) -> str:
        return f"{self.resource_name}.{suffix}"

    def single(self, suffix: str, value: object) -> Labels:
        return Labels({self.key(suffix): f"{value}"})

    def labels(self, suffix_values: Dict[str, object]) -> Labels:
        return Labels({self.key(s): f"{v}" for s, v in suffix_values.items()})

    def update_label(self, labels: Labels, suffix: str, value: object) -> None:
        labels[self.key(suffix)] = f"{value}"

    # -- base family ---------------------------------------------------------
    def base_labels(self, count: int, *parts: str) -> Labels:
        out = Labels()
        out.update(self.product_label(*parts))
        out.update(self.single("count", count))
        out.update(self.single("replicas", self._replicas()))
        return out

    def product_label(self, *parts: str) -> Labels:
        stripped = [p.replace(" ", "-") for p in parts if p]
        if not stripped:
            return Labels()
        if self.is_shared() and not self.is_renamed():
            stripped.append("SHARED")
        return self.single("product", "-".join(stripped))

    def _replicas(self) -> int:
        if self.sharing_disabled():
            return 0
        info = self.replication_info()
        if info is not None and info.replicas > 1:
            return info.replicas
        return 1

    # -- sharing state -------------------------------------------------------
    def sharing_disabled(self) -> bool:
        return self.sharing is None

    def replication_info(self):
        if self.sharing is None:
            return None
        return self.sharing.replication_info(self.resource_name)

    def is_shared(self) -> bool:
        info = self.replication_info()
        return info is not None and info.replicas > 1

    def is_renamed(self) -> bool:
        info = self.replication_info()
        return info is not None and bool(info.rename)


def new_chip_resource_labeler(
    sharing: Optional[Sharing], chip: Chip, count: int
) -> Labeler:
    """Full-GPU resource labels (NewGPUResourceLabeler, resource.go:36-73):
    product/count/replicas/memory and the architecture labels."""
    if count == 0:
        return Empty()

    model = chip.get_name()
    memory_mb = chip.get_total_memory_mb()
    rl = ResourceLabeler(FULL_GPU_RESOURCE, sharing)

    labels = rl.base_labels(count, model)
    if memory_mb:
        labels.update(rl.single("memory", memory_mb))
    labels.update(_architecture_labels(rl, chip))
    return labels


def new_slice_resource_labeler(
    resource_name: str, sharing: Optional[Sharing], slice_dev: Chip, count: int
) -> Labeler:
    """MIG resource labels (NewMIGResourceLabeler, resource.go:76-111):
    product is <parent-model>-MIG-<profile>; the attribute family comes
    straight from get_attributes()."""
    if count == 0:
        return Empty()

    parent = slice_dev.get_parent_chip()
    model = parent.get_name()
    profile = slice_dev.get_name()
    rl = ResourceLabeler(resource_name, sharing)

    labels = rl.base_labels(count, model, SLICE_PRODUCT_INFIX, profile)
    labels.update(rl.labels(slice_dev.get_attributes()))
    return labels


def _architecture_labels(rl: ResourceLabeler, chip: Chip) -> Labels:
    """family/generation labels (newArchitectureLabels, resource.go:239-258):
    compute capability major 0 → no labels, an unknown major → family
    "undefined" (getArchFamily's fallthrough)."""
    major, minor = chip.get_generation()
    if major == 0:
        return Labels()
    return rl.labels(
        {
            "family": family_for_generation(major, minor),
            "generation.major": major,
            "generation.minor": minor,
        }
    )
