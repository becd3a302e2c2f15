"""models (twin: ``gpu_feature_discovery_tpu/models/``). The twin's
``AcceleratorType``/``parse_accelerator_type`` parse TPU accelerator
types and have no counterpart."""

from gpu_feature_discovery_tpu_torch.models.chips import (
    CHIP_SPECS,
    ChipSpec,
    family_for_generation,
    spec_for,
)

__all__ = ["ChipSpec", "CHIP_SPECS", "spec_for", "family_for_generation"]
