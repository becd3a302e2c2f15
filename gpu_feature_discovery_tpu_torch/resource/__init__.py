"""resource (twin: ``gpu_feature_discovery_tpu/resource/``)."""

from gpu_feature_discovery_tpu_torch.resource.types import Chip, Manager, ResourceError
from gpu_feature_discovery_tpu_torch.resource.null import NullManager
from gpu_feature_discovery_tpu_torch.resource.fallback import FallbackToNullOnInitError

__all__ = [
    "Chip",
    "Manager",
    "ResourceError",
    "NullManager",
    "FallbackToNullOnInitError",
]
