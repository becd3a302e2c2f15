"""The host's slice facts from its environment (twin:
``gpu_feature_discovery_tpu/hostinfo/``), for the interconnect labeler
(lm/interconnect.py). Only the twin's unprefixed keys are read."""

from gpu_feature_discovery_tpu_torch.hostinfo.gpu_env import HostInfo, host_info_from_mapping
from gpu_feature_discovery_tpu_torch.hostinfo.provider import (
    EnvMetadataProvider,
    StaticProvider,
    new_host_info_provider,
)

__all__ = [
    "HostInfo",
    "host_info_from_mapping",
    "EnvMetadataProvider",
    "StaticProvider",
    "new_host_info_provider",
]
