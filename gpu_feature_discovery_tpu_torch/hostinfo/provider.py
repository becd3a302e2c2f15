"""HostInfo providers (twin:
``gpu_feature_discovery_tpu/hostinfo/provider.py``).

The twin chains the environment with the GCE metadata server's
``tpu-env`` attribute. A GPU node has no such attribute, so the port's
provider is the environment alone (``EnvMetadataProvider``), blanked by
``TFD_HERMETIC`` as the twin blanks its own, so a hermetic run sees no
host facts. ``StaticProvider`` is the fixture for tests.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

from gpu_feature_discovery_tpu_torch.hostinfo.gpu_env import HostInfo, host_info_from_mapping


class EnvMetadataProvider:
    """The host's environment variables (WORKER_ID and its siblings)."""

    def __init__(self, environ: Optional[Dict[str, str]] = None):
        self._environ = dict(environ if environ is not None else os.environ)

    def host_info(self) -> Optional[HostInfo]:
        info = host_info_from_mapping(self._environ)
        if not (info.accelerator_type or info.topology or info.worker_id is not None):
            return None
        return info


class StaticProvider:
    """A fixed HostInfo (tests)."""

    def __init__(self, info: Optional[HostInfo]):
        self._info = info

    def host_info(self) -> Optional[HostInfo]:
        return self._info


def new_host_info_provider() -> EnvMetadataProvider:
    """The daemon's provider: this process's environment, or an empty one
    under ``TFD_HERMETIC`` (raises ConfigError on a value that is not a
    boolean, as every env toggle does)."""
    from gpu_feature_discovery_tpu_torch.config.flags import env_flag

    return EnvMetadataProvider({} if env_flag("TFD_HERMETIC") else None)
