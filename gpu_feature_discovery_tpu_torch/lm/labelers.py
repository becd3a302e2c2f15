"""Labeler composition root (twin: ``gpu_feature_discovery_tpu/lm/labelers.py``).

``new_label_sources`` lists every source of one cycle in merge order —
timestamp, device, health — for the label engine (lm/engine.py).
``degraded_label_sources`` is its non-device subset, what the daemon can
still publish while the backend will not init: in this port the
timestamp alone. The twin's degraded set adds the DMI machine type and
the host interconnect, which wait for the host-facts slice. Source names
and merge order match the full list's, so the engine's per-source cache
carries across degraded and healthy cycles.
"""

from __future__ import annotations

from typing import List, Optional

from gpu_feature_discovery_tpu_torch.config.spec import Config
from gpu_feature_discovery_tpu_torch.lm.engine import LabelSource
from gpu_feature_discovery_tpu_torch.lm.gpu import gpu_label_sources
from gpu_feature_discovery_tpu_torch.lm.labeler import Labeler
from gpu_feature_discovery_tpu_torch.resource.types import Manager
from gpu_feature_discovery_tpu_torch.utils.timing import timed


def new_label_sources(
    manager: Manager, config: Config, timestamp: Optional[Labeler] = None
) -> List[LabelSource]:
    """Calls ``manager.init()`` (errors propagate); the caller owns
    ``manager.shutdown()`` after the sources have run."""
    sources = degraded_label_sources(timestamp=timestamp)
    with timed("gpu.init"):
        manager.init()
    sources.extend(gpu_label_sources(manager, config))
    return sources


def degraded_label_sources(timestamp: Optional[Labeler] = None) -> List[LabelSource]:
    """The non-device sources; no manager is touched."""
    sources: List[LabelSource] = []
    if timestamp is not None:
        ts = timestamp
        # A clock read: nothing to block on, so inline.
        sources.append(LabelSource("timestamp", lambda: ts, offload=False))
    return sources
