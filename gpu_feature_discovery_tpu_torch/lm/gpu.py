"""Device-backed label sources (twin: ``gpu_feature_discovery_tpu/lm/tpu.py``
with ``lm/pjrt_family.py``'s gpu family).

On this port the accelerator family is gpu, so the health source (which
the twin hangs off its tpu family) joins the gpu family's device source:
both publish under ``nvidia.com/gpu.``, behind the family's namespace
guard. The device source is in-memory math against the initialized
backend and runs inline; the health source does device I/O (acquisition
and the burn-in probe) only with ``--with-burnin``, and is offloaded to
the engine's pool then (lm/engine.py). Under the persistent broker the
health source carries ``cancel=broker.kill_child``: a deadline miss
SIGKILLs the worker running the probe instead of leaving a thread wedged
in native code.
"""

from __future__ import annotations

from typing import List

from gpu_feature_discovery_tpu_torch.config.spec import Config
from gpu_feature_discovery_tpu_torch.lm.engine import LabelSource
from gpu_feature_discovery_tpu_torch.lm.health import new_health_labeler
from gpu_feature_discovery_tpu_torch.lm.pjrt_family import (
    _family_device_labels,
    family_guard,
)
from gpu_feature_discovery_tpu_torch.resource.types import Manager


def gpu_label_sources(manager: Manager, config: Config) -> List[LabelSource]:
    """The device-backed sources in merge order (device, health), gated on
    devices being present. The caller owns the manager lifecycle: init()
    before, shutdown() after the sources have run."""
    if not manager.get_chips():
        return []
    broker = getattr(manager, "broker", None)
    health_cancel = (
        broker.kill_child
        if broker is not None and config.flags.tfd.with_burnin
        else None
    )
    return [
        LabelSource(
            "device",
            lambda: family_guard("gpu", _family_device_labels(manager, "gpu")),
            offload=False,
        ),
        LabelSource(
            "health",
            lambda: family_guard("gpu", new_health_labeler(manager, config).labels()),
            offload=bool(config.flags.tfd.with_burnin),
            cancel=health_cancel,
        ),
    ]
