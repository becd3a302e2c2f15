"""Device-backed label sources (twin: ``gpu_feature_discovery_tpu/lm/tpu.py``).

The sources in the twin's merge order: machine-type (the DMI product
name), device (versions, slice capability and the MIG strategy's
resources) and health (the burn-in). Device and health publish behind
the gpu family's namespace guard (lm/pjrt_family.py). Machine-type is one
read of a static file and device is in-memory math against the
initialised backend, so both run inline; the health source does device
I/O (acquisition and the burn-in probe) only with ``--with-burnin``, and
is offloaded to the engine's pool then (lm/engine.py). Under the
persistent broker the health source carries ``cancel=broker.kill_child``:
a deadline miss SIGKILLs the worker running the probe instead of leaving
a thread wedged in native code.
"""

from __future__ import annotations

from typing import List

from gpu_feature_discovery_tpu_torch.config.spec import Config
from gpu_feature_discovery_tpu_torch.lm.engine import LabelSource
from gpu_feature_discovery_tpu_torch.lm.health import new_health_labeler
from gpu_feature_discovery_tpu_torch.lm.labeler import Merge
from gpu_feature_discovery_tpu_torch.lm.labels import Labels
from gpu_feature_discovery_tpu_torch.lm.machine_type import new_machine_type_labeler
from gpu_feature_discovery_tpu_torch.lm.pjrt_family import family_guard
from gpu_feature_discovery_tpu_torch.lm.topology_strategy import new_resource_labeler
from gpu_feature_discovery_tpu_torch.lm.versions import (
    new_slice_capability_labeler,
    new_version_labeler,
)
from gpu_feature_discovery_tpu_torch.resource.types import Manager
from gpu_feature_discovery_tpu_torch.utils.timing import timed


def _device_labels(manager: Manager, config: Config) -> Labels:
    """The manager-backed label families (versions, slice capability,
    resources) as one source: they share the held backend."""
    with timed("gpu.versions"):
        versions = new_version_labeler(manager)
    with timed("gpu.slice_capability"):
        slice_capability = new_slice_capability_labeler(manager)
    with timed("gpu.resources"):
        resources = new_resource_labeler(manager, config)
    return Merge(versions, slice_capability, resources).labels()


def gpu_label_sources(manager: Manager, config: Config) -> List[LabelSource]:
    """The device-backed sources in merge order (machine-type, device,
    health), gated on devices being present: a node without GPUs
    publishes none of them. The caller owns the manager lifecycle: init()
    before, shutdown() after the sources have run."""
    if not manager.get_chips():
        return []
    machine_type_file = config.flags.tfd.machine_type_file
    broker = getattr(manager, "broker", None)
    health_cancel = (
        broker.kill_child
        if broker is not None and config.flags.tfd.with_burnin
        else None
    )
    return [
        LabelSource(
            "machine-type",
            lambda: new_machine_type_labeler(machine_type_file),
            offload=False,
        ),
        LabelSource(
            "device",
            lambda: family_guard("gpu", _device_labels(manager, config)),
            offload=False,
        ),
        LabelSource(
            "health",
            lambda: family_guard("gpu", new_health_labeler(manager, config).labels()),
            offload=bool(config.flags.tfd.with_burnin),
            cancel=health_cancel,
        ),
    ]
