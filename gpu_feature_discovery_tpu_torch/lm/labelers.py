"""Labeler composition root (twin: ``gpu_feature_discovery_tpu/lm/labelers.py``).

``new_label_sources`` lists every source of one cycle in merge order:
timestamp, the device-backed sources (machine-type, device, health; none
without GPUs), then the host interconnect, which merges last.
``degraded_label_sources`` is its non-device subset, what the daemon can
still publish while the backend will not init: timestamp, the DMI
machine type and the interconnect. Source names and merge order match
the full list's, so the engine's per-source cache carries across
degraded and healthy cycles.

``multi_backend_label_sources`` is the registry cycle's list (``--backends
gpu,cpu``): timestamp, one group per backend in ``--backends`` order, then
the interconnect. The gpu group is exactly the classic device list, so a
gpu-family token reproduces the single-backend output byte for byte; the
cpu group is lm/pjrt_family.py's. The interconnect (and the machine-type
fallback while the gpu backend is down) publishes only when the gpu
family is enabled: a ``--backends cpu`` node carries no
``nvidia.com/gpu.*`` label.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from gpu_feature_discovery_tpu_torch.config.spec import Config
from gpu_feature_discovery_tpu_torch.lm.engine import LabelSource
from gpu_feature_discovery_tpu_torch.lm.gpu import gpu_label_sources
from gpu_feature_discovery_tpu_torch.lm.labeler import Empty, Labeler
from gpu_feature_discovery_tpu_torch.lm.machine_type import new_machine_type_labeler
from gpu_feature_discovery_tpu_torch.resource.types import Manager
from gpu_feature_discovery_tpu_torch.utils.timing import timed


def new_label_sources(
    manager: Manager,
    config: Config,
    timestamp: Optional[Labeler] = None,
    interconnect: Optional[Labeler] = None,
) -> List[LabelSource]:
    """Calls ``manager.init()`` (errors propagate); the caller owns
    ``manager.shutdown()`` after the sources have run."""
    sources = _timestamp_sources(timestamp)
    with timed("gpu.init"):
        manager.init()
    sources.extend(gpu_label_sources(manager, config))
    sources.append(_interconnect_source(interconnect))
    return sources


def multi_backend_label_sources(
    backend_set,
    config: Config,
    timestamp: Optional[Labeler] = None,
    interconnect: Optional[Labeler] = None,
    strict: bool = False,
) -> Tuple[List[LabelSource], List[str]]:
    """(sources, down families) of one registry cycle over a
    ``resource.registry.BackendSet``. One concurrent acquisition pass runs
    first, so a hung family's init overlaps the others'. A backend that
    will not init contributes no device source and its family lands in
    the down list, whose degraded markers the caller publishes while the
    other families stay fresh. ``strict`` (oneshot) raises acquisition
    errors instead."""
    from gpu_feature_discovery_tpu_torch.lm.pjrt_family import pjrt_family_sources

    sources = _timestamp_sources(timestamp)
    down: List[str] = []
    backend_set.acquire_all(strict=strict)
    for rt in backend_set.runtimes:
        manager = rt.manager
        if manager is None:
            down.append(rt.family)
            if rt.family == "gpu":
                # A backend that will not init says nothing about the DMI
                # file: the machine type is lifted out, as in degraded mode.
                sources.append(_machine_type_source(config))
        elif rt.family == "gpu":
            with timed("gpu.init"):
                manager.init()
            sources.extend(gpu_label_sources(manager, config))
        else:
            sources.extend(pjrt_family_sources(manager, rt.family, config))
    if backend_set.has_family("gpu"):
        sources.append(_interconnect_source(interconnect))
    return sources, down


def degraded_label_sources(
    config: Config,
    timestamp: Optional[Labeler] = None,
    interconnect: Optional[Labeler] = None,
) -> List[LabelSource]:
    """The non-device sources; no manager is touched. The machine type
    rides in the device-gated sources of a healthy cycle; a backend that
    will not init says nothing about the DMI file, so it is lifted out
    here."""
    sources = _timestamp_sources(timestamp)
    sources.append(_machine_type_source(config))
    sources.append(_interconnect_source(interconnect))
    return sources


def _machine_type_source(config: Config) -> LabelSource:
    machine_type_file = config.flags.tfd.machine_type_file
    return LabelSource(
        "machine-type",
        lambda: new_machine_type_labeler(machine_type_file),
        offload=False,
    )


def _timestamp_sources(timestamp: Optional[Labeler]) -> List[LabelSource]:
    if timestamp is None:
        return []
    ts = timestamp
    # A clock read: nothing to block on, so inline.
    return [LabelSource("timestamp", lambda: ts, offload=False)]


def _interconnect_source(interconnect: Optional[Labeler]) -> LabelSource:
    ic = interconnect if interconnect is not None else Empty()
    # A sysfs scan: offloaded, like the twin's.
    return LabelSource("interconnect", lambda: ic)
