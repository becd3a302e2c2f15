"""MIG strategy engine (twin: ``gpu_feature_discovery_tpu/lm/topology_strategy.py``).

Reference: internal/lm/mig-strategy.go (all of it). Strategy ``none``
publishes full-GPU labels only; ``single`` expects every GPU of the node
in MIG mode with ONE profile and overloads the ``nvidia.com/gpu.*``
labels with that profile's data; ``mixed`` publishes one resource
``nvidia.com/mig-<profile>.*`` per profile.

The all-or-invalid validation of ``single`` is carried over exactly
(mig-strategy.go:181-241): a MIG-enabled GPU exposing no MIG device, a mix
of MIG-enabled and plain GPUs, or more than one profile on the node each
yield the INVALID label set (product ``<model>-MIG-INVALID``,
count/replicas/memory 0, mig-strategy.go:243-262).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Dict, Optional

from gpu_feature_discovery_tpu_torch.config.spec import (
    Config,
    TOPOLOGY_STRATEGY_MIXED,
    TOPOLOGY_STRATEGY_NONE,
    TOPOLOGY_STRATEGY_SINGLE,
)
from gpu_feature_discovery_tpu_torch.lm.labeler import Empty, Labeler, Merge
from gpu_feature_discovery_tpu_torch.lm.labels import Labels
from gpu_feature_discovery_tpu_torch.lm.resource_labeler import (
    FULL_GPU_RESOURCE,
    ResourceLabeler,
    SLICE_PRODUCT_INFIX,
    new_chip_resource_labeler,
    new_slice_resource_labeler,
)
from gpu_feature_discovery_tpu_torch.resource.types import Chip, Manager
from gpu_feature_discovery_tpu_torch.topology.slice_info import SliceInfo

log = logging.getLogger("tfd.lm")

STRATEGY_LABEL = "nvidia.com/gpu.topology.strategy"
MIXED_RESOURCE_PREFIX = "nvidia.com/mig-"


def new_strategy_labeler(strategy: str) -> Labeler:
    """``topology.strategy`` label; absent under ``none``
    (internal/lm/strategy.go:20-28)."""
    if strategy == TOPOLOGY_STRATEGY_NONE:
        return Empty()
    return Labels({STRATEGY_LABEL: strategy})


@dataclass
class _SliceResource:
    """Tracks one MIG profile while counting (migResource, mig-strategy.go:37-41)."""

    name: str = ""
    device: Optional[Chip] = None
    count: int = 0


def new_resource_labeler(manager: Manager, config: Config) -> Labeler:
    """Top-level dispatch (NewResourceLabeler, mig-strategy.go:45-77):
    full-GPU labels always, MIG labels according to the strategy."""
    chips = manager.get_chips()
    if not chips:
        return Empty()

    # One memoized SliceInfo per labeling pass, shared by the full-GPU
    # and strategy labelers.
    info = SliceInfo(manager)

    strategy = config.flags.tpu_topology_strategy
    full_chip_labels = _new_chip_labelers(info, config)

    if strategy == TOPOLOGY_STRATEGY_NONE:
        return full_chip_labels

    return Merge(full_chip_labels, _new_slice_strategy_labeler(info, config))


def _new_slice_strategy_labeler(info: SliceInfo, config: Config) -> Labeler:
    """Strategy switch (newMigLabeler, mig-strategy.go:82-108)."""
    strategy = config.flags.tpu_topology_strategy
    if strategy == TOPOLOGY_STRATEGY_SINGLE:
        labeler = _new_single_strategy_labeler(info, config)
    elif strategy == TOPOLOGY_STRATEGY_MIXED:
        labeler = _new_mixed_strategy_labeler(info, config)
    else:
        raise ValueError(f"unknown strategy: {strategy}")
    return Merge(new_strategy_labeler(strategy), labeler)


def _new_chip_labelers(info: SliceInfo, config: Config) -> Labeler:
    """Full-GPU labelers grouped by model (newGPULabelers,
    mig-strategy.go:113-179): MIG-enabled GPUs' labels are published
    without sharing info; plain GPUs override same-model entries WITH
    sharing info; counts span both groups; multiple models warn."""
    chips_map = info.get_chips_map()

    if not (chips_map[True] or chips_map[False]):
        raise ValueError("no GPUs detected")

    counts: Dict[str, int] = {}
    slice_bound: Dict[str, Chip] = {}
    for chip in chips_map[True]:
        name = chip.get_name()
        slice_bound[name] = chip
        counts[name] = counts.get(name, 0) + 1

    plain: Dict[str, Chip] = {}
    for chip in chips_map[False]:
        name = chip.get_name()
        plain[name] = chip
        counts[name] = counts.get(name, 0) + 1

    if len(counts) > 1:
        log.warning("Multiple GPU models detected: %s", sorted(counts))

    labelers = []
    for name, chip in slice_bound.items():
        labelers.append(new_chip_resource_labeler(None, chip, counts[name]))
    for name, chip in plain.items():
        labelers.append(new_chip_resource_labeler(config.sharing, chip, counts[name]))

    # Flattened eagerly like the reference (labelers.Labels(),
    # mig-strategy.go:178) so later merges see one label map.
    return Merge(*labelers).labels()


def _new_single_strategy_labeler(info: SliceInfo, config: Config) -> Labeler:
    """strategy=single (newMigStrategySingleLabeler, mig-strategy.go:181-241)."""
    enabled = info.get_chips_with_slices_enabled()

    # No MIG-enabled GPU: equivalent to strategy none.
    if not enabled:
        return Empty()

    problem = info.single_strategy_problem()
    if problem is not None:
        return _new_invalid_strategy_labeler(enabled[0], problem)

    resources = _count_slice_resources(info, lambda profile: FULL_GPU_RESOURCE)
    return _new_slice_device_labelers(resources, config)


def _new_mixed_strategy_labeler(info: SliceInfo, config: Config) -> Labeler:
    """strategy=mixed (newMigStrategyMixedLabeler, mig-strategy.go:264-295):
    MIG-enabled-but-empty GPUs are ignored; each profile becomes its own
    ``nvidia.com/mig-<profile>`` resource."""
    resources = _count_slice_resources(
        info, lambda profile: MIXED_RESOURCE_PREFIX + profile
    )
    return _new_slice_device_labelers(resources, config)


def _count_slice_resources(info: SliceInfo, name_fn) -> Dict[str, _SliceResource]:
    resources: Dict[str, _SliceResource] = {}
    for slice_dev in info.get_all_slices():
        profile = slice_dev.get_name()
        res = resources.setdefault(
            profile, _SliceResource(name=name_fn(profile), device=slice_dev)
        )
        res.count += 1
    return resources


def _new_slice_device_labelers(
    resources: Dict[str, _SliceResource], config: Config
) -> Labeler:
    labelers = [
        new_slice_resource_labeler(res.name, config.sharing, res.device, res.count)
        for res in resources.values()
    ]
    return Merge(*labelers)


def _new_invalid_strategy_labeler(chip: Chip, reason: str) -> Labeler:
    """INVALID label set (newInvalidMigStrategyLabeler,
    mig-strategy.go:243-262)."""
    log.warning("Invalid configuration detected for topology strategy single: %s", reason)
    model = chip.get_name()
    rl = ResourceLabeler(FULL_GPU_RESOURCE, sharing=None)
    labels = rl.product_label(model, SLICE_PRODUCT_INFIX, "INVALID")
    rl.update_label(labels, "count", 0)
    rl.update_label(labels, "replicas", 0)
    rl.update_label(labels, "memory", 0)
    return labels
