"""The MIG strategy engine of the PyTorch port against its JAX twin, on
the CPU.

Every case of the twin's tests/test_topology_strategy.py (the reference's
mig-strategy_test.go matrix): the same inventory (GPU names, memory,
compute capability, MIG profile names and attribute dicts) goes to the
twin's engine over its MockManager and to the port's over the port's
mocks, and the labels must be equal after the label translation:

- keys ``google.com/tpu.`` → ``nvidia.com/gpu.`` and ``google.com/tpu-`` →
  ``nvidia.com/mig-``;
- product infix ``-SLICE-`` → ``-MIG-``;
- the architecture family: the twin names a TPU generation from its
  spec table (compute capability 9.0 is none of them: "undefined"), the
  port names the compute capability ("hopper").
"""

import pytest

from gpu_feature_discovery_tpu.config import new_config as twin_new_config
from gpu_feature_discovery_tpu.config.spec import (
    ReplicatedResource as TwinReplicatedResource,
)
from gpu_feature_discovery_tpu.lm.topology_strategy import (
    new_resource_labeler as twin_new_resource_labeler,
)
from gpu_feature_discovery_tpu.resource import types as twin_types
from gpu_feature_discovery_tpu.resource.testing import MockManager as TwinMockManager
from gpu_feature_discovery_tpu.topology import SliceInfo as TwinSliceInfo
from gpu_feature_discovery_tpu_torch.config.flags import new_config
from gpu_feature_discovery_tpu_torch.config.spec import ReplicatedResource
from gpu_feature_discovery_tpu_torch.lm.topology_strategy import new_resource_labeler
from gpu_feature_discovery_tpu_torch.native.nvml import MigDeviceInfo
from gpu_feature_discovery_tpu_torch.resource.testing import (
    H100_MIG_PROFILES,
    MockChip,
    MockManager,
    SliceSpec,
)
from gpu_feature_discovery_tpu_torch.topology import SliceInfo

H100 = ("nvidia-h100-80gb-hbm3", 81559, (9, 0))
A100 = ("nvidia-a100-sxm4-80gb", 81920, (8, 0))


def mig(profile):
    """A MIG device of the published H100 profile, as NVML reports it."""
    info = MigDeviceInfo(0, *H100_MIG_PROFILES[profile])
    return SliceSpec(info.profile, info.memory_mb, info.attributes())


def gpu(model=H100, slices=(), enabled=None):
    """(model, MIG devices, MIG enabled) — one GPU of an inventory."""
    return (model, tuple(mig(p) for p in slices), enabled)


# -- the twin's engine over the same inventory -------------------------------

class _TwinSlice(twin_types.Chip):
    def __init__(self, spec, parent):
        self._spec, self._parent = spec, parent

    def is_slice_enabled(self):
        raise twin_types.ResourceError("partition")

    def is_slice_capable(self):
        raise twin_types.ResourceError("partition")

    def get_slices(self):
        raise twin_types.ResourceError("partition")

    def get_attributes(self):
        return dict(self._spec.attributes)

    def get_name(self):
        return self._spec.name

    def get_total_memory_mb(self):
        return self._spec.memory_mb

    def get_parent_chip(self):
        return self._parent

    def get_generation(self):
        return self._parent.get_generation()


class _TwinChip(twin_types.Chip):
    def __init__(self, model, slices, enabled):
        (self._name, self._memory, self._gen) = model
        self._slices = [_TwinSlice(s, self) for s in slices]
        self._enabled = bool(slices) if enabled is None else enabled
        self.probes = 0

    def is_slice_enabled(self):
        self.probes += 1
        return self._enabled

    def is_slice_capable(self):
        return True

    def get_slices(self):
        return list(self._slices)

    def get_attributes(self):
        raise twin_types.ResourceError("full chip")

    def get_name(self):
        return self._name

    def get_total_memory_mb(self):
        return self._memory

    def get_parent_chip(self):
        raise twin_types.ResourceError("full chip")

    def get_generation(self):
        return self._gen


def port_chip(model, slices, enabled):
    name, memory, gen = model
    return MockChip(name, memory, gen, slices=slices, slice_enabled=enabled)


def translate(labels):
    out = {}
    for key, value in labels.items():
        key = key.replace("google.com/tpu.", "nvidia.com/gpu.", 1)
        key = key.replace("google.com/tpu-", "nvidia.com/mig-", 1)
        out[key] = value.replace("-SLICE-", "-MIG-")
    return out


def both(gpus, strategy, replicas=None, shared="nvidia.com/gpu"):
    """(port labels, translated twin labels) with the families checked
    and set aside."""
    port_cfg = new_config(cli_values={"tpu-topology-strategy": strategy}, environ={})
    twin_cfg = twin_new_config(cli_values={"tpu-topology-strategy": strategy})
    if replicas:
        port_cfg.sharing.time_slicing.resources.append(
            ReplicatedResource(name=shared, replicas=replicas))
        twin_name = shared.replace("nvidia.com/gpu", "google.com/tpu").replace(
            "nvidia.com/mig-", "google.com/tpu-")
        twin_cfg.sharing.time_slicing.resources.append(
            TwinReplicatedResource(name=twin_name, replicas=replicas))
    got = dict(new_resource_labeler(
        MockManager([port_chip(*g) for g in gpus]), port_cfg).labels())
    want = translate(twin_new_resource_labeler(
        TwinMockManager([_TwinChip(*g) for g in gpus]), twin_cfg).labels())
    for key in [k for k in got if k.endswith(".family")]:
        assert got.pop(key) in ("hopper", "ampere")
        assert want.pop(key) == "undefined"
    return got, want


# Each twin case, on H100 inventories, with the port labels it pins.
CASES = {
    "none_no_chips_empty": ([], "none", None, "nvidia.com/gpu", {}),
    "none_full_chip_labels_only": (
        [gpu()] * 4, "none", None, "nvidia.com/gpu",
        {"nvidia.com/gpu.count": "4", "nvidia.com/gpu.product": H100[0],
         "nvidia.com/gpu.generation.major": "9"}),
    "none_with_sharing": (
        [gpu()] * 4, "none", 2, "nvidia.com/gpu",
        {"nvidia.com/gpu.replicas": "2",
         "nvidia.com/gpu.product": H100[0] + "-SHARED"}),
    "none_slice_bound_chips_published_without_sharing": (
        [gpu(slices=["3g.40gb", "3g.40gb"])] * 4, "none", 2, "nvidia.com/gpu",
        {"nvidia.com/gpu.replicas": "0", "nvidia.com/gpu.product": H100[0]}),
    "none_plain_chip_overrides_slice_bound_same_model": (
        [gpu(slices=["3g.40gb"]), gpu()], "none", 2, "nvidia.com/gpu",
        {"nvidia.com/gpu.count": "2", "nvidia.com/gpu.replicas": "2"}),
    "single_no_slice_chips_behaves_like_none_plus_strategy_label": (
        [gpu()] * 4, "single", None, "nvidia.com/gpu",
        {"nvidia.com/gpu.topology.strategy": "single", "nvidia.com/gpu.count": "4"}),
    "single_valid_uniform_slice_overloads_gpu_resource": (
        [gpu(slices=["3g.40gb", "3g.40gb"])] * 4, "single", None, "nvidia.com/gpu",
        {"nvidia.com/gpu.product": H100[0] + "-MIG-3g.40gb",
         "nvidia.com/gpu.count": "8", "nvidia.com/gpu.memory": "40320",
         "nvidia.com/gpu.multiprocessors": "60", "nvidia.com/gpu.slices.gi": "3"}),
    "single_with_sharing_on_overloaded_resource": (
        [gpu(slices=["1g.10gb"] * 7)] * 2, "single", 3, "nvidia.com/gpu",
        {"nvidia.com/gpu.replicas": "3",
         "nvidia.com/gpu.product": H100[0] + "-MIG-1g.10gb-SHARED"}),
    "single_invalid_empty_slice_bound_chip": (
        [gpu(slices=["3g.40gb"]), gpu(enabled=True)], "single", None,
        "nvidia.com/gpu",
        {"nvidia.com/gpu.product": H100[0] + "-MIG-INVALID",
         "nvidia.com/gpu.count": "0", "nvidia.com/gpu.memory": "0"}),
    "single_invalid_mixed_enable_disable": (
        [gpu(slices=["7g.80gb"]), gpu()], "single", None, "nvidia.com/gpu",
        {"nvidia.com/gpu.product": H100[0] + "-MIG-INVALID"}),
    "single_invalid_multiple_topologies": (
        [gpu(slices=["3g.40gb"]), gpu(slices=["2g.20gb"])], "single", None,
        "nvidia.com/gpu", {"nvidia.com/gpu.product": H100[0] + "-MIG-INVALID"}),
    "single_invalid_still_has_strategy_label": (
        [gpu(enabled=True)], "single", None, "nvidia.com/gpu",
        {"nvidia.com/gpu.topology.strategy": "single",
         "nvidia.com/gpu.product": H100[0] + "-MIG-INVALID"}),
    "mixed_per_topology_resources": (
        [gpu(slices=["3g.40gb"]), gpu(slices=["3g.40gb"]),
         gpu(slices=["1g.10gb", "1g.10gb", "2g.20gb"]), gpu(slices=["7g.80gb"])],
        "mixed", None, "nvidia.com/gpu",
        {"nvidia.com/mig-3g.40gb.count": "2", "nvidia.com/mig-1g.10gb.count": "2",
         "nvidia.com/mig-2g.20gb.count": "1", "nvidia.com/mig-7g.80gb.count": "1",
         "nvidia.com/mig-7g.80gb.product": H100[0] + "-MIG-7g.80gb",
         "nvidia.com/mig-7g.80gb.engines.ofa": "1", "nvidia.com/gpu.count": "4"}),
    "mixed_ignores_empty_slice_bound_chips": (
        [gpu(slices=["3g.40gb"]), gpu(enabled=True)], "mixed", None,
        "nvidia.com/gpu",
        {"nvidia.com/mig-3g.40gb.count": "1", "nvidia.com/gpu.product": H100[0]}),
    "mixed_sharing_targets_slice_resource": (
        [gpu(slices=["3g.40gb"])] * 2, "mixed", 2, "nvidia.com/mig-3g.40gb",
        {"nvidia.com/mig-3g.40gb.replicas": "2",
         "nvidia.com/mig-3g.40gb.product": H100[0] + "-MIG-3g.40gb-SHARED",
         "nvidia.com/gpu.replicas": "0"}),
    "mixed_no_slices_at_all_just_strategy_label": (
        [gpu()] * 8, "mixed", None, "nvidia.com/gpu",
        {"nvidia.com/gpu.topology.strategy": "mixed", "nvidia.com/gpu.count": "8"}),
    "mixed_profile_with_a_smaller_compute_instance": (
        [gpu(slices=["1c.3g.40gb", "3g.40gb"])], "mixed", None, "nvidia.com/gpu",
        {"nvidia.com/mig-1c.3g.40gb.slices.ci": "1",
         "nvidia.com/mig-3g.40gb.slices.ci": "3"}),
    "multiple_models_warns_and_labels_both": (
        [gpu(), gpu(model=A100)], "none", None, "nvidia.com/gpu",
        {"nvidia.com/gpu.count": "1"}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_strategy_labels_match_twin(case, caplog):
    gpus, strategy, replicas, shared, pinned = CASES[case]
    with caplog.at_level("WARNING", logger="tfd.lm"):
        got, want = both(gpus, strategy, replicas, shared)
    assert got == want
    for key, value in pinned.items():
        assert got.get(key) == value, key
    if strategy == "none":
        assert "nvidia.com/gpu.topology.strategy" not in got
    if case.startswith("multiple_models"):
        assert any("Multiple GPU models" in r.message for r in caplog.records)
    if "INVALID" in str(pinned):
        assert any("Invalid configuration" in r.message for r in caplog.records)


def test_slice_info_invalidates_when_chip_list_changes():
    """The grouping follows the manager's CURRENT list, like the twin's."""
    for info_cls, manager in ((SliceInfo, MockManager([port_chip(*gpu())] * 2)),
                              (TwinSliceInfo, TwinMockManager([_TwinChip(*gpu())] * 2))):
        info = info_cls(manager)
        assert len(info.get_chips_with_slices_disabled()) == 2
        manager._chips = manager._chips[:1]
        assert len(info.get_chips_with_slices_disabled()) == 1
        chip = (port_chip if info_cls is SliceInfo else _TwinChip)(
            *gpu(slices=["3g.40gb"]))
        manager._chips = [chip] * 4
        assert len(info.get_chips_with_slices_enabled()) == 4
        assert len(info.get_all_slices()) == 4


def test_slice_info_same_list_probes_each_chip_once():
    port = [port_chip(*gpu()) for _ in range(3)]
    twin = [_TwinChip(*gpu()) for _ in range(3)]
    for info in (SliceInfo(MockManager(port)), TwinSliceInfo(TwinMockManager(twin))):
        info.get_chips_map()
        info.get_chips_with_slices_enabled()
        assert info.any_slice_enabled_chip_is_empty()
    assert [c.calls["is_slice_enabled"] for c in port] == [c.probes for c in twin] \
        == [1, 1, 1]
