"""The twin's resource-abstraction tier (``tests/test_resource.py``) held
against the port: the null manager, the fallback decorator (the
reference's fallback_test.go), the mocks of ``resource/testing.py`` and the
slice grouping of ``topology/slice_info.py`` (the reference's
internal/mig). The twin builds TPU nodes (``new_single_host_manager("v4-8")``,
slice topologies); the port builds the same shapes from MIG devices: four
GPUs, MIG capable, each with or without MIG devices. Each case runs both
and wants the same counts, verdicts and call records."""

import pytest

from gpu_feature_discovery_tpu.resource import FallbackToNullOnInitError as TwinFallback
from gpu_feature_discovery_tpu.resource import NullManager as TwinNull
from gpu_feature_discovery_tpu.resource import ResourceError as TwinResourceError
from gpu_feature_discovery_tpu.resource import testing as twin_testing
from gpu_feature_discovery_tpu.topology import SliceInfo as TwinSliceInfo
from gpu_feature_discovery_tpu_torch.resource import (
    FallbackToNullOnInitError,
    NullManager,
    ResourceError,
)
from gpu_feature_discovery_tpu_torch.resource.testing import (
    H100_MIG_PROFILES,
    MockChip,
    MockManager,
    SliceSpec,
)
from gpu_feature_discovery_tpu_torch.topology import SliceInfo


def _mig(profile):
    sms, ce, dec, enc, jpg, ofa, gi, ci, mem = H100_MIG_PROFILES[profile]
    return SliceSpec(profile, mem, {"multiprocessors": sms, "slices.gi": gi,
                                    "slices.ci": ci, "memory": mem})


def single_host_manager():
    """The twin's ``new_single_host_manager("v4-8")``: four chips, slice
    capable, none partitioned."""
    return MockManager(chips=[MockChip(name="nvidia-h100") for _ in range(4)])


def uniform_mig_manager():
    """The twin's ``new_uniform_slice_manager("v4-8")``: every chip
    partitioned the same way."""
    return MockManager(chips=[MockChip(slices=[_mig("3g.40gb"), _mig("3g.40gb")])
                              for _ in range(4)])


def mixed_mig_manager():
    """The twin's ``new_mixed_slice_manager("v5e")``: two shapes."""
    return MockManager(chips=[MockChip(slices=[_mig("2g.20gb"), _mig("3g.40gb")])
                              for _ in range(2)])


def test_null_manager_has_no_chips_and_errors_on_versions():
    for null, error in ((TwinNull(), TwinResourceError), (NullManager(), ResourceError)):
        null.init()
        assert null.get_chips() == []
        with pytest.raises(error):
            null.get_driver_version()
        with pytest.raises(error):
            null.get_runtime_version()
        null.shutdown()


def test_fallback_swallows_init_error_and_switches_to_null():
    twin = TwinFallback(twin_testing.MockManager(
        chips=[twin_testing.MockChip()], init_error=TwinResourceError("libtpu held busy")))
    port = FallbackToNullOnInitError(MockManager(
        chips=[MockChip()], init_error=ResourceError("CUDA held busy")))
    for m, error in ((twin, TwinResourceError), (port, ResourceError)):
        m.init()
        assert m.get_chips() == []
        with pytest.raises(error):
            m.get_driver_version()


def test_fallback_passes_through_on_success():
    twin = TwinFallback(twin_testing.MockManager(chips=[twin_testing.MockChip()]))
    port = FallbackToNullOnInitError(MockManager(chips=[MockChip()]))
    for m in (twin, port):
        m.init()
    assert len(port.get_chips()) == len(twin.get_chips()) == 1
    assert port.get_driver_version() == twin.get_driver_version() == "1.9.0"
    assert port.get_runtime_version() == twin.get_runtime_version() == (0, 51)


def test_full_chip_rejects_slice_only_methods():
    for chip, error in ((twin_testing.MockChip(family="v5p"), TwinResourceError),
                        (MockChip(), ResourceError)):
        with pytest.raises(error):
            chip.get_attributes()
        with pytest.raises(error):
            chip.get_parent_chip()


def test_slice_device_shape():
    """A MIG device carries the profile's own attributes (the label rule's
    MIG table: the twin's slice attributes become the device's SMs and
    instance slices, its memory the profile's)."""
    chip = MockChip(slices=[_mig("3g.40gb")])
    [sl] = chip.get_slices()
    assert sl.get_name() == "3g.40gb"
    assert sl.get_parent_chip() is chip
    assert sl.get_attributes() == {"multiprocessors": 60, "slices.gi": 3,
                                   "slices.ci": 3, "memory": 40320}
    assert sl.get_total_memory_mb() == 40320
    with pytest.raises(ResourceError):
        sl.get_slices()
    twin_chip = twin_testing.MockChip(family="v5p", slice_topologies=["2x2x1"])
    [twin_sl] = twin_chip.get_slices()
    assert twin_sl.get_parent_chip() is twin_chip
    with pytest.raises(TwinResourceError):
        twin_sl.get_slices()


def test_single_host_builder_matches_the_twins_shape():
    twin = twin_testing.new_single_host_manager("v4-8").get_chips()
    port = single_host_manager().get_chips()
    assert len(port) == len(twin) == 4
    for chips in (twin, port):
        assert all(not c.is_slice_enabled() for c in chips)
        assert all(c.is_slice_capable() for c in chips)


def test_slice_info_grouping_memoizes_probes():
    for manager, info_cls in ((twin_testing.new_uniform_slice_manager("v4-8"), TwinSliceInfo),
                              (uniform_mig_manager(), SliceInfo)):
        info = info_cls(manager)
        assert len(info.get_chips_with_slices_enabled()) == 4
        assert info.get_chips_with_slices_disabled() == []
        info.get_chips_map()
        assert all(c.calls["is_slice_enabled"] == 1 for c in manager.get_chips())


def test_any_slice_enabled_chip_is_empty():
    twin = [
        TwinSliceInfo(twin_testing.new_single_host_manager("v4-8")),
        TwinSliceInfo(twin_testing.new_uniform_slice_manager("v4-8")),
        TwinSliceInfo(twin_testing.MockManager(chips=[
            twin_testing.MockChip(slice_topologies=["2x2x1"]),
            twin_testing.MockChip(slice_enabled=True)])),
    ]
    port = [
        SliceInfo(single_host_manager()),
        SliceInfo(uniform_mig_manager()),
        SliceInfo(MockManager(chips=[MockChip(slices=[_mig("1g.10gb")]),
                                     MockChip(slice_enabled=True)])),
    ]
    verdicts = [[i.any_slice_enabled_chip_is_empty() for i in side] for side in (twin, port)]
    assert verdicts[1] == verdicts[0] == [True, False, True]


def test_get_all_slices_spans_chips():
    twin = sorted(s.get_name() for s in
                  TwinSliceInfo(twin_testing.new_mixed_slice_manager("v5e")).get_all_slices())
    port = sorted(s.get_name() for s in SliceInfo(mixed_mig_manager()).get_all_slices())
    assert twin == ["2x2", "2x2", "2x4", "2x4"]
    assert port == ["2g.20gb", "2g.20gb", "3g.40gb", "3g.40gb"]
