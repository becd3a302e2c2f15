"""The twin's simple-labeler tier (``tests/test_labelers.py``) held against
the port: versions, slice capability (the reference's mig.capable truth
table), machine type, timestamp, the full-GPU and MIG resource label
families with sharing, and the eager device-backed labeler. Where the
concept is the same (versions, capability, machine type, timestamp, the
label-value sanitiser, the sharing rules) each case feeds the twin and
the port the same input and wants the twin's labels under the label rule
(``google.com/tpu.`` -> ``nvidia.com/gpu.``). The resource families are
translated through ROADMAP.md's MIG table: the twin's TPU spec rows
(``tensorcores``, ``sparsecores``) and slice topology become the
compute capability's family and the MIG device's own attributes."""

import logging
import re

import pytest

from gpu_feature_discovery_tpu.config import new_config as twin_new_config
from gpu_feature_discovery_tpu.config.spec import ReplicatedResource as TwinReplicated
from gpu_feature_discovery_tpu.config.spec import Sharing as TwinSharing
from gpu_feature_discovery_tpu.config.spec import TimeSlicing as TwinTimeSlicing
from gpu_feature_discovery_tpu.lm import labels as twin_labels
from gpu_feature_discovery_tpu.lm import machine_type as twin_machine_type
from gpu_feature_discovery_tpu.lm import resource_labeler as twin_resource
from gpu_feature_discovery_tpu.lm import timestamp as twin_timestamp
from gpu_feature_discovery_tpu.lm import versions as twin_versions
from gpu_feature_discovery_tpu.resource import testing as twin_testing
from gpu_feature_discovery_tpu_torch.config import new_config
from gpu_feature_discovery_tpu_torch.config.spec import ReplicatedResource, Sharing, TimeSlicing
from gpu_feature_discovery_tpu_torch.lm.gpu import new_gpu_labeler
from gpu_feature_discovery_tpu_torch.lm.labels import label_safe_value
from gpu_feature_discovery_tpu_torch.lm.machine_type import new_machine_type_labeler
from gpu_feature_discovery_tpu_torch.lm.resource_labeler import (
    new_chip_resource_labeler,
    new_slice_resource_labeler,
)
from gpu_feature_discovery_tpu_torch.lm.timestamp import new_timestamp_labeler
from gpu_feature_discovery_tpu_torch.lm.versions import (
    new_slice_capability_labeler,
    new_version_labeler,
)
from gpu_feature_discovery_tpu_torch.resource.testing import (
    H100_MIG_PROFILES,
    MockChip,
    MockManager,
    SliceSpec,
)
from gpu_feature_discovery_tpu_torch.utils.logging import reset_warn_once


def _translated(labels):
    return {k.replace("google.com/tpu", "nvidia.com/gpu", 1): v for k, v in dict(labels).items()}


def sharing_with(name="nvidia.com/gpu", replicas=4, rename=""):
    return Sharing(time_slicing=TimeSlicing(
        resources=[ReplicatedResource(name=name, rename=rename, replicas=replicas)]))


def twin_sharing_with(name="google.com/tpu", replicas=4, rename=""):
    return TwinSharing(time_slicing=TwinTimeSlicing(
        resources=[TwinReplicated(name=name, rename=rename, replicas=replicas)]))


def h100(**kw):
    return MockChip(name="NVIDIA H100 80GB HBM3", memory_mb=81559, generation=(9, 0), **kw)


def mig(profile):
    sms, ce, dec, enc, jpg, ofa, gi, ci, mem = H100_MIG_PROFILES[profile]
    return SliceSpec(profile, mem, {"memory": mem, "multiprocessors": sms,
                                    "slices.gi": gi, "slices.ci": ci})


# ---------------------------------------------------------------------------
# versions
# ---------------------------------------------------------------------------

def test_version_labeler_three_part():
    twin = twin_versions.new_version_labeler(twin_testing.MockManager(driver_version="1.9.2"))
    port = new_version_labeler(MockManager(driver_version="1.9.2"))
    assert dict(port) == _translated(twin)
    assert port["nvidia.com/gpu.driver.rev"] == "2"
    assert port["nvidia.com/gpu.runtime.minor"] == "51"


def test_version_labeler_two_part_has_empty_rev():
    twin = twin_versions.new_version_labeler(twin_testing.MockManager(driver_version="2.14"))
    port = new_version_labeler(MockManager(driver_version="2.14"))
    assert dict(port) == _translated(twin)
    assert port["nvidia.com/gpu.driver.rev"] == ""


@pytest.mark.parametrize("bad", ["unknown", "1", "1.2.3.4"])
def test_version_labeler_rejects_malformed(bad):
    with pytest.raises(ValueError, match="does not match format"):
        twin_versions.new_version_labeler(twin_testing.MockManager(driver_version=bad))
    with pytest.raises(ValueError, match="does not match format"):
        new_version_labeler(MockManager(driver_version=bad))


# ---------------------------------------------------------------------------
# slice capability (mig.capable) truth table
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("capable", [(), (False, True), (False,)])
def test_slice_capable_truth_table(capable):
    twin = twin_versions.new_slice_capability_labeler(twin_testing.MockManager(
        chips=[twin_testing.MockChip(slice_capable=c) for c in capable])).labels()
    port = new_slice_capability_labeler(MockManager(
        chips=[MockChip(slice_capable=c) for c in capable])).labels()
    assert dict(port) == _translated(twin)
    want = {} if not capable else {"nvidia.com/gpu.slice.capable": str(any(capable)).lower()}
    assert dict(port) == want


def test_slice_capable_empty_without_chips():
    assert new_slice_capability_labeler(MockManager()).labels() == {}


def test_slice_capable_true_when_any_chip_capable():
    m = MockManager(chips=[MockChip(slice_capable=False), MockChip(slice_capable=True)])
    assert new_slice_capability_labeler(m).labels() == {"nvidia.com/gpu.slice.capable": "true"}


def test_slice_capable_false_when_none_capable():
    m = MockManager(chips=[MockChip(slice_capable=False)])
    assert new_slice_capability_labeler(m).labels() == {"nvidia.com/gpu.slice.capable": "false"}


# ---------------------------------------------------------------------------
# machine type
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dmi,want", [
    ("Google Compute Engine\n", "Google-Compute-Engine"),
    ("ThinkPad X1 (Gen 9) rev/2\n", "ThinkPad-X1--Gen-9--rev-2"),
])
def test_machine_type_reads_and_sanitises(tmp_path, dmi, want):
    f = tmp_path / "product_name"
    f.write_text(dmi)
    port = new_machine_type_labeler(str(f))
    assert dict(port) == _translated(twin_machine_type.new_machine_type_labeler(str(f)))
    (value,) = port.values()
    assert value == want
    assert re.fullmatch(r"[A-Za-z0-9]([A-Za-z0-9_.-]*[A-Za-z0-9])?", value)


@pytest.mark.parametrize("value,fallback", [
    ("ok-1.2_3", None), ("(weird)", None), ("---", None), ("", "fb"),
    ("x" * 100, None), ("x" * 62 + "..", None),
])
def test_label_safe_value_edges(value, fallback):
    kw = {} if fallback is None else {"fallback": fallback}
    got = label_safe_value(value, **kw)
    assert got == twin_labels.label_safe_value(value, **kw)
    assert len(got) <= 63 and not got.endswith(".")


def test_machine_type_unknown_on_missing_file(tmp_path):
    missing = str(tmp_path / "nope")
    assert new_machine_type_labeler(missing) == {"nvidia.com/gpu.machine": "unknown"}
    assert _translated(twin_machine_type.new_machine_type_labeler(missing)) == {
        "nvidia.com/gpu.machine": "unknown"}


def test_machine_type_unknown_on_empty_path():
    assert new_machine_type_labeler("") == {"nvidia.com/gpu.machine": "unknown"}
    assert _translated(twin_machine_type.new_machine_type_labeler("")) == {
        "nvidia.com/gpu.machine": "unknown"}


# ---------------------------------------------------------------------------
# timestamp
# ---------------------------------------------------------------------------

def test_timestamp_label_is_unix_seconds():
    port = new_timestamp_labeler(new_config()).labels()
    twin = twin_timestamp.new_timestamp_labeler(twin_new_config()).labels()
    assert set(port) == set(twin) == {"google.com/tfd.timestamp"}
    assert port["google.com/tfd.timestamp"].isdigit()
    assert abs(int(port["google.com/tfd.timestamp"]) - int(twin["google.com/tfd.timestamp"])) <= 1


def test_timestamp_suppressed():
    assert new_timestamp_labeler(new_config(cli_values={"no-timestamp": True})).labels() == {}
    assert twin_timestamp.new_timestamp_labeler(
        twin_new_config(cli_values={"no-timestamp": True})).labels() == {}


# ---------------------------------------------------------------------------
# full-GPU resource labels
# ---------------------------------------------------------------------------

def test_chip_labels_base_family():
    labels = new_chip_resource_labeler(Sharing(), h100(), 4).labels()
    assert labels == {
        "nvidia.com/gpu.product": "NVIDIA-H100-80GB-HBM3",
        "nvidia.com/gpu.count": "4",
        "nvidia.com/gpu.replicas": "1",
        "nvidia.com/gpu.memory": "81559",
        "nvidia.com/gpu.family": "hopper",
        "nvidia.com/gpu.generation.major": "9",
        "nvidia.com/gpu.generation.minor": "0",
    }
    twin = _translated(twin_resource.new_chip_resource_labeler(
        TwinSharing(), twin_testing.MockChip(family="v4"), 4).labels())
    # The twin's keys less its TPU spec rows (no GPU family has one).
    assert set(labels) == set(twin) - {"nvidia.com/gpu.tensorcores", "nvidia.com/gpu.sparsecores"}


def test_chip_labels_zero_count_is_empty():
    assert new_chip_resource_labeler(Sharing(), h100(), 0).labels() == {}
    assert twin_resource.new_chip_resource_labeler(
        TwinSharing(), twin_testing.MockChip(), 0).labels() == {}


@pytest.mark.parametrize("replicas,rename", [(4, ""), (4, "shared"), (1, "")])
def test_chip_labels_sharing_as_the_twin(replicas, rename):
    port = new_chip_resource_labeler(
        sharing_with(replicas=replicas, rename=rename and "nvidia.com/gpu.shared"),
        MockChip(name="tpu-v4"), 4).labels()
    twin = twin_resource.new_chip_resource_labeler(
        twin_sharing_with(replicas=replicas, rename=rename and "google.com/tpu.shared"),
        twin_testing.MockChip(), 4).labels()
    for suffix in ("product", "replicas", "count"):
        assert port[f"nvidia.com/gpu.{suffix}"] == twin[f"google.com/tpu.{suffix}"]


def test_chip_labels_sharing_replicas_and_shared_suffix():
    labels = new_chip_resource_labeler(sharing_with(replicas=4), h100(), 4).labels()
    assert labels["nvidia.com/gpu.replicas"] == "4"
    assert labels["nvidia.com/gpu.product"] == "NVIDIA-H100-80GB-HBM3-SHARED"


def test_chip_labels_renamed_sharing_keeps_product():
    sharing = sharing_with(replicas=4, rename="nvidia.com/gpu.shared")
    labels = new_chip_resource_labeler(sharing, h100(), 4).labels()
    assert labels["nvidia.com/gpu.product"] == "NVIDIA-H100-80GB-HBM3"
    assert labels["nvidia.com/gpu.replicas"] == "4"


def test_chip_labels_sharing_disabled_zero_replicas():
    labels = new_chip_resource_labeler(None, h100(), 4).labels()
    twin = twin_resource.new_chip_resource_labeler(None, twin_testing.MockChip(), 4).labels()
    assert labels["nvidia.com/gpu.replicas"] == twin["google.com/tpu.replicas"] == "0"
    assert "SHARED" not in labels["nvidia.com/gpu.product"]


def test_chip_labels_product_spaces_dashed():
    labels = new_chip_resource_labeler(Sharing(), MockChip(name="GPU v99 prototype"), 1).labels()
    twin = twin_resource.new_chip_resource_labeler(
        TwinSharing(), twin_testing.MockChip(product="GPU v99 prototype"), 1).labels()
    assert labels["nvidia.com/gpu.product"] == twin["google.com/tpu.product"] == "GPU-v99-prototype"


def test_chip_labels_unknown_generation_family_undefined():
    labels = new_chip_resource_labeler(Sharing(), MockChip(generation=(99, 9)), 1).labels()
    assert labels["nvidia.com/gpu.family"] == "undefined"
    assert labels["nvidia.com/gpu.generation.major"] == "99"


def test_chip_labels_zero_generation_no_arch_labels():
    labels = new_chip_resource_labeler(Sharing(), MockChip(generation=(0, 0)), 1).labels()
    assert "nvidia.com/gpu.family" not in labels
    assert "nvidia.com/gpu.generation.major" not in labels


# ---------------------------------------------------------------------------
# MIG (slice) resource labels
# ---------------------------------------------------------------------------

def test_slice_labels_product_and_attributes():
    chip = h100(slices=[mig("3g.40gb")])
    [sl] = chip.get_slices()
    labels = new_slice_resource_labeler("nvidia.com/gpu", Sharing(), sl, 4).labels()
    assert labels == {
        "nvidia.com/gpu.product": "NVIDIA-H100-80GB-HBM3-MIG-3g.40gb",
        "nvidia.com/gpu.count": "4",
        "nvidia.com/gpu.replicas": "1",
        "nvidia.com/gpu.memory": "40320",
        "nvidia.com/gpu.multiprocessors": "60",
        "nvidia.com/gpu.slices.gi": "3",
        "nvidia.com/gpu.slices.ci": "3",
    }


def test_slice_labels_custom_resource_name():
    chip = h100(slices=[mig("1g.10gb")])
    [sl] = chip.get_slices()
    labels = new_slice_resource_labeler("nvidia.com/mig-1g.10gb", Sharing(), sl, 2).labels()
    assert labels["nvidia.com/mig-1g.10gb.product"] == "NVIDIA-H100-80GB-HBM3-MIG-1g.10gb"
    assert labels["nvidia.com/mig-1g.10gb.count"] == "2"
    assert labels["nvidia.com/mig-1g.10gb.multiprocessors"] == "16"


# ---------------------------------------------------------------------------
# the eager device-backed labeler
# ---------------------------------------------------------------------------

def test_gpu_labeler_empty_without_chips():
    m = MockManager()
    assert new_gpu_labeler(m, new_config()).labels() == {}
    assert m.calls["init"] == 1 and m.calls["shutdown"] == 1


def test_gpu_labeler_shutdown_called_even_on_error():
    m = MockManager(chips=[MockChip()], driver_version="unknown")
    with pytest.raises(ValueError):
        new_gpu_labeler(m, new_config())
    assert m.calls["shutdown"] == 1


def test_gpu_labeler_full_pass(tmp_path):
    f = tmp_path / "machine"
    f.write_text("a3-highgpu-8g")
    config = new_config(cli_values={"machine-type-file": str(f)})
    labels = new_gpu_labeler(MockManager(chips=[h100() for _ in range(4)]), config).labels()
    assert labels["nvidia.com/gpu.machine"] == "a3-highgpu-8g"
    assert labels["nvidia.com/gpu.count"] == "4"
    assert labels["nvidia.com/gpu.slice.capable"] == "true"
    assert labels["nvidia.com/gpu.driver.major"] == "1"


def test_stable_warnings_log_once_per_epoch(tmp_path, caplog):
    missing = str(tmp_path / "no-dmi-here")

    def levels():
        return [r.levelno for r in caplog.records if "machine type" in r.getMessage()]

    reset_warn_once()
    with caplog.at_level(logging.DEBUG, logger="tfd.lm"):
        for _ in range(10):
            labels = new_machine_type_labeler(missing)
    assert labels["nvidia.com/gpu.machine"] == "unknown"
    assert levels().count(logging.WARNING) == 1
    assert levels().count(logging.DEBUG) == 9
    caplog.clear()
    reset_warn_once()
    with caplog.at_level(logging.DEBUG, logger="tfd.lm"):
        new_machine_type_labeler(missing)
    assert levels() == [logging.WARNING]
