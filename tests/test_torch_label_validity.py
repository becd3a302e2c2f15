"""The k8s label grammar over every label the PyTorch port emits.

NFD drops a label whose key or value breaks the k8s grammar without a
word, so an invalid label vanishes from the Node. The goldens pin chosen
scenarios; this sweep holds every label of every mock-nvml layout under
every MIG strategy, of mock-gpu nodes, of the CPU burn-in with per-device
verdicts, of a slice's leader and follower, of actuation advice and its
lease, of a sharing config and of the multi-host keys to the twin's
grammar (tests/test_label_validity.py ``assert_valid_label``), and to
chip_smoke.py's copy of it, which the card's phases apply to every label
they read."""

from pathlib import Path

import pytest

import chip_smoke
from test_label_validity import assert_valid_label
from torch_slice_fixture import PortSliceHarness

from gpu_feature_discovery_tpu_torch.cmd.main import start
from gpu_feature_discovery_tpu_torch.resource.testing import LAYOUTS
from gpu_feature_discovery_tpu_torch.utils import faults

HERE = Path(__file__).parent
GPU = "nvidia.com/gpu."
STRATEGIES = ("none", "single", "mixed")


def assert_every_label_valid(labels, what):
    assert labels, f"{what} emitted nothing"
    for key, value in labels.items():
        assert_valid_label(str(key), str(value))
        assert chip_smoke.label_grammar_error(str(key), str(value)) is None, (key, value)


def _oneshot(tmp_path, *args):
    out = tmp_path / "tfd"
    assert start(["--oneshot", *args, "--output-file", str(out)]) == 0
    return dict(l.split("=", 1) for l in out.read_text().splitlines() if "=" in l)


@pytest.fixture
def hermetic(monkeypatch):
    monkeypatch.setenv("TFD_HERMETIC", "1")
    for key in ("TFD_BACKEND", "TFD_BACKENDS", "TFD_FAULT_SPEC"):
        monkeypatch.delenv(key, raising=False)


@pytest.mark.parametrize("layout,strategy",
                         [(l, s) for l in sorted(LAYOUTS) for s in STRATEGIES])
def test_every_mock_nvml_layout_under_every_strategy(tmp_path, hermetic, layout, strategy):
    labels = _oneshot(tmp_path, "--backends", f"mock-nvml:{layout}",
                      "--tpu-topology-strategy", strategy)
    assert_every_label_valid(labels, f"mock-nvml:{layout}/{strategy}")


@pytest.mark.parametrize("count", [1, 2, 8])
def test_mock_gpu_nodes(tmp_path, hermetic, count):
    labels = _oneshot(tmp_path, "--backends", f"mock-gpu:{count}")
    assert labels[GPU + "count"] == str(count)
    assert_every_label_valid(labels, f"mock-gpu:{count}")


@pytest.mark.parametrize("spec", ["", "chip.1.sick:fail:1"], ids=["healthy", "sick"])
def test_cpu_burnin_with_per_device_labels(tmp_path, hermetic, monkeypatch, spec):
    monkeypatch.setenv("TFD_BURNIN_ALLOW_CPU", "1")
    monkeypatch.setenv("TFD_BURNIN_GEOMETRY", "64x1")
    monkeypatch.setenv("TFD_BURNIN_CPU_DEVICES", "2")
    faults.load_fault_spec(spec)
    try:
        labels = _oneshot(tmp_path, "--backends", "mock-gpu:2", "--with-burnin")
    finally:
        faults.reset()
    assert labels[GPU + "health.ok"] == ("false" if spec else "true")
    assert labels[GPU + "chip.1.ok"] == ("false" if spec else "true")
    assert labels[GPU + "chips.sick"] == ("1" if spec else "0")
    assert_every_label_valid(labels, f"burn-in {spec or 'healthy'}")


MULTIHOST = {
    "slice-worker": {"ACCELERATOR_TYPE": "h100-64", "HOST_BOUNDS": "2,2,2",
                     "CHIPS_PER_HOST_BOUNDS": "2,2,2", "WRAP": "true,true,true",
                     "MACHINE_TYPE": "a3-highgpu-8g", "WORKER_ID": "3",
                     "WORKER_HOSTNAMES": "w0,w1,w2,w3,w4,w5,w6,w7"},
    # Free-form host strings through the interconnect labeler: what
    # label_safe_value exists for.
    "free-form": {"ACCELERATOR_TYPE": "H100 8 (custom build!)",
                  "MACHINE_TYPE": "weird host / name", "TOPOLOGY": "2 x 2?",
                  "CHIPS_PER_HOST_BOUNDS": "2,2,1", "WORKER_ID": "0",
                  "WORKER_HOSTNAMES": "a,b"},
}


@pytest.mark.parametrize("name", sorted(MULTIHOST))
def test_multihost_keys(tmp_path, monkeypatch, name):
    for key in ("TFD_HERMETIC", "TFD_BACKEND", "TFD_BACKENDS"):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("TFD_MOCK_PCI", "1")
    for key, value in MULTIHOST[name].items():
        monkeypatch.setenv(key, value)
    labels = _oneshot(tmp_path, "--backends", "mock-gpu:8")
    assert labels[GPU + "multihost.present"] == "true"
    assert labels[GPU + "multihost.worker-id"] == MULTIHOST[name]["WORKER_ID"]
    assert GPU + "slice.accelerator-type" in labels and GPU + "pci.present" in labels
    assert_every_label_valid(labels, name)


# The shared resource is nvidia.com/gpu: under mixed every GPU is in MIG
# mode, so the full-GPU resource has no device to share (replicas 0).
@pytest.mark.parametrize("backend,strategy,replicas", [("mock-nvml:none", "none", "4"),
                                                       ("mock-nvml:single", "single", "4"),
                                                       ("mock-nvml:mixed", "mixed", "0")])
def test_sharing_config(tmp_path, hermetic, backend, strategy, replicas):
    labels = _oneshot(tmp_path, "--backends", backend, "--tpu-topology-strategy", strategy,
                      "--config-file", str(HERE / "config-shared-torch.yaml"))
    assert labels[GPU + "replicas"] == replicas
    assert_every_label_valid(labels, f"shared {backend}")


def test_gpu_and_cpu_families(tmp_path, hermetic):
    labels = _oneshot(tmp_path, "--backends", "mock-gpu:2,mock-cpu:3")
    assert any(k.startswith("node.features/cpu.") for k in labels)
    assert_every_label_valid(labels, "gpu and cpu families")


def test_slice_leader_and_follower(tmp_path):
    with PortSliceHarness(tmp_path, workers=2) as harness:
        snap = harness.wait_for(
            lambda s: s[0].get(GPU + "slice.role") == "leader"
            and s[0].get(GPU + "slice.healthy-hosts") == "2"
            and s[1].get(GPU + "slice.role") == "follower"
            and s[1].get(GPU + "slice.leader-seen") == "true",
            what="a leader and a follower")
    assert_every_label_valid(snap[0], "the slice leader")
    assert_every_label_valid(snap[1], "the slice follower")


def test_actuation_advice_and_its_lease(tmp_path):
    with PortSliceHarness(tmp_path, workers=1, coordination="off", sick_workers=(0,),
                          extra_cli={"actuation": "enforce",
                                     "actuation-window": "1"}) as harness:
        snap = harness.wait_for(
            lambda s: s[0].get(GPU + "schedulable") == "false"
            and GPU + "tfd.actuation-lease" in s[0], what="the advice")
    assert snap[0][GPU + "tfd.cordon-advice"] == "sick-chips"
    assert_every_label_valid(snap[0], "the advice")


# chip_smoke.py's copy of the grammar against the twin's, key by key.
GRAMMAR_SAMPLES = [
    ("nvidia.com/gpu.count", "2"),
    ("nvidia.com/mig-1g.10gb.engines.ofa", "0"),
    ("google.com/tfd.timestamp", "1792280494"),
    ("node.features/cpu.count", ""),
    ("plain-name", "a_b.c-d"),
    ("nvidia.com/gpu.product", "nvidia-h100-80gb-hbm3-MIG-3g.40gb"),
    ("Nvidia.com/gpu.count", "2"),            # an upper-case prefix
    ("nvidia.com/", "2"),                    # an empty name
    ("nvidia_com/gpu.count", "2"),           # an underscore in the prefix
    ("nvidia.com/-count", "2"),              # a name that starts with a dash
    ("nvidia.com/" + "n" * 64, "2"),         # a name over 63
    ("nvidia.com/gpu.count", "v" * 64),      # a value over 63
    ("nvidia.com/gpu.machine", "weird host"),
    ("nvidia.com/gpu.machine", "-leading"),
    ("nvidia.com/gpu.machine", "trailing."),
    ("a" * 250 + ".com/gpu.count", "2"),     # a prefix over 253
]


def _twin_accepts(key, value):
    try:
        assert_valid_label(key, value)
    except AssertionError:
        return False
    return True


@pytest.mark.parametrize("key,value", GRAMMAR_SAMPLES)
def test_chip_smokes_grammar_is_the_twins(key, value):
    assert (chip_smoke.label_grammar_error(key, value) is None) == _twin_accepts(key, value)


def test_chip_smokes_reader_raises_on_a_label_outside_the_grammar(tmp_path):
    path = tmp_path / "tfd"
    path.write_text("nvidia.com/gpu.count=2\nnvidia.com/gpu.machine=weird host\n")
    with pytest.raises(SystemExit, match="outside the k8s grammar"):
        chip_smoke._read_labels(str(path))
    path.write_text("nvidia.com/gpu.count=2\n")
    assert chip_smoke._read_labels(str(path)) == {"nvidia.com/gpu.count": "2"}


@pytest.mark.parametrize("layout,strategy",
                         [(l, s) for l in sorted(LAYOUTS) for s in STRATEGIES])
def test_new_labelers_merge_is_valid_and_the_engines_map(tmp_path, hermetic, layout, strategy):
    """The twin's grammar sweep composes ``new_labelers`` (the eager Merge
    of the device labeler and the interconnect) with the timestamp; the
    port's must pass the grammar and equal the engine's oneshot map."""
    from gpu_feature_discovery_tpu_torch.config.flags import new_config
    from gpu_feature_discovery_tpu_torch.lm.interconnect import InterconnectLabeler
    from gpu_feature_discovery_tpu_torch.lm.labeler import Merge
    from gpu_feature_discovery_tpu_torch.lm.labelers import new_labelers
    from gpu_feature_discovery_tpu_torch.lm.timestamp import new_timestamp_labeler
    from gpu_feature_discovery_tpu_torch.resource.nvml_backend import NvmlManager
    from gpu_feature_discovery_tpu_torch.resource.testing import fake_nvml

    config = new_config(cli_values={"tpu-topology-strategy": strategy,
                                    "machine-type-file": ""}, environ={})
    merged = dict(Merge(new_timestamp_labeler(config),
                        new_labelers(NvmlManager(fake_nvml(layout)), InterconnectLabeler(),
                                     config)).labels())
    assert_every_label_valid(merged, f"new_labelers mock-nvml:{layout}/{strategy}")
    engine = _oneshot(tmp_path, "--backends", f"mock-nvml:{layout}", "--machine-type-file", "",
                      "--tpu-topology-strategy", strategy)
    stamp = "google.com/tfd.timestamp"
    assert {k: v for k, v in merged.items() if k != stamp} == \
        {k: v for k, v in engine.items() if k != stamp}
