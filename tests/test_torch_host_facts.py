"""The host facts of the PyTorch port against its JAX twin, on the CPU.

Machine type, the PCI interconnect labels, slice capability, the
architecture family, the degraded source set, the oneshot
fallback-to-null repair, the backend tokens and the autodetect chain,
MIG partitions across the broker's pipe, and the ``mock-nvml`` CLI.
Twin labels are compared after the label translation
(``google.com/tpu.`` → ``nvidia.com/gpu.``)."""

import json
import os
import queue
import signal
import subprocess
import sys
import threading
import time
from collections import Counter
from pathlib import Path

import pytest

from gpu_feature_discovery_tpu.config import new_config as twin_new_config
from gpu_feature_discovery_tpu.lm.engine import LabelEngine as TwinLabelEngine
from gpu_feature_discovery_tpu.lm import interconnect as twin_ic
from gpu_feature_discovery_tpu.lm import labelers as twin_labelers
from gpu_feature_discovery_tpu.lm.labeler import Empty as TwinEmpty
from gpu_feature_discovery_tpu.lm.topology_strategy import (
    new_resource_labeler as twin_resource_labeler,
)
from gpu_feature_discovery_tpu.lm.machine_type import (
    new_machine_type_labeler as twin_machine_type,
)
from gpu_feature_discovery_tpu.lm.versions import (
    new_slice_capability_labeler as twin_slice_capability,
)
from gpu_feature_discovery_tpu.pci import pciutil as twin_pci
from gpu_feature_discovery_tpu.resource import factory as twin_factory
from gpu_feature_discovery_tpu.resource.testing import MockChip as TwinMockChip
from gpu_feature_discovery_tpu.resource.testing import MockManager as TwinMockManager
from gpu_feature_discovery_tpu.sandbox import broker as twin_broker
from gpu_feature_discovery_tpu.sandbox.snapshot import DeviceSnapshot as TwinSnapshot
from gpu_feature_discovery_tpu.sandbox.snapshot import SnapshotManager as TwinSnapshotManager
from gpu_feature_discovery_tpu_torch import sandbox
from gpu_feature_discovery_tpu_torch.cmd import main as port_main
from gpu_feature_discovery_tpu_torch.cmd.main import run, start
from gpu_feature_discovery_tpu_torch.cmd.supervisor import Supervisor
from gpu_feature_discovery_tpu_torch.config.flags import new_config
from gpu_feature_discovery_tpu_torch.config.spec import (
    ConfigError,
    ReplicatedResource,
    config_from_dict,
    config_to_dict,
)
from gpu_feature_discovery_tpu_torch.lm.engine import LabelEngine
from gpu_feature_discovery_tpu_torch.lm.interconnect import InterconnectLabeler
from gpu_feature_discovery_tpu_torch.lm.labelers import (
    degraded_label_sources,
    new_label_sources,
)
from gpu_feature_discovery_tpu_torch.lm.machine_type import new_machine_type_labeler
from gpu_feature_discovery_tpu_torch.lm.pjrt_family import family_guard
from gpu_feature_discovery_tpu_torch.lm.topology_strategy import new_resource_labeler
from gpu_feature_discovery_tpu_torch.lm.labels import Labels
from gpu_feature_discovery_tpu_torch.lm.versions import new_slice_capability_labeler
from gpu_feature_discovery_tpu_torch.models.chips import family_for_generation
from gpu_feature_discovery_tpu_torch.native import nvml
from gpu_feature_discovery_tpu_torch.pci import pciutil
from gpu_feature_discovery_tpu_torch.resource import factory
from gpu_feature_discovery_tpu_torch.resource.cuda_backend import (
    CudaManager,
    StaticCudaManager,
)
from gpu_feature_discovery_tpu_torch.resource.fallback import FallbackToNullOnInitError
from gpu_feature_discovery_tpu_torch.resource.null import NullManager
from gpu_feature_discovery_tpu_torch.resource.nvml_backend import NvmlManager
from gpu_feature_discovery_tpu_torch.resource.testing import (
    H100_DRIVER_VERSION,
    LAYOUTS,
    FakeNvml,
    MockChip,
    MockManager,
    fake_nvml,
)
from gpu_feature_discovery_tpu_torch.resource.types import ResourceError
from gpu_feature_discovery_tpu_torch.sandbox import broker as port_broker
from gpu_feature_discovery_tpu_torch.sandbox.probe import _write_frame
from gpu_feature_discovery_tpu_torch.sandbox.snapshot import DeviceSnapshot, SnapshotManager
from gpu_feature_discovery_tpu_torch.utils import faults

REPO = Path(__file__).parent.parent
TIMESTAMP = "google.com/tfd.timestamp"


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv(faults.FAULT_SPEC_ENV, raising=False)
    monkeypatch.delenv("TFD_MOCK_PCI", raising=False)
    faults.reset()
    yield
    faults.reset()
    sandbox.set_broker_death_watch(False)
    sandbox.close_broker()


def translate(labels):
    return {k.replace("google.com/tpu.", "nvidia.com/gpu.", 1)
            .replace("google.com/tpu-", "nvidia.com/mig-", 1): v.replace("-SLICE-", "-MIG-")
            for k, v in dict(labels).items()}


def cfg(**cli):
    return new_config(cli_values=cli, environ={})


# ---------------------------------------------------------------------------
# machine type, slice capability, family
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("content", [
    "HGX H100 8-GPU\n", "PowerEdge XE9680 (Gen 9)\n", "ProLiant DL380a Gen11",
    "", "???", None,
])
def test_machine_type_matches_twin(tmp_path, content):
    path = tmp_path / "product_name"
    if content is not None:
        path.write_text(content)
    got = dict(new_machine_type_labeler(str(path)))
    assert got == translate(twin_machine_type(str(path)))
    assert list(got) == ["nvidia.com/gpu.machine"]


def test_machine_type_of_an_empty_path_is_unknown():
    assert new_machine_type_labeler("") == {"nvidia.com/gpu.machine": "unknown"}
    assert translate(twin_machine_type("")) == {"nvidia.com/gpu.machine": "unknown"}


@pytest.mark.parametrize("capable", [[], [False], [True], [False, True], [False, False]])
def test_slice_capability_matches_twin(capable):
    port = MockManager([MockChip(slice_capable=c) for c in capable])
    twin = TwinMockManager([TwinMockChip(slice_capable=c) for c in capable])
    got = dict(new_slice_capability_labeler(port).labels())
    assert got == translate(twin_slice_capability(twin).labels())
    if capable:
        assert got == {"nvidia.com/gpu.slice.capable": str(any(capable)).lower()}


# The reference's getArchFamily (internal/lm/resource.go:261-284).
@pytest.mark.parametrize("major,minor,family", [
    (1, 3, "tesla"), (2, 1, "fermi"), (3, 7, "kepler"), (4, 0, "undefined"),
    (5, 2, "maxwell"), (6, 1, "pascal"), (7, 0, "volta"), (7, 2, "volta"),
    (7, 5, "turing"), (8, 0, "ampere"), (8, 6, "ampere"), (8, 9, "ada-lovelace"),
    (9, 0, "hopper"), (10, 0, "blackwell"), (12, 0, "undefined"),
])
def test_family_for_generation_is_get_arch_family(major, minor, family):
    assert family_for_generation(major, minor) == family


def test_architecture_labels_of_an_h100_and_none_without_capability():
    h100 = NvmlManager(fake_nvml("none"))
    h100.init()
    labels = new_resource_labeler(h100, cfg()).labels()
    assert (labels["nvidia.com/gpu.family"], labels["nvidia.com/gpu.generation.major"],
            labels["nvidia.com/gpu.generation.minor"]) == ("hopper", "9", "0")
    assert not any(k.endswith((".tensorcores", ".sparsecores")) for k in labels)
    mock = StaticCudaManager.mock_gpu(1)
    mock.init()
    assert "nvidia.com/gpu.family" not in new_resource_labeler(mock, cfg()).labels()


def test_family_guard_admits_mig_resources_only():
    labels = Labels({"nvidia.com/gpu.count": "1", "nvidia.com/mig-3g.40gb.count": "2",
                     "google.com/tpu.count": "1", "nvidia.com/mig.strategy": "x"})
    assert list(family_guard("gpu", labels)) == [
        "nvidia.com/gpu.count", "nvidia.com/mig-3g.40gb.count"]


# ---------------------------------------------------------------------------
# the interconnect
# ---------------------------------------------------------------------------

RECORD = b"NVHOST\x00\x00580.95.05\x00r580\x00"


def _devices(mod, configs):
    return [mod.PCIDevice(path="", address=f"0000:{0x19 + 0x20 * i:02x}:00.0",
                          vendor="0x10de", device_class="0x0302", config=c)
            for i, c in enumerate(configs)]


def _space(record=None, size=256):
    caps = [pciutil.make_capability(0x01, b"\x00\x00")]
    if record is not None:
        caps.append(pciutil.make_capability(0x09, record))
    return pciutil.build_config_space(capabilities=caps)[:size]


INTERCONNECT_CASES = {
    "no_devices": [],
    "record_then_plain": [_space(RECORD), _space()],
    "plain_then_record": [_space(), _space(RECORD)],
    "short_read_skipped": [_space(RECORD, size=64), _space(RECORD)],
    "every_read_short": [_space(RECORD, size=64)] * 2,
    "binary_vendor_cap": [_space(b"\x01\x00\x28\x00\x00\x00\x10\x00")],
    "no_version": [_space(b"NVHOST\x00\x00\x00r580\x00")],
    "eight_gpus": [_space()] * 8,
}


@pytest.mark.parametrize("case", sorted(INTERCONNECT_CASES))
def test_interconnect_matches_twin(case, caplog):
    configs = INTERCONNECT_CASES[case]
    got = InterconnectLabeler(pciutil.MockNvidiaPCI(_devices(pciutil, configs))).labels()
    want = twin_ic.InterconnectLabeler(
        pci=twin_pci.MockGooglePCI(_devices(twin_pci, configs)), provider=None).labels()
    assert dict(got) == translate(want)
    if configs:
        assert got["nvidia.com/gpu.pci.count"] == str(len(configs))
    if case == "short_read_skipped":
        assert any("skipping PCI capability read" in r.message for r in caplog.records)


def test_interconnect_ignores_a_printable_binary_capability():
    """A GPU's own vendor capability is not the twin's record: bytes that
    happen to decode as a short printable "signature" make no label."""
    configs = [_space(b"(c)\x00\x00580\x00")]
    got = InterconnectLabeler(pciutil.MockNvidiaPCI(_devices(pciutil, configs))).labels()
    assert dict(got) == {"nvidia.com/gpu.pci.present": "true",
                         "nvidia.com/gpu.pci.count": "1"}


def test_interconnect_without_a_scanner_is_empty():
    assert InterconnectLabeler().labels() == {}


def test_cli_interconnect_fixture_and_tolerant_scan(monkeypatch, tmp_path):
    monkeypatch.setenv("TFD_MOCK_PCI", "1")
    labels = port_main.new_interconnect_labeler(cfg()).labels()
    assert labels["nvidia.com/gpu.pci.count"] == "2"
    assert labels["nvidia.com/gpu.pci.host-interface"] == "NVHOST"
    monkeypatch.delenv("TFD_MOCK_PCI")
    monkeypatch.setattr(pciutil, "PCI_DEVICES_ROOT", str(tmp_path / "none"))
    scanner = port_main._TolerantPCI()
    scanner._scanner.root = str(tmp_path / "none")
    assert scanner.devices() == []


# ---------------------------------------------------------------------------
# source sets against the twin
# ---------------------------------------------------------------------------

def _dmi(tmp_path):
    path = tmp_path / "product_name"
    path.write_text("HGX H100 8-GPU\n")
    return str(path)


def test_degraded_sources_match_twin(tmp_path):
    dmi = _dmi(tmp_path)
    port_ic = InterconnectLabeler(pciutil.MockNvidiaPCI())
    twin_ic_labeler = twin_ic.InterconnectLabeler(
        pci=twin_pci.MockGooglePCI(_devices(
            twin_pci, [d.config for d in pciutil.MockNvidiaPCI().devices()])),
        provider=None)
    got_sources = degraded_label_sources(cfg(**{"machine-type-file": dmi}),
                                         interconnect=port_ic)
    want_sources = twin_labelers.degraded_label_sources(
        twin_ic_labeler, twin_new_config(cli_values={"machine-type-file": dmi}))
    assert [s.name for s in got_sources] == [s.name for s in want_sources] == [
        "machine-type", "interconnect"]
    got = LabelEngine(parallel=False).generate(got_sources)
    assert dict(got) == translate(_twin_engine().generate(want_sources))
    assert got["nvidia.com/gpu.machine"] == "HGX-H100-8-GPU"
    assert got["nvidia.com/gpu.pci.count"] == "2"


def _twin_engine():
    return TwinLabelEngine(parallel=False)


def test_full_source_order_matches_twin(tmp_path):
    port = new_label_sources(StaticCudaManager.mock_gpu(2), cfg(),
                             timestamp=Labels(), interconnect=Labels())
    twin = twin_labelers.new_label_sources(
        TwinMockManager([TwinMockChip()]), TwinEmpty(), twin_new_config(),
        timestamp=Labels())
    assert [s.name for s in port] == [s.name for s in twin] == [
        "timestamp", "machine-type", "device", "health", "interconnect"]
    null = new_label_sources(NullManager(), cfg(), interconnect=Labels())
    assert [s.name for s in null] == ["interconnect"]


# ---------------------------------------------------------------------------
# the oneshot fallback-to-null repair
# ---------------------------------------------------------------------------

class _Broken(MockManager):
    def __init__(self):
        super().__init__(chips=[MockChip()], init_error=RuntimeError("no driver"))


def test_fallback_wrapper_matches_twin_on_a_failing_manager():
    port = FallbackToNullOnInitError(_Broken())
    twin = twin_factory.with_config(
        TwinMockManager(chips=[TwinMockChip()], init_error=RuntimeError("no driver")),
        twin_new_config(cli_values={"fail-on-init-error": "false"}))
    got = LabelEngine(parallel=False).generate(
        new_label_sources(port, cfg(), interconnect=Labels()))
    want = _twin_engine().generate(twin_labelers.new_label_sources(
        twin, TwinEmpty(), twin_new_config()))
    assert dict(got) == translate(want) == {}
    assert port.get_chips() == []
    with pytest.raises(Exception, match="null resource manager"):
        port.get_driver_version()


@pytest.mark.parametrize("fail_on_init_error,rc", [("false", 0), ("true", 1)])
def test_oneshot_over_a_failing_backend(tmp_path, monkeypatch, fail_on_init_error, rc):
    """--fail-on-init-error=false: the twin's wrapper, no device labels,
    exit 0; true: exit 1. Before the repair both exited 1."""
    monkeypatch.setattr(factory, "select_manager", lambda config, **_kw: _Broken())
    out = tmp_path / "tfd"
    assert start(["--oneshot", "--backends", "gpu", "--fail-on-init-error",
                  fail_on_init_error, "--output-file", str(out)]) == rc
    if rc == 0:
        lines = [l for l in out.read_text().splitlines() if l.strip()]
        assert [l for l in lines if not l.startswith(
            (TIMESTAMP, "nvidia.com/gpu.pci."))] == []
    else:
        assert not out.exists()


@pytest.mark.parametrize("token", ["gpu", "auto"])
def test_oneshot_gpu_without_a_card_falls_back_only_when_asked(tmp_path, monkeypatch,
                                                               token):
    """A GPU node (NVML loads) whose CUDA will not init."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(factory, "detect_gpu_platform", lambda: (True, "test"))
    out = tmp_path / "tfd"
    assert start(["--oneshot", "--backends", token, "--output-file", str(out)]) == 1
    assert start(["--oneshot", "--backends", token, "--fail-on-init-error=false",
                  "--no-timestamp", "--output-file", str(out)]) == 0
    assert "nvidia.com/gpu.count" not in out.read_text()


# ---------------------------------------------------------------------------
# backend tokens and the autodetect chain
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("token,kind", [
    ("auto", "auto"), ("GPU", "gpu"), ("native", "native"), ("null", "null"),
    ("mock-gpu", "mock-gpu"), ("mock-gpu:3", "mock-gpu"),
    ("mock-nvml:mixed", "mock-nvml"), ("mock-nvml:no-mig", "mock-nvml"),
])
def test_valid_backend_tokens(token, kind):
    assert factory.validate_backends(cfg(backends=token))[0] == kind


@pytest.mark.parametrize("token", [
    "tpu", "gpu,native", "mock-gpu:0", "mock-nvml", "mock-nvml:", "mock-nvml:h200",
])
def test_bad_backend_tokens_are_config_errors(token):
    with pytest.raises(ConfigError):
        factory.validate_backends(cfg(backends=token))


def test_select_manager_builds_each_kind():
    assert isinstance(factory.select_manager(cfg(backends="null")), NullManager)
    assert isinstance(factory.select_manager(cfg(backends="gpu")), CudaManager)
    assert isinstance(factory.select_manager(cfg(backends="native")), NvmlManager)
    m = factory.select_manager(cfg(backends="mock-nvml:single"))
    m.init()
    assert len(m.get_chips()) == 2 and m.get_driver_version() == H100_DRIVER_VERSION


def test_validation_loads_no_nvml(monkeypatch):
    def boom(*_a, **_k):
        raise AssertionError("NVML touched while validating")

    monkeypatch.setattr(nvml, "load_library", boom)
    monkeypatch.setattr(factory, "detect_gpu_platform", boom)
    for token in ("auto", "gpu", "native", "mock-nvml:mixed"):
        factory.validate_backends(cfg(backends=token))


@pytest.mark.parametrize("detected,native,fallback,want", [
    (False, "false", False, NullManager),      # no GPU on the node
    (False, "false", True, NullManager),
    (True, "false", False, CudaManager),       # lazy: its init error surfaces
    (True, "false", True, NullManager),        # oneshot, CUDA unusable, no opt-in
    (True, "true", True, NvmlManager),         # CUDA unusable, NVML opt-in
    (True, "true", False, NvmlManager),
])
def test_autodetect_chain(monkeypatch, detected, native, fallback, want):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(factory, "detect_gpu_platform", lambda: (detected, "test"))
    monkeypatch.setattr(factory, "NvmlManager",
                        lambda nvml_lib=None: NvmlManager(fake_nvml("none")))
    config = cfg(**{"native-enumeration": native})
    manager = factory.autodetect_manager(config, fallback_to_null=fallback)
    assert type(manager).__name__ == want.__name__


def test_autodetect_without_fallback_raises_cudas_error(monkeypatch):
    """A GPU node where neither backend inits: without the oneshot
    fallback the chain raises CUDA's error instead of hiding the device
    behind the Null manager."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(factory, "detect_gpu_platform", lambda: (True, "test"))
    monkeypatch.setattr(factory, "NvmlManager", lambda nvml_lib=None: NvmlManager(
        FakeNvml([], fail={"nvmlInit_v2": 9})))
    config = cfg(**{"native-enumeration": "true"})
    with pytest.raises(ResourceError, match="no CUDA devices"):
        factory.autodetect_manager(config)
    assert isinstance(factory.autodetect_manager(config, fallback_to_null=True),
                      NullManager)
    with pytest.raises(ResourceError, match="no CUDA devices"):
        factory.new_manager(config, wrap_fallback=False)


def test_detection_sees_nvidia_display_functions(monkeypatch, tmp_path):
    monkeypatch.setattr(nvml, "load_library", lambda *a: None)
    d = tmp_path / "0000:19:00.0"
    d.mkdir()
    (d / "vendor").write_text("0x10de\n")
    (d / "class").write_text("0x030200\n")
    (d / "config").write_bytes(b"\x00" * 64)
    monkeypatch.setattr(factory, "SysfsNvidiaPCI",
                        lambda: pciutil.SysfsNvidiaPCI(root=str(tmp_path)))
    assert factory.detect_gpu_platform()[0] is True
    (d / "class").write_text("0x068000\n")  # an NVSwitch alone is no GPU
    assert factory.detect_gpu_platform()[0] is False


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------

def test_strategy_flag_validates_and_round_trips():
    config = new_config(cli_values={"native-enumeration": "true"},
                        environ={"TFD_TPU_TOPOLOGY_STRATEGY": "mixed"})
    assert config.flags.tpu_topology_strategy == "mixed"
    assert config.flags.native_enumeration is True
    assert config.flags.tfd.machine_type_file == "/sys/class/dmi/id/product_name"
    config.sharing.time_slicing.resources.append(
        ReplicatedResource(name="nvidia.com/mig-3g.40gb", replicas=4))
    assert config_from_dict(json.loads(json.dumps(config_to_dict(config)))) == config
    with pytest.raises(ConfigError, match="tpu-topology-strategy"):
        new_config(cli_values={"tpu-topology-strategy": "both"}, environ={})


# ---------------------------------------------------------------------------
# MIG partitions across the broker's pipe
# ---------------------------------------------------------------------------

def _labels(manager, strategy):
    config = cfg(**{"tpu-topology-strategy": strategy, "machine-type-file": ""})
    return dict(LabelEngine(parallel=False).generate(
        new_label_sources(manager, config, interconnect=Labels())))


@pytest.mark.parametrize("layout", ["mixed", "single", "empty", "half"])
def test_snapshot_with_mig_partitions_round_trips_through_the_framing(layout):
    live = NvmlManager(fake_nvml(layout))
    live.init()
    doc = DeviceSnapshot.from_manager(live).to_dict()
    frames = []
    for reader in (port_broker._FrameReader, twin_broker._FrameReader):
        r, w = os.pipe()
        try:
            _write_frame(w, doc)
            frames.append(reader(r).read(time.monotonic() + 2))
        finally:
            os.close(r)
            os.close(w)
    port_frame, twin_frame = frames
    snap = DeviceSnapshot.from_dict(json.loads(port_frame))
    assert snap.to_dict() == doc
    assert [len(c.slices) for c in snap.chips] == [
        len([p for p in g.mig if p]) for g in LAYOUTS[layout]]
    for strategy in ("none", "single", "mixed"):
        assert _labels(SnapshotManager(snap), strategy) == _labels(live, strategy)
        # The twin's engine over the twin's snapshot of the same frame.
        twin_cfg = twin_new_config(cli_values={"tpu-topology-strategy": strategy})
        want = translate(twin_resource_labeler(
            TwinSnapshotManager(TwinSnapshot.from_dict(json.loads(twin_frame))),
            twin_cfg).labels())
        got = dict(new_resource_labeler(SnapshotManager(snap), cfg(
            **{"tpu-topology-strategy": strategy})).labels())
        assert got.pop("nvidia.com/gpu.family") == "hopper"
        assert want.pop("nvidia.com/gpu.family") == "undefined"
        assert got == want


def test_broker_serves_mig_partitions_equal_to_the_live_manager():
    config = cfg(backends="mock-nvml:mixed", **{"tpu-topology-strategy": "mixed"})
    brokered = sandbox.acquire_broker_manager(config)
    assert _labels(brokered, "mixed") == _labels(NvmlManager(fake_nvml("mixed")), "mixed")
    assert brokered.broker.pid != os.getpid()


def _drive_daemon(config, out, until, timeout=20.0):
    sigs = queue.SimpleQueue()
    result = {}
    t = threading.Thread(target=lambda: result.update(restart=run(
        lambda: factory.build_manager(config), config, sigs,
        supervisor=Supervisor(config))))
    t.start()
    try:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline and not until():
            time.sleep(0.01)
        labels = dict(l.split("=", 1) for l in Path(out).read_text().splitlines() if "=" in l)
    finally:
        sigs.put(signal.SIGTERM)
        t.join(timeout=20)
    assert not t.is_alive() and result.get("restart") is False
    return labels


def test_brokered_daemon_first_write_carries_host_facts(tmp_path, monkeypatch):
    """Host facts reach the labeling process through the worker's
    snapshot; this process never loads NVML."""
    def boom(*_a, **_k):
        raise AssertionError("NVML touched in the labeling process")

    monkeypatch.setattr(nvml, "load_library", boom)
    monkeypatch.setattr(factory, "detect_gpu_platform", boom)
    monkeypatch.setenv("TFD_MOCK_PCI", "1")
    out = tmp_path / "tfd"
    config = new_config(cli_values={
        "backends": "mock-nvml:mixed", "tpu-topology-strategy": "mixed",
        "output-file": str(out), "sleep-interval": "30s",
        "machine-type-file": _dmi(tmp_path)}, environ={})
    assert sandbox.broker_enabled(config)
    labels = _drive_daemon(config, out, out.exists)
    assert labels["nvidia.com/mig-3g.40gb.count"] == "2"
    assert labels["nvidia.com/gpu.machine"] == "HGX-H100-8-GPU"
    assert labels["nvidia.com/gpu.pci.count"] == "2"
    assert labels["nvidia.com/gpu.family"] == "hopper"


def test_mock_nvml_cli_publishes_the_layouts_mig_counts(tmp_path):
    out = tmp_path / "tfd"
    proc = subprocess.run(
        [sys.executable, "-m", "gpu_feature_discovery_tpu_torch", "--oneshot",
         "--backends", "mock-nvml:mixed", "--tpu-topology-strategy", "mixed",
         "--output-file", str(out)],
        cwd=REPO, capture_output=True, text=True, timeout=120,
        env={k: v for k, v in os.environ.items() if k != "TFD_MOCK_PCI"},
    )
    assert proc.returncode == 0, proc.stderr
    labels = dict(l.split("=", 1) for l in out.read_text().splitlines() if "=" in l)
    want = Counter(p for g in LAYOUTS["mixed"] for p in g.mig if p)
    got = {k.split(".count")[0].removeprefix("nvidia.com/mig-"): int(v)
           for k, v in labels.items()
           if k.startswith("nvidia.com/mig-") and k.endswith(".count")}
    assert got == dict(want)
    assert labels["nvidia.com/gpu.topology.strategy"] == "mixed"
    assert labels["nvidia.com/gpu.count"] == str(len(LAYOUTS["mixed"]))
