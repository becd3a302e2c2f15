"""The port's multi-backend registry (resource/registry.py, the registry
branch of cmd/main.run, lm/labelers.multi_backend_label_sources, the
per-token broker workers) against the twin's, on the CPU.

- ``parse_backends_value`` accepts and refuses the tokens and lists the
  two packages share, with the twin's error texts; the twin's TPU-only
  tokens are unknown here. ``TFD_BACKEND`` wins and keeps the classic
  path in both.
- ``BackendRuntime``'s retry and backoff state equals the twin's, step by
  step, under the same fault spec, fake clock and jitter seed.
- A ``--backends mock-gpu:2,mock-cpu:3`` oneshot gives the twin's cpu
  family byte for byte and the gpu family's golden; the gpu group is
  the classic list's output exactly.
- Under ``pjrt_init.cpu:fail:k`` the degraded markers and
  ``tfd_backend_up`` follow the twin's loop cycle by cycle.
- The cpu family's broker worker never imports torch.

Every comparison is exact.
"""

import os
import queue
import random
import re
import signal
import threading
import time
from pathlib import Path

import pytest

from gpu_feature_discovery_tpu.cmd import main as twin_main
from gpu_feature_discovery_tpu.cmd.supervisor import Supervisor as TwinSupervisor
from gpu_feature_discovery_tpu.config import flags as twin_flags
from gpu_feature_discovery_tpu.lm.labeler import Empty as TwinEmpty
from gpu_feature_discovery_tpu.lm.labels import Labels as TwinLabels
from gpu_feature_discovery_tpu.obs import metrics as twin_metrics
from gpu_feature_discovery_tpu.resource import registry as twin_registry
from gpu_feature_discovery_tpu.utils import faults as twin_faults
from gpu_feature_discovery_tpu_torch import sandbox
from gpu_feature_discovery_tpu_torch.cmd import main
from gpu_feature_discovery_tpu_torch.cmd.supervisor import DEGRADED_LABEL, Supervisor
from gpu_feature_discovery_tpu_torch.config import flags
from gpu_feature_discovery_tpu_torch.config.spec import ConfigError
from gpu_feature_discovery_tpu_torch.lm.labeler import Empty
from gpu_feature_discovery_tpu_torch.lm.labels import Labels
from gpu_feature_discovery_tpu_torch.lm.pjrt_family import (
    FAMILY_COUNT_KEYS,
    FAMILY_DEGRADED_LABELS,
    FAMILY_NAMESPACES,
)
from gpu_feature_discovery_tpu_torch.native import nvml
from gpu_feature_discovery_tpu_torch.obs import metrics
from gpu_feature_discovery_tpu_torch.resource import factory, registry
from gpu_feature_discovery_tpu_torch.sandbox.broker import BrokerClient
from gpu_feature_discovery_tpu_torch.utils import faults

from test_torch_oneshot import check_result, _gpu_mock_golden

HERE = Path(__file__).parent


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv("TFD_BACKEND", raising=False)
    faults.reset()
    twin_faults.reset()
    yield
    faults.reset()
    twin_faults.reset()
    sandbox.close_broker()
    sandbox.set_broker_death_watch(False)


def _outcome(parse, value):
    try:
        return ("ok", parse(value))
    except Exception as e:  # noqa: BLE001 - both must refuse alike
        # The "known:" list names each package's own providers.
        return ("error", type(e).__name__, str(e).split(" (known:")[0])


# Lists whose tokens belong to the same family in both packages.
@pytest.mark.parametrize("value", [
    "gpu", "cpu", "GPU", " cpu ", "mock-gpu", "mock-gpu:3", "mock-cpu:2",
    "gpu,cpu", "cpu,gpu", "mock-gpu:2,mock-cpu:3", "mock-cpu:3,mock-gpu:2",
    "gpu,gpu", "cpu, cpu ,gpu", "gpu,mock-gpu:2", "cpu,mock-cpu", "mock-gpu:0",
    "mock-gpu:x", "mock-cpu:-1", "mock-gpux", "mock-cpu:", "", " , ", ",gpu,",
    "auto", "null", "native", "auto,cpu", "null,mock-cpu:2", "mock-gpu:1_0",
])
def test_parse_backends_value_matches_the_twin(value):
    assert _outcome(registry.parse_backends_value, value) == \
        _outcome(twin_registry.parse_backends_value, value)


@pytest.mark.parametrize("token", [
    "tpu", "jax", "pjrt", "hostinfo", "metadata", "mock:v4-8", "mock-slice:v4-8",
    "mock-worker:v5p-64", "mock-mixed:v5e",
])
def test_the_twins_tpu_only_tokens_are_unknown_here(token):
    twin_registry.parse_backends_value(token)
    with pytest.raises(ConfigError, match=f"unknown backend {token!r} in --backends"):
        registry.parse_backends_value(token)


def _tokens(mod, cfg_mod, backends, environ):
    config = cfg_mod.new_config(cli_values={"backends": backends}, environ={})
    return mod.multi_backend_tokens(config, environ=environ)


@pytest.mark.parametrize("backends,environ", [
    ("auto", {}), ("mock-gpu:2,mock-cpu:3", {}), ("cpu", {}), ("gpu,cpu", {}),
    ("mock-gpu:2,mock-cpu:3", {"TFD_BACKEND": "mock-gpu:1"}),
    ("cpu", {"TFD_BACKEND": "null"}), ("gpu,cpu", {"TFD_BACKEND": " "}),
])
def test_tfd_backend_wins_and_keeps_the_classic_path_as_in_the_twin(backends, environ):
    assert _tokens(registry, flags, backends, environ) == \
        _tokens(twin_registry, twin_flags, backends, environ)


def test_a_lone_gpu_family_token_is_the_classic_path():
    """The one rule the port adds: its classic path takes any one
    gpu-family token (the twin's takes ``auto`` alone)."""
    for token in ("gpu", "mock-gpu:2", "native", "null", "mock-nvml:mixed"):
        assert _tokens(registry, flags, token, {}) is None
    assert _tokens(twin_registry, twin_flags, "gpu", {}) == ["gpu"]


def test_tfd_backend_forces_one_gpu_family_backend(tmp_path, monkeypatch):
    out = tmp_path / "tfd"
    argv = ["--oneshot", "--no-timestamp", "--backends", "mock-gpu:2,mock-cpu:3",
            "--output-file", str(out)]
    monkeypatch.setenv("TFD_BACKEND", "mock-gpu:1")
    assert main.start(argv) == 0
    labels = _labels(out)
    assert labels["nvidia.com/gpu.count"] == "1"
    assert not any(k.startswith("node.features/") for k in labels)
    # Unknown, or another family's: autodetect (no GPU here: nothing).
    for forced in ("mock:v4-8", "mock-cpu:2"):
        monkeypatch.setenv("TFD_BACKEND", forced)
        assert main.start(argv) == 0
        assert not any(k.startswith(("nvidia.com/", "node.features/"))
                       for k in _labels(out))


def test_validation_of_a_list_loads_no_nvml(monkeypatch):
    def boom(*_a, **_k):
        raise AssertionError("NVML touched while validating")

    monkeypatch.setattr(nvml, "load_library", boom)
    monkeypatch.setattr(factory, "detect_gpu_platform", boom)
    for value, kind in (("gpu,cpu", "gpu"), ("auto,mock-cpu:2", "auto"),
                        ("mock-nvml:mixed,cpu", "mock-nvml"), ("cpu", "")):
        config = flags.new_config(cli_values={"backends": value}, environ={})
        assert factory.validate_backends(config)[0] == kind


# ---------------------------------------------------------------------------
# per-backend retry and backoff
# ---------------------------------------------------------------------------

def _runtime_trace(reg, cfg_mod, fault_mod, script):
    config = cfg_mod.new_config(cli_values={
        "backends": "mock-gpu:2,mock-cpu:3", "probe-isolation": "none",
        "init-retries": "3", "init-backoff-max": "8s", "fail-on-init-error": "true",
    }, environ={})
    clock = [0.0]
    backend_set = reg.BackendSet(["mock-gpu:2", "mock-cpu:3"], config,
                                 clock=lambda: clock[0])
    for i, rt in enumerate(backend_set.runtimes):
        rt._policy.rng = random.Random(i)
    fault_mod.load_fault_spec(script["spec"])
    trace = []
    for step, advance in enumerate(script["advances"]):
        if step == script.get("break_gpu_at"):
            fault_mod.load_fault_spec("pjrt_init.gpu:fail:99,pjrt_init.cpu:fail:99")
            backend_set.release_all()
        clock[0] += advance
        backend_set.acquire_all()
        try:
            backend_set.check_escalation()
            escalated = False
        except Exception as e:  # noqa: BLE001 - compared by name
            escalated = type(e).__name__
        trace.append([
            (rt.family, rt.manager is not None, rt.failures, rt._next_attempt,
             rt.down, rt.exhausted, rt.attempt_due())
            for rt in backend_set.runtimes
        ] + [escalated])
    fault_mod.reset()
    return trace


@pytest.mark.parametrize("script", [
    {"spec": "pjrt_init.cpu:fail:2", "advances": [0, 0.1, 1.5, 0.5, 3, 3, 10]},
    {"spec": "pjrt_init.cpu:fail:99", "advances": [0, 2, 4, 9, 9, 20, 0.1]},
    {"spec": "pjrt_init.cpu:fail:99", "advances": [0, 9, 9, 9, 9, 9, 9, 9],
     "break_gpu_at": 3},
])
def test_backend_runtime_retry_and_backoff_match_the_twin(script):
    metrics.reset_for_tests()
    twin_metrics.reset_for_tests()
    port = _runtime_trace(registry, flags, faults, script)
    twin = _runtime_trace(twin_registry, twin_flags, twin_faults, script)
    assert port == twin
    assert any(step[1][2] for step in port), "the cpu family never failed"


# ---------------------------------------------------------------------------
# labels: the two families of a oneshot
# ---------------------------------------------------------------------------

def _labels(path):
    return dict(l.split("=", 1) for l in Path(path).read_text().splitlines() if "=" in l)


def _port_oneshot(tmp_path, name, backends):
    out = tmp_path / name
    assert main.start(["--oneshot", "--no-timestamp", "--backends", backends,
                       "--output-file", str(out)]) == 0
    return out


def _twin_oneshot(tmp_path, name, backends):
    out = tmp_path / name
    config = twin_flags.new_config(cli_values={
        "oneshot": True, "no-timestamp": True, "backends": backends,
        "output-file": str(out)}, environ={})
    assert twin_main.run(None, TwinEmpty(), config, queue.Queue()) is False
    return out


def _family_lines(path, prefix):
    return [l for l in Path(path).read_text().splitlines() if l.startswith(prefix)]


def test_two_family_oneshot_gives_the_twins_cpu_family_and_the_gpu_golden(tmp_path):
    port = _port_oneshot(tmp_path, "port", "mock-gpu:2,mock-cpu:3")
    twin = _twin_oneshot(tmp_path, "twin", "mock-gpu:2,mock-cpu:3")
    cpu = FAMILY_NAMESPACES["cpu"][0]
    assert _family_lines(port, cpu) == _family_lines(twin, cpu)
    assert _family_lines(port, cpu)[-3:] == [
        "node.features/cpu.product=mock-cpu", "node.features/cpu.count=3",
        "node.features/cpu.replicas=1"]
    # The gpu group is the classic list, byte for byte.
    classic = _port_oneshot(tmp_path, "classic", "mock-gpu:2")
    assert _family_lines(port, "nvidia.com/") == _family_lines(classic, "nvidia.com/")
    gpu_only = tmp_path / "gpu-only"
    gpu_only.write_text("\n".join(_family_lines(port, "nvidia.com/")) + "\n")
    check_result(gpu_only, [g for g in _gpu_mock_golden() if "timestamp" not in g])


def test_a_cpu_only_node_carries_no_gpu_label_and_is_the_twins(tmp_path):
    port = _port_oneshot(tmp_path, "port", "mock-cpu:3")
    twin = _twin_oneshot(tmp_path, "twin", "mock-cpu:3")
    assert port.read_bytes() == twin.read_bytes()
    assert not any(k.startswith("nvidia.com/") for k in _labels(port))


def test_the_host_cpu_backend_reads_its_versions_from_the_torch_distribution(tmp_path):
    import importlib.metadata

    labels = _labels(_port_oneshot(tmp_path, "host", "cpu"))
    major, minor, rev = importlib.metadata.version("torch").split("+")[0].split(".")[:3]
    assert labels == {
        "node.features/cpu.driver.major": major, "node.features/cpu.driver.minor": minor,
        "node.features/cpu.driver.rev": rev, "node.features/cpu.runtime.major": major,
        "node.features/cpu.runtime.minor": minor, "node.features/cpu.product": "cpu",
        "node.features/cpu.count": "1", "node.features/cpu.replicas": "1",
    }


# ---------------------------------------------------------------------------
# per-family degradation, cycle by cycle
# ---------------------------------------------------------------------------

_DAEMON_FLAGS = {
    "backends": "mock-gpu:2,mock-cpu:3", "probe-isolation": "none",
    "sleep-interval": "0.03s", "init-backoff-max": "0.001s", "reconcile": "interval",
    "no-timestamp": "true", "metrics-port": "0", "fail-on-init-error": "false",
}
_CYCLES = 6


def _record_cycles(monkeypatch, labels_cls, metrics_mod, sigs, records):
    write = labels_cls.write_to_file

    def recording(self, path):
        write(self, path)
        up = metrics_mod.BACKEND_UP
        records.append((
            FAMILY_DEGRADED_LABELS["cpu"] in self, FAMILY_DEGRADED_LABELS["gpu"] in self,
            FAMILY_COUNT_KEYS["cpu"] in self, FAMILY_COUNT_KEYS["gpu"] in self,
            up.value(backend="cpu"), up.value(backend="gpu"),
            metrics_mod.DEGRADED.value(),
        ))
        if len(records) == _CYCLES:
            sigs.put(signal.SIGTERM)

    monkeypatch.setattr(labels_cls, "write_to_file", recording)


def _drive(target, sigs):
    result = {}
    t = threading.Thread(target=lambda: result.update(restart=target(sigs)), daemon=True)
    t.start()
    t.join(60)
    assert not t.is_alive(), "the daemon did not stop"
    assert result.get("restart") is False


@pytest.mark.parametrize("k", [1, 3])
def test_only_the_cpu_family_degrades_cycle_by_cycle_like_the_twin(tmp_path, monkeypatch, k):
    spec = f"pjrt_init.cpu:fail:{k}"
    machine = tmp_path / "machine-type"
    machine.write_text("node\n")
    metrics.reset_for_tests()
    port, port_sigs = [], queue.SimpleQueue()
    _record_cycles(monkeypatch, Labels, metrics, port_sigs, port)
    config = flags.new_config(cli_values={
        **_DAEMON_FLAGS, "output-file": str(tmp_path / "port"),
        "machine-type-file": str(machine)}, environ={})
    faults.load_fault_spec(spec)
    _drive(lambda sigs: main.run(None, config, sigs, supervisor=Supervisor(config),
                                 interconnect=Empty()), port_sigs)

    twin_metrics.reset_for_tests()
    twin, twin_sigs = [], queue.SimpleQueue()
    _record_cycles(monkeypatch, TwinLabels, twin_metrics, twin_sigs, twin)
    twin_config = twin_flags.new_config(cli_values={
        **_DAEMON_FLAGS, "output-file": str(tmp_path / "twin"),
        "machine-type-file": str(machine)}, environ={})
    twin_faults.load_fault_spec(spec)
    _drive(lambda sigs: twin_main.run(None, TwinEmpty(), twin_config, sigs,
                                      supervisor=TwinSupervisor(twin_config)), twin_sigs)

    assert port == twin
    # k degraded cycles of the cpu family alone, then both fresh.
    assert port == [(True, False, False, True, 0.0, 1.0, 1.0)] * k + \
        [(False, False, True, True, 1.0, 1.0, 0.0)] * (_CYCLES - k)
    assert DEGRADED_LABEL == FAMILY_DEGRADED_LABELS["gpu"]


# ---------------------------------------------------------------------------
# one broker worker per family
# ---------------------------------------------------------------------------

def _maps(pid):
    return Path(f"/proc/{pid}/maps").read_text()


def test_the_cpu_familys_worker_never_imports_torch(tmp_path):
    import torch  # noqa: F401 - the maps check's positive control

    config = flags.new_config(cli_values={
        "backends": "mock-gpu:2,cpu", "with-burnin": "true",
        "output-file": str(tmp_path / "tfd")}, environ={})
    cpu = BrokerClient(config, backend="cpu")
    try:
        assert cpu.ping()
        assert cpu.snapshot().chips[0].name == "cpu"
        # Only a gpu-family worker serves the burn-in.
        with pytest.raises(Exception, match="unknown op 'health'"):
            cpu.health()
        assert "libtorch" in _maps(os.getpid())
        assert "libtorch" not in _maps(cpu.pid)
    finally:
        cpu.close()


def test_the_daemon_keys_one_worker_per_family_and_retires_them(tmp_path, monkeypatch):
    """At the daemon's defaults (the broker on), each family acquires
    through its own worker; the epoch's end retires both."""
    out = tmp_path / "tfd"
    config = flags.new_config(cli_values={
        "backends": "mock-gpu:2,mock-cpu:3", "sleep-interval": "0.05s",
        "metrics-port": "0", "output-file": str(out)}, environ={})
    sigs = queue.SimpleQueue()
    result = {}
    t = threading.Thread(target=lambda: result.update(restart=main.run(
        lambda: factory.build_manager(config), config, sigs,
        supervisor=Supervisor(config), interconnect=Empty())), daemon=True)
    t.start()
    try:
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and not (
                out.exists() and FAMILY_COUNT_KEYS["cpu"] in _labels(out)):
            time.sleep(0.02)
        keyed = dict(sandbox.broker._keyed)
        assert sorted(keyed) == ["mock-cpu:3", "mock-gpu:2"]
        assert sandbox.broker._active is None
        pids = [c.pid for c in keyed.values()]
        assert len(set(pids)) == 2 and all(pids)
        assert metrics.BACKEND_UP.value(backend="cpu") == 1
    finally:
        sigs.put(signal.SIGTERM)
        t.join(30)
    assert not t.is_alive() and result.get("restart") is False
    assert not sandbox.broker._keyed
    for pid in pids:
        assert not os.path.exists(f"/proc/{pid}") or re.search(
            r"\) Z ", Path(f"/proc/{pid}/stat").read_text())
    assert metrics.BACKEND_UP.value(backend="cpu") == 0
