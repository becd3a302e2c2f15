"""The twin's cold-start tier (``tests/test_coldstart.py``) held against the
port: the ``--compilation-cache-dir`` resolution and its per-epoch
export (the port's kernel library directory, ``ops/kernel_cache.py``, in
place of the twin's XLA cache), the restored-first write of
``cmd/main.py:run`` and the broker pre-spawn (``sandbox/broker.py``
``prespawn_broker``).

Resolution runs both packages on the same flags and wants the same
answer, the port's subdirectory name aside (``kernel-cache`` where the
twin's is ``xla-cache``). The daemon cases run the port's ``mock-gpu:4``
(the twin's ``mock:v4-8``)."""

import os
import queue
import signal
import threading
import time

import pytest

from gpu_feature_discovery_tpu.config import new_config as twin_new_config
from gpu_feature_discovery_tpu.config.flags import (
    resolve_compilation_cache_dir as twin_resolve,
)
from gpu_feature_discovery_tpu_torch import sandbox
from gpu_feature_discovery_tpu_torch.cmd import main as cmd_main
from gpu_feature_discovery_tpu_torch.cmd.main import run
from gpu_feature_discovery_tpu_torch.cmd.supervisor import RESTORED_LABEL, Supervisor
from gpu_feature_discovery_tpu_torch.config import new_config
from gpu_feature_discovery_tpu_torch.config.flags import (
    KERNEL_CACHE_SUBDIR,
    resolve_compilation_cache_dir,
)
from gpu_feature_discovery_tpu_torch.lm.labeler import Empty
from gpu_feature_discovery_tpu_torch.obs import metrics as obs_metrics
from gpu_feature_discovery_tpu_torch.ops import kernel_cache
from gpu_feature_discovery_tpu_torch.resource import factory
from gpu_feature_discovery_tpu_torch.resource.cuda_backend import StaticCudaManager
from gpu_feature_discovery_tpu_torch.sandbox import LabelStateStore
from gpu_feature_discovery_tpu_torch.utils import faults
from torch_env_guard import resolved_cache_dir_restored  # noqa: F401 - autouse

CACHE_DIR_ENV = "TFD_COMPILATION_CACHE_DIR"  # the flag's own alias


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    faults.reset()
    monkeypatch.delenv(CACHE_DIR_ENV, raising=False)
    monkeypatch.delenv(kernel_cache.RESOLVED_CACHE_DIR_ENV, raising=False)
    obs_metrics.reset_for_tests()
    monkeypatch.setattr(cmd_main, "_restart_to_labels_recorded", False)
    yield
    faults.reset()


def cfg(tmp_path, conf=new_config, **cli):
    machine = tmp_path / "machine-type"
    machine.write_text("Test Node\n")
    values = {"oneshot": False, "machine-type-file": str(machine),
              "output-file": str(tmp_path / "tfd"), "sleep-interval": "0.01s",
              "init-backoff-max": "0.02s", "init-retries": "50",
              "max-consecutive-failures": "50"}
    values.update(cli)
    return conf(cli_values=values, environ={})


def labels_at(path):
    try:
        with open(path) as f:
            return dict(line.strip().split("=", 1) for line in f if "=" in line)
    except OSError:
        return {}


def wait_until(pred, timeout=10.0, interval=0.002):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return pred()


def start_daemon(config, manager=None):
    sigs = queue.Queue()
    result = {}

    def target():
        try:
            result["restart"] = run(
                manager if manager is not None else (lambda: factory.build_manager(config)),
                config, sigs, supervisor=Supervisor(config), interconnect=Empty())
        except BaseException as e:  # noqa: BLE001 - surfaced by the test
            result["error"] = e

    t = threading.Thread(target=target)
    t.start()
    return t, sigs, result


def stop_daemon(t, sigs, result):
    sigs.put(signal.SIGTERM)
    t.join(timeout=10)
    assert not t.is_alive()
    assert "error" not in result, result.get("error")


# ---------------------------------------------------------------------------
# flag resolution and the per-epoch export
# ---------------------------------------------------------------------------

def _both_resolved(tmp_path, **cli):
    port = resolve_compilation_cache_dir(cfg(tmp_path, **cli))
    twin = twin_resolve(cfg(tmp_path, conf=twin_new_config, **cli))
    return port, twin.replace("xla-cache", KERNEL_CACHE_SUBDIR)


def test_resolver_auto_follows_state_dir(tmp_path):
    port, twin = _both_resolved(tmp_path, **{"state-dir": str(tmp_path / "state")})
    assert port == twin == str(tmp_path / "state" / KERNEL_CACHE_SUBDIR)


def test_resolver_auto_without_state_dir_is_unresolved(tmp_path):
    assert _both_resolved(tmp_path) == ("", "")


def test_resolver_explicit_path_and_explicit_empty(tmp_path):
    explicit = {"state-dir": str(tmp_path / "state"),
                "compilation-cache-dir": str(tmp_path / "elsewhere")}
    assert _both_resolved(tmp_path, **explicit) == (str(tmp_path / "elsewhere"),) * 2
    off = {"state-dir": str(tmp_path / "state"), "compilation-cache-dir": ""}
    assert _both_resolved(tmp_path, **off) == ("", "")


def test_configure_exports_env_and_empty_clears_it(tmp_path):
    """The twin creates the XLA cache directory here; the port's is
    created by the first build into it (``build_library``), so an epoch
    that builds nothing leaves no empty directory behind."""
    target = tmp_path / "kernels"
    kernel_cache.configure_kernel_cache(str(target))
    assert os.environ[kernel_cache.RESOLVED_CACHE_DIR_ENV] == str(target)
    assert kernel_cache.kernel_cache_dir() == target
    kernel_cache.configure_kernel_cache("")
    assert kernel_cache.RESOLVED_CACHE_DIR_ENV not in os.environ


def test_resolved_transport_never_pollutes_the_flag_alias(tmp_path):
    kernel_cache.configure_kernel_cache(str(tmp_path / "epoch1"))
    assert CACHE_DIR_ENV not in os.environ
    reloaded = new_config(cli_values={}, environ=dict(os.environ))
    assert reloaded.flags.tfd.compilation_cache_dir == "auto"


def test_an_auto_alias_alone_is_not_a_directory(monkeypatch, tmp_path):
    """The literal 'auto' needs the config layer's --state-dir resolution
    and must not become a directory named ./auto."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv(CACHE_DIR_ENV, "auto")
    assert kernel_cache.kernel_cache_dir() == kernel_cache.DEFAULT_BUILD_DIR
    kernel_cache.kernel_cache_usable()
    assert not os.path.exists("auto")


def test_configure_unusable_dir_degrades(tmp_path):
    blocker = tmp_path / "a-file"
    blocker.write_text("not a dir")
    assert kernel_cache.configure_kernel_cache(str(blocker / "sub")) is False


def test_daemon_epoch_wires_cache_dir_and_gauge(tmp_path, monkeypatch):
    monkeypatch.setenv("TFD_BACKEND", "mock-gpu:4")
    state_dir = tmp_path / "state"
    expected = state_dir / KERNEL_CACHE_SUBDIR
    expected.mkdir(parents=True)
    config = cfg(tmp_path, **{"state-dir": str(state_dir)})
    out = config.flags.tfd.output_file
    t, sigs, result = start_daemon(config)
    try:
        assert wait_until(lambda: labels_at(out).get("nvidia.com/gpu.count") == "4")
        assert os.environ.get(kernel_cache.RESOLVED_CACHE_DIR_ENV) == str(expected)
        assert obs_metrics.COMPILE_CACHE_ENABLED.value() == 1
        assert wait_until(lambda: obs_metrics.RESTART_TO_LABELS.value() > 0), \
            "the first full live write must record restart-to-labels"
    finally:
        stop_daemon(t, sigs, result)

    obs_metrics.reset_for_tests()
    monkeypatch.setattr(cmd_main, "_restart_to_labels_recorded", False)
    t, sigs, result = start_daemon(cfg(tmp_path))  # no state dir: unresolved
    try:
        assert wait_until(lambda: labels_at(out).get("nvidia.com/gpu.count") == "4")
        assert kernel_cache.RESOLVED_CACHE_DIR_ENV not in os.environ
        # The default build directory's state, as the epoch found it.
        assert obs_metrics.COMPILE_CACHE_ENABLED.value() == int(kernel_cache.kernel_cache_usable())
    finally:
        stop_daemon(t, sigs, result)


# ---------------------------------------------------------------------------
# start-up order: the restored snapshot first, the backend beside it
# ---------------------------------------------------------------------------

def test_restored_write_precedes_backend_readiness(tmp_path):
    state_dir = str(tmp_path / "state")
    assert LabelStateStore(state_dir).save(
        {"nvidia.com/gpu.count": "4", "nvidia.com/gpu.machine": "node"})
    config = cfg(tmp_path, **{"state-dir": state_dir})
    out = config.flags.tfd.output_file
    seen = {}

    def delayed_manager():
        seen["at_init"] = labels_at(out)
        seen["mtime_at_init"] = os.stat(out).st_mtime_ns if os.path.exists(out) else None
        time.sleep(0.3)  # a slow CUDA init or broker spawn
        seen["ready_walltime_ns"] = time.time_ns()
        return StaticCudaManager.mock_gpu(4)

    t, sigs, result = start_daemon(config, manager=delayed_manager)
    try:
        assert wait_until(lambda: labels_at(out).get("nvidia.com/gpu.count") == "4"
                          and RESTORED_LABEL not in labels_at(out)), labels_at(out)
    finally:
        stop_daemon(t, sigs, result)
    assert seen["at_init"].get(RESTORED_LABEL) == "true", seen["at_init"]
    assert seen["at_init"].get("nvidia.com/gpu.count") == "4"
    assert seen["mtime_at_init"] is not None
    assert seen["mtime_at_init"] < seen["ready_walltime_ns"]


# ---------------------------------------------------------------------------
# the broker pre-spawn
# ---------------------------------------------------------------------------

def test_prespawn_is_one_attempt_and_acquisition_reuses(tmp_path, monkeypatch):
    monkeypatch.setenv("TFD_BACKEND", "mock-gpu:4")
    config = cfg(tmp_path)
    try:
        sandbox.prespawn_broker(config).join(timeout=30)
        assert sandbox.get_broker(config).alive, "pre-spawn did not bring the worker up"
        assert obs_metrics.BACKEND_INIT_ATTEMPTS.value() == 1
        manager = sandbox.acquire_broker_manager(config)
        assert manager.get_chips()
        assert obs_metrics.BACKEND_INIT_ATTEMPTS.value() == 1
        assert obs_metrics.BROKER_RESPAWNS.value() == 0
    finally:
        sandbox.close_broker()


def test_prespawn_failure_is_contained(tmp_path, monkeypatch):
    monkeypatch.setenv("TFD_BACKEND", "mock-gpu:4")
    faults.load_fault_spec("pjrt_init:fail:1")
    config = cfg(tmp_path, **{"init-backoff-max": "0.001s"})
    try:
        sandbox.prespawn_broker(config).join(timeout=30)
        assert not sandbox.get_broker(config).alive
        time.sleep(0.01)  # the failed spawn's tiny backoff window
        assert sandbox.acquire_broker_manager(config).get_chips()
    finally:
        sandbox.close_broker()


def test_prespawn_after_close_refuses_to_spawn(tmp_path, monkeypatch):
    monkeypatch.setenv("TFD_BACKEND", "mock-gpu:4")
    config = cfg(tmp_path)
    client = sandbox.get_broker(config)
    sandbox.close_broker()
    client.prespawn()  # the stale thread's body, after the close
    assert not client.alive
    assert obs_metrics.BACKEND_INIT_ATTEMPTS.value() == 0


def test_daemon_prespawns_broker_only_without_faults(tmp_path, monkeypatch):
    monkeypatch.setenv("TFD_BACKEND", "mock-gpu:4")
    calls = []
    real = sandbox.prespawn_broker
    monkeypatch.setattr(sandbox, "prespawn_broker",
                        lambda config, backend=None: calls.append(1) or real(config, backend))
    out = cfg(tmp_path).flags.tfd.output_file
    t, sigs, result = start_daemon(cfg(tmp_path))
    try:
        assert wait_until(lambda: labels_at(out).get("nvidia.com/gpu.count") == "4", timeout=30)
        assert calls == [1], "a supervised broker epoch pre-spawns once"
    finally:
        stop_daemon(t, sigs, result)
    calls.clear()
    faults.load_fault_spec("pjrt_init:fail:1")
    t, sigs, result = start_daemon(cfg(tmp_path))
    try:
        assert wait_until(lambda: labels_at(out).get("nvidia.com/gpu.count") == "4", timeout=30)
        assert calls == [], "the pre-spawn stands down under injection"
    finally:
        stop_daemon(t, sigs, result)
