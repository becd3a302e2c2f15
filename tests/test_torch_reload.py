"""The twin's SIGHUP reload choreography (``tests/test_reload.py``) held
against the port's ``cmd/main.py:start``: a reload rebuilds the label
engine and closes the old one, and re-runs every per-epoch reset exactly
once per epoch; epoch close SIGKILLs an in-flight sandboxed call
(``sandbox.SandboxedCall.cancel``), closes the broker worker without a
respawn, and joins (or, wedged, abandons with a warning) the notify
sender. The twin's metadata-provider cache reset becomes the port's
fresh host-info provider per epoch (``new_interconnect_labeler``): the
port reads the environment, which it snapshots per provider.

Each case drives the port as the twin's drives the twin, with
``mock-gpu:4`` for ``mock:v4-8``; the sandboxed function is a
module-level one (``tests/torch_embedder.py``), since the port's probe
child is a fresh interpreter that imports it by name."""

import logging
import os
import queue
import signal
import subprocess
import threading
import time
from pathlib import Path

import pytest

from gpu_feature_discovery_tpu_torch.cmd import main as cmd_main
from gpu_feature_discovery_tpu_torch.lm.engine import LabelEngine, LabelSource
from gpu_feature_discovery_tpu_torch.lm.labels import Labels
from gpu_feature_discovery_tpu_torch.obs import metrics as obs_metrics
from gpu_feature_discovery_tpu_torch.peering.notify import NotifySender, NotifySubscriptions
from gpu_feature_discovery_tpu_torch.sandbox import SandboxedCall
from gpu_feature_discovery_tpu_torch.sandbox import broker as broker_mod
from gpu_feature_discovery_tpu_torch.utils import logging as tfd_logging
from torch_env_guard import resolved_cache_dir_restored  # noqa: F401 - autouse

HERE = Path(__file__).parent


def _counted(calls, key, fn):
    def wrapper(*args, **kwargs):
        calls[key] += 1
        return fn(*args, **kwargs)
    return wrapper


def _start_two_epochs(tmp_path, monkeypatch):
    sigs = queue.Queue()
    sigs.put(signal.SIGHUP)   # epoch 1: reload at the first phase boundary
    sigs.put(signal.SIGTERM)  # epoch 2: clean exit
    monkeypatch.setattr(cmd_main, "new_os_watcher", lambda: sigs)
    machine = tmp_path / "machine-type"
    machine.write_text("Test Node\n")
    return cmd_main.start(["--output-file", str(tmp_path / "tfd"),
                           "--machine-type-file", str(machine),
                           "--sleep-interval", "30s"])


def test_sighup_rebuilds_engine_and_reruns_epoch_resets(tmp_path, monkeypatch):
    monkeypatch.setenv("TFD_BACKEND", "mock-gpu:4")
    calls = {"engine": 0, "burnin": 0, "warn": 0, "hostinfo": 0}
    engine_closes = []
    real_new_engine = cmd_main.new_label_engine

    def counting_engine(config):
        calls["engine"] += 1
        engine = real_new_engine(config)
        real_close, closes = engine.close, []
        engine_closes.append(closes)

        def close():
            closes.append(True)
            real_close()

        engine.close = close
        return engine

    monkeypatch.setattr(cmd_main, "new_label_engine", counting_engine)
    monkeypatch.setattr(cmd_main, "reset_burnin_schedule",
                        _counted(calls, "burnin", cmd_main.reset_burnin_schedule))
    monkeypatch.setattr(tfd_logging, "reset_warn_once",
                        _counted(calls, "warn", tfd_logging.reset_warn_once))
    monkeypatch.setattr(cmd_main, "new_interconnect_labeler",
                        _counted(calls, "hostinfo", cmd_main.new_interconnect_labeler))
    try:
        assert _start_two_epochs(tmp_path, monkeypatch) == 0
    finally:
        broker_mod.close_broker()
    assert calls["engine"] == 2, "SIGHUP must rebuild the engine per epoch"
    assert [len(c) for c in engine_closes] == [1, 1]
    assert calls["burnin"] == 2, "burn-in schedule reset skipped on reload"
    assert calls["warn"] == 2, "warn-once reset skipped on reload"
    assert calls["hostinfo"] == 2, "host-info provider not rebuilt on reload"


def _wait_until(pred, timeout=5.0, interval=0.002):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return pred()


def _pid_alive(pid):
    try:
        os.kill(pid, 0)
        return True
    except OSError:
        return False


@pytest.fixture
def embedder_on_child_path(monkeypatch):
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        p for p in (str(HERE), os.environ.get("PYTHONPATH")) if p))


def test_engine_close_kills_inflight_probe_child(embedder_on_child_path):
    """A cycle aborted by one source's error leaves another source's
    sandboxed child in flight; epoch close must SIGKILL it."""
    import torch_embedder

    call = SandboxedCall(torch_embedder.sleep_forever, timeout_s=3600.0)

    class SandboxBacked:
        def labels(self):
            call()
            return Labels()

    def broken_produce():
        raise RuntimeError("sibling source failed; cycle aborts")

    engine = LabelEngine(parallel=True, timeout_s=30.0)
    sources = [LabelSource("broken", broken_produce),
               LabelSource("sandboxed", lambda: SandboxBacked(), cancel=call.cancel)]
    try:
        with pytest.raises(RuntimeError):
            engine.generate(sources)
        assert _wait_until(lambda: call._pids), "probe child never spawned"
        (pid,) = call._pids
        assert _pid_alive(pid), "the child should still be running mid-abort"
    finally:
        engine.close()
    assert _wait_until(lambda: not _pid_alive(pid)), \
        "engine.close() left the in-flight probe child alive"
    state = engine._state["sandboxed"]
    assert _wait_until(lambda: state.inflight.done()), \
        "worker thread still blocked after the child was killed"


def test_sighup_closes_broker_gracefully_no_respawn_storm(tmp_path, monkeypatch):
    monkeypatch.setenv("TFD_BACKEND", "mock-gpu:4")
    obs_metrics.reset_for_tests()
    assert _start_two_epochs(tmp_path, monkeypatch) == 0
    assert obs_metrics.BACKEND_INIT_ATTEMPTS.value() == 2, \
        "each epoch spawns exactly one broker worker"
    assert obs_metrics.BROKER_RESPAWNS.value() == 0, \
        "a reload killed the worker instead of closing it"
    assert obs_metrics.BROKER_UP.value() == 0, "the last epoch left the worker up"
    assert not broker_mod._active, "close_broker() skipped at epoch end"
    out = subprocess.run(["ps", "--ppid", str(os.getpid()), "-o", "stat="],
                         capture_output=True, text=True).stdout
    assert not [s for s in out.split() if s.startswith("Z")], \
        "broker workers left zombies across reload epochs"


def test_notify_sender_close_joins_idle_thread(caplog):
    sender = NotifySender(NotifySubscriptions(ttl_s=10.0), timeout=0.2)
    sender.publish(1, "etag-1")
    assert sender.flush(timeout=5.0), "the sender never went idle"
    with caplog.at_level(logging.WARNING):
        sender.close()
    assert sender._thread is not None and not sender._thread.is_alive()
    assert "abandoning" not in caplog.text


def test_notify_sender_close_abandons_wedged_thread_with_warn(caplog):
    sender = NotifySender(NotifySubscriptions(ttl_s=10.0), timeout=0.05)
    wedge = threading.Event()
    sender._deliver = lambda pending, seq: wedge.wait(30.0)
    sender.publish(1, "etag-1")
    assert _wait_until(lambda: sender._busy), "the delivery never started"
    started = time.monotonic()
    with caplog.at_level(logging.WARNING):
        sender.close()
    elapsed = time.monotonic() - started
    try:
        assert sender._thread.is_alive()
        assert elapsed < 5.0, "close() must stay bounded on a wedged sender"
        assert "abandoning" in caplog.text
    finally:
        wedge.set()
        sender._thread.join(timeout=5.0)
