"""The probe sandbox of the PyTorch port, on the CPU.

- The resolution table: ``isolation_mode``, ``broker_mode`` and
  ``broker_enabled`` give the twin's answer for every combination of
  oneshot, ``--with-burnin``, ``--probe-isolation`` and ``--probe-broker``,
  each config built through both packages' ``new_config``.
- Snapshot fidelity: labels from a SnapshotManager over a ``mock-gpu:2``
  snapshot, taken in a child process, equal the live manager's byte for
  byte.
- The probe child: ok, timeout (SIGKILL at the budget), crash (signal
  name and stderr tail), child error, no zombies, the stray sweep, and
  the chaos sites ``probe.timeout`` / ``probe.hang`` / ``probe.segv``.
- ``--probe-broker=off`` with subprocess isolation acquires one child per
  acquisition and publishes the broker daemon's bytes.
- A CLI daemon at its defaults keeps torch out of the labeling process,
  with the burn-in running in the broker worker.
"""

import itertools
import json
import os
import queue
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from gpu_feature_discovery_tpu import sandbox as twin_sandbox
from gpu_feature_discovery_tpu.config import new_config as twin_new_config
from gpu_feature_discovery_tpu_torch import sandbox
from gpu_feature_discovery_tpu_torch.cmd.main import run
from gpu_feature_discovery_tpu_torch.cmd.supervisor import DEGRADED_LABEL, Supervisor
from gpu_feature_discovery_tpu_torch.config.flags import new_config
from gpu_feature_discovery_tpu_torch.config.spec import config_from_dict, config_to_dict
from gpu_feature_discovery_tpu_torch.lm.engine import LabelEngine
from gpu_feature_discovery_tpu_torch.lm.labelers import new_label_sources
from gpu_feature_discovery_tpu_torch.resource import factory
from gpu_feature_discovery_tpu_torch.resource.cuda_backend import StaticCudaManager
from gpu_feature_discovery_tpu_torch.resource.types import ResourceError
from gpu_feature_discovery_tpu_torch.sandbox import (
    DeviceSnapshot,
    ProbeCrash,
    ProbeTimeout,
    SnapshotManager,
)
from gpu_feature_discovery_tpu_torch.sandbox import probe as probe_mod
from gpu_feature_discovery_tpu_torch.utils import faults

REPO = Path(__file__).parent.parent


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv(faults.FAULT_SPEC_ENV, raising=False)
    faults.reset()
    yield
    faults.reset()
    sandbox.close_broker()


def cfg(**cli):
    values = {"backends": "mock-gpu:2"}
    values.update(cli)
    return new_config(cli_values=values, environ={})


# ---------------------------------------------------------------------------
# the resolution table
# ---------------------------------------------------------------------------

UNSET = "unset"


@pytest.mark.parametrize(
    "oneshot,burnin,isolation,broker",
    list(itertools.product(
        [False, True], [False, True],
        [UNSET, "none", "subprocess", "auto"],
        [UNSET, "on", "off", "auto"],
    )),
)
def test_resolution_table_matches_twin(oneshot, burnin, isolation, broker):
    values = {"oneshot": oneshot, "with-burnin": burnin}
    if isolation != UNSET:
        values["probe-isolation"] = isolation
    if broker != UNSET:
        values["probe-broker"] = broker
    got = new_config(cli_values=values, environ={})
    want = twin_new_config(cli_values=values, environ={})
    assert (
        sandbox.isolation_mode(got),
        sandbox.broker_mode(got),
        sandbox.broker_enabled(got),
    ) == (
        twin_sandbox.isolation_mode(want),
        twin_sandbox.broker_mode(want),
        twin_sandbox.broker_enabled(want),
    )


def test_daemon_defaults_resolve_to_the_broker():
    daemon = cfg(**{"with-burnin": True})
    assert sandbox.isolation_mode(daemon) == "subprocess"
    assert sandbox.broker_enabled(daemon)
    for config in (cfg(oneshot=True, **{"with-burnin": True}),
                   cfg(**{"with-burnin": True, "probe-broker": "off"})):
        assert sandbox.isolation_mode(config) == "none"
        assert not sandbox.broker_enabled(config)


def test_config_round_trips_as_the_first_frame():
    config = cfg(**{"with-burnin": True, "probe-timeout": "1.5s",
                    "broker-max-requests": "7", "sleep-interval": "2s"})
    doc = json.loads(json.dumps(config_to_dict(config)))
    assert config_from_dict(doc) == config
    assert config.flags.tfd.probe_timeout == 1.5
    assert config.flags.tfd.broker_max_requests == 7


# ---------------------------------------------------------------------------
# snapshot fidelity
# ---------------------------------------------------------------------------

def _label_bytes(manager, config, path):
    labels = LabelEngine(parallel=False).generate(new_label_sources(manager, config))
    labels.write_to_file(str(path))
    return path.read_bytes()


@pytest.mark.parametrize("count", [1, 2])
def test_snapshot_labels_identical_to_live_manager(tmp_path, count):
    config = cfg(backends=f"mock-gpu:{count}", **{"no-timestamp": True})
    live = _label_bytes(StaticCudaManager.mock_gpu(count), config, tmp_path / "live")
    snap = sandbox.probe_device_snapshot(config, 10.0)
    got = _label_bytes(SnapshotManager(snap), config, tmp_path / "snap")
    assert got == live
    assert f"nvidia.com/gpu.count={count}".encode() in got


def test_snapshot_json_round_trip_and_version_gate():
    manager = StaticCudaManager.mock_gpu(2)
    manager.init()
    snap = DeviceSnapshot.from_manager(manager)
    doc = json.loads(json.dumps(snap.to_dict()))
    assert DeviceSnapshot.from_dict(doc).to_dict() == snap.to_dict()
    doc["version"] = 999
    with pytest.raises(ResourceError):
        DeviceSnapshot.from_dict(doc)
    empty = DeviceSnapshot.from_manager(StaticCudaManager.mock_gpu(2))  # not inited
    assert empty.chips == [] and empty.driver_version == ""


# ---------------------------------------------------------------------------
# the probe child
# ---------------------------------------------------------------------------

def test_run_probe_ok_round_trips_payload():
    result = probe_mod.run_probe("select+snapshot", cfg(), 10.0)
    assert result.status == "ok"
    assert len(result.payload["chips"]) == 2


def test_run_probe_timeout_kills_within_budget():
    t0 = time.monotonic()
    result = probe_mod.run_probe("snapshot", cfg(), 0.5, hang=True)
    assert result.status == "timeout"
    # Budget + kill/reap slack; a broken kill path would hang forever.
    assert time.monotonic() - t0 < 0.5 + 5.0


def test_run_probe_crash_reports_signal_and_stderr_tail():
    result = probe_mod.run_probe("snapshot", cfg(), 10.0, segv=True)
    assert result.status == "crash"
    assert result.term_signal == signal.SIGSEGV


def test_run_probe_child_error_ships_type_and_message():
    result = probe_mod.run_probe("no-such-op", cfg(), 10.0)
    assert result.status == "error"
    assert result.error_type == "KeyError" and "no-such-op" in result.error


def test_run_probe_leaves_no_zombies_and_the_sweep_kills_strays():
    for _ in range(3):
        assert probe_mod.run_probe("snapshot", cfg(), 10.0).status == "ok"
    box, done = [], {}
    t = threading.Thread(
        target=lambda: done.update(r=probe_mod.run_probe(
            "snapshot", cfg(), 30.0, hang=True, pid_box=box)),
        daemon=True,
    )
    t.start()
    deadline = time.monotonic() + 5
    while not box and time.monotonic() < deadline:
        time.sleep(0.01)
    assert box, "probe child never spawned"
    assert sandbox.kill_stray_children() == 1
    t.join(10)
    assert done["r"].status in ("crash", "timeout", "error")
    out = subprocess.run(["ps", "--ppid", str(os.getpid()), "-o", "stat="],
                         capture_output=True, text=True).stdout
    assert not [s for s in out.split() if s.startswith("Z")]


def test_probe_device_snapshot_chaos_sites():
    faults.load_fault_spec("probe.timeout:fail:1,probe.hang:fail:1,probe.segv:fail:1")
    config = cfg()
    t0 = time.monotonic()
    with pytest.raises(ProbeTimeout):
        sandbox.probe_device_snapshot(config, 5.0)  # synthesised, no child
    assert time.monotonic() - t0 < 1.0
    with pytest.raises(ProbeTimeout):
        sandbox.probe_device_snapshot(config, 0.5)  # real hang, real SIGKILL
    with pytest.raises(ProbeCrash, match="SIGSEGV"):
        sandbox.probe_device_snapshot(config, 5.0)  # real SIGSEGV
    assert len(sandbox.probe_device_snapshot(config, 5.0).chips) == 2


def test_acquire_snapshot_manager_fires_pjrt_init_in_the_parent():
    faults.load_fault_spec("pjrt_init:fail:1")
    with pytest.raises(faults.FaultInjected):
        sandbox.acquire_snapshot_manager(cfg(), 5.0)
    manager = sandbox.acquire_snapshot_manager(cfg(), 5.0)
    assert len(manager.get_chips()) == 2 and manager.get_driver_version() == "1.9.0"


# ---------------------------------------------------------------------------
# the daemon with subprocess isolation and the broker off
# ---------------------------------------------------------------------------

def _daemon_bytes(tmp_path, tag, broker):
    out = tmp_path / f"tfd-{tag}"
    config = cfg(**{"no-timestamp": True, "output-file": str(out),
                    "sleep-interval": "5s", "probe-broker": broker,
                    "probe-isolation": "subprocess"})
    sigs = queue.SimpleQueue()
    result = {}
    t = threading.Thread(target=lambda: result.update(restart=run(
        lambda: factory.build_manager(config), config, sigs,
        supervisor=Supervisor(config))))
    t.start()
    try:
        deadline = time.monotonic() + 15
        while time.monotonic() < deadline and not out.exists():
            time.sleep(0.005)
        data = out.read_bytes()
        active = sandbox.broker._active
    finally:
        sigs.put(signal.SIGTERM)
        t.join(15)
    assert not t.is_alive() and result["restart"] is False
    return data, active


def test_probe_broker_off_acquires_per_child_and_matches_the_broker(tmp_path):
    off, active = _daemon_bytes(tmp_path, "off", "off")
    assert active is None, "--probe-broker=off must never create a broker"
    on, active = _daemon_bytes(tmp_path, "on", "on")
    assert active is not None
    assert on == off
    assert b"nvidia.com/gpu.count=2" in on and DEGRADED_LABEL.encode() not in on


# ---------------------------------------------------------------------------
# the labeling process stays torch-free under the broker
# ---------------------------------------------------------------------------

_TORCH_FREE_DAEMON = r"""
import json, os, signal, sys, threading, time
from gpu_feature_discovery_tpu_torch.cmd.main import start

out = sys.argv[1]
seen = {}

def watch():
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        try:
            text = open(out).read()
        except OSError:
            text = ""
        if "nvidia.com/gpu.health.ok=true" in text:
            seen["labels"] = text
            break
        time.sleep(0.02)
    seen["torch"] = sorted(m for m in sys.modules if m.split(".")[0] == "torch")
    os.kill(os.getpid(), signal.SIGTERM)

threading.Thread(target=watch, daemon=True).start()
rc = start(["--with-burnin", "--backends", "mock-gpu:2", "--sleep-interval",
            "0.1s", "--output-file", out])
print(json.dumps({"rc": rc, **seen}))
"""


def test_cli_daemon_at_defaults_keeps_torch_out_of_the_labeling_process(tmp_path):
    out = tmp_path / "tfd"
    env = dict(os.environ, TFD_BURNIN_ALLOW_CPU="1", TFD_BURNIN_GEOMETRY="128x2")
    env.pop(faults.FAULT_SPEC_ENV, None)
    proc = subprocess.run(
        [sys.executable, "-c", _TORCH_FREE_DAEMON, str(out)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    doc = json.loads(proc.stdout.strip().splitlines()[-1])
    assert doc["rc"] == 0
    assert "labels" in doc, f"no health labels; log:\n{proc.stderr[-3000:]}"
    assert "nvidia.com/gpu.chips.healthy=1" in doc["labels"]
    assert doc["torch"] == [], "the labeling process imported torch"
    assert "broker worker" in proc.stderr and not out.exists()


# ---------------------------------------------------------------------------
# SandboxedCall: the twin's seam behind LabelSource.cancel
# (tests/test_sandbox.py of the twin). The function is a module-level one
# of tests/torch_embedder.py, which the fresh child imports by name.
# ---------------------------------------------------------------------------

@pytest.fixture
def embedder_on_child_path(monkeypatch):
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        p for p in (str(REPO / "tests"), os.environ.get("PYTHONPATH")) if p))


def _pid_alive(pid):
    try:
        os.kill(pid, 0)
        return True
    except OSError:
        return False


def _wait_until(pred, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline and not pred():
        time.sleep(0.002)
    return pred()


def test_sandboxed_call_runs_in_a_child_and_returns_its_dict(embedder_on_child_path):
    import torch_embedder

    out = sandbox.SandboxedCall(torch_embedder.answer, timeout_s=30.0)()
    assert out["answer"] == 42 and out["pid"] != os.getpid()


def test_sandboxed_call_refuses_what_a_fresh_interpreter_cannot_import():
    """The twin forks and runs any closure; the port's child is a fresh
    interpreter, so a lambda or a nested function is refused in the
    caller, before any child is spawned."""
    def nested():
        return {}

    for fn in (lambda: {}, nested):
        with pytest.raises(TypeError):
            sandbox.SandboxedCall(fn, timeout_s=1.0)
    assert twin_sandbox.SandboxedCall(lambda: {}, timeout_s=1.0) is not None


def test_sandboxed_call_timeout_and_error_are_the_twins_types(embedder_on_child_path):
    import torch_embedder

    with pytest.raises(ProbeTimeout, match="exceeded"):
        sandbox.SandboxedCall(torch_embedder.sleep_a_minute, timeout_s=0.5)()
    with pytest.raises(ResourceError, match="RuntimeError: the function failed in its child"):
        sandbox.SandboxedCall(torch_embedder.fail, timeout_s=30.0)()


def test_sandboxed_call_cancel_kills_inflight_child(embedder_on_child_path):
    import torch_embedder

    call = sandbox.SandboxedCall(torch_embedder.sleep_a_minute, timeout_s=30.0)
    result = {}

    def target():
        try:
            call()
        except BaseException as e:  # noqa: BLE001 - inspected below
            result["error"] = e

    t = threading.Thread(target=target, daemon=True)
    t.start()
    assert _wait_until(lambda: call._pids), "the child never spawned"
    (pid,) = call._pids
    assert _pid_alive(pid)
    call.cancel()
    t.join(timeout=5)
    assert not t.is_alive(), "the worker thread stayed blocked after cancel"
    assert not _pid_alive(pid)
    assert isinstance(result.get("error"), ResourceError)


def test_engine_deadline_miss_escalates_to_child_sigkill(embedder_on_child_path):
    """A sandbox-backed source that misses its deadline gets its child
    SIGKILLed: the worker thread frees, the self-inflicted death is
    swallowed at harvest, and the source runs fresh next cycle."""
    import torch_embedder
    from gpu_feature_discovery_tpu_torch.lm.engine import LabelSource
    from gpu_feature_discovery_tpu_torch.lm.labels import Labels
    from gpu_feature_discovery_tpu_torch.obs import metrics as obs_metrics

    obs_metrics.reset_for_tests()
    calls = {"n": 0}
    call = sandbox.SandboxedCall(torch_embedder.sleep_forever, timeout_s=3600.0)

    class SandboxBacked:
        def labels(self):
            calls["n"] += 1
            if calls["n"] == 1:
                call()
            return Labels({"probed": "fresh"})

    # The twin's 0.5 s deadline: the child must exist when cancel fires.
    engine = LabelEngine(parallel=True, timeout_s=0.5)
    sources = [LabelSource("sandboxed", lambda: SandboxBacked(), cancel=call.cancel)]
    try:
        first = engine.generate(sources)
        assert "probed" not in first
        assert obs_metrics.PROBE_KILLS.value() == 1, "the deadline miss killed no child"
        state = engine._state["sandboxed"]
        assert _wait_until(lambda: state.inflight.done()), "worker thread still wedged"
        second = engine.generate(sources)
        assert second.get("probed") == "fresh"
    finally:
        engine.close()
