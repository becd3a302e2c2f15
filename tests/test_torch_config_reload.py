"""Live reload of the port's config file (cmd/events.ConfigFileWatcher and
the ``config_changed`` wake of cmd/main.run) against the twin, on the CPU.

- The watcher posts exactly one ``config_changed`` event on an atomic
  rename, on a symlink swap (a ConfigMap remount) and on a file that comes
  back after it was gone, as the twin's does, and none for an untouched
  file.
- Under ``--reconcile=event`` a changed file ends the epoch for a reload,
  counted once; under ``--reconcile=interval`` only SIGHUP reloads.
- A running CLI on mock backends, started from a config file, reloads on
  an atomic rename: the new replicas, the cpu family and its worker gone,
  one ``config_changed`` wake on ``/metrics``.
"""

import os
import queue
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from gpu_feature_discovery_tpu.cmd import events as twin_events
from gpu_feature_discovery_tpu_torch import sandbox
from gpu_feature_discovery_tpu_torch.cmd import events, main
from gpu_feature_discovery_tpu_torch.cmd.supervisor import Supervisor
from gpu_feature_discovery_tpu_torch.config import flags
from gpu_feature_discovery_tpu_torch.lm.labeler import Empty
from gpu_feature_discovery_tpu_torch.obs import metrics
from gpu_feature_discovery_tpu_torch.resource import factory

from test_torch_obs_daemon import _free_port, _scrape

REPO = Path(__file__).resolve().parent.parent
POLL_S = 0.05


def _replace(path: Path, text: str, how: str) -> None:
    """Change the file the way a deployment does."""
    if how == "rename":
        tmp = path.with_name(path.name + ".new")
        tmp.write_text(text)
        os.replace(tmp, path)
    elif how == "symlink":
        # A ConfigMap volume: the file is a link into a data directory
        # that is swapped whole.
        data = path.parent / f"..data-{time.monotonic_ns()}"
        data.mkdir()
        (data / "tfd.yaml").write_text(text)
        link = path.with_name(path.name + ".link")
        link.symlink_to(data / "tfd.yaml")
        os.replace(link, path)
    elif how == "comes-back":
        path.unlink()
        time.sleep(POLL_S * 4)
        path.write_text(text)
    else:
        raise AssertionError(how)


def _events_after(watcher_cls, queue_cls, path, how, settle):
    q = queue_cls()
    watcher = watcher_cls(str(path), q, poll_s=POLL_S).start()
    try:
        if how != "untouched":
            _replace(path, "version: v1\nflags: {tfd: {noTimestamp: true}}\n", how)
        time.sleep(settle)
    finally:
        watcher.stop()
    posted = []
    while True:
        event = q.get_nowait()
        if event is None:
            return posted
        posted.append((event.reason, event.detail))


@pytest.mark.parametrize("how", ["rename", "symlink", "comes-back", "untouched"])
def test_the_watcher_posts_once_per_change_like_the_twin(tmp_path, how):
    got = []
    for name, watcher_cls, queue_cls in (
        ("port", events.ConfigFileWatcher, events.EventQueue),
        ("twin", twin_events.ConfigFileWatcher, twin_events.EventQueue),
    ):
        d = tmp_path / name
        d.mkdir()
        path = d / "tfd.yaml"
        if how == "symlink":
            first = d / "..data-0"
            first.mkdir()
            (first / "tfd.yaml").write_text("version: v1\n")
            path.symlink_to(first / "tfd.yaml")
        else:
            path.write_text("version: v1\n")
        posted = _events_after(watcher_cls, queue_cls, path, how, settle=POLL_S * 8)
        got.append([(reason, Path(detail).name) for reason, detail in posted])
    assert got[0] == got[1]
    want = [] if how == "untouched" else [(events.REASON_CONFIG_CHANGED, "tfd.yaml")]
    assert got[0] == want
    assert events.REASON_CONFIG_CHANGED == twin_events.REASON_CONFIG_CHANGED


def _epoch(tmp_path, reconcile, path):
    config = flags.new_config(cli_values={
        "backends": "mock-gpu:2", "sleep-interval": "0.05s", "metrics-port": "0",
        "probe-isolation": "none", "reconcile": reconcile,
        "output-file": str(tmp_path / "tfd")}, environ={}, config_file=str(path))
    sigs = queue.SimpleQueue()
    result = {}
    t = threading.Thread(target=lambda: result.update(restart=main.run(
        lambda: factory.build_manager(config), config, sigs,
        supervisor=Supervisor(config), interconnect=Empty(),
        config_file=str(path))), daemon=True)
    t.start()
    deadline = time.monotonic() + 30
    while not (tmp_path / "tfd").exists() and time.monotonic() < deadline:
        time.sleep(0.01)
    return t, sigs, result


@pytest.mark.parametrize("reconcile", ["event", "interval"])
def test_a_changed_file_reloads_under_event_and_waits_for_sighup_under_interval(
        tmp_path, monkeypatch, reconcile):
    monkeypatch.setattr(events, "CONFIG_POLL_S", POLL_S)
    metrics.reset_for_tests()
    path = tmp_path / "tfd.yaml"
    path.write_text("version: v1\n")
    t, sigs, result = _epoch(tmp_path, reconcile, path)
    try:
        _replace(path, "version: v1\nflags: {tfd: {noTimestamp: true}}\n", "rename")
        t.join(POLL_S * 20)
        if reconcile == "event":
            assert not t.is_alive() and result["restart"] is True
        else:
            assert t.is_alive(), "interval mode reloaded without SIGHUP"
            sigs.put(signal.SIGHUP)
            t.join(15)
            assert not t.is_alive() and result["restart"] is True
    finally:
        if t.is_alive():
            sigs.put(signal.SIGTERM)
            t.join(15)
    wakes = metrics.RECONCILE_WAKES.value(reason=events.REASON_CONFIG_CHANGED)
    assert wakes == (1 if reconcile == "event" else 0)


# ---------------------------------------------------------------------------
# the CLI, reloaded live
# ---------------------------------------------------------------------------

_FILE = """\
version: v1
flags:
  tfd:
    sleepInterval: 0.2s
    backends: {backends}
    metricsAddr: 127.0.0.1
    metricsPort: {port}
    outputFile: {out}
sharing:
  timeSlicing:
    resources:
    - name: nvidia.com/gpu
      replicas: {replicas}
"""


def _labels(path):
    try:
        return dict(l.split("=", 1) for l in Path(path).read_text().splitlines() if "=" in l)
    except FileNotFoundError:
        return {}


def _children(pid):
    kids = []
    for entry in os.listdir("/proc"):
        if entry.isdigit():
            try:
                stat = Path(f"/proc/{entry}/stat").read_text()
            except OSError:
                continue
            fields = stat.rsplit(")", 1)[1].split()
            if int(fields[1]) == pid and fields[0] != "Z":
                kids.append(int(entry))
    return kids


def _wait(what, cond, timeout, log):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        value = cond()
        if value:
            return value
        time.sleep(0.05)
    raise AssertionError(f"{what} within {timeout}s\n{Path(log).read_text()[-4000:]}")


def test_a_running_cli_reloads_on_an_atomic_rename(tmp_path):
    port = _free_port()
    out = tmp_path / "tfd"
    log = tmp_path / "log"
    path = tmp_path / "tfd.yaml"
    path.write_text(_FILE.format(backends="mock-gpu:2,mock-cpu:3", port=port,
                                 out=out, replicas=4))
    env = dict(os.environ)
    env.pop("TFD_BACKEND", None)
    env.pop("TFD_FAULT_SPEC", None)
    with open(log, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, "-m", "gpu_feature_discovery_tpu_torch",
             "--config-file", str(path), "--no-timestamp", "true"],
            cwd=REPO, env=env, stdout=f, stderr=subprocess.STDOUT)
    try:
        first = _wait("both families", lambda: (lambda l: l if (
            l.get("nvidia.com/gpu.count") == "2"
            and l.get("node.features/cpu.count") == "3") else None)(_labels(out)),
            90, log)
        # The file took effect; the CLI's --no-timestamp beat the file.
        assert first["nvidia.com/gpu.replicas"] == "4"
        assert first["nvidia.com/gpu.product"] == "mock-gpu-SHARED"
        assert "google.com/tfd.timestamp" not in first
        assert len(_children(proc.pid)) == 2, "one worker per family"
        _replace(path, _FILE.format(backends="mock-gpu:2", port=port, out=out,
                                    replicas=2), "rename")
        reloaded = _wait("the reloaded labels", lambda: (lambda l: l if (
            l.get("nvidia.com/gpu.replicas") == "2") else None)(_labels(out)), 90, log)
        assert not any(k.startswith("node.features/") for k in reloaded)
        _wait("the cpu worker gone", lambda: len(_children(proc.pid)) == 1, 15, log)
        scraped = _wait("a scrape", lambda: _scrape(port), 15, log)
        assert scraped[("tfd_reconcile_wakes_total", '{reason="config_changed"}')] == 1
        assert "Config file changed, restarting." in log.read_text()
    finally:
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
        rc = proc.wait(30)
    assert rc == 0
    assert not out.exists()
    sandbox.close_broker()
