"""The twin's process-level CLI tier (``tests/test_cli_process.py``) held
against the port: ``python -m gpu_feature_discovery_tpu_torch`` as a
process, driven as the reference's integration harness drives the
container. The golden oneshot, the exact MIG golden through the process
path, the env aliases, SIGTERM's clean-up, SIGHUP's reload (of the
config file too), a bad flag's exit, ``--version``, a signal storm and a
HUP/TERM race.

The environment is hermetic (no ``TFD_*``, ``WORKER_*`` or accelerator
keys of the host), the backend the port's mock (``mock-gpu``,
``mock-nvml:<layout>``) where the twin's is ``mock:v4-8``, and the
introspection server is off (``TFD_METRICS_PORT=0``): these daemons run
beside other test files and must not race them for a port."""

import os
import re
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).parent.parent
HERE = REPO / "tests"

# The host facts the port publishes beside the twin's gpu family.
HOST_FACTS_GOLDEN = [r"nvidia\.com\/gpu\.machine=[A-Za-z0-9._-]+",
                     r"nvidia\.com\/gpu\.slice\.capable=false"]


def spawn(tmp_path, *args, backend="mock-gpu:2", env_extra=None):
    env = {k: v for k, v in os.environ.items()
           if not (k.startswith(("TPU_", "TFD_", "WORKER_"))
                   or k in ("ACCELERATOR_TYPE", "TOPOLOGY", "HOST_BOUNDS",
                            "CHIPS_PER_HOST_BOUNDS", "WRAP", "MACHINE_TYPE"))}
    env["PYTHONPATH"] = str(REPO)
    env["TFD_BACKEND"] = backend
    env["TFD_METRICS_PORT"] = "0"
    env.update(env_extra or {})
    # File-backed output, never pipes: a reload storm's log lines would
    # fill a pipe nobody drains and block the daemon in a write.
    stdout_f, stderr_f = tempfile.TemporaryFile(), tempfile.TemporaryFile()
    proc = subprocess.Popen([sys.executable, "-m", "gpu_feature_discovery_tpu_torch", *args],
                            env=env, cwd=str(tmp_path), stdout=stdout_f, stderr=stderr_f)
    proc.stdout, proc.stderr = _Captured(stdout_f), _Captured(stderr_f)
    return proc


class _Captured:
    def __init__(self, f):
        self._f = f

    def read(self):
        return os.pread(self._f.fileno(), 1 << 24, 0)


def wait_for_file(path, timeout=15.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if os.path.exists(path):
            return True
        time.sleep(0.05)
    return False


def _matches(lines, golden):
    for line in lines:
        assert any(re.fullmatch(g, line) for g in golden if g), f"unexpected: {line}"
    assert len(lines) == len([g for g in golden if g])


def test_cli_oneshot_writes_golden_parity_file(tmp_path):
    out = tmp_path / "tfd"
    proc = spawn(tmp_path, "--oneshot", "--machine-type-file", "", "-o", str(out))
    assert proc.wait(timeout=60) == 0, proc.stderr.read().decode()
    golden = (HERE / "expected-output-gpu-mock.txt").read_text().splitlines() + HOST_FACTS_GOLDEN
    _matches(out.read_text().splitlines(), golden)


def test_cli_mig_single_strategy_exact(tmp_path):
    """The exact MIG golden through the real process path: four 3g.40gb
    devices under ``single``, every number pinned."""
    machine = tmp_path / "machine-type"
    machine.write_text("Test Node\n")
    out = tmp_path / "tfd"
    proc = spawn(tmp_path, "--oneshot", "--no-timestamp", "--tpu-topology-strategy", "single",
                 "--machine-type-file", str(machine), "-o", str(out),
                 backend="mock-nvml:single")
    assert proc.wait(timeout=60) == 0, proc.stderr.read().decode()
    want = (HERE / "torch-expected-output-exact-h100-mig-single.txt").read_text().splitlines()
    assert sorted(out.read_text().splitlines()) == sorted(l for l in want if l)


def test_cli_env_flag_aliases(tmp_path):
    out = tmp_path / "tfd"
    proc = spawn(tmp_path, "--machine-type-file", "", "-o", str(out), backend="mock-nvml:single",
                 env_extra={"TFD_ONESHOT": "true", "TPU_TOPOLOGY_STRATEGY": "single"})
    assert proc.wait(timeout=60) == 0, proc.stderr.read().decode()
    content = out.read_text()
    assert "nvidia.com/gpu.topology.strategy=single" in content
    assert "nvidia.com/gpu.product=nvidia-h100-80gb-hbm3-MIG-3g.40gb" in content


def test_cli_daemon_sigterm_removes_output(tmp_path):
    out = tmp_path / "tfd"
    proc = spawn(tmp_path, "--machine-type-file", "", "-o", str(out), "--sleep-interval", "60s")
    try:
        assert wait_for_file(out), proc.stderr.read().decode() if proc.poll() else "no file"
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
        assert not out.exists()
    finally:
        if proc.poll() is None:
            proc.kill()


def test_cli_sighup_reloads_and_keeps_running(tmp_path):
    out = tmp_path / "tfd"
    proc = spawn(tmp_path, "--machine-type-file", "", "-o", str(out), "--sleep-interval", "60s")
    try:
        assert wait_for_file(out)
        first = out.stat().st_mtime_ns
        proc.send_signal(signal.SIGHUP)
        deadline, rewritten = time.time() + 20, False
        while time.time() < deadline:
            if proc.poll() is not None:
                raise AssertionError(f"daemon exited on SIGHUP: {proc.stderr.read().decode()}")
            if out.exists() and out.stat().st_mtime_ns != first:
                rewritten = True
                break
            time.sleep(0.05)
        assert rewritten, "SIGHUP did not trigger a config reload and a rewrite"
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            proc.wait(timeout=15)
        except subprocess.TimeoutExpired:
            proc.kill()


def test_cli_bad_strategy_exits_nonzero(tmp_path):
    proc = spawn(tmp_path, "--oneshot", "--tpu-topology-strategy", "bogus")
    assert proc.wait(timeout=60) == 1
    assert b"invalid tpu-topology-strategy" in proc.stderr.read()


def test_cli_version_flag(tmp_path):
    proc = spawn(tmp_path, "--version")
    assert proc.wait(timeout=60) == 0
    assert re.match(rb"\d+\.\d+\.\d+", proc.stdout.read().strip())


def test_cli_sighup_picks_up_config_file_changes(tmp_path):
    out = tmp_path / "tfd"
    cfg = tmp_path / "config.yaml"
    cfg.write_text("version: v1\nsharing:\n  timeSlicing:\n    resources:\n"
                   "      - name: nvidia.com/gpu\n        replicas: 4\n")
    proc = spawn(tmp_path, "--machine-type-file", "", "-o", str(out), "--sleep-interval", "60s",
                 "--config-file", str(cfg))
    try:
        assert wait_for_file(out)
        assert "nvidia.com/gpu.replicas=4" in out.read_text()
        cfg.write_text("version: v1\n")  # sharing removed
        proc.send_signal(signal.SIGHUP)
        deadline = time.time() + 20
        while time.time() < deadline:
            assert proc.poll() is None, proc.stderr.read().decode()
            if out.exists() and "nvidia.com/gpu.replicas=1" in out.read_text():
                break
            time.sleep(0.1)
        content = out.read_text()
        assert "nvidia.com/gpu.replicas=1" in content and "-SHARED" not in content
    finally:
        if proc.poll() is None:
            proc.kill()


def test_cli_signal_storm_survives_and_cleans_up(tmp_path):
    """Thirty SIGHUPs during active cycles: no crash, no wedge; a final
    SIGTERM still exits cleanly and removes the file."""
    out = tmp_path / "tfd"
    proc = spawn(tmp_path, "--machine-type-file", "", "-o", str(out), "--sleep-interval", "100ms")
    try:
        assert wait_for_file(out), (
            proc.stderr.read().decode() if proc.poll() is not None else "no file")
        for _ in range(30):
            proc.send_signal(signal.SIGHUP)
            time.sleep(0.02)
            assert proc.poll() is None, f"daemon died mid-storm: {proc.stderr.read().decode()}"
        # Every queued SIGHUP removes the file in its reload transition
        # (the reference's behaviour): poll for it, as the twin does.
        assert proc.poll() is None
        assert wait_for_file(out, timeout=15), "daemon stopped labeling after the storm: " + (
            proc.stderr.read().decode() if proc.poll() is not None else "")
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0, proc.stderr.read().decode()
        assert not out.exists()
        assert "Traceback" not in proc.stderr.read().decode()
    finally:
        if proc.poll() is None:
            proc.kill()


def test_cli_interleaved_hup_term_race(tmp_path):
    out = tmp_path / "tfd"
    proc = spawn(tmp_path, "--machine-type-file", "", "-o", str(out), "--sleep-interval", "100ms")
    try:
        assert wait_for_file(out)
        proc.send_signal(signal.SIGHUP)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0, proc.stderr.read().decode()
        assert not out.exists()
    finally:
        if proc.poll() is None:
            proc.kill()
