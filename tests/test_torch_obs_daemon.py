"""The port's daemon scraped live over HTTP, on the CPU, against its JAX
twin (twin: tests/test_obs.py's acceptance scrape).

- Under ``TFD_FAULT_SPEC=pjrt_init:fail:2`` the port's CLI
  (``--with-burnin --backends mock-gpu:2``, the broker at its default)
  and the twin's supervised loop on its mock backend both show
  ``tfd_backend_init_failures_total`` 2, ``tfd_degraded`` going 1 -> 0
  and the same ``tfd_cycles_total{outcome}`` at the same cycle count.
- Through the port's broker: a ``broker.hang`` shot is one kill, a
  ``broker.crash`` shot one respawn, a ``chip.1.sick`` shot a
  ``tfd_chip_ok{chip="1"}`` of 0 for one probe, then 1. ``POST /probe``
  with the token is one ``probe_request`` wake. After SIGHUP the same
  port answers for the new epoch; after SIGTERM it refuses.
- Under MIG (FakeNvml ``mixed`` and ``half``) no ``tfd_chip_*`` series
  is set, in process and through the broker; ``none`` keeps them.
- Sockets: oneshot and ``--metrics-port 0`` open none; a taken port
  degrades to no server with one warning and binds once it is free.
"""

import http.client
import logging
import os
import queue
import re
import signal
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from promtool_lite import validate_exposition

from gpu_feature_discovery_tpu.obs import metrics as twin_metrics
from gpu_feature_discovery_tpu_torch.cmd import main as cmd_main
from gpu_feature_discovery_tpu_torch.config.flags import new_config
from gpu_feature_discovery_tpu_torch.obs import metrics
from gpu_feature_discovery_tpu_torch.obs.server import IntrospectionServer
from gpu_feature_discovery_tpu_torch.resource.cuda_backend import (
    CudaManager,
    StaticCudaManager,
)
from gpu_feature_discovery_tpu_torch.resource.testing import fake_nvml
from gpu_feature_discovery_tpu_torch.sandbox.broker import BrokerManager

from test_torch_nvml import _FakeBrokerClient, _health_cycle, fake_torch_cuda  # noqa: F401
from torch_mig_fakes import MigWorkers
from torch_env_guard import resolved_cache_dir_restored  # noqa: F401 - autouse

REPO = Path(__file__).resolve().parent.parent
_SAMPLE = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{.*\})? (\S+)$")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _request(port, method, path, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
    try:
        conn.request(method, path, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, resp.read().decode()
    finally:
        conn.close()


def _samples(body):
    """{(name, labels): value} of one exposition."""
    out = {}
    for line in body.splitlines():
        m = _SAMPLE.match(line)
        if m and not line.startswith("#"):
            out[(m.group(1), m.group(2) or "")] = float(m.group(3))
    return out


def _scrape(port):
    """The samples of one /metrics scrape, or None while nothing listens."""
    try:
        code, body = _request(port, "GET", "/metrics")
    except OSError:
        return None
    assert code == 200
    validate_exposition(body)
    return _samples(body)


def _cycles(samples):
    return {labels: v for (name, labels), v in samples.items()
            if name == "tfd_cycles_total"}


def _wait_for(what, cond, timeout, log=None, poll=0.01):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        value = cond()
        if value:
            return value
        time.sleep(poll)
    tail = Path(log).read_text()[-4000:] if log else ""
    raise AssertionError(f"{what} within {timeout}s\n{tail}")


class _Cli:
    """The port's CLI in a subprocess with its introspection server on a
    free port of 127.0.0.1."""

    def __init__(self, tmp_path, name, fault_spec="", extra=(), env=None):
        self.port = _free_port()
        self.out = tmp_path / f"{name}.tfd"
        self.log = tmp_path / f"{name}.log"
        environ = dict(os.environ, TFD_BURNIN_ALLOW_CPU="1",
                       TFD_BURNIN_GEOMETRY="64x1", TFD_FAULT_SPEC=fault_spec,
                       **(env or {}))
        environ.pop("TFD_BACKEND", None)
        with open(self.log, "w") as log:
            self.proc = subprocess.Popen(
                [sys.executable, "-m", "gpu_feature_discovery_tpu_torch",
                 "--with-burnin", "--backends", "mock-gpu:2",
                 "--output-file", str(self.out), "--metrics-addr", "127.0.0.1",
                 "--metrics-port", str(self.port), *extra],
                cwd=REPO, env=environ, stdout=log, stderr=subprocess.STDOUT,
            )

    def scrape(self):
        return _scrape(self.port)

    def wait(self, what, cond, timeout=60.0):
        def check():
            samples = self.scrape()
            return samples is not None and cond(samples) and samples
        return _wait_for(what, check, timeout, log=self.log)

    def stop(self):
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
            try:
                return self.proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
                raise
        return self.proc.returncode


def _run_twin_daemon(tmp_path, fault_spec, port):
    """The twin's supervised loop in a thread, as tests/test_obs.py runs
    it: its mock backend, the fault spec, its server on ``port``."""
    from gpu_feature_discovery_tpu.cmd import main as twin_main
    from gpu_feature_discovery_tpu.cmd.supervisor import Supervisor
    from gpu_feature_discovery_tpu.config import new_config as twin_new_config
    from gpu_feature_discovery_tpu.lm.labeler import Empty
    from gpu_feature_discovery_tpu.utils import faults

    machine = tmp_path / "machine-type"
    machine.write_text("Google Compute Engine\n")
    config = twin_new_config(cli_values={
        "machine-type-file": str(machine), "output-file": str(tmp_path / "twin.tfd"),
        **_CHAOS_FLAGS, "metrics-addr": "127.0.0.1", "metrics-port": str(port),
    }, environ={})
    os.environ["TFD_BACKEND"] = "mock:v4-8"
    faults.load_fault_spec(fault_spec)
    sigs = queue.Queue()
    result = {}

    def target():
        try:
            result["restart"] = twin_main.run(
                lambda: twin_main._build_manager(config), Empty(), config, sigs,
                supervisor=Supervisor(config))
        except BaseException as e:  # noqa: BLE001 - reported by the test
            result["error"] = e

    t = threading.Thread(target=target, daemon=True)
    t.start()

    def stop():
        sigs.put(signal.SIGTERM)
        t.join(timeout=15)
        faults.reset()
        os.environ.pop("TFD_BACKEND", None)
        assert not t.is_alive(), "twin daemon did not honour SIGTERM"
        assert "error" not in result, result.get("error")

    return stop


# A cycle every 0.4 s and an init backoff capped far below it: each cycle
# makes one init attempt, so two injected failures are two degraded
# cycles on both twins, whatever the machine's speed.
_CHAOS_FLAGS = {"sleep-interval": "0.4s", "init-backoff-max": "0.05s",
                "init-retries": "50", "max-consecutive-failures": "50"}
_CHAOS_ARGS = [arg for k, v in _CHAOS_FLAGS.items() for arg in (f"--{k}", v)]


def _converged_history(scrape, timeout, log=None):
    """Scrape until the first body with two full cycles; returns it with
    every tfd_degraded value seen on the way."""
    degraded_seen = []

    def check():
        s = scrape()
        if s is None:
            return None
        degraded_seen.append(s[("tfd_degraded", "")])
        full = s.get(("tfd_cycles_total", '{outcome="full"}'), 0)
        assert full <= 2, f"a scrape missed the second full cycle: {_cycles(s)}"
        return s if full == 2 else None

    final = _wait_for("two full cycles", check, timeout, log=log, poll=0.005)
    return final, degraded_seen


def test_pjrt_init_chaos_scrapes_like_the_twin(tmp_path):
    twin_port = _free_port()
    twin_metrics.reset_for_tests()
    stop_twin = _run_twin_daemon(tmp_path, "pjrt_init:fail:2", twin_port)
    try:
        twin_final, twin_degraded = _converged_history(
            lambda: _scrape(twin_port), timeout=30)
    finally:
        stop_twin()
    cli = _Cli(tmp_path, "chaos", fault_spec="pjrt_init:fail:2", extra=_CHAOS_ARGS)
    try:
        port_final, port_degraded = _converged_history(cli.scrape, 90, log=cli.log)
    finally:
        assert cli.stop() == 0
    for final, degraded in ((twin_final, twin_degraded), (port_final, port_degraded)):
        assert final[("tfd_backend_init_failures_total", "")] == 2
        assert final[("tfd_backend_init_recoveries_total", "")] == 1
        assert 1.0 in degraded and degraded[-1] == 0.0
        assert degraded.index(0.0, degraded.index(1.0)) > degraded.index(1.0)
    assert _cycles(port_final) == _cycles(twin_final) == {
        '{outcome="degraded"}': 2.0, '{outcome="full"}': 2.0}
    # Both made three attempts: two injected failures and the recovery.
    assert port_final[("tfd_backend_init_attempts_total", "")] == 3
    assert port_final[("tfd_broker_up", "")] == 1
    assert port_final[("tfd_broker_respawns_total", "")] == 0
    # Set once, at the first full live write, which follows the spawn.
    assert 0 < port_final[("tfd_restart_to_labels_seconds", "")] < 90


# The broker budget of the fault daemons below. It bounds each worker's
# spawn (interpreter and torch's import) as well as each request, and
# three torch imports side by side under a loaded suite take over 4 s,
# which killed spawns and counted them as probe kills; 15 s is well
# above any spawn seen and still lets the hang shot end in seconds.
BROKER_BUDGET_S = 15.0


def test_broker_faults_and_the_server_lifecycle_scrape_live(tmp_path):
    """The three broker fault shots run as three daemons side by side."""
    common = ["--sleep-interval", "0.5s", "--probe-timeout", f"{BROKER_BUDGET_S}s",
              "--init-backoff-max", "0.2s"]
    hang = _Cli(tmp_path, "hang", "broker.hang:fail:1", common)
    crash = _Cli(tmp_path, "crash", "broker.crash:fail:1",
                 common + ["--probe-token", "sekrit"])
    sick = _Cli(tmp_path, "sick", "chip.1.sick:fail:1",
                common + ["--burnin-interval", "1"],
                env={"TFD_BURNIN_CPU_DEVICES": "2"})
    try:
        # The sick shot: chip 1 reads 0 on exactly one probe, then 1.
        chip1 = []

        def chip1_recovered(s):
            value = s.get(("tfd_chip_ok", '{chip="1"}'))
            if value is not None and (not chip1 or chip1[-1] != value):
                chip1.append(value)
            return chip1[-2:] == [0.0, 1.0]

        s = sick.wait("chip 1 sick, then healthy", chip1_recovered, timeout=90)
        assert chip1 == [0.0, 1.0]
        assert s[("tfd_chip_ok", '{chip="0"}')] == 1
        assert s[("tfd_chip_tflops", '{chip="1"}')] > 0

        # The hang shot: the first request is killed at --probe-timeout.
        s = hang.wait("a killed worker respawned into full cycles",
                      lambda s: s.get(("tfd_cycles_total", '{outcome="full"}'), 0) >= 2,
                      timeout=90)
        assert s[("tfd_probe_kills_total", "")] == 1
        assert s[("tfd_probe_crashes_total", "")] == 0
        assert s[("tfd_broker_respawns_total", "")] == 1
        assert s[("tfd_broker_up", "")] == 1
        assert s[("tfd_broker_request_duration_seconds_sum", "")] >= BROKER_BUDGET_S

        # The crash shot: one signal death, one respawn.
        s = crash.wait("a crashed worker respawned into full cycles",
                       lambda s: s.get(("tfd_cycles_total", '{outcome="full"}'), 0) >= 2,
                       timeout=90)
        assert s[("tfd_probe_crashes_total", "")] == 1
        assert s[("tfd_probe_kills_total", "")] == 0
        assert s[("tfd_broker_respawns_total", "")] == 1
        assert s[("tfd_broker_up", "")] == 1
        assert s[("tfd_broker_requests_total", "")] >= 2

        # POST /probe: 401 without the token, 202 with it, one wake. A
        # wake counts its first event's reason, so the probe is posted two
        # cycles after the health labels, whose first cycle posted a
        # health_delta.
        crash.wait("health labels", lambda s: ("tfd_chip_ok", '{chip="0"}') in s)
        full = crash.scrape()[("tfd_cycles_total", '{outcome="full"}')]
        s = crash.wait("two cycles on", lambda s: s[
            ("tfd_cycles_total", '{outcome="full"}')] >= full + 2)
        wakes = s.get(("tfd_reconcile_wakes_total", '{reason="probe_request"}'), 0)
        assert _request(crash.port, "POST", "/probe")[0] == 401
        assert _request(crash.port, "POST", "/probe",
                        {"Authorization": "Bearer sekrit"})[0] == 202
        s = crash.wait("a probe_request wake", lambda s: s.get(
            ("tfd_reconcile_wakes_total", '{reason="probe_request"}'), 0) == wakes + 1)
        full = s[("tfd_cycles_total", '{outcome="full"}')]
        crash.wait("a full cycle after the wake", lambda s: s[
            ("tfd_cycles_total", '{outcome="full"}')] > full)
        assert _request(crash.port, "GET", "/healthz")[0] == 200
        assert _request(crash.port, "GET", "/readyz")[0] == 200

        # SIGHUP: the epoch's server closes and the next one binds the
        # same port. The twin's rule, held here: a commanded close (the
        # epoch's end) retires the epoch's broker client, and the new
        # epoch's first spawn is its client's first, so it is no respawn.
        crash.proc.send_signal(signal.SIGHUP)
        _wait_for("a second epoch", lambda: crash.log.read_text().count(
            "Introspection server listening") >= 2, 60, log=crash.log)
        s = crash.wait("health labels in the new epoch",
                       lambda s: s[("tfd_broker_up", "")] == 1
                       and s.get(("tfd_chip_ok", '{chip="0"}')) == 1)
        assert s[("tfd_broker_respawns_total", "")] == 1
        assert s[("tfd_reconcile_wakes_total", '{reason="signal"}')] >= 1
        assert crash.stop() == 0
        with pytest.raises(OSError):
            socket.create_connection(("127.0.0.1", crash.port), timeout=0.5)
    finally:
        for cli in (hang, crash, sick):
            cli.stop()


# ---------------------------------------------------------------------------
# MIG: the tfd_chip_* series follow the chip.<i>.* labels, by the label's
# index (each MIG device probed by a process pinned to it, which
# tests/torch_mig_fakes.py stands in for)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("path", ["in-process", "broker"])
@pytest.mark.parametrize("layout", ["mixed", "half", "none"])
def test_chip_series_follow_the_chip_labels_under_mig(
        layout, path, fake_torch_cuda, monkeypatch):
    fake = fake_nvml(layout)
    listed = fake_torch_cuda(fake)
    MigWorkers(monkeypatch)
    cuda = CudaManager(nvml_lib=fake)
    cuda.init()
    manager = cuda if path == "in-process" else BrokerManager(_FakeBrokerClient(cuda))
    metrics.reset_for_tests()
    labels = _health_cycle(manager, oneshot=path == "in-process", monkeypatch=monkeypatch)
    chip_series = sorted(
        (name, lab) for (name, lab) in _samples(metrics.REGISTRY.render())
        if name.startswith("tfd_chip_"))
    chip_labels = sorted(k for k in labels if re.match(r"nvidia\.com/gpu\.chip\.\d+\.ok$", k))
    if layout == "none":
        assert len(chip_labels) == len(listed) == int(labels["nvidia.com/gpu.count"])
        assert chip_series == sorted(
            [("tfd_chip_ok", f'{{chip="{i}"}}') for i in range(len(listed))]
            + [("tfd_chip_tflops", f'{{chip="{i}"}}') for i in range(len(listed))])
        assert all(metrics.CHIP_OK.value(chip=str(i)) == 1 for i in range(len(listed)))
    else:
        # A MIG-enabled GPU's verdict has no rate (a MIG device's is not
        # its GPU's): tfd_chip_ok alone.
        count = int(labels["nvidia.com/gpu.count"])
        mig = [i for i, g in enumerate(fake.gpus) if g.mig_mode == 1]
        assert chip_labels == sorted(f"nvidia.com/gpu.chip.{i}.ok" for i in range(count))
        assert chip_series == sorted(
            [("tfd_chip_ok", f'{{chip="{i}"}}') for i in range(count)]
            + [("tfd_chip_tflops", f'{{chip="{i}"}}') for i in range(count) if i not in mig])
        assert all(metrics.CHIP_OK.value(chip=str(i)) == 1 for i in range(count))
    assert labels["nvidia.com/gpu.health.ok"] == "true"


# ---------------------------------------------------------------------------
# sockets
# ---------------------------------------------------------------------------

def _config(tmp_path, **cli):
    values = {"machine-type-file": "", "output-file": str(tmp_path / "tfd"),
              "metrics-addr": "127.0.0.1", "probe-broker": "off"}
    values.update(cli)
    return new_config(cli_values=values, environ={})


@pytest.fixture
def bound_servers(monkeypatch):
    """Every IntrospectionServer built while the fixture is active."""
    built = []
    orig = IntrospectionServer.__init__

    def spy(self, *a, **kw):
        built.append(self)
        return orig(self, *a, **kw)

    monkeypatch.setattr(IntrospectionServer, "__init__", spy)
    return built


def test_oneshot_opens_no_socket(tmp_path, bound_servers):
    port = _free_port()
    config = _config(tmp_path, oneshot="true", **{"metrics-port": str(port)})
    assert cmd_main.run(StaticCudaManager.mock_gpu(2), config, queue.SimpleQueue()) is False
    assert (tmp_path / "tfd").exists()
    assert bound_servers == []
    assert cmd_main.start_introspection_server(config) == (None, None)
    with pytest.raises(OSError):
        socket.create_connection(("127.0.0.1", port), timeout=0.5)


def _daemon_thread(config):
    sigs = queue.SimpleQueue()
    result = {}

    def target():
        try:
            result["restart"] = cmd_main.run(lambda: StaticCudaManager.mock_gpu(1), config, sigs)
        except BaseException as e:  # noqa: BLE001 - reported by the test
            result["error"] = e

    t = threading.Thread(target=target, daemon=True)
    t.start()

    def stop():
        sigs.put(signal.SIGTERM)
        t.join(timeout=15)
        assert not t.is_alive() and "error" not in result, result
    return stop


def test_metrics_port_zero_opens_no_socket(tmp_path, bound_servers):
    config = _config(tmp_path, **{"metrics-port": "0", "sleep-interval": "0.05s"})
    assert cmd_main.start_introspection_server(config) == (None, None)
    stop = _daemon_thread(config)
    try:
        _wait_for("labels", lambda: (tmp_path / "tfd").exists(), 30)
        time.sleep(0.2)  # a few cycles, each of which would retry a bind
    finally:
        stop()
    assert bound_servers == []


def test_taken_port_warns_once_then_binds_when_free(tmp_path, caplog):
    squatter = socket.socket()
    squatter.bind(("127.0.0.1", 0))
    squatter.listen(1)
    port = squatter.getsockname()[1]
    config = _config(tmp_path, **{"metrics-port": str(port), "sleep-interval": "0.05s"})
    with caplog.at_level(logging.WARNING, logger="tfd"):
        stop = _daemon_thread(config)
        try:
            _wait_for("labels", lambda: (tmp_path / "tfd").exists(), 30)
            time.sleep(0.3)  # several cycles retry the bind quietly
            squatter.close()
            samples = _wait_for("the server once the port is free",
                                lambda: _scrape(port), 10)
            assert samples[("tfd_cycles_total", '{outcome="full"}')] >= 1
            _wait_for("ready after the epoch's next write",
                      lambda: _request(port, "GET", "/readyz")[0] == 200, 10)
        finally:
            squatter.close()
            stop()
    warnings = [r for r in caplog.records if "cannot bind introspection server" in r.message]
    assert len(warnings) == 1


# ---------------------------------------------------------------------------
# first use through the broker: the worker's pre-warm
# ---------------------------------------------------------------------------

def test_worker_ships_its_prewarm_once_with_the_first_ok_outcome(monkeypatch):
    import torch

    from gpu_feature_discovery_tpu_torch.lm import health
    from gpu_feature_discovery_tpu_torch.sandbox import broker

    monkeypatch.setattr(health, "_acquire_devices", lambda: [torch.device("cpu")])
    monkeypatch.setenv("TFD_BURNIN_GEOMETRY", "64x1")
    probe = broker._HealthProbe(threading.Lock())
    probe.prewarm_ms = 1234.5
    first = probe.request({"per_chip": True, "wait_s": 60})
    second = probe.request({"per_chip": True, "wait_s": 60})
    assert first["status"] == second["status"] == "ok"
    assert first["prewarm_ms"] == 1234.5
    assert "prewarm_ms" not in second and probe.prewarm_ms is None


class _PrewarmedBroker(_FakeBrokerClient):
    """A worker whose pre-warm paid first use: its probes report a
    compile_ms of 0 and its first outcome carries the pre-warm's ms."""

    def health(self, **kw):
        outcome = super().health(**kw)
        outcome["report"]["phases"]["compile_ms"] = 0.0
        outcome["prewarm_ms"] = 2500.0
        return outcome


def test_first_probe_compile_reads_the_prewarm_through_the_broker(
        fake_torch_cuda, monkeypatch):
    fake = fake_nvml("none")
    fake_torch_cuda(fake)
    cuda = CudaManager(nvml_lib=fake)
    cuda.init()
    metrics.reset_for_tests()
    labels = _health_cycle(BrokerManager(_PrewarmedBroker(cuda)), oneshot="false",
                           monkeypatch=monkeypatch)
    assert labels["nvidia.com/gpu.health.ok"] == "true"
    assert metrics.FIRST_PROBE_COMPILE.value() == 2.5


# ---------------------------------------------------------------------------
# tfd_compile_cache_enabled: the kernel cache the epoch resolved
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["missing", "empty", "prebuilt"])
def test_compile_cache_gauge_follows_the_resolved_directory(tmp_path, layout, monkeypatch):
    from gpu_feature_discovery_tpu_torch.ops import kernel_cache

    cache = tmp_path / "cache"
    if layout != "missing":
        cache.mkdir()
    if layout == "prebuilt":
        monkeypatch.setenv(kernel_cache.RESOLVED_CACHE_DIR_ENV, str(cache))
        kernel_cache.library_path(kernel_cache.HBM_STREAM_SUM_CU).write_bytes(b"\0")
    metrics.reset_for_tests()
    config = _config(tmp_path, oneshot="true",
                     **{"compilation-cache-dir": str(cache), "metrics-port": "0"})
    assert cmd_main.run(StaticCudaManager.mock_gpu(1), config, queue.SimpleQueue()) is False
    monkeypatch.delenv(kernel_cache.RESOLVED_CACHE_DIR_ENV, raising=False)
    assert metrics.COMPILE_CACHE_ENABLED.value() == (0 if layout == "missing" else 1)
    assert not cache.exists() if layout == "missing" else cache.is_dir()
