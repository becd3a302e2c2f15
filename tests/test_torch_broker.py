"""The persistent probe broker of the PyTorch port, on the CPU.

The twin's ``tests/test_broker.py`` list, case for case, on ``mock-gpu``:
spawn and ping, reuse without re-init, hang-kill and respawn, crash and
respawn, spawn backoff, recycle, SIGTERM to the worker, graceful and
idempotent close, ``kill_child``, the death watch, the sweep exemption,
and the daemon's acceptance scenarios. Then the wire (frames written by
either package's ``_write_frame`` read by the other's ``_FrameReader``),
and the burn-in through the worker against the in-process probe and the
twin, ``chip.1.sick`` included.

A worker without burn-in imports no torch and starts in a fraction of a
second; the burn-in worker imports torch, so one is shared by the module.
Every wait is bounded by the broker's own deadlines."""

import json
import os
import queue
import signal
import subprocess
import threading
import time

import pytest

from gpu_feature_discovery_tpu.sandbox import broker as twin_broker
from gpu_feature_discovery_tpu_torch import sandbox
from gpu_feature_discovery_tpu_torch.cmd.main import run
from gpu_feature_discovery_tpu_torch.cmd.supervisor import (
    DEGRADED_LABEL,
    RESTORED_LABEL,
    UNHEALTHY_CYCLES_LABEL,
    Supervisor,
)
from gpu_feature_discovery_tpu_torch.config.flags import new_config
from gpu_feature_discovery_tpu_torch.lm import health
from gpu_feature_discovery_tpu_torch.lm.engine import LabelEngine
from gpu_feature_discovery_tpu_torch.lm.gpu import gpu_label_sources
from gpu_feature_discovery_tpu_torch.lm.labelers import new_label_sources
from gpu_feature_discovery_tpu_torch.resource import factory
from gpu_feature_discovery_tpu_torch.resource.cuda_backend import StaticCudaManager
from gpu_feature_discovery_tpu_torch.resource.types import ResourceError
from gpu_feature_discovery_tpu_torch.sandbox import (
    BrokerClient,
    BrokerCrash,
    BrokerManager,
    BrokerTimeout,
    SnapshotManager,
)
from gpu_feature_discovery_tpu_torch.sandbox import broker as broker_mod
from gpu_feature_discovery_tpu_torch.utils import faults
from torch_env_guard import resolved_cache_dir_restored  # noqa: F401 - autouse

COUNT = "nvidia.com/gpu.count"


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv(faults.FAULT_SPEC_ENV, raising=False)
    faults.reset()
    yield
    faults.reset()
    sandbox.set_broker_death_watch(False)
    sandbox.close_broker()


def cfg(tmp_path, **cli):
    values = {
        "backends": "mock-gpu:2",
        "output-file": str(tmp_path / "tfd"),
        "sleep-interval": "0.01s",
        "init-backoff-max": "0.02s",
        "init-retries": "50",
        "max-consecutive-failures": "50",
    }
    values.update(cli)
    return new_config(cli_values=values, environ={})


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


def _pid_alive(pid):
    try:
        os.kill(pid, 0)
        return True
    except OSError:
        return False


def _try_ping(client):
    try:
        return client.ping()
    except ResourceError:
        return False


def _ping_through_spawn(client, timeout=10.0):
    """Ping, spawning the worker first. A test's 0.5 s budget is for the
    request it tests, but a spawn runs under it too, and a loaded host can
    start a Python worker slower than that: a spawn that missed its budget,
    and the backoff after it, are waited out; any other error is raised."""
    deadline = time.monotonic() + timeout
    while True:
        try:
            return client.ping()
        except (BrokerTimeout, broker_mod.BrokerError) as e:
            missed = "init exceeded" in str(e) or "backing off" in str(e)
            if not missed or time.monotonic() > deadline:
                raise
            time.sleep(0.02)


class _Client:
    """A BrokerClient closed when the test ends, however it ends."""

    def __init__(self, config):
        self.client = BrokerClient(config)

    def __enter__(self):
        return self.client

    def __exit__(self, *exc):
        self.client.close()


def start_daemon(config):
    sigs = queue.SimpleQueue()
    result = {}

    def target():
        try:
            result["restart"] = run(
                lambda: factory.build_manager(config), config, sigs,
                supervisor=Supervisor(config),
            )
        except BaseException as e:  # noqa: BLE001 - surfaced by the test
            result["error"] = e

    t = threading.Thread(target=target)
    t.start()
    return t, sigs, result


def stop_daemon(t, sigs, result):
    sigs.put(signal.SIGTERM)
    t.join(timeout=20)
    assert not t.is_alive()
    assert "error" not in result, result.get("error")


class _SpawnLog:
    """Counts "broker worker <pid> ready" lines: one per spawn."""

    def __init__(self, caplog):
        self._caplog = caplog
        caplog.set_level("INFO", logger="tfd.sandbox")

    @property
    def spawns(self):
        return sum("broker worker" in r.getMessage() and "ready in" in r.getMessage()
                   for r in self._caplog.records)

    @property
    def respawns(self):
        return sum("(respawn)" in r.getMessage() for r in self._caplog.records)


# ---------------------------------------------------------------------------
# the RPC machinery
# ---------------------------------------------------------------------------

def test_broker_spawn_serves_snapshot_and_ping(tmp_path):
    with _Client(cfg(tmp_path)) as client:
        assert client.ping() is True
        snap = client.snapshot()
        assert len(snap.chips) == 2 and snap.driver_version == "1.9.0"
        pid = client.pid
        assert pid != os.getpid() and _pid_alive(pid)
        assert client.pid == pid  # requests reuse the worker
    assert not client.alive
    assert not _pid_alive(pid)


def test_broker_reuse_never_reinits_backend(tmp_path, caplog):
    log = _SpawnLog(caplog)
    config = cfg(tmp_path)
    managers = [sandbox.acquire_broker_manager(config) for _ in range(3)]
    pids = set()
    for m in managers:
        m.init()  # the per-cycle snapshot refresh
        assert len(m.get_chips()) == 2
        pids.add(m.broker.pid)
    assert len(pids) == 1 and log.spawns == 1, "acquisition re-ran the backend init"
    sandbox.close_broker()
    assert not _pid_alive(pids.pop())


def test_broker_request_hang_killed_within_budget_and_respawns(tmp_path, caplog):
    log = _SpawnLog(caplog)
    with _Client(cfg(tmp_path, **{"probe-timeout": "0.5s"})) as client:
        assert _ping_through_spawn(client)
        pid = client.pid
        faults.load_fault_spec("broker.hang:fail:1")
        t0 = time.monotonic()
        with pytest.raises(BrokerTimeout, match="request"):
            client.ping()
        # Budget + kill/reap slack: a broken kill path hangs forever.
        assert time.monotonic() - t0 < 0.5 + 5.0
        assert not _pid_alive(pid) and not client.alive
        assert _ping_through_spawn(client)  # next use respawns
        assert client.pid != pid and log.respawns == 1


def test_broker_request_crash_surfaces_and_respawns(tmp_path):
    with _Client(cfg(tmp_path)) as client:
        assert client.ping()
        faults.load_fault_spec("broker.crash:fail:1")
        with pytest.raises(BrokerCrash, match="SIGSEGV"):
            client.ping()
        assert client.ping()


def test_broker_spawn_failure_backs_off(tmp_path):
    with _Client(cfg(tmp_path)) as client:
        faults.load_fault_spec("pjrt_init:fail:1")
        with pytest.raises(faults.FaultInjected):
            client.ping()
        with pytest.raises(ResourceError, match="backing off"):
            client.ping()
        assert wait_until(lambda: time.sleep(0.02) or _try_ping(client), timeout=5)


def test_broker_spawn_hang_and_segv_surface_as_probe_errors(tmp_path):
    with _Client(cfg(tmp_path, **{"probe-timeout": "0.5s",
                                  "init-backoff-max": "0s"})) as client:
        faults.load_fault_spec("probe.hang:fail:1,probe.segv:fail:1")
        with pytest.raises(BrokerTimeout, match="init exceeded"):
            client.ping()
        with pytest.raises(BrokerCrash, match="SIGSEGV"):
            client.ping()
        assert _ping_through_spawn(client)


def test_broker_recycles_after_max_requests(tmp_path, caplog):
    log = _SpawnLog(caplog)
    with _Client(cfg(tmp_path, **{"broker-max-requests": "2"})) as client:
        pids = set()
        for _ in range(6):
            client.ping()
            if client.pid is not None:
                pids.add(client.pid)
        assert len(pids) >= 2, "worker never recycled at the request cap"
        assert log.respawns >= 2 and log.spawns >= 3


def test_broker_worker_dies_to_sigterm_not_parent_queue(tmp_path):
    """The worker starts with default handlers: a SIGTERM addressed to it
    kills it instead of queueing on the parent's watcher."""
    with _Client(cfg(tmp_path)) as client:
        assert client.ping()
        pid = client.pid

        def _zombie_or_gone():
            try:
                with open(f"/proc/{pid}/status") as f:
                    return "State:\tZ" in f.read()
            except OSError:
                return True

        os.kill(pid, signal.SIGTERM)
        assert wait_until(_zombie_or_gone, timeout=5), "worker ignored SIGTERM"
        with pytest.raises(BrokerCrash, match="SIGTERM"):
            client.ping()
        assert not _pid_alive(pid)
        assert client.ping()


def test_broker_close_is_idempotent_and_graceful(tmp_path):
    client = BrokerClient(cfg(tmp_path))
    assert client.ping()
    pid = client.pid
    client.close()
    client.close()
    assert not _pid_alive(pid)
    out = subprocess.run(["ps", "--ppid", str(os.getpid()), "-o", "stat="],
                         capture_output=True, text=True).stdout
    assert not [s for s in out.split() if s.startswith("Z")]
    client.prespawn()  # a pre-spawn losing the race to close starts nothing
    assert not client.alive


def test_kill_child_only_fires_while_request_inflight(tmp_path):
    with _Client(cfg(tmp_path)) as client:
        assert client.ping()
        pid = client.pid
        client.kill_child()  # idle: no-op
        assert _pid_alive(pid) and client.ping()


def _blocked_ping(client):
    result = {}

    def target():
        try:
            client.ping()
        except BaseException as e:  # noqa: BLE001 - inspected by the caller
            result["error"] = e

    t = threading.Thread(target=target, daemon=True)
    t.start()
    return t, result


def test_kill_child_unblocks_inflight_request(tmp_path):
    with _Client(cfg(tmp_path, **{"probe-timeout": "30s"})) as client:
        assert client.ping()
        faults.load_fault_spec("broker.hang:fail:1")
        t, result = _blocked_ping(client)
        assert wait_until(lambda: client._inflight, timeout=5)
        time.sleep(0.05)
        client.kill_child()
        t.join(timeout=5)
        assert not t.is_alive(), "request stayed blocked after the kill"
        assert isinstance(result.get("error"), ResourceError)


def test_kill_child_reaches_worker_mid_spawn(tmp_path):
    with _Client(cfg(tmp_path, **{"probe-timeout": "30s"})) as client:
        faults.load_fault_spec("probe.hang:fail:1")
        t, result = _blocked_ping(client)
        assert wait_until(lambda: client._spawning is not None, timeout=5)
        client.kill_child()
        t.join(timeout=5)
        assert not t.is_alive(), "request stayed blocked on the hung spawn"
        assert isinstance(result.get("error"), ResourceError)
        assert wait_until(lambda: time.sleep(0.03) or _try_ping(client), timeout=5)


# ---------------------------------------------------------------------------
# the wire, against the twin
# ---------------------------------------------------------------------------

DOCS = [{"op": "ping"}, {"status": "ok", "snapshot": {"chips": [1, 2]}},
        {"status": "warming"}, {"op": "health", "sick_chips": [1], "wait_s": 2.0},
        # Port-only fields, added beside the twin's: the request's cycle and
        # parent span, and the reply's spans with the worker's pid and clock
        # offset (obs/spans.py). The twin's reader passes them through.
        {"op": "health", "wait_s": 2.0, "cycle": 7, "parent": (4242 << 32) | 9},
        {"status": "warming", "spans": [[(4243 << 32) | 1, (4242 << 32) | 9, 7,
                                         "worker.health", 10, 20, 4243, 1]],
         "span_pid": 4243, "span_clock": [1792326706000000000, "torch.profiler"]}]


@pytest.mark.parametrize("writer,reader", [
    (twin_broker._write_frame, broker_mod._FrameReader),
    (broker_mod._write_frame, twin_broker._FrameReader),
], ids=["twin-to-port", "port-to-twin"])
def test_frames_cross_between_the_packages(writer, reader):
    r, w = os.pipe()
    try:
        for doc in DOCS:
            writer(w, doc)
        frames = reader(r)
        got = [json.loads(frames.read(time.monotonic() + 2)) for _ in DOCS]
        assert got == DOCS
        os.close(w)
        w = None
        assert frames.read(time.monotonic() + 2) == b""  # EOF
    finally:
        os.close(r)
        if w is not None:
            os.close(w)


@pytest.mark.parametrize("mod", [twin_broker, broker_mod], ids=["twin", "port"])
def test_corrupt_length_prefix_is_a_typed_error(mod):
    r, w = os.pipe()
    try:
        os.write(w, (mod.MAX_FRAME_BYTES + 1).to_bytes(4, "big") + b"junk")
        with pytest.raises(mod.BrokerCrash, match="corrupt length prefix"):
            mod._FrameReader(r).read(time.monotonic() + 2)
    finally:
        os.close(r)
        os.close(w)
    assert broker_mod.MAX_FRAME_BYTES == twin_broker.MAX_FRAME_BYTES


# ---------------------------------------------------------------------------
# snapshot fidelity through the broker
# ---------------------------------------------------------------------------

def _labels(manager, config):
    return dict(LabelEngine(parallel=False).generate(new_label_sources(manager, config)))


def test_broker_labels_identical_to_live_manager(tmp_path):
    config = cfg(tmp_path, **{"no-timestamp": True})
    live = _labels(StaticCudaManager.mock_gpu(2), config)
    brokered = _labels(sandbox.acquire_broker_manager(config), config)
    assert brokered == live and brokered[COUNT] == "2"


def test_broker_manager_is_snapshot_manager(tmp_path):
    manager = sandbox.acquire_broker_manager(cfg(tmp_path))
    assert isinstance(manager, SnapshotManager) and isinstance(manager, BrokerManager)
    first = manager.snapshot
    manager.init()
    assert manager.snapshot is not first, "init() must refresh the snapshot"
    assert manager.snapshot.to_dict() == first.to_dict()
    manager.shutdown()  # no-op: the worker holds the backend
    assert manager.broker.alive


def test_sweep_exempts_live_broker_worker(tmp_path):
    with _Client(cfg(tmp_path)) as client:
        assert client.ping()
        pid = client.pid
        assert sandbox.kill_stray_children() == 0
        assert _pid_alive(pid) and client.ping()
    assert not _pid_alive(pid)


# ---------------------------------------------------------------------------
# the daemon's acceptance scenarios
# ---------------------------------------------------------------------------

def _fresh(out):
    labels = labels_at(out)
    return (labels.get(COUNT) == "2" and DEGRADED_LABEL not in labels
            and RESTORED_LABEL not in labels
            and UNHEALTHY_CYCLES_LABEL not in labels)


def test_acceptance_rebuild_reuses_live_broker(tmp_path, caplog):
    log = _SpawnLog(caplog)
    config = cfg(tmp_path, **{"probe-broker": "on"})
    out = config.flags.tfd.output_file
    faults.load_fault_spec("generate:raise:RuntimeError:1")
    t, sigs, result = start_daemon(config)
    try:
        assert wait_until(lambda: _fresh(out)), f"no fresh labels: {labels_at(out)}"
        assert log.spawns == 1, "the rebuild re-ran the backend init"
    finally:
        stop_daemon(t, sigs, result)


@pytest.mark.parametrize("spec", ["broker.hang:fail:1", "broker.crash:fail:1"])
def test_acceptance_broker_fault_killed_respawned_converges(tmp_path, caplog, spec):
    log = _SpawnLog(caplog)
    config = cfg(tmp_path, **{"probe-broker": "on", "probe-timeout": "0.5s"})
    out = config.flags.tfd.output_file
    faults.load_fault_spec(spec)
    t, sigs, result = start_daemon(config)
    try:
        assert wait_until(lambda: log.respawns >= 1 and _fresh(out), timeout=15), (
            f"did not converge after {spec}: {labels_at(out)}"
        )
        assert t.is_alive(), "the daemon exited on the worker fault"
    finally:
        stop_daemon(t, sigs, result)


def test_burnin_source_carries_broker_cancel_hook(tmp_path, burnin_worker):
    config, client = burnin_worker
    manager = BrokerManager(client)
    sources = {s.name: s for s in gpu_label_sources(manager, config)}
    assert sources["health"].cancel == manager.broker.kill_child
    assert sources["health"].offload is True
    plain = cfg(tmp_path)
    plain_sources = {s.name: s for s in gpu_label_sources(
        sandbox.acquire_broker_manager(plain), plain)}
    assert plain_sources["health"].cancel is None


def test_burnin_without_a_device_publishes_no_health(tmp_path, monkeypatch):
    """No CUDA device and no CPU opt-in: the worker answers unacquirable,
    the cycle publishes no health label, and a chip shot is given back."""
    monkeypatch.delenv("TFD_BURNIN_ALLOW_CPU", raising=False)
    config = cfg(tmp_path, **{"with-burnin": True})
    manager = sandbox.acquire_broker_manager(config)
    faults.load_fault_spec("chip.0.sick:fail:1")
    health.reset_burnin_schedule()
    assert dict(health.new_health_labeler(manager, config).labels()) == {}
    assert faults.consume_chip_faults() == (frozenset({0}), frozenset())


def test_worker_health_probe_answers_warming_while_probing(monkeypatch):
    from gpu_feature_discovery_tpu_torch.ops import healthcheck

    release = threading.Event()

    def slow_measure(devices=None, **_):
        release.wait(30)
        return {"healthy": True, "tflops": 10.0, "timing": "wall-clock"}

    monkeypatch.setattr(health, "_acquire_devices", lambda: ["dev"])
    monkeypatch.setattr(healthcheck, "measure_node_health", slow_measure)
    probe = broker_mod._HealthProbe(threading.Lock())
    t0 = time.monotonic()
    assert probe.request({"wait_s": 0.05})["status"] == "warming"
    assert time.monotonic() - t0 < 5.0, "health RPC blocked behind the probe"
    assert probe.request({"wait_s": 0.05})["status"] == "warming"
    release.set()
    outcome = probe.request({"wait_s": 5.0})
    assert outcome["status"] == "ok" and outcome["report"]["tflops"] == 10.0
    release.clear()
    assert probe.request({"wait_s": 0.05})["status"] == "warming"  # a fresh probe
    release.set()


# ---------------------------------------------------------------------------
# the death watch
# ---------------------------------------------------------------------------

def test_death_watch_marks_dead_at_death_time_and_respawn_serves(tmp_path, caplog):
    log = _SpawnLog(caplog)
    deaths = []
    sandbox.set_broker_death_watch(True, listener=deaths.append)
    with _Client(cfg(tmp_path)) as client:
        assert client.ping()
        pid = client.pid
        os.kill(pid, signal.SIGKILL)
        assert wait_until(lambda: not client.alive, timeout=5)
        assert not _pid_alive(pid), "the watch must reap the dead worker"
        assert wait_until(lambda: deaths, timeout=5) and deaths == ["SIGKILL"]
        assert client.ping() and client.pid != pid
        assert log.respawns == 1


def test_death_watch_ignores_graceful_close_and_recycle(tmp_path):
    deaths = []
    sandbox.set_broker_death_watch(True, listener=deaths.append)
    with _Client(cfg(tmp_path, **{"broker-max-requests": "1"})) as client:
        assert client.ping()  # served 1: recycled at the cap
        assert client.ping()
    time.sleep(0.3)
    assert deaths == [], f"a commanded exit fired the listener: {deaths}"


def test_death_watch_off_keeps_the_discover_on_next_rpc_contract(tmp_path):
    with _Client(cfg(tmp_path)) as client:
        assert client.ping()
        os.kill(client.pid, signal.SIGKILL)
        time.sleep(0.3)
        assert client.alive, "watch off: the death must not be pre-observed"
        with pytest.raises(BrokerCrash):
            client.ping()
        assert client.ping()


# ---------------------------------------------------------------------------
# the burn-in through the worker, against in process and the twin
# ---------------------------------------------------------------------------

BURNIN_ENV = {"TFD_BURNIN_ALLOW_CPU": "1", "TFD_BURNIN_GEOMETRY": "128x2",
              # The twin's conftest pins 8 virtual CPU devices.
              health.BURNIN_CPU_DEVICES_ENV: "8"}
VERDICT_KEYS = ("nvidia.com/gpu.health.ok", "nvidia.com/gpu.health.timing",
                "nvidia.com/gpu.chips.healthy", "nvidia.com/gpu.chips.sick")


@pytest.fixture(scope="module")
def burnin_worker(tmp_path_factory):
    """One burn-in worker (it imports torch) shared by the module."""
    with pytest.MonkeyPatch.context() as mp:
        for k, v in BURNIN_ENV.items():
            mp.setenv(k, v)
        config = cfg(tmp_path_factory.mktemp("burnin"),
                     **{"with-burnin": True, "burnin-interval": "1"})
        client = BrokerClient(config)
        try:
            yield config, client
        finally:
            client.close()


def _verdicts(labels):
    return {k: v for k, v in labels.items()
            if k in VERDICT_KEYS or (k.startswith("nvidia.com/gpu.chip.")
                                     and k.endswith(".ok"))}


def _probe_through(manager, config):
    """Probing cycles until one publishes health (the worker may answer
    "warming" first)."""
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        labels = dict(health.new_health_labeler(manager, config).labels())
        if labels:
            return labels
    raise AssertionError("the worker never published health")


def _in_process(config, monkeypatch):
    for k, v in BURNIN_ENV.items():
        monkeypatch.setenv(k, v)
    manager = StaticCudaManager.mock_gpu(2)
    manager.init()
    oneshot = new_config(cli_values={"oneshot": True, "with-burnin": True,
                                     "backends": "mock-gpu:2"}, environ={})
    return dict(health.new_health_labeler(manager, oneshot).labels())


def _twin_in_process(spec, monkeypatch):
    from gpu_feature_discovery_tpu.config import new_config as twin_new_config
    from gpu_feature_discovery_tpu.lm import health as twin_health
    from gpu_feature_discovery_tpu.resource.testing import new_single_host_manager
    from gpu_feature_discovery_tpu.utils import faults as twin_faults

    for k, v in BURNIN_ENV.items():
        monkeypatch.setenv(k, v)
    twin_faults.reset()
    twin_faults.load_fault_spec(spec)
    try:
        twin_health.reset_burnin_schedule()
        manager = new_single_host_manager("v4-8")
        manager.init()
        config = twin_new_config(cli_values={"oneshot": True, "with-burnin": True},
                                 environ={})
        labels = twin_health.new_health_labeler(manager, config).labels()
    finally:
        twin_faults.reset()
    return {k.replace("google.com/tpu.", "nvidia.com/gpu.", 1): v
            for k, v in labels.items()}


@pytest.mark.parametrize("spec", ["", "chip.1.sick:fail:1"], ids=["healthy", "sick"])
def test_burnin_labels_through_the_worker_match_in_process_and_twin(
    burnin_worker, monkeypatch, spec
):
    config, client = burnin_worker
    health.reset_burnin_schedule()
    faults.load_fault_spec(spec)
    brokered = _probe_through(BrokerManager(client), config)
    assert faults.consume_chip_faults() == (frozenset(), frozenset())  # delivered
    faults.load_fault_spec(spec)
    in_process = _in_process(config, monkeypatch)
    twin = _twin_in_process(spec, monkeypatch)
    assert _verdicts(brokered) == _verdicts(in_process) == _verdicts(twin)
    sick = spec != ""
    assert brokered["nvidia.com/gpu.chip.1.ok"] == ("false" if sick else "true")
    assert brokered["nvidia.com/gpu.chips.sick"] == ("1" if sick else "0")
    assert brokered["nvidia.com/gpu.health.ok"] == ("false" if sick else "true")
    assert "nvidia.com/gpu.health.probe-ms" in brokered


def test_worker_report_is_plain_json_with_launch_counts(burnin_worker):
    config, client = burnin_worker
    deadline = time.monotonic() + 60
    outcome = {"status": "warming"}
    while outcome["status"] == "warming" and time.monotonic() < deadline:
        outcome = client.health(per_chip=True)
    assert outcome["status"] == "ok", outcome
    phases = outcome["report"]["phases"]
    # The CPU path runs the plain version: no kernel launch, in the
    # worker or here.
    assert phases["hbm_stream_sum_launches"] == 0
    assert phases["hbm_stream_sum_launches_process"] == 0
    assert outcome["report"]["chips"] == 8
    json.dumps(outcome)


def test_worker_memory_report_names_the_worker_and_touches_no_cuda(burnin_worker):
    """The ``memory`` op: the worker's own pid; on CPU devices the
    pre-warm found no CUDA context to read and torch never initialised
    CUDA, so no device rows."""
    config, client = burnin_worker
    deadline = time.monotonic() + 60
    while client.health(per_chip=True)["status"] == "warming" and time.monotonic() < deadline:
        pass
    report = client.memory()
    assert report["pid"] == client.pid != os.getpid()
    assert report["context_used_bytes"] == [] and report["devices"] == []
    json.dumps(report)


def test_worker_memory_report_without_burnin_has_no_context_reading(tmp_path):
    with _Client(cfg(tmp_path)) as client:
        report = client.memory()
        assert report == {"pid": client.pid, "context_used_bytes": None, "devices": []}
