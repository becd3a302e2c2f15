"""The supervised daemon loop of the PyTorch port, on the CPU.

- cmd/events.py against its JAX twin: the same event script gives the
  same wakes, decisions and coalescing (ReconcileLoop, TokenBucket,
  DeltaTracker after the key translation google.com/tpu. ->
  nvidia.com/gpu.).
- cmd/main.run on mock-gpu:2 against the twin daemon on the same backend
  token: interval and event modes publish the gpu-mock golden and the
  twin's labels minus the timestamp; identical cycles leave the file's
  mtime untouched; SIGTERM removes the file; SIGHUP returns restart; a
  backend that will not init publishes nvidia.com/gpu.tfd.degraded=true.
- The real CLI in a subprocess with real signals, and the refusals of
  what this port does not run yet."""

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
from gpu_feature_discovery_tpu.cmd import main as twin_main
from gpu_feature_discovery_tpu.cmd.supervisor import Supervisor as TwinSupervisor
from gpu_feature_discovery_tpu.config import flags as twin_flags
from gpu_feature_discovery_tpu.config import new_config as twin_new_config
from gpu_feature_discovery_tpu.lm.labeler import Empty as TwinEmpty
from gpu_feature_discovery_tpu_torch.cmd import events
from gpu_feature_discovery_tpu_torch.cmd.main import run, start
from gpu_feature_discovery_tpu_torch.cmd.supervisor import DEGRADED_LABEL, Supervisor
from gpu_feature_discovery_tpu_torch.config import flags
from gpu_feature_discovery_tpu_torch.config.flags import new_config
from gpu_feature_discovery_tpu_torch.lm.labeler import Empty
from gpu_feature_discovery_tpu_torch.resource import factory
from gpu_feature_discovery_tpu_torch.resource.cuda_backend import StaticCudaManager
from torch_env_guard import resolved_cache_dir_restored  # noqa: F401 - autouse

HERE = Path(__file__).parent
REPO = HERE.parent
TIMESTAMP = "google.com/tfd.timestamp"


def _translated_key(key):
    return key.replace("google.com/tpu.", "nvidia.com/gpu.", 1)


# The host facts the port publishes beside the twin's gpu family (the
# twin's golden file stays as it is).
HOST_FACTS_GOLDEN = [
    r"nvidia\.com\/gpu\.machine=[A-Za-z0-9._-]+",
    r"nvidia\.com\/gpu\.slice\.capable=false",
]
HOST_FACT_PREFIXES = ("nvidia.com/gpu.machine=", "nvidia.com/gpu.slice.capable=")


def _golden():
    import re

    return [re.compile(f"^{g}$") for g in
            (HERE / "expected-output-gpu-mock.txt").read_text().splitlines()
            + HOST_FACTS_GOLDEN if g.strip()]


def _matches_golden(lines):
    patterns = _golden()
    return (all(any(p.match(l) for p in patterns) for l in lines)
            and all(any(p.match(l) for l in lines) for p in patterns))


# ---------------------------------------------------------------------------
# cmd/events.py parity
# ---------------------------------------------------------------------------

class _Clock:
    def __init__(self):
        self.now = 50.0

    def __call__(self):
        return self.now


def test_token_bucket_script_matches_twin():
    want_c, got_c = _Clock(), _Clock()
    want = twin_events.TokenBucket(2.0, 3.0, want_c)
    got = events.TokenBucket(2.0, 3.0, got_c)
    script = ["take", "take", "take", "take", "wait", ("tick", 0.2), "take",
              "wait", ("tick", 0.3), "take", "take", ("tick", 10.0), "take",
              "take", "take", "take"]
    for step in script:
        if isinstance(step, tuple):
            want_c.now += step[1]
            got_c.now += step[1]
        elif step == "take":
            assert got.try_take() == want.try_take()
        else:
            assert got.seconds_to_token() == want.seconds_to_token()


@pytest.mark.parametrize("reconcile", ["auto", "event", "interval"])
@pytest.mark.parametrize("oneshot", [True, False])
def test_resolve_reconcile_mode_matches_twin(reconcile, oneshot):
    values = {"reconcile": reconcile, "oneshot": oneshot}
    assert events.resolve_reconcile_mode(new_config(cli_values=values, environ={})) \
        == twin_events.resolve_reconcile_mode(twin_new_config(cli_values=values,
                                                              environ={}))


def _wake_script(mod):
    """Post scripted events, then wait; each wake's (decision, reasons,
    coalesced), and the backoff waits' decisions."""
    q = mod.EventQueue()
    loop = mod.ReconcileLoop(q, max_staleness=0.05, debounce=0.02,
                             max_probe_rate=50.0, burst=2.0)
    delta = mod.Event(mod.REASON_HEALTH_DELTA)
    out = []

    def wake():
        w = loop.wait_for_wake()
        out.append((w.decision, w.reasons, w.coalesced))

    wake()                                      # nothing: the staleness bound
    for _ in range(3):
        q.post(delta)
    wake()                                      # one wake for the burst
    q.post(delta)
    wake()                                      # burst allowance spent next
    q.post(delta)
    wake()                                      # deferred until a token
    q.post(delta)
    q.post(mod.Event(mod.REASON_SIGNAL, signum=signal.SIGHUP))
    wake()                                      # the decision preempts
    q.post(mod.Event(mod.REASON_SIGNAL, signum=signal.SIGTERM))
    wake()
    out.append(loop.wait_backoff(0.01))
    q.post(delta)
    q.post(mod.Event(mod.REASON_SIGNAL, signum=signal.SIGTERM))
    out.append(loop.wait_backoff(5.0))
    return out


def test_reconcile_wakes_match_twin():
    got, want = _wake_script(events), _wake_script(twin_events)
    assert got == want
    assert got[0] == (None, ("staleness_bound",), 0)
    assert got[1] == (None, ("health_delta",), 2)
    assert got[4][0] == "restart" and got[5][0] == "shutdown"
    assert got[6:] == [None, "shutdown"]


HEALTH_SEQUENCE = [
    {"nvidia.com/gpu.health.ok": "true", "nvidia.com/gpu.chip.0.ok": "true",
     "nvidia.com/gpu.health.matmul-tflops": "233"},
    {"nvidia.com/gpu.health.ok": "true", "nvidia.com/gpu.chip.0.ok": "true",
     "nvidia.com/gpu.health.matmul-tflops": "241"},
    {"nvidia.com/gpu.health.ok": "false", "nvidia.com/gpu.chip.0.ok": "false",
     "nvidia.com/gpu.chips.sick": "1"},
    {"nvidia.com/gpu.health.ok": "false", "nvidia.com/gpu.chip.0.ok": "false",
     "nvidia.com/gpu.chips.sick": "1", "nvidia.com/gpu.health.probe-ms": "4"},
    {},
]


def test_delta_tracker_matches_twin():
    def posted(mod, translate):
        q = mod.EventQueue()
        tracker = mod.DeltaTracker(q)
        out = []
        for labels in HEALTH_SEQUENCE:
            tracker.observe_labels({translate(k): v for k, v in labels.items()})
            e = q.get_nowait()
            out.append(None if e is None else (e.reason, e.detail))
        return out

    got = posted(events, lambda k: k)
    want = posted(twin_events,
                  lambda k: k.replace("nvidia.com/gpu.", "google.com/tpu.", 1))
    want = [None if w is None else (w[0], w[1].replace("google.com/tpu.",
                                                       "nvidia.com/gpu."))
            for w in want]
    assert got == want
    assert [g is not None for g in got] == [False, False, True, False, True]


def test_signal_forwarder_reinjects_what_it_did_not_deliver():
    sigs = queue.SimpleQueue()
    q = events.EventQueue()
    fwd = events.SignalForwarder(sigs, q).start()
    sigs.put(signal.SIGHUP)
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline and q._q.empty():
        time.sleep(0.005)
    fwd.stop()  # the forwarded SIGHUP was never consumed: back on sigs
    assert sigs.get(timeout=1) == signal.SIGHUP


# ---------------------------------------------------------------------------
# cmd/main.run against the twin daemon
# ---------------------------------------------------------------------------

def _drive(target, out, until, sig=signal.SIGTERM, timeout=15.0):
    """Run ``target(sigs)`` on a thread until ``until(out)`` holds, read
    the file, send ``sig``; returns (lines, run's return value)."""
    sigs = queue.SimpleQueue()
    result = {}
    t = threading.Thread(target=lambda: result.update(restart=target(sigs)))
    t.start()
    try:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline and not until(out):
            time.sleep(0.005)
        assert until(out), "daemon never wrote the expected labels"
        lines = sorted(l for l in Path(out).read_text().splitlines() if l.strip())
    finally:
        sigs.put(sig)
        t.join(timeout=15)
    assert not t.is_alive()
    return lines, result["restart"]


def _port_daemon(tmp_path, tag, make_manager=None, **cli):
    out = tmp_path / f"tfd-{tag}"
    values = {"backends": "mock-gpu:2", "output-file": str(out),
              "sleep-interval": "30s"}
    values.update(cli)
    config = new_config(cli_values=values, environ={})
    build = make_manager or (lambda: factory.build_manager(config))
    return out, lambda sigs: run(build, config, sigs, supervisor=Supervisor(config),
                                 interconnect=Empty())


def _twin_daemon(tmp_path, tag, **cli):
    out = tmp_path / f"twin-{tag}"
    values = {"oneshot": False, "backends": "mock-gpu:2", "output-file": str(out),
              "sleep-interval": "30s", "metrics-port": "0",
              "probe-isolation": "none", "probe-broker": "off"}
    values.update(cli)
    config = twin_new_config(cli_values=values, environ={})
    return out, lambda sigs: twin_main.run(
        lambda: twin_main._build_manager(config), TwinEmpty(), config, sigs,
        supervisor=TwinSupervisor(config),
    )


def _no_timestamp(lines):
    return [l for l in lines if not l.startswith(TIMESTAMP)]


@pytest.mark.parametrize("reconcile", ["interval", "event"])
def test_daemon_publishes_the_golden_and_the_twins_labels(tmp_path, monkeypatch,
                                                          reconcile):
    monkeypatch.delenv("TFD_BACKEND", raising=False)
    out, target = _port_daemon(tmp_path, "port", reconcile=reconcile)
    got, restart = _drive(target, out, os.path.exists)
    assert restart is False and not out.exists()
    assert _matches_golden(got)
    twin_out, twin_target = _twin_daemon(tmp_path, "twin", reconcile=reconcile)
    want, _ = _drive(twin_target, twin_out, os.path.exists)
    # The twin's gpu family carries no host facts (its tpu family does;
    # tests/test_torch_host_facts.py holds those against it).
    device = [l for l in _no_timestamp(got) if not l.startswith(HOST_FACT_PREFIXES)]
    assert device == sorted(_translated_key(l) for l in _no_timestamp(want))


class _CountingManager(StaticCudaManager):
    """mock-gpu:2 that counts its per-cycle init() re-checks."""

    def __init__(self):
        super().__init__("mock-gpu", 2, memory_mb=16384)
        self.cycles = 0

    def init(self):
        self.cycles += 1
        super().init()


def test_identical_cycles_leave_the_file_alone_and_sigterm_cleans_up(tmp_path):
    manager = _CountingManager()
    out, target = _port_daemon(tmp_path, "churn", make_manager=lambda: manager,
                               **{"sleep-interval": "0.02s", "reconcile": "interval"})
    mtimes = set()

    def cycled(path):
        if path.exists():
            mtimes.add(path.stat().st_mtime_ns)
        return manager.cycles >= 4

    _, restart = _drive(target, out, cycled)
    assert restart is False
    assert len(mtimes) == 1, f"unchanged labels were rewritten: {mtimes}"
    assert not out.exists() and not (tmp_path / "tfd-tmp").exists()


@pytest.mark.parametrize("reconcile", ["interval", "event"])
def test_sighup_returns_restart_and_removes_the_file(tmp_path, reconcile):
    out, target = _port_daemon(tmp_path, "hup", reconcile=reconcile)
    _, restart = _drive(target, out, os.path.exists, sig=signal.SIGHUP)
    assert restart is True and not out.exists()


def test_failing_backend_publishes_degraded_like_the_twin(tmp_path, monkeypatch):
    """The degraded set is the twin's: the timestamp, the DMI machine type
    and the interconnect (empty here), with the degraded marker."""
    from gpu_feature_discovery_tpu.resource import factory as twin_factory

    def broken(*_args, **_kwargs):
        raise RuntimeError("backend will not init")

    monkeypatch.setattr(twin_factory, "_get_manager", broken)
    dmi = tmp_path / "product_name"
    dmi.write_text("HGX H100 8-GPU\n")
    cli = {"fail-on-init-error": "false", "machine-type-file": str(dmi)}
    out, target = _port_daemon(tmp_path, "port", make_manager=broken, **cli)
    got, _ = _drive(target, out, os.path.exists)
    twin_out, twin_target = _twin_daemon(tmp_path, "twin", backends="auto", **cli)
    want, _ = _drive(twin_target, twin_out, os.path.exists)
    assert _no_timestamp(got) == ["nvidia.com/gpu.machine=HGX-H100-8-GPU",
                                  f"{DEGRADED_LABEL}=true"]
    assert _no_timestamp(got) == sorted(_translated_key(l) for l in _no_timestamp(want))
    assert any(l.startswith(TIMESTAMP) for l in got)


def test_auto_on_a_gpu_node_whose_cuda_will_not_init_goes_degraded(tmp_path, monkeypatch):
    """NVML loads but CUDA will not init: under --backends auto the
    daemon publishes the degraded set and keeps retrying, never the Null
    manager's empty device set."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(factory, "detect_gpu_platform", lambda: (True, "test"))
    dmi = tmp_path / "product_name"
    dmi.write_text("HGX H100 8-GPU\n")
    out, target = _port_daemon(tmp_path, "auto", backends="auto",
                               **{"fail-on-init-error": "false",
                                  "probe-isolation": "none",
                                  "machine-type-file": str(dmi)})
    got, restart = _drive(target, out, os.path.exists)
    assert restart is False
    assert _no_timestamp(got) == ["nvidia.com/gpu.machine=HGX-H100-8-GPU",
                                  f"{DEGRADED_LABEL}=true"]


def test_no_cuda_device_goes_degraded_then_exits_at_the_bound(tmp_path, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "tfd"
    rc = start(["--backends", "gpu", "--init-retries", "2",
                "--init-backoff-max", "10ms", "--sleep-interval", "10ms",
                "--reconcile", "interval", "--output-file", str(out)])
    assert rc == 1  # InitRetriesExhausted under --fail-on-init-error
    assert not out.exists()


def test_state_dir_restores_before_the_backend_inits(tmp_path):
    state_dir = tmp_path / "state"
    out, target = _port_daemon(tmp_path, "live", **{"state-dir": str(state_dir)})
    live, _ = _drive(target, out, os.path.exists)

    def broken():
        raise RuntimeError("backend will not init")

    out, target = _port_daemon(tmp_path, "restored", make_manager=broken,
                               **{"state-dir": str(state_dir),
                                  "fail-on-init-error": "false"})
    restored, _ = _drive(target, out, os.path.exists)
    assert "nvidia.com/gpu.tfd.restored=true" in restored
    assert "nvidia.com/gpu.count=2" in restored
    assert set(_no_timestamp(live)) <= set(restored)


def test_heartbeat_and_timings_file_follow_each_cycle(tmp_path):
    import json

    beat, timings = tmp_path / "beat", tmp_path / "timings.json"
    out, target = _port_daemon(
        tmp_path, "obs", **{"heartbeat-file": str(beat), "timings-file": str(timings)}
    )
    _drive(target, out, lambda p: p.exists() and beat.exists() and timings.exists())
    stages = json.loads(timings.read_text())["stages_ms"]
    assert {"labelgen.total", "labeler.device", "labeler.timestamp"} <= set(stages)


def test_oneshot_sequential_engine_keeps_the_golden(tmp_path):
    out = tmp_path / "tfd"
    assert start(["--oneshot", "--parallel-labelers", "false", "--backends",
                  "mock-gpu:2", "--output-file", str(out)]) == 0
    assert _matches_golden([l for l in out.read_text().splitlines() if l.strip()])


@pytest.mark.parametrize(
    "argv,env,slice_name",
    [
        # The config file is ported: its refusals are the twin's.
        (["--config-file", "missing.yaml"], {}, "error opening config file"),
        ([], {"TFD_CONFIG_FILE": "v2.yaml"}, "unknown version"),
        (["--reconcile", "sometimes"], {}, "reconcile"),
    ],
)
def test_unported_options_exit_1_naming_the_slice(tmp_path, monkeypatch, caplog,
                                                  argv, env, slice_name):
    (tmp_path / "v2.yaml").write_text("version: v2\n")
    monkeypatch.chdir(tmp_path)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    out = tmp_path / "tfd"
    with caplog.at_level("ERROR", logger="tfd"):
        assert start(argv + ["--backends", "mock-gpu:2", "--output-file",
                             str(out)]) == 1
    assert slice_name in caplog.text
    assert not out.exists()


@pytest.mark.parametrize("value", ["60s", "1m30s", "100ms", "2.5", "1h", "0",
                                   "", "5x", "s", "1s2"])
def test_parse_duration_matches_twin(value):
    def outcome(fn):
        try:
            return fn(value)
        except Exception as e:  # noqa: BLE001 - both must refuse alike
            return type(e).__name__

    assert outcome(flags.parse_duration) == outcome(twin_flags.parse_duration)


def test_cli_daemon_cycles_reloads_and_exits_on_real_signals(tmp_path):
    out = tmp_path / "tfd"
    env = dict(os.environ, TFD_BURNIN_ALLOW_CPU="1", TFD_BURNIN_GEOMETRY="128x2")
    env.pop("TFD_BACKEND", None)
    log_path = tmp_path / "log"
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "gpu_feature_discovery_tpu_torch",
             "--with-burnin", "--backends", "mock-gpu:2", "--sleep-interval",
             "0.1s", "--output-file", str(out)],
            cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT,
        )

    def wait_for(cond, what, timeout=60.0):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if cond():
                return
            time.sleep(0.02)
        raise AssertionError(f"{what}; log:\n{log_path.read_text()[-3000:]}")

    def health_published():
        return out.exists() and "nvidia.com/gpu.health.ok=true" in out.read_text()

    try:
        wait_for(health_published, "no health labels")
        proc.send_signal(signal.SIGHUP)
        wait_for(lambda: log_path.read_text().count("Start running") >= 2,
                 "no reload after SIGHUP")
        wait_for(health_published, "no health labels after the reload")
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=30)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert rc == 0
    assert not out.exists() and not (tmp_path / "tfd-tmp").exists()
    lines = [l for l in log_path.read_text().splitlines()]
    assert any("Received SIGHUP, restarting." in l for l in lines)
