"""The twin's event-driven reconcile tier (``tests/test_events.py``) held
against the port's ``cmd/events.py`` and ``cmd/main.py:run``:

1. the wait primitive (``ReconcileLoop``): the staleness-bound wake,
   debounce coalescing, the token-bucket storm guard under the staleness
   bound, signal and config-change preemption from every wait;
2. the producers: ``SignalForwarder``, ``ConfigFileWatcher``,
   ``DeltaTracker``;
3. the daemon: ``POST /probe`` wakes a cycle against a 60 s interval, a
   moved health verdict wakes follow-up cycles, a changed config file
   reloads the epoch, SIGTERM interrupts a supervisor backoff wait.

The deterministic cases (mode resolution, coalescing counts, the delta
tracker's verdicts, the seeded interleavings) run the twin's module and
the port's on the same input and want the same wakes. Keys are the
port's (``nvidia.com/gpu.``); the daemon cases run the port's
``mock-gpu:4`` (the twin's ``mock:v4-8``). Ports come from the slice
harness's range below the ephemeral one, as the other port test files
take them."""

import queue
import random
import signal
import threading
import time
import urllib.error
import urllib.request

import pytest

from gpu_feature_discovery_tpu.cmd import events as twin_ev
from gpu_feature_discovery_tpu.config import new_config as twin_new_config
from gpu_feature_discovery_tpu.lm.labels import Labels as TwinLabels
from gpu_feature_discovery_tpu_torch.cmd import events as ev
from gpu_feature_discovery_tpu_torch.cmd.main import run
from gpu_feature_discovery_tpu_torch.cmd.supervisor import Supervisor
from gpu_feature_discovery_tpu_torch.config import new_config
from gpu_feature_discovery_tpu_torch.lm.labeler import Empty
from gpu_feature_discovery_tpu_torch.lm.labels import Labels
from gpu_feature_discovery_tpu_torch.obs import metrics as obs_metrics
from gpu_feature_discovery_tpu_torch.resource import factory
from gpu_feature_discovery_tpu_torch.utils import faults
from torch_env_guard import resolved_cache_dir_restored  # noqa: F401 - autouse
from torch_slice_fixture import free_port


@pytest.fixture(autouse=True)
def _clean_metrics_and_faults():
    obs_metrics.reset_for_tests()
    faults.reset()
    yield
    faults.reset()


def make_loop(mod=ev, events=None, **kw):
    events = events if events is not None else mod.EventQueue()
    defaults = dict(max_staleness=5.0, debounce=0.02, max_probe_rate=1000.0)
    defaults.update(kw)
    return events, mod.ReconcileLoop(events, **defaults)


# ---------------------------------------------------------------------------
# mode resolution
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cli,want", [
    ({}, "event"), ({"oneshot": True}, "interval"),
    ({"reconcile": "interval"}, "interval"), ({"reconcile": "event"}, "event"),
])
def test_mode_resolution_is_the_twins(cli, want):
    values = dict({"oneshot": False}, **cli)
    assert ev.resolve_reconcile_mode(new_config(cli_values=values, environ={})) == want
    assert twin_ev.resolve_reconcile_mode(twin_new_config(cli_values=values, environ={})) == want


def test_auto_resolves_event_for_daemon_interval_for_oneshot():
    assert ev.resolve_reconcile_mode(new_config(cli_values={"oneshot": False}, environ={})) == "event"
    assert ev.resolve_reconcile_mode(new_config(cli_values={"oneshot": True}, environ={})) == "interval"


def test_forced_mode_wins():
    for mode in ("interval", "event"):
        config = new_config(cli_values={"oneshot": True, "reconcile": mode}, environ={})
        assert ev.resolve_reconcile_mode(config) == mode


# ---------------------------------------------------------------------------
# the wait primitive
# ---------------------------------------------------------------------------

def test_idle_queue_wakes_at_the_staleness_bound():
    _, loop = make_loop(max_staleness=0.05)
    t0 = time.monotonic()
    wake = loop.wait_for_wake()
    elapsed = time.monotonic() - t0
    assert wake.decision is None
    assert wake.reasons == (ev.REASON_STALENESS_BOUND,)
    assert 0.04 <= elapsed < 3.0
    assert obs_metrics.RECONCILE_WAKES.value(reason="staleness_bound") == 1


def test_event_storm_in_one_debounce_window_is_one_cycle():
    """Ten rapid events in one window: one wake in the twin and the port,
    the same reasons, the same coalesced count."""
    wakes = {}
    for name, mod in (("twin", twin_ev), ("port", ev)):
        events, loop = make_loop(mod, debounce=0.1)
        for i in range(10):
            events.post(mod.Event(mod.REASON_HEALTH_DELTA if i % 2 else mod.REASON_PROBE_REQUEST))
        wake = loop.wait_for_wake()
        wakes[name] = (wake.decision, wake.coalesced, set(wake.reasons))
    assert wakes["port"] == wakes["twin"] == (
        None, 9, {ev.REASON_HEALTH_DELTA, ev.REASON_PROBE_REQUEST})
    assert obs_metrics.RECONCILE_COALESCED.value() == 9
    assert obs_metrics.RECONCILE_WAKES.value(reason="probe_request") == 1
    assert obs_metrics.RECONCILE_WAKES.value(reason="health_delta") == 0


def test_signal_preempts_immediately_and_maps_like_check_signal():
    decisions = {}
    for name, mod in (("twin", twin_ev), ("port", ev)):
        events, loop = make_loop(mod, max_staleness=30.0)
        seen = []
        for event in (mod.Event(mod.REASON_SIGNAL, signum=signal.SIGTERM),
                      mod.Event(mod.REASON_SIGNAL, signum=signal.SIGHUP),
                      mod.Event(mod.REASON_CONFIG_CHANGED)):
            events.post(event)
            t0 = time.monotonic()
            seen.append(loop.wait_for_wake().decision)
            assert time.monotonic() - t0 < 5.0
        decisions[name] = seen
    assert decisions["port"] == decisions["twin"] == ["shutdown", "restart", "restart"]


def test_signal_inside_the_debounce_window_preempts_the_cycle():
    events, loop = make_loop(debounce=10.0, max_staleness=30.0)
    events.post(ev.Event(ev.REASON_PROBE_REQUEST))
    events.post(ev.Event(ev.REASON_SIGNAL, signum=signal.SIGTERM))
    t0 = time.monotonic()
    assert loop.wait_for_wake().decision == "shutdown"
    assert time.monotonic() - t0 < 5.0


def test_token_bucket_defers_wakes_beyond_the_rate():
    events, loop = make_loop(debounce=0.0, max_staleness=30.0, max_probe_rate=5.0, burst=1.0)
    events.post(ev.Event(ev.REASON_PROBE_REQUEST))
    t0 = time.monotonic()
    assert loop.wait_for_wake().decision is None
    assert time.monotonic() - t0 < 3.0
    events.post(ev.Event(ev.REASON_PROBE_REQUEST))
    t0 = time.monotonic()
    wake = loop.wait_for_wake()
    deferred = time.monotonic() - t0
    assert wake.decision is None
    # One token refills in 1/5 s; the twin's margin for clock grain.
    assert deferred >= 0.1, f"storm guard did not defer ({deferred:.3f}s)"


def test_staleness_bound_dominates_a_dry_bucket():
    events, loop = make_loop(debounce=0.0, max_staleness=0.3, max_probe_rate=0.01, burst=1.0)
    events.post(ev.Event(ev.REASON_HEALTH_DELTA))
    assert loop.wait_for_wake().decision is None
    events.post(ev.Event(ev.REASON_HEALTH_DELTA))
    t0 = time.monotonic()
    wake = loop.wait_for_wake()
    assert wake.decision is None
    assert ev.REASON_STALENESS_BOUND in wake.reasons
    assert time.monotonic() - t0 < 5.0, "a dry bucket must not outwait the bound"


def test_wait_backoff_interrupts_on_signal_and_absorbs_events():
    events, loop = make_loop()
    events.post(ev.Event(ev.REASON_PROBE_REQUEST))
    t0 = time.monotonic()
    assert loop.wait_backoff(0.05) is None
    assert time.monotonic() - t0 >= 0.04
    assert obs_metrics.RECONCILE_COALESCED.value() == 1

    def late_sigterm():
        time.sleep(0.05)
        events.post(ev.Event(ev.REASON_SIGNAL, signum=signal.SIGTERM))

    threading.Thread(target=late_sigterm, daemon=True).start()
    t0 = time.monotonic()
    assert loop.wait_backoff(30.0) == "shutdown"
    assert time.monotonic() - t0 < 5.0


# ---------------------------------------------------------------------------
# producers
# ---------------------------------------------------------------------------

def test_signal_forwarder_forwards_and_reinjects_on_stop():
    sigs = queue.SimpleQueue()
    events = ev.EventQueue()
    forwarder = ev.SignalForwarder(sigs, events).start()
    sigs.put(signal.SIGTERM)
    deadline = time.monotonic() + 5
    event = None
    while event is None and time.monotonic() < deadline:
        event = events.get(0.05)
    assert event is not None and event.signum == signal.SIGTERM
    sigs.put(signal.SIGHUP)
    time.sleep(0.05)
    forwarder.stop()
    leftovers = []
    while True:
        try:
            leftovers.append(sigs.get_nowait())
        except queue.Empty:
            break
    assert signal.SIGHUP in leftovers


def test_config_watcher_posts_config_changed_once(tmp_path):
    path = tmp_path / "config.yaml"
    path.write_text("version: v1\n")
    events = ev.EventQueue()
    watcher = ev.ConfigFileWatcher(str(path), events, poll_s=0.02)
    watcher.start()
    try:
        time.sleep(0.08)
        assert events.get_nowait() is None, "an unchanged file must not post"
        path.write_text("version: v1\nflags: {}\n")
        deadline = time.monotonic() + 5
        event = None
        while event is None and time.monotonic() < deadline:
            event = events.get(0.05)
        assert event is not None and event.reason == ev.REASON_CONFIG_CHANGED
    finally:
        watcher.stop()


def _tracker_script(mod, labels_cls, prefix):
    """The twin's delta-tracker script in one namespace; the reasons each
    observation posted, None where it posted nothing."""
    events = mod.EventQueue()
    tracker = mod.DeltaTracker(events)
    posted = []

    def observe(labels=None, peers=0):
        if peers != 0:
            tracker.observe_peers(peers)
        else:
            tracker.observe_labels(labels_cls({prefix + k: v for k, v in labels.items()}))
        event = events.get_nowait()
        posted.append(event.reason if event else None)

    observe({"chips.sick": "0", "count": "4"})
    observe({"chips.sick": "0", "count": "8"})
    observe({"chips.sick": "0", "count": "8", "health.probe-ms": "1234",
             "health.matmul-tflops": "91.2", "chip.0.tflops": "91.2"})
    observe({"chips.sick": "1", "count": "8"})
    observe(peers=None)
    observe(peers=frozenset({1, 2, 3}))
    observe(peers=frozenset({1, 2}))
    return posted


def test_delta_tracker_baselines_first_then_posts_on_change():
    port = _tracker_script(ev, Labels, "nvidia.com/gpu.")
    twin = _tracker_script(twin_ev, TwinLabels, "google.com/tpu.")
    assert port == twin == [None, None, None, ev.REASON_HEALTH_DELTA,
                            None, None, ev.REASON_PEER_DELTA]


# ---------------------------------------------------------------------------
# the daemon
# ---------------------------------------------------------------------------

def cfg(tmp_path, **cli):
    machine = tmp_path / "machine-type"
    machine.write_text("Test Node\n")
    values = {"oneshot": False, "machine-type-file": str(machine),
              "output-file": str(tmp_path / "tfd"), "metrics-port": "0"}
    values.update(cli)
    return new_config(cli_values=values, environ={})


def start_daemon(config, interconnect=None, config_file=None):
    sigs = queue.Queue()
    result = {}

    def target():
        try:
            result["restart"] = run(
                lambda: factory.build_manager(config), config, sigs,
                supervisor=Supervisor(config),
                interconnect=interconnect if interconnect is not None else Empty(),
                config_file=config_file,
            )
        except BaseException as e:  # noqa: BLE001 - surfaced by the test
            result["error"] = e

    t = threading.Thread(target=target)
    t.start()
    return t, sigs, result


def wait_until(pred, timeout=15.0, interval=0.005):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(interval)
    return pred()


def _post_probe(port, token):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/probe", data=b"", method="POST",
                                 headers={"X-TFD-Probe-Token": token} if token else {})
    try:
        with urllib.request.urlopen(req, timeout=5) as resp:
            return resp.status
    except urllib.error.HTTPError as e:
        return e.code


def test_post_probe_wakes_a_cycle_against_a_long_interval(tmp_path, monkeypatch):
    monkeypatch.setenv("TFD_BACKEND", "mock-gpu:4")
    port = free_port()
    config = cfg(tmp_path, **{"sleep-interval": "60s", "reconcile-debounce": "0.02s",
                              "metrics-addr": "127.0.0.1", "metrics-port": str(port),
                              "probe-token": "sekrit"})
    t, sigs, result = start_daemon(config)
    try:
        assert wait_until(lambda: obs_metrics.CYCLES_TOTAL.value(outcome="full") >= 1), \
            result.get("error")
        before = obs_metrics.CYCLES_TOTAL.value(outcome="full")
        assert _post_probe(port, "wrong") == 401
        time.sleep(0.2)
        assert obs_metrics.CYCLES_TOTAL.value(outcome="full") == before, \
            "an unauthenticated probe must not wake a cycle"
        assert _post_probe(port, "sekrit") == 202
        assert wait_until(lambda: obs_metrics.CYCLES_TOTAL.value(outcome="full") > before), \
            "POST /probe did not wake a cycle"
        assert obs_metrics.RECONCILE_WAKES.value(reason="probe_request") >= 1
    finally:
        sigs.put(signal.SIGTERM)
        t.join(timeout=10)
    assert not t.is_alive()
    assert "error" not in result, result.get("error")


class _ChurningHealth:
    """An interconnect whose health-projected label moves every cycle."""

    def __init__(self):
        self.cycles = 0

    def labels(self):
        self.cycles += 1
        return Labels({"nvidia.com/gpu.chips.sick": str(self.cycles % 2)})


def test_health_delta_wakes_follow_up_cycles(tmp_path, monkeypatch):
    """After one POST /probe exposes the change, HEALTH_DELTA wakes keep
    coming despite a 60 s interval; the first cycle only baselines."""
    monkeypatch.setenv("TFD_BACKEND", "mock-gpu:4")
    churn = _ChurningHealth()
    port = free_port()
    config = cfg(tmp_path, **{"sleep-interval": "60s", "reconcile-debounce": "0.01s",
                              "max-probe-rate": "200", "metrics-addr": "127.0.0.1",
                              "metrics-port": str(port), "probe-token": "sekrit"})
    t, sigs, result = start_daemon(config, interconnect=churn)
    try:
        assert wait_until(lambda: churn.cycles >= 1), result.get("error")
        assert wait_until(lambda: _post_probe(port, "sekrit") == 202, timeout=5)
        assert wait_until(lambda: churn.cycles >= 5, timeout=20), (
            f"health deltas did not wake follow-up cycles "
            f"(cycles={churn.cycles}, error={result.get('error')})")
        assert obs_metrics.RECONCILE_WAKES.value(reason="health_delta") >= 2
    finally:
        sigs.put(signal.SIGTERM)
        t.join(timeout=10)
    assert not t.is_alive()
    assert "error" not in result, result.get("error")


def test_config_file_change_reloads_the_epoch(tmp_path, monkeypatch):
    monkeypatch.setenv("TFD_BACKEND", "mock-gpu:4")
    monkeypatch.setattr(ev, "CONFIG_POLL_S", 0.03)
    config_path = tmp_path / "config.yaml"
    config_path.write_text("version: v1\n")
    config = cfg(tmp_path, **{"sleep-interval": "60s"})
    t, sigs, result = start_daemon(config, config_file=str(config_path))
    try:
        assert wait_until(lambda: obs_metrics.CYCLES_TOTAL.value(outcome="full") >= 1), \
            result.get("error")
        config_path.write_text("version: v1\nflags: {}\n")
        assert wait_until(lambda: not t.is_alive(), timeout=15), \
            "config change did not end the epoch"
    finally:
        sigs.put(signal.SIGTERM)
        t.join(timeout=10)
    assert result.get("restart") is True, result
    assert obs_metrics.RECONCILE_WAKES.value(reason="config_changed") == 1


def test_sigterm_interrupts_a_supervisor_backoff_wait(tmp_path, monkeypatch):
    monkeypatch.setenv("TFD_BACKEND", "mock-gpu:4")
    faults.load_fault_spec("generate:raise:RuntimeError:99")
    config = cfg(tmp_path, **{"sleep-interval": "0.01s", "init-backoff-max": "30s",
                              "max-consecutive-failures": "50"})
    t, sigs, result = start_daemon(config)
    try:
        # After the 5th failure the next delay is >= ~14 s: the loop is
        # parked in the backoff wait.
        assert wait_until(lambda: obs_metrics.CONSECUTIVE_CYCLE_FAILURES.value() >= 5,
                          timeout=30), result.get("error")
        time.sleep(0.3)
        t0 = time.monotonic()
        sigs.put(signal.SIGTERM)
        t.join(timeout=10)
        elapsed = time.monotonic() - t0
        assert not t.is_alive(), "SIGTERM did not interrupt the backoff wait"
        assert elapsed < 8.0, f"shutdown took {elapsed:.1f}s"
    finally:
        faults.reset()
        if t.is_alive():
            sigs.put(signal.SIGTERM)
            t.join(timeout=10)
    assert result.get("restart") is False


# ---------------------------------------------------------------------------
# interleavings from seeds: never deadlock, never skip the staleness wake
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(8))
def test_reconcile_event_interleavings_never_deadlock(seed):
    rng = random.Random(1000 + seed)
    script = [(rng.choice([ev.REASON_WORKER_DIED, ev.REASON_HEALTH_DELTA,
                           ev.REASON_PEER_DELTA, ev.REASON_PROBE_REQUEST]),
               rng.random() * 0.01) for _ in range(80)]
    events = ev.EventQueue()
    loop = ev.ReconcileLoop(events, max_staleness=0.15,
                            debounce=rng.choice([0.0, 0.005, 0.02]),
                            max_probe_rate=rng.choice([0.5, 5.0, 500.0]))

    def producer():
        for reason, pause in script:
            events.post(ev.Event(reason))
            if pause > 0.005:
                time.sleep(pause)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    for _ in range(10):
        t0 = time.monotonic()
        wake = loop.wait_for_wake()
        assert wake.decision is None, wake
        # The twin's bound: staleness + debounce + loaded-host slack.
        assert time.monotonic() - t0 < 0.15 + 0.02 + 3.0
    t.join(timeout=10)
    assert not t.is_alive()
    for _ in range(200):
        wake = loop.wait_for_wake()
        assert wake.decision is None
        if wake.reasons == (ev.REASON_STALENESS_BOUND,):
            break
    else:
        raise AssertionError("staleness-bound wake never came")
    events.post(ev.Event(ev.REASON_PROBE_REQUEST))
    events.post(ev.Event(ev.REASON_SIGNAL, signum=signal.SIGTERM))
    deadline = time.monotonic() + 10
    decision = None
    while decision is None and time.monotonic() < deadline:
        decision = loop.wait_for_wake().decision
    assert decision == "shutdown"
