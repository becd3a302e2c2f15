"""Verdict actuation of the PyTorch port (``actuation/engine.py``), held
against its JAX twin on the CPU.

Every scenario of the twin's tests/test_actuation.py runs a twin engine
and a port engine side by side on one script: the same label sequence
(made in the port's keys and translated ``nvidia.com/gpu.`` ->
``google.com/tpu.`` for the twin), the same fake clock, the same scripted
``signals``. After each cycle the two outputs are equal after the key
translation, exactly (the lease is an integer stamp of the shared
clock), and at the end the ``tfd_actuation_*`` series of the two
registries are equal, exactly. Seeded random scripts run the same way.

Then the supervisor's three lease seams beside the twin's, the daemon
scenarios in the port's in-process harness beside the twin's
``SliceHarness`` (fire within the window and clear, SIGHUP across off ->
advise -> enforce, a warm restart that does not resurrect lapsed advice,
the slice budget), and the pin that ``--actuation off`` leaves the label
file as the cycle without actuation writes it.
"""

import json
import os
import queue
import signal
import time

import numpy as np
import pytest

from slice_fixture import SliceHarness
from torch_slice_fixture import PortSliceHarness

from gpu_feature_discovery_tpu.actuation import engine as twin_engine
from gpu_feature_discovery_tpu.config import new_config as twin_new_config
from gpu_feature_discovery_tpu.lm.labels import Labels as TwinLabels
from gpu_feature_discovery_tpu.obs import metrics as twin_metrics
from gpu_feature_discovery_tpu_torch.actuation import engine
from gpu_feature_discovery_tpu_torch.actuation.engine import (
    ACTUATION_LEASE_LABEL,
    ADVICE_LABELS,
    CORDON_ADVICE_LABEL,
    DRAIN_ADVICE_LABEL,
    SCHEDULABLE_LABEL,
    WOULD_CORDON_LABEL,
    ActuationEngine,
    advice_present,
    budget_allowance,
    drop_lapsed_advice,
    new_actuation_engine,
)
from gpu_feature_discovery_tpu_torch.cmd import main as port_main
from gpu_feature_discovery_tpu_torch.config.flags import new_config
from gpu_feature_discovery_tpu_torch.config.spec import ConfigError
from gpu_feature_discovery_tpu_torch.lm.engine import STALE_SOURCES_LABEL
from gpu_feature_discovery_tpu_torch.lm.health import CHIPS_HEALTHY, CHIPS_SICK, STRAGGLER_CHIP
from gpu_feature_discovery_tpu_torch.lm.labels import Labels
from gpu_feature_discovery_tpu_torch.obs import metrics
from gpu_feature_discovery_tpu_torch.resource import factory
from torch_env_guard import resolved_cache_dir_restored  # noqa: F401 - autouse

TPU, GPU = "google.com/tpu.", "nvidia.com/gpu."
FAMILIES = ("tfd_actuation_advice", "tfd_actuation_budget_exhausted",
            "tfd_actuation_transitions_total", "tfd_actuation_convergence_cycles")


def to_twin(labels):
    return {(TPU + k[len(GPU):] if k.startswith(GPU) else k): v for k, v in labels.items()}


def to_port(labels):
    return {(GPU + k[len(TPU):] if k.startswith(TPU) else k): v for k, v in labels.items()}


def _series(module):
    """{sample: value} of the actuation families in ``module``'s registry."""
    out = {}
    for line in module.REGISTRY.render().splitlines():
        if line.startswith("#"):
            continue
        key, value = line.rsplit(" ", 1)
        if key.split("{", 1)[0] in FAMILIES:
            out[key] = float(value)
    return out


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    metrics.reset_for_tests()
    twin_metrics.reset_for_tests()
    for name in ("TFD_BACKEND", "WORKER_HOSTNAMES", "WORKER_ID", "TFD_FAULT_SPEC"):
        monkeypatch.delenv(name, raising=False)
    yield
    metrics.reset_for_tests()
    twin_metrics.reset_for_tests()


# ---------------------------------------------------------------------------
# the engine side by side
# ---------------------------------------------------------------------------

def _sick(n=3):
    return {CHIPS_HEALTHY: str(8 - n), CHIPS_SICK: str(n)}


def _healthy():
    return {CHIPS_HEALTHY: "8", CHIPS_SICK: "0"}


class Pair:
    """A twin engine and a port engine on one clock and one signals
    script. ``project`` runs both on the same cycle and checks that the
    outputs agree after the key translation; it returns the port's."""

    def __init__(self, mode="enforce", window=2, fraction=0.25, ttl=120.0,
                 worker_id=0, signals=None, t0=1000.0):
        self.now = t0
        self.total = 4
        clock = lambda: self.now  # noqa: E731
        sig = None if signals is None else (lambda: (self.total, dict(signals)))
        self.twin = twin_engine.ActuationEngine(mode, window, fraction, ttl, clock=clock,
                                                worker_id=worker_id, signals=sig)
        self.port = ActuationEngine(mode, window, fraction, ttl, clock=clock,
                                    worker_id=worker_id, signals=sig)

    def project(self, labels, mode="full"):
        port_in = Labels(labels)
        twin_in = TwinLabels(to_twin(labels))
        before_port, before_twin = dict(port_in), dict(twin_in)
        port_out = self.port.project(port_in, mode)
        twin_out = self.twin.project(twin_in, mode)
        assert dict(port_out) == to_port(twin_out)
        # Neither mutates its input, and both return the input object
        # exactly when nothing changes.
        assert dict(port_in) == before_port and dict(twin_in) == before_twin
        assert (port_out is port_in) == (twin_out is twin_in)
        return port_out

    def series(self):
        port = _series(metrics)
        assert port == _series(twin_metrics)
        return port


@pytest.mark.parametrize("hosts,fraction,allowed", [
    (4, 0.25, 1), (3, 0.25, 1), (6, 0.25, 2), (64, 0.25, 16), (64, 0.5, 32),
    (4, 0.5, 2), (3, 0.5, 2), (1, 0.25, 1), (8, 0.125, 1), (100, 0.99, 99),
])
def test_budget_allowance_exact_boundaries(hosts, fraction, allowed):
    assert budget_allowance(hosts, fraction) == twin_engine.budget_allowance(
        hosts, fraction) == allowed


def test_budget_allowance_never_zero():
    for hosts in (1, 2, 3, 7, 64):
        assert budget_allowance(hosts, 0.0001) == twin_engine.budget_allowance(
            hosts, 0.0001) == 1


def test_advice_labels_are_the_twins_translated():
    assert ADVICE_LABELS == tuple(to_port({k: ""}).popitem()[0]
                                  for k in twin_engine.ADVICE_LABELS)
    assert (engine.REASON_SICK_CHIPS, engine.REASON_STRAGGLER, engine.LEASE_TTL_FACTOR) == (
        twin_engine.REASON_SICK_CHIPS, twin_engine.REASON_STRAGGLER,
        twin_engine.LEASE_TTL_FACTOR)


def test_advice_fires_only_after_window_holds():
    e = Pair(window=3)
    for _ in range(2):
        assert not advice_present(e.project(_sick()))
    out = e.project(_sick())
    assert out[SCHEDULABLE_LABEL] == "false"
    assert out[CORDON_ADVICE_LABEL] == "sick-chips"
    assert DRAIN_ADVICE_LABEL not in out
    assert out[ACTUATION_LEASE_LABEL] == "1120"
    assert e.series()["tfd_actuation_convergence_cycles"] == 3


def test_advice_clears_only_after_clean_window():
    e = Pair(window=2)
    e.project(_sick())
    e.project(_sick())
    assert advice_present(e.project(_healthy()))
    out = e.project(_healthy())
    assert dict(out) == _healthy()
    assert e.series()['tfd_actuation_transitions_total{action="cleared"}'] == 1


def test_one_bad_cycle_between_streaks_does_not_fire():
    e = Pair(window=2)
    e.project(_sick())
    # The clean cycle resets nothing until it holds a window itself.
    assert not advice_present(e.project(_healthy()))
    assert e.series()["tfd_actuation_advice"] == 0


def test_straggler_verdict_adds_drain_advice():
    e = Pair(window=1)
    out = e.project({STRAGGLER_CHIP: "chip.3"})
    assert out[CORDON_ADVICE_LABEL] == "straggler"
    assert out[DRAIN_ADVICE_LABEL] == "true"


def test_advise_mode_emits_would_cordon_only():
    e = Pair(mode="advise", window=1)
    out = e.project(_sick())
    assert out[WOULD_CORDON_LABEL] == "sick-chips"
    assert not {SCHEDULABLE_LABEL, CORDON_ADVICE_LABEL, DRAIN_ADVICE_LABEL} & set(out)
    assert ACTUATION_LEASE_LABEL in out


def test_project_never_mutates_the_input_set():
    e = Pair(window=1)
    sick = Labels(_sick())
    out = e.port.project(sick, "full")
    assert advice_present(out) and dict(sick) == _sick() and out is not sick
    e.twin.project(TwinLabels(to_twin(_sick())), "full")
    e.series()


def test_project_returns_input_object_when_nothing_changes():
    e = Pair(window=2)
    base = Labels(_healthy())
    assert e.port.project(base, "full") is base
    e.project(_healthy())


def test_the_clear_window_names_the_straggler_reason_as_the_twins_does():
    """A fault shared with the twin (ROADMAP.md queue 3): while held
    advice waits out its clean window, the reason is re-derived from the
    clean cycle's verdicts, which name no sick device, so it reads
    ``straggler`` (without drain advice) until the advice clears."""
    e = Pair(window=2)
    e.project(_sick())
    assert e.project(_sick())[CORDON_ADVICE_LABEL] == "sick-chips"
    out = e.project(_healthy())
    assert out[CORDON_ADVICE_LABEL] == "straggler" and DRAIN_ADVICE_LABEL not in out
    assert not advice_present(e.project(_healthy()))


def test_lease_renews_at_half_life_not_every_cycle():
    e = Pair(window=1, ttl=100.0)
    first = e.project(_sick())[ACTUATION_LEASE_LABEL]
    e.now += 10
    assert e.project(_sick())[ACTUATION_LEASE_LABEL] == first
    e.now += 45
    assert int(e.project(_sick())[ACTUATION_LEASE_LABEL]) > int(first)


def test_degraded_cycles_reapply_advice_under_original_lease():
    e = Pair(window=1, ttl=100.0)
    lease = e.project(_sick())[ACTUATION_LEASE_LABEL]
    e.now += 60
    assert e.project(_healthy(), "degraded")[ACTUATION_LEASE_LABEL] == lease


def test_advice_lapses_on_degraded_cycles_past_lease():
    e = Pair(window=1, ttl=50.0)
    assert advice_present(e.project(_sick()))
    e.now += 60
    assert not advice_present(e.project(_healthy(), "degraded"))
    assert e.series()['tfd_actuation_transitions_total{action="lease-lapsed"}'] == 1


def test_stale_source_cycles_do_not_advance_streaks():
    e = Pair(window=2)
    sick = {**_sick(), STALE_SOURCES_LABEL: "gpu"}
    for _ in range(3):
        e.project(sick)
    assert not advice_present(e.project(sick))


def test_budget_suppresses_out_of_allowance_worker():
    e = Pair(window=1, worker_id=2, signals={0: True, 1: True})
    assert not advice_present(e.project(_sick()))
    series = e.series()
    assert series["tfd_actuation_budget_exhausted"] == 1
    assert series['tfd_actuation_transitions_total{action="budget-suppressed"}'] == 1


def test_budget_permits_lowest_ranked_candidate():
    e = Pair(window=1, worker_id=0, signals={2: True, 3: True})
    assert advice_present(e.project(_sick()))
    assert e.series()["tfd_actuation_budget_exhausted"] == 0


def test_budget_withdraws_advice_when_reranked_out():
    desires = {}
    e = Pair(window=1, worker_id=1, signals=desires)
    assert advice_present(e.project(_sick()))
    desires[0] = True
    assert not advice_present(e.project(_sick()))
    assert e.series()["tfd_actuation_budget_exhausted"] == 1


def test_uncoordinated_engine_always_permitted():
    e = Pair(window=1)
    assert e.port._signals is None
    assert advice_present(e.project(_sick()))


@pytest.mark.parametrize("seed", range(10))
def test_seeded_cycle_scripts_match_the_twin(seed):
    """Random verdicts, cycle modes, clock steps and peer desires: the two
    engines agree on every cycle's labels and on the series at the end."""
    rng = np.random.default_rng(seed)
    desires = {}
    e = Pair(mode=["enforce", "advise"][seed % 2], window=int(rng.integers(1, 4)),
             fraction=float(rng.choice([0.25, 0.5, 0.75])),
             ttl=float(rng.choice([3.0, 20.0, 120.0])),
             worker_id=int(rng.integers(0, 4)), signals=desires)
    e.total = int(rng.integers(1, 9))
    fired = 0
    for _ in range(200):
        labels = {"nvidia.com/gpu.count": "8"}
        r = rng.random()
        if r < 0.45:
            labels.update(_sick(int(rng.integers(1, 4))))
        elif r < 0.55:
            labels[STRAGGLER_CHIP] = f"chip.{int(rng.integers(0, 8))}"
        elif r < 0.6:
            labels[CHIPS_SICK] = "junk"
        else:
            labels.update(_healthy())
        if rng.random() < 0.1:
            labels[STALE_SOURCES_LABEL] = "gpu"
        if rng.random() < 0.1:
            # Advice riding in: a restored overlay or a damped re-serve.
            labels[SCHEDULABLE_LABEL] = "false"
            labels[ACTUATION_LEASE_LABEL] = str(int(e.now) + int(rng.integers(-5, 5)))
        if rng.random() < 0.2:
            peer = int(rng.integers(0, 8))
            desires[peer] = bool(rng.random() < 0.5)
        mode = "full" if rng.random() < 0.8 else str(rng.choice(["degraded", "reserved"]))
        e.now += float(rng.choice([0.5, 1.0, 7.0]))
        fired += advice_present(e.project(labels, mode))
    assert fired > 0
    e.series()


# ---------------------------------------------------------------------------
# construction from the flags
# ---------------------------------------------------------------------------

def test_off_constructs_no_engine():
    assert new_actuation_engine(new_config({})) is None
    assert new_actuation_engine(new_config({"actuation": "off"})) is None
    assert twin_engine.new_actuation_engine(twin_new_config({})) is None


@pytest.mark.parametrize("cli", [
    {"actuation": "bogus"}, {"max-actuated-fraction": "1.5"}, {"actuation-window": "0"},
])
def test_invalid_actuation_mode_rejected(cli):
    with pytest.raises(ConfigError) as port:
        new_config(cli)
    with pytest.raises(Exception) as twin:
        twin_new_config(cli)
    assert str(port.value) == str(twin.value)


@pytest.mark.parametrize("cli,ttl", [
    ({"actuation": "enforce", "actuation-window": "4", "max-actuated-fraction": "0.5",
      "max-staleness": "30s"}, 60.0),
    ({"actuation": "advise", "sleep-interval": "0.5s"}, 1.0),
    ({"actuation": "enforce"}, 120.0),
])
def test_engine_built_from_flags_and_staleness_bound(cli, ttl):
    port = new_actuation_engine(new_config(cli))
    twin = twin_engine.new_actuation_engine(twin_new_config(cli))
    for e in (port, twin):
        assert (e.mode, e._window, e._fraction, e._lease_ttl) == (
            cli["actuation"], int(cli.get("actuation-window", 2)),
            float(cli.get("max-actuated-fraction", 0.25)), ttl)
    assert port._signals is None and port._worker_id == 0


def test_engine_reads_the_coordinators_budget_signals():
    class Coordinator:
        worker_id = 2

        def actuation_signals(self):
            return 3, {1: True}

    e = new_actuation_engine(new_config({"actuation": "enforce", "actuation-window": "1"}),
                             Coordinator())
    assert e._worker_id == 2
    assert not advice_present(e.project(Labels(_sick()), "full"))


# ---------------------------------------------------------------------------
# the supervisor's lease seams, beside the twin's
# ---------------------------------------------------------------------------

def _write_state(state_dir, labels):
    os.makedirs(state_dir, exist_ok=True)
    with open(os.path.join(state_dir, "last-good-labels.json"), "w") as f:
        json.dump({"version": 1, "labels": labels}, f)


def _advised_state(lease):
    return {GPU + "health.ok": "false", CHIPS_SICK: "3", GPU + "count": "1",
            SCHEDULABLE_LABEL: "false", CORDON_ADVICE_LABEL: "sick-chips",
            ACTUATION_LEASE_LABEL: str(lease)}


def _both_restored(tmp_path, state):
    from gpu_feature_discovery_tpu.cmd.supervisor import Supervisor as TwinSupervisor
    from gpu_feature_discovery_tpu_torch.cmd.supervisor import Supervisor

    _write_state(str(tmp_path / "port"), state)
    _write_state(str(tmp_path / "twin"), to_twin(state))
    port = Supervisor(new_config({"state-dir": str(tmp_path / "port")}))
    twin = TwinSupervisor(twin_new_config({"state-dir": str(tmp_path / "twin")}))
    got, want = port.restore_last_good(), twin.restore_last_good()
    assert dict(got) == to_port(want)
    return port, twin, got


def test_restore_drops_expired_advice_keeps_inventory(tmp_path):
    _, _, restored = _both_restored(tmp_path, _advised_state(int(time.time()) - 10))
    assert not advice_present(restored)
    assert restored[CHIPS_SICK] == "3"
    assert _series(metrics) == _series(twin_metrics)
    assert _series(metrics)['tfd_actuation_transitions_total{action="lease-lapsed"}'] == 1


def test_restore_keeps_still_leased_advice(tmp_path):
    lease = int(time.time()) + 3600
    port, twin, restored = _both_restored(tmp_path, _advised_state(lease))
    assert restored[SCHEDULABLE_LABEL] == "false"
    assert restored[ACTUATION_LEASE_LABEL] == str(lease)
    # The restored overlay keeps it while the lease holds.
    fresh = {GPU + "machine": "node"}
    overlay = port.with_restored(Labels(fresh))
    assert dict(overlay) == to_port(twin.with_restored(TwinLabels(to_twin(fresh))))
    assert overlay[ACTUATION_LEASE_LABEL] == str(lease)


def test_restored_overlay_drops_advice_once_its_lease_lapses(tmp_path, monkeypatch):
    lease = int(time.time()) + 5
    port, twin, _ = _both_restored(tmp_path, _advised_state(lease))
    real = time.time
    monkeypatch.setattr(time, "time", lambda: real() + 60)
    fresh = {GPU + "machine": "node"}
    overlay = port.with_restored(Labels(fresh))
    assert dict(overlay) == to_port(twin.with_restored(TwinLabels(to_twin(fresh))))
    assert not advice_present(overlay) and overlay[GPU + "tfd.restored"] == "true"
    assert _series(metrics) == _series(twin_metrics)


def test_reserve_labels_age_advice_out_of_failed_cycle_reserves():
    from gpu_feature_discovery_tpu.cmd.supervisor import Supervisor as TwinSupervisor
    from gpu_feature_discovery_tpu_torch.cmd.supervisor import Supervisor

    port, twin = Supervisor(new_config({})), TwinSupervisor(twin_new_config({}))
    served = _advised_state(int(time.time()) - 5)
    port.cycle_succeeded(Labels(served), mode="full")
    twin.cycle_succeeded(TwinLabels(to_twin(served)), mode="full")
    for _ in range(2):
        reserve = port.reserve_labels()
        assert dict(reserve) == to_port(twin.reserve_labels())
        assert not advice_present(reserve)
    # One warning and one transition, not one per failed cycle.
    assert _series(metrics) == _series(twin_metrics)
    assert _series(metrics)['tfd_actuation_transitions_total{action="lease-lapsed"}'] == 1


def test_drop_lapsed_advice_passthrough_is_byte_free():
    labels = Labels({GPU + "health.ok": "true"})
    assert drop_lapsed_advice(labels) is labels


def test_drop_lapsed_advice_unparseable_lease_reads_as_lapsed():
    labels = {SCHEDULABLE_LABEL: "false", ACTUATION_LEASE_LABEL: "not-a-stamp"}
    got = drop_lapsed_advice(Labels(labels))
    assert not advice_present(got)
    assert dict(got) == to_port(twin_engine.drop_lapsed_advice(TwinLabels(to_twin(labels))))


# ---------------------------------------------------------------------------
# daemons: the port's harness beside the twin's SliceHarness
# ---------------------------------------------------------------------------

def _advice(labels, ns):
    return {k[len(ns):]: v for k, v in labels.items()
            if (GPU + k[len(ns):] if k.startswith(ns) else k) in ADVICE_LABELS}


def _wait(harness, predicate, what, timeout=30):
    deadline = time.monotonic() + timeout
    snap = {}
    while time.monotonic() < deadline:
        snap = {w.worker_id: w.labels() for w in harness.workers}
        if predicate(snap):
            return snap
        for w in harness.workers:
            assert "error" not in w.result, w.result.get("error")
        time.sleep(0.01)
    raise AssertionError(f"timed out waiting for {what}: {snap}")


def _no_advice_for(harness, seconds=0.5):
    deadline = time.monotonic() + seconds
    while time.monotonic() < deadline:
        for w in harness.workers:
            assert not advice_present(to_port(w.labels())), w.worker_id
        time.sleep(0.02)


def _fired(ns):
    return lambda snap: (snap[0].get(ns + "schedulable") == "false"
                         and snap[0].get(ns + "tfd.cordon-advice") == "sick-chips"
                         and ns + "tfd.actuation-lease" in snap[0])


def _cleared(ns):
    return lambda snap: (not advice_present(to_port(snap[0]))
                         and snap[0].get(ns + "chips.sick", "0") in ("0", ""))


def test_daemon_enforce_fires_within_window_and_clears(tmp_path):
    cli = {"actuation": "enforce", "actuation-window": "2"}
    with SliceHarness(tmp_path / "twin", workers=1, coordination="off", sick_workers=(0,),
                      extra_cli=cli) as twin, \
            PortSliceHarness(tmp_path / "port", workers=1, coordination="off",
                             sick_workers=(0,), extra_cli=cli) as port:
        t = _wait(twin, _fired(TPU), "the twin's advice")
        p = _wait(port, _fired(GPU), "the port's advice")
        assert set(_advice(p[0], GPU)) == set(_advice(t[0], TPU)) == {
            "schedulable", "tfd.cordon-advice", "tfd.actuation-lease"}
        assert metrics.ACTUATION_CONVERGENCE_CYCLES.value() == \
            twin_metrics.ACTUATION_CONVERGENCE_CYCLES.value() == 2
        # Heal at the measurement boundary: the advice follows the verdict
        # after the clean window.
        twin.workers[0].interconnect.sick = 0
        port.workers[0].interconnect.sick = 0
        _wait(twin, _cleared(TPU), "the twin's advice to clear")
        _wait(port, _cleared(GPU), "the port's advice to clear")
        for action in ("fired", "cleared"):
            assert metrics.ACTUATION_TRANSITIONS.value(action=action) == \
                twin_metrics.ACTUATION_TRANSITIONS.value(action=action) == 1


def _restart(harness, mode):
    worker = harness.workers[0]
    worker.sigs.put(signal.SIGHUP)
    worker.thread.join(timeout=10)
    assert worker.result.get("restart") is True
    worker.config.flags.tfd.actuation = mode
    harness.start_worker(0)


def test_daemon_mode_transitions_across_sighup_epochs(tmp_path):
    """off -> advise -> enforce across SIGHUP reloads: each epoch builds
    its engine from the changed config; nothing under off, would-cordon
    alone under advise, the advice family under enforce."""
    cli = {"actuation": "off", "actuation-window": "1"}
    twin = SliceHarness(tmp_path / "twin", workers=1, coordination="off", sick_workers=(0,),
                        extra_cli=cli)
    port = PortSliceHarness(tmp_path / "port", workers=1, coordination="off",
                            sick_workers=(0,), extra_cli=cli)
    try:
        twin.start()
        port.start()
        for h, ns in ((twin, TPU), (port, GPU)):
            _wait(h, lambda s, ns=ns: s[0].get(ns + "chips.sick") == "1", "the sick verdict")
        _no_advice_for(twin)
        _no_advice_for(port)
        steps = [("advise", lambda s, ns: s[0].get(ns + "tfd.would-cordon") == "sick-chips"
                  and ns + "schedulable" not in s[0]),
                 ("enforce", lambda s, ns: s[0].get(ns + "schedulable") == "false"
                  and ns + "tfd.would-cordon" not in s[0])]
        for mode, predicate in steps:
            seen = []
            for h, ns in ((twin, TPU), (port, GPU)):
                _restart(h, mode)
                snap = _wait(h, lambda s, ns=ns: predicate(s, ns), f"advice under {mode}")
                seen.append(set(_advice(snap[0], ns)))
            assert seen[0] == seen[1], mode
    finally:
        twin.stop()
        port.stop()


def test_daemon_warm_restart_does_not_resurrect_expired_advice(tmp_path):
    """Advice fires and persists with its lease; the daemon dies long
    enough for the lease to lapse (the state file aged in place); the
    restarted epoch restores the inventory but never the advice."""
    cli = {"actuation": "enforce", "actuation-window": "1"}
    state = {}
    for side, harness_cls, ns, workdir in (
            ("twin", SliceHarness, TPU, "worker-0"),
            ("port", PortSliceHarness, GPU, "port-worker-0")):
        root = tmp_path / side
        path = root / workdir / "state" / "last-good-labels.json"
        with harness_cls(root, workers=1, coordination="off", sick_workers=(0,),
                         extra_cli=cli) as h:
            _wait(h, lambda s, ns=ns: s[0].get(ns + "schedulable") == "false", "advice")
            _wait(h, lambda s, ns=ns: path.exists() and ns + "schedulable" in (
                json.loads(path.read_text()).get("labels") or {}), "the advised state")
        doc = json.loads(path.read_text())
        doc["labels"][ns + "tfd.actuation-lease"] = str(int(time.time()) - 30)
        path.write_text(json.dumps(doc))
        state[side] = (root, ns, path)
    seen = {}
    for side, harness_cls in (("twin", SliceHarness), ("port", PortSliceHarness)):
        root, ns, _ = state[side]
        with harness_cls(root, workers=1, coordination="off", extra_cli=cli) as h:
            snap = _wait(h, lambda s, ns=ns: bool(s[0]), "the restarted epoch's first write")
            assert not advice_present(to_port(snap[0]))
            _no_advice_for(h)
            seen[side] = (metrics if side == "port" else twin_metrics
                          ).ACTUATION_TRANSITIONS.value(action="lease-lapsed")
    assert seen["port"] == seen["twin"] == 1


def test_slice_budget_caps_advised_hosts_end_to_end(tmp_path):
    """Three coordinated workers all carry the verdict: allowance(3, 0.25)
    is 1, so worker 0 alone converges to advice and the rest raise the
    budget gauge, in both."""
    cli = {"actuation": "enforce", "actuation-window": "3"}

    def converged(ns):
        return lambda snap: [w for w, l in snap.items() if ns + "schedulable" in l] == [0]

    with SliceHarness(tmp_path / "twin", workers=3, sick_workers=(0, 1, 2),
                      extra_cli=cli) as twin, \
            PortSliceHarness(tmp_path / "port", workers=3, sick_workers=(0, 1, 2),
                             extra_cli=cli) as port:
        _wait(twin, converged(TPU), "the twin's budget-allowed worker alone advised")
        _wait(port, converged(GPU), "the port's budget-allowed worker alone advised")
        time.sleep(0.5)
        for h, ns in ((twin, TPU), (port, GPU)):
            assert converged(ns)({w.worker_id: w.labels() for w in h.workers})
        assert metrics.ACTUATION_BUDGET_EXHAUSTED.value() == \
            twin_metrics.ACTUATION_BUDGET_EXHAUSTED.value() == 1
        # No snapshot carries advice; the verdicts ride it.
        for w in port.workers:
            doc = w.coordinator.snapshot_payload()
            assert not advice_present(doc["labels"]) and doc["chips"]["sick"] == 1


def test_a_sick_mig_device_reaches_slice_sick_chips_and_cordon_advice(tmp_path, monkeypatch):
    """Three coordinated daemons on ``mixed`` MIG nodes (mock-nvml), each
    probing its MIG devices through its own burn-in, with GPU 1's first
    MIG device sick (the pinned probes stand in process,
    tests/torch_mig_fakes.py): each node's own verdict reads chips.sick=1,
    and the leader's slice.sick-chips and the budget-capped cordon advice
    are those of three nodes with one sick GPU each."""
    from torch_mig_fakes import MigWorkers

    cli = {"actuation": "enforce", "actuation-window": "3"}

    def converged(snap):
        return ([w for w, l in snap.items() if GPU + "schedulable" in l] == [0]
                and snap[0].get(GPU + "slice.sick-chips") == "3")

    def outcome(harness):
        snap = _wait(harness, converged, "worker 0 alone advised, 3 sick chips")
        # slice.capable is a node fact (MIG capability), not the slice's.
        return ({k: v for k, v in snap[0].items()
                 if k.startswith(GPU + "slice.") and k != GPU + "slice.capable"},
                _advice({k: v for k, v in snap[0].items()
                         if k != GPU + "tfd.actuation-lease"}, GPU),
                [snap[w].get(GPU + "chips.sick") for w in range(3)])

    with PortSliceHarness(tmp_path / "gpu", workers=3, sick_workers=(0, 1, 2),
                          extra_cli=cli) as gpu:
        want = outcome(gpu)
    monkeypatch.setenv("TFD_BURNIN_ALLOW_CPU", "1")
    monkeypatch.setenv("TFD_BURNIN_GEOMETRY", "64x1")
    workers = MigWorkers(monkeypatch, sick={(1, 0)})
    with PortSliceHarness(tmp_path / "mig", workers=3, backends="mock-nvml:mixed",
                          extra_cli={**cli, "with-burnin": "true",
                                     "burnin-interval": "1"}) as mig:
        got = outcome(mig)
        labels = mig.workers[1].labels()
    assert got == want and want[2] == ["1", "1", "1"]
    assert (labels[GPU + "chip.0.ok"], labels[GPU + "chip.1.ok"]) == ("true", "false")
    assert labels[GPU + "health.ok"] == "false"
    assert (1, 0) in {w for w, _ in workers.requests}


def test_actuation_off_writes_what_the_cycle_without_actuation_writes(tmp_path):
    """At --actuation off (the default) a confirmed verdict changes
    nothing: the daemon's file is byte for byte the oneshot cycle's (which
    has no projection and no supervisor) over the same sources, and no
    actuation series moves."""
    with PortSliceHarness(tmp_path / "port", workers=1, coordination="off",
                          sick_workers=(0,), extra_cli={"no-timestamp": "true"}) as port:
        worker = port.workers[0]
        assert worker.config.flags.tfd.actuation == "off"
        _wait(port, lambda s: s[0].get(CHIPS_SICK) == "1" and GPU + "count" in s[0],
              "the sick verdict")
        _no_advice_for(port)
        raw = worker.raw_output()
        config0 = worker.config
    out = tmp_path / "oneshot-tfd"
    control = new_config(cli_values={
        "oneshot": True, "backends": "mock-gpu:2", "output-file": str(out),
        "machine-type-file": config0.flags.tfd.machine_type_file, "no-timestamp": "true",
    }, environ={})
    interconnect = type(worker.interconnect)(port_main.new_interconnect_labeler(control))
    assert port_main.run(factory.new_manager(control), control, queue.Queue(),
                         interconnect=interconnect) is False
    assert raw == out.read_text()
    assert all(v == 0 for v in _series(metrics).values())


# ---------------------------------------------------------------------------
# two CLI daemons through the broker
# ---------------------------------------------------------------------------

def _scrape(port):
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
    try:
        conn.request("GET", "/metrics")
        body = conn.getresponse().read().decode()
    finally:
        conn.close()
    return {line.rsplit(" ", 1)[0]: float(line.rsplit(" ", 1)[1])
            for line in body.splitlines()
            if line.startswith("tfd_actuation") and not line.startswith("#")}


def _file_labels(path):
    try:
        return dict(l.split("=", 1) for l in path.read_text().splitlines() if "=" in l)
    except OSError:
        return {}


def _state_labels(state_dir):
    """The labels of a daemon's ``--state-dir`` document, or {}."""
    try:
        return json.loads((state_dir / "last-good-labels.json").read_text())["labels"]
    except (OSError, ValueError, KeyError):
        return {}


def test_cli_daemons_advise_and_a_restart_after_the_lease_restores_none(tmp_path):
    """Worker 1's card verdict (``chip.0.sick``, its one probe) becomes
    advice two cycles on, never rides its snapshot; killed, and restarted
    on its state once the lease lapsed, it restores no advice.

    Every scrape of worker 1 waits until the process of that moment has
    logged its server on its port (another test may hold the port while it
    is free: the kill to the restart's bind), and the lease waited out is
    the dead process's last one, read after the kill (a renewal may land
    between a read before it and the kill, and the state holds it). The
    kill waits until the state holds the advice: the advice reaches the
    label file a moment before the state file."""
    import subprocess
    import sys
    from pathlib import Path

    from test_torch_slice import _request
    from torch_slice_fixture import free_ports

    repo = Path(__file__).resolve().parent.parent
    ports = free_ports(2)
    outs = [tmp_path / f"w{i}.tfd" for i in range(2)]
    procs = []
    logs = {}

    def start(i, fault):
        env = dict(os.environ, TFD_BURNIN_ALLOW_CPU="1", TFD_BURNIN_GEOMETRY="64x1",
                   WORKER_HOSTNAMES=",".join(f"127.0.0.1:{p}" for p in ports), WORKER_ID=str(i))
        env.pop("TFD_BACKEND", None)
        env.pop("TFD_FAULT_SPEC", None)
        if fault:
            env["TFD_FAULT_SPEC"] = fault
        logs[i] = tmp_path / f"w{i}-{len(procs)}.log"
        log = open(logs[i], "w")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "gpu_feature_discovery_tpu_torch", "--with-burnin",
             "--backends", "mock-gpu:2", "--sleep-interval", "0.3s", "--burnin-interval",
             "100000", "--probe-timeout", "60s", "--output-file", str(outs[i]),
             "--state-dir", str(tmp_path / f"state{i}"), "--metrics-addr", "127.0.0.1",
             "--metrics-port", str(ports[i]), "--peer-token", "tok",
             "--actuation", "enforce", "--actuation-window", "2"],
            cwd=repo, env=env, stdout=log, stderr=subprocess.STDOUT))
        log.close()
        return procs[-1]

    def wait(cond, what, timeout=60):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            got = cond()
            if got:
                return got
            time.sleep(0.05)
        tails = [p.read_text()[-2000:] for p in sorted(tmp_path.glob("*.log"))]
        raise AssertionError(f"timed out waiting for {what}: {tails}")

    def serving(i):
        """Until worker i's current process serves on its port."""
        line = f"Introspection server listening on 127.0.0.1:{ports[i]}"
        wait(lambda: line in logs[i].read_text(), f"worker {i}'s server on its port")

    try:
        start(0, "")
        w1 = start(1, "chip.0.sick:fail:1")
        labels = wait(lambda: (lambda l: l if l.get(SCHEDULABLE_LABEL) == "false" else None)(
            _file_labels(outs[1])), "worker 1's advice")
        assert labels[CORDON_ADVICE_LABEL] == "sick-chips" and labels[CHIPS_SICK] == "1"
        assert int(labels[ACTUATION_LEASE_LABEL]) > time.time()
        serving(1)
        series = _scrape(ports[1])
        assert (series["tfd_actuation_advice"], series["tfd_actuation_convergence_cycles"],
                series['tfd_actuation_transitions_total{action="fired"}']) == (1, 2, 1)
        assert not advice_present(_file_labels(outs[0]))
        code, _, body = _request(ports[1], "/peer/snapshot", {"X-TFD-Probe-Token": "tok"})
        doc = json.loads(body)
        assert code == 200 and not advice_present(doc["labels"]) and doc["chips"]["sick"] == 1
        # A cycle writes its label file before it saves its state, in both
        # packages: killed in between, the state is a cycle behind and holds
        # no advice to drop, so the restart counts no lease-lapsed.
        wait(lambda: advice_present(_state_labels(tmp_path / "state1")),
             "worker 1's state to hold its advice")
        w1.kill()
        w1.wait(timeout=30)
        last = _file_labels(outs[1])
        assert advice_present(last)
        lease = int(last[ACTUATION_LEASE_LABEL])
        wait(lambda: time.time() > lease + 0.2, "worker 1's lease to lapse", timeout=10)
        start(1, "")
        restored = wait(lambda: (lambda l: l if l.get(GPU + "tfd.restored") == "true"
                                 else None)(_file_labels(outs[1])), "the restored write")
        assert not advice_present(restored) and restored[CHIPS_SICK] == "1"
        serving(1)
        series = _scrape(ports[1])
        assert series['tfd_actuation_transitions_total{action="lease-lapsed"}'] == 1
        healthy = wait(lambda: (lambda l: l if l.get(CHIPS_SICK) == "0" else None)(
            _file_labels(outs[1])), "worker 1's healthy verdict after the restart")
        assert not advice_present(healthy)
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        assert [p.wait(timeout=30) for p in procs] == [0, -signal.SIGKILL, 0]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
