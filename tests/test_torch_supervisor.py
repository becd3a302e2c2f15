"""Daemon supervision: the PyTorch port's BackoffPolicy, Supervisor,
LabelStateStore and FlapDamper (gpu_feature_discovery_tpu_torch/
utils/retry.py, cmd/supervisor.py, sandbox/state.py, sandbox/flap.py)
against their JAX twins.

Each test feeds one scripted input to both packages and compares the
outputs after the one key translation google.com/tpu. -> nvidia.com/gpu.
(so the twin's google.com/tpu.tfd.* markers meet the port's
nvidia.com/gpu.tfd.* ones). Exact equality: delays come from the same
arithmetic on the same seeded random.Random."""

import json
import random

import pytest

from gpu_feature_discovery_tpu.cmd import supervisor as twin_sup
from gpu_feature_discovery_tpu.config import new_config as twin_new_config
from gpu_feature_discovery_tpu.lm.labels import Labels as TwinLabels
from gpu_feature_discovery_tpu.sandbox import flap as twin_flap
from gpu_feature_discovery_tpu.sandbox import state as twin_state
from gpu_feature_discovery_tpu.utils import retry as twin_retry
from gpu_feature_discovery_tpu_torch.cmd import supervisor as sup
from gpu_feature_discovery_tpu_torch.config.flags import new_config
from gpu_feature_discovery_tpu_torch.lm.labels import Labels
from gpu_feature_discovery_tpu_torch.sandbox import flap, state
from gpu_feature_discovery_tpu_torch.utils import retry


def _translated(labels):
    return {k.replace("google.com/tpu.", "nvidia.com/gpu.", 1): v
            for k, v in labels.items()}


def _to_twin(labels):
    return {k.replace("nvidia.com/gpu.", "google.com/tpu.", 1): v
            for k, v in labels.items()}


@pytest.mark.parametrize("jitter,seed", [(0.0, None), (0.1, 7), (0.5, 11)])
def test_backoff_delays_match_twin(jitter, seed):
    def policy(mod):
        rng = random.Random(seed) if seed is not None else random.Random()
        return mod.BackoffPolicy(base=0.5, factor=2.0, cap=9.0, jitter=jitter, rng=rng)

    want, got = policy(twin_retry), policy(retry)
    attempts = [0, 1, 2, 3, 4, 5, 70, 2000]
    assert [got.delay(a) for a in attempts] == [want.delay(a) for a in attempts]
    for p in (want, got):
        with pytest.raises(ValueError):
            p.delay(-1)


class _Clock:
    def __init__(self):
        self.now = 100.0

    def __call__(self):
        return self.now


FULL = {
    "google.com/tfd.timestamp": "1792000000",
    "nvidia.com/gpu.count": "2",
    "nvidia.com/gpu.product": "mock-gpu",
    "nvidia.com/gpu.health.ok": "true",
}


def _supervisors(tmp_path, **flags):
    values = {"oneshot": False, "init-retries": "3", "init-backoff-max": "4s",
              "max-consecutive-failures": "3"}
    values.update(flags)
    want_clock, got_clock = _Clock(), _Clock()
    want = twin_sup.Supervisor(twin_new_config(cli_values=values, environ={}),
                               clock=want_clock)
    got = sup.Supervisor(new_config(cli_values=values, environ={}), clock=got_clock)
    # One seeded generator each, so the jitter draws are the same.
    want._policy = twin_retry.BackoffPolicy(base=1.0, cap=4.0, rng=random.Random(3))
    got._policy = retry.BackoffPolicy(base=1.0, cap=4.0, rng=random.Random(3))
    return (want, want_clock, TwinLabels), (got, got_clock, Labels)


def _run_script(supervisor, clock, labels_cls, script):
    """Each step's observable outcome: what acquisition returned, the next
    init time, the reserve labels, the failure delays, the escalation."""
    def broken():
        raise RuntimeError("no device")

    out = []
    for step in script:
        if step == "init-fail":
            try:
                got = supervisor.acquire_manager(broken)
            except Exception as e:  # noqa: BLE001 - the escalation is the output
                out.append(("escalated", type(e).__name__))
                continue
            out.append(("init", got, supervisor._next_init_attempt - clock.now,
                        supervisor.degraded))
        elif step == "init-ok":
            got = supervisor.acquire_manager(lambda: "manager")
            out.append(("init", got, supervisor.degraded))
        elif step == "tick":
            clock.now += 5.0
        elif step.startswith("ok-"):
            full = FULL if labels_cls is Labels else _to_twin(FULL)
            supervisor.cycle_succeeded(labels_cls(full), mode=step[3:])
            out.append(("ok", supervisor.has_last_good))
        elif step == "fail":
            try:
                out.append(("fail", supervisor.cycle_failed(RuntimeError("cycle"))))
            except Exception as e:  # noqa: BLE001 - the escalation is the output
                out.append(("escalated", type(e).__name__))
        elif step == "reserve":
            out.append(("reserve", _translated(supervisor.reserve_labels())))
    return out


SCRIPTS = {
    "degraded-then-recovered-then-contained": [
        "reserve", "init-fail", "init-fail", "reserve", "tick", "init-fail",
        "tick", "init-ok", "ok-full", "fail", "reserve", "fail", "reserve",
        "ok-full", "reserve", "fail", "fail", "fail",
    ],
    "init-retries-escalate": ["init-fail", "tick", "init-fail", "tick", "init-fail"],
    "window-closed-is-not-an-attempt": ["init-fail", "init-fail", "init-ok", "tick",
                                        "init-ok"],
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
@pytest.mark.parametrize("fail_on_init", ["true", "false"])
def test_supervisor_script_matches_twin(tmp_path, name, fail_on_init):
    (want_s, want_c, want_l), (got_s, got_c, got_l) = _supervisors(
        tmp_path, **{"fail-on-init-error": fail_on_init}
    )
    want = _run_script(want_s, want_c, want_l, SCRIPTS[name])
    got = _run_script(got_s, got_c, got_l, SCRIPTS[name])
    # The twin's exception class names are the port's.
    assert got == want
    if name == "init-retries-escalate":
        assert (got[-1] == ("escalated", "InitRetriesExhausted")) == (
            fail_on_init == "true"
        )


def test_restore_overlay_and_persistence_match_twin(tmp_path):
    want_dir, got_dir = tmp_path / "twin", tmp_path / "port"
    results = []
    for mod, labels_cls, sdir, conf in (
        (twin_sup, TwinLabels, want_dir, twin_new_config),
        (sup, Labels, got_dir, new_config),
    ):
        config = conf(cli_values={"oneshot": False, "state-dir": str(sdir)}, environ={})
        first = mod.Supervisor(config)
        assert first.restore_last_good() is None
        full = FULL if labels_cls is Labels else _to_twin(FULL)
        first.cycle_succeeded(labels_cls(full), mode="full")
        second = mod.Supervisor(config)
        restored = second.restore_last_good()
        fresh = labels_cls({"google.com/tfd.timestamp": "1792000099"})
        overlay = second.with_restored(fresh)
        second.cycle_succeeded(overlay, mode="degraded")
        still = second.restored
        second.cycle_succeeded(labels_cls(full), mode="full")
        results.append((_translated(restored), _translated(overlay), still,
                        second.restored))
    assert results[1] == results[0]
    assert results[1][1][sup.RESTORED_LABEL] == "true"


@pytest.mark.parametrize("writer", ["twin", "port"])
def test_state_file_loads_in_the_other_package(tmp_path, writer):
    labels = {"nvidia.com/gpu.count": "8", "google.com/tfd.timestamp": "1"}
    w, r = (twin_state, state) if writer == "twin" else (state, twin_state)
    assert w.LabelStateStore(str(tmp_path)).save(labels)
    doc = json.loads((tmp_path / w.STATE_FILENAME).read_text())
    assert set(doc) == {"version", "saved_unix", "labels"}
    assert dict(r.LabelStateStore(str(tmp_path)).load()) == labels


@pytest.mark.parametrize("content", ["{", '{"version": 2, "labels": {"a": "b"}}',
                                     '{"version": 1, "labels": {}}',
                                     '{"version": 1, "labels": {"a": 1}}'])
def test_bad_state_files_load_as_nothing_like_twin(tmp_path, content):
    (tmp_path / state.STATE_FILENAME).write_text(content)
    assert state.LabelStateStore(str(tmp_path)).load() is None
    assert twin_state.LabelStateStore(str(tmp_path)).load() is None


FLAP_SEQUENCE = [
    {"nvidia.com/gpu.count": "2"},
    {"nvidia.com/gpu.count": "2", "google.com/tfd.timestamp": "5"},
    {"nvidia.com/gpu.count": "1"},
    {"nvidia.com/gpu.count": "2", "nvidia.com/gpu.tfd.stale-sources": "health"},
    {"nvidia.com/gpu.count": "1"},
    {"nvidia.com/gpu.count": "1", "nvidia.com/gpu.tfd.unhealthy-cycles": "1"},
    {"nvidia.com/gpu.count": "1"},
    {"nvidia.com/gpu.count": "1", "nvidia.com/gpu.tfd.degraded": "true"},
    {"nvidia.com/gpu.count": "1"},
]


@pytest.mark.parametrize("window", [1, 2, 3])
def test_flap_damper_sequence_matches_twin(window):
    want_d, got_d = twin_flap.FlapDamper(window), flap.FlapDamper(window)
    for labels in FLAP_SEQUENCE:
        want = want_d.observe(TwinLabels(_to_twin(labels)))
        got = got_d.observe(Labels(labels))
        assert dict(got) == _translated(want)
        assert got_d.suppressing == want_d.suppressing


def test_heartbeat_is_touched_and_never_fatal(tmp_path):
    beat = tmp_path / "beat"
    s = sup.Supervisor(new_config(
        cli_values={"heartbeat-file": str(beat)}, environ={}))
    s.touch_heartbeat()
    assert beat.exists()
    s = sup.Supervisor(new_config(
        cli_values={"heartbeat-file": str(tmp_path / "no" / "dir" / "beat")},
        environ={}))
    s.touch_heartbeat()  # logs once, raises nothing
    s.touch_heartbeat()
