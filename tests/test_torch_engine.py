"""The label engine: the PyTorch port (gpu_feature_discovery_tpu_torch/
lm/engine.py) against its JAX twin (gpu_feature_discovery_tpu/lm/
engine.py).

Both engines get the same scripted sources — one of them sleeping past
--labeler-timeout — and must give the same merged labels cycle by cycle,
after the one key translation google.com/tpu. -> nvidia.com/gpu.:
the same stale-sources value while the straggler runs, the same
harvest of its result on a later cycle, and the same number of calls
(a straggler is never resubmitted while in flight). Exact equality."""

import threading
import time

import pytest

from gpu_feature_discovery_tpu.lm import engine as twin
from gpu_feature_discovery_tpu.lm.labels import Labels as TwinLabels
from gpu_feature_discovery_tpu_torch.config.flags import new_config
from gpu_feature_discovery_tpu_torch.lm import engine
from gpu_feature_discovery_tpu_torch.lm.labels import Labels

TIMEOUT_S = 0.15


def _translated(labels):
    return {k.replace("google.com/tpu.", "nvidia.com/gpu.", 1): v
            for k, v in labels.items()}


class _Straggler:
    """A health source whose first call blocks until ``first`` is set and
    whose second blocks until ``second`` is set; later calls return at
    once. It records its calls."""

    def __init__(self, labels_cls, prefix):
        self.first = threading.Event()
        self.second = threading.Event()
        self.calls = 0
        self._labels_cls = labels_cls
        self._prefix = prefix

    def __call__(self):
        self.calls += 1
        call = self.calls
        gate = self.first if call == 1 else self.second
        assert gate.wait(10), "test gate never released"
        return self._labels_cls({f"{self._prefix}health.ok": f"call-{min(call, 2)}"})


def _sources(mod, labels_cls, prefix, straggler):
    return [
        mod.LabelSource("timestamp",
                        lambda: labels_cls({"google.com/tfd.timestamp": "1"}),
                        offload=False),
        mod.LabelSource("device", lambda: labels_cls({f"{prefix}count": "2"}),
                        offload=False),
        mod.LabelSource("health", straggler),
        mod.LabelSource("fast", lambda: labels_cls({f"{prefix}fast": "1"})),
    ]


def _wait_done(eng, name="health"):
    fut = eng._state[name].inflight
    deadline = time.monotonic() + 10
    while not fut.done() and time.monotonic() < deadline:
        time.sleep(0.005)
    assert fut.done()


def _script(mod, labels_cls, prefix):
    """Cycles A-D: stale with no cache, stale again (still in flight),
    stale served from the harvested first result, fresh."""
    straggler = _Straggler(labels_cls, prefix)
    eng = mod.LabelEngine(parallel=True, timeout_s=TIMEOUT_S)
    sources = _sources(mod, labels_cls, prefix, straggler)
    out = []
    try:
        out.append((dict(eng.generate(sources)), straggler.calls))
        out.append((dict(eng.generate(sources)), straggler.calls))
        straggler.first.set()
        _wait_done(eng)
        out.append((dict(eng.generate(sources)), straggler.calls))
        straggler.second.set()
        _wait_done(eng)
        out.append((dict(eng.generate(sources)), straggler.calls))
    finally:
        straggler.first.set()
        straggler.second.set()
        eng.close()
    return out


def test_straggler_cycle_script_matches_twin():
    want = _script(twin, TwinLabels, "google.com/tpu.")
    got = _script(engine, Labels, "nvidia.com/gpu.")
    assert [(dict(labels), calls) for labels, calls in got] == [
        (_translated(labels), calls) for labels, calls in want
    ]
    stale = engine.STALE_SOURCES_LABEL
    assert [labels.get(stale) for labels, _ in got] == [
        "health", "health", "health", None
    ]
    assert got[2][0]["nvidia.com/gpu.health.ok"] == "call-1"  # harvested
    assert got[3][0]["nvidia.com/gpu.health.ok"] == "call-2"
    assert [calls for _, calls in got] == [1, 1, 2, 3]


@pytest.mark.parametrize("parallel", [True, False])
def test_merge_order_and_errors_match_twin(parallel):
    def build(mod, labels_cls, prefix):
        return [
            mod.LabelSource("a", lambda: labels_cls({f"{prefix}x": "a", f"{prefix}y": "a"})),
            mod.LabelSource("b", lambda: labels_cls({f"{prefix}y": "b"}), offload=False),
            mod.LabelSource("c", lambda: labels_cls({f"{prefix}x": "c"})),
        ]

    want_eng = twin.LabelEngine(parallel=parallel, timeout_s=5)
    got_eng = engine.LabelEngine(parallel=parallel, timeout_s=5)
    try:
        want = want_eng.generate(build(twin, TwinLabels, "google.com/tpu."))
        got = got_eng.generate(build(engine, Labels, "nvidia.com/gpu."))
        assert list(got.items()) == list(_translated(want).items())

        def boom():
            raise RuntimeError("source failed")

        for mod, eng in ((twin, want_eng), (engine, got_eng)):
            with pytest.raises(RuntimeError, match="source failed"):
                eng.generate([mod.LabelSource("bad", boom)])
    finally:
        want_eng.close()
        got_eng.close()


def test_new_label_engine_reads_the_flags():
    eng = engine.new_label_engine(new_config(
        cli_values={"parallel-labelers": "false", "labeler-timeout": "250ms"},
        environ={},
    ))
    assert eng._parallel is False and eng._timeout_s == 0.25
    eng = engine.new_label_engine(new_config(cli_values={}, environ={}))
    assert eng._parallel is True and eng._timeout_s == 10.0


def test_close_cancels_an_inflight_source_with_a_hook():
    gate = threading.Event()
    cancelled = []
    eng = engine.LabelEngine(parallel=True, timeout_s=0.05)
    src = engine.LabelSource(
        "slow", lambda: (gate.wait(10), Labels())[1], cancel=lambda: cancelled.append(1)
    )
    try:
        labels = eng.generate([src])
        assert labels[engine.STALE_SOURCES_LABEL] == "slow"
        assert cancelled == [1]  # the deadline miss escalates once
        eng.close()
        assert cancelled == [1]  # already cancelled: not again
    finally:
        gate.set()
