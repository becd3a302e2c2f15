"""The port's span tree (utils/timing.py over obs/spans.py), on the CPU.

- A daemon cycle on mock-gpu, through the broker and in process: the span
  names, each span's parent, and one cycle id on both sides of the pipe.
- On an injected clock: the four layers of tfd_probe_gap_seconds sum
  exactly to the time between two probes' device windows, and the
  cycle's children cover the cycle.
- tfd_fsyncs_total: 4 per written cycle with a state dir (the label file
  and its directory, the state file and its directory), none for a
  churn-free skipped write.
- The ring keeps the last 64 cycles, and no more spans per cycle than its
  slots hold.
- GET /debug/spans: Chrome trace-event JSON behind --debug-endpoints.
- The broker worker's start-up tree arrives once per spawn.
"""

import http.client
import json
import os
import queue
import signal
import threading
import time

import pytest

from gpu_feature_discovery_tpu_torch import sandbox
from gpu_feature_discovery_tpu_torch.cmd.main import run
from gpu_feature_discovery_tpu_torch.cmd.supervisor import Supervisor
from gpu_feature_discovery_tpu_torch.config.flags import new_config
from gpu_feature_discovery_tpu_torch.lm import health
from gpu_feature_discovery_tpu_torch.lm.labels import Labels
from gpu_feature_discovery_tpu_torch.obs import metrics, server, spans
from gpu_feature_discovery_tpu_torch.resource import factory
from gpu_feature_discovery_tpu_torch.sandbox import BrokerClient
from gpu_feature_discovery_tpu_torch.sandbox.state import LabelStateStore
from gpu_feature_discovery_tpu_torch.utils import faults, timing
from torch_env_guard import resolved_cache_dir_restored  # noqa: F401 - autouse

BURNIN_ENV = {"TFD_BURNIN_ALLOW_CPU": "1", "TFD_BURNIN_GEOMETRY": "128x2",
              health.BURNIN_CPU_DEVICES_ENV: "2"}


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv(faults.FAULT_SPEC_ENV, raising=False)
    faults.reset()
    metrics.reset_for_tests()
    yield
    sandbox.set_broker_death_watch(False)
    sandbox.close_broker()
    health.reset_burnin_schedule()
    faults.reset()
    metrics.reset_for_tests()


def _config(tmp_path, **cli):
    values = {"backends": "mock-gpu:2", "output-file": str(tmp_path / "tfd"),
              "sleep-interval": "0s", "reconcile": "interval", "metrics-port": "0",
              "no-timestamp": True, "init-backoff-max": "0.02s"}
    values.update(cli)
    return new_config(cli_values=values, environ={})


def _count(family, **labels):
    child = family.labels(**labels)
    with family._lock:
        return sum(child.counts)


def _run_daemon(config, until, timeout=60.0):
    """cmd/main.run on a thread until ``until()`` holds, then SIGTERM."""
    sigs = queue.SimpleQueue()
    result = {}

    def target():
        try:
            result["restart"] = run(lambda: factory.build_manager(config), config, sigs,
                                    supervisor=Supervisor(config))
        except BaseException as e:  # noqa: BLE001 - surfaced below
            result["error"] = e

    t = threading.Thread(target=target)
    t.start()
    try:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline and not until() and t.is_alive():
            time.sleep(0.01)
        assert until(), "the daemon never reached the state the test waits for"
    finally:
        sigs.put(signal.SIGTERM)
        t.join(timeout=30)
    assert not t.is_alive()
    assert "error" not in result, result.get("error")


def _by_cycle(snapshot):
    out = {}
    for s in snapshot:
        out.setdefault(s[2], []).append(s)
    return out


def _one(cycle_spans, name):
    found = [s for s in cycle_spans if s[3] == name]
    assert len(found) == 1, (name, [s[3] for s in cycle_spans])
    return found[0]


# ---------------------------------------------------------------------------
# the tree of a daemon cycle
# ---------------------------------------------------------------------------

DAEMON_SPANS = {"cycle", "cycle.prepare", "labelgen.total", "labeler.health",
                "labeler.device", "cycle.publish", "labels.write", "state.save",
                "heartbeat", "cycle.wait", "probe.prepare", "probe.device",
                "probe.report"}


@pytest.mark.parametrize("broker", ["on", "off"])
def test_a_daemon_cycle_is_one_tree_across_the_pipe(tmp_path, monkeypatch, broker):
    for k, v in BURNIN_ENV.items():
        monkeypatch.setenv(k, v)
    config = _config(tmp_path, **{"with-burnin": True, "burnin-interval": "1",
                                  "probe-broker": broker, "state-dir": str(tmp_path / "st")})
    _run_daemon(config, lambda: _count(metrics.PROBE_GAP, layer="loop") >= 3)
    cycles = _by_cycle(spans.snapshot())
    probed = [c for c, ss in cycles.items()
              if c > 0 and any(s[3] == "probe.device" for s in ss)
              and any(s[3] == "cycle" for s in ss)]
    assert len(probed) >= 3
    ss = cycles[probed[-1]]
    names = {s[3] for s in ss}
    assert DAEMON_SPANS <= names, DAEMON_SPANS - names
    root = _one(ss, "cycle")
    ids = {s[0]: s for s in ss}
    assert root[1] == 0
    for s in ss:
        assert s[2] == root[2]  # one cycle id for every span, the worker's too
        if s is not root:
            assert s[1] in ids, f"{s[3]}'s parent is not in its cycle"
            parent = ids[s[1]]
            assert parent[4] <= s[4] and s[5] <= parent[5] + 1, (s[3], parent[3])

    def parent_of(name):
        return ids[_one(ss, name)[1]][3]

    for name in ("cycle.prepare", "labelgen.total", "cycle.publish", "state.save",
                 "heartbeat", "cycle.wait"):
        assert parent_of(name) == "cycle", name
    assert parent_of("labels.write") == "cycle.publish"
    assert parent_of("labeler.health") == "labelgen.total"
    daemon_pid = root[6]
    if broker == "on":
        assert parent_of("broker.rpc.health") == "labeler.health"
        assert parent_of("worker.health") == "broker.rpc.health"
        for name in ("probe.prepare", "probe.device", "probe.report"):
            assert parent_of(name) == "worker.health"
        worker = {s[6] for s in ss if s[3].startswith(("worker.", "probe."))}
        assert len(worker) == 1 and daemon_pid not in worker
    else:
        assert "broker.rpc.health" not in names
        for name in ("probe.prepare", "probe.device", "probe.report"):
            assert parent_of(name) == "labeler.health"
            assert _one(ss, name)[6] == daemon_pid
    # The probe's three spans tile its run.
    prep, dev, rep = (_one(ss, n) for n in ("probe.prepare", "probe.device", "probe.report"))
    assert prep[5] == dev[4] and dev[5] == rep[4]
    # The stage views are as they were: no span of the tree alone leaks in.
    assert not set(metrics.cycle_stages()) & {"cycle", "cycle.publish", "labels.write",
                                               "probe.device", "broker.rpc.health"}


# ---------------------------------------------------------------------------
# the gap split, on an injected clock
# ---------------------------------------------------------------------------

class _Clock:
    def __init__(self):
        self.t = 1_000_000_000

    def __call__(self):
        return self.t

    def tick(self, ns):
        self.t += ns


def _fake_cycle(clock, worker_pid, with_probe=True):
    """One cycle through the broker, every stamp from ``clock``; returns
    the probe's device window."""
    timing.begin_cycle()
    with timing.span("cycle.prepare"):
        clock.tick(10_000)
    window = None
    with timing.timed("labelgen.total"):
        clock.tick(200_000)
        with timing.timed("labeler.health"):
            clock.tick(50_000)
            rpc = timing.Open("broker.rpc.health")
            clock.tick(300_000)  # the pipe out
            if with_probe:
                w0 = clock()
                t = [w0]
                for step in (40_000, 1_500_000, 90_000, 20_000):  # prepare, device, report, reply
                    t.append(t[-1] + step)
                wid = (worker_pid << 32) | (rpc.cycle * 10)
                worker = [
                    [wid, rpc.id, rpc.cycle, "worker.health", t[0], t[4], worker_pid, 1],
                    [wid + 1, wid, rpc.cycle, "probe.prepare", t[0], t[1], worker_pid, 2],
                    [wid + 2, wid, rpc.cycle, "probe.device", t[1], t[2], worker_pid, 2],
                    [wid + 3, wid, rpc.cycle, "probe.report", t[2], t[3], worker_pid, 2],
                ]
                clock.tick(t[4] - w0)
                window = (t[1], t[2])
            clock.tick(250_000)  # the pipe back
            rpc.end()
            if with_probe:
                spans.fold(worker, rpc.id, rpc.cycle, pid=worker_pid, offset=(7, "test"))
            clock.tick(60_000)
        clock.tick(400_000)
    with timing.span("cycle.publish"):
        clock.tick(100_000)
        with timing.span("labels.write"):
            clock.tick(3_000_000)
    with timing.span("state.save"):
        clock.tick(2_000_000)
    with timing.span("heartbeat"):
        clock.tick(30_000)
    with timing.span("cycle.wait"):
        clock.tick(5_000)
    return window


def _gap_sums():
    out = {}
    for layer in spans.GAP_LAYERS:
        child = metrics.PROBE_GAP.labels(layer=layer)
        out[layer] = round(child.sum * 1e9)
    return out


def test_an_epochs_end_breaks_the_chain(monkeypatch):
    """No gap spans two epochs: each epoch's first probe starts a chain."""
    clock = _Clock()
    monkeypatch.setattr(spans, "now_ns", clock)
    for _ in range(3):
        _fake_cycle(clock, os.getpid() + 1)
        spans.end_cycle()
        clock.tick(1_000_000)
    assert _count(metrics.PROBE_GAP, layer="loop") == 0
    _fake_cycle(clock, os.getpid() + 1)
    _fake_cycle(clock, os.getpid() + 1)
    spans.end_cycle()
    assert _count(metrics.PROBE_GAP, layer="loop") == 1


def test_the_gap_split_is_exact_across_chained_cycles(monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(spans, "now_ns", clock)
    worker_pid = os.getpid() + 1
    windows = []
    cycle_ids = []
    for i in range(5):
        windows.append(_fake_cycle(clock, worker_pid, with_probe=(i != 2)))
        cycle_ids.append(spans.context()[0])
    spans.end_cycle()
    probes = [w for w in windows if w is not None]
    assert _count(metrics.PROBE_GAP, layer="loop") == len(probes) - 1
    sums = _gap_sums()
    between = sum(b[0] - a[1] for a, b in zip(probes, probes[1:]))
    assert sum(sums.values()) == between  # exact, in ns
    # Each layer where the fake cycle put it: the pipe's 300 + 250 us, the
    # labeler's 50 + 60 us and the worker's 40 + 90 + 20 us, labelgen.total's
    # 200 + 400 us, and the rest of the cycle.
    per_gap = {"broker": 550_000, "probe": 260_000, "labelgen": 600_000,
               "loop": 10_000 + 100_000 + 3_000_000 + 2_000_000 + 30_000 + 5_000}
    gaps = len(probes) - 1
    unprobed = 5 - len(probes)
    assert sums["broker"] == gaps * per_gap["broker"] + unprobed * 550_000
    assert sums["loop"] == gaps * per_gap["loop"] + unprobed * per_gap["loop"]
    assert sums["probe"] + sums["broker"] + sums["labelgen"] + sums["loop"] == between
    # The cycle's children cover it: on this clock nothing runs between them.
    cycles = _by_cycle(spans.snapshot())
    for cid in cycle_ids:
        ss = cycles[cid]
        root = _one(ss, "cycle")
        children = [s for s in ss if s[1] == root[0]]
        assert sum(s[5] - s[4] for s in children) == root[5] - root[4]
        assert min(s[4] for s in children) == root[4]
        assert max(s[5] for s in children) == root[5]
    assert metrics.SPAN_DURATION.labels(span="cycle").sum * 1e9 == pytest.approx(
        sum(_one(cycles[c], "cycle")[5] - _one(cycles[c], "cycle")[4] for c in cycle_ids))


def test_a_probe_filed_after_its_cycle_closed_ends_no_gap(monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(spans, "now_ns", clock)
    _fake_cycle(clock, os.getpid() + 1)
    _fake_cycle(clock, os.getpid() + 1)
    timing.begin_cycle()
    assert _count(metrics.PROBE_GAP, layer="loop") == 1
    # A straggler's device window, filed under a cycle already closed.
    spans.record("probe.device", clock() - 10, clock() - 5, spans.new_id(), 0, 1)
    clock.tick(1000)
    _fake_cycle(clock, os.getpid() + 1)
    spans.end_cycle()
    assert _count(metrics.PROBE_GAP, layer="loop") == 1


# ---------------------------------------------------------------------------
# fsyncs
# ---------------------------------------------------------------------------

def test_fsyncs_count_the_file_and_its_directory(tmp_path):
    labels = Labels({"nvidia.com/gpu.count": "2"})
    labels.write_to_file(str(tmp_path / "tfd"))
    assert metrics.FSYNCS.value(file="labels") == 2
    labels.write_to_file(str(tmp_path / "tfd"))  # churn-free: skipped
    assert metrics.FSYNCS.value(file="labels") == 2
    store = LabelStateStore(str(tmp_path / "state"))
    store.save(dict(labels))
    store.save(dict(labels))  # unchanged: not rewritten
    assert metrics.FSYNCS.value(file="state") == 2
    timing.write_timings_file(str(tmp_path / "timings.json"))
    assert metrics.FSYNCS.value(file="timings") == 2


def test_a_daemon_fsyncs_4_per_written_cycle_and_none_when_nothing_changed(tmp_path):
    config = _config(tmp_path, **{"state-dir": str(tmp_path / "state"),
                                  "sleep-interval": "0.01s"})
    full = metrics.CYCLES_TOTAL.labels(outcome="full")
    _run_daemon(config, lambda: full.value >= 5)
    # The first cycle writes the labels and the state; the rest find both
    # unchanged (no timestamp label) and skip them.
    assert metrics.FSYNCS.value(file="labels") == 2
    assert metrics.FSYNCS.value(file="state") == 2
    assert metrics.LABEL_WRITE_SKIPS.value() >= 4


# ---------------------------------------------------------------------------
# the ring
# ---------------------------------------------------------------------------

def test_the_ring_keeps_the_last_64_cycles_and_counts_what_it_drops():
    for _ in range(100):
        timing.begin_cycle()
        with timing.span("cycle.prepare"):
            pass
    spans.end_cycle()
    held = sorted({s[2] for s in spans.snapshot()})
    assert held == list(range(37, 101))
    assert len(held) == spans.RING_CYCLES == 64
    doc = spans.chrome_trace()
    assert doc["otherData"]["cycles"] == held
    timing.begin_cycle()
    for _ in range(spans.RING_SPANS + 5):
        with timing.span("cycle.prepare"):
            pass
    spans.end_cycle()
    # The slot's room went to the cycle.prepare spans; the root and 5 more
    # were dropped, and counted.
    assert spans.chrome_trace()["otherData"]["dropped"] == 6
    assert len([s for s in spans.snapshot() if s[2] == 101]) == spans.RING_SPANS


# ---------------------------------------------------------------------------
# GET /debug/spans
# ---------------------------------------------------------------------------

def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.getheader("Content-Type"), resp.read()
    finally:
        conn.close()


@pytest.mark.parametrize("debug", [True, False], ids=["debug-endpoints", "no-debug"])
def test_debug_spans_is_chrome_trace_json_behind_debug_endpoints(debug):
    timing.begin_cycle()
    with timing.timed("labelgen.total"), timing.span("labels.write"):
        pass
    spans.fold([[(5 << 32) | 1, 0, 0, "worker.start", 10, 20, 5, 9]],
               parent=spans.context()[1], cycle=spans.context()[0], pid=5,
               offset=(123, "torch.profiler"))
    spans.end_cycle()
    srv = server.IntrospectionServer(metrics.REGISTRY, server.IntrospectionState(60.0),
                                     addr="127.0.0.1", port=0, debug_endpoints=debug)
    srv.start()
    try:
        code, ctype, body = _get(srv.port, "/debug/spans")
        if not debug:
            assert code == 404
            return
        assert code == 200 and ctype == "application/json"
        doc = json.loads(body)
        shifted = json.loads(_get(srv.port, "/debug/spans?base_ns=1000000")[2])
        assert _get(srv.port, "/debug/spans?base_ns=x")[0] == 400
    finally:
        srv.close()
    events = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert {e["name"] for e in events} == {"cycle", "labelgen.total", "labels.write",
                                           "worker.start"}
    for e in events:
        assert set(e) == {"name", "cat", "ph", "pid", "tid", "ts", "dur", "args"}
        assert set(e["args"]) == {"cycle", "id", "parent"}
        assert e["dur"] >= 0
    meta = [e for e in doc["traceEvents"] if e["ph"] == "M"]
    assert {e["pid"] for e in meta} == {os.getpid(), 5}
    offsets = doc["otherData"]["offsets_ns"]
    assert offsets["5"] == {"offset_ns": 123, "source": "torch.profiler"}
    assert str(os.getpid()) in offsets
    worker = next(e for e in events if e["name"] == "worker.start")
    assert worker["ts"] == (10 + 123) / 1e3  # its own process's offset
    assert doc["baseTimeNanoseconds"] == 0
    by_name = {e["name"]: e["ts"] for e in shifted["traceEvents"] if e["ph"] == "X"}
    assert by_name["worker.start"] == pytest.approx(worker["ts"] - 1000.0)
    root = next(e for e in events if e["name"] == "cycle")
    write = next(e for e in events if e["name"] == "labels.write")
    total = next(e for e in events if e["name"] == "labelgen.total")
    assert write["args"]["parent"] == total["args"]["id"]
    assert total["args"]["parent"] == root["args"]["id"]
    assert worker["args"]["parent"] == total["args"]["parent"] == root["args"]["id"]


def test_the_profiler_offset_is_measured_on_the_profilers_clock():
    import torch  # noqa: F401 - the profiler's clock is torch's

    offset, source = spans.profiler_offset()
    assert source == "torch.profiler"
    # The profiler's clock is Unix time: the offset is CLOCK_REALTIME's
    # within a millisecond.
    assert abs(offset - (time.time_ns() - time.monotonic_ns())) < 1_000_000


# ---------------------------------------------------------------------------
# the broker worker's start-up tree
# ---------------------------------------------------------------------------

START_UP = ("worker.import", "worker.cuda_init", "worker.enumerate", "worker.prewarm")


def _start_trees():
    snap = spans.snapshot()
    return [s for s in snap if s[3] == "worker.start"], snap


def test_the_workers_start_up_tree_arrives_once_per_spawn(tmp_path, monkeypatch):
    for k, v in BURNIN_ENV.items():
        monkeypatch.setenv(k, v)
    config = _config(tmp_path, **{"with-burnin": True, "probe-timeout": "60s"})
    client = BrokerClient(config)
    try:
        for spawn in (1, 2):
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline and len(_start_trees()[0]) < spawn:
                timing.begin_cycle()
                assert client.ping()
                time.sleep(0.02)
            for _ in range(3):
                timing.begin_cycle()
                assert client.ping()
            roots, snap = _start_trees()
            assert len(roots) == spawn
            root = roots[-1]
            kids = [s for s in snap if s[1] == root[0]]
            assert sorted(s[3] for s in kids) == sorted(START_UP)
            assert all(s[6] == root[6] == client.pid for s in kids)
            assert root[4] <= min(s[4] for s in kids)
            assert max(s[5] for s in kids) <= root[5]
            # Filed under the RPC that carried it.
            rpc = [s for s in snap if s[0] == root[1]]
            assert rpc and rpc[0][3] == "broker.rpc.ping"
            timing.begin_cycle()  # observed as their cycles close
            assert metrics.SPAN_DURATION.labels(span="worker.import").sum > 0
            if spawn == 1:
                pid = client.pid
                os.kill(pid, signal.SIGKILL)
                with pytest.raises(sandbox.BrokerCrash):
                    client.ping()
        spans.end_cycle()
        counts = [_count(metrics.SPAN_DURATION, span=n) for n in ("worker.start",) + START_UP]
        assert counts == [2] * 5
    finally:
        client.close()
        spans.end_cycle()
