"""Slice coordination of the PyTorch port end to end on the CPU, against
its JAX twin.

In process: ``PortSliceHarness`` (``tests/torch_slice_fixture.py``) runs
N real supervised daemon loops of the port (``cmd/main.run``) in this
process, each labeling two mock GPUs (``mock-gpu:2``), serving
``/peer/snapshot`` on 127.0.0.1 and polling the others over real HTTP,
with slice identity injected as a built SliceCoordinator. The twin's own harness (``tests/slice_fixture.py``
``SliceHarness``) runs the same scenario beside it: the acceptance
scenarios of the twin's tests/test_slice.py. At every converged step the
slice family of each worker equals the twin's after the key translation
``google.com/tpu.`` -> ``nvidia.com/gpu.``; ``slice.leader`` is a
hostname on both sides and is compared as the index of the worker that
published ``slice.role=leader``. As in the twin's harness, the broker is
off: ``close_broker()`` and the stray-child sweep at one daemon's epoch
end are process-wide and would reach a sibling's machinery. The broker
path is held by the CLI test at the end, in fresh processes.
"""

import http.client
import json
import os
import queue
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest

from slice_fixture import SliceHarness
from torch_slice_fixture import PortSliceHarness, free_port as _free_port
from torch_slice_fixture import is_coord as _is_coord, non_coord_lines
# The port's node-local lines under mock-gpu:2: the gpu-mock golden and
# the host facts the port publishes beside it.
from test_torch_daemon import _matches_golden

from gpu_feature_discovery_tpu.lm import slice_labeler as twin_slice_labeler
from gpu_feature_discovery_tpu_torch.cmd import main as port_main
from gpu_feature_discovery_tpu_torch.config.flags import new_config
from gpu_feature_discovery_tpu_torch.lm.engine import STALE_SOURCES_LABEL
from gpu_feature_discovery_tpu_torch.lm.slice_labeler import (
    SLICE_DEGRADED_LABEL,
    SLICE_HEALTHY_HOSTS_LABEL,
    SLICE_LEADER_LABEL,
    SLICE_LEADER_SEEN_LABEL,
    SLICE_ROLE_LABEL,
    SLICE_TOTAL_HOSTS_LABEL,
)
from gpu_feature_discovery_tpu_torch.obs import metrics as obs_metrics
from gpu_feature_discovery_tpu_torch.resource import factory
from torch_env_guard import resolved_cache_dir_restored  # noqa: F401 - autouse

HERE = Path(__file__).parent
REPO = HERE.parent
TPU, GPU = "google.com/tpu.", "nvidia.com/gpu."
TIMESTAMP = "google.com/tfd.timestamp"


def _is_twin_coord(key):
    return key in twin_slice_labeler.SLICE_COORD_LABELS or twin_slice_labeler.is_cohort_label(key)


def _port_slice(labels):
    return {k: v for k, v in labels.items() if _is_coord(k)}


def _twin_slice(labels):
    return {GPU + k[len(TPU):]: v for k, v in labels.items() if _is_twin_coord(k)}


@pytest.fixture(autouse=True)
def _no_forced_backend(monkeypatch):
    monkeypatch.delenv("TFD_BACKEND", raising=False)
    monkeypatch.delenv("WORKER_HOSTNAMES", raising=False)
    monkeypatch.delenv("WORKER_ID", raising=False)


def _wait_both(twin, port, predicate, what, timeout=30):
    """Poll both harnesses until ``predicate(snapshot, side)`` holds on
    each; returns (twin snapshot, port snapshot)."""
    deadline = time.monotonic() + timeout
    t = p = {}
    while time.monotonic() < deadline:
        t = {w.worker_id: w.labels() for w in twin.workers}
        p = port.snapshot()
        if predicate(t, TPU) and predicate(p, GPU):
            return t, p
        for w in list(twin.workers) + list(port.workers):
            assert "error" not in w.result, w.result.get("error")
        time.sleep(0.01)
    raise AssertionError(f"timed out waiting for {what}: twin {t}, port {p}")


def _get(labels, ns, key):
    return labels.get(ns + key)


def _converged(n):
    def check(snapshot, ns):
        leader = snapshot.get(0, {})
        return (_get(leader, ns, "slice.role") == "leader"
                and _get(leader, ns, "slice.healthy-hosts") == str(n)
                and _get(leader, ns, "slice.degraded") == "false"
                and all(_get(snapshot.get(i, {}), ns, "slice.role") == "follower"
                        and _get(snapshot.get(i, {}), ns, "slice.leader-seen") == "true"
                        for i in range(1, n)))
    return check


def _assert_slice_families_equal(twin_snap, port_snap):
    """The translated slice family of every worker equals the twin's; the
    leader's hostname is compared as the index of the leading worker."""
    def leader_index(snap, ns):
        leaders = [i for i, l in snap.items() if l.get(ns + "slice.role") == "leader"]
        return leaders

    assert leader_index(port_snap, GPU) == leader_index(twin_snap, TPU)
    for i in twin_snap:
        assert _port_slice(port_snap[i]) == _twin_slice(twin_snap[i]), i


def test_two_worker_slice_labels_match_the_twin_and_node_lines_the_golden(tmp_path):
    with SliceHarness(tmp_path / "twin", workers=2) as twin, \
            PortSliceHarness(tmp_path / "port", workers=2) as port:
        t, p = _wait_both(twin, port, _converged(2), "2-worker convergence")
        _assert_slice_families_equal(t, p)
        assert p[0][SLICE_LEADER_LABEL] == "127.0.0.1"
        assert p[0][SLICE_TOTAL_HOSTS_LABEL] == "2"
        assert SLICE_HEALTHY_HOSTS_LABEL not in p[1]
        for worker in port.workers:
            assert _matches_golden(non_coord_lines(worker.raw_output())), worker.worker_id


def test_leader_kill_promotes_the_next_lowest_as_in_the_twin(tmp_path):
    with SliceHarness(tmp_path / "twin", workers=4) as twin, \
            PortSliceHarness(tmp_path / "port", workers=4) as port:
        t, p = _wait_both(twin, port, _converged(4), "4-worker convergence")
        _assert_slice_families_equal(t, p)
        w1_local = non_coord_lines(port.workers[1].raw_output())
        twin.stop_worker(0)
        port.stop_worker(0)

        def promoted(snapshot, ns):
            w1 = snapshot.get(1, {})
            return (_get(w1, ns, "slice.role") == "leader"
                    and _get(w1, ns, "slice.healthy-hosts") == "3"
                    and _get(w1, ns, "slice.degraded") == "true"
                    and all(_get(snapshot.get(i, {}), ns, "slice.leader-seen") == "true"
                            for i in (2, 3)))

        t, p = _wait_both(twin, port, promoted, "worker 1's promotion")
        for snap in (t, p):
            snap.pop(0, None)
        _assert_slice_families_equal(t, p)
        assert p[1][SLICE_TOTAL_HOSTS_LABEL] == "4"
        assert non_coord_lines(port.workers[1].raw_output()) == w1_local


def test_follower_kill_degrades_only_the_slice_labels_as_in_the_twin(tmp_path):
    with SliceHarness(tmp_path / "twin", workers=4) as twin, \
            PortSliceHarness(tmp_path / "port", workers=4) as port:
        _wait_both(twin, port, _converged(4), "4-worker convergence")
        followers_before = {i: port.workers[i].raw_output() for i in (1, 2)}
        leader_local = non_coord_lines(port.workers[0].raw_output())
        twin.stop_worker(3)
        port.stop_worker(3)

        def degraded(snapshot, ns):
            leader = snapshot.get(0, {})
            return (_get(leader, ns, "slice.degraded") == "true"
                    and _get(leader, ns, "slice.healthy-hosts") == "3")

        t, p = _wait_both(twin, port, degraded, "slice degradation")
        for snap in (t, p):
            snap.pop(3, None)
        _assert_slice_families_equal(t, p)
        for i, before in followers_before.items():
            assert port.workers[i].raw_output() == before, i
        assert non_coord_lines(port.workers[0].raw_output()) == leader_local


def test_fully_partitioned_survivor_never_leads_as_in_the_twin(tmp_path):
    with SliceHarness(tmp_path / "twin", workers=2) as twin, \
            PortSliceHarness(tmp_path / "port", workers=2) as port:
        _wait_both(twin, port, _converged(2), "2-worker convergence")
        twin.stop_worker(0)
        port.stop_worker(0)

        def partitioned(snapshot, ns):
            w1 = snapshot.get(1, {})
            return (_get(w1, ns, "slice.role") == "follower"
                    and _get(w1, ns, "slice.leader-seen") == "false")

        t, p = _wait_both(twin, port, partitioned, "partition visibility")
        assert _port_slice(p[1]) == _twin_slice(t[1]) == {
            SLICE_ROLE_LABEL: "follower", SLICE_LEADER_SEEN_LABEL: "false"}


def test_coordination_off_is_byte_for_byte_the_node_local_output(tmp_path):
    with PortSliceHarness(tmp_path / "port", workers=2, coordination="off") as port:
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and not all(
                GPU + "count" in w.labels() for w in port.workers):
            time.sleep(0.01)
        outputs = {w.worker_id: w.raw_output() for w in port.workers}
        config0 = port.workers[0].config
    control_out = tmp_path / "control-tfd"
    control = new_config(cli_values={
        "oneshot": True, "backends": "mock-gpu:2", "output-file": str(control_out),
        "machine-type-file": config0.flags.tfd.machine_type_file,
    }, environ={})
    assert port_main.run(factory.new_manager(control), control, queue.Queue()) is False

    def no_timestamp(raw):
        return [l for l in raw.splitlines() if l and not l.startswith(TIMESTAMP + "=")]

    for worker_id, raw in outputs.items():
        lines = [l for l in raw.splitlines() if l]
        assert _matches_golden(lines), worker_id
        assert not any(_is_coord(l.split("=", 1)[0]) for l in lines)
        assert no_timestamp(raw) == no_timestamp(control_out.read_text()), worker_id


def test_two_tier_harness_converges_as_in_the_twin(tmp_path):
    def converged(snapshot, ns):
        w0 = snapshot.get(0, {})
        return (_get(w0, ns, "slice.role") == "leader"
                and _get(w0, ns, "slice.healthy-hosts") == "4"
                and _get(w0, ns, "slice.degraded") == "false"
                and not any(k.startswith(ns + "slice.cohort.") for k in w0)
                and _get(snapshot.get(2, {}), ns, "slice.role") == "cohort-leader"
                and all(_get(snapshot.get(i, {}), ns, "slice.role") == "follower"
                        for i in (1, 3)))

    with SliceHarness(tmp_path / "twin", workers=4, cohort_size=2) as twin, \
            PortSliceHarness(tmp_path / "port", workers=4, cohort_size=2) as port:
        t, p = _wait_both(twin, port, converged, "two-tier convergence")
        _assert_slice_families_equal(t, p)
        assert p[0][GPU + "slice.cohorts"] == "2"
        assert [p[i][GPU + "slice.cohort"] for i in range(4)] == ["0", "0", "1", "1"]
        for worker in port.workers:
            assert _matches_golden(non_coord_lines(worker.raw_output())), worker.worker_id


def test_slow_peers_cost_only_the_slice_labels(tmp_path):
    """Two of four peers answer far past --peer-timeout, one poll at a
    time: the round budget (0.8 x --labeler-timeout, as
    new_slice_coordinator sets it) skips what it cannot reach, so the
    slice source never misses the engine's deadline: no cycle is marked
    stale, the leader's node labels keep their golden and its last-good
    state is persisted, while its slice labels count the slow peers
    out."""
    labeler_timeout = 2.0
    with PortSliceHarness(tmp_path, workers=4, peer_timeout="1.5s",
                          labeler_timeout=f"{labeler_timeout}s",
                          round_budget=0.8 * labeler_timeout, peer_fanout=1,
                          slow_workers=(2, 3), slow_delay_s=3.0) as port:
        deadline = time.monotonic() + 40
        seen = []
        while time.monotonic() < deadline:
            leader = port.workers[0].labels()
            if leader:
                seen.append(leader)
            if (leader.get(SLICE_ROLE_LABEL) == "leader"
                    and leader.get(SLICE_HEALTHY_HOSTS_LABEL) == "2"
                    and leader.get(SLICE_DEGRADED_LABEL) == "true"):
                break
            time.sleep(0.02)
        else:
            raise AssertionError(f"the leader never counted the slow peers out: {seen[-1:]}")
        time.sleep(2 * labeler_timeout)
        seen.append(port.workers[0].labels())
        assert not any(STALE_SOURCES_LABEL in labels for labels in seen)
        assert obs_metrics.LABELER_DEADLINE_MISSES.value(labeler="slice") == 0
        # The slow peers were polled, and each poll was a miss.
        assert obs_metrics.PEER_POLLS.value(outcome="error") > 0
        assert _matches_golden(non_coord_lines(port.workers[0].raw_output()))
        state = Path(port.workers[0].config.flags.tfd.state_dir) / "last-good-labels.json"
        assert GPU + "count" in state.read_text()


def test_a_daemon_whose_backend_is_down_keeps_its_place_in_the_slice(tmp_path):
    """Degraded cycles (every backend init fails) still run the slice
    source and serve the snapshot, whose mode says so: slice labels are
    about host reachability, not device health."""
    from gpu_feature_discovery_tpu_torch.utils import faults

    faults.load_fault_spec("pjrt_init:fail:1000000")
    try:
        with PortSliceHarness(tmp_path, workers=2,
                              extra_cli={"fail-on-init-error": "false"}) as port:
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline:
                w0, w1 = (w.labels() for w in port.workers)
                if (w0.get(SLICE_ROLE_LABEL) == "leader"
                        and w1.get(SLICE_LEADER_SEEN_LABEL) == "true"):
                    break
                time.sleep(0.02)
            else:
                raise AssertionError(f"no slice while degraded: {port.snapshot()}")
            assert w0[GPU + "tfd.degraded"] == w1[GPU + "tfd.degraded"] == "true"
            assert GPU + "count" not in w0
            assert w0[SLICE_HEALTHY_HOSTS_LABEL] == "2"
            code, _, body = _request(port.workers[1].port, "/peer/snapshot")
            doc = json.loads(body)
            assert code == 200 and doc["mode"] == "degraded"
            assert GPU + "tfd.degraded" not in doc["labels"]
    finally:
        faults.reset()


@pytest.mark.parametrize("backends,serves", [
    ("mock-gpu:2,mock-cpu:2", True), ("mock-cpu:2", False),
])
def test_the_registry_cycle_coordinates_only_with_the_gpu_family(
        tmp_path, monkeypatch, backends, serves):
    """A --backends list builds the slice coordinator from the environment
    when it names the gpu family, and appends the slice source beside the
    families' sources; a cpu-only daemon claims no slice."""
    port_a, port_b = _free_port(), _free_port()
    monkeypatch.setenv("WORKER_HOSTNAMES", f"127.0.0.1:{port_b},127.0.0.1:{port_a}")
    monkeypatch.setenv("WORKER_ID", "1")
    with PortSliceHarness(tmp_path, workers=1, backends=backends, inject=False) as port:
        worker = port.workers[0]
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and "node.features/cpu.count" not in worker.labels():
            time.sleep(0.02)
        if serves:
            # Its one peer never answers: a partitioned member, never a leader.
            while time.monotonic() < deadline and SLICE_ROLE_LABEL not in worker.labels():
                time.sleep(0.02)
        labels = worker.labels()
        assert labels["node.features/cpu.count"] == "2"
        code = _request(worker.port, "/peer/snapshot")[0]
    from gpu_feature_discovery_tpu.hostinfo.tpu_env import host_info_from_mapping
    from gpu_feature_discovery_tpu.lm.interconnect import _host_info_labels

    # The host facts of WORKER_HOSTNAMES/WORKER_ID ride the gpu family's
    # interconnect source, as the twin's interconnect labeler publishes
    # them for the same mapping.
    twin_facts = _host_info_labels(host_info_from_mapping(
        {k: os.environ[k] for k in ("WORKER_HOSTNAMES", "WORKER_ID")}))
    facts = {k: v for k, v in labels.items() if k.startswith(GPU + "multihost.")}
    if serves:
        assert facts == {GPU + k[len(TPU):]: v for k, v in twin_facts.items()} == {
            GPU + "multihost.present": "true", GPU + "multihost.worker-id": "1",
            GPU + "multihost.worker-count": "2"}
    else:
        assert facts == {}
    if serves:
        assert _port_slice(labels) == {SLICE_ROLE_LABEL: "follower",
                                       SLICE_LEADER_SEEN_LABEL: "false"}
        assert labels[GPU + "count"] == "2"
        assert code == 200
    else:
        assert _port_slice(labels) == {} and code == 404


# ---------------------------------------------------------------------------
# the CLI in fresh processes, through the broker
# ---------------------------------------------------------------------------

def _request(port, path, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
    try:
        conn.request("GET", path, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, resp.getheader("ETag"), resp.read()
    finally:
        conn.close()


def _file_labels(path):
    try:
        return dict(l.split("=", 1) for l in path.read_text().splitlines() if "=" in l)
    except OSError:
        return {}


def test_two_cli_daemons_form_a_slice_through_the_broker(tmp_path):
    ports = [_free_port() for _ in range(2)]
    procs, outs, logs = [], [], []
    try:
        for i in range(2):
            out, log = tmp_path / f"w{i}.tfd", tmp_path / f"w{i}.log"
            env = dict(os.environ, TFD_BURNIN_ALLOW_CPU="1", TFD_BURNIN_GEOMETRY="64x1",
                       WORKER_HOSTNAMES=",".join(f"127.0.0.1:{p}" for p in ports),
                       WORKER_ID=str(i))
            env.pop("TFD_BACKEND", None)
            env.pop("TFD_FAULT_SPEC", None)
            with open(log, "w") as f:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "gpu_feature_discovery_tpu_torch",
                     "--with-burnin", "--backends", "mock-gpu:2", "--sleep-interval", "0.3s",
                     "--probe-timeout", "60s", "--output-file", str(out),
                     "--metrics-addr", "127.0.0.1", "--metrics-port", str(ports[i]),
                     "--peer-token", "tok"],
                    cwd=REPO, env=env, stdout=f, stderr=subprocess.STDOUT))
            outs.append(out)
            logs.append(log)
        deadline = time.monotonic() + 90
        while time.monotonic() < deadline:
            w0, w1 = (_file_labels(o) for o in outs)
            if (w0.get(SLICE_ROLE_LABEL) == "leader" and w0.get(SLICE_HEALTHY_HOSTS_LABEL) == "2"
                    and w1.get(SLICE_ROLE_LABEL) == "follower"
                    and w1.get(SLICE_LEADER_SEEN_LABEL) == "true"
                    and GPU + "health.ok" in w0 and GPU + "health.ok" in w1):
                break
            assert all(p.poll() is None for p in procs), [l.read_text()[-3000:] for l in logs]
            time.sleep(0.05)
        else:
            raise AssertionError(f"no slice: {[l.read_text()[-3000:] for l in logs]}")
        assert w0[SLICE_DEGRADED_LABEL] == "false" and w0[SLICE_TOTAL_HOSTS_LABEL] == "2"
        # Each CLI's own place in the slice, from its WORKER_ID.
        for i, labels in enumerate((w0, w1)):
            assert (labels[GPU + "multihost.present"], labels[GPU + "multihost.worker-id"],
                    labels[GPU + "multihost.worker-count"]) == ("true", str(i), "2")
        for log in logs:
            assert "broker worker" in log.read_text()
        # The token gate, then the ETag economy, on the follower.
        assert _request(ports[1], "/peer/snapshot")[0] == 403
        assert _request(ports[1], "/peer/snapshot", {"X-TFD-Probe-Token": "nope"})[0] == 401
        code, etag, body = _request(ports[1], "/peer/snapshot", {"X-TFD-Probe-Token": "tok"})
        assert code == 200 and etag.startswith('"') and etag.endswith('"') and body
        code, etag2, body2 = _request(ports[1], "/peer/snapshot",
                                      {"X-TFD-Probe-Token": "tok", "If-None-Match": etag})
        assert (code, etag2, body2) == (304, etag, b"")
        # SIGHUP: the follower's epoch ends, its coordinator is closed and a
        # new one serves the same port and rejoins the slice.
        procs[1].send_signal(signal.SIGHUP)
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            w1 = _file_labels(outs[1])
            if (logs[1].read_text().count("Introspection server listening") >= 2
                    and w1.get(SLICE_ROLE_LABEL) == "follower"
                    and w1.get(SLICE_LEADER_SEEN_LABEL) == "true"):
                break
            time.sleep(0.05)
        else:
            raise AssertionError(f"no rejoin after SIGHUP: {logs[1].read_text()[-3000:]}")
        assert _request(ports[1], "/peer/snapshot", {"X-TFD-Probe-Token": "tok"})[0] == 200
        assert procs[1].poll() is None
        for p in procs:
            p.send_signal(signal.SIGTERM)
        assert [p.wait(timeout=30) for p in procs] == [0, 0]
        assert not any(o.exists() for o in outs)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
