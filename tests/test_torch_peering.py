"""The PyTorch port's slice coordination (peering/, lm/slice_labeler.py,
the round Budget of utils/fanout.py) against its JAX twin, on the CPU.

- Cohorts: every cohort function equals the twin's for every slice size
  1..300 and cohort sizes 0, auto, 2, 3, 8 and 64.
- Wire: for label sets drawn from a seed, the port's snapshot body and
  strong ETag are the twin's after the key translation ``google.com/tpu.``
  -> ``nvidia.com/gpu.``; both strip the same keys; both refuse the same
  malformed bodies with the same texts; each parses the other's bodies.
- Coordinators: a twin and a port SliceCoordinator with the same hostname
  list poll the same stub peers, which replay a seeded script of ok, 304,
  refused, dropped, slow and junk answers round by round on one fake
  clock; after every round their views and their slice labels (after the
  translation) are equal, flat and with ``--cohort-size 2``.
- Peer list: ``WORKER_HOSTNAMES``/``WORKER_ID`` are cleaned as the twin
  cleans them, and ``new_slice_coordinator`` resolves as the twin's does.
- Budget and faults: a budgeted round skips and rotates as the twin's
  does, and the serving side's ``peer.*`` sites cost a live poller the
  same misses on both.

Every comparison is exact: label sets, integers, bytes.
"""

import dataclasses
import hashlib
import http.server
import json
import logging
import socket
import threading
import time
import types

import numpy as np
import pytest

from gpu_feature_discovery_tpu.config import new_config as twin_new_config
from gpu_feature_discovery_tpu.hostinfo import tpu_env as twin_tpu_env
from gpu_feature_discovery_tpu.lm import slice_labeler as twin_slice_labeler
from gpu_feature_discovery_tpu.obs import metrics as twin_metrics
from gpu_feature_discovery_tpu.obs import registry as twin_registry
from gpu_feature_discovery_tpu.obs import server as twin_server
from gpu_feature_discovery_tpu.peering import cohort as twin_cohort
from gpu_feature_discovery_tpu.peering import coordinator as twin_coordinator
from gpu_feature_discovery_tpu.peering import snapshot as twin_snapshot
from gpu_feature_discovery_tpu.utils import fanout as twin_fanout
from gpu_feature_discovery_tpu.utils import faults as twin_faults
from gpu_feature_discovery_tpu.utils.retry import BackoffPolicy as TwinBackoff
from gpu_feature_discovery_tpu_torch.config.flags import new_config
from gpu_feature_discovery_tpu_torch.lm import slice_labeler
from gpu_feature_discovery_tpu_torch.obs import metrics
from gpu_feature_discovery_tpu_torch.obs import registry
from gpu_feature_discovery_tpu_torch.obs import server
from gpu_feature_discovery_tpu_torch.peering import cohort
from gpu_feature_discovery_tpu_torch.peering import coordinator
from gpu_feature_discovery_tpu_torch.peering import snapshot
from gpu_feature_discovery_tpu_torch.peering import worker_env
from gpu_feature_discovery_tpu_torch.utils import fanout
from gpu_feature_discovery_tpu_torch.utils import faults
from gpu_feature_discovery_tpu_torch.utils.retry import BackoffPolicy

TPU, GPU = "google.com/tpu.", "nvidia.com/gpu."


def translate_key(key):
    return GPU + key[len(TPU):] if key.startswith(TPU) else key


def translate_labels(labels):
    return {translate_key(k): v for k, v in labels.items()}


# ---------------------------------------------------------------------------
# cohorts and the round budget
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("raw", ["0", "auto", "2", "3", "8", "64"])
def test_cohort_functions_equal_the_twins_for_every_slice_size(raw):
    for n in range(1, 301):
        size = cohort.resolve_cohort_size(raw, n)
        assert size == twin_cohort.resolve_cohort_size(raw, n), (raw, n)
        for s in {size, int(raw) if raw.isdigit() else 64}:
            part = cohort.cohort_partition(n, s)
            assert part == twin_cohort.cohort_partition(n, s), (raw, n, s)
            for c in part:
                assert cohort.chain_ids(c) == twin_cohort.chain_ids(c)
            if s > 0:
                assert [cohort.cohort_index(w, s) for w in range(n)] == [
                    twin_cohort.cohort_index(w, s) for w in range(n)]
    assert cohort.AUTO_COHORT_SIZE == twin_cohort.AUTO_COHORT_SIZE
    assert cohort.COHORT_LEADER_CHAIN == twin_cohort.COHORT_LEADER_CHAIN
    for module in (cohort, twin_cohort):
        with pytest.raises(ValueError):
            module.cohort_index(3, 0)


@pytest.mark.parametrize("raw", ["-1", "x", "2.5", ""])
def test_bad_cohort_sizes_are_refused_with_the_twins_texts(raw):
    errors = []
    for module in (cohort, twin_cohort):
        with pytest.raises(Exception) as e:
            module.resolve_cohort_size(raw, 10)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def test_round_budget_matches_the_twins():
    for budget in (None, 0.0, 1.0, 2.5):
        now = [5.0]
        port = fanout.Budget(budget, lambda: now[0])
        twin = twin_fanout.Budget(budget, lambda: now[0])
        for step in (0.0, 0.4, 0.7, 1.2, 3.0):
            now[0] += step
            assert port.remaining() == twin.remaining()
            for grace in (0.0, 0.05, 0.5):
                assert port.spent(grace) == twin.spent(grace)


# ---------------------------------------------------------------------------
# the wire
# ---------------------------------------------------------------------------

_NODE_KEYS = [TPU + k for k in (
    "count", "product", "memory", "family", "health.ok", "health.matmul-tflops",
    "chip.0.ok", "chip.1.ok", "straggler-chip", "driver.major", "slice.capable",
    "slice.chips", "multihost.worker-id")]
_MARKERS = [TPU + k for k in ("tfd.degraded", "tfd.restored", "tfd.unhealthy-cycles",
                              "tfd.stale-sources", "tfd.flapping")]
_COORD = [TPU + "slice." + k for k in (
    "role", "leader", "leader-seen", "healthy-hosts", "total-hosts", "degraded",
    "sick-chips", "cohort", "cohorts", "cohort.0.degraded", "cohort.12.degraded")]
_ADVICE = [TPU + k for k in ("schedulable", "tfd.cordon-advice", "tfd.drain-advice",
                             "tfd.would-cordon", "tfd.actuation-lease")]
_OTHER = ["google.com/tfd.timestamp", "node.features/cpu.count",
          "node.features/cpu.tfd.degraded", "example.com/x"]
_VALUES = ["0", "1", "2", "7", "true", "false", "leader", "follower", "w-3", "", "1.5",
           "x" * 30, "é"]


def _labels(rng):
    pool = _NODE_KEYS + _MARKERS + _COORD + _ADVICE + _OTHER
    picked = rng.choice(len(pool), size=int(rng.integers(0, len(pool))), replace=False)
    labels = {pool[i]: _VALUES[int(rng.integers(len(_VALUES)))] for i in picked}
    for key in (TPU + "chips.healthy", TPU + "chips.sick"):
        if rng.random() < 0.7:
            labels[key] = ["0", "1", "3", "junk", ""][int(rng.integers(5))]
    return labels


def _cohort_members(rng):
    return {int(w): {"reachable": bool(rng.random() < 0.7),
                     "generation": int(rng.integers(0, 9)) if rng.random() < 0.8 else None,
                     "sick": int(rng.integers(0, 3)) if rng.random() < 0.8 else None,
                     "mode": ["full", "degraded", None][int(rng.integers(3))]}
            for w in rng.choice(40, size=int(rng.integers(1, 5)), replace=False)}


def _translate_doc(doc):
    out = dict(doc, labels=translate_labels(doc["labels"]))
    if "slice" in out:
        out["slice"] = dict(out["slice"])
    return out


@pytest.mark.parametrize("seed", range(12))
def test_snapshot_body_and_etag_equal_the_twins_after_translation(seed):
    rng = np.random.default_rng(seed)
    for _ in range(25):
        twin_labels = _labels(rng)
        port_labels = translate_labels(twin_labels)
        assert snapshot.strip_snapshot_labels(port_labels) == translate_labels(
            twin_snapshot.strip_snapshot_labels(twin_labels))
        args = (int(rng.integers(0, 64)), f"host-{int(rng.integers(9))}",
                int(rng.integers(0, 1000)), ["full", "degraded", "reserved",
                                             "restored", None][int(rng.integers(5))])
        aggregate = None
        if rng.random() < 0.4:
            members = _cohort_members(rng)
            index = int(rng.integers(0, 8))
            aggregate = snapshot.build_cohort_aggregate(index, members)
            assert aggregate == twin_snapshot.build_cohort_aggregate(index, members)
        twin_section = twin_snapshot.build_slice_section(twin_labels)
        assert snapshot.build_slice_section(port_labels) == twin_section
        twin_doc = twin_snapshot.build_snapshot(
            args[0], args[1], twin_labels, args[2], args[3],
            cohort=aggregate, slice_section=twin_section)
        port_doc = snapshot.build_snapshot(
            args[0], args[1], port_labels, args[2], args[3],
            cohort=aggregate, slice_section=twin_section)
        want_body, want_etag = twin_snapshot.serialize_snapshot(_translate_doc(twin_doc))
        body, etag = snapshot.serialize_snapshot(port_doc)
        assert body == want_body
        assert etag == want_etag == '"' + hashlib.sha256(body).hexdigest() + '"'
        # Each twin reads the other's body.
        assert twin_snapshot.parse_snapshot(body) == json.loads(body)
        twin_body, _ = twin_snapshot.serialize_snapshot(twin_doc)
        assert snapshot.parse_snapshot(twin_body) == json.loads(twin_body)


def test_slice_section_is_the_leaders_alone():
    leader = {GPU + "slice.role": "leader", GPU + "slice.leader": "w0",
              GPU + "slice.healthy-hosts": "3", GPU + "slice.total-hosts": "3",
              GPU + "slice.degraded": "false", GPU + "slice.sick-chips": "1"}
    assert snapshot.build_slice_section(leader) == {
        "schema": 1, "leader": "w0", "healthy_hosts": 3, "total_hosts": 3,
        "degraded": False, "sick_chips": 1}
    assert snapshot.build_slice_section(dict(leader, **{GPU + "slice.role": "follower"})) is None
    # The node fact slice.capable stays on the wire; the family goes.
    assert snapshot.strip_snapshot_labels(dict(leader, **{GPU + "slice.capable": "true"})) == {
        GPU + "slice.capable": "true"}


def _doc(**over):
    doc = {"schema": 1, "worker_id": 0, "labels": {}, "generation": 1, "chips": {}}
    doc.update(over)
    return json.dumps(doc).encode()


_MALFORMED = [
    b"not json {", b"[1, 2]", b"\xff\xfe", b'{"schema": 2, "worker_id": 0}',
    b'{"worker_id": 0}', b'{"schema": 1, "worker_id": "zero"}',
    b'{"schema": 1, "worker_id": true}', b'{"schema": 1, "worker_id": -1}',
    _doc(labels={"k": 4}), _doc(labels=[]), _doc(generation="g"), _doc(generation=True),
    _doc(chips=[]), _doc(chips={"sick": "1"}), _doc(chips={"healthy": False}),
    _doc(cohort=[]), _doc(cohort={"schema": 2, "index": 0, "members": {}}),
    _doc(cohort={"index": 0, "members": {}}),
    _doc(cohort={"schema": 1, "index": "x", "members": {}}),
    _doc(cohort={"schema": 1, "index": -1, "members": {}}),
    _doc(cohort={"schema": 1, "index": 0, "members": []}),
    _doc(cohort={"schema": 1, "index": 0, "members": {"w3": {"reachable": True}}}),
    _doc(cohort={"schema": 1, "index": 0, "members": {"3": []}}),
    _doc(cohort={"schema": 1, "index": 0, "members": {"3": {"reachable": "yes"}}}),
    _doc(cohort={"schema": 1, "index": 0, "members": {"3": {"reachable": True, "sick": "1"}}}),
    _doc(cohort={"schema": 1, "index": 0,
                 "members": {"3": {"reachable": True, "generation": 1.5}}}),
    _doc(cohort={"schema": 1, "index": 0, "members": {"3": {"reachable": True, "mode": 4}}}),
    _doc(slice=[]), _doc(slice={"schema": 2}), _doc(slice={"schema": 1, "leader": 3}),
    _doc(slice={"schema": 1, "leader": "w0", "degraded": "no"}),
    _doc(slice={"schema": 1, "leader": "w0", "degraded": True, "healthy_hosts": "3"}),
    _doc(slice={"schema": 1, "leader": "w0", "degraded": True, "sick_chips": False}),
    json.dumps({"schema": 1, "worker_id": 0, "labels": {"k": "v" * (256 * 1024)},
                "generation": 1, "chips": {}}).encode(),
]


@pytest.mark.parametrize("index", range(len(_MALFORMED)))
def test_malformed_bodies_are_refused_with_the_twins_texts(index):
    body = _MALFORMED[index]
    with pytest.raises(twin_snapshot.PeerSnapshotError) as twin:
        twin_snapshot.parse_snapshot(body)
    with pytest.raises(snapshot.PeerSnapshotError) as port:
        snapshot.parse_snapshot(body)
    assert str(port.value) == str(twin.value)
    assert isinstance(port.value, ValueError)


def test_wire_constants_are_the_twins():
    for name in ("PEER_SCHEMA_VERSION", "PEER_SNAPSHOT_PATH", "COHORT_SCHEMA_VERSION",
                 "SLICE_SECTION_SCHEMA_VERSION", "MAX_SNAPSHOT_BYTES"):
        assert getattr(snapshot, name) == getattr(twin_snapshot, name), name
    from gpu_feature_discovery_tpu.actuation.engine import ADVICE_LABELS

    assert snapshot.ADVICE_LABELS == tuple(translate_key(k) for k in ADVICE_LABELS)
    assert slice_labeler.SLICE_COORD_LABELS == tuple(
        translate_key(k) for k in twin_slice_labeler.SLICE_COORD_LABELS)
    assert slice_labeler.SLICE_COHORT_PREFIX == translate_key(
        twin_slice_labeler.SLICE_COHORT_PREFIX)
    for name in ("CONFIRM_POLLS", "AUTO_FANOUT_CAP", "TIER_COHORT", "TIER_SLICE",
                 "TIER_DIRECT", "POLL_TIER_HEADER", "PEER_TOKEN_HEADER",
                 "PEER_BACKOFF_BASE_S", "PEER_BACKOFF_CAP_S",
                 "SUBSCRIPTION_TTL_FLOOR_S"):
        assert getattr(coordinator, name) == getattr(twin_coordinator, name), name


@pytest.mark.parametrize("entry", [
    "w0", "w0:9101", "10.0.0.1:80", "::1", "fe80::2", "[::1]", "[::1]:9101", "[::1",
    "[::1]x", "host:port", "a:b:c", ":9", "",
])
def test_host_port_split_is_the_twins(entry):
    assert coordinator.split_host_port(entry, 9101) == twin_coordinator.split_host_port(
        entry, 9101)


@pytest.mark.parametrize("seed", range(4))
def test_slice_labels_of_every_view_equal_the_twins_after_translation(seed):
    rng = np.random.default_rng(50 + seed)
    for _ in range(40):
        fields = dict(
            role=["leader", "cohort-leader", "follower"][int(rng.integers(3))],
            leader_hostname=["127.0.0.1", "w0", "Host_A.b", "", "x" * 80][int(rng.integers(5))],
            leader_seen=bool(rng.random() < 0.5), healthy_hosts=int(rng.integers(0, 9)),
            total_hosts=int(rng.integers(1, 9)), degraded=bool(rng.random() < 0.5),
            sick_chips=int(rng.integers(0, 4)), cohort=int(rng.integers(0, 4)),
            cohorts=int(rng.choice([0, 0, 2, 3])),
            degraded_cohorts=tuple(sorted({int(i) for i in rng.integers(0, 4, 2)})))
        assert dict(slice_labeler.slice_labels(coordinator.SliceView(**fields))) == (
            translate_labels(twin_slice_labeler.slice_labels(twin_coordinator.SliceView(**fields))))


# ---------------------------------------------------------------------------
# coordinators side by side over scripted stub peers
# ---------------------------------------------------------------------------

PEER_TIMEOUT = 0.2
SLOW_S = 0.35
ACTIONS = ("ok", "ok", "same", "same", "same", "refused", "drop", "slow", "junk")


class _StubPeer:
    """One scripted peer: serves its snapshot with a strong ETag (304 on a
    matching If-None-Match), or misbehaves as the current round says.
    ``refused`` closes the listener and every established connection, so
    a poll finds nothing at the port; the next answering round rebinds."""

    def __init__(self, worker_id, port, size):
        self.worker_id = worker_id
        self.port = port
        self.size = size
        self.action = "ok"
        self.generation = 0
        self.sick = 0
        self.body, self.etag = b"", ""
        self.httpd = None
        self.clients = set()
        self.lock = threading.Lock()
        self.render()

    def render(self):
        self.generation += 1
        labels = {GPU + "count": "1", GPU + "chips.healthy": "1",
                  GPU + "chips.sick": str(self.sick)}
        aggregate = None
        if self.size and self.worker_id % self.size == 0:
            # The lowest id of its cohort serves an aggregate, as a cohort
            # leader does.
            aggregate = snapshot.build_cohort_aggregate(
                self.worker_id // self.size,
                {self.worker_id + i: {"reachable": True, "generation": 1,
                                      "sick": self.sick if i == 0 else 0, "mode": "full"}
                 for i in range(self.size)})
        doc = snapshot.build_snapshot(self.worker_id, "127.0.0.1", labels,
                                      self.generation, "full", cohort=aggregate)
        self.body, self.etag = snapshot.serialize_snapshot(doc)

    def handler(self):
        peer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def do_GET(self):  # noqa: N802 - stdlib API
                action = peer.action
                if action == "drop":
                    self.close_connection = True
                    return
                if action == "slow":
                    time.sleep(SLOW_S)
                if action == "junk":
                    self._send(200, b"not json {", None)
                elif self.headers.get("If-None-Match") == peer.etag:
                    self._send(304, b"", peer.etag)
                else:
                    self._send(200, peer.body, peer.etag)

            def _send(self, code, body, etag):
                try:
                    self.send_response(code)
                    self.send_header("Content-Length", str(len(body)))
                    if etag:
                        self.send_header("ETag", etag)
                    self.end_headers()
                    self.wfile.write(body)
                except OSError:
                    self.close_connection = True

            def log_message(self, *a):
                pass

        return Handler

    def serve(self):
        with self.lock:
            if self.httpd is not None:
                return
            stub = self

            class Server(http.server.ThreadingHTTPServer):
                daemon_threads = True
                allow_reuse_address = True

                def process_request(self, request, client_address):
                    stub.clients.add(request)
                    super().process_request(request, client_address)

            self.httpd = Server(("127.0.0.1", self.port), self.handler())
            threading.Thread(target=self.httpd.serve_forever,
                             kwargs={"poll_interval": 0.02}, daemon=True).start()

    def stop(self):
        with self.lock:
            if self.httpd is None:
                return
            self.httpd.shutdown()
            self.httpd.server_close()
            for sock in list(self.clients):
                try:
                    sock.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass
            self.clients.clear()
            self.httpd = None

    def set_round(self, action, rng):
        self.action = action
        if action == "ok" and rng.random() < 0.5:
            self.sick = int(rng.integers(0, 3))
            self.render()
        if action == "refused":
            self.stop()
        else:
            self.serve()


def _free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def _fields(view):
    return dataclasses.asdict(view)


@pytest.mark.parametrize("size,me,seed", [(0, 0, 1), (0, 2, 2), (2, 0, 3), (2, 2, 4)],
                         ids=["flat-w0", "flat-w2", "cohort2-w0", "cohort2-w2"])
def test_coordinator_views_equal_the_twins_round_by_round(size, me, seed):
    n = 5
    rng = np.random.default_rng(seed)
    ports = _free_ports(n)
    hostnames = [f"127.0.0.1:{p}" for p in ports]
    stubs = {w: _StubPeer(w, ports[w], size) for w in range(n) if w != me}
    now = [100.0]
    clock = lambda: now[0]  # noqa: E731 - one fake clock for both twins
    common = dict(worker_id=me, hostnames=hostnames, default_port=1,
                  peer_timeout=PEER_TIMEOUT, clock=clock, cohort_size=size)
    twin = twin_coordinator.SliceCoordinator(
        backoff_factory=lambda: TwinBackoff(base=1.0, cap=4.0, jitter=0.0), **common)
    port = coordinator.SliceCoordinator(
        backoff_factory=lambda: BackoffPolicy(base=1.0, cap=4.0, jitter=0.0), **common)
    try:
        for stub in stubs.values():
            stub.serve()
        own = {GPU + "count": "1", GPU + "chips.sick": "1"}
        twin.publish_local({TPU + "count": "1", TPU + "chips.sick": "1"}, "full")
        port.publish_local(own, "full")
        seen_actions, views = set(), set()
        for _ in range(10):
            for w, stub in stubs.items():
                action = ACTIONS[int(rng.integers(len(ACTIONS)))]
                seen_actions.add(action)
                stub.set_round(action, rng)
            threads = [threading.Thread(target=c.poll_once) for c in (twin, port)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=30)
            view = _fields(port.view())
            assert view == _fields(twin.view())
            views.add(tuple(sorted(view.items())))
            assert dict(port.labels()) == translate_labels(twin.labels())
            assert port.membership_token() == twin.membership_token()
            now[0] += 1.5
        assert {"ok", "refused", "slow", "junk"} <= seen_actions
        assert len(views) >= 2  # the script moved the views
    finally:
        for c in (twin, port):
            c.close()
        for stub in stubs.values():
            stub.stop()


def test_actuation_signals_equal_the_twins():
    now = [0.0]
    common = dict(worker_id=0, hostnames=["w0", "w1", "w2", "w3"], default_port=1,
                  peer_timeout=0.1, clock=lambda: now[0])
    twin = twin_coordinator.SliceCoordinator(**common)
    port = coordinator.SliceCoordinator(**common)
    docs = {1: ({TPU + "chips.sick": "2"}, {GPU + "chips.sick": "2"}),
            2: ({TPU + "straggler-chip": "1"}, {GPU + "straggler-chip": "1"}),
            3: ({TPU + "count": "4"}, {GPU + "count": "4"})}
    twin._fetch = lambda peer, timeout: twin_snapshot.build_snapshot(
        peer.worker_id, "h", docs[peer.worker_id][0], 1, "full")
    port._fetch = lambda peer, timeout: snapshot.build_snapshot(
        peer.worker_id, "h", docs[peer.worker_id][1], 1, "full")
    try:
        for c in (twin, port):
            c.poll_once()
        assert port.actuation_signals() == twin.actuation_signals() == (
            4, {1: True, 2: True, 3: False})
    finally:
        twin.close()
        port.close()


# ---------------------------------------------------------------------------
# the peer list and the coordinator's resolution
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("raw", [
    "a,b,c", " a , b ,, c ,", "a,b,a,c,b", ",,,", "", "a", "127.0.0.1:9101,127.0.0.1:9102",
    "[::1]:1,[::1]:2,[::1]:1",
])
def test_worker_hostnames_are_cleaned_as_the_twin_cleans_them(raw, caplog):
    with caplog.at_level(logging.WARNING):
        port = worker_env.parse_worker_hostnames(raw)
    port_warnings = [r.getMessage() for r in caplog.records]
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        twin = twin_tpu_env.parse_worker_hostnames(raw)
    twin_warnings = [r.getMessage() for r in caplog.records]
    assert port == twin
    # The one intended textual difference: the variable's name.
    assert port_warnings == [w.replace("TPU_WORKER_HOSTNAMES", "WORKER_HOSTNAMES")
                             for w in twin_warnings]
    assert all("TPU_" not in w for w in port_warnings)
    if len(set(raw.replace(" ", "").split(",")) - {""}) < len(
            [h for h in raw.replace(" ", "").split(",") if h]):
        assert port_warnings and port_warnings[0].startswith(
            "WORKER_HOSTNAMES carries duplicate entries")


@pytest.mark.parametrize("env", [
    {"WORKER_HOSTNAMES": "a,b,c", "WORKER_ID": "1"},
    {"WORKER_HOSTNAMES": "a,b", "WORKER_ID": "5"},
    {"WORKER_HOSTNAMES": "a,b", "WORKER_ID": "x"},
    {"WORKER_HOSTNAMES": "a,b"},
    {"WORKER_ID": "0"},
    {},
], ids=["in-range", "out-of-range", "non-digit", "no-id", "no-list", "empty"])
def test_worker_env_reads_the_twins_unprefixed_aliases(env, caplog):
    with caplog.at_level(logging.WARNING):
        port = worker_env.worker_env_from_mapping(env)
    port_warnings = [r.getMessage() for r in caplog.records]
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        twin = twin_tpu_env.host_info_from_mapping(env)
    twin_warnings = [r.getMessage() for r in caplog.records]
    assert (port.worker_id, port.worker_hostnames) == (
        twin.worker_id, list(twin.worker_hostnames or []))
    assert port_warnings == [w.replace("TPU_WORKER_HOSTNAMES", "WORKER_HOSTNAMES")
                             for w in twin_warnings]
    # The TPU names are never read.
    tpu_only = {"TPU_" + k: v for k, v in env.items()}
    assert worker_env.worker_env_from_mapping(tpu_only) == worker_env.WorkerEnv()


def test_worker_env_is_read_from_the_process_environment(monkeypatch):
    monkeypatch.setenv("WORKER_HOSTNAMES", "h0:1,h1:2")
    monkeypatch.setenv("WORKER_ID", "1")
    monkeypatch.setenv("TPU_WORKER_HOSTNAMES", "x,y,z")
    assert worker_env.discover_worker_env() == worker_env.WorkerEnv(1, ["h0:1", "h1:2"])


_RESOLUTION = [
    (mode, oneshot, port, hosts, wid)
    for mode in ("auto", "on", "off")
    for oneshot in (False, True)
    for port in (0, 9101)
    for hosts in ([], ["a"], ["a", "b"], ["a:1", "b:2", "c:3"])
    for wid in (None, 0, 2, 7)
]


def _resolve(new_cfg, factory, module, mode, oneshot, port, hosts, wid, extra):
    cli = {"slice-coordination": mode, "oneshot": str(oneshot).lower(),
           "metrics-port": str(port), **extra}
    info = worker_env.WorkerEnv(wid, list(hosts))
    coord = factory(new_cfg(cli_values=cli, environ={}), info)
    if coord is None:
        return None
    try:
        return (coord.worker_id, coord.hostname, coord.total_hosts, coord.peer_timeout,
                coord.round_budget, coord.fanout, coord.cohort_size, coord.peer_token,
                coord.push_notify, coord._sweep_interval,
                [(p.worker_id, p.host, p.port) for p in coord._peers])
    finally:
        coord.close()


@pytest.mark.parametrize("extra", [
    {}, {"peer-timeout": "0.5s", "labeler-timeout": "4s", "peer-fanout": "1",
         "cohort-size": "2", "peer-token": "tok", "push-notify": "auto",
         "max-staleness": "3s"},
    {"cohort-size": "auto", "peer-fanout": "9", "push-notify": "on", "sleep-interval": "5s"},
], ids=["defaults", "tuned", "auto-sizes"])
def test_new_slice_coordinator_resolves_as_the_twins(extra, caplog):
    for case in _RESOLUTION:
        caplog.clear()
        with caplog.at_level(logging.WARNING, logger="tfd.peering"):
            port = _resolve(new_config, coordinator.new_slice_coordinator, coordinator,
                            *case, extra)
        port_warnings = [r.getMessage() for r in caplog.records]
        caplog.clear()
        with caplog.at_level(logging.WARNING, logger="tfd.peering"):
            twin = _resolve(twin_new_config, twin_coordinator.new_slice_coordinator,
                            twin_coordinator, *case, extra)
        twin_warnings = [r.getMessage() for r in caplog.records]
        assert port == twin, case
        assert port_warnings == [w.replace("TPU_WORKER_HOSTNAMES", "WORKER_HOSTNAMES")
                                 for w in twin_warnings], case
    # auto is on exactly with 2+ workers, a daemon, a server and a valid id.
    on = [c for c in _RESOLUTION if _resolve(new_config, coordinator.new_slice_coordinator,
                                             coordinator, *c, extra) is not None]
    assert on and all(m != "off" and not o and p and len(h) >= 2 and w is not None
                      and w < len(h) for m, o, p, h, w in on)


# ---------------------------------------------------------------------------
# the round budget, and the serving side's fault sites over live HTTP
# ---------------------------------------------------------------------------

TWIN = types.SimpleNamespace(coordinator=twin_coordinator, snapshot=twin_snapshot,
                             metrics=twin_metrics, registry=twin_registry,
                             server=twin_server, faults=twin_faults, backoff=TwinBackoff,
                             ns=TPU)
PORT = types.SimpleNamespace(coordinator=coordinator, snapshot=snapshot, metrics=metrics,
                             registry=registry, server=server, faults=faults,
                             backoff=BackoffPolicy, ns=GPU)


def _budgeted(side, round_budget):
    """Worker 0 of four whose peers answer after 60 ms each (under the
    per-peer timeout, so never confirmed down), one poll at a time."""
    coord = side.coordinator.SliceCoordinator(
        0, [f"w{i}" for i in range(4)], default_port=1, peer_timeout=0.1,
        round_budget=round_budget, clock=lambda: 1000.0, fanout=1,
        backoff_factory=lambda: side.backoff(base=5.0, factor=1.0, cap=5.0, jitter=0.0))

    def fetch(peer, timeout):
        time.sleep(0.06)
        return side.snapshot.build_snapshot(peer.worker_id, f"w{peer.worker_id}",
                                            {side.ns + "chips.sick": "0"}, 1, "full")

    coord._fetch = fetch
    return coord


def _budget_rounds(side):
    side.metrics.reset_for_tests()
    coord = _budgeted(side, 0.1)
    out = []
    try:
        coord.poll_once()
        out.append(sorted(i for i in (1, 2, 3)
                          if coord._peer_state[i].last_snapshot is None))
        out.append([(s.consecutive_failures, s.confirmed_down)
                    for s in coord._peer_state.values()])
        out.append(side.metrics.PEER_POLLS.value(outcome="skipped") > 0)
        for _ in range(3):
            coord.poll_once()
        out.append(all(coord._peer_state[i].last_snapshot is not None for i in (1, 2, 3)))
    finally:
        coord.close()
    return out


def test_round_budget_skips_without_touching_state_and_rotates_as_in_the_twin():
    """A round bounded by its budget skips the peers it cannot reach (no
    miss, verdict untouched) and starts one peer further on each round,
    so a run of slow peers never starves the tail: on both twins."""
    twin, port = _budget_rounds(TWIN), _budget_rounds(PORT)
    assert port[0] and twin[0], "the budget admitted every slow peer"
    assert port[1:] == twin[1:] == [[(0, False)] * 3, True, True]


@pytest.fixture
def serving_pair():
    """On each twin: a real introspection server serving worker 1's
    snapshot, and a worker-0 coordinator whose one peer is that server."""
    pairs = {}
    for name, side in (("twin", TWIN), ("port", PORT)):
        side.metrics.reset_for_tests()
        serving = side.coordinator.SliceCoordinator(1, ["w0", "w1"], default_port=1,
                                                    peer_timeout=0.5)
        serving.publish_local({side.ns + "count": "4", side.ns + "chips.healthy": "4",
                               side.ns + "chips.sick": "0"}, "full")
        srv = side.server.IntrospectionServer(
            side.metrics.REGISTRY, side.server.IntrospectionState(60.0),
            addr="127.0.0.1", port=0, peer_snapshot=serving.snapshot_response,
            peer_fault=serving.serving_fault)
        srv.start()
        polling = side.coordinator.SliceCoordinator(
            0, [f"127.0.0.1:{srv.port + 1}", f"127.0.0.1:{srv.port}"],
            default_port=srv.port, peer_timeout=0.5)
        pairs[name] = (side, srv, serving, polling)
    try:
        yield pairs
    finally:
        for side, srv, serving, polling in pairs.values():
            side.faults.reset()
            polling.close()
            srv.close()


def _fault_script(side, polling, spec, rounds):
    """Establish the peer, arm ``spec`` in the serving process, run the
    rounds; the (consecutive failures, degraded) after each."""
    polling.poll_once()
    side.faults.load_fault_spec(spec)
    out = []
    for _ in range(rounds):
        polling._peer_state[1].next_attempt = 0.0
        polling.poll_once()
        out.append((polling._peer_state[1].consecutive_failures, polling.view().degraded))
    return out, side.metrics.PEER_POLLS.value(outcome="error")


@pytest.mark.parametrize("spec,rounds,want", [
    # A reused connection's drop is retried once on a fresh one: the first
    # miss costs two shots, the second one.
    ("peer.unreachable:fail:3", 3, [(1, False), (2, True), (0, False)]),
    ("peer.junk:fail:2", 3, [(1, False), (2, True), (0, False)]),
    ("peer.slow:fail:1", 2, [(1, False), (0, False)]),
])
def test_serving_fault_sites_act_as_in_the_twin(serving_pair, spec, rounds, want):
    got = {}
    for name, (side, srv, serving, polling) in serving_pair.items():
        started = time.perf_counter()
        got[name] = _fault_script(side, polling, spec, rounds)
        if spec.startswith("peer.slow"):
            # The poll paid its timeout, not the handler's whole stall.
            assert time.perf_counter() - started < side.server.PEER_SLOW_DELAY_S + 2.0
        side.faults.reset()
    assert got["port"] == got["twin"]
    assert got["port"][0] == want


def test_tier_fault_gates_act_as_in_the_twin():
    """peer.tier-partition drops slice-tier polls only; peer.cohort-leader-
    dead drops every poll while the daemon is a cohort leader."""
    out = {}
    for name, side in (("twin", TWIN), ("port", PORT)):
        coord = side.coordinator.SliceCoordinator(2, ["w0", "w1", "w2", "w3"],
                                                  default_port=1, peer_timeout=0.1,
                                                  cohort_size=2)
        try:
            side.faults.load_fault_spec("peer.tier-partition:fail:1,"
                                        "peer.cohort-leader-dead:fail:1")
            row = [coord.serving_fault("cohort"), coord.serving_fault("slice"),
                   coord.serving_fault("slice")]
            coord._role = "cohort-leader"
            row += [coord.serving_fault("cohort"), coord.serving_fault("cohort")]
            coord.force_tier_partition = True
            row.append(coord.serving_fault("slice"))
            out[name] = row
        finally:
            side.faults.reset()
            coord.close()
    assert out["port"] == out["twin"] == [False, True, False, True, False, True]
