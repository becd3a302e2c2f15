"""Push-on-delta notifications of the PyTorch port (peering/notify.py, the
``POST /peer/notify`` handler of obs/server.py and the coordinator's
dirty/sweep targeting) against their JAX twin, on the CPU.

Every scenario of the twin's tests/test_notify.py runs here through BOTH
packages on the same inputs: the same publishes to the same recording
parent, the same requests to a twin and a port server, the same clock
steps through a twin and a port coordinator, and (the three collector
scenarios at the end) through a twin and a port fleet collector in
lockstep (tests/torch_fleet_pair.py). The outcomes (delivered documents,
status codes and bodies, counter deltas, target sets) must be equal, and
equal to what the twin's own test expects. Nothing here is a float;
every comparison is exact.
"""

import http.server
import json
import socket
import threading
import time
import types
import urllib.error
import urllib.request

import pytest

from gpu_feature_discovery_tpu.cmd import events as twin_events
from gpu_feature_discovery_tpu.config import spec as twin_spec
from gpu_feature_discovery_tpu.obs import metrics as twin_metrics
from gpu_feature_discovery_tpu.obs import registry as twin_registry
from gpu_feature_discovery_tpu.obs import server as twin_server
from gpu_feature_discovery_tpu.peering import coordinator as twin_coordinator
from gpu_feature_discovery_tpu.peering import notify as twin_notify
from gpu_feature_discovery_tpu.utils import faults as twin_faults
from gpu_feature_discovery_tpu.utils import retry as twin_retry
from gpu_feature_discovery_tpu_torch.cmd import events
from gpu_feature_discovery_tpu_torch.config import spec
from gpu_feature_discovery_tpu_torch.obs import metrics
from gpu_feature_discovery_tpu_torch.obs import registry
from gpu_feature_discovery_tpu_torch.obs import server
from gpu_feature_discovery_tpu_torch.peering import coordinator
from gpu_feature_discovery_tpu_torch.peering import notify
from gpu_feature_discovery_tpu_torch.utils import faults
from gpu_feature_discovery_tpu_torch.utils import retry

TWIN = types.SimpleNamespace(
    notify=twin_notify, server=twin_server, registry=twin_registry,
    metrics=twin_metrics, faults=twin_faults, coordinator=twin_coordinator,
    retry=twin_retry, events=twin_events, spec=twin_spec,
)
PORT = types.SimpleNamespace(
    notify=notify, server=server, registry=registry, metrics=metrics,
    faults=faults, coordinator=coordinator, retry=retry, events=events,
    spec=spec,
)
SIDES = {"twin": TWIN, "port": PORT}


def _both(scenario):
    """Run ``scenario(side)`` on the twin, then on the port: (twin, port)."""
    return scenario(TWIN), scenario(PORT)


# ---------------------------------------------------------------------------
# mode resolution and the wire vocabulary
# ---------------------------------------------------------------------------

def test_resolve_push_notify_modes_match_the_twins():
    cases = [(m, t) for m in ("on", "off", "auto") for t in ("", "tok")]
    for mode, token in cases:
        assert (notify.resolve_push_notify(mode, token)
                == twin_notify.resolve_push_notify(mode, token)), (mode, token)
    assert notify.resolve_push_notify("auto", "tok") is True
    assert notify.resolve_push_notify("auto", "") is False
    for module in (notify, twin_notify):
        with pytest.raises(ValueError, match="invalid push-notify mode: 'sometimes'"):
            module.resolve_push_notify("sometimes", "tok")
    assert spec.PUSH_NOTIFY_MODES == twin_spec.PUSH_NOTIFY_MODES
    assert spec.SLICE_COORDINATION_MODES == twin_spec.SLICE_COORDINATION_MODES


def test_header_spellings_pinned_across_layers_and_twins():
    """obs/server.py restates the subscribe and tier header names (obs
    does not import peering): the spellings match across the layers and
    the twins."""
    for side in (TWIN, PORT):
        assert side.server._NOTIFY_PORT_HEADER == side.notify.NOTIFY_PORT_HEADER
        assert side.server._NOTIFY_NAME_HEADER == side.notify.NOTIFY_NAME_HEADER
        assert side.server._POLL_TIER_HEADER == side.coordinator.POLL_TIER_HEADER
    for name in ("NOTIFY_PORT_HEADER", "NOTIFY_NAME_HEADER", "NOTIFY_PATH",
                 "NOTIFY_SCHEMA", "SUBSCRIPTION_TTL_SWEEPS", "NOTIFY_MAX_ATTEMPTS",
                 "NOTIFY_TIMEOUT_S"):
        assert getattr(notify, name) == getattr(twin_notify, name), name
    assert server.PEER_SLOW_DELAY_S == twin_server.PEER_SLOW_DELAY_S


# ---------------------------------------------------------------------------
# NotifySubscriptions
# ---------------------------------------------------------------------------

def _subscriptions_timeline(side):
    now = [0.0]
    subs = side.notify.NotifySubscriptions(10.0, clock=lambda: now[0])
    out = []
    subs.observe_poll("10.0.0.1", 9101, "slice-a")
    subs.observe_poll("10.0.0.2", 9102, "slice-a")
    out.append(subs.targets())
    now[0] = 9.0
    subs.observe_poll("10.0.0.1", 9101, "slice-a")
    now[0] = 11.0
    out.append(subs.targets())
    now[0] = 25.0
    out.append(subs.targets())
    bad = side.notify.NotifySubscriptions(10.0)
    for entry in (("", 9101, "a"), ("10.0.0.1", 0, "a"), ("10.0.0.1", -1, "a"),
                  ("10.0.0.1", 9101, "")):
        bad.observe_poll(*entry)
    out.append(bad.targets())
    return out


def test_subscriptions_ttl_refresh_and_unusable_entries_match_the_twins():
    twin, port = _both(_subscriptions_timeline)
    assert port == twin
    assert port == [
        [("10.0.0.1", 9101, "slice-a"), ("10.0.0.2", 9102, "slice-a")],
        [("10.0.0.1", 9101, "slice-a")],
        [],
        [],
    ]


def _subscription_counts(side):
    now = [0.0]
    subs = side.notify.NotifySubscriptions(10.0, clock=lambda: now[0])
    counts = [len(subs)]
    subs.observe_poll("10.0.0.1", 9101, "slice-a")
    subs.observe_poll("10.0.0.2", 9102, "slice-a")
    subs.observe_poll("10.0.0.2", 9102, "slice-a")
    counts.append(len(subs))
    now[0] = 9.0
    subs.observe_poll("10.0.0.1", 9101, "slice-a")
    now[0] = 11.0
    counts.append(len(subs))
    now[0] = 25.0
    counts.append(len(subs))
    return counts


def test_subscriptions_count_only_live_entries_as_in_the_twin():
    """Fault 9: the size of the registry, lapsed entries pruned, which the
    notify-lost chaos row reads after the cold sweep."""
    twin, port = _both(_subscription_counts)
    assert port == twin == [0, 2, 1, 0]


# ---------------------------------------------------------------------------
# NotifySender
# ---------------------------------------------------------------------------

class _NotifyParent:
    """A real parent endpoint recording /peer/notify POSTs."""

    def __init__(self, status=202):
        self.received = []
        self.status = status
        outer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_POST(self):  # noqa: N802 - stdlib API
                length = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(length)
                outer.received.append((self.path, json.loads(body.decode()),
                                       self.headers.get("X-TFD-Probe-Token", "")))
                self.send_response(outer.status)
                self.send_header("Content-Length", "0")
                self.end_headers()

            def log_message(self, *a):
                pass

        self.httpd = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.port = self.httpd.server_address[1]
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def _wait_for(predicate, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(0.01)
    return predicate()


def _sender(side, port, **kw):
    subs = side.notify.NotifySubscriptions(60.0)
    subs.observe_poll("127.0.0.1", port, "slice-a")
    return side.notify.NotifySender(subs, **kw)


def _deliver_one(side):
    parent = _NotifyParent()
    sender = _sender(side, parent.port, token="sekrit")
    try:
        sender.publish(7, '"abc"')
        assert _wait_for(lambda: len(parent.received) >= 1)
        return parent.received
    finally:
        sender.close()
        parent.close()


def test_sender_delivers_with_token_and_schema_as_the_twin():
    twin, port = _both(_deliver_one)
    assert port == twin == [("/peer/notify", {
        "schema": 1, "name": "slice-a", "generation": 7, "etag": '"abc"',
    }, "sekrit")]


@pytest.mark.parametrize("side", sorted(SIDES))
def test_sender_publish_never_blocks_on_hung_parent(side):
    """A parent that accepts the connection and never answers: publish()
    returns at once on both twins, delivery runs on the sender's thread."""
    ns = SIDES[side]
    hung = socket.socket()
    hung.bind(("127.0.0.1", 0))
    hung.listen(1)
    sender = _sender(ns, hung.getsockname()[1], token="sekrit", timeout=0.5,
                     backoff=ns.retry.BackoffPolicy(base=0.05, cap=0.1, jitter=0.0))
    try:
        started = time.monotonic()
        for generation in range(1, 6):
            sender.publish(generation, f'"e{generation}"')
        elapsed = time.monotonic() - started
        assert elapsed < 0.4, f"publish blocked {elapsed:.3f}s"
    finally:
        sender.close()
        hung.close()


@pytest.mark.parametrize("side", sorted(SIDES))
def test_sender_coalesces_to_latest_and_counts_dropped(side):
    ns = SIDES[side]
    parent = _NotifyParent()
    sender = _sender(ns, parent.port, token="t")
    before = ns.metrics.NOTIFY_SENT.value(outcome="dropped")
    try:
        for generation in range(1, 21):
            sender.publish(generation, f'"e{generation}"')
        assert _wait_for(lambda: any(d["generation"] == 20 for _, d, _t in parent.received))
        assert _wait_for(lambda: sender._pending is None)
        delivered = len(parent.received)
        dropped = ns.metrics.NOTIFY_SENT.value(outcome="dropped") - before
        assert delivered + dropped >= 20
        assert delivered < 20
    finally:
        sender.close()
        parent.close()


def _rejected_once(side):
    parent = _NotifyParent(status=503)
    sender = _sender(side, parent.port, token="t")
    before = side.metrics.NOTIFY_SENT.value(outcome="rejected")
    try:
        sender.publish(1, '"e"')
        assert _wait_for(lambda: side.metrics.NOTIFY_SENT.value(outcome="rejected")
                         == before + 1)
        time.sleep(0.1)  # a retry would land a second POST
        return len(parent.received)
    finally:
        sender.close()
        parent.close()


def test_sender_rejection_is_not_retried_as_in_the_twin():
    assert _both(_rejected_once) == (1, 1)


def _drop_shot(side):
    parent = _NotifyParent()
    sender = _sender(side, parent.port, token="t")
    try:
        side.faults.load_fault_spec("notify.drop:fail:1")
        sender.publish(1, '"e1"')
        assert sender.flush()
        sender.publish(2, '"e2"')
        assert _wait_for(lambda: any(d["generation"] == 2 for _, d, _t in parent.received))
        return sorted(d["generation"] for _, d, _t in parent.received)
    finally:
        side.faults.reset()
        sender.close()
        parent.close()


def test_notify_drop_fault_loses_the_notification_as_in_the_twin():
    assert _both(_drop_shot) == ([2], [2])


# ---------------------------------------------------------------------------
# POST /peer/notify: the auth ladder, the unknown child, the reject fault
# ---------------------------------------------------------------------------

_NOTIFY_BODY = json.dumps({"schema": 1, "name": "7", "generation": 3,
                           "etag": '"x"'}).encode()


def _post_notify(port, headers=None, body=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/peer/notify",
        data=_NOTIFY_BODY if body is None else body, method="POST",
        headers=headers or {},
    )
    try:
        with urllib.request.urlopen(req, timeout=5) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _serving(side, **kw):
    s = side.server.IntrospectionServer(
        side.registry.Registry(), side.server.IntrospectionState(60.0),
        addr="127.0.0.1", port=0, **kw)
    s.start()
    return s


_NOTIFY_OUTCOMES = ("ok", "unauthorized", "unknown", "invalid", "disabled", "rejected")


def _auth_ladder(side):
    woken = []
    hook = lambda n, g, e: woken.append((n, g, e)) or True  # noqa: E731
    before = {o: side.metrics.NOTIFY_RECEIVED.value(outcome=o) for o in _NOTIFY_OUTCOMES}
    answers = []
    s = _serving(side)
    try:
        answers.append(_post_notify(s.port))
    finally:
        s.close()
    s = _serving(side, peer_notify=hook, peer_token="")
    try:
        answers.append(_post_notify(s.port))
    finally:
        s.close()
    answers.append(list(woken))
    s = _serving(side, peer_notify=hook, peer_token="sekrit")
    try:
        answers.append(_post_notify(s.port))
        answers.append(_post_notify(s.port, {"X-TFD-Probe-Token": "wrong"}))
        answers.append(list(woken))
        answers.append(_post_notify(s.port, {"X-TFD-Probe-Token": "sekrit"}))
        answers.append(_post_notify(s.port, {"Authorization": "Bearer sekrit"}))
        answers.append(_post_notify(s.port, {"X-TFD-Probe-Token": "sekrit"},
                                    body=b"not json"))
        answers.append(_post_notify(s.port, {"X-TFD-Probe-Token": "sekrit"},
                                    body=b'{"generation": 1}'))
        answers.append(list(woken))
    finally:
        s.close()
    s = _serving(side, peer_notify=lambda n, g, e: False, peer_token="sekrit")
    try:
        answers.append(_post_notify(s.port, {"X-TFD-Probe-Token": "sekrit"}))
    finally:
        s.close()
    s = _serving(side, peer_notify=hook, peer_token="sekrit")
    try:
        side.faults.load_fault_spec("notify.reject:fail:1")
        answers.append(_post_notify(s.port, {"X-TFD-Probe-Token": "sekrit"}))
        answers.append(_post_notify(s.port, {"X-TFD-Probe-Token": "sekrit"}))
    finally:
        side.faults.reset()
        s.close()
    answers.append(list(woken))
    answers.append({o: side.metrics.NOTIFY_RECEIVED.value(outcome=o) - n
                    for o, n in before.items()})
    return answers


def test_post_notify_auth_ladder_unknown_child_and_reject_fault_match_the_twin():
    """The POST /probe ladder: no hook 404, no token 403, wrong or missing
    token 401, junk 400, a name outside the peer set 404, the reject
    fault 503; the hook runs only past every check."""
    twin, port = _both(_auth_ladder)
    assert port == twin
    codes = [a[0] for a in port if isinstance(a, tuple)]
    assert codes == [404, 403, 401, 401, 202, 202, 400, 400, 404, 503, 202]
    assert port[2] == [] and port[5] == []
    assert port[-2] == [("7", 3, '"x"')] * 3
    assert port[-1] == {"ok": 3, "unauthorized": 3, "unknown": 1, "invalid": 2,
                        "disabled": 1, "rejected": 1}


def _subscribe_by_poll(side):
    seen = []
    s = _serving(side, peer_snapshot=lambda: (b'{"schema": 1}', '"e"'),
                 notify_subscribe=lambda host, port, name: seen.append((host, port, name)))
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{s.port}/peer/snapshot",
            headers={side.notify.NOTIFY_PORT_HEADER: "9150",
                     side.notify.NOTIFY_NAME_HEADER: "3"})
        with urllib.request.urlopen(req, timeout=5) as resp:
            first = (resp.status, resp.read(), resp.getheader("ETag"))
        after_first = list(seen)
        with urllib.request.urlopen(f"http://127.0.0.1:{s.port}/peer/snapshot",
                                    timeout=5) as resp:
            second = resp.status
        return first, after_first, second, list(seen)
    finally:
        s.close()


def test_snapshot_poll_with_headers_subscribes_as_in_the_twin():
    twin, port = _both(_subscribe_by_poll)
    assert port == twin
    assert port == ((200, b'{"schema": 1}', '"e"'), [("127.0.0.1", 9150, "3")], 200,
                    [("127.0.0.1", 9150, "3")])


# ---------------------------------------------------------------------------
# the parent's targeting: dirty and suspects between sweeps
# ---------------------------------------------------------------------------

def _targeting(side):
    now = [0.0]
    coord = side.coordinator.SliceCoordinator(
        0, ["w0", "w1", "w2"], default_port=1, peer_timeout=0.1,
        clock=lambda: now[0], push_notify=True, sweep_interval=100.0)
    ids = lambda: sorted(p.worker_id for p in coord._round_targets())  # noqa: E731
    out = []
    try:
        out.append(ids())  # cold start: always a sweep
        for state in coord._peer_state.values():
            state.ever_reached = True
            state.consecutive_failures = 0
        now[0] = 1.0
        out.append(ids())
        out.append(coord.mark_dirty("2"))
        out.append(ids())
        out.append(ids())
        coord._peer_state[1].consecutive_failures = 1
        out.append(ids())
        now[0] = 101.0
        out.append(ids())
        out.append([coord.mark_dirty(n) for n in ("not-a-worker", "99", "1")])
    finally:
        coord.close()
    out.append(coord.mark_dirty("1"))  # closed: never dirties
    pull = side.coordinator.SliceCoordinator(0, ["w0", "w1"], default_port=1,
                                             peer_timeout=0.1)
    try:
        out.append((pull.push_notify, pull.notify_subscriptions, pull.notify_sender,
                    all(pull._round_targets() is pull._peers for _ in range(3))))
    finally:
        pull.close()
    return out


def test_coordinator_round_targets_and_mark_dirty_match_the_twin():
    twin, port = _both(_targeting)
    assert port == twin
    assert port == [[1, 2], [], True, [2], [], [1], [1, 2], [False, False, True],
                    False, (False, None, None, True)]


# ---------------------------------------------------------------------------
# the reconcile loop's membership producer
# ---------------------------------------------------------------------------

def _membership_events(side):
    q = side.events.EventQueue()
    tracker = side.events.DeltaTracker(q)
    drained = []

    def drain():
        event = q.get_nowait()
        drained.append(None if event is None else (event.reason, event.detail))

    tracker.observe_membership("slice", frozenset({0, 1}))
    tracker.observe_membership("region", frozenset({"r1", "r2"}))
    drain()
    tracker.observe_membership("slice", frozenset({0, 1}))
    tracker.observe_membership("region", frozenset({"r1", "r2"}))
    drain()
    tracker.observe_membership("region", frozenset({"r1"}))
    drain()
    drain()
    tracker2 = side.events.DeltaTracker(q)
    tracker2.observe_membership("fleet", frozenset())
    drain()
    tracker2.observe_membership("fleet", frozenset({"a"}))
    drain()
    tracker3 = side.events.DeltaTracker(q)
    tracker3.observe_peers(frozenset({0, 1}))
    drain()
    tracker3.observe_peers(frozenset({0}))
    drain()
    tracker3.observe_peers(None)
    tracker3.observe_peers(frozenset({0}))
    drain()
    return drained


def test_delta_tracker_membership_scopes_match_the_twin():
    twin, port = _both(_membership_events)
    assert port == twin
    assert port == [None, None, ("peer_delta", "['r1']"), None, None,
                    ("peer_delta", "['a']"), None, ("peer_delta", "[0]"), None]
    assert events.REASON_PEER_DELTA == twin_events.REASON_PEER_DELTA
    assert events.REASON_PEER_NOTIFY == twin_events.REASON_PEER_NOTIFY


# ---------------------------------------------------------------------------
# the fleet collector's targeting (the fleet tier of push-on-delta)
# ---------------------------------------------------------------------------

def test_collector_round_targets_dirty_and_sweep():
    """The fleet tier mirrors the peer tier's targeting rule over target
    NAMES (regions/slices), with the same cold-start sweep, on both
    collectors in lockstep."""
    from torch_fleet_pair import fleet

    now = [0.0]
    targets = [
        fleet.SliceTarget(name=f"s{i}", hosts=(f"127.0.0.1:{9000 + i}",))
        for i in range(3)
    ]
    collector = fleet.FleetCollector(
        targets,
        push_notify=True,
        sweep_interval=100.0,
        clock=lambda: now[0],
    )
    try:
        assert collector._round_targets() == ["s0", "s1", "s2"]  # cold sweep
        for state in collector._slices.values():
            for hstate in state.hosts:
                hstate.ever_reached = True
        now[0] = 1.0
        assert collector._round_targets() == []
        assert collector.mark_dirty("nope") is False
        assert collector.mark_dirty("s1") is True
        assert collector._round_targets() == ["s1"]
        assert collector._round_targets() == []
        collector._slices["s2"].hosts[0].consecutive_failures = 1
        assert collector._round_targets() == ["s2"]
        now[0] = 101.0
        assert collector._round_targets() == ["s0", "s1", "s2"]
    finally:
        collector.close()


def test_collector_chain_tail_is_not_a_perpetual_suspect():
    """The chain walk stops at the first leader-bearing host, so members
    past the leader are never attempted: they must not count as suspects
    (that would re-poll every multi-host slice every round); only a
    target with NO host ever reached is polled before its first sweep.
    Both collectors in lockstep."""
    from torch_fleet_pair import fleet

    now = [0.0]
    targets = [
        fleet.SliceTarget(
            name="multi",
            hosts=("127.0.0.1:9100", "127.0.0.1:9101", "127.0.0.1:9102"),
        ),
        fleet.SliceTarget(name="fresh", hosts=("127.0.0.1:9103",)),
    ]
    collector = fleet.FleetCollector(
        targets,
        push_notify=True,
        sweep_interval=100.0,
        clock=lambda: now[0],
    )
    try:
        assert collector._round_targets() == ["multi", "fresh"]  # cold
        collector._slices["multi"].hosts[0].ever_reached = True
        now[0] = 1.0
        assert collector._round_targets() == ["fresh"]
        collector._slices["fresh"].hosts[0].ever_reached = True
        assert collector._round_targets() == []  # idle at last
        # A failure streak anywhere in the chain still suspects the
        # target.
        collector._slices["multi"].hosts[1].consecutive_failures = 1
        assert collector._round_targets() == ["multi"]
    finally:
        collector.close()


def test_collector_pull_mode_polls_everyone():
    from torch_fleet_pair import fleet

    targets = [
        fleet.SliceTarget(name=f"s{i}", hosts=(f"127.0.0.1:{9000 + i}",))
        for i in range(2)
    ]
    collector = fleet.FleetCollector(targets)
    try:
        assert collector.push_notify is False
        assert collector.notify_sender is None
        for _ in range(3):
            assert collector._round_targets() == ["s0", "s1"]
    finally:
        collector.close()
