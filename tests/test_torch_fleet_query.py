"""The fleet query surface of the PyTorch port (fleet/query.py, the
query, delta and watch faces of fleet/collector.py, the /fleet/snapshot
query route and the --max-inflight-requests gate of obs/server.py)
against its JAX twin, on the CPU.

Every scenario of the twin's tests/test_fleet_query.py runs here
through BOTH collectors in lockstep (tests/torch_fleet_pair.py): the
same mock slice leaders (the twin rig tests/fleet_scale.py's MockFleet,
unedited), the same frozen wall clock, the same queries. Every filtered
body, delta, ETag, status, Retry-After and counter delta must be equal
byte for byte; watches park on both sides at once. Nothing compared is
a float.
"""

import json
import threading
import time

import pytest

import torch_fleet_pair as tfp
from fleet_scale import MockFleet
from fleet_scale import fleet_get as rig_fleet_get
from gpu_feature_discovery_tpu.fleet.query import QueryError
from torch_fleet_pair import (
    IntrospectionServer,
    IntrospectionState,
    collector,
    inventory,
    obs_metrics,
    obs_server,
    query,
    side_dir,
)

FleetCollector = collector.FleetCollector
DeltaMirror = inventory.DeltaMirror
FleetQuery = query.FleetQuery
entry_matches = query.entry_matches
parse_fleet_query = query.parse_fleet_query
fleet_get = tfp.paired_fleet_get(rig_fleet_get)

FROZEN_WALL = 1_700_000_000.0


def _collector(mock, **kwargs):
    col = FleetCollector(
        mock.targets(),
        peer_timeout=5.0,
        wall_clock=kwargs.pop("wall_clock", lambda: FROZEN_WALL),
        **kwargs,
    )
    col.poll_round()
    return col


def _serve(col, **kwargs):
    server = IntrospectionServer(
        obs_metrics.REGISTRY,
        IntrospectionState(60.0),
        addr="127.0.0.1",
        port=0,
        fleet_snapshot=col.inventory_response,
        fleet_query=col.query_response,
        **kwargs,
    )
    server.start()
    return server


def _query(col, raw, etag=None):
    """query_response for a plain (non-watch) exchange."""
    status, body, etag, retry, filtered = col.query_response(raw, etag)
    return status, body, etag, retry, filtered


# ---------------------------------------------------------------------------
# grammar: parse + canonicalize, and the 400 rejection matrix
# ---------------------------------------------------------------------------

def test_canonicalization_sorts_and_normalizes():
    q = parse_fleet_query("stale=TRUE&region=euw4&degraded=false")
    assert q.canonical == "degraded=false&region=euw4&stale=true"
    assert q.filtered and q.stale is True and q.degraded is False
    # Identical filters in any spelling share one cache identity.
    q2 = parse_fleet_query("degraded=False&stale=true&region=euw4")
    assert q2.canonical == q.canonical
    # Control params never enter the canonical filter identity.
    q3 = parse_fleet_query("since=4&degraded=false&region=euw4&stale=true")
    assert q3.canonical == q.canonical and q3.since == 4
    assert parse_fleet_query("") == FleetQuery()
    assert not parse_fleet_query("since=0").filtered


@pytest.mark.parametrize(
    "raw",
    [
        "color=blue",                   # unknown param
        "degraded",                     # no value
        "degraded=true&degraded=true",  # duplicate (even identical)
        "degraded=yes",                 # non-boolean
        "stale=1",
        "sick-chips=maybe",
        "max-age=soon",
        "max-age=0",
        "max-age=-5",
        "region=",                      # empty region
        "region=" + "x" * 300,          # cache-key length cap
        "since=banana",                 # a garbled ?since
        "since=-1",
        "watch=5",                      # watch without a since baseline
        "since=1&watch=0",
        "since=1&watch=-2",
        "since=1&watch=soon",
    ],
)
def test_rejection_matrix(raw):
    with pytest.raises(QueryError):
        parse_fleet_query(raw)


def test_entry_matching_semantics():
    entry = {
        "region": "euw4", "degraded": True, "stale": False,
        "sick_chips": 2, "last_seen_unix": 1000,
    }
    assert entry_matches(parse_fleet_query("region=euw4"), entry, None)
    assert not entry_matches(parse_fleet_query("region=usc1"), entry, None)
    assert entry_matches(parse_fleet_query("degraded=true"), entry, None)
    # sick_chips is a count on the wire; the filter reads truthiness.
    assert entry_matches(parse_fleet_query("sick-chips=true"), entry, None)
    assert entry_matches(
        parse_fleet_query("degraded=true&stale=false"), entry, None
    )
    assert not entry_matches(
        parse_fleet_query("degraded=true&stale=true"), entry, None
    )
    # max-age: inside the horizon matches, outside does not, and a
    # never-seen (all-null) entry never matches.
    assert entry_matches(parse_fleet_query("max-age=600"), entry, 1500)
    assert not entry_matches(parse_fleet_query("max-age=300"), entry, 1500)
    assert not entry_matches(
        parse_fleet_query("max-age=600"), {"last_seen_unix": None}, 1500
    )


# ---------------------------------------------------------------------------
# the per-filter view economy (collector level)
# ---------------------------------------------------------------------------

def test_filtered_view_serialize_once_and_304():
    mock = MockFleet(6)
    col = None
    try:
        col = _collector(mock)
        renders0 = obs_metrics.FLEET_FILTER_RENDERS.value()
        status, body, etag, _r, filtered = _query(col, "degraded=false")
        assert (status, filtered) == (200, True)
        doc = json.loads(body)
        assert doc["filter"] == "degraded=false"
        assert len(doc["slices"]) == 6
        # Any spelling of the same filter, any number of repeat polls:
        # one serialization total, same bytes, same strong ETag.
        for raw in ("degraded=false", "degraded=FALSE"):
            s2, b2, e2, _r2, _f2 = _query(col, raw)
            assert (b2, e2) == (body, etag)
        assert obs_metrics.FLEET_FILTER_RENDERS.value() == renders0 + 1
        # Idle polls with the view's ETag ride the handler's 304; the
        # unfiltered pane is untouched by all of this — byte for byte.
        assert col.inventory_response()[0] != body
        # The filtered view's generation freezes while global churn
        # misses the filter: flip everything to degraded=true and the
        # degraded=false view keeps its body, ETag, and generation.
        before_gen = doc["generation"]
        mock.churn(1.0, notify=False)
        col.poll_round()
        s3, b3, e3, _r3, _f3 = _query(col, "degraded=false")
        doc3 = json.loads(b3)
        assert doc3["slices"] == {}
        assert doc3["generation"] > before_gen
        s4, b4, e4, _r4, _f4 = _query(col, "degraded=true")
        assert len(json.loads(b4)["slices"]) == 6
        # ...and now the true-pane freezes across a no-op revalidation.
        renders1 = obs_metrics.FLEET_FILTER_RENDERS.value()
        s5, b5, e5, _r5, _f5 = _query(col, "degraded=true")
        assert (b5, e5) == (b4, e4)
        assert obs_metrics.FLEET_FILTER_RENDERS.value() == renders1
    finally:
        if col is not None:
            col.close()
        mock.close()


def test_filtered_delta_applies_through_delta_mirror():
    mock = MockFleet(8)
    col = None
    try:
        col = _collector(mock)
        status, body, etag, _r, _f = _query(col, "degraded=false")
        mirror = DeltaMirror()
        mirror.apply(json.loads(body), etag)
        since = mirror.generation
        # One slice flips away from the filter: the view's next
        # generation serves an O(changed) delta with a tombstone, and
        # the mirror's ETag-verified reconstruction accepts it.
        mock.churn(1 / 8, notify=False)
        col.poll_round()
        status, dbody, detag, _r, _f = col.query_response(
            f"degraded=false&since={since}", etag
        )
        ddoc = json.loads(dbody)
        assert ddoc["delta"] is True
        assert ddoc["filter"] == "degraded=false"
        # The flipped slice LEFT the filter: one tombstone, no changed
        # entries — the delta is scoped to the filtered view.
        assert len(ddoc["tombstones"]) == 1
        assert ddoc["changed"] == {}
        rebuilt = mirror.apply(ddoc, detag)
        full = json.loads(col.query_response("degraded=false", None)[1])
        assert rebuilt == full
        # A straggler off the one-step lineage resyncs with the full
        # filtered body — never a wrong delta.
        resyncs0 = obs_metrics.FLEET_DELTA_SERVED.value(outcome="resync")
        status, rbody, _re, _r, _f = col.query_response(
            f"degraded=false&since={max(0, since - 1)}", "\"bogus\""
        )
        assert not json.loads(rbody).get("delta")
        assert (
            obs_metrics.FLEET_DELTA_SERVED.value(outcome="resync")
            == resyncs0 + 1
        )
    finally:
        if col is not None:
            col.close()
        mock.close()


def test_region_empty_is_rejected_not_wildcard():
    # Regression guard for the warm-up line above ever changing: an
    # empty region is part of the 400 matrix, asserted over the full
    # query_response path (status, no etag, rejection counted).
    mock = MockFleet(2)
    col = None
    try:
        col = _collector(mock)
        rejected0 = obs_metrics.FLEET_QUERY_REJECTED.value()
        status, body, etag, retry, filtered = _query(col, "region=")
        assert status == 400 and etag is None
        assert b"bad fleet query" in body
        assert obs_metrics.FLEET_QUERY_REJECTED.value() == rejected0 + 1
    finally:
        if col is not None:
            col.close()
        mock.close()


def test_max_age_aging_resets_lineage_with_one_resync():
    wall = {"now": FROZEN_WALL}
    mock = MockFleet(3)
    col = None
    try:
        col = _collector(mock, wall_clock=lambda: wall["now"])
        status, body, etag, _r, _f = _query(col, "max-age=300")
        assert len(json.loads(body)["slices"]) == 3
        since = json.loads(body)["generation"]
        # The clock crosses the horizon with NO commit: membership
        # changes with no generation to stamp it, so the view ages out
        # in place (a fresh body under the SAME generation) and every
        # delta client resyncs exactly once.
        wall["now"] = FROZEN_WALL + 1200
        resyncs0 = obs_metrics.FLEET_DELTA_SERVED.value(outcome="resync")
        status, aged, aetag, _r, _f = col.query_response(
            f"max-age=300&since={since}", etag
        )
        adoc = json.loads(aged)
        assert not adoc.get("delta")
        assert adoc["slices"] == {}
        assert adoc["generation"] == since
        assert aetag != etag
        assert (
            obs_metrics.FLEET_DELTA_SERVED.value(outcome="resync")
            == resyncs0 + 1
        )
        # After the reset the new lineage serves 304s again.
        status, b2, e2, _r, _f = col.query_response("max-age=300", aetag)
        assert e2 == aetag and b2 == aged
    finally:
        if col is not None:
            col.close()
        mock.close()


def test_filter_cache_lru_evicts_and_counts():
    mock = MockFleet(2)
    col = None
    try:
        col = _collector(mock, filter_cache_size=2)
        unfiltered = col.inventory_response()
        evict0 = obs_metrics.FLEET_FILTER_CACHE.value(outcome="evict")
        _query(col, "degraded=true")
        _query(col, "stale=true")
        assert obs_metrics.FLEET_FILTER_CACHE.value(outcome="evict") == evict0
        # A third distinct filter evicts the least-recently-used view;
        # re-requesting the evicted one is a miss + re-render.
        _query(col, "sick-chips=true")
        assert (
            obs_metrics.FLEET_FILTER_CACHE.value(outcome="evict")
            == evict0 + 1
        )
        renders0 = obs_metrics.FLEET_FILTER_RENDERS.value()
        _query(col, "degraded=true")
        assert obs_metrics.FLEET_FILTER_RENDERS.value() == renders0 + 1
        # The unfiltered pane rode out all of it untouched: it lives in
        # the collector's own publish seam, never in the LRU.
        assert col.inventory_response() == unfiltered
    finally:
        if col is not None:
            col.close()
        mock.close()


# ---------------------------------------------------------------------------
# long-poll watch
# ---------------------------------------------------------------------------

def test_watch_wakes_on_filtered_movement():
    mock = MockFleet(4)
    col = None
    try:
        col = _collector(mock)
        status, body, etag, _r, _f = _query(col, "degraded=true")
        assert json.loads(body)["slices"] == {}
        since = json.loads(body)["generation"]
        parked = threading.Event()
        result = {}

        def watch():
            result["answer"] = col.query_response(
                f"degraded=true&since={since}&watch=10",
                etag,
                on_park=parked.set,
            )

        t = threading.Thread(target=watch, daemon=True)
        start = time.monotonic()
        t.start()
        assert parked.wait(5)
        assert obs_metrics.FLEET_WATCHERS.value() == 1
        mock.churn(0.5, notify=False)
        col.poll_round()
        t.join(timeout=5)
        assert not t.is_alive()
        wake_ms = (time.monotonic() - start) * 1000
        status, wbody, wetag, _r, filtered = result["answer"]
        assert (status, filtered) == (200, True)
        wdoc = json.loads(wbody)
        # The wake answers the FILTERED one-step delta, fast.
        assert wdoc["delta"] is True and wdoc["since"] == since
        assert len(wdoc["changed"]) == 2
        assert wetag != etag
        assert wake_ms < 5000
        assert obs_metrics.FLEET_WATCHERS.value() == 0
    finally:
        if col is not None:
            col.close()
        mock.close()


def test_watch_timeout_answers_304_and_close_unparks():
    mock = MockFleet(2)
    col = None
    try:
        col = _collector(mock, watch_timeout=0.2)
        body, etag = col.inventory_response()
        gen = json.loads(body)["generation"]
        timeouts0 = obs_metrics.FLEET_WATCH.value(outcome="timeout")
        # An idle watch answers at min(watch, --watch-timeout) with the
        # matching ETag — the handler's 304, and the client re-arms.
        start = time.monotonic()
        status, tbody, tetag, _r, filtered = col.query_response(
            f"since={gen}&watch=30", etag
        )
        assert time.monotonic() - start < 5
        assert (status, tetag, filtered) == (200, etag, False)
        assert (
            obs_metrics.FLEET_WATCH.value(outcome="timeout")
            == timeouts0 + 1
        )
        # close() unparks a long watch immediately: an epoch teardown
        # never waits out watch windows.
        col.watch_timeout = 30.0
        done = threading.Event()
        parked = threading.Event()

        def watch():
            col.query_response(
                f"since={gen}&watch=30", etag, on_park=parked.set
            )
            done.set()

        threading.Thread(target=watch, daemon=True).start()
        assert parked.wait(5)
        col.close()
        assert done.wait(5)
    finally:
        if col is not None:
            col.close()
        mock.close()


def test_watch_admission_cap_answers_503_retry_after():
    mock = MockFleet(2)
    col = None
    try:
        col = _collector(mock, max_watchers=0)
        body, etag = col.inventory_response()
        gen = json.loads(body)["generation"]
        rejected0 = obs_metrics.FLEET_WATCH.value(outcome="rejected")
        status, rbody, retag, retry, _f = col.query_response(
            f"since={gen}&watch=5", etag
        )
        assert (status, retag, retry) == (503, None, 1)
        assert b"watch slots exhausted" in rbody
        assert (
            obs_metrics.FLEET_WATCH.value(outcome="rejected")
            == rejected0 + 1
        )
        # An out-of-sync watcher is answered immediately (its delta IS
        # the wake) — admission never runs, so no rejection.
        status, dbody, _e, _r, _f = col.query_response(
            f"since={gen}&watch=5", "\"stale\""
        )
        assert status == 200
        assert (
            obs_metrics.FLEET_WATCH.value(outcome="rejected")
            == rejected0 + 1
        )
    finally:
        if col is not None:
            col.close()
        mock.close()


def test_watch_reconnect_resumes_via_since_after_restart(tmp_path):
    """The watch client's failure mode: the collector dies mid-park
    (connection drops), the client reconnects with the same ?since
    against the restarted collector and pays AT MOST one full resync
    before riding deltas again — the delta-resync machinery, reached
    through the watch path."""
    mock = MockFleet(4)
    state_dir = side_dir(tmp_path / "state")
    col = col2 = server = server2 = None
    try:
        col = _collector(mock, state_dir=state_dir)
        server = _serve(col)
        status, body, etag = fleet_get(server.port, "degraded=false")
        since = json.loads(body)["generation"]
        mirror = DeltaMirror()
        mirror.apply(json.loads(body), etag)
        holder = {}
        dropped = threading.Event()

        def watch():
            try:
                holder["res"] = fleet_get(
                    server.port,
                    f"degraded=false&since={since}&watch=30",
                    etag=etag,
                )
            except Exception as e:  # noqa: BLE001 - the expected drop
                holder["err"] = e
            dropped.set()

        t = threading.Thread(target=watch, daemon=True)
        t.start()
        time.sleep(0.3)  # let the watcher park
        # The collector dies mid-park: server torn down, connections
        # severed — the client's watch errors out, it must reconnect.
        server.close()
        col.close()
        assert dropped.wait(10)
        t.join(timeout=5)
        # Restart from --state-dir: generation high-water restored.
        col2 = _collector(mock, state_dir=state_dir)
        server2 = _serve(col2)
        status, b2, e2 = fleet_get(
            server2.port, f"degraded=false&since={since}", etag=etag
        )
        resyncs = 0
        if status == 200:
            doc2 = json.loads(b2)
            if not doc2.get("delta"):
                resyncs += 1
                mirror.apply(doc2, e2)
            else:
                mirror.apply(doc2, e2)
            etag, since = e2, mirror.generation
        assert resyncs <= 1
        # Back on the lineage: movement now arrives as a delta.
        mock.churn(0.5, notify=False)
        col2.poll_round()
        status, b3, e3 = fleet_get(
            server2.port, f"degraded=false&since={since}", etag=etag
        )
        assert status == 200
        doc3 = json.loads(b3)
        assert doc3["delta"] is True
        rebuilt = mirror.apply(doc3, e3)
        assert rebuilt == json.loads(
            col2.query_response("degraded=false", None)[1]
        )
    finally:
        for server_ in (server, server2):
            if server_ is not None:
                server_.close()
        for col_ in (col, col2):
            if col_ is not None:
                col_.close()
        mock.close()


# ---------------------------------------------------------------------------
# HTTP surface: HEAD parity, watch-over-HTTP, the inflight guard
# ---------------------------------------------------------------------------

def test_head_parity_states_filtered_content_length():
    import http.client

    mock = MockFleet(5)
    col = server = None
    try:
        col = _collector(mock)
        server = _serve(col)
        full_body, _etag = col.inventory_response()
        _s, filtered_body, _e = fleet_get(server.port, "stale=false")
        assert len(filtered_body) != len(full_body)
        body, etag = col.inventory_response()
        gen = json.loads(body)["generation"]
        for port in (server.port, tfp.PORT_TWINS[server.port]):
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
            try:
                for query_string, want in (
                    ("", full_body),
                    ("?stale=false", filtered_body),
                ):
                    conn.request("HEAD", f"/fleet/snapshot{query_string}")
                    resp = conn.getresponse()
                    head_body = resp.read()
                    assert resp.status == 200
                    assert head_body == b""
                    assert int(resp.headers["Content-Length"]) == len(want)
                # HEAD never parks: a watch-shaped HEAD answers its headers
                # immediately even though a GET would park.
                start = time.monotonic()
                conn.request(
                    "HEAD",
                    f"/fleet/snapshot?since={gen}&watch=30",
                    headers={"If-None-Match": etag},
                )
                resp = conn.getresponse()
                resp.read()
                assert resp.status == 304
                assert time.monotonic() - start < 5
            finally:
                conn.close()
    finally:
        if server is not None:
            server.close()
        if col is not None:
            col.close()
        mock.close()


def test_inflight_cap_sheds_with_retry_after_watchers_exempt():
    import http.client

    from gpu_feature_discovery_tpu.utils import faults as twin_faults
    from gpu_feature_discovery_tpu_torch.utils import faults as port_faults

    _InflightGate = obs_server._InflightGate
    faults = tfp.Pair(twin_faults, port_faults)

    # The gate itself: limit 0 tracks but never sheds; at the cap it
    # rejects and counts.
    gate = _InflightGate(0)
    assert all(gate.enter() for _ in range(5))
    gate = _InflightGate(1)
    rejected0 = obs_metrics.HTTP_REJECTED.value()
    assert gate.enter()
    assert obs_metrics.HTTP_INFLIGHT.value() == 1
    assert not gate.enter()
    assert obs_metrics.HTTP_REJECTED.value() == rejected0 + 1
    gate.leave()
    assert obs_metrics.HTTP_INFLIGHT.value() == 0
    assert gate.enter()
    gate.leave()

    mock = MockFleet(2)
    col = server = None
    try:
        col = _collector(mock)
        # peer_snapshot wired too: the peer.slow fault site lives on
        # that branch, which is how this test pins a slot-HOLDING
        # request (a watcher releases its slot; a stalled handler
        # does not).
        server = _serve(
            col, max_inflight=1, peer_snapshot=col.inventory_response
        )
        # A parked watcher RELEASES its inflight slot: with the cap at
        # 1 and a watcher parked, a plain GET still answers 200.
        body, etag = col.inventory_response()
        gen = json.loads(body)["generation"]
        holder = {}

        def watch():
            holder["res"] = fleet_get(
                server.port, f"since={gen}&watch=5", etag=etag
            )

        t = threading.Thread(target=watch, daemon=True)
        t.start()
        time.sleep(0.3)
        status, _b, _e = fleet_get(server.port)
        assert status == 200
        mock.churn(0.5, notify=False)
        col.poll_round()
        t.join(timeout=10)
        assert holder["res"][0] == 200
        # A request that genuinely HOLDS its slot (a fault-stalled peer
        # poll) sheds the next request: 503 + Retry-After, counted.
        rejected0 = obs_metrics.HTTP_REJECTED.value()
        faults.load_fault_spec("peer.slow:fail:1")
        try:
            def slow_peer_get(port):
                conn = http.client.HTTPConnection(
                    "127.0.0.1", port, timeout=10
                )
                try:
                    conn.request("GET", "/peer/snapshot")
                    conn.getresponse().read()
                except Exception:  # noqa: BLE001 - stall is the point
                    pass
                finally:
                    conn.close()

            for port in (server.port, tfp.PORT_TWINS[server.port]):
                slow = threading.Thread(target=slow_peer_get, args=(port,), daemon=True)
                slow.start()
                time.sleep(0.3)
                conn = http.client.HTTPConnection(
                    "127.0.0.1", port, timeout=5
                )
                try:
                    conn.request("GET", "/healthz")
                    resp = conn.getresponse()
                    resp.read()
                    assert resp.status == 503
                    assert resp.headers["Retry-After"] == "1"
                finally:
                    conn.close()
                slow.join(timeout=10)
            assert obs_metrics.HTTP_REJECTED.value() == rejected0 + 1
        finally:
            faults.reset()
    finally:
        if server is not None:
            server.close()
        if col is not None:
            col.close()
        mock.close()
