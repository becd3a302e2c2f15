"""Fleet scale of the PyTorch port against its JAX twin, on the CPU: a
real federated root over real region collectors over 1,000 mock slice
leaders, built once from the twin's classes and once from the port's
over the SAME mock leaders (the twin rig tests/fleet_scale.py, unedited:
its MockFleet serves both, and its FleetTiers is built a second time
from the port's classes).

Every scenario of the twin's tests/test_fleet_scale.py runs here with
both stacks in lockstep (tests/torch_fleet_pair.py): each round runs the
twin's stack and then the port's against the same mock state, and the
root's changed keys, every tier's inventory body, the mock tier's
request, 304 and byte counts of the round, the consumer pools' stats
and every wire-counter delta must be equal. The 10,000-slice tier stays
``slow``, as the twin's does. Nothing compared is a float but the byte
ratio, computed from equal integers on both sides.
"""

import importlib.util
import json
from pathlib import Path

import pytest

import fleet_scale as twin_rig
import torch_fleet_pair as tfp
from fleet_scale import MockFleet, consumer_filters
from torch_fleet_pair import obs_metrics

FROZEN_WALL = 1_700_000_000.0


def _port_rig():
    """The rig's module built a second time, its tiers from the port's
    classes: the source file stays as the twin's tests use it."""
    from gpu_feature_discovery_tpu_torch.fleet import SliceTarget
    from gpu_feature_discovery_tpu_torch.fleet.collector import FleetCollector
    from gpu_feature_discovery_tpu_torch.obs import metrics
    from gpu_feature_discovery_tpu_torch.obs.server import (
        IntrospectionServer,
        IntrospectionState,
    )

    spec = importlib.util.spec_from_file_location(
        "fleet_scale_port", Path(__file__).with_name("fleet_scale.py")
    )
    rig = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(rig)
    rig.SliceTarget = SliceTarget
    rig.FleetCollector = FleetCollector
    rig.obs_metrics = metrics
    rig.IntrospectionServer = IntrospectionServer
    rig.IntrospectionState = IntrospectionState
    return rig


port_rig = _port_rig()


class _PortTargets:
    """The mock's targets as the port's SliceTargets."""

    def __init__(self, mock):
        self._mock = mock

    def targets(self):
        return [port_rig.SliceTarget(name=t.name, hosts=t.hosts)
                for t in self._mock.targets()]


def _tiers(mock, **kwargs):
    """The twin's and the port's stack over ``mock``, as a Pair whose
    servers' ports map onto each other."""
    twin = twin_rig.FleetTiers(mock, **kwargs)
    try:
        port = port_rig.FleetTiers(_PortTargets(mock), **kwargs)
    except BaseException:
        twin.close()
        raise
    for attr in ("root_query_server", "root_server"):
        if getattr(twin, attr) is not None:
            tfp.PORT_TWINS[getattr(twin, attr).port] = getattr(port, attr).port
    for t, p in zip(twin.region_servers, port.region_servers):
        tfp.PORT_TWINS[t.port] = p.port
    return tfp.Pair(twin, port)


def _round(tiers, mock):
    """One full round of each stack from the same mock state: the mock
    tier's stats move as one stack's round moved them, and both stacks'
    moves must be equal."""
    before = dict(mock.stats)
    changed_twin = tiers.twin.round()
    after_twin = dict(mock.stats)
    mock.stats.update(before)
    changed_port = tiers._sides[1].round()
    assert dict(mock.stats) == after_twin, (after_twin, mock.stats)
    changed = tfp.join(changed_twin, changed_port, "round")
    # Every tier's body and ETag, byte for byte.
    tiers.root.inventory_response()
    for region in tiers.regions:
        region.inventory_response()
    return changed


def _wire():
    """The root<-region hop's byte/poll counters (cumulative registry
    families — tests measure diffs)."""
    return {
        "delta_bytes": obs_metrics.FLEET_POLL_BODY_BYTES.value(kind="delta"),
        "full_bytes": obs_metrics.FLEET_POLL_BODY_BYTES.value(kind="full"),
        "delta_polls": obs_metrics.FLEET_DELTA_POLLS.value(kind="delta"),
        "full_polls": obs_metrics.FLEET_DELTA_POLLS.value(kind="full"),
        "not_modified": obs_metrics.FLEET_SNAPSHOT_NOT_MODIFIED.value(),
    }


def _diff(before):
    after = _wire()
    return {k: after[k] - before[k] for k in before}


def test_thousand_slice_fleet_delta_rounds():
    mock = MockFleet(1000)
    tiers = None
    try:
        tiers = _tiers(mock, n_regions=4, wall_clock=lambda: FROZEN_WALL)
        # Warm round: full bodies everywhere (first contact at every
        # tier), and the root's pane covers the whole fleet.
        _round(tiers, mock)
        pane = tiers.root.inventory_payload()
        assert len(pane["slices"]) == 1000
        assert all(
            e["reachable"] and e["healthy_hosts"] == 2
            for e in pane["slices"].values()
        )
        # Idle round: >= 90% 304s at the slice tier AND pure deltas
        # rendered as 304s at the root tier.
        mock.stats.update(requests=0, not_modified=0, full=0, bytes=0)
        before = _wire()
        changed = _round(tiers, mock)
        moved = _diff(before)
        assert changed == set()
        assert mock.stats["requests"] >= 1000
        assert mock.stats["not_modified"] / mock.stats["requests"] >= 0.9
        assert moved["not_modified"] >= 4  # one 304 per region
        assert moved["delta_bytes"] == moved["full_bytes"] == 0
        # 1% churn: the root<-region hop moves O(changed) bytes.
        changed_names = mock.churn(0.01)
        assert len(changed_names) == 10
        before = _wire()
        changed = _round(tiers, mock)
        moved = _diff(before)
        by_name = {}
        for i, region in enumerate(tiers.regions):
            for name in region.inventory_payload()["slices"]:
                by_name[name] = f"region/region-{i}/{name}"
        assert changed == {by_name[n] for n in changed_names}
        assert moved["delta_polls"] == 4 and moved["full_polls"] == 0
        full_cost = sum(len(r.inventory_response()[0]) for r in tiers.regions)
        ratio = moved["delta_bytes"] / full_cost
        assert 0 < ratio <= 0.05, (moved, full_cost)
        # Byte-identity under churn: a from-scratch root (full-body
        # first contact) over the same regions holds the exact pane the
        # delta-built root reconstructed.
        fresh_root = tfp.fleet.FleetCollector(
            [
                tfp.fleet.SliceTarget(
                    name=f"region-{i}", hosts=(f"127.0.0.1:{s.port}",)
                )
                for i, s in enumerate(tiers.region_servers)
            ],
            peer_timeout=5.0,
            upstream_mode="collectors",
            wall_clock=lambda: FROZEN_WALL,
        )
        try:
            fresh_root.poll_round()
            assert (
                fresh_root.inventory_payload()["slices"]
                == tiers.root.inventory_payload()["slices"]
            )
        finally:
            fresh_root.close()
        # Dark slices: confirmed over the 2-miss rule, the flip arrives
        # at the root as deltas (stale entries, never dropped ones).
        dark = changed_names[:5]
        mock.set_dark(dark)
        _round(tiers, mock)
        changed = _round(tiers, mock)  # miss 2 confirms -> entries go stale
        pane = tiers.root.inventory_payload()["slices"]
        for name in dark:
            assert by_name[name] in changed
            assert pane[by_name[name]]["stale"] is True
            assert pane[by_name[name]]["healthy_hosts"] is not None
    finally:
        if tiers is not None:
            tiers.close()
        mock.close()


def _serving():
    """The consumer-facing serving counters (cumulative — diff them)."""
    return {
        "renders": obs_metrics.FLEET_FILTER_RENDERS.value(),
        "cache_hit": obs_metrics.FLEET_FILTER_CACHE.value(outcome="hit"),
        "cache_miss": obs_metrics.FLEET_FILTER_CACHE.value(outcome="miss"),
        "cache_evict": obs_metrics.FLEET_FILTER_CACHE.value(outcome="evict"),
        "filtered_304": obs_metrics.FLEET_FILTERED_NOT_MODIFIED.value(),
    }


def _serving_diff(before):
    after = _serving()
    return {k: after[k] - before[k] for k in before}


def test_consumer_load_filtered_views_steady_state():
    """200 keep-alive consumers over 20 distinct filters against a
    1,000-slice root, on each stack: after warm-up an idle steady state
    is >= 90% 304s with ZERO serializations, and a churn round
    serializes at most once per distinct filter."""
    filters = consumer_filters(4)
    assert len(filters) == 20
    mock = MockFleet(1000)
    tiers = pool = None
    try:
        tiers = _tiers(mock, n_regions=4, wall_clock=lambda: FROZEN_WALL,
                       serve_root=True)
        _round(tiers, mock)
        port = tiers.root_query_server.port
        pool = tfp.Pair(twin_rig.ConsumerPool(port, 200, filters),
                        twin_rig.ConsumerPool(tfp.PORT_TWINS[port], 200, filters))
        # Warm-up: 200 requests cost at most ONE render per distinct
        # filter.
        before = _serving()
        pool.poll_all()
        warm = _serving_diff(before)
        assert pool.stats["errors"] == 0
        assert pool.stats["full"] == 200
        assert warm["renders"] == len(filters)
        assert warm["cache_miss"] == len(filters)
        assert warm["cache_evict"] == 0
        # Idle steady state: every poll a 304, zero new serializations.
        _round(tiers, mock)
        pool.reset()
        before = _serving()
        pool.poll_all()
        pool.poll_all()
        idle = _serving_diff(before)
        assert pool.stats["errors"] == 0
        ratio = pool.stats["not_modified"] / pool.stats["requests"]
        assert ratio >= 0.9, pool.stats
        assert idle["renders"] == 0, idle
        assert idle["filtered_304"] == pool.stats["not_modified"]
        hits = idle["cache_hit"] / (idle["cache_hit"] + idle["cache_miss"])
        assert hits >= 0.9, idle
        # Churn: renders are bounded by filters, never by consumers.
        mock.churn(0.02)
        changed = _round(tiers, mock)
        assert changed
        pool.reset()
        before = _serving()
        pool.poll_all()
        churned = _serving_diff(before)
        assert pool.stats["errors"] == 0
        assert churned["renders"] <= len(filters), churned
        assert pool.stats["full"] + pool.stats["not_modified"] == 200
        # The filtered documents are honest: a degraded=true consumer's
        # pane carries only degraded entries, stamped with the filter.
        status, body, _etag = tfp.paired_fleet_get(twin_rig.fleet_get)(
            port, "degraded=true")
        assert status == 200
        doc = json.loads(body)
        assert doc["filter"] == "degraded=true"
        assert doc["slices"]
        assert all(e["degraded"] for e in doc["slices"].values())
        full_doc = tiers.root.inventory_payload()
        assert set(doc["slices"]) == {
            k for k, e in full_doc["slices"].items() if e["degraded"]
        }
    finally:
        if pool is not None:
            pool.close()
        if tiers is not None:
            tiers.close()
        mock.close()


def test_push_mode_idle_rounds_poll_only_changed_plus_sweep():
    """With push-on-delta and a long sweep cadence, idle/low-churn rounds
    cost O(changed) requests instead of O(children) — >= 90% fewer
    mock-tier polls at 1% churn, on each stack."""
    mock = MockFleet(400, peer_token="fleet-secret")
    tiers = None
    try:
        tiers = _tiers(
            mock,
            n_regions=4,
            wall_clock=lambda: FROZEN_WALL,
            peer_token="fleet-secret",
            push_notify=True,
            sweep_interval=3600.0,
        )
        # Cold start sweeps everything and plants the subscriptions via
        # poll headers: each peer has one subscriber per stack.
        _round(tiers, mock)
        assert len(tiers.root.inventory_payload()["slices"]) == 400
        assert all(len(p.subs) == 2 for p in mock.peers.values())
        # Pure idle push round: no notifications, so no mock polls.
        mock.stats.update(requests=0, not_modified=0, full=0, bytes=0)
        changed = _round(tiers, mock)
        assert changed == set()
        assert mock.stats["requests"] == 0
        # 1% churn: each changed peer notifies its region on both
        # stacks, each region polls exactly its dirty children and
        # nudges its root.
        changed_names = mock.churn(0.01)
        assert len(changed_names) == 4
        assert mock.stats["notifies"] == 2 * 4
        mock.stats.update(requests=0, not_modified=0, full=0, bytes=0)
        changed = _round(tiers, mock)
        by_name = {}
        for i, region in enumerate(tiers.regions):
            for name in region.inventory_payload()["slices"]:
                by_name[name] = f"region/region-{i}/{name}"
        assert changed == {by_name[n] for n in changed_names}
        # The economy: pull mode would have cost 400 requests a round.
        assert mock.stats["requests"] <= len(changed_names)
        assert mock.stats["requests"] <= 0.1 * 400
        pane = tiers.root.inventory_payload()["slices"]
        for name in changed_names:
            assert pane[by_name[name]]["healthy_hosts"] == 1
    finally:
        if tiers is not None:
            tiers.close()
        mock.close()


def test_push_off_is_byte_identical_to_pull():
    """--push-notify=off pins the pull economy on each stack: no
    subscribe headers on the wire, no notify POSTs, every child polled
    every round."""
    mock = MockFleet(60)
    tiers = None
    try:
        tiers = _tiers(mock, n_regions=2, wall_clock=lambda: FROZEN_WALL)
        _round(tiers, mock)
        assert all(not p.subs for p in mock.peers.values())
        mock.stats.update(requests=0, not_modified=0, full=0, bytes=0)
        _round(tiers, mock)
        assert mock.stats["requests"] == 60
        assert mock.stats["notifies"] == 0
        changed_names = mock.churn(0.05)
        mock.stats.update(requests=0, not_modified=0, full=0, bytes=0)
        changed = _round(tiers, mock)
        assert len(changed) == len(changed_names)
        assert mock.stats["requests"] == 60
        assert mock.stats["notifies"] == 0
        # And no push machinery was even constructed.
        assert tiers.root.notify_sender is None
        assert all(r.notify_subscriptions is None for r in tiers.regions)
    finally:
        if tiers is not None:
            tiers.close()
        mock.close()


@pytest.mark.slow
def test_ten_thousand_slice_fleet_connection_close_tier():
    """The opt-in 10k tier on each stack: Connection: close at the mock
    tier, 10 regions, full coverage and the same O(changed) wire
    claim."""
    import os
    import resource

    mock = MockFleet(10_000, keepalive=False)
    tiers = None
    try:
        tiers = _tiers(mock, n_regions=10, wall_clock=lambda: FROZEN_WALL)
        _round(tiers, mock)
        assert len(tiers.root.inventory_payload()["slices"]) == 10_000
        mock.stats.update(requests=0, not_modified=0, full=0, bytes=0)
        _round(tiers, mock)
        assert mock.stats["not_modified"] / mock.stats["requests"] >= 0.9
        changed_names = mock.churn(0.01)
        before = _wire()
        changed = _round(tiers, mock)
        moved = _diff(before)
        assert len(changed) == len(changed_names) == 100
        full_cost = sum(len(r.inventory_response()[0]) for r in tiers.regions)
        assert moved["delta_bytes"] / full_cost <= 0.05
        soft, _hard = resource.getrlimit(resource.RLIMIT_NOFILE)
        open_fds = len(os.listdir("/proc/self/fd"))
        assert open_fds < soft * 0.5, (open_fds, soft)
    finally:
        if tiers is not None:
            tiers.close()
        mock.close()
