"""The fleet collector of the PyTorch port (fleet/, cmd/fleet.py, the
/fleet/snapshot route of obs/server.py) against its JAX twin, on the CPU.

Every scenario of the twin's tests/test_fleet.py runs here through BOTH
collectors: the same targets file, the same scripted ``/peer/snapshot``
peers (the twin's coordinators and servers, or the twin's in-process
slice daemons) and the same clocks feed a twin and a port collector in
lockstep (tests/torch_fleet_pair.py). Every inventory, delta and
filtered body, ETag, status code and counter delta a scenario touches
must be equal byte for byte, and must satisfy the twin test's own
assertions. Nothing compared is a float, so no tolerance is needed. The
scenarios about the peer surface alone (the slice section, the token
matrix) run through both packages' peering layers, each under its own
label keys.
"""

import json
import os
import subprocess
import sys
import time
import types
from pathlib import Path

import pytest
import yaml

import torch_fleet_pair as tfp
from gpu_feature_discovery_tpu.config.spec import ConfigError
from gpu_feature_discovery_tpu.obs import metrics as twin_metrics
from gpu_feature_discovery_tpu.obs import server as twin_obs_server
from gpu_feature_discovery_tpu.peering import SliceCoordinator
from gpu_feature_discovery_tpu.peering import coordinator as twin_coordinator
from gpu_feature_discovery_tpu.peering import snapshot as twin_snapshot
from gpu_feature_discovery_tpu_torch.obs import metrics as port_metrics
from gpu_feature_discovery_tpu_torch.obs import server as port_obs_server
from gpu_feature_discovery_tpu_torch.peering import coordinator as port_coordinator
from gpu_feature_discovery_tpu_torch.peering import snapshot as port_snapshot
from torch_fleet_pair import (
    IntrospectionServer,
    IntrospectionState,
    collector,
    fleet,
    ha,
    http_get,
    inventory,
    obs_metrics,
    side_dir,
)
from gpu_feature_discovery_tpu.peering.snapshot import (
    PEER_SCHEMA_VERSION,
    parse_snapshot,
)
from torch_env_guard import resolved_cache_dir_restored  # noqa: F401 - autouse

FLEET_SCHEMA_VERSION = fleet.FLEET_SCHEMA_VERSION
FleetCollector = fleet.FleetCollector
InventoryStore = fleet.InventoryStore
parse_inventory = fleet.parse_inventory
parse_targets_file = fleet.parse_targets_file

REPO = Path(__file__).resolve().parent.parent

# Each package's peer layer, under its own label keys: the scenarios of
# the peer surface alone run once per side.
PEER_SIDES = (
    types.SimpleNamespace(
        name="twin", prefix="google.com/tpu.", snapshot=twin_snapshot,
        Coordinator=twin_coordinator.SliceCoordinator, metrics=twin_metrics,
        server=twin_obs_server,
    ),
    types.SimpleNamespace(
        name="port", prefix="nvidia.com/gpu.", snapshot=port_snapshot,
        Coordinator=port_coordinator.SliceCoordinator, metrics=port_metrics,
        server=port_obs_server,
    ),
)


# Each package's collector binary, for the scenarios that run it on a
# thread with its own signal queue: once per side.
CMD_SIDES = (
    types.SimpleNamespace(
        name="twin", cmd_fleet=tfp.twin_cmd_fleet, metrics=twin_metrics,
        parse_targets_file=tfp.twin_targets.parse_targets_file,
        cmd_main="gpu_feature_discovery_tpu.cmd.main",
    ),
    types.SimpleNamespace(
        name="port", cmd_fleet=tfp.port_cmd_fleet, metrics=port_metrics,
        parse_targets_file=tfp.port_targets.parse_targets_file,
        cmd_main="gpu_feature_discovery_tpu_torch.cmd.main",
    ),
)


def _keyed(labels, prefix):
    return {k.replace("google.com/tpu.", prefix, 1): v for k, v in labels.items()}


HERE = os.path.dirname(os.path.abspath(__file__))
DOCS = os.path.join(os.path.dirname(HERE), "docs")

LEADER_LABELS = {
    "google.com/tpu.count": "4",
    "google.com/tpu.chips.healthy": "4",
    "google.com/tpu.chips.sick": "0",
    "google.com/tpu.slice.role": "leader",
    "google.com/tpu.slice.leader": "h0",
    "google.com/tpu.slice.healthy-hosts": "2",
    "google.com/tpu.slice.total-hosts": "2",
    "google.com/tpu.slice.degraded": "false",
    "google.com/tpu.slice.sick-chips": "0",
}


def write_targets(tmp_path, slices):
    path = os.path.join(str(tmp_path), "targets.yaml")
    with open(path, "w") as f:
        yaml.safe_dump({"version": "v1", "slices": slices}, f)
    return path


# ---------------------------------------------------------------------------
# targets grammar
# ---------------------------------------------------------------------------

def test_targets_parse_roundtrip(tmp_path):
    path = write_targets(
        tmp_path,
        [
            {"name": "a", "hosts": ["h0:9101", "h1:9101", "h2:9101", "h3"]},
            {"name": "b", "hosts": ["10.0.1.1"]},
        ],
    )
    targets = parse_targets_file(path)
    assert [t.name for t in targets] == ["a", "b"]
    # Only the 3-deep leadership chain is polled (the cohort tier's
    # chain depth).
    assert targets[0].chain == ("h0:9101", "h1:9101", "h2:9101")
    assert targets[1].chain == ("10.0.1.1",)


@pytest.mark.parametrize(
    "doc",
    [
        {"version": "v2", "slices": []},
        {"slices": "not-a-list"},
        {"slices": [{"hosts": ["h0"]}]},              # no name
        {"slices": [{"name": "a"}]},                  # no hosts
        {"slices": [{"name": "a", "hosts": []}]},     # empty hosts
        {"slices": [{"name": "a", "hosts": [1]}]},    # non-string host
        {
            "slices": [
                {"name": "a", "hosts": ["h0"]},
                {"name": "a", "hosts": ["h1"]},       # duplicate name
            ]
        },
    ],
)
def test_targets_rejects_malformed(tmp_path, doc):
    path = os.path.join(str(tmp_path), "bad.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(doc, f)
    with pytest.raises(ConfigError):
        parse_targets_file(path)


def test_targets_missing_file_is_config_error(tmp_path):
    with pytest.raises(ConfigError):
        parse_targets_file(os.path.join(str(tmp_path), "absent.yaml"))


# ---------------------------------------------------------------------------
# the slice section on /peer/snapshot (the collector's read surface)
# ---------------------------------------------------------------------------

def test_slice_section_present_exactly_on_leader_labels():
    for S in PEER_SIDES:
        leader = _keyed(LEADER_LABELS, S.prefix)
        section = S.snapshot.build_slice_section(leader)
        assert section == {
            "schema": S.snapshot.SLICE_SECTION_SCHEMA_VERSION,
            "leader": "h0",
            "healthy_hosts": 2,
            "total_hosts": 2,
            "degraded": False,
            "sick_chips": 0,
        }, S.name
        follower = dict(leader)
        follower[S.prefix + "slice.role"] = "follower"
        assert S.snapshot.build_slice_section(follower) is None
        assert S.snapshot.build_slice_section({S.prefix + "count": "4"}) is None
    assert (port_snapshot.SLICE_SECTION_SCHEMA_VERSION
            == twin_snapshot.SLICE_SECTION_SCHEMA_VERSION)


def _coordinator(S, peer_token=""):
    return S.Coordinator(0, ["h0:1", "h1:1"], default_port=1, peer_timeout=0.5,
                         peer_token=peer_token)


def test_non_leader_snapshot_bytes_unchanged_by_slice_section():
    """A follower/off daemon's published document must stay byte-
    identical to the pre-section wire: the section key is ABSENT, not
    null."""
    bodies = []
    for S in PEER_SIDES:
        coord = _coordinator(S)
        coord.publish_local({S.prefix + "count": "4"}, "full")
        body, _ = coord.snapshot_response()
        assert b'"slice"' not in body
        doc = S.snapshot.parse_snapshot(body)
        assert "slice" not in doc
        coord.close()
        bodies.append(body.replace(S.prefix.encode(), b"<prefix>"))
    assert bodies[0] == bodies[1]


def test_leader_snapshot_carries_and_roundtrips_slice_section():
    docs = []
    for S in PEER_SIDES:
        coord = _coordinator(S)
        coord.publish_local(_keyed(LEADER_LABELS, S.prefix), "full")
        body, _ = coord.snapshot_response()
        doc = S.snapshot.parse_snapshot(body)
        assert doc["slice"]["healthy_hosts"] == 2
        # The slice.* labels themselves stay stripped from the label map.
        assert not any(k.startswith(S.prefix + "slice.") for k in doc["labels"])
        coord.close()
        docs.append(doc["slice"])
    assert docs[0] == docs[1]


def test_unknown_slice_section_schema_is_rejected():
    """Forward-rejecting, the cohort section's exact discipline: the
    collector can never silently parse a section shape it does not
    understand."""
    for S in PEER_SIDES:
        leader = _keyed(LEADER_LABELS, S.prefix)
        doc = S.snapshot.build_snapshot(0, "w0", leader, 1, "full")
        doc["slice"] = dict(S.snapshot.build_slice_section(leader))
        doc["slice"]["schema"] = S.snapshot.SLICE_SECTION_SCHEMA_VERSION + 1
        body, _ = S.snapshot.serialize_snapshot(doc)
        with pytest.raises(S.snapshot.PeerSnapshotError):
            S.snapshot.parse_snapshot(body)


# ---------------------------------------------------------------------------
# shared schema constant: bidirectional drift guards
# ---------------------------------------------------------------------------

def test_collector_speaks_exactly_the_peer_schema():
    """ONE constant end to end: the serving side renders it, the
    collector's parser enforces it (fleet imports the peering parser —
    no second copy to drift), and the inventory states it on the wire."""
    # The collector parses through THE peering parser of its own
    # package, not a copy.
    assert collector.twin.parse_snapshot is twin_snapshot.parse_snapshot
    assert tfp.port_collector.parse_snapshot is port_snapshot.parse_snapshot
    # The inventory document states the constant it was built against.
    doc = inventory.build_inventory({}, 0, False)
    assert doc["peer_schema"] == PEER_SCHEMA_VERSION == port_snapshot.PEER_SCHEMA_VERSION
    # Forward direction: a snapshot one version ahead is rejected.
    for S in PEER_SIDES:
        good = S.snapshot.build_snapshot(0, "w0", {S.prefix + "count": "4"}, 1, "full")
        good["schema"] = PEER_SCHEMA_VERSION + 1
        body, _ = S.snapshot.serialize_snapshot(good)
        with pytest.raises(S.snapshot.PeerSnapshotError):
            S.snapshot.parse_snapshot(body)


def test_docs_state_the_current_schema_versions():
    """The docs consume the same constants: a schema bump that forgets
    the references fails here, in both directions (the doc can neither
    lag nor name a phantom version). The port speaks the twin's wire, so
    the twin's docs state the port's versions too."""
    with open(os.path.join(DOCS, "observability.md")) as f:
        obs_doc = f.read()
    assert f"schema `{PEER_SCHEMA_VERSION}`" in obs_doc
    with open(os.path.join(DOCS, "configuration.md")) as f:
        conf_doc = f.read()
    assert f"(schema `{FLEET_SCHEMA_VERSION}`)" in conf_doc
    with open(REPO / "README.md") as f:
        readme = f.read()
    assert f"fleet inventory schema `{FLEET_SCHEMA_VERSION}`" in readme


# ---------------------------------------------------------------------------
# token-auth matrix on /peer/snapshot
# ---------------------------------------------------------------------------

def _serve_coordinator(peer_token=""):
    """A scripted slice leader (the twin's), the peer both collectors
    poll."""
    coord = SliceCoordinator(
        0,
        ["h0:1", "h1:1"],
        default_port=1,
        peer_timeout=0.5,
        peer_token=peer_token,
    )
    coord.publish_local(LEADER_LABELS, "full")
    server = IntrospectionServer(
        obs_metrics.REGISTRY,
        IntrospectionState(60.0),
        addr="127.0.0.1",
        port=0,
        peer_snapshot=coord.snapshot_response,
        peer_token=peer_token,
    )
    server.start()
    return coord, server


def _serve_side_coordinator(S, peer_token=""):
    coord = _coordinator(S, peer_token)
    coord.publish_local(_keyed(LEADER_LABELS, S.prefix), "full")
    server = S.server.IntrospectionServer(
        S.metrics.REGISTRY, S.server.IntrospectionState(60.0), addr="127.0.0.1",
        port=0, peer_snapshot=coord.snapshot_response, peer_token=peer_token,
    )
    server.start()
    return coord, server


def test_peer_snapshot_open_without_token_byte_identical():
    """Unset token = open, and the served bytes are EXACTLY the
    publish-time cache — auth being wired in must not perturb the
    back-compat wire."""
    for S in PEER_SIDES:
        coord, server = _serve_side_coordinator(S, peer_token="")
        try:
            status, body = http_get(
                f"http://127.0.0.1:{server.port}/peer/snapshot"
            )
            assert status == 200
            assert body == coord.snapshot_response()[0]
        finally:
            server.close()
            coord.close()


def test_peer_snapshot_token_matrix():
    for S in PEER_SIDES:
        coord, server = _serve_side_coordinator(S, peer_token="fleet-secret")
        base = f"http://127.0.0.1:{server.port}/peer/snapshot"
        try:
            assert http_get(base)[0] == 403                      # missing
            assert http_get(
                base, {"X-TFD-Probe-Token": "wrong"}
            )[0] == 401                                          # mismatch
            status, body = http_get(
                base, {"X-TFD-Probe-Token": "fleet-secret"}
            )
            assert status == 200
            assert S.snapshot.parse_snapshot(body)["worker_id"] == 0
            status, _ = http_get(
                base, {"Authorization": "Bearer fleet-secret"}
            )
            assert status == 200                                 # bearer form
        finally:
            server.close()
            coord.close()


def test_tokened_leader_poll_round_succeeds():
    """The slice leader's own poller sends the token: two coordinators
    sharing a secret keep coordinating while the surface is locked."""
    for S in PEER_SIDES:
        serving, server = _serve_side_coordinator(S, peer_token="fleet-secret")
        poller = S.Coordinator(
            1,
            [f"127.0.0.1:{server.port}", "h1:1"],
            default_port=1,
            peer_timeout=0.5,
            peer_token="fleet-secret",
        )
        try:
            poller.poll_once()
            assert not poller._peer_state[0].confirmed_down
            # And WITHOUT the token the same poll is a miss (the 403 is
            # an error outcome, never silently trusted).
            anon = S.Coordinator(
                1,
                [f"127.0.0.1:{server.port}", "h1:1"],
                default_port=1,
                peer_timeout=0.5,
            )
            anon.poll_once()
            assert anon._peer_state[0].confirmed_down
            anon.close()
        finally:
            poller.close()
            server.close()
            serving.close()


# ---------------------------------------------------------------------------
# collector unit behavior
# ---------------------------------------------------------------------------

def _targets(tmp_path, hosts_by_name):
    path = write_targets(
        tmp_path,
        [{"name": n, "hosts": list(h)} for n, h in hosts_by_name.items()],
    )
    return parse_targets_file(path)


def test_collector_idle_rounds_are_304_header_exchanges(tmp_path):
    coord, server = _serve_coordinator()
    targets = _targets(tmp_path, {"s0": [f"127.0.0.1:{server.port}"]})
    collector = FleetCollector(targets, peer_timeout=0.5)
    try:
        collector.poll_round()
        doc = collector.inventory_payload()
        assert doc["slices"]["s0"]["reachable"] is True
        assert doc["slices"]["s0"]["healthy_hosts"] == 2
        body1, etag1 = collector.inventory_response()
        before = obs_metrics.FLEET_SNAPSHOT_NOT_MODIFIED.value()
        collector.poll_round()
        assert obs_metrics.FLEET_SNAPSHOT_NOT_MODIFIED.value() == before + 1
        body2, etag2 = collector.inventory_response()
        # An idle fleet keeps the inventory body AND ETag frozen — the
        # 304 economy holds at the fleet tier too.
        assert (body1, etag1) == (body2, etag2)
        assert parse_inventory(body1)["schema"] == FLEET_SCHEMA_VERSION
    finally:
        collector.close()
        server.close()
        coord.close()


def test_collector_chain_failover_finds_promoted_leader(tmp_path):
    """Chain walk: the first chain member answering WITHOUT a slice
    section is kept as reachability evidence while the walk continues to
    the member that carries the verdict — the promoted next-in-chain."""
    follower = SliceCoordinator(
        0, ["h0:1", "h1:1"], default_port=1, peer_timeout=0.5
    )
    follower.publish_local({"google.com/tpu.count": "4"}, "full")
    fserver = IntrospectionServer(
        obs_metrics.REGISTRY,
        IntrospectionState(60.0),
        addr="127.0.0.1",
        port=0,
        peer_snapshot=follower.snapshot_response,
    )
    fserver.start()
    leader_labels = dict(LEADER_LABELS)
    leader_labels["google.com/tpu.slice.healthy-hosts"] = "1"
    leader_labels["google.com/tpu.slice.degraded"] = "true"
    leader = SliceCoordinator(
        1, ["h0:1", "h1:1"], default_port=1, peer_timeout=0.5
    )
    leader.publish_local(leader_labels, "full")
    lserver = IntrospectionServer(
        obs_metrics.REGISTRY,
        IntrospectionState(60.0),
        addr="127.0.0.1",
        port=0,
        peer_snapshot=leader.snapshot_response,
    )
    lserver.start()
    targets = _targets(
        tmp_path,
        {"s0": [f"127.0.0.1:{fserver.port}", f"127.0.0.1:{lserver.port}"]},
    )
    collector = FleetCollector(targets, peer_timeout=0.5)
    try:
        collector.poll_round()
        entry = collector.inventory_payload()["slices"]["s0"]
        assert entry["reachable"] is True
        assert entry["healthy_hosts"] == 1
        assert entry["degraded"] is True
    finally:
        collector.close()
        fserver.close()
        lserver.close()
        follower.close()
        leader.close()


def test_transient_leader_miss_keeps_last_known_verdict(tmp_path):
    """One missed leader poll with a follower still answering must NOT
    null the slice's verdict fields: a single blip cannot destroy data
    even a fully dark slice keeps (the degraded-stale rule)."""
    leader, lserver = _serve_coordinator()
    follower = SliceCoordinator(
        1, ["h0:1", "h1:1"], default_port=1, peer_timeout=0.5
    )
    follower.publish_local({"google.com/tpu.count": "4"}, "full")
    fserver = IntrospectionServer(
        obs_metrics.REGISTRY,
        IntrospectionState(60.0),
        addr="127.0.0.1",
        port=0,
        peer_snapshot=follower.snapshot_response,
    )
    fserver.start()
    targets = _targets(
        tmp_path,
        {"s0": [f"127.0.0.1:{lserver.port}", f"127.0.0.1:{fserver.port}"]},
    )
    collector = FleetCollector(targets, peer_timeout=0.5)
    try:
        collector.poll_round()
        assert collector.inventory_payload()["slices"]["s0"][
            "healthy_hosts"
        ] == 2
        # The leader goes dark for ONE round; the sectionless follower
        # answers. The verdict must survive the blip.
        lserver.close()
        collector.poll_round()
        entry = collector.inventory_payload()["slices"]["s0"]
        assert entry["reachable"] is True, entry
        assert entry["healthy_hosts"] == 2, entry
        assert entry["total_hosts"] == 2, entry
        assert entry["degraded"] is False, entry
    finally:
        collector.close()
        fserver.close()
        leader.close()
        follower.close()


def test_fleet_snapshot_304_counts_its_own_series():
    """An inbound /fleet/snapshot 304 increments the collector's OWN
    counter, never the peer-surface series a collector does not serve."""
    coord, server = _serve_coordinator()
    targets = []
    collector = FleetCollector(targets, peer_timeout=0.5)
    fleet_server = IntrospectionServer(
        obs_metrics.REGISTRY,
        IntrospectionState(60.0),
        addr="127.0.0.1",
        port=0,
        fleet_snapshot=collector.inventory_response,
    )
    fleet_server.start()
    try:
        url = f"http://127.0.0.1:{fleet_server.port}/fleet/snapshot"
        status, body = http_get(url)
        assert status == 200
        _, etag = collector.inventory_response()
        peer_before = obs_metrics.PEER_SNAPSHOT_NOT_MODIFIED.value()
        fleet_before = obs_metrics.FLEET_INVENTORY_NOT_MODIFIED.value()
        status, body = http_get(url, {"If-None-Match": etag})
        assert status == 304 and body == b""
        assert (
            obs_metrics.FLEET_INVENTORY_NOT_MODIFIED.value()
            == fleet_before + 1
        )
        assert (
            obs_metrics.PEER_SNAPSHOT_NOT_MODIFIED.value() == peer_before
        )
    finally:
        fleet_server.close()
        collector.close()
        server.close()
        coord.close()


def test_fleet_main_exits_nonzero_on_bind_failure(tmp_path):
    """Serving the inventory IS the product: a collector that cannot
    bind must exit 1, never report a clean completion."""
    import socket

    from torch_fleet_pair import cmd_fleet

    blocker = socket.socket()
    blocker.bind(("127.0.0.1", 0))
    blocker.listen(1)
    port = blocker.getsockname()[1]
    targets_path = write_targets(
        tmp_path, [{"name": "s0", "hosts": ["127.0.0.1:1"]}]
    )
    try:
        rc = cmd_fleet.main(
            [
                "--targets-file", targets_path,
                "--metrics-addr", "127.0.0.1",
                "--metrics-port", str(port),
            ]
        )
        assert rc == 1
    finally:
        blocker.close()


def test_collector_restores_and_clears_on_first_live_poll(tmp_path):
    state_dir = side_dir(os.path.join(str(tmp_path), "state"))
    coord, server = _serve_coordinator()
    targets = _targets(tmp_path, {"s0": [f"127.0.0.1:{server.port}"]})
    first = FleetCollector(targets, peer_timeout=0.5, state_dir=state_dir)
    first.poll_round()
    first.close()
    # Restart: the persisted inventory serves immediately, marked
    # restored, before any poll.
    second = FleetCollector(targets, peer_timeout=0.5, state_dir=state_dir)
    try:
        doc = second.inventory_payload()
        assert doc["restored"] is True
        assert doc["slices"]["s0"]["restored"] is True
        assert doc["slices"]["s0"]["healthy_hosts"] == 2
        assert obs_metrics.FLEET_RESTORED.value() == 1
        second.poll_round()
        doc = second.inventory_payload()
        assert doc["restored"] is False
        assert doc["slices"]["s0"]["restored"] is False
        assert obs_metrics.FLEET_RESTORED.value() == 0
    finally:
        second.close()
        server.close()
        coord.close()


def test_inventory_store_ignores_corrupt_and_mismatched(tmp_path):
    store = InventoryStore(str(tmp_path))
    assert store.load() is None
    with open(store.path, "w") as f:
        f.write("not json {")
    assert store.load() is None
    with open(store.path, "w") as f:
        json.dump({"version": 999, "slices": {}}, f)
    assert store.load() is None
    assert store.save({"s0": {"reachable": True}})
    assert store.load() == {"s0": {"reachable": True}}


def test_collector_restore_skips_slices_gone_from_targets(tmp_path):
    state_dir = side_dir(os.path.join(str(tmp_path), "state"))
    store = InventoryStore(state_dir)
    store.save({"gone": {"reachable": True}, "kept": {"reachable": True}})
    targets = _targets(tmp_path, {"kept": ["127.0.0.1:1"]})
    collector = FleetCollector(targets, peer_timeout=0.1, state_dir=state_dir)
    try:
        doc = collector.inventory_payload()
        assert "gone" not in doc["slices"]
        assert doc["slices"]["kept"]["restored"] is True
    finally:
        collector.close()


# ---------------------------------------------------------------------------
# the fleet-collector CLI mode (cmd/fleet.py)
# ---------------------------------------------------------------------------

def test_fleet_flag_resolution_precedence():
    from torch_fleet_pair import cmd_fleet

    resolve_flags = cmd_fleet.resolve_flags
    assert [fd.name for fd in tfp.port_cmd_fleet.FLEET_FLAG_DEFS] == [
        fd.name for fd in tfp.twin_cmd_fleet.FLEET_FLAG_DEFS]
    assert len(tfp.port_cmd_fleet.FLEET_FLAG_DEFS) == 18
    for fd, twin_fd in zip(tfp.port_cmd_fleet.FLEET_FLAG_DEFS,
                           tfp.twin_cmd_fleet.FLEET_FLAG_DEFS):
        assert (fd.env_vars, fd.default, fd.help) == (
            twin_fd.env_vars, twin_fd.default, twin_fd.help), fd.name

    values = resolve_flags(
        {"targets-file": "/cli.yaml", "scrape-interval": None,
         "metrics-addr": None, "metrics-port": None, "peer-timeout": None,
         "peer-fanout": None, "peer-token": None, "state-dir": None},
        environ={
            "TFD_FLEET_TARGETS": "/env.yaml",
            "TFD_FLEET_SCRAPE_INTERVAL": "3s",
            "TFD_PEER_TOKEN": "tok",
        },
    )
    assert values["targets-file"] == "/cli.yaml"      # CLI beats env
    assert values["scrape-interval"] == 3.0           # env beats default
    assert values["peer-token"] == "tok"
    assert values["metrics-port"] == 9102             # default


def test_fleet_run_epoch_serves_reloads_and_shuts_down(tmp_path):
    """run_epoch end to end: serves /fleet/snapshot + /healthz/readyz,
    returns "restart" when the targets file changes (the mtime watcher),
    and honors SIGTERM. Each package's epoch in turn, over one peer."""
    import queue
    import signal
    import threading

    coord, server = _serve_coordinator()
    try:
        for S in CMD_SIDES:
            work = tmp_path / S.name
            work.mkdir()
            targets_path = write_targets(
                work, [{"name": "s0", "hosts": [f"127.0.0.1:{server.port}"]}]
            )
            values = S.cmd_fleet.resolve_flags(
                {"targets-file": targets_path, "scrape-interval": "0.1s",
                 "metrics-addr": "127.0.0.1", "metrics-port": "0",
                 "peer-timeout": "0.5s", "peer-fanout": None, "peer-token": None,
                 "state-dir": os.path.join(str(work), "state")},
                environ={},
            )
            targets = S.parse_targets_file(targets_path)
            sigs = queue.Queue()
            result = {}

            def run():
                result["decision"] = S.cmd_fleet.run_epoch(values, targets, sigs)

            t = threading.Thread(target=run, daemon=True)
            t.start()
            # Wait for a round, then touch the targets file to force the
            # restart decision.
            time.sleep(0.5)
            with open(targets_path, "a") as f:
                f.write("\n# touched\n")
            t.join(timeout=10)
            assert result.get("decision") == "restart", (S.name, result)
            # Second epoch: SIGTERM exits cleanly.
            result.clear()
            t2 = threading.Thread(target=run, daemon=True)
            t2.start()
            time.sleep(0.3)
            sigs.put(signal.SIGTERM)
            t2.join(timeout=10)
            assert result.get("decision") == "shutdown", (S.name, result)
    finally:
        server.close()
        coord.close()


def test_fleet_main_keeps_last_good_targets_on_torn_reload(
    tmp_path, monkeypatch
):
    """Reload robustness: a targets file caught mid-rewrite — here a
    config tool's truncated temp copy, unparseable YAML — must NOT error
    the epoch. The collector keeps scraping the last-good target set,
    warns, and counts the failure on
    tfd_fleet_targets_reload_failures_total. Each package's main in
    turn."""
    import importlib
    import queue
    import signal
    import threading

    coord, server = _serve_coordinator()
    try:
        for S in CMD_SIDES:
            work = tmp_path / S.name
            work.mkdir()
            targets_path = write_targets(
                work, [{"name": "s0", "hosts": [f"127.0.0.1:{server.port}"]}]
            )
            sigs = queue.Queue()
            monkeypatch.setattr(importlib.import_module(S.cmd_main),
                                "new_os_watcher", lambda: sigs)
            counter = S.metrics.FLEET_TARGETS_RELOAD_FAILURES
            failures_before = counter.value()
            result = {}

            def run():
                result["rc"] = S.cmd_fleet.main(
                    [
                        "--targets-file", targets_path,
                        "--scrape-interval", "0.1s",
                        "--metrics-addr", "127.0.0.1",
                        "--metrics-port", "0",
                    ]
                )

            t = threading.Thread(target=run, daemon=True)
            t.start()
            time.sleep(0.5)  # epoch 1 up and scraping
            # The torn write: the mtime watcher restarts the epoch; the
            # reload parse fails.
            with open(targets_path, "w") as f:
                f.write("slices:\n  - name: s0\n    hosts: [")
            deadline = time.monotonic() + 10
            while counter.value() == failures_before and time.monotonic() < deadline:
                time.sleep(0.02)
            assert counter.value() == failures_before + 1, (
                f"{S.name}: torn reload never counted on the failure counter")
            assert t.is_alive(), (
                f"{S.name}: collector exited on a torn targets reload instead "
                "of keeping the last-good set")
            sigs.put(signal.SIGTERM)
            t.join(timeout=10)
            assert result.get("rc") == 0, (S.name, result)
    finally:
        server.close()
        coord.close()


def test_fleet_main_first_load_failure_is_still_fatal(tmp_path):
    """The last-good fallback has nothing to fall back on at FIRST
    load: a collector started against an unparseable targets file must
    exit 1 (a misconfigured deployment fails loudly, it does not serve
    an empty inventory forever)."""
    from torch_fleet_pair import cmd_fleet

    targets_path = os.path.join(str(tmp_path), "targets.yaml")
    with open(targets_path, "w") as f:
        f.write("slices:\n  - name: s0\n    hosts: [")
    rc = cmd_fleet.main(
        [
            "--targets-file", targets_path,
            "--metrics-addr", "127.0.0.1",
            "--metrics-port", "0",
        ]
    )
    assert rc == 1


def test_console_entry_dispatches_fleet_collector():
    """The installed console script and ``python -m`` share ONE entry
    (cmd.main.main): `<script> fleet-collector --help` must reach the
    collector's parser — exactly the invocation its own usage string
    advertises — not die in the daemon parser. Both packages, the same
    flag list."""
    outputs = []
    for package, script in (("gpu_feature_discovery_tpu", "tpu-feature-discovery"),
                            ("gpu_feature_discovery_tpu_torch",
                             "gpu-feature-discovery-torch")):
        proc = subprocess.run(
            [
                sys.executable,
                "-c",
                f"import sys; sys.argv = [{script!r}, "
                "'fleet-collector', '--help']; "
                f"from {package}.cmd.main import main; main()",
            ],
            capture_output=True,
            text=True,
            timeout=60,
            cwd=REPO,
        )
        assert proc.returncode == 0, proc.stderr
        assert "--targets-file" in proc.stdout, proc.stdout
        assert f"usage: {script} fleet-collector" in proc.stdout, proc.stdout
        outputs.append(proc.stdout.split("options:")[1])
    assert outputs[0] == outputs[1]


def test_never_reached_target_is_stale_with_null_age(tmp_path):
    """A target the collector never reached flips stale like any dark
    chain (earned trust: first miss confirms) — with every data field
    null and a null last_seen_unix, the documented 'never existed vs
    went dark' discriminator."""
    targets = _targets(tmp_path, {"ghost": ["127.0.0.1:1"]})
    collector = FleetCollector(targets, peer_timeout=0.2)
    try:
        collector.poll_round()
        entry = collector.inventory_payload()["slices"]["ghost"]
        assert entry["stale"] is True, entry
        assert entry["reachable"] is False, entry
        assert entry["last_seen_unix"] is None, entry
        assert entry["healthy_hosts"] is None, entry
        assert obs_metrics.FLEET_SLICES_STALE.value() == 1
    finally:
        collector.close()


def test_last_seen_quantum_dwarfs_the_default_interval():
    """The idle-fleet 304 economy only holds while the quantized stamp
    stays put across many rounds: the quantum must sit well above the
    default scrape interval (a 1.5x ratio re-renders most rounds)."""
    from torch_fleet_pair import cmd_fleet

    DEFAULT_SCRAPE_INTERVAL = cmd_fleet.DEFAULT_SCRAPE_INTERVAL
    LAST_SEEN_QUANTUM_S = collector.LAST_SEEN_QUANTUM_S

    assert LAST_SEEN_QUANTUM_S >= 10 * DEFAULT_SCRAPE_INTERVAL


# ---------------------------------------------------------------------------
# federation (--upstream-mode=collectors): root over region collectors
# ---------------------------------------------------------------------------

def _serve_slices(n, prefix="s"):
    """n fake slice leaders (SliceCoordinator + server each) and the
    SliceTarget list pointing at them."""
    SliceTarget = fleet.SliceTarget

    coords, servers, targets = [], [], []
    for i in range(n):
        coord = SliceCoordinator(
            0, ["h0:1", "h1:1"], default_port=1, peer_timeout=0.5
        )
        coord.publish_local(LEADER_LABELS, "full")
        server = IntrospectionServer(
            obs_metrics.REGISTRY,
            IntrospectionState(60.0),
            addr="127.0.0.1",
            port=0,
            peer_snapshot=coord.snapshot_response,
        )
        server.start()
        coords.append(coord)
        servers.append(server)
        targets.append(
            SliceTarget(
                name=f"{prefix}{i}", hosts=(f"127.0.0.1:{server.port}",)
            )
        )
    return coords, servers, targets


def _serve_region(targets, **kwargs):
    """A region collector over ``targets`` plus the server exposing its
    /fleet/snapshot (what a root scrapes)."""
    region = FleetCollector(targets, peer_timeout=0.5, **kwargs)
    server = IntrospectionServer(
        obs_metrics.REGISTRY,
        IntrospectionState(60.0),
        addr="127.0.0.1",
        port=0,
        fleet_snapshot=region.inventory_response,
    )
    server.start()
    return region, server


def _root_over(region_servers, names=None, **kwargs):
    SliceTarget = fleet.SliceTarget

    targets = [
        SliceTarget(
            name=(names[i] if names else f"region-{i}"),
            hosts=(f"127.0.0.1:{server.port}",),
        )
        for i, server in enumerate(region_servers)
    ]
    return FleetCollector(
        targets, peer_timeout=0.5, upstream_mode="collectors", **kwargs
    )


def test_federation_identity_root_equals_direct_collector():
    """The federation identity property: a root over ONE region
    collector serves entry-for-entry the same slice inventory as
    scraping the slices directly — modulo the region/<name>/ key prefix
    and the added ``region`` attribution field, NOTHING else moves."""
    coords, servers, targets = _serve_slices(3)
    region, region_server = _serve_region(targets)
    root = None
    try:
        region.poll_round()
        direct = region.inventory_payload()
        root = _root_over([region_server], names=["r0"])
        root.poll_round()
        merged = root.inventory_payload()
        assert merged["upstream"] == "collectors"
        assert set(merged["slices"]) == {
            f"region/r0/{name}" for name in direct["slices"]
        }
        for name, entry in direct["slices"].items():
            root_entry = dict(merged["slices"][f"region/r0/{name}"])
            assert root_entry.pop("region") == "r0"
            assert root_entry == entry, (name, root_entry, entry)
        # The region meta rides next to the merged entries.
        meta = merged["regions"]["r0"]
        assert meta["reachable"] is True and meta["stale"] is False
        assert meta["generation"] == direct["generation"]
        # And the slices-mode document stays byte-free of the new keys
        # (the plain schema-1 wire).
        assert "upstream" not in direct and "regions" not in direct
    finally:
        if root is not None:
            root.close()
        region_server.close()
        region.close()
        for s in servers:
            s.close()
        for c in coords:
            c.close()


def test_federated_idle_round_is_304_header_exchange():
    """An idle root round is ~1 304 per region: the If-None-Match
    economy holds across the /fleet/snapshot hop too, and the root's
    own body/ETag stay frozen (federation nests)."""
    coords, servers, targets = _serve_slices(2)
    region, region_server = _serve_region(targets)
    root = None
    try:
        region.poll_round()
        root = _root_over([region_server])
        root.poll_round()
        body1, etag1 = root.inventory_response()
        before = obs_metrics.FLEET_SNAPSHOT_NOT_MODIFIED.value()
        root.poll_round()
        assert (
            obs_metrics.FLEET_SNAPSHOT_NOT_MODIFIED.value() == before + 1
        )
        assert root.inventory_response() == (body1, etag1)
        parse_inventory(body1)  # the merged body is a valid upstream
    finally:
        if root is not None:
            root.close()
        region_server.close()
        region.close()
        for s in servers:
            s.close()
        for c in coords:
            c.close()


def test_dark_region_served_degraded_stale_with_age_preserved():
    """A region whose whole collector chain is confirmed dark keeps its
    merged slice entries on the root pane — flipped stale with their
    verdicts and last_seen_unix preserved — while a healthy region's
    entries stay byte-identical."""
    coords, servers, targets = _serve_slices(2)
    # Frozen wall clock: the byte-identity assertion below must not
    # flake on a real-clock LAST_SEEN_QUANTUM boundary crossing.
    frozen = {"wall_clock": lambda: 1_700_000_000.0}
    region_a, server_a = _serve_region(targets[:1], **frozen)
    region_b, server_b = _serve_region(targets[1:], **frozen)
    root = None
    try:
        region_a.poll_round()
        region_b.poll_round()
        root = _root_over(
            [server_a, server_b], names=["ra", "rb"], **frozen
        )
        root.poll_round()
        before = root.inventory_payload()
        assert before["slices"]["region/ra/s0"]["stale"] is False
        healthy_before = dict(before["slices"]["region/rb/s1"])
        # Region A's only collector dies at the wire.
        server_a.close()
        region_a.close()
        for _ in range(3):  # 2-miss confirmation + one commit
            root.poll_round()
        doc = root.inventory_payload()
        meta = doc["regions"]["ra"]
        assert meta["reachable"] is False and meta["stale"] is True
        assert meta["last_seen_unix"] is not None
        dark = doc["slices"]["region/ra/s0"]
        assert dark["stale"] is True
        assert dark["healthy_hosts"] == 2
        assert (
            dark["last_seen_unix"]
            == before["slices"]["region/ra/s0"]["last_seen_unix"]
        )
        assert doc["slices"]["region/rb/s1"] == healthy_before
        assert doc["regions"]["rb"]["stale"] is False
        assert obs_metrics.FLEET_REGIONS_STALE.value() == 1
    finally:
        if root is not None:
            root.close()
        server_b.close()
        region_b.close()
        for s in servers:
            s.close()
        for c in coords:
            c.close()


def test_root_restores_region_entries_until_first_live_scrape(tmp_path):
    """Restore-at-root: a restarted root serves each region's persisted
    entries marked restored, clearing them on that region's first live
    scrape — the slice-entry restore, one tier up."""
    state_dir = side_dir(os.path.join(str(tmp_path), "root-state"))
    coords, servers, targets = _serve_slices(2)
    region, region_server = _serve_region(targets)
    try:
        region.poll_round()
        first = _root_over([region_server], names=["r0"])
        # _root_over has no state_dir parameter; rebuild with one.
        first.close()
        SliceTarget = fleet.SliceTarget

        root_targets = [
            SliceTarget(
                name="r0", hosts=(f"127.0.0.1:{region_server.port}",)
            )
        ]
        first = FleetCollector(
            root_targets,
            peer_timeout=0.5,
            upstream_mode="collectors",
            state_dir=state_dir,
        )
        first.poll_round()
        live = first.inventory_payload()
        first.close()
        second = FleetCollector(
            root_targets,
            peer_timeout=0.5,
            upstream_mode="collectors",
            state_dir=state_dir,
        )
        try:
            doc = second.inventory_payload()
            assert doc["restored"] is True
            assert doc["regions"]["r0"]["restored"] is True
            for name, entry in live["slices"].items():
                assert doc["slices"][name]["restored"] is True
                assert (
                    doc["slices"][name]["healthy_hosts"]
                    == entry["healthy_hosts"]
                )
            assert obs_metrics.FLEET_RESTORED.value() == 1
            second.poll_round()
            doc = second.inventory_payload()
            assert doc["restored"] is False
            assert doc["regions"]["r0"]["restored"] is False
            assert all(
                not e["restored"] for e in doc["slices"].values()
            )
            assert obs_metrics.FLEET_RESTORED.value() == 0
        finally:
            second.close()
    finally:
        region_server.close()
        region.close()
        for s in servers:
            s.close()
        for c in coords:
            c.close()


def test_root_restore_skips_regions_gone_from_targets(tmp_path):
    """A region dropped from the targets file must not resurrect from
    --state-dir (the slices-mode rule, one tier up)."""
    SliceTarget = fleet.SliceTarget

    state_dir = side_dir(os.path.join(str(tmp_path), "state"))
    store = InventoryStore(state_dir)
    store.save(
        {
            "region/gone/s0": {"reachable": True},
            "region/kept/s0": {"reachable": True},
        },
        regions={
            "gone": {"reachable": True},
            "kept": {"reachable": True},
        },
    )
    root = FleetCollector(
        [SliceTarget(name="kept", hosts=("127.0.0.1:1",))],
        peer_timeout=0.1,
        upstream_mode="collectors",
        state_dir=state_dir,
    )
    try:
        doc = root.inventory_payload()
        assert "region/gone/s0" not in doc["slices"]
        assert doc["slices"]["region/kept/s0"]["restored"] is True
        assert doc["regions"]["kept"]["restored"] is True
    finally:
        root.close()


# ---------------------------------------------------------------------------
# HA: role by re-derivation, standby mirror, divergence
# ---------------------------------------------------------------------------

def test_ha_parse_peers_grammar():
    parse_ha_peers = fleet.parse_ha_peers

    assert parse_ha_peers("a:1, b:2,,c") == ["a:1", "b:2", "c"]
    with pytest.raises(ConfigError):
        parse_ha_peers("a:1,a:1")


def test_ha_bare_peer_entries_take_the_callers_default_port():
    """run_epoch passes the collector's own serving port as the HA
    default (replicas of one deployment serve where we serve): a bare
    --ha-peers entry must mirror THAT port, never a hardcoded one — a
    wrong default here polls a dead port, confirms the healthy active
    dead, and hands BOTH replicas role=active."""
    HaMonitor = fleet.HaMonitor

    ha = HaMonitor(
        ["senior-host", "self-host"], "self-host", default_port=9200
    )
    try:
        (_, senior), = ha._seniors
        assert (senior.host, senior.port) == ("senior-host", 9200)
    finally:
        ha.close()


def test_ha_monitor_rejects_self_not_in_peers():
    HaMonitor = fleet.HaMonitor

    with pytest.raises(ConfigError):
        HaMonitor(["a:1", "b:2"], "c:3")


def test_ha_first_peer_is_active_without_polling_anyone():
    """The first entry of the ordered list never polls: everything
    senior to it is the empty set, so it derives active immediately —
    and an active's divergence is 0 by definition."""
    HaMonitor = fleet.HaMonitor

    ha = HaMonitor(["me:1", "other:2"], "me:1", peer_timeout=0.2)
    try:
        assert ha.role == "active"
        assert ha.observe_round({"s0": {"reachable": True}}) == "active"
        assert obs_metrics.FLEET_HA_ROLE.value() == 1
        assert ha.divergence == 0
    finally:
        ha.close()


def test_ha_standby_mirrors_active_with_304s_and_fails_over():
    """The full HA contract at unit level: the junior replica derives
    standby while the senior serves, the mirror collapses to 304 header
    exchanges once the panes agree (divergence 0), ONE missed mirror
    poll keeps the role (the 2-miss rule), and a confirmed-dead senior
    re-derives the standby active with its own pane intact."""
    HaMonitor = fleet.HaMonitor

    coords, servers, targets = _serve_slices(2)
    active = FleetCollector(targets, peer_timeout=0.5)
    active_server = IntrospectionServer(
        obs_metrics.REGISTRY,
        IntrospectionState(60.0),
        addr="127.0.0.1",
        port=0,
        fleet_snapshot=active.inventory_response,
    )
    active_server.start()
    standby = FleetCollector(targets, peer_timeout=0.5)
    ha = HaMonitor(
        [f"127.0.0.1:{active_server.port}", "standby:9102"],
        "standby:9102",
        peer_timeout=0.5,
    )
    try:
        active.poll_round()
        standby.poll_round()
        own = standby.inventory_payload()["slices"]
        assert ha.observe_round(own) == "standby"
        assert obs_metrics.FLEET_HA_ROLE.value() == 0
        # Both scraped the same fleet: the pair agrees.
        assert ha.divergence == 0
        assert obs_metrics.FLEET_HA_DIVERGENCE.value() == 0
        # An idle agreeing pair exchanges 304s on the mirror — and the
        # mirror's 304s never touch the scrape-economy counter.
        scrape_304s = obs_metrics.FLEET_SNAPSHOT_NOT_MODIFIED.value()
        before = ha.mirror_not_modified.value
        assert ha.observe_round(own) == "standby"
        assert ha.mirror_not_modified.value == before + 1
        assert (
            obs_metrics.FLEET_SNAPSHOT_NOT_MODIFIED.value() == scrape_304s
        )
        # Active dies at the wire: miss 1 keeps the role...
        active_server.close()
        active.close()
        assert ha.observe_round(own) == "standby"
        # ...miss 2 confirms, and the standby re-derives active.
        assert ha.observe_round(own) == "active"
        assert obs_metrics.FLEET_HA_ROLE.value() == 1
        # The survivor's own pane was live the whole time: complete and
        # non-restored, zero entries lost.
        doc = standby.inventory_payload()
        assert set(doc["slices"]) == {t.name for t in targets}
        assert doc["restored"] is False
        assert all(
            e["healthy_hosts"] == 2 and not e["restored"]
            for e in doc["slices"].values()
        )
    finally:
        ha.close()
        standby.close()
        for s in servers:
            s.close()
        for c in coords:
            c.close()


def test_ha_divergence_counts_split_pane_entries():
    entries_divergence = tfp.ha.entries_divergence

    a = {
        "s0": {"reachable": True, "stale": False, "last_seen_unix": 100},
        "s1": {"reachable": True, "stale": False, "last_seen_unix": 100},
    }
    # The quantized stamp and restore markers are volatile, never a
    # split pane.
    b = {
        "s0": {"reachable": True, "stale": False, "last_seen_unix": 400},
        "s1": {"reachable": True, "stale": False, "restored": True},
    }
    assert entries_divergence(a, b) == 0
    b["s1"]["stale"] = True          # a real disagreement
    b["s2"] = {"reachable": True}    # an entry only one pane has
    assert entries_divergence(a, b) == 2


def test_fleet_main_rejects_half_configured_ha(tmp_path):
    from torch_fleet_pair import cmd_fleet

    targets_path = write_targets(
        tmp_path, [{"name": "s0", "hosts": ["127.0.0.1:1"]}]
    )
    assert cmd_fleet.main(
        ["--targets-file", targets_path, "--ha-peers", "a:1,b:2"]
    ) == 1
    assert cmd_fleet.main(
        [
            "--targets-file", targets_path,
            "--ha-peers", "a:1,b:2",
            "--ha-self", "c:3",
        ]
    ) == 1


def test_upstream_mode_flag_grammar():
    from torch_fleet_pair import spec

    parse_upstream_mode = spec.parse_upstream_mode
    for name in ("UPSTREAM_MODES", "DEFAULT_FLEET_DELTA_WINDOW",
                 "DEFAULT_FILTER_CACHE_SIZE", "DEFAULT_WATCH_TIMEOUT_S",
                 "DEFAULT_MAX_WATCHERS", "DEFAULT_MAX_INFLIGHT"):
        getattr(spec, name)  # equal on both sides, or the pair raises
    assert spec.parse_delta_window("0") == 0
    with pytest.raises(ConfigError):
        spec.parse_delta_window("-1")

    assert parse_upstream_mode(" Collectors ") == "collectors"
    assert parse_upstream_mode("slices") == "slices"
    with pytest.raises(ConfigError):
        parse_upstream_mode("regions")
    with pytest.raises(ValueError):
        FleetCollector([], upstream_mode="bogus")


# ---------------------------------------------------------------------------
# readiness + targets watcher hardening
# ---------------------------------------------------------------------------

def _blackhole():
    """A target that accepts but never answers: a round against it takes
    a full --peer-timeout."""
    import socket

    hole = socket.socket()
    hole.bind(("127.0.0.1", 0))
    hole.listen(5)
    return hole


def _readyz_epoch(S, work, hole, state_dir=""):
    """Start S's collector epoch over the blackhole target on a free
    port: (readyz url, stop function)."""
    import queue
    import signal
    import threading

    from slice_fixture import free_port

    port = free_port()
    targets_path = write_targets(
        work, [{"name": "s0", "hosts": [f"127.0.0.1:{hole.getsockname()[1]}"]}]
    )
    flags = {"targets-file": targets_path, "scrape-interval": "30s",
             "metrics-addr": "127.0.0.1", "metrics-port": str(port),
             "peer-timeout": "2s"}
    if state_dir:
        flags["state-dir"] = state_dir
    values = S.cmd_fleet.resolve_flags(flags, environ={})
    targets = S.parse_targets_file(targets_path)
    sigs = queue.Queue()
    t = threading.Thread(
        target=S.cmd_fleet.run_epoch, args=(values, targets, sigs), daemon=True
    )
    t.start()

    def stop():
        sigs.put(signal.SIGTERM)
        t.join(timeout=10)

    return f"http://127.0.0.1:{port}/readyz", stop


def _first_status(url):
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        try:
            return http_get(url)[0]
        except OSError:
            time.sleep(0.02)
    return None


def test_collector_readyz_503_until_first_round_then_200(tmp_path):
    """A fresh replica behind the HA Service must never serve an empty
    inventory as ready: /readyz answers 503 until the first scrape
    round completes, then 200. Both packages' epochs, side by side."""
    hole = _blackhole()
    epochs = []
    try:
        for S in CMD_SIDES:
            (tmp_path / S.name).mkdir()
            epochs.append(_readyz_epoch(S, tmp_path / S.name, hole))
        for S, (url, _stop) in zip(CMD_SIDES, epochs):
            assert _first_status(url) == 503, (
                f"{S.name}: a pre-first-round replica must not be ready")
        for S, (url, _stop) in zip(CMD_SIDES, epochs):
            deadline = time.monotonic() + 30
            status = None
            while time.monotonic() < deadline and status != 200:
                status, _ = http_get(url)
                time.sleep(0.05)
            assert status == 200, f"{S.name}: first completed round must flip readiness"
    finally:
        for _url, stop in epochs:
            stop()
        hole.close()


def test_collector_readyz_200_immediately_on_state_restore(tmp_path):
    """The restore regime is ready: a replica serving last-good
    restored data answers 200 before its first live round."""
    state_dir = side_dir(os.path.join(str(tmp_path), "state"))
    store = InventoryStore(state_dir)
    store.save({"s0": {"reachable": True, "healthy_hosts": 2}})
    # The never-answering target: the first live round is still in
    # flight when readiness is probed, so only the restore can explain a
    # 200.
    hole = _blackhole()
    epochs = []
    try:
        for S, sdir in zip(CMD_SIDES, (state_dir, tfp.port_side_path(state_dir))):
            (tmp_path / S.name).mkdir()
            epochs.append(_readyz_epoch(S, tmp_path / S.name, hole, sdir))
        for S, (url, _stop) in zip(CMD_SIDES, epochs):
            if S.name == "port":
                assert _first_status(url) == 200, (
                    f"{S.name}: restored last-good data is ready data")
                continue
            # The twin starts its server before it marks the restore, so
            # its first answers may be 503: its first 200 must be the
            # restore's, not the first live round's.
            deadline = time.monotonic() + 10
            while _first_status(url) != 200 and time.monotonic() < deadline:
                time.sleep(0.02)
            status, body = http_get(url.replace("/readyz", "/debug/labels"))
            assert status == 200 and json.loads(body)["mode"] == "restored", (
                f"{S.name}: restored last-good data is ready data")
    finally:
        for _url, stop in epochs:
            stop()
        hole.close()


def test_collector_marks_the_restore_ready_before_it_serves(tmp_path, monkeypatch):
    """The port's epoch marks restored data ready before its server
    handles a request, so no request between the two answers 503."""
    calls = []
    real_start = port_obs_server.IntrospectionServer.start
    real_written = port_obs_server.IntrospectionState.labels_written

    def start(self):
        calls.append("serve")
        real_start(self)

    def labels_written(self, labels, sources=None, mode="full"):
        calls.append(mode)
        real_written(self, labels, sources=sources, mode=mode)

    monkeypatch.setattr(port_obs_server.IntrospectionServer, "start", start)
    monkeypatch.setattr(port_obs_server.IntrospectionState, "labels_written",
                        labels_written)
    state_dir = side_dir(os.path.join(str(tmp_path), "state"))
    InventoryStore(state_dir).save({"s0": {"reachable": True, "healthy_hosts": 2}})
    hole = _blackhole()
    url, stop = _readyz_epoch(CMD_SIDES[1], tmp_path, hole,
                              tfp.port_side_path(state_dir))
    try:
        assert _first_status(url) is not None
    finally:
        stop()
        hole.close()
    assert calls[:2] == ["restored", "serve"], calls


def test_targets_watcher_fires_on_same_mtime_rewrite(tmp_path):
    """The stat-triple contract: a targets rewrite whose mtime is
    UNCHANGED (a same-second atomic replace — exactly what
    config-management tools produce) still fires the reload, because
    the watcher fingerprints (mtime_ns, size, inode), not mtime alone."""
    from torch_fleet_pair import events as paired_events

    ConfigFileWatcher = paired_events.ConfigFileWatcher
    EventQueue = paired_events.EventQueue

    path = write_targets(
        tmp_path, [{"name": "s0", "hosts": ["h0:9101"]}]
    )
    st = os.stat(path)
    events = EventQueue()
    watcher = ConfigFileWatcher(path, events, poll_s=0.02).start()
    try:
        # Same byte length, same forced mtime, NEW inode: only the
        # inode distinguishes the rewrite.
        replacement = os.path.join(str(tmp_path), "targets-new.yaml")
        with open(path, "rb") as f:
            content = f.read()
        with open(replacement, "wb") as f:
            f.write(content)
        os.utime(replacement, ns=(st.st_atime_ns, st.st_mtime_ns))
        os.replace(replacement, path)
        os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns))
        after = os.stat(path)
        assert after.st_mtime_ns == st.st_mtime_ns
        assert after.st_size == st.st_size
        event = events.get(timeout=5)
        assert event is not None and event.reason == "config_changed"
    finally:
        watcher.stop()


# ---------------------------------------------------------------------------
# ACCEPTANCE: a live collector over 3 real slice fixtures
# ---------------------------------------------------------------------------

def test_fleet_collector_over_three_slices_acceptance(tmp_path):
    """The collector acceptance, end to end with the token armed, both
    collectors over the same three slices of the twin's daemons:

    1. 3 hermetic 2-worker slices (real supervised daemons, real HTTP),
       every daemon requiring --peer-token on /peer/snapshot — their own
       tokened poll rounds converge to healthy slices.
    2. An unauthenticated scrape of a worker's /peer/snapshot is
       rejected (403; wrong token 401) while coordination keeps working.
    3. A collector over the 3 slices serves /fleet/snapshot reflecting
       all 3 (healthy_hosts=2 each), itself token-gated.
    4. Killing one slice's ENTIRE leadership chain flips only that
       slice's entry to degraded-stale within the confirmation window;
       the other slices' entries stay untouched and keep polling ok.
    """
    from slice_fixture import SliceHarness

    from gpu_feature_discovery_tpu.lm.slice_labeler import (
        SLICE_HEALTHY_HOSTS_LABEL,
        SLICE_ROLE_LABEL,
    )

    token = "fleet-acceptance-secret"
    harnesses = []
    try:
        for i in range(3):
            workdir = os.path.join(str(tmp_path), f"slice-{i}")
            os.makedirs(workdir, exist_ok=True)
            harnesses.append(
                SliceHarness(
                    workdir,
                    workers=2,
                    sleep_interval="0.05s",
                    peer_timeout="0.5s",
                    peer_token=token,
                )
            )
        for harness in harnesses:
            harness.start()
        for i, harness in enumerate(harnesses):
            harness.wait_for(
                lambda s: (
                    s[0].get(SLICE_ROLE_LABEL) == "leader"
                    and s[0].get(SLICE_HEALTHY_HOSTS_LABEL) == "2"
                ),
                timeout=60,
                what=f"healthy tokened slice {i}",
            )
        # (2) anonymous/wrong scrapes rejected while the slice runs.
        port0 = harnesses[0].workers[0].port
        peer_url = f"http://127.0.0.1:{port0}/peer/snapshot"
        assert http_get(peer_url)[0] == 403
        assert http_get(peer_url, {"X-TFD-Probe-Token": "wrong"})[0] == 401
        status, body = http_get(peer_url, {"X-TFD-Probe-Token": token})
        assert status == 200
        assert parse_snapshot(body)["slice"]["healthy_hosts"] == 2
        # (3) collector over all 3, tokened, serving /fleet/snapshot.
        targets = _targets(
            tmp_path,
            {
                f"slice-{i}": [
                    f"127.0.0.1:{w.port}" for w in harness.workers
                ]
                for i, harness in enumerate(harnesses)
            },
        )
        collector = FleetCollector(
            targets, peer_timeout=0.5, peer_token=token
        )
        fleet_server = IntrospectionServer(
            obs_metrics.REGISTRY,
            IntrospectionState(60.0),
            addr="127.0.0.1",
            port=0,
            fleet_snapshot=collector.inventory_response,
            peer_token=token,
        )
        fleet_server.start()
        try:
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline:
                collector.poll_round()
                doc = collector.inventory_payload()
                if all(
                    doc["slices"][f"slice-{i}"].get("healthy_hosts") == 2
                    for i in range(3)
                ):
                    break
                time.sleep(0.05)
            doc = collector.inventory_payload()
            for i in range(3):
                entry = doc["slices"][f"slice-{i}"]
                assert entry["reachable"] is True, doc
                assert entry["stale"] is False, doc
                assert entry["healthy_hosts"] == 2, doc
                assert entry["degraded"] is False, doc
            fleet_url = f"http://127.0.0.1:{fleet_server.port}/fleet/snapshot"
            assert http_get(fleet_url)[0] == 403
            status, body = http_get(fleet_url, {"X-TFD-Probe-Token": token})
            assert status == 200
            assert parse_inventory(body)["slices"]["slice-1"][
                "healthy_hosts"
            ] == 2
            # (4) kill slice 1's ENTIRE leadership chain (both workers —
            # the whole 2-host slice goes dark at the wire).
            before = {
                name: dict(doc["slices"][name])
                for name in ("slice-0", "slice-2")
            }
            harnesses[1].stop()
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline:
                collector.poll_round()
                entry = collector.inventory_payload()["slices"]["slice-1"]
                if entry["stale"]:
                    break
                time.sleep(0.05)
            doc = collector.inventory_payload()
            dark = doc["slices"]["slice-1"]
            assert dark["stale"] is True, doc
            assert dark["reachable"] is False, doc
            # Degraded-stale keeps the LAST-KNOWN verdict visible with
            # an honest age instead of vanishing from the pane.
            assert dark["healthy_hosts"] == 2, doc
            assert dark["last_seen_unix"] is not None, doc
            # The other slices' entries are untouched and still live.
            for name in ("slice-0", "slice-2"):
                entry = doc["slices"][name]
                assert entry["stale"] is False, doc
                assert entry["reachable"] is True, doc
                assert entry["healthy_hosts"] == 2, doc
                assert entry["leader"] == before[name]["leader"], doc
        finally:
            fleet_server.close()
            collector.close()
    finally:
        for harness in harnesses:
            harness.stop()


# ---------------------------------------------------------------------------
# generation-delta sync
# ---------------------------------------------------------------------------

def _serve_fleet(collector, delta=True):
    """A collector's serving surface with the query hook wired exactly
    as cmd/fleet.py wires it (fleet_query optional for the
    delta-unaware-server pin)."""
    server = IntrospectionServer(
        obs_metrics.REGISTRY,
        IntrospectionState(60.0),
        addr="127.0.0.1",
        port=0,
        fleet_snapshot=collector.inventory_response,
        fleet_query=collector.query_response if delta else None,
    )
    server.start()
    return server


def _fleet_client(port):
    """A /fleet/snapshot client state on each side, each connected to its
    own side's server."""
    hstate = collector._HostState(host="127.0.0.1", port=port)
    _connect(hstate)
    return hstate


def _connect(hstate):
    import http.client

    for h in hstate._sides:
        h.conn = http.client.HTTPConnection("127.0.0.1", h.port, timeout=5)


def _fleet_poll(hstate, delta=True):
    request_snapshot = collector.request_snapshot
    FLEET_SNAPSHOT_PATH = inventory.FLEET_SNAPSHOT_PATH
    MAX_INVENTORY_BYTES = inventory.MAX_INVENTORY_BYTES
    parse_inventory_or_delta = inventory.parse_inventory_or_delta

    doc = request_snapshot(
        hstate,
        5.0,
        FLEET_SNAPSHOT_PATH,
        parse_inventory_or_delta if delta else parse_inventory,
        MAX_INVENTORY_BYTES,
        delta=delta,
    )
    hstate.last_snapshot = doc
    return doc


def test_etag_missing_is_counted_and_warned_once(caplog):
    """A 200 with no ETag header (a stripping proxy) silently destroys
    the 304 economy: every such poll counts, the operator hears about it
    once per host, and the poll itself still succeeds."""
    import logging as _logging

    build_inventory = inventory.build_inventory
    serialize_inventory = inventory.serialize_inventory

    body, _ = serialize_inventory(build_inventory({}, 0, False))
    server = IntrospectionServer(
        obs_metrics.REGISTRY,
        IntrospectionState(60.0),
        addr="127.0.0.1",
        port=0,
        fleet_snapshot=tfp.Pair(lambda: (body, None), lambda: (body, None)),
    )
    server.start()
    hstate = _fleet_client(server.port)
    try:
        before = obs_metrics.FLEET_ETAG_MISSING.value()
        with caplog.at_level(_logging.WARNING, logger="tfd.fleet"):
            doc1 = _fleet_poll(hstate, delta=False)
            doc2 = _fleet_poll(hstate, delta=False)
        assert doc1 == doc2
        assert hstate.etag is None  # nothing to If-None-Match with
        assert obs_metrics.FLEET_ETAG_MISSING.value() == before + 2
        warned = [
            r for r in caplog.records if "no ETag header" in r.getMessage()
        ]
        # Once per host on each side.
        assert sorted("_torch" in r.pathname for r in warned) == [False, True], warned
    finally:
        drop_connection = collector.drop_connection

        drop_connection(hstate)
        server.close()


def test_oversize_body_is_a_typed_error_and_named_outcome(tmp_path):
    """A body over the tier's cap raises the TYPED error at the read
    sentinel (never a parse failure on truncated bytes) and the poll
    counts under its own outcome."""
    for S in PEER_SIDES:
        assert issubclass(S.snapshot.OversizeBodyError, S.snapshot.PeerSnapshotError)
    coord, server = _serve_coordinator()
    targets = _targets(tmp_path, {"s0": [f"127.0.0.1:{server.port}"]})
    collector = FleetCollector(targets, peer_timeout=0.5)
    # Shrink THIS collector's read cap below the fixture's body.
    collector._max_body = 64
    try:
        before = obs_metrics.FLEET_POLLS.value(outcome="oversize")
        collector.poll_round()
        assert (
            obs_metrics.FLEET_POLLS.value(outcome="oversize") == before + 1
        )
        # One miss, not a verdict: the entry reads unreached, not junk.
        assert (
            collector.inventory_payload()["slices"]["s0"]["reachable"]
            is False
        )
    finally:
        collector.close()
        server.close()
        coord.close()


def test_delta_round_moves_only_changed_entries():
    """The tentpole property at unit level: after a full-body sync, a
    changed round moves an O(changed) delta — strictly smaller than the
    full body — and the client's reconstruction is BYTE-IDENTICAL to
    what a full-body client fetches."""
    coords, servers, targets = _serve_slices(4)
    region = FleetCollector(targets, peer_timeout=0.5)
    fleet_server = _serve_fleet(region)
    hstate = _fleet_client(fleet_server.port)
    try:
        region.poll_round()
        doc = _fleet_poll(hstate)  # first contact: the full body
        assert hstate.mirror.last_changed is None
        full_len = len(hstate.mirror.body)
        assert doc == parse_inventory(region.inventory_response()[0])
        # One slice's verdict moves; everything else idles.
        changed_labels = dict(LEADER_LABELS)
        changed_labels["google.com/tpu.slice.healthy-hosts"] = "1"
        changed_labels["google.com/tpu.slice.degraded"] = "true"
        coords[0].publish_local(changed_labels, "full")
        changed = region.poll_round()
        assert changed == {"s0"}
        d_before = obs_metrics.FLEET_DELTA_POLLS.value(kind="delta")
        served_before = obs_metrics.FLEET_DELTA_SERVED.value(
            outcome="delta"
        )
        bytes_before = obs_metrics.FLEET_POLL_BODY_BYTES.value(kind="delta")
        _fleet_poll(hstate)
        assert (
            obs_metrics.FLEET_DELTA_POLLS.value(kind="delta")
            == d_before + 1
        )
        assert (
            obs_metrics.FLEET_DELTA_SERVED.value(outcome="delta")
            == served_before + 1
        )
        delta_bytes = (
            obs_metrics.FLEET_POLL_BODY_BYTES.value(kind="delta")
            - bytes_before
        )
        assert 0 < delta_bytes < full_len
        assert hstate.mirror.last_changed == {"s0"}
        body, etag = region.inventory_response()
        assert hstate.mirror.body == body
        assert hstate.etag == etag
        entry = hstate.mirror.doc["slices"]["s0"]
        assert entry["healthy_hosts"] == 1 and entry["degraded"] is True
    finally:
        drop_connection = collector.drop_connection

        drop_connection(hstate)
        fleet_server.close()
        region.close()
        for s in servers:
            s.close()
        for c in coords:
            c.close()


def test_delta_since_equals_generation_is_a_304():
    """An in-sync delta client's idle poll is still a 304 header
    exchange: ``?since`` == the server's generation with a matching
    If-None-Match answers no body at all (the empty-delta equivalent),
    and the idle-economy counter moves."""
    coords, servers, targets = _serve_slices(2)
    region = FleetCollector(targets, peer_timeout=0.5)
    fleet_server = _serve_fleet(region)
    hstate = _fleet_client(fleet_server.port)
    try:
        region.poll_round()
        _fleet_poll(hstate)
        before = obs_metrics.FLEET_INVENTORY_NOT_MODIFIED.value()
        resync_before = obs_metrics.FLEET_DELTA_SERVED.value(
            outcome="resync"
        )
        doc = _fleet_poll(hstate)
        assert (
            obs_metrics.FLEET_INVENTORY_NOT_MODIFIED.value() == before + 1
        )
        # An in-sync client is NOT a resync: nothing served, nothing
        # counted.
        assert (
            obs_metrics.FLEET_DELTA_SERVED.value(outcome="resync")
            == resync_before
        )
        assert hstate.mirror.last_changed == set()
        assert doc == hstate.mirror.doc
    finally:
        drop_connection = collector.drop_connection

        drop_connection(hstate)
        fleet_server.close()
        region.close()
        for s in servers:
            s.close()
        for c in coords:
            c.close()


def test_delta_since_ahead_or_off_lineage_forces_full_resync():
    """A client claiming a generation the server never published (a
    lost-state restart artifact) or holding an ETag off the server's
    recorded lineage must get the FULL body — never a wrong delta."""
    coords, servers, targets = _serve_slices(2)
    region = FleetCollector(targets, peer_timeout=0.5)
    fleet_server = _serve_fleet(region)
    hstate = _fleet_client(fleet_server.port)
    try:
        region.poll_round()
        _fleet_poll(hstate)
        gen = region.inventory_payload()["generation"]
        # Ahead of the server, with a stale ETag that matches nothing.
        hstate.mirror.generation = gen + 7
        hstate.etag = '"not-a-real-etag"'
        resync_before = obs_metrics.FLEET_DELTA_SERVED.value(
            outcome="resync"
        )
        doc = _fleet_poll(hstate)
        assert (
            obs_metrics.FLEET_DELTA_SERVED.value(outcome="resync")
            == resync_before + 1
        )
        # Full-body replacement, byte-identical to the server's pane.
        assert hstate.mirror.last_changed is None
        assert hstate.mirror.body == region.inventory_response()[0]
        assert doc["slices"] == region.inventory_payload()["slices"]
        # The serving hook's decision table, directly: inside the
        # window but off-lineage is a resync too.
        body, _ = region.delta_response(gen, '"wrong"')
        assert body == region.inventory_response()[0]
        assert not parse_inventory(body).get("delta")
    finally:
        drop_connection = collector.drop_connection

        drop_connection(hstate)
        fleet_server.close()
        region.close()
        for s in servers:
            s.close()
        for c in coords:
            c.close()


def test_delta_client_missing_a_tombstone_resyncs_byte_identical():
    """The self-verification property: a delta that fails to mention a
    dropped key reconstructs a pane a full-body client would not hold —
    the mirror detects the ETag mismatch, refuses the pane, and the
    full-body resync restores byte-identity."""
    DeltaMirror = fleet.DeltaMirror
    DeltaSyncError = tfp.twin_inventory.DeltaSyncError  # the port raises its twin
    build_delta = fleet.build_delta
    build_inventory = fleet.build_inventory
    serialize_inventory = fleet.serialize_inventory

    e = {"reachable": True, "stale": False}
    base = build_inventory({"s0": e, "s1": e}, 3, False)
    truth = build_inventory({"s0": dict(e, stale=True)}, 4, False)
    truth_body, truth_etag = serialize_inventory(truth)
    mirror = DeltaMirror()
    mirror.apply(base, None)
    # The wire delta SHOULD carry tombstones=["s1"]; this one lost it.
    bad = build_delta(3, 4, False, {"s0": dict(e, stale=True)}, [])
    with pytest.raises(DeltaSyncError):
        mirror.apply(bad, truth_etag)
    # Recovery is the full body — after it, byte-identity holds.
    mirror2 = DeltaMirror()
    mirror2.apply(truth, truth_etag)
    assert mirror2.body == truth_body
    # And the SOUND delta applies cleanly to a fresh mirror on base.
    mirror3 = DeltaMirror()
    mirror3.apply(base, None)
    good = build_delta(3, 4, False, {"s0": dict(e, stale=True)}, ["s1"])
    mirror3.apply(good, truth_etag)
    assert mirror3.body == truth_body
    assert mirror3.last_changed == {"s0", "s1"}


def test_targets_drop_tombstones_across_epoch_rebuild(tmp_path):
    """A slice dropped from the targets file mid-run (the mtime-watch
    reload rebuilds the collector epoch on the same --state-dir) is
    announced to delta clients as a TOMBSTONE riding the persisted
    generation lineage — the client prunes it without a full resync and
    stays byte-identical to a full-body client."""
    coords, servers, targets = _serve_slices(2)
    state_dir = side_dir(os.path.join(str(tmp_path), "state"))
    epoch1 = FleetCollector(
        targets, peer_timeout=0.5, state_dir=state_dir
    )
    server1 = _serve_fleet(epoch1)
    hstate = _fleet_client(server1.port)
    epoch2 = server2 = None
    try:
        epoch1.poll_round()
        _fleet_poll(hstate)
        gen1 = epoch1.inventory_payload()["generation"]
        assert hstate.mirror.generation == gen1
        server1.close()
        epoch1.close()
        # The reload: s1 left the targets file; same state-dir.
        epoch2 = FleetCollector(
            targets[:1], peer_timeout=0.5, state_dir=state_dir
        )
        epoch2.poll_round()
        assert epoch2.inventory_payload()["generation"] > gen1
        server2 = _serve_fleet(epoch2)
        drop_connection = collector.drop_connection

        drop_connection(hstate)
        import http.client

        hstate.port = server2.port
        _connect(hstate)
        delta_before = obs_metrics.FLEET_DELTA_SERVED.value(
            outcome="delta"
        )
        _fleet_poll(hstate)
        # The epoch hop was served as a DELTA (the lineage persisted),
        # s1 arrived as a tombstone, and byte-identity holds.
        assert (
            obs_metrics.FLEET_DELTA_SERVED.value(outcome="delta")
            == delta_before + 1
        )
        assert "s1" in hstate.mirror.last_changed
        assert "s1" not in hstate.mirror.doc["slices"]
        assert hstate.mirror.body == epoch2.inventory_response()[0]
    finally:
        drop_connection = collector.drop_connection

        drop_connection(hstate)
        if server2 is not None:
            server2.close()
        if epoch2 is not None:
            epoch2.close()
        for s in servers:
            s.close()
        for c in coords:
            c.close()


def test_full_body_and_delta_unaware_clients_stay_byte_identical():
    """The backward-compat pin: the delta protocol adds NOTHING to the
    full wire body (same keys, same bytes, delta-capable server or
    not), a delta-unaware client (no ?since) reads today's wire, and a
    garbled ?since is REJECTED with 400 on the query-wired server — it
    must never silently degrade to the full body (a consumer that
    thinks it is delta-polling would re-download the pane every round
    and nobody would notice) — while a query-unaware server ignores
    the query string entirely, the historical wire."""
    coords, servers, targets = _serve_slices(2)
    region = FleetCollector(targets, peer_timeout=0.5)
    plain = FleetCollector(targets, peer_timeout=0.5, delta_window=0)
    delta_server = _serve_fleet(region)
    plain_server = _serve_fleet(plain, delta=False)
    try:
        region.poll_round()
        plain.poll_round()
        body, etag = region.inventory_response()
        doc = parse_inventory(body)
        # The schema-1 key set, exactly — no delta vocabulary on the full
        # wire (per-entry generations stay INTERNAL).
        assert set(doc) == {
            "schema", "peer_schema", "generation", "restored", "slices"
        }
        # A delta-window=0 / delta-unwired server serves the same body
        # a delta-capable one does (the fixtures scrape identical
        # fleets; the quantized stamps agree inside one quantum).
        assert plain.inventory_response()[0] == body
        # Delta-unaware GET (no query) on the delta-capable server.
        status, wire = http_get(
            f"http://127.0.0.1:{delta_server.port}/fleet/snapshot"
        )
        assert (status, wire) == (200, body)
        # Garbled ?since on the query-wired server: 400, both
        # malformations (both directions — a valid
        # since still answers below, a garbled one never serves).
        status, wire = http_get(
            f"http://127.0.0.1:{delta_server.port}/fleet/snapshot"
            "?since=banana"
        )
        assert status == 400
        status, wire = http_get(
            f"http://127.0.0.1:{delta_server.port}/fleet/snapshot"
            "?since=-3"
        )
        assert status == 400
        # ...while the same garbled query on a query-UNWIRED server is
        # ignored wholesale: full body, 200 (the historical wire).
        status, wire = http_get(
            f"http://127.0.0.1:{plain_server.port}/fleet/snapshot"
            "?since=banana"
        )
        assert (status, wire) == (200, body)
        # ?since on a server whose window is 0: full body (delta
        # serving disabled, never an error).
        body0, _ = plain.delta_response(0, etag)
        assert body0 == body
    finally:
        delta_server.close()
        plain_server.close()
        region.close()
        plain.close()
        for s in servers:
            s.close()
        for c in coords:
            c.close()


def test_federation_hop_rides_deltas_and_stays_identical():
    """The root's region scrape is delta-aware end to end: after first
    contact the hop moves O(changed) bodies (regions_changed /
    regions_tombstones included), and the root's merged pane matches
    what a from-scratch root over the same region builds."""
    coords, servers, targets = _serve_slices(3)
    region = FleetCollector(targets, peer_timeout=0.5)
    region_server = _serve_fleet(region)
    root = root2 = None
    try:
        region.poll_round()
        root = _root_over([region_server], names=["r0"])
        root.poll_round()
        # A changed slice: the next root round crosses the hop as a
        # delta, not a full region body.
        changed_labels = dict(LEADER_LABELS)
        changed_labels["google.com/tpu.slice.sick-chips"] = "2"
        changed_labels["google.com/tpu.chips.healthy"] = "2"
        changed_labels["google.com/tpu.chips.sick"] = "2"
        coords[1].publish_local(changed_labels, "full")
        region.poll_round()
        d_before = obs_metrics.FLEET_DELTA_POLLS.value(kind="delta")
        changed = root.poll_round()
        assert (
            obs_metrics.FLEET_DELTA_POLLS.value(kind="delta")
            == d_before + 1
        )
        assert changed == {"region/r0/s1"}
        # Identity: a fresh root (full-body first contact) over the
        # same region serves the delta-built root's exact entries.
        root2 = _root_over([region_server], names=["r0"])
        root2.poll_round()
        assert (
            root.inventory_payload()["slices"]
            == root2.inventory_payload()["slices"]
        )
    finally:
        if root2 is not None:
            root2.close()
        if root is not None:
            root.close()
        region_server.close()
        region.close()
        for s in servers:
            s.close()
        for c in coords:
            c.close()


def test_ha_incremental_divergence_matches_full_walk():
    """The standby's divergence gauge maintained O(changed) equals the
    full-walk truth through agree/split/heal transitions, and the
    mirror poll itself rides the delta protocol."""
    HaMonitor = fleet.HaMonitor
    entries_divergence = tfp.ha.entries_divergence

    coords, servers, targets = _serve_slices(3)
    active = FleetCollector(targets, peer_timeout=0.5)
    active_server = _serve_fleet(active)
    # The standby watches only 2 of the 3 slices: a persistent split.
    standby = FleetCollector(targets[:2], peer_timeout=0.5)
    ha = HaMonitor(
        [f"127.0.0.1:{active_server.port}", "standby:9102"],
        "standby:9102",
        peer_timeout=0.5,
    )
    try:
        active.poll_round()
        changed = standby.poll_round()
        own = standby.inventory_payload()["slices"]
        assert ha.observe_round(own, own_changed=changed) == "standby"
        mirrored = ha._seniors[0][1].last_snapshot["slices"]
        assert ha.divergence == entries_divergence(own, mirrored) == 1
        # An idle round: the incremental path (both changed-sets empty)
        # keeps the verdict without re-walking.
        changed = standby.poll_round()
        assert changed == set()
        assert ha.observe_round(own, own_changed=changed) == "standby"
        assert ha.divergence == 1
        d_polls = obs_metrics.FLEET_DELTA_POLLS.value(kind="delta")
        # The split deepens: a shared slice's verdict moves and the
        # ACTIVE scrapes it while the standby's round misses (its pane
        # holds the old verdict) — the mirror hop carries the move as a
        # delta and the incremental divergence picks it up.
        changed_labels = dict(LEADER_LABELS)
        changed_labels["google.com/tpu.slice.healthy-hosts"] = "1"
        changed_labels["google.com/tpu.slice.degraded"] = "true"
        coords[0].publish_local(changed_labels, "full")
        active.poll_round()
        assert ha.observe_round(own, own_changed=set()) == "standby"
        assert (
            obs_metrics.FLEET_DELTA_POLLS.value(kind="delta")
            == d_polls + 1
        )
        mirrored = ha._seniors[0][1].last_snapshot["slices"]
        assert ha.divergence == entries_divergence(own, mirrored) == 2
        # The standby catches up on its next round: the shared slice
        # heals and divergence falls back to the structural 1 through
        # the incremental path.
        changed = standby.poll_round()
        assert changed == {"s0"}
        own = standby.inventory_payload()["slices"]
        assert ha.observe_round(own, own_changed=changed) == "standby"
        mirrored = ha._seniors[0][1].last_snapshot["slices"]
        assert ha.divergence == entries_divergence(own, mirrored) == 1
        assert (
            obs_metrics.FLEET_HA_DIVERGENCE.value() == ha.divergence
        )
    finally:
        ha.close()
        standby.close()
        active_server.close()
        active.close()
        for s in servers:
            s.close()
        for c in coords:
            c.close()


# ---------------------------------------------------------------------------
# the port's entry point: no torch, no jax, no yaml; the README's flags
# ---------------------------------------------------------------------------

_HEAVY = ("torch", "jax", "jaxlib", "yaml", "gpu_feature_discovery_tpu")


def _imported_top_level(importtime_stderr):
    """The top-level packages a ``python -X importtime`` run imported."""
    names = set()
    for line in importtime_stderr.splitlines():
        if line.startswith("import time:") and "|" in line:
            names.add(line.rsplit("|", 1)[1].strip().split(".")[0])
    return names


def test_fleet_collector_help_loads_no_torch_jax_or_yaml():
    proc = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", "gpu_feature_discovery_tpu_torch",
         "fleet-collector", "--help"],
        capture_output=True, text=True, timeout=60, cwd=REPO,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    for fd in tfp.port_cmd_fleet.FLEET_FLAG_DEFS:
        assert f"--{fd.name}" in proc.stdout
    imported = _imported_top_level(proc.stderr)
    assert "gpu_feature_discovery_tpu_torch" in imported
    assert not imported & set(_HEAVY), sorted(imported & set(_HEAVY))


def test_fleet_collector_epoch_loads_no_torch_jax_or_yaml(tmp_path):
    """One in-process collector epoch in a fresh interpreter: it scrapes
    rounds, confirms its unreachable target stale, exits on SIGTERM, and
    neither torch, jax nor yaml is loaded at any point."""
    targets = tmp_path / "targets.json"
    targets.write_text(json.dumps(
        {"version": "v1", "slices": [{"name": "s0", "hosts": ["127.0.0.1:1"]}]}))
    code = f"""
import json, queue, signal, sys, threading, time, urllib.request
from gpu_feature_discovery_tpu_torch.cmd import fleet
from gpu_feature_discovery_tpu_torch.fleet.targets import parse_targets_file
from gpu_feature_discovery_tpu_torch.obs import metrics

values = fleet.resolve_flags({{"targets-file": {str(targets)!r}, "scrape-interval": "0.1s",
                               "metrics-addr": "127.0.0.1", "metrics-port": "0",
                               "peer-timeout": "0.2s"}}, environ={{}})
sigs = queue.Queue()
out = {{}}
t = threading.Thread(target=lambda: out.update(d=fleet.run_epoch(
    values, parse_targets_file(values["targets-file"]), sigs)), daemon=True)
t.start()
deadline = time.monotonic() + 20
while metrics.FLEET_SCRAPE_ROUNDS.value() < 2 and time.monotonic() < deadline:
    time.sleep(0.02)
rounds, stale = metrics.FLEET_SCRAPE_ROUNDS.value(), metrics.FLEET_SLICES_STALE.value()
sigs.put(signal.SIGTERM)
t.join(10)
heavy = sorted(m for m in sys.modules if m.split(".")[0] in {_HEAVY!r})
print(json.dumps({{"decision": out.get("d"), "rounds": rounds, "stale": stale,
                  "heavy": heavy}}))
"""
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=60, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-2000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["decision"] == "shutdown"
    assert got["rounds"] >= 2 and got["stale"] == 1
    assert got["heavy"] == []


def test_readme_documents_every_collector_flag():
    """Drift guard: the README's port section names every flag of the
    port's collector table, with its environment variable."""
    readme = (REPO / "README.md").read_text()
    section = readme[readme.index("## PyTorch/CUDA port"):readme.index("## Beyond the reference")]
    for fd in tfp.port_cmd_fleet.FLEET_FLAG_DEFS:
        assert f"`--{fd.name}`" in section, fd.name
        for env in fd.env_vars:
            assert f"`{env}`" in section, (fd.name, env)
