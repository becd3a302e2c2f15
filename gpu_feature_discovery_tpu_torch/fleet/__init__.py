"""Fleet aggregation service (twin: ``gpu_feature_discovery_tpu/fleet/``):
an out-of-cluster collector over the slice coordination plane's
``/peer/snapshot`` surface. The package imports no torch: the collector
has no device, and maps neither CUDA nor NVML.

The reference GFD stops at the node boundary; the peering layer stops
at the slice. This package is the next consumer tier up: a long-running
collector (``python -m gpu_feature_discovery_tpu_torch fleet-collector``,
cmd/fleet.py) scrapes the slice LEADERS' stable,
versioned, ETag-cached ``/peer/snapshot`` endpoints across many slices
— walking each slice's 3-deep leadership chain exactly like the cohort
tier — and serves the aggregated fleet inventory as schema-versioned
JSON at ``GET /fleet/snapshot`` with the same publish-time
serialization / strong-ETag / 304 machinery the peer surface uses, so
one operator pane answers "which slices are schedulable right now".

Because ``/fleet/snapshot`` carries the same schema-versioned,
ETag-cached discipline as the surface it aggregates, the tier RECURSES:
``--upstream-mode=collectors`` points the same collector at region
collectors instead of slice leaders (``collector.py`` federation — the
ROOT tier, entries merged under ``region/<name>/<slice>`` keys, a dark
region served degraded-stale), and ``ha.py`` pairs collectors behind one
Service with role-by-re-derivation and a standby mirror — no election
protocol at any tier of this system.

- ``targets.py`` — the static targets file (target name -> host list;
  slices, or regions at the root tier), stat-triple watch reloaded
  through cmd/events.ConfigFileWatcher.
- ``inventory.py`` — the ``/fleet/snapshot`` wire schema (full body
  AND the ``?since=<generation>`` delta document, with DeltaMirror as
  the client-side reconstruction), plus the ``--state-dir``
  persistence so a collector restart serves ``restored`` data
  immediately (per-region at the root tier) and resumes its delta
  lineage instead of forcing every client through a full resync.
- ``collector.py`` — the poller: bounded concurrent rounds
  (utils/fanout), persistent keep-alive connections with
  If-None-Match/304 polling per target, 2-consecutive-miss confirmation
  with confirmed-dead backoff, leader-chain failover per slice (chain
  failover per region at the root tier).
- ``ha.py`` — the no-election HA monitor: role derived from the shared
  ordered --ha-peers list, standby mirror of the active's
  /fleet/snapshot, split-pane divergence gauge.
"""

from gpu_feature_discovery_tpu_torch.fleet.collector import FleetCollector
from gpu_feature_discovery_tpu_torch.fleet.ha import HaMonitor, parse_ha_peers
from gpu_feature_discovery_tpu_torch.fleet.inventory import (
    FLEET_SCHEMA_VERSION,
    FLEET_SNAPSHOT_PATH,
    DeltaMirror,
    DeltaSyncError,
    InventoryStore,
    build_delta,
    build_inventory,
    parse_inventory,
    parse_inventory_or_delta,
    serialize_inventory,
)
from gpu_feature_discovery_tpu_torch.fleet.targets import (
    SliceTarget,
    parse_targets_file,
)

__all__ = [
    "FLEET_SCHEMA_VERSION",
    "FLEET_SNAPSHOT_PATH",
    "DeltaMirror",
    "DeltaSyncError",
    "FleetCollector",
    "HaMonitor",
    "InventoryStore",
    "SliceTarget",
    "build_delta",
    "build_inventory",
    "parse_ha_peers",
    "parse_inventory",
    "parse_inventory_or_delta",
    "parse_targets_file",
    "serialize_inventory",
]
