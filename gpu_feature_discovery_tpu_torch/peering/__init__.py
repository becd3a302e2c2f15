"""Cross-host slice coordination, the peer layer (twin:
``gpu_feature_discovery_tpu/peering/``).

Each daemon of a group of GPU hosts (a slice) serves its marker-stripped
label snapshot as JSON at ``GET /peer/snapshot`` on its introspection
server (peering/snapshot.py); a deterministic leader, the lowest worker
id among *reachable* peers, polls the others each cycle and publishes
the ``nvidia.com/gpu.slice.*`` family from the aggregate
(peering/coordinator.py, lm/slice_labeler.py). ``--slice-coordination``
``auto`` is on when ``WORKER_HOSTNAMES`` names 2+ workers and the
introspection server is enabled (peering/worker_env.py). Stdlib HTTP on
both sides.
"""

from gpu_feature_discovery_tpu_torch.peering.coordinator import (
    CONFIRM_POLLS,
    SliceCoordinator,
    SliceView,
    new_slice_coordinator,
)
from gpu_feature_discovery_tpu_torch.peering.snapshot import (
    PEER_SCHEMA_VERSION,
    PEER_SNAPSHOT_PATH,
    PeerSnapshotError,
    build_snapshot,
    parse_snapshot,
    strip_snapshot_labels,
)

__all__ = [
    "CONFIRM_POLLS",
    "PEER_SCHEMA_VERSION",
    "PEER_SNAPSHOT_PATH",
    "PeerSnapshotError",
    "SliceCoordinator",
    "SliceView",
    "build_snapshot",
    "new_slice_coordinator",
    "parse_snapshot",
    "strip_snapshot_labels",
]
