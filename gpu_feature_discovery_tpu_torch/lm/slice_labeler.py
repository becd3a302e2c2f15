"""Slice-scoped labels from the peer coordination layer (twin:
``gpu_feature_discovery_tpu/lm/slice_labeler.py``).

The node-local labelers answer "is THIS node schedulable"; a group of
GPU hosts that runs one job is schedulable only as a WHOLE, and one dead
host strands the others behind healthy-looking node labels. The peering
coordinator (peering/coordinator.py) polls every peer's
``/peer/snapshot`` each cycle; this module turns its aggregate view into
the ``nvidia.com/gpu.slice.*`` coordination family (the twin's
``google.com/tpu.slice.*`` under the port's key rule):

- The **leader** (the lowest worker id among *reachable* members, so
  leader death fails over with no election) publishes
  ``slice.healthy-hosts``, ``slice.total-hosts``, ``slice.degraded``,
  ``slice.sick-chips`` (the sum of every reachable peer's
  ``chips.sick``), ``slice.leader`` and ``slice.role=leader``.
- **Followers** publish ``slice.role=follower`` and
  ``slice.leader-seen=true|false``: a follower that cannot reach its
  leader, or any peer at all, says so on its own node.
- Under ``--cohort-size`` every member adds ``slice.cohort``, a cohort's
  leader says ``slice.role=cohort-leader``, and the slice leader adds
  ``slice.cohorts`` and one ``slice.cohort.<i>.degraded`` per cohort
  whose leadership chain is dark.

An unreachable peer degrades the SLICE labels, never the node's own: the
slice source is one more engine source, offloaded, so a slow poll round
is bounded by the engine's per-labeler deadline and served from the
last-good cache. The node fact ``nvidia.com/gpu.slice.capable``
(lm/versions.py) is not of this family.
"""

from __future__ import annotations

from gpu_feature_discovery_tpu_torch.lm.engine import LabelSource
from gpu_feature_discovery_tpu_torch.lm.labels import Labels, label_safe_value

SLICE_ROLE_LABEL = "nvidia.com/gpu.slice.role"
SLICE_LEADER_LABEL = "nvidia.com/gpu.slice.leader"
SLICE_LEADER_SEEN_LABEL = "nvidia.com/gpu.slice.leader-seen"
SLICE_HEALTHY_HOSTS_LABEL = "nvidia.com/gpu.slice.healthy-hosts"
SLICE_TOTAL_HOSTS_LABEL = "nvidia.com/gpu.slice.total-hosts"
SLICE_DEGRADED_LABEL = "nvidia.com/gpu.slice.degraded"
SLICE_SICK_CHIPS_LABEL = "nvidia.com/gpu.slice.sick-chips"
# Two-tier coordination (--cohort-size > 0): every member publishes its
# cohort index; the slice leader adds the cohort count and one degraded
# marker per cohort served by the direct-poll fallback.
SLICE_COHORT_LABEL = "nvidia.com/gpu.slice.cohort"
SLICE_COHORTS_LABEL = "nvidia.com/gpu.slice.cohorts"
# Dynamic family: nvidia.com/gpu.slice.cohort.<i>.degraded. No node-local
# label lives under this prefix.
SLICE_COHORT_PREFIX = "nvidia.com/gpu.slice.cohort."

# The whole coordination family, for snapshot stripping: a peer's
# snapshot carries its NODE facts, never slice labels an earlier round
# derived from other peers (one stale aggregate would echo around the
# slice). A consumer that filters by line prefix relies on
# SLICE_COHORT_LABEL also prefix-matching SLICE_COHORTS_LABEL and the
# SLICE_COHORT_PREFIX family; exact-key consumers pair this tuple with
# is_cohort_label().
SLICE_COORD_LABELS = (
    SLICE_ROLE_LABEL,
    SLICE_LEADER_LABEL,
    SLICE_LEADER_SEEN_LABEL,
    SLICE_HEALTHY_HOSTS_LABEL,
    SLICE_TOTAL_HOSTS_LABEL,
    SLICE_DEGRADED_LABEL,
    SLICE_SICK_CHIPS_LABEL,
    SLICE_COHORT_LABEL,
    SLICE_COHORTS_LABEL,
)


def cohort_degraded_label(index: int) -> str:
    return f"{SLICE_COHORT_PREFIX}{int(index)}.degraded"


def is_cohort_label(key: str) -> bool:
    """True for any member of the dynamic cohort label family."""
    return key.startswith(SLICE_COHORT_PREFIX)


def slice_labels(view) -> Labels:
    """The label set of one aggregation view (peering SliceView). A flat
    view (``view.cohorts`` 0, the default) renders the single-tier
    family; a hierarchical one adds the cohort rows and the
    ``cohort-leader`` role."""
    labels = Labels()
    hierarchical = getattr(view, "cohorts", 0) > 0
    if view.role == "leader":
        labels[SLICE_ROLE_LABEL] = "leader"
        labels[SLICE_LEADER_LABEL] = label_safe_value(view.leader_hostname)
        labels[SLICE_HEALTHY_HOSTS_LABEL] = str(view.healthy_hosts)
        labels[SLICE_TOTAL_HOSTS_LABEL] = str(view.total_hosts)
        labels[SLICE_DEGRADED_LABEL] = "true" if view.degraded else "false"
        labels[SLICE_SICK_CHIPS_LABEL] = str(view.sick_chips)
        if hierarchical:
            labels[SLICE_COHORTS_LABEL] = str(view.cohorts)
            for index in view.degraded_cohorts:
                # Marked only while degraded: a per-cohort "false" row on
                # every healthy slice would be churn.
                labels[cohort_degraded_label(index)] = "true"
    else:
        labels[SLICE_ROLE_LABEL] = (
            "cohort-leader" if view.role == "cohort-leader" else "follower"
        )
        labels[SLICE_LEADER_SEEN_LABEL] = "true" if view.leader_seen else "false"
    if hierarchical:
        labels[SLICE_COHORT_LABEL] = str(view.cohort)
    return labels


def new_slice_label_source(coordinator) -> LabelSource:
    """The coordinator as a named engine source. Offloaded: a poll round
    does peer HTTP I/O, so it runs on the pool under the per-labeler
    deadline, and a miss serves the last-good slice labels instead of
    stalling the node-local sources."""
    return LabelSource("slice", lambda: coordinator, offload=True)
