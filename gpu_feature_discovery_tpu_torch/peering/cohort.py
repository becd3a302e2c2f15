"""Cohort partitioning for the two-tier coordination plane (twin:
``gpu_feature_discovery_tpu/peering/cohort.py``).

Every function here is a PURE function of ``(hostname count, cohort
size)``: every slice member must derive the identical partition from the
``WORKER_HOSTNAMES`` list alone, independent of its own worker id and of
its current reachability view, or two members could disagree about who
aggregates whom and the no-election failover would collapse.

Cohorts are FIXED contiguous id ranges (worker ``w`` belongs to cohort
``w // size``): membership never moves when hosts die, only leadership
within a cohort re-derives, so a flapping host can reshape at most its
own cohort's leadership, never the partition.
"""

from __future__ import annotations

from typing import Tuple

from gpu_feature_discovery_tpu_torch.config.spec import parse_cohort_size

__all__ = [
    "AUTO_COHORT_SIZE",
    "COHORT_LEADER_CHAIN",
    "chain_ids",
    "cohort_index",
    "cohort_partition",
    "parse_cohort_size",
    "resolve_cohort_size",
]

# ``--cohort-size=auto`` resolves to this size exactly when the slice is
# larger than it; smaller slices stay flat (one tier is simpler, and the
# flat round is already about one peer timeout at that size).
AUTO_COHORT_SIZE = 64

# How many of a cohort's lowest worker ids form its LEADERSHIP CHAIN: the
# candidates the slice leader polls for the cohort's derived leader. Three
# deep means two simultaneous leader deaths in one cohort still resolve
# without the direct-poll fallback; a chain with every member dark marks
# the cohort degraded instead.
COHORT_LEADER_CHAIN = 3


def resolve_cohort_size(raw, total_hosts: int) -> int:
    """The effective cohort size for a slice of ``total_hosts``: 0 means
    flat. ``auto`` = AUTO_COHORT_SIZE when the slice exceeds it, else
    flat; an explicit size that yields a single cohort (>= total hosts) is
    flat too: one cohort IS the flat topology."""
    s = parse_cohort_size(raw if raw is not None else "0")
    if s == "auto":
        return AUTO_COHORT_SIZE if total_hosts > AUTO_COHORT_SIZE else 0
    size = int(s)
    if size == 0 or size >= total_hosts:
        return 0
    return size


def cohort_partition(total_hosts: int, size: int) -> Tuple[Tuple[int, ...], ...]:
    """Fixed contiguous partition of worker ids 0..total_hosts-1 into
    cohorts of ``size`` (the last may be smaller). ``size`` 0, or a single
    resulting cohort, returns () — the flat topology."""
    if size <= 0 or total_hosts <= size:
        return ()
    cohorts = tuple(
        tuple(range(start, min(start + size, total_hosts)))
        for start in range(0, total_hosts, size)
    )
    return cohorts if len(cohorts) > 1 else ()


def cohort_index(worker_id: int, size: int) -> int:
    if size <= 0:
        raise ValueError("cohort_index needs a positive cohort size")
    return worker_id // size


def chain_ids(cohort: Tuple[int, ...]) -> Tuple[int, ...]:
    """The cohort's leadership chain: its COHORT_LEADER_CHAIN lowest
    worker ids (the whole cohort when smaller)."""
    return tuple(cohort[:COHORT_LEADER_CHAIN])
