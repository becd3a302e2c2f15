"""A GPU host's slice facts from its environment (twin:
``gpu_feature_discovery_tpu/hostinfo/tpu_env.py``).

The twin reads a TPU VM's facts from the ``tpu-env`` metadata attribute
or from the ``TPU_*`` variables GKE injects, and accepts the unprefixed
spellings beside them. A GPU node has neither the metadata attribute nor
the ``TPU_*`` variables, so the port reads only the twin's unprefixed
keys, set per pod by whoever deploys the slice:

    WORKER_ID              this host's index in WORKER_HOSTNAMES
    WORKER_HOSTNAMES       comma-separated, in worker-id order
    ACCELERATOR_TYPE       free-form, published as slice.accelerator-type
    TOPOLOGY               the device grid of the whole slice
    CHIPS_PER_HOST_BOUNDS  devices per host per axis, e.g. "2,2,1"
    HOST_BOUNDS            hosts per axis; with the above, the topology
    WRAP                   wraparound per axis, e.g. "true,true,false"
    MACHINE_TYPE           the precise machine type (gpu.machine)

These are the keys the peer list reads too (peering/worker_env.py), which
shares the hostname parser here. Where the twin falls back to its Cloud
TPU accelerator table (worker count, topology, multi-host from a string
like ``v5p-64``), the port has no table and falls back to nothing; the
twin gets the same for any string that is not a Cloud TPU type.
"""

from __future__ import annotations

import logging
import math
from dataclasses import dataclass, field
from typing import List, Mapping, Optional, Tuple

log = logging.getLogger("tfd.hostinfo")


@dataclass
class HostInfo:
    """Slice facts derivable from local configuration alone: each worker
    labels its own node without talking to its peers."""

    accelerator_type: str = ""
    topology: str = ""  # device grid of the WHOLE slice
    worker_id: Optional[int] = None
    worker_count: Optional[int] = None
    worker_hostnames: List[str] = field(default_factory=list)
    chips_per_host_bounds: str = ""  # e.g. "2,2,1"
    wrap: Tuple[bool, ...] = ()  # wraparound per axis
    machine_type: str = ""  # raw, as set

    @property
    def multi_host(self) -> bool:
        return self.worker_count is not None and self.worker_count > 1


def host_info_from_mapping(kv: Mapping[str, str]) -> HostInfo:
    """HostInfo from an environment mapping: the unprefixed keys of the
    module docstring, and never a ``TPU_*`` one."""
    def get(name: str) -> str:
        v = kv.get(name)
        return v.strip() if v else ""

    info = HostInfo(machine_type=kv.get("MACHINE_TYPE") or "")
    info.accelerator_type = get("ACCELERATOR_TYPE").lower()
    info.topology = get("TOPOLOGY").lower()
    info.chips_per_host_bounds = get("CHIPS_PER_HOST_BOUNDS")

    worker_id = get("WORKER_ID")
    if worker_id.isdigit():
        info.worker_id = int(worker_id)

    hostnames = get("WORKER_HOSTNAMES")
    if hostnames:
        info.worker_hostnames = parse_worker_hostnames(hostnames)
        if info.worker_hostnames:
            info.worker_count = len(info.worker_hostnames)
    if (
        info.worker_id is not None
        and info.worker_hostnames
        and info.worker_id >= len(info.worker_hostnames)
    ):
        # The id stays published (it is this host's own fact), but a list
        # that does not hold it would attribute another worker's hostname
        # to this one.
        log.warning(
            "worker_id %d is out of range for WORKER_HOSTNAMES "
            "(%d entries after cleanup) — hostname list and worker id "
            "disagree; slice-global facts may be wrong",
            info.worker_id,
            len(info.worker_hostnames),
        )

    host_bounds = get("HOST_BOUNDS")
    if info.worker_count is None and host_bounds:
        dims = _parse_bounds(host_bounds)
        if dims:
            info.worker_count = math.prod(dims)

    wrap = get("WRAP")
    if wrap:
        info.wrap = tuple(w.strip().lower() == "true" for w in wrap.split(","))

    # The slice topology from the bounds when it is not given: hosts x
    # devices per host, axis by axis.
    if not info.topology and host_bounds and info.chips_per_host_bounds:
        hb = _parse_bounds(host_bounds)
        cb = _parse_bounds(info.chips_per_host_bounds)
        if hb and cb and len(hb) == len(cb):
            info.topology = "x".join(str(h * c) for h, c in zip(hb, cb))
    return info


def parse_worker_hostnames(raw: str) -> List[str]:
    """Clean the comma-separated hostname list: whitespace stripped,
    empty entries dropped, duplicates removed with the FIRST occurrence
    keeping its position (the order is the worker-id indexing and the
    leadership order). A duplicate is warned about: two workers sharing
    one entry means the environment is corrupt."""
    seen = set()
    cleaned: List[str] = []
    duplicates: List[str] = []
    for entry in raw.split(","):
        host = entry.strip()
        if not host:
            continue
        if host in seen:
            duplicates.append(host)
            continue
        seen.add(host)
        cleaned.append(host)
    if duplicates:
        log.warning(
            "WORKER_HOSTNAMES carries duplicate entries %s; "
            "keeping first occurrences (%d unique of the raw list)",
            sorted(set(duplicates)),
            len(cleaned),
        )
    return cleaned


def _parse_bounds(bounds: str) -> Optional[Tuple[int, ...]]:
    """"2,2,1" -> (2, 2, 1); "2x2x1" too."""
    sep = "," if "," in bounds else "x"
    try:
        dims = tuple(int(p) for p in bounds.split(sep))
    except ValueError:
        return None
    if not dims or any(d <= 0 for d in dims):
        return None
    return dims
