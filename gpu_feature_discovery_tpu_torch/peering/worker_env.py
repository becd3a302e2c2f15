"""Where a GPU daemon finds its slice peers: ``WORKER_HOSTNAMES`` and
``WORKER_ID``.

The twin reads its peer list from the TPU VM's ``TPU_WORKER_HOSTNAMES``
and ``TPU_WORKER_ID`` (``gpu_feature_discovery_tpu/hostinfo/tpu_env.py``
``host_info_from_mapping``), which a GPU node does not have. The port
reads the twin's own unprefixed aliases of those two variables,
``WORKER_HOSTNAMES`` (comma-separated, in worker-id order, an entry
``host`` or ``host:port``) and ``WORKER_ID`` (this host's index in that
list), set per pod by whoever deploys the slice (a StatefulSet's ordinal,
a job launcher). Nothing else is consulted: no metadata server, no
``TPU_*`` name.

The list is cleaned as the twin cleans it (``parse_worker_hostnames``,
shared with hostinfo/gpu_env.py):
whitespace stripped, blanks dropped, duplicates warned about with the
first occurrence keeping its place, since the order is the worker-id
indexing and the leadership order.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass, field
from typing import List, Mapping, Optional

# The hostname list is cleaned by the parser the interconnect labeler's
# host facts use (hostinfo/gpu_env.py), so the two never disagree.
from gpu_feature_discovery_tpu_torch.hostinfo.gpu_env import parse_worker_hostnames

log = logging.getLogger("tfd.peering")

WORKER_HOSTNAMES_ENV = "WORKER_HOSTNAMES"
WORKER_ID_ENV = "WORKER_ID"


@dataclass
class WorkerEnv:
    """This host's place in its slice (the two fields of the twin's
    HostInfo that the coordinator reads)."""

    worker_id: Optional[int] = None
    worker_hostnames: List[str] = field(default_factory=list)


def worker_env_from_mapping(env: Mapping[str, str]) -> WorkerEnv:
    """The WorkerEnv of an environment mapping. An id that does not index
    the cleaned list is kept, with a warning; the coordinator refuses to
    run on it."""
    info = WorkerEnv()
    worker_id = (env.get(WORKER_ID_ENV) or "").strip()
    if worker_id.isdigit():
        info.worker_id = int(worker_id)
    hostnames = (env.get(WORKER_HOSTNAMES_ENV) or "").strip()
    if hostnames:
        info.worker_hostnames = parse_worker_hostnames(hostnames)
    if (
        info.worker_id is not None
        and info.worker_hostnames
        and info.worker_id >= len(info.worker_hostnames)
    ):
        log.warning(
            "worker_id %d is out of range for WORKER_HOSTNAMES "
            "(%d entries after cleanup) — hostname list and worker id "
            "disagree; slice-global facts may be wrong",
            info.worker_id,
            len(info.worker_hostnames),
        )
    return info


def discover_worker_env() -> WorkerEnv:
    """This process's WorkerEnv, from its environment."""
    return worker_env_from_mapping(os.environ)
