"""The fleet collector's targets file (twin:
``gpu_feature_discovery_tpu/fleet/targets.py``): which slices, or, at
the federation root tier, which regions' collectors, to scrape.

The twin parses with ``yaml.safe_load``; the port parses with
``config/yaml_subset.py`` (the card machine has no pyyaml), which refuses
what it cannot parse as pyyaml does, so a file either loads to the
twin's targets or fails the load.

A static, versioned YAML/JSON document — deliberately the same
parse-or-ConfigError discipline as the daemon config file
(config/spec.parse_config_file): a typo must fail the load loudly, never
silently shrink the fleet the collector watches. The file is stat-triple
watch reloaded (cmd/fleet.py reuses cmd/events.ConfigFileWatcher, which
fingerprints mtime_ns + size + inode — a rewrite landing within the same
second, exactly what config-management tools produce, still fires the
reload), so adding a slice is an edit, not a restart.

Document shape::

    version: v1
    slices:
      - name: slice-a
        hosts: ["10.0.0.1:9101", "10.0.0.2:9101", "10.0.0.3:9101"]
      - name: slice-b
        hosts: ["10.0.1.1:9101", "10.0.1.2:9101"]

``hosts`` is the slice's worker list in WORKER-ID ORDER (the same order
``WORKER_HOSTNAMES`` gives the daemons): the collector polls the first
``COHORT_LEADER_CHAIN`` entries as the slice's leadership chain — the
derived leader is the lowest reachable worker-id, so the chain walk
finds it exactly like the cohort tier's chain probe does. Entries may
carry an explicit ``:port``; bare hosts default to ``default_port``
(the collector's ``--peer-timeout`` sibling flag surface, cmd/fleet.py).

Under ``--upstream-mode=collectors`` the grammar is UNCHANGED but the
vocabulary shifts one tier up: each entry names a REGION and its
``hosts`` are that region's fleet collectors in failover order (an HA
pair is a natural 2-deep chain) — the root walks them exactly like a
leadership chain, over ``/fleet/snapshot``::

    version: v1
    slices:
      - name: us-east
        hosts: ["collector-a.us-east:9102", "collector-b.us-east:9102"]
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

from gpu_feature_discovery_tpu_torch.config import yaml_subset
from gpu_feature_discovery_tpu_torch.config.spec import ConfigError
from gpu_feature_discovery_tpu_torch.peering.cohort import COHORT_LEADER_CHAIN

TARGETS_VERSION = "v1"

# A slice name becomes a JSON object key on /fleet/snapshot and a file
# path component is never built from it — but it still must be printable
# and bounded so a corrupt file cannot smuggle junk into the inventory.
_MAX_NAME_LEN = 128


@dataclass(frozen=True)
class SliceTarget:
    """One slice the collector scrapes. ``hosts`` is the full worker
    list (worker-id order); ``chain`` is the leadership-chain prefix the
    collector actually polls."""

    name: str
    hosts: Tuple[str, ...]

    @property
    def chain(self) -> Tuple[str, ...]:
        return self.hosts[:COHORT_LEADER_CHAIN]


def parse_targets_file(path: str) -> List[SliceTarget]:
    """Parse + validate one targets file; ConfigError on anything the
    collector cannot trust (unreadable, wrong version, malformed entry,
    duplicate slice name)."""
    try:
        with open(path) as f:
            raw = yaml_subset.safe_load(f.read()) or {}
    except OSError as e:
        raise ConfigError(f"error opening targets file: {e}") from e
    except (UnicodeDecodeError, yaml_subset.YamlSubsetError) as e:
        raise ConfigError(f"targets unmarshal error: {e}") from e
    if not isinstance(raw, dict):
        raise ConfigError(
            f"targets file must contain a mapping, got {type(raw).__name__}"
        )
    version = raw.get("version") or TARGETS_VERSION
    if version != TARGETS_VERSION:
        raise ConfigError(f"unknown targets version: {version}")
    slices = raw.get("slices")
    if not isinstance(slices, list):
        raise ConfigError("targets file must carry a 'slices' list")
    out: List[SliceTarget] = []
    seen = set()
    for i, entry in enumerate(slices):
        if not isinstance(entry, dict):
            raise ConfigError(f"slices[{i}] must be a mapping")
        name = entry.get("name")
        if not isinstance(name, str) or not name.strip():
            raise ConfigError(f"slices[{i}] needs a non-empty 'name'")
        name = name.strip()
        if len(name) > _MAX_NAME_LEN:
            raise ConfigError(
                f"slices[{i}] name exceeds {_MAX_NAME_LEN} chars"
            )
        if name in seen:
            raise ConfigError(f"duplicate slice name {name!r}")
        seen.add(name)
        hosts = entry.get("hosts")
        if not isinstance(hosts, list) or not hosts:
            raise ConfigError(
                f"slice {name!r} needs a non-empty 'hosts' list"
            )
        cleaned = []
        for host in hosts:
            if not isinstance(host, str) or not host.strip():
                raise ConfigError(
                    f"slice {name!r} has a non-string/empty host entry"
                )
            cleaned.append(host.strip())
        out.append(SliceTarget(name=name, hosts=tuple(cleaned)))
    return out
