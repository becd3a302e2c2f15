"""The peer snapshot wire schema, ``GET /peer/snapshot`` (twin:
``gpu_feature_discovery_tpu/peering/snapshot.py``).

Versioned JSON, one document per poll: the peer layer's whole wire
surface, the twin's schema byte for byte, so a port daemon and a twin
daemon parse each other's documents. A peer answering with another
``schema`` counts as unreachable (a mixed-version fleet degrades the
slice labels, it never mis-aggregates), and every field the aggregator
reads is validated on parse.

Document shape (schema 1)::

    {
      "schema": 1,
      "worker_id": 3,
      "hostname": "w3",
      "generation": 17,          # DISTINCT publishes this epoch
      "mode": "full",            # full | degraded | reserved | restored
      "labels": {"nvidia.com/gpu.count": "1", ...},
      "chips": {"healthy": 1, "sick": 0}   # null when unprobed
    }

A cohort leader (``--cohort-size``) adds its cohort's aggregate under
``"cohort"`` (``{schema, index, members: {"<id>": {reachable,
generation, sick, mode}}}``), and the slice leader mirrors its published
verdict under ``"slice"`` (``{schema, leader, healthy_hosts,
total_hosts, degraded, sick_chips}``). Each section has its own schema
counter and is ABSENT (not null) where it does not apply, so a flat
follower's document is plain schema 1.

``labels`` is the daemon's last WRITTEN label set with the status
markers and the ``slice.*`` coordination family removed: a snapshot
carries the node's own facts. ``chips`` pre-extracts the per-device
health verdict (lm/health.py ``chips.healthy``/``chips.sick``) so the
leader's sick-chip sum does not re-parse label text.
"""

from __future__ import annotations

import hashlib
import json
from typing import Any, Dict, Optional

# A snapshot never carries advice: peers exchange the underlying verdicts
# and each derives its own advice (actuation/engine.py).
from gpu_feature_discovery_tpu_torch.actuation.engine import ADVICE_LABELS

PEER_SCHEMA_VERSION = 1
PEER_SNAPSHOT_PATH = "/peer/snapshot"

# The embedded cohort-aggregate section's own schema counter (forward-
# rejecting: an unknown one reads as an unreachable cohort leader).
COHORT_SCHEMA_VERSION = 1

# The embedded slice-aggregate section (the slice leader's published
# verdict, mirrored onto the wire for a consumer outside the slice),
# versioned and forward-rejecting like the cohort section.
SLICE_SECTION_SCHEMA_VERSION = 1

# A snapshot is a label set of a few KiB; anything larger is junk.
MAX_SNAPSHOT_BYTES = 256 * 1024

class PeerSnapshotError(ValueError):
    """A peer answered, but not with a valid schema-1 snapshot: counted as
    a failed poll, exactly like not answering."""


class OversizeBodyError(PeerSnapshotError):
    """A body hit the poller's read sentinel (max_bytes + 1): over the
    tier's size cap and never parsed; its own poll outcome, since under
    deltas small bodies are the norm."""


def strip_snapshot_labels(labels: Dict[str, str]) -> Dict[str, str]:
    """The snapshot view of a written label set: status markers out (they
    describe the cycle that wrote them), the slice coordination family
    out, the advice family out."""
    # Deferred: cmd imports peering (the daemon wires the coordinator).
    from gpu_feature_discovery_tpu_torch.cmd.supervisor import (
        DEGRADED_LABEL,
        RESTORED_LABEL,
        UNHEALTHY_CYCLES_LABEL,
    )
    from gpu_feature_discovery_tpu_torch.lm.engine import STALE_SOURCES_LABEL
    from gpu_feature_discovery_tpu_torch.lm.pjrt_family import FAMILY_DEGRADED_LABELS
    from gpu_feature_discovery_tpu_torch.lm.slice_labeler import (
        SLICE_COORD_LABELS,
        is_cohort_label,
    )
    from gpu_feature_discovery_tpu_torch.sandbox.flap import FLAPPING_LABEL

    dropped = {
        DEGRADED_LABEL,
        RESTORED_LABEL,
        UNHEALTHY_CYCLES_LABEL,
        STALE_SOURCES_LABEL,
        FLAPPING_LABEL,
        *FAMILY_DEGRADED_LABELS.values(),
        *SLICE_COORD_LABELS,
        *ADVICE_LABELS,
    }
    # is_cohort_label: the per-index slice.cohort.<i>.degraded markers
    # are a dynamic family no exact-key set can enumerate.
    return {
        k: str(v)
        for k, v in labels.items()
        if k not in dropped and not is_cohort_label(k)
    }


def _chip_verdict(labels: Dict[str, str]) -> Dict[str, Optional[int]]:
    from gpu_feature_discovery_tpu_torch.lm.health import CHIPS_HEALTHY, CHIPS_SICK

    out: Dict[str, Optional[int]] = {}
    for key, label in (("healthy", CHIPS_HEALTHY), ("sick", CHIPS_SICK)):
        raw = labels.get(label)
        try:
            out[key] = int(raw) if raw is not None else None
        except (TypeError, ValueError):
            out[key] = None
    return out


def build_snapshot(
    worker_id: int,
    hostname: str,
    labels: Dict[str, str],
    generation: int,
    mode: Optional[str],
    cohort: Optional[Dict[str, Any]] = None,
    slice_section: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    stripped = strip_snapshot_labels(labels)
    doc = {
        "schema": PEER_SCHEMA_VERSION,
        "worker_id": int(worker_id),
        "hostname": str(hostname),
        "generation": int(generation),
        "mode": mode,
        "labels": stripped,
        "chips": _chip_verdict(stripped),
    }
    if cohort is not None:
        doc["cohort"] = cohort
    if slice_section is not None:
        doc["slice"] = slice_section
    return doc


def build_slice_section(labels: Dict[str, str]) -> Optional[Dict[str, Any]]:
    """The slice-aggregate section of one WRITTEN label set (before
    stripping): present exactly when the labels say ``slice.role=leader``,
    a restatement of what the leader published, never a separate
    derivation. None elsewhere."""
    from gpu_feature_discovery_tpu_torch.lm.slice_labeler import (
        SLICE_DEGRADED_LABEL,
        SLICE_HEALTHY_HOSTS_LABEL,
        SLICE_LEADER_LABEL,
        SLICE_ROLE_LABEL,
        SLICE_SICK_CHIPS_LABEL,
        SLICE_TOTAL_HOSTS_LABEL,
    )

    if labels.get(SLICE_ROLE_LABEL) != "leader":
        return None

    def _int(key: str) -> Optional[int]:
        raw = labels.get(key)
        try:
            return int(raw) if raw is not None else None
        except (TypeError, ValueError):
            return None

    return {
        "schema": SLICE_SECTION_SCHEMA_VERSION,
        "leader": str(labels.get(SLICE_LEADER_LABEL, "")),
        "healthy_hosts": _int(SLICE_HEALTHY_HOSTS_LABEL),
        "total_hosts": _int(SLICE_TOTAL_HOSTS_LABEL),
        "degraded": labels.get(SLICE_DEGRADED_LABEL) == "true",
        "sick_chips": _int(SLICE_SICK_CHIPS_LABEL),
    }


def build_cohort_aggregate(
    index: int, members: Dict[int, Dict[str, Any]]
) -> Dict[str, Any]:
    """The cohort leader's aggregate section; ``members`` is keyed by int
    worker id here and by its digit string on the wire."""
    return {
        "schema": COHORT_SCHEMA_VERSION,
        "index": int(index),
        "members": {str(wid): dict(entry) for wid, entry in members.items()},
    }


def serialize_snapshot(doc: Dict[str, Any]) -> "tuple[bytes, str]":
    """One document's wire body (indent 2, sorted keys, a trailing
    newline) and its STRONG ETag, the quoted sha256 of those bytes.
    Rendered once per distinct publish and cached: an idle slice's poll
    round exchanges headers, and a matching ``If-None-Match`` is a 304."""
    body = json.dumps(doc, indent=2, sort_keys=True).encode() + b"\n"
    return body, '"' + hashlib.sha256(body).hexdigest() + '"'


def parse_snapshot(body: bytes) -> Dict[str, Any]:
    """Validate one polled snapshot body; PeerSnapshotError on anything
    the aggregator cannot trust."""
    if len(body) > MAX_SNAPSHOT_BYTES:
        raise PeerSnapshotError(
            f"snapshot body {len(body)} bytes exceeds {MAX_SNAPSHOT_BYTES}"
        )
    try:
        doc = json.loads(body.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError, RecursionError) as e:
        # RecursionError: nested past the decoder's limit (the twin lets
        # it escape untyped).
        raise PeerSnapshotError(f"snapshot is not JSON: {e}") from e
    if not isinstance(doc, dict):
        raise PeerSnapshotError(
            f"snapshot must be an object, got {type(doc).__name__}"
        )
    schema = doc.get("schema")
    if schema != PEER_SCHEMA_VERSION:
        raise PeerSnapshotError(
            f"unsupported snapshot schema {schema!r} (want {PEER_SCHEMA_VERSION})"
        )
    worker_id = doc.get("worker_id")
    if not _is_int(worker_id) or worker_id < 0:
        raise PeerSnapshotError(f"bad worker_id {worker_id!r}")
    labels = doc.get("labels")
    if not isinstance(labels, dict) or not all(
        isinstance(k, str) and isinstance(v, str) for k, v in labels.items()
    ):
        raise PeerSnapshotError("labels must map str -> str")
    generation = doc.get("generation")
    if not _is_int(generation):
        raise PeerSnapshotError(f"bad generation {generation!r}")
    chips = doc.get("chips")
    if not isinstance(chips, dict):
        raise PeerSnapshotError("chips must be an object")
    for key in ("healthy", "sick"):
        value = chips.get(key)
        if value is not None and not _is_int(value):
            raise PeerSnapshotError(f"bad chips.{key} {value!r}")
    if "cohort" in doc:
        _validate_cohort(doc["cohort"])
    if "slice" in doc:
        _validate_slice_section(doc["slice"])
    return doc


def _is_int(value: Any) -> bool:
    return isinstance(value, int) and not isinstance(value, bool)


def _validate_slice_section(section: Any) -> None:
    if not isinstance(section, dict):
        raise PeerSnapshotError("slice section must be an object")
    if section.get("schema") != SLICE_SECTION_SCHEMA_VERSION:
        raise PeerSnapshotError(
            f"unsupported slice section schema {section.get('schema')!r} "
            f"(want {SLICE_SECTION_SCHEMA_VERSION})"
        )
    if not isinstance(section.get("leader"), str):
        raise PeerSnapshotError(f"bad slice.leader {section.get('leader')!r}")
    if not isinstance(section.get("degraded"), bool):
        raise PeerSnapshotError(f"bad slice.degraded {section.get('degraded')!r}")
    for name in ("healthy_hosts", "total_hosts", "sick_chips"):
        value = section.get(name)
        if value is not None and not _is_int(value):
            raise PeerSnapshotError(f"bad slice.{name} {value!r}")


def _validate_cohort(cohort: Any) -> None:
    """Field-strict: one corrupt (or newer) cohort leader reads as
    unreachable, never mis-aggregates the slice."""
    if not isinstance(cohort, dict):
        raise PeerSnapshotError("cohort must be an object")
    if cohort.get("schema") != COHORT_SCHEMA_VERSION:
        raise PeerSnapshotError(
            f"unsupported cohort schema {cohort.get('schema')!r} "
            f"(want {COHORT_SCHEMA_VERSION})"
        )
    index = cohort.get("index")
    if not _is_int(index) or index < 0:
        raise PeerSnapshotError(f"bad cohort.index {index!r}")
    members = cohort.get("members")
    if not isinstance(members, dict):
        raise PeerSnapshotError("cohort.members must be an object")
    for key, entry in members.items():
        if not isinstance(key, str) or not key.isdigit():
            raise PeerSnapshotError(f"bad cohort member id {key!r}")
        if not isinstance(entry, dict):
            raise PeerSnapshotError(f"cohort member {key} must be an object")
        if not isinstance(entry.get("reachable"), bool):
            raise PeerSnapshotError(
                f"bad cohort member {key} reachable {entry.get('reachable')!r}"
            )
        for name in ("generation", "sick"):
            value = entry.get(name)
            if value is not None and not _is_int(value):
                raise PeerSnapshotError(f"bad cohort member {key} {name} {value!r}")
        mode = entry.get("mode")
        if mode is not None and not isinstance(mode, str):
            raise PeerSnapshotError(f"bad cohort member {key} mode {mode!r}")
