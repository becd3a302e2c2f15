"""The fleet inventory wire schema (``GET /fleet/snapshot``) and its
``--state-dir`` persistence (twin:
``gpu_feature_discovery_tpu/fleet/inventory.py``, whose wire this is
byte for byte).

Document shape (schema 1)::

    {
      "schema": 1,               # THIS document's schema
      "peer_schema": 1,          # the /peer/snapshot schema the
                                 # collector speaks — the ONE shared
                                 # constant (peering/snapshot.py
                                 # PEER_SCHEMA_VERSION); a slice
                                 # answering with any other version
                                 # reads as unreachable, never
                                 # mis-aggregated
      "generation": 7,           # distinct-inventory counter (an
                                 # unchanged round keeps body/ETag/
                                 # generation frozen — the idle fleet's
                                 # scrape is a header exchange)
      "restored": false,         # any entry still served from the
                                 # persisted last-good inventory
      "slices": {
        "slice-a": {
          "reachable": true,     # some leadership-chain member answers
          "stale": false,        # whole chain confirmed dark -> the
                                 # entry is last-known data (every
                                 # field below null = the collector has
                                 # NEVER reached this slice since it
                                 # started: a typo'd or decommissioned
                                 # target, not one that went dark)
          "leader": "w0",        # the answering chain member's hostname
          "last_seen_unix": 1722800000,   # wall clock of the last
                                 # successful poll, quantized (collector
                                 # LAST_SEEN_QUANTUM_S) so idle rounds
                                 # keep the body byte-identical;
                                 # consumers compute age = now - this;
                                 # null = never reached
          "healthy_hosts": 4,    # the leader's published slice verdict
          "total_hosts": 4,      # (null while the answering member
          "degraded": false,     # serves no slice section — e.g. a
          "sick_chips": 0,       # partitioned would-be leader)
          "mode": "full",        # the leader's write mode
          "generation": 12,      # the leader's snapshot generation
          "restored": false      # entry restored from --state-dir,
                                 # cleared by the slice's first live poll
        }
      }
    }

Under ``--upstream-mode=collectors`` (the federation tier, collector.py)
the document additionally carries::

      "upstream": "collectors",  # this inventory is a MERGE of region
                                 # collectors' /fleet/snapshot bodies
      "regions": {               # one meta entry per upstream region
        "us-east": {
          "reachable": true,     # some collector in the region's chain
                                 # answers
          "stale": false,        # whole chain confirmed dark -> every
                                 # merged slice entry below is served
                                 # degraded-stale (last-known data,
                                 # last_seen_unix preserved)
          "collector": "c0",     # the answering collector host
          "last_seen_unix": 1722800000,  # quantized, same economy
          "generation": 9,       # the region inventory's generation
          "restored": false      # region entries restored from
                                 # --state-dir, cleared by the region's
                                 # first live scrape
        }
      }

and its ``slices`` keys are ``region/<name>/<slice>`` with a ``region``
attribution field added to each merged entry — otherwise the entries are
VERBATIM what the region collector served (the federation identity
property tests/test_torch_fleet.py pins). Both keys are ABSENT in slices
mode, so a slices-mode collector's wire is the plain schema-1 document. Because the merged
body is the same schema-versioned, ETag-cached document, a root
collector is itself a valid upstream for a higher root (federation
nests; the region prefix composes).

Serialization is the peer layer's exact body format + strong-ETag pair
(peering/snapshot.serialize_snapshot), rendered once per DISTINCT
inventory; ``/fleet/snapshot`` answers a matching ``If-None-Match`` with
``304`` (obs/server.py shares the handler with ``/peer/snapshot``).

**Delta sync** (``GET /fleet/snapshot?since=<generation>``): a consumer
that already holds generation S may ask for only what moved since. The
server (collector.delta_response) answers an O(changed) DELTA document::

    {
      "schema": 1,
      "peer_schema": 1,
      "delta": true,            # the dispatch key (absent on full docs)
      "since": 5,               # the generation this delta starts from
      "generation": 8,          # ...and the generation it lands on
      "restored": false,        # the full doc's current restored flag
      "changed": {              # entries whose per-entry generation
        "slice-a": {...}        # advanced past `since` — VERBATIM full
      },                        # entries, never field-level diffs
      "tombstones": ["slice-b"] # keys dropped since `since`
      # federation tier only (absent in slices mode):
      # "regions_changed": {...}, "regions_tombstones": [...]
    }

served with the CURRENT full body's strong ETag (the header names the
STATE reached, not the response bytes) — so an in-sync consumer's
``If-None-Match`` still 304s and the idle-round economy is untouched.
The full body remains the resync fallback: a ``since`` ahead of the
server's generation, older than its delta window, or whose
``If-None-Match`` does not match that generation's recorded ETag
lineage answers the complete document. ``DeltaMirror`` is the client
half: it reconstructs the full document from deltas and VERIFIES the
reconstruction against the served ETag — a client that missed a delta
(or a tombstone) detects the mismatch and resyncs instead of serving a
silently-diverged pane.

Persistence (``InventoryStore``) follows sandbox/state.LabelStateStore:
versioned JSON through the fsync-before-rename writer, all failures
contained, corrupt/mismatched documents load as "no state" — a collector
restart then serves the last-good inventory immediately with
``restored`` entries until each slice's first live poll replaces it.
The state doc also carries the delta protocol's continuity fields (all
OPTIONAL — a pre-delta state file still restores): the generation
high-water mark (so a restarted collector's counter never moves
backward and a client's ``since`` ahead of the server is always a
restart artifact worth a full resync), the ETag-lineage history, and
the live tombstone set (so a slice dropped from the targets file is
still announced as a tombstone across the epoch rebuild the reload
triggers).
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Dict, Optional

from gpu_feature_discovery_tpu_torch.lm.labels import _write_file_atomically
from gpu_feature_discovery_tpu_torch.peering.snapshot import (
    PEER_SCHEMA_VERSION,
    serialize_snapshot,
)

log = logging.getLogger("tfd.fleet")

FLEET_SCHEMA_VERSION = 1
FLEET_SNAPSHOT_PATH = "/fleet/snapshot"

# A merged regional inventory is many slices wide — the peer snapshot's
# 256 KiB cap (one node's labels) is the wrong budget for it. ~4 MiB
# covers tens of thousands of slice entries while still bounding what a
# root collector will buffer from one upstream.
MAX_INVENTORY_BYTES = 4 * 1024 * 1024

STATE_VERSION = 1
INVENTORY_FILENAME = "fleet-inventory.json"
INVENTORY_MODE = 0o644


def build_inventory(
    slices: Dict[str, Dict[str, Any]],
    generation: int,
    restored: bool,
    regions: Optional[Dict[str, Dict[str, Any]]] = None,
) -> Dict[str, Any]:
    doc = {
        "schema": FLEET_SCHEMA_VERSION,
        # The one shared constant: the collector parses peer snapshots
        # through peering/snapshot.parse_snapshot, which rejects any
        # other version — this field states on the wire which version
        # that is (tests/test_torch_fleet.py pins the bidirectional guard).
        "peer_schema": PEER_SCHEMA_VERSION,
        "generation": int(generation),
        "restored": bool(restored),
        "slices": {name: dict(entry) for name, entry in slices.items()},
    }
    if regions is not None:
        # The federation tier only: a slices-mode collector's document
        # stays the plain schema-1 wire, so these keys are ABSENT there,
        # never null.
        doc["upstream"] = "collectors"
        doc["regions"] = {
            name: dict(entry) for name, entry in regions.items()
        }
    return doc


def build_delta(
    since: int,
    generation: int,
    restored: bool,
    changed: Dict[str, Dict[str, Any]],
    tombstones: "list[str]",
    regions_changed: Optional[Dict[str, Dict[str, Any]]] = None,
    regions_tombstones: Optional["list[str]"] = None,
) -> Dict[str, Any]:
    """One delta document (module docstring): what moved between
    ``since`` and ``generation``. Entries are carried VERBATIM — the
    delta's granularity is the entry, never a field-level diff, so a
    client's reconstruction is a plain dict update."""
    doc = {
        "schema": FLEET_SCHEMA_VERSION,
        "peer_schema": PEER_SCHEMA_VERSION,
        "delta": True,
        "since": int(since),
        "generation": int(generation),
        "restored": bool(restored),
        "changed": {name: dict(entry) for name, entry in changed.items()},
        "tombstones": sorted(tombstones),
    }
    if regions_changed is not None:
        # Federation tier only — same absence discipline as the full
        # document's upstream/regions keys.
        doc["regions_changed"] = {
            name: dict(entry) for name, entry in regions_changed.items()
        }
        doc["regions_tombstones"] = sorted(regions_tombstones or ())
    return doc


def serialize_inventory(doc: Dict[str, Any]) -> "tuple[bytes, str]":
    """Wire body + strong ETag — the peer snapshot's exact economy,
    reused: one serialization per distinct inventory, 304s for everyone
    polling an idle fleet."""
    return serialize_snapshot(doc)


def _load_body(body: bytes) -> Dict[str, Any]:
    if len(body) > MAX_INVENTORY_BYTES:
        raise ValueError(
            f"inventory body {len(body)} bytes exceeds "
            f"{MAX_INVENTORY_BYTES}"
        )
    try:
        doc = json.loads(body.decode("utf-8"))
    except RecursionError as e:
        # Nested past the decoder's limit: the twin lets it escape untyped.
        raise ValueError(f"inventory is not JSON: {e}") from e
    if not isinstance(doc, dict):
        raise ValueError("inventory must be an object")
    if doc.get("schema") != FLEET_SCHEMA_VERSION:
        raise ValueError(
            f"unsupported fleet schema {doc.get('schema')!r} "
            f"(want {FLEET_SCHEMA_VERSION})"
        )
    return doc


def _validate_entry_map(value: Any, what: str) -> None:
    if not isinstance(value, dict) or not all(
        isinstance(k, str) and isinstance(v, dict) for k, v in value.items()
    ):
        raise ValueError(f"inventory {what} must be a str->object map")


def _validate_full(doc: Dict[str, Any]) -> None:
    _validate_entry_map(doc.get("slices"), "slices")
    regions = doc.get("regions")
    if regions is not None:
        _validate_entry_map(regions, "regions")


def _validate_delta(doc: Dict[str, Any]) -> None:
    for field in ("since", "generation"):
        value = doc.get(field)
        if not isinstance(value, int) or isinstance(value, bool) or value < 0:
            raise ValueError(f"bad delta {field} {value!r}")
    if doc["since"] >= doc["generation"]:
        raise ValueError(
            f"delta since {doc['since']} must precede its generation "
            f"{doc['generation']}"
        )
    if not isinstance(doc.get("restored"), bool):
        raise ValueError(f"bad delta restored {doc.get('restored')!r}")
    _validate_entry_map(doc.get("changed"), "changed")
    tombstones = doc.get("tombstones")
    if not isinstance(tombstones, list) or not all(
        isinstance(k, str) for k in tombstones
    ):
        raise ValueError("delta tombstones must be a list of keys")
    overlap = set(tombstones) & set(doc["changed"])
    if overlap:
        raise ValueError(
            f"delta keys both changed and tombstoned: {sorted(overlap)}"
        )
    has_rc = "regions_changed" in doc
    if has_rc != ("regions_tombstones" in doc):
        raise ValueError(
            "delta regions_changed and regions_tombstones must appear "
            "together"
        )
    if has_rc:
        _validate_entry_map(doc["regions_changed"], "regions_changed")
        if not isinstance(doc["regions_tombstones"], list) or not all(
            isinstance(k, str) for k in doc["regions_tombstones"]
        ):
            raise ValueError(
                "delta regions_tombstones must be a list of keys"
            )


def parse_inventory(body: bytes) -> Dict[str, Any]:
    """Validate one FULL /fleet/snapshot body (the root collector's read
    surface, the HA mirror, dashboard clients, tests). ValueError on
    anything a consumer cannot trust — forward-rejecting on schema, the
    peering parser's exact discipline. A delta document is rejected here
    (it carries no ``slices`` map): this parser is the delta-unaware
    client's contract and must never half-accept a shape it does not
    speak."""
    doc = _load_body(body)
    _validate_full(doc)
    return doc


def parse_inventory_or_delta(body: bytes) -> Dict[str, Any]:
    """The delta-aware consumer's parse: dispatch on the ``delta`` key —
    full documents get parse_inventory's exact validation, delta
    documents their own field-strict one. The caller applies a delta
    through DeltaMirror (never reads it raw)."""
    doc = _load_body(body)
    if doc.get("delta"):
        _validate_delta(doc)
    else:
        _validate_full(doc)
    return doc


class DeltaSyncError(ValueError):
    """A delta document could not be applied onto the client-side
    mirror: out-of-order, unverifiable, or its reconstruction does not
    match the ETag the server says this generation hashes to. The
    caller's recovery is always the same — drop the mirror and refetch
    the full body."""


class DeltaMirror:
    """The client half of delta sync: a reconstructed full inventory
    document, advanced by ``apply``-ing each polled body (full or
    delta). Every delta application is VERIFIED — the reconstruction is
    re-serialized and its strong ETag compared against the one the
    server attached (which names the full body at the delta's target
    generation): byte-identity with a full-body client is checked every
    round, never assumed. One mirror per upstream host; single-threaded
    like the poller that owns it."""

    def __init__(self):
        self.doc: Optional[Dict[str, Any]] = None
        self.body: Optional[bytes] = None
        self.generation: Optional[int] = None
        # What the LAST apply changed: a set of slice keys (empty after
        # a 304), or None after a full-body replacement (the O(changed)
        # consumers fall back to a full recompute exactly then).
        self.last_changed: "Optional[set]" = None

    def note_unchanged(self) -> None:
        """A 304 round: the mirror is current and nothing moved."""
        if self.doc is not None:
            self.last_changed = set()

    def apply(
        self, doc: Dict[str, Any], etag: Optional[str]
    ) -> Dict[str, Any]:
        """Advance the mirror by one polled document and return the full
        reconstructed inventory. Raises DeltaSyncError when a delta
        cannot be applied soundly — the caller drops the mirror and the
        next poll resyncs with a full body."""
        if not doc.get("delta"):
            self.doc = doc
            self.body, _ = serialize_inventory(doc)
            self.generation = doc.get("generation")
            self.last_changed = None
            return doc
        if self.doc is None:
            raise DeltaSyncError("delta received with no mirrored base")
        if doc.get("since") != self.generation:
            raise DeltaSyncError(
                f"delta starts at generation {doc.get('since')} but the "
                f"mirror holds {self.generation}"
            )
        if not etag:
            raise DeltaSyncError(
                "delta response carried no ETag to verify against"
            )
        new_doc = dict(self.doc)
        slices = dict(self.doc.get("slices", {}))
        for key in doc.get("tombstones", ()):
            slices.pop(key, None)
        slices.update(doc.get("changed", {}))
        new_doc["slices"] = slices
        new_doc["generation"] = doc["generation"]
        new_doc["restored"] = doc["restored"]
        if "regions_changed" in doc:
            regions = dict(self.doc.get("regions") or {})
            for key in doc.get("regions_tombstones", ()):
                regions.pop(key, None)
            regions.update(doc["regions_changed"])
            new_doc["regions"] = regions
        body, own_etag = serialize_inventory(new_doc)
        if own_etag != etag:
            # The reconstruction is NOT what a full-body client holds —
            # a missed delta, a missed tombstone, or a server that lost
            # its lineage. Never serve it.
            raise DeltaSyncError(
                "reconstructed inventory does not match the served ETag"
            )
        self.doc = new_doc
        self.body = body
        self.generation = new_doc["generation"]
        self.last_changed = set(doc.get("changed", {})) | set(
            doc.get("tombstones", ())
        )
        return new_doc


class InventoryStore:
    """Load/save the last-good fleet inventory under ``--state-dir``.
    Contained failures, churn-free saves — the LabelStateStore contract
    (sandbox/state.py), applied to the collector."""

    def __init__(self, state_dir: str):
        self._dir = state_dir
        self._path = os.path.join(state_dir, INVENTORY_FILENAME)
        self._save_warned = False
        self._last_saved: Optional["tuple"] = None

    @property
    def path(self) -> str:
        return self._path

    def load(self) -> Optional[Dict[str, Dict[str, Any]]]:
        """The persisted per-slice entries, or None (absent, unreadable,
        corrupt, wrong version)."""
        slices, _ = self.load_doc()
        return slices

    def load_doc(
        self,
    ) -> "tuple[Optional[Dict[str, Dict[str, Any]]], Optional[Dict[str, Dict[str, Any]]]]":
        """The persisted ``(slices, regions)`` pair. ``slices`` is None
        on any unusable file; ``regions`` is None when the state was
        written by a slices-mode collector (no regions key)."""
        state = self.load_state()
        return state["slices"], state["regions"]

    def load_state(self) -> Dict[str, Any]:
        """The complete persisted state: the ``(slices, regions)`` pair
        plus the delta protocol's continuity fields. Every sync field is
        OPTIONAL and degrades independently — a pre-delta state file (or
        one whose sync fields are malformed) still restores its entries;
        only delta continuity starts cold (every delta client then
        resyncs with one full body, which is always sound)."""
        blank = {
            "slices": None,
            "regions": None,
            "generation": None,
            "etag_history": {},
            "tombstones": {},
            "region_tombstones": {},
        }
        try:
            with open(self._path) as f:
                doc = json.load(f)
        except FileNotFoundError:
            return blank
        except (OSError, ValueError) as e:
            log.warning(
                "ignoring unreadable fleet state file %s: %s", self._path, e
            )
            return blank
        if not isinstance(doc, dict) or doc.get("version") != STATE_VERSION:
            log.warning(
                "ignoring fleet state file %s: unsupported version %r",
                self._path,
                doc.get("version") if isinstance(doc, dict) else None,
            )
            return blank
        slices = doc.get("slices")
        if not isinstance(slices, dict) or not all(
            isinstance(k, str) and isinstance(v, dict)
            for k, v in slices.items()
        ):
            log.warning(
                "ignoring fleet state file %s: slices are not a "
                "str->object map",
                self._path,
            )
            return blank
        regions = doc.get("regions")
        if not isinstance(regions, dict) or not all(
            isinstance(k, str) and isinstance(v, dict)
            for k, v in regions.items()
        ):
            # Absent (slices-mode state) or malformed: the per-slice
            # entries still restore; only the region meta starts blank.
            regions = None
        else:
            regions = {name: dict(entry) for name, entry in regions.items()}
        state = dict(blank)
        state["slices"] = {
            name: dict(entry) for name, entry in slices.items()
        }
        state["regions"] = regions
        generation = doc.get("generation")
        if (
            isinstance(generation, int)
            and not isinstance(generation, bool)
            and generation >= 0
        ):
            state["generation"] = generation
        history = doc.get("etag_history")
        if isinstance(history, dict):
            # JSON object keys are strings; generations are ints.
            try:
                state["etag_history"] = {
                    int(g): str(etag) for g, etag in history.items()
                }
            except (TypeError, ValueError):
                state["etag_history"] = {}
        for field in ("tombstones", "region_tombstones"):
            raw = doc.get(field)
            if isinstance(raw, dict) and all(
                isinstance(k, str)
                and isinstance(g, int)
                and not isinstance(g, bool)
                for k, g in raw.items()
            ):
                state[field] = dict(raw)
        return state

    def save(
        self,
        slices: Dict[str, Dict[str, Any]],
        regions: Optional[Dict[str, Dict[str, Any]]] = None,
        generation: Optional[int] = None,
        etag_history: Optional[Dict[int, str]] = None,
        tombstones: Optional[Dict[str, int]] = None,
        region_tombstones: Optional[Dict[str, int]] = None,
    ) -> bool:
        """Persist the per-slice entries (and, at the federation tier,
        the per-region meta) atomically; False (after one warning) on
        failure. Churn-free: an unchanged inventory is not re-fsynced
        every round. Two HA replicas sharing one --state-dir both call
        this — the atomic rename makes it last-writer-wins, never a torn
        file. The optional delta-continuity fields ride the same doc:
        the generation high-water mark, the ETag-lineage history (the
        window a restarted collector can still serve deltas from), and
        the live tombstones."""
        snapshot = {name: dict(entry) for name, entry in slices.items()}
        region_snapshot = (
            {name: dict(entry) for name, entry in regions.items()}
            if regions is not None
            else None
        )
        if self._last_saved == (snapshot, region_snapshot, generation):
            return True
        doc = {
            "version": STATE_VERSION,
            "saved_unix": int(time.time()),
            "slices": snapshot,
        }
        if region_snapshot is not None:
            doc["regions"] = region_snapshot
        if generation is not None:
            doc["generation"] = int(generation)
            doc["etag_history"] = {
                str(g): etag for g, etag in (etag_history or {}).items()
            }
            doc["tombstones"] = dict(tombstones or {})
            doc["region_tombstones"] = dict(region_tombstones or {})
        try:
            os.makedirs(self._dir, exist_ok=True)
            _write_file_atomically(
                self._path,
                json.dumps(doc, sort_keys=True).encode(),
                INVENTORY_MODE,
            )
            self._last_saved = (snapshot, region_snapshot, generation)
            return True
        except OSError as e:
            if not self._save_warned:
                self._save_warned = True
                log.warning(
                    "cannot persist fleet inventory to %s: %s "
                    "(restarts will start cold)",
                    self._path,
                    e,
                )
            return False
