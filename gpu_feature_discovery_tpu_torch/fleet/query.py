"""The fleet query surface: server-side filtered views of the
inventory, each with its own serialize-once/strong-ETag/304 economy
(twin: ``gpu_feature_discovery_tpu/fleet/query.py``).

``GET /fleet/snapshot`` grows a composable filter grammar (AND
semantics, every param at most once)::

    ?region=<name>        entries whose ``region`` attribution matches
                          (federation tier; slices-mode entries carry no
                          region and never match)
    ?degraded=true|false  entries whose leader verdict says degraded
    ?stale=true|false     entries served degraded-stale (chain dark)
    ?sick-chips=true|false  entries whose verdict counts sick chips
    ?max-age=<seconds>    entries whose last_seen_unix is within
                          <seconds> of now (evaluated at the collector's
                          quantized clock — the same LAST_SEEN_QUANTUM_S
                          granularity the stamps themselves have, so an
                          idle fleet's view stays byte-frozen)

plus the two control params that ride any filter::

    ?since=<generation>   the generation-delta protocol, scoped to the
                          FILTERED view's generation lineage
    ?watch=<seconds>      long-poll: park until the filtered view's
                          generation moves (requires ``since``)

Canonicalization is the cache identity: params are sorted, values
normalized, duplicates and unknown params answer 400 (a typo'd
dashboard must never silently receive the full pane and defeat the
per-filter economy — the same reasoning that hardened ``?since=``).

Each distinct canonical filter gets ONE rendered view: the filtered
document is the same schema-versioned inventory (plus a ``filter`` key
naming the canonical query) whose ``generation`` is the last GLOBAL
generation at which the filtered content actually changed — so a
filter nothing touches keeps its body, ETag, and generation frozen
across global churn, and its idle consumers keep exchanging 304
headers. Views live in a bounded LRU (``--filter-cache-size``,
evictions counted; the unfiltered pane is the collector's own
publish-seam cache and is never here, hence never evicted) and
revalidate lazily: the first access after the global generation moved
recomputes the filtered entry set (cheap dict work) and re-serializes
ONLY when it differs — at most one serialization per distinct filter
per generation (tests/test_torch_fleet_scale.py pins it at 1,000
slices).

The filtered delta lineage is one step deep: a client holding the
view's previous generation (If-None-Match verified, exactly the global
lineage rule) gets an O(changed) delta + tombstones scoped to the
filter; anything older resyncs with the full filtered body — which is
small by construction, that being the point of the filter. DeltaMirror
applies filtered deltas unchanged: the ``filter`` key rides the
mirrored base document and the reconstruction is ETag-verified, so a
filtered watcher detects divergence exactly like a full-pane client.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Dict, Optional
from urllib.parse import quote, unquote_plus

from gpu_feature_discovery_tpu_torch.obs import metrics as obs_metrics

# Filter params, in canonical (sorted) order. ``since``/``watch`` are
# control params: they select protocol, not content, and are excluded
# from the canonical filter identity.
FILTER_PARAMS = ("degraded", "max-age", "region", "sick-chips", "stale")
CONTROL_PARAMS = ("since", "watch")

# How many generations of per-view ETag lineage a filtered view keeps.
# Content is kept ONE step deep (the previous rendered view) — a
# watcher always holds the latest body, so one step serves the wake
# path; older lineage entries exist only to recognize a straggler and
# resync it deliberately instead of diffing against content we no
# longer hold.
VIEW_HISTORY_DEPTH = 8

# Longest accepted region value: the canonical string is a cache key,
# and a client must not be able to mint megabyte keys.
_MAX_REGION_LEN = 256


class QueryError(ValueError):
    """A query string the fleet surface rejects with 400: unknown or
    duplicated params, a malformed value, or ``watch`` without the
    ``since`` baseline that makes a wake answerable as a delta."""


@dataclass(frozen=True)
class FleetQuery:
    """One parsed ``/fleet/snapshot`` query. ``canonical`` is the
    sorted, normalized filter identity ('' = the unfiltered pane);
    ``since``/``watch_s`` are the protocol controls riding it."""

    canonical: str = ""
    region: Optional[str] = None
    degraded: Optional[bool] = None
    stale: Optional[bool] = None
    sick_chips: Optional[bool] = None
    max_age_s: Optional[int] = None
    since: Optional[int] = None
    watch_s: Optional[float] = None

    @property
    def filtered(self) -> bool:
        return bool(self.canonical)


def _parse_pairs(raw: str) -> "list[tuple[str, str]]":
    pairs = []
    for part in raw.split("&"):
        if not part:
            continue
        key, sep, value = part.partition("=")
        if not sep:
            raise QueryError(f"param {key!r} needs a value")
        pairs.append((unquote_plus(key), unquote_plus(value)))
    return pairs


def _parse_bool(key: str, value: str) -> bool:
    lowered = value.strip().lower()
    if lowered == "true":
        return True
    if lowered == "false":
        return False
    raise QueryError(f"{key} must be 'true' or 'false', not {value!r}")


def parse_fleet_query(raw: str) -> FleetQuery:
    """Parse and canonicalize one query string. QueryError (the 400
    path) on anything outside the grammar — silence would hand a typo'd
    dashboard the full pane and call it filtered."""
    seen: Dict[str, str] = {}
    for key, value in _parse_pairs(raw or ""):
        if key not in FILTER_PARAMS and key not in CONTROL_PARAMS:
            raise QueryError(f"unknown param {key!r}")
        if key in seen:
            raise QueryError(f"duplicate param {key!r}")
        seen[key] = value
    fields: Dict[str, Any] = {}
    canonical_parts = []
    for key in FILTER_PARAMS:  # already sorted — the canonical order
        if key not in seen:
            continue
        value = seen[key]
        if key == "region":
            if not value or len(value) > _MAX_REGION_LEN:
                raise QueryError("region must be a non-empty name")
            fields["region"] = value
            canonical_parts.append(f"region={quote(value, safe='')}")
        elif key == "max-age":
            try:
                age = int(value)
            except ValueError:
                raise QueryError(
                    f"max-age must be an integer seconds value, not "
                    f"{value!r}"
                ) from None
            if age <= 0:
                raise QueryError("max-age must be positive")
            fields["max_age_s"] = age
            canonical_parts.append(f"max-age={age}")
        else:
            want = _parse_bool(key, value)
            fields[key.replace("-", "_")] = want
            canonical_parts.append(f"{key}={'true' if want else 'false'}")
    if "since" in seen:
        try:
            since = int(seen["since"])
        except ValueError:
            raise QueryError(
                f"since must be an integer generation, not "
                f"{seen['since']!r}"
            ) from None
        if since < 0:
            raise QueryError("since must be non-negative")
        fields["since"] = since
    if "watch" in seen:
        if "since" not in seen:
            # A watch without a baseline has nothing to answer a wake
            # WITH: the delta protocol is the wake's currency.
            raise QueryError("watch requires since=<generation>")
        try:
            watch_s = float(seen["watch"])
        except ValueError:
            raise QueryError(
                f"watch must be a seconds value, not {seen['watch']!r}"
            ) from None
        if not watch_s > 0:
            raise QueryError("watch must be positive")
        fields["watch_s"] = watch_s
    return FleetQuery(canonical="&".join(canonical_parts), **fields)


def entry_matches(
    query: FleetQuery,
    entry: Dict[str, Any],
    now_quantized: Optional[int],
) -> bool:
    """AND of every present filter against one inventory entry. Null
    verdict fields read as false (a never-reached slice is not
    degraded, not sick — it is all-null, which ``max-age`` and
    ``stale`` are the honest filters for)."""
    if query.region is not None and entry.get("region") != query.region:
        return False
    if (
        query.degraded is not None
        and bool(entry.get("degraded")) != query.degraded
    ):
        return False
    if query.stale is not None and bool(entry.get("stale")) != query.stale:
        return False
    if (
        query.sick_chips is not None
        and bool(entry.get("sick_chips")) != query.sick_chips
    ):
        return False
    if query.max_age_s is not None:
        seen = entry.get("last_seen_unix")
        if seen is None:
            return False
        if now_quantized is not None and now_quantized - seen > query.max_age_s:
            return False
    return True


def filter_entries(
    query: FleetQuery,
    entries: Dict[str, Dict[str, Any]],
    regions: Optional[Dict[str, Dict[str, Any]]],
    now_quantized: Optional[int],
) -> "tuple[Dict[str, Dict[str, Any]], Optional[Dict[str, Dict[str, Any]]]]":
    """The filtered (slices, regions) pair a view renders. The regions
    meta map passes through (it is O(regions) small) except under a
    region filter, where it narrows to the named region — so a filtered
    federation document stays self-describing."""
    matched = {
        key: entry
        for key, entry in entries.items()
        if entry_matches(query, entry, now_quantized)
    }
    if regions is None:
        return matched, None
    if query.region is None:
        return matched, regions
    narrowed = (
        {query.region: regions[query.region]}
        if query.region in regions
        else {}
    )
    return matched, narrowed


@dataclass
class FilteredView:
    """One rendered filtered view: the per-filter twin of the
    collector's publish-seam (body, etag, generation) triple, plus the
    one-step-deep delta state. Mutated only under the collector's
    serving lock."""

    query: FleetQuery
    view_gen: int
    body: bytes
    etag: str
    published: "tuple"  # the (entries, regions) pair last rendered
    # Lazy-revalidation bookkeeping: the global generation and (for
    # max-age views) the quantized clock this view was last checked
    # against. Equal values mean the cached body is current by
    # construction — no filtering, no comparison, no serialization.
    validated_gen: int = 0
    eval_now: Optional[int] = None
    # One-step delta state: the previous rendered content and the
    # bounded ETag lineage (straggler recognition).
    prev_gen: Optional[int] = None
    prev_published: Optional["tuple"] = None
    etag_history: Dict[int, str] = field(default_factory=dict)
    delta_bodies: Dict[int, bytes] = field(default_factory=dict)
    # Monotonic change counter — the watch hub's wake currency.
    revision: int = 0


class FilteredViewCache:
    """Bounded LRU of rendered views, keyed by canonical filter. The
    unfiltered pane never lives here (the collector's own cache serves
    it), so it can never be evicted. Caller holds the serving lock."""

    def __init__(self, capacity: int):
        self.capacity = max(1, int(capacity))
        self._views: "OrderedDict[str, FilteredView]" = OrderedDict()

    def __len__(self) -> int:
        return len(self._views)

    def get(self, canonical: str) -> Optional[FilteredView]:
        view = self._views.get(canonical)
        if view is not None:
            self._views.move_to_end(canonical)
        return view

    def put(self, view: FilteredView) -> None:
        self._views[view.query.canonical] = view
        self._views.move_to_end(view.query.canonical)
        while len(self._views) > self.capacity:
            self._views.popitem(last=False)
            obs_metrics.FLEET_FILTER_CACHE.labels(outcome="evict").inc()
        obs_metrics.FLEET_FILTER_VIEWS.set(len(self._views))

    def clear(self) -> None:
        self._views.clear()
        obs_metrics.FLEET_FILTER_VIEWS.set(0)
