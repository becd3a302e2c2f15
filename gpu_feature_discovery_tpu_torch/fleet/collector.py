"""The fleet collector: scrape many slices' leaders — or, one tier up,
many REGION collectors — and serve one inventory (twin:
``gpu_feature_discovery_tpu/fleet/collector.py``; device-agnostic, so
the port is the twin's code under the port's imports).

One collector per targets epoch (cmd/fleet.py rebuilds it on a targets
reload). Two faces, the coordinator's exact split:

- **Serving** (obs server handler threads): ``inventory_response`` hands
  the ``GET /fleet/snapshot`` handler the inventory body serialized once
  per DISTINCT inventory with a strong ETag — an idle fleet's dashboard
  polls are 304 header exchanges. ``delta_response`` is the same hook's
  ``?since=<generation>`` face (fleet/inventory.py module docstring):
  per-key generation stamps taken at the commit seam let a changed
  round answer O(changed) entries plus tombstones instead of the
  O(fleet) body, with an ETag-lineage check guaranteeing a delta is
  only ever served to a client that verifiably holds the exact body it
  diffs against — everyone else gets the full-body resync fallback.
- **Polling** (the run loop): ``poll_round`` walks every configured
  slice's leadership chain concurrently on a bounded fan-out pool
  (utils/fanout.BoundedPool, ``--peer-fanout`` semantics) under a round
  budget, with every robustness primitive the peer tier established:

  - one persistent keep-alive connection per (slice, chain host), with
    the single stale-connection retry so reuse never mints a miss;
  - ``If-None-Match`` per host — an idle slice costs a 304 header
    exchange, no body, no parse (≥90% of a steady-state round);
  - 2-consecutive-miss unreachability confirmation per host (earned
    trust: a host this collector has never reached counts down on its
    first miss) and confirmed-dead backoff, so a dark slice stops
    costing a full timeout every round;
  - leader-chain failover: the chain is walked in worker-id order and
    the round stops at the first member answering WITH a slice-aggregate
    section (the derived leader); a live member without one — a
    partitioned would-be leader — is kept as reachability evidence and
    the walk continues, exactly like the cohort tier's chain probe.

A slice whose ENTIRE chain is evidence-confirmed dark flips its entry to
degraded-stale: ``reachable=false, stale=true`` with the last-known data
and its ``last_seen_unix`` preserved — a dark slice keeps its last
verdict visible with an honest age instead of vanishing from the pane.

**Federation** (``--upstream-mode=collectors``, the ROOT tier): the same
collector, pointed one tier up. Each targets-file entry names a REGION
and its hosts are that region's collectors (an HA pair is a natural
chain); the poll walks the chain over ``GET /fleet/snapshot`` instead of
``/peer/snapshot`` — same persistent keep-alive + If-None-Match (an idle
root round is ~1 304/region), same 2-miss confirmation + confirmed-dead
backoff, same bounded fan-out under the round budget, same
``--peer-token`` on the wire — and MERGES each region's per-slice
entries VERBATIM under ``region/<name>/<slice>`` keys (plus a ``region``
attribution field; the federation identity property). A region whose
whole chain is confirmed dark is marked degraded in the ``regions`` meta
map and every one of its merged slice entries is served degraded-stale
with ``last_seen_unix`` preserved — a dark region ages on the pane
exactly like a dark slice, it never vanishes. The merged body is the
same schema-versioned, ETag-cached document, so a root is itself a valid
upstream for a higher root.

With ``--peer-token`` set the collector sends the shared secret on every
poll (peering/coordinator.PEER_TOKEN_HEADER — the serving daemons
require it once configured), and its own ``/fleet/snapshot`` is gated by
the same token (obs/server.py).

**Push-on-delta** (``--push-notify``, peering/notify.py): with push
enabled the collector plays BOTH roles of the notification hop. As a
parent it subscribes on the polls it already sends (the notify headers)
and, between full confirmation sweeps on the ``--max-staleness``
cadence, polls only targets a child's authenticated ``/peer/notify``
marked dirty (plus suspects mid-confirmation) — the sweep, not the
push, remains the only correctness mechanism. As a child it POSTs the
same hint upward whenever a commit moves the served inventory's ETag,
so a root over regions (and a higher root over roots) rides the same
economy. ``--push-notify=off`` is today's poll-everything round byte
for byte.
"""

from __future__ import annotations

import http.client
import logging
import threading
import time
from dataclasses import dataclass, field
from functools import partial
from typing import Any, Callable, Dict, List, Optional

from gpu_feature_discovery_tpu_torch.config.spec import (
    DEFAULT_FILTER_CACHE_SIZE,
    DEFAULT_FLEET_DELTA_WINDOW,
    DEFAULT_MAX_WATCHERS,
    DEFAULT_WATCH_TIMEOUT_S,
    UPSTREAM_COLLECTORS,
    UPSTREAM_SLICES,
)
from gpu_feature_discovery_tpu_torch.fleet.inventory import (
    FLEET_SNAPSHOT_PATH,
    MAX_INVENTORY_BYTES,
    DeltaMirror,
    InventoryStore,
    build_delta,
    build_inventory,
    parse_inventory_or_delta,
    serialize_inventory,
)
from gpu_feature_discovery_tpu_torch.fleet.query import (
    VIEW_HISTORY_DEPTH,
    FilteredView,
    FilteredViewCache,
    FleetQuery,
    QueryError,
    filter_entries,
    parse_fleet_query,
)
from gpu_feature_discovery_tpu_torch.fleet.targets import SliceTarget
from gpu_feature_discovery_tpu_torch.obs import metrics as obs_metrics
# The collector deliberately shares the peer tier's wire vocabulary —
# the stale-connection set, the host[:port] splitter (one IPv6 policy),
# the confirmation/backoff constants, the auth header — so the two
# pollers cannot drift apart on semantics. The FETCH/REACHABILITY shape
# here intentionally parallels peering/coordinator._poll_peer/_request
# (the canonical statement of those semantics lives there); a behavioral
# fix on one side should be mirrored — the coordinator's version carries
# extra concerns (tier planes, gauge ownership, injected-_fetch seams)
# that keep a full extraction from paying for itself yet.
from gpu_feature_discovery_tpu_torch.peering.coordinator import (
    AUTO_FANOUT_CAP,
    CONFIRM_POLLS,
    PEER_BACKOFF_BASE_S,
    PEER_BACKOFF_CAP_S,
    PEER_TOKEN_HEADER,
    STALE_CONN_ERRORS,
    SUBSCRIPTION_TTL_FLOOR_S,
    split_host_port,
)
from gpu_feature_discovery_tpu_torch.peering.notify import (
    NOTIFY_NAME_HEADER,
    NOTIFY_PORT_HEADER,
    SUBSCRIPTION_TTL_SWEEPS,
    NotifySender,
    NotifySubscriptions,
)
from gpu_feature_discovery_tpu_torch.peering.snapshot import (
    MAX_SNAPSHOT_BYTES,
    PEER_SNAPSHOT_PATH,
    OversizeBodyError,
    PeerSnapshotError,
    parse_snapshot,
)
from gpu_feature_discovery_tpu_torch.utils.fanout import BoundedPool, Budget
from gpu_feature_discovery_tpu_torch.utils.retry import BackoffPolicy

log = logging.getLogger("tfd.fleet")

# The dispatch-cutoff grace the peer poller uses: a poll with less than
# this much budget left is skipped, not started.
_BUDGET_GRACE_S = 0.05

# Freshness granularity of the published ``last_seen_unix``: quantized so
# an IDLE fleet's successive rounds produce byte-identical inventory
# bodies (an exact per-round stamp would re-render the body, bump the
# generation, and hand every /fleet/snapshot consumer a fresh ETag each
# round for nothing). The quantum must sit WELL ABOVE the scrape
# interval or the stamp crosses a boundary most rounds and the idle-
# fleet 304 economy (and the churn-free state save) never materializes:
# at the default 10s interval, 5 minutes means ~1 re-render per 30
# rounds. Dark-slice detection does not ride on this resolution — the
# ``stale`` flag flips within the confirmation window and the stamp
# FREEZES at the last success; the age only needs to answer "minutes or
# days", which 5-minute granularity does.
LAST_SEEN_QUANTUM_S = 300

# What a 503 at the --max-watchers admission cap tells the client to
# wait before retrying: one second — slots churn on the watch-timeout
# cadence, and a rejected watcher degrading to plain ?since polling at
# 1 Hz costs header exchanges only.
WATCH_RETRY_AFTER_S = 1


@dataclass
class _HostState:
    """One (target, chain host)'s reachability + connection state — the
    peer tier's _PeerState shape, collector-side. Touched only by the
    single round task a target gets per round (rounds never overlap a
    target with itself), so no lock. The HA mirror (fleet/ha.py) reuses
    this shape for its senior-replica states — one reachability
    vocabulary across every fleet-tier poller."""

    host: str
    port: int
    consecutive_failures: int = 0
    ever_reached: bool = False
    last_snapshot: Optional[Dict[str, Any]] = None
    next_attempt: float = 0.0
    backoff_attempt: int = 0
    conn: Optional[http.client.HTTPConnection] = None
    etag: Optional[str] = None
    # Warn-once latch for a host answering 200 with no ETag header (a
    # stripping proxy): the 304 economy is silently gone for it, which
    # must be visible without flooding the log every round.
    etag_warned: bool = False
    # The delta-sync reconstruction for this host's /fleet/snapshot
    # (created by request_snapshot on the first delta-aware poll; always
    # None for /peer/snapshot hosts — peer documents are per-node and
    # tiny, there is nothing to delta).
    mirror: Optional[DeltaMirror] = None
    backoff: BackoffPolicy = field(
        default_factory=lambda: BackoffPolicy(
            base=PEER_BACKOFF_BASE_S, cap=PEER_BACKOFF_CAP_S
        )
    )

    @property
    def confirmed_down(self) -> bool:
        # Earned trust (peering/coordinator._PeerState.confirmed_down):
        # the 2-poll grace is for ESTABLISHED conversations only.
        if not self.ever_reached:
            return self.consecutive_failures >= 1
        return self.consecutive_failures >= CONFIRM_POLLS


@dataclass
class _TargetState:
    """One configured target: its chain hosts' states and the current
    inventory data. In slices mode ``entry`` IS the slice's inventory
    entry; in collectors mode ``entry`` is the region's meta entry (the
    ``regions`` map) and ``slices`` holds the merged
    ``region/<name>/<slice>`` entries."""

    target: SliceTarget
    hosts: List[_HostState]
    entry: Dict[str, Any]
    slices: Dict[str, Dict[str, Any]] = field(default_factory=dict)
    restored: bool = False


def _blank_entry() -> Dict[str, Any]:
    return {
        "reachable": False,
        "stale": False,
        "leader": None,
        "last_seen_unix": None,
        "healthy_hosts": None,
        "total_hosts": None,
        "degraded": None,
        "sick_chips": None,
        "mode": None,
        "generation": None,
        "restored": False,
    }


def _blank_region_meta() -> Dict[str, Any]:
    """A region's meta entry before its collector chain is ever reached
    — all-null is the same 'never existed vs went dark' discriminator
    the slice entries carry."""
    return {
        "reachable": False,
        "stale": False,
        "collector": None,
        "last_seen_unix": None,
        "generation": None,
        "restored": False,
    }


# -- the shared HTTP fetch (the peer tier's persistent-connection shape) ---
#
# Both fleet-tier pollers — the collector's chain walk and the HA
# standby's active mirror (fleet/ha.py) — ride these two functions, so
# the keep-alive / If-None-Match / stale-retry semantics cannot drift
# between them. The caller's ``request`` closure owns connection
# creation (so each poller keeps its own closed-gate discipline).


def drop_connection(hstate: _HostState) -> None:
    conn, hstate.conn = hstate.conn, None
    if conn is not None:
        try:
            conn.close()
        except OSError:
            pass


def fetch_with_stale_retry(
    hstate: _HostState, request: Callable[[], Dict[str, Any]]
) -> Dict[str, Any]:
    """Run one gated request with the single stale-connection retry: a
    server closing the idle keep-alive connection between rounds is
    connection lifecycle, not target health — one retry on a fresh
    connection before anything counts as a miss (the peer poller's exact
    rule). Any other failure drops the connection and propagates."""
    reused = hstate.conn is not None
    try:
        try:
            return request()
        except STALE_CONN_ERRORS:
            if not reused:
                raise
            drop_connection(hstate)
            return request()
    except Exception:
        drop_connection(hstate)
        raise


def request_snapshot(
    hstate: _HostState,
    timeout: float,
    path: str,
    parse: Callable[[bytes], Dict[str, Any]],
    max_bytes: int,
    token: str = "",
    not_modified_counter: Any = None,
    delta: bool = False,
    extra_headers: Optional[Dict[str, str]] = None,
) -> Dict[str, Any]:
    """The wire half of one poll: GET ``path`` on ``hstate``'s existing
    connection with If-None-Match (a 304 answers from the cached
    snapshot), the peer token when configured, any caller-supplied
    ``extra_headers`` (the push-on-delta subscribe headers ride here),
    and a bounded body read through ``parse``. The caller created
    ``hstate.conn`` under its own closed-gate before calling.

    With ``delta=True`` (the /fleet/snapshot consumers) the poll rides
    the generation-delta protocol: once the host's DeltaMirror holds a
    base document, ``?since=<generation>`` is appended and the returned
    body — full or delta — is applied through the mirror, so the caller
    always receives the FULL reconstructed inventory (``last_snapshot``
    keeps the full-document shape a 304 answers from). Any unsound
    delta drops the mirror and raises — one counted miss, and the next
    poll resyncs with a full body. A delta-unaware server ignores the
    query string and answers full bodies: mixed-version fleets degrade
    to today's wire, never break."""
    conn = hstate.conn
    conn.timeout = timeout
    if conn.sock is not None:
        conn.sock.settimeout(timeout)
    headers = {}
    if token:
        headers[PEER_TOKEN_HEADER] = token
    if extra_headers:
        headers.update(extra_headers)
    if hstate.etag is not None and hstate.last_snapshot is not None:
        headers["If-None-Match"] = hstate.etag
    request_path = path
    if delta:
        if hstate.mirror is None:
            hstate.mirror = DeltaMirror()
        if (
            hstate.mirror.generation is not None
            and "If-None-Match" in headers
        ):
            request_path = f"{path}?since={hstate.mirror.generation}"
    conn.request("GET", request_path, headers=headers)
    resp = conn.getresponse()
    if resp.status == 304:
        resp.read()
        if not_modified_counter is not None:
            not_modified_counter.inc()
        if hstate.last_snapshot is None:
            raise PeerSnapshotError("304 with no cached snapshot")
        if delta and hstate.mirror is not None:
            hstate.mirror.note_unchanged()
        return hstate.last_snapshot
    if resp.status != 200:
        raise PeerSnapshotError(f"HTTP {resp.status}")
    body = resp.read(max_bytes + 1)
    if len(body) > max_bytes:
        # The sentinel byte arrived: the document is over the tier's
        # cap. Name it instead of letting parse choke on truncated
        # bytes — the poll outcome distinguishes "too big" from "junk".
        raise OversizeBodyError(f"body exceeds {max_bytes} bytes")
    snapshot = parse(body)
    etag = resp.getheader("ETag")
    if not etag:
        obs_metrics.FLEET_ETAG_MISSING.inc()
        if not hstate.etag_warned:
            hstate.etag_warned = True
            log.warning(
                "%s:%d answered 200 with no ETag header (a stripping "
                "proxy?): every poll of this host now refetches the "
                "full body instead of exchanging 304 headers",
                hstate.host,
                hstate.port,
            )
    hstate.etag = etag if etag else None
    if delta:
        kind = "delta" if snapshot.get("delta") else "full"
        obs_metrics.FLEET_DELTA_POLLS.labels(kind=kind).inc()
        obs_metrics.FLEET_POLL_BODY_BYTES.labels(kind=kind).inc(len(body))
        try:
            snapshot = hstate.mirror.apply(snapshot, etag)
        except ValueError as e:
            # Unsound delta (out of order, unverifiable, or the
            # reconstruction missed the served ETag): drop the mirror
            # AND the etag so the next poll fetches the full body.
            hstate.mirror = DeltaMirror()
            hstate.etag = None
            raise PeerSnapshotError(f"delta apply failed: {e}") from e
    else:
        obs_metrics.FLEET_POLL_BODY_BYTES.labels(kind="full").inc(len(body))
    return snapshot


class FleetCollector:
    """See module docstring."""

    def __init__(
        self,
        targets: List[SliceTarget],
        default_port: int = 9101,
        peer_timeout: float = 2.0,
        fanout: Optional[int] = None,
        round_budget: Optional[float] = None,
        peer_token: str = "",
        state_dir: str = "",
        upstream_mode: str = UPSTREAM_SLICES,
        delta_window: int = DEFAULT_FLEET_DELTA_WINDOW,
        clock: Callable[[], float] = time.monotonic,
        wall_clock: Callable[[], float] = time.time,
        backoff_factory: Optional[Callable[[], BackoffPolicy]] = None,
        push_notify: bool = False,
        sweep_interval: float = 0.0,
        filter_cache_size: int = DEFAULT_FILTER_CACHE_SIZE,
        watch_timeout: float = DEFAULT_WATCH_TIMEOUT_S,
        max_watchers: int = DEFAULT_MAX_WATCHERS,
    ):
        if upstream_mode not in (UPSTREAM_SLICES, UPSTREAM_COLLECTORS):
            raise ValueError(f"unknown upstream mode {upstream_mode!r}")
        self.upstream_mode = upstream_mode
        self._federated = upstream_mode == UPSTREAM_COLLECTORS
        # What one poll fetches and how it parses: slice leaders'
        # /peer/snapshot, or region collectors' /fleet/snapshot (the
        # same document this collector serves — federation nests).
        if self._federated:
            self._poll_path = FLEET_SNAPSHOT_PATH
            self._parse = parse_inventory_or_delta
            self._max_body = MAX_INVENTORY_BYTES
        else:
            self._poll_path = PEER_SNAPSHOT_PATH
            self._parse = parse_snapshot
            self._max_body = MAX_SNAPSHOT_BYTES
        self.peer_timeout = float(peer_timeout)
        self.round_budget = (
            float(round_budget) if round_budget is not None else None
        )
        self.peer_token = peer_token or ""
        self._clock = clock
        self._wall_clock = wall_clock
        self._round_offset = 0
        self._slices: Dict[str, _TargetState] = {}
        for target in targets:
            hosts = []
            for entry in target.chain:
                host, port = split_host_port(entry, default_port)
                state = _HostState(host=host, port=port)
                if backoff_factory is not None:
                    state.backoff = backoff_factory()
                hosts.append(state)
            self._slices[target.name] = _TargetState(
                target=target,
                hosts=hosts,
                entry=(
                    _blank_region_meta()
                    if self._federated
                    else _blank_entry()
                ),
            )
        n = max(1, len(self._slices))
        self.fanout = (
            min(AUTO_FANOUT_CAP, n)
            if not fanout
            else max(1, min(int(fanout), n))
        )
        self._fanout = BoundedPool(self.fanout, name="tfd-fleet-scrape")
        # Serving-side state (the coordinator's publish/serve split).
        self._lock = threading.Lock()
        self._generation = 0
        self._published: Optional["tuple"] = None
        self._body: Optional[bytes] = None
        self._etag: Optional[str] = None
        self._restored = False
        self._closed = False
        # The query surface (fleet/query.py): per-filter rendered views
        # in a bounded LRU (the unfiltered pane above never lives
        # there), plus the long-poll watch hub. The watch condition is
        # SEPARATE from the serving lock: parked watchers wait on it
        # with no lock held, and _commit notifies it after releasing
        # the serving lock — a parked fleet can never block a scrape.
        self._filter_views = FilteredViewCache(filter_cache_size)
        self.watch_timeout = max(float(watch_timeout), 0.0)
        self.max_watchers = max(0, int(max_watchers))
        self._watch_cond = threading.Condition()
        self._watchers = 0
        self._watch_rev = 0
        # Push-on-delta (peering/notify.py), the coordinator's exact
        # split one tier up. PARENT side: target names whose accepted
        # /peer/notify marked them dirty since the last round; between
        # full sweeps (the --max-staleness cadence — the ONLY
        # correctness mechanism) a round polls only dirty ∪ suspect
        # targets. Cold start (_next_sweep=0) always sweeps first, so a
        # restarted collector that lost its dirty set repairs itself in
        # one round. CHILD side: the sender posts upward whenever the
        # committed inventory's ETag moves; subscribers are whoever
        # polls our /fleet/snapshot with the notify headers.
        # push_notify=False constructs none of this and is the
        # pull-everything round byte for byte.
        self.push_notify = bool(push_notify)
        self._sweep_interval = max(float(sweep_interval), 0.0)
        self._next_sweep = 0.0
        self._dirty: "set" = set()
        self._notify_port = 0
        self.notify_subscriptions: Optional[NotifySubscriptions] = None
        self.notify_sender: Optional[NotifySender] = None
        if self.push_notify:
            ttl = max(
                SUBSCRIPTION_TTL_FLOOR_S,
                SUBSCRIPTION_TTL_SWEEPS * self._sweep_interval,
            )
            self.notify_subscriptions = NotifySubscriptions(ttl, clock=clock)
            self.notify_sender = NotifySender(
                self.notify_subscriptions, token=self.peer_token
            )
        # Delta-sync bookkeeping (all under _lock with the serving
        # state). Per-key generation stamps and tombstones are INTERNAL
        # — the full wire body stays byte-identical to the pre-delta
        # contract; only the ?since= path reads them. The ETag history
        # is the lineage check: a delta for since=S is served only to a
        # client whose If-None-Match names the exact full body this
        # collector published at generation S.
        self.delta_window = max(0, int(delta_window))
        self._entry_gens: Dict[str, int] = {}
        self._region_gens: Dict[str, int] = {}
        self._tombstones: Dict[str, int] = {}
        self._region_tombstones: Dict[str, int] = {}
        self._etag_history: Dict[int, str] = {}
        self._delta_cache: Dict[int, bytes] = {}
        # --state-dir: restore last-good entries for slices still in the
        # targets (a dropped slice's state must not resurrect) and serve
        # them marked restored until each slice's first live poll.
        self._store = InventoryStore(state_dir) if state_dir else None
        self.restored_slices = 0
        if self._store is not None:
            state = self._store.load_state()
            persisted, persisted_regions = state["slices"], state["regions"]
            if state["generation"] is not None:
                # The persisted generation high-water mark: the counter
                # NEVER moves backward across restarts, so a client's
                # ?since ahead of us is always a lost-state artifact
                # (answered with a full resync), never a wrapped
                # counter. Seeding _published with the persisted
                # entries makes the first _commit a normal diff against
                # the pre-restart pane: the restored-flag flips and any
                # dropped keys stamp/tombstone at generation + 1
                # through the one change-tracking path.
                self._generation = state["generation"]
                self._etag_history = dict(state["etag_history"])
                self._tombstones = dict(state["tombstones"])
                self._region_tombstones = dict(state["region_tombstones"])
                if persisted is not None:
                    self._published = (persisted, persisted_regions)
            if persisted and self._federated:
                # Restore-at-root: persisted region/<name>/<slice> keys
                # group back under their configured region; each region
                # serves restored-marked entries until ITS first live
                # scrape, mirroring the slice-entry restore one tier
                # down. A region dropped from the targets must not
                # resurrect.
                for name, state in self._slices.items():
                    prefix = f"region/{name}/"
                    mine = {
                        k: entry
                        for k, entry in persisted.items()
                        if k.startswith(prefix)
                    }
                    if not mine:
                        continue
                    for key, entry in mine.items():
                        restored_entry = dict(entry)
                        restored_entry["restored"] = True
                        state.slices[key] = restored_entry
                    meta = _blank_region_meta()
                    stored_meta = (persisted_regions or {}).get(name) or {}
                    meta.update(
                        {
                            k: stored_meta.get(k)
                            for k in meta
                            if k in stored_meta
                        }
                    )
                    meta["restored"] = True
                    state.entry = meta
                    state.restored = True
                    self.restored_slices += 1
                if self.restored_slices:
                    log.info(
                        "serving %d restored region inventories until "
                        "each region's first live scrape",
                        self.restored_slices,
                    )
            elif persisted:
                for name, entry in persisted.items():
                    state = self._slices.get(name)
                    if state is None:
                        continue
                    restored = dict(_blank_entry())
                    restored.update(
                        {k: entry.get(k) for k in restored if k in entry}
                    )
                    restored["restored"] = True
                    state.entry = restored
                    state.restored = True
                    self.restored_slices += 1
                if self.restored_slices:
                    log.info(
                        "serving %d restored slice entries until their "
                        "first live poll",
                        self.restored_slices,
                    )
        obs_metrics.FLEET_REGIONS.set(
            len(self._slices) if self._federated else 0
        )
        self._commit()

    # -- serving side ------------------------------------------------------

    def inventory_response(self) -> "tuple[bytes, str]":
        """The GET /fleet/snapshot serving hook: cached body + strong
        ETag, rendered at commit time (never per request)."""
        with self._lock:
            return self._body, self._etag

    def delta_response(
        self, since: Optional[int], if_none_match: Optional[str]
    ) -> "tuple[bytes, str]":
        """The GET /fleet/snapshot?since=<generation> serving hook: an
        O(changed) delta when the client's claimed generation is inside
        the lineage window AND its If-None-Match names the exact body
        this collector published at that generation; the FULL body
        otherwise (the resync fallback — a client ahead of us after a
        lost-state restart, behind the window, or off our lineage must
        never be fed an un-appliable diff). Every response carries the
        CURRENT full body's strong ETag — it names the state reached,
        so an in-sync client still 304s and the idle economy holds."""
        with self._lock:
            return self._delta_locked(since, if_none_match)

    def _delta_locked(
        self, since: Optional[int], if_none_match: Optional[str]
    ) -> "tuple[bytes, str]":
        full = (self._body, self._etag)
        if since is None or self.delta_window <= 0:
            return full
        if since == self._generation:
            # In sync: a matching If-None-Match becomes a 304 in
            # the handler (the 304-equivalent of an empty delta); a
            # mismatched one means the client's state is NOT what
            # it claims — full resync.
            if if_none_match != self._etag:
                obs_metrics.FLEET_DELTA_SERVED.labels(
                    outcome="resync"
                ).inc()
            return full
        lineage = self._etag_history.get(since)
        if (
            since > self._generation
            or lineage is None
            or if_none_match != lineage
        ):
            obs_metrics.FLEET_DELTA_SERVED.labels(outcome="resync").inc()
            return full
        body = self._delta_cache.get(since)
        if body is None:
            entries, regions = self._published
            changed = {
                key: entry
                for key, entry in entries.items()
                if self._entry_gens.get(key, self._generation) > since
            }
            tombstones = [
                key
                for key, gen in self._tombstones.items()
                if gen > since
            ]
            regions_changed = regions_tombstones = None
            if regions is not None:
                regions_changed = {
                    key: meta
                    for key, meta in regions.items()
                    if self._region_gens.get(key, self._generation)
                    > since
                }
                regions_tombstones = [
                    key
                    for key, gen in self._region_tombstones.items()
                    if gen > since
                ]
            body, _ = serialize_inventory(
                build_delta(
                    since,
                    self._generation,
                    self._restored,
                    changed,
                    tombstones,
                    regions_changed=regions_changed,
                    regions_tombstones=regions_tombstones,
                )
            )
            if len(self._delta_cache) >= 32:
                # Clients cluster on the current generation minus
                # one; a handful of stragglers is normal, an
                # unbounded spread is not worth caching.
                self._delta_cache.clear()
            self._delta_cache[since] = body
        obs_metrics.FLEET_DELTA_SERVED.labels(outcome="delta").inc()
        return body, self._etag

    # -- the query surface (fleet/query.py) --------------------------------

    def query_response(
        self,
        raw_query: str,
        if_none_match: Optional[str],
        allow_watch: bool = True,
        on_park: Optional[Callable[[], None]] = None,
    ) -> "tuple[int, bytes, Optional[str], Optional[int], bool]":
        """The ``GET /fleet/snapshot?<query>`` serving hook: filtered
        views, per-view delta sync, and the long-poll watch. Returns
        ``(status, body, etag, retry_after_s, filtered)`` — a 200 rides
        the handler's If-None-Match/304 machinery exactly like the
        unfiltered hooks; 400 (a query outside the grammar) and 503
        (the ``--max-watchers`` admission cap) are terminal.

        ``allow_watch=False`` (HEAD requests) answers the current state
        immediately — a prober must never park a handler thread.
        ``on_park`` runs once, just after the watcher is admitted: the
        obs server releases its ``--max-inflight-requests`` slot there,
        so parked watchers are accounted by the watch cap alone and
        cannot starve plain GETs."""
        try:
            query = parse_fleet_query(raw_query)
        except QueryError as e:
            obs_metrics.FLEET_QUERY_REJECTED.inc()
            return 400, f"bad fleet query: {e}\n".encode(), None, None, False
        with self._lock:
            body, etag, filtered = self._answer_locked(query, if_none_match)
        if (
            not allow_watch
            or query.watch_s is None
            or not etag
            or if_none_match != etag
        ):
            # Not a watch, or the client is out of sync: answer NOW
            # (a fresh body, a delta, or — matching If-None-Match —
            # the handler's 304).
            return 200, body, etag, None, filtered
        # In sync and watching: park until the view's generation moves
        # or the window closes. Deadlines are real wall progress
        # (time.monotonic, never the injectable scrape clock): watch
        # semantics are a promise to the network peer holding the
        # socket open.
        deadline = time.monotonic() + min(query.watch_s, self.watch_timeout)
        with self._watch_cond:
            if self._closed or self._watchers >= self.max_watchers:
                obs_metrics.FLEET_WATCH.labels(outcome="rejected").inc()
                return (
                    503,
                    b"watch slots exhausted\n",
                    None,
                    WATCH_RETRY_AFTER_S,
                    filtered,
                )
            self._watchers += 1
            obs_metrics.FLEET_WATCHERS.set(self._watchers)
        try:
            if on_park is not None:
                on_park()
            while True:
                with self._watch_cond:
                    rev = self._watch_rev
                with self._lock:
                    closed = self._closed
                    body, etag, filtered = self._answer_locked(
                        query, if_none_match
                    )
                if etag and etag != if_none_match:
                    obs_metrics.FLEET_WATCH.labels(outcome="delta").inc()
                    return 200, body, etag, None, filtered
                remaining = deadline - time.monotonic()
                if remaining <= 0 or closed:
                    # Window expired idle (or the epoch is ending): the
                    # matching If-None-Match becomes the handler's 304
                    # and the client re-arms its watch.
                    obs_metrics.FLEET_WATCH.labels(outcome="timeout").inc()
                    return 200, body, etag, None, filtered
                with self._watch_cond:
                    # Re-check the revision under the condition: a
                    # commit that landed between computing the answer
                    # and parking must not be slept through.
                    if self._watch_rev == rev and not self._closed:
                        self._watch_cond.wait(remaining)
        finally:
            with self._watch_cond:
                self._watchers -= 1
                obs_metrics.FLEET_WATCHERS.set(self._watchers)

    def _answer_locked(
        self, query: FleetQuery, if_none_match: Optional[str]
    ) -> "tuple[bytes, Optional[str], bool]":
        """One query's (body, etag, filtered) under the serving lock:
        the unfiltered pane rides the existing publish-seam/delta state
        BYTE-IDENTICALLY; a filtered query resolves (and lazily
        revalidates) its view first."""
        if not query.filtered:
            if query.since is None:
                return self._body, self._etag, False
            body, etag = self._delta_locked(query.since, if_none_match)
            return body, etag, False
        view = self._view_locked(query)
        if query.since is None:
            return view.body, view.etag, True
        body, etag = self._view_delta_locked(view, query.since, if_none_match)
        return body, etag, True

    def _view_locked(self, query: FleetQuery) -> FilteredView:
        """Resolve one canonical filter's rendered view, revalidating
        lazily: the first access after the global generation moved (or,
        for max-age views, after the quantized clock crossed a
        boundary) recomputes the filtered entry set — dict work — and
        re-serializes ONLY when the content actually differs. That is
        the whole per-filter economy: at most one serialization per
        distinct filter per generation, zero on idle access."""
        now_q = self._now_quantized() if query.max_age_s is not None else None
        view = self._filter_views.get(query.canonical)
        if (
            view is not None
            and view.validated_gen == self._generation
            and view.eval_now == now_q
        ):
            obs_metrics.FLEET_FILTER_CACHE.labels(outcome="hit").inc()
            return view
        entries, regions = (
            self._published if self._published is not None else ({}, None)
        )
        fentries, fregions = filter_entries(query, entries, regions, now_q)
        published = (fentries, fregions, self._restored)
        if view is None:
            obs_metrics.FLEET_FILTER_CACHE.labels(outcome="miss").inc()
            body, etag = self._render_view(
                query.canonical, published, self._generation
            )
            view = FilteredView(
                query=query,
                view_gen=self._generation,
                body=body,
                etag=etag,
                published=published,
                validated_gen=self._generation,
                eval_now=now_q,
            )
            view.etag_history[self._generation] = etag
            self._filter_views.put(view)
            return view
        obs_metrics.FLEET_FILTER_CACHE.labels(outcome="hit").inc()
        if published != view.published:
            if self._generation == view.view_gen:
                # Membership moved with NO generation movement: entries
                # aged across the max-age horizon between commits.
                # There is no generation to stamp the change with, so
                # the view's delta lineage resets — every delta client
                # of this view resyncs ONCE with the (small) full
                # filtered body, and the watch hub still wakes on the
                # revision bump below.
                view.etag_history.clear()
                view.prev_gen = None
                view.prev_published = None
            else:
                view.prev_gen = view.view_gen
                view.prev_published = view.published
            view.view_gen = self._generation
            view.body, view.etag = self._render_view(
                query.canonical, published, self._generation
            )
            view.published = published
            view.etag_history[view.view_gen] = view.etag
            while len(view.etag_history) > VIEW_HISTORY_DEPTH:
                del view.etag_history[min(view.etag_history)]
            view.delta_bodies.clear()
            view.revision += 1
        view.validated_gen = self._generation
        view.eval_now = now_q
        return view

    def _render_view(
        self, canonical: str, published: "tuple", generation: int
    ) -> "tuple[bytes, str]":
        """Serialize one filtered view: the same schema-versioned
        inventory document plus a ``filter`` key naming the canonical
        query (DeltaMirror carries extra keys through reconstruction,
        so filtered delta clients verify against this exact body)."""
        entries, regions, restored = published
        doc = build_inventory(entries, generation, restored, regions=regions)
        doc["filter"] = canonical
        obs_metrics.FLEET_FILTER_RENDERS.inc()
        return serialize_inventory(doc)

    def _view_delta_locked(
        self,
        view: FilteredView,
        since: int,
        if_none_match: Optional[str],
    ) -> "tuple[bytes, str]":
        """The filtered twin of _delta_locked, over the view's own
        generation lineage (view generations are the SUBSET of global
        generations at which this filter's content changed — the
        ``?since`` a client echoes back is whatever its last filtered
        document said). Delta content is one step deep: a client on the
        view's previous generation (If-None-Match verified) gets the
        O(changed) diff; everyone else resyncs with the full filtered
        body, which the filter already made small."""
        full = (view.body, view.etag)
        if self.delta_window <= 0:
            return full
        if since == view.view_gen:
            if if_none_match != view.etag:
                obs_metrics.FLEET_DELTA_SERVED.labels(outcome="resync").inc()
            return full
        lineage = view.etag_history.get(since)
        if (
            since > view.view_gen
            or lineage is None
            or if_none_match != lineage
            or since != view.prev_gen
            or view.prev_published is None
        ):
            obs_metrics.FLEET_DELTA_SERVED.labels(outcome="resync").inc()
            return full
        body = view.delta_bodies.get(since)
        if body is None:
            prev_entries, prev_regions, _ = view.prev_published
            entries, regions, restored = view.published
            changed = {
                key: entry
                for key, entry in entries.items()
                if prev_entries.get(key) != entry
            }
            tombstones = [
                key for key in prev_entries if key not in entries
            ]
            regions_changed = regions_tombstones = None
            if regions is not None:
                prev_region_map = prev_regions or {}
                regions_changed = {
                    key: meta
                    for key, meta in regions.items()
                    if prev_region_map.get(key) != meta
                }
                regions_tombstones = [
                    key for key in prev_region_map if key not in regions
                ]
            doc = build_delta(
                since,
                view.view_gen,
                restored,
                changed,
                tombstones,
                regions_changed=regions_changed,
                regions_tombstones=regions_tombstones,
            )
            doc["filter"] = view.query.canonical
            obs_metrics.FLEET_FILTER_RENDERS.inc()
            body, _ = serialize_inventory(doc)
            view.delta_bodies.clear()
            view.delta_bodies[since] = body
        obs_metrics.FLEET_DELTA_SERVED.labels(outcome="delta").inc()
        return body, view.etag

    def _current_entries(
        self,
    ) -> "tuple[Dict[str, Dict[str, Any]], Optional[Dict[str, Dict[str, Any]]]]":
        """The (slices, regions) pair the inventory publishes: per-slice
        entries either directly (slices mode) or merged across regions
        (collectors mode, where the per-target meta becomes the regions
        map)."""
        if self._federated:
            entries: Dict[str, Dict[str, Any]] = {}
            for state in self._slices.values():
                entries.update(
                    {k: dict(v) for k, v in state.slices.items()}
                )
            regions = {n: dict(s.entry) for n, s in self._slices.items()}
            return entries, regions
        return {n: dict(s.entry) for n, s in self._slices.items()}, None

    def inventory_payload(self) -> Dict[str, Any]:
        with self._lock:
            entries, regions = self._current_entries()
            return build_inventory(
                entries,
                self._generation,
                any(s.restored for s in self._slices.values()),
                regions=regions,
            )

    def _commit(self) -> "set":
        """Publish the current entries: render body/ETag only on a
        DISTINCT inventory (the 304 economy), stamp per-key generations
        and tombstones for the delta protocol, refresh the gauges, and
        persist churn-free. Returns the set of slice keys whose entries
        changed (including dropped keys) — the O(changed) currency the
        HA divergence check rides."""
        entries, regions = self._current_entries()
        stale = sum(1 for e in entries.values() if e.get("stale"))
        regions_stale = (
            sum(1 for m in regions.values() if m.get("stale"))
            if regions is not None
            else 0
        )
        restored = any(s.restored for s in self._slices.values())
        changed_keys: "set" = set()
        notify_generation, notify_etag = 0, None
        with self._lock:
            if self._closed:
                return changed_keys
            if self._body is None or (entries, regions) != self._published:
                prev_entries, prev_regions = (
                    self._published
                    if self._published is not None
                    else ({}, None)
                )
                if self._published is not None:
                    self._generation += 1
                gen = self._generation
                # One pass computes the changed set AND stamps it: the
                # publish decision, the delta protocol's per-key
                # generations, and the HA consumer's changed-key report
                # must never disagree about what moved.
                for key, entry in entries.items():
                    if prev_entries.get(key) != entry:
                        self._entry_gens[key] = gen
                        changed_keys.add(key)
                    self._tombstones.pop(key, None)
                for key in prev_entries:
                    if key not in entries:
                        self._entry_gens.pop(key, None)
                        self._tombstones[key] = gen
                        changed_keys.add(key)
                prev_region_map = prev_regions or {}
                for key, meta in (regions or {}).items():
                    if prev_region_map.get(key) != meta:
                        self._region_gens[key] = gen
                    self._region_tombstones.pop(key, None)
                for key in prev_region_map:
                    if key not in (regions or {}):
                        self._region_gens.pop(key, None)
                        self._region_tombstones[key] = gen
                self._published = (entries, regions)
                self._restored = restored
                self._body, self._etag = serialize_inventory(
                    build_inventory(
                        entries, self._generation, restored, regions=regions
                    )
                )
                self._etag_history[gen] = self._etag
                notify_generation, notify_etag = gen, self._etag
                self._delta_cache.clear()
                while len(self._etag_history) > max(1, self.delta_window):
                    del self._etag_history[min(self._etag_history)]
                # Tombstones older than the servable window are dead
                # weight: any client that far behind full-resyncs
                # anyway (its lineage is gone), so the set stays
                # bounded by the window, not by keys-ever-seen.
                floor = min(self._etag_history)
                for stones in (self._tombstones, self._region_tombstones):
                    for key in [k for k, g in stones.items() if g <= floor]:
                        del stones[key]
            obs_metrics.FLEET_SLICES.set(len(entries))
            obs_metrics.FLEET_SLICES_STALE.set(stale)
            obs_metrics.FLEET_REGIONS_STALE.set(regions_stale)
            obs_metrics.FLEET_RESTORED.set(1 if restored else 0)
        if self._store is not None:
            self._store.save(
                entries,
                regions,
                generation=self._generation,
                etag_history=self._etag_history,
                tombstones=self._tombstones,
                region_tombstones=self._region_tombstones,
            )
        self._notify_upward(notify_generation, notify_etag)
        if notify_etag:
            # The inventory moved: wake every parked watcher (outside
            # the serving lock — waking must never block a scrape).
            # Each wakes, revalidates ITS view lazily, and either
            # answers its filtered delta or re-parks if the movement
            # missed its filter.
            with self._watch_cond:
                self._watch_rev += 1
                self._watch_cond.notify_all()
        return changed_keys

    def _notify_upward(
        self, generation: int, etag: Optional[str]
    ) -> None:
        """The child-side push trigger, collector-as-child: a commit
        re-rendered the served inventory (its ETag moved), so tell any
        subscribed higher tier — a root over a region, a higher root
        over a root. Strictly best-effort and strictly non-blocking
        (peering/notify.NotifySender)."""
        if self.notify_sender is not None and etag:
            self.notify_sender.publish(generation, etag)

    # -- polling side ------------------------------------------------------

    def poll_round(self) -> "set":
        """One scrape round: every slice's chain walk dispatched onto
        the bounded pool in rotated order (budget skips land on whoever
        rotation puts last — the peer tier's fairness rule), then one
        commit. Returns the commit's changed slice keys so the caller's
        per-round consumers (the HA divergence check) can stay
        O(changed) instead of re-walking the fleet."""
        obs_metrics.FLEET_SCRAPE_ROUNDS.inc()
        started = time.perf_counter()
        budget = Budget(self.round_budget, time.perf_counter)
        names = self._round_targets()
        offset = self._round_offset % len(names) if names else 0
        self._round_offset += 1
        rotated = names[offset:] + names[:offset]
        self._fanout.run(
            [
                partial(self._poll_target, self._slices[name], budget)
                for name in rotated
            ]
        )
        changed = self._commit()
        obs_metrics.FLEET_SCRAPE_DURATION.observe(
            time.perf_counter() - started
        )
        return changed

    def _round_targets(self) -> List[str]:
        """Which target names this round polls. Pull mode (push_notify
        off): every target, always — byte-identical to the pre-push
        round. Push mode: a full CONFIRMATION SWEEP of every target when
        the sweep deadline passed (the only correctness mechanism — it
        catches dropped notifications, dead children that cannot push
        their own death, rotated tokens, and a restarted collector whose
        cold _next_sweep=0 forces an immediate sweep); otherwise only
        dirty ∪ suspect targets, where a suspect has a chain member with
        a failure streak in progress (so the 2-miss confirmation and the
        confirmed-dead backoff cadence advance exactly as they would
        under pull) or was never attempted AT ALL (a fresh targets-file
        add must not age until the sweep). A chain member the walk
        deliberately skips — everyone past the leader — is NOT suspect:
        it has no failure streak and its target was reached, and
        treating it as one would re-poll every multi-host slice every
        round, which is exactly the idle cost push exists to shed."""
        names = list(self._slices)
        if not self.push_notify:
            return names
        now = self._clock()
        with self._lock:
            dirty = set(self._dirty)
            self._dirty.clear()
            obs_metrics.DIRTY_CHILDREN.set(0)
        if now >= self._next_sweep:
            self._next_sweep = now + self._sweep_interval
            return names
        return [
            name
            for name in names
            if name in dirty
            or any(
                h.consecutive_failures > 0
                for h in self._slices[name].hosts
            )
            or not any(
                h.ever_reached for h in self._slices[name].hosts
            )
        ]

    def set_notify_port(self, port: int) -> None:
        """The obs server's BOUND port (cmd/fleet wires it once the
        server exists — the flag may say 0 = ephemeral): advertised in
        this poller's subscribe headers so children know where to POST
        their notifications back."""
        with self._lock:
            self._notify_port = int(port or 0)

    def mark_dirty(self, name: str, generation: int = 0, etag: str = "") -> bool:
        """The POST /peer/notify receive hook: mark the named child
        dirty for the next round. ``name`` is validated against this
        collector's OWN configured targets (never the connection address
        — NAT and shared-address harnesses would lie); an unknown name
        returns False and dirties nothing, so a stale subscription or a
        mis-pointed child cannot steer the poll loop. The generation and
        etag are advisory (logged, never trusted): the poll itself is
        the only fact-bearing channel."""
        if name not in self._slices:
            return False
        with self._lock:
            if self._closed:
                return False
            self._dirty.add(name)
            obs_metrics.DIRTY_CHILDREN.set(len(self._dirty))
        log.debug(
            "target %s notified delta (generation %s, etag %s)",
            name, generation, etag,
        )
        return True

    def _poll_target(self, state: _TargetState, budget: Budget) -> None:
        """Walk one target's chain. In slices mode the walk stops at the
        first member answering with a slice section (the leader), keeps
        walking past live-but-sectionless members; in collectors mode
        ANY member serving a valid inventory is authoritative (a region
        collector either has the region's pane or errors — there is no
        sectionless middle). A member inside its confirmed-dead backoff
        window is passed over without a poll."""
        best_live: Optional[_HostState] = None
        now = self._clock()
        for hstate in state.hosts:
            if hstate.confirmed_down and now < hstate.next_attempt:
                continue  # backoff window closed; try the next link
            if budget.spent(_BUDGET_GRACE_S):
                obs_metrics.FLEET_POLLS.labels(outcome="skipped").inc()
                log.warning(
                    "fleet round budget spent; skipping target %s this "
                    "round",
                    state.target.name,
                )
                break
            timeout = self.peer_timeout
            remaining = budget.remaining()
            if remaining is not None:
                timeout = min(timeout, remaining)
            try:
                snapshot = self._fetch(hstate, timeout, state.target.name)
            except OversizeBodyError as e:
                # Still one miss, but its own outcome: a body over the
                # tier's cap is a named anomaly (junk upstream, or an
                # inventory that outgrew MAX_INVENTORY_BYTES), not
                # generic wire noise.
                obs_metrics.FLEET_POLLS.labels(outcome="oversize").inc()
                self._host_failed(state, hstate, e)
                continue
            except Exception as e:  # noqa: BLE001 - any failure = one miss
                obs_metrics.FLEET_POLLS.labels(outcome="error").inc()
                self._host_failed(state, hstate, e)
                continue
            obs_metrics.FLEET_POLLS.labels(outcome="ok").inc()
            self._host_succeeded(hstate, snapshot)
            if self._federated:
                self._refresh_region(state, hstate, snapshot)
                return
            if snapshot.get("slice") is not None:
                self._refresh_entry(state, hstate, snapshot)
                return
            # Live but aggregateless (a partitioned would-be leader, or
            # a follower): reachability evidence, keep walking for the
            # member that actually carries the verdict.
            if best_live is None:
                best_live = hstate
        if best_live is not None:
            self._refresh_entry(state, best_live, best_live.last_snapshot)
            return
        if self._federated:
            self._mark_region_unreached(state)
        else:
            self._mark_unreached(state)

    def _now_quantized(self) -> int:
        return (
            int(self._wall_clock())
            // LAST_SEEN_QUANTUM_S
            * LAST_SEEN_QUANTUM_S
        )

    def _refresh_region(
        self,
        state: _TargetState,
        hstate: _HostState,
        doc: Dict[str, Any],
    ) -> None:
        """One region's live scrape: merge its per-slice entries
        VERBATIM under region/<name>/<slice> keys (only the ``region``
        attribution field is added — the federation identity property),
        refresh the region meta, clear the restore regime."""
        merged: Dict[str, Dict[str, Any]] = {}
        for sname, sentry in doc.get("slices", {}).items():
            entry = dict(sentry)
            prior = entry.get("region")
            # Nested federation composes the attribution path: a root's
            # entries arrive already region-stamped by the tier below.
            entry["region"] = (
                state.target.name
                if not prior
                else f"{state.target.name}/{prior}"
            )
            merged[f"region/{state.target.name}/{sname}"] = entry
        state.slices = merged
        state.entry = {
            "reachable": True,
            "stale": False,
            "collector": hstate.host,
            "last_seen_unix": self._now_quantized(),
            "generation": doc.get("generation"),
            "restored": False,
        }
        state.restored = False

    def _mark_region_unreached(self, state: _TargetState) -> None:
        """No collector in the region's chain answered this round. Same
        evidence rule as a dark slice: every chain member confirmed down
        — never a budget skip or a sat-out backoff window. The region's
        merged slice entries flip degraded-stale with their data (and
        ``last_seen_unix``) preserved: partial data beats no data, one
        tier up."""
        if not all(h.confirmed_down for h in state.hosts):
            return
        if state.entry.get("stale"):
            return
        meta = dict(state.entry)
        meta["reachable"] = False
        meta["stale"] = True
        state.entry = meta
        state.slices = {
            key: {**entry, "stale": True}
            for key, entry in state.slices.items()
        }

    def _refresh_entry(
        self,
        state: _TargetState,
        hstate: _HostState,
        snapshot: Dict[str, Any],
    ) -> None:
        section = snapshot.get("slice")
        if section is None:
            # A live-but-sectionless chain member (the leader missed ONE
            # poll and a follower answered): reachability evidence only.
            # The VERDICT fields keep their last-known values — a single
            # transient leader miss must not null data that even a fully
            # dark slice keeps (the degraded-stale rule); a slice that
            # never had a verdict stays at the blank entry's nulls.
            section = {
                k: state.entry.get(k)
                for k in (
                    "healthy_hosts", "total_hosts", "degraded", "sick_chips"
                )
            }
        state.entry = {
            "reachable": True,
            "stale": False,
            "leader": snapshot.get("hostname"),
            "last_seen_unix": self._now_quantized(),
            "healthy_hosts": section.get("healthy_hosts"),
            "total_hosts": section.get("total_hosts"),
            "degraded": section.get("degraded"),
            "sick_chips": section.get("sick_chips"),
            "mode": snapshot.get("mode"),
            "generation": snapshot.get("generation"),
            "restored": False,
        }
        state.restored = False

    def _mark_unreached(self, state: _TargetState) -> None:
        """No chain member answered this round. Degraded-stale is
        declared on EVIDENCE — every chain member confirmed down — never
        on a round that merely ran out of budget or sat out backoff
        windows."""
        if not all(h.confirmed_down for h in state.hosts):
            return
        if state.entry.get("stale"):
            return
        entry = dict(state.entry)
        entry["reachable"] = False
        entry["stale"] = True
        state.entry = entry

    def _host_succeeded(
        self, hstate: _HostState, snapshot: Dict[str, Any]
    ) -> None:
        if hstate.confirmed_down:
            log.info("fleet target %s reachable again", hstate.host)
        hstate.consecutive_failures = 0
        hstate.backoff_attempt = 0
        hstate.next_attempt = 0.0
        hstate.ever_reached = True
        hstate.last_snapshot = snapshot

    def _host_failed(
        self, state: _TargetState, hstate: _HostState, error: BaseException
    ) -> None:
        hstate.consecutive_failures += 1
        if hstate.confirmed_down:
            delay = hstate.backoff.delay(min(hstate.backoff_attempt, 63))
            hstate.backoff_attempt += 1
            hstate.next_attempt = self._clock() + delay
            if hstate.consecutive_failures == CONFIRM_POLLS:
                log.warning(
                    "target %s chain member %s confirmed unreachable "
                    "after %d consecutive failed polls (%s); re-polling "
                    "under backoff",
                    state.target.name,
                    hstate.host,
                    hstate.consecutive_failures,
                    error,
                )
        else:
            log.info(
                "poll of target %s chain member %s failed (%d/%d before "
                "confirmation): %s",
                state.target.name,
                hstate.host,
                hstate.consecutive_failures,
                CONFIRM_POLLS,
                error,
            )

    # -- the HTTP fetch (the peer tier's persistent-connection shape) ------

    def _fetch(
        self, hstate: _HostState, timeout: float, name: str
    ) -> Dict[str, Any]:
        return fetch_with_stale_retry(
            hstate, partial(self._request, hstate, timeout, name)
        )

    def _request(
        self, hstate: _HostState, timeout: float, name: str
    ) -> Dict[str, Any]:
        extra_headers = None
        with self._lock:
            # Same closed-gate discipline as the peer poller's _request:
            # a straggler round racing close() must not reopen a dropped
            # connection (the constructor does no IO under the lock).
            if self._closed:
                raise PeerSnapshotError("collector closed")
            if hstate.conn is None:
                hstate.conn = http.client.HTTPConnection(
                    hstate.host, hstate.port, timeout=timeout
                )
            if self.push_notify and self._notify_port:
                # Subscribe on the poll we already send: advertise our
                # notify port and the name we know this child by (the
                # targets-file entry — echoed back so mark_dirty can
                # validate it against the configured target set).
                extra_headers = {
                    NOTIFY_PORT_HEADER: str(self._notify_port),
                    NOTIFY_NAME_HEADER: name,
                }
        return request_snapshot(
            hstate,
            timeout,
            self._poll_path,
            self._parse,
            self._max_body,
            token=self.peer_token,
            not_modified_counter=obs_metrics.FLEET_SNAPSHOT_NOT_MODIFIED,
            # The federation hop rides the delta protocol: a region's
            # inventory is O(slices) wide, but what moves per round is
            # O(changed). Peer snapshots are per-node and tiny — no
            # delta below the fleet tier.
            delta=self._federated,
            extra_headers=extra_headers,
        )

    def close(self) -> None:
        """Epoch end: retire the pool and every persistent connection,
        zero this collector's gauges (a targets reload rebuilds the
        collector — a dropped slice must not stay latched stale)."""
        with self._lock:
            self._closed = True
            self._dirty.clear()
            self._filter_views.clear()
        with self._watch_cond:
            # Parked watchers must observe the close and answer out —
            # an epoch teardown cannot wait out their watch windows.
            self._watch_cond.notify_all()
        if self.notify_sender is not None:
            self.notify_sender.close()
        obs_metrics.DIRTY_CHILDREN.set(0)
        self._fanout.shutdown(wait=False)
        for state in self._slices.values():
            for hstate in state.hosts:
                drop_connection(hstate)
        obs_metrics.FLEET_SLICES.set(0)
        obs_metrics.FLEET_SLICES_STALE.set(0)
        obs_metrics.FLEET_REGIONS.set(0)
        obs_metrics.FLEET_REGIONS_STALE.set(0)
        obs_metrics.FLEET_RESTORED.set(0)
