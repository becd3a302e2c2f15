"""The slice poller and aggregator: reachability, leadership,
aggregation (twin: ``gpu_feature_discovery_tpu/peering/coordinator.py``,
whole: the same state machine, wire and metrics).

One coordinator per config epoch (built beside the engine in
cmd/main.run). Two faces, touched by different threads:

- **Serving** (introspection-server handler threads): ``publish_local``
  is called by the run loop after every label write and caches the
  snapshot body SERIALIZED ONCE per distinct label set, with a strong
  ETag; ``snapshot_response`` hands that ``(body, etag)`` pair to the
  ``GET /peer/snapshot`` handler, which answers ``304 Not Modified`` to a
  matching ``If-None-Match``. Lock-protected: a poll may land mid-write.
- **Polling** (one engine pool thread driving a bounded fan-out pool):
  ``labels()``, the Labeler protocol, runs one poll round over the peers
  and returns this cycle's slice labels. Inside a round, polls run on up
  to ``--peer-fanout`` pool threads, so per-peer state transitions are
  applied under the serving lock (the run loop's ``membership_token``
  reads race an in-flight round).

Reachability:

- Every poll is bounded by ``--peer-timeout``, and polls run
  CONCURRENTLY (``--peer-fanout``, default ``min(8, peers)``; ``1`` is
  the sequential round). Each peer keeps ONE persistent keep-alive
  connection, reconnecting on failure (a stale reused connection is
  retried once on a fresh one before anything counts as a miss); the
  poller sends ``If-None-Match`` and a ``304`` reuses the last parsed
  snapshot, so an idle slice's round is N header exchanges.
- A peer is confirmed UNREACHABLE only after ``CONFIRM_POLLS``
  consecutive failed polls; one successful poll clears it. The grace is
  for ESTABLISHED peers only: a peer this epoch has never reached counts
  down on its first miss.
- Confirmed-dead peers are re-polled under capped jittered backoff
  (utils/retry.BackoffPolicy).
- One round is bounded by ``round_budget`` (0.8 x ``--labeler-timeout``
  from ``new_slice_coordinator``): a peer the budget cannot reach this
  round is SKIPPED with its state untouched (``outcome="skipped"``), so
  slow peers can never pin the slice source past the engine's
  per-labeler deadline, whose miss would suppress the supervisor's state
  persistence.

Leadership is derived, not elected: the member with the LOWEST worker id
among the reachable set leads and publishes the aggregate. A daemon that
can reach NO peer never claims leadership; it publishes
``slice.role=follower`` and ``slice.leader-seen=false``.

Two-tier cohort aggregation (``--cohort-size`` > 0): the hostname list
partitions into FIXED contiguous cohorts (peering/cohort.py). Everyone
polls its own cohort's siblings; the derived cohort leader serves its
members' verdicts as an aggregate section on its own snapshot and probes
lower cohorts' leadership chains to decide whether it is the slice
leader; the slice leader polls only each cohort's chain, and a cohort
whose whole chain is dark is marked degraded and polled member by
member under the round budget. Leadership-chain links keep their OWN
per-peer states (``_tier_state``). ``--cohort-size=0`` (the default)
builds none of this.

Push-on-delta (``--push-notify``, peering/notify.py): this daemon POSTs a
hint to its subscribed pollers when its snapshot moves, and as a poller
polls only dirty and suspect peers between full sweeps.

The peer list comes from ``WORKER_HOSTNAMES``/``WORKER_ID``
(peering/worker_env.py), where the twin reads ``TPU_WORKER_HOSTNAMES``.
"""

from __future__ import annotations

import http.client
import logging
import threading
import time
from dataclasses import dataclass, field
from functools import partial
from typing import Any, Callable, Dict, List, Optional, Tuple

from gpu_feature_discovery_tpu_torch.lm.labels import Labels
from gpu_feature_discovery_tpu_torch.lm.slice_labeler import slice_labels
from gpu_feature_discovery_tpu_torch.obs import metrics as obs_metrics
from gpu_feature_discovery_tpu_torch.peering.cohort import (
    chain_ids,
    cohort_index,
    cohort_partition,
    resolve_cohort_size,
)
from gpu_feature_discovery_tpu_torch.peering.notify import (
    NOTIFY_NAME_HEADER,
    NOTIFY_PORT_HEADER,
    NotifySender,
    NotifySubscriptions,
    SUBSCRIPTION_TTL_SWEEPS,
    resolve_push_notify,
)
from gpu_feature_discovery_tpu_torch.peering.snapshot import (
    MAX_SNAPSHOT_BYTES,
    PEER_SNAPSHOT_PATH,
    PeerSnapshotError,
    build_cohort_aggregate,
    build_slice_section,
    build_snapshot,
    parse_snapshot,
    serialize_snapshot,
)
from gpu_feature_discovery_tpu_torch.utils.fanout import BoundedPool
from gpu_feature_discovery_tpu_torch.utils.retry import BackoffPolicy

log = logging.getLogger("tfd.peering")

# Widest fan-out the auto default resolves to: 8 concurrent polls keeps
# a 64-host round at ~8x the fast-poll cost (sub-ms each on reused
# connections) while a storm of slow peers costs ceil(slow/8) x timeout
# instead of slow x timeout. Wider helps only slices with more than 8
# SIMULTANEOUSLY slow-but-alive peers, at the price of idle pool
# threads on every daemon — operators can raise --peer-fanout for that.
AUTO_FANOUT_CAP = 8

# Connection-lifecycle failures a REUSED keep-alive connection may see
# when the server closed it between rounds (peer restart, idle reap):
# retried once on a fresh connection before anything counts as a miss —
# reuse must never mint failures a fresh-connection poll would not see.
STALE_CONN_ERRORS = (
    http.client.RemoteDisconnected,
    http.client.CannotSendRequest,
    ConnectionResetError,
    BrokenPipeError,
)

# Consecutive failed polls before a peer counts as unreachable — the
# same 2-consecutive confirmation the straggler detector uses
# (lm/health.STRAGGLER_CONFIRM_PROBES): a verdict that moves labels
# must survive one repetition.
CONFIRM_POLLS = 2

# Poll-tier names, sent as the X-TFD-Poll-Tier request header in
# hierarchical mode so the wire itself says which plane a request
# belongs to (the peer.tier-partition fault site drops exactly the
# "slice" plane at the serving handler — obs/server.py). Flat-mode polls
# send NO tier header.
TIER_COHORT = "cohort"    # intra-cohort sibling polls
TIER_SLICE = "slice"      # slice leader <-> cohort leadership chain
TIER_DIRECT = "direct"    # degraded-cohort direct-poll fallback
POLL_TIER_HEADER = "X-TFD-Poll-Tier"

# The /peer/snapshot auth header (--peer-token): deliberately the SAME
# header POST /probe authenticates with (obs/server.py) — one shared-
# secret transport for the whole introspection surface, verified through
# the same hmac.compare_digest path. Sent by this poller and by the
# twin's fleet collector whenever a token is configured.
PEER_TOKEN_HEADER = "X-TFD-Probe-Token"

# Backoff schedule for re-polling a CONFIRMED-dead peer: base one cycle
# of patience, capped well under the default sleep interval so a healed
# peer is noticed within a few cycles even on a long-interval daemon.
PEER_BACKOFF_BASE_S = 1.0
PEER_BACKOFF_CAP_S = 30.0

# Notify-subscription TTL floor: with a sub-second sweep cadence (the
# hermetic harnesses, or an operator who left --max-staleness tiny) the
# 3-sweeps TTL would expire a live parent between its own polls.
SUBSCRIPTION_TTL_FLOOR_S = 90.0


@dataclass
class PeerEndpoint:
    """One slice peer's address. ``hostname`` is the raw
    WORKER_HOSTNAMES entry (the identity peers are known by);
    ``host``/``port`` is where its obs server answers — an entry may
    carry an explicit ``:port`` (the hermetic harness runs N daemons on
    one address), otherwise every peer is assumed to serve on this
    daemon's own metrics port."""

    worker_id: int
    hostname: str
    host: str
    port: int

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}{PEER_SNAPSHOT_PATH}"


def split_host_port(entry: str, default_port: int) -> "tuple[str, int]":
    """Split one WORKER_HOSTNAMES entry into (host, port).

    ``[::1]:9101`` / ``[::1]`` — the bracketed IPv6 forms — yield the
    unbracketed address; an UNBRACKETED entry with more than one colon
    (a bare IPv6 address like ``::1`` or ``fe80::2``) is host-only: its
    trailing ``:1``/``:2`` group is part of the address, not a port
    (rpartition used to mis-split ``::1`` into host ``::`` port 1).
    Only a single-colon ``host:port`` with a numeric port carries an
    explicit port; everything else is a bare host on the default port.
    """
    if entry.startswith("["):
        bracket, sep, rest = entry.partition("]")
        if sep:
            host = bracket[1:]
            if not rest:
                return host, default_port
            if rest.startswith(":") and rest[1:].isdigit():
                return host, int(rest[1:])
        # Malformed bracket form: treat the raw entry as a bare host
        # rather than guessing at a split.
        return entry, default_port
    host, sep, port = entry.rpartition(":")
    if sep and port.isdigit() and ":" not in host:
        return host, int(port)
    return entry, default_port


@dataclass
class _PeerState:
    consecutive_failures: int = 0
    ever_reached: bool = False
    last_snapshot: Optional[Dict[str, Any]] = None
    next_attempt: float = 0.0
    backoff_attempt: int = 0
    # Connection-reuse + delta-polling state. Touched only by the single
    # poll task a round dispatches per peer (rounds never overlap), so
    # unlike the verdict fields above these need no lock.
    conn: Optional[http.client.HTTPConnection] = None
    etag: Optional[str] = None
    # Whether this state's verdict transitions drive the per-peer
    # tfd_peer_unreachable gauge. In hierarchical mode one peer can be
    # tracked on TWO planes at once (its slice-tier leadership link and
    # the direct/member plane); only the member-plane state owns the
    # gauge, or a tier-partitioned-but-alive peer would flap the series
    # between 1 and 0 every round.
    owns_gauge: bool = True
    backoff: BackoffPolicy = field(
        default_factory=lambda: BackoffPolicy(
            base=PEER_BACKOFF_BASE_S, cap=PEER_BACKOFF_CAP_S
        )
    )

    @property
    def confirmed_down(self) -> bool:
        if not self.ever_reached:
            # No confirmation grace for a peer this epoch has never
            # seen: the 2-poll window exists to ride out a transient
            # blip in an ESTABLISHED conversation, not to let a fresh
            # (possibly partitioned) epoch presume the slice healthy.
            return self.consecutive_failures >= 1
        return self.consecutive_failures >= CONFIRM_POLLS


@dataclass(frozen=True)
class SliceView:
    """One aggregation round's verdict (lm/slice_labeler.slice_labels
    renders it). The cohort fields stay at their defaults on a flat
    (single-tier) coordinator, which keeps the rendered label set
    byte-identical to the pre-cohort family."""

    role: str                    # "leader" | "cohort-leader" | "follower"
    leader_hostname: str
    leader_seen: bool
    healthy_hosts: int
    total_hosts: int
    degraded: bool
    sick_chips: int
    cohort: int = 0                       # own cohort index (hier only)
    cohorts: int = 0                      # cohort count; 0 = flat
    degraded_cohorts: Tuple[int, ...] = ()  # served by direct-poll fallback


@dataclass
class _CohortView:
    """The slice leader's view of ONE other cohort, resolved per round
    from the leadership-chain states (and the direct-poll fallback when
    the chain is dark)."""

    index: int
    leader_id: Optional[int]      # live cohort leader found on the chain
    degraded: bool                # chain dark -> direct-poll fallback
    healthy: int                  # reachable members (leader included)
    sick: int                     # summed member sick-chip counts


class SliceCoordinator:
    """See module docstring. Implements the Labeler protocol —
    ``labels()`` is one poll round + aggregation."""

    def __init__(
        self,
        worker_id: int,
        hostnames: List[str],
        default_port: int,
        peer_timeout: float,
        round_budget: Optional[float] = None,
        clock: Callable[[], float] = time.monotonic,
        backoff_factory: Optional[Callable[[], BackoffPolicy]] = None,
        fanout: Optional[int] = None,
        cohort_size: int = 0,
        peer_token: str = "",
        push_notify: bool = False,
        sweep_interval: float = 0.0,
    ):
        if not 0 <= worker_id < len(hostnames):
            raise ValueError(
                f"worker_id {worker_id} out of range for "
                f"{len(hostnames)} hostnames"
            )
        self.worker_id = worker_id
        self.hostname = split_host_port(hostnames[worker_id], default_port)[0]
        self.total_hosts = len(hostnames)
        self.peer_timeout = float(peer_timeout)
        # None = unbounded round (the hermetic harness's tiny slices);
        # production (new_slice_coordinator) always bounds it under the
        # engine's per-labeler deadline.
        self.round_budget = (
            float(round_budget) if round_budget is not None else None
        )
        self._clock = clock
        # Sent on every poll when configured (--peer-token); the serving
        # side requires it the same way, so a tokened slice keeps
        # coordinating while anonymous off-node scrapes are rejected.
        self.peer_token = peer_token or ""
        self._round_offset = 0
        self._backoff_factory = backoff_factory
        self._peers: List[PeerEndpoint] = []
        self._peer_state: Dict[int, _PeerState] = {}
        for i, entry in enumerate(hostnames):
            if i == self.worker_id:
                continue
            host, port = split_host_port(entry, default_port)
            self._peers.append(PeerEndpoint(i, entry, host, port))
            self._peer_state[i] = self._new_state()
        self._peer_by_id = {p.worker_id: p for p in self._peers}
        # Two-tier cohort partition (--cohort-size): () = flat, exactly
        # the single-tier coordination this module always ran. The
        # partition is a PURE function of (host count, size) — every
        # member derives the identical table (peering/cohort.py).
        self.cohort_size = int(cohort_size or 0)
        self._cohorts = cohort_partition(self.total_hosts, self.cohort_size)
        self._hier = len(self._cohorts) > 1
        self._my_cohort = (
            cohort_index(self.worker_id, self.cohort_size) if self._hier else 0
        )
        # Slice-tier leadership-link state (chain polls), separate from
        # the member-plane _peer_state: under an inter-tier partition a
        # peer can be dark on the leadership link while answering direct
        # polls, and one shared state would oscillate between the two
        # verdicts forever. Lazily populated; gauge ownership stays with
        # the member plane (_PeerState.owns_gauge).
        self._tier_state: Dict[int, _PeerState] = {}
        self._tier_round_offset = 0
        # Bounded poll fan-out: None/0 = auto (min(AUTO_FANOUT_CAP,
        # peers)); an explicit width is capped at the peer count (extra
        # threads could never run) and floored at 1 (the sequential
        # round, which constructs NO pool at all — pinned). The pool is
        # the extracted utils/fanout primitive; both tiers of a
        # hierarchical round share it.
        peers = max(1, len(self._peers))
        self.fanout = (
            min(AUTO_FANOUT_CAP, peers)
            if not fanout
            else max(1, min(int(fanout), peers))
        )
        self._fanout = BoundedPool(
            self.fanout, name=f"tfd-peer-poll-w{worker_id}"
        )
        # Serving-side state (handler threads read, run loop writes).
        self._lock = threading.Lock()
        self._local_labels: Dict[str, str] = {}
        self._local_mode: Optional[str] = None
        self._generation = 0
        # The serialized snapshot + strong ETag, rendered once per
        # DISTINCT publish (serialize_snapshot); None until the first
        # publish or snapshot_response call of the epoch.
        self._snapshot_body: Optional[bytes] = None
        self._snapshot_etag: Optional[str] = None
        # The slice-aggregate wire section (snapshot.build_slice_section)
        # extracted from the last published PRE-strip label set; None on
        # followers, so their documents stay byte-identical.
        self._slice_section: Optional[Dict[str, Any]] = None
        # Flipped by close(): an in-flight round abandoned by an epoch
        # teardown (engine.close does not wait for stragglers) must not
        # reopen connections the teardown just dropped.
        self._closed = False
        # Reachable-membership fingerprint as of the last completed poll
        # round; read by the run loop's peer-delta producer
        # (cmd/events.DeltaTracker) from the main thread while the NEXT
        # round may already be polling on the engine thread — hence
        # stored under the serving lock, not read from _peer_state.
        self._membership: Optional[frozenset] = None
        # Hierarchical round state, committed under the serving lock at
        # the end of each _poll_hier round: the derived SliceView, the
        # cohort aggregate this daemon serves while it leads its cohort
        # (rides the published snapshot — same body/ETag/304 machinery),
        # and the current role (the peer.cohort-leader-dead fault gate).
        self._last_view: Optional[SliceView] = None
        self._cohort_aggregate: Optional[Dict[str, Any]] = None
        self._role: str = "follower"
        # Hermetic-harness fault scoping (tests/slice_fixture.py): the
        # fault registry is process-global there, so the chaos rows arm
        # these per-worker flags instead. Production arms the real
        # TFD_FAULT_SPEC sites; both are enacted at the serving handler
        # via serving_fault().
        self.force_tier_partition = False
        self.force_cohort_leader_dead = False
        # Push-on-delta (peering/notify.py). PARENT side: ids an accepted
        # /peer/notify marked dirty since the last round; between full
        # sweeps (the --max-staleness cadence — the ONLY correctness
        # mechanism) a round polls only dirty ∪ suspect peers.
        # sweep_interval 0 sweeps EVERY round — push off the hot path
        # entirely; cold start (_next_sweep=0) always sweeps first, so a
        # restarted parent that lost its dirty set repairs itself in one
        # round. CHILD side: the sender posts upward whenever the served
        # snapshot's ETag moves; subscribers are whoever polls us with
        # the notify headers. push_notify=False constructs none of this
        # and is the pull-everything round byte for byte.
        self.push_notify = bool(push_notify)
        self._sweep_interval = max(float(sweep_interval), 0.0)
        self._next_sweep = 0.0
        self._dirty: set = set()
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

    def _new_state(self, owns_gauge: bool = True) -> _PeerState:
        state = _PeerState(owns_gauge=owns_gauge)
        if self._backoff_factory is not None:
            state.backoff = self._backoff_factory()
        return state

    def _tier_state_for(self, worker_id: int) -> _PeerState:
        state = self._tier_state.get(worker_id)
        if state is None:
            state = self._new_state(owns_gauge=False)
            self._tier_state[worker_id] = state
        return state

    @property
    def _pool(self):
        """The fan-out executor (None when fanout == 1 — the sequential
        round constructs no pool at all, pinned)."""
        return self._fanout.pool

    # -- serving side (obs server) ----------------------------------------

    def publish_local(self, labels: Dict[str, str], mode: str) -> None:
        """The run loop wrote a label file: refresh what peers see. Every
        write counts — a degraded or re-served set is still this node's
        honest current answer (its mode says how stale it may be).

        Churn-free: re-publishing an UNCHANGED (labels, mode) pair keeps
        the cached serialized body, its ETag, and the generation counter
        exactly as they are — that stability is what lets an idle
        slice's poll round collapse into 304 header exchanges. Only a
        distinct publish pays the serialization (counted in
        tfd_peer_snapshot_serializations_total)."""
        with self._lock:
            if (
                self._snapshot_body is not None
                and mode == self._local_mode
                and labels == self._local_labels
            ):
                return
            self._generation += 1
            self._local_labels = dict(labels)
            self._local_mode = mode
            # The slice-aggregate section mirrors what these labels
            # already published (slice.role=leader only): extracted from
            # the PRE-strip set, because strip_snapshot_labels removes
            # the slice family from the snapshot's label map.
            self._slice_section = build_slice_section(labels)
            self._render_snapshot_locked()
            generation, etag = self._generation, self._snapshot_etag
        self._notify_upward(generation, etag)

    def _render_snapshot_locked(self) -> None:
        doc = build_snapshot(
            self.worker_id,
            self.hostname,
            self._local_labels,
            self._generation,
            self._local_mode,
            cohort=self._cohort_aggregate,
            slice_section=self._slice_section,
        )
        self._snapshot_body, self._snapshot_etag = serialize_snapshot(doc)
        obs_metrics.PEER_SNAPSHOT_SERIALIZATIONS.inc()

    def _set_aggregate(self, aggregate: Optional[Dict[str, Any]]) -> None:
        """Refresh the cohort aggregate this daemon serves (None while
        it is not a cohort leader). An UNCHANGED aggregate keeps the
        cached body/ETag frozen — the idle-slice 304 economy holds at
        the aggregate tier too. The snapshot generation does NOT move:
        it counts distinct LABEL publishes; aggregate freshness travels
        by ETag, and bumping the generation here would feed the
        aggregate's own self-entry back into the body and re-render
        every round forever."""
        generation, etag = 0, None
        with self._lock:
            if aggregate == self._cohort_aggregate:
                return
            self._cohort_aggregate = aggregate
            if self._snapshot_body is not None:
                self._render_snapshot_locked()
                generation, etag = self._generation, self._snapshot_etag
        self._notify_upward(generation, etag)

    def _notify_upward(self, generation: int, etag: Optional[str]) -> None:
        """The child-side push trigger: the served snapshot's ETag moved
        (a distinct publish OR an aggregate re-render — the parent polls
        on ETag movement, not generation). Strictly best-effort and
        strictly non-blocking (peering/notify.NotifySender)."""
        if self.notify_sender is not None and etag:
            self.notify_sender.publish(generation, etag)

    def snapshot_payload(self) -> Dict[str, Any]:
        with self._lock:
            labels = dict(self._local_labels)
            mode = self._local_mode
            generation = self._generation
            aggregate = self._cohort_aggregate
            slice_section = self._slice_section
        return build_snapshot(
            self.worker_id,
            self.hostname,
            labels,
            generation,
            mode,
            cohort=aggregate,
            slice_section=slice_section,
        )

    def serving_fault(self, tier: str) -> bool:
        """The serving handler's fault gate for the two-tier chaos
        sites (obs/server.py calls this per /peer/snapshot request,
        BEFORE answering): True = drop the connection with no response,
        the same wire signature a dead host's RST produces.

        - ``peer.tier-partition`` severs exactly the slice-tier
          leadership links (requests whose X-TFD-Poll-Tier header says
          "slice"), leaving intra-cohort and direct-fallback traffic
          intact — the inter-tier partition the graceful-degradation
          path exists for.
        - ``peer.cohort-leader-dead`` makes this daemon dark at the
          wire exactly while it IS a cohort leader — the mid-tier death
          whose failover must re-derive the next chain member.

        The force_* flags are the hermetic harness's per-worker scope
        (the fault registry is process-global there)."""
        from gpu_feature_discovery_tpu_torch.utils import faults

        if tier == TIER_SLICE:
            if self.force_tier_partition:
                return True
            if faults.consume("peer.tier-partition"):
                return True
        with self._lock:
            role = self._role
        if role == "cohort-leader":
            if self.force_cohort_leader_dead:
                return True
            if faults.consume("peer.cohort-leader-dead"):
                return True
        return False

    def snapshot_response(self) -> "tuple[bytes, str]":
        """The ``GET /peer/snapshot`` serving hook: the cached serialized
        body + strong ETag. Serialization happened at PUBLISH time, so a
        request costs a lock round-trip and two attribute reads — the
        per-request ``json.dumps`` this replaces scaled with poll rate x
        slice size on every serving daemon. Before the first publish of
        the epoch the empty snapshot is rendered (and cached) once."""
        with self._lock:
            if self._snapshot_body is None:
                self._render_snapshot_locked()
            return self._snapshot_body, self._snapshot_etag

    # -- polling side (engine pool thread) --------------------------------

    def labels(self) -> Labels:
        self.poll_once()
        return slice_labels(self.view())

    def poll_once(self) -> None:
        """One poll round: every peer not inside a confirmed-down backoff
        window gets one GET bounded by the per-peer timeout AND the
        remaining round budget. A peer the budget cannot reach is
        skipped with its state UNTOUCHED — "not polled" is neither a
        miss nor a success.

        Polls dispatch in rotated order onto the bounded fan-out pool
        (``fanout`` == 1 runs the same per-peer body inline — the
        sequential round, byte for byte) and the round blocks until
        every dispatched poll finishes, so one round costs ~1x the
        per-peer timeout per ``fanout`` slow peers instead of 1x per
        slow peer. The budget is a DISPATCH cutoff: it is checked when a
        poll actually starts (pool slot acquired), so a budget that runs
        out mid-round skips exactly the polls that had not started yet.

        The round starts one peer further along the list each time:
        budget skips always land on whoever the rotation currently puts
        last, so a run of slow-but-answering peers wider than the pool
        (each just under the per-peer timeout, never confirmed down)
        cannot starve the tail forever — a never-polled peer has no
        failures, counts reachable, and a dead host behind it would stay
        invisible indefinitely.

        Hierarchical mode (``cohort_size`` > 0 with more than one
        cohort) replaces the all-peers round with the two-tier round
        (``_poll_hier``): an intra-cohort sibling round for everyone,
        plus — on the derived cohort leader — the slice-tier leadership
        round. Every semantic above (rotation, budget cutoff, 2-miss
        confirmation, confirmed-dead backoff, pooled fan-out) applies
        unchanged at both tiers; flat mode is this method byte for
        byte."""
        if self._hier:
            self._poll_hier()
            return
        round_started = time.perf_counter()
        targets = self._round_targets()
        offset = self._round_offset % len(targets) if targets else 0
        self._round_offset += 1
        rotated = targets[offset:] + targets[:offset]
        self._fanout.run(
            [partial(self._poll_peer, peer, round_started) for peer in rotated]
        )
        token = frozenset(
            p.worker_id
            for p in self._peers
            if not self._peer_state[p.worker_id].confirmed_down
        )
        with self._lock:
            self._membership = token

    # -- the hierarchical (two-tier) round ---------------------------------

    def _poll_hier(self) -> None:
        """One two-tier round. Tier 1 (everyone): poll own-cohort
        siblings — the flat round scoped to the cohort. Tier 2 (the
        derived cohort leader only): probe whether any LOWER cohort has
        a live leadership-chain member (if so, the slice leader lives
        there and this node stays a cohort leader); the slice leader —
        no live lower chain — walks every other cohort's leadership
        chain for its aggregate, and direct-polls the members of any
        cohort whose whole chain is dark (graceful degradation: partial
        data beats no data). Both tiers share the round budget and the
        fan-out pool."""
        round_started = time.perf_counter()
        obs_metrics.COHORT_POLL_ROUNDS.labels(tier=TIER_COHORT).inc()
        if self.push_notify:
            # Hierarchical rounds stay FULL polls of their planes —
            # dirty-only filtering is a flat-plane economy (the cohort
            # fan-in already bounds the leader's table). Drain the dirty
            # set so the gauge cannot grow without bound.
            with self._lock:
                self._dirty.clear()
                obs_metrics.DIRTY_CHILDREN.set(0)
        siblings = self._sibling_peers()
        offset = self._round_offset % len(siblings) if siblings else 0
        self._round_offset += 1
        rotated = siblings[offset:] + siblings[:offset]
        self._fanout.run(
            [
                partial(
                    self._poll_peer,
                    peer,
                    round_started,
                    state=self._peer_state[peer.worker_id],
                    tier=TIER_COHORT,
                )
                for peer in rotated
            ]
        )
        if self._cohort_leader_id() == self.worker_id:
            lower_live = False
            for j in range(self._my_cohort):
                if self._probe_lower_chain(j, round_started):
                    lower_live = True
                    break
            if not lower_live:
                self._poll_slice_tier(round_started)
        self._commit_hier_round()

    def _sibling_peers(self) -> List[PeerEndpoint]:
        return [
            self._peer_by_id[i]
            for i in self._cohorts[self._my_cohort]
            if i != self.worker_id
        ]

    def _cohort_leader_id(self) -> int:
        """The derived leader of THIS node's cohort: the lowest
        not-confirmed-down member id, self included (member-plane
        states — trust is earned per plane)."""
        candidates = [self.worker_id] + [
            p.worker_id
            for p in self._sibling_peers()
            if not self._peer_state[p.worker_id].confirmed_down
        ]
        return min(candidates)

    def _probe_lower_chain(self, j: int, round_started: float) -> bool:
        """Slice-leadership derivation: is any leadership-chain member
        of LOWER cohort ``j`` alive? Walks the chain in id order and
        stops at the first live one (steady state: one poll). The
        verdicts ride the slice-tier states, so a single dropped poll of
        an established lower leader cannot flap this node into claiming
        slice leadership (the 2-miss confirmation, applied at tier 2)."""
        for wid in chain_ids(self._cohorts[j]):
            peer = self._peer_by_id[wid]
            state = self._tier_state_for(wid)
            self._poll_peer(peer, round_started, state=state, tier=TIER_SLICE)
            if not state.confirmed_down:
                return True
        return False

    def _poll_slice_tier(self, round_started: float) -> None:
        """The slice leader's tier-2 round: walk every other cohort's
        leadership chain (one pooled task per cohort — chains are
        sequential inside, independent across cohorts), then direct-poll
        the members of every cohort whose chain came up dark."""
        obs_metrics.COHORT_POLL_ROUNDS.labels(tier=TIER_SLICE).inc()
        others = [
            j for j in range(len(self._cohorts)) if j != self._my_cohort
        ]
        if not others:
            return
        toff = self._tier_round_offset % len(others)
        self._tier_round_offset += 1
        ordered = others[toff:] + others[:toff]
        self._fanout.run(
            [partial(self._walk_chain, j, round_started) for j in ordered]
        )
        # Graceful degradation: a cohort whose whole chain is dark gets
        # its members polled DIRECTLY under the same round budget —
        # member-plane states, so an alive-but-tier-partitioned chain
        # member is counted by the evidence of its direct answer while
        # its leadership link stays confirmed down.
        fallback_peers: List[PeerEndpoint] = []
        for j in ordered:
            if self._chain_resolution(j)[0] is None and self._chain_dark(j):
                fallback_peers.extend(
                    self._peer_by_id[wid] for wid in self._cohorts[j]
                )
        if fallback_peers:
            self._fanout.run(
                [
                    partial(
                        self._poll_peer,
                        peer,
                        round_started,
                        state=self._peer_state[peer.worker_id],
                        tier=TIER_DIRECT,
                    )
                    for peer in fallback_peers
                ]
            )

    def _walk_chain(self, j: int, round_started: float) -> None:
        """Walk cohort ``j``'s leadership chain looking for its derived
        leader: poll candidates in id order (each under the tier-2
        state's own backoff/confirmation) and stop at the first one that
        is live AND answering with a cohort-``j`` aggregate. A live
        candidate WITHOUT an aggregate is not the leader (it defers to a
        lower member this node cannot see) — keep walking."""
        for wid in chain_ids(self._cohorts[j]):
            peer = self._peer_by_id[wid]
            state = self._tier_state_for(wid)
            self._poll_peer(peer, round_started, state=state, tier=TIER_SLICE)
            if not state.confirmed_down and (
                self._aggregate_from(state, j) is not None
            ):
                return

    @staticmethod
    def _aggregate_from(
        state: _PeerState, j: int
    ) -> Optional[Dict[str, Any]]:
        snapshot = state.last_snapshot
        if snapshot is None:
            return None
        aggregate = snapshot.get("cohort")
        if aggregate is not None and aggregate.get("index") == j:
            return aggregate
        return None

    def _chain_resolution(
        self, j: int
    ) -> "tuple[Optional[int], Optional[Dict[str, Any]]]":
        """(leader_id, aggregate) for cohort ``j`` from the current
        tier-2 states: the lowest live chain member answering with a
        cohort-``j`` aggregate, or (None, None)."""
        for wid in chain_ids(self._cohorts[j]):
            state = self._tier_state.get(wid)
            if state is None or state.confirmed_down:
                continue
            aggregate = self._aggregate_from(state, j)
            if aggregate is not None:
                return wid, aggregate
        return None, None

    def _chain_dark(self, j: int) -> bool:
        """True when cohort ``j``'s ENTIRE leadership chain is
        evidence-confirmed unusable: every candidate is either confirmed
        down or reached-and-aggregateless. A never-polled candidate
        (budget skip) is NOT dark — degradation is declared on evidence,
        never on a round that ran out of time."""
        for wid in chain_ids(self._cohorts[j]):
            state = self._tier_state.get(wid)
            if state is None:
                return False
            if not state.confirmed_down and not state.ever_reached:
                return False
        return True

    def _build_own_aggregate(self) -> Dict[str, Any]:
        """This cohort leader's aggregate: one entry per cohort member
        (self included) carrying the member-plane reachability verdict,
        the member's last seen snapshot generation, its pre-extracted
        sick-chip count, and its write mode (null when the leader holds
        no current data — an unreachable member's stale facts must not
        masquerade as current)."""
        with self._lock:
            own_generation = self._generation
            own_mode = self._local_mode
        own_sick = _sick_from(self.snapshot_payload())
        members: Dict[int, Dict[str, Any]] = {}
        for wid in self._cohorts[self._my_cohort]:
            if wid == self.worker_id:
                members[wid] = {
                    "reachable": True,
                    "generation": own_generation,
                    "sick": own_sick,
                    "mode": own_mode,
                }
                continue
            state = self._peer_state[wid]
            snapshot = state.last_snapshot
            live = not state.confirmed_down and snapshot is not None
            members[wid] = {
                "reachable": not state.confirmed_down,
                "generation": snapshot["generation"] if live else None,
                "sick": _sick_from(snapshot) if live else None,
                "mode": snapshot.get("mode") if live else None,
            }
        return build_cohort_aggregate(self._my_cohort, members)

    def _derive_hier(
        self,
    ) -> "tuple[SliceView, Optional[Dict[str, Any]], frozenset]":
        """Derive this node's (view, served aggregate, membership token)
        purely from the current poll states — no network. Run after a
        round's polls (or on a pre-round view() read, where missing
        states resolve to the humble default: defer leadership, trust
        nothing unseen)."""
        members = self._cohorts[self._my_cohort]
        reachable_sibs = [
            wid
            for wid in members
            if wid != self.worker_id
            and not self._peer_state[wid].confirmed_down
        ]
        cohort_healthy = 1 + len(reachable_sibs)
        total_cohorts = len(self._cohorts)
        leader_id = min([self.worker_id] + reachable_sibs)
        # All-tuple fingerprint: the event loop renders it with
        # sorted(), so the items must be mutually comparable.
        token_items: List[Any] = [("sib", wid) for wid in reachable_sibs]
        if leader_id != self.worker_id:
            # Plain follower: its leader is its COHORT leader; healthy/
            # degraded describe the universe this node actually
            # observes (its cohort).
            state = self._peer_state[leader_id]
            view = SliceView(
                role="follower",
                leader_hostname=self._peer_by_id[leader_id].hostname,
                leader_seen=state.ever_reached,
                healthy_hosts=cohort_healthy,
                total_hosts=self.total_hosts,
                degraded=cohort_healthy < len(members),
                sick_chips=0,
                cohort=self._my_cohort,
                cohorts=total_cohorts,
            )
            token_items.append(("role", "follower", leader_id))
            return view, None, frozenset(token_items)
        # This node leads its cohort. Slice leadership: only when every
        # LOWER cohort's whole leadership chain is confirmed dark (a
        # chain member this node never managed to poll defers — trust
        # is earned by a poll, never presumed, the flat rule at tier 2).
        lower_live_seen = False
        is_slice_leader = True
        for j in range(self._my_cohort):
            for wid in chain_ids(self._cohorts[j]):
                state = self._tier_state.get(wid)
                if state is None or not state.confirmed_down:
                    is_slice_leader = False
                    if state is not None and state.ever_reached:
                        lower_live_seen = True
            if not is_slice_leader:
                break
        if not is_slice_leader:
            view = SliceView(
                role="cohort-leader",
                leader_hostname="",
                leader_seen=lower_live_seen,
                healthy_hosts=cohort_healthy,
                total_hosts=self.total_hosts,
                degraded=cohort_healthy < len(members),
                sick_chips=0,
                cohort=self._my_cohort,
                cohorts=total_cohorts,
            )
            token_items.append(("role", "cohort-leader"))
            return view, self._build_own_aggregate(), frozenset(token_items)
        # Slice leader: aggregate every other cohort through its chain
        # resolution (live leader's aggregate), or the direct-poll
        # fallback verdicts when the chain is dark, or the optimistic
        # never-polled default (flat semantics: no failures = reachable).
        healthy = cohort_healthy
        sick = _sick_from(self.snapshot_payload())
        for wid in reachable_sibs:
            snapshot = self._peer_state[wid].last_snapshot
            if snapshot is not None:
                sick += _sick_from(snapshot)
        degraded_cohorts: List[int] = []
        for j in range(total_cohorts):
            if j == self._my_cohort:
                continue
            cohort_view = self._resolve_cohort_view(j)
            healthy += cohort_view.healthy
            sick += cohort_view.sick
            if cohort_view.degraded:
                degraded_cohorts.append(j)
            token_items.append(
                (
                    "cohort",
                    j,
                    cohort_view.leader_id,
                    cohort_view.degraded,
                    cohort_view.healthy,
                )
            )
        if not reachable_sibs and healthy == 1 and self.total_hosts > 1:
            # Fully partitioned: every sibling AND every other cohort
            # confirmed dark. Never claim to lead a slice this node
            # cannot see (the flat never-lead rule, both tiers) — and
            # WITHDRAW the served aggregate: under an egress-only
            # partition (outbound polls dead, inbound serving fine) an
            # aggregate marking every sibling unreachable would be
            # found by the slice leader's chain walk and poison the
            # slice-wide healthy count for a cohort that is actually
            # fine. With no aggregate served, the chain walks past this
            # node (reachable-but-aggregateless) and the direct-poll
            # fallback counts the members by their own answers.
            view = SliceView(
                role="follower",
                leader_hostname="",
                leader_seen=False,
                healthy_hosts=1,
                total_hosts=self.total_hosts,
                degraded=True,
                sick_chips=0,
                cohort=self._my_cohort,
                cohorts=total_cohorts,
            )
            token_items.append(("role", "partitioned"))
            return view, None, frozenset(token_items)
        view = SliceView(
            role="leader",
            leader_hostname=self.hostname,
            leader_seen=True,
            healthy_hosts=healthy,
            total_hosts=self.total_hosts,
            degraded=healthy < self.total_hosts,
            sick_chips=sick,
            cohort=self._my_cohort,
            cohorts=total_cohorts,
            degraded_cohorts=tuple(degraded_cohorts),
        )
        token_items.append(("role", "leader"))
        return view, self._build_own_aggregate(), frozenset(token_items)

    def _resolve_cohort_view(self, j: int) -> _CohortView:
        leader_id, aggregate = self._chain_resolution(j)
        member_ids = set(self._cohorts[j])
        if aggregate is not None:
            healthy = 0
            sick = 0
            for key, entry in aggregate["members"].items():
                wid = int(key)
                if wid not in member_ids:
                    continue  # defensive: ignore out-of-cohort entries
                if entry.get("reachable"):
                    healthy += 1
                    if isinstance(entry.get("sick"), int):
                        sick += entry["sick"]
            return _CohortView(j, leader_id, False, healthy, sick)
        if self._chain_dark(j):
            # Direct-poll fallback verdicts (member-plane states): the
            # cohort is DEGRADED — no live aggregation link — but its
            # members' own answers keep healthy-hosts truthful.
            healthy = 0
            sick = 0
            for wid in self._cohorts[j]:
                state = self._peer_state[wid]
                if state.confirmed_down:
                    continue
                healthy += 1
                if state.last_snapshot is not None:
                    sick += _sick_from(state.last_snapshot)
            return _CohortView(j, None, True, healthy, sick)
        # Chain state unknown (never polled / budget-skipped this
        # round): the flat never-polled semantics — no failures counts
        # reachable, carries no data, and is NOT degraded (degradation
        # is declared on evidence).
        return _CohortView(j, None, False, len(self._cohorts[j]), 0)

    def _commit_hier_round(self) -> None:
        view, aggregate, token = self._derive_hier()
        if view.role == "leader":
            live_leaders = 1 + sum(
                1
                for item in token
                if isinstance(item, tuple)
                and item[0] == "cohort"
                and item[2] is not None
            )
        elif view.role == "cohort-leader":
            live_leaders = 1
        else:
            live_leaders = 1 if view.leader_seen else 0
        self._set_aggregate(aggregate)
        with self._lock:
            if self._closed:
                # A commit racing the epoch teardown must not re-latch
                # anything close() just reset — including the gauges,
                # which is why they are written UNDER this lock (close()
                # flips _closed under it before zeroing them, so a
                # commit either lands wholly before the flip or no-ops).
                return
            self._last_view = view
            self._role = view.role
            self._membership = token
            obs_metrics.SLICE_DEGRADED.set(1 if view.degraded else 0)
            obs_metrics.COHORT_DEGRADED.set(len(view.degraded_cohorts))
            obs_metrics.COHORT_LEADERS.set(live_leaders)

    def set_notify_port(self, port: int) -> None:
        """The obs server's BOUND port (cmd/main wires it once the
        server exists — the flag may say 0 = ephemeral): advertised in
        this poller's subscribe headers so children know where to POST
        their notifications back."""
        with self._lock:
            self._notify_port = int(port or 0)

    def mark_dirty(self, name: str, generation: int = 0, etag: str = "") -> bool:
        """The POST /peer/notify receive hook: mark the named child
        dirty for the next round. ``name`` is validated against this
        coordinator's OWN peer set (never the connection address — NAT
        and shared-address harnesses would lie); an unknown name returns
        False and dirties nothing, so a stale subscription or a
        mis-pointed child cannot steer the poll loop. The generation and
        etag are advisory (logged, never trusted): the poll itself is
        the only fact-bearing channel."""
        try:
            wid = int(name)
        except ValueError:
            return False
        if wid not in self._peer_by_id:
            return False
        with self._lock:
            if self._closed:
                return False
            self._dirty.add(wid)
            obs_metrics.DIRTY_CHILDREN.set(len(self._dirty))
        log.debug(
            "peer %d notified delta (generation %s, etag %s)",
            wid, generation, etag,
        )
        return True

    def _round_targets(self) -> List[PeerEndpoint]:
        """Which peers this flat round polls. Pull mode (push_notify
        off): every peer, always — byte-identical to the pre-push round.
        Push mode: a full CONFIRMATION SWEEP of every peer when the
        sweep deadline passed (the only correctness mechanism — it
        catches dropped notifications, dead children that cannot push
        their own death, rotated tokens, and a restarted parent whose
        cold _next_sweep=0 forces an immediate sweep); otherwise only
        dirty ∪ suspect peers, where a suspect has a failure streak in
        progress or was never reached — so the 2-miss confirmation and
        the confirmed-dead backoff cadence advance exactly as they would
        under pull."""
        if not self.push_notify:
            return self._peers
        now = self._clock()
        with self._lock:
            dirty = set(self._dirty)
            self._dirty.clear()
            obs_metrics.DIRTY_CHILDREN.set(0)
        if now >= self._next_sweep:
            self._next_sweep = now + self._sweep_interval
            return self._peers
        return [
            p
            for p in self._peers
            if p.worker_id in dirty
            or self._peer_state[p.worker_id].consecutive_failures > 0
            or not self._peer_state[p.worker_id].ever_reached
        ]

    def membership_token(self) -> Optional[frozenset]:
        """Reachable-peer fingerprint as of the last poll round (None
        before the first round completes). A moved fingerprint is the
        run loop's PEER_DELTA wake: slice labels re-derive on the next
        cycle instead of aging a sleep interval."""
        with self._lock:
            return self._membership

    def _poll_peer(
        self,
        peer: PeerEndpoint,
        round_started: float,
        state: Optional[_PeerState] = None,
        tier: Optional[str] = None,
    ) -> None:
        """One peer's poll, exactly as the sequential round ran it:
        backoff-window check, budget cutoff, fetch, then the verdict
        transition — the last applied under the serving lock, because
        with fanout > 1 several polls finish concurrently and the run
        loop's ``membership_token`` reads race the round.

        ``state`` selects which plane's verdict this poll feeds (the
        member plane by default; the hierarchical round passes the
        slice-tier leadership-link states for chain polls). ``tier``
        rides as the X-TFD-Poll-Tier request header; None (flat mode)
        sends no header at all."""
        if state is None:
            state = self._peer_state[peer.worker_id]
        now = self._clock()
        if state.confirmed_down and now < state.next_attempt:
            return  # backoff window still closed; stays down
        timeout = self.peer_timeout
        if self.round_budget is not None:
            remaining = self.round_budget - (
                time.perf_counter() - round_started
            )
            if remaining <= 0.05:
                obs_metrics.PEER_POLLS.labels(outcome="skipped").inc()
                log.warning(
                    "round budget %.3fs spent; skipping poll of peer "
                    "%s (worker %d) this round",
                    self.round_budget,
                    peer.hostname,
                    peer.worker_id,
                )
                return
            timeout = min(timeout, remaining)
        started = time.perf_counter()
        obs_metrics.PEER_FANOUT_INFLIGHT.inc()
        try:
            snapshot = self._fetch_tiered(peer, timeout, state, tier)
            if snapshot["worker_id"] != peer.worker_id:
                # Backstop only: the real HTTP path already rejected a
                # mismatched worker_id inside _request (it must happen
                # BEFORE the ETag is cached), so on that path this never
                # fires — it guards injected _fetch hooks (the hermetic
                # state-machine tests) with the same contract: a peer
                # answering as somebody else is a miss, never trusted.
                raise PeerSnapshotError(
                    f"peer claims worker_id {snapshot['worker_id']}, "
                    f"expected {peer.worker_id}"
                )
        except Exception as e:  # noqa: BLE001 - any failure = one miss
            obs_metrics.PEER_POLLS.labels(outcome="error").inc()
            with self._lock:
                self._poll_failed(peer, state, e)
        else:
            obs_metrics.PEER_POLLS.labels(outcome="ok").inc()
            with self._lock:
                self._poll_succeeded(peer, state, snapshot)
        finally:
            obs_metrics.PEER_FANOUT_INFLIGHT.inc(-1.0)
            obs_metrics.PEER_POLL_DURATION.observe(
                time.perf_counter() - started
            )

    def _fetch_tiered(
        self,
        peer: PeerEndpoint,
        timeout: float,
        state: _PeerState,
        tier: Optional[str],
    ) -> Dict[str, Any]:
        """Route one fetch to the right plane's connection/ETag state,
        honoring a test-injected ``_fetch`` instance override (the
        hermetic state-machine suites replace ``coord._fetch`` with a
        ``(peer, timeout)`` hook that neither knows nor needs tiers)."""
        injected = self.__dict__.get("_fetch")
        if injected is not None:
            return injected(peer, timeout)
        return self._fetch_impl(peer, timeout, state, tier)

    def _fetch(self, peer: PeerEndpoint, timeout: float) -> Dict[str, Any]:
        """The single-plane fetch entry (flat-mode semantics): kept as
        the stable seam tests wrap; delegates to the tier-aware
        implementation with the member-plane state."""
        return self._fetch_impl(
            peer, timeout, self._peer_state[peer.worker_id], None
        )

    def _fetch_impl(
        self,
        peer: PeerEndpoint,
        timeout: float,
        state: _PeerState,
        tier: Optional[str],
    ) -> Dict[str, Any]:
        """One GET /peer/snapshot over the plane's persistent keep-alive
        connection (opened on demand; any failure tears it down so the
        next poll reconnects). A 304 answer returns the last-parsed
        snapshot unchanged — the caller's success bookkeeping advances
        exactly as on a full body."""
        reused = state.conn is not None
        try:
            try:
                snapshot = self._request(peer, state, timeout, tier)
            except STALE_CONN_ERRORS:
                if not reused:
                    raise
                # The server closed the idle keep-alive connection
                # between rounds (peer restart, idle reap): that is
                # connection lifecycle, not peer health — retry ONCE on
                # a fresh connection before anything counts as a miss.
                self._drop_connection(state)
                reused = False
                snapshot = self._request(peer, state, timeout, tier)
        except Exception:
            self._drop_connection(state)
            raise
        if reused:
            obs_metrics.PEER_CONNECTION_REUSES.inc()
        return snapshot

    def _request(
        self,
        peer: PeerEndpoint,
        state: _PeerState,
        timeout: float,
        tier: Optional[str] = None,
    ) -> Dict[str, Any]:
        with self._lock:
            # Checked and created UNDER the lock close() flips _closed
            # under: an abandoned round racing close() either assigns
            # the connection before the flip (close()'s sweep, which
            # runs after the flip, drops it) or sees _closed and raises
            # — a fresh connection can never be opened past the
            # teardown. The constructor does not connect, so no network
            # IO happens under the lock.
            if self._closed:
                raise PeerSnapshotError("coordinator closed")
            conn = state.conn
            if conn is None:
                conn = http.client.HTTPConnection(
                    peer.host, peer.port, timeout=timeout
                )
                state.conn = conn
        # The constructor timeout only applies at connect; an
        # already-open socket must be re-armed per poll (the budget may
        # have shrunk it below the full --peer-timeout).
        conn.timeout = timeout
        if conn.sock is not None:
            conn.sock.settimeout(timeout)
        headers = {}
        if self.peer_token:
            headers[PEER_TOKEN_HEADER] = self.peer_token
        if self.push_notify and self._notify_port:
            # Subscribe: ask this child to POST /peer/notify back at the
            # poll connection's source address + our server port when
            # its snapshot moves. The name is what WE know the child by
            # (its worker id) — echoed back so mark_dirty can validate
            # it against the peer set.
            headers[NOTIFY_PORT_HEADER] = str(self._notify_port)
            headers[NOTIFY_NAME_HEADER] = str(peer.worker_id)
        if state.etag is not None and state.last_snapshot is not None:
            headers["If-None-Match"] = state.etag
        if tier is not None:
            # The wire says which plane this poll belongs to, so the
            # serving side can enact tier-scoped faults (and operators
            # can tcpdump-tell a leadership-chain poll from a fallback
            # one). Flat mode sends no header at all.
            headers[POLL_TIER_HEADER] = tier
        conn.request("GET", PEER_SNAPSHOT_PATH, headers=headers)
        resp = conn.getresponse()
        if resp.status == 304:
            resp.read()  # drain (empty) body; the connection stays live
            if state.last_snapshot is None:
                # Defensive: If-None-Match is only ever sent alongside a
                # cached snapshot, so a 304 here means a confused server.
                raise PeerSnapshotError("304 with no cached snapshot")
            return state.last_snapshot
        if resp.status != 200:
            raise PeerSnapshotError(f"HTTP {resp.status}")
        body = resp.read(MAX_SNAPSHOT_BYTES + 1)
        snapshot = parse_snapshot(body)
        if snapshot["worker_id"] != peer.worker_id:
            # Validated HERE, before the ETag is cached: a misdirected
            # peer (stale DNS answering as another worker) whose ETag we
            # remembered would 304 every later poll — and the 304 path
            # would replay the OLD valid snapshot past the caller's
            # worker-id check, counting the impostor reachable forever.
            raise PeerSnapshotError(
                f"peer claims worker_id {snapshot['worker_id']}, "
                f"expected {peer.worker_id}"
            )
        etag = resp.getheader("ETag")
        state.etag = etag if etag else None
        return snapshot

    @staticmethod
    def _drop_connection(state: _PeerState) -> None:
        conn, state.conn = state.conn, None
        if conn is not None:
            try:
                conn.close()
            except OSError:
                pass

    def _poll_succeeded(
        self, peer: PeerEndpoint, state: _PeerState, snapshot: Dict[str, Any]
    ) -> None:
        if self._closed:
            # A straggler poll of an abandoned round landing after
            # close(): its verdict is nobody's input anymore, and
            # touching the gauges would undo close()'s reset (both
            # callers hold the lock, so this check and close()'s flip
            # are serialized).
            return
        if state.confirmed_down:
            log.info(
                "peer %s (worker %d) reachable again",
                peer.hostname,
                peer.worker_id,
            )
        state.consecutive_failures = 0
        state.backoff_attempt = 0
        state.next_attempt = 0.0
        state.ever_reached = True
        state.last_snapshot = snapshot
        if state.owns_gauge:
            obs_metrics.PEER_UNREACHABLE.labels(peer=peer.hostname).set(0)

    def _poll_failed(
        self, peer: PeerEndpoint, state: _PeerState, error: BaseException
    ) -> None:
        if self._closed:
            # See _poll_succeeded: a straggler poll failing BECAUSE the
            # teardown closed its socket must not re-latch
            # tfd_peer_unreachable=1 after close() zeroed it — a peer
            # gone from the next epoch's hostname list would stay
            # latched forever.
            return
        state.consecutive_failures += 1
        if state.confirmed_down:
            if state.owns_gauge:
                obs_metrics.PEER_UNREACHABLE.labels(peer=peer.hostname).set(1)
            delay = state.backoff.delay(min(state.backoff_attempt, 63))
            state.backoff_attempt += 1
            state.next_attempt = self._clock() + delay
            if state.consecutive_failures == CONFIRM_POLLS:
                log.warning(
                    "peer %s (worker %d) confirmed unreachable after %d "
                    "consecutive failed polls (%s); re-polling under "
                    "backoff",
                    peer.hostname,
                    peer.worker_id,
                    state.consecutive_failures,
                    error,
                )
        else:
            log.info(
                "poll of peer %s (worker %d) failed (%d/%d before "
                "confirmation): %s",
                peer.hostname,
                peer.worker_id,
                state.consecutive_failures,
                CONFIRM_POLLS,
                error,
            )

    # -- aggregation -------------------------------------------------------

    def view(self) -> SliceView:
        if self._hier:
            # Hierarchical views (and their gauges) are committed at
            # round end; a pre-round read derives one from the current
            # states (no network) with the humble defaults.
            with self._lock:
                stored = self._last_view
            if stored is None:
                self._commit_hier_round()
                with self._lock:
                    stored = self._last_view
            if stored is None:
                # Closed before any round committed: a bare derivation
                # (no gauges, nothing stored) keeps the caller whole.
                stored = self._derive_hier()[0]
            return stored
        reachable_peers = [
            p for p in self._peers
            if not self._peer_state[p.worker_id].confirmed_down
        ]
        healthy = 1 + len(reachable_peers)  # self is always reachable
        degraded = healthy < self.total_hosts
        # Deliberately THIS node's reachability view, not the leader's
        # published verdict: on the leader the gauge mirrors the
        # slice.degraded label; on a follower it surfaces an asymmetric
        # partition (follower cannot reach a peer the leader can) that
        # no label would show.
        obs_metrics.SLICE_DEGRADED.set(1 if degraded else 0)
        if not reachable_peers and self.total_hosts > 1:
            # Fully partitioned: every peer confirmed dark. Never claim
            # to lead a slice this node cannot see (module docstring).
            return SliceView(
                role="follower",
                leader_hostname="",
                leader_seen=False,
                healthy_hosts=healthy,
                total_hosts=self.total_hosts,
                degraded=True,
                sick_chips=0,
            )
        leader_peer = min(
            reachable_peers, key=lambda p: p.worker_id, default=None
        )
        if leader_peer is None or self.worker_id < leader_peer.worker_id:
            return SliceView(
                role="leader",
                leader_hostname=self.hostname,
                leader_seen=True,
                healthy_hosts=healthy,
                total_hosts=self.total_hosts,
                degraded=degraded,
                sick_chips=self._sum_sick_chips(reachable_peers),
            )
        leader_state = self._peer_state[leader_peer.worker_id]
        return SliceView(
            role="follower",
            leader_hostname=leader_peer.hostname,
            # leader-seen is a gating label, so it gets
            # the same 2-consecutive confirmation as everything else: an
            # ESTABLISHED leader stays seen through a single missed poll
            # (the leader is still in the reachable set until confirmed
            # down, at which point leadership re-derives or the
            # full-partition branch above reports leader-seen=false).
            # Only a leader this epoch has never successfully polled is
            # unseen from the start — trust is earned, never presumed.
            leader_seen=leader_state.ever_reached,
            healthy_hosts=healthy,
            total_hosts=self.total_hosts,
            degraded=degraded,
            sick_chips=0,
        )

    def actuation_signals(self) -> "tuple[int, Dict[int, bool]]":
        """(total slice hosts, {peer worker_id: wants-advice}) for the
        actuation budget (actuation/engine.py). A peer "wants advice"
        when its last snapshot carries a confirmed verdict — a nonzero
        pre-extracted sick-chip count or the straggler label. These are
        the UNDERLYING verdicts already on the wire; the advice family
        itself is stripped from snapshots (peering/snapshot.py), so
        every member derives the same candidate ranking from the same
        inputs — no election, and no advice echo.

        Confirmed-down peers contribute nothing: a dark peer's stale
        verdict must not consume budget a live sick host needs. In
        cohort mode _peer_state holds only this member's cohort
        siblings, so the budget is enforced cohort-scoped — a cap per
        visibility domain, conservative in the right direction (each
        cohort independently stays under the fraction).

        Reads _peer_state snapshot refs without the serving lock — the
        same single-writer pattern as the round's view derivation:
        refs are replaced wholesale by the engine thread, never
        mutated in place."""
        from gpu_feature_discovery_tpu_torch.lm.health import STRAGGLER_CHIP

        desires: Dict[int, bool] = {}
        for wid, state in self._peer_state.items():
            snapshot = state.last_snapshot
            if snapshot is None or state.confirmed_down:
                continue
            labels = snapshot.get("labels") or {}
            desires[wid] = bool(
                _sick_from(snapshot) or STRAGGLER_CHIP in labels
            )
        return self.total_hosts, desires

    def _sum_sick_chips(self, reachable_peers: List[PeerEndpoint]) -> int:
        total = _sick_from(self.snapshot_payload())
        for peer in reachable_peers:
            snapshot = self._peer_state[peer.worker_id].last_snapshot
            if snapshot is not None:
                total += _sick_from(snapshot)
        return total

    def close(self) -> None:
        """Epoch end: retire the fan-out pool and every persistent peer
        connection, and zero this coordinator's gauges in the
        process-global registry. A SIGHUP reload may rebuild the
        coordinator with a CHANGED hostname list (or none at all) —
        without the reset, a peer no longer in the slice would stay
        latched at tfd_peer_unreachable=1 forever and send an operator
        chasing a host that left the slice. The pool shutdown does not
        wait: any in-flight poll is bounded by its socket timeout and
        its thread dies with it — a slow peer must not stall a reload."""
        with self._lock:
            # Under the lock: verdict transitions also run under it, so
            # any straggler poll either lands before this flip (its
            # gauge write is zeroed below) or sees _closed and no-ops —
            # it can never re-latch a gauge after the reset.
            self._closed = True
            self._dirty.clear()
        if self.notify_sender is not None:
            self.notify_sender.close()
        obs_metrics.DIRTY_CHILDREN.set(0)
        self._fanout.shutdown(wait=False)
        for peer in self._peers:
            self._drop_connection(self._peer_state[peer.worker_id])
            obs_metrics.PEER_UNREACHABLE.labels(peer=peer.hostname).set(0)
        # list(): a straggler chain poll of the abandoned round may
        # still be lazily inserting tier states; the snapshot keeps this
        # sweep safe, and the straggler's own connection dies with its
        # socket timeout (its _request sees _closed and refuses to open
        # a fresh one).
        for state in list(self._tier_state.values()):
            # The slice-tier leadership links hold their own persistent
            # connections (a chain member can be tracked on two planes).
            self._drop_connection(state)
        obs_metrics.SLICE_DEGRADED.set(0)
        obs_metrics.COHORT_LEADERS.set(0)
        obs_metrics.COHORT_DEGRADED.set(0)


def _sick_from(snapshot: Dict[str, Any]) -> int:
    sick = snapshot.get("chips", {}).get("sick")
    return sick if isinstance(sick, int) and not isinstance(sick, bool) else 0


def new_slice_coordinator(config, host_info=None) -> Optional[SliceCoordinator]:
    """Coordinator from the daemon config, or None when coordination is
    off/unavailable. ``auto`` resolves to ON exactly when the host's
    WORKER_HOSTNAMES names 2+ workers AND the obs server will serve
    (daemon mode, --metrics-port != 0) — peers poll /peer/snapshot on
    that server, so a serverless daemon has nothing to coordinate with.
    Forced ``on`` that cannot run (oneshot, no server, no slice facts)
    degrades to off with a warning rather than failing the daemon.
    ``host_info`` is anything with ``worker_hostnames`` and ``worker_id``
    (peering/worker_env.WorkerEnv); None reads this process's
    environment."""
    from gpu_feature_discovery_tpu_torch.config.flags import (
        DEFAULT_LABELER_TIMEOUT,
        DEFAULT_PEER_TIMEOUT,
        DEFAULT_SLEEP_INTERVAL,
    )
    from gpu_feature_discovery_tpu_torch.config.spec import (
        PUSH_NOTIFY_AUTO,
        SLICE_COORDINATION_AUTO,
        SLICE_COORDINATION_OFF,
        SLICE_COORDINATION_ON,
    )

    tfd = config.flags.tfd
    mode = tfd.slice_coordination or SLICE_COORDINATION_AUTO
    if mode == SLICE_COORDINATION_OFF:
        return None
    forced = mode == SLICE_COORDINATION_ON
    if tfd.oneshot or not tfd.metrics_port:
        if forced:
            log.warning(
                "slice-coordination=on needs the introspection server "
                "(daemon mode, --metrics-port != 0); running node-local"
            )
        return None
    if host_info is None:
        from gpu_feature_discovery_tpu_torch.peering.worker_env import (
            discover_worker_env,
        )

        host_info = discover_worker_env()
    hostnames = list(host_info.worker_hostnames) if host_info else []
    worker_id = host_info.worker_id if host_info else None
    if len(hostnames) < 2:
        if forced:
            log.warning(
                "slice-coordination=on but WORKER_HOSTNAMES names "
                "%d worker(s); running node-local",
                len(hostnames),
            )
        return None
    if worker_id is None or not 0 <= worker_id < len(hostnames):
        # auto on a real slice should coordinate; a missing/out-of-range
        # worker id means the env is corrupt (worker_env.py already warned
        # on the range case) — coordination would poll the wrong set.
        log.warning(
            "slice coordination disabled: worker_id %r does not index "
            "the %d-entry hostname list",
            worker_id,
            len(hostnames),
        )
        return None
    timeout = (
        tfd.peer_timeout
        if tfd.peer_timeout is not None
        else DEFAULT_PEER_TIMEOUT
    )
    labeler_timeout = (
        tfd.labeler_timeout
        if tfd.labeler_timeout is not None
        else DEFAULT_LABELER_TIMEOUT
    )
    effective_cohort_size = resolve_cohort_size(
        getattr(tfd, "cohort_size", None), len(hostnames)
    )
    coordinator = SliceCoordinator(
        worker_id=worker_id,
        hostnames=hostnames,
        default_port=tfd.metrics_port,
        peer_timeout=timeout,
        # The whole round must land under the engine's per-labeler
        # deadline: a deadline miss marks the cycle's sources stale,
        # which suppresses the supervisor's state persistence — a slow
        # SLICE must never cost the NODE that. 0.8 leaves headroom for
        # aggregation + the engine's own dispatch.
        round_budget=0.8 * labeler_timeout,
        # 0/None = auto (min(AUTO_FANOUT_CAP, peers)); 1 pins the
        # sequential round.
        fanout=tfd.peer_fanout,
        # 0 = flat (single tier); auto = 64
        # once the slice outgrows it (peering/cohort.py).
        cohort_size=effective_cohort_size,
        # --peer-token: the serving side requires it (obs/server.py), so
        # this poller must send it or the slice partitions itself.
        peer_token=tfd.peer_token or "",
        # Push-on-delta: auto = on exactly when the token is configured
        # (the notify endpoint never works unauthenticated). The sweep
        # cadence is --max-staleness with the same 0-tracks-the-interval
        # demotion the reconcile loop applies — between sweeps a round
        # polls only notified/suspect peers.
        push_notify=resolve_push_notify(
            tfd.push_notify or PUSH_NOTIFY_AUTO, tfd.peer_token or ""
        ),
        sweep_interval=(
            tfd.max_staleness
            or tfd.sleep_interval
            or DEFAULT_SLEEP_INTERVAL
        ),
    )
    log.info(
        "slice coordination on: worker %d of %d (%s), peer timeout "
        "%.3fs, fan-out %d, cohorts %s",
        worker_id,
        len(hostnames),
        coordinator.hostname,
        timeout,
        coordinator.fanout,
        (
            f"{len(coordinator._cohorts)} x {effective_cohort_size}"
            if effective_cohort_size
            else "flat"
        ),
    )
    return coordinator
