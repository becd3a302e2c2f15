"""No-election HA for the fleet collector: role by re-derivation, a
standby that mirrors the active, and a divergence gauge for split panes
(twin: ``gpu_feature_discovery_tpu/fleet/ha.py``).

Two (or more) collectors run behind one Service, each scraping the SAME
targets file independently — the pane survives any single collector
death with no handoff, because there is nothing to hand off: the Service
stops routing to the dead replica (its ``/readyz`` goes with it) and the
survivor has been running live rounds the whole time.

What this module adds on top is the ROLE, derived the way every other
tier of this system derives leadership — no election protocol:

- ``--ha-peers`` is one ordered ``host[:port]`` list, identical on every
  replica; ``--ha-self`` names this replica's own entry. The ACTIVE is
  the first entry whose collector is reachable (self counts as
  reachable), exactly the slice tier's lowest-reachable-worker-id rule.
- A STANDBY additionally mirrors the active's ``/fleet/snapshot`` once
  per round over a persistent keep-alive connection with
  ``If-None-Match`` — an agreeing pair exchanges 304 header exchanges,
  nothing more, and a changed round moves only the changed entries
  (``?since=<generation>`` delta, fleet/inventory.DeltaMirror, with
  full-body resync as the fallback) — and publishes
  ``tfd_fleet_ha_divergence``: how many
  inventory entries differ between its OWN pane and the active's
  (volatile fields excluded). A persistently nonzero value is a SPLIT
  PANE — the two collectors can see different fleets (asymmetric
  network partition, a half-reloaded targets file) and an operator must
  look before trusting either.
- The mirror poll doubles as the liveness probe: when the active misses
  2 consecutive mirror polls (the peer tier's confirmation rule —
  earned trust applies, so a never-reached senior confirms on its first
  miss), the standby re-derives itself active (``tfd_fleet_ha_role``
  flips to 1) and keeps serving from its own live rounds — the data was
  never stale, only the role moved.

State on a shared ``--state-dir`` is last-writer-wins: both replicas
persist through the same atomic fsync-before-rename writer
(fleet/inventory.InventoryStore), so the file is always one replica's
complete inventory, never a torn merge.
"""

from __future__ import annotations

import http.client
import logging
import time
from typing import Any, Callable, Dict, List, Optional

from gpu_feature_discovery_tpu_torch.config.spec import ConfigError
from gpu_feature_discovery_tpu_torch.fleet.collector import (
    _HostState,
    drop_connection,
    fetch_with_stale_retry,
    request_snapshot,
)
from gpu_feature_discovery_tpu_torch.fleet.inventory import (
    FLEET_SNAPSHOT_PATH,
    MAX_INVENTORY_BYTES,
    parse_inventory_or_delta,
)
from gpu_feature_discovery_tpu_torch.obs import metrics as obs_metrics
from gpu_feature_discovery_tpu_torch.peering.coordinator import (
    CONFIRM_POLLS,
    split_host_port,
)
from gpu_feature_discovery_tpu_torch.utils.retry import BackoffPolicy

log = logging.getLogger("tfd.fleet")

ROLE_ACTIVE = "active"
ROLE_STANDBY = "standby"

# Entry fields excluded from the divergence comparison: the quantized
# freshness stamp can legitimately straddle a quantum boundary between
# the two replicas' scrape times, and a freshly restarted peer serving
# restored entries is a warm-up regime, not a split pane.
_DIVERGENCE_EXCLUDE = ("last_seen_unix", "restored")


def parse_ha_peers(raw: str) -> List[str]:
    """The ordered ``--ha-peers`` list: comma-separated host[:port]
    entries, whitespace stripped, empties dropped. Order is load-bearing
    (it IS the role derivation), so duplicates are a ConfigError, never
    silently deduped."""
    peers: List[str] = []
    for entry in raw.split(","):
        name = entry.strip()
        if not name:
            continue
        if name in peers:
            raise ConfigError(f"duplicate --ha-peers entry {name!r}")
        peers.append(name)
    return peers


def _strip_volatile(
    entry: Optional[Dict[str, Any]],
) -> Optional[Dict[str, Any]]:
    if entry is None:
        return None
    return {k: v for k, v in entry.items() if k not in _DIVERGENCE_EXCLUDE}


def _entry_differs(
    own: Optional[Dict[str, Any]], mirrored: Optional[Dict[str, Any]]
) -> bool:
    return _strip_volatile(own) != _strip_volatile(mirrored)


def diverging_keys(
    own: Dict[str, Dict[str, Any]], mirrored: Dict[str, Dict[str, Any]]
) -> "set":
    """The inventory keys whose entries differ between two collectors'
    panes (volatile fields excluded) — the full O(fleet) walk, run on
    the first comparison and on every full-body resync; steady-state
    rounds maintain the set incrementally from the two panes' changed
    keys (HaMonitor.observe_round)."""
    keys = set(own) | set(mirrored)
    return {
        k for k in keys if _entry_differs(own.get(k), mirrored.get(k))
    }


def entries_divergence(
    own: Dict[str, Dict[str, Any]], mirrored: Dict[str, Dict[str, Any]]
) -> int:
    """How many inventory entries differ between two collectors' panes
    (volatile fields excluded). 0 means the pair agrees entry for
    entry."""
    return len(diverging_keys(own, mirrored))


class _MirrorCounter:
    """Plain in-process counter for the mirror's 304 exchanges — test
    observability, deliberately NOT a registry family: the mirror's 304s
    must never inflate the scrape-economy counters
    (tfd_fleet_snapshot_not_modified_total measures upstream polls)."""

    def __init__(self):
        self.value = 0

    def inc(self) -> None:
        self.value += 1


class HaMonitor:
    """Derives this replica's role against its ordered peer list and
    mirrors the active while standby. Driven from the collector's run
    loop (``observe_round`` once per scrape round); single-threaded by
    construction, like the collector's serving/polling split."""

    def __init__(
        self,
        peers: List[str],
        self_name: str,
        default_port: int = 9102,
        peer_timeout: float = 2.0,
        peer_token: str = "",
        clock: Callable[[], float] = time.monotonic,
        backoff_factory: Optional[Callable[[], BackoffPolicy]] = None,
    ):
        if self_name not in peers:
            raise ConfigError(
                f"--ha-self {self_name!r} is not an entry of --ha-peers "
                f"{peers!r}"
            )
        self.self_name = self_name
        self.peer_timeout = float(peer_timeout)
        self.peer_token = peer_token or ""
        self._clock = clock
        self._closed = False
        # Only the entries SENIOR to self matter: if every one of them
        # is confirmed down, self is the first reachable entry — active.
        # Entries junior to self never need polling.
        self._seniors: List["tuple[str, _HostState]"] = []
        for name in peers[: peers.index(self_name)]:
            host, port = split_host_port(name, default_port)
            state = _HostState(host=host, port=port)
            if backoff_factory is not None:
                state.backoff = backoff_factory()
            self._seniors.append((name, state))
        self.role = ROLE_ACTIVE if not self._seniors else ROLE_STANDBY
        self.active_peer: Optional[str] = None
        self.divergence = 0
        # Incrementally-maintained divergence set: the keys currently
        # disagreeing with ``_diff_against``. None = no valid baseline
        # (first comparison, active changed, or a full-body resync
        # replaced the mirror wholesale) -> next comparison is the full
        # O(fleet) walk; otherwise only the keys either pane CHANGED
        # this round are re-verdicted — O(changed) per round.
        self._diff_keys: Optional["set"] = None
        self._diff_against: Optional[str] = None
        self.mirror_not_modified = _MirrorCounter()
        obs_metrics.FLEET_HA_ROLE.set(
            1 if self.role == ROLE_ACTIVE else 0
        )
        obs_metrics.FLEET_HA_DIVERGENCE.set(0)

    def observe_round(
        self,
        own_slices: Dict[str, Dict[str, Any]],
        own_changed: Optional["set"] = None,
    ) -> str:
        """One role derivation + mirror pass; call after each of the
        collector's scrape rounds with its current per-slice entries
        (``inventory_payload()['slices']``) and, when known, the set of
        slice keys that round changed (``poll_round()``'s return) — with
        both panes' changed keys in hand the divergence gauge updates
        O(changed); without them it falls back to the full walk.
        Returns the derived role."""
        role = ROLE_ACTIVE
        active_peer: Optional[str] = None
        mirrored: Optional[Dict[str, Any]] = None
        for name, hstate in self._seniors:
            if hstate.confirmed_down and self._clock() < hstate.next_attempt:
                continue  # confirmed dark, backoff window closed
            try:
                doc = fetch_with_stale_retry(
                    hstate, lambda h=hstate: self._request(h)
                )
            except Exception as e:  # noqa: BLE001 - any failure = one miss
                hstate.consecutive_failures += 1
                if hstate.confirmed_down:
                    delay = hstate.backoff.delay(
                        min(hstate.backoff_attempt, 63)
                    )
                    hstate.backoff_attempt += 1
                    hstate.next_attempt = self._clock() + delay
                    if hstate.consecutive_failures == CONFIRM_POLLS:
                        log.warning(
                            "HA senior %s confirmed dead (%s); deriving "
                            "role against the remaining order",
                            name,
                            e,
                        )
                    continue
                # An ESTABLISHED active missing ONE mirror poll keeps
                # the role for this round — the same 2-miss rule that
                # keeps a slice entry from flapping on a dropped poll.
                log.info(
                    "HA mirror poll of %s failed (%d/%d before "
                    "confirmation): %s",
                    name,
                    hstate.consecutive_failures,
                    CONFIRM_POLLS,
                    e,
                )
                role = ROLE_STANDBY
                active_peer = name
                break
            if hstate.confirmed_down:
                log.info("HA senior %s reachable again", name)
            hstate.consecutive_failures = 0
            hstate.backoff_attempt = 0
            hstate.next_attempt = 0.0
            hstate.ever_reached = True
            hstate.last_snapshot = doc
            role = ROLE_STANDBY
            active_peer = name
            mirrored = doc
            break
        if role != self.role:
            log.warning(
                "HA role re-derived: %s -> %s (active: %s)",
                self.role,
                role,
                active_peer or self.self_name,
            )
        self.role = role
        self.active_peer = active_peer
        if mirrored is not None:
            mirror_changed: Optional["set"] = None
            for name, hstate in self._seniors:
                if name == active_peer and hstate.mirror is not None:
                    mirror_changed = hstate.mirror.last_changed
                    break
            mirrored_slices = mirrored.get("slices", {})
            if (
                own_changed is None
                or mirror_changed is None
                or self._diff_keys is None
                or self._diff_against != active_peer
            ):
                # No baseline (first comparison, the active moved, a
                # caller without change tracking) or the mirror was
                # replaced wholesale (full-body resync): full walk.
                self._diff_keys = diverging_keys(
                    own_slices, mirrored_slices
                )
            else:
                for k in set(own_changed) | mirror_changed:
                    if _entry_differs(
                        own_slices.get(k), mirrored_slices.get(k)
                    ):
                        self._diff_keys.add(k)
                    else:
                        self._diff_keys.discard(k)
            self._diff_against = active_peer
            self.divergence = len(self._diff_keys)
        else:
            # Active (its own pane IS the pane), or a standby whose
            # mirror poll missed this round: no fresh comparison — and
            # no baseline either (own changes keep landing while the
            # mirror is dark), so the next comparison re-walks.
            self._diff_keys = None
            self._diff_against = None
            self.divergence = 0 if role == ROLE_ACTIVE else self.divergence
        obs_metrics.FLEET_HA_ROLE.set(1 if role == ROLE_ACTIVE else 0)
        obs_metrics.FLEET_HA_DIVERGENCE.set(self.divergence)
        return role

    def _request(self, hstate: _HostState) -> Dict[str, Any]:
        if self._closed:
            raise ConnectionError("HA monitor closed")
        if hstate.conn is None:
            hstate.conn = http.client.HTTPConnection(
                hstate.host, hstate.port, timeout=self.peer_timeout
            )
        return request_snapshot(
            hstate,
            self.peer_timeout,
            FLEET_SNAPSHOT_PATH,
            parse_inventory_or_delta,
            MAX_INVENTORY_BYTES,
            token=self.peer_token,
            not_modified_counter=self.mirror_not_modified,
            delta=True,
        )

    def close(self) -> None:
        self._closed = True
        for _, hstate in self._seniors:
            drop_connection(hstate)
        obs_metrics.FLEET_HA_ROLE.set(0)
        obs_metrics.FLEET_HA_DIVERGENCE.set(0)
