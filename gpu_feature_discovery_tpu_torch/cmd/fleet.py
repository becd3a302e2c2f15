"""The ``fleet-collector`` mode: ``python -m gpu_feature_discovery_tpu_torch
fleet-collector --targets-file fleet.yaml`` (twin:
``gpu_feature_discovery_tpu/cmd/fleet.py``, the same 18 flags). It
imports no torch: ``cmd/main.py`` dispatches it before anything does.

A long-running out-of-cluster service (one small Deployment, not a
DaemonSet) built entirely from the repo's existing primitives: the
collector (fleet/collector.py) scrapes every configured slice's
leadership chain per round — or, under ``--upstream-mode=collectors``,
every configured REGION's collector chain over ``/fleet/snapshot`` (the
federation root tier); the obs server (obs/server.py) serves the
aggregated inventory at ``GET /fleet/snapshot`` next to ``/metrics``,
``/healthz``, ``/readyz`` on its own server instance; the targets file
is stat-triple watched (mtime/size/inode — cmd/events.ConfigFileWatcher,
so a same-second rewrite by a config-management tool still reloads; edit
the file, the epoch rebuilds — no restart, exactly like the daemon's
config watcher); SIGHUP forces the same reload, SIGTERM/SIGINT exit
cleanly. ``/readyz`` answers 503 until the first scrape round completes
(or the --state-dir restore served last-good data), so a fresh replica
behind the HA Service never serves an empty inventory as ready.

With ``--ha-peers``/``--ha-self`` set, an HaMonitor (fleet/ha.py) rides
the scrape cadence: role re-derived every round against the shared
ordered list (no election), the standby mirroring the active's
``/fleet/snapshot`` and publishing the role/divergence gauges.

Flags resolve CLI > env > default (the collector has no config file —
the targets file IS its config; FLEET_FLAG_DEFS is the one table docs
and the parser both read, same anti-drift shape as config/flags.py).
"""

from __future__ import annotations

import argparse
import logging
import os
import time
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Sequence

from gpu_feature_discovery_tpu_torch.config.flags import (
    DEFAULT_METRICS_ADDR,
    DEFAULT_METRICS_PORT,
    DEFAULT_PEER_FANOUT,
    DEFAULT_PEER_TIMEOUT,
    parse_duration,
)
from gpu_feature_discovery_tpu_torch.config.spec import (
    DEFAULT_FILTER_CACHE_SIZE,
    DEFAULT_FLEET_DELTA_WINDOW,
    DEFAULT_MAX_INFLIGHT,
    DEFAULT_MAX_WATCHERS,
    DEFAULT_WATCH_TIMEOUT_S,
    PUSH_NOTIFY_AUTO,
    PUSH_NOTIFY_MODES,
    UPSTREAM_COLLECTORS,
    UPSTREAM_SLICES,
    ConfigError,
    parse_delta_window,
    parse_nonneg_int,
    parse_positive_int,
    parse_upstream_mode,
)
from gpu_feature_discovery_tpu_torch.obs import metrics as obs_metrics
from gpu_feature_discovery_tpu_torch.utils import logging as tfd_logging

log = logging.getLogger("tfd.fleet")

# The collector's own metrics port: next to the daemon's 9101 so one
# scrape config covers both, distinct so a collector colocated with a
# daemon (dev, tests) needs no flag.
DEFAULT_FLEET_METRICS_PORT = 9102
# How often the collector runs a scrape round. 10s keeps a fleet pane
# near-live while an idle fleet's round is N 304 header exchanges — the
# cost is connection keep-alive, not bodies.
DEFAULT_SCRAPE_INTERVAL = 10.0
# Round budget as a fraction of the interval: a round must never bleed
# into the next (the engine's 0.8 * labeler-timeout rationale).
ROUND_BUDGET_FRACTION = 0.8
# How long a notify-woken early round waits before starting, so a burst
# of child notifications (a rollout touching many slices at once)
# coalesces into one round instead of one round per notification — the
# daemon tier's reconcile-debounce rationale.
NOTIFY_DEBOUNCE_S = 0.5


@dataclass(frozen=True)
class FleetFlag:
    """One collector flag: the FLAG_DEFS shape minus the Config setter
    (the collector resolves straight to a values dict). docs drift
    guard (tests/test_torch_fleet.py, against README.md) reads this table."""

    name: str
    env_vars: Sequence[str]
    parse: Callable[[Any], Any]
    default: Any
    help: str


FLEET_FLAG_DEFS: List[FleetFlag] = [
    FleetFlag(
        name="targets-file",
        env_vars=("TFD_FLEET_TARGETS",),
        parse=str,
        default="",
        help="path to the fleet targets file (target name -> host list, "
        "fleet/targets.py grammar; slices, or regions under "
        "--upstream-mode=collectors); REQUIRED — the collector has "
        "nothing to scrape without it; stat-triple watched "
        "(mtime/size/inode), so any rewrite — even within the same "
        "second — reloads the fleet without a restart",
    ),
    FleetFlag(
        name="scrape-interval",
        env_vars=("TFD_FLEET_SCRAPE_INTERVAL",),
        parse=parse_duration,
        default=DEFAULT_SCRAPE_INTERVAL,
        help="time between fleet scrape rounds (Go duration, e.g. 10s); "
        "an idle fleet's round is ~N 304 header exchanges, so short "
        "intervals are cheap",
    ),
    FleetFlag(
        name="metrics-addr",
        env_vars=("TFD_METRICS_ADDR",),
        parse=str,
        default=DEFAULT_METRICS_ADDR,
        help="bind address for the collector's HTTP server "
        "(/fleet/snapshot, /metrics, /healthz, /readyz)",
    ),
    FleetFlag(
        name="metrics-port",
        env_vars=("TFD_METRICS_PORT",),
        parse=parse_nonneg_int,
        default=DEFAULT_FLEET_METRICS_PORT,
        help="port for the collector's HTTP server; 0 binds an "
        "ephemeral port (the collector always serves — the inventory "
        "IS the product)",
    ),
    FleetFlag(
        name="peer-timeout",
        env_vars=("TFD_PEER_TIMEOUT",),
        parse=parse_duration,
        default=DEFAULT_PEER_TIMEOUT,
        help="per-target connect/read budget for one /peer/snapshot "
        "poll (2 consecutive misses confirm a chain member "
        "unreachable, exactly like the slice tier)",
    ),
    FleetFlag(
        name="peer-fanout",
        env_vars=("TFD_PEER_FANOUT",),
        parse=parse_nonneg_int,
        default=DEFAULT_PEER_FANOUT,
        help="how many slices one scrape round polls concurrently; "
        "0 (default) is auto — min(8, slices); 1 is sequential",
    ),
    FleetFlag(
        name="peer-token",
        env_vars=("TFD_PEER_TOKEN",),
        parse=str,
        default="",
        help="shared secret sent on every /peer/snapshot poll (the "
        "slices' daemons require it once their --peer-token is set) "
        "and required on the collector's own /fleet/snapshot; empty "
        "sends nothing and serves the inventory openly",
    ),
    FleetFlag(
        name="push-notify",
        env_vars=("TFD_PUSH_NOTIFY",),
        parse=str,
        default=PUSH_NOTIFY_AUTO,
        help="push-on-delta notifications (on | off | auto): 'on' makes "
        "this collector SUBSCRIBE on the polls it already sends (its "
        "children POST a small authenticated /peer/notify hint when "
        "their snapshot changes, and between full confirmation sweeps "
        "on the --max-staleness cadence a round polls only dirty "
        "targets) and NOTIFY its own parent the same way when the "
        "served inventory changes; 'off' is today's poll-everything "
        "round byte for byte; 'auto' (default) is on exactly when "
        "--peer-token is set — the notify endpoint never works "
        "unauthenticated",
    ),
    FleetFlag(
        name="max-staleness",
        env_vars=("TFD_MAX_STALENESS",),
        parse=parse_duration,
        default=0.0,
        help="the full confirmation-sweep cadence under --push-notify "
        "(Go duration): between sweeps a round polls only notified-"
        "dirty targets, and the sweep — the ONLY correctness mechanism "
        "— repairs lost notifications, dead children that cannot push "
        "their own death, and rotated tokens within this bound. 0 "
        "(default) sweeps every round: push adds promptness but the "
        "idle economy stays pull-shaped until a cadence is set",
    ),
    FleetFlag(
        name="state-dir",
        env_vars=("TFD_STATE_DIR",),
        parse=str,
        default="",
        help="directory where the last-good fleet inventory is "
        "persisted atomically; a collector restart serves it "
        "immediately with per-slice restored markers until each "
        "slice's first live poll — a restarted ROOT restores per-"
        "region entries until each region's first live scrape. An HA "
        "pair may share one directory: saves are atomic renames, so "
        "the file is last-writer-wins, never torn (empty = disabled)",
    ),
    FleetFlag(
        name="upstream-mode",
        env_vars=("TFD_FLEET_UPSTREAM_MODE",),
        parse=parse_upstream_mode,
        default=UPSTREAM_SLICES,
        help="what the targets file's entries are: slices (default — "
        "each entry is one slice's worker list, scraped over "
        "/peer/snapshot) or collectors (each entry is a REGION whose "
        "hosts are that region's fleet collectors, scraped over "
        "/fleet/snapshot and merged under region/<name>/<slice> keys — "
        "the federation tier; the merged body is itself schema-"
        "versioned and ETag-cached, so a root is a valid upstream for "
        "a higher root)",
    ),
    FleetFlag(
        name="delta-window",
        env_vars=("TFD_FLEET_DELTA_WINDOW",),
        parse=parse_delta_window,
        default=DEFAULT_FLEET_DELTA_WINDOW,
        help="how many publish generations of ETag lineage the "
        "collector retains for /fleet/snapshot?since=<generation> "
        "delta serving; a client whose generation fell out of the "
        "window (or whose ETag lineage does not match) gets the full "
        "body — a forced resync, never a wrong delta. 0 disables "
        "delta serving entirely (every ?since answers with the full "
        "body)",
    ),
    FleetFlag(
        name="filter-cache-size",
        env_vars=("TFD_FLEET_FILTER_CACHE_SIZE",),
        parse=parse_positive_int,
        default=DEFAULT_FILTER_CACHE_SIZE,
        help="how many distinct filtered /fleet/snapshot views the "
        "collector keeps rendered (LRU; evictions counted in "
        "tfd_fleet_filter_cache_total{outcome=\"evict\"}); each "
        "distinct canonical filter gets its own serialize-once/"
        "strong-ETag/304 economy, so size this at the number of "
        "distinct dashboard/scheduler filters — the unfiltered pane "
        "is cached separately and never evicted",
    ),
    FleetFlag(
        name="watch-timeout",
        env_vars=("TFD_FLEET_WATCH_TIMEOUT",),
        parse=parse_duration,
        default=DEFAULT_WATCH_TIMEOUT_S,
        help="upper bound on how long one /fleet/snapshot?watch= "
        "long-poll may park before answering 304 (Go duration); a "
        "client asking for longer is clamped — bounded parks keep "
        "restarts and LB idle-timeouts predictable",
    ),
    FleetFlag(
        name="max-watchers",
        env_vars=("TFD_FLEET_MAX_WATCHERS",),
        parse=parse_nonneg_int,
        default=DEFAULT_MAX_WATCHERS,
        help="how many /fleet/snapshot?watch= long-polls may park "
        "concurrently; past the cap a watch is answered 503 + "
        "Retry-After (counted in tfd_fleet_watch_total"
        "{outcome=\"rejected\"}) and the client falls back to "
        "polling. 0 rejects every watch",
    ),
    FleetFlag(
        name="max-inflight-requests",
        env_vars=("TFD_MAX_INFLIGHT_REQUESTS",),
        parse=parse_nonneg_int,
        default=DEFAULT_MAX_INFLIGHT,
        help="how many HTTP requests the collector's server works "
        "concurrently; past the cap a request is answered 503 + "
        "Retry-After immediately (tfd_http_rejected_total) instead "
        "of piling a thread on — parked watchers release their slot "
        "and are bounded by --max-watchers alone. 0 (default) is "
        "unlimited, the historical behavior",
    ),
    FleetFlag(
        name="ha-peers",
        env_vars=("TFD_FLEET_HA_PEERS",),
        parse=str,
        default="",
        help="ordered comma-separated host[:port] list of EVERY "
        "collector in this HA group, identical on every replica; the "
        "first reachable entry derives itself the active — no "
        "election, re-derived every round (the slice tier's lowest-"
        "reachable-id rule). A standby mirrors the active's "
        "/fleet/snapshot (If-None-Match — an agreeing pair exchanges "
        "304s) and publishes the tfd_fleet_ha_role/divergence gauges; "
        "every replica scrapes and serves regardless of role. Empty "
        "disables HA",
    ),
    FleetFlag(
        name="ha-self",
        env_vars=("TFD_FLEET_HA_SELF",),
        parse=str,
        default="",
        help="this replica's own entry in --ha-peers, verbatim; "
        "required exactly when --ha-peers is set",
    ),
]


def build_arg_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="gpu-feature-discovery-torch fleet-collector",
        description="aggregate many slices' /peer/snapshot into one "
        "authenticated fleet inventory",
    )
    for fd in FLEET_FLAG_DEFS:
        parser.add_argument(
            f"--{fd.name}", dest=fd.name, default=None, help=fd.help
        )
    parser.add_argument(
        "--debug", action="store_true", help="enable debug logging"
    )
    return parser


def resolve_flags(ns: dict, environ: Optional[dict] = None) -> dict:
    """CLI > env > default for the collector's flag table."""
    environ = environ if environ is not None else dict(os.environ)
    values = {}
    for fd in FLEET_FLAG_DEFS:
        raw = ns.get(fd.name)
        if raw is None:
            raw = next(
                (
                    environ[e]
                    for e in fd.env_vars
                    if environ.get(e) not in (None, "")
                ),
                None,
            )
        values[fd.name] = fd.parse(raw) if raw is not None else fd.default
    return values


def run_epoch(values: dict, targets, sigs) -> str:
    """One collector epoch: build the collector + server + targets
    watcher, scrape until a decision. Returns "restart" (SIGHUP or a
    changed targets file — the caller re-reads and rebuilds),
    "shutdown" (clean signal exit), or "error" (the server could not
    bind — serving the inventory IS the product, so the caller must
    exit nonzero, not report a clean completion)."""
    from gpu_feature_discovery_tpu_torch.cmd import events as reconcile_events
    from gpu_feature_discovery_tpu_torch.cmd.main import _check_signal
    from gpu_feature_discovery_tpu_torch.fleet.collector import FleetCollector
    from gpu_feature_discovery_tpu_torch.fleet.ha import HaMonitor, parse_ha_peers
    from gpu_feature_discovery_tpu_torch.obs.server import (
        IntrospectionServer,
        IntrospectionState,
    )
    from gpu_feature_discovery_tpu_torch.peering.notify import resolve_push_notify

    interval = values["scrape-interval"]
    upstream_mode = values["upstream-mode"]
    push = resolve_push_notify(
        values["push-notify"] or PUSH_NOTIFY_AUTO, values["peer-token"]
    )
    collector = FleetCollector(
        targets,
        # Bare target hosts default to the tier they name: slice daemons
        # serve on the daemon metrics port, region collectors on the
        # collector port.
        default_port=(
            DEFAULT_FLEET_METRICS_PORT
            if upstream_mode == UPSTREAM_COLLECTORS
            else DEFAULT_METRICS_PORT
        ),
        peer_timeout=values["peer-timeout"],
        fanout=values["peer-fanout"] or None,
        round_budget=ROUND_BUDGET_FRACTION * interval,
        peer_token=values["peer-token"],
        state_dir=values["state-dir"],
        upstream_mode=upstream_mode,
        delta_window=values["delta-window"],
        push_notify=push,
        # An unset --max-staleness sweeps on the scrape cadence itself
        # (every round — push adds promptness, not yet economy); a set
        # cadence makes the rounds between sweeps O(dirty).
        sweep_interval=values["max-staleness"] or interval,
        filter_cache_size=values["filter-cache-size"],
        watch_timeout=values["watch-timeout"],
        max_watchers=values["max-watchers"],
    )
    ha = None
    if values["ha-peers"]:
        ha = HaMonitor(
            parse_ha_peers(values["ha-peers"]),
            values["ha-self"],
            # Bare --ha-peers entries default to THIS collector's own
            # serving port: the peers are replicas of the same
            # deployment, so they serve where we serve (an ephemeral
            # port-0 bind falls back to the collector default).
            default_port=(
                values["metrics-port"] or DEFAULT_FLEET_METRICS_PORT
            ),
            peer_timeout=values["peer-timeout"],
            peer_token=values["peer-token"],
        )
    state = IntrospectionState(interval)
    events = reconcile_events.EventQueue()
    peer_notify = notify_subscribe = None
    if push:
        def peer_notify(name, generation, etag):
            # The receive hook runs on a handler thread: mark the child
            # dirty (name validated against the configured targets) and
            # post the wake — the run loop decides, under its own storm
            # damping, whether the next round starts early.
            if not collector.mark_dirty(name, generation, etag):
                return False
            events.post(
                reconcile_events.Event(
                    reconcile_events.REASON_PEER_NOTIFY, detail=name
                )
            )
            return True

        notify_subscribe = collector.notify_subscriptions.observe_poll
    server = None
    try:
        server = IntrospectionServer(
            obs_metrics.REGISTRY,
            state,
            addr=values["metrics-addr"],
            port=values["metrics-port"],
            # The collector has no per-source provenance to leak; its
            # /debug/labels serves the per-slice summary below.
            debug_endpoints=True,
            fleet_snapshot=collector.inventory_response,
            fleet_query=collector.query_response,
            peer_token=values["peer-token"],
            peer_notify=peer_notify,
            notify_subscribe=notify_subscribe,
            max_inflight=values["max-inflight-requests"],
        )
    except OSError as e:
        log.error(
            "cannot bind collector server on %s:%s: %s",
            values["metrics-addr"],
            values["metrics-port"],
            e,
        )
        if ha is not None:
            ha.close()
        collector.close()
        return "error"
    if push:
        # The BOUND port (the flag may say 0 = ephemeral) rides the
        # subscribe headers so children know where to POST back.
        collector.set_notify_port(server.port)
    # A restored replica is ready from its first answer: the restore is
    # marked before the server handles a request.
    if collector.restored_slices:
        state.labels_written(
            _summary(collector), mode="restored"
        )
    server.start()
    log.info(
        "fleet collector serving on %s:%d (%d slices, scrape interval "
        "%.1fs%s)",
        values["metrics-addr"],
        server.port,
        len(targets),
        interval,
        ", push-on-delta" if push else "",
    )
    # Storm damping for notify-woken early rounds: a fleet-wide restart
    # makes every child notify at once, and the damper bounds the extra
    # rounds to roughly one per interval plus a small burst — the sweep
    # cadence is never threatened, only supplemented.
    notify_bucket = reconcile_events.TokenBucket(
        rate=1.0 / max(interval, 0.001), burst=reconcile_events.PROBE_BURST
    )
    watcher = reconcile_events.ConfigFileWatcher(
        values["targets-file"], events
    ).start()
    try:
        while True:
            changed = collector.poll_round()
            if ha is not None:
                # Role + standby mirror ride the scrape cadence: the
                # mirror poll doubles as the active's liveness probe.
                # The round's changed keys let the divergence gauge
                # update O(changed) instead of re-walking the pane.
                ha.observe_round(
                    collector.inventory_payload()["slices"],
                    own_changed=changed,
                )
            state.cycle_completed()
            # /readyz stays 503 until here on a cold start (no state
            # restore): a fresh replica behind the HA Service must never
            # serve an empty inventory as ready.
            state.labels_written(_summary(collector), mode="full")
            deadline = time.monotonic() + interval
            while True:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                # Three producers, one wait: the OS signal queue decides
                # immediately; the targets watcher's CONFIG_CHANGED is
                # a restart; a child's accepted /peer/notify starts the
                # next round early — debounced so a burst coalesces into
                # ONE early round, token-bucketed so a notify storm
                # cannot turn the scrape loop into a busy loop (the
                # scheduled cadence and its sweep are unaffected either
                # way). Bounded sub-waits keep reload latency under
                # ~0.2s on top of the watcher's own poll.
                decision = _check_signal(
                    sigs, timeout=min(0.2, remaining)
                )
                if decision is not None:
                    return decision
                event = events.get_nowait()
                if event is None:
                    continue
                if event.reason == reconcile_events.REASON_CONFIG_CHANGED:
                    log.info("targets file changed; reloading fleet")
                    return "restart"
                if (
                    event.reason == reconcile_events.REASON_PEER_NOTIFY
                    and remaining > NOTIFY_DEBOUNCE_S
                    and notify_bucket.try_take()
                ):
                    debounce_until = time.monotonic() + NOTIFY_DEBOUNCE_S
                    while time.monotonic() < debounce_until:
                        decision = _check_signal(sigs, timeout=0.1)
                        if decision is not None:
                            return decision
                        drain = events.get_nowait()
                        if drain is not None and (
                            drain.reason
                            == reconcile_events.REASON_CONFIG_CHANGED
                        ):
                            log.info(
                                "targets file changed; reloading fleet"
                            )
                            return "restart"
                    break
    finally:
        watcher.stop()
        server.close()
        if ha is not None:
            ha.close()
        collector.close()


def _summary(collector) -> dict:
    """The /debug/labels view of the inventory: one row per slice."""
    doc = collector.inventory_payload()
    out = {}
    for name, entry in doc["slices"].items():
        healthy = entry.get("healthy_hosts")
        total = entry.get("total_hosts")
        status = "stale" if entry.get("stale") else (
            "restored" if entry.get("restored") else "live"
        )
        out[name] = f"{status}:{healthy}/{total}"
    return out


def main(argv: Optional[list] = None) -> int:
    parser = build_arg_parser()
    ns = vars(parser.parse_args(argv))
    tfd_logging.setup(debug=ns.pop("debug", False))
    from gpu_feature_discovery_tpu_torch.cmd.main import new_os_watcher
    from gpu_feature_discovery_tpu_torch.fleet.targets import parse_targets_file

    sigs = new_os_watcher()
    # The last successfully parsed target set, carried across epochs: a
    # targets file caught mid-rewrite (a torn os.replace race, a config
    # tool's truncated temp copy, plain invalid YAML) must not error the
    # epoch — the collector keeps scraping the roster it already trusts
    # and the watcher fires again when the write completes. Only a FIRST
    # load with nothing to fall back on is fatal.
    last_good_targets = None
    while True:
        try:
            values = resolve_flags(ns)
            if not values["targets-file"]:
                log.error(
                    "no targets file: pass --targets-file or set "
                    "TFD_FLEET_TARGETS"
                )
                return 1
            if values["push-notify"] not in PUSH_NOTIFY_MODES:
                raise ConfigError(
                    f"invalid --push-notify {values['push-notify']!r} "
                    f"(expected one of {', '.join(PUSH_NOTIFY_MODES)})"
                )
            if bool(values["ha-peers"]) != bool(values["ha-self"]):
                raise ConfigError(
                    "--ha-peers and --ha-self must be set together "
                    "(the ordered group AND this replica's entry in it)"
                )
            if values["ha-peers"]:
                # Fail a bad pairing at startup, not mid-epoch: the
                # monitor re-runs the same validation when built.
                from gpu_feature_discovery_tpu_torch.fleet.ha import (
                    parse_ha_peers,
                )

                if values["ha-self"] not in parse_ha_peers(
                    values["ha-peers"]
                ):
                    raise ConfigError(
                        f"--ha-self {values['ha-self']!r} is not an "
                        "entry of --ha-peers"
                    )
        except ConfigError as e:
            log.error("unable to load fleet collector config: %s", e)
            return 1
        try:
            targets = parse_targets_file(values["targets-file"])
        except ConfigError as e:
            if last_good_targets is None:
                log.error("unable to load fleet collector config: %s", e)
                return 1
            obs_metrics.FLEET_TARGETS_RELOAD_FAILURES.inc()
            log.warning(
                "targets file reload failed (%s); keeping the last-good "
                "%d-target set",
                e,
                len(last_good_targets),
            )
            targets = last_good_targets
        else:
            last_good_targets = targets
        if not targets:
            log.warning("targets file names no slices; serving an empty "
                        "inventory until it does")
        decision = run_epoch(values, targets, sigs)
        if decision == "restart":
            continue
        return 0 if decision == "shutdown" else 1
