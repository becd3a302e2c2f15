"""The port's metric families (every ``tfd_*`` series) and the per-cycle
stage store (twin: ``gpu_feature_discovery_tpu/obs/metrics.py``).

Each family keeps its twin's name, type, label names and buckets, so a
dashboard built on the twin reads the port unchanged; the help text says
what the series means here where the twin's names PJRT or XLA; the
fleet collector's and the HTTP admission gate's keep the twin's help
text too. Every twin family is declared (tests/test_torch_obs.py).

``utils/timing.py``'s cycle summary and ``--timings-file`` are views
over the stage store here (``observe_stage`` / ``cycle_stages``), and
the introspection server renders ``REGISTRY``. Recording is
unconditional; ``--metrics-port`` only decides whether a scraper can
see it. Every series is recorded in the labeling process, the one that
serves ``/metrics``: what the broker worker measures on the device
reaches it in the worker's reports, and its spans in its replies.

Three families are the port's own, with no twin: ``tfd_span_duration_seconds``
and ``tfd_probe_gap_seconds`` (the span tree of ``obs/spans.py``, on
``SPAN_BUCKETS``) and ``tfd_fsyncs_total``.
"""

from __future__ import annotations

import threading
from typing import Dict

from gpu_feature_discovery_tpu_torch.obs.registry import Registry

REGISTRY = Registry()

# -- cycle outcomes (cmd/main.py, cmd/supervisor.py) -------------------------

CYCLES_TOTAL = REGISTRY.counter(
    "tfd_cycles_total",
    "Labeling cycle attempts by outcome: full (all sources, file written), "
    "degraded (backend down, non-device labels written), failed (exception "
    "contained by the supervisor).",
    labelnames=("outcome",),
)
RESERVES_TOTAL = REGISTRY.counter(
    "tfd_reserves_total",
    "Failed cycles whose last-good labels were re-served to the output "
    "file (with the tfd.unhealthy-cycles marker).",
)
CONSECUTIVE_CYCLE_FAILURES = REGISTRY.gauge(
    "tfd_consecutive_cycle_failures",
    "Current streak of failed labeling cycles (the tfd.unhealthy-cycles "
    "label value); 0 after any clean cycle.",
)
CYCLE_DURATION = REGISTRY.histogram(
    "tfd_cycle_duration_seconds",
    "End-to-end label generation time per cycle (the labelgen.total span).",
)
LAST_CYCLE_COMPLETED = REGISTRY.gauge(
    "tfd_last_cycle_completed_timestamp_seconds",
    "Wall-clock time of the last COMPLETED cycle (full, degraded, or "
    "re-served) — the same event that touches the heartbeat file.",
)

# -- event-driven reconcile loop (cmd/events.py, --reconcile) ----------------

RECONCILE_WAKES = REGISTRY.counter(
    "tfd_reconcile_wakes_total",
    "Event-loop wakes by reason: signal, worker_died (broker worker "
    "death), config_changed (the --config-file watcher), health_delta, "
    "peer_delta (slice membership moved), peer_notify (POST /peer/notify), "
    "probe_request (POST /probe), staleness_bound "
    "(--max-staleness expired with no event). One wake per cycle "
    "decision; the events a wake absorbed beyond the first are in "
    "tfd_reconcile_coalesced_total.",
    labelnames=("reason",),
)
RECONCILE_COALESCED = REGISTRY.counter(
    "tfd_reconcile_coalesced_total",
    "Events absorbed into an already-pending wake — the debounce window, "
    "the token-bucket deferral, and the failed-cycle backoff wait all "
    "coalesce bursts into one cycle; suppressed wakes are counted here, "
    "never dropped silently.",
)
WAKE_TO_LABELS = REGISTRY.histogram(
    "tfd_wake_to_labels_seconds",
    "Latency from the wake-triggering event to the cycle's label write "
    "(for staleness-bound wakes, from the wake itself).",
)

# -- backend init / degraded mode (resource/factory.py, sandbox/, supervisor) --

BACKEND_INIT_ATTEMPTS = REGISTRY.counter(
    "tfd_backend_init_attempts_total",
    "Backend factory invocations (construction attempts), healthy or not: "
    "in process, per probe child, or per broker worker spawn.",
)
BACKEND_INIT_FAILURES = REGISTRY.counter(
    "tfd_backend_init_failures_total",
    "Supervised backend construction+init attempts that raised (one per "
    "degraded acquisition attempt).",
)
BACKEND_INIT_RECOVERIES = REGISTRY.counter(
    "tfd_backend_init_recoveries_total",
    "Times the backend came back after one or more failed init attempts.",
)
BACKEND_INIT_BACKOFF = REGISTRY.gauge(
    "tfd_backend_init_backoff_seconds",
    "Backoff delay before the next backend init attempt; 0 while healthy.",
)
DEGRADED = REGISTRY.gauge(
    "tfd_degraded",
    "1 while the device backend is failing init and degraded labels are "
    "being published (the tfd.degraded marker), else 0. In the "
    "multi-backend registry cycle: 1 while ANY enabled backend family "
    "is down (tfd_backend_up has the per-family detail).",
)

# -- multi-backend registry (resource/registry.py, --backends gpu,cpu) -------

BACKEND_UP = REGISTRY.gauge(
    "tfd_backend_up",
    "Per enabled backend family in the multi-backend registry cycle: 1 "
    "while the family's backend is acquired and its labels publish "
    "fresh, 0 while it is down (only that family's labels degrade). "
    "Absent entirely on the classic single-backend path.",
    labelnames=("backend",),
)
BACKEND_INITS = REGISTRY.counter(
    "tfd_backend_inits_total",
    "Per-backend init attempts in the multi-backend registry cycle, by "
    "outcome (ok | error). The classic path's un-labeled "
    "tfd_backend_init_attempts_total/failures_total keep counting in "
    "both modes.",
    labelnames=("backend", "outcome"),
)

# -- probe sandbox, broker and restart/flap resilience (sandbox/) ------------

PROBE_DURATION = REGISTRY.histogram(
    "tfd_probe_duration_seconds",
    "Wall time of each sandboxed device probe, whatever its outcome: a "
    "probe child (interpreter, torch import, CUDA set-up, enumeration) or "
    "a broker worker's spawn up to its ready frame.",
)
PROBE_KILLS = REGISTRY.counter(
    "tfd_probe_kills_total",
    "Probe children and broker workers SIGKILLed: wall-clock budget "
    "exceeded (--probe-timeout, at a spawn or a request), engine "
    "deadline-miss escalation, or epoch-close cleanup of a worker "
    "still spawning.",
)
PROBE_CRASHES = REGISTRY.counter(
    "tfd_probe_crashes_total",
    "Probe children and broker workers that died to a signal of their own "
    "(a native SIGSEGV et al.) — contained as retryable init failures "
    "instead of killing the daemon.",
)
BROKER_REQUESTS = REGISTRY.counter(
    "tfd_broker_requests_total",
    "Requests (snapshot/health/ping) served by the persistent probe "
    "broker worker — acquisitions through a live broker advance this "
    "while tfd_backend_init_attempts_total stays flat.",
)
BROKER_REQUEST_DURATION = REGISTRY.histogram(
    "tfd_broker_request_duration_seconds",
    "Round-trip time of each broker request (pipe RPC against the worker "
    "that holds the CUDA devices), whatever its outcome.",
)
BROKER_RESPAWNS = REGISTRY.counter(
    "tfd_broker_respawns_total",
    "Broker workers respawned after a previous worker of the same epoch "
    "died (crash, hang-kill, EOF) or was recycled (--broker-max-requests).",
)
BROKER_UP = REGISTRY.gauge(
    "tfd_broker_up",
    "1 while a broker worker is live and serving requests, else 0 "
    "(including --probe-broker=off, where no worker ever exists).",
)
COMPILE_CACHE_ENABLED = REGISTRY.gauge(
    "tfd_compile_cache_enabled",
    "1 while the kernel-build cache directory (--compilation-cache-dir, "
    "ops/kernel_cache.py) exists and is writable or already holds the "
    "hand-written kernels' libraries under their keys (a restart then "
    "loads them instead of running nvcc), else 0.",
)
FIRST_PROBE_COMPILE = REGISTRY.gauge(
    "tfd_first_probe_compile_seconds",
    "First-use phase of the most recent probe that paid it: kernel library "
    "load, cuBLAS set-up, the burn-in's CUDA-graph capture and NCCL's first "
    "use (the probe's compile_ms in process; through the broker, the "
    "worker's pre-warm, which pays it before the first probe). Left as it "
    "was by the probes after, which pay none.",
)
RESTART_TO_LABELS = REGISTRY.gauge(
    "tfd_restart_to_labels_seconds",
    "Wall time from process start to this process's FIRST full live "
    "label write (restored/degraded writes excluded) — the cold-start "
    "figure the startup overlap exists to shrink. Set once per process.",
)
STATE_RESTORES = REGISTRY.counter(
    "tfd_state_restores_total",
    "Epoch starts that re-served persisted last-good labels from "
    "--state-dir (published with the tfd.restored marker).",
)
RESTORED = REGISTRY.gauge(
    "tfd_restored",
    "1 while the published labels are restored last-good state from a "
    "previous run (the tfd.restored marker), cleared by the first live "
    "full cycle; else 0.",
)
FLAP_SUPPRESSED = REGISTRY.counter(
    "tfd_flap_suppressed_total",
    "Cycles whose label change was suppressed by the --flap-window "
    "hysteresis (previous labels re-served with the tfd.flapping marker).",
)
FLAPPING = REGISTRY.gauge(
    "tfd_flapping",
    "1 while a label change is being held back by the --flap-window "
    "hysteresis, else 0.",
)

# -- per-device fault localisation (lm/health.py, --chip-probes) ------------

CHIP_OK = REGISTRY.gauge(
    "tfd_chip_ok",
    "Per-device burn-in verdict: 1 while the device's outputs are finite "
    "(the chip.<i>.ok label), 0 while sick. Never set under MIG, where no "
    "chip.<i>.* label is published. Series persist at their last value "
    "across a device-count shrink.",
    labelnames=("chip",),
)
CHIP_TFLOPS = REGISTRY.gauge(
    "tfd_chip_tflops",
    "Per-device sustained bf16 matmul rate from the last probe, RAW "
    "(no plausibility gating — operators diff devices across scrapes; "
    "the chip.<i>.tflops label applies the gates).",
    labelnames=("chip",),
)
STRAGGLER_DETECTED = REGISTRY.counter(
    "tfd_straggler_detected_total",
    "Probes that CONFIRMED a straggler device (throughput below "
    "--straggler-threshold of the healthy-device median on consecutive "
    "probes — the gpu.straggler-chip label).",
)

# -- cross-host slice coordination (peering/) -------------------------------

PEER_POLLS = REGISTRY.counter(
    "tfd_peer_polls_total",
    "Peer /peer/snapshot polls by outcome: ok (valid schema-1 snapshot), "
    "error (timeout, HTTP failure, junk body, worker-id mismatch — every "
    "failure shape counts as one miss), or skipped (the round budget ran "
    "out before this peer; its reachability state is untouched).",
    labelnames=("outcome",),
)
PEER_POLL_DURATION = REGISTRY.histogram(
    "tfd_peer_poll_duration_seconds",
    "Round-trip time of each peer snapshot poll, whatever its outcome "
    "(a timed-out poll contributes its full --peer-timeout budget).",
)
PEER_FANOUT_INFLIGHT = REGISTRY.gauge(
    "tfd_peer_fanout_inflight",
    "Peer polls currently in flight on the coordinator's bounded fan-out "
    "pool (--peer-fanout); 0 between rounds. A value pinned at the "
    "fan-out width across scrapes means the round is saturated by slow "
    "peers and the width (or --peer-timeout) needs raising.",
)
PEER_SNAPSHOT_NOT_MODIFIED = REGISTRY.counter(
    "tfd_peer_snapshot_not_modified_total",
    "Peer snapshot requests THIS daemon answered 304 Not Modified (the "
    "poller's If-None-Match matched the cached snapshot ETag): no body, "
    "no serialization, no JSON parse on either end. On an idle slice "
    "this should dominate tfd_peer_polls_total across the fleet.",
)
PEER_CONNECTION_REUSES = REGISTRY.counter(
    "tfd_peer_connection_reuses_total",
    "Peer polls completed over an already-open persistent HTTP "
    "connection (keep-alive reuse; steady-state polls skip TCP setup). "
    "A low reuse ratio means peer connections are being torn down "
    "between rounds — look for flapping peers or an intermediary "
    "closing idle connections.",
)
PEER_SNAPSHOT_SERIALIZATIONS = REGISTRY.counter(
    "tfd_peer_snapshot_serializations_total",
    "Times this daemon's peer snapshot was (re-)serialized — once per "
    "DISTINCT published label set / write mode, never per request "
    "(/peer/snapshot serves the cached body). Steady growth without "
    "label churn means something is perturbing the published set.",
)
PEER_UNREACHABLE = REGISTRY.gauge(
    "tfd_peer_unreachable",
    "1 while the named peer is CONFIRMED unreachable (2 consecutive "
    "failed polls), 0 after any successful poll.",
    labelnames=("peer",),
)
SLICE_DEGRADED = REGISTRY.gauge(
    "tfd_slice_degraded",
    "1 while the aggregated slice view counts fewer reachable hosts than "
    "WORKER_HOSTNAMES names (the slice.degraded label), else 0.",
)
COHORT_LEADERS = REGISTRY.gauge(
    "tfd_cohort_leaders",
    "Two-tier coordination (--cohort-size): cohorts this node currently "
    "sees served by a LIVE leader — on the slice leader, its own cohort "
    "plus every cohort whose leadership chain answered with an "
    "aggregate; 1 on a mid-tier cohort leader; leader visibility (0/1) "
    "on followers. 0 in flat mode.",
)
COHORT_DEGRADED = REGISTRY.gauge(
    "tfd_cohort_degraded",
    "Cohorts currently marked degraded in this node's view (whole "
    "leadership chain dark, members served by the slice leader's "
    "direct-poll fallback — the slice.cohort.<i>.degraded labels). "
    "0 in flat mode and on every non-slice-leader.",
)
COHORT_POLL_ROUNDS = REGISTRY.counter(
    "tfd_cohort_poll_rounds_total",
    "Hierarchical poll rounds STARTED by tier: cohort (the intra-cohort "
    "sibling round every member runs) or slice (the slice leader's "
    "inter-cohort leadership round). Counted at round start — a round "
    "abandoned by an epoch teardown still counts. Absent entirely in "
    "flat mode.",
    labelnames=("tier",),
)
NOTIFY_SENT = REGISTRY.counter(
    "tfd_notify_sent_total",
    "Push-on-delta notifications this process attempted upward, by "
    "outcome: ok (202 accepted), rejected (any non-202 answer — auth "
    "mismatch, unknown name, parent mid-restart), error (connection "
    "failed after the capped-backoff retries), dropped (a newer "
    "generation superseded this one before it could be sent, or the "
    "notify.drop fault site consumed it). Notifications are lossy hints "
    "by design: every non-ok outcome is repaired by the parent's next "
    "confirmation sweep, never by the child blocking its publish path.",
    labelnames=("outcome",),
)
NOTIFY_RECEIVED = REGISTRY.counter(
    "tfd_notify_received_total",
    "POST /peer/notify requests this parent's introspection server "
    "answered, by outcome: ok (202 — the named child was marked dirty "
    "and the reconcile loop woken), unauthorized (missing or mismatched "
    "token — the hook is never invoked, so an attacker cannot wake the "
    "poll loop), unknown (a name outside this parent's child set), "
    "invalid (unparseable body), disabled (push disabled or no "
    "subscription hook wired — answered 404), rejected (the "
    "notify.reject fault site answered 503 — chaos rows only).",
    labelnames=("outcome",),
)
DIRTY_CHILDREN = REGISTRY.gauge(
    "tfd_dirty_children",
    "Children currently marked dirty by an accepted /peer/notify hint "
    "and not yet re-polled. Drains to 0 after every round; a value that "
    "never drains means the poll loop is wedged while notifications "
    "keep arriving.",
)

# -- verdict actuation (actuation/engine.py, --actuation) -------------------

ACTUATION_ADVICE = REGISTRY.gauge(
    "tfd_actuation_advice",
    "1 while this daemon's label file carries actuation advice "
    "(schedulable=false / cordon-advice / would-cordon), 0 otherwise. "
    "Sums across a slice to the hosts currently advised — bounded by "
    "ceil(--max-actuated-fraction * hosts) by construction.",
)
ACTUATION_BUDGET_EXHAUSTED = REGISTRY.gauge(
    "tfd_actuation_budget_exhausted",
    "1 while this daemon holds a confirmed verdict that WANTS advice but "
    "the slice blast-radius budget (--max-actuated-fraction over the "
    "peer snapshot plane) suppresses it. A slice-wide sum near the host "
    "count is the systemic-false-positive signature: every member reads "
    "sick at once, and the budget — not the scheduler — is what kept "
    "the slice alive.",
)
ACTUATION_TRANSITIONS = REGISTRY.counter(
    "tfd_actuation_transitions_total",
    "Actuation state changes, by action: fired (advice published after "
    "the window held), cleared (verdicts converged clean for a full "
    "window), budget-suppressed (desire arrived but the slice budget "
    "said no), lease-lapsed (cached or restored advice outlived its "
    "lease without a fresh confirmation and was dropped — the "
    "fail-static path doing its job).",
    labelnames=("action",),
)
ACTUATION_CONVERGENCE_CYCLES = REGISTRY.gauge(
    "tfd_actuation_convergence_cycles",
    "Consecutive confirmed cycles the last advice firing waited for "
    "before publishing — the engine's self-reported verdict-to-advice "
    "latency in cycles. Equals --actuation-window when hysteresis is "
    "the only delay.",
)

# -- fleet aggregation service (fleet/, the fleet-collector mode) -----------

FLEET_SLICES = REGISTRY.gauge(
    "tfd_fleet_slices",
    "Slices in the served fleet inventory: the targets file's slice "
    "count in slices mode (re-read on a targets reload), or the merged "
    "region/<name>/<slice> entry count under --upstream-mode=collectors "
    "(the federation tier's pane width).",
)
FLEET_SLICES_STALE = REGISTRY.gauge(
    "tfd_fleet_slices_stale",
    "Slices whose ENTIRE leadership chain is confirmed dark in the "
    "collector's current inventory: entries served degraded-stale with "
    "their last-known data and a staleness age, or all-null for a "
    "target never reached since the collector started (a typo'd or "
    "decommissioned slice — null last_seen_unix tells the two apart). "
    "0 on a healthy fleet.",
)
FLEET_POLLS = REGISTRY.counter(
    "tfd_fleet_polls_total",
    "Collector upstream polls (/peer/snapshot in slices mode, "
    "/fleet/snapshot under --upstream-mode=collectors) by outcome: ok "
    "(valid snapshot or 304), error (timeout, HTTP failure, junk body, "
    "schema mismatch), oversize (the body hit the tier's size cap and "
    "was never parsed — a loud anomaly now that deltas make small "
    "bodies the norm), or skipped (the round budget ran out before "
    "this target).",
    labelnames=("outcome",),
)
FLEET_SNAPSHOT_NOT_MODIFIED = REGISTRY.counter(
    "tfd_fleet_snapshot_not_modified_total",
    "Collector polls answered 304 Not Modified by the upstream (slice "
    "leader or region collector — the collector's If-None-Match "
    "matched): a header exchange, no body, no parse. On an idle fleet "
    "this should dominate tfd_fleet_polls_total{outcome=\"ok\"}.",
)
FLEET_INVENTORY_NOT_MODIFIED = REGISTRY.counter(
    "tfd_fleet_inventory_not_modified_total",
    "Inbound /fleet/snapshot requests THIS collector answered 304 Not "
    "Modified (the consumer's If-None-Match matched the cached inventory "
    "ETag) — the serving-side twin of the collector's own outbound "
    "tfd_fleet_snapshot_not_modified_total; the peer-surface counter "
    "(tfd_peer_snapshot_not_modified_total) never moves on a collector.",
)
FLEET_SCRAPE_ROUNDS = REGISTRY.counter(
    "tfd_fleet_scrape_rounds_total",
    "Fleet scrape rounds STARTED (one bounded concurrent pass over every "
    "configured slice's leadership chain).",
)
FLEET_SCRAPE_DURATION = REGISTRY.histogram(
    "tfd_fleet_scrape_round_duration_seconds",
    "Wall time of each fleet scrape round, whatever its outcomes (a "
    "round against dark slices contributes its timeouts).",
)
FLEET_RESTORED = REGISTRY.gauge(
    "tfd_fleet_restored",
    "1 while the served fleet inventory still contains entries restored "
    "from --state-dir (a collector restart serves last-good data "
    "immediately; each entry clears on its slice's first live poll — at "
    "the federation tier, on its region's first live scrape), else 0.",
)
FLEET_REGIONS = REGISTRY.gauge(
    "tfd_fleet_regions",
    "Upstream REGION collectors this collector is configured to scrape "
    "(--upstream-mode=collectors, the federation tier; the targets "
    "file's entry count there). 0 on a slices-mode collector.",
)
FLEET_REGIONS_STALE = REGISTRY.gauge(
    "tfd_fleet_regions_stale",
    "Regions whose ENTIRE collector chain is confirmed dark in the root "
    "collector's current inventory: the region is marked degraded in "
    "the regions meta map and every one of its merged slice entries is "
    "served degraded-stale with last_seen_unix preserved. 0 on a "
    "healthy federation (or in slices mode).",
)
FLEET_HA_ROLE = REGISTRY.gauge(
    "tfd_fleet_ha_role",
    "1 while this collector derives itself the ACTIVE of its --ha-peers "
    "group (the first reachable entry of the shared ordered list — "
    "re-derived every round, no election protocol), 0 while standby. "
    "Meaningful only with --ha-peers set; both replicas scrape and "
    "serve regardless of role.",
)
FLEET_ETAG_MISSING = REGISTRY.counter(
    "tfd_fleet_etag_missing_total",
    "Upstream 200 responses that carried NO ETag header (a stripping "
    "proxy in front of the target?): every subsequent poll of that host "
    "refetches and reparses the full body — the 304 economy is silently "
    "lost for it. Warned once per host in the log; this counter keeps "
    "the regression visible on a dashboard. 0 on a healthy fleet.",
)
FLEET_DELTA_SERVED = REGISTRY.counter(
    "tfd_fleet_delta_served_total",
    "GET /fleet/snapshot?since=<generation> requests this collector "
    "answered, by outcome: delta (an O(changed) document — only entries "
    "whose generation advanced past the client's, plus tombstones for "
    "dropped keys) or resync (the full body instead: the client's "
    "generation is ahead of ours — a restart artifact — or older than "
    "the --delta-window lineage history, or its If-None-Match does not "
    "match that generation's recorded ETag). In-sync clients answer "
    "from tfd_fleet_inventory_not_modified_total (a 304), not here.",
    labelnames=("outcome",),
)
FLEET_DELTA_POLLS = REGISTRY.counter(
    "tfd_fleet_delta_polls_total",
    "Bodies this collector's delta-aware /fleet/snapshot polls (the "
    "federation scrape and the HA mirror) received, by kind: delta "
    "(applied onto the client-side mirror and VERIFIED against the "
    "served ETag) or full (first sync, or a forced resync). Under "
    "steady churn delta should dominate; persistent full bodies mean "
    "the upstream keeps refusing the client's ?since lineage.",
    labelnames=("kind",),
)
FLEET_POLL_BODY_BYTES = REGISTRY.counter(
    "tfd_fleet_poll_body_bytes_total",
    "Response body bytes this collector's upstream polls received, by "
    "kind (full documents vs delta documents); 304 header exchanges add "
    "nothing. The fleet tier's bytes-on-wire: the delta protocol's win "
    "is this counter's delta/full ratio under churn (the bench gates "
    "it at a 1,000-slice fleet).",
    labelnames=("kind",),
)
FLEET_TARGETS_RELOAD_FAILURES = REGISTRY.counter(
    "tfd_fleet_targets_reload_failures_total",
    "Epoch reloads of the --targets-file that failed to parse (torn "
    "write, partial copy, invalid YAML) while a last-good target set "
    "existed to keep serving. The collector polls the stale roster and "
    "warns instead of erroring the epoch; only a first load with no "
    "prior targets is fatal.",
)
FLEET_FILTER_VIEWS = REGISTRY.gauge(
    "tfd_fleet_filter_views",
    "Rendered filtered views currently held in the bounded LRU behind "
    "GET /fleet/snapshot?<filter> (--filter-cache-size). Each view is "
    "one canonicalized filter's serialize-once body + strong ETag; the "
    "unfiltered pane is the collector's own publish-seam cache and "
    "never counts here.",
)
FLEET_FILTER_CACHE = REGISTRY.counter(
    "tfd_fleet_filter_cache_total",
    "Filtered-view cache traffic, by outcome: hit (the canonical filter "
    "already had a rendered view — possibly revalidated against a moved "
    "generation, which is dict work, not serialization), miss (first "
    "sight of this filter: filter + render + insert), evict (the LRU "
    "crossed --filter-cache-size and dropped its coldest view; steady "
    "eviction means the cache is sized below the live filter "
    "population and every cycle re-renders).",
    labelnames=("outcome",),
)
FLEET_FILTER_RENDERS = REGISTRY.counter(
    "tfd_fleet_filter_renders_total",
    "Filtered-view bodies actually serialized (full bodies and delta "
    "documents). The per-filter economy's hard gate: at most one full "
    "render per distinct filter per generation that CHANGED its "
    "content — an idle filter re-renders nothing, ever (the bench and "
    "the scale harness pin this at zero across idle rounds).",
)
FLEET_FILTERED_NOT_MODIFIED = REGISTRY.counter(
    "tfd_fleet_filtered_not_modified_total",
    "Filtered /fleet/snapshot requests answered 304 Not Modified (the "
    "consumer's If-None-Match matched its view's cached ETag): no "
    "filtering, no serialization, no body. The filtered twin of "
    "tfd_fleet_inventory_not_modified_total — on an idle fleet this "
    "should dominate filtered traffic (the bench gates >= 90%).",
)
FLEET_QUERY_REJECTED = REGISTRY.counter(
    "tfd_fleet_query_rejected_total",
    "GET /fleet/snapshot queries rejected 400: unknown or duplicated "
    "params, malformed values, a non-integer or negative ?since=, or "
    "?watch= without ?since=. A typo'd dashboard answered 400 is "
    "LOUD; silently serving it the full pane would defeat the delta "
    "and filter economies invisibly. Growth here is a misconfigured "
    "consumer to hunt down.",
)
FLEET_WATCHERS = REGISTRY.gauge(
    "tfd_fleet_watchers",
    "Long-poll watch requests currently parked on "
    "/fleet/snapshot?since=<gen>&watch=<s> waiting for their filtered "
    "view's generation to move. Bounded by --max-watchers (the "
    "admission cap answers 503 + Retry-After past it); parked watchers "
    "release their --max-inflight-requests slot, so they never starve "
    "plain GETs.",
)
FLEET_WATCH = REGISTRY.counter(
    "tfd_fleet_watch_total",
    "Completed watch requests, by outcome: delta (the view's "
    "generation moved and the watcher was answered the O(changed) "
    "document — the wake-to-delta push), timeout (the watch window "
    "expired idle; answered 304 and the client re-arms), rejected "
    "(--max-watchers admission cap full: 503 + Retry-After, the "
    "watcher never parked).",
    labelnames=("outcome",),
)
FLEET_HA_DIVERGENCE = REGISTRY.gauge(
    "tfd_fleet_ha_divergence",
    "Inventory entries differing between this STANDBY's own pane and "
    "the active's mirrored /fleet/snapshot (volatile fields excluded: "
    "the quantized freshness stamp and restore markers). 0 on the "
    "active and on an agreeing pair; a persistently nonzero value is a "
    "SPLIT PANE — the two collectors see different fleets and an "
    "operator must diagnose before trusting either.",
)

# -- introspection server (obs/server.py) -----------------------------------

HTTP_ERRORS = REGISTRY.counter(
    "tfd_http_errors_total",
    "Introspection endpoint handlers that raised; the response is a 500 "
    "naming the error class instead of a torn-down connection. Unknown "
    "request paths collapse into endpoint=\"other\" — the label is never "
    "client-chosen.",
    labelnames=("endpoint",),
)

HTTP_INFLIGHT = REGISTRY.gauge(
    "tfd_http_inflight",
    "Requests the introspection server is answering right now (every "
    "method, every endpoint). ThreadingHTTPServer spawns one handler "
    "thread per connection with no ceiling of its own; "
    "--max-inflight-requests caps this gauge — a parked watch releases "
    "its slot (counted in tfd_fleet_watchers instead), so the cap "
    "governs work-in-progress, not connections held open on purpose.",
)
HTTP_REJECTED = REGISTRY.counter(
    "tfd_http_rejected_total",
    "Requests shed 503 + Retry-After at the --max-inflight-requests "
    "admission gate before any handler ran. Steady growth means the "
    "consumer population outruns the cap — raise it, or point "
    "dashboards at filtered views so each request costs a header "
    "exchange instead of a pane.",
)

# -- label engine (lm/engine.py) --------------------------------------------

LABELER_DURATION = REGISTRY.histogram(
    "tfd_labeler_duration_seconds",
    "Per-labeler wall time, recorded when the labeler finishes (a "
    "deadline-missed straggler contributes no sample until it completes).",
    labelnames=("labeler",),
)
LABELER_DEADLINE_MISSES = REGISTRY.counter(
    "tfd_labeler_deadline_misses_total",
    "Cycles in which the named labeler exceeded --labeler-timeout and was "
    "served from its last-good cache.",
    labelnames=("labeler",),
)
STRAGGLERS_HARVESTED = REGISTRY.counter(
    "tfd_labeler_stragglers_harvested_total",
    "Deadline-missed labelers whose late result a subsequent cycle folded "
    "back into the cache.",
    labelnames=("labeler",),
)
STALE_SOURCES = REGISTRY.gauge(
    "tfd_stale_sources",
    "Sources served from the last-good cache in the most recent parallel "
    "cycle (the tfd.stale-sources label names them).",
)

# -- label file output (lm/labels.py) ---------------------------------------

LABEL_WRITES = REGISTRY.counter(
    "tfd_label_file_writes_total",
    "Label serializations that reached the output (atomic rename, or "
    "stdout when no output file is configured).",
)
LABEL_WRITE_SKIPS = REGISTRY.counter(
    "tfd_label_file_write_skips_total",
    "Churn-free skips: cycles whose serialized labels were byte-identical "
    "to the file on disk, so no rename happened and NFD saw no event.",
)
LABEL_FILE_BYTES = REGISTRY.gauge(
    "tfd_label_file_bytes",
    "Serialized size of the last label set written.",
)
LABELS_PUBLISHED = REGISTRY.gauge(
    "tfd_labels_published",
    "Number of labels in the last written set.",
)
FSYNC_DURATION = REGISTRY.histogram(
    "tfd_file_fsync_duration_seconds",
    "fsync cost of the staged file before its atomic rename (label and "
    "timings files both stage through the same writer).",
)
FSYNCS = REGISTRY.counter(
    "tfd_fsyncs_total",
    "Every fsync the atomic writer makes, of the staged file and of its "
    "directory after the rename, by the file written: labels, state "
    "(--state-dir) or timings (--timings-file). A churn-free skipped "
    "label write makes none. Port-only.",
    labelnames=("file",),
)

# -- per-cycle stage store (the utils/timing.py backing) --------------------

# Latest duration per named span, cleared at cycle start. Written from the
# labeling thread and the engine's workers; read as a snapshot under the
# same lock.
_stage_lock = threading.Lock()
_cycle_stages: Dict[str, float] = {}

STAGE_DURATION = REGISTRY.gauge(
    "tfd_stage_duration_seconds",
    "Most recent duration of each named span (the Cycle timings log line "
    "and --timings-file render from the same store).",
    labelnames=("stage",),
)


# -- the span tree (obs/spans.py, utils/timing.py) --------------------------

# Fine enough for the tail of a 13 ms cycle and long enough for a worker's
# spawn: 50 us doubling to 26.2 s (DEFAULT_BUCKETS stays the twin's).
SPAN_BUCKETS = (
    0.00005, 0.0001, 0.0002, 0.0004, 0.0008, 0.0016, 0.0032, 0.0064,
    0.0128, 0.0256, 0.0512, 0.1024, 0.2048, 0.4096, 0.8192, 1.6384,
    3.2768, 6.5536, 13.1072, 26.2144,
)
SPAN_DURATION = REGISTRY.histogram(
    "tfd_span_duration_seconds",
    "Every span of the span tree by name (docs/torch/observability.md "
    "lists the fixed set): the labeling cycle and its stages, the broker's "
    "RPCs, the probe's phases and the broker worker's spans, folded in "
    "from the worker's replies. Port-only.",
    labelnames=("span",),
    buckets=SPAN_BUCKETS,
)
PROBE_GAP = REGISTRY.histogram(
    "tfd_probe_gap_seconds",
    "The time between two consecutive probes' device windows (one "
    "probe.device end to the next one's start) split by the host layer "
    "that held it: probe (the probe's host time outside its device window), "
    "broker (the pipe both ways), labelgen (the label cycle outside the "
    "health labeler), loop (the cycle outside labelgen.total). The four "
    "parts of one gap sum to it exactly. Port-only.",
    labelnames=("layer",),
    buckets=SPAN_BUCKETS,
)


def observe_stage(stage: str, elapsed: float) -> None:
    """One named span finished: feed the per-cycle store, the last-value
    gauge and, for labeler and cycle spans, the duration histograms."""
    with _stage_lock:
        _cycle_stages[stage] = elapsed
    STAGE_DURATION.labels(stage=stage).set(elapsed)
    if stage.startswith("labeler."):
        LABELER_DURATION.observe(elapsed, labeler=stage[len("labeler."):])
    elif stage == "labelgen.total":
        CYCLE_DURATION.observe(elapsed)


def reset_cycle_stages() -> None:
    with _stage_lock:
        _cycle_stages.clear()


def cycle_stages() -> Dict[str, float]:
    """Snapshot of the spans recorded since the last reset."""
    with _stage_lock:
        return dict(_cycle_stages)


def reset_for_tests() -> None:
    """Zero every series and forget the cycle stages and the span ring,
    so a test can assert exact counter values."""
    from gpu_feature_discovery_tpu_torch.obs import spans

    REGISTRY.reset_values()
    reset_cycle_stages()
    spans.reset()
