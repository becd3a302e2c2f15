"""The port's metric families (every ``tfd_*`` series) and the per-cycle
stage store (twin: ``gpu_feature_discovery_tpu/obs/metrics.py``).

Each family keeps its twin's name, type, label names and buckets, so a
dashboard built on the twin reads the port unchanged; the help text says
what the series means here where the twin's names PJRT or XLA. Only the
families of layers the port has are declared: those of the slice peer
layer, cohorts, actuation, the fleet collector, push notifications and
the HTTP admission gate land with their modules (tests/test_torch_obs.py
pins the list of what is left out).

``utils/timing.py``'s cycle summary and ``--timings-file`` are views
over the stage store here (``observe_stage`` / ``cycle_stages``), and
the introspection server renders ``REGISTRY``. Recording is
unconditional; ``--metrics-port`` only decides whether a scraper can
see it. Every series is recorded in the labeling process, the one that
serves ``/metrics``: what the broker worker measures on the device
reaches it in the worker's reports.
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

# -- introspection server (obs/server.py) -----------------------------------

HTTP_ERRORS = REGISTRY.counter(
    "tfd_http_errors_total",
    "Introspection endpoint handlers that raised; the response is a 500 "
    "naming the error class instead of a torn-down connection. Unknown "
    "request paths collapse into endpoint=\"other\" — the label is never "
    "client-chosen.",
    labelnames=("endpoint",),
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
    """Zero every series and forget the cycle stages, so a test can
    assert exact counter values."""
    REGISTRY.reset_values()
    reset_cycle_stages()
