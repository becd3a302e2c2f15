"""On-device burn-in health labeler, gated by --with-burnin (twin:
``gpu_feature_discovery_tpu/lm/health.py``).

A device can enumerate yet have degraded HBM or failing math units. When
enabled, a probing cycle runs the burn-in and the HBM probe on every local
CUDA device (ops/healthcheck.py ``measure_node_health``) and publishes:

    nvidia.com/gpu.health.ok            = true|false   (all devices finite)
    nvidia.com/gpu.health.matmul-tflops = <int>        (worst device's rate)
    nvidia.com/gpu.health.hbm-gbps      = <int>        (worst device's rate)
    nvidia.com/gpu.health.probe-ms      = <int>        (probing cycles only)
    nvidia.com/gpu.health.timing        = device-profiler|wall-clock

and, with --chip-probes (the default), per-device fault localisation:
``chip.<i>.ok``, ``chip.<i>.tflops``, ``chip.<i>.hbm-gbps``,
``chips.healthy``, ``chips.sick`` and a confirmed ``straggler-chip``.
A multi-GPU node also publishes ``health.ici.ok`` (the ring sweep over
peer copies and NCCL) and, with --chip-probes, ``health.ici.allreduce-gbps``
(the timed NCCL all-reduce, GiB/s per device).
The keys are the twin's ``google.com/tpu.*`` keys under the one allowed
translation to ``nvidia.com/gpu.``.

The probe runs every ``--burnin-interval`` cycles; cycles in between
republish the cached labels without ``probe-ms``.

Where the probe runs follows the manager. Under the persistent broker
(sandbox/broker.py, the supervised daemon's default) it is one
``health`` RPC to the worker process that holds the devices; the
worker pre-warms the kernels at spawn and answers ``warming`` until its
probe is done, and the labeling process never touches CUDA. Otherwise
(oneshot, ``--probe-broker=off``) it runs in the labeling process; there
the daemon's FIRST probe of a schedule runs on a background thread, so
the cycle's base labels publish at once while first use (kernel build,
cuBLAS and NCCL set-up, the burn-in's CUDA-graph capture) runs, and
later cycles collect it. Oneshot probes synchronously. Scheduling,
caching and rendering stay here either way. The ``chip.<i>.sick`` /
``chip.<i>.slow`` fault shots (utils/faults.py) are consumed here, at
probe launch, and travel with the probe.

Both paths record into this process's registry (obs/metrics.py), the one
``/metrics`` serves: ``tfd_first_probe_compile_seconds`` from the
report's ``phases.compile_ms``, or, through the broker, from the
worker's pre-warm (``prewarm_ms``, shipped with its first report: the
pre-warm pays first use there, so every probe reports 0),
``tfd_chip_ok{chip}`` and the raw, ungated
``tfd_chip_tflops{chip}`` beside the ``chip.<i>.*`` labels (and, like
them, never under MIG), and ``tfd_straggler_detected_total``.
"""

from __future__ import annotations

import functools
import logging
import os
import statistics
import threading
import time
import weakref

from gpu_feature_discovery_tpu_torch.config.flags import (
    DEFAULT_STRAGGLER_THRESHOLD,
    env_flag,
)
from gpu_feature_discovery_tpu_torch.config.spec import Config
from gpu_feature_discovery_tpu_torch.lm.labeler import Empty, Labeler
from gpu_feature_discovery_tpu_torch.lm.labels import Labels
from gpu_feature_discovery_tpu_torch.obs import metrics as obs_metrics
from gpu_feature_discovery_tpu_torch.resource.types import Manager
from gpu_feature_discovery_tpu_torch.utils.logging import warn_once

log = logging.getLogger("tfd.lm")

HEALTH_OK = "nvidia.com/gpu.health.ok"
HEALTH_TFLOPS = "nvidia.com/gpu.health.matmul-tflops"
HEALTH_HBM = "nvidia.com/gpu.health.hbm-gbps"
HEALTH_ICI = "nvidia.com/gpu.health.ici.ok"
HEALTH_PROBE_MS = "nvidia.com/gpu.health.probe-ms"
# Which clock produced the rate labels: "device-profiler" (CUDA events,
# ops/device_timing.py) or "wall-clock" (host timing).
HEALTH_TIMING = "nvidia.com/gpu.health.timing"

# A measured rate this far past the card's published peak is a timing
# artifact, not hardware. The margin absorbs spec-vs-measured unit slop
# (GB/s spec vs GiB/s measurement is a 1.074x ratio).
PLAUSIBILITY_MARGIN = 1.5

CHIP_OK_FMT = "nvidia.com/gpu.chip.%d.ok"
CHIP_TFLOPS_FMT = "nvidia.com/gpu.chip.%d.tflops"
CHIP_HBM_FMT = "nvidia.com/gpu.chip.%d.hbm-gbps"
CHIPS_HEALTHY = "nvidia.com/gpu.chips.healthy"
CHIPS_SICK = "nvidia.com/gpu.chips.sick"
STRAGGLER_CHIP = "nvidia.com/gpu.straggler-chip"
# The timed NCCL all-reduce of a multi-GPU node (ops/healthcheck.py
# ici_allreduce_probe), GiB/s per device on the ring model.
HEALTH_ICI_GBPS = "nvidia.com/gpu.health.ici.allreduce-gbps"

# A straggler must hold its deficit across this many CONSECUTIVE probes
# before the label publishes.
STRAGGLER_CONFIRM_PROBES = 2


def detect_straggler(per_chip, threshold: float):
    """Single-probe straggler candidate: the index of the slowest HEALTHY
    device when its rate falls below ``threshold`` x the median of the
    healthy devices' rates, else None. Needs >= 3 rated devices. Reads the
    best-iteration rate (``tflops_best``) when the probe provides one:
    host noise stalls some iterations of a healthy device, a degraded
    device is slow on every one."""
    rated = [
        (i, float(e.get("tflops_best") or e["tflops"]))
        for i, e in enumerate(per_chip)
        if e.get("healthy") and (e.get("tflops_best") or e.get("tflops")) is not None
    ]
    if len(rated) < 3:
        return None
    median = statistics.median(rate for _, rate in rated)
    if median <= 0:
        return None
    worst_idx, worst = min(rated, key=lambda r: r[1])
    return worst_idx if worst < threshold * median else None


class StragglerDetector:
    """Consecutive-probe confirmation on top of ``detect_straggler``: the
    SAME device must be the candidate on ``confirm`` probes in a row."""

    def __init__(self, threshold: float, confirm: int = STRAGGLER_CONFIRM_PROBES):
        self.threshold = threshold
        self.confirm = max(1, confirm)
        self._candidate = None
        self._streak = 0

    def observe(self, per_chip):
        """Feed one probe's per-device table; returns the CONFIRMED
        straggler index or None."""
        candidate = detect_straggler(per_chip, self.threshold)
        if candidate is None or candidate != self._candidate:
            self._candidate = candidate
            self._streak = 1 if candidate is not None else 0
            confirmed = candidate is not None and self._streak >= self.confirm
            return candidate if confirmed else None
        self._streak += 1
        return candidate if self._streak >= self.confirm else None


def _spec_peaks(manager: Manager) -> tuple:
    """(peak_tflops, peak_hbm_gbps) upper bounds for this node's devices,
    from the spec row matching each device name (models/chips.py); 0.0
    components mean "unknown, no bound"."""
    from gpu_feature_discovery_tpu_torch.models.chips import spec_for

    peak_tf = peak_hbm = 0.0
    for chip in manager.get_chips():
        spec = spec_for(chip.get_name())
        if spec is not None:
            peak_tf = max(peak_tf, spec.peak_bf16_tflops)
            peak_hbm = max(peak_hbm, spec.peak_hbm_gbps)
    return peak_tf, peak_hbm


# How long a daemon labeling cycle waits for the FIRST probe before
# publishing without health labels. The first probe per process pays the
# first use of every kernel; steady-state probes finish far inside this
# budget and stay effectively synchronous.
FIRST_PROBE_WAIT_S = 2.0


class _FirstProbeThread(threading.Thread):
    """Carries the first probe off the labeling path. ``outcome`` is
    ``(report, error, probe_ms)`` once the probe finished — the inputs the
    synchronous path produces. ``abandoned`` marks a probe whose result
    must be DISCARDED (devices became unacquirable mid-flight)."""

    def __init__(self, measure, devices):
        super().__init__(name="tfd-burnin-first-probe", daemon=True)
        self._measure = measure
        self._devices = devices
        self.outcome = None
        self.abandoned = False

    def run(self):
        t0 = time.perf_counter()
        try:
            report, error = self._measure(devices=self._devices), None
        except Exception as e:  # noqa: BLE001 - delivered to the consumer
            log.debug("burn-in first probe failed:", exc_info=True)
            report, error = None, e
        self.outcome = (report, error, (time.perf_counter() - t0) * 1e3)


# At most ONE first probe in flight per process: a SIGHUP reload retires
# the schedule mid-probe, and a second thread would seize the devices
# beside the orphan. The new schedule ADOPTS a non-abandoned in-flight
# probe instead.
_first_probe_lock = threading.Lock()
_first_probe_inflight: "_FirstProbeThread | None" = None


class _BurninSchedule:
    """Every-Nth-cycle scheduling of the burn-in, one per Manager: the
    probe occupies every device, so cycles in between republish the
    cached labels."""

    def __init__(self):
        self.cycle = -1
        self.cached: Labels | None = None
        self.consecutive_failures = 0
        self.first_probe_thread: _FirstProbeThread | None = None
        self.straggler: StragglerDetector | None = None
        # Broker path only: True while the worker answered "warming" (the
        # next RPC collects a running probe, so no chip.<i>.* shots are
        # consumed for it), and the shots shipped with that probe, re-armed
        # if the worker dies before a collect returns.
        self.broker_probe_pending = False
        self.pending_chip_faults: tuple = (frozenset(), frozenset())

    def due(self, interval: int) -> bool:
        self.cycle += 1
        return self.cached is None or self.cycle % max(1, interval) == 0


_schedules: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _schedule_for(manager: Manager) -> _BurninSchedule:
    sched = _schedules.get(manager)
    if sched is None:
        sched = _BurninSchedule()
        _schedules[manager] = sched
    return sched


def reset_burnin_schedule() -> None:
    """Drop every manager's cached health labels and cycle counter (new
    config epoch, test isolation)."""
    _schedules.clear()


# Hermetic testing: how many CPU "devices" the TFD_BURNIN_ALLOW_CPU escape
# hatch probes (default 1), the analog of the twin's virtual XLA host
# devices, so per-device fault sites have more than one device to hit.
BURNIN_CPU_DEVICES_ENV = "TFD_BURNIN_CPU_DEVICES"


def _acquire_devices():
    """The local CUDA devices, or None when the probe cannot acquire any.
    ``TFD_BURNIN_ALLOW_CPU=1`` is the hermetic-testing escape hatch: with
    no CUDA device it probes the CPU instead (BURNIN_CPU_DEVICES_ENV
    times). Never set in production — a CPU matmul rate is not device
    health."""
    import torch

    if torch.cuda.is_available() and torch.cuda.device_count() > 0:
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if env_flag("TFD_BURNIN_ALLOW_CPU"):
        count = int(os.environ.get(BURNIN_CPU_DEVICES_ENV, "").strip() or 1)
        return [torch.device("cpu")] * max(1, count)
    return None


def new_health_labeler(manager: Manager, config: Config) -> Labeler:
    """Empty unless --with-burnin and the node actually has devices. The
    probe runs every --burnin-interval cycles; in between, the last
    measured labels are republished from cache."""
    global _first_probe_inflight
    if not config.flags.tfd.with_burnin:
        return Empty()
    if not manager.get_chips():
        return Empty()
    broker = getattr(manager, "broker", None)
    if broker is not None:
        # The probe runs in the broker worker, which holds the devices;
        # this process imports no torch for it.
        return _broker_health_labels(manager, broker, config)
    from gpu_feature_discovery_tpu_torch.ops.healthcheck import measure_node_health

    # Acquisition is checked EVERY cycle, so cached health labels never
    # outlive the devices being acquirable; only the probe is scheduled.
    sched = _schedule_for(manager)
    devices = _acquire_devices()
    if devices is None:
        warn_once(
            log,
            "health:unacquirable",
            "burn-in skipped: no local CUDA devices acquirable; publishing "
            "no health labels",
        )
        # Nothing measured before the gap survives it: the cache, the
        # failure and straggler streaks, and a pending first probe.
        sched.cached = None
        sched.consecutive_failures = 0
        sched.straggler = None
        if sched.first_probe_thread is not None:
            sched.first_probe_thread.abandoned = True
            sched.first_probe_thread = None
        return Empty()
    interval = config.flags.tfd.burnin_interval or 1
    if not sched.due(interval):
        # A cycle that ran no probe carries no probe-ms (stored stripped).
        log.debug("burn-in not due; republishing cached health labels")
        return sched.cached
    chip_probes, _ = _chip_probe_opts(config)

    def _armed_measure():
        """Bind this probing cycle's chip fault shots into the measure
        call, consumed at probe LAUNCH (never on a collect-only cycle)."""
        from gpu_feature_discovery_tpu_torch.utils import faults

        if chip_probes:
            sick, slow = faults.consume_chip_faults()
        else:
            sick, slow = frozenset(), frozenset()
        return functools.partial(
            measure_node_health, per_chip=chip_probes,
            sick_chips=sick, slow_chips=slow,
        )

    first_probe = sched.cached is None and sched.consecutive_failures == 0
    if first_probe and not config.flags.tfd.oneshot:
        with _first_probe_lock:
            thread = sched.first_probe_thread
            if thread is None:
                inflight = _first_probe_inflight
                if inflight is not None and inflight.is_alive():
                    if inflight.abandoned:
                        # An orphan still holds the devices; a second
                        # probe would double-seize them. Wait it out.
                        return Empty()
                    # e.g. after SIGHUP: adopt the running probe.
                    sched.first_probe_thread = thread = inflight
                else:
                    thread = _FirstProbeThread(_armed_measure(), devices)
                    sched.first_probe_thread = thread
                    _first_probe_inflight = thread
                    thread.start()
        thread.join(FIRST_PROBE_WAIT_S)
        outcome = thread.outcome
        if outcome is None:
            log.info(
                "burn-in first probe still running; publishing base labels "
                "without health this cycle"
            )
            return Empty()
        sched.first_probe_thread = None
        with _first_probe_lock:
            if _first_probe_inflight is thread:
                _first_probe_inflight = None
        report, error, probe_ms = outcome
    else:
        t0 = time.perf_counter()
        try:
            report, error = _armed_measure()(devices=devices), None
        except Exception as e:  # noqa: BLE001 - a failing device must not kill labeling
            log.debug("burn-in probe failed:", exc_info=True)
            report, error = None, e
        probe_ms = (time.perf_counter() - t0) * 1e3
    return _labels_from_probe(sched, manager, config, report, error, probe_ms)


def _chip_probe_opts(config: Config) -> tuple:
    """Resolve (--chip-probes, --straggler-threshold) with defaults."""
    tfd = config.flags.tfd
    chip = tfd.chip_probes if tfd.chip_probes is not None else True
    threshold = (
        tfd.straggler_threshold
        if tfd.straggler_threshold is not None
        else DEFAULT_STRAGGLER_THRESHOLD
    )
    return bool(chip), float(threshold)


def _mig_enabled(manager) -> bool:
    """Whether any GPU of the inventory is in MIG mode."""
    return manager is not None and any(
        chip.is_slice_enabled() for chip in manager.get_chips()
    )


def _rate_plausible(value, host_clock: bool, peak: float) -> bool:
    """Host-clock rates below 1 are dispatch distortion; rates above the
    spec peak x margin are timing artifacts."""
    if value is None:
        return False
    if host_clock and value < 1.0:
        return False
    if peak > 0.0 and value > peak * PLAUSIBILITY_MARGIN:
        return False
    return True


def _labels_from_probe(
    sched: _BurninSchedule,
    manager: Manager,
    config: Config,
    report,
    error,
    probe_ms: float,
) -> Labels:
    """One probe outcome → published labels + schedule/cache updates."""
    if error is not None:
        # Devices were acquired but the probe failed on them: health.ok=
        # false is the honest signal. A first failure is not cached (the
        # next cycle re-probes); a second consecutive one is.
        log.warning("burn-in failed on acquired devices: %s", error)
        sched.consecutive_failures += 1
        sched.straggler = None
        labels = Labels({HEALTH_OK: "false"})
        sched.cached = labels if sched.consecutive_failures >= 2 else None
        return labels
    log.debug(
        "burn-in probe timing=%s phases=%s probe_ms=%.3f",
        report.get("timing"),
        report.get("phases"),
        probe_ms,
    )
    compile_ms = (report.get("phases") or {}).get("compile_ms")
    if compile_ms:
        # Only a probe that paid first use reports a non-zero phase.
        obs_metrics.FIRST_PROBE_COMPILE.set(float(compile_ms) / 1e3)
    peak_tf, peak_hbm = _spec_peaks(manager)
    labels = Labels(
        {
            HEALTH_OK: str(report["healthy"]).lower(),
            HEALTH_PROBE_MS: str(int(probe_ms)),
        }
    )
    if report.get("timing"):
        labels[HEALTH_TIMING] = str(report["timing"])
    # The lower floors guard host-clock measurements only: a device-clock
    # rate cannot carry dispatch latency, and a degraded device crawling
    # below the floor is what the labels exist to surface.
    host_clock = report.get("timing") != "device-profiler"
    tflops = report["tflops"]
    if _rate_plausible(tflops, host_clock, peak_tf):
        labels[HEALTH_TFLOPS] = str(int(tflops))
    elif host_clock and tflops < 1.0:
        warn_once(
            log,
            "health:implausible-tflops-low",
            "implausible matmul rate %.3f TFLOP/s; omitting label",
            tflops,
        )
    else:
        warn_once(
            log,
            "health:implausible-tflops",
            "implausible matmul rate %.1f TFLOP/s (spec peak %.0f); "
            "omitting label",
            tflops,
            peak_tf,
        )
    hbm = report.get("hbm_gbps")
    if hbm is not None:
        if _rate_plausible(hbm, host_clock, peak_hbm):
            labels[HEALTH_HBM] = str(int(hbm))
        elif host_clock and hbm < 1.0:
            warn_once(
                log,
                "health:implausible-hbm",
                "implausible HBM bandwidth %.3f GiB/s; omitting label",
                hbm,
            )
        else:
            warn_once(
                log,
                "health:implausible-hbm-high",
                "implausible HBM bandwidth %.1f GiB/s (spec peak %.0f "
                "GB/s); omitting label",
                hbm,
                peak_hbm,
            )
    if report.get("ici_ok") is not None:
        labels[HEALTH_ICI] = str(report["ici_ok"]).lower()
    chip_probes, threshold = _chip_probe_opts(config)
    table = report.get("per_chip") or []
    if chip_probes and table:
        if _mig_enabled(manager):
            # The probe ran on the devices CUDA lists: under MIG the GPUs
            # outside MIG plus one MIG device, not the inventory's GPUs,
            # so a per-device label would contradict gpu.count.
            warn_once(
                log,
                "health:mig-per-device",
                "MIG is enabled on this node: the probe measures the %d "
                "device(s) CUDA lists, not the node's GPUs; publishing no "
                "per-device health labels",
                len(table),
            )
            sched.straggler = None
        else:
            healthy_n = sum(1 for e in table if e.get("healthy"))
            labels[CHIPS_HEALTHY] = str(healthy_n)
            labels[CHIPS_SICK] = str(len(table) - healthy_n)
            for i, e in enumerate(table):
                ok = bool(e.get("healthy"))
                labels[CHIP_OK_FMT % i] = "true" if ok else "false"
                obs_metrics.CHIP_OK.labels(chip=str(i)).set(1.0 if ok else 0.0)
                chip_tflops = e.get("tflops")
                if chip_tflops is not None:
                    # The metric carries the raw rate; the label is gated.
                    obs_metrics.CHIP_TFLOPS.labels(chip=str(i)).set(
                        float(chip_tflops)
                    )
                    if _rate_plausible(chip_tflops, host_clock, peak_tf):
                        labels[CHIP_TFLOPS_FMT % i] = str(int(chip_tflops))
                chip_hbm = e.get("hbm_gbps")
                if chip_hbm is not None and _rate_plausible(
                    chip_hbm, host_clock, peak_hbm
                ):
                    labels[CHIP_HBM_FMT % i] = str(int(chip_hbm))
            if sched.straggler is None or sched.straggler.threshold != threshold:
                sched.straggler = StragglerDetector(threshold)
            confirmed = sched.straggler.observe(table)
            if confirmed is not None:
                labels[STRAGGLER_CHIP] = str(confirmed)
                obs_metrics.STRAGGLER_DETECTED.inc()
                log.warning(
                    "straggler chip %d: throughput below %.2fx the median "
                    "for %d consecutive probes",
                    confirmed,
                    threshold,
                    sched.straggler.confirm,
                )
        ici_gbps = report.get("ici_gbps")
        if report.get("chips_allreduce_ok") is False:
            # A corrupt reduction's timing is not a bandwidth: suppress
            # the rate label (ici.ok=false already published the fault,
            # folded in by measure_node_health).
            log.warning(
                "device all-reduce verdict disagreed across devices; "
                "suppressing %s",
                HEALTH_ICI_GBPS,
            )
            ici_gbps = None
        if ici_gbps:
            labels[HEALTH_ICI_GBPS] = str(int(ici_gbps))
    sched.consecutive_failures = 0
    sched.cached = Labels(
        {k: v for k, v in labels.items() if k != HEALTH_PROBE_MS}
    )
    return labels


def _broker_health_labels(manager, broker, config: Config) -> Labeler:
    """The burn-in labeler when acquisition runs through the persistent
    broker: scheduling, caching and rendering stay in THIS process (the
    same _BurninSchedule and policy as the in-process path), the probe is
    one ``health`` RPC executed in the worker. The engine routes this
    source with cancel→kill (lm/gpu.py): a --labeler-timeout miss
    SIGKILLs the worker, which respawns on next use.

    One difference from the in-process path: acquirability is confirmed
    per PROBING cycle (an RPC), not per cycle; the per-cycle snapshot
    refresh already proves the worker live in between."""
    sched = _schedule_for(manager)
    interval = config.flags.tfd.burnin_interval or 1
    if not sched.due(interval):
        log.debug("burn-in not due; republishing cached health labels")
        return sched.cached
    chip_probes, _ = _chip_probe_opts(config)
    # chip.<i>.* shots are consumed HERE (this process owns the registry)
    # and shipped in the RPC, but only when this RPC may START a probe:
    # while the worker answers "warming", the next RPC collects the
    # running probe and must not burn shots it cannot deliver.
    from gpu_feature_discovery_tpu_torch.utils import faults

    sick, slow = (frozenset(), frozenset())
    if chip_probes and not sched.broker_probe_pending:
        sick, slow = faults.consume_chip_faults()
    # Everything in flight: this launch's shots plus those shipped with a
    # still-pending probe. A dead worker loses both alike.
    pend_sick, pend_slow = sched.pending_chip_faults
    sick_in_flight, slow_in_flight = sick | pend_sick, slow | pend_slow
    try:
        outcome = broker.health(
            per_chip=chip_probes,
            sick_chips=sorted(sick),
            slow_chips=sorted(slow),
        )
    except Exception:
        # The request died with the worker: the probe never published, so
        # the shots go back for the next launch; the respawned worker holds
        # no pending probe either.
        faults.rearm_chip_faults(sick_in_flight, slow_in_flight)
        sched.pending_chip_faults = (frozenset(), frozenset())
        sched.broker_probe_pending = False
        raise
    status = outcome.get("status")
    sched.broker_probe_pending = status == "warming"
    sched.pending_chip_faults = (
        (sick_in_flight, slow_in_flight)
        if status == "warming"
        else (frozenset(), frozenset())
    )
    if status == "unacquirable":
        # The worker launched no probe: re-arm everything in flight.
        faults.rearm_chip_faults(sick_in_flight, slow_in_flight)
        # As _acquire_devices returning None in process: nothing about
        # device health, publish nothing, drop the cache.
        warn_once(
            log,
            "health:unacquirable",
            "burn-in skipped: no local CUDA devices acquirable in the broker "
            "worker; publishing no health labels",
        )
        sched.cached = None
        sched.consecutive_failures = 0
        sched.straggler = None
        return Empty()
    if status == "warming":
        # The worker's probe (or its pre-warm) still runs: base labels
        # without health this cycle, collected on a later one (cached
        # stays None, so the next cycle re-asks).
        log.info(
            "burn-in probe still warming in the broker worker; publishing "
            "base labels without health this cycle"
        )
        return Empty()
    if outcome.get("prewarm_ms"):
        # The worker's pre-warm paid first use before its first probe.
        obs_metrics.FIRST_PROBE_COMPILE.set(float(outcome["prewarm_ms"]) / 1e3)
    probe_ms = float(outcome.get("probe_ms") or 0.0)
    if status == "probe-failed":
        return _labels_from_probe(
            sched, manager, config, None, outcome.get("error", ""), probe_ms
        )
    return _labels_from_probe(
        sched, manager, config, outcome.get("report") or {}, None, probe_ms
    )
