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
``<i>`` is the GPU's NVML index, the inventory's (``gpu.count``), joined
to the probed CUDA device by UUID; where CUDA lists other GPUs than the
inventory's (a subset), no per-device label is published.

With GPUs in MIG mode the node's verdict still covers every device the
inventory counts, as the twin's covers every chip: the plain GPUs are
probed as above, and each MIG device by a one-shot child pinned to it,
which frees the device when it exits (resource/probe_targets.py says
which index each verdict carries under each strategy). ``_fold`` joins
their reports: ``health.ok`` is ``all()`` over every probed device, the
rates are the worst plain GPU's (under a valid ``single``, the worst MIG
device's).
A multi-GPU node also publishes ``health.ici.ok`` (the ring sweep over
peer copies and NCCL) and, with --chip-probes, ``health.ici.allreduce-gbps``
(the timed NCCL all-reduce, GiB/s per device).
The keys are the twin's ``google.com/tpu.*`` keys under the one allowed
translation to ``nvidia.com/gpu.``.

The probe runs every ``--burnin-interval`` cycles; cycles in between
republish the cached labels without ``probe-ms``.

A device the probe cannot get memory on is busy, not sick: on a GPU the
daemon shares the device with the node's workloads, which may hold
almost all of its memory. A probe that fails for want of device memory
(ops/healthcheck.py ``is_busy_error``) takes the twin's unacquirable
branch on every path: no health label, the cache and the failure and
straggler streaks dropped, its fault shots given back. Any other
failure of the probe is ``health.ok=false``, as in the twin.

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
``tfd_chip_tflops{chip}`` beside the ``chip.<i>.*`` labels (with the
label's index), ``tfd_straggler_detected_total``, and
``tfd_timing_gate_total{outcome}`` from the report's
``phases.timing_gate_*`` (the multi-GPU all-reduce's gates).
"""

from __future__ import annotations

import functools
import logging
import os
import statistics
import threading
import time
import weakref
from typing import Dict, Optional

from gpu_feature_discovery_tpu_torch.config.flags import (
    DEFAULT_STRAGGLER_THRESHOLD,
    env_flag,
)
from gpu_feature_discovery_tpu_torch.config.spec import Config
from gpu_feature_discovery_tpu_torch.lm.labeler import Empty, Labeler
from gpu_feature_discovery_tpu_torch.lm.labels import Labels
from gpu_feature_discovery_tpu_torch.native import nvml
from gpu_feature_discovery_tpu_torch.obs import metrics as obs_metrics
from gpu_feature_discovery_tpu_torch.ops import timing_gate
from gpu_feature_discovery_tpu_torch.resource.types import Manager
from gpu_feature_discovery_tpu_torch.utils import timing
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
        self._span_ctx = timing.context()
        self.outcome = None
        self.abandoned = False

    def run(self):
        t0 = time.perf_counter()
        try:
            with timing.adopt(self._span_ctx):
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
        # MIG nodes through the broker: the round whose outcomes are being
        # collected; and a re-probe owed after a round in which a MIG
        # device's probe failed for the first time.
        self.mig_round: Optional[_MigRound] = None
        self.reprobe = False

    def due(self, interval: int) -> bool:
        self.cycle += 1
        reprobe, self.reprobe = self.reprobe, False
        return (
            self.cached is None
            or reprobe
            or self.mig_round is not None
            or self.cycle % max(1, interval) == 0
        )


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


def only_devices(devices, uuids) -> list:
    """The devices among ``devices`` whose UUID is one of ``uuids``: a
    MIG node's plain GPUs among those CUDA lists (a MIG device CUDA lists
    reports its own UUID or its parent GPU's, neither a plain GPU's)."""
    from gpu_feature_discovery_tpu_torch.ops.healthcheck import device_uuids

    keep = {nvml.normalize_uuid(u) for u in uuids} - {""}
    return [d for d, u in zip(devices, device_uuids(devices)) if u in keep]


def pinned_devices():
    """The one device of a process pinned to a MIG device (its
    ``CUDA_VISIBLE_DEVICES`` names the device's UUID), or None when it
    has none. Raises when CUDA lists more than one: the pin did not
    hold."""
    from gpu_feature_discovery_tpu_torch.resource.types import ResourceError

    devices = _acquire_devices()
    if devices is None:
        return None
    if devices[0].type == "cuda" and len(devices) != 1:
        raise ResourceError(
            f"a process pinned to one MIG device sees {len(devices)} CUDA devices"
        )
    return devices[:1]


def _targets(manager: Manager, config: Config):
    """The node's MIG probe plan (resource/probe_targets.py), or None
    when no GPU is in MIG mode."""
    from gpu_feature_discovery_tpu_torch.resource.probe_targets import probe_targets

    return probe_targets(manager, config.flags.tpu_topology_strategy)


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
    from gpu_feature_discovery_tpu_torch.ops.healthcheck import (
        is_busy_error,
        measure_node_health,
        release_probe_memory,
    )

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
        return _forget_health(sched)
    targets = _targets(manager, config)
    if targets is not None:
        # Each MIG device is probed in a child pinned to it; this process
        # probes the plain GPUs alone.
        devices = only_devices(devices, targets.plain_uuids)
        if targets.plain and not devices:
            _warn_plain_unlisted(targets)
            return _forget_health(sched)
        if not targets.plain and not targets.mig:
            return _nothing_to_probe(sched)
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
        if targets is not None:
            measure = functools.partial(
                _measure_mig_node, targets, config, chip_probes, sick, slow
            )
        else:
            measure = functools.partial(
                measure_node_health, per_chip=chip_probes,
                sick_chips=sick, slow_chips=slow, **_inventory_kwargs(manager),
            )

        def armed(devices):
            try:
                return measure(devices=devices)
            except Exception as e:
                if is_busy_error(e):
                    # Nothing of a busy probe is published: its shots go back.
                    faults.rearm_chip_faults(sick, slow)
                raise

        return armed

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
    if error is not None and is_busy_error(error):
        if targets is None:
            # This process's own probe could not get memory: drop what
            # the attempt allocated (_measure_mig_node drops its own).
            release_probe_memory(error)
        return _busy(sched, error)
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


def _forget_health(sched: _BurninSchedule) -> Labeler:
    """No health labels this cycle, and nothing measured before the gap
    survives it: the cache, the failure and straggler streaks, and a
    pending first probe."""
    sched.cached = None
    sched.consecutive_failures = 0
    sched.straggler = None
    if sched.first_probe_thread is not None:
        sched.first_probe_thread.abandoned = True
        sched.first_probe_thread = None
    return Empty()


def _warn_plain_unlisted(targets) -> None:
    """A MIG node whose GPUs outside MIG mode CUDA does not list: their
    verdict is unknown, so no verdict speaks for the node."""
    warn_once(
        log, "health:plain-unacquirable",
        "burn-in skipped: none of the node's %d GPU(s) outside MIG mode is "
        "acquirable; publishing no health labels", len(targets.plain),
    )


def _busy(sched: _BurninSchedule, error) -> Labeler:
    """A probe that could not get device memory: the device is busy, not
    sick. The twin's unacquirable branch: no health labels, and nothing
    measured before the gap survives it."""
    text = str(error).strip()
    warn_once(
        log, "health:busy",
        "burn-in skipped: a device is busy, the probe could not get its memory "
        "(%s); publishing no health labels", text.splitlines()[0] if text else "",
    )
    return _forget_health(sched)


def _nothing_to_probe(sched: _BurninSchedule) -> Labeler:
    """A MIG node with neither a plain GPU nor a MIG device: no health."""
    warn_once(
        log, "health:nothing-to-probe",
        "every GPU is in MIG mode and none exposes a MIG device; publishing "
        "no health labels",
    )
    return _forget_health(sched)


def _probe_mig_in_child(target, config: Config, request: dict, pid_box=None) -> dict:
    """One probe of one MIG device in a one-shot child pinned to it
    (sandbox/probe.py ``run_probe``, the ``health`` op): one process
    cannot open a second MIG device, and the child frees the device when
    it exits. The outcome in the broker's shape: ``unacquirable`` when
    the child could not get device memory (busy), ``probe-failed`` for
    any other failure. The child's pid lands in ``pid_box`` at its
    spawn."""
    from gpu_feature_discovery_tpu_torch.config.flags import DEFAULT_PROBE_TIMEOUT
    from gpu_feature_discovery_tpu_torch.sandbox.probe import run_probe

    timeout = config.flags.tfd.probe_timeout
    result = run_probe(
        "health", config,
        timeout if timeout is not None else DEFAULT_PROBE_TIMEOUT,
        pid_box=pid_box, pin=target.uuid, request=request,
    )
    if result.status == "ok":
        return {"status": "ok", "report": result.payload,
                "probe_ms": result.duration_s * 1e3}
    if result.status == "busy":
        return {"status": "unacquirable", "error": result.error}
    detail = result.error or (
        f"signal {result.term_signal}" if result.term_signal else result.stderr_tail[-200:]
    )
    return {"status": "probe-failed", "error": f"{result.status}: {detail}"}


def _mig_request(per_chip: bool, shots) -> dict:
    """A MIG probe's options: its fault shots land on its one device."""
    sick, slow = shots
    return {"per_chip": per_chip, "sick_chips": [0] if sick else [],
            "slow_chips": [0] if slow else []}


def _start_mig_probes(targets, config: Config, per_chip: bool, shots: dict,
                      outcomes: Dict[str, dict], pids: list) -> list:
    """Probe every MIG device of ``targets`` at once, each in its one-shot
    pinned child on a thread started here: the device's fault ``shots``
    (by its key) ride the request, its outcome lands in ``outcomes`` by
    its key, its child's pid in ``pids``. The threads, which the caller
    owns: both MIG paths probe so, in process waiting for them, through
    the broker collecting them over cycles (``_MigRound``)."""
    no_shots = (frozenset(), frozenset())

    def probe(target):
        try:
            if not target.uuid:
                raise RuntimeError("the MIG device has no UUID")
            outcome = _probe_mig_in_child(
                target, config, _mig_request(per_chip, shots.get(target.key, no_shots)),
                pids,
            )
        except Exception as e:  # noqa: BLE001 - this device's verdict only
            outcome = {"status": "probe-failed", "error": str(e)}
        outcomes[target.key] = outcome

    threads = [threading.Thread(target=probe, args=(t,), daemon=True,
                                name="tfd-mig-probe") for t in targets.mig]
    for thread in threads:
        thread.start()
    return threads


def _busy_devices(targets, outcomes: Dict[str, dict]) -> list:
    """The MIG devices whose probe could not get device memory, each as
    ``uuid: error``."""
    return [f"{t.uuid}: {outcomes[t.key].get('error', '')}" for t in targets.mig
            if (outcomes.get(t.key) or {}).get("status") == "unacquirable"]


def _measure_mig_node(targets, config: Config, per_chip: bool, sick, slow,
                      devices=None) -> dict:
    """The in-process probe of a MIG node: ``devices`` (its plain GPUs)
    in this process and every MIG device in a pinned child, all at once;
    the folded report. A failure of the classic probe raises, as the
    probe of a node without MIG does, and so does a busy MIG device
    (DeviceBusy): its verdict is unknown, so none speaks for the node.
    A busy device wins over a failure of the plain GPUs' probe, as on the
    broker path (``_broker_mig_round``)."""
    from gpu_feature_discovery_tpu_torch.ops.healthcheck import (
        DeviceBusy,
        is_busy_error,
        measure_node_health,
        release_probe_memory,
    )

    (c_sick, c_slow), mig_shots = targets.route_faults(sick, slow)
    outcomes: Dict[str, dict] = {}
    threads = _start_mig_probes(targets, config, per_chip, mig_shots, outcomes, [])
    classic = error = None
    try:
        if devices:
            classic = measure_node_health(
                devices=devices, per_chip=per_chip, sick_chips=c_sick,
                slow_chips=c_slow, inventory_uuids=targets.gpu_uuids,
            )
    except Exception as e:  # noqa: BLE001 - raised below, after the busy check
        error = e
    finally:
        for thread in threads:
            thread.join()
    if error is not None and is_busy_error(error):
        # This process's own probe could not get memory.
        release_probe_memory(error)
        raise error
    busy = _busy_devices(targets, outcomes)
    if busy:
        raise DeviceBusy(f"MIG device(s) busy: {'; '.join(busy)}") from error
    if error is not None:
        raise error
    return _fold(targets, classic, outcomes)


_UNRATED = {"tflops": None, "tflops_best": None, "hbm_gbps": None}


def _fold(targets, classic, outcomes: Dict[str, dict]) -> dict:
    """One report for the whole MIG node, by the table of
    resource/probe_targets.py: ``classic`` is the plain GPUs' report
    (None when none was probed), ``outcomes`` each MIG device's probe
    outcome by its key. ``per_chip`` entries carry their label ``index``
    (``indexed``); a MIG device whose probe failed is unhealthy and
    unrated, and counts in ``failed``."""
    mig = []
    failed = 0
    for t in targets.mig:
        outcome = outcomes.get(t.key) or {}
        report = outcome.get("report") if outcome.get("status") == "ok" else None
        if report is None:
            failed += 1
            log.warning("burn-in of MIG device %s (GPU %d) failed: %s", t.uuid,
                        t.gpu, outcome.get("error") or outcome.get("status"))
            mig.append((t, {"healthy": False, **_UNRATED}, None))
            continue
        entry = (report.get("per_chip") or [{}])[0]
        mig.append((t, {
            "healthy": bool(report["healthy"]) and bool(entry.get("healthy", True)),
            "tflops": entry.get("tflops"),
            "tflops_best": entry.get("tflops_best"),
            "hbm_gbps": entry.get("hbm_gbps"),
        }, report))
    reports = [r for r in [classic] + [r for _, _, r in mig] if r is not None]
    folded = {
        "healthy": all(e["healthy"] for _, e, _ in mig)
        and (classic is None or bool(classic["healthy"])),
        "timing": next((r["timing"] for r in reports if r.get("timing")), None),
        "phases": dict((reports[0].get("phases") or {}) if reports else {}),
        "ici_ok": classic.get("ici_ok") if classic else None,
        "indexed": True,
        "failed": failed,
    }
    for key in ("ici_gbps", "chips_allreduce_ok"):
        if classic and key in classic:
            folded[key] = classic[key]
    if targets.per_mig_device:
        entries = [dict(e, index=t.index) for t, e, _ in mig]
        rates = [e["tflops"] for e in entries if e["tflops"] is not None]
        hbm = [e["hbm_gbps"] for e in entries]
        folded["tflops"] = min(rates) if rates else None
        folded["hbm_gbps"] = min(hbm) if hbm and None not in hbm else None
    else:
        folded["tflops"] = classic["tflops"] if classic else None
        folded["hbm_gbps"] = classic.get("hbm_gbps") if classic else None
        entries = _plain_entries(targets, classic)
        by_gpu: Dict[int, list] = {}
        for t, e, _ in mig:
            by_gpu.setdefault(t.gpu, []).append(e["healthy"])
        if entries is not None:
            entries += [{"index": gpu, "healthy": all(oks), **_UNRATED}
                        for gpu, oks in by_gpu.items()]
            entries.sort(key=lambda e: e["index"])
    if not targets.per_device:
        warn_once(
            log, "health:mig-invalid-single",
            "topology strategy single is invalid on this node (%s); "
            "publishing no per-device health labels", targets.problem,
        )
        entries = []
    elif entries is None:
        warn_once(
            log, "health:unjoined-plain",
            "CUDA lists %d device(s) that are not the node's %d GPU(s) "
            "outside MIG one to one by UUID; publishing no per-device health "
            "labels", len((classic or {}).get("per_chip") or []), len(targets.plain),
        )
        entries = []
    folded["per_chip"] = entries
    return folded


def _plain_entries(targets, classic) -> Optional[list]:
    """The classic report's entries, each with its GPU's NVML index; None
    when they are not the node's plain GPUs one to one."""
    table = (classic or {}).get("per_chip") or []
    if len(table) != len(targets.plain):
        return None
    where = nvml.inventory_positions(targets.gpu_uuids, [e.get("uuid") for e in table])
    if where is None:
        where = dict(zip(targets.plain, range(len(table))))
    if sorted(where) != sorted(targets.plain):
        return None
    return [dict(table[pos], index=i) for i, pos in where.items()]


def _inventory_kwargs(manager) -> dict:
    """The inventory's GPU UUIDs for the probe, in NVML's order, so its
    fault indices name the GPUs the labels name; nothing for an inventory
    without UUIDs."""
    uuids = [chip.get_uuid() for chip in manager.get_chips()]
    return {"inventory_uuids": uuids} if any(uuids) else {}


def _label_indices(manager, table):
    """The label index of each probed device: its NVML index, joined by
    UUID (CUDA's ordinal may differ: ``CUDA_VISIBLE_DEVICES``,
    ``CUDA_DEVICE_ORDER``); the position itself for an inventory without
    UUIDs. None when CUDA lists other GPUs than the inventory's or a
    device does not join: a label keyed by either index could then name
    the wrong GPU or contradict ``gpu.count``."""
    chips = manager.get_chips() if manager is not None else []
    where = nvml.inventory_positions(
        [chip.get_uuid() for chip in chips], [e.get("uuid") for e in table]
    )
    if where is None:
        return list(range(len(table)))
    if len(where) != len(chips) or len(table) != len(chips):
        return None
    index_at = {pos: i for i, pos in where.items()}
    return [index_at[pos] for pos in range(len(table))]


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
    phases = report.get("phases") or {}
    compile_ms = phases.get("compile_ms")
    if compile_ms:
        # Only a probe that paid first use reports a non-zero phase.
        obs_metrics.FIRST_PROBE_COMPILE.set(float(compile_ms) / 1e3)
    for outcome in timing_gate.OUTCOMES:
        # The all-reduce's timing gates since the last report, per device.
        gates = phases.get(f"timing_gate_{outcome}")
        if gates:
            obs_metrics.TIMING_GATE.labels(outcome=outcome).inc(gates)
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
    if tflops is None:
        pass  # a MIG node with no plain GPU: no GPU's rate to publish
    elif _rate_plausible(tflops, host_clock, peak_tf):
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
        if report.get("indexed"):
            indices = [e["index"] for e in table]
        else:
            indices = _label_indices(manager, table)
        if indices is None:
            warn_once(
                log,
                "health:unjoined-per-device",
                "CUDA lists %d device(s) that are not the node's %d GPU(s) "
                "one to one by UUID; publishing no per-device health labels",
                len(table),
                len(manager.get_chips()),
            )
            sched.straggler = None
        else:
            healthy_n = sum(1 for e in table if e.get("healthy"))
            labels[CHIPS_HEALTHY] = str(healthy_n)
            labels[CHIPS_SICK] = str(len(table) - healthy_n)
            for i, e in zip(indices, table):
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
            # The detector counts probe positions, stable across probes.
            confirmed = sched.straggler.observe(table)
            if confirmed is not None:
                confirmed = indices[confirmed]
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
    if report.get("failed"):
        # A MIG device's probe failed: its verdict is false this round, and
        # as after a failed probe the next cycle probes again, unless the
        # failure repeats.
        sched.consecutive_failures += 1
        sched.reprobe = sched.consecutive_failures < 2
    else:
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
    targets = _targets(manager, config)
    if targets is not None:
        return _broker_mig_round(sched, manager, broker, config, targets)
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
            **_inventory_kwargs(manager),
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
        # The worker launched no probe, or its probe could not get device
        # memory: re-arm everything in flight. As _acquire_devices
        # returning None in process: nothing about device health, publish
        # nothing, drop the cache.
        faults.rearm_chip_faults(sick_in_flight, slow_in_flight)
        if outcome.get("error"):
            return _busy(sched, outcome["error"])
        warn_once(
            log,
            "health:unacquirable",
            "burn-in skipped: no local CUDA devices acquirable in the broker "
            "worker; publishing no health labels",
        )
        return _forget_health(sched)
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


class _MigRound:
    """One probing round of a MIG node through the broker: the fault
    shots routed at its start, by probe (``"classic"`` for the plain
    GPUs' worker, a MIG target's key for its child), each probe's outcome
    as it comes, and the MIG devices' one-shot pinned children, started
    once with the round on threads it owns (``start``)."""

    def __init__(self, targets, sick, slow):
        self.targets = targets
        classic, mig = targets.route_faults(sick, slow)
        self.shots = dict(mig, classic=classic)
        self.outcomes: Dict[str, dict] = {}
        self.classic_asked = False
        # Set by the cancel hook: the round is over, its outcomes unused.
        self.cancelled = False
        self.pids: list = []
        self._threads: list = []
        self._given_back: set = set()

    def start(self, config: Config, per_chip: bool) -> None:
        self._threads = _start_mig_probes(
            self.targets, config, per_chip, self.shots, self.outcomes, self.pids
        )

    def wait(self, deadline: float) -> None:
        """Wait for the children until ``deadline`` (monotonic)."""
        for thread in self._threads:
            thread.join(max(0.0, deadline - time.monotonic()))

    def give_back(self, keys=None) -> None:
        """Re-arm the fault shots of the probes ``keys`` (None: every
        probe's), each at most once: shots that no published verdict
        enacted."""
        from gpu_feature_discovery_tpu_torch.utils import faults

        for key in self.shots if keys is None else keys:
            if key in self.shots and key not in self._given_back:
                self._given_back.add(key)
                faults.rearm_chip_faults(*self.shots[key])

    def kill(self) -> None:
        """SIGKILL the running children (the health source's cancel
        hook): the round is over, and the next cycle starts another."""
        from gpu_feature_discovery_tpu_torch.sandbox.probe import kill_if_live

        self.cancelled = True
        for pid in list(self.pids):
            kill_if_live(pid)

    def drop(self) -> None:
        """End the round unpublished: its children killed, every shot
        given back."""
        self.kill()
        self.give_back()


def cancel_mig_round(manager: Manager) -> None:
    """Kill the running children of ``manager``'s MIG round, if any (the
    broker-routed health source's cancel hook, lm/gpu.py)."""
    sched = _schedules.get(manager)
    rnd = sched.mig_round if sched is not None else None
    if rnd is not None:
        rnd.kill()


def _broker_mig_round(sched, manager, broker, config: Config, targets) -> Labeler:
    """The broker path on a MIG node: the classic worker probes the plain
    GPUs, and each MIG device is probed in a one-shot pinned child, as in
    process, all at once. The children run in the background: a round's
    outcomes are collected over cycles until every probe has one, each
    cycle waiting for them no longer than the worker's health wait;
    meanwhile the last round's labels stand (none before the first). A
    child that dies or hangs is its own device's failed verdict; a busy
    device leaves the round without a verdict; the classic worker's
    death fails the cycle, as on a node without MIG."""
    from gpu_feature_discovery_tpu_torch.sandbox import broker as broker_mod
    from gpu_feature_discovery_tpu_torch.utils import faults

    if not targets.plain and not targets.mig:
        return _nothing_to_probe(sched)
    chip_probes, _ = _chip_probe_opts(config)
    rnd = sched.mig_round
    if rnd is not None and (rnd.cancelled or rnd.targets != targets):
        rnd.drop()
        rnd = sched.mig_round = None
    if rnd is None:
        sick, slow = faults.consume_chip_faults() if chip_probes else (frozenset(), frozenset())
        rnd = sched.mig_round = _MigRound(targets, sick, slow)
        rnd.start(config, chip_probes)
    deadline = time.monotonic() + broker_mod.HEALTH_WAIT_S
    if targets.plain and "classic" not in rnd.outcomes:
        shots = (frozenset(), frozenset()) if rnd.classic_asked else rnd.shots["classic"]
        rnd.classic_asked = True
        try:
            outcome = broker.health(
                per_chip=chip_probes, sick_chips=sorted(shots[0]),
                slow_chips=sorted(shots[1]), inventory_uuids=targets.gpu_uuids,
            )
        except Exception:
            # The request died with the worker: the round ends unpublished.
            rnd.drop()
            sched.mig_round = None
            raise
        if outcome.get("status") != "warming":
            rnd.outcomes["classic"] = outcome
    classic = rnd.outcomes.get("classic")
    if classic is not None and classic.get("status") == "unacquirable":
        # As on a node without MIG: the plain GPUs' verdict is unknown, so
        # no verdict speaks for the node.
        rnd.drop()
        sched.mig_round = None
        if classic.get("error"):
            return _busy(sched, classic["error"])
        _warn_plain_unlisted(targets)
        return _forget_health(sched)
    rnd.wait(deadline)
    missing = [k for k in [t.key for t in targets.mig] + (["classic"] if targets.plain else [])
               if k not in rnd.outcomes]
    if missing:
        log.info(
            "burn-in of %d of %d MIG node probe(s) still running; republishing "
            "the last round's health labels", len(missing),
            len(targets.mig) + bool(targets.plain),
        )
        return sched.cached if sched.cached is not None else Empty()
    sched.mig_round = None
    busy = _busy_devices(targets, rnd.outcomes)
    if busy:
        # A busy device's verdict is unknown, so none speaks for the node.
        rnd.give_back()
        return _busy(sched, f"MIG device(s) busy: {'; '.join(busy)}")
    # A failed probe enacted nothing that will be published.
    rnd.give_back([t.key for t in targets.mig if rnd.outcomes[t.key].get("status") != "ok"])
    probe_ms = max(float(o.get("probe_ms") or 0.0) for o in rnd.outcomes.values())
    if classic is not None and classic.get("prewarm_ms"):
        obs_metrics.FIRST_PROBE_COMPILE.set(float(classic["prewarm_ms"]) / 1e3)
    if classic is not None and classic.get("status") == "probe-failed":
        return _labels_from_probe(
            sched, manager, config, None, classic.get("error", ""), probe_ms
        )
    report = _fold(
        targets,
        classic.get("report") if classic and classic.get("status") == "ok" else None,
        rnd.outcomes,
    )
    return _labels_from_probe(sched, manager, config, report, None, probe_ms)
