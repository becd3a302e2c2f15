"""Fault-tolerant daemon supervisor (twin:
``gpu_feature_discovery_tpu/cmd/supervisor.py``).

It makes the unhealthy paths of the daemon survivable, per cycle,
without hiding genuine brokenness:

1. **Backend init retry** (``acquire_manager``): one init attempt per
   labeling cycle, spaced by jittered exponential backoff
   (``--init-backoff-max`` caps it). While the backend is down the daemon
   publishes DEGRADED labels — the non-device sources
   (lm/labelers.degraded_label_sources) plus
   ``nvidia.com/gpu.tfd.degraded=true``. After ``--init-retries``
   consecutive failures, ``--fail-on-init-error=true`` escalates to an
   exit; ``false`` stays degraded and keeps retrying at the capped
   cadence.
2. **Per-cycle containment** (``cycle_failed``): an exception escaping
   the engine or the write marks the cycle failed; the run loop
   re-serves the last-good labels with
   ``nvidia.com/gpu.tfd.unhealthy-cycles=<n>`` and retries after a capped
   backoff. ``--max-consecutive-failures`` bounds containment.
3. **Heartbeat** (``touch_heartbeat``): ``--heartbeat-file``'s mtime is
   touched after every completed cycle, degraded ones included, so an
   exec livenessProbe restarts only a wedged pod.
4. **Restored state** (``--state-dir``, sandbox/state.py): a restart
   re-serves the previous run's labels first.

A sick device is a measurement, not a daemon fault: the health labeler
publishes ``chip.<i>.ok=false`` inside a normally completing cycle, and
none of this fires. Oneshot bypasses all of it. Actuation advice
(actuation/engine.py) rides the last-good cache like any label, but only
while its lease holds: the restore, the restored overlay and the
failed-cycle re-serve each drop advice whose lease has lapsed.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Callable, Optional

from gpu_feature_discovery_tpu_torch.actuation.engine import drop_lapsed_advice
from gpu_feature_discovery_tpu_torch.config.flags import (
    DEFAULT_INIT_BACKOFF_MAX,
    DEFAULT_INIT_RETRIES,
    DEFAULT_MAX_CONSECUTIVE_FAILURES,
)
from gpu_feature_discovery_tpu_torch.config.spec import Config
from gpu_feature_discovery_tpu_torch.lm.engine import STALE_SOURCES_LABEL
from gpu_feature_discovery_tpu_torch.lm.labels import Labels
from gpu_feature_discovery_tpu_torch.obs import metrics as obs_metrics
from gpu_feature_discovery_tpu_torch.resource.types import Manager
from gpu_feature_discovery_tpu_torch.sandbox.flap import FLAPPING_LABEL
from gpu_feature_discovery_tpu_torch.sandbox.state import LabelStateStore
from gpu_feature_discovery_tpu_torch.utils.retry import BackoffPolicy

log = logging.getLogger("tfd.supervisor")

# The gpu family's degraded marker, the twin's
# FAMILY_DEGRADED_LABELS["gpu"] (lm/pjrt_family.py): published while the
# backend cannot init, cleared by absence when it recovers.
DEGRADED_LABEL = "nvidia.com/gpu.tfd.degraded"
# Consecutive failed cycles while last-good labels are re-served.
UNHEALTHY_CYCLES_LABEL = "nvidia.com/gpu.tfd.unhealthy-cycles"
# The published labels are restored state from a previous run.
RESTORED_LABEL = "nvidia.com/gpu.tfd.restored"

# Backoff base for init re-attempts and failed-cycle retries; the cap
# comes from --init-backoff-max.
BACKOFF_BASE_S = 1.0


class InitRetriesExhausted(RuntimeError):
    """--init-retries consecutive init failures under
    --fail-on-init-error=true; ``__cause__`` carries the last error."""


class TooManyConsecutiveFailures(RuntimeError):
    """--max-consecutive-failures cycles failed in a row."""


class Supervisor:
    """Cross-cycle supervision state for one config epoch. The run loop
    (cmd/main.run) drives it; it never sleeps or reads the signal queue —
    waits stay in the loop where signals are serviced."""

    def __init__(
        self,
        config: Config,
        clock: Callable[[], float] = time.monotonic,
    ):
        tfd = config.flags.tfd
        self._init_retries = (
            tfd.init_retries if tfd.init_retries is not None else DEFAULT_INIT_RETRIES
        )
        backoff_cap = (
            tfd.init_backoff_max
            if tfd.init_backoff_max is not None
            else DEFAULT_INIT_BACKOFF_MAX
        )
        self._max_failures = (
            tfd.max_consecutive_failures
            if tfd.max_consecutive_failures is not None
            else DEFAULT_MAX_CONSECUTIVE_FAILURES
        )
        self._fail_on_init_error = bool(tfd.fail_on_init_error)
        self._heartbeat_file = tfd.heartbeat_file or ""
        # The base stays under the cap, or delay(0) would exceed it.
        self._policy = BackoffPolicy(
            base=min(BACKOFF_BASE_S, backoff_cap), cap=backoff_cap
        )
        self._clock = clock
        self._init_failures = 0
        self._next_init_attempt = 0.0
        self._consecutive_failures = 0
        self._last_good: Optional[Labels] = None
        self._heartbeat_warned = False
        self._state_store: Optional[LabelStateStore] = (
            LabelStateStore(tfd.state_dir) if tfd.state_dir else None
        )
        self._restored = False
        # The epoch's gauges read 0 from its first scrape, not "absent".
        obs_metrics.DEGRADED.set(0)
        obs_metrics.CONSECUTIVE_CYCLE_FAILURES.set(0)
        obs_metrics.BACKEND_INIT_BACKOFF.set(0)
        obs_metrics.RESTORED.set(0)
        obs_metrics.FLAPPING.set(0)

    # -- backend init -----------------------------------------------------

    def acquire_manager(self, build: Callable[[], Manager]) -> Optional[Manager]:
        """One bounded init attempt: the manager on success; None while
        the backoff window is closed or the attempt failed (the cycle then
        runs degraded); InitRetriesExhausted when the budget is spent
        under --fail-on-init-error."""
        now = self._clock()
        if now < self._next_init_attempt:
            return None
        try:
            manager = build()
        except Exception as e:  # noqa: BLE001 - supervision boundary
            self._init_failures += 1
            obs_metrics.BACKEND_INIT_FAILURES.inc()
            obs_metrics.DEGRADED.set(1)
            log.warning(
                "backend init attempt %d/%s failed: %s",
                self._init_failures,
                self._init_retries if self._fail_on_init_error else "inf",
                e,
            )
            log.debug("backend init traceback:", exc_info=True)
            if self._fail_on_init_error and self._init_failures >= self._init_retries:
                raise InitRetriesExhausted(
                    f"backend init failed {self._init_failures} consecutive "
                    f"times (--init-retries={self._init_retries}); last: {e}"
                ) from e
            # Past the budget without fail-fast: retry forever at the
            # capped cadence.
            delay = self._policy.delay(min(self._init_failures - 1, 63))
            self._next_init_attempt = now + delay
            obs_metrics.BACKEND_INIT_BACKOFF.set(delay)
            log.info("staying degraded; next backend init attempt in %.3fs", delay)
            return None
        if self._init_failures:
            obs_metrics.BACKEND_INIT_RECOVERIES.inc()
            log.info("backend init recovered after %d failed attempts",
                     self._init_failures)
        self._init_failures = 0
        self._next_init_attempt = 0.0
        obs_metrics.DEGRADED.set(0)
        obs_metrics.BACKEND_INIT_BACKOFF.set(0)
        return manager

    @property
    def degraded(self) -> bool:
        """True while the backend has failed init and not yet recovered."""
        return self._init_failures > 0

    # -- restored last-good state (--state-dir) ---------------------------

    def restore_last_good(self) -> Optional[Labels]:
        """Load the previous run's label set, prime the last-good cache
        with it and enter the restored regime. Returns the cleaned set
        the epoch should publish (the caller adds the marker and writes),
        or None when there is no usable state."""
        if self._state_store is None:
            return None
        restored = self._state_store.load()
        if restored is None:
            return None
        # Lapsed advice must not resurrect across a restart: a killed
        # daemon's cordon advice outliving its lease in the state file is
        # the frozen cordon the lease exists to prevent. Still-leased
        # advice is restored under its ORIGINAL stamp.
        cleaned = drop_lapsed_advice(self._strip_markers(restored))
        if not cleaned:
            return None
        self._last_good = cleaned
        self._restored = True
        obs_metrics.STATE_RESTORES.inc()
        obs_metrics.RESTORED.set(1)
        log.info(
            "restored %d last-good labels from %s; serving them with %s=true "
            "until the first live cycle",
            len(cleaned),
            self._state_store.path,
            RESTORED_LABEL,
        )
        return Labels(cleaned)

    @property
    def restored(self) -> bool:
        return self._restored

    def with_restored(self, labels: Labels) -> Labels:
        """Overlay a degraded cycle's fresh labels onto the restored
        inventory: fresh facts win key by key, the restored device facts
        stay published, and the marker says so."""
        if not self._restored or self._last_good is None:
            return labels
        merged = Labels(self._last_good)
        merged.update(labels)
        # Restored advice rides the overlay only while its lease holds: a
        # cycle that measured nothing never refreshes it.
        merged = drop_lapsed_advice(merged)
        merged[RESTORED_LABEL] = "true"
        return merged

    # -- per-cycle containment --------------------------------------------

    @staticmethod
    def _strip_markers(labels: Labels) -> Labels:
        """Drop every status marker: a remembered copy re-applies only
        what is true at re-serve time."""
        from gpu_feature_discovery_tpu_torch.lm.pjrt_family import FAMILY_DEGRADED_LABELS

        cleaned = Labels(labels)
        for marker in (
            UNHEALTHY_CYCLES_LABEL,
            DEGRADED_LABEL,
            RESTORED_LABEL,
            STALE_SOURCES_LABEL,
            FLAPPING_LABEL,
            # The registry cycle's per-family markers: one cycle's truth.
            *FAMILY_DEGRADED_LABELS.values(),
        ):
            cleaned.pop(marker, None)
        return cleaned

    def cycle_succeeded(self, labels: Labels, mode: str = "full") -> None:
        """A cycle generated AND wrote labels: reset the failure streak and
        remember the marker-stripped output. A clean full cycle also ends
        the restored regime and persists the set to --state-dir. Degraded
        cycles persist nothing, nor does a full cycle with stale sources
        (a deadline-missed source may have served an empty set)."""
        self._consecutive_failures = 0
        obs_metrics.CONSECUTIVE_CYCLE_FAILURES.set(0)
        stale = STALE_SOURCES_LABEL in labels
        remembered = self._strip_markers(labels)
        self._last_good = remembered
        if mode != "full" or stale:
            return
        if self._restored:
            self._restored = False
            obs_metrics.RESTORED.set(0)
            log.info("first live full cycle completed; %s cleared", RESTORED_LABEL)
        from gpu_feature_discovery_tpu_torch.lm.pjrt_family import FAMILY_COUNT_KEYS

        if self._state_store is not None and any(
            key in remembered for key in FAMILY_COUNT_KEYS.values()
        ):
            # Only a set that inventories a device family is persisted: a
            # device-less "full" set must never clobber an inventory.
            self._state_store.save(remembered)

    def cycle_failed(self, error: BaseException) -> float:
        """Contain one cycle failure: the capped backoff delay the loop
        should wait; TooManyConsecutiveFailures at the bound."""
        self._consecutive_failures += 1
        n = self._consecutive_failures
        obs_metrics.CYCLES_TOTAL.labels(outcome="failed").inc()
        obs_metrics.CONSECUTIVE_CYCLE_FAILURES.set(n)
        log.error("labeling cycle failed (%d consecutive, bound %d): %s",
                  n, self._max_failures, error)
        log.debug("cycle failure traceback:", exc_info=True)
        if n >= self._max_failures:
            raise TooManyConsecutiveFailures(
                f"{n} consecutive labeling cycles failed "
                f"(--max-consecutive-failures={self._max_failures}); last: {error}"
            ) from error
        return self._policy.delay(n - 1)

    @property
    def consecutive_failures(self) -> int:
        return self._consecutive_failures

    @property
    def has_last_good(self) -> bool:
        """True once any cycle of this epoch completed (or state was
        restored)."""
        return self._last_good is not None

    def reserve_labels(self) -> Labels:
        """What a failed cycle publishes instead of nothing: the last good
        set (if any), the unhealthy-cycles counter, the degraded marker
        while init is failing, the restored marker while restored."""
        if self._last_good is not None:
            # Failed-cycle re-serves bypass the actuation projection, so
            # the lease check lands here: lapsed advice ages out of the
            # re-serve and of the cache (one warning, not one per cycle).
            self._last_good = drop_lapsed_advice(self._last_good)
            labels = Labels(self._last_good)
        else:
            labels = Labels()
        labels[UNHEALTHY_CYCLES_LABEL] = str(self._consecutive_failures)
        if self.degraded:
            labels[DEGRADED_LABEL] = "true"
        if self._restored:
            labels[RESTORED_LABEL] = "true"
        return labels

    # -- liveness ----------------------------------------------------------

    def touch_heartbeat(self) -> None:
        """Bump the heartbeat file's mtime (creating it on first touch).
        Failures are logged once and never fail a cycle."""
        path = self._heartbeat_file
        if not path:
            return
        try:
            with open(path, "ab"):
                pass
            os.utime(path, None)
        except OSError as e:
            if not self._heartbeat_warned:
                self._heartbeat_warned = True
                log.warning("cannot touch heartbeat file %s: %s", path, e)
