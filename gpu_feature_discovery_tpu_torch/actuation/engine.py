"""Fail-safe verdict actuation (twin:
``gpu_feature_discovery_tpu/actuation/engine.py``): confirmed health
verdicts projected into scheduler-consumable advice labels, written
through the same features.d file the daemon already writes, so NFD picks
the advice up like every other label and no API-server dependency is
added.

Advice that can cordon nodes is a new blast radius, so every safety rail
degrades toward "stop advising", never toward "cordon the fleet":

1. **Confirmation gating.** Advice fires only on verdicts that already
   survived their own confirmation: ``chips.sick`` from the burn-in's
   per-device verdicts, ``straggler-chip`` from the straggler detector's
   two-probe streak (lm/health.py). The verdict must then hold
   ``--actuation-window`` consecutive FULL cycles here before any advice
   is written, and stay clean as long before the advice clears.

2. **Blast-radius budget.** ``--max-actuated-fraction`` (default 0.25)
   caps how many hosts of one slice carry advice at once, over the peer
   snapshot plane: every member reads its peers' confirmed verdicts (the
   pre-extracted ``chips.sick`` and the straggler label, already on the
   wire) and derives the same allowed set with no election and no new
   wire surface: the ``ceil(fraction * hosts)`` lowest worker ids among
   the hosts that carry a verdict. A systemic false positive (a bad
   software rollout reading every device sick) actuates a bounded
   fraction and raises ``tfd_actuation_budget_exhausted`` on the rest.
   In two-tier cohort mode a member sees its cohort siblings, so the cap
   holds per visible peer set.

3. **Leased fail-static advice.** Every advice set carries a lease
   (``nvidia.com/gpu.tfd.actuation-lease=<unix expiry>``) of
   ``LEASE_TTL_FACTOR`` x the daemon's staleness bound
   (``--max-staleness``, or ``--sleep-interval`` when unset), renewed at
   half-life, so a steady verdict does not rewrite the file every cycle.
   A daemon that dies, wedges or loses verdict freshness stops renewing;
   the lease lapses and every re-serve path (the supervisor's restore,
   its last-good re-serves, degraded cycles here) drops the advice. A
   dead actuator converges to NO advice, never to a frozen cordon.

4. **Dry run first.** ``--actuation=off|advise|enforce``: ``off`` (the
   default) builds none of this and the label output is byte for byte
   the daemon's without it; ``advise`` writes only
   ``tfd.would-cordon=<reason>`` and the lease; ``enforce`` writes the
   advice family. Advice never rides the peer snapshot
   (peering/snapshot.py strips it): peers exchange the underlying
   verdicts and each derives its own advice.
"""

from __future__ import annotations

import logging
import math
import time
from typing import Callable, Dict, Optional, Tuple

from gpu_feature_discovery_tpu_torch.lm.labels import Labels
from gpu_feature_discovery_tpu_torch.obs import metrics as obs_metrics

log = logging.getLogger("tfd.actuation")

# The advice family. ``schedulable`` is the scheduler-facing verdict
# (absent = no claim: the daemon never asserts schedulable=true); the
# tfd.* labels carry the reason and the lease. ``would-cordon`` is the
# advise-mode dry-run twin of ``cordon-advice``.
SCHEDULABLE_LABEL = "nvidia.com/gpu.schedulable"
CORDON_ADVICE_LABEL = "nvidia.com/gpu.tfd.cordon-advice"
DRAIN_ADVICE_LABEL = "nvidia.com/gpu.tfd.drain-advice"
WOULD_CORDON_LABEL = "nvidia.com/gpu.tfd.would-cordon"
ACTUATION_LEASE_LABEL = "nvidia.com/gpu.tfd.actuation-lease"

ADVICE_LABELS = (
    SCHEDULABLE_LABEL,
    CORDON_ADVICE_LABEL,
    DRAIN_ADVICE_LABEL,
    WOULD_CORDON_LABEL,
    ACTUATION_LEASE_LABEL,
)

# Cordon reasons, keyed by the confirmed verdict that produced them.
REASON_SICK_CHIPS = "sick-chips"
REASON_STRAGGLER = "straggler"

# Lease TTL as a multiple of the staleness bound: renewed at half-life,
# so one staleness-bounded cycle always lands inside the remaining half;
# a live but slow daemon never lets its own lease lapse, a dead one
# lapses within 1-2 bounds.
LEASE_TTL_FACTOR = 2.0


def budget_allowance(total_hosts: int, fraction: float) -> int:
    """How many hosts of a ``total_hosts`` slice may carry advice at
    once: ``ceil(fraction * total_hosts)``, with an epsilon so float
    noise at exact boundaries (0.25 * 4 == 1.0) never rounds an extra
    host in. Never below 1 for a positive fraction: a lone host may
    always advise on its own confirmed verdict."""
    return max(1, math.ceil(fraction * max(int(total_hosts), 1) - 1e-9))


def advice_present(labels: Dict[str, str]) -> bool:
    """Whether any advice label is in the set."""
    return any(key in labels for key in ADVICE_LABELS)


def lease_expiry(labels: Dict[str, str]) -> Optional[float]:
    """The advice lease's unix expiry, or None when absent or
    unparseable (which reads as lapsed: fail toward no advice)."""
    raw = labels.get(ACTUATION_LEASE_LABEL)
    if raw is None:
        return None
    try:
        return float(int(raw))
    except (TypeError, ValueError):
        return None


def drop_lapsed_advice(labels: Labels, now: Optional[float] = None) -> Labels:
    """Drop the advice labels whose lease is missing, unparseable or
    expired: what every re-serve path applies. An advice-free set comes
    back as the same object (the --actuation=off path); a still-leased
    set is re-served as it is, original stamp and all: re-serving never
    renews a lease."""
    if not advice_present(labels):
        return labels
    expiry = lease_expiry(labels)
    if expiry is not None and (now if now is not None else time.time()) < expiry:
        return labels
    cleaned = Labels(labels)
    for key in ADVICE_LABELS:
        cleaned.pop(key, None)
    obs_metrics.ACTUATION_TRANSITIONS.labels(action="lease-lapsed").inc()
    log.warning(
        "actuation advice lease lapsed (expiry=%s); dropping advice "
        "labels — a dead actuator converges to no advice",
        "absent" if expiry is None else int(expiry),
    )
    return cleaned


class ActuationEngine:
    """Per-epoch actuation state. The run loop calls :meth:`project`
    once per written cycle, after the flap damper (the advice family has
    its own hysteresis; damping it twice would stack windows). A SIGHUP
    reload builds a new engine, so mode and window changes apply cleanly
    and no streak outlives the config that set it.

    ``signals`` is the coordinator's ``actuation_signals`` (None for an
    uncoordinated daemon): ``() -> (total_hosts, {peer worker_id:
    wants advice})`` over the live peer snapshots."""

    def __init__(
        self,
        mode: str,
        window: int,
        fraction: float,
        lease_ttl: float,
        worker_id: int = 0,
        signals: Optional[Callable[[], Tuple[int, Dict[int, bool]]]] = None,
        clock: Callable[[], float] = time.time,
    ):
        self.mode = mode
        self._window = max(1, int(window))
        self._fraction = float(fraction)
        self._lease_ttl = max(float(lease_ttl), 0.001)
        self._worker_id = int(worker_id)
        self._signals = signals
        self._clock = clock
        # Consecutive FULL cycles the confirmed verdict has been present /
        # absent. Non-full cycles advance neither: their verdicts are
        # re-served state, not measurements.
        self._desire_streak = 0
        self._clear_streak = 0
        # The advice currently emitted ({} = none) and its lease expiry.
        self._advice: Dict[str, str] = {}
        self._lease_expiry = 0.0
        self._suppressed = False
        obs_metrics.ACTUATION_ADVICE.set(0)
        obs_metrics.ACTUATION_BUDGET_EXHAUSTED.set(0)

    # -- verdict extraction ------------------------------------------------

    @staticmethod
    def _confirmed_verdicts(labels: Dict[str, str]) -> Tuple[bool, bool]:
        """(sick devices, straggler) from a cycle's labels; both already
        passed their own confirmation upstream."""
        from gpu_feature_discovery_tpu_torch.lm.health import CHIPS_SICK, STRAGGLER_CHIP

        try:
            sick = int(labels.get(CHIPS_SICK, "0") or "0") > 0
        except ValueError:
            sick = False
        return sick, STRAGGLER_CHIP in labels

    # -- blast-radius budget ----------------------------------------------

    def _budget_permits(self) -> bool:
        """Whether this host is inside the slice's budget: among the
        hosts whose snapshots carry a confirmed verdict (self included),
        only the ``budget_allowance`` lowest worker ids may actuate. Every
        member computes it alike from the same snapshots."""
        if self._signals is None:
            return True
        total, peer_desires = self._signals()
        candidates = sorted(
            [wid for wid, desires in peer_desires.items() if desires]
            + [self._worker_id]
        )
        allowed = budget_allowance(total, self._fraction)
        return self._worker_id in candidates[:allowed]

    # -- lease -------------------------------------------------------------

    def _stamped_lease(self, now: float) -> str:
        """This cycle's lease value: renewed (now + TTL) once the previous
        stamp is past half-life, else the stamp unchanged, so a steady
        verdict rewrites the file at the half-TTL cadence only."""
        if self._lease_expiry - now < self._lease_ttl / 2.0:
            self._lease_expiry = now + self._lease_ttl
        return str(int(math.ceil(self._lease_expiry)))

    # -- the per-cycle projection -----------------------------------------

    def project(self, labels: Labels, cycle_mode: str) -> Labels:
        """Project this cycle's confirmed verdicts into advice labels.
        Returns a NEW set when advice is added or stripped, and the input
        object untouched otherwise (the flap damper may hand over its
        remembered set; mutating it would corrupt its baseline).

        Full cycles advance the streaks and own the advice family (advice
        keys riding in, from a restored overlay or a damped re-serve, are
        replaced by the current decision). Non-full cycles (a degraded
        backend, stale sources) are fail-static: the streaks hold still
        and the advice already emitted is re-applied under its ORIGINAL
        lease until that lapses."""
        from gpu_feature_discovery_tpu_torch.lm.engine import STALE_SOURCES_LABEL

        now = self._clock()
        fresh = cycle_mode == "full" and STALE_SOURCES_LABEL not in labels
        if not fresh:
            if self._advice and now >= self._lease_expiry:
                obs_metrics.ACTUATION_TRANSITIONS.labels(action="lease-lapsed").inc()
                log.warning(
                    "verdict freshness lost past the advice lease; "
                    "clearing actuation advice (fail-static)"
                )
                self._advice = {}
                obs_metrics.ACTUATION_ADVICE.set(0)
            return self._emit(labels)

        sick, straggler = self._confirmed_verdicts(labels)
        if sick or straggler:
            self._desire_streak += 1
            self._clear_streak = 0
        else:
            self._clear_streak += 1
            if self._clear_streak >= self._window:
                self._desire_streak = 0
        held = self._desire_streak >= self._window
        advice_before = bool(self._advice)

        if held:
            if self._budget_permits():
                if self._suppressed:
                    self._suppressed = False
                    obs_metrics.ACTUATION_BUDGET_EXHAUSTED.set(0)
                reason = REASON_SICK_CHIPS if sick else REASON_STRAGGLER
                advice: Dict[str, str] = {}
                if self.mode == "advise":
                    advice[WOULD_CORDON_LABEL] = reason
                else:
                    advice[SCHEDULABLE_LABEL] = "false"
                    advice[CORDON_ADVICE_LABEL] = reason
                    if straggler:
                        advice[DRAIN_ADVICE_LABEL] = "true"
                advice[ACTUATION_LEASE_LABEL] = self._stamped_lease(now)
                self._advice = advice
                if not advice_before:
                    obs_metrics.ACTUATION_TRANSITIONS.labels(action="fired").inc()
                    obs_metrics.ACTUATION_CONVERGENCE_CYCLES.set(self._desire_streak)
                    obs_metrics.ACTUATION_ADVICE.set(1)
                    log.warning(
                        "actuation advice fired (mode=%s, reason=%s) "
                        "after %d confirming cycles",
                        self.mode, reason, self._desire_streak,
                    )
            else:
                # Budget exhausted: withhold this host's advice, and
                # withdraw it when a lower-ranked host's verdict re-ranked
                # it out. The cap is an invariant, not an admission gate.
                if self._advice:
                    self._advice = {}
                    obs_metrics.ACTUATION_ADVICE.set(0)
                if not self._suppressed:
                    self._suppressed = True
                    obs_metrics.ACTUATION_TRANSITIONS.labels(
                        action="budget-suppressed").inc()
                    obs_metrics.ACTUATION_BUDGET_EXHAUSTED.set(1)
                    log.warning(
                        "confirmed verdict held %d cycles but the slice "
                        "actuation budget (--max-actuated-fraction=%g) "
                        "is exhausted; withholding advice",
                        self._desire_streak, self._fraction,
                    )
        else:
            if self._suppressed:
                self._suppressed = False
                obs_metrics.ACTUATION_BUDGET_EXHAUSTED.set(0)
            if advice_before and self._clear_streak >= self._window:
                self._advice = {}
                self._lease_expiry = 0.0
                obs_metrics.ACTUATION_TRANSITIONS.labels(action="cleared").inc()
                obs_metrics.ACTUATION_ADVICE.set(0)
                log.info("actuation advice cleared after %d clean cycles",
                         self._clear_streak)
        return self._emit(labels)

    def _emit(self, labels: Labels) -> Labels:
        """Apply the current advice to the outgoing set: stale advice keys
        in the input are stripped and the current ones applied. Returns
        the input object itself when nothing changes."""
        stale_keys = [key for key in ADVICE_LABELS if key in labels]
        if not stale_keys and not self._advice:
            return labels
        if (
            self._advice
            and len(stale_keys) == len(self._advice)
            and all(labels.get(k) == v for k, v in self._advice.items())
        ):
            return labels
        out = Labels(labels)
        for key in stale_keys:
            out.pop(key, None)
        out.update(self._advice)
        return out


def new_actuation_engine(config, coordinator=None) -> Optional[ActuationEngine]:
    """The engine of a daemon config, or None at --actuation=off (the
    default), which builds nothing and leaves the label output byte for
    byte as it was. The lease TTL is LEASE_TTL_FACTOR x the daemon's
    staleness bound (--max-staleness, or --sleep-interval when 0)."""
    from gpu_feature_discovery_tpu_torch.config.flags import (
        DEFAULT_ACTUATION_WINDOW,
        DEFAULT_MAX_ACTUATED_FRACTION,
        DEFAULT_SLEEP_INTERVAL,
    )
    from gpu_feature_discovery_tpu_torch.config.spec import ACTUATION_OFF

    tfd = config.flags.tfd
    mode = tfd.actuation or ACTUATION_OFF
    if mode == ACTUATION_OFF:
        return None
    bound = tfd.max_staleness or tfd.sleep_interval or DEFAULT_SLEEP_INTERVAL
    window = (
        tfd.actuation_window
        if tfd.actuation_window is not None
        else DEFAULT_ACTUATION_WINDOW
    )
    fraction = (
        tfd.max_actuated_fraction
        if tfd.max_actuated_fraction is not None
        else DEFAULT_MAX_ACTUATED_FRACTION
    )
    return ActuationEngine(
        mode=mode,
        window=window,
        fraction=fraction,
        lease_ttl=LEASE_TTL_FACTOR * bound,
        worker_id=coordinator.worker_id if coordinator is not None else 0,
        signals=coordinator.actuation_signals if coordinator is not None else None,
    )
