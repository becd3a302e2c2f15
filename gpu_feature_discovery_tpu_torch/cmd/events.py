"""Typed event queue and the event-driven reconcile wait (twin:
``gpu_feature_discovery_tpu/cmd/events.py``).

Under ``--reconcile=event`` (the supervised-daemon default via ``auto``)
the daemon loop blocks on ONE event queue instead of sleeping:

- **Producers** post :class:`Event`\\ s: the OS signal watcher through
  :class:`SignalForwarder`, the broker-worker death watch
  (``WORKER_DIED`` the moment the long-lived worker exits uncommanded,
  sandbox/broker.py; posted by cmd/main.run), the config-file stat
  watcher (:class:`ConfigFileWatcher` posts ``CONFIG_CHANGED``: a
  ConfigMap remount reloads the daemon without a SIGHUP), the loop's own
  :class:`DeltaTracker` (``HEALTH_DELTA`` when a health verdict moves
  between cycles, ``PEER_DELTA`` when the slice coordinator's reachable
  membership moves between poll rounds), and the introspection server's
  authenticated ``POST /probe`` (``PROBE_REQUEST``) and ``POST
  /peer/notify`` (``PEER_NOTIFY``, a child peer's push hint; obs/server.py).
- **The wait** (:meth:`ReconcileLoop.wait_for_wake`) has a deadline of
  ``--max-staleness`` (default: the sleep interval); the deadline
  expiring IS a wake, so the interval survives as a guarantee.
- **Coalescing**: a debounce window (``--reconcile-debounce``) absorbs
  the rest of a burst, and a token bucket (``--max-probe-rate``) defers
  wakes beyond the rate; the staleness deadline always dominates.
- **Decisions preempt**: a forwarded SIGHUP/SIGTERM or a
  ``CONFIG_CHANGED`` returns restart/shutdown from ANY wait, the
  failed-cycle backoff included (:meth:`ReconcileLoop.wait_backoff`).

``--reconcile=interval`` constructs none of this.
"""

from __future__ import annotations

import logging
import os
import queue
import signal
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

from gpu_feature_discovery_tpu_torch.config.flags import (
    DEFAULT_MAX_PROBE_RATE,
    DEFAULT_RECONCILE_DEBOUNCE,
)
from gpu_feature_discovery_tpu_torch.config.spec import (
    RECONCILE_AUTO,
    RECONCILE_EVENT,
    RECONCILE_INTERVAL,
)
from gpu_feature_discovery_tpu_torch.obs import metrics as obs_metrics

log = logging.getLogger("tfd.events")

# Wake reasons: the tfd_reconcile_wakes_total{reason} vocabulary.
REASON_SIGNAL = "signal"
REASON_WORKER_DIED = "worker_died"
REASON_CONFIG_CHANGED = "config_changed"
REASON_HEALTH_DELTA = "health_delta"
REASON_PEER_DELTA = "peer_delta"
REASON_PEER_NOTIFY = "peer_notify"
REASON_PROBE_REQUEST = "probe_request"
REASON_STALENESS_BOUND = "staleness_bound"

# Token-bucket burst allowance: a short legitimate burst runs its cycles
# back to back; anything past it drains at --max-probe-rate.
PROBE_BURST = 3.0

# How often the config-file watcher re-stats the file: reload latency on a
# human scale for one stat() a second.
CONFIG_POLL_S = 1.0


def resolve_reconcile_mode(config) -> str:
    """``--reconcile`` resolved to interval|event: ``auto`` is event for
    the supervised daemon and interval for oneshot."""
    tfd = config.flags.tfd
    mode = tfd.reconcile or RECONCILE_AUTO
    if mode != RECONCILE_AUTO:
        return mode
    return RECONCILE_INTERVAL if tfd.oneshot else RECONCILE_EVENT


@dataclass(frozen=True)
class Event:
    """One reconcile event; ``ts`` is its post time (monotonic)."""

    reason: str
    detail: str = ""
    signum: Optional[int] = None
    ts: float = field(default_factory=time.monotonic)


@dataclass(frozen=True)
class Wake:
    """One wait's outcome: ``decision`` is ``"restart"``/``"shutdown"``
    or None (run a cycle for ``reasons``); ``coalesced`` counts the extra
    events this wake absorbed."""

    decision: Optional[str]
    reasons: Tuple[str, ...]
    first_ts: float
    coalesced: int = 0


class EventQueue:
    """The one queue every producer posts into. A SimpleQueue, whose
    ``put`` is reentrant (cmd/main.new_os_watcher)."""

    def __init__(self):
        self._q: "queue.SimpleQueue[Event]" = queue.SimpleQueue()

    def post(self, event: Event) -> None:
        self._q.put(event)

    def get(self, timeout: Optional[float]) -> Optional[Event]:
        """One event, or None when ``timeout`` (seconds, may be 0)
        expires."""
        try:
            if timeout is None or timeout <= 0:
                return self._q.get_nowait()
            return self._q.get(timeout=timeout)
        except queue.Empty:
            return None

    def get_nowait(self) -> Optional[Event]:
        return self.get(None)


# Sentinel the forwarder's stop() injects into the OS signal queue.
_STOP = object()


class SignalForwarder:
    """Drains the OS signal queue into the event queue. Event mode only:
    under ``interval`` the loop reads the signal queue itself.

    ``stop()`` puts signal events still pending on the dying epoch's
    queue back on the OS signal queue: a SIGTERM that raced the epoch
    boundary is serviced by the next reader, not dropped."""

    def __init__(self, sigs, events: EventQueue):
        self._sigs = sigs
        self._events = events
        self._stopping = False
        self._thread = threading.Thread(
            target=self._run, name="tfd-signal-forwarder", daemon=True
        )

    def start(self) -> "SignalForwarder":
        self._thread.start()
        return self

    def _run(self) -> None:
        while True:
            signum = self._sigs.get()
            if signum is _STOP:
                if self._stopping:
                    return
                continue  # a stale sentinel from a previous epoch
            self._events.post(Event(REASON_SIGNAL, signum=signum))

    def stop(self) -> None:
        self._stopping = True
        self._sigs.put(_STOP)
        self._thread.join(timeout=5)
        while True:
            event = self._events.get_nowait()
            if event is None:
                return
            if event.reason == REASON_SIGNAL:
                self._sigs.put(event.signum)


class ConfigFileWatcher:
    """Posts ``CONFIG_CHANGED`` when the config file's (mtime, size,
    inode) signature moves. One event per watcher: the reload rebuilds the
    epoch and its watcher, so one changed file never storms the queue. A
    missing file is a signature of its own, so a file that comes back (a
    ConfigMap remount) is a change; an atomic rename or a symlink swap
    moves the inode."""

    def __init__(self, path: str, events: EventQueue, poll_s: Optional[float] = None):
        self._path = path
        self._events = events
        self._poll_s = poll_s if poll_s is not None else CONFIG_POLL_S
        self._stop = threading.Event()
        self._signature = self._stat()
        self._thread = threading.Thread(
            target=self._run, name="tfd-config-watcher", daemon=True
        )

    def _stat(self):
        try:
            st = os.stat(self._path)
        except OSError:
            return None
        return (st.st_mtime_ns, st.st_size, st.st_ino)

    def start(self) -> "ConfigFileWatcher":
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self._poll_s):
            current = self._stat()
            if current != self._signature:
                self._signature = current
                log.info("config file %s changed; requesting reload", self._path)
                self._events.post(Event(REASON_CONFIG_CHANGED, detail=self._path))
                return

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)


# Labels whose movement means the node's HEALTH VERDICT changed. Not the
# measurement labels (matmul-tflops, hbm-gbps, probe-ms), which jitter
# between probes while the verdicts hold.
HEALTH_DELTA_EXACT = frozenset(
    (
        "nvidia.com/gpu.health.ok",
        "nvidia.com/gpu.health.ici.ok",
        "nvidia.com/gpu.chips.healthy",
        "nvidia.com/gpu.chips.sick",
        "nvidia.com/gpu.straggler-chip",
    )
)
_CHIP_OK_PREFIX = "nvidia.com/gpu.chip."
_CHIP_OK_SUFFIX = ".ok"


def health_subset(labels) -> dict:
    """The verdict-class projection of one cycle's labels."""
    return {
        k: v
        for k, v in labels.items()
        if k in HEALTH_DELTA_EXACT
        or (k.startswith(_CHIP_OK_PREFIX) and k.endswith(_CHIP_OK_SUFFIX))
    }


class DeltaTracker:
    """Posts ``HEALTH_DELTA`` when the health projection of the published
    labels moves between cycles, and ``PEER_DELTA`` when a membership
    fingerprint (the slice coordinator's reachable peers) moves between
    poll rounds. The first observation of each only sets its baseline."""

    def __init__(self, events: EventQueue):
        self._events = events
        self._health: Optional[dict] = None
        self._memberships: dict = {}

    def observe_labels(self, labels) -> None:
        subset = health_subset(labels)
        if self._health is not None and subset != self._health:
            changed = [
                k for k in set(subset) | set(self._health)
                if subset.get(k) != self._health.get(k)
            ]
            self._events.post(
                Event(REASON_HEALTH_DELTA, detail=",".join(sorted(changed)[:4]))
            )
        self._health = subset

    def observe_peers(self, membership) -> None:
        """``membership`` is the coordinator's reachable-peer fingerprint
        (None before its first poll round completes)."""
        self.observe_membership("slice", membership)

    def observe_membership(self, scope: str, membership) -> None:
        """One baseline per ``scope``; ``membership`` is any comparable
        iterable, None means "not observed yet" and never moves the
        baseline."""
        if membership is None:
            return
        if scope in self._memberships and membership != self._memberships[scope]:
            self._events.post(
                Event(REASON_PEER_DELTA, detail=str(sorted(membership)))
            )
        self._memberships[scope] = membership


class TokenBucket:
    """``burst`` tokens refilled at ``rate``/s; taking one admits an
    event-driven cycle. Single-consumer, like the loop that owns it."""

    def __init__(
        self,
        rate: float,
        burst: float,
        clock: Callable[[], float] = time.monotonic,
    ):
        self._rate = float(rate)
        self._burst = max(float(burst), 1.0)
        self._clock = clock
        self._tokens = self._burst
        self._last_refill = clock()

    def _refill(self) -> None:
        now = self._clock()
        self._tokens = min(
            self._burst, self._tokens + (now - self._last_refill) * self._rate
        )
        self._last_refill = now

    def try_take(self) -> bool:
        """Take one token if available."""
        self._refill()
        if self._tokens >= 1.0:
            self._tokens -= 1.0
            return True
        return False

    def seconds_to_token(self) -> float:
        """How long until try_take could succeed (0 = now)."""
        self._refill()
        if self._tokens >= 1.0:
            return 0.0
        return (1.0 - self._tokens) / self._rate


class ReconcileLoop:
    """The wait primitive: blocks on the queue with the staleness
    deadline, debounces bursts, and rate-limits event-driven cycles.
    Single-consumer (the run loop); producers are free-threaded."""

    def __init__(
        self,
        events: EventQueue,
        max_staleness: float,
        debounce: float = DEFAULT_RECONCILE_DEBOUNCE,
        max_probe_rate: float = DEFAULT_MAX_PROBE_RATE,
        burst: float = PROBE_BURST,
        clock: Callable[[], float] = time.monotonic,
    ):
        self._events = events
        self._max_staleness = max(float(max_staleness), 0.001)
        self._debounce = max(float(debounce), 0.0)
        self._clock = clock
        self._bucket = TokenBucket(max_probe_rate, burst, clock)

    def _decision_for(self, event: Event) -> Optional[str]:
        """Restart/shutdown for a signal or a config change, None for a
        wake event (cmd/main._check_signal's vocabulary)."""
        if event.reason == REASON_SIGNAL:
            obs_metrics.RECONCILE_WAKES.labels(reason=REASON_SIGNAL).inc()
            if event.signum == signal.SIGHUP:
                log.info("Received SIGHUP, restarting.")
                return "restart"
            log.info("Received signal %s, shutting down.", event.signum)
            return "shutdown"
        if event.reason == REASON_CONFIG_CHANGED:
            obs_metrics.RECONCILE_WAKES.labels(reason=REASON_CONFIG_CHANGED).inc()
            log.info("Config file changed, restarting.")
            return "restart"
        return None

    def wait_for_wake(self) -> Wake:
        """Block until the next cycle is due: an event (debounced,
        rate-limited), a decision (immediately), or the staleness bound.
        Never blocks past ``--max-staleness`` + the debounce window."""
        deadline = self._clock() + self._max_staleness
        first = self._events.get(deadline - self._clock())
        if first is None:
            obs_metrics.RECONCILE_WAKES.labels(reason=REASON_STALENESS_BOUND).inc()
            return Wake(None, (REASON_STALENESS_BOUND,), self._clock())
        decision = self._decision_for(first)
        if decision is not None:
            return Wake(decision, (first.reason,), first.ts)

        reasons: List[str] = [first.reason]
        coalesced = 0

        def _absorb(event: Event) -> None:
            nonlocal coalesced
            coalesced += 1
            obs_metrics.RECONCILE_COALESCED.inc()
            if event.reason not in reasons:
                reasons.append(event.reason)

        debounce_end = self._clock() + self._debounce
        while True:
            remaining = debounce_end - self._clock()
            if remaining <= 0:
                break
            event = self._events.get(remaining)
            if event is None:
                break
            decision = self._decision_for(event)
            if decision is not None:
                return Wake(decision, tuple(reasons), first.ts, coalesced)
            _absorb(event)

        # Storm guard: an event-driven cycle needs a token; while the
        # bucket is dry keep absorbing, but the staleness deadline wins.
        while True:
            if self._bucket.try_take():
                break
            now = self._clock()
            if now >= deadline:
                reasons.append(REASON_STALENESS_BOUND)
                break
            wait = min(self._bucket.seconds_to_token(), deadline - now)
            event = self._events.get(wait)
            if event is not None:
                decision = self._decision_for(event)
                if decision is not None:
                    return Wake(decision, tuple(reasons), first.ts, coalesced)
                _absorb(event)

        obs_metrics.RECONCILE_WAKES.labels(reason=first.reason).inc()
        if coalesced:
            log.debug("reconcile wake %s coalesced %d event(s)", reasons, coalesced)
        return Wake(None, tuple(reasons), first.ts, coalesced)

    def wait_backoff(self, delay: float) -> Optional[str]:
        """The failed-cycle retry wait: up to ``delay`` seconds, returning
        a decision IMMEDIATELY on a forwarded signal or a config change.
        Ordinary events are
        absorbed: the retry cycle satisfies them."""
        deadline = self._clock() + delay
        while True:
            remaining = deadline - self._clock()
            if remaining <= 0:
                return None
            event = self._events.get(remaining)
            if event is None:
                return None
            decision = self._decision_for(event)
            if decision is not None:
                return decision
            obs_metrics.RECONCILE_COALESCED.inc()
