"""Push-on-delta notifications, the child side (twin:
``gpu_feature_discovery_tpu/peering/notify.py``).

The slice leader pulls: it polls every peer each round. With push on, a
child whose served snapshot ETag moves POSTs a small authenticated
``/peer/notify`` hint to every subscribed parent; the parent marks that
child dirty and polls only dirty (and suspect) children until its next
full sweep, on the ``--max-staleness`` cadence, which stays the ONLY
correctness mechanism. A lost notification, a dead child that cannot
push its own death, a restarted parent that forgot its dirty set: the
next sweep repairs each of them, the push path none.

A parent SUBSCRIBES by adding ``X-TFD-Notify-Port`` (its own
introspection port) and ``X-TFD-Notify-Name`` (the worker id it knows
the child by) to the snapshot polls it already sends; the child records
(the poll connection's source address, port, name) with a TTL that every
poll refreshes. The notification echoes the name and the parent
validates it against its own peer set.

Delivery is best-effort and off the publish path: one daemon thread,
latest-wins coalescing, connection retries on ``utils/retry``'s
BackoffPolicy, a bounded attempt budget. ``publish()`` never blocks and
never raises.
"""

from __future__ import annotations

import http.client
import json
import logging
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from gpu_feature_discovery_tpu_torch.config.spec import (
    PUSH_NOTIFY_AUTO,
    PUSH_NOTIFY_OFF,
    PUSH_NOTIFY_ON,
)
from gpu_feature_discovery_tpu_torch.obs import metrics as obs_metrics
from gpu_feature_discovery_tpu_torch.utils import faults
from gpu_feature_discovery_tpu_torch.utils.retry import BackoffPolicy

log = logging.getLogger(__name__)

# Subscription headers a parent adds to its snapshot polls. obs/server.py
# restates these names (it does not import peering); a test pins both.
NOTIFY_PORT_HEADER = "X-TFD-Notify-Port"
NOTIFY_NAME_HEADER = "X-TFD-Notify-Name"

NOTIFY_PATH = "/peer/notify"
NOTIFY_SCHEMA = 1

# Sweep periods a subscription survives without a refreshing poll.
SUBSCRIPTION_TTL_SWEEPS = 3.0

# Attempts per notification per subscriber on connection failures; the
# sweep repairs whatever the budget abandons.
NOTIFY_MAX_ATTEMPTS = 3

# Per-request connect/read timeout.
NOTIFY_TIMEOUT_S = 2.0


def resolve_push_notify(mode: str, peer_token: str) -> bool:
    """The effective push switch: ``auto`` is on exactly when a peer token
    is configured, since the notify endpoint refuses unauthenticated
    POSTs."""
    if mode == PUSH_NOTIFY_ON:
        return True
    if mode == PUSH_NOTIFY_OFF:
        return False
    if mode == PUSH_NOTIFY_AUTO:
        return bool(peer_token)
    raise ValueError(f"invalid push-notify mode: {mode!r}")


class NotifySubscriptions:
    """The child's registry of parents that asked to be notified, keyed
    by (host, port, name): the host is the poll connection's source
    address, never client-asserted. ``targets()`` prunes lapsed entries,
    so a parent that stops polling stops being notified within the TTL."""

    def __init__(self, ttl_s: float, clock: Callable[[], float] = time.monotonic):
        self._ttl = max(ttl_s, 0.0)
        self._clock = clock
        self._lock = threading.Lock()
        self._subs: Dict[Tuple[str, int, str], float] = {}

    def observe_poll(self, host: str, port: int, name: str) -> None:
        if not host or port <= 0 or not name:
            return
        with self._lock:
            self._subs[(host, port, name)] = self._clock() + self._ttl

    def targets(self) -> List[Tuple[str, int, str]]:
        now = self._clock()
        with self._lock:
            for key in [k for k, exp in self._subs.items() if exp <= now]:
                del self._subs[key]
            return sorted(self._subs)

    def __len__(self) -> int:
        """The live subscriptions, lapsed ones pruned."""
        return len(self.targets())


class NotifySender:
    """Best-effort upward notifier: one daemon thread, latest wins.

    ``publish(generation, etag)`` records the newest served state and
    wakes the worker. The worker delivers the LATEST pending hint to
    every live subscriber, retrying connection failures on the backoff
    schedule; a newer publish supersedes a delivery at its next retry
    (counted ``dropped``). A non-202 answer is counted ``rejected`` and
    not retried."""

    def __init__(
        self,
        subscriptions: NotifySubscriptions,
        token: str = "",
        timeout: float = NOTIFY_TIMEOUT_S,
        max_attempts: int = NOTIFY_MAX_ATTEMPTS,
        backoff: Optional[BackoffPolicy] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.subscriptions = subscriptions
        self._token = token
        self._timeout = timeout
        self._max_attempts = max(1, max_attempts)
        self._backoff = backoff or BackoffPolicy()
        self._clock = clock
        self._cond = threading.Condition()
        self._pending: Optional[Tuple[int, str]] = None
        self._seq = 0  # bumps per publish; a retry sees its supersession
        self._busy = False  # the worker is mid-delivery (flush waits on it)
        self._closed = False
        self._thread: Optional[threading.Thread] = None

    def publish(self, generation: int, etag: str) -> None:
        """Record the newest served (generation, etag) and wake the
        worker; an unsent older pending one is replaced and counted
        ``dropped``."""
        with self._cond:
            if self._closed:
                return
            if self._pending is not None:
                obs_metrics.NOTIFY_SENT.labels(outcome="dropped").inc()
            self._pending = (generation, etag)
            self._seq += 1
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._run, name="tfd-notify", daemon=True
                )
                self._thread.start()
            self._cond.notify_all()

    def close(self) -> None:
        """Epoch end: wake the worker so it sees ``_closed`` and join it
        within a bound, so a sender mid-POST to a wedged parent never
        stalls a reload; a straggler (a daemon thread) is abandoned with a
        warning."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        thread = self._thread
        if thread is not None:
            thread.join(timeout=self._timeout + 1.0)
            if thread.is_alive():
                log.warning(
                    "notify sender thread still delivering after the %.1fs "
                    "close bound; abandoning it (daemon thread: it dies with "
                    "its socket timeout)", self._timeout + 1.0,
                )

    def flush(self, timeout: float = 5.0) -> bool:
        """Block until queued work is delivered (or abandoned) and the
        worker is idle, or ``timeout`` elapses. For tests: the daemon never
        waits on delivery."""
        deadline = time.monotonic() + timeout
        with self._cond:
            while self._pending is not None or self._busy:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cond.wait(timeout=remaining)
        return True

    def _run(self) -> None:
        while True:
            with self._cond:
                while self._pending is None and not self._closed:
                    self._cond.wait()
                if self._pending is None:  # closed with nothing queued
                    return
                pending, seq = self._pending, self._seq
                self._pending = None
                self._busy = True
            try:
                self._deliver(pending, seq)
            finally:
                with self._cond:
                    self._busy = False
                    self._cond.notify_all()
            with self._cond:
                if self._closed and self._pending is None:
                    return

    def _superseded_or_closed(self, seq: int) -> bool:
        with self._cond:
            return self._closed or self._seq != seq

    def _deliver(self, pending: Tuple[int, str], seq: int) -> None:
        generation, etag = pending
        targets = self.subscriptions.targets()
        if not targets:
            return
        # The lossy wire, consumed only when there IS a wire: a sender
        # with no subscriber must not eat a shot meant for a delivery.
        if faults.consume("notify.drop"):
            obs_metrics.NOTIFY_SENT.labels(outcome="dropped").inc()
            return
        for host, port, name in targets:
            self._notify_one(host, port, name, generation, etag, seq)

    def _notify_one(
        self, host: str, port: int, name: str, generation: int, etag: str, seq: int
    ) -> None:
        body = json.dumps({
            "schema": NOTIFY_SCHEMA,
            "name": name,
            "generation": generation,
            "etag": etag,
        }).encode()
        headers = {"Content-Type": "application/json"}
        if self._token:
            headers["X-TFD-Probe-Token"] = self._token
        for attempt in range(self._max_attempts):
            conn = http.client.HTTPConnection(host, port, timeout=self._timeout)
            try:
                conn.request("POST", NOTIFY_PATH, body=body, headers=headers)
                resp = conn.getresponse()
                resp.read()
                if resp.status == 202:
                    obs_metrics.NOTIFY_SENT.labels(outcome="ok").inc()
                else:
                    # The parent heard and refused; a retry cannot change
                    # its mind, and its sweep still covers this child.
                    obs_metrics.NOTIFY_SENT.labels(outcome="rejected").inc()
                    log.debug("notify to %s:%d rejected: %d %s",
                              host, port, resp.status, resp.reason)
                return
            except (OSError, http.client.HTTPException) as e:
                if attempt + 1 >= self._max_attempts:
                    obs_metrics.NOTIFY_SENT.labels(outcome="error").inc()
                    log.debug("notify to %s:%d failed: %s", host, port, e)
                    return
                with self._cond:
                    self._cond.wait(timeout=self._backoff.delay(attempt))
                if self._superseded_or_closed(seq):
                    obs_metrics.NOTIFY_SENT.labels(outcome="dropped").inc()
                    return
            finally:
                conn.close()
