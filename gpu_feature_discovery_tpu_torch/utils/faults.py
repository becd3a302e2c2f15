"""Deterministic fault-injection registry, ``TFD_FAULT_SPEC`` (twin:
``gpu_feature_discovery_tpu/utils/faults.py``).

The recovery paths of the supervised daemon (backend-init backoff,
degraded labels, per-cycle containment, write-failure re-serves, the
broker's hang-kill and crash-respawn) never fire on a healthy machine.
This registry makes them reachable on demand without changing the code
paths' structure: an instrumented site calls ``maybe_inject(site)``,
which does nothing unless a fault spec armed that site. One spec string
drives both packages: the grammar and the site names are the twin's.

Spec grammar (comma-separated entries)::

    TFD_FAULT_SPEC=pjrt_init:fail:3,write:raise:OSError,generate:raise:RuntimeError:2

    <site>:fail:<n>            raise FaultInjected on the first n calls
    <site>:raise:<exc>[:<n>]   raise <exc>("injected fault ...") on the
                               first n calls (default 1)

``<exc>`` comes from a fixed allowlist; counts are finite, so every
scenario converges.

Sites this port wires:

    pjrt_init          backend acquisition: resource.factory.new_manager
                       (in process), sandbox.probe.acquire_snapshot_manager
                       (one probe child per acquisition) and the broker
                       worker's spawn (sandbox/broker.py). The name is the
                       twin's, so one spec drives both packages.
    pjrt_init.<family> one backend family's acquisition in the registry
                       cycle (--backends gpu,cpu): gpu | cpu. It fails ONLY
                       that family's acquisition, so its labels degrade
                       while the other family keeps publishing fresh
                       (resource/registry.py BackendRuntime.acquire)
    generate           lm.engine.LabelEngine.generate (cycle entry)
    labeler.<name>     lm.engine.LabelSource.run (one named labeler)
    write              lm.labels.Labels.write_to_file
    probe.timeout      the acquisition reports an immediate timeout; no
                       child is spawned (sandbox/probe.py, and a broker
                       spawn, which is an acquisition too)
    probe.hang         the probe child (or a spawning broker worker) hangs
                       until the parent's SIGKILL at --probe-timeout
    probe.segv         the probe child (or a spawning broker worker) dies
                       to a real SIGSEGV
    broker.hang        the broker worker hangs on ONE request; the parent
                       SIGKILLs it at --probe-timeout and respawns on next
                       use
    broker.crash       the broker worker dies to a real SIGSEGV at one
                       request
    chip.<i>.sick      device <i>'s verdict input is NaN-poisoned for one
                       probe (ops/healthcheck.py sick_chips), so the real
                       finite-verdict publishes chip.<i>.ok=false
    chip.<i>.slow      device <i>'s measured rate is scaled by
                       SLOW_CHIP_FACTOR for one probe; straggler
                       confirmation takes 2 consecutive probes
                       On a node with GPUs in MIG mode <i> is the label
                       index (resource/probe_targets.py): a MIG device
                       under a valid single strategy; under none/mixed a
                       plain GPU, or on a MIG-enabled GPU that GPU's first
                       MIG device, whose pinned worker enacts it
    peer.unreachable   slice coordination (peering/): this daemon's
                       /peer/snapshot handler drops the connection with
                       no response on the next N polls, as a dead host
                       does; confirmation takes 2 consecutive misses, so
                       arm 2+ shots to flip slice.degraded
    peer.slow          the snapshot handler stalls past --peer-timeout
                       before answering (the poll-timeout miss)
    peer.junk          the snapshot handler answers 200 with a non-JSON
                       body (the parse-rejection miss)
    peer.tier-partition
                       two-tier coordination (--cohort-size): the
                       handler drops the next N slice-tier leadership
                       polls (X-TFD-Poll-Tier: slice) while cohort and
                       direct-fallback polls answer
                       (SliceCoordinator.serving_fault)
    peer.cohort-leader-dead
                       the handler drops the next N polls while this
                       daemon IS a cohort leader: the mid-tier death
                       whose failover re-derives the next chain member
    notify.drop        push-on-delta (peering/notify.py): the CHILD's
                       next change notification is never sent, as a
                       dropped packet; the parent's --max-staleness
                       sweep repairs it
    notify.slow        the parent's POST /peer/notify handler stalls
                       before answering (the child's notify timeout gives
                       up off its publish path)
    notify.reject      the parent's POST /peer/notify handler answers
                       503, a rejection the child never retries

The ``probe.*``, ``broker.*`` and ``chip.*`` sites are BEHAVIOURAL: they
are consumed in the PARENT with ``consume()`` (a countdown that does not
raise) and enacted in the child process, which starts as a fresh
interpreter with ``TFD_FAULT_SPEC`` removed from its environment. The
countdown must live where the scenario is driven: a child-side countdown
would count in a registry that dies with the child, re-fire in every new
child, and no scenario could converge. ``chip.*`` is consumed by the
health labeler (lm/health.py) once per PROBING cycle and shipped to
wherever the probe runs: in process, the broker worker's ``health`` RPC,
or on a MIG node the worker or child pinned to the MIG device it names. The ``peer.*`` sites and ``notify.slow``/``notify.reject`` are
consumed and enacted in the SERVING daemon's handler (obs/server.py; the
two tier sites through the coordinator's gate), and ``notify.drop`` in
the sending child's NotifySender, where each misbehaviour lives.

The registry is process-global and loaded lazily from the environment on
first use; tests install specs with ``load_fault_spec`` and ``reset()``
when done. Counting is lock-protected: labeler sites fire from engine
pool threads.
"""

from __future__ import annotations

import logging
import os
import re
import threading
from typing import Dict, Optional, Tuple, Type

from gpu_feature_discovery_tpu_torch.config.spec import ConfigError

log = logging.getLogger("tfd.faults")

FAULT_SPEC_ENV = "TFD_FAULT_SPEC"

# The spec names exception TYPES, not code: only these resolve.
_EXCEPTION_ALLOWLIST: Dict[str, Type[BaseException]] = {
    "OSError": OSError,
    "RuntimeError": RuntimeError,
    "ValueError": ValueError,
    "TimeoutError": TimeoutError,
}


def _allowed_exceptions() -> Dict[str, Type[BaseException]]:
    from gpu_feature_discovery_tpu_torch.resource.types import ResourceError

    return {**_EXCEPTION_ALLOWLIST, "ResourceError": ResourceError}


class FaultInjected(RuntimeError):
    """The ``fail`` mode's error type, unambiguous in logs."""


class _Fault:
    def __init__(self, site: str, exc_type: Type[BaseException], remaining: int):
        self.site = site
        self.exc_type = exc_type
        self.remaining = remaining


class FaultRegistry:
    """Armed faults by site, with a thread-safe countdown."""

    def __init__(self, faults: Dict[str, _Fault]):
        self._faults = faults
        self._lock = threading.Lock()

    @property
    def sites(self) -> Tuple[str, ...]:
        return tuple(self._faults)

    def armed_sites(self) -> Tuple[str, ...]:
        """Sites with shots remaining: the chip.<i>.* family must discover
        which indices are armed before consuming them; listing does not
        consume."""
        with self._lock:
            return tuple(s for s, f in self._faults.items() if f.remaining > 0)

    def fire(self, site: str) -> None:
        fault = self._faults.get(site)
        if fault is None:
            return
        with self._lock:
            if fault.remaining <= 0:
                return
            fault.remaining -= 1
            remaining = fault.remaining
        log.warning(
            "fault injection: raising %s at site %r (%d left)",
            fault.exc_type.__name__,
            site,
            remaining,
        )
        raise fault.exc_type(f"injected fault at {site!r} ({FAULT_SPEC_ENV})")

    def untake(self, site: str) -> None:
        """Give one consumed shot back. The broker health path consumes
        chip shots BEFORE its RPC (the indices travel in the request), so
        a request that failed or answered "unacquirable" must re-arm them
        instead of burning the budget."""
        fault = self._faults.get(site)
        if fault is None:
            return
        with self._lock:
            fault.remaining += 1

    def take(self, site: str) -> bool:
        """Countdown WITHOUT raising: True when ``site`` was armed with
        shots remaining (one is consumed). The behavioural sites turn it
        into an action (hang the child, SIGSEGV it) instead of an
        exception."""
        fault = self._faults.get(site)
        if fault is None:
            return False
        with self._lock:
            if fault.remaining <= 0:
                return False
            fault.remaining -= 1
            remaining = fault.remaining
        log.warning(
            "fault injection: arming behavior at site %r (%d left)",
            site,
            remaining,
        )
        return True


def parse_fault_spec(spec: str) -> FaultRegistry:
    """Parse the grammar above; a malformed entry is a ConfigError (a
    typo'd scenario must fail, not silently test nothing)."""
    faults: Dict[str, _Fault] = {}
    exceptions = _allowed_exceptions()
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        parts = entry.split(":")
        if len(parts) < 2:
            raise ConfigError(f"fault entry {entry!r}: want <site>:<mode>[:...]")
        site, mode = parts[0], parts[1]
        if not site:
            raise ConfigError(f"fault entry {entry!r}: empty site")
        if site in faults:
            raise ConfigError(f"fault entry {entry!r}: duplicate site {site!r}")
        if mode == "fail":
            if len(parts) != 3:
                raise ConfigError(f"fault entry {entry!r}: want {site}:fail:<n>")
            exc_type: Type[BaseException] = FaultInjected
            count_raw = parts[2]
        elif mode == "raise":
            if len(parts) not in (3, 4):
                raise ConfigError(
                    f"fault entry {entry!r}: want {site}:raise:<exc>[:<n>]"
                )
            if parts[2] not in exceptions:
                raise ConfigError(
                    f"fault entry {entry!r}: unknown exception {parts[2]!r} "
                    f"(allowed: {sorted(exceptions)})"
                )
            exc_type = exceptions[parts[2]]
            count_raw = parts[3] if len(parts) == 4 else "1"
        else:
            raise ConfigError(
                f"fault entry {entry!r}: unknown mode {mode!r} (fail | raise)"
            )
        try:
            count = int(count_raw)
        except ValueError as e:
            raise ConfigError(f"fault entry {entry!r}: bad count {count_raw!r}") from e
        if count < 1:
            raise ConfigError(f"fault entry {entry!r}: count must be >= 1")
        faults[site] = _Fault(site, exc_type, count)
    return FaultRegistry(faults)


# None = not loaded yet (the environment is read on first use); a loaded
# registry, even an empty one, stays until reset().
_registry: Optional[FaultRegistry] = None
_loaded = False


def load_fault_spec(spec: str) -> FaultRegistry:
    """Install a spec programmatically (tests, the smoke script)."""
    global _registry, _loaded
    _registry = parse_fault_spec(spec)
    _loaded = True
    if _registry.sites:
        log.warning(
            "FAULT INJECTION ACTIVE (%s): %s — never set in production",
            FAULT_SPEC_ENV,
            ",".join(_registry.sites),
        )
    return _registry


def reset() -> None:
    """Disarm everything and re-read the environment on next use."""
    global _registry, _loaded
    _registry = None
    _loaded = False


def active() -> bool:
    """True when a fault spec is loaded (any sites, armed or spent). The
    broker pre-spawn, which would consume an injected shot outside the
    supervisor's paced accounting, stands down while this holds."""
    reg = _ensure_loaded()
    return reg is not None and bool(reg.sites)


def maybe_inject(site: str) -> None:
    """The instrumented-site hook: a no-op unless a spec armed ``site``."""
    reg = _ensure_loaded()
    if reg is not None:
        reg.fire(site)


def consume(site: str) -> bool:
    """Behavioural-site hook: True when ``site`` is armed (one shot is
    consumed), without raising. Call it in the process that owns the
    registry: for the sandbox, the PARENT."""
    reg = _ensure_loaded()
    if reg is None:
        return False
    return reg.take(site)


_CHIP_SITE_RE = re.compile(r"^chip\.(\d+)\.(sick|slow)$")


def consume_chip_faults() -> Tuple[frozenset, frozenset]:
    """Consume every armed ``chip.<i>.sick`` / ``chip.<i>.slow`` site (one
    shot each) and return ``(sick_indices, slow_indices)``. The health
    labeler calls it once per probing cycle, right before a probe
    launches; the indices travel to wherever the probe runs."""
    reg = _ensure_loaded()
    if reg is None:
        return frozenset(), frozenset()
    sick, slow = set(), set()
    for site in reg.armed_sites():
        m = _CHIP_SITE_RE.match(site)
        if m is None:
            continue
        if reg.take(site):
            (sick if m.group(2) == "sick" else slow).add(int(m.group(1)))
    return frozenset(sick), frozenset(slow)


def rearm_chip_faults(sick, slow) -> None:
    """Give consumed ``chip.<i>.*`` shots back (FaultRegistry.untake):
    the probe they were shipped to never ran."""
    reg = _ensure_loaded()
    if reg is None:
        return
    for i in sick:
        reg.untake(f"chip.{i}.sick")
    for i in slow:
        reg.untake(f"chip.{i}.slow")


def _ensure_loaded() -> Optional[FaultRegistry]:
    global _loaded
    if not _loaded:
        _loaded = True
        spec = os.environ.get(FAULT_SPEC_ENV, "")
        if spec:
            load_fault_spec(spec)
    return _registry
