"""Label-generation engine with per-labeler deadlines (twin:
``gpu_feature_discovery_tpu/lm/engine.py``).

Each top-level labeler (timestamp, device, health — lm/labelers.py) is a
named ``LabelSource``. Sources that can block (the burn-in probe) run on
a small pool of daemon threads; pure-local sources run on the labeling
thread meanwhile. Every offloaded source gets the same absolute
per-cycle deadline (``--labeler-timeout``, measured from cycle start).

A source that misses the deadline is not awaited: the engine serves its
last-good cached labels, names it in ``nvidia.com/gpu.tfd.stale-sources``
and leaves the straggler running. Its result is harvested into the cache
by a later cycle that finds it finished; it is never resubmitted while
in flight, so a wedged source holds one pool thread, not one per cycle.
A source may carry a ``cancel`` hook: the broker-routed health source's
is ``BrokerClient.kill_child`` (lm/gpu.py), so a deadline miss, or the
epoch's close, SIGKILLs the worker running its probe.

The ``generate`` and ``labeler.<name>`` fault sites (utils/faults.py)
fire at cycle entry and at each source's run.

Results merge in source-list order whatever order the futures finish in,
so the output is byte-identical to the sequential merge, which
``--parallel-labelers=false`` runs instead (inline, in order, no pool, no
cache, no staleness). Labeler errors propagate in both modes; only a
deadline miss degrades to cache + staleness. The daemon builds one engine
per config epoch, so a SIGHUP reload drops every cached label.
"""

from __future__ import annotations

import concurrent.futures
import logging
import queue
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Set, Tuple

from gpu_feature_discovery_tpu_torch.config.flags import DEFAULT_LABELER_TIMEOUT
from gpu_feature_discovery_tpu_torch.lm.labeler import Labeler
from gpu_feature_discovery_tpu_torch.lm.labels import Labels, label_safe_value
from gpu_feature_discovery_tpu_torch.obs import metrics as obs_metrics
from gpu_feature_discovery_tpu_torch.utils import timing

log = logging.getLogger("tfd.lm")

# Which sources missed their deadline this cycle; absent when every source
# was fresh, so default runs (and the goldens) never see it.
STALE_SOURCES_LABEL = "nvidia.com/gpu.tfd.stale-sources"

# Source names joined with "_" (names use "-"): a label value cannot
# carry a comma.
_STALE_JOIN = "_"


@dataclass(frozen=True)
class LabelSource:
    """One named top-level labeler: ``produce()`` builds or probes it and
    the engine calls ``.labels()`` on the result.

    ``offload`` says whether the source can BLOCK (device probes):
    offloaded sources run on the pool under the deadline; pure-local ones
    (dict math, a clock read) run on the labeling thread. ``cancel`` is
    the probe-sandbox escalation hook (see the module docstring).
    ``group`` names the backend family of a registry cycle's source; it
    rides into ``last_provenance`` for /debug/labels and changes nothing
    else."""

    name: str
    produce: Callable[[], Labeler]
    offload: bool = True
    cancel: Optional[Callable[[], None]] = None
    group: str = ""

    def run(self) -> Labels:
        from gpu_feature_discovery_tpu_torch.utils.faults import maybe_inject

        maybe_inject(f"labeler.{self.name}")
        return self.produce().labels()


@dataclass
class _SourceState:
    """Engine-side bookkeeping for one source name."""

    last_good: Optional[Labels] = None
    inflight: Optional[concurrent.futures.Future] = None
    cancel: Optional[Callable[[], None]] = None
    # The engine cancelled this submission itself: its failure is
    # self-inflicted and must not surface as a broken source at harvest.
    cancelled: bool = False


class _DaemonPool:
    """Minimal pool of DAEMON worker threads, spawned on demand.

    Not ThreadPoolExecutor: its workers are non-daemon and joined at exit,
    so one wedged labeler would hang shutdown. These die with the process.
    The engine holds at most one task per source name, so demand is
    bounded by the source count."""

    def __init__(self, max_workers: int, name_prefix: str = "tfd-labeler"):
        self._q: "queue.SimpleQueue[Optional[Tuple]]" = queue.SimpleQueue()
        self._max = max_workers
        self._prefix = name_prefix
        self._lock = threading.Lock()
        self._threads: List[threading.Thread] = []
        # Submitted and not yet finished; decremented only when a task
        # completes, so the spawn check can over-estimate demand, never
        # leave a task queued behind a busy worker.
        self._outstanding = 0

    def submit(self, fn: Callable[[], Labels]) -> concurrent.futures.Future:
        fut: concurrent.futures.Future = concurrent.futures.Future()
        with self._lock:
            self._outstanding += 1
            if len(self._threads) < self._max and self._outstanding > len(self._threads):
                t = threading.Thread(
                    target=self._work,
                    name=f"{self._prefix}-{len(self._threads)}",
                    daemon=True,
                )
                t.start()
                self._threads.append(t)
        self._q.put((fut, fn))
        return fut

    def _work(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            fut, fn = item
            try:
                if not fut.set_running_or_notify_cancel():
                    continue
                try:
                    fut.set_result(fn())
                except BaseException as e:  # noqa: BLE001 - via the future
                    fut.set_exception(e)
            finally:
                with self._lock:
                    self._outstanding -= 1

    def shutdown(self) -> None:
        """Idle workers exit now; busy ones after their current task (or
        never, if wedged: they are daemons)."""
        with self._lock:
            threads = list(self._threads)
        for _ in threads:
            self._q.put(None)


class LabelEngine:
    """Per-config-epoch label generator. ``generate(sources)`` is the one
    entry point; the caller rebuilds the source list every cycle while the
    engine carries the pool, the last-good cache and the stragglers."""

    def __init__(
        self,
        parallel: bool = True,
        timeout_s: float = DEFAULT_LABELER_TIMEOUT,
        max_workers: int = 8,
    ):
        self._parallel = parallel
        self._timeout_s = timeout_s
        self._max_workers = max_workers
        self._pool: Optional[_DaemonPool] = None
        self._state: Dict[str, _SourceState] = {}
        self._stale_prev: Set[str] = set()
        self._lock = threading.Lock()
        # Per-source status and duration of the last cycle, for
        # /debug/labels (obs/server.py).
        self.last_provenance: Dict[str, Dict[str, object]] = {}

    def generate(self, sources: List[LabelSource]) -> Labels:
        from gpu_feature_discovery_tpu_torch.utils.faults import maybe_inject

        maybe_inject("generate")
        if not self._parallel:
            return self._generate_sequential(sources)
        return self._generate_parallel(sources)

    def close(self) -> None:
        """Retire the pool at epoch end; a straggler finishes (or wedges)
        in the background without blocking exit. A straggler with a cancel
        hook is cancelled now, so a reload orphans no probe child."""
        for name, state in self._state.items():
            fut = state.inflight
            if fut is None or fut.done():
                continue
            if state.cancel is not None and not state.cancelled:
                state.cancelled = True
                try:
                    state.cancel()
                except Exception:  # noqa: BLE001 - close must not raise
                    log.warning("cancel hook for labeler %r failed:", name,
                                exc_info=True)
        if self._pool is not None:
            self._pool.shutdown()
            self._pool = None

    def _generate_sequential(self, sources: List[LabelSource]) -> Labels:
        merged = Labels()
        for src in sources:
            with timing.timed(f"labeler.{src.name}"):
                merged.update(src.run())
        self.last_provenance = self._provenance(sources, stale=[])
        return merged

    def _generate_parallel(self, sources: List[LabelSource]) -> Labels:
        start = time.monotonic()
        offloaded = [src for src in sources if src.offload]
        futures: Dict[str, concurrent.futures.Future] = {}
        if offloaded:
            pool = self._ensure_pool()
            # A pool thread has no span of its own: the cycle's is handed in.
            ctx = timing.context()
        for src in offloaded:
            state = self._state.setdefault(src.name, _SourceState())
            if state.inflight is not None:
                if not state.inflight.done():
                    # A straggler from an earlier cycle: wait on IT, never
                    # stack a second run behind it.
                    futures[src.name] = state.inflight
                    continue
                self._harvest(src.name, state)
            fut = pool.submit(lambda src=src: self._run_source(src, ctx))
            # In flight from submission: if an earlier source's error
            # aborts this cycle, the next one must wait on THIS future.
            state.inflight = fut
            state.cancel = src.cancel
            state.cancelled = False
            futures[src.name] = fut

        if futures:
            # Hand the GIL to the freshly woken workers before the inline
            # work starts.
            time.sleep(0)

        results: Dict[str, Labels] = {}
        for src in sources:
            if not src.offload:
                with timing.timed(f"labeler.{src.name}"):
                    results[src.name] = src.run()

        stale: List[str] = []
        for src in offloaded:
            fut = futures[src.name]
            state = self._state[src.name]
            remaining = self._timeout_s - (time.monotonic() - start)
            try:
                labels = fut.result(timeout=max(0.0, remaining))
            except concurrent.futures.TimeoutError:
                stale.append(src.name)
                labels = state.last_good if state.last_good is not None else Labels()
                if state.cancel is not None and not state.cancelled:
                    state.cancelled = True
                    try:
                        state.cancel()
                    except Exception:  # noqa: BLE001 - escalation best-effort
                        log.warning("cancel hook for labeler %r failed:",
                                    src.name, exc_info=True)
            except BaseException:
                state.inflight = None  # consumed: surfacing it this cycle
                raise
            else:
                state.inflight = None
                state.last_good = labels
            results[src.name] = labels

        merged = Labels()
        for src in sources:
            merged.update(results[src.name])
        self._log_stale_transitions(stale)
        obs_metrics.STALE_SOURCES.set(len(stale))
        for name in stale:
            obs_metrics.LABELER_DEADLINE_MISSES.labels(labeler=name).inc()
        self.last_provenance = self._provenance(sources, stale=stale)
        if stale:
            merged[STALE_SOURCES_LABEL] = label_safe_value(_STALE_JOIN.join(stale))
        return merged

    def _provenance(
        self, sources: List[LabelSource], stale: List[str]
    ) -> Dict[str, Dict[str, object]]:
        """Status and duration per source for /debug/labels. A straggler
        that has not finished has no span this cycle and reports null."""
        stages = obs_metrics.cycle_stages()
        stale_set = set(stale)
        out: Dict[str, Dict[str, object]] = {}
        for src in sources:
            elapsed = stages.get(f"labeler.{src.name}")
            entry: Dict[str, object] = {
                "status": "stale" if src.name in stale_set else "fresh",
                "duration_ms": round(elapsed * 1e3, 3) if elapsed is not None else None,
            }
            if src.group:
                entry["backend"] = src.group
            out[src.name] = entry
        return out

    def _run_source(self, src: LabelSource, ctx) -> Labels:
        with timing.adopt(ctx), timing.timed(f"labeler.{src.name}"):
            return src.run()

    def _harvest(self, name: str, state: _SourceState) -> None:
        """Fold a finished straggler's result into the cache. If it failed
        rather than finished, its error surfaces now — unless the engine
        cancelled it itself, when the source simply resubmits."""
        fut, state.inflight = state.inflight, None
        cancelled, state.cancelled = state.cancelled, False
        if cancelled and fut.exception() is not None:
            log.info("labeler %r: cancelled at the deadline; resubmitting "
                     "fresh (%s)", name, fut.exception())
            return
        state.last_good = fut.result()
        obs_metrics.STRAGGLERS_HARVESTED.labels(labeler=name).inc()
        log.info("labeler %r caught up; straggler result cached", name)

    def _log_stale_transitions(self, stale: List[str]) -> None:
        now = set(stale)
        for name in sorted(now - self._stale_prev):
            log.warning(
                "labeler %r exceeded its %.3fs deadline; serving last-good "
                "cached labels and marking %s",
                name, self._timeout_s, STALE_SOURCES_LABEL,
            )
        for name in sorted(self._stale_prev - now):
            log.info("labeler %r fresh again", name)
        self._stale_prev = now

    def _ensure_pool(self) -> _DaemonPool:
        with self._lock:
            if self._pool is None:
                self._pool = _DaemonPool(self._max_workers)
            return self._pool


def new_label_engine(config) -> LabelEngine:
    """Engine from the config (--parallel-labelers, --labeler-timeout).
    One per config epoch: close it when the epoch ends."""
    tfd = config.flags.tfd
    parallel = tfd.parallel_labelers if tfd.parallel_labelers is not None else True
    timeout = (
        tfd.labeler_timeout
        if tfd.labeler_timeout is not None
        else DEFAULT_LABELER_TIMEOUT
    )
    return LabelEngine(parallel=parallel, timeout_s=timeout)
