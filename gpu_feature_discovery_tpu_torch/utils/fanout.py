"""Bounded fan-out pool (twin: ``gpu_feature_discovery_tpu/utils/fanout.py``).

A round of independent blocking tasks runs on a bounded thread pool and
the round blocks until every task has finished, so N slow tasks cost
about N/width instead of N; width 1 builds no pool and runs the tasks
inline, in order. The multi-backend registry's per-family init
(resource/registry.py ``BackendSet.acquire_all``) is its consumer here: a
hung family's init, bounded by its own ``--probe-timeout`` when
sandboxed, overlaps the other families' instead of holding them up. The
slice coordinator's poll rounds (peering/coordinator.py) are the other:
a task checks the round's budget as its first act, so a spent budget
skips exactly the tasks that had not started yet (``Budget``).
"""

from __future__ import annotations

import threading
from concurrent.futures import CancelledError, ThreadPoolExecutor
from typing import Callable, List, Optional


class BoundedPool:
    """A reusable bounded fan-out pool. ``width <= 1`` keeps ``pool`` None
    and runs the tasks inline. Tasks contain their own failures; one that
    escapes a task propagates out of ``run`` as from the inline loop."""

    def __init__(self, width: int, name: str = "tfd-fanout"):
        self.width = max(1, int(width))
        self.pool: Optional[ThreadPoolExecutor] = (
            ThreadPoolExecutor(max_workers=self.width, thread_name_prefix=name)
            if self.width > 1
            else None
        )

    def run(self, tasks: List[Callable[[], None]]) -> None:
        """Dispatch every task and block until all of them finished (or
        the pool was shut down under the round)."""
        if self.pool is None:
            for task in tasks:
                task()
            return
        futures = [self.pool.submit(task) for task in tasks]
        for future in futures:
            try:
                future.result()
            except CancelledError:
                # shutdown(cancel_futures=True) under an abandoned round:
                # nothing reads its results.
                pass

    def shutdown(self, wait: bool = False) -> None:
        if self.pool is not None:
            self.pool.shutdown(wait=wait, cancel_futures=True)


class Budget:
    """One round's wall-clock budget, shared by every task of the round.

    ``remaining()`` is what a task consults as its first act; ``spent``
    (with the caller's grace margin) is the dispatch cutoff. None = an
    unbounded round (remaining() is None, never spent)."""

    def __init__(self, budget_s: Optional[float], clock: Callable[[], float]):
        self._budget = float(budget_s) if budget_s is not None else None
        self._clock = clock
        self._started = clock()

    def remaining(self) -> Optional[float]:
        if self._budget is None:
            return None
        return self._budget - (self._clock() - self._started)

    def spent(self, grace: float = 0.0) -> bool:
        remaining = self.remaining()
        return remaining is not None and remaining <= grace


class ErrorSink:
    """(key -> error) gathered from pool threads under a lock."""

    def __init__(self):
        self._lock = threading.Lock()
        self.errors: dict = {}

    def put(self, key, error: BaseException) -> None:
        with self._lock:
            self.errors[key] = error
