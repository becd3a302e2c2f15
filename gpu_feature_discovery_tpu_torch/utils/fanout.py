"""Bounded fan-out pool (twin: ``gpu_feature_discovery_tpu/utils/fanout.py``).

A round of independent blocking tasks runs on a bounded thread pool and
the round blocks until every task has finished, so N slow tasks cost
about N/width instead of N; width 1 builds no pool and runs the tasks
inline, in order. The multi-backend registry's per-family init
(resource/registry.py ``BackendSet.acquire_all``) is its consumer here: a
hung family's init, bounded by its own ``--probe-timeout`` when
sandboxed, overlaps the other families' instead of holding them up. The
twin's round ``Budget`` serves its peer poller, which this port does not
have yet.
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


class ErrorSink:
    """(key -> error) gathered from pool threads under a lock."""

    def __init__(self):
        self._lock = threading.Lock()
        self.errors: dict = {}

    def put(self, key, error: BaseException) -> None:
        with self._lock:
            self.errors[key] = error
