"""Per-cycle stage timing (twin: ``gpu_feature_discovery_tpu/utils/timing.py``).

The twin stores its spans in the metrics registry; the metrics plane is
a later slice of this port, so the spans live in a small per-cycle store
here. Two views render from it: the ``cycle_summary()`` log line the
daemon writes after every cycle, and the ``--timings-file`` JSON
document (``{"stages_ms": {stage: ms}}``, ms rounded to 3 decimals,
sorted keys — the twin's schema).
"""

from __future__ import annotations

import json
import logging
import threading
import time
from contextlib import contextmanager
from typing import Dict, Iterator

log = logging.getLogger("tfd.timing")

# Stage name -> seconds of the latest span this cycle. Written from the
# labeling thread and the engine's pool workers.
_stages: Dict[str, float] = {}
_stages_lock = threading.Lock()


def record(stage: str, elapsed: float) -> None:
    """Record a named span's duration (seconds)."""
    with _stages_lock:
        _stages[stage] = elapsed
    log.debug("stage %s took %.3f ms", stage, elapsed * 1e3)


@contextmanager
def timed(stage: str) -> Iterator[None]:
    start = time.perf_counter()
    try:
        yield
    finally:
        record(stage, time.perf_counter() - start)


def cycle_stages() -> Dict[str, float]:
    """A snapshot of this cycle's spans."""
    with _stages_lock:
        return dict(_stages)


def reset_cycle() -> None:
    """Forget every recorded span. The daemon calls this at cycle start,
    so a cached-health cycle does not re-report the last probe's cost and
    a deadline-missed labeler contributes no span until it finishes."""
    with _stages_lock:
        _stages.clear()


def cycle_summary() -> str:
    """One-line ``stage=N.NNNms`` rendering of every recorded span, the
    total first."""
    items = sorted(
        cycle_stages().items(), key=lambda kv: (kv[0] != "labelgen.total", kv[0])
    )
    return " ".join(f"{k}={v * 1e3:.3f}ms" for k, v in items)


def write_timings_file(path: str) -> None:
    """Dump the recorded spans as ``{"stages_ms": {stage: ms}}`` JSON
    (--timings-file) through the label file's atomic writer. Failures are
    logged, never fatal: timings are observability, not labels."""
    if not path:
        return
    from gpu_feature_discovery_tpu_torch.lm.labels import _write_file_atomically

    doc = {"stages_ms": {k: round(v * 1e3, 3) for k, v in cycle_stages().items()}}
    try:
        _write_file_atomically(path, json.dumps(doc, sort_keys=True).encode(), 0o644)
    except OSError as e:
        log.warning("cannot write timings file %s: %s", path, e)
