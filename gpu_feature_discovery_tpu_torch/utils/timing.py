"""Per-cycle stage timing, a view over the metrics registry (twin:
``gpu_feature_discovery_tpu/utils/timing.py``).

Spans are stored in ``obs.metrics``: the per-cycle stage store, the
``tfd_stage_duration_seconds`` gauge and the
``tfd_labeler_duration_seconds`` / ``tfd_cycle_duration_seconds``
histograms. Two views render from that one store: the
``cycle_summary()`` log line the daemon writes after every cycle, and
the ``--timings-file`` JSON document (``{"stages_ms": {stage: ms}}``, ms
rounded to 3 decimals, sorted keys — the twin's schema).
"""

from __future__ import annotations

import json
import logging
import time
from contextlib import contextmanager
from typing import Iterator

from gpu_feature_discovery_tpu_torch.obs import metrics as obs_metrics

log = logging.getLogger("tfd.timing")


def record(stage: str, elapsed: float) -> None:
    """Record a named span's duration (seconds)."""
    obs_metrics.observe_stage(stage, elapsed)
    log.debug("stage %s took %.3f ms", stage, elapsed * 1e3)


@contextmanager
def timed(stage: str) -> Iterator[None]:
    start = time.perf_counter()
    try:
        yield
    finally:
        record(stage, time.perf_counter() - start)


def reset_cycle() -> None:
    """Forget every recorded span. The daemon calls this at cycle start,
    so a cached-health cycle does not re-report the last probe's cost and
    a deadline-missed labeler contributes no span until it finishes. The
    histograms are cumulative and are not reset."""
    obs_metrics.reset_cycle_stages()


def cycle_summary() -> str:
    """One-line ``stage=N.NNNms`` rendering of every recorded span, the
    total first."""
    items = sorted(obs_metrics.cycle_stages().items(),
                   key=lambda kv: (kv[0] != "labelgen.total", kv[0]))
    return " ".join(f"{k}={v * 1e3:.3f}ms" for k, v in items)


def write_timings_file(path: str) -> None:
    """Dump the recorded spans as ``{"stages_ms": {stage: ms}}`` JSON
    (--timings-file) through the label file's atomic writer. Failures are
    logged, never fatal: timings are observability, not labels."""
    if not path:
        return
    from gpu_feature_discovery_tpu_torch.lm.labels import _write_file_atomically

    doc = {"stages_ms": {k: round(v * 1e3, 3)
                         for k, v in obs_metrics.cycle_stages().items()}}
    try:
        _write_file_atomically(path, json.dumps(doc, sort_keys=True).encode(), 0o644)
    except OSError as e:
        log.warning("cannot write timings file %s: %s", path, e)
