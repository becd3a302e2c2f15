"""Per-cycle stage timing and the span tree, views over the metrics
registry (twin: ``gpu_feature_discovery_tpu/utils/timing.py``).

Every span is recorded once, in ``obs/spans.py``: its start and end on
CLOCK_MONOTONIC, its parent (the span open on the thread when it
started) and its labeling cycle. From that one record:

- the span tree: the ring of the last 64 cycles (``GET /debug/spans``)
  and ``tfd_span_duration_seconds{span}``, for every span;
- the per-cycle stage store of ``obs.metrics``, the
  ``tfd_stage_duration_seconds`` gauge and the
  ``tfd_labeler_duration_seconds`` / ``tfd_cycle_duration_seconds``
  histograms, for the stages ``timed`` names (the twin's set). Two views
  render from that store: the ``cycle_summary()`` log line the daemon
  writes after every cycle, and the ``--timings-file`` JSON document
  (``{"stages_ms": {stage: ms}}``, ms rounded to 3 decimals, sorted keys
  — the twin's schema). The spans ``span`` names stay out of them.

The span names are one fixed set (docs/torch/observability.md), with no
per-device or per-cycle part.
"""

from __future__ import annotations

import json
import logging
from contextlib import contextmanager
from typing import Iterator, Optional, Tuple

from gpu_feature_discovery_tpu_torch.obs import metrics as obs_metrics
from gpu_feature_discovery_tpu_torch.obs import spans

log = logging.getLogger("tfd.timing")

begin_cycle = spans.begin_cycle
end_cycle = spans.end_cycle
context = spans.context


def now_ns() -> int:
    """A stamp on the spans' clock (CLOCK_MONOTONIC, ns)."""
    return spans.now_ns()


def record(stage: str, elapsed: float) -> None:
    """Record a named stage's duration (seconds) in the stage store alone."""
    obs_metrics.observe_stage(stage, elapsed)
    log.debug("stage %s took %.3f ms", stage, elapsed * 1e3)


class Open:
    """A span begun and not yet ended: the current parent of its thread
    until ``end``, which restores the one it replaced. As a context
    manager it ends on exit."""

    __slots__ = ("name", "id", "parent", "cycle", "start", "_prev", "_stage")

    def __init__(self, name: str, start: Optional[int] = None,
                 ctx: Optional[Tuple[int, int]] = None, stage: bool = False):
        self.name = name
        self._stage = stage
        self._prev = prev = spans.context()
        self.cycle, self.parent = prev if ctx is None else ctx
        self.id = sid = spans.new_id()
        spans.set_context((self.cycle, sid))
        self.start = spans.now_ns() if start is None else start

    def end(self, end: Optional[int] = None) -> int:
        end = spans.now_ns() if end is None else end
        spans.set_context(self._prev)
        spans.record(self.name, self.start, end, self.id, self.parent, self.cycle)
        if self._stage:
            record(self.name, (end - self.start) / 1e9)
        return end

    def __enter__(self) -> "Open":
        return self

    def __exit__(self, *exc) -> None:
        self.end()


def timed(stage: str) -> Open:
    """A span that is also a stage of the cycle summary and the timings
    file: ``with timed("labelgen.total"): ...``."""
    return Open(stage, stage=True)


def span(name: str) -> Open:
    """A span of the tree alone: ``with span("labels.write"): ...``."""
    return Open(name)


@contextmanager
def adopt(ctx: Tuple[int, int]) -> Iterator[None]:
    """Run under another thread's ``context()``: a pool thread or a probe
    thread takes its parent from the thread that handed it the work."""
    prev = spans.set_context(ctx)
    try:
        yield
    finally:
        spans.set_context(prev)


def emit(name: str, start: int, end: int) -> None:
    """A span whose ends were stamped apart (``now_ns``), under the
    calling thread's current span."""
    cycle, parent = spans.context()
    spans.record(name, start, end, spans.new_id(), parent, cycle)


def reset_cycle() -> None:
    """Forget every recorded stage. The daemon calls this at cycle start,
    so a cached-health cycle does not re-report the last probe's cost and
    a deadline-missed labeler contributes no stage until it finishes. The
    histograms and the span ring are cumulative and are not reset."""
    obs_metrics.reset_cycle_stages()


def cycle_summary() -> str:
    """One-line ``stage=N.NNNms`` rendering of every recorded stage, the
    total first."""
    items = sorted(obs_metrics.cycle_stages().items(),
                   key=lambda kv: (kv[0] != "labelgen.total", kv[0]))
    return " ".join(f"{k}={v * 1e3:.3f}ms" for k, v in items)


def write_timings_file(path: str) -> None:
    """Dump the recorded stages as ``{"stages_ms": {stage: ms}}`` JSON
    (--timings-file) through the label file's atomic writer. Failures are
    logged, never fatal: timings are observability, not labels."""
    if not path:
        return
    from gpu_feature_discovery_tpu_torch.lm.labels import _write_file_atomically

    doc = {"stages_ms": {k: round(v * 1e3, 3)
                         for k, v in obs_metrics.cycle_stages().items()}}
    try:
        _write_file_atomically(path, json.dumps(doc, sort_keys=True).encode(), 0o644,
                               fsync_file="timings")
    except OSError as e:
        log.warning("cannot write timings file %s: %s", path, e)
