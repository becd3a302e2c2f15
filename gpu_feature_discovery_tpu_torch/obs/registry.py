"""Dependency-free Prometheus metrics registry (twin:
``gpu_feature_discovery_tpu/obs/registry.py``).

Counter, Gauge and Histogram with fixed buckets and labelsets, rendered
in text exposition format 0.0.4, byte for byte as the twin renders them
for the same operations (tests/test_torch_obs.py holds the two renders
equal).

Every value mutation and the render walk take the one registry-wide
lock: the engine's worker threads record while the HTTP server renders,
and one lock makes a render a consistent snapshot. Names are checked at
registration (metric ``[a-zA-Z_:][a-zA-Z0-9_:]*``, label
``[a-zA-Z_][a-zA-Z0-9_]*``), so a typo fails at import, not at a scrape.
"""

from __future__ import annotations

import math
import re
import threading
from bisect import bisect_left
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

_METRIC_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_NAME_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

# Duration buckets (seconds) of every tfd_* histogram: a cached cycle is
# sub-millisecond, a first probe several seconds, a worker spawn ~10 s.
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
)

CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def _escape_help(text: str) -> str:
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def _escape_label_value(text: str) -> str:
    return text.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _format_value(v: float) -> str:
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if math.isnan(v):
        return "NaN"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


class _Metric:
    """One family: name, help, label names and its children, created on
    first ``labels()`` use. A label-less family gets its one child at
    registration, so it renders (as zero) from process start.

    A child mutates under the registry lock it carries; ``render()``
    holds the same lock and reads values directly, so no child method is
    called from inside the render walk (the lock is not reentrant)."""

    kind = "untyped"

    def __init__(
        self,
        name: str,
        help_text: str,
        labelnames: Sequence[str],
        lock: threading.Lock,
    ):
        if not _METRIC_NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for ln in labelnames:
            if not _LABEL_NAME_RE.match(ln) or ln.startswith("__"):
                raise ValueError(f"invalid label name {ln!r} on {name}")
        self.name = name
        self.help = help_text
        self.labelnames = tuple(labelnames)
        self._lock = lock
        self._children: Dict[Tuple[str, ...], object] = {}
        if not self.labelnames:
            self._children[()] = self._new_child()

    def _new_child(self):
        raise NotImplementedError

    def labels(self, **labelvalues: str):
        try:
            key = tuple([str(labelvalues[ln]) for ln in self.labelnames])
        except KeyError:
            key = None
        if key is None or len(labelvalues) != len(key):
            raise ValueError(
                f"{self.name}: got labels {sorted(labelvalues)}, "
                f"want {sorted(self.labelnames)}"
            )
        # Children are only ever added, under the lock, and a dict read
        # is atomic: an existing child costs one probe, no lock.
        child = self._children.get(key)
        if child is not None:
            return child
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._new_child()
                self._children[key] = child
            return child

    def _default_child(self):
        if self.labelnames:
            raise ValueError(f"{self.name} needs labels {self.labelnames}")
        return self._children[()]

    def _label_str(self, key: Tuple[str, ...], extra: str = "") -> str:
        pairs = [
            f'{ln}="{_escape_label_value(lv)}"'
            for ln, lv in zip(self.labelnames, key)
        ]
        if extra:
            pairs.append(extra)
        return "{" + ",".join(pairs) + "}" if pairs else ""

    def _reset(self) -> None:
        """Drop labeled children, zero the label-less one (tests)."""
        self._children = {}
        if not self.labelnames:
            self._children[()] = self._new_child()

    def render(self) -> List[str]:
        lines = [
            f"# HELP {self.name} {_escape_help(self.help)}",
            f"# TYPE {self.name} {self.kind}",
        ]
        for key in sorted(self._children):
            lines.extend(self._render_child(key, self._children[key]))
        return lines

    def _render_child(self, key, child) -> List[str]:
        raise NotImplementedError


class _ValueChild:
    """A counter's or a gauge's one value."""

    __slots__ = ("value", "_lock")

    def __init__(self, lock: threading.Lock):
        self.value = 0.0
        self._lock = lock

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self.value += amount


class _CounterChild(_ValueChild):
    __slots__ = ()

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters can only go up")
        super().inc(amount)


class _GaugeChild(_ValueChild):
    __slots__ = ()

    def set(self, value: float) -> None:
        with self._lock:
            self.value = float(value)


class _ValueMetric(_Metric):
    def inc(self, amount: float = 1.0) -> None:
        self._default_child().inc(amount)

    def value(self, **labelvalues: str) -> float:
        child = self.labels(**labelvalues) if labelvalues else self._default_child()
        with self._lock:
            return child.value

    def _render_child(self, key, child) -> List[str]:
        return [f"{self.name}{self._label_str(key)} {_format_value(child.value)}"]


class Counter(_ValueMetric):
    kind = "counter"

    def _new_child(self) -> _CounterChild:
        return _CounterChild(self._lock)


class Gauge(_ValueMetric):
    kind = "gauge"

    def _new_child(self) -> _GaugeChild:
        return _GaugeChild(self._lock)

    def set(self, value: float) -> None:
        self._default_child().set(value)


class _HistogramChild:
    __slots__ = ("counts", "sum", "_lock", "_bounds")

    def __init__(self, bounds: Sequence[float], lock: threading.Lock):
        self.counts = [0] * (len(bounds) + 1)  # per bucket, not cumulative
        self.sum = 0.0
        self._bounds = bounds
        self._lock = lock

    def observe(self, value: float) -> None:
        with self._lock:
            self._add(value)

    def _add(self, value: float) -> None:
        """One observation; the caller holds the lock. The first bucket
        whose bound is >= value; NaN, never <= a bound, and values past
        the last bound land in +Inf."""
        i = bisect_left(self._bounds, value) if value == value else len(self._bounds)
        self.sum += value
        self.counts[i] += 1


class Histogram(_Metric):
    kind = "histogram"

    def __init__(
        self,
        name: str,
        help_text: str,
        labelnames: Sequence[str],
        lock: threading.Lock,
        buckets: Optional[Iterable[float]] = None,
    ):
        bounds = tuple(buckets if buckets is not None else DEFAULT_BUCKETS)
        if list(bounds) != sorted(bounds) or len(set(bounds)) != len(bounds):
            raise ValueError(f"{name}: buckets must strictly increase")
        if bounds and math.isinf(bounds[-1]):
            bounds = bounds[:-1]  # +Inf is implicit
        self.bounds = bounds
        super().__init__(name, help_text, labelnames, lock)

    def _new_child(self) -> _HistogramChild:
        return _HistogramChild(self.bounds, self._lock)

    def observe(self, value: float, **labelvalues: str) -> None:
        child = self.labels(**labelvalues) if labelvalues else self._default_child()
        child.observe(value)

    def observe_children(self, pairs: Iterable[Tuple["_HistogramChild", float]]) -> None:
        """Observe each ``(child, value)`` (children of this family, from
        ``labels()``) under one acquisition of the lock."""
        with self._lock:
            for child, value in pairs:
                child._add(value)

    def _render_child(self, key, child) -> List[str]:
        lines = []
        cumulative = 0
        for bound, count in zip(self.bounds, child.counts):
            cumulative += count
            extra = 'le="%s"' % _format_value(bound)
            lines.append(f"{self.name}_bucket{self._label_str(key, extra)} {cumulative}")
        cumulative += child.counts[-1]
        inf_extra = 'le="+Inf"'
        lines.append(f"{self.name}_bucket{self._label_str(key, inf_extra)} {cumulative}")
        lines.append(f"{self.name}_sum{self._label_str(key)} {_format_value(child.sum)}")
        lines.append(f"{self.name}_count{self._label_str(key)} {cumulative}")
        return lines


class Registry:
    """Metric families by name; ``render()`` is the /metrics payload."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: Dict[str, _Metric] = {}

    def _register(self, metric: _Metric) -> _Metric:
        with self._lock:
            if metric.name in self._families:
                raise ValueError(f"metric {metric.name!r} already registered")
            self._families[metric.name] = metric
        return metric

    def counter(self, name: str, help_text: str, labelnames: Sequence[str] = ()) -> Counter:
        return self._register(Counter(name, help_text, labelnames, self._lock))

    def gauge(self, name: str, help_text: str, labelnames: Sequence[str] = ()) -> Gauge:
        return self._register(Gauge(name, help_text, labelnames, self._lock))

    def histogram(
        self,
        name: str,
        help_text: str,
        labelnames: Sequence[str] = (),
        buckets: Optional[Iterable[float]] = None,
    ) -> Histogram:
        return self._register(
            Histogram(name, help_text, labelnames, self._lock, buckets=buckets)
        )

    def families(self) -> Dict[str, _Metric]:
        with self._lock:
            return dict(self._families)

    def render(self) -> str:
        """Text exposition 0.0.4: HELP and TYPE per family, samples
        sorted by labelset, a trailing newline (promtool requires it)."""
        lines: List[str] = []
        with self._lock:
            for name in sorted(self._families):
                lines.extend(self._families[name].render())
        return "\n".join(lines) + "\n"

    def reset_values(self) -> None:
        """Zero every family and drop labeled children: tests only; the
        daemon never resets (Prometheus owns counter lifetimes)."""
        with self._lock:
            for fam in self._families.values():
                fam._reset()
