"""Observability plane: the metrics registry and the HTTP introspection
server (twin: ``gpu_feature_discovery_tpu/obs/``).

``registry`` holds the dependency-free Prometheus primitives (counter,
gauge, histogram, text exposition 0.0.4); ``metrics`` declares every
``tfd_*`` family the port publishes and the per-cycle stage store that
utils/timing.py renders from; ``spans`` the span tree behind
utils/timing.py (the ring of the last 64 cycles, the gap split);
``server`` serves ``/metrics``, ``/healthz``, ``/readyz``,
``/debug/labels``, ``/debug/spans`` and ``POST /probe``.

This package imports nothing else of the port, and no torch: the
instrumented layers call into it, so it can never create an import
cycle, and serving metrics never pulls CUDA into the labeling process.
"""
