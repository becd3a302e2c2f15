"""gpu-feature-discovery on PyTorch and CUDA: the NVIDIA H100 port of
``gpu_feature_discovery_tpu``.

Twin: ``gpu_feature_discovery_tpu/__init__.py``. This package runs the
supervised label daemon (or one ``--oneshot`` cycle), with the
``--with-burnin`` device probe, on CUDA devices and publishes the
``nvidia.com/gpu.*`` label family to the Node Feature Discovery "local"
feature source. It imports ``torch`` and never the JAX package: every
module it needs is a trimmed copy of its twin at the same relative path
(``lm/tpu.py`` becomes ``lm/gpu.py``).

Layer map (outer to inner):

- ``cmd``       : CLI entry point, reload loop, daemon loop, supervisor,
                  reconcile events
- ``config``    : flag table with ``TFD_*`` environment aliases, the
                  versioned config file and its YAML-subset parser
- ``lm``        : label engine, label sources, health labeler, atomic
                  churn-free file write
- ``sandbox``   : the probe sandbox and the persistent broker worker
                  (device probing in a killable child process), persisted
                  last-good labels, anti-flap hysteresis
- ``resource``  : the backend registry (one backend per label family),
                  CUDA and NVML device managers, the host cpu manager,
                  static mocks
- ``models``    : per-card spec table (plausibility peaks)
- ``ops``       : burn-in (timed as a CUDA graph), HBM stream-sum kernel,
                  CUDA-event device clock
- ``utils``     : backoff policy, bounded fan-out pool, per-cycle
                  timings, logging, fault injection (``TFD_FAULT_SPEC``)

Importing any module initialises no CUDA context: the probe builds and
launches kernels only when a cycle runs, and under the broker (the
daemon's default) only in the worker process.
"""
