"""ops (twin: ``gpu_feature_discovery_tpu/ops/``). The twin re-exports its
probe functions here; the port does not, since ``ops/healthcheck.py``
imports torch and no port module may load it at import. Import them from
``ops.healthcheck``."""
