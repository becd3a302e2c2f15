"""Persisted label state and anti-flap hysteresis (twin:
``gpu_feature_discovery_tpu/sandbox/``). The twin's probe sandbox and
broker are a later slice of this port."""
