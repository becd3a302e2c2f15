"""native (twin: ``gpu_feature_discovery_tpu/native/``): NVML through
ctypes, the GPU counterpart of the twin's libtpu shim."""
