from gpu_feature_discovery_tpu_torch.info.version import VERSION, get_version_string

__all__ = ["VERSION", "get_version_string"]
