"""topology (twin: ``gpu_feature_discovery_tpu/topology/``): the node's
GPUs grouped by MIG mode for the strategy engine."""

from gpu_feature_discovery_tpu_torch.topology.slice_info import SliceInfo

__all__ = ["SliceInfo"]
