"""lm (twin: ``gpu_feature_discovery_tpu/lm/``)."""

from gpu_feature_discovery_tpu_torch.lm.labels import Labels
from gpu_feature_discovery_tpu_torch.lm.labeler import Labeler, Merge, Empty

__all__ = ["Labels", "Labeler", "Merge", "Empty"]
