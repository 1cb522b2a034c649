from boslam_tpu_torch.features.frontend import (
    FrameFeatures, extract_features, extract_features_from_levels,
)

__all__ = ["FrameFeatures", "extract_features", "extract_features_from_levels"]
