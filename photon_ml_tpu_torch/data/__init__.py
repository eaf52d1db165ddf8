"""The host-side data layer (port of ``photon_ml_tpu/data``): index maps
and the feature-range plan, the LIBSVM reader, feature summaries and the
synthetic generators."""

from photon_ml_tpu_torch.data.index_map import FeatureRangePlan, IndexMap, plan_feature_ranges
from photon_ml_tpu_torch.data.libsvm import read_libsvm
from photon_ml_tpu_torch.data.summary import FeatureSummary, summarize
from photon_ml_tpu_torch.data.synthetic import synthetic_game_data, synthetic_glm_data

__all__ = [
    "FeatureRangePlan",
    "FeatureSummary",
    "IndexMap",
    "plan_feature_ranges",
    "read_libsvm",
    "summarize",
    "synthetic_game_data",
    "synthetic_glm_data",
]
