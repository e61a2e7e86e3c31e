"""Dataset generation: parametric space, samplers, records, orchestrator."""
from .bucketing import (
    bucket_key,
    canonical_scale,
    canonicalize,
    class_geometry,
    group_by_bucket,
    rescale_modes,
)
from .generator import DatasetGenerator
from .parametric_space import (
    ParametricSpace,
    PhysicalValidator,
    SampleQualityScorer,
)
from .record import DatasetRecord
from .sampling import AdaptiveSampler, SmartSampler

__all__ = [
    "ParametricSpace",
    "PhysicalValidator",
    "SampleQualityScorer",
    "SmartSampler",
    "AdaptiveSampler",
    "DatasetRecord",
    "DatasetGenerator",
    "bucket_key",
    "canonical_scale",
    "canonicalize",
    "class_geometry",
    "group_by_bucket",
    "rescale_modes",
]
