"""Physics post-processing: sectional losses, crosstalk, CMT propagation."""
from .losses import (
    DesignArrays,
    EnhancedLossCalculator,
    LossCalculator,
    ModeBatch,
    VectorialLossCalculator,
    build_design_params,
    modes_to_batch,
)

__all__ = [
    "ModeBatch",
    "DesignArrays",
    "modes_to_batch",
    "build_design_params",
    "EnhancedLossCalculator",
    "VectorialLossCalculator",
    "LossCalculator",
]
