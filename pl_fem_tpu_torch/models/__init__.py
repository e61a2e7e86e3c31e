from .layouts import (
    SUPPORTED_CONFIGS,
    SUPPORTED_N_CORES,
    SAMPLING_WEIGHTS,
    build_geometry_from_sample,
    generate_core_positions,
    get_n_cores_options,
    get_sampling_weights,
    layout_info,
)
from .geometry import (
    EpsParams,
    MCFGeometry,
    MMFGeometry,
    PhotonicLantern,
    PhotonicLanternGeometry,
    TaperSection,
    taper_profile_fraction,
    epsilon_at,
)

__all__ = [
    "SUPPORTED_CONFIGS", "SUPPORTED_N_CORES", "SAMPLING_WEIGHTS",
    "build_geometry_from_sample", "generate_core_positions",
    "get_n_cores_options", "get_sampling_weights", "layout_info",
    "EpsParams", "MCFGeometry", "MMFGeometry", "PhotonicLantern",
    "PhotonicLanternGeometry", "TaperSection", "epsilon_at",
    "taper_profile_fraction",
]
