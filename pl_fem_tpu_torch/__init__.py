"""pl_fem_tpu_torch — the photonic-lantern FEM eigensolvers in PyTorch,
with hand-written CUDA and Triton kernels for NVIDIA Hopper.

A port of the JAX package ``pl_fem_tpu`` (which stays the reference):
host meshing and export, device assembly, the packed same-grid
Chebyshev-filter eigensolver and the host f64 polish of the vectorial
H-field modes, the scalar Helmholtz solver, the host ARPACK ('hybrid')
backend of both, the loss model and CMT (``physics``), the dataset
engine (``dataset``) and its CLI (``python -m pl_fem_tpu_torch.cli``).
It imports neither jax nor ``pl_fem_tpu``.

The solver device is explicit: ``SolverConfig.device`` (default
``"cuda"``). On CUDA tensors the filter runs the kernels in
``ops/csrc`` (built with nvcc at first use into ``_build/``) and
``ops/triton_kernels.py``; on CPU tensors it runs their plain PyTorch
twins.
"""

__version__ = "0.1.0"

from .config import (
    MeshConfig,
    PhotonicLanternDesignParameters,
    PhysicalConstants,
    SimulationConfig,
    SolverConfig,
    solver_preset,
)
from .constants import PHYS, PhysConst
from .materials import Air, IPDipCauchy, Silica
from .models import (
    EpsParams,
    MCFGeometry,
    MMFGeometry,
    PhotonicLantern,
    PhotonicLanternGeometry,
    TaperSection,
)

__all__ = [
    "PHYS", "PhysConst", "PhysicalConstants", "SimulationConfig",
    "SolverConfig", "MeshConfig", "PhotonicLanternDesignParameters",
    "solver_preset", "IPDipCauchy", "Silica", "Air",
    "MCFGeometry", "MMFGeometry", "PhotonicLantern",
    "PhotonicLanternGeometry", "TaperSection", "EpsParams",
    # lazy (see __getattr__)
    "ScalarHelmholtzSolver", "TrueVectorialMaxwellSolver",
    "LossCalculator", "EnhancedLossCalculator", "VectorialLossCalculator",
    "CoupledModeTheory", "MeshGenerator",
    "DatasetGenerator", "DatasetRecord", "SmartSampler", "AdaptiveSampler",
    "ParametricSpace",
]

_LAZY = {
    "TrueVectorialMaxwellSolver": "solvers.vectorial",
    "ScalarHelmholtzSolver": "solvers.scalar",
    "LossCalculator": "physics",
    "EnhancedLossCalculator": "physics",
    "VectorialLossCalculator": "physics",
    "CoupledModeTheory": "physics.cmt",
    "MeshGenerator": "ops.femgrid",
    "DatasetGenerator": "dataset",
    "DatasetRecord": "dataset",
    "SmartSampler": "dataset",
    "AdaptiveSampler": "dataset",
    "ParametricSpace": "dataset",
}


def __getattr__(name):
    """Lazy exports: importing the package stays light; the solver,
    physics and dataset stacks (torch) load on first attribute access."""
    if name in _LAZY:
        import importlib

        mod = importlib.import_module("." + _LAZY[name], __name__)
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
