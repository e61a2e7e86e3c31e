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

from .config import MeshConfig, SimulationConfig, SolverConfig, solver_preset
from .constants import PHYS, PhysConst
from .models import EpsParams, MCFGeometry

__all__ = [
    "PHYS", "PhysConst", "SimulationConfig", "SolverConfig", "MeshConfig",
    "solver_preset", "MCFGeometry", "EpsParams",
    # lazy (see __getattr__)
    "TrueVectorialMaxwellSolver", "ScalarHelmholtzSolver", "MeshGenerator",
]

_LAZY = {
    "TrueVectorialMaxwellSolver": "solvers.vectorial",
    "ScalarHelmholtzSolver": "solvers.scalar",
    "MeshGenerator": "ops.femgrid",
}


def __getattr__(name):
    """Lazy exports: importing the package stays light; the solver stack
    (torch) loads on first attribute access."""
    if name in _LAZY:
        import importlib

        mod = importlib.import_module("." + _LAZY[name], __name__)
        return getattr(mod, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
