"""Eigenmode solvers (reference seam: solver_fem.py).

- :class:`ScalarHelmholtzSolver` — scalar LP approximation
  (solver_fem.py:245-276 capability).
- :class:`TrueVectorialMaxwellSolver` — vectorial H-field with divergence
  penalty (solver_fem.py:113-239 capability).

Both expose a ``backend`` switch: 'device' (factorization-free Chebyshev
subspace filter on ``SolverConfig.device`` with a host float64 polish)
and 'hybrid' (scipy ARPACK shift-invert on the host, the reference's
algorithm).
"""
from .postproc import (
    confinement_from_dofs,
    in_core_mask,
    polarization_from_powers,
    polarization_label,
)
from .scalar import ScalarHelmholtzSolver, build_scalar_pencil
from .vectorial import TrueVectorialMaxwellSolver

__all__ = ["ScalarHelmholtzSolver", "TrueVectorialMaxwellSolver",
           "build_scalar_pencil", "in_core_mask", "confinement_from_dofs",
           "polarization_from_powers", "polarization_label"]
