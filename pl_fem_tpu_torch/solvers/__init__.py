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
from .postproc import polarization_from_powers, polarization_label
from .scalar import ScalarHelmholtzSolver
from .vectorial import TrueVectorialMaxwellSolver

__all__ = ["ScalarHelmholtzSolver", "TrueVectorialMaxwellSolver",
           "polarization_from_powers", "polarization_label"]
