"""Eigenmode solvers (reference seam: solver_fem.py).

:class:`TrueVectorialMaxwellSolver` — vectorial H-field with divergence
penalty (solver_fem.py:113-239 capability): a Chebyshev subspace filter
on the device with a host float64 polish.
"""
from .postproc import polarization_from_powers, polarization_label
from .vectorial import TrueVectorialMaxwellSolver

__all__ = ["TrueVectorialMaxwellSolver", "polarization_from_powers",
           "polarization_label"]
