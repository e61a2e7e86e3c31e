"""The program's vectorial entry: one request is one
``TrueVectorialMaxwellSolver.solve_sweep(geoms, dg, n_modes, cfg)`` of
the request's designs on the configuration's fixed mesh."""
from __future__ import annotations

from benchmark.entries.common import Program


class System(Program):
    def request(self, wavelengths):
        from pl_fem_tpu_torch.solvers import TrueVectorialMaxwellSolver

        geoms = [self.geometry(w) for w in wavelengths]
        out = TrueVectorialMaxwellSolver.solve_sweep(
            geoms, self.dg, self.n_modes, self.sim)
        self.sync()
        self._phases = dict(TrueVectorialMaxwellSolver.last_sweep_times)
        return out

    FIELDS = ("Ex_dofs", "Ey_dofs", "Hz_dofs")
