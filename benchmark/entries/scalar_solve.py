"""The program's scalar entry: each design of a request is one
``ScalarHelmholtzSolver(geom, cfg).solve(dg, n_modes,
mode_filter="cascade")`` on the configuration's fixed mesh, as the
``--scalar`` dataset pipeline solves a design."""
from __future__ import annotations

from benchmark.entries.common import Program


class System(Program):
    def request(self, wavelengths):
        from pl_fem_tpu_torch.solvers import ScalarHelmholtzSolver

        out, phases = [], {}
        for w in wavelengths:
            solver = ScalarHelmholtzSolver(self.geometry(w), self.sim)
            out.append(solver.solve(self.dg, self.n_modes,
                                    mode_filter="cascade"))
            for k, v in solver.last_solve_times.items():
                phases[k] = phases.get(k, 0.0) + v
        self.sync()
        self._phases = phases
        return out

    FIELDS = ("field_vector",)
