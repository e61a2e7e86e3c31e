"""Plain reference of the vectorial configurations: the H-field
operators assembled on the reference's own mesh (they do not depend on
the wavelength: no dispersion), each returned design held to them, and
the exact guided modes of a design (``solve.vectorial_modes``)."""
from __future__ import annotations

import numpy as np

from . import fem, geometry, judge, mesh, solve


class Checker:
    def __init__(self, cfg: dict):
        self.cfg = cfg
        lan = geometry.lantern(cfg["geometry"], cfg["mesh"]["wavelength_um"])
        self.mesh = mesh.build(lan, cfg["mesh"])
        self.alpha = float(cfg["solver"].get("alpha_penalty", 1.0))
        self.n_modes = int(cfg["n_modes"])
        self.k = int(cfg["correct"]["reference_k"])
        self.ops = fem.vectorial(self.mesh, lan, self.alpha)
        self.scalar_parts = fem.scalar_parts(self.mesh, lan)
        self.core = fem.in_core(self.mesh, lan)

    def lantern(self, wavelength_um: float):
        return geometry.lantern(self.cfg["geometry"], wavelength_um)

    def numbers(self, wavelength_um: float, out: list) -> dict:
        """The compared numbers of the program's modes ``out`` of the
        design at ``wavelength_um``."""
        return judge.vectorial(out, self.n_modes,
                               self.lantern(wavelength_um).k0, self.ops,
                               self.core)

    def exact(self, wavelength_um: float, dtype=np.float64) -> list:
        """The reference's guided modes of the design, as the program
        returns them (``dtype=np.float32``: the control)."""
        return solve.vectorial_modes(self.mesh, self.lantern(wavelength_um),
                                     self.alpha, self.k, dtype=dtype,
                                     ops=self.ops,
                                     scalar_parts=self.scalar_parts)
