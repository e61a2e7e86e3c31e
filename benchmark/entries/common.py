"""What the entries share: the program's configuration, geometry and
fixed mesh built from a configuration file."""
from __future__ import annotations


class Program:
    """The system under test, set up from a configuration (``cfg``, the
    parsed ``configs/<name>.json``): its ``SimulationConfig`` with
    ``SolverConfig.seed`` from the run's seed, and the device grid of
    the configuration's mesh. ``request`` returns one mode list per design;
    ``phases`` the program's phase seconds of the last request."""

    FIELDS = ()

    def __init__(self, cfg: dict, seed: int, device: str = "cuda"):
        from pl_fem_tpu_torch.config import simulation_config_from_dict
        from pl_fem_tpu_torch.ops.femgrid import (MeshGenerator,
                                                  export_device_grid)

        self.cfg = cfg
        self.device = device
        mesh = cfg["mesh"]
        self.sim = simulation_config_from_dict({
            "mesh_min_points": mesh["mesh_min_points"],
            "mesh_target_points": mesh["mesh_target_points"],
            "mesh": {"bucket_rounding": mesh["bucket_rounding"]},
            "solver": {**cfg["solver"], "seed": int(seed),
                       "device": device}})
        self.n_modes = int(cfg["n_modes"])
        grid = MeshGenerator.generate(self.geometry(mesh["wavelength_um"]),
                                      mesh["refinement"], self.sim)
        self.dg = export_device_grid(grid, mesh["bucket_rounding"])
        if mesh.get("n_dofs") and self.dg.n_dofs != int(mesh["n_dofs"]):
            raise RuntimeError(f"the mesh has {self.dg.n_dofs} DOFs, the "
                               f"configuration states {mesh['n_dofs']}")
        self._phases = {}

    def geometry(self, wavelength_um: float):
        from pl_fem_tpu_torch.models import MCFGeometry

        g = self.cfg["geometry"]
        return MCFGeometry(int(g["n_cores"]), float(g["pitch_um"]),
                           float(g["core_radius_um"]), float(g["n_core"]),
                           float(g["n_clad"]), wavelength_um=wavelength_um,
                           pml_thickness=float(g["pml_thickness_um"]))

    def sync(self):
        if self.device.startswith("cuda"):
            import torch

            torch.cuda.synchronize()

    def phases(self) -> dict:
        return dict(self._phases)

    def keep(self, out):
        """The request's mode lists as the comparison reads them: every
        mode's numbers, and the fields of the first ``n_modes`` only."""
        kept = []
        for modes in out:
            kept.append([m if i < self.n_modes else
                         {k: v for k, v in m.items() if k not in self.FIELDS}
                         for i, m in enumerate(modes)])
        return kept

    def close(self):
        self.dg = None
