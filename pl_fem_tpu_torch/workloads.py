"""The workloads that ``chip_smoke.py`` drives and ``profile_design.py``
measures, defined once.

- Config 1 (BASELINE config 1, as ``bench.py`` runs it): a 7-core
  hexagonal lantern, r 1.5 um, pitch 8 um, n_core 1.535, air clad;
  N_SWEEP wavelengths 1.50-1.64 um on one ~60k-DOF mesh
  (``mesh_min_points`` 15000, refinement 2.2, ``bucket_rounding`` 1024),
  N_MODES modes, fast mode (cheb_degree 200, cheb_passes 2,
  beta_passes 1).
- The r5 dataset: the CLI at ``configs/r5_dataset.yaml`` on DATASET_N
  of its samples with DATASET_CMT_SLICES CMT slices; the scalar
  pipeline (``--scalar``) on SCALAR_DATASET_N of them.
"""
from __future__ import annotations

from pathlib import Path

N_SWEEP = 8
N_MODES = 10
MESH_MIN = 15000
REFINE = 2.2
BUCKET_ROUNDING = 1024
R5_CONFIG = Path(__file__).resolve().parents[1] / "configs" / "r5_dataset.yaml"
DATASET_N = 8                # of the 220 samples of configs/r5_dataset.yaml
DATASET_CMT_SLICES = 5
SCALAR_DATASET_N = 4         # of the same 220, through --scalar


def config1_geom(wavelength_um: float):
    """A config-1 design at ``wavelength_um``."""
    from .models import MCFGeometry

    return MCFGeometry(7, 8.0, 1.5, 1.535, 1.0, wavelength_um=wavelength_um)


def config1_sweep():
    """The config-1 fast sweep on the card: ``(config, mesh, device grid,
    designs)``, the mesh generated at 1.55 um."""
    import numpy as np

    from .config import MeshConfig, SimulationConfig, SolverConfig
    from .ops.femgrid import MeshGenerator, export_device_grid

    cfg = SimulationConfig(
        mesh_min_points=MESH_MIN, mesh_target_points=MESH_MIN,
        mesh=MeshConfig(bucket_rounding=BUCKET_ROUNDING),
        solver=SolverConfig(device="cuda", cheb_degree=200, cheb_passes=2,
                            beta_passes=1))
    grid = MeshGenerator.generate(config1_geom(1.55), REFINE, cfg)
    dg = export_device_grid(grid, BUCKET_ROUNDING)
    geoms = [config1_geom(float(wl))
             for wl in np.linspace(1.50, 1.64, N_SWEEP)]
    return cfg, grid, dg, geoms


def dataset_argv(out_dir) -> list:
    """The CLI arguments of the r5 dataset run into ``out_dir``."""
    return ["--config", str(R5_CONFIG), "--n", str(DATASET_N),
            "--out", str(out_dir), "--cmt-slices", str(DATASET_CMT_SLICES)]


def scalar_dataset_argv(out_dir) -> list:
    """The CLI arguments of the scalar r5 dataset run into ``out_dir``."""
    return ["--config", str(R5_CONFIG), "--n", str(SCALAR_DATASET_N),
            "--out", str(out_dir), "--cmt-slices", str(DATASET_CMT_SLICES),
            "--scalar"]
