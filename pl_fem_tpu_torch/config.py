"""Configuration dataclasses.

The reference imports ``SimulationConfig``/``PhysicalConstants``/
``PhotonicLanternDesignParameters`` from a config module that is absent
from its snapshot (see the reference's mesh.py:41, solver_fem.py:37,
losses.py:761). The field sets below are reconstructed from the call
sites that consume them:

- ``SimulationConfig``: mesh.py:109,186,313-314 (enable_mesh_cache,
  cache_max_size, mesh_min_points, mesh_target_points) and sampling.py.
- ``PhotonicLanternDesignParameters``: the authoritative 30-field
  constructor call at losses.py:956-988.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from .constants import PhysConst

# Re-export under the name used by the reference imports.
PhysicalConstants = PhysConst


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Eigensolver knobs (new to this framework)."""

    # 'device': Chebyshev filter on ``device`` + host f64 polish;
    # 'hybrid': scipy ARPACK shift-invert on the host CSR pencil (the
    # reference's algorithm; parity oracle and CPU fallback)
    backend: str = "device"
    # torch device the filter runs on ('cuda', 'cuda:1', 'cpu'); the
    # kernels launch only for CUDA tensors, CPU runs their plain twins
    device: str = "cuda"
    # seed of the torch.Generator that draws the random start subspace
    # and the bootstrap seed's noise blend
    seed: int = 11
    scalar_tol: float = 1e-8        # relative residual target
    cheb_degree: int = 600          # Chebyshev fold-filter degree per pass
    cheb_passes: int = 4            # filter->Rayleigh-Ritz passes
    extra_vectors: int = 12         # solve k = n_modes_target + extra (solver_fem.py:196)
    alpha_penalty: float = 1.0      # divergence penalty alpha_p (solver_fem.py:158)
    beta_passes: int = 2            # fixed-beta refinement passes
    # Chebyshev B^{-1} degree inside the filter. None = AUTO: 1 in
    # BOOTSTRAPPED fast mode (beta_passes == 1 with a two-grid seed;
    # the shallow B^{-1} only steers an already-warm subspace) and 4
    # everywhere else (from a cold random start binv=1 loses ~6e-3
    # n_eff, and the accuracy-mode beta-jitter pooled polish plateaus
    # near 8e-5 on a binv=1 subspace). 0 = exact HRZ-lumped diagonal
    # mass inverse (cheapest per step but its spectrum distortion lets
    # grid-rough junk below the guided cluster at air-clad contrast —
    # kept for experiments, not production).
    binv_degree: Optional[int] = None
    # two-grid spectral bootstrap: solve on a ~6x-coarser mesh first and
    # prolong the Ritz vectors as the fine filter's starting subspace
    # (cuts fine filter passes and centers beta without a beta pass)
    bootstrap: bool = True
    bootstrap_min_dofs: int = 6000  # fine problems below this skip it
    # fine filter passes per OUTER (beta) round on the prolonged
    # subspace; 1 suffices — accuracy comes from beta_passes >= 2
    # (see solve_sweep), not from deeper in-round filtering.
    bootstrap_fine_passes: int = 1
    # outer-round stop: the polished roots' full-space quadratic
    # residual must fall below this (relative to k0^2 |h|); the
    # beta-drift criterion alone froze bootstrapped solves one round
    # too early (~4e-4 n_eff bias at production size)
    polish_qres_tol: float = 2e-5
    # cap on qres-gated outer rounds when beta_passes >= 2. None keeps
    # the accuracy-mode legacy max(beta_passes, 6); the BALANCED preset
    # sets a small cap so a design that misses its (looser) qres tol
    # stops burning re-filter rounds chasing a 2e-6-grade subspace it
    # does not need (see solver_preset).
    qres_max_rounds: Optional[int] = None
    # bucket-member operator correction in the f64 polish (round-5;
    # docs/PARITY_r3.md §A): 'deform' re-assembles each core's
    # interface annulus on a radially deformed, member-CONFORMING
    # geometry (ops/host_assembly.py member_deformed_coords) — removes
    # the ~1e-4 non-conforming-interface bucket floor; 'mask' keeps the
    # round-3 indicator-only correction. 'deform' falls back to 'mask'
    # per member when the map is inapplicable (moved centers, tangled
    # deformed elements).
    member_correction: str = "deform"
    # diagnostic mode: validate geometry inputs for finiteness before
    # the sweep and finite-check each design's filter subspace per
    # round. A diverged/NaN design is DIAGNOSED
    # (solve_sweep.last_sweep_diagnostics) instead of emitting a
    # garbage beta, and healthy sweep members keep solving.
    debug_checks: bool = False


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Host mesher + static-shape export knobs."""

    refinement: float = 1.0
    mesh_min_points: int = 9000       # refined until >= this (mesh.py:313)
    mesh_target_points: int = 18000   # explosion guard at 2.5x (mesh.py:325)
    max_refinement_iterations: int = 5
    semi_refine: bool = True          # 50% partial refine step (mesh.py:330-332)
    bucket_rounding: int = 4096       # pad element/DOF counts to multiples
    # width of one radius/pitch bucket class (dataset/bucketing.py):
    # 0.05 = accuracy-safe (~1e-4 bucket n_eff floor); 0.20 collapses a
    # 220-sample LHS from 146 to 71 buckets (better sweep amortization)
    # while member interfaces stay inside the class mesh's refinement
    # ring — accuracy_class on each record documents the tradeoff.
    # SAFE CEILING ~0.23: past it the worst-case member interface
    # ((1+band)**-0.5 * r_class) leaves the 0.90*r refinement ring
    # (bucketing.check_band warns).
    bucket_ratio_band: float = 0.05
    min_edge_factor: float = 0.0      # optional floor on local edge length
    # isoparametric curved interface elements: P2 edge midpoints on
    # material circles sit on the ARC and the element map carries a
    # per-quadrature-point Jacobian — cuts the interface term of the
    # n_eff discretization error (dominant at high index contrast)
    curved_interfaces: bool = True
    # mesh-quality gate (reference seam: mesh.py:527-569). 'warn'
    # analyzes every generated mesh, logs failures and records the
    # verdict on the grid (FEMGrid.quality_ok/_msg -> DatasetRecord);
    # 'strict' raises so the dataset engine skip-and-records the
    # design; 'off' skips the analyzer entirely.
    quality_gate: str = "warn"


@dataclasses.dataclass(frozen=True)
class SimulationConfig:
    """Top-level simulation configuration (reference seam, rebuilt)."""

    # mesh (names match the reference call sites, mesh.py:109,186,313-314)
    enable_mesh_cache: bool = True
    cache_max_size: int = 150
    mesh_min_points: int = 9000
    mesh_target_points: int = 18000

    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    solver: SolverConfig = dataclasses.field(default_factory=SolverConfig)

    n_modes_target: Optional[int] = None   # default: ceil(2.8 * n_cores)
    use_pml: bool = True
    use_cauchy_dispersion: bool = False
    wavelength_nm: float = 1550.0

    # CMT taper sampling: the narrowest cross-section solved is
    # geometry * cmt_min_scale (full collapse is unmeshable and the
    # modes below ~0.35 scale are cladding-guided; reference analog:
    # the implicit clamp in its taper sampling). The z -> scale map
    # follows the sampled taper_profile (models/geometry.py
    # ``taper_profile_fraction``).
    cmt_min_scale: float = 0.35
    # CMT engine knobs (reference seams: the reference's config.py
    # 274-322 'rigorous' FEM-overlap coupling, 163-206 RK45 integrator)
    cmt_coupling: str = "approximate"   # 'approximate' | 'rigorous'
    cmt_adaptive: bool = False          # RK45 instead of piecewise expm
    # overlap fields: full transverse (hx, hy) stack (True) or the
    # hx component only (False, round-2 behavior)
    cmt_full_field: bool = True
    # dataset bucket pipeline depth: while bucket N runs its host f64
    # polish / losses (device idle), bucket N+1's device filter
    # dispatches from a second thread. 1 = serial (round-4 behavior).
    # Depths > 2 add host contention on this 1-core VM, not overlap.
    pipeline_buckets: int = 2

    def derived_mesh(self) -> MeshConfig:
        return dataclasses.replace(
            self.mesh,
            mesh_min_points=self.mesh_min_points,
            mesh_target_points=self.mesh_target_points,
        )


@dataclasses.dataclass
class PhotonicLanternDesignParameters:
    """Design-parameter bundle consumed by the loss model.

    Field list reconstructed verbatim from the constructor call at
    the reference's losses.py:956-988 (the only authoritative spec).
    """

    # topology
    N_cores: int = 7
    has_central_core: bool = True
    config_type: str = "hexagonal"
    geometry_config: str = "7-hexagonal"
    n_peripheral_cores: int = 6
    R_ring: float = 8.0
    packing_efficiency: float = 0.5
    pitch: float = 8.0
    pitch_min: float = 8.0
    pitch_ratio: float = 3.3

    # optics
    wavelength: float = 1550.0        # nm
    r_core_SM: float = 1.2
    r_clad_SM: float = 62.5
    n_core_SM: float = 1.53
    n_clad_SM: float = 1.0
    V_SM: float = 5.0
    NA_SM: float = 1.0
    MFD: float = 3.0
    n_eff_LP01: float = 1.45
    r_core_MM: float = 25.0
    V_MM: float = 12.0
    NA_MM: float = 0.22
    M_max: int = 40

    # materials / assembly
    n_polymer: float = 1.53
    d_polymer: float = 2.0
    coupling_uniformity: float = 0.95

    # longitudinal sections [um]
    L_mux: float = 200.0
    L_taper: float = 375.0
    L_MMF: float = 100.0
    L_total: float = 675.0
    n_taper: float = 1.0
    taper_profile: str = "exponential"


# Named solver presets. Values are SolverConfig field overrides; the
# 'balanced' numbers come from the round-5 analytic-truth calibration
# sweep (scratch/balanced_calib.py; docs/STATUS_round5.md) targeting the
# reference's 5e-5 accuracy gate (the reference's README.md:44) at a
# fraction of accuracy-mode cost: beta_passes=2 removes fast mode's
# ~4e-4 prolonged-subspace root bias, the loosened qres tol stops the
# outer loop once roots certify at the 5e-5 class instead of chasing
# the 2e-6 plateau, and the round cap bounds the worst case.
# Measured (production 15k-pt mesh, flagship air-clad hex vs exact
# dispersion, 2026-08-20): fast 1.1e-3 n_eff; tol=2.5e-4/cap 2 ->
# 4.5e-5 at ~4x fast cost; tol=1.2e-4/cap 3 -> 4.3e-5 at ~11x;
# tol=6e-5/cap 4 -> 3.4e-5 at ~10x. The ~4e-5 floor is the
# beta_passes=2 polish class, not the qres gate, so the cheapest
# passing combo is the preset.
SOLVER_PRESETS = {
    "fast": {"beta_passes": 1},
    "balanced": {"beta_passes": 2, "polish_qres_tol": 2.5e-4,
                 "qres_max_rounds": 2},
    "accuracy": {"beta_passes": 2},
}


def solver_preset(name: str, **overrides) -> SolverConfig:
    """Build a SolverConfig from a named preset plus field overrides.

    ``fast`` (~8e-4 n_eff, dataset throughput), ``balanced`` (the
    reference's 5e-5 gate class), ``accuracy`` (~2e-6 n_eff, qres-gated
    to the f32-filter/f64-polish plateau).
    """
    if name not in SOLVER_PRESETS:
        raise ValueError(f"unknown solver preset {name!r}; expected one "
                         f"of {sorted(SOLVER_PRESETS)}")
    kw = dict(SOLVER_PRESETS[name])
    kw.update(overrides)
    return SolverConfig(**kw)


def simulation_config_from_dict(d: dict) -> SimulationConfig:
    """Build a SimulationConfig from a (nested) plain dict.

    Top-level keys are SimulationConfig fields; ``solver`` and ``mesh``
    sub-dicts map onto SolverConfig / MeshConfig. Unknown keys raise —
    a silently ignored typo in a config file is worse than an error.
    """
    d = dict(d or {})
    sub = {}
    for name, cls_ in (("solver", SolverConfig), ("mesh", MeshConfig)):
        if name in d:
            kw = dict(d.pop(name) or {})
            # solver: {preset: fast|balanced|accuracy, <overrides>...}
            preset = kw.pop("preset", None) if cls_ is SolverConfig \
                else None
            known = {f.name for f in dataclasses.fields(cls_)}
            unknown = set(kw) - known
            if unknown:
                raise ValueError(f"unknown {name} config keys: "
                                 f"{sorted(unknown)}")
            sub[name] = solver_preset(preset, **kw) if preset \
                else cls_(**kw)
    known = {f.name for f in dataclasses.fields(SimulationConfig)}
    unknown = set(d) - known
    if unknown:
        raise ValueError(f"unknown simulation config keys: "
                         f"{sorted(unknown)}")
    return SimulationConfig(**d, **sub)


def load_config_file(path) -> dict:
    """Parse a YAML (or JSON — YAML superset) config file to a dict.

    Reference seam: the reference README advertises ``--config
    configs/full_dataset.yaml`` (README.md:216) with no loader in its
    snapshot; this is that loader. The returned dict's ``simulation``
    sub-dict feeds :func:`simulation_config_from_dict`; the remaining
    top-level keys are CLI argument defaults (cli.py).
    """
    import pathlib

    try:
        import yaml
    except ImportError as e:
        raise ImportError(f"reading the config file {path} needs PyYAML, "
                          f"which is not installed") from e

    text = pathlib.Path(path).read_text()
    data = yaml.safe_load(text)
    if data is None:
        return {}
    if not isinstance(data, dict):
        raise ValueError(f"config file {path} must contain a mapping, "
                         f"got {type(data).__name__}")
    return data


__all__ = [
    "PhysicalConstants",
    "SimulationConfig",
    "SolverConfig",
    "MeshConfig",
    "PhotonicLanternDesignParameters",
    "SOLVER_PRESETS",
    "solver_preset",
    "simulation_config_from_dict",
    "load_config_file",
]
