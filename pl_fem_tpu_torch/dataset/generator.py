"""Dataset generation orchestrator.

Port of pl_fem_tpu/dataset/generator.py. The reference README advertises
a ``dataset_generator.py`` (README.md:191-206) that is absent from its
snapshot; the per-sample pipeline it implies is fixed by the record
schema (dataset_record.py:129-151): solve -> losses mux -> losses demux
-> CMT mux -> CMT demux -> quality -> record. This module implements
that orchestrator with the reference CLI's skip-and-record failure
semantics (main.py:343-386), plus incremental checkpointing: records
are appended to ``records.jsonl`` as they complete, and ``resume=True``
skips already-simulated sample_ids after a crash.

Where the work runs: sampling, validation, meshing, the f64 polish, the
losses and the CMT propagation on the host; every mode solve on
``SolverConfig.device``: the vectorial bucket sweeps and CMT slice
sweeps through ``solve_sweep``, the scalar runs (``use_vectorial=False``)
design by design and slice by slice through ``ScalarHelmholtzSolver``.
With more than one CUDA device visible and ``SolverConfig.device`` a
bare "cuda", the bucket and CMT slice sweeps split their designs over
all of them (``_device_mesh``). With ``SolverConfig.backend == "hybrid"`` the serial engine's design
solves run scipy ARPACK on the host instead.
"""
from __future__ import annotations

import csv
import json
import logging
import math
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..config import SimulationConfig
from ..materials import IPDipCauchy
from ..models import MCFGeometry, taper_profile_fraction
from ..ops.femgrid import MeshGenerator, export_device_grid
from ..parallel import design_mesh
from ..physics import LossCalculator
from ..physics.cmt import CoupledModeTheory
from ..solvers import ScalarHelmholtzSolver, TrueVectorialMaxwellSolver
from ..utils import PhaseTimer
from .bucketing import (bucket_key, canonicalize, class_geometry,
                        group_by_bucket, rescale_modes)
from .parametric_space import (
    AIR_N,
    POLYMER_N,
    ParametricSpace,
    PhysicalValidator,
    SampleQualityScorer,
)
from .record import DatasetRecord
from .sampling import AdaptiveSampler, SmartSampler

logger = logging.getLogger("pl_fem_tpu_torch.dataset.generator")

C_LIGHT = 299_792_458.0  # m/s


class DatasetGenerator:
    """Per-sample simulation pipeline + batch orchestration.

    ``phase_times`` sums the wall-clock seconds of the run's phases
    (mesh, solve, losses, cmt with its cmt_solve / cmt_propagate parts;
    on scalar runs also cmt_mesh and the solver's own phases as
    ``scalar_<phase>``, which lie inside solve and cmt_solve) over all
    designs; with ``pipeline_buckets`` > 1 two buckets run at
    once, so the sum can exceed the run's wall time.
    """

    def __init__(self, space: Optional[ParametricSpace] = None,
                 config: Optional[SimulationConfig] = None,
                 use_vectorial: bool = True,
                 use_cauchy_dispersion: bool = False,
                 n_taper_slices: int = 0,
                 base_seed: int = 42,
                 out_dir: Optional[Path] = None):
        """
        Args:
            use_vectorial: full H-field solver (True) or scalar Helmholtz.
            use_cauchy_dispersion: IP-Dip Cauchy n(lambda) instead of the
                fixed polymer index (README.md:275).
            n_taper_slices: if >= 2, re-solve modes at this many taper
                cross-sections and run CMT mux/demux (the expensive outer
                product, geometry_unified.py:367-386); 0 skips CMT.
        """
        self.space = space or ParametricSpace()
        self.config = config or SimulationConfig()
        self.use_vectorial = use_vectorial
        self.use_cauchy = use_cauchy_dispersion
        self.n_taper_slices = int(n_taper_slices)
        self.base_seed = base_seed
        self.sampler = SmartSampler(self.space, self.config, base_seed)
        self.validator = PhysicalValidator()
        self.scorer = SampleQualityScorer()
        self.out_dir = Path(out_dir) if out_dir is not None else None
        if self.out_dir is not None:
            self.out_dir.mkdir(parents=True, exist_ok=True)
        self.phase_times: Dict[str, float] = {}
        self._times_lock = threading.Lock()
        # designs per bucket of the last simulate_bucketed call
        self.bucket_sizes: List[int] = []

    def _add_times(self, timer: PhaseTimer) -> None:
        with self._times_lock:
            for k, v in timer.times.items():
                self.phase_times[k] = self.phase_times.get(k, 0.0) + v

    # ------------------------------------------------------------------
    def _n_core(self, sample: Dict) -> float:
        wl_um = float(sample.get("wavelength_nm", 1550.0)) / 1000.0
        base = float(IPDipCauchy.n_um(wl_um)) if self.use_cauchy else POLYMER_N
        return base + (float(sample.get("delta_n_percent", 1.0)) - 1.0) / 100.0

    def build_geometry(self, sample: Dict) -> MCFGeometry:
        variant = None
        if int(sample["n_cores"]) == 6 and \
                sample.get("arrangement") in ("ring", "pentagon_center"):
            variant = sample["arrangement"]
        taper_mm = float(sample.get("taper_length_mm", 0.375))
        return MCFGeometry(
            n_cores=int(sample["n_cores"]),
            pitch_um=float(sample["pitch_um"]),
            core_radius_um=float(sample["core_radius_um"]),
            n_core=self._n_core(sample),
            n_clad=float(sample.get("n_clad", AIR_N)),
            wavelength_um=float(sample.get("wavelength_nm", 1550.0)) / 1000.0,
            use_complex_pml=self.config.use_pml,
            taper_length_um=taper_mm * 1000.0,
            variant=variant,
        )

    # ------------------------------------------------------------------
    def _init_record(self, sample: Dict) -> DatasetRecord:
        return DatasetRecord(
            sample_id=str(sample.get("sample_id", "S?")),
            n_cores=int(sample.get("n_cores", 0)),
            core_radius_um=float(sample.get("core_radius_um", 0.0)),
            pitch_um=float(sample.get("pitch_um", 0.0)),
            arrangement=str(sample.get("arrangement", "")),
            delta_n_percent=float(sample.get("delta_n_percent", 0.0)),
            wavelength_nm=float(sample.get("wavelength_nm", 1550.0)),
            taper_length_mm=float(sample.get("taper_length_mm", 0.375)),
            taper_profile=str(sample.get("taper_profile", "exponential")),
        )

    def _validate(self, rec: DatasetRecord, sample: Dict):
        """Geometry + physics gates; returns (geom, pmetrics) or None."""
        geom = self.build_geometry(sample)
        ok, msg = geom.validate()
        rec.success_geometry = ok
        if not ok:
            rec.error_msg = f"geometry: {msg}"
            return None
        rec.config_type = geom.config_type
        rec.geometry_config = f"{geom.n_cores}-{geom.config_type}"
        rec.n_peripheral_cores = geom.n_peripheral
        rec.R_ring = float(geom.R_ring)
        rec.packing_efficiency = float(geom.packing_efficiency)
        rec.n_core = geom.n_core
        rec.n_clad = geom.n_clad
        rec.delta_n = geom.delta_n
        rec.n_polymer = geom.n_core
        rec.V_number = float(geom.V_number)

        okp, msgp, pmetrics = self.validator.validate_sample_physics({
            **sample, "n_core": geom.n_core, "n_clad": geom.n_clad})
        rec.success_physics = okp
        if not okp:
            rec.error_msg = f"physics: {msgp}"
            return None
        rec.NA_SM = pmetrics.get("NA")
        rec.V_SM = pmetrics.get("V_number")
        rec.r_core_SM = geom.r_core
        rec.n_core_SM = geom.n_core
        rec.n_clad_SM = geom.n_clad
        rec.M_max = pmetrics.get("n_modes_est")
        return geom, pmetrics

    def _solve_scalar(self, geom, dg, n_modes: int, timer: PhaseTimer,
                      **kw) -> List[Dict]:
        """One ScalarHelmholtzSolver.solve, its phases added to ``timer``
        as ``scalar_<phase>``."""
        solver = ScalarHelmholtzSolver(geom, self.config)
        try:
            return solver.solve(dg, n_modes, **kw)
        finally:
            for name, dt in solver.last_solve_times.items():
                key = f"scalar_{name}"
                timer.times[key] = timer.times.get(key, 0.0) + dt

    def _n_modes_target(self, geom) -> int:
        return self.config.n_modes_target or math.ceil(2.8 * geom.n_cores)

    def _device_mesh(self):
        """The 'designs' mesh over every visible CUDA device when the
        solver's device is a bare "cuda" and more than one is visible,
        else None: the bucket and CMT slice sweeps split their designs
        over it (the serial engine's single-design solves do not)."""
        dev = torch.device(self.config.solver.device)
        if dev.type != "cuda" or dev.index is not None \
                or torch.cuda.device_count() < 2:
            return None
        return design_mesh()

    def _postsolve(self, rec: DatasetRecord, sample: Dict, geom,
                   modes: List[Dict], pmetrics: Dict, timer) -> None:
        """Mode stats -> losses -> CMT -> quality (steps 3b-6)."""
        wl_nm = rec.wavelength_nm
        rec.success_solver = len(modes) > 0
        if not modes:
            rec.error_msg = "solver: no guided modes"
            return
        rec.n_modes_found = len(modes)
        ne = [m["n_eff"] for m in modes]
        confs = [m["confinement"] for m in modes]
        rec.n_eff_max = float(max(ne))
        rec.n_eff_min = float(min(ne))
        rec.n_eff_mean = float(np.mean(ne))
        rec.n_eff_LP01 = rec.n_eff_max
        rec.confinement_max = float(max(confs))
        rec.confinement_min = float(min(confs))
        rec.avg_confinement = float(np.mean(confs))

        # 4. losses mux + demux
        with timer.phase("losses"):
            mux = LossCalculator.calculate_physical_losses(
                modes, geom, "mux", wl_nm)
            demux = LossCalculator.calculate_physical_losses(
                modes, geom, "demux", wl_nm)
        rec.success_losses = bool(mux.get("success")
                                  and demux.get("success"))
        if mux.get("success"):
            rec.losses_mux = mux
            rec.IL_phys_mux_dB = mux["IL_dB"]
            rec.MDL_phys_mux_dB = mux["MDL_dB"]
            rec.PDL_mux_dB = mux["PDL_dB"]
            rec.crosstalk_mux_dB = mux["crosstalk_dB"]
            rec.radiation_mux_dB_m = mux["radiation_loss_dB_per_m"]
        if demux.get("success"):
            rec.losses_demux = demux
            rec.IL_phys_demux_dB = demux["IL_dB"]
            rec.MDL_phys_demux_dB = demux["MDL_dB"]
            rec.PDL_demux_dB = demux["PDL_dB"]
            rec.crosstalk_demux_dB = demux["crosstalk_dB"]
            rec.radiation_demux_dB_m = demux["radiation_loss_dB_per_m"]

        # 5. CMT over taper slices (optional, the expensive product)
        if self.n_taper_slices >= 2 and geom.taper_length:
            with timer.phase("cmt"):
                self._run_cmt(rec, geom, modes, wl_nm, timer)

        # 6. quality + performance
        rec.quality_score = self.scorer.score_sample(sample, pmetrics)
        rec.performance_index = rec.calculate_performance_index()
        # uniformity of modal confinement across the solved mode set
        # (the reference treats it as a design input defaulting to 0.95;
        # it is measured here instead)
        cmean = float(np.mean(confs))
        rec.coupling_uniformity = float(np.clip(
            1.0 - np.std(confs) / max(cmean, 1e-9), 0.0, 1.0))
        if mux.get("success"):
            rec.coupling_degradation = mux.get("coupling_degradation")
            rec.crosstalk_penalty = mux.get("geometry_penalty")
        rec.success = (rec.success_geometry and rec.success_physics
                       and rec.success_solver and rec.success_losses)

    def _provenance(self, rec: DatasetRecord, grid, bucketed: bool):
        """Stamp solver-mode/accuracy-class/mesh-quality provenance.

        Bucketed sweeps carry a non-conforming-member accuracy floor
        that per-design solves do not (docs/PARITY_r3.md §A); a dataset
        consumer must be able to tell which class produced each record.
        """
        s = self.config.solver
        if not self.use_vectorial:
            rec.solver_mode = "scalar_cascade"
            rec.accuracy_class = "scalar LP approximation"
        elif s.backend == "hybrid":
            rec.solver_mode = "hybrid_arpack"
            rec.accuracy_class = ("reference transverse pencil "
                                  "(~6e-4 model error at air-clad)")
        else:
            rec.solver_mode = "bucketed_sweep" if bucketed else "per_design"
            if s.beta_passes >= 2:
                # balanced preset = qres-gated like accuracy mode but at
                # a loosened tol (config.SOLVER_PRESETS); stamp the tol
                # so the record says which gate certified its roots. The
                # 2e-5 threshold is the JAX package's, kept as written.
                acc = s.polish_qres_tol <= 2e-5
                tier = "accuracy" if acc else \
                    f"balanced, qres tol {s.polish_qres_tol:g}"
                if bucketed:
                    # the ~1e-4 bucket floor is measured at band 0.05
                    # (docs/PARITY_r3.md §A); wider bands admit members
                    # farther from the class geometry, so stamp the band
                    # and only quote the floor where it was measured
                    band = self.config.mesh.bucket_ratio_band
                    floor = ", ~1e-4 floor" if (band <= 0.05 and acc) \
                        else ""
                    rec.accuracy_class = (
                        f"{tier} (bucket band {band:.2f}{floor})")
                elif acc:
                    rec.accuracy_class = "accuracy (~2e-6 n_eff)"
                else:
                    rec.accuracy_class = f"{tier} (per-design)"
            else:
                rec.accuracy_class = "fast (~8e-4 n_eff)"
        if grid is not None and grid.quality is not None:
            rec.mesh_quality_ok = bool(grid.quality_ok)
            rec.mesh_quality_msg = grid.quality_msg
            if not grid.quality_ok:
                rec.warnings.append(f"mesh quality: {grid.quality_msg}")

    def simulate_sample(self, sample: Dict) -> DatasetRecord:
        """Full pipeline for one design; never raises (skip-and-record)."""
        rec = self._init_record(sample)
        timer = PhaseTimer()
        t0 = time.time()
        try:
            prepared = self._validate(rec, sample)
            if prepared is None:
                return rec
            geom, pmetrics = prepared

            # 3. mesh + solve
            with timer.phase("mesh"):
                grid = MeshGenerator.generate(
                    geom, self.config.mesh.refinement, self.config)
            rec.mesh_points = grid.n_points
            rec.mesh_elements = grid.n_elems
            rec.n_dofs = grid.n_dofs
            self._provenance(rec, grid, bucketed=False)
            dg = export_device_grid(grid, self.config.mesh.bucket_rounding)

            n_target = self._n_modes_target(geom)
            diags: Dict[int, str] = {}
            with timer.phase("solve"):
                if not self.use_vectorial:
                    # scalar CLI path uses the reference's guided-mode
                    # cascade (main.py:258-288)
                    modes = self._solve_scalar(geom, dg, n_target, timer,
                                               mode_filter="cascade")
                elif self.config.solver.backend == "hybrid":
                    modes = TrueVectorialMaxwellSolver(
                        geom, config=self.config).solve_vectorial_modes(
                            dg, n_target)
                else:
                    modes = TrueVectorialMaxwellSolver.solve_sweep(
                        [geom], dg, n_target, self.config,
                        diag_out=diags)[0]
            if 0 in diags:
                # debug_checks diagnosed the design: skip-and-record
                rec.error_msg = f"solver diagnostic: {diags[0]}"
                return rec
            self._postsolve(rec, sample, geom, modes, pmetrics, timer)
            return rec
        except Exception as e:   # skip-and-record (main.py:384-386)
            logger.warning("sample %s failed: %s", rec.sample_id, e)
            rec.error_msg = str(e)
            return rec
        finally:
            rec.solver_time_s = time.time() - t0
            self._add_times(timer)
            if timer.times:
                logger.debug("%s phases: %s", rec.sample_id, timer.summary())

    # ------------------------------------------------------------------
    def simulate_bucketed(self, samples: Sequence[Dict],
                          on_batch=None) -> List[DatasetRecord]:
        """Solve many designs as canonical-grid packed sweeps (vectorial
        only).

        Designs are rescaled into canonical buckets (dataset/bucketing
        .py: same layout + radius/pitch class -> one shared mesh), each
        bucket solved as ONE ``solve_sweep`` call on the device, then
        every record finishes with its own physical-frame losses/CMT.
        Replaces the reference's strictly serial per-design loop (the
        reference's main.py:343-386).

        ``on_batch(records)`` is called with each batch of finished
        records as it completes (the validation-failure batch first,
        then one batch per solved bucket) so long runs checkpoint
        incrementally — a crash mid-run loses at most the in-flight
        bucket, matching the serial engine's checkpoint_every semantics.
        """
        recs = [self._init_record(s) for s in samples]
        t_start = {i: time.time() for i in range(len(samples))}
        prepared = []          # (index, sample, geom, pmetrics)
        for i, (rec, sample) in enumerate(zip(recs, samples)):
            try:
                out = self._validate(rec, sample)
                if out is not None:
                    prepared.append((i, sample, out[0], out[1]))
                else:
                    rec.solver_time_s = time.time() - t_start[i]
            except Exception as e:
                logger.warning("sample %s failed: %s", rec.sample_id, e)
                rec.error_msg = str(e)
                rec.solver_time_s = time.time() - t_start[i]

        prepared_idx = {p[0] for p in prepared}
        if on_batch is not None:
            failed = [r for i, r in enumerate(recs)
                      if i not in prepared_idx]
            if failed:
                on_batch(failed)

        band = self.config.mesh.bucket_ratio_band
        groups = group_by_bucket([p[2] for p in prepared], band)
        self.bucket_sizes = [len(rows) for rows in groups.values()]
        dev_mesh = self._device_mesh()
        pipeline = max(1, int(self.config.pipeline_buckets))
        logger.info("bucketed run: %d samples -> %d buckets (%s%s)",
                    len(prepared), len(groups),
                    f"{dev_mesh.size}-device mesh" if dev_mesh is not None
                    else "single device",
                    f", {pipeline}-bucket pipeline" if pipeline > 1
                    else "")
        emit_lock = threading.Lock()

        def _solve_bucket(key, rows):
            members = [prepared[j] for j in rows]
            t_bucket = time.time()
            sweep_diags: Dict[int, str] = {}
            btimer = PhaseTimer()
            try:
                with btimer.phase("mesh"):
                    cls_geom = class_geometry(key, members[0][2], band)
                    grid = MeshGenerator.generate(
                        cls_geom, self.config.mesh.refinement, self.config)
                    dg = export_device_grid(grid,
                                            self.config.mesh.bucket_rounding)
                pairs = [canonicalize(g, cls_geom) for (_, _, g, _)
                         in members]
                n_target = self._n_modes_target(members[0][2])
                with btimer.phase("solve"):
                    sweep = TrueVectorialMaxwellSolver.solve_sweep(
                        [c for c, _ in pairs], dg, n_target, self.config,
                        diag_out=sweep_diags, mesh=dev_mesh)
            except Exception as e:
                logger.warning("bucket %s failed: %s", key, e)
                for (i, _, _, _) in members:
                    recs[i].error_msg = f"bucket solve: {e}"
                    recs[i].solver_time_s = time.time() - t_bucket
                if on_batch is not None:
                    with emit_lock:
                        on_batch([recs[i] for (i, _, _, _) in members])
                return
            finally:
                self._add_times(btimer)
            per_member = (time.time() - t_bucket) / max(len(members), 1)
            for j, ((i, sample, geom, pm), (_, s), modes) in enumerate(
                    zip(members, pairs, sweep)):
                rec = recs[i]
                if j in sweep_diags:
                    # debug_checks diagnosed this design (NaN inputs or
                    # a diverged filter): skip-and-record, not garbage
                    rec.error_msg = f"solver diagnostic: {sweep_diags[j]}"
                    rec.solver_time_s = per_member
                    continue
                rec.mesh_points = grid.n_points
                rec.mesh_elements = grid.n_elems
                rec.n_dofs = grid.n_dofs
                self._provenance(rec, grid, bucketed=True)
                timer = PhaseTimer()
                try:
                    modes = rescale_modes(modes, s, geom.k0)
                    self._postsolve(rec, sample, geom, modes, pm, timer)
                except Exception as e:
                    logger.warning("sample %s failed: %s",
                                   rec.sample_id, e)
                    rec.error_msg = str(e)
                rec.solver_time_s = per_member + timer.total
                self._add_times(timer)
            if on_batch is not None:
                with emit_lock:
                    on_batch([recs[i] for (i, _, _, _) in members])

        if pipeline > 1 and len(groups) > 1:
            # two-stage bucket pipeline: while bucket N runs its host-
            # side polish/losses (device idle), bucket N+1's device
            # filter runs from a second thread — numpy/scipy release the
            # GIL in the heavy host ops and the kernel launches are
            # asynchronous. Work items (buckets) never share records,
            # grids or families; shared caches and the kernel builds are
            # locked at their definition sites.
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(max_workers=pipeline) as ex:
                futs = [ex.submit(_solve_bucket, key, rows)
                        for key, rows in groups.items()]
                for f in futs:
                    f.result()
        else:
            for key, rows in groups.items():
                _solve_bucket(key, rows)
        return recs

    # ------------------------------------------------------------------
    def _taper_scales(self, rec: DatasetRecord, zs: np.ndarray,
                      L: float) -> np.ndarray:
        """Cross-section scale factor along z for the SAMPLED profile.

        scale(z) = 1 - (1 - cmt_min_scale) * p(z/L) with p the sampled
        ``taper_profile`` shape (models/geometry.py
        ``taper_profile_fraction``; reference intent:
        geometry_unified.py:468-480) — the profile column is physical:
        it moves the solved cross-sections, hence coupling and IL_CMT.
        The configured ``cmt_min_scale`` floor keeps the narrowest
        cross-section meshable.
        """
        ms = float(self.config.cmt_min_scale)
        return np.array([1.0 - (1.0 - ms) * taper_profile_fraction(
            rec.taper_profile, z / L) for z in zs])

    def _run_cmt(self, rec: DatasetRecord, geom: MCFGeometry,
                 modes: List[Dict], wl_nm: float, timer: PhaseTimer):
        """Solve local modes along the taper and propagate (CMT).

        Vectorial path: every z-slice of a taper is a uniform rescale of
        the same cross-section, so ALL slices canonicalize onto one
        bucket grid (dataset/bucketing.py) and solve as a single packed
        sweep on the device — one mesh + one filter call instead of a
        re-mesh + re-solve per slice, and the CMT overlap integrals get
        a common P2 basis (the reference re-meshes per z and compares
        fields across incompatible meshes; geometry_unified.py:367-386).
        Scalar path: every slice is re-meshed and solved on its own, as
        the reference does, and the fields are zero-padded to a common
        length.
        """
        L = float(geom.taper_length)
        zs = np.linspace(0.0, L, self.n_taper_slices)
        n_modes = len(modes)
        scales_z = self._taper_scales(rec, zs, L)
        geos_z = [geom.get_tapered(sc * L) for sc in scales_z]

        modes_list = []
        delta_eps_mass = None
        dg_t = cls_geom = None
        with timer.phase("cmt_solve"):
            if self.use_vectorial:
                band = self.config.mesh.bucket_ratio_band
                cls_geom = class_geometry(bucket_key(geom, band), geom, band)
                grid_t = MeshGenerator.generate(
                    cls_geom, self.config.mesh.refinement, self.config)
                dg_t = export_device_grid(grid_t,
                                          self.config.mesh.bucket_rounding)
                pairs = [canonicalize(gz, cls_geom) for gz in geos_z]
                sweeps = TrueVectorialMaxwellSolver.solve_sweep(
                    [c for c, _ in pairs], dg_t, n_modes, self.config,
                    mesh=self._device_mesh())
                full = bool(self.config.cmt_full_field)
                for gz, (_, s), mz in zip(geos_z, pairs, sweeps):
                    mz = rescale_modes(mz, s, gz.k0)
                    for m in mz:
                        # overlap field: full transverse stack by default
                        # (the reference integrates the interpolated E
                        # field, config.py:295-302); hx only under
                        # cmt_full_field=False
                        m["field_vector"] = np.concatenate(
                            [m["Ex_dofs"], m["Ey_dofs"]]) if full \
                            else m["Ex_dofs"]
                    modes_list.append(mz)
            else:
                for gz in geos_z:
                    with timer.phase("cmt_mesh"):
                        grid_z = MeshGenerator.generate(
                            gz, self.config.mesh.refinement, self.config)
                        dg_z = export_device_grid(
                            grid_z, self.config.mesh.bucket_rounding)
                    modes_list.append(self._solve_scalar(gz, dg_z, n_modes,
                                                         timer))
                # pad fields to a common length (scalar slices re-mesh)
                dmax = max(len(m["field_vector"])
                           for ml in modes_list for m in ml)
                for ml in modes_list:
                    for m in ml:
                        v = np.asarray(m["field_vector"])
                        if len(v) < dmax:
                            m["field_vector"] = np.concatenate(
                                [v, np.zeros(dmax - len(v))])

        with timer.phase("cmt_propagate"):
            if self.use_vectorial and self.config.cmt_coupling == "rigorous":
                # (eps - mean eps)-weighted mass on the shared bucket
                # grid: all slices canonicalize onto dg_t, so ONE CSR
                # serves every segment (reference seam: the per-z skfem
                # form at config.py:274-322)
                from ..physics.cmt import delta_eps_mass_csr

                delta_eps_mass = delta_eps_mass_csr(
                    dg_t, cls_geom.eps_params())

            # Near the taper waist, higher-order modes cross cutoff and
            # drop out of the guided set — that is physics, not failure.
            # Propagate the surviving common subset (slices are sorted
            # by n_eff, so a common-count truncation keeps the most-
            # guided modes).
            n_common = min((len(ml) for ml in modes_list), default=0)
            if n_common < 1:
                rec.warnings.append("CMT: a taper slice has no guided modes")
                return
            if n_common < n_modes:
                rec.warnings.append(f"CMT: truncated to {n_common}/{n_modes} "
                                    "modes (waist cutoff)")
                n_modes = n_common
            modes_list = [ml[:n_modes] for ml in modes_list]

            omega = 2.0 * np.pi * C_LIGHT / (wl_nm * 1e-9)
            cmt = CoupledModeTheory(omega,
                                    coupling_method=self.config.cmt_coupling)
            A0 = np.zeros(n_modes, dtype=complex)
            A0[0] = 1.0
            adaptive = bool(self.config.cmt_adaptive)
            res_mux = cmt.propagate_cmt(zs, modes_list, A0, "mux",
                                        use_adaptive=adaptive,
                                        delta_eps_mass=delta_eps_mass)
            res_demux = cmt.propagate_cmt(zs, modes_list, A0, "demux",
                                          use_adaptive=adaptive,
                                          delta_eps_mass=delta_eps_mass)
            rec.cmt_mux = {k: v for k, v in res_mux.items()
                           if not isinstance(v, np.ndarray)}
            rec.cmt_demux = {k: v for k, v in res_demux.items()
                             if not isinstance(v, np.ndarray)}
            rec.IL_CMT_mux_dB = res_mux["IL_dB"]
            rec.IL_CMT_demux_dB = res_demux["IL_dB"]
            rec.power_conservation_mux = res_mux["power_conservation"]
            rec.power_conservation_demux = res_demux["power_conservation"]
            ad = cmt.estimate_adiabaticity(zs, modes_list)
            rec.adiabatic_score = 1.0 if ad["is_adiabatic"] else \
                max(0.0, 1.0 - 0.1 * ad["n_violations"])

    # ------------------------------------------------------------------
    def _resume(self, resume: bool):
        """(checkpoint path or None, records already in it, their ids);
        with ``resume`` False the checkpoint is appended to, not read."""
        ckpt = (self.out_dir / "records.jsonl") if self.out_dir else None
        records: List[DatasetRecord] = []
        done_ids = set()
        if resume and ckpt is not None and ckpt.exists():
            for line in ckpt.read_text().splitlines():
                try:
                    rec = DatasetRecord.from_dict(json.loads(line))
                except (json.JSONDecodeError, TypeError):
                    continue
                records.append(rec)
                done_ids.add(rec.sample_id)
            if done_ids:
                logger.info("resume: %d records already done", len(done_ids))
        return ckpt, records, done_ids

    @staticmethod
    def _checkpointer(ckpt: Optional[Path]):
        def checkpoint(batch: List[DatasetRecord]):
            if ckpt is not None and batch:
                with open(ckpt, "a") as f:
                    f.write("\n".join(json.dumps(r.to_dict())
                                      for r in batch) + "\n")
        return checkpoint

    def _write_outputs(self, records: Sequence[DatasetRecord]) -> None:
        if self.out_dir is not None:
            self.write_csv(records, self.out_dir / "dataset_raw.csv")
            valid = self.physical_filter(records)
            self.write_csv(valid, self.out_dir / "dataset_valid_phys.csv")

    def generate(self, n_samples: int, quality_threshold: float = 0.35,
                 diversity_filter: bool = True,
                 checkpoint_every: int = 10,
                 resume: bool = True,
                 engine: str = "serial") -> List[DatasetRecord]:
        """Sample the space and simulate, with incremental checkpoints.

        ``engine='sweep'`` batches designs through canonical-grid
        packed sweeps (:meth:`simulate_bucketed`) instead of the
        reference-style serial per-design loop — same records (solver
        tolerance apart), shared meshes and filters. Vectorial only
        (scalar runs fall back to serial).
        """
        samples = self.sampler.generate_stratified_samples(
            n_samples, quality_threshold=quality_threshold,
            ensure_diversity=diversity_filter)

        ckpt, records, done_ids = self._resume(resume)
        pending = [s for s in samples
                   if s.get("sample_id") not in done_ids]
        records.extend(self._run_batch(pending, self._checkpointer(ckpt),
                                       engine, checkpoint_every))
        self._write_outputs(records)
        return records

    def _run_batch(self, pending: List[Dict], checkpoint, engine: str,
                   checkpoint_every: int = 10) -> List[DatasetRecord]:
        """Simulate one batch through the selected engine."""
        out: List[DatasetRecord] = []
        if engine == "sweep" and self.use_vectorial:
            # checkpoint per completed bucket (a crash loses at most
            # the in-flight bucket, like the serial engine's
            # checkpoint_every)
            out = self.simulate_bucketed(pending, on_batch=checkpoint)
            n_ok = sum(1 for r in out if r.success)
            logger.info("sweep engine: %d/%d successful", n_ok, len(out))
        else:
            buffer: List[DatasetRecord] = []
            for i, sample in enumerate(pending, 1):
                rec = self.simulate_sample(sample)
                out.append(rec)
                logger.info("[%d/%d] %s: success=%s (%.1fs)", i,
                            len(pending), rec.sample_id, rec.success,
                            rec.solver_time_s)
                buffer.append(rec)
                if len(buffer) >= checkpoint_every:
                    checkpoint(buffer)
                    buffer.clear()
            checkpoint(buffer)
        return out

    def generate_adaptive(self, n_samples: int, n_rounds: int = 4,
                          focus_ratio: float = 0.7,
                          quality_threshold: float = 0.35,
                          resume: bool = True,
                          engine: str = "sweep",
                          checkpoint_every: int = 10
                          ) -> List[DatasetRecord]:
        """Orchestrated exploit/explore loop over the adaptive sampler.

        Round 0 draws a stratified LHS batch; every later round feeds
        the batch's outcomes (success flags + IL/MDL metrics) back into
        :class:`AdaptiveSampler` and draws ``focus_ratio`` of the next
        batch near the best designs found so far. The reference ships
        the sampler pieces but never drives them (README.md:220-231);
        this is that orchestration, on the same checkpoint/resume
        contract as :meth:`generate`.
        """
        sampler = AdaptiveSampler(self.space, base_seed=self.base_seed)
        ckpt, records, done_ids = self._resume(resume)
        checkpoint = self._checkpointer(ckpt)

        n_rounds = max(1, int(n_rounds))
        per_round = max(1, (n_samples - len(records) + n_rounds - 1)
                        // n_rounds)
        for rnd in range(n_rounds):
            if len(records) >= n_samples:
                break
            want = min(per_round, n_samples - len(records))
            if rnd == 0 and not sampler.successful:
                batch = sampler.base_sampler.generate_stratified_samples(
                    want, quality_threshold=quality_threshold)
            else:
                batch = sampler.generate_adaptive_samples(
                    want, focus_ratio=focus_ratio)
            batch = [s for s in batch
                     if s.get("sample_id") not in done_ids]
            recs = self._run_batch(batch, checkpoint, engine,
                                   checkpoint_every)
            records.extend(recs)
            by_id = {r.sample_id: r for r in recs}
            oks, metrics = [], []
            for s in batch:
                r = by_id.get(str(s.get("sample_id")))
                oks.append(bool(r is not None and r.success))
                metrics.append({} if r is None or r.IL_phys_mux_dB is None
                               else {"IL_dB": r.IL_phys_mux_dB,
                                     "MDL_dB": r.MDL_phys_mux_dB})
            sampler.update_from_results(batch, oks, metrics)
            logger.info("adaptive round %d/%d: %d records "
                        "(%d successful total)", rnd + 1, n_rounds,
                        len(recs), len(sampler.successful))

        self._write_outputs(records)
        return records

    # ------------------------------------------------------------------
    @staticmethod
    def physical_filter(records: Sequence[DatasetRecord]
                        ) -> List[DatasetRecord]:
        """IL in [0.3, 10] dB and |MDL| < 8 dB (main.py:403-407)."""
        out = []
        for r in records:
            if not r.success or r.IL_phys_mux_dB is None:
                continue
            if 0.3 <= r.IL_phys_mux_dB <= 10.0 and \
                    (r.MDL_phys_mux_dB is None
                     or abs(r.MDL_phys_mux_dB) < 8.0):
                out.append(r)
        return out

    @staticmethod
    def write_csv(records: Sequence[DatasetRecord], path: Path):
        """One row per record, the ``to_csv_row`` columns in order;
        None is written as an empty field."""
        if not records:
            return
        rows = [r.to_csv_row() for r in records]
        with open(path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(rows[0]))
            w.writeheader()
            w.writerows(rows)
        logger.info("wrote %d records -> %s", len(rows), path)
