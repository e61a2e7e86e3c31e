#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

In order:

1. needs CUDA (raises otherwise) and prints the card's name and power
   limit as nvidia-smi reports them;
2. builds the CUDA kernels (K1-K3) from ``pl_fem_tpu_torch/ops/csrc``
   with nvcc and prints the build seconds (Triton builds K4 at its
   first launch in step 3);
3. on the config-1 production mesh (7-core hexagonal lantern, r 1.5 um,
   pitch 8 um, n_core 1.535, air clad; ~15k points, ~60k P2 DOFs),
   checks each kernel against its plain PyTorch twin at the main path's
   shapes (B = 8 designs, k = 22 columns) to within 1e-5 of max|y|, and
   times both with CUDA events;
4. runs the main path twice, warm-up then timed:
   ``TrueVectorialMaxwellSolver.solve_sweep`` over 8 wavelengths
   1.50-1.64 um in fast mode (cheb_degree 200, cheb_passes 2,
   beta_passes 1, bootstrap on). Every design must return guided modes
   with n_clad < n_eff < n_core, and every kernel's launch count must
   rise during the timed run;
5. solves a single-core step fiber (r 1.5 um, n_core 1.53, air clad)
   through the same path and holds HE11's n_eff to the exact vector
   dispersion (ops/analytic.vector_modes) within 1e-3 relative, the
   fast-mode accuracy class;
6. runs the dataset engine through the port's CLI at the production
   settings of configs/r5_dataset.yaml (fast mode, 9000-18000 mesh
   points, bucket band 0.20, sweep engine with the 2-bucket pipeline,
   seed 42, quality threshold 0.35) plus 5 CMT slices, on 8 of the
   config's 220 samples (the one cut), into a temporary directory
   removed afterwards. It checks the records (8 lines,
   every validated sample solved in a bucket sweep, at least one
   success with finite mux/demux losses, a CMT IL and a power
   conservation in (0, 1.05]), that K1-K4 launched during the run, and
   that a second run on the same directory solves nothing; then it holds
   each kernel against its twin at the largest (B, k) the engine used,
   on a mesh at the engine's settings.

It prints the per-kernel JSON line, then the card's name and power
limit, then, last, the device line. Any failure raises and the script
exits non-zero.
"""
from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

N_SWEEP = 8
N_MODES = 10
MESH_MIN = 15000
REFINE = 2.2
FIBER_MESH_MIN = 9000        # ~50k DOFs: the fiber at the production scale
FIBER_REFINE = 1.5
KERNEL_RTOL = 1e-5           # of max|y|, f32 kernel vs f32 twin
FIBER_RTOL = 1e-3            # HE11 n_eff vs exact, fast-mode class
REPO = Path(__file__).resolve().parent
DATASET_N = 8                # of the 220 samples of configs/r5_dataset.yaml
DATASET_CMT_SLICES = 5


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _event_ms(fn, reps: int = 10) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def _finite(*xs) -> bool:
    return all(x is not None and math.isfinite(x) for x in xs)


def _compare(name, kernel_fn, plain_fn):
    """Run kernel and twin on the same inputs; return (err, ms, plain_ms)."""
    import torch

    y = kernel_fn()
    ref = plain_fn()
    torch.cuda.synchronize()
    scale = float(ref.abs().max())
    err = float((y - ref).abs().max())
    if not (err <= KERNEL_RTOL * scale):
        raise AssertionError(f"{name}: max|kernel - twin| = {err:.3e} > "
                             f"{KERNEL_RTOL:g} * max|y| = {scale:.3e}")
    ms = _event_ms(kernel_fn)
    plain_ms = _event_ms(plain_fn)
    print(f"  {name}: max_abs_err={err:.3e} (max|y|={scale:.3e}, limit "
          f"{KERNEL_RTOL:g} of max|y|)  kernel {ms:.3f} ms  plain "
          f"{plain_ms:.3f} ms", flush=True)
    return err, ms, plain_ms


def _kernel_checks(dg, geoms, k, dev):
    """Each kernel against its plain twin on ``dg`` with B = len(geoms)
    designs and k columns; returns {name: (err, ms, plain_ms)}."""
    import torch

    from pl_fem_tpu_torch.ops import cuda_kernels as ck
    from pl_fem_tpu_torch.ops import triton_kernels as tk
    from pl_fem_tpu_torch.ops.assembly import (assemble_vector3_qf,
                                               eps_arrays, gather_scatter,
                                               grid_to_device)
    from pl_fem_tpu_torch.ops.kernels import QFactorSweep, shape_table

    ga = grid_to_device(dg, dev)
    gs = gather_scatter(ga)
    invs = []
    for g in geoms:
        qf, _ = assemble_vector3_qf(ga, eps_arrays(g.eps_params(), dev))
        invs.append(qf.inv_eps)
    qs = QFactorSweep(invJT=qf.invJT, w=qf.w, inv_eps=torch.stack(invs),
                      gp=ga.grad_phys)
    B = len(geoms)
    D = dg.n_dofs_padded
    L = B * 3 * k
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    X = torch.randn((D, L), generator=gen, device=dev)
    mask = ga.interior_mask
    Xm = X * mask[:, None]
    betas = torch.tensor([g.k0 * 1.49 for g in geoms], device=dev)
    N = shape_table(dev)
    park = torch.full((L,), 50.0, device=dev)
    Ye = ck.apply_vector3_elem(Xm, gs.elem_dofs, qs.gp, qs.w, qs.inv_eps,
                               betas, 1.0, N, k)
    elem = (gs.elem_dofs, qs.gp, qs.w, qs.inv_eps, betas, 1.0, N, k)
    tables = (gs.idx_v, gs.valid_v, gs.idx_e, gs.valid_e)
    W = torch.randn((D, B, 3, k), generator=gen, device=dev)
    T1 = torch.randn((D, B, 3, k), generator=gen, device=dev)
    T0 = torch.randn((D, B, 3, k), generator=gen, device=dev)
    c = torch.linspace(100.0, 120.0, B, device=dev)
    h = torch.linspace(900.0, 1000.0, B, device=dev)
    print(f"kernel checks at D={D} E={dg.elem_dofs.shape[0]} B={B} k={k} "
          f"L={L}:", flush=True)
    results = {
        "apply_vector3_elem": _compare(
            "K1 apply_vector3_elem",
            lambda: ck.apply_vector3_elem(Xm, *elem),
            lambda: ck.apply_vector3_elem_plain(Xm, *elem)),
        "accumulate": _compare(
            "K2 accumulate",
            lambda: ck.accumulate(Ye, *tables, X, mask, park),
            lambda: ck.accumulate_plain(Ye, *tables, X, mask, park)),
        "apply_mass_elem": _compare(
            "K3 apply_mass_elem",
            lambda: ck.apply_mass_elem(Xm, gs.elem_dofs, qs.w, N),
            lambda: ck.apply_mass_elem_plain(Xm, gs.elem_dofs, qs.w, N)),
        "cheb_step": _compare(
            "K4 cheb_step (renorm step)",
            lambda: tk.cheb_step(W, T1.clone(), T0, c, h, renorm=True),
            lambda: tk.cheb_step_plain(W, T1.clone(), T0, c, h,
                                       renorm=True)),
    }
    # the plain step (no renorm) is the one run 7 of every 8 steps
    _compare("K4 cheb_step (plain step)",
             lambda: tk.cheb_step(W, T1, T0, c, h),
             lambda: tk.cheb_step_plain(W, T1, T0, c, h))
    return results


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; "
                           "torch.cuda.is_available() is False")
    sys.path.insert(0, str(REPO))
    from pl_fem_tpu_torch import cli
    from pl_fem_tpu_torch.config import (MeshConfig, SimulationConfig,
                                         SolverConfig)
    from pl_fem_tpu_torch.models import MCFGeometry
    from pl_fem_tpu_torch.ops import cuda_kernels as ck
    from pl_fem_tpu_torch.ops import triton_kernels as tk
    from pl_fem_tpu_torch.ops.analytic import vector_modes
    from pl_fem_tpu_torch.ops.femgrid import (MeshGenerator,
                                              export_device_grid)
    from pl_fem_tpu_torch.solvers import TrueVectorialMaxwellSolver

    card = _card()
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # -- 2. build -------------------------------------------------------
    t0 = time.perf_counter()
    ck.build(verbose=True)
    print(f"kernel build (nvcc, sm_90a): {time.perf_counter() - t0:.1f} s",
          flush=True)

    # -- 3. kernels against their twins at the main path's shapes -------
    def make_geom(wl):
        return MCFGeometry(7, 8.0, 1.5, 1.535, 1.0, wavelength_um=wl)

    cfg = SimulationConfig(
        mesh_min_points=MESH_MIN, mesh_target_points=MESH_MIN,
        mesh=MeshConfig(bucket_rounding=1024),
        solver=SolverConfig(device="cuda", cheb_degree=200, cheb_passes=2,
                            beta_passes=1))
    t0 = time.perf_counter()
    grid = MeshGenerator.generate(make_geom(1.55), REFINE, cfg)
    dg = export_device_grid(grid, 1024)
    print(f"mesh: {grid.n_points} points, {grid.n_dofs} DOFs, "
          f"{grid.n_elems} elements, bucket {dg.bucket} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    geoms = [make_geom(float(wl)) for wl in np.linspace(1.50, 1.64, N_SWEEP)]

    results = _kernel_checks(dg, geoms, N_MODES + cfg.solver.extra_vectors,
                             dev)
    torch.cuda.empty_cache()

    # -- 4. the main path: warm-up, then timed --------------------------
    wrappers = {"apply_vector3_elem": ck.apply_vector3_elem,
                "accumulate": ck.accumulate,
                "apply_mass_elem": ck.apply_mass_elem,
                "cheb_step": tk.cheb_step}
    Solver = TrueVectorialMaxwellSolver
    t0 = time.perf_counter()
    Solver.solve_sweep(geoms, dg, N_MODES, cfg)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    for fn in wrappers.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sweep = Solver.solve_sweep(geoms, dg, N_MODES, cfg)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in wrappers.items()}
    phases = {p: round(s, 3) for p, s in Solver.last_sweep_times.items()}
    print(f"sweep warm-up: {warm_s:.1f} s; timed: {dt:.2f} s = "
          f"{dt / N_SWEEP:.3f} s/design; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    print(f"phases (s): {json.dumps(phases)}", flush=True)
    print(f"modes per design: {[len(m) for m in sweep]}", flush=True)
    print(f"top n_eff per design: "
          f"{[round(m[0]['n_eff'], 6) if m else None for m in sweep]}",
          flush=True)
    print(f"launches in the timed sweep: {json.dumps(launches)}", flush=True)
    for g, ms in zip(geoms, sweep):
        if not ms:
            raise AssertionError(f"design at {g.wavelength_um} um returned "
                                 f"no modes")
        for m in ms:
            if not (g.n_clad < m["n_eff"] < g.n_core):
                raise AssertionError(f"n_eff {m['n_eff']} outside "
                                     f"({g.n_clad}, {g.n_core})")
            if not np.all(np.isfinite(m["Ex_dofs"])):
                raise AssertionError("non-finite mode field")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched by the "
                                 f"main path")

    # -- 5. single-core step fiber against the exact dispersion ---------
    fiber = MCFGeometry(1, 8.0, 1.5, 1.53, 1.0, wavelength_um=1.55,
                        use_complex_pml=False)
    fcfg = dataclasses.replace(cfg, mesh_min_points=FIBER_MESH_MIN,
                               mesh_target_points=FIBER_MESH_MIN)
    fgrid = MeshGenerator.generate(fiber, FIBER_REFINE, fcfg)
    fmodes = Solver.solve_sweep([fiber], export_device_grid(fgrid, 1024),
                                8, fcfg)[0]
    # HE11 is the first hybrid root of order 1, labelled "HY1,1"
    he11 = dict(vector_modes(1.55, 1.5, 1.53, 1.0))["HY1,1"]
    if not fmodes:
        raise AssertionError("single-core fiber returned no modes")
    rel = abs(fmodes[0]["n_eff"] - he11) / he11
    print(f"fiber ({fgrid.n_dofs} DOFs): HE11 n_eff {fmodes[0]['n_eff']:.6f}"
          f" vs exact {he11:.6f}, rel err {rel:.2e} (limit {FIBER_RTOL:g})",
          flush=True)
    if not rel <= FIBER_RTOL:
        raise AssertionError(f"fiber HE11 rel err {rel:.2e} > {FIBER_RTOL}")

    # -- 6. the dataset engine through the CLI at the r5 settings -------
    launches_sweep = launches
    out_tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_dataset_")
    out_dir = Path(out_tmp.name)
    argv = ["--config", str(REPO / "configs" / "r5_dataset.yaml"),
            "--n", str(DATASET_N), "--out", str(out_dir),
            "--cmt-slices", str(DATASET_CMT_SLICES)]
    for fn in wrappers.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen, records = cli.run(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in wrappers.items()}
    lines = (out_dir / "records.jsonl").read_text().splitlines()
    solved = [r for r in records if r.success_physics]
    print(f"dataset engine (configs/r5_dataset.yaml, {DATASET_N} of its 220 "
          f"samples, {DATASET_CMT_SLICES} CMT slices): {len(records)} "
          f"records, {len(solved)} validated, {len(gen.bucket_sizes)} "
          f"buckets with designs per bucket {gen.bucket_sizes}; "
          f"{wall:.1f} s wall = {3600.0 * len(solved) / wall:.1f} "
          f"designs/hour (host clock); peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    print("dataset phase seconds, summed over designs: " + json.dumps(
        {p: round(v, 3) for p, v in gen.phase_times.items()}), flush=True)
    print(f"launches in the dataset run: {json.dumps(launches)}", flush=True)
    for r in records:
        print(f"  {r.sample_id}: success={r.success} modes={r.n_modes_found} "
              f"n_eff_max={r.n_eff_max:.6f} IL_mux={r.IL_phys_mux_dB} "
              f"IL_CMT_mux={r.IL_CMT_mux_dB} "
              f"power_mux={r.power_conservation_mux} "
              f"error={r.error_msg} warnings={r.warnings}", flush=True)
    if len(lines) != DATASET_N:
        raise AssertionError(f"records.jsonl holds {len(lines)} lines, "
                             f"expected {DATASET_N}")
    for r in solved:
        if r.solver_mode != "bucketed_sweep" or r.n_dofs <= 0:
            raise AssertionError(f"{r.sample_id} passed validation but was "
                                 f"not solved in a bucket sweep: "
                                 f"{r.error_msg}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was not launched by the "
                                 f"dataset engine")
    good = [r for r in records if r.success and _finite(
        r.IL_phys_mux_dB, r.MDL_phys_mux_dB, r.PDL_mux_dB,
        r.crosstalk_mux_dB, r.IL_phys_demux_dB, r.MDL_phys_demux_dB,
        r.PDL_demux_dB, r.crosstalk_demux_dB, r.IL_CMT_mux_dB)
        and r.power_conservation_mux is not None
        and 0.0 < r.power_conservation_mux <= 1.05]
    if not good:
        raise AssertionError("no record succeeded with finite losses, a "
                             "CMT IL and a power conservation in (0, 1.05]")
    print(f"records with finite losses and CMT: {len(good)}/{len(records)}",
          flush=True)

    # resume: the same run on the same directory solves nothing
    for fn in wrappers.values():
        fn.launches = 0
    cli.run(argv)
    again = (out_dir / "records.jsonl").read_text().splitlines()
    out_tmp.cleanup()
    relaunched = {name: fn.launches for name, fn in wrappers.items()}
    print(f"resume run: {len(again)} lines, launches "
          f"{json.dumps(relaunched)}", flush=True)
    if again != lines or any(relaunched.values()):
        raise AssertionError("the resumed run re-simulated samples")

    # each kernel at the largest (B, k) the engine used, on a mesh at the
    # engine's settings: bucket sweeps take ceil(2.8 n_cores) + 12
    # columns, the CMT sweeps n_modes_found + 12 for their 5 slices
    k_ds = max(max(math.ceil(2.8 * r.n_cores), r.n_modes_found)
               for r in solved) + gen.config.solver.extra_vectors
    b_ds = max(max(gen.bucket_sizes), DATASET_CMT_SLICES)
    ds_grid = MeshGenerator.generate(make_geom(1.55), 1.0, gen.config)
    ds_dg = export_device_grid(ds_grid, gen.config.mesh.bucket_rounding)
    results_ds = _kernel_checks(
        ds_dg, [make_geom(float(w)) for w in np.linspace(1.53, 1.61, b_ds)],
        k_ds, dev)
    torch.cuda.empty_cache()

    src = "pl_fem_tpu_torch/ops/"
    meta = {
        "apply_vector3_elem": ("cuda", src + "csrc/apply_vector3.cu",
                               "pl_fem_tpu/ops/kernels.py:453"),
        "accumulate": ("cuda", src + "csrc/accumulate.cu",
                       "pl_fem_tpu/ops/kernels.py:426"),
        "apply_mass_elem": ("cuda", src + "csrc/apply_mass.cu",
                            "pl_fem_tpu/ops/kernels.py:605"),
        "cheb_step": ("triton", src + "triton_kernels.py",
                      "pl_fem_tpu/ops/kernels.py:702"),
    }
    kernels = []
    for name, (route, source, replaces) in meta.items():
        err, ms, plain_ms = results[name]
        err_ds, ms_ds, plain_ds = results_ds[name]
        kernels.append({
            "name": name, "route": route, "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "launches_by_path": {"sweep": launches_sweep[name],
                                 "dataset": launches[name]},
            "dataset_shape": {"B": b_ds, "k": k_ds, "max_abs_err": err_ds,
                              "ms": ms_ds, "plain_ms": plain_ds}})
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
