"""Device time by kernel of one warm dataset design, and the config-1
sweep's phase seconds, on one NVIDIA GPU.

    python3 pl_fem_tpu_torch/profile_design.py [--repo DIR] [--out FILE]
        [--scalar | --kernels]

``--repo`` names the checkout whose ``pl_fem_tpu_torch`` is measured
(default: the one holding this file; it must have ``workloads.py`` and
``cli.generator``), so two trees can be compared in one process per tree
on the same card. The workloads are those of ``chip_smoke.py``, defined
in ``pl_fem_tpu_torch/workloads.py``. Three measurements:

1. the config-1 fast sweep: a warm-up, then SWEEPS timed sweeps, each
   with its phase seconds
   (``TrueVectorialMaxwellSolver.last_sweep_times``);
2. one packed A(beta) apply (``kernels._apply_vector3_fused``, through
   whatever kernels the tree runs for it), timed with CUDA events at the
   config-1 sweep's shape (B = 8, k = 22) and at the dataset run's
   largest (B = 5, k = 42) on a mesh at its settings; and the sweep's
   assemble and bounds work as the tree's ``solve_sweep`` runs it (the
   batched K6, the mass diagonal and K8 from the quadrature data where
   the tree has ``assembly.assemble_vector3_sweep``, else the per-design
   loops), host seconds to a synchronise, at the same two meshes (B = 8
   and B = 5);
3. the 7-core sample of the r5 dataset run's draw (the CLI's arguments
   from ``workloads.dataset_argv``, the sweep engine): once to warm up
   (Triton, coarse meshes), then once under ``torch.profiler``. It
   prints the wall time, the device time (the sum of the kernel and
   copy intervals), the device's idle share and the device time by
   kernel family.

``--kernels`` times K9 (``seed_prolong``, the bootstrap seed) and K10
(``ritz_residual``, the Rayleigh-Ritz residuals and gate) alone, on the
inputs ``chip_smoke.py`` builds: the coarse vectors, seeded-column mask
and prolongation tables of one real bootstrap with fresh noise, and the
Rayleigh-Ritz of two filter passes from a random block; at the config-1
sweep's B = 8, k = 22 and at B = 5 taper slices of the 7-core design on
a mesh at the r5 settings, k = 42 (the largest k of the r5 dataset
run). Each is timed with CUDA events and by the profiler's device time,
beside its twin; K9 also with no column seeded (no F gathered, R1 read
whole), which shows what its gathers cost. It also times the scalar
pencil's set-up on the config-1 design at both meshes: K11, where the
tree has it, and the K6, K7 and K8 launches it replaced, by CUDA events,
device time and host time a call.

``--scalar`` measures the scalar path instead:

1. the config-1 scalar solve (``ScalarHelmholtzSolver.solve`` of the
   1.55 um design on the config-1 mesh, N_MODES modes): a warm-up, then
   SWEEPS timed solves, each with its phase seconds
   (``last_solve_times``, the filter among them);
2. one stacked apply (``kernels._apply_stacked``, through whatever
   kernels the tree runs for it) at C = 1 on the scalar pencil's blocks
   and at C = 3 on the (E, 18, 18) vectorial blocks, timed with CUDA
   events on the config-1 mesh at k = 22 and on a mesh at the r5
   settings at k = 27;
3. one scalar design: the 5-core sample of the scalar run's draw
   (``workloads.scalar_dataset_argv``, the serial loop: one solve plus a
   re-mesh and a solve per CMT slice), warm, under the profiler, with
   the scalar solver's own phase seconds.

Prints one JSON object as its last line; ``--out`` also writes it.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
SWEEPS = 3                  # timed config-1 sweeps, after one warm-up

# kernel-name fragments of each family, first match wins (K1's, K3's
# and K4's also match their older kernels' names, so older checkouts
# read the same)
FAMILIES = (
    ("K1 apply_vector3", ("apply_vector3",)),
    ("K2 accumulate", ("accumulate",)),
    ("K3 mass apply", ("mass_apply", "apply_mass_elem")),
    ("K4 cheb_step (Triton)", ("_step", "_colnorm", "_rescale")),
    ("K5 apply_stacked", ("apply_stacked",)),
    ("K6 eps_at_quadrature (Triton)", ("_eps",)),
    ("K7 scalar_blocks", ("scalar_blocks",)),
    ("K8 pencil_bounds", ("pencil_rows", "pencil_max")),
    ("K11 scalar_pencil", ("scalar_pencil",)),
    ("torch elementwise", ("elementwise",)),
    ("torch reductions", ("reduce_kernel", "reduction")),
    ("copies and fills", ("memcpy", "memset")),
    ("linear algebra (cuBLAS / cuSOLVER)",
     ("gemm", "gemv", "cublas", "cutlass", "syevd", "geqrf", "orgqr",
      "ormqr", "potrf", "trsm", "cusolver", "sytrd", "steqr", "xmma")),
)


def _family(name: str) -> str:
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k.lower() in low for k in keys):
            return fam
    return "other"


def _card() -> str:
    import subprocess

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def config1_sweeps(n: int):
    """Phase seconds of a warm-up and ``n`` timed config-1 sweeps."""
    import torch

    from pl_fem_tpu_torch import workloads as wl
    from pl_fem_tpu_torch.solvers import TrueVectorialMaxwellSolver as S

    cfg, _, dg, geoms = wl.config1_sweep()
    runs = []
    for i in range(n + 1):
        t0 = time.perf_counter()
        S.solve_sweep(geoms, dg, wl.N_MODES, cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        phases = dict(S.last_sweep_times)
        print(f"config-1 sweep {'warm-up' if i == 0 else i}: {wall:.3f} s; "
              f"phases {json.dumps(phases)}", flush=True)
        if i:
            runs.append({"wall_s": wall, "phases_s": phases})
    return {"D": int(dg.n_dofs_padded), "runs": runs}


def scalar_solves(n: int):
    """Phase seconds of a warm-up and ``n`` timed config-1 scalar
    solves."""
    import torch

    from pl_fem_tpu_torch import workloads as wl
    from pl_fem_tpu_torch.solvers import ScalarHelmholtzSolver

    cfg, _, dg, _ = wl.config1_sweep()
    runs = []
    for i in range(n + 1):
        solver = ScalarHelmholtzSolver(wl.config1_geom(1.55), cfg)
        t0 = time.perf_counter()
        solver.solve(dg, wl.N_MODES)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        phases = dict(solver.last_solve_times)
        print(f"config-1 scalar solve {'warm-up' if i == 0 else i}: "
              f"{wall:.3f} s; phases {json.dumps(phases)}", flush=True)
        if i:
            runs.append({"wall_s": wall, "phases_s": phases})
    return {"D": int(dg.n_dofs_padded), "runs": runs}


def _event_ms(fn, reps: int) -> float:
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


def _r5_grid():
    """A mesh of the config-1 design at the r5 dataset's settings."""
    import tempfile

    from pl_fem_tpu_torch import cli
    from pl_fem_tpu_torch import workloads as wl
    from pl_fem_tpu_torch.ops.femgrid import MeshGenerator, export_device_grid

    with tempfile.TemporaryDirectory(prefix="profile_design_") as tmp:
        cfg = cli.generator(wl.dataset_argv(tmp))[0].config
    return export_device_grid(MeshGenerator.generate(
        wl.config1_geom(1.55), 1.0, cfg), cfg.mesh.bucket_rounding)


def stacked_apply_times(reps: int = 50):
    """CUDA-event milliseconds of one stacked apply at the shapes of the
    module note (after one warm-up call each)."""
    import numpy as np
    import torch

    from pl_fem_tpu_torch import workloads as wl
    from pl_fem_tpu_torch.ops import assembly as ta
    from pl_fem_tpu_torch.ops import kernels as tk

    dev = torch.device("cuda")
    _, _, dg1, _ = wl.config1_sweep()
    geom = wl.config1_geom(1.55)
    out = {}
    for name, dg, k in (("config1", dg1, 22), ("r5", _r5_grid(), 27)):
        ga = ta.grid_to_device(dg, dev)
        gs = ta.gather_scatter(ga)
        ea = ta.eps_arrays(geom.eps_params(), dev)
        A1 = ta.assemble_scalar_system(ga, ea, geom.k0)[0]
        prim = ta.assemble_vector3_system(ga, ea)[0]
        A3 = ta.vector3_stacked_A(prim, np.float32(geom.k0 * 1.49),
                                  np.float32(1.0))
        del prim
        g = torch.Generator(device=dev).manual_seed(0)
        D = dg.n_dofs_padded
        for C, A, mask in ((1, A1, ga.dof_valid), (3, A3, ga.interior_mask)):
            X = torch.randn((C * D, k), generator=g, device=dev)
            ms = _event_ms(lambda: tk._apply_stacked(A, gs, mask, 1.0, X, C),
                           reps)
            out[f"{name}_c{C}"] = {"D": int(D), "E": int(A.shape[0]),
                                   "k": k, "C": C, "ms": ms}
            print(f"stacked apply at {name} (D={D}, C={C}, k={k}): "
                  f"{ms:.4f} ms", flush=True)
    return out


def _sweep_qf(ta, tk, ga, gs, geoms, dev):
    """(QFactorSweep, mass diagonal) of ``geoms`` as the tree's
    ``solve_sweep`` assembles them: one batched K6 and one diagonal, or,
    in trees before it, ``assemble_vector3_qf`` per design."""
    import torch

    eas = [ta.eps_arrays(g.eps_params(), dev) for g in geoms]
    if hasattr(ta, "assemble_vector3_sweep"):
        return ta.assemble_vector3_sweep(ga, gs, eas)
    qfs = [ta.assemble_vector3_qf(ga, ea) for ea in eas]
    _, diag = qfs[-1]
    return tk.QFactorSweep(invJT=qfs[0][0].invJT, w=qfs[0][0].w,
                           inv_eps=torch.stack([q.inv_eps for q, _ in qfs]),
                           gp=ga.grad_phys), diag


def _sweep_bounds(ta, tk, ga, qs, geoms, betas, alpha):
    """The per-design bounds as the tree's ``solve_sweep`` forms them:
    K8 from the quadrature data in one launch, or, in trees before it,
    the primitives, the (E, 18, 18) stack and K8 on it per design."""
    import numpy as np
    import torch

    if hasattr(tk, "pencil_bounds_sweep"):
        b = tk.pencil_bounds_sweep(qs, ga.shape_vals, ga.elem_valid, betas,
                                   alpha)
        return b.cpu().numpy()
    out = []
    for g, beta in zip(geoms, betas):
        prim, _, _ = ta.assemble_vector3_system(
            ga, ta.eps_arrays(g.eps_params(), ga.qp_w.device))
        A = ta.vector3_stacked_A(prim, np.float32(beta), np.float32(alpha))
        out.append(tk.pencil_bounds_elem(A, prim["u_nn"], ga.elem_valid,
                                         C=3)[2])
    return torch.stack(out).cpu().numpy()


def sweep_setup_times(reps: int = 10):
    """Host seconds (to a synchronise) of the sweep's assemble work
    (``_sweep_qf``) and bounds (``_sweep_bounds``) on the config-1 mesh
    at its B = 8 designs and on a mesh at the r5 settings at B = 5: the
    median and range of ``reps`` calls after one warm-up."""
    import numpy as np
    import torch

    from pl_fem_tpu_torch import workloads as wl
    from pl_fem_tpu_torch.ops import assembly as ta
    from pl_fem_tpu_torch.ops import kernels as tk

    dev = torch.device("cuda")
    _, _, dg1, geoms1 = wl.config1_sweep()
    out = {}
    for name, dg, geoms in (("config1", dg1, geoms1),
                            ("r5", _r5_grid(),
                             [wl.config1_geom(float(w))
                              for w in np.linspace(1.53, 1.61, 5)])):
        ga = ta.grid_to_device(dg, dev)
        gs = ta.gather_scatter(ga)
        betas = np.array([g.k0 * 1.49 for g in geoms])
        t_asm, t_bnd = [], []
        for i in range(reps + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            qs, _ = _sweep_qf(ta, tk, ga, gs, geoms, dev)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            _sweep_bounds(ta, tk, ga, qs, geoms, betas, 1.0)
            t2 = time.perf_counter()
            if i:
                t_asm.append(t1 - t0)
                t_bnd.append(t2 - t1)
        out[name] = {"B": len(geoms), "assemble_s": t_asm,
                     "bounds_s": t_bnd,
                     "assemble_median_s": float(np.median(t_asm)),
                     "bounds_median_s": float(np.median(t_bnd))}
        print(f"sweep assemble / bounds at {name} (B={len(geoms)}): median "
              f"{np.median(t_asm):.5f} s ({min(t_asm):.5f}-{max(t_asm):.5f})"
              f" / {np.median(t_bnd):.5f} s ({min(t_bnd):.5f}-"
              f"{max(t_bnd):.5f})", flush=True)
    return out


def apply_times(reps: int = 20):
    """CUDA-event milliseconds of one packed A(beta) apply at the two
    shapes of the module note (after one warm-up call each)."""
    import numpy as np
    import torch

    from pl_fem_tpu_torch import workloads as wl
    from pl_fem_tpu_torch.ops import assembly as ta
    from pl_fem_tpu_torch.ops import kernels as tk

    dev = torch.device("cuda")
    _, _, dg1, _ = wl.config1_sweep()
    out = {}
    for name, dg, B, k in (("config1", dg1, 8, 22),
                           ("dataset", _r5_grid(), 5, 42)):
        ga = ta.grid_to_device(dg, dev)
        gs = ta.gather_scatter(ga)
        geoms = [wl.config1_geom(float(w)) for w in np.linspace(1.5, 1.6, B)]
        qs, _ = _sweep_qf(ta, tk, ga, gs, geoms, dev)
        betas = torch.tensor([g.k0 * 1.49 for g in geoms], device=dev)
        parks = torch.full((B,), 50.0, device=dev)
        g = torch.Generator(device=dev).manual_seed(0)
        X = torch.randn((dg.n_dofs_padded, B, 3, k), generator=g,
                        device=dev)

        ms = _event_ms(lambda: tk._apply_vector3_fused(
            qs, gs, ga.interior_mask, parks, betas, 1.0, X), reps)
        out[name] = {"D": int(dg.n_dofs_padded), "B": B, "k": k, "ms": ms}
        print(f"A(beta) apply at {name} (D={dg.n_dofs_padded}, B={B}, "
              f"k={k}): {ms:.3f} ms", flush=True)
    return out


def _device_ms(fn, reps: int = 20) -> float:
    """Device milliseconds per call of ``fn``: the CUDA intervals
    torch.profiler records over ``reps`` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               ) / 1e3 / reps


def _seed_inputs(dg, geoms, n_modes, cfg, dev):
    """K9's arguments: the coarse vectors, mask and tables of one real
    bootstrap of ``geoms`` on ``dg`` (recorded from the solver's call),
    with fresh standard-normal blocks."""
    import numpy as np
    import torch

    from pl_fem_tpu_torch.solvers import vectorial as tvec

    seed = tvec._seed_from_coarse
    got = {}

    def recorded(Hc, colmask, Pcols, Pwts, *args, **kw):
        got["inputs"] = (Hc, colmask, Pcols, Pwts)
        return seed(Hc, colmask, Pcols, Pwts, *args, **kw)

    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    tvec._seed_from_coarse = recorded
    try:
        tvec.TrueVectorialMaxwellSolver._bootstrap_sweep(geoms, dg, n_modes,
                                                         cfg, gen)
    finally:
        tvec._seed_from_coarse = seed
    Hc, colmask, cols, wts = got["inputs"]
    Hc = torch.tensor(Hc, device=dev)
    colmask = torch.tensor(colmask, device=dev)
    B, _, _, k = Hc.shape
    Dp = cols.shape[0]
    R1, R2 = (torch.randn((Dp, B, 3, k), generator=gen, device=dev)
              for _ in range(2))
    scale = float(np.float32(0.05 / np.sqrt(np.float32(3 * Dp))))
    return Hc, colmask, cols, wts, R1, R2, scale


def _ritz_inputs(dg, geoms, k, n_wanted, cfg, dev):
    """K10's arguments: the Rayleigh-Ritz of the Ritz vectors of two
    filter passes (the config's degree, B^-1 degree 4) from a random
    block, cuts and parks as ``solve_sweep`` sets them."""
    import numpy as np
    import torch

    from pl_fem_tpu_torch.ops import assembly as ta
    from pl_fem_tpu_torch.ops import kernels as tk
    from pl_fem_tpu_torch.solvers.vectorial import lp01_neff_estimate

    ga = ta.grid_to_device(dg, dev)
    gs = ta.gather_scatter(ga)
    qs, diag = ta.assemble_vector3_sweep(
        ga, gs, [ta.eps_arrays(g.eps_params(), dev) for g in geoms])
    alpha = cfg.solver.alpha_penalty
    betas = np.array([g.k0 * lp01_neff_estimate(
        g.k0, float(np.mean(g.core_radii)), g.n_core, g.n_clad)
        for g in geoms])
    cuts = np.array([min(b ** 2 / g.n_clad ** 2, 1.35 * g.k0 ** 2)
                     for b, g in zip(betas, geoms)])
    parks = 10.0 * np.maximum(cuts, 1.0)

    def f32(a):
        return torch.tensor(np.asarray(a, dtype=np.float32), device=dev)

    bounds = tk.pencil_bounds_sweep(qs, ga.shape_vals, ga.elem_valid,
                                    betas, alpha).cpu().numpy() * 1.1
    B, D = len(geoms), dg.n_dofs_padded
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    X = torch.randn((3 * D, B, k), generator=gen, device=dev)
    _, Xr, _ = tk.solve_lowest_sweep(
        qs, gs, ga.interior_mask, diag, X, cuts, betas, alpha, bounds,
        degree=cfg.solver.cheb_degree, passes=2, max_passes=2, parks=parks,
        binv_degree=4, n_wanted=n_wanted)
    _, AQ, BQ, theta, Ys = tk._sweep_ritz(
        qs, gs, ga.interior_mask, f32(parks), f32(betas), float(alpha),
        tk._fused_from_stacked(Xr))
    return (AQ, BQ, Ys.contiguous(), theta.contiguous(), f32(cuts),
            n_wanted)


def seed_rr_times(reps: int = 20, k_r5: int = 42):
    """K9 and K10 at the config-1 and r5 shapes (see the module note):
    CUDA-event and device milliseconds a call, and the twin's."""
    import tempfile

    import numpy as np
    import torch

    from pl_fem_tpu_torch import cli
    from pl_fem_tpu_torch import workloads as wl
    from pl_fem_tpu_torch.models import MCFGeometry
    from pl_fem_tpu_torch.ops import cuda_kernels as ck
    from pl_fem_tpu_torch.ops import kernels as tk

    dev = torch.device("cuda")
    cfg, _, dg1, geoms1 = wl.config1_sweep()
    with tempfile.TemporaryDirectory(prefix="profile_design_") as tmp:
        rcfg = cli.generator(wl.dataset_argv(tmp))[0].config
    slices = [MCFGeometry(7, 8.0 * sc, 1.5 * sc, 1.535, 1.0,
                          wavelength_um=1.55)
              for sc in np.linspace(rcfg.cmt_min_scale, 1.0,
                                    wl.DATASET_CMT_SLICES)]
    k1 = wl.N_MODES + cfg.solver.extra_vectors
    extra = rcfg.solver.extra_vectors
    out = {}
    for name, dg, geoms, c, k, n_wanted in (
            ("config1", dg1, geoms1, cfg, k1, min(k1, wl.N_MODES + 4)),
            ("r5", _r5_grid(), slices, rcfg, k_r5,
             min(k_r5, k_r5 - extra + 4))):
        seed = _seed_inputs(dg, geoms, k - c.solver.extra_vectors, c, dev)
        ritz = _ritz_inputs(dg, geoms, k, n_wanted, c, dev)
        row = {"Dp": int(dg.n_dofs_padded), "B": len(geoms), "k": k,
               "seeded": int((seed[1] == 1.0).sum())}
        # K9 again with no column seeded: no F gathered, R1 read whole
        unseeded = (seed[0], torch.zeros_like(seed[1])) + seed[2:]
        for kname, kernel, twin, args in (
                ("K9", ck.seed_prolong, tk.seed_prolong_plain, seed),
                ("K9_unseeded", ck.seed_prolong, tk.seed_prolong_plain,
                 unseeded),
                ("K10", ck.ritz_residual, tk.ritz_residual_plain, ritz)):
            row[kname] = {
                "ms": _event_ms(lambda: kernel(*args), reps),
                "device_ms": _device_ms(lambda: kernel(*args), reps),
                "plain_ms": _event_ms(lambda: twin(*args), 5)}
            print(f"{kname} at {name} (Dp={row['Dp']}, B={row['B']}, "
                  f"k={k}): {json.dumps(row[kname])}", flush=True)
        out[name] = row
        del seed, unseeded, ritz
        torch.cuda.empty_cache()
    return out


def scalar_setup_times(reps: int = 50):
    """The scalar pencil's set-up on the config-1 design (1.55 um) at the
    config-1 mesh and a mesh at the r5 settings: K11 (where the tree has
    it) and the three launches it replaced (K6, K7 with B's diagonal, K8
    at C = 1), each as CUDA-event and device milliseconds a call (the
    device time counts every kernel and memset) and host milliseconds a
    call without a synchronise."""
    import numpy as np
    import torch

    from pl_fem_tpu_torch import workloads as wl
    from pl_fem_tpu_torch.ops import assembly as ta
    from pl_fem_tpu_torch.ops import cuda_kernels as ck
    from pl_fem_tpu_torch.ops import kernels as tk
    from pl_fem_tpu_torch.ops import triton_kernels as trk

    dev = torch.device("cuda")
    geom = wl.config1_geom(1.55)
    k2 = float(np.float32(geom.k0) ** 2)
    Linv = torch.as_tensor(tk._LINV_REF, dtype=torch.float32, device=dev)
    tr = float(np.trace(tk._B_REF))
    out = {}
    for name, dg in (("config1", wl.config1_sweep()[2]), ("r5", _r5_grid())):
        ga = ta.grid_to_device(dg, dev)
        ea = ta.eps_arrays(geom.eps_params(), dev)

        def three():
            re, _ = trk.eps_at_quadrature(ga.qp_xy, ea)
            A, B = ck.scalar_blocks(ga.grad_phys, ga.qp_w, ga.shape_vals,
                                    re, k2)
            torch.diagonal(B, dim1=1, dim2=2).contiguous()
            return ck.pencil_bounds(A, B, ga.elem_valid, Linv, tr, 1)

        fns = {"K6+K7+K8": three}
        if hasattr(ck, "scalar_pencil"):
            fns["K11"] = lambda: ck.scalar_pencil(
                ga.grad_phys, ga.qp_w, ga.qp_xy, ga.shape_vals, ea, k2,
                ga.elem_valid, Linv, tr)
        row = {"E": int(ga.qp_w.shape[0])}
        for fname, fn in fns.items():
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            host = (time.perf_counter() - t0) / reps * 1e3
            torch.cuda.synchronize()
            row[fname] = {"ms": _event_ms(fn, reps),
                          "device_ms": _device_ms(fn, reps),
                          "host_ms": host}
            print(f"scalar set-up at {name} (E={row['E']}), {fname}: "
                  f"{json.dumps(row[fname])}", flush=True)
        out[name] = row
    return out


def dataset_design(n_cores: int = 7, scalar: bool = False):
    """The warm profile of one r5 dataset design (see the module note):
    through the sweep engine, or with ``scalar`` through the serial
    scalar pipeline."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    from pl_fem_tpu_torch import cli
    from pl_fem_tpu_torch import workloads as wl

    with tempfile.TemporaryDirectory(prefix="profile_design_") as tmp:
        gen, args = cli.generator(wl.scalar_dataset_argv(tmp) if scalar
                                  else wl.dataset_argv(tmp))
        samples = gen.sampler.generate_stratified_samples(
            args.n, quality_threshold=args.quality_threshold,
            ensure_diversity=True)
        sample = next(s for s in samples if int(s["n_cores"]) == n_cores)

        def simulate():
            if scalar:
                return gen.simulate_sample(sample)
            return gen.simulate_bucketed([sample])[0]

        t0 = time.perf_counter()
        simulate()
        torch.cuda.synchronize()
        cold = time.perf_counter() - t0
        gen.phase_times.clear()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            rec = simulate()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    by_name, spans = {}, []
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = e.time_range.elapsed_us()
        spans.append((e.time_range.start, e.time_range.end))
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + us)
    busy, end = 0.0, None                  # union of the device intervals
    for a, b in sorted(spans):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    fams = {}
    for name, (n, t) in by_name.items():
        f = fams.setdefault(_family(name), {"ms": 0.0, "launches": 0})
        f["ms"] += t / 1e3
        f["launches"] += n
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:15]
    out = {
        "sample": sample.get("sample_id"), "n_cores": n_cores,
        "n_dofs": rec.n_dofs, "success": bool(rec.success),
        "cold_wall_s": cold, "wall_s": wall, "device_ms": busy / 1e3,
        "device_idle_share": 1.0 - busy / 1e6 / wall,
        "phase_s": dict(gen.phase_times),
        "families_ms": dict(sorted(fams.items(),
                                   key=lambda kv: -kv[1]["ms"])),
        "top_kernels": [{"name": k[:120], "launches": n, "ms": t / 1e3}
                        for k, (n, t) in top]}
    print(f"{'scalar ' if scalar else ''}dataset design {out['sample']} "
          f"({n_cores} cores, "
          f"{rec.n_dofs} DOFs): cold {cold:.1f} s, warm {wall:.1f} s, "
          f"device {busy / 1e3:.0f} ms, idle "
          f"{100 * out['device_idle_share']:.1f}%", flush=True)
    for fam, v in out["families_ms"].items():
        print(f"  {fam}: {v['ms']:.1f} ms in {v['launches']} launches",
              flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--repo", default=str(HERE.parent))
    ap.add_argument("--out", default=None)
    ap.add_argument("--scalar", action="store_true",
                    help="profile one scalar dataset design instead")
    ap.add_argument("--kernels", action="store_true",
                    help="time K9, K10 and the scalar set-up alone instead")
    args = ap.parse_args(argv)
    repo = Path(args.repo).resolve()
    if sys.path and Path(sys.path[0] or ".").resolve() == HERE:
        sys.path.pop(0)         # run by path: the package's own modules
                                # must not shadow top-level names
    sys.path.insert(0, str(repo))
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("profile_design needs a CUDA device")
    import pl_fem_tpu_torch

    card = _card()
    print(f"card: {card}; package {Path(pl_fem_tpu_torch.__file__).parent}",
          flush=True)
    if args.kernels:
        result = {"card": card, "repo": str(repo),
                  "seed_rr_ms": seed_rr_times(),
                  "scalar_setup_ms": scalar_setup_times()}
    elif args.scalar:
        result = {"card": card, "repo": str(repo),
                  "scalar_solve": scalar_solves(SWEEPS),
                  "stacked_apply_ms": stacked_apply_times(),
                  "scalar_dataset_design": dataset_design(5, scalar=True)}
    else:
        result = {"card": card, "repo": str(repo),
                  "config1": config1_sweeps(SWEEPS),
                  "sweep_setup_s": sweep_setup_times(),
                  "apply_ms": apply_times(),
                  "dataset_design": dataset_design()}
    line = json.dumps(result)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
