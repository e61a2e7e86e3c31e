#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

In order:

1. needs CUDA (raises otherwise) and prints the card's name and power
   limit as nvidia-smi reports them;
2. builds the CUDA kernels (K1-K3, K5, K7-K12) from
   ``pl_fem_tpu_torch/ops/csrc`` with nvcc, one compiler process per
   source, and prints the build seconds (Triton builds K4 and K6 at
   their first launches in step 3);
3. on the config-1 production mesh (7-core hexagonal lantern, r 1.5 um,
   pitch 8 um, n_core 1.535, air clad; ~15k points, ~60k P2 DOFs),
   checks each kernel against its plain PyTorch twin at the main path's
   shapes (B = 8 designs, k = 22 columns) to within 1e-5 of max|y|, and
   times both with CUDA events beside the kernel's bound (the bytes the
   function must move at 3.35 TB/s, or its f32 operations at 67
   TFLOP/s, TF32 ones on the tensor cores at 495) and, where one
   PyTorch call computes the same function, that
   call (a cuSPARSE SpMM for K2 without epilogue and for K3). K1, the
   whole A(beta) apply, must take one launch and repeat bit for bit; its
   plan's rows per block and element evaluations per element are
   printed, and beside it the two passes that remain of the older
   three-pass apply (the mask and K2 with its epilogue). K2 also at
   L = 1 on the mass diagonal's element terms, as
   ``assembly.mass_diagonal`` feeds it; K3 in plain mode and as B^-1 of
   degree 1 and 4, which must launch it exactly `degree` times and
   repeat bit for bit (the sweep's rows hold more lanes than K12 takes);
   K12 (``binv_chain``) at the same lanes, off the path, against its
   plain twin and the four K3 step launches it would replace (bit for
   bit, or 1e-6 of each entry) and timed beside them (CUDA events and
   the profiler's device time, its bounds: the function's bytes and the
   steps' exchange); K4's renorm step (T2 unscaled and its scale),
   plain step and the step after a renorm, and an 18-step recurrence
   with two deferred renorms against the twin's. The scalar path's
   kernels on the same mesh at k = 22: K5 (stacked apply) at C = 1 on
   the scalar pencil's blocks and at C = 3 on the (E, 18, 18) vectorial
   blocks, there also against K1; K6 (permittivity: eps_re equal,
   eps_im to 1e-6); K7 (scalar blocks); K8 (spectrum bound, C = 1 and
   3, also >= its f64 value less 1e-4 relative); K11 (the scalar
   pencil's set-up in one launch: eps_re equal to its twin's at every
   point, A and B to 1e-5 of their scales, the bound to 1e-5 relative
   and >= its f64 value less 1e-4, one launch, bitwise repeatable), timed
   beside K6 + K7 + B's diagonal + K8 at C = 1 back to back, the
   scalar path's set-up before it, whose kernels stay as its
   yardstick; K4 on a (D, 1, 1, k)
   block; K2 and K3 at L = k. K5 is the whole stacked apply (mask,
   element product, accumulate, park) in one launch on K1's plan: it
   must take one launch and repeat bit for bit, it is timed beside a
   cuSPARSE SpMM of the assembled m A m + park (I - m), and its host
   time per call (no sync) is printed. The vectorial sweep's assemble
   and bounds kernels at the sweep's B = 8 designs: the batched K6
   (``inv_eps_at_quadrature``, 1/eps of every design in one launch) must
   equal its twin bit for bit, and its host time per call and device
   time (torch.profiler) are printed beside the older per-design K6
   launches and divides; K8 from the quadrature data
   (``pencil_bounds_vector3``, every design's bound in one launch) must
   repeat bit for bit and agree with its twin and with K8 on each
   design's assembled (E, 18, 18) stack to 1e-5 relative, and sit no
   further under its f64 twin than K8 may; on 1/eps scaled differently
   per design it must give each design another bound than design 0's
   data would; it is timed beside that per-design loop, with both peaks
   of device memory. K9 (``seed_prolong``, the bootstrap seed in the
   fused layout) on the coarse vectors and prolongation tables of one
   real bootstrap of the 8 designs, and K10 (``ritz_residual``, the
   Rayleigh-Ritz residuals and the pass gate) on the Rayleigh-Ritz of
   the Ritz vectors of two filter passes (degree 200, B^-1 degree 4)
   from a random block at B = 8, k = 22: K9 within 1e-5
   of max|X| of its twin, K10's residuals within 1e-6 + 1e-3 of the
   twin's and its gate the maximum of its own residuals over the wanted
   set, within the same of the twin's; both bitwise repeatable, one
   launch each, timed (CUDA events and the profiler's device time)
   beside their twins and their bounds (K9's the bytes its colmask
   needs, with the whole-block count beside it; K10's the larger of its
   bytes and its 3xTF32 products at the tensor cores' TF32 rate) and
   the share of the bound (no single PyTorch call computes either);
4. runs the main path twice, warm-up then timed:
   ``TrueVectorialMaxwellSolver.solve_sweep`` over 8 wavelengths
   1.50-1.64 um in fast mode (cheb_degree 200, cheb_passes 2,
   beta_passes 1, bootstrap on). Every design must return guided modes
   with n_clad < n_eff < n_core, and every kernel's launch count must
   rise during the timed run: K1 exactly once per A(beta) apply (per
   K4 step and per Rayleigh-Ritz pass), K2 only on the mass diagonal,
   the batched K6 and the sweep's K8 exactly once per ``solve_sweep``
   call (the bootstrap's coarse sweep and the fine one) and neither
   the single-design K6, K8 on a stack nor K11, K9 exactly once per
   bootstrapped sweep, K10 once per Rayleigh-Ritz pass, and no layout
   conversion inside ``kernels.cheb_sweep_rr_impl``; K1 and K4 are
   printed beside their counts before K9 and K10 (the same passes:
   504 / 500); the sweep's phase seconds,
   its ``assemble`` and ``bounds`` among them, are printed;
   4b. runs the same sweep (after a warm-up) with its designs split over
   two slices of the card (``solve_sweep(mesh=design_mesh(["cuda:0"] *
   2))``): n_eff within 1e-5 relative of the unsplit sweep, every
   vectorial Rayleigh-Ritz on 4 designs with its slice's device current
   and the slices in order, K1 once per A apply and K10 once per pass
   in each slice, the batched K6, K8 and K9 once per sweep or bootstrap;
   it prints both s/design with the card's name and the split's
   launches beside the unsplit sweep's; then B = 5 over the same two
   slices (padded to 6, 3 designs a slice) against the unsplit B = 5
   sweep from the same bootstrap noise and coarse start (n_eff within
   1e-5), and, where more than one card is visible, the B = 8 sweep
   over all of them;
5. solves a single-core step fiber (r 1.5 um, n_core 1.53, air clad)
   through the same path and holds HE11's n_eff to the exact vector
   dispersion (ops/analytic.vector_modes) within 1e-3 relative, the
   fast-mode accuracy class; then solves it with the balanced and the
   accuracy presets (``config.solver_preset``, B = 1), each within the
   same 1e-3, and prints their seconds; the same per-sweep counts of
   K6, K8, K9 and K10 hold in these solves;
6. runs the dataset engine through the port's CLI at the production
   settings of configs/r5_dataset.yaml (fast mode, 9000-18000 mesh
   points, bucket band 0.20, sweep engine with the 2-bucket pipeline,
   seed 42, quality threshold 0.35) plus 5 CMT slices, on 8 of the
   config's 220 samples (the one cut), into a temporary directory
   removed afterwards. It checks the records (8 lines,
   every validated sample solved in a bucket sweep, at least one
   success with finite mux/demux losses, a CMT IL and a power
   conservation in (0, 1.05]), that K1-K4 launched during the run (K1
   once per apply, K2 only on the mass diagonal; the batched K6 and the
   sweep's K8 once per sweep), the run's summed ``assemble`` and
   ``bounds`` seconds, and that a second run on the same directory
   solves nothing; then it holds each kernel against its twin at the
   largest (B, k) the engine used, on a mesh at the engine's settings
   (K5-K8 too, at the scalar engine's k), and the sweep's K6, K8, K9 and
   K10 at B = 5 taper slices of the 7-core design (core positions and
   radii scaled 0.35-1.0, as the CMT slices move them), K9 and K10 at
   that k, with the peak device memory of one Rayleigh-Ritz pass there,
   K10 against its twin's chain; the dataset run's launch counts are held
   as in step 4;
7. solves the scalar Helmholtz modes of the config-1 design (1.55 um)
   on the production mesh with ``ScalarHelmholtzSolver`` (10 modes, fast
   preset), device backend then hybrid (host ARPACK) backend; the two
   n_eff lists must agree to 5e-5, the kernels K2-K5 and K10-K12 must
   launch in the device solve (K5 once per A apply: per K4 step and per
   Rayleigh-Ritz pass; K2 only on the mass diagonal; K10 once per pass;
   K11 once per solve, K12 once per K4 step, and the standalone K6, K7
   and K8 never); the
   assemble phase's seconds are split into upload, plans and kernels on
   fresh device grids; and the single-core fiber's LP01
   must match the exact LP dispersion (ops/analytic.lp_modes) within
   1e-4 relative, with K11 once and K6, K7, K8 never in its solve;
8. runs the scalar dataset engine through the CLI (``--scalar
   --cmt-slices 5`` at configs/r5_dataset.yaml) on 4 of the config's 220
   samples (the one cut): every validated sample must be a
   ``scalar_cascade`` record, at least one must succeed with finite
   losses, K2-K5 and K10-K12 must launch (K5 once per A apply, K2 only
   at L = 1, K11 once per solve, K12 once per K4 step and K6, K7, K8
   never), and a second run must solve nothing; then K5-K8, K11 and K12
   against their twins (K12 also against the K3 step chain, at k, at
   BINV_LANES lanes and at one lane more) on the dataset's mesh at the
   run's largest k.

The config-1 and r5 workloads are defined in
``pl_fem_tpu_torch/workloads.py``. It prints the per-kernel JSON line,
then the card's name and power limit, then, last, the device line. Any
failure raises and the script exits non-zero.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

FIBER_MESH_MIN = 9000        # ~50k DOFs: the fiber at the production scale
FIBER_REFINE = 1.5
KERNEL_RTOL = 1e-5           # of max|y|, f32 kernel vs f32 twin
SPLIT_RTOL = 1e-5            # split vs unsplit sweep n_eff, relative
# the H100's published peaks (SXM, 700 W): HBM3 bytes/s, f32 FLOP/s
# outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
TF32_FLOPS_PER_S = 495e12    # dense, on the tensor cores
# K1's f32 operations per (element, design, column, quadrature point):
# values and gradients 108, curl / divergence terms 17, pull-back 108
K1_FLOPS_PER_POINT = 233
FIBER_RTOL = 1e-3            # HE11 n_eff vs exact, fast-mode class
LP01_RTOL = 1e-4             # scalar LP01 n_eff vs the exact LP dispersion
SCALAR_PARITY = 5e-5         # device vs hybrid n_eff, tests/test_solvers.py:67
EPS_IM_TOL = 1e-6            # K6 eps_im vs twin, of max(1, max|eps_im|)
BOUND_F64_SLACK = 1e-4       # K8 may sit this far (relative) under f64
REPO = Path(__file__).resolve().parent


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


def _device_ms(fn, kernels: int, reps: int = 20, name: str = ""):
    """Device milliseconds per call of ``fn``, which launches ``kernels``
    kernels (those whose name holds ``name``, where given): the CUDA
    intervals that torch.profiler records over ``reps`` calls (the event
    time of a short kernel counts the host's launch rate as well). None
    unless the profiler recorded every launch: in a long process it can
    come back with part of them."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    spans = [e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and name in e.name]
    if len(spans) != kernels * reps:
        return None
    return sum(spans) / 1e3 / reps


def _share(bound_ms, ms) -> str:
    """The bound as a share of a measured time, or "not measured"."""
    return "not measured" if ms is None else f"{100.0 * bound_ms / ms:.0f}%"


def _finite(*xs) -> bool:
    return all(x is not None and math.isfinite(x) for x in xs)


def _compare(name, kernel_fn, plain_fn, bound, library_fn=None):
    """Run kernel and twin on the same inputs, then time both (and the
    library yardstick, if any). ``bound`` is (bytes, flops) of the
    function, the flops at the f32 rate, or (bytes, ops seconds) given
    as a third item; returns the kernel's row of the JSON line."""
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
    library_ms = None if library_fn is None else _event_ms(library_fn)
    nbytes, flops = bound[:2]
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (bound[2] if len(bound) > 2 else flops / F32_FLOPS_PER_S) * 1e3
    bound_ms = max(t_bytes, t_ops)
    lib = "" if library_ms is None else f"  library {library_ms:.3f} ms"
    print(f"  {name}: max_abs_err={err:.3e} (max|y|={scale:.3e}, limit "
          f"{KERNEL_RTOL:g} of max|y|)  kernel {ms:.3f} ms  plain "
          f"{plain_ms:.3f} ms{lib}  bound {bound_ms:.3f} ms "
          f"({100.0 * bound_ms / ms:.0f}% of it)", flush=True)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms}


def _k12_checks(X, gs, w, mask, ds, degree, tag):
    """K12 (``binv_chain``) on one (D, L) block: against its plain twin
    ``binv_chain_plain`` (the K3 step twins in torch ops) within
    KERNEL_RTOL of max|y|, and against the chain of ``degree`` K3 step
    launches it replaces, equal bit for bit (or within 1e-6 of each
    entry); one launch and no K3 launch, where R and Z live
    (``binv_on_chip``); times by CUDA events (K12, the twin, the K3
    chain) and by the profiler's device intervals (K12, the K3 chain),
    and two bytes bounds of the launch: the function's (W in, the result
    out, the tables) and the exchange's (also every middle Dd written and
    read back once, and in device memory R and Z written, read and
    rewritten)."""
    import numpy as np
    import torch

    from pl_fem_tpu_torch.ops import cuda_kernels as ck
    from pl_fem_tpu_torch.ops import kernels as tkn

    D, L = X.shape
    E, Q = w.shape
    N = tkn.shape_table(X.device)
    theta, a, b = tkn._binv_coefs(np.float32(tkn.MASS_LO),
                                  np.float32(tkn.MASS_HI), degree)
    args = (X, gs, w, N, mask, ds, a, b, theta, degree)

    def chain():
        return ck.binv_chain(*args)

    def k3_chain():
        return ck.mass_step_chain(ck.mass_apply, *args)

    n3, n12, nc = (ck.mass_apply.launches, ck.binv_chain.launches,
                   ck.binv_chain.on_chip)
    y = chain()
    if (ck.mass_apply.launches, ck.binv_chain.launches) != (n3, n12 + 1):
        raise AssertionError(f"K12{tag}: not one launch, or a K3 launch")
    on_chip = ck.binv_chain.on_chip == nc + 1
    ref = k3_chain()
    torch.cuda.synchronize()
    rel = float(((y - ref).abs() / ref.abs().clamp_min(1e-30)).max())
    if not (torch.equal(y, ref) or rel <= 1e-6):
        raise AssertionError(f"K12{tag}: {rel:.3e} relative from the K3 "
                             f"chain (limit 1e-6 of each entry)")
    if not torch.equal(y, chain()):
        raise AssertionError(f"K12{tag} is not bitwise repeatable")
    blk = 4 * D * L
    tables = 4 * (E * 6 + E * Q + Q * 6 + 2 * D) + 4 * D
    fn_bytes = 2 * blk + tables
    ex_bytes = fn_bytes + 2 * (degree - 1) * blk \
        + (0 if on_chip else 4 * (degree - 1) * blk)
    row = _compare(f"K12 binv_chain{tag} vs its plain twin", chain,
                   lambda: ck.binv_chain_plain(*args), (fn_bytes, 0))
    ms, k3_ms = row["ms"], _event_ms(k3_chain)
    dev_ms = _device_ms(chain, 1, name="binv_chain")
    k3_dev_ms = _device_ms(k3_chain, degree, name="mass_apply")
    fn_ms = fn_bytes / HBM_BYTES_PER_S * 1e3
    ex_ms = ex_bytes / HBM_BYTES_PER_S * 1e3
    print(f"  K12 binv_chain{tag} (D={D}, L={L}, degree {degree}, R and Z "
          f"{'on chip' if on_chip else 'in device memory'}): "
          f"{'bit-equal' if torch.equal(y, ref) else f'{rel:.2e} rel'} to "
          f"the K3 chain; events {ms:.4f} ms (K3 chain {k3_ms:.4f} ms, "
          f"plain twin {row['plain_ms']:.4f} ms); device {dev_ms} ms (K3 "
          f"chain {k3_dev_ms} ms); bound {fn_ms:.4f} ms function "
          f"({_share(fn_ms, dev_ms)} of device), {ex_ms:.4f} ms exchange "
          f"({_share(ex_ms, dev_ms)})", flush=True)
    return {**row, "device_ms": dev_ms, "k3_chain_ms": k3_ms,
            "k3_chain_device_ms": k3_dev_ms, "degree": degree, "lanes": L,
            "on_chip": on_chip, "bit_equal": torch.equal(y, ref),
            "max_rel_err": rel, "bound_ms": fn_ms, "exchange_bound_ms": ex_ms,
            "bound_by": "bytes"}


def _mass_csr(gs, w, N, mask, park):
    """The assembled f32 CSR of M~ = diag(m) M diag(m) + park diag(1 - m)
    from the element coefficients: the SpMM yardstick beside K3 (the
    port never calls it)."""
    import torch

    D = mask.shape[0]
    C = torch.einsum("eq,qi,qj->eij", w, N, N)
    ed = gs.elem_dofs.long()
    rows = ed[:, :, None].expand_as(C).reshape(-1)
    cols = ed[:, None, :].expand_as(C).reshape(-1)
    vals = (C * mask[ed][:, :, None] * mask[ed][:, None, :]).reshape(-1)
    diag = torch.arange(D, device=mask.device)
    M = torch.sparse_coo_tensor(
        torch.stack([torch.cat([rows, diag]), torch.cat([cols, diag])]),
        torch.cat([vals, park * (1.0 - mask)]), (D, D)).coalesce()
    return M.to_sparse_csr()


def _stacked_csr(elem_dofs, A, mask, park, C):
    """The assembled f32 CSR of m A m + park (I - m) on the stacked
    (C D) rows from the (E, 6C, 6C) blocks: the SpMM yardstick beside K5
    (the port never calls it)."""
    import torch

    D = mask.shape[0]
    ed = torch.cat([elem_dofs.long() + c * D for c in range(C)], dim=1)
    m = mask.repeat(C)
    rows = ed[:, :, None].expand_as(A).reshape(-1)
    cols = ed[:, None, :].expand_as(A).reshape(-1)
    vals = (A * m[ed][:, :, None] * m[ed][:, None, :]).reshape(-1)
    diag = torch.arange(C * D, device=mask.device)
    M = torch.sparse_coo_tensor(
        torch.stack([torch.cat([rows, diag]), torch.cat([cols, diag])]),
        torch.cat([vals, park * (1.0 - m)]), (C * D, C * D)).coalesce()
    return M.to_sparse_csr()


def _host_ms(fn, reps: int = 200) -> float:
    """Host milliseconds per call of ``fn`` without a synchronise: the
    wrapper's checks and the launch (the device runs behind)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize()
    return host


def _scatter_csr(gs, E):
    """The 0/1 element -> DOF CSR (D x 6E) of the transpose tables: the
    SpMM yardstick beside K2 without its epilogue."""
    import torch

    dev = gs.idx_v.device
    split, Wv = gs.idx_v.shape
    rows = torch.cat([
        torch.arange(split, device=dev)[:, None].expand(split, Wv)
        [gs.valid_v],
        split + torch.arange(gs.idx_e.shape[0], device=dev)[:, None]
        .expand(-1, 2)[gs.valid_e]])
    cols = torch.cat([gs.idx_v[gs.valid_v], gs.idx_e[gs.valid_e]]).long()
    S = torch.sparse_coo_tensor(torch.stack([rows, cols]),
                                torch.ones(rows.shape[0], device=dev),
                                (split + gs.idx_e.shape[0], 6 * E))
    return S.coalesce().to_sparse_csr()


@contextlib.contextmanager
def _watch_sweep():
    """While active, count the Rayleigh-Ritz passes, vectorial
    (``kernels.cheb_sweep_rr_impl``, one A(beta) apply each) and stacked
    (``kernels.cheb_rr_pass_impl``, one stacked apply each), the calls of
    ``TrueVectorialMaxwellSolver.solve_sweep`` (the bootstrap's nested
    coarse sweep among them), the bootstraps that seeded a sweep
    (``_bootstrap_sweep`` calls that returned a seed), the layout
    conversions of ``kernels`` (``_fused_from_stacked``,
    ``_stacked_from_fused``) in all and inside a vectorial
    Rayleigh-Ritz, the scalar solves on the device
    (``ScalarHelmholtzSolver._solve_device`` calls), the B^-1 chains of
    degree >= 2 (``kernels._binv_steps`` calls) on rows of at most
    ``BINV_LANES`` lanes and on wider ones, record the lane
    count of
    every K2 launch made through ``kernels``, record each vectorial
    Rayleigh-Ritz's design count, device and current CUDA device
    (``rr_slices``: one per slice and pass of a split sweep), and sum the
    seconds of
    every named phase of every PhaseTimer (``phase_s``: the sweeps'
    ``assemble`` and ``bounds`` among them): the port's own functions,
    wrapped (two sweep threads may call them)."""
    from pl_fem_tpu_torch.ops import cuda_kernels as ck
    from pl_fem_tpu_torch.ops import kernels as tkn
    from pl_fem_tpu_torch.solvers import scalar as tsc
    from pl_fem_tpu_torch.solvers import vectorial as tvec
    from pl_fem_tpu_torch.utils import profiling

    seen = {"rr_passes": 0, "stacked_passes": 0, "sweeps": 0, "boots": 0,
            "scalar_solves": 0, "conversions": 0, "rr_conversions": 0,
            "k2_lanes": set(), "phase_s": {}, "rr_slices": [],
            "short_chains": 0, "wide_chains": 0}
    lock = threading.Lock()
    in_rr = threading.local()
    rr, srr = tkn.cheb_sweep_rr_impl, tkn.cheb_rr_pass_impl
    f2s, s2f = tkn._fused_from_stacked, tkn._stacked_from_fused
    acc = tkn.accumulate
    steps = tkn._binv_steps
    solver = tvec.TrueVectorialMaxwellSolver
    sweep = solver.__dict__["solve_sweep"]
    boot = solver.__dict__["_bootstrap_sweep"]
    ssolve = tsc.ScalarHelmholtzSolver._solve_device
    phase = profiling.PhaseTimer.phase

    @contextlib.contextmanager
    def timed_phase(timer, name):
        t0 = time.perf_counter()
        try:
            with phase(timer, name):
                yield
        finally:
            with lock:
                seen["phase_s"][name] = (seen["phase_s"].get(name, 0.0)
                                         + time.perf_counter() - t0)

    def counted(fn, key):
        def wrapped(*args, **kw):
            with lock:
                seen[key] += 1
            return fn(*args, **kw)
        return wrapped

    def acc_seen(Ye, *args, **kw):
        with lock:
            seen["k2_lanes"].add(Ye.shape[-1])
        return acc(Ye, *args, **kw)

    def steps_seen(w, gs, mask, ds, lo, hi, Xl, degree):
        if degree > 1:
            short = Xl.shape[1] <= ck.BINV_LANES
            with lock:
                seen["short_chains" if short else "wide_chains"] += 1
        return steps(w, gs, mask, ds, lo, hi, Xl, degree)

    def rr_seen(*args, **kw):
        import torch

        Xff = args[6]
        with lock:
            seen["rr_passes"] += 1
            seen["rr_slices"].append((Xff.shape[1], Xff.device.index,
                                      torch.cuda.current_device()))
        in_rr.active = True
        try:
            return rr(*args, **kw)
        finally:
            in_rr.active = False

    def conversion(fn):
        def wrapped(*args, **kw):
            with lock:
                seen["conversions"] += 1
                seen["rr_conversions"] += getattr(in_rr, "active", False)
            return fn(*args, **kw)
        return wrapped

    def boot_seen(cls, *args, **kw):
        out = boot.__func__(cls, *args, **kw)
        if out is not None:
            with lock:
                seen["boots"] += 1
        return out

    tkn.cheb_sweep_rr_impl = rr_seen
    tkn.cheb_rr_pass_impl = counted(srr, "stacked_passes")
    tkn._fused_from_stacked = conversion(f2s)
    tkn._stacked_from_fused = conversion(s2f)
    tkn.accumulate = acc_seen
    tkn._binv_steps = steps_seen
    solver.solve_sweep = classmethod(counted(sweep.__func__, "sweeps"))
    solver._bootstrap_sweep = classmethod(boot_seen)
    tsc.ScalarHelmholtzSolver._solve_device = counted(ssolve, "scalar_solves")
    profiling.PhaseTimer.phase = timed_phase
    try:
        yield seen
    finally:
        tkn.cheb_sweep_rr_impl, tkn.cheb_rr_pass_impl = rr, srr
        tkn._fused_from_stacked, tkn._stacked_from_fused = f2s, s2f
        tkn.accumulate = acc
        tkn._binv_steps = steps
        solver.solve_sweep = sweep
        solver._bootstrap_sweep = boot
        tsc.ScalarHelmholtzSolver._solve_device = ssolve
        profiling.PhaseTimer.phase = phase


def _check_sweep_launches(what, launches, seen):
    """The vectorial sweep's assemble and bounds: the batched K6 and K8
    from the quadrature data launch exactly once per ``solve_sweep``
    call, and the single-design K6, K8 on an assembled stack and the
    scalar path's K11 not at all; prints the summed assemble and bounds
    seconds."""
    n6, n8 = (launches["inv_eps_at_quadrature"],
              launches["pencil_bounds_vector3"])
    ph = seen["phase_s"]
    print(f"{what}: {seen['sweeps']} vectorial sweeps; batched K6 launches "
          f"{n6}, K8 (quadrature data) launches {n8}, single-design K6 "
          f"{launches['eps_at_quadrature']}, K8 on a stack "
          f"{launches['pencil_bounds']}; assemble "
          f"{ph.get('assemble', 0.0):.4f} s, bounds "
          f"{ph.get('bounds', 0.0):.4f} s summed over the sweeps",
          flush=True)
    if not seen["sweeps"] or n6 != seen["sweeps"] or n8 != seen["sweeps"]:
        raise AssertionError(f"{what}: the batched K6 and the sweep's K8 "
                             f"did not launch once per sweep")
    if launches["eps_at_quadrature"] or launches["pencil_bounds"] \
            or launches["scalar_pencil"]:
        raise AssertionError(f"{what}: the vectorial path launched the "
                             f"single-design K6, K8 on a stack or K11")


def _check_scalar_launches(what, launches, seen):
    """The scalar pencil's set-up: K11 launches exactly once per scalar
    solve on the device, and the standalone K6 (single design), K7 and
    K8 (on assembled blocks) it replaces not at all."""
    n11 = launches["scalar_pencil"]
    old = {n: launches[n] for n in ("eps_at_quadrature", "scalar_blocks",
                                    "pencil_bounds")}
    print(f"{what}: {seen['scalar_solves']} scalar solves on the device; "
          f"K11 launches {n11}; standalone K6 / K7 / K8 launches "
          f"{old['eps_at_quadrature']} / {old['scalar_blocks']} / "
          f"{old['pencil_bounds']}; K12 launches {launches['binv_chain']} "
          f"for {launches['cheb_step']} K4 steps", flush=True)
    if launches["binv_chain"] != launches["cheb_step"]:
        raise AssertionError(f"{what}: B^-1 did not run as one K12 launch "
                             f"per filter step")
    if not seen["scalar_solves"] or n11 != seen["scalar_solves"]:
        raise AssertionError(f"{what}: K11 did not launch once per scalar "
                             f"solve")
    if any(old.values()):
        raise AssertionError(f"{what}: the scalar path launched the "
                             f"standalone K6, K7 or K8")


def _check_apply_launches(what, launches, seen):
    """Every K4 step follows one A apply, and every Rayleigh-Ritz pass
    makes one: K1 (the vectorial sweeps) and K5 (the stacked filter)
    launch once per apply, K1 + K5 = K4 steps + passes; K2 only sums the
    mass diagonal (L = 1), never per filter step. K12 launches once per
    B^-1 chain of degree >= 2 on rows of at most BINV_LANES lanes (the
    scalar filter's), never on wider rows (the vectorial sweep's)."""
    from pl_fem_tpu_torch.ops import cuda_kernels as ck

    n1, n5, n4 = (launches["apply_vector3"], launches["apply_stacked"],
                  launches["cheb_step"])
    rr, srr = seen["rr_passes"], seen["stacked_passes"]
    print(f"{what}: K1 launches {n1} + K5 launches {n5} = K4 steps {n4} + "
          f"Rayleigh-Ritz passes {rr} (vectorial) + {srr} (stacked); K2 "
          f"launches {launches['accumulate']} at lane counts "
          f"{sorted(seen['k2_lanes'])}", flush=True)
    if n1 + n5 != n4 + rr + srr:
        raise AssertionError(f"{what}: K1 / K5 did not launch once per A "
                             f"apply")
    if (n1 > 0) != (rr > 0) or (n5 > 0) != (srr > 0):
        raise AssertionError(f"{what}: an apply kernel launched without "
                             f"its path, or a path without its kernel")
    if seen["k2_lanes"] - {1}:
        raise AssertionError(f"{what}: K2 launched on lane blocks (the "
                             f"filter's), not only on the mass diagonal")
    print(f"{what}: K12 launches {launches['binv_chain']} for "
          f"{seen['short_chains']} B^-1 chains of at most {ck.BINV_LANES} "
          f"lanes; {seen['wide_chains']} wider chains on K3 steps",
          flush=True)
    if launches["binv_chain"] != seen["short_chains"]:
        raise AssertionError(f"{what}: K12 did not launch once per B^-1 "
                             f"chain of at most {ck.BINV_LANES} lanes")


def _check_seed_rr_launches(what, launches, seen, before=None):
    """K9 launches exactly once per bootstrapped sweep (a
    ``_bootstrap_sweep`` that returned a seed), K10 once per
    Rayleigh-Ritz pass (vectorial and stacked), and no layout conversion
    happens inside a vectorial Rayleigh-Ritz; prints K1 and K4 beside
    ``before``, their counts in the same run before K9 and K10 (the
    Rayleigh-Ritz in torch ops), where given."""
    n9, n10 = launches["seed_prolong"], launches["ritz_residual"]
    passes = seen["rr_passes"] + seen["stacked_passes"]
    print(f"{what}: K9 launches {n9} for {seen['boots']} bootstrapped "
          f"sweeps; K10 launches {n10} for {passes} Rayleigh-Ritz passes; "
          f"layout conversions {seen['conversions']} in all, "
          f"{seen['rr_conversions']} inside a vectorial Rayleigh-Ritz",
          flush=True)
    if before is not None:
        print(f"{what}: K1 launches {launches['apply_vector3']}, K4 "
              f"launches {launches['cheb_step']} (before K9 and K10: "
              f"{before[0]} / {before[1]})", flush=True)
    if n9 != seen["boots"]:
        raise AssertionError(f"{what}: K9 did not launch once per "
                             f"bootstrapped sweep")
    if n10 != passes:
        raise AssertionError(f"{what}: K10 did not launch once per "
                             f"Rayleigh-Ritz pass")
    if seen["rr_conversions"]:
        raise AssertionError(f"{what}: the Rayleigh-Ritz converted the "
                             f"layout")


def _kernel_checks(dg, geoms, k, dev):
    """Each kernel against its plain twin on ``dg`` with B = len(geoms)
    designs and k columns; returns {name: row} with each row's error,
    kernel / twin / library times and bound."""
    import numpy as np
    import torch

    from pl_fem_tpu_torch.ops import cuda_kernels as ck
    from pl_fem_tpu_torch.ops import kernels as tkn
    from pl_fem_tpu_torch.ops.assembly import (assemble_vector3_sweep,
                                               eps_arrays, gather_scatter,
                                               grid_to_device)
    from pl_fem_tpu_torch.ops.kernels import _N_REF, shape_table

    ga = grid_to_device(dg, dev)
    gs = gather_scatter(ga)
    qs, diag = assemble_vector3_sweep(
        ga, gs, [eps_arrays(g.eps_params(), dev) for g in geoms])
    B = len(geoms)
    D = dg.n_dofs_padded
    E = dg.elem_dofs.shape[0]
    Q = qs.w.shape[1]
    L = B * 3 * k
    split, Wv = gs.idx_v.shape
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    X = torch.randn((D, L), generator=gen, device=dev)
    mask = ga.interior_mask
    Xm = X * mask[:, None]
    betas = torch.tensor([g.k0 * 1.49 for g in geoms], device=dev)
    N = shape_table(dev)
    park = torch.full((L,), 50.0, device=dev)
    parks = torch.full((B,), 50.0, device=dev)
    apply_args = (gs, qs.gp, qs.w, qs.inv_eps, betas, 1.0, N, mask, parks)
    # the twin's element results feed K2's rows
    Ye = ck.apply_vector3_elem_plain(Xm, gs.elem_dofs, qs.gp, qs.w,
                                     qs.inv_eps, betas, 1.0, N, k)
    tables = (gs.idx_v, gs.valid_v, gs.idx_e, gs.valid_e)
    W = torch.randn((D, B, 3, k), generator=gen, device=dev)
    T1 = torch.randn((D, B, 3, k), generator=gen, device=dev)
    T0 = torch.randn((D, B, 3, k), generator=gen, device=dev)
    c = torch.linspace(100.0, 120.0, B, device=dev)
    h = torch.linspace(900.0, 1000.0, B, device=dev)
    dinv = 1.0 / torch.sqrt(diag)
    lo, hi = np.float32(tkn.MASS_LO), np.float32(tkn.MASS_HI)
    # bytes of the operands every function reads once: a (D, L) block,
    # the transpose tables (int32 index + bool flag per slot), the
    # element tables K3 reads (dofs, weights), the mass mask / scale
    blk = 4 * D * L
    tab = 5 * (split * Wv + 2 * (D - split))
    mtab = tab + 4 * E * 6 + 4 * E * Q + 4 * Q * 6 + 4 * D + 4 * D
    print(f"kernel checks at D={D} E={E} B={B} k={k} L={L}:", flush=True)
    res = {}
    # K1: X in, Y out, the element tables (dofs, gradients, weights,
    # 1/eps per design), betas, shape table, mask, parks
    n0 = ck.apply_vector3.launches
    y = ck.apply_vector3(X, *apply_args)
    if ck.apply_vector3.launches != n0 + 1:
        raise AssertionError("K1 took more than one launch for one apply")
    if not torch.equal(y, ck.apply_vector3(X, *apply_args)):
        raise AssertionError("K1 is not bitwise repeatable")
    plan = gs.apply_plan
    k1 = _compare(
        "K1 apply_vector3 (mask, element math, accumulate, park)",
        lambda: ck.apply_vector3(X, *apply_args),
        lambda: ck.apply_vector3_plain(X, *apply_args),
        (2 * blk + 4 * (E * 6 + E * Q * 13 + B * E * Q + B + Q * 6 + D + B),
         K1_FLOPS_PER_POINT * E * Q * B * k))
    k1.update(rows_per_block=plan.rows, recompute=plan.recompute)
    res["apply_vector3"] = k1
    print(f"  K1 plan: {plan.rows} rows per block, {plan.recompute:.3f} "
          f"element evaluations per element, at most {plan.max_entries} "
          f"entries per block", flush=True)
    res["accumulate"] = _compare(
        "K2 accumulate (epilogue)",
        lambda: ck.accumulate(Ye, *tables, X, mask, park),
        lambda: ck.accumulate_plain(Ye, *tables, X, mask, park),
        (4 * E * 6 * L + tab + 2 * blk + 4 * D + 4 * L, 0))
    # the older apply was three passes: the mask, an element-only kernel
    # (no longer built) and K2 with its epilogue; the two that remain
    mask_ms = _event_ms(lambda: X * mask[:, None])
    k1["before"] = {"mask_pass_ms": mask_ms,
                    "accumulate_epilogue_ms": res["accumulate"]["ms"]}
    print(f"  K1 before, the older three-pass apply: mask pass "
          f"{mask_ms:.3f} ms + the element pass (not built any more) + K2 "
          f"with epilogue {res['accumulate']['ms']:.3f} ms", flush=True)
    S = _scatter_csr(gs, E)
    Yflat = Ye.view(6 * E, L)
    bare = _compare(
        "K2 accumulate (no epilogue)",
        lambda: ck.accumulate(Ye, *tables),
        lambda: ck.accumulate_plain(Ye, *tables),
        (4 * E * 6 * L + tab + blk, 0),
        lambda: torch.sparse.mm(S, Yflat))
    # the SpMM computes K2 without its epilogue: it is that row's yardstick
    res["accumulate"]["no_epilogue"] = bare
    # the mass diagonal's element terms sum_q w N_i^2, as
    # assembly.mass_diagonal builds them: K2's L = 1 row-per-thread path
    n2 = torch.as_tensor(_N_REF, dtype=torch.float32, device=dev) ** 2
    Yd = torch.einsum("eq,qi->ei", qs.w, n2)[:, :, None].contiguous()
    res["accumulate"]["diagonal"] = _compare(
        "K2 accumulate (L = 1, mass diagonal)",
        lambda: ck.accumulate(Yd, *tables),
        lambda: ck.accumulate_plain(Yd, *tables),
        (4 * E * 6 + tab + 4 * D, 0),
        lambda: torch.sparse.mm(S, Yd.view(6 * E, 1)))
    del S, Yflat

    Mt = _mass_csr(gs, qs.w, N, mask, 50.0)
    spmm_err = float((torch.sparse.mm(Mt, X) - tkn._apply_mass_fused_plain(
        qs, gs, mask, X, 50.0)).abs().max())
    print(f"  SpMM yardstick of K3: {Mt._nnz()} nonzeros, max|SpMM - twin| "
          f"= {spmm_err:.3e}", flush=True)
    res["mass_apply"] = _compare(
        "K3 mass_apply (plain mode)",
        lambda: tkn._apply_mass_fused(qs, gs, mask, X, 50.0),
        lambda: tkn._apply_mass_fused_plain(qs, gs, mask, X, 50.0),
        (2 * blk + mtab, 0), lambda: torch.sparse.mm(Mt, X))
    del Mt
    y = tkn._apply_mass_fused(qs, gs, mask, X, 50.0)
    if not torch.equal(y, tkn._apply_mass_fused(qs, gs, mask, X, 50.0)):
        raise AssertionError("K3 plain mode is not bitwise repeatable")
    # the sweep's rows hold more lanes than K12 takes: B^-1 is `degree`
    # K3 steps (degree 4 the cold sweeps')
    for degree in (1, 4):
        args = (qs, gs, mask, dinv, lo, hi, X, degree)
        n0, n12 = ck.mass_apply.launches, ck.binv_chain.launches
        y = tkn._apply_binv_fused(*args)
        n = (ck.mass_apply.launches - n0, ck.binv_chain.launches - n12)
        if n != (degree, 0):
            raise AssertionError(f"B^-1 of degree {degree} launched K3 "
                                 f"{n[0]} and K12 {n[1]} times")
        if not torch.equal(y, tkn._apply_binv_fused(*args)):
            raise AssertionError(f"B^-1 of degree {degree} is not bitwise "
                                 f"repeatable")
        # the function reads W once and writes its result once
        res["mass_apply"][f"binv_degree{degree}"] = _compare(
            f"K3 B^-1 degree {degree} ({degree} launches)",
            lambda: tkn._apply_binv_fused(*args),
            lambda: tkn._apply_binv_fused_plain(*args),
            (2 * blk + mtab, 0))
    # K12 at these lanes, off the path: the yardstick of the routing
    res["binv_chain"] = _k12_checks(X, gs, qs.w, mask, dinv, 4,
                                    ", off the path")
    res["cheb_step"] = _cheb_checks(W, T1, T0, c, h, gen, "")
    return res


def _k8_vector3_work(E, Q, B):
    """(bytes, f32 operations) of the sweep's K8 on E elements, Q points
    and B designs, counted from the function's own inputs: gradients,
    weights, shape table, 1/eps, betas, flags and Linv read once, B
    bounds written. The operations are the least this function needs as
    the kernel computes it (the congruence applied to the basis): per
    (element, design) the weights w / eps (Q), the 171 distinct 1/eps
    primitive entries of the transformed basis (2 Q each), the 324
    entries' combination (~3 each) and absolute row sums (2 each), the
    18 rows over |detJ| and their maximum; per element the basis
    transform (3 Q vectors times the 6 x 6 Linv), the 171 u primitive
    entries and |detJ| (12 Q)."""
    nbytes = (4 * (12 * E * Q + E * Q + 6 * Q + B * E * Q + B + 36) + E
              + 4 * B)
    flops = (E * B * (Q + 342 * Q + 972 + 648 + 36)
             + E * (216 * Q + 342 * Q + 12 * Q))
    return nbytes, flops


def _sweep_betas(geoms):
    """The propagation constants ``solve_sweep`` bounds its designs at
    before a bootstrap refines them: k0 times the LP01 estimate of each
    design's own mean core radius and indices."""
    import numpy as np

    from pl_fem_tpu_torch.solvers.vectorial import lp01_neff_estimate

    return [g.k0 * lp01_neff_estimate(g.k0, float(np.mean(g.core_radii)),
                                      g.n_core, g.n_clad) for g in geoms]


def _sweep_assembly_checks(dg, geoms, betas, dev):
    """The vectorial sweep's assemble and bounds kernels on ``dg`` for the
    designs ``geoms`` at the propagation constants ``betas``: the batched
    K6 against its twin (bit for bit, one launch, repeatable), timed
    beside the per-design K6 launches and divides it replaces and with
    its host time per call; K8 from the quadrature data against its twin
    (1e-5 relative), its f64 twin (BOUND_F64_SLACK) and K8 on each
    design's assembled (E, 18, 18) stack (1e-5 relative), one launch,
    repeatable, timed beside that per-design loop. With B > 1 the
    designs' bounds must differ, and on 1/eps scaled by 1 + b / 16 for
    design b (every design then differs at every point, the maximum's
    too) K8 must agree with its twin and give other bounds than K8 fed
    design 0's scaled 1/eps for all: a kernel that reads one design's
    data for every design fails here. Returns {name: row}."""
    import numpy as np
    import torch

    from pl_fem_tpu_torch.ops import cuda_kernels as ck
    from pl_fem_tpu_torch.ops import kernels as tkn
    from pl_fem_tpu_torch.ops import triton_kernels as tk
    from pl_fem_tpu_torch.ops.assembly import (eps_arrays, eps_batch,
                                               grid_to_device,
                                               quadrature_primitives,
                                               vector3_stacked_A)

    ga = grid_to_device(dg, dev)
    eas = [eps_arrays(g.eps_params(), dev) for g in geoms]
    batch = eps_batch(eas)
    B, n_cores = batch.r2.shape
    E, Q = ga.qp_w.shape
    print(f"sweep assembly checks at E={E} Q={Q} B={B} (at most {n_cores} "
          f"cores):", flush=True)
    res = {}

    # the batched K6: 1/eps of every design, bit for bit the twin's
    n0 = tk.inv_eps_at_quadrature.launches
    inv = tk.inv_eps_at_quadrature(ga.qp_xy, batch)
    if tk.inv_eps_at_quadrature.launches != n0 + 1:
        raise AssertionError("the batched K6 took more than one launch")
    ref = tk.inv_eps_at_quadrature_plain(ga.qp_xy, batch)
    if not torch.equal(inv, ref):
        raise AssertionError(f"the batched K6 differs from its twin at "
                             f"{int((inv != ref).sum())} points")
    if not torch.equal(inv, tk.inv_eps_at_quadrature(ga.qp_xy, batch)):
        raise AssertionError("the batched K6 is not bitwise repeatable")
    print(f"  batched K6 equal to its twin at all {B * E * Q} values",
          flush=True)
    row = _compare(
        f"K6 inv_eps_at_quadrature (batched, B = {B})",
        lambda: tk.inv_eps_at_quadrature(ga.qp_xy, batch),
        lambda: tk.inv_eps_at_quadrature_plain(ga.qp_xy, batch),
        (8 * E * Q + 4 * B * E * Q + 12 * B * n_cores + 8 * B,
         (6 * n_cores + 1) * B * E * Q))
    row["host_ms"] = _host_ms(
        lambda: tk.inv_eps_at_quadrature(ga.qp_xy, batch))
    row["device_ms"] = _device_ms(
        lambda: tk.inv_eps_at_quadrature(ga.qp_xy, batch), 1)
    # what the sweep ran before: a single-design K6 and a divide per design
    row["per_design_ms"] = _event_ms(
        lambda: [1.0 / tk.eps_at_quadrature(ga.qp_xy, ea)[0] for ea in eas])
    row["per_design_host_ms"] = _host_ms(
        lambda: [1.0 / tk.eps_at_quadrature(ga.qp_xy, ea)[0] for ea in eas],
        reps=50)
    print(f"  batched K6 host time per call, no sync: {row['host_ms']:.4f} "
          f"ms; device time (profiler) {row['device_ms']} ms; the {B} "
          f"single-design K6 launches and divides it replaces: "
          f"{row['per_design_ms']:.3f} ms (CUDA events), host "
          f"{row['per_design_host_ms']:.4f} ms", flush=True)
    res["inv_eps_at_quadrature"] = row

    # K8 from the quadrature data of every design
    b32 = torch.tensor(np.asarray(betas, dtype=np.float32), device=dev)
    Linv = torch.as_tensor(tkn._LINV_REF, dtype=torch.float32, device=dev)
    tr = float(np.trace(tkn._B_REF))
    args = (ga.grad_phys, ga.qp_w, ga.shape_vals, inv, b32, 1.0,
            ga.elem_valid, Linv, tr)
    n0 = ck.pencil_bounds_vector3.launches
    bnd = ck.pencil_bounds_vector3(*args)
    if ck.pencil_bounds_vector3.launches != n0 + 1:
        raise AssertionError("K8 (quadrature data) took more than one launch")
    if not torch.equal(bnd, ck.pencil_bounds_vector3(*args)):
        raise AssertionError("K8 (quadrature data) is not bitwise repeatable")
    ref = tkn.pencil_bounds_vector3_plain(*args)
    rel = float(((bnd - ref).abs() / ref).max())
    ref64 = tkn.pencil_bounds_vector3_plain(
        ga.grad_phys.double(), ga.qp_w.double(), ga.shape_vals.double(),
        inv.double(), b32.double(), 1.0, ga.elem_valid, Linv.double(), tr)
    under = float((1.0 - bnd.double() / ref64).max())
    stacked = []
    for i in range(B):
        prim = quadrature_primitives(ga.grad_phys, ga.qp_w, ga.shape_vals,
                                     inv[i])
        A3 = vector3_stacked_A(prim, b32[i], np.float32(1.0))
        stacked.append(ck.pencil_bounds(A3, prim["u_nn"], ga.elem_valid,
                                        Linv, tr, 3))
        del prim, A3
    stacked = torch.stack(stacked)
    rel_st = float(((bnd - stacked).abs() / stacked).max())
    print(f"  K8 (quadrature data): bounds {bnd.tolist()}; max relative "
          f"difference to the twin {rel:.3e}, to K8 on the assembled "
          f"stacks {rel_st:.3e} (limit {KERNEL_RTOL:g}); at most "
          f"{under:.3e} relative under the f64 twin (limit "
          f"{BOUND_F64_SLACK:g})", flush=True)
    if not (rel <= KERNEL_RTOL and rel_st <= KERNEL_RTOL):
        raise AssertionError("K8 (quadrature data) disagrees with its twin "
                             "or with K8 on the assembled stacks")
    if not under <= BOUND_F64_SLACK:
        raise AssertionError(f"K8 (quadrature data) sits {under:.3e} "
                             f"relative under its f64 twin")
    if B > 1 and bool((bnd == bnd[0]).all()):
        raise AssertionError("the designs' bounds are all equal: the "
                             "per-design data do not reach the maximum")
    if B > 1:
        scale = 1.0 + torch.arange(B, device=dev, dtype=torch.float32) / 16
        inv_s = (inv * scale[:, None, None]).contiguous()
        own = ck.pencil_bounds_vector3(*args[:3], inv_s, *args[4:])
        rel_s = float(((own - tkn.pencil_bounds_vector3_plain(
            *args[:3], inv_s, *args[4:])).abs() / own).max())
        one = ck.pencil_bounds_vector3(
            *args[:3], inv_s[:1].expand_as(inv_s).contiguous(), *args[4:])
        print(f"  K8 on 1/eps scaled by 1 + b/16: {own.tolist()}, relative "
              f"difference to the twin {rel_s:.3e}; from design 0's scaled "
              f"1/eps for all: {one.tolist()}", flush=True)
        if not rel_s <= KERNEL_RTOL:
            raise AssertionError("K8 (quadrature data) disagrees with its "
                                 "twin on the scaled 1/eps")
        if bool((own[1:] == one[1:]).any()):
            raise AssertionError("K8 gives a design the bound of design 0's "
                                 "1/eps: it does not read each design's own")
    row = _compare(
        f"K8 pencil_bounds_vector3 (B = {B}, from the quadrature data)",
        lambda: ck.pencil_bounds_vector3(*args),
        lambda: tkn.pencil_bounds_vector3_plain(*args),
        _k8_vector3_work(E, Q, B))
    row.update(max_rel_err=rel, max_rel_err_vs_stacked=rel_st,
               f64_under=under,
               device_ms=_device_ms(lambda: ck.pencil_bounds_vector3(*args),
                                    2),
               host_ms=_host_ms(lambda: ck.pencil_bounds_vector3(*args)))
    print(f"  K8 (quadrature data) device time (profiler, both launches) "
          f"{row['device_ms']} ms, host time per call {row['host_ms']:.4f} "
          f"ms", flush=True)

    def old_loop():
        # the sweep's bounds before: per design the primitives, the
        # (E, 18, 18) stack and K8 on it
        for i in range(B):
            prim = quadrature_primitives(ga.grad_phys, ga.qp_w,
                                         ga.shape_vals, inv[i])
            A3 = vector3_stacked_A(prim, b32[i], np.float32(1.0))
            ck.pencil_bounds(A3, prim["u_nn"], ga.elem_valid, Linv, tr, 3)

    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ck.pencil_bounds_vector3(*args)
    torch.cuda.synchronize()
    row["peak_mib"] = (torch.cuda.max_memory_allocated() - base) / 2**20
    torch.cuda.reset_peak_memory_stats()
    old_loop()
    torch.cuda.synchronize()
    row["per_design_peak_mib"] = ((torch.cuda.max_memory_allocated() - base)
                                  / 2**20)
    row["per_design_ms"] = _event_ms(old_loop, reps=3)
    print(f"  the per-design loop it replaces (primitives, stack, K8 on "
          f"it): {row['per_design_ms']:.3f} ms, "
          f"{row['per_design_peak_mib']:.1f} MiB above the inputs at its "
          f"peak; K8 from the quadrature data "
          f"{row['peak_mib']:.3f} MiB", flush=True)
    res["pencil_bounds_vector3"] = row
    return res


def _seed_checks(dg, geoms, n_modes, cfg, dev):
    """K9 against its twin on the coarse Ritz vectors, seeded-column mask
    and prolongation tables of one real bootstrap of ``geoms`` on ``dg``
    (``_bootstrap_sweep``, its coarse sweep included), with fresh
    standard-normal blocks: within 1e-5 of max|X|, one launch, bitwise
    repeatable, the bootstrap's own seed fused (Dp, B, 3, k); timed
    beside the twin and the byte bound. Returns the row."""
    import numpy as np
    import torch

    from pl_fem_tpu_torch.ops import cuda_kernels as ck
    from pl_fem_tpu_torch.ops import kernels as tkn
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
        boot = tvec.TrueVectorialMaxwellSolver._bootstrap_sweep(
            geoms, dg, n_modes, cfg, gen)
    finally:
        tvec._seed_from_coarse = seed
    if boot is None:
        raise AssertionError("the bootstrap did not seed the sweep")
    Hc, colmask, cols, wts = got["inputs"]
    Hc = torch.tensor(Hc, device=dev)
    colmask = torch.tensor(colmask, device=dev)
    B, _, nc, k = Hc.shape
    Dp, W = cols.shape
    if tuple(boot[0].shape) != (Dp, B, 3, k):
        raise AssertionError(f"the bootstrap's seed has shape "
                             f"{tuple(boot[0].shape)}, not the fused "
                             f"{(Dp, B, 3, k)}")
    R1, R2 = (torch.randn((Dp, B, 3, k), generator=gen, device=dev)
              for _ in range(2))
    scale = float(np.float32(0.05 / np.sqrt(np.float32(3 * Dp))))
    args = (Hc, colmask, cols, wts, R1, R2, scale)
    print(f"K9 seed checks at Dp={Dp} B={B} k={k} (coarse {nc} DOFs, W={W}, "
          f"{int(colmask.sum())} seeded columns):", flush=True)
    n0 = ck.seed_prolong.launches
    X = ck.seed_prolong(*args)
    if ck.seed_prolong.launches != n0 + 1:
        raise AssertionError("K9 took more than one launch for one seed")
    if not torch.equal(X, ck.seed_prolong(*args)):
        raise AssertionError("K9 is not bitwise repeatable")
    norms = torch.linalg.vector_norm(X, dim=(0, 2))
    if not torch.allclose(norms, torch.ones_like(norms), atol=1e-5):
        raise AssertionError("K9's columns are not unit")
    # the bytes this mask needs: R1 on the columns that are not seeded
    # (colmask != 1), Hc on those whose F counts (!= 0), R2 read and X
    # written whole, the mask and the tables; per element W gather FMAs,
    # the six column sums and the blend. Beside it the bound with R1 and
    # Hc whole (the count before the kernel skipped what the mask zeroes)
    n_r1 = int((colmask != 1.0).sum())
    n_f = int((colmask != 0.0).sum())
    nbytes = 4 * (3 * nc * n_f + B * k + 2 * Dp * W + 3 * Dp * n_r1
                  + 2 * Dp * B * 3 * k)
    whole = 4 * (Hc.numel() + B * k + 2 * Dp * W + 3 * Dp * B * 3 * k)
    row = _compare(f"K9 seed_prolong (Dp = {Dp}, B = {B}, k = {k})",
                   lambda: ck.seed_prolong(*args),
                   lambda: tkn.seed_prolong_plain(*args),
                   (nbytes, (2 * W + 17) * Dp * B * 3 * k))
    row.update(Dp=Dp, B=B, k=k, nc=nc, W=W, seeded=B * k - n_r1,
               bound_ms_whole=whole / HBM_BYTES_PER_S * 1e3,
               device_ms=_device_ms(lambda: ck.seed_prolong(*args), 3),
               host_ms=_host_ms(lambda: ck.seed_prolong(*args)))
    print(f"  K9 device time (profiler, its three launches) "
          f"{row['device_ms']} ms, host time per call {row['host_ms']:.4f} "
          f"ms; bound {row['bound_ms']:.4f} ms by bytes at this mask "
          f"({B * k - n_r1} of {B * k} columns seeded), "
          f"{row['bound_ms_whole']:.4f} ms with R1 and Hc whole; share "
          f"{_share(row['bound_ms'], row['ms'])} (events), "
          f"{_share(row['bound_ms'], row['device_ms'])} (device)",
          flush=True)
    return row


def _rr_checks(dg, geoms, k, n_wanted, cfg, dev):
    """K10 against its twin on the Rayleigh-Ritz of the Ritz vectors of
    two filter passes (``solve_lowest_sweep`` at the config's degree, B^-1
    degree 4, from a random block: near-converged wanted columns) on
    ``dg`` for the designs ``geoms`` at k columns, cuts and parks as
    ``solve_sweep`` sets them: residuals within 1e-6 + 1e-3 of the
    twin's, the gate within the same of the twin's gate and equal to the
    maximum of K10's own residuals over the wanted set, one launch,
    bitwise repeatable; timed beside the twin and the bound; the peak
    device memory of one Rayleigh-Ritz pass (``cheb_sweep_rr_impl``)
    with K10 and with the twin's chain in its place. Returns the row."""
    import numpy as np
    import torch

    from pl_fem_tpu_torch.ops import cuda_kernels as ck
    from pl_fem_tpu_torch.ops import kernels as tkn
    from pl_fem_tpu_torch.ops.assembly import (assemble_vector3_sweep,
                                               eps_arrays, gather_scatter,
                                               grid_to_device)

    ga = grid_to_device(dg, dev)
    gs = gather_scatter(ga)
    qs, diag = assemble_vector3_sweep(
        ga, gs, [eps_arrays(g.eps_params(), dev) for g in geoms])
    alpha = cfg.solver.alpha_penalty
    betas = np.asarray(_sweep_betas(geoms))
    cuts = np.array([min(b ** 2 / g.n_clad ** 2, 1.35 * g.k0 ** 2)
                     for b, g in zip(betas, geoms)])
    parks = 10.0 * np.maximum(cuts, 1.0)

    def f32(a):
        return torch.tensor(np.asarray(a, dtype=np.float32), device=dev)

    betas_t, cuts_t, parks_t = f32(betas), f32(cuts), f32(parks)
    bounds = tkn.pencil_bounds_sweep(qs, ga.shape_vals, ga.elem_valid,
                                     betas, alpha).cpu().numpy() * 1.1
    B, D = len(geoms), dg.n_dofs_padded
    mask = ga.interior_mask
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    X = torch.randn((3 * D, B, k), generator=gen, device=dev)
    _, Xr, _ = tkn.solve_lowest_sweep(
        qs, gs, mask, diag, X, cuts, betas, alpha, bounds,
        degree=cfg.solver.cheb_degree, passes=2, max_passes=2, parks=parks,
        binv_degree=4, n_wanted=n_wanted)
    Xff = tkn._fused_from_stacked(Xr)
    del X, Xr
    _, AQ, BQ, theta, Ys = tkn._sweep_ritz(qs, gs, mask, parks_t, betas_t,
                                           float(alpha), Xff)
    args = (AQ, BQ, Ys.contiguous(), theta.contiguous(), cuts_t, n_wanted)
    n0 = ck.ritz_residual.launches
    res, gate = ck.ritz_residual(*args)
    if ck.ritz_residual.launches != n0 + 1:
        raise AssertionError("K10 took more than one launch for one pass")
    again = ck.ritz_residual(*args)
    if not (torch.equal(res, again[0]) and torch.equal(gate, again[1])):
        raise AssertionError("K10 is not bitwise repeatable")
    ref, rgate = tkn.ritz_residual_plain(*args)
    torch.cuda.synchronize()
    err = float((res - ref).abs().max())
    if not bool(((res - ref).abs() <= 1e-6 + 1e-3 * ref).all()):
        raise AssertionError(f"K10: residuals {err:.3e} from the twin's, "
                             f"over 1e-6 + 1e-3 res_twin")
    gate_err = abs(float(gate) - float(rgate))
    own = float(tkn._sweep_gate_maxres(args[3], res, cuts_t, n_wanted))
    if not (gate_err <= 1e-6 + 1e-3 * float(rgate) and float(gate) == own):
        raise AssertionError(f"K10: gate {float(gate)!r}, twin's "
                             f"{float(rgate)!r}, of K10's residuals "
                             f"{own!r}")
    wanted = args[3] < cuts_t[:, None]
    if n_wanted > 0:
        wanted &= torch.arange(k, device=dev)[None] < n_wanted
    wres = ref[wanted]
    wres = [float(wres.min()), float(wres.max())] if wres.numel() else None
    print(f"K10 checks at 3D={3 * D} B={B} k={k}: {int(wanted.sum())} "
          f"wanted columns, their residuals {wres} (all "
          f"{float(ref.min()):.3e} .. {float(ref.max()):.3e}); max|res - "
          f"twin| = {err:.3e}; gate {float(gate):.6e}, twin's "
          f"{float(rgate):.6e}", flush=True)
    # AQ and BQ read once (Ys, theta, cuts and the outputs are KBs); per
    # row and design the 3xTF32 products of u and v, 3 x 4 k^2 operations
    # at the tensor cores' TF32 rate, and 6 k f32 ones for R and the
    # squares
    rows = B * 3 * D
    ops_s = (12 * k * k * rows / TF32_FLOPS_PER_S
             + 6 * k * rows / F32_FLOPS_PER_S)
    row = _compare(f"K10 ritz_residual (3D = {3 * D}, B = {B}, k = {k})",
                   lambda: ck.ritz_residual(*args)[0],
                   lambda: tkn.ritz_residual_plain(*args)[0],
                   (8 * D * B * 3 * k + 4 * (B * k * k + 2 * B * k + B),
                    rows * (12 * k * k + 6 * k), ops_s))
    row.update(gate_abs_err=gate_err, wanted=int(wanted.sum()),
               wanted_res=wres,
               device_ms=_device_ms(lambda: ck.ritz_residual(*args), 2),
               host_ms=_host_ms(lambda: ck.ritz_residual(*args)))
    print(f"  K10 device time (profiler, both launches) {row['device_ms']} "
          f"ms, host time per call {row['host_ms']:.4f} ms; bound "
          f"{row['bound_ms']:.4f} ms by {row['bound_by']} (operations "
          f"{ops_s * 1e3:.4f} ms); share "
          f"{_share(row['bound_ms'], row['ms'])} (events), "
          f"{_share(row['bound_ms'], row['device_ms'])} (device)",
          flush=True)
    del res, ref, again, AQ, BQ

    def peak_mib():
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = tkn.cheb_sweep_rr_impl(qs, gs, mask, parks_t, betas_t,
                                     float(alpha), Xff, cuts_t, n_wanted)
        torch.cuda.synchronize()
        del out
        return (torch.cuda.max_memory_allocated() - base) / 2 ** 20

    row["rr_pass_peak_mib"] = peak_mib()
    kernel = tkn.ritz_residual
    tkn.ritz_residual = tkn.ritz_residual_plain
    try:
        row["rr_pass_peak_mib_twin"] = peak_mib()
    finally:
        tkn.ritz_residual = kernel
    print(f"  one Rayleigh-Ritz pass at 3D={3 * D} B={B} k={k}: peak device "
          f"memory {row['rr_pass_peak_mib']:.1f} MiB above its inputs with "
          f"K10, {row['rr_pass_peak_mib_twin']:.1f} MiB with the twin's "
          f"chain (AQ Ys, BQ Ys, R)", flush=True)
    row.update(D=D, B=B, k=k)
    return row


def _cheb_checks(W, T1, T0, c, h, gen, tag):
    """K4 against its twin on (D, B, C, k) blocks: the renorm step (T2
    and its scale s), the plain step, the step after a renorm (both
    pending scales), and a short recurrence with two deferred renorms;
    returns the renorm step's row with the others in it."""
    import torch

    from pl_fem_tpu_torch.ops import kernels as tkn
    from pl_fem_tpu_torch.ops import triton_kernels as tk

    D, B, C, k = W.shape
    blk = 4 * W.numel()
    # a step reads W, T1, T0 and writes T2; c, h, and the (B, k) scales
    row = _compare(
        f"K4 cheb_step (renorm step{tag}: T2 unscaled and its scale)",
        lambda: tk.cheb_step(W, T1, T0, c, h, renorm=True)[0],
        lambda: tk.cheb_step_plain(W, T1, T0, c, h, renorm=True)[0],
        (4 * blk + 8 * B + 4 * B * k, 0))
    s = tk.cheb_step(W, T1, T0, c, h, renorm=True)[1]
    ref = tk.cheb_step_plain(W, T1, T0, c, h, renorm=True)[1]
    err = float((s - ref).abs().max())
    if not err <= KERNEL_RTOL * float(ref.abs().max()):
        raise AssertionError(f"K4: max|s - twin| = {err:.3e}")
    row["s_max_abs_err"] = err
    # the plain step (no renorm, no pending scale): 6 of every 8 steps
    row["plain_step"] = _compare(
        f"K4 cheb_step (plain step{tag})",
        lambda: tk.cheb_step(W, T1, T0, c, h)[0],
        lambda: tk.cheb_step_plain(W, T1, T0, c, h)[0],
        (4 * blk + 8 * B, 0))
    sv = torch.rand((B, k), generator=gen, device=W.device) + 0.5
    row["scaled_step"] = _compare(
        f"K4 cheb_step (the step after a renorm{tag})",
        lambda: tk.cheb_step(W, T1, T0, c, h, scale=sv, scale_t0=sv)[0],
        lambda: tk.cheb_step_plain(W, T1, T0, c, h, scale=sv,
                                   scale_t0=sv)[0],
        (4 * blk + 8 * B + 4 * B * k, 0))
    # T1 = T(T0), then 17 steps with renorms at the 8th and 16th, for the
    # fixed linear W(V) = A * V: through the kernel, then the twin
    A = W + 3.0

    def recurrence():
        T, _ = tkn.cheb_step(A * T0, T0, None, c, h)
        return tkn._sweep_iterate(lambda V: A * V, c, h, T0, T, 17, 8)

    y = recurrence()
    kernel_step = tkn.cheb_step
    tkn.cheb_step = tk.cheb_step_plain
    try:
        ref = recurrence()
    finally:
        tkn.cheb_step = kernel_step
    err = float((y - ref).abs().max())
    scale = float(ref.abs().max())
    print(f"  K4 18-step recurrence, deferred renorms{tag}: max_abs_err="
          f"{err:.3e} (max|y|={scale:.3e}, limit {KERNEL_RTOL:g} of max|y|)",
          flush=True)
    if not err <= KERNEL_RTOL * scale:
        raise AssertionError("K4's recurrence disagrees with the twin's")
    row["recurrence_max_abs_err"] = err
    return row


def _k11_work(E, Q, n_cores):
    """(bytes, f32 operations) of K11 on E elements, Q points and n_cores
    cores, from the function's own inputs and outputs: gradients,
    weights, points and flags read once per element, the shape table,
    Linv, the cores and the two permittivities once; A, B, the diagonal
    terms and the bound written once. Operations: 6 per (point, core)
    for the core test; per entry 12 per point (K, Me, M) and 3 for A; per
    element |detJ| (8), A / |detJ| (36), T and W (36 x 12 each), |W| and
    the row sums (72)."""
    nbytes = (E * (4 * 15 * Q + 1) + 4 * (6 * Q + 36 + 3 * n_cores + 2)
              + E * 4 * 78 + 4)
    flops = E * (6 * n_cores * Q + 36 * (12 * Q + 3) + 8 + 36 + 864 + 72)
    return nbytes, flops


def _k11_checks(ga, ea, k2, Linv, tr, A7, B7):
    """K11 (``scalar_pencil``) against its twin on the grid ``ga`` for the
    design ``ea``: eps_re equal at every point, A and B within
    KERNEL_RTOL of their own scales, the diagonal terms B's own, the
    bound within KERNEL_RTOL relative and no further under its f64 twin
    than BOUND_F64_SLACK; one launch a call and bitwise repeatable. Timed
    (CUDA events, the profiler's device time, host time per call) beside
    its twin, its bound and its yardstick: K6, K7, B's diagonal and K8 at
    C = 1 back to back, as the scalar path ran them before K11. Prints
    whether A equals K7's ``A7`` and the bound K8's on K11's own blocks
    bit for bit. Returns the row."""
    import torch

    from pl_fem_tpu_torch.ops import cuda_kernels as ck
    from pl_fem_tpu_torch.ops import triton_kernels as tk

    E, Q = ga.qp_w.shape
    n_cores = ea.positions.shape[0]
    args = (ga.grad_phys, ga.qp_w, ga.qp_xy, ga.shape_vals, ea, k2,
            ga.elem_valid, Linv, tr)
    n0 = ck.scalar_pencil.launches
    A, B, diag, bound, eps = ck.scalar_pencil(*args, return_eps=True)
    if ck.scalar_pencil.launches != n0 + 1:
        raise AssertionError("K11 took more than one launch")
    rA, rB, rdiag, rbound, reps = ck.scalar_pencil_plain(*args,
                                                         return_eps=True)
    if not torch.equal(eps, reps):
        raise AssertionError(f"K11: eps_re differs from the twin at "
                             f"{int((eps != reps).sum())} points")
    errs = {}
    for nm, y, ref in (("A", A, rA), ("B", B, rB)):
        err = float((y - ref).abs().max())
        scale = float(ref.abs().max())
        print(f"  K11 {nm} blocks: max_abs_err={err:.3e} (max|{nm}|="
              f"{scale:.3e}, limit {KERNEL_RTOL:g} of it)", flush=True)
        if not err <= KERNEL_RTOL * scale:
            raise AssertionError(f"K11: max|{nm} - twin| = {err:.3e} > "
                                 f"{KERNEL_RTOL:g} * {scale:.3e}")
        errs[f"{nm.lower()}_max_abs_err"] = err
    if not torch.equal(diag, torch.diagonal(B, dim1=1, dim2=2)):
        raise AssertionError("K11: the diagonal terms are not B's")
    rel = abs(float(bound) - float(rbound)) / float(rbound)
    b64 = float(ck.pencil_bounds_plain(rA.double(), rB.double(),
                                       ga.elem_valid, Linv.double(), tr, 1))
    print(f"  K11 eps_re equal to the twin's at all {E * Q} points; bound "
          f"{float(bound):.6e}, relative difference to the twin {rel:.3e} "
          f"(limit {KERNEL_RTOL:g}), f64 {b64:.6e} (may sit "
          f"{BOUND_F64_SLACK:g} relative under it)", flush=True)
    if not rel <= KERNEL_RTOL:
        raise AssertionError(f"K11: the bound is {rel:.3e} relative off "
                             f"its twin's")
    if not float(bound) >= b64 * (1.0 - BOUND_F64_SLACK):
        raise AssertionError(f"K11: the bound {float(bound)!r} is below its "
                             f"f64 value {b64!r} by more than "
                             f"{BOUND_F64_SLACK:g} relative")
    again = ck.scalar_pencil(*args)
    if not all(torch.equal(x, y) for x, y in zip((A, B, diag, bound),
                                                  again)):
        raise AssertionError("K11 is not bitwise repeatable")
    same_k8 = torch.equal(bound, ck.pencil_bounds(A, B, ga.elem_valid, Linv,
                                                  tr, 1))
    print(f"  K11 A bit for bit K7's: {torch.equal(A, A7)}, B: "
          f"{torch.equal(B, B7)}; bound bit for bit K8's on K11's blocks: "
          f"{same_k8}", flush=True)
    del rA, rB, rdiag, reps
    row = _compare(
        "K11 scalar_pencil (permittivity, A and B, diagonal, bound)",
        lambda: ck.scalar_pencil(*args)[0],
        lambda: ck.scalar_pencil_plain(*args)[0],
        _k11_work(E, Q, n_cores))

    def chain():
        # the scalar path's set-up before K11: K6 (r^2, then the Triton
        # kernel), K7, B's diagonal, K8's two launches
        re, _ = tk.eps_at_quadrature(ga.qp_xy, ea)
        A_, B_ = ck.scalar_blocks(ga.grad_phys, ga.qp_w, ga.shape_vals, re,
                                  k2)
        torch.diagonal(B_, dim1=1, dim2=2).contiguous()
        return ck.pencil_bounds(A_, B_, ga.elem_valid, Linv, tr, 1)

    row.update(errs, max_rel_err_bound=rel, f64_bound=b64,
               a_equals_k7=torch.equal(A, A7), bound_equals_k8=same_k8,
               device_ms=_device_ms(lambda: ck.scalar_pencil(*args), 1,
                                    name="scalar_pencil"),
               host_ms=_host_ms(lambda: ck.scalar_pencil(*args)),
               yardstick_ms=_event_ms(chain),
               yardstick_device_ms=_device_ms(chain, 6),
               yardstick_host_ms=_host_ms(chain, reps=50))
    print(f"  K11 device time (profiler) {row['device_ms']} ms, host time "
          f"per call {row['host_ms']:.4f} ms; K6 + K7 + diagonal + K8 back "
          f"to back: {row['yardstick_ms']:.3f} ms (CUDA events), device "
          f"{row['yardstick_device_ms']} ms, host "
          f"{row['yardstick_host_ms']:.4f} ms", flush=True)
    return row


def _scalar_kernel_checks(dg, geom, k, dev):
    """K5-K8 and K11 against their twins on ``dg`` with k columns, K12
    against the eight K3 steps it replaces, and the reused K2, K3, K4 at
    the scalar solver's shapes; returns {name: row}."""
    import numpy as np
    import torch

    from pl_fem_tpu_torch.ops import assembly as ta
    from pl_fem_tpu_torch.ops import cuda_kernels as ck
    from pl_fem_tpu_torch.ops import kernels as tkn
    from pl_fem_tpu_torch.ops import triton_kernels as tk

    ga = ta.grid_to_device(dg, dev)
    gs = ta.gather_scatter(ga)
    ea = ta.eps_arrays(geom.eps_params(), dev)
    D = dg.n_dofs_padded
    E = dg.elem_dofs.shape[0]
    Q = ga.qp_w.shape[1]
    n_cores = ea.positions.shape[0]
    split, Wv = gs.idx_v.shape
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    print(f"scalar kernel checks at D={D} E={E} k={k}:", flush=True)
    res = {}

    # K6: eps_re must be decided exactly as the twin decides it
    re, im = tk.eps_at_quadrature(ga.qp_xy, ea)
    rre, rim = tk.eps_at_quadrature_plain(ga.qp_xy, ea)
    if not torch.equal(re, rre):
        raise AssertionError(f"K6: eps_re differs from the twin at "
                             f"{int((re != rre).sum())} points")
    im_err = float((im - rim).abs().max())
    im_lim = EPS_IM_TOL * max(1.0, float(rim.abs().max()))
    if not im_err <= im_lim:
        raise AssertionError(f"K6: max|eps_im - twin| = {im_err:.3e} > "
                             f"{im_lim:.3e}")
    print(f"  K6 eps_re equal at all {E * Q} points; max|eps_im - twin| = "
          f"{im_err:.3e} (limit {im_lim:.3e})", flush=True)
    res["eps_at_quadrature"] = _compare(
        "K6 eps_at_quadrature",
        lambda: torch.stack(tk.eps_at_quadrature(ga.qp_xy, ea)),
        lambda: torch.stack(tk.eps_at_quadrature_plain(ga.qp_xy, ea)),
        (16 * E * Q + 12 * n_cores + 24, (5 * n_cores + 15) * E * Q))

    # K7, with one einsum over pre-stacked (dx N, dy N, N) channels as
    # the library yardstick of the A blocks
    k2 = float(np.float32(geom.k0) ** 2)
    blk_args = (ga.grad_phys, ga.qp_w, ga.shape_vals, re, k2)
    F = torch.stack([ga.grad_phys[..., 0], ga.grad_phys[..., 1],
                     ga.shape_vals[None].expand(E, Q, 6)], dim=2)
    Wc = torch.stack([ga.qp_w, ga.qp_w, -k2 * ga.qp_w * re], dim=2)
    A_ref = ck.scalar_blocks_plain(*blk_args)[0]
    ein_err = float((torch.einsum("eqc,eqci,eqcj->eij", Wc, F, F) - A_ref)
                    .abs().max())
    print(f"  einsum yardstick of K7: max|einsum - twin's A| = "
          f"{ein_err:.3e} (max|A| = {float(A_ref.abs().max()):.3e})",
          flush=True)
    del A_ref
    res["scalar_blocks"] = _compare(
        "K7 scalar_blocks",
        lambda: torch.stack(ck.scalar_blocks(*blk_args)),
        lambda: torch.stack(ck.scalar_blocks_plain(*blk_args)),
        (4 * E * (14 * Q + 72) + 4 * Q * 6, 36 * E * Q * 11),
        lambda: torch.einsum("eqc,eqci,eqcj->eij", Wc, F, F))
    A, Bm = ck.scalar_blocks(*blk_args)
    if not torch.equal(A, ck.scalar_blocks(*blk_args)[0]):
        raise AssertionError("K7 is not bitwise repeatable")
    # the stacked comparison above is scaled by max|A| = O(1); the mass
    # entries are ~1e-4..5e-2 um^2, so B is held to its own scale here
    B_ref = ck.scalar_blocks_plain(*blk_args)[1]
    b_err = float((Bm - B_ref).abs().max())
    b_scale = float(B_ref.abs().max())
    print(f"  K7 B blocks alone: max_abs_err={b_err:.3e} (max|B|="
          f"{b_scale:.3e}, limit {KERNEL_RTOL:g} of max|B|)", flush=True)
    if not b_err <= KERNEL_RTOL * b_scale:
        raise AssertionError(f"K7: max|B - twin| = {b_err:.3e} > "
                             f"{KERNEL_RTOL:g} * max|B| = {b_scale:.3e}")
    res["scalar_blocks"]["b_max_abs_err"] = b_err
    del B_ref

    # the (E, 18, 18) vectorial blocks for the C = 3 checks
    prim, _, _ = ta.assemble_vector3_system(ga, ea)
    beta = np.float32(geom.k0 * 1.49)
    A3 = ta.vector3_stacked_A(prim, beta, np.float32(1.0))
    M3 = prim["u_nn"]
    del prim

    # K8 at C = 1 and C = 3, against the twin and against f64
    Linv = torch.as_tensor(tkn._LINV_REF, dtype=torch.float32, device=dev)
    tr = float(np.trace(tkn._B_REF))
    for C, Ab, Bb in ((1, A, Bm), (3, A3, M3)):
        R = 6 * C
        row = _compare(
            f"K8 pencil_bounds (C = {C})",
            lambda: ck.pencil_bounds(Ab, Bb, ga.elem_valid, Linv, tr, C),
            lambda: ck.pencil_bounds_plain(Ab, Bb, ga.elem_valid, Linv, tr,
                                           C),
            (4 * R * R * E + 4 * 6 * E + E + 4, 24 * R * R * E))
        b32 = float(ck.pencil_bounds(Ab, Bb, ga.elem_valid, Linv, tr, C))
        b64 = float(ck.pencil_bounds_plain(Ab.double(), Bb.double(),
                                           ga.elem_valid, Linv.double(), tr,
                                           C))
        if not b32 >= b64 * (1.0 - BOUND_F64_SLACK):
            raise AssertionError(f"K8 (C = {C}): {b32!r} is below its f64 "
                                 f"value {b64!r} by more than "
                                 f"{BOUND_F64_SLACK:g} relative")
        print(f"  K8 (C = {C}) bound {b32:.6e} vs f64 {b64:.6e} (may sit "
              f"{BOUND_F64_SLACK:g} relative under it)", flush=True)
        if C == 1:
            res["pencil_bounds"] = row
        else:
            res["pencil_bounds"]["c3"] = row
    res["scalar_pencil"] = _k11_checks(ga, ea, k2, Linv, tr, A, Bm)

    # K5, the whole stacked apply, at C = 1 (the scalar pencil) and C = 3
    # (the vectorial blocks), with one cuSPARSE SpMM of the assembled
    # m A m + park (I - m) as its yardstick
    mask1, mask3 = ga.dof_valid, ga.interior_mask
    plan = gs.apply_plan
    NB, HE = plan.elems.shape
    # the plan's tables (order, entry offsets, halo elements and their
    # counts, entry slots, the slots' DOFs), padded to HE slots per block:
    # what this design reads, printed beside the bound; the bound itself
    # counts the function's own connectivity, the (E, 6) element table
    plan_bytes = (4 * D + 4 * (NB * plan.rows + 1) + 4 * NB * HE + 4 * NB
                  + (2 + 4) * 6 * NB * HE)
    print(f"  K5 plan: {plan.rows} rows per block, {plan.recompute:.3f} "
          f"element evaluations per element, at most {plan.max_entries} "
          f"entries and {HE} elements per block; tables {plan_bytes} bytes",
          flush=True)
    for C, Ab, mask in ((1, A, mask1), (3, A3, mask3)):
        R = 6 * C
        X = torch.randn((C * D, k), generator=gen, device=dev)
        park = torch.full((k,), 50.0, device=dev)
        args = (X, gs, Ab, mask, park, C)
        n0 = ck.apply_stacked.launches
        y = ck.apply_stacked(*args)
        if ck.apply_stacked.launches != n0 + 1:
            raise AssertionError("K5 took more than one launch for one apply")
        if not torch.equal(y, ck.apply_stacked(*args)):
            raise AssertionError(f"K5 (C = {C}) is not bitwise repeatable")
        S = _stacked_csr(gs.elem_dofs, Ab, mask, 50.0, C)
        spmm_err = float((torch.sparse.mm(S, X) - ck.apply_stacked_plain(
            *args)).abs().max())
        print(f"  SpMM yardstick of K5 (C = {C}): {S._nnz()} nonzeros, "
              f"max|SpMM - twin| = {spmm_err:.3e}", flush=True)
        row = _compare(
            f"K5 apply_stacked (C = {C}: mask, element product, "
            f"accumulate, park)",
            lambda: ck.apply_stacked(*args),
            lambda: ck.apply_stacked_plain(*args),
            (4 * (R * R * E + 2 * C * D * k + D + k + 6 * E),
             2 * R * R * E * k),
            lambda: torch.sparse.mm(S, X))
        del S
        row["plan_bytes"] = plan_bytes
        row["host_ms"] = _host_ms(lambda: ck.apply_stacked(*args))
        print(f"  K5 (C = {C}) host time per call, no sync: "
              f"{row['host_ms']:.4f} ms", flush=True)
        if C == 1:
            res["apply_stacked"] = row
        else:
            res["apply_stacked"]["c3"] = row
            # the assembled-block apply against the matrix-free one
            qf, _ = ta.assemble_vector3_qf(ga, ea)
            qs = tkn.QFactorSweep(invJT=qf.invJT, w=qf.w,
                                  inv_eps=qf.inv_eps[None], gp=ga.grad_phys)
            y = tkn._apply_stacked(Ab, gs, mask, 50.0, X, 3)
            ref = tkn._stacked_from_fused(tkn._apply_vector3_fused(
                qs, gs, mask, torch.tensor([50.0], device=dev),
                torch.tensor([beta], device=dev), 1.0,
                tkn._fused_from_stacked(X[:, None, :])))[:, 0]
            err = float((y - ref).abs().max())
            scale = float(ref.abs().max())
            print(f"  K5 (C = 3) vs K1: max_abs_err={err:.3e} "
                  f"(max|y|={scale:.3e}, limit {KERNEL_RTOL:g} of max|y|)",
                  flush=True)
            if not err <= KERNEL_RTOL * scale:
                raise AssertionError("the stacked apply at C = 3 disagrees "
                                     "with the matrix-free A(beta) apply")
    del A3, M3

    # the reused kernels at the scalar solver's shapes (L = k, C = 1)
    X = torch.randn((D, k), generator=gen, device=dev)
    blk = 4 * D * k
    tab = 5 * (split * Wv + 2 * (D - split))
    mtab = tab + 4 * E * 6 + 4 * E * Q + 4 * Q * 6 + 4 * D + 4 * D
    # K2 has left the scalar filter (K5 sums its own rows); at L = k it is
    # checked on the twin's element results, as a kernel of the repo
    Ye = ck.apply_stacked_elem_plain(X, mask1, gs.elem_dofs, A, 1)[0]
    park = torch.full((k,), 1.0, device=dev)
    tables = (gs.idx_v, gs.valid_v, gs.idx_e, gs.valid_e)
    res["accumulate"] = _compare(
        "K2 accumulate (epilogue, L = k)",
        lambda: ck.accumulate(Ye, *tables, X, mask1, park),
        lambda: ck.accumulate_plain(Ye, *tables, X, mask1, park),
        (4 * E * 6 * k + tab + 2 * blk + 4 * D + 4 * k, 0))
    # K2 without its epilogue is one SpMM with the 0/1 scatter matrix
    S = _scatter_csr(gs, E)
    Yflat = Ye.view(6 * E, k)
    res["accumulate"]["no_epilogue"] = _compare(
        "K2 accumulate (no epilogue, L = k)",
        lambda: ck.accumulate(Ye, *tables),
        lambda: ck.accumulate_plain(Ye, *tables),
        (4 * E * 6 * k + tab + blk, 0),
        lambda: torch.sparse.mm(S, Yflat))
    del S, Yflat
    # K3 in plain mode is one SpMM with the assembled masked mass matrix
    N = tkn.shape_table(dev)
    Mt = _mass_csr(gs, ga.qp_w, N, mask1, 1.0)
    spmm_err = float((torch.sparse.mm(Mt, X) - ck.mass_apply_plain(
        X, gs, ga.qp_w, N, mask1)).abs().max())
    print(f"  SpMM yardstick of K3: {Mt._nnz()} nonzeros, max|SpMM - twin| "
          f"= {spmm_err:.3e}", flush=True)
    res["mass_apply"] = _compare(
        "K3 mass_apply (plain mode, L = k, valid-DOF mask)",
        lambda: ck.mass_apply(X, gs, ga.qp_w, N, mask1),
        lambda: ck.mass_apply_plain(X, gs, ga.qp_w, N, mask1),
        (2 * blk + mtab, 0), lambda: torch.sparse.mm(Mt, X))
    del Mt
    # K12: the scalar filter's B^-1 (degree 8) against its eight K3 steps,
    # at k, at the widest rows routed to it (BINV_LANES lanes) and at one
    # lane more, the first width left to the K3 steps
    _, _, diag1, _ = ta.assemble_scalar_system(ga, ea, geom.k0)
    ds1 = 1.0 / torch.sqrt(diag1.clamp_min(1e-30))
    res["binv_chain"] = _k12_checks(X, gs, ga.qp_w, mask1, ds1, 8,
                                    ", scalar")
    for L, key in ((ck.BINV_LANES, "widest"), (ck.BINV_LANES + 1, "past")):
        XL = torch.randn((D, L), generator=gen, device=dev)
        res[f"binv_chain_{key}"] = _k12_checks(XL, gs, ga.qp_w, mask1, ds1,
                                               8, f", {L} lanes")
        del XL
    W, T1, T0 = (torch.randn((D, 1, 1, k), generator=gen, device=dev)
                 for _ in range(3))
    c = torch.tensor([120.0], device=dev)
    h = torch.tensor([1100.0], device=dev)
    res["cheb_step"] = _cheb_checks(W, T1, T0, c, h, gen, ", C = 1")
    return res


def _scalar_assemble_split(dg, geom, dev, runs: int = 3):
    """How the scalar solve's ``assemble`` phase (``build_scalar_pencil``)
    splits, host seconds to a synchronise, ``runs`` times on a fresh
    device grid each: the grid and permittivity upload
    (``grid_to_device``, ``eps_arrays``), the K1 / K3 plans
    (``gather_scatter``, built once per device grid), and the kernels
    (``assemble_scalar_system``: K11 and K2 at L = 1, the plans cached)."""
    import torch

    from pl_fem_tpu_torch.ops import assembly as ta

    out = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ga = ta.grid_to_device(dg, dev)
        ea = ta.eps_arrays(geom.eps_params(), dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        ta.gather_scatter(ga)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        ta.assemble_scalar_system(ga, ea, geom.k0)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        out.append({"upload_s": t1 - t0, "plans_s": t2 - t1,
                    "kernels_s": t3 - t2})
        del ga, ea
    return out


def _neff_rel(ref, out):
    """The largest relative n_eff difference of two sweeps' results;
    raises unless every design has the same number of modes (and some)."""
    worst = 0.0
    for mr, mo in zip(ref, out, strict=True):
        if not mr or len(mr) != len(mo):
            raise AssertionError(f"split sweep: {len(mo)} modes against "
                                 f"{len(mr)} unsplit")
        worst = max(worst, max(abs(a["n_eff"] - b["n_eff"]) / b["n_eff"]
                               for a, b in zip(mo, mr)))
    return worst


def _check_split_launches(what, launches, seen, mesh, width):
    """The split sweep's own counts: every vectorial Rayleigh-Ritz ran on
    ``width`` designs on its slice's device with that device current,
    the slices in mesh order, one per slice and pass; per slice K1 once
    per A apply (K1 = K4 steps + passes over the slices) and K10 once per
    pass; the sweep-wide kernels once per sweep (the batched K6, K8) or
    per bootstrap (K9), on the sweep's device."""
    sl = seen["rr_slices"]
    n = mesh.size
    per = {name: launches[name] / n for name in
           ("apply_vector3", "mass_apply", "cheb_step", "ritz_residual")}
    print(f"{what}: {n} slices; Rayleigh-Ritz calls {len(sl)} at widths "
          f"{sorted({w for w, _, _ in sl})}; launches per slice "
          f"{json.dumps(per)}; K6 / K8 / K9 {launches['inv_eps_at_quadrature']}"
          f" / {launches['pencil_bounds_vector3']} / "
          f"{launches['seed_prolong']} for {seen['sweeps']} sweeps",
          flush=True)
    if not sl or len(sl) % n:
        raise AssertionError(f"{what}: Rayleigh-Ritz calls not one per "
                             f"slice and pass")
    for i, (w, index, current) in enumerate(sl):
        if w != width or index != mesh.devices[i % n].index \
                or current != index:
            raise AssertionError(f"{what}: Rayleigh-Ritz {i} on {w} designs "
                                 f"of cuda:{index} (current cuda:{current})")
    _check_apply_launches(what, launches, seen)
    _check_sweep_launches(what, launches, seen)
    _check_seed_rr_launches(what, launches, seen)


def _split_phase(Solver, geoms, dg, cfg, sweep, unsplit_s, unsplit_counts,
                 reset_counts, read_counts, card):
    """The config-1 sweep split over two slices of the card: a warm-up,
    then the timed run held to the unsplit sweep ``sweep`` (n_eff within
    SPLIT_RTOL) with its own launch counts; B = 5 over the same two
    slices (padded to 6) against the unsplit B = 5 sweep from the same
    random numbers; and, where more than one card is visible, the sweep
    over all of them. Returns the timed split run's launch counts."""
    import numpy as np
    import torch

    from pl_fem_tpu_torch import workloads as wl
    from pl_fem_tpu_torch.parallel import design_mesh

    home = torch.cuda.current_device()
    mesh = design_mesh([f"cuda:{home}"] * 2)
    B = len(geoms)
    Solver.solve_sweep(geoms, dg, wl.N_MODES, cfg, mesh=mesh)
    torch.cuda.synchronize()
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with _watch_sweep() as seen:
        out = Solver.solve_sweep(geoms, dg, wl.N_MODES, cfg, mesh=mesh)
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = read_counts()
    phases = {p: round(v, 3) for p, v in Solver.last_sweep_times.items()}
    rel = _neff_rel(sweep, out)
    print(f"split sweep, B = {B} over 2 slices of cuda:{home}: {dt:.2f} s = "
          f"{dt / B:.3f} s/design against {unsplit_s / B:.3f} s/design "
          f"unsplit (card {card}); peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; phases (s) "
          f"{json.dumps(phases)}; n_eff against the unsplit sweep: max rel "
          f"{rel:.2e} (limit {SPLIT_RTOL:g})", flush=True)
    if torch.cuda.current_device() != home:
        raise AssertionError("the split sweep left another current device")
    if not rel <= SPLIT_RTOL:
        raise AssertionError(f"split sweep n_eff rel {rel:.2e} > "
                             f"{SPLIT_RTOL:g}")
    _check_split_launches("the split sweep", counts, seen, mesh, B // 2)
    print("the split sweep against the unsplit one, launches: "
          + json.dumps({name: [counts[name], unsplit_counts[name]]
                        for name in ("apply_vector3", "mass_apply",
                                     "cheb_step", "ritz_residual",
                                     "seed_prolong")}), flush=True)

    # B = 5 does not divide over 2 slices: padded with the last design.
    # Both sweeps take the same bootstrap noise and coarse start block, so
    # the split computes what the unsplit sweep computes
    g5 = geoms[:5]
    k = wl.N_MODES + cfg.solver.extra_vectors
    rng = np.random.default_rng(5)
    noise = tuple(rng.standard_normal((3 * dg.n_dofs_padded, 5, k),
                                      dtype=np.float32) for _ in range(2))

    def coarse_X0(shape):
        return np.random.default_rng(6).standard_normal(shape,
                                                        dtype=np.float32)

    ref5 = Solver.solve_sweep(g5, dg, wl.N_MODES, cfg, noise=noise,
                              coarse_X0=coarse_X0)
    reset_counts()
    with _watch_sweep() as seen5:
        out5 = Solver.solve_sweep(g5, dg, wl.N_MODES, cfg, noise=noise,
                                  coarse_X0=coarse_X0, mesh=mesh)
        torch.cuda.synchronize()
    rel5 = _neff_rel(ref5, out5)
    print(f"split sweep, B = 5 over 2 slices (padded to 6): {len(out5)} "
          f"results; n_eff against the unsplit B = 5 sweep: max rel "
          f"{rel5:.2e} (limit {SPLIT_RTOL:g})", flush=True)
    if len(out5) != 5 or not rel5 <= SPLIT_RTOL:
        raise AssertionError(f"padded split sweep: {len(out5)} results, "
                             f"n_eff rel {rel5:.2e}")
    # the outer call of a padded sweep only pads and calls solve_sweep
    # again: it assembles nothing
    _check_split_launches("the padded split sweep", read_counts(),
                          dict(seen5, sweeps=seen5["sweeps"] - 1), mesh, 3)

    if torch.cuda.device_count() > 1:
        everywhere = design_mesh()
        Solver.solve_sweep(geoms, dg, wl.N_MODES, cfg, mesh=everywhere)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out_all = Solver.solve_sweep(geoms, dg, wl.N_MODES, cfg,
                                     mesh=everywhere)
        torch.cuda.synchronize()
        dt_all = time.perf_counter() - t0
        rel_all = _neff_rel(sweep, out_all)
        print(f"split sweep over {everywhere.size} cards: {dt_all:.2f} s = "
              f"{dt_all / B:.3f} s/design; n_eff max rel {rel_all:.2e}",
              flush=True)
        if not rel_all <= SPLIT_RTOL:
            raise AssertionError(f"sweep over all cards: n_eff rel "
                                 f"{rel_all:.2e} > {SPLIT_RTOL:g}")
    return counts


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; "
                           "torch.cuda.is_available() is False")
    sys.path.insert(0, str(REPO))
    from pl_fem_tpu_torch import cli
    from pl_fem_tpu_torch import workloads as wl
    from pl_fem_tpu_torch.config import solver_preset
    from pl_fem_tpu_torch.models import MCFGeometry
    from pl_fem_tpu_torch.ops import cuda_kernels as ck
    from pl_fem_tpu_torch.ops import triton_kernels as tk
    from pl_fem_tpu_torch.ops.analytic import lp_modes, vector_modes
    from pl_fem_tpu_torch.ops.femgrid import (MeshGenerator,
                                              export_device_grid)
    from pl_fem_tpu_torch.solvers import (ScalarHelmholtzSolver,
                                          TrueVectorialMaxwellSolver)

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
    t0 = time.perf_counter()
    cfg, grid, dg, geoms = wl.config1_sweep()
    print(f"mesh: {grid.n_points} points, {grid.n_dofs} DOFs, "
          f"{grid.n_elems} elements, bucket {dg.bucket} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    k_c1 = wl.N_MODES + cfg.solver.extra_vectors
    results = _kernel_checks(dg, geoms, k_c1, dev)
    torch.cuda.empty_cache()
    results_sc = _scalar_kernel_checks(dg, wl.config1_geom(1.55), k_c1, dev)
    torch.cuda.empty_cache()
    results_sw = _sweep_assembly_checks(dg, geoms, _sweep_betas(geoms), dev)
    torch.cuda.empty_cache()
    results_rr = {
        "seed_prolong": _seed_checks(dg, geoms, wl.N_MODES, cfg, dev),
        "ritz_residual": _rr_checks(dg, geoms, k_c1,
                                    min(k_c1, wl.N_MODES + 4), cfg, dev)}
    torch.cuda.empty_cache()

    # -- 4. the main path: warm-up, then timed --------------------------
    wrappers = {"apply_vector3": ck.apply_vector3,
                "accumulate": ck.accumulate,
                "mass_apply": ck.mass_apply,
                "cheb_step": tk.cheb_step,
                "apply_stacked": ck.apply_stacked,
                "eps_at_quadrature": tk.eps_at_quadrature,
                "scalar_blocks": ck.scalar_blocks,
                "pencil_bounds": ck.pencil_bounds,
                "inv_eps_at_quadrature": tk.inv_eps_at_quadrature,
                "pencil_bounds_vector3": ck.pencil_bounds_vector3,
                "seed_prolong": ck.seed_prolong,
                "ritz_residual": ck.ritz_residual,
                "scalar_pencil": ck.scalar_pencil,
                "binv_chain": ck.binv_chain}
    # the vectorial paths run K1-K4, the batched K6, K8 from the
    # quadrature data, K9 and K10 (B^-1 on K3 steps where the fused rows
    # are wider than K12 takes, as the config-1 sweep's; the dataset's
    # few-mode sweeps take K12, so it is not required there:
    # _check_apply_launches holds it to one launch per chain it takes);
    # the scalar paths K2-K5 and K10-K12.
    # The single-design K6, K7 and K8 on assembled blocks are on no path:
    # they are K11's yardstick
    sweep_only = ("inv_eps_at_quadrature", "pencil_bounds_vector3",
                  "seed_prolong")
    standalone = ("eps_at_quadrature", "scalar_blocks", "pencil_bounds")
    on_vector = ["apply_vector3", "accumulate", "mass_apply", "cheb_step",
                 "ritz_residual", *sweep_only]
    on_scalar = ["accumulate", "mass_apply", "cheb_step", "apply_stacked",
                 "ritz_residual", "scalar_pencil", "binv_chain"]

    def reset_counts():
        for fn in wrappers.values():
            fn.launches = 0

    def read_counts():
        return {name: fn.launches for name, fn in wrappers.items()}

    Solver = TrueVectorialMaxwellSolver
    t0 = time.perf_counter()
    Solver.solve_sweep(geoms, dg, wl.N_MODES, cfg)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with _watch_sweep() as seen:
        sweep = Solver.solve_sweep(geoms, dg, wl.N_MODES, cfg)
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_counts()
    raw_phases = dict(Solver.last_sweep_times)
    phases = {p: round(s, 3) for p, s in raw_phases.items()}
    print(f"sweep warm-up: {warm_s:.1f} s; timed: {dt:.2f} s = "
          f"{dt / wl.N_SWEEP:.3f} s/design; peak device memory "
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
    for name in on_vector:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched by the "
                                 f"main path")
    _check_apply_launches("the timed sweep", launches, seen)
    _check_sweep_launches("the timed sweep", launches, seen)
    _check_seed_rr_launches("the timed sweep", launches, seen, (504, 500))
    sweep_phase_s = dict(seen["phase_s"])

    # -- 4b. the same sweep with its designs split over two slices ------
    launches_split = _split_phase(Solver, geoms, dg, cfg, sweep, dt,
                                  launches, reset_counts, read_counts, card)

    # -- 5. single-core step fiber against the exact dispersion ---------
    fiber = MCFGeometry(1, 8.0, 1.5, 1.53, 1.0, wavelength_um=1.55,
                        use_complex_pml=False)
    fcfg = dataclasses.replace(cfg, mesh_min_points=FIBER_MESH_MIN,
                               mesh_target_points=FIBER_MESH_MIN)
    fgrid = MeshGenerator.generate(fiber, FIBER_REFINE, fcfg)
    fdg = export_device_grid(fgrid, 1024)
    reset_counts()
    with _watch_sweep() as fseen:
        fmodes = Solver.solve_sweep([fiber], fdg, 8, fcfg)[0]
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
    for preset in ("balanced", "accuracy"):
        pcfg = dataclasses.replace(fcfg, solver=solver_preset(
            preset, device="cuda"))
        t0 = time.perf_counter()
        with _watch_sweep() as pseen:
            pmodes = Solver.solve_sweep([fiber], fdg, 8, pcfg)[0]
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        for key in ("sweeps", "boots", "rr_passes", "stacked_passes",
                    "conversions", "rr_conversions"):
            fseen[key] += pseen[key]
        for name, sec in pseen["phase_s"].items():
            fseen["phase_s"][name] = fseen["phase_s"].get(name, 0.0) + sec
        if not pmodes:
            raise AssertionError(f"{preset} preset: the fiber returned no "
                                 f"modes")
        rel = abs(pmodes[0]["n_eff"] - he11) / he11
        print(f"fiber, {preset} preset: {dt:.2f} s, HE11 n_eff "
              f"{pmodes[0]['n_eff']:.7f} vs exact {he11:.7f}, rel err "
              f"{rel:.2e} (limit {FIBER_RTOL:g})", flush=True)
        if not rel <= FIBER_RTOL:
            raise AssertionError(f"fiber HE11 ({preset} preset) rel err "
                                 f"{rel:.2e} > {FIBER_RTOL}")
    _check_sweep_launches("the fiber and its presets", read_counts(), fseen)
    _check_seed_rr_launches("the fiber and its presets", read_counts(),
                            fseen)

    # -- 6. the dataset engine through the CLI at the r5 settings -------
    launches_sweep = launches
    out_tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_dataset_")
    out_dir = Path(out_tmp.name)
    argv = wl.dataset_argv(out_dir)
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with _watch_sweep() as seen:
        gen, records = cli.run(argv)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    lines = (out_dir / "records.jsonl").read_text().splitlines()
    solved = [r for r in records if r.success_physics]
    print(f"dataset engine (configs/r5_dataset.yaml, {wl.DATASET_N} of its "
          f"220 samples, {wl.DATASET_CMT_SLICES} CMT slices): {len(records)} "
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
    if len(lines) != wl.DATASET_N:
        raise AssertionError(f"records.jsonl holds {len(lines)} lines, "
                             f"expected {wl.DATASET_N}")
    for r in solved:
        if r.solver_mode != "bucketed_sweep" or r.n_dofs <= 0:
            raise AssertionError(f"{r.sample_id} passed validation but was "
                                 f"not solved in a bucket sweep: "
                                 f"{r.error_msg}")
    for name in on_vector:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched by the "
                                 f"dataset engine")
    _check_apply_launches("the dataset run", launches, seen)
    _check_sweep_launches("the dataset run", launches, seen)
    _check_seed_rr_launches("the dataset run", launches, seen,
                            (10084, 10000))
    dataset_phase_s = dict(seen["phase_s"])
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
    reset_counts()
    cli.run(argv)
    again = (out_dir / "records.jsonl").read_text().splitlines()
    out_tmp.cleanup()
    relaunched = read_counts()
    print(f"resume run: {len(again)} lines, launches "
          f"{json.dumps(relaunched)}", flush=True)
    if again != lines or any(relaunched.values()):
        raise AssertionError("the resumed run re-simulated samples")

    # each kernel at the largest (B, k) the engine used, on a mesh at the
    # engine's settings: bucket sweeps take ceil(2.8 n_cores) + 12
    # columns, the CMT sweeps n_modes_found + 12 for their 5 slices
    k_ds = max(max(math.ceil(2.8 * r.n_cores), r.n_modes_found)
               for r in solved) + gen.config.solver.extra_vectors
    b_ds = max(max(gen.bucket_sizes), wl.DATASET_CMT_SLICES)
    ds_grid = MeshGenerator.generate(wl.config1_geom(1.55), 1.0, gen.config)
    ds_dg = export_device_grid(ds_grid, gen.config.mesh.bucket_rounding)
    results_ds = _kernel_checks(
        ds_dg,
        [wl.config1_geom(float(w)) for w in np.linspace(1.53, 1.61, b_ds)],
        k_ds, dev)
    torch.cuda.empty_cache()
    launches_ds = launches
    # the sweep's K6 and K8 on the same mesh at B = 5 taper slices of
    # the 7-core design (positions and radii scaled as the CMT slices'
    # are, down to the config's cmt_min_scale), each at its own beta
    slices = [MCFGeometry(7, 8.0 * sc, 1.5 * sc, 1.535, 1.0,
                          wavelength_um=1.55)
              for sc in np.linspace(gen.config.cmt_min_scale, 1.0,
                                    wl.DATASET_CMT_SLICES)]
    results_sw_ds = _sweep_assembly_checks(ds_dg, slices,
                                           _sweep_betas(slices), dev)
    torch.cuda.empty_cache()
    # K9 and K10 there at the engine's k: its CMT sweeps gate n_modes + 4
    extra = gen.config.solver.extra_vectors
    results_rr_ds = {
        "seed_prolong": _seed_checks(ds_dg, slices, k_ds - extra,
                                     gen.config, dev),
        "ritz_residual": _rr_checks(ds_dg, slices, k_ds,
                                    min(k_ds, k_ds - extra + 4), gen.config,
                                    dev)}
    torch.cuda.empty_cache()

    # -- 7. the scalar solver at full width: device, hybrid, fiber ------
    sgeom = wl.config1_geom(1.55)
    ScalarHelmholtzSolver(sgeom, cfg).solve(dg, wl.N_MODES)      # warm-up
    torch.cuda.synchronize()
    reset_counts()
    ssolver = ScalarHelmholtzSolver(sgeom, cfg)
    t0 = time.perf_counter()
    with _watch_sweep() as seen:
        smodes = ssolver.solve(dg, wl.N_MODES)
        torch.cuda.synchronize()
    dt_dev = time.perf_counter() - t0
    launches_scalar = read_counts()
    print("scalar solve phases (s): " + json.dumps(
        {p: round(v, 3) for p, v in ssolver.last_solve_times.items()}),
        flush=True)
    passes = launches_scalar["cheb_step"] / cfg.solver.cheb_degree
    print(f"scalar solve (config-1 design at 1.55 um, {grid.n_dofs} DOFs, "
          f"{wl.N_MODES} modes, device backend): {dt_dev:.2f} s, "
          f"{passes:g} passes of degree {cfg.solver.cheb_degree}, "
          f"{len(smodes)} modes", flush=True)
    print(f"launches in the scalar solve: {json.dumps(launches_scalar)}",
          flush=True)
    for name in on_scalar:
        if launches_scalar[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched by the "
                                 f"scalar solve")
    if launches_scalar["apply_vector3"]:
        raise AssertionError("the scalar solve launched K1")
    _check_apply_launches("the scalar solve", launches_scalar, seen)
    _check_seed_rr_launches("the scalar solve", launches_scalar, seen)
    _check_scalar_launches("the scalar solve", launches_scalar, seen)
    split = _scalar_assemble_split(dg, sgeom, dev)
    hcfg = dataclasses.replace(cfg, solver=dataclasses.replace(
        cfg.solver, backend="hybrid"))
    reset_counts()
    t0 = time.perf_counter()
    hsolver = ScalarHelmholtzSolver(sgeom, hcfg)
    hmodes = hsolver.solve(dg, wl.N_MODES)
    dt_hyb = time.perf_counter() - t0
    print("hybrid solve phases (s): " + json.dumps(
        {p: round(v, 3) for p, v in hsolver.last_solve_times.items()}),
        flush=True)
    if any(read_counts().values()):
        raise AssertionError("the hybrid backend launched a kernel")
    ne_d = [m["n_eff"] for m in smodes[:wl.N_MODES]]
    ne_h = [m["n_eff"] for m in hmodes[:wl.N_MODES]]
    print(f"scalar solve, hybrid backend (host ARPACK): {dt_hyb:.2f} s, "
          f"{len(hmodes)} modes", flush=True)
    print(f"scalar n_eff device: {[round(x, 7) for x in ne_d]}", flush=True)
    print(f"scalar n_eff hybrid: {[round(x, 7) for x in ne_h]}", flush=True)
    if len(ne_d) < wl.N_MODES or len(ne_h) < wl.N_MODES:
        raise AssertionError(f"scalar solve found {len(ne_d)} (device) and "
                             f"{len(ne_h)} (hybrid) of {wl.N_MODES} modes")
    worst = max(abs(a - b) for a, b in zip(ne_d, ne_h))
    print(f"scalar device vs hybrid: max|dn_eff| = {worst:.2e} (limit "
          f"{SCALAR_PARITY:g})", flush=True)
    if not worst <= SCALAR_PARITY:
        raise AssertionError(f"scalar device and hybrid n_eff differ by "
                             f"{worst:.2e} > {SCALAR_PARITY:g}")
    for m in smodes:
        if not (sgeom.n_clad < m["n_eff"] < sgeom.n_core * 1.005
                and np.all(np.isfinite(m["field_vector"]))
                and m["field_vector"].shape == (grid.n_dofs,)):
            raise AssertionError("bad scalar mode")
    reset_counts()
    with _watch_sweep() as fsseen:
        fsm = ScalarHelmholtzSolver(fiber, fcfg).solve(fdg, 8)
    launches_fiber = read_counts()
    _check_apply_launches("the scalar fiber", launches_fiber, fsseen)
    _check_seed_rr_launches("the scalar fiber", launches_fiber, fsseen)
    _check_scalar_launches("the scalar fiber", launches_fiber, fsseen)
    lp01 = max(ne for _, _, ne in lp_modes(fiber.V_number, fiber.n_core,
                                            fiber.n_clad))
    if not fsm:
        raise AssertionError("single-core fiber returned no scalar modes")
    rel = abs(fsm[0]["n_eff"] - lp01) / lp01
    print(f"fiber ({fgrid.n_dofs} DOFs): scalar LP01 n_eff "
          f"{fsm[0]['n_eff']:.6f} vs exact {lp01:.6f}, rel err {rel:.2e} "
          f"(limit {LP01_RTOL:g})", flush=True)
    if not rel <= LP01_RTOL:
        raise AssertionError(f"fiber LP01 rel err {rel:.2e} > {LP01_RTOL}")

    # -- 8. the scalar dataset engine through the CLI -------------------
    out_tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_scalar_")
    out_dir = Path(out_tmp.name)
    argv = wl.scalar_dataset_argv(out_dir)
    reset_counts()
    t0 = time.perf_counter()
    with _watch_sweep() as seen:
        sgen, srecords = cli.run(argv)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches_sds = read_counts()
    lines = (out_dir / "records.jsonl").read_text().splitlines()
    ssolved = [r for r in srecords if r.success_physics]
    print(f"scalar dataset engine (--scalar, configs/r5_dataset.yaml, "
          f"{wl.SCALAR_DATASET_N} of its 220 samples, "
          f"{wl.DATASET_CMT_SLICES} CMT slices, serial loop): "
          f"{len(srecords)} records, {len(ssolved)} validated; {wall:.1f} s "
          f"wall = {3600.0 * len(ssolved) / wall:.1f} designs/hour (host "
          f"clock)", flush=True)
    print("scalar dataset phase seconds, summed over designs: " + json.dumps(
        {p: round(v, 3) for p, v in sgen.phase_times.items()}), flush=True)
    print(f"launches in the scalar dataset run: {json.dumps(launches_sds)}",
          flush=True)
    for r in srecords:
        print(f"  {r.sample_id}: success={r.success} mode={r.solver_mode} "
              f"dofs={r.n_dofs} modes={r.n_modes_found} "
              f"n_eff_max={r.n_eff_max:.6f} IL_mux={r.IL_phys_mux_dB} "
              f"IL_CMT_mux={r.IL_CMT_mux_dB} "
              f"power_mux={r.power_conservation_mux} "
              f"error={r.error_msg} warnings={r.warnings}", flush=True)
    if len(lines) != wl.SCALAR_DATASET_N:
        raise AssertionError(f"records.jsonl holds {len(lines)} lines, "
                             f"expected {wl.SCALAR_DATASET_N}")
    for r in ssolved:
        if r.solver_mode != "scalar_cascade" or r.n_dofs <= 0:
            raise AssertionError(f"{r.sample_id} passed validation but is "
                                 f"no scalar_cascade record: {r.error_msg}")
    for name in on_scalar:
        if launches_sds[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched by the "
                                 f"scalar dataset engine")
    _check_apply_launches("the scalar dataset run", launches_sds, seen)
    _check_seed_rr_launches("the scalar dataset run", launches_sds, seen)
    _check_scalar_launches("the scalar dataset run", launches_sds, seen)
    sgood = [r for r in srecords if r.success and _finite(
        r.IL_phys_mux_dB, r.MDL_phys_mux_dB, r.crosstalk_mux_dB,
        r.IL_phys_demux_dB, r.n_eff_max)]
    if not sgood:
        raise AssertionError("no scalar record succeeded with finite losses")
    n_cmt = sum(1 for r in srecords if _finite(r.IL_CMT_mux_dB))
    print(f"scalar records with finite losses: {len(sgood)}/{len(srecords)};"
          f" with a CMT IL: {n_cmt}", flush=True)
    reset_counts()
    cli.run(argv)
    again = (out_dir / "records.jsonl").read_text().splitlines()
    out_tmp.cleanup()
    relaunched = read_counts()
    print(f"scalar resume run: {len(again)} lines, launches "
          f"{json.dumps(relaunched)}", flush=True)
    if again != lines or any(relaunched.values()):
        raise AssertionError("the resumed scalar run re-simulated samples")

    # K5-K8 and K11 at the scalar engine's largest k on the dataset mesh
    k_sds = max(max(math.ceil(2.8 * r.n_cores), r.n_modes_found)
                for r in ssolved) + sgen.config.solver.extra_vectors
    results_sds = _scalar_kernel_checks(ds_dg, sgeom, k_sds, dev)
    torch.cuda.empty_cache()

    src = "pl_fem_tpu_torch/ops/"
    meta = {
        "apply_vector3": ("cuda", src + "csrc/apply_vector3.cu",
                          "pl_fem_tpu/ops/kernels.py:453"),
        "accumulate": ("cuda", src + "csrc/accumulate.cu",
                       "pl_fem_tpu/ops/kernels.py:426"),
        "mass_apply": ("cuda", src + "csrc/mass_apply.cu",
                       "pl_fem_tpu/ops/kernels.py:605, "
                       "pl_fem_tpu/ops/kernels.py:640"),
        "cheb_step": ("triton", src + "triton_kernels.py",
                      "pl_fem_tpu/ops/kernels.py:702"),
        "apply_stacked": ("cuda", src + "csrc/apply_stacked.cu",
                          "pl_fem_tpu/ops/kernels.py:74, "
                          "pl_fem_tpu/ops/kernels.py:53"),
        "eps_at_quadrature": ("triton", src + "triton_kernels.py",
                              "pl_fem_tpu/ops/assembly.py:126"),
        "scalar_blocks": ("cuda", src + "csrc/scalar_blocks.cu",
                          "pl_fem_tpu/ops/assembly.py:151, "
                          "pl_fem_tpu/ops/assembly.py:327"),
        "pencil_bounds": ("cuda", src + "csrc/pencil_bounds.cu",
                          "pl_fem_tpu/ops/kernels.py:1120"),
        "inv_eps_at_quadrature": ("triton", src + "triton_kernels.py",
                                  "pl_fem_tpu/ops/assembly.py:126, "
                                  "pl_fem_tpu/ops/assembly.py:356"),
        "pencil_bounds_vector3": ("cuda", src + "csrc/pencil_bounds.cu",
                                  "pl_fem_tpu/ops/kernels.py:1120, "
                                  "pl_fem_tpu/solvers/vectorial.py:648-664"),
        "seed_prolong": ("cuda", src + "csrc/seed_prolong.cu",
                         "pl_fem_tpu/solvers/vectorial.py:125"),
        "ritz_residual": ("cuda", src + "csrc/ritz_residual.cu",
                          "pl_fem_tpu/ops/kernels.py:759, "
                          "pl_fem_tpu/ops/kernels.py:962"),
        "scalar_pencil": ("cuda", src + "csrc/scalar_pencil.cu",
                          "pl_fem_tpu/ops/assembly.py:126, "
                          "pl_fem_tpu/ops/assembly.py:151, "
                          "pl_fem_tpu/ops/assembly.py:327, "
                          "pl_fem_tpu/ops/kernels.py:1120"),
        "binv_chain": ("cuda", src + "csrc/binv_chain.cu",
                       "pl_fem_tpu/ops/kernels.py:640"),
    }
    kernels = []
    for name, (route, source, replaces) in meta.items():
        by_path = {"sweep": launches_sweep[name],
                   "split_sweep": launches_split[name],
                   "dataset": launches_ds[name],
                   "scalar_solve": launches_scalar[name],
                   "scalar_dataset": launches_sds[name]}
        if name in results_rr:
            # K9 and K10: the vectorial dataset run's count, the config-1
            # sweep's shapes; the r5 mesh's B = 5 slices at its k beside
            row = {"launches": launches_ds[name], **results_rr[name],
                   "dataset_shape": results_rr_ds[name]}
        elif name in results_sw:
            # the sweep's assemble and bounds: the dataset run's count,
            # the config-1 sweep's B = 8 designs; the taper slices on the
            # dataset's mesh beside them
            row = {"launches": launches_ds[name], **results_sw[name],
                   "dataset_shape": {"B": wl.DATASET_CMT_SLICES,
                                     **results_sw_ds[name]}}
        elif name in results:
            # K1-K4: the vectorial dataset run's count, the packed
            # shapes' numbers; the scalar solver's shapes beside them
            row = {"launches": launches_ds[name], **results[name],
                   "dataset_shape": {"B": b_ds, "k": k_ds,
                                     **results_ds[name]}}
            if name in results_sc:
                row["scalar_shape"] = {"k": k_c1, **results_sc[name]}
                row["scalar_dataset_shape"] = {"k": k_sds,
                                               **results_sds[name]}
        else:
            # K5-K8 and K11: the scalar solve's count, the config-1 mesh
            # at k = 22; the scalar dataset's mesh and k beside them
            row = {"launches": launches_scalar[name], **results_sc[name],
                   "dataset_shape": {"k": k_sds, **results_sds[name]}}
        if name in standalone:
            row["on_path"] = "none: K11's yardstick on the scalar path"
        kernels.append({"name": name, "route": route, "source": source,
                        "replaces": replaces, **row,
                        "launches_by_path": by_path})
    print("assemble / bounds seconds: config-1 sweep (outer sweep) "
          f"{raw_phases.get('assemble')} / {raw_phases.get('bounds')}, both "
          f"sweeps "
          f"{sweep_phase_s.get('assemble', 0.0):.4f} / "
          f"{sweep_phase_s.get('bounds', 0.0):.4f}; r5 dataset run summed "
          f"{dataset_phase_s.get('assemble', 0.0):.4f} / "
          f"{dataset_phase_s.get('bounds', 0.0):.4f} (card {card})",
          flush=True)
    print(f"scalar assemble split (config-1 mesh, host clock to a "
          f"synchronise; card {card}): {json.dumps(split)}", flush=True)
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
