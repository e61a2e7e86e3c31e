"""The Triton kernels with their plain PyTorch twins: K4, the Chebyshev
recurrence step, and K6, the permittivity at the quadrature points.

K4 replaces the step of pl_fem_tpu/ops/kernels.py ``_sweep_apply_t`` and
``_sweep_iterate``: given W = B^{-1} A(beta_b) V for the current vector
V = T1, the shifted-scaled filter operator is T V = (W - c_b V) / h_b
and the three-term recurrence is T2 = 2 T(T1) - T0, over the fused-lane
block (D, B, C, k) with per-design centre c_b and half-width h_b (C = 3
components in the packed vectorial sweep; the scalar solver's stacked
block (C D, k) goes in as (C D, 1, 1, k)). The opening step (``T0 is
None``) returns T(V) itself. On renorm steps the recurrence is rescaled:
s = 1 / (||T2||_(D, C) + 1e-30) for every (design, column), and both T1
and T2 are multiplied by s, T1 in place.

Three programs, all launched on PyTorch's current stream:

- ``_step``: the fused elementwise pass over (D, L) tiles; on renorm
  steps it also writes each tile's column sums of T2^2 to a small
  (row blocks, L) partial array;
- ``_colnorm``: a grid over (blocks of (design, column) pairs, chunks
  of row blocks) sums the partials of its chunk over the rows and the C
  components into a (chunks, B * k) array;
- ``_rescale``: sums those chunk partials for its lanes (a fixed order,
  so the result is deterministic), forms s and multiplies T1 and T2 by
  s in place.

Bound on the H100: bytes. A step reads W, T1, T0 and writes T2, four
(D, L) f32 arrays; a renorm step adds one read and write of T1 and T2.
The design fuses the shift, scale, recurrence and the norm's partial
sums into one pass, so W is never written back in a scaled form and
T2 is read again only on renorm steps (one in eight).

K6 replaces pl_fem_tpu/ops/assembly.py ``eps_at_quadrature``: one fused
elementwise pass over the E * Q quadrature points, each testing its
distance to the N cores in a short loop and evaluating the annular PML
polynomial. Bound on the H100: bytes (two coordinates read, two values
written per point). The in-core test squares with ``mul.rn.f32`` so that
the compiler cannot fuse a square into the sum that follows: every point
is decided exactly as the twin's separately rounded ops decide it. The
PML polynomial keeps the twin's roundings too (IEEE square root and
division, libdevice's ``powf``).

Triton is imported, and the kernels are built, inside the first launch,
so this module imports on hosts without Triton. The launches hold a
lock: the dataset engine runs two sweeps at once from two threads, and a
launch that meets a new specialisation compiles it, which must happen
once and not in two threads at a time. A launch only enqueues work, so
the lock costs the other thread microseconds outside a compile.
"""
from __future__ import annotations

import threading
from typing import Optional

import torch

_BD = 32          # rows per tile
_BL = 128         # lanes per tile
_BP = 64          # (design, column) pairs per _colnorm program
_RCH = 128        # row blocks per _colnorm program
_KERNELS: dict = {}
_LOCK = threading.Lock()


def cheb_step_plain(W, V, T0: Optional[torch.Tensor], c, h,
                    renorm: bool = False):
    """Plain twin of K4 on (D, B, C, k) blocks; c, h are (B,).

    Returns T2; when ``renorm`` it rescales V in place and returns the
    rescaled T2, as the kernel does.
    """
    cb = c[None, :, None, None]
    hb = h[None, :, None, None]
    T2 = (W - cb * V) / hb
    if T0 is not None:
        T2 = 2.0 * T2 - T0
    if renorm:
        s = 1.0 / (torch.linalg.vector_norm(T2, dim=(0, 2), keepdim=True)
                   + 1e-30)
        V.mul_(s)
        T2 = T2 * s
    return T2


def _build():
    import triton
    import triton.language as tl
    from triton.language.extra import libdevice

    @triton.jit
    def _step(W, V, T0, C, H, OUT, P, D, L, LB: tl.constexpr,
              FIRST: tl.constexpr, RENORM: tl.constexpr,
              BD: tl.constexpr, BL: tl.constexpr):
        pid_d = tl.program_id(0)
        pid_l = tl.program_id(1)
        rows = pid_d * BD + tl.arange(0, BD)
        cols = pid_l * BL + tl.arange(0, BL)
        cmask = cols < L
        m = (rows[:, None] < D) & cmask[None, :]
        offs = rows[:, None].to(tl.int64) * L + cols[None, :]
        b = cols // LB
        cb = tl.load(C + b, mask=cmask, other=0.0)
        hb = tl.load(H + b, mask=cmask, other=1.0)
        w = tl.load(W + offs, mask=m, other=0.0)
        v = tl.load(V + offs, mask=m, other=0.0)
        t = (w - cb[None, :] * v) / hb[None, :]
        if not FIRST:
            t0 = tl.load(T0 + offs, mask=m, other=0.0)
            t = 2.0 * t - t0
        tl.store(OUT + offs, t, mask=m)
        if RENORM:
            ps = tl.sum(t * t, axis=0)
            tl.store(P + pid_d * L + cols, ps, mask=cmask)

    @triton.jit
    def _colnorm(P, P2, NRB, L, NPAIR, K: tl.constexpr, C: tl.constexpr,
                 BP: tl.constexpr, RCH: tl.constexpr, BR: tl.constexpr):
        pid_p = tl.program_id(0)
        pid_c = tl.program_id(1)
        pairs = pid_p * BP + tl.arange(0, BP)          # (design, column)
        pmask = pairs < NPAIR
        b = pairs // K
        j = pairs - b * K
        base = b * (C * K) + j
        acc = tl.zeros((BP,), dtype=tl.float32)
        for r0 in range(0, RCH, BR):
            r = pid_c * RCH + r0 + tl.arange(0, BR)
            rm = (r[:, None] < NRB) & pmask[None, :]
            row = r[:, None].to(tl.int64) * L
            for comp in tl.static_range(C):
                x = tl.load(P + row + (base + comp * K)[None, :], mask=rm,
                            other=0.0)
                acc += tl.sum(x, axis=0)
        tl.store(P2 + pid_c * NPAIR + pairs, acc, mask=pmask)

    @triton.jit
    def _rescale(T1, T2, P2, NCH, NPAIR, D, L, K: tl.constexpr,
                 C: tl.constexpr, BD: tl.constexpr, BL: tl.constexpr):
        pid_d = tl.program_id(0)
        pid_l = tl.program_id(1)
        rows = pid_d * BD + tl.arange(0, BD)
        cols = pid_l * BL + tl.arange(0, BL)
        cmask = cols < L
        m = (rows[:, None] < D) & cmask[None, :]
        offs = rows[:, None].to(tl.int64) * L + cols[None, :]
        pair = (cols // (C * K)) * K + cols % K
        ss = tl.zeros((BL,), dtype=tl.float32)
        for ch in range(0, NCH):
            ss += tl.load(P2 + ch * NPAIR + pair, mask=cmask, other=0.0)
        s = 1.0 / (tl.sqrt(ss) + 1e-30)
        t1 = tl.load(T1 + offs, mask=m, other=0.0)
        t2 = tl.load(T2 + offs, mask=m, other=0.0)
        tl.store(T1 + offs, t1 * s[None, :], mask=m)
        tl.store(T2 + offs, t2 * s[None, :], mask=m)

    @triton.jit
    def _eps(XY, POS, R2, EC, ECL, PS, PT, PSTR, PORD, RE, IM, P, NCORES,
             BLOCK: tl.constexpr):
        offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
        m = offs < P
        x = tl.load(XY + 2 * offs, mask=m, other=0.0)
        y = tl.load(XY + 2 * offs + 1, mask=m, other=0.0)
        inside = tl.zeros((BLOCK,), dtype=tl.int32)
        for n in range(0, NCORES):
            dx = x - tl.load(POS + 2 * n)
            dy = y - tl.load(POS + 2 * n + 1)
            # each square rounded on its own, never contracted into an FMA
            dx2 = tl.inline_asm_elementwise(
                "mul.rn.f32 $0, $1, $2;", "=f,f,f", [dx, dx],
                dtype=tl.float32, is_pure=True, pack=1)
            dy2 = tl.inline_asm_elementwise(
                "mul.rn.f32 $0, $1, $2;", "=f,f,f", [dy, dy],
                dtype=tl.float32, is_pure=True, pack=1)
            d2 = dx2 + dy2
            inside = inside | (d2 <= tl.load(R2 + n)).to(tl.int32)
        re = tl.where(inside > 0, tl.load(EC), tl.load(ECL))
        start = tl.load(PS)
        thick = tl.load(PT)
        order = tl.load(PORD)
        # the PML polynomial with the twin's roundings: products rounded
        # on their own, IEEE square root and division, libdevice's powf
        x2 = tl.inline_asm_elementwise(
            "mul.rn.f32 $0, $1, $2;", "=f,f,f", [x, x], dtype=tl.float32,
            is_pure=True, pack=1)
        y2 = tl.inline_asm_elementwise(
            "mul.rn.f32 $0, $1, $2;", "=f,f,f", [y, y], dtype=tl.float32,
            is_pure=True, pack=1)
        rho = tl.div_rn(tl.sqrt_rn(x2 + y2) - start,
                        tl.maximum(thick, 1e-30) + tl.zeros_like(x))
        rho = tl.minimum(tl.maximum(rho, 0.0), 1.0)
        pw = libdevice.pow(rho, order + tl.zeros_like(rho))
        sigma = tl.where((thick > 0.0) & (start > 0.0),
                         tl.load(PSTR) * pw, 0.0)
        tl.store(RE + offs, re, mask=m)
        tl.store(IM + offs, re * sigma, mask=m)

    return {"step": _step, "colnorm": _colnorm, "rescale": _rescale,
            "eps": _eps}


def _kernels():
    """The built kernels; call with ``_LOCK`` held."""
    if not _KERNELS:
        _KERNELS.update(_build())
    return _KERNELS


def cheb_step(W, V, T0: Optional[torch.Tensor], c, h, renorm: bool = False):
    """K4: one Chebyshev recurrence step on (D, B, C, k) f32 blocks.

    T2 = 2 (W - c_b V) / h_b - T0, or (W - c_b V) / h_b when ``T0`` is
    None. With ``renorm`` the per-(design, column) norm over (D, C)
    rescales V in place and the returned T2.
    """
    if W.device.type == "cpu":
        return cheb_step_plain(W, V, T0, c, h, renorm)
    dev = W.device
    if W.dim() != 4:
        raise ValueError(f"expected (D, B, C, k) blocks, got {tuple(W.shape)}")
    D, B, C, k = W.shape
    arrays = {"W": W, "V": V, "c": c, "h": h}
    if T0 is not None:
        arrays["T0"] = T0
    for name, t in arrays.items():
        if t.device != dev or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 tensor "
                             f"on {dev}")
    for name in ("V", "T0"):
        if name in arrays and arrays[name].shape != W.shape:
            raise ValueError(f"{name} shape {tuple(arrays[name].shape)} "
                             f"!= {tuple(W.shape)}")
    if c.shape != (B,) or h.shape != (B,):
        raise ValueError("c and h must be (B,) per-design vectors")
    L = B * C * k
    out = torch.empty_like(W)
    nrb = -(-D // _BD)
    grid = (nrb, -(-L // _BL))
    P = torch.empty((nrb, L), dtype=torch.float32, device=dev) \
        if renorm else out
    nch = -(-nrb // _RCH)
    P2 = torch.empty((nch, B * k), dtype=torch.float32, device=dev) \
        if renorm else out
    with _LOCK:
        kn = _kernels()
        kn["step"][grid](W, V, W if T0 is None else T0, c, h, out, P, D, L,
                         LB=C * k, FIRST=T0 is None, RENORM=renorm,
                         BD=_BD, BL=_BL)
        if renorm:
            kn["colnorm"][(-(-(B * k) // _BP), nch)](
                P, P2, nrb, L, B * k, K=k, C=C, BP=_BP, RCH=_RCH, BR=32)
            kn["rescale"][grid](V, out, P2, nch, B * k, D, L, K=k, C=C,
                                BD=_BD, BL=_BL)
        cheb_step.launches += 1
    return out


cheb_step.launches = 0


# ---------------------------------------------------------------------------
# K6: permittivity at the quadrature points
# ---------------------------------------------------------------------------

_EPS_BLOCK = 1024     # points per program


def eps_at_quadrature_plain(qp_xy, eps):
    """Plain twin of K6: (eps_re, eps_im), each (E, Q), at the points
    ``qp_xy`` (E, Q, 2). ``eps`` carries the EpsArrays fields: the
    piecewise-constant core / cladding permittivity and the annular PML
    polynomial of models/geometry.py ``epsilon_at``."""
    x = qp_xy[..., 0]
    y = qp_xy[..., 1]
    d2 = ((x[..., None] - eps.positions[:, 0]) ** 2
          + (y[..., None] - eps.positions[:, 1]) ** 2)
    in_core = torch.any(d2 <= eps.core_radii ** 2, dim=-1)
    eps_re = torch.where(in_core, eps.eps_core, eps.eps_clad)
    rho = torch.clamp((torch.sqrt(x * x + y * y) - eps.pml_start)
                      / torch.clamp(eps.pml_thickness, min=1e-30), 0.0, 1.0)
    sigma = torch.where((eps.pml_thickness > 0.0) & (eps.pml_start > 0.0),
                        eps.pml_strength * rho ** eps.pml_order,
                        torch.zeros_like(rho))
    return eps_re, eps_re * sigma


def eps_at_quadrature(qp_xy, eps):
    """K6: relative permittivity (re, im) at every quadrature point.

    qp_xy (E, Q, 2) f32; ``eps`` an EpsArrays of f32 tensors on the same
    device (positions (N, 2), core_radii (N,), six 0-d scalars, read by
    the kernel from device memory: no value comes back to the host).
    ``pml_start <= 0`` or ``pml_thickness <= 0`` disables the PML
    branchlessly. Returns (eps_re, eps_im), both (E, Q).
    """
    if qp_xy.device.type == "cpu":
        return eps_at_quadrature_plain(qp_xy, eps)
    dev = qp_xy.device
    E, Q, two = qp_xy.shape
    n_cores = eps.positions.shape[0]
    shapes = {"positions": (n_cores, 2), "core_radii": (n_cores,),
              "eps_core": (), "eps_clad": (), "pml_start": (),
              "pml_thickness": (), "pml_strength": (), "pml_order": ()}
    for name, t in [("qp_xy", qp_xy)] + [(n, getattr(eps, n))
                                         for n in shapes]:
        if t.device != dev or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 tensor "
                             f"on {dev}")
        if name in shapes and tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{shapes[name]}")
    if two != 2:
        raise ValueError(f"qp_xy must be (E, Q, 2), got {tuple(qp_xy.shape)}")
    P = E * Q
    r2 = eps.core_radii ** 2
    re = torch.empty((E, Q), dtype=torch.float32, device=dev)
    im = torch.empty((E, Q), dtype=torch.float32, device=dev)
    with _LOCK:
        _kernels()["eps"][(-(-P // _EPS_BLOCK),)](
            qp_xy, eps.positions, r2, eps.eps_core, eps.eps_clad,
            eps.pml_start, eps.pml_thickness, eps.pml_strength,
            eps.pml_order, re, im, P, n_cores, BLOCK=_EPS_BLOCK)
        eps_at_quadrature.launches += 1
    return re, im


eps_at_quadrature.launches = 0
