"""The Triton kernels with their plain PyTorch twins: K4, the Chebyshev
recurrence step, and K6, the permittivity at the quadrature points (one
design's Re and Im, or 1/Re of every design of a sweep).

K4 replaces the step of pl_fem_tpu/ops/kernels.py ``_sweep_apply_t`` and
``_sweep_iterate``: given W = B^{-1} A(beta_b) V for the current vector
V = T1, the shifted-scaled filter operator is T V = (W - c_b V) / h_b
and the three-term recurrence is T2 = 2 T(T1) - T0, over the fused-lane
block (D, B, C, k) with per-design centre c_b and half-width h_b (C = 3
components in the packed vectorial sweep; the scalar solver's stacked
block (C D, k) goes in as (C D, 1, 1, k)). The opening step (``T0 is
None``) returns T(V) itself.

The renorm is deferred. A renorm step writes T2 unscaled and forms
s = 1 / (||T2||_(D, C) + 1e-30) for every (design, column) on the
device; the reference's rescaled pair (s T1, s T2) is then carried as
the unscaled arrays plus the pending scale s. The recurrence is linear,
so the next two steps apply s as they read their inputs: a step takes
an optional scale of V (``scale``, which multiplies 2 T(V), since
W = B^{-1} A(V) is linear in V) and of T0 (``scale_t0``):

    T2 = scale * 2 (W - c_b V) / h_b - scale_t0 * T0.

Right after a renorm both are s; one step later only ``scale_t0`` is.
The caller flushes a scale still pending when the recurrence ends.

Two programs, both launched on PyTorch's current stream:

- ``_step``: the fused elementwise pass over (D, L) tiles; on renorm
  steps each program walks NT tiles down the rows and writes its column
  sums of T2^2 to a small (row groups, L) partial array;
- ``_colnorm``: one program per block of (design, column) pairs sums
  the partials over all row groups and the C components in a fixed
  order (so s is deterministic) and writes s (B, k).

Neither is specialized on the lane count L (nor ``_colnorm`` on the
pair count): the order of a renorm's sums then does not depend on how
many designs share the block, so a design's scale is the same bits in a
sweep of B designs and in a slice of it (``solve_sweep(mesh=)``); with
L specialized, a config-1 design's scale moved by ~1e-7 between B = 8
and B = 4, which the bootstrap's seed turned into 1.2e-5 in n_eff.

Bound on the H100: bytes. A step reads W, T1, T0 and writes T2, four
(D, L) f32 arrays, whether renorm or not: the scales are (B, k)
vectors, and the partials 1 / (32 NT) of a block. The design fuses the
shift, scale, recurrence and the norm's partial sums into one pass, so
W is never written back in a scaled form and T2 is never read again.

K6 replaces pl_fem_tpu/ops/assembly.py ``eps_at_quadrature``: one fused
elementwise pass over the E * Q quadrature points, each testing its
distance to the N cores in a short loop and evaluating the annular PML
polynomial. Bound on the H100: bytes (two coordinates read, two values
written per point). The in-core test squares with ``mul.rn.f32`` so that
the compiler cannot fuse a square into the sum that follows: every point
is decided exactly as the twin's separately rounded ops decide it. The
PML polynomial keeps the twin's roundings too (IEEE square root and
division, libdevice's ``powf``). Its batched entry for the vectorial
sweep, ``inv_eps_at_quadrature``, replaces the per-design loop of
pl_fem_tpu/ops/assembly.py ``assemble_vector3_qf``'s 1/eps: one launch
over a grid of point blocks by designs writes 1/Re(eps) of all B
designs (the same core test, then an IEEE ``div_rn``).

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
_NT = 8           # tiles down the rows per program on renorm steps
_BP = 16          # (design, column) pairs per _colnorm program
_BR = 64          # row groups per _colnorm load
_KERNELS: dict = {}
_LOCK = threading.Lock()


def cheb_step_plain(W, V, T0: Optional[torch.Tensor], c, h,
                    renorm: bool = False, scale=None, scale_t0=None):
    """Plain twin of K4 on (D, B, C, k) blocks; c, h are (B,), the
    pending scales ``scale`` (of V) and ``scale_t0`` (of T0) (B, k) or
    None.

    Returns (T2, s): T2 = scale * 2 (W - c V) / h - scale_t0 * T0 (the
    opening step (W - c V) / h when T0 is None), and with ``renorm``
    s = 1 / (||T2||_(D, C) + 1e-30) as (B, k), else None. Nothing is
    updated in place.
    """
    cb = c[None, :, None, None]
    hb = h[None, :, None, None]
    T2 = (W - cb * V) / hb
    if T0 is not None:
        T2 = 2.0 * T2
        if scale is not None:
            T2 = scale[None, :, None, :] * T2
        T0s = T0 if scale_t0 is None else scale_t0[None, :, None, :] * T0
        T2 = T2 - T0s
    s = None
    if renorm:
        s = 1.0 / (torch.linalg.vector_norm(T2, dim=(0, 2)) + 1e-30)
    return T2, s


def _build():
    import triton
    import triton.language as tl
    from triton.language.extra import libdevice

    # L (and NPAIR) are not specialized: Triton's layout for a tile, and
    # with it the order of the per-column sums of a renorm, follows what
    # it knows of L's divisibility, so a design's scale would change with
    # the number of designs sharing the block (a split sweep's slices)
    @triton.jit(do_not_specialize=["L"])
    def _step(W, V, T0, C, H, SV, ST0, OUT, P, D, L, K: tl.constexpr,
              LB: tl.constexpr, FIRST: tl.constexpr, RENORM: tl.constexpr,
              HAS_SV: tl.constexpr, HAS_ST0: tl.constexpr,
              BD: tl.constexpr, BL: tl.constexpr, NT: tl.constexpr):
        pid_d = tl.program_id(0)
        pid_l = tl.program_id(1)
        cols = pid_l * BL + tl.arange(0, BL)
        cmask = cols < L
        b = cols // LB
        pair = b * K + cols % K                        # (design, column)
        cb = tl.load(C + b, mask=cmask, other=0.0)
        hb = tl.load(H + b, mask=cmask, other=1.0)
        if HAS_SV:
            sv = tl.load(SV + pair, mask=cmask, other=1.0)
        if HAS_ST0:
            s0 = tl.load(ST0 + pair, mask=cmask, other=1.0)
        ps = tl.zeros((BL,), dtype=tl.float32)
        for it in tl.static_range(NT):
            rows = (pid_d * NT + it) * BD + tl.arange(0, BD)
            m = (rows[:, None] < D) & cmask[None, :]
            offs = rows[:, None].to(tl.int64) * L + cols[None, :]
            w = tl.load(W + offs, mask=m, other=0.0)
            v = tl.load(V + offs, mask=m, other=0.0)
            t = (w - cb[None, :] * v) / hb[None, :]
            if not FIRST:
                t = 2.0 * t
                if HAS_SV:
                    t = sv[None, :] * t
                t0 = tl.load(T0 + offs, mask=m, other=0.0)
                if HAS_ST0:
                    t0 = s0[None, :] * t0
                t = t - t0
            tl.store(OUT + offs, t, mask=m)
            if RENORM:
                ps += tl.sum(t * t, axis=0)
        if RENORM:
            tl.store(P + pid_d * L + cols, ps, mask=cmask)

    @triton.jit(do_not_specialize=["L", "NPAIR"])
    def _colnorm(P, S, NRB, L, NPAIR, K: tl.constexpr, C: tl.constexpr,
                 BP: tl.constexpr, BR: tl.constexpr):
        pairs = tl.program_id(0) * BP + tl.arange(0, BP)  # (design, column)
        pmask = pairs < NPAIR
        b = pairs // K
        j = pairs - b * K
        base = b * (C * K) + j
        acc = tl.zeros((BP,), dtype=tl.float32)
        for r0 in range(0, NRB, BR):
            r = r0 + tl.arange(0, BR)
            rm = (r[:, None] < NRB) & pmask[None, :]
            row = r[:, None].to(tl.int64) * L
            for comp in tl.static_range(C):
                x = tl.load(P + row + (base + comp * K)[None, :], mask=rm,
                            other=0.0)
                acc += tl.sum(x, axis=0)
        tl.store(S + pairs, 1.0 / (tl.sqrt(acc) + 1e-30), mask=pmask)

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

    @triton.jit
    def _inv_eps(XY, POS, R2, EC, ECL, OUT, P, NMAX, BLOCK: tl.constexpr,
                 NP: tl.constexpr):
        offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
        b = tl.program_id(1)
        m = offs < P
        x = tl.load(XY + 2 * offs, mask=m, other=0.0)
        y = tl.load(XY + 2 * offs + 1, mask=m, other=0.0)
        # the design's cores as one (NP,) load, padding at r2 = -1
        n = tl.arange(0, NP)
        nm = n < NMAX
        c = b * NMAX + n
        px = tl.load(POS + 2 * c, mask=nm, other=0.0)
        py = tl.load(POS + 2 * c + 1, mask=nm, other=0.0)
        r2 = tl.load(R2 + c, mask=nm, other=-1.0)
        dx = x[:, None] - px[None, :]
        dy = y[:, None] - py[None, :]
        dx2 = tl.inline_asm_elementwise(
            "mul.rn.f32 $0, $1, $2;", "=f,f,f", [dx, dx],
            dtype=tl.float32, is_pure=True, pack=1)
        dy2 = tl.inline_asm_elementwise(
            "mul.rn.f32 $0, $1, $2;", "=f,f,f", [dy, dy],
            dtype=tl.float32, is_pure=True, pack=1)
        hit = (dx2 + dy2 <= r2[None, :]).to(tl.int32)
        re = tl.where(tl.max(hit, axis=1) > 0, tl.load(EC + b),
                      tl.load(ECL + b))
        tl.store(OUT + b * P + offs, tl.div_rn(1.0 + tl.zeros_like(x), re),
                 mask=m)

    return {"step": _step, "colnorm": _colnorm, "eps": _eps,
            "inv_eps": _inv_eps}


def _kernels():
    """The built kernels; call with ``_LOCK`` held."""
    if not _KERNELS:
        _KERNELS.update(_build())
    return _KERNELS


def cheb_step(W, V, T0: Optional[torch.Tensor], c, h, renorm: bool = False,
              scale=None, scale_t0=None):
    """K4: one Chebyshev recurrence step on (D, B, C, k) f32 blocks.

    T2 = scale * 2 (W - c_b V) / h_b - scale_t0 * T0, or (W - c_b V) / h_b
    when ``T0`` is None; ``scale`` and ``scale_t0`` are the pending
    renorm scales (B, k) of V and T0, None for 1. Returns (T2, s): with
    ``renorm``, s = 1 / (||T2||_(D, C) + 1e-30) as (B, k), formed on the
    device and pending on both V and T2; else s is None. Two launches on
    a renorm step, one otherwise; nothing is updated in place.
    """
    if renorm and scale is not None:
        # s would then be pending on V times ``scale``, not on V
        raise ValueError("a renorm step right after a renorm step")
    if W.device.type == "cpu":
        return cheb_step_plain(W, V, T0, c, h, renorm, scale, scale_t0)
    dev = W.device
    if W.dim() != 4:
        raise ValueError(f"expected (D, B, C, k) blocks, got {tuple(W.shape)}")
    D, B, C, k = W.shape
    arrays = {"W": W, "V": V, "c": c, "h": h}
    for name, t in (("T0", T0), ("scale", scale), ("scale_t0", scale_t0)):
        if t is not None:
            arrays[name] = t
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
    for name in ("scale", "scale_t0"):
        if name in arrays and arrays[name].shape != (B, k):
            raise ValueError(f"{name} must be a (B, k) = {(B, k)} scale")
    if T0 is None and (scale is not None or scale_t0 is not None):
        raise ValueError("the opening step takes no pending scale")
    L = B * C * k
    out = torch.empty_like(W)
    nt = _NT if renorm else 1
    nrb = -(-D // (_BD * nt))
    grid = (nrb, -(-L // _BL))
    P = torch.empty((nrb, L), dtype=torch.float32, device=dev) \
        if renorm else out
    s = torch.empty((B, k), dtype=torch.float32, device=dev) \
        if renorm else None
    with _LOCK:
        kn = _kernels()
        kn["step"][grid](W, V, W if T0 is None else T0, c, h,
                         c if scale is None else scale,
                         c if scale_t0 is None else scale_t0, out, P, D, L,
                         K=k, LB=C * k, FIRST=T0 is None, RENORM=renorm,
                         HAS_SV=scale is not None,
                         HAS_ST0=scale_t0 is not None, BD=_BD, BL=_BL,
                         NT=nt)
        if renorm:
            kn["colnorm"][(-(-(B * k) // _BP),)](
                P, s, nrb, L, B * k, K=k, C=C, BP=_BP, BR=_BR)
        cheb_step.launches += 1
    return out, s


cheb_step.launches = 0


# ---------------------------------------------------------------------------
# K6: permittivity at the quadrature points
# ---------------------------------------------------------------------------

_EPS_BLOCK = 1024     # points per program
_INV_EPS_TILE = 2048  # (points, cores) pairs per program of the batched K6


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


def inv_eps_at_quadrature_plain(qp_xy, eps_batch):
    """Plain twin of the batched K6: 1 / eps_re (B, E, Q), design by
    design ``eps_at_quadrature_plain``'s core test (padded cores, r2 =
    -1, hold no point) and then ``1.0 / eps_re``."""
    x = qp_xy[..., 0]
    y = qp_xy[..., 1]
    out = []
    for b in range(eps_batch.r2.shape[0]):
        pos = eps_batch.positions[b]
        d2 = ((x[..., None] - pos[:, 0]) ** 2
              + (y[..., None] - pos[:, 1]) ** 2)
        in_core = torch.any(d2 <= eps_batch.r2[b], dim=-1)
        eps_re = torch.where(in_core, eps_batch.eps_core[b],
                             eps_batch.eps_clad[b])
        out.append(1.0 / eps_re)
    return torch.stack(out)


def inv_eps_at_quadrature(qp_xy, eps_batch):
    """K6 for a sweep: 1 / Re(eps) at every quadrature point of every
    design, (B, E, Q) f32, in one launch.

    qp_xy (E, Q, 2) f32; ``eps_batch`` an ``assembly.EpsBatch`` of f32
    tensors on the same device: core positions (B, N, 2), squared radii
    r2 (B, N) (-1 on the padding of designs with fewer than N cores) and
    the core / cladding permittivities (B,). The PML does not enter
    Re(eps). The divide is IEEE (``div_rn``), so the result is bit for
    bit the twin's ``1.0 / eps_re``.

    Triton, as the single-design K6: an elementwise pass. A program
    takes a block of points and one design (a grid of point blocks by
    designs, so even B = 1 fills the card), loads the design's cores as
    one vector, tests a (points, cores) tile and writes the block's
    values. Bound on the H100: bytes (two coordinates read, B values
    written per point; the blocks of other designs find the coordinates
    in L2).
    """
    if qp_xy.device.type == "cpu":
        return inv_eps_at_quadrature_plain(qp_xy, eps_batch)
    dev = qp_xy.device
    E, Q, two = qp_xy.shape
    B, n_cores = eps_batch.r2.shape
    shapes = {"positions": (B, n_cores, 2), "r2": (B, n_cores),
              "eps_core": (B,), "eps_clad": (B,)}
    for name, t in [("qp_xy", qp_xy)] + [(n, getattr(eps_batch, n))
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
    if B < 1 or n_cores < 1 or B * P >= 2 ** 31:
        raise ValueError(f"{B} designs of {n_cores} cores at {P} points is "
                         f"not a batch the kernel takes")
    out = torch.empty((B, E, Q), dtype=torch.float32, device=dev)
    NP = max(2, 1 << (n_cores - 1).bit_length())
    block = max(64, _INV_EPS_TILE // NP)        # a (points, cores) tile
    with _LOCK:
        _kernels()["inv_eps"][(-(-P // block), B)](
            qp_xy, eps_batch.positions, eps_batch.r2, eps_batch.eps_core,
            eps_batch.eps_clad, out, P, n_cores, BLOCK=block, NP=NP)
        inv_eps_at_quadrature.launches += 1
    return out


inv_eps_at_quadrature.launches = 0
