"""K4: the Chebyshev recurrence step as Triton kernels, with its plain
PyTorch twin.

Replaces the step of pl_fem_tpu/ops/kernels.py ``_sweep_apply_t`` and
``_sweep_iterate``: given W = B^{-1} A(beta_b) V for the current vector
V = T1, the shifted-scaled filter operator is T V = (W - c_b V) / h_b
and the three-term recurrence is T2 = 2 T(T1) - T0, over the fused-lane
block (D, B, 3, k) with per-design centre c_b and half-width h_b. The
opening step (``T0 is None``) returns T(V) itself. On renorm steps the
recurrence is rescaled: s = 1 / (||T2||_(D, 3) + 1e-30) for every
(design, column), and both T1 and T2 are multiplied by s, T1 in place.

Three programs, all launched on PyTorch's current stream:

- ``_step``: the fused elementwise pass over (D, L) tiles; on renorm
  steps it also writes each tile's column sums of T2^2 to a small
  (row blocks, L) partial array;
- ``_colnorm``: a grid over (blocks of (design, column) pairs, chunks
  of row blocks) sums the partials of its chunk over the rows and the 3
  components into a (chunks, B * k) array;
- ``_rescale``: sums those chunk partials for its lanes (a fixed order,
  so the result is deterministic), forms s and multiplies T1 and T2 by
  s in place.

Bound on the H100: bytes. A step reads W, T1, T0 and writes T2, four
(D, L) f32 arrays; a renorm step adds one read and write of T1 and T2.
The design fuses the shift, scale, recurrence and the norm's partial
sums into one pass, so W is never written back in a scaled form and
T2 is read again only on renorm steps (one in eight).

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
    """Plain twin of K4 on (D, B, 3, k) blocks; c, h are (B,).

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
    def _colnorm(P, P2, NRB, L, NPAIR, K: tl.constexpr, BP: tl.constexpr,
                 RCH: tl.constexpr, BR: tl.constexpr):
        pid_p = tl.program_id(0)
        pid_c = tl.program_id(1)
        pairs = pid_p * BP + tl.arange(0, BP)          # (design, column)
        pmask = pairs < NPAIR
        b = pairs // K
        j = pairs - b * K
        base = b * (3 * K) + j
        acc = tl.zeros((BP,), dtype=tl.float32)
        for r0 in range(0, RCH, BR):
            r = pid_c * RCH + r0 + tl.arange(0, BR)
            rm = (r[:, None] < NRB) & pmask[None, :]
            row = r[:, None].to(tl.int64) * L
            for comp in tl.static_range(3):
                x = tl.load(P + row + (base + comp * K)[None, :], mask=rm,
                            other=0.0)
                acc += tl.sum(x, axis=0)
        tl.store(P2 + pid_c * NPAIR + pairs, acc, mask=pmask)

    @triton.jit
    def _rescale(T1, T2, P2, NCH, NPAIR, D, L, K: tl.constexpr,
                 BD: tl.constexpr, BL: tl.constexpr):
        pid_d = tl.program_id(0)
        pid_l = tl.program_id(1)
        rows = pid_d * BD + tl.arange(0, BD)
        cols = pid_l * BL + tl.arange(0, BL)
        cmask = cols < L
        m = (rows[:, None] < D) & cmask[None, :]
        offs = rows[:, None].to(tl.int64) * L + cols[None, :]
        pair = (cols // (3 * K)) * K + cols % K
        ss = tl.zeros((BL,), dtype=tl.float32)
        for ch in range(0, NCH):
            ss += tl.load(P2 + ch * NPAIR + pair, mask=cmask, other=0.0)
        s = 1.0 / (tl.sqrt(ss) + 1e-30)
        t1 = tl.load(T1 + offs, mask=m, other=0.0)
        t2 = tl.load(T2 + offs, mask=m, other=0.0)
        tl.store(T1 + offs, t1 * s[None, :], mask=m)
        tl.store(T2 + offs, t2 * s[None, :], mask=m)

    return {"step": _step, "colnorm": _colnorm, "rescale": _rescale}


def _kernels():
    """The built kernels; call with ``_LOCK`` held."""
    if not _KERNELS:
        _KERNELS.update(_build())
    return _KERNELS


def cheb_step(W, V, T0: Optional[torch.Tensor], c, h, renorm: bool = False):
    """K4: one Chebyshev recurrence step on (D, B, 3, k) f32 blocks.

    T2 = 2 (W - c_b V) / h_b - T0, or (W - c_b V) / h_b when ``T0`` is
    None. With ``renorm`` the per-(design, column) norm over (D, 3)
    rescales V in place and the returned T2.
    """
    if W.device.type == "cpu":
        return cheb_step_plain(W, V, T0, c, h, renorm)
    dev = W.device
    D, B, C3, k = W.shape
    if C3 != 3:
        raise ValueError(f"expected (D, B, 3, k) blocks, got {tuple(W.shape)}")
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
    L = B * 3 * k
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
                         LB=3 * k, FIRST=T0 is None, RENORM=renorm,
                         BD=_BD, BL=_BL)
        if renorm:
            kn["colnorm"][(-(-(B * k) // _BP), nch)](
                P, P2, nrb, L, B * k, K=k, BP=_BP, RCH=_RCH, BR=32)
            kn["rescale"][grid](V, out, P2, nch, B * k, D, L, K=k, BD=_BD,
                                BL=_BL)
        cheb_step.launches += 1
    return out


cheb_step.launches = 0
