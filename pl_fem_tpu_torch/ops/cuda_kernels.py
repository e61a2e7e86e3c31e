"""Hand-written CUDA kernels, their loader and their plain PyTorch twins:
K1 the packed A(beta_b) apply with its mask and park (element math and
accumulate in one kernel), K2 the element -> DOF accumulate, K3 the
fused DOF-centric mass apply (plain, or one step of the B^{-1}
semi-iteration), K5 the stacked-block apply with its mask and park
(element product and accumulate in one kernel), K7 the scalar pencil's
element blocks, K8 the pencil's spectrum bound (on assembled blocks, and
for the vectorial sweep from the quadrature data of all its designs), K9
the vectorial sweep's bootstrap seed, K10 the Rayleigh-Ritz residual
norms with the pass gate and K11 the scalar pencil's whole set-up (the
permittivity, K7's blocks and K8's bound at C = 1 in one launch; the
scalar path runs it in place of K6, K7 and K8, which stay as its
yardstick), and K12 the B^{-1} semi-iteration of degree >= 2 (K3's step
chain) in one cooperative launch, on rows of at most BINV_LANES lanes.
K8's sweep entry, K9 and K10 take CUDA tensors only: their twins live in
``kernels`` beside the functions that compose them, which pick the twin
on the CPU.

The sources are ``ops/csrc/*.cu``. At first use on a CUDA tensor they
are compiled with ``nvcc`` for ``sm_90a`` (one compiler process per
source, all started together) and linked into one shared library with a
plain C interface under ``pl_fem_tpu_torch/_build/``, loaded with
``ctypes``; a source newer than the library triggers a rebuild. Each
wrapper:

- runs the plain twin when its input lies on the CPU (the tests), and
  launches the kernel on a CUDA tensor, raising on anything the kernel
  does not take; a launch is never wrapped in a fallback;
- allocates the output with ``torch.empty`` and launches on PyTorch's
  current stream without synchronising;
- checks the ``cudaGetLastError`` code the C launcher returns;
- counts its launches in ``<wrapper>.launches``.

The dataset engine runs two sweeps at once from two threads: ``lib()``
builds and loads the library under a lock, once per process, and
``build()`` writes to a temporary name private to its process and
thread.

The (Q, 6) shape table ``N`` comes from ``ops/quadrature.py`` via
``ops/kernels.shape_table`` and is passed at launch.
"""
from __future__ import annotations

import ctypes
import functools
import math
import os
import subprocess
import threading
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np
import torch

from .assembly import MASS_ROWS  # rows per block, kRows of mass_apply.cu
from .triton_kernels import eps_at_quadrature_plain

_CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
_LIB_NAME = "libpl_fem_kernels.so"
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "pl_apply_vector3": [_P] * 14 + [_F] + [_I] * 8 + [_P, _P],
    "pl_accumulate": [_P, _P, _P, _P, _P, _P, _P, _P,
                      _I, _I, _I, _I, _P, _P],
    "pl_mass_apply": [_P] * 14 + [_F] * 4 + [_I] * 6 + [_P],
    "pl_apply_stacked": [_P] * 10 + [_I] * 6 + [_P, _P],
    "pl_scalar_blocks": [_P, _P, _P, _P, _F, _I, _I, _P, _P, _P],
    "pl_pencil_bounds_blocks": [_I, _I],
    "pl_pencil_bounds": [_P, _P, _P, _P, _F, _F, _I, _I, _P, _P, _P],
    "pl_pencil_bounds_vector3_blocks": [_I],
    "pl_pencil_bounds_vector3": [_P] * 5 + [_F, _P, _P, _F, _F]
                                + [_I] * 3 + [_P] * 3,
    "pl_seed_prolong_blocks": [_I] * 3,
    "pl_seed_prolong": [_P] * 6 + [_F] + [_I] * 5 + [_P] * 4,
    "pl_ritz_residual_blocks": [_I] * 4,
    "pl_ritz_residual": [_P] * 5 + [_I] * 5 + [_P] * 4,
    "pl_scalar_pencil": [_P] * 8 + [_F, _P, _P, _F, _F] + [_I] * 3
                        + [_P] * 6,
    "pl_binv_chain": [_P] * 17 + [ctypes.POINTER(_F)] * 2 + [_F]
                     + [_I] * 7 + [_P],
    "pl_binv_chain_limits": [_I] * 4 + [ctypes.POINTER(_I),
                                        ctypes.POINTER(ctypes.c_longlong)],
}
_LIB: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()
_TINY_F32 = float(torch.finfo(torch.float32).tiny) * 1e3   # K8's |detJ| floor


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    return str(cand) if cand.exists() else "nvcc"


def build(verbose: bool = False) -> Path:
    """Compile every ``csrc/*.cu`` into the kernel library; return its path.

    Every source is compiled to an object by its own ``nvcc`` process,
    all started together, and the objects are linked into the library.
    Objects and library are written under names private to this process
    and thread and the library is renamed into place, so a concurrent
    build never loads or overwrites a half-written file.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / _LIB_NAME
    tag = f"{os.getpid()}.{threading.get_ident()}"
    tmp = BUILD_DIR / f".{_LIB_NAME}.{tag}"
    srcs = sorted(_CSRC.glob("*.cu"))
    objs = [BUILD_DIR / f".{src.stem}.{tag}.o" for src in srcs]
    flags = _NVCC_FLAGS + (["-Xptxas=-v"] if verbose else [])
    procs = [subprocess.Popen(
        [_nvcc(), *flags, "-c", "-o", str(obj), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for src, obj in zip(srcs, objs)]
    try:
        logs = [p.communicate() for p in procs]
        for src, p, (so, se) in zip(srcs, procs, logs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name} "
                                   f"({p.returncode}):\n{se}")
            if verbose:
                print(so + se)
        res = subprocess.run(
            [_nvcc(), *_NVCC_FLAGS, "-shared", "-o", str(tmp),
             *map(str, objs)], capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                               f"{res.stderr}")
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    os.replace(tmp, out)
    return out


def _stale(lib: Path) -> bool:
    if not lib.exists():
        return True
    t = lib.stat().st_mtime
    return any(s.stat().st_mtime > t for s in _CSRC.glob("*.cu*"))


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built from the sources on first use
    (once per process, whichever thread gets here first)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            path = BUILD_DIR / _LIB_NAME
            if _stale(path):
                build()
            L = ctypes.CDLL(str(path))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(L, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            L.pl_error_string.argtypes = [ctypes.c_int]
            L.pl_error_string.restype = ctypes.c_char_p
            _LIB = L
        return _LIB


def _count(wrapper) -> None:
    """One more launch on ``wrapper.launches`` (two sweep threads may
    launch at once; the read-modify-write is locked)."""
    with _LOCK:
        wrapper.launches += 1


def _check(rc: int, what: str):
    if rc != 0:
        msg = lib().pl_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")


def _require(t: torch.Tensor, name: str, dtype, device, shape=None):
    if (t.dtype == dtype and t.device == device and t.is_contiguous()
            and (shape is None or t.shape == shape)):
        return          # the common case, in as few calls as it takes
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")


def _require_lanes(t: torch.Tensor, name: str, L: int):
    """K2 and K3 load the lanes of a (rows, L) f32 block as float4,
    float2 or scalars by L, so its start must be aligned to
    4 * gcd(L, 4) bytes, as a row at ``row * L`` is."""
    align = 4 * math.gcd(L, 4)
    if t.data_ptr() % align:
        raise ValueError(f"{name} must start on a {align}-byte boundary "
                         f"(lane count {L})")


def _stream(device) -> int:
    """The raw handle of PyTorch's current stream on ``device``, through
    the accessor torch's own generated launchers use (a Stream object
    built per launch cost more host time than a small kernel takes)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


# ---------------------------------------------------------------------------
# K1: the packed A(beta_b) apply
# ---------------------------------------------------------------------------

def apply_vector3_elem_plain(Xm, elem_dofs, gp, w, inv_eps, betas, alpha,
                             N, k: int):
    """Plain twin of K1: (D, L) masked block -> (E, 6, L) element results.

    L = B * 3 * k in the (B, 3, k) lane order. The algebra is that of
    pl_fem_tpu/ops/kernels.py ``_apply_vector3_fused``: values and
    physical gradients at the Q points, the three curl terms weighted by
    w / eps_b and the divergence term weighted by w * alpha, pulled back
    to the 6 local rows. Values and gradients come from one batched
    product with the per-element table Ph = [N; dN/dx; dN/dy] (3Q, 6),
    the pull-back from one product with its transpose.
    """
    D, L = Xm.shape
    B = betas.shape[0]
    E = elem_dofs.shape[0]
    Q = N.shape[0]
    U = Xm[elem_dofs.long()]                          # (E, 6, L)
    Ph = torch.cat([N.expand(E, Q, 6), gp[..., 0], gp[..., 1]], dim=1)
    VG = torch.bmm(Ph, U).view(E, 3, Q, B, 3, k)
    V, Gx, Gy = VG[:, 0], VG[:, 1], VG[:, 2]          # (E, Q, B, 3, k)
    b = betas[None, None, :, None]                    # over (E, Q, B, k)
    c1 = Gy[:, :, :, 2] - b * V[:, :, :, 1]           # dy hz - b hy
    c2 = b * V[:, :, :, 0] - Gx[:, :, :, 2]           # b hx - dx hz
    c3 = Gx[:, :, :, 1] - Gy[:, :, :, 0]              # dx hy - dy hx
    dv = Gx[:, :, :, 0] + Gy[:, :, :, 1] - b * V[:, :, :, 2]
    we = (w[:, :, None] * inv_eps.permute(1, 2, 0))[..., None]
    wa = (w * alpha)[:, :, None, None]
    c1h, c2h, c3h, dvh = we * c1, we * c2, we * c3, wa * dv
    # value channel S and gradient channels Tx, Ty per component
    STT = torch.stack([
        torch.stack([b * c2h, -b * c1h, -b * dvh], dim=3),
        torch.stack([dvh, c3h, -c2h], dim=3),
        torch.stack([-c3h, dvh, c1h], dim=3)], dim=1).view(E, 3 * Q, L)
    return torch.bmm(Ph.transpose(1, 2), STT)


def apply_vector3_plain(X, gs, gp, w, inv_eps, betas, alpha, N, mask,
                        parks):
    """Plain twin of K1: m * sum_e A_e(beta_b) (m X)_e + park_b (X - m X)
    as three passes, the mask, the element math and K2's twin with its
    epilogue."""
    D, L = X.shape
    B = betas.shape[0]
    Ye = apply_vector3_elem_plain(X * mask[:, None], gs.elem_dofs, gp, w,
                                  inv_eps, betas, alpha, N, L // (3 * B))
    return accumulate_plain(Ye, gs.idx_v, gs.valid_v, gs.idx_e, gs.valid_e,
                            X, mask, parks.repeat_interleave(L // B))


def apply_vector3(X, gs, gp, w, inv_eps, betas, alpha: float, N, mask,
                  parks):
    """K1 (``csrc/apply_vector3.cu``): the packed A(beta_b) apply,
    ``m * sum_e A_e(beta_b) (m X)_e + park_b * (X - m X)``, one launch.

    X (D, L) f32 with L = B * 3 * k in the (B, 3, k) lane order; ``gs``
    a GatherScatter (the kernel reads ``elem_dofs`` and the row blocks
    and element halos of ``gs.apply_plan``; the twin the element and
    transpose tables); gp (E, Q, 6, 2), starting on 16 bytes; w (E, Q);
    inv_eps (B, E, Q); betas (B,); N (Q, 6); mask (D,); parks (B,).
    Returns Y (D, L).
    """
    if X.device.type == "cpu":
        return apply_vector3_plain(X, gs, gp, w, inv_eps, betas, alpha, N,
                                   mask, parks)
    dev = X.device
    D, L = X.shape
    E = gs.elem_dofs.shape[0]
    B = betas.shape[0]
    Q = w.shape[1]
    if L % (3 * B):
        raise ValueError(f"lane count {L} is not B * 3 * k for B = {B}")
    pl = gs.apply_plan
    NB, HE = pl.elems.shape
    f32, i32 = torch.float32, torch.int32
    _require(X, "X", f32, dev)
    _require(gs.elem_dofs, "elem_dofs", i32, dev, (E, 6))
    _require(gp, "gp", f32, dev, (E, Q, 6, 2))
    if gp.data_ptr() % 16:
        raise ValueError("gp must start on a 16-byte boundary (the kernel "
                         "loads a quadrature point's gradients as float4)")
    _require(w, "w", f32, dev, (E, Q))
    _require(inv_eps, "inv_eps", f32, dev, (B, E, Q))
    _require(betas, "betas", f32, dev, (B,))
    _require(N, "N", f32, dev, (Q, 6))
    _require(mask, "mask", f32, dev, (D,))
    _require(parks, "parks", f32, dev, (B,))
    if NB != -(-D // pl.rows):
        raise ValueError(f"plan of {NB} blocks of {pl.rows} rows does not "
                         f"cover {D} rows")
    _require(pl.order, "plan.order", i32, dev, (D,))
    _require(pl.row_ptr, "plan.row_ptr", i32, dev, (NB * pl.rows + 1,))
    _require(pl.elems, "plan.elems", i32, dev)
    _require(pl.n_elems, "plan.n_elems", i32, dev, (NB,))
    _require(pl.dst, "plan.dst", torch.int16, dev, (NB, HE, 6))
    Y = torch.empty((D, L), dtype=f32, device=dev)
    rc = lib().pl_apply_vector3(
        X.data_ptr(), gs.elem_dofs.data_ptr(), gp.data_ptr(), w.data_ptr(),
        inv_eps.data_ptr(), betas.data_ptr(), N.data_ptr(), mask.data_ptr(),
        parks.data_ptr(), pl.order.data_ptr(), pl.row_ptr.data_ptr(),
        pl.elems.data_ptr(), pl.n_elems.data_ptr(), pl.dst.data_ptr(),
        float(alpha), D, E, B, L // (3 * B), Q, pl.rows, HE,
        int(pl.max_entries), Y.data_ptr(), _stream(dev))
    _check(rc, "apply_vector3")
    _count(apply_vector3)
    return Y


apply_vector3.launches = 0


# ---------------------------------------------------------------------------
# K2: element -> DOF accumulate (+ mask/park epilogue)
# ---------------------------------------------------------------------------

def accumulate_plain(Ye, idx_v, valid_v, idx_e, valid_e, X=None, mask=None,
                     park=None):
    """Plain twin of K2: (E, 6, L) -> (D, L) through the split tables.

    With ``X`` given, returns ``Y * m + park * (X - X * m)`` (mask m (D,),
    park (L,) per lane), the epilogue of the operator applies.

    Each table row is a bag of flat (element, row) indices summed with
    weight 1 where valid and 0 where padded: ``embedding_bag``, which
    on the CPU runs ~20x faster than a gather + where + sum.
    """
    E, six, L = Ye.shape
    flat = Ye.reshape(E * six, L)

    def bags(idx, valid):
        return torch.nn.functional.embedding_bag(
            idx.long(), flat, mode="sum",
            per_sample_weights=valid.to(flat.dtype))

    Y = torch.cat([bags(idx_v, valid_v), bags(idx_e, valid_e)], dim=0)
    if X is None:
        return Y
    m = mask[:, None]
    return Y * m + park[None, :] * (X - X * m)


def accumulate(Ye, idx_v, valid_v, idx_e, valid_e, X=None, mask=None,
               park=None):
    """K2 (``csrc/accumulate.cu``): deterministic element -> DOF sum.

    Ye (E, 6, L) f32; idx_v/valid_v (split, Wv) int32/bool; idx_e/valid_e
    (D - split, 2). Optional epilogue operands X (D, L), mask (D,) f32 and
    park (L,) f32. Returns Y (D, L).
    """
    if Ye.device.type == "cpu":
        return accumulate_plain(Ye, idx_v, valid_v, idx_e, valid_e, X,
                                mask, park)
    dev = Ye.device
    E, six, L = Ye.shape
    split, Wv = idx_v.shape
    D = split + idx_e.shape[0]
    f32 = torch.float32
    _require(Ye, "Ye", f32, dev)
    _require(idx_v, "idx_v", torch.int32, dev)
    _require(valid_v, "valid_v", torch.bool, dev, (split, Wv))
    _require(idx_e, "idx_e", torch.int32, dev, (D - split, 2))
    _require(valid_e, "valid_e", torch.bool, dev, (D - split, 2))
    if X is not None:
        _require(X, "X", f32, dev, (D, L))
        _require(mask, "mask", f32, dev, (D,))
        _require(park, "park", f32, dev, (L,))
    if L >= 8:                  # the lane path's vector loads (L < 8: scalar)
        for t, name in ((Ye, "Ye"), (X, "X"), (park, "park")):
            if t is not None:
                _require_lanes(t, name, L)
    Y = torch.empty((D, L), dtype=f32, device=dev)
    rc = lib().pl_accumulate(
        Ye.data_ptr(), idx_v.data_ptr(), valid_v.data_ptr(),
        idx_e.data_ptr(), valid_e.data_ptr(),
        None if X is None else X.data_ptr(),
        None if X is None else mask.data_ptr(),
        None if X is None else park.data_ptr(),
        D, split, Wv, L, Y.data_ptr(), _stream(dev))
    _check(rc, "accumulate")
    _count(accumulate)
    return Y


accumulate.launches = 0


# ---------------------------------------------------------------------------
# K3: the fused mass apply (plain, or one B^{-1} semi-iteration step)
# ---------------------------------------------------------------------------

def apply_mass_elem_plain(Xm, elem_dofs, w, N):
    """Element part of K3's plain twin: Ye[e, i] = sum_j C_ij(e)
    Xm[dof(e, j)] with C_ij(e) = sum_q w[e, q] N[q, i] N[q, j]."""
    C = torch.einsum("eq,qi,qj->eij", w, N, N)
    return torch.einsum("eij,ejl->eil", C, Xm[elem_dofs.long()])


class BinvStep(NamedTuple):
    """Operands of one degree step of the Chebyshev B^{-1}
    semi-iteration (``mass_apply`` step mode).

    With V the input block (W on the first step, else Dd) and s = ``ds``:
    R' = R - s M~(s V), Z' = Z + V, Dd' = a V + b R'; the first step
    takes R = s W, V = R / theta, Z = 0 from W, the last returns
    s (Z' + Dd'). R and Z are (D, L) buffers updated in place (written
    on the first step, read on the last; None at degree 1).
    """

    ds: torch.Tensor               # (D,) Jacobi scale 1 / sqrt(diag B)
    R: Optional[torch.Tensor]
    Z: Optional[torch.Tensor]
    a: float
    b: float
    theta: float
    first: bool
    last: bool


def mass_apply_plain(X, gs, w, N, mask, park: float = 1.0,
                     step: Optional[BinvStep] = None):
    """Plain twin of K3, from K3's former element pass and K2's.

    Plain mode: ``m * M(m * X) + park * (X - m * X)`` (D, L). Step mode:
    one step of the loop of ``kernels._apply_binv_fused_plain`` with the
    same torch ops in the same order, returning Dd' (or the result on
    the last step) and updating ``step.R`` / ``step.Z`` in place.
    """
    if step is None:
        D, L = X.shape
        Xm = X * mask[:, None]
        Ye = apply_mass_elem_plain(Xm, gs.elem_dofs, w, N)
        pk = torch.full((L,), float(park), dtype=X.dtype, device=X.device)
        return accumulate_plain(Ye, gs.idx_v, gs.valid_v, gs.idx_e,
                                gs.valid_e, X, mask, pk)
    ds = step.ds[:, None]
    if step.first:
        R = ds * X
        Z = torch.zeros_like(R)
        Dd = R / step.theta
    else:
        R, Z, Dd = step.R, step.Z, X
    Z = Z + Dd
    R = R - ds * mass_apply_plain(ds * Dd, gs, w, N, mask, 1.0)
    Dd = step.a * Dd + step.b * R
    if step.last:
        return ds * (Z + Dd)
    step.R.copy_(R)
    step.Z.copy_(Z)
    return Dd


def mass_apply(X, gs, w, N, mask, park: float = 1.0,
               step: Optional[BinvStep] = None):
    """K3 (``csrc/mass_apply.cu``): the masked consistent-mass apply.

    X (D, L) f32; ``gs`` a GatherScatter (the kernel reads its ``plan``,
    the per-grid row blocks, entries and halos of
    ``assembly.mass_plan``; the twin its element and transpose tables);
    w (E, Q); N (Q, 6); mask (D,) f32. Plain
    mode returns ``m * M(m * X) + park * (X - m * X)``; with ``step`` it
    runs one B^{-1} semi-iteration step (see :class:`BinvStep`) and
    returns a new tensor, never X (other rows gather X while the kernel
    runs).
    """
    if X.device.type == "cpu":
        return mass_apply_plain(X, gs, w, N, mask, park, step)
    dev = X.device
    D, L = X.shape
    E = gs.elem_dofs.shape[0]
    Q = w.shape[1]
    pl = gs.plan
    NB, H = pl.halo.shape
    n_ent = pl.ent.shape[0]
    f32, i32 = torch.float32, torch.int32
    _require(X, "X", f32, dev)
    _require_lanes(X, "X", L)
    _require(w, "w", f32, dev, (E, Q))
    _require(N, "N", f32, dev, (Q, 6))
    _require(pl.order, "plan.order", i32, dev, (D,))
    _require(pl.halo, "plan.halo", i32, dev)
    _require(pl.n_halo, "plan.n_halo", i32, dev, (NB,))
    if NB != -(-D // MASS_ROWS):
        raise ValueError(f"plan of {NB} blocks does not cover {D} rows")
    _require(pl.row_ptr, "plan.row_ptr", i32, dev, (NB * MASS_ROWS + 1,))
    _require(pl.ent, "plan.ent", i32, dev)
    _require(pl.loc, "plan.loc", torch.int16, dev, (n_ent, 6))
    _require(mask, "mask", f32, dev, (D,))
    ptr = {"ds": None, "R": None, "Z": None}
    flags, a, b, theta = 0, 0.0, 0.0, 1.0
    if step is not None:
        flags = 1 | (2 if step.first else 0) | (4 if step.last else 0)
        a, b, theta = float(step.a), float(step.b), float(step.theta)
        _require(step.ds, "ds", f32, dev, (D,))
        ptr["ds"] = step.ds.data_ptr()
        if not (step.first and step.last):
            for name in ("R", "Z"):
                t = getattr(step, name)
                if t is None:
                    raise ValueError(f"step mode below degree 1 needs {name}")
                _require(t, name, f32, dev, (D, L))
                _require_lanes(t, name, L)
                ptr[name] = t.data_ptr()
    out = torch.empty((D, L), dtype=f32, device=dev)
    rc = lib().pl_mass_apply(
        X.data_ptr(), w.data_ptr(), N.data_ptr(),
        pl.order.data_ptr(), pl.halo.data_ptr(), pl.n_halo.data_ptr(),
        pl.row_ptr.data_ptr(), pl.ent.data_ptr(), pl.loc.data_ptr(),
        mask.data_ptr(), ptr["ds"], ptr["R"], ptr["Z"], out.data_ptr(),
        float(park), a, b, theta, D, H, int(pl.max_entries), Q, L,
        flags,
        _stream(dev))
    _check(rc, "mass_apply")
    _count(mass_apply)
    return out


mass_apply.launches = 0


# ---------------------------------------------------------------------------
# K12: the B^{-1} semi-iteration's step chain in one launch
# ---------------------------------------------------------------------------

# The widest rows a B^{-1} chain runs K12 on: up to 32 lanes a row is
# summed by one quarter warp (8 threads of 4 lanes), so a block's 32 rows
# take one pass of a CTA. There K12 took 0.45-0.92x the K3 step chain's
# device time on the H100 (22-32 lanes, config-1 and r5 meshes); from 33
# lanes on it took 0.99-1.7x on the r5 mesh and at 33-40 lanes on
# config-1, so wider chains stay K3 steps (PERF.md, section 6).
BINV_LANES = 32


def binv_on_chip(D: int, L: int, n_sm: int, shared: int) -> bool:
    """Where K12 keeps R and Z: in shared memory when those of the rows
    one CTA an SM owns (the mass plan's blocks of MASS_ROWS rows shared
    out over ``n_sm`` SMs) fit in ``shared``, the bytes such a CTA has
    left once its halo staging and one block record are in (what
    :func:`_card_limits` reads from ``pl_binv_chain_limits``); else in
    device memory. Exactly the test by which K12's launcher finds a
    layout with one CTA an SM, so an on-chip launch always finds one. A
    function of the shape and the card alone."""
    blocks = -(-D // MASS_ROWS)
    rows = -(-blocks // n_sm) * MASS_ROWS
    return 2 * 4 * rows * L <= shared


@functools.lru_cache(maxsize=64)
def _card_limits(index: int, H: int, max_ent: int, L: int):
    """(SM count, shared memory left for R and Z) of CUDA device
    ``index`` for a chain of L lanes on a plan of H halo rows and
    ``max_ent`` entries a block."""
    n_sm, shared = ctypes.c_int(), ctypes.c_longlong()
    _check(lib().pl_binv_chain_limits(index, H, max_ent, L,
                                      ctypes.byref(n_sm),
                                      ctypes.byref(shared)), "binv_chain")
    return n_sm.value, shared.value


def mass_step_chain(apply, X, gs, w, N, mask, ds, a_coefs, b_coefs, theta,
                    degree: int):
    """The B^{-1} semi-iteration as ``degree`` step-mode calls of
    ``apply`` (:func:`mass_apply`, one K3 launch a step, or its twin
    :func:`mass_apply_plain`), step i with ``a_coefs[i]`` and
    ``b_coefs[i]`` (see :class:`BinvStep`); R and Z in two buffers of
    X's shape, updated in place (none at degree 1)."""
    R = Z = None
    if degree > 1:
        R = torch.empty_like(X)
        Z = torch.empty_like(X)
    V = X
    for i in range(degree):
        V = apply(V, gs, w, N, mask, step=BinvStep(
            ds, R, Z, a_coefs[i], b_coefs[i], theta, first=i == 0,
            last=i == degree - 1))
    return V


def binv_chain_plain(X, gs, w, N, mask, ds, a_coefs, b_coefs, theta,
                     degree: int):
    """Plain twin of K12: the chain of ``degree`` K3 step twins."""
    return mass_step_chain(mass_apply_plain, X, gs, w, N, mask, ds, a_coefs,
                           b_coefs, theta, degree)


def binv_chain(X, gs, w, N, mask, ds, a_coefs, b_coefs, theta,
               degree: int):
    """K12 (``csrc/binv_chain.cu``): the Chebyshev B^{-1} semi-iteration
    of ``degree`` >= 2 steps in one cooperative launch, equal bit for bit
    to ``degree`` K3 launches in step mode (step i with ``a_coefs[i]``
    and ``b_coefs[i]``; see :class:`BinvStep`).

    X (D, L) f32; ``gs``, w, N and mask as for :func:`mass_apply`; ds
    (D,) the Jacobi scale. R and Z stay in shared memory where
    :func:`binv_on_chip` says they fit (such launches are counted in
    ``binv_chain.on_chip`` too), else in two device buffers. Returns a
    new (D, L) tensor.
    """
    if degree < 2 or len(a_coefs) != degree or len(b_coefs) != degree:
        raise ValueError(f"the chain takes degree >= 2 and one (a, b) a "
                         f"step, got degree {degree}, {len(a_coefs)} a "
                         f"and {len(b_coefs)} b")
    if X.device.type == "cpu":
        return binv_chain_plain(X, gs, w, N, mask, ds, a_coefs, b_coefs,
                                theta, degree)
    dev = X.device
    D, L = X.shape
    E = gs.elem_dofs.shape[0]
    Q = w.shape[1]
    pl = gs.plan
    NB, H = pl.halo.shape
    n_ent = pl.ent.shape[0]
    f32, i32 = torch.float32, torch.int32
    _require(X, "X", f32, dev)
    _require_lanes(X, "X", L)
    _require(w, "w", f32, dev, (E, Q))
    _require(N, "N", f32, dev, (Q, 6))
    _require(pl.order, "plan.order", i32, dev, (D,))
    _require(pl.halo, "plan.halo", i32, dev)
    _require(pl.n_halo, "plan.n_halo", i32, dev, (NB,))
    if NB != -(-D // MASS_ROWS):
        raise ValueError(f"plan of {NB} blocks does not cover {D} rows")
    _require(pl.row_ptr, "plan.row_ptr", i32, dev, (NB * MASS_ROWS + 1,))
    _require(pl.ent, "plan.ent", i32, dev)
    _require(pl.loc, "plan.loc", torch.int16, dev, (n_ent, 6))
    _require(mask, "mask", f32, dev, (D,))
    _require(ds, "ds", f32, dev, (D,))
    on_chip = binv_on_chip(D, L, *_card_limits(dev.index, H,
                                                int(pl.max_entries), L))
    # the kernel's own scratch: U of even and odd steps and Dd, rows of
    # L rounded up to 4 lanes; R and Z where they are not kept on chip
    Lp = -(-L // 4) * 4
    U = torch.empty((3, D, Lp), dtype=f32, device=dev)
    RZ = None if on_chip else torch.empty((2, D, L), dtype=f32, device=dev)
    out = torch.empty((D, L), dtype=f32, device=dev)
    coefs = [(_F * degree)(*map(float, c)) for c in (a_coefs, b_coefs)]
    rc = lib().pl_binv_chain(
        X.data_ptr(), w.data_ptr(), N.data_ptr(),
        pl.order.data_ptr(), pl.halo.data_ptr(), pl.n_halo.data_ptr(),
        pl.row_ptr.data_ptr(), pl.ent.data_ptr(), pl.loc.data_ptr(),
        mask.data_ptr(), ds.data_ptr(), U[0].data_ptr(), U[1].data_ptr(),
        U[2].data_ptr(), out.data_ptr(),
        None if on_chip else RZ[0].data_ptr(),
        None if on_chip else RZ[1].data_ptr(), *coefs, float(theta), D, H,
        int(pl.max_entries), Q, L, degree, int(on_chip), _stream(dev))
    _check(rc, "binv_chain")
    _count(binv_chain)
    if on_chip:
        with _LOCK:
            binv_chain.on_chip += 1
    return out


binv_chain.launches = 0
binv_chain.on_chip = 0


# ---------------------------------------------------------------------------
# K5: the stacked-block apply
# ---------------------------------------------------------------------------

def apply_stacked_elem_plain(X, mask, elem_dofs, Abig, C: int):
    """Element part of K5's twin: gather the masked rows and multiply by
    the element blocks, as pl_fem_tpu/ops/kernels.py ``_apply_stacked``
    does before its accumulate. Returns (C, E, 6, k)."""
    D = mask.shape[0]
    E = elem_dofs.shape[0]
    k = X.shape[1]
    ed = torch.cat([elem_dofs.long() + c * D for c in range(C)], dim=1)
    Xm = X * mask.repeat(C)[:, None]
    Ye = torch.einsum("eij,ejk->eik", Abig, Xm[ed])        # (E, 6C, k)
    return Ye.reshape(E, C, 6, k).permute(1, 0, 2, 3).contiguous()


def apply_stacked_plain(X, gs, Abig, mask, park, C: int):
    """Plain twin of K5: m * sum_e A_e (m X)_e + park * (X - m X) as two
    passes, the element product and K2's twin with its epilogue once per
    component."""
    D = mask.shape[0]
    Ye = apply_stacked_elem_plain(X, mask, gs.elem_dofs, Abig, C)
    parts = [accumulate_plain(Ye[c], gs.idx_v, gs.valid_v, gs.idx_e,
                              gs.valid_e, X[c * D:(c + 1) * D], mask, park)
             for c in range(C)]
    return parts[0] if C == 1 else torch.cat(parts, dim=0)


def apply_stacked(X, gs, Abig, mask, park, C: int):
    """K5 (``csrc/apply_stacked.cu``): the stacked-block apply,
    ``m * sum_e A_e (m X)_e + park * (X - m X)``, one launch.

    X (C * D, k) f32, the stacked component-major block; ``gs`` a
    GatherScatter (the kernel reads the row blocks and element halos of
    ``gs.apply_plan``; the twin the element and transpose tables); Abig
    (E, 6C, 6C) f32; mask (D,) f32, the same for
    every component; park (k,) f32 per column; C is 1 or 3. Returns Y
    (C * D, k).
    """
    if X.device.type == "cpu":
        return apply_stacked_plain(X, gs, Abig, mask, park, C)
    dev = X.device
    D = mask.shape[0]
    E = gs.elem_dofs.shape[0]
    k = X.shape[1]
    f32, i32 = torch.float32, torch.int32
    if C not in (1, 3):
        raise ValueError(f"the stacked apply takes C = 1 or 3, got {C}")
    pl = gs.apply_plan
    NB, HE = pl.elems.shape
    _require(X, "X", f32, dev, (C * D, k))
    _require(Abig, "Abig", f32, dev, (E, 6 * C, 6 * C))
    _require(mask, "mask", f32, dev, (D,))
    _require(park, "park", f32, dev, (k,))
    if NB != -(-D // pl.rows):
        raise ValueError(f"plan of {NB} blocks of {pl.rows} rows does not "
                         f"cover {D} rows")
    _require(pl.order, "plan.order", i32, dev, (D,))
    _require(pl.row_ptr, "plan.row_ptr", i32, dev, (NB * pl.rows + 1,))
    _require(pl.elems, "plan.elems", i32, dev)
    _require(pl.n_elems, "plan.n_elems", i32, dev, (NB,))
    _require(pl.dst, "plan.dst", torch.int16, dev, (NB, HE, 6))
    _require(pl.dofs, "plan.dofs", i32, dev, (NB, HE, 6))
    Y = torch.empty((C * D, k), dtype=f32, device=dev)
    rc = lib().pl_apply_stacked(
        X.data_ptr(), Abig.data_ptr(), mask.data_ptr(), park.data_ptr(),
        pl.order.data_ptr(), pl.row_ptr.data_ptr(), pl.elems.data_ptr(),
        pl.n_elems.data_ptr(), pl.dst.data_ptr(), pl.dofs.data_ptr(), D, k,
        C, pl.rows, HE, int(pl.max_entries), Y.data_ptr(), _stream(dev))
    _check(rc, "apply_stacked")
    _count(apply_stacked)
    return Y


apply_stacked.launches = 0


# ---------------------------------------------------------------------------
# K7: the scalar Helmholtz pencil's element blocks
# ---------------------------------------------------------------------------

def scalar_blocks_plain(grad_phys, qp_w, N, eps_re, k2):
    """Plain twin of K7: the weighted sums of pl_fem_tpu/ops/assembly.py
    ``scalar_blocks`` and A = K - k0^2 Me of ``assemble_scalar_system``.
    Returns (A, B), both (E, 6, 6)."""
    gx = grad_phys[..., 0]
    gy = grad_phys[..., 1]
    Nq = N[None].expand(qp_w.shape + (6,))

    def wsum(coeff, a, b):
        return torch.einsum("eq,eqi,eqj->eij", coeff, a, b)

    K = wsum(qp_w, gx, gx) + wsum(qp_w, gy, gy)
    Me = wsum(qp_w * eps_re, Nq, Nq)
    return K - k2 * Me, wsum(qp_w, Nq, Nq)


def scalar_blocks(grad_phys, qp_w, N, eps_re, k2: float):
    """K7 (``csrc/scalar_blocks.cu``): A = K - k2 Me and B = M.

    grad_phys (E, Q, 6, 2), qp_w (E, Q), N (Q, 6) and eps_re (E, Q), all
    f32; ``k2`` is k0^2. Returns (A, B), both (E, 6, 6) f32.
    """
    if qp_w.device.type == "cpu":
        return scalar_blocks_plain(grad_phys, qp_w, N, eps_re, k2)
    dev = qp_w.device
    E, Q = qp_w.shape
    f32 = torch.float32
    _require(grad_phys, "grad_phys", f32, dev, (E, Q, 6, 2))
    _require(qp_w, "qp_w", f32, dev)
    _require(N, "N", f32, dev, (Q, 6))
    _require(eps_re, "eps_re", f32, dev, (E, Q))
    A = torch.empty((E, 6, 6), dtype=f32, device=dev)
    B = torch.empty((E, 6, 6), dtype=f32, device=dev)
    rc = lib().pl_scalar_blocks(
        grad_phys.data_ptr(), qp_w.data_ptr(), N.data_ptr(),
        eps_re.data_ptr(), float(k2), E, Q, A.data_ptr(), B.data_ptr(),
        _stream(dev))
    _check(rc, "scalar_blocks")
    _count(scalar_blocks)
    return A, B


scalar_blocks.launches = 0


# ---------------------------------------------------------------------------
# K8: the pencil's spectrum bound
# ---------------------------------------------------------------------------

def pencil_bounds_plain(Abig, Bblk, elem_valid, Linv, trace_ref: float,
                        C: int):
    """Plain twin of K8: 1.02 x the largest Gershgorin row sum of
    Linv (A_e / |detJ|_e) Linv^T over the valid elements (the body of
    pl_fem_tpu/ops/kernels.py ``pencil_bounds_elem``). 0-d tensor."""
    dtype = Abig.dtype
    detj = torch.diagonal(Bblk, dim1=1, dim2=2).sum(-1) / trace_ref
    tiny = float(torch.finfo(dtype).tiny) * 1e3
    detj = torch.where(elem_valid, torch.clamp(detj, min=tiny),
                       torch.ones_like(detj))
    Linv3 = torch.block_diag(*([Linv.to(dtype)] * C))
    W = torch.einsum("ij,ejk,lk->eil", Linv3, Abig / detj[:, None, None],
                     Linv3)
    rows = W.abs().sum(dim=2).amax(dim=1)                  # (E,) Gershgorin
    return torch.where(elem_valid, rows, torch.zeros_like(rows)).max() * 1.02


def pencil_bounds(Abig, Bblk, elem_valid, Linv, trace_ref: float, C: int):
    """K8 (``csrc/pencil_bounds.cu``): the spectrum bound of (A, B).

    Abig (E, 6C, 6C) and Bblk (E, 6, 6) f32, elem_valid (E,) bool, Linv
    (6, 6) f32 the inverse Cholesky factor of the reference mass,
    ``trace_ref`` that mass's trace; C is 1 or 3. Returns a 0-d f32
    tensor on the device of ``Abig``. Two launches (rows, then the
    maximum over the blocks' partials) count as one.
    """
    if Abig.device.type == "cpu":
        return pencil_bounds_plain(Abig, Bblk, elem_valid, Linv, trace_ref, C)
    dev = Abig.device
    E = Abig.shape[0]
    f32 = torch.float32
    if C not in (1, 3):
        raise ValueError(f"the pencil bound takes C = 1 or 3, got {C}")
    _require(Abig, "Abig", f32, dev, (E, 6 * C, 6 * C))
    _require(Bblk, "Bblk", f32, dev, (E, 6, 6))
    _require(elem_valid, "elem_valid", torch.bool, dev, (E,))
    _require(Linv, "Linv", f32, dev, (6, 6))
    L = lib()
    partial = torch.empty((L.pl_pencil_bounds_blocks(E, C),), dtype=f32,
                          device=dev)
    out = torch.empty((), dtype=f32, device=dev)
    rc = L.pl_pencil_bounds(
        Abig.data_ptr(), Bblk.data_ptr(), elem_valid.data_ptr(),
        Linv.data_ptr(), float(trace_ref),
        _TINY_F32, E, C, partial.data_ptr(),
        out.data_ptr(), _stream(dev))
    _check(rc, "pencil_bounds")
    _count(pencil_bounds)
    return out


pencil_bounds.launches = 0


def pencil_bounds_vector3(gp, w, N, inv_eps, betas, alpha: float,
                          elem_valid, Linv, trace_ref: float):
    """K8 for the vectorial sweep (``csrc/pencil_bounds.cu``): the
    spectrum bound of A(beta_b) for every design b from the quadrature
    data, without the primitives or the (E, 18, 18) stack.

    gp (E, Q, 6, 2), w (E, Q), N (Q, 6), inv_eps (B, E, Q) and betas
    (B,), all f32; elem_valid (E,) bool; Linv (6, 6) f32 the inverse
    Cholesky factor of the reference mass, ``trace_ref`` its trace.
    Returns (B,) f32 on the device of ``w``. Two launches (the rows of
    every design, then each design's maximum over the blocks' partials)
    count as one. CUDA tensors only: its twin,
    ``kernels.pencil_bounds_vector3_plain``, composes the assembly's
    primitives and stack, and ``kernels.pencil_bounds_sweep`` takes it on
    the CPU.
    """
    dev = w.device
    if dev.type != "cuda":
        raise ValueError("pencil_bounds_vector3 takes CUDA tensors, got "
                         f"{dev}")
    E, Q = w.shape
    B = inv_eps.shape[0]
    f32 = torch.float32
    _require(gp, "gp", f32, dev, (E, Q, 6, 2))
    _require(w, "w", f32, dev, (E, Q))
    _require(N, "N", f32, dev, (Q, 6))
    _require(inv_eps, "inv_eps", f32, dev, (B, E, Q))
    _require(betas, "betas", f32, dev, (B,))
    _require(elem_valid, "elem_valid", torch.bool, dev, (E,))
    _require(Linv, "Linv", f32, dev, (6, 6))
    L = lib()
    nb = L.pl_pencil_bounds_vector3_blocks(E)
    partial = torch.empty((B, nb), dtype=f32, device=dev)
    out = torch.empty((B,), dtype=f32, device=dev)
    rc = L.pl_pencil_bounds_vector3(
        gp.data_ptr(), w.data_ptr(), N.data_ptr(), inv_eps.data_ptr(),
        betas.data_ptr(), float(alpha), elem_valid.data_ptr(),
        Linv.data_ptr(), float(trace_ref),
        _TINY_F32, E, Q, B, partial.data_ptr(),
        out.data_ptr(), _stream(dev))
    _check(rc, "pencil_bounds_vector3")
    _count(pencil_bounds_vector3)
    return out


pencil_bounds_vector3.launches = 0


# ---------------------------------------------------------------------------
# K9: the vectorial sweep's bootstrap seed
# ---------------------------------------------------------------------------

def seed_prolong(Hc, colmask, cols, wts, R1, R2, scale: float):
    """K9 (``csrc/seed_prolong.cu``): the two-grid bootstrap seed in the
    filter's fused layout. With F = P Hc prolonged through the gather
    tables, ``X = F / |F| m + R1 / |R1| (1 - m) + scale R2``, then
    normalized; every norm per (design, column) over all 3 Dp rows.

    Hc (B, 3, nc, k) f32 coarse Ritz vectors; colmask (B, k) f32; cols
    (Dp, W) int32 and wts (Dp, W) f32 the prolongation's padded rows; R1,
    R2 (Dp, B, 3, k) f32 standard-normal blocks. Returns X (Dp, B, 3, k).
    Where colmask is exactly 1 the kernel does not read R1, where it is
    exactly 0 it does not gather F (their coefficients are 0). Three
    launches (the column sums, their coefficients, the blend) count as
    one. CUDA tensors only: its twin is ``kernels.seed_prolong_plain``,
    and ``solvers/vectorial._seed_from_coarse`` takes it on the CPU.
    """
    dev = Hc.device
    if dev.type != "cuda":
        raise ValueError(f"seed_prolong takes CUDA tensors, got {dev}")
    B, C, nc, k = Hc.shape
    Dp, W = cols.shape
    f32 = torch.float32
    if C != 3:
        raise ValueError(f"Hc holds {C} components, expected 3")
    if not 1 <= k <= 128:
        raise ValueError(f"seed_prolong takes 1 to 128 columns, got {k}")
    if not 1 <= W <= 8:
        raise ValueError(f"seed_prolong takes 1 to 8 entries a row, got {W}")
    _require(Hc, "Hc", f32, dev)
    _require(colmask, "colmask", f32, dev, (B, k))
    _require(cols, "cols", torch.int32, dev, (Dp, W))
    _require(wts, "wts", f32, dev, (Dp, W))
    _require(R1, "R1", f32, dev, (Dp, B, 3, k))
    _require(R2, "R2", f32, dev, (Dp, B, 3, k))
    for t, name in ((R1, "R1"), (R2, "R2")):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
    L = lib()
    partial = torch.empty((L.pl_seed_prolong_blocks(Dp, B, k), 6, B * k),
                          dtype=torch.float64, device=dev)
    coef = torch.empty((3, B * k), dtype=f32, device=dev)
    X = torch.empty((Dp, B, 3, k), dtype=f32, device=dev)
    rc = L.pl_seed_prolong(
        Hc.data_ptr(), colmask.data_ptr(), cols.data_ptr(), wts.data_ptr(),
        R1.data_ptr(), R2.data_ptr(), float(scale), Dp, B, nc, k, W,
        partial.data_ptr(), coef.data_ptr(), X.data_ptr(), _stream(dev))
    _check(rc, "seed_prolong")
    _count(seed_prolong)
    return X


seed_prolong.launches = 0


# ---------------------------------------------------------------------------
# K10: the Rayleigh-Ritz residual norms and the pass gate
# ---------------------------------------------------------------------------

def ritz_residual(AQ, BQ, Ys, theta, cuts, n_wanted: int = 0):
    """K10 (``csrc/ritz_residual.cu``): the Rayleigh-Ritz residuals
    ``res[b, l] = ||(AQ_b - theta_bl BQ_b) Ys_b[:, l]|| /
    (||AQ_b Ys_b[:, l]|| + 1e-30)`` over all rows of design b, without
    forming AQ Ys, BQ Ys or the residual block, and the pass gate: the
    largest res among the wanted columns (theta_bl < cuts_b, and l <
    n_wanted when n_wanted > 0), or the smallest res if none is wanted.

    AQ, BQ (D, B, C, k) f32 in the fused layout (C = 1 for the stacked
    solver's (C D, k) block viewed as (C D, 1, 1, k)); Ys (B, k, k);
    theta (B, k); cuts (B,). AQ and BQ start on 16 bytes (the kernel
    streams them in 16-byte copies). Returns res (B, k) and the gate, a
    0-d tensor. Two launches (the rows, then the partials and the gate)
    count as one. CUDA tensors only: its twin is
    ``kernels.ritz_residual_plain``, and ``kernels.ritz_residual_gate``
    takes it on the CPU.
    """
    dev = AQ.device
    if dev.type != "cuda":
        raise ValueError(f"ritz_residual takes CUDA tensors, got {dev}")
    if AQ.dim() != 4:
        raise ValueError(f"AQ must be (D, B, C, k), got {tuple(AQ.shape)}")
    D, B, C, k = AQ.shape
    f32 = torch.float32
    if not 1 <= k <= 96:
        raise ValueError(f"ritz_residual takes 1 to 96 columns, got {k}")
    if C not in (1, 3):
        raise ValueError(f"ritz_residual takes C = 1 or 3, got {C}")
    _require(AQ, "AQ", f32, dev)
    _require(BQ, "BQ", f32, dev, (D, B, C, k))
    _require(Ys, "Ys", f32, dev, (B, k, k))
    _require(theta, "theta", f32, dev, (B, k))
    _require(cuts, "cuts", f32, dev, (B,))
    for t, name in ((AQ, "AQ"), (BQ, "BQ")):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
    L = lib()
    nP = L.pl_ritz_residual_blocks(D, B, C, k)
    if nP < 1:
        raise ValueError(f"ritz_residual takes no block of shape "
                         f"{(D, B, C, k)}")
    partial = torch.empty((B, nP, 2, k), dtype=torch.float64, device=dev)
    res = torch.empty((B, k), dtype=f32, device=dev)
    gate = torch.empty((), dtype=f32, device=dev)
    rc = L.pl_ritz_residual(
        AQ.data_ptr(), BQ.data_ptr(), Ys.data_ptr(), theta.data_ptr(),
        cuts.data_ptr(), D, B, C, k, int(n_wanted), partial.data_ptr(),
        res.data_ptr(), gate.data_ptr(), _stream(dev))
    _check(rc, "ritz_residual")
    _count(ritz_residual)
    return res, gate


ritz_residual.launches = 0


# ---------------------------------------------------------------------------
# K11: the scalar pencil's set-up (permittivity, blocks, bound) in one launch
# ---------------------------------------------------------------------------

def scalar_pencil_plain(grad_phys, qp_w, qp_xy, N, eps, k2, elem_valid,
                        Linv, trace_ref: float, return_eps: bool = False):
    """Plain twin of K11: K6's twin for eps_re, K7's for the blocks, B's
    diagonal and K8's at C = 1 for the bound, composed as the scalar
    path composed the three kernels. Returns (A, B, diag, bound), with
    eps_re (E, Q) last when ``return_eps``."""
    eps_re, _ = eps_at_quadrature_plain(qp_xy, eps)
    A, B = scalar_blocks_plain(grad_phys, qp_w, N, eps_re, k2)
    diag = torch.diagonal(B, dim1=1, dim2=2).contiguous()
    bound = pencil_bounds_plain(A, B, elem_valid, Linv, trace_ref, 1)
    return (A, B, diag, bound) + ((eps_re,) if return_eps else ())


def scalar_pencil(grad_phys, qp_w, qp_xy, N, eps, k2: float, elem_valid,
                  Linv, trace_ref: float, return_eps: bool = False):
    """K11 (``csrc/scalar_pencil.cu``): the scalar pencil's element
    blocks A = K - k2 Me and B = M, B's diagonal terms and the spectrum
    bound of (A, B) in one launch, from the quadrature data and the
    permittivity model (K6's core test on eps_re; the PML's imaginary
    part is not formed).

    grad_phys (E, Q, 6, 2), qp_w (E, Q), qp_xy (E, Q, 2) and N (Q, 6),
    all f32; ``eps`` an EpsArrays of f32 tensors on the same device (the
    kernel reads positions, core_radii, eps_core and eps_clad); ``k2``
    is k0^2; elem_valid (E,) bool; Linv (6, 6) f32 the inverse Cholesky
    factor of the reference mass, ``trace_ref`` its trace. Returns A, B
    (E, 6, 6), diag (E, 6) and the bound (0-d), views of one buffer,
    with eps_re (E, Q) last when ``return_eps`` (the tests'). grad_phys
    starts on 16 bytes, qp_xy and the core positions on 8; Q <= 8. One
    call is a 4-byte memset and one kernel.
    """
    if qp_w.device.type == "cpu":
        return scalar_pencil_plain(grad_phys, qp_w, qp_xy, N, eps, k2,
                                   elem_valid, Linv, trace_ref, return_eps)
    dev = qp_w.device
    E, Q = qp_w.shape
    n = eps.positions.shape[0]
    f32 = torch.float32
    for t, name, shape in (
            (grad_phys, "grad_phys", (E, Q, 6, 2)), (qp_w, "qp_w", (E, Q)),
            (qp_xy, "qp_xy", (E, Q, 2)), (N, "N", (Q, 6)),
            (eps.positions, "positions", (n, 2)),
            (eps.core_radii, "core_radii", (n,)),
            (eps.eps_core, "eps_core", ()), (eps.eps_clad, "eps_clad", ()),
            (Linv, "Linv", (6, 6))):
        _require(t, name, f32, dev, shape)
    _require(elem_valid, "elem_valid", torch.bool, dev, (E,))
    if grad_phys.data_ptr() % 16 or qp_xy.data_ptr() % 8 \
            or eps.positions.data_ptr() % 8:
        raise ValueError("grad_phys must start on 16 bytes, qp_xy and "
                         "positions on 8 (the kernel loads them as float4 "
                         "and float2)")
    # one allocation for the four outputs: the wrapper's host time is
    # most of a call at the scalar path's sizes
    buf = torch.empty((78 * E + 1,), dtype=f32, device=dev)
    p = buf.data_ptr()
    eps_re = (torch.empty((E, Q), dtype=f32, device=dev) if return_eps
              else None)
    rc = lib().pl_scalar_pencil(
        grad_phys.data_ptr(), qp_w.data_ptr(), qp_xy.data_ptr(),
        N.data_ptr(), eps.positions.data_ptr(), eps.core_radii.data_ptr(),
        eps.eps_core.data_ptr(), eps.eps_clad.data_ptr(), float(k2),
        elem_valid.data_ptr(), Linv.data_ptr(), float(trace_ref), _TINY_F32,
        E, Q, n, p, p + 144 * E, p + 288 * E,
        None if eps_re is None else eps_re.data_ptr(), p + 312 * E,
        _stream(dev))
    _check(rc, "scalar_pencil")
    _count(scalar_pencil)
    out = (buf.as_strided((E, 6, 6), (36, 6, 1), 0),
           buf.as_strided((E, 6, 6), (36, 6, 1), 36 * E),
           buf.as_strided((E, 6), (6, 1), 72 * E),
           buf.as_strided((), (), 78 * E))
    return out + ((eps_re,) if return_eps else ())


scalar_pencil.launches = 0
