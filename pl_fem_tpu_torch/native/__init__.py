"""Native host-runtime kernels (C++ via ctypes, numpy fallback).

``lib()`` returns the loaded shared library or None; callers fall back
to the numpy implementation when the extension has not been built.
Build with ``python -m pl_fem_tpu_torch.native.build`` (g++, no pybind11).
"""
from __future__ import annotations

import ctypes
import logging
from pathlib import Path
from typing import Optional

import numpy as np

logger = logging.getLogger("pl_fem_tpu_torch.native")

_SO_PATH = Path(__file__).resolve().parents[1] / "_build" / "_native.so"
_LIB = None
_TRIED = False


def lib() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    if not _SO_PATH.exists():
        from .build import build

        try:
            build()
        except Exception as e:     # toolchain absent: numpy fallback
            logger.info("native build unavailable (%s); using numpy", e)
            return None
    try:
        L = ctypes.CDLL(str(_SO_PATH))
        L.pl_build_pattern.restype = ctypes.c_int64
        L.pl_build_pattern.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p]
        L.pl_scatter_slots.restype = None
        L.pl_scatter_slots.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int64]
        _LIB = L
    except OSError as e:
        logger.warning("failed to load %s: %s", _SO_PATH, e)
    return _LIB


def build_pattern_native(rows: np.ndarray, cols: np.ndarray, n: int):
    """(perm, indices, indptr) via the C++ kernel, or None if unavailable."""
    L = lib()
    if L is None:
        return None
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    cols = np.ascontiguousarray(cols, dtype=np.int64)
    nnz = len(rows)
    perm = np.empty(nnz, dtype=np.int64)
    indices = np.empty(nnz, dtype=np.int32)
    indptr = np.empty(n + 1, dtype=np.int64)
    n_uniq = L.pl_build_pattern(
        rows.ctypes.data, cols.ctypes.data, nnz, n,
        perm.ctypes.data, indices.ctypes.data, indptr.ctypes.data)
    if n_uniq < 0:
        return None
    return perm, indices[:n_uniq].copy(), indptr


def scatter_slots_native(perm: np.ndarray, values: np.ndarray,
                         nnz_out: int):
    """data[perm[i]] += values[i] via the C++ kernel, or None."""
    L = lib()
    if L is None:
        return None
    perm = np.ascontiguousarray(perm, dtype=np.int64)
    values = np.ascontiguousarray(values, dtype=np.float64)
    out = np.empty(nnz_out, dtype=np.float64)
    L.pl_scatter_slots(perm.ctypes.data, values.ctypes.data, len(perm),
                       out.ctypes.data, nnz_out)
    return out
