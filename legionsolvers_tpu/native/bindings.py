"""ctypes bindings for the native host kernels (csrc/kernels.cpp).

Builds ``libls_native.so`` on first import with g++ (O3, -march=native,
OpenMP) and caches it beside the sources; if the compiler or load fails,
``available()`` returns False and callers fall back to numpy.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "csrc", "kernels.cpp")
_LIB = os.path.join(_HERE, "csrc", "libls_native.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False

_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")


def _build() -> Optional[ctypes.CDLL]:
    if not os.path.exists(_LIB) or os.path.getmtime(_LIB) < os.path.getmtime(_SRC):
        cmd = [
            "g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-fopenmp",
            "-march=native", _SRC, "-o", _LIB,
        ]
        subprocess.run(cmd, check=True, capture_output=True)
    lib = ctypes.CDLL(_LIB)
    lib.stencil_size.restype = ctypes.c_int64
    lib.stencil_size.argtypes = [_i64p, ctypes.c_int64, _i64p, ctypes.c_int64]
    lib.stencil_fill_coo.restype = ctypes.c_int64
    lib.stencil_fill_coo.argtypes = [
        _i64p, ctypes.c_int64, _i64p, _f64p, ctypes.c_int64,
        _i64p, _i64p, _f64p,
    ]
    lib.build_indptr.restype = None
    lib.build_indptr.argtypes = [_i64p, ctypes.c_int64, ctypes.c_int64, _i64p]
    lib.pack_ell_shard.restype = None
    lib.pack_ell_shard.argtypes = [
        ctypes.c_int64, _i64p, _i64p, _f64p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        _i64p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        _i32p, _f64p,
    ]
    lib.shard_halo_columns.restype = ctypes.c_int64
    lib.shard_halo_columns.argtypes = [
        ctypes.c_int64, _i64p, ctypes.c_int64, ctypes.c_int64, _i64p,
    ]
    lib.dia_unique_offsets.restype = ctypes.c_int64
    lib.dia_unique_offsets.argtypes = [
        ctypes.c_int64, _i64p, _i64p, ctypes.c_int64, _i64p,
    ]
    lib.dia_accumulate_f32.restype = None
    lib.dia_accumulate_f32.argtypes = [
        ctypes.c_int64, _i64p, _i64p, _f64p, ctypes.c_int64, _i64p,
        ctypes.c_int64, _f32p,
    ]
    lib.dia_accumulate_f64.restype = None
    lib.dia_accumulate_f64.argtypes = [
        ctypes.c_int64, _i64p, _i64p, _f64p, ctypes.c_int64, _i64p,
        ctypes.c_int64, _f64p,
    ]
    lib.rcm_permutation.restype = None
    lib.rcm_permutation.argtypes = [
        ctypes.c_int64, ctypes.c_int64, _i64p, _i64p, _i64p,
    ]
    return lib


def _get() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is None and not _tried:
            _tried = True
            if os.environ.get("LEGIONSOLVERS_NO_NATIVE"):
                return None
            try:
                _lib = _build()
            except Exception:
                _lib = None
    return _lib


def available() -> bool:
    return _get() is not None


# -- entry points (native with numpy fallback) ------------------------------

def stencil_size(shape, offsets) -> int:
    shape = np.ascontiguousarray(shape, np.int64)
    offs = np.ascontiguousarray(offsets, np.int64)
    lib = _get()
    if lib is not None:
        return int(lib.stencil_size(shape, len(shape), offs, offs.shape[0]))
    cnt = np.maximum(shape[None, :] - np.abs(offs), 0)
    return int(np.prod(cnt, axis=1).sum())


def stencil_fill_coo(shape, offsets, values):
    """Generate (rows, cols, vals) for the stencil, grid-point-major order."""
    shape = np.ascontiguousarray(shape, np.int64)
    offs = np.ascontiguousarray(offsets, np.int64)
    vals_in = np.ascontiguousarray(values, np.float64)
    nnz = stencil_size(shape, offs)
    lib = _get()
    if lib is None:
        return None  # caller uses its numpy generator
    rows = np.empty(nnz, np.int64)
    cols = np.empty(nnz, np.int64)
    vals = np.empty(nnz, np.float64)
    written = lib.stencil_fill_coo(
        shape, len(shape), offs, vals_in, offs.shape[0], rows, cols, vals
    )
    assert written == nnz, (written, nnz)
    return rows, cols, vals


def build_indptr(rows, n_rows):
    rows = np.ascontiguousarray(rows, np.int64)
    lib = _get()
    indptr = np.empty(n_rows + 1, np.int64)
    if lib is not None:
        lib.build_indptr(rows, len(rows), n_rows, indptr)
        return indptr
    indptr[:] = 0
    np.add.at(indptr, rows + 1, 1)
    return np.cumsum(indptr)


def shard_halo_columns(cols_global, d0, B_d):
    cols_global = np.ascontiguousarray(cols_global, np.int64)
    lib = _get()
    if lib is not None:
        out = np.empty(max(len(cols_global), 1), np.int64)
        m = lib.shard_halo_columns(len(cols_global), cols_global, d0, B_d, out)
        return out[:m].copy()
    c = cols_global
    return np.unique(c[(c < d0) | (c >= d0 + B_d)])


_DIA_CHUNK = 1 << 24  # nnz per host pass: bounds temp memory to ~0.5 GB


def dia_unique_offsets(rows, cols, max_diags):
    """Sorted distinct diagonal offsets (col - row), or None when the matrix
    has more than ``max_diags`` of them.  O(nnz) native scan with a chunked
    numpy fallback; never materializes an O(nnz) temporary beyond one chunk."""
    rows = np.ascontiguousarray(rows, np.int64)
    cols = np.ascontiguousarray(cols, np.int64)
    lib = _get()
    if lib is not None:
        out = np.empty(max(max_diags, 1), np.int64)
        m = lib.dia_unique_offsets(len(rows), rows, cols, max_diags, out)
        return None if m < 0 else out[:m].copy()
    u = np.empty(0, np.int64)
    for s in range(0, len(rows), _DIA_CHUNK):
        d = cols[s : s + _DIA_CHUNK] - rows[s : s + _DIA_CHUNK]
        u = np.union1d(u, d)
        if len(u) > max_diags:
            return None
    return u


def dia_accumulate(rows, cols, vals, uoffs, padded, dtype):
    """coef[D, padded] in the TARGET dtype with duplicate entries summed
    (COO semantics).  Native O(nnz) loop (f32/f64 targets) or chunked
    searchsorted + np.add.at fallback; host memory is bounded by the output
    plus one chunk of temporaries (the round-2 path scattered float64 over
    the full padded size — ~25 GB at the reference's 1-node scale)."""
    rows = np.ascontiguousarray(rows, np.int64)
    cols = np.ascontiguousarray(cols, np.int64)
    uoffs = np.ascontiguousarray(uoffs, np.int64)
    dtype = np.dtype(dtype)
    coef = np.zeros((len(uoffs), padded), dtype)
    lib = _get()
    if lib is not None and dtype in (np.float32, np.float64):
        fn = (lib.dia_accumulate_f32 if dtype == np.float32
              else lib.dia_accumulate_f64)
        cf = coef.reshape(-1)
        for s in range(0, len(rows), _DIA_CHUNK):
            e = min(s + _DIA_CHUNK, len(rows))
            vc = np.ascontiguousarray(vals[s:e], np.float64)
            # 1-D slices of contiguous arrays stay contiguous; all chunks
            # accumulate into the same coef buffer
            fn(e - s, rows[s:e], cols[s:e], vc, len(uoffs), uoffs, padded, cf)
        return coef
    flat = coef.reshape(-1)
    for s in range(0, len(rows), _DIA_CHUNK):
        e = min(s + _DIA_CHUNK, len(rows))
        d = cols[s:e] - rows[s:e]
        idx = np.searchsorted(uoffs, d)
        np.add.at(flat, idx * padded + rows[s:e],
                  np.asarray(vals[s:e], dtype))
    return coef


def rcm_permutation(n, rows, cols):
    """Reverse Cuthill-McKee ordering of the symmetrized pattern:
    perm[i] = original index placed at position i, so A[perm][:, perm] is
    banded (the scipy reverse_cuthill_mckee convention).  Native BFS with
    George-Liu pseudo-peripheral starts; scipy.sparse.csgraph fallback.

    The planner uses it to reorder general sparse systems into banded form
    and solve in the permuted basis (parallel/reorder.py)."""
    rows = np.ascontiguousarray(rows, np.int64)
    cols = np.ascontiguousarray(cols, np.int64)
    lib = _get()
    if lib is not None:
        perm = np.empty(n, np.int64)
        lib.rcm_permutation(n, len(rows), rows, cols, perm)
        return perm
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    a = coo_matrix(
        (np.ones(len(rows), np.float32), (rows, cols)), shape=(n, n)
    ).tocsr()
    return np.asarray(
        reverse_cuthill_mckee(a + a.T, symmetric_mode=True), np.int64
    )


def pack_ell_shard(
    rows_local, cols_global, vals, B_r, B_d, d0, halo_global, L, dump
):
    """ELL-pack one shard's kernel slice; returns (ell_cols i32 [B_r, L],
    ell_vals f64 [B_r, L])."""
    rows_local = np.ascontiguousarray(rows_local, np.int64)
    cols_global = np.ascontiguousarray(cols_global, np.int64)
    vals = np.ascontiguousarray(vals, np.float64)
    halo_global = np.ascontiguousarray(halo_global, np.int64)
    lib = _get()
    if lib is not None:
        ell_cols = np.empty(B_r * L, np.int32)
        ell_vals = np.empty(B_r * L, np.float64)
        lib.pack_ell_shard(
            len(rows_local), rows_local, cols_global, vals,
            B_r, B_d, d0, halo_global, len(halo_global), L, dump,
            ell_cols, ell_vals,
        )
        return ell_cols.reshape(B_r, L), ell_vals.reshape(B_r, L)
    return None  # caller uses its numpy packer
