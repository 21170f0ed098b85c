"""Global (single-shard / GSPMD) sparse matrix-vector products.

JAX analog of the reference's leaf SpMV tasks
(reference: COOMatrixTasks.cpp:10-75, CSRMatrixTasks.cpp:10-92 CPU;
COOMatrixTasks.cu:12-146, CSRMatrixTasks.cu:14-156 cuSPARSE).  The reference
accumulates into the output through a sum-reduction accessor; the jnp analog
is ``.at[...].add`` scatter-add, which XLA lowers to an efficient sorted
segment reduction.

These are the correctness-reference paths and the building blocks for the
per-shard local SpMV used by the distributed operator; the performance paths
are the per-shard ELL layout in ``parallel/distmatrix.py`` and the
matrix-free Pallas stencil kernels (``ops/pallas/stencil2d.py``,
``ops/pallas/stencil3d.py``).
"""

from __future__ import annotations

import jax.numpy as jnp


def spmv_coo(
    rows: jnp.ndarray,
    cols: jnp.ndarray,
    vals: jnp.ndarray,
    x: jnp.ndarray,
    n_range: int,
) -> jnp.ndarray:
    """y = A @ x for COO (rows, cols, vals).

    Equivalent of ``COOMatvecTask`` (reference: COOMatrixTasks.cpp:67-74:
    ``out[row[k]] <<= entry[k] * in[col[k]]``).  Padding protocol: padded
    nonzeros must carry ``vals == 0`` (their row/col may be any in-bounds
    slot), matching the reference's domain-containment guards.
    """
    contrib = vals * x[cols]
    return jnp.zeros(n_range, dtype=x.dtype).at[rows].add(contrib)


def spmv_coo_add(rows, cols, vals, x, y):
    """y += A @ x — accumulate form used by the planner's multi-operator
    matvec (reference: SquarePlanner.hpp:340-357 zero-fills then reduces each
    operator's contribution)."""
    return y.at[rows].add(vals * x[cols])


def rmatvec_coo(rows, cols, vals, x, n_domain: int) -> jnp.ndarray:
    """y = A^T @ x for COO.  The reference stubs this out
    (COOMatrixTasks.cpp:78-83 is ``assert(false)``); the transpose product
    is just the row/col swap, so we provide it for real."""
    return jnp.zeros(n_domain, dtype=x.dtype).at[cols].add(vals * x[rows])


def spmv_ell(
    ell_cols: jnp.ndarray,
    ell_vals: jnp.ndarray,
    x: jnp.ndarray,
) -> jnp.ndarray:
    """y = A @ x for ELL layout: ``ell_cols``/``ell_vals`` are [n_rows, L]
    with padded slots carrying ``vals == 0`` and any in-bounds column.

    A dense gather plus a row reduction, no scatter.  The distributed operator stores its per-shard
    local slices in this layout.
    """
    gathered = x[ell_cols]  # [n_rows, L] gather
    return jnp.sum(ell_vals * gathered, axis=1)


def spmv_dia(
    offsets,
    diags: jnp.ndarray,
    x: jnp.ndarray,
) -> jnp.ndarray:
    """y = A @ x for DIA (diagonal) storage: ``offsets`` is a static python
    sequence of diagonal offsets, ``diags`` is [n_diags, n] where
    ``diags[k, i]`` is A[i, i + offsets[k]] (zero where out of range).

    Stencil matrices are exactly banded, so this turns the irregular SpMV
    gather into shifted elementwise multiply-adds at streaming speed.  The
    shifts are static rolls, which XLA fuses.
    """
    n = x.shape[0]
    y = jnp.zeros_like(x)
    for k, off in enumerate(offsets):
        # y[i] += diags[k, i] * x[i + off], for i s.t. 0 <= i + off < n.
        if off == 0:
            y = y + diags[k] * x
        elif off > 0:
            contrib = diags[k, : n - off] * x[off:]
            y = y.at[: n - off].add(contrib)
        else:
            contrib = diags[k, -off:] * x[: n + off]
            y = y.at[-off:].add(contrib)
    return y
