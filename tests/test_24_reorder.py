"""Reordered-basis solves (RCM) + windowed-ELL operator.

Explicit matrices that fail the DIA gate take build-time RCM + solving in
the permuted basis (parallel/reorder.py) with the windowed-ELL layout for
scattered-in-band sparsity (parallel/winell_op.py); the reference runs all
sparsity through cuSPARSE (reference: CSRMatrixTasks.cu:14-156).  These
tests pin:

* windowed-ELL matvec/rmatvec against a scipy oracle;
* Krylov invariance: the reordered solve's residual history and solution
  match the unpermuted solve;
* eager step() outside the basis stays correct (per-call permutation);
* the env kill switch routes back to the ELL fallback.
"""

import os

import numpy as np
import pytest
import jax.numpy as jnp
import scipy.sparse as sp

from legionsolvers_tpu import (
    BlockPartition,
    CGSolver,
    PartitionedVector,
    SolverOptions,
    SquarePlanner,
)
from legionsolvers_tpu.core.matrix import COOMatrix
from legionsolvers_tpu.parallel.reorder import (
    ReorderedOperator,
    try_reordered_operator,
)
from legionsolvers_tpu.parallel.winell_op import WinEllOperator, plan_winell


def _random_banded(n, bw, avg, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n, n * avg)
    cols = rows + rng.integers(-bw, bw + 1, n * avg)
    keep = (cols >= 0) & (cols < n)
    rows, cols = rows[keep], cols[keep]
    vals = rng.uniform(-1.0, 1.0, len(rows)) * scale
    return rows, cols, vals


def _spd_banded_coo(n, bw, avg, seed, options):
    """SPD: A = B + B^T + diag(shift) with shift > ||B + B^T||_inf."""
    rows, cols, vals = _random_banded(n, bw, avg, seed)
    r = np.concatenate([rows, cols, np.arange(n)])
    c = np.concatenate([cols, rows, np.arange(n)])
    v = np.concatenate([vals, vals, np.full(n, 4.0 * avg)])
    return COOMatrix(r, c, v, n, n, options=options)


@pytest.fixture
def f64():
    return SolverOptions(entry_dtype=jnp.float64)


def test_winell_matvec_oracle(f64):
    n = 5000
    rows, cols, vals = _random_banded(n, 700, 7, seed=3)

    class M:
        pass

    m = M()
    m.rows, m.cols, m.vals = rows, cols, vals
    m.n_domain = m.n_range = n
    m.n_kernel = len(rows)
    part = BlockPartition(n, 1)
    op = WinEllOperator(m, part, f64)
    x = np.random.default_rng(0).standard_normal(part.padded_size)
    x[n:] = 0
    A = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    y = np.asarray(op.matvec(jnp.asarray(x)))
    np.testing.assert_allclose(y[:n], A @ x[:n], rtol=1e-12, atol=1e-12)
    z = np.asarray(op.rmatvec(jnp.asarray(x)))
    np.testing.assert_allclose(z[:n], A.T @ x[:n], rtol=1e-12, atol=1e-12)


def test_winell_duplicates_summed(f64):
    # COO semantics: repeated (row, col) accumulate
    n = 2048
    rows = np.array([5, 5, 5, 100, 100])
    cols = np.array([7, 7, 9, 99, 99])
    vals = np.array([1.0, 2.0, 4.0, 8.0, 16.0])

    class M:
        pass

    m = M()
    m.rows, m.cols, m.vals = rows, cols, vals
    m.n_domain = m.n_range = n
    m.n_kernel = 5
    op = WinEllOperator(m, BlockPartition(n, 1), f64)
    x = np.zeros(op.partition.padded_size)
    x[7], x[9], x[99] = 1.0, 1.0, 1.0
    y = np.asarray(op.matvec(jnp.asarray(x)))
    assert y[5] == pytest.approx(7.0)
    assert y[100] == pytest.approx(24.0)


def _solve_system(matrix, n, options, iters=15, no_upgrade=False):
    part = BlockPartition(n, 1)
    pl = SquarePlanner(mesh=None, options=options)
    pl.add_sol_vector(
        PartitionedVector("s", part, options=options).zero_fill()
    )
    pl.add_rhs_vector(
        PartitionedVector("b", part, options=options).constant_fill(1.0)
    )
    if no_upgrade:
        os.environ["LEGIONSOLVERS_NO_RCM"] = "1"
        os.environ["LEGIONSOLVERS_NO_DIA"] = "1"
        try:
            pl.add_row_partitioned_matrix(matrix, 0, 0)
        finally:
            del os.environ["LEGIONSOLVERS_NO_RCM"]
            del os.environ["LEGIONSOLVERS_NO_DIA"]
    else:
        pl.add_row_partitioned_matrix(matrix, 0, 0)
    solver = CGSolver(pl)
    hist = np.asarray(solver.solve(iters))
    x = np.asarray(pl.get_vector(0, 0).data)[:n]
    return pl, hist, x


def test_reordered_cg_matches_plain(f64):
    """Scattered-banded SPD system: the reorder gate must fire (windowed
    ELL), and history + solution must match the un-upgraded ELL solve."""
    n = 4096
    A = _spd_banded_coo(n, bw=160, avg=4, seed=7, options=f64)
    pl, hist, x = _solve_system(A, n, f64)
    op = pl.row_partitioned_matrices[0][0]
    assert isinstance(op, ReorderedOperator), type(op)
    assert isinstance(op.base, WinEllOperator), type(op.base)
    assert pl.basis_perm is not None
    pl2, hist2, x2 = _solve_system(A, n, f64, no_upgrade=True)
    np.testing.assert_allclose(hist, hist2, rtol=1e-9)
    np.testing.assert_allclose(x, x2, rtol=1e-8, atol=1e-12)
    # after solve() the planner is back in the ORIGINAL basis
    assert not pl._in_solver_basis
    b = np.asarray(pl.get_vector(1, 0).data)[:n]
    np.testing.assert_allclose(b, 1.0)


def test_reordered_permuted_laplacian_dia(f64):
    """A randomly permuted 1-D Laplacian: RCM recovers a banded order, the
    permuted matrix passes the DIA gate, and the CG trajectory matches the
    unpermuted golden system's."""
    from legionsolvers_tpu import coo_negative_laplacian_1d
    from legionsolvers_tpu.parallel.dia_op import DiaOperator

    n = 2048
    L = coo_negative_laplacian_1d(n, options=f64)
    rng = np.random.default_rng(11)
    pr = rng.permutation(n)
    P = COOMatrix(
        pr[np.asarray(L.rows)], pr[np.asarray(L.cols)], np.asarray(L.vals),
        n, n, options=f64,
    )
    pl, hist, x = _solve_system(P, n, f64)
    op = pl.row_partitioned_matrices[0][0]
    assert isinstance(op, ReorderedOperator)
    assert isinstance(op.base, DiaOperator)
    plu, histu, xu = _solve_system(L, n, f64)
    np.testing.assert_allclose(hist, histu, rtol=1e-9)
    # x solves the PERMUTED system: unknown pr[i] of it equals unknown i of
    # the original system
    xu_perm = np.empty(n)
    xu_perm[pr] = xu
    np.testing.assert_allclose(x, xu_perm, rtol=1e-8, atol=1e-12)


def test_reordered_eager_step_out_of_basis(f64):
    """step() outside solve() (eager, original basis) must agree with the
    wrapped matvec semantics: one eager step == first solve step."""
    n = 4096
    A = _spd_banded_coo(n, bw=160, avg=4, seed=13, options=f64)
    part = BlockPartition(n, 1)

    def build():
        pl = SquarePlanner(mesh=None, options=f64)
        pl.add_sol_vector(
            PartitionedVector("s", part, options=f64).zero_fill()
        )
        pl.add_rhs_vector(
            PartitionedVector("b", part, options=f64).constant_fill(1.0)
        )
        pl.add_row_partitioned_matrix(A, 0, 0)
        return pl

    pl_eager = build()
    assert isinstance(pl_eager.row_partitioned_matrices[0][0],
                      ReorderedOperator)
    s_eager = CGSolver(pl_eager)
    s_eager.step()
    rr_eager = float(s_eager.residual_norm_squared[-1].value)

    pl_jit = build()
    hist = np.asarray(CGSolver(pl_jit).solve(1))
    assert rr_eager == pytest.approx(float(hist[1]), rel=1e-10)


def test_rcm_kill_switch(f64):
    from legionsolvers_tpu.parallel.distmatrix import RowPartitionedMatrix

    n = 4096
    A = _spd_banded_coo(n, bw=160, avg=4, seed=17, options=f64)
    part = BlockPartition(n, 1)
    pl = SquarePlanner(mesh=None, options=f64)
    pl.add_sol_vector(PartitionedVector("s", part, options=f64).zero_fill())
    pl.add_rhs_vector(
        PartitionedVector("b", part, options=f64).constant_fill(1.0)
    )
    os.environ["LEGIONSOLVERS_NO_RCM"] = "1"
    try:
        pl.add_row_partitioned_matrix(A, 0, 0)
    finally:
        del os.environ["LEGIONSOLVERS_NO_RCM"]
    assert isinstance(pl.row_partitioned_matrices[0][0], RowPartitionedMatrix)


def test_rcm_permutation_reduces_bandwidth():
    from legionsolvers_tpu.native.bindings import rcm_permutation

    nx = 64
    n = nx * nx
    # 2-D 5-pt pattern, scrambled
    Y, X = np.meshgrid(np.arange(nx), np.arange(nx), indexing="ij")
    rows_l, cols_l = [], []
    for dy, dx in [(0, 0), (-1, 0), (1, 0), (0, -1), (0, 1)]:
        m = (Y + dy >= 0) & (Y + dy < nx) & (X + dx >= 0) & (X + dx < nx)
        rows_l.append(Y[m] * nx + X[m])
        cols_l.append((Y[m] + dy) * nx + (X[m] + dx))
    rows = np.concatenate(rows_l)
    cols = np.concatenate(cols_l)
    pr = np.random.default_rng(0).permutation(n)
    prows, pcols = pr[rows], pr[cols]
    perm = rcm_permutation(n, prows, pcols)
    assert sorted(perm) == list(range(n))
    iperm = np.empty(n, np.int64)
    iperm[perm] = np.arange(n)
    bw = np.abs(iperm[prows] - iperm[pcols]).max()
    assert bw <= 2 * nx  # grid RCM bandwidth ~ nx


def test_sharded_winell_matches_gather_ell(mesh4_or_skip=None):
    """The round-4 sharded windowed-ELL fast path (per-shard plans over the
    extended halo buffer, RowPartitionedMatrix._plan_sharded_winell) must
    agree with the XLA-gather ELL fallback on the same system."""
    import jax

    from legionsolvers_tpu.parallel.mesh import make_mesh
    from legionsolvers_tpu.parallel.distmatrix import RowPartitionedMatrix

    F = SolverOptions(entry_dtype=jnp.float64)
    n = 64 * 1024
    rows, cols, vals = _random_banded(n, bw=300, avg=6, seed=23)
    A = COOMatrix(rows, cols, vals, n, n, options=F)
    mesh = make_mesh(4)
    part = BlockPartition(n, 4)

    rpm = RowPartitionedMatrix(A, part, part, mesh=mesh, options=F)
    assert rpm._win is not None, "sharded winell plan should be eligible"
    x = np.random.default_rng(0).standard_normal(part.padded_size)
    x[n:] = 0
    xd = jax.device_put(
        jnp.asarray(x),
        jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("shard")),
    )
    y_win = np.asarray(rpm.matvec(xd))

    os.environ["LEGIONSOLVERS_NO_WINELL"] = "1"
    try:
        rpm2 = RowPartitionedMatrix(A, part, part, mesh=mesh, options=F)
    finally:
        del os.environ["LEGIONSOLVERS_NO_WINELL"]
    assert rpm2._win is None
    y_ell = np.asarray(rpm2.matvec(xd))
    np.testing.assert_allclose(y_win[:n], y_ell[:n], rtol=1e-12, atol=1e-12)

    # and against the dense oracle
    A_sp = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    np.testing.assert_allclose(y_win[:n], A_sp @ x[:n], rtol=1e-11,
                               atol=1e-11)


def test_sharded_winell_cg_solve(f64):
    """End-to-end sharded CG through the windowed-gather path matches the
    gather-ELL fallback's trajectory."""
    import jax

    from legionsolvers_tpu.parallel.mesh import make_mesh
    from legionsolvers_tpu.parallel.distmatrix import RowPartitionedMatrix

    n = 64 * 1024
    rows, cols, vals = _random_banded(n, bw=200, avg=3, seed=29)
    r = np.concatenate([rows, cols, np.arange(n)])
    c = np.concatenate([cols, rows, np.arange(n)])
    v = np.concatenate([vals, vals, np.full(n, 16.0)])
    A = COOMatrix(r, c, v, n, n, options=f64)
    mesh = make_mesh(4)
    part = BlockPartition(n, 4)

    def run(no_win):
        if no_win:
            os.environ["LEGIONSOLVERS_NO_WINELL"] = "1"
        os.environ["LEGIONSOLVERS_NO_DIA"] = "1"
        os.environ["LEGIONSOLVERS_NO_RCM"] = "1"
        try:
            pl_ = SquarePlanner(mesh=mesh, options=f64)
            pl_.add_sol_vector(PartitionedVector(
                "s", part, mesh=mesh, options=f64).zero_fill())
            pl_.add_rhs_vector(PartitionedVector(
                "b", part, mesh=mesh, options=f64).constant_fill(1.0))
            pl_.add_row_partitioned_matrix(A, 0, 0)
        finally:
            os.environ.pop("LEGIONSOLVERS_NO_WINELL", None)
            del os.environ["LEGIONSOLVERS_NO_DIA"]
            del os.environ["LEGIONSOLVERS_NO_RCM"]
        op = pl_.row_partitioned_matrices[0][0]
        assert isinstance(op, RowPartitionedMatrix)
        assert (op._win is None) == no_win
        return np.asarray(CGSolver(pl_).solve(8))

    h_win = run(False)
    h_ell = run(True)
    np.testing.assert_allclose(h_win, h_ell, rtol=1e-9)


def test_sharded_reordered_solve(f64):
    """RCM reordering on a MESH: a scrambled banded system re-bands and
    routes onto the sharded windowed-gather path; the solve matches the
    un-upgraded gather-ELL solve."""
    from legionsolvers_tpu.parallel.mesh import make_mesh
    from legionsolvers_tpu.parallel.distmatrix import RowPartitionedMatrix

    n = 64 * 1024
    rows, cols, vals = _random_banded(n, bw=200, avg=3, seed=31)
    r = np.concatenate([rows, cols, np.arange(n)])
    c = np.concatenate([cols, rows, np.arange(n)])
    v = np.concatenate([vals, vals, np.full(n, 16.0)])
    pr = np.random.default_rng(7).permutation(n)
    A = COOMatrix(pr[r], pr[c], v, n, n, options=f64)  # scrambled
    mesh = make_mesh(4)
    part = BlockPartition(n, 4)

    def build(no_upgrade):
        if no_upgrade:
            os.environ["LEGIONSOLVERS_NO_RCM"] = "1"
            os.environ["LEGIONSOLVERS_NO_DIA"] = "1"
            os.environ["LEGIONSOLVERS_NO_WINELL"] = "1"
        try:
            pl_ = SquarePlanner(mesh=mesh, options=f64)
            pl_.add_sol_vector(PartitionedVector(
                "s", part, mesh=mesh, options=f64).zero_fill())
            pl_.add_rhs_vector(PartitionedVector(
                "b", part, mesh=mesh, options=f64).constant_fill(1.0))
            pl_.add_row_partitioned_matrix(A, 0, 0)
        finally:
            for k in ("LEGIONSOLVERS_NO_RCM", "LEGIONSOLVERS_NO_DIA",
                      "LEGIONSOLVERS_NO_WINELL"):
                os.environ.pop(k, None)
        return pl_

    pl_w = build(False)
    op = pl_w.row_partitioned_matrices[0][0]
    assert isinstance(op, ReorderedOperator), type(op)
    assert isinstance(op.base, RowPartitionedMatrix)
    assert op.base._win is not None
    h_w = np.asarray(CGSolver(pl_w).solve(8))
    x_w = np.asarray(pl_w.get_vector(0, 0).data)[:n]

    pl_e = build(True)
    h_e = np.asarray(CGSolver(pl_e).solve(8))
    x_e = np.asarray(pl_e.get_vector(0, 0).data)[:n]
    np.testing.assert_allclose(h_w, h_e, rtol=1e-9)
    np.testing.assert_allclose(x_w, x_e, rtol=1e-8, atol=1e-12)


def test_sliced_winell_degree_coherent(f64):
    """Sliced-ELL (round 5): per-degree-class plans on a graded band.
    Block-granular classes fire only when row degree is spatially
    coherent (the typical RCM outcome for graded meshes); matvec/rmatvec
    must match scipy and the class L's must descend."""
    import scipy.sparse as sp

    from legionsolvers_tpu.parallel.winell_op import (
        SlicedWinEllOperator,
        plan_winell_classes,
    )

    rng = np.random.default_rng(3)
    n, bw = 32768, 512
    deg = (3 + 24 * (np.arange(n) / n)).astype(np.int64)
    rows = np.repeat(np.arange(n), deg)
    cols = rows + rng.integers(-bw, bw + 1, len(rows))
    keep = (cols >= 0) & (cols < n)
    rows, cols = rows[keep], cols[keep]
    vals = rng.uniform(-1, 1, len(rows))

    class M:
        pass

    m = M()
    m.rows, m.cols, m.vals = rows, cols, vals
    m.n_domain = m.n_range = n
    m.n_kernel = len(rows)
    part = BlockPartition(n, 1)
    plan = plan_winell_classes(rows, cols, vals, n, part.padded_size,
                               np.float64)
    assert plan is not None and "classes" in plan
    Ls = [p["row_length"] for _, p in plan["classes"]]
    assert Ls == sorted(Ls, reverse=True) and len(Ls) >= 3
    op = SlicedWinEllOperator(m, part, f64, plan=plan)
    x = np.random.default_rng(0).standard_normal(part.padded_size)
    y = np.asarray(op.matvec(jnp.asarray(x)))
    A = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    np.testing.assert_allclose(y[:n], A @ x[:n], rtol=1e-11, atol=1e-11)
    z = np.asarray(op.rmatvec(jnp.asarray(x)))
    np.testing.assert_allclose(z[:n], A.T @ x[:n], rtol=1e-11, atol=1e-11)


def test_sliced_winell_iid_degrees_degenerate(f64):
    """Negative result pinned (round 5): iid row degrees make every
    1024-row block's max ~ the global max, so the class partition
    degenerates to ONE class (the classic uniform plan) — tile-granular
    slicing cannot help the iid randband (PROFILE_r05.md)."""
    from legionsolvers_tpu.parallel.winell_op import plan_winell_classes

    rng = np.random.default_rng(5)
    n, bw, avg = 32768, 512, 8
    rows = rng.integers(0, n, n * avg)
    cols = rows + rng.integers(-bw, bw + 1, n * avg)
    keep = (cols >= 0) & (cols < n)
    rows, cols = rows[keep], cols[keep]
    vals = rng.uniform(-1, 1, len(rows))
    part = BlockPartition(n, 1)
    plan = plan_winell_classes(rows, cols, vals, n, part.padded_size,
                               np.float64)
    assert plan is not None and "classes" not in plan  # uniform fallback
