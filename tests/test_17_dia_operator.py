"""Explicit-DIA operator tests (the accelerated explicit-matrix path).

The reference's explicit matrices run through cuSPARSE SpMV (reference:
CSRMatrixTasks.cu:14-156); here banded ones auto-upgrade to per-diagonal
coefficient arrays (parallel/dia_op.py).  These tests pin: DIA matvec == the jnp ELL RowPartitionedMatrix path bit-for-bit
on the same inputs, golden CG trajectories unchanged through the planner
auto-upgrade, rmatvec adjoint, fp64 fallback, and padding.
"""

import numpy as np
import pytest
import jax.numpy as jnp

from legionsolvers_tpu import (
    BlockPartition,
    CGSolver,
    DiaOperator,
    PartitionedVector,
    RowPartitionedMatrix,
    SolverOptions,
    SquarePlanner,
    coo_negative_laplacian_1d,
    create_coo_stencil_matrix,
    laplacian_stencil,
)

F64 = SolverOptions(entry_dtype=jnp.float64)
F32 = SolverOptions(entry_dtype=jnp.float32)
GOLDEN = [100, 4900, 4704, 4512, 4324, 4140, 3960, 3784, 3612, 3444, 3280]


@pytest.mark.parametrize("pieces", [1, 4])
@pytest.mark.parametrize("shape", [(64,), (8, 8), (4, 4, 4)])
def test_dia_matches_ell_bitwise(shape, pieces, mesh4):
    """DiaOperator matvec must equal the jnp ELL path bit-for-bit: both
    reduce each row's contributions in ascending-column order (ELL packs
    column-sorted; DIA sums diagonals in ascending offset = ascending column
    per row), so even in floating point the results are identical."""
    n = int(np.prod(shape))
    A = create_coo_stencil_matrix(shape, laplacian_stencil(len(shape)),
                                  options=F64)
    mesh = mesh4 if pieces == 4 else None
    part = BlockPartition(n, pieces)
    dia = DiaOperator(A, partition=part, mesh=mesh, options=F64)
    ell = RowPartitionedMatrix(A, part, part, mesh, options=F64)
    rng = np.random.default_rng(0)
    x = PartitionedVector.from_array(
        "x", rng.random(n), part, mesh=mesh, options=F64
    )
    y_dia = np.asarray(dia.matvec(x.data))
    y_ell = np.asarray(ell.matvec(x.data))
    np.testing.assert_array_equal(y_dia, y_ell)


def test_dia_f32_pallas_interpret(mesh4):
    """f32 sharded DIA matvec_dot vs dense oracle."""
    shape = (32, 128)
    n = 32 * 128
    A = create_coo_stencil_matrix(shape, laplacian_stencil(2), options=F32)
    part = BlockPartition(n, 4)
    dia = DiaOperator(A, partition=part, mesh=mesh4, options=F32)
    assert not dia._wide_band and len(dia.flat_offsets) == 5
    rng = np.random.default_rng(1)
    xh = rng.random(n).astype(np.float32)
    x = PartitionedVector.from_array("x", xh, part, mesh=mesh4, options=F32)
    y, d = dia.matvec_dot(x.data)
    y = np.asarray(y)[:n]
    expected = A.to_dense().astype(np.float64) @ xh
    np.testing.assert_allclose(y, expected, rtol=1e-4, atol=1e-6)  # f32
    assert float(d) == pytest.approx(float(xh @ y), rel=1e-5)


@pytest.mark.parametrize("pieces", [1, 4])
def test_planner_auto_upgrade_golden(pieces, mesh4):
    """add_row_partitioned_matrix auto-upgrades the 1-D Laplacian to
    DiaOperator and the n=100 CG golden is unchanged."""
    mesh = mesh4 if pieces == 4 else None
    part = BlockPartition(100, pieces)
    A = coo_negative_laplacian_1d(100, options=F64)
    planner = SquarePlanner(mesh=mesh, options=F64)
    planner.add_sol_vector(
        PartitionedVector("s", part, mesh=mesh, options=F64).zero_fill()
    )
    planner.add_rhs_vector(
        PartitionedVector("b", part, mesh=mesh, options=F64).constant_fill(1.0)
    )
    planner.add_row_partitioned_matrix(A, 0, 0)
    assert isinstance(planner.row_partitioned_matrices[0][0], DiaOperator)
    hist = np.asarray(CGSolver(planner).solve(10)).tolist()
    assert hist == GOLDEN


def test_planner_prefer_dia_false(mesh4):
    part = BlockPartition(100, 4)
    A = coo_negative_laplacian_1d(100, options=F64)
    planner = SquarePlanner(mesh=mesh4, options=F64)
    planner.add_sol_vector(
        PartitionedVector("s", part, mesh=mesh4, options=F64).zero_fill()
    )
    planner.add_rhs_vector(
        PartitionedVector("b", part, mesh=mesh4, options=F64).constant_fill(1.0)
    )
    planner.add_row_partitioned_matrix(A, 0, 0, prefer_dia=False)
    assert isinstance(planner.row_partitioned_matrices[0][0],
                      RowPartitionedMatrix)


def test_dia_rmatvec_adjoint(mesh4):
    """<A^T y, x> == <y, A x> through the swapped-diagonal transpose."""
    shape = (8, 8)
    n = 64
    # asymmetric operator: shifted stencil
    offs = [((0, 0), 4.0), ((0, 1), -2.0), ((1, 0), -1.0)]
    A = create_coo_stencil_matrix(shape, offs, options=F64)
    part = BlockPartition(n, 4)
    dia = DiaOperator(A, partition=part, mesh=mesh4, options=F64)
    rng = np.random.default_rng(2)
    xh, yh = rng.random(n), rng.random(n)
    x = PartitionedVector.from_array("x", xh, part, mesh=mesh4, options=F64)
    y = PartitionedVector.from_array("y", yh, part, mesh=mesh4, options=F64)
    ax = np.asarray(dia.matvec(x.data))[:n]
    aty = np.asarray(dia.rmatvec(y.data))[:n]
    assert yh @ ax == pytest.approx(aty @ xh, rel=1e-12)


def test_dia_padding_path(mesh4):
    """n not divisible by pieces: padded coefficient rows are zero, solve
    converges to the true solution."""
    n = 103
    part = BlockPartition(n, 4)
    A = coo_negative_laplacian_1d(n, options=F64)
    planner = SquarePlanner(mesh=mesh4, options=F64)
    planner.add_sol_vector(
        PartitionedVector("s", part, mesh=mesh4, options=F64).zero_fill()
    )
    planner.add_rhs_vector(
        PartitionedVector("b", part, mesh=mesh4, options=F64).constant_fill(1.0)
    )
    planner.add_row_partitioned_matrix(A, 0, 0)
    assert isinstance(planner.row_partitioned_matrices[0][0], DiaOperator)
    CGSolver(planner).solve(n)
    x = np.asarray(planner.get_vector(0, 0).data)[:n]
    assert np.linalg.norm(A.to_dense() @ x - 1.0) < 1e-8


def test_dia_rejects_nonsquare():
    class Fake:
        rows = np.array([0, 1])
        cols = np.array([0, 1])
        vals = np.array([1.0, 1.0])
        n_domain = 4
        n_range = 2
        n_kernel = 2

    with pytest.raises(ValueError):
        DiaOperator(Fake(), partition=BlockPartition(2, 1), mesh=None,
                    options=F64)


def test_dia_wide_band_gather(mesh8):
    """Bandwidth > block size routes through the gather-based linearized
    fallback and matches the dense oracle."""
    shape = (4, 8)  # band 8 > block 4 at 8 pieces
    n = 32
    A = create_coo_stencil_matrix(shape, laplacian_stencil(2), options=F64)
    part = BlockPartition(n, 8)
    dia = DiaOperator(A, partition=part, mesh=mesh8, options=F64)
    assert dia._wide_band
    rng = np.random.default_rng(3)
    xh = rng.random(n)
    x = PartitionedVector.from_array("x", xh, part, mesh=mesh8, options=F64)
    y = np.asarray(dia.matvec(x.data))[:n]
    np.testing.assert_allclose(y, A.to_dense() @ xh, rtol=1e-12)


def test_dia_extract_native_and_fallback_parity():
    """The O(nnz) native extraction and the chunked numpy fallback agree
    with a dense oracle (duplicates summed, target dtype direct) — the
    scale-proof replacement for round 2's full-size float64 host scatter."""
    from legionsolvers_tpu.native import bindings as nb

    rng = np.random.default_rng(0)
    n, nnz = 50, 300
    rows = rng.integers(0, n, nnz)
    cols = rng.integers(0, n, nnz)
    vals = rng.standard_normal(nnz)
    dense = np.zeros((n, n))
    np.add.at(dense, (rows, cols), vals)

    u = nb.dia_unique_offsets(rows, cols, 200)
    assert u is not None and (np.diff(u) > 0).all()
    oracle = np.zeros((len(u), n + 3))
    for k, s in enumerate(u):
        for r in range(n):
            if 0 <= r + s < n:
                oracle[k, r] = dense[r, r + s]
    for dt in (np.float32, np.float64):
        coef = nb.dia_accumulate(rows, cols, vals, u, n + 3, dt)
        np.testing.assert_allclose(coef, oracle.astype(dt), rtol=1e-6)

    # too many diagonals -> None (planner keeps the ELL path)
    assert nb.dia_unique_offsets(
        np.arange(100), np.zeros(100, np.int64), 40) is None

    # numpy fallback parity (force the no-native path)
    lib, tried = nb._lib, nb._tried
    nb._lib, nb._tried = None, True
    try:
        u2 = nb.dia_unique_offsets(rows, cols, 200)
        c2 = nb.dia_accumulate(rows, cols, vals, u2, n + 3, np.float64)
    finally:
        nb._lib, nb._tried = lib, tried
    np.testing.assert_array_equal(u, u2)
    c1 = nb.dia_accumulate(rows, cols, vals, u, n + 3, np.float64)
    np.testing.assert_allclose(c1, c2, rtol=1e-12)


def test_dia_gate_is_density_aware():
    """Many-diagonal BANDED matrices now upgrade to DIA (per-nnz traffic is
    constant in the diagonal count — round 2's hard 40-diagonal cap was the
    wrong gate), while low-fill scattered matrices keep the ELL fallback."""
    import jax.numpy as jnp

    from legionsolvers_tpu import (
        BlockPartition,
        COOMatrix,
        SolverOptions,
        SquarePlanner,
        PartitionedVector,
    )
    from legionsolvers_tpu.parallel.dia_op import DiaOperator
    from legionsolvers_tpu.parallel.distmatrix import RowPartitionedMatrix

    F64 = SolverOptions(entry_dtype=jnp.float64)
    n, D = 256, 61  # 61 full diagonals: D > 40, fill = 1.0 per diagonal
    rows, cols, vals = [], [], []
    rng = np.random.default_rng(0)
    for s in range(-30, 31):
        r = np.arange(max(0, -s), min(n, n - s))
        rows.append(r)
        cols.append(r + s)
        vals.append(rng.standard_normal(len(r)))
    A = COOMatrix(np.concatenate(rows), np.concatenate(cols),
                  np.concatenate(vals), n, n, options=F64)

    def build(A):
        part = BlockPartition(n, 1)
        pl_ = SquarePlanner(mesh=None, options=F64)
        pl_.add_sol_vector(
            PartitionedVector("s", part, options=F64).zero_fill())
        pl_.add_rhs_vector(
            PartitionedVector("b", part, options=F64).constant_fill(1.0))
        pl_.add_row_partitioned_matrix(A, 0, 0)
        return pl_

    planner = build(A)
    op = planner.row_partitioned_matrices[0][0]
    assert isinstance(op, DiaOperator), type(op)
    x = rng.standard_normal(n)
    y = np.asarray(op.matvec(jnp.asarray(x)))[:n]
    np.testing.assert_allclose(y, A.to_dense() @ x, rtol=1e-12)

    # scattered: 100+ distinct diagonals with ~4 entries each -> fill far
    # below MIN_DIA_FILL -> ELL
    m = 2048
    rs = rng.integers(0, m, 500)
    cs = rng.integers(0, m, 500)
    vs = rng.standard_normal(500)
    # ensure the diagonal itself exists so the matrix is solvable-ish
    B = COOMatrix(np.concatenate([rs, np.arange(m)]),
                  np.concatenate([cs, np.arange(m)]),
                  np.concatenate([vs, np.full(m, 4.0)]), m, m, options=F64)
    n_prev = n
    n = m
    planner2 = build(B)
    n = n_prev
    op2 = planner2.row_partitioned_matrices[0][0]
    # the density gate must NOT hand this to the direct DIA kernel; since
    # round 4 the planner routes such matrices through the RCM reorder
    # upgrade (parallel/reorder.py) when it helps, with the halo-ELL
    # RowPartitionedMatrix as the final fallback
    from legionsolvers_tpu.parallel.reorder import ReorderedOperator

    assert isinstance(op2, (RowPartitionedMatrix, ReorderedOperator)), type(op2)
    # and whichever path was taken must be correct
    x2 = rng.standard_normal(m)
    y2 = np.asarray(op2.matvec(jnp.asarray(np.concatenate(
        [x2, np.zeros(planner2.canonical_partitions[0].padded_size - m)]
    ))))[:m]
    np.testing.assert_allclose(y2, B.to_dense() @ x2, rtol=1e-11, atol=1e-11)
