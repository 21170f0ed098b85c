"""Grid-native vector layout + fused matvec_dot tests (f32).  The grid
layout stores 2-D stencil problems as 2-D arrays sharded over the leading
axis, eliminating relayout copies at pass boundaries; results must be
identical to the flat layout."""

import jax.numpy as jnp
import numpy as np
import pytest

from legionsolvers_tpu import (
    BlockPartition,
    CGSolver,
    PartitionedVector,
    SolverOptions,
    SquarePlanner,
    StencilOperator,
    laplacian_stencil,
)

F32 = SolverOptions(entry_dtype=jnp.float32)


def build(ng, pieces, mesh, grid):
    n = ng * ng
    part = BlockPartition(n, pieces)
    op = StencilOperator(
        (ng, ng), laplacian_stencil(2), partition=part, mesh=mesh, options=F32
    )
    gs = (ng, ng) if grid else None
    if grid and not op.uses_grid_view:
        pytest.skip("grid view unavailable for this geometry")
    rhs = PartitionedVector("rhs", part, mesh=mesh, options=F32, grid_shape=gs)
    rhs.constant_fill(1.0)
    sol = PartitionedVector("sol", part, mesh=mesh, options=F32, grid_shape=gs)
    sol.zero_fill()
    planner = SquarePlanner(mesh=mesh, options=F32)
    planner.add_sol_vector(sol)
    planner.add_rhs_vector(rhs)
    planner.add_operator(op, 0, 0)
    return planner, op


@pytest.mark.parametrize("pieces,use_mesh", [(1, False), (4, True)])
def test_grid_cg_matches_flat(pieces, use_mesh, mesh4):
    ng = 128
    mesh = mesh4 if use_mesh else None
    p_flat, _ = build(ng, pieces, mesh, grid=False)
    p_grid, op = build(ng, pieces, mesh, grid=True)
    assert op.uses_grid_view
    h_flat = np.asarray(CGSolver(p_flat).solve(8))
    h_grid = np.asarray(CGSolver(p_grid).solve(8))
    # f32: fused per-shard dot partials reduce in a different order than the
    # flat path's dot -> small trajectory divergence is expected
    np.testing.assert_allclose(h_grid, h_flat, rtol=1e-3)
    x_flat = p_flat.sol_vectors[0].to_numpy()
    x_grid = p_grid.sol_vectors[0].to_numpy()
    np.testing.assert_allclose(x_grid, x_flat, rtol=1e-2, atol=1e-5)


def test_matvec_dot_fused_matches_separate():
    ng = 128
    part = BlockPartition(ng * ng, 1)
    op = StencilOperator(
        (ng, ng), laplacian_stencil(2), partition=part, options=F32
    )
    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.random((ng, ng)), jnp.float32)
    y, d = op.matvec_dot(x)
    y2 = op.matvec(x)
    np.testing.assert_allclose(np.asarray(y), np.asarray(y2), rtol=1e-6)
    d2 = float(jnp.sum(x * y2, dtype=jnp.float32))
    assert np.isclose(float(d), d2, rtol=1e-4)


def test_rmatvec_distributed(mesh4):
    """Distributed transpose matvec (reference stubs this) must match the
    dense transpose, both for RowPartitionedMatrix and StencilOperator."""
    from legionsolvers_tpu import SquarePlanner, create_coo_stencil_matrix
    from legionsolvers_tpu.parallel.distmatrix import RowPartitionedMatrix

    F64 = SolverOptions(entry_dtype=jnp.float64)
    n = 64
    offs = [((0,), 2.0), ((-1,), -1.5), ((1,), -0.5)]  # asymmetric
    A = create_coo_stencil_matrix((n,), offs, options=F64)
    part = BlockPartition(n, 4)
    dist = RowPartitionedMatrix(A, part, part, mesh4, options=F64)
    rng = np.random.default_rng(5)
    x_host = rng.random(n)
    x = PartitionedVector.from_array("x", x_host, part, mesh=mesh4, options=F64)
    y = np.asarray(dist.rmatvec(x.data))[:n]
    np.testing.assert_allclose(y, A.to_dense().T @ x_host, rtol=1e-12)

    op = StencilOperator((n,), offs, partition=part, mesh=mesh4, options=F64)
    y2 = np.asarray(op.rmatvec(x.data))[:n]
    np.testing.assert_allclose(y2, A.to_dense().T @ x_host, rtol=1e-12)


def test_grid_vector_validation():
    part = BlockPartition(100, 4)  # padded (112) != n -> grid must reject
    with pytest.raises(ValueError):
        PartitionedVector("v", part, grid_shape=(10, 10))
    part2 = BlockPartition(64, 4)
    with pytest.raises(ValueError):
        PartitionedVector("v", part2, grid_shape=(4, 4))  # wrong size
    v = PartitionedVector("v", part2, grid_shape=(8, 8))
    v.constant_fill(2.0)
    assert v.dot(v).get_value() == 256.0
    np.testing.assert_array_equal(v.to_numpy(), np.full(64, 2.0))
