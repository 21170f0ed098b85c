"""3-D grid-view stencil passes (ops/grid3d.py).

Covers the reference benchmark's 3-D cases — 7-point and 27-point Laplacians
(reference: test/BenchmarkStencil.cpp:24-137) — against the dense COO
reference, single-piece and sharded, plus the fused-CG runner vs the
linearized path.
"""

import numpy as np
import pytest
import jax.numpy as jnp

from legionsolvers_tpu import (
    BlockPartition,
    CGSolver,
    PartitionedVector,
    SolverOptions,
    SquarePlanner,
    StencilOperator,
    laplacian_stencil,
)
from legionsolvers_tpu.problems.stencil import stencil_coo_arrays

F32 = SolverOptions(entry_dtype=jnp.float32)
SHAPE = (8, 8, 24)  # any Y, Z: the grid view has no tiling constraint


def _dense_ref(shape, st, x):
    rows, cols, vals, n = stencil_coo_arrays(shape, st)
    y = np.zeros(n, dtype=np.float64)
    np.add.at(y, rows, vals * x[cols].astype(np.float64))
    return y


@pytest.mark.parametrize("dim_sel", [3, 4])
def test_pallas3d_matvec_single_piece(dim_sel):
    st = laplacian_stencil(dim_sel)
    n = int(np.prod(SHAPE))
    x = np.random.default_rng(0).standard_normal(n).astype(np.float32)
    y_ref = _dense_ref(SHAPE, st, x)

    op = StencilOperator(SHAPE, st, partition=BlockPartition(n, 1),
                         mesh=None, options=F32)
    assert op.uses_grid_view and op._view["kind"] == "3d"
    y = np.asarray(op.matvec(jnp.asarray(x)))
    assert np.abs(y - y_ref).max() / np.abs(y_ref).max() < 1e-5

    y2, d = op.matvec_dot(jnp.asarray(x))
    dref = float(x.astype(np.float64) @ y_ref)
    assert abs(float(d) - dref) / abs(dref) < 1e-4
    np.testing.assert_allclose(np.asarray(y2), y, rtol=1e-6)


@pytest.mark.parametrize("dim_sel", [3, 4])
def test_pallas3d_matvec_sharded(dim_sel, mesh4):
    st = laplacian_stencil(dim_sel)
    n = int(np.prod(SHAPE))
    x = np.random.default_rng(1).standard_normal(n).astype(np.float32)
    y_ref = _dense_ref(SHAPE, st, x)

    op = StencilOperator(SHAPE, st, partition=BlockPartition(n, 4),
                         mesh=mesh4, options=F32)
    assert op.uses_grid_view and op._view["kind"] == "3d"
    y = np.asarray(op.matvec(jnp.asarray(x)))
    assert np.abs(y - y_ref).max() / np.abs(y_ref).max() < 1e-5


@pytest.mark.parametrize("dim_sel", [3, 4])
def test_pallas3d_fused_cg_matches_linearized(dim_sel, mesh4):
    st = laplacian_stencil(dim_sel)
    n = int(np.prod(SHAPE))
    part = BlockPartition(n, 4)

    def run(grid_view):
        op = StencilOperator(SHAPE, st, partition=part, mesh=mesh4,
                             options=F32, grid_view=grid_view)
        gs = SHAPE if grid_view else None
        rhs = PartitionedVector("rhs", part, mesh=mesh4, options=F32,
                                grid_shape=gs).constant_fill(1.0)
        sol = PartitionedVector("sol", part, mesh=mesh4, options=F32,
                                grid_shape=gs).zero_fill()
        planner = SquarePlanner(mesh=mesh4, options=F32)
        planner.add_sol_vector(sol)
        planner.add_rhs_vector(rhs)
        planner.add_operator(op, 0, 0)
        solver = CGSolver(planner)
        if grid_view:
            assert solver._make_fused_runner(8) is not None
        return np.asarray(solver.solve(8), dtype=np.float64)

    hp, hl = run(True), run(False)
    rel = np.abs(hp - hl) / np.maximum(np.abs(hl), 1e-12)
    assert rel.max() < 5e-3


def test_fused3d_xpay_pq_matches_classic(mesh4):
    """The xpay_pq + update 3-D schedule (32 B/unknown) vs classic CG,
    unsharded and sharded."""
    import numpy as np

    from legionsolvers_tpu import (
        BlockPartition,
        CGSolver,
        PartitionedVector,
        SolverOptions,
        SquarePlanner,
        StencilOperator,
        laplacian_stencil,
    )
    from legionsolvers_tpu.utils.roofline import solver_bytes_per_iteration

    F32 = SolverOptions(entry_dtype=jnp.float32)
    shape = (16, 32, 40)
    n = int(np.prod(shape))

    def build(pieces, mesh):
        part = BlockPartition(n, pieces)
        op = StencilOperator(shape, laplacian_stencil(3), partition=part,
                             mesh=mesh, options=F32)
        pl_ = SquarePlanner(mesh=mesh, options=F32)
        gs = shape if op.uses_grid_view else None
        pl_.add_sol_vector(PartitionedVector(
            "s", part, mesh=mesh, options=F32, grid_shape=gs).zero_fill())
        pl_.add_rhs_vector(PartitionedVector(
            "b", part, mesh=mesh, options=F32,
            grid_shape=gs).constant_fill(1.0))
        pl_.add_operator(op, 0, 0)
        return pl_, op

    for pieces, mesh in ((1, None), (4, mesh4)):
        p1, op1 = build(pieces, mesh)
        s1 = CGSolver(p1)
        _, sched = solver_bytes_per_iteration(s1, n)
        assert sched == "fused3d"
        h1 = np.asarray(s1.solve(8))
        p2, _ = build(pieces, mesh)
        s2 = CGSolver(p2)
        s2._make_fused_runner = lambda k: None
        h2 = np.asarray(s2.solve(8))
        np.testing.assert_allclose(h1, h2, rtol=5e-4)
        x1 = p1.sol_vectors[0].to_numpy()
        x2 = p2.sol_vectors[0].to_numpy()
        np.testing.assert_allclose(x1, x2, rtol=0,
                                   atol=2e-3 * np.abs(x2).max())
