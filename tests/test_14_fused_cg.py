"""Fused-CG path tests.

The fused path runs each CG iteration as two passes (xpay+pq, then the x/r
update re-deriving A p) — 32 B/unknown/iteration vs 48 for the classic
schedule — or, for 2-D stencils the s-step kernel takes, one pass per two
iterations.  It must be an exact continuation of standard CG:
same residual² trajectory and solution as the generic planner path (the
reference's iteration structure, CGSolver.hpp:46-55), both unsharded and
sharded, and composable with prior plain step() calls.
"""

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


def build(shape, pieces, mesh, grid=True):
    n = int(np.prod(shape))
    part = BlockPartition(n, pieces)
    op = StencilOperator(
        shape, laplacian_stencil(len(shape)), partition=part, mesh=mesh,
        options=F32,
    )
    gs = shape if grid and len(shape) == 2 else None
    rhs = PartitionedVector("rhs", part, mesh=mesh, options=F32, grid_shape=gs)
    rhs.constant_fill(1.0)
    sol = PartitionedVector("sol", part, mesh=mesh, options=F32, grid_shape=gs)
    sol.zero_fill()
    planner = SquarePlanner(mesh=mesh, options=F32)
    planner.add_sol_vector(sol)
    planner.add_rhs_vector(rhs)
    planner.add_operator(op, 0, 0)
    return planner, op


def solve_pair(shape, pieces, mesh, iters, grid=True):
    """(generic history/x, fused history/x) on identical systems."""
    pg, _ = build(shape, pieces, mesh, grid)
    sg = CGSolver(pg)
    sg._make_fused_runner = lambda k: None  # force the generic path
    hg = np.asarray(sg.solve(iters))

    pf, op = build(shape, pieces, mesh, grid)
    assert op.supports_fused_cg
    sf = CGSolver(pf)
    assert sf._solve_cache == {}
    hf = np.asarray(sf.solve(iters))
    assert sf._solve_cache[(iters, "fused", False)] is not None  # fused was taken
    return hg, pg.sol_vectors[0].to_numpy(), hf, pf.sol_vectors[0].to_numpy()


@pytest.mark.parametrize("pieces,use_mesh", [(1, False), (4, True)])
def test_fused_cg_matches_generic_2d(pieces, use_mesh, mesh4):
    mesh = mesh4 if use_mesh else None
    hg, xg, hf, xf = solve_pair((64, 128), pieces, mesh, 8)
    np.testing.assert_allclose(hf, hg, rtol=1e-4)
    np.testing.assert_allclose(xf, xg, rtol=1e-3, atol=1e-6)


def test_fused_cg_flat_layout_1d(mesh4):
    """1-D problems reach the fused path through the flat-offset
    decomposition onto the 2-D passes."""
    hg, xg, hf, xf = solve_pair((128 * 64,), 4, mesh4, 6, grid=False)
    np.testing.assert_allclose(hf, hg, rtol=1e-4)
    np.testing.assert_allclose(xf, xg, rtol=1e-3, atol=1e-6)


def test_fused_cg_is_exact_continuation():
    """step() twice, then fused solve: trajectory must continue the same CG
    (the fused prologue uses the incoming p, not a restart)."""
    planner, op = build((64, 128), 1, None)
    assert op.supports_fused_cg
    solver = CGSolver(planner)
    solver.step()
    solver.step()
    pre = [float(s.value) for s in solver.residual_norm_squared]
    hist = np.asarray(solver.solve(4))
    assert np.isclose(hist[0], pre[-1], rtol=1e-6)

    planner2, _ = build((64, 128), 1, None)
    solver2 = CGSolver(planner2)
    solver2._make_fused_runner = lambda k: None
    h2 = np.asarray(solver2.solve(6))
    np.testing.assert_allclose(
        np.concatenate([pre[:-1], hist]), h2, rtol=1e-4
    )


def test_fused_block_runner_used_for_multi_space(mesh4):
    """Block systems (2 spaces, the reference's BenchmarkStencil stress
    config) take the per-space-phases block runner since round 5
    (parallel/block_fused.py; r4 verdict item 1) — it must fire AND solve."""
    part = BlockPartition(64 * 128, 4)
    op = StencilOperator(
        (64, 128), laplacian_stencil(2), partition=part, mesh=mesh4,
        options=F32,
    )
    planner = SquarePlanner(mesh=mesh4, options=F32)
    for _ in range(2):
        sol = PartitionedVector("s", part, mesh=mesh4, options=F32)
        sol.zero_fill()
        planner.add_sol_vector(sol)
    for _ in range(2):
        rhs = PartitionedVector("b", part, mesh=mesh4, options=F32)
        rhs.constant_fill(1.0)
        planner.add_rhs_vector(rhs)
    planner.add_operator(op, 0, 0)
    planner.add_operator(op, 1, 1)
    solver = CGSolver(planner)
    assert solver._make_fused_runner(4) is not None
    hist = np.asarray(solver.solve(4))
    assert hist.shape == (5,) and hist[0] == 2 * 64 * 128
    # trajectory must track the transcription (same block system, old path)
    import os
    os.environ["LEGIONSOLVERS_NO_BLOCK_FUSED"] = "1"
    try:
        planner2 = SquarePlanner(mesh=mesh4, options=F32)
        for _ in range(2):
            planner2.add_sol_vector(
                PartitionedVector("s", part, mesh=mesh4,
                                  options=F32).zero_fill())
        for _ in range(2):
            planner2.add_rhs_vector(
                PartitionedVector("b", part, mesh=mesh4,
                                  options=F32).constant_fill(1.0))
        planner2.add_operator(op, 0, 0)
        planner2.add_operator(op, 1, 1)
        solver2 = CGSolver(planner2)
        assert solver2._make_fused_runner(4) is None
        hist2 = np.asarray(solver2.solve(4))
    finally:
        del os.environ["LEGIONSOLVERS_NO_BLOCK_FUSED"]
    np.testing.assert_allclose(hist, hist2, rtol=2e-3)


def test_consume_rhs_matches_plain():
    """The 3-live-vector max-size mode (b donated through r, re-filled
    between runs — the reference-2^30-parity path, bench_all_ls.py:366-379)
    must reproduce the plain donate path's trajectory exactly and leave the
    planner consistent across repeated runs."""
    import numpy as np

    import legionsolvers_tpu.benchmark as B

    r1 = B.main(["-dim", "2", "-solver", "1", "-nx", "64", "-ny", "128",
                 "-it", "8"])
    r2 = B.main(["-dim", "2", "-solver", "1", "-nx", "64", "-ny", "128",
                 "-it", "8", "--consume-rhs"])
    assert np.isclose(r1["final_residual2"], r2["final_residual2"],
                      rtol=1e-6)
