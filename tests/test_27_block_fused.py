"""Fused multi-space (block-system) schedules — parallel/block_fused.py.

The reference's benchmark stress config (2 spaces, matrix registered twice,
BenchmarkStencil.cpp:201-207) runs the per-space fused phases.  These tests
pin the per-space-phases block runners against the planner transcription
(LEGIONSOLVERS_NO_BLOCK_FUSED=1 forces the old path) with DISTINCT rhs per
space — identical rhs would mask scalar-combination bugs, because for
diag(A, A) with b0 == b1 the global and per-space coefficient ratios
coincide.

f64 systems take the classic phases (exact-trajectory agreement); f32
2-D/3-D grids take the fused phases (s-step through the Triton kernel in
interpret mode, two-pass, BiCGStab three-pass), sharded variants run on the
virtual CPU mesh.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from legionsolvers_tpu import (
    BiCGStabSolver,
    BlockPartition,
    CGSolver,
    PartitionedVector,
    SolverOptions,
    SquarePlanner,
    StencilOperator,
    laplacian_stencil,
)

F32 = SolverOptions(entry_dtype=jnp.float32)


def build_grid_block_planner(shape, pieces, mesh, num_spaces=2, seed=5,
                             shift=0.0):
    """2-space grid-layout planner over the dim-matching Laplacian stencil
    (plus optional diagonal shift), distinct random rhs per space."""
    n = int(np.prod(shape))
    part = BlockPartition(n, pieces)
    offs = laplacian_stencil(len(shape) if len(shape) < 3 else 3)
    if shift:
        offs = [(o, v + (shift if all(c == 0 for c in o) else 0.0))
                for o, v in offs]
    op = StencilOperator(shape, offs, partition=part, mesh=mesh, options=F32)
    assert op.uses_grid_view, "geometry must hit the grid view"
    rng = np.random.default_rng(seed)
    planner = SquarePlanner(mesh=mesh, options=F32)
    for i in range(num_spaces):
        planner.add_sol_vector(
            PartitionedVector(f"s{i}", part, mesh=mesh, options=F32,
                              grid_shape=shape).zero_fill()
        )
    for i in range(num_spaces):
        b = rng.random(n).astype(np.float32)
        planner.add_rhs_vector(
            PartitionedVector.from_array(
                f"b{i}", b.reshape(shape), part, mesh=mesh, options=F32,
                grid_shape=shape,
            )
        )
    for i in range(num_spaces):
        planner.add_operator(op, i, i)
    return planner


def run_pair(build, solver_cls, iters):
    """(fused history+solutions, transcription history+solutions)."""
    pl_f = build()
    s_f = solver_cls(pl_f)
    assert s_f._make_fused_runner(iters) is not None, "block runner must fire"
    h_f = np.asarray(s_f.solve(iters))
    xs_f = [np.asarray(pl_f.get_vector(0, i).data)
            for i in range(pl_f.num_spaces)]

    os.environ["LEGIONSOLVERS_NO_BLOCK_FUSED"] = "1"
    try:
        pl_t = build()
        s_t = solver_cls(pl_t)
        assert s_t._make_fused_runner(iters) is None
        h_t = np.asarray(s_t.solve(iters))
        xs_t = [np.asarray(pl_t.get_vector(0, i).data)
                for i in range(pl_t.num_spaces)]
    finally:
        del os.environ["LEGIONSOLVERS_NO_BLOCK_FUSED"]
    return (h_f, xs_f), (h_t, xs_t)


@pytest.mark.parametrize("pieces", [1, 4])
def test_block_cg_2d_step2_matches_transcription(pieces, mesh4):
    """2-D 5-pt block CG: every space is step2-eligible, so the block
    runner takes the s-step schedule; trajectory and solutions must track
    the transcription (f32: modest tolerance for reduction-order drift)."""
    mesh = mesh4 if pieces == 4 else None
    shape = (128, 256) if pieces == 4 else (32, 256)
    build = lambda: build_grid_block_planner(shape, pieces, mesh, shift=8.0)
    (h_f, xs_f), (h_t, xs_t) = run_pair(build, CGSolver, 12)
    np.testing.assert_allclose(h_f, h_t, rtol=2e-3)
    for a, b in zip(xs_f, xs_t):
        np.testing.assert_allclose(a, b, rtol=5e-3, atol=1e-5)


def test_block_cg_2d_twopass_matches_transcription():
    """With the s-step schedule disabled, the block runner composes the
    two-pass phases; odd iteration count exercises the prologue + loop."""
    os.environ["LEGIONSOLVERS_NO_SSTEP"] = "1"
    try:
        build = lambda: build_grid_block_planner((32, 256), 1, None,
                                                 shift=8.0)
        (h_f, xs_f), (h_t, xs_t) = run_pair(build, CGSolver, 9)
    finally:
        del os.environ["LEGIONSOLVERS_NO_SSTEP"]
    np.testing.assert_allclose(h_f, h_t, rtol=2e-3)
    for a, b in zip(xs_f, xs_t):
        np.testing.assert_allclose(a, b, rtol=5e-3, atol=1e-5)


def test_block_cg_odd_iterations_step2_tail():
    """Odd iteration count on the s-step schedule: the odd_update tail must
    agree with the transcription's last plain iteration."""
    build = lambda: build_grid_block_planner((32, 256), 1, None, shift=8.0)
    (h_f, xs_f), (h_t, xs_t) = run_pair(build, CGSolver, 11)
    np.testing.assert_allclose(h_f, h_t, rtol=2e-3)


def test_block_cg_3d_matches_transcription():
    """3-D 7-pt block CG (plane-streaming phases)."""
    build = lambda: build_grid_block_planner((8, 16, 128), 1, None,
                                             shift=8.0)
    (h_f, xs_f), (h_t, xs_t) = run_pair(build, CGSolver, 8)
    np.testing.assert_allclose(h_f, h_t, rtol=2e-3)
    for a, b in zip(xs_f, xs_t):
        np.testing.assert_allclose(a, b, rtol=5e-3, atol=1e-5)


@pytest.mark.parametrize("pieces", [1, 4])
def test_block_bicgstab_matches_transcription(pieces, mesh4):
    """2-D block BiCGStab on the three-pass phases (sharded: the
    single-exchange derived-halo fixup structure per space)."""
    mesh = mesh4 if pieces == 4 else None
    shape = (128, 256) if pieces == 4 else (32, 256)
    build = lambda: build_grid_block_planner(shape, pieces, mesh, shift=8.0)
    (h_f, xs_f), (h_t, xs_t) = run_pair(build, BiCGStabSolver, 10)
    # BiCGStab's recurrence amplifies f32 vector rounding (see
    # solvers/bicgstab.py numerics note); require trajectory tracking to a
    # loose tolerance plus true-residual agreement at the end
    np.testing.assert_allclose(h_f[:6], h_t[:6], rtol=0.05)
    for a, b in zip(xs_f, xs_t):
        np.testing.assert_allclose(a, b, rtol=0.05, atol=1e-4)


def test_block_bicgstab_3d_matches_transcription():
    build = lambda: build_grid_block_planner((8, 16, 128), 1, None,
                                             shift=8.0)
    (h_f, xs_f), (h_t, xs_t) = run_pair(build, BiCGStabSolver, 8)
    np.testing.assert_allclose(h_f[:5], h_t[:5], rtol=0.05)


def test_block_cg_solution_actually_solves():
    """End check independent of the transcription: the fused block solve's
    residual b - A x must be small in every space."""
    shape = (32, 256)
    build = lambda: build_grid_block_planner(shape, 1, None, shift=8.0)
    pl = build()
    s = CGSolver(pl)
    # 16 iterations: converged to ~1e-5 but not to exact f32 zero residual
    # (a fully-converged f32 CG hits rr == 0 -> beta = 0/0 NaN, equally on
    # the single-space runners — not a block-path property)
    s.solve(16)
    from tests.test_08_stencil import dense_stencil

    offs = [(o, v + (8.0 if all(c == 0 for c in o) else 0.0))
            for o, v in laplacian_stencil(2)]
    A = dense_stencil(shape, offs)
    for i in range(2):
        x = np.asarray(pl.get_vector(0, i).data).reshape(-1)
        b = np.asarray(pl.get_vector(1, i).data).reshape(-1)
        assert np.linalg.norm(b - A @ x) / np.linalg.norm(b) < 1e-4
