"""Fused BiCGStab passes (ops/grid2d.py bicg_*): pass-level agreement with a
dense fp64 oracle of the reference recurrence (BiCGStabSolver.hpp:64-82),
and the fused runners against the planner transcription."""

import jax.numpy as jnp
import numpy as np
import pytest

from legionsolvers_tpu.ops.grid2d import bicg_pv, bicg_st, bicg_update

OFFS = ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1))
VALS = (4.0, -1.0, -1.0, -1.0, -1.0)
KW = dict(offsets=OFFS, values=VALS)


def apply_np(v):
    R, C = v.shape
    out = np.zeros_like(v)
    for (dy, dx), w in zip(OFFS, VALS):
        src = np.zeros_like(v)
        ys = slice(max(0, dy), R + min(0, dy))
        yd = slice(max(0, -dy), R + min(0, -dy))
        xs = slice(max(0, dx), C + min(0, dx))
        xd = slice(max(0, -dx), C + min(0, -dx))
        src[yd, xd] = v[ys, xs]
        out += w * src
    return out


@pytest.fixture
def state():
    rng = np.random.default_rng(7)
    shp = (32, 128)
    return {k: rng.standard_normal(shp).astype(np.float32)
            for k in ("x", "r", "p", "v", "rt")}


def test_supported(mesh4):
    """Any 2-D grid view runs the fused passes (no width constraint);
    sharded blocks need >= 16 rows for the edge fixups; 1-D blocks too
    small to fold into [rows, 128] have no grid view."""
    from legionsolvers_tpu import BlockPartition, StencilOperator
    from legionsolvers_tpu import laplacian_stencil as lap

    def op(shape, pieces, mesh=None):
        n = int(np.prod(shape))
        return StencilOperator(shape, lap(len(shape)),
                               partition=BlockPartition(n, pieces), mesh=mesh)

    assert op((64, 100), 1).supports_fused_bicgstab
    assert op((64, 128), 4, mesh4).supports_fused_bicgstab
    assert not op((32, 128), 4, mesh4).supports_fused_bicgstab
    assert op((4096,), 1).supports_fused_bicgstab
    assert not op((100,), 1).supports_fused_bicgstab


def test_pv_oracle(state):
    beta, omega = 0.37, 1.21
    p, v, rtv = bicg_pv(
        *(jnp.asarray(state[k]) for k in ("r", "p", "v", "rt")),
        beta, omega, **KW)
    pe = state["r"].astype(np.float64) + beta * (
        state["p"] - omega * state["v"]).astype(np.float64)
    ve = apply_np(pe)
    np.testing.assert_allclose(np.asarray(p), pe, atol=2e-5 * np.abs(pe).max())
    np.testing.assert_allclose(np.asarray(v), ve, atol=2e-5 * np.abs(ve).max())
    np.testing.assert_allclose(
        float(rtv), (state["rt"].astype(np.float64) * ve).sum(), rtol=2e-4)


def test_st_oracle(state):
    alpha = 0.83
    ts, tt = bicg_st(jnp.asarray(state["r"]), jnp.asarray(state["v"]),
                     alpha, **KW)
    se = (state["r"] - alpha * state["v"]).astype(np.float64)
    te = apply_np(se)
    np.testing.assert_allclose(float(ts), (te * se).sum(), rtol=2e-4)
    np.testing.assert_allclose(float(tt), (te * te).sum(), rtol=2e-4)


def test_update_oracle(state):
    alpha, omega = 0.83, 0.41
    xo, ro, rr, rtr = bicg_update(
        *(jnp.asarray(state[k]) for k in ("r", "v", "x", "p", "rt")),
        alpha, omega, **KW)
    se = (state["r"] - alpha * state["v"]).astype(np.float64)
    te = apply_np(se)
    xe = state["x"] + alpha * state["p"] + omega * se
    re = se - omega * te
    np.testing.assert_allclose(np.asarray(xo), xe, atol=2e-5 * np.abs(xe).max())
    np.testing.assert_allclose(np.asarray(ro), re, atol=2e-5 * np.abs(re).max())
    np.testing.assert_allclose(float(rr), (re * re).sum(), rtol=2e-4)
    np.testing.assert_allclose(
        float(rtr), (state["rt"].astype(np.float64) * re).sum(),
        rtol=2e-3, atol=1e-2)


def build_sys(shape, no_fused=False):
    import os

    from legionsolvers_tpu import (
        BlockPartition,
        BiCGStabSolver,
        PartitionedVector,
        SolverOptions,
        SquarePlanner,
        StencilOperator,
        laplacian_stencil,
    )

    F32 = SolverOptions(entry_dtype=jnp.float32)
    n = int(np.prod(shape))
    part = BlockPartition(n, 1)
    if no_fused:
        os.environ["LEGIONSOLVERS_NO_FUSED_BICGSTAB"] = "1"
    try:
        op = StencilOperator(shape, laplacian_stencil(2), partition=part,
                             mesh=None, options=F32)
        planner = SquarePlanner(mesh=None, options=F32)
        gs = shape if op.uses_grid_view else None
        planner.add_sol_vector(PartitionedVector(
            "s", part, options=F32, grid_shape=gs).zero_fill())
        planner.add_rhs_vector(PartitionedVector(
            "b", part, options=F32, grid_shape=gs).constant_fill(1.0))
        planner.add_operator(op, 0, 0)
        solver = BiCGStabSolver(planner)
        if no_fused:
            assert not op.supports_fused_bicgstab
    finally:
        os.environ.pop("LEGIONSOLVERS_NO_FUSED_BICGSTAB", None)
    return planner, op, solver


@pytest.mark.parametrize("iters", [1, 5, 12])
def test_fused_solve_matches_transcription(iters):
    """The 3-pass fused schedule is the same recurrence as the planner
    transcription; f32 trajectories must agree to rounding growth."""
    planner, op, solver = build_sys((32, 128))
    assert op.supports_fused_bicgstab
    assert solver._make_fused_runner(1) is not None
    h_fused = np.asarray(solver.solve(iters))

    planner2, op2, solver2 = build_sys((32, 128), no_fused=True)
    h_ref = np.asarray(solver2.solve(iters))
    np.testing.assert_allclose(h_fused, h_ref, rtol=2e-3)
    x1 = planner.sol_vectors[0].to_numpy()
    x2 = planner2.sol_vectors[0].to_numpy()
    np.testing.assert_allclose(x1, x2, rtol=0, atol=5e-3 * np.abs(x2).max())


def test_fused_schedule_reported():
    from legionsolvers_tpu.utils.roofline import solver_bytes_per_iteration

    planner, op, solver = build_sys((32, 128))
    bpi, sched = solver_bytes_per_iteration(solver, 32 * 128)
    assert sched == "bicgstab_fused2d"
    assert bpi == 15 * 4 * 32 * 128


def test_fused_is_continuation():
    """step() twice then a fused solve continues the same trajectory."""
    planner, op, solver = build_sys((32, 128))
    solver.step()
    solver.step()
    h = np.asarray(solver.solve(3))

    planner2, op2, solver2 = build_sys((32, 128), no_fused=True)
    solver2.step()
    solver2.step()
    h2 = np.asarray(solver2.solve(3))
    np.testing.assert_allclose(h, h2, rtol=5e-3)


def test_fused_1d_flat_decomposition():
    """1-D stencils map onto the 2-D passes via the flat-offset
    decomposition (wrap terms take the roll+mask path); fused vs
    transcription trajectories must agree."""
    import os

    from legionsolvers_tpu import (
        BlockPartition,
        BiCGStabSolver,
        PartitionedVector,
        SolverOptions,
        SquarePlanner,
        StencilOperator,
        laplacian_stencil,
    )

    F32 = SolverOptions(entry_dtype=jnp.float32)
    n = 64 * 128
    part = BlockPartition(n, 1)

    def build(no_fused):
        if no_fused:
            os.environ["LEGIONSOLVERS_NO_FUSED_BICGSTAB"] = "1"
        try:
            op = StencilOperator((n,), laplacian_stencil(1), partition=part,
                                 mesh=None, options=F32)
            planner = SquarePlanner(mesh=None, options=F32)
            planner.add_sol_vector(PartitionedVector(
                "s", part, options=F32).zero_fill())
            planner.add_rhs_vector(PartitionedVector(
                "b", part, options=F32).constant_fill(1.0))
            planner.add_operator(op, 0, 0)
            return planner, op, BiCGStabSolver(planner)
        finally:
            os.environ.pop("LEGIONSOLVERS_NO_FUSED_BICGSTAB", None)

    p1, op1, s1 = build(False)
    assert op1.uses_grid_view and op1.supports_fused_bicgstab
    h1 = np.asarray(s1.solve(8))
    p2, op2, s2 = build(True)
    h2 = np.asarray(s2.solve(8))
    np.testing.assert_allclose(h1, h2, rtol=2e-3)


def build_sys_sharded(shape, pieces, mesh, no_fused=False):
    import os

    from legionsolvers_tpu import (
        BlockPartition,
        BiCGStabSolver,
        PartitionedVector,
        SolverOptions,
        SquarePlanner,
        StencilOperator,
        laplacian_stencil,
    )

    F32 = SolverOptions(entry_dtype=jnp.float32)
    n = int(np.prod(shape))
    part = BlockPartition(n, pieces)
    if no_fused:
        os.environ["LEGIONSOLVERS_NO_FUSED_BICGSTAB"] = "1"
    try:
        op = StencilOperator(shape, laplacian_stencil(2), partition=part,
                             mesh=mesh, options=F32)
        planner = SquarePlanner(mesh=mesh, options=F32)
        gs = shape if op.uses_grid_view else None
        planner.add_sol_vector(PartitionedVector(
            "s", part, mesh=mesh, options=F32, grid_shape=gs).zero_fill())
        planner.add_rhs_vector(PartitionedVector(
            "b", part, mesh=mesh, options=F32,
            grid_shape=gs).constant_fill(1.0))
        planner.add_operator(op, 0, 0)
        return planner, op, BiCGStabSolver(planner)
    finally:
        os.environ.pop("LEGIONSOLVERS_NO_FUSED_BICGSTAB", None)


@pytest.mark.parametrize("pieces,iters", [(4, 1), (4, 8), (8, 6)])
def test_fused_sharded_matches_transcription(pieces, iters, mesh4, mesh8):
    """Sharded fused BiCGStab (zero-halo passes + edge/dot fixups from
    exchanged input halos) vs the transcription across shard boundaries."""
    mesh = mesh4 if pieces == 4 else mesh8
    shape = (16 * pieces, 128)  # 16-row local blocks: the minimum
    planner, op, solver = build_sys_sharded(shape, pieces, mesh)
    assert op.supports_fused_bicgstab
    assert solver._make_fused_runner(1) is not None
    h_fused = np.asarray(solver.solve(iters))

    planner2, op2, solver2 = build_sys_sharded(shape, pieces, mesh,
                                               no_fused=True)
    h_ref = np.asarray(solver2.solve(iters))
    np.testing.assert_allclose(h_fused, h_ref, rtol=3e-3)
    x1 = planner.sol_vectors[0].to_numpy()
    x2 = planner2.sol_vectors[0].to_numpy()
    np.testing.assert_allclose(x1, x2, rtol=0, atol=5e-3 * np.abs(x2).max())


def test_fused_sharded_matches_single_shard(mesh4):
    """The SAME problem sharded vs unsharded through the fused path (any
    fixup algebra error shows up as a shard-boundary artifact)."""
    shape = (128, 128)
    p4, op4, s4 = build_sys_sharded(shape, 4, mesh4)
    assert op4.supports_fused_bicgstab
    h4 = np.asarray(s4.solve(7))
    p1, op1, s1 = build_sys_sharded(shape, 1, None)
    h1 = np.asarray(s1.solve(7))
    # f32 BiCGStab amplifies reduction-order differences (psum of shard
    # partials vs one flat sum); 0.5% envelope like the other comparisons
    np.testing.assert_allclose(h4, h1, rtol=5e-3)
    x4 = p4.sol_vectors[0].to_numpy()
    x1 = p1.sol_vectors[0].to_numpy()
    np.testing.assert_allclose(x4, x1, rtol=0, atol=5e-3 * np.abs(x1).max())


def test_fused_3d_matches_transcription():
    """The plane-streaming 3-D fused BiCGStab (bicgstab3d.py) vs the
    transcription on a 3-D 7-pt system."""
    import os

    from legionsolvers_tpu import (
        BlockPartition,
        BiCGStabSolver,
        PartitionedVector,
        SolverOptions,
        SquarePlanner,
        StencilOperator,
        laplacian_stencil,
    )
    from legionsolvers_tpu.utils.roofline import solver_bytes_per_iteration

    F32 = SolverOptions(entry_dtype=jnp.float32)
    shape = (8, 16, 128)
    n = 8 * 16 * 128

    def build(no_fused):
        if no_fused:
            os.environ["LEGIONSOLVERS_NO_FUSED_BICGSTAB"] = "1"
        try:
            part = BlockPartition(n, 1)
            op = StencilOperator(shape, laplacian_stencil(3),
                                 partition=part, mesh=None, options=F32)
            pl_ = SquarePlanner(mesh=None, options=F32)
            gs = shape if op.uses_grid_view else None
            pl_.add_sol_vector(PartitionedVector(
                "s", part, options=F32, grid_shape=gs).zero_fill())
            pl_.add_rhs_vector(PartitionedVector(
                "b", part, options=F32, grid_shape=gs).constant_fill(1.0))
            pl_.add_operator(op, 0, 0)
            return pl_, op, BiCGStabSolver(pl_)
        finally:
            os.environ.pop("LEGIONSOLVERS_NO_FUSED_BICGSTAB", None)

    p1, op1, s1 = build(False)
    assert op1.supports_fused_bicgstab
    _, sched = solver_bytes_per_iteration(s1, n)
    assert sched == "bicgstab_fused3d"
    h1 = np.asarray(s1.solve(8))
    p2, _, s2 = build(True)
    h2 = np.asarray(s2.solve(8))
    np.testing.assert_allclose(h1, h2, rtol=3e-3)
    x1 = p1.sol_vectors[0].to_numpy()
    x2 = p2.sol_vectors[0].to_numpy()
    np.testing.assert_allclose(x1, x2, rtol=0, atol=5e-3 * np.abs(x2).max())
