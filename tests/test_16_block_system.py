"""Block-system (multi-space) planner tests.

The reference's benchmark registers the same matrix twice over 2 sol/rhs
spaces (reference: test/BenchmarkStencil.cpp:201-207) — a block-diagonal
system diag(A, A) whose CG scalars couple the two spaces through summed dot
products (reference: SquarePlanner.hpp:331-338).  Nothing in the reference's
test suite exercises it numerically; these tests pin the semantics:

* identical rhs in both spaces => every dot doubles, so alpha/beta ratios are
  unchanged and the residual^2 history is exactly 2x the single-space golden;
* distinct rhs => CG on the SPD block-diagonal operator still converges to
  the true solution of each block;
* the fused matvec_dot path and its explicit capability-query fallback agree.
"""

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
    coo_negative_laplacian_1d,
    laplacian_stencil,
)

F64 = SolverOptions(entry_dtype=jnp.float64)
GOLDEN = [100, 4900, 4704, 4512, 4324, 4140, 3960, 3784, 3612, 3444, 3280]


def build_block_planner(n, pieces, mesh, num_spaces=2, explicit=False,
                        rhs_vals=None):
    part = BlockPartition(n, pieces)
    planner = SquarePlanner(mesh=mesh, options=F64)
    for i in range(num_spaces):
        sol = PartitionedVector(f"sol{i}", part, mesh=mesh, options=F64)
        sol.zero_fill()
        planner.add_sol_vector(sol)
    for i in range(num_spaces):
        if rhs_vals is None:
            rhs = PartitionedVector(f"rhs{i}", part, mesh=mesh, options=F64)
            rhs.constant_fill(1.0)
        else:
            rhs = PartitionedVector.from_array(
                f"rhs{i}", rhs_vals[i], part, mesh=mesh, options=F64
            )
        planner.add_rhs_vector(rhs)
    if explicit:
        A = coo_negative_laplacian_1d(n, options=F64)
        for i in range(num_spaces):
            planner.add_row_partitioned_matrix(A, i, i)
    else:
        op = StencilOperator((n,), laplacian_stencil(1), partition=part,
                             mesh=mesh, options=F64)
        for i in range(num_spaces):
            planner.add_operator(op, i, i)
    return planner


@pytest.mark.parametrize("explicit", [False, True])
@pytest.mark.parametrize("pieces", [1, 4])
def test_block_cg_doubles_golden(explicit, pieces, mesh4):
    """Same matrix + same rhs registered over 2 spaces: the CG residual^2
    history is exactly 2x the n=100 golden (all dots double, ratios
    unchanged), and both solution blocks equal the single-space solution."""
    mesh = mesh4 if pieces == 4 else None
    planner = build_block_planner(100, pieces, mesh, explicit=explicit)
    solver = CGSolver(planner)
    hist = np.asarray(solver.solve(10))
    assert hist.tolist() == [2 * g for g in GOLDEN]
    x0 = np.asarray(planner.get_vector(0, 0).data)[:100]
    x1 = np.asarray(planner.get_vector(0, 1).data)[:100]
    np.testing.assert_array_equal(x0, x1)


def test_block_cg_distinct_rhs(mesh4):
    """Distinct rhs per space: CG on diag(A, A) converges to each block's
    true solution."""
    n = 64
    rng = np.random.default_rng(7)
    b0, b1 = rng.random(n), rng.random(n)
    planner = build_block_planner(n, 4, mesh4, rhs_vals=[b0, b1])
    solver = CGSolver(planner)
    solver.solve(2 * n)  # exact in <= n iterations per block (fp64)
    from tests.test_08_stencil import dense_stencil

    A = dense_stencil((n,), laplacian_stencil(1))
    for i, b in enumerate([b0, b1]):
        x = np.asarray(planner.get_vector(0, i).data)[:n]
        np.testing.assert_allclose(x, np.linalg.solve(A, b), rtol=1e-8)


def test_block_bicgstab_converges(mesh4):
    """BiCGStab over the 2-space block system drives the residual down."""
    n = 100
    planner = build_block_planner(n, 4, mesh4)
    solver = BiCGStabSolver(planner)
    solver.solve(80)
    # residual check directly: b - A x per space
    from tests.test_08_stencil import dense_stencil

    A = dense_stencil((n,), laplacian_stencil(1))
    for i in range(2):
        x = np.asarray(planner.get_vector(0, i).data)[:n]
        res = np.linalg.norm(np.ones(n) - A @ x)
        assert res < 1e-6


def test_block_matvec_dot_matches_fallback(mesh4):
    """planner.matvec_dot over 2 spaces (fused where supported) must equal
    the explicit matvec + dot fallback."""
    n = 100
    planner = build_block_planner(n, 4, mesh4)
    solver = CGSolver(planner)
    P, Q = solver.P, solver.Q
    pq_fused = float(planner.matvec_dot(Q, P).value)
    q_fused = [np.asarray(planner.get_vector(Q, i).data) for i in range(2)]
    planner.matvec(Q, P)
    pq_ref = float(planner.dot(P, Q).value)
    q_ref = [np.asarray(planner.get_vector(Q, i).data) for i in range(2)]
    assert pq_fused == pytest.approx(pq_ref, rel=1e-14)
    for a, b in zip(q_fused, q_ref):
        np.testing.assert_allclose(a, b, rtol=1e-14)


def test_offdiagonal_matvec_dot_falls_back(mesh4):
    """An operator registered off-diagonally (domain != range space) is not
    fusable; matvec_dot must take the matvec + dot fallback and produce the
    correct coupled product (capability query, not exception dispatch)."""
    n = 64
    part = BlockPartition(n, 4)
    planner = SquarePlanner(mesh=mesh4, options=F64)
    rng = np.random.default_rng(3)
    xs = [rng.random(n), rng.random(n)]
    for i in range(2):
        planner.add_sol_vector(
            PartitionedVector(f"s{i}", part, mesh=mesh4, options=F64).zero_fill()
        )
    for i in range(2):
        planner.add_rhs_vector(
            PartitionedVector.from_array(f"b{i}", xs[i], part, mesh=mesh4,
                                         options=F64)
        )
    op = StencilOperator((n,), laplacian_stencil(1), partition=part,
                         mesh=mesh4, options=F64)
    # couple the spaces: range 0 reads domain 1 and vice versa
    planner.add_operator(op, 1, 0)
    planner.add_operator(op, 0, 1)
    planner.allocate_workspace(1)
    W = 2
    planner.copy(W, 1)  # W <- rhs
    val = float(planner.matvec_dot(W, 1).value)
    from tests.test_08_stencil import dense_stencil

    A = dense_stencil((n,), laplacian_stencil(1))
    # dst space 0 = A @ src space 1, dst space 1 = A @ src space 0
    expected = xs[0] @ (A @ xs[1]) + xs[1] @ (A @ xs[0])
    assert val == pytest.approx(expected, rel=1e-12)
    y0 = np.asarray(planner.get_vector(W, 0).data)[:n]
    np.testing.assert_allclose(y0, A @ xs[1], rtol=1e-12)


def test_benchmark_block_smoke(capsys):
    """benchmark.py --block runs end-to-end on CPU (reference stress setup)."""
    from legionsolvers_tpu.benchmark import main

    main(["-dim", "1", "-nx", "256", "-vp", "1", "-it", "1000", "--block",
          "--dtype", "float64"])
    out = capsys.readouterr().out
    assert "ms per iteration" in out


def test_benchmark_cg_donating_smoke(capsys):
    """benchmark.py -solver 1 single-space: exercises the DONATING fused
    runner with reset()-style restarts (regression: reset() shares the RHS
    buffer into P/R, and donating shared buffers tripped
    INVALID_ARGUMENT on chip — the unshare guard must materialize
    copies)."""
    from legionsolvers_tpu.benchmark import main

    main(["-dim", "2", "-nx", "16", "-ny", "128", "-solver", "1",
          "-vp", "1", "-it", "200", "--dtype", "float32"])
    out = capsys.readouterr().out
    assert "ms per iteration" in out


@pytest.mark.parametrize("solver", [2, 3, 4])
def test_benchmark_other_solvers_smoke(capsys, solver):
    """benchmark.py -solver 2|3 runs end-to-end on CPU (regression: the
    scalar-state snapshot must skip BiCGStab's residual_norm_squared METHOD,
    which broke every BiCGStab row of the round-2 on-chip matrix)."""
    from legionsolvers_tpu.benchmark import main

    main(["-dim", "1", "-nx", "256", "-solver", str(solver), "-vp", "1",
          "-it", "1000", "--dtype", "float64"])
    out = capsys.readouterr().out
    assert "ms per iteration" in out
