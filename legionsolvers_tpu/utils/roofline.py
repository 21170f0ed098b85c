"""Shared memory-traffic model for solver benchmarks.

One bytes-per-iteration accounting used by BOTH benchmark drivers (bench.py
and legionsolvers_tpu/benchmark.py) so they report the same "% of streaming
roofline" for the same configuration — the analog of the reference's single
ms/iteration metric definition (reference: test/BenchmarkStencil.cpp:255-262,
bench_all.py:206).

The model counts device-memory bytes moved per *unknown* per iteration for the schedule
the solver will actually execute, assuming the matrix-free stencil operator
(O(1) matrix bytes).  Vector element size is taken from the dtype.  Counts
are per logical pass: each vector read or write of length n costs
``n * itemsize``; passes the implementation provably fuses are counted once.

CG schedules (see solvers/cg.py, parallel/stencil_op.py):

* ``fused2d_x2`` — s-step (s=2) schedule: ONE kernel pass per TWO CG
  iterations (read x/r/p, write x/r/p; Ap, A^2p, Ar and the next step's
  Gram matrix never stored) -> 6 passes / 2 iters = 12 B/unknown at f32.
* ``fused2d`` / ``fused3d`` — two passes/iter: xpay_pq (read r + p_old,
  write p = 3 passes) + update (read p/x/r, write x/r = 5); q = A p never
  stored -> 8 passes = 32 B/unknown at f32.
* ``fused_jnp`` — whole-loop jnp runner: matvec+pq dot (read p, write q,
  dot reuses the pass: 2), x axpy (3), r axpy (3), rr dot (1), p xpay (3)
  = 12 passes = 48 B/unknown.
* ``classic``  — step()-per-iteration with a separate p.q dot pass (2 more
  reads) = 14 passes = 56 B/unknown.

BiCGStab (solvers/bicgstab.py ``step``, assuming XLA fuses the adjacent
axpy/xpay pairs): rho dot (2), p update (4), matvec V (2),
r_tilde.V dot (2), R axpy (3), U = A R via matvec_dot with <R, U> fused
into the kernel (2), U.U dot (1), two SOL axpys (4), R axpy (3), residual
dot (1) = 24 passes = 96 B/unknown when the operator fuses SpMV+dot, 25
passes (separate <R, U> read-pass) otherwise.

GMRES(m) per cycle (solvers/gmres.py ``step``): residual matvec + xpay +
dot + scal (2+3+1+3 = 9); Arnoldi j = 0..m-1: matvec (2), j+1 dots (2 each),
j+1 axpys (3 each), norm dot (1), scal (3) -> sum = m*6 + 5*m(m+1)/2 - ...
computed exactly in :func:`gmres_passes`; solution update m axpys (3m).
"""

from __future__ import annotations

CG_PASSES = {
    "fused2d_x2": 3,  # s-step: read x/r/p + write x/r/p per TWO iterations
    "fused2d": 8,     # xpay_pq (12) + update (20)
    "fused3d": 8,
    "fused_jnp": 12,
    "classic": 14,
}


def _sstep_refresh_passes() -> float:
    """Amortized extra passes PER ITERATION for the s-step drift guard
    (a gram2 re-measurement — 2 read passes — every REFRESH step2 passes,
    each pass covering 2 iterations; see
    StencilOperator._make_step2_cg_runner)."""
    import os

    refresh = int(os.environ.get("LEGIONSOLVERS_SSTEP_REFRESH", "16"))
    return 1.0 / refresh if refresh > 0 else 0.0


def operator_matvec_passes(op) -> int:
    """Vector-length passes one y = A x costs for this operator: read x
    + write y = 2 for matrix-free stencils; + D coefficient streams for the
    explicit-DIA operator; + 2L index/value streams for the ELL layout."""
    if type(op).__name__ == "DiaOperator":
        return 2 + len(op.flat_offsets)
    if type(op).__name__ == "RowPartitionedMatrix":
        return 2 + 2 * op.row_length
    return 2


def _op_cg_kind(op) -> str:
    """Per-operator fused-CG schedule label."""
    view = getattr(op, "_view", None)
    if view is None:
        return "fused_jnp"
    if view.get("kind") == "3d":
        return "fused3d"
    # the s-step schedule needs >= 2 iterations; benchmark runs always
    # qualify, a single step() falls back to fused2d with the same
    # marginal traffic rounding
    if getattr(op, "step2_eligible", False):
        return "fused2d_x2"
    return "fused2d"


def cg_schedule(solver) -> str:
    """Which CG schedule ``solver.solve()`` will execute, by the same
    capability probes CGSolver._make_fused_runner / StencilOperator use.
    Block-diagonal multi-space systems (parallel/block_fused.py) run the
    per-space schedule with identical per-unknown traffic, so they report
    the same label."""
    planner = solver.planner
    from ..parallel.block_fused import block_cg_supported, diagonal_block_ops

    ops = diagonal_block_ops(planner)
    if ops is not None and all(
        getattr(op, "supports_fused_cg", False) for op in ops
    ):
        if planner.num_spaces == 1 or block_cg_supported(ops):
            kinds = {_op_cg_kind(op) for op in ops}
            if len(kinds) > 1:
                # mixed per-space schedules: s-step needs ALL spaces
                # eligible, so the block runner runs the two-pass family;
                # charge the most expensive member
                kinds.discard("fused2d_x2")
            return max(kinds, key=lambda k: CG_PASSES[k])
    # step()-per-iteration path: the p.q reduction is fused into the SpMV
    # pass when every operator supports matvec_dot
    fusable = all(
        getattr(op, "supports_matvec_dot", False)
        for op, _, _ in planner.row_partitioned_matrices
    )
    return "fused_jnp" if fusable else "classic"


def cg_bytes_per_unknown(schedule: str, itemsize: int = 4) -> float:
    return CG_PASSES[schedule] * itemsize


def bicgstab_bytes_per_unknown(itemsize: int = 4, fused: bool = True) -> float:
    return (24 if fused else 25) * itemsize


def gmres_passes(m: int) -> int:
    """Vector passes per GMRES(m) cycle for the MGS planner transcription
    (see module docstring)."""
    passes = 9  # residual: matvec(2) + xpay(3) + dot(1) + scal(3)
    for j in range(m):
        passes += 2            # matvec
        passes += 2 * (j + 1)  # MGS dots
        passes += 3 * (j + 1)  # MGS axpys
        passes += 1            # norm dot
        if j + 1 < m:
            passes += 3        # scal
    passes += 3 * m            # solution update axpys
    return passes


def gmres_cgs2_passes(m: int) -> int:
    """Vector passes per GMRES(m) cycle for the batched CGS2 fast path
    (solvers/gmres.py ``_make_fused_runner``): residual (read x + b, write
    V0 = 3 + matvec); per Arnoldi step j: matvec (2), two projection
    matmuls + two rank-update matmuls (4 sweeps of the j+1 basis rows plus
    ~4 reads of w), norm + scaled write of V[j+1] (2); solution update
    (read V[:m] + x, write x)."""
    passes = 4
    for j in range(m):
        passes += 2 + 4 * (j + 1) + 4 + 2
    passes += m + 2
    return passes


def gmres_bytes_per_cycle_per_unknown(m: int, itemsize: int = 4) -> float:
    return gmres_passes(m) * itemsize


def solver_bytes_per_iteration(solver, n: int) -> tuple[float, str]:
    """(bytes per iteration for the whole system, schedule label) for any of
    the three solver classes.  ``n`` is the total unknown count (all spaces)."""
    import jax.numpy as jnp

    itemsize = jnp.dtype(solver.planner.options.entry_dtype).itemsize
    name = type(solver).__name__
    ops = [op for op, _, _ in solver.planner.row_partitioned_matrices]
    # extra streams beyond the matrix-free 2-pass matvec (DIA coefficients,
    # ELL index/value slabs), charged once per matvec in the schedule
    extra = max((operator_matvec_passes(op) - 2 for op in ops), default=0)
    if name == "PCGSolver":
        # the naive pass count is 17 (matvec_dot 2, x axpy 3, r axpy 3,
        # z apply 3, rz dot 2, rr dot 1, p xpay 3), but XLA fuses the
        # elementwise tail into the matvec/update passes: 6 passes (24
        # B/unknown at f32) is the least the step can move.
        return (6 + 2 * extra) * itemsize * n, "pcg_jacobi"
    if name == "CGSolver":
        sched = cg_schedule(solver)
        passes = CG_PASSES[sched] + (extra if sched in ("fused_jnp", "classic") else 0)
        if sched == "fused2d_x2":
            passes = passes + _sstep_refresh_passes()
        label = sched if extra == 0 else f"{sched}+{extra}"
        return passes * itemsize * n, label
    if name == "BiCGStabSolver":
        planner = solver.planner
        from ..parallel.block_fused import (
            block_bicgstab_supported,
            diagonal_block_ops,
        )

        # three-pass schedule (ops/grid2d.py bicg_*): pv 6 +
        # st 2 + upd 7 = 15 passes (60 B/unknown at f32); block systems
        # run it per space (same per-unknown traffic) when every space's
        # operator supports it
        dops = diagonal_block_ops(planner)
        if (
            dops is not None
            and all(getattr(op, "supports_fused_bicgstab", False)
                    for op in dops)
            and (planner.num_spaces == 1 or block_bicgstab_supported(dops))
        ):
            kind = getattr(dops[0], "_view", None) or {}
            label = ("bicgstab_fused3d" if kind.get("kind") == "3d"
                     else "bicgstab_fused2d")
            return 15 * itemsize * n, label
        fused = all(
            getattr(op, "supports_matvec_dot", False) for op in ops
        ) and len(ops) == solver.planner.num_spaces
        passes = (24 if fused else 25) + 2 * extra
        return passes * itemsize * n, ("bicgstab_fused" if fused else "bicgstab")
    if name == "GMRESSolver":
        m = solver.restart
        fused = solver._make_fused_runner(1) is not None
        base = gmres_cgs2_passes(m) if fused else gmres_passes(m)
        passes = base + extra * (m + 1)  # m+1 matvecs per cycle
        label = f"gmres{m}_cgs2" if fused else f"gmres{m}_mgs"
        return passes * itemsize * n, label
    raise ValueError(f"no traffic model for {name}")

