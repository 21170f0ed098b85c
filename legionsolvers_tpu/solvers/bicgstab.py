"""BiCGStab solver (preconditioner-free).

Transcription of the reference's ``BiCGStabSolver<T>``
(reference: BiCGStabSolver.hpp:13-84) onto the JAX planner: same vector
indices (SOL=0, RHS=1, P=2, R=3, R_TILDE=4, U=5, V=6), same rho/alpha/omega
recurrences carried as deferred Scalars, two matvecs per step.  ``solve``
compiles the iteration once and scans it, tracking ||r||^2 per step.

Numerics note (PROFILE_r04.md §4-5, revising PROFILE_r03): at large n the
f32 trajectory is sensitive to the REDUCTION ORDER of the carried dots
(a tile-size change alone splits trajectories by iteration ~6).  With
``SolverOptions.compensated_dots`` the dots carry two-float accumulation
(ops/ddsum.py) and the solve is exactly reproducible across reduction
orders (measured bit-identical over 30 iterations at n=16.7M).  Distinct
ALGORITHMS (fused vs transcription) still diverge through vector-level
f32 rounding amplified by the recurrence — inherent to f32 vectors; the
reference runs f64 end-to-end, so for convergence-critical work at scale
use compensated dots plus, if needed, the f64 CPU path.
"""

from __future__ import annotations

from typing import List

import jax
import jax.numpy as jnp

from ..core.scalar import Scalar
from ..planner import SquarePlanner


class BiCGStabSolver:
    SOL = 0
    RHS = 1
    P = 2
    R = 3
    R_TILDE = 4
    U = 5
    V = 6

    def __init__(self, planner: SquarePlanner):
        self.planner = planner
        planner.allocate_workspace(5)
        planner.copy(self.R, self.RHS)
        planner.copy(self.R_TILDE, self.RHS)
        dtype = planner.options.entry_dtype
        one = Scalar(jnp.asarray(1.0, dtype))
        zero = Scalar(jnp.asarray(0.0, dtype))
        self.rho: List[Scalar] = [one]
        self.alpha: List[Scalar] = [zero]
        self.omega: List[Scalar] = [one]
        planner.zero_fill(self.P)
        planner.zero_fill(self.V)
        self._solve_cache = {}

    def reset(self) -> None:
        """Re-derive the workspace state from the CURRENT sol/rhs vectors
        (the constructor's initialization without reallocating; assumes the
        caller zero-fills the solution vector for a from-scratch restart)."""
        planner = self.planner
        planner.copy(self.R, self.RHS)
        planner.copy(self.R_TILDE, self.RHS)
        dtype = planner.options.entry_dtype
        self.rho = [Scalar(jnp.asarray(1.0, dtype))]
        self.alpha = [Scalar(jnp.asarray(0.0, dtype))]
        self.omega = [Scalar(jnp.asarray(1.0, dtype))]
        planner.zero_fill(self.P)
        planner.zero_fill(self.V)

    def step(self) -> None:
        """One BiCGStab iteration (reference: BiCGStabSolver.hpp:64-82)."""
        planner = self.planner
        rho_new = planner.dot(self.R, self.R_TILDE)
        beta = (rho_new / self.rho[-1]) * (self.alpha[-1] / self.omega[-1])
        self.rho.append(rho_new)
        planner.axpy(self.P, -self.omega[-1], self.V)
        planner.xpay(self.P, beta, self.R)
        planner.matvec(self.V, self.P)
        temp = planner.dot(self.R_TILDE, self.V)
        planner.axpy(self.R, Scalar(-1.0), self.rho[-1], temp, self.V)
        self.alpha.append(self.rho[-1] / temp)
        # U = A R with <R, A R> fused into the SpMV pass (saves re-reading
        # R and U for the omega numerator; planner falls back to
        # matvec + dot when the operator can't fuse)
        r_anorm2 = planner.matvec_dot(self.U, self.R)
        u_norm2 = planner.dot(self.U, self.U)
        self.omega.append(r_anorm2 / u_norm2)
        planner.axpy(self.SOL, self.alpha[-1], self.P)
        planner.axpy(self.SOL, self.omega[-1], self.R)
        planner.axpy(self.R, -self.omega[-1], self.U)

    def residual_norm_squared(self) -> Scalar:
        return self.planner.dot(self.R, self.R)

    def _make_fused_runner(self, num_iterations: int):
        """Fused whole-iteration runner (three passes, 60 B/unknown;
        ops/grid2d.py, ops/grid3d.py) for single-space systems driven by one
        diagonal-block operator that supports it.  ``r~`` is passed as the
        RHS data directly (R_TILDE is always a copy of b in this solver, so
        its workspace slot stays unmaterialized).  Returns None when the
        topology doesn't allow fusion."""
        from ..parallel.block_fused import diagonal_block_ops

        planner = self.planner
        ops = diagonal_block_ops(planner)
        if ops is None:
            return None
        donate = getattr(self, "donate_workspace", False)
        if planner.num_spaces == 1:
            op = ops[0]
            if not getattr(op, "supports_fused_bicgstab", False):
                return None
            return op.make_fused_bicgstab_runner(num_iterations,
                                                 donate=donate)
        from ..parallel.block_fused import (
            block_bicgstab_supported,
            make_block_bicgstab_runner,
        )

        if not block_bicgstab_supported(ops) or num_iterations < 1:
            return None
        return make_block_bicgstab_runner(ops, num_iterations, donate=donate)

    def solve(self, num_iterations: int, use_jit: bool = True) -> jnp.ndarray:
        """Scan ``num_iterations`` compiled steps; returns the ||r||^2 history
        (length num_iterations + 1, starting with the initial residual).

        Single-space single-operator stencil systems run on the fused
        three-pass schedule (15 vector passes/iteration vs 24 for the
        transcription); the U workspace vector is then left untouched (s and
        t = A s are never stored)."""
        self.planner.to_solver_basis()
        try:
            return self._solve_in_basis(num_iterations, use_jit)
        finally:
            self.planner.from_solver_basis()

    def _solve_in_basis(self, num_iterations, use_jit):
        planner = self.planner
        if use_jit and num_iterations >= 1:
            fkey = (num_iterations, "fused",
                    getattr(self, "donate_workspace", False))
            if fkey not in self._solve_cache:
                self._solve_cache[fkey] = self._make_fused_runner(
                    num_iterations
                )
            frun = self._solve_cache[fkey]
            if frun is not None:
                nsp = planner.num_spaces
                xv = [planner.get_vector(self.SOL, i) for i in range(nsp)]
                rv = [planner.get_vector(self.R, i) for i in range(nsp)]
                pv = [planner.get_vector(self.P, i) for i in range(nsp)]
                vv = [planner.get_vector(self.V, i) for i in range(nsp)]
                rt = [planner.get_vector(self.RHS, i) for i in range(nsp)]
                if getattr(self, "donate_workspace", False):
                    from .cg import _unshare_for_donation

                    _unshare_for_donation(
                        (*xv, *rv, *pv, *vv), *rt,
                        *(planner.get_vector(self.R_TILDE, i)
                          for i in range(nsp)),
                    )
                scalars = (self.rho[-1].value, self.alpha[-1].value,
                           self.omega[-1].value)
                if nsp == 1:
                    (xd, rd, pd, vd, rho, alpha, omega, history) = frun(
                        xv[0].data, rv[0].data, pv[0].data, vv[0].data,
                        rt[0].data, *scalars,
                    )
                    xd, rd, pd, vd = (xd,), (rd,), (pd,), (vd,)
                else:
                    (xd, rd, pd, vd, rho, alpha, omega, history) = frun(
                        tuple(v.data for v in xv),
                        tuple(v.data for v in rv),
                        tuple(v.data for v in pv),
                        tuple(v.data for v in vv),
                        tuple(v.data for v in rt),
                        *scalars,
                    )
                for i in range(nsp):
                    xv[i].data, rv[i].data = xd[i], rd[i]
                    pv[i].data, vv[i].data = pd[i], vd[i]
                dtype = planner.options.entry_dtype
                self.rho = [Scalar(jnp.asarray(rho, dtype))]
                self.alpha = [Scalar(jnp.asarray(alpha, dtype))]
                self.omega = [Scalar(jnp.asarray(omega, dtype))]
                return history

        def body(i, carry):
            state, rho, alpha, omega, history = carry
            planner.load_state(state)
            self.rho = [Scalar(rho)]
            self.alpha = [Scalar(alpha)]
            self.omega = [Scalar(omega)]
            self.step()
            rr = self.residual_norm_squared().value
            history = history.at[i + 1].set(rr)
            return (
                planner.dump_state(),
                self.rho[-1].value,
                self.alpha[-1].value,
                self.omega[-1].value,
                history,
            )

        rr0 = self.residual_norm_squared().value

        # fori_loop + in-place history, not lax.scan (see CGSolver.solve)
        def run_impl(state, scalars, rr0):
            rho, alpha, omega = scalars
            history = jnp.zeros(num_iterations + 1, dtype=jnp.asarray(rr0).dtype)
            history = history.at[0].set(rr0)
            return jax.lax.fori_loop(
                0, num_iterations, body, (state, rho, alpha, omega, history)
            )

        key = (num_iterations, use_jit)
        run = self._solve_cache.get(key)
        if run is None:
            run = jax.jit(run_impl) if use_jit else run_impl
            self._solve_cache[key] = run
        final_state, rho, alpha, omega, history = run(
            planner.dump_state(),
            (self.rho[-1].value, self.alpha[-1].value, self.omega[-1].value),
            rr0,
        )
        planner.load_state(final_state)
        self.rho = [Scalar(rho)]
        self.alpha = [Scalar(alpha)]
        self.omega = [Scalar(omega)]
        return history
