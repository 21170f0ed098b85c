"""Conjugate Gradient solver over the planner algebra.

Transcription of the reference's ``CGSolver<T>`` (reference: CGSolver.hpp:13-57)
onto the JAX planner: same vector indices (SOL=0, RHS=1, P=2, Q=3, R=4), same
future-ratio coefficient passing (2-future and 3-future axpy, 2-future xpay),
same residual-norm-squared history.  Where the reference's ``step()`` issues
an async task DAG per iteration, here ``step()`` traces the same DAG into XLA
and :meth:`solve` compiles the whole iteration once and drives it with
``lax.scan`` — the analog of Legion physical-trace replay
(reference: BenchmarkStencil.cpp:219-246, LegionSolversMapper.cpp:52-59).
"""

from __future__ import annotations

from typing import List

import jax
import jax.numpy as jnp

from ..core.scalar import Scalar, ScalarHistory
from ..planner import SquarePlanner


def _unshare_for_donation(vectors, *protected) -> None:
    """Ensure each vector's buffer is distinct from the others' and from
    every protected vector's (``planner.copy``/``assign`` share buffers;
    donating a shared buffer invalidates its other users or trips XLA's
    duplicate-donation check)."""
    seen = {id(v.data) for v in protected}
    for v in vectors:
        if id(v.data) in seen:
            v.data = v.data + jnp.zeros((), v.data.dtype)
        seen.add(id(v.data))


class CGSolver:
    SOL = 0
    RHS = 1
    P = 2
    Q = 3
    R = 4

    def __init__(self, planner: SquarePlanner):
        self.planner = planner
        planner.allocate_workspace(3)
        planner.copy(self.P, self.RHS)
        planner.copy(self.R, self.RHS)
        self.residual_norm_squared: List[Scalar] = [planner.dot(self.R, self.R)]
        self._solve_cache = {}

    def reset(self) -> None:
        """Re-derive the workspace state from the CURRENT sol/rhs vectors —
        the constructor's initialization without reallocating: P = R = b,
        residual history = [<b, b>].  Callers restarting a solve from
        scratch should ``zero_fill`` the solution vector first (the init
        assumes x0 = 0, like the reference's tests).  This is the
        memory-lean alternative to planner.dump_state snapshots for
        repeated benchmark runs: no second copy of every vector stays
        live, which is what bounds the max single-chip problem size."""
        planner = self.planner
        planner.copy(self.P, self.RHS)
        planner.copy(self.R, self.RHS)
        self.residual_norm_squared = [planner.dot(self.R, self.R)]

    def step(self) -> None:
        """One CG iteration (reference: CGSolver.hpp:46-55).  The q = A p
        product and the p.q reduction are fused into one kernel pass where
        the operator supports it."""
        planner = self.planner
        p_norm = planner.matvec_dot(self.Q, self.P)
        r_norm2_old = self.residual_norm_squared[-1]
        planner.axpy(self.SOL, r_norm2_old, p_norm, self.P)
        planner.axpy(self.R, Scalar(-1.0), r_norm2_old, p_norm, self.Q)
        r_norm2_new = planner.dot(self.R, self.R)
        self.residual_norm_squared.append(r_norm2_new)
        planner.xpay(self.P, r_norm2_new, r_norm2_old, self.R)

    def _make_fused_runner(self, num_iterations: int):
        """Fused whole-iteration runner.  Single space: the operator's own
        fused schedule (two-pass / s-step / 3-D, 32 / 12 B/unknown/
        iter).  Multi-space block-diagonal systems (the reference's
        benchmark stress config, BenchmarkStencil.cpp:201-207): per-space
        fused phases with cross-space scalar sums
        (parallel/block_fused.py).  Returns None when the topology doesn't
        allow fusion."""
        from ..parallel.block_fused import diagonal_block_ops

        planner = self.planner
        ops = diagonal_block_ops(planner)
        if ops is None:
            return None
        donate = getattr(self, "donate_workspace", False)
        if planner.num_spaces == 1:
            op = ops[0]
            if not getattr(op, "supports_fused_cg", False):
                return None
            try:
                return op.make_fused_cg_runner(num_iterations, donate=donate)
            except TypeError:  # operator predates the donate option
                return op.make_fused_cg_runner(num_iterations)
        from ..parallel.block_fused import (
            block_cg_supported,
            make_block_cg_runner,
        )

        if not block_cg_supported(ops) or num_iterations < 1:
            return None
        return make_block_cg_runner(ops, num_iterations, donate=donate)

    def solve(self, num_iterations: int, use_jit: bool = True) -> jnp.ndarray:
        """Run ``num_iterations`` steps as one compiled ``lax.scan`` loop.

        Returns the residual² history of length ``num_iterations + 1``
        (matching Test05's printed output, Test05COOSolveCG.cpp:84-89) and
        leaves the planner holding the final vectors.

        When the planner topology allows it, iterations run on the fused
        fused path (q = A p is never stored); the Q workspace
        vector is then left untouched rather than holding the last A p.
        """
        planner = self.planner
        # reordered-basis systems solve in the RCM basis (permute at the
        # boundaries only; no-op otherwise) — parallel/reorder.py
        planner.to_solver_basis()
        try:
            return self._solve_in_basis(num_iterations, use_jit)
        finally:
            planner.from_solver_basis()

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
                xs = [planner.get_vector(self.SOL, i) for i in range(nsp)]
                rs = [planner.get_vector(self.R, i) for i in range(nsp)]
                ps = [planner.get_vector(self.P, i) for i in range(nsp)]
                consume = getattr(self, "consume_rhs", False)
                if getattr(self, "donate_workspace", False):
                    # planner.copy shares buffers (P/R alias the RHS array
                    # after reset()); donated inputs must be distinct live
                    # buffers, and the RHS must survive — materialize
                    # copies where needed (one extra pass per solve).
                    # consume_rhs mode (the 3-live-vector max-size path,
                    # matching the reference's 2^30 1-node sizes,
                    # bench_all_ls.py:366-379) donates the RHS buffer
                    # THROUGH r instead: r = b needs no copy, and b is
                    # invalidated after the solve.
                    protected = (
                        () if consume
                        else tuple(
                            planner.get_vector(self.RHS, i)
                            for i in range(nsp)
                        )
                    )
                    _unshare_for_donation((*xs, *rs, *ps), *protected)
                rr0 = self.residual_norm_squared[-1].value
                if nsp == 1:
                    xd, rd, pd, history = frun(
                        xs[0].data, rs[0].data, ps[0].data, rr0
                    )
                    xd, rd, pd = (xd,), (rd,), (pd,)
                else:
                    xd, rd, pd, history = frun(
                        tuple(v.data for v in xs),
                        tuple(v.data for v in rs),
                        tuple(v.data for v in ps),
                        rr0,
                    )
                for i in range(nsp):
                    xs[i].data, rs[i].data, ps[i].data = xd[i], rd[i], pd[i]
                if consume and getattr(self, "donate_workspace", False):
                    for i in range(nsp):
                        planner.get_vector(self.RHS, i)._data = None
                self.residual_norm_squared = ScalarHistory(history)
                return history

        def body(i, carry):
            state, rr_old, history = carry
            planner.load_state(state)
            self.residual_norm_squared = [Scalar(rr_old)]
            self.step()
            rr_new = self.residual_norm_squared[-1].value
            history = history.at[i + 1].set(rr_new)
            return planner.dump_state(), rr_new, history

        rr0 = self.residual_norm_squared[-1].value
        # fori_loop with an in-place history buffer, not lax.scan: scan's
        # carry double-buffering costs an extra copy of every carried
        # vector per iteration
        def run_impl(state, rr0):
            history = jnp.zeros(num_iterations + 1, dtype=jnp.asarray(rr0).dtype)
            history = history.at[0].set(rr0)
            return jax.lax.fori_loop(
                0, num_iterations, body, (state, rr0, history)
            )

        # cache the compiled runner per iteration count so repeated solves
        # (and warmup-then-timed benchmark loops) replay the same executable —
        # the analog of Legion physical-trace replay
        key = (num_iterations, use_jit)
        run = self._solve_cache.get(key)
        if run is None:
            run = jax.jit(run_impl) if use_jit else run_impl
            self._solve_cache[key] = run
        final_state, _, history = run(planner.dump_state(), rr0)
        planner.load_state(final_state)
        self.residual_norm_squared = ScalarHistory(history)
        return history
