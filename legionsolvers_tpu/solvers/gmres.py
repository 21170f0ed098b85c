"""GMRES(m) with restarts — Arnoldi via modified Gram-Schmidt + Givens solve.

The Arnoldi process is a transcription of the reference's ``GMRESSolver<T>``
(reference: GMRESSolver.hpp:15-129): workspace = restart+1 Krylov basis
vectors at planner indices ``krylov_basis(i) = i + 2``, modified Gram-Schmidt
with the Hessenberg entries carried as deferred Scalars, last basis vector
left unnormalized.

The least-squares update is NOT in the reference — it launches a DummyTask
and uses the constant-1 future as every coefficient (GMRESSolver.hpp:109-126;
its ``triangular_matrix``/``coefficients`` members are allocated but unused).
Here the small (m+1) x m Hessenberg solve is implemented for real with Givens
rotations on device: m is static, so the rotation loop unrolls into the same
single jitted step as everything else and costs O(m^2) scalar flops.
"""

from __future__ import annotations

from typing import List

import jax
import jax.numpy as jnp

from ..core.scalar import Scalar, ScalarHistory
from ..planner import SquarePlanner


def _least_squares_givens(H: jnp.ndarray, beta: jnp.ndarray) -> jnp.ndarray:
    """Solve min_y || beta * e1 - H y ||_2 for the (m+1) x m Hessenberg H via
    Givens rotations + back-substitution.  Zero subdiagonals (lucky breakdown)
    and zero diagonals (stagnation) are guarded so the result stays finite."""
    m = H.shape[1]
    R = H
    g = jnp.zeros(m + 1, dtype=H.dtype).at[0].set(beta)
    for i in range(m):
        a = R[i, i]
        b = R[i + 1, i]
        denom = jnp.sqrt(a * a + b * b)
        safe = denom > 0
        c = jnp.where(safe, a / jnp.where(safe, denom, 1), 1.0)
        s = jnp.where(safe, b / jnp.where(safe, denom, 1), 0.0)
        row_i = c * R[i, :] + s * R[i + 1, :]
        row_i1 = -s * R[i, :] + c * R[i + 1, :]
        R = R.at[i, :].set(row_i).at[i + 1, :].set(row_i1)
        gi = c * g[i] + s * g[i + 1]
        gi1 = -s * g[i] + c * g[i + 1]
        g = g.at[i].set(gi).at[i + 1].set(gi1)
    # back-substitution on the upper-triangular m x m block
    y = jnp.zeros(m, dtype=H.dtype)
    for i in range(m - 1, -1, -1):
        resid = (g[i] - jnp.dot(R[i, i + 1 :], y[i + 1 :],
                                precision=jax.lax.Precision.HIGHEST)
                 if i + 1 < m else g[i])
        diag = R[i, i]
        y = y.at[i].set(jnp.where(jnp.abs(diag) > 0, resid / jnp.where(jnp.abs(diag) > 0, diag, 1), 0.0))
    return y


class GMRESSolver:
    SOL = 0
    RHS = 1

    def __init__(self, planner: SquarePlanner, restart: int):
        self.planner = planner
        self.restart = int(restart)
        planner.allocate_workspace(self.restart + 1)
        self.inner_products: List[List[Scalar]] = [
            [Scalar(jnp.zeros((), planner.options.entry_dtype))] * self.restart
            for _ in range(self.restart + 1)
        ]
        self.residual_norm_squared: List[Scalar] = []
        self._solve_cache = {}

    def krylov_basis(self, i: int) -> int:
        """reference: GMRESSolver.hpp:80-82."""
        return i + 2

    def reset(self) -> None:
        """Clear the recorded Hessenberg/residual state (GMRES re-derives
        everything else from sol/rhs at the start of each cycle)."""
        self.inner_products = [
            [Scalar(jnp.zeros((), self.planner.options.entry_dtype))]
            * self.restart
            for _ in range(self.restart + 1)
        ]
        self.residual_norm_squared = []

    def step(self) -> None:
        """One GMRES(m) cycle: residual, Arnoldi, least-squares update
        (reference: GMRESSolver.hpp:84-127, with the real solve)."""
        planner = self.planner
        kb = self.krylov_basis
        m = self.restart

        # residual vector r = b - A x in basis slot 0
        planner.matvec(kb(0), self.SOL)
        planner.xpay(kb(0), Scalar(-1.0), self.RHS)
        beta2 = planner.dot(kb(0), kb(0))
        self.residual_norm_squared.append(beta2)
        inv_norm = beta2.rsqrt()
        planner.scal(kb(0), inv_norm)

        # Arnoldi with modified Gram-Schmidt (reference: GMRESSolver.hpp:92-107)
        dtype = planner.options.entry_dtype
        H = jnp.zeros((m + 1, m), dtype=dtype)
        for j in range(m):
            planner.matvec(kb(j + 1), kb(j))
            for k in range(j + 1):
                h = planner.dot(kb(k), kb(j + 1))
                self.inner_products[k][j] = h
                H = H.at[k, j].set(h.value)
                planner.axpy(kb(j + 1), -h, kb(k))
            d = planner.dot(kb(j + 1), kb(j + 1))
            h_last = d.sqrt()
            self.inner_products[j + 1][j] = h_last
            H = H.at[j + 1, j].set(h_last.value)
            if j + 1 < m:
                # guard lucky breakdown: a zero vector stays zero
                safe = d.value > 0
                scale = jnp.where(safe, 1.0 / jnp.sqrt(jnp.where(safe, d.value, 1)), 0.0)
                planner.scal(kb(j + 1), Scalar(scale))

        # real small dense solve (replaces the reference's DummyTask stub)
        y = _least_squares_givens(H, beta2.sqrt().value)
        for j in range(m):
            planner.axpy(self.SOL, Scalar(y[j]), kb(j))

    def _make_fused_runner(self, num_cycles: int):
        """Batched-basis GMRES(m) cycle for single-space, single-operator
        systems: the Krylov basis lives in ONE (m+1, n) array and
        orthogonalization is CGS2 (classical Gram-Schmidt applied twice) —
        all j+1 projection coefficients come from a single ``V @ w`` product
        (one sweep of the basis) and the update is one
        rank-(j+1) ``h @ V`` matmul, instead of the planner path's j+1
        sequential dot+axpy round trips (reference analog: the MGS loop of
        GMRESSolver.hpp:92-107, whose per-vector task launches Legion could
        at least overlap; one jitted XLA program cannot, so it batches).  CGS2 is numerically equivalent to MGS for
        well-conditioned bases ("twice is enough", Giraud et al. 2005).
        Returns None when the topology doesn't allow it."""
        planner = self.planner
        if planner.num_spaces != 1 or len(planner.row_partitioned_matrices) != 1:
            return None
        op, di, ri = planner.row_partitioned_matrices[0]
        if di != 0 or ri != 0:
            return None
        m = self.restart
        dtype = planner.options.entry_dtype
        hi = jax.lax.Precision.HIGHEST

        def dot_all(V, w, nd):
            # (j+1,) projection coefficients in one basis sweep
            return jnp.tensordot(V, w, axes=nd, precision=hi)

        def cycle(x, b, _):
            r = b - op.matvec(x)
            nd = r.ndim
            beta2 = jnp.tensordot(r, r, axes=nd, precision=hi)
            inv_norm = jnp.where(beta2 > 0, jax.lax.rsqrt(beta2), 0.0)
            V = jnp.zeros((m + 1,) + r.shape, dtype)
            V = V.at[0].set(r * inv_norm)
            H = jnp.zeros((m + 1, m), dtype)
            for j in range(m):
                w = op.matvec(V[j])
                h1 = dot_all(V[: j + 1], w, nd)
                w = w - jnp.tensordot(h1, V[: j + 1], axes=1, precision=hi)
                h2 = dot_all(V[: j + 1], w, nd)
                w = w - jnp.tensordot(h2, V[: j + 1], axes=1, precision=hi)
                h = h1 + h2
                d = jnp.tensordot(w, w, axes=nd, precision=hi)
                h_last = jnp.sqrt(d)
                H = H.at[: j + 1, j].set(h).at[j + 1, j].set(h_last)
                scale = jnp.where(d > 0, jax.lax.rsqrt(d), 0.0)
                V = V.at[j + 1].set(w * scale)
            y = _least_squares_givens(H, jnp.sqrt(beta2))
            x = x + jnp.tensordot(y, V[:m], axes=1, precision=hi)
            return x, beta2, V, H

        def run(x, b):
            history = jnp.zeros(num_cycles, dtype)
            n_shape = x.shape
            V0 = jnp.zeros((m + 1,) + n_shape, dtype)
            H0 = jnp.zeros((m + 1, m), dtype)

            def body(i, carry):
                x, _, _, history = carry
                x, beta2, V, H = cycle(x, b, i)
                return x, V, H, history.at[i].set(beta2)

            # the final cycle's basis and Hessenberg ride out of the loop so
            # solve() can reconcile the planner workspace / inner_products
            # with the transcription path's observable state
            return jax.lax.fori_loop(
                0, num_cycles, body, (x, V0, H0, history)
            )

        return jax.jit(run)

    def solve(self, num_cycles: int, use_jit: bool = True) -> jnp.ndarray:
        """Run ``num_cycles`` restart cycles as one scanned loop; returns the
        ||r||^2 measured at the start of each cycle plus the final residual
        (length num_cycles + 1).

        Single-space single-operator systems run on the batched CGS2 fast
        path (:meth:`_make_fused_runner`); its Hessenberg entries differ
        from the MGS transcription only by f32 rounding.  Observable state
        after ``solve()`` matches the transcription path: the workspace
        basis vectors hold the final cycle's Krylov basis and
        ``inner_products`` holds its Hessenberg entries — with one
        documented difference: the last basis vector (slot ``restart``) is
        normalized on the fast path, while the MGS transcription leaves it
        unnormalized (reference: GMRESSolver.hpp:92-107 never rescales the
        final vector)."""
        self.planner.to_solver_basis()
        try:
            return self._solve_in_basis(num_cycles, use_jit)
        finally:
            self.planner.from_solver_basis()

    def _solve_in_basis(self, num_cycles, use_jit):
        planner = self.planner
        if use_jit and num_cycles >= 1:
            fkey = (num_cycles, "fused")
            if fkey not in self._solve_cache:
                self._solve_cache[fkey] = self._make_fused_runner(num_cycles)
            frun = self._solve_cache[fkey]
            if frun is not None:
                xv = planner.get_vector(self.SOL, 0)
                bv = planner.get_vector(self.RHS, 0)
                x_new, V, H, history = frun(xv.data, bv.data)
                xv.data = x_new
                # reconcile observable state with the transcription path:
                # basis slots 1..m hold the final cycle's Krylov basis ...
                for i in range(1, self.restart + 1):
                    planner.get_vector(self.krylov_basis(i), 0).data = V[i]
                # lazy rows: no per-element device dispatch unless read
                self.inner_products = [
                    ScalarHistory(H[k]) for k in range(self.restart + 1)
                ]
                self.residual_norm_squared = ScalarHistory(history)
                # ... and slot 0 the closing unnormalized residual, exactly
                # like the transcription path's final matvec/xpay below
                op = planner.row_partitioned_matrices[0][0]
                r = bv.data - op.matvec(x_new)
                planner.get_vector(self.krylov_basis(0), 0).data = r
                nd = r.ndim
                rr_final = jnp.tensordot(
                    r, r, axes=nd, precision=jax.lax.Precision.HIGHEST
                )
                return jnp.concatenate(
                    [history, jnp.reshape(rr_final, (1,))]
                )

        m = self.restart
        dtype = planner.options.entry_dtype

        def body(i, carry):
            state, H, history = carry
            planner.load_state(state)
            self.residual_norm_squared = []
            self.step()
            # thread the Hessenberg through the carry: step()'s Scalars are
            # trace-local and would leak as dead tracers otherwise
            H = jnp.stack([
                jnp.stack([
                    jnp.asarray(self.inner_products[k][j].value, dtype)
                    for j in range(m)
                ])
                for k in range(m + 1)
            ])
            history = history.at[i].set(self.residual_norm_squared[0].value)
            return planner.dump_state(), H, history

        # fori_loop + in-place history, not lax.scan (see CGSolver.solve)
        def run_impl(state):
            history = jnp.zeros(num_cycles, dtype=dtype)
            H0 = jnp.zeros((m + 1, m), dtype=dtype)
            return jax.lax.fori_loop(
                0, num_cycles, body, (state, H0, history)
            )

        key = (num_cycles, use_jit)
        run = self._solve_cache.get(key)
        if run is None:
            run = jax.jit(run_impl) if use_jit else run_impl
            self._solve_cache[key] = run
        final_state, H, history = run(planner.dump_state())
        planner.load_state(final_state)
        self.inner_products = [ScalarHistory(H[k]) for k in range(m + 1)]
        # closing residual after the last cycle
        planner.matvec(self.krylov_basis(0), self.SOL)
        planner.xpay(self.krylov_basis(0), Scalar(-1.0), self.RHS)
        rr_final = planner.dot(self.krylov_basis(0), self.krylov_basis(0)).value
        return jnp.concatenate([history, jnp.reshape(rr_final, (1,))])
