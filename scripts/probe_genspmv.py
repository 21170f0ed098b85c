"""GPU benchmark of the routed-gather general-sparsity SpMV.

Builds a random 8-nnz-per-row matrix at n = 2^20, which RCM cannot band
(bandwidth stays ~n), routes it through the planner (reorder gate ->
degree-sorted basis -> GeneralSpmvOperator), and measures matvec and
CG-iteration marginal times.

Usage: python scripts/probe_genspmv.py   (one device process only)
"""

from __future__ import annotations

import sys
import time

import numpy as np

sys.path.insert(0, ".")

import jax
import jax.numpy as jnp

from legionsolvers_tpu import (
    BlockPartition,
    CGSolver,
    PartitionedVector,
    SolverOptions,
    SquarePlanner,
)
from legionsolvers_tpu.core.matrix import COOMatrix
from legionsolvers_tpu.parallel.genspmv import GeneralSpmvOperator
from legionsolvers_tpu.parallel.reorder import ReorderedOperator
from legionsolvers_tpu.utils.timing import marginal_seconds_per_iter

N = 1 << 20
AVG = 4  # + symmetrization + diagonal -> ~8 stored nnz/row


def main():
    opt = SolverOptions(entry_dtype=jnp.float32)
    rng = np.random.default_rng(1)
    m = N * AVG
    rows = rng.integers(0, N, m)
    cols = rng.integers(0, N, m)
    vals = rng.uniform(-1, 1, m)
    r = np.concatenate([rows, cols, np.arange(N)])
    c = np.concatenate([cols, rows, np.arange(N)])
    v = np.concatenate([vals, vals, np.full(N, 4.0 * AVG)])
    A = COOMatrix(r, c, v, N, N, options=opt)
    nnz = A.n_kernel
    part = BlockPartition(N, 1)

    pl = SquarePlanner(mesh=None, options=opt)
    pl.add_sol_vector(PartitionedVector("s", part, options=opt).zero_fill())
    pl.add_rhs_vector(
        PartitionedVector("b", part, options=opt).constant_fill(1.0)
    )
    t0 = time.time()
    pl.add_row_partitioned_matrix(A, 0, 0)
    op = pl.row_partitioned_matrices[0][0]
    print(f"[genspmv] build {time.time()-t0:.1f} s; operator: "
          f"{type(op).__name__}({type(getattr(op, 'base', op)).__name__})",
          file=sys.stderr, flush=True)
    assert isinstance(op, ReorderedOperator)
    assert isinstance(op.base, GeneralSpmvOperator)
    base = op.base
    print(f"[genspmv] plan: "
          f"{ {k: base._plan[k] for k in ('B1', 'W1', 'W2', 'V', 'SRB3', 'P', 'f1', 'D_pad')} }",
          file=sys.stderr, flush=True)

    # matvec marginal (in the solver basis = the hot-loop condition)
    st = tuple(base.device_state())

    def mk(K):
        @jax.jit
        def f(x, *dev):
            base.set_device_state(dev)
            try:
                def body(k, x):
                    return base.matvec(x) * (1e-3 + 1e-9 * k)
                return jax.lax.fori_loop(0, K, body, x)
            finally:
                base.set_device_state(st)
        return f

    x = jnp.asarray(rng.standard_normal(part.padded_size).astype(np.float32))
    f1, f2 = mk(3), mk(23)
    jax.block_until_ready(f1(x, *st))
    jax.block_until_ready(f2(x, *st))
    per = marginal_seconds_per_iter(
        lambda k: (f1 if k == 3 else f2)(x, *st), 3, 23
    )
    print(f"[genspmv] matvec: {per*1e3:.3f} ms -> {nnz/per/1e9:.2f} Gnnz/s",
          flush=True)

    # CG through the planner (transcription path; 2 matvecs-equivalent of
    # traffic via matvec + dots/axpys)
    solver = CGSolver(pl)
    h_short = solver.solve(4)
    jax.block_until_ready(h_short)
    h_long = solver.solve(24)
    jax.block_until_ready(h_long)
    per_it = marginal_seconds_per_iter(
        lambda k: jax.block_until_ready(solver.solve(k)), 4, 24
    )
    print(f"[genspmv] CG: {per_it*1e3:.3f} ms/iter -> "
          f"{nnz/per_it/1e9:.2f} Gnnz/s; residual2[24] "
          f"{float(np.asarray(h_long)[-1]):.4g}", flush=True)


if __name__ == "__main__":
    main()
