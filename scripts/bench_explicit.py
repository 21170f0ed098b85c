"""GPU benchmark: CG with EXPLICIT sparse matrices (DIA vs ELL).

The reference's core compute path is cuSPARSE SpMV over explicit CSR/COO
(reference: CSRMatrixTasks.cu:14-156); this measures this library's
equivalents on the same problem as bench.py (2-D 5-pt negative Laplacian,
f32, one GPU):

* planner auto-upgrade -> DiaOperator ((2+D)*4 B/elt matvec traffic);
* prefer_dia=False      -> RowPartitionedMatrix (jnp ELL gather);
* the matrix-free StencilOperator for the ratio.

Usage: python scripts/bench_explicit.py [n_grid] (default 4096)
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax.numpy as jnp
import numpy as np

SHORT, LONG = 20, 100


def build(n_grid, explicit, prefer_dia, options):
    from legionsolvers_tpu import (
        BlockPartition,
        PartitionedVector,
        SquarePlanner,
        StencilOperator,
        create_coo_stencil_matrix,
        laplacian_stencil,
    )

    n = n_grid * n_grid
    part = BlockPartition(n, 1)
    planner = SquarePlanner(mesh=None, options=options)
    planner.add_sol_vector(
        PartitionedVector("sol", part, options=options).zero_fill()
    )
    planner.add_rhs_vector(
        PartitionedVector("rhs", part, options=options).constant_fill(1.0)
    )
    if explicit:
        t0 = time.perf_counter()
        A = create_coo_stencil_matrix(
            (n_grid, n_grid), laplacian_stencil(2), options=options
        )
        t1 = time.perf_counter()
        planner.add_row_partitioned_matrix(A, 0, 0, prefer_dia=prefer_dia)
        t2 = time.perf_counter()
        print(f"[explicit] matrix build {t1-t0:.1f}s, "
              f"partition+pack {t2-t1:.1f}s "
              f"({type(planner.row_partitioned_matrices[0][0]).__name__})",
              file=sys.stderr)
    else:
        op = StencilOperator(
            (n_grid, n_grid), laplacian_stencil(2),
            partition=part, mesh=None, options=options,
        )
        planner.add_operator(op, 0, 0)
    return planner


def bench_cg(planner, nnz, label, bw):
    from legionsolvers_tpu import CGSolver
    from legionsolvers_tpu.utils.roofline import solver_bytes_per_iteration
    from legionsolvers_tpu.utils.timing import marginal_seconds_per_iter

    solver = CGSolver(planner)
    bpi, sched = solver_bytes_per_iteration(
        solver, planner.canonical_partitions[0].n
    )
    init_state = planner.dump_state()
    init_rr = solver.residual_norm_squared[-1]

    def run(iters):
        planner.load_state(init_state)
        solver.residual_norm_squared = [init_rr]
        return solver.solve(iters)

    run(SHORT), run(LONG)
    sec = marginal_seconds_per_iter(run, SHORT, LONG)
    hist = np.asarray(run(SHORT))
    pct = 100 * (bpi / bw) / sec if bw else float("nan")
    print(
        f"[explicit] {label}: {sec*1e3:.3f} ms/iter, "
        f"{nnz/sec/1e9:.2f} Gnnz/s, schedule {sched} "
        f"({bpi/planner.canonical_partitions[0].n:.0f} B/unknown), "
        f"{pct:.0f}% of roofline, residual2[{SHORT}]={hist[-1]:.4g}",
        flush=True,
    )
    return sec


def main():
    from legionsolvers_tpu import SolverOptions
    from legionsolvers_tpu.utils.timing import measure_stream_bandwidth

    n_grid = int(sys.argv[1]) if len(sys.argv) > 1 else 4096
    options = SolverOptions(entry_dtype=jnp.float32)
    nnz = 5 * n_grid * n_grid - 4 * n_grid
    bw = measure_stream_bandwidth()
    print(f"[explicit] stream bandwidth {bw/1e9:.0f} GB/s", file=sys.stderr)

    t_free = bench_cg(build(n_grid, False, True, options), nnz,
                      f"matrix-free stencil n={n_grid}^2", bw)
    t_dia = bench_cg(build(n_grid, True, True, options), nnz,
                     f"explicit DIA n={n_grid}^2", bw)
    print(f"[explicit] DIA / matrix-free ratio: {t_dia/t_free:.2f}x",
          flush=True)
    # The ELL leg runs at n/2 per side (index+value slabs plus the gathered
    # [n, L] product make it the largest footprint; its B/unknown model
    # normalizes the comparison).
    n_ell = min(n_grid, 2048)
    nnz_ell = 5 * n_ell * n_ell - 4 * n_ell
    t_ell = bench_cg(build(n_ell, True, False, options), nnz_ell,
                     f"explicit ELL n={n_ell}^2", bw)
    print(f"[explicit] ELL / matrix-free ratio (per-nnz): "
          f"{(t_ell/nnz_ell)/(t_free/nnz):.2f}x", flush=True)



if __name__ == "__main__":
    main()
