"""Cross-library comparison baseline: scipy.sparse vs legionsolvers_tpu.

The analog of the reference's PETSc/Trilinos comparison drivers (reference:
bench_all.py:212-358, benchmarks/petsc/main.cpp:280-305,
benchmarks/trilinos/main.cpp:272-330): the SAME generated matrices (the
BenchmarkStencil Laplacians, dims 1/2/3/3D-27pt), the same fixed-iteration
ms-per-iteration metric, no preconditioner, tolerance forced to never
converge (fixed-work timing, like the reference's tol=0 runs).

scipy runs on the host CPU; the legionsolvers_tpu numbers are measured on
whatever backend jax selects, which every row names.  Writes a markdown
table to stdout and appends a JSON record per row.

Usage: python scripts/bench_crosslib.py [--sizes small|bench]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


CASES_SMALL = [  # (dim label, grid shape)
    (1, (1 << 16,)),
    (2, (256, 256)),
    (3, (32, 32, 32)),
    (4, (32, 32, 32)),
]
CASES_BENCH = [
    (1, (1 << 22,)),
    (2, (2048, 2048)),
    (3, (256, 128, 128)),
    (4, (128, 128, 128)),
]
SOLVERS = [(1, "cg"), (2, "bicgstab"), (3, "gmres")]
ITERS = 50
RESTART = 10


def scipy_ms_per_iter(A_sp, b, solver: str, iters: int) -> float:
    """Fixed-work scipy run: atol=0/rtol=0 never converges, maxiter pins the
    iteration count (the reference's tol=0 PETSc/Trilinos runs)."""
    from scipy.sparse.linalg import bicgstab, cg, gmres

    x0 = np.zeros_like(b)
    t0 = time.perf_counter()
    if solver == "cg":
        cg(A_sp, b, x0=x0, rtol=0.0, atol=0.0, maxiter=iters)
        n_it = iters
    elif solver == "bicgstab":
        bicgstab(A_sp, b, x0=x0, rtol=0.0, atol=0.0, maxiter=iters)
        n_it = iters
    else:
        cycles = max(iters // RESTART, 1)
        gmres(A_sp, b, x0=x0, rtol=0.0, atol=0.0, restart=RESTART,
              maxiter=cycles * RESTART)
        n_it = cycles  # report per restart cycle, like our GMRES metric
    return (time.perf_counter() - t0) / n_it * 1e3


def ours_ms_per_iter(shape, dim, solver_id, iters) -> tuple[float, float]:
    import jax.numpy as jnp

    from legionsolvers_tpu import (
        BiCGStabSolver,
        BlockPartition,
        CGSolver,
        GMRESSolver,
        PartitionedVector,
        SolverOptions,
        SquarePlanner,
        StencilOperator,
        laplacian_stencil,
    )
    from legionsolvers_tpu.utils.timing import marginal_seconds_per_iter

    options = SolverOptions(entry_dtype=jnp.float32)
    n = int(np.prod(shape))
    part = BlockPartition(n, 1)
    op = StencilOperator(shape, laplacian_stencil(dim), partition=part,
                         mesh=None, options=options)
    planner = SquarePlanner(mesh=None, options=options)
    gs = shape if op.uses_grid_view else None
    planner.add_sol_vector(PartitionedVector(
        "s", part, options=options, grid_shape=gs).zero_fill())
    planner.add_rhs_vector(PartitionedVector(
        "b", part, options=options, grid_shape=gs).constant_fill(1.0))
    planner.add_operator(op, 0, 0)
    cls = {1: CGSolver, 2: BiCGStabSolver, 3: GMRESSolver}[solver_id]
    solver = cls(planner, RESTART) if solver_id == 3 else cls(planner)
    units = max(iters // RESTART, 2) if solver_id == 3 else iters

    init_state = planner.dump_state()
    scal = {
        k: list(getattr(solver, k))
        for k in ("residual_norm_squared", "rho", "alpha", "omega")
        if hasattr(solver, k) and isinstance(getattr(solver, k), list)
    }

    def run(k):
        planner.load_state(init_state)
        for key, v in scal.items():
            setattr(solver, key, list(v))
        return solver.solve(k)

    # marginal window of 4x the base unit count: at crosslib sizes (n ~ 4M)
    # one iteration is short, and a units//5..units window is too short to
    # rise above per-call timing noise
    long_units = units * 5
    run(units), run(long_units)
    sec = marginal_seconds_per_iter(run, units, long_units)
    hist = np.asarray(run(units))
    return sec * 1e3, float(hist[-1])


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--sizes", choices=["small", "bench"], default="small")
    p.add_argument("--json", default=None, help="append JSON records here")
    p.add_argument("--cpu", action="store_true",
                   help="force the jax side onto CPU too")
    p.add_argument("--reuse-scipy", default=None, metavar="JSONL",
                   help="take scipy_ms from a previous --json record file "
                   "instead of re-running the (slow) scipy side")
    args = p.parse_args()
    cases = CASES_SMALL if args.sizes == "small" else CASES_BENCH

    scipy_cache = {}
    if args.reuse_scipy:
        with open(args.reuse_scipy) as f:
            for line in f:
                r = json.loads(line)
                scipy_cache[(r["dim"], r["n"], r["solver"])] = r["scipy_ms"]

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    backend = jax.default_backend()
    import scipy.sparse

    from legionsolvers_tpu import SolverOptions, laplacian_stencil
    from legionsolvers_tpu.problems.stencil import create_coo_stencil_matrix
    import jax.numpy as jnp

    rows = []
    print(f"| dim | n | solver | scipy (CPU) ms/it | ours ({backend}) ms/it "
          f"| speedup |")
    print("|---|---|---|---|---|---|")
    for dim, shape in cases:
        n = int(np.prod(shape))
        A_sp = None  # built lazily: skipped entirely under --reuse-scipy
        b = np.ones(n)
        for sid, sname in SOLVERS:
            sc = scipy_cache.get((dim, n, sname))
            if sc is None:
                if A_sp is None:
                    A = create_coo_stencil_matrix(
                        shape, laplacian_stencil(dim),
                        options=SolverOptions(entry_dtype=jnp.float64),
                    )
                    A_sp = scipy.sparse.csr_matrix(
                        (np.asarray(A.vals), (A.rows, A.cols)), shape=(n, n)
                    )
                sc = scipy_ms_per_iter(A_sp, b, sname, ITERS)
            ours, res = ours_ms_per_iter(shape, dim, sid, ITERS)
            unit = "cycle" if sid == 3 else "iter"
            print(f"| {dim} | {n} | {sname} | {sc:.3f} | {ours:.3f} "
                  f"| {sc/ours:.1f}x |", flush=True)
            rows.append({
                "dim": dim, "n": n, "solver": sname, "unit": unit,
                "scipy_ms": sc, "ours_ms": ours, "backend": backend,
                "final_residual2": res,
            })
    if args.json:
        with open(args.json, "a") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")


if __name__ == "__main__":
    main()
