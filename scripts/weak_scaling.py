#!/usr/bin/env python3
"""Weak-scaling sweep — the analog of the reference's bench_all_ls.py
(reference: bench_all_ls.py:365-494: per-node-count max problem sizes,
doubling per node-doubling, 200 iterations).

Runs CG on the 2-D 5-point Laplacian over 1, 2, 4, ... shards with the
problem size scaled proportionally (fixed work per shard), and reports
ms/iteration and weak-scaling efficiency relative to the 1-shard run.

On a multi-GPU host this sweeps the local devices; across hosts, run one
process per host with ``initialize_distributed()``.  ``--cpu-devices N``
sweeps a virtual CPU device mesh to validate the scaling *semantics* (CPU
timings are not meaningful as absolute numbers).

Usage:
  python scripts/weak_scaling.py --cpu-devices 8 --base-edge 512 --iters 50
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--cpu-devices", type=int, default=0,
                   help="force N virtual CPU devices (testing)")
    p.add_argument("--base-edge", type=int, default=1024,
                   help="grid edge for 1 shard; rows scale with shards")
    p.add_argument("--iters", type=int, default=100)
    p.add_argument("--dtype", default="float32")
    args = p.parse_args()

    if args.cpu_devices:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={args.cpu_devices}"
        ).strip()
        import jax

        jax.config.update("jax_platforms", "cpu")
    import jax
    import jax.numpy as jnp
    import numpy as np

    from legionsolvers_tpu import (
        BlockPartition,
        CGSolver,
        PartitionedVector,
        SolverOptions,
        SquarePlanner,
        StencilOperator,
        laplacian_stencil,
    )
    from legionsolvers_tpu.parallel.mesh import make_mesh
    from legionsolvers_tpu.utils.timing import marginal_seconds_per_iter

    options = SolverOptions(entry_dtype=jnp.dtype(args.dtype))
    n_dev = len(jax.devices())
    shard_counts = []
    s = 1
    while s <= n_dev:
        shard_counts.append(s)
        s *= 2

    base = None
    print(f"devices: {n_dev} ({jax.devices()[0].platform})")
    for S in shard_counts:
        # weak scaling: rows grow with S, columns fixed -> n proportional to S
        rows = args.base_edge * S
        cols = args.base_edge
        n = rows * cols
        mesh = make_mesh(S) if S > 1 else None
        part = BlockPartition(n, S)
        op = StencilOperator(
            (rows, cols), laplacian_stencil(2), partition=part, mesh=mesh,
            options=options,
        )
        gs = (rows, cols) if op.uses_grid_view else None
        rhs = PartitionedVector(
            "rhs", part, mesh=mesh, options=options, grid_shape=gs
        ).constant_fill(1.0)
        sol = PartitionedVector(
            "sol", part, mesh=mesh, options=options, grid_shape=gs
        ).zero_fill()
        planner = SquarePlanner(mesh=mesh, options=options)
        planner.add_sol_vector(sol)
        planner.add_rhs_vector(rhs)
        planner.add_operator(op, 0, 0)
        solver = CGSolver(planner)
        init_state = planner.dump_state()
        init_rr = solver.residual_norm_squared[-1]

        def run(iters):
            planner.load_state(init_state)
            solver.residual_norm_squared = [init_rr]
            return solver.solve(iters)

        short = max(args.iters // 5, 1)
        run(short), run(args.iters)
        sec = marginal_seconds_per_iter(run, short, args.iters)
        if base is None:
            base = sec
        eff = base / sec
        print(
            f"shards={S:3d} n={n:>12d} ({rows}x{cols}) "
            f"{sec*1e3:9.3f} ms/iter  weak-eff={100*eff:6.1f}%  "
            f"{jax.devices()[0].device_kind}"
        )


if __name__ == "__main__":
    main()
