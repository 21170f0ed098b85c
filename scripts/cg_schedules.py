"""Time the 2-D CG schedules against each other on one GPU.

ms/iteration of ``CGSolver.solve(200)`` on the 2-D 5-point Laplacian at
4096^2 f32 (the flagship cell), for:

* ``sstep_triton`` — the s-step schedule with its pass as the Triton kernel
  (ops/pallas/sstep2d.py), once per kernel config given with ``--configs``;
* ``sstep_jnp``    — the same schedule with the plain jnp pass
  (ops/grid2d.step2_jnp / gram2_jnp);
* ``fused2d``      — two fused passes per iteration;
* ``fused_jnp``    — the classic six-operation schedule (no grid view).

Schedules run in turns (forward, then reverse order) so that clock and
power drift hits all of them alike; the minimum of each is reported.

Usage:  python scripts/cg_schedules.py [--n 4096] [--iters 200]
            [--configs 128,128,4,2 128,256,4,2]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402


def build(n, grid_view):
    from legionsolvers_tpu import (BlockPartition, CGSolver, PartitionedVector,
                                   SolverOptions, SquarePlanner,
                                   StencilOperator, laplacian_stencil)

    opts = SolverOptions(entry_dtype=jnp.float32)
    part = BlockPartition(n * n, 1)
    op = StencilOperator((n, n), laplacian_stencil(2), partition=part,
                         options=opts, grid_view=grid_view)
    gs = (n, n) if grid_view else None
    pl = SquarePlanner(options=opts)
    pl.add_sol_vector(PartitionedVector("x", part, options=opts,
                                        grid_shape=gs).zero_fill())
    pl.add_rhs_vector(PartitionedVector("b", part, options=opts,
                                        grid_shape=gs).constant_fill(1.0))
    pl.add_operator(op, 0, 0)
    return pl, CGSolver(pl)


@contextlib.contextmanager
def schedule(name, config=None):
    """Patch in the pieces a schedule needs while its runner is built."""
    from legionsolvers_tpu.ops import grid2d
    from legionsolvers_tpu.ops.pallas import sstep2d

    saved = (sstep2d.gram2, sstep2d.step2, sstep2d.DEFAULT_CONFIG)
    if name == "sstep_jnp":
        sstep2d.gram2, sstep2d.step2 = grid2d.gram2_jnp, grid2d.step2_jnp
    if config is not None:
        sstep2d.DEFAULT_CONFIG = config
    if name == "fused2d":
        os.environ["LEGIONSOLVERS_NO_SSTEP"] = "1"
    try:
        yield
    finally:
        sstep2d.gram2, sstep2d.step2, sstep2d.DEFAULT_CONFIG = saved
        os.environ.pop("LEGIONSOLVERS_NO_SSTEP", None)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--iters", type=int, default=200)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--configs", nargs="*", default=["128,128,4,2"],
                    help="Triton kernel configs: TC,RB,num_warps,num_stages")
    args = ap.parse_args()
    from legionsolvers_tpu.benchmark import card_line

    card = card_line()
    dev = jax.devices()[0]
    print(f"card: {card}; jax: {dev.platform} {dev.device_kind}", flush=True)

    cases = [(f"sstep_triton{c}", "sstep_triton",
              tuple(int(v) for v in c.split(","))) for c in args.configs]
    cases += [("sstep_jnp", "sstep_jnp", None), ("fused2d", "fused2d", None),
              ("fused_jnp", "fused_jnp", None)]
    runs = {}
    for label, name, cfg in cases:
        pl, solver = build(args.n, grid_view=name != "fused_jnp")

        def run(pl=pl, solver=solver):
            for v in pl.sol_vectors:
                v.zero_fill()
            solver.reset()
            return solver.solve(args.iters)

        with schedule(name, cfg):
            t0 = time.perf_counter()
            hist = np.asarray(run())
        print(f"{label}: first solve (compile + run) "
              f"{time.perf_counter() - t0:.2f} s, residual2[{args.iters}] "
              f"{hist[-1]:.6g}", flush=True)
        runs[label] = run

    best = {k: float("inf") for k in runs}
    order = list(runs)
    for turn in (order, order[::-1]):
        for label in turn:
            for _ in range(args.reps):
                t0 = time.perf_counter()
                jax.block_until_ready(runs[label]())
                best[label] = min(best[label], time.perf_counter() - t0)
    for label in order:
        print(f"{label}: {best[label] / args.iters * 1e3:.4f} ms/iteration "
              f"(min of {2 * args.reps} solve({args.iters}))", flush=True)
    print(json.dumps({"card": card, "n": args.n, "iters": args.iters,
                      "ms_per_iter": {k: best[k] / args.iters * 1e3
                                      for k in order}}))


if __name__ == "__main__":
    main()
