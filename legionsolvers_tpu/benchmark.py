"""BenchmarkStencil equivalent: the reference's benchmark driver as a CLI.

Mirrors reference: test/BenchmarkStencil.cpp — flags ``-dim 1..4`` (1-D 3-pt,
2-D 5-pt, 3-D 7-pt, 3-D 27-pt Laplacian), ``-solver 1|2|3`` (CG, BiCGStab,
GMRES(10)), grid sizes ``-nx -ny -nz``, pieces ``-vp``, iterations ``-it``,
and the reference's block-system stress setup (2 sol/rhs spaces with the
matrix registered twice, BenchmarkStencil.cpp:201-207) via ``--block``.
Prints "Achieved X ms per iteration" like the reference (:255-262) plus
nnz/s, the device it ran on, and — given ``--bw`` — the fraction of the
streaming roofline.

Usage:  python -m legionsolvers_tpu.benchmark -dim 2 -nx 4096 -ny 4096 -it 200
"""

from __future__ import annotations

import argparse
import sys

import jax
import jax.numpy as jnp
import numpy as np


def build_planner(args, mesh, options):
    from . import (
        BlockPartition,
        PartitionedVector,
        SquarePlanner,
        StencilOperator,
        calculate_stencil_size,
        laplacian_stencil,
        stencil_grid_ndim,
    )

    nd = stencil_grid_ndim(args.dim)
    shape = tuple([args.nx, args.ny, args.nz][:nd])
    offsets = laplacian_stencil(args.dim)
    n = int(np.prod(shape))
    part = BlockPartition(n, args.vp)
    op = StencilOperator(shape, offsets, partition=part, mesh=mesh, options=options)

    planner = SquarePlanner(mesh=mesh, options=options)
    num_spaces = 2 if args.block else 1
    # grid-native vector storage when the grid view is active: avoids
    # 1-D<->N-D relayout copies at every operator boundary
    gs = shape if op.uses_grid_view else None
    for i in range(num_spaces):
        sol = PartitionedVector(f"sol{i}", part, mesh=mesh, options=options,
                                grid_shape=gs)
        sol.zero_fill()
        planner.add_sol_vector(sol)
    for i in range(num_spaces):
        rhs = PartitionedVector(f"rhs{i}", part, mesh=mesh, options=options,
                                grid_shape=gs)
        rhs.constant_fill(1.0)
        planner.add_rhs_vector(rhs)
    for i in range(num_spaces):
        # reference registers the same matrix once per space (diagonal blocks)
        planner.add_operator(op, i, i)
    nnz = calculate_stencil_size(shape, offsets) * num_spaces
    return planner, n * num_spaces, nnz


def card_line() -> str:
    """``name, power.limit`` of the GPUs as nvidia-smi reports them (a child
    process that stays off JAX), or why it could not be read."""
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def device_info() -> dict:
    """The device every result is attributed to, as JAX reports it."""
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def main(argv=None, bw=None):
    """Run one benchmark config; returns a metrics dict (and prints the
    reference-style "Achieved X ms per iteration" line).  ``bw``: optional
    stream bandwidth in bytes/s measured on the same device, for the
    roofline fraction."""
    from . import BiCGStabSolver, CGSolver, GMRESSolver, SolverOptions
    from .parallel.mesh import make_mesh
    from .utils.compile_cache import enable_compile_cache
    from .utils.timing import marginal_seconds_per_iter

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-dim", type=int, default=2, choices=[1, 2, 3, 4])
    p.add_argument("-solver", type=int, default=1, choices=[1, 2, 3, 4],
                   help="1=CG 2=BiCGStab 3=GMRES(restart) 4=PCG+Jacobi "
                   "(beyond-reference: the reference implements no "
                   "preconditioner, README.md:31)")
    p.add_argument("-nx", type=int, default=None)
    p.add_argument("-ny", type=int, default=None)
    p.add_argument("-nz", type=int, default=None)
    p.add_argument("-vp", type=int, default=1, help="pieces (mesh shards)")
    p.add_argument("-it", type=int, default=200, help="timed iterations")
    p.add_argument("-restart", type=int, default=10, help="GMRES restart")
    p.add_argument("--block", action="store_true",
                   help="2-space block system (reference stress setup)")
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "float64", "bfloat16"])
    p.add_argument("--bw", type=float, default=None,
                   help="stream bandwidth (bytes/s) measured on the same "
                   "device: enables the roofline fraction")
    p.add_argument("--consume-rhs", action="store_true",
                   help="CG max-size mode: 3 live vectors — the rhs buffer "
                   "is donated through r and re-filled between runs "
                   "(reference 2^30 1-node parity, bench_all_ls.py:366-379)")
    args = p.parse_args(argv)
    # unset extents default to n = 2^24 unknowns for every dim: 2^24,
    # 4096^2, 256^3 (the reference's per-GPU size class)
    default = {1: (1 << 24,), 2: (4096, 4096), 4: (256, 256, 256)}
    default[3] = default[4]
    for name, d in zip(("nx", "ny", "nz"), default[args.dim] + (1, 1)):
        if getattr(args, name) is None:
            setattr(args, name, d)
    if bw is None:
        bw = args.bw
    enable_compile_cache()
    device = device_info()

    options = SolverOptions(entry_dtype=jnp.dtype(args.dtype))
    mesh = make_mesh(args.vp) if args.vp > 1 else None
    planner, n, nnz = build_planner(args, mesh, options)

    from .utils.roofline import solver_bytes_per_iteration

    if args.solver == 1:
        solver = CGSolver(planner)
    elif args.solver == 2:
        solver = BiCGStabSolver(planner)
    elif args.solver == 4:
        from .solvers.pcg import JacobiPreconditioner, PCGSolver

        solver = PCGSolver(planner, JacobiPreconditioner(planner))
    else:
        solver = GMRESSolver(planner, restart=args.restart)
    # shared traffic model (utils/roofline.py) — same accounting as bench.py
    bytes_per_iter, schedule = solver_bytes_per_iteration(solver, n)
    print(f"[bench] schedule: {schedule} "
          f"({bytes_per_iter / n:.0f} B/unknown/iter)", file=sys.stderr)

    if bw is not None:
        print(f"[bench] measured stream bandwidth: {bw/1e9:.0f} GB/s",
              file=sys.stderr)

    # repeated runs re-derive the initial state from fills + solver.reset()
    # instead of snapshotting the planner (a dump_state snapshot keeps a
    # second copy of every vector live, halving the max problem size);
    # CG additionally donates its x/r/p buffers into the fused runner
    import os as _os

    if args.solver in (1, 2) and not _os.environ.get(
        "LEGIONSOLVERS_NO_DONATE"
    ):
        # CG and BiCGStab fused runners consume their carried vectors in
        # place; donation is what holds the max-size rungs at the live-set
        # minimum (the runners alias every carried vector since round 4)
        solver.donate_workspace = True
    consume = bool(
        args.consume_rhs
        or _os.environ.get("LEGIONSOLVERS_CONSUME_RHS")
    ) and args.solver == 1 and getattr(solver, "donate_workspace", False)
    if consume:
        solver.consume_rhs = True
    short = max(args.it // 5, 1)

    def run(iters):
        # identical work every run: x0 = 0, b = 1, workspace re-derived
        for v in planner.sol_vectors:
            v.zero_fill()
        if consume:
            # the previous solve consumed b and left r/p holding their
            # final 4 GB-class buffers: release them BEFORE re-filling b so
            # the peak stays at 3 live vectors
            for ws in planner.workspace_vectors:
                for v in ws:
                    v._data = None
            for v in planner.rhs_vectors:
                v.refill_constant(1.0)
        solver.reset()
        return solver.solve(iters)

    run(short), run(args.it)  # compile both lengths
    sec_per_iter = marginal_seconds_per_iter(run, short, args.it)
    hist = np.asarray(run(args.it))

    ms = sec_per_iter * 1e3
    names = {1: "CG", 2: "BiCGStab", 3: f"GMRES({args.restart})",
             4: "PCG(Jacobi)"}
    print(
        f"[bench] dim={args.dim} {names[args.solver]} n={n} pieces={args.vp} "
        f"dtype={args.dtype}: residual2[{args.it}]={hist[-1]:.4g}",
        file=sys.stderr,
    )
    pct = None if bw is None else 100 * (bytes_per_iter / bw) / sec_per_iter
    roofline = f", {pct:.1f}% of stream roofline" if pct is not None else ""
    print(f"Achieved {ms:.6f} ms per iteration "
          f"({nnz / sec_per_iter / 1e9:.2f} Gnnz/s{roofline}) on "
          f"{device['count']} x {device['kind']} ({device['platform']})")
    result = {
        "dim": args.dim,
        "solver": names[args.solver],
        "n": n,
        "nnz": nnz,
        "pieces": args.vp,
        "dtype": args.dtype,
        "ms_per_iter": ms,
        "gnnz_per_s": nnz / sec_per_iter / 1e9,
        "schedule": schedule,
        "bytes_per_unknown": bytes_per_iter / n,
        "pct_roofline": pct,
        "final_residual2": float(hist[-1]),
        "device": device,
    }
    import json
    import os as _os

    if _os.environ.get("LEGIONSOLVERS_BENCH_JSON"):
        # machine-readable row for subprocess harnesses (bench_matrix runs
        # each config in its own process, so one that runs out of device
        # memory cannot take the others with it)
        print("BENCH_JSON " + json.dumps(result))
    return result


if __name__ == "__main__":
    main()
