"""Benchmark driver — the analog of the reference's BenchmarkStencil
(reference: test/BenchmarkStencil.cpp:209-262: warmup traces, timed traces,
"Achieved X ms per iteration"; metric definition in bench_all.py:206).

Runs CG on the 2-D 5-point negative Laplacian (the reference's dim-2
benchmark case) at 4096 x 4096 = 16.7M unknowns in f32, through the
matrix-free stencil operator, on the GPU, and prints ONE JSON line:

  {"metric": "cg_spmv_nnz_per_s", "value": ..., "unit": "nnz/s",
   "vs_baseline": ..., "ms_per_iter": ..., "device": {...}}

The reference publishes no absolute numbers (BASELINE.md), so
``vs_baseline`` is the fraction of the streaming roofline for the schedule
actually executed: bytes per iteration (utils/roofline.py, shared with
legionsolvers_tpu/benchmark.py) over a copy bandwidth measured in the same
process (utils/timing.measure_stream_bandwidth).  Times are marginal over
a short and a long compiled solve (utils/timing.py).  Exits non-zero when
JAX finds no GPU.

Usage:  python bench.py
"""

from __future__ import annotations

import json
import sys

import jax.numpy as jnp
import numpy as np

N_GRID = 4096            # 2-D grid edge -> n = 16.7M unknowns
SHORT_ITERS = 50
LONG_ITERS = 250         # marginal window: 200 iterations (reference count)


def main() -> None:
    from legionsolvers_tpu import CGSolver, SolverOptions
    from legionsolvers_tpu.benchmark import card_line, device_info
    from legionsolvers_tpu.utils.compile_cache import enable_compile_cache
    from legionsolvers_tpu.utils.roofline import solver_bytes_per_iteration
    from legionsolvers_tpu.utils.timing import (
        marginal_seconds_per_iter,
        measure_stream_bandwidth,
    )
    import __graft_entry__ as ge

    device = device_info()
    if device["platform"] != "gpu":
        sys.exit(f"bench.py: no GPU found (JAX platform {device['platform']})")
    enable_compile_cache()
    print(f"[bench] card: {card_line()}", file=sys.stderr)

    options = SolverOptions(entry_dtype=jnp.float32)
    planner = ge._build_system(N_GRID, mesh=None, pieces=1, options=options)
    solver = CGSolver(planner)
    n = N_GRID * N_GRID
    nnz = 5 * N_GRID * N_GRID - 4 * N_GRID  # 5-pt stencil exact nnz
    bytes_per_iter, schedule = solver_bytes_per_iteration(solver, n)
    print(f"[bench] CG schedule: {schedule} "
          f"({bytes_per_iter / n:.0f} B/unknown/iter)", file=sys.stderr)
    bw = measure_stream_bandwidth()
    print(f"[bench] measured stream bandwidth: {bw/1e9:.0f} GB/s",
          file=sys.stderr)

    # repeated runs re-derive the initial state (fills + reset) rather than
    # snapshotting the planner — no second copy of the vectors stays live —
    # and the fused runner consumes (donates) its x/r/p buffers in place
    solver.donate_workspace = True

    def run(iters):
        for v in planner.sol_vectors:
            v.zero_fill()
        solver.reset()
        return solver.solve(iters)

    run(SHORT_ITERS), run(LONG_ITERS)  # compile both lengths
    sec_per_iter = marginal_seconds_per_iter(run, SHORT_ITERS, LONG_ITERS)
    hist = np.asarray(run(SHORT_ITERS))

    ms_per_iter = sec_per_iter * 1e3
    stream_ms = bytes_per_iter / bw * 1e3
    print(
        f"[bench] 2-D 5-pt CG, n={n} ({N_GRID}x{N_GRID}), f32, "
        f"{device['count']} x {device['kind']}: {ms_per_iter:.4f} ms/iter "
        f"(stream roofline {stream_ms:.4f} ms), "
        f"{nnz / sec_per_iter / 1e9:.2f} Gnnz/s, residual2[{SHORT_ITERS}] "
        f"{float(hist[-1]):.4g}",
        file=sys.stderr,
    )
    print(json.dumps({
        "metric": "cg_spmv_nnz_per_s",
        "value": nnz / sec_per_iter,
        "unit": "nnz/s",
        "vs_baseline": stream_ms / ms_per_iter,
        "ms_per_iter": ms_per_iter,
        "schedule": schedule,
        "device": device,
    }))


if __name__ == "__main__":
    main()
