"""Benchmark timing harness.

The analog of the reference's fence-bracketed timing (reference:
BenchmarkStencil.cpp:225-259: execution+mapping fences around
``get_current_time_in_nanoseconds`` futures, warmup traces excluded).
Every timing ends in ``block_until_ready``; per-iteration times are
*marginal*: a short and a long run of the same compiled loop, differenced,
so fixed per-call costs (dispatch, host sync) cancel.
"""

from __future__ import annotations

import time
from typing import Callable

import jax


def time_call(f: Callable, *args, reps: int = 5) -> float:
    """Best-of-``reps`` wall seconds for ``f(*args)`` until the device has
    finished."""
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(f(*args))
        best = min(best, time.perf_counter() - t0)
    return best


def marginal_seconds_per_iter(
    run: Callable[[int], object], short: int, long: int, reps: int = 5
) -> float:
    """Marginal per-iteration wall time of ``run(num_iters)``; both lengths
    must already be compiled (call them once beforehand).  Raises when the
    long run is not slower than the short one: no per-iteration time can be
    read from such a pair."""
    t_short = time_call(run, short, reps=reps)
    t_long = time_call(run, long, reps=reps)
    diff = t_long - t_short
    if diff <= 0:
        raise RuntimeError(
            f"marginal timing failed: {long} iterations took {t_long:.6f} s, "
            f"{short} took {t_short:.6f} s"
        )
    return diff / (long - short)


def measure_stream_bandwidth(n: int = 1 << 26, dtype=None) -> float:
    """Measured streaming bytes/s via a marginal chained-axpy fori_loop
    (3 arrays * itemsize bytes touched per element per iteration), the
    in-situ memory roofline used to normalize solver benchmarks.  The
    coefficient depends on the loop index so XLA cannot fold the chain, and
    the default arrays (256 MB each at f32) are far larger than any on-chip
    cache."""
    import jax.numpy as jnp

    dtype = dtype or jnp.float32
    x = jax.random.uniform(jax.random.PRNGKey(0), (n,), dtype)
    y = jax.random.uniform(jax.random.PRNGKey(1), (n,), dtype)

    def make(k):
        @jax.jit
        def chain(x, y):
            def body(i, r):
                c = (0.5 + 1e-6 * i).astype(dtype)
                return c * r + 0.001 * y

            return jnp.sum(jax.lax.fori_loop(0, k, body, x))

        return chain

    k0, k1 = 20, 100
    f0, f1 = make(k0), make(k1)
    float(f0(x, y)), float(f1(x, y))  # compile both
    per_iter = marginal_seconds_per_iter(
        lambda k: (f0 if k == k0 else f1)(x, y), k0, k1
    )
    itemsize = jnp.dtype(dtype).itemsize
    return 3 * itemsize * n / per_iter
