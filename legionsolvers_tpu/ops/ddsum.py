"""Compensated (two-float / double-float) reductions for f32 solves.

The reference runs f64 end-to-end (reference: test_all.py:130-133 pins f64
goldens; its CUDA leaf tasks run in double).  In an f32 solve, rho =
<r~, r> is a catastrophically cancelling sum whose true value can fall
below the f32 term-rounding noise floor (eps * sum|terms|) within a few
iterations at n = 16.7M, making the trajectory reduction-order chaotic.

The fix is classical error-free transformation (EFT) arithmetic:

* ``two_sum``    — Knuth: s + e == a + b exactly (6 flops, no FMA needed);
* ``two_prod``   — Dekker split: p + e == a * b exactly for f32 inputs
  (the 17-flop split form, which needs no fused multiply-add; whether the
  compiler's FMA contraction preserves it on a given backend is checked
  by tests/test_25_compensated.py on that backend);
* ``dd_add``     — double-float accumulate (carries ~49 significand bits);
* ``dd_sum`` / ``dd_dot`` — reductions carrying (hi, lo) through EVERY
  level of the tree, lowering the noise floor by ~2^25 relative to a plain
  f32 reduction.

Used by the fused BiCGStab passes (ops/grid2d.py, under the
``compensated`` flag) and by the solver transcriptions for rho-class dots,
so fused and transcription paths agree at benchmark scale instead of
splitting chaotically.  Pure jnp.
"""

from __future__ import annotations

import jax.numpy as jnp

_SPLITTER = 4097.0  # 2^12 + 1 for f32 (Dekker): splits 24-bit significands


def two_sum(a, b):
    """(s, e) with s = fl(a + b) and s + e == a + b exactly (Knuth)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def _split(a):
    c = _SPLITTER * a
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a, b):
    """(p, e) with p = fl(a * b) and p + e == a * b exactly (Dekker)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def dd_add(xh, xl, yh, yl):
    """Double-float addition: (xh, xl) + (yh, yl) -> (hi, lo)."""
    s, e = two_sum(xh, yh)
    e = e + (xl + yl)
    hi, lo = two_sum(s, e)
    return hi, lo


def _dd_reduce_axis0(h, l):
    """Fold axis 0 of (hi, lo) arrays to length 1 by repeated halving
    (sequential tail folds keep any length exact — dd error per fold is
    O(2^-49), order-independent at this precision)."""
    while h.shape[0] > 1:
        m = h.shape[0] // 2
        hh, ll = dd_add(h[:m], l[:m], h[m : 2 * m], l[m : 2 * m])
        if h.shape[0] % 2:
            hh0, ll0 = dd_add(hh[:1], ll[:1], h[-1:], l[-1:])
            hh = jnp.concatenate([hh0, hh[1:]], 0)
            ll = jnp.concatenate([ll0, ll[1:]], 0)
        h, l = hh, ll
    return h, l


def dd_sum_2d(h, l):
    """Reduce (hi, lo) arrays of shape [R, C] to scalar (hi, lo), carrying
    the compensation through every level.

    Rows fold by halving, columns fold first in static 128-chunks, then by
    halvings — static slices only, no reshapes."""
    R, C = h.shape
    if C % 128 == 0 and C > 128:
        hh = h[:, :128]
        ll = l[:, :128]
        for k in range(1, C // 128):
            hh, ll = dd_add(hh, ll, h[:, 128 * k : 128 * (k + 1)],
                            l[:, 128 * k : 128 * (k + 1)])
        h, l = hh, ll
        C = 128
    h, l = _dd_reduce_axis0(h, l)
    # lanes: halve while the width allows exact splits; C is 128 or small
    w = C
    while w > 1:
        m = w // 2
        nh, nl = dd_add(h[:, :m], l[:, :m], h[:, m : 2 * m], l[:, m : 2 * m])
        if w % 2:
            th, tl = dd_add(nh[:, :1], nl[:, :1], h[:, -1:], l[:, -1:])
            nh = jnp.concatenate([th, nh[:, 1:]], 1)
            nl = jnp.concatenate([tl, nl[:, 1:]], 1)
        h, l = nh, nl
        w = m
    return h[0, 0], l[0, 0]


def dd_dot_tile(a, b):
    """Compensated <a, b> over a 2-D tile: (hi, lo) f32 scalars.

    Cost ~25 flops/element (17 two_prod + 7 dd accumulation + reduction
    amortization) vs ~2 for a plain f32 dot — acceptable where the pass is
    memory-bound, which is why the BiCGStab passes (60 B/unknown) carry it
    as an option."""
    a = a.astype(jnp.float32)
    b = b.astype(jnp.float32)
    R = a.shape[0]
    # accumulate rows in chunks of 8 into an (8, C) dd accumulator:
    # sequential dd folds are exact to O(2^-49) per fold
    step = 8 if R % 8 == 0 else 1
    hi = jnp.zeros((step,) + a.shape[1:], jnp.float32)
    lo = jnp.zeros_like(hi)
    for k in range(R // step):
        p, e = two_prod(a[k * step : (k + 1) * step],
                        b[k * step : (k + 1) * step])
        hi, lo = dd_add(hi, lo, p, e)
    return dd_sum_2d(hi, lo)


def dd_dot(x, y):
    """Compensated dot of arbitrarily large flat arrays in XLA; returns the
    f32 value hi + lo collapsed to one scalar (rel. accuracy = f32
    representation — exactly what ratio-carried solver scalars need; callers
    wanting the pair use :func:`dd_dot_tile`).  Rolled ``fori_loop`` over
    row chunks so tracing stays O(1) in n."""
    import jax

    x = jnp.asarray(x).reshape(-1)
    y = jnp.asarray(y).reshape(-1)
    n = x.shape[0]
    c = 512 if n % 512 == 0 else 128
    pad = (-n) % c
    if pad:
        x = jnp.pad(x, (0, pad))
        y = jnp.pad(y, (0, pad))
    X = x.reshape(-1, c).astype(jnp.float32)
    Y = y.reshape(-1, c).astype(jnp.float32)
    R = X.shape[0]
    step = min(8, R)

    def body(k, acc):
        hi, lo = acc
        a = jax.lax.dynamic_slice_in_dim(X, k * step, step)
        b = jax.lax.dynamic_slice_in_dim(Y, k * step, step)
        p, e = two_prod(a, b)
        return dd_add(hi, lo, p, e)

    hi = jnp.zeros((step, c), jnp.float32)
    lo = jnp.zeros_like(hi)
    hi, lo = jax.lax.fori_loop(0, R // step, body, (hi, lo))
    if R % step:
        p, e = two_prod(X[-(R % step) :], Y[-(R % step) :])
        h2, l2 = dd_add(hi[: R % step], lo[: R % step], p, e)
        hi = jnp.concatenate([h2, hi[R % step :]], 0)
        lo = jnp.concatenate([l2, lo[R % step :]], 0)
    h, l = dd_sum_2d(hi, lo)
    return h + l
