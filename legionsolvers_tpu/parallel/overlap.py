"""Halo-exchange / compute overlap via edge fixup.

The reference gets communication/compute overlap for free: Legion issues
ghost-region copies asynchronously and leaf tasks whose inputs are ready run
concurrently (reference: COOMatrix.cpp:172-188 ghost region requirement;
CGSolver.hpp:46-55 never blocks).  A naive shard_map port loses that: the
SpMV pass *consumes* the ppermute results, so XLA must finish the halo
exchange before the pass starts, leaving the collective's latency exposed
on every matvec.

The fix implemented here: run the main pass with ZERO halo
blocks — making it data-independent of the ppermute, so XLA's async
collective scheduler (collective-permute-start/-done) is free to fly the
exchange during the whole O(n) pass — then patch the first/last ``bandwidth``
rows with the contributions the zero-halo pass omitted.  The fixup touches
only O(bandwidth * C) elements, so its cost is negligible against the O(n)
pass; the dataflow-independence property is asserted by
tests/test_18_overlap.py on the jaxpr.

Layout contract matches the grid passes (ops/grid2d.py): the local
block is a [Br, C] grid; halo ``top`` is an [8, C] block whose LAST rlo rows
are the neighbor's edge rows (x[-rlo:]), halo ``bot``'s FIRST rhi rows are
x[Br:Br+rhi]; both are zeros at the global grid edges.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..ops.grid2d import acc_dtype, colshift


def edge_missing(offsets, top, bot, Br: int, coeff):
    """The contributions a zero-halo stencil pass omitted at the block edges.

    ``coeff(k, row_slice)`` returns the multiplier for offset ``k`` restricted
    to ``row_slice`` of the output rows (a scalar for constant-coefficient
    stencils).

    Returns (miss_top, miss_bot): [rlo, C] additions to y[0:rlo] and
    [rhi, C] additions to y[Br-rhi:], either possibly None.
    """
    rlo = max(0, -min(dy for dy, _ in offsets))
    rhi = max(0, max(dy for dy, _ in offsets))
    miss_top = None
    miss_bot = None
    for k, (dy, dx) in enumerate(offsets):
        if dy < 0:
            # y[r] needs x[r + dy] for r in [0, -dy): rows top[8+dy+r]
            term = coeff(k, slice(0, -dy)) * colshift(top[8 + dy : 8, :], dx)
            pad = jnp.zeros((rlo + dy, term.shape[1]), term.dtype)
            term = jnp.concatenate([term, pad]) if rlo + dy else term
            miss_top = term if miss_top is None else miss_top + term
        elif dy > 0:
            # y[r] needs x[r + dy] for r in [Br - dy, Br): rows bot[0:dy]
            term = coeff(k, slice(Br - dy, Br)) * colshift(bot[0:dy, :], dx)
            pad = jnp.zeros((rhi - dy, term.shape[1]), term.dtype)
            term = jnp.concatenate([pad, term]) if rhi - dy else term
            miss_bot = term if miss_bot is None else miss_bot + term
    return miss_top, miss_bot


def apply_edge_fixup(y: jnp.ndarray, offsets, top, bot, coeff):
    """y (zero-halo pass output, [Br, C]) + the omitted edge terms."""
    Br = y.shape[0]
    miss_top, miss_bot = edge_missing(offsets, top, bot, Br, coeff)
    if miss_top is not None:
        y = y.at[: miss_top.shape[0], :].add(miss_top)
    if miss_bot is not None:
        y = y.at[Br - miss_bot.shape[0] :, :].add(miss_bot)
    return y


def dot_fixup(x: jnp.ndarray, offsets, top, bot, coeff) -> jnp.ndarray:
    """Correction to a fused <x, A x> computed by a zero-halo pass:
    sum over edge rows of x * (omitted A x terms)."""
    Br = x.shape[0]
    miss_top, miss_bot = edge_missing(offsets, top, bot, Br, coeff)
    acc = acc_dtype(x.dtype)
    fix = jnp.zeros((), acc)
    if miss_top is not None:
        k = miss_top.shape[0]
        fix = fix + jnp.sum((x[:k, :] * miss_top).astype(acc))
    if miss_bot is not None:
        k = miss_bot.shape[0]
        fix = fix + jnp.sum((x[Br - k :, :] * miss_bot).astype(acc))
    return fix
