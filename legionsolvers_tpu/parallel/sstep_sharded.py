"""Sharded s-step CG: edge fixup for the zero-halo step2/gram2 passes.

The s-step pass (TWO CG iterations per kernel pass, 12 B/unknown/iter)
chains up to four stencil applications, so a zero-halo shard-local pass is
wrong within up to 4 rows of each shard edge — in the output vectors AND in
the emitted Gram matrix.  The fix implemented here keeps the pass
zero-halo (hence data-independent of the ppermutes — the overlap property
of parallel/overlap.py) and repairs everything afterwards from
pre-exchanged 4-row halos of the pass INPUTS:

* every corrupted quantity (x''/r''/p'' edge rows; the Gram contributions
  of the outer 4 rows) is recomputed on a 12-row strip in plain jnp — once
  with the true neighbor halos, once with zero halos (reproducing exactly
  what the kernel computed) — and the difference is patched in;
* wrongness radii: depth-d application chains corrupt d rows; x'' has
  depth 1, r''/p'' depth 2, the Gram (via A^2 p'') depth 4, and a depth-4
  quantity on strip rows [0, 4) reads inputs on [-4, 8) — exactly the
  12-row strip;
* nothing computed by the NEIGHBOR during the same pass is needed: all
  strip quantities derive from pass inputs, so one exchange per pass
  suffices and no cross-pass dependency exists (the reason r2 thought this
  was hard).

Cost per pass: two [8, C] ppermutes + O(strip * C) jnp work — negligible
against the O(Br * C) pass.  The same machinery repairs the gram2
bootstrap/refresh pass (depth 2 <= 4, same strips).

Reference analog: this is the scaling story — the reference weak-scales the
same row-partitioned CG to 2^37 unknowns (bench_all_ls.py:465-478) with
Legion moving the ghosts; here the ghosts ride collective-permutes under
the kernel pass.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

from ..ops.grid2d import apply2d as _apply, gram10 as _gram10

HALO = 4        # pre-exchanged rows per edge (= max application depth)
STRIP = 8       # local rows entering each edge strip
EXT = HALO + STRIP


def _chain_step2(x_e, r_e, p_e, coef, offs, vals, invalid):
    """All step2 quantities on an [EXT, C] slab.  ``invalid`` is an [EXT]
    0/1 mask (1 = out-of-grid row) applied after every application, as
    the kernel masks its intermediates.  Inputs must already
    be zero on invalid rows.  Returns (xo, rn, pn, Apn, A2pn, Arn)."""
    inv = invalid[:, None]
    msk = lambda u: u * (1.0 - inv)
    dt = r_e.dtype
    c0, c1, c2, c3, c4, c5 = (coef[i].astype(dt) for i in range(6))
    ap = lambda u: _apply(u, offs, vals)
    s3 = msk(ap(p_e))
    u3 = c0 * p_e + c1 * r_e - c2 * s3
    t2 = msk(ap(u3))
    rn = r_e - t2
    pn = rn + c3 * r_e - c4 * s3 + c5 * p_e
    Apn = msk(ap(pn))
    A2pn = ap(Apn)
    Arn = ap(rn)
    xo = x_e + u3
    return xo, rn, pn, Apn, A2pn, Arn


def _chain_gram2(r_e, p_e, offs, vals, invalid):
    """gram2-pass quantities on an [EXT, C] slab: (r, p, Ap, A2p, Ar)."""
    inv = invalid[:, None]
    msk = lambda u: u * (1.0 - inv)
    ap = lambda u: _apply(u, offs, vals)
    Ap = msk(ap(p_e))
    A2p = ap(Ap)
    Ar = ap(r_e)
    return r_e, p_e, Ap, A2p, Ar


def exchange_halo4(r, p, axis, S) -> Tuple:
    """(r_top, p_top, r_bot, p_bot): HALO neighbor rows of r and p above and
    below this shard's block (zeros at the global grid edges).  One fused
    ppermute per direction; depends only on pass inputs, so XLA schedules
    it under the zero-halo kernel pass."""
    up = jnp.concatenate([r[-HALO:], p[-HALO:]], 0)
    dn = jnp.concatenate([r[:HALO], p[:HALO]], 0)
    t = jax.lax.ppermute(up, axis, [(i, (i + 1) % S) for i in range(S)])
    b = jax.lax.ppermute(dn, axis, [(i, (i - 1) % S) for i in range(S)])
    idx = jax.lax.axis_index(axis)
    t = jnp.where(idx == 0, jnp.zeros_like(t), t)
    b = jnp.where(idx == S - 1, jnp.zeros_like(b), b)
    return t[:HALO], t[HALO:], b[:HALO], b[HALO:]


def _edge_masks(Br: int, is_first, is_last, dtype):
    """(invalid_true_top, invalid_kern_top, invalid_true_bot,
    invalid_kern_bot) as [EXT] f32 masks.  The kernel ALWAYS masks at the
    local block bounds (its maskW sees only the local grid); the truth
    masks only at the GLOBAL grid edges (traced via is_first/is_last)."""
    rows_t = jnp.arange(-HALO, STRIP)
    rows_b = jnp.arange(Br - STRIP, Br + HALO)
    kern_t = (rows_t < 0).astype(dtype)
    kern_b = (rows_b >= Br).astype(dtype)
    true_t = jnp.where(is_first, kern_t, jnp.zeros_like(kern_t))
    true_b = jnp.where(is_last, kern_b, jnp.zeros_like(kern_b))
    return true_t, kern_t, true_b, kern_b


def step2_fixup(outs, saves, halos, coef, offs, vals, axis, S):
    """Repair one zero-halo step2 pass.

    outs  = (x_out, r_out, p_out, g_local) — the kernel's shard-local
            results (g_local NOT yet psummed);
    saves = (x_t, r_t, p_t, x_b, r_b, p_b) — the pass INPUT edge strips
            ([STRIP, C] each), sliced before the aliased kernel call;
    halos = exchange_halo4 result.
    Returns (x_out, r_out, p_out, g_local) repaired; caller psums g."""
    x_out, r_out, p_out, g = outs
    x_t, r_t, p_t, x_b, r_b, p_b = saves
    rt4, pt4, rb4, pb4 = halos
    Br = x_out.shape[0]
    dt = x_out.dtype
    is_first = jax.lax.axis_index(axis) == 0
    is_last = jax.lax.axis_index(axis) == S - 1
    tt, kt, tb, kb = _edge_masks(Br, is_first, is_last, dt)
    z4 = jnp.zeros_like(rt4)
    sl = slice(HALO, HALO + HALO)  # strip-local rows [0, 4) / [Br-4, Br)

    # ---- top edge: ext local rows [-4, 8) -------------------------------
    xe = jnp.concatenate([jnp.zeros_like(rt4), x_t], 0)
    true = _chain_step2(xe, jnp.concatenate([rt4 * (1.0 - tt[:HALO, None]),
                                             r_t], 0),
                        jnp.concatenate([pt4 * (1.0 - tt[:HALO, None]),
                                         p_t], 0),
                        coef, offs, vals, tt)
    kern = _chain_step2(xe, jnp.concatenate([z4, r_t], 0),
                        jnp.concatenate([z4, p_t], 0),
                        coef, offs, vals, kt)
    x_out = x_out.at[0:1].set(true[0][HALO : HALO + 1])
    r_out = r_out.at[0:2].set(true[1][HALO : HALO + 2])
    p_out = p_out.at[0:2].set(true[2][HALO : HALO + 2])
    g = g + _gram10(*(q[sl] for q in true[1:])) \
          - _gram10(*(q[sl] for q in kern[1:]))

    # ---- bottom edge: ext local rows [Br-8, Br+4) -----------------------
    xe = jnp.concatenate([x_b, jnp.zeros_like(rb4)], 0)
    true_b = _chain_step2(xe, jnp.concatenate([r_b, rb4 * (1.0 - tb[STRIP:, None])], 0),
                          jnp.concatenate([p_b, pb4 * (1.0 - tb[STRIP:, None])], 0),
                          coef, offs, vals, tb)
    kern_b = _chain_step2(xe, jnp.concatenate([r_b, z4], 0),
                          jnp.concatenate([p_b, z4], 0),
                          coef, offs, vals, kb)
    slb = slice(HALO, HALO + HALO)  # local rows [Br-4, Br)
    x_out = x_out.at[Br - 1 : Br].set(true_b[0][STRIP - 1 : STRIP])
    r_out = r_out.at[Br - 2 : Br].set(true_b[1][STRIP - 2 : STRIP])
    p_out = p_out.at[Br - 2 : Br].set(true_b[2][STRIP - 2 : STRIP])
    g = g + _gram10(*(q[slb] for q in true_b[1:])) \
          - _gram10(*(q[slb] for q in kern_b[1:]))
    return x_out, r_out, p_out, g


def gram2_fixup(g, r, p, halos, offs, vals, axis, S):
    """Repair one zero-halo gram2 pass (bootstrap / drift refresh): the
    corrupted contributions have depth <= 2, a subset of the step2 strips,
    so the same 12-row strips are recomputed."""
    rt4, pt4, rb4, pb4 = halos
    Br = r.shape[0]
    dt = r.dtype
    is_first = jax.lax.axis_index(axis) == 0
    is_last = jax.lax.axis_index(axis) == S - 1
    tt, kt, tb, kb = _edge_masks(Br, is_first, is_last, dt)
    z4 = jnp.zeros_like(rt4)
    sl = slice(HALO, HALO + HALO)

    r_t, p_t = r[:STRIP], p[:STRIP]
    true = _chain_gram2(jnp.concatenate([rt4 * (1.0 - tt[:HALO, None]), r_t], 0),
                        jnp.concatenate([pt4 * (1.0 - tt[:HALO, None]), p_t], 0),
                        offs, vals, tt)
    kern = _chain_gram2(jnp.concatenate([z4, r_t], 0),
                        jnp.concatenate([z4, p_t], 0), offs, vals, kt)
    g = g + _gram10(*(q[sl] for q in true)) - _gram10(*(q[sl] for q in kern))

    r_b, p_b = r[Br - STRIP :], p[Br - STRIP :]
    true_b = _chain_gram2(
        jnp.concatenate([r_b, rb4 * (1.0 - tb[STRIP:, None])], 0),
        jnp.concatenate([p_b, pb4 * (1.0 - tb[STRIP:, None])], 0),
        offs, vals, tb)
    kern_b = _chain_gram2(jnp.concatenate([r_b, z4], 0),
                          jnp.concatenate([p_b, z4], 0), offs, vals, kb)
    g = g + _gram10(*(q[sl] for q in true_b)) \
          - _gram10(*(q[sl] for q in kern_b))
    return g
