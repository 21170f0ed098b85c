"""Stencil passes over the 2-D grid view, in plain jnp.

A 2-D stencil operator's local block is the grid ``[R, C]``; offsets are
``(dy, dx)`` pairs.  Every pass here applies the stencil with rows outside
the block taken from caller-provided halo blocks (the neighbour shard's edge
rows; zeros at the global grid edge) and columns outside ``[0, C)`` zero —
the Dirichlet truncation of the matrix.  XLA fuses each pass into one loop
over the grid that reads each input once.

Halo contract: ``top`` holds the rows just above the block in its LAST rows,
``bot`` the rows just below in its FIRST rows; any row count covering the
stencil's row bandwidth works (the sharded runners pass 8-row blocks).

Passes (CG, reference recurrence CGSolver.hpp:46-55):

* :func:`grid2d_stencil_matvec` — y = A x (and <x, A x>);
* :func:`grid2d_cg_pq`          — <p, A p> without writing A p;
* :func:`grid2d_cg_update`      — x + alpha p, r - alpha A p, <r', r'>;
* :func:`grid2d_cg_xpay_pq`     — p = r + beta p_old and <p, A p>.

BiCGStab's three-pass schedule (reference: BiCGStabSolver.hpp:64-82):
:func:`bicg_pv`, :func:`bicg_st`, :func:`bicg_update` (zero-halo).

The s-step pass (two CG iterations per read of x, r, p) is
:func:`step2_jnp` with its bootstrap :func:`gram2_jnp`; the Triton kernel
``ops/pallas/sstep2d.py`` is checked against them.

Dots accumulate in float32, or in the entry dtype when it is wider.
"""

from __future__ import annotations

import inspect

import jax
import jax.numpy as jnp

def _pass(f):
    """Every pass is its own jitted function, so it shows up by name in
    jaxprs and profiles; stencil geometry and flags are static."""
    params = inspect.signature(f).parameters
    static = [a for a in ("offsets", "values", "with_dot", "compensated")
              if a in params]
    return jax.jit(f, static_argnames=static)


# Gram entries of {r, Ar, p, Ap, A^2p} that the s-step coefficients need,
# in the order every s-step pass emits them
GRAM_NAMES = ("rr", "pAp", "rAp", "ApAp", "rAr",
              "ApAr", "ApA2p", "ArAr", "ArA2p", "A2pA2p")


def acc_dtype(dtype):
    """Reduction dtype (scalar type) for vectors of ``dtype``: float32 or
    wider."""
    return jnp.promote_types(dtype, jnp.float32).type


def dot(a, b):
    return jnp.sum((a * b).astype(acc_dtype(a.dtype)))


def row_bandwidth(offsets):
    """(rows above, rows below) the stencil reaches."""
    rlo = max(0, -min(dy for dy, _ in offsets))
    rhi = max(0, max(dy for dy, _ in offsets))
    return rlo, rhi


def decompose_flat_offsets(flat_offsets, values, C: int):
    """Rewrite 1-D linearized shifts as (dy, dx) terms over a [R, C] view.

    A flat shift ``s = q*C + r`` (0 <= r < C) reads, for column c, either
    row+q col c+r (when c+r < C) or row+q+1 col c+r-C: two complementary
    column-masked terms, which the zero-filled column shifts of
    :func:`apply2d` produce exactly, so any 1-D banded operator maps onto
    the 2-D passes."""
    offs, vals = [], []
    for s, v in zip(flat_offsets, values):
        q, r = divmod(int(s), C)
        offs.append((q, r))
        vals.append(float(v))
        if r:
            offs.append((q + 1, r - C))
            vals.append(float(v))
    return tuple(offs), tuple(vals)


def colshift(rows2d, dx: int):
    """out[:, c] = rows2d[:, c + dx] where 0 <= c + dx < C, else 0."""
    C = rows2d.shape[1]
    if dx == 0:
        return rows2d
    if abs(dx) >= C:
        return jnp.zeros_like(rows2d)
    if dx > 0:
        return jnp.pad(rows2d[:, dx:], ((0, 0), (0, dx)))
    return jnp.pad(rows2d[:, : C + dx], ((0, 0), (-dx, 0)))


def _rowshift(v, dy: int, top, bot):
    """out[r] = v[r + dy], rows outside the block from the halos (zeros
    when the halo is None)."""
    R, C = v.shape
    if dy == 0:
        return v
    if dy > 0:
        fill = bot[:dy] if bot is not None else jnp.zeros((dy, C), v.dtype)
        return jnp.concatenate([v[dy:], fill.astype(v.dtype)], 0)
    k = -dy
    fill = (top[top.shape[0] - k:] if top is not None
            else jnp.zeros((k, C), v.dtype))
    return jnp.concatenate([fill.astype(v.dtype), v[: R - k]], 0)


def apply2d(v, offsets, values, top=None, bot=None):
    """One stencil application on the [R, C] block ``v``."""
    acc = None
    for (dy, dx), w in zip(offsets, values):
        sh = colshift(_rowshift(v, dy, top, bot), dx)
        t = sh if w == 1.0 else (-sh if w == -1.0 else w * sh)
        acc = t if acc is None else acc + t
    return acc


# ---------------------------------------------------------------- CG passes

@_pass
def grid2d_stencil_matvec(x, halo_top, halo_bot, *, offsets, values,
                          with_dot: bool = False):
    """y = A x (and <x, y> when ``with_dot``)."""
    y = apply2d(x, offsets, values, halo_top, halo_bot)
    return (y, dot(x, y)) if with_dot else y


@_pass
def grid2d_cg_pq(p, halo_top, halo_bot, *, offsets, values):
    """<p, A p>; A p is never stored."""
    return dot(p, apply2d(p, offsets, values, halo_top, halo_bot))


@_pass
def grid2d_cg_update(p, x, r, alpha, halo_top, halo_bot, *, offsets, values):
    """(x + alpha p, r - alpha A p, <r', r'>)."""
    a = jnp.asarray(alpha).astype(x.dtype)
    r = r - a * apply2d(p, offsets, values, halo_top, halo_bot)
    return x + a * p, r, dot(r, r)


@_pass
def grid2d_cg_xpay_pq(r, p_old, beta, r_top, r_bot, p_top, p_bot, *,
                      offsets, values):
    """(p, <p, A p>) with p = r + beta p_old; p's halo rows are formed from
    the r and p_old halos the same way."""
    b = jnp.asarray(beta).astype(r.dtype)
    p = r + b * p_old
    q = apply2d(p, offsets, values, r_top + b * p_top, r_bot + b * p_bot)
    return p, dot(p, q)


# ------------------------------------------------------------ s-step CG
#
# With s = 2, both iterations' coefficients are rational functions of the
# 10-entry Gram vector of {r, Ar, p, Ap, A^2p} that the previous pass
# emitted, so one pass applies two CG iterations (the reference's own fused
# double-CG sketch, reference: scripts/krylov.py:34-93):
#
#   a0 = rr/<p,Ap>;  r1 = r - a0 Ap;  rr1 = rr - 2 a0 <r,Ap> + a0^2 <Ap,Ap>
#   b1 = rr1/rr;     p1 = r1 + b1 p;  a1 = rr1/<p1,Ap1>
#   x'' = x + (a0 + a1 b1) p + a1 r - a0 a1 Ap
#   r'' = r - (a0 + a1 b1) Ap - a1 Ar + a0 a1 A^2p
#   p'' = r'' + b2 r - b2 a0 Ap + b2 b1 p          (b2 = rr2/rr1)

def cg2_coeffs(g):
    """(update coefficients [6], rr after iteration 1, rr after iteration
    2) from the Gram vector ``g`` ordered as :data:`GRAM_NAMES`."""
    rr, pAp, rAp, ApAp, rAr, ApAr, ApA2p, ArAr, ArA2p, A2pA2p = (
        g[i] for i in range(10)
    )
    a0 = rr / pAp
    rr1 = rr - 2.0 * a0 * rAp + a0 * a0 * ApAp
    b1 = rr1 / rr
    r1Ar1 = rAr - 2.0 * a0 * ApAr + a0 * a0 * ApA2p
    r1Ap = rAp - a0 * ApAp
    p1Ap1 = r1Ar1 + 2.0 * b1 * r1Ap + b1 * b1 * pAp
    a1 = rr1 / p1Ap1
    r1Ap1 = r1Ar1 + b1 * r1Ap
    Ar1Ap = ApAr - a0 * ApA2p
    Ar1Ar1 = ArAr - 2.0 * a0 * ArA2p + a0 * a0 * A2pA2p
    Ap1Ap1 = Ar1Ar1 + 2.0 * b1 * Ar1Ap + b1 * b1 * ApAp
    rr2 = rr1 - 2.0 * a1 * r1Ap1 + a1 * a1 * Ap1Ap1
    b2 = rr2 / rr1
    coef = jnp.stack([a0 + a1 * b1, a1, a0 * a1, b2, b2 * a0, b2 * b1])
    return coef, rr1, rr2


def gram10(rb, pb, Apb, A2pb, Arb):
    """The Gram vector in :data:`GRAM_NAMES` order."""
    return jnp.stack([
        dot(rb, rb), dot(pb, Apb), dot(rb, Apb), dot(Apb, Apb), dot(rb, Arb),
        dot(Apb, Arb), dot(Apb, A2pb), dot(Arb, Arb), dot(Arb, A2pb),
        dot(A2pb, A2pb),
    ])


@_pass
def gram2_jnp(r, p, *, offsets, values):
    """Gram vector of (r, p) over a zero-halo block — the s-step bootstrap
    pass."""
    ap = lambda u: apply2d(u, offsets, values)
    Ap = ap(p)
    return gram10(r, p, Ap, ap(Ap), ap(r))


@_pass
def step2_jnp(x, r, p, coef, *, offsets, values):
    """Two CG iterations over a zero-halo block given the coefficients from
    :func:`cg2_coeffs`: (x'', r'', p'', Gram vector of (r'', p'')).  Five
    stencil applications, by linearity:

        u   = c0 p + c1 r - c2 Ap        (= x'' - x)
        r'' = r - A u
        p'' = r'' + c3 r - c4 Ap + c5 p
    """
    ap = lambda u: apply2d(u, offsets, values)
    c0, c1, c2, c3, c4, c5 = (coef[i].astype(x.dtype) for i in range(6))
    Ap = ap(p)
    u = c0 * p + c1 * r - c2 * Ap
    rn = r - ap(u)
    pn = rn + c3 * r - c4 * Ap + c5 * p
    Apn = ap(pn)
    return x + u, rn, pn, gram10(rn, pn, Apn, ap(Apn), ap(rn))


# ------------------------------------------------------------- BiCGStab

def _bdot(a, b, compensated):
    if compensated:
        from .ddsum import dd_dot

        return dd_dot(a.reshape(-1), b.reshape(-1))
    return dot(a, b)


@_pass
def bicg_pv(r, p, v, rt, beta, omega, *, offsets, values,
            compensated: bool = False):
    """(p' = r + beta (p - omega v), v' = A p', <r~, v'>)."""
    dt = r.dtype
    p = r + jnp.asarray(beta).astype(dt) * (p - jnp.asarray(omega).astype(dt) * v)
    v = apply2d(p, offsets, values)
    return p, v, _bdot(rt, v, compensated)


@_pass
def bicg_st(r, v, alpha, *, offsets, values, compensated: bool = False):
    """(<t, s>, <t, t>) with s = r - alpha v and t = A s."""
    s = r - jnp.asarray(alpha).astype(r.dtype) * v
    t = apply2d(s, offsets, values)
    return _bdot(t, s, compensated), _bdot(t, t, compensated)


@_pass
def bicg_update(r, v, x, p, rt, alpha, omega, *, offsets, values,
                compensated: bool = False):
    """(x' = x + alpha p + omega s, r' = s - omega t, <r', r'>, <r~, r'>)
    with s and t recomputed."""
    dt = r.dtype
    a = jnp.asarray(alpha).astype(dt)
    w = jnp.asarray(omega).astype(dt)
    s = r - a * v
    t = apply2d(s, offsets, values)
    x = x + a * p + w * s
    r = s - w * t
    return x, r, _bdot(r, r, compensated), _bdot(rt, r, compensated)
