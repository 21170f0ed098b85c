"""Stencil passes over the 3-D grid view, in plain jnp.

The local block is ``[X, Y, Z]`` (whole x-planes per shard); offsets are
``(ox, oy, oz)`` with ``|ox| <= 1``.  The planes just before and after the
block come from caller-provided ``[Y, Z]`` halo planes (the neighbour
shard's edge planes; zeros at the global grid edge); y and z shifts are
zero-filled at the grid edge.  The passes mirror ``ops/grid2d.py``: matvec,
CG's pq / update / xpay_pq, and BiCGStab's pv / st / update (zero-halo,
single shard).
"""

from __future__ import annotations

import jax.numpy as jnp

from .grid2d import _bdot, _pass, dot


def _shift(v, axis: int, o: int):
    """out[.., i, ..] = v[.., i + o, ..] along ``axis``, zero-filled."""
    if o == 0:
        return v
    n = v.shape[axis]
    pad = [(0, 0)] * v.ndim
    idx = [slice(None)] * v.ndim
    if o > 0:
        idx[axis] = slice(o, n)
        pad[axis] = (0, o)
    else:
        idx[axis] = slice(0, n + o)
        pad[axis] = (-o, 0)
    return jnp.pad(v[tuple(idx)], pad)


def apply3d(v, offsets, values, top=None, bot=None):
    """One stencil application on the [X, Y, Z] block ``v``."""
    X, Y, Z = v.shape
    z = jnp.zeros((1, Y, Z), v.dtype)
    prev = z if top is None else top.reshape(1, Y, Z).astype(v.dtype)
    nxt = z if bot is None else bot.reshape(1, Y, Z).astype(v.dtype)
    planes = {
        -1: jnp.concatenate([prev, v[: X - 1]], 0),
        0: v,
        1: jnp.concatenate([v[1:], nxt], 0),
    }
    acc = None
    for (ox, oy, oz), w in zip(offsets, values):
        sh = _shift(_shift(planes[ox], 1, oy), 2, oz)
        t = sh if w == 1.0 else (-sh if w == -1.0 else w * sh)
        acc = t if acc is None else acc + t
    return acc


@_pass
def grid3d_stencil_matvec(x, halo_top, halo_bot, *, offsets, values,
                          with_dot: bool = False):
    y = apply3d(x, offsets, values, halo_top, halo_bot)
    return (y, dot(x, y)) if with_dot else y


@_pass
def grid3d_cg_pq(p, halo_top, halo_bot, *, offsets, values):
    return dot(p, apply3d(p, offsets, values, halo_top, halo_bot))


@_pass
def grid3d_cg_update(p, x, r, alpha, halo_top, halo_bot, *, offsets, values):
    a = jnp.asarray(alpha).astype(x.dtype)
    r = r - a * apply3d(p, offsets, values, halo_top, halo_bot)
    return x + a * p, r, dot(r, r)


@_pass
def grid3d_cg_xpay_pq(r, p_old, beta, pn_top, pn_bot, *, offsets, values):
    """(p, <p, A p>) with p = r + beta p_old; ``pn_top``/``pn_bot`` are p's
    halo planes (r_halo + beta p_halo)."""
    p = r + jnp.asarray(beta).astype(r.dtype) * p_old
    return p, dot(p, apply3d(p, offsets, values, pn_top, pn_bot))


@_pass
def bicg3d_pv(r, p, v, rt, beta, omega, *, offsets, values,
              compensated: bool = False):
    dt = r.dtype
    p = r + jnp.asarray(beta).astype(dt) * (p - jnp.asarray(omega).astype(dt) * v)
    v = apply3d(p, offsets, values)
    return p, v, _bdot(rt, v, compensated)


@_pass
def bicg3d_st(r, v, alpha, *, offsets, values, compensated: bool = False):
    s = r - jnp.asarray(alpha).astype(r.dtype) * v
    t = apply3d(s, offsets, values)
    return _bdot(t, s, compensated), _bdot(t, t, compensated)


@_pass
def bicg3d_update(r, v, x, p, rt, alpha, omega, *, offsets, values,
                  compensated: bool = False):
    dt = r.dtype
    a = jnp.asarray(alpha).astype(dt)
    w = jnp.asarray(omega).astype(dt)
    s = r - a * v
    t = apply3d(s, offsets, values)
    x = x + a * p + w * s
    r = s - w * t
    return x, r, _bdot(r, r, compensated), _bdot(rt, r, compensated)
