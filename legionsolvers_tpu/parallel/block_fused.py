"""Fused multi-space (block-system) solver schedules.

The reference's benchmark *default stress config* registers the same matrix
twice over two sol/rhs spaces (reference: BenchmarkStencil.cpp:201-207) —
a block-diagonal system.  A Krylov iteration on a
block-diagonal system is the SAME per-space kernel passes with the scalar
reductions summed across spaces — every dot of a block vector is the sum of
per-space dots, so

    global CG/BiCGStab on  diag(A_0 .. A_{S-1})
  = per-space passes + cross-space scalar sums between them,

exactly (not an approximation; the coupling between spaces is only through
alpha/beta/omega).  This module factors each fused schedule of
``parallel/stencil_op.py`` into per-space *phase* closures cut at the
scalar-reduction boundaries, and drives them with one compiled loop:

* CG two-pass (32 B/unknown/space): phases prologue_pq / xpay_pq / update
  (mirrors StencilOperator.make_fused_cg_runner's body);
* CG s-step (12 B/unknown/space): phases gram / step2 / odd_update with the
  GLOBAL Gram matrix feeding ``cg2_coeffs`` (mirrors _make_step2_cg_runner;
  the per-space Gram matrices of {r, Ar, p, Ap, A^2p} sum to the block
  system's Gram);
* BiCGStab three-pass (60 B/unknown/space): phases pv / st / update cut at
  the rtv -> alpha, (ts, tt) -> omega, (rr, rtr) boundaries (mirrors
  make_fused_bicgstab_runner, including the sharded single-exchange
  edge-fixup structure);
* classic phases for operators without the grid view (any geometry/dtype,
  incl. the f64 golden path).

Sharded spaces compose transparently: per-space phases keep their internal
``psum``/``ppermute`` (sum-then-psum == psum-then-sum), and the block
runner wraps ALL spaces' local arrays in one ``shard_map``.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from ..options import SHARD_AXIS


# ======================================================================
# per-space phase builders
# ======================================================================

def _view_geom(op):
    v = op._view
    C, Br, offs = v["C"], v["Br"], v["offs"]
    rlo = max(0, -min(dy for dy, _ in offs))
    rhi = max(0, max(dy for dy, _ in offs))
    return v, C, Br, offs, v["vals"], rlo, rhi


class _Phases:
    """Plain namespace; one instance per space."""


def _psum_fn(sharded):
    if sharded:
        return lambda s: jax.lax.psum(s, SHARD_AXIS)
    return lambda s: s


def _cg_jnp_phases(op):
    """Fallback CG phases from the operator's local matvec (classic 6-op
    schedule, q materialized).  Arithmetic order matches CGSolver.step so
    f64 golden trajectories survive (mirrors _make_jnp_cg_runner)."""
    S = op.partition.num_pieces
    sharded = S > 1
    psum = _psum_fn(sharded)
    ph = _Phases()

    def reshape_in(a):
        return a.reshape(-1) if a.ndim > 1 else a

    ph.grid_in = reshape_in
    ph.grid_out = lambda a, ref: a.reshape(ref.shape)

    def ldot(a, b):
        return psum(jnp.sum(a * b))

    def prologue(p):
        q = op._local_matvec(p, sharded=sharded)
        return ldot(p, q), q

    def xpay_pq(r, p, beta):
        p = r + beta.astype(p.dtype) * p
        q = op._local_matvec(p, sharded=sharded)
        return p, ldot(p, q), q

    def update(p, x, r, alpha, q):
        a = alpha.astype(p.dtype)
        x = x + a * p
        r = r - a * q
        return x, r, ldot(r, r)

    ph.prologue, ph.xpay_pq, ph.update = prologue, xpay_pq, update
    return ph


def _cg_2d_phases(op):
    """Two-pass fused CG phases (mirrors make_fused_cg_runner's 2-D body,
    including the sharded zero-halo overlap + dot_fixup structure)."""
    from ..ops.grid2d import grid2d_cg_pq, grid2d_cg_update, grid2d_cg_xpay_pq
    from .overlap import dot_fixup

    v, C, Br, offs, vals, rlo, rhi = _view_geom(op)
    S = op.partition.num_pieces
    sharded = S > 1
    psum = _psum_fn(sharded)
    kw = dict(offsets=offs, values=vals)
    coeff = lambda k, sl: jnp.asarray(vals[k], op.options.entry_dtype)
    ph = _Phases()
    ph.grid_in = lambda a: a.reshape(Br, C) if a.ndim == 1 else a
    ph.grid_out = lambda a, ref: a.reshape(ref.shape)

    def exchange(*grids):
        dtype = grids[0].dtype
        tops = [jnp.zeros((8, C), dtype) for _ in grids]
        bots = [jnp.zeros((8, C), dtype) for _ in grids]
        if sharded and rlo > 0:
            edge = jnp.concatenate([g[Br - rlo :] for g in grids], 0)
            t = jax.lax.ppermute(
                edge, SHARD_AXIS, [(i, (i + 1) % S) for i in range(S)]
            )
            t = jnp.where(
                jax.lax.axis_index(SHARD_AXIS) == 0, jnp.zeros_like(t), t
            )
            tops = [
                z.at[8 - rlo :, :].set(t[k * rlo : (k + 1) * rlo])
                for k, z in enumerate(tops)
            ]
        if sharded and rhi > 0:
            edge = jnp.concatenate([g[:rhi] for g in grids], 0)
            b = jax.lax.ppermute(
                edge, SHARD_AXIS, [(i, (i - 1) % S) for i in range(S)]
            )
            b = jnp.where(
                jax.lax.axis_index(SHARD_AXIS) == S - 1, jnp.zeros_like(b), b
            )
            bots = [
                z.at[:rhi, :].set(b[k * rhi : (k + 1) * rhi])
                for k, z in enumerate(bots)
            ]
        return tops, bots

    def prologue(p):
        (p_top,), (p_bot,) = exchange(p)
        if sharded and (rlo or rhi):
            z = jnp.zeros((8, C), p.dtype)
            pq = psum(
                grid2d_cg_pq(p, z, z, **kw)
                + dot_fixup(p, offs, p_top, p_bot, coeff)
            )
        else:
            pq = psum(grid2d_cg_pq(p, p_top, p_bot, **kw))
        return pq, (p_top, p_bot)

    def xpay_pq(r, p, beta):
        (r_top, p_top), (r_bot, p_bot) = exchange(r, p)
        bb = beta.astype(p.dtype)
        if sharded and (rlo or rhi):
            z = jnp.zeros((8, C), p.dtype)
            p, pq = grid2d_cg_xpay_pq(r, p, beta, z, z, z, z, **kw)
            ptop = r_top + bb * p_top
            pbot = r_bot + bb * p_bot
            pq = pq + dot_fixup(p, offs, ptop, pbot, coeff)
        else:
            p, pq = grid2d_cg_xpay_pq(
                r, p, beta, r_top, r_bot, p_top, p_bot, **kw
            )
            ptop = r_top + bb * p_top
            pbot = r_bot + bb * p_bot
        return p, psum(pq), (ptop, pbot)

    def update(p, x, r, alpha, ctx):
        ptop, pbot = ctx
        x, r, rr = grid2d_cg_update(p, x, r, alpha, ptop, pbot, **kw)
        return x, r, psum(rr)

    ph.prologue, ph.xpay_pq, ph.update = prologue, xpay_pq, update
    return ph


def _cg_3d_phases(op):
    """3-D grid CG phases (mirrors _make_grid3d_cg_runner)."""
    from ..ops.grid3d import grid3d_cg_pq, grid3d_cg_update, grid3d_cg_xpay_pq

    v = op._view
    Y, Z, Br = v["Y"], v["Z"], v["Br"]
    S = op.partition.num_pieces
    sharded = S > 1
    psum = _psum_fn(sharded)
    kw = dict(offsets=v["offs3"], values=v["vals"])
    ph = _Phases()
    ph.grid_in = lambda a: a.reshape(Br, Y, Z) if a.ndim == 1 else a
    ph.grid_out = lambda a, ref: a.reshape(ref.shape)

    def prologue(p):
        top, bot = op._exchange_planes3d(p, sharded=sharded)
        pq = psum(grid3d_cg_pq(p, top, bot, **kw))
        return pq, (top, bot)

    def xpay_pq(r, p, beta):
        bb = beta.astype(p.dtype)
        rt, rb = op._exchange_planes3d(r, sharded=sharded)
        pt, pb = op._exchange_planes3d(p, sharded=sharded)
        pn_t = rt + bb * pt
        pn_b = rb + bb * pb
        p, pq = grid3d_cg_xpay_pq(r, p, bb, pn_t, pn_b, **kw)
        return p, psum(pq), (pn_t, pn_b)

    def update(p, x, r, alpha, ctx):
        top, bot = ctx
        x, r, rr = grid3d_cg_update(p, x, r, alpha, top, bot, **kw)
        return x, r, psum(rr)

    ph.prologue, ph.xpay_pq, ph.update = prologue, xpay_pq, update
    return ph


def _cg_step2_phases(op):
    """s-step CG phases (mirrors _make_step2_cg_runner: gram bootstrap,
    zero-halo step2 pass with sharded edge fixup, odd-iteration tail)."""
    from ..ops.grid2d import acc_dtype, grid2d_cg_update
    from ..ops.pallas.sstep2d import gram2 as grid2d_cg_gram2
    from ..ops.pallas.sstep2d import step2 as grid2d_cg_step2
    from .sstep_sharded import (
        STRIP,
        exchange_halo4,
        gram2_fixup,
        step2_fixup,
    )
    from .overlap import edge_missing

    v, C, Br, offs, vals, rlo, rhi = _view_geom(op)
    S = op.partition.num_pieces
    sharded = S > 1
    kw = dict(offsets=offs, values=vals)
    ph = _Phases()
    ph.grid_in = lambda a: a.reshape(Br, C) if a.ndim == 1 else a
    ph.grid_out = lambda a, ref: a.reshape(ref.shape)

    def gram(r, p):
        if not sharded:
            return grid2d_cg_gram2(r, p, **kw)
        halos = exchange_halo4(r, p, SHARD_AXIS, S)
        g = grid2d_cg_gram2(r, p, **kw)
        g = gram2_fixup(g, r, p, halos, offs, vals, SHARD_AXIS, S)
        return jax.lax.psum(g, SHARD_AXIS)

    def step2(x, r, p, coef):
        if not sharded:
            return grid2d_cg_step2(x, r, p, coef, **kw)
        halos = exchange_halo4(r, p, SHARD_AXIS, S)
        saves = (x[:STRIP], r[:STRIP], p[:STRIP],
                 x[-STRIP:], r[-STRIP:], p[-STRIP:])
        x, r, p, g = grid2d_cg_step2(x, r, p, coef, **kw)
        x, r, p, g = step2_fixup(
            (x, r, p, g), saves, halos, coef, offs, vals, SHARD_AXIS, S
        )
        return x, r, p, jax.lax.psum(g, SHARD_AXIS)

    def odd_update(p, x, r, alpha):
        """One plain CG update from the current p (used for the odd
        trailing iteration); returns (x, r, rr_partial)."""
        if not sharded:
            z = jnp.zeros((8, C), p.dtype)
            x, r, rr = grid2d_cg_update(p, x, r, alpha, z, z, **kw)
            return x, r, rr
        rt_, pt, rb_, pb = exchange_halo4(r, p, SHARD_AXIS, S)
        top = jnp.zeros((8, C), p.dtype).at[8 - 4 :, :].set(pt)
        bot = jnp.zeros((8, C), p.dtype).at[:4, :].set(pb)
        z = jnp.zeros((8, C), p.dtype)
        x, r, rr_loc = grid2d_cg_update(p, x, r, alpha, z, z, **kw)
        coeff = lambda kk, sl: jnp.asarray(vals[kk], p.dtype)
        miss_alpha = alpha.astype(p.dtype)
        mt, mb = edge_missing(offs, top, bot, Br, coeff)
        if mt is not None:
            r = r.at[: mt.shape[0]].add(-miss_alpha * mt)
        if mb is not None:
            r = r.at[Br - mb.shape[0] :].add(-miss_alpha * mb)
        rr = jax.lax.psum(
            jnp.sum((r * r).astype(acc_dtype(r.dtype))), SHARD_AXIS
        )
        return x, r, rr

    ph.gram, ph.step2, ph.odd_update = gram, step2, odd_update
    return ph


def _bicg_jnp_phases(op):
    """Fallback BiCGStab phases from the operator's local matvec (s and t
    materialize; classic schedule, any geometry/dtype)."""
    S = op.partition.num_pieces
    sharded = S > 1
    psum = _psum_fn(sharded)
    ph = _Phases()
    ph.grid_in = lambda a: a.reshape(-1) if a.ndim > 1 else a
    ph.grid_out = lambda a, ref: a.reshape(ref.shape)

    def ldot(a, b):
        # entry-dtype accumulation (f64 on the golden path, acc otherwise),
        # matching the planner transcription's blas1.dot
        return psum(jnp.sum(a * b))

    def boot(r, rt):
        return ldot(r, r), ldot(rt, r)

    def pv(r, p, vv, rt, beta, omega):
        p = r + beta.astype(p.dtype) * (p - omega.astype(p.dtype) * vv)
        vv = op._local_matvec(p, sharded=sharded)
        return p, vv, ldot(rt, vv), None

    def st(r, vv, p, alpha, ctx):
        s = r - alpha.astype(r.dtype) * vv
        t = op._local_matvec(s, sharded=sharded)
        return ldot(t, s), ldot(t, t), (s, t)

    def update(r, vv, x, p, rt, alpha, omega, ctx):
        s, t = ctx
        a = alpha.astype(x.dtype)
        w = omega.astype(x.dtype)
        x = x + a * p + w * s
        r = s - w * t
        return x, r, ldot(r, r), ldot(rt, r)

    ph.boot, ph.pv, ph.st, ph.update = boot, pv, st, update
    return ph


def _bicg_2d_phases(op):
    """Three-pass fused BiCGStab phases, cut at the scalar boundaries
    rtv -> alpha, (ts, tt) -> omega, (rr, rtr) (mirrors
    make_fused_bicgstab_runner's 2-D body including the sharded
    single-exchange derived-halo fixups)."""
    from ..ops.grid2d import acc_dtype, apply2d as _apply
    from ..ops.grid2d import bicg_pv, bicg_st, bicg_update
    from .overlap import edge_missing

    v, C, Br, offs, vals, rlo, rhi = _view_geom(op)
    S = op.partition.num_pieces
    sharded = S > 1
    psum = _psum_fn(sharded)
    compensated = bool(op.options.compensated_dots)
    kw = dict(offsets=offs, values=vals, compensated=compensated)
    dtype = jnp.dtype(op.options.entry_dtype)
    coeff = lambda k, sl: jnp.asarray(vals[k], dtype)
    acc = acc_dtype(dtype)
    ph = _Phases()
    ph.grid_in = lambda a: a.reshape(Br, C) if a.ndim == 1 else a
    ph.grid_out = lambda a, ref: a.reshape(ref.shape)

    def exchange3(a, b, c, dlo, dhi):
        k = max(dlo, 1)
        m = max(dhi, 1)
        up = jnp.concatenate([a[-k:], b[-k:], c[-k:]], 0)
        dn_ = jnp.concatenate([a[:m], b[:m], c[:m]], 0)
        t = jax.lax.ppermute(
            up, SHARD_AXIS, [(i, (i + 1) % S) for i in range(S)])
        bt = jax.lax.ppermute(
            dn_, SHARD_AXIS, [(i, (i - 1) % S) for i in range(S)])
        idx = jax.lax.axis_index(SHARD_AXIS)
        t = jnp.where(idx == 0, jnp.zeros_like(t), t)
        bt = jnp.where(idx == S - 1, jnp.zeros_like(bt), bt)
        tops = (t[:k][-dlo:] if dlo else t[:0],
                t[k:2 * k][-dlo:] if dlo else t[:0],
                t[2 * k:][-dlo:] if dlo else t[:0])
        bots = (bt[:m][:dhi], bt[m:2 * m][:dhi], bt[2 * m:][:dhi])
        return tops, bots

    def pad8(top, bot):
        zt = jnp.zeros((8, C), dtype)
        zb = jnp.zeros((8, C), dtype)
        if rlo:
            zt = zt.at[8 - rlo :, :].set(top)
        if rhi:
            zb = zb.at[:rhi, :].set(bot)
        return zt, zb

    def edge_dot(a_top, a_bot, miss_t, miss_b):
        f = acc(0)
        if miss_t is not None:
            f = f + jnp.sum((a_top * miss_t).astype(acc))
        if miss_b is not None:
            f = f + jnp.sum((a_bot * miss_b).astype(acc))
        return f

    def t0_edges(s_loc_t, s_loc_b):
        t0t = t0b = None
        if rlo:
            ext = jnp.concatenate([jnp.zeros((rlo, C), dtype), s_loc_t], 0)
            t0t = _apply(ext, offs, vals)[rlo : 2 * rlo]
        if rhi:
            ext = jnp.concatenate([s_loc_b, jnp.zeros((rhi, C), dtype)], 0)
            t0b = _apply(ext, offs, vals)[-2 * rhi : -rhi]
        return t0t, t0b

    def boot(r, rt):
        if compensated:
            from ..ops.ddsum import dd_dot

            return (psum(dd_dot(r.reshape(-1), r.reshape(-1))),
                    psum(dd_dot(rt.reshape(-1), r.reshape(-1))))
        return (psum(jnp.sum((r * r).astype(acc))),
                psum(jnp.sum((rt * r).astype(acc))))

    def pv(r, p, vv, rt, beta, omega):
        if not sharded:
            p, vv, rtv = bicg_pv(r, p, vv, rt, beta, omega, **kw)
            return p, vv, rtv, None
        (r_t, p_t, v_t), (r_b, p_b, v_b) = exchange3(
            r, p, vv, 2 * rlo, 2 * rhi)
        bb = beta.astype(dtype)
        om = omega.astype(dtype)
        p, vv, rtv0 = bicg_pv(r, p, vv, rt, beta, omega, **kw)
        pn2_t = r_t + bb * (p_t - om * v_t) if rlo else r_t
        pn2_b = r_b + bb * (p_b - om * v_b) if rhi else r_b
        pn_t = pn2_t[-rlo:] if rlo else pn2_t
        pn_b = pn2_b[:rhi] if rhi else pn2_b
        pt8, pb8 = pad8(pn_t, pn_b)
        mv_t, mv_b = edge_missing(offs, pt8, pb8, Br, coeff)
        if mv_t is not None:
            vv = vv.at[:rlo].add(mv_t)
        if mv_b is not None:
            vv = vv.at[Br - rhi :].add(mv_b)
        rtv = psum(rtv0 + edge_dot(rt[:rlo], rt[Br - rhi :], mv_t, mv_b))
        return p, vv, rtv, (r_t, r_b, pn2_t, pn2_b)

    def st(r, vv, p, alpha, ctx):
        if not sharded:
            ts, tt = bicg_st(r, vv, alpha, **kw)
            return ts, tt, None
        r_t, r_b, pn2_t, pn2_b = ctx
        al = alpha.astype(dtype)
        idx_s = jax.lax.axis_index(SHARD_AXIS)
        r2_t = r_t[-rlo:] if rlo else r_t
        r2_b = r_b[:rhi] if rhi else r_b
        v2_t = v2_b = None
        if rlo:
            slab_t = jnp.concatenate([pn2_t, p[:rhi]], 0)
            v2_t = _apply(slab_t, offs, vals)[rlo : 2 * rlo]
            v2_t = jnp.where(idx_s == 0, jnp.zeros_like(v2_t), v2_t)
        if rhi:
            slab_b = jnp.concatenate([p[Br - rlo :], pn2_b], 0)
            v2_b = _apply(slab_b, offs, vals)[rlo : rlo + rhi]
            v2_b = jnp.where(idx_s == S - 1, jnp.zeros_like(v2_b), v2_b)
        ts0, tt0 = bicg_st(r, vv, alpha, **kw)
        s_t = r2_t - al * v2_t if rlo else r2_t
        s_b = r2_b - al * v2_b if rhi else r2_b
        st8, sb8 = pad8(s_t, s_b)
        mt_t, mt_b = edge_missing(offs, st8, sb8, Br, coeff)
        ctxr = rlo + rhi
        s_loc_t = (r[: rlo + ctxr] - al * vv[: rlo + ctxr]
                   if rlo else None)
        s_loc_b = (r[Br - rhi - ctxr :] - al * vv[Br - rhi - ctxr :]
                   if rhi else None)
        t0t, t0b = t0_edges(s_loc_t, s_loc_b)
        ts = psum(ts0 + edge_dot(
            s_loc_t[:rlo] if rlo else None,
            s_loc_b[-rhi:] if rhi else None, mt_t, mt_b))
        dtt = acc(0)
        if mt_t is not None:
            dtt = dtt + jnp.sum(
                (2.0 * t0t * mt_t + mt_t * mt_t).astype(acc))
        if mt_b is not None:
            dtt = dtt + jnp.sum(
                (2.0 * t0b * mt_b + mt_b * mt_b).astype(acc))
        tt = psum(tt0 + dtt)
        return ts, tt, (mt_t, mt_b, t0t, t0b, s_loc_t, s_loc_b)

    def update(r, vv, x, p, rt, alpha, omega, ctx):
        if not sharded:
            x, r, rr, rtr = bicg_update(r, vv, x, p, rt, alpha, omega, **kw)
            return x, r, rr, rtr
        mt_t, mt_b, t0t, t0b, s_loc_t, s_loc_b = ctx
        om2 = omega.astype(dtype)
        x, r, rr0_, rtr0 = bicg_update(r, vv, x, p, rt, alpha, omega, **kw)
        drr = acc(0)
        drtr = acc(0)
        if mt_t is not None:
            d_t = -om2 * mt_t
            r0e = s_loc_t[:rlo] - om2 * t0t
            r = r.at[:rlo].add(d_t)
            drr = drr + jnp.sum((2.0 * r0e * d_t + d_t * d_t).astype(acc))
            drtr = drtr + jnp.sum((rt[:rlo] * d_t).astype(acc))
        if mt_b is not None:
            d_b = -om2 * mt_b
            r0e = s_loc_b[-rhi:] - om2 * t0b
            r = r.at[Br - rhi :].add(d_b)
            drr = drr + jnp.sum((2.0 * r0e * d_b + d_b * d_b).astype(acc))
            drtr = drtr + jnp.sum((rt[Br - rhi :] * d_b).astype(acc))
        rr = psum(rr0_ + drr)
        rtr = psum(rtr0 + drtr)
        return x, r, rr, rtr

    ph.boot, ph.pv, ph.st, ph.update = boot, pv, st, update
    return ph


def _bicg_3d_phases(op):
    """3-D grid BiCGStab phases (single shard, mirrors
    _make_bicgstab3d_runner)."""
    from ..ops.grid2d import acc_dtype
    from ..ops.grid3d import bicg3d_pv, bicg3d_st, bicg3d_update

    v = op._view
    Y, Z, Br = v["Y"], v["Z"], v["Br"]
    compensated = bool(op.options.compensated_dots)
    kw = dict(offsets=v["offs3"], values=v["vals"], compensated=compensated)
    acc = acc_dtype(op.options.entry_dtype)
    ph = _Phases()
    ph.grid_in = lambda a: a.reshape(Br, Y, Z) if a.ndim == 1 else a
    ph.grid_out = lambda a, ref: a.reshape(ref.shape)

    def boot(r, rt):
        if compensated:
            from ..ops.ddsum import dd_dot

            return (dd_dot(r.reshape(-1), r.reshape(-1)),
                    dd_dot(rt.reshape(-1), r.reshape(-1)))
        return (jnp.sum((r * r).astype(acc)),
                jnp.sum((rt * r).astype(acc)))

    def pv(r, p, vv, rt, beta, omega):
        p, vv, rtv = bicg3d_pv(r, p, vv, rt, beta, omega, **kw)
        return p, vv, rtv, None

    def st(r, vv, p, alpha, ctx):
        ts, tt = bicg3d_st(r, vv, alpha, **kw)
        return ts, tt, None

    def update(r, vv, x, p, rt, alpha, omega, ctx):
        x, r, rr, rtr = bicg3d_update(r, vv, x, p, rt, alpha, omega, **kw)
        return x, r, rr, rtr

    ph.boot, ph.pv, ph.st, ph.update = boot, pv, st, update
    return ph


# ======================================================================
# phase selection
# ======================================================================

def diagonal_block_ops(planner):
    """Per-space operator list when the system is block-diagonal with
    exactly one operator per space (dom == rng == space), else None."""
    if len(planner.row_partitioned_matrices) != planner.num_spaces:
        return None
    ops = [None] * planner.num_spaces
    for op, di, ri in planner.row_partitioned_matrices:
        if di != ri or ops[ri] is not None:
            return None
        ops[ri] = op
    return ops


def _is_stencil_like(op):
    return hasattr(op, "_local_matvec") and hasattr(op, "_view")


def block_cg_supported(ops) -> bool:
    """All diagonal-block operators must be stencil operators sharing one
    mesh topology and each supporting a fused CG schedule."""
    if os.environ.get("LEGIONSOLVERS_NO_BLOCK_FUSED"):
        return False
    if not ops or not all(_is_stencil_like(op) for op in ops):
        return False
    if not all(getattr(op, "supports_fused_cg", False) for op in ops):
        return False
    S0 = ops[0].partition.num_pieces
    if any(op.partition.num_pieces != S0 for op in ops):
        return False
    if S0 > 1 and any(op.mesh is None for op in ops):
        return False
    return True


def block_bicgstab_supported(ops) -> bool:
    if os.environ.get("LEGIONSOLVERS_NO_BLOCK_FUSED"):
        return False
    if not ops or not all(_is_stencil_like(op) for op in ops):
        return False
    S0 = ops[0].partition.num_pieces
    if any(op.partition.num_pieces != S0 for op in ops):
        return False
    if S0 > 1 and any(op.mesh is None for op in ops):
        return False
    # per-space: fused three-pass where supported, jnp fallback otherwise —
    # mixtures are fine (phases share signatures)
    return True


def _cg_phases_for(op):
    v = op._view
    if v is None:
        return _cg_jnp_phases(op)
    if v.get("kind") == "3d":
        return _cg_3d_phases(op)
    return _cg_2d_phases(op)


def _bicg_phases_for(op):
    if getattr(op, "supports_fused_bicgstab", False):
        if op._view.get("kind") == "3d":
            return _bicg_3d_phases(op)
        return _bicg_2d_phases(op)
    return _bicg_jnp_phases(op)


# ======================================================================
# block runners
# ======================================================================

def _scalar_dtype(arrs):
    """f64 systems (the golden path) carry f64 reductions/history like the
    transcription; everything else accumulates in f32."""
    if all(a.dtype == jnp.float64 for a in arrs):
        return jnp.float64
    return jnp.float32


def _wrap(ops, local_run, in_groups, in_scalars, out_groups, out_scalars,
          donate_groups):
    """jit (single shard) or shard_map+jit (sharded) over per-space tuples.
    The first ``in_groups`` args are tuples of per-space arrays; the first
    ``donate_groups`` of those are donated (when nonzero)."""
    S = ops[0].partition.num_pieces
    dn = tuple(range(donate_groups))
    if S == 1:
        return jax.jit(local_run, donate_argnums=dn)
    mesh = ops[0].mesh
    fns = {}

    def build(ndims):
        fn = fns.get(ndims)
        if fn is None:
            group = tuple(
                P(SHARD_AXIS, *([None] * (nd - 1))) for nd in ndims
            )
            in_specs = (group,) * in_groups + (P(),) * in_scalars
            out_specs = (group,) * out_groups + (P(),) * out_scalars
            fn = jax.jit(
                jax.shard_map(
                    local_run, mesh=mesh, in_specs=in_specs,
                    out_specs=out_specs, check_vma=False,
                ),
                donate_argnums=dn,
            )
            fns[ndims] = fn
        return fn

    def runner(*args):
        ndims = tuple(a.ndim for a in args[0])
        return build(ndims)(*args)

    runner.build = build
    return runner


def make_block_cg_runner(ops, num_iterations: int, donate: bool = False):
    """Compiled whole-loop CG over a block-diagonal multi-space system.

    Contract: ``run(xs, rs, ps, rr0) -> (xs, rs, ps, history)`` with tuples
    of per-space arrays and the GLOBAL rr0 = sum of per-space <r, r>;
    history[0] = rr0.  Exact continuation of planner-transcription CG on
    the block system from any state (coefficients from cross-space-summed
    reductions).  Chooses the s-step schedule when EVERY space is
    step2-eligible (12 B/unknown/space/iteration), otherwise per-space
    two-pass / 3-D / jnp phases (mixtures allowed)."""
    if num_iterations < 1:
        raise ValueError("block CG runner needs at least one iteration")
    nsp = len(ops)
    if num_iterations >= 2 and all(
        getattr(op, "step2_eligible", False) for op in ops
    ):
        return _make_block_step2_runner(ops, num_iterations, donate)
    phases = [_cg_phases_for(op) for op in ops]

    def local_run(xs, rs, ps, rr0):
        refs = xs
        xs = [ph.grid_in(a) for ph, a in zip(phases, xs)]
        rs = [ph.grid_in(a) for ph, a in zip(phases, rs)]
        ps = [ph.grid_in(a) for ph, a in zip(phases, ps)]
        sdt = _scalar_dtype(xs)
        rr0 = jnp.asarray(rr0, sdt)
        hist = jnp.zeros(num_iterations + 1, sdt).at[0].set(rr0)
        # prologue: iteration 0 with the incoming p
        pq = sdt(0)
        ctxs = []
        for s in range(nsp):
            pq_s, ctx = phases[s].prologue(ps[s])
            pq = pq + pq_s
            ctxs.append(ctx)
        alpha = rr0 / pq
        rr = sdt(0)
        for s in range(nsp):
            xs[s], rs[s], rr_s = phases[s].update(
                ps[s], xs[s], rs[s], alpha, ctxs[s]
            )
            rr = rr + rr_s
        hist = hist.at[1].set(rr)

        def body(i, carry):
            xs, rs, ps, rr, rr_prev, hist = carry
            xs, rs, ps = list(xs), list(rs), list(ps)
            beta = rr / rr_prev
            pq = sdt(0)
            ctxs = []
            for s in range(nsp):
                ps[s], pq_s, ctx = phases[s].xpay_pq(rs[s], ps[s], beta)
                pq = pq + pq_s
                ctxs.append(ctx)
            alpha = rr / pq
            rr_new = sdt(0)
            for s in range(nsp):
                xs[s], rs[s], rr_s = phases[s].update(
                    ps[s], xs[s], rs[s], alpha, ctxs[s]
                )
                rr_new = rr_new + rr_s
            hist = hist.at[i + 1].set(rr_new)
            return tuple(xs), tuple(rs), tuple(ps), rr_new, rr, hist

        xs, rs, ps, rr, _, hist = jax.lax.fori_loop(
            1, num_iterations, body,
            (tuple(xs), tuple(rs), tuple(ps), rr, rr0, hist),
        )
        out = lambda arrs: tuple(
            ph.grid_out(a, ref) for ph, a, ref in zip(phases, arrs, refs)
        )
        return out(xs), out(rs), out(ps), hist

    return _wrap(ops, local_run, 3, 1, 3, 1, 3 if donate else 0)


def _make_block_step2_runner(ops, num_iterations: int, donate: bool):
    """s-step block CG: the per-space Gram matrices sum to the block
    system's Gram, so ``cg2_coeffs`` of the summed Gram yields the exact
    block-CG coefficients for both iterations of each pass."""
    from ..ops.grid2d import cg2_coeffs

    nsp = len(ops)
    phases = [_cg_step2_phases(op) for op in ops]
    K, odd = divmod(num_iterations, 2)
    refresh = int(os.environ.get("LEGIONSOLVERS_SSTEP_REFRESH", "16"))

    def local_run(xs, rs, ps, rr0):
        refs = xs
        xs = [ph.grid_in(a) for ph, a in zip(phases, xs)]
        rs = [ph.grid_in(a) for ph, a in zip(phases, rs)]
        ps = [ph.grid_in(a) for ph, a in zip(phases, ps)]
        sdt = _scalar_dtype(xs)
        rr0 = jnp.asarray(rr0, sdt)
        hist = jnp.zeros(num_iterations + 1, sdt).at[0].set(rr0)

        def gram_all(rs, ps):
            g = None
            for s in range(nsp):
                g_s = phases[s].gram(rs[s], ps[s])
                g = g_s if g is None else g + g_s
            return g

        g = gram_all(rs, ps)

        def body(k, carry):
            xs, rs, ps, g, hist = carry
            xs, rs, ps = list(xs), list(rs), list(ps)
            coef, rr1, _ = cg2_coeffs(g)
            g_new = None
            for s in range(nsp):
                xs[s], rs[s], ps[s], g_s = phases[s].step2(
                    xs[s], rs[s], ps[s], coef
                )
                g_new = g_s if g_new is None else g_new + g_s
            hist = hist.at[2 * k + 1].set(rr1)
            hist = hist.at[2 * k + 2].set(g_new[0])
            return tuple(xs), tuple(rs), tuple(ps), g_new, hist

        def run_block(state, base, count):
            def b(k, carry):
                return body(base + k, carry)

            return jax.lax.fori_loop(0, count, b, state)

        state = (tuple(xs), tuple(rs), tuple(ps), g, hist)
        if refresh > 0 and K > refresh:
            n_blocks, rem = divmod(K, refresh)
            state = run_block(state, jnp.int32(0), refresh)

            def outer(o, state):
                xs, rs, ps, g, hist = state
                g = gram_all(list(rs), list(ps))
                return run_block(
                    (xs, rs, ps, g, hist), (o + 1) * refresh, refresh
                )

            state = jax.lax.fori_loop(0, n_blocks - 1, outer, state)
            if rem:
                xs, rs, ps, g, hist = state
                g = gram_all(list(rs), list(ps))
                state = run_block(
                    (xs, rs, ps, g, hist), jnp.int32(n_blocks * refresh), rem
                )
        else:
            state = jax.lax.fori_loop(0, K, body, state)
        xs, rs, ps, g, hist = state
        xs, rs, ps = list(xs), list(rs), list(ps)
        if odd:
            alpha = g[0] / g[1]
            rr_new = sdt(0)
            for s in range(nsp):
                xs[s], rs[s], rr_s = phases[s].odd_update(
                    ps[s], xs[s], rs[s], alpha
                )
                rr_new = rr_new + rr_s
            hist = hist.at[num_iterations].set(rr_new)
            bb = rr_new / g[0]
            for s in range(nsp):
                ps[s] = rs[s] + bb.astype(ps[s].dtype) * ps[s]
        out = lambda arrs: tuple(
            ph.grid_out(a, ref) for ph, a, ref in zip(phases, arrs, refs)
        )
        return out(xs), out(rs), out(ps), hist

    return _wrap(ops, local_run, 3, 1, 3, 1, 3 if donate else 0)


def make_block_bicgstab_runner(ops, num_iterations: int,
                               donate: bool = False):
    """Compiled whole-loop BiCGStab over a block-diagonal multi-space
    system.  Contract mirrors the single-space fused runner with per-space
    tuples: ``run(xs, rs, ps, vs, rts, rho, alpha, omega) ->
    (xs, rs, ps, vs, rho, alpha, omega, history)``; exact continuation of
    the transcription recurrence on the block system (every carried dot is
    summed across spaces before the scalar recurrences)."""
    nsp = len(ops)
    phases = [_bicg_phases_for(op) for op in ops]

    def local_run(xs, rs, ps, vs, rts, rho, alpha, omega):
        refs = xs
        gi = lambda arrs: [ph.grid_in(a) for ph, a in zip(phases, arrs)]
        xs, rs, ps, vs, rts = gi(xs), gi(rs), gi(ps), gi(vs), gi(rts)
        sdt = _scalar_dtype(xs)
        rho, alpha, omega = (jnp.asarray(s, sdt)
                             for s in (rho, alpha, omega))
        rr0 = sdt(0)
        rtr = sdt(0)
        for s in range(nsp):
            rr_s, rtr_s = phases[s].boot(rs[s], rts[s])
            rr0 = rr0 + rr_s
            rtr = rtr + rtr_s
        hist = jnp.zeros(num_iterations + 1, sdt).at[0].set(rr0)

        def body(i, carry):
            xs, rs, ps, vs, rho, alpha, omega, rtr, hist = carry
            xs, rs, ps, vs = list(xs), list(rs), list(ps), list(vs)
            rho_new = rtr
            beta = (rho_new / rho) * (alpha / omega)
            rtv = sdt(0)
            ctx1 = []
            for s in range(nsp):
                ps[s], vs[s], rtv_s, c = phases[s].pv(
                    rs[s], ps[s], vs[s], rts[s], beta, omega
                )
                rtv = rtv + rtv_s
                ctx1.append(c)
            alpha = rho_new / rtv
            ts = sdt(0)
            tt = sdt(0)
            ctx2 = []
            for s in range(nsp):
                ts_s, tt_s, c = phases[s].st(
                    rs[s], vs[s], ps[s], alpha, ctx1[s]
                )
                ts = ts + ts_s
                tt = tt + tt_s
                ctx2.append(c)
            omega = ts / tt
            rr = sdt(0)
            rtr = sdt(0)
            for s in range(nsp):
                xs[s], rs[s], rr_s, rtr_s = phases[s].update(
                    rs[s], vs[s], xs[s], ps[s], rts[s], alpha, omega, ctx2[s]
                )
                rr = rr + rr_s
                rtr = rtr + rtr_s
            hist = hist.at[i + 1].set(rr)
            return (tuple(xs), tuple(rs), tuple(ps), tuple(vs),
                    rho_new, alpha, omega, rtr, hist)

        (xs, rs, ps, vs, rho, alpha, omega, rtr, hist) = jax.lax.fori_loop(
            0, num_iterations, body,
            (tuple(xs), tuple(rs), tuple(ps), tuple(vs),
             rho, alpha, omega, rtr, hist),
        )
        out = lambda arrs: tuple(
            ph.grid_out(a, ref) for ph, a, ref in zip(phases, arrs, refs)
        )
        return (out(xs), out(rs), out(ps), out(vs),
                rho, alpha, omega, hist)

    return _wrap(ops, local_run, 5, 3, 4, 4, 4 if donate else 0)
