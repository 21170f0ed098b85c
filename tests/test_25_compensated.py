"""Compensated (two-float) reductions for f32 solves.

The reference runs f64 end-to-end (reference: test_all.py:130-133 goldens on
double).  In f32, rho-class dots at large n fall below the f32 cancellation
noise floor and the trajectory becomes reduction-order chaotic;
ops/ddsum.py carries those reductions as two-float (hi, lo) pairs instead.
These tests pin:

* EFT building blocks are exact (two_sum / two_prod identities in f64);
* dd_dot reaches ~2x-precision on catastrophically cancelling dots where
  plain f32 loses every digit;
* the compensated fused BiCGStab passes reproduce f64 oracle dots to
  f32-representation accuracy;
* the solver option wires through (planner.dot + fused runner).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from legionsolvers_tpu.ops.ddsum import (
    dd_add,
    dd_dot,
    dd_dot_tile,
    two_prod,
    two_sum,
)

OFFS = ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1))
VALS = (4.0, -1.0, -1.0, -1.0, -1.0)
KW = dict(offsets=OFFS, values=VALS)


def test_eft_identities_exact():
    rng = np.random.default_rng(0)
    a = rng.standard_normal(4096).astype(np.float32) * 1e3
    b = rng.standard_normal(4096).astype(np.float32) * 1e-3
    s, e = two_sum(jnp.asarray(a), jnp.asarray(b))
    # s + e == a + b exactly (compare in f64: both sides representable)
    np.testing.assert_array_equal(
        np.asarray(s, np.float64) + np.asarray(e, np.float64),
        a.astype(np.float64) + b.astype(np.float64),
    )
    p, pe = two_prod(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_array_equal(
        np.asarray(p, np.float64) + np.asarray(pe, np.float64),
        a.astype(np.float64) * b.astype(np.float64),
    )


def test_dd_dot_cancellation():
    """x . y engineered to cancel catastrophically (condition ~ 1e9 — the
    rho regime of PROFILE_r03.md): plain f32 loses every digit, dd keeps
    f32-representation accuracy, the (hi, lo) pair ~2x precision."""
    rng = np.random.default_rng(1)
    half = (1 << 19) - 1
    z = rng.standard_normal(half).astype(np.float32)
    w = rng.standard_normal(half).astype(np.float32)
    # sum(z*w) - sum(z*w) == 0 exactly; one tiny surviving term
    x = np.concatenate([z, z, np.float32([1.0, 0.0])])
    y = np.concatenate([w, -w, np.float32([1e-3, 0.0])])
    exact = np.dot(x.astype(np.float64), y.astype(np.float64))
    assert abs(exact - 1e-3) < 1e-9  # the pairwise terms cancel exactly
    cond = 2.0 * np.abs(z.astype(np.float64) * w).sum() / exact
    assert cond > 1e8
    naive = float(jnp.sum(jnp.asarray(x) * jnp.asarray(y)))
    dd = float(dd_dot(jnp.asarray(x), jnp.asarray(y)))
    assert abs(naive - exact) / exact > 1e-2   # f32: no digits survive
    assert abs(dd - exact) / exact < 1e-4      # dd: f32-representation
    hi, lo = dd_dot_tile(jnp.asarray(x).reshape(-1, 512),
                         jnp.asarray(y).reshape(-1, 512))
    pair = np.float64(np.asarray(hi)) + np.float64(np.asarray(lo))
    assert abs(pair - exact) / exact < 1e-7    # the pair holds ~2x bits


def test_dd_dot_odd_sizes():
    rng = np.random.default_rng(2)
    for n in (100, 127, 1000, 4097):
        x = rng.standard_normal(n).astype(np.float32)
        y = rng.standard_normal(n).astype(np.float32)
        exact = np.dot(x.astype(np.float64), y.astype(np.float64))
        dd = float(dd_dot(jnp.asarray(x), jnp.asarray(y)))
        assert abs(dd - exact) <= 2e-7 * abs(exact) + 1e-6


def test_compensated_kernel_dots_match_f64():
    from legionsolvers_tpu.ops.grid2d import bicg_st, bicg_update

    rng = np.random.default_rng(7)
    shp = (32, 128)
    st = {k: rng.standard_normal(shp).astype(np.float32)
          for k in ("x", "r", "p", "v", "rt")}
    alpha, omega = 0.83, 0.41

    def apply_np(v):
        R, C = v.shape
        out = np.zeros_like(v)
        for (dy, dx), w in zip(OFFS, VALS):
            src = np.zeros_like(v)
            ys = slice(max(0, dy), R + min(0, dy))
            yd = slice(max(0, -dy), R + min(0, -dy))
            xs = slice(max(0, dx), C + min(0, dx))
            xd = slice(max(0, -dx), C + min(0, -dx))
            src[yd, xd] = v[ys, xs]
            out += w * src
        return out

    # f64 oracle of the SAME f32 inputs: the compensated kernel's dots must
    # agree to f32-representation accuracy (the plain kernel only to
    # accumulated f32 rounding)
    s64 = st["r"].astype(np.float64) - alpha * st["v"].astype(np.float64)
    # the kernel computes s in f32, then t = A s — mirror that
    s32 = (st["r"] - np.float32(alpha) * st["v"]).astype(np.float32)
    t64 = apply_np(s32.astype(np.float64))
    ts_e = float((t64 * s32).sum())
    tt_e = float((t64 * t64).sum())
    ts, tt = bicg_st(jnp.asarray(st["r"]), jnp.asarray(st["v"]),
                     alpha, compensated=True, **KW)
    assert abs(float(ts) - ts_e) <= 4e-7 * abs(ts_e)
    assert abs(float(tt) - tt_e) <= 4e-7 * abs(tt_e)

    xo, ro, rr, rtr = bicg_update(
        jnp.asarray(st["r"]), jnp.asarray(st["v"]), jnp.asarray(st["x"]),
        jnp.asarray(st["p"]), jnp.asarray(st["rt"]),
        alpha, omega, compensated=True, **KW)
    # r' in f32 exactly as the kernel forms it
    t32 = np.asarray(
        jnp.asarray(apply_np(s32.astype(np.float64)), jnp.float32))
    r32 = (s32 - np.float32(omega) * t32).astype(np.float32)
    rn64 = np.asarray(ro, np.float64)
    rr_e = float((rn64 * rn64).sum())
    rtr_e = float((st["rt"].astype(np.float64) * rn64).sum())
    assert abs(float(rr) - rr_e) <= 4e-7 * abs(rr_e)
    assert abs(float(rtr) - rtr_e) <= 4e-7 * max(abs(rtr_e), 1.0)
    del s64, r32


def _solve(shape, iters, compensated):
    from legionsolvers_tpu import (
        BlockPartition,
        BiCGStabSolver,
        PartitionedVector,
        SolverOptions,
        SquarePlanner,
        StencilOperator,
        laplacian_stencil,
    )

    F = SolverOptions(entry_dtype=jnp.float32, compensated_dots=compensated)
    n = int(np.prod(shape))
    part = BlockPartition(n, 1)
    op = StencilOperator(shape, laplacian_stencil(2), partition=part,
                         mesh=None, options=F)
    pl_ = SquarePlanner(mesh=None, options=F)
    gs = shape if op.uses_grid_view else None
    pl_.add_sol_vector(PartitionedVector(
        "s", part, options=F, grid_shape=gs).zero_fill())
    pl_.add_rhs_vector(PartitionedVector(
        "b", part, options=F, grid_shape=gs).constant_fill(1.0))
    pl_.add_operator(op, 0, 0)
    return np.asarray(BiCGStabSolver(pl_).solve(iters))


def test_compensated_fused_solve_matches_plain():
    """At small n (no cancellation catastrophe) the compensated and plain
    fused solves must track each other closely — compensation changes the
    noise, not the recurrence."""
    h_plain = _solve((40, 128), 8, compensated=False)
    h_comp = _solve((40, 128), 8, compensated=True)
    assert h_comp.shape == h_plain.shape
    np.testing.assert_allclose(h_comp, h_plain, rtol=5e-3)


def test_planner_dot_compensated_flag():
    from legionsolvers_tpu import (
        BlockPartition,
        PartitionedVector,
        SolverOptions,
        SquarePlanner,
    )

    rng = np.random.default_rng(3)
    n = 1 << 16
    x = rng.standard_normal(n).astype(np.float32)
    y = (-x + (1e-5 * rng.standard_normal(n)).astype(np.float32)).astype(
        np.float32
    )
    exact = np.dot(x.astype(np.float64), y.astype(np.float64))
    part = BlockPartition(n, 1)
    for comp in (False, True):
        F = SolverOptions(entry_dtype=jnp.float32, compensated_dots=comp)
        pl_ = SquarePlanner(mesh=None, options=F)
        vx = PartitionedVector("x", part, options=F)
        vy = PartitionedVector("y", part, options=F)
        vx.data = jnp.asarray(x)
        vy.data = jnp.asarray(y)
        pl_.add_sol_vector(vx)
        pl_.add_rhs_vector(vy)
        d = float(pl_.dot(0, 1).value)
        if comp:
            assert abs(d - exact) / abs(exact) < 1e-5
