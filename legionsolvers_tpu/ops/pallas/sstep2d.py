"""Triton kernel: the s-step CG pass over a 2-D grid.

One pass applies two CG iterations (``ops/grid2d.py`` has the algebra and
the plain jnp version of the same pass, :func:`~..grid2d.step2_jnp`): it
reads x, r and p once, writes x'', r'' and p'', and emits the Gram vector of
the new (r'', p'') for the next pass's coefficients.  That is 24 bytes per
unknown per pass at f32, 12 per iteration.  The intermediates A p, A u,
A p'', A^2 p'' and A r'' never reach device memory.

The pass chains up to four stencil applications, so an output row depends
on input rows up to four away.  Each program owns a strip of ``TC`` columns
and ``RB`` rows and walks down it one row per loop step, keeping every
intermediate's last rows in registers: the row shifts of the stencil are
then choices among carried rows, and the column shifts are separate copies
of each quantity at each column offset it is needed at (loaded from memory
for the inputs, where neighbouring programs' columns come from L2;
recomputed for the intermediates).  A program starts ``WARMUP`` rows above
its strip so that its carried rows are exact when it reaches the strip.

Rows outside the grid are zeros and every intermediate that is applied
again is re-masked to the grid, so the chained applications are true
powers of the Dirichlet matrix, exactly as in the jnp version.  Stencils
with ``|dy| <= 1`` and ``|dx| <= MAX_DX`` are supported.

Each program writes its ten Gram partials to one row of a
``[programs, 10]`` output that XLA sums.  The pass is zero-halo: sharded
runs repair the shard edges afterwards (``parallel/sstep_sharded.py``).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from . import interpret_mode
from ..grid2d import acc_dtype

MAX_DX = 1
WARMUP = {"step2": 8, "gram2": 4}
# (column tile, rows per program, warps, pipeline stages): the fastest of
# the configurations timed end to end at 4096^2 f32 on an H100
# (scripts/cg_schedules.py; PERF.md, bring-up findings)
DEFAULT_CONFIG = (128, 256, 4, 2)


def supported(offsets) -> bool:
    return all(abs(dy) <= 1 and abs(dx) <= MAX_DX for dy, dx in offsets)


def _rng(k):
    return range(-k, k + 1)


def _kernel(mode, offsets, values, R, C, TC, RB, dtype, interpret):
    N = R * C
    idt = jnp.int32 if N < 2**31 else jnp.int64
    acc = acc_dtype(dtype)
    d = max(abs(dx) for _, dx in offsets)
    terms = [(dy, dx, float(v)) for (dy, dx), v in zip(offsets, values)]
    W = WARMUP[mode]

    def apply(rows, s):
        """Stencil at column shift ``s`` of the centre row; ``rows`` maps
        dy -> {shift: vector}."""
        out = None
        for dy, dx, v in terms:
            t = rows[dy][s + dx]
            t = t if v == 1.0 else (-t if v == -1.0 else t * v)
            out = t if out is None else out + t
        return out

    def kernel(*refs):
        if mode == "step2":
            x_ref, r_ref, p_ref, c_ref, xo_ref, ro_ref, po_ref, g_ref = refs
        else:
            r_ref, p_ref, g_ref = refs
        zero = jnp.zeros((TC,), dtype)
        b = pl.program_id(0)
        j = pl.program_id(1)
        cols = j.astype(idt) * TC + jax.lax.broadcasted_iota(idt, (TC,), 0)
        colok = {s: (cols + s >= 0) & (cols + s < C) for s in _rng(4 * d)}
        first = b.astype(idt) * RB
        last = jnp.minimum(first + RB, R)

        def ok(m, s):
            return (m >= 0) & (m < R) & colok[s]

        def at(m, s):
            # masked lanes are never dereferenced on the GPU; the
            # interpreter gathers and scatters them, so it needs indices in
            # range that do not collide with a valid lane's
            i = m * C + cols + s
            return jnp.remainder(i, N) if interpret else i

        def load(ref, m, s, mask):
            return plgpu.load(ref.at[at(m, s)], mask=mask, other=zero)

        def rows_of(ref, m, k):
            return {s: load(ref, m, s, ok(m, s)) for s in _rng(k)}

        def masked_apply(m, rows, k):
            return {s: jnp.where(ok(m, s), apply(rows, s), zero)
                    for s in _rng(k)}

        def gram(G, rb, pb, Apb, A2pb, Arb, valid):
            pairs = ((rb, rb), (pb, Apb), (rb, Apb), (Apb, Apb), (rb, Arb),
                     (Apb, Arb), (Apb, A2pb), (Arb, Arb), (Arb, A2pb),
                     (A2pb, A2pb))
            return tuple(
                g + jnp.where(valid, (u * w).astype(acc), jnp.zeros((), acc))
                for g, (u, w) in zip(G, pairs)
            )

        def only(q, k):
            return {s: q[s] for s in _rng(k)}

        G0 = tuple(jnp.zeros((TC,), acc) for _ in range(10))
        k0 = first - W

        if mode == "gram2":
            def body(t, carry):
                P0, P1, APm, AP0, Rm, R0, G = carry
                k = k0 + t
                P2 = rows_of(p_ref, k + 2, 2 * d)
                R1 = rows_of(r_ref, k + 1, d)
                AP1 = masked_apply(k + 1, {-1: P0, 0: P1, 1: P2}, d)
                A2p = apply({-1: APm, 0: AP0, 1: AP1}, 0)
                Ar = apply({-1: Rm, 0: R0, 1: R1}, 0)
                valid = (k >= first) & (k < last) & colok[0]
                G = gram(G, R0[0], P0[0], AP0[0], A2p, Ar, valid)
                return P1, P2, AP0, AP1, R0, R1, G

            z2 = {s: zero for s in _rng(2 * d)}
            z1 = {s: zero for s in _rng(d)}
            carry = (z2, z2, z1, z1, z1, z1, G0)
        else:
            c = [c_ref[i].astype(dtype) for i in range(6)]

            def body(t, carry):
                P2, P3, R2, S2, U0, U1, U2, RNm, RN0, RN1, PN0, PN1, APm, AP0, G = carry
                k = k0 + t
                # inputs entering the window
                P4 = rows_of(p_ref, k + 4, 4 * d)
                R3 = rows_of(r_ref, k + 3, 3 * d)
                # A p and u = c0 p + c1 r - c2 A p on row k+3
                S3 = masked_apply(k + 3, {-1: P2, 0: P3, 1: P4}, 3 * d)
                U3 = {s: c[0] * P3[s] + c[1] * R3[s] - c[2] * S3[s]
                      for s in _rng(3 * d)}
                # r'' = r - A u and p'' on row k+2
                T2 = masked_apply(k + 2, {-1: U1, 0: U2, 1: U3}, 2 * d)
                RN2 = {s: R2[s] - T2[s] for s in _rng(2 * d)}
                PN2 = {s: RN2[s] + c[3] * R2[s] - c[4] * S2[s] + c[5] * P2[s]
                       for s in _rng(2 * d)}
                # A p'' on row k+1; A^2 p'' and A r'' on row k
                AP1 = masked_apply(k + 1, {-1: PN0, 0: PN1, 1: PN2}, d)
                A2p = apply({-1: APm, 0: AP0, 1: AP1}, 0)
                Ar = apply({-1: RNm, 0: RN0, 1: RN1}, 0)
                # row k is complete
                valid = (k >= first) & (k < last) & colok[0]
                i = at(k, 0)
                xk = plgpu.load(x_ref.at[i], mask=valid, other=zero)
                plgpu.store(xo_ref.at[i], xk + U0, mask=valid)
                plgpu.store(ro_ref.at[i], RN0[0], mask=valid)
                plgpu.store(po_ref.at[i], PN0[0], mask=valid)
                G = gram(G, RN0[0], PN0[0], AP0[0], A2p, Ar, valid)
                return (P3, P4, only(R3, 2 * d), only(S3, 2 * d), U1[0], U2,
                        U3, RN0, RN1, only(RN2, d), PN1, PN2, AP0, AP1, G)

            z4 = {s: zero for s in _rng(4 * d)}
            z3 = {s: zero for s in _rng(3 * d)}
            z2 = {s: zero for s in _rng(2 * d)}
            z1 = {s: zero for s in _rng(d)}
            carry = (z4, z4, z2, z2, zero, z3, z3, z1, z1, z1, z2, z2, z1,
                     z1, G0)

        G = jax.lax.fori_loop(0, RB + W, body, carry)[-1]
        pid = b * pl.num_programs(1) + j
        for q in range(10):
            g_ref[pid, q] = jnp.sum(G[q])

    return kernel


@functools.partial(
    jax.jit, static_argnames=("mode", "offsets", "values", "config")
)
def _call(x, r, p, coef, *, mode, offsets, values, config):
    R, C = r.shape
    dtype = r.dtype
    if not supported(offsets):
        raise ValueError(f"s-step kernel needs |dy| <= 1, |dx| <= {MAX_DX}")
    TC, RB, num_warps, num_stages = config
    grid = (pl.cdiv(R, RB), pl.cdiv(C, TC))
    nprog = grid[0] * grid[1]
    gram = jax.ShapeDtypeStruct((nprog, 10), acc_dtype(dtype))
    vec = jax.ShapeDtypeStruct((R * C,), dtype)
    if mode == "step2":
        args = (x.reshape(-1), r.reshape(-1), p.reshape(-1),
                coef.astype(acc_dtype(dtype)))
        out_shape = (vec, vec, vec, gram)
        aliases = {0: 0}  # each program reads x only where it writes x''
    else:
        args = (r.reshape(-1), p.reshape(-1))
        out_shape = (gram,)
        aliases = {}
    interpret = interpret_mode()
    outs = pl.pallas_call(
        _kernel(mode, offsets, values, R, C, TC, RB, dtype, interpret),
        grid=grid,
        out_shape=out_shape,
        input_output_aliases=aliases,
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=num_warps, num_stages=num_stages
        ),
        interpret=interpret,
        name=f"sstep2d_{mode}",
    )(*args)
    g = jnp.sum(outs[-1], axis=0)
    if mode == "gram2":
        return g
    xo, ro, po = (o.reshape(R, C) for o in outs[:3])
    return xo, ro, po, g


def gram2(r, p, *, offsets, values, config=None):
    """Gram vector (``grid2d.GRAM_NAMES`` order) of (r, p): the s-step
    bootstrap pass."""
    return _call(None, r, p, None, mode="gram2", offsets=tuple(offsets),
                 values=tuple(values), config=tuple(config or DEFAULT_CONFIG))


def step2(x, r, p, coef, *, offsets, values, config=None):
    """Two CG iterations in one pass: (x'', r'', p'', Gram of (r'', p''))
    given the coefficients of ``grid2d.cg2_coeffs``.  ``x`` is consumed."""
    return _call(x, r, p, coef, mode="step2", offsets=tuple(offsets),
                 values=tuple(values), config=tuple(config or DEFAULT_CONFIG))
