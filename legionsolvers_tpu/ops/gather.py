"""Gathers over host-planned layouts for general sparse matrices.

The general-sparsity tiers (``parallel/winell_op.py``, ``parallel/
distmatrix.py`` and ``parallel/genspmv.py``) plan their layouts on the host:
an RCM-banded windowed ELL, and a radix routing of an arbitrary static
gather into row-structured stages.  On the device each is one
``jnp.take`` over the plan's index arrays, which XLA lowers to a native
gather.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

# Window cap of the windowed-ELL planner, in chunks of 128 elements: a
# (tile, slot) whose column span exceeds it is not routed to that tier.
MAX_WINDOW_ROWS = 64
# Caps of the routed-gather planner's stages (rows of 1024 elements): a
# stage's gather window, destination block and source block.  A plain
# gather costs the same at any window, so these only bound plan sizes.
MAX_W_ROWS = 64
MAX_BLOCK_ROWS = 256
MAX_SRC_ROWS = 512


@functools.partial(jax.jit, static_argnames=("window_rows",))
def winell_spmv(x2d, wstart, cols, vals, *, window_rows: int):
    """y = A @ x with A in per-tile windowed ELL layout.

    ``x2d`` is x viewed as [NR, 128].  Tile t covers output rows
    [t*Rt*128, (t+1)*Rt*128); slot s of the tile multiplies ``vals[t, s]``
    with ``x[wstart[t, s]*128 + cols[t, s]]``, ``cols`` being indices into
    the slot's window of ``window_rows`` * 128 elements.  Padding slots
    carry val 0.  Returns y as [nt*Rt, 128]."""
    nt, L, Rt, C = cols.shape
    KR = int(window_rows)
    if KR <= 0 or KR > MAX_WINDOW_ROWS:
        raise ValueError(f"unsupported window_rows={KR}")
    idx = wstart[:nt, :, None, None] * C + cols
    g = jnp.take(x2d.reshape(-1), idx, mode="clip")
    return jnp.sum(vals * g, axis=1).reshape(nt * Rt, C)


@functools.partial(
    jax.jit,
    static_argnames=("block_rows", "src_block_rows", "w0_table", "w_rows"),
)
def blockperm_gather(src, idx, vals=None, *, block_rows: int,
                     src_block_rows: int, w0_table: tuple, w_rows: int = 1):
    """out[d, j] = src[(blk(d) * srb + w0_table[d % br]) * 1024 + idx[d, j]]
    (* vals[d, j]), with blk(d) = d // br, br = block_rows,
    srb = src_block_rows, and idx relative to the w_rows-row window."""
    BRK, SRB, W = int(block_rows), int(src_block_rows), int(w_rows)
    if BRK % 8 or BRK > MAX_BLOCK_ROWS:
        raise ValueError(f"unsupported block_rows={BRK}")
    if SRB % 8 or SRB > MAX_SRC_ROWS:
        raise ValueError(f"unsupported src_block_rows={SRB}")
    if W < 1 or W > MAX_W_ROWS:
        raise ValueError(f"unsupported w_rows={W}")
    if len(w0_table) != BRK or any(w0 < 0 or w0 + W > SRB for w0 in w0_table):
        raise ValueError("bad w0_table")
    RD = idx.shape[0]
    assert idx.shape[1] == 1024 and RD % BRK == 0
    assert src.size % (SRB * 1024) == 0, (src.size, SRB)
    d = jnp.arange(RD, dtype=idx.dtype)
    w0 = jnp.asarray(w0_table, idx.dtype)[d % BRK]
    base = ((d // BRK) * SRB + w0) * 1024
    out = jnp.take(src.reshape(-1), base[:, None] + idx, mode="clip")
    return out if vals is None else out * vals
