"""General-sparsity SpMV: host-planned radix routing + blocked gathers.

The reference's cuSPARSE SpMV is pattern-agnostic (CSRMatrixTasks.cu:14-156,
COOMatrixTasks.cu:12-146); matrices RCM cannot band — random sparsity,
power-law graphs — have no bounded per-tile column spans for the
windowed-ELL tier.  This tier decomposes an ARBITRARY static
gather-with-duplication ``xg[k] = x[col(k)]`` at BUILD time into three
row-structured stages, each a blocked gather
(``ops/gather.blockperm_gather``), with XLA transposes carrying all
long-range movement:

  hop 1  fan out x rows into B1 destination groups
         (I1[a, g, :] = the x-row-a values destined for group g);
  T1     transpose [A, B1, W1] -> [B1, A, W1]: each group's values are now
         contiguous;
  hop 2  route within each group into per-(destination-region) slots;
  T2     per-group transpose: each region's values contiguous;
  hop 3  gather each destination block from its (few-row) region, scaling
         by the matrix values (fused) -> products in SELL slot-major order;
  sum    per-tile slot sums (plain XLA reshape-sums) -> y.

Slot widths W1/W2 are the measured per-cell maxima of the actual matrix
(no distribution assumptions); the planner searches the group count B1 for
feasibility + modeled cost.  Everything irregular happens on the host,
once; the device program is a fixed pipeline of dense-shaped ops.

Single piece (one device); sharded systems keep the existing
fallback.  Rows are expected pre-sorted by degree (descending) for tight
SELL tiles — ``parallel/reorder.py`` arranges that basis like it arranges
RCM for the banded path.
"""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp
import numpy as np

from ..options import SolverOptions, DEFAULT_OPTIONS
from ..core.partition import BlockPartition
from ..ops.gather import (
    MAX_BLOCK_ROWS,
    MAX_SRC_ROWS,
    MAX_W_ROWS,
    blockperm_gather,
)

_B1_CANDIDATES = (8, 16, 32, 64, 128, 256, 512, 1024)


def _hop3_block_rows(G2: int, SRB3: int):
    """Smallest dest block size whose source block is 8-divisible and within
    the stage caps, or None."""
    for b in (8, 16, 32, 64, 128, 256):
        if b % G2:
            continue
        srb = (b // G2) * SRB3
        if srb % 8 == 0 and srb <= MAX_SRC_ROWS:
            return b
    return None


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def plan_static_gather(
    src_of_dest: np.ndarray,   # int64 [MD] (MD % 1024 == 0); -1 = pad slot
    n_src_pad: int,            # padded source length (multiple of 1024)
    allow_cap: bool = True,    # False for the overflow recursion (depth 1)
) -> Optional[dict]:
    """Three-hop routing plan for ``out[k] = src[src_of_dest[k]]``.

    Returns None when no feasible geometry exists (then the caller falls
    back to the XLA gather).  Pad slots (-1) read source position 0."""
    MD = len(src_of_dest)
    assert MD % 1024 == 0 and n_src_pad % 1024 == 0
    D = MD // 1024
    real = src_of_dest >= 0
    e_dest = np.flatnonzero(real)
    src = src_of_dest[e_dest]
    A = n_src_pad // 1024
    if A % 8:
        return None  # caller pads the source to 8-row multiples
    dest_row = e_dest // 1024
    a = src // 1024

    g = np.gcd(A, 1024)
    q_t1 = 1024 // g  # W1 granularity so I1' rows are 1024-aligned

    best = None
    for B1 in _B1_CANDIDATES:
        if B1 > 8 and B1 * 8 > 2 * D:
            continue  # groups saturate below 8 dest rows: no finer fan-out
        G1 = _round_up(-(-D // B1), 8)
        g1 = np.minimum(dest_row // G1, B1 - 1)
        key1 = a * B1 + g1
        cnt1 = np.bincount(key1, minlength=A * B1)
        W1 = int(cnt1.max(initial=1))
        # 128-multiple W1: T1's transpose minor dimension is W1, and a
        # narrow minor dimension makes the transpose inefficient
        W1 = _round_up(W1, int(np.lcm(np.lcm(max(8192 // B1, 1), q_t1),
                                      128)))
        f1 = B1 * W1 // 1024
        if f1 * 8 > MAX_BLOCK_ROWS:
            continue  # hop-1 dest block (8 * f1 rows) beyond the stage cap
        RB = A * W1 // 1024
        order1 = np.argsort(key1, kind="stable")
        starts1 = np.zeros(A * B1 + 1, np.int64)
        np.cumsum(cnt1, out=starts1[1:])
        rank1 = np.empty(len(src), np.int64)
        rank1[order1] = np.arange(len(src)) - starts1[key1[order1]]
        pos1t = g1 * (A * W1) + a * W1 + rank1
        b_global = pos1t // 1024
        NB1 = B1 * RB
        variants = [(8, False), (4, False), (2, False), (1, False)]
        if allow_cap:
            variants.append((1, True))
        for G2, capped in variants:
            NRg = G1 // G2
            region = dest_row // G2
            r_local = region - g1 * NRg
            key2 = b_global * NRg + r_local
            cnt2 = np.bincount(key2, minlength=NB1 * NRg)
            W2max = int(cnt2.max(initial=1))
            if capped:
                # cap the per-cell slot count near the MEAN and route the
                # tail through a small second pipeline: the Poisson tail
                # (measured max 23 vs mean 3.45 on random 8/row) otherwise
                # pads hop 2 + its transpose ~7x.  Only worth it when the
                # tail is THIN: with few source rows the per-(source-row,
                # dest-row) counts are structurally heavy, the overflow
                # inherits the same concentration, and its recursive plan
                # blows up (measured at n = 32768: 10% overflow, sub-plan
                # W2 = 870 -> infeasible)
                nz = cnt2[cnt2 > 0]
                W2 = max(2, int(np.ceil(2.0 * nz.mean()))) if len(nz) else 2
                if W2 >= W2max:
                    continue  # no tail to shed; identical to uncapped
                n_ovf_est = int(np.maximum(cnt2 - W2, 0).sum())
                if n_ovf_est > 0.06 * len(src):
                    continue
            else:
                W2 = W2max
            if NRg * W2 > 8192:
                continue
            P = next((pp for pp in (1, 2, 4, 8)
                      if NRg * W2 <= pp * 1024), None)
            # capped regions append the overflow splice slots (bounded by
            # one lane block per 128; exact V computed at emit time —
            # reserve a conservative 256 in the feasibility/cost check)
            v_guess = 256 if capped else 0
            SRB3 = -(-(RB * W2 + v_guess) // 1024)
            # the source block ((BR3 // G2) * SRB3 rows) only needs to
            # satisfy the stage's 8-divisibility and size caps
            BR3 = _hop3_block_rows(G2, SRB3)
            if P is None or SRB3 > MAX_W_ROWS or BR3 is None:
                continue
            slots1 = A * B1 * W1
            slots2 = NB1 * P * 1024
            # elements each stage moves: hop 1, hop 2 + its transpose,
            # hop 3, and the overflow pipeline (a few passes per element)
            n_ovf = int(np.maximum(cnt2 - W2, 0).sum()) if capped else 0
            cost = (slots1 + 2 * slots2 + D * 1024
                    + 4 * n_ovf + (D * v_guess if capped else 0))
            cand = (cost, B1, G1, G2, NRg, W1, RB, P, W2, SRB3, BR3,
                    capped, g1, rank1, pos1t, b_global, r_local, key2,
                    cnt2)
            if best is None or cost < best[0]:
                best = cand
    if best is None:
        return None
    (_, B1, G1, G2, NRg, W1, RB, P, W2, SRB3, BR3, capped,
     g1, rank1, pos1t, b_global, r_local, key2, cnt2) = best

    f1 = B1 * W1 // 1024
    RD1 = A * B1 * W1 // 1024
    idx1 = np.zeros(RD1 * 1024, np.int32)
    pos1 = a * (B1 * W1) + g1 * W1 + rank1
    idx1[pos1] = (src % 1024).astype(np.int32)

    order2 = np.argsort(key2, kind="stable")
    starts2 = np.zeros(len(cnt2) + 1, np.int64)
    np.cumsum(cnt2, out=starts2[1:])
    rank2 = np.empty(len(src), np.int64)
    rank2[order2] = np.arange(len(src)) - starts2[key2[order2]]
    b_local = b_global - g1 * RB
    D_pad = _round_up(D, BR3)
    main = rank2 < W2 if capped else slice(None)
    RD2 = B1 * RB * P
    idx2 = np.zeros(RD2 * 1024, np.int32)
    pos2 = (b_global * (P * 1024) + r_local * W2 + rank2)[main]
    idx2[pos2] = (pos1t % 1024)[main].astype(np.int32)

    V = 0
    ovf_src = None
    ovf_rank = None
    if capped:
        ovf = np.flatnonzero(rank2 >= W2)
        reg_o = dest_row[ovf]  # G2 == 1: region id = dest row
        cnt_o0 = np.bincount(reg_o, minlength=D)
        V = _round_up(int(cnt_o0.max(initial=1)), 128)
        SRB3 = -(-(RB * W2 + V) // 1024)
        BR3 = _hop3_block_rows(G2, SRB3)
        if V > 2048 or BR3 is None or SRB3 > MAX_W_ROWS:
            # the capped winner is infeasible at its EXACT overflow width
            # (the search used a conservative guess); fall back to the
            # best uncapped candidate instead of rejecting the matrix
            return plan_static_gather(src_of_dest, n_src_pad,
                                      allow_cap=False)
        D_pad = _round_up(D, BR3)
        cnt_o = np.zeros(D_pad, np.int64)
        cnt_o[: len(cnt_o0)] = cnt_o0
        ord_o = np.argsort(reg_o, kind="stable")
        st_o = np.zeros(D_pad + 1, np.int64)
        np.cumsum(cnt_o, out=st_o[1:])
        ovf_rank = np.empty(len(ovf), np.int64)
        ovf_rank[ord_o] = np.arange(len(ovf)) - st_o[reg_o[ord_o]]
        ovf_src = np.full(D_pad * V, -1, np.int64)
        ovf_src[reg_o * V + ovf_rank] = src[ovf]

    idx3 = np.zeros(D_pad * 1024, np.int32)
    # rank2-major within the region row: matches apply_static_gather's
    # lane-major T2 layout (plain 2-D transpose; see the T2 comment there)
    idx3[e_dest] = (rank2 * RB + b_local).astype(np.int32)
    if capped:
        idx3[e_dest[ovf]] = (RB * W2 + ovf_rank).astype(np.int32)

    return {
        "A": A, "B1": B1, "G1": G1, "G2": G2, "NRg": NRg, "W1": W1,
        "RB": RB, "P": P, "W2": W2, "SRB3": SRB3, "BR3": BR3, "f1": f1,
        "D": D, "D_pad": D_pad, "V": V,
        "idx1": idx1.reshape(RD1, 1024),
        "idx2": idx2.reshape(RD2, 1024),
        "idx3": idx3.reshape(D_pad, 1024),
        "ovf_src": ovf_src,
    }


def apply_static_gather(x_pad, plan, idx1, idx2, idx3, vals3, ovf=None):
    """Run the planned pipeline: [A*1024] source -> [D_pad, 1024] products
    (gathered values scaled by ``vals3``; pure gather when vals3 is None).
    Index/value arrays are passed explicitly so callers thread them as jit
    ARGUMENTS.  ``ovf`` = (plan_o, idx1_o, idx2_o, idx3_o) for the capped
    tail: a recursive (uncapped) pipeline gathers the overflow elements and
    its output is spliced into each region's tail slots by CONCATENATION
    (never a scatter)."""
    A, B1, W1 = plan["A"], plan["B1"], plan["W1"]
    RB, NRg, P, W2 = plan["RB"], plan["NRg"], plan["P"], plan["W2"]
    SRB3, f1, G2, BR3 = plan["SRB3"], plan["f1"], plan["G2"], plan["BR3"]
    V = plan.get("V", 0)
    i1 = blockperm_gather(
        x_pad, idx1, block_rows=8 * f1, src_block_rows=8,
        w0_table=tuple(dl // f1 for dl in range(8 * f1)),
    )
    i1t = i1.reshape(A, B1, W1).transpose(1, 0, 2).reshape(-1)
    i2 = blockperm_gather(
        i1t, idx2, block_rows=8 * P, src_block_rows=8,
        w0_table=tuple(dl // P for dl in range(8 * P)),
    )
    i2g = i2.reshape(B1, RB, P * 1024)[:, :, : NRg * W2]
    # T2 as a PLAIN 2-D transpose per group, (RB, NRg*W2) -> (NRg*W2, RB):
    # both minor dims are large (RB >= 8, typically 128+).  The naive
    # (0, 2, 1, 3) region-major move keeps W2 (tiny — the capped winner's
    # W2 is ~6) as the minor dim; the within-row slot ORDER of i2t is plan-defined
    # (idx3 encodes rank2 * RB + b_local to match this layout), so the
    # lane-major choice is free.
    i2t = i2g.reshape(B1, RB, NRg * W2).transpose(0, 2, 1)
    i2t = i2t.reshape(B1, NRg, W2 * RB).reshape(B1 * NRg, W2 * RB)
    n_regions = plan["D_pad"] // G2
    if i2t.shape[0] < n_regions:
        i2t = jnp.pad(i2t, ((0, n_regions - i2t.shape[0]), (0, 0)))
    elif i2t.shape[0] > n_regions:
        i2t = i2t[:n_regions]
    if V:
        plan_o, i1o, i2o, i3o = ovf
        flat_o = apply_static_gather(
            x_pad, plan_o, i1o, i2o, i3o, None
        ).reshape(-1)[: n_regions * V]
        i2t = jnp.concatenate(
            [i2t, flat_o.reshape(n_regions, V)], axis=1
        )
    pad = SRB3 * 1024 - i2t.shape[1]
    if pad:
        i2t = jnp.pad(i2t, ((0, 0), (0, pad)))
    srb3_blk = (BR3 // G2) * SRB3
    return blockperm_gather(
        i2t.reshape(-1), idx3, vals3, block_rows=BR3,
        src_block_rows=srb3_blk,
        w0_table=tuple((dl // G2) * SRB3 for dl in range(BR3)),
        w_rows=SRB3,
    )


class GeneralSpmvOperator:
    """y = A @ x for arbitrary sparsity on the routed-gather pipeline
    (single piece).  Rows should arrive pre-sorted by descending degree
    (the planner's degree basis) for tight SELL tiles; any order is
    correct.  Cites: reference cuSPARSE SpMV generality
    (CSRMatrixTasks.cu:14-156)."""

    def __init__(
        self,
        matrix,
        partition: BlockPartition,
        options: SolverOptions = DEFAULT_OPTIONS,
    ):
        if partition.num_pieces != 1:
            raise ValueError("GeneralSpmvOperator is single-piece only")
        self.matrix = matrix
        self.partition = partition
        self.options = options
        dtype = np.dtype(options.entry_dtype)
        n = matrix.n_range
        P_vec = partition.padded_size

        rows = np.asarray(matrix.rows, np.int64)
        cols = np.asarray(matrix.cols, np.int64)
        vals = np.asarray(matrix.vals, np.float64)
        # combine duplicate (row, col) entries (COO semantics, like the
        # reference's reduction-accessor SpMV, COOMatrixTasks.cpp:38-39)
        order = np.lexsort((cols, rows))
        r, c, v = rows[order], cols[order], vals[order]
        if len(r):
            new = np.empty(len(r), bool)
            new[0] = True
            new[1:] = (r[1:] != r[:-1]) | (c[1:] != c[:-1])
            if not new.all():
                st = np.flatnonzero(new)
                v = np.add.reduceat(v, st)
                r, c = r[new], c[new]
        # DIAGONAL SPLIT: a tile's diagonal entries all source from the
        # tile's own 1024-column range — one source row — an irreducible
        # (source-row, dest-row) cluster that blows the routing maxima on
        # any matrix with a full diagonal (symmetric + shift being the
        # common case).  The diagonal is elementwise anyway: y += d * x
        # outside the pipeline.
        on_diag = r == c
        diag = np.zeros(P_vec, np.float64)
        if on_diag.any():
            diag[r[on_diag]] = v[on_diag]
            r, c, v = r[~on_diag], c[~on_diag], v[~on_diag]
        self.diag = jnp.asarray(diag.astype(dtype))
        # row counts of the DEDUPLICATED entries: slot assignment below
        # must index the deduped arrays
        counts = np.bincount(r, minlength=P_vec)
        # SELL tiles of 1024 rows: per-tile slot count = that tile's max.
        # A mega-degree row (>> tile mean) blows the slot count of its
        # whole tile; such matrices go back to the fallback rather than
        # pay a 10-100x padded pipeline (row splitting is future work)
        nt = _round_up(P_vec, 1024) // 1024
        cpad = np.zeros(nt * 1024, np.int64)
        cpad[: len(counts)] = counts
        Lt = cpad.reshape(nt, 1024).max(axis=1)
        Lt = np.maximum(Lt, 1)
        row_off = np.concatenate([[0], np.cumsum(Lt)])  # dest rows per tile
        D = _round_up(int(row_off[-1]), 8)  # hop-3 grid: 8-row dest blocks
        MD = D * 1024
        if MD > 6 * max(len(r), P_vec):
            raise ValueError("SELL padding pathological (mega-degree row)")

        row_start = np.concatenate([[0], np.cumsum(counts)])
        # slot assignment DE-BIASED by a per-row cyclic shift: column-rank
        # slots would give slot-plane 0 every row's SMALLEST column, which
        # clusters source rows and blows the routing maxima ~5x (measured:
        # W2 116 -> 27 on random 8/row at n=1M)
        colrank = np.arange(len(r)) - row_start[r]
        slot = (colrank + r) % counts[r].clip(min=1)
        dest = (row_off[r // 1024] + slot) * 1024 + (r % 1024)

        src_of_dest = np.full(MD, -1, np.int64)
        src_of_dest[dest] = c
        A_src = _round_up(max(P_vec, 1024) // 1024, 8)
        self._n_src_pad = A_src * 1024
        plan = plan_static_gather(src_of_dest, self._n_src_pad)
        if plan is None:
            raise ValueError("no feasible routing geometry for this matrix")
        # hop-3 dest rows are padded to the chosen block size
        vals3 = np.zeros(plan["D_pad"] * 1024, dtype)
        vals3[dest] = v.astype(dtype)
        self._plan = {
            k: plan[k] for k in plan
            if not k.startswith("idx") and k != "ovf_src"
        }
        self.idx1 = jnp.asarray(plan["idx1"])
        self.idx2 = jnp.asarray(plan["idx2"])
        self.idx3 = jnp.asarray(plan["idx3"])
        self.vals3 = jnp.asarray(vals3.reshape(plan["D_pad"], 1024))
        self._ovf_plan = None
        self.ovf_idx = None
        if plan.get("V", 0):
            plan_o = plan_static_gather(
                plan["ovf_src"], self._n_src_pad, allow_cap=False
            )
            if plan_o is None:
                raise ValueError("overflow sub-plan failed")
            self._ovf_plan = {
                k: plan_o[k] for k in plan_o
                if not k.startswith("idx") and k != "ovf_src"
            }
            self.ovf_idx = (
                jnp.asarray(plan_o["idx1"]),
                jnp.asarray(plan_o["idx2"]),
                jnp.asarray(plan_o["idx3"]),
            )
        # phase-2 segments: consecutive tiles sharing one slot count
        segs = []
        t0 = 0
        for t in range(1, nt + 1):
            if t == nt or Lt[t] != Lt[t0]:
                segs.append((int(row_off[t0]), t - t0, int(Lt[t0])))
                t0 = t
        self._segments = tuple(segs)
        self._transpose_op = None

    # ------------------------------------------------------------------
    @property
    def n_domain(self) -> int:
        return self.matrix.n_domain

    @property
    def n_range(self) -> int:
        return self.matrix.n_range

    def nnz(self) -> int:
        return self.matrix.n_kernel

    @property
    def supports_matvec_dot(self) -> bool:
        return False

    def device_state(self):
        return (self.idx1, self.idx2, self.idx3, self.vals3, self.ovf_idx,
                self.diag)

    def set_device_state(self, state) -> None:
        (self.idx1, self.idx2, self.idx3, self.vals3, self.ovf_idx,
         self.diag) = state

    # ------------------------------------------------------------------
    def matvec(self, x: jnp.ndarray) -> jnp.ndarray:
        P_vec = self.partition.padded_size
        xp = x.reshape(-1)
        if self._n_src_pad != P_vec:
            xp = jnp.pad(xp, (0, self._n_src_pad - P_vec))
        ovf = (
            (self._ovf_plan, *self.ovf_idx)
            if self._ovf_plan is not None else None
        )
        prod = apply_static_gather(
            xp, self._plan, self.idx1, self.idx2, self.idx3, self.vals3,
            ovf=ovf,
        )
        parts = []
        for (row0, ntile, L) in self._segments:
            blk = prod[row0 : row0 + ntile * L]
            parts.append(blk.reshape(ntile, L, 1024).sum(axis=1).reshape(-1))
        y = jnp.concatenate(parts) if len(parts) > 1 else parts[0]
        return y[:P_vec] + self.diag * x.reshape(-1)

    def matvec_add(self, y: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
        return y + self.matvec(x)

    def transpose(self) -> "GeneralSpmvOperator":
        """A^T on a fresh plan of the swapped pattern (the reference stubs
        rmatvec, COOMatrixTasks.cpp:78-83)."""
        if self._transpose_op is None:

            class _Swapped:
                def __init__(s, m):
                    s.rows, s.cols, s.vals = m.cols, m.rows, m.vals
                    s.n_domain, s.n_range = m.n_range, m.n_domain
                    s.n_kernel = m.n_kernel

            self._transpose_op = GeneralSpmvOperator(
                _Swapped(self.matrix), self.partition, self.options
            )
        return self._transpose_op

    def rmatvec(self, x: jnp.ndarray) -> jnp.ndarray:
        return self.transpose().matvec(x)


def degree_sort_perm(matrix) -> np.ndarray:
    """perm[i] = original row index at sorted position i, rows by
    DESCENDING degree (stable): packs SELL tiles tightly."""
    n = matrix.n_range
    counts = np.bincount(np.asarray(matrix.rows, np.int64), minlength=n)
    return np.argsort(-counts, kind="stable")
