"""Row-partitioned distributed sparse operators with explicit halo exchange.

This is the JAX realization of the reference's partitioned ``matvec``
launch (reference: COOMatrix.cpp:144-191, SquarePlanner.hpp:209-235): the
reference gives each piece (a) its block of output rows, (b) the kernel
sub-region of nonzeros whose row lands in that block (preimage of the row
field), and (c) a *ghost partition* of the source vector (image of the col
field) that Legion materializes by copying remote entries.  Legion moves the
ghost data implicitly; here the movement is an explicit, compile-time
``ppermute`` schedule computed once on the host
(:func:`legionsolvers_tpu.core.partition.build_halo_exchange`).

Per-shard data layout (all shapes static, identical across shards — SPMD):

* local nonzeros in **ELL** layout ``[B, L]`` (B = rows per shard, L = max
  nonzeros/row), with column indices remapped into the shard's *extended
  x buffer* ``[0, B + halo_total + 1)``: own block first, then halo slots
  (sorted by global id), then one dump slot for padding;
* for each ring offset ``d``: gather indices of what to send to shard
  ``(s+d) % S`` and scatter positions for what arrives from ``(s-d) % S``.

``matvec`` runs under ``jax.shard_map``: gather-send -> ``ppermute`` ->
scatter into the extended buffer -> local SpMV.  The local SpMV is the
windowed-ELL gather (ops/gather.py) whenever per-shard window planning over
a banded-ordered extended layout succeeds (``_plan_sharded_winell``), and
the dense ELL gather + row reduction otherwise.  XLA overlaps the independent ppermutes with each other and
with the local portion of the compute (the analog of Legion overlapping
ghost copies with leaf tasks).
"""

from __future__ import annotations

import functools
import os
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..options import SHARD_AXIS, SolverOptions, DEFAULT_OPTIONS
from ..core.matrix import AbstractMatrix
from ..core.partition import (
    BlockPartition,
    HaloExchange,
    build_halo_exchange,
    kernel_partition_from_range,
)


class RowPartitionedMatrix:
    """A sparse operator partitioned by row blocks over the solver mesh.

    Built host-side from any :class:`AbstractMatrix` plus the canonical
    domain/range block partitions (the planner's
    ``add_row_partitioned_matrix``, SquarePlanner.hpp:209-235).  The domain
    and range partitions may differ in extent but must share piece count.
    """

    def __init__(
        self,
        matrix: AbstractMatrix,
        domain_partition: BlockPartition,
        range_partition: BlockPartition,
        mesh: Optional[Mesh],
        options: SolverOptions = DEFAULT_OPTIONS,
    ):
        if domain_partition.num_pieces != range_partition.num_pieces:
            raise ValueError("domain/range piece counts must match")
        if mesh is not None and mesh.shape[SHARD_AXIS] != range_partition.num_pieces:
            raise ValueError(
                f"mesh has {mesh.shape[SHARD_AXIS]} shards but partition has "
                f"{range_partition.num_pieces} pieces"
            )
        self.matrix = matrix
        self.domain_partition = domain_partition
        self.range_partition = range_partition
        self.mesh = mesh
        self.options = options

        S = range_partition.num_pieces
        B_r = range_partition.block_size
        B_d = domain_partition.block_size

        # --- dependent partitioning, host side --------------------------
        kernel_pieces = kernel_partition_from_range(matrix.rows, range_partition)
        self.kernel_pieces = kernel_pieces
        self.halo: HaloExchange = build_halo_exchange(
            matrix.cols, kernel_pieces, domain_partition
        )
        ext = self.halo.ext_size
        dump = ext - 1

        # --- per-shard ELL with remapped columns ------------------------
        counts_per_row = np.zeros((S, B_r), dtype=np.int64)
        for s in range(S):
            local_rows = matrix.rows[kernel_pieces[s]] - s * B_r
            np.add.at(counts_per_row[s], local_rows, 1)
        L = max(int(counts_per_row.max(initial=0)), 1)
        self.row_length = L

        idt = np.int32
        ell_cols = np.full((S, B_r, L), dump, dtype=idt)
        ell_vals = np.zeros((S, B_r, L), dtype=np.asarray(matrix.vals).dtype)
        from ..native import pack_ell_shard as _native_pack

        for s in range(S):
            knz = kernel_pieces[s]
            lrows = (matrix.rows[knz] - s * B_r).astype(np.int64)
            gcols = matrix.cols[knz]
            order = np.argsort(lrows, kind="stable")
            lr_s, gc_s = lrows[order], gcols[order]
            vals_s = np.asarray(matrix.vals)[knz][order]
            hg = self.halo.halo_global[s]
            packed = _native_pack(
                lr_s, gc_s, vals_s, B_r, B_d, s * B_d, hg, L, dump
            )
            if packed is not None:
                ell_cols[s], ev = packed
                ell_vals[s] = ev.astype(ell_vals.dtype)
                continue
            # numpy fallback: remap columns + slot within each row
            owners = domain_partition.owner_of(gc_s)
            local = owners == s
            lc_s = np.empty(len(gc_s), dtype=np.int64)
            lc_s[local] = gc_s[local] - s * B_d
            lc_s[~local] = B_d + np.searchsorted(hg, gc_s[~local])
            starts = np.zeros(B_r + 1, dtype=np.int64)
            np.add.at(starts, lr_s + 1, 1)
            starts = np.cumsum(starts)
            slot = np.arange(len(lr_s)) - starts[:-1].repeat(np.diff(starts))
            ell_cols[s, lr_s, slot] = lc_s
            ell_vals[s, lr_s, slot] = vals_s

        o = options
        if mesh is None:
            # Unsharded path: one global ELL slab with *global padded* column
            # indices (padded slots carry val 0, col 0 — harmless).  Used for
            # single-device runs and as the semantics reference for the
            # sharded path.
            g_cols = np.zeros((S * B_r, L), dtype=np.int64)
            g_vals = np.zeros((S * B_r, L), dtype=np.asarray(matrix.vals).dtype)
            for s in range(S):
                lc = ell_cols[s].astype(np.int64)
                hg = self.halo.halo_global[s]
                gc = np.zeros_like(lc)
                local = lc < B_d
                halo_slot = (lc >= B_d) & (lc < B_d + len(hg))
                gc[local] = lc[local] + s * B_d
                if len(hg):
                    gc[halo_slot] = hg[lc[halo_slot] - B_d]
                g_cols[s * B_r : (s + 1) * B_r] = gc
                g_vals[s * B_r : (s + 1) * B_r] = ell_vals[s]
            self.g_ell_cols = jnp.asarray(g_cols.astype(np.int32))
            self.g_ell_vals = jnp.asarray(g_vals.astype(options.entry_dtype))
        shard3 = (
            NamedSharding(mesh, P(SHARD_AXIS, None, None)) if mesh else None
        )
        shard2 = NamedSharding(mesh, P(SHARD_AXIS, None)) if mesh else None
        put = lambda a, sh: (
            jax.device_put(jnp.asarray(a), sh) if sh is not None else jnp.asarray(a)
        )
        self.ell_cols = put(ell_cols.astype(idt), shard3)
        self.ell_vals = put(ell_vals.astype(o.entry_dtype), shard3)
        self.send_idx = {
            d: put(self.halo.send_idx[d].astype(idt), shard2)
            for d in self.halo.offsets
        }
        self.recv_pos = {
            d: put(self.halo.recv_pos[d].astype(idt), shard2)
            for d in self.halo.offsets
        }

        self._S = S
        self._B_d = B_d
        self._B_r = B_r
        self._matvec_sharded = None
        self._rmatvec_sharded = None

        # ---- sharded windowed-ELL path ------------------------------------
        # Per-shard windowed-ELL plans over the EXTENDED buffer (local
        # block + halo slots) for banded-ish matrices on several devices
        # (the single-device form is parallel/winell_op.py).  All shards share one static geometry
        # (Rt/L/KR maxima) — SPMD.  Fallback: the XLA-gather ELL above.
        self._win = None
        if mesh is not None and not bool(
            int(os.environ.get("LEGIONSOLVERS_NO_WINELL", "0"))
        ):
            self._win = self._plan_sharded_winell(ell_cols, ell_vals, dump)

    # ------------------------------------------------------------------
    def _plan_sharded_winell(self, ell_cols, ell_vals, dump):
        """Per-shard windowed-ELL plans over a BANDED-ORDERED extended
        layout, or None when any shard is ineligible.

        The gather-ELL ext buffer appends halo slots AFTER the local block,
        which scatters an edge row's columns across the whole buffer and
        blows the window spans.  The windowed path therefore uses its own
        layout — ``[lo-halo (right-aligned to n_lo_max) | local block |
        hi-halo | dump]`` — where a banded matrix's columns stay contiguous
        per row.  Per-shard halo counts differ; the SHAPES stay SPMD-static
        (maxima) and only the scatter positions (``recv_pos2``) and column
        ids are per-shard data.  Two planning passes force one static
        kernel geometry (L/KR maxima) across shards."""
        from .winell_op import plan_winell

        S, B_r, B_d = self._S, self._B_r, self._B_d
        o = self.options
        dtype = np.dtype(o.entry_dtype)
        hg = self.halo.halo_global
        n_lo = np.array([int((hg[s] < s * B_d).sum()) for s in range(S)])
        n_hi = np.array([len(hg[s]) - n_lo[s] for s in range(S)])
        n_lo_u = int(n_lo.max(initial=0))
        n_hi_u = int(n_hi.max(initial=0))
        ext2 = n_lo_u + B_d + n_hi_u + 1  # + dump slot
        pad_n = max(B_r, ext2)

        def remap(s, e):
            """old ext id -> banded-ordered ext2 id (vectorized)."""
            e = np.asarray(e, np.int64)
            out = np.empty_like(e)
            local = e < B_d
            out[local] = n_lo_u + e[local]
            lo = (~local) & (e < B_d + n_lo[s])
            out[lo] = n_lo_u - n_lo[s] + (e[lo] - B_d)
            hi = (~local) & (e >= B_d + n_lo[s]) & (e < B_d + len(hg[s]))
            out[hi] = n_lo_u + B_d + (e[hi] - B_d - n_lo[s])
            out[e >= B_d + len(hg[s])] = ext2 - 1  # dump
            return out

        coos, recv2 = [], {}
        for s in range(S):
            rows_idx, slot_idx = np.nonzero(ell_cols[s] != dump)
            coos.append((
                rows_idx.astype(np.int64),
                remap(s, ell_cols[s][rows_idx, slot_idx]),
                ell_vals[s][rows_idx, slot_idx],
            ))
        for d in self.halo.offsets:
            recv2[d] = np.stack([
                remap(s, self.halo.recv_pos[d][s]) for s in range(S)
            ]).astype(np.int32)

        def plan_all(kr_min=0, l_min=0):
            plans = []
            for lr, lc, lv in coos:
                p = plan_winell(lr, lc, lv, pad_n, pad_n, dtype,
                                tile_rows_of_128=8,
                                window_rows_min=kr_min,
                                row_length_min=l_min)
                if p is None:
                    return None
                plans.append(p)
            return plans

        plans = plan_all()
        if plans is None:
            return None
        Lmax = max(p["row_length"] for p in plans)
        KRmax = max(p["window_rows"] for p in plans)
        if any(p["row_length"] != Lmax or p["window_rows"] != KRmax
               for p in plans):
            plans = plan_all(kr_min=KRmax, l_min=Lmax)
            if plans is None:
                return None
        sh4 = NamedSharding(self.mesh, P(SHARD_AXIS, None, None, None, None))
        sh3 = NamedSharding(self.mesh, P(SHARD_AXIS, None, None))
        sh2 = NamedSharding(self.mesh, P(SHARD_AXIS, None))
        return {
            "N": plans[0]["N"],
            "KR": KRmax,
            "ext2": ext2,
            "n_lo_u": n_lo_u,
            "wstart": jax.device_put(
                jnp.asarray(np.stack([p["wstart"] for p in plans])), sh3),
            "cols": jax.device_put(
                jnp.asarray(np.stack([p["cols"] for p in plans])), sh4),
            "vals": jax.device_put(
                jnp.asarray(np.stack([p["vals"] for p in plans])), sh4),
            "recv_pos2": {
                d: jax.device_put(jnp.asarray(recv2[d]), sh2)
                for d in self.halo.offsets
            },
        }

    @property
    def num_pieces(self) -> int:
        return self._S

    def nnz(self) -> int:
        return self.matrix.n_kernel

    # Operator device state: threaded through solver jits as ARGUMENTS (via
    # SquarePlanner.dump_state/load_state) so the ELL slabs and halo
    # schedules are never baked into compiled programs as giant constants.
    def device_state(self):
        s = {
            "ell_cols": self.ell_cols,
            "ell_vals": self.ell_vals,
            "send_idx": self.send_idx,
            "recv_pos": self.recv_pos,
        }
        if self.mesh is None:
            s["g_ell_cols"] = self.g_ell_cols
            s["g_ell_vals"] = self.g_ell_vals
        if self._win is not None:
            s["win_wstart"] = self._win["wstart"]
            s["win_cols"] = self._win["cols"]
            s["win_vals"] = self._win["vals"]
            s["win_recv_pos2"] = self._win["recv_pos2"]
        return s

    def set_device_state(self, state) -> None:
        for k, v in state.items():
            if k.startswith("win_"):
                self._win[k[len("win_"):]] = v
            else:
                setattr(self, k, v)

    # ------------------------------------------------------------------
    def _local_matvec(self, x_blk, ell_cols, ell_vals, *sched):
        """Per-shard body (runs inside shard_map).  ``x_blk`` is [1, B_d]."""
        ext = self._build_ext(x_blk.reshape(-1), sched)
        # Local SpMV: dense gather + row-sum over the ELL slab.
        gathered = ext[ell_cols[0]]  # [B_r, L]
        y = jnp.sum(ell_vals[0] * gathered, axis=1)
        return y  # [B_r]; out_spec P(SHARD_AXIS) reassembles [S * B_r]

    def _build_ext(self, x_loc, sched):
        """Extended x buffer for this shard: local block + exchanged halo
        slots (one ppermute per ring offset; all independent -> overlapped
        by XLA)."""
        S = self._S
        B_d = self._B_d
        ext = jnp.zeros(self.halo.ext_size, dtype=x_loc.dtype)
        ext = ext.at[:B_d].set(x_loc)
        n_off = len(self.halo.offsets)
        for k, d in enumerate(self.halo.offsets):
            sidx = sched[k].reshape(-1)
            rpos = sched[n_off + k].reshape(-1)
            send = x_loc[sidx]
            perm = [(i, (i + d) % S) for i in range(S)]
            recv = jax.lax.ppermute(send, SHARD_AXIS, perm)
            ext = ext.at[rpos].set(recv)
        return ext

    def _local_matvec_win(self, x_blk, wstart, cols, vals, *sched):
        """Per-shard windowed-ELL SpMV over the banded-ordered extended
        buffer (ops/gather.py).  ``sched`` = send_idx per offset, then
        recv_pos2 per offset."""
        from ..ops.gather import winell_spmv

        w = self._win
        S = self._S
        x_loc = x_blk.reshape(-1)
        Np = max(w["N"], w["ext2"])
        ext = jnp.zeros(Np, dtype=x_loc.dtype)
        ext = ext.at[w["n_lo_u"] : w["n_lo_u"] + self._B_d].set(x_loc)
        n_off = len(self.halo.offsets)
        for k, d in enumerate(self.halo.offsets):
            sidx = sched[k].reshape(-1)
            rpos = sched[n_off + k].reshape(-1)
            send = x_loc[sidx]
            perm = [(i, (i + d) % S) for i in range(S)]
            recv = jax.lax.ppermute(send, SHARD_AXIS, perm)
            ext = ext.at[rpos].set(recv)
        y = winell_spmv(
            ext.reshape(-1, 128), wstart[0], cols[0], vals[0],
            window_rows=w["KR"],
        ).reshape(-1)
        return y[: self._B_r]

    def _build_matvec(self):
        mesh = self.mesh
        n_off = len(self.halo.offsets)
        specs2 = (P(SHARD_AXIS, None),) * (2 * n_off)
        if self._win is not None:
            f = jax.shard_map(
                self._local_matvec_win,
                mesh=mesh,
                in_specs=(
                    P(SHARD_AXIS),
                    P(SHARD_AXIS, None, None),
                    P(SHARD_AXIS, None, None, None, None),
                    P(SHARD_AXIS, None, None, None, None),
                )
                + specs2,
                out_specs=P(SHARD_AXIS),
                check_vma=False,
            )

            def matvec(x):
                sched = tuple(
                    self.send_idx[d] for d in self.halo.offsets
                ) + tuple(
                    self._win["recv_pos2"][d] for d in self.halo.offsets
                )
                y = f(x, self._win["wstart"], self._win["cols"],
                      self._win["vals"], *sched)
                return y.reshape(-1)

            return matvec
        f = jax.shard_map(
            self._local_matvec,
            mesh=mesh,
            in_specs=(
                P(SHARD_AXIS),
                P(SHARD_AXIS, None, None),
                P(SHARD_AXIS, None, None),
            )
            + specs2,
            out_specs=P(SHARD_AXIS),
        )

        def matvec(x):
            sched = tuple(self.send_idx[d] for d in self.halo.offsets) + tuple(
                self.recv_pos[d] for d in self.halo.offsets
            )
            y = f(x, self.ell_cols, self.ell_vals, *sched)
            return y.reshape(-1)

        return matvec

    def matvec(self, x: jnp.ndarray) -> jnp.ndarray:
        """y = A @ x over padded sharded arrays: x has length
        ``domain_partition.padded_size``, result ``range_partition.padded_size``.

        Padding correctness: padded ELL slots point at the dump slot with
        value 0; padded x slots are 0 by the vector invariant; padded output
        rows have all-zero ELL rows, so y's padding stays 0.
        """
        if self.mesh is None:
            # plain ELL over the global padded arrays (XLA gather)
            from ..ops.spmv import spmv_ell

            return spmv_ell(self.g_ell_cols, self.g_ell_vals, x)
        if self._matvec_sharded is None:
            self._matvec_sharded = self._build_matvec()
        return self._matvec_sharded(x)

    def matvec_add(self, y: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
        """y += A @ x (reduction-accumulate form: the analog of the
        reference's sum-reduction output privileges, COOMatrixTasks.cpp:38-39)."""
        return y + self.matvec(x)

    # ------------------------------------------------------------------
    # Transpose matvec.  The reference leaves this unimplemented
    # (COORmatvecTask / CSRRmatvecTask are assert(false) stubs,
    # COOMatrixTasks.cpp:78-83, CSRMatrixTasks.cpp:95-100); here it is the
    # exact adjoint of the forward halo schedule: scatter local
    # contributions into the extended-x coordinate system, then ppermute
    # each halo slot's partial sums BACK to the owning shard (reverse ring
    # offsets) and accumulate.
    # ------------------------------------------------------------------
    def _local_rmatvec(self, x_blk, ell_cols, ell_vals, *sched):
        S = self._S
        B_d = self._B_d
        x_loc = x_blk.reshape(-1)  # [B_r]
        contrib = (ell_vals[0] * x_loc[:, None]).ravel()
        c_ext = jnp.zeros(self.halo.ext_size, dtype=x_loc.dtype)
        c_ext = c_ext.at[ell_cols[0].ravel()].add(contrib)
        y = c_ext[:B_d]
        n_off = len(self.halo.offsets)
        for k, d in enumerate(self.halo.offsets):
            sidx = sched[k].reshape(-1)
            rpos = sched[n_off + k].reshape(-1)
            # this shard's partial sums for rows owned by (s - d) % S
            outgoing = c_ext[rpos]
            perm = [(i, (i - d) % S) for i in range(S)]
            incoming = jax.lax.ppermute(outgoing, SHARD_AXIS, perm)
            y = y.at[sidx].add(incoming)
        return y  # [B_d]

    def rmatvec(self, x: jnp.ndarray) -> jnp.ndarray:
        """y = A^T @ x over padded sharded arrays (x over the range space,
        result over the domain space)."""
        if self.mesh is None:
            from ..ops.spmv import rmatvec_coo

            rows = jnp.asarray(self.matrix.rows, dtype=jnp.int32)
            cols = jnp.asarray(self.matrix.cols, dtype=jnp.int32)
            vals = jnp.asarray(
                np.asarray(self.matrix.vals), dtype=self.options.entry_dtype
            )
            y = rmatvec_coo(
                rows, cols, vals, x[: self.matrix.n_range], self.matrix.n_domain
            )
            out = jnp.zeros(
                self.domain_partition.padded_size, dtype=y.dtype
            )
            return out.at[: self.matrix.n_domain].set(y)
        if self._rmatvec_sharded is None:
            n_off = len(self.halo.offsets)
            specs2 = (P(SHARD_AXIS, None),) * (2 * n_off)
            f = jax.shard_map(
                self._local_rmatvec,
                mesh=self.mesh,
                in_specs=(
                    P(SHARD_AXIS),
                    P(SHARD_AXIS, None, None),
                    P(SHARD_AXIS, None, None),
                )
                + specs2,
                out_specs=P(SHARD_AXIS),
            )

            def rmatvec(x):
                sched = tuple(
                    self.send_idx[d] for d in self.halo.offsets
                ) + tuple(self.recv_pos[d] for d in self.halo.offsets)
                return f(x, self.ell_cols, self.ell_vals, *sched).reshape(-1)

            self._rmatvec_sharded = rmatvec
        return self._rmatvec_sharded(x)
