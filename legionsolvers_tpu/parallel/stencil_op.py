"""Matrix-free stencil operator.

The reference's benchmark drives linearized-CSR stencil matrices through
cuSPARSE (reference: BenchmarkStencil.cpp:24-137, CSRMatrixTasks.cu:14-156).
A stencil matrix is exactly banded, so it needs **no storage at all**:
``matvec`` is a sum of statically shifted, boundary-masked multiply-adds over
the source vector, O(n) memory traffic against O(nnz) index and value
traffic for CSR/ELL.

Two layouts, selected automatically:

* **grid view** (2-D and 3-D grids whose shard blocks are whole rows or
  planes; 1-D blocks folded into ``[rows, C]`` by the flat-offset
  decomposition): the local block is a ``[rows, C]`` or ``[X, Y, Z]``
  grid, and the passes of ``ops/grid2d.py`` / ``ops/grid3d.py`` apply the
  stencil with halo rows or planes from the neighbour shards.  Solvers get
  fused whole-iteration runners over it; 2-D CG takes the s-step schedule,
  whose pass is the Triton kernel of ``ops/pallas/sstep2d.py``.
* **linearized path** (4-D+, padded tails, small 1-D blocks): 1-D shifted
  slices with integer-computed boundary masks, fused by XLA into one pass.

Distribution: the linearized index is block-sharded; the stencil bandwidth
is bounded by the block size (checked), so halo exchange is two neighbour
``ppermute``s of fixed edge windows (the reference observes the same
structure: stencil ghosts are the block edges +- bandwidth, SURVEY §5).
Ring-wrapped windows at the global edges are zeroed (grid view) or killed by
the boundary masks (linearized view), so edge shards need no special casing.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..options import SHARD_AXIS, SolverOptions, DEFAULT_OPTIONS
from ..core.partition import BlockPartition
from ..problems.stencil import (
    Stencil,
    _strides,
    linear_offset,
    create_coo_stencil_matrix,
)


class StencilOperator:
    """y = A @ x for an N-D stencil over a row-major-linearized grid."""

    def __init__(
        self,
        shape: Sequence[int],
        offsets: Stencil,
        partition: Optional[BlockPartition] = None,
        mesh: Optional[Mesh] = None,
        options: SolverOptions = DEFAULT_OPTIONS,
        grid_view: bool = True,
    ):
        self.shape = tuple(int(d) for d in shape)
        self.offsets = [(tuple(int(c) for c in o), float(v)) for o, v in offsets]
        self.n = int(np.prod(self.shape))
        self.mesh = mesh
        self.options = options
        if partition is None:
            S = mesh.shape[SHARD_AXIS] if mesh is not None else 1
            partition = BlockPartition(self.n, S)
        self.partition = partition
        if mesh is not None and mesh.shape[SHARD_AXIS] != partition.num_pieces:
            raise ValueError("mesh size must equal partition piece count")

        self.strides = _strides(self.shape)
        self.lin_offsets = [linear_offset(self.shape, o) for o, _ in self.offsets]
        self.band_lo = max(0, -min(self.lin_offsets, default=0))  # look-back
        self.band_hi = max(0, max(self.lin_offsets, default=0))  # look-ahead
        # When the stencil bandwidth exceeds the block size, neighbor-ring
        # ppermute can no longer supply the halo; the linearized path then
        # falls back to a gather-based (all_gather) halo instead of failing
        # (the reference handles any partition/ghost shape via Legion images,
        # COOMatrix.cpp:98-118).
        B = partition.block_size
        self._wide_band = (
            partition.num_pieces > 1 and max(self.band_lo, self.band_hi) > B
        )

        self._view = self._plan_grid_view() if grid_view else None

    # -- interface parity ---------------------------------------------------
    @property
    def n_domain(self) -> int:
        return self.n

    @property
    def n_range(self) -> int:
        return self.n

    @property
    def uses_grid_view(self) -> bool:
        return self._view is not None

    @property
    def supports_matvec_dot(self) -> bool:
        """Whether :meth:`matvec_dot` (SpMV with the <x, Ax> reduction fused
        into the kernel pass) is available for this operator's topology —
        queried by ``SquarePlanner.matvec_dot`` instead of exception-based
        dispatch."""
        return self.partition.num_pieces == 1 or self.mesh is not None

    def nnz(self) -> int:
        from ..problems.stencil import calculate_stencil_size

        return calculate_stencil_size(self.shape, self.offsets)

    def to_coo(self):
        """Explicit COO form (parity/testing; O(nnz) host memory)."""
        return create_coo_stencil_matrix(
            self.shape, self.offsets, options=self.options
        )

    # ======================================================================
    # grid view planning
    # ======================================================================
    def _plan_grid_view(self):
        """The [rows, C] (2-D, and 1-D through the flat-offset
        decomposition) or [X, Y, Z] (3-D) view of the local block, or None.
        Shard blocks must hold whole rows / planes, and the halo must fit
        the passes' contract: |dy| <= 8 rows (2-D), |ox| <= 1 plane (3-D)."""
        if self.partition.padded_size != self.n:
            return None  # padded tail rows would need masking
        B = self.partition.block_size
        vals = tuple(v for _, v in self.offsets)
        from ..ops.grid2d import decompose_flat_offsets, row_bandwidth

        def view2d(C, offs, vals):
            rlo, rhi = row_bandwidth(offs)
            if B % C or rlo > 8 or rhi > 8 or B // C < max(rlo, rhi, 1):
                return None
            return {"kind": "2d", "C": C, "Br": B // C, "offs": offs,
                    "vals": vals}

        if len(self.shape) == 2:
            offs = tuple((o[0], o[1]) for o, _ in self.offsets)
            return view2d(self.shape[1], offs, vals)
        if len(self.shape) == 1:
            for C in (4096, 2048, 1024, 512, 256, 128):
                if B % C == 0 and B // C >= 8:
                    return view2d(C, *decompose_flat_offsets(
                        self.lin_offsets, vals, C))
            return None
        if len(self.shape) == 3:
            _, Y, Z = self.shape
            offs3 = tuple(o for o, _ in self.offsets)
            if B % (Y * Z) or any(abs(o[0]) > 1 for o in offs3):
                return None
            return {"kind": "3d", "Y": Y, "Z": Z, "Br": B // (Y * Z),
                    "offs3": offs3, "vals": vals}
        return None  # 4-D+: linearized path

    def _exchange_planes3d(self, g: jnp.ndarray, *, sharded: bool):
        """([Y, Z] top, [Y, Z] bot) x-halo planes for the local [Xl, Y, Z]
        block: the neighbors' edge planes via ppermute, zeros at the global
        grid boundary (|ox| <= 1, so one plane each way suffices)."""
        v = self._view
        Y, Z = v["Y"], v["Z"]
        S = self.partition.num_pieces
        need_lo = any(o[0] < 0 for o in v["offs3"])
        need_hi = any(o[0] > 0 for o in v["offs3"])
        top = jnp.zeros((Y, Z), g.dtype)
        bot = jnp.zeros((Y, Z), g.dtype)
        if sharded and S > 1:
            if need_lo:
                t = jax.lax.ppermute(
                    g[-1], SHARD_AXIS, [(i, (i + 1) % S) for i in range(S)]
                )
                top = jnp.where(
                    jax.lax.axis_index(SHARD_AXIS) == 0, jnp.zeros_like(t), t
                )
            if need_hi:
                b = jax.lax.ppermute(
                    g[0], SHARD_AXIS, [(i, (i - 1) % S) for i in range(S)]
                )
                bot = jnp.where(
                    jax.lax.axis_index(SHARD_AXIS) == S - 1,
                    jnp.zeros_like(b), b,
                )
        return top, bot

    def _grid_local_3d(
        self, x_loc: jnp.ndarray, *, sharded: bool, with_dot: bool = False
    ):
        from ..ops.grid3d import grid3d_stencil_matvec

        v = self._view
        Y, Z, Br = v["Y"], v["Z"], v["Br"]
        S = self.partition.num_pieces
        was_flat = x_loc.ndim == 1
        xg = x_loc.reshape(Br, Y, Z) if was_flat else x_loc
        top, bot = self._exchange_planes3d(xg, sharded=sharded)
        out = grid3d_stencil_matvec(
            xg, top, bot, offsets=v["offs3"], values=v["vals"],
            with_dot=with_dot,
        )
        if with_dot:
            y, partial = out
            if sharded and S > 1:
                partial = jax.lax.psum(partial, SHARD_AXIS)
            return (y.reshape(-1) if was_flat else y), partial
        return out.reshape(-1) if was_flat else out

    def _grid_local(
        self, x_loc: jnp.ndarray, *, sharded: bool, with_dot: bool = False
    ):
        from ..ops.grid2d import grid2d_stencil_matvec

        v = self._view
        if v.get("kind") == "3d":
            return self._grid_local_3d(
                x_loc, sharded=sharded, with_dot=with_dot
            )
        C, Br, offs, vals = v["C"], v["Br"], v["offs"], v["vals"]
        S = self.partition.num_pieces
        rlo = max(0, -min(dy for dy, _ in offs))
        rhi = max(0, max(dy for dy, _ in offs))
        was_flat = x_loc.ndim == 1
        xg = x_loc.reshape(Br, C) if was_flat else x_loc
        dtype = xg.dtype

        # halo contract: [8, C] blocks, halo rows last-rlo (top) /
        # first-rhi (bottom), zeros at the global grid edges
        top = jnp.zeros((8, C), dtype)
        bot = jnp.zeros((8, C), dtype)
        if sharded and S > 1:
            if rlo > 0:
                t = jax.lax.ppermute(
                    xg[Br - rlo :], SHARD_AXIS,
                    [(i, (i + 1) % S) for i in range(S)],
                )
                is_first = jax.lax.axis_index(SHARD_AXIS) == 0
                t = jnp.where(is_first, jnp.zeros_like(t), t)
                top = top.at[8 - rlo :, :].set(t)
            if rhi > 0:
                h = jax.lax.ppermute(
                    xg[:rhi], SHARD_AXIS, [(i, (i - 1) % S) for i in range(S)]
                )
                is_last = jax.lax.axis_index(SHARD_AXIS) == S - 1
                h = jnp.where(is_last, jnp.zeros_like(h), h)
                bot = bot.at[:rhi, :].set(h)

        if sharded and S > 1 and (rlo or rhi):
            # Overlap: the pass runs with ZERO halos, so it is
            # data-independent of the ppermutes above and XLA's async
            # collective scheduler can fly the exchange during the O(n)
            # pass; the omitted edge terms are patched afterwards
            # (parallel/overlap.py; the analog of Legion overlapping ghost
            # copies with leaf tasks, COOMatrix.cpp:172-188).
            from .overlap import apply_edge_fixup, dot_fixup

            zero = jnp.zeros((8, C), dtype)
            out = grid2d_stencil_matvec(
                xg, zero, zero, offsets=offs, values=vals, with_dot=with_dot,
            )
            coeff = lambda k, sl: jnp.asarray(vals[k], dtype)
            if with_dot:
                y, partial = out
                partial = partial + dot_fixup(xg, offs, top, bot, coeff)
            else:
                y = out
            y = apply_edge_fixup(y, offs, top, bot, coeff)
            if with_dot:
                partial = jax.lax.psum(partial, SHARD_AXIS)
                return (y.reshape(-1) if was_flat else y), partial
            return y.reshape(-1) if was_flat else y

        out = grid2d_stencil_matvec(
            xg, top, bot, offsets=offs, values=vals, with_dot=with_dot,
        )
        if with_dot:
            y, partial = out
            if sharded and S > 1:
                partial = jax.lax.psum(partial, SHARD_AXIS)
            return (y.reshape(-1) if was_flat else y), partial
        return out.reshape(-1) if was_flat else out

    # ======================================================================
    # linearized path: shifted 1-D slices + integer boundary masks
    # ======================================================================
    def _diag_value(self, off: Tuple[int, ...], v: float, g: jnp.ndarray, dtype):
        """Masked diagonal value at global linearized indices ``g``."""
        m = g < self.n
        for d, o in enumerate(off):
            if o == 0:
                continue
            p_d = (g // self.strides[d]) % self.shape[d]
            m = m & (p_d + o >= 0) & (p_d + o < self.shape[d])
        return jnp.where(m, jnp.asarray(v, dtype), jnp.zeros((), dtype))

    def _linear_local(self, x_loc: jnp.ndarray, *, sharded: bool) -> jnp.ndarray:
        B = self.partition.block_size
        S = self.partition.num_pieces
        lo, hi = self.band_lo, self.band_hi
        dtype = x_loc.dtype

        if sharded and S > 1 and self._wide_band:
            # Gather-based halo: bandwidth exceeds the block size, so the
            # +-1 neighbor ring can't supply the window.  all_gather the
            # source and slice this shard's [sB - lo, sB + B + hi) window
            # (mod padded size; wrapped reads are killed by the boundary
            # masks, same as the unsharded multiblock path).
            x_all = jax.lax.all_gather(x_loc, SHARD_AXIS, tiled=True)
            s = jax.lax.axis_index(SHARD_AXIS)
            N = self.partition.padded_size
            w = (
                jnp.arange(B + lo + hi, dtype=jnp.int64 if N > 2**31 else jnp.int32)
                + (s * B - lo)
            ) % N
            x_ext = x_all[w]
        else:
            parts = []
            if lo > 0:
                tail = x_loc[B - lo :]
                if sharded and S > 1:
                    tail = jax.lax.ppermute(
                        tail, SHARD_AXIS, [(i, (i + 1) % S) for i in range(S)]
                    )
                parts.append(tail)
            parts.append(x_loc)
            if hi > 0:
                head = x_loc[:hi]
                if sharded and S > 1:
                    head = jax.lax.ppermute(
                        head, SHARD_AXIS, [(i, (i - 1) % S) for i in range(S)]
                    )
                parts.append(head)
            x_ext = jnp.concatenate(parts) if len(parts) > 1 else x_loc

        if sharded and S > 1:
            s = jax.lax.axis_index(SHARD_AXIS)
        else:
            s = 0
        g = s * B + jnp.arange(B, dtype=jnp.int64 if self.n > 2**31 else jnp.int32)

        y = jnp.zeros(B, dtype=dtype)
        for (off, v), doff in zip(self.offsets, self.lin_offsets):
            dval = self._diag_value(off, v, g, dtype)
            y = y + dval * jax.lax.slice(x_ext, (lo + doff,), (lo + doff + B,))
        return y

    def _local_matvec(self, x_loc: jnp.ndarray, *, sharded: bool) -> jnp.ndarray:
        if self._view is not None:
            return self._grid_local(x_loc, sharded=sharded)
        return self._linear_local(x_loc, sharded=sharded)

    # ======================================================================
    def _unsharded_multiblock(self, x: jnp.ndarray) -> jnp.ndarray:
        """Mesh-less simulation of the multi-piece linearized layout."""
        B = self.partition.block_size
        lo, hi = self.band_lo, self.band_hi
        dtype = x.dtype
        N = self.partition.padded_size
        outs = []
        for s in range(self.partition.num_pieces):
            idx = (jnp.arange(s * B - lo, s * B + B + hi)) % N
            x_ext = x[idx]
            g = s * B + jnp.arange(
                B, dtype=jnp.int64 if self.n > 2**31 else jnp.int32
            )
            y = jnp.zeros(B, dtype=dtype)
            for (off, v), doff in zip(self.offsets, self.lin_offsets):
                dval = self._diag_value(off, v, g, dtype)
                y = y + dval * jax.lax.slice(x_ext, (lo + doff,), (lo + doff + B,))
            outs.append(y)
        return jnp.concatenate(outs)

    def _make_fn(self, *, grid_input: bool, with_dot: bool):
        S = self.partition.num_pieces
        if grid_input and self._view is None:
            raise ValueError("grid-layout input requires the grid view")

        def local(x_loc, *, sharded):
            if with_dot:
                if self._view is not None:
                    return self._grid_local(
                        x_loc, sharded=sharded, with_dot=True
                    )
                y = self._local_matvec(x_loc, sharded=sharded)
                part = jnp.sum(x_loc * y)  # accumulate in the entry dtype
                if sharded and S > 1:
                    part = jax.lax.psum(part, SHARD_AXIS)
                return y, part
            return self._local_matvec(x_loc, sharded=sharded)

        if S == 1:
            return lambda x: local(x, sharded=False)
        if self.mesh is None:
            if grid_input or with_dot:
                raise ValueError(
                    "grid/fused-dot input needs a mesh or a single piece"
                )
            if self._view is not None:
                # whole-problem single-block view (semantics identical)
                op1 = StencilOperator(
                    self.shape, self.offsets,
                    partition=BlockPartition(self.n, 1),
                    mesh=None, options=self.options,
                )
                return lambda x: op1._local_matvec(x, sharded=False)
            return self._unsharded_multiblock
        ndim_in = len(self.shape) if grid_input else 1
        data_spec = P(SHARD_AXIS, *([None] * (ndim_in - 1)))
        out_specs = (data_spec, P()) if with_dot else data_spec
        return jax.shard_map(
            lambda x: local(x, sharded=True),
            mesh=self.mesh,
            in_specs=(data_spec,),
            out_specs=out_specs,
            # pallas_call's out_shape carries no varying-mesh-axes metadata;
            # disable the vma check for the shard_maps that reach a kernel
            check_vma=False,
        )

    def _fn(self, x: jnp.ndarray, with_dot: bool):
        grid_input = x.ndim > 1
        if not hasattr(self, "_fns"):
            self._fns = {}
        key = (grid_input, with_dot)
        if key not in self._fns:
            self._fns[key] = self._make_fn(
                grid_input=grid_input, with_dot=with_dot
            )
        return self._fns[key]

    def matvec(self, x: jnp.ndarray) -> jnp.ndarray:
        """y = A @ x.  ``x`` may be the flat padded layout or (when the
        grid view is active) the natural grid layout — the result matches
        the input layout."""
        return self._fn(x, False)(x)

    def matvec_dot(self, x: jnp.ndarray):
        """(A @ x, <x, A x>) with the reduction fused into the SpMV pass
        where possible — used by CG to avoid re-reading p and q for the
        alpha denominator."""
        return self._fn(x, True)(x)

    def matvec_add(self, y: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
        return y + self.matvec(x)

    # ======================================================================
    # Fused-CG runners: whole solves as one compiled loop
    # ======================================================================
    @property
    def supports_fused_cg(self) -> bool:
        """Whether :meth:`make_fused_cg_runner` is available: always, except
        sharded runs without a mesh."""
        return self.partition.num_pieces == 1 or self.mesh is not None

    @property
    def step2_eligible(self) -> bool:
        """Whether the s-step (2 iterations / pass, 12 B/unknown/iter)
        fused-CG schedule applies: 2-D grid view with a stencil the s-step
        kernel takes (|dy| <= 1, |dx| <= 1), not disabled via
        LEGIONSOLVERS_NO_SSTEP.  Sharded runs qualify too (mesh required,
        local blocks of >= 16 rows): the pass stays zero-halo/overlappable
        and the 4-row-deep edge corruption of the outputs AND the Gram is
        repaired from pre-exchanged input halos
        (parallel/sstep_sharded.py)."""
        if os.environ.get("LEGIONSOLVERS_NO_SSTEP"):
            return False
        v = self._view
        if v is None or v.get("kind") == "3d":
            return False
        if self.partition.num_pieces > 1:
            if self.mesh is None:
                return False
            from .sstep_sharded import STRIP

            # the two edge-fixup strips must not overlap
            if v["Br"] < 2 * STRIP:
                return False
        from ..ops.pallas.sstep2d import supported

        return supported(v["offs"])

    def _make_step2_cg_runner(self, num_iterations: int, donate: bool = False):
        """s-step fused CG: one kernel pass per TWO iterations (read x/r/p,
        write x''/r''/p'', 12 B/unknown/iteration) with both iterations'
        coefficients derived from the Gram matrix of {r, Ar, p, Ap, A^2p}
        that the *previous* pass emitted (ops/pallas/sstep2d.py, s=2
        monomial basis — the completion of the reference's own fused
        double-CG sketch, reference: scripts/krylov.py:34-93).  A
        gram2 bootstrap pass starts the recurrence from any (x, r, p, rr)
        state; an odd trailing iteration runs as update + XLA xpay.  Same
        contract as the other runners: run(x, r, p, rr0) ->
        (x, r, p, history); history entries after odd iterations are the
        Gram-derived rr1 (exact in exact arithmetic), entries after even
        iterations are true <r, r> from the next Gram.

        Numerics guard: every LEGIONSOLVERS_SSTEP_REFRESH passes (default
        16, i.e. every 32 iterations; 0 disables) the Gram matrix is
        RE-MEASURED from the stored r/p vectors by a gram2 pass instead of
        chained through the step2 recurrence, bounding monomial-basis drift
        on ill-conditioned systems.  Amortized cost: 2/REFRESH extra vector
        passes per 2 iterations (~1.5% traffic at the default), counted by
        utils/roofline.py."""
        from ..ops.grid2d import acc_dtype, cg2_coeffs, grid2d_cg_update
        from ..ops.pallas.sstep2d import gram2, step2

        v = self._view
        C, Br, offs, vals = v["C"], v["Br"], v["offs"], v["vals"]
        acc = acc_dtype(self.options.entry_dtype)
        kw = dict(offsets=offs, values=vals)
        K, odd = divmod(num_iterations, 2)
        refresh = int(os.environ.get("LEGIONSOLVERS_SSTEP_REFRESH", "16"))
        S = self.partition.num_pieces
        sharded = S > 1

        from .sstep_sharded import (
            STRIP,
            exchange_halo4,
            gram2_fixup,
            step2_fixup,
        )
        from .overlap import dot_fixup, apply_edge_fixup

        def sharded_gram2(r, p):
            halos = exchange_halo4(r, p, SHARD_AXIS, S)
            g = gram2(r, p, **kw)
            g = gram2_fixup(g, r, p, halos, offs, vals, SHARD_AXIS, S)
            return jax.lax.psum(g, SHARD_AXIS)

        def gram_bootstrap(r, p):
            if sharded:
                return sharded_gram2(r, p)
            return gram2(r, p, **kw)

        def step2_pass(x, r, p, coef):
            """One zero-halo step2 pass; sharded runs pre-exchange 4-row
            input halos (flying under the pass — parallel/overlap.py) and
            repair the edge corruption + Gram afterwards."""
            if not sharded:
                return step2(x, r, p, coef, **kw)
            halos = exchange_halo4(r, p, SHARD_AXIS, S)
            saves = (x[:STRIP], r[:STRIP], p[:STRIP],
                     x[-STRIP:], r[-STRIP:], p[-STRIP:])
            x, r, p, g = step2(x, r, p, coef, **kw)
            x, r, p, g = step2_fixup(
                (x, r, p, g), saves, halos, coef, offs, vals, SHARD_AXIS, S
            )
            return x, r, p, jax.lax.psum(g, SHARD_AXIS)

        def local_run(x, r, p, rr0):
            was_flat = x.ndim == 1
            if was_flat:
                x, r, p = (a.reshape(Br, C) for a in (x, r, p))
            rr0 = jnp.asarray(rr0, acc)
            hist = jnp.zeros(num_iterations + 1, acc).at[0].set(rr0)
            g = gram_bootstrap(r, p)

            def body(k, carry):
                x, r, p, g, hist = carry
                coef, rr1, _ = cg2_coeffs(g)
                x, r, p, g = step2_pass(x, r, p, coef)
                hist = hist.at[2 * k + 1].set(rr1)
                hist = hist.at[2 * k + 2].set(g[0])
                return x, r, p, g, hist

            def run_block(state, base, count):
                """``count`` step2 passes starting at pass index ``base``
                (base is traced: history scatters use it dynamically)."""
                x, r, p, g, hist = state

                def b(k, carry):
                    return body(base + k, carry)

                return jax.lax.fori_loop(0, count, b, (x, r, p, g, hist))

            if refresh > 0 and K > refresh:
                # Drift guard without control flow in the hot loop: a
                # nested structure re-measures the Gram from the stored
                # vectors at every block boundary.
                n_blocks, rem = divmod(K, refresh)
                state = run_block((x, r, p, g, hist), jnp.int32(0), refresh)

                def outer(o, state):
                    x, r, p, g, hist = state
                    g = gram_bootstrap(r, p)
                    return run_block(
                        (x, r, p, g, hist), (o + 1) * refresh, refresh
                    )

                state = jax.lax.fori_loop(0, n_blocks - 1, outer, state)
                if rem:
                    x, r, p, g, hist = state
                    g = gram_bootstrap(r, p)
                    state = run_block(
                        (x, r, p, g, hist), jnp.int32(n_blocks * refresh),
                        rem,
                    )
                x, r, p, g, hist = state
            else:
                x, r, p, g, hist = jax.lax.fori_loop(
                    0, K, body, (x, r, p, g, hist)
                )
            if odd:
                alpha = g[0] / g[1]
                if sharded:
                    # once-per-solve tail: exchange +-1 p rows, zero-halo
                    # update + edge/dot fixup (overlap preserved)
                    rt, pt, rb, pb = exchange_halo4(r, p, SHARD_AXIS, S)
                    top = jnp.zeros((8, C), p.dtype).at[8 - 4 :, :].set(pt)
                    bot = jnp.zeros((8, C), p.dtype).at[:4, :].set(pb)
                    z = jnp.zeros((8, C), p.dtype)
                    x, r, rr_loc = grid2d_cg_update(p, x, r, alpha, z, z, **kw)
                    coeff = lambda kk, sl: jnp.asarray(vals[kk], p.dtype)
                    miss_alpha = alpha.astype(p.dtype)
                    # r = r_kernel + alpha * (omitted A p edge terms)? the
                    # update subtracts alpha*A p, so add back the omitted
                    # terms with -alpha
                    from .overlap import edge_missing

                    mt, mb = edge_missing(offs, top, bot, Br, coeff)
                    if mt is not None:
                        r = r.at[: mt.shape[0]].add(-miss_alpha * mt)
                    if mb is not None:
                        r = r.at[Br - mb.shape[0] :].add(-miss_alpha * mb)
                    rr_new = jax.lax.psum(
                        jnp.sum((r * r).astype(acc)), SHARD_AXIS
                    )
                else:
                    z = jnp.zeros((8, C), p.dtype)
                    x, r, rr_new = grid2d_cg_update(p, x, r, alpha, z, z, **kw)
                hist = hist.at[num_iterations].set(rr_new)
                p = r + (rr_new / g[0]).astype(p.dtype) * p
            if was_flat:
                x, r, p = (a.reshape(-1) for a in (x, r, p))
            return x, r, p, hist

        dn = (0, 1, 2) if donate else ()
        if not sharded:
            return jax.jit(local_run, donate_argnums=dn)

        fns = {}

        def build(ndim):
            fn = fns.get(ndim)
            if fn is None:
                spec = P(SHARD_AXIS, *([None] * (ndim - 1)))
                fn = jax.jit(
                    jax.shard_map(
                        local_run,
                        mesh=self.mesh,
                        in_specs=(spec, spec, spec, P()),
                        out_specs=(spec, spec, spec, P()),
                        check_vma=False,
                    ),
                    donate_argnums=dn,
                )
                fns[ndim] = fn
            return fn

        def runner(x, r, p, rr0):
            return build(x.ndim)(x, r, p, jnp.asarray(rr0, acc))

        runner.build = build
        return runner

    def make_fused_cg_runner(self, num_iterations: int, donate: bool = False):
        """Build a compiled CG loop.  2-D grids with a stencil the s-step
        kernel takes run the s-step schedule (one pass per two iterations,
        12 B/unknown/iteration, see :meth:`step2_eligible`); other grid views
        run two fused passes per iteration, 32 B/unknown (vs 48 for the
        classic matvec/dot/axpy/axpy/dot/xpay schedule):

        * pass 1 ``xpay_pq``: p = r + beta p and pq = <p, A p>, A p not
          stored (12 B/elt);
        * pass 2 ``update``: x += alpha p, r -= alpha (A p), rr = <r, r>,
          re-deriving A p (20 B/elt).

        Iteration 0 runs as a prologue using the *incoming* p (a plain ``pq``
        pass instead of ``xpay_pq``), so the loop is an exact continuation of
        standard CG from any (x, r, p, rr) state.  Returned callable:
        ``run(x, r, p, rr0) -> (x, r, p, history)`` with history[0] = rr0;
        inputs may be flat padded blocks or grid layout.  q = A p is never
        stored.
        """
        if num_iterations < 1:
            raise ValueError("fused CG runner needs at least one iteration")
        if self._view is None:
            return self._make_jnp_cg_runner(num_iterations, donate)
        if self._view.get("kind") == "3d":
            return self._make_grid3d_cg_runner(num_iterations, donate)
        if num_iterations >= 2 and self.step2_eligible:
            return self._make_step2_cg_runner(num_iterations, donate)

        from ..ops.grid2d import (
            acc_dtype,
            grid2d_cg_pq,
            grid2d_cg_update,
            grid2d_cg_xpay_pq,
            row_bandwidth,
        )

        v = self._view
        C, Br, offs, vals = v["C"], v["Br"], v["offs"], v["vals"]
        S = self.partition.num_pieces
        rlo, rhi = row_bandwidth(offs)
        acc = acc_dtype(self.options.entry_dtype)
        sharded = S > 1
        kw = dict(offsets=offs, values=vals)

        def exchange(*grids):
            """Per-array ([8, C] top, [8, C] bot) halo blocks: neighbor edge
            rows via one fused ppermute per direction, zeros at the global
            grid edges (halo contract: top real rows last, bottom first)."""
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
                    jax.lax.axis_index(SHARD_AXIS) == S - 1,
                    jnp.zeros_like(b), b,
                )
                bots = [
                    z.at[:rhi, :].set(b[k * rhi : (k + 1) * rhi])
                    for k, z in enumerate(bots)
                ]
            return tops, bots

        def psum(s):
            return jax.lax.psum(s, SHARD_AXIS) if sharded else s

        # Overlap (sharded): pass 1 runs with ZERO halos so it has no data
        # dependence on the iteration's ppermutes — XLA can fly the exchange
        # during the pass — and the omitted edge contributions to <p, A p>
        # are patched from the exchanged halos (parallel/overlap.py).  The
        # update pass consumes the (long since arrived) halos directly.
        from .overlap import dot_fixup

        coeff = lambda k, sl: jnp.asarray(vals[k], self.options.entry_dtype)

        def body(i, carry):
            x, r, p, rr, rr_prev, hist = carry
            beta = rr / rr_prev
            (r_top, p_top), (r_bot, p_bot) = exchange(r, p)
            if sharded and (rlo or rhi):
                z = jnp.zeros((8, C), p.dtype)
                p, pq = grid2d_cg_xpay_pq(r, p, beta, z, z, z, z, **kw)
                bb = jnp.asarray(beta, p_top.dtype)
                ptop = r_top + bb * p_top
                pbot = r_bot + bb * p_bot
                pq = pq + dot_fixup(p, offs, ptop, pbot, coeff)
            else:
                p, pq = grid2d_cg_xpay_pq(
                    r, p, beta, r_top, r_bot, p_top, p_bot, **kw
                )
                bb = jnp.asarray(beta, p_top.dtype)
                ptop = r_top + bb * p_top
                pbot = r_bot + bb * p_bot
            pq = psum(pq)
            alpha = rr / pq
            x, r, rr_new = grid2d_cg_update(p, x, r, alpha, ptop, pbot, **kw)
            rr_new = psum(rr_new)
            hist = hist.at[i + 1].set(rr_new)
            return x, r, p, rr_new, rr, hist

        def local_run(x, r, p, rr0):
            was_flat = x.ndim == 1
            if was_flat:
                x, r, p = (a.reshape(Br, C) for a in (x, r, p))
            rr0 = jnp.asarray(rr0, acc)
            hist = jnp.zeros(num_iterations + 1, acc).at[0].set(rr0)
            # prologue: iteration 0 with the incoming p (pq-only pass),
            # same zero-halo overlap structure as the loop body
            (p_top,), (p_bot,) = exchange(p)
            if sharded and (rlo or rhi):
                z = jnp.zeros((8, C), p.dtype)
                pq = grid2d_cg_pq(p, z, z, **kw)
                pq = psum(pq + dot_fixup(p, offs, p_top, p_bot, coeff))
            else:
                pq = psum(grid2d_cg_pq(p, p_top, p_bot, **kw))
            x, r, rr = grid2d_cg_update(p, x, r, rr0 / pq, p_top, p_bot, **kw)
            rr = psum(rr)
            hist = hist.at[1].set(rr)
            x, r, p, rr, _, hist = jax.lax.fori_loop(
                1, num_iterations, body, (x, r, p, rr, rr0, hist)
            )
            if was_flat:
                x, r, p = (a.reshape(-1) for a in (x, r, p))
            return x, r, p, hist

        dn = (0, 1, 2) if donate else ()
        if not sharded:
            return jax.jit(local_run, donate_argnums=dn)

        fns = {}  # jitted shard_map per input layout (flat vs grid)

        def build(ndim):
            fn = fns.get(ndim)
            if fn is None:
                spec = P(SHARD_AXIS, *([None] * (ndim - 1)))
                fn = jax.jit(
                    jax.shard_map(
                        local_run,
                        mesh=self.mesh,
                        in_specs=(spec, spec, spec, P()),
                        out_specs=(spec, spec, spec, P()),
                        check_vma=False,
                    ),
                    donate_argnums=dn,
                )
                fns[ndim] = fn
            return fn

        def runner(x, r, p, rr0):
            return build(x.ndim)(x, r, p, jnp.asarray(rr0, acc))

        runner.build = build
        return runner

    @property
    def supports_fused_bicgstab(self) -> bool:
        """Whether :meth:`make_fused_bicgstab_runner` is available: any grid
        view (3-D single-shard).  Sharded 2-D runs qualify too (mesh
        required, local blocks >= 16 rows): the
        passes stay zero-halo and the single-application edge corruption
        of outputs AND fused dots is repaired from exchanged input halos
        (the same overlap-preserving structure as the sharded s-step CG)."""
        if os.environ.get("LEGIONSOLVERS_NO_FUSED_BICGSTAB"):
            return False
        v = self._view
        if v is None:
            return False
        if v.get("kind") == "3d":
            return self.partition.num_pieces == 1
        if self.partition.num_pieces > 1:
            return self.mesh is not None and v["Br"] >= 16
        return True

    def make_fused_bicgstab_runner(self, num_iterations: int,
                                   donate: bool = False):
        """Whole-loop BiCGStab at 15 vector passes/iteration (60 B/unknown
        at acc) via the three fused passes of ops/grid2d.py — vs 24 passes
        for the planner transcription.  Contract:
        ``run(x, r, p, v, rt, rho, alpha, omega) ->
        (x, r, p, v, rho, alpha, omega, history)`` with history[0] =
        <r, r> on entry; exact continuation of the transcription
        recurrence (reference: BiCGStabSolver.hpp:64-82) from any state."""
        v = self._view
        if v.get("kind") == "3d":
            return self._make_bicgstab3d_runner(num_iterations, donate)
        from ..ops.grid2d import (
            acc_dtype,
            apply2d as _apply,
            bicg_pv,
            bicg_st,
            bicg_update,
            row_bandwidth,
        )
        from .overlap import edge_missing

        C, Br, offs, vals = v["C"], v["Br"], v["offs"], v["vals"]
        S = self.partition.num_pieces
        sharded = S > 1
        compensated = bool(self.options.compensated_dots)
        kw = dict(offsets=offs, values=vals, compensated=compensated)
        rlo, rhi = row_bandwidth(offs)
        dtype = jnp.dtype(self.options.entry_dtype)
        acc = acc_dtype(dtype)
        coeff = lambda k, sl: jnp.asarray(vals[k], dtype)

        def exchange3(a, b, c, dlo, dhi):
            """Neighbor edge rows of three arrays (zeros at global edges):
            ((a_t, b_t, c_t), (a_b, b_b, c_b)) with dlo/dhi rows each."""
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
            """[8, C] halo blocks in the passes'/overlap.py's contract:
            top real rows LAST, bottom real rows FIRST."""
            zt = jnp.zeros((8, C), dtype)
            zb = jnp.zeros((8, C), dtype)
            if rlo:
                zt = zt.at[8 - rlo :, :].set(top)
            if rhi:
                zb = zb.at[:rhi, :].set(bot)
            return zt, zb

        def psum(s):
            return jax.lax.psum(s, SHARD_AXIS) if sharded else s

        def edge_dot(a_top, a_bot, miss_t, miss_b):
            """sum(a_edge * miss) over both edges (acc)."""
            f = jnp.zeros((), acc)
            if miss_t is not None:
                f = f + jnp.sum((a_top * miss_t).astype(acc))
            if miss_b is not None:
                f = f + jnp.sum((a_bot * miss_b).astype(acc))
            return f

        def t0_edges(s_loc_t, s_loc_b):
            """Zero-halo A(s) on the edge rows, recomputed in jnp from the
            local edge strips (t is never stored): strips carry
            rlo+rhi extra context rows."""
            t0t = t0b = None
            if rlo:
                ext = jnp.concatenate(
                    [jnp.zeros((rlo, C), dtype), s_loc_t], 0)
                t0t = _apply(ext, offs, vals)[rlo : 2 * rlo]
            if rhi:
                ext = jnp.concatenate(
                    [s_loc_b, jnp.zeros((rhi, C), dtype)], 0)
                t0b = _apply(ext, offs, vals)[-2 * rhi : -rhi]
            return t0t, t0b

        def local_run(x, r, p, vv, rt, rho, alpha, omega):
            was_flat = x.ndim == 1
            if was_flat:
                x, r, p, vv, rt = (a.reshape(Br, C)
                                   for a in (x, r, p, vv, rt))
            rho, alpha, omega = (jnp.asarray(s, acc)
                                 for s in (rho, alpha, omega))
            # bootstrap dots (once per solve): <r, r> and <r~, r>
            if compensated:
                from ..ops.ddsum import dd_dot

                rr0 = psum(dd_dot(r.reshape(-1), r.reshape(-1)))
                rtr = psum(dd_dot(rt.reshape(-1), r.reshape(-1)))
            else:
                rr0 = psum(jnp.sum((r * r).astype(acc)))
                rtr = psum(jnp.sum((rt * r).astype(acc)))
            hist = jnp.zeros(num_iterations + 1, acc).at[0].set(rr0)

            def body(i, carry):
                x, r, p, vv, rho, alpha, omega, rtr, hist = carry
                rho_new = rtr
                beta = (rho_new / rho) * (alpha / omega)
                if not sharded:
                    p, vv, rtv = bicg_pv(r, p, vv, rt, beta, omega, **kw)
                    alpha = rho_new / rtv
                    ts, tt = bicg_st(r, vv, alpha, **kw)
                    omega = ts / tt
                    x, r, rr, rtr = bicg_update(
                        r, vv, x, p, rt, alpha, omega, **kw
                    )
                    hist = hist.at[i + 1].set(rr)
                    return x, r, p, vv, rho_new, alpha, omega, rtr, hist

                # ---- sharded: zero-halo passes + edge fixups ----------
                # ONE exchange per iteration, of depth-2 INPUT halos (r/p/v
                # at 2*rlo / 2*rhi rows).  Every later fixup quantity is
                # derived from it: p_new's halo elementwise, and
                # v_new = A p_new's halo by applying the stencil to the
                # derived p_new slab (the sstep_sharded.py technique at
                # depth 2) — so the mid-iteration exchange of round 3
                # (HLO_OVERLAP.txt non_overlapped entries) is gone and the
                # single exchange is data-independent of all three passes.
                (r_t, p_t, v_t), (r_b, p_b, v_b) = exchange3(
                    r, p, vv, 2 * rlo, 2 * rhi)
                bb = beta.astype(dtype)
                om = omega.astype(dtype)
                p, vv, rtv0 = bicg_pv(r, p, vv, rt, beta, omega, **kw)
                # p_new on the depth-2 halo rows (elementwise recurrence)
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
                rtv = psum(rtv0 + edge_dot(rt[:rlo], rt[Br - rhi :],
                                           mv_t, mv_b))
                alpha = rho_new / rtv
                al = alpha.astype(dtype)

                # v_new's halo rows, DERIVED (not exchanged): A p_new on the
                # neighbor edge needs p_new on [-2*rlo, rlo) — the derived
                # depth-2 halo plus the pv pass's own first rows (p is p_new
                # here).  Shards without a neighbor zero theirs (matching
                # the zeroed exchange rows).
                idx_s = jax.lax.axis_index(SHARD_AXIS)
                r2_t = r_t[-rlo:] if rlo else r_t  # input r, unchanged
                r2_b = r_b[:rhi] if rhi else r_b
                if rlo:
                    # A at rows [-rlo, 0) reads rows [-2*rlo, rhi)
                    slab_t = jnp.concatenate([pn2_t, p[:rhi]], 0)
                    v2_t = _apply(slab_t, offs, vals)[rlo : 2 * rlo]
                    v2_t = jnp.where(
                        idx_s == 0, jnp.zeros_like(v2_t), v2_t)
                if rhi:
                    # A at rows [Br, Br+rhi) reads rows [Br-rlo, Br+2*rhi)
                    slab_b = jnp.concatenate([p[Br - rlo :], pn2_b], 0)
                    v2_b = _apply(slab_b, offs, vals)[rlo : rlo + rhi]
                    v2_b = jnp.where(
                        idx_s == S - 1, jnp.zeros_like(v2_b), v2_b)
                ts0, tt0 = bicg_st(r, vv, alpha, **kw)
                s_t = r2_t - al * v2_t if rlo else r2_t   # s halo rows
                s_b = r2_b - al * v2_b if rhi else r2_b
                st8, sb8 = pad8(s_t, s_b)
                mt_t, mt_b = edge_missing(offs, st8, sb8, Br, coeff)
                # local s edge strips (with rlo+rhi context rows)
                ctx = rlo + rhi
                s_loc_t = (r[: rlo + ctx] - al * vv[: rlo + ctx]
                           if rlo else None)
                s_loc_b = (r[Br - rhi - ctx :] - al * vv[Br - rhi - ctx :]
                           if rhi else None)
                t0t, t0b = t0_edges(s_loc_t, s_loc_b)
                ts = psum(ts0 + edge_dot(
                    s_loc_t[:rlo] if rlo else None,
                    s_loc_b[-rhi:] if rhi else None, mt_t, mt_b))
                dtt = jnp.zeros((), acc)
                if mt_t is not None:
                    dtt = dtt + jnp.sum(
                        (2.0 * t0t * mt_t + mt_t * mt_t).astype(acc))
                if mt_b is not None:
                    dtt = dtt + jnp.sum(
                        (2.0 * t0b * mt_b + mt_b * mt_b).astype(acc))
                tt = psum(tt0 + dtt)
                omega = ts / tt
                om2 = omega.astype(dtype)

                x, r, rr0_, rtr0 = bicg_update(
                    r, vv, x, p, rt, alpha, omega, **kw
                )
                # r' = s - omega t: edge correction delta = -omega * miss
                drr = jnp.zeros((), acc)
                drtr = jnp.zeros((), acc)
                if mt_t is not None:
                    d_t = -om2 * mt_t
                    r0e = s_loc_t[:rlo] - om2 * t0t
                    r = r.at[:rlo].add(d_t)
                    drr = drr + jnp.sum(
                        (2.0 * r0e * d_t + d_t * d_t).astype(acc))
                    drtr = drtr + jnp.sum((rt[:rlo] * d_t).astype(acc))
                if mt_b is not None:
                    d_b = -om2 * mt_b
                    r0e = s_loc_b[-rhi:] - om2 * t0b
                    r = r.at[Br - rhi :].add(d_b)
                    drr = drr + jnp.sum(
                        (2.0 * r0e * d_b + d_b * d_b).astype(acc))
                    drtr = drtr + jnp.sum(
                        (rt[Br - rhi :] * d_b).astype(acc))
                rr = psum(rr0_ + drr)
                rtr = psum(rtr0 + drtr)
                hist = hist.at[i + 1].set(rr)
                return x, r, p, vv, rho_new, alpha, omega, rtr, hist

            x, r, p, vv, rho, alpha, omega, rtr, hist = jax.lax.fori_loop(
                0, num_iterations, body,
                (x, r, p, vv, rho, alpha, omega, rtr, hist),
            )
            if was_flat:
                x, r, p, vv = (a.reshape(-1) for a in (x, r, p, vv))
            return x, r, p, vv, rho, alpha, omega, hist

        dn = (0, 1, 2, 3) if donate else ()
        if not sharded:
            return jax.jit(local_run, donate_argnums=dn)

        spec2 = P(SHARD_AXIS, None)
        spec1 = P(SHARD_AXIS)

        fns = {}

        def build(ndim):
            fn = fns.get(ndim)
            if fn is None:
                spec = spec1 if ndim == 1 else spec2
                fn = jax.jit(
                    jax.shard_map(
                        local_run,
                        mesh=self.mesh,
                        in_specs=(spec,) * 5 + (P(), P(), P()),
                        out_specs=(spec,) * 4 + (P(), P(), P(), P()),
                        check_vma=False,
                    ),
                    donate_argnums=dn,
                )
                fns[ndim] = fn
            return fn

        def runner(x, r, p, vv, rt, rho, alpha, omega):
            return build(x.ndim)(x, r, p, vv, rt, rho, alpha, omega)

        runner.build = build
        return runner

    def _make_bicgstab3d_runner(self, num_iterations: int,
                                donate: bool = False):
        """3-D fused BiCGStab (single shard): the 3-D analogs of the three
        2-D passes (ops/grid3d.py), 60 B/unknown.  Same contract as the 2-D
        runner."""
        from ..ops.grid2d import acc_dtype
        from ..ops.grid3d import bicg3d_pv, bicg3d_st, bicg3d_update

        v = self._view
        Y, Z, Br = v["Y"], v["Z"], v["Br"]
        acc = acc_dtype(self.options.entry_dtype)
        compensated = bool(self.options.compensated_dots)
        kw = dict(offsets=v["offs3"], values=v["vals"],
                  compensated=compensated)

        def local_run(x, r, p, vv, rt, rho, alpha, omega):
            was_flat = x.ndim == 1
            if was_flat:
                x, r, p, vv, rt = (a.reshape(Br, Y, Z)
                                   for a in (x, r, p, vv, rt))
            rho, alpha, omega = (jnp.asarray(s, acc)
                                 for s in (rho, alpha, omega))
            if compensated:
                from ..ops.ddsum import dd_dot

                rr0 = dd_dot(r.reshape(-1), r.reshape(-1))
                rtr = dd_dot(rt.reshape(-1), r.reshape(-1))
            else:
                rr0 = jnp.sum((r * r).astype(acc))
                rtr = jnp.sum((rt * r).astype(acc))
            hist = jnp.zeros(num_iterations + 1, acc).at[0].set(rr0)

            def body(i, carry):
                x, r, p, vv, rho, alpha, omega, rtr, hist = carry
                rho_new = rtr
                beta = (rho_new / rho) * (alpha / omega)
                p, vv, rtv = bicg3d_pv(r, p, vv, rt, beta, omega, **kw)
                alpha = rho_new / rtv
                ts, tt = bicg3d_st(r, vv, alpha, **kw)
                omega = ts / tt
                x, r, rr, rtr = bicg3d_update(
                    r, vv, x, p, rt, alpha, omega, **kw)
                hist = hist.at[i + 1].set(rr)
                return x, r, p, vv, rho_new, alpha, omega, rtr, hist

            x, r, p, vv, rho, alpha, omega, rtr, hist = jax.lax.fori_loop(
                0, num_iterations, body,
                (x, r, p, vv, rho, alpha, omega, rtr, hist),
            )
            if was_flat:
                x, r, p, vv = (a.reshape(-1) for a in (x, r, p, vv))
            return x, r, p, vv, rho, alpha, omega, hist

        dn = (0, 1, 2, 3) if donate else ()
        return jax.jit(local_run, donate_argnums=dn)

    def _make_grid3d_cg_runner(self, num_iterations: int, donate: bool = False):
        """Fused CG over the 3-D grid view: each iteration is an ``xpay_pq``
        pass (p = r + beta p, <p, A p>; 12 B/elt) + an ``update`` pass
        (20 B/elt) = 32 B/unknown/iteration.  One r and p halo-plane
        exchange per iteration.  Same contract as the 2-D runner:
        run(x, r, p, rr0) -> (x, r, p, history)."""
        from ..ops.grid2d import acc_dtype
        from ..ops.grid3d import (
            grid3d_cg_pq,
            grid3d_cg_update,
            grid3d_cg_xpay_pq,
        )

        v = self._view
        Y, Z, Br = v["Y"], v["Z"], v["Br"]
        S = self.partition.num_pieces
        sharded = S > 1
        acc = acc_dtype(self.options.entry_dtype)
        kw = dict(offsets=v["offs3"], values=v["vals"])

        def psum(s):
            return jax.lax.psum(s, SHARD_AXIS) if sharded else s

        def half_step(x, r, p, rr, hist, slot):
            """pq + update passes for the current p; returns new state."""
            top, bot = self._exchange_planes3d(p, sharded=sharded)
            pq = psum(grid3d_cg_pq(p, top, bot, **kw))
            alpha = rr / pq
            x, r, rr_new = grid3d_cg_update(p, x, r, alpha, top, bot, **kw)
            rr_new = psum(rr_new)
            hist = hist.at[slot].set(rr_new)
            return x, r, rr_new, hist

        def body(i, carry):
            x, r, p, rr, rr_prev, hist = carry
            beta = (rr / rr_prev).astype(p.dtype)
            # p's halo planes = r_halo + beta * p_halo
            rt, rb = self._exchange_planes3d(r, sharded=sharded)
            pt, pb = self._exchange_planes3d(p, sharded=sharded)
            pn_t = rt + beta * pt
            pn_b = rb + beta * pb
            p, pq = grid3d_cg_xpay_pq(r, p, beta, pn_t, pn_b, **kw)
            pq = psum(pq)
            alpha = rr / pq
            x, r, rr_new = grid3d_cg_update(
                p, x, r, alpha, pn_t, pn_b, **kw
            )
            rr_new = psum(rr_new)
            hist = hist.at[i + 1].set(rr_new)
            return x, r, p, rr_new, rr, hist

        def local_run(x, r, p, rr0):
            was_flat = x.ndim == 1
            if was_flat:
                x, r, p = (a.reshape(Br, Y, Z) for a in (x, r, p))
            rr0 = jnp.asarray(rr0, acc)
            hist = jnp.zeros(num_iterations + 1, acc).at[0].set(rr0)
            # prologue: iteration 0 uses the incoming p unchanged
            x, r, rr, hist = half_step(x, r, p, rr0, hist, 1)
            x, r, p, rr, _, hist = jax.lax.fori_loop(
                1, num_iterations, body, (x, r, p, rr, rr0, hist)
            )
            if was_flat:
                x, r, p = (a.reshape(-1) for a in (x, r, p))
            return x, r, p, hist

        dn = (0, 1, 2) if donate else ()
        if not sharded:
            return jax.jit(local_run, donate_argnums=dn)

        fns = {}

        def runner(x, r, p, rr0):
            fn = fns.get(x.ndim)
            if fn is None:
                spec = P(SHARD_AXIS, *([None] * (x.ndim - 1)))
                fn = jax.jit(
                    jax.shard_map(
                        local_run,
                        mesh=self.mesh,
                        in_specs=(spec, spec, spec, P()),
                        out_specs=(spec, spec, spec, P()),
                        check_vma=False,
                    ),
                    donate_argnums=dn,
                )
                fns[x.ndim] = fn
            return fn(x, r, p, jnp.asarray(rr0, acc))

        return runner

    def _make_jnp_cg_runner(self, num_iterations: int, donate: bool = False):
        """Whole-loop CG runner for operators without the grid view (1-D,
        4-D+, padded tails): the classic 6-op schedule with the matvec
        recomputed per iteration, compiled as one ``fori_loop`` so dispatch
        overhead is amortized like the other runners.  Arithmetic order matches ``CGSolver.step`` (the
        reference recurrence, CGSolver.hpp:46-55), so the fp64 golden
        trajectory is preserved bit-for-bit."""
        S = self.partition.num_pieces
        sharded = S > 1

        def ldot(a, b):
            s = jnp.sum(a * b)
            return jax.lax.psum(s, SHARD_AXIS) if sharded else s

        def body(i, carry):
            x, r, p, rr, hist = carry
            q = self._local_matvec(p, sharded=sharded)
            pq = ldot(p, q)
            alpha = rr / pq
            x = x + alpha * p
            r = r - alpha * q
            rr_new = ldot(r, r)
            hist = hist.at[i + 1].set(rr_new)
            p = r + (rr_new / rr) * p
            return x, r, p, rr_new, hist

        def local_run(x, r, p, rr0):
            # accept grid-layout inputs too: flatten to the 1-D local block
            # for the linearized matvec, restore the layout on return
            shape = x.shape
            if x.ndim > 1:
                x, r, p = (a.reshape(-1) for a in (x, r, p))
            rr0 = jnp.asarray(rr0, x.dtype)
            hist = jnp.zeros(num_iterations + 1, x.dtype).at[0].set(rr0)
            x, r, p, _, hist = jax.lax.fori_loop(
                0, num_iterations, body, (x, r, p, rr0, hist)
            )
            if len(shape) > 1:
                x, r, p = (a.reshape(shape) for a in (x, r, p))
            return x, r, p, hist

        dn = (0, 1, 2) if donate else ()
        if not sharded:
            return jax.jit(local_run, donate_argnums=dn)

        fns = {}  # jitted shard_map per input layout (flat vs grid)

        def runner(x, r, p, rr0):
            fn = fns.get(x.ndim)
            if fn is None:
                spec = P(SHARD_AXIS, *([None] * (x.ndim - 1)))
                fn = jax.jit(
                    jax.shard_map(
                        local_run,
                        mesh=self.mesh,
                        in_specs=(spec, spec, spec, P()),
                        out_specs=(spec, spec, spec, P()),
                        check_vma=False,
                    ),
                    donate_argnums=dn,
                )
                fns[x.ndim] = fn
            return fn(x, r, p, rr0)

        return runner

    def transpose(self) -> "StencilOperator":
        """A^T as a stencil operator: offset o with value v becomes offset -o
        (A[p, p+o] = v  =>  A^T[q, q-o] = v).  Built lazily and cached."""
        if not hasattr(self, "_transpose_op"):
            self._transpose_op = StencilOperator(
                self.shape,
                [(tuple(-c for c in o), v) for o, v in self.offsets],
                partition=self.partition,
                mesh=self.mesh,
                options=self.options,
                grid_view=self._view is not None,
            )
        return self._transpose_op

    def rmatvec(self, x: jnp.ndarray) -> jnp.ndarray:
        """y = A^T @ x (the reference stubs transpose matvec entirely:
        COOMatrixTasks.cpp:78-83)."""
        return self.transpose().matvec(x)
