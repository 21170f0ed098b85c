"""SquarePlanner: assembles vectors + operators into a solvable system.

JAX analog of the reference's ``SquarePlanner<T>``
(reference: SquarePlanner.hpp:30-357).  It keeps the reference's vector-index
algebra exactly — index 0 is the solution vector set, 1 the right-hand-side
set, ``2 + k`` the k-th workspace set, each set holding one vector per
registered "space" (block-system support: the reference registers the same
matrix twice over two spaces in BenchmarkStencil.cpp:201-207) — so the
solver classes are near-transcriptions of the reference algorithms.

Differences:
* ``add_row_partitioned_matrix`` builds a
  :class:`~legionsolvers_tpu.parallel.distmatrix.RowPartitionedMatrix` —
  host-side dependent partitioning + static halo schedule — instead of
  launching Legion dependent-partitioning ops.
* The planner exposes ``dump_state()/load_state()`` so a whole solver
  iteration can be traced once and driven by ``lax.scan`` (the analog of the
  reference's physical-trace replay, LegionSolversMapper.cpp:52-59).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import jax.numpy as jnp

from .core.matrix import AbstractMatrix
from .core.partition import BlockPartition
from .core.scalar import Scalar
from .core.vector import PartitionedVector, _resolve_alpha
from .ops import blas1
from .options import SolverOptions, DEFAULT_OPTIONS
from .parallel.distmatrix import RowPartitionedMatrix

SOL = 0
RHS = 1


class SquarePlanner:
    def __init__(self, mesh=None, options: SolverOptions = DEFAULT_OPTIONS):
        self.mesh = mesh
        self.options = options
        self.canonical_partitions: List[BlockPartition] = []
        self.canonical_grid_shapes: List[Optional[tuple]] = []
        self.sol_vectors: List[PartitionedVector] = []
        self.rhs_vectors: List[PartitionedVector] = []
        self.workspace_vectors: List[List[PartitionedVector]] = []
        self.row_partitioned_matrices: List[
            Tuple[RowPartitionedMatrix, int, int]
        ] = []
        # RCM reordered-basis state (parallel/reorder.py), PER SPACE: set
        # when a space's first explicit matrix is upgraded to a reordered
        # operator; solvers enter the basis for the duration of solve() and
        # leave it after.  Each entry holds perm_np/iperm_np (host) and
        # perm_dev/iperm_dev (padded device index arrays for that space).
        self.basis_perms: Dict[int, Dict] = {}
        self._in_solver_basis = False

    @property
    def basis_perm(self):
        """Legacy single-basis view (space 0), kept for callers that only
        probe whether a reordered basis is active."""
        return self.basis_perms.get(0)

    # -- registration (reference: SquarePlanner.hpp:99-188) ----------------
    def _register_canonical(self, idx: int, v: PartitionedVector) -> None:
        if len(self.canonical_partitions) > idx:
            if self.canonical_partitions[idx] != v.partition:
                raise ValueError("vector partition disagrees with canonical")
            if self.canonical_grid_shapes[idx] != v.grid_shape:
                raise ValueError("vector layout disagrees with canonical")
        else:
            if len(self.canonical_partitions) != idx:
                raise ValueError("sol/rhs vectors must be added alternately")
            self.canonical_partitions.append(v.partition)
            self.canonical_grid_shapes.append(v.grid_shape)

    def add_sol_vector(self, v: PartitionedVector) -> int:
        if self.workspace_vectors:
            raise RuntimeError("cannot add vectors after allocate_workspace")
        idx = len(self.sol_vectors)
        self._register_canonical(idx, v)
        self.sol_vectors.append(v)
        return idx

    def add_rhs_vector(self, v: PartitionedVector) -> int:
        if self.workspace_vectors:
            raise RuntimeError("cannot add vectors after allocate_workspace")
        idx = len(self.rhs_vectors)
        self._register_canonical(idx, v)
        self.rhs_vectors.append(v)
        return idx

    @property
    def num_spaces(self) -> int:
        n = len(self.canonical_partitions)
        assert n == len(self.sol_vectors) == len(self.rhs_vectors)
        return n

    def allocate_workspace(self, num_vectors: int) -> None:
        """Allocate ``num_vectors`` workspace vector sets, one vector per
        canonical space (reference: SquarePlanner.hpp:153-188)."""
        if self.workspace_vectors:
            raise RuntimeError("workspace already allocated")
        for j in range(num_vectors):
            self.workspace_vectors.append(
                [
                    PartitionedVector(
                        f"workspace_{j}_{i}",
                        self.canonical_partitions[i],
                        mesh=self.mesh,
                        options=self.options,
                        grid_shape=self.canonical_grid_shapes[i],
                        # materialized on first touch: solvers that never
                        # read a workspace vector (Q on the fused CG path)
                        # pay no device memory for it
                        lazy=True,
                    )
                    for i in range(self.num_spaces)
                ]
            )

    def add_row_partitioned_matrix(
        self, matrix: AbstractMatrix, domain_index: int, range_index: int,
        prefer_dia: bool = True,
    ) -> None:
        """reference: SquarePlanner.hpp:209-235 — derive the kernel partition
        from the canonical range partition and the ghost partition from the
        kernel partition; here both become static per-shard data.

        Storage is chosen by a host-side layout analysis (the analog of the
        reference picking the cuSPARSE COO vs CSR leaf task): square
        matrices with few distinct diagonals become a
        :class:`~.parallel.dia_op.DiaOperator` (per-diagonal coefficient
        arrays, (2 + D) * itemsize B/row traffic); others try the RCM
        reordered tiers (parallel/reorder.py); everything else becomes the
        general ELL + halo-schedule
        :class:`~.parallel.distmatrix.RowPartitionedMatrix`.
        Pass ``prefer_dia=False`` (or set LEGIONSOLVERS_NO_DIA=1) to force ELL.
        """
        import os

        if domain_index >= self.num_spaces or range_index >= self.num_spaces:
            raise ValueError("space index out of range")
        dp = self.canonical_partitions[domain_index]
        rp = self.canonical_partitions[range_index]
        dist = None
        same_space = domain_index == range_index
        dom_basis = self.basis_perms.get(domain_index)
        rng_basis = self.basis_perms.get(range_index)
        # Basis consistency first (r4 advisor, severity high): once a space
        # adopted an RCM basis, EVERY later operator touching it must be
        # expressed in that basis — to_solver_basis permutes the space's
        # vectors, so an original-basis operator would silently compute
        # garbage.  Square same-space matrices adopt via the forced reorder
        # path (best kernel on the permuted matrix, generic ELL fallback);
        # cross-space matrices get the two-sided CrossBasisOperator.
        if same_space and rng_basis is not None:
            from .parallel.reorder import try_reordered_operator

            dist = try_reordered_operator(
                matrix, rp, self.options, perm=rng_basis["perm_np"],
                mesh=self.mesh, force=True,
            )
        elif not same_space and (
            dom_basis is not None or rng_basis is not None
        ):
            from .parallel.reorder import cross_basis_operator

            dist = cross_basis_operator(
                matrix, dp, rp, dom_basis, rng_basis, self.mesh, self.options
            )
        if dist is None and (
            prefer_dia
            and not bool(int(os.environ.get("LEGIONSOLVERS_NO_DIA", "0")))
            and matrix.n_domain == matrix.n_range
            and dp == rp
            and (dp.num_pieces == 1 or self.mesh is not None)
            and self.canonical_grid_shapes[domain_index] is None
        ):
            import numpy as np

            from .native import bindings as native
            from .parallel.dia_op import (
                MAX_DIAGONALS,
                MIN_DIA_FILL,
                DiaOperator,
            )

            # density-aware gate: DIA per-nnz traffic is constant in the
            # diagonal count, so many-diagonal banded matrices still get
            # the streaming kernel; only low-FILL diagonals (mostly-zero
            # coefficient arrays) make DIA lose to ELL
            uoffs = native.dia_unique_offsets(
                np.asarray(matrix.rows, np.int64),
                np.asarray(matrix.cols, np.int64),
                MAX_DIAGONALS,
            )
            if (
                uoffs is not None
                and matrix.n_kernel
                >= MIN_DIA_FILL * len(uoffs) * rp.padded_size
            ):
                dist = DiaOperator(
                    matrix, partition=rp, mesh=self.mesh, options=self.options
                )
        if (
            dist is None
            and prefer_dia
            and not bool(int(os.environ.get("LEGIONSOLVERS_NO_RCM", "0")))
            and same_space
            and matrix.n_domain == matrix.n_range
            and dp == rp
            and (dp.num_pieces == 1 or self.mesh is not None)
            and self.canonical_grid_shapes[domain_index] is None
            # a fresh RCM basis may only be established on a space no other
            # operator touches yet; existing original-basis operators on the
            # space cannot be re-expressed after the fact
            and not any(
                range_index in (d, r)
                for _, d, r in self.row_partitioned_matrices
            )
        ):
            from .parallel.reorder import try_reordered_operator

            dist = try_reordered_operator(
                matrix, rp, self.options, mesh=self.mesh
            )
            if dist is not None:
                import numpy as np

                iperm_np = np.empty(len(dist.perm_np), np.int64)
                iperm_np[dist.perm_np] = np.arange(len(dist.perm_np))
                self.basis_perms[range_index] = {
                    "perm_np": dist.perm_np,
                    "iperm_np": iperm_np,
                    "perm_dev": dist.perm_dev,
                    "iperm_dev": dist.iperm_dev,
                }
        if dist is None:
            dist = RowPartitionedMatrix(
                matrix,
                domain_partition=dp,
                range_partition=rp,
                mesh=self.mesh,
                options=self.options,
            )
        self.row_partitioned_matrices.append((dist, domain_index, range_index))

    def add_operator(self, op, domain_index: int, range_index: int) -> None:
        """Register a pre-distributed operator (e.g. a matrix-free
        :class:`~legionsolvers_tpu.parallel.stencil_op.StencilOperator`).
        The operator must expose ``matvec_add(y, x)`` over padded sharded
        arrays and agree with the canonical partitions."""
        if domain_index >= self.num_spaces or range_index >= self.num_spaces:
            raise ValueError("space index out of range")
        if (
            domain_index in self.basis_perms
            or range_index in self.basis_perms
        ):
            # matrix-free operators cannot be re-expressed in an RCM basis;
            # silently registering one would corrupt permuted-space solves
            raise ValueError(
                "cannot register a matrix-free operator on a space already "
                "in an RCM solver basis; register it before any reorderable "
                "matrix, or pass prefer_dia=False / set "
                "LEGIONSOLVERS_NO_RCM=1 for the explicit matrices"
            )
        part = getattr(op, "partition", None)
        if part is not None and part != self.canonical_partitions[range_index]:
            raise ValueError("operator partition disagrees with canonical")
        self.row_partitioned_matrices.append((op, domain_index, range_index))

    # -- vector access (reference: SquarePlanner.hpp:237-246) --------------
    def get_vector(self, vec_idx: int, space_idx: int) -> PartitionedVector:
        if vec_idx == SOL:
            return self.sol_vectors[space_idx]
        if vec_idx == RHS:
            return self.rhs_vectors[space_idx]
        return self.workspace_vectors[vec_idx - 2][space_idx]

    def _vectors(self, vec_idx: int) -> List[PartitionedVector]:
        return [self.get_vector(vec_idx, i) for i in range(self.num_spaces)]

    # -- algebra (reference: SquarePlanner.hpp:248-357) --------------------
    def zero_fill(self, vec_idx: int) -> None:
        for v in self._vectors(vec_idx):
            v.zero_fill()

    def copy(self, dst_idx: int, src_idx: int) -> None:
        for d, s in zip(self._vectors(dst_idx), self._vectors(src_idx)):
            d.assign(s)

    def scal(self, dst_idx: int, *alpha) -> None:
        for v in self._vectors(dst_idx):
            v.scal(*alpha)

    def axpy(self, dst_idx: int, *args) -> None:
        """axpy(dst, alpha..., src): dst += alpha * src with the 1/2/3-scalar
        future-ratio protocol (reference: SquarePlanner.hpp:275-310)."""
        *alpha, src_idx = args
        for d, s in zip(self._vectors(dst_idx), self._vectors(src_idx)):
            d.axpy(*alpha, s)

    def xpay(self, dst_idx: int, *args) -> None:
        *alpha, src_idx = args
        for d, s in zip(self._vectors(dst_idx), self._vectors(src_idx)):
            d.xpay(*alpha, s)

    def dot(self, v_idx: int, w_idx: int) -> Scalar:
        """Sum of per-space dots (reference: SquarePlanner.hpp:331-338).
        Under ``options.compensated_dots`` each dot carries two-float
        accumulation (ops/ddsum.py) — an f32 stand-in for f64 reductions."""
        if self.options.compensated_dots:
            from .ops.ddsum import dd_dot

            def d(a, b, v):
                if v.mesh is not None:
                    # per-shard dd accumulation + a tiny f32 psum of the
                    # collapsed partials, mirroring the sharded fused path
                    # in stencil_op.py — running dd_dot's pad/fori_loop as
                    # a GLOBAL computation would serialize and move every
                    # shard's data (r4 advisor finding)
                    import jax
                    from jax.experimental.shard_map import shard_map

                    spec = v.sharding.spec
                    from .options import SHARD_AXIS

                    f = shard_map(
                        lambda x, y: jax.lax.psum(
                            dd_dot(x.reshape(-1), y.reshape(-1)), SHARD_AXIS
                        ),
                        mesh=v.mesh, in_specs=(spec, spec),
                        out_specs=jax.sharding.PartitionSpec(),
                    )
                    r = f(a, b)
                else:
                    r = dd_dot(a.reshape(-1), b.reshape(-1))
                return jnp.asarray(r, self.options.entry_dtype)
        else:
            d = lambda a, b, v: blas1.dot(a, b)
        parts = [
            d(v.data, w.data, v)
            for v, w in zip(self._vectors(v_idx), self._vectors(w_idx))
        ]
        total = parts[0]
        for p in parts[1:]:
            total = total + p
        return Scalar(total)

    def _operators_by_range(self):
        by_range = {}
        for dist, domain_index, range_index in self.row_partitioned_matrices:
            by_range.setdefault(range_index, []).append((dist, domain_index))
        return by_range

    def matvec(self, dst_idx: int, src_idx: int) -> None:
        """dst = sum over registered operators of A @ src, accumulated per
        range space (reference: SquarePlanner.hpp:340-357 zero-fills then
        reduces; here single-operator spaces assign directly, saving the
        zero-fill + add passes)."""
        by_range = self._operators_by_range()
        for i in range(self.num_spaces):
            dst = self.get_vector(dst_idx, i)
            ops = by_range.get(i, [])
            if not ops:
                dst.zero_fill()
                continue
            first = True
            for dist, domain_index in ops:
                src = self.get_vector(src_idx, domain_index)
                if first:
                    dst.data = dist.matvec(src.data)
                    first = False
                else:
                    dst.data = dist.matvec_add(dst.data, src.data)

    def matvec_dot(self, dst_idx: int, src_idx: int) -> Scalar:
        """dst = A src and return <src, dst> in one pass, fusing the
        reduction into the SpMV kernel where the operator supports it
        (StencilOperator.matvec_dot).  Falls back to matvec + dot."""
        by_range = self._operators_by_range()
        # Explicit capability query (no exception-based control flow in
        # traced paths): an operator advertises fused SpMV+dot support via
        # ``supports_matvec_dot``.
        fusable = all(
            len(ops) == 1
            and getattr(ops[0][0], "supports_matvec_dot", False)
            and ops[0][1] == rng  # square diagonal block: src space == dst
            for rng, ops in by_range.items()
        ) and len(by_range) == self.num_spaces
        if not fusable:
            self.matvec(dst_idx, src_idx)
            return self.dot(src_idx, dst_idx)
        total = None
        for i in range(self.num_spaces):
            dist, _ = by_range[i][0]
            src = self.get_vector(src_idx, i)
            dst = self.get_vector(dst_idx, i)
            y, part = dist.matvec_dot(src.data)
            dst.data = y
            part = jnp.asarray(part, dtype=self.options.entry_dtype)
            total = part if total is None else total + part
        return Scalar(total)

    # -- reordered-basis solves (parallel/reorder.py) ----------------------
    def to_solver_basis(self) -> None:
        """Enter the RCM basis: permute every materialized vector once and
        flip the reordered operators to their zero-overhead path.  No-op
        when no matrix was reorder-upgraded.  Krylov recurrences are
        invariant under the orthogonal similarity, so residual histories
        and solutions (after :meth:`from_solver_basis`) are unchanged."""
        if not self.basis_perms or self._in_solver_basis:
            return
        self._permute_vectors("perm_dev")
        self._in_solver_basis = True
        self._set_ops_in_basis(True)

    def from_solver_basis(self) -> None:
        if not self.basis_perms or not self._in_solver_basis:
            return
        self._permute_vectors("iperm_dev")
        self._in_solver_basis = False
        self._set_ops_in_basis(False)

    def _permute_vectors(self, key: str) -> None:
        """Permute each space's vectors with THAT SPACE's basis (spaces
        without a basis are untouched — the r4 advisor found the previous
        all-spaces application of the space-0 permutation corrupted or
        crashed multi-space planners)."""
        import jax

        for space, basis in self.basis_perms.items():
            idx = basis[key]
            for vset in [
                self.sol_vectors, self.rhs_vectors, *self.workspace_vectors
            ]:
                v = vset[space]
                if v._data is not None:
                    out = jnp.take(v.data, idx)
                    if v.sharding is not None:
                        # keep the block sharding through the once-per-solve
                        # cross-shard gather (an all-to-all on the mesh)
                        out = jax.lax.with_sharding_constraint(
                            out, v.sharding
                        )
                    v.data = out

    def _set_ops_in_basis(self, flag: bool) -> None:
        for op, _, _ in self.row_partitioned_matrices:
            if hasattr(op, "in_basis"):
                op.in_basis = flag

    # -- functional state for scan-based solver loops ----------------------
    def dump_state(self) -> Dict:
        """Everything a compiled solver loop must carry as ARGUMENTS: the
        vectors, plus each operator's device buffers (ELL slabs, DIA
        coefficients, halo schedules).  Threading the operator buffers keeps
        them out of the compiled program — closed-over concrete arrays
        become HLO constants, which bloats the executable by the matrix
        size."""
        state = {
            "sol": tuple(v.data for v in self.sol_vectors),
            "rhs": tuple(v.data for v in self.rhs_vectors),
            "ops": tuple(
                op.device_state() if hasattr(op, "device_state") else None
                for op, _, _ in self.row_partitioned_matrices
            ),
        }
        for j, ws in enumerate(self.workspace_vectors):
            state[f"ws{j}"] = tuple(v.data for v in ws)
        return state

    def load_state(self, state: Dict) -> None:
        for v, d in zip(self.sol_vectors, state["sol"]):
            v.data = d
        for v, d in zip(self.rhs_vectors, state["rhs"]):
            v.data = d
        for (op, _, _), s in zip(
            self.row_partitioned_matrices, state.get("ops", ())
        ):
            if s is not None:
                op.set_device_state(s)
        for j, ws in enumerate(self.workspace_vectors):
            for v, d in zip(ws, state[f"ws{j}"]):
                v.data = d
