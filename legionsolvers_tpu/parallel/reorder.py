"""Reordered-basis solves: RCM at build time, permutation only at the edges.

The reference never reorders — it hands arbitrary sparsity to cuSPARSE
(reference: CSRMatrixTasks.cu:14-156).  Here *general* sparsity is made
banded at build time instead, so that the banded layouts (DIA, windowed
ELL) apply:

    solve  (P A P^T) (P x) = P b       with P = RCM permutation

Krylov methods are invariant under orthogonal similarity: every dot product,
norm, and recurrence coefficient matches the unpermuted iteration exactly
(up to float summation order), so the residual histories and iteration
counts are unchanged.  The permutation is applied ONCE per solve at the
boundaries (``SquarePlanner.to_solver_basis``/``from_solver_basis`` — a
handful of device gathers amortized over hundreds of iterations), never
inside the hot loop.  This is the standard sparse-solver playbook (PETSc/
hypre apply RCM for bandwidth reduction the same way).

:class:`ReorderedOperator` wraps an operator built on the PERMUTED matrix.
While a solve is in the reordered basis (``in_basis`` set by the planner),
``matvec`` is the base operator's — zero overhead.  Outside a solve (eager
``step()`` driving, debugging) it stays *correct* by permuting per call.
"""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp
import numpy as np


class _PermutedMatrix:
    """Host-side view of A under a permutation of each side: entry (r, c)
    moves to (iperm_row[r], iperm_col[c]).  ``iperm_col`` defaults to
    ``iperm_row`` (the symmetric similarity P A P^T); pass ``None`` for an
    identity on that side (cross-space operators where only one space has a
    solver basis)."""

    _SAME = object()

    def __init__(self, matrix, iperm_row, iperm_col=_SAME):
        if iperm_col is _PermutedMatrix._SAME:
            iperm_col = iperm_row
        rows = np.asarray(matrix.rows, np.int64)
        cols = np.asarray(matrix.cols, np.int64)
        self.rows = rows if iperm_row is None else iperm_row[rows]
        self.cols = cols if iperm_col is None else iperm_col[cols]
        self.vals = matrix.vals
        self.n_domain = matrix.n_domain
        self.n_range = matrix.n_range
        self.n_kernel = matrix.n_kernel


def rcm_reorder(matrix) -> tuple:
    """(permuted_matrix, perm, iperm) with perm from the native RCM kernel;
    perm[i] = original index at reordered position i."""
    from ..native.bindings import rcm_permutation

    n = matrix.n_range
    perm = rcm_permutation(
        n, np.asarray(matrix.rows, np.int64), np.asarray(matrix.cols, np.int64)
    )
    iperm = np.empty(n, np.int64)
    iperm[perm] = np.arange(n)
    return _PermutedMatrix(matrix, iperm), perm, iperm


class ReorderedOperator:
    """A in the original basis, computed by ``base`` in the RCM basis."""

    def __init__(self, base, perm: np.ndarray, iperm: np.ndarray,
                 partition, options):
        self.base = base
        self.partition = partition
        self.options = options
        P = partition.padded_size
        n = len(perm)
        tail = np.arange(n, P, dtype=np.int64)
        idt = np.int32 if P <= np.iinfo(np.int32).max else np.int64
        self.perm_np = perm
        self.perm_dev = jnp.asarray(np.concatenate([perm, tail]).astype(idt))
        self.iperm_dev = jnp.asarray(np.concatenate([iperm, tail]).astype(idt))
        self.in_basis = False  # toggled by SquarePlanner.to_solver_basis

    # ------------------------------------------------------------------
    @property
    def n_domain(self) -> int:
        return self.base.n_domain

    @property
    def n_range(self) -> int:
        return self.base.n_range

    def nnz(self) -> int:
        return self.base.nnz()


    @property
    def supports_matvec_dot(self) -> bool:
        return getattr(self.base, "supports_matvec_dot", False)

    # ------------------------------------------------------------------
    def device_state(self):
        base_state = (
            self.base.device_state()
            if hasattr(self.base, "device_state")
            else None
        )
        return (base_state, self.perm_dev, self.iperm_dev)

    def set_device_state(self, state) -> None:
        base_state, self.perm_dev, self.iperm_dev = state
        if base_state is not None:
            self.base.set_device_state(base_state)

    # ------------------------------------------------------------------
    def matvec(self, x: jnp.ndarray) -> jnp.ndarray:
        if self.in_basis:
            return self.base.matvec(x)
        py = self.base.matvec(jnp.take(x, self.perm_dev))
        return jnp.take(py, self.iperm_dev)

    def matvec_add(self, y: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
        return y + self.matvec(x)

    def matvec_dot(self, x: jnp.ndarray):
        if self.in_basis:
            return self.base.matvec_dot(x)
        py, d = self.base.matvec_dot(jnp.take(x, self.perm_dev))
        return jnp.take(py, self.iperm_dev), d

    def rmatvec(self, x: jnp.ndarray) -> jnp.ndarray:
        if self.in_basis:
            return self.base.rmatvec(x)
        py = self.base.rmatvec(jnp.take(x, self.perm_dev))
        return jnp.take(py, self.iperm_dev)


def try_reordered_operator(
    matrix, partition, options, perm: Optional[np.ndarray] = None,
    mesh=None, force: bool = False,
) -> Optional[ReorderedOperator]:
    """Build the best reordered operator for an explicit matrix that failed
    the direct DIA gate, or None when reordering doesn't help.

    Order of preference on the permuted matrix: DIA (banded after RCM —
    streaming-speed kernel), then windowed ELL (scattered within the band;
    single-piece :class:`~.winell_op.WinEllOperator`, or the sharded
    windowed plans inside
    :class:`~legionsolvers_tpu.parallel.distmatrix.RowPartitionedMatrix`).
    ``perm`` forces a specific permutation (planner consistency when several
    matrices must share one basis).  ``force=True`` (requires ``perm``)
    never returns None: a matrix that has no fast kernel in the given basis
    still comes back as a ReorderedOperator over the generic gather-ELL
    ``RowPartitionedMatrix`` of the permuted matrix — registering it in the
    ORIGINAL basis instead would silently corrupt results once the planner
    permutes the space's vectors (r4 advisor finding)."""
    if not force:
        if partition.num_pieces > 1 and mesh is None:
            return None
        if matrix.n_domain != matrix.n_range:
            return None
    n = matrix.n_range
    if not force and n < 1024:
        return None  # the XLA fallback is fine at toy sizes
    if perm is None:
        pm, perm, iperm = rcm_reorder(matrix)
    else:
        iperm = np.empty(n, np.int64)
        iperm[perm] = np.arange(n)
        pm = _PermutedMatrix(matrix, iperm)

    base = None
    from .dia_op import MAX_DIAGONALS, MIN_DIA_FILL, DiaOperator
    from ..native import bindings as native

    uoffs = native.dia_unique_offsets(pm.rows, pm.cols, MAX_DIAGONALS)
    if (
        uoffs is not None
        and pm.n_kernel >= MIN_DIA_FILL * len(uoffs) * partition.padded_size
    ):
        base = DiaOperator(pm, partition=partition, mesh=mesh,
                           options=options)
    if base is None and partition.num_pieces == 1:
        from .winell_op import (
            SlicedWinEllOperator,
            WinEllOperator,
            plan_winell,
            plan_winell_classes,
        )

        # sliced-ELL per-degree-class plans: kill the uniform-L padding on
        # irregular-row matrices; fall back to the classic uniform plan
        # when one class suffices or slicing is ineligible
        import os as _os2

        planc = None
        if not _os2.environ.get("LEGIONSOLVERS_NO_SLICED_ELL"):
            planc = plan_winell_classes(
                pm.rows, pm.cols, np.asarray(pm.vals), n,
                partition.padded_size, np.dtype(options.entry_dtype),
            )
        if planc is not None and "classes" in planc:
            base = SlicedWinEllOperator(pm, partition, options, plan=planc)
        elif planc is not None:
            base = WinEllOperator(pm, partition, options, plan=planc)
        else:
            plan = plan_winell(
                pm.rows, pm.cols, np.asarray(pm.vals), n,
                partition.padded_size, np.dtype(options.entry_dtype),
            )
            if plan is not None:
                base = WinEllOperator(pm, partition, options, plan=plan)
    if base is None and partition.num_pieces == 1:
        # RCM could not band this matrix: the routed-gather pipeline
        # (parallel/genspmv.py) is pattern-agnostic like the reference's
        # cuSPARSE (CSRMatrixTasks.cu:14-156).  With a free basis choice
        # it prefers its own DEGREE-SORTED order (tight SELL tiles ~2.3x
        # fewer slots than arrival order); under a forced shared basis it
        # builds on the given permutation.
        import os as _os

        if not _os.environ.get("LEGIONSOLVERS_NO_GENSPMV"):
            from .genspmv import GeneralSpmvOperator, degree_sort_perm

            if not force:
                dperm = degree_sort_perm(matrix)
                diperm = np.empty(n, np.int64)
                diperm[dperm] = np.arange(n)
                try:
                    base_d = GeneralSpmvOperator(
                        _PermutedMatrix(matrix, diperm), partition, options
                    )
                    return ReorderedOperator(
                        base_d, dperm, diperm, partition, options
                    )
                except ValueError:
                    pass  # no feasible routing geometry (tiny/degenerate)
            else:
                try:
                    base = GeneralSpmvOperator(pm, partition, options)
                except ValueError:
                    pass
    if base is None and partition.num_pieces > 1:
        from .distmatrix import RowPartitionedMatrix

        rpm = RowPartitionedMatrix(
            pm, domain_partition=partition, range_partition=partition,
            mesh=mesh, options=options,
        )
        # only worth the basis machinery if the windowed plan succeeded
        # (otherwise the un-permuted gather-ELL is the same speed) —
        # unless the basis already exists and the operator MUST adopt it
        if rpm._win is not None or force:
            base = rpm
    if base is None and force:
        from .distmatrix import RowPartitionedMatrix

        base = RowPartitionedMatrix(
            pm, domain_partition=partition, range_partition=partition,
            mesh=mesh, options=options,
        )
    if base is None:
        return None
    return ReorderedOperator(base, perm, iperm, partition, options)


class CrossBasisOperator:
    """Rectangular / cross-space operator expressed in per-space solver
    bases (identity on any side without a basis).

    Built by the planner when a matrix spanning two spaces arrives after
    one of them adopted an RCM basis: the round-4 advisor found that
    silently registering such a matrix in the ORIGINAL basis corrupts
    results the moment ``to_solver_basis`` permutes the space's vectors.
    ``base`` is an operator over the two-sided-permuted matrix; outside the
    basis every call permutes at the edges (debug/eager path only)."""

    supports_matvec_dot = False

    def __init__(self, base, dom_basis, rng_basis, dom_padded, rng_padded):
        self.base = base
        self.in_basis = False

        def pad_pair(basis, P):
            if basis is None:
                return None, None
            n = len(basis["perm_np"])
            tail = np.arange(n, P, dtype=np.int64)
            idt = np.int32 if P <= np.iinfo(np.int32).max else np.int64
            return (
                jnp.asarray(
                    np.concatenate([basis["perm_np"], tail]).astype(idt)
                ),
                jnp.asarray(
                    np.concatenate([basis["iperm_np"], tail]).astype(idt)
                ),
            )

        self.dom_perm_dev, self.dom_iperm_dev = pad_pair(dom_basis, dom_padded)
        self.rng_perm_dev, self.rng_iperm_dev = pad_pair(rng_basis, rng_padded)

    @property
    def n_domain(self) -> int:
        return self.base.n_domain

    @property
    def n_range(self) -> int:
        return self.base.n_range

    def nnz(self) -> int:
        return self.base.nnz()


    def device_state(self):
        base_state = (
            self.base.device_state()
            if hasattr(self.base, "device_state")
            else None
        )
        return (base_state, self.dom_perm_dev, self.dom_iperm_dev,
                self.rng_perm_dev, self.rng_iperm_dev)

    def set_device_state(self, state) -> None:
        (base_state, self.dom_perm_dev, self.dom_iperm_dev,
         self.rng_perm_dev, self.rng_iperm_dev) = state
        if base_state is not None:
            self.base.set_device_state(base_state)

    @staticmethod
    def _gather(x, idx):
        return x if idx is None else jnp.take(x, idx)

    def matvec(self, x: jnp.ndarray) -> jnp.ndarray:
        if self.in_basis:
            return self.base.matvec(x)
        py = self.base.matvec(self._gather(x, self.dom_perm_dev))
        return self._gather(py, self.rng_iperm_dev)

    def matvec_add(self, y: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
        return y + self.matvec(x)

    def rmatvec(self, x: jnp.ndarray) -> jnp.ndarray:
        if self.in_basis:
            return self.base.rmatvec(x)
        py = self.base.rmatvec(self._gather(x, self.rng_perm_dev))
        return self._gather(py, self.dom_iperm_dev)


def cross_basis_operator(
    matrix, dom_partition, rng_partition, dom_basis, rng_basis, mesh, options
) -> CrossBasisOperator:
    """Wrap ``matrix`` (spanning two planner spaces) so it computes in the
    spaces' solver bases; ``dom_basis``/``rng_basis`` are the planner's
    per-space basis dicts (or None for identity)."""
    from .distmatrix import RowPartitionedMatrix

    pm = _PermutedMatrix(
        matrix,
        rng_basis["iperm_np"] if rng_basis else None,
        dom_basis["iperm_np"] if dom_basis else None,
    )
    base = RowPartitionedMatrix(
        pm, domain_partition=dom_partition, range_partition=rng_partition,
        mesh=mesh, options=options,
    )
    return CrossBasisOperator(
        base, dom_basis, rng_basis,
        dom_partition.padded_size, rng_partition.padded_size,
    )
