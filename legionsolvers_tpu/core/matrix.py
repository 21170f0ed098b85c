"""Sparse matrix operators: abstract interface + COO and CSR containers.

JAX analog of the reference's operator hierarchy
(reference: AbstractLinearOperator.hpp:9-22, AbstractMatrix.hpp:14-59,
COOMatrix.cpp, CSRMatrix.cpp).  The reference keeps matrices in Legion
regions and derives kernel/ghost partitions at runtime with dependent
partitioning; here matrices are built on the host (numpy) once, mirrored to
device arrays, and the partition derivations are explicit index-set
computations (``core/partition.py``) used both for the distributed operator
build and for the golden partition tests.

CSR parity note: the reference's rowptr region stores one ``Rect<1>`` per row
(first/last kernel index — CSRMatrix.hpp:22-23), not a classical indptr
array, because Legion's ``image_range`` wants rectangles.  We store classical
``indptr`` and expose :meth:`CSRMatrix.row_rects` for golden-test parity.
"""

from __future__ import annotations

import abc
from typing import List, Optional, Sequence

import jax.numpy as jnp
import numpy as np

from ..options import SolverOptions, DEFAULT_OPTIONS
from . import partition as pt
from .partition import BlockPartition


class AbstractLinearOperator(abc.ABC):
    """Minimal operator interface (reference: AbstractLinearOperator.hpp:9-22):
    domain/range extents plus the two partition derivations."""

    @property
    @abc.abstractmethod
    def n_domain(self) -> int: ...

    @property
    @abc.abstractmethod
    def n_range(self) -> int: ...

    @abc.abstractmethod
    def apply(self, x: jnp.ndarray) -> jnp.ndarray:
        """y = A @ x on global (possibly padded) arrays."""

    def apply_add(self, y: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
        """y += A @ x (planner accumulation form)."""
        return y + self.apply(x)


class AbstractMatrix(AbstractLinearOperator):
    """An explicit sparse matrix with a kernel (nonzero) space, supporting the
    four partition derivations (reference: AbstractMatrix.hpp:23-59)."""

    # Subclasses provide .rows / .cols host arrays over the kernel space.
    rows: np.ndarray
    cols: np.ndarray

    @property
    def n_kernel(self) -> int:
        return len(self.rows)

    # -- dependent-partition derivations (host, numpy) ---------------------
    def kernel_partition_from_range_partition(
        self, range_partition: BlockPartition
    ) -> List[np.ndarray]:
        """reference: preimage on row field, COOMatrix.cpp:77-95."""
        return pt.kernel_partition_from_range(self.rows, range_partition)

    def kernel_partition_from_domain_partition(
        self, domain_partition: BlockPartition
    ) -> List[np.ndarray]:
        """reference: preimage on col field, COOMatrix.cpp:57-74."""
        return pt.kernel_partition_from_domain(self.cols, domain_partition)

    def domain_partition_from_kernel_partition(
        self, kernel_partition: Sequence[np.ndarray]
    ) -> List[np.ndarray]:
        """reference: image on col field, COOMatrix.cpp:98-118 (the ghost
        partition)."""
        return pt.domain_partition_from_kernel(self.cols, kernel_partition)

    def range_partition_from_kernel_partition(
        self, kernel_partition: Sequence[np.ndarray]
    ) -> List[np.ndarray]:
        """reference: image on row field, COOMatrix.cpp:121-141."""
        return pt.range_partition_from_kernel(self.rows, kernel_partition)

    def domain_partition_from_range_partition(
        self, range_partition: BlockPartition
    ) -> List[np.ndarray]:
        """Composition, as in the reference's default implementation
        (AbstractMatrix.cpp:8-29)."""
        return self.domain_partition_from_kernel_partition(
            self.kernel_partition_from_range_partition(range_partition)
        )

    def to_dense(self) -> np.ndarray:
        """Host-side densification (tests only)."""
        A = np.zeros((self.n_range, self.n_domain))
        np.add.at(A, (self.rows, self.cols), np.asarray(self.vals, dtype=np.float64))
        return A


class COOMatrix(AbstractMatrix):
    """Coordinate-format sparse operator (reference: COOMatrix.hpp/.cpp).

    Host arrays (rows, cols, vals) are the kernel region's three fields
    (COOMatrix.hpp:17-20); device mirrors are created lazily per dtype.
    """

    def __init__(
        self,
        rows: np.ndarray,
        cols: np.ndarray,
        vals: np.ndarray,
        n_range: int,
        n_domain: int,
        name: str = "coo",
        options: SolverOptions = DEFAULT_OPTIONS,
    ):
        self.rows = np.asarray(rows, dtype=np.int64)
        self.cols = np.asarray(cols, dtype=np.int64)
        self.vals = np.asarray(vals)
        self._n_range = int(n_range)
        self._n_domain = int(n_domain)
        self.name = name
        self.options = options
        if not (len(self.rows) == len(self.cols) == len(self.vals)):
            raise ValueError("rows/cols/vals length mismatch")
        if len(self.rows) and (
            self.rows.min() < 0
            or self.rows.max() >= n_range
            or self.cols.min() < 0
            or self.cols.max() >= n_domain
        ):
            raise ValueError("COO indices out of bounds")
        self._dev = None

    @property
    def n_domain(self) -> int:
        return self._n_domain

    @property
    def n_range(self) -> int:
        return self._n_range

    def device_arrays(self):
        if self._dev is None:
            o = self.options
            self._dev = (
                jnp.asarray(self.rows, dtype=o.index_dtype),
                jnp.asarray(self.cols, dtype=o.index_dtype),
                jnp.asarray(self.vals, dtype=o.entry_dtype),
            )
        return self._dev

    def apply(self, x: jnp.ndarray) -> jnp.ndarray:
        from ..ops.spmv import spmv_coo

        rows, cols, vals = self.device_arrays()
        y = spmv_coo(rows, cols, vals, x[: self.n_domain], self.n_range)
        if x.shape[0] > self.n_domain:  # keep padded layout
            y = jnp.zeros(x.shape[0], dtype=y.dtype).at[: self.n_range].set(y)
        return y

    def rmatvec(self, x: jnp.ndarray) -> jnp.ndarray:
        """A^T @ x — implemented for real (the reference stubs it:
        COOMatrixTasks.cpp:78-83)."""
        from ..ops.spmv import rmatvec_coo

        rows, cols, vals = self.device_arrays()
        y = rmatvec_coo(rows, cols, vals, x[: self.n_range], self.n_domain)
        if x.shape[0] > self.n_range:
            y = jnp.zeros(x.shape[0], dtype=y.dtype).at[: self.n_domain].set(y)
        return y

    def to_csr(self) -> "CSRMatrix":
        order = np.lexsort((self.cols, self.rows))
        rows, cols, vals = self.rows[order], self.cols[order], self.vals[order]
        indptr = np.zeros(self.n_range + 1, dtype=np.int64)
        np.add.at(indptr, rows + 1, 1)
        indptr = np.cumsum(indptr)
        return CSRMatrix(
            indptr, cols, vals, self.n_range, self.n_domain,
            name=self.name + "_csr", options=self.options,
        )

    def print(self) -> None:
        """Debug dump (reference: COOPrintTask, COOMatrixTasks.cpp:86-127)."""
        for k in range(self.n_kernel):
            print(f"{self.name} [{self.rows[k]}, {self.cols[k]}]: {self.vals[k]}")


class CSRMatrix(AbstractMatrix):
    """Compressed-sparse-row operator (reference: CSRMatrix.hpp/.cpp)."""

    def __init__(
        self,
        indptr: np.ndarray,
        cols: np.ndarray,
        vals: np.ndarray,
        n_range: int,
        n_domain: int,
        name: str = "csr",
        options: SolverOptions = DEFAULT_OPTIONS,
    ):
        self.indptr = np.asarray(indptr, dtype=np.int64)
        self.cols = np.asarray(cols, dtype=np.int64)
        self.vals = np.asarray(vals)
        self._n_range = int(n_range)
        self._n_domain = int(n_domain)
        self.name = name
        self.options = options
        if self.indptr.shape != (n_range + 1,):
            raise ValueError("indptr must have length n_range + 1")
        if self.indptr[0] != 0 or self.indptr[-1] != len(self.cols):
            raise ValueError("malformed indptr")
        # Expanded row array over the kernel space: gives CSR the same
        # derivation machinery as COO (the reference instead partitions the
        # rowptr region by image_range/preimage_range, CSRMatrix.cpp:89-155 —
        # semantically identical for contiguous row blocks).
        self.rows = np.repeat(
            np.arange(n_range, dtype=np.int64), np.diff(self.indptr)
        )
        self._dev = None

    @property
    def n_domain(self) -> int:
        return self._n_domain

    @property
    def n_range(self) -> int:
        return self._n_range

    def row_rects(self) -> np.ndarray:
        """[n_range, 2] array of (first, last) kernel index per row — the
        reference's Rect-valued rowptr field (CSRMatrix.hpp:22-23).  Rows with
        no nonzeros get the empty rect (lo, lo-1)."""
        lo = self.indptr[:-1]
        hi = self.indptr[1:] - 1
        return np.stack([lo, hi], axis=1)

    def device_arrays(self):
        if self._dev is None:
            o = self.options
            self._dev = (
                jnp.asarray(self.rows, dtype=o.index_dtype),
                jnp.asarray(self.cols, dtype=o.index_dtype),
                jnp.asarray(self.vals, dtype=o.entry_dtype),
            )
        return self._dev

    def apply(self, x: jnp.ndarray) -> jnp.ndarray:
        from ..ops.spmv import spmv_coo

        rows, cols, vals = self.device_arrays()
        y = spmv_coo(rows, cols, vals, x[: self.n_domain], self.n_range)
        if x.shape[0] > self.n_domain:
            y = jnp.zeros(x.shape[0], dtype=y.dtype).at[: self.n_range].set(y)
        return y

    def rmatvec(self, x: jnp.ndarray) -> jnp.ndarray:
        """A^T @ x (reference stub: CSRMatrixTasks.cpp:95-100)."""
        from ..ops.spmv import rmatvec_coo

        rows, cols, vals = self.device_arrays()
        y = rmatvec_coo(rows, cols, vals, x[: self.n_range], self.n_domain)
        if x.shape[0] > self.n_range:
            y = jnp.zeros(x.shape[0], dtype=y.dtype).at[: self.n_domain].set(y)
        return y

    def to_ell(self):
        """Pad rows to the max row length -> (ell_cols, ell_vals) host arrays;
        padded slots carry value 0 and column 0."""
        counts = np.diff(self.indptr)
        L = int(counts.max(initial=0))
        n = self.n_range
        ell_cols = np.zeros((n, L), dtype=np.int64)
        ell_vals = np.zeros((n, L), dtype=self.vals.dtype)
        slot = (
            np.arange(len(self.cols), dtype=np.int64)
            - self.indptr[:-1].repeat(counts)
        )
        ell_cols[self.rows, slot] = self.cols
        ell_vals[self.rows, slot] = self.vals
        return ell_cols, ell_vals

    def print(self) -> None:
        """Debug dump (reference: CSRPrintTask, CSRMatrixTasks.cpp:103-160)."""
        for i in range(self.n_range):
            for k in range(self.indptr[i], self.indptr[i + 1]):
                print(f"{self.name} [{i}, {self.cols[k]}]: {self.vals[k]}")
