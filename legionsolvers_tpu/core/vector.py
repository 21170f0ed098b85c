"""Distributed (block-sharded) vectors.

JAX analog of the reference's ``PartitionedVector<T>``
(reference: PartitionedVector.hpp:13-134, PartitionedVector.cpp).  Where the
reference owns a Legion logical region + disjoint/complete index partition and
issues index launches per op, a :class:`PartitionedVector` here owns one
padded ``jax.Array`` sharded block-wise over the solver mesh's shard axis; the
ops delegate to :mod:`legionsolvers_tpu.ops.blas1` and stay fully inside jit
traces (the analog of the reference's never-blocking future discipline).

The object is mutable in the imperative style of the reference API
(``v.axpy(alpha, x)`` rebinds ``v``'s data) *and* a registered pytree, so it
can flow through ``jax.jit`` / ``lax.scan`` as a functional value.  Solver
inner loops use the raw arrays through the planner's functional state.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..options import SHARD_AXIS, SolverOptions, DEFAULT_OPTIONS
from ..ops import blas1
from .partition import BlockPartition
from .scalar import Scalar, alpha_from_scalars

AlphaLike = Union[int, float, jnp.ndarray, Scalar]


def _resolve_alpha(args: Sequence[AlphaLike]) -> jnp.ndarray:
    """Accept either one direct coefficient or the reference's 1-4 scalar
    future-ratio protocol (reference: PartitionedVector.cpp:211-333 passes
    1/2/3 futures to the leaf; get_alpha combines them)."""
    if len(args) == 1 and not isinstance(args[0], Scalar):
        return jnp.asarray(args[0])
    return alpha_from_scalars([a if isinstance(a, Scalar) else Scalar(a) for a in args])


@jax.tree_util.register_pytree_node_class
class PartitionedVector:
    """A named, block-partitioned vector of true length ``n`` stored padded to
    ``partition.padded_size`` with zeros in the padding slots."""

    def __init__(
        self,
        name: str,
        partition: BlockPartition,
        mesh: Optional[Mesh] = None,
        data: Optional[jnp.ndarray] = None,
        options: SolverOptions = DEFAULT_OPTIONS,
        grid_shape: Optional[tuple] = None,
        lazy: bool = False,
    ):
        """``grid_shape``: optional N-D layout for the vector's data.  For
        grid (stencil) problems, storing the vector in its natural grid shape
        — sharded over the leading axis — avoids 1-D<->N-D relayout copies at
        every operator boundary.  Requires prod(grid_shape) ==
        padded_size == n (no padding) and grid_shape[0] divisible by the
        piece count.  All BLAS-1 ops are elementwise, so they are
        shape-agnostic; only fills and host transfers special-case."""
        self.name = name
        self.partition = partition
        self.mesh = mesh
        self.options = options
        if grid_shape is not None:
            grid_shape = tuple(int(d) for d in grid_shape)
            if int(np.prod(grid_shape)) != partition.padded_size:
                raise ValueError("grid_shape must cover padded_size exactly")
            if partition.padded_size != partition.n:
                raise ValueError("grid layout requires an unpadded partition")
            if grid_shape[0] % partition.num_pieces:
                raise ValueError(
                    "grid_shape[0] must be divisible by the piece count"
                )
        self.grid_shape = grid_shape
        if data is None and not lazy:
            shape = grid_shape or (partition.padded_size,)
            data = jnp.zeros(shape, dtype=options.entry_dtype)
            if mesh is not None:
                data = jax.device_put(data, self.sharding)
        self._data = data

    # ``data`` materializes lazily: workspace vectors a solver never
    # touches (e.g. Q on the fused CG path) then cost no device memory —
    # this is what lets the max single-chip problem size match vector-count
    # accounting rather than allocation accounting.
    @property
    def data(self):
        if self._data is None:
            shape = self.grid_shape or (self.partition.padded_size,)
            d = jnp.zeros(shape, dtype=self.options.entry_dtype)
            if self.mesh is not None:
                d = jax.device_put(d, self.sharding)
            self._data = d
        return self._data

    @data.setter
    def data(self, value):
        self._data = value

    # -- pytree protocol ---------------------------------------------------
    def tree_flatten(self):
        return (self.data,), (
            self.name, self.partition, self.mesh, self.options, self.grid_shape,
        )

    @classmethod
    def tree_unflatten(cls, aux, leaves):
        name, partition, mesh, options, grid_shape = aux
        return cls(
            name, partition, mesh=mesh, data=leaves[0], options=options,
            grid_shape=grid_shape,
        )

    # -- construction helpers ----------------------------------------------
    @property
    def n(self) -> int:
        return self.partition.n

    @property
    def sharding(self) -> Optional[NamedSharding]:
        if self.mesh is None:
            return None
        if self.grid_shape is not None:
            spec = P(SHARD_AXIS, *([None] * (len(self.grid_shape) - 1)))
        else:
            spec = P(SHARD_AXIS)
        return NamedSharding(self.mesh, spec)

    def like(self, name: str) -> "PartitionedVector":
        """Fresh zero vector over the same partition/mesh (the analog of
        allocating another field over the same index partition)."""
        return PartitionedVector(
            name, self.partition, mesh=self.mesh, options=self.options,
            grid_shape=self.grid_shape,
        )

    @classmethod
    def from_array(
        cls,
        name: str,
        values: np.ndarray,
        partition: BlockPartition,
        mesh: Optional[Mesh] = None,
        options: SolverOptions = DEFAULT_OPTIONS,
        grid_shape: Optional[tuple] = None,
    ) -> "PartitionedVector":
        """Build from a host array of length ``n`` (pads + shards)."""
        values = np.asarray(values).reshape(-1)
        if values.shape != (partition.n,):
            raise ValueError(f"expected shape ({partition.n},), got {values.shape}")
        padded = np.zeros(partition.padded_size, dtype=options.entry_dtype)
        padded[: partition.n] = values
        v = cls(
            name, partition, mesh=mesh, options=options, grid_shape=grid_shape,
        )
        data = jnp.asarray(padded.reshape(grid_shape) if grid_shape else padded)
        if mesh is not None:
            data = jax.device_put(data, v.sharding)
        v.data = data
        return v

    # -- fills (reference: PartitionedVector.cpp:151-172) -------------------
    def constant_fill(self, value) -> "PartitionedVector":
        if self.grid_shape is not None:  # grid layout has no padding
            self.data = jnp.full_like(self.data, value)
        else:
            self.data = blas1.masked_fill(self.data, value, self.n)
        return self

    def zero_fill(self) -> "PartitionedVector":
        # return to the lazy state: zeros materialize on first read, so a
        # zero_fill followed by a full overwrite allocates nothing
        self._data = None
        return self

    def refill_constant(self, value) -> "PartitionedVector":
        """``constant_fill`` that RELEASES the previous buffer before
        allocating (and never materializes a template): the max-size path's
        fill, where two live copies of a vector would not fit (used by the
        consume-rhs benchmark mode after a solve donated this buffer)."""
        self._data = None
        if self.grid_shape is not None:
            d = jnp.full(self.grid_shape, value, self.options.entry_dtype)
        else:
            idx = jnp.arange(self.partition.padded_size)
            d = jnp.where(idx < self.n, value, 0).astype(
                self.options.entry_dtype
            )
        if self.mesh is not None:
            d = jax.device_put(d, self.sharding)
        self.data = d
        return self

    def random_fill(self, key=None, lo=0.0, hi=1.0) -> "PartitionedVector":
        """Uniform fill (reference: RandomFillTask, UtilityTasks.cpp:128-166)."""
        if key is None:
            key = jax.random.PRNGKey(0)
        vals = jax.random.uniform(
            key, (self.partition.padded_size,), dtype=self.data.dtype,
            minval=lo, maxval=hi,
        )
        mask = jnp.arange(vals.shape[0]) < self.n
        vals = jnp.where(mask, vals, 0)
        if self.grid_shape is not None:
            vals = vals.reshape(self.grid_shape)
        if self.mesh is not None:
            vals = jax.lax.with_sharding_constraint(vals, self.sharding)
        self.data = vals
        return self

    # -- copy (reference: operator=, PartitionedVector.cpp:176-191) ---------
    def assign(self, other: "PartitionedVector") -> "PartitionedVector":
        if other.partition != self.partition:
            raise ValueError("assign requires identical partitions")
        self.data = other.data
        return self

    def copy(self, name: Optional[str] = None) -> "PartitionedVector":
        return PartitionedVector(
            name or self.name,
            self.partition,
            mesh=self.mesh,
            data=self.data,
            options=self.options,
            grid_shape=self.grid_shape,
        )

    # -- BLAS-1 (reference: PartitionedVector.cpp:196-358) ------------------
    def scal(self, *alpha: AlphaLike) -> "PartitionedVector":
        self.data = blas1.scal(_resolve_alpha(alpha), self.data)
        return self

    def axpy(self, *args) -> "PartitionedVector":
        """axpy(alpha..., x): self += alpha * x, where ``alpha...`` is either a
        direct coefficient or 1-3 Scalars under the future-ratio protocol
        (reference: PartitionedVector.cpp:211-284)."""
        *alpha, x = args
        self.data = blas1.axpy(self.data, _resolve_alpha(alpha), x.data)
        return self

    def xpay(self, *args) -> "PartitionedVector":
        """xpay(alpha..., x): self = x + alpha * self
        (reference: PartitionedVector.cpp:288-333)."""
        *alpha, x = args
        self.data = blas1.xpay(self.data, _resolve_alpha(alpha), x.data)
        return self

    def dot(self, other: "PartitionedVector") -> Scalar:
        """<self, other> as a deferred Scalar (reference:
        PartitionedVector.cpp:337-358)."""
        return Scalar(blas1.dot(self.data, other.data))

    def norm2(self) -> Scalar:
        return Scalar(blas1.norm2(self.data))

    # -- materialization ----------------------------------------------------
    def to_numpy(self) -> np.ndarray:
        """Gather the true (unpadded) values to the host, flattened."""
        return np.asarray(self.data).reshape(-1)[: self.n]

    def print(self) -> None:
        """Debug dump (reference: PrintVectorTask path)."""
        print(f"[legionsolvers] vector {self.name}: {self.to_numpy()}")

    def __repr__(self) -> str:
        return (
            f"PartitionedVector({self.name!r}, n={self.n}, "
            f"pieces={self.partition.num_pieces})"
        )
