"""BLAS-1 kernels over padded, block-sharded 1-D arrays.

JAX analog of the reference's ``LinearAlgebraTasks`` leaf tasks
(reference: LinearAlgebraTasks.hpp:11-52, LinearAlgebraTasks.cpp:16-175 CPU;
LinearAlgebraTasks.cu:15-238 cuBLAS).  Where the reference index-launches one
leaf task per vector piece, here each op is a plain jnp expression over a
``NamedSharding``-annotated array: XLA's SPMD partitioner splits it per shard
(the "index launch"), fuses neighboring elementwise ops into one kernel (the
analog of Legion tracing amortization), and inserts the cross-shard psum for
``dot`` (the analog of the ``LEGION_REDOP_SUM`` future reduction,
PartitionedVector.cpp:337-358).

All arrays carry the invariant that padding slots (``index >= n``) are zero,
so ``dot`` needs no masking and scal/axpy/xpay preserve the invariant for
free (0 + alpha*0 == 0).  Only fills must mask (see ``masked_fill``).

Coefficients ``alpha`` may be python numbers, 0-d arrays, or the reference's
future-ratio tuples via :func:`~legionsolvers_tpu.core.scalar.alpha_from_scalars`.
"""

from __future__ import annotations

import jax.numpy as jnp


def scal(alpha, x: jnp.ndarray) -> jnp.ndarray:
    """x <- alpha * x   (reference: ScalTask, LinearAlgebraTasks.cpp:16-55)."""
    return jnp.asarray(alpha, dtype=x.dtype) * x


def axpy(y: jnp.ndarray, alpha, x: jnp.ndarray) -> jnp.ndarray:
    """y <- alpha * x + y   (reference: AxpyTask, LinearAlgebraTasks.cpp:58-100)."""
    return jnp.asarray(alpha, dtype=y.dtype) * x + y


def xpay(y: jnp.ndarray, alpha, x: jnp.ndarray) -> jnp.ndarray:
    """y <- x + alpha * y   (reference: XpayTask, LinearAlgebraTasks.cpp:103-144)."""
    return x + jnp.asarray(alpha, dtype=y.dtype) * y


def dot(x: jnp.ndarray, y: jnp.ndarray) -> jnp.ndarray:
    """Return <x, y> as a 0-d array (reference: DotTask + future sum-reduction,
    LinearAlgebraTasks.cpp:147-175, PartitionedVector.cpp:337-358).  Under
    SPMD this lowers to per-shard partial dots + an all-reduce.
    Shape-agnostic (vectors may be stored in grid layout)."""
    return jnp.sum(x * y, dtype=x.dtype)


def norm2(x: jnp.ndarray) -> jnp.ndarray:
    """||x||^2 — the solvers' residual tracker."""
    return dot(x, x)


def masked_fill(template: jnp.ndarray, value, n: int) -> jnp.ndarray:
    """Constant-fill the first ``n`` slots, zero the padding (reference:
    IndexFillLauncher path, PartitionedVector.cpp:151-172).  ``template``
    supplies shape/dtype/sharding."""
    idx = jnp.arange(template.shape[0])
    return jnp.where(
        idx < n,
        jnp.asarray(value, dtype=template.dtype),
        jnp.zeros((), dtype=template.dtype),
    )
