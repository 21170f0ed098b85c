"""Library-wide configuration for legionsolvers_tpu.

JAX analog of the reference's compile-time configuration
(reference: src/LibraryOptions.hpp:10-46).  Where the reference fixes entry
types (f32/f64), index types (s32/u32/s64), a maximum dimensionality, and a
bounds-checking flag at compile time, we express the same policy as explicit
runtime dtype/config objects: every array in the library is created with an
explicit dtype drawn from this module, never from jax defaults.

Entry types are float32 and float64 (the reference's own precision, native
on the GPU; the golden-trajectory tests require exact fp64 integer
arithmetic — reference: test_all.py:130-133); bfloat16 is accepted but
untested.
"""

from __future__ import annotations

import dataclasses
import os

import jax.numpy as jnp

# Entry (matrix/vector element) dtypes supported, mirroring the reference's
# {float, double} entry-type cross product (LibraryOptions.hpp:24-27), plus
# bfloat16.
ENTRY_DTYPES = (jnp.float32, jnp.float64, jnp.bfloat16)

# Index dtypes, mirroring {int32, uint32, int64} (LibraryOptions.hpp:29-33).
# int32 is preferred: half the index bytes.
INDEX_DTYPES = (jnp.int32, jnp.int64)

# Maximum problem dimensionality for stencil generators
# (reference: LEGION_SOLVERS_MAX_DIM, LibraryOptions.hpp:35).
MAX_DIM = 3

# Name of the mesh axis over which vectors/matrices are block-partitioned.
# The reference's single distribution axis is the 1-D color space of vector
# pieces (PartitionedVector.cpp:196-207); ours is this named mesh axis.
SHARD_AXIS = "shard"

# Bounds checking: the reference ties accessor bounds checks to NDEBUG
# (LibraryOptions.hpp:17-21).  We tie host-side partition/index validation to
# this flag; device code is functionally pure so there is nothing to race on.
CHECK_BOUNDS = bool(int(os.environ.get("LEGIONSOLVERS_CHECK_BOUNDS", "1")))


@dataclasses.dataclass(frozen=True)
class SolverOptions:
    """Per-problem dtype/layout policy.

    entry_dtype: dtype of matrix entries and vector elements.
    index_dtype: dtype of all index arrays (rows/cols/halo schedules).
    compensated_dots: carry solver reduction scalars (rho-class dots) as
        two-float (double-float) accumulations — an f32 stand-in for the
        reference's native-f64 reductions (ops/ddsum.py; lowers the f32
        cancellation noise floor by ~2^25 at ~25 flops/element for the
        affected dots).  Honored by ``SquarePlanner.dot`` and the fused
        BiCGStab passes; defaults off because CG/GMRES carry only
        positive-definite sums that do not need it.
    """

    entry_dtype: jnp.dtype = jnp.float32
    index_dtype: jnp.dtype = jnp.int32
    # default_factory so LEGIONSOLVERS_COMPENSATED_DOTS is read when a
    # SolverOptions is CONSTRUCTED, like the per-call env knobs
    # (LEGIONSOLVERS_NO_RCM etc.) — a class-definition-time read silently
    # ignores the env var when it is set after import (r4 advisor finding)
    compensated_dots: bool = dataclasses.field(
        default_factory=lambda: bool(
            int(os.environ.get("LEGIONSOLVERS_COMPENSATED_DOTS", "0"))
        )
    )

    def __post_init__(self) -> None:
        if CHECK_BOUNDS:
            if jnp.dtype(self.entry_dtype) not in [jnp.dtype(d) for d in ENTRY_DTYPES]:
                raise ValueError(f"unsupported entry dtype {self.entry_dtype}")
            if jnp.dtype(self.index_dtype) not in [jnp.dtype(d) for d in INDEX_DTYPES]:
                raise ValueError(f"unsupported index dtype {self.index_dtype}")


DEFAULT_OPTIONS = SolverOptions()


def round_up(x: int, m: int) -> int:
    """Round ``x`` up to the next multiple of ``m``."""
    return -(-x // m) * m
