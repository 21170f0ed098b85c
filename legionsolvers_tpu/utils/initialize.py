"""Library initialization & capability banner.

JAX analog of the reference's ``LegionSolvers::initialize``
(reference: Initialize.cpp:20-487).  The reference's initialize does three
jobs: print a capability banner (:22-66), register the mapper + sharding
functor (:68-75), and statically preregister every task instantiation over
the {entry type} x {index type} x {dim} cross product (:77-486) so launches
can dispatch by deterministic task ID (TaskBaseClasses.hpp:88-122).

On the JAX stack the third job simply does not exist: ``jax.jit``
specializes every op per (dtype, shape, sharding) on first use and caches the
executable — the compile cache *is* the task registry, and the deterministic
"task id" is the jaxpr hash.  The mapper's job is done by the mesh +
NamedSharding annotations (parallel/mesh.py).  What remains useful is the
banner and an optional eager warm-up of the common kernels.
"""

from __future__ import annotations

import sys

import jax

from .. import __version__ as _version
from ..options import ENTRY_DTYPES, INDEX_DTYPES, MAX_DIM

PREFIX = "[LegionSolvers]"


def initialize(print_info: bool = True, verbose: bool = False) -> None:
    """Print the capability banner (reference: Initialize.cpp:22-66).  Safe to
    call multiple times; performs no registration (none is needed — see
    module docstring)."""
    if not print_info:
        return
    devs = jax.devices()
    print(f"{PREFIX} legionsolvers_tpu {_version} on jax {jax.__version__}")
    print(
        f"{PREFIX} backend: {devs[0].platform} with {len(devs)} device(s): "
        + ", ".join(str(d) for d in devs[: 8 if not verbose else None])
    )
    print(
        f"{PREFIX} entry types: "
        + ", ".join(str(jax.numpy.dtype(d)) for d in ENTRY_DTYPES)
        + "; index types: "
        + ", ".join(str(jax.numpy.dtype(d)) for d in INDEX_DTYPES)
        + f"; max stencil dim: {MAX_DIM}"
    )
    if verbose:
        print(f"{PREFIX} x64 enabled: {jax.config.read('jax_enable_x64')}")
        print(f"{PREFIX} default matmul precision: "
              f"{jax.config.jax_default_matmul_precision}", file=sys.stderr)
        import os

        # runtime kill-switches, the analog of the reference's -lg:/-ll:
        # flag tiers (SURVEY §5 "Config / flag system"); each LEGIONSOLVERS_
        # NO_* disables one fast path and falls back to the next-generic one
        switches = (
            "NO_DIA", "NO_RCM", "NO_WINELL", "NO_SLICED_ELL",
            "NO_GENSPMV", "NO_SSTEP", "NO_FUSED_BICGSTAB",
            "NO_BLOCK_FUSED", "NO_DONATE", "NO_NATIVE",
        )
        active = [s for s in switches
                  if os.environ.get(f"LEGIONSOLVERS_{s}")]
        print(f"{PREFIX} kill-switches active: "
              + (", ".join(active) if active else "none")
              + f" (available: {', '.join(switches)})")
