"""Native host-side runtime components (C++ via ctypes).

The device compute path is JAX/XLA/Pallas; this package is the native runtime
*around* it — the analog of the reference's C++ fill tasks and dependent
partitioning (reference: StencilGenerator.cpp, ExampleSystems.cpp:250-470,
COOMatrix.cpp:57-141).  The shared library is built on first use with the
system compiler and cached next to the sources; every entry point has a
pure-numpy fallback, so the library degrades gracefully on hosts without a
toolchain.
"""

from .bindings import (
    available,
    build_indptr,
    pack_ell_shard,
    rcm_permutation,
    shard_halo_columns,
    stencil_fill_coo,
    stencil_size,
)
