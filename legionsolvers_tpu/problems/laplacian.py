"""Example-system generators: 1-D negative Laplacian in COO and CSR form.

JAX analog of the reference's ``ExampleSystems``
(reference: ExampleSystems.hpp/.cpp).  The reference index-launches fill
tasks that compute the matrix entries analytically per nonzero; here the same
closed-form fill runs vectorized in numpy on the host (matrix build is a
one-time cost; the arrays then live on device for the life of the solve).

Fill formulas (must match the reference exactly for the golden tests):
nonzero k of the n-point 1-D negative Laplacian (3n-2 nonzeros) has
row = (k+1)//3, col = k - 2*((k+1)//3), entry = +2 if k % 3 == 0 else -1
(reference: ExampleSystems.cpp:311-321), giving tridiag(-1, 2, -1).
The CSR variant stores the same nonzeros row-major with the Rect-style
rowptr (first,last) per row (reference: ExampleSystems.cpp:448-466).
"""

from __future__ import annotations

import numpy as np

from ..core.matrix import COOMatrix, CSRMatrix
from ..options import SolverOptions, DEFAULT_OPTIONS


def laplacian_1d_kernel_size(n: int) -> int:
    """Number of nonzeros (reference: ExampleSystems.hpp:27-31)."""
    return 3 * n - 2


def coo_negative_laplacian_1d(
    n: int, options: SolverOptions = DEFAULT_OPTIONS
) -> COOMatrix:
    """reference: coo_negative_laplacian_1d, ExampleSystems.cpp:12-105 +
    fill body :250-321."""
    k = np.arange(laplacian_1d_kernel_size(n), dtype=np.int64)
    rows = (k + 1) // 3
    cols = k - 2 * ((k + 1) // 3)
    vals = np.where(k % 3 == 0, 2.0, -1.0)
    return COOMatrix(
        rows, cols, vals, n_range=n, n_domain=n,
        name="neg_laplacian_1d_coo", options=options,
    )


def csr_negative_laplacian_1d(
    n: int, options: SolverOptions = DEFAULT_OPTIONS
) -> CSRMatrix:
    """reference: csr_negative_laplacian_1d, ExampleSystems.cpp:108-249 +
    fill bodies :324-470.  Same nonzeros as the COO variant, stored row-major
    (which the COO fill already is: k increments row-major)."""
    coo = coo_negative_laplacian_1d(n, options)
    csr = coo.to_csr()
    csr.name = "neg_laplacian_1d_csr"
    return csr
