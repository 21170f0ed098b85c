"""legionsolvers_tpu — a distributed sparse iterative solver library in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
dzhang314/LegionSolvers (see SURVEY.md): deferred scalars, block-sharded
distributed vectors with BLAS-1 algebra, COO/CSR/stencil sparse operators with
host-computed dependent partitioning and static ppermute halo exchange,
a planner assembling multi-space systems, and CG / BiCGStab / GMRES(m)
solvers compiled into single jitted step functions driven by ``lax.scan``.
"""

from .options import SolverOptions, DEFAULT_OPTIONS, SHARD_AXIS, MAX_DIM
from .core.scalar import Scalar, alpha_from_scalars
from .core.partition import BlockPartition, build_halo_exchange
from .core.vector import PartitionedVector
from .core.matrix import AbstractLinearOperator, AbstractMatrix, COOMatrix, CSRMatrix
from .parallel.mesh import make_mesh, single_device_mesh, num_shards
from .parallel.distmatrix import RowPartitionedMatrix
from .parallel.dia_op import DiaOperator
from .parallel.stencil_op import StencilOperator
from .parallel.winell_op import WinEllOperator
from .parallel.genspmv import GeneralSpmvOperator
from .parallel.reorder import ReorderedOperator
from .parallel.winell_op import SlicedWinEllOperator, WinEllOperator
from .planner import SquarePlanner
from .solvers.cg import CGSolver
from .solvers.bicgstab import BiCGStabSolver
from .solvers.gmres import GMRESSolver
from .problems.laplacian import (
    coo_negative_laplacian_1d,
    csr_negative_laplacian_1d,
    laplacian_1d_kernel_size,
)
from .problems.stencil import (
    calculate_stencil_size,
    create_coo_stencil_matrix,
    create_csr_stencil_matrix,
    create_linearized_csr_stencil_matrix,
    laplacian_stencil,
    stencil_grid_ndim,
)

__version__ = "0.1.0"
from .solvers.pcg import PCGSolver, JacobiPreconditioner
