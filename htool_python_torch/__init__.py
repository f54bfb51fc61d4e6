"""htool_python_torch — the hierarchical-matrix library on PyTorch and CUDA.

The port of htool_python_tpu (the JAX/Pallas reference, which stays in the
repository unchanged) to PyTorch on an NVIDIA H100.  Cluster trees and
block plans are computed on host (numpy); assembly (batched ACA, QR/SVD
truncation, dense fills, recompression, or the user's own low-rank and
dense-block hooks) runs as batched torch ops on the device; the compressed
product runs hand-written CUDA kernels through ops/cuda_matvec.py on CUDA
tensors — K1 (real f32) and K2 (complex64), one body templated on the
element type in csrc/hmatrix_product.cu (K1-al: K1 on the aligned low-rank
layout, with config.matvec_aligned_layout), and their float64 /
complex128 siblings in csrc/hmatrix_product_f64.cu — and their plain
PyTorch version on CPU tensors.  H-LU / H-Cholesky
(hmatrix/factorization.py, HODLR by randomized peeling in ops/hodlr.py),
distributed operators (parallel/; sharded over processes on
torch.distributed in parallel/sharded.py) and the one- and two-level
(GenEO) Schwarz DDM solver with its dense and hierarchical local solvers
and GMRES / CG (solvers/) run their products through the same kernels.
Entry points run on CUDA unless the caller passes device='cpu'.  Cluster
trees of the built-in policies come from a C++ builder compiled at first
use (csrc/cluster_builder.cpp, native/).  Nothing here imports JAX or the
reference package; the reference's examples run on the port from
htool_python_torch/examples/.

The names mirror the reference's public surface (every subpackage
re-exports the reference's `__all__`; tests/test_torch_surface.py holds
them); `Complex*` aliases are the same classes (dtype is a property of
the data).
"""

from .config import Config, get_config, set_precision

# Clustering
from .clustering.cluster import Cluster, ClusterTreeBuilder
from .clustering.io import read_cluster_from, write_cluster_to
from .clustering.partitioning import (
    BoundingBoxGeometric,
    BoundingBoxRegular,
    PCAGeometric,
    PCARegular,
    VirtualPartitioning,
)

# H-matrix
from .hmatrix.generator import (
    FunctionGenerator,
    KernelGenerator,
    MatrixGenerator,
    VirtualDenseBlocksGenerator,
    VirtualGenerator,
    VirtualLowRankGenerator,
)
from .hmatrix.hmatrix import HMatrix, HMatrixTreeBuilder
from .hmatrix.lowrank import LowRankMatrix
from .hmatrix.recompression import openmp_recompression, recompression

# Distributed operators
from .parallel.builders import (
    CustomApproximationBuilder,
    DefaultApproximationBuilder,
    DefaultLocalApproximationBuilder,
)
from .parallel.distributed_operator import DistributedOperator
from .parallel.local_operator import (
    LocalDenseMatrix,
    LocalHMatrix,
    LocalRenumbering,
    RestrictedGlobalToLocalOperator,
    VirtualLocalToLocalOperator,
)

# Solvers
from .solvers.coarse import (
    GeneoCoarseOperatorBuilder,
    GeneoCoarseSpaceDenseBuilder,
    VirtualGeneoCoarseSpaceBuilder,
    VirtualGeneoCoarseSpaceDenseBuilder,
)
from .solvers.ddm import DDMSolver, DDMSolverBuilder, \
    DDMSolverWithDenseLocalSolver

# Misc
from .utils.logger import logger, test_logger
from .utils.plotting import plot

ComplexVirtualGenerator = VirtualGenerator
ComplexVirtualLowRankGenerator = VirtualLowRankGenerator
ComplexVirtualDenseBlocksGenerator = VirtualDenseBlocksGenerator
ComplexLowRankMatrix = LowRankMatrix
ComplexHMatrix = HMatrix
ComplexHMatrixTreeBuilder = HMatrixTreeBuilder
ComplexVirtualPartitioning = VirtualPartitioning
ComplexDistributedOperator = DistributedOperator
ComplexDefaultApproximationBuilder = DefaultApproximationBuilder
ComplexDefaultLocalApproximationBuilder = DefaultLocalApproximationBuilder
ComplexCustomApproximationBuilder = CustomApproximationBuilder
ComplexRestrictedGlobalToLocalOperator = RestrictedGlobalToLocalOperator
ComplexVirtualLocalToLocalOperator = VirtualLocalToLocalOperator
ComplexDDMSolverBuilder = DDMSolverBuilder
ComplexDDMSolverWithDenseLocalSolver = DDMSolverWithDenseLocalSolver
ComplexGeneoCoarseSpaceDenseBuilder = GeneoCoarseSpaceDenseBuilder
ComplexVirtualGeneoCoarseSpaceDenseBuilder = VirtualGeneoCoarseSpaceDenseBuilder
ComplexVirtualGeneoCoarseSpaceBuilder = VirtualGeneoCoarseSpaceBuilder
ComplexGeneoCoarseOperatorBuilder = GeneoCoarseOperatorBuilder
Solver = DDMSolver
ComplexSolver = DDMSolver

__all__ = [n for n in dir() if not n.startswith("_")]

__version__ = "0.1.0"
