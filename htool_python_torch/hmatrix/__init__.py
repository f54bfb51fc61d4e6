"""Block plans, generators, assembly and the HMatrix operator."""

from .generator import (
    FunctionGenerator,
    KernelGenerator,
    MatrixGenerator,
    VirtualDenseBlocksGenerator,
    VirtualGenerator,
    VirtualLowRankGenerator,
)
from .hmatrix import HMatrix, HMatrixTreeBuilder
from .lowrank import LowRankMatrix
from .recompression import openmp_recompression, recompression

__all__ = [
    "HMatrix",
    "HMatrixTreeBuilder",
    "LowRankMatrix",
    "VirtualGenerator",
    "VirtualLowRankGenerator",
    "VirtualDenseBlocksGenerator",
    "FunctionGenerator",
    "KernelGenerator",
    "MatrixGenerator",
    "recompression",
    "openmp_recompression",
]
