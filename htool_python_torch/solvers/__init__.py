"""Solvers: Krylov methods (GMRES, CG), HPDDM-style options, the
one-level Schwarz DDM solver (dense and hierarchical local solvers) and
its GenEO two-level coarse space."""

from .coarse import (
    GeneoCoarseOperatorBuilder,
    GeneoCoarseSpaceDenseBuilder,
    VirtualGeneoCoarseSpaceBuilder,
    VirtualGeneoCoarseSpaceDenseBuilder,
)
from .ddm import DDMSolver, DDMSolverBuilder, DDMSolverWithDenseLocalSolver
from .krylov import cg, gmres
from .options import parse_hpddm_args

__all__ = [
    "gmres",
    "cg",
    "parse_hpddm_args",
    "DDMSolver",
    "DDMSolverBuilder",
    "DDMSolverWithDenseLocalSolver",
    "GeneoCoarseSpaceDenseBuilder",
    "VirtualGeneoCoarseSpaceDenseBuilder",
    "VirtualGeneoCoarseSpaceBuilder",
    "GeneoCoarseOperatorBuilder",
]
