"""Solvers: Krylov methods (GMRES, CG), HPDDM-style options and the
one-level Schwarz DDM solver (dense and hierarchical local solvers)."""
