"""Solvers: Krylov methods (GMRES, CG), HPDDM-style options, the
one-level Schwarz DDM solver (dense and hierarchical local solvers) and
its GenEO two-level coarse space."""
