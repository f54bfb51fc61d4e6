"""The port's GenEO two-level coarse space (solvers/coarse.py and
`DDMSolver.build_coarse_space`) against the reference's, on the CPU in
float64 (golden data, N = 400, data/htool_generated_data).

* The GenEO rows of the reference's table (tests/test_ddm_solver.py:
  124-135) on the reference's own operator, carried over with `interop`:
  in the `DDMWithHMatrixPlusOverlap` rows both packages hold the same
  operator, block diagonal and dense subdomains, so the iteration counts
  equal the reference's, the solutions agree to 1e-10, and so do the
  coarse operators Z E^-1 Z^T (Z's columns are fixed only up to sign and
  order; the coarse operator is not); in the `DDMWithHMatrix` rows each
  package assembles its own local H-matrices, and the port meets the
  reference's contract (GMRES to 1e-6, solution within 10 eps of
  sol.bin).
* The same nine rows on the port's own assembly: the reference's
  contract.
* E = Z^T A Z: the device route (64-column chunks) against
  `matvec_global`, the host route of custom Python operators and the
  reference's E, to 1e-12.
"""

import copy
import types

import jax
import numpy as np
import pytest
import scipy.linalg as sla
import torch

import htool_python_torch as T
import htool_python_tpu as H
from conftest import GeneratorFromMatrix
from htool_python_torch import interop
from htool_python_torch.parallel.builders import PerPartition, \
    _extract_block_diagonal
from test_torch_complex import one_thread  # noqa: F401
from test_torch_ddm import (_EPS, _TOL, PortMatrixGenerator, _builder,
                            _port_cluster, _Rows, _solve)


class PortCustomDenseGeneoBuilder(T.VirtualGeneoCoarseSpaceDenseBuilder):
    """The reference test's user dense GenEO hook
    (tests/test_ddm_solver.py CustomDenseGeneoBuilder), on the port."""

    def compute_coarse_space(self, Ai, Bi):
        w, v = sla.eigh(Ai, Bi)
        idx = w.argsort()[::-1]
        if self.geneo_threshold > 0:
            nb_eig = int((w > self.geneo_threshold).sum())
        else:
            nb_eig = self.geneo_nu
        self.set_coarse_space(v[:, idx[:nb_eig]].real)


class PortCustomMatrixFreeGeneoBuilder(T.VirtualGeneoCoarseSpaceBuilder):
    """The reference test's matrix-free hook (CustomMatrixFreeGeneoBuilder):
    the callback applied to the identity gives DAiD."""

    def __init__(self, size_wo, size_with, Ai, Bi, geneo_nu=-1,
                 geneo_threshold=-1.0):
        super().__init__(size_wo, size_with, Ai, geneo_nu=geneo_nu,
                         geneo_threshold=geneo_threshold)
        self.Bi = np.asarray(Bi).real

    def compute_coarse_space(self, hmatrix_callback):
        m = self.size_with_overlap
        DAiD = np.stack([hmatrix_callback(e) for e in np.eye(m)], axis=1)
        DAiD = 0.5 * (DAiD + DAiD.T)
        w, v = sla.eigh(DAiD, self.Bi)
        idx = w.argsort()[::-1]
        nb_eig = (int((w > self.geneo_threshold).sum())
                  if self.geneo_threshold > 0 else self.geneo_nu)
        self.set_coarse_space(v[:, idx[:nb_eig]])


def _space_builders(pkg, geneo_type, diag, c2o, ovr, Ki, symmetry, UPLO,
                    local_h=None):
    """One builder per partition, as the reference test makes them."""
    if pkg is H:
        from test_ddm_solver import (CustomDenseGeneoBuilder,
                                     CustomMatrixFreeGeneoBuilder)
        dense_cls, free_cls = (CustomDenseGeneoBuilder,
                               CustomMatrixFreeGeneoBuilder)
    else:
        dense_cls, free_cls = (PortCustomDenseGeneoBuilder,
                               PortCustomMatrixFreeGeneoBuilder)
    out = []
    for p in range(len(ovr)):
        wo, wth, bd = len(c2o[p]), len(ovr[p]), diag[p]
        if geneo_type == "geneo_nu":
            sb = pkg.GeneoCoarseSpaceDenseBuilder(wo, wth, bd, Ki[p],
                                                  symmetry, UPLO, geneo_nu=2)
        elif geneo_type == "geneo_threshold":
            sb = pkg.GeneoCoarseSpaceDenseBuilder(
                wo, wth, bd, Ki[p], symmetry, UPLO, geneo_threshold=0.1)
        elif geneo_type == "custom_dense_geneo_nu":
            sb = dense_cls(wo, wth, bd.to_dense(), Ki[p], symmetry, UPLO,
                           geneo_nu=2)
        elif geneo_type == "custom_dense_geneo_threshold":
            sb = dense_cls(wo, wth, bd.to_dense(), Ki[p], symmetry, UPLO,
                           geneo_threshold=0.1)
        else:
            assert geneo_type == "custom_geneo_nu"
            sb = free_cls(wo, wth, (local_h or diag)[p], Ki[p], geneo_nu=2)
        out.append(sb)
    return out


def _reference(A, ref_cluster, symmetry, UPLO):
    """The reference's DefaultApproximationBuilder on the golden matrix,
    recompressed as the reference test does."""
    ref = H.DefaultApproximationBuilder(
        GeneratorFromMatrix(A), ref_cluster, ref_cluster,
        H.HMatrixTreeBuilder(_EPS, 10, symmetry, UPLO), None)
    H.recompression(ref.hmatrix)
    return ref


def _carried(ref, golden_data_root, symmetry, n_partitions):
    """(distributed operator, block diagonal) of the port holding the
    reference's block rows."""
    cluster = _port_cluster(golden_data_root, symmetry, n_partitions)
    op = interop.distributed_from_reference(
        cluster, cluster,
        [(h.plan, jax.tree_util.tree_map(np.asarray, h._data), h._lr_ranks,
          h.epsilon) for h in ref.hmatrix], "cpu")
    diag = PerPartition(_extract_block_diagonal(
        op._global_to_local[p][0].hmatrix, cluster, cluster, p)
        for p in range(n_partitions))
    return op, diag


def _two_level(solver, builders, operator_builder, f, symmetry, schwarz):
    """The reference test's order: the coarse space, the option, then the
    one-level factorization and the solve."""
    solver.build_coarse_space(builders, operator_builder)
    return _solve(solver, f, symmetry, schwarz, coarse_correction="additive")


def _coarse_operator(solver, pkg):
    """Z E^-1 Z^T of a solver's coarse state, as numpy."""
    if pkg is H:
        Z, E_lu = solver._coarse
        return Z @ sla.lu_solve(E_lu, Z.conj().T)
    Z, (lu, piv) = solver._coarse
    return (Z @ torch.linalg.lu_solve(lu, piv, Z.conj().T)).numpy()


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize(
    "mu,symmetry,schwarz,geneo_type,n_partitions",
    [(1, "S", "asm", "geneo_nu", 2),
     (1, "S", "ras", "geneo_nu", 2),
     (10, "S", "ras", "geneo_nu", 2),
     (1, "S", "ras", "geneo_threshold", 2),
     (1, "S", "asm", "custom_dense_geneo_nu", 2),
     (1, "S", "ras", "custom_dense_geneo_threshold", 2),
     (1, "S", "asm", "geneo_nu", 4)])
def test_overlap_rows_equal_reference(load_data_solver, golden_data_root, mu,
                                      symmetry, schwarz, geneo_type,
                                      n_partitions):
    [A, x_sol, f, _, ref_cluster, neighbors, intersections, symmetry, UPLO,
     c2o, ovr, Ki] = load_data_solver
    ref = _reference(A, ref_cluster, symmetry, UPLO)
    ref_solver = H.DDMSolverBuilder(
        ref.distributed_operator, copy.deepcopy(ref.block_diagonal_hmatrix),
        GeneratorFromMatrix(A), ovr, c2o, neighbors, intersections).solver
    x_ref = _two_level(
        ref_solver, _space_builders(H, geneo_type, ref.block_diagonal_hmatrix,
                                    c2o, ovr, Ki, symmetry, UPLO),
        H.GeneoCoarseOperatorBuilder(ref.distributed_operator), f, symmetry,
        schwarz)

    op, diag = _carried(ref, golden_data_root, symmetry, n_partitions)
    solver = T.DDMSolverBuilder(op, copy.deepcopy(diag),
                                PortMatrixGenerator(A), ovr, c2o, neighbors,
                                intersections).solver
    x = _two_level(solver, _space_builders(T, geneo_type, diag, c2o, ovr,
                                           Ki, symmetry, UPLO),
                   T.GeneoCoarseOperatorBuilder(op), f, symmetry, schwarz)

    info, ref_info = solver.get_information(), ref_solver.get_information()
    assert int(info["Nb_coarse_vectors"]) > 0
    for key in ("Nb_it", "Nb_coarse_vectors", "Coarse_correction"):
        assert info[key] == ref_info[key], (key, info, ref_info)
    assert _rel(x, x_ref) <= 1e-10
    assert _rel(_coarse_operator(solver, T),
                _coarse_operator(ref_solver, H)) <= 1e-10
    # the preconditioner, and with no Schwarz method the coarse term alone
    r = np.random.RandomState(0).standard_normal(len(x))
    for method in (schwarz, "none"):
        for s in (solver, ref_solver):
            s.set_hpddm_args(f"-hpddm_schwarz_method {method}")
        assert _rel(solver._preconditioner()(r),
                    ref_solver._preconditioner()(r)) <= 1e-10
    xs = x[:, 1] if mu > 1 else x
    assert np.linalg.norm(op @ x - f) / np.linalg.norm(f) < _TOL
    assert _rel(xs, x_sol) < 10 * _EPS


@pytest.mark.parametrize(
    "mu,symmetry,schwarz,geneo_type,n_partitions",
    [(1, "S", "asm", "geneo_nu", 2),
     (1, "S", "ras", "custom_geneo_nu", 2),
     (10, "S", "asm", "custom_geneo_nu", 2)])
def test_hmatrix_subdomain_rows_on_the_reference_operator(
        load_data_solver, golden_data_root, mu, symmetry, schwarz, geneo_type,
        n_partitions):
    """`DDMWithHMatrix`: the port compresses the overlapping subdomains
    itself (its ACA pivots may differ from the reference's), so these rows
    hold the reference's contract."""
    [A, x_sol, f, geometry, ref_cluster, neighbors, intersections, symmetry,
     UPLO, c2o, ovr, Ki] = load_data_solver
    op, diag = _carried(_reference(A, ref_cluster, symmetry, UPLO),
                        golden_data_root, symmetry, n_partitions)
    approx = types.SimpleNamespace(distributed_operator=op,
                                   block_diagonal_hmatrix=diag)
    builder = _builder("DDMWithHMatrix", approx, PortMatrixGenerator(A),
                       symmetry, UPLO, ovr, c2o, neighbors, intersections,
                       geometry)
    x = _two_level(builder.solver, _space_builders(
        T, geneo_type, diag, c2o, ovr, Ki, symmetry, UPLO,
        builder.get_local_hmatrix()), T.GeneoCoarseOperatorBuilder(op), f,
        symmetry, schwarz)
    xs = x[:, 1] if mu > 1 else x
    assert int(builder.solver.get_information()["Nb_coarse_vectors"]) == 4
    assert np.linalg.norm(op @ x - f) / np.linalg.norm(f) < _TOL
    assert _rel(xs, x_sol) < 10 * _EPS


@pytest.mark.parametrize(
    "mu,symmetry,kind,schwarz,geneo_type,n_partitions",
    [(1, "S", "DDMWithHMatrixPlusOverlap", "asm", "geneo_nu", 2),
     (1, "S", "DDMWithHMatrixPlusOverlap", "ras", "geneo_nu", 2),
     (10, "S", "DDMWithHMatrixPlusOverlap", "ras", "geneo_nu", 2),
     (1, "S", "DDMWithHMatrixPlusOverlap", "ras", "geneo_threshold", 2),
     (1, "S", "DDMWithHMatrixPlusOverlap", "asm", "custom_dense_geneo_nu", 2),
     (1, "S", "DDMWithHMatrixPlusOverlap", "ras",
      "custom_dense_geneo_threshold", 2),
     (1, "S", "DDMWithHMatrix", "asm", "geneo_nu", 2),
     (1, "S", "DDMWithHMatrix", "ras", "custom_geneo_nu", 2),
     (10, "S", "DDMWithHMatrix", "asm", "custom_geneo_nu", 2)])
def test_rows_on_the_port_assembly(load_data_solver, golden_data_root, mu,
                                   symmetry, kind, schwarz, geneo_type,
                                   n_partitions):
    [A, x_sol, f, geometry, _, neighbors, intersections, symmetry, UPLO, c2o,
     ovr, Ki] = load_data_solver
    cluster = _port_cluster(golden_data_root, symmetry, n_partitions)
    generator = PortMatrixGenerator(A)
    approx = T.DefaultApproximationBuilder(
        generator, cluster, cluster,
        T.HMatrixTreeBuilder(_EPS, 10, symmetry, UPLO, device="cpu"))
    T.recompression(approx.hmatrix)
    builder = _builder(kind, approx, generator, symmetry, UPLO, ovr, c2o,
                       neighbors, intersections, geometry)
    x = _two_level(builder.solver, _space_builders(
        T, geneo_type, approx.block_diagonal_hmatrix, c2o, ovr, Ki, symmetry,
        UPLO, builder.get_local_hmatrix()
        if kind == "DDMWithHMatrix" else None),
        T.GeneoCoarseOperatorBuilder(approx.distributed_operator), f,
        symmetry, schwarz)
    op = approx.distributed_operator
    xs = x[:, 1] if mu > 1 else x
    info = builder.solver.get_information()
    assert int(info["Nb_coarse_vectors"]) > 0, info
    assert np.linalg.norm(op @ x - f) / np.linalg.norm(f) < _TOL, info
    assert _rel(xs, x_sol) < 10 * _EPS


@pytest.mark.parametrize("mu,symmetry,n_partitions", [(1, "S", 2)])
@pytest.mark.parametrize("ncol", [7, 70])
def test_coarse_operator_routes(load_data_solver, golden_data_root, mu,
                                symmetry, n_partitions, ncol):
    """E on the device route (one chunk of 7, or 70 columns padded to two
    chunks of 64) against `matvec_global`, the reference's E on the same Z
    and the host route of custom Python local operators, to 1e-12."""
    [A, _, _, _, ref_cluster, _, _, symmetry, UPLO, _, _, _] = \
        load_data_solver
    ref = _reference(A, ref_cluster, symmetry, UPLO)
    op, _ = _carried(ref, golden_data_root, symmetry, n_partitions)
    assert op.device_apply_available()
    Z = np.random.RandomState(ncol).standard_normal((A.shape[0], ncol))
    E = T.GeneoCoarseOperatorBuilder(op).build_coarse_operator(Z)
    assert E.shape == (ncol, ncol) and E.dtype == np.float64
    assert _rel(E, Z.T @ op.matvec_global(Z)) <= 1e-12
    E_ref = H.GeneoCoarseOperatorBuilder(
        ref.distributed_operator).build_coarse_operator(Z)
    assert _rel(E, E_ref) <= 1e-12

    cluster = op.target_cluster
    perm = cluster.get_permutation()
    A_int = A[np.ix_(perm, perm)]
    full = T.LocalRenumbering(0, len(perm), perm)
    rows = []
    for p in range(n_partitions):
        node = cluster.get_cluster_on_partition(p)
        t0, ts = node.get_offset(), node.get_size()
        rows.append(_Rows(A_int[t0:t0 + ts], T.LocalRenumbering(node), full))
    host = T.CustomApproximationBuilder(cluster, cluster, None, rows,
                                        device="cpu").distributed_operator
    assert not host.device_apply_available()
    E_host = T.GeneoCoarseOperatorBuilder(host).build_coarse_operator(Z)
    assert _rel(E_host, Z.T @ A @ Z) <= 1e-12
    # the compressed operator is within eps of the dense one
    assert _rel(E, E_host) <= 10 * _EPS
    assert T.GeneoCoarseOperatorBuilder(op).build_coarse_operator(
        Z[:, :0]).shape == (0, 0)
