"""The port's GenEO coarse space builders against the reference's, on the
CPU in float64 (golden data, N = 400, P = 2), beside the solver rows of
test_torch_geneo.py:

* the `eig` branch of `GeneoCoarseSpaceDenseBuilder` on the non-symmetric
  data gives the reference's coarse space (compared by the projector
  Z Z^H: Z's columns are fixed only up to sign and order);
* the matrix-free hook's callback, applied to the identity, is the
  reference's in both branches (a local operator without the overlap,
  embedded; one with it, between the partitions of unity);
* an empty coarse space leaves the solve one-level, and a second
  `build_coarse_space` replaces the first;
* chip_smoke.py's overlap (a k-d tree's neighbours) is the one of
  tools/generate_test_data.py (dense distances) on the same points.
"""

import copy
import importlib
import pathlib
import sys

import numpy as np
import pytest

import htool_python_torch as T
import htool_python_tpu as H
from conftest import GeneratorFromMatrix
from htool_python_torch.solvers import coarse
from htool_python_tpu.solvers import coarse as ref_coarse
from test_torch_complex import one_thread, port_operator  # noqa: F401
from test_torch_ddm import _EPS, PortMatrixGenerator, _solve
from test_torch_geneo import _carried, _reference, _rel, _two_level


def _solvers(load_data_solver, golden_data_root, n_partitions):
    """(reference solver, port solver, port operator, port block diagonal)
    of the `DDMWithHMatrixPlusOverlap` variant on the reference's
    operator."""
    [A, _, _, _, ref_cluster, neighbors, intersections, symmetry, UPLO, c2o,
     ovr, _] = load_data_solver
    ref = _reference(A, ref_cluster, symmetry, UPLO)
    ref_solver = H.DDMSolverBuilder(
        ref.distributed_operator, copy.deepcopy(ref.block_diagonal_hmatrix),
        GeneratorFromMatrix(A), ovr, c2o, neighbors, intersections).solver
    op, diag = _carried(ref, golden_data_root, symmetry, n_partitions)
    solver = T.DDMSolverBuilder(op, copy.deepcopy(diag),
                                PortMatrixGenerator(A), ovr, c2o, neighbors,
                                intersections).solver
    return ref, ref_solver, solver, op, diag


def _dense_builders(pkg, diag, load_data_solver, symmetry, UPLO, **geneo):
    c2o, ovr, Ki = load_data_solver[9:12]
    return [pkg.GeneoCoarseSpaceDenseBuilder(len(c2o[p]), len(ovr[p]),
                                             diag[p], Ki[p], symmetry, UPLO,
                                             **geneo)
            for p in range(len(ovr))]


@pytest.mark.parametrize("mu,symmetry,n_partitions", [(1, "N", 2)])
def test_eig_branch_matches_reference(load_data_solver, golden_data_root, mu,
                                      symmetry, n_partitions):
    ref, ref_solver, solver, _, diag = _solvers(load_data_solver,
                                                golden_data_root, n_partitions)
    Z_ref = ref_coarse.assemble_geneo_coarse_space(
        ref_solver, _dense_builders(H, ref.block_diagonal_hmatrix,
                                    load_data_solver, "N", "N", geneo_nu=2))
    Z = coarse.assemble_geneo_coarse_space(
        solver, _dense_builders(T, diag, load_data_solver, "N", "N",
                                geneo_nu=2))
    assert Z.shape == Z_ref.shape == (len(load_data_solver[2]), 4)
    assert _rel(Z @ Z.conj().T, Z_ref @ Z_ref.conj().T) <= 1e-10


@pytest.mark.parametrize("mu,symmetry,n_partitions", [(1, "S", 2)])
def test_matrix_free_callbacks_match_reference(load_data_solver,
                                               golden_data_root, mu, symmetry,
                                               n_partitions):
    [A, _, _, geometry, _, neighbors, intersections, _, UPLO, c2o, ovr,
     Ki] = load_data_solver
    ref, ref_solver, solver, _, diag = _solvers(load_data_solver,
                                                golden_data_root, n_partitions)
    # the reference's overlapping subdomains compressed as H-matrices, and
    # the port holding their arrays on its own (equal) cluster trees
    ref_local = H.DDMSolverBuilder(
        ref.distributed_operator, ovr, c2o, neighbors, intersections,
        GeneratorFromMatrix(A), geometry, H.ClusterTreeBuilder(),
        H.HMatrixTreeBuilder(_EPS, 10, symmetry, UPLO)).get_local_hmatrix()
    for p in range(n_partitions):
        m = len(ovr[p])
        local = port_operator(ref_local[p], T.ClusterTreeBuilder()
                              .create_cluster_tree(geometry[:, ovr[p]], 2))
        for ref_Ai, Ai in ((ref.block_diagonal_hmatrix[p], diag[p]),
                           (ref_local[p], local)):
            callbacks = [
                mod._make_callback(pkg.VirtualGeneoCoarseSpaceBuilder(
                    len(c2o[p]), m, h), s.subdomains[p])
                for mod, pkg, h, s in ((ref_coarse, H, ref_Ai, ref_solver),
                                       (coarse, T, Ai, solver))]
            ref_DAiD, DAiD = (np.stack([cb(e) for e in np.eye(m)], axis=1)
                              for cb in callbacks)
            assert DAiD.shape == (m, m) and np.abs(DAiD).max() > 0
            assert _rel(DAiD, ref_DAiD) <= 1e-12
            # the overlap is zeroed: rows and columns of the ghost dofs
            ghost = np.setdiff1d(np.arange(m), c2o[p])
            assert not DAiD[ghost].any() and not DAiD[:, ghost].any()


@pytest.mark.parametrize("mu,symmetry,n_partitions", [(1, "S", 2)])
def test_empty_and_replaced_coarse_space(load_data_solver, golden_data_root,
                                         mu, symmetry, n_partitions):
    f, UPLO = load_data_solver[2], load_data_solver[8]
    _, _, solver, op, diag = _solvers(load_data_solver, golden_data_root,
                                      n_partitions)
    x_one = _solve(solver, f, symmetry, "asm", coarse_correction="additive")
    its_one = solver.get_information()["Nb_it"]

    # no vector in any subdomain: no coarse state, the one-level solve
    x = _two_level(solver, _dense_builders(T, diag, load_data_solver,
                                           symmetry, UPLO, geneo_nu=0),
                   T.GeneoCoarseOperatorBuilder(op), f, symmetry, "asm")
    assert solver._coarse is None
    assert solver.get_information()["Nb_coarse_vectors"] == "0"
    assert solver.get_information()["Nb_it"] == its_one
    assert _rel(x, x_one) <= 1e-12

    # 2 vectors a subdomain, then 4: the second state replaces the first
    # and solves as a solver that only ever had it
    fresh = copy.deepcopy(solver)
    _two_level(solver, _dense_builders(T, diag, load_data_solver, symmetry,
                                       UPLO, geneo_nu=2),
               T.GeneoCoarseOperatorBuilder(op), f, symmetry, "asm")
    assert solver.get_information()["Nb_coarse_vectors"] == "4"
    x = _two_level(solver, _dense_builders(T, diag, load_data_solver,
                                           symmetry, UPLO, geneo_nu=4),
                   T.GeneoCoarseOperatorBuilder(op), f, symmetry, "asm")
    x_fresh = _two_level(fresh, _dense_builders(T, diag, load_data_solver,
                                                symmetry, UPLO, geneo_nu=4),
                         T.GeneoCoarseOperatorBuilder(op), f, symmetry, "asm")
    assert solver.get_information()["Nb_coarse_vectors"] == "8"
    assert (solver.get_information()["Nb_it"]
            == fresh.get_information()["Nb_it"])
    assert _rel(x, x_fresh) <= 1e-12


@pytest.mark.parametrize("n,P", [(400, 2), (400, 4), (2000, 4)])
def test_chip_smoke_overlap_is_the_recipe(n, P):
    root = pathlib.Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root / "tools"))
    sys.path.insert(0, str(root))
    try:
        recipe = importlib.import_module("generate_test_data")
        chip_smoke = importlib.import_module("chip_smoke")
    finally:
        del sys.path[:2]
    points = np.random.RandomState(n + P).rand(3, n)
    builder = T.ClusterTreeBuilder()
    builder.set_maximal_leaf_size(10)
    cluster = builder.create_cluster_tree(points, 2, size_of_partition=P)
    ovr, c2o, neighbors, intersections = chip_smoke.overlap_decomposition(
        points, cluster, P)
    for p, (r_ovr, r_c2o, r_nbr, r_inter) in enumerate(
            recipe._overlap_decomposition(points, cluster, P)):
        assert np.array_equal(ovr[p], r_ovr)
        assert np.array_equal(c2o[p], r_c2o)
        assert np.array_equal(neighbors[p], r_nbr)
        assert len(intersections[p]) == len(r_inter)
        assert all(np.array_equal(a, b)
                   for a, b in zip(intersections[p], r_inter))
