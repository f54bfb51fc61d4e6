"""The port's DDM solver on the reference's golden data (CPU, float64 and
complex128; data/htool_generated_data, N = 400, sym and non-sym).

Rows of the reference's own table (tests/test_ddm_solver.py) without
GenEO: every builder variant (BlockJacobi, BlockJacobiDense,
DDMWithHMatrixPlusOverlap(Dense), DDMWithHMatrix(Dense)), Schwarz
none / asm / ras, mu in {1, 10}, P in {1, 2, 4}, right and left variants:
GMRES converges to 1e-6 and the solution is within 10 eps of sol.bin.  On
the reference's own operator (its block rows carried over with `interop`)
the iteration counts equal the reference solver's, with the dense tier
and with the hierarchical tier (subdomains above `ddm_local_dense_max`
factorized by HODLR; thresholds lowered in both packages).  An unknown
-hpddm_ option raises.  GenEO two-level solves: test_torch_geneo.py.
"""

import copy

import jax
import numpy as np
import pytest

import htool_python_torch as T
import htool_python_tpu as H
from conftest import GeneratorFromMatrix
from htool_python_torch import interop
from htool_python_torch.config import get_config
from htool_python_torch.parallel.builders import PerPartition, \
    _extract_block_diagonal
from htool_python_torch.solvers import options
from htool_python_tpu.config import get_config as ref_config
from htool_python_tpu.solvers import options as ref_options
from test_torch_complex import one_thread  # noqa: F401

_EPS, _TOL = 1e-6, 1e-6


class PortMatrixGenerator(T.VirtualGenerator):
    def __init__(self, matrix):
        super().__init__()
        self.matrix = matrix
        self.is_complex = np.iscomplexobj(matrix)

    def build_submatrix(self, J, K, mat):
        mat[:, :] = self.matrix[np.ix_(np.asarray(J), np.asarray(K))]


def _port_cluster(golden_data_root, symmetry, n_partitions):
    path = golden_data_root / ("output_" + ("sym" if symmetry == "S"
                                            else "non_sym"))
    return T.read_cluster_from(
        str(path / f"cluster_{n_partitions}_cluster_tree_properties.csv"),
        str(path / f"cluster_{n_partitions}_cluster_tree.csv"))


def _builder(kind, approx, generator, symmetry, UPLO, ovr, c2o, neighbors,
             intersections, geometry):
    op = approx.distributed_operator
    hb = T.HMatrixTreeBuilder(_EPS, 10, symmetry, UPLO, device="cpu")
    if kind == "BlockJacobi":
        return T.DDMSolverBuilder(op, copy.deepcopy(
            approx.block_diagonal_hmatrix))
    if kind == "BlockJacobiDense":
        return T.DDMSolverWithDenseLocalSolver(op,
                                               approx.block_diagonal_hmatrix)
    if kind == "DDMWithHMatrixPlusOverlap":
        return T.DDMSolverBuilder(op, copy.deepcopy(
            approx.block_diagonal_hmatrix), generator, ovr, c2o, neighbors,
            intersections)
    if kind == "DDMWithHMatrixPlusOverlapDense":
        return T.DDMSolverWithDenseLocalSolver(
            op, approx.block_diagonal_hmatrix, generator, ovr, c2o,
            neighbors, intersections)
    if kind == "DDMWithHMatrix":
        b = T.DDMSolverBuilder(op, ovr, c2o, neighbors, intersections,
                               generator, geometry, T.ClusterTreeBuilder(),
                               hb, radii=None, weights=None)
        T.recompression(b.get_local_hmatrix())
        return b
    assert kind == "DDMWithHMatrixDense"
    return T.DDMSolverWithDenseLocalSolver(op, ovr, c2o, neighbors,
                                           intersections, generator,
                                           geometry, hb)


def _args(symmetry, schwarz, variant="right", coarse_correction="none"):
    restart = "" if symmetry == "S" else " -hpddm_gmres_restart 200 "
    return ("-hpddm_krylov_method gmres" + restart
            + " -hpddm_schwarz_method " + schwarz
            + f" -hpddm_max_it 200 -hpddm_variant {variant} -hpddm_tol "
            + str(_TOL)
            + f" -hpddm_schwarz_coarse_correction {coarse_correction}")


def _solve(solver, f, symmetry, schwarz, variant="right",
           coarse_correction="none"):
    dtype = "complex128" if symmetry != "S" else "float64"
    x = np.zeros(f.shape, dtype=dtype, order="F")
    solver.set_hpddm_args(_args(symmetry, schwarz, variant,
                                coarse_correction))
    if schwarz in ("asm", "ras"):
        solver.facto_one_level()
    solver.solve(x, f)
    return x


@pytest.mark.parametrize(
    "mu,symmetry,kind,schwarz,n_partitions,variant",
    [
        (1, "N", "BlockJacobi", "none", 1, "right"),
        (1, "N", "BlockJacobi", "asm", 2, "right"),
        (1, "N", "BlockJacobi", "ras", 4, "right"),
        (1, "N", "BlockJacobiDense", "asm", 2, "right"),
        (1, "N", "DDMWithHMatrixPlusOverlap", "asm", 4, "right"),
        (1, "N", "DDMWithHMatrixPlusOverlapDense", "ras", 2, "right"),
        (1, "N", "DDMWithHMatrix", "ras", 2, "right"),
        (1, "N", "DDMWithHMatrixDense", "asm", 4, "right"),
        (10, "N", "BlockJacobi", "ras", 2, "right"),
        (1, "N", "BlockJacobi", "ras", 2, "left"),
        (1, "S", "BlockJacobi", "ras", 1, "right"),
        (1, "S", "BlockJacobi", "asm", 4, "right"),
        (1, "S", "BlockJacobiDense", "ras", 4, "right"),
        (1, "S", "DDMWithHMatrixPlusOverlap", "ras", 2, "right"),
        (1, "S", "DDMWithHMatrixPlusOverlapDense", "asm", 4, "right"),
        (1, "S", "DDMWithHMatrix", "asm", 4, "right"),
        (1, "S", "DDMWithHMatrixDense", "ras", 2, "right"),
        (10, "S", "DDMWithHMatrixPlusOverlap", "asm", 4, "right"),
        (1, "S", "BlockJacobi", "asm", 2, "left"),
    ])
def test_golden_ddm_solve(load_data_solver, golden_data_root, mu, symmetry,
                          kind, schwarz, n_partitions, variant):
    [A, x_ref, f, geometry, _, neighbors, intersections, symmetry, UPLO,
     cluster_to_ovr, ovr_to_global, _] = load_data_solver
    cluster = _port_cluster(golden_data_root, symmetry, n_partitions)
    generator = PortMatrixGenerator(A)
    approx = T.DefaultApproximationBuilder(
        generator, cluster, cluster,
        T.HMatrixTreeBuilder(_EPS, 10, symmetry, UPLO, device="cpu"))
    T.recompression(approx.hmatrix)
    builder = _builder(kind, approx, generator, symmetry, UPLO,
                       ovr_to_global, cluster_to_ovr, neighbors,
                       intersections, geometry)
    x = _solve(builder.solver, f, symmetry, schwarz, variant)
    op = approx.distributed_operator
    if mu == 1:
        residual = np.linalg.norm(op * x - f) / np.linalg.norm(f)
        xs = x
    else:
        residual = np.linalg.norm(op @ x - f) / np.linalg.norm(f)
        xs = x[:, 1]
    info = builder.solver.get_information()
    # left variant: tol applies to the preconditioned residual
    assert residual < (_TOL if variant == "right" else 10 * _TOL), info
    assert np.linalg.norm(xs - x_ref) / np.linalg.norm(x_ref) < 10 * _EPS
    assert info["Nb_subdomains"] == str(n_partitions)
    assert int(info["Nb_it"]) > 0


@pytest.mark.parametrize("mu", [1])
@pytest.mark.parametrize("symmetry,schwarz,n_partitions",
                         [("S", "asm", 2), ("N", "ras", 4)])
def test_iterations_equal_reference_on_its_operator(load_data_solver,
                                                    golden_data_root, mu,
                                                    symmetry, schwarz,
                                                    n_partitions):
    [A, _, f, _, ref_cluster, _, _, symmetry, UPLO, _, _, _] = \
        load_data_solver
    ref = H.DefaultApproximationBuilder(
        GeneratorFromMatrix(A), ref_cluster, ref_cluster,
        H.HMatrixTreeBuilder(_EPS, 10, symmetry, UPLO), None)
    ref_builder = H.DDMSolverBuilder(ref.distributed_operator,
                                     copy.deepcopy(ref.block_diagonal_hmatrix))
    x_ref = _solve(ref_builder.solver, f, symmetry, schwarz)

    cluster = _port_cluster(golden_data_root, symmetry, n_partitions)
    op = interop.distributed_from_reference(
        cluster, cluster,
        [(h.plan, jax.tree_util.tree_map(np.asarray, h._data), h._lr_ranks,
          h.epsilon) for h in ref.hmatrix], "cpu")
    diag = PerPartition(_extract_block_diagonal(
        op._global_to_local[p][0].hmatrix, cluster, cluster, p)
        for p in range(n_partitions))
    builder = T.DDMSolverBuilder(op, diag)
    x = _solve(builder.solver, f, symmetry, schwarz)
    assert (builder.solver.get_information()["Nb_it"]
            == ref_builder.solver.get_information()["Nb_it"])
    assert np.linalg.norm(x - x_ref) <= 1e-10 * np.linalg.norm(x_ref)


@pytest.mark.parametrize("mu", [1])
@pytest.mark.parametrize("symmetry,schwarz,n_partitions",
                         [("S", "asm", 2), ("N", "ras", 4)])
def test_coarse_correction_without_coarse_space_matches_reference(
        load_data_solver, golden_data_root, mu, symmetry, schwarz,
        n_partitions):
    """-hpddm_schwarz_coarse_correction with no coarse space built: both
    packages run the one-level solve (the reference's use_coarse needs a
    coarse space), with equal iteration counts and solutions."""
    [A, _, f, _, ref_cluster, _, _, symmetry, UPLO, _, _, _] = \
        load_data_solver
    ref = H.DefaultApproximationBuilder(
        GeneratorFromMatrix(A), ref_cluster, ref_cluster,
        H.HMatrixTreeBuilder(_EPS, 10, symmetry, UPLO), None)
    ref_builder = H.DDMSolverBuilder(ref.distributed_operator,
                                     copy.deepcopy(ref.block_diagonal_hmatrix))
    x_ref = _solve(ref_builder.solver, f, symmetry, schwarz,
                   coarse_correction="additive")
    cluster = _port_cluster(golden_data_root, symmetry, n_partitions)
    op = interop.distributed_from_reference(
        cluster, cluster,
        [(h.plan, jax.tree_util.tree_map(np.asarray, h._data), h._lr_ranks,
          h.epsilon) for h in ref.hmatrix], "cpu")
    diag = PerPartition(_extract_block_diagonal(
        op._global_to_local[p][0].hmatrix, cluster, cluster, p)
        for p in range(n_partitions))
    solver = T.DDMSolverBuilder(op, diag).solver
    x = _solve(solver, f, symmetry, schwarz, coarse_correction="additive")
    assert solver.get_information()["Coarse_correction"] == "additive"
    assert (solver.get_information()["Nb_it"]
            == ref_builder.solver.get_information()["Nb_it"])
    assert np.linalg.norm(x - x_ref) <= 1e-10 * np.linalg.norm(x_ref)
    x_one = _solve(solver, f, symmetry, schwarz)
    assert np.linalg.norm(x - x_one) <= 1e-12 * np.linalg.norm(x_one)


# the hierarchical tier at the golden size: every subdomain (100 or 200
# dofs) above ddm_local_dense_max and hodlr_threshold, HODLR leaves of at
# most 32 and probe batches as wide as any block (k = m), so both packages'
# randomized range capture is exact and their local solvers agree to
# round-off
_HIER_KNOBS = {"ddm_local_dense_max": 64, "hodlr_threshold": 64,
               "hodlr_leaf_size": 32, "hodlr_sample_size": 256}


@pytest.fixture
def hierarchical_tier():
    saved = [(cfg, {k: getattr(cfg, k) for k in _HIER_KNOBS})
             for cfg in (get_config(), ref_config())]
    for cfg, _ in saved:
        for k, v in _HIER_KNOBS.items():
            setattr(cfg, k, v)
    yield
    for cfg, old in saved:
        for k, v in old.items():
            setattr(cfg, k, v)


@pytest.mark.parametrize("mu", [1])
@pytest.mark.parametrize("symmetry,schwarz,n_partitions",
                         [("S", "asm", 2), ("N", "ras", 4)])
def test_hierarchical_tier_iterations_equal_reference(
        load_data_solver, golden_data_root, hierarchical_tier, mu, symmetry,
        schwarz, n_partitions):
    [A, _, f, _, ref_cluster, _, _, symmetry, UPLO, _, _, _] = \
        load_data_solver
    ref = H.DefaultApproximationBuilder(
        GeneratorFromMatrix(A), ref_cluster, ref_cluster,
        H.HMatrixTreeBuilder(_EPS, 10, symmetry, UPLO), None)
    ref_builder = H.DDMSolverBuilder(ref.distributed_operator,
                                     copy.deepcopy(ref.block_diagonal_hmatrix))
    x_ref = _solve(ref_builder.solver, f, symmetry, schwarz)
    assert [h["solver"].kind for h in ref_builder.solver._hier] == (
        ["hodlr"] * n_partitions)

    cluster = _port_cluster(golden_data_root, symmetry, n_partitions)
    op = interop.distributed_from_reference(
        cluster, cluster,
        [(h.plan, jax.tree_util.tree_map(np.asarray, h._data), h._lr_ranks,
          h.epsilon) for h in ref.hmatrix], "cpu")
    diag = PerPartition(_extract_block_diagonal(
        op._global_to_local[p][0].hmatrix, cluster, cluster, p)
        for p in range(n_partitions))
    builder = T.DDMSolverBuilder(op, diag)
    x = _solve(builder.solver, f, symmetry, schwarz)
    solver = builder.solver
    assert solver._facto is None
    assert [h["solver"].kind for h in solver._hier] == ["hodlr"] * n_partitions
    assert all(s.local_matrix is None for s in solver.subdomains)
    assert (solver.get_information()["Nb_it"]
            == ref_builder.solver.get_information()["Nb_it"])
    assert np.linalg.norm(x - x_ref) <= 1e-8 * np.linalg.norm(x_ref)


@pytest.mark.parametrize("mu,symmetry,n_partitions", [(1, "N", 4)])
def test_mixed_tiers_in_user_order(load_data_solver, golden_data_root, mu,
                                   symmetry, n_partitions):
    """Overlapping subdomains re-clustered as root H-matrices (the local
    H-matrix's user order is the subdomain's dof order, so the HODLR solve
    goes through its cluster permutation) of 181, 246, 254 and 177 dofs:
    with ddm_local_dense_max 200 two are dense and two hierarchical, and
    the solve meets tol with the iterations of the all-dense tier."""
    [A, x_ref, f, geometry, _, neighbors, intersections, symmetry, UPLO,
     cluster_to_ovr, ovr_to_global, _] = load_data_solver
    cluster = _port_cluster(golden_data_root, symmetry, n_partitions)
    generator = PortMatrixGenerator(A)
    approx = T.DefaultApproximationBuilder(
        generator, cluster, cluster,
        T.HMatrixTreeBuilder(_EPS, 10, symmetry, UPLO, device="cpu"))
    builder = _builder("DDMWithHMatrix", approx, generator, symmetry, UPLO,
                       ovr_to_global, cluster_to_ovr, neighbors,
                       intersections, geometry)
    solver = builder.solver
    x_dense = _solve(solver, f, symmetry, "asm")
    its = int(solver.get_information()["Nb_it"])
    cfg = get_config()
    saved = (cfg.ddm_local_dense_max, cfg.hodlr_threshold,
             cfg.hodlr_leaf_size)
    cfg.ddm_local_dense_max, cfg.hodlr_threshold, cfg.hodlr_leaf_size = (
        200, 128, 32)
    try:
        x = _solve(solver, f, symmetry, "asm")
    finally:
        (cfg.ddm_local_dense_max, cfg.hodlr_threshold,
         cfg.hodlr_leaf_size) = saved
    assert solver._facto[3] == 181  # the dense batch: 181 and 177 dofs
    assert [h["solver"].kind for h in solver._hier] == ["hodlr", "hodlr"]
    assert all(h["solver"].perm is not None for h in solver._hier)
    op = approx.distributed_operator
    assert np.linalg.norm(op * x - f) / np.linalg.norm(f) < _TOL
    assert np.linalg.norm(x - x_ref) / np.linalg.norm(x_ref) < 10 * _EPS
    assert abs(int(solver.get_information()["Nb_it"]) - its) <= 1
    assert np.linalg.norm(x - x_dense) <= 1e-5 * np.linalg.norm(x_dense)


class _Rows(T.RestrictedGlobalToLocalOperator):
    """A custom Python operator: one partition's rows of a dense matrix."""

    def __init__(self, A, target, source):
        super().__init__(target, source)
        self.A = A

    def add_vector_product(self, trans, alpha, input, beta, output):
        output *= beta
        output += alpha * (self.A @ input)

    add_matrix_product_row_major = add_vector_product


@pytest.mark.parametrize("mu,symmetry,n_partitions", [(1, "N", 2)])
def test_lu_tier_and_host_path(load_data_solver, golden_data_root, mu,
                               symmetry, n_partitions):
    """The dense tier with ddm_dense_apply 'solve' (LU solves each
    application) takes the iterations of 'invert'; a distributed operator
    of custom Python local operators runs the host recurrences and still
    meets tol."""
    [A, x_ref, f, _, _, _, _, symmetry, UPLO, _, _, _] = load_data_solver
    cluster = _port_cluster(golden_data_root, symmetry, n_partitions)
    approx = T.DefaultApproximationBuilder(
        PortMatrixGenerator(A), cluster, cluster,
        T.HMatrixTreeBuilder(_EPS, 10, symmetry, UPLO, device="cpu"))
    builder = T.DDMSolverBuilder(approx.distributed_operator,
                                 approx.block_diagonal_hmatrix)
    x_inv = _solve(builder.solver, f, symmetry, "ras")
    its = builder.solver.get_information()["Nb_it"]
    cfg = get_config()
    cfg.ddm_dense_apply = "solve"
    try:
        x_lu = _solve(builder.solver, f, symmetry, "ras")
    finally:
        cfg.ddm_dense_apply = "invert"
    assert builder.solver._facto[0] == "lu"
    assert builder.solver.get_information()["Nb_it"] == its
    assert np.linalg.norm(x_lu - x_inv) <= 1e-10 * np.linalg.norm(x_inv)

    perm = cluster.get_permutation()
    A_int = A[np.ix_(perm, perm)]
    full = T.LocalRenumbering(0, len(perm), perm)
    rows = []
    for p in range(n_partitions):
        node = cluster.get_cluster_on_partition(p)
        t0, ts = node.get_offset(), node.get_size()
        rows.append(_Rows(A_int[t0:t0 + ts], T.LocalRenumbering(node), full))
    op = T.CustomApproximationBuilder(cluster, cluster, None, rows,
                                      device="cpu").distributed_operator
    assert not op.device_apply_available()
    solver = T.DDMSolverBuilder(op, approx.block_diagonal_hmatrix).solver
    x = _solve(solver, f, symmetry, "ras")
    assert np.linalg.norm(A @ x - f) / np.linalg.norm(f) < _TOL
    assert np.linalg.norm(x - x_ref) / np.linalg.norm(x_ref) < 10 * _EPS


@pytest.mark.parametrize("mu,symmetry,n_partitions", [(1, "S", 2)])
def test_what_is_not_ported_raises(load_data_solver, golden_data_root, mu,
                                   symmetry, n_partitions):
    [A, _, f, _, _, _, _, symmetry, UPLO, _, _, _] = load_data_solver
    cluster = _port_cluster(golden_data_root, symmetry, n_partitions)
    approx = T.DefaultApproximationBuilder(
        PortMatrixGenerator(A), cluster, cluster,
        T.HMatrixTreeBuilder(_EPS, 10, symmetry, UPLO, device="cpu"))
    solver = T.DDMSolverBuilder(approx.distributed_operator,
                                approx.block_diagonal_hmatrix).solver
    cfg = get_config()
    limit = cfg.ddm_local_dense_max
    cfg.ddm_local_dense_max = 100  # the subdomains hold 200 dofs
    try:
        # once NotImplementedError (item 13); now the hierarchical tier: an
        # LU of each subdomain's H-matrix copy (200 dofs: below
        # hodlr_threshold), the same preconditioner as the dense tier's
        x_hier = _solve(solver, f, symmetry, "asm")
    finally:
        cfg.ddm_local_dense_max = limit
    assert solver._facto is None
    assert [h["solver"].kind for h in solver._hier] == ["lu"] * n_partitions
    its = solver.get_information()["Nb_it"]
    x_dense = _solve(solver, f, symmetry, "asm")
    assert solver._facto is not None and solver._hier == []
    assert solver.get_information()["Nb_it"] == its
    assert np.linalg.norm(x_hier - x_dense) <= 1e-10 * np.linalg.norm(x_dense)
    # a coarse correction without a coarse space runs one-level, as the
    # reference does (it raised NotImplementedError before)
    x_coarse = _solve(solver, f, symmetry, "asm",
                      coarse_correction="additive")
    assert solver.get_information()["Nb_it"] == its
    assert solver.get_information()["Nb_coarse_vectors"] == "0"
    assert np.linalg.norm(x_coarse - x_dense) <= 1e-12 * np.linalg.norm(
        x_dense)
    # once NotImplementedError (item 16); now a GenEO coarse space on the
    # block-Jacobi subdomains (no overlap: Bi = I, the 2 largest
    # eigenvectors of each diagonal block), used by the next solve
    sizes = [s.size for s in solver.subdomains]
    solver.build_coarse_space(
        [T.GeneoCoarseSpaceDenseBuilder(m, m, h, np.eye(m), symmetry, UPLO,
                                        geneo_nu=2)
         for m, h in zip(sizes, approx.block_diagonal_hmatrix)],
        T.GeneoCoarseOperatorBuilder(approx.distributed_operator))
    x_two = _solve(solver, f, symmetry, "asm", coarse_correction="additive")
    assert solver.get_information()["Nb_coarse_vectors"] == "4"
    op = approx.distributed_operator
    assert np.linalg.norm(op * x_two - f) / np.linalg.norm(f) < _TOL
    with pytest.raises(ValueError, match="-hpddm_geneo_nu"):
        solver.set_hpddm_args("-hpddm_geneo_nu 2")


def test_options_parse_as_the_reference():
    assert options.DEFAULTS == ref_options.DEFAULTS
    args = ("-hpddm_krylov_method gmres -hpddm_gmres_restart 60 "
            "-hpddm_schwarz_method asm -hpddm_max_it 300 -hpddm_tol 1e-6 "
            "-hpddm_variant left -hpddm_compute_residual l2 "
            "-hpddm_verbosity")
    assert options.parse_hpddm_args(args) == ref_options.parse_hpddm_args(args)
    with pytest.raises(ValueError, match="-hpddm_tolerance"):
        options.parse_hpddm_args("-hpddm_tolerance 1e-6")
