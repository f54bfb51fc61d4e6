"""The port's distributed operator against the reference (CPU, float64 and
complex128).

* The reference's `DefaultApproximationBuilder` block rows, carried over
  with `interop.distributed_from_reference`: partition layout equal, the
  distributed product within 1e-12 of the reference's operator for
  P in {1, 3} x nb_rhs in {1, 5} x storage N / S, the block diagonal
  extracted on the device with the reference's buckets and entries.
* Independent builds by the port meet eps against the dense oracle.
* Custom local operators (host path, in-place `beta` contract), the
  windowed local-to-local product, the device apply after an in-place
  change to a dense piece, the reduced information dict, and the cluster
  CSV round trip between both packages.

The reference assembles through its host-generator path (no XLA compile).
"""

import jax
import numpy as np
import pytest
import torch

import htool_python_torch as T
import htool_python_tpu as H
from htool_python_torch import interop
from htool_python_torch.models.kernels import inverse_distance_kernel as pk
from htool_python_torch.parallel.builders import _extract_block_diagonal
from test_torch_complex import (ReferenceHostGenerator, hermitian_oracle,
                                one_thread, symmetric_matrix)  # noqa: F401

_N, _LEAF, _EPS = 400, 24, 1e-6


def _points(n=_N, seed=3):
    return np.random.RandomState(seed).rand(3, n)


def _real_oracle(points):
    d = np.linalg.norm(points[:, :, None] - points[:, None, :], axis=0)
    return 1.0 / (0.1 + d)


def _clusters(points, P, leaf=_LEAF):
    out = []
    for pkg in (H, T):
        b = pkg.ClusterTreeBuilder()
        b.set_maximal_leaf_size(leaf)
        out.append(b.create_cluster_tree(points, 2, size_of_partition=P))
    return out


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _matrix(points, symmetry, dtype):
    if dtype == np.float64:
        return _real_oracle(points)
    return symmetric_matrix(points) if symmetry == "S" else \
        hermitian_oracle(points)


@pytest.fixture(scope="module")
def reference_rows():
    """{(dtype, symmetry, P): (reference builder, port cluster, matrix)}."""
    cache = {}

    def get(dtype, symmetry, P):
        key = (dtype, symmetry, P)
        if key not in cache:
            points = _points()
            A = _matrix(points, symmetry, dtype)
            ref_cluster, port_cluster = _clusters(points, P)
            hb = H.HMatrixTreeBuilder(_EPS, 10.0, symmetry,
                                      "L" if symmetry == "S" else "N")
            hb.set_dtype(dtype)
            cache[key] = (H.DefaultApproximationBuilder(
                ReferenceHostGenerator(A), ref_cluster, ref_cluster, hb, None),
                port_cluster, A)
        return cache[key]

    return get


def _port_operator(ref, port_cluster):
    rows = [(h.plan, jax.tree_util.tree_map(np.asarray, h._data),
             h._lr_ranks, h.epsilon) for h in ref.hmatrix]
    return interop.distributed_from_reference(port_cluster, port_cluster,
                                              rows, "cpu")


def _reference_dense(ref):
    """The reference distributed operator as a dense matrix in user
    numbering, from its block rows' own densification."""
    op = ref.distributed_operator
    n = op.shape[0]
    inner = np.zeros((n, n), dtype=np.asarray(ref.hmatrix[0].to_dense()).dtype)
    for p, h in enumerate(ref.hmatrix):
        t_off, t_sz = int(op.t_offsets[p]), int(op.t_sizes[p])
        inner[t_off:t_off + t_sz] = np.asarray(h.to_dense())
    perm = op.target_cluster.get_permutation()
    out = np.empty_like(inner)
    out[np.ix_(perm, op.source_cluster.get_permutation())] = inner
    return out


@pytest.mark.parametrize("nb_rhs", [1, 5])
@pytest.mark.parametrize("P", [1, 3])
@pytest.mark.parametrize("symmetry", ["N", "S"])
@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_distributed_product_matches_reference(reference_rows, dtype,
                                               symmetry, P, nb_rhs):
    ref, port_cluster, _ = reference_rows(dtype, symmetry, P)
    op = _port_operator(ref, port_cluster)
    assert np.array_equal(op.t_offsets, ref.distributed_operator.t_offsets)
    assert np.array_equal(op.t_sizes, ref.distributed_operator.t_sizes)
    rng = np.random.RandomState(nb_rhs)
    x = rng.rand(_N, nb_rhs) + (1j * rng.rand(_N, nb_rhs)
                                if dtype == np.complex128 else 0)
    y_ref = _reference_dense(ref) @ x
    if nb_rhs == 1:
        y = op * x[:, 0]
        assert _rel(y, y_ref[:, 0]) <= 1e-12
    else:
        assert _rel(op @ x, y_ref) <= 1e-12
    # the host path (the local operators' own products) agrees too
    x_int = x[op.source_cluster.get_permutation()]
    for p in range(P):
        t_off, t_sz = int(op.t_offsets[p]), int(op.t_sizes[p])
        y_int = op.internal_sub_vector_product_global_to_local(x_int, 0, p)
        perm_t = op.target_cluster.get_permutation()
        assert _rel(y_int, y_ref[perm_t[t_off:t_off + t_sz]]) <= 1e-12


def test_product_matches_reference_product(reference_rows):
    """The reference's own distributed product (its device apply)."""
    ref, port_cluster, _ = reference_rows(np.float64, "N", 3)
    x = np.asfortranarray(np.random.RandomState(5).rand(_N, 5))
    y_ref = ref.distributed_operator @ x
    assert _rel(_port_operator(ref, port_cluster) @ x, y_ref) <= 1e-12


@pytest.mark.parametrize("symmetry", ["N", "S"])
def test_rectangular_block_row_densifies_like_reference(reference_rows,
                                                        symmetry):
    """A block row (t_sz x N) densifies to its own shape, equal to the
    reference's densification of the same row."""
    ref, port_cluster, _ = reference_rows(np.float64, symmetry, 3)
    op = _port_operator(ref, port_cluster)
    for p, ref_row in enumerate(ref.hmatrix):
        h = op._global_to_local[p][0].hmatrix
        dense = h.to_dense()
        assert dense.shape == (int(op.t_sizes[p]), _N)
        assert _rel(dense, np.asarray(ref_row.to_dense())) <= 1e-12


@pytest.mark.parametrize("P", [1, 3])
@pytest.mark.parametrize("symmetry", ["N", "S"])
@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_extracted_block_diagonal_equals_reference(reference_rows, dtype,
                                                   symmetry, P):
    ref, port_cluster, _ = reference_rows(dtype, symmetry, P)
    op = _port_operator(ref, port_cluster)
    for p, ref_diag in enumerate(ref.block_diagonal_hmatrix):
        diag = _extract_block_diagonal(op._global_to_local[p][0].hmatrix,
                                       port_cluster, port_cluster, p)
        for kind in ("dense_buckets", "lowrank_buckets"):
            mine, theirs = getattr(diag.plan, kind), getattr(ref_diag.plan,
                                                             kind)
            assert len(mine) == len(theirs)
            for a, b in zip(mine, theirs):
                assert (a.pt, a.ps) == (b.pt, b.ps)
                for field in ("t_off", "s_off", "t_sz", "s_sz", "mirror"):
                    assert np.array_equal(getattr(a, field),
                                          np.asarray(getattr(b, field)))
        for r_mine, r_theirs in zip(diag._lr_ranks, ref_diag._lr_ranks):
            assert np.array_equal(r_mine, r_theirs)
        for mine, theirs in zip(diag._data["dense"] + diag._data["lr"],
                                ref_diag._data["dense"]
                                + ref_diag._data["lr"]):
            for a, b in zip(mine[:-3], theirs[:-3]):
                assert np.array_equal(a.numpy(), np.asarray(b))
        assert (diag.plan.nb_rows, diag.plan.nb_cols) == ref_diag.shape


@pytest.mark.parametrize("symmetry,UPLO", [("N", "N"), ("S", "L")])
def test_independent_build_meets_eps(symmetry, UPLO):
    points = _points(seed=4)
    A = _real_oracle(points)
    cluster = _clusters(points, 3)[1]
    eps = 1e-4
    approx = T.DefaultApproximationBuilder(
        T.KernelGenerator(pk(0.1), points, points, device="cpu"), cluster,
        cluster, T.HMatrixTreeBuilder(eps, 10.0, symmetry, UPLO,
                                      device="cpu"))
    op = approx.distributed_operator
    assert len(approx.build_profile["block_row_s"]) == 3
    x = np.random.RandomState(6).rand(_N, 2)
    assert _rel(op @ x, A @ x) < eps
    # the extracted diagonal blocks are the partition-diagonal of A
    perm = cluster.get_permutation()
    for p, diag in enumerate(approx.block_diagonal_hmatrix):
        t_off, t_sz = int(op.t_offsets[p]), int(op.t_sizes[p])
        idx = perm[t_off:t_off + t_sz]
        D = A[np.ix_(idx, idx)]
        assert np.linalg.norm(diag.to_dense() - D) < eps * np.linalg.norm(D)
    info = op.get_distributed_information()
    assert info["Number_of_partitions"] == "3"
    assert int(info["Number_of_rows"]) == _N


def test_local_builder_holds_the_diagonal_blocks():
    """DefaultLocalApproximationBuilder compresses only each partition's
    diagonal block, which is also its block diagonal."""
    points = _points(seed=13)
    A = _real_oracle(points)
    cluster = _clusters(points, 2)[1]
    eps = 1e-4
    approx = T.DefaultLocalApproximationBuilder(
        T.KernelGenerator(pk(0.1), points, points, device="cpu"), cluster,
        cluster, T.HMatrixTreeBuilder(eps, 10.0, "N", "N", device="cpu"))
    assert approx.block_diagonal_hmatrix is approx.hmatrix
    perm = cluster.get_permutation()
    op = approx.distributed_operator
    x = np.random.RandomState(14).rand(_N)
    A_bd = np.zeros_like(A)
    for p in range(2):
        t_off, t_sz = int(op.t_offsets[p]), int(op.t_sizes[p])
        idx = perm[t_off:t_off + t_sz]
        A_bd[np.ix_(idx, idx)] = A[np.ix_(idx, idx)]
    assert _rel(op * x, A_bd @ x) < eps


def test_information_matches_reference(reference_rows):
    ref, port_cluster, _ = reference_rows(np.float64, "S", 3)
    assert (_port_operator(ref, port_cluster).get_distributed_information()
            == ref.distributed_operator.get_distributed_information())


class _DenseRows(T.RestrictedGlobalToLocalOperator):
    """A custom global-to-local operator: rows of a dense matrix."""

    def __init__(self, A, target, source):
        super().__init__(target, source)
        self.A = A

    def add_vector_product(self, trans, alpha, input, beta, output):
        output *= beta
        output += alpha * (self.A @ input)

    add_matrix_product_row_major = add_vector_product


class _DenseDiagonal(T.VirtualLocalToLocalOperator):
    def __init__(self, A, target, source):
        super().__init__(target, source)
        self.A = A

    def local_add_vector_product(self, trans, alpha, input, beta, output):
        output *= beta
        output += alpha * (self.A @ input)

    local_add_matrix_product_row_major = local_add_vector_product


def test_custom_local_operators():
    points = _points(seed=7)
    A = _real_oracle(points)
    cluster = _clusters(points, 2)[1]
    perm = cluster.get_permutation()
    A_int = A[np.ix_(perm, perm)]
    full = T.LocalRenumbering(0, _N, perm)
    ops = []
    for p in range(2):
        node = cluster.get_cluster_on_partition(p)
        t0, ts = node.get_offset(), node.get_size()
        target = T.LocalRenumbering(node)
        # off-diagonal columns through a custom operator, the diagonal
        # block through a local-to-local one
        off = A_int[t0:t0 + ts].copy()
        off[:, t0:t0 + ts] = 0
        ops.append(_DenseRows(off, target, full))
        ops.append(_DenseDiagonal(A_int[t0:t0 + ts, t0:t0 + ts], target,
                                  target))
    op = T.CustomApproximationBuilder(cluster, cluster, None, ops,
                                      device="cpu").distributed_operator
    assert not op.device_apply_available()
    x = np.random.RandomState(8).rand(_N, 3)
    assert _rel(op @ x, A @ x) <= 1e-12
    assert _rel(op * x[:, 0], A @ x[:, 0]) <= 1e-12
    # the in-place contract: out <- beta * out + alpha * op(in)
    out0 = np.random.RandomState(9).rand(ops[0].A.shape[0])
    out = out0.copy()
    ops[0].add_vector_product("N", 2.0, x[perm, 0], 3.0, out)
    assert np.allclose(out, 3.0 * out0 + 2.0 * (ops[0].A @ x[perm, 0]),
                       rtol=1e-14)
    # the windowed local-to-local product: the input is zero outside it
    diag = ops[3]
    s = diag.local_source_renumbering
    window = x[perm[s.offset + 10:s.offset + 50], 0]
    got = np.zeros(s.size)
    diag.add_sub_matrix_product_to_local("N", 1.0, window, 0.0, got,
                                         s.offset + 10, 40)
    xz = np.zeros(s.size)
    xz[10:50] = window
    assert np.allclose(got, diag.A @ xz, rtol=1e-14)


def test_device_apply_sees_in_place_change_to_a_dense_piece():
    points = _points(n=120, seed=10)
    A = _real_oracle(points)
    cluster = _clusters(points, 2, leaf=16)[1]
    perm = cluster.get_permutation()
    A_int = A[np.ix_(perm, perm)]
    full = T.LocalRenumbering(0, 120, perm)
    pieces = []
    for p in range(2):
        node = cluster.get_cluster_on_partition(p)
        t0, ts = node.get_offset(), node.get_size()
        pieces.append(T.LocalDenseMatrix(A_int[t0:t0 + ts].copy(),
                                         T.LocalRenumbering(node), full))
    op = T.CustomApproximationBuilder(cluster, cluster, None, pieces,
                                      device="cpu").distributed_operator
    assert op.device_apply_available()
    x = torch.as_tensor(np.random.RandomState(11).rand(120, 2))
    y1 = op.build_device_apply()(x).numpy()
    assert _rel(y1, A @ x.numpy()) <= 1e-12
    pieces[1].data *= 2.0  # in place
    A2 = A.copy()
    rows = perm[cluster.get_cluster_on_partition(1).get_offset():]
    A2[rows] *= 2.0
    y2 = op.build_device_apply()(x).numpy()
    assert _rel(y2, A2 @ x.numpy()) <= 1e-12
    assert _rel(op @ x.numpy(), A2 @ x.numpy()) <= 1e-12


def test_cluster_csv_round_trip(tmp_path):
    points = _points(seed=12)
    ref_cluster, port_cluster = _clusters(points, 3)
    T.write_cluster_to(port_cluster, str(tmp_path / "p.csv"),
                       str(tmp_path / "t.csv"))
    back = H.read_cluster_from(str(tmp_path / "p.csv"),
                               str(tmp_path / "t.csv"))
    H.write_cluster_to(ref_cluster, str(tmp_path / "rp.csv"),
                       str(tmp_path / "rt.csv"))
    mine = T.read_cluster_from(str(tmp_path / "rp.csv"),
                               str(tmp_path / "rt.csv"))
    for a, b in ((back, ref_cluster), (mine, port_cluster)):
        assert np.array_equal(a.get_permutation(), b.get_permutation())
        assert a.nb_partitions() == b.nb_partitions() == 3
        for p in range(3):
            assert (a.get_cluster_on_partition(p).get_offset(),
                    a.get_cluster_on_partition(p).get_size()) == (
                b.get_cluster_on_partition(p).get_offset(),
                b.get_cluster_on_partition(p).get_size())
    (tmp_path / "bad.csv").write_text("not,a,header\n")
    with pytest.raises(ValueError, match="cluster CSV format"):
        T.read_cluster_from(str(tmp_path / "bad.csv"), str(tmp_path / "t.csv"))
