"""The custom low-rank and dense-block hooks against the reference (CPU).

The same user callbacks, written once against each package's base classes
(the arithmetic of the reference's tests/conftest.py `CustomSVDLowRank` and
`CustomDenseBlocksGenerator`), build an H-matrix in both packages from the
same matrix: equal plans, equal ranks, products within 1e-12 in float64
(and complex128).  Also the reference's cases of tests/test_hmatrix.py
(`use_custom_lrg`, the constructor's `low_rank_strategy` and its type
check, recompression after a custom build): a False return densifies, the
dense-blocks hook is called once with every dense leaf, `allow_copy=False`
keeps the arrays until `clear_data()`.

The reference assembles through its host path (the hooks turn its device
ACA off, and the reference generator here is a host generator): no XLA
compile.
"""

import math

import numpy as np
import pytest
import torch

import htool_python_torch as T
import htool_python_tpu as H
from test_torch_complex import ReferenceHostGenerator, one_thread  # noqa: F401

_N, _LEAF, _EPS, _ETA = 400, 16, 1e-4, 10.0


def _points(n=_N, seed=4):
    return np.random.RandomState(seed).rand(3, n)


def _matrix(points, dtype):
    d = np.linalg.norm(points[:, :, None] - points[:, None, :], axis=0)
    if dtype == np.complex128:
        return np.exp(1j * 5.0 * (points[0][:, None] - points[0][None, :])) / (
            0.1 + d)
    return 1.0 / (0.1 + d)


def _svd_hook(base):
    """The reference's CustomSVDLowRank (tests/conftest.py:169) on `base`,
    counting its calls."""

    class CustomSVD(base):
        def __init__(self, matrix, allow_copy=True):
            super().__init__(allow_copy)
            self.matrix = matrix
            self.calls = 0

        def build_low_rank_approximation(self, rows, cols, epsilon):
            self.calls += 1
            submat = self.matrix[np.ix_(rows, cols)]
            u, s, vh = np.linalg.svd(submat, full_matrices=False)
            norm = np.linalg.norm(submat)
            svd_norm = 0.0
            trunc = len(s) - 1
            while trunc > 0 and math.sqrt(svd_norm) / norm < epsilon:
                svd_norm += s[trunc] ** 2
                trunc -= 1
            trunc += 1
            if trunc * (len(rows) + len(cols)) > len(rows) * len(cols):
                return False
            self.set_U(u[:, :trunc] * s[:trunc])
            self.set_V(vh[:trunc, :])
            return True

    return CustomSVD


def _dense_hook(base):
    """The reference's CustomDenseBlocksGenerator (tests/conftest.py:195),
    recording each call's blocks."""

    class CustomDense(base):
        def __init__(self, matrix):
            super().__init__()
            self.matrix = matrix
            self.calls = []

        def build_dense_blocks(self, rows_offsets, cols_offsets, blocks):
            self.calls.append([(b.shape, b.flags["F_CONTIGUOUS"],
                                not b.any()) for b in blocks])
            for rows, cols, block in zip(rows_offsets, cols_offsets, blocks):
                block[:, :] = self.matrix[np.ix_(rows, cols)]

    return CustomDense


def _clusters(points):
    out = []
    for pkg in (H, T):
        b = pkg.ClusterTreeBuilder()
        b.set_maximal_leaf_size(_LEAF)
        out.append(b.create_cluster_tree(points, 2))
    return out


def _build(pkg, cluster, A, symmetry, lrg=None, dbg=None, ctor=False):
    UPLO = "L" if symmetry != "N" else "N"
    kwargs = {} if pkg is H else {"device": "cpu"}
    if ctor:
        hb = pkg.HMatrixTreeBuilder(_EPS, _ETA, symmetry, UPLO, -1, lrg,
                                    **kwargs)
    else:
        hb = pkg.HMatrixTreeBuilder(_EPS, _ETA, symmetry, UPLO, **kwargs)
        if lrg is not None:
            hb.set_low_rank_generator(lrg)
    if dbg is not None:
        hb.set_dense_blocks_generator(dbg)
    hb.set_dtype(A.dtype)
    gen = (ReferenceHostGenerator(A) if pkg is H
           else T.MatrixGenerator(A, device="cpu"))
    return hb.build(gen, cluster, cluster)


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _buckets(h):
    return [(b.pt, b.ps, b.t_off.tolist(), b.s_off.tolist())
            for b in h.plan.dense_buckets + h.plan.lowrank_buckets]


@pytest.mark.parametrize("ctor", [False, True])
@pytest.mark.parametrize("symmetry,dtype", [("N", np.float64),
                                            ("S", np.float64),
                                            ("N", np.complex128)])
def test_custom_build_matches_reference(symmetry, dtype, ctor):
    points = _points()
    A = _matrix(points, dtype)
    if symmetry == "S":
        A = (A + A.T) / 2
    ref_cluster, port_cluster = _clusters(points)
    hooks = {}
    for pkg in (H, T):
        lrg = _svd_hook(pkg.VirtualLowRankGenerator)(A)
        dbg = _dense_hook(pkg.VirtualDenseBlocksGenerator)(A)
        cluster = ref_cluster if pkg is H else port_cluster
        hooks[pkg] = (_build(pkg, cluster, A, symmetry, lrg, dbg, ctor),
                      lrg, dbg)
    (ref, ref_lrg, ref_dbg), (port, lrg, dbg) = hooks[H], hooks[T]
    # the same callbacks on the same blocks: equal plans and ranks
    assert lrg.calls == ref_lrg.calls > 0
    assert len(dbg.calls) == len(ref_dbg.calls) == 1
    assert dbg.calls == ref_dbg.calls
    assert _buckets(port) == _buckets(ref)
    assert len(port._lr_ranks) == len(ref._lr_ranks) > 0
    for r_port, r_ref in zip(port._lr_ranks, ref._lr_ranks):
        assert np.array_equal(r_port, np.asarray(r_ref))
    assert not port._lr_svd_form and not ref._lr_svd_form
    assert port.dtype == torch.float64 if dtype == np.float64 else \
        port.dtype == torch.complex128
    rng = np.random.RandomState(1)
    X = rng.rand(_N, 3) + (1j * rng.rand(_N, 3) if dtype == np.complex128
                           else 0)
    for trans in ("N", "T", "C"):
        y_ref = np.asarray(ref.matvec(X, trans))
        assert _rel(port.matvec(X, trans), y_ref) <= 1e-12
    assert _rel(port * X[:, 0], A @ X[:, 0]) < _EPS
    assert _rel(port.to_dense_in_user_numbering(),
                np.asarray(ref.to_dense_in_user_numbering())) <= 1e-12


@pytest.mark.parametrize("pkg", [H, T], ids=["reference", "port"])
def test_false_densifies(pkg):
    """A hook that returns False for every block: no low-rank bucket, the
    operator exact (every leaf dense)."""
    points = _points(200)
    A = _matrix(points, np.float64)
    cluster = _clusters(points)[0 if pkg is H else 1]

    class Never(pkg.VirtualLowRankGenerator):
        calls = 0

        def build_low_rank_approximation(self, rows, cols, epsilon):
            Never.calls += 1
            return False

    lrg = Never()
    h = _build(pkg, cluster, A, "N", lrg)
    assert Never.calls > 0
    assert h.plan.lowrank_buckets == [] and not h._lr_svd_form
    x = np.random.RandomState(2).rand(200)
    assert _rel(h * x, A @ x) <= 1e-13


def test_dense_blocks_hook_called_once_with_every_leaf():
    """One call, with every dense leaf of the build (the blocks the
    low-rank test densified included), each zeroed and Fortran-ordered;
    the product equals the port's build without the hook."""
    points = _points()
    A = _matrix(points, np.float64)
    cluster = _clusters(points)[1]
    dbg = _dense_hook(T.VirtualDenseBlocksGenerator)(A)
    h = _build(T, cluster, A, "N", dbg=dbg)
    plain = _build(T, cluster, A, "N")
    assert len(dbg.calls) == 1
    leaves = dbg.calls[0]
    assert len(leaves) == sum(b.nb for b in h.plan.dense_buckets)
    assert all(fortran and zeroed for _, fortran, zeroed in leaves)
    sizes = sorted(shape for shape, _, _ in leaves)
    assert sizes == sorted((int(t), int(s)) for b in h.plan.dense_buckets
                           for t, s in zip(b.t_sz, b.s_sz))
    assert h._lr_svd_form  # the low-rank blocks still come from ACA
    x = np.random.RandomState(3).rand(_N)
    assert _rel(h * x, plain * x) <= 1e-12
    assert _rel(h * x, A @ x) < _EPS


def test_allow_copy_false_keeps_arrays_until_clear_data():
    points = _points(300)
    A = _matrix(points, np.float64)
    cluster = _clusters(points)[1]
    lrg = _svd_hook(T.VirtualLowRankGenerator)(A, allow_copy=False)
    h = _build(T, cluster, A, "N", lrg)
    n_kept = sum(len(r) for r in h._lr_ranks)
    n_ok = len(lrg._stored) // 2
    assert n_ok >= n_kept > 0  # densified by the worthwhile test: kept too
    lrg.clear_data()
    assert lrg._stored == []
    # the operator owns copies: unchanged by clear_data
    x = np.random.RandomState(4).rand(300)
    assert _rel(h * x, A @ x) < _EPS


def test_low_rank_strategy_type_check():
    """`low_rank_strategy` is the constructor's spelling of
    set_low_rank_generator (reference tests/test_hmatrix.py:376);
    anything without `build_low_rank_approximation` raises."""
    lrg = _svd_hook(T.VirtualLowRankGenerator)(np.eye(2))
    hb = T.HMatrixTreeBuilder(1e-3, 100.0, "N", "N", -1, lrg, device="cpu")
    assert hb._low_rank_generator is lrg and hb.low_rank_strategy is lrg
    for bad in ("partialACA", object()):
        with pytest.raises(TypeError, match="VirtualLowRankGenerator"):
            T.HMatrixTreeBuilder(1e-3, 100.0, "N", "N", -1, bad,
                                 device="cpu")
    assert T.ComplexVirtualLowRankGenerator is T.VirtualLowRankGenerator
    assert (T.ComplexVirtualDenseBlocksGenerator
            is T.VirtualDenseBlocksGenerator)


def test_recompression_after_custom_build():
    """A custom build's factors are of unknown form, so recompression takes
    the general path (QR + SVD), in both packages, to the same ranks."""
    points = _points()
    A = _matrix(points, np.float64)
    ref_cluster, port_cluster = _clusters(points)
    ref = _build(H, ref_cluster, A, "N",
                 _svd_hook(H.VirtualLowRankGenerator)(A))
    port = _build(T, port_cluster, A, "N",
                  _svd_hook(T.VirtualLowRankGenerator)(A))
    assert not port._lr_svd_form
    H.recompression(ref, 1e-3)
    T.recompression(port, 1e-3)
    assert [np.asarray(r).tolist() for r in ref._lr_ranks] == [
        r.tolist() for r in port._lr_ranks]
    x = np.random.RandomState(5).rand(_N)
    assert _rel(port * x, np.asarray(ref * x)) <= 1e-12
    assert _rel(port * x, A @ x) < 1e-3
