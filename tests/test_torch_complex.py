"""The port's complex path against the reference, in complex128 (CPU).

* The plain version of kernel K2 (the port's `apply_hmatrix_padded`) on
  complex bucket arrays the reference assembled, carried over with
  `from_reference_data`, for trans N/T/C x storage N, H-L, H-U, S-L x
  k in {1, 3}: both sum in a fixed order on the CPU, so they agree to
  1e-12 relative.
* Independent complex assemblies of the hermitian kernel
  exp(10i (x0 - y0)) / (0.1 + r) on the unit sphere, storage N and H-L,
  eps in {1e-4, 1e-6}: the port's operator (batched ACA) meets eps against
  the dense kernel matrix (the reference's contract, tests/test_hmatrix.py),
  and agrees with the reference's operator to 2 eps relative to the dense
  matrix.

The reference assembles through its host-generator path (a numpy SVD per
block, then its own bucketing and rank-class packing): the same buckets
and storage layout as its device path, without the XLA compiles that make
a device assembly cost seconds here.
* K1's route for a complex x on a real f32 operator (`cuda_matvec._launch`
  with its real views `_real_view`: H (a + ib) = H a + i H b over the
  (L, 2k) real views of x and of the zeroed y), run here with the
  plain version as its real product, against the plain version on the
  complex x and against the reference's product.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import threadpoolctl
import torch

import htool_python_torch as T
import htool_python_tpu as H
from htool_python_torch import interop
from htool_python_torch.hmatrix.plan import build_block_plan
from htool_python_torch.models.geometry import create_random_points_on_sphere
from htool_python_torch.models.kernels import hermitian_phase_kernel as pk
from htool_python_torch.ops import cuda_matvec
from htool_python_torch.ops import matvec as port_mv
from htool_python_tpu.ops import matvec as ref_mv

_STORAGES = [("N", "N"), ("H", "L"), ("H", "U"), ("S", "L")]
_N, _LEAF = 400, 32


def sphere(n=_N, seed=1):
    return create_random_points_on_sphere(n, np.random.RandomState(seed))


def hermitian_oracle(points):
    d = np.linalg.norm(points[:, :, None] - points[:, None, :], axis=0)
    return np.exp(1j * 10.0 * (points[0][:, None] - points[0][None, :])) / (
        0.1 + d)


def symmetric_matrix(points):
    """A complex-symmetric, not hermitian matrix: the reference's own 'S'
    case (tests/test_pallas_matvec.py), exp(2i r) / (0.1 + r) off the
    diagonal and n on it."""
    n = points.shape[1]
    d = np.linalg.norm(points[:, :, None] - points[:, None, :], axis=0)
    A = np.exp(1j * 2.0 * d) / (0.1 + d + np.eye(n))
    np.fill_diagonal(A, n)
    return A


def clusters(points, leaf=_LEAF):
    out = []
    for pkg in (H, T):
        builder = pkg.ClusterTreeBuilder()
        builder.set_maximal_leaf_size(leaf)
        out.append(builder.create_cluster_tree(points, 2))
    return out


class ReferenceHostGenerator(H.VirtualGenerator):
    """Entries of a dense matrix through the reference's host path."""

    def __init__(self, matrix):
        super().__init__()
        self.matrix = matrix
        self.is_complex = np.iscomplexobj(matrix)

    def build_submatrix(self, J, K, mat):
        mat[:, :] = self.matrix[np.ix_(np.asarray(J), np.asarray(K))]


def reference_complex_operator(symmetry, UPLO, dtype, eps=1e-6, n=_N,
                               leaf=_LEAF):
    """(reference H-matrix, port cluster, points): the hermitian kernel,
    or for 'S' the complex-symmetric matrix."""
    points = sphere(n)
    ref_cluster, port_cluster = clusters(points, leaf)
    gen = ReferenceHostGenerator(symmetric_matrix(points) if symmetry == "S"
                                 else hermitian_oracle(points))
    hb = H.HMatrixTreeBuilder(eps, 10.0, symmetry, UPLO)
    hb.set_dtype(dtype)
    return hb.build(gen, ref_cluster, ref_cluster), port_cluster, points


def port_operator(hm, port_cluster):
    """The port HMatrix holding the reference's assembled arrays, with its
    SVD-form flag."""
    plan = build_block_plan(port_cluster, port_cluster, hm.eta, hm.symmetry,
                            hm.UPLO)
    plan = interop.plan_from_reference(plan, hm.plan)
    dense = [np.asarray(D) for D, *_ in hm._data["dense"]]
    lr = [(np.asarray(Ut), np.asarray(V)) for Ut, V, *_ in hm._data["lr"]]
    return T.HMatrix.from_arrays(plan, dense, lr, hm._lr_ranks, hm.epsilon,
                                 np.asarray(hm._data["dense"][0][0]).dtype,
                                 "cpu", lr_svd_form=hm._lr_svd_form)


def random_pad(L, n, k, seed, dtype=np.complex128):
    rng = np.random.RandomState(seed)
    x = np.zeros((L, k), dtype)
    x[:n] = rng.rand(n, k) + 1j * rng.rand(n, k)
    return x


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The suite runs several pytest workers on one machine; the OpenMP
    (torch) and OpenBLAS (numpy) threads in each, as many as the cores and
    spinning between calls, would oversubscribe the cores and slow every
    worker several times over, so these small problems run on one
    thread."""
    with threadpoolctl.threadpool_limits(1):
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        yield
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def c128_operators():
    return {sym: reference_complex_operator(*sym, np.complex128)
            for sym in _STORAGES}


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("trans", ["N", "T", "C"])
@pytest.mark.parametrize("symmetry,UPLO", _STORAGES)
def test_plain_k2_matches_reference_c128(c128_operators, symmetry, UPLO,
                                         trans, k):
    hm = c128_operators[(symmetry, UPLO)][0]
    np_tree = jax.tree_util.tree_map(np.asarray, hm._data)
    data = interop.from_reference_data(np_tree, "cpu")
    assert data["lr"] and data["lr"][0][0].dtype == torch.complex128
    L, n = hm._pad_len, hm.shape[0]
    x_pad = random_pad(L, n, k, seed=k)
    y_ref = np.asarray(ref_mv.apply_hmatrix_padded(
        hm._data, jnp.asarray(x_pad), L, trans, symmetry))
    x_t = torch.as_tensor(x_pad)
    y_plain = port_mv.apply_hmatrix_padded(data, x_t, L, trans, symmetry)
    assert _rel(y_plain.numpy(), y_ref) <= 1e-12
    # the kernels' wrapper runs the plain version on CPU tensors
    y_wrap = cuda_matvec.apply_hmatrix_cuda(data, x_t, L, trans, symmetry)
    assert torch.equal(y_wrap, y_plain)


@pytest.mark.parametrize("symmetry,UPLO", [("N", "N"), ("H", "L")])
@pytest.mark.parametrize("eps", [1e-4, 1e-6])
def test_complex_assembly_matches_oracle_and_reference(c128_operators, eps,
                                                       symmetry, UPLO):
    if eps == 1e-6:  # the module's reference operators
        ref, port_cluster, points = c128_operators[(symmetry, UPLO)]
    else:
        ref, port_cluster, points = reference_complex_operator(
            symmetry, UPLO, np.complex128, eps=eps)
    A = hermitian_oracle(points)
    hb = T.HMatrixTreeBuilder(eps, 10.0, symmetry, UPLO, device="cpu")
    hb.set_dtype(torch.complex128)
    port = hb.build(T.KernelGenerator(pk(10.0), points, points,
                                      is_complex=True, device="cpu"),
                    port_cluster, port_cluster)
    assert port._lr_svd_form and port.dtype == torch.complex128
    D_port = port.to_dense_in_user_numbering()
    assert np.linalg.norm(D_port - A) <= eps * np.linalg.norm(A)
    rng = np.random.RandomState(4)
    x = rng.rand(_N) + 1j * rng.rand(_N)
    for trans, At in (("N", A), ("T", A.T), ("C", A.conj().T)):
        assert _rel(port.matvec(x, trans), At @ x) < eps
    D_ref = ref.to_dense_in_user_numbering()
    assert np.linalg.norm(D_port - D_ref) <= 2 * eps * np.linalg.norm(A)


@pytest.fixture(scope="module")
def f32_operator():
    points = np.random.RandomState(3).rand(3, 300)
    ref_cluster = clusters(points, 24)[0]
    d = np.linalg.norm(points[:, :, None] - points[:, None, :], axis=0)
    hb = H.HMatrixTreeBuilder(1e-4, 10.0, "S", "L")
    hb.set_dtype(np.float32)
    return hb.build(ReferenceHostGenerator(1.0 / (0.1 + d)), ref_cluster,
                    ref_cluster)


@pytest.mark.parametrize("trans", ["N", "T", "C"])
def test_real_view_route_for_complex_x(f32_operator, trans):
    hm = f32_operator
    data = interop.from_reference_data(
        jax.tree_util.tree_map(np.asarray, hm._data), "cpu")
    L, n = hm._pad_len, hm.shape[0]
    x = torch.as_tensor(random_pad(L, n, 3, seed=9, dtype=np.complex64))
    y_plain = port_mv.apply_hmatrix_padded(data, x, L, trans, "S")
    assert y_plain.dtype == torch.complex64
    y_view = torch.zeros((L, 3), dtype=torch.complex64)
    cuda_matvec._real_view(y_view).add_(port_mv.apply_hmatrix_padded(
        data, cuda_matvec._real_view(x), L, trans, "S"))
    assert y_view.dtype == torch.complex64
    assert _rel(y_view.numpy(), y_plain.numpy()) <= 1e-6
    y_ref = np.asarray(ref_mv.apply_hmatrix_padded(
        hm._data, jnp.asarray(x.numpy()), L, trans, "S"))
    assert _rel(y_view.numpy(), y_ref) <= 1e-6
