"""Kernels K1 and K2 (one body, csrc/hmatrix_product.cu) against their
plain version on the card, in each launch structure, K1-al on the aligned
low-rank layout, the HODLR factorization through K1 and K1-al, one- and
two-level (GenEO) DDM solves on the golden data, the profiling path's
kernels P1-P4 and K1's attribution sweeps, the float64 / complex128 kernels
(csrc/hmatrix_product_f64.cu, also on float32 / complex64 data with a
float64 / complex128 x; within 1e-12, f64 atomics), the sharded
operator on a world-1 NCCL group, and the user-numbering product's
permutation kernels (bit for bit) around every product kernel (skips
without a card).

Run on a machine with a CUDA device:
    python -m pytest --noconftest tests/test_torch_gpu.py
(--noconftest: the suite's conftest imports JAX, which this file does not
need and a GPU machine may lack.)
The kernels add into y with f32 atomics in an order that changes from run
to run, so they agree with the plain version to 1e-5 relative (P3's
'xgemm' runs in TF32: `bucket_variants.kernel_tolerance`).
"""

import pathlib
import struct

import numpy as np
import pytest
import torch

import htool_python_torch as T
from htool_python_torch.config import get_config
from htool_python_torch.models.geometry import \
    create_random_points_on_sphere
from htool_python_torch.models.kernels import (hermitian_phase_kernel,
                                               inverse_distance_kernel)
from htool_python_torch.ops import cuda_matvec
from htool_python_torch.ops.matvec import apply_hmatrix_padded


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
def test_k1_matches_plain_version(cuda_device):
    points = np.random.RandomState(0).rand(3, 3000)
    builder = T.ClusterTreeBuilder()
    builder.set_maximal_leaf_size(64)
    cluster = builder.create_cluster_tree(points, 2)
    gen = T.KernelGenerator(inverse_distance_kernel(0.1), points, points,
                            device=cuda_device)
    for symmetry, UPLO in (("N", "N"), ("S", "L"), ("S", "U")):
        hb = T.HMatrixTreeBuilder(1e-3, 10.0, symmetry, UPLO,
                                  device=cuda_device)
        hb.set_dtype(torch.float32)
        hm = hb.build(gen, cluster, cluster)
        L = hm._pad_len
        for trans in ("N", "T"):
            for k in (1, 2, 3, 8, 11, 12):
                x = torch.zeros((L, k), device=cuda_device)
                x[:3000] = torch.rand((3000, k), device=cuda_device,
                                      generator=torch.Generator(
                                          cuda_device).manual_seed(k))
                y = cuda_matvec.apply_hmatrix_cuda(hm._data, x, L, trans,
                                                   symmetry)
                y_plain = apply_hmatrix_padded(hm._data, x, L, trans,
                                               symmetry)
                err = (y - y_plain).abs().max() / y_plain.abs().max()
                assert err <= 1e-5, (symmetry, UPLO, trans, k, float(err))
        # user numbering: a tensor on the card stays there, numpy comes back
        x_user = torch.rand(3000, device=cuda_device,
                            generator=torch.Generator(cuda_device).manual_seed(1))
        y_dev = hm.matvec(x_user)
        assert y_dev.device == x_user.device
        y_host = hm.matvec(x_user.cpu().numpy())
        assert (np.linalg.norm(y_dev.cpu().numpy() - y_host)
                <= 1e-5 * np.linalg.norm(y_host))
    # a float64 x on float32 data: the operator promoted, as in the
    # reference, through hmatrix_product_f64_from_f32 (f64 atomics)
    before = cuda_matvec.LAUNCH_COUNTS[cuda_matvec.F64_F32_NAME]
    y = cuda_matvec.apply_hmatrix_cuda(hm._data, x.double(), L, "N",
                                       symmetry)
    assert cuda_matvec.LAUNCH_COUNTS[cuda_matvec.F64_F32_NAME] == before + 1
    y_plain = apply_hmatrix_padded(hm._data, x.double(), L, "N", symmetry)
    assert y.dtype == y_plain.dtype == torch.float64
    assert (y - y_plain).abs().max() <= 1e-12 * y_plain.abs().max()
    # a y one row short of the furthest block segment is refused
    table = hm._bucket_table()
    with pytest.raises(ValueError, match="past x"):
        cuda_matvec.apply_hmatrix_cuda(hm._data, x[:table.extent],
                                       table.extent - 1, "N", symmetry, table)


def _symmetric_phase_kernel(x, y):
    """exp(10 i r) / (0.1 + r): complex and symmetric, not hermitian."""
    r = torch.sqrt(torch.sum((x - y) ** 2, dim=-1))
    return torch.exp(10j * r) / (0.1 + r)


def _complex_operators(device, n=3000, eps=1e-4):
    points = create_random_points_on_sphere(n, np.random.RandomState(1))
    builder = T.ClusterTreeBuilder()
    builder.set_maximal_leaf_size(64)
    cluster = builder.create_cluster_tree(points, 2)
    ops = {}
    for symmetry, UPLO, kernel in (
            ("N", "N", hermitian_phase_kernel(10.0)),
            ("H", "L", hermitian_phase_kernel(10.0)),
            ("H", "U", hermitian_phase_kernel(10.0)),
            ("S", "L", _symmetric_phase_kernel)):
        hb = T.HMatrixTreeBuilder(eps, 10.0, symmetry, UPLO, device=device)
        hb.set_dtype(torch.complex64)
        ops[symmetry, UPLO] = hb.build(
            T.KernelGenerator(kernel, points, points, is_complex=True,
                              device=device), cluster, cluster)
    return ops


@pytest.mark.gpu
def test_k2_matches_plain_version(cuda_device):
    for (symmetry, UPLO), hm in _complex_operators(cuda_device).items():
        L, n = hm._pad_len, hm.shape[0]
        table = hm._bucket_table()
        assert table.dtype == torch.complex64
        for trans in ("N", "T", "C"):
            for k in (1, 2, 3, 8):
                g = torch.Generator(cuda_device).manual_seed(k)
                x = torch.zeros((L, k), dtype=torch.complex64,
                                device=cuda_device)
                x[:n] = torch.complex(
                    torch.rand((n, k), device=cuda_device, generator=g),
                    torch.rand((n, k), device=cuda_device, generator=g))
                before = cuda_matvec.LAUNCH_COUNTS[cuda_matvec.K2_NAME]
                y = cuda_matvec.apply_hmatrix_cuda(hm._data, x, L, trans,
                                                   symmetry, table)
                assert (cuda_matvec.LAUNCH_COUNTS[cuda_matvec.K2_NAME]
                        == before + 1)
                y_plain = apply_hmatrix_padded(hm._data, x, L, trans,
                                               symmetry)
                err = (y - y_plain).abs().max() / y_plain.abs().max()
                assert err <= 1e-5, (symmetry, UPLO, trans, k, float(err))
        # a real f32 x is promoted, and K2 still runs
        xr = torch.rand((L, 3), device=cuda_device)
        y = cuda_matvec.apply_hmatrix_cuda(hm._data, xr, L, "N", symmetry,
                                           table)
        y_plain = apply_hmatrix_padded(hm._data, xr, L, "N", symmetry)
        assert y.dtype == torch.complex64
        assert (y - y_plain).abs().max() <= 1e-5 * y_plain.abs().max()
    # a complex128 x on complex64 data: the operator promoted, through
    # hmatrix_product_complex128_from_c64 (f64 atomics)
    before = cuda_matvec.LAUNCH_COUNTS[cuda_matvec.C128_C64_NAME]
    x = x.to(torch.complex128)
    y = cuda_matvec.apply_hmatrix_cuda(hm._data, x, L, "N", symmetry, table)
    assert cuda_matvec.LAUNCH_COUNTS[cuda_matvec.C128_C64_NAME] == before + 1
    y_plain = apply_hmatrix_padded(hm._data, x, L, "N", symmetry)
    assert y.dtype == y_plain.dtype == torch.complex128
    assert (y - y_plain).abs().max() <= 1e-12 * y_plain.abs().max()


def _complex_x(device, L, n, k, seed):
    g = torch.Generator(device).manual_seed(seed)
    x = torch.zeros((L, k), dtype=torch.complex64, device=device)
    x[:n] = torch.complex(torch.rand((n, k), device=device, generator=g),
                          torch.rand((n, k), device=device, generator=g))
    return x


@pytest.mark.gpu
def test_k2_on_the_work_list_at_wide_and_odd_k(cuda_device):
    """K2 walks the same work list as K1 (its records at 8-byte elements):
    FFMA up to 8 columns, 3xTF32 tensor cores from 9 over the interleaved
    real columns, passes of 64 complex columns; every storage and trans
    against the plain version."""
    for (symmetry, UPLO), hm in _complex_operators(cuda_device).items():
        L, n = hm._pad_len, hm.shape[0]
        table = hm._bucket_table()
        assert len(table.items) == len(table.work.items) > 0
        for trans in ("N", "T", "C"):
            for k in (5, 9, 17, 33, 64, 65, 128):
                x = _complex_x(cuda_device, L, n, k, k)
                before = cuda_matvec.LAUNCH_COUNTS[cuda_matvec.K2_NAME]
                y = cuda_matvec.apply_hmatrix_cuda(hm._data, x, L, trans,
                                                   symmetry, table)
                assert (cuda_matvec.LAUNCH_COUNTS[cuda_matvec.K2_NAME]
                        == before + -(-k // 64))
                y_plain = apply_hmatrix_padded(hm._data, x, L, trans,
                                               symmetry)
                err = (y - y_plain).abs().max() / y_plain.abs().max()
                assert err <= 1e-5, (symmetry, UPLO, trans, k, float(err))


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["fused", "per_bucket", "seq"])
def test_k2_empty_buckets_and_no_columns(cuda_device, launch_mode, mode):
    """Empty buckets launch nothing and change nothing; k = 0 and data
    with only empty buckets give zeros without a launch."""
    launch_mode(mode)
    hm = _complex_operators(cuda_device, n=2000)[("H", "L")]
    data, L, n = hm._data, hm._pad_len, hm.shape[0]
    meta = (torch.zeros(0, dtype=torch.int32, device=cuda_device),
            torch.zeros(0, dtype=torch.int32, device=cuda_device),
            torch.zeros(0, dtype=torch.bool, device=cuda_device))
    D = data["dense"][0][0]
    Ut, V = data["lr"][0][:2]
    empty = {"dense": [(D[:0], *meta)], "lr": [(Ut[:0], V[:0], *meta)]}
    padded = {"dense": empty["dense"] + data["dense"],
              "lr": empty["lr"] + data["lr"]}
    x = _complex_x(cuda_device, L, n, 3, 0)
    y = cuda_matvec.apply_hmatrix_cuda(padded, x, L, "C", "H")
    y_plain = apply_hmatrix_padded(data, x, L, "C", "H")
    assert (y - y_plain).abs().max() <= 1e-5 * y_plain.abs().max()
    before = dict(cuda_matvec.LAUNCH_COUNTS)
    y0 = cuda_matvec.apply_hmatrix_cuda(padded, x[:, :0].contiguous(), L,
                                        "N", "H")
    assert y0.shape == (L, 0) and y0.dtype == torch.complex64
    y_empty = cuda_matvec.apply_hmatrix_cuda(empty, x, L, "N", "H")
    assert y_empty.dtype == torch.complex64 and not y_empty.abs().any()
    assert cuda_matvec.LAUNCH_COUNTS == before


@pytest.mark.gpu
def test_k1_on_the_real_view_of_a_complex_x(cuda_device):
    """A complex x on a real f32 operator runs K1 over its 2k real
    columns (H real: H (a + ib) = H a + i H b)."""
    points = np.random.RandomState(2).rand(3, 3000)
    builder = T.ClusterTreeBuilder()
    builder.set_maximal_leaf_size(64)
    cluster = builder.create_cluster_tree(points, 2)
    for symmetry, UPLO in (("N", "N"), ("S", "L")):
        hb = T.HMatrixTreeBuilder(1e-3, 10.0, symmetry, UPLO,
                                  device=cuda_device)
        hb.set_dtype(torch.float32)
        hm = hb.build(T.KernelGenerator(inverse_distance_kernel(0.1),
                                        points, points, device=cuda_device),
                      cluster, cluster)
        L = hm._pad_len
        for trans in ("N", "T", "C"):
            for k in (1, 4):
                x = torch.zeros((L, k), dtype=torch.complex64,
                                device=cuda_device)
                x[:3000] = torch.randn((3000, k), dtype=torch.complex64,
                                       device=cuda_device)
                before = dict(cuda_matvec.LAUNCH_COUNTS)
                y = cuda_matvec.apply_hmatrix_cuda(hm._data, x, L, trans,
                                                   symmetry)
                assert (cuda_matvec.LAUNCH_COUNTS[cuda_matvec.KERNEL_NAME]
                        == before[cuda_matvec.KERNEL_NAME] + 1)
                assert (cuda_matvec.LAUNCH_COUNTS[cuda_matvec.K2_NAME]
                        == before[cuda_matvec.K2_NAME])
                y_plain = apply_hmatrix_padded(hm._data, x, L, trans,
                                               symmetry)
                err = (y - y_plain).abs().max() / y_plain.abs().max()
                assert err <= 1e-5, (symmetry, trans, k, float(err))


@pytest.mark.gpu
def test_product_after_recompression_on_the_card(cuda_device):
    """Recompression replaces the buckets; the next product must build a
    new bucket table (the old one names freed tensors)."""
    hm = _complex_operators(cuda_device, n=2000, eps=1e-6)[("H", "L")]
    n = hm.shape[0]
    hm * np.ones(n, np.complex64)  # builds the bucket table
    bytes_before = sum(t.numel() * t.element_size()
                       for e in hm._data["dense"] + hm._data["lr"]
                       for t in e[:-3])
    T.recompression(hm, 1e-4)
    bytes_after = sum(t.numel() * t.element_size()
                      for e in hm._data["dense"] + hm._data["lr"]
                      for t in e[:-3])
    assert bytes_after < bytes_before
    x = (np.random.RandomState(3).rand(n)
         + 1j * np.random.RandomState(4).rand(n)).astype(np.complex64)
    for trans in ("N", "T", "C"):
        A = hm.to_dense_in_user_numbering()
        A = {"N": A, "T": A.T, "C": A.conj().T}[trans]
        y = hm.matvec(x, trans)
        assert np.linalg.norm(y - A @ x) <= 1e-5 * np.linalg.norm(A @ x)


@pytest.fixture
def launch_mode():
    """Sets config.matvec_kernel_mode for one test and restores 'fused'."""
    cfg = get_config()
    yield lambda mode: setattr(cfg, "matvec_kernel_mode", mode)
    cfg.matvec_kernel_mode = "fused"


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["per_bucket", "seq"])
def test_launch_structures_match_plain_version(cuda_device, launch_mode,
                                               mode):
    """K1-pb / K1-seq and K2-pb / K2-seq: every storage case, against the
    plain version, each counted under its own name (a per-bucket product
    once per bucket)."""
    launch_mode(mode)
    points = np.random.RandomState(0).rand(3, 3000)
    builder = T.ClusterTreeBuilder()
    builder.set_maximal_leaf_size(64)
    cluster = builder.create_cluster_tree(points, 2)
    ops = {}
    for symmetry, UPLO in (("N", "N"), ("S", "L"), ("S", "U")):
        hb = T.HMatrixTreeBuilder(1e-3, 10.0, symmetry, UPLO,
                                  device=cuda_device)
        hb.set_dtype(torch.float32)
        ops[symmetry, UPLO] = hb.build(
            T.KernelGenerator(inverse_distance_kernel(0.1), points, points,
                              device=cuda_device), cluster, cluster)
    ops.update(_complex_operators(cuda_device))
    for (symmetry, UPLO), hm in ops.items():
        L, n = hm._pad_len, hm.shape[0]
        table = hm._bucket_table()
        name = cuda_matvec.launch_name(
            cuda_matvec.KERNEL_NAME if hm.dtype == torch.float32
            else cuda_matvec.K2_NAME, mode)
        for trans in ("N", "T", "C"):
            for k in (1, 3, 8, 11):
                g = torch.Generator(cuda_device).manual_seed(k)
                x = torch.zeros((L, k), dtype=hm.dtype, device=cuda_device)
                x[:n] = torch.rand((n, k), dtype=hm.dtype,
                                   device=cuda_device, generator=g)
                before = dict(cuda_matvec.LAUNCH_COUNTS)
                y = cuda_matvec.apply_hmatrix_cuda(hm._data, x, L, trans,
                                                   symmetry, table)
                after = dict(cuda_matvec.LAUNCH_COUNTS)
                assert after[name] - before[name] == (
                    table.n_buckets if mode == "per_bucket" else 1)
                assert sum(after.values()) - sum(before.values()) \
                    == after[name] - before[name]
                y_plain = apply_hmatrix_padded(hm._data, x, L, trans,
                                               symmetry)
                err = (y - y_plain).abs().max() / y_plain.abs().max()
                assert err <= 1e-5, (symmetry, UPLO, trans, k, float(err))


_GOLDEN = (pathlib.Path(__file__).resolve().parents[1] / "data"
           / "htool_generated_data")


class _MatrixGenerator(T.VirtualGenerator):
    def __init__(self, matrix):
        super().__init__()
        self.matrix = matrix
        self.is_complex = np.iscomplexobj(matrix)

    def build_submatrix(self, J, K, mat):
        mat[:, :] = self.matrix[np.ix_(np.asarray(J), np.asarray(K))]


def _golden_problem(complex_case, P, size=400, seed=0):
    """(A, rhs, sol, P-partition cluster) of the golden problem: read from
    data/htool_generated_data where it is, else rebuilt in memory with the
    recipe of tools/generate_test_data.py (the data directory is not part
    of a checkout)."""
    path = _GOLDEN / ("output_non_sym" if complex_case else "output_sym")
    if (path / "matrix.bin").exists():
        raw = (path / "matrix.bin").read_bytes()
        m, n = struct.unpack("@II", raw[:8])
        A = np.frombuffer(raw[8:], dtype=np.complex128).reshape((m, n)).T
        rhs = np.frombuffer((path / "rhs.bin").read_bytes()[4:],
                            np.complex128)
        sol = np.frombuffer((path / "sol.bin").read_bytes()[4:],
                            np.complex128)
        cluster = T.read_cluster_from(
            str(path / f"cluster_{P}_cluster_tree_properties.csv"),
            str(path / f"cluster_{P}_cluster_tree.csv"))
        return A, rhs, sol, cluster
    rng = np.random.RandomState(seed)
    pts = rng.randn(3, size)
    pts /= np.linalg.norm(pts, axis=0, keepdims=True)
    pts += 0.1 * rng.rand(3, size)
    d = np.linalg.norm(pts[:, :, None] - pts[:, None, :], axis=0)
    if complex_case:
        A = np.exp(2j * d) / (4 * np.pi * np.maximum(d, 1e-2))
        np.fill_diagonal(A, np.abs(A).max())
        r7 = np.random.RandomState(7)
        A = A + 0.02 * np.abs(A).mean() * (r7.rand(*A.shape)
                                           + 1j * r7.rand(*A.shape))
    else:
        A = 1.0 / (1e-1 + d)
    A = A + np.abs(A).sum(axis=1).max() * np.eye(size, dtype=A.dtype)
    rhs = rng.rand(size) + (1j * rng.rand(size) if complex_case else 0)
    sol = np.linalg.solve(A, rhs)
    builder = T.ClusterTreeBuilder()
    builder.set_maximal_leaf_size(10)
    cluster = builder.create_cluster_tree(pts, 2, size_of_partition=P)
    return (A.astype(np.complex128), rhs.astype(np.complex128),
            sol.astype(np.complex128), cluster)


@pytest.mark.gpu
@pytest.mark.parametrize("symmetry,schwarz", [("S", "asm"), ("N", "ras")])
def test_golden_ddm_solve_on_the_card(cuda_device, symmetry, schwarz):
    """A P = 2 block-Jacobi DDM solve of the golden problem
    (tools/generate_test_data.py) in float32 / complex64 on the card:
    GMRES converges to 1e-6 and the solution is within 10 eps of sol."""
    A, rhs, sol, cluster = _golden_problem(symmetry == "N", 2)
    dtype = np.complex64
    if symmetry == "S":
        A, rhs, sol, dtype = A.real, rhs.real, sol.real, np.float32
    eps = 1e-6
    hb = T.HMatrixTreeBuilder(eps, 10, symmetry,
                              "L" if symmetry == "S" else "N",
                              device=cuda_device)
    hb.set_dtype(dtype)
    approx = T.DefaultApproximationBuilder(_MatrixGenerator(A), cluster,
                                           cluster, hb)
    solver = T.DDMSolverBuilder(approx.distributed_operator,
                                approx.block_diagonal_hmatrix).solver
    solver.set_hpddm_args("-hpddm_krylov_method gmres -hpddm_schwarz_method "
                          f"{schwarz} -hpddm_max_it 200 -hpddm_tol 1e-6")
    solver.facto_one_level()
    f = rhs.astype(dtype)
    x = np.zeros_like(f)
    before = cuda_matvec.LAUNCH_COUNTS[cuda_matvec.launch_name(
        cuda_matvec.KERNEL_NAME if symmetry == "S" else cuda_matvec.K2_NAME,
        "fused")]
    solver.solve(x, f)
    info = solver.get_information()
    assert float(info["Residual_estimate"]) <= 1e-6, info
    assert cuda_matvec.LAUNCH_COUNTS[cuda_matvec.launch_name(
        cuda_matvec.KERNEL_NAME if symmetry == "S" else cuda_matvec.K2_NAME,
        "fused")] > before
    err = np.linalg.norm(x - sol) / np.linalg.norm(sol)
    assert err < 10 * eps, (err, info)


def _golden_overlap(cluster, P, size=400, seed=0):
    """(ovr_to_global, cluster_to_ovr, neighbors, intersections) of the
    golden problem's points and P-partition cluster, by the recipe of
    tools/generate_test_data.py: each partition's dofs, then two rounds of
    growth to every point's 8 nearest neighbours."""
    rng = np.random.RandomState(seed)
    pts = rng.randn(3, size)
    pts /= np.linalg.norm(pts, axis=0, keepdims=True)
    pts += 0.1 * rng.rand(3, size)
    d = np.linalg.norm(pts[:, :, None] - pts[:, None, :], axis=0)
    np.fill_diagonal(d, np.inf)
    knn = np.argsort(d, axis=1)[:, :8]
    perm = cluster.get_permutation()
    ovr, c2o = [], []
    for p in range(P):
        node = cluster.get_cluster_on_partition(p)
        own = perm[node.get_offset():node.get_offset() + node.get_size()]
        in_sub = np.zeros(size, dtype=bool)
        in_sub[own] = True
        for _ in range(2):
            in_sub[np.unique(knn[in_sub].ravel())] = True
        ovr.append(np.concatenate(
            [own, np.setdiff1d(np.flatnonzero(in_sub), own)]))
        c2o.append(np.arange(len(own)))
    neighbors = [[q for q in range(P)
                  if q != p and np.isin(ovr[p], ovr[q]).any()]
                 for p in range(P)]
    intersections = [[np.flatnonzero(np.isin(ovr[p], ovr[q]))
                      for q in neighbors[p]] for p in range(P)]
    return ovr, c2o, neighbors, intersections


@pytest.mark.gpu
def test_two_level_golden_solve_on_the_card(cuda_device):
    """The symmetric golden problem on P = 2 overlapping subdomains with
    the GenEO coarse space (2 vectors a subdomain, Ki = A[ovr, ovr]) in
    float32 on the card: E = Z^T A Z launches K1, Z and E's LU stay on the
    card in float32, GMRES converges to 1e-6 and the solution is within
    10 eps of sol."""
    A, rhs, sol, cluster = _golden_problem(False, 2)
    A, rhs, sol = A.real, rhs.real, sol.real
    ovr, c2o, neighbors, intersections = _golden_overlap(cluster, 2)
    eps = 1e-6
    hb = T.HMatrixTreeBuilder(eps, 10, "S", "L", device=cuda_device)
    hb.set_dtype(np.float32)
    gen = _MatrixGenerator(A)
    approx = T.DefaultApproximationBuilder(gen, cluster, cluster, hb)
    op, diag = approx.distributed_operator, approx.block_diagonal_hmatrix
    solver = T.DDMSolverBuilder(op, diag, gen, ovr, c2o, neighbors,
                                intersections).solver
    name = cuda_matvec.launch_name(cuda_matvec.KERNEL_NAME, "fused")
    before = cuda_matvec.LAUNCH_COUNTS[name]
    solver.build_coarse_space(
        [T.GeneoCoarseSpaceDenseBuilder(len(c2o[p]), len(ovr[p]), diag[p],
                                        A[np.ix_(ovr[p], ovr[p])], "S", "L",
                                        geneo_nu=2) for p in range(2)],
        T.GeneoCoarseOperatorBuilder(op))
    assert cuda_matvec.LAUNCH_COUNTS[name] > before
    Z, (lu, _) = solver._coarse
    assert Z.shape == (len(rhs), 4)
    assert Z.device.type == lu.device.type == "cuda"
    assert Z.dtype == lu.dtype == torch.float32
    solver.set_hpddm_args("-hpddm_krylov_method gmres -hpddm_schwarz_method "
                          "asm -hpddm_schwarz_coarse_correction additive "
                          "-hpddm_max_it 200 -hpddm_tol 1e-6")
    solver.facto_one_level()
    f = rhs.astype(np.float32)
    x = np.zeros_like(f)
    solver.solve(x, f)
    info = solver.get_information()
    assert info["Nb_coarse_vectors"] == "4"
    assert float(info["Residual_estimate"]) <= 1e-6, info
    err = np.linalg.norm(x - sol) / np.linalg.norm(sol)
    assert err < 10 * eps, (err, info)


def _f32_operators(device, n=3000):
    points = np.random.RandomState(0).rand(3, n)
    builder = T.ClusterTreeBuilder()
    builder.set_maximal_leaf_size(64)
    cluster = builder.create_cluster_tree(points, 2)
    ops = {}
    for symmetry, UPLO in (("N", "N"), ("S", "L"), ("S", "U")):
        hb = T.HMatrixTreeBuilder(1e-3, 10.0, symmetry, UPLO, device=device)
        hb.set_dtype(torch.float32)
        ops[symmetry, UPLO] = hb.build(
            T.KernelGenerator(inverse_distance_kernel(0.1), points, points,
                              device=device), cluster, cluster)
    return ops


@pytest.mark.gpu
def test_k1al_matches_plain_version(cuda_device):
    """K1-al on the aligned low-rank layout (leaf-64 plans), every storage
    case, against the plain version on the same data and on the canonical
    layout; counted under its own name, one launch a product."""
    from htool_python_torch.ops.matvec import ALIGN_LANE, align_lowrank

    for (symmetry, UPLO), hm in _f32_operators(cuda_device).items():
        L, n = hm._pad_len, hm.shape[0]
        aligned = align_lowrank(hm._data, ALIGN_LANE)
        table = cuda_matvec.BucketTable(aligned, hm.device)
        assert table.aligned
        for trans in ("N", "T"):
            for k in (1, 2, 3, 4, 8, 11, 12, 128):
                g = torch.Generator(cuda_device).manual_seed(k)
                x = torch.zeros((L, k), device=cuda_device)
                x[:n] = torch.rand((n, k), device=cuda_device, generator=g)
                before = cuda_matvec.LAUNCH_COUNTS[cuda_matvec.ALIGNED_NAME]
                y = cuda_matvec.apply_hmatrix_cuda(aligned, x, L, trans,
                                                   symmetry, table)
                torch.cuda.synchronize()
                assert (cuda_matvec.LAUNCH_COUNTS[cuda_matvec.ALIGNED_NAME]
                        == before + 1)
                for data in (aligned, hm._data):
                    y_plain = apply_hmatrix_padded(data, x, L, trans,
                                                   symmetry)
                    err = (y - y_plain).abs().max() / y_plain.abs().max()
                    assert err <= 1e-5, (symmetry, UPLO, trans, k, float(err))


def _split_buckets(device, seed=0):
    """float32 buckets that K1's work list splits: dense 192 x 128 blocks
    (3 row items each), rank-70 low-rank blocks (2 rank items each), a
    small low-rank bucket, and an empty one; random mirror flags."""
    rng = np.random.RandomState(seed)
    L = 1024

    def meta(nb, pt, ps):
        return (torch.as_tensor(rng.randint(0, L - pt, nb),
                                dtype=torch.int32, device=device),
                torch.as_tensor(rng.randint(0, L - ps, nb),
                                dtype=torch.int32, device=device),
                torch.as_tensor(rng.rand(nb) < 0.5, device=device))

    def arr(*shape):
        return torch.as_tensor(rng.randn(*shape), dtype=torch.float32,
                               device=device)

    data = {"dense": [(arr(3, 192, 128), *meta(3, 192, 128))],
            "lr": [(arr(4, 70, 64), arr(4, 70, 96), *meta(4, 64, 96)),
                   (arr(0, 3, 32), arr(0, 3, 32), *meta(0, 32, 32)),
                   (arr(2, 5, 32), arr(2, 5, 32), *meta(2, 32, 32))]}
    return data, L


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["fused", "per_bucket", "seq"])
def test_k1_work_list_matches_plain_version(cuda_device, launch_mode, mode):
    """K1's work-list body in each launch structure (K1-al for aligned
    data under 'fused') on low-rank sphere operators (storage N, S-L),
    their aligned layout, and buckets the work list splits, at the widths
    of chip_smoke.py's checks, FFMA (k <= 8) and 3xTF32 (k >= 9), and a
    two-pass width (130): within 1e-5 relative of the plain version."""
    from htool_python_torch.models.kernels import second_kind_kernel
    from htool_python_torch.ops.matvec import ALIGN_LANE, align_lowrank

    launch_mode(mode)
    n = 6000
    points = create_random_points_on_sphere(n, np.random.RandomState(3))
    builder = T.ClusterTreeBuilder()
    builder.set_maximal_leaf_size(64)
    cluster = builder.create_cluster_tree(points, 2)
    cases = []
    for symmetry, UPLO in (("N", "N"), ("S", "L")):
        hb = T.HMatrixTreeBuilder(1e-4, 10.0, symmetry, UPLO,
                                  device=cuda_device)
        hb.set_dtype(torch.float32)
        hm = hb.build(T.KernelGenerator(second_kind_kernel(0.5, 10.0), points,
                                        points, device=cuda_device),
                      cluster, cluster)
        assert hm._data["lr"]
        cases.append((symmetry, hm._data, hm._pad_len))
        cases.append((symmetry, align_lowrank(hm._data, ALIGN_LANE),
                      hm._pad_len))
    split, L_split = _split_buckets(cuda_device)
    cases.append(("S", split, L_split))
    for symmetry, data, L in cases:
        table = cuda_matvec.BucketTable(data, cuda_device)
        for trans in ("N", "T"):
            for k in (1, 2, 4, 8, 9, 32, 128, 130):
                g = torch.Generator(cuda_device).manual_seed(k)
                x = torch.rand((L, k), device=cuda_device, generator=g)
                y = cuda_matvec.apply_hmatrix_cuda(data, x, L, trans,
                                                   symmetry, table)
                y_plain = apply_hmatrix_padded(data, x, L, trans, symmetry)
                err = (y - y_plain).abs().max() / y_plain.abs().max()
                assert err <= 1e-5, (symmetry, table.aligned, trans, k,
                                     float(err))


@pytest.mark.gpu
@pytest.mark.parametrize("operator", ["headline", "hlu"])
def test_k1_at_the_main_path_shapes(cuda_device, operator):
    """K1 and K1-al at chip_smoke.py's shapes and widths: the headline
    operator (N = 40000, leaf 128) and the hlu operator (N = 32768 on the
    sphere, leaf 64), trans N / T, k in {1, 2, 4, 8, 9, 32, 128}, within
    1e-5 relative of the plain version."""
    from htool_python_torch.models.geometry import \
        create_random_points_in_sphere
    from htool_python_torch.models.kernels import second_kind_kernel
    from htool_python_torch.ops.matvec import ALIGN_LANE, align_lowrank

    if operator == "headline":
        n, leaf = 40000, 128
        points = create_random_points_in_sphere(n, np.random.RandomState(0))
        kernel = inverse_distance_kernel(0.1)
    else:
        n, leaf = 32768, 64
        points = create_random_points_on_sphere(n, np.random.RandomState(11))
        kernel = second_kind_kernel(0.5, 0.5 * n)
    builder = T.ClusterTreeBuilder()
    builder.set_maximal_leaf_size(leaf)
    cluster = builder.create_cluster_tree(points, 2)
    hb = T.HMatrixTreeBuilder(1e-3, 10.0, "N", "N", device=cuda_device)
    hb.set_dtype(torch.float32)
    hm = hb.build(T.KernelGenerator(kernel, points, points,
                                    device=cuda_device), cluster, cluster)
    L = hm._pad_len
    for data in (hm._data, align_lowrank(hm._data, ALIGN_LANE)):
        table = cuda_matvec.BucketTable(data, cuda_device)
        for trans in ("N", "T"):
            for k in (1, 2, 4, 8, 9, 32, 128):
                g = torch.Generator(cuda_device).manual_seed(k)
                x = torch.zeros((L, k), device=cuda_device)
                x[:n] = torch.rand((n, k), device=cuda_device, generator=g)
                y = cuda_matvec.apply_hmatrix_cuda(data, x, L, trans, "N",
                                                   table)
                y_plain = apply_hmatrix_padded(data, x, L, trans, "N")
                err = (y - y_plain).abs().max() / y_plain.abs().max()
                assert err <= 1e-5, (operator, table.aligned, trans, k,
                                     float(err))


@pytest.mark.gpu
def test_k1_zero_columns_and_empty_buckets(cuda_device):
    """A product with no columns, and one over buckets that are all empty,
    launch nothing and give zeros; an empty bucket among full ones is
    skipped."""
    data, L = _split_buckets(cuda_device)
    table = cuda_matvec.BucketTable(data, cuda_device)
    assert table.n_buckets == 3 and len(table.work.ranges) == 3
    before = dict(cuda_matvec.LAUNCH_COUNTS)
    y = cuda_matvec.apply_hmatrix_cuda(
        data, torch.zeros((L, 0), device=cuda_device), L, "N", "S", table)
    assert y.shape == (L, 0)
    empty = {"dense": [], "lr": [data["lr"][1]]}
    y = cuda_matvec.apply_hmatrix_cuda(
        empty, torch.rand((L, 3), device=cuda_device), L, "N", "N")
    assert y.shape == (L, 3) and not y.any()
    assert cuda_matvec.LAUNCH_COUNTS == before


@pytest.mark.gpu
def test_hodlr_factorization_on_the_card(cuda_device):
    """lu_factorization / cholesky_factorization above a lowered
    hodlr_threshold, through K1 and with the aligned layout through K1-al:
    HODLR, no dense fallback, and solves within eps."""
    import copy

    from htool_python_torch.models.kernels import second_kind_kernel

    n, eps = 6000, 1e-3
    points = create_random_points_on_sphere(n, np.random.RandomState(11))
    builder = T.ClusterTreeBuilder()
    builder.set_maximal_leaf_size(64)
    cluster = builder.create_cluster_tree(points, 2)
    hb = T.HMatrixTreeBuilder(eps, 10.0, "N", "N", device=cuda_device)
    hb.set_dtype(torch.float32)
    hm = hb.build(T.KernelGenerator(second_kind_kernel(0.5, 0.5 * n), points,
                                    points, device=cuda_device),
                  cluster, cluster)
    x_ref = np.random.RandomState(2).rand(n).astype(np.float32)
    b = hm * x_ref
    cfg = get_config()
    saved = cfg.hodlr_threshold
    cfg.hodlr_threshold = 2048
    try:
        for aligned in (False, True):
            cfg.matvec_aligned_layout = aligned
            for kind in ("lu", "cholesky"):
                cuda_matvec.reset_launch_counts()
                fac = copy.deepcopy(hm)
                if kind == "lu":
                    fac.lu_factorization()
                    x = fac.lu_solve("N", b)
                else:
                    fac.cholesky_factorization("L")
                    x = fac.cholesky_solve("L", b)
                assert fac._factorization[0] == "hodlr"
                counts = cuda_matvec.LAUNCH_COUNTS
                assert (counts[cuda_matvec.ALIGNED_NAME] > 0) == aligned
                assert (counts[cuda_matvec.KERNEL_NAME] > 0) != aligned
                assert (np.linalg.norm(hm * x - b)
                        < eps * np.linalg.norm(b))
                assert (np.linalg.norm(x - x_ref)
                        < 10 * eps * np.linalg.norm(x_ref))
    finally:
        cfg.hodlr_threshold = saved
        cfg.matvec_aligned_layout = False


@pytest.mark.gpu
def test_stream_probes_match_plain_version(cuda_device):
    """P1 over buffer counts and tile sizes (first and last tiles weighted
    by the reference's clipped index map), and P2 over block shapes (one
    width that is not a whole number of warps of float4), against their
    plain versions, each to 1e-5 relative (P2 on positive entries, so that
    its sum does not cancel)."""
    from htool_python_torch.profiling import stream

    rng = np.random.RandomState(0)
    x = torch.rand((1, stream.OUT_COLS), device=cuda_device)
    for step_mb, n_buf in ((1, 1), (1, 4), (2, 3), (1, 24)):
        arrays, _ = stream.make_stream(step_mb, n_buf, 24, rng=rng)
        bufs = [torch.from_numpy(a).to(cuda_device) for a in arrays]
        before = stream.LAUNCH_COUNTS[stream.P1_NAME]
        got = stream.stream_probe(bufs, x, step_mb)
        torch.cuda.synchronize()
        assert stream.LAUNCH_COUNTS[stream.P1_NAME] == before + 1
        want = stream.stream_probe_plain(bufs, x, step_mb)
        err = (got - want).abs().max() / want.abs().max()
        assert err <= 1e-5, (step_mb, n_buf, float(err))
    x = torch.zeros((1, 1), device=cuda_device)
    for shape, G in (((16, 640), 4), ((32, 256), 96), ((8192, 640), 1),
                     ((7, 100), 3)):
        A = torch.from_numpy(np.abs(stream.make_shape_case(
            shape, G, 24 << 20, rng=np.random.default_rng(0)))).to(cuda_device)
        got = stream.shape_stream(A, x, G)
        want = stream.shape_stream_plain(A, x, G)
        assert float((got - want).abs()) <= 1e-5 * float(want), (shape, G)


@pytest.mark.gpu
def test_k1_sweeps_match_plain_version(cuda_device):
    """K1's attribution sweeps (profiling/k1_sweeps.py) at their --cpu
    size on the card: every case of the six families timed, K1 against
    its plain version at k = 1, 8 and 128, and the pow2-padded products
    against the stored one, each within 1e-5."""
    from htool_python_torch.profiling import k1_sweeps

    before = cuda_matvec.LAUNCH_COUNTS[cuda_matvec.KERNEL_NAME]
    result = k1_sweeps.run_sweeps(cuda_device, tiny=True, ks=(1, 8, 128),
                                  check_ks=(1, 8, 128))
    assert cuda_matvec.LAUNCH_COUNTS[cuda_matvec.KERNEL_NAME] > before
    assert k1_sweeps.failures(result) == []
    entries = dict(k1_sweeps.case_entries(result))
    assert len(entries) == 33
    for entry in entries.values():
        for k in (1, 8, 128):
            row = entry[f"k{k}"]
            assert row["max_rel_err"] <= k1_sweeps.CHECK_TOL
            assert min(row["ms"], row["device_ms"], row["bound_ms"]) > 0
    for rule in k1_sweeps.RULES:
        assert all(result["repad"][rule]["whole"][f"k{k}"]["repad_err"]
                   <= k1_sweeps.CHECK_TOL for k in (1, 8, 128))


@pytest.mark.gpu
def test_bucket_variants_match_plain_version(cuda_device):
    """P3 over the reference's six variants and the other choices of
    gather, term and accumulation, on the low-rank and the dense bucket of
    the reference's --cpu size (4 MiB, L = 40960), with two segments moved
    past the ends of x and y; with accum 'skip', y = 0 and the per-CTA sums
    of positive data to 1e-5 relative; K1 on the same bucket equals
    'base'.  Then 'xgemm' on 2 SMs + 37 groups (its persistent grid's
    tail), within `kernel_tolerance`, and its per-group sums."""
    from htool_python_torch.profiling import bucket_variants as bv

    rng = np.random.default_rng(0)
    L = bv.LENGTH
    combos = [v[1:] for v in bv.VARIANTS] + [
        ("take", "vpu", "roll"), ("none", "vpu", "static"),
        ("roll", "skip", "roll"), ("take", "skip", "static"),
        ("none", "xgemm", "skip"), ("roll", "vpu", "skip")]
    for kind, r, pt, ps, G in bv.CASES:
        slabs, (t_off, s_off), _ = bv.build_case(kind, 4, L, G, r, pt, ps,
                                                 rng)
        s_off[0], t_off[1] = L - 100, -50
        x = torch.from_numpy(rng.standard_normal((1, L)).astype(
            np.float32)).to(cuda_device)
        slabs = torch.from_numpy(slabs).to(cuda_device)
        offs = (torch.from_numpy(t_off).to(cuda_device),
                torch.from_numpy(s_off).to(cuda_device))
        for gather, term, accum in combos:
            if accum == "skip":  # positive data: the sums do not cancel
                args = (kind, gather, term, accum, slabs.abs(), offs,
                        x.abs(), L, G, r, pt, ps)
                y, sink = bv.bucket_variant(*args, return_sink=True)
                y_plain, want = bv.bucket_variant_plain(*args,
                                                        return_sink=True)
                assert not y.any() and not y_plain.any()
                assert ((sink - want).abs()
                        <= 1e-5 * want.abs().max()).all(), (kind, gather, term)
                continue
            args = (kind, gather, term, accum, slabs, offs, x, L, G, r, pt,
                    ps)
            y = bv.bucket_variant(*args)
            torch.cuda.synchronize()
            y_plain = bv.bucket_variant_plain(*args)
            tol = bv.kernel_tolerance(*args, y_plain)
            assert ((y - y_plain).abs() <= tol).all(), (kind, gather, term,
                                                        accum)
        # K1 refuses segments outside x and y: move them back inside
        offs = (offs[0].clamp(0, L - pt), offs[1].clamp(0, L - ps))
        data = bv.k1_data(kind, slabs, offs, r, pt, ps)
        y_k1 = cuda_matvec.apply_hmatrix_cuda(data, x.reshape(L, 1), L, "N",
                                              "N").reshape(1, L)
        y_base = bv.bucket_variant(kind, "roll", "vpu", "roll", slabs, offs,
                                   x, L, G, r, pt, ps)
        err = (y_k1 - y_base).abs().max() / y_base.abs().max()
        assert err <= 1e-5, (kind, float(err))
    # 'xgemm' runs a persistent grid of one CTA per SM: 2 SMs + 37 groups
    # are no multiple of it, so CTAs take 2 or 3 groups and the ring's
    # phases run on across groups; segments past both ends of x and y;
    # accum 'skip' writes one sum per group
    g = torch.Generator(cuda_device).manual_seed(1)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    n_groups = 2 * sms + 37
    for kind, r, pt, ps, G in bv.CASES:
        nb = n_groups * G
        slabs = torch.randn((nb, bv.slab_rows(kind, r, pt), max(pt, ps)),
                            device=cuda_device, generator=g)
        t_off, s_off = (torch.randint(0, L - w - 256, (nb,), generator=g,
                                      device=cuda_device, dtype=torch.int32)
                        for w in (pt, ps))
        s_off[0], t_off[1], s_off[-1], t_off[-2] = L - 100, -50, -30, L - 60
        x = torch.randn((1, L), device=cuda_device, generator=g)
        for gather, accum in (("roll", "roll"), ("take", "static")):
            args = (kind, gather, "xgemm", accum, slabs, (t_off, s_off), x, L,
                    G, r, pt, ps)
            y = bv.bucket_variant(*args)
            torch.cuda.synchronize()
            y_plain = bv.bucket_variant_plain(*args)
            tol = bv.kernel_tolerance(*args, y_plain)
            assert ((y - y_plain).abs() <= tol).all(), (kind, gather, accum)
            assert (y_plain.abs() > tol).any()  # a zero output would fail
        args = (kind, "roll", "xgemm", "skip", slabs.abs(), (t_off, s_off),
                x.abs(), L, G, r, pt, ps)
        y, sink = bv.bucket_variant(*args, return_sink=True)
        # TF32 moves a group's sum by about 1e-5 of it: the sums are held to
        # the plain twin that rounds as the kernel does, to f32 round-off
        y_twin, want = bv.xgemm_streamed_plain(kind, "roll", "skip",
                                               *args[4:], return_sink=True,
                                               tf32=True)
        assert not y.any() and not y_twin.any()
        assert sink.shape == want.shape == (n_groups,)
        assert ((sink - want).abs() <= 1e-5 * want.abs().max()).all(), kind


@pytest.mark.gpu
def test_take_along_axis_matches_plain_version(cuda_device):
    """P4 at the reference probe's shapes and on random indices: equal to
    its plain version; an index outside the row raises IndexError."""
    from htool_python_torch.profiling import bucket_variants as bv

    x = torch.arange(8 * 1024, dtype=torch.float32,
                     device=cuda_device).reshape(8, 1024)
    idx = (torch.arange(256, dtype=torch.int32, device=cuda_device) + 3
           ).expand(8, 256).contiguous()
    got = bv.take_along_axis(x, idx)
    assert torch.equal(got[0].cpu(), torch.arange(3, 259).float())
    g = torch.Generator(cuda_device).manual_seed(0)
    x = torch.rand((5, 333), device=cuda_device, generator=g)
    idx = torch.randint(0, 333, (5, 77), device=cuda_device, generator=g,
                        dtype=torch.int32)
    assert torch.equal(bv.take_along_axis(x, idx),
                       bv.take_along_axis_plain(x, idx))
    idx[2, 5] = 333
    with pytest.raises(IndexError):
        bv.take_along_axis(x, idx)
    # the timed form: no read per call, the count checked once
    fault = bv.fault_counter(cuda_device)
    for _ in range(3):
        out = bv.take_along_axis(x, idx, fault=fault)
    assert out[2, 5] == 0 and int(fault.item()) == 3
    with pytest.raises(IndexError):
        bv.check_fault(fault, 333)


def _wide_buckets(dtype, device, symmetry, seed=0, L=4096):
    """Buckets that split into items (192-row dense blocks, rank-70 and
    rank-8 low-rank blocks) with random mirror flags, ~3 000 items: more
    than the persistent grid holds, so every CTA walks several and the
    last ones fewer."""
    rng = np.random.RandomState(seed)

    def a(*shape):
        v = rng.randn(*shape)
        if dtype.is_complex:
            v = v + 1j * rng.randn(*shape)
        return torch.as_tensor(v).to(dtype).to(device)

    def meta(nb, pt, ps):
        mirror = (rng.rand(nb) < 0.5) & (symmetry != "N")
        return tuple(torch.as_tensor(v, device=device) for v in (
            rng.randint(0, L - pt, nb).astype(np.int32),
            rng.randint(0, L - ps, nb).astype(np.int32), mirror))

    return {"dense": [(a(5, 192, 128), *meta(5, 192, 128)),
                      (a(300, 64, 64), *meta(300, 64, 64))],
            "lr": [(a(7, 70, 96), a(7, 70, 160), *meta(7, 96, 160)),
                   (a(2600, 8, 64), a(2600, 8, 64), *meta(2600, 64, 64))]}, L


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,x_dtype", [
    (torch.float64, torch.float64), (torch.complex128, torch.complex128),
    (torch.float32, torch.float64), (torch.complex64, torch.complex128)])
def test_f64_kernels_match_plain_version(cuda_device, dtype, x_dtype):
    """The float64 / complex128 family against the plain version within
    1e-12: hmatrix_product_f64 / hmatrix_product_complex128 on float64 /
    complex128 data, and the instantiations that read float32 / complex64
    data with a float64 / complex128 x; every storage and trans, k from
    one column to more than one pass (64 real / 32 complex columns a
    pass); a narrower x promoted, a complex x on real data through the
    real view; one launch per pass counted."""
    name = cuda_matvec.dispatch(dtype, x_dtype)[0]
    storages = ("N", "S", "H") if dtype.is_complex else ("N", "S")
    for symmetry in storages:
        data, L = _wide_buckets(dtype, cuda_device, symmetry)
        table = cuda_matvec.BucketTable(data, cuda_device)
        assert len(table.work.items) > 2 * 132 * 8
        for trans in ("N", "T", "C") if dtype.is_complex else ("N", "T"):
            for k in (1, 2, 3, 8, 9, 33, 64, 65, 129):
                g = torch.Generator(cuda_device).manual_seed(k)
                x = torch.randn((L, k), dtype=x_dtype, device=cuda_device,
                                generator=g)
                before = cuda_matvec.LAUNCH_COUNTS[name]
                y = cuda_matvec.apply_hmatrix_cuda(data, x, L, trans,
                                                   symmetry, table)
                torch.cuda.synchronize()
                passes = -(-k // cuda_matvec.PASS_COLS[x_dtype])
                assert cuda_matvec.LAUNCH_COUNTS[name] == before + passes
                y_plain = apply_hmatrix_padded(data, x, L, trans, symmetry)
                assert y.dtype == y_plain.dtype == x_dtype
                err = (y - y_plain).abs().max() / y_plain.abs().max()
                assert err <= 1e-12, (symmetry, trans, k, float(err))
        if dtype == x_dtype:
            other = (torch.float32 if not dtype.is_complex
                     else torch.complex64)
            x = torch.randn((L, 3), dtype=other, device=cuda_device)
            y = cuda_matvec.apply_hmatrix_cuda(data, x, L, "N", symmetry,
                                               table)
            y_plain = apply_hmatrix_padded(data, x, L, "N", symmetry)
            assert y.dtype == y_plain.dtype
            assert (y - y_plain).abs().max() <= 1e-12 * y_plain.abs().max()
    if not dtype.is_complex:  # the real view at float64
        x = torch.randn((L, 3), dtype=torch.complex128, device=cuda_device)
        y = cuda_matvec.apply_hmatrix_cuda(data, x, L, "N", "S", table)
        y_plain = apply_hmatrix_padded(data, x, L, "N", "S")
        assert y.dtype == torch.complex128
        assert (y - y_plain).abs().max() <= 1e-12 * y_plain.abs().max()
    cfg = get_config()
    cfg.matvec_kernel_mode = "seq"
    try:
        with pytest.raises(NotImplementedError, match="one launch structure"):
            cuda_matvec.apply_hmatrix_cuda(data, x.to(x_dtype), L, "N", "N",
                                           table)
    finally:
        cfg.matvec_kernel_mode = "fused"


@pytest.mark.gpu
def test_sharded_f64_product_on_a_world_of_one(cuda_device):
    """The sharded operator on a world-1 NCCL group, P = 4 partitions on
    the one rank, float64: 'N', 'T' and 3-column products within 1e-10 of
    the single-process DistributedOperator and of the block rows' dense
    matrix, through hmatrix_product_f64."""
    import socket

    import torch.distributed as dist

    from htool_python_torch.parallel import (ShardedDistributedOperator,
                                             initialize_distributed)

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    assert initialize_distributed(f"tcp://127.0.0.1:{port}", 1, 0, "nccl")
    try:
        n = 2000
        points = np.random.RandomState(1).rand(3, n)
        builder = T.ClusterTreeBuilder()
        builder.set_maximal_leaf_size(64)
        cluster = builder.create_cluster_tree(points, 2, size_of_partition=4)
        hb = T.HMatrixTreeBuilder(1e-6, 10.0, "N", "N", device=cuda_device)
        approx = T.DefaultApproximationBuilder(
            T.KernelGenerator(inverse_distance_kernel(0.1), points, points,
                              device=cuda_device), cluster, cluster, hb)
        op = ShardedDistributedOperator(approx.hmatrix, cluster, cluster)
        assert op.dtype == torch.float64 and op.partitions == range(4)
        rng = np.random.RandomState(2)
        x, X = rng.rand(n), rng.rand(n, 3)
        before = cuda_matvec.LAUNCH_COUNTS[cuda_matvec.F64_NAME]
        y = op * x
        assert cuda_matvec.LAUNCH_COUNTS[cuda_matvec.F64_NAME] == before + 4
        y_ref = approx.distributed_operator * x
        assert np.linalg.norm(y - y_ref) <= 1e-10 * np.linalg.norm(y_ref)
        Y_ref = approx.distributed_operator @ X
        assert (np.linalg.norm(op @ X - Y_ref)
                <= 1e-10 * np.linalg.norm(Y_ref))
        dense = np.zeros((n, n))
        for p, h in enumerate(approx.hmatrix):
            o, s = int(op.t_offsets[p]), int(op.t_sizes[p])
            rows = cluster.get_permutation()[o:o + s]
            dense[np.sort(rows)] = h.to_dense_in_user_numbering()
        yt = op.matvec_global(torch.as_tensor(x, device=cuda_device), "T")
        assert yt.device.type == "cuda"
        assert (np.linalg.norm(yt.cpu().numpy() - dense.T @ x)
                <= 1e-10 * np.linalg.norm(dense.T @ x))
    finally:
        dist.destroy_process_group()


def _bits(t):
    """t's bytes, so that equality is bit for bit."""
    return t.contiguous().view(torch.uint8)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.complex64,
                                   torch.float64, torch.complex128])
def test_user_numbering_product_kernels(cuda_device, dtype):
    """The product in user numbering on the card (`apply_hmatrix_user_cuda`:
    the permute-in kernel, the product, the permute-out kernel) against its
    plain version, every storage and trans, k from one column to more than
    one pass, n = 4 093 rows (not a multiple of 4): the product within the
    kernels' tolerance (1e-5 relative for K1 / K2, 1e-12 for the float64 /
    complex128 family), one permute-in and one permute-out a product.  The
    two permutation kernels alone equal their plain versions bit for bit
    (a permutation is an exact copy; y zeroed), in 16-, 8- and 4-byte
    vectors (k and the dtype set a row's length; one x starts one element
    past an aligned address)."""
    from htool_python_torch.ops.matvec import permute_in, permute_out

    tol = 1e-12 if dtype in (torch.float64, torch.complex128) else 1e-5
    n, dev = 4093, cuda_device
    rng = np.random.RandomState(0)
    for symmetry in ("N", "S", "H"):
        data, L = _wide_buckets(dtype, dev, symmetry)
        table = cuda_matvec.BucketTable(data, dev)
        p_in, inv = (torch.as_tensor(p, dtype=torch.int32, device=dev)
                     for p in (rng.permutation(n),
                               np.argsort(rng.permutation(n))))
        for trans in ("N", "T", "C"):
            for k in (1, 2, 8, 9, 128, 129):
                g = torch.Generator(dev).manual_seed(k)
                x = torch.randn((n, k), dtype=dtype, device=dev, generator=g)
                before = dict(cuda_matvec.LAUNCH_COUNTS)
                y = cuda_matvec.apply_hmatrix_user_cuda(
                    data, p_in, inv, x, L, trans, symmetry, n, table)
                torch.cuda.synchronize()
                for name in (cuda_matvec.PERMUTE_IN_NAME,
                             cuda_matvec.PERMUTE_OUT_NAME):
                    assert cuda_matvec.LAUNCH_COUNTS[name] == before[name] + 1
                x_pad_plain = permute_in(x, p_in.long(), L, dtype)
                y_pad_plain = apply_hmatrix_padded(data, x_pad_plain, L,
                                                   trans, symmetry)
                y_plain = permute_out(y_pad_plain, inv.long(), n)
                assert y.shape == y_plain.shape and y.dtype == dtype
                err = (y - y_plain).abs().max() / y_plain.abs().max()
                assert err <= tol, (symmetry, trans, k, float(err))
                if trans != "N":
                    continue
                # the two kernels alone, into buffers full of NaN
                x_pad = torch.full((L, k), float("nan"), dtype=dtype,
                                   device=dev)
                y_zero, out = torch.full_like(x_pad, float("nan")), \
                    torch.full((n, k), float("nan"), dtype=dtype, device=dev)
                with torch.cuda.device(dev):
                    stream = torch.cuda.current_stream(dev).cuda_stream
                    cuda_matvec.launch_permute_in(x, p_in, x_pad, y_zero,
                                                  stream)
                    cuda_matvec.launch_permute_out(y_pad_plain, inv, out,
                                                   stream)
                torch.cuda.synchronize()
                assert torch.equal(_bits(x_pad), _bits(x_pad_plain))
                assert torch.equal(_bits(y_zero),
                                   _bits(torch.zeros_like(y_zero)))
                assert torch.equal(_bits(out), _bits(y_plain))
    # an x one element past an aligned address: 4-byte vectors in the
    # 16-byte rows of float32, 8-byte ones in complex64 and float64
    k = 16 // torch.empty((), dtype=dtype).element_size()
    x = torch.randn(n * k + 1, dtype=dtype, device=dev)[1:].view(n, k)
    assert x.data_ptr() % 16 == x.element_size() % 16
    y = cuda_matvec.apply_hmatrix_user_cuda(data, p_in, inv, x, L, "N",
                                            symmetry, n, table)
    y_plain = _plain_user_product(data, p_in.long(), inv.long(), x, L, "N",
                                  symmetry, n, dtype)
    assert (y - y_plain).abs().max() <= tol * y_plain.abs().max()


def _plain_user_product(data, perm_in, inv_out, x2d, L, trans, sym, nout,
                        dtype):
    """The product in user numbering by the plain versions, on x2d's
    device."""
    from htool_python_torch.ops.matvec import permute_in, permute_out

    return permute_out(apply_hmatrix_padded(
        data, permute_in(x2d, perm_in, L, dtype), L, trans, sym), inv_out,
        nout)


@pytest.mark.gpu
def test_user_numbering_answers_are_fresh(cuda_device):
    """HMatrix.matvec on the card: every answer is a new tensor (callers
    keep earlier ones: Krylov bases, the benchmark's reservoir), the first
    unchanged by the second call; one K1 launch, one permute-in and one
    permute-out a product; a numpy x (1-D, and 2-D in Fortran order, which
    the wrapper makes contiguous) gives the device input's answer; a
    float64 x on float32 data is promoted before the permute-in kernel."""
    n = 2999
    points = np.random.RandomState(2).rand(3, n)
    builder = T.ClusterTreeBuilder()
    builder.set_maximal_leaf_size(64)
    cluster = builder.create_cluster_tree(points, 2)
    hb = T.HMatrixTreeBuilder(1e-3, 10.0, "N", "N", device=cuda_device)
    hb.set_dtype(torch.float32)
    hm = hb.build(T.KernelGenerator(inverse_distance_kernel(0.1), points,
                                    points, device=cuda_device),
                  cluster, cluster)
    g = torch.Generator(cuda_device).manual_seed(3)
    x1, x2 = (torch.rand(n, device=cuda_device, generator=g)
              for _ in range(2))
    names = (cuda_matvec.KERNEL_NAME, cuda_matvec.PERMUTE_IN_NAME,
             cuda_matvec.PERMUTE_OUT_NAME)
    before = {name: cuda_matvec.LAUNCH_COUNTS[name] for name in names}
    y1 = hm.matvec(x1)
    kept = y1.clone()
    y2 = hm.matvec(x2)
    torch.cuda.synchronize()
    for name in names:
        assert cuda_matvec.LAUNCH_COUNTS[name] == before[name] + 2, name
    assert y1.data_ptr() != y2.data_ptr()
    assert torch.equal(y1, kept)
    perm_in, inv_out = hm._device_perms("N")  # int64: the plain version
    y_plain = _plain_user_product(hm._data, perm_in, inv_out, x1[:, None],
                                  hm._pad_len, "N", "N", n,
                                  torch.float32)[:, 0]
    assert (y1 - y_plain).abs().max() <= 1e-5 * y_plain.abs().max()
    y_host = hm * x1.cpu().numpy()
    assert (np.abs(y_host - y1.cpu().numpy()).max()
            <= 1e-5 * float(y_plain.abs().max()))
    X = np.asfortranarray(np.random.RandomState(4).rand(n, 3)
                          .astype(np.float32))
    Y = hm @ X
    Y_dev = hm.matvec(torch.as_tensor(np.ascontiguousarray(X),
                                      device=cuda_device)).cpu().numpy()
    assert np.abs(Y - Y_dev).max() <= 1e-5 * np.abs(Y_dev).max()
    before = cuda_matvec.LAUNCH_COUNTS[cuda_matvec.F64_F32_NAME]
    y64 = hm.matvec(x1.double())
    assert y64.dtype == torch.float64
    assert cuda_matvec.LAUNCH_COUNTS[cuda_matvec.F64_F32_NAME] == before + 1
    y64_plain = _plain_user_product(hm._data, perm_in, inv_out,
                                    x1.double()[:, None], hm._pad_len, "N",
                                    "N", n, torch.float64)[:, 0]
    assert (y64 - y64_plain).abs().max() <= 1e-12 * y64_plain.abs().max()
