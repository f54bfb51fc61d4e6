"""The port's slice end to end, against the dense oracle and against the
reference's independently assembled operator (float64, CPU).

Assembly runs in both packages from the same points; the port's operator
must meet epsilon against the dense kernel matrix (the reference's
contract, tests/test_hmatrix.py), and the two densified operators must
agree to 2 * epsilon relative to the dense matrix.  Also: the device rule
(CUDA by default, never a silent CPU fallback), the custom low-rank and
dense-block hooks, and the import guard (the port never imports JAX or the
reference package).
"""

import ast
import copy
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import htool_python_torch as T
import htool_python_tpu as H
from htool_python_torch.hmatrix.assembly import ASSEMBLY_PROFILE
from htool_python_torch.models.kernels import inverse_distance_kernel as pk
from htool_python_tpu.models.kernels import inverse_distance_kernel as rk

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _cloud(n, seed=0):
    return np.random.RandomState(seed).rand(3, n)


def _oracle(points):
    d = np.linalg.norm(points[:, :, None] - points[:, None, :], axis=0)
    return 1.0 / (0.1 + d)


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("symmetry,UPLO", [("N", "N"), ("S", "L")])
@pytest.mark.parametrize("eps", [1e-4, 1e-3])
def test_slice_matches_oracle_and_reference(eps, symmetry, UPLO):
    points = _cloud(500)
    A = _oracle(points)
    port_b = T.ClusterTreeBuilder()
    port_b.set_maximal_leaf_size(32)
    port_cluster = port_b.create_cluster_tree(points, 2)
    port = T.HMatrixTreeBuilder(eps, 10.0, symmetry, UPLO, device="cpu").build(
        T.KernelGenerator(pk(0.1), points, points, device="cpu"),
        port_cluster, port_cluster)
    assert set(ASSEMBLY_PROFILE) >= {"lr_aca_s", "lr_pack_s", "dense_fill_s",
                                     "total_s"}
    rng = np.random.RandomState(1)
    x = rng.rand(500)
    assert _rel(port * x, A @ x) < eps
    X = rng.rand(500, 3)
    assert _rel(port @ X, A @ X) < eps
    assert _rel(port.matvec(X, "T"), A.T @ X) < eps

    ref_b = H.ClusterTreeBuilder()
    ref_b.set_maximal_leaf_size(32)
    ref_cluster = ref_b.create_cluster_tree(points, 2)
    ref = H.HMatrixTreeBuilder(eps, 10.0, symmetry, UPLO).build(
        H.KernelGenerator(rk(0.1), points, points), ref_cluster, ref_cluster)
    diff = (port.to_dense_in_user_numbering()
            - ref.to_dense_in_user_numbering())
    assert np.linalg.norm(diff) / np.linalg.norm(A) <= 2 * eps


@pytest.mark.parametrize("symmetry,UPLO", [("N", "N"), ("S", "L")])
def test_block_row_build_matches_reference(symmetry, UPLO):
    """A partition's block row (target_partition_number; symmetric storage
    keeps its partition-diagonal block in one triangle with
    partition_number_for_symmetry): sub-block H-matrices in the internal
    numbering of the row, against the reference's own build."""
    eps = 1e-4
    points = _cloud(400, seed=6)
    ops = {}
    for pkg, gen in ((H, H.KernelGenerator(rk(0.1), points, points)),
                     (T, T.KernelGenerator(pk(0.1), points, points,
                                           device="cpu"))):
        builder = pkg.ClusterTreeBuilder()
        builder.set_maximal_leaf_size(24)
        cluster = builder.create_cluster_tree(points, 2, size_of_partition=2)
        kw = {} if pkg is H else {"device": "cpu"}
        hb = pkg.HMatrixTreeBuilder(eps, 10.0, symmetry, UPLO, **kw)
        ops[pkg] = hb.build(gen, cluster, cluster, target_partition_number=1,
                            partition_number_for_symmetry=(
                                1 if symmetry == "S" else -1))
    ref, port = ops[H], ops[T]
    assert not port.is_root() and port.shape == ref.shape
    assert port.plan.t_off_absolute == ref.plan.t_off_absolute == (
        symmetry == "S")
    D_ref = ref.to_dense_in_user_numbering()
    D_port = port.to_dense_in_user_numbering()
    assert np.linalg.norm(D_port - D_ref) <= 2 * eps * np.linalg.norm(D_ref)
    x = np.random.RandomState(5).rand(port.shape[1])
    assert _rel(port.matvec(x), ref.matvec(x)) <= 2 * eps


class _HostGenerator(T.VirtualGenerator):
    """A host callback generator (the reference tests' CustomGenerator)."""

    def __init__(self, points):
        super().__init__()
        self.points = points

    def build_submatrix(self, J, K, mat):
        mat[:, :] = _oracle(self.points)[np.ix_(J, K)]


def test_host_generator_path():
    points = _cloud(300, seed=4)
    A = _oracle(points)
    builder = T.ClusterTreeBuilder()
    builder.set_maximal_leaf_size(20)
    cluster = builder.create_cluster_tree(points, 2)
    hm = T.HMatrixTreeBuilder(1e-4, 10.0, "N", "N", device="cpu").build(
        _HostGenerator(points), cluster, cluster)
    x = np.random.RandomState(2).rand(300)
    assert _rel(hm * x, A @ x) < 1e-4
    assert int(hm.get_local_information()["Number_of_low_rank_blocks"]) > 0


def test_matrix_generator_float32():
    points = _cloud(300, seed=5)
    A = _oracle(points)
    builder = T.ClusterTreeBuilder()
    builder.set_maximal_leaf_size(20)
    cluster = builder.create_cluster_tree(points, 2)
    hb = T.HMatrixTreeBuilder(1e-3, 10.0, "N", "N", device="cpu")
    hb.set_dtype(np.float32)
    hm = hb.build(T.MatrixGenerator(A, device="cpu"), cluster, cluster)
    x = np.random.RandomState(3).rand(300).astype(np.float32)
    y = hm * x
    assert y.dtype == np.float32
    assert _rel(y, A @ x) < 1e-3


def test_cuda_is_the_default_device():
    points = _cloud(50)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-card rule cannot show")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.HMatrixTreeBuilder(1e-3, 10.0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.KernelGenerator(pk(0.1), points, points)


def test_generator_and_builder_devices_must_agree():
    points = _cloud(50)
    gen = T.KernelGenerator(pk(0.1), points, points, device="cpu")
    cluster = T.ClusterTreeBuilder().create_cluster_tree(points, 2)
    hb = T.HMatrixTreeBuilder(1e-3, 10.0, device="meta")
    with pytest.raises(ValueError, match="generator lives on"):
        hb.build(gen, cluster, cluster)


class _SVDHook(T.VirtualLowRankGenerator):
    """Truncated SVD of each admissible block of `matrix`."""

    def __init__(self, matrix):
        super().__init__()
        self.matrix = matrix

    def build_low_rank_approximation(self, rows, cols, epsilon):
        u, s, vh = np.linalg.svd(self.matrix[np.ix_(rows, cols)],
                                 full_matrices=False)
        r = max(int(np.sum(s > epsilon * s[0])), 1)
        if r * (len(rows) + len(cols)) > len(rows) * len(cols):
            return False
        self.set_U(u[:, :r] * s[:r])
        self.set_V(vh[:r])
        return True


class _DenseHook(T.VirtualDenseBlocksGenerator):
    def __init__(self, matrix):
        super().__init__()
        self.matrix, self.calls = matrix, 0

    def build_dense_blocks(self, rows_offsets, cols_offsets, blocks):
        self.calls += 1
        for rows, cols, block in zip(rows_offsets, cols_offsets, blocks):
            block[:, :] = self.matrix[np.ix_(rows, cols)]


def test_unported_hooks_raise():
    # the custom low-rank and dense-block hooks raised NotImplementedError
    # until they were ported (hmatrix/assembly.py); now a build with both
    # meets epsilon and calls the dense-blocks hook once
    points = _cloud(300)
    A = _oracle(points)
    builder = T.ClusterTreeBuilder()
    builder.set_maximal_leaf_size(16)
    hooked = builder.create_cluster_tree(points, 2)
    hb = T.HMatrixTreeBuilder(1e-3, 10.0, device="cpu")
    dense_hook = _DenseHook(A)
    hb.set_low_rank_generator(_SVDHook(A))
    hb.set_dense_blocks_generator(dense_hook)
    hm_hooked = hb.build(T.KernelGenerator(pk(0.1), points, points,
                                           device="cpu"), hooked, hooked)
    assert dense_hook.calls == 1 and hm_hooked.plan.lowrank_buckets
    assert not hm_hooked._lr_svd_form
    x_hooked = np.random.RandomState(2).rand(300)
    assert _rel(hm_hooked * x_hooked, A @ x_hooked) < 1e-3
    hb = T.HMatrixTreeBuilder(1e-3, 10.0, device="cpu")
    points = _cloud(60)
    cluster = T.ClusterTreeBuilder().create_cluster_tree(points, 2)
    hm = hb.build(T.KernelGenerator(pk(0.1), points, points, device="cpu"),
                  cluster, cluster)
    # the factorizations raised NotImplementedError until they were ported
    # (hmatrix/factorization.py); now they factorize in place and solve
    x_true = np.random.RandomState(1).rand(60)
    b = hm * x_true
    lu = copy.deepcopy(hm)
    lu.lu_factorization()
    assert lu._factorization[0] == "lu"  # 60 dofs: the dense path
    x = lu.lu_solve("N", b)
    assert np.linalg.norm(x - x_true) < 1e-6 * np.linalg.norm(x_true)
    assert hm._factorization is None
    hm.cholesky_factorization()
    assert hm._factorization[0] == "cholesky"
    assert np.linalg.norm(hm * hm.cholesky_solve("L", b) - b) < (
        1e-6 * np.linalg.norm(b))


def _port_sources():
    return sorted((ROOT / "htool_python_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]


def test_port_never_imports_jax_or_the_reference(tmp_path):
    banned = ("jax", "jaxlib", "htool_python_tpu", "tools")
    for path in _port_sources():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            elif (isinstance(node, ast.Call) and node.args
                  and isinstance(node.args[0], ast.Constant)
                  and isinstance(node.args[0].value, str)
                  and getattr(node.func, "attr",
                              getattr(node.func, "id", None))
                  in ("import_module", "__import__")):
                names = [node.args[0].value]
            for name in names:
                assert name.split(".")[0] not in banned, (path, name)
                # nor the reference's scripts under tools/
                assert not name.startswith("profile_matvec"), (path, name)
    # and at run time: importing every port module loads neither
    mods = sorted({".".join(p.relative_to(ROOT).with_suffix("").parts)
                   .removesuffix(".__init__")
                   for p in (ROOT / "htool_python_torch").rglob("*.py")})
    assert {"htool_python_torch.clustering.io",
            "htool_python_torch.parallel.local_operator",
            "htool_python_torch.parallel.distributed_operator",
            "htool_python_torch.parallel.builders",
            "htool_python_torch.solvers.options",
            "htool_python_torch.solvers.krylov",
            "htool_python_torch.solvers.ddm",
            "htool_python_torch.parallel.sharded",
            "htool_python_torch.parallel.multihost",
            "htool_python_torch.parallel.dryrun",
            "htool_python_torch.profiling.f64_variants"} <= set(mods)
    code = ("import sys, importlib\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'htool_python_tpu')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)
    # nor do the dryrun's spawned workers, which check their own modules
    from htool_python_torch.parallel import dryrun

    rc, results = dryrun.launch(1, 1, cpu=True, timeout=120,
                                rendezvous_dir=tmp_path)
    assert rc == 0 and '"ok": true' in results[0][1], results
