"""The port's public surface against the reference's (CPU).

* Every name of the reference's `__all__` (the root and each subpackage)
  is in the port's `__all__`; every public method of a class the two
  share is on the port's class; every public function and class a
  reference module defines is in the port's module of the same name.  The
  one list of exclusions, `NOT_PORTED`, cites ROADMAP §1's "Not ported"
  entries.
* `HMatrix.get_distributed_information()` equals the reference's on the
  block rows of tests/test_distributed_operator.py's default build (the
  reference's arrays carried over with `interop`), and in a gloo world of
  2 processes, each passing its own block row, the all-gathered result
  equals `DistributedOperator.get_distributed_information()`.
* `lowrank_leaves()` equals the reference's to 1e-12 in float64.
* `compact_for_products()` leaves the products bit for bit as they were,
  then densification, recompression, the dense factorization and
  `lowrank_leaves` raise the reference's RuntimeError.
* `plot` draws the cases of tests/test_cluster.py:69-82 and
  tests/test_hmatrix.py:342 on Agg figures; the package and its examples
  import without matplotlib.
"""

import copy
import importlib
import inspect
import json
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import htool_python_torch as T
import htool_python_tpu as H
from htool_python_torch import interop
from htool_python_torch.config import get_config
from htool_python_torch.models.kernels import inverse_distance_kernel
from test_torch_complex import (ReferenceHostGenerator, one_thread,  # noqa: F401
                                port_operator)

ROOT = Path(__file__).resolve().parents[1]
SUBPACKAGES = ["", "clustering", "hmatrix", "models", "parallel", "solvers",
               "utils", "ops"]

# Reference names the port does not carry, each as TPU / JAX plumbing that
# ROADMAP §1 lists under "Not ported".
NOT_PORTED = {
    # x64 is a JAX switch: the port's dtypes are torch dtypes, always
    # explicit (ROADMAP §1: `use_x64`)
    "use_x64",
    "config.use_x64",
    # the Pallas / XLA product backend switch, and the bucket rounding that
    # the reference reads nowhere (ROADMAP §1 knob rule; the port picks
    # its kernel by the operand's device and dtype)
    "Config.matvec_backend",
    "Config.bucket_rounding",
    "ops.matvec.resolve_backend",
    "ops.matvec.apply_hmatrix",
    # the generators' jit-operand protocol (ROADMAP §1: `device_*_ops` /
    # `device_operands`); the port's generators are called directly
    *(f"{cls}.{name}" for cls in ("KernelGenerator", "MatrixGenerator")
      for name in ("device_blocks_ops", "device_rows_ops",
                   "device_cols_ops", "device_operands")),
    "MatrixGenerator.device_matrix",
    "ops.aca.generator_operands",
    "ops.aca.concat_rank_chunks",
    "ops.aca.truncate_eps_array",
    # the complex64 re / im plane split of the TPU kernel (ROADMAP §1:
    # `ops/matvec.py`'s plane-split helpers); K2 reads complex64
    "ops.matvec.is_planes",
    "ops.matvec.split_planes",
    "ops.matvec.planes_supported",
    "ops.matvec.planes_fit",
    # device meshes (ROADMAP §1: `make_mesh` / `make_global_mesh` /
    # `make_hybrid_mesh`, which are the port's `rank_partitions`)
    "parallel.sharded.make_mesh",
    "parallel.multihost.make_global_mesh",
    "parallel.multihost.make_hybrid_mesh",
    # the reference's native loader switch: the port has no fallback to
    # ask about (a failed build raises)
    "native.available",
}
# reference modules with no counterpart module (ROADMAP §1: the Pallas
# kernels became csrc/*.cu, complex transfers are a TPU-link workaround)
NOT_PORTED_MODULES = {"ops.pallas_matvec", "utils.complex_io"}


def _module(pkg, sub):
    return importlib.import_module(pkg.__name__ + (f".{sub}" if sub else ""))


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_all_covers_reference(sub):
    ref, port = _module(H, sub), _module(T, sub)
    prefix = f"{sub}." if sub else ""
    missing = {n for n in ref.__all__ if n not in port.__all__
               and prefix + n not in NOT_PORTED and n not in NOT_PORTED}
    assert not missing, f"{port.__name__}.__all__ lacks {sorted(missing)}"
    for n in port.__all__:
        assert hasattr(port, n), f"{port.__name__}.{n} listed, not defined"


def _reference_modules():
    for info in pkgutil.walk_packages(H.__path__, H.__name__ + "."):
        rel = info.name[len(H.__name__) + 1:]
        if rel not in NOT_PORTED_MODULES:
            yield rel


def _defined(module):
    return {n: o for n, o in vars(module).items()
            if not n.startswith("_") and (inspect.isclass(o)
                                          or inspect.isfunction(o))
            and o.__module__ == module.__name__}


@pytest.mark.parametrize("rel", sorted(_reference_modules()))
def test_module_covers_reference(rel):
    """The module's public functions and classes, and each shared class's
    public methods."""
    ref, port = _module(H, rel), _module(T, rel)
    missing = []
    for name, obj in _defined(ref).items():
        if f"{rel}.{name}" in NOT_PORTED or name in NOT_PORTED:
            continue
        theirs = getattr(port, name, None)
        if theirs is None:
            missing.append(name)
            continue
        if inspect.isclass(obj):
            assert inspect.isclass(theirs), name
            missing += [f"{name}.{m}" for m in dir(obj)
                        if not m.startswith("_") and not hasattr(theirs, m)
                        and f"{name}.{m}" not in NOT_PORTED]
    assert not missing, f"{port.__name__} lacks {missing}"


def test_exclusions_are_still_needed():
    """Every exclusion names something the reference has and the port
    lacks: a name the port gains leaves the list."""
    for entry in NOT_PORTED:
        *path, name = entry.split(".")
        owner = ".".join(path)
        if owner[:1].isupper():  # Class.attribute
            ref_owner, port_owner = getattr(H, owner), getattr(T, owner)
        else:
            ref_owner = _module(H, owner)
            port_owner = _module(T, owner)
        assert hasattr(ref_owner, name), entry
        assert not hasattr(port_owner, name), entry


def test_generator_dtype():
    gen = T.FunctionGenerator(lambda J, K: np.zeros((len(J), len(K))))
    assert gen.dtype(np.float32) == np.float32
    assert H.FunctionGenerator(lambda J, K: 0).dtype(np.float32) == np.float32


# ---------------------------------------------------------------------------
# get_distributed_information


def _block_rows(nb_cols, symmetry, UPLO, P=3, nb_rows=400, eps=1e-3):
    """(reference builder, port DistributedOperator, port block rows) of
    tests/test_distributed_operator.py's default build, the reference's
    arrays carried over."""
    rng = np.random.RandomState(nb_cols)
    tp = rng.random_sample((3, nb_rows))
    sp = tp if nb_cols == nb_rows else rng.random_sample((3, nb_cols))
    A = 1.0 / (0.1 + np.linalg.norm(tp[:, :, None] - sp[:, None, :], axis=0))
    clusters = {}
    for pkg in (H, T):
        b = pkg.ClusterTreeBuilder()
        b.set_maximal_leaf_size(16)
        t = b.create_cluster_tree(tp, 2, size_of_partition=P)
        clusters[pkg] = (t, t if sp is tp else b.create_cluster_tree(sp, 2))
    hb = H.HMatrixTreeBuilder(eps, 10.0, symmetry, UPLO)
    hb.set_dtype(np.float64)
    ref = H.DefaultApproximationBuilder(ReferenceHostGenerator(A),
                                        *clusters[H], hb, None)
    rows = [(h.plan, {k: [tuple(np.asarray(a) for a in e) for e in v]
                      for k, v in h._data.items()}, h._lr_ranks, h.epsilon)
            for h in ref.hmatrix]
    op = interop.distributed_from_reference(*clusters[T], rows, "cpu")
    hms = interop.block_rows_from_reference(*clusters[T], rows, "cpu")
    return ref, op, hms


@pytest.mark.parametrize("nb_cols,symmetry,UPLO", [
    (400, "N", "N"), (400, "S", "L"), (400, "S", "U"), (200, "N", "N")])
def test_distributed_information_matches_reference(nb_cols, symmetry, UPLO):
    ref, op, hms = _block_rows(nb_cols, symmetry, UPLO)
    for ref_h, h in zip(ref.hmatrix, hms):
        assert h.get_distributed_information() == \
            ref_h.get_distributed_information()
        assert h.get_distributed_information(comm=object()) == \
            h.get_distributed_information()
    assert op.get_distributed_information() == \
        ref.distributed_operator.get_distributed_information()


_WORKER = """
import json, sys, torch
import htool_python_torch as T
from htool_python_torch.parallel import dryrun
from htool_python_torch.parallel.multihost import initialize_distributed
torch.set_num_threads(1)
rendezvous, rank = sys.argv[1], int(sys.argv[2])
assert initialize_distributed("file://" + rendezvous, 2, rank, "gloo")
_, _, approx = dryrun.build_problem(T, torch, 2, torch.device("cpu"))
out = {"gathered": approx.hmatrix[rank].get_distributed_information(),
       "single": approx.distributed_operator.get_distributed_information()}
torch.distributed.destroy_process_group()
print("INFO " + json.dumps(out), flush=True)
"""


def test_distributed_information_in_a_gloo_world(tmp_path):
    """Each of 2 processes passes its own block row (as each MPI rank does
    in the reference); the all-gathered stats equal the single-process
    reduction over both block rows."""
    env = dict(os.environ, OMP_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1",
               MKL_NUM_THREADS="1",
               PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get(
                   "PYTHONPATH", ""))
    rendezvous = str(tmp_path / "rendezvous")
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, rendezvous,
                               str(rank)], cwd=ROOT, env=env, text=True,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT)
             for rank in range(2)]
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=120)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    for proc, out in zip(procs, outs):
        assert proc.returncode == 0, out
        lines = [ln for ln in out.splitlines() if ln.startswith("INFO ")]
        info = json.loads(lines[-1][5:])
        assert info["gathered"] == info["single"]
        assert info["gathered"]["Number_of_partitions"] == "2"


# ---------------------------------------------------------------------------
# lowrank_leaves and compact_for_products


def _reference_operator(dtype, n=400, leaf=24, eps=1e-4):
    points = np.random.RandomState(8).rand(3, n)
    A = 1.0 / (0.1 + np.linalg.norm(points[:, :, None] - points[:, None, :],
                                    axis=0))
    clusters = []
    for pkg in (H, T):
        b = pkg.ClusterTreeBuilder()
        b.set_maximal_leaf_size(leaf)
        clusters.append(b.create_cluster_tree(points, 2))
    hb = H.HMatrixTreeBuilder(eps, 10.0, "N", "N")
    hb.set_dtype(dtype)
    hm = hb.build(ReferenceHostGenerator(A), clusters[0], clusters[0])
    return hm, port_operator(hm, clusters[1])


def test_lowrank_leaves_match_reference():
    ref, port = _reference_operator(np.float64)
    ours, theirs = port.lowrank_leaves(), ref.lowrank_leaves()
    assert len(ours) == len(theirs) > 0
    for (U, V, b, r), (rU, rV, rb, rr) in zip(ours, theirs):
        assert isinstance(U, np.ndarray) and U.shape == rU.shape
        assert V.shape == rV.shape and U.shape[2] == V.shape[1]
        assert np.abs(U - rU).max() <= 1e-12 * np.abs(rU).max()
        assert np.abs(V - rV).max() <= 1e-12 * np.abs(rV).max()
        np.testing.assert_array_equal(b.t_off, rb.t_off)
        np.testing.assert_array_equal(r, rr)
    U, *_ = ours[0]
    U[...] = 0  # a copy: the operator keeps its factors
    assert np.abs(port.lowrank_leaves()[0][0]).max() > 0


@pytest.fixture
def aligned_layout():
    cfg = get_config()
    before = cfg.matvec_aligned_layout
    cfg.matvec_aligned_layout = True
    yield
    cfg.matvec_aligned_layout = before


def test_compact_for_products(aligned_layout):
    _, hm = _reference_operator(np.float32)
    rng = np.random.RandomState(3)
    x, X = rng.rand(400).astype(np.float32), rng.rand(400, 5).astype(
        np.float32)
    before = (hm * x, hm @ X, hm.matvec(x, "T"))
    hm.compact_for_products()
    assert hm._data is None and hm._product_data() is hm._aligned
    after = (hm * x, hm @ X, hm.matvec(x, "T"))
    for a, b in zip(before, after):
        np.testing.assert_array_equal(a, b)
    twin = copy.deepcopy(hm)
    np.testing.assert_array_equal(twin * x, before[0])
    for h in (hm, twin):
        for call in (h.to_dense, h.to_dense_in_user_numbering,
                     h.lowrank_leaves, h.lu_factorization,
                     lambda: T.recompression(h)):
            with pytest.raises(RuntimeError, match="compact_for_products"):
                call()
    hm.compact_for_products()  # a second call changes nothing
    np.testing.assert_array_equal(hm * x, before[0])


def test_compact_for_products_without_a_second_layout():
    """Without the aligned layout products read the assembly arrays, and
    compaction keeps them (the reference's no-op)."""
    _, hm = _reference_operator(np.float32)
    dense = hm.to_dense()
    hm.compact_for_products()
    assert hm._data is not None
    np.testing.assert_array_equal(hm.to_dense(), dense)


# ---------------------------------------------------------------------------
# plot


@pytest.mark.parametrize("dimension", [2, 3])
def test_cluster_plot(dimension):
    """tests/test_cluster.py:69-82's cases: the whole tree and a partition,
    at depths 1 and 2, on a 2-D and a 3-D cloud, 2 partitions."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    points = np.random.RandomState(dimension).rand(dimension, 500)
    cluster = T.ClusterTreeBuilder().create_cluster_tree(
        points, 2, size_of_partition=2)
    local = cluster.get_cluster_on_partition(0)
    fig, ax = plt.subplots(2, 2)
    for a, (c, depth) in zip(ax.flat, [(cluster, 1), (cluster, 2),
                                       (local, 1), (local, 2)]):
        assert T.plot(a, c, points, depth) is a
        assert len(a.collections) >= 2  # one scatter a cluster
    fig3 = plt.figure()
    ax3 = fig3.add_subplot(projection="3d")
    T.utils.plot(ax3, cluster, points)
    plt.close(fig)
    plt.close(fig3)


def test_hmatrix_plot():
    """tests/test_hmatrix.py:342's case (200 points, leaf 10), and a
    PerPartition drawing its first element."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    points = np.random.RandomState(0).rand(3, 200)
    builder = T.ClusterTreeBuilder()
    builder.set_maximal_leaf_size(10)
    cluster = builder.create_cluster_tree(points, 2)
    gen = T.KernelGenerator(inverse_distance_kernel(0.1), points, points,
                            device="cpu")
    hm = T.HMatrixTreeBuilder(1e-3, 10.0, "N", "N", device="cpu").build(
        gen, cluster, cluster)
    fig, ax = plt.subplots(1, 2)
    T.plot(ax[0], hm)
    blocks = sum(b.nb for b in hm.plan.dense_buckets
                 + hm.plan.lowrank_buckets)
    assert len(ax[0].patches) == blocks
    T.plot(ax[1], T.parallel.PerPartition([hm]))
    assert len(ax[1].patches) == blocks
    with pytest.raises(TypeError):
        T.plot(ax[0], "not a cluster")
    plt.close(fig)


def test_imports_without_matplotlib():
    """The card's machine has no matplotlib: the package, every subpackage
    and every example module import without it."""
    code = (
        "import sys, importlib, pkgutil\n"
        "sys.modules['matplotlib'] = None\n"
        "import htool_python_torch as T\n"
        "for m in pkgutil.walk_packages(T.__path__, 'htool_python_torch.'):\n"
        "    if m.name.endswith('__main__'): continue\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'htool_python_tpu', 'matplotlib') and sys.modules[m]]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, text=True,
                         capture_output=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
