"""The port's sharded operator against the reference's (CPU, float64).

* P in {2, 4, 8} partitions on one process: the reference's
  `ShardedDistributedOperator` on the conftest's 8 virtual CPU devices and
  the port's on the same block rows (carried over with
  `interop.block_rows_from_reference`): 'N', 'T' and 3-column products
  within 1e-12; `sharded_block_solve` on the reference's
  test_sharded_block_solve case within 1e-12 of the reference's.
* Spawned gloo worlds (the dryrun's workers, `parallel/dryrun.py`): 2
  processes with P = 2 and 4, 4 processes with P = 4, each joined under a
  timeout, on a rendezvous file in tmp_path so that concurrent test
  workers never share a port.
* A P that the world size does not divide raises ValueError.

The reference assembles through its host-generator path (no XLA compile
but the sharded programs').
"""

import jax
import numpy as np
import pytest
import torch

import htool_python_torch as T
import htool_python_tpu as H
from htool_python_torch import interop
from htool_python_torch.parallel import dryrun
from htool_python_torch.parallel.multihost import (partition_range,
                                                   rank_partitions)
from htool_python_torch.parallel.sharded import (ShardedDistributedOperator,
                                                 sharded_block_solve)
from htool_python_tpu.parallel import sharded as ref_sharded
from test_torch_complex import ReferenceHostGenerator, one_thread  # noqa: F401

_N, _LEAF, _EPS = 400, 16, 1e-6


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.fixture(scope="module")
def problems():
    """{P: (reference builder, reference sharded operator, port sharded
    operator, matrix)} on the same points and block rows."""
    rng = np.random.RandomState(0)
    points = rng.random_sample((3, _N))
    d = np.linalg.norm(points[:, :, None] - points[:, None, :], axis=0)
    A = 1.0 / (0.1 + d)
    out = {}
    for P in (2, 4, 8):
        clusters = []
        for pkg in (H, T):
            b = pkg.ClusterTreeBuilder()
            b.set_maximal_leaf_size(_LEAF)
            clusters.append(b.create_cluster_tree(points, 2,
                                                  size_of_partition=P))
        ref_cluster, port_cluster = clusters
        hb = H.HMatrixTreeBuilder(_EPS, 10.0, "N", "N")
        hb.set_dtype(np.float64)
        ref = H.DefaultApproximationBuilder(ReferenceHostGenerator(A),
                                            ref_cluster, ref_cluster, hb,
                                            None)
        ref_op = ref_sharded.ShardedDistributedOperator(
            ref.hmatrix, ref_cluster, ref_cluster, ref_sharded.make_mesh(P))
        rows = [(h.plan, jax.tree_util.tree_map(np.asarray, h._data),
                 h._lr_ranks, h.epsilon) for h in ref.hmatrix]
        port_op = ShardedDistributedOperator(
            interop.block_rows_from_reference(port_cluster, port_cluster,
                                              rows, "cpu"),
            port_cluster, port_cluster)
        out[P] = (ref, ref_op, port_op, A)
    return out


@pytest.mark.parametrize("P", [2, 4, 8])
def test_sharded_products_match_reference(problems, P):
    ref, ref_op, op, A = problems[P]
    assert op.partitions == range(P) and op.n_partitions == P
    assert np.array_equal(op.t_offsets, ref_op.t_offsets)
    assert np.array_equal(op.t_sizes, ref_op.t_sizes)
    assert all(h.dtype == torch.float64 for h in op.hmatrices)
    rng = np.random.RandomState(P)
    x = rng.rand(_N)
    y = op * x
    assert isinstance(y, np.ndarray) and y.shape == (_N,)
    assert _rel(y, np.asarray(ref_op * x)) <= 1e-12
    assert _rel(y, ref.distributed_operator * x) <= 1e-12
    assert _rel(y, A @ x) < 10 * _EPS
    yt = op.matvec_global(x, "T")
    assert _rel(yt, np.asarray(ref_op.matvec_global(x, trans="T"))) <= 1e-12
    X = rng.rand(_N, 3)
    assert _rel(op @ X, np.asarray(ref_op @ X)) <= 1e-12
    # a tensor in gives a tensor out, and the device apply is the same map
    Xt = torch.as_tensor(X)
    Y = op.matvec_global(Xt)
    assert torch.is_tensor(Y) and _rel(Y.numpy(), op @ X) <= 1e-15
    assert _rel(op.build_device_apply("T")(Xt).numpy(),
                op.matvec_global(X, "T")) <= 1e-15


def test_sharded_block_solve_matches_reference():
    """The reference's test_sharded_block_solve case: random overlapping
    index sets, a boolean partition of unity on the owned dofs."""
    import jax.numpy as jnp
    import jax.scipy.linalg as jsl

    rng = np.random.RandomState(1)
    n, P, m = 64, 4, 24
    idx = np.zeros((P, m), dtype=np.int64)
    own = np.array_split(np.arange(n), P)
    weights = np.zeros((P, m))
    A = rng.rand(n, n) + n * np.eye(n)
    mats = np.zeros((P, m, m))
    for p in range(P):
        extra = rng.choice(np.setdiff1d(np.arange(n), own[p]),
                           m - len(own[p]), replace=False)
        ids = np.concatenate([own[p], extra])
        idx[p] = ids
        weights[p, :len(own[p])] = 1.0
        mats[p] = A[np.ix_(ids, ids)]
    lu_ref, piv_ref = jsl.lu_factor(jnp.asarray(mats))
    ref = ref_sharded.sharded_block_solve(ref_sharded.make_mesh(P), lu_ref,
                                          piv_ref, idx, weights, n)
    lu, piv = torch.linalg.lu_factor(torch.as_tensor(mats))
    precond = sharded_block_solve(lu, piv, idx, weights, n)
    r = rng.rand(n)
    z = precond(r)
    z_ref = np.zeros(n)
    for p in range(P):
        z_ref[idx[p]] += weights[p] * np.linalg.solve(mats[p], r[idx[p]])
    assert _rel(z, np.asarray(ref(r))) <= 1e-12
    assert _rel(z, z_ref) <= 1e-12
    R = torch.as_tensor(rng.rand(n, 3))
    Z = precond.device_apply(R)
    assert Z.shape == (n, 3)
    assert _rel(Z[:, 1].numpy(), precond(R[:, 1].numpy())) <= 1e-15


@pytest.mark.parametrize("processes,partitions", [(2, 2), (2, 4), (4, 4)])
def test_spawned_gloo_world(tmp_path, processes, partitions):
    """The dryrun's workers in a gloo world on a rendezvous file: every
    check of `dryrun.run_checks` (products and preconditioner within 1e-10
    of the single-process operator, GMRES to 1e-8) on every rank, every
    process joined within the timeout."""
    rc, results = dryrun.launch(processes, partitions, cpu=True, timeout=150,
                                rendezvous_dir=tmp_path)
    assert rc == 0, results
    assert len(results) == processes
    for code, out in results:
        assert code == 0 and '"ok": true' in out, out


def test_wrong_partition_count_raises(problems):
    _, _, op, _ = problems[2]
    with pytest.raises(ValueError, match="partitions"):
        ShardedDistributedOperator(op.hmatrices[:1], op.target_cluster,
                                   op.source_cluster)
    assert rank_partitions(8) == range(8)  # one process holds them all
    assert partition_range(8, 4, 1) == range(2, 4)
    assert partition_range(4, 2, 1) == range(2, 4)
    for P, world in ((3, 2), (4, 3), (2, 4), (0, 1)):
        with pytest.raises(ValueError, match="cannot be laid"):
            partition_range(P, world, 0)
