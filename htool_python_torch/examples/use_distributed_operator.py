"""Row-partitioned distributed operator.

The port of the reference's example/use_distributed_operator.py: the
reference runs P MPI processes, each assembling the H-matrix block row of
its target partition.  Here the P block rows live in one process
(`DefaultApproximationBuilder`), on the card; `ShardedDistributedOperator`
lays the same block rows over the processes of a torch.distributed group
(without one, this process holds them all).  Problem: 1200 + 1200 points
by `create_partitioned_geometries`, 1/(0.1 + r), epsilon 1e-3, eta 10,
leaf 32, float32, then `openmp_recompression`.

    python -m htool_python_torch.examples.use_distributed_operator [--cpu] [--partitions P]
"""

import numpy as np
import torch

from .. import (ClusterTreeBuilder, DefaultApproximationBuilder,
                HMatrixTreeBuilder, openmp_recompression)
from ..config import resolve_device
from ..parallel.sharded import ShardedDistributedOperator
from ._common import rel_err
from .create_geometry import create_partitioned_geometries
from .define_generators import make_device_generator

EPSILON = 1e-3


def build_operator(P, device):
    # pre-partitioned geometry: P shifted clusters + the (2, P) offset/size
    # table describing the contiguous user-numbering partition
    target_pts, source_pts, partition = create_partitioned_geometries(
        3, 1200, 1200, P)
    cb = ClusterTreeBuilder()
    cb.set_maximal_leaf_size(32)
    target = cb.create_cluster_tree_from_local_partition(
        target_pts, 2, P, partition)
    source = cb.create_cluster_tree(source_pts, 2)
    gen = make_device_generator(target_pts, source_pts, device)
    hb = HMatrixTreeBuilder(EPSILON, 10.0, "N", "N", device=device)
    hb.set_dtype(torch.float32)
    approx = DefaultApproximationBuilder(gen, target, source, hb, None)
    return target_pts, source_pts, target, source, approx


def _run(device=None, partitions=2):
    device = resolve_device(device)
    P = partitions
    rng = np.random.RandomState(0)
    tp, sp, target, source, approx = build_operator(P, device)
    op = approx.distributed_operator
    n = op.shape[1]

    # post-assembly rank re-truncation of every block row
    openmp_recompression(approx.hmatrix)

    # dense oracle for the accuracy check
    d = np.linalg.norm(tp[:, :, None] - sp[:, None, :], axis=0)
    A = 1.0 / (0.1 + d)

    x = rng.rand(n).astype(np.float32)
    y = op * x
    rel = rel_err(y, A @ x)
    print(f"global matvec rel err {rel:.2e}")
    assert rel < EPSILON

    X = np.asfortranarray(rng.rand(n, 3).astype(np.float32))
    rel_m = rel_err(op @ X, A @ X)
    print(f"global matmat rel err {rel_m:.2e}")
    assert rel_m < EPSILON

    # the solver's loop never leaves the device: build_device_apply gives
    # the product as a function of device tensors
    fn = op.build_device_apply()
    x_dev = torch.as_tensor(x[:, None], device=device)
    y_dev = fn(x_dev)[:, 0].cpu().numpy()
    rel_dev = rel_err(y_dev, y)
    assert rel_dev < 1e-5  # float32: the same products, summed in another order

    # the block rows laid over the processes of a torch.distributed group
    # (this process holds them all without one)
    sharded = ShardedDistributedOperator(approx.hmatrix, target, source)
    rel_sharded = rel_err(sharded * x, y)
    print("sharded product matches:", rel_sharded)
    assert rel_sharded < 1e-5

    info = op.get_distributed_information()
    print("shape:", op.shape)
    print(info)
    assert info["Number_of_partitions"] == str(P)
    numbers = dict(matvec_rel_err=rel, matmat_rel_err=rel_m,
                   device_apply_rel_diff=rel_dev,
                   sharded_rel_diff=rel_sharded,
                   compression_ratio=float(info["Compression_ratio"]))
    return numbers, (tp, target, approx, P)


def run(device=None, partitions=2) -> dict:
    """The example's computation and checks; returns its numbers."""
    return _run(device, partitions)[0]


def main(argv=None):
    from .. import plot
    from ._common import cli, figure, finish_plot

    args = cli(__doc__, argv)
    _, (tp, target, approx, P) = _run(args.device, args.partitions)
    fig = figure(args.show)
    ax1 = fig.add_subplot(1, 2, 1, projection="3d")
    ax2 = fig.add_subplot(1, 2, 2)
    ax1.set_title(f"target partitions (P={P})")
    ax2.set_title("block row of partition 0")
    plot(ax1, target, tp, 1)
    plot(ax2, approx.hmatrix[0])
    finish_plot(fig, __file__, args.show)


if __name__ == "__main__":
    main()
