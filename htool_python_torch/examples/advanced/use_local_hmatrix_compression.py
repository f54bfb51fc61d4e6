"""Hybrid distributed operator: compressed diagonal, custom off-diagonal.

The port of the reference's
example/advanced/use_local_hmatrix_compression.py:
`DefaultLocalApproximationBuilder` compresses only each partition's
diagonal block as an H-matrix (float32, on the device, then
`recompression`); the two off-diagonal strips of every partition are
registered as dense user `RestrictedGlobalToLocalOperator`s.  600 points,
epsilon 1e-3, eta 10, leaf 20.

    python -m htool_python_torch.examples.advanced.use_local_hmatrix_compression [--cpu] [--partitions P]
"""

import numpy as np
import torch

from ... import (ClusterTreeBuilder, DefaultLocalApproximationBuilder,
                 HMatrixTreeBuilder, LocalRenumbering, recompression)
from ...config import resolve_device
from .._common import rel_err
from ..create_geometry import create_random_points_in_sphere
from ..define_generators import CustomGenerator
from .define_custom_local_operator import \
    CustomRestrictedGlobalToLocalOperator

EPSILON = 1e-3


def add_offdiagonal_strips(op, generator, target, source, p):
    """Register the two dense strips left and right of partition p's
    diagonal block (either may be empty)."""
    tloc = target.get_cluster_on_partition(p)
    sloc = source.get_cluster_on_partition(p)
    lo, sz = sloc.get_offset(), sloc.get_size()
    total = source.get_size()
    perm = source.get_permutation()
    for off, width in [(0, lo), (lo + sz, total - lo - sz)]:
        if width > 0:
            op.add_global_to_local_operator(
                CustomRestrictedGlobalToLocalOperator(
                    generator, LocalRenumbering(tloc),
                    LocalRenumbering(off, width, perm)), p)


def _run(device=None, partitions=2):
    device = resolve_device(device)
    P = partitions
    rng = np.random.RandomState(2)
    n = 600
    points = create_random_points_in_sphere(n, rng)
    cb = ClusterTreeBuilder()
    cb.set_maximal_leaf_size(20)
    target = cb.create_cluster_tree(points, 2, size_of_partition=P)
    source = cb.create_cluster_tree(points, 2, size_of_partition=P)
    oracle = CustomGenerator(points, points)

    hb = HMatrixTreeBuilder(EPSILON, 10.0, "N", "N", device=device)
    hb.set_dtype(torch.float32)
    local_approx = DefaultLocalApproximationBuilder(
        oracle, target, source, hb, None)
    op = local_approx.distributed_operator
    recompression(local_approx.hmatrix)

    for p in range(P):
        add_offdiagonal_strips(op, oracle, target, source, p)

    x = rng.rand(n).astype(np.float32)
    rel = rel_err(op * x, oracle.mat_vec(x))
    print(f"hybrid matvec rel err {rel:.2e}")
    assert rel < EPSILON

    X = np.asfortranarray(rng.rand(n, 5).astype(np.float32))
    rel_m = rel_err(op @ X, oracle.mat_mat(X))
    print(f"hybrid matmat rel err {rel_m:.2e}")
    assert rel_m < EPSILON

    info = local_approx.hmatrix[0].get_local_information()
    print(info)
    numbers = dict(matvec_rel_err=rel, matmat_rel_err=rel_m,
                   compression_ratio=float(info["Compression_ratio"]))
    return numbers, (points, source, local_approx, P)


def run(device=None, partitions=2) -> dict:
    """The example's computation and checks; returns its numbers."""
    return _run(device, partitions)[0]


def main(argv=None):
    from ... import plot
    from .._common import cli, figure, finish_plot

    args = cli(__doc__, argv)
    _, (points, source, local_approx, P) = _run(args.device, args.partitions)
    fig = figure(args.show)
    ax1 = fig.add_subplot(1, 2, 1, projection="3d")
    ax2 = fig.add_subplot(1, 2, 2)
    ax1.set_title(f"source partitions (P={P})")
    ax2.set_title("compressed diagonal block, partition 0")
    plot(ax1, source, points, 1)
    plot(ax2, local_approx.hmatrix[0])
    finish_plot(fig, __file__, args.show)


if __name__ == "__main__":
    main()
