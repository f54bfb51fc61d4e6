"""Geometric cluster trees: the host-side setup stage of every workflow.

The port of the reference's example/use_cluster.py: the four splitting
policies (`PCARegular`, `PCAGeometric`, `BoundingBoxRegular`,
`BoundingBoxGeometric`) on one cloud of 600 points, a partitioned tree
(the top split defines P contiguous row blocks of the internal
numbering, the unit a distributed operator works on), the permutation,
and the cluster picture.  The trees are built on the host by the native
C++ builder.

    python -m htool_python_torch.examples.use_cluster [--cpu] [--partitions P]
"""

import numpy as np

from .. import (BoundingBoxGeometric, BoundingBoxRegular, ClusterTreeBuilder,
               PCAGeometric, PCARegular)
from ..config import resolve_device
from .create_geometry import create_random_points_in_sphere


def build_tree(points, strategy, leaf_size=16, children=2, partitions=None):
    builder = ClusterTreeBuilder()
    builder.set_maximal_leaf_size(leaf_size)
    builder.set_partitioning_strategy(strategy)
    if partitions:
        return builder.create_cluster_tree(points, children,
                                           size_of_partition=partitions)
    return builder.create_cluster_tree(points, children)


def _run(device=None, partitions=2):
    resolve_device(device)  # the trees live on the host; the rule holds
    points = create_random_points_in_sphere(600, np.random.RandomState(7))

    # compare the four splitting policies on the same cloud
    strategies = {
        "PCARegular": PCARegular(),
        "PCAGeometric": PCAGeometric(),
        "BoundingBoxRegular": BoundingBoxRegular(),
        "BoundingBoxGeometric": BoundingBoxGeometric(),
    }
    trees = {name: build_tree(points, s) for name, s in strategies.items()}
    for name, tree in trees.items():
        leaf = tree.get_maximal_leaf_size()
        print(f"{name:22s} size={tree.get_size()} max_leaf={leaf}")

    # a partitioned tree: the top split defines P contiguous row blocks
    part_tree = build_tree(points, PCARegular(), partitions=partitions)
    parts = []
    for p in range(partitions):
        node = part_tree.get_cluster_on_partition(p)
        parts.append((node.get_offset(), node.get_size()))
        print(f"partition {p}: offset={node.get_offset()} "
              f"size={node.get_size()}")
    assert sum(size for _, size in parts) == len(points[0])

    # the permutation maps user point indices -> leaf-contiguous internal
    # order; products apply it at the device boundary
    perm = part_tree.get_permutation()
    assert sorted(perm) == list(range(len(perm)))

    numbers = {
        "sizes": {name: t.get_size() for name, t in trees.items()},
        "max_leaf": {name: t.get_maximal_leaf_size()
                     for name, t in trees.items()},
        "partitions": parts,
        "permutations": dict({name: t.get_permutation()
                              for name, t in trees.items()},
                             partitioned=perm),
    }
    return numbers, (points, trees["PCARegular"], part_tree, partitions)


def run(device=None, partitions=2) -> dict:
    """The example's computation and checks; returns its numbers."""
    return _run(device, partitions)[0]


def main(argv=None):
    from .. import plot
    from ._common import cli, figure, finish_plot

    args = cli(__doc__, argv)
    _, (points, tree, part_tree, P) = _run(args.device, args.partitions)
    fig = figure(args.show)
    axes = [fig.add_subplot(1, 2, i + 1, projection="3d") for i in range(2)]
    axes[0].set_title("PCARegular, depth 2")
    axes[1].set_title(f"partitioned tree, depth 1 (P={P})")
    plot(axes[0], tree, points, 2)
    plot(axes[1], part_tree, points, 1)
    finish_plot(fig, __file__, args.show)


if __name__ == "__main__":
    main()
