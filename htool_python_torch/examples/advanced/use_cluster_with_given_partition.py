"""Cluster trees over a partition the application already owns.

The port of the reference's
example/advanced/use_cluster_with_given_partition.py.  When the row
distribution comes from outside (a mesh partitioner, an existing
decomposition), the tree keeps it as its top split.  Two input formats,
as in the reference: a (2, P) table of (offset, size) pairs (partition p
is the user-index range [offset_p, offset_p + size_p)), or one partition
label per point.  Below the partition level the builder subdivides
normally.  600 points, leaf 20.

    python -m htool_python_torch.examples.advanced.use_cluster_with_given_partition [--cpu] [--partitions P]
"""

import numpy as np

from ... import ClusterTreeBuilder
from ...config import resolve_device
from ..create_geometry import create_partitioned_geometries


def _run(device=None, partitions=2):
    resolve_device(device)  # the trees live on the host; the rule holds
    P = partitions
    points, _, table = create_partitioned_geometries(3, 600, 600, P)

    builder = ClusterTreeBuilder()
    builder.set_maximal_leaf_size(20)

    # format 1: (2, P) offset/size table
    tree_local = builder.create_cluster_tree_from_local_partition(
        points, 2, P, table)

    # format 2: per-point labels describing the same partition
    labels = np.zeros(points.shape[1], dtype=np.int64)
    for p in range(P):
        lo, sz = int(table[0, p]), int(table[1, p])
        labels[lo:lo + sz] = p
    tree_global = builder.create_cluster_tree_from_global_partition(
        points, 2, P, labels)

    # both formats produce the same partition-level layout
    local_parts, global_parts = [], []
    for p in range(P):
        a = tree_local.get_cluster_on_partition(p)
        b = tree_global.get_cluster_on_partition(p)
        assert a.get_size() == b.get_size() == int(table[1, p])
        local_parts.append((a.get_offset(), a.get_size()))
        global_parts.append((b.get_offset(), b.get_size()))
        print(f"partition {p}: size {a.get_size()}, "
              f"internal offset {a.get_offset()}")
    numbers = dict(local_partitions=local_parts,
                   global_partitions=global_parts,
                   nodes=tree_local.tree.nb_nodes)
    return numbers, (points, tree_local)


def run(device=None, partitions=2) -> dict:
    """The example's computation and checks; returns its numbers."""
    return _run(device, partitions)[0]


def main(argv=None):
    from ... import plot
    from .._common import cli, figure, finish_plot

    args = cli(__doc__, argv)
    _, (points, tree) = _run(args.device, args.partitions)
    fig = figure(args.show)
    ax1 = fig.add_subplot(1, 2, 1, projection="3d")
    ax2 = fig.add_subplot(1, 2, 2, projection="3d")
    ax1.set_title("given partition, depth 1")
    ax2.set_title("partition-0 subtree, depth 1")
    plot(ax1, tree, points, 1)
    plot(ax2, tree.get_cluster_on_partition(0), points, 1)
    finish_plot(fig, __file__, args.show)


if __name__ == "__main__":
    main()
