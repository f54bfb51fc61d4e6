"""Cluster-tree (de)serialization to CSV.

Copy of htool_python_tpu/clustering/io.py, reading and writing the same
two-file CSV format (`*_cluster_tree_properties.csv` +
`*_cluster_tree.csv`), so that the port loads the clusters of the DDM
golden data (data/htool_generated_data, tools/generate_test_data.py).

Format:
  properties csv:
    line 1: nb_nodes,n_points,dim,maximal_leaf_size,nb_partitions
    line 2: permutation (comma-separated, internal position -> user index)
    line 3: partition node ids (comma-separated)
  tree csv: one line per node:
    offset,size,depth,parent,children_start,children_count,radius,center...
"""

from __future__ import annotations

import numpy as np

from .cluster import Cluster, ClusterTree


def write_cluster_to(cluster: Cluster, properties_path: str, tree_path: str) -> None:
    t = cluster.tree
    with open(properties_path, "w") as f:
        f.write(f"{t.nb_nodes},{len(t.permutation)},{t.dim},"
                f"{t.maximal_leaf_size},{len(t.partition)}\n")
        f.write(",".join(str(int(i)) for i in t.permutation) + "\n")
        f.write(",".join(str(int(i)) for i in t.partition) + "\n")
    with open(tree_path, "w") as f:
        for n in range(t.nb_nodes):
            row = [int(t.offsets[n]), int(t.sizes[n]), int(t.depths[n]),
                   int(t.parents[n]), int(t.children_start[n]),
                   int(t.children_count[n]), float(t.radii[n])]
            row += [float(c) for c in t.centers[n]]
            f.write(",".join(str(v) for v in row) + "\n")


def read_cluster_from(properties_path: str, tree_path: str) -> Cluster:
    with open(properties_path) as f:
        header = f.readline().strip().split(",")
        try:
            nb_nodes, n_points, dim, mls, nb_part = (int(v) for v in header)
        except ValueError:
            raise ValueError(
                f"{properties_path!r} is not in the cluster CSV format "
                "(header must be 'nb_nodes,n_points,dim,maximal_leaf_size,"
                "nb_partitions'); write it with write_cluster_to()") from None
        permutation = np.array([int(v) for v in f.readline().strip().split(",")],
                               dtype=np.int64)
        partition = np.array([int(v) for v in f.readline().strip().split(",")],
                             dtype=np.int64)
    if len(permutation) != n_points or len(partition) != nb_part:
        raise ValueError(f"{properties_path!r}: the permutation or partition "
                         "length disagrees with the header")

    offsets = np.empty(nb_nodes, dtype=np.int64)
    sizes = np.empty(nb_nodes, dtype=np.int64)
    depths = np.empty(nb_nodes, dtype=np.int64)
    parents = np.empty(nb_nodes, dtype=np.int64)
    children_start = np.empty(nb_nodes, dtype=np.int64)
    children_count = np.empty(nb_nodes, dtype=np.int64)
    radii = np.empty(nb_nodes, dtype=np.float64)
    centers = np.empty((nb_nodes, dim), dtype=np.float64)
    with open(tree_path) as f:
        for n, line in enumerate(f):
            vals = line.strip().split(",")
            offsets[n], sizes[n], depths[n], parents[n] = (
                int(vals[0]), int(vals[1]), int(vals[2]), int(vals[3]))
            children_start[n], children_count[n] = int(vals[4]), int(vals[5])
            radii[n] = float(vals[6])
            centers[n] = [float(v) for v in vals[7:7 + dim]]

    tree = ClusterTree(
        points=None,  # geometry is not persisted; block planning uses centers/radii
        offsets=offsets, sizes=sizes, depths=depths, parents=parents,
        children_start=children_start, children_count=children_count,
        centers=centers, radii=radii, partition=partition,
        permutation=permutation, maximal_leaf_size=mls,
    )
    return Cluster(tree, 0)
