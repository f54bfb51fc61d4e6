"""Cluster tree: geometric hierarchical clustering of point clouds.

Copy of htool_python_tpu/clustering/cluster.py: the port's equivalent of
the reference's `Cluster<T>` / `ClusterTreeBuilder<T>` (reference
bindings: src/htool/clustering/cluster_node.hpp:13-27 and
src/htool/clustering/cluster_tree_builder.hpp:13-68).  Built once on the
host — by the native C++ builder (native/) for the four built-in
policies, in numpy for user policies —, stored as flat arrays
(structure-of-arrays) so downstream block planning and device kernels can
consume it without pointer chasing.

Conventions (pinned by reference tests, tests/test_distributed_operator.py:105-129):
  permutation[internal_position] = user_index
so x_internal = x_user[permutation] and y_user[permutation] = y_internal.
Node offsets/sizes index the *internal* (leaf-contiguous) numbering.
"""

from __future__ import annotations

import numpy as np

from .partitioning import (BoundingBoxGeometric, BoundingBoxRegular,
                           PCAGeometric, PCARegular, VirtualPartitioning)


class ClusterTree:
    """Flat-array storage of a cluster tree.

    Arrays indexed by node id (root = 0, children contiguous):
      offsets, sizes, depths, parents : int64
      children_start, children_count : int64  (children of n are
          [children_start[n], children_start[n]+children_count[n]) )
      centers : (nnodes, dim) float64
      radii   : (nnodes,) float64   (max distance center->point (+point radius))
      partition : (P,) int64 node ids of the partition-level clusters
      permutation : (N,) int64, internal position -> user index
    """

    def __init__(self, points, offsets, sizes, depths, parents, children_start,
                 children_count, centers, radii, partition, permutation,
                 maximal_leaf_size):
        self.points = points  # (dim, N) user-numbered coordinates
        self.offsets = offsets
        self.sizes = sizes
        self.depths = depths
        self.parents = parents
        self.children_start = children_start
        self.children_count = children_count
        self.centers = centers
        self.radii = radii
        self.partition = partition
        self.permutation = permutation
        self.maximal_leaf_size = maximal_leaf_size

    @property
    def nb_nodes(self) -> int:
        return len(self.sizes)

    @property
    def dim(self) -> int:
        return self.centers.shape[1]

    def children_of(self, node: int) -> range:
        s = int(self.children_start[node])
        return range(s, s + int(self.children_count[node]))

    def is_leaf(self, node: int) -> bool:
        return int(self.children_count[node]) == 0

    def root_cluster(self) -> "Cluster":
        return Cluster(self, 0)

    def max_depth(self) -> int:
        return int(self.depths.max())


class Cluster:
    """View of one node of a ClusterTree (reference: `Cluster` python class,
    clustering/cluster_node.hpp:13-27)."""

    __slots__ = ("tree", "node")

    def __init__(self, tree: ClusterTree, node: int):
        self.tree = tree
        self.node = int(node)

    # ---- reference API ----
    def get_size(self) -> int:
        return int(self.tree.sizes[self.node])

    def get_offset(self) -> int:
        return int(self.tree.offsets[self.node])

    def get_depth(self) -> int:
        return int(self.tree.depths[self.node])

    def get_maximal_leaf_size(self) -> int:
        return int(self.tree.maximal_leaf_size)

    def get_minimal_depth(self) -> int:
        return int(self.tree.depths[self.node])

    def get_maximal_depth(self) -> int:
        out = self.get_depth()
        stack = [self.node]
        while stack:
            n = stack.pop()
            out = max(out, int(self.tree.depths[n]))
            stack.extend(self.tree.children_of(n))
        return out

    def get_permutation(self) -> np.ndarray:
        """Full-tree permutation, internal position -> user index (zero-copy)."""
        return self.tree.permutation

    def get_cluster_on_partition(self, rank: int) -> "Cluster":
        return Cluster(self.tree, int(self.tree.partition[rank]))

    def get_clusters_on_partition(self):
        return [Cluster(self.tree, int(p)) for p in self.tree.partition]

    def nb_partitions(self) -> int:
        return len(self.tree.partition)

    def is_leaf(self) -> bool:
        return self.tree.is_leaf(self.node)

    def get_children(self):
        return [Cluster(self.tree, c) for c in self.tree.children_of(self.node)]

    def get_center(self) -> np.ndarray:
        return self.tree.centers[self.node]

    def get_radius(self) -> float:
        return float(self.tree.radii[self.node])

    def __repr__(self):
        return (f"Cluster(node={self.node}, offset={self.get_offset()}, "
                f"size={self.get_size()}, depth={self.get_depth()})")


class ClusterTreeBuilder:
    """Builds a ClusterTree from (dim, N) coordinates.

    Reference parity: src/htool/clustering/cluster_tree_builder.hpp:13-68 —
    `create_cluster_tree(coords, nb_children, size_of_partition=, radii=,
    weights=)`, `create_cluster_tree_from_global_partition`,
    `create_cluster_tree_from_local_partition`, `set_maximal_leaf_size`,
    `set_partitioning_strategy`.
    """

    def __init__(self):
        self._maximal_leaf_size = 10
        self._strategy: VirtualPartitioning = PCARegular()
        self._minimal_depth = 0

    def set_maximal_leaf_size(self, n: int) -> None:
        self._maximal_leaf_size = int(n)

    def set_partitioning_strategy(self, strategy: VirtualPartitioning) -> None:
        self._strategy = strategy

    def set_minimal_depth(self, d: int) -> None:
        self._minimal_depth = int(d)

    # ------------------------------------------------------------------
    def create_cluster_tree(self, coordinates, number_of_children,
                            size_of_partition: int = 1, radii=None, weights=None):
        coords = np.ascontiguousarray(np.asarray(coordinates, dtype=np.float64))
        if coords.ndim != 2:
            raise ValueError("coordinates must be (dim, N)")
        n = coords.shape[1]
        radii, weights = self._default_rw(n, radii, weights)
        all_idx = np.arange(n, dtype=np.int64)
        if size_of_partition <= 1:
            top_parts = None
        else:
            top_parts = self._strategy.split(coords, weights, all_idx,
                                             int(size_of_partition))
            if len(top_parts) != size_of_partition:
                raise ValueError(
                    f"cannot split {n} points into {size_of_partition} partitions")
        return self._build(coords, radii, weights, int(number_of_children), top_parts)

    def create_cluster_tree_from_global_partition(self, coordinates,
                                                  number_of_children,
                                                  size_of_partition, partition,
                                                  radii=None, weights=None):
        """`partition` = length-N array of partition labels in [0, P)."""
        coords = np.ascontiguousarray(np.asarray(coordinates, dtype=np.float64))
        n = coords.shape[1]
        radii, weights = self._default_rw(n, radii, weights)
        labels = np.asarray(partition).astype(np.int64)
        top_parts = [np.flatnonzero(labels == p).astype(np.int64)
                     for p in range(int(size_of_partition))]
        return self._build(coords, radii, weights, int(number_of_children), top_parts)

    def create_cluster_tree_from_local_partition(self, coordinates,
                                                 number_of_children,
                                                 size_of_partition, partition,
                                                 radii=None, weights=None):
        """`partition` = (2, P) array of (offset, size) pairs in user numbering."""
        coords = np.ascontiguousarray(np.asarray(coordinates, dtype=np.float64))
        n = coords.shape[1]
        radii, weights = self._default_rw(n, radii, weights)
        part = np.asarray(partition).astype(np.int64)
        top_parts = [np.arange(part[0, p], part[0, p] + part[1, p], dtype=np.int64)
                     for p in range(int(size_of_partition))]
        if sum(len(p) for p in top_parts) != n:
            raise ValueError("local partition does not cover all points")
        return self._build(coords, radii, weights, int(number_of_children), top_parts)

    # ------------------------------------------------------------------
    @staticmethod
    def _default_rw(n, radii, weights):
        radii = (np.zeros(n) if radii is None
                 else np.asarray(radii, dtype=np.float64))
        weights = (np.ones(n) if weights is None
                   else np.asarray(weights, dtype=np.float64))
        return radii, weights

    def _node_geometry(self, coords, radii, weights, idx):
        w = weights[idx]
        wsum = max(w.sum(), np.finfo(np.float64).tiny)
        center = coords[:, idx] @ (w / wsum)
        dist = np.linalg.norm(coords[:, idx] - center[:, None], axis=0) + radii[idx]
        return center, float(dist.max()) if len(idx) else 0.0

    def _build(self, coords, radii, weights, nb_children, top_parts):
        """Core breadth-first build.  `top_parts` = None (no partition) or
        the list of P user-index arrays forming the partition level.

        The four built-in policies take the native C++ builder
        (csrc/cluster_builder.cpp, the reference's production path, the
        same algorithm), which raises if it cannot be built; user
        VirtualPartitioning subclasses, whose splits are Python callbacks,
        take the numpy path (`_build_numpy`), the plain version the native
        tree is tested against."""
        if top_parts is not None and len(top_parts) == 1:
            # single-partition: the partition node is the root itself
            top_parts = None
        kinds = _native_strategy_kinds(self._strategy)
        if kinds is None:
            return self._build_numpy(coords, radii, weights, nb_children,
                                     top_parts)
        from ..native import build_cluster_tree_native

        (offsets, sizes, depths, parents, cstart, ccount, centers, radius_arr,
         partition, permutation) = build_cluster_tree_native(
            coords, radii, weights, nb_children, self._maximal_leaf_size,
            self._minimal_depth, *kinds, top_parts)
        tree = ClusterTree(
            points=coords, offsets=offsets, sizes=sizes, depths=depths,
            parents=parents, children_start=cstart, children_count=ccount,
            centers=centers, radii=radius_arr, partition=partition,
            permutation=permutation,
            maximal_leaf_size=self._maximal_leaf_size)
        return Cluster(tree, 0)

    def _build_numpy(self, coords, radii, weights, nb_children, top_parts):
        """The numpy build (the reference's behaviour-defining path)."""
        offsets, sizes, depths, parents = [], [], [], []
        children_start, children_count = [], []
        centers, radius_arr = [], []
        permutation = np.empty(coords.shape[1], dtype=np.int64)
        partition_nodes = []

        # Iterative BFS so children of a node get contiguous ids.
        # Work items: (user index array, depth, parent id, offset)
        root_idx = np.arange(coords.shape[1], dtype=np.int64)

        def add_node(idx, depth, parent, offset):
            node = len(sizes)
            offsets.append(offset)
            sizes.append(len(idx))
            depths.append(depth)
            parents.append(parent)
            children_start.append(0)
            children_count.append(0)
            c, r = self._node_geometry(coords, radii, weights, idx)
            centers.append(c)
            radius_arr.append(r)
            return node

        root = add_node(root_idx, 0, -1, 0)
        from collections import deque
        queue = deque([(root, root_idx)])
        mls = self._maximal_leaf_size

        while queue:
            node, idx = queue.popleft()
            depth = depths[node]
            offset = offsets[node]
            if node == root and top_parts is not None:
                parts = top_parts
            else:
                force = depth < self._minimal_depth
                if (len(idx) <= mls and not force) or len(idx) < nb_children:
                    permutation[offset:offset + len(idx)] = idx
                    continue
                parts = self._strategy.split(coords, weights, idx, nb_children)
            if len(parts) <= 1:
                permutation[offset:offset + len(idx)] = idx
                continue
            children_start[node] = len(sizes)
            children_count[node] = len(parts)
            child_offset = offset
            new_items = []
            for part in parts:
                child = add_node(part, depth + 1, node, child_offset)
                if node == root and top_parts is not None:
                    partition_nodes.append(child)
                new_items.append((child, part))
                child_offset += len(part)
            queue.extend(new_items)

        if top_parts is None:
            partition_nodes = [root]

        tree = ClusterTree(
            points=coords,
            offsets=np.asarray(offsets, dtype=np.int64),
            sizes=np.asarray(sizes, dtype=np.int64),
            depths=np.asarray(depths, dtype=np.int64),
            parents=np.asarray(parents, dtype=np.int64),
            children_start=np.asarray(children_start, dtype=np.int64),
            children_count=np.asarray(children_count, dtype=np.int64),
            centers=np.asarray(centers, dtype=np.float64),
            radii=np.asarray(radius_arr, dtype=np.float64),
            partition=np.asarray(partition_nodes, dtype=np.int64),
            permutation=permutation,
            maximal_leaf_size=mls,
        )
        return Cluster(tree, 0)


# (direction_kind, split_kind) of the native builder: PCA / bounding box,
# regular / geometric split
_NATIVE_KINDS = {PCARegular: (0, 0), PCAGeometric: (0, 1),
                 BoundingBoxRegular: (1, 0), BoundingBoxGeometric: (1, 1)}


def _native_strategy_kinds(strategy):
    """The native builder's kinds for the four built-in policies, or None
    for any other VirtualPartitioning (a subclass of a built-in one
    included: its methods may differ)."""
    return _NATIVE_KINDS.get(type(strategy))
