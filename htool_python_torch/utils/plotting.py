"""Matplotlib pictures of clusters and of an H-matrix's block structure.

Copy of htool_python_tpu/utils/plotting.py: `plot(ax, cluster, points,
depth)` scatters the points coloured by their cluster at a tree depth;
`plot(ax, hmatrix)` draws the leaf rectangles annotated with their ranks,
dense leaves in red; a `PerPartition` draws its first element.  Everything
is read on the host (the plan's buckets and `_lr_ranks`); matplotlib is
imported inside the functions, so the package imports without it.
"""

from __future__ import annotations

import numpy as np


def plot(ax, obj, points=None, depth=None):
    from ..clustering.cluster import Cluster
    from ..hmatrix.hmatrix import HMatrix
    from ..parallel.builders import PerPartition

    if isinstance(obj, PerPartition):
        obj = obj[0]
    if isinstance(obj, Cluster):
        return _plot_cluster(ax, obj, points, depth if depth is not None else 1)
    if isinstance(obj, HMatrix):
        return _plot_hmatrix(ax, obj)
    raise TypeError(f"cannot plot {type(obj)}")


def _nodes_at_depth(cluster, depth):
    """Nodes at `depth` below this node (leaves above that depth included)."""
    tree = cluster.tree
    out = []
    stack = [(cluster.node, 0)]
    while stack:
        n, d = stack.pop()
        if d == depth or tree.is_leaf(n):
            out.append(n)
            continue
        stack.extend((c, d + 1) for c in tree.children_of(n))
    return out


def _plot_cluster(ax, cluster, points, depth):
    import matplotlib.pyplot as plt

    tree = cluster.tree
    perm = tree.permutation
    nodes = _nodes_at_depth(cluster, depth)
    cmap = plt.get_cmap("tab20")
    pts = np.asarray(points)
    is3d = pts.shape[0] >= 3 and getattr(ax, "name", "") == "3d"
    for k, n in enumerate(nodes):
        off, sz = int(tree.offsets[n]), int(tree.sizes[n])
        idx = perm[off:off + sz]
        color = cmap(k % 20)
        if is3d:
            ax.scatter(pts[0, idx], pts[1, idx], pts[2, idx], color=color, s=4)
        else:
            ax.scatter(pts[0, idx], pts[1, idx], color=color, s=4)
    return ax


def _plot_hmatrix(ax, hmatrix):
    import matplotlib.patches as mpatches

    nt, ns = hmatrix.shape

    def draw(t_off, t_sz, s_off, s_sz, rank):
        # matrix convention: x = columns, y = rows (inverted)
        if rank < 0:
            face = (0.85, 0.15, 0.15, 0.8)  # dense leaves in red
        else:
            face = (0.2, 0.4, 0.8, 0.35)
        rect = mpatches.Rectangle((s_off, t_off), s_sz, t_sz,
                                  facecolor=face, edgecolor="black",
                                  linewidth=0.3)
        ax.add_patch(rect)
        if t_sz * s_sz > nt * ns / 4000.0:
            ax.text(s_off + s_sz / 2, t_off + t_sz / 2, str(rank),
                    ha="center", va="center", fontsize=6)

    for b in hmatrix.plan.dense_buckets:
        for i in range(b.nb):
            draw(b.t_off[i], b.t_sz[i], b.s_off[i], b.s_sz[i], -1)
            if b.mirror[i]:
                draw(b.s_off[i], b.s_sz[i], b.t_off[i], b.t_sz[i], -1)
    for b, ranks in zip(hmatrix.plan.lowrank_buckets, hmatrix._lr_ranks):
        for i in range(b.nb):
            draw(b.t_off[i], b.t_sz[i], b.s_off[i], b.s_sz[i], int(ranks[i]))
            if b.mirror[i]:
                draw(b.s_off[i], b.s_sz[i], b.t_off[i], b.t_sz[i],
                     int(ranks[i]))
    ax.set_xlim(0, ns)
    ax.set_ylim(nt, 0)
    ax.set_aspect("equal")
    return ax
