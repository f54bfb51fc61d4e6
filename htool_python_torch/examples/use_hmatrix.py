"""Compress a kernel operator into an H-matrix and use it on the device.

The port of the reference's example/use_hmatrix.py: 1200 points in the
unit ball, the kernel 1/(0.1 + r) as a `KernelGenerator` (entries
computed on the device in batched tiles), symmetric one-triangle storage
('S', 'L'), epsilon 1e-3, eta 10, leaf 64, in float32.  Products (`hm *
x`, `hm @ X`) run kernel K1 on the card; the direct solve factorizes a
copy (`lu_factorization`, `lu_solve`).  A dense oracle, built once in
numpy, checks the accuracy.

    python -m htool_python_torch.examples.use_hmatrix [--cpu]
"""

import copy

import numpy as np
import torch

from .. import ClusterTreeBuilder, HMatrixTreeBuilder
from ..config import resolve_device
from ._common import rel_err
from .create_geometry import create_random_points_in_sphere
from .define_generators import make_device_generator

EPSILON = 1e-3
ETA = 10.0


def assemble(points, device):
    builder = ClusterTreeBuilder()
    builder.set_maximal_leaf_size(64)
    cluster = builder.create_cluster_tree(points, 2)
    generator = make_device_generator(points, points, device)
    # symmetric one-triangle storage: mirror blocks contribute transposed
    hmatrix_builder = HMatrixTreeBuilder(EPSILON, ETA, "S", "L",
                                         device=device)
    hmatrix_builder.set_dtype(torch.float32)
    return cluster, hmatrix_builder.build(generator, cluster, cluster)


def dense_oracle(points):
    d = np.linalg.norm(points[:, :, None] - points[:, None, :], axis=0)
    return 1.0 / (0.1 + d)


def _run(device=None, partitions=2):
    device = resolve_device(device)
    rng = np.random.RandomState(1)
    n = 1200
    points = create_random_points_in_sphere(n, rng)
    cluster, hm = assemble(points, device)
    A = dense_oracle(points)

    # --- products (numpy in -> numpy out, tensor in -> tensor out) ---
    x = rng.rand(n).astype(np.float32)
    rel = rel_err(hm * x, A @ x)
    print(f"matvec rel err {rel:.2e} (epsilon {EPSILON:g})")
    assert rel < EPSILON

    X = rng.rand(n, 4).astype(np.float32)
    rel_m = rel_err(hm @ X, A @ X)
    print(f"matmat rel err {rel_m:.2e}")
    assert rel_m < EPSILON

    # --- direct solve ---
    # factorization is in place: factor a copy, keep hm for products
    factor = copy.deepcopy(hm)
    factor.lu_factorization()
    b = hm * x
    x_sol = factor.lu_solve("N", b)
    rel_lu = rel_err(x_sol, x)
    print(f"H-LU solve rel err {rel_lu:.2e}")
    assert rel_lu < 10 * EPSILON

    # --- observability ---
    info = hm.get_local_information()
    print("compression ratio:", info["Compression_ratio"])
    print("rank range:", info["Min_rank"], "-", info["Max_rank"])
    print(hm.get_tree_parameters())
    numbers = dict(matvec_rel_err=rel, matmat_rel_err=rel_m,
                   lu_solve_rel_err=rel_lu,
                   compression_ratio=float(info["Compression_ratio"]),
                   min_rank=int(info["Min_rank"]),
                   max_rank=int(info["Max_rank"]))
    return numbers, (points, cluster, hm)


def run(device=None, partitions=2) -> dict:
    """The example's computation and checks; returns its numbers."""
    return _run(device, partitions)[0]


def main(argv=None):
    from .. import plot
    from ._common import cli, figure, finish_plot

    args = cli(__doc__, argv)
    _, (points, cluster, hm) = _run(args.device, args.partitions)
    fig = figure(args.show)
    ax1 = fig.add_subplot(1, 2, 1, projection="3d")
    ax2 = fig.add_subplot(1, 2, 2)
    ax1.set_title("cluster, depth 2")
    ax2.set_title("block structure (ranks)")
    plot(ax1, cluster, points, 2)
    plot(ax2, hm)
    finish_plot(fig, __file__, args.show)


if __name__ == "__main__":
    main()
