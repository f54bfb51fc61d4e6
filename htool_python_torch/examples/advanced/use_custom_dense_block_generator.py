"""Assemble the dense leaves through the batched user callback.

The port of the reference's
example/advanced/use_custom_dense_block_generator.py:
`set_dense_blocks_generator(hook)` routes every non-admissible leaf to one
`build_dense_blocks` call (define_custom_dense_blocks_generator.py);
admissible blocks still go through the usual low-rank compression.  700
points, epsilon 1e-3, eta 10, leaf 20, float32.

    python -m htool_python_torch.examples.advanced.use_custom_dense_block_generator [--cpu]
"""

import numpy as np
import torch

from ... import ClusterTreeBuilder, HMatrixTreeBuilder
from ...config import resolve_device
from .._common import rel_err
from ..create_geometry import create_random_points_in_sphere
from ..define_generators import CustomGenerator
from .define_custom_dense_blocks_generator import CustomDenseBlocksGenerator

EPSILON = 1e-3


def run(device=None, partitions=2) -> dict:
    """The example's computation and checks; returns its numbers."""
    device = resolve_device(device)
    rng = np.random.RandomState(11)
    n = 700
    points = create_random_points_in_sphere(n, rng)
    cb = ClusterTreeBuilder()
    cb.set_maximal_leaf_size(20)
    cluster = cb.create_cluster_tree(points, 2)

    oracle = CustomGenerator(points, points)
    hook = CustomDenseBlocksGenerator(oracle, cluster, cluster)

    hb = HMatrixTreeBuilder(EPSILON, 10.0, "N", "N", device=device)
    hb.set_dtype(torch.float32)
    hb.set_dense_blocks_generator(hook)
    hm = hb.build(oracle, cluster, cluster)

    x = rng.rand(n).astype(np.float32)
    y_exact = oracle.mat_vec(x)
    rel = rel_err(hm * x, y_exact)
    print(f"matvec rel err {rel:.2e}")
    assert rel < EPSILON

    X = rng.rand(n, 2).astype(np.float32)
    rel_m = rel_err(hm @ X, oracle.mat_mat(X))
    print(f"matmat rel err {rel_m:.2e}")
    assert rel_m < EPSILON
    info = hm.get_local_information()
    print(info)
    return dict(matvec_rel_err=rel, matmat_rel_err=rel_m,
                compression_ratio=float(info["Compression_ratio"]))


def main(argv=None):
    from .._common import cli

    args = cli(__doc__, argv)
    run(args.device, args.partitions)


if __name__ == "__main__":
    main()
