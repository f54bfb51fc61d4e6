"""Plug a custom low-rank compressor into H-matrix assembly.

The port of the reference's
example/advanced/use_custom_low_rank_approximation.py.  Two equivalent
spellings wire the hook in: `set_low_rank_generator(hook)` after
construction, or the `low_rank_strategy` constructor argument.  Assembly
then calls the hook per admissible block instead of the device ACA.  700
points, epsilon 1e-3, eta 100, leaf 20, float32; the compression ratio is
compared with the default ACA's.

    python -m htool_python_torch.examples.advanced.use_custom_low_rank_approximation [--cpu]
"""

import numpy as np
import torch

from ... import ClusterTreeBuilder, HMatrixTreeBuilder
from ...config import resolve_device
from .._common import rel_err
from ..create_geometry import create_random_points_in_sphere
from ..define_generators import CustomGenerator
from .define_custom_low_rank_generator import CustomSVD

EPSILON = 1e-3


def run(device=None, partitions=2) -> dict:
    """The example's computation and checks; returns its numbers."""
    device = resolve_device(device)
    rng = np.random.RandomState(4)
    n = 700
    points = create_random_points_in_sphere(n, rng)
    cb = ClusterTreeBuilder()
    cb.set_maximal_leaf_size(20)
    cluster = cb.create_cluster_tree(points, 2)

    oracle = CustomGenerator(points, points)
    svd_hook = CustomSVD(oracle)

    # spelling 1: setter
    hb = HMatrixTreeBuilder(EPSILON, 100.0, "N", "N", device=device)
    hb.set_dtype(torch.float32)
    hb.set_low_rank_generator(svd_hook)
    hm = hb.build(oracle, cluster, cluster)

    # spelling 2: constructor argument (reference `low_rank_strategy`)
    hb2 = HMatrixTreeBuilder(EPSILON, 100.0, "N", "N", -1, CustomSVD(oracle),
                             device=device)
    hb2.set_dtype(torch.float32)
    hm2 = hb2.build(oracle, cluster, cluster)

    x = rng.rand(n).astype(np.float32)
    y_exact = oracle.mat_vec(x)
    numbers = {}
    for name, h in [("setter", hm), ("ctor", hm2)]:
        rel = rel_err(h * x, y_exact)
        print(f"{name}: matvec rel err {rel:.2e}")
        assert rel < EPSILON
        numbers[f"{name}_matvec_rel_err"] = rel

    # SVD is rank-optimal: compare against the built-in ACA compression
    hb_aca = HMatrixTreeBuilder(EPSILON, 100.0, "N", "N", device=device)
    hb_aca.set_dtype(torch.float32)
    hm_aca = hb_aca.build(oracle, cluster, cluster)
    numbers["svd_compression_ratio"] = float(
        hm.get_local_information()["Compression_ratio"])
    numbers["aca_compression_ratio"] = float(
        hm_aca.get_local_information()["Compression_ratio"])
    print("SVD-hook compression:", numbers["svd_compression_ratio"])
    print("default-ACA compression:", numbers["aca_compression_ratio"])
    return numbers


def main(argv=None):
    from .._common import cli

    args = cli(__doc__, argv)
    run(args.device, args.partitions)


if __name__ == "__main__":
    main()
