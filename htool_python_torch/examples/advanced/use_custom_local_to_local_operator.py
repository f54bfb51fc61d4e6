"""Default diagonal H-matrices plus user off-diagonal operators.

The port of the reference's
example/advanced/use_custom_local_to_local_operator.py (a module-level
script there): `DefaultLocalApproximationBuilder` compresses each
partition's diagonal block (float32, on the device), and the blocks left
and right of it are dense user `RestrictedGlobalToLocalOperator`s.  500 +
500 points by `create_partitionned_geometries`, epsilon 1e-3, eta 10,
leaf 10.

    python -m htool_python_torch.examples.advanced.use_custom_local_to_local_operator [--cpu] [--partitions P]
"""

import numpy as np
import torch

from ... import (ClusterTreeBuilder, DefaultLocalApproximationBuilder,
                 HMatrixTreeBuilder, LocalRenumbering)
from ...config import resolve_device
from .._common import rel_err
from ..create_geometry import create_partitionned_geometries
from ..define_generators import CustomGenerator
from .define_custom_local_operator import \
    CustomRestrictedGlobalToLocalOperator


def run(device=None, partitions=2) -> dict:
    """The example's computation and checks; returns its numbers."""
    device = resolve_device(device)
    P = partitions

    # Random geometry
    nb_rows = 500
    nb_cols = 500
    dimension = 3
    [target_points, source_points, target_partition] = (
        create_partitionned_geometries(dimension, nb_rows, nb_cols, P))

    # Htool parameters
    eta = 10
    epsilon = 1e-3
    maximal_leaf_size = 10
    number_of_children = 2

    # Build clusters
    cluster_builder = ClusterTreeBuilder()
    cluster_builder.set_maximal_leaf_size(maximal_leaf_size)
    target_cluster = cluster_builder.create_cluster_tree_from_local_partition(
        target_points, number_of_children, P, target_partition)
    source_cluster = cluster_builder.create_cluster_tree(
        source_points, number_of_children, size_of_partition=P)

    # Build generator
    generator = CustomGenerator(target_points, source_points)

    # Default diagonal blocks as H-matrices, user extra-diagonal operators
    hb = HMatrixTreeBuilder(epsilon, eta, "N", "N", device=device)
    hb.set_dtype(torch.float32)
    custom_local_approximation = DefaultLocalApproximationBuilder(
        generator, target_cluster, source_cluster, hb, None)
    distributed_operator = custom_local_approximation.distributed_operator

    for p in range(P):
        target_local_cluster = target_cluster.get_cluster_on_partition(p)
        source_local_cluster = source_cluster.get_cluster_on_partition(p)
        off = source_local_cluster.get_offset()
        sz = source_local_cluster.get_size()
        total = source_cluster.get_size()
        if off > 0:  # left of the diagonal block
            distributed_operator.add_global_to_local_operator(
                CustomRestrictedGlobalToLocalOperator(
                    generator, LocalRenumbering(target_local_cluster),
                    LocalRenumbering(0, off,
                                     source_cluster.get_permutation()),
                    False, False), p)
        if total - sz - off > 0:  # right of the diagonal block
            distributed_operator.add_global_to_local_operator(
                CustomRestrictedGlobalToLocalOperator(
                    generator, LocalRenumbering(target_local_cluster),
                    LocalRenumbering(off + sz, total - sz - off,
                                     source_cluster.get_permutation()),
                    False, False), p)

    # Test matrix vector product
    rng = np.random.RandomState(0)
    x = rng.rand(nb_cols).astype(np.float32)
    err = rel_err(distributed_operator * x, generator.mat_vec(x))
    print("matvec rel err:", err)
    assert err < epsilon

    # Test matrix matrix product
    X = np.asfortranarray(rng.rand(nb_cols, 2).astype(np.float32))
    err_m = rel_err(distributed_operator @ X, generator.mat_mat(X))
    print("matmat rel err:", err_m)
    assert err_m < epsilon
    return dict(matvec_rel_err=err, matmat_rel_err=err_m)


def main(argv=None):
    from .._common import cli

    args = cli(__doc__, argv)
    run(args.device, args.partitions)


if __name__ == "__main__":
    main()
