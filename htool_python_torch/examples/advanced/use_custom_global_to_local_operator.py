"""A distributed operator made entirely of user-provided operators.

The port of the reference's
example/advanced/use_custom_global_to_local_operator.py:
`CustomApproximationBuilder` skips H-matrix assembly, and each
partition's block row is a user `RestrictedGlobalToLocalOperator` (here a
dense one over the oracle generator, in float64 numpy on the host).
Products are then exact, and the example checks them to 1e-12.  600
points, leaf 20.

    python -m htool_python_torch.examples.advanced.use_custom_global_to_local_operator [--cpu] [--partitions P]
"""

import numpy as np

from ... import ClusterTreeBuilder, CustomApproximationBuilder, \
    LocalRenumbering
from ...config import resolve_device
from .._common import rel_err
from ..create_geometry import create_random_points_in_sphere
from ..define_generators import CustomGenerator
from .define_custom_local_operator import \
    CustomRestrictedGlobalToLocalOperator


def run(device=None, partitions=2) -> dict:
    """The example's computation and checks; returns its numbers."""
    device = resolve_device(device)
    P = partitions
    rng = np.random.RandomState(13)
    n = 600
    points = create_random_points_in_sphere(n, rng)
    cb = ClusterTreeBuilder()
    cb.set_maximal_leaf_size(20)
    target = cb.create_cluster_tree(points, 2, size_of_partition=P)
    source = cb.create_cluster_tree(points, 2, size_of_partition=P)
    oracle = CustomGenerator(points, points)

    # one user operator per partition: that partition's target rows
    # against the full source width
    ops = [CustomRestrictedGlobalToLocalOperator(
        oracle, LocalRenumbering(target.get_cluster_on_partition(p)),
        LocalRenumbering(source))
        for p in range(P)]

    approx = CustomApproximationBuilder(target, source, None, ops,
                                        device=device)
    A = approx.distributed_operator

    x = rng.rand(n)
    rel = rel_err(A * x, oracle.mat_vec(x))
    assert rel < 1e-12
    X = np.asfortranarray(rng.rand(n, 2))
    rel_m = rel_err(A @ X, oracle.mat_mat(X))
    assert rel_m < 1e-12
    print("custom-operator products match the oracle to machine precision")
    return dict(matvec_rel_err=rel, matmat_rel_err=rel_m)


def main(argv=None):
    from .._common import cli

    args = cli(__doc__, argv)
    run(args.device, args.partitions)


if __name__ == "__main__":
    main()
