"""Domain-decomposition-preconditioned GMRES on the device.

The port of the reference's example/use_ddm_solver.py: 1200 points in
the unit ball on P subdomains, 1/(0.1 + r) in symmetric storage ('S',
'L'), epsilon 1e-3, leaf 32, float32, `recompression`; one-level
additive Schwarz from the partition-diagonal blocks (`DDMSolverBuilder`),
HPDDM's option strings, a manufactured solution, and two right-hand
sides in one solve.

    python -m htool_python_torch.examples.use_ddm_solver [--cpu] [--partitions P]
"""

import numpy as np
import torch

from .. import (ClusterTreeBuilder, DDMSolverBuilder,
                DefaultApproximationBuilder, HMatrixTreeBuilder,
                recompression)
from ..config import resolve_device
from ._common import rel_err
from .create_geometry import create_random_points_in_sphere
from .define_generators import make_device_generator

EPSILON = 1e-3
TOL = 1e-6


def build_problem(P, rng, device, n=1200):
    points = create_random_points_in_sphere(n, rng)
    cb = ClusterTreeBuilder()
    cb.set_maximal_leaf_size(32)
    cluster = cb.create_cluster_tree(points, 2, size_of_partition=P)
    gen = make_device_generator(points, points, device)
    hb = HMatrixTreeBuilder(EPSILON, 10.0, "S", "L", device=device)
    hb.set_dtype(torch.float32)
    approx = DefaultApproximationBuilder(gen, cluster, cluster, hb, None)
    return points, cluster, approx


def _run(device=None, partitions=2):
    device = resolve_device(device)
    P = partitions
    rng = np.random.RandomState(0)
    points, cluster, approx = build_problem(P, rng, device)
    op = approx.distributed_operator
    n = op.shape[0]

    recompression(approx.hmatrix)

    # one-level additive Schwarz from the partition-diagonal blocks
    builder = DDMSolverBuilder(op, approx.block_diagonal_hmatrix)
    solver = builder.solver
    solver.set_hpddm_args(
        f"-hpddm_krylov_method gmres -hpddm_schwarz_method asm "
        f"-hpddm_tol {TOL} -hpddm_max_it 200 -hpddm_gmres_restart 40 "
        f"-hpddm_compute_residual l2")
    solver.facto_one_level()

    # manufactured solution; solve writes into x in place
    x_exact = rng.rand(n).astype(np.float32)
    b = op * x_exact
    x = np.zeros(n, dtype=np.float32)
    solver.solve(x, b)

    rel = rel_err(x, x_exact)
    info = solver.get_information()
    print(f"converged in {info['Nb_it']} iterations, "
          f"residual {info['Relative_residual']}, solution err {rel:.2e}")
    assert rel < 10 * EPSILON

    # several right-hand sides march in lockstep in the same cycle
    B = np.stack([b, 2 * b], axis=1)
    X = np.zeros_like(B)
    solver.solve(X, B)
    rel_rhs = float(np.linalg.norm(X[:, 1] - 2 * X[:, 0]) / np.linalg.norm(X))
    assert rel_rhs < 1e-4

    print(op.get_distributed_information())
    numbers = dict(iterations=int(info["Nb_it"]),
                   relative_residual=float(info["Relative_residual"]),
                   solution_rel_err=rel, two_rhs_rel_diff=rel_rhs)
    return numbers, (points, cluster, approx, P)


def run(device=None, partitions=2) -> dict:
    """The example's computation and checks; returns its numbers."""
    return _run(device, partitions)[0]


def main(argv=None):
    from .. import plot
    from ._common import cli, figure, finish_plot

    args = cli(__doc__, argv)
    _, (points, cluster, approx, P) = _run(args.device, args.partitions)
    fig = figure(args.show)
    ax1 = fig.add_subplot(1, 2, 1, projection="3d")
    ax2 = fig.add_subplot(1, 2, 2)
    ax1.set_title(f"subdomains (P={P})")
    ax2.set_title("block-diagonal H-matrix, partition 0")
    plot(ax1, cluster, points, 1)
    plot(ax2, approx.block_diagonal_hmatrix[0])
    finish_plot(fig, __file__, args.show)


if __name__ == "__main__":
    main()
