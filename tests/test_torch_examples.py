"""The port's examples (htool_python_torch/examples/) on the CPU.

* Each of the ten runnable examples' `run(device='cpu')` passes its own
  assertions, the reference examples' checks (products within epsilon of
  the dense oracle, the H-LU and DDM solutions within 10 epsilon, user
  operators to 1e-12), and returns finite numbers.
* Host structures equal the reference's on the same inputs: use_cluster's
  permutations (every policy and the partitioned tree) and
  use_cluster_with_given_partition's partition offsets and sizes.
  Operators are held to the epsilon contract, not compared bit for bit.
* Without a card, `run()` raises as every entry point does; `main`
  draws the reference example's picture.
"""

import importlib
import numbers

import numpy as np
import pytest
import torch

import htool_python_tpu as H
from htool_python_torch.examples import EXAMPLES, _common
from htool_python_torch.examples import use_cluster
from htool_python_torch.examples.advanced import \
    use_cluster_with_given_partition
from htool_python_tpu.models.geometry import (create_partitioned_geometries,
                                              create_random_points_in_sphere)
from test_torch_complex import one_thread  # noqa: F401


def _finite(value):
    if isinstance(value, dict):
        return all(_finite(v) for v in value.values())
    if isinstance(value, (list, tuple, np.ndarray)):
        return all(_finite(v) for v in value)
    return isinstance(value, numbers.Number) and np.isfinite(value)


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_passes_its_checks(name):
    module = importlib.import_module(f"htool_python_torch.examples.{name}")
    result = module.run(device="cpu")
    assert result and _finite(result)
    for key, value in result.items():
        if key.endswith("rel_err"):
            assert value < 1e-2, (key, value)


def test_use_cluster_matches_reference():
    result = use_cluster.run(device="cpu")
    np.random.seed(7)  # the reference example's draw
    points = create_random_points_in_sphere(600)
    for name, perm in result["permutations"].items():
        b = H.ClusterTreeBuilder()
        b.set_maximal_leaf_size(16)
        strategy = "PCARegular" if name == "partitioned" else name
        b.set_partitioning_strategy(getattr(H, strategy)())
        ref = b.create_cluster_tree(points, 2, size_of_partition=(
            2 if name == "partitioned" else 1))
        np.testing.assert_array_equal(perm, ref.get_permutation(),
                                      err_msg=name)
        if name == "partitioned":
            assert result["partitions"] == [
                (c.get_offset(), c.get_size())
                for c in ref.get_clusters_on_partition()]


@pytest.mark.parametrize("partitions", [2, 3])
def test_given_partition_matches_reference(partitions):
    result = use_cluster_with_given_partition.run("cpu", partitions)
    points, _, table = create_partitioned_geometries(3, 600, 600, partitions)
    b = H.ClusterTreeBuilder()
    b.set_maximal_leaf_size(20)
    ref = b.create_cluster_tree_from_local_partition(points, 2, partitions,
                                                     table)
    expected = [(c.get_offset(), c.get_size())
                for c in ref.get_clusters_on_partition()]
    assert result["local_partitions"] == expected
    assert result["global_partitions"] == expected
    assert result["nodes"] == ref.tree.nb_nodes


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs no card")
def test_run_needs_a_card_unless_told():
    with pytest.raises(RuntimeError, match="device='cpu'"):
        use_cluster.run()


@pytest.mark.parametrize("name", ["use_cluster", "use_hmatrix"])
def test_main_draws_the_picture(monkeypatch, name):
    import matplotlib

    matplotlib.use("Agg")
    drawn = []
    monkeypatch.setattr(_common, "finish_plot",
                        lambda fig, script, show: drawn.append(
                            [len(ax.collections) + len(ax.patches)
                             for ax in fig.axes]))
    module = importlib.import_module(f"htool_python_torch.examples.{name}")
    module.main(["--cpu"])
    assert len(drawn) == 1 and all(n > 0 for n in drawn[0])


def test_ddm_solver_with_a_float64_right_hand_side():
    """The reference example's own vectors are numpy float64: on the
    example's float32 operator the dense tier's solves then run in
    float64, as the reference promotes them (they raised before)."""
    from htool_python_torch import DDMSolverBuilder
    from htool_python_torch.examples import use_ddm_solver as ex

    rng = np.random.RandomState(0)
    _, _, approx = ex.build_problem(2, rng, "cpu")
    op = approx.distributed_operator
    solver = DDMSolverBuilder(op, approx.block_diagonal_hmatrix).solver
    solver.set_hpddm_args("-hpddm_schwarz_method asm -hpddm_tol 1e-6 "
                          "-hpddm_max_it 200 -hpddm_gmres_restart 40")
    solver.facto_one_level()
    x_exact = rng.rand(op.shape[0])
    b = op * x_exact
    assert b.dtype == np.float64
    x = np.zeros_like(b)
    solver.solve(x, b)
    assert np.linalg.norm(x - x_exact) / np.linalg.norm(x_exact) < \
        10 * ex.EPSILON
