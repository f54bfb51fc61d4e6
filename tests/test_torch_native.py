"""The port's native cluster-tree builder (csrc/cluster_builder.cpp, built
by g++ at first use) against its numpy path and the reference's tree.

Over the cases of tests/test_native.py (the four policies, 2 and 3
children, 3 partitions, point radii and weights; a user-given local
partition) and a few more (no partition, a global partition, a minimal
depth, 2-D points): the node arrays are equal (the centers and radii,
summed in another order, to 1e-12), and the permutations leaf by leaf as
sets, as tests/test_native.py compares them (projection ties may order a
leaf's points differently).  The reference builds its tree with its own
native path here.  A user policy, a subclass of a built-in one included,
takes the numpy path; a compiler that fails raises with its output
instead of giving a tree, and no environment variable turns the native
path off.
"""

import numpy as np
import pytest

import htool_python_torch as T
import htool_python_tpu as H
from htool_python_torch import native
from htool_python_torch.clustering import cluster as cluster_mod
from htool_python_torch.ops import cuda_build
from test_torch_complex import one_thread  # noqa: F401

_STRATEGIES = ["PCARegular", "PCAGeometric", "BoundingBoxRegular",
               "BoundingBoxGeometric"]
_INT_FIELDS = ("offsets", "sizes", "depths", "parents", "children_start",
               "children_count", "partition")


def _numpy_path(monkeypatch):
    monkeypatch.setattr(cluster_mod, "_native_strategy_kinds", lambda s: None)


def _build(pkg, points, method="create_cluster_tree", strategy="PCARegular",
           leaf=17, minimal_depth=0, args=(), **kw):
    b = pkg.ClusterTreeBuilder()
    b.set_maximal_leaf_size(leaf)
    b.set_minimal_depth(minimal_depth)
    b.set_partitioning_strategy(getattr(pkg, strategy)())
    return getattr(b, method)(points, *args, **kw)


def assert_same_tree(a, b):
    ta, tb = a.tree, b.tree
    assert ta.nb_nodes == tb.nb_nodes
    for name in _INT_FIELDS:
        np.testing.assert_array_equal(getattr(ta, name), getattr(tb, name),
                                      err_msg=name)
    np.testing.assert_allclose(ta.centers, tb.centers, rtol=1e-12,
                               atol=1e-14)
    np.testing.assert_allclose(ta.radii, tb.radii, rtol=1e-12, atol=1e-14)
    n = len(ta.permutation)
    assert sorted(ta.permutation) == list(range(n))
    for node in range(ta.nb_nodes):
        if ta.children_count[node]:
            continue
        o, s = int(ta.offsets[node]), int(ta.sizes[node])
        assert set(ta.permutation[o:o + s]) == set(tb.permutation[o:o + s])


def _three_trees(monkeypatch, build):
    """(port native, port numpy, reference) trees of `build(pkg)`."""
    calls = []
    real = native.build_cluster_tree_native

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(native, "build_cluster_tree_native", counted)
    port_native = build(T)
    assert calls, "the built-in policy did not take the native builder"
    with monkeypatch.context() as m:
        _numpy_path(m)
        port_numpy = build(T)
    assert len(calls) == 1
    return port_native, port_numpy, build(H)


@pytest.mark.parametrize("children", [2, 3])
@pytest.mark.parametrize("strategy", _STRATEGIES)
def test_native_matches_numpy_and_reference(monkeypatch, strategy, children):
    """tests/test_native.py::test_native_matches_python's case."""
    rng = np.random.RandomState(5)
    n = 700
    pts = rng.random_sample((3, n))
    radii = rng.rand(n) * 0.01
    weights = 0.5 + rng.rand(n)
    trees = _three_trees(monkeypatch, lambda pkg: _build(
        pkg, pts, strategy=strategy, args=(children,), size_of_partition=3,
        radii=radii, weights=weights))
    assert_same_tree(trees[0], trees[1])
    assert_same_tree(trees[0], trees[2])
    assert len(trees[0].tree.partition) == 3


def test_native_local_partition(monkeypatch):
    """tests/test_native.py::test_native_local_partition_and_products's
    partition: the given segments hold exactly their points."""
    pts = np.random.RandomState(6).random_sample((3, 500))
    part = np.array([[0, 200, 350], [200, 150, 150]])
    trees = _three_trees(monkeypatch, lambda pkg: _build(
        pkg, pts, "create_cluster_tree_from_local_partition", leaf=10,
        args=(2, 3, part)))
    assert_same_tree(trees[0], trees[1])
    assert_same_tree(trees[0], trees[2])
    t = trees[0].tree
    np.testing.assert_array_equal(t.sizes[t.partition], part[1])
    for p, node in enumerate(t.partition):
        o, s = int(t.offsets[node]), int(t.sizes[node])
        assert set(t.permutation[o:o + s]) == set(
            range(part[0, p], part[0, p] + part[1, p]))


@pytest.mark.parametrize("case", ["plain", "global_partition",
                                  "minimal_depth", "disk"])
def test_native_other_builds(monkeypatch, case):
    rng = np.random.RandomState(7)
    n = 900
    pts = rng.random_sample((2 if case == "disk" else 3, n))
    labels = rng.randint(0, 4, n)
    if case == "global_partition":
        def build(pkg):
            return _build(pkg, pts, "create_cluster_tree_from_global_partition",
                          strategy="PCAGeometric", args=(2, 4, labels))
    else:
        def build(pkg):
            return _build(pkg, pts, leaf=40 if case == "minimal_depth" else 24,
                          minimal_depth=6 if case == "minimal_depth" else 0,
                          args=(2,))
    trees = _three_trees(monkeypatch, build)
    assert_same_tree(trees[0], trees[1])
    assert_same_tree(trees[0], trees[2])


def test_user_policy_takes_the_numpy_path(monkeypatch):
    """A user VirtualPartitioning (here a subclass of a built-in policy,
    whose methods may differ) is split by its Python callbacks."""
    def refuse(*a, **k):
        raise AssertionError("a user policy reached the native builder")

    class MyPCA(T.PCARegular):
        pass

    pts = np.random.RandomState(8).random_sample((3, 400))
    monkeypatch.setattr(native, "build_cluster_tree_native", refuse)
    b = T.ClusterTreeBuilder()
    b.set_maximal_leaf_size(20)
    b.set_partitioning_strategy(MyPCA())
    ours = b.create_cluster_tree(pts, 2)
    monkeypatch.undo()
    assert_same_tree(ours, _build(T, pts, leaf=20, args=(2,)))


def test_failed_build_raises_with_compiler_output(monkeypatch):
    """No fallback: a g++ that fails makes the build raise, with g++'s own
    message, and no tree is returned."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(cuda_build, "_LOADED", {})
    monkeypatch.setattr(cuda_build, "GXX_FLAGS",
                        cuda_build.GXX_FLAGS + ["-fno-such-option-anywhere"])
    pts = np.random.RandomState(9).random_sample((3, 200))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as err:
        T.ClusterTreeBuilder().create_cluster_tree(pts, 2)
    assert "-fno-such-option-anywhere" in str(err.value)
    assert not cuda_build.library_path("cluster_builder").exists()


def test_no_switch_turns_the_native_path_off(monkeypatch):
    """The reference's environment switches do nothing here."""
    calls = []
    real = native.build_cluster_tree_native
    monkeypatch.setattr(native, "build_cluster_tree_native",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    monkeypatch.setenv("HTOOL_TPU_NO_NATIVE", "1")
    monkeypatch.setenv("HTOOL_TPU_NATIVE_DIR", "/nonexistent")
    pts = np.random.RandomState(10).random_sample((3, 300))
    T.ClusterTreeBuilder().create_cluster_tree(pts, 2)
    assert calls == [1]


def test_native_builder_checks_its_inputs():
    """What the C++ builder cannot take is refused before a pointer is
    passed: more coordinates than its buffers hold, radii or weights of
    another length, a partition that misses or repeats points."""
    pts = np.random.RandomState(11).random_sample((3, 50))
    with pytest.raises(ValueError, match="coordinates"):
        T.ClusterTreeBuilder().create_cluster_tree(
            np.zeros((native.MAX_DIM + 1, 50)), 2)
    with pytest.raises(ValueError, match="one entry a point"):
        T.ClusterTreeBuilder().create_cluster_tree(pts, 2,
                                                   radii=np.zeros(49))
    with pytest.raises(ValueError, match="every point once"):
        T.ClusterTreeBuilder().create_cluster_tree_from_global_partition(
            pts, 2, 2, np.where(np.arange(50) < 25, 0, 5))
