"""The port's H-LU / H-Cholesky (hmatrix/factorization.py) against the
reference's, on the CPU.

Both packages factorize the same operator: the reference assembles a
second-kind matrix 10 I + 1 / (0.5 + r) on 320 points of the unit sphere
(its host-generator path, leaf 32, eps 1e-6), and the port holds the
reference's own bucket arrays (`interop.plan_from_reference`,
`HMatrix.from_arrays`).  `hodlr_threshold` (256) and `hodlr_leaf_size` (64)
are lowered in both configurations by a fixture that restores them, so
both take the HODLR path (320 = 8 * 40: no padding rows).

* f64: `lu_solve` 'N' / 'T' and `cholesky_solve` ('S' storage) agree with
  the reference's solutions to 1e-9 (the HODLR solve plus two sweeps of
  iterative refinement through the operator's product converge to the
  operator's own solution); so does the dense path (n <= threshold).
* f32: the port's solutions meet the reference contract, error < 10 eps.
* The port's own rules: `cholesky_solve` with another UPLO than the
  factorization's raises (the reference ignores it: ROADMAP section 3,
  fault 4), numpy in -> numpy out and tensor in -> tensor out, argument
  checks, solving before factorizing, and the dense fallback when the
  operator is not HODLR-compressible (the reference's case,
  tests/test_hodlr.py:196-222).
"""

import copy

import numpy as np
import pytest
import torch

import htool_python_torch as T
import htool_python_tpu as H
from htool_python_torch.config import get_config as port_config
from htool_python_tpu.config import get_config as ref_config
from test_torch_complex import (ReferenceHostGenerator, clusters, one_thread,  # noqa: F401
                                port_operator, sphere)

_N, _EPS = 320, 1e-6
_KNOBS = {"hodlr_threshold": 256, "hodlr_leaf_size": 64}


@pytest.fixture(scope="module", autouse=True)
def lowered_thresholds():
    saved = [(cfg, {k: getattr(cfg, k) for k in _KNOBS})
             for cfg in (port_config(), ref_config())]
    for cfg, _ in saved:
        for k, v in _KNOBS.items():
            setattr(cfg, k, v)
    yield
    for cfg, old in saved:
        for k, v in old.items():
            setattr(cfg, k, v)


def second_kind(points):
    d = np.linalg.norm(points[:, :, None] - points[:, None, :], axis=0)
    return 1.0 / (0.5 + d) + 10.0 * np.eye(points.shape[1])


def operators(symmetry, UPLO, dtype, eps=_EPS):
    """(reference H-matrix, the port's H-matrix on its arrays)."""
    points = sphere(_N)
    ref_cluster, port_cluster = clusters(points)
    hb = H.HMatrixTreeBuilder(eps, 10.0, symmetry, UPLO)
    hb.set_dtype(dtype)
    hm = hb.build(ReferenceHostGenerator(second_kind(points)), ref_cluster,
                  ref_cluster)
    return hm, port_operator(hm, port_cluster)


@pytest.fixture(scope="module")
def f64_pair():
    return operators("N", "N", np.float64)


@pytest.fixture(scope="module")
def f64_sym_pair():
    return operators("S", "L", np.float64)


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def test_lu_solve_matches_reference(f64_pair):
    ref, port = (copy.deepcopy(h) for h in f64_pair)
    ref.lu_factorization()
    port.lu_factorization()
    assert ref._factorization[0] == port._factorization[0] == "hodlr"
    rng = np.random.RandomState(3)
    x_true = rng.rand(_N, 3)
    B = f64_pair[1] @ x_true
    for trans in ("N", "T"):
        x_ref = ref.lu_solve(trans, B)
        x = port.lu_solve(trans, B)
        assert _rel(x, x_ref) < 1e-9
        assert _rel(port.lu_solve(trans, B[:, 0]), x_ref[:, 0]) < 1e-9
    assert _rel(port.lu_solve("N", B), x_true) < _EPS


def test_cholesky_solve_matches_reference(f64_sym_pair):
    ref, port = (copy.deepcopy(h) for h in f64_sym_pair)
    ref.cholesky_factorization("L")
    port.cholesky_factorization("L")
    assert ref._factorization[0] == port._factorization[0] == "hodlr"
    b = f64_sym_pair[1] * np.ones(_N)
    x_ref = ref.cholesky_solve("L", b)
    x = port.cholesky_solve("L", b)
    assert _rel(x, x_ref) < 1e-9
    assert _rel(x, np.ones(_N)) < _EPS


@pytest.mark.parametrize("kind", ["lu", "cholesky"])
def test_dense_path_matches_reference(f64_sym_pair, kind):
    cfg = port_config(), ref_config()
    for c in cfg:
        c.hodlr_threshold = 4096
    try:
        ref, port = (copy.deepcopy(h) for h in f64_sym_pair)
        for h in (ref, port):
            if kind == "lu":
                h.lu_factorization()
            else:
                h.cholesky_factorization("L")
    finally:
        for c in cfg:
            c.hodlr_threshold = _KNOBS["hodlr_threshold"]
    assert port._factorization[0] == ref._factorization[0] == kind
    b = np.random.RandomState(4).rand(_N, 2)
    if kind == "lu":
        for trans in ("N", "T"):
            assert _rel(port.lu_solve(trans, b), ref.lu_solve(trans, b)) < 1e-9
    else:
        assert _rel(port.cholesky_solve("L", b),
                    ref.cholesky_solve("L", b)) < 1e-9


@pytest.mark.parametrize("symmetry,UPLO", [("N", "N"), ("S", "U")])
def test_f32_solves_meet_epsilon(symmetry, UPLO):
    eps = 1e-4
    _, port = operators(symmetry, UPLO, np.float32, eps)
    fac = copy.deepcopy(port)
    if symmetry == "N":
        fac.lu_factorization()
    else:
        fac.cholesky_factorization(UPLO)
    assert fac._factorization[0] == "hodlr"
    x_true = np.random.RandomState(5).rand(_N).astype(np.float32)
    b = port * x_true
    x = (fac.lu_solve("N", b) if symmetry == "N"
         else fac.cholesky_solve(UPLO, b))
    assert x.dtype == np.float32
    assert _rel(port * x, b) < eps
    assert _rel(x, x_true) < 10 * eps


def test_port_rules(f64_sym_pair):
    port = copy.deepcopy(f64_sym_pair[1])
    b = np.ones(_N)
    with pytest.raises(RuntimeError, match="factorization first"):
        port.lu_solve("N", b)
    port.cholesky_factorization("L")
    with pytest.raises(ValueError, match="UPLO='L'"):
        port.cholesky_solve("U", b)
    with pytest.raises(ValueError, match="UPLO must be"):
        port.cholesky_solve("X", b)
    with pytest.raises(ValueError, match="trans must be"):
        port.lu_solve(b, "N")
    with pytest.raises(ValueError, match="expects 320"):
        port.lu_solve("N", np.ones(_N - 1))
    x = port.cholesky_solve("L", b)
    xt = port.cholesky_solve("L", torch.as_tensor(b))
    assert isinstance(x, np.ndarray) and torch.is_tensor(xt)
    assert np.array_equal(xt.numpy(), x)
    port.lu_factorization()
    with pytest.raises(ValueError, match="lu_factorization"):
        port.cholesky_solve("L", b)
    assert _rel(port.lu_solve("N", b), x) < 1e-9


def test_rank_saturation_falls_back_to_dense_lu():
    """Above the HODLR threshold an operator that is not HODLR-compressible
    at the tolerance falls back to the dense LU, and still solves."""
    cfg = port_config()
    saved = cfg.hodlr_max_sample_size
    cfg.hodlr_max_sample_size = 16
    try:
        n = 500
        rng = np.random.RandomState(13)
        A = rng.rand(n, n) + n * np.eye(n)
        cb = T.ClusterTreeBuilder()
        cb.set_maximal_leaf_size(64)
        cluster = cb.create_cluster_tree(rng.rand(3, n), 2)
        hm = T.HMatrixTreeBuilder(1e-10, 10.0, "N", "N", device="cpu").build(
            T.MatrixGenerator(A, device="cpu"), cluster, cluster)
        f = copy.deepcopy(hm)
        f.lu_factorization()
        assert f._factorization[0] == "lu"
        x_ref = rng.rand(n)
        x = f.lu_solve("N", hm * x_ref)
        assert _rel(x, x_ref) < 1e-6
    finally:
        cfg.hodlr_max_sample_size = saved
