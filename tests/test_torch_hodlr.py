"""The port's HODLR factorization (ops/hodlr.py) against the reference's.

* `build_hodlr` on a dense f64 / complex128 operator n I + F G^T (n = 640
  = 10 * 64, so no padding rows; leaf 64; F, G random of rank 4, so every
  off-diagonal block is exactly low-rank and the randomized range capture
  is exact up to round-off),
  with the same numpy Generator seed in both packages: the geometry and
  every level's per-block ranks are equal, each level's U V and the leaf
  blocks D agree to 1e-10 relative, and `hodlr_solve` 'N' / 'T' (and 'C'
  in complex128) agree to 1e-10.  Storage 'N' and 'S' in f64, 'H'
  (mirrored conjugate factors) in complex128.
* The reference's own cases (tests/test_hodlr.py:90-248) on the port: the
  saturation bound, the fresh-seed retry before the raise, the
  adversarial (f32-overflowing) probe draw, the exact small symmetric
  solve.  The dense fallback is in test_torch_factorization.py.

Everything runs on the CPU through the plain torch ops; QR column signs
and LU pivots may differ between the packages, so U V products, ranks and
solves are compared, never factors or pivots.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from htool_python_torch.ops import hodlr as P
from htool_python_tpu.ops import hodlr as R
from test_torch_complex import one_thread  # noqa: F401 (fixture)

_N, _LEAF, _EPS = 640, 64, 1e-8


def _operator(sym, complex_):
    """n I + F G^T with exactly rank-4 (rank-7 complex) off-diagonal
    blocks; 'S' / 'H' make it symmetric / hermitian."""
    rng = np.random.RandomState(5)
    F = rng.standard_normal((_N, 4))
    G = F if sym != "N" else rng.standard_normal((_N, 4))
    A = _N * np.eye(_N) + F @ G.T
    if complex_:
        E = rng.standard_normal((_N, 3)) + 1j * rng.standard_normal((_N, 3))
        A = A + (E @ E.conj().T if sym == "H"
                 else E @ E.T if sym == "S"
                 else E @ rng.standard_normal((3, _N)))
    return A


def _appliers(A):
    Aj, At = jnp.asarray(A), torch.as_tensor(A)

    def pick(M, trans):
        return M if trans == "N" else (M.T if trans == "T" else M.conj().T)

    return (lambda x, t: pick(Aj, t) @ x), (lambda x, t: pick(At, t) @ x)


def _block_ranks(V):
    """Per-block ranks: the truncation zeroes V's rows past the rank."""
    return (np.abs(np.asarray(V)).max(axis=2) > 0).sum(axis=1)


def _rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("sym,complex_", [("N", False), ("S", False),
                                          ("H", True)])
def test_build_and_solve_match_reference(sym, complex_):
    A = _operator(sym, complex_)
    dtype = np.complex128 if complex_ else np.float64
    f_ref, f_port = _appliers(A)
    href = R.build_hodlr(f_ref, _N, dtype, _EPS, leaf_size=_LEAF, sym=sym,
                         rng=np.random.default_rng(3))
    hport = P.build_hodlr(f_port, _N, dtype, _EPS, leaf_size=_LEAF, sym=sym,
                          rng=np.random.default_rng(3), device="cpu")
    assert (hport.L, hport.ml, hport.n_pad) == (href.L, href.ml, href.n_pad)
    assert P._geometry(_N, _LEAF) == R._geometry(_N, _LEAF)
    assert len(hport.levels) == len(href.levels) == href.L
    for lev_r, lev_p in zip(href.levels, hport.levels):
        assert [tuple(t.shape) for t in lev_p] == [t.shape for t in lev_r]
        for (U, V), (Up, Vp) in (((lev_r[0], lev_r[1]), lev_p[:2]),
                                 ((lev_r[2], lev_r[3]), lev_p[2:])):
            assert np.array_equal(_block_ranks(Vp), _block_ranks(V))
            UV = np.einsum("pmr,prn->pmn", np.asarray(U), np.asarray(V))
            UVp = torch.einsum("pmr,prn->pmn", Up, Vp).numpy()
            assert _rel(UVp, UV) < 1e-10
    assert _rel(hport.D.numpy(), np.asarray(href.D)) < 1e-10

    fref, fport = R.factor_hodlr(href), P.factor_hodlr(hport)
    b = np.random.RandomState(1).rand(_N, 3)
    if complex_:
        b = b + 1j * np.random.RandomState(2).rand(_N, 3)
    for trans in ("N", "T", "C") if complex_ else ("N", "T"):
        x_ref = np.asarray(R.hodlr_solve(fref, b, trans))
        x = P.hodlr_solve(fport, torch.as_tensor(b), trans).numpy()
        assert _rel(x, x_ref) < 1e-10
        x1 = P.hodlr_solve(fport, torch.as_tensor(b[:, 0]), trans).numpy()
        assert _rel(x1, x_ref[:, 0]) < 1e-10
    y = P.hodlr_matvec(hport, torch.as_tensor(b)).numpy()
    assert _rel(y, np.asarray(R.hodlr_matvec(href, b))) < 1e-10
    assert _rel(y, A @ b) < 1e-10


def _full_rank(n=600):
    rng = np.random.RandomState(11)
    A = torch.as_tensor(rng.rand(n, n) + n * np.eye(n))
    return n, lambda x, t: (A if t == "N" else A.T) @ x


def test_rank_saturation_bounded():
    """A full-rank off-diagonal operator hits the sample cap and raises,
    rather than peeling toward k = m with dense-size probe batches."""
    n, apply_fn = _full_rank()
    with pytest.raises(P.HODLRRankSaturationError):
        P.build_hodlr(apply_fn, n, torch.float64, 1e-12, leaf_size=64,
                      max_sample_size=32, device="cpu")


def test_saturation_retries_with_fresh_seed_then_raises():
    """Saturation triggers one fresh-seed retry of the level before the
    raise, and the error says so."""
    n, apply_fn = _full_rank()

    class CountingRng:
        def __init__(self):
            self.inner = np.random.default_rng(0x5EED)
            self.reseeds = 0

        def standard_normal(self, shape):
            return self.inner.standard_normal(shape)

        def integers(self, high):
            self.reseeds += 1
            return self.inner.integers(high)

    counting = CountingRng()
    with pytest.raises(P.HODLRRankSaturationError, match="retry"):
        P.build_hodlr(apply_fn, n, torch.float64, 1e-12, leaf_size=64,
                      max_sample_size=32, rng=counting, device="cpu")
    assert counting.reseeds == 1


def test_robust_to_adversarial_probe_draw():
    """An f32-overflowing probe draw poisons the factors with non-finite
    values without saturating: the build detects it, redraws with a fresh
    seed and still ends in a usable factorization."""
    n = 512
    rng0 = np.random.default_rng(7)
    pts = np.sort(rng0.random(n))
    A = (np.eye(n) * 2.0
         + 1.0 / (50.0 * np.abs(pts[:, None] - pts[None, :]) + 1.0))
    At = torch.as_tensor(A.astype(np.float32))

    class ScaledRng:
        def __init__(self, scale):
            self.inner = np.random.default_rng(0)
            self.scale = scale

        def standard_normal(self, shape):
            return self.inner.standard_normal(shape) * self.scale

        def integers(self, high):
            return self.inner.integers(high)

    h = P.build_hodlr(lambda x, t: (At if t == "N" else At.T) @ x, n,
                      torch.float32, 1e-4, leaf_size=64,
                      rng=ScaledRng(1e35), max_sample_size=64, device="cpu")
    f = P.factor_hodlr(h)
    b = torch.as_tensor(rng0.standard_normal((n, 1)).astype(np.float32))
    x = P.hodlr_solve(f, b, "N")
    assert float(torch.linalg.norm(At @ x - b) / torch.linalg.norm(b)) < 50e-4


def test_small_symmetric_exact():
    """Symmetric mirrored HODLR of a small dense SPD matrix against a dense
    solve."""
    n = 700
    rng = np.random.RandomState(5)
    B = rng.rand(n, n)
    A = torch.as_tensor(B @ B.T + n * np.eye(n))
    h = P.build_hodlr(lambda x, t: (A if t == "N" else A.T) @ x, n,
                      torch.float64, 1e-10, leaf_size=64, sym="S",
                      device="cpu")
    f = P.factor_hodlr(h)
    x_ref = torch.as_tensor(rng.rand(n))
    x = P.hodlr_solve(f, A @ x_ref)
    assert float(torch.linalg.norm(x - x_ref) / torch.linalg.norm(x_ref)) < 1e-7


def test_solve_rejects_wrong_size():
    n, apply_fn = 100, lambda x, t: 2.0 * x
    f = P.factor_hodlr(P.build_hodlr(apply_fn, n, torch.float64, 1e-8,
                                     leaf_size=32, device="cpu"))
    with pytest.raises(ValueError, match="RHS of size 100"):
        P.hodlr_solve(f, torch.ones(99, dtype=torch.float64))
    x = P.hodlr_solve(f, torch.ones(n, dtype=torch.float64))
    assert torch.allclose(x, torch.full((n,), 0.5, dtype=torch.float64))
