"""The port's Krylov solvers against the reference's (CPU, float64 and
complex128): the same systems and preconditioners through both packages'
device solvers (restarted right- and left-preconditioned GMRES, blocked
multi-RHS with columns that converge at different iterations, CG) and host
solvers.  The port keeps the reference's arithmetic (CGS2, lartg Givens
rotations, the breakdown rule), so iteration counts are equal and the
solutions agree to 1e-10.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from htool_python_torch.solvers import krylov
from htool_python_tpu.solvers import krylov as ref_krylov
from test_torch_complex import one_thread  # noqa: F401

_N = 80


def _system(dtype, seed=0, spd=False):
    """A well-conditioned nonsymmetric (or SPD) matrix with a spread
    spectrum, and its Jacobi preconditioner (inverse diagonal)."""
    rng = np.random.RandomState(seed)
    B = rng.randn(_N, _N) / np.sqrt(_N)
    if dtype == np.complex128:
        B = B + 1j * rng.randn(_N, _N) / np.sqrt(_N)
    if spd:
        A = B @ B.conj().T + np.diag(np.linspace(0.5, 20.0, _N))
    else:
        A = B + np.diag(np.linspace(1.0, 30.0, _N))
    return A.astype(dtype), (1.0 / np.diag(A)).astype(dtype)


def _rhs(dtype, k, seed=1):
    rng = np.random.RandomState(seed)
    b = rng.rand(_N, k)
    if dtype == np.complex128:
        b = b + 1j * rng.rand(_N, k)
    return b.astype(dtype)


def _ops(A, dinv):
    """(port A, port M, reference A, reference M)."""
    At, dt = torch.as_tensor(A), torch.as_tensor(dinv)[:, None]
    Aj, dj = jnp.asarray(A), jnp.asarray(dinv)[:, None]
    return (lambda v: At @ v, lambda v: dt * v,
            lambda v: Aj @ v, lambda v: dj * v)


def _compare(x, info, x_ref, info_ref):
    assert np.array_equal(np.asarray(info["niter"]),
                          np.asarray(info_ref["niter"]))
    x, x_ref = np.asarray(x), np.asarray(x_ref)
    assert np.linalg.norm(x - x_ref) <= 1e-10 * np.linalg.norm(x_ref)
    assert np.all(info["converged"])


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
@pytest.mark.parametrize("variant", ["right", "left"])
def test_gmres_matches_reference(dtype, variant):
    A, dinv = _system(dtype)
    pA, pM, rA, rM = _ops(A, dinv)
    b = _rhs(dtype, 1)[:, 0]
    if variant == "left":  # M^{-1} A x = M^{-1} b, no inner preconditioner
        pA = krylov.compose_operators(pM, pA)
        rA = ref_krylov.compose_operators(rM, rA)
        bp = pM(torch.as_tensor(b)[:, None])[:, 0]
        br = np.asarray(rM(jnp.asarray(b)[:, None]))[:, 0]
        pM = rM = None
    else:
        bp, br = torch.as_tensor(b), b
    x, info = krylov.gmres_device(pA, bp, M_fn=pM, tol=1e-10, max_it=200,
                                  restart=5)
    x_ref, info_ref = ref_krylov.gmres_device(rA, br, M_fn=rM, tol=1e-10,
                                              max_it=200, restart=5)
    assert x.shape == (_N,)
    _compare(x, info, x_ref, info_ref)
    assert info["niter"][0] > 5  # it restarted
    assert info["residual_estimate"][0] <= 1e-10


def test_blocked_gmres_with_unequal_columns():
    """Four columns: a generic one, one whose solution lies in a small
    Krylov space (a happy breakdown), a zero column (converged at the
    start) and a scaled copy of the first; restarts every 6 iterations."""
    A = np.diag(np.linspace(1.0, 30.0, _N)) + np.triu(
        np.random.RandomState(2).rand(_N, _N), 1) / _N
    b = _rhs(np.float64, 4)
    b[:, 1] = 0.0
    b[:3, 1] = [1.0, 2.0, 3.0]  # A upper triangular: x lives in 3 dims
    b[:, 2] = 0.0
    b[:, 3] = 1e3 * b[:, 0]
    pA, pM, rA, rM = _ops(A, 1.0 / np.diag(A))
    x, info = krylov.gmres_device(pA, torch.as_tensor(b), M_fn=pM, tol=1e-9,
                                  max_it=120, restart=6)
    x_ref, info_ref = ref_krylov.gmres_device(rA, b, M_fn=rM, tol=1e-9,
                                              max_it=120, restart=6)
    assert len(set(info["niter"].tolist())) >= 3  # unequal convergence
    assert info["niter"][2] == 0
    _compare(x, info, x_ref, info_ref)


def test_cg_matches_reference():
    A, dinv = _system(np.float64, seed=3, spd=True)
    pA, pM, rA, rM = _ops(A, dinv)
    b = _rhs(np.float64, 2, seed=4)
    x, info = krylov.cg_device(pA, torch.as_tensor(b), M_fn=pM, tol=1e-10,
                               max_it=300)
    x_ref, info_ref = ref_krylov.cg_device(rA, b, M_fn=rM, tol=1e-10,
                                           max_it=300)
    _compare(x, info, x_ref, info_ref)


@pytest.mark.parametrize("dtype", [np.float64, np.complex128])
def test_host_solvers_match_reference(dtype):
    A, dinv = _system(dtype, seed=5, spd=dtype == np.float64)
    b = _rhs(dtype, 1, seed=6)[:, 0]
    op = lambda v: A @ v  # noqa: E731
    M = lambda v: dinv * v  # noqa: E731
    for solve in ("gmres", "cg") if dtype == np.float64 else ("gmres",):
        kw = {"restart": 12} if solve == "gmres" else {}
        x, info = getattr(krylov, solve)(op, b, M=M, tol=1e-10, max_it=200,
                                         **kw)
        x_ref, info_ref = getattr(ref_krylov, solve)(op, b, M=M, tol=1e-10,
                                                     max_it=200, **kw)
        assert info["niter"] == info_ref["niter"]
        assert np.linalg.norm(x - x_ref) <= 1e-10 * np.linalg.norm(x_ref)
        assert info["converged"]
