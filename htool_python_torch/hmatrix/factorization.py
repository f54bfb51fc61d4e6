"""H-matrix factorizations: LU and Cholesky, and their solves.

Counterpart of htool_python_tpu/hmatrix/factorization.py.  Factorization
is in place (deepcopy first); solving with the factorization of an
epsilon-compressed operator gives relative error < epsilon.

Two paths, chosen by size:
- n <= config.hodlr_threshold: densify and factor on the device
  (torch.linalg LU / Cholesky), exact;
- larger: the level-batched HODLR Woodbury factorization (ops/hodlr.py),
  built by randomized peeling through the operator's own product (kernel
  K1, or K1-al with config.matvec_aligned_layout, on CUDA).  When the
  operator is not HODLR-compressible at the tolerance
  (HODLRRankSaturationError) it falls back to the dense path with a
  warning, as the reference does.

Solves take numpy and return numpy, or take a tensor on the operator's
device and return a tensor there.  Unlike the reference, `cholesky_solve`
raises ValueError when its UPLO is not the factorization's.
"""

from __future__ import annotations

import logging
import time

import torch

from ..config import get_config, require_full_f32
from ..ops.hodlr import (HODLRRankSaturationError, _lu_solve, build_hodlr,
                         factor_hodlr, hodlr_solve)
from ..utils.logger import get_logger

# columns of one product during the peeling: the probe batches widen up to
# config.hodlr_max_sample_size columns, applied in chunks of this many
_CHUNK = 128


def _clock(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def _hierarchical_factor(hmatrix, sym: str = "N"):
    """The HODLR factorization of `hmatrix`, built through its product; its
    `profile` holds the seconds of the HODLR build and of the Woodbury
    factorization, the products the build ran and their columns, and the
    largest block ranks of each level."""

    cfg = get_config()
    n = hmatrix.shape[0]
    eps = max(hmatrix.epsilon * cfg.hodlr_eps_factor, 1e-14)

    profile = {"products": 0, "columns": 0}

    def product(x, trans):
        profile["products"] += 1
        profile["columns"] += x.shape[1]
        return hmatrix._apply_internal_2d(x, trans)

    def apply_fn(x, trans):
        if x.shape[1] <= _CHUNK:
            return product(x, trans)
        return torch.cat([product(x[:, i:i + _CHUNK], trans)
                          for i in range(0, x.shape[1], _CHUNK)], dim=1)

    t0 = _clock(hmatrix.device)
    h = build_hodlr(apply_fn, n, hmatrix.dtype, eps,
                    leaf_size=cfg.hodlr_leaf_size,
                    sample_size=cfg.hodlr_sample_size,
                    power_iters=cfg.hodlr_power_iters,
                    sym=sym, device=hmatrix.device)
    t1 = _clock(hmatrix.device)
    fact = factor_hodlr(h)
    fact.profile = dict(profile, n=n, sym=sym, L=h.L, hodlr_leaf=h.ml,
                        build_s=t1 - t0, factor_s=_clock(hmatrix.device) - t1,
                        max_ranks=h.max_ranks)
    return fact


def _check_square(hmatrix, what):
    n, nc = hmatrix.shape
    if n != nc:
        raise ValueError(f"{what} requires a square H-matrix")
    if hmatrix.device.type == "cuda":
        require_full_f32()
    return n


def lu_factorization(hmatrix) -> None:
    n = _check_square(hmatrix, "lu_factorization")
    if n > get_config().hodlr_threshold:
        try:
            hmatrix._factorization = ("hodlr", _hierarchical_factor(hmatrix))
            return
        except HODLRRankSaturationError as e:
            get_logger().warning(
                "%s; falling back to the dense LU path (O(n^2) memory)", e)
    lu, piv = torch.linalg.lu_factor(hmatrix.to_dense_tensor())
    hmatrix._factorization = ("lu", lu, piv)


def cholesky_factorization(hmatrix, UPLO: str = "L") -> None:
    if not isinstance(UPLO, str) or UPLO not in ("L", "U"):
        raise ValueError(f"cholesky_factorization(UPLO): UPLO must be 'L' or "
                         f"'U', got {UPLO!r}")
    n = _check_square(hmatrix, "cholesky_factorization")
    if n > get_config().hodlr_threshold:
        # symmetric HODLR Woodbury: sample one triangle, mirror the factors
        sym = "H" if hmatrix.dtype.is_complex else "S"
        try:
            hmatrix._factorization = (
                "hodlr", _hierarchical_factor(hmatrix, sym=sym), UPLO)
            return
        except HODLRRankSaturationError as e:
            get_logger().warning(
                "%s; falling back to the dense Cholesky path "
                "(O(n^2) memory)", e)
    c = torch.linalg.cholesky(hmatrix.to_dense_tensor(), upper=(UPLO == "U"))
    hmatrix._factorization = ("cholesky", c, UPLO)


def _solve_internal(hmatrix, trans: str, b2):
    """Solve in internal numbering; b2 an (n, k) tensor on the device."""
    kind = hmatrix._factorization[0]
    if kind == "lu":
        _, lu, piv = hmatrix._factorization
        return _lu_solve(lu, piv, b2, trans)
    if kind == "hodlr":
        fact = hmatrix._factorization[1]
        x = hodlr_solve(fact, b2, trans)
        log = get_logger()
        debug = log.isEnabledFor(logging.DEBUG)
        res0 = None
        for i in range(get_config().hodlr_refine_iters):
            r = b2 - hmatrix._apply_internal_2d(x, trans)
            if debug and i == 0:
                res0 = float(torch.linalg.norm(r) / torch.linalg.norm(b2))
            x = x + hodlr_solve(fact, r, trans)
        if debug and res0 is not None:
            rf = b2 - hmatrix._apply_internal_2d(x, trans)
            resf = float(torch.linalg.norm(rf) / torch.linalg.norm(b2))
            if res0 > 10 * hmatrix.epsilon > resf:
                log.debug(
                    "HODLR solve: raw factorization residual %.2e exceeded "
                    "epsilon=%.0e; iterative refinement carried it to %.2e",
                    res0, hmatrix.epsilon, resf)
        return x
    _, c, UPLO = hmatrix._factorization
    dtype = torch.promote_types(c.dtype, b2.dtype)
    c, b2 = c.to(dtype), b2.to(dtype)
    # A = L L^H (lower) or U^H U (upper)
    if UPLO == "L":
        y = torch.linalg.solve_triangular(c, b2, upper=False)
        return torch.linalg.solve_triangular(c.mH, y, upper=True)
    y = torch.linalg.solve_triangular(c.mH, b2, upper=False)
    return torch.linalg.solve_triangular(c, y, upper=True)


def _user_solve(hmatrix, trans: str, b):
    """Solve in user numbering for root H-matrices (what `lu_solve`
    returns); sub-block H-matrices solve in internal numbering.  numpy in
    -> numpy out, tensor in -> tensor out."""
    if hmatrix._factorization is None:
        raise RuntimeError(
            "call lu_factorization / cholesky_factorization first")
    b, device_io = hmatrix._to_device(b)
    n = hmatrix.plan.nb_rows
    if len(b) != n:
        raise ValueError(
            f"rhs has {len(b)} rows; factorized operator expects {n}")
    squeeze = b.ndim == 1
    b2 = b[:, None] if squeeze else b
    if hmatrix.is_root():
        # the solve maps rows (target numbering) to columns (source) for
        # 'N': the permutations of the transposed product
        perm_in, inv_out = hmatrix._device_perms("T" if trans == "N" else "N")
        x = _solve_internal(hmatrix, trans, b2[perm_in])[inv_out]
    else:
        x = _solve_internal(hmatrix, trans, b2)
    x = x[:, 0] if squeeze else x
    return x if device_io else x.cpu().numpy()


def lu_solve(hmatrix, trans: str, b):
    # the reference signature is (trans char, rhs); a clear error here
    # beats the failure a swapped call hits further down
    if not isinstance(trans, str) or trans not in ("N", "T", "C"):
        raise ValueError(
            f"lu_solve(trans, b): trans must be 'N', 'T' or 'C', got "
            f"{trans!r}")
    return _user_solve(hmatrix, trans, b)


def cholesky_solve(hmatrix, UPLO: str, b):
    if not isinstance(UPLO, str) or UPLO not in ("L", "U"):
        raise ValueError(
            f"cholesky_solve(UPLO, b): UPLO must be 'L' or 'U', got "
            f"{UPLO!r}")
    fact = hmatrix._factorization
    if fact is not None:
        # ("cholesky", c, UPLO) or ("hodlr", f, UPLO); an LU has none
        stored = fact[2] if fact[0] != "lu" and len(fact) == 3 else None
        if stored != UPLO:
            raise ValueError(
                f"cholesky_solve(UPLO={UPLO!r}): the operator was factorized "
                + (f"with UPLO={stored!r}" if stored else
                   "by lu_factorization"))
    return _user_solve(hmatrix, "N", b)
