"""Hierarchical factorization: a level-batched HODLR solver built by
randomized peeling through the operator's own bucketed product.

Counterpart of htool_python_tpu/ops/hodlr.py.  The operator is
re-compressed into a level-balanced HODLR form (uniform bisection of the
internal numbering, which is leaf-contiguous, so contiguous index ranges
are spatially coherent and the off-diagonal blocks numerically low-rank)
and factorized as a product of block-diagonal Woodbury factors:

    A^{-1} = K_0 o K_1 o ... o K_{L-1} o S_leaf
    K_j    = I - G_j C_j^{-1} Vt_j          (block-diagonal per level-j node)
    S_leaf = batched LU solve of the 2^L leaf diagonal blocks

where for a level-j node with children (a, b) and off-diagonal factors
A_ab ~ U_up V_up, A_ba ~ U_lo V_lo:

    Vt_j = [[0, V_up], [V_lo, 0]],   U_j = [[U_up, 0], [0, U_lo]]
    G_j  = (blkdiag(A_a, A_b))^{-1} U_j    (computed with the finer factors)
    C_j  = I_{2r} + Vt_j G_j               (small capacitance, batched LU)

Every step (sampling, QR, SVD truncation, capacitance LU, the solve
sweeps) is one batched torch op over all nodes of a level.  The HODLR form
is built from any linear operator exposed as `apply(X, trans) -> Y` on
(n, k) tensors with trans in {'N', 'T', 'C'}: for level j (top-down),
random probes supported on the "b" (resp. "a") child column ranges are
pushed through the operator, the coarser levels' contributions are
subtracted (peeling), and the finer levels cannot pollute because their
column ranges lie inside the level-j diagonal where the probes are zero.
The leaf diagonal blocks come from one batched identity probe minus the
accumulated off-diagonal expansion.

Probes are drawn on the host from an explicit numpy Generator, in the
reference's draw order, and moved to the device once per draw, so the
port draws the reference's probes.  LU pivots are LAPACK's (1-based, where
JAX's are 0-based) and QR column signs may differ from the reference's:
compare solves and U V products, never pivots or factors.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import as_torch_dtype, get_config, resolve_device
from .aca import batched_truncate


# ---------------------------------------------------------------------------
# representation


@dataclasses.dataclass
class HODLR:
    """Level-balanced HODLR approximation of a square operator.

    levels[j] = (U_up, V_up, U_lo, V_lo) with shapes
      U_* (2^j, m_j, r_j), V_* (2^j, r_j, m_j), m_j = n_pad / 2^(j+1).
    D: (2^L, ml, ml) leaf diagonal blocks (identity on padding rows/cols).
    """

    n: int
    n_pad: int
    ml: int
    L: int
    levels: list
    D: torch.Tensor
    dtype: torch.dtype
    # per level, the largest block rank of the upper and lower
    # off-diagonal factors (diagnostics)
    max_ranks: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class HODLRFactorization:
    """Woodbury factor chain: leaf LU + per-level (G, C_lu, C_piv)."""

    hodlr: HODLR
    lu_d: torch.Tensor
    piv_d: torch.Tensor
    # facts[j] = (G (2^j, 2*m_j, 2*r_j), C_lu (2^j, 2r, 2r), C_piv)
    facts: list
    profile: dict = dataclasses.field(default_factory=dict)  # diagnostics


def _geometry(n: int, leaf_size: int):
    """Pick (L, ml, n_pad): ml * 2^L >= n with small padding overhead."""
    L = 0
    while (n + (1 << L) - 1) // (1 << L) > leaf_size:
        L += 1
    ml = -(-n // (1 << L))  # ceil
    ml = max(8, -(-ml // 8) * 8)  # round to 8
    return L, ml, ml * (1 << L)


def _lu_solve(lu, piv, b, trans: str = "N"):
    """Solve A^(trans) x = b from torch.linalg.lu_factor's (lu, piv):
    'T' of complex data solves with the conjugates (A^T x = b <=>
    A^H conj(x) = conj(b)).  Computes in the promoted dtype of lu and b."""
    dtype = torch.promote_types(lu.dtype, b.dtype)
    lu, b = lu.to(dtype), b.to(dtype)
    if trans == "N":
        return torch.linalg.lu_solve(lu, piv, b)
    if trans == "C" or not lu.is_complex():
        return torch.linalg.lu_solve(lu, piv, b, adjoint=True)
    return torch.linalg.lu_solve(lu, piv, b.conj().resolve_conj(),
                                 adjoint=True).conj().resolve_conj()


# ---------------------------------------------------------------------------
# off-diagonal expansion apply (used for peeling and for leaf extraction)


def _level_apply(lev, x, trans):
    """Apply one level's off-diagonal expansion to x (n_pad, k)."""
    U_up, V_up, U_lo, V_lo = lev
    p, m, r = U_up.shape
    k = x.shape[1]
    xr = x.reshape(p, 2, m, k)
    xa, xb = xr[:, 0], xr[:, 1]
    if trans == "N":
        ya = torch.einsum("pmr,prk->pmk", U_up,
                          torch.einsum("prm,pmk->prk", V_up, xb))
        yb = torch.einsum("pmr,prk->pmk", U_lo,
                          torch.einsum("prm,pmk->prk", V_lo, xa))
    else:
        conj = trans == "C"
        Uu, Vu, Ul, Vl = ((t.conj() if conj else t)
                          for t in (U_up, V_up, U_lo, V_lo))
        # block (a,b)^T acts b <- a with V_up^T U_up^T
        yb = torch.einsum("prm,prk->pmk", Vu,
                          torch.einsum("pmr,pmk->prk", Uu, xa))
        ya = torch.einsum("prm,prk->pmk", Vl,
                          torch.einsum("pmr,pmk->prk", Ul, xb))
    return torch.stack([ya, yb], dim=1).reshape(x.shape)


def _offdiag_apply(levels, x, trans):
    y = torch.zeros_like(x)
    for lev in levels:
        y = y + _level_apply(lev, x, trans)
    return y


def hodlr_matvec(h: HODLR, x, trans: str = "N"):
    """Full HODLR product (diagnostics / tests); x a tensor on the
    HODLR's device, (n,) or (n, k)."""
    squeeze = x.ndim == 1
    x2 = x[:, None] if squeeze else x
    k = x2.shape[1]
    xp = torch.zeros((h.n_pad, k), dtype=torch.promote_types(x2.dtype, h.dtype),
                     device=h.D.device)
    xp[:h.n] = x2
    y = _offdiag_apply(h.levels, xp, trans)
    xr = xp.reshape(-1, h.ml, k)
    if trans == "N":
        yd = torch.einsum("pij,pjk->pik", h.D, xr)
    elif trans == "T":
        yd = torch.einsum("pji,pjk->pik", h.D, xr)
    else:
        yd = torch.einsum("pji,pjk->pik", h.D.conj(), xr)
    y = (y + yd.reshape(h.n_pad, k))[:h.n]
    return y[:, 0] if squeeze else y


# ---------------------------------------------------------------------------
# construction by randomized peeling


class HODLRRankSaturationError(RuntimeError):
    """Raised when an off-diagonal block's numerical rank exceeds the
    adaptive sampling cap: the operator is not HODLR-compressible at the
    requested tolerance (callers fall back to the dense factorization)."""


def build_hodlr(apply_fn, n: int, dtype, eps: float, leaf_size: int = 256,
                sample_size: int = 32, power_iters: int = 1,
                rng: np.random.Generator | None = None,
                sym: str = "N", max_sample_size: int | None = None,
                device=None) -> HODLR:
    """Compress the operator `apply_fn` into HODLR form on `device`.

    apply_fn(X, trans): (n, k) -> (n, k) tensors, trans in {'N','T','C'}.
    eps: per-block relative Frobenius truncation tolerance.
    sym: 'S' (A_ba = A_ab^T) or 'H' (A_ba = A_ab^H) samples only the upper
    off-diagonal blocks and mirrors the factors (half the peeling work, an
    exactly symmetric representation).
    rng: the probes' numpy Generator (default default_rng(0x5eed)); the
    draws are the reference's.
    max_sample_size: cap on the adaptive sample doubling per level
    (default config.hodlr_max_sample_size, itself capped at the block
    size); exceeding it raises HODLRRankSaturationError.
    """
    if max_sample_size is None:
        max_sample_size = get_config().hodlr_max_sample_size
    if rng is None:
        rng = np.random.default_rng(0x5eed)
    device = resolve_device(device)
    dtype = as_torch_dtype(dtype)
    np_dtype = np.dtype(str(dtype).replace("torch.", ""))
    L, ml, n_pad = _geometry(n, leaf_size)

    def apply_pad(xp, trans):
        y = apply_fn(xp[:n], trans)
        out = torch.zeros((n_pad, xp.shape[1]), dtype=xp.dtype, device=device)
        out[:n] = y
        return out

    def probes(shape):
        w = rng.standard_normal(shape)
        if np.issubdtype(np_dtype, np.complexfloating):
            w = w + 1j * rng.standard_normal(shape)
        return torch.from_numpy(w.astype(np_dtype, copy=False)).to(device)

    def peel(x, trans):
        return apply_pad(x, trans) - _offdiag_apply(levels, x, trans)

    levels: list = []
    max_ranks: list = []
    row = torch.arange(n_pad, device=device)
    valid = row < n

    for j in range(L):
        p = 1 << j
        m = n_pad >> (j + 1)
        # child parity of each row at this level: 0 = "a" (even child)
        parity = (row // m) % 2
        k = min(max(sample_size, 16), m)
        sides = ("up",) if sym in ("S", "H") else ("up", "lo")
        retried = False
        while True:
            factors = []
            ok = True
            for side in sides:
                # sample columns of the (a,b) block (side 'up'): probes live
                # on b rows, results are read on a rows (and vice versa)
                src = ((parity == (1 if side == "up" else 0)) & valid)
                dst = ((parity == (0 if side == "up" else 1)) & valid)
                src = src.to(dtype)[:, None]
                dst = dst.to(dtype)[:, None]
                om = probes((n_pad, k)) * src
                y = peel(om, "N") * dst
                for _ in range(power_iters):
                    z = peel(y, "C") * src
                    y = peel(z, "N") * dst
                # batched QR over the blocks of this side
                half = 0 if side == "up" else 1
                Q, _ = torch.linalg.qr(y.reshape(p, 2, m, k)[:, half])
                qfull = torch.zeros((p, 2, m, k), dtype=dtype, device=device)
                qfull[:, half] = Q
                qfull = qfull.reshape(n_pad, k) * dst
                zr = (peel(qfull, "C") * src).reshape(p, 2, m, k)
                Z = zr[:, 1 - half]  # (p, m, k)
                V0 = Z.transpose(1, 2).conj()  # (p, k, m)
                # a numerically poisoned draw (e.g. f32 overflow through
                # the power iterations) yields non-finite factors without
                # saturating: detect it and redraw rather than ship NaNs
                # (checked before the truncation too: torch's SVD raises
                # on non-finite input where the reference's returns NaN)
                poisoned = not bool(torch.isfinite(Q).all()
                                    & torch.isfinite(V0).all())
                if not poisoned:
                    ranks0 = torch.full((p,), k, dtype=torch.int64,
                                        device=device)
                    U1, V1, r1 = batched_truncate(Q, V0, ranks0, eps)
                    r1 = r1.cpu().numpy()
                    poisoned = not bool(torch.isfinite(U1).all()
                                        & torch.isfinite(V1).all())
                if poisoned:
                    ok = False
                    break
                # adaptivity: a block that saturated the sample budget was
                # not captured: double k and redo the level
                if k < m and len(r1) and int(r1.max()) > k - 4:
                    ok = False
                    break
                factors.append((U1, V1, r1))
            if ok:
                break
            if poisoned or k >= min(max_sample_size, m):
                if not retried:
                    # one retry with a fresh probe draw before giving up:
                    # genuine high rank saturates again (the captured rank
                    # is bounded by the true block rank for any draw), a
                    # poisoned draw gets a second chance
                    retried = True
                    rng = np.random.default_rng(rng.integers(1 << 63))
                    k = min(max(sample_size, 16), m)
                    continue
                if poisoned:
                    raise HODLRRankSaturationError(
                        f"HODLR level {j}: non-finite factors from the "
                        "probe draw persisted after a fresh-seed retry")
                raise HODLRRankSaturationError(
                    f"HODLR level {j}: off-diagonal rank exceeds the sample "
                    f"cap {min(max_sample_size, m)} (block size {m}, eps "
                    f"{eps:g}) after a fresh-seed retry; operator is not "
                    "HODLR-compressible at this tolerance")
            k = min(2 * k, m, max_sample_size)
        if sym in ("S", "H"):
            # mirror: A_ba = (U_up V_up)^sigma => U_lo = V_up^sigma,
            # V_lo = U_up^sigma (sigma = T for 'S', H for 'H')
            U_up1, V_up1, r_up1 = factors[0]
            U_lo1, V_lo1 = V_up1.transpose(1, 2), U_up1.transpose(1, 2)
            if sym == "H":
                U_lo1, V_lo1 = U_lo1.conj(), V_lo1.conj()
            factors.append((U_lo1, V_lo1, r_up1))
        rmaxs = [int(f[2].max()) if len(f[2]) else 1 for f in factors]
        max_ranks.append(rmaxs)
        r_pad = max(8, -(-max(rmaxs + [1]) // 8) * 8)
        r_pad = min(r_pad, factors[0][0].shape[2])
        levels.append(tuple(
            t.contiguous().resolve_conj() for t in (
                factors[0][0][:, :, :r_pad], factors[0][1][:, :r_pad, :],
                factors[1][0][:, :, :r_pad], factors[1][1][:, :r_pad, :])))
        sample_size = max(16, min(int(1.25 * max(rmaxs)) + 8, m))

    # leaf diagonal extraction: batched identity probe minus the
    # accumulated off-diagonal expansion
    vmask = valid.to(dtype)[:, None]
    eye = (torch.arange(ml, device=device)[None, :]
           == (row % ml)[:, None]).to(dtype) * vmask
    D = peel(eye, "N").reshape(1 << L, ml, ml)
    # identity on padding rows/cols keeps the leaf LU nonsingular
    pad_diag = (~valid).to(dtype).reshape(1 << L, ml)
    D = D * vmask.reshape(1 << L, ml, 1) + torch.diag_embed(pad_diag)
    return HODLR(n=n, n_pad=n_pad, ml=ml, L=L, levels=levels, D=D,
                 dtype=dtype, max_ranks=max_ranks)


# ---------------------------------------------------------------------------
# factorization (bottom-up Woodbury chain)


def factor_hodlr(h: HODLR) -> HODLRFactorization:
    lu_d, piv_d = torch.linalg.lu_factor(h.D)
    facts: dict[int, tuple] = {}

    def solve_below(jmin, x):
        k = x.shape[1]
        x = _lu_solve(lu_d, piv_d, x.reshape(-1, h.ml, k)).reshape(h.n_pad, k)
        for j in range(h.L - 1, jmin - 1, -1):
            x = _woodbury_correct(h.levels[j], facts[j], x, "N")
        return x

    for j in reversed(range(h.L)):
        U_up, V_up, U_lo, V_lo = h.levels[j]
        p, m, r = U_up.shape
        ufull = torch.zeros((p, 2, m, 2 * r), dtype=h.dtype, device=h.D.device)
        ufull[:, 0, :, :r] = U_up
        ufull[:, 1, :, r:] = U_lo
        G = solve_below(j + 1, ufull.reshape(h.n_pad, 2 * r))
        Gr = G.reshape(p, 2, m, 2 * r)
        ct = torch.einsum("prm,pmk->prk", V_up, Gr[:, 1])
        cb = torch.einsum("prm,pmk->prk", V_lo, Gr[:, 0])
        C = (torch.eye(2 * r, dtype=h.dtype, device=h.D.device)[None]
             + torch.cat([ct, cb], dim=1))
        C_lu, C_piv = torch.linalg.lu_factor(C)
        facts[j] = (G.reshape(p, 2 * m, 2 * r), C_lu, C_piv)

    return HODLRFactorization(hodlr=h, lu_d=lu_d, piv_d=piv_d,
                              facts=[facts[j] for j in range(h.L)])


def _woodbury_correct(lev, fact, x, trans):
    """Apply K_j (trans 'N') or K_j^T / K_j^H to x (n_pad, k), in x's
    dtype (a wider x than the factors: the factors are cast)."""
    U_up, V_up, U_lo, V_lo = (t.to(x.dtype) for t in lev)
    G, C_lu, C_piv = fact
    G = G.to(x.dtype)
    p, m, r = U_up.shape
    k = x.shape[1]
    xn = x.reshape(p, 2 * m, k)
    if trans == "N":
        xr = xn.reshape(p, 2, m, k)
        t = torch.cat([torch.einsum("prm,pmk->prk", V_up, xr[:, 1]),
                       torch.einsum("prm,pmk->prk", V_lo, xr[:, 0])], dim=1)
        s = _lu_solve(C_lu, C_piv, t)
        y = xn - torch.einsum("pmr,prk->pmk", G, s)
    else:
        conj = trans == "C"
        Gc, Vu, Vl = ((t.conj() if conj else t) for t in (G, V_up, V_lo))
        t = torch.einsum("pmr,pmk->prk", Gc, xn)
        s = _lu_solve(C_lu, C_piv, t, trans)
        ya = torch.einsum("prm,prk->pmk", Vl, s[:, r:])
        yb = torch.einsum("prm,prk->pmk", Vu, s[:, :r])
        y = xn - torch.stack([ya, yb], dim=1).reshape(p, 2 * m, k)
    return y.reshape(x.shape)


def _solve_padded(lu_d, piv_d, levels, facts, x, L: int, trans: str):
    """Solve A^(trans) x_out = x on the padded (n_pad, k) right-hand side."""
    n_pad, k = x.shape
    ml = lu_d.shape[1]
    if trans == "N":
        x = _lu_solve(lu_d, piv_d, x.reshape(-1, ml, k)).reshape(n_pad, k)
        for j in range(L - 1, -1, -1):
            x = _woodbury_correct(levels[j], facts[j], x, "N")
    else:
        for j in range(L):
            x = _woodbury_correct(levels[j], facts[j], x, trans)
        x = _lu_solve(lu_d, piv_d, x.reshape(-1, ml, k),
                      trans).reshape(n_pad, k)
    return x


def hodlr_solve(f: HODLRFactorization, b, trans: str = "N"):
    """Solve A^(trans) x = b; b is (n,) or (n, k), a tensor (or an array,
    moved to the factorization's device).  Returns a tensor there."""
    h = f.hodlr
    b = torch.as_tensor(b, device=f.lu_d.device)
    squeeze = b.ndim == 1
    b2 = b[:, None] if squeeze else b
    if b2.shape[0] != h.n:
        raise ValueError(f"expected RHS of size {h.n}, got {b2.shape[0]}")
    xp = torch.zeros((h.n_pad, b2.shape[1]),
                     dtype=torch.promote_types(b2.dtype, h.dtype),
                     device=f.lu_d.device)
    xp[:h.n] = b2
    xp = _solve_padded(f.lu_d, f.piv_d, h.levels, f.facts, xp, h.L, trans)
    x = xp[:h.n]
    return x[:, 0] if squeeze else x
