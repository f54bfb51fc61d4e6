"""Krylov solvers: restarted preconditioned GMRES and CG.

Counterpart of htool_python_tpu/solvers/krylov.py, with its arithmetic
(classical Gram-Schmidt with one reorthogonalization, Givens rotations in
LAPACK `lartg` convention, an identity-initialized Hessenberg matrix and a
batched back-substitution, the breakdown rule), so that iteration counts
match the reference's.

* `gmres_device` / `cg_device`: the solvers' path.  Every right-hand side
  column marches in lockstep (blocked multi-RHS) with per-column `active`,
  `conv` and `brk` masks.  The Krylov basis and every O(n) operation stay
  on the operands' device.  GMRES keeps the small (m+1) x k Hessenberg
  recurrence (rotations, residual estimates, masks) on the host, in the
  working dtype: each inner iteration copies the new Hessenberg column
  ((j+2) x k values) to the host, which is also the iteration's one
  synchronisation, the early-exit test.  The update of x is the
  combination of the preconditioned vectors M v_j that the Arnoldi process
  multiplied by A (kept beside the basis), where the reference applies M
  once more to V y: the same x in exact arithmetic, but in float32 the
  extra application's rounding, amplified by A, lifted the true residual
  |b - A x| an order of magnitude above GMRES's own estimate.  CG reads
  one flag per column per iteration for the same test.
* `gmres` / `cg`: host recurrences for custom Python operators (numpy).

Nothing is cached between solves.
"""

from __future__ import annotations

import numpy as np
import torch

from ..hmatrix.assembly import _numpy_dtype


def _norm(v):
    return float(np.linalg.norm(v))


def _cols_norm(w):
    """Column 2-norms of (n, k): real (k,)."""
    return torch.sqrt(torch.sum(w.abs() ** 2, dim=0))


def compose_operators(outer, inner):
    """x -> outer(inner(x))."""
    return lambda x: outer(inner(x))


def _as_2d(b, dtype):
    b = torch.as_tensor(b)
    squeeze = b.ndim == 1
    b2 = b[:, None] if squeeze else b
    if dtype is not None:
        b2 = b2.to(dtype)
    return b2, squeeze


def _gmres_cycle(A_fn, M_fn, m, max_it, x, b, bnorm, conv, niter, est,
                 it_start, tol, verbosity):
    """One restart cycle of at most m inner iterations with per-column
    masking.  x, b: (n, k) tensors; bnorm (k,), conv (k,) bool, niter (k,),
    est (k,) (each column's last residual estimate) host arrays.  Returns
    (x, conv, niter, est).

    Host state (k = number of RHS columns): H (m+1, m, k) rotated
    Hessenberg, identity in its top (m, m) part so that the final batched
    triangular solve is valid for columns that stopped early; cs (m, k)
    real, sn (m, k), g (m+1, k) rotated rhs."""
    n, k = x.shape
    dtype = x.dtype
    device = x.device
    np_dtype = _numpy_dtype(dtype)
    np_rdtype = np.zeros((), np_dtype).real.dtype
    niter_in = niter.copy()

    r = b - A_fn(x)
    beta_t = _cols_norm(r)
    beta = beta_t.cpu().numpy()
    conv = conv | (beta <= tol * bnorm)
    conv_t = torch.as_tensor(conv, device=device)
    safe_beta = torch.where(beta_t > 0, beta_t, torch.ones_like(beta_t))
    V = torch.zeros((m + 1, n, k), dtype=dtype, device=device)
    MV = torch.zeros((m, n, k), dtype=dtype, device=device)  # M v_j
    V[0] = torch.where(conv_t[None, :], torch.zeros((), dtype=dtype,
                                                    device=device),
                       r / safe_beta[None, :].to(dtype))
    H = np.zeros((m + 1, m, k), dtype=np_dtype)
    H[np.arange(m), np.arange(m)] = 1.0
    cs = np.zeros((m, k), dtype=np_rdtype)
    sn = np.zeros((m, k), dtype=np_dtype)
    g = np.zeros((m + 1, k), dtype=np_dtype)
    g[0] = np.where(conv, 0.0, beta.astype(np_dtype))
    brk = np.zeros(k, dtype=bool)
    tiny = np.asarray(np.finfo(np_rdtype).tiny * 16, dtype=np_rdtype)
    safe_bnorm = np.where(bnorm > 0, bnorm, 1.0)

    j = 0
    while j < m and not np.all(conv | brk | (it_start + j >= max_it)):
        active = (~conv) & (~brk) & (it_start + j < max_it)
        MV[j] = M_fn(V[j])
        w = A_fn(MV[j])
        # CGS2: classical Gram-Schmidt with one reorthogonalization, each
        # pass one batched contraction over the basis built so far
        Vj = V[:j + 1]
        h1 = torch.einsum("ink,nk->ik", Vj.conj(), w)
        w = w - torch.einsum("ink,ik->nk", Vj, h1)
        h2 = torch.einsum("ink,nk->ik", Vj.conj(), w)
        w = w - torch.einsum("ink,ik->nk", Vj, h2)
        hj1_t = _cols_norm(w)
        host = torch.cat([h1 + h2, hj1_t[None, :].to(dtype)]).cpu().numpy()
        hj1 = host[j + 1].real.astype(np_rdtype)
        hcol = np.zeros((m + 1, k), dtype=np_dtype)
        hcol[:j + 1] = host[:j + 1]
        grow = hj1 > tiny
        keep = torch.as_tensor(active & grow, device=device)
        V[j + 1] = torch.where(
            keep[None, :],
            w / torch.where(keep, hj1_t, torch.ones_like(hj1_t))[None, :]
            .to(dtype), torch.zeros((), dtype=dtype, device=device))

        # apply the accumulated Givens rotations to the new column
        for i in range(j):
            t1 = cs[i] * hcol[i] + sn[i] * hcol[i + 1]
            t2 = -np.conj(sn[i]) * hcol[i] + cs[i] * hcol[i + 1]
            hcol[i] = t1
            hcol[i + 1] = t2
        # new rotation (LAPACK lartg convention: c real)
        a = hcol[j]
        absa = np.abs(a)
        babs = hj1  # real >= 0 by construction
        denom = np.sqrt(absa ** 2 + babs ** 2)
        c_new = np.where(denom > 0, absa / np.where(denom > 0, denom, 1.0),
                         1.0).astype(np_rdtype)
        c_new = np.where((absa == 0) & (babs > 0), 0.0, c_new).astype(
            np_rdtype)
        s_new = np.where(
            absa > 0,
            c_new.astype(np_dtype) * np.conj(
                babs.astype(np_dtype) / np.where(absa > 0, a, 1.0)),
            np.where(babs > 0, 1.0, 0.0)).astype(np_dtype)
        g_j = c_new.astype(np_dtype) * g[j]
        g_j1 = -np.conj(s_new) * g[j]
        h_jj = c_new.astype(np_dtype) * a + s_new * babs.astype(np_dtype)
        hcol[j] = h_jj
        hcol[j + 1] = 0.0

        H[:, j] = np.where(active[None, :], hcol, H[:, j])
        cs[j] = np.where(active, c_new, cs[j])
        sn[j] = np.where(active, s_new, sn[j])
        g[j] = np.where(active, g_j, g[j])
        g[j + 1] = np.where(active, g_j1, g[j + 1])
        res = np.abs(g[j + 1]) / safe_bnorm
        est = np.where(active, res, est)
        niter = niter + active.astype(niter.dtype)
        conv = conv | (active & (res <= tol))
        # breakdown without convergence: stop THIS cycle for the column
        # but do not flag it converged; the caller restarts it from the
        # updated x with a fresh residual (brk resets every cycle)
        brk = brk | (active & ~grow & ~conv)
        if verbosity and np.any(active):
            print(f"GMRES it {it_start + j + 1}: residual estimate "
                  f"{np.max(res[active]):.3e}")
        j += 1

    # batched back-substitution: columns that never ran keep the identity
    # diagonal and a zero rhs, so a zero update; g[done] holds the
    # least-squares remainder, not part of the system
    done = niter - niter_in
    gsys = g[:m] * (np.arange(m)[:, None] < done[None, :])
    R = torch.from_numpy(np.ascontiguousarray(np.moveaxis(H[:m], -1, 0)))
    gk = torch.from_numpy(np.ascontiguousarray(gsys.T[..., None]))
    y = torch.linalg.solve_triangular(R, gk, upper=True)[..., 0]  # (k, m)
    # rows past the iterations run this cycle are exactly zero
    dx = torch.einsum("jnk,kj->nk", MV[:j], y[:, :j].to(device))
    return x + dx, conv, niter, est


def gmres_device(A_fn, b, M_fn=None, tol=1e-6, max_it=100, restart=40,
                 verbosity=0, dtype=None):
    """Blocked-RHS restarted right-preconditioned GMRES.

    A_fn, M_fn: (n, k) -> (n, k) tensor functions (M_fn=None: identity).
    b: (n,) or (n, k) tensor, on the operators' device.  Returns (x, info)
    with per-column 'niter' (k,), 'residual' (k,) = |b - A x| / |b| after
    the solve, 'residual_estimate' (k,) = the solver's own last estimate
    |g_{j+1}| / |b| (0 for a column converged at the start), 'converged'
    (k,) = residual <= tol."""
    b2, squeeze = _as_2d(b, dtype)
    M = M_fn if M_fn is not None else (lambda v: v)
    n, k = b2.shape
    bnorm = _cols_norm(b2).cpu().numpy()
    restart = max(1, min(int(restart), int(max_it)))
    x = torch.zeros_like(b2)
    conv = np.zeros(k, dtype=bool)
    niter = np.zeros(k, dtype=np.int32)
    est = np.zeros(k, dtype=bnorm.dtype)
    total = 0
    while total < max_it:
        x, conv, niter, est = _gmres_cycle(A_fn, M, restart, int(max_it), x,
                                           b2, bnorm, conv, niter, est, total,
                                           tol, verbosity)
        total += restart
        if np.all(conv):
            break
    x, info = _finish(A_fn, b2, x, bnorm, tol, niter, squeeze)
    info["residual_estimate"] = est
    return x, info


def _finish(A_fn, b2, x, bnorm, tol, niter, squeeze):
    """(x, info) with the residual |b - A x| / |b| of every column."""
    res = (_cols_norm(b2 - A_fn(x)).cpu().numpy()
           / np.where(bnorm > 0, bnorm, 1.0))
    info = {"niter": np.asarray(niter), "residual": res,
            "converged": res <= tol}
    return (x[:, 0] if squeeze else x), info


def cg_device(A_fn, b, M_fn=None, tol=1e-6, max_it=100, verbosity=0,
              dtype=None):
    """Blocked-RHS preconditioned CG with per-column convergence masking;
    the same arguments and result as gmres_device."""
    b2, squeeze = _as_2d(b, dtype)
    M = M_fn if M_fn is not None else (lambda v: v)
    bnorm_t = _cols_norm(b2)
    bnorm = bnorm_t.cpu().numpy()
    x = torch.zeros_like(b2)
    r = b2 - A_fn(x)
    z = M(r)
    p = z
    rz = torch.sum(r.conj() * z, dim=0)
    conv = _cols_norm(r) <= tol * bnorm_t
    niter = torch.zeros(b2.shape[1], dtype=torch.int32, device=b2.device)
    it = 0
    zero = torch.zeros((), dtype=b2.dtype, device=b2.device)
    one = torch.ones((), dtype=b2.dtype, device=b2.device)
    while it < max_it and not bool(torch.all(conv)):
        active = ~conv
        Ap = A_fn(p)
        pAp = torch.sum(p.conj() * Ap, dim=0)
        alpha = torch.where(active & (pAp.abs() > 0),
                            rz / torch.where(pAp.abs() > 0, pAp, one), zero)
        x = x + alpha[None, :] * p
        r = r - alpha[None, :] * Ap
        z = M(r)
        rz_new = torch.sum(r.conj() * z, dim=0)
        beta = torch.where(active & (rz.abs() > 0),
                           rz_new / torch.where(rz.abs() > 0, rz, one), zero)
        p = torch.where(active[None, :], z + beta[None, :] * p, p)
        rz = torch.where(active, rz_new, rz)
        niter = niter + active.to(niter.dtype)
        conv = conv | (_cols_norm(r) <= tol * bnorm_t)
        it += 1
    x_out, info = _finish(A_fn, b2, x, bnorm, tol, niter.cpu().numpy(),
                          squeeze)
    if verbosity:
        print(f"CG finished after {int(np.max(info['niter']))} its: "
              f"residual {float(np.max(info['residual'])):.3e}")
    return x_out, info


# ======================================================================
# Host recurrences (custom Python operators / preconditioners)
# ======================================================================

def gmres(A, b, x0=None, M=None, tol=1e-6, max_it=100, restart=40,
          verbosity=0):
    """Right-preconditioned restarted GMRES for one RHS (host recurrences).

    A, M: callables v -> A@v, v -> M^{-1}@v (M=None => identity).
    Returns (x, info) with info = {'niter', 'residual', 'converged'}.
    """
    b = np.asarray(b)
    n = len(b)
    dtype = np.result_type(b.dtype, np.asarray(A(np.zeros_like(b))).dtype)
    x = np.zeros(n, dtype=dtype) if x0 is None else np.asarray(x0).astype(dtype)
    Mi = (lambda v: v) if M is None else M
    bnorm = _norm(b)
    if bnorm == 0:
        return np.zeros(n, dtype=dtype), {"niter": 0, "residual": 0.0,
                                          "converged": True}
    restart = max(1, min(restart, max_it))
    total_it = 0
    while total_it < max_it:
        r = b - np.asarray(A(x))
        beta = _norm(r)
        if beta / bnorm < tol:
            return x, {"niter": total_it, "residual": beta / bnorm,
                       "converged": True}
        m = min(restart, max_it - total_it)
        V = np.zeros((m + 1, n), dtype=dtype)
        H = np.zeros((m + 1, m), dtype=dtype)
        cs = np.zeros(m, dtype=dtype)
        sn = np.zeros(m, dtype=dtype)
        g = np.zeros(m + 1, dtype=dtype)
        V[0] = r / beta
        g[0] = beta
        j_done = 0
        for j in range(m):
            w = np.asarray(A(Mi(V[j])), dtype=dtype)
            # modified Gram-Schmidt
            for i in range(j + 1):
                H[i, j] = np.vdot(V[i], w)
                w = w - H[i, j] * V[i]
            H[j + 1, j] = _norm(w)
            breakdown = not (H[j + 1, j].real > np.finfo(
                np.dtype(dtype).type(0).real.dtype).tiny * 16)
            if not breakdown:
                V[j + 1] = w / H[j + 1, j]
            # apply accumulated Givens rotations
            for i in range(j):
                t = cs[i] * H[i, j] + sn[i] * H[i + 1, j]
                H[i + 1, j] = -np.conj(sn[i]) * H[i, j] + cs[i] * H[i + 1, j]
                H[i, j] = t
            # new rotation (LAPACK lartg convention: c real,
            # s = c*conj(b/a))
            denom = np.sqrt(abs(H[j, j]) ** 2 + abs(H[j + 1, j]) ** 2)
            if denom == 0:
                cs[j], sn[j] = 1.0, 0.0
            elif abs(H[j, j]) == 0:
                cs[j], sn[j] = 0.0, 1.0
            else:
                cs[j] = abs(H[j, j]) / denom
                sn[j] = cs[j] * np.conj(H[j + 1, j] / H[j, j])
            t = cs[j] * g[j]
            g[j + 1] = -np.conj(sn[j]) * g[j]
            g[j] = t
            H[j, j] = cs[j] * H[j, j] + sn[j] * H[j + 1, j]
            H[j + 1, j] = 0.0
            j_done = j + 1
            total_it += 1
            res_est = abs(g[j + 1]) / bnorm
            if verbosity:
                print(f"GMRES it {total_it}: residual estimate {res_est:.3e}")
            if res_est < tol or breakdown:
                # happy breakdown: the exact solution lies in the current
                # space; never orthogonalize against a zero basis vector
                break
        # solve the small triangular system and update
        y = np.zeros(j_done, dtype=dtype)
        for i in range(j_done - 1, -1, -1):
            y[i] = (g[i] - H[i, i + 1:j_done] @ y[i + 1:]) / H[i, i]
        x = x + np.asarray(Mi(V[:j_done].T @ y))
        # breakdown without convergence: restart from the updated x with a
        # fresh residual; every inner pass advances total_it
    r = b - np.asarray(A(x))
    res = _norm(r) / bnorm
    return x, {"niter": total_it, "residual": res, "converged": res < tol}


def cg(A, b, x0=None, M=None, tol=1e-6, max_it=100, verbosity=0):
    """Preconditioned conjugate gradient (SPD operators), host recurrences."""
    b = np.asarray(b)
    n = len(b)
    dtype = b.dtype
    x = np.zeros(n, dtype=dtype) if x0 is None else np.asarray(x0).astype(dtype)
    Mi = (lambda v: v) if M is None else M
    bnorm = _norm(b)
    if bnorm == 0:
        return np.zeros(n, dtype=dtype), {"niter": 0, "residual": 0.0,
                                          "converged": True}
    r = b - np.asarray(A(x))
    z = np.asarray(Mi(r))
    p = z.copy()
    rz = np.vdot(r, z)
    it = 0
    while it < max_it:
        if _norm(r) / bnorm < tol:
            break
        Ap = np.asarray(A(p))
        alpha = rz / np.vdot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = np.asarray(Mi(r))
        rz_new = np.vdot(r, z)
        p = z + (rz_new / rz) * p
        rz = rz_new
        it += 1
        if verbosity:
            print(f"CG it {it}: residual {_norm(r) / bnorm:.3e}")
    res = _norm(b - np.asarray(A(x))) / bnorm
    return x, {"niter": it, "residual": res, "converged": res < tol}
