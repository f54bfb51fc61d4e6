"""Batched partial-pivot Adaptive Cross Approximation and SVD re-truncation.

Counterpart of htool_python_tpu/ops/aca.py.  One chunk of equally-padded
admissible blocks is compressed by a loop over the candidate rank in which
all blocks advance in lockstep; per-block convergence is handled by
masking.  The reference's `lax.while_loop` becomes a Python loop over
batched tensors.  Its batch-wide early exit (every block stopped) is
tested every `_STOP_CHECK_EVERY` iterations only, because the test is a
host synchronization; the extra iterations of a stopped block change
nothing (its cross is rejected and its pivot row is already marked used),
so the results equal the reference's.

Entry evaluation goes through a device generator (KernelGenerator /
MatrixGenerator): rows and columns are produced on the fly, so an
admissible block costs O(rank * (m + n)) kernel evaluations, never O(m*n).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import get_config

_STOP_CHECK_EVERY = 4


def _pow2_ceil(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _pow2_floor(n: int) -> int:
    return _pow2_ceil(n + 1) // 2 if n >= 1 else 1


def _chunk_cap(per_block_elems: int, itemsize: int = 4) -> int:
    """Largest power-of-two batch size keeping one chunk's dominant operand
    under the configured assembly memory budget.  The budget is calibrated
    in f32 elements; wider dtypes get proportionally smaller chunks so the
    BYTE footprint stays bounded."""
    budget = (get_config().assembly_chunk_elems * 4) // max(int(itemsize), 4)
    return max(8, _pow2_floor(budget // max(per_block_elems, 1)))


def _ladder_size(nb: int, cap: int) -> int:
    """Smallest size from the 4x ladder {cap, cap/4, cap/16, ..., >=8}
    that is >= nb (the reference's chunk-size ladder)."""
    s = cap
    while s // 4 >= max(nb, 8):
        s //= 4
    return s


def _chunk_slices(nb: int, cap: int):
    """Yield (start, stop, padded_size) covering [0, nb) in chunks of at
    most `cap` blocks.  `padded_size` is the reference's ladder size, which
    bounds its compiled-program count; eager torch has no compiled
    programs, so the port runs each chunk at its real size stop - start."""
    if nb <= cap:
        yield 0, nb, _ladder_size(nb, cap)
        return
    for i0 in range(0, nb, cap):
        yield i0, min(i0 + cap, nb), cap


def real_dtype(dtype: torch.dtype) -> torch.dtype:
    return {torch.complex64: torch.float32,
            torch.complex128: torch.float64}.get(dtype, dtype)


_WIDER = {torch.float32: torch.float64, torch.complex64: torch.complex128}


def svd(a):
    """torch.linalg.svd(a, full_matrices=False), computed in double
    precision for single-precision input and returned in a's precision.
    cuSOLVER's batched single-precision SVD reconstructs its input far
    less accurately than the precision's round-off (chip_smoke.py phase
    `device`, `svd_check`), which would put a floor above eps = 1e-6 under
    every complex64 assembly; the matrices it gets here are small (a
    block's r x r core, or a dense block of at most 64 x 64)."""
    wide = _WIDER.get(a.dtype)
    if wide is None:
        return torch.linalg.svd(a, full_matrices=False)
    U, s, Vh = torch.linalg.svd(a.to(wide), full_matrices=False)
    return U.to(a.dtype), s.to(real_dtype(a.dtype)), Vh.to(a.dtype)


def batched_aca(gen, t_idx, s_idx, t_sz, s_sz, rmax: int, eps: float,
                reqrank: int, dtype):
    """Compress one bucket of admissible blocks.

    gen       : device generator with device_rows / device_cols
    t_idx     : (nb, pt) user row indices (clamped in pad region)
    s_idx     : (nb, ps) user col indices
    t_sz,s_sz : (nb,) actual block sizes
    rmax      : max rank (<= min(pt, ps))
    eps       : blockwise relative Frobenius tolerance (ignored if reqrank>0)
    reqrank   : fixed-rank mode when > 0

    Index and size arrays may be numpy or tensors; they are moved to the
    generator's device.  Returns (U (nb,pt,rmax), V (nb,rmax,ps),
    ranks (nb,), ok (nb,)) on that device, with columns >= rank zeroed.
    ok=False => ACA did not converge (the caller densifies those blocks).
    """
    dev = gen.device
    t_idx = torch.as_tensor(np.asarray(t_idx), dtype=torch.int64, device=dev)
    s_idx = torch.as_tensor(np.asarray(s_idx), dtype=torch.int64, device=dev)
    t_sz = torch.as_tensor(np.asarray(t_sz), dtype=torch.int64, device=dev)
    s_sz = torch.as_tensor(np.asarray(s_sz), dtype=torch.int64, device=dev)
    nb, pt = t_idx.shape
    ps = s_idx.shape[1]
    # ACA state per block ~ pt*rmax + rmax*ps (+ generator row/col evals)
    cap = _chunk_cap((pt + ps) * (int(rmax) + 16) * 2, dtype.itemsize)
    outs = [aca_chunk(gen, int(rmax), float(eps), int(reqrank), dtype,
                      t_idx[i0:i1], s_idx[i0:i1], t_sz[i0:i1], s_sz[i0:i1])
            for i0, i1, _ in _chunk_slices(nb, cap)]
    if len(outs) == 1:
        return outs[0]
    return tuple(torch.cat([o[i] for o in outs]) for i in range(4))


def aca_chunk(gen, rmax: int, eps: float, reqrank: int, dtype, t_idx, s_idx,
              t_sz, s_sz):
    """The lockstep ACA over one chunk of blocks (device tensors)."""
    dev = t_idx.device
    nb, pt = t_idx.shape
    ps = s_idx.shape[1]
    fixed_rank = reqrank > 0
    target_rank = int(reqrank) if fixed_rank else int(rmax)
    # iteration budget: zero-pivot rows are retried (they consume an
    # iteration but no rank slot), so allow some slack beyond target_rank
    niter = target_rank + min(16, pt)
    rdt = real_dtype(dtype)
    tiny = torch.finfo(rdt).tiny * 1e3

    ar = torch.arange(nb, device=dev)
    row_valid = torch.arange(pt, device=dev)[None, :] < t_sz[:, None]
    col_valid = torch.arange(ps, device=dev)[None, :] < s_sz[:, None]

    U = torch.zeros((nb, pt, rmax), dtype=dtype, device=dev)
    V = torch.zeros((nb, rmax, ps), dtype=dtype, device=dev)
    used = torch.zeros((nb, pt), dtype=torch.bool, device=dev)
    next_i = torch.zeros(nb, dtype=torch.int64, device=dev)
    fro2 = torch.zeros(nb, dtype=rdt, device=dev)
    rank = torch.zeros(nb, dtype=torch.int64, device=dev)
    conv_cnt = torch.zeros(nb, dtype=torch.int64, device=dev)
    stopped = torch.zeros(nb, dtype=torch.bool, device=dev)

    for k in range(niter):
        if k % _STOP_CHECK_EVERY == 0 and bool(stopped.all()):
            break
        i_k = next_i
        # residual row at i_k (the generator may evaluate in another dtype)
        rows = gen.device_rows(t_idx[ar, i_k], s_idx).to(dtype)  # (nb, ps)
        rows = rows - torch.einsum("nr,nrj->nj", U[ar, i_k], V)
        rows = torch.where(col_valid, rows, 0)
        j_k = torch.argmax(torch.where(col_valid, rows.abs(), -1.0), dim=1)
        delta = rows[ar, j_k]
        # zero pivot: this row's residual is (numerically) zero. The row
        # is exhausted, but the BLOCK may not be converged — retry with
        # another unused row instead of declaring convergence.
        zero_piv = delta.abs() <= tiny
        v_k = rows / torch.where(zero_piv, 1.0, delta)[:, None]
        # residual column at j_k
        cols = gen.device_cols(t_idx, s_idx[ar, j_k]).to(dtype)  # (nb, pt)
        cols = cols - torch.einsum("nir,nr->ni", U, V[ar, :, j_k])
        u_k = torch.where(row_valid, cols, 0)

        unorm2 = torch.sum(u_k.abs() ** 2, dim=1)
        vnorm2 = torch.sum(v_k.abs() ** 2, dim=1)
        c = torch.einsum("nir,ni->nr", U.conj(), u_k)
        d = torch.einsum("nrj,nj->nr", V.conj(), v_k)
        fro2_new = fro2 + unorm2 * vnorm2 + 2.0 * torch.real(
            torch.sum(c * d, dim=1))
        fro2_new = torch.clamp(fro2_new, min=0.0)

        accept = ~(stopped | zero_piv)
        if fixed_rank:
            inc_conv = torch.zeros_like(accept)
        else:
            inc_conv = unorm2 * vnorm2 <= (eps * eps) * fro2_new
        # require TWO consecutive sub-eps increments before declaring
        # convergence: a single accidentally-small pivot product must not
        # truncate a block that still carries mass
        conv_cnt = torch.where(
            accept, torch.where(inc_conv, conv_cnt + 1, 0), conv_cnt)
        converged = conv_cnt >= 2

        # write the accepted cross at column `rank` (ranks advance per
        # block): adding into the still-zero column is exact, and a
        # rejected cross adds zeros
        take = (accept & (rank < rmax))[:, None]
        slot = torch.clamp(rank, max=rmax - 1)
        U[ar, :, slot] += u_k * take
        V[ar, slot, :] += v_k * take
        used[ar, i_k] = used[ar, i_k] | accept | zero_piv
        fro2 = torch.where(accept, fro2_new, fro2)
        rank = rank + accept.to(torch.int64)

        # next row pivot: largest |u_k| among unused valid rows (uniform
        # score when retrying after a zero pivot)
        score = torch.where(zero_piv[:, None], 1.0, u_k.abs())
        cand = torch.where(row_valid & ~used, score, -1.0)
        best = torch.argmax(cand, dim=1)
        # no unused rows left => every row's residual visited: block is
        # exactly represented (dead == success)
        dead = ~(torch.amax(cand, dim=1) >= 0)
        rank_full = rank >= target_rank
        stopped = stopped | converged | dead | rank_full
        next_i = torch.where(stopped, i_k, best)

    if fixed_rank:
        ok = torch.ones(nb, dtype=torch.bool, device=dev)
    else:
        # success = converged (two consecutive sub-eps increments), or all
        # rows exhausted (exact), or achieved rank covers the full block;
        # blocks that merely hit the rank cap are NOT ok (caller densifies)
        full = rank >= torch.minimum(t_sz, s_sz)
        no_rows = ~torch.any(row_valid & ~used, dim=1)
        ok = (conv_cnt >= 2) | no_rows | full
    return U, V, rank, ok


def batched_truncate(U, V, ranks, eps: float, reqrank: int = -1):
    """Batched QR+SVD re-truncation of padded low-rank factors (relative
    Frobenius criterion per block).  Returns (U', V', ranks') with trailing
    columns zeroed; chunked over the block axis like the reference."""
    nb, pt, r = U.shape
    ps = V.shape[2]
    if r == 0 or nb == 0:
        return U, V, ranks
    ranks = torch.as_tensor(ranks, device=U.device)
    # peak operand per block ~ QR workspaces + factors: (pt + ps + 4r) * r
    cap = _chunk_cap((pt + ps + 4 * r) * r, U.dtype.itemsize)
    outs = [truncate_chunk(int(reqrank), U[i0:i1], V[i0:i1], ranks[i0:i1],
                           float(eps))
            for i0, i1, _ in _chunk_slices(nb, cap)]
    if len(outs) == 1:
        return outs[0]
    return tuple(torch.cat([o[i] for o in outs]) for i in range(3))


def truncate_chunk(reqrank: int, U, V, ranks, eps: float):
    """QR of both factors, SVD of the small core, per-block truncation."""
    dtype = U.dtype
    Qu, Ru = torch.linalg.qr(U)  # (nb, pt, r'), (nb, r', r)
    Qv, Rv = torch.linalg.qr(V.transpose(1, 2).conj())
    core = torch.einsum("nij,nkj->nik", Ru, Rv.conj())  # Ru @ Rv^H
    W, s, Zh = svd(core)
    # per-block truncation rank: smallest r' with tail energy <= eps^2 * total
    s2 = s * s
    total = torch.sum(s2, dim=1, keepdim=True)
    tail = torch.flip(torch.cumsum(torch.flip(s2, [1]), dim=1), [1])
    pos = torch.arange(s.shape[1], device=U.device)[None, :]
    if reqrank > 0:
        keep = pos < reqrank
    else:
        keep = tail > (eps * eps) * torch.clamp(
            total, min=torch.finfo(s.dtype).tiny)
    new_ranks = torch.sum(keep, dim=1)
    sk = torch.where(keep, s, 0.0).to(dtype)
    Unew = torch.einsum("nik,nkr->nir", Qu, W * sk[:, None, :])
    Vnew = torch.einsum("nrk,njk->nrj", Zh, Qv.conj())
    # zero rows of V beyond rank (U already zeroed via sk)
    Vnew = Vnew * (pos < new_ranks[:, None])[:, :, None].to(dtype)
    return Unew, Vnew, new_ranks
