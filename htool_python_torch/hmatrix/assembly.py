"""H-matrix assembly: fill dense buckets, compress admissible buckets.

Counterpart of htool_python_tpu/hmatrix/assembly.py.  Host-orchestrated
(assembly is a one-shot setup phase with data-dependent re-bucketing),
device-executed where the generator allows it:

  * device generators (KernelGenerator / MatrixGenerator): batched ACA per
    bucket (ops/aca.py) with an rmax escalation ladder + batched QR/SVD
    re-truncation — or batched dense build + SVD for small buckets — and a
    rank-class packing into rank-major factors Ut (nb, r, pt), V (nb, r, ps);
  * host generators (`VirtualGenerator.build_submatrix`): per-block dense
    fill + numpy SVD truncation;
  * custom hooks: `VirtualLowRankGenerator` (per-block user compression,
    False => densify; it turns the device ACA path off, as in the
    reference) and `VirtualDenseBlocksGenerator` (ALL dense leaves in one
    callback).  Their host arrays go into the padded device buckets and
    through the same rank-class packing.

Blocks whose compression fails or is not worthwhile (rank*(m+n) > m*n) are
moved into the dense buckets before the dense fill.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..config import get_config, require_full_f32
from ..ops.aca import (_chunk_cap, _chunk_slices, _ladder_size, aca_chunk,
                       svd, truncate_chunk)
from ..ops.matvec import RankMajorFactors
from .generator import VirtualGenerator
from .plan import BlockPlan, _bucketize

# buckets at most this many padded entries use dense-build + batched SVD
# instead of ACA on the device path (small blocks: SVD is exact and cheap)
_DENSE_SVD_MAX = 64 * 64

# Per-phase wall-time breakdown (seconds) of the LAST assemble() call:
# lr_aca_s (compression), lr_pack_s (rank-class packing), dense_fill_s,
# total_s.  The device is synchronized at each phase end, so the split is
# exact.
ASSEMBLY_PROFILE: dict = {}


def _is_device_generator(gen) -> bool:
    return hasattr(gen, "device_rows") and hasattr(gen, "device_cols")


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _chunk(rows_idx, cols_idx, t_sz, s_sz, i0, i1, device):
    """Device tensors of the slice [i0:i1) of a bucket's index/size arrays."""
    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a[i0:i1]),
                               dtype=torch.int64, device=device)
    return dev(rows_idx), dev(cols_idx), dev(t_sz), dev(s_sz)


def _masked_blocks(gen, dtype, rows_idx, cols_idx, t_sz, s_sz):
    """Batched dense fill of one chunk, zeroed outside the actual sizes."""
    D = gen.device_blocks(rows_idx, cols_idx).to(dtype)
    pt, ps = rows_idx.shape[1], cols_idx.shape[1]
    dev = D.device
    mask = ((torch.arange(pt, device=dev)[None, :, None] < t_sz[:, None, None])
            & (torch.arange(ps, device=dev)[None, None, :] < s_sz[:, None, None]))
    return torch.where(mask, D, 0)


def _dense_svd_lr(gen, dtype, rows_idx, cols_idx, t_sz, s_sz):
    """Small-block low-rank path: dense fill + batched SVD factors."""
    D = _masked_blocks(gen, dtype, rows_idx, cols_idx, t_sz, s_sz)
    U, S, Vh = svd(D)
    return (U * S[:, None, :]).to(dtype), Vh.to(dtype)


def _bucket_user_indices(perm, base, b, side):
    """(nb, width) user indices of a bucket's blocks, clamped in the pad
    region (so device evaluations stay in bounds)."""
    off = b.t_off if side == "t" else b.s_off
    sz = b.t_sz if side == "t" else b.s_sz
    width = b.pt if side == "t" else b.ps
    pos = np.minimum(np.arange(width)[None, :], (sz - 1)[:, None]) + off[:, None]
    return np.asarray(perm[pos + base], dtype=np.int64)


def _host_truncate(mat, eps, reqrank):
    """numpy SVD truncation; returns (U, V) or None if not worthwhile."""
    u, s, vh = np.linalg.svd(mat, full_matrices=False)
    if reqrank > 0:
        r = min(reqrank, len(s))
    else:
        s2 = s * s
        total = s2.sum()
        if total == 0:
            r = 0
        else:
            tail = np.cumsum(s2[::-1])[::-1]
            r = int(np.sum(tail > eps * eps * total))
    m, n = mat.shape
    if r * (m + n) > m * n:
        return None
    return u[:, :r] * s[:r], vh[:r, :]


def _numpy_dtype(dtype: torch.dtype):
    return torch.empty((), dtype=dtype).numpy().dtype


def assemble(plan: BlockPlan, generator, epsilon: float, reqrank: int = -1,
             dtype=None, device=None, low_rank_generator=None,
             dense_blocks_generator=None):
    """Returns (new_plan, dense_arrays, lr_arrays, lr_ranks).

    dense_arrays[i] : (nb, pt, ps) tensor for new_plan.dense_buckets[i]
    lr_arrays[i]    : RankMajorFactors (Ut (nb,r,pt), V (nb,r,ps)) for
                      new_plan.lowrank_buckets[i]
    lr_ranks[i]     : (nb,) int32 numpy actual ranks

    A device generator assembles on its own device; a host generator needs
    `device` for the result tensors.  `low_rank_generator` (a
    VirtualLowRankGenerator) compresses every admissible block on the host
    instead of ACA; `dense_blocks_generator` (a
    VirtualDenseBlocksGenerator) fills every dense leaf in one call.
    """
    require_full_f32()
    cfg = get_config()
    if dtype is None:
        dtype = cfg.default_dtype(getattr(generator, "is_complex", False))
    if _is_device_generator(generator):
        if device is not None and torch.device(device) != generator.device:
            raise ValueError(f"generator lives on {generator.device}, "
                             f"assembly asked for {device}")
        device = generator.device
    elif device is None:
        raise ValueError("a host generator needs an explicit device")
    device = torch.device(device)
    # a custom low-rank hook turns the device ACA path off (the reference's
    # rule, htool_python_tpu/hmatrix/assembly.py:161)
    use_device = (_is_device_generator(generator)
                  and low_rank_generator is None)

    perm_t = plan.target_root.get_permutation()
    perm_s = plan.source_root.get_permutation()
    if isinstance(generator, VirtualGenerator):
        if generator.target_permutation is not None:
            perm_t = generator.target_permutation
        if generator.source_permutation is not None:
            perm_s = generator.source_permutation
    # symmetric block-row plans store t_off in absolute coordinates
    t_base = 0 if plan.t_off_absolute else plan.target_offset
    s_base = plan.source_offset

    kept_lr_buckets, lr_arrays, lr_ranks = [], [], []
    densify_blocks: list[tuple] = []

    ASSEMBLY_PROFILE.clear()
    t_all0 = time.perf_counter()
    ASSEMBLY_PROFILE["lr_aca_s"] = 0.0
    ASSEMBLY_PROFILE["lr_pack_s"] = 0.0
    for b in plan.lowrank_buckets:
        if use_device:
            rows_idx = _bucket_user_indices(perm_t, t_base, b, "t")
            cols_idx = _bucket_user_indices(perm_s, s_base, b, "s")
            t0 = time.perf_counter()
            chunks, ranks, ok, order, drop = _device_lr_bucket(
                generator, b, rows_idx, cols_idx, epsilon, reqrank, dtype,
                cfg)
            ASSEMBLY_PROFILE["lr_aca_s"] += time.perf_counter() - t0
            t0 = time.perf_counter()
            # device rows may be re-ordered (and duplicated by the rmax
            # escalation ladder) — align the bucket's host arrays with them
            b = _subset_bucket(b, order)
            worth = ranks * (b.t_sz + b.s_sz) <= b.t_sz * b.s_sz
            keep = ok & worth & ~drop
            for i in np.flatnonzero(~keep & ~drop):
                densify_blocks.append((b.t_off[i], b.t_sz[i], b.s_off[i],
                                       b.s_sz[i], b.mirror[i]))
            if keep.any():
                kept_idx = np.flatnonzero(keep)
                kept_ranks = ranks[kept_idx]
                class_list = list(_rank_classes(kept_ranks))
                # chunk-local selections (chunks cover the row range in
                # ascending, disjoint slices)
                bounds = np.cumsum([0] + [c[0].shape[0] for c in chunks])
                class_sels = []
                for _, sk in class_list:
                    gsel = kept_idx[sk]
                    class_sels.append([
                        torch.as_tensor(
                            gsel[(gsel >= bounds[ci]) & (gsel < bounds[ci + 1])]
                            - bounds[ci], dtype=torch.int64, device=device)
                        for ci in range(len(chunks))])
                outs = _pack_classes([rc for rc, _ in class_list],
                                     [c[0] for c in chunks],
                                     [c[1] for c in chunks], class_sels)
                for (rclass, sk), (Ut_c, V_c) in zip(class_list, outs):
                    kept_lr_buckets.append(_subset_bucket(b, kept_idx[sk]))
                    lr_arrays.append(RankMajorFactors(Ut_c, V_c))
                    lr_ranks.append(kept_ranks[sk].astype(np.int32))
            _sync(device)
            ASSEMBLY_PROFILE["lr_pack_s"] += time.perf_counter() - t0
            continue

        t0 = time.perf_counter()
        if low_rank_generator is not None:
            U, V, ranks, ok = _custom_lr_bucket(
                low_rank_generator, b,
                _bucket_user_indices(perm_t, t_base, b, "t"),
                _bucket_user_indices(perm_s, s_base, b, "s"), epsilon,
                _numpy_dtype(dtype))
        else:
            U, V, ranks, ok = _host_lr_bucket(
                generator, b, perm_t, perm_s, t_base, s_base, epsilon,
                reqrank, _numpy_dtype(dtype))
        ASSEMBLY_PROFILE["lr_aca_s"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        worth = ranks * (b.t_sz + b.s_sz) <= b.t_sz * b.s_sz
        keep = ok & worth
        for i in np.flatnonzero(~keep):
            densify_blocks.append((b.t_off[i], b.t_sz[i], b.s_off[i],
                                   b.s_sz[i], b.mirror[i]))
        if keep.any():
            sel = np.flatnonzero(keep)
            b, U, V, ranks = _subset_bucket(b, sel), U[sel], V[sel], ranks[sel]
            # sub-bucket by rank class: the product streams the PADDED
            # factor arrays, so rank ~20 blocks in a rank-128 bucket would
            # waste ~6x the bytes on zero columns
            for rclass, sel in _rank_classes(ranks):
                kept_lr_buckets.append(_subset_bucket(b, sel))
                lr_arrays.append(RankMajorFactors(
                    torch.as_tensor(U[sel][:, :, :rclass].transpose(0, 2, 1).copy(),
                                    device=device),
                    torch.as_tensor(V[sel][:, :rclass, :].copy(), device=device)))
                lr_ranks.append(ranks[sel].astype(np.int32))
        ASSEMBLY_PROFILE["lr_pack_s"] += time.perf_counter() - t0

    # --- dense buckets (original + densified) ---
    dense_tuples = []
    for b in plan.dense_buckets:
        for i in range(b.nb):
            dense_tuples.append((b.t_off[i], b.t_sz[i], b.s_off[i],
                                 b.s_sz[i], b.mirror[i]))
    dense_tuples.extend(densify_blocks)
    dense_buckets = _bucketize(dense_tuples)

    t_dense0 = time.perf_counter()
    dense_arrays = []
    if dense_blocks_generator is not None:
        dense_arrays = _custom_dense_buckets(
            dense_blocks_generator, dense_buckets, perm_t, perm_s, t_base,
            s_base, _numpy_dtype(dtype), device)
    elif use_device:
        for b in dense_buckets:
            rows_idx = _bucket_user_indices(perm_t, t_base, b, "t")
            cols_idx = _bucket_user_indices(perm_s, s_base, b, "s")
            cap = _chunk_cap(b.pt * b.ps * 6, dtype.itemsize)
            Ds = [_masked_blocks(generator, dtype,
                                 *_chunk(rows_idx, cols_idx, b.t_sz, b.s_sz,
                                         i0, i1, device))
                  for i0, i1, _ in _chunk_slices(b.nb, cap)]
            dense_arrays.append(Ds[0] if len(Ds) == 1 else torch.cat(Ds))
    else:
        np_dtype = _numpy_dtype(dtype)
        for b in dense_buckets:
            D = np.zeros((b.nb, b.pt, b.ps), dtype=np_dtype)
            for i in range(b.nb):
                r0 = t_base + b.t_off[i]
                c0 = s_base + b.s_off[i]
                mat = np.zeros((b.t_sz[i], b.s_sz[i]), dtype=np_dtype,
                               order="F")
                generator.build_submatrix(perm_t[r0:r0 + b.t_sz[i]],
                                          perm_s[c0:c0 + b.s_sz[i]], mat)
                D[i, :b.t_sz[i], :b.s_sz[i]] = mat
            dense_arrays.append(torch.as_tensor(D, device=device))
    _sync(device)
    ASSEMBLY_PROFILE["dense_fill_s"] = time.perf_counter() - t_dense0
    ASSEMBLY_PROFILE["total_s"] = time.perf_counter() - t_all0

    new_plan = dataclasses.replace(plan, dense_buckets=dense_buckets,
                                   lowrank_buckets=kept_lr_buckets)
    return new_plan, dense_arrays, lr_arrays, lr_ranks


def _rank_classes(ranks):
    """Partition block indices by rank class (multiples of 16 above 8,
    class 8 for tiny ranks): yields (rank_class, index array), ascending.
    The reference's classes, kept so buckets match it."""
    ranks = np.asarray(ranks)
    r = np.maximum(ranks, 1)
    classes = np.where(r <= 8, 8, ((r + 15) // 16) * 16)
    for rc in np.unique(classes):
        yield int(rc), np.flatnonzero(classes == rc)


def _subset_bucket(b, sel):
    return dataclasses.replace(
        b, t_off=b.t_off[sel], s_off=b.s_off[sel],
        t_sz=b.t_sz[sel], s_sz=b.s_sz[sel], mirror=b.mirror[sel])


def _host_lr_bucket(gen, b, perm_t, perm_s, t_base, s_base, epsilon,
                    reqrank, np_dtype):
    """Host generator: dense fill + numpy SVD truncation per block."""
    rmax = 1
    Us, Vs = [], []
    ranks = np.zeros(b.nb, np.int32)
    ok = np.zeros(b.nb, bool)
    for i in range(b.nb):
        r0, c0 = t_base + b.t_off[i], s_base + b.s_off[i]
        rows = perm_t[r0:r0 + b.t_sz[i]]
        cols = perm_s[c0:c0 + b.s_sz[i]]
        mat = np.zeros((b.t_sz[i], b.s_sz[i]), dtype=np_dtype, order="F")
        gen.build_submatrix(rows, cols, mat)
        uv = _host_truncate(mat, epsilon, reqrank)
        if uv is None:
            Us.append(None)
            Vs.append(None)
            continue
        U, V = uv
        Us.append(U)
        Vs.append(V)
        ranks[i] = U.shape[1]
        ok[i] = True
        rmax = max(rmax, U.shape[1])
    Uarr = np.zeros((b.nb, b.pt, rmax), dtype=np_dtype)
    Varr = np.zeros((b.nb, rmax, b.ps), dtype=np_dtype)
    for i in range(b.nb):
        if ok[i]:
            Uarr[i, :b.t_sz[i], :ranks[i]] = Us[i]
            Varr[i, :ranks[i], :b.s_sz[i]] = Vs[i]
    return Uarr, Varr, ranks, ok


def _custom_lr_bucket(lrg, b, rows_idx, cols_idx, epsilon, np_dtype):
    """User VirtualLowRankGenerator: one call per block with its user rows
    and columns; False => densify.  Returns (U (nb, pt, rmax), V (nb, rmax,
    ps), ranks, ok) as `_host_lr_bucket` does."""
    rmax = 1
    Us, Vs = [], []
    ranks = np.zeros(b.nb, np.int32)
    ok = np.zeros(b.nb, bool)
    for i in range(b.nb):
        rows = rows_idx[i, :b.t_sz[i]]
        cols = cols_idx[i, :b.s_sz[i]]
        if lrg.build_low_rank_approximation(rows, cols, epsilon):
            U, V = lrg.take_uv()
            Us.append(U)
            Vs.append(V)
            ranks[i] = U.shape[1]
            ok[i] = True
            rmax = max(rmax, U.shape[1])
        else:
            Us.append(None)
            Vs.append(None)
    Uarr = np.zeros((b.nb, b.pt, rmax), dtype=np_dtype)
    Varr = np.zeros((b.nb, rmax, b.ps), dtype=np_dtype)
    for i in np.flatnonzero(ok):
        Uarr[i, :b.t_sz[i], :ranks[i]] = Us[i]
        Varr[i, :ranks[i], :b.s_sz[i]] = Vs[i]
    return Uarr, Varr, ranks, ok


def _custom_dense_buckets(dbg, dense_buckets, perm_t, perm_s, t_base, s_base,
                          np_dtype, device):
    """User VirtualDenseBlocksGenerator: ONE call with every dense leaf
    (user rows, user columns, a zeroed Fortran-ordered block each), then
    each bucket's blocks padded into one device tensor."""
    rows, cols, mats = [], [], []
    for b in dense_buckets:
        for i in range(b.nb):
            r0, c0 = t_base + b.t_off[i], s_base + b.s_off[i]
            rows.append(perm_t[r0:r0 + b.t_sz[i]])
            cols.append(perm_s[c0:c0 + b.s_sz[i]])
            mats.append(np.zeros((b.t_sz[i], b.s_sz[i]), dtype=np_dtype,
                                 order="F"))
    dbg.build_dense_blocks(rows, cols, mats)
    out, it = [], iter(mats)
    for b in dense_buckets:
        D = np.zeros((b.nb, b.pt, b.ps), dtype=np_dtype)
        for i in range(b.nb):
            D[i, :b.t_sz[i], :b.s_sz[i]] = next(it)
        out.append(torch.as_tensor(D, device=device))
    return out


def _bucket_rmax(b, cfg) -> int:
    """ACA candidate-rank cap for a bucket, scaling with block size (the
    escalation ladder means only genuinely high-rank blocks pay for it)."""
    rmax = max(8, int(min(b.pt, b.ps) * cfg.max_rank_ratio))
    hard = 128 if min(b.pt, b.ps) < 1024 else 256
    return min(rmax, b.pt, b.ps, hard)


def _aca_stages(rmax: int) -> list[int]:
    """rmax escalation ladder: a cheap low-rank pass first, escalating only
    the unconverged blocks to the full cap."""
    if rmax > 48:
        return [32, rmax]
    return [rmax]


def _stage2_chunk_size(nb: int, cap: int) -> int:
    """Chunk size for escalation stages (the reference's rule)."""
    return min(cap, _ladder_size(nb, cap))


def _pack_classes(widths, chunk_Us, chunk_Vs, class_sels):
    """Assembly post-pass for one bucket: for every rank class, gather its
    blocks chunk by chunk (trimming / padding each chunk's factor width to
    the class width), concatenate along the block axis, and emit the
    storage layout (rank-major Ut).  Gathering per chunk keeps the
    transient footprint at ~the final compressed size."""
    outs = []
    for w, parts in zip(widths, class_sels):
        ut_parts, v_parts = [], []
        for U, V, loc in zip(chunk_Us, chunk_Vs, parts):
            if loc.shape[0] == 0:
                continue
            cw = U.shape[2]
            Uw, Vw = U[loc], V[loc]
            if cw < w:
                Uw = torch.nn.functional.pad(Uw, (0, w - cw))
                Vw = torch.nn.functional.pad(Vw, (0, 0, 0, w - cw))
            else:
                Uw, Vw = Uw[:, :, :w], Vw[:, :w, :]
            ut_parts.append(Uw.transpose(1, 2))  # (c, w, pt)
            v_parts.append(Vw)
        outs.append((torch.cat(ut_parts).contiguous(),
                     torch.cat(v_parts).contiguous()))
    return outs


def _device_lr_bucket(gen, b, rows_idx, cols_idx, epsilon, reqrank, dtype,
                      cfg):
    """Device generator: batched ACA (or batched dense+SVD for small blocks).

    All device work is chunked over the block axis, and SVD re-truncation
    is fused into each chunk so only *trimmed* factors accumulate.

    Returns (chunks, ranks, ok, order, drop): `chunks` is a list of
    per-chunk factor pairs (U (c, pt, w), V (c, w, ps)); the host arrays
    are aligned with their concatenation.  Rows are ordered by `order`
    (indices into the bucket's original blocks, possibly with DUPLICATES
    from the rmax escalation ladder); rows flagged `drop` are stage-N
    failures superseded by a later stage and must be neither kept nor
    densified."""
    device = gen.device
    # blockwise safety factor: partial ACA's running Frobenius estimate is
    # an underestimate, and SVD re-truncation adds its own eps-level error;
    # half-tolerance on both keeps the operator-level contract with margin
    eps_half = 0.5 * float(epsilon)
    chunks = []
    order_parts: list[np.ndarray] = []
    drop_parts: list[np.ndarray] = []
    if b.pt * b.ps <= _DENSE_SVD_MAX:
        # batched SVD expands its operand ~an order of magnitude in
        # workspace — budget with a large fudge
        cap = _chunk_cap(b.pt * b.ps * 32, dtype.itemsize)
        for i0, i1, _ in _chunk_slices(b.nb, cap):
            ri, ci, tz, sz = _chunk(rows_idx, cols_idx, b.t_sz, b.s_sz,
                                    i0, i1, device)
            Uc, Vc = _dense_svd_lr(gen, dtype, ri, ci, tz, sz)
            r0 = torch.full((i1 - i0,), Uc.shape[2], dtype=torch.int64,
                            device=device)
            Uc, Vc, rc = truncate_chunk(int(reqrank), Uc, Vc, r0, eps_half)
            rc = rc.cpu().numpy()
            w = max(int(rc.max(initial=0)), 1)
            chunks.append((Uc[:, :, :w], Vc[:, :w, :], rc,
                           np.ones(i1 - i0, bool)))
            order_parts.append(np.arange(i0, i1))
            drop_parts.append(np.zeros(i1 - i0, bool))
    else:
        rmax = _bucket_rmax(b, cfg)
        stages = _aca_stages(rmax) if reqrank <= 0 else [rmax]
        remaining = np.arange(b.nb)
        for s_i, srm in enumerate(stages):
            last = s_i == len(stages) - 1
            cap = _chunk_cap((b.pt + b.ps) * (srm + 16) * 2, dtype.itemsize)
            ri_all, ci_all = rows_idx[remaining], cols_idx[remaining]
            tz_all, sz_all = b.t_sz[remaining], b.s_sz[remaining]
            fail_parts: list[np.ndarray] = []
            n_rem = len(remaining)
            s2 = _stage2_chunk_size(n_rem, cap) if s_i > 0 else None
            slices = ([(i0, min(i0 + s2, n_rem), s2)
                       for i0 in range(0, n_rem, s2)] if s2 is not None
                      else _chunk_slices(n_rem, cap))
            for i0, i1, _ in slices:
                ri, ci, tz, sz = _chunk(ri_all, ci_all, tz_all, sz_all,
                                        i0, i1, device)
                Uc, Vc, rc, okc = aca_chunk(gen, srm, eps_half, int(reqrank),
                                            dtype, ri, ci, tz, sz)
                Uc, Vc, rc2 = truncate_chunk(int(reqrank), Uc, Vc, rc,
                                             eps_half)
                ok_np = okc.cpu().numpy()
                rc_np = rc2.cpu().numpy()
                w = max(int(rc_np.max(initial=0)), 1)
                chunks.append((Uc[:, :, :w], Vc[:, :w, :], rc_np, ok_np))
                order_parts.append(remaining[i0:i1])
                if last:
                    drop_parts.append(np.zeros(i1 - i0, bool))
                else:
                    # unconverged at this stage: superseded by the next
                    # stage's retry — never densified from THIS row
                    drop_parts.append(~ok_np)
                    fail_parts.append(remaining[i0:i1][~ok_np])
            if not last:
                remaining = (np.concatenate(fail_parts) if fail_parts
                             else np.zeros(0, np.int64))
                if len(remaining) == 0:
                    break
    out_chunks = [(U, V) for U, V, _, _ in chunks]
    ranks = np.concatenate([c[2] for c in chunks])
    ok = np.concatenate([c[3] for c in chunks])
    order = np.concatenate(order_parts)
    drop = np.concatenate(drop_parts)
    return out_chunks, ranks, ok, order, drop
