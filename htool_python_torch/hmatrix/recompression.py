"""Post-assembly rank re-truncation.

Counterpart of htool_python_tpu/hmatrix/recompression.py (reference
parity: module-level `recompression(hmatrix[, epsilon, callback])` and
`openmp_recompression`, src/htool/hmatrix/hmatrix.hpp:96-99; both names run
the same batched device code).  Mutates the HMatrix in place, like the
reference; a list or tuple of HMatrix (one per partition) is recompressed
entry by entry.

Three paths, chosen as the reference chooses them:

  * a `callback(U, V, epsilon) -> (U2, V2) | None`, the custom per-leaf
    hook: it receives one leaf's factors in the user-facing layout
    (U (pt, r), V (r, ps), numpy) and returns replacement factors, or None
    to keep the leaf (a host loop: a parity surface, not the hot path);
  * SVD-form factors (`HMatrix._lr_svd_form`, set by every assembly path):
    row i of the rank-major Ut is sigma_i u_i, so the singular values are
    its row norms; the new rank comes from them, and the factors are
    trimmed and re-classed without a factorization;
  * otherwise the streaming path: each bucket goes through the batched
    QR + SVD truncation (ops/aca.py truncate_chunk) in assembly-sized
    chunks, and the results are re-packed into fresh rank classes.

Both batched paths re-class by the new ranks, so the padded bytes that a
product streams shrink with them, and release each bucket's old factors
as soon as its new ones exist (peak device memory: the operator plus one
bucket).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.aca import _chunk_cap, _chunk_slices, truncate_chunk
from ..ops.matvec import RankMajorFactors
from .assembly import _numpy_dtype, _pack_classes, _rank_classes, \
    _subset_bucket


def recompression(hmatrix, epsilon: float | None = None,
                  callback=None) -> None:
    if isinstance(hmatrix, (list, tuple)):  # one HMatrix per partition
        for h in hmatrix:
            recompression(h, epsilon, callback)
        return
    eps = float(epsilon) if epsilon is not None else hmatrix.epsilon
    if callback is not None:
        _recompress_with_callback(hmatrix, eps, callback)
        hmatrix._lr_svd_form = False  # user factors: form unknown
        return
    if hmatrix._lr_svd_form:
        _recompress_svd_form(hmatrix, eps)
        return
    _recompress_streaming(hmatrix, eps)


def openmp_recompression(hmatrix, epsilon: float | None = None,
                         callback=None) -> None:
    recompression(hmatrix, epsilon, callback)


def _recompress_with_callback(hmatrix, eps: float, callback) -> None:
    np_dtype = _numpy_dtype(hmatrix.dtype)
    lr_arrays, lr_ranks = [], []
    for (Ut, V, *_), b, ranks in zip(hmatrix._assembly_data()["lr"],
                                     hmatrix.plan.lowrank_buckets,
                                     hmatrix._lr_ranks):
        Uh = Ut.cpu().numpy().transpose(0, 2, 1)  # (nb, pt, r)
        Vh = V.cpu().numpy()                      # (nb, r, ps)
        new_U, new_V, new_r = [], [], []
        for i in range(Uh.shape[0]):
            r = int(ranks[i])
            res = callback(Uh[i, :b.t_sz[i], :r].copy(),
                           Vh[i, :r, :b.s_sz[i]].copy(), eps)
            if res is None:
                new_U.append(Uh[i])
                new_V.append(Vh[i])
                new_r.append(r)
                continue
            U2, V2 = (np.asarray(a, dtype=np_dtype) for a in res)
            if (U2.shape[0] != b.t_sz[i] or V2.shape[1] != b.s_sz[i]
                    or U2.shape[1] != V2.shape[0]):
                raise ValueError(
                    "recompression callback returned factors of shape "
                    f"{U2.shape} x {V2.shape} for a {b.t_sz[i]}x{b.s_sz[i]} "
                    "leaf")
            r2 = U2.shape[1]
            Up = np.zeros(Uh.shape[1:], dtype=np_dtype)
            Vp = np.zeros(Vh.shape[1:], dtype=np_dtype)
            Up[:U2.shape[0], :r2] = U2
            Vp[:r2, :V2.shape[1]] = V2
            new_U.append(Up)
            new_V.append(Vp)
            new_r.append(r2)
        r_arr = np.asarray(new_r, dtype=np.int32)
        rmax = max(int(r_arr.max()) if len(r_arr) else 1, 1)
        lr_arrays.append((np.stack(new_U)[:, :, :rmax],
                          np.stack(new_V)[:, :rmax, :]))
        lr_ranks.append(r_arr)
    hmatrix._set_lr_arrays(lr_arrays, lr_ranks)


def _svd_form_ranks(Ut, eps: float):
    """Post-truncation ranks of SVD-form factors: the squared row norms of
    the rank-major Ut are the squared singular values (descending; pad
    rows are zero); keep those whose tail energy exceeds eps^2 of the
    total.  One read of Ut."""
    s2 = torch.sum(Ut.abs() ** 2, dim=2)  # (nb, r) real
    total = torch.sum(s2, dim=1, keepdim=True)
    tail = torch.flip(torch.cumsum(torch.flip(s2, [1]), dim=1), [1])
    keep = tail > (eps * eps) * torch.clamp(total,
                                            min=torch.finfo(s2.dtype).tiny)
    return torch.sum(keep, dim=1).to(torch.int32)


def _trim_classes(widths, Ut, V, class_sels, r_new):
    """Gather each rank class's blocks and trim them to the class width (a
    slice of the leading rank axis in the rank-major layout).  Rows in
    [new rank, width) held components that are now truncated, so they are
    zeroed: the product kernels stream padded widths and rely on zero
    padding."""
    outs = []
    for w, sel in zip(widths, class_sels):
        # stored factors may be narrower than their rank class (the host
        # path packs at the bucket's own maximum rank)
        we = min(w, Ut.shape[1])
        mask = (torch.arange(we, device=Ut.device)[None, :, None]
                < r_new[sel][:, None, None]).to(Ut.dtype)
        outs.append(((Ut[sel, :we, :] * mask).contiguous(),
                     (V[sel, :we, :] * mask).contiguous()))
    return outs


def _recompress_svd_form(hmatrix, eps: float) -> None:
    """O(stored bytes) recompression of SVD-form factors: the new ranks
    from the row norms of Ut, then a trim and a re-classing; no
    factorization."""
    data = hmatrix._assembly_data()
    # every bucket's ranks are computed before the first readback
    rank_devs = [_svd_form_ranks(Ut, eps) for Ut, *_ in data["lr"]]
    new_buckets, new_arrays, new_ranks = [], [], []
    for bi, b in enumerate(hmatrix.plan.lowrank_buckets):
        Ut, V = data["lr"][bi][:2]
        r_dev = rank_devs[bi]
        r_new = r_dev.cpu().numpy()
        class_list = list(_rank_classes(r_new))
        sels = [torch.as_tensor(sk, dtype=torch.int64, device=Ut.device)
                for _, sk in class_list]
        outs = _trim_classes([rc for rc, _ in class_list], Ut, V, sels,
                             r_dev.to(torch.int64))
        for (_, sk), (Ut_c, V_c) in zip(class_list, outs):
            new_buckets.append(_subset_bucket(b, sk))
            new_arrays.append(RankMajorFactors(Ut_c, V_c))
            new_ranks.append(r_new[sk].astype(np.int32))
        del Ut, V
        data["lr"][bi] = None  # bound peak memory to one bucket extra
    hmatrix._set_lr_structure(new_buckets, new_arrays, new_ranks)
    hmatrix._lr_svd_form = True  # trimmed SVD pairs are SVD pairs


def _recompress_streaming(hmatrix, eps: float) -> None:
    """Chunked QR + SVD recompression for factors of unknown form: each
    bucket runs through the assembly's batched truncation in chunks of
    bounded workspace, and the results are re-packed into fresh rank
    classes (the assembly's packing post-pass)."""
    data = hmatrix._assembly_data()
    itemsize = hmatrix.dtype.itemsize
    new_buckets, new_arrays, new_ranks = [], [], []
    for bi, (b, ranks) in enumerate(zip(hmatrix.plan.lowrank_buckets,
                                        hmatrix._lr_ranks)):
        Ut, V = data["lr"][bi][:2]
        nb, r, pt = Ut.shape
        ps = V.shape[2]
        # the QR / SVD workspace expands the operand about 8 times
        cap = _chunk_cap((pt + ps) * r * 8, itemsize)
        ranks = torch.as_tensor(np.asarray(ranks), device=Ut.device)
        chunks, rank_parts = [], []
        for i0, i1, _ in _chunk_slices(nb, cap):
            U2, V2, r2 = truncate_chunk(-1, Ut[i0:i1].transpose(1, 2),
                                        V[i0:i1], ranks[i0:i1], eps)
            chunks.append((U2, V2))
            rank_parts.append(r2)
        r_new = (torch.cat(rank_parts).cpu().numpy() if rank_parts
                 else np.asarray(hmatrix._lr_ranks[bi]))
        class_list = list(_rank_classes(r_new))
        bounds = np.cumsum([0] + [c[0].shape[0] for c in chunks])
        class_sels = [[torch.as_tensor(
            sk[(sk >= bounds[ci]) & (sk < bounds[ci + 1])] - bounds[ci],
            dtype=torch.int64, device=Ut.device)
            for ci in range(len(chunks))] for _, sk in class_list]
        outs = _pack_classes([rc for rc, _ in class_list],
                             [c[0] for c in chunks], [c[1] for c in chunks],
                             class_sels)
        for (_, sk), (Ut_c, V_c) in zip(class_list, outs):
            new_buckets.append(_subset_bucket(b, sk))
            new_arrays.append(RankMajorFactors(Ut_c, V_c))
            new_ranks.append(r_new[sk].astype(np.int32))
        del Ut, V, chunks
        data["lr"][bi] = None  # bound peak memory to one bucket extra
    hmatrix._set_lr_structure(new_buckets, new_arrays, new_ranks)
    # the batched truncation leaves SVD pairs: a later recompression of
    # this operator can take the O(stored bytes) path
    hmatrix._lr_svd_form = True
