"""Bucketed H-matrix product: block terms, the plain version of kernels K1
and K2, and the user-numbering entry point.

Counterpart of htool_python_tpu/ops/matvec.py.  The H-matrix is stored as
buckets of equally-padded blocks; a product is, per bucket:

  gather source segments -> one batched GEMM -> scatter-add to target

Low-rank buckets do the two-stage contraction  w = V x_s ; y_t += U w.
Symmetric ('S') / hermitian ('H') storage keeps one triangle only; blocks
flagged `mirror` additionally contribute their (conj-)transpose.

`apply_hmatrix_padded` is the plain PyTorch version of kernels K1 (real
f32) and K2 (complex64) and of their float64 / complex128 siblings, all
in ops/cuda_matvec.py: the CPU path, and what the kernels are held
against on the card.  `index_add_` does the
scatter; on CUDA its summation order is not deterministic, on the CPU it
is.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _gather(x_pad, off, width):
    """x_pad (L, k), off (nb,) -> (nb, width, k)."""
    idx = off.long()[:, None] + torch.arange(width, device=x_pad.device)[None, :]
    return x_pad[idx]


def _scatter_add(y_pad, off, vals):
    """y_pad (L, k) += vals (nb, w, k) at rows off[:,None]+arange(w)."""
    idx = off.long()[:, None] + torch.arange(vals.shape[1],
                                             device=y_pad.device)[None, :]
    y_pad.index_add_(0, idx.reshape(-1), vals.reshape(-1, vals.shape[2]))
    return y_pad


# ----------------------------------------------------------------------
# Per-bucket block-term primitives: the SINGLE definition of how a bucket
# of blocks transforms gathered input segments.  Low-rank storage is
# rank-major: Ut (nb, r, pt), V (nb, r, ps).
# ----------------------------------------------------------------------

def dense_block_term(D, xg, conj=False):
    """Apply dense blocks: D (nb,pt,ps) @ xg (nb,ps,k) -> (nb,pt,k)."""
    Dm = D.conj() if conj else D
    return torch.einsum("nij,njk->nik", Dm, xg)


def dense_block_term_t(D, xg, conj=False):
    """Apply transposed dense blocks: D^(T/H) with xg (nb,pt,k) -> (nb,ps,k).
    conj=True applies the conjugate transpose."""
    Dm = D.conj() if conj else D
    return torch.einsum("nij,nik->njk", Dm, xg)


def lowrank_block_term(Ut, V, xg, conj=False):
    """Apply low-rank blocks B = U V: Ut (nb,r,pt) RANK-MAJOR, V (nb,r,ps),
    xg (nb,ps,k) -> (nb,pt,k) via w = V x; y = U w."""
    Um = Ut.conj() if conj else Ut
    Vm = V.conj() if conj else V
    w = torch.einsum("nrj,njk->nrk", Vm, xg)
    return torch.einsum("nri,nrk->nik", Um, w)


def lowrank_block_term_t(Ut, V, xg, conj=False):
    """Apply transposed low-rank blocks B^(T/H) = V^(T/H) U^(T/H):
    xg (nb,pt,k) -> (nb,ps,k)."""
    Um = Ut.conj() if conj else Ut
    Vm = V.conj() if conj else V
    w = torch.einsum("nri,nik->nrk", Um, xg)
    return torch.einsum("nrj,nrk->njk", Vm, w)


def result_dtype(data, x_dtype) -> torch.dtype:
    dt = x_dtype
    for entry in data["dense"] + data["lr"]:
        dt = torch.promote_types(dt, entry[0].dtype)
    return dt


def apply_hmatrix_padded(data, x_pad, ny_pad: int, trans: str, sym: str):
    """Compute y_pad = H^(trans) @ x_pad over bucketed block data.

    data: dict with
      'dense': list of (D (nb,pt,ps), t_off (nb,), s_off (nb,), mirror (nb,))
      'lr':    list of (Ut (nb,r,pt) RANK-MAJOR, V (nb,r,ps), t_off, s_off,
               mirror)
    x_pad: (ns_pad, k) padded input (zeros in the pad region).
    trans: 'N' | 'T' | 'C'.  sym: 'N' | 'S' | 'H' (how mirrors transform).
    Returns y_pad (ny_pad, k) in the promoted dtype of data and x (a real
    operator applied to a complex x is cast to complex, bucket by bucket).
    """
    dtype = result_dtype(data, x_pad.dtype)
    x_pad = x_pad.to(dtype)
    y = torch.zeros((ny_pad, x_pad.shape[1]), dtype=dtype, device=x_pad.device)
    conj_main = trans == "C"
    # mirror blocks transform by sigma = T ('S') / H ('H'); composing with
    # the product's own trans gives one conjugation flag
    conj_mirror = (sym == "H") != (trans == "C")

    for D, t_off, s_off, mirror in data["dense"]:
        D = D.to(dtype)
        pt, ps = D.shape[1], D.shape[2]
        m = mirror.to(dtype)[:, None, None]
        if trans == "N":
            _scatter_add(y, t_off,
                         dense_block_term(D, _gather(x_pad, s_off, ps)))
            # mirror: sigma(D) at (s,t)
            _scatter_add(y, s_off,
                         dense_block_term_t(D, _gather(x_pad, t_off, pt),
                                            conj=(sym == "H")) * m)
        else:
            _scatter_add(y, s_off,
                         dense_block_term_t(D, _gather(x_pad, t_off, pt),
                                            conj=conj_main))
            _scatter_add(y, t_off,
                         dense_block_term(D, _gather(x_pad, s_off, ps),
                                          conj=conj_mirror) * m)

    for Ut, V, t_off, s_off, mirror in data["lr"]:
        Ut, V = Ut.to(dtype), V.to(dtype)
        pt, ps = Ut.shape[2], V.shape[2]
        m = mirror.to(dtype)[:, None, None]
        if trans == "N":
            _scatter_add(y, t_off,
                         lowrank_block_term(Ut, V, _gather(x_pad, s_off, ps)))
            # mirror: sigma(UV) at (s,t)
            _scatter_add(y, s_off,
                         lowrank_block_term_t(Ut, V, _gather(x_pad, t_off, pt),
                                              conj=(sym == "H")) * m)
        else:
            _scatter_add(y, s_off,
                         lowrank_block_term_t(Ut, V, _gather(x_pad, t_off, pt),
                                              conj=conj_main))
            _scatter_add(y, t_off,
                         lowrank_block_term(Ut, V, _gather(x_pad, s_off, ps),
                                            conj=conj_mirror) * m)
    return y


# Rows of one work item at most: rank rows of a low-rank block, rows of a
# dense one (8 x kRowsPerWarp in csrc/hmatrix_product.cu: the kernels keep
# an item's w = V x, (rows, k), in registers and shared memory, and a
# complex row's accumulators take twice a real one's registers).
WORK_ROWS = 64
WORK_ROWS_COMPLEX = 32


@dataclasses.dataclass
class WorkList:
    """The work list of kernels K1 and K2 over bucket data (`work_list`).

    Each item is (bucket row, block, lo, hi): rows [lo, hi) of one block,
    rank rows of a low-rank block (U V is the sum of its rank slices) or
    rows of a dense one, at most WORK_ROWS of them (WORK_ROWS_COMPLEX for
    complex data).  Bucket rows number the
    non-empty buckets as the kernels' table does: dense buckets, then
    low-rank ones.  `items` is ordered largest first (by stored bytes),
    `by_bucket` in bucket order, `ranges[b]` is
    bucket row b's (first item, count) in `by_bucket`, and `nbytes[i]` the
    stored bytes of items[i].  Every stored entry belongs to exactly one
    item.  Items of equal size, and the items of one bucket, come in a
    fixed shuffled order, so that items running at the same time seldom
    add into the same rows of y."""

    items: np.ndarray  # (n, 4) int32
    by_bucket: np.ndarray  # (n, 4) int32
    ranges: np.ndarray  # (n_buckets, 2) int64
    nbytes: np.ndarray  # (n,) int64


def _check_runs(named):
    """Each (name, stored tensor) is contiguous and starts on 16 bytes, and
    each of its rows (D's ps, Ut's pt, V's ps values) is a whole number of
    16 bytes: every block, and every row the kernel copies, is then one
    16-byte aligned run."""
    for name, t in named:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} {tuple(t.shape)} is not a contiguous "
                             "run starting on 16 bytes")
        if t.shape[2] * t.element_size() % 16:
            raise ValueError(f"{name} rows of {t.shape[2]} values are not "
                             "whole 16-byte runs")


def work_list(data) -> WorkList:
    """The work list of kernels K1 and K2 over `data` (see WorkList); raises
    ValueError unless every factor run is contiguous and 16-byte aligned
    (`_check_runs`).  Host only: shapes and data pointers, no device
    read."""
    parts = []  # (bucket row, block, lo, hi, bytes) arrays per bucket
    row = 0
    for kind in ("dense", "lr"):
        for entry in data[kind]:
            if kind == "dense":
                D = entry[0]
                _check_runs([("D", D)])
                nb, rows, per_row = D.shape[0], D.shape[1], D.shape[2]
                itemsize = D.element_size()
            else:
                Ut, V = entry[0], entry[1]
                _check_runs([("Ut", Ut), ("V", V)])
                nb, rows = Ut.shape[0], Ut.shape[1]
                per_row = Ut.shape[2] + V.shape[2]
                itemsize = Ut.element_size()
            if nb == 0:
                continue
            step = WORK_ROWS_COMPLEX if entry[0].is_complex() else WORK_ROWS
            lo = np.arange(0, rows, step)
            hi = np.minimum(lo + step, rows)
            blocks = np.repeat(np.arange(nb), len(lo))
            part = np.empty((len(blocks), 5), dtype=np.int64)
            part[:, 0] = row
            part[:, 1] = blocks
            part[:, 2] = np.tile(lo, nb)
            part[:, 3] = np.tile(hi, nb)
            part[:, 4] = (part[:, 3] - part[:, 2]) * per_row * itemsize
            parts.append(part)
            row += 1
    allp = (np.concatenate(parts) if parts
            else np.zeros((0, 5), dtype=np.int64))
    counts = np.bincount(allp[:, 0], minlength=row)
    ranges = np.stack([np.cumsum(counts) - counts, counts], 1)
    # ties in a fixed shuffled order: a plan lists the blocks of one block
    # row together, and items that run at the same time and add into the
    # same rows of y would queue on the same atomic addresses
    spread = np.random.RandomState(0).permutation(len(allp))
    order = np.lexsort((spread, -allp[:, 4]))
    by_bucket = np.lexsort((spread, allp[:, 0]))
    return WorkList(
        items=np.ascontiguousarray(allp[order, :4], dtype=np.int32),
        by_bucket=np.ascontiguousarray(allp[by_bucket, :4], dtype=np.int32),
        ranges=np.ascontiguousarray(ranges, dtype=np.int64),
        nbytes=allp[order, 4])


def conj_flags(trans: str, sym: str):
    """(conjugate the x[s:] -> y[t:] direction, conjugate the x[t:] ->
    y[s:] one) of a complex product: 'N' runs a block's main term forward
    and its mirror backward, 'T' / 'C' the other way round; the main term
    is conjugated for 'C', the mirror for (sym == 'H') != (trans == 'C')
    (`apply_hmatrix_padded`'s conj_main, conj_mirror).  The kernels take
    them as launch arguments."""
    conj_main = trans == "C"
    conj_mirror = (sym == "H") != (trans == "C")
    if trans == "N":
        return False, conj_mirror
    return conj_mirror, conj_main


def apply_work_list(data, wl: WorkList, x_pad, ny_pad: int, trans: str,
                    sym: str):
    """The plain walk of the kernels' work list: y_pad = H^(trans) x_pad
    computed item by item, each item's rows as the kernels split them
    (items with the same bucket and rows run as one batch), each direction
    of a block conjugated as `conj_flags` says (complex data; for real data
    'C' is 'T' and 'H' is 'S').  The same result as `apply_hmatrix_padded`,
    which stays the kernels' plain version.  CPU tests use it to check the
    decomposition."""
    buckets = list(data["dense"]) + list(data["lr"])
    buckets = [e for e in buckets if e[0].shape[0]]
    dtype = result_dtype(data, x_pad.dtype)
    conj_fwd, conj_tr = conj_flags(trans, sym)
    x = x_pad.to(dtype)
    y = torch.zeros((ny_pad, x.shape[1]), dtype=dtype, device=x.device)
    n_dense = sum(1 for e in data["dense"] if e[0].shape[0])
    items = torch.as_tensor(wl.items, dtype=torch.long)
    groups, inverse = torch.unique(items[:, [0, 2, 3]], dim=0,
                                   return_inverse=True)
    for gi, (b, lo, hi) in enumerate(groups.tolist()):
        blk = items[inverse == gi, 1].to(x.device)
        entry = buckets[b]
        t_off, s_off, mirror = (e[blk] for e in entry[-3:])
        mirrored = mirror.to(dtype)[:, None, None]
        fwd = torch.ones_like(mirrored) if trans == "N" else mirrored
        tr = mirrored if trans == "N" else torch.ones_like(mirrored)
        if b < n_dense:
            Dr = entry[0][blk, lo:hi].to(dtype)  # (nb, R, ps)
            ps = Dr.shape[2]
            _scatter_add(y, t_off + lo, dense_block_term(
                Dr, _gather(x, s_off, ps), conj_fwd) * fwd)
            _scatter_add(y, s_off, dense_block_term_t(
                Dr, _gather(x, t_off + lo, hi - lo), conj_tr) * tr)
        else:
            Ut = entry[0][blk, lo:hi].to(dtype)
            V = entry[1][blk, lo:hi].to(dtype)
            _scatter_add(y, t_off, lowrank_block_term(
                Ut, V, _gather(x, s_off, V.shape[2]), conj_fwd) * fwd)
            _scatter_add(y, s_off, lowrank_block_term_t(
                Ut, V, _gather(x, t_off, Ut.shape[2]), conj_tr) * tr)
    return y


def permute_in(x2d, perm_in, pad_len: int, dtype):
    """x_pad (pad_len, k) of `dtype` with x_pad[i] = x2d[perm_in[i]] for i
    below x2d's rows and zero rows after them: the plain version of the
    permute-in kernel (csrc/hmatrix_product.cu `hm_permute_in`, which also
    zeroes the product's y; the plain product zeroes its own)."""
    x_pad = torch.zeros((pad_len, x2d.shape[1]), dtype=dtype,
                        device=x2d.device)
    x_pad[:x2d.shape[0]] = x2d[perm_in]
    return x_pad


def permute_out(y_pad, inv_perm_out, nout: int):
    """y_pad's first nout rows in user numbering, out[j] =
    y_pad[inv_perm_out[j]]: the plain version of the permute-out kernel
    (`hm_permute_out`)."""
    return y_pad[:nout][inv_perm_out]


def apply_hmatrix_user(data, perm_in, inv_perm_out, x2d, pad_len: int,
                       trans: str, sym: str, nout: int, table=None):
    """End-to-end product in user numbering: permute in -> pad -> bucketed
    product (the wrapper of kernels K1 and K2, with the data's BucketTable
    `table`) -> un-permute.  perm_in / inv_perm_out are permutations, as
    integer tensors on x2d's device (int32 on CUDA).  On a CUDA tensor
    the two permutations are kernels too (ops/cuda_matvec.py
    `apply_hmatrix_user_cuda`); on the CPU `permute_in` and `permute_out`,
    their plain versions, run around the plain product."""
    from .cuda_matvec import apply_hmatrix_cuda, apply_hmatrix_user_cuda

    if x2d.device.type == "cuda":
        return apply_hmatrix_user_cuda(data, perm_in, inv_perm_out, x2d,
                                       pad_len, trans, sym, nout, table)
    x_pad = permute_in(x2d, perm_in, pad_len, result_dtype(data, x2d.dtype))
    y_pad = apply_hmatrix_cuda(data, x_pad, pad_len, trans, sym, table)
    return permute_out(y_pad, inv_perm_out, nout)


class RankMajorFactors(tuple):
    """Marker for low-rank factors already in storage layout
    (Ut (nb, r, pt), V (nb, r, ps)), as the assembly packs them."""

    __slots__ = ()

    def __new__(cls, Ut, V):
        return tuple.__new__(cls, (Ut, V))


def pack_bucket_data(dense_buckets, dense_arrays, lr_buckets, lr_arrays,
                     device):
    """Build the data dict consumed by the products from plan buckets (host
    numpy offsets) and device data tensors.

    Accepts low-rank factors as (U (nb, pt, r), V (nb, r, ps)) or as
    RankMajorFactors already transposed, and stores Ut (nb, r, pt): the
    kernel reads one rank row of Ut or V with neighbouring threads on
    neighbouring addresses.  Offsets are int32, mirror flags bool, all
    contiguous on `device`."""
    def meta(b):
        return (torch.as_tensor(b.t_off, dtype=torch.int32, device=device),
                torch.as_tensor(b.s_off, dtype=torch.int32, device=device),
                torch.as_tensor(b.mirror, dtype=torch.bool, device=device))

    dense = [(torch.as_tensor(D, device=device).contiguous(), *meta(b))
             for b, D in zip(dense_buckets, dense_arrays)]
    lr = []
    for b, pair in zip(lr_buckets, lr_arrays):
        if isinstance(pair, RankMajorFactors):
            Ut, V = pair
            Ut = torch.as_tensor(Ut, device=device)
        else:
            U, V = pair
            Ut = torch.as_tensor(U, device=device).transpose(1, 2)
        lr.append((Ut.contiguous(),
                   torch.as_tensor(V, device=device).contiguous(), *meta(b)))
    return {"dense": dense, "lr": lr}


# lane of the aligned low-rank layout K1-al reads: 8 f32 values, 32 bytes,
# one DRAM sector (two float4).  The reference's 128 is the TPU's lane
# count; at leaf-64 plans it would quadruple a 64-wide factor's bytes,
# where 8 adds 12.5 %.
ALIGN_LANE = 8


def is_aligned(data) -> bool:
    """True for bucket data in the aligned low-rank layout
    (`align_lowrank`)."""
    return bool(data.get("aligned"))


def _align_win(w: int, lane: int) -> int:
    """Aligned window covering w values shifted by less than one lane."""
    return -(-(w + lane) // lane) * lane


def align_lowrank(data, lane: int = ALIGN_LANE):
    """The aligned low-rank layout (reference ops/matvec.py:187-216 with
    its 128 lanes as `lane`): each low-rank block's Ut is shifted along its
    pt axis by t_off % lane and V along its ps axis by s_off % lane, both
    zero-padded to the window W = ceil((w + lane) / lane) * lane, and the
    offsets rounded down to a multiple of `lane`; mirror flags are kept and
    dense buckets left as they are.  The result is an ordinary bucket list
    (plus the marker 'aligned': lane) whose low-rank blocks are wider
    windows with zero columns, so any product of it equals the product of
    `data`; kernel K1-al reads its segments as whole aligned sectors."""
    def shift(A, W, sh):
        nb, r, w = A.shape
        Ap = torch.nn.functional.pad(A, (0, W - w))
        idx = (torch.arange(W, device=A.device)[None, :]
               - sh[:, None].long()) % W
        return torch.gather(Ap, 2, idx[:, None, :].expand(nb, r, W))

    lr_al = []
    for Ut, V, t_off, s_off, mirror in data["lr"]:
        Wt, Ws = _align_win(Ut.shape[2], lane), _align_win(V.shape[2], lane)
        t_sh, s_sh = t_off % lane, s_off % lane
        lr_al.append((shift(Ut, Wt, t_sh).contiguous(),
                      shift(V, Ws, s_sh).contiguous(),
                      (t_off - t_sh).contiguous(), (s_off - s_sh).contiguous(),
                      mirror))
    return {"dense": list(data["dense"]), "lr": lr_al, "aligned": lane}


def padded_lengths(plan):
    """(ny_pad, ns_pad) covering every scatter/gather target of the plan,
    for both 'N' and transpose products (mirrors write to both sides); the
    reference's rule, kept for parity."""
    nt, ns = plan.nb_rows, plan.nb_cols
    max_pt = max([b.pt for b in plan.dense_buckets + plan.lowrank_buckets],
                 default=1)
    max_ps = max([b.ps for b in plan.dense_buckets + plan.lowrank_buckets],
                 default=1)
    pad = max(max_pt, max_ps) + 256
    r128 = lambda v: -(-v // 128) * 128  # noqa: E731
    return r128(nt + pad), r128(ns + pad)


def stored_bytes(data) -> int:
    """Bytes of the stored (padded) bucket data a product streams."""
    return sum(t.numel() * t.element_size()
               for entry in data["dense"] + data["lr"]
               for t in entry[:-3])
