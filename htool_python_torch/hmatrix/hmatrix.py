"""HMatrix: the compressed hierarchical operator, and its tree builder.

Counterpart of htool_python_tpu/hmatrix/hmatrix.py.  State is a host-side
BlockPlan + per-bucket device tensors.  Products run in the
cluster-internal numbering on the device; user-numbering permutations are
applied at the boundary (x_internal = x_user[perm],
y_user[perm] = y_internal).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..clustering.cluster import Cluster
from ..config import as_torch_dtype, get_config, resolve_device
from ..ops.cuda_matvec import BucketTable, apply_hmatrix_cuda
from ..ops.matvec import (ALIGN_LANE, RankMajorFactors, align_lowrank,
                          apply_hmatrix_user, pack_bucket_data)
from . import factorization
from .assembly import assemble
from .plan import BlockPlan, build_block_plan


def reduce_hmatrix_information(hmatrices) -> dict:
    """The reference's reduced info dict over H-matrices held in one process
    (the block rows of a distributed operator): sums for sizes, blocks and
    storage, min / max / mean over ranks."""
    return _reduced_info_dict(np.stack([h._information_tuple()
                                        for h in hmatrices]))


def _reduced_info_dict(a: np.ndarray) -> dict:
    """The info dict of (pieces, 10) `_information_tuple` rows."""
    rows = int(a[:, 0].sum())
    cols = int(a[0, 1])  # every piece spans the full source width
    stored = int(a[:, 4].sum())
    rank_count = int(a[:, 9].sum())
    total = max(rows * cols, 1)
    return {
        "Number_of_rows": str(rows),
        "Number_of_columns": str(cols),
        "Number_of_dense_blocks": str(int(a[:, 2].sum())),
        "Number_of_low_rank_blocks": str(int(a[:, 3].sum())),
        "Compression_ratio": str(total / max(stored, 1)),
        "Space_saving": str(1.0 - stored / total),
        "Storage_size_in_bytes": str(int(a[:, 5].sum())),
        "Min_rank": str(int(a[:, 6].min()) if rank_count else 0),
        "Max_rank": str(int(a[:, 7].max())),
        "Mean_rank": str(float(a[:, 8].sum()) / rank_count
                         if rank_count else 0.0),
    }


class HMatrix:
    """Compressed operator over (target_cluster x source_cluster)."""

    def __init__(self, plan: BlockPlan, dense_arrays, lr_arrays, lr_ranks,
                 epsilon, dtype, device):
        self.plan = plan
        self.device = torch.device(device)
        self._data = pack_bucket_data(plan.dense_buckets, dense_arrays,
                                      plan.lowrank_buckets, lr_arrays,
                                      self.device)
        self._lr_ranks = [np.asarray(r) for r in lr_ranks]
        self.epsilon = float(epsilon)
        self.eta = float(plan.eta)
        self.symmetry = plan.symmetry
        self.UPLO = plan.UPLO
        self.dtype = as_torch_dtype(dtype)
        self._dev_perms = None  # lazy device permutation cache
        # (product data, its BucketTable): the kernels' table, built at the
        # first product of each layout
        self._table = None
        self._aligned = None  # the aligned low-rank layout, built at 1st use
        self._compacted = False  # True once compact_for_products freed _data
        self._factorization = None  # set by lu/cholesky_factorization
        # every low-rank leaf an exact SVD pair (U = Q W diag(s) with
        # orthonormal Q W, V with orthonormal rows): recompression may then
        # trim by the row norms of Ut (hmatrix/recompression.py).  The
        # builder's assembly paths all end in an SVD truncation and set it.
        self._lr_svd_form = False

        nt, ns = plan.nb_rows, plan.nb_cols
        maxdim = max([b.pt for b in plan.dense_buckets + plan.lowrank_buckets]
                     + [b.ps for b in plan.dense_buckets + plan.lowrank_buckets]
                     + [1])
        # the reference's padded length (+384 slack, 128-multiple): every
        # block segment [off, off + pt) lies inside it, and so does every
        # aligned window [off - off % lane, + W), which ends before
        # off + pt + 2 * lane (<= 255 rows past the segment at lane 128)
        self._pad_len = -(-(max(nt, ns) + maxdim + 384) // 128) * 128

    @classmethod
    def from_arrays(cls, plan, dense, lr, ranks, eps, dtype, device,
                    lr_svd_form: bool = False):
        """An HMatrix from already-assembled arrays (numpy or tensors):
        dense[i] (nb, pt, ps) per plan.dense_buckets[i]; lr[i] a pair
        (Ut (nb, r, pt), V (nb, r, ps)) in rank-major storage layout per
        plan.lowrank_buckets[i]; ranks[i] (nb,).  `lr_svd_form`: every
        low-rank pair is an SVD pair (see __init__).  Lets another
        assembly — the reference's, in the tests — define the operator."""
        device = resolve_device(device)
        dtype = as_torch_dtype(dtype)
        def tensor(a):  # numpy arrays are copied (they may be read-only)
            if torch.is_tensor(a):
                return a.to(device=device, dtype=dtype)
            return torch.tensor(np.asarray(a), device=device, dtype=dtype)

        dense = [tensor(D) for D in dense]
        lr = [RankMajorFactors(tensor(Ut), tensor(V)) for Ut, V in lr]
        h = cls(plan, dense, lr, ranks, eps, dtype, device)
        h._lr_svd_form = bool(lr_svd_form)
        return h

    # ------------------------------------------------------------------
    @property
    def shape(self):
        return (self.plan.nb_rows, self.plan.nb_cols)

    @property
    def nb_rows(self):
        return self.plan.nb_rows

    @property
    def nb_cols(self):
        return self.plan.nb_cols

    def get_target_cluster(self) -> Cluster:
        return self.plan.target_cluster

    def get_source_cluster(self) -> Cluster:
        return self.plan.source_cluster

    def is_root(self) -> bool:
        """True if this H-matrix covers the full target and source trees."""
        p = self.plan
        return (p.target_offset == 0
                and p.nb_rows == len(p.target_root.get_permutation())
                and p.source_offset == 0
                and p.nb_cols == len(p.source_root.get_permutation()))

    # ------------------------------------------------------------------
    # products
    def _product_data(self):
        """The bucket data products consume: with
        config.matvec_aligned_layout on, a float32 operator with low-rank
        buckets gives their aligned layout (align_lowrank, lane ALIGN_LANE,
        built once and kept), which the wrapper sends to kernel K1-al;
        otherwise the canonical storage.  After compact_for_products only
        the aligned layout is left, and products read it whatever the
        switch says."""
        if self._data is None:
            return self._aligned
        if (get_config().matvec_aligned_layout
                and self.dtype == torch.float32 and self._data["lr"]):
            if self._aligned is None:
                self._aligned = align_lowrank(self._data, ALIGN_LANE)
            return self._aligned
        return self._data

    def compact_for_products(self) -> None:
        """Free the assembly layout where products read another one (the
        aligned low-rank layout of K1-al), so only the product layout stays
        in device memory.  Densification, recompression, the dense
        factorization and `lowrank_leaves` need the assembly layout and
        raise afterwards; call this only when the remaining work is
        products and solves.  No-op otherwise.  (The reference also splits
        complex64 operators into re / im planes here, for its TPU kernel;
        K2 reads complex64 as it is stored.)"""
        if self._data is not None and self._product_data() is not self._data:
            if self._table is not None and self._table[0] is self._data:
                self._table = None  # it holds the freed layout's tensors
            self._data = None
            self._compacted = True

    def _assembly_data(self):
        """The bucket data as assembled (the canonical storage), which
        densification and recompression read; products may read the
        aligned layout instead (`_product_data`).  Raises once
        compact_for_products has freed it."""
        if self._compacted:
            raise RuntimeError(
                "assembly arrays were freed by compact_for_products(); "
                "densify/recompression/factorization need them — rebuild "
                "the operator or skip compaction")
        return self._data

    def _bucket_table(self) -> BucketTable:
        """The product data's BucketTable, checked and built once per
        layout: a table names its layout's offsets and tensors, so a flip
        of matvec_aligned_layout builds the other layout's table."""
        data = self._product_data()
        if self._table is None or self._table[0] is not data:
            self._table = (data, BucketTable(data, self.device))
        return self._table[1]

    def _to_device(self, x):
        """(tensor on self.device, was the input a tensor)."""
        if torch.is_tensor(x):
            if x.device != self.device:
                raise ValueError(f"input is on {x.device}, the H-matrix on "
                                 f"{self.device}")
            return x, True
        return torch.as_tensor(np.asarray(x), device=self.device), False

    def _apply_internal_2d(self, x2d, trans: str):
        """x2d: (nin, k) tensor in internal numbering. Returns (nout, k).

        Symmetric block-row plans (t_off_absolute) run in absolute
        coordinates: the target segment is placed at / sliced from the
        plan's target_offset."""
        nt, ns = self.shape
        nin = ns if trans == "N" else nt
        nout = nt if trans == "N" else ns
        if x2d.shape[0] != nin:
            raise ValueError(f"expected input of size {nin}, got {x2d.shape[0]}")
        t_base = self.plan.target_offset if self.plan.t_off_absolute else 0
        in_base = 0 if trans == "N" else t_base
        out_base = t_base if trans == "N" else 0
        dtype = torch.promote_types(self.dtype, x2d.dtype)
        x_pad = torch.zeros((self._pad_len, x2d.shape[1]), dtype=dtype,
                            device=self.device)
        x_pad[in_base:in_base + nin] = x2d
        y_pad = apply_hmatrix_cuda(self._product_data(), x_pad,
                                   self._pad_len, trans, self.symmetry,
                                   self._bucket_table())
        return y_pad[out_base:out_base + nout]

    def matvec_internal(self, x, trans: str = "N"):
        """Product in internal numbering; numpy in -> numpy out, tensor in
        -> tensor out (on the H-matrix's device)."""
        x, device_io = self._to_device(x)
        squeeze = x.ndim == 1
        y = self._apply_internal_2d(x[:, None] if squeeze else x, trans)
        y = y[:, 0] if squeeze else y
        return y if device_io else y.cpu().numpy()

    def _device_perms(self, trans: str, dtype=torch.int64):
        """(perm_in, inv_perm_out) device tensors of `dtype` for
        user-numbering products, cached per trans direction and dtype:
        int64 for indexing, int32 for the permutation kernels that
        `matvec` runs on the card."""
        if self._dev_perms is None:
            self._dev_perms = {}
        key = ("N" if trans == "N" else "T", dtype)
        if key not in self._dev_perms:
            perm_t = self.plan.target_root.get_permutation()
            perm_s = self.plan.source_root.get_permutation()
            perm_in = perm_s if key[0] == "N" else perm_t
            perm_out = perm_t if key[0] == "N" else perm_s
            for perm in (perm_in, perm_out):  # the kernels read them unchecked
                if not np.array_equal(np.sort(perm), np.arange(len(perm))):
                    raise ValueError("a cluster permutation is not a "
                                     "permutation of its rows")
            inv_out = np.empty_like(perm_out)
            inv_out[perm_out] = np.arange(len(perm_out))
            self._dev_perms[key] = (
                torch.as_tensor(perm_in, dtype=dtype, device=self.device),
                torch.as_tensor(inv_out, dtype=dtype, device=self.device))
        return self._dev_perms[key]

    def matvec(self, x, trans: str = "N"):
        """Product in user numbering (root H-matrices).  For sub-blocks
        (local H-matrices) internal == local numbering; use matvec_internal.

        Accepts numpy or torch input; a tensor input (on the H-matrix's
        device) stays there and a tensor is returned."""
        if not self.is_root():
            return self.matvec_internal(x, trans)
        x, device_io = self._to_device(x)
        perm_in, inv_out = self._device_perms(trans, torch.int32)
        if x.shape[0] != perm_in.shape[0]:
            raise ValueError(
                f"expected input of size {perm_in.shape[0]}, got {x.shape[0]}")
        squeeze = x.ndim == 1
        x2d = x[:, None] if squeeze else x
        nout = self.shape[0] if trans == "N" else self.shape[1]
        y = apply_hmatrix_user(self._product_data(), perm_in, inv_out, x2d,
                               self._pad_len, trans, self.symmetry, nout,
                               self._bucket_table())
        y = y[:, 0] if squeeze else y
        return y if device_io else y.cpu().numpy()

    def __mul__(self, x):
        x = np.asarray(x)
        if x.ndim != 1:
            raise ValueError("use @ for matrices")
        return self.matvec(x)

    def __matmul__(self, X):
        # as in the reference: 1-D or 2-D numpy input, in any memory order
        # (np.asarray keeps Fortran-ordered column blocks as they are)
        return self.matvec(np.asarray(X))

    # ------------------------------------------------------------------
    # densification
    def to_dense_tensor(self) -> torch.Tensor:
        """Dense matrix in the cluster-internal numbering of this block, as
        a tensor on the H-matrix's device: each bucket's blocks are formed
        in one batched op and added into place with one index_add_ (their
        padding is masked out, so the buffer is exactly nt x ns)."""
        nt, ns = self.shape
        tb = self.plan.target_offset if self.plan.t_off_absolute else 0
        cols = ns
        out = torch.zeros(nt * ns, dtype=self.dtype, device=self.device)
        data = self._assembly_data()

        def put(t0, s0, t_sz, s_sz, blk):
            """blk (nb, p, q) at rows t0 + [0, p), cols s0 + [0, q), masked
            to (t_sz, s_sz)."""
            p, q = blk.shape[1], blk.shape[2]
            dev = self.device
            ar_p = torch.arange(p, device=dev)
            ar_q = torch.arange(q, device=dev)
            t0, s0, t_sz, s_sz = (torch.as_tensor(np.asarray(v, np.int64),
                                                  device=dev)
                                  for v in (t0, s0, t_sz, s_sz))
            mask = ((ar_p[None, :, None] < t_sz[:, None, None])
                    & (ar_q[None, None, :] < s_sz[:, None, None]))
            lin = ((t0[:, None, None] + ar_p[None, :, None]) * cols
                   + s0[:, None, None] + ar_q[None, None, :])
            out.index_add_(0, lin[mask], blk[mask])

        blocks = ([(D, b) for (D, *_), b in zip(data["dense"],
                                                self.plan.dense_buckets)]
                  + [(torch.einsum("nri,nrj->nij", Ut, V), b)
                     for (Ut, V, *_), b in zip(data["lr"],
                                               self.plan.lowrank_buckets)])
        for blk, b in blocks:
            put(b.t_off - tb, b.s_off, b.t_sz, b.s_sz, blk)
            m = np.flatnonzero(b.mirror)
            if len(m):
                mt = blk[torch.as_tensor(m, device=self.device)].transpose(1, 2)
                if self.symmetry == "H":
                    mt = mt.conj()
                put(b.s_off[m] - tb, b.t_off[m], b.s_sz[m], b.t_sz[m], mt)
        return out.view(nt, ns)

    def to_dense(self) -> np.ndarray:
        """Dense matrix in the cluster-internal numbering of this block."""
        return self.to_dense_tensor().cpu().numpy()

    def to_dense_in_user_numbering_tensor(self) -> torch.Tensor:
        """Dense matrix with rows/cols in user numbering, on the device.
        For sub-blocks the rows/cols are this block's points ordered by
        ascending user index."""
        p = self.plan
        perm_t = p.target_root.get_permutation()[
            p.target_offset:p.target_offset + p.nb_rows]
        perm_s = p.source_root.get_permutation()[
            p.source_offset:p.source_offset + p.nb_cols]
        # root: out[perm_t[i], perm_s[j]] = a[i, j]; a sub-block sorts its
        # points by user index: both read a at the inverse order
        inv_t, inv_s = (torch.as_tensor(np.argsort(q), device=self.device)
                        for q in (perm_t, perm_s))
        return self.to_dense_tensor()[inv_t][:, inv_s]

    def to_dense_in_user_numbering(self) -> np.ndarray:
        return self.to_dense_in_user_numbering_tensor().cpu().numpy()

    # ------------------------------------------------------------------
    # factorizations (hmatrix/factorization.py); in place: deepcopy first
    def lu_factorization(self):
        factorization.lu_factorization(self)

    def cholesky_factorization(self, UPLO: str = "L"):
        factorization.cholesky_factorization(self, UPLO)

    def lu_solve(self, trans: str, b):
        """Solve A^(trans) x = b with the factorization; numpy in -> numpy
        out, tensor in -> tensor out."""
        return factorization.lu_solve(self, trans, b)

    def cholesky_solve(self, UPLO: str, b):
        return factorization.cholesky_solve(self, UPLO, b)

    # ------------------------------------------------------------------
    def __deepcopy__(self, memo):
        new = object.__new__(HMatrix)
        new.__dict__.update(self.__dict__)
        # tensors are never modified in place and may be shared, but the
        # CONTAINERS are copied so a sibling's bucket replacement cannot
        # leak into this one
        if self._data is not None:
            new._data = {"dense": list(self._data["dense"]),
                         "lr": list(self._data["lr"])}
        new._lr_ranks = [r.copy() for r in self._lr_ranks]
        if self._aligned is not None:
            new._aligned = {"dense": list(self._aligned["dense"]),
                            "lr": list(self._aligned["lr"]),
                            "aligned": self._aligned["aligned"]}
        new._table = None  # it names this operator's containers
        new._factorization = None
        return new

    # ------------------------------------------------------------------
    # low-rank storage replacement (recompression)
    def _set_lr_structure(self, lowrank_buckets, lr_arrays, lr_ranks):
        """Replace the low-rank buckets AND factors (recompression with
        rank re-classing: recompressed ranks fall below their assembly
        class, so re-bucketing trims the padded bytes products stream).
        lr_arrays[i]: RankMajorFactors or (U (nb, pt, r), V (nb, r, ps))."""
        self.plan = dataclasses.replace(self.plan,
                                        lowrank_buckets=list(lowrank_buckets))
        self._set_lr_arrays(lr_arrays, lr_ranks)

    def _set_lr_arrays(self, lr_arrays, lr_ranks):
        """Replace the low-rank factors of the current buckets."""
        dense_arrays = [d[0] for d in self._assembly_data()["dense"]]
        self._data = pack_bucket_data(self.plan.dense_buckets, dense_arrays,
                                      self.plan.lowrank_buckets, lr_arrays,
                                      self.device)
        self._lr_ranks = [np.asarray(r) for r in lr_ranks]
        self._aligned = None  # laid out from the replaced factors
        self._table = None  # it names the replaced tensors by pointer

    # ------------------------------------------------------------------
    # info dicts (reference: get_tree_parameters / get_local_information)
    def get_tree_parameters(self) -> dict:
        return {
            "Epsilon": str(self.epsilon),
            "Eta": str(self.eta),
            "Symmetry": self.symmetry,
            "UPLO": self.UPLO,
            "Minimal_target_depth": str(self.plan.minimal_target_depth),
            "Minimal_source_depth": str(self.plan.minimal_source_depth),
            "Number_of_rows": str(self.plan.nb_rows),
            "Number_of_columns": str(self.plan.nb_cols),
        }

    def _storage_counts(self):
        dense_entries = 0
        for b in self.plan.dense_buckets:
            e = b.t_sz.astype(np.int64) * b.s_sz
            dense_entries += int(np.sum(e)) + int(np.sum(e * b.mirror))
        lr_entries = 0
        ranks_all = []
        for b, r in zip(self.plan.lowrank_buckets, self._lr_ranks):
            e = r.astype(np.int64) * (b.t_sz + b.s_sz)
            lr_entries += int(np.sum(e * (1 + b.mirror.astype(np.int64))))
            ranks_all.append(r)
        ranks_all = (np.concatenate(ranks_all) if ranks_all
                     else np.zeros(0, np.int64))
        return dense_entries, lr_entries, ranks_all

    def _information_tuple(self):
        """Numeric stats reduced by reduce_hmatrix_information: (rows, cols,
        dense_blocks, lr_blocks, stored_entries, bytes, min_rank, max_rank,
        rank_sum, rank_count)."""
        nt, ns = self.shape
        dense_e, lr_e, ranks = self._storage_counts()
        stored = dense_e + lr_e
        itemsize = torch.empty((), dtype=self.dtype).element_size()
        return np.array([
            nt, ns, self.plan.nb_dense_blocks(), self.plan.nb_lowrank_blocks(),
            stored, stored * itemsize,
            int(ranks.min()) if len(ranks) else np.iinfo(np.int64).max,
            int(ranks.max()) if len(ranks) else 0,
            int(ranks.sum()) if len(ranks) else 0, len(ranks),
        ], dtype=np.int64)

    def get_distributed_information(self, comm=None) -> dict:
        """Stats reduced over the distributed pieces of the operator (the
        reference's MPI-reduced `get_distributed_information(comm)`).  In a
        torch.distributed group of more than one process each process
        passes its own block row, as each MPI rank does, and the stats are
        all-gathered over the group; otherwise they are this H-matrix's.
        A process holding every block row reduces over them with
        `DistributedOperator.get_distributed_information`.  `comm` is
        accepted for the reference's signature and not used."""
        from ..parallel.multihost import process_count
        from ..parallel.sharded import all_gather

        tup = self._information_tuple()
        world = process_count()
        if world > 1:
            mine = torch.as_tensor(tup[None], device=self.device)
            rows = all_gather(torch.empty((world, len(tup)), dtype=mine.dtype,
                                          device=self.device), mine)
            info = _reduced_info_dict(rows.cpu().numpy())
        else:
            info = _reduced_info_dict(tup[None])
        info["Number_of_partitions"] = str(
            len(self.plan.target_root.tree.partition))
        return info

    def lowrank_leaves(self):
        """The low-rank leaves in the user layout, on the host: a list of
        (U (nb, pt, r), V (nb, r, ps), bucket, ranks), one per low-rank
        bucket (the stored rank-major Ut, transposed).  They are copies:
        changing them leaves the operator as it is."""
        return [(np.array(Ut.transpose(1, 2).cpu()), np.array(V.cpu()), b, r)
                for (Ut, V, *_), b, r in zip(self._assembly_data()["lr"],
                                             self.plan.lowrank_buckets,
                                             self._lr_ranks)]

    def get_local_information(self) -> dict:
        nt, ns = self.shape
        dense_e, lr_e, ranks = self._storage_counts()
        total = max(nt * ns, 1)
        stored = dense_e + lr_e
        itemsize = torch.empty((), dtype=self.dtype).element_size()
        return {
            "Number_of_rows": str(nt),
            "Number_of_columns": str(ns),
            "Number_of_dense_blocks": str(self.plan.nb_dense_blocks()),
            "Number_of_low_rank_blocks": str(self.plan.nb_lowrank_blocks()),
            "Compression_ratio": str(total / max(stored, 1)),
            "Space_saving": str(1.0 - stored / total),
            "Storage_size_in_bytes": str(stored * itemsize),
            "Min_rank": str(int(ranks.min()) if len(ranks) else 0),
            "Max_rank": str(int(ranks.max()) if len(ranks) else 0),
            "Mean_rank": str(float(ranks.mean()) if len(ranks) else 0.0),
        }


class HMatrixTreeBuilder:
    """Drives block-tree construction + compression (reference:
    hmatrix_tree_builder.hpp:10-44).  Runs on `device` (CUDA unless the
    caller names another); a device generator must live on that device."""

    def __init__(self, epsilon: float, eta: float, symmetry: str = "N",
                 UPLO: str = "N", reqrank: int = -1, low_rank_strategy=None,
                 device=None):
        if symmetry not in ("N", "S", "H"):
            raise ValueError("symmetry must be 'N', 'S' or 'H'")
        if UPLO not in ("N", "L", "U"):
            raise ValueError("UPLO must be 'N', 'L' or 'U'")
        if symmetry in ("S", "H") and UPLO == "N":
            raise ValueError("symmetric/hermitian requires UPLO 'L' or 'U'")
        # reference semantics (hmatrix_tree_builder.hpp:23-32): the
        # constructor's spelling of set_low_rank_generator, not a
        # strategy-name string
        if low_rank_strategy is not None and not hasattr(
                low_rank_strategy, "build_low_rank_approximation"):
            raise TypeError(
                "low_rank_strategy must be a VirtualLowRankGenerator "
                "(reference: hmatrix_tree_builder.hpp:23-32); got "
                f"{type(low_rank_strategy).__name__}")
        self.low_rank_strategy = low_rank_strategy
        self._low_rank_generator = low_rank_strategy
        self._dense_blocks_generator = None
        self.epsilon = float(epsilon)
        self.eta = float(eta)
        self.symmetry = symmetry
        self.UPLO = UPLO
        self.reqrank = int(reqrank)
        self.device = resolve_device(device)
        self._minimal_target_depth = 0
        self._minimal_source_depth = 0
        self._block_tree_consistency = True
        self._dtype = None

    def set_low_rank_generator(self, gen):
        """Compress every admissible block with `gen` (a
        VirtualLowRankGenerator) on the host instead of ACA."""
        self._low_rank_generator = gen

    def set_dense_blocks_generator(self, gen):
        """Fill every dense leaf with `gen` (a VirtualDenseBlocksGenerator),
        in one call per build."""
        self._dense_blocks_generator = gen

    def set_minimal_target_depth(self, d: int):
        self._minimal_target_depth = int(d)

    def set_minimal_source_depth(self, d: int):
        self._minimal_source_depth = int(d)

    def set_block_tree_consistency(self, flag: bool):
        if not flag:
            from ..utils.logger import get_logger
            get_logger().warning(
                "set_block_tree_consistency(False) has no effect: flat "
                "bucketed plans are always built consistently here")
        self._block_tree_consistency = bool(flag)

    def set_dtype(self, dtype):
        self._dtype = as_torch_dtype(dtype)

    def build(self, generator, target_cluster: Cluster, source_cluster: Cluster,
              target_partition_number: int = -1,
              partition_number_for_symmetry: int = -1) -> HMatrix:
        t_node = target_cluster
        if target_partition_number >= 0:
            t_node = target_cluster.get_cluster_on_partition(
                target_partition_number)
        # symmetric structure applies when target and source coincide, or —
        # with partition_number_for_symmetry — on the partition-diagonal
        # sub-block of a block-row build
        sym = self.symmetry
        uplo = self.UPLO
        sym_partition_diag = False

        def _trees_coincide(a, b):
            # the reference workflow builds target and source clusters with
            # separate create_cluster_tree calls on the same points;
            # structural identity is what symmetric storage requires
            return a is b or (
                a.nb_nodes == b.nb_nodes
                and np.array_equal(a.permutation, b.permutation)
                and np.array_equal(a.offsets, b.offsets)
                and np.array_equal(a.sizes, b.sizes))

        same_tree = _trees_coincide(t_node.tree, source_cluster.tree)
        if not same_tree or t_node.node != source_cluster.node:
            if (sym != "N" and partition_number_for_symmetry >= 0
                    and same_tree):
                if (target_partition_number >= 0
                        and partition_number_for_symmetry
                        != target_partition_number):
                    raise ValueError(
                        "partition_number_for_symmetry must match "
                        "target_partition_number")
                sym_partition_diag = True
            else:
                if sym != "N":
                    from ..utils.logger import get_logger
                    get_logger().warning(
                        "symmetric build of a non-diagonal sub-block without "
                        "partition_number_for_symmetry: falling back to "
                        "unsymmetric ('N') storage")
                sym, uplo = "N", "N"
        plan = build_block_plan(
            t_node, source_cluster, self.eta, sym, uplo,
            self._minimal_target_depth, self._minimal_source_depth,
            target_root=Cluster(target_cluster.tree, 0),
            source_root=Cluster(source_cluster.tree, 0),
            symmetric_partition_diag=sym_partition_diag,
        )
        dtype = self._dtype
        if dtype is None:
            dtype = get_config().default_dtype(
                getattr(generator, "is_complex", False))
        new_plan, dense_arrays, lr_arrays, lr_ranks = assemble(
            plan, generator, self.epsilon, self.reqrank, dtype, self.device,
            self._low_rank_generator, self._dense_blocks_generator)
        h = HMatrix(new_plan, dense_arrays, lr_arrays, lr_ranks,
                    self.epsilon, dtype, self.device)
        # every default assembly path (device ACA or dense + QR/SVD
        # truncation, host SVD) leaves SVD pairs: recompression may take its
        # O(bytes) trim; a custom low-rank hook's factors are of unknown form
        h._lr_svd_form = self._low_rank_generator is None
        return h

