"""The sharded, multi-process distributed operator on torch.distributed.

Counterpart of htool_python_tpu/parallel/sharded.py, and of htool-DDM's MPI
distribution that it replaced on the TPU.  There, the P block rows were
stacked into one padded array set with a leading partition axis sharded
over a device mesh, and one shard_map program ran the product.  Here every
process (one per card; NCCL between cards, gloo between CPU processes)
keeps its own P / world size consecutive block rows as port `HMatrix`
objects (`multihost.rank_partitions`), and a product is:

  'N':      x replicated -> each rank's block rows through
            `HMatrix.matvec_internal` (the product kernels on the card) ->
            the target segments, padded to the longest, gathered with one
            all_gather_into_tensor -> un-permuted;
  'T'/'C':  each rank adds sum_p H_p^(trans) x_p over its block rows into a
            source-length vector (the block row's mirrors conjugated as
            the reference's rule, sharded.py:143-145) -> one all_reduce.

Without a process group (or in a world of one) a single process holds all
P partitions and the collectives are identities.  The stacking of
partitions into one padded array set (`_stack_partition_data`) is TPU/XLA
plumbing and has no counterpart.

`sharded_block_solve` is the one-level block-Jacobi preconditioner with
the subdomain batch sharded the same way: each rank solves its subdomains
(batched `torch.linalg.lu_solve`), weights them, scatter-adds into a
vector with one padding row, and one all_reduce sums the ranks.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch
import torch.distributed as dist

from ..clustering.cluster import Cluster
from ..config import resolve_device
from .multihost import rank_partitions


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def all_gather(out, inp, group=None):
    """out = the ranks' `inp` stacked along dim 0 in rank order (one
    all_gather_into_tensor; a copy without a process group)."""
    if not _initialized():
        out.copy_(inp.reshape(out.shape))
        return out
    o, i = ((torch.view_as_real(out), torch.view_as_real(inp))
            if out.is_complex() else (out, inp))
    with warnings.catch_warnings():  # deprecated name in newer torch
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(o, i.contiguous(), group=group)
    return out


def all_reduce(t, group=None):
    """t summed over the ranks, in place (nothing without a group)."""
    if _initialized():
        dist.all_reduce(torch.view_as_real(t) if t.is_complex() else t,
                        group=group)
    return t


class ShardedDistributedOperator:
    """Global-to-global operator from per-partition block-row HMatrices (as
    `DefaultApproximationBuilder.hmatrix` holds them), sharded over the
    processes of `group`.

    `hmatrices[p]` is partition p's block row (target partition p x the
    whole source); a rank reads only its own partitions' entries
    (`rank_partitions`), so the others may be None.  Raises ValueError
    unless the world size divides P.  Products run on the device of the
    rank's block rows; numpy in gives numpy out, a tensor in gives a tensor
    out (the reference's rule, sharded.py:346-356)."""

    def __init__(self, hmatrices, target_cluster: Cluster,
                 source_cluster: Cluster, group=None):
        self.hmatrices = list(hmatrices)
        self.target_cluster = target_cluster
        self.source_cluster = source_cluster
        self.group = group
        P = len(self.hmatrices)
        if target_cluster.nb_partitions() != P:
            raise ValueError(f"{P} block rows for a target cluster of "
                             f"{target_cluster.nb_partitions()} partitions")
        self.n_partitions = P
        self.partitions = rank_partitions(P, group)
        self.shape = (target_cluster.get_size(), source_cluster.get_size())
        parts = [target_cluster.get_cluster_on_partition(p) for p in range(P)]
        self.t_offsets = np.array([c.get_offset() for c in parts], np.int64)
        self.t_sizes = np.array([c.get_size() for c in parts], np.int64)
        self.t_max = int(self.t_sizes.max())
        local = [self.hmatrices[p] for p in self.partitions]
        for p, h in zip(self.partitions, local):
            if h is None or h.shape != (self.t_sizes[p], self.shape[1]):
                raise ValueError(f"partition {p} needs its block row of "
                                 f"shape {(int(self.t_sizes[p]), self.shape[1])}")
        self.device = local[0].device
        dtype = local[0].dtype
        for h in local:
            dtype = torch.promote_types(dtype, h.dtype)
        self.dtype = dtype

        def perm(a):
            return torch.as_tensor(a, dtype=torch.int64, device=self.device)

        perm_t = target_cluster.get_permutation()
        perm_s = source_cluster.get_permutation()
        self._perm_t, self._perm_s = perm(perm_t), perm(perm_s)
        self._inv_t, self._inv_s = perm(np.argsort(perm_t)), perm(
            np.argsort(perm_s))

    def _apply(self, x2d, trans: str):
        """H^(trans) x2d, both (n, k) tensors on self.device in user
        numbering."""
        if trans not in ("N", "T", "C"):
            raise ValueError(f"trans must be 'N', 'T' or 'C', got {trans!r}")
        n_in = self.shape[1] if trans == "N" else self.shape[0]
        if x2d.shape[0] != n_in:
            raise ValueError(f"expected input of size {n_in}, got "
                             f"{x2d.shape[0]}")
        dtype = torch.promote_types(x2d.dtype, self.dtype)
        k = x2d.shape[1]
        if trans == "N":
            x_int = x2d[self._perm_s].to(dtype)
            seg = torch.zeros((len(self.partitions), self.t_max, k),
                              dtype=dtype, device=self.device)
            for i, p in enumerate(self.partitions):
                seg[i, :self.t_sizes[p]] = self.hmatrices[p].matvec_internal(
                    x_int, "N")
            parts = all_gather(torch.empty((self.n_partitions, self.t_max, k),
                                           dtype=dtype, device=self.device),
                               seg, self.group)
            y_int = torch.empty((self.shape[0], k), dtype=dtype,
                                device=self.device)
            for p in range(self.n_partitions):
                o, s = int(self.t_offsets[p]), int(self.t_sizes[p])
                y_int[o:o + s] = parts[p, :s]
            return y_int[self._inv_t]
        x_int = x2d[self._perm_t].to(dtype)
        y_int = torch.zeros((self.shape[1], k), dtype=dtype,
                            device=self.device)
        for p in self.partitions:
            o, s = int(self.t_offsets[p]), int(self.t_sizes[p])
            y_int += self.hmatrices[p].matvec_internal(x_int[o:o + s], trans)
        return all_reduce(y_int, self.group)[self._inv_s]

    def build_device_apply(self, trans: str = "N"):
        """A tensor -> tensor apply x2d (n, k) -> y2d (n, k) on self.device,
        as `solvers/krylov.py gmres_device` takes it: every rank runs the
        same replicated solve and calls it together.  It reads the block
        rows at every call (no memo outlives a change to them)."""
        return lambda x2d: self._apply(x2d, trans)

    def matvec_global(self, x, trans: str = "N"):
        """Global-to-global product in user numbering ('N', 'T' or 'C'),
        called by every rank together."""
        device_io = torch.is_tensor(x)
        if device_io:
            if x.device != self.device:
                raise ValueError(f"input is on {x.device}, the operator on "
                                 f"{self.device}")
        else:
            x = torch.as_tensor(np.asarray(x), device=self.device)
        squeeze = x.ndim == 1
        y = self._apply(x[:, None] if squeeze else x, trans)
        y = y[:, 0] if squeeze else y
        return y if device_io else y.cpu().numpy()

    def __mul__(self, x):
        return self.matvec_global(x)

    def __matmul__(self, X):
        return self.matvec_global(X)


def sharded_block_solve(lu, piv, idx_pad, weights, n: int, group=None,
                        device=None):
    """The sharded one-level preconditioner r (n, k) -> sum_p R_p^T D_p
    A_p^{-1} R_p r (reference sharded.py:365-416).

    lu (P, m, m), piv (P, m): `torch.linalg.lu_factor` of every subdomain
    matrix, padded to m; idx_pad (P, m): each subdomain's global user
    indices, padding rows -> n; weights (P, m).  Each rank keeps its
    consecutive P / world size subdomains (`rank_partitions`) on `device`
    (lu's device for a tensor, else the card), solves them with one batched
    `torch.linalg.lu_solve`, weights and scatter-adds them into an (n + 1)
    -row vector (row n takes the padding), and one all_reduce sums the
    ranks.  Returns precond(r) (numpy in, numpy out; tensor in, tensor
    out) with the tensor apply (n, k) -> (n, k) as `precond.device_apply`.
    """
    if device is None:
        device = lu.device if torch.is_tensor(lu) else resolve_device(None)
    mine = rank_partitions(len(lu), group)
    sl = slice(mine.start, mine.stop)

    def local(a, dtype=None):
        return torch.as_tensor(a[sl]).to(device=device, dtype=dtype)

    lu_l, piv_l = local(lu), local(piv, torch.int32)
    idx_l, w_l = local(idx_pad, torch.int64), local(weights)

    def device_apply(r2d):
        k = r2d.shape[1]
        dtype = torch.promote_types(lu_l.dtype, r2d.dtype)
        r_ext = torch.cat([r2d.to(dtype), torch.zeros((1, k), dtype=dtype,
                                                      device=device)])
        Z = torch.linalg.lu_solve(lu_l.to(dtype), piv_l, r_ext[idx_l])
        Z = Z * w_l.to(dtype)[:, :, None]
        out = torch.zeros((n + 1, k), dtype=dtype, device=device)
        out.index_add_(0, idx_l.reshape(-1), Z.reshape(-1, k))
        return all_reduce(out, group)[:n]

    def precond(r):
        device_io = torch.is_tensor(r)
        r = r if device_io else torch.as_tensor(np.asarray(r), device=device)
        squeeze = r.ndim == 1
        out = device_apply(r[:, None] if squeeze else r)
        out = out[:, 0] if squeeze else out
        return out if device_io else out.cpu().numpy()

    precond.device_apply = device_apply
    return precond
