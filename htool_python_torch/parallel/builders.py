"""One-call distributed-operator assembly builders.

Counterpart of htool_python_tpu/parallel/builders.py:
  * `DefaultApproximationBuilder` — each partition gets the H-matrix block
    row of its target rows x ALL source columns, registered as a
    global-to-local operator; exposes `.distributed_operator`, `.hmatrix`,
    `.block_diagonal_hmatrix` and `.build_profile`;
  * `DefaultLocalApproximationBuilder` — only the partition-diagonal block
    is compressed; off-diagonal operators are added by the user;
  * `CustomApproximationBuilder` — user-provided local operators.

One process holds every partition, so `.hmatrix` and
`.block_diagonal_hmatrix` are `PerPartition` containers (a list that
forwards attribute access to its only element when it has one).

The block diagonal is extracted on the device (`_extract_block_diagonal`):
blocks are selected and clipped with index tensors, never copied to the
host, and re-bucketed with the plan's `_bucketize`, so the extracted
plan's buckets are the reference's.
"""

from __future__ import annotations

import copy
import time

import numpy as np
import torch

from ..clustering.cluster import Cluster
from ..hmatrix.assembly import _sync
from ..hmatrix.hmatrix import HMatrix, HMatrixTreeBuilder
from ..hmatrix.plan import BlockPlan, _bucketize, _pad_dim
from ..ops.matvec import RankMajorFactors
from .distributed_operator import DistributedOperator
from .local_operator import LocalHMatrix, LocalRenumbering


class PerPartition(list):
    """Per-partition container with single-element attribute forwarding."""

    def __getattr__(self, name):
        if len(self) == 1:
            return getattr(self[0], name)
        raise AttributeError(
            f"PerPartition has {len(self)} elements; index it explicitly "
            f"(e.g. obj[p].{name})")

    def __deepcopy__(self, memo):
        return PerPartition(copy.deepcopy(item, memo) for item in self)


class DefaultApproximationBuilder:
    def __init__(self, generator, target_cluster: Cluster,
                 source_cluster: Cluster, hmatrix_builder: HMatrixTreeBuilder,
                 comm=None):
        self.distributed_operator = DistributedOperator(
            target_cluster, source_cluster, comm, hmatrix_builder.device)
        P = self.distributed_operator.n_partitions
        hmatrices = []
        src_renum = LocalRenumbering(0, source_cluster.get_size(),
                                     source_cluster.get_permutation())
        symmetric = hmatrix_builder.symmetry != "N"
        self.build_profile = {"block_row_s": []}
        for p in range(P):
            # symmetric operators: the partition-diagonal sub-block of each
            # block row keeps one triangle + mirrors (the reference passes
            # the rank as partition_number_for_symmetry)
            t0 = time.perf_counter()
            h = hmatrix_builder.build(
                generator, target_cluster, source_cluster,
                target_partition_number=p,
                partition_number_for_symmetry=(p if symmetric else -1))
            _sync(h.device)
            self.build_profile["block_row_s"].append(time.perf_counter() - t0)
            hmatrices.append(h)
            op = LocalHMatrix(h)
            # block row: source window = the full source range
            op.local_source_renumbering = src_renum
            self.distributed_operator.add_global_to_local_operator(op, p)
        self.hmatrix = PerPartition(hmatrices)
        self._clusters = (target_cluster, source_cluster)
        self._block_diag = None

    @property
    def block_diagonal_hmatrix(self):
        """Partition-diagonal sub-blocks, extracted on first access (a
        distributed product does not need them; solver setups do)."""
        if self._block_diag is None:
            t0 = time.perf_counter()
            tc, sc = self._clusters
            self._block_diag = PerPartition(
                _extract_block_diagonal(h, tc, sc, p)
                for p, h in enumerate(self.hmatrix))
            _sync(self.distributed_operator.device)
            self.build_profile["extract_block_diag_s"] = (time.perf_counter()
                                                          - t0)
        return self._block_diag

    @block_diagonal_hmatrix.setter
    def block_diagonal_hmatrix(self, value):
        self._block_diag = value


class DefaultLocalApproximationBuilder:
    def __init__(self, generator, target_cluster: Cluster,
                 source_cluster: Cluster, hmatrix_builder: HMatrixTreeBuilder,
                 comm=None):
        self.distributed_operator = DistributedOperator(
            target_cluster, source_cluster, comm, hmatrix_builder.device)
        P = self.distributed_operator.n_partitions
        hmatrices = []
        for p in range(P):
            s_node = source_cluster.get_cluster_on_partition(p)
            h = _build_sub_block(hmatrix_builder, generator, target_cluster,
                                 source_cluster, p)
            hmatrices.append(h)
            op = LocalHMatrix(h)
            op.local_source_renumbering = LocalRenumbering(s_node)
            self.distributed_operator.add_global_to_local_operator(op, p)
        self.hmatrix = PerPartition(hmatrices)
        self.block_diagonal_hmatrix = self.hmatrix


class CustomApproximationBuilder:
    def __init__(self, target_cluster: Cluster, source_cluster: Cluster,
                 comm=None, local_operator=None, device=None):
        """`device`: where the distributed operator's device apply runs
        (default: CUDA); it runs only when every local operator is an
        H-matrix or a dense block."""
        self.distributed_operator = DistributedOperator(
            target_cluster, source_cluster, comm, device)
        if local_operator is not None:
            ops = (local_operator if isinstance(local_operator, (list, tuple))
                   else [local_operator])
            for op in ops:
                # either operator kind is accepted here: dispatch on the
                # interface the object implements
                if hasattr(op, "local_add_vector_product"):
                    self.distributed_operator.add_local_to_local_operator(op)
                else:
                    self.distributed_operator.add_global_to_local_operator(op)


def _build_sub_block(hmatrix_builder: HMatrixTreeBuilder, generator,
                     target_cluster: Cluster, source_cluster: Cluster,
                     p: int):
    """Build the (target partition p) x (source partition p) diagonal block."""
    t_node = target_cluster.get_cluster_on_partition(p)
    s_node = source_cluster.get_cluster_on_partition(p)
    sub_builder = HMatrixTreeBuilder(
        hmatrix_builder.epsilon, hmatrix_builder.eta,
        hmatrix_builder.symmetry, hmatrix_builder.UPLO,
        hmatrix_builder.reqrank, device=hmatrix_builder.device)
    sub_builder._dtype = hmatrix_builder._dtype
    return sub_builder.build(generator, t_node, s_node)


def _extract_block_diagonal(hmatrix, target_cluster, source_cluster, p):
    """The diagonal sub-block of a block-row H-matrix, as its own HMatrix.

    Blocks of the row plan that meet the source partition's column range are
    kept, clipped to it; the host reads only the plan (numpy metadata), and
    the stored tensors are gathered into the new buckets on the device."""
    t_node = target_cluster.get_cluster_on_partition(p)
    if source_cluster.nb_partitions() > p:
        s_node = source_cluster.get_cluster_on_partition(p)
    else:
        # unpartitioned source cluster: the "diagonal" block spans all
        # source columns
        s_node = source_cluster
    s_lo = s_node.get_offset() - hmatrix.plan.source_offset
    s_hi = s_lo + s_node.get_size()
    # symmetric block-row plans carry absolute t offsets; the extracted
    # diagonal block is a standard local plan (both offsets partition-local)
    tb = hmatrix.plan.target_offset if hmatrix.plan.t_off_absolute else 0
    data = hmatrix._assembly_data()
    device = hmatrix.device

    def kept(buckets):
        """Clipped (t_off, t_sz, s_off, s_sz, mirror) tuples of the blocks
        that meet [s_lo, s_hi), and their sources (bucket, block, first
        column kept), in plan order."""
        tuples, sources = [], []
        for j, b in enumerate(buckets):
            lo = b.s_off.astype(np.int64)
            clo = np.maximum(lo, s_lo)
            chi = np.minimum(lo + b.s_sz, s_hi)
            for i in np.flatnonzero(chi > clo):
                tuples.append((int(b.t_off[i]) - tb, int(b.t_sz[i]),
                               int(clo[i]) - s_lo, int(chi[i] - clo[i]),
                               bool(b.mirror[i])))
                sources.append((j, int(i), int(clo[i] - lo[i])))
        new = _bucketize(tuples)
        # _bucketize groups by padded shape, sorted, each group in plan
        # order: a stable sort by the same key gives its order
        order = sorted(range(len(tuples)), key=lambda q: (
            _pad_dim(tuples[q][1]), _pad_dim(tuples[q][3])))
        groups, start = [], 0
        for b in new:
            groups.append([(*sources[q], tuples[q][1], tuples[q][3])
                           for q in order[start:start + b.nb]])
            start += b.nb
        return new, groups

    def gather(src, group, rows, cols):
        """out[g, a, c] = src[i_g, a, col0_g + c] for group entries
        (j, i_g, col0_g, n_rows_g, n_cols_g), masked to a < n_rows_g and
        c < n_cols_g (indices past src's extent are clamped, then masked)."""
        blk, col0, nr, nc = (torch.as_tensor(np.asarray(v, np.int64),
                                             device=device)
                             for v in list(zip(*group))[1:])
        ar_r = torch.arange(rows, device=device)
        ar_c = torch.arange(cols, device=device)
        rr = ar_r.clamp(max=src.shape[1] - 1)
        cc = (col0[:, None] + ar_c[None, :]).clamp(max=src.shape[2] - 1)
        out = src[blk[:, None, None], rr[None, :, None], cc[:, None, :]]
        mask = ((ar_r[None, :, None] < nr[:, None, None])
                & (ar_c[None, None, :] < nc[:, None, None]))
        return torch.where(mask, out, torch.zeros((), dtype=out.dtype,
                                                  device=device))

    def scatter(bucket_groups, shape, fill):
        """One new bucket's tensor: every source bucket's share gathered by
        `fill(j, rows_of_group, positions)` into its positions."""
        out = None
        by_src = {}
        for pos, g in enumerate(bucket_groups):
            by_src.setdefault(g[0], []).append(pos)
        for j, positions in by_src.items():
            part = fill(j, [bucket_groups[q] for q in positions])
            if out is None:
                out = torch.zeros(shape, dtype=part.dtype, device=device)
            out[torch.as_tensor(positions, device=device)] = part
        return out

    # dense: D (nb, pt, ps); group entries (j, i, col0, t_sz, width)
    dense_buckets, dense_groups = kept(hmatrix.plan.dense_buckets)
    dense_arrays = [
        scatter(g, (b.nb, b.pt, b.ps), lambda j, grp, b=b: gather(
            data["dense"][j][0], grp, b.pt, b.ps))
        for b, g in zip(dense_buckets, dense_groups)]

    # low-rank: Ut (nb, r, pt), V (nb, r, ps), rank rows masked by each
    # block's rank
    lr_buckets, lr_groups = kept(hmatrix.plan.lowrank_buckets)
    lr_arrays, lr_ranks = [], []
    for b, g in zip(lr_buckets, lr_groups):
        ranks = [int(hmatrix._lr_ranks[j][i]) for j, i, *_ in g]
        rmax = max(ranks + [1])
        g_ut = [(j, i, 0, r, t_sz) for (j, i, _, t_sz, _), r in zip(g, ranks)]
        g_v = [(j, i, c0, r, w) for (j, i, c0, _, w), r in zip(g, ranks)]
        Ut = scatter(g_ut, (b.nb, rmax, b.pt), lambda j, grp: gather(
            data["lr"][j][0], grp, rmax, b.pt))
        V = scatter(g_v, (b.nb, rmax, b.ps), lambda j, grp: gather(
            data["lr"][j][1], grp, rmax, b.ps))
        lr_arrays.append(RankMajorFactors(Ut, V))
        lr_ranks.append(np.asarray(ranks, dtype=np.int32))

    plan = BlockPlan(
        target_cluster=t_node, source_cluster=s_node,
        target_root=hmatrix.plan.target_root,
        source_root=hmatrix.plan.source_root,
        eta=hmatrix.eta, symmetry=hmatrix.symmetry, UPLO=hmatrix.UPLO,
        dense_buckets=dense_buckets, lowrank_buckets=lr_buckets)
    return HMatrix(plan, dense_arrays, lr_arrays, lr_ranks, hmatrix.epsilon,
                   hmatrix.dtype, device)
