"""Carry the reference package's state into the port, from numpy only.

The reference (htool_python_tpu) keeps an H-matrix's product data as a
pytree {'dense': [(D, t_off, s_off, mirror)], 'lr': [(Ut, V, t_off, s_off,
mirror)]} (its ops/matvec.py apply_hmatrix_padded docstring) and its plan
buckets as dataclasses of numpy arrays.  The functions here take those
after `np.asarray` on every leaf, or the bucket objects read attribute by
attribute, and import nothing of the reference.  A reference distributed
operator's block rows come over the same way (`block_rows_from_reference`),
into the port's DistributedOperator (`distributed_from_reference`) or its
ShardedDistributedOperator.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .clustering.cluster import Cluster
from .config import resolve_device
from .hmatrix.hmatrix import HMatrix
from .hmatrix.plan import BlockPlan, Bucket
from .parallel.distributed_operator import DistributedOperator
from .parallel.local_operator import LocalHMatrix, LocalRenumbering


def from_reference_data(np_tree, device=None):
    """The port's bucket data (ops/matvec.py layout) from the reference's
    pytree with numpy leaves.  Data arrays keep their dtype (float32/64,
    complex64/128); offsets become int32, mirror flags bool."""
    device = resolve_device(device)

    def meta(t_off, s_off, mirror):
        return (torch.tensor(np.asarray(t_off, np.int32), device=device),
                torch.tensor(np.asarray(s_off, np.int32), device=device),
                torch.tensor(np.asarray(mirror, bool), device=device))

    def copy(a):  # a copy: the reference's host views are read-only
        return torch.tensor(np.asarray(a), device=device)

    dense = [(copy(D), *meta(t, s, m)) for D, t, s, m in np_tree["dense"]]
    lr = [(copy(Ut), copy(V), *meta(t, s, m))
          for Ut, V, t, s, m in np_tree["lr"]]
    return {"dense": dense, "lr": lr}


def bucket_from_reference(ref_bucket) -> Bucket:
    """A port Bucket with the fields of a reference bucket."""
    return Bucket(pt=int(ref_bucket.pt), ps=int(ref_bucket.ps),
                  t_off=np.asarray(ref_bucket.t_off, np.int32),
                  s_off=np.asarray(ref_bucket.s_off, np.int32),
                  t_sz=np.asarray(ref_bucket.t_sz, np.int32),
                  s_sz=np.asarray(ref_bucket.s_sz, np.int32),
                  mirror=np.asarray(ref_bucket.mirror, bool))


def plan_from_reference(port_plan: BlockPlan, ref_plan) -> BlockPlan:
    """`port_plan` (built by the port on the same clusters) with the
    reference plan's buckets, e.g. those of a reference assembly, which
    moved failed low-rank blocks into dense buckets and split the rest by
    rank class."""
    return dataclasses.replace(
        port_plan,
        dense_buckets=[bucket_from_reference(b) for b in ref_plan.dense_buckets],
        lowrank_buckets=[bucket_from_reference(b)
                         for b in ref_plan.lowrank_buckets])


def block_row_from_reference(target_cluster: Cluster, source_cluster: Cluster,
                             p: int, ref_plan, np_tree, lr_ranks, epsilon,
                             device=None) -> HMatrix:
    """Partition p's block row of a reference `DefaultApproximationBuilder`
    as a port HMatrix on the port's clusters: the reference plan's buckets
    and flags (`ref_plan` read attribute by attribute), its bucket arrays
    (`np_tree`, the block row's `_data` with numpy leaves) and ranks."""
    plan = BlockPlan(
        target_cluster=target_cluster.get_cluster_on_partition(p),
        source_cluster=source_cluster,
        target_root=Cluster(target_cluster.tree, 0),
        source_root=Cluster(source_cluster.tree, 0),
        eta=float(ref_plan.eta), symmetry=ref_plan.symmetry,
        UPLO=ref_plan.UPLO,
        dense_buckets=[bucket_from_reference(b)
                       for b in ref_plan.dense_buckets],
        lowrank_buckets=[bucket_from_reference(b)
                         for b in ref_plan.lowrank_buckets],
        minimal_target_depth=int(ref_plan.minimal_target_depth),
        minimal_source_depth=int(ref_plan.minimal_source_depth),
        t_off_absolute=bool(ref_plan.t_off_absolute))
    dense = [np.asarray(D) for D, *_ in np_tree["dense"]]
    lr = [(np.asarray(Ut), np.asarray(V)) for Ut, V, *_ in np_tree["lr"]]
    dtype = (dense or [a for pair in lr for a in pair])[0].dtype
    return HMatrix.from_arrays(plan, dense, lr, lr_ranks, epsilon, dtype,
                               device)


def block_rows_from_reference(target_cluster: Cluster,
                              source_cluster: Cluster, block_rows,
                              device=None) -> list:
    """The block rows of a reference `DefaultApproximationBuilder` as port
    HMatrices, one per partition (the `hmatrices` of the port's
    ShardedDistributedOperator).  `block_rows[p]` = (ref_plan, np_tree,
    lr_ranks, epsilon) of partition p; see block_row_from_reference."""
    return [block_row_from_reference(target_cluster, source_cluster, p, *row,
                                     device=device)
            for p, row in enumerate(block_rows)]


def distributed_from_reference(target_cluster: Cluster,
                               source_cluster: Cluster, block_rows,
                               device=None) -> DistributedOperator:
    """The port's distributed operator holding the block rows of a
    reference `DefaultApproximationBuilder`, laid out as that builder lays
    them out (partition p's block row over the full source range).
    `block_rows[p]` = (ref_plan, np_tree, lr_ranks, epsilon) of partition
    p; see block_row_from_reference."""
    op = DistributedOperator(target_cluster, source_cluster,
                             device=resolve_device(device))
    src = LocalRenumbering(0, source_cluster.get_size(),
                           source_cluster.get_permutation())
    for p, h in enumerate(block_rows_from_reference(
            target_cluster, source_cluster, block_rows, device)):
        local = LocalHMatrix(h)
        local.local_source_renumbering = src
        op.add_global_to_local_operator(local, p)
    return op
