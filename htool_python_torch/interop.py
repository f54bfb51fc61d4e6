"""Carry the reference package's state into the port, from numpy only.

The reference (htool_python_tpu) keeps an H-matrix's product data as a
pytree {'dense': [(D, t_off, s_off, mirror)], 'lr': [(Ut, V, t_off, s_off,
mirror)]} (its ops/matvec.py apply_hmatrix_padded docstring) and its plan
buckets as dataclasses of numpy arrays.  The functions here take those
after `np.asarray` on every leaf, or the bucket objects read attribute by
attribute, and import nothing of the reference.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .config import resolve_device
from .hmatrix.plan import BlockPlan, Bucket


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
