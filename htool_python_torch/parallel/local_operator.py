"""Local operators: the per-partition pieces of a distributed operator.

Counterpart of htool_python_tpu/parallel/local_operator.py:
  * `LocalRenumbering` — (offset, size, permutation) descriptor of a
    contiguous segment of the permuted global numbering;
  * `RestrictedGlobalToLocalOperator` — user operator mapping a global
    source window to this partition's target rows;
    `add_vector_product(trans, alpha, in, beta, out)` updates `out` IN
    PLACE (`out *= beta; out += alpha * y`), the reference's contract;
  * `VirtualLocalToLocalOperator` — operator for the partition-diagonal
    block, with windowed sub-products by zero-extension;
  * `LocalHMatrix` / `LocalDenseMatrix` — adapters turning an HMatrix / a
    dense block into a local operator.

The host path works on numpy arrays, as the reference's user operators
do; the distributed operator's device apply reads LocalHMatrix and
LocalDenseMatrix pieces directly (parallel/distributed_operator.py).
"""

from __future__ import annotations

import numpy as np


class LocalRenumbering:
    """Descriptor of a contiguous segment [offset, offset+size) of the
    permuted (internal) global numbering."""

    def __init__(self, *args):
        if len(args) == 1:  # from a Cluster node
            cluster = args[0]
            self.offset = cluster.get_offset()
            self.size = cluster.get_size()
            self.permutation = cluster.get_permutation()
        elif len(args) == 3:
            offset, size, permutation = args
            self.offset = int(offset)
            self.size = int(size)
            self.permutation = np.asarray(permutation, dtype=np.int64)
        else:
            raise TypeError("LocalRenumbering(cluster) or (offset, size, permutation)")

    @property
    def global_size(self) -> int:
        return len(self.permutation)

    @property
    def is_stable(self) -> bool:
        """True if the permutation restricted to the segment is the identity."""
        seg = self.permutation[self.offset:self.offset + self.size]
        return bool(np.array_equal(seg, np.arange(self.offset,
                                                  self.offset + self.size)))


class RestrictedGlobalToLocalOperator:
    """Abstract user operator: global source window -> local target rows."""

    def __init__(self, target_local_renumbering: LocalRenumbering,
                 source_local_renumbering: LocalRenumbering,
                 target_use_permutation_to_mvprod: bool = False,
                 source_use_permutation_to_mvprod: bool = False):
        self.local_target_renumbering = target_local_renumbering
        self.local_source_renumbering = source_local_renumbering
        self.target_use_permutation_to_mvprod = target_use_permutation_to_mvprod
        self.source_use_permutation_to_mvprod = source_use_permutation_to_mvprod

    def add_vector_product(self, trans, alpha, input, beta, output):
        raise NotImplementedError  # pragma: no cover

    def add_matrix_product_row_major(self, trans, alpha, input, beta, output):
        raise NotImplementedError  # pragma: no cover


class VirtualLocalToLocalOperator:
    """Abstract user operator for the partition-diagonal block."""

    def __init__(self, target_local_renumbering: LocalRenumbering,
                 source_local_renumbering: LocalRenumbering):
        self.local_target_renumbering = target_local_renumbering
        self.local_source_renumbering = source_local_renumbering

    def local_add_vector_product(self, trans, alpha, input, beta, output):
        raise NotImplementedError  # pragma: no cover

    def local_add_matrix_product_row_major(self, trans, alpha, input, beta,
                                           output):
        raise NotImplementedError  # pragma: no cover

    def add_sub_matrix_product_to_local(self, trans, alpha, input, beta,
                                        output, offset, size):
        """Windowed product by zero-extension: `input` holds the internal
        window [offset, offset + size); the operator sees it zero outside."""
        ssz = self.local_source_renumbering.size
        soff = self.local_source_renumbering.offset
        x = np.zeros((ssz,) + input.shape[1:], dtype=input.dtype)
        lo = max(offset, soff)
        hi = min(offset + size, soff + ssz)
        if hi > lo:
            x[lo - soff:hi - soff] = input[lo - offset:hi - offset]
        self.local_add_vector_product(trans, alpha, x, beta, output)


class LocalHMatrix(RestrictedGlobalToLocalOperator):
    """Adapter: an HMatrix block used as a local operator.

    The wrapped HMatrix's target covers [t_off, t_off+t_size) and source
    covers [s_off, s_off+s_size) of the respective internal numberings.
    """

    def __init__(self, hmatrix, target_cluster=None, source_cluster=None,
                 symmetry: str = "N", UPLO: str = "N",
                 target_use_perm: bool = True, source_use_perm: bool = True):
        p = hmatrix.plan
        tc = target_cluster if target_cluster is not None else p.target_cluster
        sc = source_cluster if source_cluster is not None else p.source_cluster
        super().__init__(LocalRenumbering(tc), LocalRenumbering(sc),
                         target_use_perm, source_use_perm)
        self.hmatrix = hmatrix

    def add_vector_product(self, trans, alpha, input, beta, output):
        y = self.hmatrix.matvec_internal(input, trans)
        output *= beta
        output += alpha * y

    add_matrix_product_row_major = add_vector_product


class LocalDenseMatrix(RestrictedGlobalToLocalOperator):
    """Adapter: an explicit dense block used as a local operator."""

    def __init__(self, data, target_renumbering: LocalRenumbering,
                 source_renumbering: LocalRenumbering):
        super().__init__(target_renumbering, source_renumbering)
        self.data = np.asarray(data)

    def add_vector_product(self, trans, alpha, input, beta, output):
        if trans == "N":
            y = self.data @ input
        elif trans == "T":
            y = self.data.T @ input
        else:
            y = self.data.conj().T @ input
        output *= beta
        output += alpha * y

    add_matrix_product_row_major = add_vector_product
