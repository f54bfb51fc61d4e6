"""DistributedOperator: row-partitioned global operator.

Counterpart of htool_python_tpu/parallel/distributed_operator.py.  The
target cluster is split into P partitions; partition p owns one optional
local-to-local operator (its diagonal block) plus any number of
global-to-local operators.  `*` / `@` are global-to-global products in user
numbering, and `internal_sub_vector_product_global_to_local` computes one
partition's target segment from a window of the internal source vector.

One process holds every partition.  When every local operator is an
H-matrix or a dense block (`device_apply_available`), products run on the
device through `build_device_apply`: gather with the source permutation,
add each piece into its target rows (an H-matrix piece through
`HMatrix.matvec_internal`, i.e. kernel K1 / K2 with the piece's bucket
table; a dense piece through torch.matmul), and scatter with the target
permutation.  Custom Python local operators run on the host, in numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from ..clustering.cluster import Cluster
from ..config import resolve_device
from ..hmatrix.assembly import _numpy_dtype
from ..hmatrix.hmatrix import reduce_hmatrix_information
from .local_operator import (
    LocalDenseMatrix,
    LocalHMatrix,
    RestrictedGlobalToLocalOperator,
    VirtualLocalToLocalOperator,
)


class DistributedOperator:
    def __init__(self, target_cluster: Cluster, source_cluster: Cluster,
                 comm=None, device=None):
        """`device`: where the device apply runs; by default the device of
        the H-matrix pieces, or CUDA when there are none."""
        self.target_cluster = target_cluster
        self.source_cluster = source_cluster
        self.comm = comm  # accepted for parity; unused in one process
        self.n_partitions = target_cluster.nb_partitions()
        # partition layout in internal numbering
        self.t_offsets = np.array(
            [target_cluster.get_cluster_on_partition(p).get_offset()
             for p in range(self.n_partitions)], dtype=np.int64)
        self.t_sizes = np.array(
            [target_cluster.get_cluster_on_partition(p).get_size()
             for p in range(self.n_partitions)], dtype=np.int64)
        self._local_to_local = [None] * self.n_partitions
        self._global_to_local = [[] for _ in range(self.n_partitions)]
        self._device = None if device is None else resolve_device(device)

    # ------------------------------------------------------------------
    @property
    def shape(self):
        return (self.target_cluster.get_size(), self.source_cluster.get_size())

    def get_size_of_partition(self, p: int) -> int:
        return int(self.t_sizes[p])

    def _partition_of_target_offset(self, offset: int) -> int:
        for p in range(self.n_partitions):
            if self.t_offsets[p] == offset:
                return p
        raise ValueError(f"no target partition starts at offset {offset}")

    def add_local_to_local_operator(self, op: VirtualLocalToLocalOperator,
                                    partition: int | None = None) -> None:
        if partition is None:
            partition = self._partition_of_target_offset(
                op.local_target_renumbering.offset)
        self._local_to_local[partition] = op

    def add_global_to_local_operator(self, op: RestrictedGlobalToLocalOperator,
                                     partition: int | None = None) -> None:
        if partition is None:
            partition = self._partition_of_target_offset(
                op.local_target_renumbering.offset)
        self._global_to_local[partition].append(op)

    def _operators(self, p: int) -> list:
        ops = list(self._global_to_local[p])
        if self._local_to_local[p] is not None:
            ops.append(self._local_to_local[p])
        return ops

    @property
    def device(self) -> torch.device:
        """Where the device apply runs."""
        if self._device is None:
            for p in range(self.n_partitions):
                for op in self._operators(p):
                    if isinstance(op, LocalHMatrix):
                        return op.hmatrix.device
            self._device = resolve_device(None)
        return self._device

    # ------------------------------------------------------------------
    # host path (custom Python local operators)
    def _apply_partition_internal(self, p: int, x_int: np.ndarray,
                                  dtype) -> np.ndarray:
        """Partition p's target segment of A_internal @ x_int (2-D x)."""
        t_sz = int(self.t_sizes[p])
        y = np.zeros((t_sz,) + x_int.shape[1:], dtype=dtype)
        multi = x_int.ndim == 2 and x_int.shape[1] > 1
        l2l = self._local_to_local[p]
        if l2l is not None:
            s = l2l.local_source_renumbering
            seg = np.ascontiguousarray(x_int[s.offset:s.offset + s.size])
            if multi:
                l2l.local_add_matrix_product_row_major("N", 1.0, seg, 1.0, y)
            else:
                l2l.local_add_vector_product("N", 1.0, seg, 1.0, y)
        for op in self._global_to_local[p]:
            s = op.local_source_renumbering
            seg = np.ascontiguousarray(x_int[s.offset:s.offset + s.size])
            if multi:
                op.add_matrix_product_row_major("N", 1.0, seg, 1.0, y)
            else:
                op.add_vector_product("N", 1.0, seg, 1.0, y)
        return y

    def _result_dtype(self, x) -> np.dtype:
        """numpy result dtype of a product with x."""
        dts = [np.dtype(x.dtype)]
        for p in range(self.n_partitions):
            for op in self._operators(p):
                if isinstance(op, LocalHMatrix):
                    dts.append(_numpy_dtype(op.hmatrix.dtype))
                elif hasattr(op, "data"):
                    dts.append(np.asarray(op.data).dtype)
        return np.result_type(*dts)

    def matvec_global(self, x):
        """Global-to-global product in user numbering (reference `*`/`@`);
        numpy in, numpy out.  Runs the device apply when every local
        operator allows it, else the host path."""
        x = np.asarray(x)
        squeeze = x.ndim == 1
        x2 = x[:, None] if squeeze else x
        dtype = self._result_dtype(x2)
        if self.device_apply_available():
            y = self.build_device_apply()(
                torch.as_tensor(np.ascontiguousarray(x2, dtype=dtype),
                                device=self.device)).cpu().numpy()
        else:
            x_int = x2[self.source_cluster.get_permutation()]
            y_int = np.zeros((self.shape[0],) + x2.shape[1:], dtype=dtype)
            for p in range(self.n_partitions):
                t_off, t_sz = int(self.t_offsets[p]), int(self.t_sizes[p])
                y_int[t_off:t_off + t_sz] = self._apply_partition_internal(
                    p, x_int, dtype)
            y = np.empty_like(y_int)
            y[self.target_cluster.get_permutation()] = y_int
        return y[:, 0] if squeeze else y

    def __mul__(self, x):
        x = np.asarray(x)
        if x.ndim != 1:
            raise ValueError("use @ for matrices")
        if len(x) != self.shape[1]:
            raise ValueError("size mismatch")
        return self.matvec_global(x)

    def __matmul__(self, X):
        X = np.asarray(X)
        if X.shape[0] != self.shape[1]:
            raise ValueError("size mismatch")
        return self.matvec_global(X)

    # ------------------------------------------------------------------
    # device path (the solvers' hot loop)
    def device_apply_available(self) -> bool:
        """True when every registered local operator is an H-matrix or a
        dense block; custom Python operators force the host path."""
        return all(isinstance(op, (LocalHMatrix, LocalDenseMatrix))
                   for p in range(self.n_partitions)
                   for op in self._operators(p))

    def build_device_apply(self):
        """A function x2d (n_src, k) -> y2d (n_tgt, k), both tensors on
        `self.device` in user numbering: the global product.

        It holds the permutations and the dense pieces as device tensors
        and the H-matrices themselves (whose products use their own bucket
        tables), and is built anew on every call: nothing is memoized, so a
        new apply sees any change made to the pieces since the last one."""
        if not self.device_apply_available():
            raise ValueError("distributed operator holds custom Python local "
                             "operators; device apply unavailable")
        device = self.device
        pieces = []  # (t_off, t_sz, s_off, s_sz, apply(seg))
        op_dtypes = []
        for p in range(self.n_partitions):
            t_off, t_sz = int(self.t_offsets[p]), int(self.t_sizes[p])
            for op in self._operators(p):
                s = op.local_source_renumbering
                if isinstance(op, LocalHMatrix):
                    h = op.hmatrix
                    if h.device != device:
                        raise ValueError(f"an H-matrix piece is on {h.device}, "
                                         f"the operator on {device}")
                    fn = (lambda seg, _h=h: _h.matvec_internal(seg, "N"))
                    op_dtypes.append(h.dtype)
                else:
                    D = torch.as_tensor(op.data, device=device)
                    fn = (lambda seg, _D=D: _D @ seg)
                    op_dtypes.append(D.dtype)
                pieces.append((t_off, t_sz, int(s.offset), int(s.size), fn))
        n_t = self.shape[0]
        perm_s = torch.as_tensor(self.source_cluster.get_permutation(),
                                 dtype=torch.int64, device=device)
        inv_t = torch.as_tensor(np.argsort(self.target_cluster.get_permutation()),
                                dtype=torch.int64, device=device)

        def apply(x2d):
            dtype = x2d.dtype
            for dt in op_dtypes:
                dtype = torch.promote_types(dtype, dt)
            x_int = x2d[perm_s].to(dtype)
            y_int = torch.zeros((n_t, x2d.shape[1]), dtype=dtype,
                                device=device)
            for t_off, t_sz, s_off, s_sz, fn in pieces:
                y_int[t_off:t_off + t_sz] += fn(x_int[s_off:s_off + s_sz])
            return y_int[inv_t]  # y[perm_t] = y_int

        return apply

    # ------------------------------------------------------------------
    def get_distributed_information(self) -> dict:
        """Stats reduced over every partition's H-matrix-backed local
        operators (the reference's MPI-reduced
        `HMatrix.get_distributed_information(comm)`, each rank contributing
        its block row)."""
        hmats = [op.hmatrix for p in range(self.n_partitions)
                 for op in self._operators(p) if isinstance(op, LocalHMatrix)]
        if not hmats:
            raise ValueError("no H-matrix-backed local operators registered")
        info = reduce_hmatrix_information(hmats)
        info["Number_of_partitions"] = str(self.n_partitions)
        return info

    # ------------------------------------------------------------------
    def internal_sub_vector_product_global_to_local(self, x_window, offset,
                                                    partition: int = 0):
        """Partition's target segment of A_internal @ x where x is zero
        outside the internal window [offset, offset+len(x_window))."""
        x_window = np.asarray(x_window)
        squeeze = x_window.ndim == 1
        xw = x_window[:, None] if squeeze else x_window
        dtype = self._result_dtype(xw)
        x_int = np.zeros((self.shape[1],) + xw.shape[1:], dtype=dtype)
        x_int[offset:offset + len(xw)] = xw
        y = self._apply_partition_internal(partition, x_int, dtype)
        return y[:, 0] if squeeze else y
