"""Coefficient generators: how matrix entries are produced during assembly.

Counterpart of htool_python_tpu/hmatrix/generator.py:

  * `VirtualGenerator` — subclass and implement `build_submatrix(J, K, mat)`,
    filling the numpy array `mat` with entries at *user-numbered* rows J /
    cols K (the reference's host-callback path).
  * `FunctionGenerator` — a vectorized host function f(J, K).
  * `MatrixGenerator` / `KernelGenerator` — device generators: their data
    live as tensors on `device`, and `device_blocks` / `device_rows` /
    `device_cols` evaluate whole batches of blocks, rows or columns there.
    Assembly with them runs entirely on the device, batched per bucket.
  * `VirtualLowRankGenerator` / `VirtualDenseBlocksGenerator` — the user's
    own compression of each low-rank block and assembly of the dense
    leaves (a BEM code's hooks), on the host, in numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import resolve_device


class VirtualGenerator:
    """Host-callback generator (reference-compatible).

    The optional (target_permutation, source_permutation) constructor
    arguments mirror the reference binding signature; cluster permutations
    are applied by the planner before the callback, so they are accepted
    for API parity and used only to override those permutations.
    """

    is_complex = False

    def __init__(self, target_permutation=None, source_permutation=None):
        self.target_permutation = (
            None if target_permutation is None
            else np.asarray(target_permutation, dtype=np.int64))
        self.source_permutation = (
            None if source_permutation is None
            else np.asarray(source_permutation, dtype=np.int64))

    def build_submatrix(self, J, K, mat) -> None:  # pragma: no cover - abstract
        raise NotImplementedError

    # dtype the assembly should use; complex subclasses may override
    def dtype(self, default):
        return default


class FunctionGenerator(VirtualGenerator):
    """Vectorized host generator from f(J, K) -> (len(J), len(K)) ndarray."""

    def __init__(self, fn, is_complex=False):
        super().__init__()
        self.fn = fn
        self.is_complex = is_complex

    def build_submatrix(self, J, K, mat):
        mat[:, :] = self.fn(np.asarray(J), np.asarray(K))


class MatrixGenerator(VirtualGenerator):
    """Generator backed by an explicit dense matrix, held on `device`."""

    def __init__(self, matrix, device=None):
        super().__init__()
        self.matrix = np.asarray(matrix)
        self.is_complex = np.iscomplexobj(self.matrix)
        self.device = resolve_device(device)
        self._matrix = torch.as_tensor(self.matrix, device=self.device)

    def build_submatrix(self, J, K, mat):
        mat[:, :] = self.matrix[np.ix_(np.asarray(J), np.asarray(K))]

    def device_blocks(self, t_idx, s_idx):
        """t_idx (nb, bt), s_idx (nb, bs) user indices -> (nb, bt, bs)."""
        return self._matrix[t_idx[:, :, None], s_idx[:, None, :]]

    def device_rows(self, t_idx, s_idx):
        """t_idx (nb,), s_idx (nb, bs) -> (nb, bs)."""
        return self._matrix[t_idx[:, None], s_idx]

    def device_cols(self, t_idx, s_idx):
        """t_idx (nb, bt), s_idx (nb,) -> (nb, bt)."""
        return self._matrix[t_idx, s_idx[:, None]]


class KernelGenerator(VirtualGenerator):
    """Entries k(x_i, y_j) from a torch kernel of coordinates.

    `kernel` maps broadcastable coordinate tensors (..., dim), (..., dim) to
    entry values (...,) (models/kernels.py).  `target_points` /
    `source_points` are (dim, N) like the reference's generators.  The
    coordinates live on `device` in `coord_dtype`; assembly casts the
    entries to its own coefficient dtype.
    """

    def __init__(self, kernel, target_points, source_points, is_complex=False,
                 device=None, coord_dtype=torch.float64):
        super().__init__()
        self.kernel = kernel
        self.target_points = np.asarray(target_points, dtype=np.float64)
        self.source_points = np.asarray(source_points, dtype=np.float64)
        self.is_complex = is_complex
        self.device = resolve_device(device)
        self._tx = torch.as_tensor(self.target_points.T, dtype=coord_dtype,
                                   device=self.device).contiguous()  # (N, dim)
        self._sx = torch.as_tensor(self.source_points.T, dtype=coord_dtype,
                                   device=self.device).contiguous()

    def build_submatrix(self, J, K, mat):
        tx = torch.as_tensor(self.target_points[:, np.asarray(J)].T)
        sx = torch.as_tensor(self.source_points[:, np.asarray(K)].T)
        mat[:, :] = self.kernel(tx[:, None, :], sx[None, :, :]).numpy()

    def device_blocks(self, t_idx, s_idx):
        return self.kernel(self._tx[t_idx][:, :, None, :],
                           self._sx[s_idx][:, None, :, :])

    def device_rows(self, t_idx, s_idx):
        return self.kernel(self._tx[t_idx][:, None, :], self._sx[s_idx])

    def device_cols(self, t_idx, s_idx):
        return self.kernel(self._tx[t_idx], self._sx[s_idx][:, None, :])


class VirtualLowRankGenerator:
    """Custom low-rank approximation hook (reference:
    virtual_low_rank_generator.hpp:15-92).

    Subclass implements `build_low_rank_approximation(rows, cols, epsilon)`
    (user-numbered rows and columns of one admissible block), calling
    `set_U(U)` (len(rows) x r) / `set_V(V)` (r x len(cols)) and returning
    True, or returning False to assemble that block dense.  Assembly copies
    the factors into its padded device buckets; with `allow_copy=False`
    the generator also keeps every array it was given until `clear_data()`
    (the reference's ownership protocol).
    """

    def __init__(self, allow_copy: bool = True):
        self._allow_copy = allow_copy
        self._U = None
        self._V = None
        self._stored = []

    def build_low_rank_approximation(self, rows, cols, epsilon) -> bool:
        raise NotImplementedError  # pragma: no cover - abstract

    def set_U(self, U):
        self._U = np.asarray(U)
        if not self._allow_copy:
            self._stored.append(self._U)

    def set_V(self, V):
        self._V = np.asarray(V)
        if not self._allow_copy:
            self._stored.append(self._V)

    def clear_data(self):
        self._stored.clear()

    def take_uv(self):
        """The factors of the last successful call, handed over once."""
        U, V = self._U, self._V
        self._U = None
        self._V = None
        return U, V


class VirtualDenseBlocksGenerator:
    """Batched dense-leaf hook (reference:
    virtual_dense_blocks_generator.hpp:11-69): every dense leaf of a build,
    blocks densified by the low-rank test included, is handed over in ONE
    call, `build_dense_blocks(rows_offsets, cols_offsets, blocks)`: lists of
    user-numbered row and column index arrays and of zeroed
    Fortran-ordered (len(rows), len(cols)) numpy arrays to fill in
    place."""

    def __init__(self, target_cluster=None, source_cluster=None):
        self.target_cluster = target_cluster
        self.source_cluster = source_cluster

    def build_dense_blocks(self, rows_offsets, cols_offsets, blocks) -> None:
        raise NotImplementedError  # pragma: no cover - abstract
