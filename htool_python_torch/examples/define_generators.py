"""Kernel generators for the examples.

* `CustomGenerator`: the host `VirtualGenerator` (the reference example's
  contract: build_submatrix fills a block at user-numbered indices), in
  vectorized numpy, with the dense mat_vec / mat_mat oracles the examples
  check against.
* `make_device_generator`: the same kernel 1/(0.1 + r) as a
  `KernelGenerator`, evaluated on the device in batched tiles during
  assembly.
"""

import numpy as np

from ..hmatrix.generator import KernelGenerator, VirtualGenerator
from ..models.kernels import inverse_distance_kernel


class CustomGenerator(VirtualGenerator):
    def __init__(self, target_points, source_points):
        super().__init__()
        self.target_points = np.asarray(target_points)
        self.source_points = np.asarray(source_points)
        self.nb_rows = self.target_points.shape[1]
        self.nb_cols = self.source_points.shape[1]

    def _block(self, J, K):
        t = self.target_points[:, np.asarray(J)]
        s = self.source_points[:, np.asarray(K)]
        d = np.linalg.norm(t[:, :, None] - s[:, None, :], axis=0)
        return 1.0 / (1e-1 + d)

    def get_coef(self, i, j):
        return float(self._block([i], [j])[0, 0])

    def build_submatrix(self, J, K, mat):
        mat[:, :] = self._block(J, K)

    def mat_vec(self, x):
        return self._block(np.arange(self.nb_rows),
                           np.arange(self.nb_cols)) @ x

    def mat_mat(self, X):
        return self._block(np.arange(self.nb_rows),
                           np.arange(self.nb_cols)) @ X


def make_device_generator(target_points, source_points, device=None):
    """Kernel entries computed on the device in batched tiles (assembly
    never calls back into Python per block)."""
    return KernelGenerator(inverse_distance_kernel(1e-1),
                           np.asarray(target_points),
                           np.asarray(source_points), device=device)
