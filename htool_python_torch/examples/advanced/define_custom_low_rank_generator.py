"""A user compression hook: truncated SVD with a worthwhileness check
(reference: example/advanced/define_custom_low_rank_generator.py).

Subclass `VirtualLowRankGenerator` and implement
`build_low_rank_approximation(rows, cols, epsilon)`: call `set_U(U)` /
`set_V(V)` and return True to store the block low-rank, or return False
to have the block filled densely instead.  The hook runs on the host per
block; the default compressor is the device-batched ACA.
"""

import numpy as np

from ...hmatrix.generator import VirtualGenerator, VirtualLowRankGenerator


class CustomSVD(VirtualLowRankGenerator):
    """Optimal (SVD) per-block compression against a host generator."""

    def __init__(self, generator: VirtualGenerator,
                 allow_copy: bool = True):
        super().__init__(allow_copy)
        self.generator = generator

    def build_low_rank_approximation(self, rows, cols, epsilon):
        m, n = len(rows), len(cols)
        block = np.zeros((m, n), order="F")
        self.generator.build_submatrix(rows, cols, block)
        u, s, vh = np.linalg.svd(block, full_matrices=False)
        # smallest rank whose discarded tail has Frobenius mass below
        # epsilon * ||block||_F
        tail_mass = np.sqrt(np.cumsum((s ** 2)[::-1]))[::-1]
        above = np.nonzero(tail_mass >= epsilon * np.linalg.norm(block))[0]
        rank = int(above[-1]) + 1 if len(above) else 1
        if rank * (m + n) > m * n:
            return False  # storing factors would cost more than the block
        self.set_U(u[:, :rank] * s[:rank])
        self.set_V(vh[:rank, :])
        return True
