"""A batched dense-leaf assembly hook (reference:
example/advanced/define_custom_dense_blocks_generator.py).

`VirtualDenseBlocksGenerator.build_dense_blocks` receives every dense
leaf of the plan in one call: lists of user-numbered row indices, column
indices, and pre-allocated blocks to fill.  This one groups the leaves by
shape and fills each group with one stacked kernel evaluation.
"""

import numpy as np

from ...clustering.cluster import Cluster
from ...hmatrix.generator import VirtualDenseBlocksGenerator


class CustomDenseBlocksGenerator(VirtualDenseBlocksGenerator):
    def __init__(self, generator, target_cluster: Cluster,
                 source_cluster: Cluster):
        super().__init__(target_cluster, source_cluster)
        self.generator = generator

    def build_dense_blocks(self, rows_offsets, cols_offsets, blocks):
        # group leaves by shape so each group fills in one vectorized call
        groups: dict[tuple, list[int]] = {}
        for i, b in enumerate(blocks):
            groups.setdefault(b.shape, []).append(i)
        tp = self.generator.target_points
        sp = self.generator.source_points
        for _, ids in groups.items():
            rows = np.stack([rows_offsets[i] for i in ids])  # (g, m)
            cols = np.stack([cols_offsets[i] for i in ids])  # (g, n)
            t = tp[:, rows]                                  # (dim, g, m)
            s = sp[:, cols]                                  # (dim, g, n)
            d = np.linalg.norm(t[:, :, :, None] - s[:, :, None, :], axis=0)
            vals = 1.0 / (1e-1 + d)                          # (g, m, n)
            for k, i in enumerate(ids):
                blocks[i][...] = vals[k]
