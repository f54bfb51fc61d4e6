"""Custom local operators for a DistributedOperator (reference:
example/advanced/define_custom_local_operator.py).  The in-place
`output` contract is kept: `output *= beta; output += alpha * (...)`.
"""

import numpy as np

from ...hmatrix.generator import VirtualGenerator
from ...parallel.local_operator import (LocalRenumbering,
                                        RestrictedGlobalToLocalOperator,
                                        VirtualLocalToLocalOperator)


class CustomRestrictedGlobalToLocalOperator(RestrictedGlobalToLocalOperator):
    """Dense user operator mapping a global source window to this
    partition's local target rows."""

    def __init__(self, generator: VirtualGenerator,
                 target_local_renumbering: LocalRenumbering,
                 source_local_renumbering: LocalRenumbering,
                 target_use_permutation_to_mvprod: bool = False,
                 source_use_permutation_to_mvprod: bool = False) -> None:
        super().__init__(target_local_renumbering, source_local_renumbering,
                         target_use_permutation_to_mvprod,
                         source_use_permutation_to_mvprod)
        t, s = target_local_renumbering, source_local_renumbering
        self.data = np.zeros((t.size, s.size))
        generator.build_submatrix(
            t.permutation[t.offset:t.offset + t.size],
            s.permutation[s.offset:s.offset + s.size], self.data)

    def add_vector_product(self, trans, alpha, input, beta, output):
        # in-place operations keep the caller's buffer
        output *= beta
        if trans == "N":
            output += alpha * self.data.dot(input)
        elif trans == "T":
            output += alpha * self.data.T.dot(input)
        else:
            output += alpha * self.data.conj().T.dot(input)

    add_matrix_product_row_major = add_vector_product


# kept under both names: the reference renamed this class and left the old
# name in one of its examples
CustomGlobalToLocalOperator = CustomRestrictedGlobalToLocalOperator


class CustomLocalToLocalOperator(VirtualLocalToLocalOperator):
    """Dense user operator for the partition-diagonal block."""

    def __init__(self, generator: VirtualGenerator,
                 target_local_renumbering: LocalRenumbering,
                 source_local_renumbering: LocalRenumbering) -> None:
        super().__init__(target_local_renumbering, source_local_renumbering)
        t, s = target_local_renumbering, source_local_renumbering
        self.data = np.zeros((t.size, s.size))
        generator.build_submatrix(
            t.permutation[t.offset:t.offset + t.size],
            s.permutation[s.offset:s.offset + s.size], self.data)

    def local_add_vector_product(self, trans, alpha, input, beta, output):
        output *= beta
        if trans == "N":
            output += alpha * self.data.dot(input)
        elif trans == "T":
            output += alpha * self.data.T.dot(input)
        else:
            output += alpha * self.data.conj().T.dot(input)

    local_add_matrix_product_row_major = local_add_vector_product
