"""Distributed operators: local operators, the row-partitioned global
operator and its builders, and the sharded multi-process operator on
torch.distributed (sharded.py, multihost.py)."""

from .builders import (
    CustomApproximationBuilder,
    DefaultApproximationBuilder,
    DefaultLocalApproximationBuilder,
    PerPartition,
)
from .distributed_operator import DistributedOperator
from .local_operator import (
    LocalDenseMatrix,
    LocalHMatrix,
    LocalRenumbering,
    RestrictedGlobalToLocalOperator,
    VirtualLocalToLocalOperator,
)
from .multihost import (initialize_distributed, is_primary, process_count,
                        rank_partitions)
from .sharded import ShardedDistributedOperator, sharded_block_solve

__all__ = [
    "LocalRenumbering",
    "RestrictedGlobalToLocalOperator",
    "VirtualLocalToLocalOperator",
    "LocalHMatrix",
    "LocalDenseMatrix",
    "DistributedOperator",
    "DefaultApproximationBuilder",
    "DefaultLocalApproximationBuilder",
    "CustomApproximationBuilder",
    "PerPartition",
    "ShardedDistributedOperator",
    "sharded_block_solve",
    "initialize_distributed",
    "process_count",
    "is_primary",
    "rank_partitions",
]
