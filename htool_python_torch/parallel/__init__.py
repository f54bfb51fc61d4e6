"""Distributed operators: local operators, the row-partitioned global
operator and its builders, and the sharded multi-process operator on
torch.distributed (sharded.py, multihost.py)."""

from .multihost import (initialize_distributed, is_primary, process_count,
                        rank_partitions)
from .sharded import ShardedDistributedOperator, sharded_block_solve

__all__ = ["ShardedDistributedOperator", "sharded_block_solve",
           "initialize_distributed", "process_count", "is_primary",
           "rank_partitions"]
