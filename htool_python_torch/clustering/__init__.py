"""Cluster trees and partitioning strategies (host: the native C++ builder
for the four built-in policies, numpy for user policies)."""

from .cluster import Cluster, ClusterTree, ClusterTreeBuilder
from .io import read_cluster_from, write_cluster_to
from .partitioning import (
    BoundingBoxGeometric,
    BoundingBoxRegular,
    PCAGeometric,
    PCARegular,
    VirtualPartitioning,
)

__all__ = [
    "Cluster",
    "ClusterTree",
    "ClusterTreeBuilder",
    "PCARegular",
    "PCAGeometric",
    "BoundingBoxRegular",
    "BoundingBoxGeometric",
    "VirtualPartitioning",
    "read_cluster_from",
    "write_cluster_to",
]
