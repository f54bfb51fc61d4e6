"""Geometries and kernels for generators, tests and benchmarks."""

from .geometry import (
    create_partitioned_geometries,
    create_random_geometries,
    create_random_points_in_disk,
    create_random_points_in_sphere,
)
from .kernels import helmholtz_kernel, inverse_distance_kernel, laplace_kernel

__all__ = [
    "create_random_points_in_disk",
    "create_random_points_in_sphere",
    "create_random_geometries",
    "create_partitioned_geometries",
    "inverse_distance_kernel",
    "laplace_kernel",
    "helmholtz_kernel",
]
