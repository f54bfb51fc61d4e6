"""Geometry helpers for the examples: the package's point clouds
(models/geometry.py) under the reference example's names (reference:
example/create_geometry.py)."""

from ..models.geometry import (  # noqa: F401
    create_partitioned_geometries,
    create_random_geometries,
    create_random_points_in_disk,
    create_random_points_in_sphere,
)

# reference spelling (example/create_geometry.py:40)
create_partitionned_geometries = create_partitioned_geometries
