"""Points drawn uniformly in the unit ball (the reference's
example/create_geometry.py `create_random_points_in_sphere`, drawn from a
numpy Generator)."""

import numpy as np


def points(n: int, rng: np.random.Generator) -> np.ndarray:
    """(3, n) float64."""
    u = rng.random((3, n))
    r = np.cbrt(u[0])
    costh = 2.0 * u[1] - 1.0
    sinth = np.sqrt(1.0 - costh ** 2)
    phi = 2.0 * np.pi * u[2]
    return np.stack([r * sinth * np.cos(phi), r * sinth * np.sin(phi),
                     r * costh])
