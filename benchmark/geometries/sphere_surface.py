"""Points drawn uniformly on the unit sphere's surface, the boundary-element
geometry (normalized Gaussian triples)."""

import numpy as np


def points(n: int, rng: np.random.Generator) -> np.ndarray:
    """(3, n) float64."""
    g = rng.standard_normal((3, n))
    return g / np.linalg.norm(g, axis=0, keepdims=True)
