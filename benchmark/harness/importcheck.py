"""The packages a run may not load: JAX and the JAX package that the port
was made from.  Module names are compared by their top-level name, whole:
the port's own name begins with the JAX package's."""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "htool_python_tpu"})


def forbidden_loaded(modules=None) -> list:
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & FORBIDDEN)
