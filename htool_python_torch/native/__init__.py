"""Host C++ for the port: the cluster-tree builder.

Counterpart of htool_python_tpu/native/.  csrc/cluster_builder.cpp (a copy
of the reference's, the same algorithm as the numpy path in
clustering/cluster.py) is built by `g++ -O3 -march=native` at first use
into `build/` (ops/cuda_build.py, keyed by a hash of the source, the flags
and the compiler's target) and bound here with ctypes through the
reference's C interface: ct_build, ct_nb_nodes, ct_nb_partitions, ct_copy,
ct_free.  There is no switch and no fallback: the four built-in policies
always take this builder, and a failed build or load raises with the
compiler's output.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

MAX_DIM = 16  # the builder's per-node buffers (csrc/cluster_builder.cpp)

_lock = threading.Lock()
_lib = None


def _load():
    """The bound library, built first where it is missing."""
    global _lib
    with _lock:
        if _lib is None:
            from ..ops import cuda_build

            lib = cuda_build.load("cluster_builder")
            i64p = ctypes.POINTER(ctypes.c_int64)
            f64p = ctypes.POINTER(ctypes.c_double)
            lib.ct_build.restype = ctypes.c_void_p
            lib.ct_build.argtypes = [f64p, f64p, f64p, ctypes.c_int,
                                     ctypes.c_int64, ctypes.c_int,
                                     ctypes.c_int64, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_int, i64p,
                                     ctypes.c_int64, i64p]
            lib.ct_nb_nodes.restype = ctypes.c_int64
            lib.ct_nb_nodes.argtypes = [ctypes.c_void_p]
            lib.ct_nb_partitions.restype = ctypes.c_int64
            lib.ct_nb_partitions.argtypes = [ctypes.c_void_p]
            lib.ct_copy.restype = None
            lib.ct_copy.argtypes = ([ctypes.c_void_p] + [i64p] * 6
                                    + [f64p] * 2 + [i64p])
            lib.ct_free.restype = None
            lib.ct_free.argtypes = [ctypes.c_void_p]
            _lib = lib
        return _lib


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def build_cluster_tree_native(coords: np.ndarray, point_radii: np.ndarray,
                              weights: np.ndarray, nb_children: int,
                              mls: int, minimal_depth: int,
                              direction_kind: int, split_kind: int,
                              top_parts):
    """Run the C++ builder.  `top_parts` = None or the list of user-index
    arrays forming the partition level.  Returns the flat tree arrays
    (offsets, sizes, depths, parents, children_start, children_count,
    centers, radii, partition, permutation), the layout of
    clustering.cluster.ClusterTree."""
    coords = np.ascontiguousarray(coords, dtype=np.float64)
    dim, n = coords.shape
    point_radii = np.ascontiguousarray(point_radii, dtype=np.float64)
    weights = np.ascontiguousarray(weights, dtype=np.float64)
    if not 1 <= dim <= MAX_DIM:
        raise ValueError(f"the native builder takes 1 to {MAX_DIM} "
                         f"coordinates a point, got {dim}")
    if point_radii.shape != (n,) or weights.shape != (n,):
        raise ValueError(f"radii {point_radii.shape} and weights "
                         f"{weights.shape} must have one entry a point ({n})")

    if top_parts is None:
        perm = np.arange(n, dtype=np.int64)
        sizes_top = np.zeros(0, dtype=np.int64)
    else:
        perm = np.ascontiguousarray(np.concatenate(top_parts), dtype=np.int64)
        sizes_top = np.asarray([len(p) for p in top_parts], dtype=np.int64)
        if len(perm) != n or not np.array_equal(np.sort(perm), np.arange(n)):
            raise ValueError("the partition must hold every point once")

    lib = _load()

    h = lib.ct_build(
        _ptr(coords, ctypes.c_double), _ptr(point_radii, ctypes.c_double),
        _ptr(weights, ctypes.c_double), dim, n, int(nb_children), int(mls),
        int(minimal_depth), int(direction_kind), int(split_kind),
        _ptr(sizes_top, ctypes.c_int64), len(sizes_top),
        _ptr(perm, ctypes.c_int64))
    try:
        nn = lib.ct_nb_nodes(h)
        npart = lib.ct_nb_partitions(h)
        offsets, sizes, depths, parents, cstart, ccount = (
            np.empty(nn, dtype=np.int64) for _ in range(6))
        centers = np.empty((nn, dim), dtype=np.float64)
        radii = np.empty(nn, dtype=np.float64)
        partition = np.empty(npart, dtype=np.int64)
        lib.ct_copy(h, *(_ptr(a, ctypes.c_int64) for a in
                         (offsets, sizes, depths, parents, cstart, ccount)),
                    _ptr(centers, ctypes.c_double),
                    _ptr(radii, ctypes.c_double),
                    _ptr(partition, ctypes.c_int64))
    finally:
        lib.ct_free(h)
    return (offsets, sizes, depths, parents, cstart, ccount, centers, radii,
            partition, perm)
