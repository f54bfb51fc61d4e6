"""The aligned low-rank layout that kernel K1-al reads (ops/matvec.py
`align_lowrank`), against the reference's, on the CPU.

* `align_lowrank(data, 128)` on the reference's own bucket arrays gives
  exactly the reference's arrays (its lane count is 128): shifted factors,
  rounded offsets, mirror flags, untouched dense buckets.
* The plain version of K1 on the `ALIGN_LANE` layout equals the product
  of the canonical layout to 1e-12 in f64 (the aligned windows only add
  zero columns), trans N / T, storage N, S-L, S-U.
* `HMatrix._product_data` follows `config.matvec_aligned_layout` for a
  float32 operator: the bucket table follows the layout after the knob
  flips, recompression and deepcopy drop or separate the cached layout,
  and every product equals the canonical one.

The reference assembles through its host-generator path (no XLA compile).
"""

import copy

import jax
import numpy as np
import pytest
import torch

import htool_python_torch as T
import htool_python_tpu as H
from htool_python_torch import interop
from htool_python_torch.config import get_config
from htool_python_torch.ops import matvec as port_mv
from htool_python_tpu.ops import matvec as ref_mv
from test_torch_complex import (ReferenceHostGenerator, clusters, one_thread,  # noqa: F401
                                port_operator, sphere)

_SYMS = [("N", "N"), ("S", "L"), ("S", "U")]
_N = 400


def reference_operator(symmetry, UPLO, dtype):
    points = sphere(_N)
    d = np.linalg.norm(points[:, :, None] - points[:, None, :], axis=0)
    ref_cluster, port_cluster = clusters(points)
    hb = H.HMatrixTreeBuilder(1e-4, 10.0, symmetry, UPLO)
    hb.set_dtype(dtype)
    hm = hb.build(ReferenceHostGenerator(1.0 / (0.1 + d)), ref_cluster,
                  ref_cluster)
    return hm, port_cluster


@pytest.fixture(scope="module")
def f64_operators():
    return {sym: reference_operator(*sym, np.float64) for sym in _SYMS}


def _port_data(hm):
    return interop.from_reference_data(
        jax.tree_util.tree_map(np.asarray, hm._data), "cpu")


@pytest.mark.parametrize("symmetry,UPLO", _SYMS)
def test_align_lowrank_128_equals_reference(f64_operators, symmetry, UPLO):
    hm = f64_operators[(symmetry, UPLO)][0]
    ref = jax.tree_util.tree_map(np.asarray,
                                 ref_mv.align_lowrank(hm._data)["aligned"])
    port = port_mv.align_lowrank(_port_data(hm), 128)
    assert port_mv.is_aligned(port) and not port_mv.is_aligned(
        _port_data(hm))
    assert len(port["lr"]) == len(ref["lr"]) > 0
    for mine, theirs in zip(port["lr"] + port["dense"],
                            ref["lr"] + ref["dense"]):
        assert len(mine) == len(theirs)
        for a, b in zip(mine, theirs):
            assert tuple(a.shape) == b.shape
            assert np.array_equal(a.numpy(), b)


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("trans", ["N", "T"])
@pytest.mark.parametrize("symmetry,UPLO", _SYMS)
def test_plain_product_of_aligned_layout(f64_operators, symmetry, UPLO,
                                         trans, k):
    hm = f64_operators[(symmetry, UPLO)][0]
    data = _port_data(hm)
    aligned = port_mv.align_lowrank(data, port_mv.ALIGN_LANE)
    for (Ut, V, t, s, _), (Ua, Va, ta, sa, _) in zip(data["lr"],
                                                     aligned["lr"]):
        assert not (ta % port_mv.ALIGN_LANE).any()
        assert not (sa % port_mv.ALIGN_LANE).any()
        assert Ua.shape[2] % port_mv.ALIGN_LANE == 0
        assert Ua.shape[2] >= Ut.shape[2] + port_mv.ALIGN_LANE
    L, n = hm._pad_len, hm.shape[0]
    x = torch.zeros((L, k), dtype=torch.float64)
    x[:n] = torch.as_tensor(np.random.RandomState(k).rand(n, k))
    y = port_mv.apply_hmatrix_padded(data, x, L, trans, symmetry)
    y_al = port_mv.apply_hmatrix_padded(aligned, x, L, trans, symmetry)
    assert float((y_al - y).abs().max() / y.abs().max()) < 1e-12


def test_hmatrix_layout_follows_the_knob():
    cfg = get_config()
    hm_ref, port_cluster = reference_operator("S", "L", np.float32)
    hm = port_operator(hm_ref, port_cluster)
    x = np.random.RandomState(2).rand(_N).astype(np.float32)
    X = np.random.RandomState(3).rand(_N, 3).astype(np.float32)
    canonical = hm * x, hm @ X, hm.matvec(x, "T")

    def products(h):
        return h * x, h @ X, h.matvec(x, "T")

    def same(ys, zs):
        for y, z in zip(ys, zs):
            assert np.abs(y - z).max() <= 1e-6 * np.abs(z).max()

    assert not hm._bucket_table().aligned
    cfg.matvec_aligned_layout = True
    try:
        data = hm._product_data()
        assert port_mv.is_aligned(data) and data is hm._product_data()
        assert hm._bucket_table().aligned
        same(products(hm), canonical)
        twin = copy.deepcopy(hm)
        assert twin._aligned is not hm._aligned
        assert twin._aligned["lr"] is not hm._aligned["lr"]
        assert twin._aligned["lr"][0][0] is hm._aligned["lr"][0][0]
        same(products(twin), canonical)
        T.recompression(twin)
        assert twin._aligned is None and twin._table is None
        recompressed = products(twin)  # the new factors' aligned layout
        assert twin._aligned["lr"][0][0] is not hm._aligned["lr"][0][0]
        assert twin._bucket_table().aligned
        cfg.matvec_aligned_layout = False
        same(recompressed, products(twin))
        cfg.matvec_aligned_layout = True
        # only float32 operators take the aligned layout
        h64 = port_operator(*reference_operator("N", "N", np.float64))
        assert not port_mv.is_aligned(h64._product_data())
    finally:
        cfg.matvec_aligned_layout = False
    assert not port_mv.is_aligned(hm._product_data())
    assert not hm._bucket_table().aligned
    same(products(hm), canonical)
