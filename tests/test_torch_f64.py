"""The float64 / complex128 products (hmatrix_product_f64,
hmatrix_product_complex128; csrc/hmatrix_product_f64.cu) on the CPU.

The kernels run on the card only (tests/test_torch_gpu.py, chip_smoke.py
`f64_check`); here:

* the wrapper's dispatch: x and y take the promoted dtype of data and x;
  the data's dtype picks the kernel, or, for a float64 / complex128 x on
  float32 / complex64 data, the instantiation that reads the data as
  stored and computes in the wider type; a real operator takes a complex x
  through its real view; the f64 family raises NotImplementedError under
  the 'per_bucket' / 'seq' launch structures; other dtypes raise
  TypeError;
* the work list of f64 and complex128 data covers every stored entry once
  (64-row items for f64, 32 for complex128) and its item records name each
  slice at 8 / 16 bytes an element;
* the plain version (`apply_hmatrix_padded`, the kernels' yardstick) and
  the plain walk of the kernels' work list (`apply_work_list`) against the
  reference's `apply_hmatrix_padded` on the reference's own arrays, within
  1e-12, trans N / T (/ C) x storage x k in {1, 9, 65}; the arrays carry
  over bit for bit (`interop.from_reference_data`);
* the real view at float64 (`cuda_matvec._real_view`, as `_launch` takes
  a complex x on real data);
* the promoted products: the reference's `apply_hmatrix_padded` on its
  own float32 / complex64 arrays with a float64 / complex128 x (it
  promotes the operator) against the port's plain version and its plain
  walk of the work list on the same arrays, within 1e-12.

The reference assembles through its host-generator path (no XLA compile).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import htool_python_tpu as H
from htool_python_torch import interop
from htool_python_torch.ops import cuda_matvec
from htool_python_torch.ops import matvec as port_mv
from htool_python_tpu.ops import matvec as ref_mv
from test_torch_complex import (ReferenceHostGenerator, one_thread,  # noqa: F401
                                random_pad, reference_complex_operator)
from test_torch_k1_worklist import _coverage

F32, C64, F64, C128 = (torch.float32, torch.complex64, torch.float64,
                       torch.complex128)


@pytest.mark.parametrize("data,x,want", [
    (F32, F32, ("hmatrix_product", F32, False)),
    (F32, C64, ("hmatrix_product", C64, True)),
    (C64, F32, ("hmatrix_product_complex", C64, False)),
    (C64, C64, ("hmatrix_product_complex", C64, False)),
    (F64, F32, ("hmatrix_product_f64", F64, False)),
    (F64, F64, ("hmatrix_product_f64", F64, False)),
    (F64, C64, ("hmatrix_product_f64", C128, True)),
    (F64, C128, ("hmatrix_product_f64", C128, True)),
    (C128, F32, ("hmatrix_product_complex128", C128, False)),
    (C128, F64, ("hmatrix_product_complex128", C128, False)),
    (C128, C64, ("hmatrix_product_complex128", C128, False)),
    (C128, C128, ("hmatrix_product_complex128", C128, False)),
    (F32, F64, ("hmatrix_product_f64_from_f32", F64, False)),
    (F32, C128, ("hmatrix_product_f64_from_f32", C128, True)),
    (C64, F64, ("hmatrix_product_complex128_from_c64", C128, False)),
    (C64, C128, ("hmatrix_product_complex128_from_c64", C128, False)),
])
def test_dispatch(data, x, want):
    assert cuda_matvec.dispatch(data, x) == want
    assert want[0] in cuda_matvec.LAUNCH_COUNTS


@pytest.mark.parametrize("mode", ["per_bucket", "seq"])
def test_f64_kernels_have_one_launch_structure(mode):
    for dtype, x in ((F64, F64), (C128, C128), (F32, F64), (C64, C128)):
        with pytest.raises(NotImplementedError, match="one launch structure"):
            cuda_matvec.dispatch(dtype, x, mode)
    assert cuda_matvec.dispatch(F32, F32, mode)[0] == "hmatrix_product"
    assert cuda_matvec.PASS_COLS[F64] == 64
    assert cuda_matvec.PASS_COLS[C128] == 32


@pytest.mark.parametrize("dtype", [torch.int32, torch.bfloat16,
                                   torch.float16])
def test_other_dtypes_raise(dtype):
    with pytest.raises(TypeError, match="float64 or complex128"):
        cuda_matvec.dispatch(dtype, F64)
    with pytest.raises(TypeError, match="float64 or complex128"):
        cuda_matvec.dispatch(F64, dtype)


def _real_reference(symmetry, n=240, dtype=np.float64):
    points = np.random.RandomState(6).rand(3, n)
    d = np.linalg.norm(points[:, :, None] - points[:, None, :], axis=0)
    b = H.ClusterTreeBuilder()
    b.set_maximal_leaf_size(16)
    cluster = b.create_cluster_tree(points, 2)
    hb = H.HMatrixTreeBuilder(1e-6, 10.0, symmetry,
                              "L" if symmetry == "S" else "N")
    hb.set_dtype(dtype)
    return hb.build(ReferenceHostGenerator(1.0 / (0.1 + d)), cluster,
                    cluster)


_CASES = [("f64", "N"), ("f64", "S"), ("c128", "N"), ("c128", "H"),
          ("c128", "S")]


@pytest.fixture(scope="module")
def operators():
    out = {}
    for kind, sym in _CASES:
        if kind == "f64":
            out[kind, sym] = _real_reference(sym)
        else:
            out[kind, sym] = reference_complex_operator(
                sym, "L" if sym != "N" else "N", np.complex128, eps=1e-6,
                n=200)[0]
    return out


def _port_data(hm):
    return interop.from_reference_data(
        jax.tree_util.tree_map(np.asarray, hm._data), "cpu")


@pytest.mark.parametrize("kind,symmetry", _CASES)
def test_arrays_carry_over_bit_for_bit(operators, kind, symmetry):
    hm = operators[kind, symmetry]
    data = _port_data(hm)
    want = F64 if kind == "f64" else C128
    for ref_entry, entry in zip(hm._data["dense"] + hm._data["lr"],
                                data["dense"] + data["lr"]):
        for a, t in zip(ref_entry[:-3], entry[:-3]):
            assert t.dtype == want
            assert np.array_equal(np.asarray(a), t.numpy())


@pytest.mark.parametrize("kind,symmetry", _CASES + [("f64", "synthetic"),
                                                    ("c128", "synthetic")])
def test_records_cover_every_entry_once(operators, kind, symmetry):
    if symmetry == "synthetic":
        data = _synthetic(F64 if kind == "f64" else C128)
    else:
        data = _port_data(operators[kind, symmetry])
    size = 8 if kind == "f64" else 16
    rows = port_mv.WORK_ROWS if kind == "f64" else port_mv.WORK_ROWS_COMPLEX
    wl = port_mv.work_list(data)
    assert all((s == 1).all() for s in _coverage(data, wl))
    assert int(wl.nbytes.sum()) == port_mv.stored_bytes(data)
    assert ((wl.items[:, 3] - wl.items[:, 2]) <= rows).all()
    if symmetry == "synthetic":  # 192-row dense and rank-70 blocks split
        assert (wl.items[:, 3] - wl.items[:, 2]).max() == rows
    rec = cuda_matvec._item_records(data, wl.items, "cpu").numpy()
    buckets = [e for e in data["dense"] + data["lr"] if e[0].shape[0]]
    n_dense = sum(1 for e in data["dense"] if e[0].shape[0])
    for i, (b, blk, lo, hi) in enumerate(wl.items.tolist()):
        entry = buckets[b]
        assert entry[0].element_size() == size
        assert rec[i, 0] == (entry[0].data_ptr() + size * (
            blk * entry[0].shape[1] + lo) * entry[0].shape[2])
        assert rec[i, 3] & 0xFFFFFFFF == hi - lo
        if b >= n_dense:
            assert rec[i, 1] == entry[1][blk, lo].data_ptr()
            assert rec[i, 4] >> 32 == 2 * int(entry[-1][blk])
        else:
            assert rec[i, 1] == 0 and rec[i, 4] >> 32 & 1


def _synthetic(dtype, seed=0, L=768):
    """Buckets wider than an item: dense 192 x 64 blocks and rank-70
    low-rank blocks, random mirror flags."""
    rng = np.random.RandomState(seed)

    def a(*shape):
        v = rng.randn(*shape)
        return torch.as_tensor(v + 1j * rng.randn(*shape) if dtype.is_complex
                               else v).to(dtype)

    def meta(nb, pt, ps):
        return (torch.as_tensor(rng.randint(0, L - pt, nb), dtype=torch.int32),
                torch.as_tensor(rng.randint(0, L - ps, nb), dtype=torch.int32),
                torch.as_tensor(rng.rand(nb) < 0.5))

    return {"dense": [(a(3, 192, 64), *meta(3, 192, 64))],
            "lr": [(a(2, 70, 32), a(2, 70, 96), *meta(2, 32, 96))]}


@pytest.mark.parametrize("k", [1, 9, 65])
@pytest.mark.parametrize("kind,symmetry", _CASES)
def test_plain_products_match_reference(operators, kind, symmetry, k):
    hm = operators[kind, symmetry]
    data = _port_data(hm)
    L, n = hm._pad_len, hm.shape[0]
    if kind == "f64":
        x = np.zeros((L, k))
        x[:n] = np.random.RandomState(k).rand(n, k)
    else:
        x = random_pad(L, n, k, seed=k)
    for trans in ("N", "T") if kind == "f64" else ("N", "T", "C"):
        y_ref = np.asarray(ref_mv.apply_hmatrix_padded(
            hm._data, jnp.asarray(x), L, trans, symmetry))
        x_t = torch.as_tensor(x)
        y = port_mv.apply_hmatrix_padded(data, x_t, L, trans, symmetry)
        assert y.dtype == (F64 if kind == "f64" else C128)
        y_walk = port_mv.apply_work_list(data, port_mv.work_list(data), x_t,
                                         L, trans, symmetry)
        for out in (y, y_walk):
            assert (np.linalg.norm(out.numpy() - y_ref)
                    <= 1e-12 * np.linalg.norm(y_ref))


def test_real_view_at_float64(operators):
    """A real f64 operator on a complex128 x: H (a + ib) = H a + i H b over
    the (L, 2k) float64 view, as the f64 kernel takes a complex x."""
    hm = operators["f64", "S"]
    data = _port_data(hm)
    L, n = hm._pad_len, hm.shape[0]
    x = torch.as_tensor(random_pad(L, n, 3, seed=3, dtype=np.complex128))

    xr = cuda_matvec._real_view(x)
    assert xr.dtype == F64 and xr.shape == (L, 6)
    y = torch.zeros((L, 3), dtype=C128)
    cuda_matvec._real_view(y).add_(
        port_mv.apply_hmatrix_padded(data, xr, L, "N", "S"))
    y_plain = port_mv.apply_hmatrix_padded(data, x, L, "N", "S")
    assert y.dtype == C128
    assert torch.linalg.norm(y - y_plain) <= 1e-14 * torch.linalg.norm(
        y_plain)


_PROMOTED = [("f32", "N"), ("f32", "S"), ("c64", "N"), ("c64", "H"),
             ("c64", "S")]


@pytest.fixture(scope="module")
def narrow_operators():
    """The reference's float32 / complex64 operators of `operators`."""
    out = {}
    for kind, sym in _PROMOTED:
        if kind == "f32":
            out[kind, sym] = _real_reference(sym, dtype=np.float32)
        else:
            out[kind, sym] = reference_complex_operator(
                sym, "L" if sym != "N" else "N", np.complex64, eps=1e-6,
                n=200)[0]
    return out


@pytest.mark.parametrize("k", [1, 9])
@pytest.mark.parametrize("kind,symmetry", _PROMOTED)
def test_promoted_products_match_reference(narrow_operators, kind, symmetry,
                                           k):
    """float32 / complex64 data with a float64 / complex128 x: the
    reference promotes the operator (its ops/matvec.py:111); the port's
    plain version and the plain walk of the kernels' work list, on the
    same arrays as stored, give its product within 1e-12, in the wider
    dtype, which the kernels' float-storage instantiations compute."""
    hm = narrow_operators[kind, symmetry]
    data = _port_data(hm)
    assert data["dense"][0][0].dtype == (F32 if kind == "f32" else C64)
    L, n = hm._pad_len, hm.shape[0]
    if kind == "f32":
        x = np.zeros((L, k))
        x[:n] = np.random.RandomState(k).rand(n, k)
    else:
        x = random_pad(L, n, k, seed=k, dtype=np.complex128)
    want = F64 if kind == "f32" else C128
    assert cuda_matvec.dispatch(data["dense"][0][0].dtype,
                                torch.as_tensor(x).dtype)[1] == want
    wl = port_mv.work_list(data)
    for trans in ("N", "T") if kind == "f32" else ("N", "T", "C"):
        y_ref = np.asarray(ref_mv.apply_hmatrix_padded(
            hm._data, jnp.asarray(x), L, trans, symmetry))
        assert y_ref.dtype == np.dtype(str(want).split(".")[1])
        x_t = torch.as_tensor(x)
        y = port_mv.apply_hmatrix_padded(data, x_t, L, trans, symmetry)
        y_walk = port_mv.apply_work_list(data, wl, x_t, L, trans, symmetry)
        for out in (y, y_walk):
            assert out.dtype == want
            assert (np.linalg.norm(out.numpy() - y_ref)
                    <= 1e-12 * np.linalg.norm(y_ref))
