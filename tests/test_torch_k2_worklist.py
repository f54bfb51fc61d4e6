"""Kernel K2's work list (ops/matvec.py `work_list`) on the CPU.

K2 is K1's body on complex64 (csrc/hmatrix_product.cu): it walks the same
kind of work list, block slices of at most WORK_ROWS_COMPLEX (32) rows,
with one conjugation flag per direction of a block (ops/matvec.py
`conj_flags`).  Checked here:

* the complex work list covers every stored entry exactly once, storage
  N, S-L, H-L and H-U, and its byte total is `stored_bytes`;
* the item records the kernel reads name each slice at 8-byte elements;
* the plain walk of the list (`apply_work_list`, conjugating as the
  kernel does) equals the reference's `apply_hmatrix_padded` in
  complex128 to 1e-12, trans N / T / C x the four storages x k in {1, 3,
  9}, also on blocks split into several items; and the reference's
  complex Pallas kernel (interpreter, complex64) to 1e-5 on two cases;
* P4's timed form (a caller's fault counter, nothing read per call)
  raises at its check, and its one-call form still raises at once.

The reference assembles through its host-generator path (no XLA
compile).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from htool_python_torch import interop
from htool_python_torch.ops import cuda_matvec
from htool_python_torch.ops import matvec as port_mv
from htool_python_torch.profiling import bucket_variants as bv
from htool_python_tpu.ops import matvec as ref_mv
from htool_python_tpu.ops.matvec import split_planes
from htool_python_tpu.ops.pallas_matvec import apply_hmatrix_pallas_complex
from test_torch_complex import one_thread  # noqa: F401 (fixture)
from test_torch_complex import random_pad, reference_complex_operator
from test_torch_k1_worklist import _coverage

_STORAGES = [("N", "N"), ("S", "L"), ("H", "L"), ("H", "U")]


def _port_data(hm):
    return interop.from_reference_data(
        jax.tree_util.tree_map(np.asarray, hm._data), "cpu")


@pytest.fixture(scope="module")
def operators():
    """{(symmetry, UPLO): reference complex128 H-matrix}, n = 200."""
    return {sym: reference_complex_operator(*sym, np.complex128, eps=1e-6,
                                            n=200)[0]
            for sym in _STORAGES}


def _synthetic(symmetry, seed=0):
    """Complex128 buckets wider than WORK_ROWS_COMPLEX: dense 160 x 64
    blocks (5 row items each) and rank-70 low-rank blocks (3 rank items
    each); random mirror flags under symmetric or hermitian storage."""
    rng = np.random.RandomState(seed)
    L = 768

    def c(*shape):
        return torch.as_tensor(rng.randn(*shape) + 1j * rng.randn(*shape))

    def meta(nb, pt, ps):
        mirror = rng.rand(nb) < 0.5
        return (torch.as_tensor(rng.randint(0, L - pt, nb), dtype=torch.int32),
                torch.as_tensor(rng.randint(0, L - ps, nb), dtype=torch.int32),
                torch.as_tensor(mirror & (symmetry != "N")))

    return {"dense": [(c(3, 160, 64), *meta(3, 160, 64))],
            "lr": [(c(2, 70, 32), c(2, 70, 96), *meta(2, 32, 96))]}, L


@pytest.mark.parametrize("symmetry,UPLO", _STORAGES)
def test_complex_work_list_covers_every_entry_once(operators, symmetry,
                                                   UPLO):
    data = _port_data(operators[(symmetry, UPLO)])
    assert all(e[0].is_complex() for e in data["dense"] + data["lr"])
    wl = port_mv.work_list(data)
    assert all((s == 1).all() for s in _coverage(data, wl))
    assert int(wl.nbytes.sum()) == port_mv.stored_bytes(data)
    assert (np.diff(wl.nbytes) <= 0).all()  # largest first
    assert ((wl.items[:, 3] - wl.items[:, 2])
            <= port_mv.WORK_ROWS_COMPLEX).all()
    assert sorted(map(tuple, wl.items)) == sorted(map(tuple, wl.by_bucket))
    # the table builds it for complex data too
    table = cuda_matvec.BucketTable(data, "cpu")
    assert table.dtype == torch.complex128
    assert np.array_equal(table.work.items, wl.items)


@pytest.mark.parametrize("case", ["H-L", "synthetic"])
def test_item_records_at_8_byte_elements(operators, case):
    """complex64 records: every slice's first factor rows by address, at
    8 bytes an element."""
    if case == "synthetic":
        data = _synthetic("H")[0]
    else:
        data = _port_data(operators[("H", "L")])
    data = {kind: [tuple(t.to(torch.complex64) if t.is_complex() else t
                         for t in e) for e in data[kind]]
            for kind in ("dense", "lr")}
    wl = port_mv.work_list(data)
    if case == "synthetic":  # 5 row items per dense block, 3 per rank-70
        assert len(wl.items) == 3 * 5 + 2 * 3
    rec = cuda_matvec._item_records(data, wl.items, "cpu").numpy()
    buckets = [e for e in data["dense"] + data["lr"] if e[0].shape[0]]
    n_dense = sum(1 for e in data["dense"] if e[0].shape[0])
    for i, (b, blk, lo, hi) in enumerate(wl.items.tolist()):
        entry = buckets[b]
        assert entry[0].element_size() == 8
        assert rec[i, 0] == entry[0][blk, lo].data_ptr()
        assert rec[i, 0] == (entry[0].data_ptr()
                             + 8 * (blk * entry[0].shape[1] + lo)
                             * entry[0].shape[2])
        if b >= n_dense:
            assert rec[i, 1] == entry[1][blk, lo].data_ptr()


def _check_walk(data, L, n, trans, symmetry, k, reference):
    x = random_pad(L, n, k, seed=k)
    y_ref = reference(jnp.asarray(x))
    y = port_mv.apply_work_list(data, port_mv.work_list(data),
                                torch.as_tensor(x), L, trans,
                                symmetry).numpy()
    assert np.linalg.norm(y - y_ref) <= 1e-12 * np.linalg.norm(y_ref)


@pytest.mark.parametrize("k", [1, 3, 9])
@pytest.mark.parametrize("trans", ["N", "T", "C"])
@pytest.mark.parametrize("symmetry,UPLO", _STORAGES)
def test_complex_walk_matches_reference(operators, symmetry, UPLO, trans, k):
    hm = operators[(symmetry, UPLO)]
    _check_walk(_port_data(hm), hm._pad_len, hm.shape[0], trans, symmetry, k,
                lambda x: np.asarray(ref_mv.apply_hmatrix_padded(
                    hm._data, x, hm._pad_len, trans, symmetry)))


@pytest.mark.parametrize("trans", ["N", "T", "C"])
@pytest.mark.parametrize("symmetry", ["S", "H"])
def test_split_complex_blocks_match_reference(symmetry, trans):
    data, L = _synthetic(symmetry)
    tree = {kind: [tuple(t.numpy() for t in e) for e in data[kind]]
            for kind in ("dense", "lr")}
    _check_walk(data, L, L, trans, symmetry, 3,
                lambda x: np.asarray(ref_mv.apply_hmatrix_padded(
                    tree, x, L, trans, symmetry)))


@pytest.mark.parametrize("symmetry,UPLO,trans,k",
                         [("H", "L", "C", 3), ("N", "N", "T", 1)])
def test_complex_walk_matches_pallas_c64(symmetry, UPLO, trans, k):
    """The walk in complex64 against the reference's complex Pallas kernel
    in interpret mode (as tests/test_torch_complex_pallas.py runs it): f32
    sums in other orders, so 1e-5 relative."""
    hm = reference_complex_operator(symmetry, UPLO, np.complex64, eps=1e-4,
                                    n=200)[0]
    data = _port_data(hm)
    L, n = hm._pad_len, hm.shape[0]
    x = random_pad(L, n, k, seed=k, dtype=np.complex64)
    y_pallas = np.asarray(apply_hmatrix_pallas_complex(
        split_planes(hm._data)["cplanes"], jnp.asarray(x), L, trans,
        symmetry, interpret=True))
    y = port_mv.apply_work_list(data, port_mv.work_list(data),
                                torch.as_tensor(x), L, trans, symmetry)
    assert y.dtype == torch.complex64
    assert (np.linalg.norm(y.numpy() - y_pallas)
            <= 1e-5 * np.linalg.norm(y_pallas))


@pytest.mark.parametrize("trans,sym,want", [
    ("N", "N", (False, False)), ("N", "S", (False, False)),
    ("N", "H", (False, True)), ("T", "S", (False, False)),
    ("T", "H", (True, False)), ("C", "N", (True, True)),
    ("C", "S", (True, True)), ("C", "H", (False, True))])
def test_conj_flags_per_direction(trans, sym, want):
    assert port_mv.conj_flags(trans, sym) == want


def test_p4_counter_form_raises_at_its_check():
    x = torch.arange(20, dtype=torch.float32).reshape(2, 10)
    idx = torch.tensor([[0, 9, 3], [1, 10, -1]], dtype=torch.int32)
    fault = bv.fault_counter("cpu")
    for _ in range(2):  # no raise per call
        out = bv.take_along_axis(x, idx, fault=fault)
    assert out.tolist() == [[0.0, 9.0, 3.0], [11.0, 0.0, 0.0]]
    assert int(fault) == 4
    with pytest.raises(IndexError, match="4 indices"):
        bv.check_fault(fault, 10)
    bv.check_fault(bv.fault_counter("cpu"), 10)  # a clean count passes
    # the one-call form raises at once
    with pytest.raises(IndexError):
        bv.take_along_axis(x, idx)
    with pytest.raises(ValueError):  # a counter of the wrong type
        bv.take_along_axis(x, idx, fault=torch.zeros(1))
