"""Recompression: the port's `recompression` against the reference's, on
identical input (CPU).

The reference assembles a float64 and a complex128 operator on the unit
sphere at eps 1e-6 (its host-generator path, tests/test_torch_complex.py);
both packages then recompress the same arrays at 1e-4:

* the SVD-form path (the default after assembly): equal ranks per block,
  equal re-classed buckets, and densified operators within 1e-12;
* the streaming QR + SVD path (`_lr_svd_form = False`): rank sums within
  the reference's own slack between its two paths (tests/test_hmatrix.py)
  and operators within 1e-10;
* the per-leaf callback path: the same callback gives the same operator.

Also: deep copies (and a per-partition list) recompress independently, a
product after recompression matches the densified operator, and the port's
own assemblies are SVD pairs, so its two paths agree on them too.
"""

import copy

import numpy as np
import pytest
import torch

import htool_python_torch as T
import htool_python_tpu as H
from htool_python_torch.models.kernels import hermitian_phase_kernel as pk
from htool_python_torch.models.kernels import inverse_distance_kernel as pik
from test_torch_complex import ReferenceHostGenerator, clusters, \
    hermitian_oracle, port_operator, sphere
from test_torch_complex import one_thread  # noqa: F401 (fixture)

_DTYPES = [np.float64, np.complex128]
_ASSEMBLY_EPS, _EPS = 1e-6, 1e-4
_N = 800


def _problem(dtype):
    """(points, port generator, dense oracle)."""
    points = sphere(_N)
    if dtype == np.complex128:
        return (points, T.KernelGenerator(pk(10.0), points, points,
                                          is_complex=True, device="cpu"),
                hermitian_oracle(points))
    d = np.linalg.norm(points[:, :, None] - points[:, None, :], axis=0)
    return (points, T.KernelGenerator(pik(0.1), points, points, device="cpu"),
            1.0 / (0.1 + d))


@pytest.fixture(scope="module")
def reference_operators():
    out = {}
    for dtype in _DTYPES:
        points, _, A = _problem(dtype)
        ref_cluster, port_cluster = clusters(points, 32)
        hb = H.HMatrixTreeBuilder(_ASSEMBLY_EPS, 10.0, "N", "N")
        hb.set_dtype(dtype)
        out[dtype] = (hb.build(ReferenceHostGenerator(A), ref_cluster,
                               ref_cluster), port_cluster)
    return out


def _pair(reference_operators, dtype):
    """(a deep copy of the reference operator, the port's copy of it)."""
    ref, port_cluster = reference_operators[dtype]
    return copy.deepcopy(ref), port_operator(ref, port_cluster)


def _rank_sum(h):
    return sum(int(np.sum(r)) for r in h._lr_ranks)


def _stored_bytes(h):
    return sum(t.numel() * t.element_size()
               for e in h._data["dense"] + h._data["lr"] for t in e[:-3])


def _dense_rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("dtype", _DTYPES)
def test_svd_form_recompression_matches_reference(reference_operators,
                                                  dtype):
    ref, port = _pair(reference_operators, dtype)
    assert ref._lr_svd_form and port._lr_svd_form
    bytes_before, rank_before = _stored_bytes(port), _rank_sum(port)
    H.recompression(ref, _EPS)
    T.recompression(port, _EPS)
    assert port._lr_svd_form
    assert _rank_sum(port) < rank_before  # it actually recompressed
    assert _stored_bytes(port) < bytes_before
    assert len(port.plan.lowrank_buckets) == len(ref.plan.lowrank_buckets)
    for pb, rb, pr, rr in zip(port.plan.lowrank_buckets,
                              ref.plan.lowrank_buckets, port._lr_ranks,
                              ref._lr_ranks):
        assert (pb.pt, pb.ps) == (rb.pt, rb.ps)
        for name in ("t_off", "s_off", "t_sz", "s_sz", "mirror"):
            np.testing.assert_array_equal(getattr(pb, name),
                                          getattr(rb, name))
        np.testing.assert_array_equal(pr, rr)
    for (Ut, V, *_), (rUt, rV, *_) in zip(port._data["lr"], ref._data["lr"]):
        assert Ut.shape == np.asarray(rUt).shape
        assert V.shape == np.asarray(rV).shape
    assert _dense_rel(port.to_dense(), np.asarray(ref.to_dense())) <= 1e-12


@pytest.mark.parametrize("dtype", _DTYPES)
def test_streaming_recompression_matches_reference(reference_operators,
                                                   dtype):
    ref, port = _pair(reference_operators, dtype)
    ref._lr_svd_form = port._lr_svd_form = False
    rank_before = _rank_sum(port)
    H.recompression(ref, _EPS)
    T.openmp_recompression(port, _EPS)
    assert port._lr_svd_form  # the batched truncation leaves SVD pairs
    s_port, s_ref = _rank_sum(port), _rank_sum(ref)
    assert s_port < rank_before
    assert abs(s_port - s_ref) <= max(1, s_ref // 200)
    assert _dense_rel(port.to_dense(), np.asarray(ref.to_dense())) <= 1e-10


def _svd_callback(U, V, epsilon):
    """Re-truncate one leaf by the SVD of U V; keep leaves whose rank does
    not drop (returns None for them)."""
    u, s, vh = np.linalg.svd(U @ V, full_matrices=False)
    tail = np.cumsum((s * s)[::-1])[::-1]
    r = max(int(np.sum(tail > epsilon * epsilon * tail[0])), 1)
    if r >= U.shape[1]:
        return None
    return u[:, :r] * s[:r], vh[:r]


@pytest.mark.parametrize("dtype", _DTYPES)
def test_callback_recompression_matches_reference(reference_operators,
                                                  dtype):
    ref, port = _pair(reference_operators, dtype)
    H.recompression(ref, _EPS, _svd_callback)
    T.recompression(port, _EPS, _svd_callback)
    assert not port._lr_svd_form  # user factors: form unknown
    assert _rank_sum(port) == _rank_sum(ref)
    for pr, rr in zip(port._lr_ranks, ref._lr_ranks):
        np.testing.assert_array_equal(pr, rr)
    assert _dense_rel(port.to_dense(), np.asarray(ref.to_dense())) <= 1e-12
    with pytest.raises(ValueError, match="callback returned factors"):
        T.recompression(port, _EPS, lambda U, V, eps: (U[:-1], V))


def test_deepcopies_recompress_independently(reference_operators):
    _, port = _pair(reference_operators, np.complex128)
    dense = port.to_dense()
    twins = [copy.deepcopy(port), copy.deepcopy(port)]
    T.recompression(twins, _EPS)  # a list: one HMatrix per partition
    for twin in twins:
        assert twin._data["lr"] is not port._data["lr"]
        assert _rank_sum(twin) < _rank_sum(port)
        assert _dense_rel(twin.to_dense(), dense) <= 2 * _EPS
    np.testing.assert_array_equal(port.to_dense(), dense)


@pytest.mark.parametrize("dtype", _DTYPES)
def test_product_after_recompression_matches_to_dense(reference_operators,
                                                      dtype):
    _, port = _pair(reference_operators, dtype)
    n = port.shape[0]
    rng = np.random.RandomState(1)
    x = rng.rand(n, 2) + (1j * rng.rand(n, 2) if dtype == np.complex128
                          else 0)
    port.matvec(x)  # builds the bucket table of the assembled buckets
    assert port._table is not None
    T.recompression(port, _EPS)
    assert port._table is None  # it named the replaced buckets
    A = port.to_dense_in_user_numbering()
    for trans, At in (("N", A), ("T", A.T), ("C", A.conj().T)):
        y = port.matvec(x, trans)
        assert _dense_rel(y, At @ x) <= 1e-12


@pytest.mark.parametrize("dtype", _DTYPES)
def test_recompression_of_the_ports_own_assembly(dtype):
    """The port's assembly leaves SVD pairs (V with orthonormal rows, the
    rows of Ut orthogonal), so the O(bytes) trim and the streaming QR + SVD
    agree on its operators, and both stay within eps of the oracle."""
    points, port_gen, A = _problem(dtype)
    port_cluster = clusters(points, 32)[1]
    hb = T.HMatrixTreeBuilder(_ASSEMBLY_EPS, 10.0, "N", "N", device="cpu")
    hb.set_dtype(torch.complex128 if dtype == np.complex128
                 else torch.float64)
    hm = hb.build(port_gen, port_cluster, port_cluster)
    assert hm._lr_svd_form
    for (Ut, V, *_), r in zip(hm._data["lr"], hm._lr_ranks):
        live = (torch.arange(V.shape[1])[None, :]
                < torch.as_tensor(r)[:, None]).to(V.dtype)
        gram_v = V @ V.mH
        assert torch.allclose(gram_v, torch.diag_embed(live), atol=1e-12)
        gram_u = Ut.conj() @ Ut.transpose(1, 2)
        off = gram_u - torch.diag_embed(torch.diagonal(gram_u, dim1=1,
                                                       dim2=2))
        assert float(off.abs().max()) <= 1e-12 * float(gram_u.abs().max())
    fast, slow = copy.deepcopy(hm), copy.deepcopy(hm)
    slow._lr_svd_form = False
    T.recompression(fast, _EPS)
    T.recompression(slow, _EPS)
    s_fast, s_slow = _rank_sum(fast), _rank_sum(slow)
    assert s_fast < _rank_sum(hm)
    assert abs(s_fast - s_slow) <= max(1, s_slow // 200)
    for h in (fast, slow):
        D = h.to_dense_in_user_numbering()
        assert np.linalg.norm(D - A) <= 2 * _EPS * np.linalg.norm(A)
