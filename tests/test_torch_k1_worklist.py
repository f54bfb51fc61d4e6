"""Kernel K1's work list (ops/matvec.py `work_list`) on the CPU.

K1 walks block slices of at most WORK_ROWS rows (rank rows of a low-rank
block, rows of a dense one).  Checked here, in float64:

* the list covers every stored entry exactly once, its byte total is
  `stored_bytes`, and its items are ordered largest first;
* the plain walk of the list (`apply_work_list`: the same items in the
  same split) equals the plain version `apply_hmatrix_padded` and the
  reference's `apply_hmatrix` on the reference's own bucket arrays to
  1e-12, trans N / T, storage N / S, k in {1, 3, 8, 9, 33, 128}, in the
  canonical and the aligned layout;
* blocks wider than WORK_ROWS in rows and in rank split into several items
  and still give the same product;
* a factor run that is not 16-byte aligned, or not contiguous, makes
  BucketTable raise.

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
from htool_python_torch.profiling import k1_variants
from htool_python_tpu.ops import matvec as ref_mv
from test_torch_complex import (ReferenceHostGenerator, clusters, one_thread,  # noqa: F401
                                sphere)

_SYMS = [("N", "N"), ("S", "L")]
_KS = [1, 3, 8, 9, 33, 128]


def _reference(symmetry, UPLO):
    points = sphere(400)
    d = np.linalg.norm(points[:, :, None] - points[:, None, :], axis=0)
    ref_cluster, _ = clusters(points)
    hb = H.HMatrixTreeBuilder(1e-4, 10.0, symmetry, UPLO)
    hb.set_dtype(np.float64)
    return hb.build(ReferenceHostGenerator(1.0 / (0.1 + d)), ref_cluster,
                    ref_cluster)


@pytest.fixture(scope="module")
def operators():
    """{storage: (reference H-matrix, the port's data of its arrays)}."""
    out = {}
    for sym in _SYMS:
        hm = _reference(*sym)
        out[sym[0]] = (hm, interop.from_reference_data(
            jax.tree_util.tree_map(np.asarray, hm._data), "cpu"))
    return out


def _synthetic(symmetry="S", seed=0):
    """Buckets wider than WORK_ROWS: dense 192 x 128 blocks (3 row items
    each) and rank-70 low-rank blocks (2 rank items each), float64; random
    mirror flags under symmetric storage."""
    rng = np.random.RandomState(seed)
    L = 1024

    def meta(nb, pt, ps):
        mirror = rng.rand(nb) < 0.5
        return (torch.as_tensor(rng.randint(0, L - pt, nb), dtype=torch.int32),
                torch.as_tensor(rng.randint(0, L - ps, nb), dtype=torch.int32),
                torch.as_tensor(mirror & (symmetry != "N")))

    dense = [(torch.as_tensor(rng.randn(3, 192, 128)), *meta(3, 192, 128))]
    lr = [(torch.as_tensor(rng.randn(4, 70, 64)),
           torch.as_tensor(rng.randn(4, 70, 96)), *meta(4, 64, 96)),
          (torch.as_tensor(rng.randn(2, 5, 32)),
           torch.as_tensor(rng.randn(2, 5, 32)), *meta(2, 32, 32))]
    return {"dense": dense, "lr": lr}, L


def _coverage(data, wl):
    """Per stored row of every non-empty bucket, how many items cover it."""
    buckets = [e for e in data["dense"] + data["lr"] if e[0].shape[0]]
    seen = [np.zeros(e[0].shape[:2], dtype=int) for e in buckets]
    for b, blk, lo, hi in wl.items:
        seen[b][blk, lo:hi] += 1
    return seen


@pytest.mark.parametrize("case", ["N", "S", "aligned", "synthetic"])
def test_work_list_covers_every_entry_once(operators, case):
    if case == "synthetic":
        data = _synthetic()[0]
    elif case == "aligned":
        data = port_mv.align_lowrank(operators["N"][1], port_mv.ALIGN_LANE)
    else:
        data = operators[case][1]
    wl = port_mv.work_list(data)
    assert all((s == 1).all() for s in _coverage(data, wl))
    assert int(wl.nbytes.sum()) == port_mv.stored_bytes(data)
    assert (np.diff(wl.nbytes) <= 0).all()  # largest first
    assert ((wl.items[:, 3] - wl.items[:, 2]) <= port_mv.WORK_ROWS).all()
    # the same items in bucket order, each bucket's a contiguous range
    assert sorted(map(tuple, wl.items)) == sorted(map(tuple, wl.by_bucket))
    for b, (first, count) in enumerate(wl.ranges):
        assert (wl.by_bucket[first:first + count, 0] == b).all()
    assert int(wl.ranges[:, 1].sum()) == len(wl.items)
    if case == "synthetic":  # 3 row items per dense block, 2 per rank-70
        assert len(wl.items) == 3 * 3 + 4 * 2 + 2


@pytest.mark.parametrize("k", _KS)
@pytest.mark.parametrize("trans", ["N", "T"])
@pytest.mark.parametrize("symmetry", ["N", "S"])
def test_plain_walk_matches_reference(operators, symmetry, trans, k):
    hm, data = operators[symmetry]
    L, n = hm._pad_len, hm.shape[0]
    x = np.zeros((L, k))
    x[:n] = np.random.RandomState(k).rand(n, k)
    y_ref = np.asarray(ref_mv.apply_hmatrix(hm._data, jnp.asarray(x), L,
                                            trans, symmetry))
    x_t = torch.as_tensor(x)
    y_plain = port_mv.apply_hmatrix_padded(data, x_t, L, trans, symmetry)
    for layout in (data, port_mv.align_lowrank(data, port_mv.ALIGN_LANE)):
        y = port_mv.apply_work_list(layout, port_mv.work_list(layout), x_t,
                                    L, trans, symmetry).numpy()
        assert np.linalg.norm(y - y_ref) <= 1e-12 * np.linalg.norm(y_ref)
        assert (np.linalg.norm(y - y_plain.numpy())
                <= 1e-12 * np.linalg.norm(y_plain.numpy()))


@pytest.mark.parametrize("k", [1, 9])
@pytest.mark.parametrize("trans", ["N", "T"])
@pytest.mark.parametrize("symmetry", ["N", "S"])
def test_split_blocks_match_plain_version(symmetry, trans, k):
    data, L = _synthetic(symmetry)
    x = torch.as_tensor(np.random.RandomState(k).rand(L, k))
    y_plain = port_mv.apply_hmatrix_padded(data, x, L, trans, symmetry)
    y = port_mv.apply_work_list(data, port_mv.work_list(data), x, L, trans,
                                symmetry)
    assert (torch.linalg.norm(y - y_plain)
            <= 1e-12 * torch.linalg.norm(y_plain))
    # the reference on the same arrays
    tree = {"dense": [tuple(np.asarray(t) for t in e) for e in data["dense"]],
            "lr": [tuple(np.asarray(t) for t in e) for e in data["lr"]]}
    y_ref = np.asarray(ref_mv.apply_hmatrix(tree, jnp.asarray(x.numpy()), L,
                                            trans, symmetry))
    assert (np.linalg.norm(y.numpy() - y_ref)
            <= 1e-12 * np.linalg.norm(y_ref))


@pytest.mark.parametrize("case", ["S", "synthetic"])
def test_item_records_name_each_slice(operators, case):
    """The records the kernel reads (48 bytes an item): each names its
    slice's first factor rows by address, its offsets (a dense slice's
    target moved to its first row), rows, widths and flags."""
    data = _synthetic()[0] if case == "synthetic" else operators[case][1]
    wl = port_mv.work_list(data)
    rec = cuda_matvec._item_records(data, wl.items, "cpu").numpy()
    assert rec.shape == (len(wl.items), 6) and not rec[:, 5].any()
    halves = rec[:, 2:5].view(np.int32).reshape(-1, 6)  # little-endian
    t, s, R, pt, ps, flags = halves.T
    buckets = [e for e in data["dense"] + data["lr"] if e[0].shape[0]]
    n_dense = sum(1 for e in data["dense"] if e[0].shape[0])
    for i, (b, blk, lo, hi) in enumerate(wl.items):
        entry = buckets[b]
        dense = b < n_dense
        first = entry[0][blk, lo]  # the slice's first row of D or Ut
        assert rec[i, 0] == first.data_ptr()
        assert rec[i, 1] == (0 if dense else entry[1][blk, lo].data_ptr())
        assert t[i] == int(entry[-3][blk]) + (lo if dense else 0)
        assert s[i] == int(entry[-2][blk]) and R[i] == hi - lo
        assert (pt[i], ps[i]) == ((entry[0].shape[1], entry[0].shape[2])
                                  if dense else (entry[0].shape[2],
                                                 entry[1].shape[2]))
        assert flags[i] == int(dense) + 2 * bool(entry[-1][blk])


@pytest.mark.parametrize("name", sorted(k1_variants.VARIANTS))
def test_k1_variants_edit_the_shipped_source(name):
    """Every variant that profiling/k1_variants.py times on the card is an
    edit that still applies to the shipped kernel source."""
    from htool_python_torch.ops.cuda_build import CSRC

    source = (CSRC / "hmatrix_product.cu").read_text()
    edited = k1_variants.variant_source(source, name)
    assert (edited == source) == (name == "shipped")


@pytest.mark.parametrize("fault", ["offset", "strided"])
def test_misaligned_factor_run_raises(operators, fault):
    data = operators["N"][1]
    Ut, V, t_off, s_off, mirror = data["lr"][0]
    if fault == "offset":  # contiguous, but starting 8 bytes past 16
        buf = torch.zeros(Ut.numel() + 1, dtype=Ut.dtype)
        bad = buf[1:].view(Ut.shape)
        bad.copy_(Ut)
        assert bad.data_ptr() % 16
    else:  # every other rank row: not one run
        bad = torch.cat([Ut, Ut], 1)[:, ::2]
        assert not bad.is_contiguous()
    broken = {"dense": data["dense"],
              "lr": [(bad, V, t_off, s_off, mirror)] + data["lr"][1:]}
    with pytest.raises(ValueError, match="16 bytes"):
        cuda_matvec.BucketTable(broken, "cpu")
    cuda_matvec.BucketTable(data, "cpu")  # the operator's own runs pass
