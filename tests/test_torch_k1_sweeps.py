"""K1's attribution sweeps (htool_python_torch/profiling/k1_sweeps.py)
against the reference's scripts tools/profile_matvec9.py, 9b, 9d, 9e, 9f
and 9g (CPU).

The scripts draw their cases inside `main` at 384 MiB and time them on the
TPU, so they are not run here; their draws are written out below in the
scripts' order, with the lines they copy, at a small total and L:

* each family's case builder gives those arrays bit for bit, and 9g's
  random data and offsets come out of `swap_draws` the same way;
* K1's plain version on the banded, the constant and the pow2-padded
  cases agrees with the reference's `apply_hmatrix_pallas` (run by the
  Pallas interpreter, as tests/test_torch_matvec_pallas.py runs it) within
  1e-6 relative at k = 1 and 8; the cases share one bucket shape, (16, 8,
  1024), so the interpreter compiles once for each k;
* `repad(data, "pow2")` equals the scripts' `jnp.pad` (9d:93-98);
* on a small headline build of both packages (N = 1200 in the unit ball,
  leaf 128, eps 1e-3, through each package's host-generator path, where
  both packages' ranks and buckets are equal), the bucket the port picks
  for the 2 x 2 and the three it times alone have the shapes and offsets
  that 9g:56-58's and 9f:95-98's rules pick on the reference's data;
* `python -m htool_python_torch.profiling.k1_sweeps --cpu` exits 0 with
  every check within 1e-5 of float64, and without --cpu it raises where
  there is no card;
* the module imports nothing of JAX, the reference package or tools/.
"""

import ast
import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import htool_python_torch as T
import htool_python_tpu as H
from htool_python_torch import interop
from htool_python_torch.models.geometry import create_random_points_in_sphere
from htool_python_torch.ops.matvec import apply_hmatrix_padded
from htool_python_torch.profiling import k1_sweeps as ks
from htool_python_tpu.ops import pallas_matvec as pm
from test_torch_complex import one_thread  # noqa: F401 (fixture)

ROOT = pathlib.Path(__file__).resolve().parents[1]
L_TEST = 4096
TOTAL_TEST = 3 << 20  # 8 blocks of lr_r64_w640, the widest case


def _normal(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _leaves(tree):
    return [a for kind in ("dense", "lr") for e in tree[kind] for a in e]


def _assert_bits(case, name, leaves, x1):
    assert case.name == name
    assert np.array_equal(case.x1, x1) and case.x1.dtype == np.float32
    got = _leaves(case.tree)
    assert len(got) == len(leaves)
    for a, b in zip(got, leaves):
        assert a.dtype == b.dtype and np.array_equal(a, b), name


def test_shape_cases_draw_as_profile_matvec9():
    rng = np.random.default_rng(0)  # 9.py:33
    L, total = L_TEST, TOTAL_TEST
    x1 = _normal(rng, (L + 1024, 1))  # 9.py:31, 35
    cases = ks.shape_cases(TOTAL_TEST, L_TEST)
    for name, kind, r, W in [  # 9.py:37-44
            ("lr_r8_w640", "lr", 8, 640), ("lr_r16_w640", "lr", 16, 640),
            ("lr_r64_w640", "lr", 64, 640), ("lr_r16_w256", "lr", 16, 256),
            ("lr_r32_w128", "lr", 32, 128), ("dense_128", "dense", 0, 128)]:
        if kind == "lr":  # 9.py:46-51
            per = 2 * r * W * 4
            nb = (total // per // 8) * 8
            U = rng.standard_normal((nb, r, W)).astype(np.float32)
            V = rng.standard_normal((nb, r, W)).astype(np.float32)
            arrays = [U, V]
        else:  # 9.py:52-56
            per = W * W * 4
            nb = (total // per // 8) * 8
            arrays = [rng.standard_normal((nb, W, W)).astype(np.float32)]
        assert nb >= 8
        t_off = rng.integers(0, L - W, nb).astype(np.int64)  # 9.py:57-58
        s_off = rng.integers(0, L - W, nb).astype(np.int64)
        mir = np.zeros(nb, np.int8)
        _assert_bits(next(cases), name, [*arrays, t_off, s_off, mir], x1)
    assert next(cases, None) is None


def _make(rng, r, W, L, total):
    """make(r, W) of tools/profile_matvec9b.py:36-44 (the loop bodies of
    9d:52-58 draw the same)."""
    per = 2 * r * W * 4
    nb = (total // per // 8) * 8
    U = rng.standard_normal((nb, r, W)).astype(np.float32)
    V = rng.standard_normal((nb, r, W)).astype(np.float32)
    t_off = rng.integers(0, L - W, nb).astype(np.int64)
    s_off = rng.integers(0, L - W, nb).astype(np.int64)
    return [U, V, t_off, s_off, np.zeros(nb, np.int8)]


def test_width_cases_draw_as_profile_matvec9b():
    rng = np.random.default_rng(0)  # 9b.py:32
    x1 = _normal(rng, (L_TEST + 2048, 1))  # 9b.py:30, 34
    cases = ks.width_cases(TOTAL_TEST, L_TEST)
    _assert_bits(next(cases), "w640_base",
                 _make(rng, 8, 640, L_TEST, TOTAL_TEST), x1)  # 9b.py:65
    for r, W in ((8, 512), (8, 384), (16, 384), (8, 256)):  # 9b.py:77-78
        _assert_bits(next(cases), f"w{W}_r{r}_base",
                     _make(rng, r, W, L_TEST, TOTAL_TEST), x1)
    assert next(cases, None) is None


def test_pow2_cases_draw_as_profile_matvec9d():
    rng = np.random.default_rng(0)  # 9d.py:45
    x1 = _normal(rng, (L_TEST + 2048, 1))  # 9d.py:49-50
    cases = ks.pow2_cases(TOTAL_TEST, L_TEST)
    for r, W in ((8, 768), (8, 896), (8, 1024), (16, 1024)):  # 9d.py:52
        _assert_bits(next(cases), f"syn_r{r}_w{W}",
                     _make(rng, r, W, L_TEST, TOTAL_TEST), x1)
    assert next(cases, None) is None


def test_offset_cases_draw_as_profile_matvec9e():
    L, total = L_TEST, TOTAL_TEST
    r, W = 8, 1024  # 9e.py:35
    per = 2 * r * W * 4
    nb = (total // per // 8) * 8  # 9e.py:36-37
    rng = np.random.default_rng(0)
    U = rng.standard_normal((nb, r, W)).astype(np.float32)  # 9e.py:39-40
    V = rng.standard_normal((nb, r, W)).astype(np.float32)
    mir = np.zeros(nb, np.int8)
    x1 = _normal(rng, (L + 2048, 1))  # 9e.py:33, 42
    bands = np.arange(0, L - W, (L - W) // 62)  # 9e.py:45
    assert np.array_equal(ks.band_starts(L, W), bands)

    def offsets(kind):  # 9e.py:47-58
        if kind == "rand":
            return rng.integers(0, L - W, nb).astype(np.int64)
        if kind == "banded_sorted":
            return np.sort(rng.choice(bands, nb)).astype(np.int64)
        if kind == "banded_shuffled":
            return rng.choice(bands, nb).astype(np.int64)
        return np.zeros(nb, np.int64) + 1024

    cases = ks.offset_cases(total, L)
    for name, tk, sk in [  # 9e.py:60-67, drawn in :68-71's order
            ("t_rand__s_rand", "rand", "rand"),
            ("t_band_sorted__s_rand", "banded_sorted", "rand"),
            ("t_band_shuf__s_rand", "banded_shuffled", "rand"),
            ("t_rand__s_band", "rand", "banded_sorted"),
            ("t_band__s_band", "banded_sorted", "banded_sorted"),
            ("t_const__s_rand", "const", "rand")]:
        t_off = offsets(tk)
        s_off = offsets(sk)
        _assert_bits(next(cases), name, [U, V, t_off, s_off, mir], x1)
    assert next(cases, None) is None


def test_swap_draws_as_profile_matvec9g():
    shape, nb, n, pad2 = (3, 16, 256), 3, 2000, 4096
    rng = np.random.default_rng(1)  # 9g.py:70
    want = [rng.standard_normal((pad2, 1)).astype(np.float32),  # 9g.py:71
            rng.standard_normal(shape).astype(np.float32),  # 9g.py:74-77
            rng.standard_normal(shape).astype(np.float32),
            rng.integers(0, n - 700, nb).astype(np.int64),
            rng.integers(0, n - 700, nb).astype(np.int64)]
    got = ks.swap_draws(shape, nb, n, pad2)
    for a, b in zip(got, want, strict=True):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert np.array_equal(ks.real_x1(pad2), want[0])  # 9f.py:60-61


def _jnp_padw(a):
    """The scripts' `padw` (tools/profile_matvec9d.py:93-98)."""
    W = a.shape[2]
    W2 = ks.pow2_up(W)
    if W2 == W:
        return a
    return jnp.pad(a, ((0, 0), (0, 0), (0, W2 - W)))


def _pallas_cases():
    """(name, bucket tree with numpy leaves, x1): the banded and constant
    offsets of 9e and 9d's (8, 768) case padded to 1024 by `repad`, all
    (16, 8, 1024) buckets over L = 4096."""
    out = [(c.name, c.tree, c.x1) for c in ks.offset_cases(1 << 20, L_TEST)]
    case = next(ks.pow2_cases(16 * 2 * 8 * 768 * 4, L_TEST))
    padded = ks.repad(interop.from_reference_data(case.tree, "cpu"), "pow2")
    tree = {"dense": [], "lr": [tuple(t.numpy() for t in padded["lr"][0])]}
    assert tree["lr"][0][0].shape == (16, 8, 1024)
    return out + [("pow2_padded_r8_w768", tree, case.x1)]


@pytest.mark.parametrize("k", [1, 8])
def test_plain_k1_matches_pallas_on_every_offset_and_padding(k):
    for name, tree, x1 in _pallas_cases():
        pad_len = x1.shape[0]
        x = ks.wide_x(x1, k)
        y_pallas = np.asarray(pm.apply_hmatrix_pallas(
            {kind: [tuple(jnp.asarray(a) for a in e) for e in tree[kind]]
             for kind in ("dense", "lr")}, jnp.asarray(x), pad_len, "N", "N",
            interpret=True))
        y = apply_hmatrix_padded(interop.from_reference_data(tree, "cpu"),
                                 torch.from_numpy(x), pad_len, "N", "N")
        assert y.dtype == torch.float32 and y.shape == (pad_len, k)
        err = np.linalg.norm(y.numpy() - y_pallas) / np.linalg.norm(y_pallas)
        assert err <= 1e-6, (name, err)


def test_repad_pow2_equals_the_scripts_jnp_pad():
    rng = np.random.default_rng(3)
    tree = {"dense": [(_normal(rng, (2, 64, 192)), np.array([0, 64]),
                       np.array([5, 9]), np.zeros(2, np.int8))],
            "lr": [(_normal(rng, (3, 5, 384)), _normal(rng, (3, 5, 768)),
                    np.array([1, 2, 3]), np.array([4, 5, 6]),
                    np.zeros(3, np.int8)),
                   (_normal(rng, (2, 4, 128)), _normal(rng, (2, 4, 64)),
                    np.array([7, 8]), np.array([9, 10]),
                    np.zeros(2, np.int8))]}
    data = interop.from_reference_data(tree, "cpu")
    assert ks.repad(data, "stored") is data
    padded = ks.repad(data, "pow2")
    for kind in ("dense", "lr"):
        for got, want in zip(padded[kind], tree[kind], strict=True):
            n_mats = len(want) - 3
            for g, w in zip(got[:n_mats], want[:n_mats]):
                w2 = np.asarray(_jnp_padw(jnp.asarray(w)))
                assert g.is_contiguous() and np.array_equal(g.numpy(), w2)
            for g, w in zip(got[n_mats:], want[n_mats:]):
                assert np.array_equal(g.numpy(), w.astype(g.numpy().dtype))
    assert [e[0].shape[2] for e in padded["lr"]] == [512, 128]
    assert padded["lr"][1][1].shape[2] == 128  # 64 goes up to 128
    with pytest.raises(ValueError):
        ks.repad(data, "pow3")
    with pytest.raises(ValueError):
        ks.repad({**data, "aligned": True}, "pow2")


def _headline_builds(n=1200):
    """The headline's points and kernel, built by each package's
    host-generator path (eps 1e-3, eta 10, leaf 128, float32)."""
    points = create_random_points_in_sphere(n, np.random.RandomState(0))
    A = 1.0 / (0.1 + np.linalg.norm(points[:, :, None] - points[:, None, :],
                                    axis=0))

    def fill(J, K, mat):
        mat[:, :] = A[np.ix_(np.asarray(J), np.asarray(K))]

    ops = {}
    for pkg in (H, T):
        gen = type("Host", (pkg.VirtualGenerator,),
                   {"build_submatrix": lambda self, J, K, mat: fill(J, K,
                                                                    mat)})
        builder = pkg.ClusterTreeBuilder()
        builder.set_maximal_leaf_size(128)
        cluster = builder.create_cluster_tree(points, 2)
        kw = {} if pkg is H else {"device": "cpu"}
        hb = pkg.HMatrixTreeBuilder(1e-3, 10.0, "N", "N", **kw)
        hb.set_dtype(np.float32 if pkg is H else torch.float32)
        ops[pkg] = hb.build(gen(), cluster, cluster)
    return ops[H], ops[T]


def test_bucket_picks_match_the_reference_rules():
    ref, port = _headline_builds()
    lr = [tuple(np.asarray(a) for a in e) for e in ref._data["lr"]]
    data = port._product_data()
    assert len(data["lr"]) == len(lr) >= 3
    # 9g.py:56-57
    best = max(range(len(lr)), key=lambda i: int(np.prod(lr[i][0].shape)))
    # 9f.py:96-99 (on the padded data: padding keeps the order here)
    sizes = [(int(np.prod(U.shape)) + int(np.prod(V.shape)), i)
             for i, (U, V, *_) in enumerate(lr)]
    sizes.sort(reverse=True)
    picks = [(ks.swap_bucket(data), best)] + [
        (j, i) for j, (_, i) in zip(ks.largest_lowrank(data), sizes[:3])]
    for j, i in picks:
        mine, theirs = data["lr"][j], lr[i]
        assert tuple(mine[0].shape) == theirs[0].shape
        assert tuple(mine[1].shape) == theirs[1].shape
        for got, want in zip(mine[2:4], theirs[2:4]):
            assert np.array_equal(got.numpy(), want)
    padded = ks.repad(data, "pow2")
    assert ks.largest_lowrank(padded) == [i for _, i in sizes[:3]]


def test_entry_point_cpu_mode(tmp_path):
    out = tmp_path / "sweeps.json"
    assert ks.main(["--cpu", "--ks", "1,8", "--out", str(out)]) == 0
    result = json.loads(out.read_text())
    assert result["mode"] == "check" and result["failed"] == []
    assert set(ks.FAMILIES) <= set(result)
    names = dict(ks.case_entries(result))
    assert len(names) == 6 + 5 + 4 + 6 + 2 * 4 + 4
    for entry in names.values():
        assert entry["nb"] > 0
        for k in (1, 8):
            assert entry[f"k{k}"]["rel_err"] <= ks.CHECK_TOL
    for rule in ks.RULES:
        whole = result["repad"][rule]["whole"]
        assert all(whole[f"k{k}"]["repad_err"] <= ks.CHECK_TOL
                   for k in (1, 8))
    sizes = result["repad"]["real_bytes"]
    assert sizes["stored"] == sizes["orig"] < sizes["pow2"]


def test_entry_point_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ks.main([])


def test_sweeps_import_nothing_of_jax_or_the_reference():
    for name in ("k1_sweeps.py", "bounds.py"):
        path = ROOT / "htool_python_torch" / "profiling" / name
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import)
                     else [node.module or ""]
                     if isinstance(node, ast.ImportFrom) else [])
            for mod in names:
                assert mod.split(".")[0] not in (
                    "jax", "jaxlib", "htool_python_tpu", "tools"), (name, mod)
                assert not mod.startswith("profile_matvec"), (name, mod)
