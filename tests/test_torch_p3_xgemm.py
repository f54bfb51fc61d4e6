"""P3's 'xgemm' term in the order of summation of its kernel (CPU).

csrc/bucket_variants.cu `xgemm_kernel` sums the 'xgemm' term block by
block: for a low-rank block the consumer warps each sum every 8th k8 step
of V x, their partials are added in warp order and the block's row of out
is w^T Ut; a dense block is D x over its k8 steps in one warp.  Its plain
twin, `bucket_variants.xgemm_streamed_plain`, sums in that order.  Here
the twin is held, on the reference's --cpu case (1 MiB, L = 4096), to:

* the plain version `bucket_variant_plain` and the reference's `launch`
  (tools/profile_matvec5.py) in interpret mode: 1e-6 relative, for both
  kinds, both gathers and both accumulations that reach y;
* with its operands rounded to TF32 as the kernel rounds them, the
  kernel's tolerance `kernel_tolerance` (which still rejects a zero
  output and a group left out);
* with accum 'skip', one sum per group, as `n_ctas` counts them;
* the shapes the kernel takes (its registers hold G <= 32 and, for 'lr',
  pt <= 256; a TMA box holds a slab of at most 256 rows);
* every edit of profiling/xgemm_variants.py (the kernel rebuilt with one
  design choice changed, timed on the card) still applying to the source.
"""

import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from htool_python_torch.ops import cuda_build
from htool_python_torch.profiling import bucket_variants as bv
from htool_python_torch.profiling import xgemm_variants
from test_torch_complex import one_thread  # noqa: F401 (fixture)

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "tools"))
import profile_matvec5 as p5  # noqa: E402

L_TEST = 4096
CASE_IDS = [c[0] for c in bv.CASES]


def _case(kind, r, pt, ps, G, seed, total_mb=1):
    rng = np.random.default_rng(seed)
    slabs, offs, _ = bv.build_case(kind, total_mb, L_TEST, G, r, pt, ps, rng)
    x = rng.standard_normal((1, L_TEST)).astype(np.float32)
    return slabs, offs, x


def _torch(slabs, offs, x):
    return (torch.from_numpy(slabs), tuple(torch.from_numpy(o) for o in offs),
            torch.from_numpy(x))


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("accum", ["roll", "static"])
@pytest.mark.parametrize("gather", ["roll", "take"])
@pytest.mark.parametrize("case", bv.CASES, ids=CASE_IDS)
def test_streamed_twin_matches_plain_version_and_reference(one_thread, case,
                                                           gather, accum):
    kind, r, pt, ps, G = case
    slabs, offs, x = _case(kind, r, pt, ps, G, seed=0)
    want = np.asarray(p5.launch(kind, gather, "xgemm", accum, slabs, offs,
                                jnp.asarray(x), L_TEST, G, r, pt, ps, True))
    args = (kind, gather, accum, *_torch(slabs, offs, x), L_TEST, G, r, pt,
            ps)
    got = bv.xgemm_streamed_plain(*args).numpy()
    plain = bv.bucket_variant_plain(kind, gather, "xgemm", accum,
                                    *args[3:]).numpy()
    assert got.shape == (1, L_TEST)
    assert _rel(got, plain) <= 1e-6
    assert _rel(got, want) <= 1e-6


@pytest.mark.parametrize("gather,accum", [("roll", "roll"),
                                          ("take", "static")])
@pytest.mark.parametrize("case", bv.CASES, ids=CASE_IDS)
def test_streamed_twin_in_tf32_within_kernel_tolerance(one_thread, case,
                                                       gather, accum):
    kind, r, pt, ps, G = case
    slabs, offs, x = _torch(*_case(kind, r, pt, ps, G, seed=8, total_mb=4))
    args = (kind, gather, "xgemm", accum, slabs, offs, x, L_TEST, G, r, pt,
            ps)
    y = bv.bucket_variant_plain(*args)
    tol = bv.kernel_tolerance(*args, y)
    tf32 = bv.xgemm_streamed_plain(kind, gather, accum, *args[4:],
                                   tf32=True)
    assert (tf32 != y).any()  # the rounding shows
    assert ((tf32 - y).abs() <= tol).all()
    sd = bv.tf32_error_std(kind, gather, accum, slabs, offs, x, L_TEST, G,
                           r, pt, ps)
    assert float(((tf32 - y).abs() / sd)[sd > 0].max()) <= 5
    assert (y.abs() > tol).any()  # a zero output fails
    group = bv.xgemm_streamed_plain(kind, gather, accum, slabs[:G],
                                    (offs[0][:G], offs[1][:G]), x, L_TEST, G,
                                    r, pt, ps, tf32=True)
    assert (group.abs() > 10 * tol).any()  # so does a group left out


@pytest.mark.parametrize("gather", ["roll", "none"])
@pytest.mark.parametrize("case", bv.CASES, ids=CASE_IDS)
def test_streamed_twin_sink_holds_one_sum_per_group(one_thread, case,
                                                    gather):
    kind, r, pt, ps, G = case
    slabs, offs, x = _case(kind, r, pt, ps, G, seed=9)
    slabs, offs, x = _torch(np.abs(slabs), offs, np.abs(x))
    args = (kind, gather, "skip", slabs, offs, x, L_TEST, G, r, pt, ps)
    y, sink = bv.xgemm_streamed_plain(*args, return_sink=True)
    y_plain, want = bv.bucket_variant_plain(kind, gather, "xgemm",
                                            *args[2:], return_sink=True)
    n_groups = bv.n_ctas("xgemm", slabs.shape[0], G)
    assert sink.shape == want.shape == (n_groups,)
    assert not y.any() and not y_plain.any()
    if gather == "none":
        assert not sink.any() and not want.any()
    else:
        assert (sink - want).abs().max() <= 1e-6 * want.abs().max()


@pytest.mark.parametrize("kind,G,r,pt,ps", [
    ("lr", 48, 16, 256, 256),   # G above the two m16 tiles of out
    ("lr", 32, 16, 272, 256),   # pt above the warps' n8 tiles of out
    ("lr", 32, 8, 256, 256),    # r not a multiple of 16
    ("dense", 16, 0, 128, 100),  # ps not a multiple of 8
    ("dense", 24, 0, 128, 128),  # G not a multiple of 16
    ("dense", 16, 0, 272, 128)])  # a slab taller than one TMA box
def test_xgemm_refuses_shapes_its_kernel_does_not_take(kind, G, r, pt, ps):
    rows, W = bv.slab_rows(kind, r, pt), max(pt, ps)
    slabs = torch.zeros((2 * G, rows, W))
    offs = (torch.zeros(2 * G, dtype=torch.int32),) * 2
    x = torch.zeros((1, L_TEST))
    with pytest.raises(ValueError, match="xgemm"):
        bv.xgemm_streamed_plain(kind, "roll", "roll", slabs, offs, x, L_TEST,
                                G, r, pt, ps)
    # the plain version of the reference's formulation takes any shape
    assert bv.bucket_variant_plain(kind, "roll", "xgemm", "roll", slabs,
                                   offs, x, L_TEST, G, r, pt, ps).shape == (
                                       1, L_TEST)


@pytest.mark.parametrize("name", sorted(xgemm_variants.VARIANTS))
def test_xgemm_variants_edit_the_shipped_source(name):
    """Every variant that profiling/xgemm_variants.py times on the card is
    an edit of csrc/bucket_variants.cu that still finds its text there."""
    source = (cuda_build.CSRC
              / cuda_build.SOURCES["bucket_variants"]).read_text()
    edited = xgemm_variants.variant_source(source, name)
    assert (edited == source) == (name == "shipped")
