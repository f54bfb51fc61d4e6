"""The profiling path's kernels against the reference's (CPU).

The reference's profiling scripts (tools/profile_matvec3.py, 9c, 5) run
here as their own --cpu mode runs them: their Pallas kernels in interpret
mode, imported from tools/ unchanged, with their size constants patched
down.  The port's plain versions get the same inputs, drawn by the port's
builders from the same seeds (which must give the reference's arrays bit
for bit):

* P1 `stream_probe` against `make_stream`'s kernel at 4 MiB: 1e-6
  relative (f32 sums in another order; the entries are positive);
* P2 `shape_stream` against `stream`'s kernel at 1-2 MiB, captured
  through a stub of its `_chain_time`: within 1e-6 of 1e-30 * sum|A| (the
  entries are standard normal, so the sum cancels);
* P3 `bucket_variant` against `launch(..., interpret=True)` at 1 MiB and
  L = 4096, for the six variants x {lr, dense}, the probes 'static' and
  'skip' included: 1e-6 relative, and y = 0 exactly for 'stream';
* P4 `take_along_axis` against jnp.take_along_axis and the probe's own
  expectation.
Plus the multiplicity of P1's tiles against a count of the reference's
clipped index map, P2's cases grouped by the width its kernel sees,
P3's 'xgemm' tolerance (it holds the plain version with its operands
rounded to TF32 as the kernel rounds them, and rejects a zero output and
one group left out), the per-CTA sums of accum 'skip', `chain_time` on the
CPU (a chain of zeros included), and `python -m htool_python_torch.profiling
--cpu`.
"""

import json
import pathlib
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from htool_python_torch.profiling import bucket_variants as bv
from htool_python_torch.profiling import stream
from htool_python_torch.profiling.__main__ import main as profiling_main
from htool_python_torch.profiling.timing import chain_time
from test_torch_complex import one_thread  # noqa: F401 (fixture)

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "tools"))
import profile_matvec3 as p3  # noqa: E402
import profile_matvec5 as p5  # noqa: E402
import profile_matvec9c as p9c  # noqa: E402

L_TEST = 4096


@pytest.mark.parametrize("b,spb,grid", [(0, 1, 1), (0, 4, 4), (1, 2, 4),
                                        (2, 3, 12), (3, 1, 4), (1, 5, 15)])
def test_tile_weights_count_the_clipped_index_map(b, spb, grid):
    counts = np.bincount([min(max(i - b * spb, 0), spb - 1)
                          for i in range(grid)], minlength=spb)
    assert (stream.tile_weights(b, spb, grid) == counts).all()


@pytest.mark.parametrize("step_mb,n_buf", [(1, 2), (1, 4), (2, 2)])
def test_stream_probe_matches_reference(monkeypatch, step_mb, n_buf):
    monkeypatch.setattr(p3, "TOTAL_MB", 4)
    np.random.seed(7)
    ref_bufs, run, ref_grid = p3.make_stream(step_mb, n_buf)
    bufs, grid = stream.make_stream(step_mb, n_buf, 4,
                                    rng=np.random.RandomState(7))
    assert grid == ref_grid and len(bufs) == n_buf
    for a, b in zip(bufs, ref_bufs):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    x = np.random.RandomState(1).rand(1, 128).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(run([jnp.asarray(a) for a in ref_bufs],
                              jnp.asarray(x)))
    got = stream.stream_probe([torch.from_numpy(a) for a in bufs],
                              torch.from_numpy(x), step_mb).numpy()
    assert got.shape == (1, 128)
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


@pytest.mark.parametrize("shape,G,total", [((16, 640), 4, 1 << 20),
                                           ((32, 256), 4, 1 << 20),
                                           ((256, 640), 1, 2 << 20)])
def test_shape_stream_matches_reference(monkeypatch, shape, G, total):
    captured = {}

    def capture(jax_, jnp_, fn, data, x, *args, **kwargs):
        captured.update(fn=fn, A=data, x=x)
        return 1.0

    monkeypatch.setattr(p9c, "TOTAL", total)
    monkeypatch.setattr(p9c, "_chain_time", capture)
    p9c.stream(shape, G)
    A = stream.make_shape_case(shape, G, total, rng=np.random.default_rng(0))
    assert np.array_equal(A, np.asarray(captured["A"]))
    with pltpu.force_tpu_interpret_mode():
        want = float(captured["fn"](captured["A"], captured["x"])[0, 0])
    got = stream.shape_stream(torch.from_numpy(A),
                              torch.from_numpy(np.array(captured["x"])), G)
    assert got.shape == (1, 1)
    assert abs(float(got) - want) <= 1e-6 * np.abs(A).sum() * 1e-30


@pytest.mark.parametrize("name,gather,term,accum", bv.VARIANTS)
@pytest.mark.parametrize("case", bv.CASES, ids=[c[0] for c in bv.CASES])
def test_bucket_variant_matches_reference(case, name, gather, term, accum):
    kind, r, pt, ps, G = case
    ref_rng, rng = np.random.default_rng(0), np.random.default_rng(0)
    ref_slabs, ref_offs, ref_stored = p5.build_case(kind, 1, L_TEST, G, r,
                                                    pt, ps, ref_rng)
    slabs, offs, stored = bv.build_case(kind, 1, L_TEST, G, r, pt, ps, rng)
    assert stored == ref_stored and np.array_equal(slabs,
                                                   np.asarray(ref_slabs))
    assert all(np.array_equal(a, b) for a, b in zip(offs, ref_offs))
    x = rng.standard_normal((1, L_TEST)).astype(np.float32)
    want = np.asarray(p5.launch(kind, gather, term, accum, ref_slabs,
                                ref_offs, jnp.asarray(x), L_TEST, G, r, pt,
                                ps, True))
    got = bv.bucket_variant(kind, gather, term, accum,
                            torch.from_numpy(slabs),
                            tuple(torch.from_numpy(o) for o in offs),
                            torch.from_numpy(x), L_TEST, G, r, pt,
                            ps).numpy()
    assert got.shape == (1, L_TEST)
    if name == "stream":
        assert not got.any() and not want.any()
    else:
        assert (np.linalg.norm(got - want) <= 1e-6 * np.linalg.norm(want)), (
            np.linalg.norm(got - want) / np.linalg.norm(want))


def test_shape_cases_run_once_for_each_width():
    runs_as = stream.launch_groups(stream.SHAPE_CASES)
    shapes = {name: shape for name, shape, _ in stream.SHAPE_CASES}
    assert list(runs_as) == list(shapes)
    assert len(set(runs_as.values())) == 6  # 640, 256, 128, 512, 768, 1024
    for name, first in runs_as.items():
        assert shapes[first][-1] == shapes[name][-1]
        assert runs_as[first] == first


def _tf32(t):
    """t rounded to TF32 as cvt.rna.tf32.f32 rounds it: 10 stored mantissa
    bits, ties away from zero."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _xgemm_in_tf32(kind, gather, accum, slabs, offs, x, L, G, r, pt, ps):
    """The 'xgemm' variant with the operands of its products rounded to
    TF32 where the kernel rounds them: V and x, then w = V x and Ut (dense:
    D and x); f32 sums."""
    t_off, s_off = offs
    xg = _tf32(bv._gather(x, s_off, ps, L))[..., None]
    if kind == "lr":
        w = _tf32((_tf32(slabs[:, r:, :ps]) @ xg)[..., 0])
        out = (_tf32(slabs[:, :r, :pt]) * w[..., None]).sum(1)
    else:
        out = (_tf32(slabs[:, :, :ps]) @ xg)[..., 0]
    y = torch.zeros(L)
    if accum == "roll":
        bv._accum_seg(y, t_off, out, L)
    else:
        bv._accum_static(y, out)
    return y[None]


@pytest.mark.parametrize("gather,accum", [("roll", "roll"),
                                          ("take", "static")])
@pytest.mark.parametrize("case", bv.CASES, ids=[c[0] for c in bv.CASES])
def test_xgemm_tolerance_holds_tf32_and_rejects_wrong_outputs(one_thread,
                                                              case, gather,
                                                              accum):
    kind, r, pt, ps, G = case
    rng = np.random.default_rng(8)
    slabs, offs, _ = bv.build_case(kind, 4, L_TEST, G, r, pt, ps, rng)
    slabs = torch.from_numpy(slabs)
    offs = tuple(torch.from_numpy(o) for o in offs)
    x = torch.from_numpy(rng.standard_normal((1, L_TEST)).astype(np.float32))
    args = (kind, gather, "xgemm", accum, slabs, offs, x, L_TEST, G, r, pt,
            ps)
    y = bv.bucket_variant_plain(*args)
    tol = bv.kernel_tolerance(*args, y)
    tf32 = _xgemm_in_tf32(kind, gather, accum, slabs, offs, x, L_TEST, G, r,
                          pt, ps)
    assert (tf32 != y).any()  # the rounding shows
    assert ((tf32 - y).abs() <= tol).all()
    sd = bv.tf32_error_std(kind, gather, accum, slabs, offs, x, L_TEST, G,
                           r, pt, ps)
    assert float(((tf32 - y).abs() / sd)[sd > 0].max()) <= 5
    assert (y.abs() > tol).any()  # a zero output fails
    # leaving the first group out moves y by the group's own output
    group = bv.bucket_variant_plain(kind, gather, "xgemm", accum, slabs[:G],
                                    (offs[0][:G], offs[1][:G]), x, L_TEST, G,
                                    r, pt, ps)
    assert (group.abs() > 10 * tol).any()


@pytest.mark.parametrize("case", bv.CASES, ids=[c[0] for c in bv.CASES])
def test_stream_variant_sink_holds_the_scaled_group_sums(case):
    """With accum 'skip' y stays 0; the per-CTA sums are what keeps the
    kernel's loads: for 'stream', G pt 1e-30 sum(the group's slab)."""
    kind, r, pt, ps, G = case
    slabs, offs, _ = bv.build_case(kind, 1, L_TEST, G, r, pt, ps,
                                   np.random.default_rng(9))
    slabs = np.abs(slabs)
    args = (kind, "none", "skip", "skip", torch.from_numpy(slabs),
            tuple(torch.from_numpy(o) for o in offs),
            torch.ones((1, L_TEST)), L_TEST, G, r, pt, ps)
    y, sink = bv.bucket_variant(*args, return_sink=True)
    exact = (slabs.astype(np.float64).reshape(slabs.shape[0] // G, -1)
             .sum(1) * G * pt * 1e-30)
    assert not y.any() and sink.shape == (slabs.shape[0] // G,)
    assert np.abs(sink.numpy() - exact).max() <= 1e-6 * exact.max()
    assert bv.bucket_variant(*args[:2], "vpu", *args[3:],
                             return_sink=True)[1].shape == (slabs.shape[0],)
    with pytest.raises(ValueError):
        bv.bucket_variant(*args[:3], "roll", *args[4:], return_sink=True)


def test_k1_on_the_bucket_equals_base():
    """K1's plain version on the bucket repacked into K1's layout computes
    what the 'base' variant computes."""
    from htool_python_torch.ops.cuda_matvec import apply_hmatrix_cuda

    rng = np.random.default_rng(3)
    for kind, r, pt, ps, G in bv.CASES:
        slabs, offs, _ = bv.build_case(kind, 1, L_TEST, G, r, pt, ps, rng)
        slabs = torch.from_numpy(slabs)
        offs = tuple(torch.from_numpy(o) for o in offs)
        x = torch.from_numpy(rng.standard_normal((1, L_TEST)).astype(
            np.float32))
        y_k1 = apply_hmatrix_cuda(bv.k1_data(kind, slabs, offs, r, pt, ps),
                                  x.reshape(L_TEST, 1), L_TEST, "N", "N")
        y_base = bv.bucket_variant(kind, "roll", "vpu", "roll", slabs, offs,
                                   x, L_TEST, G, r, pt, ps)
        assert (torch.linalg.vector_norm(y_k1.reshape(1, -1) - y_base)
                <= 1e-6 * torch.linalg.vector_norm(y_base))


def test_bucket_variant_segments_outside_read_zeros_and_drop_rows():
    """A segment past the end of x reads zeros there, a target segment
    before the start of y drops those rows: against the float64 product
    of the blocks clipped by hand."""
    kind, r, pt, ps, G = bv.CASES[1]
    rng = np.random.default_rng(4)
    slabs, (t_off, s_off), _ = bv.build_case(kind, 1, L_TEST, G, r, pt, ps,
                                             rng)
    x = rng.standard_normal((1, L_TEST)).astype(np.float32)
    s_off[0], t_off[1] = L_TEST - 100, -50
    got = bv.bucket_variant(kind, "roll", "vpu", "roll",
                            torch.from_numpy(slabs),
                            (torch.from_numpy(t_off), torch.from_numpy(s_off)),
                            torch.from_numpy(x), L_TEST, G, r, pt, ps)
    x_ext = np.concatenate([x[0], np.zeros(ps)]).astype(np.float64)
    want = np.zeros(L_TEST + 2 * pt)  # rows shifted by pt
    for g in range(slabs.shape[0]):
        seg = x_ext[s_off[g]:s_off[g] + ps]
        want[pt + t_off[g]:pt + t_off[g] + pt] += slabs[g, :, :ps] @ seg
    want = want[pt:pt + L_TEST]
    assert np.abs(got.numpy()[0] - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("which", ["probe", "random"])
def test_take_along_axis_matches_reference(which):
    if which == "probe":  # the reference probe's inputs
        x = np.arange(8 * 1024, dtype=np.float32).reshape(8, 1024)
        idx = np.broadcast_to(np.arange(256, dtype=np.int32) + 3, (8, 256))
    else:
        rng = np.random.default_rng(5)
        x = rng.standard_normal((5, 333)).astype(np.float32)
        idx = rng.integers(0, 333, (5, 77)).astype(np.int32)
    got = bv.take_along_axis(torch.from_numpy(x),
                             torch.from_numpy(np.ascontiguousarray(idx)))
    want = np.asarray(jnp.take_along_axis(jnp.asarray(x), jnp.asarray(idx),
                                          axis=1))
    assert np.array_equal(got.numpy(), want)
    if which == "probe":
        assert np.array_equal(got.numpy()[0], np.arange(3, 259))


def test_take_along_axis_raises_outside_the_row():
    x = torch.zeros((2, 10))
    for bad in (10, -1):
        idx = torch.zeros((2, 3), dtype=torch.int32)
        idx[1, 2] = bad
        with pytest.raises(IndexError):
            bv.take_along_axis(x, idx)


def test_wrappers_refuse_bad_inputs():
    bufs = [torch.zeros((512, 512))]
    with pytest.raises(ValueError):  # not a whole number of 2 MiB tiles
        stream.stream_probe(bufs, torch.zeros((1, 128)), 2)
    with pytest.raises(ValueError):  # x of the wrong width
        stream.stream_probe(bufs, torch.zeros((1, 64)), 1)
    with pytest.raises(ValueError):  # 10 blocks in windows of 4
        stream.shape_stream(torch.zeros((10, 4, 8)), torch.zeros((1, 1)), 4)
    slabs = torch.zeros((10, 32, 256))
    offs = (torch.zeros(10, dtype=torch.int32),) * 2
    with pytest.raises(ValueError):  # 10 blocks in groups of 4
        bv.bucket_variant("lr", "roll", "vpu", "roll", slabs, offs,
                          torch.zeros((1, L_TEST)), L_TEST, 4, 16, 256, 256)
    with pytest.raises(ValueError):
        bv.bucket_variant("lr", "gather", "vpu", "roll", slabs, offs,
                          torch.zeros((1, L_TEST)), L_TEST, 5, 16, 256, 256)


def test_chain_time_on_the_cpu_survives_a_chain_of_zeros():
    kind, r, pt, ps, G = bv.CASES[0]
    slabs, offs, _ = bv.build_case(kind, 1, L_TEST, G, r, pt, ps,
                                   np.random.default_rng(0))
    slabs = torch.from_numpy(slabs)
    offs = tuple(torch.from_numpy(o) for o in offs)
    x = torch.ones((1, L_TEST))
    for accum, term in (("roll", "vpu"), ("skip", "skip")):  # 'skip': y = 0
        t = chain_time(lambda d, xv, a=accum, tm=term: bv.bucket_variant(
            kind, "roll", tm, a, d, offs, xv, L_TEST, G, r, pt, ps),
            slabs, x, reps_lo=1, reps_hi=3)
        assert t > 0


def test_profiling_entry_point_cpu_mode(tmp_path):
    out = tmp_path / "profile.json"
    assert profiling_main(["--cpu", "--out", str(out)]) == 0
    result = json.loads(out.read_text())
    assert result["failed"] == [] and result["mode"] == "check"
    assert len(result["stream"]) == 4 and len(result["shape"]) == 3
    assert result["bucket"]["take_probe"] == "ok"
    for kind in ("lr", "dense"):
        names = [v[0] for v in bv.VARIANTS] + ["k1"]
        assert set(names) <= set(result["bucket"][kind])
        # the probes differ from the product on purpose
        assert result["bucket"][kind]["stream"]["rel_err"] == 1.0
        assert result["bucket"][kind]["xgemm_sacc"]["rel_err"] > 0.5


def test_profiling_entry_point_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry point would run on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        profiling_main([])
