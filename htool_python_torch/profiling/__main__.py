"""The profiling path:
    python -m htool_python_torch.profiling [--cpu] [--out FILE]

Runs the case lists of the reference's profiling scripts through kernels
P1-P4, at the reference's sizes:

  stream: P1 on each (step_mb, n_buf) of tools/profile_matvec3.py `main`,
          384 MiB each (`make_stream`; the reference draws from numpy's
          unseeded global state, the port from RandomState(0));
  shape:  P2 on each case of tools/profile_matvec9c.py `main`, about 384
          MiB each (default_rng(0) per case, as there), each width once:
          the card's kernel sees only the last dimension;
  bucket: the gather probe (P4), then P3's six variants on the low-rank
          and the dense bucket of tools/profile_matvec5.py `main` (384 MiB
          each, L = 40960, one column), and K1 (ops/cuda_matvec.py) on the
          same bucket in its own layout, which computes what 'base' does.

Each case is timed by `timing.chain_time` (the reference's reps: 50 / 350
for P1, 10 / 60 otherwise) and reported, unrounded, as ms and GB/s over
the bytes the case stores, beside its bound: those bytes over 3.35 TB/s
(H100 SXM HBM3).  One JSON object is printed, and written to --out when
given, keyed like the reference's *_result.json files.

--cpu is the reference's --cpu mode: the plain versions on the CPU at a
tiny size, each checked against a float64 computation on the host, no
timing; the exit code is 1 if a check fails.  Without --cpu the path runs
on CUDA and raises when there is no card: it never falls back to the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..config import resolve_device
from . import bucket_variants as bv
from . import stream
from .bounds import HBM_BYTES_PER_S
from .timing import chain_time, cuda_ms

CHECK_TOL = 1e-5  # --cpu: f32 against float64

# --cpu sizes: every case valid, a few MiB each
TINY_STREAM_MB = 4
TINY_STREAM_CASES = [(1, 1), (1, 2), (1, 4), (2, 2)]
TINY_SHAPE_TOTAL = 2 << 20
TINY_SHAPE_CASES = [("3d_16x640_G4", (16, 640), 4),
                    ("3d_32x256_G4", (32, 256), 4),
                    ("2d_256x640_G1", (256, 640), 1)]
TINY_BUCKET_MB = 4  # the reference's --cpu size


def bound_ms(nbytes: int) -> float:
    """Least ms to read nbytes once from HBM."""
    return nbytes / HBM_BYTES_PER_S * 1e3


def _rel(a, b) -> float:
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def stream_cases(device, tiny):
    """P1 over its case list: {case: {ms, GBs, steps, us_per_step,
    bound_ms}}, or with `tiny` {case: {steps, rel_err}} against float64."""
    total_mb = TINY_STREAM_MB if tiny else stream.TOTAL_MB
    rng = np.random.RandomState(0)
    x = torch.zeros((1, stream.OUT_COLS), dtype=torch.float32, device=device)
    out = {}
    for step_mb, n_buf in TINY_STREAM_CASES if tiny else stream.STREAM_CASES:
        arrays, grid = stream.make_stream(step_mb, n_buf, total_mb, rng=rng)
        bufs = [torch.from_numpy(a).to(device) for a in arrays]
        nbytes = sum(a.nbytes for a in arrays)
        key = f"s{step_mb}MB_b{n_buf}"
        if tiny:
            tile = stream.rows_per_step(step_mb)
            spb = arrays[0].shape[0] // tile
            ref = sum(stream.tile_weights(b, spb, grid)
                      @ a.astype(np.float64).reshape(spb, tile, -1).sum(1)
                      for b, a in enumerate(arrays))[:stream.OUT_COLS]
            got = stream.stream_probe(bufs, x, step_mb).cpu().numpy()[0]
            out[key] = {"steps": grid, "rel_err": _rel(got, ref)}
            continue
        t = chain_time(lambda d, xx, s=step_mb: stream.stream_probe(d, xx, s),
                       bufs, x, reps_lo=50, reps_hi=350)
        out[key] = {"ms": t * 1e3, "GBs": nbytes / t / 1e9, "steps": grid,
                    "us_per_step": t / grid * 1e6,
                    "bound_ms": bound_ms(nbytes)}
    return out


def shape_cases(device, tiny):
    """P2 over its case list: {case: {ms, GBs, bound_ms}}, or with `tiny`
    {case: {err}}, the error against float64 over 1e-30 * sum|A| (the sum
    cancels).  Timed, each width runs once: a case whose width ran before
    is {same_launch_as: that case} (`stream.launch_groups`)."""
    total = TINY_SHAPE_TOTAL if tiny else stream.SHAPE_TOTAL
    cases = TINY_SHAPE_CASES if tiny else stream.SHAPE_CASES
    runs_as = stream.launch_groups(cases)
    x = torch.zeros((1, 1), dtype=torch.float32, device=device)
    out = {}
    for name, shape, G in cases:
        if not tiny and runs_as[name] != name:
            out[name] = {"same_launch_as": runs_as[name]}
            continue
        array = stream.make_shape_case(shape, G, total,
                                       rng=np.random.default_rng(0))
        A = torch.from_numpy(array).to(device)
        if tiny:
            a64 = array.astype(np.float64)
            got = float(stream.shape_stream(A, x, G))
            out[name] = {"err": abs(got - a64.sum() * 1e-30)
                         / (np.abs(a64).sum() * 1e-30)}
            continue
        t = chain_time(lambda a, xx, g=G: stream.shape_stream(a, xx, g), A, x)
        out[name] = {"ms": t * 1e3, "GBs": array.nbytes / t / 1e9,
                     "bound_ms": bound_ms(array.nbytes)}
    return out


def take_probe(device):
    """P4 at the reference probe's shapes: x (8, 1024) = arange, idx (8,
    256) = arange(256) + 3; 'ok' when row i reads 1024 i + arange(3, 259)
    (the reference checks row 0)."""
    xp = torch.arange(8 * 1024, dtype=torch.float32,
                      device=device).reshape(8, 1024)
    ip = (torch.arange(256, dtype=torch.int32, device=device) + 3).expand(
        8, 256).contiguous()
    got = bv.take_along_axis(xp, ip).cpu().numpy()
    want = 1024 * np.arange(8)[:, None] + np.arange(3, 259)
    ok = bool((got == want).all())
    return ("ok" if ok else "wrong-values"), (xp, ip)


def _expected(kind, accum, slabs, offs, x, r, pt, ps):
    """The float64 value of a variant of VARIANTS on the host: the product
    (accum 'roll'), every block at offset 0 ('static'), or zeros ('skip',
    only the 'stream' variant)."""
    t_off, s_off = offs
    if accum == "skip":
        return np.zeros(x.shape[1])
    if accum == "static":
        t_off = np.zeros_like(t_off)
    return bv.product_f64(kind, slabs, (t_off, s_off), x, x.shape[1], r, pt,
                          ps)


def bucket_cases(device, tiny):
    """The gather probe and P3 over its variants, with K1 on each bucket:
    {take_probe, lr: {stored_mb, nb, bound_ms, <variant>: {ms, GBs}, k1:
    {ms, GBs}}, dense: ...}; with `tiny`, each variant's rel_err against
    the float64 product (the reference's --cpu number: 'static' and
    'stream' differ from it on purpose) and err_own against the variant's
    own float64 value."""
    from ..ops.cuda_matvec import BucketTable, apply_hmatrix_cuda

    total_mb = TINY_BUCKET_MB if tiny else bv.TOTAL_MB
    L = bv.LENGTH
    rng = np.random.default_rng(0)
    probe, probe_inputs = take_probe(device)
    out = {"take_probe": probe}
    if not tiny:
        # the timed form: one device counter, checked once after the reps
        fault = bv.fault_counter(device)
        out["take_probe_ms"] = cuda_ms(
            lambda: bv.take_along_axis(*probe_inputs, fault=fault), reps=100)
        bv.check_fault(fault, probe_inputs[0].shape[1])
    for kind, r, pt, ps, G in bv.CASES:
        slabs_np, offs_np, stored = bv.build_case(kind, total_mb, L, G, r,
                                                  pt, ps, rng)
        x_np = rng.standard_normal((1, L)).astype(np.float32)
        slabs = torch.from_numpy(slabs_np).to(device)
        offs = tuple(torch.from_numpy(o).to(device) for o in offs_np)
        x = torch.from_numpy(x_np).to(device)
        data = bv.k1_data(kind, slabs, offs, r, pt, ps)
        table = BucketTable(data, device)

        def variant(gather, term, accum):
            def fn(d, xv):
                return bv.bucket_variant(kind, gather, term, accum, d, offs,
                                         xv, L, G, r, pt, ps)
            return fn

        def k1(d, xv):
            return apply_hmatrix_cuda(d, xv.reshape(L, 1), L, "N", "N",
                                      table).reshape(1, L)

        entry = {"stored_mb": stored >> 20, "nb": slabs_np.shape[0],
                 "bound_ms": bound_ms(stored + 2 * 4 * L
                                      + 8 * slabs_np.shape[0])}
        runs = [(name, variant(g, t, a), slabs, a)
                for name, g, t, a in bv.VARIANTS]
        runs.append(("k1", k1, data, "roll"))
        if tiny:
            product = _expected(kind, "roll", slabs_np, offs_np, x_np, r, pt,
                                ps)
        for name, fn, arg, accum in runs:
            if tiny:
                got = fn(arg, x).cpu().numpy()[0].astype(np.float64)
                own = _expected(kind, accum, slabs_np, offs_np, x_np, r, pt,
                                ps)
                entry[name] = {
                    "rel_err": float(np.linalg.norm(got - product)
                                     / np.linalg.norm(product)),
                    "err_own": float(np.linalg.norm(got - own)
                                     / max(np.linalg.norm(own), 1e-30))}
                continue
            t = chain_time(fn, arg, x)
            entry[name] = {"ms": t * 1e3, "GBs": stored / t / 1e9}
        out[kind] = entry
    return out


def run_profile(device, tiny=False):
    """The profiling path on `device` (see the module docstring); returns
    its result, with the host seconds of each part (input draws
    included)."""
    device = resolve_device(device)
    result = {"device": (torch.cuda.get_device_name(device)
                         if device.type == "cuda" else "cpu"),
              "mode": "check" if tiny else "timing",
              "hbm_bytes_per_s": HBM_BYTES_PER_S}
    seconds = result["seconds"] = {}
    for name, part in (("stream", stream_cases), ("shape", shape_cases),
                       ("bucket", bucket_cases)):
        t0 = time.perf_counter()
        result[name] = part(device, tiny)
        seconds[name] = time.perf_counter() - t0
    return result


def failures(result):
    """The checks a result fails: --cpu errors above CHECK_TOL, and a take
    probe that did not read arange(3, 259)."""
    bad = [] if result["bucket"]["take_probe"] == "ok" else ["take_probe"]
    if result["mode"] == "check":
        bad += [f"stream/{k}" for k, v in result["stream"].items()
                if not v["rel_err"] <= CHECK_TOL]
        bad += [f"shape/{k}" for k, v in result["shape"].items()
                if not v["err"] <= CHECK_TOL]
        bad += [f"bucket/{kind}/{k}" for kind in ("lr", "dense")
                for k, v in result["bucket"][kind].items()
                if isinstance(v, dict) and not v["err_own"] <= CHECK_TOL]
    return bad


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m htool_python_torch.profiling",
        description="Time the kernel-profiling cases (P1-P4) on the card; "
        "--cpu checks the plain versions at a tiny size instead.")
    ap.add_argument("--cpu", action="store_true",
                    help="plain versions on the CPU, tiny size, no timing")
    ap.add_argument("--out", help="also write the JSON result to this file")
    args = ap.parse_args(argv)
    if args.cpu:
        device = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("the profiling path runs on a CUDA device and "
                               "none is available (--cpu checks the plain "
                               "versions instead)")
        from ..ops import cuda_build

        device = torch.device("cuda")
        cuda_build.build_all(["stream_probe", "bucket_variants",
                              "hmatrix_product"])
    result = run_profile(device, tiny=args.cpu)
    bad = failures(result)
    result["failed"] = bad
    text = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text, flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
