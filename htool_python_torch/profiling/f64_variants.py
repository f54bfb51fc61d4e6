"""The float64 / complex128 product kernels built with one design choice
changed, timed on the card.

csrc/hmatrix_product_f64.cu takes its design choices as macros: the ring's
depth (`HM_F64_STAGES`), each warp's output tiles added into y by bulk
reductions rather than one f64 atomic per value (`HM_F64_BULK_REDUCE`),
the widest pass (doubles of an x row) that runs the narrow DFMA path
rather than the FP64 tensor cores (`HM_F64_NARROW_MAX`), and on those the
tensor cores (`mma.sync.m8n8k4.f64`) or DFMA on the same fragments
(`HM_F64_DMMA`); `HM_F64_PHASE_CYCLES` makes each warp add its clock64
counts of each phase into y[0 .. 5] (`PHASES`; the
output is then not the product).  This module compiles the source once
per variant (`VARIANTS`, each a set of -D flags; with `--parent FILE` also
an earlier body of the file, `parent`, which has the float64 and
complex128 entry points only), swaps each library in for the wrapper in
turn, and times the product on the card (device ms, `timing.device_ms`)
against the plain version on three operators: the headline assembled in
float64 (N = 40000 in the unit ball, 1/(0.1 + r), eps 1e-3, leaf 128), the
same in float32 with a float64 x (the float-storage instantiation), and a
complex128 hermitian operator (N = 8000 on the sphere, exp(10i(x0 - y0)) /
(0.1 + r), eps 1e-6, leaf 128, storage H-L).

    python -m htool_python_torch.profiling.f64_variants [--parent FILE] [--out FILE]

Needs a CUDA card and nvcc; prints one JSON object.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np

VARIANTS = {
    "shipped": [],
    "bulk_reduce": ["-DHM_F64_BULK_REDUCE=1"],
    "dfma": ["-DHM_F64_DMMA=0"],
    "dmma_from_1": ["-DHM_F64_NARROW_MAX=0"],
    "narrow_to_8": ["-DHM_F64_NARROW_MAX=8"],
    "stages_3": ["-DHM_F64_STAGES=3"],
    "phase_cycles": ["-DHM_F64_PHASE_CYCLES=1"],
    "phase_cycles_bulk": ["-DHM_F64_PHASE_CYCLES=1", "-DHM_F64_BULK_REDUCE=1"],
}
# the consumer warps' phases (y[0 .. 4], summed over warps) and the
# producer's (y[5])
PHASES = ("consumer_wait", "row_math", "col_math", "output", "phase_end",
          "producer_wait")
KS = (1, 4, 8, 9, 16, 32, 64, 129)
CYCLE_KS = (1, 4, 8, 64)


def _build(names, parent=None):
    """One nvcc per variant, all at once; {name: library path}.  `parent`:
    the source of an earlier body, built as variant 'parent'."""
    from ..ops import cuda_build

    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = cuda_build.CSRC / cuda_build.SOURCES["hmatrix_product_f64"]
    jobs = {name: (src, VARIANTS[name]) for name in names}
    if parent is not None:
        psrc = cuda_build.BUILD_DIR / "f64_variant_parent.cu"
        psrc.write_text(Path(parent).read_text())
        jobs["parent"] = (psrc, [])
    procs = {}
    for name, (source, flags) in jobs.items():
        lib = cuda_build.BUILD_DIR / f"f64_variant_{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, *flags, "-o",
             str(lib), str(source)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        out[name] = lib
    return out


def operators(device):
    """{label: (HMatrix, symmetry, dtype of x)}."""
    import torch

    from .. import ClusterTreeBuilder, HMatrixTreeBuilder, KernelGenerator
    from ..models.geometry import (create_random_points_in_sphere,
                                   create_random_points_on_sphere)
    from ..models.kernels import hermitian_phase_kernel, inverse_distance_kernel

    ball = create_random_points_in_sphere(40000, np.random.RandomState(0))
    recipes = {
        "headline_f64": (ball, inverse_distance_kernel(0.1), 1e-3,
                         torch.float64, "N", "N", torch.float64),
        "headline_f32_f64x": (ball, inverse_distance_kernel(0.1), 1e-3,
                              torch.float32, "N", "N", torch.float64),
        "hermitian_c128": (create_random_points_on_sphere(
            8000, np.random.RandomState(1)), hermitian_phase_kernel(10.0),
            1e-6, torch.complex128, "H", "L", torch.complex128)}
    out = {}
    for name, (points, kernel, eps, dtype, sym, uplo, x_dtype) in \
            recipes.items():
        builder = ClusterTreeBuilder()
        builder.set_maximal_leaf_size(128)
        cluster = builder.create_cluster_tree(points, 2)
        hb = HMatrixTreeBuilder(eps, 10.0, sym, uplo, device=device)
        hb.set_dtype(dtype)
        out[name] = (hb.build(KernelGenerator(kernel, points, points,
                                              is_complex=dtype.is_complex,
                                              device=device),
                              cluster, cluster), sym, x_dtype)
    return out


def _bind_parent(lib):
    """The wrapper's library record for an earlier body, which has the
    float64 and complex128 entry points only."""
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.hm_f64_launch.argtypes = [p, ll, p, ll, p, ll, i, i, i, p]
    lib.hm_c128_launch.argtypes = [p, ll, p, ll, p, ll, i, i, i, i, i, p]
    lib.hm_f64_launch.restype = lib.hm_c128_launch.restype = i
    lib.hm_f64_error_string.argtypes = [i]
    lib.hm_f64_error_string.restype = ctypes.c_char_p
    return lib


def run(ks=KS, parent=None):
    import torch

    from ..ops import cuda_build, cuda_matvec
    from ..ops.matvec import apply_hmatrix_padded
    from .timing import device_ms

    if not torch.cuda.is_available():
        raise RuntimeError("f64_variants times the kernels on a CUDA card")
    device = torch.device("cuda")
    libs = _build(VARIANTS, parent)
    ops = operators(device)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    result = {"device": torch.cuda.get_device_name(0), "variants": {}}
    plain = {}
    for label, (hm, sym, x_dtype) in ops.items():
        data, L, n = hm._product_data(), hm._pad_len, hm.shape[0]
        for k in ks:
            g = torch.Generator(device).manual_seed(k)
            x = torch.zeros((L, k), dtype=x_dtype, device=device)
            x[:n] = torch.rand((n, k), dtype=x_dtype, device=device,
                               generator=g)
            plain[label, k] = x, apply_hmatrix_padded(data, x, L, "N", sym)
    load = cuda_build.load
    try:
        for name, path in libs.items():
            lib = ctypes.CDLL(str(path))
            cuda_build.load = lambda _name, lib=lib: lib
            cuda_matvec._LIBS.pop(cuda_matvec.F64_LIBRARY, None)
            if name == "parent":
                cuda_matvec._LIBS[cuda_matvec.F64_LIBRARY] = _bind_parent(lib)
            cases = {}
            for label, (hm, sym, x_dtype) in ops.items():
                if name == "parent" and hm.dtype != x_dtype:
                    continue  # no float-storage entry point
                data, table, L = (hm._product_data(), hm._bucket_table(),
                                  hm._pad_len)
                grid = min(sms, len(table.work.items))
                for k in ks:
                    x, y_plain = plain[label, k]

                    def product():
                        return cuda_matvec.apply_hmatrix_cuda(
                            data, x, L, "N", sym, table)

                    try:
                        case = {"device_ms": device_ms(product)}
                    except RuntimeError as e:  # e.g. no shared-memory plan
                        cases[f"{label}/k{k}"] = {"error": str(e)[:200]}
                        continue
                    y = product()
                    if name.startswith("phase_cycles"):
                        if k in CYCLE_KS:
                            extra = (torch.view_as_real(y - y_plain)
                                     if y.is_complex() else y - y_plain)
                            tot = extra.flatten()[:len(PHASES)].tolist()
                            per = [grid * 8] * 5 + [grid]
                            case["cycles_per_warp"] = {
                                ph: v / w for ph, v, w in zip(PHASES, tot,
                                                              per)}
                    else:
                        case["max_rel_err"] = float(
                            (y - y_plain).abs().max() / y_plain.abs().max())
                    cases[f"{label}/k{k}"] = case
            result["variants"][name] = cases
            print(name, json.dumps(cases), file=sys.stderr, flush=True)
    finally:
        cuda_build.load = load
        cuda_matvec._LIBS.pop(cuda_matvec.F64_LIBRARY, None)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="the source of an earlier body of "
                    "csrc/hmatrix_product_f64.cu, timed as variant 'parent'")
    ap.add_argument("--out", help="also write the JSON object to this file")
    args = ap.parse_args(argv)
    text = json.dumps(run(parent=args.parent))
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
