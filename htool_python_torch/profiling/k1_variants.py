"""Kernels K1 and K2 built with one design choice changed, timed on the
card.

The ring's stage count, the way x rows reach a stage on the tensor-core
path, the column count from which the tensor cores take over from FFMA
(real and complex), whether the FFMA path splits a small-rank strip's
columns over the warps, and whether the consumers do any arithmetic at all
are choices of htool_python_torch/csrc/hmatrix_product.cu (K1 and K2, one
body) that only a measurement can make.  This module compiles the source
once per variant (each a textual edit of the shipped source, `VARIANTS`),
swaps each library in for the kernels' wrapper in turn, and times the
product on the card (device ms, `timing.device_ms`) on the headline
operator (N = 40000, 1/(0.1 + r), eps 1e-3, leaf 128), the hlu operator
(N = 32768 on the sphere, second_kind_kernel(0.5, 0.5 N), eps 1e-3, leaf
64) and, for K2, the Helmholtz operator (N = 100000 on the sphere,
exp(10i(x0 - y0)) / (0.1 + r), eps 1e-6, leaf 128, complex64, after
recompression: chip_smoke.py's), against the plain version where the
variant still computes the product.

    python -m htool_python_torch.profiling.k1_variants [--out FILE]

Needs a CUDA card and nvcc; prints one JSON object.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys

import numpy as np

# name -> [(text of the shipped source, its replacement), ...]; "shipped"
# is the source as it is
_MATH = ("        if constexpr (KC == kTC) {\n"
         "            if (is_row(h.kind))\n"
         "                tc_row_strip")
_MATH_END = ("        __syncwarp();\n"
             "        if (lane == 0) mbar_arrive(empty + stage);")
STAGES = "constexpr int kStages = 3;"
X_BULK_FROM = "k % 4 == 0 && ld % 4 == 0 && k >= 64"
FMA_REAL = "constexpr int kFmaColsReal = 8;"
FMA_COMPLEX = "constexpr int kFmaColsComplex = 8;"
SPLIT_REAL = "constexpr bool kSplitRowsReal = true;"
SPLIT_COMPLEX = "constexpr bool kSplitRowsComplex = true;"
VARIANTS = {
    "shipped": [],
    "stages_2": [(STAGES, "constexpr int kStages = 2;")],
    "stages_4": [(STAGES, "constexpr int kStages = 4;")],
    "stages_6": [(STAGES, "constexpr int kStages = 6;")],
    "x_bulk_rows_from_k16": [(X_BULK_FROM,
                              "k % 4 == 0 && ld % 4 == 0 && k >= 16")],
    "x_cp_async_rows": [(X_BULK_FROM, "k % 4 == 0 && ld % 4 == 0 && false")],
    "complex_tc_from_k3": [(FMA_COMPLEX,
                            "constexpr int kFmaColsComplex = 2;")],
    "complex_tc_from_k5": [(FMA_COMPLEX,
                            "constexpr int kFmaColsComplex = 4;")],
    "real_tc_from_k5": [(FMA_REAL, "constexpr int kFmaColsReal = 4;")],
    "complex_unsplit_rows": [(SPLIT_COMPLEX,
                              "constexpr bool kSplitRowsComplex = false;")],
    "real_unsplit_rows": [(SPLIT_REAL,
                           "constexpr bool kSplitRowsReal = false;")],
    "no_math": [("<math>", "")],
    "no_math_stages_4": [("<math>", ""), (STAGES,
                                          "constexpr int kStages = 4;")],
}
# variants whose output is not the product
NO_PRODUCT = ("no_math", "no_math_stages_4")


def variant_source(source: str, name: str) -> str:
    """The shipped source with variant `name`'s edits; raises if an edit
    no longer matches the source."""
    for old, new in VARIANTS[name]:
        if old == "<math>":  # drop the consumers' block arithmetic
            a, b = source.find(_MATH), source.find(_MATH_END)
            if a < 0 or b < a:
                raise ValueError("the consumers' arithmetic is not found")
            source = source[:a] + source[b:]
            continue
        if old not in source:
            raise ValueError(f"variant {name}: {old!r} is not in the source")
        source = source.replace(old, new)
    return source


def _build(names):
    """One nvcc per variant, all at once; {name: library path}."""
    from ..ops import cuda_build

    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    source = (cuda_build.CSRC
              / cuda_build.SOURCES["hmatrix_product"]).read_text()
    procs = {}
    for name in names:
        src = cuda_build.BUILD_DIR / f"k1_variant_{name}.cu"
        src.write_text(variant_source(source, name))
        lib = src.with_suffix(".so")
        procs[name] = (lib, subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(lib),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    out = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        out[name] = lib
    return out


def operators(device):
    """{'headline', 'hlu', 'helmholtz': HMatrix} at their full sizes (see
    the module docstring)."""
    import torch

    from .. import (ClusterTreeBuilder, HMatrixTreeBuilder, KernelGenerator,
                    recompression)
    from ..models.geometry import (create_random_points_in_sphere,
                                   create_random_points_on_sphere)
    from ..models.kernels import (hermitian_phase_kernel,
                                  inverse_distance_kernel, second_kind_kernel)

    recipes = {
        "headline": (create_random_points_in_sphere(
            40000, np.random.RandomState(0)), inverse_distance_kernel(0.1),
            128, 1e-3, torch.float32),
        "hlu": (create_random_points_on_sphere(
            32768, np.random.RandomState(11)),
            second_kind_kernel(0.5, 0.5 * 32768), 64, 1e-3, torch.float32),
        "helmholtz": (create_random_points_on_sphere(
            100000, np.random.RandomState(1)), hermitian_phase_kernel(10.0),
            128, 1e-6, torch.complex64)}
    out = {}
    for name, (points, kernel, leaf, eps, dtype) in recipes.items():
        builder = ClusterTreeBuilder()
        builder.set_maximal_leaf_size(leaf)
        cluster = builder.create_cluster_tree(points, 2)
        hb = HMatrixTreeBuilder(eps, 10.0, "N", "N", device=device)
        hb.set_dtype(dtype)
        out[name] = hb.build(KernelGenerator(kernel, points, points,
                                             is_complex=dtype.is_complex,
                                             device=device),
                             cluster, cluster)
        if dtype.is_complex:
            recompression(out[name])
    return out


def run(ks=(1, 8, 32, 128)):
    import torch

    from ..ops import cuda_build, cuda_matvec
    from ..ops.matvec import apply_hmatrix_padded
    from .timing import device_ms

    if not torch.cuda.is_available():
        raise RuntimeError("k1_variants times the kernel on a CUDA card")
    device = torch.device("cuda")
    libs = _build(VARIANTS)
    ops = operators(device)
    result = {"device": torch.cuda.get_device_name(0), "variants": {}}
    plain = {}  # (operator, k) -> (x, the plain version's product)
    for label, hm in ops.items():
        data, L, n = hm._product_data(), hm._pad_len, hm.shape[0]
        for k in ks:
            g = torch.Generator(device).manual_seed(k)
            x = torch.zeros((L, k), dtype=hm.dtype, device=device)
            x[:n] = torch.rand((n, k), dtype=hm.dtype, device=device,
                               generator=g)
            plain[label, k] = x, apply_hmatrix_padded(data, x, L, "N", "N")
    load = cuda_build.load
    try:
        for name, path in libs.items():
            lib = ctypes.CDLL(str(path))
            cuda_build.load = lambda _name, lib=lib: lib
            cuda_matvec._LIBS.clear()  # the next product loads `lib`
            cases = {}
            for label, hm in ops.items():
                data, table, L = (hm._product_data(), hm._bucket_table(),
                                  hm._pad_len)
                for k in ks:
                    x, y_plain = plain[label, k]

                    def product():
                        return cuda_matvec.apply_hmatrix_cuda(
                            data, x, L, "N", "N", table)

                    case = {"device_ms": device_ms(product)}
                    if name not in NO_PRODUCT:
                        case["max_rel_err"] = float(
                            (product() - y_plain).abs().max()
                            / y_plain.abs().max())
                    cases[f"{label}/k{k}"] = case
            result["variants"][name] = cases
            print(name, json.dumps(cases), file=sys.stderr, flush=True)
    finally:
        cuda_build.load = load
        cuda_matvec._LIBS.clear()
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the JSON object to this file")
    args = ap.parse_args(argv)
    result = run()
    text = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
