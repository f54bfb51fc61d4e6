"""Kernel K1 built with one design choice changed, timed on the card.

The ring's stage count, the way x rows reach a stage on the tensor-core
path, and whether the consumers do any arithmetic at all are choices of
htool_python_torch/csrc/hmatrix_product.cu that only a measurement can
make.  This module compiles the source once per variant (each a textual
edit of the shipped source, `VARIANTS`), swaps each library in for K1's
wrapper in turn, and times the product on the card (device ms,
`timing.device_ms`) on the headline operator (N = 40000, 1/(0.1 + r),
eps 1e-3, leaf 128) and the hlu operator (N = 32768 on the sphere,
second_kind_kernel(0.5, 0.5 N), eps 1e-3, leaf 64), against the plain
version where the variant still computes the product.

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
VARIANTS = {
    "shipped": [],
    "stages_2": [(STAGES, "constexpr int kStages = 2;")],
    "stages_4": [(STAGES, "constexpr int kStages = 4;")],
    "stages_6": [(STAGES, "constexpr int kStages = 6;")],
    "x_bulk_rows_from_k16": [(X_BULK_FROM,
                              "k % 4 == 0 && ld % 4 == 0 && k >= 16")],
    "x_cp_async_rows": [(X_BULK_FROM, "k % 4 == 0 && ld % 4 == 0 && false")],
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
    """{'headline': HMatrix, 'hlu': HMatrix} at their full sizes."""
    import torch

    from .. import ClusterTreeBuilder, HMatrixTreeBuilder, KernelGenerator
    from ..models.geometry import (create_random_points_in_sphere,
                                   create_random_points_on_sphere)
    from ..models.kernels import inverse_distance_kernel, second_kind_kernel

    out = {}
    for name, points, kernel, leaf in (
            ("headline", create_random_points_in_sphere(
                40000, np.random.RandomState(0)),
             inverse_distance_kernel(0.1), 128),
            ("hlu", create_random_points_on_sphere(
                32768, np.random.RandomState(11)),
             second_kind_kernel(0.5, 0.5 * 32768), 64)):
        builder = ClusterTreeBuilder()
        builder.set_maximal_leaf_size(leaf)
        cluster = builder.create_cluster_tree(points, 2)
        hb = HMatrixTreeBuilder(1e-3, 10.0, "N", "N", device=device)
        hb.set_dtype(torch.float32)
        out[name] = hb.build(KernelGenerator(kernel, points, points,
                                             device=device),
                             cluster, cluster)
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
                    g = torch.Generator(device).manual_seed(k)
                    x = torch.rand((L, k), device=device, generator=g)

                    def product():
                        return cuda_matvec.apply_hmatrix_cuda(
                            data, x, L, "N", "N", table)

                    case = {"device_ms": device_ms(product)}
                    if name not in NO_PRODUCT:
                        y, y_plain = product(), apply_hmatrix_padded(
                            data, x, L, "N", "N")
                        case["max_rel_err"] = float(
                            (y - y_plain).abs().max() / y_plain.abs().max())
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
