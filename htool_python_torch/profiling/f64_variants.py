"""The float64 / complex128 product kernels built with one design choice
changed, timed on the card.

csrc/hmatrix_product_f64.cu takes its tuning choices as macros: the widest
pass that runs the narrow path (`HM_F64_NARROW_MAX` for float64,
`HM_C128_NARROW_MAX` for complex128), and the unrolling of the narrow COL
phase's loop over an item's rows (`HM_F64_COL_UNROLL`) and of both wide
loops (`HM_F64_WIDE_UNROLL`).  This module compiles the
source once per variant (`VARIANTS`, each a set of -D flags), swaps each
library in for the wrapper in turn, and times the product on the card
(device ms, `timing.device_ms`) on the headline operator assembled in
float64 (N = 40000 in the unit ball, 1/(0.1 + r), eps 1e-3, leaf 128) and
on a complex128 hermitian operator (N = 8000 on the sphere,
exp(10i(x0 - y0)) / (0.1 + r), eps 1e-6, leaf 128, storage H-L), each
against the plain version.

    python -m htool_python_torch.profiling.f64_variants [--out FILE]

Needs a CUDA card and nvcc; prints one JSON object.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys

import numpy as np

VARIANTS = {
    "shipped": [],
    "col_unroll_1": ["-DHM_F64_COL_UNROLL=1"],
    "wide_unroll_2": ["-DHM_F64_WIDE_UNROLL=2"],
    "real_narrow_to_16": ["-DHM_F64_NARROW_MAX=16"],
    "complex_narrow_to_8": ["-DHM_C128_NARROW_MAX=8"],
}
KS = (1, 8, 16, 32, 64)


def _build(names):
    """One nvcc per variant, all at once; {name: library path}."""
    from ..ops import cuda_build

    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = cuda_build.CSRC / cuda_build.SOURCES["hmatrix_product_f64"]
    procs = {}
    for name in names:
        lib = cuda_build.BUILD_DIR / f"f64_variant_{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, *VARIANTS[name],
             "-o", str(lib), str(src)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    out = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        out[name] = lib
    return out


def operators(device):
    """{'headline_f64': (HMatrix, symmetry), 'hermitian_c128': ...}."""
    import torch

    from .. import ClusterTreeBuilder, HMatrixTreeBuilder, KernelGenerator
    from ..models.geometry import (create_random_points_in_sphere,
                                   create_random_points_on_sphere)
    from ..models.kernels import hermitian_phase_kernel, inverse_distance_kernel

    recipes = {
        "headline_f64": (create_random_points_in_sphere(
            40000, np.random.RandomState(0)), inverse_distance_kernel(0.1),
            1e-3, torch.float64, "N", "N"),
        "hermitian_c128": (create_random_points_on_sphere(
            8000, np.random.RandomState(1)), hermitian_phase_kernel(10.0),
            1e-6, torch.complex128, "H", "L")}
    out = {}
    for name, (points, kernel, eps, dtype, sym, uplo) in recipes.items():
        builder = ClusterTreeBuilder()
        builder.set_maximal_leaf_size(128)
        cluster = builder.create_cluster_tree(points, 2)
        hb = HMatrixTreeBuilder(eps, 10.0, sym, uplo, device=device)
        hb.set_dtype(dtype)
        out[name] = (hb.build(KernelGenerator(kernel, points, points,
                                              is_complex=dtype.is_complex,
                                              device=device),
                              cluster, cluster), sym)
    return out


def run(ks=KS):
    import torch

    from ..ops import cuda_build, cuda_matvec
    from ..ops.matvec import apply_hmatrix_padded
    from .timing import device_ms

    if not torch.cuda.is_available():
        raise RuntimeError("f64_variants times the kernels on a CUDA card")
    device = torch.device("cuda")
    libs = _build(VARIANTS)
    ops = operators(device)
    result = {"device": torch.cuda.get_device_name(0), "variants": {}}
    plain = {}
    for label, (hm, sym) in ops.items():
        data, L, n = hm._product_data(), hm._pad_len, hm.shape[0]
        for k in ks:
            g = torch.Generator(device).manual_seed(k)
            x = torch.zeros((L, k), dtype=hm.dtype, device=device)
            x[:n] = torch.rand((n, k), dtype=hm.dtype, device=device,
                               generator=g)
            plain[label, k] = x, apply_hmatrix_padded(data, x, L, "N", sym)
    load = cuda_build.load
    try:
        for name, path in libs.items():
            lib = ctypes.CDLL(str(path))
            cuda_build.load = lambda _name, lib=lib: lib
            cuda_matvec._LIBS.pop(cuda_matvec.F64_LIBRARY, None)
            cases = {}
            for label, (hm, sym) in ops.items():
                data, table, L = (hm._product_data(), hm._bucket_table(),
                                  hm._pad_len)
                for k in ks:
                    x, y_plain = plain[label, k]

                    def product():
                        return cuda_matvec.apply_hmatrix_cuda(
                            data, x, L, "N", sym, table)

                    cases[f"{label}/k{k}"] = {
                        "device_ms": device_ms(product),
                        "max_rel_err": float((product() - y_plain).abs().max()
                                             / y_plain.abs().max())}
            result["variants"][name] = cases
            print(name, json.dumps(cases), file=sys.stderr, flush=True)
    finally:
        cuda_build.load = load
        cuda_matvec._LIBS.pop(cuda_matvec.F64_LIBRARY, None)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the JSON object to this file")
    args = ap.parse_args(argv)
    text = json.dumps(run())
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
