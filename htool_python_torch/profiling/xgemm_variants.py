"""Kernel P3's 'xgemm' term built with one design choice changed, timed on
the card.

What holds `xgemm_kernel` (htool_python_torch/csrc/bucket_variants.cu)
short of the read rate is a question only a measurement answers: the
ring's depth, the x segments staged at each group's start, the consumers'
arithmetic (each GEMM, the TF32 rounding), the barrier between the two
GEMMs of a low-rank block, its atomics into y.  This module compiles the source once per
variant (each a textual edit of the shipped source, `VARIANTS`), swaps
each library in for P3's wrapper in turn, and times 'xgemm' (gather
'roll', accum 'roll') by CUDA events on the profiling path's two buckets
(384 MiB each, L = 40960: `bucket_variants.CASES`), beside the 'stream'
variant of the same build (every slab byte read, no arithmetic), and
checks it against the plain version where the variant still computes the
product.

    python -m htool_python_torch.profiling.xgemm_variants [--out FILE]

Needs a CUDA card and nvcc; prints one JSON object.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys

_LR_PARTIAL = """                lr_partial(S, c.rows, X, p.sx, c.r, c.G, c.ps, g, warp, lane, wp + warp * c.r);
"""
_BARRIER = "                consumer_sync();  // the partials are in\n"
_LR_UPDATE = """                lr_update(S, c.rows, wp, c.r, c.G, c.pt, g, warp, lane, out);
"""
_LR_ATOMICS = """                    accum<ACCUM>(c, t, col, X[b * p.sx + col], dep);"""
_DENSE_MATH = """                dense_block<ACCUM>(c, S, X, p.sx, g, __ldg(c.t_off + first + g), warp, lane,
                                   dep);"""
_STAGE_X = "        stage_segments<GATHER, true>(X, c, first, c.G, c.ps, p.sx);"
_STAGES = "constexpr int kXMaxStages = 4;"
_TF32 = """    return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;"""
_NO_MATH = [(_LR_PARTIAL + _BARRIER + _LR_UPDATE, "                (void)wp;\n"),
            (_DENSE_MATH, "                (void)S;")]
_LR_WAIT = """                mbar_wait(full + stage, parity);
                const float* S = ring + (long long)stage * p.stage_floats;
                float* wp"""
_GROUP_START = """        consumer_sync();  // every warp is done with the previous group's X
"""
_LR_OUT = """            // out row b is block b's result."""
# the cycles (clock64) of each phase of a low-rank block, summed in each
# warp's registers and added into y[0 .. 5] at the kernel's end: wait for
# the stage, first GEMM, barrier, second GEMM, then per group: staging x,
# the atomics into y
_CONSUMERS = """    int stage = 0;
    uint32_t parity = 0;
    for (long long grp = blockIdx.x; grp < n_groups; grp += gridDim.x) {
        const long long first = grp * c.G;"""
_KERNEL_END = """            if (threadIdx.x == 0) c.sink[grp] = total;
        }
    }
}"""
PHASE_CYCLES = [
    (_CONSUMERS, "    long long cyc[6] = {};\n" + _CONSUMERS),
    (_KERNEL_END, _KERNEL_END[:-2] + "\n    if (lane == 0)\n        for (int q = 0; q < 6; ++q)"
     " atomicAdd(c.y + q, (float)cyc[q]);\n}"),
    (_LR_WAIT, "                long long q0 = clock64();\n" + _LR_WAIT),
    (_LR_PARTIAL, "                long long q1 = clock64();\n"
     "                cyc[0] += q1 - q0;\n" + _LR_PARTIAL
     + "                long long q2 = clock64();\n"
     "                cyc[1] += q2 - q1;\n"),
    (_BARRIER + _LR_UPDATE, _BARRIER + "                long long q3 = clock64();\n"
     "                cyc[2] += q3 - q2;\n" + _LR_UPDATE
     + "                cyc[3] += clock64() - q3;\n"),
    (_GROUP_START, "        long long q4 = clock64();\n" + _GROUP_START),
    ("        if constexpr (KIND == kLr) {\n            float out",
     "        cyc[4] += clock64() - q4;\n"
     "        if constexpr (KIND == kLr) {\n            float out"),
    (_LR_OUT, "            long long q5 = clock64();\n" + _LR_OUT),
    ("        } else {\n            for (int g = 0; g < c.G; ++g) {",
     "            cyc[5] += clock64() - q5;\n"
     "        } else {\n            for (int g = 0; g < c.G; ++g) {"),
]
_MMA = r"""        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0])"""
_MMA_ASM = r"""    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));"""
PHASES = ("wait", "first_gemm", "barrier", "second_gemm", "group_staging",
          "group_atomics")
# name -> [(text of the shipped source, its replacement), ...]
VARIANTS = {
    "shipped": [],
    "stages_2": [(_STAGES, "constexpr int kXMaxStages = 2;")],
    "stages_3": [(_STAGES, "constexpr int kXMaxStages = 3;")],
    "stages_6": [(_STAGES, "constexpr int kXMaxStages = 6;")],
    "no_lr_barrier": [(_BARRIER, "")],
    "no_x_staging": [(_STAGE_X, "")],
    "no_math": _NO_MATH,
    "lr_no_first_gemm": [(_LR_PARTIAL, "")],
    "lr_no_second_gemm": [(_LR_UPDATE, "")],
    "lr_no_atomics": [(_LR_ATOMICS, "                    dep += X[b * p.sx + col];")],
    # the operands passed to the tensor cores unrounded (as raw f32 bits)
    "no_tf32_rounding": [(_TF32, "    return __float_as_uint(v);")],
    # the same rounding by the conversion instruction
    "cvt_tf32_rounding": [(_TF32, "    uint32_t t;\n"
                           "    asm(\"cvt.rna.tf32.f32 %0, %1;\\n\" : \"=r\"(t) : \"f\"(v));\n"
                           "    return t;")],
    "lr_phase_cycles": PHASE_CYCLES,
    # every tensor-core product issued twice (what one more costs)
    "mma_twice": [(_MMA, r"""        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0])""")],
    # no tensor cores: four FFMA in place of each product, on the same
    # operands (what the loads, roundings and control cost)
    "no_mma": [(_MMA_ASM, """    c[0] = fmaf(__uint_as_float(a[0]), __uint_as_float(b0), c[0]);
    c[1] = fmaf(__uint_as_float(a[1]), __uint_as_float(b1), c[1]);
    c[2] = fmaf(__uint_as_float(a[2]), __uint_as_float(b0), c[2]);
    c[3] = fmaf(__uint_as_float(a[3]), __uint_as_float(b1), c[3]);""")],
}
# variants whose output is not the product
NO_PRODUCT = ("no_lr_barrier", "no_x_staging", "no_math", "lr_no_first_gemm",
              "lr_no_second_gemm", "lr_no_atomics", "lr_phase_cycles",
              "mma_twice", "no_mma")


def variant_source(source: str, name: str) -> str:
    """The shipped source with variant `name`'s edits; raises if an edit
    no longer matches the source."""
    for old, new in VARIANTS[name]:
        if old not in source:
            raise ValueError(f"variant {name}: {old!r} is not in the source")
        source = source.replace(old, new)
    return source


def _build(names):
    """One nvcc per variant, all at once; {name: library path}."""
    from ..ops import cuda_build

    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    source = (cuda_build.CSRC
              / cuda_build.SOURCES["bucket_variants"]).read_text()
    procs = {}
    for name in names:
        src = cuda_build.BUILD_DIR / f"xgemm_variant_{name}.cu"
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


def run(reps=20):
    import torch

    from ..ops import cuda_build
    from . import bucket_variants as bv
    from .timing import cuda_ms

    if not torch.cuda.is_available():
        raise RuntimeError("xgemm_variants times the kernel on a CUDA card")
    device = torch.device("cuda")
    libs = _build(VARIANTS)
    g = torch.Generator(device).manual_seed(5)
    L = bv.LENGTH
    buckets = {}
    for kind, r, pt, ps, G in bv.CASES:
        nb, _ = bv.case_blocks(kind, bv.TOTAL_MB, G, r, pt, ps)
        slabs = torch.randn((nb, bv.slab_rows(kind, r, pt), max(pt, ps)),
                            device=device, generator=g)
        offs = tuple(torch.randint(0, L - w - 256, (nb,), device=device,
                                   generator=g, dtype=torch.int32)
                     for w in (pt, ps))
        x = torch.randn((1, L), device=device, generator=g)
        args = (kind, "roll", "xgemm", "roll", slabs, offs, x, L, G, r, pt,
                ps)
        y_plain = bv.bucket_variant_plain(*args)
        buckets[kind] = args, y_plain, bv.kernel_tolerance(*args, y_plain)
    result = {"device": torch.cuda.get_device_name(0), "variants": {}}
    load = cuda_build.load
    try:
        for name, path in libs.items():
            lib = ctypes.CDLL(str(path))
            cuda_build.load = lambda _name, lib=lib: lib
            bv._LIBS.clear()  # the next launch loads `lib`
            cases = {}
            for kind, (args, y_plain, tol) in buckets.items():
                stream = (kind, "none", "skip", "skip", *args[4:])
                case = {"ms": cuda_ms(lambda: bv.bucket_variant(*args),
                                      reps=reps),
                        "stream_ms": cuda_ms(
                            lambda: bv.bucket_variant(*stream), reps=reps)}
                if name == "lr_phase_cycles" and kind == "lr":
                    # cycles a warp spends in each phase, per block (the
                    # group phases per group)
                    y = bv.bucket_variant(*args)[0, :len(PHASES)].tolist()
                    nb = args[4].shape[0]
                    per = [nb, nb, nb, nb, nb // args[8], nb // args[8]]
                    case["cycles_per_warp"] = {
                        ph: v / (bv.XGEMM_WARPS * n)
                        for ph, v, n in zip(PHASES, y, per)}
                if name not in NO_PRODUCT:
                    case["within_tolerance"] = bool(
                        ((bv.bucket_variant(*args) - y_plain).abs()
                         <= tol).all())
                cases[kind] = case
            result["variants"][name] = cases
            print(name, json.dumps(cases), file=sys.stderr, flush=True)
    finally:
        cuda_build.load = load
        bv._LIBS.clear()
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
