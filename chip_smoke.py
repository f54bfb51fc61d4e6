#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (htool_python_torch) on one GPU.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 chip_smoke.py            # headline N = 40000, Helmholtz N = 100000
    python3 chip_smoke.py --n 24000 --n-helm 20000   # a smaller rehearsal
    python3 chip_smoke.py --k1-buckets-only   # K1 bucket by bucket, alone
    python3 chip_smoke.py --k1-buckets-only --bucket-operators helmholtz
                                              # K2 bucket by bucket, alone

Phases, in this order, one line each (`phase <name> {json}`):
  device:       card name and power limit, kernel build seconds, ptxas
                reports (and `ptxas_xgemm` / `ptxas_f64`: registers and
                spills of each instantiation of P3's 'xgemm' kernel and
                of the f64 family's four), and the
                reconstruction error of a complex64 SVD on
                the card (torch.linalg.svd, and the port's double-precision
                svd);
  native_cluster: the headline tree (N points in the unit ball, seed 0)
                and the Helmholtz tree (N = --n-helm on the sphere, seed
                1), leaf 128, by the native C++ builder and by the numpy
                path: every node array and the permutation equal (centers
                and radii to 1e-12), both host times;
  main_path:    the headline pipeline — a random cloud in the unit ball,
                kernel 1/(0.1+r), eps 1e-3, eta 10, leaf 128, f32, storage
                'N' — through ClusterTreeBuilder -> HMatrixTreeBuilder.build
                -> HMatrix.matvec / @ in user numbering (k = 1 and 8), with
                kernel launches counted around the products and the sampled
                error against the dense oracle (<= 1e-3);
  permute:      the permute-in and permute-out kernels of the product in
                user numbering (`hm_permute_in` / `hm_permute_out`) at the
                benchmark cells' shapes: on the headline operator at k = 1
                and 128 (float32), after `helmholtz` on its operator at
                k = 8 (complex64), with the operator's own permutations;
                each bit for bit against its plain version (ops/matvec.py
                permute_in with y zeroed, permute_out), with ms (CUDA
                events, calls back to back from the host), device ms
                (queued behind a spin kernel), the plain version's ms,
                torch.index_select's (the gather alone) and the bytes
                bound; launches are the main path's (one each a product);
  surface:      every name of the reference's `__all__` lists (read from
                its source, not imported) imported from the port on this
                machine, without matplotlib; get_distributed_information()
                and lowrank_leaves() on the headline operator;
  example:      one line per example of htool_python_torch/examples/: its
                run() on the card (float32, so products run K1), its
                numbers, seconds and launches; a failed assertion fails
                the script, and use_hmatrix must launch K1;
  profiling:    the kernel-profiling path (python -m
                htool_python_torch.profiling) at the reference's sizes:
                P1 over its 7 buffer cases (384 MiB each), P2 over its 11
                block shapes (about 384 MiB each), the P4 gather probe, P3's
                six variants on the low-rank and the dense bucket (384 MiB
                each, L = 40960) and K1 on the same buckets, each timed by a
                device-resident chain (ms, GB/s, bound), with P1-P4's
                launches counted around it;
  profiling_check: P1-P4 against their plain versions on inputs drawn on
                the card at those shapes (every P1 and P2 case, P3's six
                variants and K1 on both buckets, P4 at the probe's shapes
                and on random indices), one line per case with its error,
                ms, plain ms, library ms (torch.sum(buf, 0) per buffer,
                A.sum(), torch.gather; none for P3) and bound: P1 within
                1e-5 relative, P2 within 1e-5 of 1e-30 sum|A|, P3 within
                1e-5 relative plus, for 'xgemm', the TF32 bound of
                csrc/bucket_variants.cu, K1 within 1e-5 of 'base', P4
                exact; each P3 case with its GB/s over the stored bytes and
                its share of P1's best rate in this phase, and 'xgemm' with
                its bound by TF32 operations beside the bytes';
  k1_buckets:   K1 on each bucket of the headline operator alone (and,
                after `helmholtz`, K2 on each bucket of the Helmholtz
                operator with a complex x; after `hlu`, K1 on the hlu
                operator), k = 1, 8 and 128, by
                CUDA events: ms, stored bytes, GB/s and the share of P1's
                best read rate in this run (its buffer cases, by CUDA
                events), and the sum over the buckets against the fused
                product's ms (the gap is the tail and the mix);
  product_time: product ms for k = 1 and 8 from a device-resident chain,
                effective GB/s over the stored bytes, a device-to-device
                copy rate, P1's best read rate of `profiling`, the
                product's fraction of each, and the bound; the chain and
                the host ms of one
                call again with K1's bucket table built on every call
                instead of once per operator;
  k1_sweeps:    K1's attribution sweeps (the reference's
                tools/profile_matvec9.py, 9b, 9d, 9e, 9f, 9g; python -m
                htool_python_torch.profiling.k1_sweeps) on the headline
                operator at k = 1, 8 and 128: the four synthetic families
                (block shape, width, power-of-two width, offset structure;
                384 MiB a case, drawn with numpy as the scripts draw them),
                the operator with its stored widths and padded to powers
                of two (the whole product and its three largest low-rank
                buckets alone) and 9g's 2 x 2 of real and random data and
                offsets on its largest low-rank bucket; one line per
                family, each case with ms (chain), device ms, GB/s, the
                share of P1's best read rate (its events rate of this run)
                and the bound; K1 within 1e-5 of its plain version at k = 1
                and 128 and each re-padded product within 1e-5 of the
                stored one; then a summary line (wall seconds, worst
                errors, K1's launches);
  k1_check:     kernel K1 against its plain version on the card, for
                trans N/T x storage N (the headline buckets), S-L, S-U
                (smaller assemblies) x k in {1, 2, 4, 8, 9, 32, 64, 128}
                (FFMA up to 8 columns, 3xTF32 tensor cores from 9), each
                within 1e-5 relative (the kernel sums with f32 atomics, in
                a varying order), both timed with CUDA events, beside the
                bound (`product_bound`: bytes, or operations at the f32
                rate, or at k > 8 three TF32 products at the TF32 rate);
  k1_complex_x: K1 on the real view of a complex64 x (H real: H (a + ib)
                = H a + i H b) against the plain version on the headline
                operator, k in {1, 4}, within 1e-5;
  helmholtz:    the complex path — N points on the unit sphere (seed 1),
                kernel exp(10i(x0 - y0)) / (0.1 + r), eps 1e-6, eta 10,
                leaf 128, complex64, storage 'N' — through the same entry
                points, then `recompression(hm)`, then hm * x and hm @ X
                (k = 8) on complex x, with K2's launches counted around
                the products; seconds of cluster, assembly (split) and
                recompression, stored bytes and compression before and
                after recompression, product ms for k = 1 and 8 from a
                device-resident chain, effective GB/s and the bound, and
                the sampled error on 200 rows against the dense oracle
                (<= 2e-6: eps, plus complex64 round-off of the same order);
  k2_check:     kernel K2 (K1's body on complex64) against its plain
                version for trans N/T/C x storage N (the Helmholtz
                buckets), H-L, H-U (hermitian kernel) and S-L (the
                complex-symmetric exp(10i r) / (0.1 + r)) on smaller sphere
                assemblies x k in {1, 2, 4, 8, 9, 32, 64, 128} ('fused':
                FFMA up to 8 columns, 3xTF32 tensor cores from 9, passes of
                64 columns) and {1, 4, 8} ('per_bucket', 'seq'), each
                within 1e-5 relative, both timed with CUDA events, beside
                `product_bound`;
  recompression_paths: seconds of both recompression paths (the SVD-form
                trim and the streaming QR + SVD) on the H-L operator, with
                the ranks and bytes they leave;
  distributed:  the reference's 2-partition stage — N points in the unit
                ball (seed 1), a 2-partition cluster, the headline kernel
                and eps — through DefaultApproximationBuilder: build
                seconds per block row, the global product ms (k = 1 and 8)
                from a device-resident chain through the distributed
                operator's device apply, the sampled error on 200 rows
                (<= 1e-3), K1's launches per product (one per block row),
                and the device apply against the same product with each
                block row in K1's plain version, k in {1, 8}, in each
                launch structure, within 1e-5 relative;
  ddm:          the reference's ddm_gmres stage — N = 20000 points, 4
                partitions, eps 1e-4, f32 — DefaultApproximationBuilder ->
                DDMSolverBuilder(op, block_diagonal_hmatrix) ->
                facto_one_level (batched dense LU, inverse) -> ASM
                right-preconditioned GMRES (restart 60, tol 1e-6, at most
                300 iterations): the setup split, peak memory, max |I - A
                A^-1| per subdomain, the block rows' check of the
                distributed phase on these 4 block rows, and for each solve
                (`ddm_solve` lines: cold — the first after the setup —,
                warm, warm under each of the launch structures
                'per_bucket' and 'seq', 4 right-hand sides) its iterations,
                ms per iteration, K1 launches by structure, GMRES's own
                residual estimate (<= 1e-6), the true residual |A x - f| /
                |f| through the distributed operator, and the same residual
                with the operator applied in float64 (the plain version on
                the host), both <= 1e-5.
  ddm_geneo:    the ddm problem (N points, P = 4, eps 1e-4, f32) with
                overlapping subdomains — two rounds of 8-nearest-neighbour
                growth around each partition (tools/generate_test_data.py's
                recipe, `overlap_decomposition`), dense local matrices from
                the generator — through DDMSolverBuilder(op, block_diagonal,
                generator, ovr, c2o, neighbors, intersections): a one-level
                ASM solve, then build_coarse_space with
                GeneoCoarseSpaceDenseBuilder (DAiD against Ki = A[ovr, ovr]
                in float64, 16 vectors a subdomain, scipy eigh on the host)
                and GeneoCoarseOperatorBuilder (E = Z^T A Z through K1 at k =
                64), then two-level solves cold, warm and with 4 right-hand
                sides (`ddm_geneo_solve` lines, the checks of `ddm`); the
                setup split (overlap, Ki, DAiD and eigh per subdomain, QR,
                E, E's LU), K1's launches in E, each subdomain's 16th
                eigenvalue, E and the coarse term on a random r against
                float64 on the CPU (within 1e-5), K1's device ms at k = 64
                on each block row beside its bound, and torch.linalg.eigh of
                one subdomain's pencil on the card (a measurement);
  k1al_check:   kernel K1-al (K1 on the aligned low-rank layout,
                ops/matvec.py align_lowrank) against its plain version on
                the same data, and K1 on the canonical layout against its
                plain version, storage N and S-L x trans N and T x k in {1,
                2, 4, 8, 9, 32, 64, 128}, each within 1e-5 relative, on the
                headline operator and its S-L twin (N = 40000, leaf 128)
                and on the hlu operator and its S-L twin (N = 32768, leaf
                64); with both times, both layouts' stored bytes and the
                bound (the canonical bytes);
  hlu:          the reference's pinned 32k factorization
                (tests/test_hier_local_solver.py:65-96): N points on the
                unit sphere (seed 11), second_kind_kernel(0.5, 0.5 N), eps
                1e-3, eta 10, leaf 64, f32 -> deepcopy -> lu_factorization
                (HODLR, no dense fallback) -> lu_solve('N', hm * x), then
                cholesky_factorization('L') / cholesky_solve, then
                lu_factorization with config.matvec_aligned_layout on
                (every product through K1-al); each `hlu_factorization`
                line has the HODLR build and factor seconds, the ranks per
                level, the products and launches of the build, solve ms
                (refinement included) and its device profile
                (torch.profiler), peak memory, and the residual (<
                eps) and error (< 10 eps); the `hlu` line adds the device
                profile of one LU factorization;
  surface_compact: after `k1_buckets` on the hlu operator, with the
                aligned layout on: K1-al's products before and after
                compact_for_products() (equal bit for bit where two calls
                before it agree bit for bit, else within 1e-5: f32
                atomics), the device memory it freed, to_dense raising;
  ddm_hier:     the reference's pinned hierarchical-tier solve
                (tests/test_hier_local_solver.py:21-62): N = 16384 on the
                sphere (seed 5), second_kind_kernel(0.5, 10), eps 1e-4,
                leaf 64, P = 2 (subdomains above ddm_local_dense_max and
                hodlr_threshold), block-Jacobi, ASM GMRES (restart 60, tol
                1e-6, at most 200 iterations): both local solvers HODLR,
                fewer than 200 iterations, true residual <= 1e-5 through
                the f32 operator and its f64 copy; the setup split, ms per
                iteration cold and warm, the wall ms of one apply plus
                preconditioner in a device-resident chain, the device busy
                ms, device operations and busy share of each and of one
                solve (torch.profiler), and the block rows' check of
                `distributed`.
  f64_check:    the float64 / complex128 kernels: the headline pipeline
                assembled in float64 (hm * x, hm @ X with their launches
                counted; sampled error <= 1e-3), a Helmholtz operator in
                complex128 (N = --n-k2 on the sphere, eps 1e-6; hm * x,
                hm @ X on complex x, sampled error <= 2e-6), then
                hmatrix_product_f64 on the headline (trans N / T) and
                hmatrix_product_complex128 on N, H-L (Helmholtz kernel) and
                S-L (exp(10i r) / (0.1 + r)) assemblies (trans N / T / C),
                k in {1, 8, 9, 64, 129}, each within 1e-12 of the plain
                version, timed with CUDA events beside `product_bound`
                (bytes, or flops at the FP64 tensor-core rate); its line
                also sums up `f64_promoted`;
  f64_promoted: run right after `k1al_check` on the headline's float32
                operator and after `k1_buckets` on the Helmholtz path's
                complex64 one (so that nothing is assembled twice): hm *
                x and hm @ X with numpy's float64 / complex128 x through
                hmatrix_product_f64_from_f32 /
                hmatrix_product_complex128_from_c64 (their launches
                counted; sampled error <= 1e-3 / <= 2e-6, the result in
                the wider dtype), then those kernels against their plain
                version (which promotes the operator, as the reference
                does), x float64 and complex128 on float32 data,
                complex128 on complex64, trans N / T, k in {1, 8, 9, 64},
                within 1e-12;
  sharded:      the sharded operator (parallel/sharded.py) on a world-1
                NCCL group: the headline kernel on --n-sharded points, P =
                4 partitions on this rank, float64 and float32; 'N', 'T'
                and 3-column products against the single-process
                DistributedOperator and the block rows' plain version
                (<= 1e-10 in f64, <= 1e-5 in f32), product ms (k = 1, 8);
                in f64 the sharded block-Jacobi preconditioner on the four
                dense subdomain matrices against a loop of solves and one
                GMRES solve to 1e-8 (iterations, ms each, launches); then
                `python -m htool_python_torch.parallel.dryrun` (one process
                per card) in a process of its own, which must exit 0;
  custom_hooks: the custom low-rank (truncated SVD on the host) and
                dense-block hooks on the headline kernel at --n-hooks
                points, f32: build seconds on the card and on the CPU, one
                dense-blocks call a build, K1's launches, the sampled error
                (<= 1e-3) and the card's product against the CPU build's
                (<= 1e-5).
Every kernel check (k1_check, k1_complex_x, k2_check) runs each case under
the three launch structures of config.matvec_kernel_mode ('fused',
'per_bucket', 'seq'); K1-al has the fused structure only.  The `ddm`
phase holds every structure to 44 +- 2 iterations.
Then `versus_before` (this run's product ms, K1 / K1-al ms on the hlu
operator, K2 ms on the Helmholtz operator, distributed product ms, ms per
DDM iteration and LU seconds beside the previous product kernels', as
PERF.md recorded them), a
`kernels` JSON line, the nvidia-smi line, and last the JSON ok line.  Any failure raises and exits non-zero; without a CUDA device the
script exits non-zero before printing any result.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

KERNEL_TOL = 1e-5  # f32 atomic summation order vs the plain version
F64_TOL = 1e-12  # f64 atomic summation order vs the plain version
# 8: one column tile; 9: two; 64: a whole pass (32 complex); 129: a third
F64_KS = (1, 8, 9, 64, 129)
PROMOTED_KS = (1, 8, 9, 64)  # the float-storage instantiations' checks
SHARDED_P = 4  # partitions of the sharded phase, on one rank
SHARDED_F64_TOL = 1e-10  # the reference dryrun's bar (__graft_entry__.py)
SHARDED_GMRES_TOL = 1e-8
SAMPLED_ERR_MAX = 1e-3  # the headline epsilon
HELM_EPS = 1e-6
HELM_ERR_MAX = 2 * HELM_EPS  # complex64 round-off is of the order of eps
DDM_EPS = 1e-4  # the reference's ddm_gmres stage (bench.py _stage_ddm)
DDM_TOL = 1e-6
DDM_MAX_IT = 300
# the ddm phase's iterations in every launch structure (every H100 run in
# PERF.md; the TPU reference took 48), kept within +-2
DDM_ITERATIONS = 44
# the true residual |A x - f| / |f| of the f32 solve, recomputed through
# the f32 product: GMRES stops at tol 1e-6 on its own estimate
DDM_TRUE_RES_MAX = 1e-5
# GenEO vectors a subdomain of the ddm_geneo phase: 4 x 16 = 64, one
# GeneoCoarseOperatorBuilder.COLUMN_CHUNK, so E's product is K1 at k = 64
DDM_GENEO_NU = 16
HLU_EPS = 1e-3  # tests/test_hier_local_solver.py:65-96
DDM_HIER_EPS = 1e-4  # tests/test_hier_local_solver.py:21-62
DDM_HIER_MAX_IT = 200
# columns of the K1 and K1-al checks: the FFMA widths (1-8), the first
# tensor-core width (9) and the HODLR peeling's chunks (32-128)
K1_KS = (1, 2, 4, 8, 9, 32, 64, 128)
K1_TIMED_KS = (1, 8, 32, 64, 128)
# the previous product kernels' numbers (PERF.md, their final runs on an
# H100 80GB HBM3 at 700 W: K1's of PR 5, K2's of PR 6), printed beside
# this run's in `versus_before`
BEFORE = {"product_ms_k1": 0.253, "product_ms_k8": 0.367,
          "k2_ms_k1": 1.019, "k2_ms_k8": 1.892,
          "k1_hlu_ms_k128": 1.282, "k1al_hlu_ms_k1": 0.063,
          "k1al_hlu_ms_k8": 0.129, "k1al_hlu_ms_k128": 1.148,
          "distributed_global_product_ms_k1": 0.42,
          "distributed_global_product_ms_k8": 0.50,
          "ddm_ms_per_iteration_warm": "1.6-1.9", "hlu_lu_s": 1.18,
          "ddm_hier_ms_per_iteration": "6.5-6.9"}


# this run's values of the metrics in BEFORE, filled by the phases
SUMMARY = {}


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def emit(phase, **fields):
    print(f"phase {phase} " + json.dumps(fields), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def ptxas_by_kernel(report, key):
    """{kernel: "registers ...; spills ..."} of the ptxas report's entry
    functions whose mangled name holds `key`, named by their template
    arguments: integers (xgemm_kernel<kind, gather, accum>) and the f64
    family's element types (<float, double, 4>; a repeated type is mangled
    as a substitution, S..._, and named as the one before it)."""
    import re

    types = {"d": "double", "f": "float", "7double2": "double2",
             "6float2": "float2"}
    token = r"7double2|6float2|S\w*?_|Li\d+E|d|f"

    def template_args(mangled):
        m = re.match(r"I((?:%s)+)E" % token, mangled.split(key, 1)[1])
        names = []
        for tok in re.findall(token, m.group(1) if m else ""):
            if tok.startswith("Li"):
                names.append(tok[2:-1])
            else:
                names.append(types.get(tok, names[-1] if names else tok))
        return ",".join(names)

    out, name = {}, None
    for line in report.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)", line)
        if m:
            name = m.group(1) if key in m.group(1) else None
            continue
        if name and ("registers" in line or "spill" in line):
            args = template_args(name)
            label = f"{key}<{args}>"
            out[label] = (out.get(label, "") + "; " + line.split(":")[-1]
                          .strip()).strip("; ")
    return out


def device_profile(torch, fn, reps=10, top=6):
    """The device activity (kernels, copies, fills) that torch.profiler
    records over `reps` calls of fn after one warm-up call, per call: its
    summed duration (busy ms), the number of activities, the wall ms
    (profiler on), the busy share of the wall time, and the `top`
    activities by duration."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms, count = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, count + 1)
    busy = sum(ms for ms, _ in by_name.values())
    return {"busy_ms": busy / reps, "wall_ms": wall_ms / reps,
            "busy_share": busy / wall_ms,
            "device_ops": sum(c for _, c in by_name.values()) / reps,
            "top": [{"name": name[:90], "ms": ms / reps, "count": c / reps}
                    for name, (ms, c) in sorted(by_name.items(),
                                                key=lambda kv: -kv[1][0])[:top]]}


def copy_rate_gbs(torch, device, nbytes=1 << 30):
    """Device-to-device copy rate (bytes read + written per second)."""
    from htool_python_torch.profiling.timing import cuda_ms

    src = torch.rand(nbytes // 4, device=device)
    dst = torch.empty_like(src)
    ms = cuda_ms(lambda: dst.copy_(src), reps=20)
    return 2 * nbytes / (ms * 1e-3) / 1e9


def svd_check(torch, device):
    """Relative reconstruction error max |U S Vh - A| / max |A| of
    torch.linalg.svd in complex64 on the card, against the port's svd
    (ops/aca.py: the same call in complex128, cast back), on a batch of
    random 96 x 96 matrices (the size of a block's rank core)."""
    from htool_python_torch.ops.aca import svd

    g = torch.Generator(device).manual_seed(0)
    A = torch.randn((256, 96, 96), dtype=torch.complex64, device=device,
                    generator=g)
    out = {}
    for name, fn in (("torch_linalg_svd_c64",
                      lambda a: torch.linalg.svd(a, full_matrices=False)),
                     ("port_svd_c64", svd)):
        U, s, Vh = fn(A)
        err = (U * s[:, None, :].to(U.dtype)) @ Vh - A
        out[name] = float(err.abs().max() / A.abs().max())
    return out


def build_operator(T, torch, points, symmetry, UPLO, device, dtype=None):
    from htool_python_torch.models.kernels import inverse_distance_kernel

    builder = T.ClusterTreeBuilder()
    builder.set_maximal_leaf_size(128)
    t0 = time.perf_counter()
    cluster = builder.create_cluster_tree(points, 2)
    t_cluster = time.perf_counter() - t0
    gen = T.KernelGenerator(inverse_distance_kernel(0.1), points, points,
                            device=device)
    hb = T.HMatrixTreeBuilder(1e-3, 10.0, symmetry, UPLO, device=device)
    hb.set_dtype(dtype or torch.float32)
    t0 = time.perf_counter()
    hm = hb.build(gen, cluster, cluster)
    torch.cuda.synchronize()
    return hm, t_cluster, time.perf_counter() - t0


def sampled_error(points, x, y, rng, n_rows=200):
    """Relative error on n_rows sampled rows against the dense oracle
    1/(0.1 + r) (a complex x: its real and imaginary parts)."""
    rows = rng.choice(points.shape[1], n_rows, replace=False)
    d = np.linalg.norm(points[:, rows, None] - points[:, None, :], axis=0)
    y_exact = (1.0 / (0.1 + d)) @ x.astype(np.result_type(x, np.float64))
    return float(np.linalg.norm(y[rows] - y_exact) / np.linalg.norm(y_exact))


def main_path(T, torch, n, seed, device, counts):
    """The headline pipeline, with K1's launches counted around the
    products; returns the operator."""
    from htool_python_torch.hmatrix.assembly import ASSEMBLY_PROFILE
    from htool_python_torch.models.geometry import \
        create_random_points_in_sphere
    from htool_python_torch.ops import cuda_matvec
    from htool_python_torch.ops.matvec import stored_bytes

    rng = np.random.RandomState(seed)
    points = create_random_points_in_sphere(n, rng)
    hm, t_cluster, t_asm = build_operator(T, torch, points, "N", "N", device)
    profile = dict(ASSEMBLY_PROFILE)
    dense_e, lr_e, ranks = hm._storage_counts()
    data = hm._product_data()
    nbytes = stored_bytes(data)

    x1 = rng.rand(n).astype(np.float32)
    X8 = np.asfortranarray(rng.rand(n, 8).astype(np.float32))
    cuda_matvec.reset_launch_counts()
    y1 = hm * x1
    Y8 = hm @ X8
    torch.cuda.synchronize()
    counts.update(cuda_matvec.LAUNCH_COUNTS)

    check(y1.shape == (n,) and Y8.shape == (n, 8), "product shapes")
    check(np.isfinite(y1).all() and np.isfinite(Y8).all(),
          "non-finite product")
    err = sampled_error(points, x1, y1, rng)
    err8 = max(sampled_error(points, X8[:, c], Y8[:, c],
                             np.random.RandomState(c)) for c in range(8))
    emit("main_path", N=n, epsilon=1e-3, eta=10.0, leaf=128, dtype="float32",
         storage="N", cluster_s=t_cluster, assembly_s=t_asm,
         assembly_profile=profile, compressed_entries=int(dense_e + lr_e),
         stored_bytes=int(nbytes),
         compression_ratio=n * n / max(dense_e + lr_e, 1),
         dense_buckets=len(data["dense"]), lowrank_buckets=len(data["lr"]),
         blocks=hm.plan.nb_dense_blocks() + hm.plan.nb_lowrank_blocks(),
         max_rank=int(ranks.max()) if len(ranks) else 0,
         sampled_rel_error_k1=err, sampled_rel_error_k8_max=err8,
         launches=dict(counts))
    check(err <= SAMPLED_ERR_MAX and err8 <= SAMPLED_ERR_MAX,
          f"sampled error {err}, {err8} above {SAMPLED_ERR_MAX}")
    return hm


def chain_ms(torch, hm, k, seed, prepared=True):
    """Product ms from a device-resident chain in internal numbering
    (normalized power iteration), 110 reps minus 10 reps over 100.
    prepared: pass the operator's BucketTable, as HMatrix products do;
    otherwise the wrapper builds and checks the table on every call."""
    from htool_python_torch.ops.cuda_matvec import apply_hmatrix_cuda

    L, n = hm._pad_len, hm.shape[0]
    data = hm._product_data()
    table = hm._bucket_table() if prepared else None
    g = torch.Generator(hm.device).manual_seed(seed)
    x0 = torch.zeros((L, k), dtype=hm.dtype, device=hm.device)
    x0[:n] = torch.rand((n, k), dtype=hm.dtype, device=hm.device,
                        generator=g)

    def run(reps):
        x = x0
        for _ in range(reps):
            y = apply_hmatrix_cuda(data, x, L, "N", "N", table)
            x = y * (1.0 / torch.linalg.vector_norm(y))
        return x

    run(3)
    times = {}
    for reps in (10, 110):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(reps)
        torch.cuda.synchronize()
        times[reps] = time.perf_counter() - t0
    return (times[110] - times[10]) / 100 * 1e3


def host_ms(torch, hm, prepared, reps=100):
    """Host ms per call of K1's wrapper: `reps` calls issued back to back,
    the clock stopped before the device finishes (launches are
    asynchronous, so this is the host's share unless a call waits for the
    device)."""
    from htool_python_torch.ops.cuda_matvec import apply_hmatrix_cuda

    L, data = hm._pad_len, hm._product_data()
    table = hm._bucket_table() if prepared else None
    x = torch.zeros((L, 1), device=hm.device)
    apply_hmatrix_cuda(data, x, L, "N", "N", table)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        apply_hmatrix_cuda(data, x, L, "N", "N", table)
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / reps * 1e3


def permute_cases(torch, hm, ks, seed, reps=50):
    """The permute-in and permute-out kernels at `hm`'s shapes (its n rows,
    padded length and dtype, its int32 permutations of trans 'N') for each
    k of `ks`, into buffers full of NaN: bit for bit against their plain
    versions, and timed (see the module docstring, `permute`).  Bytes: x,
    perm, x_pad and y for permute-in; y's n rows, inv and out for
    permute-out."""
    from htool_python_torch.ops import cuda_matvec as cm
    from htool_python_torch.ops.matvec import permute_in, permute_out
    from htool_python_torch.profiling.bounds import HBM_BYTES_PER_S

    n, L, dev, dt = int(hm.shape[1]), int(hm._pad_len), hm.device, hm.dtype
    p32, i32 = hm._device_perms("N", torch.int32)
    p64, i64 = p32.long(), i32.long()
    stream = torch.cuda.current_stream(dev).cuda_stream
    nan = float("nan")

    def same(a, b):  # bit for bit
        return torch.equal(a.contiguous().view(torch.uint8),
                           b.contiguous().view(torch.uint8))

    cases = []
    for k in ks:
        g = torch.Generator(dev).manual_seed(seed + k)
        x = torch.randn((n, k), dtype=dt, device=dev, generator=g)
        y_src = torch.randn((L, k), dtype=dt, device=dev, generator=g)
        x_pad, y, out = (torch.full(shape, nan, dtype=dt, device=dev)
                         for shape in ((L, k), (L, k), (n, k)))

        def run_in():
            cm.launch_permute_in(x, p32, x_pad, y, stream)

        def run_out():
            cm.launch_permute_out(y_src, i32, out, stream)

        run_in()
        run_out()
        x_plain = permute_in(x, p64, L, dt)
        out_plain = permute_out(y_src, i64, n)
        torch.cuda.synchronize()
        exact = {"permute_in": same(x_pad, x_plain)
                 and same(y, torch.zeros_like(y)),
                 "permute_out": same(out, out_plain)}
        row = k * x.element_size()
        nbytes = {"permute_in": n * row + 4 * n + 2 * L * row,
                  "permute_out": 2 * n * row + 4 * n}
        runs = {"permute_in": (run_in, lambda: (
                    permute_in(x, p64, L, dt),
                    torch.zeros((L, k), dtype=dt, device=dev)),
                    lambda: torch.index_select(x, 0, p64)),
                "permute_out": (run_out, lambda: permute_out(y_src, i64, n),
                                lambda: torch.index_select(y_src[:n], 0,
                                                           i64))}
        for name, (run, plain, library) in runs.items():
            case = dict(kernel=name, k=k, n=n, pad_len=L, dtype=str(dt),
                        bit_exact=exact[name], bytes=nbytes[name],
                        bound_ms=nbytes[name] / HBM_BYTES_PER_S * 1e3,
                        **_timed_case(run, plain, library, reps=reps,
                                      plain_reps=reps),
                        device_ms=device_ms(torch, run, reps=reps))
            emit("permute", **case)
            check(case["bit_exact"], f"permute: {name} at k = {k} differs "
                  "from its plain version")
            cases.append(case)
    return cases


def kernel_cases(torch, operators, phase, dtype, transes, ks=(1, 4, 8),
                 reps=30, plain_reps=5, other_ks=None, modes=None,
                 tol=KERNEL_TOL):
    """A kernel against its plain version on the card for every operator
    x trans x k x launch structure (config.matvec_kernel_mode), with x of
    `dtype`; kernel and plain version timed with CUDA events.  `other_ks`:
    the k of the 'per_bucket' and 'seq' structures where they differ from
    'fused''s `ks`; `modes`: the launch structures (all by default).  One
    line `phase <phase>` per case; fails above `tol` (the kernels' atomics
    sum in a varying order).  These launches are checks, not the main
    path."""
    from htool_python_torch.config import get_config
    from htool_python_torch.ops.cuda_matvec import MODES, apply_hmatrix_cuda
    from htool_python_torch.ops.matvec import apply_hmatrix_padded
    from htool_python_torch.profiling.bounds import product_bound
    from htool_python_torch.profiling.timing import cuda_ms

    cfg = get_config()
    results = []
    for (symmetry, UPLO), hm in operators.items():
        L, n = hm._pad_len, hm.shape[0]
        data, table = hm._product_data(), hm._bucket_table()
        g = torch.Generator(hm.device).manual_seed(7)
        for trans in transes:
            for k in ks:
                x = torch.zeros((L, k), dtype=dtype, device=hm.device)
                x[:n] = torch.rand((n, k), dtype=dtype, device=hm.device,
                                   generator=g)
                y_plain = apply_hmatrix_padded(data, x, L, trans, symmetry)
                plain_ms = cuda_ms(lambda: apply_hmatrix_padded(
                    data, x, L, trans, symmetry), reps=plain_reps, warmup=1)
                for mode in modes or MODES:
                    if mode != "fused" and other_ks and k not in other_ks:
                        continue
                    cfg.matvec_kernel_mode = mode
                    try:
                        y = apply_hmatrix_cuda(data, x, L, trans, symmetry,
                                               table)
                        torch.cuda.synchronize()
                        ms = cuda_ms(lambda: apply_hmatrix_cuda(
                            data, x, L, trans, symmetry, table), reps=reps)
                    finally:
                        cfg.matvec_kernel_mode = "fused"
                    abs_err = float((y - y_plain).abs().max())
                    rel = abs_err / float(y_plain.abs().max())
                    bound, bound_by = product_bound(data, L, k, dtype)
                    case = dict(storage=symmetry + ("-" + UPLO if UPLO != "N"
                                                    else ""),
                                N=n, trans=trans, k=k, mode=mode,
                                max_rel_err=rel, max_abs_err=abs_err, ms=ms,
                                plain_ms=plain_ms, bound_ms=bound,
                                bound_by=bound_by)
                    emit(phase, **case)
                    check(y.dtype == y_plain.dtype and np.isfinite(rel)
                          and rel <= tol,
                          f"{phase}: the kernel disagrees with its plain "
                          f"version: {case}")
                    results.append(case)
    return results


def helmholtz_sampled_error(points, x, y, rng, n_rows=200):
    """Relative error on n_rows sampled rows against the dense oracle
    exp(10i (x0 - y0)) / (0.1 + r)."""
    rows = rng.choice(points.shape[1], n_rows, replace=False)
    tx = points[:, rows]
    d = np.linalg.norm(tx[:, :, None] - points[:, None, :], axis=0)
    K = np.exp(1j * 10.0 * (tx[0][:, None] - points[0][None, :])) / (0.1 + d)
    y_exact = K @ x.astype(np.complex128)
    return float(np.linalg.norm(y[rows] - y_exact) / np.linalg.norm(y_exact))


def symmetric_phase_kernel(torch):
    """exp(10i r) / (0.1 + r): complex-symmetric (K(x, y) = K(y, x)), not
    hermitian; the 'S' storage case of the complex checks."""
    def k(x, y):
        r = torch.sqrt(torch.sum((x - y) ** 2, dim=-1))
        return torch.exp(10j * r) / (0.1 + r)
    return k


def build_complex(T, torch, points, kernel, symmetry, UPLO, device,
                  dtype=None):
    builder = T.ClusterTreeBuilder()
    builder.set_maximal_leaf_size(128)
    t0 = time.perf_counter()
    cluster = builder.create_cluster_tree(points, 2)
    t_cluster = time.perf_counter() - t0
    gen = T.KernelGenerator(kernel, points, points, is_complex=True,
                            device=device)
    hb = T.HMatrixTreeBuilder(HELM_EPS, 10.0, symmetry, UPLO, device=device)
    hb.set_dtype(dtype or torch.complex64)
    t0 = time.perf_counter()
    hm = hb.build(gen, cluster, cluster)
    torch.cuda.synchronize()
    return hm, t_cluster, time.perf_counter() - t0


def helmholtz(T, torch, n, seed, device, counts, copy_gbs):
    """The complex path, with the kernels' launches counted around it;
    returns (operator, product timing)."""
    from htool_python_torch.hmatrix.assembly import ASSEMBLY_PROFILE
    from htool_python_torch.models.geometry import \
        create_random_points_on_sphere
    from htool_python_torch.models.kernels import hermitian_phase_kernel
    from htool_python_torch.ops import cuda_matvec
    from htool_python_torch.ops.matvec import stored_bytes
    from htool_python_torch.profiling.bounds import product_bound

    points = create_random_points_on_sphere(n, np.random.RandomState(1))
    torch.cuda.reset_peak_memory_stats()
    cuda_matvec.reset_launch_counts()
    hm, t_cluster, t_asm = build_complex(
        T, torch, points, hermitian_phase_kernel(10.0), "N", "N", device)
    profile = dict(ASSEMBLY_PROFILE)
    before = dict(stored_bytes=stored_bytes(hm._product_data()),
                  compression_ratio=n * n / max(sum(hm._storage_counts()[:2]),
                                                1))
    t0 = time.perf_counter()
    T.recompression(hm)
    torch.cuda.synchronize()
    t_recomp = time.perf_counter() - t0
    dense_e, lr_e, ranks = hm._storage_counts()
    data = hm._product_data()
    nbytes = stored_bytes(data)

    rng = np.random.RandomState(seed)
    x1 = (rng.rand(n) + 1j * rng.rand(n)).astype(np.complex64)
    X8 = np.asfortranarray((rng.rand(n, 8) + 1j * rng.rand(n, 8))
                           .astype(np.complex64))
    y1 = hm * x1
    Y8 = hm @ X8
    torch.cuda.synchronize()
    counts.update(cuda_matvec.LAUNCH_COUNTS)

    check(y1.shape == (n,) and Y8.shape == (n, 8)
          and y1.dtype == np.complex64, "Helmholtz product shapes")
    check(np.isfinite(y1).all() and np.isfinite(Y8).all(),
          "non-finite Helmholtz product")
    err = helmholtz_sampled_error(points, x1, y1, rng)
    err8 = max(helmholtz_sampled_error(points, X8[:, c], Y8[:, c],
                                       np.random.RandomState(c))
               for c in range(8))
    timing = {}
    for k in (1, 8):
        ms = chain_ms(torch, hm, k, seed)
        bound, bound_by = product_bound(data, hm._pad_len, k)
        timing[k] = dict(product_ms=ms, effective_GBs=nbytes / ms / 1e6,
                         fraction_of_copy_rate=nbytes / ms / 1e6 / copy_gbs,
                         bound_ms=bound, bound_by=bound_by)
    emit("helmholtz", N=n, epsilon=HELM_EPS, eta=10.0, leaf=128,
         dtype="complex64", storage="N", kernel="exp(10i(x0-y0))/(0.1+r)",
         cluster_s=t_cluster, assembly_s=t_asm, assembly_profile=profile,
         recompression_s=t_recomp, before_recompression=before,
         stored_bytes=int(nbytes),
         compression_ratio=n * n / max(dense_e + lr_e, 1),
         dense_buckets=len(data["dense"]), lowrank_buckets=len(data["lr"]),
         blocks=hm.plan.nb_dense_blocks() + hm.plan.nb_lowrank_blocks(),
         max_rank=int(ranks.max()) if len(ranks) else 0,
         sampled_rel_error_k1=err, sampled_rel_error_k8_max=err8,
         copy_GBs=copy_gbs,
         product={f"k{k}": v for k, v in timing.items()},
         peak_memory_GB=torch.cuda.max_memory_allocated() / 1e9,
         launches=dict(counts))
    check(nbytes <= before["stored_bytes"],
          f"recompression grew the operator: {before['stored_bytes']} -> "
          f"{nbytes} bytes")
    check(err <= HELM_ERR_MAX and err8 <= HELM_ERR_MAX,
          f"Helmholtz sampled error {err}, {err8} above {HELM_ERR_MAX}")
    return hm, timing


def recompression_times(T, torch, hm):
    """Seconds of both recompression paths on deep copies of `hm` (the
    original is untouched), with the ranks and bytes they leave."""
    import copy

    from htool_python_torch.ops.matvec import stored_bytes

    out = {}
    for path, svd_form in (("svd_form", True), ("streaming", False)):
        h = copy.deepcopy(hm)
        h._lr_svd_form = svd_form
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        T.recompression(h)
        torch.cuda.synchronize()
        out[path] = dict(seconds=time.perf_counter() - t0,
                         rank_sum=int(sum(int(r.sum()) for r in h._lr_ranks)),
                         stored_bytes=stored_bytes(h._product_data()))
    out["before"] = dict(rank_sum=int(sum(int(r.sum())
                                          for r in hm._lr_ranks)),
                         stored_bytes=stored_bytes(hm._product_data()))
    return out


def apply_chain_ms(torch, fn, n, k, dtype, device, seed, reps=(10, 110)):
    """ms per call of fn, (n, k) -> (n, k), from a device-resident chain
    (normalized power iteration), reps[1] - reps[0] calls over the
    difference of the host clock around synchronize."""
    g = torch.Generator(device).manual_seed(seed)
    x0 = torch.rand((n, k), dtype=dtype, device=device, generator=g)

    def run(count):
        x = x0
        for _ in range(count):
            y = fn(x)
            x = y * (1.0 / torch.linalg.vector_norm(y))
        return x

    run(3)
    times = {}
    for count in reps:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(count)
        torch.cuda.synchronize()
        times[count] = time.perf_counter() - t0
    return (times[reps[1]] - times[reps[0]]) / (reps[1] - reps[0]) * 1e3


def float64_copy(T, torch, op):
    """The block-row operator `op` in float64 on the CPU (its products run
    the plain version): the exact arithmetic of the operator that an f32
    solve works with."""
    out = T.DistributedOperator(op.target_cluster, op.source_cluster,
                                device="cpu")
    for p in range(op.n_partitions):
        for local in op._global_to_local[p]:
            h = local.hmatrix
            data = h._product_data()
            h64 = T.HMatrix.from_arrays(
                h.plan, [D.double().cpu() for D, *_ in data["dense"]],
                [(Ut.double().cpu(), V.double().cpu())
                 for Ut, V, *_ in data["lr"]],
                h._lr_ranks, h.epsilon, torch.float64, "cpu")
            piece = T.LocalHMatrix(h64)
            piece.local_source_renumbering = local.local_source_renumbering
            out.add_global_to_local_operator(piece, p)
    return out


def plain_distributed_apply(torch, op):
    """The distributed operator's global product with each block row's
    product in its plain version (ops/matvec.py apply_hmatrix_padded),
    gathered and scattered as `build_device_apply` does: the yardstick of
    K1 on the block rows the distributed and ddm paths launch it on."""
    from htool_python_torch.ops.matvec import apply_hmatrix_padded
    from htool_python_torch.parallel.local_operator import LocalHMatrix

    device = op.device
    perm_s = torch.as_tensor(op.source_cluster.get_permutation(),
                             dtype=torch.int64, device=device)
    inv_t = torch.as_tensor(np.argsort(op.target_cluster.get_permutation()),
                            dtype=torch.int64, device=device)

    def apply(x2d):
        x_int = x2d[perm_s]
        y_int = torch.zeros((op.shape[0], x2d.shape[1]), dtype=x2d.dtype,
                            device=device)
        for p in range(op.n_partitions):
            t_off, t_sz = int(op.t_offsets[p]), int(op.t_sizes[p])
            for piece in op._operators(p):
                check(isinstance(piece, LocalHMatrix),
                      f"partition {p} holds a {type(piece).__name__}")
                h, s = piece.hmatrix, piece.local_source_renumbering
                nt, ns = h.shape
                t_base = h.plan.target_offset if h.plan.t_off_absolute else 0
                x_pad = torch.zeros((h._pad_len, x2d.shape[1]),
                                    dtype=x2d.dtype, device=device)
                x_pad[:ns] = x_int[s.offset:s.offset + s.size]
                y = apply_hmatrix_padded(h._product_data(), x_pad,
                                         h._pad_len, "N", h.symmetry)
                y_int[t_off:t_off + t_sz] += y[t_base:t_base + nt]
        return y_int[inv_t]

    return apply


def block_row_cases(torch, op, phase, ks=(1, 8)):
    """The distributed operator's device apply (K1 on every block row)
    against `plain_distributed_apply` on the same x, in every launch
    structure, each within the kernels' tolerance.  These launches are
    checks, not the main path."""
    from htool_python_torch.config import get_config
    from htool_python_torch.ops.cuda_matvec import MODES

    cfg = get_config()
    apply, plain = op.build_device_apply(), plain_distributed_apply(torch, op)
    g = torch.Generator(op.device).manual_seed(11)
    cases = []
    for k in ks:
        x = torch.rand((op.shape[1], k), dtype=torch.float32,
                       device=op.device, generator=g)
        y_plain = plain(x)
        for mode in MODES:
            cfg.matvec_kernel_mode = mode
            try:
                y = apply(x)
                torch.cuda.synchronize()
            finally:
                cfg.matvec_kernel_mode = "fused"
            abs_err = float((y - y_plain).abs().max())
            rel = abs_err / float(y_plain.abs().max())
            case = dict(k=k, mode=mode, max_rel_err=rel, max_abs_err=abs_err)
            check(np.isfinite(rel) and rel <= KERNEL_TOL,
                  f"{phase}: the block rows' product disagrees with its "
                  f"plain version: {case}")
            cases.append(case)
    return cases


def distributed(T, torch, n, device, counts):
    """The reference's 2-partition stage: block rows of the headline
    operator on a 2-partition cluster, the global product through the
    distributed operator, with K1's launches counted around one product."""
    from htool_python_torch.models.geometry import \
        create_random_points_in_sphere
    from htool_python_torch.models.kernels import inverse_distance_kernel
    from htool_python_torch.ops import cuda_matvec

    points = create_random_points_in_sphere(n, np.random.RandomState(1))
    cb = T.ClusterTreeBuilder()
    cb.set_maximal_leaf_size(128)
    cluster = cb.create_cluster_tree(points, 2, size_of_partition=2)
    gen = T.KernelGenerator(inverse_distance_kernel(0.1), points, points,
                            device=device)
    hb = T.HMatrixTreeBuilder(1e-3, 10.0, "N", "N", device=device)
    hb.set_dtype(torch.float32)
    t0 = time.perf_counter()
    approx = T.DefaultApproximationBuilder(gen, cluster, cluster, hb)
    t_build = time.perf_counter() - t0
    op = approx.distributed_operator
    apply = op.build_device_apply()

    rng = np.random.RandomState(2)
    x1 = rng.rand(n).astype(np.float32)
    cuda_matvec.reset_launch_counts()
    y1 = op * x1
    torch.cuda.synchronize()
    counts.update(cuda_matvec.LAUNCH_COUNTS)
    check(y1.shape == (n,) and np.isfinite(y1).all(),
          "distributed product shape or values")
    err = sampled_error(points, x1, y1, rng)
    cases = block_row_cases(torch, op, "distributed")
    product = {f"k{k}": apply_chain_ms(torch, apply, n, k, torch.float32,
                                       device, k) for k in (1, 8)}
    info = op.get_distributed_information()
    SUMMARY.update({f"distributed_global_product_ms_{key}": v
                    for key, v in product.items()})
    emit("distributed", N=n, partitions=op.n_partitions, epsilon=1e-3,
         eta=10.0, leaf=128, dtype="float32", build_s=t_build,
         build_profile=approx.build_profile,
         partition_sizes=op.t_sizes.tolist(),
         compression_ratio=float(info["Compression_ratio"]),
         global_product_ms=product, sampled_rel_error=err,
         block_row_check=cases,
         launches_per_product={k: v for k, v in counts.items() if v})
    check(err <= SAMPLED_ERR_MAX,
          f"distributed sampled error {err} above {SAMPLED_ERR_MAX}")
    check(counts[cuda_matvec.KERNEL_NAME] == op.n_partitions
          and sum(counts.values()) == op.n_partitions,
          f"a fused global product launched {counts}, not one K1 launch "
          "per block row")
    return cases


def ddm(T, torch, n, device, counts):
    """The reference's ddm_gmres stage: one-level ASM-preconditioned GMRES
    on 4 partitions, solved cold, warm, warm under each of the other two
    launch structures, and once with 4 right-hand sides; K1's launches of
    each structure counted around the solves."""
    from htool_python_torch.config import get_config
    from htool_python_torch.models.geometry import \
        create_random_points_in_sphere
    from htool_python_torch.models.kernels import inverse_distance_kernel
    from htool_python_torch.ops import cuda_matvec

    P = 4
    points = create_random_points_in_sphere(n, np.random.RandomState(1))
    cb = T.ClusterTreeBuilder()
    cb.set_maximal_leaf_size(128)
    cluster = cb.create_cluster_tree(points, 2, size_of_partition=P)
    gen = T.KernelGenerator(inverse_distance_kernel(0.1), points, points,
                            device=device)
    hb = T.HMatrixTreeBuilder(DDM_EPS, 10.0, "N", "N", device=device)
    hb.set_dtype(torch.float32)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    approx = T.DefaultApproximationBuilder(gen, cluster, cluster, hb)
    t_rows = time.perf_counter() - t0
    t0 = time.perf_counter()
    block_diag = approx.block_diagonal_hmatrix
    t_extract = time.perf_counter() - t0
    op = approx.distributed_operator
    t0 = time.perf_counter()
    solver = T.DDMSolverBuilder(op, block_diag).solver
    solver.set_hpddm_args(
        "-hpddm_krylov_method gmres -hpddm_schwarz_method asm "
        f"-hpddm_max_it {DDM_MAX_IT} -hpddm_gmres_restart 60 "
        f"-hpddm_tol {DDM_TOL}")
    solver.facto_one_level()
    torch.cuda.synchronize()
    t_facto = time.perf_counter() - t0
    peak_setup = torch.cuda.max_memory_allocated() / 1e9

    rng = np.random.RandomState(3)
    cfg = get_config()
    op64 = float64_copy(T, torch, op)

    def solve(label, x_ref, mode="fused"):
        k = x_ref.shape[1]
        f = op @ x_ref
        if k == 1:
            x_ref, f = x_ref[:, 0], f[:, 0]
        x = np.zeros_like(f)
        cfg.matvec_kernel_mode = mode
        cuda_matvec.reset_launch_counts()
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            solver.solve(x, f)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        finally:
            cfg.matvec_kernel_mode = "fused"
        launches = {key: v for key, v in cuda_matvec.LAUNCH_COUNTS.items()
                    if v}
        info = solver.get_information()
        its = int(info["Nb_it"])
        r = (op @ x if k > 1 else op * x) - f
        true_res = float(np.linalg.norm(r) / np.linalg.norm(f))
        # the same residual with the operator applied in float64: what the
        # f32 product's rounding adds to the residual is gone from it
        r64 = op64 @ x.astype(np.float64).reshape(n, k) - f.reshape(n, k)
        true_res64 = float(np.linalg.norm(r64) / np.linalg.norm(f))
        out = dict(solve=label, mode=mode, columns=k, iterations=its,
                   seconds=seconds, ms_per_iteration=seconds * 1e3 / its,
                   solver_residual=float(info["Residual_estimate"]),
                   recomputed_residual=float(info["Relative_residual"]),
                   true_residual=true_res, true_residual_f64=true_res64,
                   solution_rel_error=float(np.linalg.norm(x - x_ref)
                                            / np.linalg.norm(x_ref)),
                   launches=launches)
        emit("ddm_solve", **out)
        check(np.isfinite(x).all(), f"ddm {label}: non-finite solution")
        check(its <= DDM_MAX_IT and out["solver_residual"] <= DDM_TOL,
              f"ddm {label}: GMRES did not converge: {out}")
        check(true_res <= DDM_TRUE_RES_MAX
              and true_res64 <= DDM_TRUE_RES_MAX,
              f"ddm {label}: true residual {true_res} (f64 operator "
              f"{true_res64}) above {DDM_TRUE_RES_MAX}")
        return out

    def rhs(k):
        return rng.rand(n, k).astype(np.float32)

    # the first solve after the setup: of the solve's work only the product
    # that formed f ran before it
    cold = solve("cold", rhs(1))

    # the card's f32 LU and inverse: max |I - A_i A_i^-1| per subdomain
    inv = solver._facto[1][0]
    inverse_err = []
    for i, s in enumerate(solver.subdomains):
        Ai = s.dense_tensor(device)
        R = Ai @ inv[i, :s.size, :s.size]
        R.diagonal().sub_(1.0)
        inverse_err.append(float(R.abs().max()))
        del Ai, R

    cases = block_row_cases(torch, op, "ddm")
    # per-iteration device work without the solver's host syncs: one
    # operator and one preconditioner application, in a chain
    A_fn = op.build_device_apply()
    M_fn = solver._device_preconditioner()
    op_ms = apply_chain_ms(torch, lambda v: A_fn(M_fn(v)), n, 1,
                           torch.float32, device, 0)

    # the three structures solve the same system: their iteration counts
    # differ only by the order of the f32 atomic sums
    x_warm = rhs(1)
    solves = [cold, solve("warm", x_warm),
              solve("warm", x_warm, "per_bucket"),
              solve("warm", x_warm, "seq"), solve("blocked", rhs(4))]
    by_mode = {s["mode"]: s for s in solves[1:4]}
    for mode in ("per_bucket", "seq"):
        name = cuda_matvec.launch_name(cuda_matvec.KERNEL_NAME, mode)
        counts[name] = by_mode[mode]["launches"].get(name, 0)
        check(counts[name] > 0, f"the {mode} solve never launched {name}")
        check(set(by_mode[mode]["launches"]) == {name},
              f"the {mode} solve launched {by_mode[mode]['launches']}")
    SUMMARY["ddm_ms_per_iteration_warm"] = {
        s["mode"]: s["ms_per_iteration"] for s in solves[1:4]}
    its = [s["iterations"] for s in solves[1:4]]
    check(max(its) - min(its) <= 2
          and all(abs(i - DDM_ITERATIONS) <= 2 for i in its),
          f"iteration counts of the three launch structures: {its}, not "
          f"{DDM_ITERATIONS} +- 2")
    emit("ddm", N=n, partitions=P, epsilon=DDM_EPS, eta=10.0, leaf=128,
         dtype="float32", schwarz="asm", tol=DDM_TOL, restart=60,
         subdomain_sizes=[s.size for s in solver.subdomains],
         setup_s={"block_rows": t_rows, "extract_block_diagonal": t_extract,
                  "facto_one_level": t_facto},
         build_profile=approx.build_profile,
         peak_memory_setup_GB=peak_setup,
         peak_memory_GB=torch.cuda.max_memory_allocated() / 1e9,
         inverse_max_abs_err=inverse_err,
         apply_plus_precond_chain_ms=op_ms,
         host_ms_per_iteration=solves[1]["ms_per_iteration"] - op_ms,
         block_row_check=cases, solves=solves)
    return cases


def overlap_decomposition(points, cluster, P, n_layers=2, n_neighbors=8):
    """Overlapping subdomains (ovr_to_global, cluster_to_ovr, neighbors,
    intersections) by the recipe of tools/generate_test_data.py:71-118:
    each partition's dofs in cluster order, then `n_layers` rounds of
    growth to every point's `n_neighbors` nearest neighbours, the ghosts
    appended in ascending user order.  The neighbours come from a k-d tree,
    where the recipe sorts a dense N x N distance matrix (9.6 GB at N =
    20 000)."""
    from scipy.spatial import cKDTree

    N = points.shape[1]
    _, knn = cKDTree(points.T).query(points.T, k=n_neighbors + 1)
    check((knn[:, 0] == np.arange(N)).all(),
          "overlap: a point's nearest neighbour is not itself")
    knn = knn[:, 1:]
    perm = cluster.get_permutation()
    ovr, c2o = [], []
    for p in range(P):
        node = cluster.get_cluster_on_partition(p)
        own = perm[node.get_offset():node.get_offset() + node.get_size()]
        in_sub = np.zeros(N, dtype=bool)
        in_sub[own] = True
        for _ in range(n_layers):
            in_sub[np.unique(knn[in_sub].ravel())] = True
        ghosts = np.setdiff1d(np.flatnonzero(in_sub), own)
        ovr.append(np.concatenate([own, ghosts]).astype(np.int64))
        c2o.append(np.arange(len(own), dtype=np.int64))
    neighbors, intersections = [], []
    for p in range(P):
        nbr, inter = [], []
        for q in range(P):
            shared = np.flatnonzero(np.isin(ovr[p], ovr[q])) if q != p else []
            if len(shared):
                nbr.append(q)
                inter.append(shared.astype(np.int64))
        neighbors.append(np.asarray(nbr, dtype=np.int64))
        intersections.append(inter)
    return ovr, c2o, neighbors, intersections


def ddm_geneo(T, torch, n, device, counts):
    """The ddm phase's problem with overlapping subdomains (dense local
    matrices from the generator) and the GenEO coarse space: a one-level
    solve, then `build_coarse_space` with DDM_GENEO_NU vectors a subdomain
    (E = Z^T A Z through K1 at k = 64), two-level solves cold, warm and with
    4 right-hand sides; K1's launches counted around those; then the checks
    of E and of the coarse term against float64 on the CPU, K1's device
    time at k = 64 on the block rows, and torch.linalg.eigh on the card for
    one subdomain's pencil (a measurement only)."""
    from htool_python_torch.models.geometry import \
        create_random_points_in_sphere
    from htool_python_torch.models.kernels import inverse_distance_kernel
    from htool_python_torch.ops import cuda_matvec
    from htool_python_torch.ops.cuda_matvec import apply_hmatrix_cuda
    from htool_python_torch.profiling.bounds import product_bound
    from htool_python_torch.solvers import coarse

    P = 4
    points = create_random_points_in_sphere(n, np.random.RandomState(1))
    cb = T.ClusterTreeBuilder()
    cb.set_maximal_leaf_size(128)
    cluster = cb.create_cluster_tree(points, 2, size_of_partition=P)
    gen = T.KernelGenerator(inverse_distance_kernel(0.1), points, points,
                            device=device)
    hb = T.HMatrixTreeBuilder(DDM_EPS, 10.0, "N", "N", device=device)
    hb.set_dtype(torch.float32)
    torch.cuda.reset_peak_memory_stats()
    setup = {}
    t0 = time.perf_counter()
    approx = T.DefaultApproximationBuilder(gen, cluster, cluster, hb)
    op = approx.distributed_operator
    block_diag = approx.block_diagonal_hmatrix
    setup["block_rows_and_diagonal"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ovr, c2o, nbr, inter = overlap_decomposition(points, cluster, P)
    setup["overlap"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    solver = T.DDMSolverBuilder(op, block_diag, gen, ovr, c2o, nbr,
                                inter).solver
    setup["subdomain_matrices"] = time.perf_counter() - t0
    solver.set_hpddm_args(
        "-hpddm_krylov_method gmres -hpddm_schwarz_method asm "
        f"-hpddm_max_it {DDM_MAX_IT} -hpddm_gmres_restart 60 "
        f"-hpddm_tol {DDM_TOL}")
    t0 = time.perf_counter()
    solver.facto_one_level()
    torch.cuda.synchronize()
    setup["facto_one_level"] = time.perf_counter() - t0
    op64 = float64_copy(T, torch, op)
    rng = np.random.RandomState(3)

    def solve(label, x_ref, correction):
        solver.set_hpddm_args(f"-hpddm_schwarz_coarse_correction {correction}")
        k = x_ref.shape[1]
        f = op @ x_ref
        if k == 1:
            x_ref, f = x_ref[:, 0], f[:, 0]
        x = np.zeros_like(f)
        before = dict(cuda_matvec.LAUNCH_COUNTS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solver.solve(x, f)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        info = solver.get_information()
        its = int(info["Nb_it"])
        r = (op @ x if k > 1 else op * x) - f
        true_res = float(np.linalg.norm(r) / np.linalg.norm(f))
        r64 = op64 @ x.astype(np.float64).reshape(n, k) - f.reshape(n, k)
        true_res64 = float(np.linalg.norm(r64) / np.linalg.norm(f))
        out = dict(solve=label, columns=k, iterations=its, seconds=seconds,
                   ms_per_iteration=seconds * 1e3 / its,
                   coarse_correction=info["Coarse_correction"],
                   coarse_vectors=int(info["Nb_coarse_vectors"]),
                   solver_residual=float(info["Residual_estimate"]),
                   true_residual=true_res, true_residual_f64=true_res64,
                   solution_rel_error=float(np.linalg.norm(x - x_ref)
                                            / np.linalg.norm(x_ref)),
                   launches={key: v - before[key] for key, v in
                             cuda_matvec.LAUNCH_COUNTS.items()
                             if v > before[key]})
        emit("ddm_geneo_solve", **out)
        check(np.isfinite(x).all(), f"ddm_geneo {label}: non-finite solution")
        check(its <= DDM_MAX_IT and out["solver_residual"] <= DDM_TOL,
              f"ddm_geneo {label}: GMRES did not converge: {out}")
        check(true_res <= DDM_TRUE_RES_MAX
              and true_res64 <= DDM_TRUE_RES_MAX,
              f"ddm_geneo {label}: true residual {true_res} (f64 operator "
              f"{true_res64}) above {DDM_TRUE_RES_MAX}")
        return out

    stamps, e_stamp = [], {}

    class TimedBuilder(T.GeneoCoarseSpaceDenseBuilder):
        """The library's builder, timed; the kept vectors' eigenvalues by
        their Rayleigh quotients on the lower triangles eigh reads (DAiD,
        from an 'N' operator, is symmetric only to eps)."""

        def compute_coarse_space(self, Ai, Bi):
            t0 = time.perf_counter()
            super().compute_coarse_space(Ai, Bi)
            t1 = time.perf_counter()
            v = self._coarse_space
            As = np.tril(Ai) + np.tril(Ai, -1).T
            lam = (np.einsum("ij,ij->j", v, As @ v)
                   / np.einsum("ij,ij->j", v, Bi @ v))
            stamps.append(dict(start=t0, end=t1, eigh_s=t1 - t0,
                               eigenvalues=lam))

    class TimedOperatorBuilder(T.GeneoCoarseOperatorBuilder):
        """The library's E, timed, with its kernel launches."""

        def build_coarse_operator(self, Z):
            before = dict(cuda_matvec.LAUNCH_COUNTS)
            t0 = time.perf_counter()
            E = super().build_coarse_operator(Z)  # numpy: synchronized
            e_stamp.update(start=t0, end=time.perf_counter(), E=E, launches={
                key: v - before[key] for key, v in
                cuda_matvec.LAUNCH_COUNTS.items() if v > before[key]})
            return E

    # the path: counts from 0 here, read after the last two-level solve
    cuda_matvec.reset_launch_counts()
    one_level = solve("one_level", rng.rand(n, 1).astype(np.float32), "none")
    t0 = time.perf_counter()
    Ki = []
    for p in range(P):
        K = np.empty((len(ovr[p]), len(ovr[p])))
        gen.build_submatrix(ovr[p], ovr[p], K)
        Ki.append(K)
    setup["Ki"] = time.perf_counter() - t0
    builders = [TimedBuilder(len(c2o[p]), len(ovr[p]), block_diag[p], Ki[p],
                             "S", "L", geneo_nu=DDM_GENEO_NU)
                for p in range(P)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solver.build_coarse_space(builders, TimedOperatorBuilder(op))
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    setup["build_coarse_space"] = t_end - t0
    ends = [t0] + [st["end"] for st in stamps[:-1]]
    setup["DAiD"] = [st["start"] - e for st, e in zip(stamps, ends)]
    setup["eigh"] = [st["eigh_s"] for st in stamps]
    setup["qr"] = e_stamp["start"] - stamps[-1]["end"]
    setup["E"] = e_stamp["end"] - e_stamp["start"]
    setup["E_lu"] = t_end - e_stamp["end"]
    x_warm = rng.rand(n, 1).astype(np.float32)
    solves = [solve("cold", x_warm, "additive"),
              solve("warm", x_warm, "additive"),
              solve("blocked", rng.rand(n, 4).astype(np.float32), "additive")]
    counts.update(cuda_matvec.LAUNCH_COUNTS)
    check(e_stamp["launches"].get(cuda_matvec.KERNEL_NAME, 0) > 0,
          f"E's build launched {e_stamp['launches']}, not K1")
    check(counts.get(cuda_matvec.KERNEL_NAME, 0) > 0,
          "the ddm_geneo path never launched kernel K1")

    Z, _ = solver._coarse
    nc = Z.shape[1]
    # the same assembly (weights, zero extension, QR, keep rule) on the CPU
    # in float64, from the vectors the builders kept

    class Kept(coarse.VirtualGeneoCoarseSpaceBuilder):
        def __init__(self, p):
            super().__init__(len(c2o[p]), len(ovr[p]), None)
            self.vectors = builders[p]._coarse_space.astype(np.float64)

        def compute_coarse_space(self, hmatrix_callback):
            self.set_coarse_space(self.vectors)

    Z64 = coarse.assemble_geneo_coarse_space(solver,
                                             [Kept(p) for p in range(P)])
    check(nc >= 1 and Z64 is not None and nc == Z64.shape[1],
          f"ddm_geneo: {nc} coarse vectors on the card, "
          f"{None if Z64 is None else Z64.shape[1]} in float64 on the CPU")
    Zc = Z.double().cpu().numpy()
    projector_err = float(np.linalg.norm(Zc @ (Zc.T @ Z64) - Z64)
                          / np.linalg.norm(Z64))
    E = e_stamp["E"]
    E64 = Zc.T @ (op64 @ Zc)
    e_err = float(np.linalg.norm(E.astype(np.float64) - E64)
                  / np.linalg.norm(E64))
    check(e_err <= KERNEL_TOL,
          f"ddm_geneo: E on the card {e_err} from its float64 CPU product")
    g = torch.Generator(device).manual_seed(7)
    r = torch.rand((n, 1), dtype=torch.float32, device=device, generator=g)
    zc = solver._coarse_device(r).double().cpu().numpy()
    r64 = r.double().cpu().numpy()

    def coarse_err(E_):
        z64 = Zc @ np.linalg.solve(E_, Zc.T @ r64)
        return float(np.linalg.norm(zc - z64) / np.linalg.norm(z64))

    # Z E^-1 Z^T r in float64 on the CPU from the card's Z and E; and from
    # E's float64 product, where E's f32 rounding enters times cond(E)
    coarse_errs = {"card_E": coarse_err(E.astype(np.float64)),
                   "E_f64": coarse_err(E64)}
    cond_E = float(np.linalg.cond(E64))
    check(coarse_errs["card_E"] <= KERNEL_TOL,
          f"ddm_geneo: the coarse term on the card {coarse_errs} from its "
          "float64 CPU counterpart")

    # K1 at E's width on each block row alone, by device ms, and the
    # device apply of one 64-column chunk
    k = T.GeneoCoarseOperatorBuilder.COLUMN_CHUNK
    rows = []
    for p in range(P):
        h = op._global_to_local[p][0].hmatrix
        data, table = h._product_data(), h._bucket_table()
        x = torch.rand((h._pad_len, k), dtype=torch.float32, device=device,
                       generator=g)
        bound, bound_by = product_bound(data, h._pad_len, k)
        rows.append(dict(block_row=p, ms=device_ms(
            torch, lambda: apply_hmatrix_cuda(data, x, h._pad_len, "N",
                                              h.symmetry, table)),
            bound_ms=bound, bound_by=bound_by))
    apply = op.build_device_apply()
    Zk = torch.rand((n, k), dtype=torch.float32, device=device, generator=g)
    k1_k64 = dict(k=k, block_rows=rows, ms=sum(r_["ms"] for r_ in rows),
                  bound_ms=sum(r_["bound_ms"] for r_ in rows),
                  apply_ms=device_ms(torch, lambda: apply(Zk)))

    # measurement only: the first subdomain's pencil on the card, reduced
    # to a standard problem by a Cholesky of Ki, in float64; DAiD's lower
    # triangle, as scipy's eigh reads it (the block diagonal of an 'N'
    # operator is symmetric only to eps)
    DAiD = torch.as_tensor(coarse._embedded_dirichlet(
        builders[0], solver.subdomains[0]), dtype=torch.float64, device=device)
    DAiD = torch.tril(DAiD) + torch.tril(DAiD, -1).T
    K = torch.as_tensor(Ki[0], device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    L = torch.linalg.cholesky(K)
    C = torch.linalg.solve_triangular(L, DAiD, upper=False)
    C = torch.linalg.solve_triangular(L, C.T, upper=False)
    w, _ = torch.linalg.eigh(C)
    torch.cuda.synchronize()
    eigh_s = time.perf_counter() - t0
    wk = torch.linalg.eigvalsh(K)
    eigh_card = dict(subdomain=0, m=int(K.shape[0]), s=eigh_s,
                     cond_Ki=float(wk[-1] / wk[0]),
                     top_rel_diff=float(np.max(np.abs(
                         np.sort(w.cpu().numpy())[::-1][:DDM_GENEO_NU]
                         - stamps[0]["eigenvalues"])
                         / np.abs(stamps[0]["eigenvalues"]))))
    del DAiD, K, L, C, wk
    torch.cuda.empty_cache()
    emit("ddm_geneo", N=n, partitions=P, epsilon=DDM_EPS, eta=10.0, leaf=128,
         dtype="float32", schwarz="asm", coarse_correction="additive",
         geneo_nu=DDM_GENEO_NU, tol=DDM_TOL, restart=60,
         subdomain_sizes=[s.size for s in solver.subdomains],
         owned_sizes=[len(c) for c in c2o], setup_s=setup,
         coarse_vectors=nc, coarse_vectors_f64=Z64.shape[1],
         projector_rel_err=projector_err,
         eigenvalue_16=[float(st["eigenvalues"][-1]) for st in stamps],
         eigenvalues_kept=[st["eigenvalues"].tolist() for st in stamps],
         E_launches=e_stamp["launches"], E_rel_err_f64=e_err,
         coarse_term_rel_err_f64=coarse_errs, cond_E=cond_E, k1_k64=k1_k64,
         iterations={"ddm_block_jacobi": DDM_ITERATIONS,
                     "one_level_overlap": one_level["iterations"],
                     "two_level": solves[1]["iterations"]},
         warm_ms_per_iteration=solves[1]["ms_per_iteration"],
         eigh_on_card=eigh_card,
         peak_memory_GB=torch.cuda.max_memory_allocated() / 1e9,
         build_profile=approx.build_profile, solves=[one_level] + solves)
    return k1_k64


def k1al_cases(torch, operators, label, ks=K1_KS, reps=20):
    """K1-al on the aligned layout of every operator x trans x k against
    its plain version on the same data (the aligned windows add zero
    columns only), and K1 on the canonical layout against its plain
    version, timed beside it.  These launches are checks, not the main
    path."""
    from htool_python_torch.ops.cuda_matvec import (BucketTable,
                                                    apply_hmatrix_cuda)
    from htool_python_torch.ops.matvec import (ALIGN_LANE, align_lowrank,
                                               apply_hmatrix_padded,
                                               stored_bytes)
    from htool_python_torch.profiling.bounds import product_bound
    from htool_python_torch.profiling.timing import cuda_ms

    results = []
    for (symmetry, UPLO), hm in operators.items():
        L, n = hm._pad_len, hm.shape[0]
        data = hm._data
        aligned = align_lowrank(data, ALIGN_LANE)
        table, table_al = (BucketTable(d, hm.device) for d in (data, aligned))
        check(table_al.aligned, "align_lowrank's data is not marked aligned")
        g = torch.Generator(hm.device).manual_seed(13)
        for trans in ("N", "T"):
            for k in ks:
                x = torch.zeros((L, k), dtype=torch.float32, device=hm.device)
                x[:n] = torch.rand((n, k), device=hm.device, generator=g)
                y_plain = apply_hmatrix_padded(aligned, x, L, trans, symmetry)
                y = apply_hmatrix_cuda(aligned, x, L, trans, symmetry,
                                       table_al)
                torch.cuda.synchronize()
                abs_err = float((y - y_plain).abs().max())
                rel = abs_err / float(y_plain.abs().max())
                y1 = apply_hmatrix_cuda(data, x, L, trans, symmetry, table)
                y1_plain = apply_hmatrix_padded(data, x, L, trans, symmetry)
                abs_err1 = float((y1 - y1_plain).abs().max())
                rel1 = abs_err1 / float(y1_plain.abs().max())
                del y1, y1_plain
                bound, bound_by = product_bound(data, L, k)
                case = dict(
                    operator=label, storage=symmetry + ("-" + UPLO if UPLO
                                                        != "N" else ""),
                    N=n, trans=trans, k=k, max_rel_err=rel,
                    max_abs_err=abs_err, k1_max_rel_err=rel1,
                    k1_max_abs_err=abs_err1,
                    ms=cuda_ms(lambda: apply_hmatrix_cuda(
                        aligned, x, L, trans, symmetry, table_al), reps=reps),
                    k1_ms=cuda_ms(lambda: apply_hmatrix_cuda(
                        data, x, L, trans, symmetry, table), reps=reps),
                    plain_ms=cuda_ms(lambda: apply_hmatrix_padded(
                        aligned, x, L, trans, symmetry), reps=2, warmup=1),
                    bound_ms=bound, bound_by=bound_by,
                    aligned_bound_ms=product_bound(aligned, L, k)[0],
                    stored_bytes=stored_bytes(data),
                    aligned_stored_bytes=stored_bytes(aligned))
                del y, y_plain, x
                emit("k1al_check", **case)
                check(np.isfinite(rel) and rel <= KERNEL_TOL,
                      f"k1al_check: K1-al disagrees with its plain version: "
                      f"{case}")
                check(np.isfinite(rel1) and rel1 <= KERNEL_TOL,
                      f"k1al_check: K1 disagrees with its plain version: "
                      f"{case}")
                results.append(case)
    return results


def device_ms(torch, fn, reps=20, cover_cycles=10_000_000):
    """Device ms per call of fn: CUDA events around `reps` calls queued
    behind a spin kernel (torch.cuda._sleep, ~5 ms), so that the card runs
    the calls back to back however long the host takes to queue them (a
    plain event timing of a short call measures the host).  The same as
    profiling/timing.py's, kept here so that --k1-buckets-only also runs
    on a checkout that predates it."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(cover_cycles)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def k1_buckets(torch, operators, stream_gbs, ks=(1, 8, 128), reps=20):
    """K1 (K2 on a complex64 operator, with a complex64 x) on each bucket
    of each operator alone (a one-bucket data list and
    its own BucketTable, 'fused', trans N), timed with CUDA events at each
    k: ms by CUDA events over back-to-back calls (bounded below by the
    host's time per call, ~0.03-0.08 ms) and device ms (`device_ms`: the
    calls queued behind a spin kernel, the wrapper's zeroing of y
    included), stored bytes, GB/s and the share of P1's best read rate
    `stream_gbs` (both from the device ms); and the sum over the buckets
    against the whole fused product.  One `k1_buckets` line per operator and k.  These launches are
    measurements, not the main path; they go only through
    `apply_hmatrix_cuda` and `BucketTable`, so an older checkout of the
    package runs them too (--k1-buckets-only)."""
    from htool_python_torch.ops.cuda_matvec import (BucketTable,
                                                    apply_hmatrix_cuda)
    from htool_python_torch.ops.matvec import stored_bytes
    from htool_python_torch.profiling.bounds import product_bound
    from htool_python_torch.profiling.timing import cuda_ms

    out = {}
    for label, hm in operators.items():
        data, table = hm._product_data(), hm._bucket_table()
        L, n = hm._pad_len, hm.shape[0]
        singles = []
        for kind in ("dense", "lr"):
            for entry in data[kind]:
                if entry[0].shape[0] == 0:
                    continue
                one = {"dense": [entry] if kind == "dense" else [],
                       "lr": [entry] if kind == "lr" else []}
                singles.append((kind, entry, one, BucketTable(one,
                                                              hm.device)))
        g = torch.Generator(hm.device).manual_seed(17)
        for k in ks:
            x = torch.zeros((L, k), dtype=hm.dtype, device=hm.device)
            x[:n] = torch.rand((n, k), dtype=hm.dtype, device=hm.device,
                               generator=g)
            def fused():
                return apply_hmatrix_cuda(data, x, L, "N", "N", table)

            fused_ms = cuda_ms(fused, reps=reps)
            fused_dev = device_ms(torch, fused)
            rows = []
            for kind, entry, one, t1 in singles:
                def run():
                    return apply_hmatrix_cuda(one, x, L, "N", "N", t1)

                ms = cuda_ms(run, reps=reps)
                dev = device_ms(torch, run)
                nbytes = stored_bytes(one)
                gbs = nbytes / dev / 1e6
                shape = entry[0].shape
                rows.append(dict(
                    kind=kind, nb=int(shape[0]),
                    pt=int(shape[1] if kind == "dense" else shape[2]),
                    ps=int(shape[2] if kind == "dense" else entry[1].shape[2]),
                    r=0 if kind == "dense" else int(shape[1]),
                    bytes=int(nbytes), ms=ms, device_ms=dev, GBs=gbs,
                    share_of_stream=gbs / stream_gbs,
                    bound_ms=product_bound(one, L, k)[0]))
            total = sum(rw["device_ms"] for rw in rows)
            nbytes = stored_bytes(data)
            emit("k1_buckets", operator=label, N=n, k=k,
                 dtype=str(hm.dtype).replace("torch.", ""),
                 stream_GBs=stream_gbs, fused_ms=fused_ms,
                 fused_device_ms=fused_dev,
                 fused_GBs=nbytes / fused_dev / 1e6,
                 fused_share_of_stream=nbytes / fused_dev / 1e6 / stream_gbs,
                 sum_of_buckets_device_ms=total, gap_ms=fused_dev - total,
                 bound_ms=product_bound(data, L, k)[0],
                 stored_bytes=int(nbytes), buckets=rows)
            out[label, k] = dict(fused_ms=fused_ms, fused_device_ms=fused_dev,
                                 sum_device_ms=total, rows=rows)
            del x
    return out


def k1_sweeps(torch, hm, stream_gbs, counts):
    """K1's attribution sweeps (python -m
    htool_python_torch.profiling.k1_sweeps) on the headline operator `hm`,
    with K1's launches counted around them: one `k1_sweeps` line per
    family, then a summary line.  Fails where K1 is more than 1e-5 from its
    plain version (k = 1 and 128) or a re-padded product more than 1e-5
    from the stored one."""
    from htool_python_torch.ops import cuda_matvec
    from htool_python_torch.profiling.k1_sweeps import (case_entries,
                                                        failures, run_sweeps)

    cuda_matvec.reset_launch_counts()
    t0 = time.perf_counter()
    result = run_sweeps(hm.device, operator=hm, p1_gbs=stream_gbs,
                        on_family=lambda name, part: emit(
                            "k1_sweeps", family=name, **part))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts.update(cuda_matvec.LAUNCH_COUNTS)
    bad = failures(result)
    rows = [(name, entry[f"k{k}"]) for name, entry in case_entries(result)
            for k in result["check_ks"]]
    worst = max(rows, key=lambda r: r[1]["max_rel_err"])
    emit("k1_sweeps_summary", wall_s=wall, seconds=result["seconds"],
         ks=result["ks"], check_ks=result["check_ks"], cases=len(rows)
         // len(result["check_ks"]), p1_best_GBs=stream_gbs,
         max_rel_err=worst[1]["max_rel_err"], worst_case=worst[0],
         max_repad_err=max(r["repad_err"] for _, r in rows
                           if "repad_err" in r),
         launches=counts[cuda_matvec.KERNEL_NAME], failed=bad)
    check(not bad, f"k1_sweeps: {bad} above {KERNEL_TOL}")
    check(counts[cuda_matvec.KERNEL_NAME] > 0,
          "the K1 sweeps never launched kernel K1")
    return result


def second_kind_operator(T, torch, n, rng, diagonal, eps, symmetry, UPLO,
                         device, partitions=None):
    """The reference's factorization operators
    (tests/test_hier_local_solver.py): n points on the unit sphere drawn
    from `rng`, second_kind_kernel(0.5, diagonal), leaf 64, eta 10, f32;
    with `partitions`, the DefaultApproximationBuilder of a cluster with
    that many partitions instead of one H-matrix.  Returns (operator or
    builder, seconds)."""
    from htool_python_torch.models.geometry import \
        create_random_points_on_sphere
    from htool_python_torch.models.kernels import second_kind_kernel

    points = create_random_points_on_sphere(n, rng)
    t0 = time.perf_counter()
    cb = T.ClusterTreeBuilder()
    cb.set_maximal_leaf_size(64)
    cluster = (cb.create_cluster_tree(points, 2) if partitions is None else
               cb.create_cluster_tree(points, 2, size_of_partition=partitions))
    gen = T.KernelGenerator(second_kind_kernel(0.5, diagonal), points, points,
                            device=device)
    hb = T.HMatrixTreeBuilder(eps, 10.0, symmetry, UPLO, device=device)
    hb.set_dtype(torch.float32)
    out = (hb.build(gen, cluster, cluster) if partitions is None else
           T.DefaultApproximationBuilder(gen, cluster, cluster, hb))
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def hlu(T, torch, n, device, counts):
    """The reference's 32k factorization: LU, Cholesky, and LU with every
    product through K1-al; `counts` gets the launches of the aligned LU's
    factorization and solve.  Returns (operator, its S-L twin)."""
    import copy

    from htool_python_torch.config import get_config
    from htool_python_torch.ops import cuda_matvec
    from htool_python_torch.profiling.timing import cuda_ms

    rng = np.random.RandomState(11)
    hm, t_asm = second_kind_operator(T, torch, n, rng, 0.5 * n, HLU_EPS, "N",
                                     "N", device)
    x_ref = rng.rand(n).astype(np.float32)
    b = hm * x_ref
    b_dev = torch.as_tensor(b, device=device)
    cfg = get_config()

    def factorize(kind, aligned):
        fac = copy.deepcopy(hm)
        cfg.matvec_aligned_layout = aligned
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            cuda_matvec.reset_launch_counts()
            t0 = time.perf_counter()
            if kind == "lu":
                fac.lu_factorization()
            else:
                fac.cholesky_factorization("L")
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            build = {key: v for key, v in cuda_matvec.LAUNCH_COUNTS.items()
                     if v}
            check(fac._factorization[0] == "hodlr",
                  f"hlu {kind}: the HODLR build fell back to the dense path")

            def solve(rhs):
                return (fac.lu_solve("N", rhs) if kind == "lu"
                        else fac.cholesky_solve("L", rhs))

            x = solve(b)
            launches = {key: v for key, v in cuda_matvec.LAUNCH_COUNTS.items()
                        if v}
            solve_ms = cuda_ms(lambda: solve(b_dev), reps=5, warmup=1)
            solve_profile = device_profile(torch, lambda: solve(b_dev),
                                           reps=3)
            peak = torch.cuda.max_memory_allocated() / 1e9
        finally:
            cfg.matvec_aligned_layout = False
        check(x.shape == (n,) and x.dtype == np.float32
              and np.isfinite(x).all(), f"hlu {kind}: solution shape/values")
        res = float(np.linalg.norm(hm * x - b) / np.linalg.norm(b))
        err = float(np.linalg.norm(x - x_ref) / np.linalg.norm(x_ref))
        prof = fac._factorization[1].profile
        out = dict(kind=kind, aligned_layout=aligned, N=n,
                   factorization_s=seconds, hodlr_build_s=prof["build_s"],
                   hodlr_factor_s=prof["factor_s"], levels=prof["L"],
                   hodlr_leaf=prof["hodlr_leaf"],
                   max_ranks_per_level=prof["max_ranks"],
                   build_products=prof["products"],
                   build_columns=prof["columns"], build_launches=build,
                   launches=launches, solve_ms=solve_ms,
                   solve_device_profile=solve_profile, residual=res,
                   error=err, peak_memory_GB=peak)
        emit("hlu_factorization", **out)
        check(res < HLU_EPS and err < 10 * HLU_EPS,
              f"hlu {kind}: residual {res} (< {HLU_EPS}) or error {err} (< "
              f"{10 * HLU_EPS})")
        return out, launches

    lu, _ = factorize("lu", False)
    # where the factorization's time goes on the device
    facto_profile = device_profile(
        torch, lambda: copy.deepcopy(hm).lu_factorization(), reps=1, top=8)
    chol, _ = factorize("cholesky", False)
    al, al_launches = factorize("lu", True)
    check(lu["build_launches"].get(cuda_matvec.KERNEL_NAME, 0) > 0
          and cuda_matvec.ALIGNED_NAME not in lu["launches"],
          f"hlu: the LU build launched {lu['build_launches']}, not K1")
    # with the aligned layout every product, its dense buckets included
    # (K1's dense path inside the same launch), is one K1-al launch
    check(al_launches.get(cuda_matvec.ALIGNED_NAME, 0) > 0
          and set(al_launches) == {cuda_matvec.ALIGNED_NAME},
          f"hlu: the aligned LU launched {al_launches}, not K1-al alone")
    counts.update(al_launches)
    SUMMARY["hlu_lu_s"] = lu["factorization_s"]
    rng_s = np.random.RandomState(11)
    hm_s, t_asm_s = second_kind_operator(T, torch, n, rng_s, 0.5 * n, HLU_EPS,
                                         "S", "L", device)
    emit("hlu", N=n, epsilon=HLU_EPS, eta=10.0, leaf=64, dtype="float32",
         kernel="second_kind_kernel(0.5, 0.5 N)", assembly_s=t_asm,
         assembly_s_twin_S_L=t_asm_s,
         compression_ratio=float(hm.get_local_information()
                                 ["Compression_ratio"]),
         lu_s=lu["factorization_s"], cholesky_s=chol["factorization_s"],
         aligned_lu_s=al["factorization_s"],
         aligned_lu_launches=al_launches,
         lu_factorization_device_profile=facto_profile)
    return hm, hm_s


def ddm_hier(T, torch, n, device, counts):
    """The reference's hierarchical-tier solve: 2 subdomains of ~n/2 dofs,
    each factorized by HODLR; K1's launches counted around the warm
    solve."""
    from htool_python_torch.config import get_config
    from htool_python_torch.ops import cuda_matvec

    P = 2
    rng = np.random.RandomState(5)
    torch.cuda.reset_peak_memory_stats()
    approx, t_rows = second_kind_operator(T, torch, n, rng, 10.0,
                                          DDM_HIER_EPS, "N", "N", device,
                                          partitions=P)
    t0 = time.perf_counter()
    block_diag = approx.block_diagonal_hmatrix
    t_extract = time.perf_counter() - t0
    op = approx.distributed_operator
    solver = T.DDMSolverBuilder(op, block_diag).solver
    cfg = get_config()
    for s in solver.subdomains:
        check(s.local_matrix is None and s.size > cfg.ddm_local_dense_max
              and s.size > cfg.hodlr_threshold,
              f"ddm_hier: a subdomain of {s.size} dofs is not in the "
              "hierarchical tier's range")
    solver.set_hpddm_args(
        "-hpddm_krylov_method gmres -hpddm_schwarz_method asm "
        f"-hpddm_max_it {DDM_HIER_MAX_IT} -hpddm_gmres_restart 60 "
        f"-hpddm_tol {DDM_TOL}")
    t0 = time.perf_counter()
    solver.facto_one_level()
    torch.cuda.synchronize()
    t_facto = time.perf_counter() - t0
    check(solver._facto is None,
          "ddm_hier: large subdomains fell into the dense tier")
    kinds = [h["solver"].kind for h in solver._hier]
    check(kinds == ["hodlr"] * P,
          f"ddm_hier: local solvers {kinds}, not HODLR (dense fallback)")
    check(all(s.local_matrix is None for s in solver.subdomains),
          "ddm_hier: facto_one_level densified a subdomain")
    profiles = [h["solver"].hmatrix._factorization[1].profile
                for h in solver._hier]
    op64 = float64_copy(T, torch, op)
    x_ref = rng.rand(n).astype(np.float32)
    f = op * x_ref

    def solve(label):
        x = np.zeros_like(f)
        cuda_matvec.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solver.solve(x, f)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        info = solver.get_information()
        its = int(info["Nb_it"])
        true_res = float(np.linalg.norm(op * x - f) / np.linalg.norm(f))
        true_res64 = float(np.linalg.norm(op64 * x.astype(np.float64) - f)
                           / np.linalg.norm(f))
        out = dict(solve=label, iterations=its, seconds=seconds,
                   ms_per_iteration=seconds * 1e3 / its,
                   solver_residual=float(info["Residual_estimate"]),
                   true_residual=true_res, true_residual_f64=true_res64,
                   solution_rel_error=float(np.linalg.norm(x - x_ref)
                                            / np.linalg.norm(x_ref)),
                   launches={key: v for key, v in
                             cuda_matvec.LAUNCH_COUNTS.items() if v})
        emit("ddm_hier_solve", **out)
        check(np.isfinite(x).all(), f"ddm_hier {label}: non-finite solution")
        check(its < DDM_HIER_MAX_IT and true_res <= DDM_TRUE_RES_MAX
              and true_res64 <= DDM_TRUE_RES_MAX,
              f"ddm_hier {label}: {its} iterations, true residual "
              f"{true_res} (f64 operator {true_res64})")
        return out

    cold = solve("cold")
    warm = solve("warm")
    counts.update(warm["launches"])
    SUMMARY["ddm_hier_ms_per_iteration"] = {
        s["solve"]: s["ms_per_iteration"] for s in (cold, warm)}
    cases = block_row_cases(torch, op, "ddm_hier")
    A_fn = op.build_device_apply()
    M_fn = solver._device_preconditioner()
    chain_ms = apply_chain_ms(torch, lambda v: A_fn(M_fn(v)), n, 1,
                              torch.float32, device, 0)
    r = torch.rand((n, 1), device=device)
    busy = {name: device_profile(torch, lambda: fn(r)) for name, fn in
            (("apply", A_fn), ("preconditioner", M_fn))}
    x = np.zeros_like(f)
    busy["solve"] = device_profile(torch, lambda: solver.solve(x, f), reps=1,
                                   top=8)
    emit("ddm_hier", N=n, partitions=P, epsilon=DDM_HIER_EPS, eta=10.0,
         leaf=64, dtype="float32", kernel="second_kind_kernel(0.5, 10)",
         schwarz="asm", tol=DDM_TOL, restart=60,
         subdomain_sizes=[s.size for s in solver.subdomains],
         local_solvers=kinds,
         setup_s={"block_rows": t_rows, "extract_block_diagonal": t_extract,
                  "facto_one_level": t_facto,
                  "hodlr_build": [p["build_s"] for p in profiles],
                  "hodlr_factor": [p["factor_s"] for p in profiles]},
         hodlr={key: [p[key] for p in profiles] for key in
                ("L", "hodlr_leaf", "max_ranks", "products", "columns")},
         build_profile=approx.build_profile,
         peak_memory_GB=torch.cuda.max_memory_allocated() / 1e9,
         apply_plus_precond_chain_ms=chain_ms,
         device_profile=busy,
         block_row_check=cases, solves=[cold, warm])
    return cases


def f64_promoted(torch, hm, points, seed, counts):
    """The float-storage instantiations of the f64 family on an operator
    that an earlier phase assembled (the headline's float32 one from
    `main_path`, the Helmholtz path's complex64 one from `helmholtz`), so
    that nothing is assembled twice; its results join `f64_check`.  First
    the user entry points with numpy's default wider x (`hm * x` with a
    float64 or complex128 x, `hm @ X` with a complex128 X; the launches
    counted around them: the main path of hmatrix_product_f64_from_f32 /
    hmatrix_product_complex128_from_c64), their dtype and their sampled
    error against the dense oracle (<= 1e-3 on the headline, <= 2e-6 on
    Helmholtz); then the kernel against its plain version (which promotes
    the operator, as the reference does), trans N / T x k in PROMOTED_KS,
    x float64 and complex128 on float32 data, complex128 on complex64,
    within F64_TOL.  Returns the cases, each with its x dtype."""
    from htool_python_torch.ops import cuda_matvec

    n = hm.shape[0]
    rng = np.random.RandomState(seed + 3)
    helm = hm.dtype.is_complex
    x1 = rng.rand(n) + (1j * rng.rand(n) if helm else 0.0)
    X4 = np.asfortranarray(rng.rand(n, 4) + 1j * rng.rand(n, 4))
    cuda_matvec.reset_launch_counts()
    y1 = hm * x1
    Y4 = hm @ X4
    torch.cuda.synchronize()
    counts.update(cuda_matvec.LAUNCH_COUNTS)
    check(y1.dtype == x1.dtype and Y4.dtype == np.complex128
          and np.isfinite(y1).all() and np.isfinite(Y4).all(),
          f"promoted product dtype or values: {y1.dtype}, {Y4.dtype}")
    if helm:
        errs = [helmholtz_sampled_error(points, x1, y1, rng)] + [
            helmholtz_sampled_error(points, X4[:, c], Y4[:, c],
                                    np.random.RandomState(c))
            for c in range(4)]
        bar = HELM_ERR_MAX
    else:
        errs = [sampled_error(points, x1, y1, rng)] + [
            sampled_error(points, X4[:, c], Y4[:, c],
                          np.random.RandomState(c)) for c in range(4)]
        bar = SAMPLED_ERR_MAX
    check(max(errs) <= bar,
          f"promoted sampled error {max(errs)} above {bar} ({hm.dtype})")
    cases = []
    for x_dtype in ((torch.complex128,) if helm
                    else (torch.float64, torch.complex128)):
        found = kernel_cases(torch, {("N", "N"): hm}, "f64_promoted", x_dtype,
                             ("N", "T"), ks=PROMOTED_KS,
                             reps=10 if helm else 20, plain_reps=2,
                             modes=("fused",), tol=F64_TOL)
        cases += [dict(c, data=str(hm.dtype).split(".")[1],
                       x=str(x_dtype).split(".")[1]) for c in found]
    emit("f64_promoted", data=str(hm.dtype).split(".")[1], N=n,
         sampled_rel_error_k1=errs[0], sampled_rel_error_complex_max=max(
             errs[1:]), launches={k: v for k, v in counts.items() if v})
    return cases


def f64_check(T, torch, args, device, counts, promoted=()):
    """float64 / complex128 products: the headline operator assembled in
    float64 through the user entry points (`hm * x`, `hm @ X`, with the
    kernels' launches counted around them: the main path of
    hmatrix_product_f64) and its sampled error; a Helmholtz operator in
    complex128 (`hm * x`, `hm @ X` on complex x: the main path of
    hmatrix_product_complex128); then both kernels against their plain
    version, trans N / T (/ C) x storage x k in F64_KS, within F64_TOL.
    `promoted`: the cases of `f64_promoted` (the float-storage
    instantiations, run where their operators were assembled), summed up
    in this phase's line.  Returns (f64 cases, c128 cases)."""
    from htool_python_torch.models.geometry import (
        create_random_points_in_sphere, create_random_points_on_sphere)
    from htool_python_torch.models.kernels import hermitian_phase_kernel
    from htool_python_torch.ops import cuda_matvec
    from htool_python_torch.ops.matvec import stored_bytes

    rng = np.random.RandomState(args.seed)
    points = create_random_points_in_sphere(args.n, rng)
    hm, _, t_asm = build_operator(T, torch, points, "N", "N", device,
                                  torch.float64)
    check(hm.dtype == torch.float64, f"the f64 build gave {hm.dtype}")
    x1 = rng.rand(args.n)
    X8 = np.asfortranarray(rng.rand(args.n, 8))
    cuda_matvec.reset_launch_counts()
    y1 = hm * x1
    Y8 = hm @ X8
    torch.cuda.synchronize()
    counts.update(cuda_matvec.LAUNCH_COUNTS)
    check(y1.dtype == np.float64 and np.isfinite(y1).all()
          and np.isfinite(Y8).all(), "f64 product dtype or values")
    err = sampled_error(points, x1, y1, rng)
    err8 = max(sampled_error(points, X8[:, c], Y8[:, c],
                             np.random.RandomState(c)) for c in range(8))
    check(err <= SAMPLED_ERR_MAX and err8 <= SAMPLED_ERR_MAX,
          f"f64 sampled error {err}, {err8} above {SAMPLED_ERR_MAX}")

    pts_k2 = create_random_points_on_sphere(
        args.n_k2, np.random.RandomState(args.seed + 2))
    c_ops = {}
    for sym, kern in ((("N", "N"), hermitian_phase_kernel(10.0)),
                      (("H", "L"), hermitian_phase_kernel(10.0)),
                      (("S", "L"), symmetric_phase_kernel(torch))):
        c_ops[sym] = build_complex(T, torch, pts_k2, kern, *sym, device,
                                   torch.complex128)[0]
    xc = rng.rand(args.n_k2) + 1j * rng.rand(args.n_k2)
    cuda_matvec.reset_launch_counts()
    yc = c_ops[("N", "N")] * xc
    Yc = c_ops[("N", "N")] @ np.asfortranarray(np.stack([xc] * 8, 1))
    torch.cuda.synchronize()
    counts[cuda_matvec.C128_NAME] = cuda_matvec.LAUNCH_COUNTS[
        cuda_matvec.C128_NAME]
    check(yc.dtype == np.complex128 and np.isfinite(Yc).all()
          and np.linalg.norm(Yc[:, 3] - yc) <= F64_TOL * np.linalg.norm(yc),
          "complex128 product dtype or values")
    err_c = helmholtz_sampled_error(pts_k2, xc, yc, rng)
    check(err_c <= HELM_ERR_MAX,
          f"complex128 sampled error {err_c} above {HELM_ERR_MAX}")

    cases = kernel_cases(torch, {("N", "N"): hm}, "f64_check", torch.float64,
                         ("N", "T"), ks=F64_KS, reps=20, plain_reps=3,
                         modes=("fused",), tol=F64_TOL)
    c_cases = kernel_cases(torch, c_ops, "f64_check", torch.complex128,
                           ("N", "T", "C"), ks=F64_KS, reps=20, plain_reps=2,
                           modes=("fused",), tol=F64_TOL)
    emit("f64_check", N=args.n, dtype="float64", assembly_s=t_asm,
         stored_bytes=int(stored_bytes(hm._product_data())),
         sampled_rel_error_k1=err, sampled_rel_error_k8_max=err8,
         complex128_N=args.n_k2, complex128_stored_bytes=int(stored_bytes(
             c_ops[("N", "N")]._product_data())),
         complex128_sampled_rel_error=err_c,
         launches={k: v for k, v in counts.items() if v},
         promoted_cases=len(promoted),
         promoted_max_rel_err=max((c["max_rel_err"] for c in promoted),
                                  default=None))
    return cases, c_cases


def free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def plain_transposed_apply(torch, op, x2d, trans):
    """The sharded operator's transposed product with each block row in
    its plain version, summed on this process: the yardstick of its 'T'
    product (which runs the kernels and an all_reduce)."""
    from htool_python_torch.ops.matvec import apply_hmatrix_padded

    perm_t = torch.as_tensor(op.target_cluster.get_permutation(),
                             device=x2d.device)
    inv_s = torch.as_tensor(np.argsort(op.source_cluster.get_permutation()),
                            device=x2d.device)
    x_int = x2d[perm_t]
    y_int = torch.zeros((op.shape[1], x2d.shape[1]), dtype=x2d.dtype,
                        device=x2d.device)
    for p, h in enumerate(op.hmatrices):
        o, s = int(op.t_offsets[p]), int(op.t_sizes[p])
        base = h.plan.target_offset if h.plan.t_off_absolute else 0
        x_pad = torch.zeros((h._pad_len, x2d.shape[1]), dtype=x2d.dtype,
                            device=x2d.device)
        x_pad[base:base + s] = x_int[o:o + s]
        y_int += apply_hmatrix_padded(h._product_data(), x_pad, h._pad_len,
                                      trans, h.symmetry)[:op.shape[1]]
    return y_int[inv_s]


def sharded(T, torch, n, device, counts):
    """The sharded operator (parallel/sharded.py) on a world-1 NCCL group:
    the headline kernel on n points (seed 1), P = SHARDED_P partitions on
    this one rank, in float64 and float32; products against the
    single-process DistributedOperator ('N', 3 columns) and the block
    rows' plain version ('T'); in float64 the sharded block-Jacobi
    preconditioner on the dense subdomain matrices against a sequential
    loop of solves, and one GMRES solve with it; then the multi-process
    dryrun (python -m htool_python_torch.parallel.dryrun, one process per
    card) in a process of its own, after this group is destroyed."""
    import torch.distributed as dist

    from htool_python_torch.models.geometry import \
        create_random_points_in_sphere
    from htool_python_torch.models.kernels import inverse_distance_kernel
    from htool_python_torch.ops import cuda_matvec
    from htool_python_torch.parallel import (ShardedDistributedOperator,
                                             initialize_distributed,
                                             process_count)

    check(initialize_distributed(f"tcp://127.0.0.1:{free_port()}", 1, 0,
                                 "nccl") and process_count() == 1,
          "the world-1 NCCL group did not come up")
    points = create_random_points_in_sphere(n, np.random.RandomState(1))
    cb = T.ClusterTreeBuilder()
    cb.set_maximal_leaf_size(128)
    cluster = cb.create_cluster_tree(points, 2, size_of_partition=SHARDED_P)
    gen = T.KernelGenerator(inverse_distance_kernel(0.1), points, points,
                            device=device)
    out = {"N": n, "partitions": SHARDED_P, "world_size": process_count(),
           "device_count": torch.cuda.device_count()}
    rng = np.random.RandomState(2)
    try:
        for dtype, tol in ((torch.float64, SHARDED_F64_TOL),
                           (torch.float32, KERNEL_TOL)):
            name = str(dtype).split(".")[1]
            np_dtype = np.float64 if dtype == torch.float64 else np.float32
            hb = T.HMatrixTreeBuilder(1e-3, 10.0, "N", "N", device=device)
            hb.set_dtype(dtype)
            t0 = time.perf_counter()
            approx = T.DefaultApproximationBuilder(gen, cluster, cluster, hb)
            t_build = time.perf_counter() - t0
            op = ShardedDistributedOperator(approx.hmatrix, cluster, cluster)
            x = rng.rand(n).astype(np_dtype)
            X = np.asfortranarray(rng.rand(n, 3).astype(np_dtype))
            cuda_matvec.reset_launch_counts()
            y, yt, Y = op * x, op.matvec_global(x, "T"), op @ X
            torch.cuda.synchronize()
            launches = {k: v for k, v in cuda_matvec.LAUNCH_COUNTS.items()
                        if v}
            counts.update({f"{name}/{k}": v for k, v in launches.items()})
            y_ref = approx.distributed_operator * x
            Y_ref = approx.distributed_operator @ X
            yt_ref = plain_transposed_apply(
                torch, op, torch.as_tensor(x[:, None], device=device),
                "T")[:, 0].cpu().numpy()
            errs = {key: float(np.linalg.norm(a - b) / np.linalg.norm(b))
                    for key, a, b in (("N", y, y_ref), ("T", yt, yt_ref),
                                      ("k3", Y, Y_ref))}
            check(all(np.isfinite(e) and e <= tol for e in errs.values()),
                  f"sharded {name} products disagree: {errs} above {tol}")
            apply = op.build_device_apply()
            res = {"build_s": t_build, "errors": errs, "tolerance": tol,
                   "launches": launches,
                   "sampled_rel_error": sampled_error(points, x, y, rng),
                   "product_ms": {f"k{k}": apply_chain_ms(
                       torch, apply, n, k, dtype, device, k)
                       for k in (1, 8)}}
            if dtype == torch.float64:
                res.update(sharded_solve(torch, op, approx, cluster, device,
                                         rng, counts))
            out[name] = res
            del approx, op
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m",
                           "htool_python_torch.parallel.dryrun",
                           "--timeout", "300"],
                          cwd=os.path.dirname(os.path.abspath(__file__)),
                          capture_output=True, text=True, timeout=360)
    out["dryrun"] = {"exit": proc.returncode,
                     "seconds": time.perf_counter() - t0,
                     "last_line": (proc.stdout.strip().splitlines()
                                   or [""])[-1][:600]}
    emit("sharded", **out)
    check(proc.returncode == 0, f"the dryrun failed (exit "
          f"{proc.returncode}):\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    return out


def sharded_solve(torch, op, approx, cluster, device, rng, counts):
    """The float64 part of `sharded`: block-Jacobi on the dense subdomain
    matrices (each partition's diagonal block densified on the card,
    factorized by torch.linalg.lu_factor), against a loop of
    torch.linalg.solve; one GMRES solve (restart 60, tol
    SHARDED_GMRES_TOL) with the kernels' launches counted."""
    from htool_python_torch.ops import cuda_matvec
    from htool_python_torch.parallel import sharded_block_solve
    from htool_python_torch.solvers.krylov import gmres_device

    n = op.shape[0]
    P = op.n_partitions
    m = int(op.t_sizes.max())
    perm = cluster.get_permutation()
    t0 = time.perf_counter()
    mats = torch.zeros((P, m, m), dtype=torch.float64, device=device)
    idx = np.full((P, m), n, dtype=np.int64)
    weights = np.zeros((P, m))
    ids = []
    for p in range(P):
        o, s = int(op.t_offsets[p]), int(op.t_sizes[p])
        ids.append(torch.as_tensor(perm[o:o + s], device=device))
        idx[p, :s] = perm[o:o + s]
        weights[p, :s] = 1.0
        mats[p, :s, :s] = approx.block_diagonal_hmatrix[p].to_dense_tensor()
        pad = torch.arange(s, m, device=device)
        mats[p, pad, pad] = 1.0
    lu, piv = torch.linalg.lu_factor(mats)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    precond = sharded_block_solve(lu, piv, idx, weights, n)
    r = torch.as_tensor(rng.rand(n), device=device)
    z = precond(r)
    z_ref = torch.zeros_like(r)
    for p, rows in enumerate(ids):
        s = len(rows)
        z_ref[rows] = torch.linalg.solve(mats[p, :s, :s], r[rows])
    err_p = float(torch.linalg.norm(z - z_ref) / torch.linalg.norm(z_ref))
    check(err_p <= SHARDED_F64_TOL,
          f"sharded preconditioner mismatch {err_p} above {SHARDED_F64_TOL}")
    del mats
    x_true = torch.as_tensor(rng.rand(n), device=device)
    apply = op.build_device_apply()
    b = apply(x_true[:, None])[:, 0]
    cuda_matvec.reset_launch_counts()
    t0 = time.perf_counter()
    x_sol, info = gmres_device(apply, b, M_fn=precond.device_apply,
                               tol=SHARDED_GMRES_TOL, max_it=500, restart=60)
    torch.cuda.synchronize()
    t_solve = time.perf_counter() - t0
    launches = {k: v for k, v in cuda_matvec.LAUNCH_COUNTS.items() if v}
    counts.update({f"gmres/{k}": v for k, v in launches.items()})
    res = float(np.max(info["residual"]))
    its = int(np.max(info["niter"]))
    check(res <= SHARDED_GMRES_TOL,
          f"sharded GMRES residual {res} above {SHARDED_GMRES_TOL} after "
          f"{its} iterations")
    return {"precond_setup_s": t_setup, "precond_err": err_p,
            "gmres_iterations": its, "gmres_residual": res,
            "gmres_s": t_solve, "gmres_ms_per_iteration": t_solve / its * 1e3,
            "solution_err": float(torch.linalg.norm(x_sol - x_true)
                                  / torch.linalg.norm(x_true)),
            "gmres_launches": launches}


class _HookFactors:
    """The custom-hooks phase's user callbacks: a truncated SVD of each
    admissible block (the arithmetic of the reference's tests/conftest.py
    `CustomSVDLowRank`) and one dense-blocks call, both from the kernel's
    entries computed on the host; the SVDs are kept by block, so that the
    same build on the CPU repeats every callback but not its SVDs."""

    def __init__(self, points):
        self.points = points
        self.svds = {}
        self.dense_calls = 0
        self.lr_calls = 0

    def entries(self, rows, cols):
        d = np.linalg.norm(self.points[:, rows, None]
                           - self.points[:, None, cols], axis=0)
        return 1.0 / (0.1 + d)

    def low_rank(self, rows, cols, epsilon):
        import math

        self.lr_calls += 1
        key = (rows.tobytes(), cols.tobytes())
        if key not in self.svds:
            submat = self.entries(rows, cols)
            u, s, vh = np.linalg.svd(submat, full_matrices=False)
            norm = np.linalg.norm(submat)
            svd_norm = 0.0
            trunc = len(s) - 1
            while trunc > 0 and math.sqrt(svd_norm) / norm < epsilon:
                svd_norm += s[trunc] ** 2
                trunc -= 1
            trunc += 1
            self.svds[key] = (None if trunc * (len(rows) + len(cols))
                              > len(rows) * len(cols)
                              else (u[:, :trunc] * s[:trunc], vh[:trunc]))
        return self.svds[key]


def custom_hooks(T, torch, n, seed, device, counts):
    """The custom low-rank and dense-block hooks: the headline kernel on n
    points (seed + 3), f32, built on the card with a VirtualLowRankGenerator
    and a VirtualDenseBlocksGenerator (`_HookFactors`), its product through
    K1 with the launches counted, the sampled error against the dense
    oracle, and the same build on the CPU (the plain version's product)."""
    from htool_python_torch.models.geometry import \
        create_random_points_in_sphere
    from htool_python_torch.models.kernels import inverse_distance_kernel
    from htool_python_torch.ops import cuda_matvec

    points = create_random_points_in_sphere(n, np.random.RandomState(seed + 3))
    factors = _HookFactors(points)

    class LowRank(T.VirtualLowRankGenerator):
        def build_low_rank_approximation(self, rows, cols, epsilon):
            uv = factors.low_rank(rows, cols, epsilon)
            if uv is None:
                return False
            self.set_U(uv[0])
            self.set_V(uv[1])
            return True

    class Dense(T.VirtualDenseBlocksGenerator):
        def build_dense_blocks(self, rows_offsets, cols_offsets, blocks):
            factors.dense_calls += 1
            for rows, cols, block in zip(rows_offsets, cols_offsets, blocks):
                block[:, :] = factors.entries(rows, cols)

    builder = T.ClusterTreeBuilder()
    builder.set_maximal_leaf_size(128)
    cluster = builder.create_cluster_tree(points, 2)
    builds = {}
    for label, dev in (("card", device), ("cpu", torch.device("cpu"))):
        hb = T.HMatrixTreeBuilder(SAMPLED_ERR_MAX, 10.0, "N", "N",
                                  device=dev)
        hb.set_dtype(torch.float32)
        hb.set_low_rank_generator(LowRank())
        hb.set_dense_blocks_generator(Dense())
        calls = factors.dense_calls
        t0 = time.perf_counter()
        hm = hb.build(T.KernelGenerator(inverse_distance_kernel(0.1), points,
                                        points, device=dev), cluster, cluster)
        torch.cuda.synchronize()
        builds[label] = (hm, time.perf_counter() - t0,
                         factors.dense_calls - calls)
    hm, t_build, dense_calls = builds["card"]
    rng = np.random.RandomState(4)
    x = rng.rand(n).astype(np.float32)
    cuda_matvec.reset_launch_counts()
    y = hm * x
    torch.cuda.synchronize()
    counts.update(cuda_matvec.LAUNCH_COUNTS)
    y_cpu = builds["cpu"][0] * x
    diff = float(np.linalg.norm(y - y_cpu) / np.linalg.norm(y_cpu))
    err = sampled_error(points, x, y, rng)
    emit("custom_hooks", N=n, dtype="float32", epsilon=SAMPLED_ERR_MAX,
         build_s=t_build, cpu_build_s=builds["cpu"][1],
         low_rank_calls=factors.lr_calls // 2,
         low_rank_blocks=hm.plan.nb_lowrank_blocks(),
         dense_blocks_calls_per_build=[dense_calls, builds["cpu"][2]],
         dense_blocks=hm.plan.nb_dense_blocks(), lr_svd_form=hm._lr_svd_form,
         sampled_rel_error=err, card_vs_cpu_rel_diff=diff,
         launches={k: v for k, v in counts.items() if v})
    check(dense_calls == 1 and builds["cpu"][2] == 1,
          "the dense-blocks hook was not called once a build")
    check(not hm._lr_svd_form and hm.plan.nb_lowrank_blocks() > 0,
          "the custom build kept no low-rank block")
    check(err <= SAMPLED_ERR_MAX,
          f"custom-hooks sampled error {err} above {SAMPLED_ERR_MAX}")
    check(diff <= KERNEL_TOL,
          f"custom-hooks product differs from the CPU build by {diff}")
    check(counts.get(cuda_matvec.KERNEL_NAME, 0) > 0,
          "the custom-hooks product never launched K1")


TREE_INT_FIELDS = ("offsets", "sizes", "depths", "parents", "children_start",
                   "children_count", "partition")


def native_cluster(T, torch, n, n_helm, seed):
    """The headline and Helmholtz trees (leaf 128, PCARegular) by the
    native C++ builder and by the numpy path (a subclass of the built-in
    policy is a user policy, which takes it): every node array and the
    permutation equal (centers and radii to 1e-12: another summation
    order), and both host times."""
    from htool_python_torch.models.geometry import (
        create_random_points_in_sphere, create_random_points_on_sphere)

    class NumpyPath(T.PCARegular):
        """The built-in policy as a user policy: the numpy path."""

    # load the library before the clock runs (it is built in `device`)
    T.ClusterTreeBuilder().create_cluster_tree(
        np.random.RandomState(0).rand(3, 64), 2)
    clouds = (("headline", create_random_points_in_sphere(
                  n, np.random.RandomState(seed))),
              ("helmholtz", create_random_points_on_sphere(
                  n_helm, np.random.RandomState(1))))
    for label, points in clouds:
        trees, seconds = [], []
        for strategy in (T.PCARegular(), NumpyPath()):
            builder = T.ClusterTreeBuilder()
            builder.set_maximal_leaf_size(128)
            builder.set_partitioning_strategy(strategy)
            t0 = time.perf_counter()
            trees.append(builder.create_cluster_tree(points, 2).tree)
            seconds.append(time.perf_counter() - t0)
        nat, ref = trees
        check(nat.nb_nodes == ref.nb_nodes
              and all(np.array_equal(getattr(nat, f), getattr(ref, f))
                      for f in TREE_INT_FIELDS),
              f"native_cluster {label}: the node arrays differ")
        perm_equal = bool(np.array_equal(nat.permutation, ref.permutation))
        leaves = np.flatnonzero(nat.children_count == 0)
        check(perm_equal or all(
            set(nat.permutation[o:o + s]) == set(ref.permutation[o:o + s])
            for o, s in zip(nat.offsets[leaves], nat.sizes[leaves])),
            f"native_cluster {label}: a leaf holds other points")
        center_err = float(np.abs(nat.centers - ref.centers).max())
        radius_err = float(np.abs(nat.radii - ref.radii).max())
        check(center_err <= 1e-12 and radius_err <= 1e-12,
              f"native_cluster {label}: centers / radii differ by "
              f"{center_err} / {radius_err}")
        emit("native_cluster", operator=label, N=points.shape[1], leaf=128,
             nodes=int(nat.nb_nodes), native_s=seconds[0],
             numpy_s=seconds[1], permutation_equal=perm_equal,
             max_center_diff=center_err, max_radius_diff=radius_err)


def _reference_all(path):
    """The names of a reference `__init__.py`'s `__all__`, read from its
    source without importing it (the reference needs JAX, which this
    machine does not have): the literal list, or where `__all__` is built
    from dir(), every name the file imports or assigns."""
    import ast

    tree = ast.parse(path.read_text())
    names = []
    for node in tree.body:
        if isinstance(node, ast.Assign):
            for target in node.targets:
                if isinstance(target, ast.Name) and target.id == "__all__":
                    if isinstance(node.value, (ast.List, ast.Tuple)):
                        return [e.value for e in node.value.elts]
                elif isinstance(target, ast.Name):
                    names.append(target.id)
        elif isinstance(node, ast.ImportFrom):
            names += [a.asname or a.name for a in node.names]
    return [n for n in names if not n.startswith("_")]


# reference names the port does not carry (tests/test_torch_surface.py
# NOT_PORTED; ROADMAP §1 "Not ported")
SURFACE_NOT_PORTED = {"use_x64"}


def surface(T, torch, hm, n):
    """The reference's public names imported from the port on this
    machine (which has no matplotlib), and HMatrix's
    get_distributed_information() / lowrank_leaves() on the headline
    operator."""
    import importlib
    import importlib.util
    from pathlib import Path

    t0 = time.perf_counter()
    ref_root = Path(__file__).resolve().parent / "htool_python_tpu"
    imported = {}
    for sub in ("", "clustering", "hmatrix", "models", "parallel",
                "solvers", "utils", "ops"):
        names = _reference_all(ref_root / sub / "__init__.py")
        module = importlib.import_module(
            "htool_python_torch" + (f".{sub}" if sub else ""))
        missing = [name for name in names if name not in SURFACE_NOT_PORTED
                   and not hasattr(module, name)]
        check(not missing, f"surface: {module.__name__} lacks {missing}")
        imported[sub or "root"] = len(names)
    check("matplotlib" not in sys.modules,
          "surface: importing the package loaded matplotlib")

    info = hm.get_distributed_information()
    local = hm.get_local_information()
    check(info["Number_of_rows"] == str(n) and info["Number_of_partitions"]
          == "1" and all(info[k] == local[k] for k in local),
          f"surface: get_distributed_information {info} against {local}")
    leaves = hm.lowrank_leaves()
    check(len(leaves) == len(hm.plan.lowrank_buckets)
          and sum(len(r) for *_, r in leaves) == hm.plan.nb_lowrank_blocks()
          and all(U.shape == (b.nb, b.pt, V.shape[1])
                  and V.shape[::2] == (b.nb, b.ps)
                  for U, V, b, _ in leaves),
          "surface: lowrank_leaves shapes")
    emit("surface", seconds=time.perf_counter() - t0,
         names_checked=imported,
         matplotlib_installed=importlib.util.find_spec("matplotlib")
         is not None, distributed_information=info,
         lowrank_leaves=len(leaves),
         lowrank_leaf_bytes=int(sum(U.nbytes + V.nbytes
                                    for U, V, *_ in leaves)))


def surface_compact(torch, hm, counts):
    """compact_for_products() on an operator whose products read the
    aligned layout (K1-al): the assembly arrays are freed, K1-al's
    products afterwards equal those before (bit for bit where two calls
    before it agree bit for bit; K1-al sums with f32 atomics), and
    densification raises."""
    from htool_python_torch.config import get_config
    from htool_python_torch.ops import cuda_matvec

    t0 = time.perf_counter()
    cfg = get_config()
    cfg.matvec_aligned_layout = True
    try:
        gen = torch.Generator(device=hm.device).manual_seed(5)
        X = torch.rand((hm.shape[1], 8), generator=gen, device=hm.device)
        cuda_matvec.reset_launch_counts()
        before = [hm.matvec(X) for _ in range(2)]
        torch.cuda.synchronize()
        mem_before = torch.cuda.memory_allocated()
        hm.compact_for_products()
        torch.cuda.synchronize()
        mem_after = torch.cuda.memory_allocated()
        after = hm.matvec(X)
        torch.cuda.synchronize()
        counts.update(cuda_matvec.LAUNCH_COUNTS)
    finally:
        cfg.matvec_aligned_layout = False
    try:
        hm.to_dense()
        raised = False
    except RuntimeError as e:
        raised = "compact_for_products" in str(e)
    repeatable = bool(torch.equal(before[0], before[1]))
    bitwise = bool(torch.equal(after, before[0]))
    err = float((after - before[0]).abs().max() / before[0].abs().max())
    emit("surface_compact", seconds=time.perf_counter() - t0,
         operator="hlu, N=" + str(hm.shape[0]),
         launches={k: v for k, v in counts.items() if v},
         freed_GB=(mem_before - mem_after) / 1e9,
         repeatable_before=repeatable, bitwise_equal=bitwise,
         max_rel_diff=err, to_dense_raises=raised)
    # each product in user numbering: K1-al between its two permutations
    permutes = (cuda_matvec.PERMUTE_IN_NAME, cuda_matvec.PERMUTE_OUT_NAME)
    check(counts.get(cuda_matvec.ALIGNED_NAME, 0) > 0
          and set(k for k, v in counts.items() if v and k not in permutes)
          == {cuda_matvec.ALIGNED_NAME}
          and all(counts[k] == len(before) + 1 for k in permutes),
          "surface_compact: the products did not run K1-al alone")
    check(hm._data is None and mem_after < mem_before,
          "surface_compact: the assembly arrays were not freed")
    check(bitwise or (not repeatable and err <= KERNEL_TOL),
          f"surface_compact: products after compaction differ by {err}")
    check(raised, "surface_compact: to_dense did not raise")


def _printable(value):
    """An example's numbers for its line: long arrays by their shape."""
    if isinstance(value, dict):
        return {k: _printable(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_printable(v) for v in value]
    if isinstance(value, np.ndarray):
        return value.tolist() if value.size <= 8 else {"shape": value.shape}
    if isinstance(value, np.generic):
        return value.item()
    return value


def examples(torch, counts):
    """Every port example's run() on the card (float32, K1): its numbers,
    seconds and kernel launches on one line each; an example whose own
    assertion fails fails the script."""
    import contextlib
    import importlib
    import io

    from htool_python_torch.examples import EXAMPLES
    from htool_python_torch.ops import cuda_matvec

    for name in EXAMPLES:
        module = importlib.import_module(f"htool_python_torch.examples.{name}")
        cuda_matvec.reset_launch_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):  # its own prints
            numbers = module.run()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {k: v for k, v in cuda_matvec.LAUNCH_COUNTS.items() if v}
        for k, v in launches.items():
            counts[k] = counts.get(k, 0) + v
        emit("example", name=name, seconds=seconds, launches=launches,
             **_printable(numbers))
        if name == "use_hmatrix":
            check(launches.get(cuda_matvec.KERNEL_NAME, 0) > 0,
                  "use_hmatrix never launched kernel K1")
    check(counts.get(cuda_matvec.KERNEL_NAME, 0) > 0,
          "the examples never launched kernel K1")


def profiling(torch, device, counts, smi):
    """The profiling path (python -m htool_python_torch.profiling) at the
    reference's sizes, with P1-P4's launches counted around it; returns its
    result."""
    from htool_python_torch.profiling import bucket_variants, stream
    from htool_python_torch.profiling.__main__ import failures, run_profile

    stream.reset_launch_counts()
    bucket_variants.reset_launch_counts()
    t0 = time.perf_counter()
    result = run_profile(device)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts.update(stream.LAUNCH_COUNTS)
    counts.update(bucket_variants.LAUNCH_COUNTS)
    emit("profiling", card=smi, wall_s=seconds, launches=dict(counts),
         **result)
    check(not failures(result), f"profiling: {failures(result)} failed")
    return result


def _timed_case(run, plain, library=None, reps=20, plain_reps=5):
    """ms of a kernel's wrapper, of its plain version and of the library
    yardstick (None without one), by CUDA events on the same inputs."""
    from htool_python_torch.profiling.timing import cuda_ms

    return dict(ms=cuda_ms(run, reps=reps),
                plain_ms=cuda_ms(plain, reps=plain_reps, warmup=1),
                library_ms=None if library is None else cuda_ms(library,
                                                                reps=reps))


def tf32_check(args, diff, y_plain, tol):
    """For a TF32 'xgemm' variant of P3: the largest error in standard
    deviations of `tf32_error_std`, and that its tolerance rejects a zero
    output and the output with the first group of G blocks left out."""
    from htool_python_torch.profiling import bucket_variants as bv

    kind, gather, term, accum, slabs, (t_off, s_off), x, L, G = args[:9]
    sd = bv.tf32_error_std(kind, gather, accum, slabs, (t_off, s_off), x,
                           L, G, *args[9:])
    group = bv.bucket_variant_plain(kind, gather, term, accum, slabs[:G],
                                    (t_off[:G], s_off[:G]), x, L, G,
                                    *args[9:])
    # leaving the group out moves the output by the group's own output
    return dict(tf32_sigmas=float((diff / sd)[sd > 0].max()),
                rejects_zero=bool((y_plain.abs() > tol).any()),
                rejects_dropped_group=bool((group.abs() > tol).any()))


def sink_case(torch, kind, gather, term, offs, x, L, G, r, pt, ps):
    """A P3 variant with accum 'skip' (y stays 0) on positive slabs, so that
    its per-CTA sums do not cancel: y == 0, and the sums against the plain
    version's and against their float64 value, G pt 1e-30 sum(the group's
    slab) for the 'stream' variant, each to 1e-5 relative."""
    from htool_python_torch.profiling import bucket_variants as bv

    nb = offs[0].shape[0]
    g = torch.Generator(x.device).manual_seed(6)
    slabs = torch.rand((nb, bv.slab_rows(kind, r, pt), max(pt, ps)),
                       device=x.device, generator=g)
    args = (kind, gather, term, "skip", slabs, offs, x, L, G, r, pt, ps)
    y, sink = bv.bucket_variant(*args, return_sink=True)
    y_plain, sink_plain = bv.bucket_variant_plain(*args, return_sink=True)
    fields = dict(y_zero=not (y.any() or y_plain.any()))
    err = float((sink - sink_plain).abs().max())
    fields.update(max_abs_err=err,
                  max_rel_err=err / float(sink_plain.abs().max()))
    if (gather, term) == ("none", "skip"):
        exact = slabs.double().reshape(nb // G, -1).sum(1) * (G * pt * 1e-30)
        fields["sink_err_of_exact"] = float(
            ((sink.double() - exact).abs() / exact).max())
    check(fields["y_zero"] and fields["max_rel_err"] <= KERNEL_TOL
          and fields.get("sink_err_of_exact", 0.0) <= KERNEL_TOL,
          f"P3 ({kind}, {gather}, {term}, skip) disagrees with its plain "
          f"version: {fields}")
    fields.update(_timed_case(lambda: bv.bucket_variant(*args),
                              lambda: bv.bucket_variant_plain(*args)))
    return fields


def profiling_checks(torch, device):
    """P1-P4 against their plain versions on the card at the profiling
    path's shapes, on inputs drawn on the card: every P1 case, P2 once for
    each width of its cases (the kernel sees nothing else of the shape),
    P3's six variants on both buckets with K1 on the same bucket, P4 at the
    probe's shapes and on random indices.  One `profiling_check` line per
    case with its error, ms, plain ms, library ms and bound; fails above the
    kernels' tolerances (P1 and P2: 1e-5 relative, on positive entries; P3:
    `kernel_tolerance`, 1e-5 relative plus 8 standard deviations of the
    TF32 error for 'xgemm', which must reject a zero output and one group
    left out; 'stream' on its per-CTA sums; P4: exact).  These launches are
    checks, not the profiling path's."""
    from htool_python_torch.ops.cuda_matvec import (BucketTable,
                                                    apply_hmatrix_cuda)
    from htool_python_torch.ops.matvec import apply_hmatrix_padded
    from htool_python_torch.profiling import bucket_variants as bv
    from htool_python_torch.profiling import stream
    from htool_python_torch.profiling.__main__ import take_probe
    from htool_python_torch.profiling.bounds import (HBM_BYTES_PER_S,
                                                     TF32_FLOPS)

    g = torch.Generator(device).manual_seed(5)
    cases = {"P1": {}, "P2": {}, "P3": {}, "P4": {}}

    def record(kind, name, **fields):
        emit("profiling_check", kernel=kind, case=name, **fields)
        cases[kind][name] = fields

    x = torch.rand((1, stream.OUT_COLS), device=device, generator=g)
    for step_mb, n_buf in stream.STREAM_CASES:
        rows, _ = stream.stream_rows(step_mb, n_buf)
        bufs = [torch.rand((rows, stream.WIDTH), device=device, generator=g)
                for _ in range(n_buf)]
        y = stream.stream_probe(bufs, x, step_mb)
        y_plain = stream.stream_probe_plain(bufs, x, step_mb)
        err = float((y - y_plain).abs().max())
        nbytes = sum(b.numel() * 4 for b in bufs) + 2 * x.numel() * 4
        record("P1", f"s{step_mb}MB_b{n_buf}", max_abs_err=err,
               max_rel_err=err / float(y_plain.abs().max()),
               bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, **_timed_case(
                   lambda: stream.stream_probe(bufs, x, step_mb),
                   lambda: stream.stream_probe_plain(bufs, x, step_mb),
                   lambda: [torch.sum(b, 0) for b in bufs]))
        case = cases["P1"][f"s{step_mb}MB_b{n_buf}"]
        case["GBs"] = nbytes / case["ms"] / 1e6
        check(cases["P1"][f"s{step_mb}MB_b{n_buf}"]["max_rel_err"]
              <= KERNEL_TOL, f"P1 disagrees with its plain version at "
              f"({step_mb}, {n_buf})")
        del bufs
    x = torch.zeros((1, 1), device=device)
    runs_as = stream.launch_groups(stream.SHAPE_CASES)
    for name, shape, G in stream.SHAPE_CASES:
        if runs_as[name] != name:  # the kernel sees only the last dimension
            continue
        # positive entries, so that the sum does not cancel
        A = torch.rand((stream.shape_blocks(shape, G),) + shape,
                       device=device, generator=g)
        o = stream.shape_stream(A, x, G)
        o_plain = stream.shape_stream_plain(A, x, G)
        err = float((o - o_plain).abs())
        record("P2", name, max_abs_err=err,
               max_rel_err=err / float(o_plain.abs()),
               bound_ms=(A.numel() + 2) * 4 / HBM_BYTES_PER_S * 1e3,
               **_timed_case(lambda: stream.shape_stream(A, x, G),
                             lambda: stream.shape_stream_plain(A, x, G),
                             lambda: A.sum()))
        check(cases["P2"][name]["max_rel_err"] <= KERNEL_TOL,
              f"P2 disagrees with its plain version on {name}")
        del A
    p1_gbs = max(c["GBs"] for c in cases["P1"].values())
    L = bv.LENGTH
    for kind, r, pt, ps, G in bv.CASES:
        nb, per = bv.case_blocks(kind, bv.TOTAL_MB, G, r, pt, ps)
        slabs = torch.randn((nb, bv.slab_rows(kind, r, pt), max(pt, ps)),
                            device=device, generator=g)
        offs = tuple(torch.randint(0, L - w - 256, (nb,), device=device,
                                   generator=g, dtype=torch.int32)
                     for w in (pt, ps))
        x = torch.randn((1, L), device=device, generator=g)
        nbytes = nb * per + 2 * 4 * L + 8 * nb
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        # 'xgemm' computes every tile of its block-diagonal GEMMs: G times
        # the flops of 'vpu', in TF32
        flops = 2 * nb * G * (r * (ps + pt) if kind == "lr" else pt * ps)
        xgemm_bounds = dict(bytes_bound_ms=bound,
                            ops_bound_ms=flops / TF32_FLOPS * 1e3,
                            flops=flops, bound_by="bytes" if bound >= flops
                            / TF32_FLOPS * 1e3 else "operations")

        def rates(fields, term):
            """The case's read rate over the stored bytes and its share of
            P1's best rate in this run; for 'xgemm' both bounds."""
            fields["GBs"] = nbytes / fields["ms"] / 1e6
            fields["share_of_p1"] = fields["GBs"] / p1_gbs
            if term == "xgemm":
                fields.update(xgemm_bounds,
                              bound_ms=max(bound, xgemm_bounds["ops_bound_ms"]))
            return fields

        for name, gather, term, accum in bv.VARIANTS:
            if accum == "skip":
                record("P3", f"{kind}/{name}", **rates(dict(
                    bound_ms=bound, **sink_case(torch, kind, gather, term,
                                                offs, x, L, G, r, pt, ps)),
                    term))
                continue
            args = (kind, gather, term, accum, slabs, offs, x, L, G, r, pt,
                    ps)
            y = bv.bucket_variant(*args)
            y_plain = bv.bucket_variant_plain(*args)
            diff = (y - y_plain).abs()
            tol = bv.kernel_tolerance(*args, y_plain)
            fields = dict(within_tolerance=bool((diff <= tol).all()))
            if term == "xgemm":
                fields.update(tf32_check(args, diff, y_plain, tol))
            record("P3", f"{kind}/{name}", **rates(dict(
                max_abs_err=float(diff.max()),
                max_rel_err=float(diff.max() / max(
                    float(y_plain.abs().max()), 1e-30)),
                bound_ms=bound, **fields, **_timed_case(
                    lambda: bv.bucket_variant(*args),
                    lambda: bv.bucket_variant_plain(*args))), term))
            check(all(v for k, v in fields.items() if k != "tf32_sigmas"),
                  f"P3 disagrees with its plain version on {kind}/{name}, "
                  f"or its check would pass a wrong output: {fields}")
        data = bv.k1_data(kind, slabs, offs, r, pt, ps)
        table = BucketTable(data, slabs.device)
        x_pad = x.reshape(L, 1)
        y_k1 = apply_hmatrix_cuda(data, x_pad, L, "N", "N", table)
        y_base = bv.bucket_variant(kind, "roll", "vpu", "roll", slabs, offs,
                                   x, L, G, r, pt, ps)
        err = float((y_k1.reshape(1, L) - y_base).abs().max())
        record("P3", f"{kind}/k1", **rates(dict(
            max_abs_err=err, max_rel_err=err / float(y_base.abs().max()),
            bound_ms=bound, **_timed_case(lambda: apply_hmatrix_cuda(
                data, x_pad, L, "N", "N", table),
                lambda: apply_hmatrix_padded(data, x_pad, L, "N", "N"))),
            "vpu"))
        check(cases["P3"][f"{kind}/k1"]["max_rel_err"] <= KERNEL_TOL,
              f"K1 and the 'base' variant disagree on the {kind} bucket")
        del slabs, data, table
    _, (xp, probe) = take_probe(device)
    xr = torch.rand((8, 1024), device=device, generator=g)
    rand = torch.randint(0, 1024, (8, 256), device=device, generator=g,
                         dtype=torch.int32)
    for name, xx, idx in (("probe", xp, probe), ("random", xr, rand)):
        out = bv.take_along_axis(xx, idx)
        err = float((out - bv.take_along_axis_plain(xx, idx)).abs().max())
        idx64 = idx.long()
        nbytes = (xx.numel() + 2 * idx.numel()) * 4
        # timed in the form that reads nothing back: one device counter
        # per case, checked once after the reps.  ms: events around
        # back-to-back calls, which the host's time per call bounds;
        # device_ms: the same calls queued behind a spin kernel
        fault = bv.fault_counter(device)

        def take():
            return bv.take_along_axis(xx, idx, fault=fault)

        def gather():
            return torch.gather(xx, 1, idx64)

        record("P4", name, max_abs_err=err,
               bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
               device_ms=device_ms(torch, take, reps=100),
               library_device_ms=device_ms(torch, gather, reps=100),
               **_timed_case(take, lambda: bv.take_along_axis_plain(xx, idx),
                             gather, reps=100))
        bv.check_fault(fault, xx.shape[1])
        check(err == 0.0, f"P4 disagrees with its plain version ({name})")
    return cases


def profiling_entries(counts, checks, result):
    """The `kernels` line's entries of P1-P4: the representative case's
    numbers from `profiling_checks`, every case's ms beside them, and the
    profiling path's chain times."""
    pal = "tools/profile_matvec"

    def entry(pid, name, source, replaces, case, bound_by="bytes"):
        head = checks[pid][case]
        return {"name": name, "id": pid, "route": "cuda",
                "source": "htool_python_torch/csrc/" + source,
                "replaces": replaces, "launches": counts[name],
                "max_abs_err": max(c["max_abs_err"]
                                   for c in checks[pid].values()),
                "ms": head["ms"], "plain_ms": head["plain_ms"],
                "bound_ms": head["bound_ms"], "bound_by": bound_by,
                "library_ms": head["library_ms"], "case": case,
                "ms_by_case": {k: c["ms"] for k, c in checks[pid].items()}}

    return [
        dict(entry("P1", "stream_probe", "stream_probe.cu",
                   pal + "3.py:53 (make_stream; stream_kernel :37)",
                   "s1MB_b1"),
             chain_ms_by_case={k: v["ms"]
                               for k, v in result["stream"].items()}),
        dict(entry("P2", "shape_stream", "stream_probe.cu",
                   pal + "9c.py:27 (stream; kernel :35)", "3d_16x640_G96"),
             chain_ms_by_case={k: v["ms"]
                               for k, v in result["shape"].items()
                               if "ms" in v}),
        dict(entry("P3", "bucket_variant", "bucket_variants.cu",
                   pal + "5.py:225 (launch; make_kernel :144)", "lr/base"),
             xgemm={kind: {key: checks["P3"][f"{kind}/xgemm"][key] for key in
                           ("ms", "bound_ms", "bound_by", "bytes_bound_ms",
                            "ops_bound_ms", "share_of_p1", "tf32_sigmas")}
                    for kind in ("lr", "dense")},
             chain_ms_by_case={f"{kind}/{k}": v["ms"]
                               for kind in ("lr", "dense")
                               for k, v in result["bucket"][kind].items()
                               if isinstance(v, dict)}),
        dict(entry("P4", "take_along_axis", "bucket_variants.cu",
                   pal + "5.py:288 (main; probe_kernel :301)", "probe"),
             device_ms=checks["P4"]["probe"]["device_ms"],
             library_device_ms=checks["P4"]["probe"]["library_device_ms"])]



def buckets_only(T, torch, args, device) -> int:
    """--k1-buckets-only: the k1_buckets phase alone on the operators of
    --bucket-operators, through nothing of the package but the product's
    wrapper and the builders, so that an older checkout runs it too (one
    that predates htool_python_torch/profiling/bounds.py, which holds
    `product_bound` and `p1_best_gbs`, with that file copied into it)."""
    from htool_python_torch.profiling.bounds import p1_best_gbs

    wanted = args.bucket_operators.split(",")
    unknown = set(wanted) - {"headline", "hlu", "helmholtz"}
    check(not unknown, f"unknown --bucket-operators {sorted(unknown)}")
    ops = {}
    if "headline" in wanted:
        ops["headline"] = main_path(T, torch, args.n, args.seed, device, {})
    if "hlu" in wanted:
        ops["hlu"] = second_kind_operator(
            T, torch, args.n_hlu, np.random.RandomState(11),
            0.5 * args.n_hlu, HLU_EPS, "N", "N", device)[0]
    if "helmholtz" in wanted:
        from htool_python_torch.models.geometry import \
            create_random_points_on_sphere
        from htool_python_torch.models.kernels import hermitian_phase_kernel

        points = create_random_points_on_sphere(args.n_helm,
                                                np.random.RandomState(1))
        helm = build_complex(T, torch, points, hermitian_phase_kernel(10.0),
                             "N", "N", device)[0]
        T.recompression(helm)
        ops["helmholtz"] = helm
    k1_buckets(torch, ops, p1_best_gbs(device))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=40000,
                    help="points of the main path (default: 40000)")
    ap.add_argument("--n-sym", type=int, default=8000,
                    help="points of the symmetric K1 check assemblies")
    ap.add_argument("--n-helm", type=int, default=100000,
                    help="points of the Helmholtz path (default: 100000)")
    ap.add_argument("--n-k2", type=int, default=8000,
                    help="points of the H and S K2 check assemblies")
    ap.add_argument("--n-dist", type=int, default=40000,
                    help="points of the distributed path (default: 40000)")
    ap.add_argument("--n-ddm", type=int, default=20000,
                    help="points of the DDM solve (default: 20000)")
    ap.add_argument("--n-hlu", type=int, default=32768,
                    help="points of the factorization (default: 32768)")
    ap.add_argument("--n-ddm-hier", type=int, default=16384,
                    help="points of the hierarchical-tier DDM solve "
                    "(default: 16384)")
    ap.add_argument("--n-sharded", type=int, default=40000,
                    help="points of the sharded phase (default: 40000)")
    ap.add_argument("--n-hooks", type=int, default=8000,
                    help="points of the custom-hooks phase (default: 8000)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--k1-buckets-only", action="store_true",
                    help="build the operators of --bucket-operators and run "
                    "the k1_buckets phase alone (it needs nothing of the "
                    "package but the product's wrapper, so it also times an "
                    "older checkout's K1 and K2); prints no ok line")
    ap.add_argument("--bucket-operators", default="headline,hlu",
                    help="operators of --k1-buckets-only, from headline, "
                    "hlu, helmholtz (K2: the Helmholtz path's operator "
                    "after recompression, complex x); default headline,hlu")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import htool_python_torch as T
    from htool_python_torch.models.geometry import (
        create_random_points_in_sphere, create_random_points_on_sphere)
    from htool_python_torch.models.kernels import hermitian_phase_kernel
    from htool_python_torch.ops import cuda_build
    from htool_python_torch.ops.cuda_matvec import (ALIGNED_NAME,
                                                    C128_C64_NAME, C128_NAME,
                                                    F64_F32_NAME, F64_NAME,
                                                    K2_NAME, KERNEL_NAME,
                                                    PERMUTE_IN_NAME,
                                                    PERMUTE_OUT_NAME,
                                                    launch_name)
    from htool_python_torch.ops.matvec import stored_bytes
    from htool_python_torch.profiling.bounds import (p1_best_gbs,
                                                     product_bound)

    device = torch.device("cuda")
    smi = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)
    t0 = time.perf_counter()
    built = cuda_build.build_all()
    emit("device", nvidia_smi=smi, device=name, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda,
         build_s=time.perf_counter() - t0, nvcc_s=built,
         ptxas={lib: [ln.strip() for ln in cuda_build.ptxas_report(lib)
                      .splitlines() if "registers" in ln or "spill" in ln]
                for lib in cuda_build.SOURCES},
         ptxas_xgemm=ptxas_by_kernel(
             cuda_build.ptxas_report("bucket_variants"), "xgemm_kernel"),
         ptxas_f64=ptxas_by_kernel(
             cuda_build.ptxas_report("hmatrix_product_f64"),
             "hmatrix_product_f64_kernel"),
         svd_check=svd_check(torch, device))

    if args.k1_buckets_only:
        return buckets_only(T, torch, args, device)
    native_cluster(T, torch, args.n, args.n_helm, args.seed)
    counts = {}
    hm = main_path(T, torch, args.n, args.seed, device, counts)
    check(counts.get(KERNEL_NAME, 0) > 0,
          "the main path never launched kernel K1")
    check(counts.get(PERMUTE_IN_NAME) == counts.get(PERMUTE_OUT_NAME)
          == counts[KERNEL_NAME],
          "the main path did not run one permute-in and one permute-out "
          "a product")
    perm_cases = permute_cases(torch, hm, (1, 128), args.seed)
    surface(T, torch, hm, args.n)
    example_counts = {}
    examples(torch, example_counts)

    prof_counts = {}
    prof = profiling(torch, device, prof_counts, smi)
    for pname in ("stream_probe", "shape_stream", "bucket_variant",
                  "take_along_axis"):
        check(prof_counts.get(pname, 0) > 0,
              f"the profiling path never launched {pname}")
    prof_checks = profiling_checks(torch, device)
    stream_gbs = max(v["GBs"] for v in prof["stream"].values())

    data = hm._product_data()
    nbytes = stored_bytes(data)
    copy_gbs = copy_rate_gbs(torch, device)
    timing = {}
    for k in (1, 8):
        ms = chain_ms(torch, hm, k, args.seed)
        bound, bound_by = product_bound(data, hm._pad_len, k)
        timing[k] = dict(product_ms=ms, effective_GBs=nbytes / ms / 1e6,
                         bound_ms=bound, bound_by=bound_by,
                         product_ms_table_per_call=chain_ms(
                             torch, hm, k, args.seed, prepared=False))
    SUMMARY.update({f"product_ms_k{k}": v["product_ms"]
                    for k, v in timing.items()})
    stream_events_gbs = p1_best_gbs(device)
    k1_buckets(torch, {"headline": hm}, stream_events_gbs)
    emit("product_time", card=smi, stored_bytes=int(nbytes), copy_GBs=copy_gbs,
         stream_GBs=stream_gbs,
         host_ms_per_call={"prepared_table": host_ms(torch, hm, True),
                           "table_per_call": host_ms(torch, hm, False)},
         product={f"k{k}": dict(v, fraction_of_copy_rate=v["effective_GBs"]
                                / copy_gbs,
                                fraction_of_stream_rate=v["effective_GBs"]
                                / stream_gbs) for k, v in timing.items()})
    sweep_counts = {}
    k1_sweeps(torch, hm, stream_events_gbs, sweep_counts)

    pts_sym = create_random_points_in_sphere(
        args.n_sym, np.random.RandomState(args.seed + 1))
    operators = {("N", "N"): hm}
    for sym in (("S", "L"), ("S", "U")):
        operators[sym] = build_operator(T, torch, pts_sym, *sym, device)[0]
    cases = kernel_cases(torch, operators, "k1_check", torch.float32,
                         ("N", "T"), ks=K1_KS)
    del operators
    cx_cases = kernel_cases(torch, {("N", "N"): hm}, "k1_complex_x",
                            torch.complex64, ("N", "C"), ks=(1, 4))
    pts_main = create_random_points_in_sphere(
        args.n, np.random.RandomState(args.seed))
    al_cases = k1al_cases(torch, {
        ("N", "N"): hm,
        ("S", "L"): build_operator(T, torch, pts_main, "S", "L", device)[0]},
        "headline")
    promoted_counts = {}
    promoted = f64_promoted(torch, hm, pts_main, args.seed,
                            promoted_counts)
    check(promoted_counts.get(F64_F32_NAME, 0) > 0,
          "the headline's float64 products never launched "
          "hmatrix_product_f64_from_f32")
    del hm, data
    torch.cuda.empty_cache()

    helm_counts = {}
    helm, helm_timing = helmholtz(T, torch, args.n_helm, args.seed, device,
                                  helm_counts, copy_gbs)
    check(helm_counts.get(K2_NAME, 0) > 0,
          "the Helmholtz path never launched kernel K2")
    perm_cases += permute_cases(torch, helm, (8,), args.seed)
    pts_k2 = create_random_points_on_sphere(
        args.n_k2, np.random.RandomState(args.seed + 2))
    c_ops = {("N", "N"): helm}
    for sym, kern in ((("H", "L"), hermitian_phase_kernel(10.0)),
                      (("H", "U"), hermitian_phase_kernel(10.0)),
                      (("S", "L"), symmetric_phase_kernel(torch))):
        c_ops[sym] = build_complex(T, torch, pts_k2, kern, *sym, device)[0]
    k2 = kernel_cases(torch, c_ops, "k2_check", torch.complex64,
                      ("N", "T", "C"), ks=K1_KS, reps=20, plain_reps=3,
                      other_ks=(1, 4, 8))
    SUMMARY.update({f"k2_ms_k{c['k']}": c["ms"] for c in k2
                    if c["mode"] == "fused" and c["storage"] == "N"
                    and c["trans"] == "N" and c["k"] in (1, 8)})
    emit("recompression_paths", operator=f"H-L, N={args.n_k2}",
         card=smi, **recompression_times(T, torch, c_ops[("H", "L")]))
    k1_buckets(torch, {"helmholtz": helm}, stream_events_gbs)
    promoted_helm_counts = {}
    promoted += f64_promoted(
        torch, helm, create_random_points_on_sphere(
            args.n_helm, np.random.RandomState(1)), args.seed,
        promoted_helm_counts)
    check(promoted_helm_counts.get(C128_C64_NAME, 0) > 0,
          "the Helmholtz path's complex128 products never launched "
          "hmatrix_product_complex128_from_c64")

    del helm, c_ops
    torch.cuda.empty_cache()

    dist_counts = {}
    row_cases = distributed(T, torch, args.n_dist, device, dist_counts)
    ddm_counts = {}
    row_cases += ddm(T, torch, args.n_ddm, device, ddm_counts)
    geneo_counts = {}
    geneo_k64 = ddm_geneo(T, torch, args.n_ddm, device, geneo_counts)

    hlu_counts = {}
    hm_lu, hm_lu_s = hlu(T, torch, args.n_hlu, device, hlu_counts)
    al_cases += k1al_cases(torch, {("N", "N"): hm_lu, ("S", "L"): hm_lu_s},
                           "hlu")
    k1_buckets(torch, {"hlu": hm_lu}, stream_events_gbs)
    compact_counts = {}
    surface_compact(torch, hm_lu, compact_counts)
    del hm_lu, hm_lu_s
    torch.cuda.empty_cache()
    hier_counts = {}
    row_cases += ddm_hier(T, torch, args.n_ddm_hier, device, hier_counts)
    check(hier_counts.get(KERNEL_NAME, 0) > 0,
          "the ddm_hier solve never launched kernel K1")

    f64_counts = {}
    f64_cases, c128_cases = f64_check(T, torch, args, device, f64_counts,
                                      promoted)
    check(f64_counts.get(F64_NAME, 0) > 0
          and f64_counts.get(C128_NAME, 0) > 0,
          "the f64 path never launched hmatrix_product_f64 or "
          "hmatrix_product_complex128")
    torch.cuda.empty_cache()
    sharded_counts = {}
    sharded_out = sharded(T, torch, args.n_sharded, device, sharded_counts)
    check(sharded_counts.get(f"float64/{F64_NAME}", 0) > 0
          and sharded_counts.get(f"float32/{KERNEL_NAME}", 0) > 0,
          "the sharded products never launched hmatrix_product_f64 or K1")
    hook_counts = {}
    custom_hooks(T, torch, args.n_hooks, args.seed, device, hook_counts)

    def block_row_err(mode):
        return max(c["max_abs_err"] for c in row_cases if c["mode"] == mode)

    def entry(name, mode, source, replaces, launches, case_list, timing_):
        mine = [c for c in case_list if c["mode"] == mode]
        head = next(c for c in mine if c["storage"] == "N"
                    and c["trans"] == "N" and c["k"] == 1)
        head8 = next(c for c in mine if c["storage"] == "N"
                     and c["trans"] == "N" and c["k"] == 8)
        return {"name": launch_name(name, mode), "route": "cuda",
                "source": source, "replaces": replaces, "launches": launches,
                "max_abs_err": max(c["max_abs_err"] for c in mine),
                "ms": head["ms"], "plain_ms": head["plain_ms"],
                "bound_ms": timing_[1]["bound_ms"],
                "bound_by": timing_[1]["bound_by"], "library_ms": None,
                "ms_k8": head8["ms"], "plain_ms_k8": head8["plain_ms"],
                "bound_ms_k8": timing_[8]["bound_ms"]}

    k1_src = "htool_python_torch/csrc/hmatrix_product.cu"  # K1 and K2
    pallas = "htool_python_tpu/ops/pallas_matvec.py:"
    kernels = [
        dict(entry(KERNEL_NAME, "fused", k1_src, pallas + "538",
                   counts[KERNEL_NAME], cases, timing),
             max_abs_err_complex_x=max(c["max_abs_err"] for c in cx_cases),
             max_abs_err_block_rows=block_row_err("fused"),
             launches_ddm_geneo=geneo_counts[KERNEL_NAME],
             ddm_block_rows_k64={key: geneo_k64[key] for key in
                                 ("ms", "bound_ms", "apply_ms")}),
        dict(entry(K2_NAME, "fused", k1_src, pallas + "571",
                   helm_counts[K2_NAME], k2, helm_timing),
             helmholtz_by_k={k: dict(ms=c["ms"], bound_ms=c["bound_ms"],
                                     bound_by=c["bound_by"])
                             for c in k2 if c["mode"] == "fused"
                             and c["storage"] == "N" and c["trans"] == "N"
                             for k in [c["k"]] if k in K1_TIMED_KS})]
    for mode, line in (("per_bucket", "522"), ("seq", "649")):
        # K1-pb / K1-seq on the DDM solve; K2's times in this structure
        # (complex64, the Helmholtz shapes) as extra fields
        e = entry(KERNEL_NAME, mode, k1_src, pallas + line,
                  ddm_counts[launch_name(KERNEL_NAME, mode)], cases, timing)
        c = entry(K2_NAME, mode, k1_src, pallas + line, 0, k2, helm_timing)
        e["max_abs_err"] = max(e["max_abs_err"], c["max_abs_err"])
        e["max_abs_err_block_rows"] = block_row_err(mode)
        e.update({f"complex64_{key}": c[key] for key in
                  ("ms", "ms_k8", "plain_ms", "plain_ms_k8", "bound_ms",
                   "bound_ms_k8", "max_abs_err")})
        kernels.append(e)

    def al_case(operator, k):
        return next(c for c in al_cases if c["operator"] == operator
                    and c["storage"] == "N" and c["trans"] == "N"
                    and c["k"] == k)

    def by_k(ms_key, operator=None):
        """{k: (ms, bound ms, bound_by)} of K1 (fused, headline, trans N,
        storage N) or of the aligned-layout cases of `operator`."""
        out = {}
        for k in K1_TIMED_KS:
            c = (al_case(operator, k) if operator else next(
                c for c in cases if c["mode"] == "fused"
                and c["storage"] == "N" and c["trans"] == "N"
                and c["k"] == k))
            out[k] = dict(ms=c[ms_key], bound_ms=c["bound_ms"],
                          bound_by=c["bound_by"])
        return out

    kernels[0]["headline_by_k"] = by_k("ms")

    head = al_case("hlu", 1)
    kernels.append({
        "name": ALIGNED_NAME, "route": "cuda", "source": k1_src,
        "replaces": pallas + "355-378 (_step_body kind 'alr'; _load_al :89, "
        "_accum_al :95)",
        "launches": hlu_counts[ALIGNED_NAME],
        "max_abs_err": max(c["max_abs_err"] for c in al_cases),
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": None,
        "operator": f"hlu, N={args.n_hlu}, storage N, trans N",
        "stored_bytes": head["stored_bytes"],
        "aligned_stored_bytes": head["aligned_stored_bytes"],
        **{f"{key}_k{k}": al_case("hlu", k)[key]
           for k in (8, 128) for key in ("ms", "plain_ms", "bound_ms")},
        **{f"k1_ms_k{k}": al_case("hlu", k)["k1_ms"] for k in (1, 8, 128)},
        **{f"headline_{key}_k{k}": al_case("headline", k)[key]
           for k in (1, 8, 128) for key in ("ms", "k1_ms")},
        "hlu_by_k": by_k("ms", "hlu"), "k1_hlu_by_k": by_k("k1_ms", "hlu"),
        "launches_surface_compact": compact_counts[ALIGNED_NAME]})
    SUMMARY.update({"k1_hlu_ms_k128": al_case("hlu", 128)["k1_ms"],
                    **{f"k1al_hlu_ms_k{k}": al_case("hlu", k)["ms"]
                       for k in (1, 8, 128)}})
    emit("versus_before", card=smi,
         before_origin="PERF.md: the previous product kernel's final run, "
         "H100 80GB HBM3, 700 W",
         **{key: {"now": SUMMARY.get(key), "before": v}
            for key, v in BEFORE.items()})
    kernels += profiling_entries(prof_counts, prof_checks, prof)
    f64_src = "htool_python_torch/csrc/hmatrix_product_f64.cu"
    for kern, case_list, launches in (
            (F64_NAME, f64_cases, f64_counts[F64_NAME]),
            (C128_NAME, c128_cases, f64_counts[C128_NAME])):
        def f64_case(k, cl=case_list):
            return next(c for c in cl if c["storage"] == "N"
                        and c["trans"] == "N" and c["k"] == k)
        kernels.append({
            "name": kern, "route": "cuda", "source": f64_src,
            "replaces": "none: XLA in htool_python_tpu/ops/matvec.py:100",
            "launches": launches,
            "max_abs_err": max(c["max_abs_err"] for c in case_list),
            "max_rel_err": max(c["max_rel_err"] for c in case_list),
            "ms": f64_case(1)["ms"], "plain_ms": f64_case(1)["plain_ms"],
            "bound_ms": f64_case(1)["bound_ms"],
            "bound_by": f64_case(1)["bound_by"], "library_ms": None,
            "bound_operations_rate": "FP64 tensor cores, 67 TFLOP/s",
            "operator": (f"headline in float64, N={args.n}" if kern == F64_NAME
                         else f"Helmholtz kernel in complex128, N={args.n_k2}"),
            **{f"{key}_k{k}": f64_case(k)[key] for k in F64_KS[1:]
               for key in ("ms", "plain_ms", "bound_ms")},
            **({"launches_sharded": sharded_counts[f"float64/{F64_NAME}"],
                "launches_sharded_gmres": sharded_counts.get(
                    f"gmres/{F64_NAME}", 0)} if kern == F64_NAME else {})})
    for kern, data_dt, x_dt, launches, operator in (
            (F64_F32_NAME, "float32", "float64",
             promoted_counts[F64_F32_NAME],
             f"headline in float32, N={args.n}, float64 x"),
            (C128_C64_NAME, "complex64", "complex128",
             promoted_helm_counts[C128_C64_NAME],
             f"Helmholtz path in complex64, N={args.n_helm}, complex128 x")):
        mine = [c for c in promoted if c["data"] == data_dt]

        def p_case(k, mine=mine, x_dt=x_dt):
            return next(c for c in mine if c["x"] == x_dt
                        and c["trans"] == "N" and c["k"] == k)
        kernels.append({
            "name": kern, "route": "cuda", "source": f64_src,
            "replaces": "none: XLA in htool_python_tpu/ops/matvec.py:100 "
            "(the operator promoted at :111)",
            "launches": launches,
            "max_abs_err": max(c["max_abs_err"] for c in mine),
            "max_rel_err": max(c["max_rel_err"] for c in mine),
            "ms": p_case(1)["ms"], "plain_ms": p_case(1)["plain_ms"],
            "bound_ms": p_case(1)["bound_ms"],
            "bound_by": p_case(1)["bound_by"], "library_ms": None,
            "bound_operations_rate": "FP64 tensor cores, 67 TFLOP/s",
            "operator": operator,
            **{f"{key}_k{k}": p_case(k)[key] for k in PROMOTED_KS[1:]
               for key in ("ms", "plain_ms", "bound_ms")}})
    for kern, pname in ((PERMUTE_IN_NAME, "permute_in"),
                        (PERMUTE_OUT_NAME, "permute_out")):
        mine = {f"k{c['k']}": c for c in perm_cases if c["kernel"] == pname}
        kernels.append({
            "name": kern, "route": "cuda", "source": k1_src,
            "replaces": "none: x2d[perm_in] and the zero pad (y_pad[:nout]"
            "[inv_perm_out]) inside the reference's jitted apply_hmatrix_user, "
            "htool_python_tpu/ops/matvec.py:374-380",
            "launches": counts[kern], "max_abs_err": 0.0 if all(
                c["bit_exact"] for c in mine.values()) else None,
            **{key: mine["k1"][key] for key in
               ("ms", "device_ms", "plain_ms", "bound_ms", "library_ms")},
            "bound_by": "bytes", "library": "torch.index_select",
            "by_case": {case: {key: c[key] for key in
                               ("n", "pad_len", "dtype", "ms", "device_ms",
                                "plain_ms", "bound_ms", "library_ms")}
                        for case, c in mine.items()}})
    kernels[0]["launches_sharded_float32"] = sharded_counts[
        f"float32/{KERNEL_NAME}"]
    kernels[0]["launches_custom_hooks"] = hook_counts[KERNEL_NAME]
    kernels[0]["launches_examples"] = example_counts[KERNEL_NAME]
    kernels[0]["launches_k1_sweeps"] = sweep_counts[KERNEL_NAME]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
