// Kernels P3 and P4 on Hopper: single-bucket variants of K1's body and the
// gather they use.
//
// P3 (`bv_launch`) replaces the TPU kernel `launch` of
// tools/profile_matvec5.py:225 (body `make_kernel` :144): one synthetic
// bucket of nb equal blocks in the reference's merged slab (nb, rows, W),
// W = max(pt, ps) -- low-rank ('lr'): rows [:r] hold Ut (r, pt) and rows
// [r:] hold V (r, ps), rows = 2r; dense: rows = pt hold D (pt, ps) --
// with offsets t_off, s_off into y and x (1, L), and
//     y[t:t+pt] += Ut^T (V x[s:s+ps])   or   y[t:t+pt] += D x[s:s+ps]
// computed by one of several bodies, so that K1's time splits into its
// parts.  Each choice is a template parameter:
//   gather: 'roll' stages each x segment in shared memory from aligned
//           16-byte loads around the unaligned s_off, shifted into place
//           (K1's staging; the TPU rolled a 128-lane window); 'take' reads
//           x[s_off + j] one value at a time through P4's `gather_at`,
//           with no window (into the dot products of 'vpu' and 'skip',
//           into the shared-memory operand of 'xgemm'); 'none' uses zeros;
//   term:   'vpu' is K1's block body on the CUDA cores, one CTA per block
//           (a warp per row of V or D, then a thread per output row);
//           'xgemm' is the reference's block-diagonal formulation over a
//           group of G blocks on the tensor cores: Wp = V_flat (G r, ps) @
//           X^T (ps, G), keep each block's own column (the diagonal
//           blocks), then w_bd (G, G r) @ Ut_flat (G r, pt) (dense: D_flat
//           (G pt, ps) @ X^T, keep the diagonal), every tile computed, in
//           TF32 mma.sync summing in f32; its own persistent kernel
//           (`xgemm_kernel`, below);
//           'skip' gives x's gathered values plus 1e-30 * sum(the group's
//           slab), one CTA per group;
//   accum:  'roll' adds each block's result into y at t_off with f32
//           atomicAdd (K1's); 'static' adds every block at offset 0 (on
//           the card, the same-address contention that K1's shared target
//           rows approach); 'skip' adds nothing.
// The probes 'static' and 'skip' give "wrong" products on purpose: the
// point is attribution.  With accum 'skip' nothing is stored, and the
// compiler would drop every load whose value is unused, so the results of
// each group of G blocks (of each block for 'vpu') are summed into its slot
// of `sink` (the TPU kernel's sum(slab) * 1e-30 kept the same dependence).
// Out-of-range segments read zeros (x outside [0, L)) and drop rows (y
// outside [0, L)), as the plain version does.
//
// P4 (`bv_take`) replaces the TPU probe of tools/profile_matvec5.py:288
// (`probe_kernel` :301): out[i, j] = x[i, idx[i, j]] over int32 indices,
// through `gather_at`; an index outside the row reads 0 and is counted in
// `fault`, which the wrapper reads and raises on after one call, or which
// the caller checks once after many (the timed form: no read, no sync per
// call).  Its time is launch latency.
//
// Plain PyTorch versions and wrappers: htool_python_torch/profiling/
// bucket_variants.py (`bucket_variant_plain`, `take_along_axis_plain`).
//
// What bounds them.  P3 reads each stored byte once (384 MiB in the
// reference's cases) and does 2 flops per entry for 'vpu': bytes / 3.35
// TB/s, 0.120 ms.  'xgemm' does G times the flops of 'vpu': 2 nb G r (ps +
// pt) for 'lr', 6.4 GFLOP in the reference's case (in f32 on the CUDA
// cores, 67 TFLOP/s, that alone would take 0.096 ms), 2 nb G pt ps for
// 'dense', 3.2 GFLOP; in TF32 on the tensor cores (495 TFLOP/s) 0.013 and
// 0.0065 ms, so it too is bound by its bytes.  P4 moves a few KiB: launch
// latency bounds it.
//
// The 'xgemm' kernel (`xgemm_kernel`).  Written to stream at the card's
// read rate with the tensor cores as a side cost:
//  * A persistent grid: one CTA per SM (the ring takes the SM's shared
//    memory), walking groups b, b + grid, ...; with accum 'skip' it writes
//    one sum per group into sink[group].
//  * A ring of TMA stages guarded by full / empty `mbarrier`s, one block's
//    slab a stage (32 KiB 'lr', 64 KiB 'dense' in the reference's cases; 4
//    and 3 stages): the producer warp's lane 0 issues one 2-D
//    `cp.async.bulk.tensor` per 32-column strip of the slab (8 'lr', 4
//    'dense') from a tensor map of the slabs (nb rows x W floats, boxes of
//    32 columns x the slab's rows) with the 128-byte swizzle: 16-byte chunk
//    q of row m lands at chunk q ^ (m % 8), so that the A fragments (8 rows
//    of one chunk) and Ut's B fragments hit 32 distinct banks.  A tensor
//    map, not one 1-D bulk copy per padded row (the first design): 128 row
//    copies of 512 bytes a dense block held the ring to 0.178 ms where one
//    copy a block streams at 0.134 (profiling/xgemm_variants.py, PERF.md).
//  * The group's G x segments are staged once per group (gather 'roll' or
//    'take', as 'vpu' stages them) by the 8 consumer warps, rounded to TF32
//    there, into padded rows (max(ps, pt) + 4 floats: 4 mod 8, so X's
//    fragments hit distinct banks too), while the producer keeps the ring
//    filling.
//  * Consumers run mma.sync.m16n8k8 TF32 from shared memory, each operand
//    rounded once (to nearest, as cvt.rna), summing in f32.  'lr', block g
//    of the group: the r x G tile V_g X^T with the warps splitting the k8
//    steps (warp w takes steps w, w + 8, ...; V_g and X each read once), the
//    kept column g read from the accumulator registers by the m16n8 layout
//    (lanes t == (g % 8) / 2) into a per-warp partial in shared memory;
//    after one barrier of the consumers, out (G x pt) += w_bd_g (G x r)
//    Ut_g, the block's k-chunk of the second GEMM computed in full with A
//    formed in registers (row g = the sum of the 8 partials, the other rows
//    0; a k8 step takes w's and Ut's rows k0 + 2t, k0 + 2t + 1 for its
//    logical columns t, t + 4, so that w is one float2 and Ut's swizzled
//    rows hit distinct banks) and out kept in registers across the group
//    (each warp holds its n8 tiles warp + 8 j over all G rows; G <= 32 and
//    pt <= 256). At the group's end out goes through X into y, so that each
//    atomic instruction adds 32 consecutive floats of one row (one f32
//    atomic per block output row, as 'base'): the accumulator layout's own
//    atomics (8 rows an instruction) took 0.08 ms more.  'dense', block g:
//    D_g X^T over all of k, a warp per m16 tile of rows (D_g read once), the
//    kept column added into y at once, one atomic per row.
//  * The consumers set their fragments' addresses once per block (the
//    swizzle reduces to a per-lane XOR), and round to TF32 by an integer
//    add and mask rather than cvt.rna (the same result for finite values):
//    'lr' 0.246 -> 0.203 and 0.205 -> 0.188 ms (profiling/xgemm_variants.py,
//    PERF.md).  What still holds 'lr' is that instruction stream: with no
//    arithmetic the ring streams at 0.146 ms, issuing every mma twice adds
//    0.035, and each GEMM of a 32 KiB block takes a warp about 1 500
//    cycles, near the 1.6 us the block takes to stream.
//  * Registers and spills (nvcc -Xptxas -v, sm_90a, CUDA 12.8): the 18
//    instantiations of `xgemm_kernel` (kind x gather x accum) use 108-110
//    registers ('lr': out's 32 floats a thread) and 77-100 ('dense'), no
//    spills, no stack frame; the 288-thread CTA may have up to 224.  Shared
//    memory, set at launch: 'lr' 4 stages of 32 768 bytes and X 33 280
//    (166 560 in all), 'dense' 3 stages of 65 536 and X 8 448 (206 240): one
//    CTA per SM.  chip_smoke.py's `device` phase prints the report
//    (`ptxas_xgemm`).
//
// Tolerances.  'vpu' and 'skip' agree with the plain version to f32
// summation round-off (1e-5 relative; the atomics add in a varying
// order); with accum 'skip' the sums in `sink` are checked
// instead of y.  'xgemm' rounds both operands of each product to TF32
// (unit round-off u = 2^-11) in both GEMMs: V, x, then w = V x and Ut
// (dense: D and x).  The worst case, a few u times sum |terms|, exceeds
// |y| itself once thousands of blocks add into one row, so chip_smoke.py
// and the tests hold 'xgemm' to 1e-5 of max |y| plus 8 standard
// deviations of the rounding error, elementwise
// (profiling/bucket_variants.py `kernel_tolerance`, `tf32_error_std`).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libbucket_variants.so bucket_variants.cu
// (done at first use by htool_python_torch/ops/cuda_build.py).

#include <cuda.h>  // CUtensorMap (the driver itself is reached through the runtime)
#include <cuda_runtime.h>

#include <cstdint>

namespace {

enum { kLr = 0, kDense = 1 };                       // kind
enum { kGatherRoll = 0, kGatherTake = 1, kGatherNone = 2 };
enum { kVpu = 0, kXgemm = 1, kTermSkip = 2 };       // term
enum { kAccRoll = 0, kAccStatic = 1, kAccSkip = 2 };  // accum

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct Case {
    const float* slabs;  // (nb, rows, W)
    const int* t_off;    // (nb,)
    const int* s_off;    // (nb,)
    const float* x;      // (L,), 16-byte aligned
    float* y;            // (L,), zeroed
    float* sink;         // accum 'skip': one float per block ('vpu') or group
    int L, nb, G, r, pt, ps, rows, W;
};

// P4's device gather: row[i] for 0 <= i < n, else 0, counted in *fault
// when fault is given.
__device__ __forceinline__ float gather_at(const float* __restrict__ row, int n, int i,
                                           int* fault) {
    if (i >= 0 && i < n) return __ldg(row + i);
    if (fault) atomicAdd(fault, 1);
    return 0.0f;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

// Sum of v over the CTA; every thread gets it.
__device__ float block_sum(float v) {
    __shared__ float sh[kWarps];
    v = warp_sum(v);
    if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = v;
    __syncthreads();
    float total = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += sh[w];
    __syncthreads();
    return total;
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
    return fmaf(a.x, b.x, fmaf(a.y, b.y, fmaf(a.z, b.z, fmaf(a.w, b.w, acc))));
}

// x4[q] (floats 4q .. 4q+3 of x), zeros outside x (L a multiple of 4).
__device__ __forceinline__ float4 load4(const float4* __restrict__ x4, int L, int q) {
    return (q >= 0 && q < L / 4) ? __ldg(x4 + q) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// Floats sh .. sh+3 of the 8 in (a, b).
__device__ __forceinline__ float4 shift4(float4 a, float4 b, int sh) {
    switch (sh) {
        case 0: return a;
        case 1: return make_float4(a.y, a.z, a.w, b.x);
        case 2: return make_float4(a.z, a.w, b.x, b.y);
        default: return make_float4(a.w, b.x, b.y, b.z);
    }
}

// Four consecutive x values from s on, as the gather reads them.
template <int GATHER>
__device__ __forceinline__ float4 x_quad(const Case& c, int s) {
    if constexpr (GATHER == kGatherTake) {
        return make_float4(gather_at(c.x, c.L, s, nullptr), gather_at(c.x, c.L, s + 1, nullptr),
                           gather_at(c.x, c.L, s + 2, nullptr), gather_at(c.x, c.L, s + 3, nullptr));
    } else if constexpr (GATHER == kGatherRoll) {
        // the two aligned float4 around x[s], shifted into place
        const float4* x4 = reinterpret_cast<const float4*>(c.x);
        const int q = s >> 2;  // floor(s / 4)
        return shift4(load4(x4, c.L, q), load4(x4, c.L, q + 1), s & 3);
    } else {
        return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
}

// v rounded to TF32 (10 stored mantissa bits, to nearest, ties away from
// zero), as the tensor cores take it: the bits of a float.  For finite v
// this is cvt.rna.tf32.f32 done by an integer add and mask, which the
// consumers issue faster (profiling/xgemm_variants.py, PERF.md).
__device__ __forceinline__ uint32_t tf32(float v) {
    return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// dst[g*stride + j] = x[s_off[first + g] + j] for g < n_seg, j < width
// (stride and width multiples of 4), rounded to TF32 with ROUND; threads 0
// .. kThreads - 1 take part.
template <int GATHER, bool ROUND = false>
__device__ void stage_segments(float* dst, const Case& c, long long first, int n_seg,
                               int width, int stride) {
    const int w4 = width / 4;
#pragma unroll 4
    for (int e = threadIdx.x; e < n_seg * w4; e += kThreads) {
        const int g = e / w4, q = e - g * w4;
        float4 v = x_quad<GATHER>(c, c.s_off[first + g] + 4 * q);
        if constexpr (ROUND)
            v = make_float4(__uint_as_float(tf32(v.x)), __uint_as_float(tf32(v.y)),
                            __uint_as_float(tf32(v.z)), __uint_as_float(tf32(v.w)));
        reinterpret_cast<float4*>(dst + g * stride)[q] = v;
    }
}

template <int ACCUM>
__device__ __forceinline__ void accum(const Case& c, int t, int j, float v, float& dep) {
    if constexpr (ACCUM == kAccRoll) {
        const int row = t + j;
        if (row >= 0 && row < c.L) atomicAdd(c.y + row, v);
    } else if constexpr (ACCUM == kAccStatic) {
        atomicAdd(c.y + j, v);
    } else {
        dep += v;
    }
}

// term 'vpu': block i, one CTA.  'roll' stages the x segment in shared
// memory (ps floats) first; 'take' and 'none' read it in the dot products.
template <int KIND, int GATHER, int ACCUM>
__device__ void vpu_block(const Case& c, long long i, float* smem, float& dep) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int ps4 = c.ps / 4, W = c.W;
    const float* slab = c.slabs + i * c.rows * (long long)W;
    const int s = c.s_off[i], t = c.t_off[i];
    float* xs = smem;  // roll: (ps,)
    if constexpr (GATHER == kGatherRoll) {
        stage_segments<kGatherRoll>(xs, c, i, 1, c.ps, c.ps);
        __syncthreads();
    }
    auto xq = [&](int q) -> float4 {
        if constexpr (GATHER == kGatherRoll) return reinterpret_cast<const float4*>(xs)[q];
        else return x_quad<GATHER>(c, s + 4 * q);
    };
    if constexpr (KIND == kLr) {
        float* ws = smem + (GATHER == kGatherRoll ? c.ps : 0);  // (r,)
        const float* V = slab + (long long)c.r * W;
        for (int rr = warp; rr < c.r; rr += kWarps) {  // w = V x_seg, a warp per row
            const float4* v4 = reinterpret_cast<const float4*>(V + (long long)rr * W);
            float acc = 0.0f;
            for (int q = lane; q < ps4; q += 32) acc = dot4(__ldg(v4 + q), xq(q), acc);
            acc = warp_sum(acc);
            if (lane == 0) ws[rr] = acc;
        }
        __syncthreads();
        for (int j = threadIdx.x; j < c.pt; j += kThreads) {  // Ut^T w, a thread per row
            float o = 0.0f;
            for (int rr = 0; rr < c.r; ++rr) o = fmaf(__ldg(slab + (long long)rr * W + j), ws[rr], o);
            accum<ACCUM>(c, t, j, o, dep);
        }
    } else {
        for (int j = warp; j < c.pt; j += kWarps) {  // D x_seg, a warp per row
            const float4* d4 = reinterpret_cast<const float4*>(slab + (long long)j * W);
            float acc = 0.0f;
            for (int q = lane; q < ps4; q += 32) acc = dot4(__ldg(d4 + q), xq(q), acc);
            acc = warp_sum(acc);
            if (lane == 0) accum<ACCUM>(c, t, j, acc, dep);
        }
    }
}

// term 'skip': group grp of G blocks, one CTA: out[g, j] = x_seg_g[j] +
// 1e-30 * sum(the group's slab), j < pt.
template <int GATHER, int ACCUM>
__device__ void skip_group(const Case& c, long long grp, float* smem, float& dep) {
    const int G = c.G, pt = c.pt;
    const long long first = grp * G;
    const long long n4 = (long long)G * c.rows * c.W / 4;
    const float4* s4 = reinterpret_cast<const float4*>(c.slabs + first * c.rows * (long long)c.W);
    float s = 0.0f;
    for (long long e = threadIdx.x; e < n4; e += kThreads) {
        const float4 v = __ldg(s4 + e);
        s += (v.x + v.y) + (v.z + v.w);
    }
    const float tiny = block_sum(s) * 1e-30f;
    if constexpr (GATHER == kGatherRoll) {
        stage_segments<kGatherRoll>(smem, c, first, G, c.ps, c.ps);
        __syncthreads();
    }
    for (int e = threadIdx.x; e < G * pt; e += kThreads) {
        const int g = e / pt, j = e - g * pt;
        float v = 0.0f;
        if constexpr (GATHER == kGatherRoll) v = smem[g * c.ps + j];
        else if constexpr (GATHER == kGatherTake) v = gather_at(c.x, c.L, c.s_off[first + g] + j, nullptr);
        accum<ACCUM>(c, c.t_off[first + g], j, v + tiny, dep);
    }
}

// ---- term 'xgemm': a persistent kernel on a bulk-copy ring ----------------

constexpr int kXWarps = kWarps;               // consumer warps (8)
constexpr int kXThreads = kThreads + 32;      // + the producer warp
constexpr int kXMaxStages = 4;                // more are no faster (xgemm_variants)
constexpr int kXMaxG = 32;                    // 'lr': out's two m16 tiles of blocks
constexpr int kXOutTiles = 4;                 // 'lr': out's n8 tiles a warp: pt <= 256
constexpr int kXStrip = 32;                   // floats of a box row: 128 bytes, one swizzle span
constexpr int kXMaxRows = 256;                // rows of a TMA box
constexpr int kXHeadBytes = 128 + 1024;       // the barriers, and the ring's 1024-byte alignment

// The layout of one launch: the row stride (floats) of X, the staged x
// segments; the 32-column strips of a slab that a stage holds; a stage's
// floats; the stage count.
struct XPlan {
    int sx, strips, stage_floats, stages;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    const uint32_t addr = smem_addr(bar);
    uint32_t done = 0;
    do {
        asm volatile("{\n .reg .pred p;\n"
                     " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                     " selp.u32 %0, 1, 0, p;\n}\n"
                     : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                 :: "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// The box of `map` at (column x, row y) into dst, 128-byte swizzled.
__device__ __forceinline__ void tma_load_2d(float* dst, const CUtensorMap* map, int x, int y,
                                            uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%2, %3}], [%4];\n"
        :: "r"(smem_addr(dst)), "l"(map), "r"(x), "r"(y), "r"(smem_addr(bar))
        : "memory");
}

// A barrier of the consumer warps alone (the producer never waits on it).
__device__ __forceinline__ void consumer_sync() {
    asm volatile("bar.sync 1, %0;\n" :: "n"(kThreads) : "memory");
}

// Sum of v over the consumer warps; every consumer thread gets it.
__device__ float consumer_sum(float v, float* red) {
    v = warp_sum(v);
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
    consumer_sync();
    float total = 0.0f;
#pragma unroll
    for (int w = 0; w < kXWarps; ++w) total += red[w];
    consumer_sync();
    return total;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A stage's layout: the slab lands as strips of 32 columns, each `rows`
// rows of 128 bytes, and the TMA's 128-byte swizzle puts 16-byte chunk q of
// a row at chunk q ^ (row % 8): slab element (row, col) is at float
//     ((col / 32) rows + row) 32 + (((col / 4) % 8 ^ row % 8) 4) + col % 4.
// The consumers set their fragments' addresses from it once per block.

// The producer warp: every block of the CTA's groups into the ring, one
// TMA box (32 columns x the slab's rows) per strip.
__device__ void xgemm_produce(const Case& c, const XPlan& p, const CUtensorMap* map,
                              float* ring, uint64_t* full, uint64_t* empty,
                              long long n_groups, int lane) {
    const uint32_t bytes = (uint32_t)p.strips * kXStrip * c.rows * 4;
    int stage = 0;
    uint32_t parity = 0;
    for (long long grp = blockIdx.x; grp < n_groups; grp += gridDim.x) {
        for (int g = 0; g < c.G; ++g) {
            mbar_wait(empty + stage, parity ^ 1);
            if (lane == 0) {
                float* S = ring + (long long)stage * p.stage_floats;
                const int row0 = (int)((grp * c.G + g) * c.rows);
                mbar_arrive_expect_tx(full + stage, bytes);
                for (int s = 0; s < p.strips; ++s)
                    tma_load_2d(S + s * kXStrip * c.rows, map, s * kXStrip, row0, full + stage);
            }
            __syncwarp();
            if (++stage == p.stages) { stage = 0; parity ^= 1; }
        }
    }
}

// Column g (< G) of the accumulator tiles acc[j] (n8 tile nc + j): lanes
// with t == (g % 8) / 2 hold it, rows g4 (v0) and g4 + 8 (v1) of the m16
// tile.  Returns whether this lane holds it.
__device__ __forceinline__ bool kept_column(const float (&acc)[4][4], int g, int nc, int tq,
                                            float& v0, float& v1) {
    const int j = (g >> 3) - nc;
    if (j < 0 || j >= 4 || tq != (g & 7) >> 1) return false;
    const bool odd = g & 1;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
        if (jj == j) {
            v0 = odd ? acc[jj][1] : acc[jj][0];
            v1 = odd ? acc[jj][3] : acc[jj][2];
        }
    }
    return true;
}

// The first GEMM of 'lr' for block g: P (r x G) = V (slab rows r .. 2r - 1
// of stage S, ps columns) X^T over this warp's k8 steps k0 = 8 warp + 64 i,
// every tile computed; the kept column g, this warp's partial of w = V
// x_seg_g, into wp (r floats).  X holds TF32 values already.  The
// fragments' addresses are set once: step i lies in strip warp / 4 + 2 i
// of the slab, its columns k0 + t in 16-byte chunk 2 warp % 8 and k0 + t +
// 4 in the next, each at chunk ^ g4 (V's rows m0, m0 + 8 are g4 mod 8).
__device__ void lr_partial(const float* S, int rows, const float* X, int sx, int r, int G,
                           int ps, int g, int warp, int lane, float* wp) {
    const int g4 = lane >> 2, tq = lane & 3, NT = G / 8;
    const int c0 = (2 * warp) & 7, step = 2 * rows * kXStrip;
    for (int mt = 0; mt < r / 16; ++mt) {
        const float* A = S + ((warp >> 2) * rows + r + mt * 16 + g4) * kXStrip + tq;
        const int o0 = (c0 ^ g4) << 2, o1 = ((c0 + 1) ^ g4) << 2;
        for (int nc = 0; nc < NT; nc += 4) {
            float acc[4][4] = {};
            const float* a = A;
            const float* B = X + (nc * 8 + g4) * sx + 8 * warp + tq;
#pragma unroll 4
            for (int k0 = 8 * warp; k0 < ps; k0 += 8 * kXWarps, a += step, B += 8 * kXWarps) {
                const uint32_t f[4] = {tf32(a[o0]), tf32(a[o0 + 8 * kXStrip]), tf32(a[o1]),
                                       tf32(a[o1 + 8 * kXStrip])};
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    if (nc + j >= NT) break;
                    mma_tf32(acc[j], f, __float_as_uint(B[j * 8 * sx]),
                             __float_as_uint(B[j * 8 * sx + 4]));
                }
            }
            float v0, v1;
            if (kept_column(acc, g, nc, tq, v0, v1)) {
                wp[mt * 16 + g4] = v0;
                wp[mt * 16 + g4 + 8] = v1;
            }
        }
    }
}

// The second GEMM's k-chunk of 'lr' for block g: out (G x pt) += w_bd_g (G
// x r) Ut (slab rows 0 .. r - 1 of stage S), A formed in registers (row g:
// w, the sum of the warps' partials in wpart (kXWarps x r); every other row
// 0), out the warp's n8 tiles warp + 8 j over all G rows.  A k8 step takes
// its logical columns t and t + 4 from w's (and Ut's rows) k0 + 2t and k0 +
// 2t + 1, so that a lane reads w as one float2 and Ut's swizzled rows on 32
// distinct banks.  The fragments' addresses are set once: tile j's columns
// 8 (warp + 8 j) + g4 lie in strip warp / 4 + 2 j, chunk (2 warp + g4 / 4)
// % 8, at chunk ^ (row % 8) in rows 2t and 2t + 1 (mod 8).
__device__ void lr_update(const float* S, int rows, const float* wpart, int r, int G, int pt,
                          int g, int warp, int lane, float (&out)[2][kXOutTiles][4]) {
    const int g4 = lane >> 2, tq = lane & 3, MT = G / 16, NT = pt / 8;
    const int cn = (2 * warp + (g4 >> 2)) & 7, jstep = 2 * rows * kXStrip;
    const float* U0 = S + ((warp >> 2) * rows + 2 * tq) * kXStrip + ((cn ^ (2 * tq)) << 2)
                      + (g4 & 3);
    const float* U1 = S + ((warp >> 2) * rows + 2 * tq + 1) * kXStrip
                      + ((cn ^ (2 * tq + 1)) << 2) + (g4 & 3);
    const float* W = wpart + 2 * tq;
    for (int k0 = 0; k0 < r; k0 += 8, U0 += 8 * kXStrip, U1 += 8 * kXStrip, W += 8) {
        float w0 = 0.0f, w1 = 0.0f;
#pragma unroll
        for (int q = 0; q < kXWarps; ++q) {
            const float2 v = *reinterpret_cast<const float2*>(W + q * r);
            w0 += v.x;
            w1 += v.y;
        }
        const uint32_t t0 = tf32(w0), t1 = tf32(w1);
        uint32_t a[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
            const int row = mt * 16 + g4;
            a[mt][0] = row == g ? t0 : 0u;
            a[mt][1] = row + 8 == g ? t0 : 0u;
            a[mt][2] = row == g ? t1 : 0u;
            a[mt][3] = row + 8 == g ? t1 : 0u;
        }
#pragma unroll
        for (int j = 0; j < kXOutTiles; ++j) {
            if (warp + kXWarps * j >= NT) break;
            const uint32_t b0 = tf32(U0[j * jstep]), b1 = tf32(U1[j * jstep]);
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
                if (mt < MT) mma_tf32(out[mt][j], a[mt], b0, b1);
        }
    }
}

// 'dense', block g at y offset t: D (slab rows 0 .. pt - 1 of stage S, ps
// columns) X^T over all of k, a warp per m16 tile of rows, every tile
// computed; the kept column g into y.  X holds TF32 values already.  A
// strip's four k8 steps q take chunks 2q and 2q + 1 of rows that are g4
// mod 8, at chunk ^ g4.
template <int ACCUM>
__device__ void dense_block(const Case& c, const float* S, const float* X, int sx, int g,
                            int t, int warp, int lane, float& dep) {
    const int g4 = lane >> 2, tq = lane & 3, NT = c.G / 8, rows = c.rows;
    int o[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) o[q] = (q ^ g4) << 2;
    for (int mt = warp; mt < c.pt / 16; mt += kXWarps) {
        const int m0 = mt * 16 + g4;
        for (int nc = 0; nc < NT; nc += 4) {
            float acc[4][4] = {};
            const float* a = S + m0 * kXStrip + tq;
            const float* B = X + (nc * 8 + g4) * sx + tq;
            for (int k0 = 0; k0 < c.ps; k0 += kXStrip, a += rows * kXStrip, B += kXStrip) {
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    if (k0 + 8 * q >= c.ps) break;
                    const uint32_t f[4] = {tf32(a[o[2 * q]]), tf32(a[o[2 * q] + 8 * kXStrip]),
                                           tf32(a[o[2 * q + 1]]),
                                           tf32(a[o[2 * q + 1] + 8 * kXStrip])};
#pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        if (nc + j >= NT) break;
                        mma_tf32(acc[j], f, __float_as_uint(B[j * 8 * sx + 8 * q]),
                                 __float_as_uint(B[j * 8 * sx + 8 * q + 4]));
                    }
                }
            }
            float v0, v1;
            if (kept_column(acc, g, nc, tq, v0, v1)) {
                accum<ACCUM>(c, t, m0, v0, dep);
                accum<ACCUM>(c, t, m0 + 8, v1, dep);
            }
        }
    }
}

// Term 'xgemm'.  Shared memory: the barriers; from the next 1024-byte
// boundary the ring (p.stages stages of p.stage_floats); X (G rows of
// stride sx); for 'lr' two buffers of the warps' partials of w (kXWarps x r
// each, by block parity); kXWarps floats for the per-group sums of accum
// 'skip'.  `map` is the slabs as a 2-D tensor (nb rows x W columns).
template <int KIND, int GATHER, int ACCUM>
__global__ void __launch_bounds__(kXThreads, 1)
xgemm_kernel(Case c, XPlan p, const __grid_constant__ CUtensorMap map) {
    extern __shared__ __align__(128) float xsmem[];
    uint64_t* full = reinterpret_cast<uint64_t*>(xsmem);
    uint64_t* empty = full + kXMaxStages;
    // the 128-byte swizzle repeats every 1024 bytes of shared address
    const uint32_t head = 128 + ((1024 - ((smem_addr(xsmem) + 128) & 1023)) & 1023);
    float* ring = xsmem + head / 4;
    float* X = ring + (long long)p.stages * p.stage_floats;
    float* wpart = X + c.G * p.sx;
    float* red = wpart + (KIND == kLr ? 2 * kXWarps * c.r : 0);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const long long n_groups = c.nb / c.G;
    if (threadIdx.x == 0) {
        for (int q = 0; q < p.stages; ++q) {
            mbar_init(full + q, 1);  // the producer's expect_tx arrival
            mbar_init(empty + q, kXWarps);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (warp == kXWarps) {
        xgemm_produce(c, p, &map, ring, full, empty, n_groups, lane);
        return;
    }
    int stage = 0;
    uint32_t parity = 0;
    for (long long grp = blockIdx.x; grp < n_groups; grp += gridDim.x) {
        const long long first = grp * c.G;
        float dep = 0.0f;
        consumer_sync();  // every warp is done with the previous group's X
        stage_segments<GATHER, true>(X, c, first, c.G, c.ps, p.sx);
        consumer_sync();
        if constexpr (KIND == kLr) {
            float out[2][kXOutTiles][4] = {};
            for (int g = 0; g < c.G; ++g) {
                mbar_wait(full + stage, parity);
                const float* S = ring + (long long)stage * p.stage_floats;
                float* wp = wpart + (g & 1) * kXWarps * c.r;
                lr_partial(S, c.rows, X, p.sx, c.r, c.G, c.ps, g, warp, lane, wp + warp * c.r);
                consumer_sync();  // the partials are in
                lr_update(S, c.rows, wp, c.r, c.G, c.pt, g, warp, lane, out);
                __syncwarp();
                if (lane == 0) mbar_arrive(empty + stage);
                if (++stage == p.stages) { stage = 0; parity ^= 1; }
            }
            // out row b is block b's result.  It goes into y through X (free
            // once the last block's partials are in), so that each atomic
            // instruction adds 32 consecutive floats of one row, as 'base'
            // does; one f32 atomic per output row
            const int g4 = lane >> 2, tq = lane & 3;
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
                if (mt * 16 >= c.G) break;
#pragma unroll
                for (int j = 0; j < kXOutTiles; ++j) {
                    const int nt = warp + kXWarps * j;
                    if (nt >= c.pt / 8) break;
                    float* o = X + (mt * 16 + g4) * p.sx + nt * 8 + 2 * tq;
                    *reinterpret_cast<float2*>(o) = make_float2(out[mt][j][0], out[mt][j][1]);
                    *reinterpret_cast<float2*>(o + 8 * p.sx) =
                        make_float2(out[mt][j][2], out[mt][j][3]);
                }
            }
            consumer_sync();
            for (int b = warp; b < c.G; b += kXWarps) {
                const int t = __ldg(c.t_off + first + b);
                for (int col = lane; col < c.pt; col += 32)
                    accum<ACCUM>(c, t, col, X[b * p.sx + col], dep);
            }
        } else {
            for (int g = 0; g < c.G; ++g) {
                mbar_wait(full + stage, parity);
                const float* S = ring + (long long)stage * p.stage_floats;
                dense_block<ACCUM>(c, S, X, p.sx, g, __ldg(c.t_off + first + g), warp, lane,
                                   dep);
                __syncwarp();
                if (lane == 0) mbar_arrive(empty + stage);
                if (++stage == p.stages) { stage = 0; parity ^= 1; }
            }
        }
        if constexpr (ACCUM == kAccSkip) {
            const float total = consumer_sum(dep, red);
            if (threadIdx.x == 0) c.sink[grp] = total;
        }
    }
}

// cuTensorMapEncodeTiled of the driver, found through the runtime (nothing
// links against the driver library).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The slabs as a 2-D tensor of nb rows x W floats, boxes of 32 columns x
// the slab's rows, 128-byte swizzled; the last one is kept, since a
// profiling chain launches on the same slabs again and again.
cudaError_t slab_map(const Case& c, CUtensorMap* out) {
    static EncodeTiled encode = nullptr;
    static CUtensorMap kept;
    static const void* kept_ptr = nullptr;
    static long long kept_rows = -1;
    static int kept_W = -1, kept_box = -1;
    const long long n_rows = (long long)c.nb * c.rows;
    if (c.slabs == kept_ptr && n_rows == kept_rows && c.W == kept_W && c.rows == kept_box) {
        *out = kept;
        return cudaSuccess;
    }
    if (encode == nullptr) {
        void* fn = nullptr;
        cudaDriverEntryPointQueryResult found;
        const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                                      cudaEnableDefault, &found);
        if (e != cudaSuccess) return e;
        if (found != cudaDriverEntryPointSuccess || fn == nullptr) return cudaErrorNotSupported;
        encode = reinterpret_cast<EncodeTiled>(fn);
    }
    const cuuint64_t dims[2] = {(cuuint64_t)c.W, (cuuint64_t)n_rows};
    const cuuint64_t strides[1] = {(cuuint64_t)c.W * 4};
    const cuuint32_t box[2] = {kXStrip, (cuuint32_t)c.rows};
    const cuuint32_t steps[2] = {1, 1};
    if (encode(&kept, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(c.slabs), dims,
               strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE)
        != CUDA_SUCCESS) {
        kept_ptr = nullptr;
        return cudaErrorInvalidValue;
    }
    kept_ptr = c.slabs;
    kept_rows = n_rows;
    kept_W = c.W;
    kept_box = c.rows;
    *out = kept;
    return cudaSuccess;
}

// The layout and grid of a launch of 'xgemm': the stages that fit the
// card's opt-in shared memory (at most kXMaxStages), one CTA per SM or as
// many as fit, no more than the groups.  Shapes outside the kernel's
// registers (G > kXMaxG; 'lr' with pt > 256), slabs of more rows than a
// TMA box takes (256), and shapes with fewer than two stages are refused
// (cudaErrorInvalidConfiguration).  The grid is worked out once per
// (instantiation, device, shared memory) and kept.
template <int KIND, int GATHER, int ACCUM>
cudaError_t launch_xgemm(const Case& c, cudaStream_t st) {
    if (c.G > kXMaxG || (KIND == kLr && c.pt > 8 * kXWarps * kXOutTiles)
        || c.rows > kXMaxRows)
        return cudaErrorInvalidConfiguration;
    auto kernel = xgemm_kernel<KIND, GATHER, ACCUM>;
    int device = 0, optin = 0;
    cudaError_t e = cudaGetDevice(&device);
    if (e != cudaSuccess) return e;
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (e != cudaSuccess) return e;
    XPlan p;
    // 4 mod 8 (ps, pt multiples of 8): X's fragments on distinct banks; X
    // holds 'lr''s out (G x pt) at the group's end
    p.sx = (c.ps > c.pt ? c.ps : c.pt) + 4;
    const int cols = KIND == kLr ? c.W : c.ps;  // the slab columns used
    p.strips = (cols + kXStrip - 1) / kXStrip;
    p.stage_floats = p.strips * kXStrip * c.rows;  // rows a multiple of 8: 1024-byte stages
    const size_t fixed = kXHeadBytes
        + ((size_t)c.G * p.sx + (KIND == kLr ? 2 * kXWarps * c.r : 0) + kXWarps) * 4;
    const size_t per_stage = (size_t)p.stage_floats * 4;
    if ((size_t)optin < fixed + 2 * per_stage) return cudaErrorInvalidConfiguration;
    p.stages = (int)((optin - fixed) / per_stage);
    if (p.stages > kXMaxStages) p.stages = kXMaxStages;
    const size_t smem = fixed + p.stages * per_stage;
    static int cached_device = -1, cached_grid = 0;
    static size_t cached_smem = 0;
    if (device != cached_device || smem != cached_smem) {
        e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return e;
        int sms = 0, per_sm = 0;
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
        if (e != cudaSuccess) return e;
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kXThreads, smem);
        if (e != cudaSuccess) return e;
        if (per_sm < 1) return cudaErrorInvalidConfiguration;
        cached_device = device;
        cached_smem = smem;
        cached_grid = sms * per_sm;
    }
    CUtensorMap map;
    e = slab_map(c, &map);
    if (e != cudaSuccess) return e;
    const long long n_groups = c.nb / c.G;
    const unsigned grid = (unsigned)(n_groups < cached_grid ? n_groups : cached_grid);
    kernel<<<grid, kXThreads, smem, st>>>(c, p, map);
    return cudaGetLastError();
}

template <int KIND, int GATHER, int TERM, int ACCUM>
__global__ void __launch_bounds__(kThreads) bucket_variant_kernel(Case c) {
    extern __shared__ __align__(128) float smem[];
    float dep = 0.0f;
    static_assert(TERM != kXgemm, "term 'xgemm' runs xgemm_kernel");
    if constexpr (TERM == kVpu) {
        vpu_block<KIND, GATHER, ACCUM>(c, blockIdx.x, smem, dep);
    } else {
        skip_group<GATHER, ACCUM>(c, blockIdx.x, smem, dep);
    }
    if constexpr (ACCUM == kAccSkip) {
        const float total = block_sum(dep);
        if (threadIdx.x == 0) c.sink[blockIdx.x] = total;
    }
}

template <int KIND, int GATHER, int TERM>
size_t smem_bytes(const Case& c) {
    size_t floats = 0;
    if constexpr (TERM == kVpu) {
        floats = (GATHER == kGatherRoll ? c.ps : 0) + (KIND == kLr ? c.r : 0);
    } else {
        floats = GATHER == kGatherRoll ? (size_t)c.G * c.ps : 0;
    }
    return floats * sizeof(float);
}

template <int KIND, int GATHER, int TERM, int ACCUM>
cudaError_t launch_variant(const Case& c, cudaStream_t st) {
    if constexpr (TERM == kXgemm) {
        return launch_xgemm<KIND, GATHER, ACCUM>(c, st);
    } else {
        const unsigned grid = TERM == kVpu ? (unsigned)c.nb : (unsigned)(c.nb / c.G);
        const size_t smem = smem_bytes<KIND, GATHER, TERM>(c);
        auto kernel = bucket_variant_kernel<KIND, GATHER, TERM, ACCUM>;
        if (smem > 48 * 1024) {
            const cudaError_t e = cudaFuncSetAttribute(
                kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
            if (e != cudaSuccess) return e;
        }
        kernel<<<grid, kThreads, smem, st>>>(c);
        return cudaGetLastError();
    }
}

template <int KIND, int GATHER, int TERM>
cudaError_t pick_accum(int accum, const Case& c, cudaStream_t st) {
    switch (accum) {
        case kAccRoll: return launch_variant<KIND, GATHER, TERM, kAccRoll>(c, st);
        case kAccStatic: return launch_variant<KIND, GATHER, TERM, kAccStatic>(c, st);
        default: return launch_variant<KIND, GATHER, TERM, kAccSkip>(c, st);
    }
}

template <int KIND, int GATHER>
cudaError_t pick_term(int term, int accum, const Case& c, cudaStream_t st) {
    switch (term) {
        case kVpu: return pick_accum<KIND, GATHER, kVpu>(accum, c, st);
        case kXgemm: return pick_accum<KIND, GATHER, kXgemm>(accum, c, st);
        default: return pick_accum<KIND, GATHER, kTermSkip>(accum, c, st);
    }
}

template <int KIND>
cudaError_t pick_gather(int gather, int term, int accum, const Case& c, cudaStream_t st) {
    switch (gather) {
        case kGatherRoll: return pick_term<KIND, kGatherRoll>(term, accum, c, st);
        case kGatherTake: return pick_term<KIND, kGatherTake>(term, accum, c, st);
        default: return pick_term<KIND, kGatherNone>(term, accum, c, st);
    }
}

__global__ void take_kernel(const float* __restrict__ x, int n, const int* __restrict__ idx,
                            int m, long long total, float* __restrict__ out, int* fault) {
    for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < total;
         e += (long long)gridDim.x * blockDim.x)
        out[e] = gather_at(x + (e / m) * n, n, idx[e], fault);
}

}  // namespace

// Plain C interface, loaded with ctypes; each returns the cudaError_t of
// its launch (0 on success).

// P3: kind 0 'lr' / 1 'dense'; gather 0 'roll' / 1 'take' / 2 'none';
// term 0 'vpu' / 1 'xgemm' / 2 'skip'; accum 0 'roll' / 1 'static' / 2
// 'skip'.  slabs (nb, rows, W) f32, 32-byte aligned, W a multiple of 8;
// x and y (L,) with L a multiple of 4, y zeroed; sink (nb,) floats for
// accum 'skip'.  'xgemm' and 'skip' need nb a multiple of G; 'xgemm'
// needs G, pt (and r for 'lr') multiples of 16 and ps of 8, and refuses
// (cudaErrorInvalidConfiguration) G > 32, 'lr' with pt > 256, slabs of
// more than 256 rows (one TMA box) and shapes whose two stages do not fit
// the shared memory (`launch_xgemm`).
extern "C" int bv_launch(int kind, int gather, int term, int accum, const float* slabs,
                         const int* t_off, const int* s_off, const float* x, float* y,
                         float* sink, int L, int nb, int G, int r, int pt, int ps, int rows,
                         int W, void* stream) {
    if (kind < 0 || kind > 1 || gather < 0 || gather > 2 || term < 0 || term > 2
        || accum < 0 || accum > 2 || nb <= 0 || G <= 0 || L % 4 != 0 || W % 8 != 0
        || ps % 4 != 0 || pt > L || (term != kVpu && nb % G != 0)
        || (accum == kAccSkip && sink == nullptr))
        return cudaErrorInvalidValue;
    if (term == kXgemm && (G % 16 != 0 || pt % 16 != 0 || ps % 8 != 0
                           || (kind == kLr && r % 16 != 0)))
        return cudaErrorInvalidValue;
    const Case c{slabs, t_off, s_off, x, y, sink, L, nb, G, r, pt, ps, rows, W};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return kind == kLr ? pick_gather<kLr>(gather, term, accum, c, st)
                       : pick_gather<kDense>(gather, term, accum, c, st);
}

// P4: out (rows, m) = x (rows, n) gathered at idx (rows, m) int32; *fault
// (zeroed by the caller) counts the indices outside [0, n).
extern "C" int bv_take(const float* x, int rows, int n, const int* idx, int m, float* out,
                       int* fault, void* stream) {
    const long long total = (long long)rows * m;
    if (total == 0) return 0;
    const int threads = 256;
    const long long blocks = (total + threads - 1) / threads;
    take_kernel<<<(unsigned)(blocks < 65535 ? blocks : 65535), threads, 0,
                  static_cast<cudaStream_t>(stream)>>>(x, n, idx, m, total, out, fault);
    return cudaGetLastError();
}

extern "C" const char* bv_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
