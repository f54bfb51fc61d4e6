// Kernels K1 and K2: the bucketed H-matrix product y = H^(trans) x on
// Hopper, real f32 (K1) and complex64 (K2), one body templated on the
// element type.
//
// K1 replaces the TPU kernel `apply_hmatrix_pallas` of
// htool_python_tpu/ops/pallas_matvec.py:538 (its fused launch
// `_launch_fused` :756, `_fused_kernel` / `_step_body` / `_term_fwd` /
// `_term_tr`); the same body serves the reference's per-bucket (:522,
// K1-pb) and sequential (:649, K1-seq) launch structures and its aligned
// low-rank step (`_step_body` kind "alr" :355-378, K1-al).  K2 replaces
// `apply_hmatrix_pallas_complex` (:571: the same launches with the complex
// `_step_body`, `_cterm_fwd` / `_cterm_tr`), in the same three structures
// (K2, K2-pb, K2-seq).  The TPU kernel had no complex type and streamed
// re / im f32 plane pairs with explicit cross terms; K2 reads the stored
// interleaved complex64 tensors (float2) as they are.  Their plain PyTorch
// version is `apply_hmatrix_padded` in htool_python_torch/ops/matvec.py
// (and `apply_work_list` there walks the same work items); the wrapper is
// htool_python_torch/ops/cuda_matvec.py.
//
// What it computes.  The operator is a list of buckets of equally padded
// blocks.  A dense block adds  y[t:t+pt] += D x[s:s+ps]  (D is pt x ps,
// row-major); a low-rank block adds  y[t:t+pt] += Ut^T (V x[s:s+ps])  with
// rank-major factors Ut (r x pt) and V (r x ps).  trans = 'T' applies the
// transposes from the target rows into the source rows.  Symmetric storage
// adds, for blocks flagged `mirror`, the opposite-direction term too; for
// real data both directions then run whatever `trans` is.  For complex
// data each direction may use the conjugated factors (the launch's
// conj_fwd for x[s:] -> y[t:], conj_tr for x[t:] -> y[s:]): that is how the
// wrapper forms trans 'C' and hermitian ('H') mirrors.  x and y are
// row-major (rows, k); y must be zeroed by the caller.
//
// What bounds it on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32 FFMA, 495
// TFLOP/s TF32 tensor cores).  Every stored entry is used for 2 flops per
// column (real) or 8 (complex: 4 multiplies, 4 adds).  At k <= 8 that is
// at most 4 flops a byte: the product is bound by the bytes it streams (the
// headline's 417 MB: 0.125 ms; the Helmholtz operator's 2.83 GB: 0.85 ms).
// At k = 128 it is 64 (real) or 128 (complex) flops a byte: on the FFMA
// units the operations bound it (the headline's 26.7 GFLOP: 0.40 ms; the
// hlu operator's 6.1: 0.091 ms).  With the 3xTF32 split below (three TF32
// products for each f32 one, at 495 TFLOP/s) the headline is still bound
// by its operations (0.162 ms), the hlu operator by its bytes, 95 MB of
// factors plus x and y (0.039 ms, just ahead of its 0.037 ms of
// operations), and the Helmholtz operator by its operations (3.5e8
// complex entries x 8 flops x 128 columns x 3 / 495 TFLOP/s: 2.2 ms).
//
// What the design does about it.
//  * A work list, not one CTA per block.  The wrapper's BucketTable builds
//    it once (ops/matvec.py `work_list`, ops/cuda_matvec.py
//    `_item_records`): one item per dense block slice of at most kMaxRows
//    rows, and one per low-rank block slice of at most kMaxRows rank rows
//    (8 x kRowsPerWarp: 64 real, 32 complex)
//    (U V is the sum of its rank slices, so a slice is a low-rank block of
//    its own).  Every stored entry belongs to exactly one item; items are
//    ordered largest first, ties shuffled so that items running at the
//    same time seldom add into the same rows of y.  Each item is one
//    48-byte record holding its factor addresses, offsets, rows, widths and
//    flags: the producer reads one record per item (the next one while the
//    current one streams) and nothing else about it.  For a low-rank item
//    the whole w = V x[s] (R x k) is needed before its Ut part: one item per
//    slice, its factors streamed through the ring, w kept in shared memory.
//  * All k columns in one CTA (an x row of up to kMaxCols floats: 128 real
//    or 64 complex columns; a wider x runs in passes of that many columns,
//    each reading every stored byte once).  A stored byte is read once per
//    direction it is used in: a mirrored block under symmetric storage runs
//    both directions and streams its factors twice.
//  * Bulk async copies into a shared-memory ring.  Each block's D, V and
//    Ut are contiguous, 16-byte aligned runs (BucketTable checks it).  A
//    factor is streamed in strips of J columns (all the item's rows), or
//    whole where it fits a stage at k <= 8: one producer warp issues one
//    `cp.async.bulk` (1-D TMA, no tensor map) per factor row of a strip, or
//    one for a whole factor, and one for the x rows the strip contracts
//    with where they are one run (on the tensor-core path, into padded
//    rows: one bulk copy per row, or 16-byte cp.async below 64 floats a
//    row; 8-byte cp.async where x's rows are 8- but not 16-byte aligned, as
//    complex rows at odd k are; 4-byte where they are not even that), into
//    a ring of kStages stages guarded by full / empty `mbarrier`s.  The
//    producer reckons in floats, so a complex entry is two of them and a
//    stage holds half as many complex entries as real ones.  Each stage
//    starts with a header (struct Strip) that the producer writes: the 8
//    consumer warps are driven by the headers alone and read nothing from
//    device memory but the stages.  The grid is persistent: one CTA per SM
//    (the ring takes the SM's shared memory), each walking items b, b +
//    grid, ...  In flight per SM: up to 3 stages of ~76 KB (k <= 8) or ~66
//    KB (128 floats a row), against the ~3.35 TB/s x ~1 us / 132 SMs = 25
//    KB that DRAM latency asks for; the stage count is set by the
//    producer's fixed time per strip (kStages).
//  * k <= 8: the consumers run FFMA on the strip in shared memory: for w =
//    V x the warps split the item's rows and, below 8 x kRowsPerWarp rows,
//    the strip's columns too (`fma_rows`: each x row is then read by fewer
//    warps; the lanes' sums are reduce-scattered by shuffles once per
//    phase and added in shared memory), one thread per output row for Ut^T
//    w; a complex multiply-add is 4 FFMAs.
//    Atomics into y: f32, float4 / float2 where the row segment is aligned
//    (real k = 4, 8; complex k = 2, 4, 8 as float4, two values at once),
//    float2 (one complex value) else, and for real k <= 2 over 4 / 2
//    consecutive rows where the output window starts on a multiple of 4 /
//    2 rows (always in the aligned layout, K1-al, whose x strips are also
//    always one aligned run).
//  * k >= 9: the block products run on the tensor cores, mma.sync.m16n8k8
//    TF32 with the 3xTF32 split (a = a_hi + a_lo, a_hi = tf32(a), a_lo =
//    tf32(a - a_hi); a b ~ a_lo b_hi + a_hi b_lo + a_hi b_hi, accumulated in
//    f32), which keeps about f32's precision where plain TF32 (2^-11) would
//    miss the 1e-5 check.  Each factor strip in shared memory serves all k
//    columns: w^T (k x R) = x^T V^T accumulates in registers over the
//    strips of V (k on the m16 side, the item's rows on the n8 side, so an
//    8-rank block wastes nothing; with fewer than 8 such tiles the warps
//    split each strip's k8 steps), and each strip of Ut gives its J output
//    rows x k columns at once.  Complex data runs the same tiles over the
//    2k interleaved real columns of x (re, im, re, im, ...): with F = Fr +
//    i Fi, F x = Fr X + Fi (i x), and i x in the interleaved columns is X
//    with each (re, im) pair turned into (-im, re) -- two real products
//    into one accumulator, the second fed with the pair-swapped fragment of
//    the same strip and Fi's sign flipped under conjugation.  Each strip
//    sums into its own tile, added to the running sum in f32 (the tensor
//    cores' f32 accumulation truncates).  What bounds this path in practice
//    is not the arithmetic: every block re-reads its k-column x segment and
//    adds a pt x k tile into y, so at k = 128 the headline moves ~1.3 GB of
//    x and ~1.4 GB of y through L2 (row ownership of y, and blocks that
//    share an x segment sharing its read, are later work).
//
// Registers and spills (nvcc -Xptxas -v, sm_90a, CUDA 12.8): K1's KC = 1,
// 2, 4, 8 and tensor-core instantiations use 72, 80, 96, 144 and 128
// registers, K2's 72, 96, 109, 153 and 135, no spills, 160 bytes of stack
// (the producer's phases of an item).  ptxas allows this 288-thread CTA
// 168: with 8 accumulator rows a warp, K2's KC = 8 spilled 1 000 bytes,
// hence 4 rows a warp and items of at most 32 rows for complex data
// (kRowsPerWarp).  chip_smoke.py's `device` phase prints the report.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libhmatrix_product.so hmatrix_product.cu
// (done at first use by htool_python_torch/ops/cuda_build.py).

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kConsumerWarps = 8;
constexpr int kConsumers = 32 * kConsumerWarps;
constexpr int kThreads = kConsumers + 32;  // + the producer warp
constexpr int kMaxRows = 64;    // rows of an item (ops/matvec.py WORK_ROWS)
constexpr int kMaxCols = 128;   // floats of an x row in one pass
// Stages of the ring.  Each strip costs the producer a fixed time (its
// header, its barriers, one bulk copy per factor row), so fewer, larger
// stages stream faster, down to 3 (PERF.md, profiling/k1_variants.py).
constexpr int kStages = 3;
constexpr int kTC = 0;          // KC value of the tensor-core instantiation
// Columns up to which a pass runs FFMA (KC = 1, 2, 4, 8), real and
// complex; wider passes run on the tensor cores (PERF.md,
// profiling/k1_variants.py).
constexpr int kFmaColsReal = 8;
constexpr int kFmaColsComplex = 8;
// Whether the FFMA path splits a small-rank ROW phase's strip columns over
// the warps (`fma_rows`), real and complex.
constexpr bool kSplitRowsReal = true;
constexpr bool kSplitRowsComplex = true;
constexpr int kSlack = 8;       // floats of an x window's alignment shift

// floats per element: 1 for float (K1), 2 for float2 (K2, complex64)
template <typename T>
constexpr int kE = sizeof(T) / sizeof(float);
// Rows of an item a consumer warp holds on the FFMA path (the accumulators
// are kRowsPerWarp x KC elements a thread): a complex item has at most 8 x
// 4 = 32 rows (ops/matvec.py WORK_ROWS_COMPLEX), so that KC = 8 fits the
// 168 registers ptxas allows a thread of this 288-thread CTA.
template <typename T>
constexpr int kRowsPerWarp = kE<T> == 2 ? 4 : 8;

// A work item, as BucketTable packs it (ops/cuda_matvec.py `_item_records`):
// rows [lo, lo + R) of one block.  Low-rank: a = Ut + (block r + lo) pt,
// v = V + (block r + lo) ps (rank rows, each a contiguous row of pt / ps
// elements); dense: a = D + (block pt + lo) ps, t already + lo.
struct Item {
    long long a, v;
    int t, s, R, pt, ps, flags;  // flags: kDense | kMirror
    long long pad;
};
constexpr int kDense = 1, kMirror = 2;

// What one pass over a factor F (R rows of `width` elements, contiguous)
// does.  ROW_*: contract F's columns with x rows [xoff, xoff + width) into
// R x k sums, kept in shared memory as w (ROW_W) or added into y rows
// [yoff, yoff + R) (ROW_Y, a dense block).  COL_*: y rows [yoff, yoff +
// width) += F^T w, with w from the previous ROW_W phase (COL_W) or the x
// rows [xoff, xoff + R) (COL_X, a dense block's transpose).  conj: use
// conj(F) (complex data only).
enum Kind { ROW_W, ROW_Y, COL_W, COL_X };

struct Phase {
    const float* F;
    long long xoff, yoff;
    int R, width, kind, conj;
};

__device__ __forceinline__ bool is_row(int kind) { return kind <= ROW_Y; }

// The phases of an item, in the order the producer streams them.
__device__ __forceinline__ int item_phases(const Item& it, int swapped,
                                           int symmetric, int conj_fwd,
                                           int conj_tr, Phase* ph) {
    const bool mirrored = symmetric && (it.flags & kMirror);
    const bool fwd = !swapped || mirrored;  // x[s:] -> y[t:]
    const bool tr = swapped || mirrored;    // x[t:] -> y[s:]
    const float* a = reinterpret_cast<const float*>(it.a);
    const float* v = reinterpret_cast<const float*>(it.v);
    int n = 0;
    if (it.flags & kDense) {
        if (fwd) ph[n++] = Phase{a, it.s, it.t, it.R, it.ps, ROW_Y, conj_fwd};
        if (tr) ph[n++] = Phase{a, it.t, it.s, it.R, it.ps, COL_X, conj_tr};
    } else {
        if (fwd) {
            ph[n++] = Phase{v, it.s, 0, it.R, it.ps, ROW_W, conj_fwd};
            ph[n++] = Phase{a, 0, it.t, it.R, it.pt, COL_W, conj_fwd};
        }
        if (tr) {
            ph[n++] = Phase{a, it.t, 0, it.R, it.pt, ROW_W, conj_tr};
            ph[n++] = Phase{v, 0, it.s, it.R, it.ps, COL_W, conj_tr};
        }
    }
    return n;
}

// Row stride (floats) of x in shared memory and of w, for k columns of E
// floats: KC E at k <= 8; on the tensor-core path the k E real columns
// rounded up to 8 and then to 8 mod 32 floats, so that an mma fragment of
// x or w (rows tq, columns g) hits 32 distinct banks.
__host__ __device__ __forceinline__ int x_stride(int KC, int k, int E) {
    if (KC != kTC) return KC * E;
    const int kp = (k * E + 7) & ~7;
    return kp + (((8 - kp) % 32) + 32) % 32;
}

__device__ __forceinline__ int col_stride(int J) {
    return J + (((8 - J) % 32) + 32) % 32;
}

// One strip of a phase as the producer hands it to the consumers, written
// into the stage's header before the stage's full barrier is arrived on.
struct Strip {
    long long yrow;   // ROW: the phase's first y row (ROW_Y); COL: the strip's
    int kind, R, wj;  // rows, columns of the strip
    int SF;           // row stride (elements) of the factor strip at the stage's start
    int xbase;        // where the x rows start in the stage (floats)
    int flags;        // kFirst | kLast (of the phase) | kDone (no more work) | kConj
};
constexpr int kFirst = 1, kLast = 2, kDone = 4, kConj = 8;
constexpr int kHeaderFloats = 8;  // 32 bytes of header ahead of each stage

// Strip width J (a multiple of 16, or the whole width) and factor row
// stride SF (elements of E floats) of a phase, for x rows of sx floats in
// a stage of `stage` floats.  ROW phases: SF = J + 4, so that an mma
// fragment's factor rows g fall on distinct banks; real COL phases read
// the strip transposed: SF = 8 or 24 mod 32; complex ones read float2
// pairs, half a warp at a time: SF = J + 4 again.  FFMA reads along rows
// only: where the whole factor fits a stage it is one unpadded run (one
// bulk copy).  The x rows follow the factor strip: J rows for ROW, R rows
// for COL_X.
__device__ __forceinline__ void geometry(const Phase& p, int sx, int stage,
                                         bool fma, int E, int& J, int& SF) {
    const int xrows_per_col = is_row(p.kind) ? sx : 0;
    const int xfixed = (p.kind == COL_X ? p.R * sx : 0) + kSlack;
    if (fma && p.R * p.width * E + p.width * xrows_per_col + xfixed <= stage) {
        J = SF = p.width;
        return;
    }
    const bool padded_col = E == 1 && !is_row(p.kind);
    const int wpad = (p.width + 15) & ~15;
    J = (stage - xfixed - (padded_col ? 24 : 4) * E * p.R)
        / (p.R * E + xrows_per_col);
    J = min(wpad, max(16, J & ~15));
    SF = padded_col ? col_stride(J) : J + 4;
}

// ---- mbarrier, bulk copy and cp.async helpers (PTX) ----------------------

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

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// The barrier's phase also waits for this thread's earlier cp.async copies
// (counted as one of its expected arrivals).
__device__ __forceinline__ void mbar_arrive_cp_async(uint64_t* bar) {
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
                 :: "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void bulk_copy(float* dst, const float* src,
                                          uint32_t bytes, uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n"
        :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
        : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async8(float* dst, const float* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
                 :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void consumer_sync() {
    asm volatile("bar.sync 1, %0;\n" :: "n"(kConsumers) : "memory");
}

// ---- the producer warp -----------------------------------------------

// x rows [r0, r0 + nrows) (k floats, row stride ld floats; x holds lx
// rows) into X with row stride sx; returns the shift (floats) of the first
// row past X and adds the bulk bytes to *tx.  A contiguous run (sx == k ==
// ld) goes as one bulk copy of its 16-byte aligned window (the shift is
// the run's misalignment, at most 3); rows into a padded stride (the
// tensor-core path), where k and ld are multiples of 4, as one bulk copy
// per row from 64 floats up and as 16-byte cp.async below (a bulk copy
// costs the producer a fixed time, which rows of 128 bytes do not repay;
// PERF.md, profiling/k1_variants.py); else as 8-byte cp.async where k and
// ld are even (complex rows at odd k), 4-byte cp.async where not.
__device__ __forceinline__ int copy_x(float* X, const float* __restrict__ x,
                                      long long lx, int ld, int k, int sx,
                                      long long r0, int nrows, uint64_t* full,
                                      uint32_t* tx, bool issue, int lane) {
    if (sx == k && ld == k) {
        const long long o = r0 * k, o4 = o & ~3LL;
        const long long e4 = (o + (long long)nrows * k + 3) & ~3LL;
        if (e4 <= lx * k) {
            *tx += (uint32_t)((e4 - o4) * 4);
            if (issue && lane == 0) bulk_copy(X, x + o4, (uint32_t)((e4 - o4) * 4), full);
            return (int)(o - o4);
        }
    } else if (k % 4 == 0 && ld % 4 == 0 && k >= 64) {
        *tx += (uint32_t)(nrows * k * 4);
        if (issue)
            for (int q = lane; q < nrows; q += 32)
                bulk_copy(X + q * sx, x + (r0 + q) * ld, (uint32_t)(k * 4), full);
        return 0;
    } else if (k % 4 == 0 && ld % 4 == 0) {
        const int q4 = k / 4;
        if (issue)
            for (int e = lane; e < nrows * q4; e += 32) {
                const int q = e / q4, c = 4 * (e - q * q4);
                cp_async16(X + q * sx + c, x + (r0 + q) * ld + c);
            }
        return 0;
    } else if (k % 2 == 0 && ld % 2 == 0) {
        const int q2 = k / 2;
        if (issue)
            for (int e = lane; e < nrows * q2; e += 32) {
                const int q = e / q2, c = 2 * (e - q * q2);
                cp_async8(X + q * sx + c, x + (r0 + q) * ld + c);
            }
        return 0;
    }
    if (issue)
        for (int e = lane; e < nrows * k; e += 32) {
            const int q = e / k, c = e - q * k;
            cp_async4(X + q * sx + c, x + (r0 + q) * ld + c);
        }
    return 0;
}

// Issues the copies of one strip (columns [j0, j0 + wj) of phase p's
// factor, elements of E floats, and its x rows of k floats) into stage S
// and writes the stage's header.
__device__ __forceinline__ void produce_strip(const Phase& p, int J, int SF,
                                              int j0, int flags, int E,
                                              float* S, Strip* hdr,
                                              uint64_t* full,
                                              const float* __restrict__ x,
                                              long long lx, int ld, int k,
                                              int sx, int lane) {
    const int wj = min(J, p.width - j0);
    float* X = S + p.R * SF * E;
    uint32_t tx = (uint32_t)(p.R * wj * E * 4);
    int shift = 0;
    if (is_row(p.kind))
        shift = copy_x(X, x, lx, ld, k, sx, p.xoff + j0, wj, full, &tx, false, lane);
    else if (p.kind == COL_X)
        shift = copy_x(X, x, lx, ld, k, sx, p.xoff, p.R, full, &tx, false, lane);
    if (lane == 0) {
        *hdr = Strip{is_row(p.kind) ? p.yoff : p.yoff + j0, p.kind, p.R, wj, SF,
                     p.R * SF * E + shift, flags | (p.conj ? kConj : 0)};
        mbar_arrive_expect_tx(full, tx);
    }
    __syncwarp();
    if (SF == J) {  // whole unpadded rows (geometry's FFMA case): one run
        if (lane == 0) bulk_copy(S, p.F, (uint32_t)(p.R * p.width * E * 4), full);
    } else {
        for (int rr = lane; rr < p.R; rr += 32)
            bulk_copy(S + rr * SF * E, p.F + ((long long)rr * p.width + j0) * E,
                      (uint32_t)(wj * E * 4), full);
    }
    if (is_row(p.kind))
        copy_x(X, x, lx, ld, k, sx, p.xoff + j0, wj, full, &tx, true, lane);
    else if (p.kind == COL_X)
        copy_x(X, x, lx, ld, k, sx, p.xoff, p.R, full, &tx, true, lane);
    mbar_arrive_cp_async(full);
}

// ---- k <= 8: FFMA on the strip ----------------------------------------

// The element arithmetic of the FFMA path: float (K1) or float2 (K2, re /
// im).  cj(a, s): a, or conj(a) for s == -1.
__device__ __forceinline__ float cj(float a, float) { return a; }
__device__ __forceinline__ float2 cj(float2 a, float s) {
    return make_float2(a.x, s * a.y);
}
__device__ __forceinline__ void mac(float& acc, float a, float x) {
    acc = fmaf(a, x, acc);
}
__device__ __forceinline__ void mac(float2& acc, float2 a, float2 x) {
    acc.x = fmaf(a.x, x.x, fmaf(-a.y, x.y, acc.x));
    acc.y = fmaf(a.x, x.y, fmaf(a.y, x.x, acc.y));
}
__device__ __forceinline__ bool nonzero(float v) { return v != 0.0f; }
__device__ __forceinline__ bool nonzero(float2 v) {
    return v.x != 0.0f || v.y != 0.0f;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}
__device__ __forceinline__ float2 warp_sum(float2 v) {
    return make_float2(warp_sum(v.x), warp_sum(v.y));
}

// KC consecutive elements from shared memory (16-byte aligned when they
// span a multiple of 16 bytes, 8-byte aligned when they span 8).
template <int KC>
__device__ __forceinline__ void load_kc(const float* p, float (&v)[KC]) {
    if constexpr (KC % 4 == 0) {
#pragma unroll
        for (int q = 0; q < KC / 4; ++q) {
            const float4 f = reinterpret_cast<const float4*>(p)[q];
            v[4 * q] = f.x; v[4 * q + 1] = f.y; v[4 * q + 2] = f.z; v[4 * q + 3] = f.w;
        }
    } else if constexpr (KC == 2) {
        const float2 f = *reinterpret_cast<const float2*>(p);
        v[0] = f.x; v[1] = f.y;
    } else {
        v[0] = p[0];
    }
}

template <int KC>
__device__ __forceinline__ void load_kc(const float2* p, float2 (&v)[KC]) {
    if constexpr (KC % 2 == 0) {
#pragma unroll
        for (int q = 0; q < KC / 2; ++q) {
            const float4 f = reinterpret_cast<const float4*>(p)[q];
            v[2 * q] = make_float2(f.x, f.y);
            v[2 * q + 1] = make_float2(f.z, f.w);
        }
    } else {
        v[0] = p[0];
    }
}

// y[yr, c] += acc[c] for c < k, skipping all-zero values (a padded block
// row adds nothing).  vec: k == KC and the row segment is 16-byte aligned
// (8-byte for real KC == 2), so Hopper's vector atomics add 4 floats (2)
// at once: 4 real or 2 complex values.  A complex value alone goes as one
// float2 atomic.
template <int KC>
__device__ __forceinline__ void add_row(float* __restrict__ y, long long yr,
                                        long long ly, int ld, int k,
                                        const float (&acc)[KC], bool vec) {
    if (yr >= ly) return;
    float* p = y + yr * ld;
    if constexpr (KC % 4 == 0) {
        if (vec) {
#pragma unroll
            for (int q = 0; q < KC / 4; ++q) {
                const float4 v = make_float4(acc[4 * q], acc[4 * q + 1],
                                             acc[4 * q + 2], acc[4 * q + 3]);
                if (v.x != 0.0f || v.y != 0.0f || v.z != 0.0f || v.w != 0.0f)
                    atomicAdd(reinterpret_cast<float4*>(p) + q, v);
            }
            return;
        }
    } else if constexpr (KC == 2) {
        if (vec) {
            if (acc[0] != 0.0f || acc[1] != 0.0f)
                atomicAdd(reinterpret_cast<float2*>(p), make_float2(acc[0], acc[1]));
            return;
        }
    }
#pragma unroll
    for (int c = 0; c < KC; ++c)
        if (c < k && acc[c] != 0.0f) atomicAdd(p + c, acc[c]);
}

template <int KC>
__device__ __forceinline__ void add_row(float2* __restrict__ y, long long yr,
                                        long long ly, int ld, int k,
                                        const float2 (&acc)[KC], bool vec) {
    if (yr >= ly) return;
    float2* p = y + yr * ld;
    if constexpr (KC % 2 == 0) {
        if (vec) {
#pragma unroll
            for (int q = 0; q < KC / 2; ++q) {
                const float4 v = make_float4(acc[2 * q].x, acc[2 * q].y,
                                             acc[2 * q + 1].x, acc[2 * q + 1].y);
                if (v.x != 0.0f || v.y != 0.0f || v.z != 0.0f || v.w != 0.0f)
                    atomicAdd(reinterpret_cast<float4*>(p) + q, v);
            }
            return;
        }
    }
#pragma unroll
    for (int c = 0; c < KC; ++c)
        if (c < k && nonzero(acc[c])) atomicAdd(p + c, acc[c]);
}

// How the consumer warps share a ROW phase's R rows on the FFMA path (P
// = kRowsPerWarp rows a warp).  Unsplit, warp w takes rows w + 8 i and its
// lanes read the whole x strip, so each x row is read 8 times whatever R
// is (at R = 8 the x strip of a complex 8-column pass is as large as the
// factor's, in 64-byte rows whose float4 reads conflict 4 ways).  Split,
// the rows fall into the fewest RG = 1, 2, 4 or 8 groups of at most P
// rows: warp w takes rows g + RG i of group g = w % RG and every S-th
// stretch of 32 strip columns (S = 8 / RG, s = w / RG), so each x row is
// read RG times and the phase end adds the S partial sums of a row in
// shared memory.
struct FmaRows { int g, RG, s, S; };

template <typename T>
__device__ __forceinline__ FmaRows fma_rows(int R, int warp) {
    constexpr int P = kRowsPerWarp<T>;
    const bool split = kE<T> == 2 ? kSplitRowsComplex : kSplitRowsReal;
    const int RG = !split || R > 4 * P ? 8 : R > 2 * P ? 4 : R > P ? 2 : 1;
    return FmaRows{warp % RG, RG, warp / RG, kConsumerWarps / RG};
}

// ROW strip: acc[i][c] += sum_jj op(F[rr, jj]) X[jj, c] for the warp's rows
// rr = g + RG i over its columns jj (lane partial sums; reduced at the end
// of the phase).
template <typename T, int KC>
__device__ __forceinline__ void fma_row_strip(const T* F, const T* X, int SF,
                                              int R, int wj, float cs,
                                              int warp, int lane,
                                              T (&acc)[kRowsPerWarp<T>][KC]) {
    const FmaRows P = fma_rows<T>(R, warp);
#pragma unroll 4
    for (int jj = 32 * P.s + lane; jj < wj; jj += 32 * P.S) {
        T xv[KC];
        load_kc<KC>(X + jj * KC, xv);
#pragma unroll
        for (int i = 0; i < kRowsPerWarp<T>; ++i) {
            const int rr = P.g + P.RG * i;
            if (rr < R) {
                const T a = cj(F[rr * SF + jj], cs);
#pragma unroll
                for (int c = 0; c < KC; ++c) mac(acc[i][c], a, xv[c]);
            }
        }
    }
}

// A float part of an element: the value, or re (q = 0) / im (q = 1).
__device__ __forceinline__ float part_of(float v, int) { return v; }
__device__ __forceinline__ float part_of(float2 v, int q) { return q ? v.y : v.x; }

// Reduce-scatter of the lanes' f[N] over the warp: the lanes exchange half
// of their n values at each of the masks 16, 8, ... (keeping the half the
// mask bit of their lane picks), so that lane l ends with the warp's sums
// of the logical values base + v, v < max(N / 32, 1), after N - 1 shuffles
// a lane at most (a warp_sum of each value would take 5 N).  Where N < 32
// the last masks only add (dup: lanes with a dup bit set hold copies).
template <int N, int n, int MASK>
__device__ __forceinline__ void reduce_scatter(float (&f)[N], int lane,
                                               int& base, int& dup) {
    if constexpr (MASK >= 1) {
        if constexpr (n >= 2) {
            constexpr int half = n / 2;
            const bool up = lane & MASK;
#pragma unroll
            for (int v = 0; v < half; ++v) {
                const float send = up ? f[v] : f[v + half];
                const float keep = up ? f[v + half] : f[v];
                f[v] = keep + __shfl_xor_sync(0xffffffffu, send, MASK);
            }
            if (up) base += half;
            reduce_scatter<N, half, MASK / 2>(f, lane, base, dup);
        } else {
            f[0] += __shfl_xor_sync(0xffffffffu, f[0], MASK);
            dup |= MASK;
            reduce_scatter<N, n, MASK / 2>(f, lane, base, dup);
        }
    }
}

// End of a ROW phase: the row sums into w (ROW_W) or y (ROW_Y).  Unsplit,
// each warp's lane 0 writes its rows' sums.  Split, each warp's partial
// sums are reduce-scattered over its lanes into the warp's slot of w
// (slot s holds rows [s P RG, (s + 1) P RG) of w's kMaxRows), the S slots
// of every row are added after a barrier into slot 0 (w proper), and a
// ROW_Y phase adds w into y; barriers keep w's readers and writers apart.
template <typename T, int KC>
__device__ __forceinline__ void fma_row_finish(const Strip& h, T* W,
                                               T (&acc)[kRowsPerWarp<T>][KC],
                                               int warp, int lane, int tid,
                                               T* __restrict__ y,
                                               long long ly, int ld, int k) {
    const FmaRows P = fma_rows<T>(h.R, warp);
    const bool vec = k == KC && KC > 1 && ld == k;
    constexpr int RPW = kRowsPerWarp<T>;
    if (P.S == 1) {
#pragma unroll
        for (int i = 0; i < RPW; ++i) {
            const int rr = warp + 8 * i;
            if (rr >= h.R) break;  // uniform in the warp
#pragma unroll
            for (int c = 0; c < KC; ++c) acc[i][c] = warp_sum(acc[i][c]);
            if (lane == 0) {
                if (h.kind == ROW_W) {
#pragma unroll
                    for (int c = 0; c < KC; ++c) W[rr * KC + c] = acc[i][c];
                } else {
                    add_row<KC>(y, h.yrow + rr, ly, ld, k, acc[i], vec);
                }
            }
        }
        return;
    }
    constexpr int E = kE<T>, RF = KC * E, N = RPW * RF;  // floats of a row, of acc
    float* Wf = reinterpret_cast<float*>(W);
    float f[N];
#pragma unroll
    for (int i = 0; i < RPW; ++i)
#pragma unroll
        for (int c = 0; c < KC; ++c)
#pragma unroll
            for (int q = 0; q < E; ++q) f[(i * KC + c) * E + q] = part_of(acc[i][c], q);
    int base = 0, dup = 0;
    reduce_scatter<N, N, 16>(f, lane, base, dup);
    const int R8 = RPW * P.RG;
    if ((lane & dup) == 0) {
#pragma unroll
        for (int v = 0; v < (N >= 32 ? N / 32 : 1); ++v) {
            const int i = (base + v) / RF, j = (base + v) - i * RF;
            const int rr = P.g + P.RG * i;
            if (rr < h.R) Wf[(P.s * R8 + rr) * RF + j] = f[v];
        }
    }
    consumer_sync();  // every warp's partial sums are in its slot
    for (int t = tid; t < h.R * RF; t += kConsumers) {
        const int r = t / RF, j = t - r * RF;
        float sum = 0.0f;
        for (int q = 0; q < P.S; ++q) sum += Wf[(q * R8 + r) * RF + j];
        Wf[r * RF + j] = sum;
    }
    consumer_sync();  // w is whole
    if (h.kind == ROW_Y) {
        for (int r = tid; r < h.R; r += kConsumers) {
            T v[KC];
#pragma unroll
            for (int c = 0; c < KC; ++c) v[c] = W[r * KC + c];
            add_row<KC>(y, h.yrow + r, ly, ld, k, v, vec);
        }
        consumer_sync();  // w read before the next phase writes it
    }
}

// COL strip: y[yrow0 + jj, c] += sum_rr op(F[rr, jj]) w[rr, c], one thread
// per output row; for real data at k <= 2 on a window starting on a
// multiple of 4 / KC rows, each thread adds 4 / KC consecutive rows with
// one float4 atomic.
template <typename T, int KC>
__device__ __forceinline__ void fma_col_strip(const T* F, const T* W,
                                              int SF, int R, int wj,
                                              long long yrow0, float cs,
                                              T* __restrict__ y,
                                              long long ly, int ld, int k,
                                              int tid) {
    if constexpr (KC <= 2 && kE<T> == 1) {
        constexpr int RW = 4 / KC;  // rows per float4
        if (k == KC && ld == k && yrow0 % RW == 0 && SF % 4 == 0) {
            for (int j = tid * RW; j < wj; j += kConsumers * RW) {
                float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 4
                for (int rr = 0; rr < R; ++rr) {
                    float wv[KC], a[RW];
                    load_kc<KC>(W + rr * KC, wv);
                    load_kc<RW>(F + rr * SF + j, a);
#pragma unroll
                    for (int q = 0; q < RW; ++q)
#pragma unroll
                        for (int c = 0; c < KC; ++c)
                            acc[q * KC + c] = fmaf(a[q], wv[c], acc[q * KC + c]);
                }
                if (acc[0] == 0.0f && acc[1] == 0.0f && acc[2] == 0.0f && acc[3] == 0.0f)
                    continue;
                const long long yr = yrow0 + j;
                if (yr + RW <= ly) {
                    atomicAdd(reinterpret_cast<float4*>(y + yr * KC),
                              make_float4(acc[0], acc[1], acc[2], acc[3]));
                } else {
                    for (int q = 0; q < 4; ++q)
                        if (yr + q / KC < ly && acc[q] != 0.0f)
                            atomicAdd(y + yr * KC + q, acc[q]);
                }
            }
            return;
        }
    }
    for (int j = tid; j < wj; j += kConsumers) {
        T acc[KC];
#pragma unroll
        for (int c = 0; c < KC; ++c) acc[c] = T{};
#pragma unroll 4
        for (int rr = 0; rr < R; ++rr) {
            const T a = cj(F[rr * SF + j], cs);
            T wv[KC];
            load_kc<KC>(W + rr * KC, wv);
#pragma unroll
            for (int c = 0; c < KC; ++c) mac(acc[c], a, wv[c]);
        }
        add_row<KC>(y, yrow0 + j, ly, ld, k, acc, k == KC && KC > 1 && ld == k);
    }
}

// ---- k >= 9: 3xTF32 mma.sync on the tensor cores --------------------------

__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(v));
    const float rest = v - __uint_as_float(hi);
    asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(rest));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += A B in 3xTF32 for one m16n8k8 step, from f32 fragments.
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ahi)[4],
                                     const uint32_t (&alo)[4], float b0, float b1) {
    uint32_t bh0, bl0, bh1, bl1;
    split_tf32(b0, bh0, bl0);
    split_tf32(b1, bh1, bl1);
    mma_tf32(c, alo, bh0, bh1);
    mma_tf32(c, ahi, bl0, bl1);
    mma_tf32(c, ahi, bh0, bh1);
}

// An x or w value at real column m (< k) of row q, or that of i x / i w
// for the complex path: the interleaved pair (re, im) becomes (-im, re),
// so column m reads its partner m ^ 1, negated at an even m.
template <bool ROT>
__device__ __forceinline__ float xval(const float* X, int q, int sx, int m,
                                      bool ok) {
    if (!ok) return 0.0f;
    if constexpr (ROT) {
        const float v = X[q * sx + (m ^ 1)];
        return (m & 1) ? v : -v;
    } else {
        return X[q * sx + m];
    }
}

// Tiles of a ROW phase on the tensor cores, computed transposed: w^T (k x
// R) += X^T (k x J) F^T (J x R), so that the columns fill the m16 side (no
// padding at k = 16, 32, ... 128) and the R <= 64 rows the n8 side (none at
// R = 8, 16, ...).  MK, a power of two, m16 tiles cover k; warp w takes m
// tile w % MK and the n8 tiles n = w / MK + (8 / MK) i.
__device__ __forceinline__ int row_mtiles(int k) {
    return k <= 16 ? 1 : k <= 32 ? 2 : k <= 64 ? 4 : 8;
}

// How the consumer warps share a ROW phase's tiles (MK m16 tiles over k,
// NT n8 tiles over R).  With at least 8 tiles, warp w takes m tile w % MK
// and the n tiles w / MK + (8 / MK) i.  With fewer (a narrow x or a small
// rank), S = 8 / tiles warps share each tile, each taking every S-th k8
// step of a strip, and the phase end adds their partial tiles.
struct RowTiles { int col0, n0, nstep, split, S; bool idle; };

__device__ __forceinline__ RowTiles row_tiles(int R, int k, int warp) {
    const int MK = row_mtiles(k), NT = (R + 7) / 8, tiles = MK * NT;
    if (tiles >= kConsumerWarps)
        return RowTiles{(warp % MK) * 16, warp / MK, kConsumerWarps / MK, 0, 1, false};
    const int S = kConsumerWarps / tiles, t = warp % tiles;
    return RowTiles{(t % MK) * 16, t / MK, NT, warp / tiles, S, warp >= tiles * S};
}

// k here counts real columns (2 per complex one); F holds T elements, X
// floats.  Complex: F x = Fr X + (cs Fi) (i X), both into `part`.
template <typename T>
__device__ __forceinline__ void tc_row_strip(const T* F, const float* X,
                                             int SF, int sx, int R, int wj,
                                             int k, float cs, int warp,
                                             int lane, float (&acc)[8][4]) {
    constexpr bool CX = kE<T> == 2;
    const RowTiles T_ = row_tiles(R, k, warp);
    if (T_.idle) return;
    const int NT = (R + 7) / 8;
    const int g = lane >> 2, tq = lane & 3;
    const int m0 = T_.col0 + g, m1 = m0 + 8;
    // the strip's sum in its own accumulators, added to acc in f32: the
    // tensor cores' f32 accumulation truncates, and a chain over a whole
    // 1024-wide factor drifts by ~1e-5 of |y|
    float part[8][4] = {};
    for (int kk = 8 * T_.split; kk < wj; kk += 8 * T_.S) {
        const int q0 = kk + tq, q1 = q0 + 4;
        const bool ok[4] = {q0 < wj && m0 < k, q0 < wj && m1 < k,
                            q1 < wj && m0 < k, q1 < wj && m1 < k};
        const int qs[4] = {q0, q0, q1, q1}, ms[4] = {m0, m1, m0, m1};
        uint32_t ahi[4], alo[4], rhi[4], rlo[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            split_tf32(xval<false>(X, qs[q], sx, ms[q], ok[q]), ahi[q], alo[q]);
            if constexpr (CX)
                split_tf32(xval<true>(X, qs[q], sx, ms[q], ok[q]), rhi[q], rlo[q]);
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            const int n = T_.n0 + T_.nstep * i;
            if (n >= NT) break;
            const int row = n * 8 + g;
            const T b0 = (row < R && q0 < wj) ? F[row * SF + q0] : T{};
            const T b1 = (row < R && q1 < wj) ? F[row * SF + q1] : T{};
            if constexpr (CX) {
                mma3(part[i], ahi, alo, b0.x, b1.x);
                mma3(part[i], rhi, rlo, cs * b0.y, cs * b1.y);
            } else {
                mma3(part[i], ahi, alo, b0, b1);
            }
        }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][q] += part[i][q];
}

// End of a ROW phase on the tensor cores: w (R x k, rows past R zero) into
// shared memory, the shares of a split tile added after the first one.
// Its caller syncs, and for ROW_Y adds w into y rows.
__device__ __forceinline__ void tc_row_finish(int R, float* W, int sw,
                                              float (&acc)[8][4], int k,
                                              int warp, int lane) {
    const RowTiles T = row_tiles(R, k, warp);
    const int NT = (R + 7) / 8;
    const int g = lane >> 2, tq = lane & 3;
    for (int pass = 0; pass < (T.S > 1 ? 2 : 1); ++pass) {
        if (pass == 1) consumer_sync();  // the first shares are in w
        if (T.idle || (pass == 0) != (T.split == 0)) continue;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            const int n = T.n0 + T.nstep * i;
            if (n >= NT) break;
            const int r0 = n * 8 + 2 * tq, c0 = T.col0 + g, c1 = c0 + 8;
            float* w[4] = {W + r0 * sw + c0, W + (r0 + 1) * sw + c0,
                           W + r0 * sw + c1, W + (r0 + 1) * sw + c1};
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                if ((q < 2 ? c0 : c1) >= k) continue;  // m16 tiles reach past k
                if (pass == 0) *w[q] = acc[i][q];
                else atomicAdd(w[q], acc[i][q]);
            }
        }
    }
}

// y rows [yrow, yrow + R) += w (R x k floats in shared memory, stride sw):
// float4 atomics where k and ld are multiples of 4, float2 where they are
// even (a complex value), else f32.
__device__ __forceinline__ void add_w(const float* W, int sw, int R,
                                      long long yrow, float* __restrict__ y,
                                      long long ly, int ld, int k, int tid) {
    if (k % 4 == 0 && ld % 4 == 0) {
        const int q4 = k / 4;
        for (int e = tid; e < R * q4; e += kConsumers) {
            const int r = e / q4, c = 4 * (e - r * q4);
            const float4 v = *reinterpret_cast<const float4*>(W + r * sw + c);
            if (yrow + r < ly && (v.x != 0.0f || v.y != 0.0f || v.z != 0.0f || v.w != 0.0f))
                atomicAdd(reinterpret_cast<float4*>(y + (yrow + r) * ld + c), v);
        }
        return;
    }
    if (k % 2 == 0 && ld % 2 == 0) {
        const int q2 = k / 2;
        for (int e = tid; e < R * q2; e += kConsumers) {
            const int r = e / q2, c = 2 * (e - r * q2);
            const float2 v = *reinterpret_cast<const float2*>(W + r * sw + c);
            if (yrow + r < ly && (v.x != 0.0f || v.y != 0.0f))
                atomicAdd(reinterpret_cast<float2*>(y + (yrow + r) * ld + c), v);
        }
        return;
    }
    for (int e = tid; e < R * k; e += kConsumers) {
        const int r = e / k, c = e - r * k;
        const float v = W[r * sw + c];
        if (yrow + r < ly && v != 0.0f) atomicAdd(y + (yrow + r) * ld + c, v);
    }
}

// y[row, col], y[row, col + 1] += v0, v1 (col even), skipping zeros and
// columns past k; one float2 atomic where k is even.
__device__ __forceinline__ void add_pair(float* __restrict__ y, long long row,
                                         long long ly, int ld, int k, int col,
                                         float v0, float v1) {
    if (row >= ly || col >= k || (v0 == 0.0f && v1 == 0.0f)) return;
    float* p = y + row * ld + col;
    if (col + 1 < k && ld % 2 == 0) {
        atomicAdd(reinterpret_cast<float2*>(p), make_float2(v0, v1));
        return;
    }
    if (v0 != 0.0f) atomicAdd(p, v0);
    if (col + 1 < k && v1 != 0.0f) atomicAdd(p + 1, v1);
}

// Adds an m16n8 accumulator tile (c[0..1]: row g, columns 2tq, 2tq + 1;
// c[2..3]: row g + 8) at y rows row_g / row_g + 8 (each only if its flag
// is set), columns col0 + ...  Where k and ld are multiples of 4, lane
// pairs (tq, tq ^ 1) trade halves so that each lane holds 4 consecutive
// columns of one row and adds them with one float4 atomic; else float2.
__device__ __forceinline__ void add_tile(float* __restrict__ y, long long row_g,
                                         bool ok_g, bool ok_g8, long long ly,
                                         int ld, int k, int col0,
                                         const float (&c)[4], int lane) {
    const int tq = lane & 3;
    if (k % 4 == 0 && ld % 4 == 0) {  // uniform over the warp
        const bool odd = tq & 1;
        const float r0 = __shfl_xor_sync(0xffffffffu, odd ? c[0] : c[2], 1);
        const float r1 = __shfl_xor_sync(0xffffffffu, odd ? c[1] : c[3], 1);
        const long long row = odd ? row_g + 8 : row_g;
        const int col = col0 + 4 * (tq >> 1);
        const float4 v = odd ? make_float4(r0, r1, c[2], c[3])
                             : make_float4(c[0], c[1], r0, r1);
        if ((odd ? ok_g8 : ok_g) && row < ly && col < k
            && (v.x != 0.0f || v.y != 0.0f || v.z != 0.0f || v.w != 0.0f))
            atomicAdd(reinterpret_cast<float4*>(y + row * ld + col), v);
        return;
    }
    if (ok_g) add_pair(y, row_g, ly, ld, k, col0 + 2 * tq, c[0], c[1]);
    if (ok_g8) add_pair(y, row_g + 8, ly, ld, k, col0 + 2 * tq, c[2], c[3]);
}

// COL strip: y[yrow0 + j, :] += sum_rr op(F[rr, j]) w[rr, :] for j < wj;
// work units of one m16 tile of output rows x 4 n8 tiles, dealt to the
// warps.  k counts real columns; complex: Fr^T w + (cs Fi)^T (i w).
template <typename T>
__device__ __forceinline__ void tc_col_strip(const T* F, const float* W,
                                             int SF, int sw, int R, int wj,
                                             long long yrow0, float cs,
                                             float* __restrict__ y,
                                             long long ly, int ld, int k,
                                             int warp, int lane) {
    constexpr bool CX = kE<T> == 2;
    constexpr int NTW = 4;
    const int NT = (k + 7) / 8, NG = (NT + NTW - 1) / NTW, MT = (wj + 15) / 16;
    const int g = lane >> 2, tq = lane & 3;
    for (int u = warp; u < MT * NG; u += kConsumerWarps) {
        const int mt = u / NG, n0 = (u - mt * NG) * NTW;
        const int m0 = mt * 16 + g, m1 = m0 + 8;
        float acc[NTW][4] = {};
        for (int kk = 0; kk < R; kk += 8) {
            const int q0 = kk + tq, q1 = q0 + 4;
            T a[4];
            a[0] = (q0 < R && m0 < wj) ? F[q0 * SF + m0] : T{};
            a[1] = (q0 < R && m1 < wj) ? F[q0 * SF + m1] : T{};
            a[2] = (q1 < R && m0 < wj) ? F[q1 * SF + m0] : T{};
            a[3] = (q1 < R && m1 < wj) ? F[q1 * SF + m1] : T{};
            uint32_t ahi[4], alo[4], ihi[4], ilo[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                if constexpr (CX) {
                    split_tf32(a[q].x, ahi[q], alo[q]);
                    split_tf32(cs * a[q].y, ihi[q], ilo[q]);
                } else {
                    split_tf32(a[q], ahi[q], alo[q]);
                }
            }
#pragma unroll
            for (int i = 0; i < NTW; ++i) {
                const int col = (n0 + i) * 8 + g;
                if (n0 + i >= NT) break;
                mma3(acc[i], ahi, alo, xval<false>(W, q0, sw, col, q0 < R && col < k),
                     xval<false>(W, q1, sw, col, q1 < R && col < k));
                if constexpr (CX)
                    mma3(acc[i], ihi, ilo, xval<true>(W, q0, sw, col, q0 < R && col < k),
                         xval<true>(W, q1, sw, col, q1 < R && col < k));
            }
        }
#pragma unroll
        for (int i = 0; i < NTW; ++i) {
            if (n0 + i >= NT) break;
            add_tile(y, yrow0 + m0, m0 < wj, m1 < wj, ly, ld, k, (n0 + i) * 8,
                     acc[i], lane);
        }
    }
}

// ---- the kernel ---------------------------------------------------------

// One launch walks items [0, n_items) with a persistent grid: CTA b takes
// items b, b + gridDim.x, ...  Shared memory: kStages stages of stage_floats
// (a Strip header, then the factor strip and its x rows), then w (kMaxRows
// x sx floats), then the 2 x kStages barriers.  T: float (K1) or float2
// (K2).  KC: 1, 2, 4, 8 (FFMA, k <= KC) or kTC (tensor cores, 9 <= k and
// k E <= kMaxCols).  x and y rows have stride ld (>= k) elements: a pass
// over columns [c0, c0 + k) of a wider x gets x + c0, y + c0.  conj_fwd /
// conj_tr: complex data only.
template <typename T, int KC>
__global__ void __launch_bounds__(kThreads, 1)
hmatrix_product_kernel(const Item* __restrict__ items, long long n_items,
                       const T* __restrict__ x, long long lx,
                       T* __restrict__ y, long long ly, int ld, int k,
                       int swapped, int symmetric, int conj_fwd, int conj_tr,
                       int stage_floats) {
    constexpr int E = kE<T>;
    extern __shared__ float4 smem4[];
    float* ring = reinterpret_cast<float*>(smem4);
    const int sx = x_stride(KC, k, E);  // floats
    float* W = ring + (long long)kStages * stage_floats;
    uint64_t* full = reinterpret_cast<uint64_t*>(W + kMaxRows * sx);
    uint64_t* empty = full + kStages;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int body = stage_floats - kHeaderFloats;  // floats after the header
    if (threadIdx.x == 0) {
        for (int q = 0; q < kStages; ++q) {
            mbar_init(full + q, 33);  // expect_tx arrival + 32 cp.async lanes
            mbar_init(empty + q, kConsumerWarps);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (warp == kConsumerWarps) {  // the producer warp
        const float* xf = reinterpret_cast<const float*>(x);
        int stage = 0;
        uint32_t parity = 0;
        long long it = blockIdx.x;
        Item cur;
        if (it < n_items) cur = items[it];
        for (; it < n_items; it += gridDim.x) {
            // the next item's record is read while this one streams
            const long long nx = it + gridDim.x;
            const Item next = nx < n_items ? items[nx] : cur;
            Phase ph[4];
            const int np = item_phases(cur, swapped, symmetric, conj_fwd,
                                       conj_tr, ph);
            for (int q = 0; q < np; ++q) {
                int J, SF;
                geometry(ph[q], sx, body, KC != kTC, E, J, SF);
                for (int j0 = 0; j0 < ph[q].width; j0 += J) {
                    mbar_wait(empty + stage, parity ^ 1);
                    float* S = ring + (long long)stage * stage_floats;
                    const int flags = (j0 == 0 ? kFirst : 0)
                                      | (j0 + J >= ph[q].width ? kLast : 0);
                    produce_strip(ph[q], J, SF, j0, flags, E, S + kHeaderFloats,
                                  reinterpret_cast<Strip*>(S), full + stage, xf,
                                  lx, ld * E, k * E, sx, lane);
                    if (++stage == kStages) { stage = 0; parity ^= 1; }
                }
            }
            cur = next;
        }
        // the end: a header with no copies
        mbar_wait(empty + stage, parity ^ 1);
        float* S = ring + (long long)stage * stage_floats;
        if (lane == 0) {
            *reinterpret_cast<Strip*>(S) = Strip{0, 0, 0, 0, 0, 0, kDone};
            mbar_arrive_expect_tx(full + stage, 0);
        }
        __syncwarp();
        mbar_arrive_cp_async(full + stage);
        asm volatile("cp.async.wait_all;\n" ::: "memory");
        return;
    }

    // the consumer warps: driven by the stage headers alone
    const int tid = threadIdx.x;
    float* yf = reinterpret_cast<float*>(y);
    int stage = 0;
    uint32_t parity = 0;
    constexpr int AR = KC == kTC ? 8 : kRowsPerWarp<T>, AC = KC == kTC ? 4 : KC;
    using Acc = std::conditional_t<KC == kTC, float, T>;
    Acc acc[AR][AC];
    for (;;) {
        mbar_wait(full + stage, parity);
        const float* S = ring + (long long)stage * stage_floats;
        const Strip h = *reinterpret_cast<const Strip*>(S);
        if (h.flags & kDone) break;
        const T* F = reinterpret_cast<const T*>(S + kHeaderFloats);
        const float* X = S + kHeaderFloats + h.xbase;  // x strip (ROW) or w rows (COL_X)
        const float cs = (h.flags & kConj) ? -1.0f : 1.0f;
        if (is_row(h.kind) && (h.flags & kFirst)) {
#pragma unroll
            for (int i = 0; i < AR; ++i)
#pragma unroll
                for (int c = 0; c < AC; ++c) acc[i][c] = Acc{};
        }
        const float* w = h.kind == COL_X ? X : W;
        if constexpr (KC == kTC) {
            if (is_row(h.kind))
                tc_row_strip(F, X, h.SF, sx, h.R, h.wj, k * E, cs, warp, lane, acc);
            else
                tc_col_strip(F, w, h.SF, sx, h.R, h.wj, h.yrow, cs, yf, ly,
                             ld * E, k * E, warp, lane);
        } else {
            if (is_row(h.kind))
                fma_row_strip<T, KC>(F, reinterpret_cast<const T*>(X), h.SF, h.R,
                                     h.wj, cs, warp, lane, acc);
            else
                fma_col_strip<T, KC>(F, reinterpret_cast<const T*>(w), h.SF, h.R,
                                     h.wj, h.yrow, cs, y, ly, ld, k, tid);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + stage);
        if (++stage == kStages) { stage = 0; parity ^= 1; }
        if (!(h.flags & kLast)) continue;
        // the end of a phase.  w written (ROW_W) before COL reads it; read
        // (COL_W) before the next ROW_W writes it.
        if (is_row(h.kind)) {
            if constexpr (KC == kTC) {
                tc_row_finish(h.R, W, sx, acc, k * E, warp, lane);
                consumer_sync();
                if (h.kind == ROW_Y) {
                    add_w(W, sx, h.R, h.yrow, yf, ly, ld * E, k * E, tid);
                    consumer_sync();
                }
            } else {
                fma_row_finish<T, KC>(h, reinterpret_cast<T*>(W), acc, warp,
                                      lane, tid, y, ly, ld, k);
                if (h.kind == ROW_W) consumer_sync();
            }
        } else if (h.kind == COL_W) {
            consumer_sync();
        }
    }
}

// ---- launch -------------------------------------------------------------

// Shared memory of one launch: the card's opt-in maximum per block, so one
// CTA fills an SM; the stages share what w and the barriers leave.
struct Plan { size_t bytes; int stage_floats, optin; };

cudaError_t smem_plan(int KC, int k, int E, Plan* plan) {
    int device = 0, optin = 0;
    cudaError_t e = cudaGetDevice(&device);
    if (e != cudaSuccess) return e;
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (e != cudaSuccess) return e;
    const size_t fixed = (size_t)kMaxRows * x_stride(KC, k, E) * 4 + 2 * kStages * 8;
    const int stage_floats = (int)(((optin - fixed) / 4 / kStages) & ~(size_t)3);
    *plan = Plan{(size_t)kStages * stage_floats * 4 + fixed, stage_floats, optin};
    return cudaSuccess;
}

// Resident CTAs of the whole card for an instantiation (E, KC) and smem,
// computed once per (device, E, KC, smem) and kept.
struct GridEntry { int device, inst; size_t smem; int grid; };
GridEntry g_grids[64];
int g_n_grids = 0;

template <typename Kernel>
cudaError_t persistent_grid(Kernel kernel, int inst, size_t smem, int optin,
                            int* grid) {
    int device = 0;
    cudaError_t e = cudaGetDevice(&device);
    if (e != cudaSuccess) return e;
    for (int q = 0; q < g_n_grids; ++q) {
        if (g_grids[q].device == device && g_grids[q].inst == inst
            && g_grids[q].smem == smem) {
            *grid = g_grids[q].grid;
            return cudaSuccess;
        }
    }
    // always the card's maximum, so that no launch of this instantiation
    // ever asks for more than the attribute allows
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (e != cudaSuccess) return e;
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (e != cudaSuccess) return e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
    if (e != cudaSuccess) return e;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    *grid = sms * per_sm;
    if (g_n_grids < 64) g_grids[g_n_grids++] = GridEntry{device, inst, smem, *grid};
    return cudaSuccess;
}

// Calls f with the instantiation (KC, a std::integral_constant) that a
// pass of k columns of E floats runs: FFMA over KC >= k columns up to
// kFmaCols*, the tensor cores above.
template <int E, typename F>
cudaError_t with_instantiation(int k, F f) {
    if (k > (E == 1 ? kFmaColsReal : kFmaColsComplex))
        return f(std::integral_constant<int, kTC>{});
    if (k > 4) return f(std::integral_constant<int, 8>{});
    if (k > 2) return f(std::integral_constant<int, 4>{});
    if (k == 2) return f(std::integral_constant<int, 2>{});
    return f(std::integral_constant<int, 1>{});
}

// Every item of [items, items + n_items) in one launch per pass of at most
// kMaxCols / E columns.
template <typename T>
cudaError_t launch_items(const void* items, long long n_items, const T* x,
                         long long lx, T* y, long long ly, int k,
                         int swapped, int symmetric, int conj_fwd, int conj_tr,
                         cudaStream_t st) {
    constexpr int E = kE<T>, pass = kMaxCols / E;
    if (n_items == 0 || k == 0) return cudaSuccess;
    for (int c0 = 0; c0 < k; c0 += pass) {
        const int kc = k - c0 < pass ? k - c0 : pass;
        cudaError_t e = with_instantiation<E>(kc, [&](auto tag) {
            constexpr int KC = decltype(tag)::value;
            Plan plan;
            cudaError_t err = smem_plan(KC, kc, E, &plan);
            if (err != cudaSuccess) return err;
            int resident = 0;
            err = persistent_grid(hmatrix_product_kernel<T, KC>, KC + 16 * E,
                                  plan.bytes, plan.optin, &resident);
            if (err != cudaSuccess) return err;
            const long long grid = n_items < resident ? n_items : resident;
            hmatrix_product_kernel<T, KC><<<(unsigned)grid, kThreads, plan.bytes, st>>>(
                static_cast<const Item*>(items), n_items, x + c0, lx, y + c0, ly, k,
                kc, swapped, symmetric, conj_fwd, conj_tr, plan.stage_floats);
            return cudaGetLastError();
        });
        if (e != cudaSuccess) return e;
    }
    return cudaSuccess;
}

// One launch per bucket over that bucket's items.  `ranges` is a host
// int64 array of n_buckets (first item, item count) pairs into
// items_by_bucket; every launch adds into the same y.
template <typename T>
cudaError_t launch_per_bucket(const void* items_by_bucket, const long long* ranges,
                              int n_buckets, const T* x, long long lx, T* y,
                              long long ly, int k, int swapped, int symmetric,
                              int conj_fwd, int conj_tr, cudaStream_t st) {
    const Item* items = static_cast<const Item*>(items_by_bucket);
    for (int b = 0; b < n_buckets; ++b) {
        const cudaError_t e = launch_items(
            items + ranges[2 * b], ranges[2 * b + 1], x, lx, y, ly, k, swapped,
            symmetric, conj_fwd, conj_tr, st);
        if (e != cudaSuccess) return e;
    }
    return cudaSuccess;
}

}  // namespace

// Plain C interface, loaded with ctypes.  `items` is a device array of
// n_items work-item records (struct Item, 48 bytes); x (lx, k) and y (ly,
// k) row-major, float32 (hm_k1_*) or complex64, interleaved re / im
// (hm_k2_*), y zeroed by the caller.  K2's conj_fwd / conj_tr conjugate the
// operator in the x[s:] -> y[t:] and the x[t:] -> y[s:] direction.  Each
// returns the cudaError_t of its launches (0 on success).

// 'fused': the work list ordered largest first.
extern "C" int hm_k1_launch(const void* items, long long n_items, const float* x,
                            long long lx, float* y, long long ly, int k,
                            int swapped, int symmetric, void* stream) {
    return launch_items(items, n_items, x, lx, y, ly, k, swapped, symmetric, 0, 0,
                        static_cast<cudaStream_t>(stream));
}

// K1-al: the same launch over data in the aligned low-rank layout (every
// low-rank block's offsets a multiple of 8 rows, its widths multiples of 8),
// where every x strip of a low-rank block is one aligned run and every
// output window starts on a multiple of 8 rows.
extern "C" int hm_k1_launch_al(const void* items, long long n_items, const float* x,
                               long long lx, float* y, long long ly, int k,
                               int swapped, int symmetric, void* stream) {
    return launch_items(items, n_items, x, lx, y, ly, k, swapped, symmetric, 0, 0,
                        static_cast<cudaStream_t>(stream));
}

// 'seq' (K1-seq): the persistent grid over the work list in bucket order.
extern "C" int hm_k1_launch_seq(const void* items_by_bucket, long long n_items,
                                const float* x, long long lx, float* y,
                                long long ly, int k, int swapped, int symmetric,
                                void* stream) {
    return launch_items(items_by_bucket, n_items, x, lx, y, ly, k, swapped,
                        symmetric, 0, 0, static_cast<cudaStream_t>(stream));
}

// 'per_bucket' (K1-pb): one launch per bucket over that bucket's items.
extern "C" int hm_k1_launch_per_bucket(const void* items_by_bucket,
                                       const long long* ranges, int n_buckets,
                                       const float* x, long long lx, float* y,
                                       long long ly, int k, int swapped,
                                       int symmetric, void* stream) {
    return launch_per_bucket(items_by_bucket, ranges, n_buckets, x, lx, y, ly, k,
                             swapped, symmetric, 0, 0,
                             static_cast<cudaStream_t>(stream));
}

// K2 ('fused'), K2-seq and K2-pb: the same over complex64 data and x.
extern "C" int hm_k2_launch(const void* items, long long n_items, const void* x,
                            long long lx, void* y, long long ly, int k,
                            int swapped, int symmetric, int conj_fwd,
                            int conj_tr, void* stream) {
    return launch_items(items, n_items, static_cast<const float2*>(x), lx,
                        static_cast<float2*>(y), ly, k, swapped, symmetric,
                        conj_fwd, conj_tr, static_cast<cudaStream_t>(stream));
}

extern "C" int hm_k2_launch_seq(const void* items_by_bucket, long long n_items,
                                const void* x, long long lx, void* y,
                                long long ly, int k, int swapped, int symmetric,
                                int conj_fwd, int conj_tr, void* stream) {
    return launch_items(items_by_bucket, n_items, static_cast<const float2*>(x),
                        lx, static_cast<float2*>(y), ly, k, swapped, symmetric,
                        conj_fwd, conj_tr, static_cast<cudaStream_t>(stream));
}

extern "C" int hm_k2_launch_per_bucket(const void* items_by_bucket,
                                       const long long* ranges, int n_buckets,
                                       const void* x, long long lx, void* y,
                                       long long ly, int k, int swapped,
                                       int symmetric, int conj_fwd, int conj_tr,
                                       void* stream) {
    return launch_per_bucket(items_by_bucket, ranges, n_buckets,
                             static_cast<const float2*>(x), lx,
                             static_cast<float2*>(y), ly, k, swapped, symmetric,
                             conj_fwd, conj_tr, static_cast<cudaStream_t>(stream));
}

// The user-numbering permutations around a product (ops/cuda_matvec.py
// `apply_hmatrix_user_cuda`).  They replace no TPU kernel: the reference
// keeps x[perm_in], the padding and y[:nout][inv_out] inside its one jitted
// program (htool_python_tpu/ops/matvec.py `apply_hmatrix_user`), which XLA
// fuses.  Their plain versions are `permute_in` / `permute_out` in
// htool_python_torch/ops/matvec.py.
//
//  * permute-in: x_pad[i] = x[perm[i]] for i < n, zero rows up to pad_len,
//    and the product's y (ny rows) zeroed, all in one launch;
//  * permute-out: out[j] = y[inv[j]] for j < nout.
//
// What bounds them: bytes.  Each moves its rows once (x_pad and y written,
// x and y read, one 4-byte index a row), a few MB at the benchmark's shapes
// (0.8 MB at N = 40 000, k = 1; 32 MB at N = 100 000, 8 complex columns),
// so at k = 1 they are as short as a launch.  Both copy whole rows of
// row_bytes bytes and never look at the elements, so one body serves
// float32, complex64, float64 and complex128: the rows move in vectors of
// 16 bytes where the row length and every pointer allow it, else 8 or 4.
// A row's vectors go to 2^shift consecutive threads (the least power of
// two at or above the row's vector count, at most 32), so a warp reads
// whole rows, or 32 consecutive vectors of one, and neighbouring threads
// touch neighbouring addresses; there is no division per element.
// The kernels trust the indices (a permutation, as HMatrix builds them);
// the wrapper checks every size.

namespace {

constexpr int kPermThreads = 256;
constexpr long long kPermMaxBlocks = 32768;  // the rest by a grid-stride loop

// The rows a thread's group of 2^shift threads walks (r, r + step, ...)
// and the thread's first vector of each (lane, stepping by width).
struct RowWalk {
    long long r, step;
    int lane, width;
    __device__ RowWalk(int shift) {
        const int per_block = kPermThreads >> shift;
        r = (long long)blockIdx.x * per_block + (threadIdx.x >> shift);
        step = (long long)gridDim.x * per_block;
        lane = threadIdx.x & ((1 << shift) - 1);
        width = 1 << shift;
    }
};

template <typename V>
__device__ __forceinline__ void copy_row(V* __restrict__ dst, const V* __restrict__ src,
                                         int row, const RowWalk& w) {
    for (int c = w.lane; c < row; c += w.width) dst[c] = src[c];
}

template <typename V>
__device__ __forceinline__ void zero_row(V* __restrict__ dst, int row,
                                         const RowWalk& w) {
    for (int c = w.lane; c < row; c += w.width) dst[c] = V{};
}

// Rows [0, pad_len) of x_pad, then rows [0, ny) of y, as one row space.
template <typename V>
__global__ void __launch_bounds__(kPermThreads)
user_permute_in_kernel(const V* __restrict__ x, const int* __restrict__ perm,
                       long long n, V* __restrict__ x_pad, long long pad_len,
                       V* __restrict__ y, long long ny, int row, int shift) {
    RowWalk w(shift);
    for (; w.r < pad_len + ny; w.r += w.step) {
        if (w.r < n)
            copy_row(x_pad + w.r * row, x + (long long)perm[w.r] * row, row, w);
        else if (w.r < pad_len)
            zero_row(x_pad + w.r * row, row, w);
        else
            zero_row(y + (w.r - pad_len) * row, row, w);
    }
}

template <typename V>
__global__ void __launch_bounds__(kPermThreads)
user_permute_out_kernel(const V* __restrict__ y, const int* __restrict__ inv,
                        long long nout, V* __restrict__ out, int row, int shift) {
    RowWalk w(shift);
    for (; w.r < nout; w.r += w.step)
        copy_row(out + w.r * row, y + (long long)inv[w.r] * row, row, w);
}

// Calls f with a zero vector of the widest type (16, 8 or 4 bytes) that
// divides row_bytes and every address in `addresses` (OR-ed together).
template <typename F>
cudaError_t with_row_vector(long long row_bytes, uintptr_t addresses, F f) {
    const uintptr_t a = (uintptr_t)row_bytes | addresses;
    if (a % 16 == 0) return f(uint4{});
    if (a % 8 == 0) return f(uint2{});
    if (a % 4 == 0) return f(0u);
    return cudaErrorInvalidValue;  // rows of whole 4-byte elements only
}

// (grid, shift) of a launch over `rows` rows of `row` vectors.
void row_grid(long long rows, int row, unsigned* grid, int* shift) {
    int s = 0;
    while ((1 << s) < row && s < 5) ++s;
    const long long per_block = kPermThreads >> s;
    long long blocks = (rows + per_block - 1) / per_block;
    *grid = (unsigned)(blocks < kPermMaxBlocks ? blocks : kPermMaxBlocks);
    *shift = s;
}

}  // namespace

// x (n rows), x_pad (pad_len rows) and y (ny rows) are row-major with rows
// of row_bytes bytes; perm is n int32 row numbers of x.  Returns the
// cudaError_t of the launch (cudaErrorInvalidValue for a row that is not a
// whole number of 4-byte words, or n > pad_len); no launch for no bytes.
extern "C" int hm_permute_in(const void* x, const int* perm, long long n,
                             void* x_pad, long long pad_len, void* y,
                             long long ny, long long row_bytes, void* stream) {
    if (n < 0 || n > pad_len || ny < 0 || row_bytes < 0)
        return cudaErrorInvalidValue;
    if (row_bytes == 0 || pad_len + ny == 0) return cudaSuccess;
    const uintptr_t addresses = (uintptr_t)x | (uintptr_t)x_pad | (uintptr_t)y;
    return with_row_vector(row_bytes, addresses, [&](auto zero) {
        using V = decltype(zero);
        const int row = (int)(row_bytes / sizeof(V));
        unsigned grid;
        int shift;
        row_grid(pad_len + ny, row, &grid, &shift);
        user_permute_in_kernel<V><<<grid, kPermThreads, 0,
                                    static_cast<cudaStream_t>(stream)>>>(
            static_cast<const V*>(x), perm, n, static_cast<V*>(x_pad), pad_len,
            static_cast<V*>(y), ny, row, shift);
        return cudaGetLastError();
    });
}

// out (nout rows) = y rows inv[0..nout), rows of row_bytes bytes.
extern "C" int hm_permute_out(const void* y, const int* inv, long long nout,
                              void* out, long long row_bytes, void* stream) {
    if (nout < 0 || row_bytes < 0) return cudaErrorInvalidValue;
    if (row_bytes == 0 || nout == 0) return cudaSuccess;
    const uintptr_t addresses = (uintptr_t)y | (uintptr_t)out;
    return with_row_vector(row_bytes, addresses, [&](auto zero) {
        using V = decltype(zero);
        const int row = (int)(row_bytes / sizeof(V));
        unsigned grid;
        int shift;
        row_grid(nout, row, &grid, &shift);
        user_permute_out_kernel<V><<<grid, kPermThreads, 0,
                                     static_cast<cudaStream_t>(stream)>>>(
            static_cast<const V*>(y), inv, nout, static_cast<V*>(out), row,
            shift);
        return cudaGetLastError();
    });
}

extern "C" const char* hm_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
