// Kernel K1: the real f32 bucketed H-matrix product y = H^(trans) x on Hopper.
//
// Replaces the TPU kernel `apply_hmatrix_pallas` of
// htool_python_tpu/ops/pallas_matvec.py:538 (its fused launch
// `_launch_fused` :756, `_fused_kernel` / `_step_body` / `_term_fwd` /
// `_term_tr`); the same body serves the reference's per-bucket (:522,
// K1-pb) and sequential (:649, K1-seq) launch structures and its aligned
// low-rank step (`_step_body` kind "alr" :355-378, K1-al).  Its plain
// PyTorch version is `apply_hmatrix_padded` in
// htool_python_torch/ops/matvec.py (and `apply_work_list` there walks the
// same work items); the wrapper is htool_python_torch/ops/cuda_matvec.py.
//
// What it computes.  The operator is a list of buckets of equally padded
// blocks.  A dense block adds  y[t:t+pt] += D x[s:s+ps]  (D is pt x ps,
// row-major); a low-rank block adds  y[t:t+pt] += Ut^T (V x[s:s+ps])  with
// rank-major factors Ut (r x pt) and V (r x ps).  trans = 'T' applies the
// transposes from the target rows into the source rows.  Symmetric storage
// adds, for blocks flagged `mirror`, the opposite-direction term too; for
// real data both directions then run whatever `trans` is.  x and y are
// row-major (rows, k); y must be zeroed by the caller.
//
// What bounds it on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32 FFMA, 495
// TFLOP/s TF32 tensor cores).  Every stored entry is used for 2 flops per
// column.  At k <= 8 that is at most 4 flops a byte: the product is bound
// by the bytes it streams (the headline's 417 MB: 0.125 ms).  At k = 128
// it is 64 flops a byte: on the FFMA units the operations bound it (the
// headline's 26.7 GFLOP: 0.40 ms; the hlu operator's 6.1: 0.091 ms).  With
// the 3xTF32 split below (three TF32 products for each f32 one, at 495
// TFLOP/s) the headline is still bound by its operations (0.162 ms), and
// the hlu operator by its bytes, 95 MB of factors plus x and y (0.039 ms,
// just ahead of its 0.037 ms of operations).
//
// What the design does about it.
//  * A work list, not one CTA per block.  The wrapper's BucketTable builds
//    it once (ops/matvec.py `work_list`, ops/cuda_matvec.py
//    `_item_records`): one item per dense block slice of at most kMaxRows
//    rows, and one per low-rank block slice of at most kMaxRows rank rows
//    (U V is the sum of its rank slices, so a slice is a low-rank block of
//    its own).  Every stored entry belongs to exactly one item; items are
//    ordered largest first, ties shuffled so that items running at the
//    same time seldom add into the same rows of y.  Each item is one
//    48-byte record holding its factor addresses, offsets, rows, widths and
//    flags: the producer reads one record per item (the next one while the
//    current one streams) and nothing else about it.  For a low-rank item
//    the whole w = V x[s] (R x k) is needed before its Ut part: one item per
//    slice, its factors streamed through the ring, w kept in shared memory.
//  * All k columns in one CTA (up to kMaxCols; a wider x runs in passes of
//    kMaxCols columns, each reading every stored byte once).  A stored byte
//    is read once per direction it is used in: a mirrored block under
//    symmetric storage runs both directions and streams its factors twice.
//  * Bulk async copies into a shared-memory ring.  Each block's D, V and
//    Ut are contiguous, 16-byte aligned runs (BucketTable checks it).  A
//    factor is streamed in strips of J columns (all the item's rows), or
//    whole where it fits a stage at k <= 8: one producer warp issues one
//    `cp.async.bulk` (1-D TMA, no tensor map) per factor row of a strip, or
//    one for a whole factor, and one for the x rows the strip contracts
//    with where they are one run (on the tensor-core path, into padded
//    rows: one bulk copy per row, or 16-byte cp.async below 64 columns;
//    4-byte cp.async where x's rows are not 16-byte aligned), into a ring
//    of kStages stages guarded by full / empty `mbarrier`s.  Each stage
//    starts with a header (struct Strip) that the producer writes: the 8
//    consumer warps are driven by the headers alone and read nothing from
//    device memory but the stages.  The grid is persistent: one CTA per SM
//    (the ring takes the SM's shared memory), each walking items b, b +
//    grid, ...  In flight per SM: up to 3 stages of ~76 KB (k <= 8) or ~66
//    KB (k = 128), against the ~3.35 TB/s x ~1 us / 132 SMs = 25 KB that
//    DRAM latency asks for; the stage count is set by the producer's fixed
//    time per strip (kStages).
//  * k <= 8: the consumers run FFMA on the strip in shared memory, one warp
//    per factor row for w = V x (lane sums reduced once per phase), one
//    thread per output row for Ut^T w; f32 atomics into y, float4 / float2
//    where the row segment is aligned (k = 4, 8), and at k <= 2 over 4 / 2
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
//    rows x k columns at once.  What bounds this path in practice is not
//    the arithmetic: every block re-reads its k-column x segment and adds
//    a pt x k tile into y, so at k = 128 the headline moves ~1.3 GB of x
//    and ~1.4 GB of y through L2 (row ownership of y, and blocks that share
//    an x segment sharing its read, are later work).
//
// Registers and spills (nvcc -Xptxas -v, sm_90a, CUDA 12.8): KC = 1, 2, 4,
// 8 and the tensor-core instantiation use 80, 80, 95, 145 and 128
// registers (one 288-thread CTA an SM allows 224), no spills, 160 bytes
// of stack (the producer's phases of an item).
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
constexpr int kMaxCols = 128;   // columns of one pass
// Stages of the ring.  Each strip costs the producer a fixed time (its
// header, its barriers, one bulk copy per factor row), so fewer, larger
// stages stream faster, down to 3 (PERF.md, profiling/k1_variants.py).
constexpr int kStages = 3;
constexpr int kTC = 0;          // KC value of the tensor-core instantiation
constexpr int kSlack = 8;       // floats of an x window's alignment shift

// A work item, as BucketTable packs it (ops/cuda_matvec.py `_item_records`):
// rows [lo, lo + R) of one block.  Low-rank: a = Ut + (block r + lo) pt,
// v = V + (block r + lo) ps (rank rows, each a contiguous row of pt / ps
// floats); dense: a = D + (block pt + lo) ps, t already + lo.
struct Item {
    long long a, v;
    int t, s, R, pt, ps, flags;  // flags: kDense | kMirror
    long long pad;
};
constexpr int kDense = 1, kMirror = 2;

// What one pass over a factor F (R rows of `width` floats, contiguous)
// does.  ROW_*: contract F's columns with x rows [xoff, xoff + width) into
// R x k sums, kept in shared memory as w (ROW_W) or added into y rows
// [yoff, yoff + R) (ROW_Y, a dense block).  COL_*: y rows [yoff, yoff +
// width) += F^T w, with w from the previous ROW_W phase (COL_W) or the x
// rows [xoff, xoff + R) (COL_X, a dense block's transpose).
enum Kind { ROW_W, ROW_Y, COL_W, COL_X };

struct Phase {
    const float* F;
    long long xoff, yoff;
    int R, width, kind;
};

__device__ __forceinline__ bool is_row(int kind) { return kind <= ROW_Y; }

// The phases of an item, in the order the producer streams them.
__device__ __forceinline__ int item_phases(const Item& it, int swapped,
                                           int symmetric, Phase* ph) {
    const bool mirrored = symmetric && (it.flags & kMirror);
    const bool fwd = !swapped || mirrored;  // x[s:] -> y[t:]
    const bool tr = swapped || mirrored;    // x[t:] -> y[s:]
    const float* a = reinterpret_cast<const float*>(it.a);
    const float* v = reinterpret_cast<const float*>(it.v);
    int n = 0;
    if (it.flags & kDense) {
        if (fwd) ph[n++] = Phase{a, it.s, it.t, it.R, it.ps, ROW_Y};
        if (tr) ph[n++] = Phase{a, it.t, it.s, it.R, it.ps, COL_X};
    } else {
        if (fwd) {
            ph[n++] = Phase{v, it.s, 0, it.R, it.ps, ROW_W};
            ph[n++] = Phase{a, 0, it.t, it.R, it.pt, COL_W};
        }
        if (tr) {
            ph[n++] = Phase{a, it.t, 0, it.R, it.pt, ROW_W};
            ph[n++] = Phase{v, 0, it.s, it.R, it.ps, COL_W};
        }
    }
    return n;
}

// Row stride of x in shared memory and of w: KC at k <= 8; on the
// tensor-core path k rounded up to 8 and then to 8 mod 32 floats, so that
// an mma fragment of x or w (rows tq, columns g) hits 32 distinct banks.
__host__ __device__ __forceinline__ int x_stride(int KC, int k) {
    if (KC != kTC) return KC;
    const int kp = (k + 7) & ~7;
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
    int SF;           // row stride of the factor strip at the stage's start
    int xbase;        // where the x rows start in the stage (floats)
    int flags;        // kFirst | kLast (of the phase) | kDone (no more work)
};
constexpr int kFirst = 1, kLast = 2, kDone = 4;
constexpr int kHeaderFloats = 8;  // 32 bytes of header ahead of each stage

// Strip width J (a multiple of 16, or the whole width) and factor row
// stride SF of a phase.  ROW phases: SF = J + 4, so that an mma fragment's
// factor rows g fall on distinct banks; COL phases read the strip
// transposed: SF = 8 or 24 mod 32.  FFMA reads along rows only: where the
// whole factor fits a stage it is one unpadded run (one bulk copy).  The
// x rows follow the factor strip: J rows for ROW, R rows for COL_X.
__device__ __forceinline__ void geometry(const Phase& p, int sx, int stage,
                                         bool fma, int& J, int& SF) {
    const int xrows_per_col = is_row(p.kind) ? sx : 0;
    const int xfixed = (p.kind == COL_X ? p.R * sx : 0) + kSlack;
    if (fma && p.R * p.width + p.width * xrows_per_col + xfixed <= stage) {
        J = SF = p.width;
        return;
    }
    const int wpad = (p.width + 15) & ~15;
    if (is_row(p.kind)) {
        J = (stage - xfixed - 4 * p.R) / (p.R + sx);
    } else {
        J = (stage - xfixed - 24 * p.R) / p.R;
    }
    J = min(wpad, max(16, J & ~15));
    SF = is_row(p.kind) ? J + 4 : col_stride(J);
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

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void consumer_sync() {
    asm volatile("bar.sync 1, %0;\n" :: "n"(kConsumers) : "memory");
}

// ---- the producer warp -----------------------------------------------

// x rows [r0, r0 + nrows) (k columns, row stride ld; x holds lx rows)
// into X with row stride sx; returns the shift (floats) of the first row
// past X and adds the bulk bytes to *tx.  A contiguous run (sx == k ==
// ld) goes as one bulk copy of its 16-byte aligned window (the shift is
// the run's misalignment, at most 3); rows into a padded stride (the
// tensor-core path), where k and ld are multiples of 4, as one bulk copy
// per row from 64 columns up and as 16-byte cp.async below (a bulk copy
// costs the producer a fixed time, which rows of 128 bytes do not repay;
// PERF.md, profiling/k1_variants.py); else as 4-byte cp.async.
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
    }
    if (issue)
        for (int e = lane; e < nrows * k; e += 32) {
            const int q = e / k, c = e - q * k;
            cp_async4(X + q * sx + c, x + (r0 + q) * ld + c);
        }
    return 0;
}

// Issues the copies of one strip (columns [j0, j0 + wj) of phase p's
// factor, and its x rows) into stage S and writes the stage's header.
__device__ __forceinline__ void produce_strip(const Phase& p, int J, int SF,
                                              int j0, int flags, float* S,
                                              Strip* hdr, uint64_t* full,
                                              const float* __restrict__ x,
                                              long long lx, int ld, int k,
                                              int sx, int lane) {
    const int wj = min(J, p.width - j0);
    float* X = S + p.R * SF;
    uint32_t tx = (uint32_t)(p.R * wj * 4);
    int shift = 0;
    if (is_row(p.kind))
        shift = copy_x(X, x, lx, ld, k, sx, p.xoff + j0, wj, full, &tx, false, lane);
    else if (p.kind == COL_X)
        shift = copy_x(X, x, lx, ld, k, sx, p.xoff, p.R, full, &tx, false, lane);
    if (lane == 0) {
        *hdr = Strip{is_row(p.kind) ? p.yoff : p.yoff + j0, p.kind, p.R, wj, SF,
                     p.R * SF + shift, flags};
        mbar_arrive_expect_tx(full, tx);
    }
    __syncwarp();
    if (SF == J) {  // whole unpadded rows (geometry's FFMA case): one run
        if (lane == 0) bulk_copy(S, p.F, (uint32_t)(p.R * p.width * 4), full);
    } else {
        for (int rr = lane; rr < p.R; rr += 32)
            bulk_copy(S + rr * SF, p.F + (long long)rr * p.width + j0,
                      (uint32_t)(wj * 4), full);
    }
    if (is_row(p.kind))
        copy_x(X, x, lx, ld, k, sx, p.xoff + j0, wj, full, &tx, true, lane);
    else if (p.kind == COL_X)
        copy_x(X, x, lx, ld, k, sx, p.xoff, p.R, full, &tx, true, lane);
    mbar_arrive_cp_async(full);
}

// ---- k <= 8: FFMA on the strip ----------------------------------------

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

// KC consecutive floats from shared memory (16-byte aligned when KC is a
// multiple of 4, 8-byte aligned when KC == 2).
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

// y[yr, c] += acc[c] for c < k, skipping all-zero rows (a padded block
// row adds nothing).  vec: k == KC and the row segment is 16-byte aligned
// (8-byte for KC == 2), so Hopper's vector atomics add 4 (2) values at once.
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

// ROW strip: acc[i][c] += sum_jj F[rr, jj] X[jj, c] for the warp's rows
// rr = warp + 8 i (lane partial sums; reduced at the end of the phase).
template <int KC>
__device__ __forceinline__ void fma_row_strip(const float* F, const float* X,
                                              int SF, int R, int wj, int warp,
                                              int lane, float (&acc)[8][KC]) {
#pragma unroll 4
    for (int jj = lane; jj < wj; jj += 32) {
        float xv[KC];
        load_kc<KC>(X + jj * KC, xv);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            const int rr = warp + 8 * i;
            if (rr < R) {
                const float a = F[rr * SF + jj];
#pragma unroll
                for (int c = 0; c < KC; ++c) acc[i][c] = fmaf(a, xv[c], acc[i][c]);
            }
        }
    }
}

// End of a ROW phase: the warp's row sums into w (ROW_W) or y (ROW_Y).
template <int KC>
__device__ __forceinline__ void fma_row_finish(const Strip& h, float* W,
                                               float (&acc)[8][KC], int warp,
                                               int lane, float* __restrict__ y,
                                               long long ly, int ld, int k) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const int rr = warp + 8 * i;
        if (rr >= h.R) break;  // uniform in the warp
#pragma unroll
        for (int c = 0; c < KC; ++c) acc[i][c] = warp_sum(acc[i][c]);
        if (lane == 0) {
            if (h.kind == ROW_W) {
#pragma unroll
                for (int c = 0; c < KC; ++c) W[rr * KC + c] = acc[i][c];
            } else {
                add_row<KC>(y, h.yrow + rr, ly, ld, k, acc[i],
                            k == KC && KC > 1 && ld == k);
            }
        }
    }
}

// COL strip: y[yrow0 + jj, c] += sum_rr F[rr, jj] w[rr, c], one thread per
// output row; at k <= 2 on a window starting on a multiple of 4 / KC rows,
// each thread adds 4 / KC consecutive rows with one float4 atomic.
template <int KC>
__device__ __forceinline__ void fma_col_strip(const float* F, const float* W,
                                              int SF, int R, int wj,
                                              long long yrow0,
                                              float* __restrict__ y,
                                              long long ly, int ld, int k,
                                              int tid) {
    if constexpr (KC <= 2) {
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
        float acc[KC];
#pragma unroll
        for (int c = 0; c < KC; ++c) acc[c] = 0.0f;
#pragma unroll 4
        for (int rr = 0; rr < R; ++rr) {
            const float a = F[rr * SF + j];
            float wv[KC];
            load_kc<KC>(W + rr * KC, wv);
#pragma unroll
            for (int c = 0; c < KC; ++c) acc[c] = fmaf(a, wv[c], acc[c]);
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

__device__ __forceinline__ void tc_row_strip(const float* F, const float* X,
                                             int SF, int sx, int R, int wj,
                                             int k, int warp, int lane,
                                             float (&acc)[8][4]) {
    const RowTiles T = row_tiles(R, k, warp);
    if (T.idle) return;
    const int NT = (R + 7) / 8;
    const int g = lane >> 2, tq = lane & 3;
    const int m0 = T.col0 + g, m1 = m0 + 8;
    // the strip's sum in its own accumulators, added to acc in f32: the
    // tensor cores' f32 accumulation truncates, and a chain over a whole
    // 1024-wide factor drifts by ~1e-5 of |y|
    float part[8][4] = {};
    for (int kk = 8 * T.split; kk < wj; kk += 8 * T.S) {
        const int q0 = kk + tq, q1 = q0 + 4;
        float a[4];
        a[0] = (q0 < wj && m0 < k) ? X[q0 * sx + m0] : 0.0f;
        a[1] = (q0 < wj && m1 < k) ? X[q0 * sx + m1] : 0.0f;
        a[2] = (q1 < wj && m0 < k) ? X[q1 * sx + m0] : 0.0f;
        a[3] = (q1 < wj && m1 < k) ? X[q1 * sx + m1] : 0.0f;
        uint32_t ahi[4], alo[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) split_tf32(a[q], ahi[q], alo[q]);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            const int n = T.n0 + T.nstep * i;
            if (n >= NT) break;
            const int row = n * 8 + g;
            const float b0 = (row < R && q0 < wj) ? F[row * SF + q0] : 0.0f;
            const float b1 = (row < R && q1 < wj) ? F[row * SF + q1] : 0.0f;
            mma3(part[i], ahi, alo, b0, b1);
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

// y rows [yrow, yrow + R) += w (R x k in shared memory, stride sw): float4
// atomics where k and ld are multiples of 4.
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

// COL strip: y[yrow0 + j, :] += sum_rr F[rr, j] w[rr, :] for j < wj; work
// units of one m16 tile of output rows x 4 n8 tiles, dealt to the warps.
__device__ __forceinline__ void tc_col_strip(const float* F, const float* W,
                                             int SF, int sw, int R, int wj,
                                             long long yrow0,
                                             float* __restrict__ y,
                                             long long ly, int ld, int k,
                                             int warp, int lane) {
    constexpr int NTW = 4;
    const int NT = (k + 7) / 8, NG = (NT + NTW - 1) / NTW, MT = (wj + 15) / 16;
    const int g = lane >> 2, tq = lane & 3;
    for (int u = warp; u < MT * NG; u += kConsumerWarps) {
        const int mt = u / NG, n0 = (u - mt * NG) * NTW;
        const int m0 = mt * 16 + g, m1 = m0 + 8;
        float acc[NTW][4] = {};
        for (int kk = 0; kk < R; kk += 8) {
            const int q0 = kk + tq, q1 = q0 + 4;
            float a[4];
            a[0] = (q0 < R && m0 < wj) ? F[q0 * SF + m0] : 0.0f;
            a[1] = (q0 < R && m1 < wj) ? F[q0 * SF + m1] : 0.0f;
            a[2] = (q1 < R && m0 < wj) ? F[q1 * SF + m0] : 0.0f;
            a[3] = (q1 < R && m1 < wj) ? F[q1 * SF + m1] : 0.0f;
            uint32_t ahi[4], alo[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) split_tf32(a[q], ahi[q], alo[q]);
#pragma unroll
            for (int i = 0; i < NTW; ++i) {
                const int col = (n0 + i) * 8 + g;
                if (n0 + i >= NT) break;
                const float b0 = (q0 < R && col < k) ? W[q0 * sw + col] : 0.0f;
                const float b1 = (q1 < R && col < k) ? W[q1 * sw + col] : 0.0f;
                mma3(acc[i], ahi, alo, b0, b1);
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
// x sx), then the 2 x kStages barriers.  KC: 1, 2, 4, 8 (FFMA, k <= KC)
// or kTC (tensor cores, 9 <= k <= 128).  x and y rows have stride ld (>=
// k): a pass over columns [c0, c0 + k) of a wider x gets x + c0, y + c0.
template <int KC>
__global__ void __launch_bounds__(kThreads, 1)
hmatrix_product_kernel(const Item* __restrict__ items, long long n_items,
                       const float* __restrict__ x, long long lx,
                       float* __restrict__ y, long long ly, int ld, int k,
                       int swapped, int symmetric, int stage_floats) {
    extern __shared__ float4 smem4[];
    float* ring = reinterpret_cast<float*>(smem4);
    const int sx = x_stride(KC, k);
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
            const int np = item_phases(cur, swapped, symmetric, ph);
            for (int q = 0; q < np; ++q) {
                int J, SF;
                geometry(ph[q], sx, body, KC != kTC, J, SF);
                for (int j0 = 0; j0 < ph[q].width; j0 += J) {
                    mbar_wait(empty + stage, parity ^ 1);
                    float* S = ring + (long long)stage * stage_floats;
                    const int flags = (j0 == 0 ? kFirst : 0)
                                      | (j0 + J >= ph[q].width ? kLast : 0);
                    produce_strip(ph[q], J, SF, j0, flags, S + kHeaderFloats,
                                  reinterpret_cast<Strip*>(S), full + stage, x,
                                  lx, ld, k, sx, lane);
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
    int stage = 0;
    uint32_t parity = 0;
    constexpr int AC = KC == kTC ? 4 : KC;
    float acc[8][AC];
    for (;;) {
        mbar_wait(full + stage, parity);
        const float* S = ring + (long long)stage * stage_floats;
        const Strip h = *reinterpret_cast<const Strip*>(S);
        if (h.flags & kDone) break;
        const float* F = S + kHeaderFloats;
        const float* X = F + h.xbase;  // x strip (ROW) or w rows (COL_X)
        if (is_row(h.kind) && (h.flags & kFirst)) {
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
                for (int c = 0; c < AC; ++c) acc[i][c] = 0.0f;
        }
        const float* w = h.kind == COL_X ? X : W;
        if constexpr (KC == kTC) {
            if (is_row(h.kind))
                tc_row_strip(F, X, h.SF, sx, h.R, h.wj, k, warp, lane, acc);
            else
                tc_col_strip(F, w, h.SF, sx, h.R, h.wj, h.yrow, y, ly, ld, k,
                             warp, lane);
        } else {
            if (is_row(h.kind))
                fma_row_strip<KC>(F, X, h.SF, h.R, h.wj, warp, lane, acc);
            else
                fma_col_strip<KC>(F, w, h.SF, h.R, h.wj, h.yrow, y, ly, ld, k,
                                  tid);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + stage);
        if (++stage == kStages) { stage = 0; parity ^= 1; }
        if (!(h.flags & kLast)) continue;
        // the end of a phase.  w written (ROW_W) before COL reads it; read
        // (COL_W) before the next ROW_W writes it.
        if (is_row(h.kind)) {
            if constexpr (KC == kTC) {
                tc_row_finish(h.R, W, sx, acc, k, warp, lane);
                consumer_sync();
                if (h.kind == ROW_Y) {
                    add_w(W, sx, h.R, h.yrow, y, ly, ld, k, tid);
                    consumer_sync();
                }
            } else {
                fma_row_finish<KC>(h, W, acc, warp, lane, y, ly, ld, k);
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

cudaError_t smem_plan(int KC, int k, Plan* plan) {
    int device = 0, optin = 0;
    cudaError_t e = cudaGetDevice(&device);
    if (e != cudaSuccess) return e;
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (e != cudaSuccess) return e;
    const size_t fixed = (size_t)kMaxRows * x_stride(KC, k) * 4 + 2 * kStages * 8;
    const int stage_floats = (int)(((optin - fixed) / 4 / kStages) & ~(size_t)3);
    *plan = Plan{(size_t)kStages * stage_floats * 4 + fixed, stage_floats, optin};
    return cudaSuccess;
}

// Resident CTAs of the whole card for (KC, smem), computed once per
// (device, KC, smem) and kept.
struct GridEntry { int device, kc; size_t smem; int grid; };
GridEntry g_grids[64];
int g_n_grids = 0;

template <typename Kernel>
cudaError_t persistent_grid(Kernel kernel, int KC, size_t smem, int optin,
                            int* grid) {
    int device = 0;
    cudaError_t e = cudaGetDevice(&device);
    if (e != cudaSuccess) return e;
    for (int q = 0; q < g_n_grids; ++q) {
        if (g_grids[q].device == device && g_grids[q].kc == KC && g_grids[q].smem == smem) {
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
    if (g_n_grids < 64) g_grids[g_n_grids++] = GridEntry{device, KC, smem, *grid};
    return cudaSuccess;
}

// Calls f with the instantiation (KC, a std::integral_constant) that a
// pass of k columns runs: FFMA over KC >= k columns up to 8, the tensor
// cores above.
template <typename F>
cudaError_t with_instantiation(int k, F f) {
    if (k > 8) return f(std::integral_constant<int, kTC>{});
    if (k > 4) return f(std::integral_constant<int, 8>{});
    if (k > 2) return f(std::integral_constant<int, 4>{});
    if (k == 2) return f(std::integral_constant<int, 2>{});
    return f(std::integral_constant<int, 1>{});
}

// Every item of [items, items + n_items) in one launch per pass of at most
// kMaxCols columns.
cudaError_t launch_items(const void* items, long long n_items, const float* x,
                         long long lx, float* y, long long ly, int k,
                         int swapped, int symmetric, cudaStream_t st) {
    if (n_items == 0 || k == 0) return cudaSuccess;
    for (int c0 = 0; c0 < k; c0 += kMaxCols) {
        const int kc = k - c0 < kMaxCols ? k - c0 : kMaxCols;
        cudaError_t e = with_instantiation(kc, [&](auto tag) {
            constexpr int KC = decltype(tag)::value;
            Plan plan;
            cudaError_t err = smem_plan(KC, kc, &plan);
            if (err != cudaSuccess) return err;
            int resident = 0;
            err = persistent_grid(hmatrix_product_kernel<KC>, KC, plan.bytes, plan.optin,
                                  &resident);
            if (err != cudaSuccess) return err;
            const long long grid = n_items < resident ? n_items : resident;
            hmatrix_product_kernel<KC><<<(unsigned)grid, kThreads, plan.bytes, st>>>(
                static_cast<const Item*>(items), n_items, x + c0, lx, y + c0, ly, k,
                kc, swapped, symmetric, plan.stage_floats);
            return cudaGetLastError();
        });
        if (e != cudaSuccess) return e;
    }
    return cudaSuccess;
}

}  // namespace

// Plain C interface, loaded with ctypes.  `items` is a device array of
// n_items work-item records (struct Item, 48 bytes); x (lx, k) and y (ly,
// k) row-major, y zeroed by the caller.  Each returns the cudaError_t of
// its launches (0 on success).

// 'fused': the work list ordered largest first.
extern "C" int hm_k1_launch(const void* items, long long n_items, const float* x,
                            long long lx, float* y, long long ly, int k,
                            int swapped, int symmetric, void* stream) {
    return launch_items(items, n_items, x, lx, y, ly, k, swapped, symmetric,
                        static_cast<cudaStream_t>(stream));
}

// K1-al: the same launch over data in the aligned low-rank layout (every
// low-rank block's offsets a multiple of 8 rows, its widths multiples of 8),
// where every x strip of a low-rank block is one aligned run and every
// output window starts on a multiple of 8 rows.
extern "C" int hm_k1_launch_al(const void* items, long long n_items, const float* x,
                               long long lx, float* y, long long ly, int k,
                               int swapped, int symmetric, void* stream) {
    return launch_items(items, n_items, x, lx, y, ly, k, swapped, symmetric,
                        static_cast<cudaStream_t>(stream));
}

// 'seq' (K1-seq): the persistent grid over the work list in bucket order.
extern "C" int hm_k1_launch_seq(const void* items_by_bucket, long long n_items,
                                const float* x, long long lx, float* y,
                                long long ly, int k, int swapped, int symmetric,
                                void* stream) {
    return launch_items(items_by_bucket, n_items, x, lx, y, ly, k, swapped,
                        symmetric, static_cast<cudaStream_t>(stream));
}

// 'per_bucket' (K1-pb): one launch per bucket over that bucket's items.
// `ranges` is a host int64 array of n_buckets (first item, item count)
// pairs into items_by_bucket; every launch adds into the same y.
extern "C" int hm_k1_launch_per_bucket(const void* items_by_bucket,
                                       const long long* ranges, int n_buckets,
                                       const float* x, long long lx, float* y,
                                       long long ly, int k, int swapped,
                                       int symmetric, void* stream) {
    const Item* items = static_cast<const Item*>(items_by_bucket);
    for (int b = 0; b < n_buckets; ++b) {
        const cudaError_t e = launch_items(
            items + ranges[2 * b], ranges[2 * b + 1], x, lx, y, ly, k, swapped,
            symmetric, static_cast<cudaStream_t>(stream));
        if (e != cudaSuccess) return e;
    }
    return 0;
}

extern "C" const char* hm_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
