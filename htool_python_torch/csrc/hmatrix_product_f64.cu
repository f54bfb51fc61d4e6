// Kernels hmatrix_product_f64 and hmatrix_product_complex128: the bucketed
// H-matrix product y = H^(trans) x on Hopper in float64 and complex128, one
// body templated on the storage type S of the operator's factors and the
// compute type C of x, y and the arithmetic.  Four instantiations:
//
//   S        C        entry point              case
//   double   double   hm_f64_launch            float64 data (F64)
//   double2  double2  hm_c128_launch           complex128 data (C128)
//   float    double   hm_f64_f32data_launch    float32 data, float64 x
//   float2   double2  hm_c128_c64data_launch   complex64 data, complex128 x
//
// (double2 / float2 hold a complex value as interleaved re / im.)  A factor
// entry is widened to C as it leaves shared memory; widening is exact, so
// the float-storage instantiations compute what the reference computes
// when it promotes the operator to the wider dtype of x
// (htool_python_tpu/ops/matvec.py:111), without a copy of the operator and
// streaming half the bytes.
//
// They replace no TPU kernel: the TPU had no float64, and the reference
// computes these products in XLA (htool_python_tpu/ops/matvec.py:100
// `apply_hmatrix_padded`).  Their plain PyTorch version is
// `apply_hmatrix_padded` in htool_python_torch/ops/matvec.py; the wrapper
// is htool_python_torch/ops/cuda_matvec.py.  K1 and K2
// (csrc/hmatrix_product.cu, float / float2) are a separate body that this
// file leaves alone; the ring below is theirs, carried over.
//
// What it computes.  The same as K1 / K2: a list of buckets of equally
// padded blocks; a dense block adds y[t:t+pt] += D x[s:s+ps] (D row-major,
// pt x ps), a low-rank block y[t:t+pt] += Ut^T (V x[s:s+ps]) with rank-major
// Ut (r x pt) and V (r x ps).  trans 'T' runs the transposes from the
// target rows into the source rows; symmetric storage adds, for blocks
// flagged `mirror`, the opposite direction too.  For complex data each
// direction may use the conjugated factors (conj_fwd for x[s:] -> y[t:],
// conj_tr for x[t:] -> y[s:], ops/matvec.py `conj_flags`): that is how the
// wrapper forms trans 'C' and hermitian ('H') mirrors.  x and y are
// row-major (rows, k); y must be zeroed by the caller.
//
// What bounds it on an H100 SXM (3.35 TB/s; 67 TFLOP/s FP64 on the tensor
// cores, 33.5 with DFMA).  Every stored entry is used for 2 flops per
// column (real) or 8 (complex).  At k = 1 that is 1/4 flop a byte of
// double storage (1/2 of float): every instantiation is bound by the bytes
// it streams (the headline assembled in float64 stores 0.83 GB: 0.25 ms;
// in float32 0.42 GB plus x and y in float64: 0.13 ms).  On the FP64
// tensor cores the operations bound a real double product from about k =
// 32, a complex one from about k = 8.
//
// What the design does about it.
//  * The work list of K1 and K2 (ops/matvec.py `work_list`, records built
//    by ops/cuda_matvec.py `_item_records` at the storage element size):
//    block slices of at most kMaxRows<C> rows (64 real, the real data's
//    WORK_ROWS; 32 complex, WORK_ROWS_COMPLEX), every stored entry in
//    exactly one item, largest first.  A pass takes kPass<C> columns (64
//    real, 32 complex: 64 doubles a row); a wider x runs in passes, each
//    reading every stored byte once.
//  * K1's bulk-copy ring: a persistent grid of one 288-thread CTA per SM,
//    CTA b walking items b, b + grid, ...; a producer warp streams each
//    phase of an item (V x, then Ut^T w; D x; the transposes) in strips of
//    J factor columns, one `cp.async.bulk` per factor row (in bytes of S:
//    a stage holds twice as many float entries as double ones) and the x
//    rows the strip contracts with (one bulk copy where they are one run,
//    one per row from 256 bytes, else 16- or 8-byte cp.async), into
//    kStages stages guarded by full / empty mbarriers.  Each stage starts
//    with a header (struct Strip): the 8 consumer warps read nothing from
//    device memory but the stages.  Factor rows sit at a padded stride SF
//    so that the consumers' reads hit distinct banks.  Two stages of the
//    SM's shared memory each stream faster than three smaller ones (fewer
//    strips, each with the producer's fixed cost).
//  * Narrow passes (up to HM_F64_NARROW_MAX = 4 doubles of an x row: real
//    k <= 4, complex k <= 2) run DFMA from shared memory: in a ROW phase
//    (w = F x) thread t takes one of the item's rows and every NS-th
//    column of the strip (NS = 256 / the rows rounded up to a power of
//    two), the row's NS partial sums added by shuffles (and shared-memory
//    atomics past a warp) at the phase end; in a COL phase (y rows += F^T
//    w) one thread per output row.
//  * Wider passes run on the FP64 tensor cores, mma.sync.m8n8k4.f64 (a
//    full precision FMA, so no split as K1's 3xTF32 needs).  A ROW phase
//    takes 8 x 8 output tiles over (rows, columns), warp w tiles w + 8 i
//    (the warps share the k-steps of a strip where there are fewer than 8
//    tiles, their partial tiles added in shared memory at the phase end),
//    a warp with few tiles running its k-steps in 2 or 4 independent
//    accumulator chains; w (R x k) stays in shared memory.  A COL phase
//    gives each warp whole 8-row tiles of output, every column at once.
//    Complex data runs real tiles over the interleaved re / im columns, as
//    K2: F x = Fr X + Fi (i X), i X being X with each (re, im) pair turned
//    into (-im, re) (one shuffle), Fi negated under conjugation.
//  * Each output value is summed over the item's rows in registers and
//    added into y with one f64 atomicAdd (complex128 as its two parts).
//    HM_F64_BULK_REDUCE 1 adds each warp's output tile instead with one
//    `cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f64` from a
//    slot in shared memory where the tile is one run of y (one pass; an
//    odd start or end padded with a zero added to the neighbouring value):
//    measured, it was as fast or slower at every width but real k = 64
//    (PERF.md §6).  Items running at the same time add into the same rows
//    of y in a varying order, so the result agrees with the plain version
//    to f64 summation round-off, not bit for bit.
//
// Measured (PERF.md §6, profiling/f64_variants.py, NVIDIA H100 80GB HBM3,
// 700 W), device ms at k = 1 / 8 / 64: the f64 headline 0.305 / 0.419 /
// 2.10 (the earlier DFMA body 0.417 / 1.189 / 3.57 in the same run; bound
// 0.249 / 0.251 / 0.262, bytes); the f32 headline with a float64 x 0.200
// at k = 1 (bound 0.125); complex128 H-L at N = 8000 0.081 / 0.175 / 0.96
// (the earlier body 0.135 / 0.545 / 3.52).  What holds k = 1 is the
// card's read rate (2.7 TB/s; the consumers wait on full stages most of
// the time); from k = 8 the consumers' arithmetic and, at wide k, the x
// segments and y tiles that every block re-reads and adds through L2.
// Registers (ptxas, CUDA 12.8): 79-145 a thread, no spills; 160 bytes of
// stack (the producer's phases of an item).
//
// Design choices that profiling/f64_variants.py rebuilds with another
// value (-D): the ring's depth (HM_F64_STAGES), bulk reductions into y
// (HM_F64_BULK_REDUCE), the widest narrow pass (HM_F64_NARROW_MAX), the
// tensor cores or DFMA on the same fragments (HM_F64_DMMA);
// HM_F64_PHASE_CYCLES adds each warp's clock64 counts of its phases into
// y[0 .. 5] (its output is then not the product).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libhmatrix_product_f64.so hmatrix_product_f64.cu
// (done at first use by htool_python_torch/ops/cuda_build.py).

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#ifndef HM_F64_STAGES
#define HM_F64_STAGES 2
#endif
#ifndef HM_F64_BULK_REDUCE
#define HM_F64_BULK_REDUCE 0
#endif
#ifndef HM_F64_DMMA
#define HM_F64_DMMA 1
#endif
#ifndef HM_F64_NARROW_MAX
#define HM_F64_NARROW_MAX 4
#endif
#ifndef HM_F64_PHASE_CYCLES
#define HM_F64_PHASE_CYCLES 0
#endif

namespace {

constexpr int kConsumerWarps = 8;
constexpr int kConsumers = 32 * kConsumerWarps;
constexpr int kThreads = kConsumers + 32;  // + the producer warp
constexpr int kStages = HM_F64_STAGES;
constexpr int kHeaderBytes = 32;
constexpr int kSlotMin = 256;  // doubles of an output slot at narrow widths

// doubles per compute element: 1 (double), 2 (double2)
template <typename C>
constexpr int kE = sizeof(C) / 8;
// rows of an item (ops/matvec.py WORK_ROWS, WORK_ROWS_COMPLEX) and columns
// (elements) of one pass, by compute type
template <typename C>
constexpr int kMaxRows = kE<C> == 1 ? 64 : 32;
template <typename C>
constexpr int kPass = kE<C> == 1 ? 64 : 32;

// A work item, as BucketTable packs it (ops/cuda_matvec.py `_item_records`,
// the layout of K1's struct Item): rows [lo, lo + R) of one block.
// Low-rank: a = Ut + (block r + lo) pt, v = V + (block r + lo) ps (rank
// rows, each a contiguous row of pt / ps elements of S); dense: a = D +
// (block pt + lo) ps, t already + lo.
struct Item {
    long long a, v;
    int t, s, R, pt, ps, flags;  // flags: kDense | kMirror
    long long pad;
};
static_assert(sizeof(Item) == 48, "Item must match _item_records");
constexpr int kDense = 1, kMirror = 2;

// What one pass over a factor F (R rows of `width` elements, contiguous)
// does.  ROW_*: contract F's columns with x rows [xoff, xoff + width) into
// R x k sums, kept in shared memory as w (ROW_W) or added into y rows
// [yoff, yoff + R) (ROW_Y, a dense block).  COL_*: y rows [yoff, yoff +
// width) += F^T w, with w from the previous ROW_W phase (COL_W) or the x
// rows [xoff, xoff + R) (COL_X, a dense block's transpose).
enum Kind { ROW_W, ROW_Y, COL_W, COL_X };

template <typename S>
struct Phase {
    const S* F;
    long long xoff, yoff;
    int R, width, kind, conj;
};

__host__ __device__ __forceinline__ bool is_row(int kind) { return kind <= ROW_Y; }

template <typename S>
__device__ __forceinline__ int item_phases(const Item& it, int swapped,
                                           int symmetric, int conj_fwd,
                                           int conj_tr, Phase<S>* ph) {
    const bool mirrored = symmetric && (it.flags & kMirror);
    const bool fwd = !swapped || mirrored;  // x[s:] -> y[t:]
    const bool tr = swapped || mirrored;    // x[t:] -> y[s:]
    const S* a = reinterpret_cast<const S*>(it.a);
    const S* v = reinterpret_cast<const S*>(it.v);
    int n = 0;
    if (it.flags & kDense) {
        if (fwd) ph[n++] = Phase<S>{a, it.s, it.t, it.R, it.ps, ROW_Y, conj_fwd};
        if (tr) ph[n++] = Phase<S>{a, it.t, it.s, it.R, it.ps, COL_X, conj_tr};
    } else {
        if (fwd) {
            ph[n++] = Phase<S>{v, it.s, 0, it.R, it.ps, ROW_W, conj_fwd};
            ph[n++] = Phase<S>{a, 0, it.t, it.R, it.pt, COL_W, conj_fwd};
        }
        if (tr) {
            ph[n++] = Phase<S>{a, it.t, 0, it.R, it.pt, ROW_W, conj_tr};
            ph[n++] = Phase<S>{v, 0, it.s, it.R, it.ps, COL_W, conj_tr};
        }
    }
    return n;
}

// Row stride (doubles) of x rows in a stage and of w, for kcr real columns
// (2 per complex one): unpadded up to 8 (the rows then copy as one run),
// else rounded up to 4 and then to 4 mod 16, so that a tensor-core
// fragment of x or w (rows t, columns g) hits distinct banks.
__host__ __device__ __forceinline__ int x_stride(int kcr) {
    if (kcr <= 8) return kcr;
    const int kp = (kcr + 3) & ~3;
    return kp + (((4 - kp) % 16) + 16) % 16;
}

// Doubles of a warp's output slot (bulk reductions only): an 8-row tile
// of every column (plus 2 for an odd start and end), at least kSlotMin + 2.
__host__ __device__ __forceinline__ int slot_doubles(int kcr) {
    if (!HM_F64_BULK_REDUCE) return 0;
    return (8 * kcr > kSlotMin ? 8 * kcr : kSlotMin) + 2;
}

// One strip of a phase as the producer hands it to the consumers, written
// into the stage's header before the stage's full barrier is arrived on.
struct Strip {
    long long yrow;   // ROW: the phase's first y row (ROW_Y); COL: the strip's
    int kind, R, wj;  // rows, columns of the strip
    int SF;           // row stride (elements of S) of the factor strip
    int xbase;        // where the x rows start after the header (doubles)
    int flags;        // kFirst | kLast (of the phase) | kDone | kConj
};
static_assert(sizeof(Strip) == kHeaderBytes, "Strip is the stage header");
constexpr int kFirst = 1, kLast = 2, kDone = 4, kConj = 8;

// Rows of an item rounded up to a power of two, and the slices of a
// strip's columns that the narrow ROW phase gives each row (kConsumers /
// that: thread tid takes row tid / NS, columns tid % NS + NS i).
__host__ __device__ __forceinline__ int row_slices(int R) {
    int rp = 1;
    while (rp < R) rp *= 2;
    return kConsumers / rp;
}

// Padding of a factor row (elements of S) past the strip's J columns:
// SF = J + pad is `target` mod M (M elements of S span the 32 banks), so
// that the consumers' reads hit distinct banks: a DMMA ROW fragment (rows
// g, columns t) at target 4, a DMMA COL fragment (rows t, columns g) at
// M / 4, a narrow ROW warp (32 / NS rows of NS consecutive columns) at
// NS; a narrow COL warp reads along rows.  J is a multiple of 16, so the
// pad is below M.
template <typename S>
__device__ __forceinline__ int sf_target(int kind, int R, bool narrow) {
    constexpr int M = 128 / sizeof(S);
    if (narrow) return is_row(kind) ? row_slices(R) % M : 0;
    return is_row(kind) ? 4 : M / 4;
}

// Strip width J (a multiple of 16, or the whole width padded to 16, the
// strips of a phase as even as 16 allows) and factor row stride SF of a
// phase in a stage of `body` bytes after its header.  The stage holds the
// factor strip (R rows of SF elements of S), 16-byte aligned, then the x
// rows: J rows of sx doubles for ROW, R rows for COL_X, each with two
// doubles of slack for a run copied from an even double.
template <typename S>
__device__ __forceinline__ void geometry(const Phase<S>& p, int sx, int body,
                                         bool narrow, int& J, int& SF) {
    constexpr int M = 128 / sizeof(S);
    const bool row = is_row(p.kind);
    const int fixed = (p.kind == COL_X ? p.R * sx * 8 : 0) + 32
                      + (M - 1) * p.R * (int)sizeof(S);
    const int per_col = p.R * (int)sizeof(S) + (row ? sx * 8 : 0);
    const int wpad = (p.width + 15) & ~15;
    const int jmax = max(16, ((body - fixed) / per_col) & ~15);
    const int strips = (wpad + jmax - 1) / jmax;
    J = ((wpad / 16 + strips - 1) / strips) * 16;
    const int target = sf_target<S>(p.kind, p.R, narrow);
    SF = J + (((target - J) % M) + M) % M;
}

// ---- mbarrier, bulk copy, bulk reduce and cp.async helpers (PTX) ---------

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

__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n"
        :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
        : "memory");
}

__device__ __forceinline__ void cp_async8(double* dst, const double* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
                 :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(double* dst, const double* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

// y[0 .. bytes / 8) += src[...] in f64, element by element (atomic per
// element), read from shared memory by the bulk-copy unit.
__device__ __forceinline__ void bulk_reduce_add(double* dst, const double* src,
                                                uint32_t bytes) {
    asm volatile(
        "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f64 "
        "[%0], [%1], %2;\n"
        :: "l"(dst), "r"(smem_addr(src)), "r"(bytes) : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Every bulk reduction of this thread has read its source.
__device__ __forceinline__ void bulk_wait_read() {
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Shared-memory writes of this thread made visible to the bulk-copy unit.
__device__ __forceinline__ void fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void consumer_sync() {
    asm volatile("bar.sync 1, %0;\n" :: "n"(kConsumers) : "memory");
}

// ---- the producer warp -----------------------------------------------

// x rows [r0, r0 + nrows) (k doubles, row stride ld doubles; x holds lx
// rows) into X with row stride sx; returns the shift (doubles) of the first
// row past X and adds the bulk bytes to *tx.  A contiguous run (sx == k ==
// ld) goes as one bulk copy from the even double at or before it (the
// shift is 0 or 1); rows into a padded stride where k and ld are even as
// one bulk copy per row from 256 bytes up and as 16-byte cp.async below;
// else as 8-byte cp.async (odd k or ld).
__device__ __forceinline__ int copy_x(double* X, const double* __restrict__ x,
                                      long long lx, int ld, int k, int sx,
                                      long long r0, int nrows, uint64_t* full,
                                      uint32_t* tx, bool issue, int lane) {
    if (sx == k && ld == k) {
        const long long o = r0 * k, o2 = o & ~1LL;
        const long long e2 = (o + (long long)nrows * k + 1) & ~1LL;
        if (e2 <= lx * k) {
            *tx += (uint32_t)((e2 - o2) * 8);
            if (issue && lane == 0) bulk_copy(X, x + o2, (uint32_t)((e2 - o2) * 8), full);
            return (int)(o - o2);
        }
    }
    if (k % 2 == 0 && ld % 2 == 0 && sx % 2 == 0 && k >= 32) {
        *tx += (uint32_t)(nrows * k * 8);
        if (issue)
            for (int q = lane; q < nrows; q += 32)
                bulk_copy(X + (long long)q * sx, x + (r0 + q) * ld, (uint32_t)(k * 8), full);
    } else if (k % 2 == 0 && ld % 2 == 0 && sx % 2 == 0) {
        const int q2 = k / 2;
        if (issue)
            for (int e = lane; e < nrows * q2; e += 32) {
                const int q = e / q2, c = 2 * (e - q * q2);
                cp_async16(X + q * sx + c, x + (r0 + q) * ld + c);
            }
    } else if (issue) {
        for (int e = lane; e < nrows * k; e += 32) {
            const int q = e / k, c = e - q * k;
            cp_async8(X + q * sx + c, x + (r0 + q) * ld + c);
        }
    }
    return 0;
}

// Issues the copies of one strip (columns [j0, j0 + wj) of phase p's
// factor and its x rows of k doubles) into the stage body B and writes the
// stage's header.
template <typename S>
__device__ __forceinline__ void produce_strip(const Phase<S>& p, int J, int SF,
                                              int j0, int flags, char* B,
                                              Strip* hdr, uint64_t* full,
                                              const double* __restrict__ x,
                                              long long lx, int ld, int k,
                                              int sx, int lane) {
    const int wj = min(J, p.width - j0);
    const int fbytes = (p.R * SF * (int)sizeof(S) + 15) & ~15;
    double* X = reinterpret_cast<double*>(B + fbytes);
    uint32_t tx = (uint32_t)(p.R * wj * (int)sizeof(S));
    int shift = 0;
    if (is_row(p.kind))
        shift = copy_x(X, x, lx, ld, k, sx, p.xoff + j0, wj, full, &tx, false, lane);
    else if (p.kind == COL_X)
        shift = copy_x(X, x, lx, ld, k, sx, p.xoff, p.R, full, &tx, false, lane);
    if (lane == 0) {
        *hdr = Strip{is_row(p.kind) ? p.yoff : p.yoff + j0, p.kind, p.R, wj, SF,
                     fbytes / 8 + shift, flags | (p.conj ? kConj : 0)};
        mbar_arrive_expect_tx(full, tx);
    }
    __syncwarp();
    for (int rr = lane; rr < p.R; rr += 32)
        bulk_copy(B + (long long)rr * SF * sizeof(S), p.F + (long long)rr * p.width + j0,
                  (uint32_t)(wj * sizeof(S)), full);
    if (is_row(p.kind))
        copy_x(X, x, lx, ld, k, sx, p.xoff + j0, wj, full, &tx, true, lane);
    else if (p.kind == COL_X)
        copy_x(X, x, lx, ld, k, sx, p.xoff, p.R, full, &tx, true, lane);
    mbar_arrive_cp_async(full);
}

// ---- the consumers' arithmetic ----------------------------------------

// A factor entry widened to the compute type (exact).
__device__ __forceinline__ double widen(float v) { return static_cast<double>(v); }
__device__ __forceinline__ double widen(double v) { return v; }
__device__ __forceinline__ double2 widen(float2 v) { return make_double2(v.x, v.y); }
__device__ __forceinline__ double2 widen(double2 v) { return v; }

// The compute type's arithmetic on the narrow path: cj(a, cs) is a, or
// conj(a) for cs == -1; mac(acc, a, x) = acc + a x.
__device__ __forceinline__ double cj(double a, double) { return a; }
__device__ __forceinline__ double2 cj(double2 a, double cs) {
    return make_double2(a.x, cs * a.y);
}
__device__ __forceinline__ double mac(double acc, double a, double x) {
    return __fma_rn(a, x, acc);
}
__device__ __forceinline__ double2 mac(double2 acc, double2 a, double2 x) {
    acc.x = __fma_rn(a.x, x.x, __fma_rn(-a.y, x.y, acc.x));
    acc.y = __fma_rn(a.x, x.y, __fma_rn(a.y, x.x, acc.y));
    return acc;
}
__device__ __forceinline__ double add(double a, double b) { return a + b; }
__device__ __forceinline__ double2 add(double2 a, double2 b) {
    return make_double2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ double shfl_xor(double v, int m) {
    return __shfl_xor_sync(0xffffffffu, v, m);
}
__device__ __forceinline__ double2 shfl_xor(double2 v, int m) {
    return make_double2(shfl_xor(v.x, m), shfl_xor(v.y, m));
}
// element c of a row of interleaved doubles (16-byte aligned for double2)
template <typename C>
__device__ __forceinline__ C elem(const double* row, int c) {
    return reinterpret_cast<const C*>(row)[c];
}

// c (8 x 8) += a (8 x 4) b (4 x 8), the warp's fragments: lane (g, t) =
// (lane / 4, lane % 4) holds a = A[g][t], b = B[t][g], c = C[g][2t, 2t + 1].
// HM_F64_DMMA 0 forms the same sums with shuffles and DFMA (a variant).
__device__ __forceinline__ void dmma(double (&c)[2], double a, double b) {
#if HM_F64_DMMA
    asm("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 "
        "{%0, %1}, {%2}, {%3}, {%0, %1};\n"
        : "+d"(c[0]), "+d"(c[1]) : "d"(a), "d"(b));
#else
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        const double aq = __shfl_sync(0xffffffffu, a, 4 * g + q);
        const double b0 = __shfl_sync(0xffffffffu, b, 8 * t + q);
        const double b1 = __shfl_sync(0xffffffffu, b, 8 * t + 4 + q);
        c[0] = __fma_rn(aq, b0, c[0]);
        c[1] = __fma_rn(aq, b1, c[1]);
    }
#endif
}

// c += op(a) b for one k-step: real, or complex over interleaved real
// columns (column 8n + g of b): Ar b + (cs Ai) (i b), i b's value at this
// column being its partner's (column ^ 1, lane ^ 4), negated at even ones.
__device__ __forceinline__ void mma_step(double (&c)[2], double a, double, double b,
                                         int) {
    dmma(c, a, b);
}
__device__ __forceinline__ void mma_step(double (&c)[2], double2 a, double cs,
                                         double b, int g) {
    const double p = __shfl_xor_sync(0xffffffffu, b, 4);
    dmma(c, a.x, b);
    dmma(c, cs * a.y, (g & 1) ? p : -p);
}

// ---- wide passes: m8n8k4 FP64 tiles ----------------------------------------

// How the consumer warps share a ROW phase's tiles: MT 8-row tiles over R,
// NT 8-column tiles over kcr.  With at least 8 tiles, warp w takes tiles
// w + 8 i (m = u % MT, n = u / MT); with fewer, S = 8 / tiles warps share
// each tile, each taking every S-th k-step of a strip, and the phase end
// adds their partial tiles.
struct RowTiles { int MT, tiles, S, split; bool idle; };

__device__ __forceinline__ RowTiles row_tiles(int R, int kcr, int warp) {
    const int MT = (R + 7) >> 3, tiles = MT * ((kcr + 7) >> 3);
    if (tiles >= kConsumerWarps) return RowTiles{MT, tiles, 1, 0, false};
    const int S = kConsumerWarps / tiles;
    return RowTiles{MT, tiles, S, warp / tiles, warp >= tiles * S};
}

// the warp's i-th tile (>= tiles: none; the warp's tiles are a prefix)
__device__ __forceinline__ int row_tile(const RowTiles& T, int warp, int i) {
    if (T.S > 1) return i == 0 ? warp % T.tiles : T.tiles;
    return warp + kConsumerWarps * i;
}

// The number of tiles warp `warp` holds (a prefix of i = 0, 1, ...), and
// the independent accumulator chains it runs them in: CH chains of 8 / CH
// tiles, chain q taking every CH-th k-step into acc[i + (8 / CH) q], so
// that a warp with few tiles does not wait on one mma after another.
__device__ __forceinline__ int warp_tiles(const RowTiles& T, int warp) {
    int nt = 0;
    while (nt < 8 && row_tile(T, warp, nt) < T.tiles) ++nt;
    return nt;
}
__device__ __forceinline__ int chains(int nt) { return nt <= 2 ? 4 : nt <= 4 ? 2 : 1; }

// k-steps kk0, kk0 + step, ... of a ROW strip in CH chains.  aoff / bcol:
// each tile's A row offset in F and B column (-1: past R / past kcr);
// one_row: the warp's tiles share their A rows (loaded once a k-step).
template <typename S, int CH>
__device__ __forceinline__ void row_steps(const S* F, const double* X, int sx,
                                          int wj, int kk0, int step,
                                          const int (&aoff)[8],
                                          const int (&bcol)[8], int nt,
                                          bool one_row, double cs, int g,
                                          int t, double (&acc)[8][2]) {
    constexpr int TW = 8 / CH;
    for (int kk = kk0; kk < wj; kk += CH * step) {
#pragma unroll
        for (int q = 0; q < CH; ++q) {
            const int j = kk + q * step + t;
            if (j - t >= wj) break;  // uniform in the warp
            const S* f = F + j;
            const double* xr = X + j * sx;
            auto a = widen(aoff[0] >= 0 ? f[aoff[0]] : S{});
#pragma unroll
            for (int i = 0; i < TW; ++i) {
                if (i >= nt) break;
                if (i > 0 && !one_row) a = widen(aoff[i] >= 0 ? f[aoff[i]] : S{});
                const double b = bcol[i] >= 0 ? xr[bcol[i]] : 0.0;
                mma_step(acc[i + TW * q], a, cs, b, g);
            }
        }
    }
}

// ROW strip: acc (the warp's tiles of w = op(F) X) += over the strip's wj
// columns (a multiple of 4).  F: R rows at stride SF (elements of S); X:
// wj rows of kcr doubles at stride sx.  Each tile's A row offset and B
// column are worked out once a strip.
template <typename S>
__device__ __forceinline__ void row_strip(const S* F, const double* X, int SF,
                                          int sx, int R, int wj, int kcr,
                                          double cs, int warp, int lane,
                                          double (&acc)[8][2]) {
    const RowTiles T = row_tiles(R, kcr, warp);
    if (T.idle) return;
    const int g = lane >> 2, t = lane & 3;
    const int nt = warp_tiles(T, warp);
    int aoff[8], bcol[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const int u = row_tile(T, warp, i);
        const int row = 8 * (u % T.MT) + g, col = 8 * (u / T.MT) + g;
        aoff[i] = row < R ? row * SF : -1;
        bcol[i] = col < kcr ? col : -1;
    }
    // tiles w + 8 i share their m-tile where MT divides the 8 warps
    const bool one_row = T.S == 1 && kConsumerWarps % T.MT == 0;
    const int kk0 = 4 * T.split, step = 4 * T.S;
    switch (chains(nt)) {
        case 4:
            row_steps<S, 4>(F, X, sx, wj, kk0, step, aoff, bcol, nt, one_row, cs, g, t, acc);
            break;
        case 2:
            row_steps<S, 2>(F, X, sx, wj, kk0, step, aoff, bcol, nt, one_row, cs, g, t, acc);
            break;
        default:
            row_steps<S, 1>(F, X, sx, wj, kk0, step, aoff, bcol, nt, one_row, cs, g, t, acc);
    }
}

// End of a ROW phase: each tile's chains summed, the warps' tiles of w
// (R x kcr) into W (stride sw), the shares of a split tile added after the
// first.  Its caller syncs.
__device__ __forceinline__ void row_finish(int R, int kcr, double* W, int sw,
                                           double (&acc)[8][2], int warp,
                                           int lane) {
    const RowTiles T = row_tiles(R, kcr, warp);
    const int g = lane >> 2, t = lane & 3;
    const int ch = chains(warp_tiles(T, warp));
    if (ch == 4) {
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int q = 0; q < 2; ++q)
                acc[i][q] += acc[i + 2][q] + acc[i + 4][q] + acc[i + 6][q];
    } else if (ch == 2) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int q = 0; q < 2; ++q) acc[i][q] += acc[i + 4][q];
    }
    for (int pass = 0; pass < (T.S > 1 ? 2 : 1); ++pass) {
        if (pass == 1) consumer_sync();  // the first shares are in W
        if (T.idle || (pass == 0) != (T.split == 0)) continue;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            const int u = row_tile(T, warp, i);
            if (u >= T.tiles) break;
            const int row = 8 * (u % T.MT) + g, col = 8 * (u / T.MT) + 2 * t;
#pragma unroll
            for (int q = 0; q < 2; ++q) {
                if (row >= R || col + q >= kcr) continue;
                if (pass == 0) W[row * sw + col + q] = acc[i][q];
                else atomicAdd(W + row * sw + col + q, acc[i][q]);
            }
        }
    }
}

// ---- narrow passes: DFMA from shared memory --------------------------------

// ROW strip, narrow (kcr <= KC doubles, NC = KC / E elements of C): thread
// tid takes row r = tid / NS and the strip's columns tid % NS + NS i
// (`row_slices`), NC accumulators; rows past R idle.  The phase end sums
// each row's NS partial sums.
template <typename S, typename C, int NC>
__device__ __forceinline__ void narrow_row_strip(const S* F, const double* X,
                                                 int SF, int sx, int R, int wj,
                                                 double cs, int tid,
                                                 C (&acc)[NC]) {
    const int NS = row_slices(R), r = tid / NS;
    if (r >= R) return;
    const S* f = F + r * SF;
#pragma unroll 4
    for (int j = tid - r * NS; j < wj; j += NS) {
        const C a = cj(widen(f[j]), cs);
        const double* xr = X + j * sx;
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[c] = mac(acc[c], a, elem<C>(xr, c));
    }
}

// End of a narrow ROW phase: each row's partial sums added over its NS
// threads (shuffles within a warp, then shared-memory atomics across the
// NS / 32 warps of a row with NS > 32) into W (stride sw), columns below
// kcr.  Its caller syncs.
template <typename C, int NC>
__device__ __forceinline__ void narrow_row_finish(int R, int kcr, double* W,
                                                  int sw, C (&acc)[NC],
                                                  int tid) {
    constexpr int E = kE<C>;
    const int NS = row_slices(R), r = tid / NS, s = tid - r * NS;
    const int span = NS < 32 ? NS : 32;
    for (int m = 1; m < span; m *= 2) {
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[c] = add(acc[c], shfl_xor(acc[c], m));
    }
    const bool lead = r < R && s % span == 0;
    for (int pass = 0; pass < (NS > 32 ? 2 : 1); ++pass) {
        if (pass == 1) consumer_sync();  // the first warp's sums are in W
        if (!lead || (pass == 0) != (s < 32)) continue;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
            if (c * E >= kcr) break;
            double* w = W + r * sw + c * E;
            const double* v = reinterpret_cast<const double*>(&acc[c]);
#pragma unroll
            for (int q = 0; q < E; ++q) {
                if (pass == 0) w[q] = v[q];
                else atomicAdd(w + q, v[q]);
            }
        }
    }
}

// ---- output into y ------------------------------------------------------

// A warp's writer of output tiles (rows x kcr doubles of y, row stride
// ld doubles; y holds ly rows): one bulk reduction per tile from the
// warp's slots where the tile is one run of y, else an atomicAdd per
// nonzero value.
struct YOut {
    double* y;
    long long ly;
    int ld, kcr;
    double* slot;  // this warp's (bulk reductions only)
    int sd;        // its doubles
};

// Starts a tile of `rows` rows at y row yr.  Returns where the tile's row 0
// column 0 goes in a slot (rows at stride kcr), or nullptr for atomics;
// e0 / n: the run of y (doubles from y) that the slot adds into.
__device__ __forceinline__ double* tile_begin(YOut& o, long long yr, int rows,
                                              int lane, long long& e0, int& n) {
    if (!HM_F64_BULK_REDUCE || o.ld != o.kcr) return nullptr;
    const long long es = yr * o.kcr, ee = es + (long long)rows * o.kcr;
    e0 = es & ~1LL;
    const long long e1 = (ee + 1) & ~1LL;
    if (e1 > o.ly * o.kcr) return nullptr;
    n = (int)(e1 - e0);
    if (lane == 0) bulk_wait_read();  // the slot's last tile has been read
    __syncwarp();
    double* s = o.slot;
    if (lane == 0) {  // the pads, where the run starts or ends one early / late
        s[0] = 0.0;
        s[n - 1] = 0.0;
    }
    __syncwarp();
    return s + (es - e0);
}

__device__ __forceinline__ void tile_end(YOut& o, long long e0, int n,
                                         int lane) {
    fence_proxy_async();
    __syncwarp();
    if (lane == 0) bulk_reduce_add(o.y + e0, o.slot, (uint32_t)(n * 8));
}

__device__ __forceinline__ void put(const YOut& o, double* s, long long yr,
                                    int r, int c, double v) {
    if (s) {
        s[r * o.kcr + c] = v;
    } else if (v != 0.0 && yr + r < o.ly) {
        atomicAdd(o.y + (yr + r) * o.ld + c, v);
    }
}

// Rows of the chunks a COL strip of wj rows is dealt out in: a multiple of
// `unit` rows, about wj / 8 so that every warp has one, and with bulk
// reductions at most a slot's (slot_doubles holds 8 rows, and 32 up to
// 8 doubles a row).
__device__ __forceinline__ int chunk_rows(const YOut& o, int wj, int unit) {
    const int per_warp = ((wj + unit - 1) / unit + kConsumerWarps - 1)
                         / kConsumerWarps * unit;
    if (!HM_F64_BULK_REDUCE) return per_warp;
    return min((o.sd - 2) / o.kcr / unit * unit, per_warp);
}

// COL strip, wide: y rows [yrow0, yrow0 + wj) += op(F)^T w, F R rows at
// stride SF, w R rows of kcr doubles at stride sw.  A chunk's 8-row tiles
// each sum over the R rows with all columns at once; the chunk goes out as
// one tile.
template <typename S>
__device__ __forceinline__ void col_strip(const S* F, const double* w, int SF,
                                          int sw, int R, int wj, long long yrow0,
                                          double cs, YOut& o, int warp, int lane,
                                          long long* cyc) {
    const int kcr = o.kcr, NT = (kcr + 7) >> 3;
    const int g = lane >> 2, t = lane & 3;
    const int CR = chunk_rows(o, wj, 8);
    for (int r0 = warp * CR; r0 < wj; r0 += kConsumerWarps * CR) {
        const int r1 = min(wj, r0 + CR);
#if HM_F64_PHASE_CYCLES
        long long c0 = clock64();
#endif
        long long e0 = 0;
        int n = 0;
        double* s = tile_begin(o, yrow0 + r0, r1 - r0, lane, e0, n);
#if HM_F64_PHASE_CYCLES
        cyc[3] += clock64() - c0;
#endif
        for (int m0 = r0; m0 < r1; m0 += 8) {
#if HM_F64_PHASE_CYCLES
            long long c1 = clock64();
#endif
            double acc[8][2];
#pragma unroll
            for (int i = 0; i < 8; ++i) acc[i][0] = acc[i][1] = 0.0;
            const int jrow = m0 + g;
            for (int kk = 0; kk < R; kk += 4) {
                const int r = kk + t;
                const auto a = widen(r < R && jrow < r1 ? F[r * SF + jrow] : S{});
                const double* wr = w + r * sw;
#pragma unroll
                for (int i = 0; i < 8; ++i) {
                    if (i >= NT) break;
                    const int col = 8 * i + g;
                    const double b = r < R && col < kcr ? wr[col] : 0.0;
                    mma_step(acc[i], a, cs, b, g);
                }
            }
#if HM_F64_PHASE_CYCLES
            long long c2 = clock64();
            cyc[2] += c2 - c1;
#endif
            if (jrow < r1) {
#pragma unroll
                for (int i = 0; i < 8; ++i) {
                    if (i >= NT) break;
#pragma unroll
                    for (int q = 0; q < 2; ++q) {
                        const int col = 8 * i + 2 * t + q;
                        if (col < kcr) put(o, s, yrow0 + r0, jrow - r0, col, acc[i][q]);
                    }
                }
            }
#if HM_F64_PHASE_CYCLES
            cyc[3] += clock64() - c2;
#endif
        }
#if HM_F64_PHASE_CYCLES
        long long c3 = clock64();
#endif
        if (s) tile_end(o, e0, n, lane);
#if HM_F64_PHASE_CYCLES
        cyc[3] += clock64() - c3;
#endif
    }
    (void)cyc;
}

// COL strip, narrow: one thread per output row (a warp's 32 consecutive
// rows of its chunk at a time), NC accumulators over the R rows of F, F's
// rows read along (conflict-free) and w's broadcast.
template <typename S, typename C, int NC>
__device__ __forceinline__ void narrow_col_strip(const S* F, const double* w,
                                                 int SF, int sw, int R, int wj,
                                                 long long yrow0, double cs,
                                                 YOut& o, int warp, int lane,
                                                 long long* cyc) {
    constexpr int E = kE<C>;
    const int kcr = o.kcr;
    const int CR = chunk_rows(o, wj, 32);
    for (int r0 = warp * CR; r0 < wj; r0 += kConsumerWarps * CR) {
        const int r1 = min(wj, r0 + CR);
#if HM_F64_PHASE_CYCLES
        long long c0 = clock64();
#endif
        long long e0 = 0;
        int n = 0;
        double* s = tile_begin(o, yrow0 + r0, r1 - r0, lane, e0, n);
#if HM_F64_PHASE_CYCLES
        cyc[3] += clock64() - c0;
#endif
        for (int j = r0 + lane; j < r1; j += 32) {
#if HM_F64_PHASE_CYCLES
            long long c1 = clock64();
#endif
            C acc[NC];
#pragma unroll
            for (int c = 0; c < NC; ++c) acc[c] = C{};
#pragma unroll 4
            for (int r = 0; r < R; ++r) {
                const C a = cj(widen(F[r * SF + j]), cs);
                const double* wr = w + r * sw;
#pragma unroll
                for (int c = 0; c < NC; ++c) acc[c] = mac(acc[c], a, elem<C>(wr, c));
            }
#if HM_F64_PHASE_CYCLES
            long long c2 = clock64();
            cyc[2] += c2 - c1;
#endif
#pragma unroll
            for (int c = 0; c < NC; ++c) {
                if (c * E >= kcr) break;
                const double* v = reinterpret_cast<const double*>(&acc[c]);
#pragma unroll
                for (int q = 0; q < E; ++q) put(o, s, yrow0 + r0, j - r0, c * E + q, v[q]);
            }
#if HM_F64_PHASE_CYCLES
            cyc[3] += clock64() - c2;
#endif
        }
#if HM_F64_PHASE_CYCLES
        long long c3 = clock64();
#endif
        if (s) tile_end(o, e0, n, lane);
#if HM_F64_PHASE_CYCLES
        cyc[3] += clock64() - c3;
#endif
    }
    (void)cyc;
}

// y rows [yrow, yrow + R) += W (a ROW_Y phase's D x): warp w adds rows
// [8 w, 8 w + 8) as one tile.
__device__ __forceinline__ void add_w(const double* W, int sw, int R,
                                      long long yrow, YOut& o, int warp,
                                      int lane) {
    const int r0 = 8 * warp;
    if (r0 >= R) return;
    const int rows = min(8, R - r0), kcr = o.kcr;
    long long e0 = 0;
    int n = 0;
    double* s = tile_begin(o, yrow + r0, rows, lane, e0, n);
    for (int e = lane; e < rows * kcr; e += 32) {
        const int r = e / kcr, c = e - r * kcr;
        put(o, s, yrow + r0, r, c, W[(r0 + r) * sw + c]);
    }
    if (s) tile_end(o, e0, n, lane);
}

// ---- the kernel ---------------------------------------------------------

// One launch walks items [0, n_items) with a persistent grid.  Shared
// memory: kStages stages of stage_bytes (a Strip header, then the factor
// strip and its x rows), then w (kMaxRows<C> x sx doubles), then the
// consumer warps' output slots, then the 2 x kStages barriers.  x and y
// point at the pass's first column; their rows are ld doubles apart (k E);
// kc <= kPass<C> columns (elements) in this pass.  KC: the narrow path's
// doubles of an x row (1, 2, 4 or 8, at least kc E), or kWide (m8n8k4).
constexpr int kWide = 0;

template <typename S, typename C, int KC>
__global__ void __launch_bounds__(kThreads, 1)
hmatrix_product_f64_kernel(const Item* __restrict__ items, long long n_items,
                           const double* __restrict__ x, long long lx,
                           double* __restrict__ y, long long ly, int ld, int kc,
                           int swapped, int symmetric, int conj_fwd, int conj_tr,
                           int stage_bytes) {
    constexpr bool narrow = KC != kWide;
    constexpr int NC = narrow ? KC / kE<C> : 1;
    extern __shared__ float4 smem4[];
    char* ring = reinterpret_cast<char*>(smem4);
    const int kcr = kc * kE<C>;
    const int sx = x_stride(kcr);
    const int sd = slot_doubles(kcr);
    double* W = reinterpret_cast<double*>(ring + (long long)kStages * stage_bytes);
    double* slots = W + kMaxRows<C> * sx;
    uint64_t* full = reinterpret_cast<uint64_t*>(slots + kConsumerWarps * sd);
    uint64_t* empty = full + kStages;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int body = stage_bytes - kHeaderBytes;
    long long cyc[6] = {0, 0, 0, 0, 0, 0};  // HM_F64_PHASE_CYCLES only
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
            Phase<S> ph[4];
            const int np = item_phases<S>(cur, swapped, symmetric, conj_fwd,
                                          conj_tr, ph);
            for (int q = 0; q < np; ++q) {
                int J, SF;
                geometry<S>(ph[q], sx, body, narrow, J, SF);
                for (int j0 = 0; j0 < ph[q].width; j0 += J) {
#if HM_F64_PHASE_CYCLES
                    long long c0 = clock64();
#endif
                    mbar_wait(empty + stage, parity ^ 1);
#if HM_F64_PHASE_CYCLES
                    cyc[5] += clock64() - c0;
#endif
                    char* St = ring + (long long)stage * stage_bytes;
                    const int flags = (j0 == 0 ? kFirst : 0)
                                      | (j0 + J >= ph[q].width ? kLast : 0);
                    produce_strip<S>(ph[q], J, SF, j0, flags, St + kHeaderBytes,
                                     reinterpret_cast<Strip*>(St), full + stage,
                                     x, lx, ld, kcr, sx, lane);
                    if (++stage == kStages) { stage = 0; parity ^= 1; }
                }
            }
            cur = next;
        }
        // the end: a header with no copies
        mbar_wait(empty + stage, parity ^ 1);
        char* St = ring + (long long)stage * stage_bytes;
        if (lane == 0) {
            *reinterpret_cast<Strip*>(St) = Strip{0, 0, 0, 0, 0, 0, kDone};
            mbar_arrive_expect_tx(full + stage, 0);
        }
        __syncwarp();
        mbar_arrive_cp_async(full + stage);
        asm volatile("cp.async.wait_all;\n" ::: "memory");
#if HM_F64_PHASE_CYCLES
        if (lane == 0) atomicAdd(y + 5, static_cast<double>(cyc[5]));
#endif
        return;
    }

    // the consumer warps: driven by the stage headers alone
    const int tid = threadIdx.x;
    YOut o{y, ly, ld, kcr, slots + warp * sd, sd};
    int stage = 0;
    uint32_t parity = 0;
    double acc[8][2];  // wide
    C nacc[NC];        // narrow
    for (;;) {
#if HM_F64_PHASE_CYCLES
        long long c0 = clock64();
#endif
        mbar_wait(full + stage, parity);
#if HM_F64_PHASE_CYCLES
        long long c1 = clock64();
        cyc[0] += c1 - c0;
#endif
        const char* St = ring + (long long)stage * stage_bytes;
        const Strip h = *reinterpret_cast<const Strip*>(St);
        if (h.flags & kDone) break;
        const S* F = reinterpret_cast<const S*>(St + kHeaderBytes);
        const double* X = reinterpret_cast<const double*>(St + kHeaderBytes) + h.xbase;
        const double* w = h.kind == COL_X ? X : W;
        const double cs = (h.flags & kConj) ? -1.0 : 1.0;
        if (is_row(h.kind)) {
            if (h.flags & kFirst) {
#pragma unroll
                for (int i = 0; i < 8; ++i) acc[i][0] = acc[i][1] = 0.0;
#pragma unroll
                for (int c = 0; c < NC; ++c) nacc[c] = C{};
            }
            if constexpr (narrow)
                narrow_row_strip<S, C, NC>(F, X, h.SF, sx, h.R, h.wj, cs, tid, nacc);
            else
                row_strip<S>(F, X, h.SF, sx, h.R, h.wj, kcr, cs, warp, lane, acc);
#if HM_F64_PHASE_CYCLES
            cyc[1] += clock64() - c1;
#endif
        } else if constexpr (narrow) {
            narrow_col_strip<S, C, NC>(F, w, h.SF, sx, h.R, h.wj, h.yrow, cs, o,
                                       warp, lane, cyc);
        } else {
            col_strip<S>(F, w, h.SF, sx, h.R, h.wj, h.yrow, cs, o, warp, lane,
                         cyc);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + stage);
        if (++stage == kStages) { stage = 0; parity ^= 1; }
        if (!(h.flags & kLast)) continue;
        // the end of a phase.  w written (ROW_W) before COL reads it; read
        // (COL_W) before the next ROW_W writes it.
#if HM_F64_PHASE_CYCLES
        long long c4 = clock64();
#endif
        if (is_row(h.kind)) {
            if constexpr (narrow)
                narrow_row_finish<C, NC>(h.R, kcr, W, sx, nacc, tid);
            else
                row_finish(h.R, kcr, W, sx, acc, warp, lane);
            consumer_sync();
            if (h.kind == ROW_Y) {
                add_w(W, sx, h.R, h.yrow, o, warp, lane);
                consumer_sync();
            }
        } else if (h.kind == COL_W) {
            consumer_sync();
        }
#if HM_F64_PHASE_CYCLES
        cyc[4] += clock64() - c4;
#endif
    }
    if (lane == 0) bulk_wait_all();
#if HM_F64_PHASE_CYCLES
    if (lane == 0)
        for (int q = 0; q < 5; ++q) atomicAdd(y + q, static_cast<double>(cyc[q]));
#endif
    (void)cyc;
}

// ---- launch -------------------------------------------------------------

// Shared memory of one launch: the card's opt-in maximum per block, so one
// CTA fills an SM; the stages share what w, the slots and the barriers
// leave.  Fails where a stage could not hold the largest strip of 16
// columns (a COL_X phase of kMaxRows rows with its x rows, or a ROW strip).
struct Plan { size_t bytes; int stage_bytes, optin; };

template <typename S, typename C>
cudaError_t smem_plan(int kcr, Plan* plan) {
    int device = 0, optin = 0;
    cudaError_t e = cudaGetDevice(&device);
    if (e != cudaSuccess) return e;
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (e != cudaSuccess) return e;
    const int sx = x_stride(kcr), R = kMaxRows<C>;
    const size_t fixed = (size_t)R * sx * 8
                         + (size_t)kConsumerWarps * slot_doubles(kcr) * 8
                         + 2 * kStages * 8;
    const int stage_bytes = (int)(((optin - fixed) / kStages) & ~(size_t)15);
    constexpr int pad = 128 / sizeof(S) - 1;
    const int col_x = R * sx * 8 + R * (16 + pad) * (int)sizeof(S) + 32;
    const int row = R * (16 + pad) * (int)sizeof(S) + 16 * sx * 8 + 32;
    if (stage_bytes - kHeaderBytes < (col_x > row ? col_x : row)) return cudaErrorInvalidValue;
    *plan = Plan{(size_t)kStages * stage_bytes + fixed, stage_bytes, optin};
    return cudaSuccess;
}

// Resident CTAs of the whole card for an instantiation and smem, computed
// once per (device, instantiation, smem) and kept.
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
// pass of kcr doubles a row runs: the narrow path over KC >= kcr doubles
// up to HM_F64_NARROW_MAX, the tensor cores above.
template <typename F>
cudaError_t with_instantiation(int kcr, F f) {
    if (kcr > HM_F64_NARROW_MAX) return f(std::integral_constant<int, kWide>{});
    if (kcr > 4) return f(std::integral_constant<int, 8>{});
    if (kcr > 2) return f(std::integral_constant<int, 4>{});
    if (kcr == 2) return f(std::integral_constant<int, 2>{});
    return f(std::integral_constant<int, 1>{});
}

// Every item in one launch per pass of at most kPass<C> columns.  x (lx,
// k) and y (ly, k) of C, as doubles.
template <typename S, typename C>
cudaError_t launch_items(const void* items, long long n_items, const double* x,
                         long long lx, double* y, long long ly, int k,
                         int swapped, int symmetric, int conj_fwd, int conj_tr,
                         cudaStream_t st) {
    constexpr int E = kE<C>, pass = kPass<C>;
    if (n_items == 0 || k == 0) return cudaSuccess;
    for (int c0 = 0; c0 < k; c0 += pass) {
        const int kc = k - c0 < pass ? k - c0 : pass;
        cudaError_t e = with_instantiation(kc * E, [&](auto tag) {
            constexpr int KC = decltype(tag)::value;
            // a real pass never takes KC = 1 as complex; odd KC is real only
            if constexpr (E == 2 && KC == 1) {
                return cudaErrorInvalidValue;
            } else {
                constexpr int inst = (int)sizeof(S) + 32 * E + 128 * KC;
                Plan plan;
                cudaError_t err = smem_plan<S, C>(kc * E, &plan);
                if (err != cudaSuccess) return err;
                int resident = 0;
                err = persistent_grid(hmatrix_product_f64_kernel<S, C, KC>, inst,
                                      plan.bytes, plan.optin, &resident);
                if (err != cudaSuccess) return err;
                const long long grid = n_items < resident ? n_items : resident;
                hmatrix_product_f64_kernel<S, C, KC>
                    <<<(unsigned)grid, kThreads, plan.bytes, st>>>(
                        static_cast<const Item*>(items), n_items,
                        x + (long long)c0 * E, lx, y + (long long)c0 * E, ly, k * E,
                        kc, swapped, symmetric, conj_fwd, conj_tr, plan.stage_bytes);
                return cudaGetLastError();
            }
        });
        if (e != cudaSuccess) return e;
    }
    return cudaSuccess;
}

}  // namespace

// Plain C interface, loaded with ctypes, in the style of hm_k1_launch /
// hm_k2_launch (csrc/hmatrix_product.cu).  `items` is a device array of
// n_items work-item records (struct Item, 48 bytes) naming the operator's
// factor rows at its storage element size; x (lx, k) and y (ly, k)
// row-major, float64 (hm_f64_*) or complex128, interleaved re / im
// (hm_c128_*), y zeroed by the caller; the wrapper has checked that every
// block segment lies inside both.  conj_fwd / conj_tr conjugate the
// operator in the x[s:] -> y[t:] and the x[t:] -> y[s:] direction.  Each
// returns the cudaError_t of its launches (0 on success).

// float64 data
extern "C" int hm_f64_launch(const void* items, long long n_items, const void* x,
                             long long lx, void* y, long long ly, int k,
                             int swapped, int symmetric, void* stream) {
    return launch_items<double, double>(
        items, n_items, static_cast<const double*>(x), lx, static_cast<double*>(y),
        ly, k, swapped, symmetric, 0, 0, static_cast<cudaStream_t>(stream));
}

// float32 data, float64 x and y
extern "C" int hm_f64_f32data_launch(const void* items, long long n_items,
                                     const void* x, long long lx, void* y,
                                     long long ly, int k, int swapped,
                                     int symmetric, void* stream) {
    return launch_items<float, double>(
        items, n_items, static_cast<const double*>(x), lx, static_cast<double*>(y),
        ly, k, swapped, symmetric, 0, 0, static_cast<cudaStream_t>(stream));
}

// complex128 data
extern "C" int hm_c128_launch(const void* items, long long n_items, const void* x,
                              long long lx, void* y, long long ly, int k,
                              int swapped, int symmetric, int conj_fwd,
                              int conj_tr, void* stream) {
    return launch_items<double2, double2>(
        items, n_items, static_cast<const double*>(x), lx, static_cast<double*>(y),
        ly, k, swapped, symmetric, conj_fwd, conj_tr,
        static_cast<cudaStream_t>(stream));
}

// complex64 data, complex128 x and y
extern "C" int hm_c128_c64data_launch(const void* items, long long n_items,
                                      const void* x, long long lx, void* y,
                                      long long ly, int k, int swapped,
                                      int symmetric, int conj_fwd, int conj_tr,
                                      void* stream) {
    return launch_items<float2, double2>(
        items, n_items, static_cast<const double*>(x), lx, static_cast<double*>(y),
        ly, k, swapped, symmetric, conj_fwd, conj_tr,
        static_cast<cudaStream_t>(stream));
}

extern "C" const char* hm_f64_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
