// Kernels hmatrix_product_f64 and hmatrix_product_complex128: the bucketed
// H-matrix product y = H^(trans) x on Hopper in float64 and complex128, one
// body templated on the element type (double, and double2 holding a
// complex128 value as interleaved re / im).
//
// They replace no TPU kernel: the TPU had no float64, and the reference
// computes these products in XLA (htool_python_tpu/ops/matvec.py:100
// `apply_hmatrix_padded`, the dtype promoted at :111).  They were added
// because every reference test, and the port's default dtype, is float64:
// without them an f64 operator had no product on the card.  Their plain
// PyTorch version is `apply_hmatrix_padded` in htool_python_torch/ops/
// matvec.py; the wrapper is htool_python_torch/ops/cuda_matvec.py.  K1 and
// K2 (csrc/hmatrix_product.cu, float / float2) are a separate, tuned body
// that this file leaves alone.
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
// cores, 33.5 TFLOP/s with DFMA outside them).  Every stored entry is used
// for 2 flops per column (real) or 8 (complex).  At k = 1 that is 1/4 flop
// a byte of f64 and 1/2 of complex128: the product is bound by the bytes
// it streams (the headline assembled in f64 stores 0.83 GB: 0.25 ms).  At
// k = 64 a real entry costs 128 flops for 8 bytes: on the DFMA units the
// operations bound it from about k = 16 (complex128 from k = 8).
//
// What the design does about it.  Simple first (the DMMA tensor-core path,
// mma.sync.m8n8k4.f64, and a shared-memory ring like K1's are later work):
//  * The work list of K1 and K2 (ops/matvec.py `work_list`, records built
//    by ops/cuda_matvec.py `_item_records` at 8 / 16 bytes an element):
//    block slices of at most kMaxRows<T> rows (64 for float64, the real
//    data's WORK_ROWS; 32 for complex128, WORK_ROWS_COMPLEX), every stored
//    entry in exactly one item, largest first.  A low-rank slice's w = V x
//    (R x kc) sits in static shared memory: R x one pass of columns, 64 x
//    64 doubles or 32 x 32 complex128, 32 KB or 16 KB, which is what sets
//    the rows of an item and the columns of a pass (kPass<T>: 64 real, 32
//    complex columns; a wider x runs in passes, each reading every stored
//    byte once).  Registers do not grow with the rows.
//  * A persistent grid: as many 256-thread CTAs as fit on the card, CTA b
//    walking items b, b + grid, ...
//  * Narrow passes (up to kNarrowMax<T> columns: 8 real, 16 complex), in
//    groups of CG <= 8 columns.  ROW phase (contract an R x W factor with x
//    rows [xoff, xoff + W)): one warp per (row, column group), its lanes
//    striding over W (the factor row read coalesced), DFMA into CG
//    accumulators, a butterfly reduce-scatter across the lanes (CG - 1 +
//    log2(32 / CG) shuffles), the sums written into w (a low-rank V x or
//    Ut x) or added into y (a dense block's D x).  COL phase (y rows [yoff,
//    yoff + W) += F^T w): one thread per (output row, column group), DFMA
//    over the item's R rows (unrolled by kColUnroll, so that the factor
//    loads overlap), F's row read coalesced and w broadcast from shared
//    memory; a dense block's transpose first copies its x rows into w.
//  * Wide passes: lanes over columns (kPass / 32 each) and a warp over
//    kRowsW = 4 rows (ROW) or output rows (COL) at once, so that each x row
//    or w row a warp loads serves them all and no reduction is needed; the
//    factor entries are broadcast loads.
//  * Native atomicAdd(double*) into y; complex128 takes two, one per part
//    (sm_90 has no 16-byte double2 atomic).  Items running at the same time
//    add into the same rows of y in a varying order, so the result agrees
//    with the plain version to f64 summation round-off, not bit for bit.
//
// Measured (PERF.md §6, chip_smoke.py `f64_check`, H100 80GB HBM3, 700 W):
// the f64 headline at k = 1 runs at about 0.6 of its byte bound; at 8 to
// 64 columns the kernel is 5-17x its bound, held by its loads and atomics
// (no shared-memory staging of the factors, one atomic per output value).
//
// Registers and spills (nvcc -Xptxas -v, sm_90a, CUDA 12.8; chip_smoke.py's
// `device` phase prints the report): double CG = 1, 2, 4, 8 and wide use
// 40, 60, 80, 78 and 64 registers, double2 48, 60, 100, 106 and 64; no
// spills but 8 bytes in double CG = 1 (its stack frame); 32 KB / 16 KB of
// static shared memory.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libhmatrix_product_f64.so hmatrix_product_f64.cu
// (done at first use by htool_python_torch/ops/cuda_build.py).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Design choices that profiling/f64_variants.py rebuilds with another
// value (-D), each set by its measurement (PERF.md §6): passes of up to
// kNarrowMax<T> columns run the narrow path (in groups of 8), wider ones
// the wide path (float64: 8, as the wide path is faster from 9 columns;
// complex128: 16, where the narrow path still takes 0.6 of the wide one's
// time); the unrolling of the narrow COL phase's loop over an item's rows
// (4: 1 is slower at 8 columns and on complex128) and of both wide loops
// (4: 0.8 of 2's time at 16 to 64 columns).
#ifndef HM_F64_NARROW_MAX
#define HM_F64_NARROW_MAX 8
#endif
#ifndef HM_C128_NARROW_MAX
#define HM_C128_NARROW_MAX 16
#endif
#ifndef HM_F64_COL_UNROLL
#define HM_F64_COL_UNROLL 4
#endif
#ifndef HM_F64_WIDE_UNROLL
#define HM_F64_WIDE_UNROLL 4
#endif
template <typename T>
constexpr int kNarrowMax = sizeof(T) == 8 ? HM_F64_NARROW_MAX
                                          : HM_C128_NARROW_MAX;
constexpr int kColUnroll = HM_F64_COL_UNROLL;
constexpr int kWideUnroll = HM_F64_WIDE_UNROLL;

// columns of one pass, and rows of an item, by element type
template <typename T>
constexpr int kPass = sizeof(T) == 8 ? 64 : 32;
template <typename T>
constexpr int kMaxRows = sizeof(T) == 8 ? 64 : 32;

// A work item, as BucketTable packs it (ops/cuda_matvec.py `_item_records`,
// the layout of K1's struct Item): rows [lo, lo + R) of one block.
// Low-rank: a = Ut + (block r + lo) pt, v = V + (block r + lo) ps (rank
// rows, each a contiguous row of pt / ps elements); dense: a = D + (block
// pt + lo) ps, t already + lo.
struct Item {
    long long a, v;
    int t, s, R, pt, ps, flags;  // flags: kDense | kMirror
    long long pad;
};
static_assert(sizeof(Item) == 48, "Item must match _item_records");
constexpr int kDense = 1, kMirror = 2;

// Element arithmetic: double, and double2 as one complex128 value.
__device__ __forceinline__ double load(const double* p, bool) {
    return __ldg(p);
}
__device__ __forceinline__ double2 load(const double2* p, bool conj) {
    double2 v = __ldg(p);
    if (conj) v.y = -v.y;
    return v;
}
__device__ __forceinline__ double mul_add(double a, double b, double c) {
    return __fma_rn(a, b, c);
}
__device__ __forceinline__ double2 mul_add(double2 a, double2 b, double2 c) {
    c.x = __fma_rn(a.x, b.x, __fma_rn(-a.y, b.y, c.x));
    c.y = __fma_rn(a.x, b.y, __fma_rn(a.y, b.x, c.y));
    return c;
}
template <typename T>
__device__ __forceinline__ T zero() {
    return T{};
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

// Sums each of the CG accumulators over the warp's 32 lanes, scattered:
// after it, lane l < CG holds the total of column `col` (returned), each
// column in one lane.  Halving the accumulators at each of the first
// log2(CG) butterfly steps takes CG - 1 + log2(32 / CG) shuffles, where a
// plain reduction of each would take 5 CG.
template <typename T, int CG>
__device__ __forceinline__ int reduce_scatter(T (&acc)[CG], int lane) {
    int col = 0;
#pragma unroll
    for (int h = CG / 2, bit = 1; h >= 1; h /= 2, bit *= 2) {
        const bool upper = lane & bit;
#pragma unroll
        for (int i = 0; i < h; ++i) {
            const T send = upper ? acc[i] : acc[i + h];
            const T keep = upper ? acc[i + h] : acc[i];
            acc[i] = add(keep, shfl_xor(send, bit));
        }
        if (upper) col += h;
    }
#pragma unroll
    for (int m = CG; m < 32; m *= 2) acc[0] = add(acc[0], shfl_xor(acc[0], m));
    return col;
}
__device__ __forceinline__ void add_to(double* p, double v) {
    atomicAdd(p, v);
}
__device__ __forceinline__ void add_to(double2* p, double2 v) {
    atomicAdd(&p->x, v.x);
    atomicAdd(&p->y, v.y);
}

// ROW phase: out[r][c] = sum_j F[r][j] x[xoff + j][c] for r < R, c < kc,
// written into w (to_y false) or added into y rows [yoff, yoff + R).
// Narrow passes (kc <= 8): lanes over j, CG accumulators, reduce-scatter.
template <typename T, int CG>
__device__ __forceinline__ void row_phase_narrow(const T* F, int R, int W,
                                          const T* x, long long ldx,
                                          long long xoff, int kc, bool conj,
                                          T* w, bool to_y, T* y,
                                          long long ldy, long long yoff) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int groups = (kc + CG - 1) / CG;
    for (int task = warp; task < R * groups; task += kWarps) {
        const int r = task / groups, c0 = (task - r * groups) * CG;
        T acc[CG];
#pragma unroll
        for (int c = 0; c < CG; ++c) acc[c] = zero<T>();
        const T* f = F + static_cast<long long>(r) * W;
        const T* xs = x + xoff * ldx + c0;
#pragma unroll 4
        for (int j = lane; j < W; j += 32) {
            const T fj = load(f + j, conj);
            const T* xr = xs + static_cast<long long>(j) * ldx;
#pragma unroll
            for (int c = 0; c < CG; ++c)
                if (CG == 1 || c0 + c < kc) acc[c] = mul_add(fj, load(xr + c, false), acc[c]);
        }
        const int c = c0 + reduce_scatter<T, CG>(acc, lane);
        if (lane < CG && c < kc) {
            if (to_y)
                add_to(y + (yoff + r) * ldy + c, acc[0]);
            else
                w[r * kPass<T> + c] = acc[0];
        }
    }
}

// Wide passes (kc > 8): lanes over columns (kPass / 32 each), a warp over
// kRowsW rows at once, so that each x row it loads serves them all and no
// reduction is needed; the factor entries are broadcast loads.
constexpr int kRowsW = 4;

template <typename T>
__device__ __forceinline__ void row_phase_wide(const T* F, int R, int W,
                                               const T* x, long long ldx,
                                               long long xoff, int kc,
                                               bool conj, T* w, bool to_y,
                                               T* y, long long ldy,
                                               long long yoff) {
    constexpr int CPL = kPass<T> / 32;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const T* xs = x + xoff * ldx;
    for (int r0 = warp * kRowsW; r0 < R; r0 += kWarps * kRowsW) {
        const int nr = R - r0 < kRowsW ? R - r0 : kRowsW;
        T acc[kRowsW][CPL];
#pragma unroll
        for (int i = 0; i < kRowsW; ++i)
#pragma unroll
            for (int q = 0; q < CPL; ++q) acc[i][q] = zero<T>();
        const T* f = F + static_cast<long long>(r0) * W;
#pragma unroll kWideUnroll
        for (int j = 0; j < W; ++j) {
            T xv[CPL];
#pragma unroll
            for (int q = 0; q < CPL; ++q) {
                const int c = lane + 32 * q;
                xv[q] = c < kc ? load(xs + static_cast<long long>(j) * ldx + c, false)
                               : zero<T>();
            }
#pragma unroll
            for (int i = 0; i < kRowsW; ++i) {
                if (i < nr) {
                    const T fi = load(f + static_cast<long long>(i) * W + j, conj);
#pragma unroll
                    for (int q = 0; q < CPL; ++q) acc[i][q] = mul_add(fi, xv[q], acc[i][q]);
                }
            }
        }
#pragma unroll
        for (int i = 0; i < kRowsW; ++i)
#pragma unroll
            for (int q = 0; q < CPL; ++q) {
                const int c = lane + 32 * q;
                if (i < nr && c < kc) {
                    if (to_y)
                        add_to(y + (yoff + r0 + i) * ldy + c, acc[i][q]);
                    else
                        w[(r0 + i) * kPass<T> + c] = acc[i][q];
                }
            }
    }
}

// COL phase: y[yoff + j][c] += sum_r F[r][j] w[r][c] for j < W, c < kc.
// Narrow passes: one thread per (j, CG columns), F's rows coalesced.
template <typename T, int CG>
__device__ __forceinline__ void col_phase_narrow(const T* F, int R, int W,
                                          const T* w, int kc, bool conj, T* y,
                                          long long ldy, long long yoff) {
    const int groups = (kc + CG - 1) / CG;
    for (int task = threadIdx.x; task < W * groups; task += kThreads) {
        const int g = task / W, j = task - g * W, c0 = g * CG;
        T acc[CG];
#pragma unroll
        for (int c = 0; c < CG; ++c) acc[c] = zero<T>();
#pragma unroll kColUnroll
        for (int r = 0; r < R; ++r) {
            const T f = load(F + static_cast<long long>(r) * W + j, conj);
            const T* wr = w + r * kPass<T> + c0;
#pragma unroll
            for (int c = 0; c < CG; ++c) acc[c] = mul_add(f, wr[c], acc[c]);
        }
#pragma unroll
        for (int c = 0; c < CG; ++c)
            if (CG == 1 || c0 + c < kc) add_to(y + (yoff + j) * ldy + c0 + c, acc[c]);
    }
}

// Wide passes: lanes over columns, a warp over kRowsW output rows at once,
// w's row (conflict-free) serving them all.
template <typename T>
__device__ __forceinline__ void col_phase_wide(const T* F, int R, int W,
                                               const T* w, int kc, bool conj,
                                               T* y, long long ldy,
                                               long long yoff) {
    constexpr int CPL = kPass<T> / 32;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    for (int j0 = warp * kRowsW; j0 < W; j0 += kWarps * kRowsW) {
        const int nj = W - j0 < kRowsW ? W - j0 : kRowsW;
        T acc[kRowsW][CPL];
#pragma unroll
        for (int i = 0; i < kRowsW; ++i)
#pragma unroll
            for (int q = 0; q < CPL; ++q) acc[i][q] = zero<T>();
#pragma unroll kWideUnroll
        for (int r = 0; r < R; ++r) {
            T wv[CPL];
#pragma unroll
            for (int q = 0; q < CPL; ++q) wv[q] = w[r * kPass<T> + lane + 32 * q];
            const T* f = F + static_cast<long long>(r) * W + j0;
#pragma unroll
            for (int i = 0; i < kRowsW; ++i) {
                if (i < nj) {
                    const T fi = load(f + i, conj);
#pragma unroll
                    for (int q = 0; q < CPL; ++q) acc[i][q] = mul_add(fi, wv[q], acc[i][q]);
                }
            }
        }
#pragma unroll
        for (int i = 0; i < kRowsW; ++i)
#pragma unroll
            for (int q = 0; q < CPL; ++q) {
                const int c = lane + 32 * q;
                if (i < nj && c < kc) add_to(y + (yoff + j0 + i) * ldy + c, acc[i][q]);
            }
    }
}

// kWide: the CG value of the wide instantiation
constexpr int kWide = 0;

template <typename T, int CG>
__device__ __forceinline__ void row_phase(const T* F, int R, int W, const T* x,
                                          long long ldx, long long xoff, int kc,
                                          bool conj, T* w, bool to_y, T* y,
                                          long long ldy, long long yoff) {
    if constexpr (CG == kWide)
        row_phase_wide<T>(F, R, W, x, ldx, xoff, kc, conj, w, to_y, y, ldy, yoff);
    else
        row_phase_narrow<T, CG>(F, R, W, x, ldx, xoff, kc, conj, w, to_y, y, ldy,
                                yoff);
}

template <typename T, int CG>
__device__ __forceinline__ void col_phase(const T* F, int R, int W, const T* w,
                                          int kc, bool conj, T* y, long long ldy,
                                          long long yoff) {
    if constexpr (CG == kWide)
        col_phase_wide<T>(F, R, W, w, kc, conj, y, ldy, yoff);
    else
        col_phase_narrow<T, CG>(F, R, W, w, kc, conj, y, ldy, yoff);
}

// x rows [xoff, xoff + R), columns [0, kc), into w (a dense block's
// transpose contracts them).
template <typename T>
__device__ __forceinline__ void stage_x(const T* x, long long ldx,
                                        long long xoff, int R, int kc, T* w) {
    for (int i = threadIdx.x; i < R * kc; i += kThreads) {
        const int r = i / kc, c = i - r * kc;
        w[r * kPass<T> + c] = x[(xoff + r) * ldx + c];
    }
}

// One pass of kc <= kPass<T> columns: x and y point at the pass's first
// column, their rows ldx = ldy = k elements apart.
template <typename T, int CG>
__global__ void __launch_bounds__(kThreads)
hmatrix_product_f64_kernel(const Item* __restrict__ items, long long n_items,
                           const T* __restrict__ x, T* y, long long ld, int kc,
                           int swapped, int symmetric, int conj_fwd,
                           int conj_tr) {
    __shared__ T w[kMaxRows<T> * kPass<T>];
    for (long long b = blockIdx.x; b < n_items; b += gridDim.x) {
        const Item it = items[b];
        const bool mirrored = symmetric && (it.flags & kMirror);
        const bool fwd = !swapped || mirrored;  // x[s:] -> y[t:]
        const bool tr = swapped || mirrored;    // x[t:] -> y[s:]
        const T* a = reinterpret_cast<const T*>(it.a);
        const T* v = reinterpret_cast<const T*>(it.v);
        if (it.flags & kDense) {
            if (fwd)
                row_phase<T, CG>(a, it.R, it.ps, x, ld, it.s, kc, conj_fwd, w,
                                 true, y, ld, it.t);
            if (tr) {
                stage_x(x, ld, it.t, it.R, kc, w);
                __syncthreads();
                col_phase<T, CG>(a, it.R, it.ps, w, kc, conj_tr, y, ld, it.s);
                __syncthreads();
            }
        } else {
            if (fwd) {
                row_phase<T, CG>(v, it.R, it.ps, x, ld, it.s, kc, conj_fwd, w,
                                 false, y, ld, 0);
                __syncthreads();
                col_phase<T, CG>(a, it.R, it.pt, w, kc, conj_fwd, y, ld, it.t);
                __syncthreads();
            }
            if (tr) {
                row_phase<T, CG>(a, it.R, it.pt, x, ld, it.t, kc, conj_tr, w,
                                 false, y, ld, 0);
                __syncthreads();
                col_phase<T, CG>(v, it.R, it.ps, w, kc, conj_tr, y, ld, it.s);
                __syncthreads();
            }
        }
    }
}

// The persistent grid of one instantiation on the current device: the
// CTAs that fit on every SM at once, found once per device.
template <typename T, int CG>
cudaError_t resident_grid(int* grid) {
    static int cached[64] = {0};
    int device = 0;
    cudaError_t e = cudaGetDevice(&device);
    if (e != cudaSuccess) return e;
    if (device < 64 && cached[device] > 0) {
        *grid = cached[device];
        return cudaSuccess;
    }
    int sms = 0, per_sm = 0;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (e != cudaSuccess) return e;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, hmatrix_product_f64_kernel<T, CG>, kThreads, 0);
    if (e != cudaSuccess) return e;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    *grid = sms * per_sm;
    if (device < 64) cached[device] = *grid;
    return cudaSuccess;
}

template <typename T, int CG>
cudaError_t launch_pass(const Item* items, long long n_items, const T* x, T* y,
                        long long ld, int kc, int swapped, int symmetric,
                        int conj_fwd, int conj_tr, cudaStream_t st) {
    int resident = 0;
    cudaError_t e = resident_grid<T, CG>(&resident);
    if (e != cudaSuccess) return e;
    const long long grid = n_items < resident ? n_items : resident;
    hmatrix_product_f64_kernel<T, CG><<<(unsigned)grid, kThreads, 0, st>>>(
        items, n_items, x, y, ld, kc, swapped, symmetric, conj_fwd, conj_tr);
    return cudaGetLastError();
}

// Every item in one launch per pass of at most kPass<T> columns; CG (the
// columns a thread sums at once) is the pass's width up to 8, and wider
// passes take the wide instantiation (lanes over columns).
template <typename T>
cudaError_t launch_items(const void* items_v, long long n_items, const T* x,
                         T* y, int k, int swapped, int symmetric, int conj_fwd,
                         int conj_tr, cudaStream_t st) {
    const Item* items = static_cast<const Item*>(items_v);
    if (n_items == 0 || k == 0) return cudaSuccess;
    for (int c0 = 0; c0 < k; c0 += kPass<T>) {
        const int kc = k - c0 < kPass<T> ? k - c0 : kPass<T>;
        cudaError_t e;
        if (kc == 1)
            e = launch_pass<T, 1>(items, n_items, x + c0, y + c0, k, kc, swapped,
                                  symmetric, conj_fwd, conj_tr, st);
        else if (kc == 2)
            e = launch_pass<T, 2>(items, n_items, x + c0, y + c0, k, kc, swapped,
                                  symmetric, conj_fwd, conj_tr, st);
        else if (kc <= 4)
            e = launch_pass<T, 4>(items, n_items, x + c0, y + c0, k, kc, swapped,
                                  symmetric, conj_fwd, conj_tr, st);
        else if (kc <= kNarrowMax<T>)
            e = launch_pass<T, 8>(items, n_items, x + c0, y + c0, k, kc, swapped,
                                  symmetric, conj_fwd, conj_tr, st);
        else
            e = launch_pass<T, kWide>(items, n_items, x + c0, y + c0, k, kc,
                                      swapped, symmetric, conj_fwd, conj_tr, st);
        if (e != cudaSuccess) return e;
    }
    return cudaSuccess;
}

}  // namespace

// Plain C interface, loaded with ctypes, in the style of hm_k1_launch /
// hm_k2_launch (csrc/hmatrix_product.cu).  `items` is a device array of
// n_items work-item records (struct Item, 48 bytes); x (lx, k) and y (ly,
// k) row-major, float64 (hm_f64_launch) or complex128, interleaved re / im
// (hm_c128_launch), y zeroed by the caller; the wrapper has checked that
// every block segment lies inside both (lx, ly are not read here).
// conj_fwd / conj_tr conjugate the operator in the x[s:] -> y[t:] and the
// x[t:] -> y[s:] direction.  Each returns the cudaError_t of its launches
// (0 on success).
extern "C" int hm_f64_launch(const void* items, long long n_items, const double* x,
                             long long lx, double* y, long long ly, int k,
                             int swapped, int symmetric, void* stream) {
    (void)lx;
    (void)ly;
    return launch_items(items, n_items, x, y, k, swapped, symmetric, 0, 0,
                        static_cast<cudaStream_t>(stream));
}

extern "C" int hm_c128_launch(const void* items, long long n_items, const void* x,
                              long long lx, void* y, long long ly, int k,
                              int swapped, int symmetric, int conj_fwd,
                              int conj_tr, void* stream) {
    (void)lx;
    (void)ly;
    return launch_items(items, n_items, static_cast<const double2*>(x),
                        static_cast<double2*>(y), k, swapped, symmetric,
                        conj_fwd, conj_tr, static_cast<cudaStream_t>(stream));
}

extern "C" const char* hm_f64_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
