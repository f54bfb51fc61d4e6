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
//           (G pt, ps) @ X^T, keep the diagonal), one CTA per group, in
//           nvcuda::wmma TF32 fragments (m16n16k8) summing in f32;
//           'skip' gives x's gathered values plus 1e-30 * sum(the group's
//           slab), one CTA per group;
//   accum:  'roll' adds each block's result into y at t_off with f32
//           atomicAdd (K1's); 'static' adds every block at offset 0 (on
//           the card, the same-address contention that K1's shared target
//           rows approach); 'skip' adds nothing.
// The probes 'static' and 'skip' give "wrong" products on purpose: the
// point is attribution.  With accum 'skip' nothing is stored, and the
// compiler would drop every load whose value is unused, so each CTA
// writes the sum of its results to its slot of `sink` (the TPU kernel's
// sum(slab) * 1e-30 kept the same dependence).
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
// TB/s, 0.120 ms.  'xgemm' does G times the flops of 'vpu' (6.4 GFLOP
// for the lr case: in f32 on the CUDA cores, 67 TFLOP/s, that alone would
// take 0.096 ms), hence the tensor cores (495 TFLOP/s in TF32).  P4 moves
// a few KiB: launch latency bounds it.
//
// Tolerances.  'vpu' and 'skip' agree with the plain version to f32
// summation round-off (1e-5 relative; the atomics add in a varying
// order); with accum 'skip' the per-CTA sums in `sink` are checked
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

#include <cuda_runtime.h>
#include <mma.h>

namespace {

using namespace nvcuda;

enum { kLr = 0, kDense = 1 };                       // kind
enum { kGatherRoll = 0, kGatherTake = 1, kGatherNone = 2 };
enum { kVpu = 0, kXgemm = 1, kTermSkip = 2 };       // term
enum { kAccRoll = 0, kAccStatic = 1, kAccSkip = 2 };  // accum

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 16 * 16;  // one warp's accumulator tile in shared memory

struct Case {
    const float* slabs;  // (nb, rows, W)
    const int* t_off;    // (nb,)
    const int* s_off;    // (nb,)
    const float* x;      // (L,), 16-byte aligned
    float* y;            // (L,), zeroed
    float* sink;         // accum 'skip': one float per CTA
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

// dst[g*width + j] = x[s_off[first + g] + j] for g < n_seg, j < width.
template <int GATHER>
__device__ void stage_segments(float* dst, const Case& c, long long first, int n_seg,
                               int width) {
    const int w4 = width / 4;
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int e = threadIdx.x; e < n_seg * w4; e += kThreads) {
        const int g = e / w4, q = e - g * w4;
        d4[e] = x_quad<GATHER>(c, c.s_off[first + g] + 4 * q);
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
        stage_segments<kGatherRoll>(xs, c, i, 1, c.ps);
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

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 8, wmma::precision::tf32, wmma::row_major>;
using FragBc = wmma::fragment<wmma::matrix_b, 16, 16, 8, wmma::precision::tf32, wmma::col_major>;
using FragBr = wmma::fragment<wmma::matrix_b, 16, 16, 8, wmma::precision::tf32, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 8, float>;

template <typename Frag>
__device__ __forceinline__ void to_tf32(Frag& f) {
#pragma unroll
    for (int q = 0; q < f.num_elements; ++q) f.x[q] = wmma::__float_to_tf32(f.x[q]);
}

// The first GEMM of 'xgemm': P (n_rows, G) = A (n_rows, ps) @ X^T (ps, G)
// with A's row m at a_row(m) (row-major, leading dimension W) and X the
// staged (G, ps) segments (X^T column-major); keeps, as the reference's
// masked row sum does, for each row m only the column g = m / per of its
// own block: diag[m] = sum_n (n == g ? P[m, n] : 0).  Every tile of P is
// computed, as in the reference's formulation.  A warp per 16 rows.
template <typename ARow>
__device__ void gemm_keep_diagonal(ARow a_row, int n_rows, int per, const float* X, int G,
                                   int ps, int W, float* scratch, float* diag) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    FragA a;
    FragBc b;
    FragC acc;
    for (int mt = warp; mt < n_rows / 16; mt += kWarps) {
        const float* A = a_row(mt * 16);
        const int g = mt * 16 / per;  // the block of these 16 rows (per % 16 == 0)
        float keep = 0.0f;
        for (int nt = 0; nt < G / 16; ++nt) {
            wmma::fill_fragment(acc, 0.0f);
            for (int k0 = 0; k0 < ps; k0 += 8) {
                wmma::load_matrix_sync(a, A + k0, W);
                wmma::load_matrix_sync(b, X + nt * 16 * ps + k0, ps);
                to_tf32(a);
                to_tf32(b);
                wmma::mma_sync(acc, a, b, acc);
            }
            wmma::store_matrix_sync(scratch, acc, 16, wmma::mem_row_major);
            __syncwarp();
            if (lane < 16)
                for (int col = 0; col < 16; ++col)
                    keep += (nt * 16 + col == g) ? scratch[lane * 16 + col] : 0.0f;
            __syncwarp();
        }
        if (lane < 16) diag[mt * 16 + lane] = keep;
    }
}

// term 'xgemm', kind 'lr': group grp of G blocks, one CTA.  Shared memory:
// X (G, max(ps, pt)) -- the segments, later the results --, w_col (G r),
// w_bd (G, G r), one 16 x 16 tile per warp.
template <int GATHER, int ACCUM>
__device__ void xgemm_lr(const Case& c, long long grp, float* smem, float& dep) {
    const int G = c.G, r = c.r, pt = c.pt, ps = c.ps, W = c.W, Gr = c.G * c.r;
    const int warp = threadIdx.x >> 5;
    const long long first = grp * G;
    const float* slab = c.slabs + first * c.rows * (long long)W;
    float* X = smem;
    float* wcol = X + G * max(ps, pt);
    float* wbd = wcol + Gr;
    float* scratch = wbd + G * Gr + warp * kTile;
    stage_segments<GATHER>(X, c, first, G, ps);
    __syncthreads();
    // w_col = diag(V_flat @ X^T): V_flat row m is V row m % r of block m / r
    gemm_keep_diagonal([&](int m) { return slab + ((long long)(m / r) * c.rows + r + m % r) * W; },
                       Gr, r, X, G, ps, W, scratch, wcol);
    __syncthreads();
    for (int e = threadIdx.x; e < G * Gr; e += kThreads) {  // w_bd: w_col masked to own block
        const int g = e / Gr, col = e - g * Gr;
        wbd[e] = (col / r == g) ? wcol[col] : 0.0f;
    }
    __syncthreads();
    // out (G, pt) = w_bd (G, G r) @ Ut_flat (G r, pt); Ut_flat row m is Ut row m % r of block m / r
    FragA a;
    FragBr b;
    FragC acc;
    const int n_tiles = pt / 16;
    for (int tile = warp; tile < (G / 16) * n_tiles; tile += kWarps) {
        const int mt = tile / n_tiles, nt = tile - mt * n_tiles;
        wmma::fill_fragment(acc, 0.0f);
        for (int k0 = 0; k0 < Gr; k0 += 8) {  // 8 rows of Ut_flat lie in one block (r % 8 == 0)
            wmma::load_matrix_sync(a, wbd + mt * 16 * Gr + k0, Gr);
            wmma::load_matrix_sync(
                b, slab + ((long long)(k0 / r) * c.rows + k0 % r) * W + nt * 16, W);
            to_tf32(a);
            to_tf32(b);
            wmma::mma_sync(acc, a, b, acc);
        }
        wmma::store_matrix_sync(X + mt * 16 * pt + nt * 16, acc, pt, wmma::mem_row_major);
    }
    __syncthreads();
    for (int e = threadIdx.x; e < G * pt; e += kThreads) {
        const int g = e / pt;
        accum<ACCUM>(c, c.t_off[first + g], e - g * pt, X[e], dep);
    }
}

// term 'xgemm', kind 'dense': group grp of G blocks, one CTA.  Shared
// memory: X (G, ps), the results (G, pt), one 16 x 16 tile per warp.
template <int GATHER, int ACCUM>
__device__ void xgemm_dense(const Case& c, long long grp, float* smem, float& dep) {
    const int G = c.G, pt = c.pt, ps = c.ps, W = c.W;
    const int warp = threadIdx.x >> 5;
    const long long first = grp * G;
    const float* slab = c.slabs + first * c.rows * (long long)W;  // D_flat (G pt, W)
    float* X = smem;
    float* out = X + G * ps;
    float* scratch = out + G * pt + warp * kTile;
    stage_segments<GATHER>(X, c, first, G, ps);
    __syncthreads();
    // out (G pt,) = diag(D_flat @ X^T): row m = g pt + i is row i of block g
    gemm_keep_diagonal([&](int m) { return slab + (long long)m * W; }, G * pt, pt, X, G, ps, W,
                       scratch, out);
    __syncthreads();
    for (int e = threadIdx.x; e < G * pt; e += kThreads) {
        const int g = e / pt;
        accum<ACCUM>(c, c.t_off[first + g], e - g * pt, out[e], dep);
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
        stage_segments<kGatherRoll>(smem, c, first, G, c.ps);
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

template <int KIND, int GATHER, int TERM, int ACCUM>
__global__ void __launch_bounds__(kThreads) bucket_variant_kernel(Case c) {
    extern __shared__ __align__(128) float smem[];
    float dep = 0.0f;
    if constexpr (TERM == kVpu) {
        vpu_block<KIND, GATHER, ACCUM>(c, blockIdx.x, smem, dep);
    } else if constexpr (TERM == kXgemm) {
        if constexpr (KIND == kLr) xgemm_lr<GATHER, ACCUM>(c, blockIdx.x, smem, dep);
        else xgemm_dense<GATHER, ACCUM>(c, blockIdx.x, smem, dep);
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
    } else if constexpr (TERM == kXgemm) {
        const int wide = c.ps > c.pt ? c.ps : c.pt;
        floats = KIND == kLr
            ? (size_t)c.G * wide + (size_t)c.G * c.r + (size_t)c.G * c.G * c.r + kWarps * kTile
            : (size_t)c.G * c.ps + (size_t)c.G * c.pt + kWarps * kTile;
    } else {
        floats = GATHER == kGatherRoll ? (size_t)c.G * c.ps : 0;
    }
    return floats * sizeof(float);
}

template <int KIND, int GATHER, int TERM, int ACCUM>
cudaError_t launch_variant(const Case& c, cudaStream_t st) {
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
// needs G, pt (and r for 'lr') multiples of 16 and ps of 8.
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
