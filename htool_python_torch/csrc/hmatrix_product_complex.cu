// Kernel K2: the complex64 bucketed H-matrix product y = H^(trans) x on Hopper.
//
// Replaces the TPU kernel `apply_hmatrix_pallas_complex` of
// htool_python_tpu/ops/pallas_matvec.py (its `_launch_fused` with the
// `cdense` / `clr` kinds, `_step_body`'s complex branch and `_cterm_fwd` /
// `_cterm_tr`): one launch covers every bucket of the operator.  Its plain
// PyTorch version is `apply_hmatrix_padded` in
// htool_python_torch/ops/matvec.py; the wrapper is
// htool_python_torch/ops/cuda_matvec.py.
//
// What it computes.  K1's function (hmatrix_product.cu) over complex64
// data and x: a dense block adds  y[t:t+pt] += op(D) x[s:s+ps], a low-rank
// block  y[t:t+pt] += op(Ut)^T (op(V) x[s:s+ps]), and the opposite
// direction (`tr`: x[t:] -> y[s:]) applies the transposes.  op() is the
// identity or the complex conjugate, chosen per direction by the wrapper
// (`conj_fwd`, `conj_tr`), which is how trans 'C' and hermitian ('H')
// mirrors are formed.  The TPU kernel had no complex type and streamed
// re/im f32 plane pairs with explicit cross terms; this kernel reads the
// stored interleaved complex64 tensors as they are.
//
// What bounds it.  Every stored complex entry (8 bytes) is read once and
// used for 8 flops per right-hand side (4 multiplies, 4 adds).  At k = 8
// that is about 0.34 ms of f32 work at 67 TFLOP/s against about 0.84 ms of
// bytes at 3.35 TB/s for a 2.8 GB operator (both reckoned from the H100
// SXM data sheet): the product is bound by the bytes it streams.
//
// What the design does about it.  K1's structure: one CTA per (block,
// group of <= 8 right-hand sides), the grid walks the buckets through the
// same device table, one launch per product.  Factor and dense rows are
// read once, coalesced, 16 bytes (two complex values) a thread, never
// staged; only the block's x segment (column-major) and the rank-sized
// w = V x live in shared memory.  At 8 columns the complex x segment of a
// 1024-row block is 66 KB, over the 48 KB default, so the launch raises
// the limit; with fewer CTAs then fitting on an SM, a CTA has 256 threads
// (K1: 128) to keep loads in flight.  Results go out with float2 atomicAdd
// (one complex value), or float4 (two) where the row segment is aligned;
// the order of those adds varies from run to run.  Faster designs (row
// ownership, TMA staging) are later work.
//
// Launch structures: K1's three ('fused', 'per_bucket' = K2-pb, 'seq' =
// K2-seq; see hmatrix_product.cu), over one block body.  The reference ran
// complex symmetric storage under 'seq' through its fused kernel
// (pallas_matvec.py:598-605); here 'seq' covers every storage case.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libhmatrix_product_complex.so
//        hmatrix_product_complex.cu
// (done at first use by htool_python_torch/ops/cuda_build.py).

#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;

// One row of the device bucket table (the layout of K1's, shared by the
// wrapper); every field is 8 bytes wide.
struct Bucket {
    long long a;       // dense: D (nb, pt, ps); low-rank: Ut (nb, r, pt)
    long long v;       // low-rank: V (nb, r, ps); dense: 0
    long long t_off;   // const int* (nb,)
    long long s_off;   // const int* (nb,)
    long long mirror;  // const unsigned char* (nb,)
    long long first;   // grid index of the bucket's first block
    long long nb, pt, ps, r;  // r == 0 marks a dense bucket
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

// Leading dimension (in complex values) of a staged x segment of n rows
// and KC columns, n a multiple of 4.  Reads: a warp reads 32 consecutive
// float4 of one column, conflict-free when every column starts 16-byte
// aligned (ldx even).  Writes: stage_x's warp stores 8-byte values, which
// shared memory serves half a warp at a time; a half warp covers 16/KC
// consecutive rows of KC columns, and those 16 values hit 16 distinct bank
// pairs when ldx = 16/KC modulo 32/KC (for KC = 8: ldx = 2 mod 4, so
// consecutive columns start 2 bank pairs apart).  KC == 1 has one column.
__host__ __device__ __forceinline__ int x_ld(int n, int KC) {
    if (KC == 1) return n;
    const int h = 16 / KC, q = 2 * h;
    return (n - h + q - 1) / q * q + h;  // least ldx >= n with ldx = h mod q
}

// y[yr, c0 + c] += (re[c], im[c]) for c < kc, skipping values whose both
// parts are zero (a padded block row adds nothing).  `vec`: the row segment
// is 16-byte aligned (k even, KC even), so float4 atomics add two complex
// values at once (vector atomics, compute capability 9.x).
template <int KC>
__device__ __forceinline__ void add_row(float2* __restrict__ y, long long yr,
                                        long long ly, int k, int c0, int kc,
                                        const float (&re)[KC],
                                        const float (&im)[KC], bool vec) {
    if (yr >= ly) return;
    float2* p = y + yr * k + c0;
    if constexpr (KC % 2 == 0) {
        if (vec) {
#pragma unroll
            for (int q = 0; q < KC / 2; ++q) {
                const float4 v = make_float4(re[2 * q], im[2 * q],
                                             re[2 * q + 1], im[2 * q + 1]);
                if (2 * q < kc && (v.x != 0.0f || v.y != 0.0f || v.z != 0.0f || v.w != 0.0f))
                    atomicAdd(reinterpret_cast<float4*>(p) + q, v);
            }
            return;
        }
    }
#pragma unroll
    for (int c = 0; c < KC; ++c)
        if (c < kc && (re[c] != 0.0f || im[c] != 0.0f))
            atomicAdd(p + c, make_float2(re[c], im[c]));
}

// Column-major staging of the block's input segment: xs[c*ldx + j] =
// x[off + j, c0 + c] for j < n, zero outside x or past the k columns.
template <int KC>
__device__ void stage_x(float2* xs, int ldx, const float2* __restrict__ x,
                        long long lx, int k, int c0, int kc, long long off,
                        int n) {
    for (int e = threadIdx.x; e < n * KC; e += blockDim.x) {
        const int j = e / KC, c = e % KC;
        const long long row = off + j;
        xs[c * ldx + j] = (c < kc && row < lx) ? x[row * k + c0 + c]
                                               : make_float2(0.0f, 0.0f);
    }
}

// out[row, c] = sum_j op(A[row, j]) * xs[c*ldx + j] for row < n_rows, one
// warp per row; op conjugates when csign == -1.  A is row-major (n_rows,
// n_in) complex with n_in even and rows 16-byte aligned.  to_y: added
// into y[out_off + row, c0 + c]; otherwise written to ws[row*KC + c].
template <int KC, bool to_y>
__device__ void row_dot(const float2* __restrict__ A, int n_rows, int n_in,
                        float csign, const float2* xs, int ldx, float2* ws,
                        float2* __restrict__ y, long long ly, int k, int c0,
                        int kc, long long out_off, bool vec) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nw = blockDim.x >> 5, n2 = n_in >> 1;
    for (int row = warp; row < n_rows; row += nw) {
        const float4* A4 = reinterpret_cast<const float4*>(A + (long long)row * n_in);
        float re[KC], im[KC];
#pragma unroll
        for (int c = 0; c < KC; ++c) re[c] = im[c] = 0.0f;
#pragma unroll 2
        for (int q = lane; q < n2; q += 32) {
            float4 a = __ldg(A4 + q);  // two complex values: (x, y), (z, w)
            a.y *= csign;
            a.w *= csign;
#pragma unroll
            for (int c = 0; c < KC; ++c) {
                const float4 xv = reinterpret_cast<const float4*>(xs + c * ldx)[q];
                re[c] = fmaf(a.x, xv.x, fmaf(-a.y, xv.y, fmaf(a.z, xv.z,
                        fmaf(-a.w, xv.w, re[c]))));
                im[c] = fmaf(a.x, xv.y, fmaf(a.y, xv.x, fmaf(a.z, xv.w,
                        fmaf(a.w, xv.z, im[c]))));
            }
        }
#pragma unroll
        for (int c = 0; c < KC; ++c) {
            re[c] = warp_sum(re[c]);
            im[c] = warp_sum(im[c]);
        }
        if (lane == 0) {
            if constexpr (to_y) {
                add_row<KC>(y, out_off + row, ly, k, c0, kc, re, im, vec);
            } else {
#pragma unroll
                for (int c = 0; c < KC; ++c) ws[row * KC + c] = make_float2(re[c], im[c]);
            }
        }
    }
}

// y[out_off + j, c0 + c] += sum_rr op(A[rr, j]) * w(rr, c) for j < n_out,
// one thread per pair of output rows j, j+1 (one 16-byte load of A per
// rank row; a warp's loads cover 512 consecutive bytes).  A is row-major
// (n_rows, n_out) complex with n_out even.  w lives in shared memory,
// row-major w[rr*KC + c] (the low-rank intermediate) or, with W_COLS,
// column-major w[c*ldw + rr] (a staged x segment); every thread reads the
// same w entry.
template <int KC, bool W_COLS>
__device__ void col_combine(const float2* __restrict__ A, int n_rows,
                            int n_out, float csign, const float2* w, int ldw,
                            float2* __restrict__ y, long long ly, int k,
                            int c0, int kc, long long out_off, bool vec) {
    for (int j = 2 * threadIdx.x; j < n_out; j += 2 * blockDim.x) {
        float re0[KC], im0[KC], re1[KC], im1[KC];
#pragma unroll
        for (int c = 0; c < KC; ++c) re0[c] = im0[c] = re1[c] = im1[c] = 0.0f;
        for (int rr = 0; rr < n_rows; ++rr) {
            float4 a = __ldg(reinterpret_cast<const float4*>(A + (long long)rr * n_out + j));
            a.y *= csign;
            a.w *= csign;
#pragma unroll
            for (int c = 0; c < KC; ++c) {
                const float2 wv = W_COLS ? w[c * ldw + rr] : w[rr * KC + c];
                re0[c] = fmaf(a.x, wv.x, fmaf(-a.y, wv.y, re0[c]));
                im0[c] = fmaf(a.x, wv.y, fmaf(a.y, wv.x, im0[c]));
                re1[c] = fmaf(a.z, wv.x, fmaf(-a.w, wv.y, re1[c]));
                im1[c] = fmaf(a.z, wv.y, fmaf(a.w, wv.x, im1[c]));
            }
        }
        add_row<KC>(y, out_off + j, ly, k, c0, kc, re0, im0, vec);
        add_row<KC>(y, out_off + j + 1, ly, k, c0, kc, re1, im1, vec);
    }
}

// The bucket holding grid block `blk`: the last table row with first <= blk.
__device__ __forceinline__ int find_bucket(const Bucket* __restrict__ table,
                                           int n_buckets, long long blk) {
    int lo = 0, hi = n_buckets - 1;
    while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (table[mid].first <= blk) lo = mid; else hi = mid - 1;
    }
    return lo;
}

// The product of block i of bucket B for the column group c0 = blockIdx.y
// * KC, with shared memory xs (KC, max_ldx) followed by ws (max_r, KC).
// All three launch structures below run this body.
template <int KC>
__device__ __forceinline__ void block_product(
        const Bucket& B, long long i, const float2* __restrict__ x, long long lx,
        float2* __restrict__ y, long long ly, int k, int swapped, int symmetric,
        int conj_fwd, int conj_tr, float2* xs, float2* ws) {
    const int pt = (int)B.pt, ps = (int)B.ps, r = (int)B.r;
    const int c0 = blockIdx.y * KC;
    const int kc = min(KC, k - c0);
    const bool vec = KC % 2 == 0 && k % 2 == 0;  // see add_row
    const long long t = reinterpret_cast<const int*>(B.t_off)[i];
    const long long s = reinterpret_cast<const int*>(B.s_off)[i];
    const bool mirrored = symmetric && reinterpret_cast<const unsigned char*>(B.mirror)[i];
    const bool fwd = !swapped || mirrored;  // x[s:] -> y[t:]
    const bool tr = swapped || mirrored;    // x[t:] -> y[s:]
    const float sf = conj_fwd ? -1.0f : 1.0f, st = conj_tr ? -1.0f : 1.0f;
    const int ldx_s = x_ld(ps, KC), ldx_t = x_ld(pt, KC);

    if (r == 0) {
        const float2* D = reinterpret_cast<const float2*>(B.a) + i * pt * ps;
        if (fwd) {
            stage_x<KC>(xs, ldx_s, x, lx, k, c0, kc, s, ps);
            __syncthreads();
            row_dot<KC, true>(D, pt, ps, sf, xs, ldx_s, nullptr, y, ly, k, c0, kc, t, vec);
            __syncthreads();
        }
        if (tr) {
            stage_x<KC>(xs, ldx_t, x, lx, k, c0, kc, t, pt);
            __syncthreads();
            col_combine<KC, true>(D, pt, ps, st, xs, ldx_t, y, ly, k, c0, kc, s, vec);
        }
    } else {
        const float2* Ut = reinterpret_cast<const float2*>(B.a) + i * r * pt;
        const float2* V = reinterpret_cast<const float2*>(B.v) + i * r * ps;
        if (fwd) {
            stage_x<KC>(xs, ldx_s, x, lx, k, c0, kc, s, ps);
            __syncthreads();
            row_dot<KC, false>(V, r, ps, sf, xs, ldx_s, ws, nullptr, ly, k, c0, kc, 0, vec);
            __syncthreads();
            col_combine<KC, false>(Ut, r, pt, sf, ws, KC, y, ly, k, c0, kc, t, vec);
            __syncthreads();
        }
        if (tr) {
            stage_x<KC>(xs, ldx_t, x, lx, k, c0, kc, t, pt);
            __syncthreads();
            row_dot<KC, false>(Ut, r, pt, st, xs, ldx_t, ws, nullptr, ly, k, c0, kc, 0, vec);
            __syncthreads();
            col_combine<KC, false>(V, r, ps, st, ws, KC, y, ly, k, c0, kc, s, vec);
        }
    }
}

// 'fused': one CTA per (block, column group), every bucket in one launch.
template <int KC>
__global__ void __launch_bounds__(kThreads)
hmatrix_product_complex_kernel(const Bucket* __restrict__ table, int n_buckets,
                               const float2* __restrict__ x, long long lx,
                               float2* __restrict__ y, long long ly, int k,
                               int swapped, int symmetric, int conj_fwd,
                               int conj_tr, int max_ldx) {
    extern __shared__ float4 smem4[];
    float2* xs = reinterpret_cast<float2*>(smem4);  // (KC, max_ldx)
    float2* ws = xs + (long long)max_ldx * KC;      // (max_r, KC)
    const long long blk = blockIdx.x;
    const Bucket B = table[find_bucket(table, n_buckets, blk)];
    block_product<KC>(B, blk - B.first, x, lx, y, ly, k, swapped, symmetric,
                      conj_fwd, conj_tr, xs, ws);
}

// 'per_bucket' (K2-pb): one launch per bucket `row`, one CTA per (block of
// that bucket, column group); no bucket search.  max_ldx is the bucket's.
template <int KC>
__global__ void __launch_bounds__(kThreads)
hmatrix_product_complex_bucket_kernel(const Bucket* __restrict__ table, int row,
                                      const float2* __restrict__ x, long long lx,
                                      float2* __restrict__ y, long long ly, int k,
                                      int swapped, int symmetric, int conj_fwd,
                                      int conj_tr, int max_ldx) {
    extern __shared__ float4 smem4[];
    float2* xs = reinterpret_cast<float2*>(smem4);
    float2* ws = xs + (long long)max_ldx * KC;
    const Bucket B = table[row];
    block_product<KC>(B, blockIdx.x, x, lx, y, ly, k, swapped, symmetric,
                      conj_fwd, conj_tr, xs, ws);
}

// 'seq' (K2-seq): one launch, a persistent grid that walks every block in
// bucket order with a grid-stride loop.  Every storage case, symmetric
// included.
template <int KC>
__global__ void __launch_bounds__(kThreads)
hmatrix_product_complex_seq_kernel(const Bucket* __restrict__ table, int n_buckets,
                                   long long n_blocks, const float2* __restrict__ x,
                                   long long lx, float2* __restrict__ y, long long ly,
                                   int k, int swapped, int symmetric, int conj_fwd,
                                   int conj_tr, int max_ldx) {
    extern __shared__ float4 smem4[];
    float2* xs = reinterpret_cast<float2*>(smem4);
    float2* ws = xs + (long long)max_ldx * KC;
    for (long long blk = blockIdx.x; blk < n_blocks; blk += gridDim.x) {
        const Bucket B = table[find_bucket(table, n_buckets, blk)];
        block_product<KC>(B, blk - B.first, x, lx, y, ly, k, swapped, symmetric,
                          conj_fwd, conj_tr, xs, ws);
        __syncthreads();  // the next block restages xs and ws
    }
}

size_t smem_bytes(int max_ldx, int KC, long long max_r) {
    return ((size_t)max_ldx + max_r) * KC * sizeof(float2);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
    if (smem <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)smem);
}

// Resident CTAs of the whole card for (kernel instance KC, smem): the
// persistent grid of 'seq', computed once per (device, KC, smem) and kept.
struct GridEntry { int device, kc; size_t smem; int grid; };
GridEntry g_grids[64];
int g_n_grids = 0;

template <typename Kernel>
cudaError_t persistent_grid(Kernel kernel, int KC, size_t smem, int* grid) {
    int device = 0;
    cudaError_t e = cudaGetDevice(&device);
    if (e != cudaSuccess) return e;
    for (int q = 0; q < g_n_grids; ++q) {
        if (g_grids[q].device == device && g_grids[q].kc == KC && g_grids[q].smem == smem) {
            *grid = g_grids[q].grid;
            return cudaSuccess;
        }
    }
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

// Calls f with the column-group width KC (a std::integral_constant) that a
// product with k right-hand sides uses.
template <typename F>
cudaError_t with_kc(int k, F f) {
    if (k >= 8) return f(std::integral_constant<int, 8>{});
    if (k >= 3) return f(std::integral_constant<int, 4>{});
    if (k == 2) return f(std::integral_constant<int, 2>{});
    return f(std::integral_constant<int, 1>{});
}

unsigned col_groups(int k, int KC) { return (unsigned)((k + KC - 1) / KC); }

}  // namespace

// Plain C interface, loaded with ctypes.  `table` is a device int64 array
// of n_buckets rows of 10 fields (struct Bucket), sorted by `first`, no
// empty bucket, pointing at complex64 tensors; x (lx, k) and y (ly, k) are
// complex64 (interleaved re, im); y must be zeroed by the caller.
// conj_fwd / conj_tr conjugate the operator in the x[s:] -> y[t:] and the
// x[t:] -> y[s:] direction.  Each returns the cudaError_t of its launches
// (0 on success).

// 'fused': one launch over every bucket.
extern "C" int hm_k2_launch(const void* table, int n_buckets, long long n_blocks,
                            const void* x, long long lx, void* y, long long ly,
                            int k, int swapped, int symmetric, int conj_fwd,
                            int conj_tr, int max_dim, int max_r, void* stream) {
    if (n_blocks == 0 || k == 0) return 0;
    const Bucket* t = static_cast<const Bucket*>(table);
    const float2* xc = static_cast<const float2*>(x);
    float2* yc = static_cast<float2*>(y);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return with_kc(k, [&](auto kc) {
        constexpr int KC = decltype(kc)::value;
        const int max_ldx = x_ld(max_dim, KC);  // x_ld grows with n
        const size_t smem = smem_bytes(max_ldx, KC, max_r);
        cudaError_t e = allow_smem(hmatrix_product_complex_kernel<KC>, smem);
        if (e != cudaSuccess) return e;
        const dim3 grid((unsigned)n_blocks, col_groups(k, KC));
        hmatrix_product_complex_kernel<KC><<<grid, kThreads, smem, st>>>(
            t, n_buckets, xc, lx, yc, ly, k, swapped, symmetric, conj_fwd,
            conj_tr, max_ldx);
        return cudaGetLastError();
    });
}

// 'per_bucket' (K2-pb): one launch per table row.  `host_rows` is the
// host copy of the table (the same n_buckets rows), read for each row's
// block count and dims; every launch adds into the same y.
extern "C" int hm_k2_launch_per_bucket(const void* table, const void* host_rows,
                                       int n_buckets, const void* x, long long lx,
                                       void* y, long long ly, int k, int swapped,
                                       int symmetric, int conj_fwd, int conj_tr,
                                       void* stream) {
    if (k == 0) return 0;
    const Bucket* t = static_cast<const Bucket*>(table);
    const Bucket* h = static_cast<const Bucket*>(host_rows);
    const float2* xc = static_cast<const float2*>(x);
    float2* yc = static_cast<float2*>(y);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return with_kc(k, [&](auto kc) {
        constexpr int KC = decltype(kc)::value;
        for (int row = 0; row < n_buckets; ++row) {
            const long long dim = h[row].pt > h[row].ps ? h[row].pt : h[row].ps;
            const int max_ldx = x_ld((int)dim, KC);
            const size_t smem = smem_bytes(max_ldx, KC, h[row].r);
            cudaError_t e = allow_smem(hmatrix_product_complex_bucket_kernel<KC>, smem);
            if (e != cudaSuccess) return e;
            const dim3 grid((unsigned)h[row].nb, col_groups(k, KC));
            hmatrix_product_complex_bucket_kernel<KC><<<grid, kThreads, smem, st>>>(
                t, row, xc, lx, yc, ly, k, swapped, symmetric, conj_fwd, conj_tr,
                max_ldx);
            e = cudaGetLastError();
            if (e != cudaSuccess) return e;
        }
        return cudaSuccess;
    });
}

// 'seq' (K2-seq): one launch of a persistent grid over every bucket.
extern "C" int hm_k2_launch_seq(const void* table, int n_buckets, long long n_blocks,
                                const void* x, long long lx, void* y, long long ly,
                                int k, int swapped, int symmetric, int conj_fwd,
                                int conj_tr, int max_dim, int max_r, void* stream) {
    if (n_blocks == 0 || k == 0) return 0;
    const Bucket* t = static_cast<const Bucket*>(table);
    const float2* xc = static_cast<const float2*>(x);
    float2* yc = static_cast<float2*>(y);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return with_kc(k, [&](auto kc) {
        constexpr int KC = decltype(kc)::value;
        const int max_ldx = x_ld(max_dim, KC);
        const size_t smem = smem_bytes(max_ldx, KC, max_r);
        cudaError_t e = allow_smem(hmatrix_product_complex_seq_kernel<KC>, smem);
        if (e != cudaSuccess) return e;
        int resident = 0;
        e = persistent_grid(hmatrix_product_complex_seq_kernel<KC>, KC, smem, &resident);
        if (e != cudaSuccess) return e;
        const long long gx = n_blocks < resident ? n_blocks : resident;
        const dim3 grid((unsigned)gx, col_groups(k, KC));
        hmatrix_product_complex_seq_kernel<KC><<<grid, kThreads, smem, st>>>(
            t, n_buckets, n_blocks, xc, lx, yc, ly, k, swapped, symmetric,
            conj_fwd, conj_tr, max_ldx);
        return cudaGetLastError();
    });
}

extern "C" const char* hm_k2_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
