// Kernel K1: the real f32 bucketed H-matrix product y = H^(trans) x on Hopper.
//
// Replaces the TPU kernel `apply_hmatrix_pallas` of
// htool_python_tpu/ops/pallas_matvec.py (its `_fused_kernel` /
// `_step_body` / `_term_fwd` / `_term_tr`): one launch covers every bucket
// of the operator.  Its plain PyTorch version is `apply_hmatrix_padded` in
// htool_python_torch/ops/matvec.py; the wrapper is
// htool_python_torch/ops/cuda_matvec.py.
//
// What it computes.  The operator is a list of buckets of equally padded
// blocks.  A dense block adds  y[t:t+pt] += D x[s:s+ps]  (D is pt x ps,
// row-major); a low-rank block adds  y[t:t+pt] += Ut^T (V x[s:s+ps])  with
// rank-major factors Ut (r x pt) and V (r x ps).  trans = 'T' applies the
// transposes from the target rows into the source rows.  Symmetric storage
// adds, for blocks flagged `mirror`, the opposite-direction term too; for
// real data both directions then run whatever `trans` is.
//
// What bounds it.  Every stored entry is read once and used for 2 flops
// per right-hand side, far below the card's f32 rate even at k = 8, so the
// product is bound by the bytes it streams: stored bytes / 3.35 TB/s on an
// H100 SXM (about 0.125 ms for 417 MB).
//
// What the design does about it.  One CTA per (block, group of <= 8
// right-hand sides); the grid walks the buckets through a small device
// table, so there is one launch per product.  Each factor or dense row is
// read once, coalesced (neighbouring threads on neighbouring addresses,
// 16 bytes a thread), and never staged: only the block's input segment of
// x (column-major, so that those reads are free of bank conflicts) and the
// rank-sized intermediate w = V x live in shared memory.  Many
// blocks add into the same rows of y, so results go out with f32
// atomicAdd (their order varies from run to run), as float4 vector atomics
// where the row segment allows.  Faster designs (row
// ownership instead of atomics, TMA staging) are later work.
//
// Launch structures.  The reference's `matvec_kernel_mode` chooses how the
// buckets are launched; one block body (`block_product`) serves all three:
//   * 'fused' (`_launch_fused`, pallas_matvec.py:756): one launch, one CTA
//     per (block, column group), each CTA finds its bucket in the table;
//   * 'per_bucket' (K1-pb, `_launch_per_bucket`, pallas_matvec.py:522): one
//     launch per bucket, sized by that bucket's dims, no bucket search; all
//     launches add into the one zeroed y (the reference summed one partial
//     output per launch because a Pallas launch owns its output);
//   * 'seq' (K1-seq, `_launch_seq`, pallas_matvec.py:649): one launch of a
//     persistent grid (SMs x resident CTAs, from the occupancy calculator,
//     computed once per column-group width and shared-memory size) whose
//     CTAs walk the blocks in bucket order with a grid-stride loop.
// All three stream the same bytes, so the same bound holds for each.
//
// K1-al, the aligned low-rank layout.  With config.matvec_aligned_layout
// on, a float32 operator's low-rank buckets come pre-shifted into aligned
// windows (htool_python_torch/ops/matvec.py `align_lowrank`, lane 8 f32 =
// 32 bytes, one DRAM sector): every low-rank block's offsets are multiples
// of 8 rows and its factor widths whole windows of zero-padded columns.
// It replaces the reference's `_step_body` kind "alr"
// (pallas_matvec.py:355-378) with `_load_al` (:89) and `_accum_al` (:95),
// which read the same layout at 128 lanes.  It computes K1's function on
// that data and is bound by the same bytes (the canonical layout's; the
// zero columns are its extra cost).  The `aligned` instantiation of
// `block_product` (fused launch only, `hm_k1_launch_al`) uses the
// alignment where K1 cannot: its x segment starts on a 32-byte boundary
// and spans whole sectors, so it is staged with 16-byte vector loads and no
// ragged head (`stage_x_al`); at k = 1 and 2 its output window starts on a
// multiple of 8 rows, so four consecutive y values (4 rows, or 2 rows x 2
// columns) go out as one float4 atomicAdd (`col_combine_al`) where K1 adds
// one row at a time.  Dense buckets take K1's path unchanged; at k >= 4
// nothing changes (K1 already adds float4 over columns).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libhmatrix_product.so hmatrix_product.cu
// (done at first use by htool_python_torch/ops/cuda_build.py).

#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;

// One row of the device bucket table; every field is 8 bytes wide so the
// layout matches the int64 tensor the wrapper builds.
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

// y[yr, c0 + c] += acc[c] for c < kc, skipping all-zero rows (a padded
// block row adds nothing).  `vec`: the row segment is 16-byte aligned
// (k % 4 == 0; 8-byte for KC == 2), so Hopper's vector atomics (float4 /
// float2 atomicAdd, compute capability 9.x) add 4 (2) values at once and a
// warp's update of KC columns costs KC/4 memory operations instead of KC.
template <int KC>
__device__ __forceinline__ void add_row(float* __restrict__ y, long long yr,
                                        long long ly, int k, int c0, int kc,
                                        const float (&acc)[KC], bool vec) {
    if (yr >= ly) return;
    float* p = y + yr * k + c0;
    if constexpr (KC % 4 == 0) {
        if (vec) {
#pragma unroll
            for (int q = 0; q < KC / 4; ++q) {
                const float4 v = make_float4(acc[4 * q], acc[4 * q + 1],
                                             acc[4 * q + 2], acc[4 * q + 3]);
                if (4 * q < kc && (v.x != 0.0f || v.y != 0.0f || v.z != 0.0f || v.w != 0.0f))
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
        if (c < kc && acc[c] != 0.0f) atomicAdd(p + c, acc[c]);
}

// Column-major staging of the block's input segment: xs[c*ldx + j] =
// x[off + j, c0 + c] for j < n, zero outside x or past the k columns.  The
// leading dimension ldx = n + 4 keeps every column 16-byte aligned and
// shifts consecutive columns by 4 banks: row_dot's reads (a warp reads 32
// consecutive float4 of one column) are free of bank conflicts, and so are
// the staging writes (a warp covers 32/KC rows x KC columns) when n is a
// multiple of 32.
template <int KC>
__device__ void stage_x(float* xs, int ldx, const float* __restrict__ x,
                        long long lx, int k, int c0, int kc, long long off,
                        int n) {
    for (int e = threadIdx.x; e < n * KC; e += blockDim.x) {
        const int j = e / KC, c = e % KC;
        const long long row = off + j;
        xs[c * ldx + j] = (c < kc && row < lx) ? x[row * k + c0 + c] : 0.0f;
    }
}

// stage_x for a segment that starts on a multiple of 8 rows (n a multiple
// of 8), read with 16-byte loads: when the CTA takes every column (kc ==
// k) the segment x[off : off + n, :] is one contiguous, 32-byte aligned run
// of n * k floats; when k % 4 == 0 each row's KC columns are whole float4.
// Otherwise, or when the segment runs past x, it stages as stage_x does.
template <int KC>
__device__ void stage_x_al(float* xs, int ldx, const float* __restrict__ x,
                           long long lx, int k, int c0, int kc, long long off,
                           int n) {
    if (off + n > lx) {
        stage_x<KC>(xs, ldx, x, lx, k, c0, kc, off, n);
        return;
    }
    if (kc == k) {
        const float4* src = reinterpret_cast<const float4*>(x + off * k);
        const int n4 = n * k / 4;
        for (int q = threadIdx.x; q < n4; q += blockDim.x) {
            const float4 v = __ldg(src + q);
            if (k == 1) {
                reinterpret_cast<float4*>(xs)[q] = v;
                continue;
            }
            const float vals[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int e = 4 * q + i, j = e / k;
                xs[(e - j * k) * ldx + j] = vals[i];
            }
        }
        for (int e = threadIdx.x; e < n * (KC - kc); e += blockDim.x)
            xs[(kc + e / n) * ldx + e % n] = 0.0f;  // columns past k
        return;
    }
    if constexpr (KC % 4 == 0) {
        if (k % 4 == 0) {
            constexpr int G = KC / 4;  // float4 per row
            for (int e = threadIdx.x; e < n * G; e += blockDim.x) {
                const int j = e / G, g = e % G;
                float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
                if (4 * g < kc)
                    v = __ldg(reinterpret_cast<const float4*>(x + (off + j) * k + c0 + 4 * g));
                xs[(4 * g) * ldx + j] = v.x;
                xs[(4 * g + 1) * ldx + j] = v.y;
                xs[(4 * g + 2) * ldx + j] = v.z;
                xs[(4 * g + 3) * ldx + j] = v.w;
            }
            return;
        }
    }
    stage_x<KC>(xs, ldx, x, lx, k, c0, kc, off, n);
}

// out[row, c] = sum_j A[row, j] * xs[c*ldx + j] for row < n_rows, one warp
// per row.  A is row-major (n_rows, n_in) with n_in a multiple of 4 and
// rows 16-byte aligned.  to_y: atomically added into y[out_off + row,
// c0 + c]; otherwise written to ws[row*KC + c] in shared memory.
template <int KC, bool to_y>
__device__ void row_dot(const float* __restrict__ A, int n_rows, int n_in,
                        const float* xs, int ldx, float* ws,
                        float* __restrict__ y, long long ly, int k, int c0,
                        int kc, long long out_off, bool vec) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nw = blockDim.x >> 5, n4 = n_in >> 2;
    for (int row = warp; row < n_rows; row += nw) {
        const float4* A4 = reinterpret_cast<const float4*>(A + (long long)row * n_in);
        float acc[KC];
#pragma unroll
        for (int c = 0; c < KC; ++c) acc[c] = 0.0f;
        for (int q = lane; q < n4; q += 32) {
            const float4 a = __ldg(A4 + q);
#pragma unroll
            for (int c = 0; c < KC; ++c) {
                const float4 xv = reinterpret_cast<const float4*>(xs + c * ldx)[q];
                acc[c] = fmaf(a.x, xv.x, fmaf(a.y, xv.y, fmaf(a.z, xv.z,
                         fmaf(a.w, xv.w, acc[c]))));
            }
        }
#pragma unroll
        for (int c = 0; c < KC; ++c) acc[c] = warp_sum(acc[c]);
        if (lane == 0) {
            if constexpr (to_y) {
                add_row<KC>(y, out_off + row, ly, k, c0, kc, acc, vec);
            } else {
#pragma unroll
                for (int c = 0; c < KC; ++c) ws[row * KC + c] = acc[c];
            }
        }
    }
}

// y[out_off + j, c0 + c] += sum_rr A[rr, j] * w(rr, c) for j < n_out, one
// thread per output row j (a warp's updates then hit neighbouring rows).
// A is row-major (n_rows, n_out).  w lives in shared memory, row-major
// w[rr*KC + c] (the low-rank intermediate) or, with W_COLS, column-major
// w[c*ldw + rr] (a staged x segment); every thread reads the same w entry.
template <int KC, bool W_COLS>
__device__ void col_combine(const float* __restrict__ A, int n_rows, int n_out,
                            const float* w, int ldw, float* __restrict__ y,
                            long long ly, int k, int c0, int kc,
                            long long out_off, bool vec) {
    for (int j = threadIdx.x; j < n_out; j += blockDim.x) {
        float acc[KC];
#pragma unroll
        for (int c = 0; c < KC; ++c) acc[c] = 0.0f;
        for (int rr = 0; rr < n_rows; ++rr) {
            const float a = __ldg(A + (long long)rr * n_out + j);
            float wv[KC];
            if constexpr (W_COLS) {
#pragma unroll
                for (int c = 0; c < KC; ++c) wv[c] = w[c * ldw + rr];
            } else {
                load_kc<KC>(w + rr * KC, wv);
            }
#pragma unroll
            for (int c = 0; c < KC; ++c) acc[c] = fmaf(a, wv[c], acc[c]);
        }
        add_row<KC>(y, out_off + j, ly, k, c0, kc, acc, vec);
    }
}

// col_combine<KC, false> for k == KC <= 2 on an output window that starts
// on a multiple of 8 rows (n_out a multiple of 8): each thread owns R = 4 /
// KC consecutive rows, reads their R factor values of each rank row with
// one vector load, and adds its 4 consecutive y values (row-major: R rows x
// KC columns) with one float4 atomicAdd, skipped when all four are zero.
template <int KC>
__device__ void col_combine_al(const float* __restrict__ A, int n_rows,
                               int n_out, const float* w,
                               float* __restrict__ y, long long ly,
                               long long out_off) {
    constexpr int R = 4 / KC;
    for (int j0 = threadIdx.x * R; j0 < n_out; j0 += blockDim.x * R) {
        float acc[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[q] = 0.0f;
        for (int rr = 0; rr < n_rows; ++rr) {
            const float* a_row = A + (long long)rr * n_out + j0;
            float a[R];
            if constexpr (R == 4) {
                const float4 v = __ldg(reinterpret_cast<const float4*>(a_row));
                a[0] = v.x; a[1] = v.y; a[2] = v.z; a[3] = v.w;
            } else {
                const float2 v = __ldg(reinterpret_cast<const float2*>(a_row));
                a[0] = v.x; a[1] = v.y;
            }
            float wv[KC];
            load_kc<KC>(w + rr * KC, wv);
#pragma unroll
            for (int q = 0; q < R; ++q)
#pragma unroll
                for (int c = 0; c < KC; ++c)
                    acc[q * KC + c] = fmaf(a[q], wv[c], acc[q * KC + c]);
        }
        if (acc[0] == 0.0f && acc[1] == 0.0f && acc[2] == 0.0f && acc[3] == 0.0f)
            continue;
        const long long yr = out_off + j0;
        if (yr + R <= ly) {
            atomicAdd(reinterpret_cast<float4*>(y + yr * KC),
                      make_float4(acc[0], acc[1], acc[2], acc[3]));
        } else {
            for (int q = 0; q < 4; ++q)
                if (yr + q / KC < ly && acc[q] != 0.0f) atomicAdd(y + yr * KC + q, acc[q]);
        }
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
// * KC, with shared memory xs (KC, max_dim + 4) followed by ws (max_r, KC).
// All three launch structures below run this body; AL (K1-al, fused
// launch only) reads low-rank blocks of the aligned layout.
template <int KC, bool AL = false>
__device__ __forceinline__ void block_product(
        const Bucket& B, long long i, const float* __restrict__ x, long long lx,
        float* __restrict__ y, long long ly, int k, int swapped, int symmetric,
        float* xs, float* ws) {
    const int pt = (int)B.pt, ps = (int)B.ps, r = (int)B.r;
    const int c0 = blockIdx.y * KC;
    const int kc = min(KC, k - c0);
    const bool vec = k % (KC >= 4 ? 4 : 2) == 0;  // see add_row
    const long long t = reinterpret_cast<const int*>(B.t_off)[i];
    const long long s = reinterpret_cast<const int*>(B.s_off)[i];
    const bool mirrored = symmetric && reinterpret_cast<const unsigned char*>(B.mirror)[i];
    const bool fwd = !swapped || mirrored;  // x[s:] -> y[t:]
    const bool tr = swapped || mirrored;    // x[t:] -> y[s:]

    if (r == 0) {
        const float* D = reinterpret_cast<const float*>(B.a) + i * pt * ps;
        if (fwd) {
            stage_x<KC>(xs, ps + 4, x, lx, k, c0, kc, s, ps);
            __syncthreads();
            row_dot<KC, true>(D, pt, ps, xs, ps + 4, nullptr, y, ly, k, c0, kc, t, vec);
            __syncthreads();
        }
        if (tr) {
            stage_x<KC>(xs, pt + 4, x, lx, k, c0, kc, t, pt);
            __syncthreads();
            col_combine<KC, true>(D, pt, ps, xs, pt + 4, y, ly, k, c0, kc, s, vec);
        }
    } else {
        const float* Ut = reinterpret_cast<const float*>(B.a) + i * r * pt;
        const float* V = reinterpret_cast<const float*>(B.v) + i * r * ps;
        if constexpr (AL) {
            // K1-al: aligned segments; at k <= 2, float4 atomics over rows
            if (fwd) {
                stage_x_al<KC>(xs, ps + 4, x, lx, k, c0, kc, s, ps);
                __syncthreads();
                row_dot<KC, false>(V, r, ps, xs, ps + 4, ws, nullptr, ly, k, c0, kc, 0, vec);
                __syncthreads();
                if constexpr (KC <= 2)  // then k == KC
                    col_combine_al<KC>(Ut, r, pt, ws, y, ly, t);
                else
                    col_combine<KC, false>(Ut, r, pt, ws, KC, y, ly, k, c0, kc, t, vec);
                __syncthreads();
            }
            if (tr) {
                stage_x_al<KC>(xs, pt + 4, x, lx, k, c0, kc, t, pt);
                __syncthreads();
                row_dot<KC, false>(Ut, r, pt, xs, pt + 4, ws, nullptr, ly, k, c0, kc, 0, vec);
                __syncthreads();
                if constexpr (KC <= 2)  // then k == KC
                    col_combine_al<KC>(V, r, ps, ws, y, ly, s);
                else
                    col_combine<KC, false>(V, r, ps, ws, KC, y, ly, k, c0, kc, s, vec);
            }
            return;
        }
        if (fwd) {
            stage_x<KC>(xs, ps + 4, x, lx, k, c0, kc, s, ps);
            __syncthreads();
            row_dot<KC, false>(V, r, ps, xs, ps + 4, ws, nullptr, ly, k, c0, kc, 0, vec);
            __syncthreads();
            col_combine<KC, false>(Ut, r, pt, ws, KC, y, ly, k, c0, kc, t, vec);
            __syncthreads();
        }
        if (tr) {
            stage_x<KC>(xs, pt + 4, x, lx, k, c0, kc, t, pt);
            __syncthreads();
            row_dot<KC, false>(Ut, r, pt, xs, pt + 4, ws, nullptr, ly, k, c0, kc, 0, vec);
            __syncthreads();
            col_combine<KC, false>(V, r, ps, ws, KC, y, ly, k, c0, kc, s, vec);
        }
    }
}

// 'fused': one CTA per (block, column group), every bucket in one launch;
// AL: K1-al.
template <int KC, bool AL>
__global__ void __launch_bounds__(kThreads)
hmatrix_product_kernel(const Bucket* __restrict__ table, int n_buckets,
                       const float* __restrict__ x, long long lx,
                       float* __restrict__ y, long long ly, int k,
                       int swapped, int symmetric, int max_dim) {
    extern __shared__ float4 smem4[];
    float* xs = reinterpret_cast<float*>(smem4);
    float* ws = xs + (long long)(max_dim + 4) * KC;
    const long long blk = blockIdx.x;
    const Bucket B = table[find_bucket(table, n_buckets, blk)];
    block_product<KC, AL>(B, blk - B.first, x, lx, y, ly, k, swapped, symmetric, xs, ws);
}

// 'per_bucket' (K1-pb): one launch per bucket `row`, one CTA per (block of
// that bucket, column group); no bucket search.  max_dim is the bucket's.
template <int KC>
__global__ void __launch_bounds__(kThreads)
hmatrix_product_bucket_kernel(const Bucket* __restrict__ table, int row,
                              const float* __restrict__ x, long long lx,
                              float* __restrict__ y, long long ly, int k,
                              int swapped, int symmetric, int max_dim) {
    extern __shared__ float4 smem4[];
    float* xs = reinterpret_cast<float*>(smem4);
    float* ws = xs + (long long)(max_dim + 4) * KC;
    const Bucket B = table[row];
    block_product<KC>(B, blockIdx.x, x, lx, y, ly, k, swapped, symmetric, xs, ws);
}

// 'seq' (K1-seq): one launch, a persistent grid that walks every block in
// bucket order with a grid-stride loop.
template <int KC>
__global__ void __launch_bounds__(kThreads)
hmatrix_product_seq_kernel(const Bucket* __restrict__ table, int n_buckets,
                           long long n_blocks, const float* __restrict__ x,
                           long long lx, float* __restrict__ y, long long ly,
                           int k, int swapped, int symmetric, int max_dim) {
    extern __shared__ float4 smem4[];
    float* xs = reinterpret_cast<float*>(smem4);
    float* ws = xs + (long long)(max_dim + 4) * KC;
    for (long long blk = blockIdx.x; blk < n_blocks; blk += gridDim.x) {
        const Bucket B = table[find_bucket(table, n_buckets, blk)];
        block_product<KC>(B, blk - B.first, x, lx, y, ly, k, swapped, symmetric, xs, ws);
        __syncthreads();  // the next block restages xs and ws
    }
}

size_t smem_bytes(int KC, long long max_dim, long long max_r) {
    return (size_t)(max_dim + 4 + max_r) * KC * sizeof(float);
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
// empty bucket; y (ly, k) must be zeroed by the caller.  Each returns the
// cudaError_t of its launches (0 on success).

namespace {

template <bool AL>
int launch_fused(const void* table, int n_buckets, long long n_blocks,
                 const float* x, long long lx, float* y, long long ly, int k,
                 int swapped, int symmetric, int max_dim, int max_r,
                 void* stream) {
    if (n_blocks == 0 || k == 0) return 0;
    const Bucket* t = static_cast<const Bucket*>(table);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return with_kc(k, [&](auto kc) {
        constexpr int KC = decltype(kc)::value;
        const size_t smem = smem_bytes(KC, max_dim, max_r);
        cudaError_t e = allow_smem(hmatrix_product_kernel<KC, AL>, smem);
        if (e != cudaSuccess) return e;
        const dim3 grid((unsigned)n_blocks, col_groups(k, KC));
        hmatrix_product_kernel<KC, AL><<<grid, kThreads, smem, st>>>(
            t, n_buckets, x, lx, y, ly, k, swapped, symmetric, max_dim);
        return cudaGetLastError();
    });
}

}  // namespace

// 'fused': one launch over every bucket.
extern "C" int hm_k1_launch(const void* table, int n_buckets, long long n_blocks,
                            const float* x, long long lx, float* y, long long ly,
                            int k, int swapped, int symmetric, int max_dim,
                            int max_r, void* stream) {
    return launch_fused<false>(table, n_buckets, n_blocks, x, lx, y, ly, k,
                               swapped, symmetric, max_dim, max_r, stream);
}

// K1-al: the fused launch over data in the aligned low-rank layout (every
// low-rank block's offsets a multiple of 8 rows, its widths multiples of 8).
extern "C" int hm_k1_launch_al(const void* table, int n_buckets, long long n_blocks,
                               const float* x, long long lx, float* y, long long ly,
                               int k, int swapped, int symmetric, int max_dim,
                               int max_r, void* stream) {
    return launch_fused<true>(table, n_buckets, n_blocks, x, lx, y, ly, k,
                              swapped, symmetric, max_dim, max_r, stream);
}

// 'per_bucket' (K1-pb): one launch per table row.  `host_rows` is the
// host copy of the table (the same n_buckets rows), read for each row's
// block count and dims; every launch adds into the same y.
extern "C" int hm_k1_launch_per_bucket(const void* table, const void* host_rows,
                                       int n_buckets, const float* x, long long lx,
                                       float* y, long long ly, int k, int swapped,
                                       int symmetric, void* stream) {
    if (k == 0) return 0;
    const Bucket* t = static_cast<const Bucket*>(table);
    const Bucket* h = static_cast<const Bucket*>(host_rows);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return with_kc(k, [&](auto kc) {
        constexpr int KC = decltype(kc)::value;
        for (int row = 0; row < n_buckets; ++row) {
            const long long dim = h[row].pt > h[row].ps ? h[row].pt : h[row].ps;
            const size_t smem = smem_bytes(KC, dim, h[row].r);
            cudaError_t e = allow_smem(hmatrix_product_bucket_kernel<KC>, smem);
            if (e != cudaSuccess) return e;
            const dim3 grid((unsigned)h[row].nb, col_groups(k, KC));
            hmatrix_product_bucket_kernel<KC><<<grid, kThreads, smem, st>>>(
                t, row, x, lx, y, ly, k, swapped, symmetric, (int)dim);
            e = cudaGetLastError();
            if (e != cudaSuccess) return e;
        }
        return cudaSuccess;
    });
}

// 'seq' (K1-seq): one launch of a persistent grid over every bucket.
extern "C" int hm_k1_launch_seq(const void* table, int n_buckets, long long n_blocks,
                                const float* x, long long lx, float* y, long long ly,
                                int k, int swapped, int symmetric, int max_dim,
                                int max_r, void* stream) {
    if (n_blocks == 0 || k == 0) return 0;
    const Bucket* t = static_cast<const Bucket*>(table);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    return with_kc(k, [&](auto kc) {
        constexpr int KC = decltype(kc)::value;
        const size_t smem = smem_bytes(KC, max_dim, max_r);
        cudaError_t e = allow_smem(hmatrix_product_seq_kernel<KC>, smem);
        if (e != cudaSuccess) return e;
        int resident = 0;
        e = persistent_grid(hmatrix_product_seq_kernel<KC>, KC, smem, &resident);
        if (e != cudaSuccess) return e;
        const long long gx = n_blocks < resident ? n_blocks : resident;
        const dim3 grid((unsigned)gx, col_groups(k, KC));
        hmatrix_product_seq_kernel<KC><<<grid, kThreads, smem, st>>>(
            t, n_buckets, n_blocks, x, lx, y, ly, k, swapped, symmetric, max_dim);
        return cudaGetLastError();
    });
}

extern "C" const char* hm_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
