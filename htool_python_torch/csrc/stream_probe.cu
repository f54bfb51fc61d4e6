// Kernels P1 and P2 on Hopper: the stream probes of the profiling path.
//
// P1 (`sp_stream_probe`) replaces the TPU kernel `make_stream` of
// tools/profile_matvec3.py:53 (body `stream_kernel` :37): n_buf f32
// buffers of (rows, 512), read in tiles of `rows_per_tile` rows (step_mb
// MiB).  The reference's grid runs spb = rows / rows_per_tile steps per
// buffer, spb * n_buf in all, and at step i presents buffer b's tile
// clip(i - b*spb, 0, spb - 1); its body adds the column sums of every
// presented tile.  So a buffer's first tile counts b*spb + 1 times, its
// last grid - (b+1)*spb + 1 times and every other tile once, and
//     out (1, 128) = x + sum_b sum_t weight(b, t) colsum(tile b,t)[:128].
// The kernel reads each tile once and applies its weight (the TPU never
// re-copied a frozen block either), and it sums all 512 columns although
// only the first 128 reach out: a probe that read only those would not
// stream the buffer.
//
// P2 (`sp_shape_stream`) replaces the TPU kernel `stream` of
// tools/profile_matvec9c.py:27 (body `kernel` :35): an f32 array
// (nb, *shape) streamed in windows of G blocks,
//     o (1, 1) = x + 1e-30 * sum(A)
// (the reference scales each window's sum by 1e-30 and adds it; the
// scaled value only keeps the sum alive).  The array is read as rows of
// its last dimension, width W = shape[-1]: a thread row of W/4 threads
// walks one row with 16-byte loads (W = 640 is 160 float4, 5 warps), the
// card's counterpart of the TPU's lane-width question that P2 asks.
// Neither G nor the leading dimensions of the shape reach the kernel:
// cases that share W launch the same kernel over the same bytes, so the
// profiling path runs each width once (stream.py `launch_groups`).
//
// Plain PyTorch versions and wrappers: htool_python_torch/profiling/
// stream.py (`stream_probe_plain`, `shape_stream_plain`).
//
// What bounds them.  Both read every input byte once and do one add per
// float: bytes / 3.35 TB/s on an H100 SXM, 0.120 ms for P1's 384 MiB.
//
// What the design does about it.  One pass of CTAs over chunks of `chunk`
// rows (a grid-stride loop, `n_cta` CTAs sized by the wrapper to fill the
// card), neighbouring threads on neighbouring 16-byte addresses, several
// independent loads in flight per thread.  Each CTA reduces its column
// sums in shared memory and writes one partial row (P1: 512 column sums;
// P2: one scalar); a second launch of one CTA sums the partials in a
// fixed order and adds x.  No atomics, so the result does not depend on
// scheduling.  A chunk never straddles two P1 tiles (the wrapper keeps
// rows_per_tile a multiple of chunk), so the weight is applied once per
// chunk.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libstream_probe.so stream_probe.cu
// (done at first use by htool_python_torch/ops/cuda_build.py).

#include <cuda_runtime.h>

namespace {

constexpr int kMaxBufs = 32;
constexpr int kP1Width = 512;   // P1's buffer width
constexpr int kP1Out = 128;     // the columns of P1's output
constexpr int kFinishThreads = 1024;

struct BufPtrs { const float4* p[kMaxBufs]; };

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
    return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// Sum of v over the CTA (any blockDim <= 1024); every thread gets it.
__device__ float block_sum(float v) {
    __shared__ float sh[1024];
    sh[threadIdx.x] = v;
    __syncthreads();
    for (int s = 512; s > 0; s >>= 1) {
        if (threadIdx.x < s && threadIdx.x + s < blockDim.x)
            sh[threadIdx.x] += sh[threadIdx.x + s];
        __syncthreads();
    }
    const float total = sh[0];
    __syncthreads();
    return total;
}

// Column sums over rows of w4 float4.  Thread (ry, cx) = (tid / w4,
// tid % w4) adds rows ry, ry + ty, ... of each chunk at float4 column cx.
// P1: weighted by the chunk's tile, one partial row of 4*w4 sums per CTA;
// otherwise (P2) unweighted, one scalar per CTA.
template <bool P1>
__global__ void __launch_bounds__(1024)
colsum_kernel(BufPtrs bufs, int n_buf, long long rows, int w4, int chunk,
              long long rows_per_tile, float* __restrict__ partial) {
    extern __shared__ float4 red[];  // (ty, w4)
    const int ty = blockDim.x / w4;
    const int cx = threadIdx.x % w4, ry = threadIdx.x / w4;
    const long long chunks_per_buf = (rows + chunk - 1) / chunk;
    const long long n_chunks = chunks_per_buf * n_buf;
    const long long spb = P1 ? rows / rows_per_tile : 1;
    const long long steps = spb * n_buf;
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (long long c = blockIdx.x; c < n_chunks; c += gridDim.x) {
        const int b = (int)(c / chunks_per_buf);
        const long long row0 = (c - b * chunks_per_buf) * chunk;
        const int nr = (int)min((long long)chunk, rows - row0);
        const float4* src = bufs.p[b] + row0 * w4 + cx;
        float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 4
        for (int r = ry; r < nr; r += ty) s = add4(s, __ldg(src + (long long)r * w4));
        if constexpr (P1) {
            const long long t = row0 / rows_per_tile;
            const float w = 1.0f + (t == 0 ? (float)(b * spb) : 0.0f)
                          + (t == spb - 1 ? (float)(steps - (b + 1) * spb) : 0.0f);
            acc = make_float4(fmaf(w, s.x, acc.x), fmaf(w, s.y, acc.y),
                              fmaf(w, s.z, acc.z), fmaf(w, s.w, acc.w));
        } else {
            acc = add4(acc, s);
        }
    }
    red[threadIdx.x] = acc;
    __syncthreads();
    if (ry == 0)
        for (int q = 1; q < ty; ++q) acc = add4(acc, red[q * w4 + cx]);
    if constexpr (P1) {
        if (ry == 0) reinterpret_cast<float4*>(partial)[(long long)blockIdx.x * w4 + cx] = acc;
    } else {
        const float total = block_sum(ry == 0 ? (acc.x + acc.y) + (acc.z + acc.w) : 0.0f);
        if (threadIdx.x == 0) partial[blockIdx.x] = total;
    }
}

// P1's second pass: out[c] = x[c] + sum_q partial[q, c] for c < 128, the
// CTAs' partial rows summed in a fixed order (8 slices of them, each into
// 8 independent sums, then the slices in order).  The independent sums
// keep 8 loads of each thread in flight: with one running sum each warp
// waited out its ~66 loads one after the other, and this pass took a tenth
// of P1's time.
__global__ void __launch_bounds__(kFinishThreads)
p1_finish(const float* __restrict__ partial, int n_cta,
          const float* __restrict__ x, float* __restrict__ out) {
    __shared__ float sh[kFinishThreads];
    const int c = threadIdx.x % kP1Out, sl = threadIdx.x / kP1Out;
    const int ns = blockDim.x / kP1Out;
    float u[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    int q = sl;
    for (; q + 7 * ns < n_cta; q += 8 * ns) {
#pragma unroll
        for (int k = 0; k < 8; ++k) u[k] += partial[(long long)(q + k * ns) * kP1Width + c];
    }
    for (; q < n_cta; q += ns) u[0] += partial[(long long)q * kP1Width + c];
    float v = ((u[0] + u[1]) + (u[2] + u[3])) + ((u[4] + u[5]) + (u[6] + u[7]));
    sh[threadIdx.x] = v;
    __syncthreads();
    if (sl == 0) {
        for (int q = 1; q < ns; ++q) v += sh[q * kP1Out + c];
        out[c] = x[c] + v;
    }
}

// P2's second pass: o = x + 1e-30 * sum_q partial[q].
__global__ void __launch_bounds__(kFinishThreads)
p2_finish(const float* __restrict__ partial, int n_cta,
          const float* __restrict__ x, float* __restrict__ out) {
    float v = 0.0f;
    for (int q = threadIdx.x; q < n_cta; q += blockDim.x) v += partial[q];
    v = block_sum(v);
    if (threadIdx.x == 0) out[0] = x[0] + v * 1e-30f;
}

cudaError_t launch_colsum(bool p1, const BufPtrs& bufs, int n_buf, long long rows,
                          int width, int chunk, long long rows_per_tile, int threads,
                          int n_cta, float* partial, cudaStream_t st) {
    if (width <= 0 || width % 4 != 0 || chunk <= 0 || n_cta <= 0 || threads > 1024)
        return cudaErrorInvalidValue;
    const int w4 = width / 4;
    if (threads < w4 || threads % w4 != 0) return cudaErrorInvalidValue;
    const size_t smem = (size_t)threads * sizeof(float4);
    if (p1)
        colsum_kernel<true><<<n_cta, threads, smem, st>>>(bufs, n_buf, rows, w4, chunk,
                                                           rows_per_tile, partial);
    else
        colsum_kernel<false><<<n_cta, threads, smem, st>>>(bufs, n_buf, rows, w4, chunk,
                                                            rows_per_tile, partial);
    return cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes.  The wrapper allocates `partial`
// (P1: n_cta x 512 floats; P2: n_cta floats) and `out`; each function
// returns the cudaError_t of its launches (0 on success).

// P1: `bufs` is a host array of n_buf device pointers to (rows, 512) f32
// buffers, 16-byte aligned; rows a multiple of rows_per_tile, and
// rows_per_tile of chunk.  x and out are (1, 128).
extern "C" int sp_stream_probe(const void* const* bufs, int n_buf, long long rows,
                               long long rows_per_tile, int chunk, int threads,
                               int n_cta, const float* x, float* out, float* partial,
                               void* stream) {
    if (n_buf <= 0 || n_buf > kMaxBufs || rows <= 0 || rows_per_tile <= 0
        || rows % rows_per_tile != 0 || rows_per_tile % chunk != 0)
        return cudaErrorInvalidValue;
    BufPtrs p{};
    for (int b = 0; b < n_buf; ++b) p.p[b] = static_cast<const float4*>(bufs[b]);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t e = launch_colsum(true, p, n_buf, rows, kP1Width, chunk, rows_per_tile,
                                  threads, n_cta, partial, st);
    if (e != cudaSuccess) return e;
    p1_finish<<<1, kFinishThreads, 0, st>>>(partial, n_cta, x, out);
    return cudaGetLastError();
}

// P2: `a` is the array as rows of `width` floats (width a multiple of 4,
// 16-byte aligned); x and out are (1, 1).
extern "C" int sp_shape_stream(const float* a, long long rows, int width, int chunk,
                               int threads, int n_cta, const float* x, float* out,
                               float* partial, void* stream) {
    if (rows <= 0) return cudaErrorInvalidValue;
    BufPtrs p{};
    p.p[0] = reinterpret_cast<const float4*>(a);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t e = launch_colsum(false, p, 1, rows, width, chunk, 0, threads, n_cta,
                                  partial, st);
    if (e != cudaSuccess) return e;
    p2_finish<<<1, kFinishThreads, 0, st>>>(partial, n_cta, x, out);
    return cudaGetLastError();
}

extern "C" const char* sp_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
