"""Kernels P1 and P2 on Hopper: the stream probes of the profiling path.

P1, `stream_probe`, is the counterpart of tools/profile_matvec3.py:53
`make_stream` (body `stream_kernel` :37): how fast the card reads 384 MiB
split over 1 to 24 buffers, in tiles of 1 to 16 MiB.  P2, `shape_stream`,
is the counterpart of tools/profile_matvec9c.py:27 `stream`: how fast it
reads an f32 array of about 384 MiB by the shape of its blocks.  Source:
htool_python_torch/csrc/stream_probe.cu, built by ops/cuda_build.py and
called through ctypes; the source says what each computes, what bounds it
and how it is laid out.

Each has its plain PyTorch version beside it (`stream_probe_plain`,
`shape_stream_plain`).  The wrapper runs the plain version on CPU tensors
only; on CUDA tensors it launches the kernel or raises.  LAUNCH_COUNTS
counts the wrapper's launches.

The plain versions sum in another order than the reference's grid and
than the kernels (the kernels sum each chunk of 64 rows, then the CTAs'
partials in a fixed order), so they agree to f32 round-off: P1 to 1e-6
relative (its entries are positive), P2 to 1e-6 of 1e-30 * sum|A| (its
entries are standard normal, so the sum cancels).

P2's kernel reads A as rows of its last dimension: neither G nor the
leading dimensions of the block shape reach it.  The TPU's windows of G
blocks have no counterpart on the card, so the cases that share a width
run the same launch over the same bytes (to within the whole windows of
G that `shape_blocks` keeps); `launch_groups` names one case for each.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

P1_NAME = "stream_probe"
P2_NAME = "shape_stream"
LAUNCH_COUNTS = {P1_NAME: 0, P2_NAME: 0}

TOTAL_MB = 384  # profile_matvec3.TOTAL_MB
SHAPE_TOTAL = 384 << 20  # profile_matvec9c.TOTAL
WIDTH = 512  # P1's buffer width
OUT_COLS = 128  # the columns of P1's output

# (step_mb, n_buf): profile_matvec3.main
STREAM_CASES = [(1, 1), (4, 1), (16, 1), (1, 4), (1, 12), (1, 24), (4, 12)]
# (name, block shape, G): profile_matvec9c.main
SHAPE_CASES = [
    ("3d_16x640_G96", (16, 640), 96),
    ("3d_32x256_G96", (32, 256), 96),
    ("3d_16x640_G24", (16, 640), 24),
    ("3d_80x128_G96", (80, 128), 96),
    ("3d_16x512_G96", (16, 512), 96),
    ("3d_16x768_G96", (16, 768), 96),
    ("3d_16x1024_G64", (16, 1024), 64),
    ("2d_8192x640_G1", (8192, 640), 1),
    ("2d_8192x256_G1", (8192, 256), 1),
    ("2d_8192x768_G1", (8192, 768), 1),
    ("2d_8192x1024_G1", (8192, 1024), 1),
]

MAX_BUFS = 32  # kMaxBufs in the .cu
CHUNK_ROWS = 64  # rows a CTA reads per chunk
_THREADS = 512  # about this many threads per CTA
_THREADS_PER_SM = 2048


def reset_launch_counts() -> None:
    for name in LAUNCH_COUNTS:
        LAUNCH_COUNTS[name] = 0


def rows_per_step(step_mb: int) -> int:
    """Rows of one P1 tile: step_mb MiB of 512 f32 columns."""
    return step_mb * (1 << 20) // (WIDTH * 4)


def make_stream(step_mb: int, n_buf: int, total_mb: int = TOTAL_MB, *, rng):
    """P1's inputs as `make_stream` draws them: n_buf f32 buffers of
    (rows, 512) from rng.rand, total_mb MiB in all, rows a whole number of
    step_mb MiB tiles.  The reference draws from numpy's global state, so
    `rng` is a np.random.RandomState (seeded as np.random.seed would be).
    Returns (buffers, grid steps of the reference's kernel)."""
    rows, grid = stream_rows(step_mb, n_buf, total_mb)
    bufs = [rng.rand(rows, WIDTH).astype(np.float32) for _ in range(n_buf)]
    return bufs, grid


def stream_rows(step_mb: int, n_buf: int, total_mb: int = TOTAL_MB):
    """(rows of each P1 buffer, grid steps of the reference's kernel):
    total_mb / n_buf MiB a buffer, cut to whole step_mb MiB tiles."""
    steps_per_buf = total_mb // n_buf // step_mb
    return steps_per_buf * rows_per_step(step_mb), steps_per_buf * n_buf


def tile_weights(b: int, spb: int, grid: int) -> np.ndarray:
    """How many times the reference adds each of buffer b's spb tiles: its
    clipped index map presents the first tile b*spb + 1 times, the last
    grid - (b+1)*spb + 1 times (one tile: grid times), the others once."""
    w = np.ones(spb, np.int64)
    w[0] += b * spb
    w[-1] += grid - (b + 1) * spb
    return w


def _check_stream(bufs, x, step_mb):
    if not 1 <= len(bufs) <= MAX_BUFS:
        raise ValueError(f"want 1 to {MAX_BUFS} buffers, got {len(bufs)}")
    rows = bufs[0].shape[0] if bufs[0].ndim == 2 else -1
    tile = rows_per_step(step_mb)
    for i, b in enumerate(bufs):
        if (b.dtype != torch.float32 or b.shape != (rows, WIDTH)
                or not b.is_contiguous() or b.device != x.device):
            raise ValueError(f"buffer {i} must be a contiguous float32 "
                             f"({rows}, {WIDTH}) tensor on {x.device}, got "
                             f"{b.dtype} {tuple(b.shape)} on {b.device}")
    if tile < 1 or rows % tile or rows == 0:
        raise ValueError(f"{rows} rows are not a whole number of "
                         f"{step_mb} MiB tiles")
    if x.dtype != torch.float32 or x.shape != (1, OUT_COLS):
        raise ValueError(f"x must be a float32 (1, {OUT_COLS}) tensor, got "
                         f"{x.dtype} {tuple(x.shape)}")
    return rows, tile


def stream_probe_plain(bufs, x, step_mb: int):
    """P1's plain version: x + sum_b sum_t weight(b, t) colsum(tile)[:128]
    (`tile_weights`), out (1, 128)."""
    rows, tile = _check_stream(bufs, x, step_mb)
    spb = rows // tile
    grid = spb * len(bufs)
    acc = torch.zeros(WIDTH, dtype=torch.float32, device=x.device)
    for b, buf in enumerate(bufs):
        w = torch.as_tensor(tile_weights(b, spb, grid), dtype=torch.float32,
                            device=x.device)
        acc += w @ buf.reshape(spb, tile, WIDTH).sum(1)
    return x + acc[:OUT_COLS]


def _grid(device, threads, n_chunks):
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(n_chunks, sms * (_THREADS_PER_SM // threads)))


def _threads(width):
    w4 = width // 4
    return w4 * max(1, _THREADS // w4)


def _library():
    from ..ops.cuda_build import load

    lib = load("stream_probe")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.sp_stream_probe.argtypes = [p, i, ll, ll, i, i, i, p, p, p, p]
    lib.sp_shape_stream.argtypes = [p, ll, i, i, i, i, p, p, p, p]
    lib.sp_stream_probe.restype = lib.sp_shape_stream.restype = i
    lib.sp_error_string.argtypes = [i]
    lib.sp_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib, rc, name):
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} "
                           f"({lib.sp_error_string(rc).decode()})")


def _check_aligned(t, name):
    if t.data_ptr() % 16:
        raise ValueError(f"{name} is not 16-byte aligned")


def stream_probe(bufs, x, step_mb: int):
    """Kernel P1 on CUDA tensors, its plain version on CPU tensors: out
    (1, 128) = x + the weighted column sums of bufs' step_mb MiB tiles (see
    stream_probe_plain)."""
    rows, tile = _check_stream(bufs, x, step_mb)
    if x.device.type == "cpu":
        return stream_probe_plain(bufs, x, step_mb)
    if tile % CHUNK_ROWS:
        raise ValueError(f"a {step_mb} MiB tile ({tile} rows) is not a "
                         f"multiple of {CHUNK_ROWS} rows")
    for i, b in enumerate(bufs):
        _check_aligned(b, f"buffer {i}")
    x = x.contiguous()
    lib = _library()
    threads = _threads(WIDTH)
    n_cta = _grid(x.device, threads, len(bufs) * rows // CHUNK_ROWS)
    partial = torch.empty((n_cta, WIDTH), dtype=torch.float32,
                          device=x.device)
    out = torch.empty((1, OUT_COLS), dtype=torch.float32, device=x.device)
    ptrs = (ctypes.c_void_p * len(bufs))(*[b.data_ptr() for b in bufs])
    with torch.cuda.device(x.device):
        rc = lib.sp_stream_probe(
            ptrs, len(bufs), rows, tile, CHUNK_ROWS, threads, n_cta,
            x.data_ptr(), out.data_ptr(), partial.data_ptr(),
            torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(lib, rc, P1_NAME)
    LAUNCH_COUNTS[P1_NAME] += 1
    return out


def make_shape_case(shape, G: int, total_bytes: int = SHAPE_TOTAL, *, rng):
    """P2's input as `stream` draws it: an f32 (nb, *shape) array of
    standard normals, nb the largest multiple of G that keeps it within
    total_bytes.  The reference seeds np.random.default_rng(0) for every
    case; `rng` is that Generator."""
    return rng.standard_normal((shape_blocks(shape, G, total_bytes),)
                               + tuple(shape)).astype(np.float32)


def shape_blocks(shape, G: int, total_bytes: int = SHAPE_TOTAL) -> int:
    """P2's block count: the largest multiple of G whose f32 blocks of
    `shape` fit in total_bytes."""
    return total_bytes // (int(np.prod(shape)) * 4) // G * G


def launch_groups(cases):
    """{case name: the first case of its width} over P2's (name, shape, G)
    cases: the cases whose kernel launches are the same."""
    first = {}
    return {name: first.setdefault(shape[-1], name)
            for name, shape, _ in cases}


def _check_shape(A, x, G):
    if A.dtype != torch.float32 or A.ndim < 2 or not A.is_contiguous():
        raise ValueError(f"A must be a contiguous float32 (nb, *shape) "
                         f"tensor, got {A.dtype} {tuple(A.shape)}")
    if G < 1 or A.shape[0] % G or A.shape[0] == 0:
        raise ValueError(f"{A.shape[0]} blocks are not a whole number of "
                         f"windows of {G}")
    if x.dtype != torch.float32 or x.shape != (1, 1) or x.device != A.device:
        raise ValueError(f"x must be a float32 (1, 1) tensor on {A.device}")


def shape_stream_plain(A, x, G: int):
    """P2's plain version: o (1, 1) = x + sum over windows of G blocks of
    sum(window) * 1e-30."""
    _check_shape(A, x, G)
    return x + (A.reshape(A.shape[0] // G, -1).sum(1) * 1e-30).sum()


def shape_stream(A, x, G: int):
    """Kernel P2 on CUDA tensors, its plain version on CPU tensors: o (1, 1)
    = x + 1e-30 * sum(A), read in rows of A's last dimension (see
    shape_stream_plain)."""
    _check_shape(A, x, G)
    if A.device.type == "cpu":
        return shape_stream_plain(A, x, G)
    width = A.shape[-1]
    if width % 4 or width > 4096:
        raise ValueError(f"the last dimension ({width}) must be a multiple "
                         "of 4 and at most 4096")
    _check_aligned(A, "A")
    x = x.contiguous()
    lib = _library()
    rows = A.numel() // width
    threads = _threads(width)
    n_cta = _grid(A.device, threads, -(-rows // CHUNK_ROWS))
    partial = torch.empty(n_cta, dtype=torch.float32, device=A.device)
    out = torch.empty((1, 1), dtype=torch.float32, device=A.device)
    with torch.cuda.device(A.device):
        rc = lib.sp_shape_stream(
            A.data_ptr(), rows, width, CHUNK_ROWS, threads, n_cta,
            x.data_ptr(), out.data_ptr(), partial.data_ptr(),
            torch.cuda.current_stream(A.device).cuda_stream)
    _raise_on(lib, rc, P2_NAME)
    LAUNCH_COUNTS[P2_NAME] += 1
    return out
