"""What a product on the card is held to: its bound by bytes or operations
(`product_bound`) and the read rate the card reaches in this run
(`p1_best_gbs`).  Shared by chip_smoke.py and the K1 sweeps (k1_sweeps.py).

The rates are the published peaks of one H100 SXM (NVIDIA's data sheet,
dense, at the full 700 W power limit).
"""

from __future__ import annotations

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32_FLOPS = 67e12  # H100 SXM f32 outside the tensor cores
TF32_FLOPS = 495e12  # H100 SXM TF32 tensor cores, dense
F64_FLOPS = 67e12  # H100 SXM FP64 tensor cores (DFMA: 33.5 TFLOP/s)


def product_bound(data, L, k, x_dtype=None):
    """(bound ms, bound_by) of one product with k columns of an x of
    `x_dtype` (default: the data's dtype): the bytes it must move (every
    stored entry once at its storage element size, 9 bytes of offsets and
    mirror flag per block, x read once and y written once at the size of
    the promoted dtype of data and x) over the HBM rate, against its flops
    (per stored entry, column and use — a mirrored block is used twice —
    2 for real data and x, 4 for real data and a complex x, whose 2k real
    columns it runs, 8 for complex data: 4 multiplies and 4 adds) over the
    rate of what the kernel multiplies on.  float32 / complex64 results:
    the f32 rate, and at k > 8, where K1 and K2 multiply on the tensor
    cores in 3xTF32 (K2 as two real products over the 2k interleaved real
    columns: the same 8 flops per complex entry and column), three TF32
    products for each f32 one at the TF32 rate.  float64 / complex128
    results (the f64 family, on float64 / complex128 data or reading
    float32 / complex64 data): the FP64 tensor-core peak (F64_FLOPS, 67
    TFLOP/s), on which that family multiplies at every k."""
    nbytes = 0
    entry_uses = 0
    data_dtype = None
    for entry in data["dense"] + data["lr"]:
        mats, mirror = entry[:-3], entry[-1]
        data_dtype = mats[0].dtype
        per_block = sum(m[0].numel() for m in mats)
        uses = mirror.numel() + int(mirror.sum())
        nbytes += (sum(m.numel() * m.element_size() for m in mats)
                   + 9 * mirror.numel())
        entry_uses += per_block * uses
    if data_dtype is None:
        return 0.0, "bytes"
    out = torch.promote_types(data_dtype, x_dtype or data_dtype)
    per = 8 if data_dtype.is_complex else 4 if out.is_complex else 2
    flops = per * k * entry_uses
    nbytes += 2 * int(L) * k * torch.empty((), dtype=out).element_size()
    t_bytes = nbytes / HBM_BYTES_PER_S
    if out.to_real() == torch.float64:
        t_ops = flops / F64_FLOPS
    else:
        t_ops = 3 * flops / TF32_FLOPS if k > 8 else flops / F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def p1_best_gbs(device, reps=20):
    """P1's best read rate over its buffer cases (stream.STREAM_CASES, 384
    MiB each), by CUDA events: the read rate the card reaches in this run,
    in GB/s."""
    from . import stream
    from .timing import cuda_ms

    g = torch.Generator(device).manual_seed(5)
    x = torch.rand((1, stream.OUT_COLS), device=device, generator=g)
    best = 0.0
    for step_mb, n_buf in stream.STREAM_CASES:
        rows, _ = stream.stream_rows(step_mb, n_buf)
        bufs = [torch.rand((rows, stream.WIDTH), device=device, generator=g)
                for _ in range(n_buf)]
        ms = cuda_ms(lambda: stream.stream_probe(bufs, x, step_mb), reps=reps)
        best = max(best, sum(b.numel() * 4 for b in bufs) / ms / 1e6)
        del bufs
    return best
