"""The plain reference: the configuration's dense operator, evaluated from
the points the benchmark made, in float64 (complex128) with plain torch.

It imports nothing of the program and takes nothing the program made: it
evaluates the kernel formula itself, block by block, and multiplies.  The
control puts it in the program's place at a lower precision (`round_to`):
the dense entries and the inputs rounded to TF32, bfloat16 or fp8 (e4m3)
before an exact product, which is what a kernel reading them at that
precision and summing in float32 computes, up to its own summation error.
"""

from __future__ import annotations

import torch

BLOCK = 4096  # rows and columns of one dense block evaluated at a time
PRECISIONS = ("tf32", "bf16", "fp8")


def round_to(t: torch.Tensor, precision: str | None) -> torch.Tensor:
    """t rounded to `precision` and returned in float64 / complex128 (None:
    unchanged).  TF32 rounds float32's mantissa to 10 bits, to nearest with
    ties away from zero, as cvt.rna.tf32.f32 does."""
    if precision is None:
        return t.to(torch.complex128 if t.is_complex() else torch.float64)
    if t.is_complex():
        return torch.complex(round_to(t.real, precision),
                             round_to(t.imag, precision))
    f = t.to(torch.float32)
    if precision == "tf32":
        bits = f.contiguous().view(torch.int32)
        f = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    elif precision == "bf16":
        f = f.to(torch.bfloat16)
    elif precision == "fp8":
        f = f.to(torch.float8_e4m3fn)
    else:
        raise ValueError(f"unknown precision {precision!r}")
    return f.to(torch.float64)


def dense_product(kernel, points, X: torch.Tensor, precision=None,
                  block: int = BLOCK) -> torch.Tensor:
    """K X for the dense K[i, j] = kernel(p_i, p_j) of points (3, N), X (N,
    m) on the device where the product runs; float64 or complex128."""
    P = torch.as_tensor(points.T, dtype=torch.float64, device=X.device)
    n = P.shape[0]
    Xr = round_to(X, precision)
    out = None
    for r0 in range(0, n, block):
        acc = None
        for c0 in range(0, n, block):
            K = kernel(P[r0:r0 + block, None, :], P[None, c0:c0 + block, :])
            part = round_to(K, precision) @ Xr[c0:c0 + block].to(
                torch.promote_types(K.dtype, Xr.dtype))
            acc = part if acc is None else acc + part
        if out is None:
            out = torch.empty((n,) + acc.shape[1:], dtype=acc.dtype,
                              device=X.device)
        out[r0:r0 + block] = acc
    return out


def dense_matrix(kernel, points, device, precision=None,
                 block: int = BLOCK) -> torch.Tensor:
    """The whole dense K (N, N), its entries rounded to `precision`."""
    P = torch.as_tensor(points.T, dtype=torch.float64, device=device)
    n = P.shape[0]
    rows = [torch.cat([round_to(kernel(P[r0:r0 + block, None, :],
                                       P[None, c0:c0 + block, :]), precision)
                       for c0 in range(0, n, block)], dim=1)
            for r0 in range(0, n, block)]
    return torch.cat(rows, dim=0)


def column_errors(Y: torch.Tensor, R: torch.Tensor) -> tuple:
    """For each column of the answer Y against the reference R (n, m): the
    relative 2-norm error, and the largest error of one row over the
    reference column's root-mean-square.  Returns two lists."""
    D = (Y.to(R.dtype) - R).abs()
    ref_norm = torch.linalg.vector_norm(R, dim=0)
    rel = (torch.linalg.vector_norm(D, dim=0) / ref_norm).tolist()
    rms = ref_norm / R.shape[0] ** 0.5
    row = (D.max(dim=0).values / rms).tolist()
    return rel, row


def entry_errors(Y: torch.Tensor, R: torch.Tensor, rows: torch.Tensor) -> list:
    """For each column c of the answer Y against the reference R (n, m): the
    relative error of its entry in row rows[c]."""
    cols = torch.arange(R.shape[1], device=R.device)
    rows = rows.to(R.device)
    want = R[rows, cols]
    return ((Y[rows, cols].to(R.dtype) - want).abs() / want.abs()).tolist()

