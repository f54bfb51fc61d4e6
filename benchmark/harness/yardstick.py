"""The frozen yardstick of the product: its least bytes and operations, and
the card's published peaks.

Bytes: every compressed entry once at the data's element size (the
operator's unpadded storage, `Storage_size_in_bytes`), x read once and y
written once (N x k elements each).  Operations: 2 a stored entry and
column for real data, 8 for complex (one complex multiply-add).  The bound
is the larger of bytes over the HBM rate and operations over the highest
rate at which the card multiplies float32 inputs (TF32 dense on the tensor
cores), so no way of computing the product can read above it.
"""

from __future__ import annotations

# NVIDIA H100 SXM5 80 GB, published dense rates at its 700 W limit
HBM_BYTES_PER_S = 3.35e12
TF32_FLOP_PER_S = 495e12  # the highest f32-input rate: TF32 on tensor cores
PEAKS = {"hbm_bytes_per_s": HBM_BYTES_PER_S,
         "tf32_flop_per_s": TF32_FLOP_PER_S}


def product_bytes(stored_bytes: int, n_rows: int, n_cols: int, k: int,
                  itemsize: int) -> int:
    """Bytes a product y = H X must move at least: the stored entries, X
    (n_cols x k) read once, Y (n_rows x k) written once."""
    return stored_bytes + (n_rows + n_cols) * k * itemsize


def product_ops(stored_entries: int, k: int, is_complex: bool) -> int:
    return (8 if is_complex else 2) * stored_entries * k


def product_bound(stored_bytes: int, n_rows: int, n_cols: int, k: int,
                  itemsize: int, is_complex: bool) -> tuple:
    """(least seconds of one product, 'bytes' or 'operations')."""
    t_bytes = product_bytes(stored_bytes, n_rows, n_cols, k,
                            itemsize) / HBM_BYTES_PER_S
    t_ops = product_ops(stored_bytes // itemsize, k,
                        is_complex) / TF32_FLOP_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def stored_entries(blocks) -> int:
    """Entries a compressed operator stores: a dense block (m, n) m n, a
    low-rank block (m, n, r) r (m + n)."""
    return sum(b[0] * b[1] if len(b) == 2 else b[2] * (b[0] + b[1])
               for b in blocks)
