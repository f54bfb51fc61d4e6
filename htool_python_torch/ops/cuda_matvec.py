"""Kernels K1 and K2 on Hopper: the bucketed H-matrix product.

K1, the real f32 product, is the counterpart of
htool_python_tpu/ops/pallas_matvec.py `apply_hmatrix_pallas`; source
htool_python_torch/csrc/hmatrix_product.cu.  K2, the complex64 product, is
the counterpart of `apply_hmatrix_pallas_complex` there; source
htool_python_torch/csrc/hmatrix_product_complex.cu.  Both are built by
ops/cuda_build.py and called through ctypes.

Each kernel has three launch structures, chosen by the config knob
`matvec_kernel_mode` as in the reference (htool_python_tpu/config.py
`matvec_kernel_mode`, pallas_matvec.py `_kernel_mode`):

  * 'fused' (the default): one launch covers every bucket;
  * 'per_bucket' (K1-pb / K2-pb, the reference's `_launch_per_bucket`):
    one launch per bucket, all adding into the one zeroed y;
  * 'seq' (K1-seq / K2-seq, the reference's `_launch_seq`): one launch of
    a persistent grid that walks the buckets in order.

Only this wrapper reads the knob.  On a CUDA tensor the chosen structure
launches (never another one); the plain version has no launch structure,
so on the CPU every mode runs it.  LAUNCH_COUNTS counts each structure
under its own name (`hmatrix_product`, `hmatrix_product/per_bucket`,
`hmatrix_product/seq`, and the same for `hmatrix_product_complex`); a
per-bucket product counts one launch per non-empty bucket.

K1-al (`hmatrix_product/aligned`, the reference's `_step_body` kind
"alr"): float32 data in the aligned low-rank layout (ops/matvec.py
`align_lowrank`, which HMatrix._product_data gives with
config.matvec_aligned_layout on) launches K1's aligned instantiation in
the 'fused' structure.  The data is an ordinary bucket list, so the plain
version and the 'per_bucket' / 'seq' structures take it as it is (they
count as K1-pb / K1-seq).

Contract (the same as `apply_hmatrix_padded`, their plain version in
ops/matvec.py): for bucket data {'dense': [(D, t_off, s_off, mirror)],
'lr': [(Ut, V, t_off, s_off, mirror)]} and x_pad (L, k), return y_pad
(ny_pad, k) = H^(trans) x_pad for trans in 'N', 'T', 'C' and storage sym in
'N', 'S', 'H'.  Any k.  x_pad and y_pad
must both hold every block segment (BucketTable.extent rows), or the call
raises.  The data's dtype picks the kernel:

  * float32 data, float32 x: K1.  For real data 'C' is 'T' and 'H' is 'S'.
  * float32 data, complex64 x: K1 on the real view (`real_view_product`).
    H is real, so H (a + ib) = H a + i H b: the (L, k) complex x is read
    as (L, 2k) floats (torch.view_as_real, no copy), K1 runs over the 2k
    real columns, and its (ny_pad, 2k) result is viewed back as complex.
  * complex64 data: K2, with a float32 x promoted to complex64 first.
    trans 'C' conjugates the operator, and a hermitian ('H') mirror term
    is conjugated; the wrapper turns both into one conjugation flag per
    direction of a block (`_conj_flags`, the plain version's conj_main /
    conj_mirror).
  * float64 or complex128 on CUDA: NotImplementedError (ROADMAP item 22;
    the TPU had no f64 kernel either).

Tolerance: many blocks add into the same rows of y with f32 atomicAdd, in
an order that changes from run to run, so either kernel agrees with the
plain version to f32 summation round-off (checked at 1e-5 relative), not
bit for bit.

The operand's device decides: CPU tensors go to the plain version; on a
CUDA tensor this always launches a kernel or raises, never falls back.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..config import get_config
from .matvec import apply_hmatrix_padded, is_aligned

KERNEL_NAME = "hmatrix_product"  # K1
K2_NAME = "hmatrix_product_complex"
ALIGNED_NAME = "hmatrix_product/aligned"  # K1-al

MODES = ("fused", "per_bucket", "seq")


def launch_name(kernel: str, mode: str) -> str:
    """The LAUNCH_COUNTS key of `kernel` launched in `mode`."""
    return kernel if mode == "fused" else f"{kernel}/{mode}"


# launches of each kernel and structure, counted where the wrapper
# launches it
LAUNCH_COUNTS = {launch_name(kern, mode): 0 for kern in (KERNEL_NAME, K2_NAME)
                 for mode in MODES}
LAUNCH_COUNTS[ALIGNED_NAME] = 0

_TABLE_FIELDS = 10  # int64 fields per bucket row (struct Bucket in the .cu)

# the data dtype each kernel takes
_KERNEL_OF = {torch.float32: KERNEL_NAME, torch.complex64: K2_NAME}

_F64_ITEM = ("float64 and complex128 products on CUDA are not ported: "
             "ROADMAP queue 1, item 22")


def reset_launch_counts() -> None:
    for name in LAUNCH_COUNTS:
        LAUNCH_COUNTS[name] = 0


def kernel_mode() -> str:
    """The configured launch structure; raises on an unknown one."""
    mode = get_config().matvec_kernel_mode
    if mode not in MODES:
        raise ValueError(f"matvec_kernel_mode must be one of {MODES}, got "
                         f"{mode!r}")
    return mode


def _library(name):
    from .cuda_build import load

    lib = load(name)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    pre = "hm_k1" if name == KERNEL_NAME else "hm_k2"
    conj = [] if name == KERNEL_NAME else [i, i]  # conj_fwd, conj_tr
    whole = [p, i, ll, p, ll, p, ll, i, i, i, *conj, i, i, p]
    aligned = [("launch_al", whole)] if name == KERNEL_NAME else []
    for suffix, argtypes in (
            ("launch", whole), ("launch_seq", whole), *aligned,
            ("launch_per_bucket", [p, p, i, p, ll, p, ll, i, i, i, *conj,
                                   p])):
        fn = getattr(lib, f"{pre}_{suffix}")
        fn.argtypes = argtypes
        fn.restype = i
    err = lib.hm_error_string if name == KERNEL_NAME else lib.hm_k2_error_string
    err.argtypes = [i]
    err.restype = ctypes.c_char_p
    return lib


def _data_dtype(data):
    """dtype of the data's first stored tensor (None without buckets)."""
    for kind in ("dense", "lr"):
        if data[kind]:
            return data[kind][0][0].dtype
    return None


def _check_dtype(dtype, name):
    if dtype in (torch.float64, torch.complex128):
        raise NotImplementedError(f"{name} is {dtype}: {_F64_ITEM}")
    if dtype not in _KERNEL_OF:
        raise TypeError(f"{name} has dtype {dtype}, want float32 or "
                        "complex64")


def _check_operand(t, name, device, ndim, dtype):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, x on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, the operator {dtype}")
    if t.ndim != ndim or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {ndim}-d tensor, "
                         f"got shape {tuple(t.shape)}")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} is not 16-byte aligned")


def _check_meta(t_off, s_off, mirror, nb, device):
    for name, t, dt in (("t_off", t_off, torch.int32),
                        ("s_off", s_off, torch.int32),
                        ("mirror", mirror, torch.bool)):
        if (t.device != device or t.dtype != dt or t.shape != (nb,)
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous ({nb},) {dt} "
                             f"tensor on {device}")


def _bucket_rows(data, device, dtype):
    """Host rows of the device bucket table, plus max dims and rank."""
    rows, first, max_dim, max_r = [], 0, 1, 1
    for kind in ("dense", "lr"):
        for entry in data[kind]:
            if kind == "dense":
                D, t_off, s_off, mirror = entry
                _check_operand(D, "D", device, 3, dtype)
                nb, pt, ps = D.shape
                a, v, r = D.data_ptr(), 0, 0
            else:
                Ut, V, t_off, s_off, mirror = entry
                _check_operand(Ut, "Ut", device, 3, dtype)
                _check_operand(V, "V", device, 3, dtype)
                nb, r, pt = Ut.shape
                ps = V.shape[2]
                if V.shape[:2] != (nb, r):
                    raise ValueError(f"Ut {tuple(Ut.shape)} and V "
                                     f"{tuple(V.shape)} do not match")
                a, v = Ut.data_ptr(), V.data_ptr()
                max_r = max(max_r, r)
            if pt % 4 or ps % 4:
                raise ValueError(f"padded block dims ({pt}, {ps}) must be "
                                 "multiples of 4")
            _check_meta(t_off, s_off, mirror, nb, device)
            if nb == 0:
                continue
            rows.append((a, v, t_off.data_ptr(), s_off.data_ptr(),
                         mirror.data_ptr(), first, nb, pt, ps, r))
            first += nb
            max_dim = max(max_dim, pt, ps)
    return rows, first, max_dim, max_r


def _extent(data) -> int:
    """max(t_off + pt, s_off + ps) over every block: the rows that x and y
    must both hold (one host sync)."""
    segments = ([(t, s, D.shape[1], D.shape[2])
                 for D, t, s, _ in data["dense"]]
                + [(t, s, Ut.shape[2], V.shape[2])
                   for Ut, V, t, s, _ in data["lr"]])
    ends = [torch.stack([t.max().long() + pt, s.max().long() + ps])
            for t, s, pt, ps in segments if t.numel()]
    return int(torch.cat(ends).max()) if ends else 0


class BucketTable:
    """One operator's bucket data as K1 or K2 takes it, checked once.

    `dtype` is the data's dtype, which picks the kernel; a product refuses
    data of another dtype.  `extent` is where the furthest block segment
    ends, max(t_off + pt, s_off + ps).  A product reads and writes both
    sides of every block (mirror terms, and the plain version's masked
    ones), so x and y must both hold `extent` rows; the wrapper checks that
    on every call, since the kernels themselves skip rows past the end of
    y and read zeros past the end of x.  `aligned`: the data is in the
    aligned low-rank layout, which a fused K1 product runs as K1-al.  On CUDA the table also holds the
    device table of bucket descriptors (struct Bucket in the .cu files),
    built after every operand was checked, and its host copy `host_rows`,
    which a per-bucket product reads for each launch's block count and
    dims (no device read).  It names the data's tensors by
    pointer: it stays valid while the data's containers and tensors do
    (HMatrix builds one at its first product and drops it on copy and
    whenever its buckets are replaced).
    """

    def __init__(self, data, device):
        device = torch.device(device)
        if device.type not in ("cpu", "cuda"):
            raise ValueError(f"unsupported device {device}")
        self.device = device
        self.dtype = _data_dtype(data)
        self.aligned = is_aligned(data)
        self.extent = _extent(data)
        self.table = None
        if device.type == "cuda":
            self.n_blocks = 0
            if self.dtype is not None:
                _check_dtype(self.dtype, "the operator")
                rows, self.n_blocks, self.max_dim, self.max_r = _bucket_rows(
                    data, device, self.dtype)
                self.n_buckets = len(rows)
                self.host_rows = np.ascontiguousarray(
                    np.asarray(rows, dtype=np.int64).reshape(-1,
                                                             _TABLE_FIELDS))
                self.table = torch.from_numpy(self.host_rows).to(device)


def _conj_flags(trans: str, sym: str):
    """(conjugate the x[s:] -> y[t:] direction, the x[t:] -> y[s:] one) of
    K2: 'N' runs the main term forward and the mirror backward, 'T' / 'C'
    the other way round; the main term is conjugated for 'C', the mirror
    for (sym == 'H') != (trans == 'C') (plain version: conj_main,
    conj_mirror)."""
    conj_main = trans == "C"
    conj_mirror = (sym == "H") != (trans == "C")
    if trans == "N":
        return False, conj_mirror
    return conj_mirror, conj_main


def _launch(name, mode, table, x, y, trans, sym):
    """Kernel `name` in launch structure `mode` over `table`, x (L, k) into
    the zeroed y (ny, k); x and y hold the kernel's dtype."""
    lib = _library(name)
    counter = (ALIGNED_NAME if name == KERNEL_NAME and mode == "fused"
               and table.aligned else launch_name(name, mode))
    device = x.device
    L, k = x.shape
    stream = torch.cuda.current_stream(device).cuda_stream
    pre, err = (("hm_k1", lib.hm_error_string) if name == KERNEL_NAME
                else ("hm_k2", lib.hm_k2_error_string))
    conj = ([] if name == KERNEL_NAME
            else [int(c) for c in _conj_flags(trans, sym)])
    io = (x.data_ptr(), L, y.data_ptr(), y.shape[0], k, int(trans != "N"),
          int(sym != "N"), *conj)
    with torch.cuda.device(device):
        if mode == "per_bucket":
            rc = getattr(lib, pre + "_launch_per_bucket")(
                table.table.data_ptr(), table.host_rows.ctypes.data,
                table.n_buckets, *io, stream)
        else:
            fn = getattr(lib, pre + ("_launch_seq" if mode == "seq"
                                     else "_launch_al" if counter
                                     == ALIGNED_NAME else "_launch"))
            rc = fn(table.table.data_ptr(), table.n_buckets, table.n_blocks,
                    *io, table.max_dim, table.max_r, stream)
    if rc != 0:
        raise RuntimeError(f"{counter} launch failed: CUDA "
                           f"error {rc} ({err(rc).decode()})")
    LAUNCH_COUNTS[counter] += table.n_buckets if mode == "per_bucket" else 1


def real_view_product(real_product, x_pad, ny_pad: int):
    """H x_pad for a real f32 operator H and a complex64 x_pad (L, k): H is
    real, so H (a + ib) = H a + i H b.  x_pad is read as its (L, 2k) f32
    view (re, im interleaved per column, no copy) and
    `real_product(x_real, y_real)` adds H x_real into the (ny_pad, 2k) f32
    view of the zeroed complex result, which is returned."""
    L, k = x_pad.shape
    y = torch.zeros((ny_pad, k), dtype=torch.complex64, device=x_pad.device)
    real_product(torch.view_as_real(x_pad).reshape(L, 2 * k),
                 torch.view_as_real(y).reshape(ny_pad, 2 * k))
    return y


def apply_hmatrix_cuda(data, x_pad, ny_pad: int, trans: str, sym: str,
                       table: BucketTable | None = None):
    """y_pad (ny_pad, k) = H^(trans) x_pad through kernel K1 or K2 (CUDA
    tensors) or their plain version (CPU tensors).  `table`: the data's
    BucketTable, built here when not given.  See the module docstring."""
    if trans not in ("N", "T", "C"):
        raise ValueError(f"trans must be 'N', 'T' or 'C', got {trans!r}")
    if sym not in ("N", "S", "H"):
        raise ValueError(f"sym must be 'N', 'S' or 'H', got {sym!r}")
    device = x_pad.device
    if table is None:
        table = BucketTable(data, device)
    elif table.device != device:
        raise ValueError(f"the bucket table is on {table.device}, x on "
                         f"{device}")
    if table.dtype != _data_dtype(data):
        raise ValueError(f"the bucket table was built for {table.dtype} "
                         f"data, not {_data_dtype(data)}")
    L = x_pad.shape[0]
    if table.extent > min(L, ny_pad):
        raise ValueError(f"a block segment ends at row {table.extent}, "
                         f"past x ({L} rows) or y ({ny_pad} rows)")
    mode = kernel_mode()
    if device.type == "cpu":
        return apply_hmatrix_padded(data, x_pad, ny_pad, trans, sym)
    _check_dtype(x_pad.dtype, "x_pad")
    dtype = (x_pad.dtype if table.dtype is None
             else torch.promote_types(table.dtype, x_pad.dtype))
    k = x_pad.shape[1]
    if table.n_blocks == 0 or k == 0:
        return torch.zeros((ny_pad, k), dtype=dtype, device=device)
    name = _KERNEL_OF[table.dtype]
    if table.dtype == torch.float32 and dtype == torch.complex64:
        _check_operand(x_pad, "x_pad", device, 2, torch.complex64)
        return real_view_product(
            lambda xr, yr: _launch(name, mode, table, xr, yr, trans, sym),
            x_pad, ny_pad)
    x_pad = x_pad.to(dtype)
    _check_operand(x_pad, "x_pad", device, 2, dtype)
    y = torch.zeros((ny_pad, k), dtype=dtype, device=device)
    _launch(name, mode, table, x_pad, y, trans, sym)
    return y
