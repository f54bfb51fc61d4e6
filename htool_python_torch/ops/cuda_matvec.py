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

K1 walks the work list of its BucketTable (ops/matvec.py `work_list`:
block slices of at most WORK_ROWS rows, every stored entry in exactly one
item): 'fused' over the items largest first, 'seq' over them in bucket
order, 'per_bucket' one launch per bucket over that bucket's items.  One
K1 launch takes up to K1_PASS_COLS columns; a wider x runs in passes of
that many columns, each pass one launch (per bucket, for 'per_bucket').

Only this wrapper reads the knob.  On a CUDA tensor the chosen structure
launches (never another one); the plain version has no launch structure,
so on the CPU every mode runs it.  LAUNCH_COUNTS counts each structure
under its own name (`hmatrix_product`, `hmatrix_product/per_bucket`,
`hmatrix_product/seq`, and the same for `hmatrix_product_complex`); a
per-bucket product counts one launch per non-empty bucket.

K1-al (`hmatrix_product/aligned`, the reference's `_step_body` kind
"alr"): float32 data in the aligned low-rank layout (ops/matvec.py
`align_lowrank`, which HMatrix._product_data gives with
config.matvec_aligned_layout on) launches K1 through its aligned entry
point `hm_k1_launch_al` in the 'fused' structure: the same body, whose
x strips of low-rank blocks are then whole aligned sectors and whose
k <= 2 output rows go out four (two) at a time.  The data is an ordinary
bucket list, so the plain version and the 'per_bucket' / 'seq' structures
take it as it is (they count as K1-pb / K1-seq).

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
bit for bit.  K1 at more than 8 columns multiplies on the tensor cores in
3xTF32 (each f32 operand split into two TF32 parts), which keeps f32's
round-off.

The operand's device decides: CPU tensors go to the plain version; on a
CUDA tensor this always launches a kernel or raises, never falls back.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..config import get_config
from .matvec import apply_hmatrix_padded, is_aligned, work_list

KERNEL_NAME = "hmatrix_product"  # K1
K2_NAME = "hmatrix_product_complex"
ALIGNED_NAME = "hmatrix_product/aligned"  # K1-al

MODES = ("fused", "per_bucket", "seq")

# columns of one K1 launch (kMaxCols in csrc/hmatrix_product.cu); a wider x
# runs in passes of this many columns
K1_PASS_COLS = 128


def launch_name(kernel: str, mode: str) -> str:
    """The LAUNCH_COUNTS key of `kernel` launched in `mode`."""
    return kernel if mode == "fused" else f"{kernel}/{mode}"


# launches of each kernel and structure, counted where the wrapper
# launches it
LAUNCH_COUNTS = {launch_name(kern, mode): 0 for kern in (KERNEL_NAME, K2_NAME)
                 for mode in MODES}
LAUNCH_COUNTS[ALIGNED_NAME] = 0

_TABLE_FIELDS = 10  # int64 fields per bucket row (struct Bucket, K2's .cu)

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


_LIBS = {}


def _library(name):
    """The kernel library `name`, built and loaded at first use, with its
    functions' ctypes signatures set once."""
    if name in _LIBS:
        return _LIBS[name]
    from .cuda_build import load

    lib = load(name)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    if name == KERNEL_NAME:
        # items, n_items, x, lx, y, ly, k, swapped, symmetric, stream
        whole = [p, ll, p, ll, p, ll, i, i, i, p]
        signatures = (("launch", whole), ("launch_al", whole),
                      ("launch_seq", whole),
                      ("launch_per_bucket", [p, p, i, p, ll, p, ll, i, i, i,
                                             p]))
        pre, err = "hm_k1", lib.hm_error_string
    else:
        whole = [p, i, ll, p, ll, p, ll, i, i, i, i, i, i, i, p]
        signatures = (("launch", whole), ("launch_seq", whole),
                      ("launch_per_bucket", [p, p, i, p, ll, p, ll, i, i, i,
                                             i, i, p]))
        pre, err = "hm_k2", lib.hm_k2_error_string
    for suffix, argtypes in signatures:
        fn = getattr(lib, f"{pre}_{suffix}")
        fn.argtypes = argtypes
        fn.restype = i
    err.argtypes = [i]
    err.restype = ctypes.c_char_p
    _LIBS[name] = lib
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


def _item_records(data, order, device):
    """K1's work items `order` ((n, 4) host array of (bucket row, block,
    lo, hi), ops/matvec.py `work_list`) as the kernel reads them: an int64
    (n, 6) tensor on `device` of struct Item records
    (csrc/hmatrix_product.cu), each naming its factor rows by address, its
    offsets (a dense slice's target already moved to its first row), rows,
    widths and flags (1: dense, 2: mirror), so that the kernel reads one
    record per item and nothing else about it.  Built on the host: one copy
    of the offsets and mirror flags down, one of the records up."""
    buckets = [e for kind in ("dense", "lr") for e in data[kind]
               if e[0].shape[0]]
    n_dense = sum(1 for e in data["dense"] if e[0].shape[0])
    meta = [torch.cat([e[i].reshape(-1).to(torch.int64) for e in buckets]
                      ).cpu().numpy() if buckets else np.zeros(0, np.int64)
            for i in (-3, -2, -1)]
    first = np.cumsum([0] + [e[0].shape[0] for e in buckets])
    b, blk = order[:, 0].astype(np.int64), order[:, 1].astype(np.int64)
    lo = order[:, 2].astype(np.int64)
    t, s, mirror = (m[first[b] + blk] if len(b) else m[:0] for m in meta)
    # per bucket: factor addresses, rows of a block, widths, dense flag
    geo = np.array([(e[0].data_ptr(), e[1].data_ptr() if i >= n_dense else 0,
                     e[0].shape[1], e[0].shape[2], e[1].shape[2]
                     if i >= n_dense else e[0].shape[2], e[0].element_size(),
                     int(i < n_dense)) for i, e in enumerate(buckets)],
                   dtype=np.int64).reshape(-1, 7)[b]
    a_ptr, v_ptr, rows, w_a, w_v, size, dense = geo.T
    rec = np.zeros((len(order), 6), dtype=np.int64)
    rec[:, 0] = a_ptr + (blk * rows + lo) * w_a * size
    rec[:, 1] = np.where(dense == 1, 0, v_ptr + (blk * rows + lo) * w_v * size)
    rec[:, 2] = (t + lo * dense) | (s << 32)
    # dense: pt is its rows' count, ps its width; low-rank: pt, ps widths
    pt = np.where(dense == 1, rows, w_a)
    rec[:, 3] = (order[:, 3] - lo) | (pt << 32)
    rec[:, 4] = w_v | ((2 * mirror + dense) << 32)
    return torch.from_numpy(rec).to(device)


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
    on every call (K2 skips rows past the end of y and reads zeros past
    the end of x; K1 copies x rows without a bound).  `aligned`: the data
    is in the aligned low-rank layout, which a fused K1 product runs as
    K1-al.  `work`: for real data, K1's work list (ops/matvec.py
    `work_list`), built on every device, which checks that every factor
    run is contiguous and 16-byte aligned.

    On CUDA, after every operand was checked, the table also holds what
    the kernel reads: for K1 the work list as item records
    (`_item_records`), largest first (`items`) and in bucket order
    (`items_by_bucket`, whose bucket ranges `work.ranges` a per-bucket
    product reads on the host); for K2 the device table of bucket
    descriptors (struct Bucket in hmatrix_product_complex.cu) and its host
    copy `host_rows`, which a per-bucket product reads for each launch's
    block count and dims (no device read).  It names the data's tensors by
    pointer: it stays valid while the data's containers and tensors do
    (HMatrix builds one at its first product and drops it on copy and
    whenever its buckets are replaced).
    """

    def __init__(self, data, device):
        device = torch.device(device)
        if device.type not in ("cpu", "cuda"):
            raise ValueError(f"unsupported device {device}")
        if device.type == "cuda" and device.index is None:
            # the form tensors report, so that devices compare
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self.dtype = _data_dtype(data)
        self.aligned = is_aligned(data)
        self.extent = _extent(data)
        self.table = None
        # K1's work list (real data), checked on every device
        self.work = (work_list(data) if self.dtype is not None
                     and not self.dtype.is_complex else None)
        if device.type == "cuda":
            self.n_blocks = 0
            if self.dtype is not None:
                _check_dtype(self.dtype, "the operator")
                rows, self.n_blocks, self.max_dim, self.max_r = _bucket_rows(
                    data, device, self.dtype)
                self.n_buckets = len(rows)
                if self.work is not None:
                    self.items = _item_records(data, self.work.items, device)
                    self.items_by_bucket = _item_records(
                        data, self.work.by_bucket, device)
                else:
                    self.host_rows = np.ascontiguousarray(
                        np.asarray(rows, dtype=np.int64).reshape(
                            -1, _TABLE_FIELDS))
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


def _launch_k1(lib, mode, aligned, table, x, y, trans, sym, stream):
    """K1's launches over the work list: 'fused' (K1-al on aligned data)
    and 'seq' one launch per pass of K1_PASS_COLS columns, over the list
    largest first and in bucket order; 'per_bucket' one per bucket and
    pass.  Returns (rc, launches)."""
    L, k = x.shape
    io = (x.data_ptr(), L, y.data_ptr(), y.shape[0], k, int(trans != "N"),
          int(sym != "N"))
    passes = -(-k // K1_PASS_COLS)
    n = len(table.work.items)
    if mode == "per_bucket":
        return lib.hm_k1_launch_per_bucket(
            table.items_by_bucket.data_ptr(), table.work.ranges.ctypes.data,
            table.n_buckets, *io, stream), table.n_buckets * passes
    if mode == "seq":
        return lib.hm_k1_launch_seq(table.items_by_bucket.data_ptr(), n, *io,
                                    stream), passes
    fn = lib.hm_k1_launch_al if aligned else lib.hm_k1_launch
    return fn(table.items.data_ptr(), n, *io, stream), passes


def _launch(name, mode, table, x, y, trans, sym):
    """Kernel `name` in launch structure `mode` over `table`, x (L, k) into
    the zeroed y (ny, k); x and y hold the kernel's dtype."""
    lib = _library(name)
    aligned = name == KERNEL_NAME and mode == "fused" and table.aligned
    counter = ALIGNED_NAME if aligned else launch_name(name, mode)
    device = x.device
    L, k = x.shape
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        if name == KERNEL_NAME:
            rc, launches = _launch_k1(lib, mode, aligned, table, x, y, trans,
                                      sym, stream)
            err = lib.hm_error_string
        else:
            err = lib.hm_k2_error_string
            io = (x.data_ptr(), L, y.data_ptr(), y.shape[0], k,
                  int(trans != "N"), int(sym != "N"),
                  *[int(c) for c in _conj_flags(trans, sym)])
            if mode == "per_bucket":
                rc = lib.hm_k2_launch_per_bucket(
                    table.table.data_ptr(), table.host_rows.ctypes.data,
                    table.n_buckets, *io, stream)
            else:
                fn = (lib.hm_k2_launch_seq if mode == "seq"
                      else lib.hm_k2_launch)
                rc = fn(table.table.data_ptr(), table.n_buckets,
                        table.n_blocks, *io, table.max_dim, table.max_r,
                        stream)
            launches = table.n_buckets if mode == "per_bucket" else 1
    if rc != 0:
        raise RuntimeError(f"{counter} launch failed: CUDA "
                           f"error {rc} ({err(rc).decode()})")
    LAUNCH_COUNTS[counter] += launches


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
