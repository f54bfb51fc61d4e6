"""Kernels K1 and K2 on Hopper, and their float64 / complex128 siblings:
the bucketed H-matrix product.

K1, the real f32 product, is the counterpart of
htool_python_tpu/ops/pallas_matvec.py `apply_hmatrix_pallas`; K2, the
complex64 product, of `apply_hmatrix_pallas_complex` there.  Both are one
kernel body, templated on the element type, in
htool_python_torch/csrc/hmatrix_product.cu, built by ops/cuda_build.py and
called through ctypes (entry points `hm_k1_*` and `hm_k2_*`).

Each kernel has three launch structures, chosen by the config knob
`matvec_kernel_mode` as in the reference (htool_python_tpu/config.py
`matvec_kernel_mode`, pallas_matvec.py `_kernel_mode`):

  * 'fused' (the default): one launch covers every bucket;
  * 'per_bucket' (K1-pb / K2-pb, the reference's `_launch_per_bucket`):
    one launch per bucket, all adding into the one zeroed y;
  * 'seq' (K1-seq / K2-seq, the reference's `_launch_seq`): one launch of
    a persistent grid that walks the buckets in order.

Both walk the work list of their BucketTable (ops/matvec.py `work_list`:
block slices of at most WORK_ROWS rows, WORK_ROWS_COMPLEX for complex
data, every stored entry in exactly one item): 'fused' over the items
largest first, 'seq' over them in bucket order, 'per_bucket' one launch
per bucket over that bucket's items.  One launch takes up to PASS_COLS[dtype] columns (an x row of 128 floats: 128
real or 64 complex columns); a wider x runs in passes of that many
columns, each pass one launch (per bucket, for 'per_bucket').

Only this wrapper reads the knob.  On a CUDA tensor the chosen structure
launches (never another one); the plain version has no launch structure,
so on the CPU every mode runs it.  LAUNCH_COUNTS counts each structure
under its own name (`hmatrix_product`, `hmatrix_product/per_bucket`,
`hmatrix_product/seq`, and the same for `hmatrix_product_complex`); a
per-bucket product counts one launch per non-empty bucket and pass.

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
  * float32 data, complex64 x: K1 on the real view (`_launch`).
    H is real, so H (a + ib) = H a + i H b: the (L, k) complex x is read
    as (L, 2k) floats (torch.view_as_real, no copy), K1 runs over the 2k
    real columns, and its (ny_pad, 2k) result is viewed back as complex.
  * complex64 data: K2, with a float32 x promoted to complex64 first.
    trans 'C' conjugates the operator, and a hermitian ('H') mirror term
    is conjugated; the wrapper turns both into one conjugation flag per
    direction of a block (ops/matvec.py `conj_flags`, the plain version's
    conj_main / conj_mirror).
  * float64 data: `hmatrix_product_f64` (csrc/hmatrix_product_f64.cu),
    with a float32 x promoted to float64, and a complex x (complex64 or
    complex128) through the real view at float64, as K1 takes a complex x.
  * complex128 data: `hmatrix_product_complex128`, the same body on
    complex128, with a real or complex64 x promoted to complex128 and the
    conjugation flags of K2.
  * float32 data with a float64 x: `hmatrix_product_f64_from_f32`, the same
    body reading float32 factors and computing in float64 (the factor
    entries widened as they are read; widening is exact, so this is the
    reference's product with the operator promoted, without a copy of it);
    with a complex128 x the same through the real view.
  * complex64 data with a complex128 (or float64) x:
    `hmatrix_product_complex128_from_c64`, the same body reading complex64
    factors and computing in complex128, with the conjugation flags.
    These four replace no TPU kernel (the reference computes f64 and
    complex128 in XLA, htool_python_tpu/ops/matvec.py:100, and promotes
    the operator to the wider dtype of x at :111); they walk the same work
    list at the data's element size, in passes of PASS_COLS columns (by the
    dtype of x), and have one launch structure: under 'per_bucket' or
    'seq' they raise NotImplementedError (ROADMAP item 1 adds no call sites
    to that knob).  LAUNCH_COUNTS counts each under its own name.

Tolerance: many blocks add into the same rows of y with f32 atomicAdd, in
an order that changes from run to run, so either kernel agrees with the
plain version to f32 summation round-off (checked at 1e-5 relative), not
bit for bit; the float64 / complex128 kernels, whose tiles go into y as
f64 bulk reductions or atomics, to f64 round-off (checked at 1e-12).  From 9 columns K1 and K2 multiply on the
tensor cores in 3xTF32 (each f32 operand split into two TF32 parts; K2
over the interleaved real columns), which keeps f32's round-off.

The operand's device decides: CPU tensors go to the plain version; on a
CUDA tensor this always launches a kernel or raises, never falls back.

A product in user numbering on the card (`apply_hmatrix_user_cuda`, which
HMatrix.matvec reaches through ops/matvec.py `apply_hmatrix_user`) is three
device passes, all in csrc/hmatrix_product.cu: the permute-in kernel
(`hm_permute_in`: x_pad[i] = x[perm_in[i]], zero padding rows, y zeroed),
the product launch above into that y, and the permute-out kernel
(`hm_permute_out`: out[j] = y[inv_perm_out[j]]).  Both copy whole rows, so
they serve every dtype; their plain versions are ops/matvec.py
`permute_in` / `permute_out`, which the CPU runs.  LAUNCH_COUNTS counts
them as PERMUTE_IN_NAME and PERMUTE_OUT_NAME, one each a product.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..config import get_config
from .matvec import apply_hmatrix_padded, conj_flags, is_aligned, work_list

KERNEL_NAME = "hmatrix_product"  # K1
K2_NAME = "hmatrix_product_complex"
ALIGNED_NAME = "hmatrix_product/aligned"  # K1-al
F64_NAME = "hmatrix_product_f64"
C128_NAME = "hmatrix_product_complex128"
F64_F32_NAME = "hmatrix_product_f64_from_f32"  # float32 data, float64 x
C128_C64_NAME = "hmatrix_product_complex128_from_c64"  # complex64 data
F64_LIBRARY = "hmatrix_product_f64"  # csrc/hmatrix_product_f64.cu
# the user-numbering permutations around a product on the card
# (`apply_hmatrix_user_cuda`), in K1 / K2's library
PERMUTE_IN_NAME = "hmatrix_product/permute_in"
PERMUTE_OUT_NAME = "hmatrix_product/permute_out"

MODES = ("fused", "per_bucket", "seq")

# columns of one launch by the dtype of x (an x row of kMaxCols = 128
# floats in csrc/hmatrix_product.cu; kPass in csrc/hmatrix_product_f64.cu,
# an x row of 64 doubles); a wider x runs in passes of this many columns
PASS_COLS = {torch.float32: 128, torch.complex64: 64, torch.float64: 64,
             torch.complex128: 32}


def launch_name(kernel: str, mode: str) -> str:
    """The LAUNCH_COUNTS key of `kernel` launched in `mode`."""
    return kernel if mode == "fused" else f"{kernel}/{mode}"


# launches of each kernel and structure, counted where the wrapper
# launches it
LAUNCH_COUNTS = {launch_name(kern, mode): 0 for kern in (KERNEL_NAME, K2_NAME)
                 for mode in MODES}
LAUNCH_COUNTS[ALIGNED_NAME] = 0
LAUNCH_COUNTS[F64_NAME] = 0
LAUNCH_COUNTS[C128_NAME] = 0
LAUNCH_COUNTS[F64_F32_NAME] = 0
LAUNCH_COUNTS[C128_C64_NAME] = 0
LAUNCH_COUNTS[PERMUTE_IN_NAME] = 0
LAUNCH_COUNTS[PERMUTE_OUT_NAME] = 0

# the data dtype each kernel takes
_KERNEL_OF = {torch.float32: KERNEL_NAME, torch.complex64: K2_NAME,
              torch.float64: F64_NAME, torch.complex128: C128_NAME}
# the kernel of float32 / complex64 data with a float64 / complex128 x
_PROMOTED_OF = {torch.float32: F64_F32_NAME, torch.complex64: C128_C64_NAME}
# the float64 / complex128 family: its C entry point, and whether it takes
# the conjugation flags
_F64_ENTRY = {F64_NAME: ("hm_f64_launch", False),
              F64_F32_NAME: ("hm_f64_f32data_launch", False),
              C128_NAME: ("hm_c128_launch", True),
              C128_C64_NAME: ("hm_c128_c64data_launch", True)}


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


def _library():
    """The kernels' library (K1 and K2), built and loaded at first use, with
    its functions' ctypes signatures set once."""
    if KERNEL_NAME in _LIBS:
        return _LIBS[KERNEL_NAME]
    from .cuda_build import load

    lib = load(KERNEL_NAME)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    # items, n_items, x, lx, y, ly, k, swapped, symmetric[, conj_fwd,
    # conj_tr], stream; per bucket: items, ranges, n_buckets, then the same
    for pre, conj in (("hm_k1", []), ("hm_k2", [i, i])):
        io = [p, ll, p, ll, i, i, i, *conj, p]
        for suffix, argtypes in (("launch", [p, ll, *io]),
                                 ("launch_seq", [p, ll, *io]),
                                 ("launch_per_bucket", [p, p, i, *io])):
            fn = getattr(lib, f"{pre}_{suffix}")
            fn.argtypes = argtypes
            fn.restype = i
    lib.hm_k1_launch_al.argtypes = lib.hm_k1_launch.argtypes
    lib.hm_k1_launch_al.restype = i
    # x, perm, n, x_pad, pad_len, y, ny, row_bytes, stream
    lib.hm_permute_in.argtypes = [p, p, ll, p, ll, p, ll, ll, p]
    lib.hm_permute_in.restype = i
    # y, inv, nout, out, row_bytes, stream
    lib.hm_permute_out.argtypes = [p, p, ll, p, ll, p]
    lib.hm_permute_out.restype = i
    lib.hm_error_string.argtypes = [i]
    lib.hm_error_string.restype = ctypes.c_char_p
    _LIBS[KERNEL_NAME] = lib
    return lib


def _f64_library():
    """The float64 / complex128 kernels' library, as `_library`."""
    if F64_LIBRARY in _LIBS:
        return _LIBS[F64_LIBRARY]
    from .cuda_build import load

    lib = load(F64_LIBRARY)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    # items, n_items, x, lx, y, ly, k, swapped, symmetric[, conj_fwd,
    # conj_tr], stream
    for entry, conj in _F64_ENTRY.values():
        fn = getattr(lib, entry)
        fn.argtypes = [p, ll, p, ll, p, ll, i, i, i, *([i, i] if conj else []),
                       p]
        fn.restype = i
    lib.hm_f64_error_string.argtypes = [i]
    lib.hm_f64_error_string.restype = ctypes.c_char_p
    _LIBS[F64_LIBRARY] = lib
    return lib


def _data_dtype(data):
    """dtype of the data's first stored tensor (None without buckets)."""
    for kind in ("dense", "lr"):
        if data[kind]:
            return data[kind][0][0].dtype
    return None


def _check_dtype(dtype, name):
    if dtype not in _KERNEL_OF:
        raise TypeError(f"{name} has dtype {dtype}, want float32, "
                        "complex64, float64 or complex128")


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


def _check_buckets(data, device, dtype):
    """Checks every stored tensor and its block metadata for the kernels;
    returns the number of stored blocks."""
    n_blocks = 0
    for kind in ("dense", "lr"):
        for entry in data[kind]:
            if kind == "dense":
                D, t_off, s_off, mirror = entry
                _check_operand(D, "D", device, 3, dtype)
                nb, pt, ps = D.shape
            else:
                Ut, V, t_off, s_off, mirror = entry
                _check_operand(Ut, "Ut", device, 3, dtype)
                _check_operand(V, "V", device, 3, dtype)
                nb, _, pt = Ut.shape
                ps = V.shape[2]
                if V.shape[:2] != Ut.shape[:2]:
                    raise ValueError(f"Ut {tuple(Ut.shape)} and V "
                                     f"{tuple(V.shape)} do not match")
            if pt % 4 or ps % 4:
                raise ValueError(f"padded block dims ({pt}, {ps}) must be "
                                 "multiples of 4")
            _check_meta(t_off, s_off, mirror, nb, device)
            n_blocks += nb
    return n_blocks


def _item_records(data, order, device):
    """The kernels' work items `order` ((n, 4) host array of (bucket row,
    block, lo, hi), ops/matvec.py `work_list`) as the kernel reads them: an
    int64
    (n, 6) tensor on `device` of struct Item records
    (csrc/hmatrix_product.cu), each naming its factor rows by address (at
    the data's element size: 4 bytes for K1, 8 for K2), its
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
    """One operator's bucket data as the kernels take it, checked once.

    `dtype` is the data's dtype, which picks the kernel; a product refuses
    data of another dtype.  `extent` is where the furthest block segment
    ends, max(t_off + pt, s_off + ps).  A product reads and writes both
    sides of every block (mirror terms, and the plain version's masked
    ones), so x and y must both hold `extent` rows; the wrapper checks that
    on every call (the kernels copy x rows without a bound).  `aligned`:
    the data is in the aligned low-rank layout, which a fused K1 product
    runs as K1-al.  `work`: the kernels' work list (ops/matvec.py
    `work_list`), built on every device, which checks that every factor
    run is contiguous and 16-byte aligned.

    On CUDA, after every operand was checked, the table also holds what
    the kernel reads: the work list as item records (`_item_records`),
    largest first (`items`) and in bucket order (`items_by_bucket`, whose
    bucket ranges `work.ranges` a per-bucket product reads on the host).
    It names the data's tensors by pointer: it stays valid while the
    data's containers and tensors do (HMatrix builds one at its first
    product and drops it on copy and whenever its buckets are replaced).
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
        self.work = work_list(data) if self.dtype is not None else None
        self.n_buckets = 0 if self.work is None else len(self.work.ranges)
        if device.type == "cuda":
            self.n_blocks = 0
            if self.dtype is not None:
                _check_dtype(self.dtype, "the operator")
                self.n_blocks = _check_buckets(data, device, self.dtype)
                self.items = _item_records(data, self.work.items, device)
                self.items_by_bucket = _item_records(
                    data, self.work.by_bucket, device)
        self._kernels = {}  # (x dtype, mode) -> `kernel_for`'s answer

    def kernel_for(self, x_dtype, mode: str):
        """`dispatch(self.dtype, x_dtype, mode)`, worked out once per x
        dtype and mode; (None, x_dtype, False) for data without buckets
        (after checking x_dtype).  Raises as `dispatch` does, every time."""
        key = (x_dtype, mode)
        if key not in self._kernels:
            if self.dtype is None:
                _check_dtype(x_dtype, "x_pad")
                self._kernels[key] = (None, x_dtype, False)
            else:
                self._kernels[key] = dispatch(self.dtype, x_dtype, mode)
        return self._kernels[key]


def _launch_f64(name, table, x, y, trans, sym, stream):
    """Kernel `name` (one of the float64 / complex128 family, `_F64_ENTRY`)
    over the work list of `table` largest first, x (L, k) into the zeroed y
    (ny, k), both float64 or complex128, on `stream` of the current device:
    one launch per pass of PASS_COLS columns."""
    lib = _f64_library()
    L, k = x.shape
    io = (x.data_ptr(), L, y.data_ptr(), y.shape[0], k, int(trans != "N"),
          int(sym != "N"))
    entry, conj = _F64_ENTRY[name]
    fn = getattr(lib, entry)
    if conj:
        io += tuple(int(c) for c in conj_flags(trans, sym))
    rc = fn(table.items.data_ptr(), len(table.work.items), *io, stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} "
                           f"({lib.hm_f64_error_string(rc).decode()})")
    LAUNCH_COUNTS[name] += -(-k // PASS_COLS[x.dtype])


def _launch(name, mode, table, x, y, real_view, trans, sym, stream):
    """Kernel `name` in launch structure `mode` over the work list of
    `table`, x (L, k) into the zeroed y (ny, k) on `stream`; x and y hold
    the product's dtype (`dispatch`) and lie on the current device.  With
    `real_view` (a complex x on real data) the kernel runs over the
    (rows, 2k) real views of x and y: H is real, so H (a + ib) = H a +
    i H b.  K1 / K2: 'fused' (K1-al on aligned real data) and 'seq' launch
    once per pass of PASS_COLS columns, over the list largest first and in
    bucket order; 'per_bucket' once per bucket and pass.  The float64 /
    complex128 family has the 'fused' structure only."""
    if real_view:
        x, y = _real_view(x), _real_view(y)
    if name in _F64_ENTRY:  # 'fused' only (`dispatch`)
        return _launch_f64(name, table, x, y, trans, sym, stream)
    lib = _library()
    aligned = name == KERNEL_NAME and mode == "fused" and table.aligned
    counter = ALIGNED_NAME if aligned else launch_name(name, mode)
    L, k = x.shape
    pre = "hm_k1" if name == KERNEL_NAME else "hm_k2"
    io = (x.data_ptr(), L, y.data_ptr(), y.shape[0], k, int(trans != "N"),
          int(sym != "N"))
    if name == K2_NAME:
        io += tuple(int(c) for c in conj_flags(trans, sym))
    passes = -(-k // PASS_COLS[x.dtype])
    n = len(table.work.items)
    if mode == "per_bucket":
        rc = getattr(lib, f"{pre}_launch_per_bucket")(
            table.items_by_bucket.data_ptr(),
            table.work.ranges.ctypes.data, table.n_buckets, *io, stream)
        launches = table.n_buckets * passes
    elif mode == "seq":
        rc = getattr(lib, f"{pre}_launch_seq")(
            table.items_by_bucket.data_ptr(), n, *io, stream)
        launches = passes
    else:
        fn = (lib.hm_k1_launch_al if aligned
              else getattr(lib, f"{pre}_launch"))
        rc = fn(table.items.data_ptr(), n, *io, stream)
        launches = passes
    _raise_on(rc, lib, counter)
    LAUNCH_COUNTS[counter] += launches


def _raise_on(rc, lib, name):
    """Raises if a launch of `name` from K1 / K2's library returned CUDA
    error `rc`."""
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA "
                           f"error {rc} ({lib.hm_error_string(rc).decode()})")


def _real_view(t):
    """The (rows, 2k) real view of a complex (rows, k) tensor (re, im
    interleaved per column; no copy): how a real operator's kernel takes a
    complex x and y of the matching width (float32 data with complex64,
    float64 with complex128)."""
    return torch.view_as_real(t).reshape(t.shape[0], 2 * t.shape[1])


def _stream(device):
    """The raw handle of `device`'s current CUDA stream (torch's C call:
    about 0.1 us on the H100's host, where
    torch.cuda.current_stream(device).cuda_stream builds a Stream object
    in about 4 us)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def dispatch(data_dtype, x_dtype, mode: str = "fused"):
    """(kernel, dtype of x and y, real view) of a CUDA product of
    `data_dtype` data with an x of `x_dtype` in launch structure `mode`:
    x and y take the promoted dtype of data and x, as in the reference; the
    data's dtype picks the kernel, or, where x is wider (float64 /
    complex128 x on float32 / complex64 data), the kernel that reads the
    data as stored and computes in the wider type; a real operator takes a
    complex x through its real view (`_launch`).  Raises
    NotImplementedError for the float64 / complex128 family in another
    structure than 'fused'; TypeError for another dtype."""
    _check_dtype(data_dtype, "the operator")
    _check_dtype(x_dtype, "x_pad")
    dtype = torch.promote_types(data_dtype, x_dtype)
    name = (_KERNEL_OF[data_dtype] if dtype.to_real() == data_dtype.to_real()
            else _PROMOTED_OF[data_dtype])
    if name in _F64_ENTRY and mode != "fused":
        raise NotImplementedError(
            f"{name} has one launch structure ('fused'), not {mode!r}: "
            "ROADMAP item 1 adds no call sites to matvec_kernel_mode")
    return name, dtype, dtype.is_complex and not data_dtype.is_complex


def _checked_table(data, device, L: int, ny_pad: int, trans: str, sym: str,
                   table):
    """The checks of every product of `data` on `device` with x of L rows
    into y of ny_pad rows; returns the data's BucketTable (`table`, or one
    built here)."""
    if trans not in ("N", "T", "C"):
        raise ValueError(f"trans must be 'N', 'T' or 'C', got {trans!r}")
    if sym not in ("N", "S", "H"):
        raise ValueError(f"sym must be 'N', 'S' or 'H', got {sym!r}")
    if table is None:
        table = BucketTable(data, device)
    elif table.device != device:
        raise ValueError(f"the bucket table is on {table.device}, x on "
                         f"{device}")
    if table.dtype != _data_dtype(data):
        raise ValueError(f"the bucket table was built for {table.dtype} "
                         f"data, not {_data_dtype(data)}")
    if table.extent > min(L, ny_pad):
        raise ValueError(f"a block segment ends at row {table.extent}, "
                         f"past x ({L} rows) or y ({ny_pad} rows)")
    return table


def apply_hmatrix_cuda(data, x_pad, ny_pad: int, trans: str, sym: str,
                       table: BucketTable | None = None):
    """y_pad (ny_pad, k) = H^(trans) x_pad through kernel K1, K2 or their
    float64 / complex128 siblings (CUDA tensors) or their plain version
    (CPU tensors).  `table`: the data's
    BucketTable, built here when not given.  See the module docstring."""
    device = x_pad.device
    table = _checked_table(data, device, x_pad.shape[0], ny_pad, trans, sym,
                           table)
    mode = kernel_mode()
    if device.type == "cpu":
        return apply_hmatrix_padded(data, x_pad, ny_pad, trans, sym)
    k = x_pad.shape[1]
    name, dtype, real_view = table.kernel_for(x_pad.dtype, mode)
    if table.n_blocks == 0 or k == 0:
        return torch.zeros((ny_pad, k), dtype=dtype, device=device)
    x_pad = x_pad.to(dtype)
    _check_operand(x_pad, "x_pad", device, 2, dtype)
    y = torch.zeros((ny_pad, k), dtype=dtype, device=device)
    with torch.cuda._DeviceGuard(device.index):
        _launch(name, mode, table, x_pad, y, real_view, trans, sym,
                _stream(device))
    return y


def _check_index(t, name, device, n):
    if (t.device != device or t.dtype != torch.int32 or t.shape != (n,)
            or not t.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous ({n},) int32 tensor "
                         f"on {device}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")


def apply_hmatrix_user_cuda(data, perm_in, inv_perm_out, x2d, pad_len: int,
                            trans: str, sym: str, nout: int,
                            table: BucketTable | None = None):
    """y (nout, k) = H^(trans) x2d in user numbering on the card, in three
    hand-written device passes: the permute-in kernel (x_pad[i] =
    x[perm_in[i]], zero padding rows up to pad_len, y zeroed), the product
    (`_launch`, as `apply_hmatrix_cuda`), the permute-out kernel (out[j] =
    y[inv_perm_out[j]]).  x2d (n, k) on a CUDA device, promoted first to
    the product's dtype where it differs (and made contiguous);
    perm_in (n,) and inv_perm_out (nout,) contiguous int32 permutations on
    that device, which the kernels read unchecked (HMatrix builds them
    from its clusters).  The answer is a new tensor on every call.  Counts
    one PERMUTE_IN_NAME and one PERMUTE_OUT_NAME launch a product with
    columns.  Their plain versions are ops/matvec.py `permute_in` /
    `permute_out`."""
    device = x2d.device
    table = _checked_table(data, device, pad_len, pad_len, trans, sym, table)
    mode = kernel_mode()
    name, dtype, real_view = table.kernel_for(x2d.dtype, mode)
    if x2d.ndim != 2:
        raise ValueError(f"x must be 2-d, got shape {tuple(x2d.shape)}")
    n, k = x2d.shape
    _check_index(perm_in, "perm_in", device, n)
    _check_index(inv_perm_out, "inv_perm_out", device, nout)
    if max(n, nout) > pad_len:
        raise ValueError(f"{max(n, nout)} rows do not fit the padded length "
                         f"{pad_len}")
    out = torch.empty((nout, k), dtype=dtype, device=device)
    if k == 0:
        return out
    # each of these is a dispatched op, even where it returns x2d itself
    x = x2d if x2d.dtype == dtype else x2d.to(dtype)
    if not x.is_contiguous():
        x = x.contiguous()
    # fresh from the allocator, of the product's shape and dtype: 512-byte
    # aligned, so `_check_operand` has nothing to find in them
    x_pad = torch.empty((pad_len, k), dtype=dtype, device=device)
    y = torch.empty((pad_len, k), dtype=dtype, device=device)
    with torch.cuda._DeviceGuard(device.index):
        stream = _stream(device)
        launch_permute_in(x, perm_in, x_pad, y, stream)
        if table.n_blocks:
            _launch(name, mode, table, x_pad, y, real_view, trans, sym,
                    stream)
        launch_permute_out(y, inv_perm_out, out, stream)
    return out


def launch_permute_in(x, perm_in, x_pad, y, stream):
    """The permute-in kernel on `stream` of the current device: x_pad[i] =
    x[perm_in[i]] for i below x's rows, zero rows after them, and y
    zeroed.  x, x_pad and y are contiguous, of one dtype and row width;
    perm_in an int32 permutation of x's rows (the caller checks them)."""
    lib = _library()
    _raise_on(lib.hm_permute_in(
        x.data_ptr(), perm_in.data_ptr(), x.shape[0], x_pad.data_ptr(),
        x_pad.shape[0], y.data_ptr(), y.shape[0],
        x.shape[1] * x.element_size(), stream), lib, PERMUTE_IN_NAME)
    LAUNCH_COUNTS[PERMUTE_IN_NAME] += 1


def launch_permute_out(y, inv_perm_out, out, stream):
    """The permute-out kernel on `stream` of the current device: out[j] =
    y[inv_perm_out[j]] for j below out's rows, as `launch_permute_in`
    takes its operands."""
    lib = _library()
    _raise_on(lib.hm_permute_out(
        y.data_ptr(), inv_perm_out.data_ptr(), out.shape[0], out.data_ptr(),
        out.shape[1] * out.element_size(), stream), lib, PERMUTE_OUT_NAME)
    LAUNCH_COUNTS[PERMUTE_OUT_NAME] += 1
