"""Kernels P3 and P4 on Hopper: single-bucket variants of K1's body, and
the gather they use.

P3, `bucket_variant`, is the counterpart of tools/profile_matvec5.py:225
`launch` (body `make_kernel` :144): one synthetic bucket of K1's work
computed by a chosen gather x block math x y-accumulation, so that K1's
time splits into its parts.  P4, `take_along_axis`, is the counterpart of
the gather probe of tools/profile_matvec5.py:288 (`probe_kernel` :301).
Source: htool_python_torch/csrc/bucket_variants.cu, built by
ops/cuda_build.py and called through ctypes; the source says what each
variant computes, what bounds it and how it is laid out.

The plain versions (`bucket_variant_plain`, `take_along_axis_plain`)
follow the reference's `_gather_*`, `_term_vpu_*`, `_term_xgemm_*` and
`_accum_*` one to one, batched over the bucket's groups of G blocks.  The
wrapper runs them on CPU tensors only; on CUDA tensors it launches the
kernel or raises.  LAUNCH_COUNTS counts the wrapper's launches.
`xgemm_streamed_plain` is a second plain version of term 'xgemm' that sums
in the order of the kernel's consumers, block by block.

A block segment that runs outside [0, L) reads zeros from x and drops its
rows of y, in the kernel and the plain version alike (the reference's
cases keep every segment inside: offsets below L - width - 256).

With accum 'skip' nothing reaches y; the sums that keep the kernel's loads
alive, one per block for term 'vpu' and one per group of G blocks
otherwise (`n_ctas`), come back with `return_sink=True` (the plain version
gives the same sums), so that even the 'stream' variant can be checked.

Tolerances against the reference (the plain version, f32 on the CPU):
1e-6 relative (sums in another order).  The kernel against the plain
version: 1e-5 relative, and for term 'xgemm' (TF32 tensor cores) 1e-5 of
max|y| plus XGEMM_SIGMAS standard deviations of the TF32 rounding error,
elementwise (`kernel_tolerance`, `tf32_error_std`).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

P3_NAME = "bucket_variant"
P4_NAME = "take_along_axis"
LAUNCH_COUNTS = {P3_NAME: 0, P4_NAME: 0}

KINDS = ("lr", "dense")
GATHERS = ("roll", "take", "none")
TERMS = ("vpu", "xgemm", "skip")
ACCUMS = ("roll", "static", "skip")

TOTAL_MB = 384  # profile_matvec5.main
LENGTH = 40960  # its L: the length of x and y
# (kind, r, pt, ps, G): profile_matvec5.main
CASES = [("lr", 16, 256, 256, 32), ("dense", 0, 128, 128, 16)]
# (name, gather, term, accum): profile_matvec5.main
VARIANTS = [
    ("base", "roll", "vpu", "roll"),
    ("xgemm", "roll", "xgemm", "roll"),
    ("take_xgemm", "take", "xgemm", "roll"),
    ("take_xgemm_sacc", "take", "xgemm", "static"),
    ("xgemm_sacc", "roll", "xgemm", "static"),
    ("stream", "none", "skip", "skip"),
]
KERNEL_TOL = 1e-5  # f32 atomics add in a varying order
TF32_UNIT = 2.0 ** -11  # unit round-off of TF32 (10 stored mantissa bits)
# standard deviations of the TF32 error that 'xgemm' may reach: the largest
# of 40 960 Gaussian errors lies near 4.4 of them
XGEMM_SIGMAS = 8.0
# the 'xgemm' kernel's consumer warps, and the shapes it takes
# (csrc/bucket_variants.cu `launch_xgemm`)
XGEMM_WARPS = 8
XGEMM_MAX_G = 32
XGEMM_MAX_PT_LR = 256
XGEMM_MAX_ROWS = 256  # a slab's rows: one TMA box


def reset_launch_counts() -> None:
    for name in LAUNCH_COUNTS:
        LAUNCH_COUNTS[name] = 0


def slab_rows(kind: str, r: int, pt: int) -> int:
    return 2 * r if kind == "lr" else pt


def build_case(kind, total_mb, L, G, r, pt, ps, rng):
    """The reference's `build_case`: a merged slab (nb, rows, max(pt, ps))
    of standard normals ('lr': rows [:r] Ut, [r:] V; 'dense': D), nb the
    largest multiple of G within total_mb MiB, then t_off and s_off drawn
    below L - width - 256, all from the numpy Generator rng.  Returns
    (slabs, (t_off, s_off), stored bytes), numpy arrays."""
    nb, per = case_blocks(kind, total_mb, G, r, pt, ps)
    slabs = rng.standard_normal(
        (nb, slab_rows(kind, r, pt), max(pt, ps))).astype(np.float32)
    t_off = rng.integers(0, L - pt - 256, nb).astype(np.int32)
    s_off = rng.integers(0, L - ps - 256, nb).astype(np.int32)
    return slabs, (t_off, s_off), nb * per


def case_blocks(kind, total_mb, G, r, pt, ps):
    """(nb, stored bytes a block) of `build_case`: nb the largest multiple
    of G within total_mb MiB."""
    per = slab_rows(kind, r, pt) * (max(pt, ps) if kind == "lr" else ps) * 4
    return (total_mb << 20) // per // G * G, per


def product_f64(kind, slabs, offs, x, L, r, pt, ps):
    """The reference's `reference`: the bucket's product in float64 on the
    host, block by block; numpy in, numpy (L,) out."""
    t_off, s_off = offs
    y = np.zeros(L, np.float64)
    for g in range(slabs.shape[0]):
        xs = x[0, s_off[g]:s_off[g] + ps].astype(np.float64)
        if kind == "lr":
            Ut = slabs[g, :r, :pt].astype(np.float64)
            V = slabs[g, r:, :ps].astype(np.float64)
            y[t_off[g]:t_off[g] + pt] += Ut.T @ (V @ xs)
        else:
            y[t_off[g]:t_off[g] + pt] += slabs[g, :, :ps].astype(
                np.float64) @ xs
    return y


def k1_data(kind, slabs, offs, r, pt, ps):
    """The bucket in K1's layout: one bucket of the port's bucket data
    (ops/matvec.py), low-rank (Ut, V) split out of the merged slab, no
    mirror.  K1 on it computes what the 'base' variant computes."""
    t_off, s_off = offs
    mirror = torch.zeros(slabs.shape[0], dtype=torch.bool,
                         device=slabs.device)
    if kind == "lr":
        return {"dense": [], "lr": [(slabs[:, :r, :pt].contiguous(),
                                     slabs[:, r:, :ps].contiguous(),
                                     t_off, s_off, mirror)]}
    return {"dense": [(slabs[:, :, :ps].contiguous(), t_off, s_off,
                       mirror)], "lr": []}


def _check_variant(kind, gather, term, accum, slabs, offs, x, L, G, r, pt,
                   ps, return_sink=False):
    for name, value, allowed in (("kind", kind, KINDS),
                                 ("gather", gather, GATHERS),
                                 ("term", term, TERMS),
                                 ("accum", accum, ACCUMS)):
        if value not in allowed:
            raise ValueError(f"{name} must be one of {allowed}, got "
                             f"{value!r}")
    rows, W = slab_rows(kind, r, pt), max(pt, ps)
    if kind == "lr" and r < 1:
        raise ValueError(f"a low-rank bucket needs r >= 1, got {r}")
    if (slabs.dtype != torch.float32 or slabs.ndim != 3
            or slabs.shape[1:] != (rows, W) or not slabs.is_contiguous()):
        raise ValueError(f"slabs must be a contiguous float32 (nb, {rows}, "
                         f"{W}) tensor, got {slabs.dtype} "
                         f"{tuple(slabs.shape)}")
    nb = slabs.shape[0]
    if nb == 0 or G < 1 or nb % G:
        raise ValueError(f"{nb} blocks are not a whole number of groups of "
                         f"{G}")
    if (x.dtype != torch.float32 or x.shape != (1, L)
            or x.device != slabs.device or not x.is_contiguous()):
        raise ValueError(f"x must be a contiguous float32 (1, {L}) tensor on "
                         f"{slabs.device}, got {x.dtype} {tuple(x.shape)} "
                         f"on {x.device}")
    for name, off in zip(("t_off", "s_off"), offs):
        if (off.dtype != torch.int32 or off.shape != (nb,)
                or off.device != slabs.device or not off.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous int32 ({nb},) "
                             f"tensor on {slabs.device}")
    if pt > L or (term == "skip" and pt > ps):
        raise ValueError(f"pt = {pt} must be at most L = {L}, and at most "
                         f"ps = {ps} for term 'skip'")
    if return_sink and accum != "skip":
        raise ValueError("only accum 'skip' writes the sink")


def _segments(off, width, L):
    """Rows off + [0, width) of each block, clamped into [0, L), and where
    they were inside."""
    idx = off.long()[:, None] + torch.arange(width, device=off.device)
    return idx.clamp(0, L - 1), (idx >= 0) & (idx < L)


def _gather(x, s_off, width, L):
    """(nb, width) x segments at s_off: what the reference's `_gather_rolls`
    (slice + roll per block) and `_gather_take` (take_along_axis on an
    (8, L) copy of x) both give; zeros outside x."""
    rows, inside = _segments(s_off, width, L)
    return torch.where(inside, x[0, rows], 0.0)


def _term_vpu_lr(slab, xg, r, pt, ps):
    """Ut^T (V x_seg) per block by broadcast-multiply-reduce: slab (S, G,
    2r, W), xg (S, G, ps) -> (S, G, pt)."""
    Ut, V = slab[..., :r, :pt], slab[..., r:, :ps]
    w = torch.sum(V * xg[..., None, :], dim=-1)  # (S, G, r)
    return torch.sum(Ut * w[..., None], dim=-2)


def _term_xgemm_lr(slab, xg, r, pt, ps):
    """The same by the block-diagonal formulation: Wp = V_flat (G r, ps) @
    X^T (ps, G), keep each row's own block column, then w_bd (G, G r) @
    Ut_flat (G r, pt)."""
    S, G = xg.shape[:2]
    Ut = slab[..., :r, :pt].reshape(S, G * r, pt)
    V = slab[..., r:, :ps].reshape(S, G * r, ps)
    Wp = V @ xg.transpose(1, 2)  # (S, G r, G)
    own = (torch.arange(G * r, device=xg.device)[:, None] // r
           == torch.arange(G, device=xg.device))  # (G r, G)
    w_col = torch.where(own, Wp, 0.0).sum(2)  # (S, G r)
    w_bd = torch.where(own.T, w_col[:, None, :], 0.0)  # (S, G, G r)
    return w_bd @ Ut


def _term_vpu_dense(slab, xg, pt, ps):
    """D x_seg per block: slab (S, G, pt, W), xg (S, G, ps) -> (S, G, pt)."""
    return torch.sum(slab[..., :pt, :ps] * xg[..., None, :], dim=-1)


def _term_xgemm_dense(slab, xg, pt, ps):
    """The same by the block-diagonal formulation: D_flat (G pt, ps) @ X^T
    (ps, G), keep each row's own block column."""
    S, G = xg.shape[:2]
    D = slab[..., :pt, :ps].reshape(S, G * pt, ps)
    Yp = D @ xg.transpose(1, 2)  # (S, G pt, G)
    own = (torch.arange(G * pt, device=xg.device)[:, None] // pt
           == torch.arange(G, device=xg.device))
    return torch.where(own, Yp, 0.0).sum(2).reshape(S, G, pt)


def _accum_seg(y, t_off, out, L):
    """y[t:t+pt] += out per block (rows outside [0, L) dropped)."""
    rows, inside = _segments(t_off, out.shape[1], L)
    y.index_add_(0, rows.flatten(), torch.where(inside, out, 0.0).flatten())


def _accum_static(y, out):
    """y[:pt] += out for every block: the reference's static-offset probe."""
    y[:out.shape[1]] += out.sum(0)


def n_ctas(term, nb, G):
    """The slots of the sink: one a block for term 'vpu' (one CTA each),
    one a group of G blocks otherwise (one CTA each for 'skip'; 'xgemm''s
    persistent CTAs write one slot for each group they take)."""
    return nb if term == "vpu" else nb // G


def _gathered(gather, x, s_off, ps, L):
    if gather == "none":
        return torch.zeros((s_off.shape[0], ps), dtype=torch.float32,
                           device=x.device)
    return _gather(x, s_off, ps, L)


def bucket_variant_plain(kind, gather, term, accum, slabs, offs, x, L, G, r,
                         pt, ps, return_sink=False):
    """P3's plain version: y (1, L) of one bucket under (gather, term,
    accum); see the module docstring and the .cu source for each choice.
    With `return_sink` (accum 'skip' only), (y, sink): sink[c] the sum of
    the results of slot c (`n_ctas`)."""
    _check_variant(kind, gather, term, accum, slabs, offs, x, L, G, r, pt,
                   ps, return_sink)
    t_off, s_off = offs
    nb, rows, W = slabs.shape
    S = nb // G
    xg = _gathered(gather, x, s_off, ps, L)
    slab, xg = slabs.reshape(S, G, rows, W), xg.reshape(S, G, ps)
    if term == "vpu":
        out = (_term_vpu_lr(slab, xg, r, pt, ps) if kind == "lr"
               else _term_vpu_dense(slab, xg, pt, ps))
    elif term == "xgemm":
        out = (_term_xgemm_lr(slab, xg, r, pt, ps) if kind == "lr"
               else _term_xgemm_dense(slab, xg, pt, ps))
    else:
        out = xg[..., :pt] + slab.sum((1, 2, 3))[:, None, None] * 1e-30
    y = torch.zeros(L, dtype=torch.float32, device=x.device)
    if accum == "roll":
        _accum_seg(y, t_off, out.reshape(nb, pt), L)
    elif accum == "static":
        _accum_static(y, out.reshape(nb, pt))
    if return_sink:
        return y[None], out.reshape(n_ctas(term, nb, G), -1).sum(1)
    return y[None]


def round_tf32(t):
    """t (float32) rounded to TF32 as the kernel's cvt.rna.tf32.f32 rounds
    it: 10 stored mantissa bits, ties away from zero."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _check_xgemm_shape(G, r, pt, ps, kind):
    if (G % 16 or pt % 16 or ps % 8 or (kind == "lr" and r % 16)
            or G > XGEMM_MAX_G or (kind == "lr" and pt > XGEMM_MAX_PT_LR)
            or slab_rows(kind, r, pt) > XGEMM_MAX_ROWS):
        raise ValueError(
            f"term 'xgemm' (m16n8k8 TF32 tiles, out in registers, a slab in "
            f"one TMA box) needs G, pt{' and r' if kind == 'lr' else ''} "
            f"multiples of 16, ps of 8, G <= {XGEMM_MAX_G}"
            + (f", pt <= {XGEMM_MAX_PT_LR}" if kind == "lr" else "")
            + f" and at most {XGEMM_MAX_ROWS} slab rows; got G = {G}, r = "
            f"{r}, pt = {pt}, ps = {ps}")


def _k8_sum(terms):
    """The k8 steps of terms (..., steps) summed one after another, as one
    warp's accumulator takes its mma steps."""
    acc = terms[..., 0]
    for s in range(1, terms.shape[-1]):
        acc = acc + terms[..., s]
    return acc


def xgemm_streamed_plain(kind, gather, accum, slabs, offs, x, L, G, r, pt,
                         ps, return_sink=False, tf32=False):
    """The 'xgemm' term summed block by block in the order of the kernel's
    consumers (csrc/bucket_variants.cu `xgemm_kernel`), batched over the
    groups; y (1, L), and with `return_sink` (accum 'skip') the per-group
    sums too.  It computes only each block's kept column and row of out:
    the other tiles the kernel computes hold 0 there.

    'lr', block g of a group: warp q of 8 sums V_g x_g over its k8 steps
    q, q + 8, ... (each step's 8 products summed first); w is the warps'
    partials added in warp order; block g's row of out is w^T Ut_g over
    the k8 steps of r in order (the other blocks add exact zeros into it).
    'dense': D_g x_g over the k8 steps of ps in order, in one warp.  With
    `tf32`, V, x, w and Ut (D and x) are rounded to TF32 as the kernel
    rounds them (`round_tf32`); the sums stay f32."""
    _check_variant(kind, gather, "xgemm", accum, slabs, offs, x, L, G, r, pt,
                   ps, return_sink)
    _check_xgemm_shape(G, r, pt, ps, kind)
    rnd = round_tf32 if tf32 else (lambda t: t)
    t_off, s_off = offs
    nb, rows, W = slabs.shape
    S = nb // G
    xg = rnd(_gathered(gather, x, s_off, ps, L)).reshape(S, G, ps // 8, 8)
    slab = slabs.reshape(S, G, rows, W)
    out = torch.zeros((S, G, pt), dtype=torch.float32, device=x.device)
    for g in range(G):
        xs = xg[:, g]  # (S, steps, 8)
        if kind == "lr":
            V = rnd(slab[:, g, r:, :ps]).reshape(S, r, ps // 8, 8)
            steps = (V * xs[:, None]).sum(-1)  # (S, r, steps)
            partials = [_k8_sum(steps[..., q::XGEMM_WARPS])
                        for q in range(min(XGEMM_WARPS, ps // 8))]
            w = partials[0]
            for p in partials[1:]:
                w = w + p
            w = rnd(w).reshape(S, r // 8, 8, 1)
            Ut = rnd(slab[:, g, :r, :pt]).reshape(S, r // 8, 8, pt)
            out[:, g] = _k8_sum((w * Ut).sum(2).transpose(1, 2))
        else:
            D = rnd(slab[:, g, :pt, :ps]).reshape(S, pt, ps // 8, 8)
            out[:, g] = _k8_sum((D * xs[:, None]).sum(-1))
    y = torch.zeros(L, dtype=torch.float32, device=x.device)
    if accum == "roll":
        _accum_seg(y, t_off, out.reshape(nb, pt), L)
    elif accum == "static":
        _accum_static(y, out.reshape(nb, pt))
    if return_sink:
        return y[None], out.reshape(S, -1).sum(1)
    return y[None]


def tf32_error_std(kind, gather, accum, slabs, offs, x, L, G, r, pt, ps):
    """The standard deviation (1, L) of the error that term 'xgemm' makes
    by rounding the operands of its products to TF32.  Each rounding
    changes a value by a relative delta, |delta| <= u = 2^-11, of variance
    at most u^2 / 3; the kernel rounds V and x, then w = V x and Ut (lr),
    or D and x (dense), and sums in f32 (2^-13 times finer).  With the
    deltas independent and the terms of random sign, as in the reference's
    normal draws, the error of y[j] has a variance of at most
        2 u^2 / 3 * sum_blocks sum_k Ut[k, j]^2 (sum_i V[k, i]^2 x_i^2 + w_k^2)
    (dense: 2 u^2 / 3 * sum_blocks sum_i D[j, i]^2 x_i^2), summed as the
    variant accumulates.  A statistical bound, not a worst case: the
    worst case sums |terms| and lets a wrong kernel through."""
    t_off, s_off = offs
    xg = _gathered(gather, x, s_off, ps, L)
    x2 = (xg * xg)[..., None]
    if kind == "lr":
        Ut, V = slabs[:, :r, :pt], slabs[:, r:, :ps]
        w = (V @ xg[..., None])[..., 0]
        s = ((V * V) @ x2)[..., 0] + w * w  # (nb, r)
        var = torch.sum(Ut * Ut * s[..., None], dim=1)  # (nb, pt)
    else:
        D = slabs[:, :, :ps]
        var = ((D * D) @ x2)[..., 0]
    y = torch.zeros(L, dtype=torch.float32, device=x.device)
    if accum == "roll":
        _accum_seg(y, t_off, var, L)
    elif accum == "static":
        _accum_static(y, var)
    return torch.sqrt(y * (2 * TF32_UNIT ** 2 / 3))[None]


def kernel_tolerance(kind, gather, term, accum, slabs, offs, x, L, G, r,
                     pt, ps, y_plain):
    """The elementwise bound (1, L) on |kernel - plain version|:
    KERNEL_TOL * max|y_plain| for the order of the f32 atomics, plus for
    term 'xgemm' XGEMM_SIGMAS times `tf32_error_std`.  A zero output, or
    one group of G blocks left out, falls far outside it (checked in
    tests/test_torch_profiling.py, and in chip_smoke.py at the reference's
    sizes)."""
    tol = torch.full_like(y_plain, KERNEL_TOL * float(y_plain.abs().max()))
    if term == "xgemm":
        tol += XGEMM_SIGMAS * tf32_error_std(kind, gather, accum, slabs,
                                             offs, x, L, G, r, pt, ps)
    return tol


_LIBS = {}


def _library():
    """The library of P3 and P4, built and loaded at first use, with its
    functions' ctypes signatures set once (P4's time is mostly the
    host's, so nothing is redone per call)."""
    if "bucket_variants" in _LIBS:
        return _LIBS["bucket_variants"]
    from ..ops.cuda_build import load

    lib = load("bucket_variants")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.bv_launch.argtypes = [i, i, i, i, p, p, p, p, p, p] + [i] * 8 + [p]
    lib.bv_take.argtypes = [p, i, i, p, i, p, p, p]
    lib.bv_launch.restype = lib.bv_take.restype = i
    lib.bv_error_string.argtypes = [i]
    lib.bv_error_string.restype = ctypes.c_char_p
    _LIBS["bucket_variants"] = lib
    return lib


def _raise_on(lib, rc, name):
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} "
                           f"({lib.bv_error_string(rc).decode()})")


def bucket_variant(kind, gather, term, accum, slabs, offs, x, L, G, r, pt,
                   ps, return_sink=False):
    """Kernel P3 on CUDA tensors, its plain version on CPU tensors: y (1, L)
    of one bucket of nb blocks (slabs (nb, rows, max(pt, ps)) f32, offs =
    (t_off, s_off) int32 (nb,)) under (gather, term, accum); with
    `return_sink` (accum 'skip' only), (y, the per-CTA sums)."""
    _check_variant(kind, gather, term, accum, slabs, offs, x, L, G, r, pt,
                   ps, return_sink)
    if x.device.type == "cpu":
        return bucket_variant_plain(kind, gather, term, accum, slabs, offs,
                                    x, L, G, r, pt, ps, return_sink)
    W = max(pt, ps)
    if (L % 4 or W % 8 or ps % 4 or slabs.data_ptr() % 32
            or x.data_ptr() % 16):
        raise ValueError("the kernel needs L a multiple of 4, max(pt, ps) of "
                         "8, ps of 4, slabs 32-byte and x 16-byte aligned")
    if term == "xgemm":
        _check_xgemm_shape(G, r, pt, ps, kind)
    lib = _library()
    nb = slabs.shape[0]
    y = torch.zeros((1, L), dtype=torch.float32, device=x.device)
    sink = (torch.empty(nb, dtype=torch.float32, device=x.device)
            if accum == "skip" else None)
    t_off, s_off = offs
    with torch.cuda.device(x.device):
        rc = lib.bv_launch(
            KINDS.index(kind), GATHERS.index(gather), TERMS.index(term),
            ACCUMS.index(accum), slabs.data_ptr(), t_off.data_ptr(),
            s_off.data_ptr(), x.data_ptr(), y.data_ptr(),
            None if sink is None else sink.data_ptr(), L, nb, G, r, pt, ps,
            slab_rows(kind, r, pt), W,
            torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(lib, rc, P3_NAME)
    LAUNCH_COUNTS[P3_NAME] += 1
    if return_sink:
        return y, sink[:n_ctas(term, nb, G)]
    return y


def _check_take(x, idx):
    if x.dtype != torch.float32 or x.ndim != 2 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous float32 2-d tensor, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if (idx.dtype != torch.int32 or idx.ndim != 2
            or idx.shape[0] != x.shape[0] or not idx.is_contiguous()
            or idx.device != x.device):
        raise ValueError(f"idx must be a contiguous int32 ({x.shape[0]}, m) "
                         f"tensor on {x.device}, got {idx.dtype} "
                         f"{tuple(idx.shape)} on {idx.device}")


def _out_of_range(n_bad, n):
    return IndexError(f"{n_bad} indices outside [0, {n})")


def take_along_axis_plain(x, idx):
    """P4's plain version: out[i, j] = x[i, idx[i, j]]; raises IndexError
    for an index outside the row."""
    _check_take(x, idx)
    bad = int(((idx < 0) | (idx >= x.shape[1])).sum())
    if bad:
        raise _out_of_range(bad, x.shape[1])
    rows = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[rows, idx.long()]


def take_along_axis(x, idx, fault=None):
    """Kernel P4 on CUDA tensors, its plain version on CPU tensors:
    out[i, j] = x[i, idx[i, j]] over int32 indices.

    Without `fault` it raises IndexError for an index outside the row: on
    CUDA the kernel counts them and the wrapper reads the count, which
    waits for the kernel.  With `fault`, a caller's int32 counter of one
    element on x's device (`fault_counter`), the count is added there and
    nothing is read back: out-of-range entries come out 0, and the caller
    checks the counter once, after many calls, with `check_fault`."""
    _check_take(x, idx)
    if fault is not None and (fault.dtype != torch.int32
                              or fault.numel() != 1
                              or fault.device != x.device):
        raise ValueError(f"fault must be one int32 on {x.device}, got "
                         f"{fault.dtype} {tuple(fault.shape)} on "
                         f"{fault.device}")
    own = fault is None
    if own:
        if x.device.type == "cpu":
            return take_along_axis_plain(x, idx)
        fault = fault_counter(x.device)
    if x.device.type == "cpu":
        inside = (idx >= 0) & (idx < x.shape[1])
        fault += (~inside).sum().to(torch.int32)
        rows = torch.arange(x.shape[0])[:, None]
        taken = x[rows, idx.long().clamp(0, x.shape[1] - 1)]
        return torch.where(inside, taken, torch.zeros((), dtype=x.dtype))
    lib = _library()
    out = torch.empty(idx.shape, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = lib.bv_take(x.data_ptr(), x.shape[0], x.shape[1],
                         idx.data_ptr(), idx.shape[1], out.data_ptr(),
                         fault.data_ptr(),
                         torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(lib, rc, P4_NAME)
    LAUNCH_COUNTS[P4_NAME] += 1
    if own:
        check_fault(fault, x.shape[1])
    return out


def fault_counter(device):
    """A zeroed out-of-range counter for `take_along_axis(..., fault=)`."""
    return torch.zeros(1, dtype=torch.int32, device=device)


def check_fault(fault, n):
    """Raises IndexError if `fault` (see `take_along_axis`) counted any
    index outside a row of n values: one read of the counter."""
    bad = int(fault.item())
    if bad:
        raise _out_of_range(bad, n)
