"""K1's attribution sweeps:
    python -m htool_python_torch.profiling.k1_sweeps [--cpu] [--ks 1,8,128]
        [--out FILE]

The port of the reference's K1 attribution scripts (tools/
profile_matvec9.py, 9b, 9d, 9e, 9f, 9g), which time its fused Pallas
product on synthetic and real buckets.  Here every case goes through the
port's normal entry, `ops/cuda_matvec.py apply_hmatrix_cuda` with a
`BucketTable`: kernel K1 on the card, its plain version
(`ops/matvec.py apply_hmatrix_padded`) on the CPU.

Synthetic one-bucket cases, drawn with numpy exactly as the scripts draw
them (the same default_rng seed, calls and order; nb rounded down to a
multiple of 8), 384 MiB each over L = 40960, and carried into the port's
layout by `interop.from_reference_data`; each case is freed before the
next is drawn:
  shape:   tools/profile_matvec9.py:37-44, K1's rate by block shape (x and
           y of L + 1024 rows);
  width:   tools/profile_matvec9b.py:36-44, 65, 77, the production
           kernel's width cases (its `_PROF_*` flag probes are TPU
           plumbing: their counterpart is profiling/k1_variants.py);
           L + 2048 rows;
  pow2:    tools/profile_matvec9d.py:45-58, part (a), the power-of-two
           widths; L + 2048 rows;
  offsets: tools/profile_matvec9e.py:32-69, one (r8, w1024) bucket under
           six offset structures: uniform, banded (63 band starts, sorted
           or shuffled) and constant targets, banded sources.  K1's work
           list (ops/matvec.py `work_list`) orders items largest first,
           ties in a fixed shuffled order, so the sorted and the shuffled
           banded targets reach K1 in orders of the same kind.

Cases on an operator the caller built (the headline when none is given:
N = 40000 in the unit ball, seed 0, 1/(0.1 + r), eps 1e-3, eta 10, leaf
128, float32), with x and y of its pad_len + 2048 rows (9d:111, 9f:58,
9g:69) and x drawn from default_rng(1) as 9f and 9g draw it:
  repad:   tools/profile_matvec9d.py:77-126 part (b) and 9f:58-104: for
           each rule of `repad` ('stored', and 'pow2', every stored width
           padded up to a power of two from 128), the whole product and
           the three largest low-rank buckets alone (9f:95-98's order),
           with the re-padded product held to the stored one (9d:114-121);
  swap:    tools/profile_matvec9g.py:56-88, the largest low-rank bucket
           (9g:56-58's rule) padded to powers of two, under {real, random}
           data x {real, random} offsets (default_rng(1), offsets below
           N - 700).
9f's per-bucket-against-fused leg is not here: chip_smoke.py
`kernel_cases` times K1 in each launch structure on this operator.

Each case reports, at each k of --ks (x's first column is the script's
x1, the others are drawn from default_rng(k)): ms by `timing.chain_time`
(the reference's reps, 10 / 60), device ms by `timing.device_ms`, the
stored bytes and GB/s over them (from both times), the share of P1's best
read rate measured in the same run (`bounds.p1_best_gbs`), and the bound
(`bounds.product_bound`) with what sets it; the re-padded products add
GB/s over the stored bytes before padding, as 9d:123-126 does.  At each k
of `check_ks` K1 is held against its plain version on the card within
1e-5 relative (max |y - y_plain| / max |y_plain|, as chip_smoke.py's
`k1_check`).

--cpu runs the plain versions at a tiny size (a few MiB a case, L = 4096,
a headline of 1200 points), each checked against a float64 product on the
host (`product_f64`), with no timing; the exit code is 1 if a check fails.
Without --cpu the sweeps run on CUDA and raise when there is no card: they
never fall back to the CPU.  One JSON object is printed, and written to
--out when given, keyed like the reference's *_result.json files.

Nothing here imports JAX, the reference package or tools/.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch

from .. import interop
from ..config import resolve_device
from ..ops.cuda_matvec import BucketTable, apply_hmatrix_cuda
from ..ops.matvec import apply_hmatrix_padded, is_aligned, stored_bytes
from .bounds import p1_best_gbs, product_bound
from .timing import chain_time, device_ms

LENGTH = 40960  # L of the synthetic cases (9.py:30, 9b:29, 9d:48, 9e:32)
TOTAL = 384 << 20  # bytes of one synthetic case
KS = (1, 8, 128)
CHECK_KS = (1, 128)
CHECK_TOL = 1e-5  # f32 atomics sum in a varying order; --cpu: against f64
REPAD_EXTRA = 2048  # rows added to the operator's x and y (9d:111)
SWAP_SEED = 1  # 9f:60 and 9g:70's default_rng
SWAP_MARGIN = 700  # 9g:76: random offsets below N - 700

# (name, kind, r, W): tools/profile_matvec9.py:37-44; x and y of L + 1024
SHAPE_CASES = [("lr_r8_w640", "lr", 8, 640), ("lr_r16_w640", "lr", 16, 640),
               ("lr_r64_w640", "lr", 64, 640),
               ("lr_r16_w256", "lr", 16, 256),
               ("lr_r32_w128", "lr", 32, 128),
               ("dense_128", "dense", 0, 128)]
SHAPE_PAD = 1024
# (r, W): tools/profile_matvec9b.py:65 ("w640_base") and :77; L + 2048
WIDTH_CASES = [(8, 640), (8, 512), (8, 384), (16, 384), (8, 256)]
# (r, W): tools/profile_matvec9d.py:52; L + 2048
POW2_CASES = [(8, 768), (8, 896), (8, 1024), (16, 1024)]
# tools/profile_matvec9e.py:35 and :60-67: (name, target kind, source kind)
OFFSET_BUCKET = (8, 1024)
OFFSET_CASES = [("t_rand__s_rand", "rand", "rand"),
                ("t_band_sorted__s_rand", "banded_sorted", "rand"),
                ("t_band_shuf__s_rand", "banded_shuffled", "rand"),
                ("t_rand__s_band", "rand", "banded_sorted"),
                ("t_band__s_band", "banded_sorted", "banded_sorted"),
                ("t_const__s_rand", "const", "rand")]
WIDE_PAD = 2048
FAMILIES = ("shape", "width", "pow2", "offsets", "repad", "swap")
RULES = ("stored", "pow2")

# --cpu: every case valid (at least 8 blocks of each shape), a few MiB each
TINY_LENGTH = 4096
TINY_TOTAL = 4 << 20
TINY_N = 1200
HEADLINE_N = 40000


@dataclasses.dataclass
class Case:
    """One synthetic case: `tree` is the bucket in the reference's layout
    ({'dense': [(D, t_off, s_off, mirror)], 'lr': [(U, V, t_off, s_off,
    mirror)]}, numpy leaves as the script draws them), `x1` the script's
    (pad_len, 1) float32 x."""

    name: str
    tree: dict
    x1: np.ndarray


def _normal(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _uniform(rng, high, nb):
    return rng.integers(0, high, nb).astype(np.int64)


def _blocks(total, per):
    return total // per // 8 * 8


def _bucket(mats, t_off, s_off):
    mirror = np.zeros(len(t_off), np.int8)
    if len(mats) == 1:
        return {"dense": [(mats[0], t_off, s_off, mirror)], "lr": []}
    return {"dense": [], "lr": [(*mats, t_off, s_off, mirror)]}


def _lowrank(rng, r, W, total, length):
    """make(r, W) of tools/profile_matvec9b.py:36-44 (and the loop bodies
    of 9.py:46-58, 9d:53-58): U, V, then t_off, s_off below L - W.
    Returns the bucket."""
    nb = _blocks(total, 2 * r * W * 4)
    mats = (_normal(rng, (nb, r, W)), _normal(rng, (nb, r, W)))
    t_off = _uniform(rng, length - W, nb)
    return _bucket(mats, t_off, _uniform(rng, length - W, nb))


def shape_cases(total=TOTAL, length=LENGTH):
    """tools/profile_matvec9.py:30-58: x1, then each shape's blocks and
    offsets, one case at a time."""
    rng = np.random.default_rng(0)
    x1 = _normal(rng, (length + SHAPE_PAD, 1))
    for name, kind, r, W in SHAPE_CASES:
        if kind == "lr":
            tree = _lowrank(rng, r, W, total, length)
        else:
            nb = _blocks(total, W * W * 4)
            D = _normal(rng, (nb, W, W))
            t_off = _uniform(rng, length - W, nb)
            tree = _bucket((D,), t_off, _uniform(rng, length - W, nb))
            del D
        yield Case(name, tree, x1)
        del tree


def width_cases(total=TOTAL, length=LENGTH):
    """tools/profile_matvec9b.py:29-80 without its flag probes: x1, then
    make(8, 640) ('w640_base') and make(r, W) of each later width."""
    rng = np.random.default_rng(0)
    x1 = _normal(rng, (length + WIDE_PAD, 1))
    for i, (r, W) in enumerate(WIDTH_CASES):
        tree = _lowrank(rng, r, W, total, length)
        yield Case("w640_base" if i == 0 else f"w{W}_r{r}_base", tree, x1)
        del tree


def pow2_cases(total=TOTAL, length=LENGTH):
    """tools/profile_matvec9d.py:45-58, part (a): x1, then each
    power-of-two width."""
    rng = np.random.default_rng(0)
    x1 = _normal(rng, (length + WIDE_PAD, 1))
    for r, W in POW2_CASES:
        tree = _lowrank(rng, r, W, total, length)
        yield Case(f"syn_r{r}_w{W}", tree, x1)
        del tree


def band_starts(length=LENGTH, width=OFFSET_BUCKET[1]):
    """tools/profile_matvec9e.py:45: the band starts."""
    return np.arange(0, length - width, (length - width) // 62)


def offset_cases(total=TOTAL, length=LENGTH):
    """tools/profile_matvec9e.py:32-69: one (r8, w1024) bucket's U, V,
    then x1, then each case's target and source offsets."""
    r, W = OFFSET_BUCKET
    nb = _blocks(total, 2 * r * W * 4)
    rng = np.random.default_rng(0)
    mats = (_normal(rng, (nb, r, W)), _normal(rng, (nb, r, W)))
    x1 = _normal(rng, (length + WIDE_PAD, 1))
    bands = band_starts(length, W)

    def offsets(kind):
        if kind == "rand":
            return _uniform(rng, length - W, nb)
        if kind == "banded_sorted":
            return np.sort(rng.choice(bands, nb)).astype(np.int64)
        if kind == "banded_shuffled":
            return rng.choice(bands, nb).astype(np.int64)
        return np.zeros(nb, np.int64) + 1024  # "const"

    for name, t_kind, s_kind in OFFSET_CASES:
        t_off = offsets(t_kind)
        yield Case(name, _bucket(mats, t_off, offsets(s_kind)), x1)


SYNTHETIC = {"shape": shape_cases, "width": width_cases, "pow2": pow2_cases,
             "offsets": offset_cases}


def pow2_up(n: int) -> int:
    """The scripts' `_pow2_up`: the least power of two from 128 up that
    holds n."""
    p = 128
    while p < n:
        p *= 2
    return p


def _widen(a):
    w = pow2_up(a.shape[2])
    return a if w == a.shape[2] else torch.nn.functional.pad(
        a, (0, w - a.shape[2]))


def repad(data, rule):
    """The operator's bucket data (canonical layout) under a padding rule:
    'stored' is the data itself, 'pow2' pads the last axis of every D, Ut
    and V with zeros up to `pow2_up` of its width, as the scripts' `padw`
    does (9d:93-102, 9f:64-71).  A padded block reaches further into x and
    y: give them REPAD_EXTRA more rows (the BucketTable's extent check
    holds the product to that)."""
    if is_aligned(data):
        raise ValueError("repad takes the canonical layout, not the aligned "
                         "one")
    if rule == "stored":
        return data
    if rule != "pow2":
        raise ValueError(f"rule must be one of {RULES}, got {rule!r}")
    return {"dense": [(_widen(D), t, s, m) for D, t, s, m in data["dense"]],
            "lr": [(_widen(U), _widen(V), t, s, m)
                   for U, V, t, s, m in data["lr"]]}


def largest_lowrank(data, count=3):
    """tools/profile_matvec9f.py:95-98: the indices of the `count` largest
    low-rank buckets by stored entries (Ut and V), largest first, ties to
    the later bucket."""
    sizes = sorted(((U.numel() + V.numel(), i)
                    for i, (U, V, *_) in enumerate(data["lr"])), reverse=True)
    return [i for _, i in sizes[:count]]


def swap_bucket(data) -> int:
    """tools/profile_matvec9g.py:56-58: the low-rank bucket with the most
    Ut entries, the first of equals."""
    lr = data["lr"]
    return max(range(len(lr)), key=lambda i: lr[i][0].numel())


def real_x1(pad2):
    """x1 of the operator's cases: (pad2, 1) from default_rng(1), as
    tools/profile_matvec9f.py:58-61 and 9g:69-71 draw it."""
    return _normal(np.random.default_rng(SWAP_SEED), (pad2, 1))


def swap_draws(shape, nb, n, pad2):
    """tools/profile_matvec9g.py:69-77 in its order: x1 (pad2, 1), random U
    and V of the padded bucket's `shape`, random t_off and s_off below
    n - 700, from default_rng(1)."""
    rng = np.random.default_rng(SWAP_SEED)
    x1 = _normal(rng, (pad2, 1))
    U_r = _normal(rng, shape)
    V_r = _normal(rng, shape)
    t_r = rng.integers(0, n - SWAP_MARGIN, nb).astype(np.int64)
    s_r = rng.integers(0, n - SWAP_MARGIN, nb).astype(np.int64)
    return x1, U_r, V_r, t_r, s_r


def swap_cases(data, n, pad2):
    """tools/profile_matvec9g.py:56-88: (x1, [(name, one-bucket data)]) of
    the 2 x 2 on the largest low-rank bucket padded to powers of two."""
    U, V, t_off, s_off, mirror = data["lr"][swap_bucket(data)]
    U, V = _widen(U), _widen(V)
    x1, U_r, V_r, t_r, s_r = swap_draws(tuple(U.shape), U.shape[0], n, pad2)
    dev = U.device
    U_r, V_r = (torch.from_numpy(a).to(dev) for a in (U_r, V_r))
    t_r, s_r = (torch.from_numpy(a.astype(np.int32)).to(dev)
                for a in (t_r, s_r))
    cases = [("realdata_realoff", U, V, t_off, s_off),
             ("realdata_randoff", U, V, t_r, s_r),
             ("randdata_realoff", U_r, V_r, t_off, s_off),
             ("randdata_randoff", U_r, V_r, t_r, s_r)]
    return x1, [(name, {"dense": [], "lr": [(u, v, t, s, mirror)]})
                for name, u, v, t, s in cases]


def wide_x(x1, k):
    """x of k columns: the script's x1, then k - 1 columns drawn from
    default_rng(k)."""
    if k == 1:
        return x1
    more = _normal(np.random.default_rng(k), (x1.shape[0], k - 1))
    return np.concatenate([x1, more], axis=1)


def product_f64(data, x, ny):
    """y (ny, k) = H x in float64 on the host with numpy, bucket by bucket
    (trans N, no mirrored blocks): the --cpu checks' reference, computed
    apart from the plain version."""
    x = np.asarray(x, np.float64)
    y = np.zeros((ny, x.shape[1]))
    for entry in data["dense"] + data["lr"]:
        mats = [m.cpu().numpy().astype(np.float64) for m in entry[:-3]]
        t_off, s_off, mirror = (a.cpu().numpy() for a in entry[-3:])
        if mirror.any():
            raise ValueError("product_f64 takes no mirrored blocks")
        xs = x[s_off.astype(np.int64)[:, None] + np.arange(mats[-1].shape[2])]
        if len(mats) == 1:
            out = np.einsum("nij,njk->nik", mats[0], xs)
        else:
            out = np.einsum("nri,nrk->nik", mats[0],
                            np.einsum("nrj,njk->nrk", mats[1], xs))
        rows = (t_off.astype(np.int64)[:, None]
                + np.arange(out.shape[1])).reshape(-1)
        vals = out.reshape(-1, x.shape[1])
        for c in range(x.shape[1]):
            y[:, c] += np.bincount(rows, weights=vals[:, c], minlength=ny)
    return y


def _max_rel(got, want) -> float:
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


class _Sweep:
    """One run's settings and the loop that measures a case."""

    def __init__(self, device, ks, check_ks, p1_gbs):
        self.device = device
        self.host = device.type == "cpu"  # checks against float64, no timing
        self.ks = tuple(ks)
        self.check_ks = tuple(k for k in check_ks if k in self.ks)
        self.p1_gbs = p1_gbs

    def xs(self, x1):
        """{k: x (pad_len, k) on the device} of one family."""
        return {k: torch.from_numpy(wide_x(x1, k)).to(self.device)
                for k in self.ks}

    def case(self, data, xs, orig_bytes=None):
        """One case: {nb, stored_bytes, k<k>: {...}} (see the module
        docstring).  On the CPU each k holds `rel_err` against
        `product_f64`; else each k holds the times, rates and bound, and
        `max_rel_err` against the plain version at each k of check_ks."""
        table = BucketTable(data, self.device)
        nbytes = stored_bytes(data)
        out = {"nb": sum(int(e[0].shape[0])
                         for e in data["dense"] + data["lr"]),
               "stored_bytes": nbytes}
        for k, x in xs.items():
            ny = x.shape[0]

            def fn(d, xv, ny=ny):
                return apply_hmatrix_cuda(d, xv, ny, "N", "N", table)

            if self.host:
                got = fn(data, x).numpy()
                out[f"k{k}"] = {"rel_err": _max_rel(
                    got, product_f64(data, x.numpy(), ny))}
                continue
            row = {}
            if k in self.check_ks:
                y = fn(data, x)
                y_plain = apply_hmatrix_padded(data, x, ny, "N", "N")
                row["max_rel_err"] = float(
                    (y - y_plain).abs().max() / y_plain.abs().max())
                del y, y_plain
            t = chain_time(fn, data, x)
            dev = device_ms(lambda: fn(data, x))
            bound, bound_by = product_bound(data, ny, k)
            row.update(ms=t * 1e3, device_ms=dev, GBs=nbytes / t / 1e9,
                       GBs_device=nbytes / dev / 1e6,
                       share_of_p1=nbytes / t / 1e9 / self.p1_gbs,
                       share_of_p1_device=nbytes / dev / 1e6 / self.p1_gbs,
                       bound_ms=bound, bound_by=bound_by)
            if orig_bytes is not None:
                row["GBs_orig_bytes"] = orig_bytes / t / 1e9
            out[f"k{k}"] = row
        return out

    def synthetic(self, family, total, length):
        """Every case of one synthetic family, each freed before the next
        is drawn."""
        out = {}
        xs = None
        for case in SYNTHETIC[family](total, length):
            if xs is None:
                xs = self.xs(case.x1)
            data = interop.from_reference_data(case.tree, self.device)
            out[case.name] = self.case(data, xs)
            if family == "offsets":
                out["nb"] = out[case.name]["nb"]
            del data, case
        return out

    def repad(self, data, pad_len, n):
        """Both padding rules on the operator's data: the whole product
        (held to the stored product at each check k: `repad_err`, the
        relative 2-norm of 9d:114-121) and the three largest low-rank
        buckets alone."""
        pad2 = pad_len + REPAD_EXTRA
        xs = self.xs(real_x1(pad2))
        orig = stored_bytes(data)
        out = {"N": n, "pad_len": pad_len, "rows": pad2,
               "real_bytes": {"orig": orig}}
        for rule in RULES:
            padded = repad(data, rule)
            out["real_bytes"][rule] = stored_bytes(padded)
            entry = {"whole": self.case(padded, xs, orig_bytes=orig)}
            table = BucketTable(padded, self.device)
            for k in self.ks if self.host else self.check_ks:
                x = xs[k]
                y2 = apply_hmatrix_cuda(padded, x, pad2, "N", "N", table)
                y_ref = apply_hmatrix_padded(data, x[:pad_len], pad_len, "N",
                                             "N")
                entry["whole"][f"k{k}"]["repad_err"] = float(
                    torch.linalg.vector_norm(y2[:pad_len] - y_ref)
                    / torch.linalg.vector_norm(y_ref))
                del y2, y_ref
            for j, i in enumerate(largest_lowrank(padded)):
                e = padded["lr"][i]
                one = {"dense": [], "lr": [e]}
                entry[f"real_bucket{j}_{e[0].shape[1]}x{e[0].shape[2]}"] = (
                    self.case(one, xs))
            out[rule] = entry
            del padded, table
        return out

    def swap(self, data, pad_len, n):
        """9g's 2 x 2 on the operator's largest low-rank bucket."""
        x1, cases = swap_cases(data, n, pad_len + REPAD_EXTRA)
        xs = self.xs(x1)
        U = cases[0][1]["lr"][0][0]
        out = {"bucket": swap_bucket(data), "nb": int(U.shape[0]),
               "r": int(U.shape[1]), "W": int(U.shape[2])}
        for name, one in cases:
            out[name] = self.case(one, xs)
        return out


def headline_operator(n, device, seed=0):
    """The headline operator (bench.py config 1, chip_smoke.py
    `main_path`): n points in the unit ball from RandomState(seed), kernel
    1/(0.1 + r), eps 1e-3, eta 10, leaf 128, float32, storage 'N'."""
    from ..clustering.cluster import ClusterTreeBuilder
    from ..hmatrix.generator import KernelGenerator
    from ..hmatrix.hmatrix import HMatrixTreeBuilder
    from ..models.geometry import create_random_points_in_sphere
    from ..models.kernels import inverse_distance_kernel

    points = create_random_points_in_sphere(n, np.random.RandomState(seed))
    builder = ClusterTreeBuilder()
    builder.set_maximal_leaf_size(128)
    cluster = builder.create_cluster_tree(points, 2)
    gen = KernelGenerator(inverse_distance_kernel(0.1), points, points,
                          device=device)
    hb = HMatrixTreeBuilder(1e-3, 10.0, "N", "N", device=device)
    hb.set_dtype(torch.float32)
    return hb.build(gen, cluster, cluster)


def run_sweeps(device, tiny=False, ks=KS, check_ks=CHECK_KS, operator=None,
               p1_gbs=None, on_family=None):
    """The sweeps on `device` (see the module docstring): {device, mode,
    size, ks, check_ks, p1_best_GBs, <family>: {...}, seconds: {family:
    host s, draws included}}.  On CUDA every case is timed and checked
    against the plain version at each k of check_ks; on the CPU every case
    is checked against float64 at each k, untimed.  `tiny`: the --cpu
    sizes (TINY_TOTAL, TINY_LENGTH, TINY_N) instead of the reference's.
    `operator`: an HMatrix for the repad and swap families (built here,
    the headline, when None); `p1_gbs`: P1's best rate of this run
    (measured here when None); `on_family(name, part)` is called as each
    family ends."""
    device = resolve_device(device)
    if device.type == "cuda" and p1_gbs is None:
        p1_gbs = p1_best_gbs(device)
    sweep = _Sweep(device, ks, check_ks, p1_gbs)
    result = {"device": (torch.cuda.get_device_name(device)
                         if device.type == "cuda" else "cpu"),
              "mode": "check" if sweep.host else "timing",
              "size": "tiny" if tiny else "reference", "ks": list(sweep.ks),
              "check_ks": list(sweep.ks if sweep.host else sweep.check_ks),
              "p1_best_GBs": p1_gbs}
    seconds = result["seconds"] = {}
    total, length = (TINY_TOTAL, TINY_LENGTH) if tiny else (TOTAL, LENGTH)
    for family in FAMILIES:
        t0 = time.perf_counter()
        if family in SYNTHETIC:
            result[family] = sweep.synthetic(family, total, length)
        else:
            if operator is None:
                operator = headline_operator(TINY_N if tiny else HEADLINE_N,
                                             device)
            data, n = operator._product_data(), int(operator.shape[0])
            part = sweep.repad if family == "repad" else sweep.swap
            result[family] = part(data, int(operator._pad_len), n)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        seconds[family] = time.perf_counter() - t0
        if on_family is not None:
            on_family(family, result[family])
    return result


def case_entries(result):
    """(family/case, entry) of every case in a result."""
    for family in FAMILIES:
        part = result.get(family, {})
        groups = ([(f"{family}/{rule}", part[rule]) for rule in RULES]
                  if family == "repad" else [(family, part)])
        for prefix, group in groups:
            for name, entry in group.items():
                if isinstance(entry, dict) and "nb" in entry:
                    yield f"{prefix}/{name}", entry


def failures(result):
    """The checks a result fails: an error above CHECK_TOL (K1 against its
    plain version; with --cpu the plain version against float64; a
    re-padded product against the stored one), or one that is not
    finite."""
    bad = []
    for name, entry in case_entries(result):
        for k in result["ks"]:
            row = entry[f"k{k}"]
            for key in ("rel_err", "max_rel_err", "repad_err"):
                if key in row and not row[key] <= CHECK_TOL:
                    bad.append(f"{name}/k{k}/{key}")
    return bad


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m htool_python_torch.profiling.k1_sweeps",
        description="Time K1 on the reference's attribution cases "
        "(tools/profile_matvec9*.py) on the card; --cpu checks the plain "
        "versions at a tiny size instead.")
    ap.add_argument("--cpu", action="store_true",
                    help="plain versions on the CPU, tiny size, no timing")
    ap.add_argument("--ks", default=",".join(map(str, KS)),
                    help="columns of x, comma-separated (default 1,8,128)")
    ap.add_argument("--out", help="also write the JSON result to this file")
    args = ap.parse_args(argv)
    ks = tuple(int(k) for k in args.ks.split(","))
    if args.cpu:
        device = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("the K1 sweeps run on a CUDA device and none "
                               "is available (--cpu checks the plain "
                               "versions instead)")
        from ..ops import cuda_build

        device = torch.device("cuda")
        cuda_build.build_all(["stream_probe", "hmatrix_product"])
    result = run_sweeps(device, tiny=args.cpu, ks=ks)
    bad = failures(result)
    result["failed"] = bad
    text = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text, flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
