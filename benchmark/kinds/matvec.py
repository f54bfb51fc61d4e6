"""Closed loop of products y = H X, one caller.

Each request is `HMatrix.matvec(X)` on a device-resident X of `columns`
columns in user numbering, taken in turn from a pool of `pool` inputs drawn
from the seed, and is ended by `torch.cuda.synchronize()`.  Most inputs are
standard normal (a Krylov vector has mixed signs).  The last
`point_inputs` of the pool hold one nonzero a column, at a point drawn
from the seed: their answers are columns of the operator, whose entry at
the point itself comes from its dense diagonal block alone.  A reservoir
drawn from the seed keeps one answer of each input, and the window's last,
for the check.  The window closes at the first pass through the pool that
ends after `seconds`, so every input is used equally often.

Traffic file keys: kind "matvec", columns, pool, point_inputs (0 where
absent).
"""

from __future__ import annotations

import random
import time

from harness import problem, reference

IN_CALL, WAITING = "in HMatrix.matvec", "in torch.cuda.synchronize"


def _inputs(s: problem.Setup, n: int, k: int) -> tuple:
    """(pool, supports): the pool of inputs and, for each, None or the
    point (row) of each column's one nonzero."""
    torch, tr = s.torch, s.cell.traffic
    size, n_point = int(tr["pool"]), int(tr.get("point_inputs", 0))
    g = torch.Generator(device=s.device).manual_seed(s.seeds[1])
    pool = [torch.randn((n, k), dtype=s.dtype, device=s.device, generator=g)
            for _ in range(size)]
    rows = torch.randperm(n, device=s.device, generator=g)[:n_point * k]
    supports = [None] * (size - n_point)
    cols = torch.arange(k, device=s.device)
    for p in range(size - n_point, size):
        at = rows[(p - size + n_point) * k:][:k]
        x = torch.zeros_like(pool[p])
        x[at, cols] = pool[p][at, cols]
        pool[p] = x
        supports.append(at)
    return pool, supports


def setup(s: problem.Setup) -> dict:
    import htool_python_torch as T

    torch = s.torch
    hm = problem.build_hmatrix(T, s)
    info = hm.get_local_information()
    n, k = s.points.shape[1], int(s.cell.traffic["columns"])
    s.record.counters.update(
        stored_bytes=int(info["Storage_size_in_bytes"]), n=n, k=k,
        itemsize=torch.empty((), dtype=s.dtype).element_size(),
        is_complex=s.is_complex)
    pool, supports = _inputs(s, n, k)
    for x in pool[:3]:  # warm-up: load the kernels, the tables, the perms
        hm.matvec(x)
    s.sync()
    return {"hm": hm, "pool": pool, "supports": supports}


def window(state: dict, s: problem.Setup, seconds: float) -> None:
    hm, pool, rec = state["hm"], state["pool"], s.record
    keep, uses = {}, [0] * len(pool)
    rng = random.Random(s.seeds[2])
    issue, ret, done = rec.t_issue, rec.t_return, rec.t_done
    clock, sync, n_pool = time.perf_counter, s.sync, len(pool)
    sync()
    deadline = clock() + seconds
    i, t2 = 0, clock()
    while t2 < deadline or i % n_pool:
        p = i % n_pool
        x = pool[p]
        t0 = clock()
        y = hm.matvec(x)
        t1 = clock()
        sync()
        t2 = clock()
        issue.append(t0)
        ret.append(t1)
        done.append(t2)
        uses[p] += 1  # reservoir of one answer of each input
        if rng.randrange(uses[p]) == 0:
            keep[p] = (i, y)
        i += 1
    kept = list(keep.values())
    if all(j != i - 1 for j, _ in kept):  # and the last answer
        kept.append((i - 1, y))
    rec.window_s = done[-1] - issue[0]
    state["kept"] = kept


def release(state: dict) -> dict:
    """The answers to check; frees the operator."""
    return {"kept": state.pop("kept"), "pool": state.pop("pool"),
            "supports": state.pop("supports")}


def check(answers: dict, s: problem.Setup, precision=None) -> dict:
    """{name: worst reading} over the kept answers, every column of each.
    Of the standard normal inputs: rel_err (2-norm error over the
    reference's norm) and row_err (largest error of a row over the
    reference's root-mean-square).  Of the point-supported ones: diag_err,
    the relative error of the answer at the input's own point."""
    pool, kept, supports = (answers["pool"], answers["kept"],
                            answers["supports"])
    used = sorted({i % len(pool) for i, _ in kept})
    X = s.torch.cat([pool[j] for j in used], dim=1)
    R = reference.dense_product(s.kernel, s.points, X, precision=precision)
    k = pool[0].shape[1]
    rel, row, diag = [], [], []
    for i, y in kept:
        p = i % len(pool)
        c = used.index(p) * k
        if supports[p] is None:
            a, b = reference.column_errors(y, R[:, c:c + k])
            rel += a
            row += b
        else:
            diag += reference.entry_errors(y, R[:, c:c + k], supports[p])
    out = {"rel_err": max(rel), "row_err": max(row)}
    if diag:
        out["diag_err"] = max(diag)
    return out


def _faulty(answers: dict, alter) -> dict:
    return {**answers,
            "kept": [(i, alter(i, y.clone())) for i, y in answers["kept"]]}


def _unchanged(answers, s):
    """Each product returns its input: a step that leaves its state as it
    was."""
    pool = answers["pool"]
    return _faulty(answers, lambda i, y: pool[i % len(pool)].clone())


def _half(answers, s):
    """Half of the batch left out: the second half of the columns (of the
    rows, for one column) is never computed."""
    def alter(i, y):
        if y.shape[1] > 1:
            y[:, y.shape[1] // 2:] = 0
        else:
            y[y.shape[0] // 2:] = 0
        return y
    return _faulty(answers, alter)


def _altered(answers, s):
    """An answer altered where it is produced: the first entry of each
    column is off by the column's largest magnitude."""
    def alter(i, y):
        y[0] += y.abs().max(dim=0).values.to(y.dtype)
        return y
    return _faulty(answers, alter)


FAULTS = {"unchanged": _unchanged, "half": _half, "altered": _altered}


def control(answers: dict, s: problem.Setup, precision: str) -> dict:
    """The readings of the reference put in the program's place at
    `precision`: its products of the kept answers' inputs, judged as the
    program's are."""
    pool, kept = answers["pool"], answers["kept"]
    used = sorted({i % len(pool) for i, _ in kept})
    X = s.torch.cat([pool[j] for j in used], dim=1)
    Y = reference.dense_product(s.kernel, s.points, X, precision=precision)
    k = pool[0].shape[1]
    fake = {**answers,
            "kept": [(i, Y[:, used.index(i % len(pool)) * k:][:, :k])
                     for i, _ in kept]}
    return check(fake, s)
