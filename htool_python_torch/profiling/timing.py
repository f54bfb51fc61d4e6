"""Timing on the card, shared by the profiling path and chip_smoke.py.

`cuda_ms` times a call by CUDA events; `device_ms` the same behind a spin
kernel, so that a short call's host time does not count; `chain_time`
times a device-resident chain of applications, the counterpart of the
reference's tools/profile_matvec.py:27 `_chain_time`.
"""

from __future__ import annotations

import time

import torch


def cuda_ms(fn, reps, warmup=3):
    """Mean ms per call of fn over `reps` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def chain_time(fn, data, x, reps_lo=10, reps_hi=60):
    """Seconds per application of fn in a chain: each rep computes
    y = fn(data, x) and carries x <- y / ||y|| into the next, so no rep can
    start before the one before it has finished.  A chain of reps_lo and
    one of reps_hi reps each run once to warm up, then once timed; the
    difference over reps_hi - reps_lo cancels the chain's fixed cost, as
    the reference's differencing does.  On a CUDA x the chains are timed by
    CUDA events, on the CPU by the host clock.  Returns at least 1e-9 s, as
    the reference does.

    Nothing checks the chain's values: a y of zeros (the `stream` variant
    of P3) makes x NaN from the second rep on, and the chain runs on."""
    cuda = x.device.type == "cuda"

    def chain(reps):
        xx = x
        for _ in range(reps):
            y = fn(data, xx)
            xx = y * (1.0 / torch.linalg.vector_norm(y))
        return xx

    def timed(reps):
        if not cuda:
            t0 = time.perf_counter()
            chain(reps)
            return time.perf_counter() - t0
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        chain(reps)
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) * 1e-3

    chain(reps_lo)
    chain(reps_hi)
    if cuda:
        torch.cuda.synchronize()
    t_lo = timed(reps_lo)
    t_hi = timed(reps_hi)
    return max((t_hi - t_lo) / (reps_hi - reps_lo), 1e-9)


def device_ms(fn, reps=20, cover_cycles=10_000_000):
    """Device ms per call of fn: CUDA events around `reps` calls queued
    behind a spin kernel (torch.cuda._sleep, ~5 ms on an H100), so that
    the card runs the calls back to back however long the host takes to
    queue them; a plain event timing of a short call measures the host."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(cover_cycles)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps
