"""The device trace of a `--trace 1` window, reduced to a `Trace`.

torch.profiler records the device's activities (kernels, copies, fills)
over the window.  A fill launched right after a synchronize, just before
the window opens, ties the profiler's clock to the host's, so each idle
gap of the device can be named by what the host was doing then: inside
the program's call, waiting in the synchronize, or in the harness between
two requests.
"""

from __future__ import annotations

import bisect
import time

from .record import Record, Trace

TOP = 10  # entries of each breakdown list


def _device_events(prof, torch) -> list:
    """[(start_s, end_s, name)] of the device activities, in the profiler's
    clock."""
    cuda = torch.autograd.DeviceType.CUDA
    out = []
    results = getattr(prof.profiler, "kineto_results", None)
    if results is not None and hasattr(results, "events"):
        for e in results.events():
            if e.device_type() != cuda:
                continue
            if hasattr(e, "start_ns"):
                start, dur = e.start_ns() * 1e-9, e.duration_ns() * 1e-9
            else:
                start, dur = e.start_us() * 1e-6, e.duration_us() * 1e-6
            out.append((start, start + dur, e.name()))
        return out
    for e in prof.events():
        if e.device_type == cuda:
            out.append((e.time_range.start * 1e-6, e.time_range.end * 1e-6,
                        e.name))
    return out


def merge(intervals) -> list:
    """The union of [start, end] intervals, as sorted disjoint intervals."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


def host_label(record: Record, t: float, in_call: str, waiting: str) -> str:
    """What the host was doing at host time t in the window."""
    j = bisect.bisect_right(record.t_issue, t) - 1
    if j < 0:
        return "before the first request"
    if t <= record.t_return[j]:
        return in_call
    if t <= record.t_done[j]:
        return waiting
    return "harness, between requests"


def traced(torch, window, record: Record, in_call: str, waiting: str):
    """Run window() (which fills record's request times) under
    torch.profiler and set record.trace."""
    from torch.profiler import ProfilerActivity, profile

    marker = torch.zeros(1, device="cuda")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t_mark = time.perf_counter()
        marker.fill_(1.0)
        torch.cuda.synchronize()
        window()
    events = _device_events(prof, torch)
    if not events or not record.t_issue:
        return
    events.sort()
    offset = events[0][0] - t_mark  # profiler clock minus host clock
    w0 = record.t_issue[0] + offset
    w1 = record.t_done[-1] + offset
    inside = [(max(s, w0), min(e, w1), n) for s, e, n in events[1:]
              if e > w0 and s < w1]
    busy = merge((s, e) for s, e, _ in inside)
    by_name: dict = {}
    for s, e, n in inside:
        entry = by_name.setdefault(n, [0.0, 0])
        entry[0] += e - s
        entry[1] += 1
    gaps, prev = [], w0
    for s, e in busy + [[w1, w1]]:
        if s > prev:
            gaps.append((s - prev, host_label(record, (s + prev) / 2 - offset,
                                              in_call, waiting)))
        prev = max(prev, e)
    by_label: dict = {}
    for length, label in gaps:
        by_label[label] = by_label.get(label, 0.0) + length
    idle = sorted(([f"all gaps: {k}", v] for k, v in by_label.items()),
                  key=lambda kv: -kv[1])
    idle += [[f"longest gap: {label}", length]
             for length, label in sorted(gaps, reverse=True)]
    record.trace = Trace(busy_s=sum(e - s for s, e in busy),
                         window_s=record.t_done[-1] - record.t_issue[0],
                         n_events=len(inside), by_name=by_name,
                         idle_gaps=idle[:TOP])


def device_ops(trace: Trace) -> list:
    """[[name, seconds]] of the activities that took most device time."""
    top = sorted(trace.by_name.items(), key=lambda kv: -kv[1][0])[:TOP]
    return [[name[:160], sec] for name, (sec, _) in top]
