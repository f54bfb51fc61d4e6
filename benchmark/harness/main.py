"""One run of one cell: set-up, the measured window, the check, the result.

The order matters.  Set-up (imports, points, assembly, warm-up) ends
before the window opens; the device memory peak is read when it closes;
then the program's state is freed, and only then does the reference run,
so neither its time nor its memory enters a metric.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import subprocess
import sys
import time

from . import importcheck, problem, spec
from . import trace as tracing
from .record import Record


def parse(argv):
    p = argparse.ArgumentParser(prog="benchmark/run.py",
                                description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True,
                   help="a workload name of BENCHMARK.json")
    p.add_argument("--seed", type=int, required=True,
                   help="any whole number: the inputs follow from it")
    p.add_argument("--seconds", type=float, required=True,
                   help="length of the measured window")
    p.add_argument("--trace", type=int, choices=(0, 1), default=0,
                   help="1: trace the window and report the per-layer "
                        "metrics instead of the end-to-end ones")
    return p.parse_args(argv)


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"unknown ({type(e).__name__})"


def run_cell(cell, seed: int, seconds: float, trace: bool, torch, device,
             t_start: float) -> dict:
    """Set up, measure and check one run; returns the result's fields
    (without the device's name)."""
    cuda = device.type == "cuda"
    kind = cell.kind()
    rec = Record(kind=cell.traffic["kind"])
    s = problem.make_setup(cell, seed, torch, device, rec)
    state = kind.setup(s)
    s.sync()
    if cuda:
        rec.resident_bytes = torch.cuda.memory_allocated(device)
    rec.setup_s = time.perf_counter() - t_start

    if trace and cuda:
        tracing.traced(torch, lambda: kind.window(state, s, seconds), rec,
                       kind.IN_CALL, kind.WAITING)
    else:
        kind.window(state, s, seconds)
    s.sync()
    if cuda:
        rec.peak_bytes = torch.cuda.max_memory_allocated(device)

    answers = kind.release(state)
    state.clear()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    readings = kind.check(answers, s)
    checks = {name: {"value": float(readings[name]), "limit": float(limit)}
              for name, limit in cell.limits["numbers"].items()}
    correct = rec.count > 0 and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values())

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec.metric_reader(m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    result = {"correct": bool(correct), "attempted": rec.count,
              "failed": int(rec.failed), "metrics": metrics,
              "device": {"count": cell.chips,
                         "memory_peak_bytes": rec.peak_bytes}}
    if rec.trace is not None:
        result["device"].update(busy_s=rec.trace.busy_s,
                                window_s=rec.trace.window_s)
        result["breakdown"] = {"device_ops": tracing.device_ops(rec.trace),
                               "idle_gaps": rec.trace.idle_gaps}
    result["checks"] = checks
    return result


def finish(result: dict) -> int:
    """Print the compared numbers as the last lines of standard error and
    the result as the last line of standard output; 4 if a forbidden
    package is loaded."""
    bad = importcheck.forbidden_loaded()
    if bad:
        print("forbidden packages loaded in this process: "
              + ", ".join(bad), file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr, flush=True)
    checks = result.pop("checks")
    result["checks"] = checks  # the compared numbers come last
    print(json.dumps(result), flush=True)
    return 0


def main(argv, t_start: float) -> int:
    args = parse(argv)
    try:
        cell = spec.load_cell(args.workload)
    except spec.SpecError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA device (torch.cuda.is_available() is false); "
              "the benchmark measures the card only", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell.chips:
        print(f"error: {args.workload} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), torch,
                      device, t_start)
    result["device"] = {"platform": "gpu",
                        "kind": torch.cuda.get_device_name(0),
                        **result["device"],
                        "power_limit": power_limit()}
    return finish(result)
