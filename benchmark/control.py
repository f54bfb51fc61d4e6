"""The correctness check's readings: the program's, the control's and the
planted faults', at a cell's own size, seed after seed in one process.

    python3 benchmark/control.py --workload <name> --seeds 11,12,13 \\
        [--seconds 2] [--precisions tf32,bf16,fp8] [--out FILE]

For each seed it sets the cell up and runs a short window of its own
traffic, as a run does, then prints one JSON line: the numbers the check
compares for the program's answers ("program"); for the reference put in
the program's place at each lower precision ("control"); and for each
fault of the traffic kind planted in the program's answers where they are
produced ("faults").  The limits in limits/<workload>.json are set between
the program's readings and the smallest control or fault reading.  Needs a
CUDA card, as run.py does.
"""

import argparse
import gc
import json
import os
import sys

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
sys.path[:0] = [BENCH, ROOT]

from harness import problem, reference, spec  # noqa: E402
from harness.record import Record  # noqa: E402


def readings(cell, seed, seconds, precisions, torch, device) -> dict:
    kind = cell.kind()
    rec = Record(kind=cell.traffic["kind"])
    s = problem.make_setup(cell, seed, torch, device, rec)
    state = kind.setup(s)
    kind.window(state, s, seconds)
    s.sync()
    answers = kind.release(state)
    state.clear()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    out = {"seed": seed, "attempted": rec.count,
           "program": kind.check(answers, s),
           "control": {p: kind.control(answers, s, p) for p in precisions},
           "faults": {name: kind.check(fault(answers, s), s)
                      for name, fault in kind.FAULTS.items()}}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True,
                   help="comma-separated whole numbers")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--precisions", default=",".join(reference.PRECISIONS))
    p.add_argument("--out", help="also append the lines to this file")
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 3
    cell = spec.load_cell(args.workload)
    device = torch.device("cuda", 0)
    for seed in (int(x) for x in args.seeds.split(",")):
        line = json.dumps({"workload": args.workload, **readings(
            cell, seed, args.seconds, args.precisions.split(","), torch,
            device)})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
