"""Run one cell of the benchmark of htool_python_torch once, on one card.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Prints one JSON line last on standard output
(`correct`, `attempted`, `failed`, `metrics`, `device`, with `--trace 1`
`breakdown`, and last `checks`: each compared number beside its limit) and
the compared numbers as the last lines of standard error.  Exits 2 for an
unknown workload or a missing file, 3 without enough CUDA cards, 4 if JAX
or the JAX package was loaded; a run that is not correct exits 0 with
`"correct": false`.
"""

import time

T_START = time.perf_counter()  # noqa: E402  (set-up is timed from here)

import os  # noqa: E402
import sys  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
# every build and kernel cache at a fixed path inside the checkout
BUILD = os.path.join(ROOT, "build")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(BUILD, "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(BUILD, "triton")
os.environ["CUDA_CACHE_PATH"] = os.path.join(BUILD, "cuda_cache")
sys.path[:0] = [BENCH, ROOT]

from harness.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
