"""CPU tests of the benchmark's harness: run with
`python -m pytest benchmark/tests -q` from the root of the checkout.
Tests that need a CUDA card carry the `gpu` marker and skip without one."""

import json
import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for path in (ROOT, BENCH):
    if path not in sys.path:
        sys.path.insert(0, path)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips where there is none")


@pytest.fixture(scope="session", autouse=True)
def one_thread():
    """One torch thread: the CPU build's LU hangs with more (and workers
    running side by side oversubscribe the cores)."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the cells run on the card")
    return torch.device("cuda", 0)


def workloads() -> list:
    from harness import spec

    return [w["name"] for w in json.loads(
        (spec.ROOT / "BENCHMARK.json").read_text())["workloads"]]


def small_cell(workload, n):
    """The cell as BENCHMARK.json has it, at n points."""
    from harness import spec

    cell = spec.load_cell(workload)
    cell.config["N"] = n
    return cell
