"""A run with the timed path broken underneath comes out not correct: a
step that returns its state unchanged, half of the batch left out, an
answer altered where it is produced.  (One chip: no exchange between chips
to leave out.)  Each cell runs at a size a test can hold, on the CPU, with
its committed limits."""

import functools

import pytest
import torch

from conftest import small_cell, workloads
from harness import main

N = 1200


def _broken_matvec(fault):
    from htool_python_torch.hmatrix.hmatrix import HMatrix

    sound = HMatrix.matvec

    def matvec(self, x, trans="N"):
        if fault == "unchanged":
            return x.clone()
        y = sound(self, x, trans)
        if fault == "half":
            if y.shape[1] > 1:
                y[:, y.shape[1] // 2:] = 0
            else:
                y[y.shape[0] // 2:] = 0
        else:
            y[0] += y.abs().max(dim=0).values.to(y.dtype)
        return y
    return HMatrix, matvec


def _run(workload):
    cell = small_cell(workload, N)
    return main.run_cell(cell, 20240601, 0.2, False, torch,
                         torch.device("cpu"), 0.0)["checks"]


@functools.lru_cache(maxsize=None)
def _sound(workload):
    return _run(workload)


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("workload", workloads())
def test_a_broken_timed_path_is_not_correct(workload, fault, monkeypatch):
    sound = _sound(workload)
    cls, broken = _broken_matvec(fault)
    monkeypatch.setattr(cls, "matvec", broken)
    checks = _run(workload)
    # failed by a number that the fault moved far from the sound reading
    assert any(c["value"] > c["limit"]
               and c["value"] > 5 * sound[name]["value"]
               for name, c in checks.items()), (checks, sound)
