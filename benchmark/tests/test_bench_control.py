"""The control comes out not correct: the plain reference put in the
program's place, computed at the precision named in the cell's limits file
(`control`: TF32, bfloat16 and fp8, each below the configuration's float32
or complex64), fails at least one of the cell's committed limits, at a size
a test can hold on the CPU; so does each planted fault.  The same readings at the cells' own sizes on
the card come from `benchmark/control.py` (see test_bench_chip.py)."""

import pytest
import torch

import control
from conftest import small_cell, workloads


@pytest.mark.parametrize("workload", workloads())
def test_the_control_is_not_correct(workload):
    cell = small_cell(workload, 1200)
    precisions = cell.limits["control"]
    r = control.readings(cell, 4_000_000_007, 0.2, precisions, torch,
                         torch.device("cpu"))
    limits = cell.limits["numbers"]
    assert all(r["program"][name] <= limit for name, limit in limits.items())
    for p in precisions:
        assert any(r["control"][p][name] > limit
                   for name, limit in limits.items()), (p, r)
    assert all(any(r["faults"][f][name] > limit
                   for name, limit in limits.items())
               for f in r["faults"]), r
