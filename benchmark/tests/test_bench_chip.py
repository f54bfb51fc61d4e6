"""On the card: a cell runs end to end through benchmark/run.py and is
correct, and the control fails at the cell's own size.  Skips without a
CUDA device.  On the card: `python -m pytest benchmark/tests -q -m gpu`."""

import json
import subprocess
import sys

import pytest

import control
from conftest import ROOT
from harness import spec

WORKLOAD = "invdist-n40k-f32.matvec-k1"


@pytest.mark.gpu
def test_a_cell_runs_and_is_correct_on_the_card(cuda_device):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", WORKLOAD,
         "--seed", "2147483659", "--seconds", "2", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert line["metrics"]["matvec_ms.krylov"]["value"] > 0


@pytest.mark.gpu
def test_the_control_fails_at_the_cells_size(cuda_device):
    import torch

    cell = spec.load_cell(WORKLOAD)
    precisions = cell.limits["control"]
    r = control.readings(cell, 2147483661, 1.0, precisions, torch,
                         cuda_device)
    for p in precisions:
        assert any(r["control"][p][name] > limit
                   for name, limit in cell.limits["numbers"].items()), p
    assert all(r["program"][name] <= limit
               for name, limit in cell.limits["numbers"].items())
