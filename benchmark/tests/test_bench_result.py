"""The result's last line, the compared numbers on standard error, the
import check, and the refusal to run without a card."""

import json
import os
import subprocess
import sys

import pytest
import torch

from conftest import BENCH, ROOT, small_cell
from harness import importcheck, main


def test_last_line_and_checks(capsys):
    cell = small_cell("invdist-n40k-f32.matvec-k1", 1200)
    result = main.run_cell(cell, 2 ** 31 + 12345, 0.3, False, torch,
                           torch.device("cpu"), 0.0)
    result["device"] = {"platform": "gpu", "kind": "test", **result["device"]}
    assert main.finish(result) == 0
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["metrics"]) == {"matvec_ms.krylov",
                                    "matvec_p95_ms.krylov", "setup_s"}
    for m in line["metrics"].values():
        assert m["value"] > 0 and m["unit"] in ("ms", "s")
    assert set(line["checks"]) == set(cell.limits["numbers"])
    tail = err.strip().splitlines()[-len(line["checks"]):]
    for name, c in line["checks"].items():
        assert any(t.startswith(f"check {name} = ") and repr(c["limit"]) in t
                   for t in tail)


def test_trace_metrics_are_left_out_where_nothing_was_traced():
    cell = small_cell("invdist-n40k-f32.matvec-k128", 1200)
    result = main.run_cell(cell, 7, 0.2, True, torch, torch.device("cpu"),
                           0.0)
    # the CPU has no device trace: only the host readers report
    assert set(result["metrics"]) == {"dispatch_us.matvec", "assembly_s"}
    assert result["metrics"]["dispatch_us.matvec"]["value"] > 0


def test_forbidden_names_are_compared_whole():
    mods = {"jax.numpy": 0, "htool_python_torch.ops": 0, "jaxtyping": 0,
            "htool_python_tpu": 0, "flaxen": 0, "numpy": 0}
    assert importcheck.forbidden_loaded(mods) == ["htool_python_tpu", "jax"]


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = ("import sys, torch; sys.path[:0] = [%r, %r]; torch.set_num_threads(1)\n"
            "from conftest import small_cell\n"
            "from harness import importcheck, main\n"
            "cell = small_cell('helmholtz-n100k-c64.matvec-k8', 600)\n"
            "main.run_cell(cell, 1, 0.1, False, torch, torch.device('cpu'), 0.0)\n"
            "assert 'htool_python_torch' in sys.modules\n"
            "print(importcheck.forbidden_loaded())\n"
            % (os.path.join(BENCH, "tests"), BENCH))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=300)
    assert out.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.parametrize("args,code", [
    (["--workload", "invdist-n40k-f32.matvec-k1"], 3),
    (["--workload", "no-such.cell"], 2)])
def test_no_result_without_a_card_or_a_cell(args, code):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", *args, "--seed", "3000000000",
         "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True,
        text=True, timeout=300)
    assert out.returncode == code
    assert "correct" not in out.stdout
