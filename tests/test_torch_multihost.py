"""The port's multi-process entry points (parallel/multihost.py) and its
dryrun (`python -m htool_python_torch.parallel.dryrun`) on the CPU.

* `initialize_distributed` with neither arguments nor the variables
  `torchrun` sets does nothing and returns False (the reference's rule);
  `process_count` / `is_primary` then describe the single process.
* The dryrun at 2 processes (gloo), as a user runs it, under a subprocess
  timeout: every worker passes its checks and none loads JAX or the
  reference package; a worker past the launcher's deadline is killed and
  fails the run.
"""

import json
import os
import pathlib
import subprocess
import sys

import torch.distributed as dist

from htool_python_torch.parallel import multihost

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_initialize_distributed_without_variables(monkeypatch):
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                 "LOCAL_RANK"):
        monkeypatch.delenv(name, raising=False)
    assert multihost.initialize_distributed() is False
    assert not dist.is_initialized()
    assert multihost.process_count() == 1
    assert multihost.process_index() == 0
    assert multihost.is_primary()


def test_dryrun_two_processes():
    env = dict(os.environ, OMP_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "htool_python_torch.parallel.dryrun", "--cpu",
         "--processes", "2", "--timeout", "150"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=200)
    assert out.returncode == 0, out.stdout + out.stderr
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["dryrun"] == "ok" and result["backend"] == "gloo"
    assert result["processes"] == 2 and result["partitions"] == 4
    assert len(result["workers"]) == 2
    for worker in result["workers"]:
        assert worker["ok"]
        assert worker["product_err"] < 1e-10 and worker["trans_err"] < 1e-10
        assert worker["gmres_residual"] < 1e-8


def test_dryrun_fails_a_worker_past_its_timeout(tmp_path):
    """A worker still running at the deadline is killed and fails the run:
    the launcher never waits forever (the reference's own dryrun test hangs
    for minutes, ROADMAP section 3, fault 2)."""
    from htool_python_torch.parallel import dryrun

    rc, results = dryrun.launch(2, 2, cpu=True, timeout=0.5,
                                rendezvous_dir=tmp_path)
    assert rc == 1
    assert [code for code, _ in results] == [None, None]
    assert all(out == "timed out" for _, out in results)
