"""Dry run of the sharded operator in several processes.

    python -m htool_python_torch.parallel.dryrun                # one process per card
    python -m htool_python_torch.parallel.dryrun --cpu --processes 2

The counterpart of the reference's `__graft_entry__.py dryrun_multichip`
and `tools/multihost_dryrun.py`.  It starts N local processes (NCCL with
one process per card, or gloo on the CPU with --cpu) that meet on a
rendezvous file, and each builds the reference's problem (N = 64 P points
in the unit cube, seed 0, P partitions, 1/(0.1 + r), eps 1e-3, eta 10,
leaf 64, float64) and checks, against the single-process
DistributedOperator that every process also builds:

  * the sharded product, its 'T' product (against the block rows'
    densification) and a 3-column product, within 1e-10;
  * the sharded block-Jacobi preconditioner (`sharded_block_solve`)
    against its sequential loop, within 1e-10;
  * a GMRES solve with both to its tolerance, 1e-8.

Every process is joined under one deadline (--timeout): a process that
hangs fails the run, which never waits forever.  Exits non-zero on any
failed check; the last line is one JSON object with the results.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

TOL = 1e-10
GMRES_TOL = 1e-8
_ROOT = Path(__file__).resolve().parents[2]
_BANNED = ("jax", "jaxlib", "htool_python_tpu")


def build_problem(T, torch, P: int, device, dtype=None):
    """(points, cluster, DefaultApproximationBuilder) of the reference's
    dryrun problem on P partitions: every process draws the same points."""
    from ..models.kernels import inverse_distance_kernel

    n = 64 * P
    points = np.random.RandomState(0).random_sample((3, n))
    builder = T.ClusterTreeBuilder()
    builder.set_maximal_leaf_size(64)
    cluster = builder.create_cluster_tree(points, 2, size_of_partition=P)
    gen = T.KernelGenerator(inverse_distance_kernel(0.1), points, points,
                            device=device)
    hb = T.HMatrixTreeBuilder(1e-3, 10.0, "N", "N", device=device)
    hb.set_dtype(dtype if dtype is not None else torch.float64)
    return points, cluster, T.DefaultApproximationBuilder(gen, cluster,
                                                          cluster, hb)


def block_jacobi(torch, sharded, approx, cluster, device, group=None):
    """(preconditioner, dense subdomain matrices, their global indices) of
    the block-Jacobi preconditioner on the operator's partitions, through
    `sharded_block_solve`."""
    from .sharded import sharded_block_solve

    n = sharded.shape[0]
    perm = cluster.get_permutation()
    P = sharded.n_partitions
    m = int(sharded.t_sizes.max())
    mats = np.zeros((P, m, m))
    idx = np.full((P, m), n, dtype=np.int64)
    weights = np.zeros((P, m))
    ids = []
    for p in range(P):
        o, s = int(sharded.t_offsets[p]), int(sharded.t_sizes[p])
        ids.append(perm[o:o + s])
        idx[p, :s] = ids[-1]
        weights[p, :s] = 1.0
        mats[p, :s, :s] = approx.block_diagonal_hmatrix[p].to_dense()
        mats[p, range(s, m), range(s, m)] = 1.0
    lu, piv = torch.linalg.lu_factor(torch.as_tensor(mats, device=device))
    return (sharded_block_solve(lu, piv, idx, weights, n, group=group),
            mats, ids)


def run_checks(T, torch, P: int, device, group=None) -> dict:
    """The dryrun's checks on this process; raises AssertionError on a
    failed one, returns the errors and the solve's iterations."""
    from ..solvers.krylov import gmres_device
    from .sharded import ShardedDistributedOperator

    points, cluster, approx = build_problem(T, torch, P, device)
    n = points.shape[1]
    sharded = ShardedDistributedOperator(approx.hmatrix, cluster, cluster,
                                         group)
    op = approx.distributed_operator
    rng = np.random.RandomState(1)
    x = rng.rand(n)
    y = sharded * x
    y_ref = op * x
    err = float(np.linalg.norm(y - y_ref) / np.linalg.norm(y_ref))
    assert err < TOL, f"sharded product mismatch: {err:.3e}"

    dense = np.zeros((n, n))
    for p, h in enumerate(approx.hmatrix):
        o, s = int(sharded.t_offsets[p]), int(sharded.t_sizes[p])
        rows = cluster.get_permutation()[o:o + s]
        # a block row densifies with its rows in ascending user order
        dense[np.sort(rows), :] = h.to_dense_in_user_numbering()
    yt = sharded.matvec_global(x, "T")
    err_t = float(np.linalg.norm(yt - dense.T @ x)
                  / np.linalg.norm(dense.T @ x))
    assert err_t < TOL, f"sharded 'T' product mismatch: {err_t:.3e}"

    X = np.asfortranarray(rng.rand(n, 3))
    Y_ref = op @ X
    err_m = float(np.linalg.norm(sharded @ X - Y_ref) / np.linalg.norm(Y_ref))
    assert err_m < TOL, f"sharded 3-column product mismatch: {err_m:.3e}"

    precond, mats, ids = block_jacobi(torch, sharded, approx, cluster,
                                      device, group)
    z = precond(y)
    z_ref = np.zeros(n)
    for p, rows in enumerate(ids):
        s = len(rows)
        z_ref[rows] = np.linalg.solve(mats[p][:s, :s], y[rows])
    err_p = float(np.linalg.norm(z - z_ref) / np.linalg.norm(z_ref))
    assert err_p < TOL, f"sharded preconditioner mismatch: {err_p:.3e}"

    b = torch.as_tensor(y, device=device)
    x_sol, info = gmres_device(sharded.build_device_apply(), b,
                               M_fn=precond.device_apply, tol=GMRES_TOL,
                               max_it=200, restart=60)
    res = float(np.max(info["residual"]))
    assert res < GMRES_TOL, (f"preconditioned GMRES residual {res:.3e} did "
                             f"not reach {GMRES_TOL:g}")
    sol_err = float(np.linalg.norm(x_sol.cpu().numpy() - x)
                    / np.linalg.norm(x))
    return {"product_err": err, "trans_err": err_t, "matmat_err": err_m,
            "precond_err": err_p, "gmres_residual": res,
            "gmres_iterations": int(np.max(info["niter"])),
            "solution_err": sol_err}


def worker(args) -> int:
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(_ROOT))
    import htool_python_torch as T
    from .multihost import initialize_distributed, process_count

    if args.cpu:
        torch.set_num_threads(1)
    ok = initialize_distributed(f"file://{args.rendezvous}", args.processes,
                                args.rank, "gloo" if args.cpu else "nccl")
    assert ok and process_count() == args.processes
    device = (torch.device("cpu") if args.cpu
              else torch.device("cuda", torch.cuda.current_device()))
    out = {"rank": args.rank, "device": str(device)}
    try:
        out.update(run_checks(T, torch, args.partitions, device))
        loaded = sorted(m for m in sys.modules if m.split(".")[0] in _BANNED)
        assert not loaded, f"the port loaded {loaded}"
        out["ok"] = True
    except AssertionError as e:
        out.update(ok=False, error=str(e))
    finally:
        dist.destroy_process_group()
    print("dryrun_worker " + json.dumps(out), flush=True)
    return 0 if out["ok"] else 1


def launch(processes: int, partitions: int, cpu: bool, timeout: float,
           rendezvous_dir=None) -> tuple[int, list]:
    """Start `processes` workers and join them all by `timeout` seconds
    from now; a worker still running then is killed and the run fails.
    Returns (exit code, [(worker exit code or None, output)])."""
    tmp = None
    if rendezvous_dir is None:
        tmp = tempfile.TemporaryDirectory()
        rendezvous_dir = tmp.name
    rendezvous = Path(rendezvous_dir) / f"rendezvous-{os.getpid()}"
    env = dict(os.environ, PYTHONPATH=str(_ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    if cpu:
        env.update(OMP_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1",
                   MKL_NUM_THREADS="1")
    procs = []
    for rank in range(processes):
        cmd = [sys.executable, "-m", "htool_python_torch.parallel.dryrun",
               "--worker", "--rank", str(rank), "--processes",
               str(processes), "--partitions", str(partitions),
               "--rendezvous", str(rendezvous)] + (["--cpu"] if cpu else [])
        procs.append(subprocess.Popen(cmd, cwd=_ROOT, env=env,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    deadline = time.monotonic() + timeout
    results = []
    for proc in procs:
        try:
            out, _ = proc.communicate(timeout=max(deadline - time.monotonic(),
                                                  0.1))
            results.append((proc.returncode, out))
        except subprocess.TimeoutExpired:
            results.append((None, "timed out"))
    for proc in procs:  # stop whatever is left: a hung peer fails the run
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    if tmp is not None:
        tmp.cleanup()
    rc = 0 if all(code == 0 for code, _ in results) else 1
    return rc, results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--processes", type=int, default=None,
                    help="processes (default: one per card, 2 with --cpu)")
    ap.add_argument("--partitions", type=int, default=None,
                    help="partitions P, a multiple of --processes "
                    "(default: 2 per process)")
    ap.add_argument("--cpu", action="store_true",
                    help="gloo on the CPU instead of NCCL on the cards")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds by which every process must have ended")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--rendezvous", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        return worker(args)
    if args.processes is None:
        if args.cpu:
            args.processes = 2
        else:
            import torch

            if not torch.cuda.is_available():
                print("dryrun: no CUDA device (use --cpu)", file=sys.stderr)
                return 1
            args.processes = torch.cuda.device_count()
    partitions = args.partitions or 2 * args.processes
    t0 = time.perf_counter()
    rc, results = launch(args.processes, partitions, args.cpu, args.timeout)
    workers = []
    for rank, (code, out) in enumerate(results):
        lines = [ln for ln in out.splitlines()
                 if ln.startswith("dryrun_worker ")]
        if code != 0:
            print(f"dryrun: process {rank} exit {code}:\n{out[-4000:]}",
                  file=sys.stderr)
        workers.append(json.loads(lines[-1].split(" ", 1)[1]) if lines
                       else {"rank": rank, "ok": False, "exit": code})
    print(json.dumps({"dryrun": "ok" if rc == 0 else "failed",
                      "processes": args.processes, "partitions": partitions,
                      "backend": "gloo" if args.cpu else "nccl",
                      "seconds": time.perf_counter() - t0,
                      "workers": workers}), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
