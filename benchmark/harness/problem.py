"""What a configuration gives a traffic kind: its points, its kernel formula,
its precision, and the port's builders set up as the configuration says.

The points are the configuration's: drawn once from its `points_seed`
(`numpy.random.default_rng`), as a deployment keeps one mesh.  A run's
seed draws the numbering of those points and the traffic's inputs, so
every seed gives the same operator and the same amount of work, in
another order, and one seed the same inputs on every run and machine.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np

DTYPES = {"float32": ("float32", False), "complex64": ("complex64", True)}


def sub_seeds(seed: int, n: int = 4) -> list:
    """n independent 32-bit seeds drawn from any whole-number seed."""
    return [int(s) for s in np.random.SeedSequence(seed).generate_state(n)]


@dataclass
class Setup:
    """A run's problem, shared by the harness and the traffic kind."""

    cell: object  # spec.Cell
    seed: int
    torch: object
    device: object
    record: object  # record.Record
    points: np.ndarray = None  # (3, N), float64
    kernel: object = None  # the formula: k(x, y) on (..., 3) tensors
    is_complex: bool = False
    dtype: object = None  # the configuration's torch dtype
    seeds: list = field(default_factory=list)  # [numbering, inputs, sample, spare]

    def sync(self):
        if self.device.type == "cuda":
            self.torch.cuda.synchronize()


def make_setup(cell, seed, torch, device, record) -> Setup:
    cfg = cell.config
    name, is_complex = DTYPES[cfg["dtype"]]
    s = Setup(cell=cell, seed=seed, torch=torch, device=device, record=record,
              seeds=sub_seeds(seed), is_complex=is_complex,
              dtype=getattr(torch, name))
    points = cell.geometry().points(
        int(cfg["N"]), np.random.default_rng(int(cfg["points_seed"])))
    perm = np.random.default_rng(s.seeds[0]).permutation(points.shape[1])
    s.points = np.ascontiguousarray(points[:, perm])
    kernel_mod = cell.kernel()
    if bool(kernel_mod.IS_COMPLEX) != is_complex:
        raise ValueError(f"kernel {cfg['kernel']['name']} and dtype "
                         f"{cfg['dtype']} disagree on complex values")
    s.kernel = kernel_mod.kernel(cfg["kernel"])
    return s


def build_hmatrix(T, s: Setup):
    """The configuration's operator, with recompression where it says so;
    sets record.assembly_s (cluster tree and build, synchronized)."""
    cfg = s.cell.config
    t0 = time.perf_counter()
    cb = T.ClusterTreeBuilder()
    cb.set_maximal_leaf_size(int(cfg["leaf_size"]))
    cluster = cb.create_cluster_tree(s.points, 2)
    gen = T.KernelGenerator(s.kernel, s.points, s.points,
                            is_complex=s.is_complex, device=s.device)
    hb = T.HMatrixTreeBuilder(float(cfg["epsilon"]), float(cfg["eta"]),
                              cfg["symmetry"], cfg["UPLO"], device=s.device)
    hb.set_dtype(s.dtype)
    hm = hb.build(gen, cluster, cluster)
    s.sync()
    s.record.assembly_s = time.perf_counter() - t0
    if cfg.get("recompression"):
        T.recompression(hm)
        s.sync()
    return hm
