"""Build and load the port's hand-written CUDA kernels.

Each source under htool_python_torch/csrc/ has a plain C interface and is
compiled by `nvcc` into its own shared library, loaded with ctypes.  The
build runs at first use, into `build/` at the root of the checkout, keyed
by a hash of the source and flags, so a changed source rebuilds and an
unchanged one loads at once.  `build_all` starts one `nvcc` per source,
all at the same time.  Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build"

# kernel library name -> source file under csrc/
SOURCES = {"hmatrix_product": "hmatrix_product.cu",  # K1, K2
           # float64 and complex128 products
           "hmatrix_product_f64": "hmatrix_product_f64.cu",
           "stream_probe": "stream_probe.cu",  # P1, P2
           "bucket_variants": "bucket_variants.cu"}  # P3, P4

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOADED: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin and PATH); the CUDA kernels "
                           "cannot be built")
    return found


def library_path(name: str) -> Path:
    src = (CSRC / SOURCES[name]).read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{key}.so"


def build_all(names=None) -> dict:
    """Compile every missing library of `names` (default: all), one nvcc
    process per source, started together.  Returns {name: seconds} for the
    builds run; raises with nvcc's output when one fails.  Each library's
    ptxas report (registers, shared memory, spills) is kept beside it as
    `<library>.log`."""
    names = list(SOURCES) if names is None else list(names)
    todo = {n: library_path(n) for n in names if not library_path(n).exists()}
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name, out in todo.items():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    seconds, failures = {}, []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {SOURCES[name]} "
                            f"(exit {proc.returncode}):\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)  # atomic: concurrent builders never see a partial file
    if failures:
        raise RuntimeError("\n".join(failures))
    return seconds


def ptxas_report(name: str) -> str:
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library `name`, built first if it is missing."""
    if name not in _LOADED:
        build_all([name])
        _LOADED[name] = ctypes.CDLL(str(library_path(name)))
    return _LOADED[name]
