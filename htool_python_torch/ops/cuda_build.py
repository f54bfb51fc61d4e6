"""Build and load the port's hand-written native code.

Each source under htool_python_torch/csrc/ has a plain C interface and is
compiled into its own shared library, loaded with ctypes: the CUDA kernels
(`.cu`) by `nvcc`, the host cluster-tree builder (`.cpp`) by `g++`.  The
build runs at first use, into `build/` at the root of the checkout, keyed
by a hash of the source and flags (for `g++ -march=native` also of the
compiler's version and the instruction set it targets here, so a library
built on another machine is never loaded), so a changed source rebuilds
and an unchanged one loads at once.  `build_all` starts one compiler per source, all at the
same time.  A failed build raises with the compiler's output; nothing here
runs at import.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build"

# library name -> source file under csrc/
SOURCES = {"hmatrix_product": "hmatrix_product.cu",  # K1, K2
           # float64 and complex128 products
           "hmatrix_product_f64": "hmatrix_product_f64.cu",
           "stream_probe": "stream_probe.cu",  # P1, P2
           "bucket_variants": "bucket_variants.cu",  # P3, P4
           "cluster_builder": "cluster_builder.cpp"}  # host: cluster trees

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
GXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]

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


def _host_source(name: str) -> bool:
    return SOURCES[name].endswith(".cpp")


@functools.lru_cache(maxsize=None)
def _gxx_target() -> str:
    """The compiler's version and what `g++ -march=native` resolves to on
    this machine (every target option, enabled or not): part of a host
    library's key."""
    try:
        return "".join(
            subprocess.run(["g++", *args], capture_output=True, text=True,
                           check=True).stdout
            for args in (["--version"],
                         ["-march=native", "-Q", "--help=target"]))
    except (OSError, subprocess.CalledProcessError) as e:
        raise RuntimeError(f"g++ cannot report its target ({e}); the host "
                           "cluster-tree builder cannot be built") from e


def _command(name: str, out: Path) -> list:
    src = str(CSRC / SOURCES[name])
    if _host_source(name):
        return ["g++", *GXX_FLAGS, "-o", str(out), src]
    return [_nvcc(), *NVCC_FLAGS, "-o", str(out), src]


def library_path(name: str) -> Path:
    src = (CSRC / SOURCES[name]).read_bytes()
    flags = (" ".join(GXX_FLAGS) + _gxx_target() if _host_source(name)
             else " ".join(NVCC_FLAGS))
    key = hashlib.sha256(src + flags.encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{key}.so"


def build_all(names=None) -> dict:
    """Compile every missing library of `names` (default: all), one
    compiler process per source, started together.  Returns {name:
    seconds} for the builds run; raises with the compiler's output when one
    fails or cannot start.  Each library's compiler report (for a kernel,
    ptxas's registers, shared memory and spills) is kept beside it as
    `<library>.log`."""
    names = list(SOURCES) if names is None else list(names)
    todo = {n: library_path(n) for n in names if not library_path(n).exists()}
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, seconds, failures = {}, {}, []
    for name, out in todo.items():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = _command(name, tmp)
        try:
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
        except OSError as e:
            failures.append(f"{cmd[0]} could not start for {SOURCES[name]}: "
                            f"{e}")
            continue
        procs[name] = (proc, cmd[0], tmp, out, time.perf_counter())
    for name, (proc, compiler, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"{os.path.basename(compiler)} failed for "
                            f"{SOURCES[name]} (exit {proc.returncode}):\n{log}")
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
