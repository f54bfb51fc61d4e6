"""Global precision / execution configuration and the device rule.

Counterpart of `htool_python_tpu/config.py`.  Dtypes are torch dtypes and
always explicit; every entry point that allocates takes a `device`, which
defaults to CUDA and never silently becomes the CPU (`resolve_device`).

Full f32 matrix products are part of the accuracy contract: TF32 keeps
about 1e-3 relative precision, which is exactly the headline epsilon, so
the port switches TF32 off when its ops are imported and checks it again
before assembly and products (`require_full_f32`).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class Config:
    """Framework-wide defaults. Mutable singleton accessed via get_config()."""

    # dtype used for coefficient data when the caller does not specify one
    real_dtype: torch.dtype = torch.float64
    complex_dtype: torch.dtype = torch.complex128
    # smallest padded block dimension of the bucket grid (hmatrix/plan.py)
    min_bucket_dim: int = 8
    # maximum ACA rank as a fraction of min(block dims); safety cap
    max_rank_ratio: float = 0.5
    # admissible blocks larger than this (either dim) are split further:
    # bounded ranks per block and few distinct bucket shapes
    max_block_size: int = 1024
    # assembly memory budget: batched ACA / QR+SVD / dense fills are
    # chunked over the block axis so that one chunk's dominant operand
    # stays under ~this many f32 elements (2^28 = 1 GB)
    assembly_chunk_elems: int = 1 << 28
    # launch structure of the product kernels K1 / K2 on CUDA
    # (ops/cuda_matvec.py, the only reader): 'fused' = one launch over
    # every bucket, 'per_bucket' = one launch per bucket, 'seq' = one
    # launch of a persistent grid walking the buckets; any other value
    # makes the next product raise ValueError
    matvec_kernel_mode: str = "fused"
    # the real f32 product reads the low-rank buckets in the aligned layout
    # (ops/matvec.py align_lowrank, lane ALIGN_LANE) through kernel K1-al;
    # HMatrix._product_data is the only reader
    matvec_aligned_layout: bool = False
    # DDM local solves (solvers/ddm.py): subdomains of at most this many
    # dofs (or with an explicit dense matrix) go to the batched dense tier;
    # larger H-matrix subdomains stay compressed and go to the
    # hierarchical tier (a copy of each, lu_factorization)
    ddm_local_dense_max: int = 6144
    # factorization (hmatrix/factorization.py): blocks up to this size
    # densify and factor (exact); larger ones use the level-batched HODLR
    # Woodbury factorization (ops/hodlr.py) built by randomized peeling
    # through the operator's own product
    hodlr_threshold: int = 4096
    hodlr_leaf_size: int = 256
    hodlr_sample_size: int = 32
    hodlr_power_iters: int = 1
    # cap on the adaptive sample doubling: a level whose off-diagonal rank
    # still saturates at this many samples raises HODLRRankSaturationError
    # (the factorization then falls back to the dense path)
    hodlr_max_sample_size: int = 1024
    # HODLR build tolerance = hodlr_eps_factor * hmatrix.epsilon
    hodlr_eps_factor: float = 0.1
    # iterative-refinement sweeps per HODLR solve (x += F^-1 (b - A x), the
    # residual through the operator's product)
    hodlr_refine_iters: int = 2
    # dense tier: 'invert' forms each subdomain's inverse once at
    # facto_one_level, so a preconditioner application is one batched
    # GEMM; 'solve' keeps the LU factors and solves with them each time
    ddm_dense_apply: str = "invert"

    def default_dtype(self, is_complex: bool) -> torch.dtype:
        return self.complex_dtype if is_complex else self.real_dtype


_CONFIG = Config()


def get_config() -> Config:
    return _CONFIG


def set_precision(mode: str) -> None:
    """Set the default coefficient precision: 'f32' or 'f64'."""
    cfg = get_config()
    if mode == "f32":
        cfg.real_dtype, cfg.complex_dtype = torch.float32, torch.complex64
    elif mode == "f64":
        cfg.real_dtype, cfg.complex_dtype = torch.float64, torch.complex128
    else:
        raise ValueError(f"unknown precision mode {mode!r} (want 'f32' or 'f64')")


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another.  Raises when CUDA is asked for and no card is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "htool_python_torch runs on a CUDA device by default and none "
                "is available; pass device='cpu' explicitly to run on the CPU")
        if dev.index is None:  # the form tensors report, so devices compare
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


_NP_TO_TORCH = {
    "float32": torch.float32, "float64": torch.float64,
    "complex64": torch.complex64, "complex128": torch.complex128,
}


def as_torch_dtype(dtype) -> torch.dtype:
    """torch dtype from a torch dtype, a numpy dtype or its name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    import numpy as np

    name = np.dtype(dtype).name
    if name not in _NP_TO_TORCH:
        raise TypeError(f"unsupported coefficient dtype {dtype!r}")
    return _NP_TO_TORCH[name]


def set_full_f32_matmul() -> None:
    """Switch TF32 off for CUDA matrix products and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def require_full_f32() -> None:
    """Raise if TF32 was switched back on after import."""
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise RuntimeError(
            "TF32 is enabled (torch.backends.cuda.matmul.allow_tf32 or "
            "torch.backends.cudnn.allow_tf32); its ~1e-3 relative precision "
            "breaks the epsilon contract — call "
            "htool_python_torch.config.set_full_f32_matmul()")
