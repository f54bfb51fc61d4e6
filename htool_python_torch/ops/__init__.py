"""Device operations: batched ACA/truncation and the bucketed product.

Importing the ops switches TF32 off for CUDA matrix products and cuDNN:
TF32 keeps about 1e-3 relative precision, exactly the headline epsilon.
"""

from ..config import set_full_f32_matmul

set_full_f32_matmul()

from . import aca, matvec  # noqa: E402  (after the TF32 switch)

__all__ = ["matvec", "aca"]
