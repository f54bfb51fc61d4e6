"""Port vs reference in complex64: the plain version of kernel K2 against
the reference's complex Pallas kernel `apply_hmatrix_pallas_complex` (run
by the Pallas interpreter on the CPU, as tests/test_pallas_matvec.py runs
it, on the reference's re/im plane split of its own complex64 buckets),
for trans N/T/C x storage N, S-L x k in {1, 3} (H-L and H-U:
tests/test_torch_hermitian_pallas.py; the interpreter compiles each case
for seconds, so the cases are split over two files).  The two sum in
different orders in f32, so they agree to 1e-5 relative, the bound the
reference holds its plane kernel to.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from htool_python_torch import interop
from htool_python_torch.ops.matvec import apply_hmatrix_padded
from htool_python_tpu.ops.matvec import split_planes
from htool_python_tpu.ops.pallas_matvec import apply_hmatrix_pallas_complex
from test_torch_complex import one_thread  # noqa: F401 (fixture)
from test_torch_complex import random_pad, reference_complex_operator

_STORAGES = [("N", "N"), ("S", "L")]


def c64_operators(storages):
    """The reference's complex64 operators (n = 200, eps 1e-4)."""
    return {sym: reference_complex_operator(*sym, np.complex64, eps=1e-4,
                                            n=200)[0]
            for sym in storages}


def check_plain_k2_against_pallas(hm, symmetry, trans, k):
    data = interop.from_reference_data(
        jax.tree_util.tree_map(np.asarray, hm._data), "cpu")
    assert data["lr"] and data["lr"][0][0].dtype == torch.complex64
    L, n = hm._pad_len, hm.shape[0]
    x_pad = random_pad(L, n, k, seed=k, dtype=np.complex64)
    y_pallas = np.asarray(apply_hmatrix_pallas_complex(
        split_planes(hm._data)["cplanes"], jnp.asarray(x_pad), L, trans,
        symmetry, interpret=True))
    y_port = apply_hmatrix_padded(data, torch.as_tensor(x_pad), L, trans,
                                  symmetry)
    assert y_port.dtype == torch.complex64
    err = (np.linalg.norm(y_port.numpy() - y_pallas)
           / np.linalg.norm(y_pallas))
    assert err <= 1e-5, err


@pytest.fixture(scope="module")
def operators():
    return c64_operators(_STORAGES)


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("trans", ["N", "T", "C"])
@pytest.mark.parametrize("symmetry,UPLO", _STORAGES)
def test_plain_k2_matches_pallas_c64(operators, symmetry, UPLO, trans, k):
    check_plain_k2_against_pallas(operators[(symmetry, UPLO)], symmetry,
                                  trans, k)
