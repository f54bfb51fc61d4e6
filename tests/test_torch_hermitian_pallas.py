"""Port vs reference in complex64, hermitian storage: the plain version of
kernel K2 against the reference's complex Pallas kernel (Pallas
interpreter, CPU) for trans N/T/C x storage H-L, H-U x k in {1, 3}, within
1e-5 relative; the cases of tests/test_torch_complex_pallas.py, which
holds the check, for the other storages.
"""

import pytest

from test_torch_complex import one_thread  # noqa: F401 (fixture)
from test_torch_complex_pallas import c64_operators, \
    check_plain_k2_against_pallas

_STORAGES = [("H", "L"), ("H", "U")]


@pytest.fixture(scope="module")
def operators():
    return c64_operators(_STORAGES)


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("trans", ["N", "T", "C"])
@pytest.mark.parametrize("symmetry,UPLO", _STORAGES)
def test_plain_k2_matches_pallas_hermitian(operators, symmetry, UPLO, trans,
                                           k):
    check_plain_k2_against_pallas(operators[(symmetry, UPLO)], symmetry,
                                  trans, k)
