"""The plain versions of the user-numbering permutation kernels (the port's
`permute_in` / `permute_out`, ops/matvec.py) and the product in user
numbering they surround, against the reference's `apply_hmatrix_user`
(CPU).

The operator is small random bucket data (a dense and a low-rank bucket,
random mirror flags) given to both packages as the same arrays, with
random permutations of its rows.  A permutation is an exact copy, so the
plain permutations equal numpy's row indexing bit for bit; the products
sum in different fixed orders, so they agree to the dtype's round-off
(1e-12 relative in float64 / complex128, 1e-5 in float32 / complex64).
The kernels themselves run on the card: tests/test_torch_gpu.py
`test_user_numbering_product_kernels`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from htool_python_torch import interop
from htool_python_torch.ops import cuda_matvec
from htool_python_torch.ops import matvec as port_mv
from htool_python_tpu.ops import matvec as ref_mv

N, L = 90, 256  # rows, padded length (a multiple of 4 above N, as plans pad)
_TOL = {np.float32: 1e-5, np.complex64: 1e-5, np.float64: 1e-12,
        np.complex128: 1e-12}


def _operator(dtype, seed=0):
    """numpy bucket data in the reference's layout: dense (3, 16, 12) and
    low-rank rank-4 (2, 4, 20) / (2, 4, 8) blocks inside the first N rows
    and columns."""
    rng = np.random.RandomState(seed)

    def arr(*shape):
        a = rng.randn(*shape)
        if np.issubdtype(dtype, np.complexfloating):
            a = a + 1j * rng.randn(*shape)
        return a.astype(dtype)

    def meta(nb, pt, ps):
        return (rng.randint(0, N - pt, nb).astype(np.int32),
                rng.randint(0, N - ps, nb).astype(np.int32),
                rng.rand(nb) < 0.5)

    return {"dense": [(arr(3, 16, 12), *meta(3, 16, 12))],
            "lr": [(arr(2, 4, 20), arr(2, 4, 8), *meta(2, 20, 8))]}


@pytest.mark.parametrize("trans", ["N", "T", "C"])
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("dtype", [np.float32, np.complex64, np.float64,
                                   np.complex128])
def test_plain_permutations_match_reference_user_product(dtype, k, trans):
    np_data = _operator(dtype)
    sym = "H" if np.issubdtype(dtype, np.complexfloating) else "S"
    rng = np.random.RandomState(k)
    perm_in, perm_out = rng.permutation(N), rng.permutation(N)
    inv_out = np.argsort(perm_out)
    x = rng.randn(N, k).astype(dtype)
    if np.issubdtype(dtype, np.complexfloating):
        x = x + 1j * rng.randn(N, k).astype(dtype)
    data = interop.from_reference_data(np_data, "cpu")
    t_perm_in, t_inv = (torch.as_tensor(p, dtype=torch.int32)
                        for p in (perm_in, inv_out))
    t_x = torch.as_tensor(x)

    # the plain permutations: exact row copies, zero padding
    x_pad = port_mv.permute_in(t_x, t_perm_in, L, t_x.dtype)
    assert x_pad.shape == (L, k) and x_pad.dtype == t_x.dtype
    assert np.array_equal(x_pad[:N].numpy(), x[perm_in])
    assert not x_pad[N:].any()
    y_pad = torch.as_tensor(rng.randn(L, k).astype(dtype))
    assert np.array_equal(port_mv.permute_out(y_pad, t_inv, N).numpy(),
                          y_pad.numpy()[:N][inv_out])
    # permute-out by the inverse of permute-in's permutation undoes it
    assert torch.equal(port_mv.permute_out(x_pad, torch.as_tensor(
        np.argsort(perm_in), dtype=torch.int32), N), t_x)

    # the product they surround, against the reference's one program
    before = dict(cuda_matvec.LAUNCH_COUNTS)
    y = port_mv.apply_hmatrix_user(data, t_perm_in, t_inv, t_x, L, trans,
                                   sym, N)
    assert cuda_matvec.LAUNCH_COUNTS == before  # the CPU launches nothing
    jx_data = {kind: [tuple(jnp.asarray(a) for a in e) for e in np_data[kind]]
               for kind in ("dense", "lr")}
    y_ref = np.asarray(ref_mv.apply_hmatrix_user(
        jx_data, jnp.asarray(perm_in), jnp.asarray(inv_out), jnp.asarray(x),
        L, trans, sym, N, backend="xla"))
    assert y.dtype == t_x.dtype and y_ref.dtype == dtype
    err = np.linalg.norm(y.numpy() - y_ref) / np.linalg.norm(y_ref)
    assert err <= _TOL[dtype], (dtype, k, trans, err)
    # and the port's own route: permutations around the plain product
    y_plain = port_mv.apply_hmatrix_padded(data, x_pad, L, trans, sym)
    assert torch.equal(y, port_mv.permute_out(y_plain, t_inv, N))
