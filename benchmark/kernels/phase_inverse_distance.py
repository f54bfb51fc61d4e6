"""exp(i w (x_0 - y_0)) / (shift + |x - y|): the Helmholtz-style stage
kernel, a plane-wave phase over the inverse distance (complex, hermitian).

`kernel(params)` is the formula on broadcastable coordinate tensors
(..., 3) -> (...): the program's generator evaluates it during assembly and
the reference evaluates it in complex128 for the check."""

import torch

IS_COMPLEX = True


def kernel(params: dict):
    shift = float(params["shift"])
    w = float(params["wavenumber"])

    def k(x, y):
        r = torch.sqrt(torch.sum((x - y) ** 2, dim=-1))
        return torch.exp(1j * w * (x[..., 0] - y[..., 0])) / (shift + r)

    return k
