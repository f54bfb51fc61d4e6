"""1 / (shift + |x - y|): the reference's example and test kernel.

`kernel(params)` is the formula on broadcastable coordinate tensors
(..., 3) -> (...): the program's generator evaluates it during assembly and
the reference evaluates it in float64 for the check."""

import torch

IS_COMPLEX = False


def kernel(params: dict):
    shift = float(params["shift"])

    def k(x, y):
        return 1.0 / (shift + torch.sqrt(torch.sum((x - y) ** 2, dim=-1)))

    return k
