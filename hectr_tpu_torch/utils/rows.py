"""Matrix-vector products over a batch of rows, each row bit-equal to
its own unbatched product on the CPU."""

from __future__ import annotations

import torch


def matvec(M: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """M [r, c] applied to the last axis of x [..., c] -> [..., r].

    A 1-D x is the plain product ``M @ x``.  On the card a batch is one
    product ``x @ M.mT`` (a row may round an ulp apart from its 1-D
    product).  On the CPU, output index i of a batch is one
    matrix-vector product ``x @ M[i]`` over all rows: the BLAS dot
    product that ``M @ x_row`` computes for that index, with the roles of
    matrix and vector swapped, so every row equals its 1-D product bit
    for bit (a batched matrix product sums in another order).  That is r
    products whatever the batch, none per row."""
    if x.dim() == 1:
        return M @ x
    if x.device.type != "cpu":
        return x @ M.mT
    return torch.stack([x @ row for row in M], dim=-1)
