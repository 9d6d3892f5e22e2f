"""Batched symmetric tridiagonal (Thomas) solver.

Counterpart of `hipgp_tpu/ops/tridiag.py`: the same forward-elimination and
back-substitution recurrences, row by row, batched over the trailing axes.
"""
from __future__ import annotations

import torch

__all__ = ["tridiagonal_solve"]


def tridiagonal_solve(d: torch.Tensor, c: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b for symmetric tridiagonal A.

    d: (N, ...) main diagonal; c: (N-1, ...) off-diagonal (above and below);
    b: (N, ...) right-hand side(s).  Returns x of shape (N, ...); N >= 1.
    """
    n = d.shape[0]
    if n == 1:
        return b / d
    # forward elimination: p_k = d_k - c_{k-1}^2 / p_{k-1},
    #                      y_k = (b_k - c_{k-1} y_{k-1}) / p_k
    ps = [d[0]]
    ys = [b[0] / d[0]]
    for k in range(1, n):
        pk = d[k] - c[k - 1] * (c[k - 1] / ps[-1])
        ys.append((b[k] - c[k - 1] * ys[-1]) / pk)
        ps.append(pk)
    # back substitution: x_k = y_k - (c_k / p_k) x_{k+1}
    xs = [ys[-1]]
    for k in range(n - 2, -1, -1):
        xs.append(ys[k] - (c[k] / ps[k]) * xs[-1])
    return torch.stack(xs[::-1])
