"""Dense Toeplitz constructors and the general 1-D FFT Toeplitz matvec.

Counterpart of `hipgp_tpu/ops/toeplitz_dense.py`: dense (non-)symmetric
Toeplitz matrices from a first column c and first row r, one entry without
building the matrix, and T(c, r) @ v by a circulant embedding of length
n + m.
"""
from __future__ import annotations

import torch

__all__ = ["toeplitz", "sym_toeplitz", "toeplitz_getitem", "toeplitz_matmul",
           "sym_toeplitz_matmul"]


def toeplitz_getitem(c: torch.Tensor, r: torch.Tensor, i, j) -> torch.Tensor:
    """T[i, j] of the (c, r) Toeplitz matrix; i, j may be tensors."""
    d = torch.as_tensor(i, device=c.device) - torch.as_tensor(j, device=c.device)
    return torch.where(d >= 0, c[torch.abs(d)], r[torch.abs(d)])


def toeplitz(c: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Dense Toeplitz matrix from its first column c and first row r
    (c[0] == r[0])."""
    d = (torch.arange(c.shape[0], device=c.device)[:, None]
         - torch.arange(r.shape[0], device=c.device)[None, :])
    return torch.where(d >= 0, c[torch.clamp(d, min=0)], r[torch.clamp(-d, min=0)])


def sym_toeplitz(c: torch.Tensor) -> torch.Tensor:
    """Dense symmetric Toeplitz matrix from its first column."""
    return toeplitz(c, c)


def toeplitz_matmul(c: torch.Tensor, r: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """T(c, r) @ v by circulant FFT embedding; v: (..., m) -> (..., n).

    The n x m Toeplitz matrix sits in a circulant of length n + m whose
    first column is [c_0 .. c_{n-1}, 0, r_{m-1} .. r_1]."""
    n, m = c.shape[0], r.shape[0]
    L = n + m
    col = torch.cat([c, torch.zeros((1,), dtype=c.dtype, device=c.device),
                     torch.flip(r[1:], dims=(0,))])
    vpad = torch.nn.functional.pad(v, (0, L - m))
    out = torch.fft.irfft(torch.fft.rfft(vpad, dim=-1) * torch.fft.rfft(col), n=L, dim=-1)
    return out[..., :n]


def sym_toeplitz_matmul(c: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return toeplitz_matmul(c, c, v)
