"""Stationary covariance kernels on tensors.

Counterpart of `hipgp_tpu/kernels/stationary.py`: every kernel exposes
``__call__(x, y, params) -> (N, M)`` and ``diag(x, params) -> (N,)``, with
``params = (sig2, ell)`` passed at every call; ``ell`` may be a scalar or a
(D,) ARD vector.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

__all__ = ["Kernel", "SqExp", "Matern", "Gneiting", "kernel_from_name"]

Params = Tuple[torch.Tensor, torch.Tensor]


def _scaled_sqdist(x: torch.Tensor, y: torch.Tensor, ell) -> torch.Tensor:
    """sum_d ((x_d - y_d)/ell_d)^2, shape (N, M)."""
    diff = (x[:, None, :] - y[None, :, :]) / ell
    return torch.sum(diff * diff, dim=-1)


class Kernel:
    """Base class. Subclasses implement ``__call__``."""

    def __call__(self, x: torch.Tensor, y: torch.Tensor, params: Params) -> torch.Tensor:
        raise NotImplementedError

    def diag(self, x: torch.Tensor, params: Params) -> torch.Tensor:
        sig2, _ = params
        return sig2 * torch.ones(x.shape[0], dtype=x.dtype, device=x.device)


class SqExp(Kernel):
    """Squared-exponential kernel."""

    def __call__(self, x, y, params):
        sig2, ell = params
        return sig2 * torch.exp(-0.5 * _scaled_sqdist(x, y, ell))


class Matern(Kernel):
    """Matern kernel, nu in {0.5, 1.5, 2.5}; isotropic distance divided by a
    scalar ell after the norm."""

    def __init__(self, nu: float = 0.5):
        if nu not in (0.5, 1.5, 2.5):
            raise ValueError("nu must be one of 0.5, 1.5, 2.5")
        self.nu = nu

    def __call__(self, x, y, params):
        sig2, ell = params
        sqd = torch.sum((x[:, None, :] - y[None, :, :]) ** 2, dim=-1)
        d = torch.sqrt(torch.clamp(sqd, min=1e-36))
        if self.nu == 0.5:
            k = torch.exp(-d / ell)
        elif self.nu == 1.5:
            dp = math.sqrt(3.0) * d / ell
            k = (1.0 + dp) * torch.exp(-dp)
        else:
            dp = math.sqrt(5.0) * d / ell
            k = (1.0 + dp + (5.0 / 3.0) * sqd / (ell * ell)) * torch.exp(-dp)
        return sig2 * k


class Gneiting(Kernel):
    """Compactly supported Gneiting kernel: zero beyond scaled distance 1."""

    def __init__(self, alpha: float = 1.0):
        self.alpha = alpha

    def __call__(self, x, y, params):
        sig2, ell = params
        t = torch.sqrt(torch.clamp(_scaled_sqdist(x, y, ell), min=1e-36))
        cterms = (1.0 - t) * torch.cos(math.pi * t) + (1.0 / math.pi) * torch.sin(math.pi * t)
        cij = (1.0 + t ** self.alpha) ** (-3.0) * cterms
        cij = torch.where(t > 1.0, torch.zeros_like(cij), cij)
        return sig2 * cij


def kernel_from_name(name: str) -> Kernel:
    """Factory over the reference CLI names."""
    table = {
        "SqExp": SqExp,
        "sqexp": SqExp,
        "Mat12": lambda: Matern(0.5),
        "Mat32": lambda: Matern(1.5),
        "Mat52": lambda: Matern(2.5),
        "Gneiting": Gneiting,
    }
    if name not in table:
        raise ValueError(f"unknown kernel {name!r}; choose from {sorted(table)}")
    return table[name]()
