"""Derivative-observation cross-covariances.

Counterpart of `hipgp_tpu/kernels/derivatives.py`: the closed forms of the
1-D squared-exponential, and generic derivative cross-covariances of any
scalar kernel by ``torch.func.grad`` and ``torch.func.vmap`` (where the JAX
package uses ``jax.grad`` and ``jax.vmap``).

Conventions (x: derivative-observation inputs, y: function inputs):
  k(x, y)               Cov(f(x),  f(y))
  kprime(x, y)          Cov(f'(x), f(y))   = d/dx k(x, y)
  kprime_double(x, y)   Cov(f'(x), f'(y))  = d^2/dx dy k(x, y)
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.func import grad, vmap

__all__ = ["sqexp_k", "sqexp_kprime", "sqexp_kprime_double", "sqexp_k_diag",
           "sqexp_kprime_double_diag", "grad_cross_cov", "grad_grad_cov"]


def sqexp_k(x: torch.Tensor, y: torch.Tensor, sig2, ell) -> torch.Tensor:
    """1-D SqExp Gram: x (N,), y (M,) -> (N, M)."""
    diff = x[:, None] - y[None, :]
    return sig2 * torch.exp(-0.5 * diff ** 2 / ell ** 2)


def sqexp_kprime(x: torch.Tensor, y: torch.Tensor, sig2, ell) -> torch.Tensor:
    """Cov(f'(x), f(y)) = -(x - y)/ell^2 k(x, y)."""
    diff = x[:, None] - y[None, :]
    return -diff / ell ** 2 * sqexp_k(x, y, sig2, ell)


def sqexp_kprime_double(x: torch.Tensor, y: torch.Tensor, sig2, ell) -> torch.Tensor:
    """Cov(f'(x), f'(y)) = k(x, y)/ell^2 (1 - (x - y)^2/ell^2)."""
    diff = x[:, None] - y[None, :]
    ell2 = ell ** 2
    return sqexp_k(x, y, sig2, ell) / ell2 * (1.0 - diff ** 2 / ell2)


def sqexp_k_diag(x: torch.Tensor, sig2, ell) -> torch.Tensor:
    return sig2 * torch.ones_like(x)


def sqexp_kprime_double_diag(x: torch.Tensor, sig2, ell) -> torch.Tensor:
    return (sig2 / ell ** 2) * torch.ones_like(x)


def grad_cross_cov(kscalar: Callable, x: torch.Tensor, y: torch.Tensor, params):
    """Cov(f'(x_i), f(y_j)) = d/dx kscalar(x, y) for a scalar kernel
    ``kscalar(x, y, params) -> 0-dim tensor`` on 1-D inputs; (N, M)."""
    dk = grad(kscalar, argnums=0)
    return vmap(lambda xi: vmap(lambda yj: dk(xi, yj, params))(y))(x)


def grad_grad_cov(kscalar: Callable, x: torch.Tensor, y: torch.Tensor, params):
    """Cov(f'(x_i), f'(y_j)) = d^2/dx dy kscalar(x, y); (N, M)."""
    ddk = grad(grad(kscalar, argnums=0), argnums=1)
    return vmap(lambda xi: vmap(lambda yj: ddk(xi, yj, params))(y))(x)
