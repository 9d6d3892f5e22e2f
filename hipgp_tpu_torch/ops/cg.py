"""Batched preconditioned conjugate gradients over matrix-free SPD operators.

Counterpart of `hipgp_tpu/ops/cg.py`:

* ``pcg``      — early exit once every row has ||r||_2 < tol (one host
                 check per iteration), or after ``maxiter`` iterations;
* ``pcg_scan`` — a fixed number of iterations.

Same update order, zero-guards and implicit x0 = 0 start as the JAX package.
Vectors live on the last axis; leading batch dims are kept.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

__all__ = ["pcg", "pcg_result", "pcg_scan", "PCGResult"]

MatVec = Callable[[torch.Tensor], torch.Tensor]


class PCGResult(NamedTuple):
    x: torch.Tensor
    iters: int               # iterations actually run
    resnorm: torch.Tensor    # (...,) final ||r||_2 per batch element


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b, dim=-1)


def _guarded_steps(rz, pAp):
    """alpha = rz / pAp, zero where pAp == 0 (converged or degenerate rows)."""
    safe = torch.abs(pAp) > 0
    alpha = torch.where(safe, rz / torch.where(safe, pAp, torch.ones_like(pAp)),
                        torch.zeros_like(pAp))
    return safe, alpha


def _beta(safe, rz_new, rz):
    return torch.where(safe, rz_new / torch.where(rz != 0, rz, torch.ones_like(rz)),
                       torch.zeros_like(rz))


def pcg(matvec: MatVec, b: torch.Tensor, precond: Optional[MatVec] = None,
        maxiter: int = 20, tol: float = 1e-10) -> torch.Tensor:
    """Solve A x = b with (preconditioned) CG; returns x with b's shape."""
    return pcg_result(matvec, b, precond, maxiter, tol).x


def pcg_result(matvec: MatVec, b: torch.Tensor,
               precond: Optional[MatVec] = None, maxiter: int = 20,
               tol: float = 1e-10) -> PCGResult:
    """Like :func:`pcg` but also reports iteration count and residual norms."""
    if precond is None:
        precond = lambda r: r
    x = torch.zeros_like(b)
    r = b
    z = precond(r)
    p = z
    rz = _dot(r, z)
    rr = _dot(r, r)
    tol_sq = torch.as_tensor(tol, dtype=b.dtype) ** 2
    k = 0
    while k < maxiter and bool(torch.any(rr >= tol_sq)):
        Ap = matvec(p)
        pAp = _dot(p, Ap)
        safe, alpha = _guarded_steps(rz, pAp)
        x = x + alpha[..., None] * p
        r = r - alpha[..., None] * Ap
        rr = _dot(r, r)
        z = precond(r)
        rz_new = _dot(r, z)
        p = z + _beta(safe, rz_new, rz)[..., None] * p
        rz = rz_new
        k += 1
    return PCGResult(x=x, iters=k, resnorm=torch.sqrt(rr))


def pcg_scan(matvec: MatVec, b: torch.Tensor,
             precond: Optional[MatVec] = None,
             num_iters: int = 20) -> torch.Tensor:
    """Fixed-iteration CG (no residual-norm reduction, no host check)."""
    if precond is None:
        precond = lambda r: r
    x = torch.zeros_like(b)
    r = b
    z = precond(r)
    p = z
    rz = _dot(r, z)
    for _ in range(num_iters):
        Ap = matvec(p)
        pAp = _dot(p, Ap)
        safe, alpha = _guarded_steps(rz, pAp)
        x = x + alpha[..., None] * p
        r = r - alpha[..., None] * Ap
        z = precond(r)
        rz_new = _dot(r, z)
        p = z + _beta(safe, rz_new, rz)[..., None] * p
        rz = rz_new
    return x
