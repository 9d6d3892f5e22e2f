"""Batched preconditioned conjugate gradients over matrix-free SPD operators.

Counterpart of `hipgp_tpu/ops/cg.py`:

* ``pcg``       — early exit once every row has ||r||_2 < tol (one host
                  check per iteration), or after ``maxiter`` iterations;
* ``pcg_scan``  — a fixed number of iterations;
* ``pcg_trace`` — a fixed number of iterations, collecting ||r||_2 and a
                  user metric of every iterate on the device (the CG-vs-PCG
                  convergence study of paper section 5.1).

Same update order and zero-guards as the JAX package; the start is x0 = 0,
or the given ``x0`` with r = b - A x0.  Vectors live on the last axis;
leading batch dims are kept.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

__all__ = ["pcg", "pcg_result", "pcg_scan", "pcg_trace", "PCGResult"]

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


def _start(matvec: MatVec, b: torch.Tensor, x0: Optional[torch.Tensor]):
    """(x, r) at the start: (0, b), or (x0, b - A x0)."""
    if x0 is None:
        return torch.zeros_like(b), b
    return x0, b - matvec(x0)


def _fixed_iters(matvec: MatVec, b: torch.Tensor, precond: Optional[MatVec],
                 num_iters: int, x0: Optional[torch.Tensor], each=None):
    """``num_iters`` PCG iterations from :func:`_start`; ``each(x, r)``, if
    given, runs after every iteration.  Returns x."""
    if precond is None:
        precond = lambda r: r
    x, r = _start(matvec, b, x0)
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
        if each is not None:
            each(x, r)
    return x


def pcg(matvec: MatVec, b: torch.Tensor, precond: Optional[MatVec] = None,
        maxiter: int = 20, tol: float = 1e-10,
        x0: Optional[torch.Tensor] = None,
        dot_fn: Optional[Callable] = None) -> torch.Tensor:
    """Solve A x = b with (preconditioned) CG; returns x with b's shape."""
    return pcg_result(matvec, b, precond, maxiter, tol, x0, dot_fn).x


def pcg_result(matvec: MatVec, b: torch.Tensor,
               precond: Optional[MatVec] = None, maxiter: int = 20,
               tol: float = 1e-10, x0: Optional[torch.Tensor] = None,
               dot_fn: Optional[Callable] = None) -> PCGResult:
    """Like :func:`pcg` but also reports iteration count and residual norms.

    ``dot_fn(a, b) -> (batch,)`` replaces the inner product (a sum over the
    last axis): for operands split over ranks, where it must also sum over
    them (`parallel.fft_sharded`); it then takes ||r||^2 and r.z of an
    iteration as one call on the two pairs stacked (one collective)."""
    dot = _dot if dot_fn is None else dot_fn
    if precond is None:
        precond = lambda r: r
    if dot_fn is None:
        rr_rz = lambda r, z: (_dot(r, r), _dot(r, z))
    else:
        rr_rz = lambda r, z: tuple(dot_fn(torch.stack([r, r]), torch.stack([r, z])))
    x, r = _start(matvec, b, x0)
    z = precond(r)
    p = z
    rr, rz = rr_rz(r, z)
    tol_sq = torch.as_tensor(tol, dtype=b.dtype) ** 2
    k = 0
    while k < maxiter and bool(torch.any(rr >= tol_sq)):
        Ap = matvec(p)
        pAp = dot(p, Ap)
        safe, alpha = _guarded_steps(rz, pAp)
        x = x + alpha[..., None] * p
        r = r - alpha[..., None] * Ap
        z = precond(r)
        rr, rz_new = rr_rz(r, z)
        p = z + _beta(safe, rz_new, rz)[..., None] * p
        rz = rz_new
        k += 1
    return PCGResult(x=x, iters=k, resnorm=torch.sqrt(rr))


def pcg_scan(matvec: MatVec, b: torch.Tensor,
             precond: Optional[MatVec] = None, num_iters: int = 20,
             x0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fixed-iteration CG (no residual-norm reduction, no host check)."""
    return _fixed_iters(matvec, b, precond, num_iters, x0)


def pcg_trace(matvec: MatVec, b: torch.Tensor,
              precond: Optional[MatVec] = None, num_iters: int = 20,
              metric_fn: Optional[Callable[[torch.Tensor], object]] = None,
              x0: Optional[torch.Tensor] = None):
    """Fixed-iteration CG collecting ``metric_fn(x_k)`` at every iteration.

    Returns ``(x, traces)``: ``traces["resnorm"]`` is ||r_k||_2, shape
    (num_iters, *batch); ``traces["metric"]`` (with ``metric_fn``) stacks the
    metric's values along a new leading axis, leaf by leaf where it returns a
    dict of tensors.  The per-iteration values stay on the device and are
    stacked once at the end (no host sync inside the loop)."""
    res, met = [], []

    def each(x, r):
        res.append(torch.sqrt(_dot(r, r)))
        if metric_fn is not None:
            met.append(metric_fn(x))

    x = _fixed_iters(matvec, b, precond, num_iters, x0, each)
    traces = {"resnorm": torch.stack(res) if res else
              torch.zeros((0,) + tuple(b.shape[:-1]), dtype=b.dtype, device=b.device)}
    if metric_fn is not None and met:
        traces["metric"] = ({k: torch.stack([m[k] for m in met]) for k in met[0]}
                            if isinstance(met[0], dict) else torch.stack(met))
    return x, traces
