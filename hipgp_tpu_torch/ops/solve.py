"""Structured solves: K^{-1} B by PCG and the whitening kn = R^T K^{-1} v.

Counterpart of `hipgp_tpu/ops/solve.py` (`inv_matmul`, `whiten`, and the
fused 2-D solver `_mxu2d_solver` / `_rt_mxu2d`).  The dispatch keeps the JAX
package's shape: on a CUDA device, in float32, on a 2-D grid whose embedded
axes are all <= MXU2D_MAX_LEN, every PCG apply and every R^T goes through
kernel A (`ops/mxu2d.py`), with both CG inner products taken from the
applies' self-dots; everywhere else (the CPU, float64) the plain path runs:
`cg.pcg` over `matmul_by_K` with the `matmul_by_Cinv` preconditioner, then
`matmul_by_RT`.

Gradients through the solve are not ported yet: ``inv_matmul`` is a forward
solve only.
"""
from __future__ import annotations

from typing import Dict

import torch

from .bttb import (BTTBSpectrum, _full_weights, matmul_by_Cinv, matmul_by_K,
                   matmul_by_RT)
from .cg import _beta, _guarded_steps, pcg, pcg_scan
from .mxu2d import MXU2D_MAX_LEN, sandwich_apply, sandwich_apply_selfdot

__all__ = ["inv_matmul", "whiten", "gram_solve", "PCG_STATS"]

# solves and iterations run by the fused kernel-path PCG (the launch count of
# kernel A per solve is 1 + 2 * iterations)
PCG_STATS: Dict[str, int] = {"solves": 0, "iterations": 0}


def _mxu2d_solver_ok(spec: BTTBSpectrum, dtype: torch.dtype,
                     device: torch.device) -> bool:
    """True when the fused 2-D sandwich PCG path applies: a 2-D grid whose
    embedded axes are all <= MXU2D_MAX_LEN, float32, on a CUDA device."""
    if len(spec.dims) != 2 or dtype != torch.float32:
        return False
    if torch.device(device).type != "cuda":
        return False
    if min(spec.edims) <= 1:
        return False
    return max(spec.edims) <= MXU2D_MAX_LEN


def _fused_sandwich_pcg(apply_dot, s0, wK, wC, num_iters: int, tol: float,
                        fixed_iters: bool):
    """PCG over (B, *grid) sample volumes with fused self-dot applies
    (``apply_dot(s, w) -> (y, dots)``).  Same update order and guards as
    `cg.pcg` / `cg.pcg_scan`."""
    nd = s0.ndim - 1
    ax = lambda a: a.reshape(a.shape + (1,) * nd)
    red = tuple(range(-nd, 0))

    z, rz = apply_dot(s0, wC)
    x = torch.zeros_like(s0)
    r = s0
    p = z
    k = 0
    if not fixed_iters:
        rr = torch.sum(r * r, dim=red)
        tol_sq = torch.as_tensor(tol, dtype=s0.dtype) ** 2
    while k < num_iters and (fixed_iters or bool(torch.any(rr >= tol_sq))):
        Ap, pAp = apply_dot(p, wK)
        safe, alpha = _guarded_steps(rz, pAp)
        x = x + ax(alpha) * p
        r = r - ax(alpha) * Ap
        if not fixed_iters:
            rr = torch.sum(r * r, dim=red)
        z, rz_new = apply_dot(r, wC)
        p = z + ax(_beta(safe, rz_new, rz)) * p
        rz = rz_new
        k += 1
    PCG_STATS["solves"] += 1
    PCG_STATS["iterations"] += k
    return x


def _mxu2d_pcg(s0, wK, wC, dims, edims, num_iters: int, tol: float,
               fixed_iters: bool):
    """PCG over (B, d0, d1) sample planes with the cropped sandwich kernel
    and the CG inner products taken from the applies."""

    def apply_dot(s, w):
        return sandwich_apply_selfdot(s, w, dims, edims)

    return _fused_sandwich_pcg(apply_dot, s0, wK, wC, num_iters, tol,
                               fixed_iters)


def _mxu2d_solver(spec: BTTBSpectrum, b: torch.Tensor, maxiter: int,
                  tol: float, fixed_iters: bool) -> torch.Tensor:
    """K^{-1} b for (..., M) rows through the fused 2-D PCG."""
    dims, edims = spec.dims, spec.edims
    wK = _full_weights(spec.eigs, edims[-1]).contiguous()
    wC = 1.0 / wK
    batch = b.shape[:-1]
    s0 = b.reshape((-1,) + dims).contiguous()
    x = _mxu2d_pcg(s0, wK, wC, dims, edims, maxiter, tol, fixed_iters)
    return x.reshape(batch + (spec.M,))


def inv_matmul(spec: BTTBSpectrum, rhs: torch.Tensor, *, maxiter: int = 20,
               tol: float = 1e-8, fixed_iters: bool = False) -> torch.Tensor:
    """K^{-1} @ rhs with rhs of shape (..., M), by PCG with the circulant
    preconditioner.  Forward only: gradients through the solve are not
    ported yet."""
    if _mxu2d_solver_ok(spec, rhs.dtype, rhs.device):
        return _mxu2d_solver(spec, rhs, maxiter, tol, fixed_iters)
    matvec = lambda v: matmul_by_K(spec, v)
    precond = lambda v: matmul_by_Cinv(spec, v)
    if fixed_iters:
        return pcg_scan(matvec, rhs, precond=precond, num_iters=maxiter)
    return pcg(matvec, rhs, precond=precond, maxiter=maxiter, tol=tol)


def whiten(spec: BTTBSpectrum, Knm: torch.Tensor, *, maxiter: int = 20,
           tol: float = 1e-8, fixed_iters: bool = False) -> torch.Tensor:
    """kn = R^T K^{-1} Knm: (..., M) -> (..., M') whitened cross-covariances."""
    d = inv_matmul(spec, Knm, maxiter=maxiter, tol=tol, fixed_iters=fixed_iters)
    if _mxu2d_solver_ok(spec, d.dtype, d.device):
        return _rt_mxu2d(spec, d)
    return matmul_by_RT(spec, d)


def _rt_mxu2d(spec: BTTBSpectrum, d: torch.Tensor) -> torch.Tensor:
    """R^T @ d through the sandwich kernel: (..., M) -> (..., M'), the same
    operator as `matmul_by_RT` (sqrt weights, cropped input, full output)."""
    dims, edims = spec.dims, spec.edims
    w = torch.sqrt(_full_weights(spec.eigs, edims[-1])).contiguous()
    batch = d.shape[:-1]
    y = sandwich_apply(d.reshape((-1,) + dims).contiguous(), w, dims, edims,
                       out_expanded=True)
    return y.reshape(batch + (spec.Mprime,))


# the benchmark-facing alias: K^{-1/2} v in the expanded basis
gram_solve = whiten
