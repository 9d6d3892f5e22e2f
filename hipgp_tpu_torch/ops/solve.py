"""Structured solves: K^{-1} B by PCG and the whitening kn = R^T K^{-1} v.

Counterpart of `hipgp_tpu/ops/solve.py` (`inv_matmul`, `whiten`,
`cholesky_whiten`, `spd_solve`, `spd_inverse`, the packed-planes 1-D solver `_planes_solver` /
`_rt_planes` and the fused 2-D solver `_mxu2d_solver` / `_rt_mxu2d`).  The
dispatch keeps the JAX package's order, with its backend test replaced by a
device test:

* on a CUDA device, in float32, on a 1-D grid whose embedding length the
  radix plan supports with at least 8 rows of data, the PCG state lives as
  packed complex planes and every apply and the R^T go through the radix
  kernels B-2, B-3 and B-4 (`ops/radix_fft.py`);
* on a CUDA device, in float32, on a 2-D grid whose embedded axes are all
  <= MXU2D_MAX_LEN, they go through kernel A (`ops/mxu2d.py`);
* on a CUDA device, in float32, on a 3-D grid whose embedded axes are all
  <= MXU2D_MAX_LEN (and > 1), the state is permuted once per solve so that
  the smallest embedded axis is the outer one, and they go through the
  outer-axis products and kernel B-5, or kernel B-6 (`ops/mxu3d.py`);
* everywhere else (the CPU, float64) the plain path runs: `cg.pcg` over
  `matmul_by_K` with the `matmul_by_Cinv` preconditioner, then
  `matmul_by_RT`.

The fused paths take the CG inner products from the applies' self-dots.
The 2-D kernel path is taken only while `bttb.USE_MXU2D_PCG` is set; off,
the 2-D float32 CUDA solve is the generic path (whose applies go through
kernel B-8 when `bttb.USE_PALLAS_TRANSFORM` is set), as in JAX.

``inv_matmul`` is differentiable in the right-hand side and the spectrum,
by implicit differentiation as `lax.custom_linear_solve(..., symmetric=True)`
does it: the forward runs the dispatched solver with no graph through its
iterations; the backward solves again, lambda = K^{-1} g with the same
solver, returns lambda for the right-hand side, and takes the spectrum's
cotangent as the VJP of `matmul_by_K(spec, x)` at -lambda with the solution
x held fixed (on the 1-D radix path that VJP is the radix apply's backward:
two B-2 forwards and ``radix_middle_wgrad``).  ``whiten``'s R^T is
differentiable on every path: the plain path by autograd, the 2-D kernel
path through kernel A's backward, the 1-D planes path through the radix
apply's backward and then, as in the JAX package, through
sqrt(`_planes_weights`) and `stage_order_weights`'s float64 plain chain to
``spec.ecolumn`` and min(``spec.eigs``), the 3-D kernel path through the
outer products and kernel B-5's backward.  The PCG's fused self-dot applies
are solver-internal and have no backward, as in JAX; the forward solve runs
them with no graph.  `bttb.USE_RADIX_FFT` (1-D) and `bttb.USE_MXU3D_PCG`
(3-D) off route those float32 CUDA solves to the plain path, as the JAX
package's switches do.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from . import bttb
from .bttb import (BTTBSpectrum, _full_weights, fp32_matmul, matmul_by_Cinv,
                   matmul_by_K, matmul_by_RT)
from .cg import _beta, _guarded_steps, pcg, pcg_scan
from .mxu2d import MXU2D_MAX_LEN, plans_ok, sandwich_apply, sandwich_apply_selfdot
from .mxu3d import best_perm, sandwich_apply_3d, sandwich_apply_3d_selfdot
from .radix_fft import (fused_circulant_apply_cropped,
                        fused_circulant_apply_cropped_selfdot, make_plan,
                        pack_rows, permute_weights, radix_supported,
                        row_multiple, stage_order_weights, unpack_rows)

__all__ = ["inv_matmul", "whiten", "gram_solve", "cholesky_whiten", "spd_solve",
           "spd_inverse", "cholesky_or_nan", "PCG_STATS"]

# solves and iterations run by the fused kernel-path PCG (the self-dot
# applies per solve are 1 + 2 * iterations)
PCG_STATS: Dict[str, int] = {"solves": 0, "iterations": 0}


def _planes_solver_ok(spec: BTTBSpectrum, dtype: torch.dtype,
                      device: torch.device) -> bool:
    """True when the packed planes-state PCG path applies: USE_RADIX_FFT, a
    1-D grid whose embedding length the radix plan supports, float32, on a
    CUDA device, with a crop boundary of at least 8 rows."""
    if len(spec.dims) != 1 or dtype != torch.float32 or not bttb.USE_RADIX_FFT:
        return False
    if torch.device(device).type != "cuda":
        return False
    L = spec.edims[0]
    if not radix_supported(L):
        return False
    return -(-spec.M // row_multiple(L)) >= 8


def _planes_weights(spec: BTTBSpectrum, plan) -> torch.Tensor:
    """Stage-order clamped circulant spectrum for the planes path, without
    the 1/L fold: the radix forward stages of the stored embedded column
    (no natural-order spectrum), clamped to min(spec.eigs), which equals the
    build-time floor whenever an eigenvalue was clamped and changes nothing
    otherwise; else the permuted natural full weights."""
    L = spec.edims[0]
    if spec.ecolumn is not None:
        w = stage_order_weights(spec.ecolumn, plan)
        return torch.maximum(w, torch.min(spec.eigs))
    return permute_weights(_full_weights(spec.eigs, L), plan) * L


def _mxu2d_solver_ok(spec: BTTBSpectrum, dtype: torch.dtype,
                     device: torch.device) -> bool:
    """True when the fused 2-D sandwich PCG path applies: USE_MXU2D_PCG, a
    2-D grid whose embedded axes are all <= MXU2D_MAX_LEN and have a kernel-A
    plan, float32, on a CUDA device."""
    if len(spec.dims) != 2 or dtype != torch.float32 or not bttb.USE_MXU2D_PCG:
        return False
    if torch.device(device).type != "cuda":
        return False
    if min(spec.edims) <= 1:
        return False
    return max(spec.edims) <= MXU2D_MAX_LEN and plans_ok(spec.edims)


def _mxu3d_solver_ok(spec: BTTBSpectrum, dtype: torch.dtype,
                     device: torch.device) -> bool:
    """True when the fused 3-D sandwich PCG path applies: USE_MXU3D_PCG, a
    3-D grid whose embedded axes are all > 1, <= MXU2D_MAX_LEN and have
    kernel A's and B-5's plans, float32, on a CUDA device."""
    if len(spec.dims) != 3 or dtype != torch.float32 or not bttb.USE_MXU3D_PCG:
        return False
    if torch.device(device).type != "cuda":
        return False
    if min(spec.edims) <= 1:
        return False
    return max(spec.edims) <= MXU2D_MAX_LEN and plans_ok(spec.edims, wp=True)


def _inv_perm(perm):
    inv = [0] * len(perm)
    for i, p in enumerate(perm):
        inv[p] = i
    return tuple(inv)


def _fused_sandwich_pcg(apply_dot, s0, wK, wC, num_iters: int, tol: float,
                        fixed_iters: bool, batch_dims: int = 1):
    """PCG over (*batch, *grid) sample volumes with fused self-dot applies
    (``apply_dot(s, w) -> (y, dots)``, dots shaped like the batch): the
    ``batch_dims`` leading axes index the systems.  Same update order and
    guards as `cg.pcg` / `cg.pcg_scan`."""
    nd = s0.ndim - batch_dims
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


def _mxu3d_permuted(spec: BTTBSpectrum, w: torch.Tensor):
    """(perm, inverse perm, permuted dims, permuted edims, w permuted and
    contiguous) for the 3-D kernel path."""
    perm = best_perm(spec.edims)
    pdims = tuple(spec.dims[a] for a in perm)
    pedims = tuple(spec.edims[a] for a in perm)
    return perm, _inv_perm(perm), pdims, pedims, w.permute(perm).contiguous()


def _mxu3d_solver(spec: BTTBSpectrum, b: torch.Tensor, maxiter: int,
                  tol: float, fixed_iters: bool) -> torch.Tensor:
    """K^{-1} b for (..., M) rows through the fused 3-D PCG.  The state is
    permuted into the kernel order once per solve, never per apply."""
    dims = spec.dims
    perm, inv, pdims, pedims, wK = _mxu3d_permuted(
        spec, _full_weights(spec.eigs, spec.edims[-1]))
    wC = 1.0 / wK
    batch = b.shape[:-1]
    s0 = b.reshape((-1,) + dims).permute((0,) + tuple(a + 1 for a in perm))

    def apply_dot(s, w):
        return sandwich_apply_3d_selfdot(s, w, pdims, pedims)

    x = _fused_sandwich_pcg(apply_dot, s0.contiguous(), wK, wC, maxiter, tol,
                            fixed_iters)
    x = x.permute((0,) + tuple(a + 1 for a in inv))
    return x.reshape(batch + (spec.M,))


def _rt_mxu3d(spec: BTTBSpectrum, d: torch.Tensor) -> torch.Tensor:
    """R^T @ d through the 3-D sandwich: (..., M) -> (..., M'), the same
    operator as `matmul_by_RT`; the kernel-order permutation is undone on the
    expanded output, so the whitened layout is the plain path's."""
    perm, inv, pdims, pedims, w = _mxu3d_permuted(
        spec, torch.sqrt(_full_weights(spec.eigs, spec.edims[-1])))
    batch = d.shape[:-1]
    x = d.reshape((-1,) + spec.dims).permute((0,) + tuple(a + 1 for a in perm))
    y = sandwich_apply_3d(x.contiguous(), w, pdims, pedims, out_expanded=True)
    y = y.permute((0,) + tuple(a + 1 for a in inv))
    return y.reshape(batch + (spec.Mprime,))


def _planes_pcg(s0, dK, dC, plan, rows: int, mask, num_iters: int, tol: float,
                fixed_iters: bool):
    """PCG over packed (2, V, Mp) planes with both CG inner products taken
    from the cropped self-dot applies (`_planes_pcg_fused` and, without
    ``fixed_iters``, `_planes_pcg_fused_while` of the JAX package).  With
    ``mask`` the state tails stay zero, so the self-dots, whose partner is
    the apply's own zero-tailed input, need no mask: only the apply output
    does."""

    def apply_dot(s, d_perm):
        yr, yi, dr, di = fused_circulant_apply_cropped_selfdot(
            s[0], s[1], d_perm, plan, rows, rows)
        y = torch.stack([yr, yi])
        if mask is not None:
            y = y * mask
        return y, torch.stack([dr, di])

    return _fused_sandwich_pcg(apply_dot, s0, dK, dC, num_iters, tol,
                               fixed_iters, batch_dims=2)


def _planes_layout(spec: BTTBSpectrum, b: torch.Tensor):
    """(..., M) rows -> (rows, Mp, nb, planes): ``planes`` are the nb rows
    packed by `pack_rows` into (V, Mp) real and imaginary planes, with M
    padded to the plan's next B*C row multiple Mp = rows * B*C."""
    BC = row_multiple(spec.edims[0])
    rows = -(-spec.M // BC)
    Mp = rows * BC
    flat = b.reshape(-1, spec.M)
    return rows, Mp, flat.shape[0], pack_rows(flat, Mp)


def _planes_solver(spec: BTTBSpectrum, b: torch.Tensor, maxiter: int,
                   tol: float, fixed_iters: bool) -> torch.Tensor:
    """K^{-1} b for (..., M) rows through the packed planes PCG of the 1-D
    radix path.  The state lives as (2, V, Mp) planes (row 2v is the real
    part of plane v, row 2v+1 its imaginary part; Mp = M padded to the
    plan's B*C row multiple) and every apply runs the cropped radix kernels,
    so the embedded padding region is never formed: one deinterleave at
    entry and one interleave at exit per solve."""
    M, L = spec.M, spec.edims[0]
    plan = make_plan(L, b.dtype, b.device)
    w = _planes_weights(spec, plan)
    dK = (w / L).contiguous()
    dC = (1.0 / (w * L)).contiguous()
    rows, Mp, nb, planes = _planes_layout(spec, b)
    mask = (torch.arange(Mp, device=b.device) < M).to(b.dtype) if Mp != M else None
    x = _planes_pcg(torch.stack(planes), dK, dC, plan, rows, mask, maxiter, tol,
                    fixed_iters)
    return unpack_rows(x[0], x[1], nb)[:, :M].reshape(b.shape[:-1] + (M,))


def _rt_planes(spec: BTTBSpectrum, d: torch.Tensor) -> torch.Tensor:
    """R^T @ d through the cropped planes apply: (..., M) -> (..., M'), the
    same operator as `matmul_by_RT` (sqrt weights, cropped input, full
    expanded output)."""
    L = spec.edims[0]
    plan = make_plan(L, d.dtype, d.device)
    dRT = (torch.sqrt(_planes_weights(spec, plan)) / L).contiguous()
    rows, Mp, nb, planes = _planes_layout(spec, d)
    yr, yi = fused_circulant_apply_cropped(*planes, dRT, plan, rows, plan.A)
    return unpack_rows(yr, yi, nb).reshape(d.shape[:-1] + (spec.Mprime,))


def _solve(spec: BTTBSpectrum, rhs: torch.Tensor, maxiter: int, tol: float,
           do_precond: bool, fixed_iters: bool) -> torch.Tensor:
    """K^{-1} @ rhs through the dispatched solver, with no graph."""
    if do_precond and _planes_solver_ok(spec, rhs.dtype, rhs.device):
        return _planes_solver(spec, rhs, maxiter, tol, fixed_iters)
    if do_precond and _mxu2d_solver_ok(spec, rhs.dtype, rhs.device):
        return _mxu2d_solver(spec, rhs, maxiter, tol, fixed_iters)
    if do_precond and _mxu3d_solver_ok(spec, rhs.dtype, rhs.device):
        return _mxu3d_solver(spec, rhs, maxiter, tol, fixed_iters)
    matvec = lambda v: matmul_by_K(spec, v)
    precond = (lambda v: matmul_by_Cinv(spec, v)) if do_precond else None
    if fixed_iters:
        return pcg_scan(matvec, rhs, precond=precond, num_iters=maxiter)
    return pcg(matvec, rhs, precond=precond, maxiter=maxiter, tol=tol)


def _detached(spec: BTTBSpectrum, eigs: torch.Tensor) -> BTTBSpectrum:
    """``spec`` with ``eigs`` and no tensor that carries a graph."""
    det = lambda t: None if t is None else t.detach()
    return dataclasses.replace(spec, column=det(spec.column), eigs=eigs,
                               ecolumn=det(spec.ecolumn))


class _InvMatmul(torch.autograd.Function):
    """K^{-1} rhs with the implicit gradient of a symmetric linear solve."""

    @staticmethod
    def forward(ctx, rhs, eigs, spec, opts):
        x = _solve(spec, rhs, *opts)
        ctx.spec, ctx.opts = spec, opts
        ctx.save_for_backward(x)
        return x

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        lam = _solve(ctx.spec, g.contiguous(), *ctx.opts)
        g_eigs = None
        if ctx.needs_input_grad[1]:
            eigs = ctx.spec.eigs.detach().requires_grad_()
            with torch.enable_grad(), fp32_matmul():
                y = matmul_by_K(_detached(ctx.spec, eigs), x.detach())
                # the VJP at -lam as the gradient of a scalar: passing -lam as
                # grad_outputs would make autograd import sympy on first use
                # (~5 s in a fresh process)
                (g_eigs,) = torch.autograd.grad(-torch.sum(y * lam), eigs)
        return (lam if ctx.needs_input_grad[0] else None), g_eigs, None, None


def inv_matmul(spec: BTTBSpectrum, rhs: torch.Tensor, *, maxiter: int = 20,
               tol: float = 1e-8, do_precond: bool = True,
               fixed_iters: bool = False) -> torch.Tensor:
    """K^{-1} @ rhs with rhs of shape (..., M), by PCG with the circulant
    preconditioner (plain CG with ``do_precond=False``); differentiable in
    rhs and ``spec.eigs`` (implicitly, see the module docstring)."""
    opts = (maxiter, tol, do_precond, fixed_iters)
    return _InvMatmul.apply(rhs, spec.eigs, _detached(spec, spec.eigs.detach()), opts)


def whiten(spec: BTTBSpectrum, Knm: torch.Tensor, *, maxiter: int = 20,
           tol: float = 1e-8, do_precond: bool = True,
           fixed_iters: bool = False) -> torch.Tensor:
    """kn = R^T K^{-1} Knm: (..., M) -> (..., M') whitened cross-covariances;
    differentiable in Knm and the spectrum (``spec.eigs``, and on the 1-D
    planes path ``spec.ecolumn``)."""
    d = inv_matmul(spec, Knm, maxiter=maxiter, tol=tol, do_precond=do_precond,
                   fixed_iters=fixed_iters)
    if _planes_solver_ok(spec, d.dtype, d.device):
        return _rt_planes(spec, d)
    if _mxu2d_solver_ok(spec, d.dtype, d.device):
        return _rt_mxu2d(spec, d)
    if _mxu3d_solver_ok(spec, d.dtype, d.device):
        return _rt_mxu3d(spec, d)
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


def cholesky_whiten(Kmm: torch.Tensor, Knm: torch.Tensor,
                    jitter: float = 0.0) -> torch.Tensor:
    """Dense-oracle whitening kn = L^{-1} Kmn with K = L L^T: Knm (..., M)
    -> (..., M); O(M^3)."""
    if jitter:
        Kmm = Kmm + jitter * torch.eye(Kmm.shape[-1], dtype=Kmm.dtype,
                                       device=Kmm.device)
    Lc = torch.linalg.cholesky(Kmm)
    sol = torch.linalg.solve_triangular(Lc, Knm.transpose(-1, -2), upper=False)
    return sol.transpose(-1, -2)


def cholesky_or_nan(A: torch.Tensor) -> torch.Tensor:
    """The lower Cholesky factor of A (leading batch dims allowed), NaN in
    every matrix of the batch whose factorisation fails, as XLA's Cholesky
    returns it (torch.linalg.cholesky raises instead); no host sync."""
    L, info = torch.linalg.cholesky_ex(A)
    failed = (info != 0)[..., None, None]
    if L.requires_grad:
        return L.masked_fill(failed, float("nan"))
    return L.masked_fill_(failed, float("nan"))


def spd_solve(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve A x = b for symmetric positive-definite A by Cholesky and two
    triangular solves; leading batch dims on A and b, and b one dim short of
    A for a single right-hand side.  A matrix that is not positive definite
    gives NaN (`cholesky_or_nan`).  Only the factor is allocated beside A
    (the dense full-batch solve keeps its M' x M' matrix and factor alive
    together, nothing more)."""
    squeeze = b.ndim == A.ndim - 1
    if squeeze:
        b = b[..., None]
    with bttb.fp32_matmul():
        L = cholesky_or_nan(A)
        # two triangular solves on L itself (torch.cholesky_solve works on a
        # column-major copy of the factor: a third M' x M' buffer on the card)
        y = torch.linalg.solve_triangular(L, b, upper=False)
        x = torch.linalg.solve_triangular(L.mT, y, upper=True)
    return x[..., 0] if squeeze else x


def spd_inverse(A: torch.Tensor) -> torch.Tensor:
    """Inverse of a symmetric positive-definite matrix (batched) by Cholesky."""
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    return spd_solve(A, eye.expand(A.shape))
