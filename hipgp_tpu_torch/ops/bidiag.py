"""Golub-Kahan bidiagonalization with full reorthogonalization.

Counterpart of `hipgp_tpu/ops/bidiag.py`, an alternative whitening solver
kept as API.  Given matvecs for A (N -> M) and A* (M -> N) with K = A* A, it
builds column-orthonormal U (M x J), V (N x J) and an upper bidiagonal
B = U* A V (diagonal ``alphas``, superdiagonal ``betas``; the v-started
variant); :func:`bidiag_solve` forms c = V (B B^T)^{-1} (alpha_1 ||b|| e_1)
through :func:`~.tridiag.tridiagonal_solve` (B B^T is symmetric tridiagonal:
diagonal alpha_k^2 + beta_k^2, off-diagonal alpha_{k+1} beta_k).

The JAX package's semantics are kept: a fixed J = ``num_iters``, exactly one
full reorthogonalization pass per vector against the filled rows (a 0/1
mask over all J rows), the ``alpha > 0`` and ``beta > 0`` guards, and V's
last row left unwritten at k = J - 1.  Batched over the trailing axis of
``b``.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .tridiag import tridiagonal_solve

__all__ = ["golub_kahan_bidiag", "bidiag_solve", "BidiagFactors"]

MatVec = Callable[[torch.Tensor], torch.Tensor]


class BidiagFactors(NamedTuple):
    U: torch.Tensor       # (J, M, bsz)
    V: torch.Tensor       # (J, N, bsz)
    alphas: torch.Tensor  # (J, bsz)
    betas: torch.Tensor   # (J, bsz)


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(x * x, dim=0))


def _reorth(basis: torch.Tensor, mask: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """w - Q (Q^T w) over the rows of ``basis`` (J, dim, bsz) that ``mask``
    (J,) selects."""
    coeffs = torch.einsum("jdb,db->jb", basis, w) * mask[:, None]
    return w - torch.einsum("jdb,jb->db", basis, coeffs)


def _guarded(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x > 0, x, torch.ones_like(x))


def golub_kahan_bidiag(A_matvec: MatVec, Astar_matvec: MatVec, b: torch.Tensor,
                       num_iters: int) -> BidiagFactors:
    """J = ``num_iters`` Golub-Kahan steps started from v_1 = b / ||b||."""
    N, bsz = b.shape
    M = A_matvec(b).shape[0]
    J, dt, dev = num_iters, b.dtype, b.device
    v = b / _norm(b)[None, :]
    U = torch.zeros((J, M, bsz), dtype=dt, device=dev)
    V = torch.zeros((J, N, bsz), dtype=dt, device=dev)
    V[0] = v
    alphas = torch.zeros((J, bsz), dtype=dt, device=dev)
    betas = torch.zeros((J, bsz), dtype=dt, device=dev)
    u_prev = torch.zeros((M, bsz), dtype=dt, device=dev)
    beta_prev = torch.zeros((bsz,), dtype=dt, device=dev)
    rows = torch.arange(J, device=dev)
    for k in range(J):
        u = A_matvec(v) - beta_prev[None, :] * u_prev
        u = _reorth(U, (rows < k).to(dt), u)
        alpha = _norm(u)
        u = u / _guarded(alpha)[None, :]
        U[k] = u
        alphas[k] = alpha
        w = Astar_matvec(u) - alpha[None, :] * v
        w = _reorth(V, (rows <= k).to(dt), w)
        beta = _norm(w)
        v = w / _guarded(beta)[None, :]
        betas[k] = beta
        if k + 1 < J:
            V[k + 1] = v
        u_prev, beta_prev = u, beta
    return BidiagFactors(U=U, V=V, alphas=alphas, betas=betas)


def bidiag_solve(A_matvec: MatVec, Astar_matvec: MatVec, b: torch.Tensor,
                 num_iters: int) -> torch.Tensor:
    """Whitening-style solve c = V (B B^T)^{-1} alpha_1 ||b|| e_1;
    b: (N, bsz) -> c: (N, bsz)."""
    f = golub_kahan_bidiag(A_matvec, Astar_matvec, b, num_iters)
    diag = f.alphas ** 2 + f.betas ** 2            # (J, bsz)
    offdiag = f.alphas[1:] * f.betas[:-1]          # (J-1, bsz)
    rhs = torch.zeros_like(diag)
    rhs[0] = f.alphas[0] * _norm(b)
    d = tridiagonal_solve(diag, offdiag, rhs)      # (J, bsz)
    return torch.einsum("jnb,jb->nb", f.V, d)
