"""1-D GPs with derivative observations (functional API).

Counterpart of `hipgp_tpu/models/derivative_gp.py`: mixed derivative and
function observations of a 1-D SqExp GP: the exact joint-GP prediction
oracle, the inducing-point batch solve ('ziggy': the circulant whitening of
`ops/solve.py`; 'cholesky': the dense L^{-1}), posterior prediction in the
latent or derivative domain, and the ELBO used to learn (sig2, ell),
differentiable through the whitening's implicit gradient.  At the protocol's
M = 128 the embedding is below the radix kernels' gate, so the whitening
runs the generic PCG over the einsum chain on either device.

As in the JAX package (a deliberate fix of the reference), the derivative
branch of the ELBO uses the prior diagonal Cov(f'(x), f'(x)) = sig2/ell^2
(the reference passes sig2 for both branches,
`ziggy/exact_gp_1d_derivatives.py:305,338`).
"""
from __future__ import annotations

import math

import torch

from ..kernels import SqExp
from ..kernels.derivatives import (sqexp_k, sqexp_k_diag, sqexp_kprime,
                                   sqexp_kprime_double, sqexp_kprime_double_diag)
from ..ops import make_spectrum, spd_inverse, whiten
from ..ops.bttb import embedded_dims, fp32_matmul
from ..utils import stats

__all__ = ["exact_gp_prediction", "derivative_prediction",
           "latent_from_derivative_prediction", "svgp_batch_solve",
           "posterior_prediction", "compute_elbo"]


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _whiten_kn(u, Knm, sig2, ell, whitened_type, maxiter, tol, jitter):
    """kn (n, M'): whitened cross-covariances over the 1-D inducing grid u."""
    if whitened_type == "cholesky":
        Kuu = sqexp_k(u, u, sig2, ell) + jitter * _eye(u.shape[0], u)
        L = torch.linalg.cholesky(Kuu)
        return torch.linalg.solve_triangular(L, Knm.T, upper=False).T
    kern = SqExp()
    spec = make_spectrum([u], lambda a, b: kern(a, b, (sig2, ell)), jitter=jitter)
    return whiten(spec, Knm, maxiter=maxiter, tol=tol)


def exact_gp_prediction(xtest, xprime, yprime, xlatent, ylatent, sig2, ell,
                        derivative_obs_noise_std, obs_noise_std):
    """Dense joint-GP oracle over mixed observations: builds
    [[K'' + s'^2 I, K'], [K'^T, K + s^2 I]] and predicts the latent f at
    xtest.  Returns (mu (ntest,), sig2* (ntest,))."""
    ys, ktest_cols = [], []
    with fp32_matmul():
        if xprime is not None:
            Kpp = sqexp_kprime_double(xprime, xprime, sig2, ell)
            Kpp = Kpp + derivative_obs_noise_std ** 2 * _eye(xprime.shape[0], Kpp)
            ys.append(yprime.reshape(-1))
            ktest_cols.append(sqexp_kprime(xprime, xtest, sig2, ell).T)
        if xlatent is not None:
            Kll = sqexp_k(xlatent, xlatent, sig2, ell)
            Kll = Kll + obs_noise_std ** 2 * _eye(xlatent.shape[0], Kll)
            ys.append(ylatent.reshape(-1))
            ktest_cols.append(sqexp_k(xlatent, xtest, sig2, ell).T)
        if xprime is not None and xlatent is not None:
            corr = sqexp_kprime(xprime, xlatent, sig2, ell)
            K = torch.cat([torch.cat([Kpp, corr], dim=1),
                           torch.cat([corr.T, Kll], dim=1)], dim=0)
        elif xprime is not None:
            K = Kpp
        else:
            K = Kll
        ytot = torch.cat(ys)
        ktest = torch.cat(ktest_cols, dim=1)            # (ntest, ntotal)
        mu = ktest @ torch.linalg.solve(K, ytot)
        v = torch.linalg.solve(K, ktest.T)               # (ntotal, ntest)
    return mu, sig2 - torch.sum(ktest.T * v, dim=0)


def derivative_prediction(xprime, yprime, x, sig2, ell, jitter=1e-4):
    """Predict the latent f at x from derivative observations alone:
    (mu, cov)."""
    npr = xprime.shape[0]
    with fp32_matmul():
        Kpp = sqexp_kprime_double(xprime, xprime, sig2, ell) + jitter * _eye(npr, xprime)
        Kpx = sqexp_kprime(xprime, x, sig2, ell)        # (npr, n)
        Kxx = sqexp_k(x, x, sig2, ell)
        mu = Kpx.T @ torch.linalg.solve(Kpp, yprime.reshape(-1))
        cov = Kxx - Kpx.T @ torch.linalg.solve(Kpp, Kpx)
    return mu, cov


def latent_from_derivative_prediction(x, y, xprime, sig2, ell, jitter=1e-4):
    """Predict f' at xprime from function observations: (mu, cov)."""
    n = x.shape[0]
    with fp32_matmul():
        Kxx = sqexp_k(x, x, sig2, ell) + jitter * _eye(n, x)
        Kpx = sqexp_kprime(xprime, x, sig2, ell)        # (npr, n)
        Kpp = sqexp_kprime_double(xprime, xprime, sig2, ell)
        mu = Kpx @ torch.linalg.solve(Kxx, y.reshape(-1))
        cov = Kpp - Kpx @ torch.linalg.solve(Kxx, Kpx.T)
    return mu, cov


def svgp_batch_solve(u, xprime, yprime, x, y, sig2, ell, derivative_obs_noise_std,
                     obs_noise_std, whitened_type: str = "ziggy", maxiter: int = 20,
                     tol: float = 1e-8, jitter: float = 1e-4):
    """Closed-form optimal q over the 1-D inducing grid u from mixed
    observations: (m (M',), S (M', M'))."""
    M = u.shape[0]
    Mp = embedded_dims((M,))[0] if whitened_type == "ziggy" else M
    Lam = _eye(Mp, u)
    b = torch.zeros(Mp, dtype=u.dtype, device=u.device)
    parts = []
    if xprime is not None:
        parts.append((sqexp_kprime(xprime, u, sig2, ell), yprime, derivative_obs_noise_std))
    if x is not None:
        parts.append((sqexp_k(x, u, sig2, ell), y, obs_noise_std))
    with fp32_matmul():
        for Knm, yb, noise_std in parts:
            kn = _whiten_kn(u, Knm, sig2, ell, whitened_type, maxiter, tol, jitter)
            ivar = 1.0 / noise_std ** 2
            Lam = Lam + ivar * (kn.T @ kn)
            b = b + ivar * (kn.T @ yb.reshape(-1))
        S = spd_inverse(Lam)
        return S @ b, S


def posterior_prediction(x, u, m, S, sig2, ell, domain: str = "latent",
                         whitened_type: str = "ziggy", maxiter: int = 20,
                         tol: float = 1e-8, jitter: float = 1e-4):
    """Posterior (mu, sig2*) at x in the 'latent' (f) or 'prime' (f')
    domain."""
    if domain == "latent":
        Knm, Knn = sqexp_k(x, u, sig2, ell), sqexp_k_diag(x, sig2, ell)
    elif domain == "prime":
        Knm, Knn = sqexp_kprime(x, u, sig2, ell), sqexp_kprime_double_diag(x, sig2, ell)
    else:
        raise ValueError(f"unknown domain {domain!r}")
    with fp32_matmul():
        kn = _whiten_kn(u, Knm, sig2, ell, whitened_type, maxiter, tol, jitter)
        mu = kn @ m
        sig2_star = Knn - torch.sum(kn * kn, dim=-1) + torch.sum((kn @ S) * kn, dim=-1)
    return mu, sig2_star


def _an(m, S, Knn_diag, kn, y, noise_std):
    with fp32_matmul():
        knt_kn = torch.sum(kn * kn, dim=-1)
        knt_m = kn @ m
        knSkn = torch.sum((kn @ S) * kn, dim=-1)
    ns = torch.as_tensor(noise_std, dtype=kn.dtype, device=kn.device)
    mse = (knt_m - y.reshape(-1)) ** 2
    variance = Knn_diag - knt_kn + knSkn
    return (-0.5 / ns ** 2 * (mse + variance) - torch.log(ns)
            - 0.5 * math.log(2.0 * math.pi))


def compute_elbo(u, m, S, xprime, yprime, x, y, sig2, ell, derivative_obs_noise_std,
                 obs_noise_std, whitened_type: str = "ziggy", maxiter: int = 20,
                 tol: float = 1e-8, jitter: float = 1e-4):
    """ELBO over mixed observations, differentiable in (sig2, ell)."""
    elbo = 0.0
    if xprime is not None:
        Knm = sqexp_kprime(xprime, u, sig2, ell)
        kn = _whiten_kn(u, Knm, sig2, ell, whitened_type, maxiter, tol, jitter)
        Knn = sqexp_kprime_double_diag(xprime, sig2, ell)
        elbo = elbo + torch.sum(_an(m, S, Knn, kn, yprime, derivative_obs_noise_std))
    if x is not None:
        Knm = sqexp_k(x, u, sig2, ell)
        kn = _whiten_kn(u, Knm, sig2, ell, whitened_type, maxiter, tol, jitter)
        Knn = sqexp_k_diag(x, sig2, ell)
        elbo = elbo + torch.sum(_an(m, S, Knn, kn, y, obs_noise_std))
    return elbo - stats.kl_to_standard(m, S)
