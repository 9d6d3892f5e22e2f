"""Gaussian KL divergences and density helpers (counterpart of
`hipgp_tpu/utils/stats.py`): the KL to the whitened prior N(0, I) that the
three variational families need (diagonal, block-diagonal and dense
covariances), the KL between two Gaussians given Cholesky factors, and the
normal log-density and CDF, the dense KL between two Gaussians that the
unwhitened SVGP needs, and the gamma log-density helpers of its lengthscale
prior."""
from __future__ import annotations

import math

import torch

from ..ops.bttb import fp32_matmul
from ..ops.solve import cholesky_or_nan, spd_solve

__all__ = ["diag_kl_to_standard", "kl_to_standard", "block_kl_to_standard",
           "kl_mvn", "kl_mvn_chol", "normal_logpdf", "normal_cdf", "gamma_lnpdf",
           "gamma_lnpdf_lnx", "gamma_moments", "gamma_params"]

LN2PI = math.log(2.0 * math.pi)


def diag_kl_to_standard(m: torch.Tensor, S: torch.Tensor) -> torch.Tensor:
    """KL( N(m, diag(S)) || N(0, I) ).  m, S: (D, 1) or (D,)."""
    m = m.reshape(-1)
    S = S.reshape(-1)
    return 0.5 * (torch.sum(S) + torch.sum(m * m) - torch.sum(torch.log(S)) - m.shape[0])


def _spd_logdet(S: torch.Tensor) -> torch.Tensor:
    """log det of an SPD matrix by Cholesky (NaN where S is not PD)."""
    return 2.0 * torch.sum(torch.log(torch.diagonal(cholesky_or_nan(S))))


def kl_to_standard(m: torch.Tensor, S: torch.Tensor) -> torch.Tensor:
    """KL( N(m, S) || N(0, I) ) for dense SPD S."""
    m = m.reshape(-1)
    return 0.5 * (torch.trace(S) + torch.sum(m * m) - _spd_logdet(S) - m.shape[0])


def block_kl_to_standard(m: torch.Tensor, blk_S: torch.Tensor,
                         chol_jitter: float = 1e-4) -> torch.Tensor:
    """KL( N(m, blockdiag(blk_S)) || N(0, I) ), blk_S (num_blocks, bs, bs);
    the log-determinant by a batched Cholesky of blk_S + chol_jitter I (the
    reference's jitter)."""
    nb, bs, _ = blk_S.shape
    eye = torch.eye(bs, dtype=blk_S.dtype, device=blk_S.device)
    chol = cholesky_or_nan(blk_S + chol_jitter * eye)
    lndet = 2.0 * torch.sum(torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)))
    trace = torch.sum(torch.diagonal(blk_S, dim1=-2, dim2=-1))
    m = m.reshape(-1)
    return 0.5 * (trace + torch.sum(m * m) - lndet - nb * bs)


def kl_mvn(m0: torch.Tensor, S0: torch.Tensor, m1: torch.Tensor,
           S1: torch.Tensor) -> torch.Tensor:
    """KL( N(m0, S0) || N(m1, S1) ) for dense SPD covariances, by Cholesky
    solves with S1 (full FP32 products)."""
    k = S0.shape[-1]
    with fp32_matmul():
        S1_inv_S0 = spd_solve(S1, S0)
        diff = (m1 - m0).reshape(-1, 1)
        quad = torch.sum(diff * spd_solve(S1, diff))
    return 0.5 * (torch.trace(S1_inv_S0) + quad - k + _spd_logdet(S1)
                  - _spd_logdet(S0))


def kl_mvn_chol(m0: torch.Tensor, cS0: torch.Tensor, m1: torch.Tensor,
                cS1: torch.Tensor) -> torch.Tensor:
    """KL( N(m0, S0) || N(m1, S1) ) given lower-triangular Cholesky factors
    cS0, cS1 of the covariances."""
    k = cS0.shape[-1]
    lndet0 = 2.0 * torch.sum(torch.log(torch.diagonal(cS0)))
    lndet1 = 2.0 * torch.sum(torch.log(torch.diagonal(cS1)))
    diff = (m1 - m0).reshape(-1, 1)
    quad = torch.sum(torch.linalg.solve_triangular(cS1, diff, upper=False) ** 2)
    tr = torch.linalg.solve_triangular(cS1, cS0, upper=False)
    return 0.5 * (lndet1 - lndet0 + quad + torch.sum(tr * tr) - k)


def normal_logpdf(y, loc, scale):
    log_scale = torch.log(scale) if isinstance(scale, torch.Tensor) else math.log(scale)
    return -0.5 * LN2PI - log_scale - 0.5 * ((y - loc) / scale) ** 2


def normal_cdf(x, loc, scale):
    return 0.5 * (1.0 + torch.erf((x - loc) / (scale * math.sqrt(2.0))))


def gamma_lnpdf(x, alpha, beta):
    """Unnormalized log Gamma(alpha, beta) density (shape, inverse scale)."""
    return (alpha + 1.0) * torch.log(x) - beta * x


def gamma_lnpdf_lnx(lnx, alpha, beta):
    """Unnormalized log Gamma density of exp(lnx) (log-space argument)."""
    return (alpha + 1.0) * lnx - beta * torch.exp(lnx)


def gamma_moments(alpha, beta):
    """(mean, variance) of Gamma(alpha, beta)."""
    return alpha / beta, alpha / beta ** 2


def gamma_params(mean, var):
    """(alpha, beta) of the Gamma with this mean and variance."""
    beta = mean / var
    alpha = mean * beta
    return alpha, beta
