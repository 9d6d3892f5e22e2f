"""Gaussian KL divergences to the whitened prior N(0, I) (counterpart of
`hipgp_tpu/utils/stats.py`, the part the three variational families need:
diagonal, block-diagonal and dense covariances)."""
from __future__ import annotations

import torch

from ..ops.solve import cholesky_or_nan

__all__ = ["diag_kl_to_standard", "kl_to_standard", "block_kl_to_standard"]


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
