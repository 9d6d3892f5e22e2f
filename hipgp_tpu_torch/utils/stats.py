"""Gaussian KL divergence and density helpers (counterpart of
`hipgp_tpu/utils/stats.py`, the part the mean-field family needs)."""
from __future__ import annotations

import torch

__all__ = ["diag_kl_to_standard"]


def diag_kl_to_standard(m: torch.Tensor, S: torch.Tensor) -> torch.Tensor:
    """KL( N(m, diag(S)) || N(0, I) ).  m, S: (D, 1) or (D,)."""
    m = m.reshape(-1)
    S = S.reshape(-1)
    return 0.5 * (torch.sum(S) + torch.sum(m * m) - torch.sum(torch.log(S)) - m.shape[0])
