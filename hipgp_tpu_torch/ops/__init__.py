"""Structured linear algebra: the BTTB/circulant operator, batched PCG, the
whitening solve, and kernel A (the cropped 2-D sandwich)."""
from .bttb import (
    BTTBSpectrum,
    circulant_embed,
    dense_gram,
    embedded_dims,
    expanded_dims,
    make_spectrum,
    matmul_by_Cinv,
    matmul_by_K,
    matmul_by_RT,
    next_fast_len,
    toeplitz_column,
)
from .cg import PCGResult, pcg, pcg_result, pcg_scan
from .mxu2d import sandwich_apply, sandwich_apply_selfdot
from .solve import gram_solve, inv_matmul, whiten

__all__ = [
    "BTTBSpectrum",
    "circulant_embed",
    "dense_gram",
    "embedded_dims",
    "expanded_dims",
    "make_spectrum",
    "matmul_by_Cinv",
    "matmul_by_K",
    "matmul_by_RT",
    "next_fast_len",
    "toeplitz_column",
    "PCGResult",
    "pcg",
    "pcg_result",
    "pcg_scan",
    "sandwich_apply",
    "sandwich_apply_selfdot",
    "gram_solve",
    "inv_matmul",
    "whiten",
]
