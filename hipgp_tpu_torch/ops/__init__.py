"""Structured linear algebra: the BTTB/circulant operator, batched PCG (and
its traced form), the whitening solve, Golub-Kahan bidiagonalization, the
tridiagonal solve, dense Toeplitz helpers, kernel A (the cropped 2-D sandwich), the radix kernels
B-2 to B-4 (the packed 1-D circulant apply) and B-7 (its two-diagonal
middle), the 3-D sandwich kernels B-5 (weight planes) and B-6 (whole
sample), and B-8 (the full-plane 2-D sandwich)."""
from .bttb import (
    BTTBSpectrum,
    bttb_matvec,
    circulant_embed,
    dense_gram,
    embedded_dims,
    expanded_dims,
    make_spectrum,
    matmul_by_Cinv,
    matmul_by_K,
    matmul_by_R,
    matmul_by_RT,
    next_fast_len,
    spectrum_from_column,
    toeplitz_column,
)
from .bidiag import BidiagFactors, bidiag_solve, golub_kahan_bidiag
from .cg import PCGResult, pcg, pcg_result, pcg_scan, pcg_trace
from .mxu2d import sandwich_apply, sandwich_apply_selfdot, sandwich_apply_wp
from .mxu3d import sandwich_apply_3d, sandwich_apply_3d_selfdot
from .pallas_transform import circulant_apply_2d
from .radix_fft import (fused_circulant_apply, fused_circulant_apply_cropped,
                        fused_circulant_apply_cropped_dual,
                        fused_circulant_apply_cropped_selfdot)
from .solve import (cholesky_or_nan, cholesky_whiten, gram_solve, inv_matmul,
                    spd_inverse, spd_solve, whiten)
from .toeplitz_dense import (sym_toeplitz, sym_toeplitz_matmul, toeplitz,
                             toeplitz_getitem, toeplitz_matmul)
from .tridiag import tridiagonal_solve

__all__ = [
    "BTTBSpectrum",
    "bttb_matvec",
    "circulant_embed",
    "dense_gram",
    "embedded_dims",
    "expanded_dims",
    "make_spectrum",
    "matmul_by_Cinv",
    "matmul_by_K",
    "matmul_by_R",
    "matmul_by_RT",
    "next_fast_len",
    "spectrum_from_column",
    "toeplitz_column",
    "PCGResult",
    "pcg",
    "pcg_result",
    "pcg_scan",
    "pcg_trace",
    "BidiagFactors",
    "bidiag_solve",
    "golub_kahan_bidiag",
    "tridiagonal_solve",
    "sym_toeplitz",
    "sym_toeplitz_matmul",
    "toeplitz",
    "toeplitz_getitem",
    "toeplitz_matmul",
    "sandwich_apply",
    "sandwich_apply_selfdot",
    "sandwich_apply_wp",
    "sandwich_apply_3d",
    "sandwich_apply_3d_selfdot",
    "circulant_apply_2d",
    "fused_circulant_apply",
    "fused_circulant_apply_cropped",
    "fused_circulant_apply_cropped_dual",
    "fused_circulant_apply_cropped_selfdot",
    "cholesky_whiten",
    "gram_solve",
    "inv_matmul",
    "spd_inverse",
    "spd_solve",
    "cholesky_or_nan",
    "whiten",
]
