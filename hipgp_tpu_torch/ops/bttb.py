"""Block-Toeplitz-Toeplitz-Block (BTTB) operator on a grid, in PyTorch.

Counterpart of `hipgp_tpu/ops/bttb.py`.  The Gram matrix of a stationary
kernel on a Cartesian product grid is (nested) symmetric BTTB.  Embedding its
defining column into a circulant tensor diagonalises it by the
multi-dimensional DFT, which gives O(M log M) matvecs and an exact whitening
square root R with K = R^T R, where R = C^{1/2}[:, :M] on the original grid.

The embedding lengths (`expanded_dims`, `next_fast_len`, `embedded_dims`)
are copied verbatim from the JAX package: they fix M' and the whitened
layout, so a state carried between the two packages means the same thing.
The matvecs run the real-Fourier-basis matmul chain whenever every embedded
axis is <= MATMUL_DFT_MAX_LEN (the same operator as the JAX package's), and
torch.fft otherwise.  All matvecs act on the last axis; leading batch
dimensions are kept.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "BTTBSpectrum",
    "toeplitz_column",
    "circulant_embed",
    "make_spectrum",
    "matmul_by_K",
    "matmul_by_RT",
    "matmul_by_Cinv",
    "expanded_dims",
    "embedded_dims",
    "next_fast_len",
    "dense_gram",
]

# Eigenvalue floor for the circulant embedding: keeps C, the preconditioner
# and the whitening square root positive definite in finite precision.
DEFAULT_EIG_FLOOR = 1e-6
# Embedded axes up to this length use the real-basis matmul transform (and
# the 2-D sandwich kernel); longer ones use the FFT.
MATMUL_DFT_MAX_LEN = 512


def expanded_dims(dims: Sequence[int]) -> Tuple[int, ...]:
    """Minimal circulant-embedding size per grid dim: m -> 2m-2 (m if m == 1)."""
    return tuple(2 * d - 2 if d > 1 else d for d in dims)


def _is_smooth(n: int) -> bool:
    for p in (2, 3, 5):
        while n % p == 0:
            n //= p
    return n == 1


def next_fast_len(n: int, multiple_of: int = 1) -> int:
    """Smallest L >= n whose prime factors are all in {2, 3, 5} (and which
    is a multiple of ``multiple_of``, itself required {2,3,5}-smooth)."""
    if multiple_of > 1:
        if not _is_smooth(multiple_of):
            raise ValueError(
                f"multiple_of={multiple_of} must be {{2,3,5}}-smooth (a "
                "non-smooth shard count would force a non-smooth FFT length)"
            )
        k = max(1, -(-n // multiple_of))
        while not _is_smooth(k):
            k += 1
        return k * multiple_of
    if n <= 1:
        return 1
    best = 1 << (n - 1).bit_length()  # next power of two always works
    p5 = 1
    while p5 < best:
        p3 = p5
        while p3 < best:
            p2 = p3
            while p2 < n:
                p2 *= 2
            if p2 < best:
                best = p2
            p3 *= 3
        p5 *= 5
    return best


def _next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def _next_pow2_mult(n: int, multiple_of: int) -> int:
    """Smallest L = r * 2^b >= n with multiple_of | L, where r is the odd
    part of multiple_of."""
    if multiple_of <= 1:
        return _next_pow2(n)
    if not _is_smooth(multiple_of):
        raise ValueError(f"multiple_of={multiple_of} must be {{2,3,5}}-smooth")
    r = multiple_of
    while r % 2 == 0:
        r //= 2
    L = r * _next_pow2(-(-n // r))
    while L % multiple_of:
        L *= 2
    return L


def embedded_dims(
    dims: Sequence[int], multiple_of: Optional[Sequence[int]] = None
) -> Tuple[int, ...]:
    """Embedding size per grid dim: the minimal {2,3,5}-smooth lengths when
    every axis is <= MATMUL_DFT_MAX_LEN, else every axis padded to the next
    power of two (times its ``multiple_of``)."""
    exp = expanded_dims(dims)
    mult = tuple(multiple_of) if multiple_of is not None else (1,) * len(exp)
    if len(mult) != len(exp):
        raise ValueError("multiple_of must have one entry per grid dim")
    smooth = [next_fast_len(e, m) for e, m in zip(exp, mult)]
    if all(s <= MATMUL_DFT_MAX_LEN for s in smooth):
        return tuple(smooth)
    return tuple(
        _next_pow2_mult(e, m) if e > 1 else e for e, m in zip(exp, mult)
    )


@dataclasses.dataclass(frozen=True)
class BTTBSpectrum:
    """The BTTB column and its clamped circulant spectrum.

    column:  (*dims) Gram column over the grid, jitter added at the origin.
    eigs:    real half-spectrum of the circulant embedding on the rfftn
             grid, clamped to the eigenvalue floor;
             shape (*edims[:-1], edims[-1] // 2 + 1).
    dims:    grid shape (m_1, ..., m_D).
    edims:   embedded shape.
    ecolumn: the full embedded (wrapped-lag) column, shape (*edims).
    """

    column: torch.Tensor
    eigs: torch.Tensor
    dims: Tuple[int, ...]
    edims: Tuple[int, ...]
    ecolumn: Optional[torch.Tensor] = None

    @property
    def M(self) -> int:
        return math.prod(self.dims)

    @property
    def Mprime(self) -> int:
        return math.prod(self.edims)

    @property
    def ndim(self) -> int:
        return len(self.dims)


def _grid_points(xgrids: Sequence[torch.Tensor]) -> torch.Tensor:
    mesh = torch.meshgrid(*xgrids, indexing="ij")
    return torch.stack([m.reshape(-1) for m in mesh], dim=-1)


def toeplitz_column(
    xgrids: Sequence[torch.Tensor],
    kernel_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    jitter: float = 1e-3,
) -> torch.Tensor:
    """First column of the Gram matrix of ``kernel_fn`` on the product grid,
    shape (*dims), with the nugget ``jitter`` added at the origin."""
    dims = tuple(len(g) for g in xgrids)
    pts = _grid_points(xgrids)
    col = kernel_fn(pts[:1], pts)[0].clone()
    col[0] += jitter
    return col.reshape(dims)


def circulant_embed(col: torch.Tensor) -> torch.Tensor:
    """Mirror-extend the Toeplitz column along every dim: (m,) -> (2m-2,)."""
    out = col
    for axis, m in enumerate(col.shape):
        if m <= 1:
            continue
        rev = torch.flip(out, dims=(axis,))
        idx = [slice(None)] * out.ndim
        idx[axis] = slice(1, -1)
        out = torch.cat([out, rev[tuple(idx)]], dim=axis)
    return out


def _real_even_half_spectrum(emb: torch.Tensor) -> torch.Tensor:
    """rfftn-layout half-spectrum of a real even-symmetric tensor (its DFT
    is real): the complex fftn's real part, sliced to the non-redundant half."""
    full = torch.fft.fftn(emb.to(torch.complex128 if emb.dtype == torch.float64
                                 else torch.complex64)).real
    L = emb.shape[-1]
    return full[..., : L // 2 + 1].contiguous()


def make_spectrum(
    xgrids: Sequence[torch.Tensor],
    kernel_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    jitter: float = 1e-3,
) -> BTTBSpectrum:
    """Column, circulant embedding and clamped spectrum in one call (the JAX
    package's default ``transform='fft'``, padded to fast lengths).

    Each embedded axis is padded from 2m-2 to `embedded_dims` by evaluating
    the kernel at wrapped lags tau_j = min(j, L - j) * h: for any
    L >= 2m - 2 that circulant has the exact BTTB Gram as its top-left
    M x M block, so the padding changes the whitened basis, never K.
    Requires uniformly spaced grids.
    """
    dims = tuple(len(g) for g in xgrids)
    edims = embedded_dims(dims)
    coords = []
    for g, L in zip(xgrids, edims):
        if L == 1:
            coords.append(g[:1])
            continue
        h = g[1] - g[0]
        j = torch.arange(L, dtype=g.dtype, device=g.device)
        coords.append(g[0] + torch.minimum(j, L - j) * h)
    pts = _grid_points(coords)
    c = kernel_fn(pts[:1], pts)[0].clone()
    c[0] += jitter
    emb = c.reshape(edims)
    eigs = torch.clamp(_real_even_half_spectrum(emb), min=DEFAULT_EIG_FLOOR)
    col_idx = tuple(slice(0, d) for d in dims)
    return BTTBSpectrum(column=emb[col_idx], eigs=eigs, dims=dims,
                        edims=edims, ecolumn=emb)


# ---------------------------------------------------------------------------
# Real-eigenbasis transform
#
# The circulant embedding is even-symmetric, so its spectrum is real and even
# and the operator diagonalises in the REAL Fourier basis
#   Q = [1/sqrt(L), sqrt(2/L) cos(2 pi k n / L), (-1)^n / sqrt(L),
#        sqrt(2/L) sin(2 pi k n / L)]
# with C = (Q_1 x ... x Q_D) diag(lam) (.)^T: one real (L, L) matmul per axis
# per direction, the same operator as the FFT formulation.
# ---------------------------------------------------------------------------

_BASIS_NP: Dict[int, np.ndarray] = {}
_BASIS: Dict[tuple, torch.Tensor] = {}


def _real_fourier_basis_np(L: int) -> np.ndarray:
    """Orthogonal (L, L) real Fourier basis Q in float64, columns ordered so
    column k pairs with frequency min(k, L-k) (the full DFT layout)."""
    if L not in _BASIS_NP:
        n = np.arange(L)[:, None]
        k = np.arange(L)[None, :]
        ang = 2.0 * np.pi * n * k / L
        Q = np.where(k <= L // 2, np.cos(ang), np.sin(2.0 * np.pi * n * (L - k) / L))
        scale = np.full(L, np.sqrt(2.0 / L))
        scale[0] = np.sqrt(1.0 / L)
        if L % 2 == 0:
            scale[L // 2] = np.sqrt(1.0 / L)
        _BASIS_NP[L] = Q * scale[None, :]
    return _BASIS_NP[L]


def _real_fourier_basis(L: int, dtype: torch.dtype,
                        device: torch.device) -> torch.Tensor:
    """:func:`_real_fourier_basis_np` as a tensor, cached per dtype and device."""
    key = (L, dtype, str(device))
    if key not in _BASIS:
        _BASIS[key] = torch.as_tensor(_real_fourier_basis_np(L)).to(
            device=device, dtype=dtype)
    return _BASIS[key]


_LETTERS = "abcdefghijklmnopqrstuvwxyz"


def _axis_contract(x: torch.Tensor, Q: torch.Tensor, axis: int) -> torch.Tensor:
    """Contract ``axis`` of x with Q[in, out], keeping the axis in place."""
    nd = x.ndim
    axis = axis % nd
    subs = _LETTERS[:nd]
    out = subs[:axis] + "Z" + subs[axis + 1:]
    return torch.einsum(f"{subs},{subs[axis]}Z->{out}", x, Q)


def _full_weights(half: torch.Tensor, L: int) -> torch.Tensor:
    """Expand an rfftn half-spectrum to the full spectrum by mirroring the
    last axis (the circulant spectrum is real and even)."""
    if L == 1 or half.shape[-1] == L:
        return half
    if L % 2 == 0:
        mirror = torch.flip(half[..., 1:-1], dims=(-1,))
    else:
        mirror = torch.flip(half[..., 1:], dims=(-1,))
    return torch.cat([half, mirror], dim=-1)


def _pad_to(x: torch.Tensor, dims, edims) -> torch.Tensor:
    pad = []
    for d, e in zip(reversed(dims), reversed(edims)):
        pad += [0, e - d]
    return torch.nn.functional.pad(x, pad)


def _apply_spectrum_matmul(spec: BTTBSpectrum, v: torch.Tensor,
                           weights_full: torch.Tensor, in_expanded: bool,
                           out_expanded: bool) -> torch.Tensor:
    """The einsum chain: analysis per axis (minor axis first), scale by the
    full spectrum, synthesis per axis."""
    dims, edims = spec.dims, spec.edims
    nd = len(dims)
    batch = v.shape[:-1]
    if in_expanded:
        x = v.reshape(batch + edims)
    else:
        x = _pad_to(v.reshape(batch + dims), dims, edims)
    for a in range(-1, -nd - 1, -1):
        x = _axis_contract(x, _real_fourier_basis(edims[a], v.dtype, v.device), a)
    x = x * weights_full
    for a in range(-nd, 0):
        x = _axis_contract(x, _real_fourier_basis(edims[a], v.dtype, v.device).T, a)
    if out_expanded:
        return x.reshape(batch + (spec.Mprime,))
    crop = (Ellipsis,) + tuple(slice(0, d) for d in dims)
    return x[crop].reshape(batch + (spec.M,))


def _apply_spectrum_fft(spec: BTTBSpectrum, v: torch.Tensor,
                        weights: torch.Tensor, in_expanded: bool,
                        out_expanded: bool) -> torch.Tensor:
    """rfftn -> scale by the half-spectrum -> irfftn, over the last axes."""
    dims, edims = spec.dims, spec.edims
    nd = len(dims)
    batch = v.shape[:-1]
    if in_expanded:
        x = v.reshape(batch + edims)
    else:
        x = _pad_to(v.reshape(batch + dims), dims, edims)
    axes = tuple(range(-nd, 0))
    y = torch.fft.irfftn(torch.fft.rfftn(x, dim=axes) * weights, s=edims, dim=axes)
    if out_expanded:
        return y.reshape(batch + (spec.Mprime,))
    crop = (Ellipsis,) + tuple(slice(0, d) for d in dims)
    return y[crop].reshape(batch + (spec.M,))


def _apply_spectrum(spec: BTTBSpectrum, v: torch.Tensor, weights: torch.Tensor,
                    in_expanded: bool, out_expanded: bool) -> torch.Tensor:
    """pad -> transform -> scale by ``weights`` (a half-spectrum) ->
    inverse transform -> crop.  ``v`` is (..., M), or (..., M') when
    ``in_expanded``."""
    if max(spec.edims) <= MATMUL_DFT_MAX_LEN:
        wfull = _full_weights(weights, spec.edims[-1])
        return _apply_spectrum_matmul(spec, v, wfull, in_expanded, out_expanded)
    return _apply_spectrum_fft(spec, v, weights, in_expanded, out_expanded)


def matmul_by_K(spec: BTTBSpectrum, v: torch.Tensor) -> torch.Tensor:
    """K @ v for (..., M) vectors."""
    return _apply_spectrum(spec, v, spec.eigs, False, False)


def matmul_by_RT(spec: BTTBSpectrum, v: torch.Tensor) -> torch.Tensor:
    """R^T @ v: original space (..., M) -> whitened space (..., M')."""
    return _apply_spectrum(spec, v, torch.sqrt(spec.eigs), False, True)


def matmul_by_Cinv(spec: BTTBSpectrum, v: torch.Tensor) -> torch.Tensor:
    """Circulant-inverse preconditioner: top-left block of C^{-1} applied to v."""
    return _apply_spectrum(spec, v, 1.0 / spec.eigs, False, False)


def dense_gram(
    xgrids: Sequence[torch.Tensor],
    kernel_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    jitter: float = 1e-3,
) -> torch.Tensor:
    """The dense M x M Gram matrix (test oracle; O(M^2) memory)."""
    pts = _grid_points(xgrids)
    K = kernel_fn(pts, pts)
    return K + jitter * torch.eye(K.shape[0], dtype=K.dtype, device=K.device)
