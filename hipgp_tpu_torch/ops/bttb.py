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
axis is <= MATMUL_DFT_MAX_LEN (the same operator as the JAX package's; on a
2-D grid, for a float32 tensor on a CUDA device and with
USE_PALLAS_TRANSFORM set, the full-plane sandwich kernel B-8 of
`ops/pallas_transform.py`); on a 1-D grid whose embedding length the radix
plan supports, for a float32 tensor on a CUDA device, the packed radix apply
(`ops/radix_fft.py`, kernels B-2 to B-4); and torch.fft otherwise.  All
matvecs act on the last axis; leading batch dimensions are kept.  They are
differentiable in the vector and the spectrum (so, through `make_spectrum`,
in the kernel's hyperparameters) on every branch: the radix branch through
the radix apply's backward (`radix_fft.fused_circulant_apply`).
"""
from __future__ import annotations

import contextlib
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
    "spectrum_from_column",
    "apply_route",
    "matmul_by_K",
    "matmul_by_RT",
    "matmul_by_Cinv",
    "bttb_matvec",
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
# The 2-D matmul chain through the full-plane sandwich kernel B-8
# (`ops/pallas_transform.py`) for float32 CUDA tensors.  Off, as in the JAX
# package, by measurement: at (256, 250, 250) on an H100 80GB HBM3 (700 W)
# B-8 takes 1.29-1.31 ms against the einsum chain's 0.88-0.90 ms, in turns
# by chip_smoke.py [kernels] (PERF.md section 6).
USE_PALLAS_TRANSFORM = False
# The fused 2-D sandwich PCG and R^T through kernel A (`solve._mxu2d_solver`,
# `solve._rt_mxu2d`); off, the 2-D float32 CUDA solve is the generic `pcg`
# over `matmul_by_K` (through B-8 when USE_PALLAS_TRANSFORM is set).
USE_MXU2D_PCG = True
# The fused 3-D sandwich PCG and R^T (`solve._mxu3d_solver`: the outer-axis
# products and kernel B-5, or kernel B-6) for float32 CUDA tensors; off, the
# 3-D float32 CUDA solve is the generic, differentiable `pcg` over
# `matmul_by_K`.  On, as in the JAX package.
USE_MXU3D_PCG = True
# The 1-D long-axis radix kernels B-2 to B-4 for float32 CUDA tensors: the
# packed planes PCG (`solve._planes_solver`) and the radix apply of
# `matmul_by_K` and its kin (`_radix_apply_ok`); off, the 1-D float32 CUDA
# solve is the generic, differentiable `pcg` over the torch.fft apply.  On,
# as in the JAX package.
USE_RADIX_FFT = True
# Arithmetic of the einsum chain's products (the JAX package's
# MATMUL_DFT_PRECISION and MATMUL_DFT_DTYPE): 'fp32' (TF32 off, the port's
# policy), 'tf32' (TF32 on) or 'bf16' (operands stored in bfloat16, the
# products accumulated in float32 by the matmul, the result cast back).
# Swept by experiments/precision_study.py; not meant to change otherwise.
MATMUL_DFT_POLICY = "fp32"


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


@contextlib.contextmanager
def fp32_matmul(tf32: bool = False):
    """Full-FP32 matrix products for the duration (TF32 off): TF32 keeps
    about three decimal digits, which these DFT-like sums cannot spare.
    ``tf32=True`` turns TF32 on instead (the precision study's policy)."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def needs_grad(*tensors) -> bool:
    """True when autograd would record an op on any of ``tensors``."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def no_backward(where: str):
    """The error for a gradient through a solver-internal apply (the fused
    self-dot applies of the PCG), which has no backward, as in the JAX
    package: a silent zero or partial gradient would be wrong."""
    return NotImplementedError(
        f"{where} is solver-internal and has no backward, as in the JAX "
        "package; gradients flow through inv_matmul / whiten, whose backward "
        "solves again and differentiates the operator")


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


def spectrum_from_column(col: torch.Tensor,
                         eig_floor: float = DEFAULT_EIG_FLOOR) -> BTTBSpectrum:
    """The clamped circulant half-spectrum of a Toeplitz column (*dims), on
    the minimal 2m - 2 embedding (`circulant_embed`)."""
    emb = circulant_embed(col)
    eigs = torch.clamp(_real_even_half_spectrum(emb), min=eig_floor)
    return BTTBSpectrum(column=col, eigs=eigs, dims=tuple(col.shape),
                        edims=tuple(emb.shape), ecolumn=emb)


def _cosine_matrix(L: int, dtype: torch.dtype, device) -> torch.Tensor:
    """(L, L) cosine DFT matrix C[n, k] = cos(2 pi n k / L), built in float64."""
    n = np.arange(L, dtype=np.float64)
    return torch.as_tensor(np.cos((2.0 * np.pi / L) * np.outer(n, n))).to(
        dtype=dtype, device=device)


def _real_even_half_spectrum_matmul(emb: torch.Tensor) -> torch.Tensor:
    """The half-spectrum of a per-axis-even real tensor without an FFT: the
    DFT of an even vector is its cosine transform, so one (L, L) cosine
    contraction per axis gives the same eigenvalues as
    :func:`_real_even_half_spectrum` (full FP32)."""
    full = emb
    with fp32_matmul():
        for a in range(emb.ndim):
            full = _axis_contract(full, _cosine_matrix(emb.shape[a], emb.dtype, emb.device), a)
    return full[..., : emb.shape[-1] // 2 + 1].contiguous()


def make_spectrum(
    xgrids: Sequence[torch.Tensor],
    kernel_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    jitter: float = 1e-3,
    eig_floor: float = DEFAULT_EIG_FLOOR,
    pad_to_fast: bool = True,
    multiple_of: Optional[Sequence[int]] = None,
    transform: str = "fft",
) -> BTTBSpectrum:
    """Column, circulant embedding and spectrum clamped to ``eig_floor`` in
    one call.

    With ``pad_to_fast`` each embedded axis is padded from 2m-2 to
    `embedded_dims` (rounded up to the per-axis ``multiple_of``, as the
    grid-sharded solves need: `parallel.fft_sharded.shard_multiples`) by
    evaluating the kernel at wrapped lags tau_j = min(j, L - j) * h: for any
    L >= 2m - 2 that circulant has the exact BTTB Gram as its top-left
    M x M block, so the padding changes the whitened basis, never K.
    Requires uniformly spaced grids.  Without it, the minimal 2m - 2
    embedding of the Toeplitz column (`spectrum_from_column`); the kernel
    paths refuse its lengths where they have no plan for them, and the
    generic path takes them.  ``transform``: 'fft' (torch.fft) or 'matmul'
    (one cosine-matrix contraction per axis, for short axes).
    """
    if transform not in ("fft", "matmul"):
        raise ValueError(f"unknown transform {transform!r}")
    if not pad_to_fast:
        if multiple_of is not None:
            raise ValueError("multiple_of requires pad_to_fast=True")
        return spectrum_from_column(toeplitz_column(xgrids, kernel_fn, jitter), eig_floor)
    dims = tuple(len(g) for g in xgrids)
    edims = embedded_dims(dims, multiple_of)
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
    half = (_real_even_half_spectrum_matmul(emb) if transform == "matmul"
            else _real_even_half_spectrum(emb))
    eigs = torch.clamp(half, min=eig_floor)
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
    """Contract ``axis`` of x with Q[in, out], keeping the axis in place
    (bfloat16 operands under MATMUL_DFT_POLICY 'bf16')."""
    nd = x.ndim
    axis = axis % nd
    subs = _LETTERS[:nd]
    out = subs[:axis] + "Z" + subs[axis + 1:]
    eq = f"{subs},{subs[axis]}Z->{out}"
    if MATMUL_DFT_POLICY == "bf16":
        return torch.einsum(eq, x.to(torch.bfloat16), Q.to(torch.bfloat16)).to(x.dtype)
    return torch.einsum(eq, x, Q)


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


def _pallas_transform_ok(spec: BTTBSpectrum, v: torch.Tensor) -> bool:
    """The gate of kernel B-8 (the JAX package's `_apply_spectrum_matmul`
    gate, its backend test replaced by a device test): USE_PALLAS_TRANSFORM,
    a 2-D grid, a float32 tensor on a CUDA device, and every embedded axis
    <= PALLAS_MAX_LEN with a kernel-A plan (B-8 is kernel A's launch)."""
    if not USE_PALLAS_TRANSFORM or len(spec.dims) != 2:
        return False
    if v.device.type != "cuda" or v.dtype != torch.float32:
        return False
    from .mxu2d import plans_ok
    from .pallas_transform import PALLAS_MAX_LEN

    return max(spec.edims) <= PALLAS_MAX_LEN and plans_ok(spec.edims)


def _apply_spectrum_matmul(spec: BTTBSpectrum, v: torch.Tensor,
                           weights_full: torch.Tensor, in_expanded: bool,
                           out_expanded: bool) -> torch.Tensor:
    """The einsum chain: analysis per axis (minor axis first), scale by the
    full spectrum, synthesis per axis; through kernel B-8 where
    `_pallas_transform_ok` says so.  Full FP32 (TF32 off) unless
    MATMUL_DFT_POLICY says otherwise."""
    dims, edims = spec.dims, spec.edims
    nd = len(dims)
    batch = v.shape[:-1]
    if in_expanded:
        x = v.reshape(batch + edims)
    else:
        x = _pad_to(v.reshape(batch + dims), dims, edims)
    if _pallas_transform_ok(spec, v):
        from .pallas_transform import circulant_apply_2d

        Q0 = _real_fourier_basis(edims[0], v.dtype, v.device)
        Q1 = _real_fourier_basis(edims[1], v.dtype, v.device)
        x = circulant_apply_2d(x.reshape((-1,) + edims).contiguous(), Q0, Q1,
                               weights_full.contiguous()).reshape(batch + edims)
    else:
        with fp32_matmul(tf32=MATMUL_DFT_POLICY == "tf32"):
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


def _radix_apply_ok(spec: BTTBSpectrum, dtype: torch.dtype,
                    device: torch.device) -> bool:
    """The 1-D radix branch: USE_RADIX_FFT, float32 on a CUDA device, and an
    embedding length the radix plan supports."""
    if len(spec.dims) != 1 or dtype != torch.float32 or not USE_RADIX_FFT:
        return False
    if torch.device(device).type != "cuda":
        return False
    from .radix_fft import radix_supported

    return radix_supported(spec.edims[0])


def _apply_spectrum_radix(spec: BTTBSpectrum, v: torch.Tensor,
                          weights: torch.Tensor, in_expanded: bool,
                          out_expanded: bool) -> torch.Tensor:
    """The packed radix apply: two real rows per complex plane (the
    spectrum is real and even, so C_d (x1 + i x2) = C_d x1 + i C_d x2),
    uncropped through the three radix kernels."""
    from .radix_fft import (fused_circulant_apply, make_plan, pack_rows,
                            permute_weights, unpack_rows)

    L = spec.edims[0]
    batch = v.shape[:-1]
    x = v.reshape(-1, v.shape[-1])
    plan = make_plan(L, v.dtype, v.device)
    dperm = permute_weights(_full_weights(weights, L), plan)
    yr, yi = fused_circulant_apply(*pack_rows(x, L), dperm, plan)
    y = unpack_rows(yr, yi, x.shape[0])
    if not out_expanded:
        y = y[:, :spec.M]
    return y.reshape(batch + (y.shape[-1],))


def _apply_spectrum(spec: BTTBSpectrum, v: torch.Tensor, weights: torch.Tensor,
                    in_expanded: bool, out_expanded: bool) -> torch.Tensor:
    """pad -> transform -> scale by ``weights`` (a half-spectrum) ->
    inverse transform -> crop.  ``v`` is (..., M), or (..., M') when
    ``in_expanded``."""
    if max(spec.edims) <= MATMUL_DFT_MAX_LEN:
        wfull = _full_weights(weights, spec.edims[-1])
        return _apply_spectrum_matmul(spec, v, wfull, in_expanded, out_expanded)
    if _radix_apply_ok(spec, v.dtype, v.device):
        return _apply_spectrum_radix(spec, v, weights, in_expanded, out_expanded)
    return _apply_spectrum_fft(spec, v, weights, in_expanded, out_expanded)


def apply_route(spec: BTTBSpectrum, dtype: torch.dtype, device) -> str:
    """The branch `matmul_by_K` and its kin take for ``dtype`` tensors on
    ``device``: 'B-8' (kernel B-8), 'einsum' (the real-basis matmul chain),
    'radix' (kernels B-2 to B-4) or 'torch.fft'."""
    if max(spec.edims) <= MATMUL_DFT_MAX_LEN:
        v = torch.empty(0, dtype=dtype, device=device)
        return "B-8" if _pallas_transform_ok(spec, v) else "einsum"
    return "radix" if _radix_apply_ok(spec, dtype, device) else "torch.fft"


def matmul_by_K(spec: BTTBSpectrum, v: torch.Tensor) -> torch.Tensor:
    """K @ v for (..., M) vectors."""
    return _apply_spectrum(spec, v, spec.eigs, False, False)


def matmul_by_RT(spec: BTTBSpectrum, v: torch.Tensor) -> torch.Tensor:
    """R^T @ v: original space (..., M) -> whitened space (..., M')."""
    return _apply_spectrum(spec, v, torch.sqrt(spec.eigs), False, True)


def matmul_by_R(spec: BTTBSpectrum, v: torch.Tensor) -> torch.Tensor:
    """R @ v: whitened space (..., M') -> original space (..., M)."""
    return _apply_spectrum(spec, v, torch.sqrt(spec.eigs), True, False)


def matmul_by_Cinv(spec: BTTBSpectrum, v: torch.Tensor) -> torch.Tensor:
    """Circulant-inverse preconditioner: top-left block of C^{-1} applied to v."""
    return _apply_spectrum(spec, v, 1.0 / spec.eigs, False, False)


def bttb_matvec(spec: BTTBSpectrum, v: torch.Tensor, mode: str) -> torch.Tensor:
    """The four structured matvecs by name: 'gram' (K v), 'rtv' (R^T v),
    'rv' (R v), 'cinv' (C^{-1} v)."""
    ops = {"gram": matmul_by_K, "rtv": matmul_by_RT, "rv": matmul_by_R,
           "cinv": matmul_by_Cinv}
    if mode not in ops:
        raise ValueError(f"unknown mode {mode!r}")
    return ops[mode](spec, v)


def dense_gram(
    xgrids: Sequence[torch.Tensor],
    kernel_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    jitter: float = 1e-3,
) -> torch.Tensor:
    """The dense M x M Gram matrix (test oracle; O(M^2) memory)."""
    pts = _grid_points(xgrids)
    K = kernel_fn(pts, pts)
    return K + jitter * torch.eye(K.shape[0], dtype=K.dtype, device=K.device)
