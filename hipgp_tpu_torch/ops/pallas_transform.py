"""Kernel B-8: the full-plane 2-D circulant apply out[b] = Q0 ((Q0^T x[b] Q1) * w) Q1^T.

Counterpart of `hipgp_tpu/ops/pallas_transform.py`, whose names it keeps (as
the port kept `mxu2d` and `mxu3d`); the kernel here is hand-written CUDA, not
Pallas.  On (B, L0, L1) embedded planes it is the real-eigenbasis sandwich of
`bttb._apply_spectrum_matmul` in one call, uncropped: the 2-D `matmul_by_K`,
`matmul_by_Cinv` and `matmul_by_RT` when `bttb.USE_PALLAS_TRANSFORM` is set.

Two implementations live here:

* kernel B-8, launched for a float32 tensor on a CUDA device (anything else
  raises): kernel A's launch, ``csrc/sandwich_fft.cu``, with both crops full.
  That kernel is FFT-structured and does not read Q0 and Q1: on a CUDA
  tensor they must be the cached `bttb._real_fourier_basis` tensors (the
  only ones its caller, `bttb._apply_spectrum_matmul`, passes); other
  tables raise;
* its plain PyTorch version, :func:`_apply_einsum`, taken only for a tensor
  on the CPU, with whatever tables it is given.

:func:`circulant_apply_2d` is differentiable in x and w, as the JAX custom
VJP is: the operator is symmetric in x, so gx is the same apply on the
cotangent (B-8 again on the card), and gw = sum_b analysis(x_b) *
analysis(g_b), plain PyTorch.  The tables get no gradient.  Launches are
counted in :data:`LAUNCHES`.
"""
from __future__ import annotations

from typing import Dict

import torch

from . import bttb
from .bttb import fp32_matmul
from . import mxu2d

__all__ = ["circulant_apply_2d", "PALLAS_MAX_LEN", "LAUNCHES", "reset_launches"]

# largest embedded axis the kernel path is used for (the JAX gate's bound)
PALLAS_MAX_LEN = 512
# launches of kernel B-8; a plain-version call counts nothing
LAUNCHES: Dict[str, int] = {"circulant_apply_2d": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _analysis_2d(x, Q0, Q1):
    """Coefficients Q0^T x Q1 of (..., L0, L1) planes."""
    with fp32_matmul():
        return torch.matmul(Q0.T, torch.matmul(x, Q1))


def _apply_einsum(x, Q0, Q1, w):
    """The plain version: minor-axis analysis, leading-axis analysis, the
    scale by w, leading-axis synthesis, minor-axis synthesis."""
    with fp32_matmul():
        a = torch.matmul(Q0.T, torch.matmul(x, Q1)) * w
        return torch.matmul(torch.matmul(Q0, a), Q1.T)


def _check_basis(Q0, Q1, x) -> None:
    """Raises unless Q0 and Q1 are cached real Fourier bases of their
    lengths (tensors `bttb._real_fourier_basis` returned) in x's dtype on
    x's device: the kernel computes with its own FFT tables and never reads
    them."""
    for name, Q in (("Q0", Q0), ("Q1", Q1)):
        cached = any(Q is t for (L, dtype, _), t in bttb._BASIS.items()
                     if L == Q.shape[0] and dtype == x.dtype)
        if not cached or Q.device != x.device:
            raise ValueError(f"kernel B-8 takes only the cached real Fourier basis "
                             f"as {name} (bttb._real_fourier_basis); it does not "
                             f"read the tables")


def _apply(x, Q0, Q1, w):
    """Kernel B-8 on a CUDA tensor, the plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return _apply_einsum(x, Q0, Q1, w)
    _check_basis(Q0, Q1, x)
    y = mxu2d._launch_fft(x, w, tuple(w.shape), selfdot=False)
    LAUNCHES["circulant_apply_2d"] += 1
    return y


class _CirculantApply2d(torch.autograd.Function):
    """B-8 with the JAX package's `_fwd`/`_bwd`."""

    @staticmethod
    def forward(ctx, x, Q0, Q1, w):
        # the tables are kept as they are: the kernel's check needs the
        # very tensors the caller passed
        ctx.save_for_backward(x, w)
        ctx.bases = (Q0, Q1)
        return _apply(x, Q0, Q1, w)

    @staticmethod
    def backward(ctx, g):
        (x, w), (Q0, Q1) = ctx.saved_tensors, ctx.bases
        g = g.contiguous()
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = _apply(g, Q0, Q1, w)
        if ctx.needs_input_grad[3]:
            gw = torch.sum(_analysis_2d(x, Q0, Q1) * _analysis_2d(g, Q0, Q1), dim=0)
        return gx, None, None, gw


def circulant_apply_2d(x: torch.Tensor, Q0: torch.Tensor, Q1: torch.Tensor,
                       w: torch.Tensor) -> torch.Tensor:
    """out[b] = Q0 ((Q0^T x[b] Q1) * w) Q1^T.

    x: (B, L0, L1); Q0: (L0, L0); Q1: (L1, L1); w: (L0, L1) real spectrum.
    Kernel B-8 on a CUDA tensor (Q0, Q1 the cached bases), the plain
    version on a CPU tensor; differentiable in x and w."""
    if x.ndim != 3:
        raise ValueError(f"x must be (B, L0, L1), got {tuple(x.shape)}")
    L0, L1 = x.shape[1:]
    if tuple(Q0.shape) != (L0, L0) or tuple(Q1.shape) != (L1, L1):
        raise ValueError(f"tables must be ({L0}, {L0}) and ({L1}, {L1}), got "
                         f"{tuple(Q0.shape)} and {tuple(Q1.shape)}")
    if tuple(w.shape) != (L0, L1):
        raise ValueError(f"w must be ({L0}, {L1}), got {tuple(w.shape)}")
    return _CirculantApply2d.apply(x, Q0, Q1, w)
