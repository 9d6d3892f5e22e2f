"""The cropped 2-D sandwich y = P_o (Q0 x Q1) diag(w) (Q0 x Q1)^T P_i^T x.

Counterpart of `hipgp_tpu/ops/mxu2d.py` (`sandwich_apply`,
`sandwich_apply_selfdot`, `sandwich_apply_wp`).  The hot op of every PCG iteration on a 2-D
inducing grid is this real-eigenbasis sandwich per sample: two analysis
contractions, an elementwise scale by the full (L0, L1) spectrum w, two
synthesis contractions.  With rectangular tables (Q[:d] per axis) the
circulant padding is never materialised on input or output.  The self-dot
variant also returns dots[b] = <x[b], y[b]>: both PCG inner products
(p . Ap and r . C^{-1} r) are self-dots of an apply.

The weight-plane variant :func:`sandwich_apply_wp` applies the sandwich to
every plane of a (B, W, i0, i1) stack, plane l with its own spectrum w[l]:
the building block of the 3-D sandwich (`ops/mxu3d.py`), where the
outer-axis analysis turns one 3-D sample into W independent 2-D plane
problems.  Its self-dots sum over the planes.

Two implementations of each function live here:

* kernel A and kernel B-5, ``csrc/mxu2d.cu``, hand-written CUDA for Hopper,
  launched for a tensor on a CUDA device (f32 only; anything else raises);
* their plain PyTorch versions, :func:`sandwich_plain` and
  :func:`sandwich_wp_plain`, the einsum chain of
  `bttb._apply_spectrum_matmul` over the same rectangular tables, taken only
  for a tensor on the CPU.

Each wrapper counts its kernel launches in :data:`LAUNCHES`.

:func:`sandwich_apply` is differentiable in x and w (a
``torch.autograd.Function``, the JAX package's `_get_sandwich` custom VJP):
the operator is linear in x and its pullback is the same sandwich with the
two crops swapped (P_i and P_o exchange; diag(w) and Q are symmetric), so gx
is kernel A again on a CUDA tensor; gw = sum_b analysis(x_b) * analysis(g_b)
is plain PyTorch, as in JAX.  The self-dot and weight-plane variants are
solver-internal and not differentiable, as in JAX.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from .bttb import _real_fourier_basis, fp32_matmul, needs_grad, no_backward

__all__ = ["sandwich_apply", "sandwich_apply_selfdot", "sandwich_plain",
           "sandwich_apply_wp", "sandwich_wp_plain", "LAUNCHES",
           "MXU2D_MAX_LEN", "reset_launches"]

# largest embedded axis the kernel path is used for (the solver gate)
MXU2D_MAX_LEN = 512
# launches of kernel A, per wrapper; a plain-version call counts nothing
LAUNCHES: Dict[str, int] = {"sandwich_apply": 0, "sandwich_apply_selfdot": 0,
                            "sandwich_apply_wp": 0, "sandwich_apply_wp_selfdot": 0}
# blocks a grid's y dimension may have (the row GEMMs' row tiles)
_GRID_Y_LIMIT = 65535
# shared memory one block may use on the card (sm_90)
_SMEM_LIMIT = 232448
_TABLES: Dict[tuple, tuple] = {}
_LIB = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _tables(dims, edims, in_expanded, out_expanded, dtype, device):
    """Rectangular analysis/synthesis slabs of the orthonormal real Fourier
    bases: q0a = Q0[:i0].T, q1a = Q1[:i1], q0s = Q0[:o0], q1s = Q1[:o1].T,
    all contiguous; cached per shape, dtype and device."""
    key = (tuple(dims), tuple(edims), in_expanded, out_expanded, dtype, str(device))
    if key not in _TABLES:
        (d0, d1), (L0, L1) = dims, edims
        i0, i1 = (L0, L1) if in_expanded else (d0, d1)
        o0, o1 = (L0, L1) if out_expanded else (d0, d1)
        Q0 = _real_fourier_basis(L0, dtype, device)
        Q1 = _real_fourier_basis(L1, dtype, device)
        _TABLES[key] = (Q0[:i0].T.contiguous(), Q1[:i1].contiguous(),
                        Q0[:o0].contiguous(), Q1[:o1].T.contiguous(),
                        (i0, i1), (o0, o1))
    return _TABLES[key]


def sandwich_plain(x, w, q0a, q1a, q0s, q1s, selfdot: bool = False):
    """The plain PyTorch sandwich on (B, i0, i1) planes: minor-axis analysis,
    leading-axis analysis, scale, leading-axis synthesis, minor-axis
    synthesis.  Returns y (B, o0, o1), and (y, dots) with ``selfdot``."""
    with fp32_matmul():
        u = torch.matmul(x, q1a)          # (B, i0, L1)
        a = torch.matmul(q0a, u) * w      # (B, L0, L1)
        c = torch.matmul(q0s, a)          # (B, o0, L1)
        y = torch.matmul(c, q1s)          # (B, o0, o1)
    if selfdot:
        return y, torch.sum(x * y, dim=(1, 2))
    return y


def sandwich_wp_plain(x, w, q0a, q1a, q0s, q1s, selfdot: bool = False):
    """The plain PyTorch sandwich of every plane of a (B, W, i0, i1) stack,
    plane l with spectrum w[l] of the (W, L0, L1) stack.  Returns
    y (B, W, o0, o1), and (y, dots) with ``selfdot``: each plane's dot, then
    their sum over the planes in order."""
    with fp32_matmul():
        u = torch.matmul(x, q1a)          # (B, W, i0, L1)
        a = torch.matmul(q0a, u) * w      # (B, W, L0, L1)
        c = torch.matmul(q0s, a)          # (B, W, o0, L1)
        y = torch.matmul(c, q1s)          # (B, W, o0, o1)
    if selfdot:
        return y, torch.sum(torch.sum(x * y, dim=(2, 3)), dim=1)
    return y


def _lib():
    global _LIB
    if _LIB is None:
        from .. import _build

        lib = _build.load("mxu2d")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.mxu2d_sandwich.argtypes = [p] * 11 + [i] * 7 + [p]
        lib.mxu2d_sandwich.restype = ctypes.c_int
        lib.mxu2d_sandwich_wp.argtypes = [p] * 11 + [i] * 8 + [p]
        lib.mxu2d_sandwich_wp.restype = ctypes.c_int
        lib.mxu2d_row_tiles.argtypes = [i] * 4
        lib.mxu2d_row_tiles.restype = ctypes.c_int
        lib.mxu2d_middle_smem_bytes.argtypes = [i, i]
        lib.mxu2d_middle_smem_bytes.restype = ctypes.c_size_t
        lib.mxu2d_partial_floats.argtypes = [i, i, i]
        lib.mxu2d_partial_floats.restype = ctypes.c_size_t
        _LIB = lib
    return _LIB


def _launch(x, w, tables, selfdot: bool):
    """Kernel A on (B, i0, i1) planes with w (L0, L1), or kernel B-5 on a
    (B, W, i0, i1) stack with w (W, L0, L1), on CUDA tensors: checks,
    allocates every output and scratch buffer with torch.empty, launches on
    the current stream, raises on a non-zero cudaError_t.  The caller counts
    the launch (kernel B-8 is this launch with full-plane tables)."""
    q0a, q1a, q0s, q1s, (i0, i1), (o0, o1) = tables
    L0, L1 = w.shape[-2:]
    wp = x.ndim == 4
    B, W = x.shape[0], (x.shape[1] if wp else 1)
    for name, t in (("x", x), ("w", w)):
        if t.dtype != torch.float32:
            raise TypeError(f"sandwich kernel takes float32 {name}, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"sandwich kernel needs a contiguous {name}")
    if selfdot and (i0, i1) != (o0, o1):
        raise ValueError("the self-dot needs equal input and output crops")
    lib = _lib()
    if lib.mxu2d_middle_smem_bytes(i0, L0) > _SMEM_LIMIT:
        raise ValueError(f"input rows {i0} and embedded rows {L0} need more "
                         "shared memory than one block has")
    if lib.mxu2d_row_tiles(B, W, i0, o0) > _GRID_Y_LIMIT:
        raise ValueError(f"{B * W} planes of {max(i0, o0)} rows are more than "
                         "one launch of the row GEMM covers; split the batch")
    dev = x.device
    y = torch.empty((B, W, o0, o1) if wp else (B, o0, o1), dtype=torch.float32,
                    device=dev)
    u = torch.empty((W * i0 * B * L1,), dtype=torch.float32, device=dev)
    c = torch.empty((W * o0 * B * L1,), dtype=torch.float32, device=dev)
    if selfdot:
        dots = torch.empty((B,), dtype=torch.float32, device=dev)
        partial = torch.empty((lib.mxu2d_partial_floats(B * W, o0, o1),),
                              dtype=torch.float32, device=dev)
        dots_p, partial_p = dots.data_ptr(), partial.data_ptr()
    else:
        dots = None
        dots_p = partial_p = None
    ptrs = (x.data_ptr(), q0a.data_ptr(), q1a.data_ptr(), q0s.data_ptr(),
            q1s.data_ptr(), w.data_ptr(), y.data_ptr(), dots_p, u.data_ptr(),
            c.data_ptr(), partial_p)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if wp:
            err = lib.mxu2d_sandwich_wp(*ptrs, B, W, i0, i1, L0, L1, o0, o1, stream)
        else:
            err = lib.mxu2d_sandwich(*ptrs, B, i0, i1, L0, L1, o0, o1, stream)
    if err != 0:
        raise RuntimeError(f"mxu2d sandwich kernel failed: cudaError_t {err}")
    return (y, dots) if selfdot else y


def _check_shapes(x, w, tables):
    i_shape, o_shape = tables[4], tables[5]
    if x.ndim != 3 or tuple(x.shape[1:]) != i_shape:
        raise ValueError(f"x must be (B, {i_shape[0]}, {i_shape[1]}), got "
                         f"{tuple(x.shape)}")
    if w.ndim != 2 or w.shape[0] != tables[0].shape[0] or w.shape[1] != tables[1].shape[1]:
        raise ValueError(f"w must be the full (L0, L1) spectrum, got {tuple(w.shape)}")


def _analysis(x: torch.Tensor, dims, edims, expanded: bool) -> torch.Tensor:
    """Q0^T P^T x Q1 per sample, (B, i0, i1) -> (B, L0, L1), with the crop
    ``expanded`` selects (the JAX package's `_analysis_einsum`)."""
    q0a, q1a = _tables(dims, edims, expanded, expanded, x.dtype, x.device)[:2]
    with fp32_matmul():
        return torch.matmul(q0a, torch.matmul(x, q1a))


class _Sandwich(torch.autograd.Function):
    """Kernel A (or its plain version on the CPU) with the backward of the
    JAX package's `_get_sandwich`: gx is the sandwich with the crops
    swapped, gw = sum_b analysis(x_b) * analysis(g_b)."""

    @staticmethod
    def forward(ctx, x, w, dims, edims, in_expanded, out_expanded):
        tables = _tables(dims, edims, in_expanded, out_expanded, x.dtype, x.device)
        ctx.save_for_backward(x, w)
        ctx.crops = (dims, edims, in_expanded, out_expanded)
        if x.device.type == "cpu":
            return sandwich_plain(x, w, *tables[:4])
        y = _launch(x, w, tables, selfdot=False)
        LAUNCHES["sandwich_apply"] += 1
        return y

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dims, edims, in_expanded, out_expanded = ctx.crops
        g = g.contiguous()
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = sandwich_apply(g, w, dims, edims, in_expanded=out_expanded,
                                out_expanded=in_expanded)
        if ctx.needs_input_grad[1]:
            gw = torch.sum(_analysis(x, dims, edims, in_expanded)
                           * _analysis(g, dims, edims, out_expanded), dim=0)
        return gx, gw, None, None, None, None


def sandwich_apply(x: torch.Tensor, w: torch.Tensor, dims: Tuple[int, int],
                   edims: Tuple[int, int], *, in_expanded: bool = False,
                   out_expanded: bool = False) -> torch.Tensor:
    """y[b] = P_o (Q0 x Q1) diag(w) (Q0 x Q1)^T P_i^T x[b].

    x: (B, i0, i1) with (i0, i1) = ``edims`` when ``in_expanded`` else
    ``dims``; w: (L0, L1) full spectrum (`bttb._full_weights` layout).
    Returns (B, o0, o1).  Kernel A on a CUDA tensor, the plain version on
    a CPU tensor; differentiable in x and w (the backward's gx is kernel A
    with the crops swapped)."""
    dims, edims = tuple(dims), tuple(edims)
    in_expanded, out_expanded = bool(in_expanded), bool(out_expanded)
    _check_shapes(x, w, _tables(dims, edims, in_expanded, out_expanded,
                                x.dtype, x.device))
    return _Sandwich.apply(x, w, dims, edims, in_expanded, out_expanded)


def sandwich_apply_selfdot(x: torch.Tensor, w: torch.Tensor,
                           dims: Tuple[int, int], edims: Tuple[int, int]):
    """Cropped in/out sandwich plus the per-sample self-dot: returns
    (y, dots) with dots[b] = sum(x[b] * y[b])."""
    tables = _tables(dims, edims, False, False, x.dtype, x.device)
    _check_shapes(x, w, tables)
    if x.device.type == "cpu":
        return sandwich_plain(x, w, *tables[:4], selfdot=True)
    if needs_grad(x, w):
        raise no_backward("the self-dot sandwich (solver-internal)")
    out = _launch(x, w, tables, selfdot=True)
    LAUNCHES["sandwich_apply_selfdot"] += 1
    return out


def sandwich_apply_wp(x: torch.Tensor, w: torch.Tensor, dims: Tuple[int, int],
                      edims: Tuple[int, int], *, in_expanded: bool = False,
                      out_expanded: bool = False, selfdot: bool = False):
    """y[b, l] = P_o (Q0 x Q1) diag(w[l]) (Q0 x Q1)^T P_i^T x[b, l] on a
    (B, W, i0, i1) plane stack with per-plane spectra w (W, L0, L1).

    Returns (B, W, o0, o1); with ``selfdot`` (cropped in and out) also
    dots[b] = sum_l <x[b, l], y[b, l]>.  Kernel B-5 on a CUDA tensor, the
    plain version on a CPU tensor."""
    tables = _tables(dims, edims, bool(in_expanded), bool(out_expanded),
                     x.dtype, x.device)
    i_shape = tables[4]
    if x.ndim != 4 or tuple(x.shape[2:]) != i_shape:
        raise ValueError(f"x must be (B, W, {i_shape[0]}, {i_shape[1]}), got "
                         f"{tuple(x.shape)}")
    if w.ndim != 3 or w.shape[0] != x.shape[1] or tuple(w.shape[1:]) != tuple(edims):
        raise ValueError(f"w must be ({x.shape[1]}, {edims[0]}, {edims[1]}) "
                         f"per-plane spectra, got {tuple(w.shape)}")
    if selfdot and (in_expanded or out_expanded):
        raise ValueError("the self-dot needs equal input and output crops")
    if x.device.type == "cpu":
        return sandwich_wp_plain(x, w, *tables[:4], selfdot=selfdot)
    if needs_grad(x, w):
        raise no_backward("kernel B-5")
    out = _launch(x, w, tables, selfdot=selfdot)
    LAUNCHES["sandwich_apply_wp_selfdot" if selfdot else "sandwich_apply_wp"] += 1
    return out
