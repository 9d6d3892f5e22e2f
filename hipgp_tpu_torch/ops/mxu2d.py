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

* on a tensor on a CUDA device (f32 only; anything else raises), hand-written
  CUDA for Hopper: kernel A, ``csrc/sandwich_fft.cu``, the FFT-structured
  circulant sandwich (also kernel B-8's, `ops/pallas_transform.py`), and
  kernel B-5, ``csrc/mxu2d.cu``, dense real-DFT contractions per plane;
* their plain PyTorch versions, :func:`sandwich_plain` and
  :func:`sandwich_wp_plain`, the einsum chain of
  `bttb._apply_spectrum_matmul` over the same rectangular tables, taken only
  for a tensor on the CPU.

Kernel A computes the sandwich through the DFT of the zero-padded plane
(one Cooley-Tukey step per axis, `fft_plan`): for a w even in each axis, as
the solver's spectra are, that is crop(irfft2(w[:, :L1/2+1] * rfft2(pad(x))));
its scale step also applies w's odd parts, as the real basis does, so it is
the sandwich for any w.

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
import math
from typing import Dict, Tuple

import numpy as np
import torch

from .bttb import _real_fourier_basis, fp32_matmul, needs_grad, no_backward

__all__ = ["sandwich_apply", "sandwich_apply_selfdot", "sandwich_plain",
           "sandwich_apply_wp", "sandwich_wp_plain", "fft_plan", "LAUNCHES",
           "MXU2D_MAX_LEN", "reset_launches"]

# largest embedded axis the kernel path is used for (the solver gate)
MXU2D_MAX_LEN = 512
# launches of kernels A and B-5, per wrapper; a plain-version call counts nothing
LAUNCHES: Dict[str, int] = {"sandwich_apply": 0, "sandwich_apply_selfdot": 0,
                            "sandwich_apply_wp": 0, "sandwich_apply_wp_selfdot": 0}
# blocks a grid's y dimension may have (B-5's row GEMMs' row tiles)
_GRID_Y_LIMIT = 65535
# largest factor of kernel A's one-step Cooley-Tukey split (csrc/sandwich_fft.cu)
_FFT_MAX_FACTOR = 32
# shared memory one block may use on the card (sm_90)
_SMEM_LIMIT = 232448
_TABLES: Dict[tuple, tuple] = {}
_FFT_TABLES: Dict[tuple, torch.Tensor] = {}
_LIB = None
_FFT_LIB = None


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


def _crops(dims, edims, in_expanded: bool, out_expanded: bool):
    """The input and output plane shapes ((i0, i1), (o0, o1)) of a crop."""
    return (tuple(edims) if in_expanded else tuple(dims),
            tuple(edims) if out_expanded else tuple(dims))


def fft_plan(L: int) -> Tuple[int, int]:
    """Kernel A's split of a length-L DFT into one Cooley-Tukey step
    L = a * b with a <= b <= 32, the most balanced one (the fewest
    operations per point).  Raises for a length with no such split (every
    {2,3,5}-smooth L <= 512 has one)."""
    for a in range(math.isqrt(L), 0, -1):
        if L % a == 0 and L // a <= _FFT_MAX_FACTOR:
            return a, L // a
    raise ValueError(f"length {L} has no split into two factors <= "
                     f"{_FFT_MAX_FACTOR}; kernel A does not take it")


def _pad8(n: int) -> int:
    return (n + 7) // 8 * 8


def _fft_split_np(L: int, P: int, Q: int, sign: float) -> np.ndarray:
    """One oriented split L = P * Q of one direction as kernel A keeps it in
    shared memory: the P x P and Q x Q DFT matrices e^{sign 2 pi i r s / n}
    (rows padded with zeros to a multiple of 8 entries), then the twiddles
    e^{sign 2 pi i n2 k1 / L} as Q rows of P (padded the same way);
    complex128, flat."""
    blocks = []
    for rows, cols, n in ((P, P, P), (Q, Q, Q), (Q, P, L)):
        block = np.zeros((rows, _pad8(cols)), dtype=np.complex128)
        rs = np.arange(rows)[:, None] * np.arange(cols)[None, :] % n
        block[:, :cols] = np.exp(sign * 2j * np.pi * rs / n)
        blocks.append(block.ravel())
    return np.concatenate(blocks)


def _fft_table_np(L: int) -> np.ndarray:
    """Kernel A's table of a length L = a * b (`fft_plan`), complex128: for
    the forward (e^-) and then the inverse (e^+) direction, the splits
    (P, Q) = (a, b) and (b, a) of `_fft_split_np` (the layout `make_split` in
    csrc/sandwich_fft.cu reads)."""
    a, b = fft_plan(L)
    return np.concatenate([_fft_split_np(L, P, Q, sign) for sign in (-1.0, 1.0)
                           for P, Q in ((a, b), (b, a))])


def _fft_tables(L: int, device) -> torch.Tensor:
    """:func:`_fft_table_np` rounded to float32 as interleaved (re, im)
    pairs, cached per length and device."""
    key = (L, str(device))
    if key not in _FFT_TABLES:
        t = _fft_table_np(L)
        pairs = np.stack([t.real, t.imag], axis=-1).astype(np.float32)
        _FFT_TABLES[key] = torch.as_tensor(pairs).to(device).contiguous()
    return _FFT_TABLES[key]


def _fft_orient(plan, nin: int, nout: int, real_in: bool = False,
                real_out: bool = False) -> int:
    """1 when a transform of nin nonzero inputs to nout outputs costs less
    as (P, Q) = (b, a) than as (a, b): step 1 does P * nin and step 2 Q * nout
    complex multiply-adds, half as many FMAs each for a real input (step 1)
    or a real output (step 2)."""
    a, b = plan
    c1, c2 = (2 if real_in else 4), (2 if real_out else 4)
    return int(c1 * b * nin + c2 * a * nout < c1 * a * nin + c2 * b * nout)


def _fft_launch_plan(i_shape, edims, o_shape):
    """The splits (a0, b0, a1, b1) of the two axes and the orientations of
    kernel A's four transforms: the real-input row DFT i1 -> L1/2+1, the
    column DFT i0 -> L0 and back L0 -> o0, the real-output row DFT
    L1/2+1 -> o1."""
    (i0, i1), (L0, L1), (o0, o1) = i_shape, edims, o_shape
    p0, p1 = fft_plan(L0), fft_plan(L1)
    H = L1 // 2 + 1
    swaps = (_fft_orient(p1, i1, H, real_in=True), _fft_orient(p0, i0, L0),
             _fft_orient(p0, L0, o0), _fft_orient(p1, H, o1, real_out=True))
    return p0 + p1, swaps


def _lib():
    global _LIB
    if _LIB is None:
        from .. import _build

        lib = _build.load("mxu2d")
        p, i = ctypes.c_void_p, ctypes.c_int
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


def _fft_lib():
    global _FFT_LIB
    if _FFT_LIB is None:
        from .. import _build

        lib = _build.load("sandwich_fft")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.fft_sandwich.argtypes = [p] * 9 + [i] * 15 + [p]
        lib.fft_sandwich.restype = ctypes.c_int
        lib.fft_sandwich_smem_bytes.argtypes = [i] * 11
        lib.fft_sandwich_smem_bytes.restype = ctypes.c_size_t
        _FFT_LIB = lib
    return _FFT_LIB


def _check_operands(x, w):
    for name, t in (("x", x), ("w", w)):
        if t.dtype != torch.float32:
            raise TypeError(f"sandwich kernel takes float32 {name}, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"sandwich kernel needs a contiguous {name}")


def _launch_fft(x, w, o_shape, selfdot: bool):
    """Kernel A on (B, i0, i1) planes with the full (L0, L1) spectrum w,
    out to (B, o0, o1), on CUDA tensors: checks, allocates every output and
    scratch buffer with torch.empty, launches on the current stream, raises
    on a non-zero cudaError_t.  The caller counts the launch (kernel B-8 is
    this launch with both crops full)."""
    _check_operands(x, w)
    B, i0, i1 = x.shape
    L0, L1 = w.shape
    o0, o1 = o_shape
    if selfdot and (i0, i1) != (o0, o1):
        raise ValueError("the self-dot needs equal input and output crops")
    splits, swaps = _fft_launch_plan((i0, i1), (L0, L1), (o0, o1))
    lib = _fft_lib()
    if lib.fft_sandwich_smem_bytes(i1, L0, o1, *splits, *swaps) > _SMEM_LIMIT:
        raise ValueError(f"embedding {(L0, L1)} needs more shared memory than one "
                         "block has")
    dev = x.device
    H = L1 // 2 + 1
    y = torch.empty((B, o0, o1), dtype=torch.float32, device=dev)
    s1 = torch.empty((2 * B * H * i0,), dtype=torch.float32, device=dev)
    s2 = torch.empty((2 * B * H * o0,), dtype=torch.float32, device=dev)
    if selfdot:
        dots = torch.empty((B,), dtype=torch.float32, device=dev)
        rowdot = torch.empty((B * o0,), dtype=torch.float32, device=dev)
        dots_p, rowdot_p = dots.data_ptr(), rowdot.data_ptr()
    else:
        dots = None
        dots_p = rowdot_p = None
    t0, t1 = _fft_tables(L0, dev), _fft_tables(L1, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fft_sandwich(x.data_ptr(), w.data_ptr(), t0.data_ptr(), t1.data_ptr(),
                               y.data_ptr(), dots_p, s1.data_ptr(), s2.data_ptr(),
                               rowdot_p, B, i0, i1, L0, L1, o0, o1, *splits, *swaps,
                               stream)
    if err != 0:
        raise RuntimeError(f"sandwich_fft kernel failed: cudaError_t {err}")
    return (y, dots) if selfdot else y


def _launch_wp(x, w, tables, selfdot: bool):
    """Kernel B-5 on a (B, W, i0, i1) stack with w (W, L0, L1), on CUDA
    tensors: checks, allocates every output and scratch buffer with
    torch.empty, launches on the current stream, raises on a non-zero
    cudaError_t.  The caller counts the launch."""
    q0a, q1a, q0s, q1s, (i0, i1), (o0, o1) = tables
    L0, L1 = w.shape[-2:]
    B, W = x.shape[:2]
    _check_operands(x, w)
    lib = _lib()
    if lib.mxu2d_middle_smem_bytes(i0, L0) > _SMEM_LIMIT:
        raise ValueError(f"input rows {i0} and embedded rows {L0} need more "
                         "shared memory than one block has")
    if lib.mxu2d_row_tiles(B, W, i0, o0) > _GRID_Y_LIMIT:
        raise ValueError(f"{B * W} planes of {max(i0, o0)} rows are more than "
                         "one launch of the row GEMM covers; split the batch")
    dev = x.device
    y = torch.empty((B, W, o0, o1), dtype=torch.float32, device=dev)
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
        err = lib.mxu2d_sandwich_wp(*ptrs, B, W, i0, i1, L0, L1, o0, o1, stream)
    if err != 0:
        raise RuntimeError(f"mxu2d sandwich kernel failed: cudaError_t {err}")
    return (y, dots) if selfdot else y


def _check_shapes(x, w, i_shape, edims):
    if x.ndim != 3 or tuple(x.shape[1:]) != tuple(i_shape):
        raise ValueError(f"x must be (B, {i_shape[0]}, {i_shape[1]}), got "
                         f"{tuple(x.shape)}")
    if w.ndim != 2 or tuple(w.shape) != tuple(edims):
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
        ctx.save_for_backward(x, w)
        ctx.crops = (dims, edims, in_expanded, out_expanded)
        if x.device.type == "cpu":
            tables = _tables(dims, edims, in_expanded, out_expanded, x.dtype, x.device)
            return sandwich_plain(x, w, *tables[:4])
        y = _launch_fft(x, w, _crops(dims, edims, in_expanded, out_expanded)[1],
                        selfdot=False)
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
    _check_shapes(x, w, _crops(dims, edims, in_expanded, out_expanded)[0], edims)
    return _Sandwich.apply(x, w, dims, edims, in_expanded, out_expanded)


def sandwich_apply_selfdot(x: torch.Tensor, w: torch.Tensor,
                           dims: Tuple[int, int], edims: Tuple[int, int]):
    """Cropped in/out sandwich plus the per-sample self-dot: returns
    (y, dots) with dots[b] = sum(x[b] * y[b])."""
    dims, edims = tuple(dims), tuple(edims)
    _check_shapes(x, w, dims, edims)
    if x.device.type == "cpu":
        tables = _tables(dims, edims, False, False, x.dtype, x.device)
        return sandwich_plain(x, w, *tables[:4], selfdot=True)
    if needs_grad(x, w):
        raise no_backward("the self-dot sandwich (solver-internal)")
    out = _launch_fft(x, w, dims, selfdot=True)
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
    out = _launch_wp(x, w, tables, selfdot=selfdot)
    LAUNCHES["sandwich_apply_wp_selfdot" if selfdot else "sandwich_apply_wp"] += 1
    return out
