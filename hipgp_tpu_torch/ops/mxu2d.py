"""The cropped 2-D sandwich y = P_o (Q0 x Q1) diag(w) (Q0 x Q1)^T P_i^T x.

Counterpart of `hipgp_tpu/ops/mxu2d.py` (`sandwich_apply`,
`sandwich_apply_selfdot`).  The hot op of every PCG iteration on a 2-D
inducing grid is this real-eigenbasis sandwich per sample: two analysis
contractions, an elementwise scale by the full (L0, L1) spectrum w, two
synthesis contractions.  With rectangular tables (Q[:d] per axis) the
circulant padding is never materialised on input or output.  The self-dot
variant also returns dots[b] = <x[b], y[b]>: both PCG inner products
(p . Ap and r . C^{-1} r) are self-dots of an apply.

Two implementations of the same function live here:

* kernel A, ``csrc/mxu2d.cu``, hand-written CUDA for Hopper, launched for a
  tensor on a CUDA device (f32 only; anything else raises);
* its plain PyTorch version, :func:`sandwich_plain`, the einsum chain of
  `bttb._apply_spectrum_matmul` over the same rectangular tables, taken only
  for a tensor on the CPU.

Each wrapper counts its kernel launches in :data:`LAUNCHES`.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from .bttb import _real_fourier_basis

__all__ = ["sandwich_apply", "sandwich_apply_selfdot", "sandwich_plain",
           "LAUNCHES", "MXU2D_MAX_LEN", "reset_launches"]

# largest embedded axis the kernel path is used for (the solver gate)
MXU2D_MAX_LEN = 512
# launches of kernel A, per wrapper; a plain-version call counts nothing
LAUNCHES: Dict[str, int] = {"sandwich_apply": 0, "sandwich_apply_selfdot": 0}
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
    u = torch.matmul(x, q1a)          # (B, i0, L1)
    a = torch.matmul(q0a, u) * w      # (B, L0, L1)
    c = torch.matmul(q0s, a)          # (B, o0, L1)
    y = torch.matmul(c, q1s)          # (B, o0, o1)
    if selfdot:
        return y, torch.sum(x * y, dim=(1, 2))
    return y


def _lib():
    global _LIB
    if _LIB is None:
        from .. import _build

        lib = _build.load("mxu2d")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.mxu2d_sandwich.argtypes = [p] * 11 + [i] * 7 + [p]
        lib.mxu2d_sandwich.restype = ctypes.c_int
        lib.mxu2d_middle_smem_bytes.argtypes = [i, i]
        lib.mxu2d_middle_smem_bytes.restype = ctypes.c_size_t
        lib.mxu2d_partial_floats.argtypes = [i, i, i]
        lib.mxu2d_partial_floats.restype = ctypes.c_size_t
        _LIB = lib
    return _LIB


def _launch(x, w, tables, selfdot: bool):
    """Kernel A on CUDA tensors: checks, allocates every output and scratch
    buffer with torch.empty, launches on the current stream, raises on a
    non-zero cudaError_t."""
    q0a, q1a, q0s, q1s, (i0, i1), (o0, o1) = tables
    L0, L1 = w.shape
    B = x.shape[0]
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
    dev = x.device
    y = torch.empty((B, o0, o1), dtype=torch.float32, device=dev)
    u = torch.empty((i0 * B * L1,), dtype=torch.float32, device=dev)
    c = torch.empty((o0 * B * L1,), dtype=torch.float32, device=dev)
    if selfdot:
        dots = torch.empty((B,), dtype=torch.float32, device=dev)
        partial = torch.empty((lib.mxu2d_partial_floats(B, o0, o1),),
                              dtype=torch.float32, device=dev)
        dots_p, partial_p = dots.data_ptr(), partial.data_ptr()
    else:
        dots = None
        dots_p = partial_p = None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mxu2d_sandwich(
            x.data_ptr(), q0a.data_ptr(), q1a.data_ptr(), q0s.data_ptr(),
            q1s.data_ptr(), w.data_ptr(), y.data_ptr(), dots_p, u.data_ptr(),
            c.data_ptr(), partial_p, B, i0, i1, L0, L1, o0, o1, stream)
    if err != 0:
        raise RuntimeError(f"mxu2d sandwich kernel failed: cudaError_t {err}")
    LAUNCHES["sandwich_apply_selfdot" if selfdot else "sandwich_apply"] += 1
    return (y, dots) if selfdot else y


def _check_shapes(x, w, tables):
    i_shape, o_shape = tables[4], tables[5]
    if x.ndim != 3 or tuple(x.shape[1:]) != i_shape:
        raise ValueError(f"x must be (B, {i_shape[0]}, {i_shape[1]}), got "
                         f"{tuple(x.shape)}")
    if w.ndim != 2 or w.shape[0] != tables[0].shape[0] or w.shape[1] != tables[1].shape[1]:
        raise ValueError(f"w must be the full (L0, L1) spectrum, got {tuple(w.shape)}")


def sandwich_apply(x: torch.Tensor, w: torch.Tensor, dims: Tuple[int, int],
                   edims: Tuple[int, int], *, in_expanded: bool = False,
                   out_expanded: bool = False) -> torch.Tensor:
    """y[b] = P_o (Q0 x Q1) diag(w) (Q0 x Q1)^T P_i^T x[b].

    x: (B, i0, i1) with (i0, i1) = ``edims`` when ``in_expanded`` else
    ``dims``; w: (L0, L1) full spectrum (`bttb._full_weights` layout).
    Returns (B, o0, o1).  Kernel A on a CUDA tensor, the plain version on
    a CPU tensor."""
    tables = _tables(dims, edims, bool(in_expanded), bool(out_expanded),
                     x.dtype, x.device)
    _check_shapes(x, w, tables)
    if x.device.type == "cpu":
        return sandwich_plain(x, w, *tables[:4])
    return _launch(x, w, tables, selfdot=False)


def sandwich_apply_selfdot(x: torch.Tensor, w: torch.Tensor,
                           dims: Tuple[int, int], edims: Tuple[int, int]):
    """Cropped in/out sandwich plus the per-sample self-dot: returns
    (y, dots) with dots[b] = sum(x[b] * y[b])."""
    tables = _tables(dims, edims, False, False, x.dtype, x.device)
    _check_shapes(x, w, tables)
    if x.device.type == "cpu":
        return sandwich_plain(x, w, *tables[:4], selfdot=True)
    return _launch(x, w, tables, selfdot=True)
