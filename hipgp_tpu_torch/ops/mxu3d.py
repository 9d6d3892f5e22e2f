"""The cropped 3-D sandwich y = P_o (Q0 x Q1 x Q2) diag(w) (.)^T P_i^T x.

Counterpart of `hipgp_tpu/ops/mxu3d.py`.  The 3-D whitening and PCG applies
(the inter-domain dust map, paper section 5.5) are Kronecker sandwiches over
(d0, d1, d2) sample volumes.  They are factored through the outer axis:

* the outer-axis analysis and synthesis are large plain products over the
  leading axis (:func:`_outer_contract`, ``torch.matmul`` in full FP32, as
  the JAX package leaves them to XLA outside any Pallas kernel);
* after the outer analysis the operator is block-diagonal over l0, so each
  (d1, d2) plane sees its own 2-D sandwich with spectrum w[l0]: the
  weight-plane kernel B-5 (`mxu2d.sandwich_apply_wp`) runs all B * L0 plane
  problems, and its self-dots sum over the planes to the full 3-D inner
  product (Q0 is orthonormal).

Kernel B-6 (``csrc/mxu3d.cu``) instead runs the whole sandwich of one sample,
outer axis included, in one launch (:func:`sandwich_apply_wp3`); its plain
version is the same outer contraction + `sandwich_wp_plain` + outer
contraction.  :data:`USE_WP3` chooses which of the two carries the PCG
applies, by measurement on the card (`PERF.md`).

Axis order matters: callers permute so that the smallest embedded axis is the
outer axis (:func:`best_perm`), once per solve, never per apply
(`solve._mxu3d_solver`).
"""
from __future__ import annotations

import ctypes
from typing import Dict, Sequence, Tuple

import torch

from .bttb import _real_fourier_basis, fp32_matmul, needs_grad, no_backward
from .mxu2d import _SMEM_LIMIT, _tables, sandwich_apply_wp, sandwich_wp_plain

__all__ = ["sandwich_apply_3d", "sandwich_apply_3d_selfdot", "sandwich_apply_wp3",
           "sandwich_wp3_plain", "best_perm", "USE_WP3", "LAUNCHES",
           "reset_launches"]

# Kernel B-6 carries the 3-D PCG self-dot applies when True (and the shape
# passes _wp3_ok); else the outer products + kernel B-5 do.  Set from the
# measurement of both at the dust map's self-dot shape, (512, 32, 64, 64)
# through (64, 128, 128), by chip_smoke.py [kernels-3d] on an H100 80GB HBM3
# at 700 W: B-6 13.64 ms against 11.65 ms for the two outer products and B-5
# (B-6 does 8 % less work but its outer-axis phases run narrow 128 x 64 and
# 128 x 32 tiles).
USE_WP3 = False
# launches of kernel B-6; a plain-version call counts nothing
LAUNCHES: Dict[str, int] = {"sandwich_apply_wp3": 0}
# persistent blocks of B-6 per SM (its launch bounds)
_WP3_BLOCKS_PER_SM = 2
_TABLES: Dict[tuple, tuple] = {}
_LIB = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def best_perm(edims: Sequence[int]) -> Tuple[int, ...]:
    """Axis permutation for the 3-D path: embedded lengths ascending, so the
    outer axis is the smallest (the shallow z axis of an (nx, nx, nz) dust
    grid) and the largest is the minor axis.  Stable for ties."""
    return tuple(sorted(range(len(edims)), key=lambda a: edims[a]))


def _outer_contract(x: torch.Tensor, Q: torch.Tensor) -> torch.Tensor:
    """Contract axis 1 of (B, a, j, k) with Q[a, out], the axis kept in
    place: one batched product (out, a) . (a, j*k) per sample."""
    B, a = x.shape[:2]
    with fp32_matmul():
        y = torch.matmul(Q.T, x.reshape(B, a, -1))
    return y.reshape((B, Q.shape[1]) + tuple(x.shape[2:]))


def sandwich_apply_3d(x: torch.Tensor, w: torch.Tensor, dims, edims, *,
                      in_expanded: bool = False,
                      out_expanded: bool = False) -> torch.Tensor:
    """y[b] = P_o (Q0 x Q1 x Q2) diag(w) (.)^T P_i^T x[b].

    x: (B, i0, i1, i2) with i = ``edims`` when ``in_expanded`` else
    ``dims``; w: (L0, L1, L2) full spectrum in the same axis order (axis 0 is
    the outer axis).  Returns (B, o0, o1, o2): outer products and kernel B-5."""
    L0 = edims[0]
    i0 = L0 if in_expanded else dims[0]
    o0 = L0 if out_expanded else dims[0]
    Q0 = _real_fourier_basis(L0, x.dtype, x.device)
    u = _outer_contract(x, Q0[:i0])                       # (B, L0, i1, i2)
    b2 = sandwich_apply_wp(u, w, tuple(dims[1:]), tuple(edims[1:]),
                           in_expanded=in_expanded, out_expanded=out_expanded)
    return _outer_contract(b2, Q0[:o0].T)                  # (B, o0, o1, o2)


def _wp3_ok(dims, edims, dtype) -> bool:
    """Kernel B-6's gate: float32, and its middle pass's slab of the d1 input
    rows and the L1 embedded rows fits one block's shared memory."""
    if dtype != torch.float32:
        return False
    return _wp3_smem_bytes(dims[1], edims[1]) <= _SMEM_LIMIT


def _wp3_smem_bytes(d1: int, L1: int) -> int:
    """`mxu3d_wp3_smem_bytes` of ``csrc/mxu3d.cu``, in Python so that the
    gate needs no build."""
    r8 = lambda n: -(-n // 8) * 8
    tile = 8 * (128 + 4)
    return 4 * max(4 * tile, (r8(d1) + r8(L1)) * 64 + 2 * tile)


def _wp3_tables(dims, edims, dtype, device):
    """B-6's rectangular tables (q1a, q0os, q0oa, q0a, q0s, q1s), contiguous,
    cached per shape, dtype and device."""
    key = (tuple(dims), tuple(edims), dtype, str(device))
    if key not in _TABLES:
        (d0, d1, d2), (W, L1, L2) = dims, edims
        Q0 = _real_fourier_basis(W, dtype, device)
        Q1 = _real_fourier_basis(L1, dtype, device)
        Q2 = _real_fourier_basis(L2, dtype, device)
        _TABLES[key] = tuple(t.contiguous() for t in (
            Q2[:d2], Q0[:d0], Q0[:d0].T, Q1[:d1].T, Q1[:d1], Q2[:d2].T))
    return _TABLES[key]


def sandwich_wp3_plain(x, w, dims, edims, selfdot: bool = False):
    """B-6's plain version: the outer analysis, the plain weight-plane
    sandwich, the outer synthesis; with ``selfdot`` also the per-sample dots
    summed over the planes."""
    d0, W = dims[0], edims[0]
    Q0 = _real_fourier_basis(W, x.dtype, x.device)
    t = _tables(tuple(dims[1:]), tuple(edims[1:]), False, False, x.dtype, x.device)
    u = _outer_contract(x, Q0[:d0])
    out = sandwich_wp_plain(u, w, *t[:4], selfdot=selfdot)
    b2 = out[0] if selfdot else out
    y = _outer_contract(b2, Q0[:d0].T)
    return (y, out[1]) if selfdot else y


def _lib():
    global _LIB
    if _LIB is None:
        from .. import _build

        lib = _build.load("mxu3d")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.mxu3d_wp3.argtypes = [p] * 11 + [i] * 8 + [p]
        lib.mxu3d_wp3.restype = ctypes.c_int
        lib.mxu3d_wp3_scratch_floats.argtypes = [i] * 5
        lib.mxu3d_wp3_scratch_floats.restype = ctypes.c_size_t
        _LIB = lib
    return _LIB


def _launch_wp3(x, w, dims, edims, selfdot: bool):
    """Kernel B-6 on CUDA tensors: checks, allocates the output, the dots
    and the scratch with torch.empty, launches on the current stream, raises
    on a non-zero cudaError_t."""
    for name, t in (("x", x), ("w", w)):
        if t.dtype != torch.float32:
            raise TypeError(f"wp3 kernel takes float32 {name}, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"wp3 kernel needs a contiguous {name}")
    if not _wp3_ok(dims, edims, x.dtype):
        raise ValueError(f"dims {tuple(dims)} / embedded {tuple(edims)} need more "
                         "shared memory than one block has")
    (d0, d1, d2), (W, L1, L2) = dims, edims
    B = x.shape[0]
    lib = _lib()
    dev = x.device
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    blocks = max(1, min(B, _WP3_BLOCKS_PER_SM * sms))
    tables = _wp3_tables(dims, edims, x.dtype, dev)
    y = torch.empty_like(x)
    dots = torch.empty((B,), dtype=torch.float32, device=dev) if selfdot else None
    scratch = torch.empty((lib.mxu3d_wp3_scratch_floats(blocks, d0, d1, W, L2),),
                          dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mxu3d_wp3(x.data_ptr(), *(t.data_ptr() for t in tables), w.data_ptr(),
                            y.data_ptr(), None if dots is None else dots.data_ptr(),
                            scratch.data_ptr(), B, d0, d1, d2, W, L1, L2, blocks, stream)
    if err != 0:
        raise RuntimeError(f"mxu3d wp3 kernel failed: cudaError_t {err}")
    LAUNCHES["sandwich_apply_wp3"] += 1
    return (y, dots) if selfdot else y


def sandwich_apply_wp3(x: torch.Tensor, w: torch.Tensor, dims, edims,
                       selfdot: bool = False):
    """The whole cropped 3-D sandwich of each sample of a (B, d0, d1, d2)
    stack with the (W, L1, L2) spectrum w; with ``selfdot`` also
    dots[b] = <x[b], y[b]>.  Kernel B-6 on a CUDA tensor, its plain version
    on a CPU tensor."""
    if x.ndim != 4 or tuple(x.shape[1:]) != tuple(dims):
        raise ValueError(f"x must be (B, {', '.join(map(str, dims))}), got "
                         f"{tuple(x.shape)}")
    if tuple(w.shape) != tuple(edims):
        raise ValueError(f"w must be the full {tuple(edims)} spectrum, got "
                         f"{tuple(w.shape)}")
    if x.device.type == "cpu":
        return sandwich_wp3_plain(x, w, dims, edims, selfdot=selfdot)
    if needs_grad(x, w):
        raise no_backward("kernel B-6")
    return _launch_wp3(x, w, tuple(dims), tuple(edims), selfdot)


def sandwich_apply_3d_selfdot(x: torch.Tensor, w: torch.Tensor, dims, edims):
    """Cropped in and out 3-D sandwich plus the per-sample self-dot:
    (y, dots) with dots[b] = sum(x[b] * y[b]), through kernel B-6 when
    :data:`USE_WP3` is set and its gate passes, else the outer products and
    kernel B-5 (whose per-plane dots sum to the 3-D inner product because Q0
    is orthonormal: <x, Q0 b> = <Q0^T x, b>)."""
    if USE_WP3 and _wp3_ok(dims, edims, x.dtype):
        return sandwich_apply_wp3(x, w, dims, edims, selfdot=True)
    d0, L0 = dims[0], edims[0]
    Q0 = _real_fourier_basis(L0, x.dtype, x.device)
    u = _outer_contract(x, Q0[:d0])
    b2, dots = sandwich_apply_wp(u, w, tuple(dims[1:]), tuple(edims[1:]),
                                 selfdot=True)
    return _outer_contract(b2, Q0[:d0].T), dots
