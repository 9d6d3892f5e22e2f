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
outer axis included, in one launch (:func:`sandwich_apply_wp3`): a
cluster-resident FFT sandwich, the sample's half spectrum spread over the
shared memory of a thread-block cluster of :data:`WP3_CLUSTER` CTAs, each
packed minor-axis column transformed as a (j0, j1) slab over distributed
shared memory (its plan, twiddles and gate here; its numpy model in
`tests/test_torch_wp3_plan.py`).  Its plain version is the same outer
contraction + `sandwich_wp_plain` + outer contraction.  :data:`USE_WP3`
chooses which of the two carries the PCG applies, by measurement on the card
(`PERF.md`); a shape B-6's gate refuses goes to the outer products and B-5.

Axis order matters: callers permute so that the smallest embedded axis is the
outer axis (:func:`best_perm`), once per solve, never per apply
(`solve._mxu3d_solver`).
"""
from __future__ import annotations

import ctypes
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from .bttb import _real_fourier_basis, fp32_matmul, needs_grad, no_backward
from .mxu2d import _SMEM_LIMIT, _tables, sandwich_apply_wp, sandwich_wp_plain

__all__ = ["sandwich_apply_3d", "sandwich_apply_3d_selfdot", "sandwich_apply_wp3",
           "sandwich_wp3_plain", "best_perm", "USE_WP3", "LAUNCHES",
           "reset_launches"]

# Kernel B-6 carries the 3-D PCG self-dot applies when True (and the shape
# passes _wp3_ok); else the outer products + kernel B-5 do.  Set from the
# measurement of both at the dust map's self-dot shape, (512, 32, 64, 64)
# through (64, 128, 128), in turns by chip_smoke.py [kernels-3d] on an NVIDIA
# H100 80GB HBM3 at 700.00 W: B-6 2.63 ms against 3.93 ms for the two outer
# products and B-5 (a dust-map natgrad step 174.4 against 229.0 ms,
# profile_domain_step.py).
USE_WP3 = True
# launches of kernel B-6; a plain-version call counts nothing
LAUNCHES: Dict[str, int] = {"sandwich_apply_wp3": 0}
# CTAs of one thread-block cluster: one sample's half spectrum lies across
# their shared memory (csrc/mxu3d.cu, CL)
WP3_CLUSTER = 8
# the embedded (W, L1, L2) the kernel is built for (csrc/mxu3d.cu,
# WP3_FOR_EACH_SHAPE), and the register-radix split L = R1 * R2 of each axis
# length (its Rad<L>)
_WP3_SHAPES = ((64, 128, 128), (64, 64, 128), (32, 64, 64), (16, 32, 32))
_WP3_RADICES = {16: (4, 4), 32: (8, 4), 64: (8, 8), 128: (16, 8)}
# a bound on the kernel's static shared memory (the per-warp dot partials
# and the CTA's partial dot: 80 bytes by ptxas on sm_90a)
_WP3_STATIC_SMEM = 1024
# the number of clusters a launch may keep resident, per (edims, dims[:2],
# device), from cudaOccupancyMaxActiveClusters (the persistent grid's size)
_ACTIVE_CLUSTERS: Dict[tuple, int] = {}
_TABLES: Dict[tuple, torch.Tensor] = {}
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
    the outer axis).  Returns (B, o0, o1, o2): outer products and kernel B-5;
    differentiable in x and w (autograd through the products, B-5's
    backward for the planes)."""
    L0 = edims[0]
    i0 = L0 if in_expanded else dims[0]
    o0 = L0 if out_expanded else dims[0]
    Q0 = _real_fourier_basis(L0, x.dtype, x.device)
    u = _outer_contract(x, Q0[:i0])                       # (B, L0, i1, i2)
    b2 = sandwich_apply_wp(u, w, tuple(dims[1:]), tuple(edims[1:]),
                           in_expanded=in_expanded, out_expanded=out_expanded)
    return _outer_contract(b2, Q0[:o0].T)                  # (B, o0, o1, o2)


def wp3_radices(L: int) -> Tuple[int, int]:
    """(R1, R2) of kernel B-6's two register-radix steps for an axis of
    length L = R1 * R2 (the first step's radix R1)."""
    return _WP3_RADICES[L]


def _wp3_col_stride(rows: int) -> int:
    """Float2 stride of one packed column of the resident half spectrum:
    ``rows`` rounded up to 2 mod 16 (csrc/mxu3d.cu, col_stride)."""
    return rows + (18 - rows % 16) % 16


def _wp3_row_stride(L: int) -> int:
    """Float2 stride of one transform row of length L in the working buffer:
    a pad after every 16, rounded up to 8 mod 16 (csrc/mxu3d.cu,
    row_stride)."""
    base = L + L // 16
    return base + (24 - base % 16) % 16


def _wp3_smem_bytes(dims, edims) -> int:
    """`mxu3d_wp3_smem_bytes` of ``csrc/mxu3d.cu``, in Python so that the
    gate needs no build: each CTA's share of the packed half spectrum
    (L2/2 columns of ceil(d0/8) planes of d1 rows), the working buffer of
    one (W, L1) slab and the three axes' twiddle tables, in float2."""
    (d0, d1, _), (W, L1, L2) = dims, edims
    rows = -(-d0 // WP3_CLUSTER) * d1
    return 8 * ((L2 // 2) * _wp3_col_stride(rows) + W * _wp3_row_stride(L1) + W + L1 + L2)


def _wp3_ok(dims, edims, dtype) -> bool:
    """Kernel B-6's gate: float32, an embedding the kernel is built for,
    every axis's data at most half its embedded length (the pruned first
    and last steps), and the CTA's share of the sample in one block's
    shared memory."""
    if dtype != torch.float32 or tuple(edims) not in _WP3_SHAPES:
        return False
    if any(not 1 <= d <= L // 2 for d, L in zip(dims, edims)):
        return False
    return _wp3_smem_bytes(dims, edims) <= _SMEM_LIMIT - _WP3_STATIC_SMEM


def _wp3_twiddles_np(L: int) -> np.ndarray:
    """e^{-2 pi i m / L} for m < L, built in float64: the twiddles of
    kernel B-6's steps on an axis of length L."""
    return np.exp(-2j * np.pi * np.arange(L) / L)


def _wp3_tables(edims, device) -> torch.Tensor:
    """The twiddles of the W, L1 and L2 axes, one after the other, as the
    kernel reads them: interleaved (re, im) float32 pairs, built in float64
    and rounded once; cached per embedding and device."""
    key = (tuple(edims), str(device))
    if key not in _TABLES:
        tw = np.concatenate([_wp3_twiddles_np(L) for L in edims])
        pairs = np.stack([tw.real, tw.imag], axis=-1).reshape(-1)
        _TABLES[key] = torch.as_tensor(pairs, dtype=torch.float32).to(device)
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


def _bind(lib):
    """Sets the argument and result types of a build of ``csrc/mxu3d.cu``."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mxu3d_wp3.argtypes = [p] * 6 + [i] * 8 + [p]
    lib.mxu3d_wp3.restype = ctypes.c_int
    lib.mxu3d_wp3_max_clusters.argtypes = [i] * 5 + [p]
    lib.mxu3d_wp3_max_clusters.restype = ctypes.c_int
    lib.mxu3d_wp3_smem_bytes.argtypes = [i] * 5
    lib.mxu3d_wp3_smem_bytes.restype = ctypes.c_size_t
    lib.mxu3d_wp3_weight_floats.argtypes = [i] * 3
    lib.mxu3d_wp3_weight_floats.restype = ctypes.c_size_t
    return lib


def _lib():
    global _LIB
    if _LIB is None:
        from .. import _build

        _LIB = _bind(_build.load("mxu3d"))
    return _LIB


def _wp3_clusters(dims, edims, device) -> int:
    """The clusters of kernel B-6 that the card keeps resident at once
    (cudaOccupancyMaxActiveClusters), asked once per shape and device; the
    persistent grid has at most this many."""
    key = (tuple(edims), tuple(dims[:2]), str(device))
    if key not in _ACTIVE_CLUSTERS:
        n = ctypes.c_int(0)
        with torch.cuda.device(device):
            err = _lib().mxu3d_wp3_max_clusters(*dims[:2], *edims, ctypes.byref(n))
        if err != 0 or n.value < 1:
            raise RuntimeError(f"mxu3d wp3 occupancy query failed: cudaError_t {err}, "
                               f"{n.value} clusters")
        _ACTIVE_CLUSTERS[key] = n.value
    return _ACTIVE_CLUSTERS[key]


def _launch_wp3(x, w, dims, edims, selfdot: bool):
    """Kernel B-6 on CUDA tensors: checks, allocates the output, the dots
    and the weights laid out by group with torch.empty, launches on the current
    stream, raises on a non-zero cudaError_t."""
    for name, t in (("x", x), ("w", w)):
        if t.dtype != torch.float32:
            raise TypeError(f"wp3 kernel takes float32 {name}, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"wp3 kernel needs a contiguous {name}")
    if not _wp3_ok(dims, edims, x.dtype):
        raise ValueError(f"dims {tuple(dims)} / embedded {tuple(edims)}: not a shape "
                         "kernel B-6 is built for")
    B = x.shape[0]
    lib = _lib()
    dev = x.device
    clusters = min(B, _wp3_clusters(dims, edims, dev))
    tables = _wp3_tables(edims, dev)
    y = torch.empty_like(x)
    dots = torch.empty((B,), dtype=torch.float32, device=dev) if selfdot else None
    wq = torch.empty((lib.mxu3d_wp3_weight_floats(*edims),), dtype=torch.float32,
                     device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.mxu3d_wp3(x.data_ptr(), w.data_ptr(), tables.data_ptr(), wq.data_ptr(),
                            y.data_ptr(), None if dots is None else dots.data_ptr(),
                            B, *dims, *edims, clusters, stream)
    if err != 0:
        raise RuntimeError(f"mxu3d wp3 kernel failed: cudaError_t {err}")
    LAUNCHES["sandwich_apply_wp3"] += 1
    return (y, dots) if selfdot else y


def sandwich_apply_wp3(x: torch.Tensor, w: torch.Tensor, dims, edims,
                       selfdot: bool = False):
    """The whole cropped 3-D sandwich of each sample of a (B, d0, d1, d2)
    stack with the (W, L1, L2) spectrum w; with ``selfdot`` also
    dots[b] = <x[b], y[b]>.  Kernel B-6 on a CUDA tensor, its plain version
    on a CPU tensor.  Solver-internal: a required gradient raises, as the
    JAX package gives it no backward."""
    if x.ndim != 4 or tuple(x.shape[1:]) != tuple(dims):
        raise ValueError(f"x must be (B, {', '.join(map(str, dims))}), got "
                         f"{tuple(x.shape)}")
    if tuple(w.shape) != tuple(edims):
        raise ValueError(f"w must be the full {tuple(edims)} spectrum, got "
                         f"{tuple(w.shape)}")
    if needs_grad(x, w):
        raise no_backward("the whole-sample sandwich (kernel B-6)")
    if x.device.type == "cpu":
        return sandwich_wp3_plain(x, w, dims, edims, selfdot=selfdot)
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
