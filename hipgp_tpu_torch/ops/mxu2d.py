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
  kernel B-5, ``csrc/sandwich_wp.cu``, the plane-resident FFT sandwich (one
  block per plane, radix-16/8/4/2/3/5 butterflies, `wp_fft_plan`), with kernel
  A's three passes and a plane index for planes that do not fit one block
  (`_wp_route`);
* their plain PyTorch versions, :func:`sandwich_plain` and
  :func:`sandwich_wp_plain`, the einsum chain of
  `bttb._apply_spectrum_matmul` over the same rectangular tables, taken only
  for a tensor on the CPU.

Both kernels compute the sandwich through the DFT of the zero-padded plane
(kernel A: one Cooley-Tukey step per axis, `fft_plan`): for a w even in each
axis, as the solver's spectra are, that is
crop(irfft2(w[:, :L1/2+1] * rfft2(pad(x)))); their scale steps also apply w's
odd parts, as the real basis does, so each is the sandwich for any w.

Each wrapper counts its kernel launches in :data:`LAUNCHES`.

:func:`sandwich_apply` is differentiable in x and w (a
``torch.autograd.Function``, the JAX package's `_get_sandwich` custom VJP):
the operator is linear in x and its pullback is the same sandwich with the
two crops swapped (P_i and P_o exchange; diag(w) and Q are symmetric), so gx
is kernel A again on a CUDA tensor; gw = sum_b analysis(x_b) * analysis(g_b)
is plain PyTorch, as in JAX.  :func:`sandwich_apply_wp` without the self-dot
is differentiable the same way, per plane (the JAX package's
`_get_sandwich_wp`): gx is kernel B-5 with the crops swapped, gw[l] =
sum_b analysis(x_bl) * analysis(g_bl).  The self-dot variants are
solver-internal and not differentiable, as in JAX: a required gradient
raises there.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Tuple

import numpy as np
import torch

from .bttb import _real_fourier_basis, fp32_matmul, needs_grad, no_backward

__all__ = ["sandwich_apply", "sandwich_apply_selfdot", "sandwich_plain",
           "sandwich_apply_wp", "sandwich_wp_plain", "fft_plan", "wp_fft_plan",
           "LAUNCHES", "MXU2D_MAX_LEN", "reset_launches"]

# largest embedded axis the kernel path is used for (the solver gate)
MXU2D_MAX_LEN = 512
# launches of kernels A and B-5, per wrapper; a plain-version call counts nothing
LAUNCHES: Dict[str, int] = {"sandwich_apply": 0, "sandwich_apply_selfdot": 0,
                            "sandwich_apply_wp": 0, "sandwich_apply_wp_selfdot": 0}
# largest factor of kernel A's one-step Cooley-Tukey split (csrc/sandwich_fft.cu)
_FFT_MAX_FACTOR = 32
# shared memory one block may use on the card (sm_90)
_SMEM_LIMIT = 232448
# B-5's resident route (csrc/sandwich_wp.cu): the static shared memory of its
# kernel (the dots reduction's NT floats), the stages a plan may have, and
# the transform buffer it is given where the whole of a row or column pass
# needs more (in float2: 33 rows of 128, 33 KB)
_WP_STATIC_SMEM = 256 * 4
_WP_MAX_STAGES = 8
_WP_BUFFER = 33 * 128
_TABLES: Dict[tuple, tuple] = {}
_FFT_TABLES: Dict[tuple, torch.Tensor] = {}
_WP_TABLES: Dict[tuple, torch.Tensor] = {}
_WP_LIB = None
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


def plans_ok(edims, wp: bool = False) -> bool:
    """True when kernel A (and, with ``wp``, kernel B-5) has a plan for every
    embedded axis: every {2,3,5}-smooth length <= 512 has one, a minimal
    2m - 2 embedding (``make_spectrum(pad_to_fast=False)``) may not."""
    try:
        for L in edims:
            fft_plan(L)
            if wp:
                wp_fft_plan(L)
    except ValueError:
        return False
    return True


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


def wp_fft_plan(L: int) -> Tuple[int, ...]:
    """Kernel B-5's radices of a length-L DFT (csrc/sandwich_wp.cu), the
    first stage first: the power of two in as few stages as radices 16, 8, 4
    and 2 allow (16s first; 2^5 as 8 * 4), then the 3s and the 5s, so that
    an even radix leads wherever L is even (the pruned first stage runs the
    half butterfly there); (1,) for L = 1.  Raises for a length that is not
    {2,3,5}-smooth or needs more stages than the kernel takes."""
    n, counts = L, {}
    for f in (2, 3, 5):
        counts[f] = 0
        while n > 1 and n % f == 0:
            n //= f
            counts[f] += 1
    if n != 1 or L < 1:
        raise ValueError(f"length {L} is not {{2,3,5}}-smooth; kernel B-5 does not take it")
    q, r = divmod(counts[2], 4)
    twos = ([16] * (q - 1) + [8, 4] if r == 1 and q else
            [16] * q + {0: [], 1: [2], 2: [4], 3: [8]}[r])
    radices = twos + [3] * counts[3] + [5] * counts[5]
    if len(radices) > _WP_MAX_STAGES:
        raise ValueError(f"length {L} needs {len(radices)} butterfly stages; kernel B-5 "
                         f"takes at most {_WP_MAX_STAGES}")
    return tuple(radices) or (1,)


def _wp_positions(L: int, radices) -> np.ndarray:
    """Where the forward transform of kernel B-5 (decimation in frequency,
    in place, `radices` first stage first) leaves each frequency: position
    p = sum_t k_t L / (R_1 ... R_t) holds frequency k_1 + R_1 k_2 +
    R_1 R_2 k_3 + ...; returns pos[frequency]."""
    p = np.arange(L)
    rem, freq, mult, span = p.copy(), np.zeros(L, dtype=np.int64), 1, L
    for R in radices:
        span //= R
        freq += (rem // span) * mult
        rem %= span
        mult *= R
    pos = np.empty(L, dtype=np.int64)
    pos[freq] = p
    return pos


def _wp_table_np(L: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Kernel B-5's table of a length L: the twiddles e^{-2 pi i m / L},
    m < L, in complex128, the position of each frequency after its forward
    transform (`_wp_positions` of `wp_fft_plan`) and the frequency at each
    position."""
    tw = np.exp(-2j * np.pi * np.arange(L) / L)
    pos = _wp_positions(L, wp_fft_plan(L))
    return tw, pos, np.argsort(pos)


def _wp_tables(L: int, device) -> torch.Tensor:
    """:func:`_wp_table_np` as the kernel reads it, 4 L float32: the
    twiddles as interleaved (re, im) pairs, the positions, the frequencies;
    cached per length and device."""
    key = (L, str(device))
    if key not in _WP_TABLES:
        tw, pos, freq = _wp_table_np(L)
        flat = np.concatenate([np.stack([tw.real, tw.imag], axis=-1).ravel(),
                               pos, freq]).astype(np.float32)
        _WP_TABLES[key] = torch.as_tensor(flat).to(device).contiguous()
    return _WP_TABLES[key]


def _wp_resident_smem(L0: int, L1: int, SR: int, SH: int, WB: int) -> int:
    """`wp_resident_smem_bytes` of csrc/sandwich_wp.cu: the two tables
    (4 L floats each), SR x SH float2 of resident plane, WB float2 of
    transform buffer."""
    return 16 * (L0 + L1) + 8 * (SR * SH + WB)


def _wp_route(i_shape, edims, o_shape):
    """Kernel B-5's route for a crop, by the shape alone: ``("resident",
    layout)`` where the resident half spectrum (max(i0, o0) rows of
    (L1 + 1) // 2 columns, bins 0 and L1/2 packed in column 0), the tables
    and a buffer of at least one transform fit
    one block's shared memory (csrc/sandwich_wp.cu), else
    ``("three-pass", None)`` (kernel A's passes with a plane index,
    csrc/sandwich_fft.cu).  The layout: the transform buffer WB (float2; the
    row passes whole where they fit `_WP_BUFFER`), the columns per group G and
    the input and output row pairs per group RGi, RGo (each group's
    transforms times their odd stride fit WB, the groups balanced), the
    shared memory it asks for."""
    (i0, _), (L0, L1), (o0, _) = i_shape, edims, o_shape
    C = (L1 + 1) // 2
    SH, SR = C | 1, max(i0, o0)
    npi, npo = (i0 + 1) // 2, (o0 + 1) // 2
    rows_full = max(npi | 1, npo | 1) * L1
    cols_full = (C | 1) * L0
    limit = _SMEM_LIMIT - _WP_STATIC_SMEM
    least = max(L0, L1)
    WB = max(least, min(max(rows_full, cols_full), _WP_BUFFER))
    if _wp_resident_smem(L0, L1, SR, SH, WB) > limit:
        WB = least
    smem = _wp_resident_smem(L0, L1, SR, SH, WB)
    if smem > limit:
        return "three-pass", None

    def groups(n, N):
        m = WB // N
        cap = m if m % 2 else m - 1        # (nt | 1) * N <= WB
        return -(-n // -(-n // cap))

    return "resident", dict(WB=WB, G=groups(C, L0), RGi=groups(npi, L1),
                            RGo=groups(npo, L1), smem=smem)


def _wp_lib():
    global _WP_LIB
    if _WP_LIB is None:
        from .. import _build

        lib = _build.load("sandwich_wp")
        p, i = ctypes.c_void_p, ctypes.c_int
        ip = ctypes.POINTER(ctypes.c_int)
        lib.wp_resident.argtypes = [p] * 7 + [i] * 8 + [ip, i, ip, i] + [i] * 4 + [p]
        lib.wp_resident.restype = ctypes.c_int
        lib.wp_resident_smem_bytes.argtypes = [i] * 5
        lib.wp_resident_smem_bytes.restype = ctypes.c_size_t
        _WP_LIB = lib
    return _WP_LIB


def _fft_lib():
    global _FFT_LIB
    if _FFT_LIB is None:
        from .. import _build

        lib = _build.load("sandwich_fft")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.fft_sandwich.argtypes = [p] * 9 + [i] * 16 + [p]
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
    """Kernel A on (B, i0, i1) planes with the full (L0, L1) spectrum w, out
    to (B, o0, o1); or, kernel B-5's three-pass route, on a (B, W, i0, i1)
    stack with per-plane spectra w (W, L0, L1), out to (B, W, o0, o1), the
    dots summed over each sample's planes.  On CUDA tensors: checks,
    allocates every output and scratch buffer with torch.empty, launches on
    the current stream, raises on a non-zero cudaError_t.  The caller counts
    the launch (kernel B-8 is this launch with both crops full)."""
    _check_operands(x, w)
    B, (i0, i1) = x.shape[0], tuple(x.shape[-2:])
    W = x.shape[1] if x.ndim == 4 else 1
    L0, L1 = w.shape[-2:]
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
    y = torch.empty(tuple(x.shape[:-2]) + (o0, o1), dtype=torch.float32, device=dev)
    s1 = torch.empty((2 * B * W * H * i0,), dtype=torch.float32, device=dev)
    s2 = torch.empty((2 * B * W * H * o0,), dtype=torch.float32, device=dev)
    if selfdot:
        dots = torch.empty((B,), dtype=torch.float32, device=dev)
        rowdot = torch.empty((B * W * o0,), dtype=torch.float32, device=dev)
        dots_p, rowdot_p = dots.data_ptr(), rowdot.data_ptr()
    else:
        dots = None
        dots_p = rowdot_p = None
    t0, t1 = _fft_tables(L0, dev), _fft_tables(L1, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fft_sandwich(x.data_ptr(), w.data_ptr(), t0.data_ptr(), t1.data_ptr(),
                               y.data_ptr(), dots_p, s1.data_ptr(), s2.data_ptr(),
                               rowdot_p, B, W, i0, i1, L0, L1, o0, o1, *splits, *swaps,
                               stream)
    if err != 0:
        raise RuntimeError(f"sandwich_fft kernel failed: cudaError_t {err}")
    return (y, dots) if selfdot else y


def _launch_wp(x, w, o_shape, selfdot: bool):
    """Kernel B-5 on a (B, W, i0, i1) stack with w (W, L0, L1), out to
    (B, W, o0, o1), on CUDA tensors, by the route `_wp_route` gives the shape:
    the resident kernel, or kernel A's three passes with a plane index.
    Checks, allocates every output and scratch buffer with torch.empty,
    launches on the current stream, raises on a non-zero cudaError_t.  The
    caller counts the launch."""
    _check_operands(x, w)
    B, W, i0, i1 = x.shape
    L0, L1 = w.shape[-2:]
    o0, o1 = o_shape
    if selfdot and (i0, i1) != (o0, o1):
        raise ValueError("the self-dot needs equal input and output crops")
    route, lay = _wp_route((i0, i1), (L0, L1), (o0, o1))
    if route == "three-pass":
        return _launch_fft(x, w, o_shape, selfdot)
    r0, r1 = wp_fft_plan(L0), wp_fft_plan(L1)
    if B * W >= 2 ** 31:
        raise ValueError(f"{B * W} planes are more than one launch's grid covers")
    lib = _wp_lib()
    SH = ((L1 + 1) // 2) | 1
    smem = lib.wp_resident_smem_bytes(L0, L1, max(i0, o0), SH, lay["WB"])
    if smem != lay["smem"]:
        raise RuntimeError(f"B-5 resident layout: the kernel asks for {smem} bytes of "
                           f"shared memory, the route chose {lay['smem']}")
    dev = x.device
    y = torch.empty((B, W, o0, o1), dtype=torch.float32, device=dev)
    if selfdot:
        dots = torch.empty((B,), dtype=torch.float32, device=dev)
        planedot = torch.empty((B * W,), dtype=torch.float32, device=dev)
        dots_p, planedot_p = dots.data_ptr(), planedot.data_ptr()
    else:
        dots = None
        dots_p = planedot_p = None
    t0, t1 = _wp_tables(L0, dev), _wp_tables(L1, dev)
    rad0, rad1 = (ctypes.c_int * len(r0))(*r0), (ctypes.c_int * len(r1))(*r1)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.wp_resident(x.data_ptr(), w.data_ptr(), t0.data_ptr(), t1.data_ptr(),
                              y.data_ptr(), planedot_p, dots_p, B, W, i0, i1, L0, L1, o0,
                              o1, rad0, len(r0), rad1, len(r1), lay["G"], lay["RGi"],
                              lay["RGo"], lay["WB"], stream)
    if err != 0:
        raise RuntimeError(f"sandwich_wp kernel failed: cudaError_t {err}")
    return (y, dots) if selfdot else y


def _check_shapes(x, w, i_shape, edims):
    if x.ndim != 3 or tuple(x.shape[1:]) != tuple(i_shape):
        raise ValueError(f"x must be (B, {i_shape[0]}, {i_shape[1]}), got "
                         f"{tuple(x.shape)}")
    if w.ndim != 2 or tuple(w.shape) != tuple(edims):
        raise ValueError(f"w must be the full (L0, L1) spectrum, got {tuple(w.shape)}")


def _analysis(x: torch.Tensor, dims, edims, expanded: bool) -> torch.Tensor:
    """Q0^T P^T x Q1 per plane, (..., i0, i1) -> (..., L0, L1), with the crop
    ``expanded`` selects (the JAX package's `_analysis_einsum` and
    `_analysis_einsum_wp`)."""
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
    if needs_grad(x, w):
        raise no_backward("the self-dot sandwich (kernel A)")
    if x.device.type == "cpu":
        tables = _tables(dims, edims, False, False, x.dtype, x.device)
        return sandwich_plain(x, w, *tables[:4], selfdot=True)
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
    dims, edims = tuple(dims), tuple(edims)
    i_shape, o_shape = _crops(dims, edims, bool(in_expanded), bool(out_expanded))
    if x.ndim != 4 or tuple(x.shape[2:]) != i_shape:
        raise ValueError(f"x must be (B, W, {i_shape[0]}, {i_shape[1]}), got "
                         f"{tuple(x.shape)}")
    if w.ndim != 3 or w.shape[0] != x.shape[1] or tuple(w.shape[1:]) != edims:
        raise ValueError(f"w must be ({x.shape[1]}, {edims[0]}, {edims[1]}) "
                         f"per-plane spectra, got {tuple(w.shape)}")
    if selfdot and (in_expanded or out_expanded):
        raise ValueError("the self-dot needs equal input and output crops")
    if not selfdot:
        return _SandwichWP.apply(x, w, dims, edims, bool(in_expanded), bool(out_expanded))
    if needs_grad(x, w):
        raise no_backward("the self-dot weight-plane sandwich (kernel B-5)")
    if x.device.type == "cpu":
        tables = _tables(dims, edims, False, False, x.dtype, x.device)
        return sandwich_wp_plain(x, w, *tables[:4], selfdot=True)
    out = _launch_wp(x, w, o_shape, selfdot=True)
    LAUNCHES["sandwich_apply_wp_selfdot"] += 1
    return out


class _SandwichWP(torch.autograd.Function):
    """Kernel B-5 (or its plain version on the CPU) with the backward of the
    JAX package's `_get_sandwich_wp`: gx is B-5 with the crops swapped,
    gw[l] = sum_b analysis(x_bl) * analysis(g_bl)."""

    @staticmethod
    def forward(ctx, x, w, dims, edims, in_expanded, out_expanded):
        ctx.save_for_backward(x if ctx.needs_input_grad[1] else None,
                              w if ctx.needs_input_grad[0] else None)
        ctx.crops = (dims, edims, in_expanded, out_expanded)
        if x.device.type == "cpu":
            tables = _tables(dims, edims, in_expanded, out_expanded, x.dtype, x.device)
            return sandwich_wp_plain(x, w, *tables[:4])
        y = _launch_wp(x, w, _crops(dims, edims, in_expanded, out_expanded)[1],
                       selfdot=False)
        LAUNCHES["sandwich_apply_wp"] += 1
        return y

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dims, edims, in_expanded, out_expanded = ctx.crops
        g = g.contiguous()
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = sandwich_apply_wp(g, w, dims, edims, in_expanded=out_expanded,
                                   out_expanded=in_expanded)
        if ctx.needs_input_grad[1]:
            gw = torch.sum(_analysis(x, dims, edims, in_expanded)
                           * _analysis(g, dims, edims, out_expanded), dim=0)
        return gx, gw, None, None, None, None
