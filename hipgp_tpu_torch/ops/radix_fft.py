"""The packed radix circulant apply y = F^{-1}(d * F x) on a long 1-D axis.

Counterpart of `hipgp_tpu/ops/radix_fft.py`.  L = A * B * C (C = 128, B in
[8, 128], A in [8, 2048], all powers of two) and the DFT is the three-stage
Cooley-Tukey decomposition with twiddles

  X[ka + A*kb + AB*kc] =
    sum_c W_C[kc,c] T2[kb,c] sum_b W_B[kb,b] T1[ka, b*C+c] sum_a W_A[ka,a] x[a,b,c]

with T1[ka, m] = exp(-2 pi i ka m / L) and T2[kb, c] = exp(-2 pi i kb c / (BC)).
The apply never forms the natural-order spectrum: the diagonal d is kept in
stage order (`permute_weights`, with the 1/L of the inverse folded in) and
the inverse consumes stage order directly.  Each apply is three stages:

  stage 1 (A-point DFT over the outer axis)  ->  middle  ->  stage 1 inverse

on V complex planes that each pack two real right-hand sides (d is real and
even, so C_d (x1 + i x2) = C_d x1 + i C_d x2).  The layout functions
(`_factorize`, `make_plan`, `permute_weights`, `row_multiple`,
`stage_order_weights`) are those of the JAX package, so the solver state and
the weights line up with it element for element.

Two implementations of each stage live here:

* the hand-written CUDA kernels of ``csrc/radix.cu`` (B-2 ``stage1``, B-3
  ``stage1_inv_dot``, B-4 ``middle``, B-7 ``middle_dual``), register-radix
  FFTs whose radices are `_S1_RADICES` and `_MID_RADICES` and whose
  twiddles come from the float64 plan table `_kernel_table`, launched for
  float32 tensors on a CUDA device (anything else raises);
* their plain PyTorch versions (`stage1_plain`, `stage1_inv_dot_plain`,
  `middle_plain`, `middle_dual_plain`): dense DFT tables and complex
  matmuls, taken only for a tensor on the CPU.

Each wrapper counts its kernel launches in :data:`LAUNCHES`.

The cropped apply (`fused_circulant_apply_cropped`, and through it
`fused_circulant_apply`) is differentiable in xr, xi and d_perm, with the
backward of the JAX package's custom VJP (`_get_apply`): the x-cotangent is
the same apply with the crops swapped (B-2, B-4, B-2 on the cotangent); the
d-cotangent is sum_v Re[(M F1 x) conj(M F1 g)] in stage order, F1 stage 1
(B-2 forward of x at the input crop and of g at the output crop) and M the
forward middle, summed by ``radix_middle_wgrad`` (`middle_wgrad`, plain
version `middle_wgrad_plain`).  The self-dot apply is solver-internal and
not differentiable, as in the JAX package: a required gradient raises there;
the two-diagonal apply has no backward either.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .bttb import needs_grad, no_backward

__all__ = ["RadixPlan", "make_plan", "permute_weights", "fused_circulant_apply",
           "fused_circulant_apply_cropped", "fused_circulant_apply_cropped_selfdot",
           "fused_circulant_apply_cropped_dual", "middle_dual", "middle_dual_plain",
           "radix_supported", "row_multiple", "stage_order_weights",
           "stage1", "stage1_inv_dot", "middle", "middle_wgrad", "stage1_plain",
           "stage1_inv_dot_plain", "middle_plain", "middle_wgrad_plain",
           "wgrad_splits", "wgrad_kernel_info", "WGRAD_CLUSTER", "pack_rows", "unpack_rows",
           "LAUNCHES", "reset_launches", "attribute_sets"]

_LANE = 128
# CTAs of a ``radix_middle_wgrad`` cluster (``WCL`` of csrc/radix.cu): one
# transforms x's plane, the other g's
WGRAD_CLUSTER = 2
# launches of the radix kernels, per wrapper; a plain-version call counts nothing
LAUNCHES: Dict[str, int] = {"stage1": 0, "stage1_inv_dot": 0, "middle": 0,
                            "middle_dual": 0, "middle_wgrad": 0}
_LIB = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _factorize(L: int) -> Optional[Tuple[int, int, int]]:
    """L = A*B*C with C = 128, B in [8,128], A in [8,2048], all pow2."""
    if L <= 0 or L & (L - 1):
        return None
    C = _LANE
    rest = L // C
    if rest * C != L:
        return None
    # prefer B = 128, shrink toward 8; A takes the remainder
    for B in (128, 64, 32, 16, 8):
        if rest % B == 0:
            A = rest // B
            if 8 <= A <= 2048:
                return A, B, C
    return None


def radix_supported(L: int) -> bool:
    return _factorize(L) is not None


def row_multiple(L: int) -> int:
    """B*C for ``L``'s plan: the cropped applies' row granularity."""
    A, B, C = _factorize(L)
    return B * C


def _dft_mats(n: int) -> Tuple[np.ndarray, np.ndarray]:
    k = np.arange(n)
    ang = -2.0 * np.pi * np.outer(k, k) / n
    return np.cos(ang), np.sin(ang)


class RadixPlan(NamedTuple):
    L: int
    A: int
    B: int
    C: int
    wac: torch.Tensor   # (A, A) stage-1 DFT cos
    was: torch.Tensor   # (A, A) sin
    wasum: torch.Tensor  # cos + sin
    wbc: torch.Tensor   # (B, B)
    wbs: torch.Tensor
    wbsum: torch.Tensor
    wcc: torch.Tensor   # (C, C)
    wcs: torch.Tensor
    wcsum: torch.Tensor
    theta: torch.Tensor  # (B, C) T1 unit phase: -2 pi (b*C + c) / L
    t2c: torch.Tensor   # (B, C) T2 cos
    t2s: torch.Tensor   # (B, C) sin


@functools.lru_cache(maxsize=16)
def _plan_arrays(L: int):
    A, B, C = _factorize(L)
    mats = [_dft_mats(n) for n in (A, B, C)]
    m = (np.arange(B)[:, None] * C + np.arange(C)[None, :]).astype(np.float64)
    theta = -2.0 * np.pi * m / L
    ang2 = -2.0 * np.pi * np.outer(np.arange(B), np.arange(C)) / (B * C)
    return A, B, C, mats, theta, np.cos(ang2), np.sin(ang2)


@functools.lru_cache(maxsize=16)
def make_plan(L: int, dtype: torch.dtype = torch.float32,
              device="cpu") -> RadixPlan:
    """Plan tables, built in float64 with numpy and turned into tensors of
    ``dtype`` on ``device``; cached per (L, dtype, device)."""
    A, B, C, mats, theta, t2c, t2s = _plan_arrays(L)
    j = lambda a: torch.as_tensor(a).to(device=device, dtype=dtype)
    (wac, was), (wbc, wbs), (wcc, wcs) = mats
    return RadixPlan(
        L, A, B, C,
        j(wac), j(was), j(wac + was),
        j(wbc), j(wbs), j(wbc + wbs),
        j(wcc), j(wcs), j(wcc + wcs),
        j(theta), j(t2c), j(t2s),
    )


def permute_weights(d_natural: torch.Tensor, plan: RadixPlan) -> torch.Tensor:
    """Natural-order spectrum (L,) -> kernel stage order (A, B, C), with the
    1/L inverse-transform scale folded in: k = ka + A*kb + AB*kc, so the
    natural layout viewed (C, B, A) transposes to (A, B, C)."""
    d = d_natural.reshape(plan.C, plan.B, plan.A).permute(2, 1, 0)
    return (d / plan.L).contiguous()


# ---------------------------------------------------------------------------
# Plain PyTorch versions of the three stages
# ---------------------------------------------------------------------------

def stage1_plain(xr, xi, wr, wi):
    """y = (wr + i wi) @ (xr + i xi) over the outer axis: (V, Ain, N) planes
    and an (Aout, Ain) table -> (V, Aout, N).  The forward stage takes
    W_A[:, :in_rows], the inverse conj(W_A)[:out_rows]."""
    w = torch.complex(wr, wi)
    y = torch.matmul(w, torch.complex(xr, xi))
    return y.real.contiguous(), y.imag.contiguous()


def stage1_inv_dot_plain(zr, zi, ur, ui, wr, wi):
    """`stage1_plain` plus the per-v self-dots dr[v] = sum(ur[v] * yr[v]),
    di[v] = sum(ui[v] * yi[v]) (u shaped like the output)."""
    yr, yi = stage1_plain(zr, zi, wr, wi)
    return yr, yi, torch.sum(ur * yr, dim=(1, 2)), torch.sum(ui * yi, dim=(1, 2))


@functools.lru_cache(maxsize=8)
def _middle_tables(L: int, dtype: torch.dtype, device):
    """T1 (A, B, C), T2 (B, C), W_B, W_C as complex tensors, computed in
    float64 and cast."""
    A, B, C, mats, theta, t2c, t2s = _plan_arrays(L)
    ang = theta[None] * np.arange(A, dtype=np.float64)[:, None, None]
    cdt = torch.complex128 if dtype == torch.float64 else torch.complex64
    t = lambda re, im: torch.complex(torch.as_tensor(re), torch.as_tensor(im)).to(
        device=device, dtype=cdt)
    (_, _), (wbc, wbs), (wcc, wcs) = mats
    return t(np.cos(ang), np.sin(ang)), t(t2c, t2s), t(wbc, wbs), t(wcc, wcs)


def _middle_forward(y, t1, t2, wb, wc):
    """T1, the B-point DFT over b, T2, the C-point DFT over c: complex
    (..., A, B, C) planes into stage order."""
    return torch.matmul(torch.matmul(wb, y * t1) * t2, wc)


def _middle_inverse(y, t1, t2, wb, wc):
    """The conjugate chain back: the inverse C-point DFT, conj T2, the
    inverse B-point DFT, conj T1; as real and imaginary parts."""
    y = torch.matmul(y, wc.conj()) * t2.conj()
    y = torch.matmul(wb.conj(), y) * t1.conj()
    return y.real.contiguous(), y.imag.contiguous()


def middle_plain(yr, yi, d_perm, plan: RadixPlan):
    """(V, A, B, C) planes -> same shape: per (B, C) plane, T1, the B-point
    DFT over b, T2, the C-point DFT over c, x d (stage order, 1/L folded
    in), then the conjugate chain back."""
    tables = _middle_tables(plan.L, yr.dtype, yr.device)
    y = _middle_forward(torch.complex(yr, yi), *tables)
    return _middle_inverse(y * d_perm, *tables)


def middle_dual_plain(yr, yi, dA, dB, plan: RadixPlan):
    """`middle_plain` with two diagonals on one forward half: returns
    (zAr, zAi, zBr, zBi), the chain back from the forward spectrum times dA
    and times dB."""
    tables = _middle_tables(plan.L, yr.dtype, yr.device)
    y = _middle_forward(torch.complex(yr, yi), *tables)
    return _middle_inverse(y * dA, *tables) + _middle_inverse(y * dB, *tables)


def middle_wgrad_plain(xr, xi, gr, gi, plan: RadixPlan):
    """B-4's weight cotangent: (V, A, B, C) stage-1 outputs x and g -> the
    (A, B, C) sum over v of Re[X conj(G)], X and G their forward middles
    (T1, the B-point DFT, T2, the C-point DFT; d_perm's stage order)."""
    tables = _middle_tables(plan.L, xr.dtype, xr.device)
    X = _middle_forward(torch.complex(xr, xi), *tables)
    G = _middle_forward(torch.complex(gr, gi), *tables)
    return torch.sum(X.real * G.real + X.imag * G.imag, dim=0)


# ---------------------------------------------------------------------------
# The kernels' plan table
# ---------------------------------------------------------------------------

# Radices of the kernels' register steps (csrc/radix.cu `S1Plan`, `MidPlan`):
# stage 1's A-point DFT, and the middle's B-point DFT (its C = 128 point DFT
# is 16 x 8 at every plan).
_S1_RADICES = {8: (8,), 16: (16,), 32: (8, 4), 64: (8, 8), 128: (16, 8),
               256: (16, 16), 512: (8, 8, 8), 1024: (16, 8, 8), 2048: (16, 16, 8)}
_MID_RADICES = {128: (16, 8), 64: (8, 8), 32: (8, 4), 16: (16, 1), 8: (8, 1)}
_MC1, _MC2 = 16, 8


def _unit(num, den) -> np.ndarray:
    """exp(-2 pi i num / den) in float64, the integer product reduced first."""
    return np.exp(-2j * np.pi * (np.asarray(num, dtype=np.int64) % den) / den)


@functools.lru_cache(maxsize=16)
def _kernel_table_np(L: int) -> Dict[str, np.ndarray]:
    """The float64 tables the kernels read, by name, in the table's order:
    twA[m] = W_A^m; tw4[a, k1] = W_C^{a k1} (a < 8, k1 < 16); twB[m] = W_B^m;
    base[k1, c] = W_{BC}^{k1 c} (k1 < R1) and fac[k2, c] = W_{BC}^{R1 k2 c}
    (k2 < R2), whose product is T2 at kb = k1 + R1 k2; t1r[ka, b] =
    W_{AB}^{ka b} and t1c[ka, c] = W_L^{ka c}, whose product is T1; with
    W_n^m = exp(-2 pi i m / n) and (R1, R2) the middle's radices over b."""
    A, B, C = _factorize(L)
    R1, R2 = _MID_RADICES[B]
    ar = np.arange
    return {
        "twA": _unit(ar(A), A),
        "tw4": _unit(np.outer(ar(_MC2), ar(_MC1)), C),
        "twB": _unit(ar(B), B),
        "base": _unit(np.outer(ar(R1), ar(C)), B * C),
        "fac": _unit(np.outer(R1 * ar(R2), ar(C)), B * C),
        "t1r": _unit(np.outer(ar(A), ar(B)), A * B),
        "t1c": _unit(np.outer(ar(A), ar(C)), L),
    }


@functools.lru_cache(maxsize=16)
def _kernel_table(L: int, device) -> torch.Tensor:
    """`_kernel_table_np` flattened in order, as interleaved float32 (re, im)
    on ``device``; cached per (L, device)."""
    flat = np.concatenate([t.ravel() for t in _kernel_table_np(L).values()])
    return torch.as_tensor(np.stack([flat.real, flat.imag], axis=-1).ravel(),
                           dtype=torch.float32, device=device)


def _kernel_plan(A: int, B: int):
    """The kernels' own register radices at plan (A, B), from ``csrc/radix.cu``
    (`radix_plan`): (stage 1's over a, the middle's over b, over c), in the
    form of `_S1_RADICES`, `_MID_RADICES` and (`_MC1`, `_MC2`); None for a
    plan the kernels do not take."""
    r = (ctypes.c_int * 7)()
    if not _lib().radix_plan(A, B, r):
        return None
    return tuple(x for x in r[:3] if x > 1), (r[3], r[4]), (r[5], r[6])


@functools.lru_cache(maxsize=16)
def _checked_table(L: int, dev) -> torch.Tensor:
    """`_kernel_table` once the kernels' radices are checked to be the ones
    the table was built for (and the CPU model follows), and its size the
    kernels' count: a plan they do not take, or radices that differ in value
    or order, raise."""
    A, B, _ = _factorize(L)
    plan = _kernel_plan(A, B)
    if plan is None:
        raise ValueError(f"radix kernels take no plan (A, B) = {(A, B)}")
    mine = (_S1_RADICES.get(A), _MID_RADICES.get(B), (_MC1, _MC2))
    if plan != mine:
        raise ValueError(f"radix kernels' radices {plan} at (A, B) = {(A, B)}, "
                         f"the tables' {mine}")
    tab = _kernel_table(L, dev)
    if tab.numel() != _lib().radix_table_floats(A, B):
        raise ValueError(f"radix plan table of {tab.numel()} floats at (A, B) = "
                         f"{(A, B)}, the kernels read {_lib().radix_table_floats(A, B)}")
    return tab


# ---------------------------------------------------------------------------
# The kernels' wrappers
# ---------------------------------------------------------------------------

def _bind(lib):
    """Sets the C signatures of a built ``csrc/radix.cu`` on ``lib``."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.radix_stage1.argtypes = [p] * 5 + [i] * 6 + [p]
    lib.radix_stage1.restype = ctypes.c_int
    lib.radix_stage1_dot.argtypes = [p] * 10 + [i] * 4 + [p]
    lib.radix_stage1_dot.restype = ctypes.c_int
    lib.radix_middle.argtypes = [p] * 6 + [i] * 4 + [p]
    lib.radix_middle.restype = ctypes.c_int
    lib.radix_middle_dual.argtypes = [p] * 9 + [i] * 4 + [p]
    lib.radix_middle_dual.restype = ctypes.c_int
    lib.radix_middle_wgrad.argtypes = [p] * 6 + [ctypes.c_size_t, p] + [i] * 5 + [p]
    lib.radix_middle_wgrad.restype = ctypes.c_int
    lib.radix_wgrad_smem_bytes.argtypes = [i]
    lib.radix_wgrad_smem_bytes.restype = ctypes.c_size_t
    lib.radix_wgrad_max_clusters.argtypes = [i, ctypes.POINTER(i)]
    lib.radix_wgrad_max_clusters.restype = ctypes.c_int
    lib.radix_dot_partials.argtypes = [i, i, i]
    lib.radix_dot_partials.restype = ctypes.c_size_t
    lib.radix_table_floats.argtypes = [i, i]
    lib.radix_table_floats.restype = ctypes.c_size_t
    lib.radix_plan.argtypes = [i, i, ctypes.POINTER(i)]
    lib.radix_plan.restype = ctypes.c_int
    for counter in (lib.radix_attribute_sets, lib.radix_kernels_configured):
        counter.argtypes = []
        counter.restype = ctypes.c_int
    return lib


def _lib():
    global _LIB
    if _LIB is None:
        from .. import _build

        _LIB = _bind(_build.load("radix"))
    return _LIB


def attribute_sets() -> Tuple[int, int]:
    """(cudaFuncSetAttribute calls, kernels configured) of ``csrc/radix.cu``
    so far in this process: the kernels are configured once, on the first
    launch of any."""
    lib = _lib()
    return lib.radix_attribute_sets(), lib.radix_kernels_configured()


def _check(name, ref, *tensors):
    """The kernels take contiguous float32 tensors on ``ref``'s CUDA device."""
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"{name} kernel takes float32, got {t.dtype}")
        if t.device != ref.device:
            raise ValueError(f"{name} kernel: tensor on {t.device}, input on {ref.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} kernel needs contiguous tensors")


def _raise_on(err, name):
    if err != 0:
        raise RuntimeError(f"radix {name} kernel failed: cudaError_t {err}")


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _s1_tables(plan: RadixPlan, in_rows: int, out_rows: int, inverse: bool):
    if inverse:
        return plan.wac[:out_rows], -plan.was[:out_rows]
    return plan.wac[:, :in_rows], plan.was[:, :in_rows]


def stage1(xr: torch.Tensor, xi: torch.Tensor, plan: RadixPlan, out_rows: int,
           inverse: bool):
    """The A-point DFT over the outer axis of (V, in_rows, B*C) planes,
    forward (exp(-2 pi i k a / A)) or inverse (the conjugate, unscaled):
    rows >= in_rows of the input are zero and only the first ``out_rows``
    rows of the output are formed.  Returns (yr, yi), (V, out_rows, B*C).
    Kernel B-2 on a CUDA tensor, the plain version on a CPU tensor."""
    V, in_rows, N = xr.shape
    if xi.shape != xr.shape or N != plan.B * plan.C:
        raise ValueError(f"stage1 takes (V, rows, {plan.B * plan.C}) planes, got "
                         f"{tuple(xr.shape)} and {tuple(xi.shape)}")
    if not (1 <= in_rows <= plan.A and 1 <= out_rows <= plan.A):
        raise ValueError(f"stage1 rows {in_rows} -> {out_rows} outside 1..{plan.A}")
    if xr.device.type == "cpu":
        wr, wi = _s1_tables(plan, in_rows, out_rows, inverse)
        return stage1_plain(xr, xi, wr, wi)
    _check("stage1", xr, xr, xi)
    yr = torch.empty((V, out_rows, N), dtype=torch.float32, device=xr.device)
    yi = torch.empty_like(yr)
    with torch.cuda.device(xr.device):
        tab = _checked_table(plan.L, xr.device)
        err = _lib().radix_stage1(xr.data_ptr(), xi.data_ptr(), yr.data_ptr(),
                                  yi.data_ptr(), tab.data_ptr(), V, N, plan.A, in_rows, out_rows,
                                  1 if inverse else -1, _stream(xr.device))
    _raise_on(err, "stage1")
    LAUNCHES["stage1"] += 1
    return yr, yi


def stage1_inv_dot(zr: torch.Tensor, zi: torch.Tensor, ur: torch.Tensor,
                   ui: torch.Tensor, plan: RadixPlan, out_rows: int):
    """The inverse `stage1` of (V, A, B*C) planes to (V, out_rows, B*C) plus
    the self-dots dr[v] = sum(ur[v] * yr[v]), di[v] = sum(ui[v] * yi[v]),
    with u shaped like the output.  Returns (yr, yi, dr, di).  Kernel B-3
    on a CUDA tensor (the dots summed in a fixed order), the plain version
    on a CPU tensor."""
    V, A, N = zr.shape
    if (zi.shape != zr.shape or A != plan.A or N != plan.B * plan.C
            or tuple(ur.shape) != (V, out_rows, N) or ui.shape != ur.shape):
        raise ValueError(f"stage1_inv_dot takes (V, {plan.A}, {plan.B * plan.C}) "
                         f"planes and (V, {out_rows}, {plan.B * plan.C}) riders, got "
                         f"{tuple(zr.shape)} and {tuple(ur.shape)}")
    if not 1 <= out_rows <= plan.A:
        raise ValueError(f"stage1_inv_dot rows {out_rows} outside 1..{plan.A}")
    if zr.device.type == "cpu":
        wr, wi = _s1_tables(plan, A, out_rows, True)
        return stage1_inv_dot_plain(zr, zi, ur, ui, wr, wi)
    _check("stage1_inv_dot", zr, zr, zi, ur, ui)
    lib = _lib()
    dev = zr.device
    yr = torch.empty((V, out_rows, N), dtype=torch.float32, device=dev)
    yi = torch.empty_like(yr)
    dots = torch.empty((2, V), dtype=torch.float32, device=dev)
    partial = torch.empty((2 * lib.radix_dot_partials(V, N, A),),
                          dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.radix_stage1_dot(zr.data_ptr(), zi.data_ptr(), ur.data_ptr(),
                                   ui.data_ptr(), _checked_table(plan.L, dev).data_ptr(),
                                   yr.data_ptr(), yi.data_ptr(),
                                   dots[0].data_ptr(), dots[1].data_ptr(),
                                   partial.data_ptr(), V, N, A, out_rows,
                                   _stream(dev))
    _raise_on(err, "stage1_inv_dot")
    LAUNCHES["stage1_inv_dot"] += 1
    return yr, yi, dots[0], dots[1]


def middle(yr: torch.Tensor, yi: torch.Tensor, d_perm: torch.Tensor,
           plan: RadixPlan):
    """The middle stages on (V, A, B, C) planes (see `middle_plain`).
    Kernel B-4 on a CUDA tensor, the plain version on a CPU tensor."""
    V = yr.shape[0]
    shape = (V, plan.A, plan.B, plan.C)
    if tuple(yr.shape) != shape or yi.shape != yr.shape or tuple(d_perm.shape) != shape[1:]:
        raise ValueError(f"middle takes {shape} planes and a {shape[1:]} diagonal, "
                         f"got {tuple(yr.shape)} and {tuple(d_perm.shape)}")
    if yr.device.type == "cpu":
        return middle_plain(yr, yi, d_perm, plan)
    _check("middle", yr, yr, yi, d_perm)
    zr = torch.empty_like(yr)
    zi = torch.empty_like(yr)
    with torch.cuda.device(yr.device):
        err = _lib().radix_middle(yr.data_ptr(), yi.data_ptr(), d_perm.data_ptr(),
                                  _checked_table(plan.L, yr.device).data_ptr(),
                                  zr.data_ptr(), zi.data_ptr(), V, plan.A, plan.B,
                                  plan.C, _stream(yr.device))
    _raise_on(err, "middle")
    LAUNCHES["middle"] += 1
    return zr, zi


def middle_dual(yr: torch.Tensor, yi: torch.Tensor, dA: torch.Tensor,
                dB: torch.Tensor, plan: RadixPlan):
    """The middle stages with two diagonals on one forward half (see
    `middle_dual_plain`): returns (zAr, zAi, zBr, zBi).  Kernel B-7 on a
    CUDA tensor, the plain version on a CPU tensor."""
    V = yr.shape[0]
    shape = (V, plan.A, plan.B, plan.C)
    if (tuple(yr.shape) != shape or yi.shape != yr.shape
            or tuple(dA.shape) != shape[1:] or dB.shape != dA.shape):
        raise ValueError(f"middle_dual takes {shape} planes and two {shape[1:]} "
                         f"diagonals, got {tuple(yr.shape)}, {tuple(dA.shape)} and "
                         f"{tuple(dB.shape)}")
    if yr.device.type == "cpu":
        return middle_dual_plain(yr, yi, dA, dB, plan)
    _check("middle_dual", yr, yr, yi, dA, dB)
    out = [torch.empty_like(yr) for _ in range(4)]
    with torch.cuda.device(yr.device):
        tab = _checked_table(plan.L, yr.device)
        err = _lib().radix_middle_dual(yr.data_ptr(), yi.data_ptr(), dA.data_ptr(),
                                       dB.data_ptr(), tab.data_ptr(),
                                       *(z.data_ptr() for z in out),
                                       V, plan.A, plan.B, plan.C, _stream(yr.device))
    _raise_on(err, "middle_dual")
    LAUNCHES["middle_dual"] += 1
    return tuple(out)


def wgrad_splits(V: int, A: int, sms: int) -> int:
    """Clusters per ka of ``radix_middle_wgrad`` (``wgrad_splits`` of
    ``csrc/radix.cu``): the ``sms // WGRAD_CLUSTER`` clusters the card holds
    at once shared among the A values of ka, so that A * splits clusters
    make one wave at A <= 64; at least one, at most one per plane."""
    return max(1, min(V, sms // WGRAD_CLUSTER // A))


def wgrad_kernel_info(B: int) -> Tuple[int, int]:
    """(dynamic shared memory of a CTA in bytes, clusters resident at once)
    of ``radix_middle_wgrad`` at plan B on the current card."""
    n = ctypes.c_int(0)
    _raise_on(_lib().radix_wgrad_max_clusters(B, ctypes.byref(n)), "middle_wgrad")
    return _lib().radix_wgrad_smem_bytes(B), n.value


def middle_wgrad(xr: torch.Tensor, xi: torch.Tensor, gr: torch.Tensor,
                 gi: torch.Tensor, plan: RadixPlan) -> torch.Tensor:
    """B-4's weight cotangent on (V, A, B, C) stage-1 outputs x and g (see
    `middle_wgrad_plain`): returns the (A, B, C) sum.  Kernel
    ``radix_middle_wgrad`` on a CUDA tensor (summed in a fixed order), the
    plain version on a CPU tensor."""
    V = xr.shape[0]
    shape = (V, plan.A, plan.B, plan.C)
    if any(tuple(t.shape) != shape for t in (xr, xi, gr, gi)):
        raise ValueError(f"middle_wgrad takes four {shape} planes, got "
                         f"{[tuple(t.shape) for t in (xr, xi, gr, gi)]}")
    if xr.device.type == "cpu":
        return middle_wgrad_plain(xr, xi, gr, gi, plan)
    _check("middle_wgrad", xr, xr, xi, gr, gi)
    if xr.data_ptr() % 16 or gr.data_ptr() % 16:
        raise ValueError("middle_wgrad kernel needs xr and gr 16-byte aligned "
                         "(their planes arrive by bulk copies)")
    dev = xr.device
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    splits = wgrad_splits(V, plan.A, sms)
    # the only scratch: the splits' sums, when a ka's planes are split
    partial = (torch.empty((splits * plan.L,), dtype=torch.float32, device=dev)
               if splits > 1 else None)
    dbar = torch.empty(shape[1:], dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _lib().radix_middle_wgrad(xr.data_ptr(), xi.data_ptr(), gr.data_ptr(),
                                        gi.data_ptr(), _checked_table(plan.L, dev).data_ptr(),
                                        None if partial is None else partial.data_ptr(),
                                        0 if partial is None else partial.numel(),
                                        dbar.data_ptr(), V, plan.A, plan.B, plan.C, sms,
                                        _stream(dev))
    _raise_on(err, "middle_wgrad")
    LAUNCHES["middle_wgrad"] += 1
    return dbar


# ---------------------------------------------------------------------------
# The applies
# ---------------------------------------------------------------------------

def pack_rows(x: torch.Tensor, n: int):
    """(nb, m) real rows -> the (V, n) real and imaginary planes of the
    packed applies, V = ceil(nb / 2): plane v holds rows 2v and 2v+1, each
    zero-padded to n columns (an odd batch gets one zero row)."""
    nb, m = x.shape
    x = torch.nn.functional.pad(x, (0, n - m, 0, nb % 2))
    return x[0::2].contiguous(), x[1::2].contiguous()


def unpack_rows(yr: torch.Tensor, yi: torch.Tensor, nb: int) -> torch.Tensor:
    """The inverse of `pack_rows`: (V, n) planes -> the first nb of their
    interleaved (2V, n) rows."""
    return torch.stack([yr, yi], dim=1).reshape(-1, yr.shape[-1])[:nb]


def _forward_and_middle(xr, xi, d_perm, plan: RadixPlan, in_rows: int):
    V = xr.shape[0]
    A, B, C = plan.A, plan.B, plan.C
    yr, yi = stage1(xr.reshape(V, in_rows, B * C), xi.reshape(V, in_rows, B * C),
                    plan, A, inverse=False)
    zr, zi = middle(yr.view(V, A, B, C), yi.view(V, A, B, C), d_perm, plan)
    return zr.view(V, A, B * C), zi.view(V, A, B * C)


def _apply_stages(xr, xi, d_perm, plan: RadixPlan, in_rows: int, out_rows: int):
    """The cropped apply's three launches: B-2 forward, B-4, B-2 inverse."""
    V = xr.shape[0]
    zr, zi = _forward_and_middle(xr, xi, d_perm, plan, in_rows)
    yr, yi = stage1(zr, zi, plan, out_rows, inverse=True)
    n = out_rows * plan.B * plan.C
    return yr.view(V, n), yi.view(V, n)


class _RadixApply(torch.autograd.Function):
    """The cropped apply with the backward of the JAX package's `_get_apply`:
    the x-cotangent is the apply with the crops swapped; the d-cotangent is
    `middle_wgrad` of the B-2 forwards of x (input crop) and of the
    cotangent g (output crop)."""

    @staticmethod
    def forward(ctx, xr, xi, d_perm, plan, in_rows, out_rows):
        ctx.plan, ctx.rows = plan, (in_rows, out_rows)
        want_x = ctx.needs_input_grad[0] or ctx.needs_input_grad[1]
        want_d = ctx.needs_input_grad[2]
        ctx.save_for_backward(xr if want_d else None, xi if want_d else None,
                              d_perm if want_x else None)
        return _apply_stages(xr, xi, d_perm, plan, in_rows, out_rows)

    @staticmethod
    def backward(ctx, gr, gi):
        xr, xi, d_perm = ctx.saved_tensors
        plan, (in_rows, out_rows) = ctx.plan, ctx.rows
        gr, gi = gr.contiguous(), gi.contiguous()
        gxr = gxi = gd = None
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            gxr, gxi = _apply_stages(gr, gi, d_perm, plan, out_rows, in_rows)
        if ctx.needs_input_grad[2]:
            V, A, B, C = gr.shape[0], plan.A, plan.B, plan.C
            fx = stage1(xr.reshape(V, in_rows, B * C), xi.reshape(V, in_rows, B * C),
                        plan, A, inverse=False)
            fg = stage1(gr.reshape(V, out_rows, B * C), gi.reshape(V, out_rows, B * C),
                        plan, A, inverse=False)
            gd = middle_wgrad(*(t.view(V, A, B, C) for t in fx + fg), plan)
        return gxr, gxi, gd, None, None, None


def fused_circulant_apply_cropped(xr, xi, d_perm, plan: RadixPlan,
                                  in_rows: int, out_rows: int):
    """Cropped-IO packed circulant apply y = P_out C_d P_in^T x.

    xr, xi: (V, in_rows * B * C), the leading slab of the embedded vector
    (everything beyond it is zero).  Returns (V, out_rows * B * C): the
    leading slab of C_d applied to the embedded input.  d_perm is the
    `permute_weights` layout.  Differentiable in xr, xi and d_perm (see the
    module docstring); without a gradient the three launches run directly."""
    if needs_grad(xr, xi, d_perm):
        return _RadixApply.apply(xr, xi, d_perm, plan, in_rows, out_rows)
    return _apply_stages(xr, xi, d_perm, plan, in_rows, out_rows)


def fused_circulant_apply(xr, xi, d_perm, plan: RadixPlan):
    """Packed circulant apply on (V, L) planes: returns (C_d xr, C_d xi) for
    a real even spectrum (two real right-hand sides per complex slot)."""
    return fused_circulant_apply_cropped(xr, xi, d_perm, plan, plan.A, plan.A)


def fused_circulant_apply_cropped_selfdot(xr, xi, d_perm, plan: RadixPlan,
                                          in_rows: int, out_rows: int):
    """Cropped apply plus the input-output inner products: returns
    (yr, yi, dr, di) with y = C_d x cropped as in
    `fused_circulant_apply_cropped`, dr[v] = xr[v] . yr[v] and
    di[v] = xi[v] . yi[v].  Both PCG inner products are self-dots of an
    apply, so the inverse stage emits them."""
    if in_rows != out_rows:
        raise ValueError("the self-dot needs matching in/out crops")
    if needs_grad(xr, xi, d_perm):
        raise no_backward("the self-dot radix apply")
    V = xr.shape[0]
    N = plan.B * plan.C
    zr, zi = _forward_and_middle(xr, xi, d_perm, plan, in_rows)
    yr, yi, dr, di = stage1_inv_dot(zr, zi, xr.reshape(V, out_rows, N),
                                    xi.reshape(V, out_rows, N), plan, out_rows)
    return yr.view(V, out_rows * N), yi.view(V, out_rows * N), dr, di


def fused_circulant_apply_cropped_dual(xr, xi, dA, dB, plan: RadixPlan,
                                       in_rows: int, out_rows: int):
    """Cropped-IO circulant apply with two diagonals sharing one forward
    transform: returns (C_dA x, C_dB x) as ((yAr, yAi), (yBr, yBi)), each
    cropped as in `fused_circulant_apply_cropped`.  One stage-1 forward, one
    dual middle (kernel B-7), two stage-1 inverses.  No solver uses it (the
    PCG's two applies act on different vectors) and it is not
    differentiable, as in the JAX package."""
    V = xr.shape[0]
    A, B, C = plan.A, plan.B, plan.C
    N = B * C
    yr, yi = stage1(xr.reshape(V, in_rows, N), xi.reshape(V, in_rows, N), plan, A,
                    inverse=False)
    z = middle_dual(yr.view(V, A, B, C), yi.view(V, A, B, C), dA, dB, plan)
    outs = []
    for zr, zi in (z[:2], z[2:]):
        ur, ui = stage1(zr.view(V, A, N), zi.view(V, A, N), plan, out_rows, inverse=True)
        outs.append((ur.view(V, out_rows * N), ui.view(V, out_rows * N)))
    return tuple(outs)


def _forward_stages(xr, xi, plan: RadixPlan, in_rows: Optional[int] = None):
    """Forward transform only, plain PyTorch on the plan's tables: (V, rows*B*C)
    -> the (V, A, B, C) planes after T1/F2/T2/F3 (d_perm's layout), as the
    real and imaginary parts."""
    V = xr.shape[0]
    A, B, C = plan.A, plan.B, plan.C
    rows = A if in_rows is None else in_rows
    yr, yi = stage1_plain(xr.reshape(V, rows, B * C), xi.reshape(V, rows, B * C),
                          plan.wac[:, :rows], plan.was[:, :rows])
    y = _middle_forward(torch.complex(yr, yi).view(V, A, B, C),
                        *_middle_tables(plan.L, xr.dtype, xr.device))
    return y.real, y.imag


def stage_order_weights(emb: torch.Tensor, plan: RadixPlan) -> torch.Tensor:
    """(L,) real embedded column -> its unclamped DFT in kernel stage order:
    (A, B, C) with [a, b, c] = DFT(emb)[a + A*b + A*B*c], the layout of
    `permute_weights` without the 1/L.  Computed by the forward stages in
    plain PyTorch in float64 and cast to ``emb``'s dtype: near-zero
    eigenvalues form by cancellation, and the clamp, 1/w and sqrt(w) that
    consume them amplify any rounding noise of a reduced-precision
    transform into O(1) errors on the clamped modes.  The DFT of the real
    even column is real; the imaginary part is rounding noise."""
    plan64 = make_plan(plan.L, torch.float64, emb.device)
    e = emb.to(torch.float64)[None]
    fr, _ = _forward_stages(e, torch.zeros_like(e), plan64)
    return fr[0].to(emb.dtype).contiguous()
