"""Grid-sharded BTTB solves: the expanded grid split over the ranks of a
'grid' mesh axis.

Counterpart of `hipgp_tpu/parallel/fft_sharded.py`.  With P the projector
onto the original grid's positions (a mask in expanded space),
K v = P C P v, so a whole PCG solve runs on expanded-space blocks:

* the circulant apply C (and C^{1/2}, C^{-1}) runs axis by axis with one
  all_to_all pair per direction: transform the local axes, exchange,
  transform the formerly split axis.  Each per-axis transform is the
  real-basis product (an einsum in full FP32) for axes up to
  ``ops.bttb.MATMUL_DFT_MAX_LEN``, or a local complex ``torch.fft`` for
  longer ones (mixing them is exact: the spectrum is real and even along
  every axis, so the real-basis pair rotation commutes with the weights);
* a 1-D grid uses the four-step FFT (L = L0 * L1: a local FFT over one
  factor, the twiddles, an exchange, a local FFT over the other), with the
  spectrum pre-permuted into the four-step output order;
* masks and axpys are local; PCG's inner products sum over the axis.

The JAX package runs these inside ``shard_map`` on one process; here each
rank runs them on its own block and the exchanges are `mesh.all_to_all`
(differentiable).  ``make_spectrum(..., multiple_of=shard_multiples(dims,
n))`` pads the embedding so that the split axes divide n (exact: the
circulant embedding is valid for any length >= 2m - 2).  The product and the
FFT here lie outside every Pallas kernel in the JAX package, so they are
PyTorch library calls here too.

The ``local_*`` functions run on one rank's block (the composable core, as
in the JAX package); `sharded_matmul_by_K`, `sharded_inv_matmul` and
`sharded_gram_solve` take and return whole arrays on every rank.  JAX's
``weights_pspec`` (a PartitionSpec) has no counterpart: :func:`weights_shard`
cuts this rank's block of :func:`host_weights` instead.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..ops import bttb
from ..ops.bttb import (BTTBSpectrum, _axis_contract, _cosine_matrix, _full_weights,
                        _real_fourier_basis, fp32_matmul)
from ..ops.cg import pcg
from .mesh import all_gather, all_reduce, all_to_all, axis_group, axis_index, axis_size

__all__ = [
    "sharded_gram_solve",
    "sharded_inv_matmul",
    "sharded_matmul_by_K",
    "shard_multiples",
    "host_weights",
    "weights_shard",
    "local_circulant_apply",
    "local_spectrum_weights",
    "local_whiten",
    "local_whiten_diff",
    "local_mask",
    "GridShardInfo",
]


# ---------------------------------------------------------------------------
# static shard layout
# ---------------------------------------------------------------------------


class GridShardInfo:
    """Static layout of one expanded grid split n ways.

    nd >= 2: the leading embedded axis is split (rows_per rows a rank); the
    apply trades it against the minor axis with one all_to_all pair, so both
    must divide n.  nd == 1: the length splits as L = L0 * L1 (the
    four-step view, C order: flat = n0 * L1 + n1) with the L0 axis split;
    both factors must divide n.
    """

    def __init__(self, spec: BTTBSpectrum, n_shards: int,
                 matmul_max_len: Optional[int] = None):
        self.dims = spec.dims
        self.edims = spec.edims
        self.n = int(n_shards)
        self.nd = len(spec.dims)
        self.matmul_max_len = (bttb.MATMUL_DFT_MAX_LEN if matmul_max_len is None
                               else matmul_max_len)
        if self.nd == 1:
            L = spec.edims[0]
            self.L0, self.L1 = _split_1d(L, self.n)
            self.rows_per = self.L0 // self.n
            self.local_shape = (self.rows_per, self.L1)  # (n0_local, n1)
            self.Mp_local = L // self.n
        else:
            L0, Lm = spec.edims[0], spec.edims[-1]
            for name, L in (("leading", L0), ("minor", Lm)):
                if L % self.n:
                    raise ValueError(
                        f"expanded {name} dim {L} not divisible by {self.n} shards: "
                        "build the spectrum with make_spectrum(..., "
                        "multiple_of=shard_multiples(dims, n))")
            self.rows_per = L0 // self.n
            self.local_shape = (self.rows_per,) + tuple(self.edims[1:])
            self.Mp_local = spec.Mprime // self.n


def _split_1d(L: int, n: int) -> Tuple[int, int]:
    """L = L0 * L1 with n | L0 and n | L1, L0 as near sqrt(L) as possible
    (a balanced four-step)."""
    best = None
    for L0 in range(1, int(math.isqrt(L)) + 1):
        if L % L0:
            continue
        L1 = L // L0
        for a, b in ((L0, L1), (L1, L0)):
            if a % n == 0 and b % n == 0:
                score = abs(math.log(a) - math.log(b))
                if best is None or score < best[0]:
                    best = (score, a, b)
    if best is None:
        raise ValueError(
            f"cannot split L={L} into two factors both divisible by n={n}; build the "
            "spectrum with make_spectrum(..., multiple_of=shard_multiples(dims, n)) "
            "so L is a multiple of n^2")
    return best[1], best[2]


def shard_multiples(dims: Sequence[int], n_shards: int) -> Tuple[int, ...]:
    """Per-axis ``multiple_of`` for `ops.bttb.make_spectrum` so the embedded
    grid splits evenly n ways: the leading and minor axes divisible by n
    (1-D: the one axis divisible by n^2, for two n-divisible factors)."""
    nd = len(dims)
    if nd == 1:
        return (n_shards * n_shards,)
    return (n_shards,) + (1,) * (nd - 2) + (n_shards,)


# ---------------------------------------------------------------------------
# the weights' layout
# ---------------------------------------------------------------------------


def host_weights(spec: BTTBSpectrum, info: GridShardInfo) -> torch.Tensor:
    """The full (real, even) circulant spectrum laid out for the sharded
    apply: nd >= 2, shape ``edims``, split on the minor axis (the scaling
    happens after the exchange); nd == 1, the four-step output order
    Wt[k0, k1] = W[k1 * L0 + k0], shape (L0, L1), split on k0."""
    wfull = _full_weights(spec.eigs, spec.edims[-1])
    if info.nd == 1:
        return wfull.reshape(info.L1, info.L0).T.contiguous()
    return wfull


def weights_shard(w: torch.Tensor, info: GridShardInfo, index: int) -> torch.Tensor:
    """Rank ``index``'s block of :func:`host_weights` (the block JAX's
    ``weights_pspec`` gives its device)."""
    if info.nd == 1:
        return w[index * info.rows_per:(index + 1) * info.rows_per].contiguous()
    per = info.edims[-1] // info.n
    return w[..., index * per:(index + 1) * per].contiguous()


# ---------------------------------------------------------------------------
# the circulant apply on one rank's block
# ---------------------------------------------------------------------------


def _axis_transform_local(x, L, axis, inverse, max_len):
    """One axis's analysis or synthesis: the real-basis product for short
    axes, a local complex FFT for long ones."""
    if L <= max_len:
        Q = _real_fourier_basis(L, x.real.dtype if x.is_complex() else x.dtype, x.device)
        if inverse:
            Q = Q.T
        if x.is_complex():
            Q = Q.to(x.dtype)
        with fp32_matmul():
            return _axis_contract(x, Q, axis)
    return torch.fft.ifft(x, dim=axis) if inverse else torch.fft.fft(x, dim=axis)


def local_circulant_apply(x: torch.Tensor, w_local: torch.Tensor, info: GridShardInfo,
                          group) -> torch.Tensor:
    """C applied to this rank's block of expanded-space vectors.

    x: (B, *info.local_shape) real.  w_local: this rank's block of
    :func:`host_weights` (an elementwise function of it, sqrt or reciprocal,
    commutes with the layout).  Returns (B, *info.local_shape), x's dtype.
    """
    if info.nd == 1:
        return _four_step_apply(x, w_local, info, group)
    nd, dtype, edims, max_len = info.nd, x.dtype, info.edims, info.matmul_max_len
    # analysis over the local trailing axes, minor first
    for a in range(-1, -nd, -1):
        x = _axis_transform_local(x, edims[a], a, False, max_len)
    # (B, L0/n, ..., Lm) -> (B, L0, ..., Lm/n)
    x = all_to_all(x, group, split_axis=x.ndim - 1, concat_axis=1)
    x = _axis_transform_local(x, edims[0], -nd, False, max_len)
    x = x * w_local
    x = _axis_transform_local(x, edims[0], -nd, True, max_len)
    x = all_to_all(x, group, split_axis=1, concat_axis=x.ndim - 1)
    for a in range(-nd + 1, 0):
        x = _axis_transform_local(x, edims[a], a, True, max_len)
    if x.is_complex():
        x = x.real.to(dtype)
    return x


def _complex_of(dtype):
    return torch.complex128 if dtype == torch.float64 else torch.complex64


# the four-step twiddles by (L0, L1, n, rank, dtype, device): every apply of a
# solve takes the same table
_TWIDDLES = {}


def _four_step_twiddle(info: GridShardInfo, group, cdtype, device) -> torch.Tensor:
    """exp(-2 pi i k0 n1 / L) for every k0 and this rank's n1, the phase
    reduced modulo L in integers and taken in float64."""
    L0, L1, L = info.L0, info.L1, info.L0 * info.L1
    rank = dist.get_rank(group)
    key = (L0, L1, info.n, rank, cdtype, str(device))
    if key not in _TWIDDLES:
        per = L1 // info.n
        n1g = rank * per + np.arange(per, dtype=np.int64)
        phase = (np.arange(L0, dtype=np.int64)[:, None] * n1g[None, :]) % L
        _TWIDDLES[key] = torch.as_tensor(np.exp((-2j * np.pi / L) * phase)).to(
            dtype=cdtype, device=device)
    return _TWIDDLES[key]


def _four_step_forward(z, tw, info: GridShardInfo, group):
    """The distributed four-step DFT: the (B, L0/n, L1) n0-split C-order view
    -> (B, L0/n, L1) in the four-step output order z[k0_local, k1] with
    X[k1 L0 + k0] = z[k0, k1] (the layout of :func:`host_weights`)."""
    z = all_to_all(z, group, split_axis=2, concat_axis=1)   # -> (B, L0, L1/n)
    z = torch.fft.fft(z, dim=1) * tw[None]                  # DFT over n0, twiddles
    z = all_to_all(z, group, split_axis=1, concat_axis=2)   # -> (B, L0/n, L1)
    return torch.fft.fft(z, dim=2)                          # DFT over n1


def _four_step_inverse(z, tw, info: GridShardInfo, group):
    """The inverse of :func:`_four_step_forward` (the same layouts)."""
    z = torch.fft.ifft(z, dim=2)
    z = all_to_all(z, group, split_axis=2, concat_axis=1)
    z = torch.fft.ifft(z * torch.conj(tw)[None], dim=1)
    return all_to_all(z, group, split_axis=1, concat_axis=2)


def _four_step_apply(x, wt_local, info: GridShardInfo, group):
    """The 1-D circulant apply by the distributed four-step FFT: x is
    (B, rows_per, L1), the rows of the (L0, L1) view of the flat expanded
    vector; wt_local the rank's (L0/n, L1) block of the four-step-ordered
    spectrum."""
    dtype = x.dtype
    cdtype = _complex_of(dtype)
    tw = _four_step_twiddle(info, group, cdtype, x.device)
    z = _four_step_forward(x.to(cdtype), tw, info, group)
    z = _four_step_inverse(z * wt_local[None], tw, info, group)
    return z.real.to(dtype)


def local_spectrum_weights(xgrids, kernel_fn, info: GridShardInfo, group,
                           jitter: float = 1e-3, eig_floor: float = 1e-6) -> torch.Tensor:
    """This rank's block of the circulant spectrum in the
    :func:`host_weights` layout, built without any rank holding all M'
    eigenvalues: the kernel at this rank's slice of the wrapped-lag embedded
    column (`ops.bttb.make_spectrum`'s, distributed), then one distributed
    forward DFT (the cosine product per short axis, a local FFT per long
    one, and the exchange for the leading axis; the four-step forward in
    1-D).  Differentiable in the hyperparameters ``kernel_fn`` closes over."""
    xgrids = [torch.as_tensor(g) for g in xgrids]
    dtype, dev = xgrids[0].dtype, xgrids[0].device
    edims = info.edims
    gidx = dist.get_rank(group)

    def wrapped_lag(flat_idx, L, g):
        lag = torch.minimum(flat_idx, L - flat_idx).to(dtype) * (g[1] - g[0])
        return g[0] + lag

    if info.nd == 1:
        flat = gidx * info.Mp_local + torch.arange(info.Mp_local, device=dev)
        pts = wrapped_lag(flat, edims[0], xgrids[0])[:, None]
        c = kernel_fn(xgrids[0][:1, None], pts)[0]
        c = c + jitter * (flat == 0).to(dtype)
        cdtype = _complex_of(dtype)
        tw = _four_step_twiddle(info, group, cdtype, dev)
        w = _four_step_forward(c.reshape(1, info.rows_per, info.L1).to(cdtype), tw, info,
                               group)
        return torch.clamp(w[0].real.to(dtype), min=eig_floor)

    rows_per = info.rows_per
    r = gidx * rows_per + torch.arange(rows_per, device=dev)
    coords = [wrapped_lag(r, edims[0], xgrids[0])]
    for g, L in zip(xgrids[1:], edims[1:]):
        coords.append(wrapped_lag(torch.arange(L, device=dev), L, g))
    mesh_pts = torch.meshgrid(*coords, indexing="ij")
    pts = torch.stack([m.reshape(-1) for m in mesh_pts], dim=-1)
    origin = torch.stack([g[0] for g in xgrids])[None, :]
    c = kernel_fn(origin, pts)[0]
    is_origin = float(gidx == 0)
    c = torch.cat([c[:1] + jitter * is_origin, c[1:]])
    x = c.reshape((rows_per,) + tuple(edims[1:]))
    max_len, nd = info.matmul_max_len, info.nd

    def axis_dft(x, L, axis):
        # the true DFT per axis (real: the embedded column is even on every axis)
        if L <= max_len:
            with fp32_matmul():
                return _axis_contract(x, _cosine_matrix(L, dtype, dev), axis)
        return torch.fft.fft(x.to(_complex_of(dtype)), dim=axis).real.to(dtype)

    for a in range(-1, -nd, -1):
        x = axis_dft(x, edims[a], a)
    # (L0/n, ..., Lm) -> (L0, ..., Lm/n): the host_weights minor-split layout
    x = all_to_all(x, group, split_axis=x.ndim - 1, concat_axis=0)
    x = axis_dft(x, edims[0], -nd)
    return torch.clamp(x, min=eig_floor)


def local_mask(info: GridShardInfo, shard_idx: int, dtype, device=None) -> torch.Tensor:
    """(Mp_local,) flat mask of the original grid's positions in block
    ``shard_idx``."""
    dims, edims = info.dims, info.edims
    if info.nd == 1:
        flat = shard_idx * info.Mp_local + torch.arange(info.Mp_local, device=device)
        return (flat < dims[0]).to(dtype)
    rows_per = info.rows_per
    r = shard_idx * rows_per + torch.arange(rows_per, device=device)
    mask = (r < dims[0]).to(dtype).reshape((rows_per,) + (1,) * (len(dims) - 1))
    for a in range(1, len(dims)):
        shape = [1] * len(dims)
        shape[a] = edims[a]
        mask = mask * (torch.arange(edims[a], device=device) < dims[a]).to(dtype).reshape(shape)
    return mask.reshape(-1)


def _grid_dot(group):
    """PCG's inner product over the rows' blocks: summed over the group."""
    def dot(a, b):
        return all_reduce([torch.sum(a * b, dim=-1)], group)[0]

    return dot


def _cmul(vflat, w, info, group):
    B = vflat.shape[0]
    v = vflat.reshape((B,) + info.local_shape)
    return local_circulant_apply(v, w, info, group).reshape(B, -1)


def _local_solve(x_local, w_local, info, group, mode, maxiter, tol, mask=None):
    """'apply' (K x), 'solve' (K^{-1} x by the masked PCG with the circulant
    preconditioner) or 'whiten' (R^T K^{-1} x = C^{1/2} [K^{-1} x; 0]) on
    this rank's (B, Mp_local) block."""
    if mask is None:
        mask = local_mask(info, dist.get_rank(group), x_local.dtype, x_local.device)
    kv = lambda v: mask * _cmul(v * mask, w_local, info, group)
    if mode == "apply":
        return kv(x_local)
    cinv = lambda v: mask * _cmul(v * mask, 1.0 / w_local, info, group)
    sol = pcg(kv, x_local * mask, precond=cinv, maxiter=maxiter, tol=tol,
              dot_fn=_grid_dot(group))
    if mode == "solve":
        return sol
    return _cmul(sol * mask, torch.sqrt(w_local), info, group)


def local_whiten(x_local: torch.Tensor, w_local: torch.Tensor, info: GridShardInfo,
                 group, maxiter: int = 20, tol: float = 1e-8,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """kn = R^T K^{-1} x on this rank's block: x_local (B, Mp_local), its
    block of the expanded-space embedding of the right-hand side (original
    entries in place, zeros elsewhere); returns its (B, Mp_local) block of
    the whitened (B, M') result."""
    return _local_solve(x_local, w_local, info, group, "whiten", maxiter, tol, mask)


class _ShardedSolve(torch.autograd.Function):
    """sol = (P C P)^{-1} P x by the masked PCG, implicitly differentiated:
    the backward solves again on the cotangent (lambda; the operator is
    symmetric), gives mask * lambda for x and -d<lambda, P C_w P sol>/dw for
    the weights (the preconditioner's weights are held constant)."""

    @staticmethod
    def forward(ctx, x_local, w_local, info, group, maxiter, tol, mask):
        sol = _local_solve(x_local, w_local, info, group, "solve", maxiter, tol, mask)
        ctx.save_for_backward(sol, w_local, mask)
        ctx.args = (info, group, maxiter, tol)
        return sol

    @staticmethod
    def backward(ctx, g):
        sol, w, mask = ctx.saved_tensors
        info, group, maxiter, tol = ctx.args
        lam = _local_solve(g, w, info, group, "solve", maxiter, tol, mask)
        g_w = None
        if ctx.needs_input_grad[1]:
            with torch.enable_grad():
                w_ = w.detach().requires_grad_()
                y = mask * _cmul(sol * mask, w_, info, group)
                # the VJP at -lam as the gradient of a scalar (explicit
                # grad_outputs would import sympy on first use)
                (g_w,) = torch.autograd.grad(-torch.sum(y * lam), w_)
        return (mask * lam if ctx.needs_input_grad[0] else None), g_w, None, None, None, None, None


def local_whiten_diff(x_local: torch.Tensor, w_local: torch.Tensor, info: GridShardInfo,
                      group, maxiter: int = 20, tol: float = 1e-8,
                      mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Differentiable :func:`local_whiten`: gradients in the right-hand side
    and the weights (so, through :func:`local_spectrum_weights`, in the
    kernel's hyperparameters) flow implicitly through the truncated PCG
    (`_ShardedSolve`) and through the final C^{1/2} apply; the sharded
    counterpart of `ops.solve.whiten`.  x_local: (B, Mp_local)."""
    if mask is None:
        mask = local_mask(info, dist.get_rank(group), x_local.dtype, x_local.device)
    sol = _ShardedSolve.apply(x_local, w_local, info, group, maxiter, tol, mask)
    return _cmul(sol * mask, torch.sqrt(w_local), info, group)


# ---------------------------------------------------------------------------
# whole arrays in and out
# ---------------------------------------------------------------------------


def sharded_matmul_by_K(spec: BTTBSpectrum, v: torch.Tensor, mesh, axis: str = "grid",
                        matmul_max_len: Optional[int] = None) -> torch.Tensor:
    """K @ v with the expanded grid split over ``axis``; v: (B, M) on every
    rank, the (B, M) result on every rank."""
    return _solve_or_apply(spec, v, mesh, axis, "apply", matmul_max_len=matmul_max_len)


def sharded_inv_matmul(spec: BTTBSpectrum, b: torch.Tensor, mesh, axis: str = "grid",
                       maxiter: int = 20, tol: float = 1e-8,
                       matmul_max_len: Optional[int] = None) -> torch.Tensor:
    """K^{-1} b by the masked PCG over the grid's blocks; (B, M) -> (B, M)."""
    return _solve_or_apply(spec, b, mesh, axis, "solve", maxiter, tol, matmul_max_len)


def sharded_gram_solve(spec: BTTBSpectrum, b: torch.Tensor, mesh, axis: str = "grid",
                       maxiter: int = 20, tol: float = 1e-8,
                       matmul_max_len: Optional[int] = None) -> torch.Tensor:
    """K^{-1/2} b = R^T K^{-1} b, grid-sharded; (B, M) -> (B, M')."""
    return _solve_or_apply(spec, b, mesh, axis, "whiten", maxiter, tol, matmul_max_len)


def _embed_full(spec: BTTBSpectrum, b: torch.Tensor) -> torch.Tensor:
    """(B, M) -> the (B, M') zero-padded expanded-space embedding, flat."""
    B = b.shape[0]
    x = b.reshape((B,) + tuple(spec.dims))
    pad = []
    for d, e in zip(reversed(spec.dims), reversed(spec.edims)):
        pad += [0, e - d]
    return torch.nn.functional.pad(x, pad).reshape(B, -1)


def _crop_full(spec: BTTBSpectrum, y: torch.Tensor) -> torch.Tensor:
    """(B, M') expanded, flat -> the (B, M) original-grid entries."""
    B = y.shape[0]
    y = y.reshape((B,) + tuple(spec.edims))
    return y[(slice(None),) + tuple(slice(0, d) for d in spec.dims)].reshape(B, -1)


def _solve_or_apply(spec, b, mesh, axis, mode, maxiter=20, tol=1e-8, matmul_max_len=None):
    n, index, group = axis_size(mesh, axis), axis_index(mesh, axis), axis_group(mesh, axis)
    info = GridShardInfo(spec, n, matmul_max_len=matmul_max_len)
    x = _embed_full(spec, b)[:, index * info.Mp_local:(index + 1) * info.Mp_local]
    w = weights_shard(host_weights(spec, info), info, index)
    out = all_gather(_local_solve(x, w, info, group, mode, maxiter, tol), group, axis=1)
    return out if mode == "whiten" else _crop_full(spec, out)
