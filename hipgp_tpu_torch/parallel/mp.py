"""Model-parallel HIP-GP: the whitened state split over a 'grid' mesh axis,
composed with data parallelism over a 'dp' axis.

Counterpart of `hipgp_tpu/parallel/mp.py`.  A mean-field or block HIP-GP
whose whitened state (theta1, theta2, Lambda: M' entries, or the block
axis), whose cross-covariances kn (N x M') and whose every whitening
transform live in blocks of M'/n_grid a rank, while the data rows are split
n_dp ways at the same time.  The math is the single-device model's:

* Knm is evaluated in each rank's block of the EXPANDED layout: each grid
  rank computes the kernel against its own rows of inducing points only
  (a rank whose block lies wholly in the circulant padding computes none);
* the whitening PCG runs on the expanded-space blocks
  (`fft_sharded.local_whiten`: per-axis transforms and all_to_all, dots
  summed over the grid);
* Lambda (family-shaped) and b accumulate locally and are summed over 'dp'
  only;
* the optimal mean (I + sum_n kn_n kn_n^T / s_n^2) m = b is solved by CG
  with the kn stack kept split both ways: each matvec sums kn @ m over
  'grid' and kn^T (ivar u) over 'dp' ('cg'), or through the original-space
  data Gram A and the grid-split circulant apply ('gram', 'factored');
* prediction sums the per-row contractions (kn.qm, kn.kn, kn S kn) over
  'grid';
* natural-gradient training runs the model's own ``elbo_and_grads`` with
  :func:`make_mp_kn_fn` as its ``kn_fn``: the grid-split differentiable
  whitening (`fft_sharded.local_whiten_diff`), so hyperparameters learn
  through the split solve.

The JAX package runs this on one process over global arrays, and XLA puts a
``psum`` into every contraction over M'.  The port runs one process a rank
(SPMD) and holds no global array, so each sum over M' is an explicit
all-reduce over the grid ranks: in the model, the per-row sums of
``batch_an`` pass `mesh.sum_over`, whose gradient is each rank's share; the
terms every grid rank computes whole (Knn, the noise) enter the summed
hyper-gradient from grid rank 0 only; the KL is each rank's coordinates or
blocks, summed over the grid; the natural gradient stays on the rank's
block of M' and is summed over 'dp' only.  A state under 'mp' is each
rank's block (:func:`mp_shard_state`); :func:`mp_gather_state` rebuilds the
whole state on every rank (the port's counterpart of reading a JAX global
array), for checkpoints and for the caller.

Supported families: 'mean-field' and 'block'.  The block family needs the
leading block edge to divide the rank's row count (rows_per =
edims[0]/n_grid; in 1-D the rank's length), so that every block lies on one
rank and the global block numbering is rank-contiguous.  A rank's block of
the expanded grid is a contiguous run of the flat index: the leading rows
in 2-D and 3-D, the n0 rows of the four-step view (flat = n0 L1 + n1) in
1-D.  Row padding and micro-batches are JAX's: ``ceil(min(batch, N) /
n_dp)`` rows a rank a step, pad rows of weight 0 and noise 1.  Where the
port's single-device solvers differ from JAX on purpose, so do these: A,
b_m and the ELBO scalars of 'gram' and 'factored' are summed in
``GRAM_ACC_DTYPE`` (float64), and 'factored''s default jitter is keyed on
the factor's dtype.  The Monte-Carlo estimator's offset is drawn once a
micro-batch (or a kn_fn call) on every rank from the caller's generator,
which every rank seeds alike: the same draws as the single-device model's.
"""
from __future__ import annotations

import copy
import dataclasses
import math
import types
import warnings
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels.interdomain import k_semi_mc, k_semi_sqexp
from ..models import hipgp as _hipgp
from ..models.hipgp import GRAM_ACC_DTYPE, MEAN_PCG_STATS, FactoredSolveInconsistency
from ..ops.bttb import MATMUL_DFT_MAX_LEN, fp32_matmul
from ..ops.cg import pcg_result
from ..utils import blocks as blk
from .dp import _local, _rank_rows
from .fft_sharded import (GridShardInfo, _grid_dot, host_weights, local_circulant_apply,
                          local_mask, local_spectrum_weights, local_whiten,
                          local_whiten_diff, weights_shard)
from .mesh import all_gather, all_reduce, axis_group, axis_index, axis_size
from .multihost import GlobalBatch

__all__ = [
    "mp_batch_solve",
    "mp_predict",
    "mp_shard_state",
    "mp_gather_state",
    "grid_state_spec",
    "make_mp_kn_fn",
    "mp_elbo_and_grads",
    "mp_svigp_fit",
]

LN2PI = math.log(2.0 * math.pi)
# rows of the Cholesky factor of A whitened per solve in 'factored' (JAX's)
FACTOR_ROWS = 512


def _check_model(model):
    if model.family not in ("mean-field", "block"):
        raise ValueError(
            "grid-sharded (model-parallel) HIP-GP supports the mean-field "
            f"and block families; got {model.family!r}")
    if model.whitened_type != "ziggy":
        raise ValueError("grid sharding requires whitened_type='ziggy'")


def _static_shard_info(model, n_shards: int) -> GridShardInfo:
    """The grid's layout over ``n_shards`` ranks from the model's dims alone
    (it does not depend on the hyperparameters)."""
    return GridShardInfo(types.SimpleNamespace(dims=model.dims, edims=model.edims,
                                               Mprime=model.Mprime), n_shards)


def _local_block_indices(model, info: GridShardInfo):
    """(blk_idx, inverse, nb_local) of the blocks one grid rank owns, as
    tensors on the model's device.  Every rank has the same LOCAL tables: a
    rank's block is the C order of ``(rows_per,) + edims[1:]`` (a run of
    ``Mp_local`` entries in 1-D), and blocks enumerate the leading chunk
    coordinate slowest, so `utils.blocks.block_indices` over the local dims
    gives the rank's slice of the global enumeration."""
    sizes = model.block_sizes
    if info.nd == 1:
        local_dims = (info.Mp_local,)
        if info.Mp_local % sizes[0]:
            raise ValueError(
                f"block size {sizes[0]} does not divide the per-shard length "
                f"{info.Mp_local} (= edims[0]/n_grid); choose a block size "
                "dividing it, or fewer shards")
    else:
        local_dims = (info.rows_per,) + tuple(info.edims[1:])
        if info.rows_per % sizes[0]:
            raise ValueError(
                f"leading block chunk {sizes[0]} does not divide the "
                f"per-shard row count {info.rows_per} (= edims[0]/n_grid); "
                "choose an aligned block size, or fewer shards")
    bidx, binv = blk.block_indices(local_dims, sizes)
    return (torch.as_tensor(bidx, device=model.device),
            torch.as_tensor(binv, device=model.device), bidx.shape[0])


def _local_model(model, info: GridShardInfo):
    """The model as one grid rank sees it: M' is the rank's Mp_local and a
    block model's index tables are the rank's (`_local_block_indices`), so
    the family's methods (standard_params, get_lam, compute_knSkn,
    kl_to_prior, the natural gradient) act on the rank's block."""
    view = copy.copy(model)
    view.Mprime = info.Mp_local
    if model.family == "block":
        view.blk_idx, view.blk_inv, view.num_blocks = _local_block_indices(model, info)
    return view


class _Grid:
    """One rank's place on the ('dp', 'grid') mesh: both axes' sizes,
    indices and process groups, the grid's layout, the rank's view of the
    model and its mask of original-grid positions."""

    def __init__(self, model, mesh, dp_axis: str, grid_axis: str):
        self.model, self.mesh, self.dp_axis, self.grid_axis = model, mesh, dp_axis, grid_axis
        self.ndp, self.dpi = axis_size(mesh, dp_axis), axis_index(mesh, dp_axis)
        self.ng, self.gidx = axis_size(mesh, grid_axis), axis_index(mesh, grid_axis)
        self.dp, self.grid = axis_group(mesh, dp_axis), axis_group(mesh, grid_axis)
        self.info = _static_shard_info(model, self.ng)
        self.offset = self.gidx * self.info.Mp_local
        self.view = _local_model(model, self.info)
        self.mask = local_mask(self.info, self.gidx, model.dtype, model.device)
        self._orig = None

    @property
    def orig(self):
        """(idx, valid) of `_local_orig_indices`, built once."""
        if self._orig is None:
            self._orig = _local_orig_indices(self.model, self.info, self.gidx)
        return self._orig

    def weights(self, state, spectrum_mode: str, transform: str = "fft"):
        """This rank's block of the circulant spectrum at the state's
        hyperparameters: cut from the whole spectrum ('host') or built
        without any rank holding all M' eigenvalues ('sharded');
        differentiable in the hyperparameters either way."""
        model = self.model
        if spectrum_mode == "host":
            spec = model.spectrum(state, transform=transform)
            return weights_shard(host_weights(spec, self.info), self.info, self.gidx)
        p = model.kernel_params(state)
        return local_spectrum_weights(model.xgrids, lambda a, b: model.kernel(a, b, p),
                                      self.info, self.grid, jitter=model.jitter)

    def local_state(self, state):
        """The state's block on this rank: a whole state is cut
        (:func:`mp_shard_state`), a block is returned as it is."""
        if state.theta1.shape[0] == self.info.Mp_local:
            return state
        return mp_shard_state(state, self.mesh, self.grid_axis)


# ---------------------------------------------------------------------------
# cross-covariances in the expanded layout
# ---------------------------------------------------------------------------


def _mc_offset(generator, npts: int) -> float:
    """The Monte-Carlo estimator's stratified offset u ~ U[0, 1/npts), drawn
    as `kernels.k_semi_mc` draws it (from a fresh seed-0 generator when
    ``generator`` is None)."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return float(torch.rand((), generator=generator, dtype=torch.float64)) / npts


def _cross_cov(model, params, pts, x, integrated_obs, estimator, samps, u):
    """(rows of x, points) cross-covariance, as `HIPGP.make_grams` builds
    its Knm (``u``: the Monte-Carlo estimator's offset)."""
    if not integrated_obs:
        return model.kernel(x, pts, params)
    if estimator == "analytic":
        if not getattr(model.kernel, "has_k_semi", False):
            raise ValueError(
                "analytic semi-integrated estimator requires a kernel "
                "with a closed form (SqExp); use 'mc-biased'")
        return k_semi_sqexp(pts, x, params).T
    if estimator == "mc-biased":
        return k_semi_mc(model.kernel, pts, x, params, npts=samps, u=u).T
    raise ValueError(f"unknown estimator {estimator!r}")


def _knn_diag(model, params, x, integrated_obs):
    if not integrated_obs:
        return model.kernel.diag(x, params)
    if model.diag_interp is None:
        raise ValueError("integrated_obs requires support_integrated_obs=True at build")
    return model.diag_interp(x, params)


def _full_knm(model, params, x, integrated_obs=False, semi_integrated_estimator="analytic",
              semi_integrated_samps=10, u=None):
    """(bsz, M) ORIGINAL-space cross-covariance: the 'gram' and 'factored'
    solvers' M-space accumulation unit (whole on every grid rank; M is
    small where they are used, M' is what is split)."""
    return _cross_cov(model, params, model.xinduce, x, integrated_obs,
                      semi_integrated_estimator, semi_integrated_samps, u)


def _local_orig_indices(model, info: GridShardInfo, gidx: int):
    """(flat original-space indices (Mp_local,), validity mask) of this
    rank's expanded slots: slot j holds original entry idx[j] where
    mask[j], and idx[j] is clipped junk elsewhere."""
    dims, dev = model.dims, model.device
    if info.nd == 1:
        flat = gidx * info.Mp_local + torch.arange(info.Mp_local, device=dev)
        return torch.clamp(flat, 0, dims[0] - 1), flat < dims[0]
    rows_per = info.rows_per
    r = gidx * rows_per + torch.arange(rows_per, device=dev)
    tshape = info.edims[1:]
    tidx = torch.zeros((), dtype=torch.long, device=dev)
    tvalid = torch.ones((), dtype=torch.bool, device=dev)
    stride = 1
    # the trailing original flat index and its validity, axis by axis (C order)
    for a in range(len(dims) - 1, 0, -1):
        shape = [1] * (len(dims) - 1)
        shape[a - 1] = tshape[a - 1]
        j = torch.arange(tshape[a - 1], device=dev).reshape(shape)
        tidx = tidx + torch.clamp(j, max=dims[a] - 1) * stride
        tvalid = tvalid & (j < dims[a])
        stride *= dims[a]
    idx = torch.clamp(r, 0, dims[0] - 1)[:, None] * stride + tidx.reshape(1, -1)
    valid = (r < dims[0])[:, None] & tvalid.reshape(1, -1)
    return idx.reshape(-1), valid.reshape(-1)


def _local_embed_from_orig(v, idx, mask):
    """(B, M) original-space vectors (whole on every rank) -> this rank's
    (B, Mp_local) expanded block (original entries in place, zeros
    elsewhere)."""
    return v[:, idx] * mask.to(v.dtype)[None, :]


def _local_crop_psum(out_local, idx, mask, M: int, group):
    """(B, Mp_local) expanded blocks -> the (B, M) original-space vectors on
    every rank: each rank adds its slots into place (`index_add_`), and the
    sum over the grid puts every original slot, owned by one rank, whole."""
    vals = out_local * mask.to(out_local.dtype)[None, :]
    full = torch.zeros((out_local.shape[0], M), dtype=out_local.dtype,
                       device=out_local.device).index_add_(1, idx, vals)
    return all_reduce([full], group)[0]


def _local_points(model, info: GridShardInfo, gidx: int):
    """(the inducing points of this rank's valid expanded rows, their
    count): the leading-axis rows in [gidx rows_per, ...) that lie on the
    original grid (in 1-D the run of Mp_local points).  Decided on host
    integers: a rank wholly in the circulant padding has none."""
    dims = model.dims
    if info.nd == 1:
        f0 = gidx * info.Mp_local
        nv = max(0, min(info.Mp_local, dims[0] - f0))
        return model.xgrids[0][f0:f0 + nv, None], nv
    r0 = gidx * info.rows_per
    nv = max(0, min(info.rows_per, dims[0] - r0))
    mesh = torch.meshgrid(model.xgrids[0][r0:r0 + nv], *model.xgrids[1:], indexing="ij")
    return torch.stack([m.reshape(-1) for m in mesh], dim=-1), nv


def _local_embedded_knm(model, params, xb, info: GridShardInfo, gidx: int,
                        integrated_obs: bool = False,
                        semi_integrated_estimator: str = "analytic",
                        semi_integrated_samps: int = 10, u: Optional[float] = None):
    """This rank's (bsz, Mp_local) block of the circulant embedding of Knm:
    k(x_b, z_j) at the original grid's positions, zeros on the padding.
    The kernel is evaluated only against the rank's own valid inducing
    rows; a rank wholly in the padding (up to half of them, the upper rows
    of the expanded leading axis) evaluates nothing (JAX's ``lax.cond``,
    here an ``if`` on host integers)."""
    bsz = xb.shape[0]
    pts, nv = _local_points(model, info, gidx)
    if nv == 0:
        return torch.zeros((bsz, info.Mp_local), dtype=model.dtype, device=xb.device)
    K = _cross_cov(model, params, pts, xb, integrated_obs, semi_integrated_estimator,
                   semi_integrated_samps, u)
    if info.nd == 1:
        return F.pad(K, (0, info.Mp_local - nv))
    dims, edims = model.dims, info.edims
    x = K.reshape((bsz, nv) + tuple(dims[1:]))
    pad = []
    for d, e in zip(reversed(dims[1:]), reversed(edims[1:])):
        pad += [0, e - d]
    pad += [0, info.rows_per - nv]
    return F.pad(x, pad).reshape(bsz, -1)


# ---------------------------------------------------------------------------
# the state's layout
# ---------------------------------------------------------------------------


def grid_state_spec(model=None, grid_axis: str = "grid"):
    """HIPGPState-shaped: the mesh axis along which each leaf's leading axis
    is cut (the theta leaves; a block theta2 on its block axis), None for a
    leaf kept whole on every rank (the log-hyperparameters).  JAX's
    ``P(grid_axis)`` / ``P()``; :func:`mp_shard_state` cuts by it."""
    from ..models.hipgp import HIPGPState

    return HIPGPState(theta1=grid_axis, theta2=grid_axis, log_sig2=None, log_ell=None,
                      log_noise2=None)


def _cut_leaves(state, mesh, grid_axis, fn):
    spec = grid_state_spec(None, grid_axis)
    return state.replace(**{f.name: fn(getattr(state, f.name))
                            for f in dataclasses.fields(state)
                            if getattr(spec, f.name) is not None})


def mp_shard_state(state, mesh, grid_axis: str = "grid"):
    """This rank's block of a whole mean-field or block state: the theta
    leaves cut along their leading axis into one block a grid rank (a block
    theta2 on its block axis), the scalars kept whole."""
    n, i = axis_size(mesh, grid_axis), axis_index(mesh, grid_axis)

    def cut(a):
        if a.shape[0] % n:
            raise ValueError(f"a state leaf of leading length {a.shape[0]} does not "
                             f"split over {n} grid ranks")
        per = a.shape[0] // n
        return a[i * per:(i + 1) * per].clone()

    return _cut_leaves(state, mesh, grid_axis, cut)


def mp_gather_state(state, mesh, grid_axis: str = "grid"):
    """The whole state on every rank from each grid rank's block (the
    inverse of :func:`mp_shard_state`; a collective over the grid: every
    grid rank calls it).  The port's counterpart of reading a JAX global
    array: checkpoints, `convert.state_to_numpy` and a single-device
    ``predict`` take the whole state."""
    group = axis_group(mesh, grid_axis)
    return _cut_leaves(state, mesh, grid_axis,
                       lambda a: all_gather(a.contiguous(), group, axis=0))


# ---------------------------------------------------------------------------
# the closed-form solve
# ---------------------------------------------------------------------------


def _sharded_spectrum_kappa(w_local, g: _Grid) -> float:
    """The spectrum's dynamic range from each grid rank's block of it (no
    rank holds all M' eigenvalues): the extrema reduced by MAX and MIN
    (JAX's ``pmax`` / ``pmin``)."""
    (hi,) = all_reduce([torch.max(w_local)], g.grid, op="max")
    (lo,) = all_reduce([torch.min(w_local)], g.grid, op="min")
    return float(hi) / float(lo)


class _Rows:
    """The micro-batches of this rank's rows: (nsteps, bsz_loc, ...) x, y,
    weights and noise (the noise exp(log_noise2 / 2) where none is given),
    and N, the sum of the weights over 'dp' (the real rows)."""

    def __init__(self, model, state, g: _Grid, xobs, yobs, noise_std, batch_size,
                 row_weights):
        x = _local(xobs, model)
        n_global = xobs.n_global if isinstance(xobs, GlobalBatch) else None
        n_rows = x.shape[0] if n_global is None else n_global
        y = _local(yobs, model).reshape(-1)
        ns = None if noise_std is None else _local(noise_std, model).reshape(-1)
        w = (torch.ones((x.shape[0],), dtype=model.dtype, device=model.device)
             if row_weights is None else _local(row_weights, model).reshape(-1))
        bs = min(batch_size, n_rows) if batch_size > 0 else n_rows
        self.x, self.y, self.w, ns = _rank_rows(g.ndp, g.dpi, x, y, ns, w, bs, n_global)
        self.has_noise = ns is not None
        self.ns = (torch.exp(0.5 * state.log_noise2) * torch.ones_like(self.w)
                   if ns is None else ns)
        self.nsteps = self.x.shape[0]
        (self.N,) = all_reduce([torch.sum(self.w)], g.dp)

    def ivar(self, i):
        return self.w[i] / (self.ns[i] * self.ns[i])

    def noise(self, i):
        """batch_an's noise_std: None on the model-noise path."""
        return self.ns[i] if self.has_noise else None


def _sweep_kn(model, params, g: _Grid, w_loc, rows: _Rows, i, flags, maxiter_cg, tol, u):
    """This rank's (bsz_loc, Mp_local) block of micro-batch i's whitened kn."""
    knm = _local_embedded_knm(model, params, rows.x[i], g.info, g.gidx, u=u, **flags)
    return local_whiten(knm, w_loc, g.info, g.grid, maxiter=maxiter_cg, tol=tol, mask=g.mask)


def _gram_sweep(model, params, g, w_loc, rows, flags, maxiter_cg, tol, generator, kn=True):
    """The one data sweep of 'gram' (with ``kn``) and 'factored' (without),
    the port's `HIPGP._gram_sweep` on this rank's rows: the rank's block of
    Lambda (grid-split) and sum ivar kn.kn (a grid partial) from the split
    whitening, and beside them the whole A, b_m and the ELBO scalars in
    GRAM_ACC_DTYPE; everything summed over 'dp', sum ivar kn.kn also over
    the grid."""
    acc, dev, M = GRAM_ACC_DTYPE, model.device, model.M
    mc = flags["integrated_obs"] and flags["semi_integrated_estimator"] == "mc-biased"
    lam = g.view._lam_zeros() if kn else None
    A = torch.zeros((M, M), dtype=acc, device=dev)
    bm = torch.zeros((M,), dtype=acc, device=dev)
    sy2, sKnn, sknkn, slog = (torch.zeros((), dtype=acc, device=dev) for _ in range(4))
    for i in range(rows.nsteps):
        u = _mc_offset(generator, flags["semi_integrated_samps"]) if mc else None
        xl, wb, nsb = rows.x[i], rows.w[i], rows.ns[i]
        ivar = rows.ivar(i)
        if kn:
            kn_i = _sweep_kn(model, params, g, w_loc, rows, i, flags, maxiter_cg, tol, u)
            lam += g.view.get_lam(ivar, kn_i, bscale=1.0, add_identity=False)
            with fp32_matmul():
                knkn = torch.einsum("bi,bi->b", kn_i, kn_i)
            del kn_i
        Knm = _full_knm(model, params, xl, u=u, **flags).to(acc)
        ivar, yv = ivar.to(acc), rows.y[i].to(acc)
        A.addmm_(Knm.T, Knm * ivar[:, None])
        bm += Knm.T @ (ivar * yv)
        del Knm
        if kn:
            sknkn += torch.sum(ivar * knkn)
        sy2 += torch.sum(ivar * yv * yv)
        sKnn += torch.sum(ivar * _knn_diag(model, params, xl, flags["integrated_obs"]).reshape(-1))
        slog += torch.sum(wb.to(acc) * (-torch.log(nsb.to(acc)) - 0.5 * LN2PI))
    return lam, A, bm, sy2, sKnn, sknkn, slog


def _gram_mean_solve(model, g: _Grid, w_loc, A, bm, maxiter, tol):
    """The Woodbury mean under the grid split: z = (K + A)^{-1} b_m by PCG
    with K the grid-split circulant apply (the PCG's (1, M) vectors whole on
    every rank: every rank runs the same iteration) and the circulant
    inverse as preconditioner, then mhat = R^T z by the sqrt-weight apply.
    In A's dtype (GRAM_ACC_DTYPE, the port's 'gram'); returns (mhat, this
    rank's (Mp_local,) block in the model's dtype; z (M,))."""
    acc = A.dtype
    w = w_loc.to(acc)
    idx, vmask = g.orig
    info = g.info

    def apply_w(v, ww):
        emb = _local_embed_from_orig(v, idx, vmask).reshape((v.shape[0],) + info.local_shape)
        out = local_circulant_apply(emb, ww, info, g.grid)
        return _local_crop_psum(out.reshape(v.shape[0], -1), idx, vmask, model.M, g.grid)

    def kpa_mv(v):
        with fp32_matmul():
            return apply_w(v, w) + v @ A

    res = pcg_result(kpa_mv, bm[None, :], precond=lambda v: apply_w(v, 1.0 / w),
                     maxiter=maxiter, tol=tol)
    MEAN_PCG_STATS.update(iterations=res.iters, resnorm=float(res.resnorm[0]),
                          bnorm=float(bm.norm()))
    z = res.x
    embz = _local_embed_from_orig(z, idx, vmask).reshape((1,) + info.local_shape)
    mhat = local_circulant_apply(embz, torch.sqrt(w), info, g.grid).reshape(-1)
    return mhat.to(model.dtype), z[0]


def _gram_elbo(g: _Grid, new_state, z, zAz, bm, sy2, sKnn, sknkn, slog, lam, N):
    """'gram''s closed-form ELBO (`HIPGP._gram_elbo_stage`): sum(S * Lambda)
    and the KL summed over the grid's blocks, in z's dtype."""
    acc = z.dtype
    qm, qS = g.view.standard_params(new_state)
    quad = zAz - 2.0 * (z @ bm) + sy2
    sSkn, kl = all_reduce([torch.sum(qS.to(acc) * lam.to(acc)),
                           g.view.kl_to_prior(qm.to(acc), qS.to(acc))], g.grid)
    total_an = -0.5 * (quad + sKnn - sknkn + sSkn) + slog
    return (total_an / N.to(acc) - kl / g.model.N).to(g.model.dtype)


def _solve_gram(model, state, params, g, w_loc, rows, flags, clock, generator, *,
                maxiter_cg, tol, mean_solver_maxiter, mean_solver_tol, compute_elbo):
    """'gram': `_gram_sweep`, the sums, `_gram_mean_solve`, `_gram_elbo`."""
    lam, A, bm, sy2, sKnn, sknkn, slog = _gram_sweep(model, params, g, w_loc, rows, flags,
                                                     maxiter_cg, tol, generator)
    clock.mark("sweep")
    (lam,) = all_reduce([lam], g.dp)
    all_reduce([A], g.dp, inplace=True)
    bm, sy2, sKnn, sknkn, slog = all_reduce([bm, sy2, sKnn, sknkn, slog], g.dp)
    (sknkn,) = all_reduce([sknkn], g.grid)
    clock.mark("all_reduce")
    mhat, z = _gram_mean_solve(model, g, w_loc, A, bm, mean_solver_maxiter, mean_solver_tol)
    new_state = g.view._state_from_lam_mhat(state, lam, mhat)
    clock.mark("mean")
    if not compute_elbo:
        return new_state
    elbo = _gram_elbo(g, new_state, z, z @ (A @ z), bm, sy2, sKnn, sknkn, slog, lam, rows.N)
    clock.mark("elbo")
    return new_state, elbo


def _solve_factored(model, state, params, g, w_loc, rows, flags, clock, generator, *,
                    maxiter_cg, tol, mean_solver_maxiter, mean_solver_tol, compute_elbo,
                    factor_jitter):
    """The factored collapse (`HIPGP._batch_solve_factored`) under the
    split: a sweep of (A, b_m, ELBO scalars) without whitening, summed over
    'dp'; A's Cholesky factor on every rank (`HIPGP.factor_data_gram`); its
    rows split over 'dp' in chunks of at most FACTOR_ROWS, each whitened
    grid-split, Lambda summed over 'dp' and tr(K^{-1} A) over the mesh; the
    Woodbury mean; the closed-form ELBO.  The two exactness guards read
    all-reduced values, so every rank takes the same branch; a failed guard
    raises FactoredSolveInconsistency."""
    stats = _hipgp.FACTORED_STATS
    _, A, bm, sy2, sKnn, _, slog = _gram_sweep(model, params, g, w_loc, rows, flags,
                                               maxiter_cg, tol, generator, kn=False)
    clock.mark("sweep")
    all_reduce([A], g.dp, inplace=True)
    bm, sy2, sKnn, slog = all_reduce([bm, sy2, sKnn, slog], g.dp)
    clock.mark("all_reduce")
    L_A, stats["jitter"] = model.factor_data_gram(A, factor_jitter)
    clock.mark("factor")
    M = model.M
    rows_per_dp = -(-M // g.ndp)
    cs = min(rows_per_dp, FACTOR_ROWS)
    nc = -(-rows_per_dp // cs)
    per_dp = nc * cs
    Lt = L_A.T.to(model.dtype)
    del L_A
    if g.ndp * per_dp != M:
        Lt = torch.cat([Lt, Lt.new_zeros((g.ndp * per_dp - M, M))])
    mine = Lt[g.dpi * per_dp:(g.dpi + 1) * per_dp]
    idx, vmask = g.orig
    lam = g.view._lam_zeros()
    tr = torch.zeros((), dtype=GRAM_ACC_DTYPE, device=model.device)
    for c in range(nc):
        emb = _local_embed_from_orig(mine[c * cs:(c + 1) * cs], idx, vmask)
        G = local_whiten(emb, w_loc, g.info, g.grid, maxiter=maxiter_cg, tol=tol,
                         mask=g.mask)
        sq = torch.sum(G * G, dim=0)
        lam += sq if model.family == "mean-field" else g.view._lam_from_factor_rows(G)
        tr += torch.sum(sq.to(GRAM_ACC_DTYPE))
        del G
    del Lt, mine
    (lam,) = all_reduce([lam], g.dp)
    (tr,) = all_reduce([tr], g.grid)
    (tr,) = all_reduce([tr], g.dp)
    clock.mark("g")
    tr_f, sk_f = float(tr), float(sKnn)
    stats.update(trKinvA=tr_f, sKnn=sk_f)
    if _hipgp.FACTORED_GUARDS and (not math.isfinite(tr_f) or tr_f > 1.2 * sk_f + 1e-6):
        raise FactoredSolveInconsistency(
            f"tr(K^-1 A) = {tr_f:.4e} vs sum ivar Knn = {sk_f:.4e}")
    mhat, z = _gram_mean_solve(model, g, w_loc, A, bm, mean_solver_maxiter, mean_solver_tol)
    new_state = g.view._state_from_lam_mhat(state, lam, mhat)
    clock.mark("mean")
    if not compute_elbo:
        return new_state
    _, qS = g.view.standard_params(new_state)
    (sSkn,) = all_reduce([torch.sum(qS.to(tr.dtype) * lam.to(tr.dtype))], g.grid)
    bracket = sk_f - tr_f + float(sSkn)
    stats["bracket"] = bracket
    if _hipgp.FACTORED_GUARDS and bracket < -1e-3 * sk_f:
        raise FactoredSolveInconsistency(
            f"tr(K^-1 A) = {tr_f:.4e} vs sum ivar Knn = {sk_f:.4e}; variance bracket "
            f"{bracket:.4e}")
    elbo = _gram_elbo(g, new_state, z, z @ (A @ z), bm, sy2, sKnn, tr, slog, lam, rows.N)
    clock.mark("elbo")
    return new_state, elbo


def _solve_cg(model, state, params, g, w_loc, rows, flags, clock, generator, *,
              maxiter_cg, tol, mean_solver_maxiter, mean_solver_tol, compute_elbo):
    """The mean by CG over the kn stack kept split both ways: kn @ m summed
    over the grid, kn^T (ivar u) over 'dp', PCG's dots over the grid; the
    ELBO from the same stack, its per-row sums over the grid."""
    mc = flags["integrated_obs"] and flags["semi_integrated_estimator"] == "mc-biased"
    view = g.view
    lam = view._lam_zeros()
    b = torch.zeros((g.info.Mp_local,), dtype=model.dtype, device=model.device)
    kns, ivars = [], []
    for i in range(rows.nsteps):
        u = _mc_offset(generator, flags["semi_integrated_samps"]) if mc else None
        kn = _sweep_kn(model, params, g, w_loc, rows, i, flags, maxiter_cg, tol, u)
        ivar = rows.ivar(i)
        lam += view.get_lam(ivar, kn, bscale=1.0, add_identity=False)
        b += kn.T @ (ivar * rows.y[i])
        kns.append(kn)
        ivars.append(ivar)
    kn_all, ivar_all = torch.cat(kns), torch.cat(ivars)
    del kns
    clock.mark("sweep")
    lam, b = all_reduce([lam, b], g.dp)
    clock.mark("all_reduce")

    def big_mv(v):
        # v + kn^T diag(ivar) kn v: kn v summed over the grid, kn^T (.) over dp
        with fp32_matmul():
            u = all_reduce([kn_all @ v[0]], g.grid)[0]
            r = all_reduce([kn_all.T @ (ivar_all * u)], g.dp)[0]
        return v + r[None, :]

    dot = _grid_dot(g.grid)
    res = pcg_result(big_mv, b[None, :], maxiter=mean_solver_maxiter, tol=mean_solver_tol,
                     dot_fn=dot)
    MEAN_PCG_STATS.update(iterations=res.iters, resnorm=float(res.resnorm[0]),
                          bnorm=float(dot(b, b).sqrt()))
    new_state = view._state_from_lam_mhat(state, lam, res.x[0])
    clock.mark("mean")
    if not compute_elbo:
        return new_state
    qm, qS = view.standard_params(new_state)
    row_sums = lambda *s: all_reduce(s, g.grid)
    bsz = rows.x.shape[1]
    total = torch.zeros((), dtype=model.dtype, device=model.device)
    for i in range(rows.nsteps):
        Knn = _knn_diag(model, params, rows.x[i], flags["integrated_obs"])
        an = view.batch_an(new_state, rows.y[i], rows.noise(i), kn_all[i * bsz:(i + 1) * bsz],
                           Knn, qm, qS, row_sums=row_sums)
        total = total + torch.sum(an * rows.w[i])
    (total,) = all_reduce([total], g.dp)
    (kl,) = all_reduce([view.kl_to_prior(qm, qS)], g.grid)
    elbo = total / rows.N - kl / model.N
    clock.mark("elbo")
    return new_state, elbo


def _declined(kap):
    warnings.warn(
        "mp factored solve declined: spectrum dynamic range "
        f"{kap:.2e} exceeds the measured f32 trust region "
        f"({_hipgp.FACTORED_F32_KAPPA_MAX:g}); falling back to the sweep-based "
        "'gram' solver", RuntimeWarning, stacklevel=3)


@torch.no_grad()
def mp_batch_solve(model, state, xobs, yobs, noise_std, mesh, batch_size: int = 1024,
                   maxiter_cg: int = 10, tol: float = 1e-8, mean_solver_maxiter: int = 200,
                   mean_solver_tol: float = 1e-8, integrated_obs: bool = False,
                   semi_integrated_estimator: str = "analytic",
                   semi_integrated_samps: int = 10,
                   generator: Optional[torch.Generator] = None, compute_elbo: bool = False,
                   mean_solver: str = "cg", spectrum_mode: str = "host", dp_axis: str = "dp",
                   grid_axis: str = "grid", factor_jitter: Optional[float] = None,
                   row_weights=None, timings: Optional[dict] = None):
    """Closed-form optimal q (mean-field, block) with M' split over
    ``grid_axis`` and the data rows over ``dp_axis``.

    Returns the new state (this rank's block of the thetas, the scalars
    whole), or ``(new_state, elbo)`` with ``compute_elbo``; every rank of a
    grid position gets the same block, every rank the same ELBO.  ``state``
    is a whole state or its block (only its hyperparameters are read).
    ``xobs``, ``yobs``, ``noise_std`` are full arrays (every rank passes
    the same) or `multihost.GlobalBatch` blocks of the rows of this rank's
    'dp' position (`multihost.process_slice(n, mesh)`), whose pad rows
    ``row_weights`` masks (`multihost.global_row_weights`).

    ``mean_solver``:

    * 'cg' (default): CG on (I + sum_n kn_n kn_n^T / s_n^2) m = b with the
      kn stack split both ways, O(N_local x M'/n_grid) memory a rank; the
      ELBO reuses the stack;
    * 'gram': the Woodbury collapse m = R (K + A)^{-1} b_m, A = sum_n
      ivar_n Knm_n Knm_n^T the whole M x M data Gram summed over 'dp', the
      (K + A) PCG with K the grid-split circulant apply; no kn stack; the
      ELBO from the sweep's scalars;
    * 'factored': the collapse with M whitening solves in place of N
      (`_solve_factored`).  In float32 it is declined (RuntimeWarning,
      'gram' instead) when the spectrum's dynamic range exceeds
      ``models.hipgp.FACTORED_F32_KAPPA_MAX``, by the whole spectrum or,
      under 'sharded', by the blocks' extrema; a failed exactness guard
      (tr(K^{-1} A) <= 1.2 sum ivar Knn, the variance bracket) warns and
      runs 'gram'.

    ``spectrum_mode``: 'host' builds the whole spectrum on every rank and
    cuts the rank's block; 'sharded' builds only the block
    (`fft_sharded.local_spectrum_weights`).  ``generator`` draws the
    Monte-Carlo estimator's offsets (one a micro-batch, the same on every
    rank).  ``timings``, a dict, receives the seconds of 'sweep',
    'all_reduce', 'mean' and 'elbo' ('factored' adds 'factor' and 'g'), the
    card synchronised at each boundary.  MEAN_PCG_STATS and, for
    'factored', FACTORED_STATS of `models.hipgp` record the last solve."""
    _check_model(model)
    if mean_solver not in ("cg", "gram", "factored"):
        raise ValueError(f"mean_solver={mean_solver!r}; choose 'cg' | 'gram' | 'factored'")
    if spectrum_mode not in ("host", "sharded"):
        raise ValueError(f"spectrum_mode={spectrum_mode!r}")
    g = _Grid(model, mesh, dp_axis, grid_axis)
    clock = _hipgp._StageClock(timings, model.device)
    if mean_solver == "factored":
        _hipgp.FACTORED_STATS.update(dict.fromkeys(_hipgp.FACTORED_STATS, float("nan")))
    if spectrum_mode == "host":
        spec = model.spectrum(state)
        w_loc = weights_shard(host_weights(spec, g.info), g.info, g.gidx)
        if mean_solver == "factored":
            kap = float(torch.max(spec.eigs) / torch.min(spec.eigs))
        del spec
    else:
        w_loc = g.weights(state, "sharded")
        if mean_solver == "factored":
            kap = _sharded_spectrum_kappa(w_loc, g)
    if mean_solver == "factored":
        _hipgp.FACTORED_STATS["kappa"] = kap
        if model.dtype == torch.float32 and kap > _hipgp.FACTORED_F32_KAPPA_MAX:
            _declined(kap)
            mean_solver = "gram"
    rows = _Rows(model, state, g, xobs, yobs, noise_std, batch_size, row_weights)
    params = model.kernel_params(state)
    flags = dict(integrated_obs=integrated_obs,
                 semi_integrated_estimator=semi_integrated_estimator,
                 semi_integrated_samps=semi_integrated_samps)
    kw = dict(maxiter_cg=maxiter_cg, tol=tol, mean_solver_maxiter=mean_solver_maxiter,
              mean_solver_tol=mean_solver_tol, compute_elbo=compute_elbo)
    args = (model, state, params, g, w_loc, rows, flags, clock, generator)
    if mean_solver == "factored":
        try:
            return _solve_factored(*args, factor_jitter=factor_jitter, **kw)
        except FactoredSolveInconsistency as e:
            warnings.warn(
                f"mp factored solve failed its exactness check ({e}); falling back to "
                "the sweep-based 'gram' solver", RuntimeWarning, stacklevel=2)
            if timings is not None:
                for k in [k for k in timings if not k.startswith("factored_")]:
                    timings["factored_" + k] = timings.pop(k)
            clock = _hipgp._StageClock(timings, model.device)
            args = args[:7] + (clock, generator)
            mean_solver = "gram"
    if mean_solver == "gram":
        return _solve_gram(*args, **kw)
    return _solve_cg(*args, **kw)


# ---------------------------------------------------------------------------
# prediction
# ---------------------------------------------------------------------------


@torch.no_grad()
def mp_predict(model, state, x, mesh, batch_size: int = 1024, maxiter_cg: int = 50,
               tol: float = 1e-8, var_clamp: float = _hipgp.VAR_CLAMP,
               integrated_obs: bool = False, semi_integrated_estimator: str = "analytic",
               semi_integrated_samps: int = 10,
               generator: Optional[torch.Generator] = None, spectrum_mode: str = "host",
               dp_axis: str = "dp", grid_axis: str = "grid") -> Tuple[torch.Tensor, torch.Tensor]:
    """(mu*, sig*) of every row of x, on every rank: the rows split over
    'dp' in micro-batches of ``ceil(min(batch_size, N) / n_dp)``, every kn
    contraction (kn.qm, kn.kn, kn S kn) summed over 'grid', the latent
    variance Knn - kn.kn floored at ``var_clamp`` (Knn the doubly
    integrated diagonal for ``integrated_obs`` rows), the results gathered
    over 'dp'.  ``state``: the whole state or this rank's block.
    ``spectrum_mode`` and ``generator`` as in :func:`mp_batch_solve`."""
    _check_model(model)
    if spectrum_mode not in ("host", "sharded"):
        raise ValueError(f"spectrum_mode={spectrum_mode!r}")
    g = _Grid(model, mesh, dp_axis, grid_axis)
    st = g.local_state(state)
    w_loc = g.weights(st, spectrum_mode)
    params = model.kernel_params(st)
    qm, qS = g.view.standard_params(st)
    x = torch.as_tensor(x).to(dtype=model.dtype, device=model.device)
    N = x.shape[0]
    bs = min(batch_size, N) if batch_size > 0 else N
    ones = torch.ones((N,), dtype=model.dtype, device=model.device)
    xb, _, _, _ = _rank_rows(g.ndp, g.dpi, x, ones, None, ones, bs)
    mc = integrated_obs and semi_integrated_estimator == "mc-biased"
    mus, sigs = [], []
    for i in range(xb.shape[0]):
        u = _mc_offset(generator, semi_integrated_samps) if mc else None
        knm = _local_embedded_knm(model, params, xb[i], g.info, g.gidx, integrated_obs,
                                  semi_integrated_estimator, semi_integrated_samps, u)
        kn = local_whiten(knm, w_loc, g.info, g.grid, maxiter=maxiter_cg, tol=tol,
                          mask=g.mask)
        mu, knkn, knSkn = all_reduce([kn @ qm, torch.sum(kn * kn, dim=-1),
                                      g.view.compute_knSkn(kn, qS)], g.grid)
        Knn = _knn_diag(model, params, xb[i], integrated_obs)
        ktilde = torch.clamp(Knn.reshape(-1) - knkn, min=var_clamp)
        mus.append(mu)
        sigs.append(torch.sqrt(ktilde + knSkn))
    # (nsteps, bsz_loc) a rank -> (nsteps, bsz_loc n_dp) in JAX's row order
    mu = all_gather(torch.stack(mus), g.dp, axis=1).reshape(-1)[:N]
    sig = all_gather(torch.stack(sigs), g.dp, axis=1).reshape(-1)[:N]
    return mu, sig


# ---------------------------------------------------------------------------
# natural-gradient training under the grid split
# ---------------------------------------------------------------------------


class _MPKnFn:
    """The grid-split whitening as the model's ``kn_fn`` hook:
    ``kn_fn(st, x, generator) -> (kn, Knn_diag)`` with kn this rank's
    (rows, Mp_local) block.  It carries what the layers above it need:
    ``grid_group`` (the model sums its per-row contractions, the KL and its
    hyper-gradients over it), ``model`` (the rank's view of the model, on
    which `HIPGP.elbo_and_grads` and `infer.svigp_fit` run), ``offset``
    (the rank's first index in M') and :meth:`shard_state` /
    :meth:`gather_state` (checkpoints hold the whole state)."""

    def __init__(self, model, mesh, maxiter_cg, tol, integrated_obs, estimator, samps,
                 spectrum_mode, dp_axis, grid_axis):
        self._g = _Grid(model, mesh, dp_axis, grid_axis)
        self.full_model = model
        self.model = self._g.view
        self.grid_group = self._g.grid
        self.offset = self._g.offset
        self.maxiter_cg, self.tol = maxiter_cg, tol
        self.flags = dict(integrated_obs=integrated_obs, semi_integrated_estimator=estimator,
                          semi_integrated_samps=samps)
        self.spectrum_mode = spectrum_mode
        # the cosine-product spectrum build when every embedded axis is short
        # (JAX's choice: no FFT inside the split natgrad step)
        self.transform = ("matmul" if all(e <= MATMUL_DFT_MAX_LEN for e in model.edims)
                          else "fft")

    def __call__(self, st, x, generator=None):
        g, model, flags = self._g, self.full_model, self.flags
        params = model.kernel_params(st)
        mc = flags["integrated_obs"] and flags["semi_integrated_estimator"] == "mc-biased"
        u = _mc_offset(generator, flags["semi_integrated_samps"]) if mc else None
        w = g.weights(st, self.spectrum_mode, self.transform)
        knm = _local_embedded_knm(model, params, x, g.info, g.gidx, u=u, **flags)
        kn = local_whiten_diff(knm, w, g.info, g.grid, maxiter=self.maxiter_cg, tol=self.tol,
                               mask=g.mask)
        return kn, _knn_diag(model, params, x, flags["integrated_obs"])

    def shard_state(self, state):
        return self._g.local_state(state)

    def gather_state(self, state):
        return mp_gather_state(state, self._g.mesh, self._g.grid_axis)


def make_mp_kn_fn(model, mesh, maxiter_cg: int = 10, tol: float = 1e-8,
                  integrated_obs: bool = False, semi_integrated_estimator: str = "analytic",
                  semi_integrated_samps: int = 10, spectrum_mode: str = "host",
                  dp_axis: str = "dp", grid_axis: str = "grid"):
    """The grid-split whitening solve as an ``elbo_and_grads`` /
    ``svigp_fit`` hook.

    Returns ``kn_fn(st, x, generator) -> (kn, Knn_diag)``: kn is this rank's
    (rows of x, Mp_local) block of the whitened cross-covariances, x being
    the rank's 'dp' rows; each grid rank evaluates the kernel against its
    own inducing rows (`_local_embedded_knm`) and the PCG whitening runs
    grid-split (`fft_sharded.local_whiten_diff`: implicit differentiation,
    so hyperparameters learn through the split solve).  ``spectrum_mode``:
    'host' builds the whole spectrum (by the cosine product when every
    embedded axis is at most ``ops.bttb.MATMUL_DFT_MAX_LEN``, JAX's choice)
    and cuts the rank's block; 'sharded' builds the block alone, also
    differentiably.  The hook carries ``grid_group``, over which the model
    then sums every contraction over M' (`_MPKnFn`)."""
    _check_model(model)
    if spectrum_mode not in ("host", "sharded"):
        raise ValueError(f"spectrum_mode={spectrum_mode!r}")
    return _MPKnFn(model, mesh, maxiter_cg, tol, integrated_obs, semi_integrated_estimator,
                   semi_integrated_samps, spectrum_mode, dp_axis, grid_axis)


def mp_elbo_and_grads(model, state, x, y, noise_std=None, *, mesh, maxiter_cg: int = 10,
                      integrated_obs: bool = False,
                      semi_integrated_estimator: str = "analytic",
                      semi_integrated_samps: int = 10,
                      generator: Optional[torch.Generator] = None, weights=None,
                      compute_hyper_grads: bool = False, spectrum_mode: str = "host",
                      dp_axis: str = "dp", grid_axis: str = "grid"):
    """Minibatch ELBO and natural gradient with the state split over
    ``grid_axis`` and the batch's rows over ``dp_axis``: the model's own
    ``elbo_and_grads`` with :func:`make_mp_kn_fn`.  Every rank passes the
    whole batch and takes its 'dp' rows; ``state`` is whole or this rank's
    block.  Returns (elbo, grads) on every rank, the grads' theta leaves
    this rank's block (the hyper-gradients whole)."""
    from .dp import _rows

    kn_fn = make_mp_kn_fn(model, mesh, maxiter_cg=maxiter_cg,
                          integrated_obs=integrated_obs,
                          semi_integrated_estimator=semi_integrated_estimator,
                          semi_integrated_samps=semi_integrated_samps,
                          spectrum_mode=spectrum_mode, dp_axis=dp_axis, grid_axis=grid_axis)
    n, i = axis_size(mesh, dp_axis), axis_index(mesh, dp_axis)
    y = y.reshape(-1)
    if weights is None:
        weights = torch.ones_like(y)
    return kn_fn.model.elbo_and_grads(
        kn_fn.shard_state(state), _rows(x, n, i), _rows(y, n, i), _rows(noise_std, n, i),
        maxiter_cg=maxiter_cg, integrated_obs=integrated_obs,
        semi_integrated_estimator=semi_integrated_estimator,
        semi_integrated_samps=semi_integrated_samps, generator=generator,
        weights=_rows(weights, n, i), compute_hyper_grads=compute_hyper_grads,
        group=axis_group(mesh, dp_axis), kn_fn=kn_fn)


def mp_svigp_fit(model, state, xtrain, ytrain, noise_std_train, config, mesh,
                 spectrum_mode: str = "host", dp_axis: str = "dp", grid_axis: str = "grid",
                 **fit_kwargs):
    """Grid- and data-split natural-gradient SVI: `infer.svigp_fit` with the
    whitening split over the mesh (mean-field, block).

    The state (whole, or this rank's block) is cut to the rank's block, the
    batch size is rounded up to a multiple of the 'dp' size
    (`round_batch_to_mesh`; pad rows weigh 0) and every batch's rows are
    split over 'dp' (`make_dp_data_shard_fn`); every optimizer update is
    elementwise on the blocks.  The warm start's Lambda is the rank's block
    summed over 'dp'; rho's power iteration sums kn u over the grid and
    kn^T (.) over 'dp'; a checkpoint holds the whole state
    (:func:`mp_gather_state`, written by rank 0) and a resumed fit cuts it
    again.  Returns (state, report) as `infer.svigp_fit`, the state this
    rank's block (:func:`mp_predict` takes it; :func:`mp_gather_state`
    makes it whole)."""
    from ..infer.fit import svigp_fit
    from .dp import make_dp_data_shard_fn, round_batch_to_mesh

    _check_model(model)
    N = int(torch.as_tensor(xtrain).shape[0])
    config = round_batch_to_mesh(config, mesh, N, axis=dp_axis)
    kn_fn = make_mp_kn_fn(model, mesh, maxiter_cg=config.maxiter_cg,
                          integrated_obs=config.integrated_obs,
                          semi_integrated_estimator=config.semi_integrated_estimator,
                          semi_integrated_samps=config.num_semi_mc_samples,
                          spectrum_mode=spectrum_mode, dp_axis=dp_axis, grid_axis=grid_axis)
    return svigp_fit(model, kn_fn.shard_state(state), xtrain, ytrain, noise_std_train, config,
                     kn_fn=kn_fn, data_shard_fn=make_dp_data_shard_fn(mesh, dp_axis),
                     **fit_kwargs)
