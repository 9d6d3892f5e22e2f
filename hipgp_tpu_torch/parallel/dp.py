"""Exact data parallelism over the ranks of a mesh axis.

Counterpart of `hipgp_tpu/parallel/dp.py`.  HIP-GP's information-form
quantities are sums over data points (Lambda = sum_n kn_n kn_n^T / s_n^2,
b = sum_n y_n kn_n / s_n^2, and the natural gradient's batch terms), so
splitting the rows over ranks and summing the accumulators is exact.  The
JAX package lets XLA insert those all-reduces; here they are explicit and
each term is counted once:

* :func:`dp_batch_solve` sweeps each rank's columns of every micro-batch
  with the model's ``accumulate_lam_b`` and all-reduces (Lambda, b, big)
  once before ``finalize_from_lam_b``;
* :func:`make_dp_data_shard_fn` is the ``svigp_fit(data_shard_fn=...)``
  hook: this rank's columns of every prepared batch, and the process group
  over which the model's step, the warm start and rho then sum;
* :func:`dp_elbo_and_grads`, :func:`make_dp_train_step` and
  :func:`dp_svigp_fit` take a whole batch on every rank and compute on this
  rank's rows of it.

Every rank gets the same result.  Rows are split in JAX's layout: rank r
holds the r-th of ``n`` equal column blocks of each (micro-)batch.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .mesh import all_reduce, axis_group, axis_index, axis_size
from .multihost import GlobalBatch

__all__ = ["dp_batch_solve", "make_dp_train_step", "dp_elbo_and_grads",
           "make_dp_data_shard_fn", "round_batch_to_mesh", "dp_svigp_fit"]


class _DataShardFn:
    """This rank's columns of each prepared (nb, bsz, ...) batch array (the
    columns JAX's ``P(None, 'dp')`` gives its device), with the process
    group of the mesh axis as ``group``."""

    def __init__(self, mesh, axis: str):
        self.group = axis_group(mesh, axis)
        self.n, self.index = axis_size(mesh, axis), axis_index(mesh, axis)

    def columns(self, a):
        if a is None:
            return None
        if a.shape[1] % self.n:
            raise ValueError(f"batch of {a.shape[1]} rows does not split over "
                             f"{self.n} ranks: round it with round_batch_to_mesh")
        per = a.shape[1] // self.n
        return a[:, self.index * per:(self.index + 1) * per]

    def __call__(self, xb, yb, sb, w):
        return tuple(self.columns(a) for a in (xb, yb, sb, w))


def make_dp_data_shard_fn(mesh, axis: str = "dp"):
    """The ``infer.svigp_fit(data_shard_fn=...)`` hook: keeps this rank's
    columns of every prepared batch and carries the axis's process group,
    over which the fit then sums every over-batch term (exact data
    parallelism with the whole svigp_fit: callbacks, warm start, rho,
    resume)."""
    return _DataShardFn(mesh, axis)


def round_batch_to_mesh(config, mesh, n_rows: int, axis: str = "dp"):
    """config with batch_size rounded up to a multiple of the axis size, so
    that every batch splits evenly over the ranks (the pad rows carry zero
    weight)."""
    n = axis_size(mesh, axis)
    bsz = config.batch_size if config.batch_size > 0 else n_rows
    bsz = min(bsz, n_rows)
    bsz = -(-bsz // n) * n
    if bsz != config.batch_size:
        config = dataclasses.replace(config, batch_size=bsz)
    return config


def _pad_to(n_target, *arrays, fills):
    out = []
    for a, fill in zip(arrays, fills):
        if a is None:
            out.append(None)
            continue
        pad = n_target - a.shape[0]
        if pad:
            tail = torch.full((pad,) + tuple(a.shape[1:]), fill, dtype=a.dtype,
                              device=a.device)
            a = torch.cat([a, tail])
        out.append(a)
    return out


def _rank_rows(ndev, index, x, y, ns, w, batch_size, n_global=None):
    """(x, y, w, ns) of this rank as (nsteps, per_dev, ...) micro-batches.

    Full arrays (``n_global`` None): JAX's layout, the rows padded to nsteps
    micro-batches of ``chunk = per_dev * ndev`` rows (pads: x 0, y 0, w 0,
    ns 1) and rank r holding columns [r per_dev, (r + 1) per_dev) of each.
    A `GlobalBatch`'s block (``n_global`` its global row count): this rank's
    own block in micro-batches of per_dev rows (the sums are the same; only
    which rows share a micro-batch differs)."""
    N = x.shape[0] if n_global is None else n_global
    per_dev = (-(-N // ndev) if batch_size == -1 or batch_size >= N
               else -(-batch_size // ndev))
    if n_global is None:
        chunk, cols = per_dev * ndev, slice(index * per_dev, (index + 1) * per_dev)
    else:
        chunk, cols = per_dev, slice(None)
    nsteps = -(-x.shape[0] // chunk)
    x, y, w, ns = _pad_to(nsteps * chunk, x, y, w, ns, fills=(0.0, 0.0, 0.0, 1.0))
    steps = lambda a: None if a is None else a.reshape((nsteps, chunk) + a.shape[1:])[:, cols]
    return steps(x), steps(y), steps(w), steps(ns)


def _local(a, model):
    """A full array or a `GlobalBatch`'s block, flat rows, in the model's
    dtype on its device."""
    if a is None:
        return None
    t = a.local if isinstance(a, GlobalBatch) else a
    return torch.as_tensor(t).to(dtype=model.dtype, device=model.device)


@torch.no_grad()
def dp_batch_solve(model, state, xobs, yobs, noise_std, mesh, batch_size: int = -1,
                   maxiter_cg: int = 10, integrated_obs: bool = False,
                   semi_integrated_estimator: str = "analytic",
                   semi_integrated_samps: int = 10, axis: str = "dp",
                   row_weights=None, compute_elbo: bool = False,
                   timings: Optional[dict] = None):
    """The closed-form batch solve with the rows split over ``axis``.

    Each rank accumulates (Lambda, b, big) over its columns of every
    micro-batch with the model's ``accumulate_lam_b`` (the single-device
    unit), the three are summed over the axis in one all-reduce, and every
    rank finalizes the same state.  ``xobs``, ``yobs``, ``noise_std`` and
    ``row_weights`` are full arrays (every rank passes the same), or the
    `multihost.GlobalBatch` blocks that `multihost.global_batch` and
    `global_row_weights` give, whose pad rows ``row_weights`` masks.

    ``compute_elbo``: a second sweep evaluates the bound at the optimum
    (sum a_n w_n all-reduced, N_real the all-reduced sum of the weights) and
    ``(new_state, elbo)`` is returned.  ``timings``, a dict, receives the
    seconds of 'sweep', 'all_reduce', 'finalize' and 'elbo'."""
    ndev, index = axis_size(mesh, axis), axis_index(mesh, axis)
    group = axis_group(mesh, axis)
    cuda = model.device.type == "cuda"

    def mark(name, t0):
        if timings is None:
            return None
        if cuda:
            torch.cuda.synchronize(model.device)
        t = time.perf_counter()
        if t0 is not None:
            timings[name] = t - t0
        return t

    t = mark(None, None)
    x = _local(xobs, model)
    y = _local(yobs, model).reshape(-1)
    ns = None if noise_std is None else _local(noise_std, model).reshape(-1)
    w = (torch.ones((x.shape[0],), dtype=model.dtype, device=model.device)
         if row_weights is None else _local(row_weights, model).reshape(-1))
    n_global = xobs.n_global if isinstance(xobs, GlobalBatch) else None
    xb, yb, wb, nsb = _rank_rows(ndev, index, x, y, ns, w, batch_size, n_global)
    flags = dict(integrated_obs=integrated_obs,
                 semi_integrated_estimator=semi_integrated_estimator,
                 semi_integrated_samps=semi_integrated_samps)
    spec = model.spectrum(state) if model.whitened_type == "ziggy" else None

    def ivar_of(i):
        if nsb is not None:
            return wb[i] / (nsb[i] * nsb[i])
        return wb[i] * torch.exp(-state.log_noise2)

    lam = model._lam_zeros()
    b = torch.zeros((model.Mprime,), dtype=model.dtype, device=model.device)
    big = (None if model.family == "full-rank" else
           torch.zeros((model.Mprime, model.Mprime), dtype=model.dtype, device=model.device))
    for i in range(xb.shape[0]):
        lam_i, b_i, big = model.accumulate_lam_b(state, xb[i], yb[i], ivar_of(i),
                                                 maxiter_cg=maxiter_cg, spec=spec,
                                                 big=big, **flags)
        lam += lam_i
        b += b_i
        del lam_i
    t = mark("sweep", t)
    # the exact reduction of the information-form sums: (Lambda, b) in one
    # collective, the M' x M' big in place in another
    lam, b = all_reduce([lam, b], group)
    if big is not None:
        all_reduce([big], group, inplace=True)
    t = mark("all_reduce", t)
    new_state = model.finalize_from_lam_b(state, lam, b, big)
    del big
    t = mark("finalize", t)
    if not compute_elbo:
        return new_state

    qm, qS = model.standard_params(new_state)
    spec = model.spectrum(new_state) if model.whitened_type == "ziggy" else None
    total = torch.zeros((2,), dtype=model.dtype, device=model.device)
    for i in range(xb.shape[0]):
        Knm, Knn = model.make_grams(new_state, xb[i], **flags)
        kn = model.compute_kn(new_state, Knm, maxiter_cg=maxiter_cg, spec=spec)
        an = model.batch_an(new_state, yb[i], None if nsb is None else nsb[i], kn, Knn,
                            qm, qS)
        total[0] += torch.sum(an * wb[i])
    total[1] = torch.sum(wb)
    (total,) = all_reduce([total], group)
    # the row weights exclude the pad rows from N_real
    elbo = total[0] / total[1] - model.kl_to_prior(qm, qS) / model.N
    mark("elbo", t)
    return new_state, elbo


def _rows(a, n, index):
    """This rank's block of rows of a whole batch (JAX's ``P('dp')``)."""
    if a is None:
        return None
    if a.shape[0] % n:
        raise ValueError(f"batch of {a.shape[0]} rows does not split over {n} ranks")
    per = a.shape[0] // n
    return a[index * per:(index + 1) * per]


def dp_elbo_and_grads(model, mesh, axis: str = "dp", **elbo_kwargs):
    """(state, x, y, noise_std, weights) -> (elbo, grads) on a whole batch
    (every rank passes the same) with its rows split over ``axis``: every
    rank runs ``model.elbo_and_grads`` on its block, summed over the axis."""
    group = axis_group(mesh, axis)
    n, index = axis_size(mesh, axis), axis_index(mesh, axis)

    def step(state, x, y, noise_std, weights):
        return model.elbo_and_grads(state, _rows(x, n, index), _rows(y, n, index),
                                    _rows(noise_std, n, index),
                                    weights=_rows(weights, n, index), group=group,
                                    **elbo_kwargs)

    return step


def make_dp_train_step(model, config, opt, mesh, axis: str = "dp",
                       has_noise: bool = True):
    """The data-parallel `infer.batch_step`: one optimizer step on a whole
    batch (every rank passes the same) whose rows are split over ``axis``.
    Returns ``train_step(state, opt_state, xb, yb, sb, wb) -> (state,
    opt_state, elbo)``, without ``sb`` when ``has_noise`` is False (the
    model's own log_noise2 drives the likelihood and can be learned).  The
    port's optimizer (`infer.make_optimizer`) keeps its own moments: pass it
    as ``opt_state`` (it is returned, stepped)."""
    from ..infer.fit import batch_step

    group = axis_group(mesh, axis)
    n, index = axis_size(mesh, axis), axis_index(mesh, axis)

    def body(state, opt_state, xb, yb, sb, wb):
        state, elbo = batch_step(model, config, opt_state, state, _rows(xb, n, index),
                                 _rows(yb, n, index), _rows(sb, n, index),
                                 _rows(wb, n, index), group=group)
        return state, opt_state, elbo

    if has_noise:
        return body
    return lambda state, opt_state, xb, yb, wb: body(state, opt_state, xb, yb, None, wb)


def dp_svigp_fit(model, state, xtrain, ytrain, noise_std_train, config, mesh,
                 axis: str = "dp", verbose: bool = True):
    """The data-parallel fit loop: every epoch's batches with their rows split
    over ``axis`` (no warm start, shuffle or checkpoints: `infer.svigp_fit`
    with `make_dp_data_shard_fn` has those).  Returns (state, report) as
    `infer.svigp_fit`: 'elbo_trace', 'epoch_elbos', 'epoch_times'."""
    from ..infer.fit import make_optimizer, prepare_batches

    as_t = lambda a: torch.as_tensor(a).to(dtype=model.dtype, device=model.device)
    noise = None if config.learn_noise or noise_std_train is None else as_t(noise_std_train)
    xb, yb, sb, w = prepare_batches(as_t(xtrain), as_t(ytrain), noise, config.batch_size)
    opt = make_optimizer(state, config)
    step = make_dp_train_step(model, config, opt, mesh, axis=axis, has_noise=sb is not None)
    trace, epoch_elbos, epoch_times = [], [], []
    for epoch in range(config.epochs):
        t0 = time.perf_counter()
        elbos = []
        for i in range(xb.shape[0]):
            if sb is not None:
                state, opt, elbo = step(state, opt, xb[i], yb[i], sb[i], w[i])
            else:
                state, opt, elbo = step(state, opt, xb[i], yb[i], w[i])
            elbos.append(elbo)
        elbos = torch.stack(elbos).cpu().numpy().tolist()
        trace.extend(elbos)
        epoch_elbos.append(sum(elbos) / len(elbos))
        epoch_times.append(time.perf_counter() - t0)
        if config.error_on_nonfinite and not np.isfinite(epoch_elbos[-1]):
            raise RuntimeError(
                f"[dp] epoch {epoch} mean ELBO is non-finite ({epoch_elbos[-1]}): "
                "lower the natural-gradient lr or use batch_solve; set "
                "config.error_on_nonfinite=False to grind on")
        if verbose and dist.get_rank(axis_group(mesh, axis)) == 0:
            print(f"[dp] epoch {epoch}: elbo {epoch_elbos[-1]:.4f} "
                  f"({epoch_times[-1]:.2f}s)", flush=True)
    return state, {"elbo_trace": trace, "epoch_elbos": epoch_elbos,
                   "epoch_times": epoch_times}
