"""SVI training loop (natural gradients) and chunked prediction.

Counterpart of `hipgp_tpu/infer/fit.py`.  An epoch is a Python loop over
batches: each step takes the ELBO and the natural gradient from
``model.elbo_and_grads`` and applies it to the natural parameters as SGD
with a per-step exponential decay (the JAX package's
``optax.sgd(optax.exponential_decay(lr, 1, step_decay))``).  With
``learn_kernel`` or ``learn_noise`` the same step also takes the gradient in
the log-hyperparameters and applies Adam to them (``optax.adam(kernel_lr)``
under the JAX package's ``optax.multi_transform``); the gradients of what
is not learned are zeroed.  After the theta2 warm start a power iteration
estimates the natural-gradient stability limit (``natgrad_safe_lr``).
With ``shuffle`` every epoch draws one permutation of the rows from
``np.random.default_rng(seed)``, as the JAX package does.  A non-finite
epoch raises unless ``error_on_nonfinite`` is off.  With ``checkpoint_dir``
the fit saves the state, the optimizer (in the JAX package's saved form:
the leaves of its optax state) and the epoch every ``checkpoint_every``
epochs, and ``resume`` continues from such a checkpoint, the JAX package's
or this one's.  ``ell_fit`` grid-searches the lengthscale by the closed-form
``batch_solve`` ELBO.

Data is padded to a whole number of batches and masked, as in the JAX
package, so every batch has the same shape.
"""
from __future__ import annotations

import dataclasses
import os
import time
import warnings
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..utils.checkpoint import restore_checkpoint, save_checkpoint

__all__ = ["FitConfig", "svigp_fit", "ell_fit", "batch_predict",
           "predictive_variance_correction", "make_optimizer",
           "prepare_batches", "batch_step", "natgrad_stability_rho",
           "HyperAdam", "zero_frozen"]


@dataclasses.dataclass(frozen=True)
class FitConfig:
    """Training configuration: the JAX package's FitConfig fields, with its
    defaults."""

    fit_method: str = "natgrad"
    epochs: int = 50
    batch_size: int = 256
    lr: float = 1e-2
    schedule_lr: bool = True
    step_decay: float = 0.99
    learn_kernel: bool = False
    learn_noise: bool = False
    kernel_lr: float = 1e-3
    maxiter_cg: int = 5
    integrated_obs: bool = False
    semi_integrated_estimator: str = "analytic"
    num_semi_mc_samples: int = 10
    predict_maxiter_cg: int = 50
    predict_ksemi_method: str = "analytic"
    predict_ksemi_samps: int = 200
    batch_log_interval: int = 0  # > 0: print every k-th batch ELBO
    epoch_log_interval: int = 1
    only_eval_last_epoch: bool = False
    shuffle: bool = False  # the reference does not shuffle
    seed: int = 0
    # raise when an epoch's mean ELBO is NaN/Inf; off, grind on to the end
    # (the reference's behaviour)
    error_on_nonfinite: bool = True


def prepare_batches(x: torch.Tensor, y: torch.Tensor,
                    noise_std: Optional[torch.Tensor], batch_size: int):
    """Pad to a batch multiple and reshape to (nb, bsz, ...); returns
    (xb, yb, sb, w) with w the 0/1 row weights."""
    N = x.shape[0]
    y = y.reshape(-1)
    bsz = min(batch_size, N) if batch_size > 0 else N
    nb = -(-N // bsz)
    pad = nb * bsz - N

    def p(a, fill=0.0):
        if pad == 0:
            return a
        tail = torch.full((pad,) + tuple(a.shape[1:]), fill, dtype=a.dtype,
                          device=a.device)
        return torch.cat([a, tail], dim=0)

    xb = p(x).reshape(nb, bsz, -1)
    yb = p(y).reshape(nb, bsz)
    w = p(torch.ones((N,), dtype=x.dtype, device=x.device)).reshape(nb, bsz)
    sb = None
    if noise_std is not None:
        sb = p(noise_std.reshape(-1), fill=1.0).reshape(nb, bsz)
    return xb, yb, sb, w


def _hyper_names(state):
    """The state's log-hyperparameter fields in field order (a HIP-GP's
    three, an SVGP's two: it has no noise leaf)."""
    return [f.name for f in dataclasses.fields(state) if not f.name.startswith("theta")]


def _int32(n: int) -> torch.Tensor:
    return torch.tensor(n, dtype=torch.int32)


class HyperAdam:
    """Adam on the state's log-hyperparameters, the update of ``optax.adam``
    (bias-corrected moments, eps outside the square root, no eps_root)."""

    def __init__(self, lr: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.count = 0
        self.mu = self.nu = None

    def step(self, state, grads):
        names = _hyper_names(state)
        g = [getattr(grads, k) for k in names]
        if self.mu is None:
            self.mu = [torch.zeros_like(a) for a in g]
            self.nu = [torch.zeros_like(a) for a in g]
        self.count += 1
        self.mu = [(1 - self.b1) * a + self.b1 * m for a, m in zip(g, self.mu)]
        self.nu = [(1 - self.b2) * a * a + self.b2 * n for a, n in zip(g, self.nu)]
        c1, c2 = 1 - self.b1 ** self.count, 1 - self.b2 ** self.count
        new = {k: getattr(state, k) - self.lr * ((m / c1) / (torch.sqrt(n / c2) + self.eps))
               for k, m, n in zip(names, self.mu, self.nu)}
        return state.replace(**new)

    def leaves(self, state):
        """The leaves of ``optax.adam``'s state in the JAX flatten order:
        count (int32), then mu and nu of the log-hyperparameters (the theta
        entries are masked and have none); zero moments before the first
        step, shaped like ``state``'s hypers."""
        zeros = [torch.zeros_like(getattr(state, k)).detach() for k in _hyper_names(state)]
        return [_int32(self.count)] + (self.mu or zeros) + (self.nu or zeros)

    def load_leaves(self, leaves, state) -> None:
        """Set count and moments from :meth:`leaves`-ordered arrays, in the
        dtypes and on the devices of ``state``'s hypers."""
        names = _hyper_names(state)
        like = [getattr(state, k) for k in names] * 2
        moments = [torch.as_tensor(a).to(dtype=t.dtype, device=t.device)
                   for a, t in zip(leaves[1:], like)]
        self.count = int(leaves[0])
        self.mu, self.nu = moments[:len(names)], moments[len(names):]


class FitOptimizer:
    """The JAX package's ``optax.multi_transform``: SGD on the natural
    parameters with the learning rate lr * step_decay ** step (constant
    without ``schedule_lr``) and, when a hyperparameter is learned,
    :class:`HyperAdam` at ``kernel_lr`` on the log-hyperparameters (else
    they stay put)."""

    def __init__(self, config: FitConfig):
        self.lr = config.lr
        self.schedule = config.schedule_lr
        self.decay = config.step_decay if config.schedule_lr else 1.0
        self.count = 0
        learn = config.learn_kernel or config.learn_noise
        self.hyper = HyperAdam(config.kernel_lr) if learn else None

    def step(self, state, grads):
        lr = self.current_lr()
        self.count += 1
        state = state.replace(theta1=state.theta1 - lr * grads.theta1,
                              theta2=state.theta2 - lr * grads.theta2)
        return state if self.hyper is None else self.hyper.step(state, grads)

    def current_lr(self) -> float:
        """The natural-parameter lr of the next step."""
        return self.lr * self.decay ** self.count

    def leaves(self, state):
        """The optimizer's saved form: the leaves of the JAX package's
        ``make_optimizer(state, config).init(state)`` as ``jax.tree.flatten``
        orders them (its partition's 'hyper' before 'theta'): Adam's count,
        mu and nu when a hyper is learned (:meth:`HyperAdam.leaves`), then
        the schedule's step count (int32) with ``schedule_lr``.  A constant
        lr and no learned hyper has no leaves."""
        out = [] if self.hyper is None else self.hyper.leaves(state)
        return out + ([_int32(self.count)] if self.schedule else [])

    def load_leaves(self, leaves, state) -> None:
        """Load :meth:`leaves`-ordered arrays (from either package's
        ``opt_state.npz``) into this optimizer."""
        want = len(self.leaves(state))
        if len(leaves) != want:
            raise ValueError(f"optimizer state has {len(leaves)} leaves, this "
                             f"configuration's has {want}")
        if self.hyper is not None:
            self.hyper.load_leaves(leaves[:1 + 2 * len(_hyper_names(state))], state)
        if self.schedule:
            self.count = int(leaves[-1])

    def treedef(self, state) -> str:
        """``str`` of the JAX treedef of the optimizer state that
        :meth:`leaves` flattens, for the checkpoint's sidecar."""
        empty = "CustomNode(namedtuple[EmptyState], [])"
        masked = "CustomNode(namedtuple[MaskedNode], [])"
        moments = (f"CustomNode({type(state).__name__}[()], ["
                   + ", ".join(masked if f.name.startswith("theta") else "*"
                               for f in dataclasses.fields(state)) + "])")
        hyper = (f"[(CustomNode(namedtuple[ScaleByAdamState], [*, {moments}, {moments}]), "
                 f"{empty})]" if self.hyper is not None else f"[{empty}]")
        sched = ("CustomNode(namedtuple[ScaleByScheduleState], [*])" if self.schedule
                 else empty)
        return ("PyTreeDef(CustomNode(namedtuple[PartitionState], [{'hyper': "
                f"CustomNode(namedtuple[MaskedState], {hyper}), 'theta': "
                f"CustomNode(namedtuple[MaskedState], [({empty}, {sched})])}}]))")


def make_optimizer(state, config: FitConfig) -> FitOptimizer:
    """The fit's optimizer for ``state`` (the JAX package's signature; the
    optimizer keeps its own moments, so the state only fixes the order)."""
    return FitOptimizer(config)


def zero_frozen(config: FitConfig, grads):
    """The hyperparameter gradients of what ``config`` does not learn, zeroed
    (an SVGP's state has no noise leaf)."""
    z = torch.zeros_like
    if not config.learn_kernel:
        grads = grads.replace(log_sig2=z(grads.log_sig2), log_ell=z(grads.log_ell))
    if not config.learn_noise and hasattr(grads, "log_noise2"):
        grads = grads.replace(log_noise2=z(grads.log_noise2))
    return grads


def _gram_flags(config: FitConfig, generator=None) -> dict:
    """The observation keywords of `make_grams` that the config sets."""
    return dict(integrated_obs=config.integrated_obs,
                semi_integrated_estimator=config.semi_integrated_estimator,
                semi_integrated_samps=config.num_semi_mc_samples,
                generator=generator)


def batch_step(model, config: FitConfig, opt: FitOptimizer, state, xb, yb, sb, wb,
               generator=None, group=None, kn_fn=None):
    """One natural-gradient step (and Adam step on the learned
    hyperparameters) on one prepared batch: (state, elbo).  ``group``: the
    process group over which the batch's rows are split (data parallelism;
    `model.elbo_and_grads` sums over it); ``kn_fn``: the whitening override
    (`parallel.make_mp_kn_fn`)."""
    elbo, grads = model.elbo_and_grads(
        state, xb, yb, sb, maxiter_cg=config.maxiter_cg, weights=wb,
        compute_hyper_grads=config.learn_kernel or config.learn_noise,
        **_gram_flags(config, generator), group=group, kn_fn=kn_fn)
    return opt.step(state, zero_frozen(config, grads)), elbo


def _batch_kn_ivar(model, state, xl, sl, wl, config: FitConfig, spec=None,
                   generator=None, kn_fn=None):
    """(kn, ivar) for one prepared batch: the warm start's kn path
    (``kn_fn``'s kn where one is given)."""
    if kn_fn is not None:
        kn = kn_fn(state, xl, generator)[0]
    else:
        if spec is None:
            spec = model.spectrum(state)
        Knm, _ = model.make_grams(state, xl, **_gram_flags(config, generator))
        kn = model.compute_kn(state, Knm, maxiter_cg=config.maxiter_cg, spec=spec)
    ivar = wl / (sl * sl) if sl is not None else wl * torch.exp(-state.log_noise2)
    return kn, ivar


def _theta2_warmstart(model, state, xb, sb, w, config: FitConfig, generator=None,
                      group=None, kn_fn=None):
    """theta2 <- -(Lambda + I)/2 from one Lambda-only pass over the data,
    Lambda family-shaped (`model.get_lam`, its prior identity too).  With
    ``group`` the rows are split over its ranks: the data's Lambda is summed
    over them in one all-reduce before the identity is added.  With an
    'mp' ``kn_fn`` (and its view as ``model``) Lambda is the rank's block."""
    spec = None if kn_fn is not None else model.spectrum(state)
    dt, dev = model.dtype, model.device
    zero_kn = torch.zeros((1, model.Mprime), dtype=dt, device=dev)
    lam = torch.zeros_like(model.get_lam(torch.ones((1,), dtype=dt, device=dev), zero_kn))
    for b in range(xb.shape[0]):
        kn, ivar = _batch_kn_ivar(model, state, xb[b], None if sb is None else sb[b],
                                  w[b], config, spec=spec, generator=generator, kn_fn=kn_fn)
        lam = lam + model.get_lam(ivar, kn, add_identity=False)
    if group is not None:
        from ..parallel.mesh import all_reduce

        (lam,) = all_reduce([lam], group)
    lam = lam + model.get_lam(torch.zeros((1,), dtype=dt, device=dev), zero_kn,
                              add_identity=True)
    return state.replace(theta2=-0.5 * lam)


def natgrad_stability_rho(kn, ivar, state, model, bscale, iters: int = 30,
                          group=None, grid_group=None, grid_offset: int = 0) -> float:
    """Top eigenvalue rho of the warm-metric-preconditioned batch precision
    of the natural-gradient iteration, by power iteration (any family: S
    applied as S * v, by blocks, or S @ v).

    The linearized theta1 recursion is eta1 <- (I - lr B S) eta1 + const with
    B = bscale kn^T diag(ivar) kn + I (one batch's implied precision) and S
    the current variational covariance; it is stable for lr < 2 / rho with
    rho = lambda_max(B S).  B S is similar to the SPD S^{1/2} B S^{1/2}, so
    plain power iteration with a norm-ratio estimate converges to it.  Cost:
    2 * iters (bsz, M') products.  With ``group`` the batch's rows are split
    over its ranks: kn^T (ivar * (kn u)) is summed over them in every
    iteration (one all-reduce of M' values), so rho is the whole batch's on
    every rank.  With ``grid_group`` kn, the state and the iterate hold
    this rank's block of M' (from index ``grid_offset``; `parallel.mp`):
    kn u and the norms are summed over the grid as well."""
    _, S = model.standard_params(state)
    if model.family == "mean-field":
        apply_S = lambda v: S * v
    elif model.family == "block":
        apply_S = lambda v: model.block_diag_multiply(S, v[None, :])[0]
    else:
        apply_S = lambda v: S @ v

    from ..parallel.mesh import all_reduce

    total = ((lambda t: t) if grid_group is None
             else (lambda t: all_reduce([t], grid_group)[0]))
    kn_u = lambda u: total(kn @ u)
    if group is None:
        data_sum = lambda u: kn.T @ (ivar * kn_u(u))
    else:
        data_sum = lambda u: all_reduce([kn.T @ (ivar * kn_u(u))], group)[0]

    def mv(v):
        u = apply_S(v)
        return bscale * data_sum(u) + u

    norm = (torch.linalg.norm if grid_group is None
            else (lambda t: torch.sqrt(total(torch.sum(t * t)))))
    idx = torch.arange(grid_offset, grid_offset + kn.shape[-1], device=kn.device)
    z = torch.sin(idx.to(kn.dtype) * 0.73) + 0.1
    z = z / norm(z)
    rho = torch.zeros((), dtype=kn.dtype, device=kn.device)
    for _ in range(iters):
        q = mv(z)
        rho = norm(q) / norm(z)
        z = q / norm(q)
    return float(rho)


def svigp_fit(model, state, xtrain, ytrain, noise_std_train, config: FitConfig,
              epoch_callback: Optional[Callable] = None, verbose: bool = True, *,
              checkpoint_dir: Optional[str] = None, checkpoint_every: int = 0,
              resume: bool = False, theta2_warmstart: bool = False,
              natgrad_safe_lr: str = "warn", max_steps: Optional[int] = None,
              data_shard_fn: Optional[Callable] = None, kn_fn: Optional[Callable] = None):
    """Fit the variational parameters by natural-gradient SVI.

    ``data_shard_fn(xb, yb, sb, w)``: applied to the prepared (nb, bsz, ...)
    batches (and to every epoch's shuffled ones); data parallelism passes
    `parallel.make_dp_data_shard_fn(mesh)`, which keeps this rank's columns of
    every batch and carries the process group over which the batches' sums
    run (``data_shard_fn.group``): the steps, the warm start and rho then sum
    over it, and only its rank 0 writes checkpoints.

    ``kn_fn``: the whitening override threaded into every step, the warm
    start and rho (JAX's hook).  Model parallelism passes
    `parallel.make_mp_kn_fn`'s with this rank's block of the state: the fit
    then runs on the kn_fn's view of the model (``kn_fn.model``), rho sums
    over the grid (``kn_fn.grid_group``), and a checkpoint holds the whole
    state (``kn_fn.gather_state``, a collective; written by the world's rank
    0), which a resumed fit cuts again (``kn_fn.shard_state``).

    ``theta2_warmstart``: one Lambda-only pass over the data sets theta2 to
    -(Lambda + I)/2 before SVI.  From the cold init the raw natural-gradient
    iteration overshoots while theta2 (the metric) is still far from the
    data's precision: at N = 20 000, batch 256 the ELBO dives by orders of
    magnitude (to NaN in float32 at M = 125^2), as in the reference; the
    warm metric removes that transient at the cost of one data pass.

    ``natgrad_safe_lr``: 'warn' (default) | 'clamp' | 'off'.  After the warm
    start of a natgrad fit (``config.fit_method``),
    :func:`natgrad_stability_rho` on the first batch estimates the stability
    limit lr_crit = 2/rho; 'warn' warns when ``config.lr`` exceeds 0.5
    lr_crit, 'clamp' lowers the lr to 0.5 lr_crit instead.

    ``checkpoint_dir`` with ``checkpoint_every`` = k saves the state, the
    optimizer and the epoch count there after every k-th epoch that ran to
    its end (`utils.checkpoint.save_checkpoint`); ``resume`` restores them
    from ``checkpoint_dir`` when it holds a ``state.npz`` and runs the
    epochs after the saved one.  As in the JAX package, a restored fit skips
    the theta2 warm start and with it the rho estimate and the 'clamp' of
    ``natgrad_safe_lr`` (its later epochs run at ``config.lr``), and with
    ``shuffle`` it starts a fresh ``np.random.default_rng(config.seed)``,
    so the first resumed epoch draws epoch 0's permutation.

    ``max_steps`` ends the fit after that many batch steps of this call
    (None: run every epoch to its end).  With ``config.learn_noise`` the
    per-point noise is dropped and the model's noise is learned, as in the
    JAX package.  ``config.shuffle`` permutes the rows once per epoch with
    ``np.random.default_rng(config.seed)``.  ``epoch_callback(epoch, model,
    state, trace)`` runs after every epoch (only the last with
    ``config.only_eval_last_epoch``).  Returns (state, report); the report
    holds the per-batch ELBO trace, the per-epoch mean ELBOs and wall-clock
    seconds, the per-epoch sig2 and ell (with ``learn_kernel``) and noise2
    (with ``learn_noise``) traces, the number of steps run, the warm start's
    seconds, and ``natgrad_rho``, ``natgrad_lr_crit`` and ``lr_used``."""
    dt_, dev = model.dtype, model.device
    as_t = lambda a: torch.as_tensor(a).to(dtype=dt_, device=dev)
    outer_model = model
    model = getattr(kn_fn, "model", model)
    grid = getattr(kn_fn, "grid_group", None)
    noise = None if config.learn_noise else noise_std_train
    x_raw, y_raw = as_t(xtrain), as_t(ytrain).reshape(-1)
    s_raw = None if noise is None else as_t(noise).reshape(-1)
    xb, yb, sb, w = prepare_batches(x_raw, y_raw, s_raw, config.batch_size)
    group = getattr(data_shard_fn, "group", None)
    # the global batch size (rho's batch scale) before a shard function
    # keeps this rank's columns
    bsz = xb.shape[1]
    if data_shard_fn is not None:
        xb, yb, sb, w = data_shard_fn(xb, yb, sb, w)
    # the Monte-Carlo estimator's draws (one generator for the whole fit)
    gen = torch.Generator().manual_seed(0)
    opt = make_optimizer(state, config)
    start_epoch = 0
    restored = (resume and checkpoint_dir is not None
                and os.path.exists(os.path.join(checkpoint_dir, "state.npz")))
    if restored:
        state, _, start_epoch = restore_checkpoint(checkpoint_dir, state, opt)
        if grid is not None:
            state = kn_fn.shard_state(state)
        if verbose:
            print(f"resumed from {checkpoint_dir} at epoch {start_epoch}", flush=True)
    # the warm start and the rho estimate are HIP-GP's (an SVGP has no
    # family-shaped Lambda), as in the JAX package
    warmstart = theta2_warmstart and not restored and hasattr(model, "get_lam")
    t0 = time.perf_counter()
    if warmstart:
        state = _theta2_warmstart(model, state, xb, sb, w, config, generator=gen,
                                  group=group, kn_fn=kn_fn)
    warmstart_s = time.perf_counter() - t0
    rho = lr_crit = None
    if (natgrad_safe_lr != "off" and warmstart
            and config.fit_method == "natgrad"
            and getattr(model, "family", None) in ("mean-field", "block", "full-rank")):
        if natgrad_safe_lr not in ("warn", "clamp"):
            raise ValueError(f"natgrad_safe_lr={natgrad_safe_lr!r}: expected "
                             "'warn', 'clamp', or 'off'")
        kn0, ivar0 = _batch_kn_ivar(model, state, xb[0],
                                    None if sb is None else sb[0], w[0], config,
                                    generator=gen, kn_fn=kn_fn)
        rho = natgrad_stability_rho(kn0, ivar0, state, model, model.N / bsz,
                                    group=group, grid_group=grid,
                                    grid_offset=getattr(kn_fn, "offset", 0))
        lr_crit = 2.0 / rho
        if config.lr > 0.5 * lr_crit:
            msg = (f"natgrad lr={config.lr:g} exceeds half the estimated natgrad "
                   f"stability limit lr_crit=2/rho={lr_crit:.3g} (rho={rho:.1f}): "
                   "the mean-field metric underestimates the collective "
                   "curvature at this lengthscale and grid, and the iteration "
                   "diverges geometrically above lr_crit")
            if natgrad_safe_lr == "clamp":
                config = dataclasses.replace(config, lr=0.5 * lr_crit)
                opt = make_optimizer(state, config)
                if verbose:
                    print(f"natgrad_safe_lr: clamping lr to {config.lr:.3g}; {msg}",
                          flush=True)
            else:
                warnings.warn(msg + "; pass natgrad_safe_lr='clamp' to lower it, "
                              "or reduce config.lr", UserWarning, stacklevel=2)
    nb = xb.shape[0]
    if config.shuffle:
        shuffle_rng = np.random.default_rng(config.seed)
    trace, epoch_elbos, epoch_times = [], [], []
    sig2_trace, ell_trace, noise2_trace = [], [], []
    steps = 0
    for epoch in range(start_epoch, config.epochs):
        if max_steps is not None and steps >= max_steps:
            break
        if config.shuffle:
            perm = torch.as_tensor(shuffle_rng.permutation(x_raw.shape[0]), device=dev)
            xb, yb, sb, w = prepare_batches(x_raw[perm], y_raw[perm],
                                            None if s_raw is None else s_raw[perm],
                                            config.batch_size)
            if data_shard_fn is not None:
                xb, yb, sb, w = data_shard_fn(xb, yb, sb, w)
        t0 = time.perf_counter()
        elbos = []
        for b in range(nb):
            if max_steps is not None and steps >= max_steps:
                break
            state, elbo = batch_step(model, config, opt, state, xb[b], yb[b],
                                     None if sb is None else sb[b], w[b],
                                     generator=gen, group=group, kn_fn=kn_fn)
            elbos.append(elbo)
            steps += 1
        elbos_np = torch.stack(elbos).cpu().numpy()
        dt = time.perf_counter() - t0
        epoch_times.append(dt)
        trace.extend(elbos_np.tolist())
        epoch_elbos.append(float(elbos_np.mean()))
        if config.error_on_nonfinite and not np.isfinite(epoch_elbos[-1]):
            raise RuntimeError(
                f"epoch {epoch} mean ELBO is non-finite ({epoch_elbos[-1]}): "
                "the natural-gradient lr is likely above the stability limit "
                "at this lengthscale and grid; lower config.lr, use "
                "theta2_warmstart or the closed-form batch_solve, or set "
                "config.error_on_nonfinite=False to grind on")
        if config.learn_kernel:
            sig2_trace.append(float(torch.exp(state.log_sig2)))
            ell_trace.append(float(torch.exp(state.log_ell.reshape(-1)[0])))
        if config.learn_noise:
            noise2_trace.append(float(torch.exp(state.log_noise2)))
        if verbose and config.batch_log_interval > 0:
            for bi in range(0, len(elbos_np), config.batch_log_interval):
                print(f"  ... batch {bi}/{len(elbos_np)}: elbo {elbos_np[bi]:.4f}",
                      flush=True)
        if (verbose and config.epoch_log_interval
                and epoch % config.epoch_log_interval == 0):
            print(f"epoch {epoch:4d}: elbo {epoch_elbos[-1]:.4f} ({dt:.2f}s)",
                  flush=True)
        if epoch_callback is not None and (
                not config.only_eval_last_epoch or epoch == config.epochs - 1):
            epoch_callback(epoch, outer_model, state, trace)
        if (checkpoint_dir is not None and checkpoint_every and len(elbos) == nb
                and (epoch + 1) % checkpoint_every == 0):
            saved = state if grid is None else kn_fn.gather_state(state)
            writer = (dist.get_rank() == 0 if grid is not None
                      else group is None or dist.get_rank(group) == 0)
            if writer:
                save_checkpoint(checkpoint_dir, saved, opt, step=epoch + 1)
    report = {
        "elbo_trace": trace,
        "epoch_elbos": epoch_elbos,
        "epoch_times": epoch_times,
        "sig2_trace": sig2_trace,
        "ell_trace": ell_trace,
        "noise2_trace": noise2_trace,
        "steps": steps,
        "warmstart_s": warmstart_s,
        "natgrad_rho": rho,
        "natgrad_lr_crit": lr_crit,
        "lr_used": config.lr,
    }
    return state, report


# device-memory budget for one predict chunk's (bsz, M') whitened kn buffer
PREDICT_CHUNK_BUDGET_BYTES = 2 << 30


def batch_predict(model, state, x, batch_size: int = 100, **predict_kwargs):
    """Chunked prediction: pad to a batch multiple and predict chunk by
    chunk (``predict_kwargs`` go to ``model.predict``: maxiter_cg and the
    observation flags).  The chunk is clamped so its (bsz, M') buffer fits
    the budget, counted with the model dtype's item size, and twice for the
    block family (its block-ordered copy of kn, as the JAX package counts
    it)."""
    x = torch.as_tensor(x).to(dtype=model.dtype, device=model.device)
    N = x.shape[0]
    Mp = int(getattr(model, "Mprime", 0) or 0)
    if Mp:   # an SVGP's chunk is not clamped, as in the JAX package
        itemsize = torch.empty((), dtype=model.dtype).element_size()
        per_row = itemsize * Mp * (2 if getattr(model, "family", "") == "block" else 1)
        batch_size = max(1, min(batch_size, PREDICT_CHUNK_BUDGET_BYTES // per_row))
    bsz = min(batch_size, N)
    nb = -(-N // bsz)
    pad = nb * bsz - N
    if pad:
        x = torch.cat([x, torch.zeros((pad, x.shape[1]), dtype=x.dtype,
                                      device=x.device)])
    chunks = x.reshape(nb, bsz, -1)
    mus, sigs = [], []
    for i in range(nb):
        mu, sig = model.predict(state, chunks[i], **predict_kwargs)
        mus.append(mu)
        sigs.append(sig)
    return torch.cat(mus)[:N], torch.cat(sigs)[:N]


def ell_fit(model, state, xobs, yobs, sobs, ell_min: float, ell_max: float,
            ell_step_size: float, batch_solve_bsz: int = -1, maxiter_cg: int = 10,
            integrated_obs: bool = False,
            semi_integrated_estimator: str = "analytic",
            semi_integrated_samps: int = 10, verbose: bool = True,
            parallel: Optional[str] = None, mesh=None, **solve_kwargs):
    """Grid-search the lengthscale by the closed-form ``batch_solve`` ELBO
    over ``np.arange(ell_min, ell_max + ell_step_size, ell_step_size)``
    (``solve_kwargs`` go to ``batch_solve``: ``mean_solver`` and its
    settings).  ``parallel='dp'`` solves each candidate by
    `parallel.dp_batch_solve` over ``mesh`` (default: every rank of the world
    on 'dp'); ``parallel='mp'`` by `parallel.mp_batch_solve` over ``mesh``
    (default: a (1, world) ('dp', 'grid') mesh; the model built with that
    many ``grid_shards``), in batches of ``batch_solve_bsz`` rows (all of
    them when it is not positive), with ``mean_solver`` 'gram' or
    'factored' passed on and anything else solved by 'cg', as in the JAX
    package, and the best state gathered whole (`parallel.mp_gather_state`).
    Every rank gets the same ELBO curve and takes the same argmax.  Returns
    (best_state, best_ell, ell_list, elbo_list)."""
    if parallel not in (None, "dp", "mp"):
        raise ValueError(f"parallel={parallel!r}; choose None | 'dp' | 'mp'")
    as_t = lambda a: torch.as_tensor(a, dtype=model.dtype, device=model.device)
    x, y = as_t(xobs), as_t(yobs)
    s = None if sobs is None else as_t(sobs)
    flags = dict(batch_size=batch_solve_bsz, maxiter_cg=maxiter_cg,
                 integrated_obs=integrated_obs,
                 semi_integrated_estimator=semi_integrated_estimator,
                 semi_integrated_samps=semi_integrated_samps, compute_elbo=True)
    if parallel == "dp":
        from ..parallel import dp_batch_solve, make_mesh

        mesh = make_mesh() if mesh is None else mesh
        solve = lambda st: dp_batch_solve(model, st, x, y, s, mesh, **flags)
    elif parallel == "mp":
        from ..parallel import make_mesh, mp_batch_solve

        if mesh is None:
            world = dist.get_world_size()
            mesh = make_mesh(axis_names=("dp", "grid"), shape=(1, world))
        mp_kw = {k: v for k, v in solve_kwargs.items()
                 if k in ("mean_solver_maxiter", "mean_solver_tol", "factor_jitter")}
        if solve_kwargs.get("mean_solver") in ("gram", "factored"):
            mp_kw["mean_solver"] = solve_kwargs["mean_solver"]
        mp_flags = dict(flags, batch_size=batch_solve_bsz if batch_solve_bsz > 0
                        else x.shape[0])
        solve = lambda st: mp_batch_solve(model, st, x, y, s, mesh, **mp_flags, **mp_kw)
    else:
        solve = lambda st: model.batch_solve(st, x, y, s, **flags, **solve_kwargs)
    ells = np.arange(ell_min, ell_max + ell_step_size, ell_step_size)
    best = (-np.inf, None, None)
    elbo_list = []
    for ell in ells:
        st, elbo = solve(state.replace(log_ell=as_t(float(np.log(ell)))))
        elbo_f = float(elbo)
        elbo_list.append(elbo_f)
        if verbose:
            print(f"ell={ell:.4f} elbo={elbo_f:.5f}", flush=True)
        if elbo_f > best[0]:
            best = (elbo_f, float(ell), st)
    best_state = best[2]
    if parallel == "mp":
        from ..parallel import mp_gather_state

        best_state = mp_gather_state(best_state, mesh)
    return best_state, best[1], list(map(float, ells)), elbo_list


def predictive_variance_correction(model, state, xobs, aobs, sobs, **kwargs) -> float:
    """Post-hoc predictive-std rescale factor
    sqrt(max(sum d^2 - sum s^2, 0) / sum fsig^2), d = aobs - fmu
    (``kwargs`` go to `batch_predict`)."""
    fmu, fsig = batch_predict(model, state, xobs, **kwargs)
    a = torch.as_tensor(aobs).to(dtype=fmu.dtype, device=fmu.device).reshape(-1)
    s = torch.as_tensor(sobs).to(dtype=fmu.dtype, device=fmu.device).reshape(-1)
    num = torch.sum((a - fmu) ** 2) - torch.sum(s ** 2)
    return float(torch.sqrt(torch.clamp(num, min=0.0) / torch.sum(fsig ** 2)))
