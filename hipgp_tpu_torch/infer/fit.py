"""SVI training loop (natural gradients) and chunked prediction.

Counterpart of `hipgp_tpu/infer/fit.py`.  An epoch is a Python loop over
batches: each step takes the ELBO and the natural gradient from
``model.elbo_and_grads`` and applies it to the natural parameters as SGD
with a per-step exponential decay (the JAX package's
``optax.sgd(optax.exponential_decay(lr, 1, step_decay))``).  The
hyperparameters stay fixed: learning them, the step-size guard, shuffling,
checkpoints and resume are not ported yet.  A non-finite epoch raises.

Data is padded to a whole number of batches and masked, as in the JAX
package, so every batch has the same shape.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

__all__ = ["FitConfig", "svigp_fit", "batch_predict", "make_optimizer",
           "prepare_batches", "batch_step"]


@dataclasses.dataclass(frozen=True)
class FitConfig:
    """Training configuration: the fields of the JAX package's FitConfig that
    the natgrad fit with fixed hyperparameters reads, with its defaults."""

    epochs: int = 50
    batch_size: int = 256
    lr: float = 1e-2
    schedule_lr: bool = True
    step_decay: float = 0.99
    maxiter_cg: int = 5
    predict_maxiter_cg: int = 50


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


class ThetaSGD:
    """SGD on the natural parameters with the learning rate
    lr * step_decay ** step (constant without ``schedule_lr``)."""

    def __init__(self, config: FitConfig):
        self.lr = config.lr
        self.decay = config.step_decay if config.schedule_lr else 1.0
        self.count = 0

    def step(self, state, grads):
        lr = self.lr * self.decay ** self.count
        self.count += 1
        return state.replace(theta1=state.theta1 - lr * grads.theta1,
                             theta2=state.theta2 - lr * grads.theta2)


def make_optimizer(config: FitConfig) -> ThetaSGD:
    return ThetaSGD(config)


def batch_step(model, config: FitConfig, opt: ThetaSGD, state, xb, yb, sb, wb):
    """One natural-gradient step on one prepared batch: (state, elbo)."""
    elbo, grads = model.elbo_and_grads(state, xb, yb, sb,
                                       maxiter_cg=config.maxiter_cg, weights=wb)
    return opt.step(state, grads), elbo


def _theta2_warmstart(model, state, xb, sb, w, config: FitConfig):
    """theta2 <- -(Lambda + I)/2 from one Lambda-only pass over the data."""
    spec = model.spectrum(state)
    lam = torch.zeros((model.Mprime,), dtype=model.dtype, device=model.device)
    for b in range(xb.shape[0]):
        ivar = (w[b] / (sb[b] * sb[b]) if sb is not None
                else w[b] * torch.exp(-state.log_noise2))
        Knm, _ = model.make_grams(state, xb[b])
        kn = model.compute_kn(state, Knm, maxiter_cg=config.maxiter_cg, spec=spec)
        lam = lam + model.get_lam(ivar, kn, add_identity=False)
    return state.replace(theta2=-0.5 * (lam + 1.0))


def svigp_fit(model, state, xtrain, ytrain, noise_std_train, config: FitConfig,
              verbose: bool = True, theta2_warmstart: bool = False,
              max_steps: Optional[int] = None):
    """Fit the variational parameters by natural-gradient SVI.

    ``theta2_warmstart``: one Lambda-only pass over the data sets theta2 to
    -(Lambda + I)/2 before SVI.  From the cold init the raw natural-gradient
    iteration overshoots while theta2 (the metric) is still far from the
    data's precision: at N = 20 000, batch 256 the ELBO dives by orders of
    magnitude (to NaN in float32 at M = 125^2), as in the reference; the
    warm metric removes that transient at the cost of one data pass.

    ``max_steps`` ends the fit after that many batch steps in all (None:
    run every epoch to its end).  Returns (state, report); the report holds
    the per-batch ELBO trace, the per-epoch mean ELBOs and wall-clock
    seconds, and the number of steps run."""
    dt_, dev = model.dtype, model.device
    as_t = lambda a: torch.as_tensor(a).to(dtype=dt_, device=dev)
    xb, yb, sb, w = prepare_batches(
        as_t(xtrain), as_t(ytrain),
        None if noise_std_train is None else as_t(noise_std_train),
        config.batch_size,
    )
    opt = make_optimizer(config)
    if theta2_warmstart:
        state = _theta2_warmstart(model, state, xb, sb, w, config)
    nb = xb.shape[0]
    trace, epoch_elbos, epoch_times = [], [], []
    steps = 0
    for epoch in range(config.epochs):
        if max_steps is not None and steps >= max_steps:
            break
        t0 = time.perf_counter()
        elbos = []
        for b in range(nb):
            if max_steps is not None and steps >= max_steps:
                break
            state, elbo = batch_step(model, config, opt, state, xb[b], yb[b],
                                     None if sb is None else sb[b], w[b])
            elbos.append(elbo)
            steps += 1
        elbos_np = torch.stack(elbos).cpu().numpy()
        dt = time.perf_counter() - t0
        epoch_times.append(dt)
        trace.extend(elbos_np.tolist())
        epoch_elbos.append(float(elbos_np.mean()))
        if not np.isfinite(epoch_elbos[-1]):
            raise RuntimeError(
                f"epoch {epoch} mean ELBO is non-finite ({epoch_elbos[-1]}): "
                "the natural-gradient lr is likely above the stability limit "
                "at this lengthscale and grid; lower config.lr or use "
                "theta2_warmstart")
        if verbose:
            print(f"epoch {epoch:4d}: elbo {epoch_elbos[-1]:.4f} ({dt:.2f}s)",
                  flush=True)
    report = {
        "elbo_trace": trace,
        "epoch_elbos": epoch_elbos,
        "epoch_times": epoch_times,
        "steps": steps,
    }
    return state, report


# device-memory budget for one predict chunk's (bsz, M') whitened kn buffer
PREDICT_CHUNK_BUDGET_BYTES = 2 << 30


def batch_predict(model, state, x, batch_size: int = 100, **predict_kwargs):
    """Chunked prediction: pad to a batch multiple and predict chunk by
    chunk.  The chunk is clamped so its (bsz, M') buffer fits the budget,
    counted with the model dtype's item size."""
    x = torch.as_tensor(x).to(dtype=model.dtype, device=model.device)
    N = x.shape[0]
    itemsize = torch.empty((), dtype=model.dtype).element_size()
    per_row = itemsize * model.Mprime
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
