"""The paper's synthetic 2-D regression protocol on the PyTorch port.

Counterpart of `hipgp_tpu/experiments/run_synthetic.py` for the mean-field
model with natural-gradient SVI: the same defaults (N = 20 000 observations
and 2 000 test points of the "medium" random sin/tanh surface, noise 0.01,
M = 125^2 inducing points on [-1, 1]^2, SqExp with ell 0.05, batch 256,
maxiter_cg 10, 10 epochs), the same model construction as the JAX harness
(sig2 from the marginal variance of y, init_Svar 1, jitter 1e-3), one fit and
one prediction.  It prints the test RMSE and mean log-likelihood and writes
no file.

Usage: python -m hipgp_tpu_torch.experiments.run_synthetic --epochs 1
       (add --device cpu --nobs 2000 --num-inducing 32 for a small CPU run)
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..infer import FitConfig, batch_predict, svigp_fit
from ..kernels import kernel_from_name
from ..models import HIPGP
from ..utils import metrics
from .synthetic_data import make_two_dim_data

__all__ = ["main", "build_model", "marginal_sig2"]

# rows per prediction chunk (the JAX harness's predict_batch_size)
PREDICT_BATCH = 4096


def marginal_sig2(yobs, sobs) -> float:
    """var(y) - mean noise^2, floored at 1e-3 (the JAX harness's
    ``sig2_init='marginal'``)."""
    nvar = 0.0 if sobs is None else float(np.mean(np.asarray(sobs) ** 2))
    return max(float(np.var(np.asarray(yobs))) - nvar, 1e-3)


def build_model(kernel: str, num_inducing: int, num_obs: int, sig2_init: float,
                ell: float, noise_std: float, dtype=torch.float32,
                device="cuda") -> HIPGP:
    """The mean-field HIP-GP of the protocol on a num_inducing^2 grid."""
    grids = [np.linspace(-1, 1, num_inducing)] * 2
    return HIPGP(kernel_from_name(kernel), grids, num_obs=num_obs,
                 sig2_init=sig2_init, ell_init=ell, noise2_init=noise_std ** 2,
                 init_Svar=1.0, jitter=1e-3, dtype=dtype, device=device)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--nobs", type=int, default=20_000)
    p.add_argument("--ntest", type=int, default=2000)
    p.add_argument("--noise-std", type=float, default=0.01)
    p.add_argument("--function-complexity", default="medium",
                   choices=["simple", "medium", "hard"])
    p.add_argument("--num-inducing", type=int, default=125,
                   help="inducing grid points per dimension")
    p.add_argument("--gridnum", type=int, default=64,
                   help="evaluation grid points per dimension (sets the centring)")
    p.add_argument("--kernel", default="SqExp")
    p.add_argument("--ell", type=float, default=0.05)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--steps", type=int, default=None,
                   help="stop after this many batch steps in all")
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--theta2-warmstart", action="store_true",
                   help="one Lambda-only sweep initializes theta2 before SVI")
    p.add_argument("--no-schedule-lr", action="store_true",
                   help="constant natgrad lr")
    p.add_argument("--maxiter-cg", type=int, default=10)
    p.add_argument("--device", default="cuda")
    p.add_argument("--f64", action="store_true")
    args = p.parse_args(argv)

    d = make_two_dim_data(Nobs=args.nobs, Ntest=args.ntest,
                          noise_std=args.noise_std,
                          function_complexity=args.function_complexity,
                          gridnum=args.gridnum)
    dtype = torch.float64 if args.f64 else torch.float32
    model = build_model(args.kernel, args.num_inducing, len(d["xobs"]),
                        marginal_sig2(d["yobs"], d["sobs"]), args.ell,
                        args.noise_std, dtype=dtype, device=args.device)
    cfg = FitConfig(epochs=args.epochs, batch_size=args.batch_size, lr=args.lr,
                    maxiter_cg=args.maxiter_cg,
                    schedule_lr=not args.no_schedule_lr)
    t0 = time.perf_counter()
    state, report = svigp_fit(model, model.init_state(), d["xobs"], d["yobs"],
                              d["sobs"], cfg,
                              theta2_warmstart=args.theta2_warmstart,
                              max_steps=args.steps)
    fit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    mu, sig = batch_predict(model, state, d["xtest"], batch_size=PREDICT_BATCH,
                            maxiter_cg=cfg.predict_maxiter_cg)
    mu, sig = mu.cpu().numpy(), sig.cpu().numpy()
    predict_s = time.perf_counter() - t0
    summary = metrics.error_summary(d["ftest"], mu, sig)
    out = {
        "steps": report["steps"],
        "first_elbo": report["elbo_trace"][0],
        "last_elbo": report["elbo_trace"][-1],
        "fit_s": fit_s,
        "predict_s": predict_s,
        "test_rmse": summary["rmse"],
        "test_loglike": summary["loglike"],
        "ftest_std": float(np.std(d["ftest"])),
    }
    print(f"device {args.device}: {report['steps']} steps in {fit_s:.2f} s, "
          f"ELBO {out['first_elbo']:.4f} -> {out['last_elbo']:.4f}; "
          f"test RMSE {out['test_rmse']:.5f} (std(ftest) {out['ftest_std']:.5f}), "
          f"mean loglike {out['test_loglike']:.4f}", flush=True)
    return out


if __name__ == "__main__":
    main()
