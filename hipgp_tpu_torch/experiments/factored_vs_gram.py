"""The 'factored' closed form against 'gram' on the 2-D protocol's data.

The comparison of `chip_smoke.py` [full-batch-factored], on any device: the
paper's 2-D synthetic data (20 000 rows of the "medium" surface, noise 0.01,
seed 42), SqExp at ell 0.05 on an ``--grid``^2 inducing grid in float32,
'factored' (at ``--factor-jitter``, the solver's default when absent) and
'gram' from the same init state with the whitening at ``--maxiter-cg`` and
the mean PCG at ``--mean-maxiter`` / ``--mean-tol``.  It prints the
spectrum's kappa, each solve's stages, its mean PCG's iterations and
residual, the factored solve's checks (`models.hipgp.FACTORED_STATS`) and
any fallback warning, then theta2 max-relative, theta1 and the ELBO of
'factored' against 'gram'.

Usage: python -m hipgp_tpu_torch.experiments.factored_vs_gram --device cpu
           --batch-size 2000 --maxiter-cg 10
       (--maxiter-cg 200 --mean-maxiter 6000 --mean-tol 1e-10 for the
       converged comparison; --factor-jitter 1e-4 for the JAX package's
       float32 jitter, where the default is the float64 factor's 1e-10)
"""
from __future__ import annotations

import argparse
import time
import warnings

import torch

from ..models.hipgp import FACTORED_STATS, MEAN_PCG_STATS
from .run_synthetic import build_model, marginal_sig2
from .synthetic_data import make_two_dim_data

__all__ = ["main"]


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--grid", type=int, default=64)
    p.add_argument("--nobs", type=int, default=20_000)
    p.add_argument("--batch-size", type=int, default=-1)
    p.add_argument("--maxiter-cg", type=int, default=10)
    p.add_argument("--mean-maxiter", type=int, default=200)
    p.add_argument("--mean-tol", type=float, default=1e-8)
    p.add_argument("--factor-jitter", type=float, default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    d = make_two_dim_data(Nobs=args.nobs, Ntest=10, noise_std=0.01,
                          function_complexity="medium", gridnum=64, seed=42)
    m = build_model("SqExp", args.grid, len(d["xobs"]), marginal_sig2(d["yobs"], d["sobs"]),
                    0.05, 0.01, dtype=torch.float32, device=args.device)
    st = m.init_state()
    spec = m.spectrum(st)
    print(f"grid {spec.dims} -> {spec.edims}, kappa {float(spec.eigs.max() / spec.eigs.min()):.6e}",
          flush=True)
    kw = dict(batch_size=args.batch_size, maxiter_cg=args.maxiter_cg,
              mean_solver_maxiter=args.mean_maxiter, mean_solver_tol=args.mean_tol,
              compute_elbo=True)
    out = {}
    for solver, extra in (("factored", {"factor_jitter": args.factor_jitter}), ("gram", {})):
        timings, t0 = {}, time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            new, elbo = m.batch_solve(st, d["xobs"], d["yobs"], d["sobs"], mean_solver=solver,
                                      timings=timings, **kw, **extra)
        out[solver] = (new, float(elbo))
        ms = MEAN_PCG_STATS
        checks = f"; checks {dict(FACTORED_STATS)}" if solver == "factored" else ""
        print(f"{solver}: ELBO {float(elbo):.8f} in {time.perf_counter() - t0:.2f} s ("
              + ", ".join(f"{k} {v:.3f}" for k, v in timings.items())
              + f"); mean PCG {ms['iterations']} iterations, ||r||/||b_m|| "
              f"{ms['resnorm'] / ms['bnorm']:.3e}{checks}; warnings "
              f"{[str(w.message) for w in caught]}", flush=True)
    (f, ef), (g, eg) = out["factored"], out["gram"]
    res = {"theta2_max_rel": float((f.theta2 - g.theta2).abs().max() / g.theta2.abs().max()),
           "theta1_rel": float((f.theta1 - g.theta1).norm() / g.theta1.norm()),
           "elbo_rel": abs(ef - eg) / abs(eg)}
    print("factored vs gram: " + ", ".join(f"{k} {v:.3e}" for k, v in res.items()), flush=True)
    return res


if __name__ == "__main__":
    main()
