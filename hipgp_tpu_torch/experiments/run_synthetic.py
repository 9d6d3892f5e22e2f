"""The paper's synthetic 2-D regression protocol on the PyTorch port.

Counterpart of `hipgp_tpu/experiments/run_synthetic.py`: the same defaults (N = 20 000 observations and 2 000 test points of
the "medium" random sin/tanh surface, noise 0.01, M = 125^2 inducing points
on [-1, 1]^2, SqExp with ell 0.05, batch 256, maxiter_cg 10, 10 epochs) and
the same flags: ``--fit-method`` natgrad (SVI) or full-batch (the
closed-form ``batch_solve`` with ``--mean-solver`` dense, cg, gram or factored),
``--ell-sweep MIN MAX STEP`` (the lengthscale picked by the closed-form
ELBO before the fit, written to ``ell_sweep.csv``), ``--integrated-obs``.
Each model of ``--models`` (mean-field, block-diagonal with blocks of
``--xblock-size`` points along each axis of the embedded grid, full-rank
under the 'standard' parameterization, full batch only, or the dense
unwhitened SVGP over the same grid's M points) runs through the harness
(`harness.fit_predict_and_save`: sig2 from the marginal variance of y,
init_Svar 1, jitter 1e-3), which writes its artifacts and figures (the
evaluation grid's among them) under ``--output-dir``; the summary of every model goes to
``errordf-summary.csv`` there.  It prints the test RMSE and mean
log-likelihood.  ``--device``, ``--steps`` and ``--f64`` are the port's.
``--parallel dp`` fits (and sweeps the lengthscale) data-parallel, one
process per device, every rank generating the same data and only rank 0
writing; ``--parallel mp`` fits (and sweeps) model-parallel the same way,
the whitened state split over a (1, world) ('dp', 'grid') mesh (mean-field
and block models).

Usage: python -m hipgp_tpu_torch.experiments.run_synthetic --epochs 1
       (add --device cpu --nobs 2000 --num-inducing 32 for a small CPU run;
       --fit-method full-batch --mean-solver gram for the closed form)
       torchrun --nproc-per-node N -m hipgp_tpu_torch.experiments.run_synthetic
           --parallel dp    (or --parallel mp)
       (without torchrun, --parallel runs as a world of one process)
"""
from __future__ import annotations

import argparse
import csv
import os
import time

import numpy as np
import torch

from ..infer import FitConfig, ell_fit
from ..kernels import kernel_from_name
from ..models import HIPGP
from ..utils import metrics
from .harness import fit_predict_and_save, init_parallel, make_model
from .synthetic_data import make_two_dim_data

__all__ = ["main", "build_model", "marginal_sig2"]


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
                   help="evaluation grid points per dimension")
    p.add_argument("--models", nargs="+", default=["mean-field"],
                   choices=["mean-field", "block-diagonal", "full-rank", "SVGP"])
    p.add_argument("--kernel", default="SqExp")
    p.add_argument("--ell", type=float, default=0.05)
    p.add_argument("--fit-method", default="natgrad", choices=["natgrad", "full-batch"])
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--steps", type=int, default=None,
                   help="stop the natgrad fit after this many batch steps in all")
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--theta2-warmstart", action="store_true",
                   help="one Lambda-only sweep initializes theta2 before SVI")
    p.add_argument("--no-schedule-lr", action="store_true",
                   help="constant natgrad lr")
    p.add_argument("--maxiter-cg", type=int, default=10)
    p.add_argument("--xblock-size", type=int, default=5)
    p.add_argument("--integrated-obs", action="store_true")
    p.add_argument("--ell-sweep", type=float, nargs=3, metavar=("MIN", "MAX", "STEP"),
                   default=None,
                   help="grid-search the lengthscale by batch-solve ELBO before fitting")
    p.add_argument("--mean-solver", default="dense",
                   choices=["dense", "cg", "gram", "factored"])
    p.add_argument("--output-dir", default="./output-synthetic")
    p.add_argument("--parallel", default=None, choices=["dp", "mp"],
                   help="over the ranks of torchrun's world: dp data-parallel, mp "
                        "model-parallel (the state split over a (1, world) grid)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--f64", action="store_true")
    args = p.parse_args(argv)
    mesh, writer = init_parallel(args.parallel, args.device)

    if writer:
        os.makedirs(args.output_dir, exist_ok=True)
    d = make_two_dim_data(Nobs=args.nobs, Ntest=args.ntest, noise_std=args.noise_std,
                          function_complexity=args.function_complexity,
                          do_integrated=args.integrated_obs, gridnum=args.gridnum)
    yobs = d["aobs"] if args.integrated_obs else d["yobs"]
    dtype = torch.float64 if args.f64 else torch.float32
    grids = [np.linspace(-1, 1, args.num_inducing)] * 2
    cfg = FitConfig(epochs=args.epochs, batch_size=args.batch_size, lr=args.lr,
                    maxiter_cg=args.maxiter_cg, integrated_obs=args.integrated_obs,
                    schedule_lr=not args.no_schedule_lr)

    ell = args.ell
    if args.ell_sweep is not None:
        shards = None
        if args.parallel == "mp":
            from ..parallel.mesh import axis_size

            shards = axis_size(mesh, "grid")
        probe = make_model("mean-field", args.kernel, grids, num_obs=len(d["xobs"]),
                           sig2_init=float(np.var(yobs)), ell_init=args.ell,
                           noise2_init=args.noise_std ** 2,
                           support_integrated_obs=args.integrated_obs,
                           grid_shards=shards, dtype=dtype, device=args.device)
        _, ell, ells, elbos = ell_fit(
            probe, probe.init_state(), d["xobs"], yobs, d["sobs"],
            ell_min=args.ell_sweep[0], ell_max=args.ell_sweep[1],
            ell_step_size=args.ell_sweep[2], batch_solve_bsz=args.batch_size,
            maxiter_cg=args.maxiter_cg, integrated_obs=args.integrated_obs,
            verbose=writer, parallel=args.parallel, mesh=mesh)
        if writer:
            metrics.write_csv(os.path.join(args.output_dir, "ell_sweep.csv"),
                              {"ell": ells, "elbo": elbos})
            print(f"ell sweep selected ell = {ell}", flush=True)

    summaries, outs = [], []
    for model_class in args.models:
        name = f"{model_class}-{args.kernel}"
        if writer:
            print(f"=== {name} ===", flush=True)
        t0 = time.perf_counter()
        model, state, report = fit_predict_and_save(
            name=name, xobs=d["xobs"], yobs=yobs, sobs=d["sobs"], xinduce_grids=grids,
            model_class=model_class, kernel=args.kernel, sig2_init="marginal",
            ell_init=ell, noise2_init=args.noise_std ** 2,
            block_sizes=(args.xblock_size, args.xblock_size), fit_method=args.fit_method,
            fit_config=cfg, maxiter_cg=args.maxiter_cg, mean_solver=args.mean_solver,
            theta2_warmstart=args.theta2_warmstart, xtest=d["xtest"],
            ftest=d["ftest"], etest=d["etest"], xgrid=d["xgrid"], fgrid=d["fgrid"],
            grid_shape=d["grid_shape"], grid_extent=d["grid_extent"],
            output_dir=args.output_dir, dtype=dtype, device=args.device,
            max_steps=args.steps, parallel=args.parallel, mesh=mesh)
        wall_s = time.perf_counter() - t0
        if writer:
            with open(os.path.join(args.output_dir, name, "noise_reduction.csv")) as f:
                rows = list(csv.reader(f))[1:]
            summaries.append({"model": name, **{r[0]: float(r[1]) for r in rows}})
        pd_ = report["pdict"]
        summary = metrics.error_summary(pd_["ftest"], pd_["fmu_test"], pd_["fsig_test"])
        trace = report["elbo_trace"]
        out = {
            "model": name,
            "fit_method": args.fit_method,
            "steps": report.get("steps", 0),
            "first_elbo": trace[0],
            "last_elbo": trace[-1],
            "fit_s": report["time_report"]["fitting"],
            "predict_s": report["time_report"]["ftest_eval"],
            "wall_s": wall_s,
            "test_rmse": summary["rmse"],
            "test_loglike": summary["loglike"],
            "ftest_std": float(np.std(d["ftest"])),
        }
        outs.append(out)
        if not writer:
            continue
        print(f"device {args.device}: {name} {args.fit_method}"
              + (f" ({args.mean_solver})" if args.fit_method == "full-batch"
                 else f", {out['steps']} steps")
              + f" in {out['fit_s']:.2f} s, ELBO {out['first_elbo']:.4f} -> "
              f"{out['last_elbo']:.4f}; test RMSE {out['test_rmse']:.5f} (std(ftest) "
              f"{out['ftest_std']:.5f}), mean loglike {out['test_loglike']:.4f}",
              flush=True)
    cols = []
    for r in summaries:
        cols += [k for k in r if k not in cols]
    if writer:
        metrics.write_csv(os.path.join(args.output_dir, "errordf-summary.csv"),
                          {c: [r.get(c, np.nan) for r in summaries] for c in cols})
    return outs[0] if len(outs) == 1 else outs


if __name__ == "__main__":
    main()
