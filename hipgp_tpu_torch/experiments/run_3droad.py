"""Appendix C.3: UCI 3droad altitude regression, on the port.

Counterpart of `hipgp_tpu/experiments/run_3droad.py`, with the same CLI:
434 874 rows of (lat, lon, altitude), standardized, split 64/16/20 into
train, valid and test, fit through the harness (`harness.fit_predict_and_save`,
the 'dense' closed form by default).  ``--data-path`` points to the UCI
``3D_spatial_network.txt`` (id, lat, lon, altitude); without it a synthetic
road-altitude surface of ``--nobs`` rows stands in.  ``--device`` (default
cuda) and ``--f64`` are the port's.  ``--parallel dp`` fits data-parallel,
one process per device: ``torchrun --nproc-per-node N -m
hipgp_tpu_torch.experiments.run_3droad --parallel dp`` (without torchrun, a
world of one process); ``--parallel mp`` fits model-parallel the same way,
the whitened state split over a (1, world) ('dp', 'grid') mesh (mean-field
and block; the harness's 'dense' becomes the split 'cg').

Usage: python -m hipgp_tpu_torch.experiments.run_3droad
       (add --device cpu --nobs 400 --num-inducing 8 for a small CPU run)
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..infer import FitConfig
from .harness import fit_predict_and_save, init_parallel

__all__ = ["main", "load_uci_3droad", "synthetic_road_data", "split_64_16_20"]


def load_uci_3droad(path: str, seed: int = 0):
    """(x (N, 2) standardized, y (N,) standardized) from the UCI file,
    rows permuted by ``np.random.RandomState(seed)``."""
    raw = np.loadtxt(path, delimiter=",")
    x = raw[:, 1:3]
    y = raw[:, 3]
    x = (x - x.mean(axis=0)) / x.std(axis=0)
    y = (y - y.mean()) / y.std()
    perm = np.random.RandomState(seed).permutation(len(x))
    return x[perm], y[perm]


def synthetic_road_data(n: int, seed: int = 0):
    rs = np.random.RandomState(seed)
    x = rs.uniform(-2, 2, (n, 2))
    f = (np.sin(2.0 * x[:, 0]) * np.cos(1.5 * x[:, 1])
         + 0.5 * np.sin(5.0 * x[:, 0] * x[:, 1]))
    y = f + 0.15 * rs.standard_normal(n)
    return x, y, f


def split_64_16_20(n):
    ntr = int(0.64 * n)
    nva = int(0.16 * n)
    return slice(0, ntr), slice(ntr, ntr + nva), slice(ntr + nva, n)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data-path", default=None)
    p.add_argument("--nobs", type=int, default=20_000, help="synthetic N when no data file")
    p.add_argument("--num-inducing", type=int, default=64)
    p.add_argument("--model-class", default="mean-field")
    p.add_argument("--kernel", default="Mat52")
    p.add_argument("--ell", type=float, default=0.1)
    p.add_argument("--sig2-init", type=float, default=0.1,
                   help="marginal-variance init; <= 0 uses the empirical "
                        "distance-slope regression (the reference's default is 0.1)")
    p.add_argument("--noise-std", type=float, default=0.15)
    p.add_argument("--fit-method", default="full-batch", choices=["natgrad", "full-batch"])
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--batch-size", type=int, default=1024)
    p.add_argument("--maxiter-cg", type=int, default=20)
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--kernel-lr", type=float, default=1e-3)
    p.add_argument("--mean-solver", default="dense",
                   choices=["dense", "cg", "gram", "factored", "matfree"])
    p.add_argument("--parallel", default=None, choices=["dp", "mp"],
                   help="over the ranks of torchrun's world: dp data-parallel, mp "
                        "model-parallel (the state split over a (1, world) grid)")
    p.add_argument("--learn-kernel", action="store_true",
                   help="learn hyperparameters (cholesky whitening under 'auto')")
    p.add_argument("--whitening", default="auto", choices=["auto", "ziggy", "cholesky"],
                   help="'auto': cholesky iff --learn-kernel (the reference's rule); "
                        "'ziggy' learns the hyperparameters through the PCG whitening")
    p.add_argument("--theta2-warmstart", action="store_true",
                   help="one Lambda-only sweep before natgrad SVI")
    p.add_argument("--output-dir", default="./output-3droad")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--f64", action="store_true")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    mesh, _ = init_parallel(args.parallel, args.device)

    ftrue = None
    if args.data_path and os.path.exists(args.data_path):
        x, y = load_uci_3droad(args.data_path, args.seed)
    else:
        print("no --data-path: generating synthetic 3droad-like data", flush=True)
        x, y, ftrue = synthetic_road_data(args.nobs, args.seed)

    tr, va, te = split_64_16_20(len(x))
    sobs = np.full(len(x), args.noise_std)
    lo, hi = x.min(axis=0), x.max(axis=0)
    grids = [np.linspace(lo[d], hi[d], args.num_inducing) for d in range(2)]
    cfg = FitConfig(epochs=args.epochs, batch_size=args.batch_size,
                    maxiter_cg=args.maxiter_cg, lr=args.lr,
                    learn_kernel=args.learn_kernel, kernel_lr=args.kernel_lr)
    return fit_predict_and_save(
        name=f"3droad-{args.model_class}",
        xobs=x[tr], yobs=y[tr], sobs=sobs[tr], xinduce_grids=grids,
        model_class=args.model_class, kernel=args.kernel,
        sig2_init=(args.sig2_init if args.sig2_init > 0 else "empirical"),
        ell_init=args.ell, noise2_init=args.noise_std ** 2,
        whitened_type=(("cholesky" if args.learn_kernel else "ziggy")
                       if args.whitening == "auto" else args.whitening),
        theta2_warmstart=args.theta2_warmstart, fit_method=args.fit_method,
        fit_config=cfg, maxiter_cg=args.maxiter_cg, mean_solver=args.mean_solver,
        parallel=args.parallel, mesh=mesh, batch_solve_bsz=args.batch_size,
        xvalid=x[va], fvalid=(ftrue[va] if ftrue is not None else y[va]),
        xtest=x[te], ftest=(ftrue[te] if ftrue is not None else y[te]),
        output_dir=args.output_dir,
        dtype=torch.float64 if args.f64 else torch.float32, device=args.device)


if __name__ == "__main__":
    main()
