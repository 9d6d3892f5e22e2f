"""Paper section 5.2: whitening-solve wall clock, PCG + FFT vs Cholesky.

Counterpart of `hipgp_tpu/experiments/run_pcg_vs_cholesky.py`, with the same
defaults: K^{-1/2} v on 1-D inducing grids M in {1e3, 5e3, 1e4, 5e4, 1e5,
5e5, 1e6} on [0, 1], for the SqExp, Mat12, Mat32 and Mat52 kernels with
sig2 0.1 and ell one grid spacing, batch 8, 20 fixed PCG iterations
(tol 0), jitter 1e-3; Cholesky only below M = 50 000.  The timed function
builds the spectrum and runs `gram_solve`, as the JAX driver's does; reps
are chained (`utils.timing.chain_time`).  Writes
wall_clock_time_summary_pcg_vs_cholesky_{kernel}.csv per kernel (columns
M, pcg_fft_sec, cholesky_sec).

On a CUDA device in float32, sizes whose embedding the radix plan supports
with at least 8 rows of data run the packed planes PCG through the radix
kernels; other supported sizes run the generic PCG over the radix apply.

Usage: python -m hipgp_tpu_torch.experiments.run_pcg_vs_cholesky
       (--sizes 300 5000 --kernels Mat52 --reps 1 --device cpu for a small
       CPU run)
"""
from __future__ import annotations

import argparse
import csv
import math
import os

import numpy as np
import torch

from ..kernels import kernel_from_name
from ..ops import cholesky_whiten, dense_gram, gram_solve, make_spectrum
from ..utils.timing import chain_time

__all__ = ["main", "protocol_problem", "protocol_solve", "CHOLESKY_MAX_M"]

CHOLESKY_MAX_M = 50_000
SIG2, JITTER, MAXITER = 0.1, 1e-3, 20


def protocol_problem(kern, M, dtype=torch.float32, device="cuda", sig2=SIG2,
                     ell_spacings=1.0):
    """The protocol's operator at size M: (grid, kfun), M points on [0, 1]
    and ``kern`` with variance ``sig2`` and lengthscale ``ell_spacings``
    grid spacings."""
    ell = ell_spacings / M
    grid = torch.linspace(0.0, 1.0, M, dtype=dtype, device=device)
    return grid, lambda a, b: kern(a, b, (sig2, ell))


def protocol_spectrum(grid, kfun):
    """The circulant-embedded spectrum of ``protocol_problem``'s operator."""
    return make_spectrum([grid], kfun, jitter=JITTER)


def protocol_solve(grid, kfun, maxiter=MAXITER):
    """The timed function: v -> K^{-1/2} v, the spectrum built anew and
    ``maxiter`` fixed PCG iterations (tol 0)."""

    def pcg_path(v):
        return gram_solve(protocol_spectrum(grid, kfun), v, maxiter=maxiter,
                          tol=0.0, fixed_iters=True)

    return pcg_path


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--sizes", type=int, nargs="+",
                   default=[1000, 5000, 10_000, 50_000, 100_000, 500_000, 1_000_000])
    p.add_argument("--kernels", nargs="+",
                   default=["SqExp", "Mat12", "Mat32", "Mat52"])
    p.add_argument("--bsz", type=int, default=8)
    p.add_argument("--maxiter-cg", type=int, default=MAXITER)
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--sig2", type=float, default=SIG2)
    p.add_argument("--ell-spacings", type=float, default=1.0,
                   help="lengthscale in units of grid spacings (reference: 1)")
    p.add_argument("--output-dir", default="./output-pcg-vs-cholesky")
    p.add_argument("--f64", action="store_true")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    dtype = torch.float64 if args.f64 else torch.float32
    dev = torch.device(args.device)
    os.makedirs(args.output_dir, exist_ok=True)
    rng = np.random.default_rng(0)

    all_results = {}
    for kname in args.kernels:
        kern = kernel_from_name(kname)
        rows = []
        for M in args.sizes:
            grid, kfun = protocol_problem(kern, M, dtype, dev, args.sig2,
                                          args.ell_spacings)
            v = torch.as_tensor(rng.standard_normal((args.bsz, M)), dtype=dtype,
                                device=dev)
            pcg_path = protocol_solve(grid, kfun, args.maxiter_cg)
            t_pcg, _ = chain_time(pcg_path, v, reps=args.reps)

            t_chol = math.nan
            if M < CHOLESKY_MAX_M:
                def chol_path(v):
                    K = dense_gram([grid], kfun, jitter=JITTER)
                    return cholesky_whiten(K, v)

                t_chol, _ = chain_time(chol_path, v, reps=args.reps)

            rows.append({"M": M, "pcg_fft_sec": t_pcg, "cholesky_sec": t_chol})
            print(f"{kname} M={M:>8d}: pcg {t_pcg * 1e3:9.2f} ms   "
                  f"cholesky {t_chol * 1e3:9.2f} ms", flush=True)
        path = os.path.join(args.output_dir,
                            f"wall_clock_time_summary_pcg_vs_cholesky_{kname}.csv")
        with open(path, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=["M", "pcg_fft_sec", "cholesky_sec"])
            w.writeheader()
            w.writerows(rows)
        all_results[kname] = rows
    return all_results


if __name__ == "__main__":
    main()
