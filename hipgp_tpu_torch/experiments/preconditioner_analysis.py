"""Paper appendix C.1: preconditioner efficiency r_pcg = PCG iters / CG iters.

Counterpart of `hipgp_tpu/experiments/preconditioner_analysis.py`, with the
same defaults: for 1-D grids of M in {10 .. 500} points on [0, 1], the
SqExp, Mat12, Mat32 and Mat52 kernels and ell in {0.05, 0.5} (sig2 1,
jitter 1e-3), the iterations CG and circulant-preconditioned CG take to
``--tol`` (`ops.pcg_result`, at most ``--maxiter``) on ``--bsz`` standard
normal right-hand sides (`np.random.default_rng(0)`, drawn in the JAX
script's order), and their ratio.  Writes r_pcg.csv (columns kernel, ell, M,
cg_iters, pcg_iters, r_pcg) into ``--output-dir`` with the ``csv`` module
and returns the table as a dict of numpy arrays, one per column.  Each row's
line names the branch its matvecs take (`ops.bttb.apply_route`: the einsum
chain up to an embedding of 512, beyond it torch.fft, or the radix kernels
on the card where the radix plan takes the length).

Usage: python -m hipgp_tpu_torch.experiments.preconditioner_analysis
       (add --device cpu --sizes 16 64 --kernels Mat52 --ells 0.05 --f64 for
       a small CPU run)
"""
from __future__ import annotations

import argparse
import csv
import os

import numpy as np
import torch

from ..kernels import kernel_from_name
from ..ops import make_spectrum, matmul_by_Cinv, matmul_by_K, pcg_result
from ..ops.bttb import apply_route

__all__ = ["main", "iters_to_tol", "COLUMNS"]

COLUMNS = ("kernel", "ell", "M", "cg_iters", "pcg_iters", "r_pcg")


def iters_to_tol(spec, b, tol, maxiter, precond: bool) -> int:
    pc = (lambda v: matmul_by_Cinv(spec, v)) if precond else None
    res = pcg_result(lambda v: matmul_by_K(spec, v), b, precond=pc, maxiter=maxiter,
                     tol=tol)
    return int(res.iters)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--sizes", type=int, nargs="+", default=[10, 25, 50, 100, 250, 500])
    p.add_argument("--kernels", nargs="+", default=["SqExp", "Mat12", "Mat32", "Mat52"])
    p.add_argument("--ells", type=float, nargs="+", default=[0.05, 0.5])
    p.add_argument("--tol", type=float, default=1e-6)
    p.add_argument("--maxiter", type=int, default=2000)
    p.add_argument("--bsz", type=int, default=4)
    p.add_argument("--output-dir", default="./output-precond")
    p.add_argument("--f64", action="store_true")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    dtype = torch.float64 if args.f64 else torch.float32
    os.makedirs(args.output_dir, exist_ok=True)
    rng = np.random.default_rng(0)

    rows = []
    for kname in args.kernels:
        kern = kernel_from_name(kname)
        for ell in args.ells:
            for M in args.sizes:
                grid = torch.linspace(0.0, 1.0, M, dtype=dtype, device=args.device)
                spec = make_spectrum([grid], lambda a, b: kern(a, b, (1.0, ell)), jitter=1e-3)
                b = torch.as_tensor(rng.standard_normal((args.bsz, M))).to(
                    dtype=dtype, device=args.device)
                it_cg = iters_to_tol(spec, b, args.tol, args.maxiter, False)
                it_pcg = iters_to_tol(spec, b, args.tol, args.maxiter, True)
                rows.append({"kernel": kname, "ell": ell, "M": M, "cg_iters": it_cg,
                             "pcg_iters": it_pcg, "r_pcg": it_pcg / max(it_cg, 1)})
                print({**rows[-1], "matvecs": apply_route(spec, dtype, args.device)},
                      flush=True)
    with open(os.path.join(args.output_dir, "r_pcg.csv"), "w", newline="") as f:
        wr = csv.writer(f)
        wr.writerow(COLUMNS)
        wr.writerows([r[c] for c in COLUMNS] for r in rows)
    return {c: np.array([r[c] for r in rows]) for c in COLUMNS}


if __name__ == "__main__":
    main()
