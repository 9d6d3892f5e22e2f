"""Paper section 5.1: CG against circulant-preconditioned CG on K_n solves.

Counterpart of `hipgp_tpu/experiments/run_solve_kn.py`, with the same
defaults: for each 2-D inducing grid of ``--gridsizes`` points a side on
[0, 1]^2 (Matern-5/2, sig2 1, ell 0.05, jitter 1e-3), solve K d = Knm for
``--bsz`` rows of Knm at uniform points (`np.random.default_rng(seed)`, as
the JAX script draws them) with plain CG and with PCG, ``--num-iters``
iterations each, tracing the iterate's RMSE and MAE against a reference
solve (`ops.pcg_trace` with min(4 num_iters, 4000) PCG iterations) and the
largest residual norm of the batch.  Writes {cg,pcg}-trace-grid{g}.csv per
grid (columns iter, rmse, mae, resnorm) into ``--output-dir`` with the
``csv`` module, prints the iterations each method takes to 10 x the least
CG RMSE, and unless ``--no-plots`` the two comparison plots (matplotlib,
imported there only).  Each grid's line names the branch its matvecs take
(`ops.bttb.apply_route`: the einsum chain, or kernel B-8 on the card under
``bttb.USE_PALLAS_TRANSFORM``) and its seconds.

Usage: python -m hipgp_tpu_torch.experiments.run_solve_kn --no-plots
       (add --device cpu --gridsizes 12 --num-iters 60 --bsz 4 for a small
       CPU run)
"""
from __future__ import annotations

import argparse
import csv
import os
import time

import numpy as np
import torch

from ..kernels import kernel_from_name
from ..ops import make_spectrum, matmul_by_Cinv, matmul_by_K, pcg_trace
from ..ops.bttb import apply_route
from ..ops.radix_fft import LAUNCHES

__all__ = ["main", "run_one", "iters_to"]

COLUMNS = ("iter", "rmse", "mae", "resnorm")


def run_one(gridsize: int, kernel_name: str, ell: float, num_iters: int, bsz: int,
            seed: int, dtype=torch.float32, device="cuda"):
    """{'cg': trace, 'pcg': trace} for one grid, each trace a dict of numpy
    arrays over the iterations (iter, rmse, mae, resnorm); prints the
    embedding and the branch the matvecs take."""
    kern = kernel_from_name(kernel_name)
    grids = [torch.linspace(0.0, 1.0, gridsize, dtype=dtype, device=device)] * 2
    kfun = lambda a, b: kern(a, b, (1.0, ell))
    spec = make_spectrum(grids, kfun, jitter=1e-3)
    print(f"grid {gridsize}x{gridsize}: embedded {spec.edims}, matvecs "
          f"{apply_route(spec, dtype, device)}", flush=True)

    rng = np.random.default_rng(seed)
    xbatch = torch.as_tensor(rng.uniform(0, 1, (bsz, 2))).to(dtype=dtype, device=device)
    mesh = torch.meshgrid(*grids, indexing="ij")
    xinduce = torch.stack([m.reshape(-1) for m in mesh], dim=-1)
    Knm = kern(xbatch, xinduce, (1.0, ell))   # (bsz, M)

    mv = lambda v: matmul_by_K(spec, v)
    pc = lambda v: matmul_by_Cinv(spec, v)
    # converged reference solution (a long PCG run)
    x_star, _ = pcg_trace(mv, Knm, precond=pc, num_iters=min(4 * num_iters, 4000))

    def metric(xk):
        err = xk - x_star
        return {"rmse": torch.sqrt(torch.mean(err ** 2)), "mae": torch.mean(torch.abs(err))}

    out = {}
    for name, use_pc in (("cg", False), ("pcg", True)):
        _, tr = pcg_trace(mv, Knm, precond=pc if use_pc else None, num_iters=num_iters,
                          metric_fn=metric)
        out[name] = {"iter": np.arange(num_iters),
                     "rmse": tr["metric"]["rmse"].cpu().numpy(),
                     "mae": tr["metric"]["mae"].cpu().numpy(),
                     "resnorm": tr["resnorm"].max(dim=-1).values.cpu().numpy()}
    return out


def iters_to(rmse: np.ndarray, tol: float, num_iters: int) -> int:
    """The first iteration whose RMSE is below ``tol`` (num_iters if none)."""
    below = rmse < tol
    return int(np.argmax(below)) if below.any() else num_iters


def _write_csv(path, trace):
    with open(path, "w", newline="") as f:
        wr = csv.writer(f)
        wr.writerow(COLUMNS)
        wr.writerows(zip(*(trace[c].tolist() for c in COLUMNS)))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--gridsizes", type=int, nargs="+", default=[25, 50, 100])
    p.add_argument("--kernel", default="Mat52")
    p.add_argument("--ell", type=float, default=0.05)
    p.add_argument("--num-iters", type=int, default=2000)
    p.add_argument("--bsz", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--f64", action="store_true")
    p.add_argument("--output-dir", default="./output-solve-kn")
    p.add_argument("--no-plots", action="store_true")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    dtype = torch.float64 if args.f64 else torch.float32
    os.makedirs(args.output_dir, exist_ok=True)
    on_card = torch.device(args.device).type == "cuda"

    results = {}
    for g in args.gridsizes:
        radix0 = dict(LAUNCHES)
        t0 = time.perf_counter()
        res = run_one(g, args.kernel, args.ell, args.num_iters, args.bsz, args.seed,
                      dtype, args.device)
        if on_card:
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        radix = {k: v - radix0[k] for k, v in LAUNCHES.items() if v != radix0[k]}
        for name, trace in res.items():
            _write_csv(os.path.join(args.output_dir, f"{name}-trace-grid{g}.csv"), trace)
        results[g] = res
        r_cg, r_pcg = res["cg"]["rmse"], res["pcg"]["rmse"]
        tol = max(r_cg.min(), 1e-12) * 10
        it_cg = iters_to(r_cg, tol, args.num_iters)
        it_pcg = iters_to(r_pcg, tol, args.num_iters)
        print(f"  {secs:.2f} s, radix launches {radix}: iters to rmse<{tol:.1e}: "
              f"cg={it_cg} pcg={it_pcg}", flush=True)

    if not args.no_plots:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        for stat in ("rmse", "mae"):
            fig, ax = plt.subplots(figsize=(7, 5))
            for g, res in results.items():
                frac = np.arange(args.num_iters) / args.num_iters
                ax.semilogy(frac, res["cg"][stat], "--", label=f"CG {g}x{g}")
                ax.semilogy(frac, res["pcg"][stat], "-", label=f"PCG {g}x{g}")
            ax.set_xlabel("fraction of CG iterations")
            ax.set_ylabel(stat)
            ax.legend()
            fig.savefig(os.path.join(args.output_dir, f"cg-pcg-comparison-{stat}.pdf"),
                        bbox_inches="tight")
            plt.close(fig)
    return results


if __name__ == "__main__":
    main()
