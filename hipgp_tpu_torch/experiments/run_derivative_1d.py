"""Paper section 5.3: a 1-D GP with derivative observations, on the port.

Counterpart of `hipgp_tpu/experiments/run_derivative_1d.py`, with the same
CLI and outputs: a random-MLP 1-D function observed through ``--nlatent``
function values and ``--nprime`` derivative values; Adam (the port's
`infer.fit.HyperAdam`, optax's ``adam``) on (log_sig2, log_ell) of the loss
-ELBO/1e4 through the closed-form `models.derivative_gp.svgp_batch_solve`;
then the posterior in the latent and derivative domains against the truth
and the exact joint GP.  Writes ``derivative-1d-summary.csv`` and
``loss_trace.npy`` into ``--output-dir``; ``--compare`` instead runs the
notebook's comparison ({ziggy, cholesky} x {with, without derivative
observations} and the exact joint GP) into ``derivative-comparison.csv``.
``--device`` (default cuda) and ``--f64`` choose where and in what.

Usage: python -m hipgp_tpu_torch.experiments.run_derivative_1d --f64
       (add --device cpu for a CPU run)
"""
from __future__ import annotations

import argparse
import csv
import dataclasses
import os

import numpy as np
import torch

from ..infer.fit import HyperAdam
from ..models.derivative_gp import (compute_elbo, exact_gp_prediction,
                                    posterior_prediction, svgp_batch_solve)
from .synthetic_data import make_one_dim_function

__all__ = ["main", "write_rows"]


@dataclasses.dataclass(frozen=True)
class _Hypers:
    """(log_sig2, log_ell), or their gradients, for `HyperAdam`."""

    log_sig2: torch.Tensor
    log_ell: torch.Tensor

    def replace(self, **changes) -> "_Hypers":
        return dataclasses.replace(self, **changes)


def write_rows(path: str, rows) -> None:
    """A list of dicts as CSV, columns in order of first appearance (as
    pandas writes a frame built from the list, without its index)."""
    cols = []
    for r in rows:
        cols += [k for k in r if k not in cols]
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=cols, restval="")
        w.writeheader()
        w.writerows(rows)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--nlatent", type=int, default=1000)
    p.add_argument("--nprime", type=int, default=10)
    p.add_argument("--num-inducing", type=int, default=128)
    p.add_argument("--noise-std", type=float, default=0.05)
    p.add_argument("--deriv-noise-std", type=float, default=None,
                   help="derivative-observation noise std (defaults to "
                        "--noise-std; the notebook uses 0.2 vs 0.05)")
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--lr", type=float, default=0.05)
    p.add_argument("--maxiter-cg", type=int, default=50)
    p.add_argument("--whitened-type", default="ziggy", choices=["ziggy", "cholesky"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--output-dir", default="./output-derivative-1d")
    p.add_argument("--f64", action="store_true")
    p.add_argument("--device", default="cuda")
    p.add_argument("--compare", action="store_true",
                   help="run the notebook's model comparison: {ziggy, cholesky}"
                        " x {with, without derivative obs} + the exact joint GP")
    args = p.parse_args(argv)

    dtype = torch.float64 if args.f64 else torch.float32
    dev = torch.device(args.device)
    os.makedirs(args.output_dir, exist_ok=True)
    t = lambda a: torch.as_tensor(np.asarray(a)).to(dtype=dtype, device=dev)

    f, fprime = make_one_dim_function(seed=args.seed)
    rng = np.random.default_rng(args.seed)
    x = np.sort(rng.uniform(0.0, 2.0, args.nlatent))
    xp = np.sort(rng.uniform(0.0, 2.0, args.nprime))
    y = f(x) + args.noise_std * rng.standard_normal(args.nlatent)
    nsp = args.deriv_noise_std if args.deriv_noise_std is not None else args.noise_std
    yp = fprime(xp) + nsp * rng.standard_normal(args.nprime)

    x_t, y_t, xp_t, yp_t = t(x), t(y), t(xp), t(yp)
    u = torch.linspace(-0.1, 2.1, args.num_inducing, dtype=dtype, device=dev)
    ns = args.noise_std
    xtest = torch.linspace(0.05, 1.95, 200, dtype=dtype, device=dev)
    xtest_np = xtest.cpu().numpy()

    def fit_and_eval(whitened_type, xp_use, yp_use):
        """Adam on (log_sig2, log_ell) through the closed-form solve and the
        ELBO, then the posterior RMSE in both domains."""
        def loss(h):
            sig2, ell = torch.exp(h.log_sig2), torch.exp(h.log_ell)
            m, S = svgp_batch_solve(u, xp_use, yp_use, x_t, y_t, sig2, ell, nsp, ns,
                                    whitened_type=whitened_type,
                                    maxiter=args.maxiter_cg)
            e = compute_elbo(u, m, S, xp_use, yp_use, x_t, y_t, sig2, ell, nsp, ns,
                             whitened_type=whitened_type, maxiter=args.maxiter_cg)
            return -e / 1e4

        params = _Hypers(log_sig2=t(0.0), log_ell=torch.log(t(0.2)))
        opt = HyperAdam(args.lr)
        trace = []
        for i in range(args.steps):
            h = _Hypers(*(a.detach().requires_grad_() for a in
                          (params.log_sig2, params.log_ell)))
            lval = loss(h)
            g = torch.autograd.grad(lval, (h.log_sig2, h.log_ell))
            params = opt.step(params, _Hypers(*g))
            trace.append(float(lval.detach()))
            if i % 10 == 0:
                print(f"step {i:4d}: loss {trace[-1]:.6f} "
                      f"sig2 {float(torch.exp(params.log_sig2)):.4f} "
                      f"ell {float(torch.exp(params.log_ell)):.4f}", flush=True)

        sig2 = float(torch.exp(params.log_sig2))
        ell = float(torch.exp(params.log_ell))
        with torch.no_grad():
            m, S = svgp_batch_solve(u, xp_use, yp_use, x_t, y_t, sig2, ell, nsp, ns,
                                    whitened_type=whitened_type,
                                    maxiter=4 * args.maxiter_cg)
            rows = {}
            for domain, truth in (("latent", f), ("prime", fprime)):
                mu, s2 = posterior_prediction(xtest, u, m, S, sig2, ell, domain=domain,
                                              whitened_type=whitened_type,
                                              maxiter=4 * args.maxiter_cg)
                mu, s2 = mu.cpu().numpy(), s2.cpu().numpy()
                rows[f"{domain}_rmse"] = float(np.sqrt(np.mean((mu - truth(xtest_np)) ** 2)))
                rows[f"{domain}_meansig"] = float(np.mean(np.sqrt(np.maximum(s2, 0))))
        rows["sig2"] = sig2
        rows["ell"] = ell
        return rows, trace

    def exact_rmse(xp_use, yp_use, sig2, ell):
        """The exact joint GP's latent RMSE at the given hyperparameters."""
        mu, _ = exact_gp_prediction(xtest, xp_use, yp_use, x_t, y_t, sig2, ell, nsp, ns)
        return float(np.sqrt(np.mean((mu.cpu().numpy() - f(xtest_np)) ** 2)))

    if args.compare:
        records = []
        empty = (xp_t[:0], yp_t[:0])
        for wt in ("ziggy", "cholesky"):
            for use_derivs in (True, False):
                xp_use, yp_use = (xp_t, yp_t) if use_derivs else empty
                rows, _ = fit_and_eval(wt, xp_use, yp_use)
                records.append({"model": wt, "derivative_obs": use_derivs, **rows})
        for use_derivs in (True, False):
            xp_use, yp_use = (xp_t, yp_t) if use_derivs else empty
            last = [r for r in records if r["derivative_obs"] == use_derivs][0]
            records.append({"model": "exact-gp", "derivative_obs": use_derivs,
                            "latent_rmse": exact_rmse(xp_use, yp_use, last["sig2"],
                                                      last["ell"])})
        write_rows(os.path.join(args.output_dir, "derivative-comparison.csv"), records)
        for r in records:
            print(r, flush=True)
        return records

    rows, trace = fit_and_eval(args.whitened_type, xp_t, yp_t)
    rows["vs_exact_gp_rmse"] = exact_rmse(xp_t, yp_t, rows["sig2"], rows["ell"])
    write_rows(os.path.join(args.output_dir, "derivative-1d-summary.csv"), [rows])
    np.save(os.path.join(args.output_dir, "loss_trace.npy"), np.asarray(trace))
    for k, v in rows.items():
        print(f"{k:16s} {v}", flush=True)
    return rows


if __name__ == "__main__":
    main()
