"""Self-contained 1-D fit-and-plot demo on the port.

Counterpart of `hipgp_tpu/experiments/demo_1d.py` (the reference's
`ziggy/svgp.py` demo): a 1-D function observed with noise, fit in closed
form by the dense whitened SVGP and by the mean-field HIP-GP on a 1-D
inducing grid.  `fit` returns the predictions and their test RMSE and runs
anywhere; `plot` draws the comparison figure and needs matplotlib (imported
there), which the card's machine lacks.

Usage: python -m hipgp_tpu_torch.experiments.demo_1d [--n 500] [--out demo1d.png]
       (add --device cpu for a CPU run; --no-plot to skip the figure)
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

__all__ = ["main", "fit", "plot", "truth"]


def truth(t):
    return np.sin(6 * t) * np.exp(-0.5 * t) + 0.5 * np.cos(12 * t)


def fit(n: int = 500, num_inducing: int = 50, noise_std: float = 0.2, seed: int = 0,
        dtype=torch.float32, device="cuda"):
    """Fit both models to the demo's data: (results, data), ``results`` a
    dict name -> (mu, sig, rmse) on the 300 test points (numpy), ``data``
    the dict of x, y and xt."""
    from ..kernels import SqExp
    from ..models import HIPGP, SVGP

    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0, 2, n))
    y = truth(x) + noise_std * rng.standard_normal(n)
    s = np.full(n, noise_std)
    xt = np.linspace(0, 2, 300)
    t = lambda a: torch.as_tensor(a).to(dtype=dtype, device=device)
    grid = torch.linspace(-0.1, 2.1, num_inducing, dtype=dtype)

    preds = {}
    svgp = SVGP(SqExp(), grid[:, None], num_obs=n, whitened=True, sig2_init=1.0,
                ell_init=0.15, jitter=1e-5, dtype=dtype, device=device)
    st = svgp.batch_solve(svgp.init_state(), t(x)[:, None], t(y), t(s))
    preds["SVGP (dense)"] = svgp.predict(st, t(xt)[:, None])

    hip = HIPGP(SqExp(), [grid], num_obs=n, family="mean-field", whitened_type="ziggy",
                sig2_init=1.0, ell_init=0.15, noise2_init=noise_std ** 2, jitter=1e-5,
                dtype=dtype, device=device)
    sth = hip.batch_solve(hip.init_state(), t(x)[:, None], t(y), t(s), maxiter_cg=100)
    with torch.no_grad():
        preds["HIP-GP (mean-field)"] = hip.predict(sth, t(xt)[:, None], maxiter_cg=100)

    results = {}
    for name, (mu, sig) in preds.items():
        mu, sig = mu.detach().cpu().numpy(), sig.detach().cpu().numpy()
        rmse = float(np.sqrt(np.mean((mu - truth(xt)) ** 2)))
        results[name] = (mu, sig, rmse)
        print(f"{name}: test rmse {rmse:.4f}", flush=True)
    return results, {"x": x, "y": y, "xt": xt}


def plot(results, data, out: str) -> str:
    """The comparison figure: observations, truth, and each model's mean
    with a two-sigma band, saved to ``out``."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    x, y, xt = data["x"], data["y"], data["xt"]
    fig, ax = plt.subplots(figsize=(10, 5))
    ax.scatter(x, y, s=4, c="grey", alpha=0.4, label="observations")
    ax.plot(xt, truth(xt), "k--", lw=1.5, label="truth")
    for name, (mu, sig, _) in results.items():
        (line,) = ax.plot(xt, mu, lw=1.5, label=name)
        ax.fill_between(xt, mu - 2 * sig, mu + 2 * sig, alpha=0.15, color=line.get_color())
    ax.legend()
    fig.savefig(out, bbox_inches="tight")
    plt.close(fig)
    print(f"wrote {out}", flush=True)
    return out


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=500)
    p.add_argument("--num-inducing", type=int, default=50)
    p.add_argument("--noise-std", type=float, default=0.2)
    p.add_argument("--out", default="demo1d.png")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--f64", action="store_true")
    p.add_argument("--device", default="cuda")
    p.add_argument("--no-plot", action="store_true")
    args = p.parse_args(argv)
    results, data = fit(args.n, args.num_inducing, args.noise_std, args.seed,
                        torch.float64 if args.f64 else torch.float32, args.device)
    if not args.no_plot:
        plot(results, data, args.out)
    return results


if __name__ == "__main__":
    main()
