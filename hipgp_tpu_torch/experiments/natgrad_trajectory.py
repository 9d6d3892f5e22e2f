"""Natgrad ELBO/RMSE trajectory parity against the live reference, on the port.

Counterpart of `hipgp_tpu/experiments/natgrad_trajectory.py`: the
reference's own natural-gradient settings (SGD lr 1e-2, batch 200,
shuffle off, optional per-batch StepLR 0.99, maxiter_cg 20, cold
expectation-family init) on the same synthetic data with the same theta1
draw (a numpy draw shared by every leg), run as these legs:

  * ``ref``        the live ziggy ``MeanFieldToeplitzGP`` under the
                   `ziggy/svi_gp.py:282-388` loop, through `ref_compat`'s
                   shims (float64, CPU; needs the reference checkout);
  * ``torch``      the port's `svigp_fit` on ``--device``;
  * ``chol``       the same with the cholesky whitening (exact kn, no
                   truncated PCG), the truncation-free control;
  * ``solve``      the closed-form mean-field optimum at the same hypers;
  * ``ref-svgp``   the live reference's dense SVGP (whitened, float64);
  * ``torch-svgp`` the port's `SVGP` through `svigp_fit`, mirroring the
                   reference's two quirks as the JAX leg does: the learning
                   rate times 1000/N (the reference rescales its natural
                   gradient so) and the ELBO shifted by the Gaussian
                   normaliser it omits;
  * ``compare``    ``ref`` against ``torch`` and ``chol``, ``ref-svgp``
                   against ``torch-svgp``: per-epoch deviations into
                   ``compare.json``.

Each leg writes ``<leg>.csv`` (per epoch: the mean batch ELBO, the test
RMSE, seconds, coverage) into ``--output-dir``.  The port's legs run in
float64 at the reduced scale (N = 2 000, M = 16^2) and in float32 at
``--paper`` (N = 20 000, M = 125^2, where the ref legs and compare are
dropped); the SVGP leg runs in float64 always, as the reference asserts.

Usage: python -m hipgp_tpu_torch.experiments.natgrad_trajectory --modes torch chol solve torch-svgp
       (add --device cpu for a CPU run)
"""
from __future__ import annotations

import argparse
import csv
import json
import math
import os
import time

import numpy as np
import torch

from .synthetic_data import make_two_dim_data

__all__ = ["main", "run_ref", "run_torch", "run_solve", "run_ref_svgp",
           "run_torch_svgp", "compare"]

_COV_SIGS = (0.5, 1.0, 2.0, 3.0)


def _theta1_init(mprime: int, seed: int) -> np.ndarray:
    """The shared xavier_normal_((M', 1)) draw: std sqrt(2/(M' + 1))."""
    rng = np.random.default_rng(seed)
    return math.sqrt(2.0 / (mprime + 1)) * rng.standard_normal(mprime)


def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _rmse(a, b):
    return float(np.sqrt(np.mean((_np(a).reshape(-1) - _np(b).reshape(-1)) ** 2)))


def _coverage_cols(mu, sig, ftruth):
    """{cov0.5, cov1, cov2, cov3}: the fraction of test points with
    |f_true - mu| < s sig (the reference's zscore_to_coverage_vec)."""
    z = (_np(ftruth).reshape(-1) - _np(mu).reshape(-1)) / _np(sig).reshape(-1)
    return {f"cov{s:g}": float(np.mean(np.abs(z) < s)) for s in _COV_SIGS}


def _dtype(args):
    return torch.float32 if args.paper else torch.float64


def _grids(args, dtype):
    return [torch.linspace(-1.0, 1.0, args.m1, dtype=dtype)] * 2


def run_ref(data, args):
    """The live reference's natgrad under `ziggy/svi_gp.py:282-388`'s loop
    (SGD on theta, per-batch StepLR, shuffle off, cold init; Adam on the
    kernel hypers before the SGD step with ``learn_kernel``)."""
    from .ref_compat import import_ziggy

    import_ziggy()
    from ziggy import kernels as zk
    from ziggy.hipgp import BlockToeplitzGP, FullRankToeplitzGP, MeanFieldToeplitzGP

    torch.manual_seed(args.seed)
    grids = [torch.linspace(-1.0, 1.0, args.m1, dtype=torch.double) for _ in range(2)]
    kw = dict(num_obs=args.nobs, sig2_init=args.sig2, ell_init=args.ell,
              noise2_init=args.noise ** 2, learn_kernel=args.learn_kernel,
              learn_noise=False, dtype=torch.double)
    fam = getattr(args, "family", "mean-field")
    if fam == "mean-field":
        mod = MeanFieldToeplitzGP(zk.SqExp(), grids, **kw)
    elif fam == "block":
        mod = BlockToeplitzGP(zk.SqExp(), grids, xblock_size=args.xblock_size, **kw)
    else:
        mod = FullRankToeplitzGP(zk.SqExp(), grids, **kw)
    if fam != "full-rank":  # full-rank initializes theta1 = zeros
        mod.global_theta1.data[:] = torch.tensor(
            _theta1_init(mod.Mprime, args.seed), dtype=torch.double)[:, None]

    x = torch.tensor(data["xobs"], dtype=torch.double)
    y = torch.tensor(data["yobs"], dtype=torch.double)[:, None]
    s = torch.tensor(data["sobs"], dtype=torch.double)[:, None]
    xt = torch.tensor(data["xtest"], dtype=torch.double)
    opt = torch.optim.SGD([mod.global_theta1, mod.global_theta2], lr=args.lr)
    hopt = (torch.optim.Adam([mod.log_ell, mod.log_sig2], lr=args.kernel_lr)
            if args.learn_kernel else None)
    sched = (torch.optim.lr_scheduler.StepLR(opt, step_size=1, gamma=args.step_decay)
             if args.schedule_lr else None)
    nb = -(-args.nobs // args.batch_size)
    rows = []
    for epoch in range(args.epochs):
        t0 = time.time()
        elbos = []
        for b in range(nb):
            sl = slice(b * args.batch_size, min((b + 1) * args.batch_size, args.nobs))
            opt.zero_grad()
            if hopt is not None:
                hopt.zero_grad()
            lval = mod.elbo_and_grad(xbatch=x[sl], ybatch=y[sl], noise_std_batch=s[sl],
                                     maxiter_cg=args.maxiter_cg)
            if hopt is not None:
                (-lval).backward()
                hopt.step()
            opt.step()
            if sched is not None:
                sched.step()
            elbos.append(float(lval))
        with torch.no_grad():
            mu, sig = mod.predict(xt, maxiter_cg=args.predict_maxiter_cg)
        row = {"epoch": epoch, "elbo": float(np.mean(elbos)),
               "rmse": _rmse(mu.squeeze(-1), data["ftest"]), "secs": time.time() - t0,
               **_coverage_cols(mu.squeeze(-1), sig.squeeze(-1), data["ftest"])}
        if args.learn_kernel:
            row["sig2"] = float(torch.exp(mod.log_sig2))
            row["ell"] = float(torch.exp(mod.log_ell))
        rows.append(row)
        print("ref", rows[-1], flush=True)
    return rows


def run_torch(data, args, whitened_type="ziggy", tag="torch"):
    """The same protocol through the port's `svigp_fit` (``whitened_type``
    'cholesky' for the ``chol`` control) on ``args.device``."""
    from ..infer.fit import FitConfig, batch_predict, svigp_fit
    from ..kernels import SqExp
    from ..models.hipgp import HIPGP

    dt, dev = _dtype(args), torch.device(args.device)
    fam = getattr(args, "family", "mean-field")
    model = HIPGP(SqExp(), _grids(args, dt), num_obs=args.nobs, family=fam,
                  xblock_size=args.xblock_size, whitened_type=whitened_type,
                  sig2_init=args.sig2, ell_init=args.ell, noise2_init=args.noise ** 2,
                  dtype=dt, device=dev)
    state = model.init_state()
    if fam != "full-rank":  # full-rank initializes theta1 = zeros
        state = state.replace(theta1=torch.as_tensor(
            _theta1_init(model.Mprime, args.seed)).to(dtype=dt, device=dev))
    t = lambda a: torch.as_tensor(a).to(dtype=dt, device=dev)
    xt = t(data["xtest"])
    cfg = FitConfig(epochs=args.epochs, batch_size=args.batch_size, lr=args.lr,
                    schedule_lr=args.schedule_lr, step_decay=args.step_decay,
                    maxiter_cg=args.maxiter_cg, shuffle=False, seed=args.seed,
                    learn_kernel=args.learn_kernel, kernel_lr=args.kernel_lr,
                    epoch_log_interval=0)
    rows = []
    nb = -(-args.nobs // args.batch_size)

    def cb(epoch, model_, state_, trace):
        t0 = time.time()
        mu, sig = batch_predict(model_, state_, xt, maxiter_cg=args.predict_maxiter_cg)
        row = {"epoch": epoch, "elbo": float(np.mean(trace[-nb:])),
               "rmse": _rmse(mu, data["ftest"]), "secs": time.time() - t0,
               **_coverage_cols(mu, sig, data["ftest"])}
        if args.learn_kernel:
            row["sig2"] = float(torch.exp(state_.log_sig2))
            row["ell"] = float(torch.exp(state_.log_ell.reshape(-1)[0]))
        rows.append(row)
        print(tag, rows[-1], flush=True)

    _, rep = svigp_fit(model, state, t(data["xobs"]), t(data["yobs"]), t(data["sobs"]),
                       cfg, epoch_callback=cb, verbose=False,
                       theta2_warmstart=args.warmstart,
                       natgrad_safe_lr=getattr(args, "safe_lr", "warn"))
    if rep.get("natgrad_rho") is not None:
        print(f"{tag} natgrad rho={rep['natgrad_rho']:.1f} "
              f"lr_crit={rep['natgrad_lr_crit']:.3g} lr_used={rep['lr_used']:.3g}",
              flush=True)
    return rows


def _induce_grid(m1):
    g = np.linspace(-1.0, 1.0, m1)
    xx, yy = np.meshgrid(g, g, indexing="ij")
    return np.stack([xx.reshape(-1), yy.reshape(-1)], axis=-1)


def run_ref_svgp(data, args):
    """The live reference's dense SVGP natgrad (`ziggy/svgp.py`, float64,
    whitened: its unwhitened kn path calls ``.cuda()``) under the same
    loop."""
    from .ref_compat import import_ziggy

    import_ziggy()
    from ziggy import kernels as zk
    from ziggy.svgp import SVGP as RefSVGP

    torch.manual_seed(args.seed)
    xind = torch.tensor(_induce_grid(args.m1), dtype=torch.double)
    mod = RefSVGP(zk.SqExp(), xind, num_obs=args.nobs, sig2_init=args.sig2,
                  ell_init=args.ell, learn_kernel=False, whitened=True,
                  dtype=torch.double)
    # the reference's elbo_and_grad calls _make_kn_vectors(Knm) bare and
    # unpacks (kn, Kmm), though its default is return_Kmm=False
    # (`ziggy/svgp.py:297`): only the bare call gets the tuple
    orig_mkv = mod._make_kn_vectors

    def _mkv(Knm, Kmm=None, return_Kmm=None):
        if return_Kmm is None:
            return orig_mkv(Knm, Kmm=Kmm, return_Kmm=True)
        return orig_mkv(Knm, Kmm=Kmm, return_Kmm=return_Kmm)

    mod._make_kn_vectors = _mkv
    x = torch.tensor(data["xobs"], dtype=torch.double)
    y = torch.tensor(data["yobs"], dtype=torch.double)[:, None]
    s = torch.tensor(data["sobs"], dtype=torch.double)[:, None]
    xt = torch.tensor(data["xtest"], dtype=torch.double)
    opt = torch.optim.SGD([mod.global_theta1, mod.global_theta2], lr=args.lr)
    sched = (torch.optim.lr_scheduler.StepLR(opt, step_size=1, gamma=args.step_decay)
             if args.schedule_lr else None)
    nb = -(-args.nobs // args.batch_size)
    rows = []
    for epoch in range(args.epochs):
        t0 = time.time()
        elbos = []
        for b in range(nb):
            sl = slice(b * args.batch_size, min((b + 1) * args.batch_size, args.nobs))
            opt.zero_grad()
            lval = mod.elbo_and_grad(x[sl], y[sl], s[sl])
            opt.step()
            if sched is not None:
                sched.step()
            elbos.append(float(lval))
        with torch.no_grad():
            mu, _ = mod.predict(xt)
        rows.append({"epoch": epoch, "elbo": float(np.mean(elbos)),
                     "rmse": _rmse(mu.squeeze(-1), data["ftest"]),
                     "secs": time.time() - t0})
        print("ref-svgp", rows[-1], flush=True)
    return rows


def run_torch_svgp(data, args):
    """The dense-SVGP protocol through the port's `svigp_fit` in float64 on
    ``args.device``, with the reference's 1000/N natural-gradient rescale
    as a learning-rate factor and its ELBO convention (no Gaussian
    normaliser in the data term)."""
    from ..infer.fit import FitConfig, batch_predict, svigp_fit
    from ..kernels import SqExp
    from ..models.svgp import SVGP

    dt, dev = torch.float64, torch.device(args.device)
    model = SVGP(SqExp(), torch.as_tensor(_induce_grid(args.m1), dtype=dt),
                 num_obs=args.nobs, sig2_init=args.sig2, ell_init=args.ell,
                 whitened=True, dtype=dt, device=dev)
    normalizer = float(np.mean(np.log(data["sobs"])) + 0.5 * np.log(2 * np.pi))
    cfg = FitConfig(epochs=args.epochs, batch_size=args.batch_size,
                    lr=args.lr * 1000.0 / args.nobs, schedule_lr=args.schedule_lr,
                    step_decay=args.step_decay, maxiter_cg=args.maxiter_cg,
                    shuffle=False, seed=args.seed, epoch_log_interval=0)
    t = lambda a: torch.as_tensor(a).to(dtype=dt, device=dev)
    xt = t(data["xtest"])
    nb = -(-args.nobs // args.batch_size)
    rows = []

    def cb(epoch, model_, state_, trace):
        t0 = time.time()
        mu, _ = batch_predict(model_, state_, xt)
        rows.append({"epoch": epoch, "elbo": float(np.mean(trace[-nb:])) + normalizer,
                     "rmse": _rmse(mu, data["ftest"]), "secs": time.time() - t0})
        print("torch-svgp", rows[-1], flush=True)

    svigp_fit(model, model.init_state(), t(data["xobs"]), t(data["yobs"]),
              t(data["sobs"]), cfg, epoch_callback=cb, verbose=False)
    return rows


def run_solve(data, args):
    """The closed-form mean-field optimum at the same hypers, the natgrad
    trajectory's asymptote ('gram' at --paper, 'dense' otherwise)."""
    from ..infer.fit import batch_predict
    from ..kernels import SqExp
    from ..models.hipgp import HIPGP

    dt, dev = _dtype(args), torch.device(args.device)
    t = lambda a: torch.as_tensor(a).to(dtype=dt, device=dev)
    model = HIPGP(SqExp(), _grids(args, dt), num_obs=args.nobs, family="mean-field",
                  sig2_init=args.sig2, ell_init=args.ell, noise2_init=args.noise ** 2,
                  dtype=dt, device=dev)
    t0 = time.time()
    new = model.batch_solve(model.init_state(), t(data["xobs"]), t(data["yobs"]),
                            t(data["sobs"]), batch_size=5000, maxiter_cg=args.maxiter_cg,
                            mean_solver="gram" if args.paper else "dense")
    with torch.no_grad():
        mu, sig = batch_predict(model, new, t(data["xtest"]), batch_size=1000,
                                maxiter_cg=args.predict_maxiter_cg)
    row = {"epoch": -1, "elbo": float("nan"), "rmse": _rmse(mu, data["ftest"]),
           "secs": time.time() - t0, **_coverage_cols(mu, sig, data["ftest"])}
    print("solve", row, flush=True)
    return [row]


def _write(rows, path):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
        w.writeheader()
        w.writerows(rows)
    print("wrote", path, flush=True)


def _read(path):
    with open(path) as f:
        return [{k: float(v) for k, v in r.items()} for r in csv.DictReader(f)]


def compare(args):
    """Per-epoch deviations of each port leg from its reference leg, into
    ``compare.json``; returns them."""
    out = {}
    pairs = [("ref.csv", ("torch", "chol"))]
    if os.path.exists(os.path.join(args.output_dir, "ref-svgp.csv")):
        pairs.append(("ref-svgp.csv", ("torch-svgp",)))
    for refname, tags in pairs:
        _compare_one(args, out, refname, tags)
    with open(os.path.join(args.output_dir, "compare.json"), "w") as f:
        json.dump(out, f, indent=1)
    return out


def _compare_one(args, out, refname, tags):
    refpath = os.path.join(args.output_dir, refname)
    if not os.path.exists(refpath):
        return
    ref = _read(refpath)
    for tag in tags:
        p = os.path.join(args.output_dir, f"{tag}.csv")
        if not os.path.exists(p):
            continue
        got = _read(p)
        n = min(len(ref), len(got))
        dev = lambda k: max(abs(ref[i][k] - got[i][k]) for i in range(n))
        out[tag] = {"epochs": n, "max_abs_elbo_dev": dev("elbo"),
                    "max_abs_rmse_dev": dev("rmse"),
                    "final_elbo": (ref[n - 1]["elbo"], got[n - 1]["elbo"]),
                    "final_rmse": (ref[n - 1]["rmse"], got[n - 1]["rmse"])}
        if "cov1" in ref[0] and "cov1" in got[0]:
            for s in _COV_SIGS:
                c = f"cov{s:g}"
                out[tag][f"max_abs_{c}_dev"] = dev(c)
                out[tag][f"final_{c}"] = (ref[n - 1][c], got[n - 1][c])
        if "ell" in ref[0] and "ell" in got[0]:
            out[tag]["max_abs_ell_dev"] = dev("ell")
            out[tag]["max_abs_sig2_dev"] = dev("sig2")
            out[tag]["final_ell"] = (ref[n - 1]["ell"], got[n - 1]["ell"])
            out[tag]["final_sig2"] = (ref[n - 1]["sig2"], got[n - 1]["sig2"])
        print(tag, json.dumps(out[tag], indent=1), flush=True)


LEGS = ("ref", "torch", "chol", "solve", "ref-svgp", "torch-svgp", "compare")


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--modes", nargs="+", default=["ref", "torch", "chol", "compare"],
                   choices=list(LEGS))
    p.add_argument("--nobs", type=int, default=2000)
    p.add_argument("--ntest", type=int, default=1000)
    p.add_argument("--m1", type=int, default=16)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--batch-size", type=int, default=200)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--schedule-lr", action="store_true")
    p.add_argument("--step-decay", type=float, default=0.99)
    p.add_argument("--maxiter-cg", type=int, default=20)
    p.add_argument("--predict-maxiter-cg", type=int, default=50)
    p.add_argument("--learn-kernel", action="store_true")
    p.add_argument("--kernel-lr", type=float, default=1e-3)
    p.add_argument("--family", default="mean-field",
                   choices=["mean-field", "block", "full-rank"])
    p.add_argument("--xblock-size", type=int, default=5)
    p.add_argument("--ell", type=float, default=0.2)
    p.add_argument("--sig2", type=float, default=None,
                   help="default: var(y) - noise^2, the reference's rule")
    p.add_argument("--noise", type=float, default=0.1)
    p.add_argument("--gridnum", type=int, default=50)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--warmstart", action="store_true",
                   help="theta2 warm start (the port's legs; beyond the reference)")
    p.add_argument("--safe-lr", default="warn", choices=["warn", "clamp", "off"],
                   help="natgrad stability policy (svigp_fit natgrad_safe_lr; "
                        "needs --warmstart)")
    p.add_argument("--paper", action="store_true",
                   help="N = 20 000, M = 125^2, float32 (the port's legs only)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--output-dir", default="./output-natgrad-trajectory")
    args = p.parse_args(argv)
    if args.paper:
        args.nobs, args.m1 = 20000, 125
        args.modes = [m for m in args.modes if m not in ("ref", "compare")]
    return args


def main(argv=None):
    args = parse_args(argv)
    data = make_two_dim_data(Nobs=args.nobs, Ntest=args.ntest, noise_std=args.noise,
                             gridnum=args.gridnum, seed=args.seed)
    if args.sig2 is None:
        args.sig2 = float(np.var(data["yobs"]) - args.noise ** 2)
        print(f"sig2 from data: {args.sig2:.4f}", flush=True)
    out = {}
    runs = (("ref", lambda: run_ref(data, args)),
            ("torch", lambda: run_torch(data, args, "ziggy", "torch")),
            ("solve", lambda: run_solve(data, args)),
            ("ref-svgp", lambda: run_ref_svgp(data, args)),
            ("torch-svgp", lambda: run_torch_svgp(data, args)),
            ("chol", lambda: run_torch(data, args, "cholesky", "chol")))
    for leg, run in runs:
        if leg in args.modes:
            out[leg] = run()
            _write(out[leg], os.path.join(args.output_dir, f"{leg}.csv"))
    if "compare" in args.modes:
        out["compare"] = compare(args)
    return out


if __name__ == "__main__":
    main()
