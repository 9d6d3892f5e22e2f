"""Paper section 5.5: an interstellar-dust map from line-of-sight integrals.

Counterpart of `hipgp_tpu/experiments/run_domain.py`: ``--model-class``
mean-field (default), block-diagonal (blocks of ``--xblock-size`` along x
and y and ``--zblock-size`` along z, on the embedded grid) or full-rank
(the harness's, under the 'standard' parameterization: full batch only).
The observations are integrated
extinctions e(x) = ||x|| int_0^1 rho(a x) da along rays from the origin to
each star, with heteroscedastic noise; the model fits the latent 3-D density
rho on an nx x nx x nz inducing grid.  Without ``--data-path`` a synthetic
dust field (anisotropic Gaussian blobs, seed 0) is generated.

sig2 comes from the distance-slope regression (`empirical_sig2_init`).  The
fit is, as in JAX, by default the closed-form full batch
(``--fit-method full-batch``: ``HIPGP.batch_solve`` over batches of
``--batch-size`` rows with ``--mean-solver`` 'dense', 'cg', 'gram',
'factored' or 'matfree'; the paper-scale 64 x 64 x 32 grid needs 'matfree',
the only one that holds no M' x M' or M x M matrix), or the JAX experiment's
natgrad protocol (``--fit-method natgrad``: the theta2 warm start, the step
size clamped to half the estimated stability limit, then SVI).  Then e is
predicted at the test stars (integrated) and the latent density on the
central-z slice (point).  It prints and writes (with the ``csv`` module,
into ``--output-dir``) the e post-RMSE, the latent RMSE and correlation on
the slice, the ELBO trace, for natgrad rho and the lr used, and for the full
batch the seconds of each stage of the solve, its mean PCG's iterations and
relative residual and, on the card, the peak of allocated memory; the fitted
state goes to ``state.npz`` there, in the JAX package's checkpoint layout.
``--eval-only-state`` (the JAX flag) restores such a state, the JAX
package's or the port's, and skips the fit.  With a ``--data-path`` table
(which gives no true density on the slice) ``--snapshot`` names a
latte-format SPH snapshot: its dust density, deposited on the device by
``--deposit-method`` sph or cic (`dust_density.gen_dust_density`) onto
eval_grid x eval_grid x max(nz, 2) cells over the stars' box, sampled at the
slice's cells, is the slice's truth, as in the JAX package.
``--parallel dp`` fits data-parallel, one process per device (the full
batch by `parallel.dp_batch_solve`, whose mean is the dense solve whatever
``--mean-solver`` says, as in the JAX package; natgrad through `svigp_fit`
with `parallel.make_dp_data_shard_fn`); every rank generates the same data
and only rank 0 writes.  ``--parallel mp`` fits model-parallel, the whitened
state split over a (1, world) ('dp', 'grid') mesh (mean-field and block):
the full batch by `parallel.mp_batch_solve` ('gram' and 'factored' passed
on, any other mean solver solved by 'cg', as in the JAX package), natgrad by
`parallel.mp_svigp_fit`, the predictions by `parallel.mp_predict`; the state
is gathered whole (`parallel.mp_gather_state`) before rank 0 writes it.

Usage: python -m hipgp_tpu_torch.experiments.run_domain --fit-method natgrad
           --nx 64 --nz 32 --ell 0.07
       (add --device cpu --nobs 300 --nx 8 --nz 4 --max-steps 3 for a small CPU
       run; without --fit-method natgrad, --device cpu --nobs 300 --nx 8 --nz 4
       runs the dense closed-form fit)
       python -m hipgp_tpu_torch.experiments.run_domain --nobs 100000 --ntest 2000
           --nx 64 --nz 32 --mean-solver matfree --eval-grid 30 --ell 0.2
       (the paper-scale full-batch fit; add --model-class block-diagonal for
       the 2 x 2 x 2 block family)
       torchrun --nproc-per-node N -m hipgp_tpu_torch.experiments.run_domain
           --parallel dp ...
"""
from __future__ import annotations

import argparse
import csv
import os
import time

import numpy as np
import torch

from ..infer import FitConfig, batch_predict, svigp_fit
from ..models import HIPGP
from ..models.hipgp import MEAN_PCG_STATS
from ..parallel import (dp_batch_solve, make_dp_data_shard_fn, mp_batch_solve,
                        mp_gather_state, mp_predict, mp_svigp_fit, round_batch_to_mesh)
from ..parallel.mesh import axis_size
from ..utils import checkpoint, metrics
from .dust_density import gen_dust_density
from .harness import empirical_sig2_init, init_parallel, make_model
from .synthetic_data import integrated_obs

__all__ = ["main", "synthetic_dust_field", "make_synthetic_domain_data",
           "load_domain_data", "empirical_sig2_init", "domain_problem",
           "domain_model", "snapshot_truth"]

# rows per prediction chunk (the JAX harness's predict_batch_size; clamped
# by batch_predict's memory budget)
PREDICT_BATCH = 4096
# Monte-Carlo points per ray for integrated predictions without a closed
# form (the JAX FitConfig's predict_ksemi_samps)
PREDICT_KSEMI_SAMPS = 200


def load_domain_data(path: str):
    """(x (N, 3), e, e_err, density or None) from the reference's
    whitespace-separated table with named columns x y z e e_err [density]."""
    data = np.genfromtxt(path, names=True)
    x = np.column_stack([data["x"], data["y"], data["z"]])
    density = data["density"] if "density" in data.dtype.names else None
    return x, np.asarray(data["e"]), np.asarray(data["e_err"]), density


def synthetic_dust_field(seed: int = 0, nblobs: int = 6,
                         blob_min: float = 0.1, blob_max: float = 0.3):
    """Positive 3-D density: a mixture of anisotropic Gaussian blobs."""
    rs = np.random.RandomState(seed)
    centers = rs.uniform(-0.6, 0.6, (nblobs, 3))
    scales = rs.uniform(blob_min, blob_max, (nblobs, 3))
    weights = rs.uniform(0.5, 1.5, nblobs)

    def rho(pts):
        pts = np.atleast_2d(pts)
        out = np.zeros(len(pts))
        for c, s, w in zip(centers, scales, weights):
            out += w * np.exp(-0.5 * np.sum(((pts - c) / s) ** 2, axis=-1))
        return out

    return rho


def make_synthetic_domain_data(n: int, noise_std: float, seed: int = 0,
                               nblobs: int = 6, blob_min: float = 0.1,
                               blob_max: float = 0.3):
    """(x, a, e, sobs, rho): n stars in the unit cube away from the origin,
    their exact extinctions e, noisy ones a with sobs ~ U[s/2, 3s/2]."""
    rs = np.random.RandomState(seed)
    rho = synthetic_dust_field(seed, nblobs, blob_min, blob_max)
    x = rs.uniform(-1.0, 1.0, (4 * n, 3))
    x = x[np.linalg.norm(x, axis=1) > 0.15][:n]
    e = integrated_obs(x, rho)
    sobs = rs.uniform(noise_std / 2, 3 * noise_std / 2, len(x))
    a = e + sobs * rs.standard_normal(len(x))
    return x, a, e, sobs, rho


def _write_csv(path, header, rows):
    with open(path, "w", newline="") as f:
        wr = csv.writer(f)
        wr.writerow(header)
        wr.writerows(rows)


def domain_problem(nobs: int, ntest: int, noise_std: float, nx: int, nz: int,
                   nblobs: int = 6, blob_min: float = 0.1, blob_max: float = 0.3,
                   eval_grid: int = 20, data_path=None, dataset: str = "small-sim"):
    """The data, the inducing grids and the evaluation slice of the protocol:
    a dict with xobs, aobs, sobs (training), xtest, etest, the three grids
    (nx, nx, nz points spanning the stars), xgrid (the eval_grid^2 points of
    the central-z slice) and fgrid (the true density there, None for a data
    file)."""
    if data_path and os.path.exists(data_path):
        rs = np.random.RandomState(0)
        x, e, e_err, _ = load_domain_data(data_path)
        if dataset == "gaia":
            sobs, a = e_err + 0.1, e
        else:
            sobs = rs.rand(len(e)) * noise_std + noise_std / 2
            a = e + rs.randn(len(e)) * sobs
        perm = rs.permutation(len(x))
        x, a, e_true, sobs = x[perm], a[perm], e[perm], sobs[perm]
        rho = None
    else:
        x, a, e_true, sobs, rho = make_synthetic_domain_data(
            nobs + ntest, noise_std, nblobs=nblobs, blob_min=blob_min,
            blob_max=blob_max)
    ntr = len(x) - ntest
    lo, hi = x.min(axis=0), x.max(axis=0)
    grids = [np.linspace(lo[0], hi[0], nx), np.linspace(lo[1], hi[1], nx),
             np.linspace(lo[2], hi[2], nz)]
    g1 = np.linspace(lo[0] * 0.9, hi[0] * 0.9, eval_grid)
    g2 = np.linspace(lo[1] * 0.9, hi[1] * 0.9, eval_grid)
    gx, gy = np.meshgrid(g1, g2, indexing="ij")
    zmid = float((lo[2] + hi[2]) / 2)
    xgrid = np.column_stack([gx.ravel(), gy.ravel(), np.full(gx.size, zmid)])
    return dict(xobs=x[:ntr], aobs=a[:ntr], sobs=sobs[:ntr], xtest=x[ntr:],
                etest=e_true[ntr:], grids=grids, xgrid=xgrid, zmid=zmid,
                fgrid=rho(xgrid) if rho is not None else None)


def snapshot_truth(x, xgrid, zmid: float, eval_grid: int, nz: int, snapshot: str,
                   method: str = "sph", device="cuda") -> np.ndarray:
    """The slice's true density from an SPH snapshot (the JAX run_domain's
    ground truth): the snapshot deposited onto eval_grid x eval_grid x
    max(nz, 2) cells over [-max|x|, max|x|]^3, read at the cells holding the
    slice's points and z = zmid."""
    nz_slab = max(nz, 2)
    cube = gen_dust_density(x, eval_grid, eval_grid, nz_slab, snapshot_path=snapshot,
                            method=method, device=device)
    scales = np.max(np.abs(x), axis=0)

    def cell(coords, scale, n):
        return np.clip(((coords + scale) / (2 * scale) * n).astype(int), 0, n - 1)

    iz = cell(np.array([zmid]), scales[2], nz_slab)[0]
    return cube[cell(xgrid[:, 0], scales[0], eval_grid),
                cell(xgrid[:, 1], scales[1], eval_grid), iz]


def domain_model(kernel: str, grids, num_obs: int, sig2: float, ell: float,
                 dtype=torch.float32, device="cuda", model_class: str = "mean-field",
                 block_sizes=None, grid_shards=None) -> HIPGP:
    """The model of the protocol, built by the JAX harness's factory
    (`harness.make_model`: noise2_init 1, init_Svar 1, jitter 1e-3), with
    the doubly-integrated diagonal's table; ``block_sizes`` chunks the
    block family, ``grid_shards`` pads the embedding for a model-parallel
    fit."""
    return make_model(model_class, kernel, grids, num_obs=num_obs, sig2_init=sig2,
                      ell_init=ell, noise2_init=1.0, init_Svar=1.0, jitter=1e-3,
                      block_sizes=block_sizes, support_integrated_obs=True,
                      grid_shards=grid_shards, dtype=dtype, device=device)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--data-path", default=None,
                   help="reference-format table (named columns x y z e e_err "
                        "[density]); synthetic if absent")
    p.add_argument("--dataset", default="small-sim",
                   choices=["small-sim", "big-sim", "gaia"],
                   help="sim: synthetic noise added to e; gaia: real errors")
    p.add_argument("--nobs", type=int, default=5000)
    p.add_argument("--ntest", type=int, default=500)
    p.add_argument("--noise-std", type=float, default=0.1)
    p.add_argument("--nblobs", type=int, default=6)
    p.add_argument("--blob-min", type=float, default=0.1)
    p.add_argument("--blob-max", type=float, default=0.3)
    p.add_argument("--nx", type=int, default=16, help="inducing points per xy dim")
    p.add_argument("--nz", type=int, default=8, help="inducing points in z")
    p.add_argument("--model-class", default="mean-field",
                   help="mean-field | block-diagonal | full-rank")
    p.add_argument("--xblock-size", type=int, default=2,
                   help="block family: block edge along x and y")
    p.add_argument("--zblock-size", type=int, default=2,
                   help="block family: block edge along z")
    p.add_argument("--kernel", default="SqExp")
    p.add_argument("--ell", type=float, default=0.2)
    p.add_argument("--fit-method", default="full-batch", choices=["natgrad", "full-batch"])
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--max-steps", type=int, default=None,
                   help="stop after this many batch steps in all")
    p.add_argument("--batch-size", type=int, default=512)
    p.add_argument("--maxiter-cg", type=int, default=20)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--mean-solver", default="dense",
                   choices=["dense", "cg", "gram", "factored", "matfree"],
                   help="full-batch mean solve (the 64 x 64 x 32 grid needs matfree)")
    p.add_argument("--mean-solver-maxiter", type=int, default=200)
    p.add_argument("--mean-solver-tol", type=float, default=1e-8)
    p.add_argument("--eval-grid", type=int, default=20,
                   help="xy evaluation grid size on the central-z slice")
    p.add_argument("--snapshot", default=None,
                   help="latte-format npz SPH snapshot: with --data-path, the slice's "
                        "true density by deposition on the device")
    p.add_argument("--deposit-method", default="sph", choices=["sph", "cic"])
    p.add_argument("--output-dir", default="./output-domain")
    p.add_argument("--eval-only-state", default=None,
                   help="restore this state.npz and skip the fit (re-evaluation)")
    p.add_argument("--parallel", default=None, choices=["dp", "mp"],
                   help="over the ranks of torchrun's world: dp data-parallel, mp "
                        "model-parallel (the state split over a (1, world) grid)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--f64", action="store_true")
    args = p.parse_args(argv)
    mesh, writer = init_parallel(args.parallel, args.device)
    full_batch = args.fit_method == "full-batch"

    t_all = time.perf_counter()
    prob = domain_problem(args.nobs, args.ntest, args.noise_std, args.nx, args.nz,
                          args.nblobs, args.blob_min, args.blob_max, args.eval_grid,
                          args.data_path, args.dataset)
    xobs, aobs, sobs_tr = prob["xobs"], prob["aobs"], prob["sobs"]
    xtest, etest, xgrid, fgrid = prob["xtest"], prob["etest"], prob["xgrid"], prob["fgrid"]
    deposit_s = None
    if fgrid is None and args.snapshot:
        if not os.path.exists(args.snapshot):
            raise FileNotFoundError(f"--snapshot {args.snapshot} does not exist")
        t0 = time.perf_counter()
        fgrid = snapshot_truth(np.concatenate([xobs, xtest]), xgrid, prob["zmid"],
                               args.eval_grid, args.nz, args.snapshot,
                               args.deposit_method, args.device)
        deposit_s = time.perf_counter() - t0
    analytic = args.kernel == "SqExp"
    sig2 = empirical_sig2_init(xobs, aobs)
    blocks = ((args.xblock_size, args.xblock_size, args.zblock_size)
              if args.model_class.startswith("block") else None)
    mp = args.parallel == "mp"
    # 'mp' has no dense M' x M' mean: 'gram' and 'factored' pass, the rest is 'cg'
    mean_solver = ("cg" if mp and args.mean_solver not in ("gram", "factored")
                   else args.mean_solver)
    model = domain_model(args.kernel, prob["grids"], len(xobs), sig2, args.ell,
                         dtype=torch.float64 if args.f64 else torch.float32,
                         device=args.device, model_class=args.model_class,
                         block_sizes=blocks,
                         grid_shards=axis_size(mesh, "grid") if mp else None)
    cfg = FitConfig(epochs=args.epochs, batch_size=args.batch_size, lr=args.lr,
                    maxiter_cg=args.maxiter_cg, integrated_obs=True,
                    semi_integrated_estimator="analytic" if analytic else "mc-biased")
    on_card = torch.device(args.device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    timings = {}
    MEAN_PCG_STATS.update(iterations=0, resnorm=float("nan"), bnorm=float("nan"))
    t0 = time.perf_counter()
    if args.eval_only_state:
        state = checkpoint.load_pytree(args.eval_only_state, model.init_state())
        full_batch = False
        report = {"elbo_trace": [float("nan")], "steps": 0, "epoch_times": [],
                  "warmstart_s": 0.0, "natgrad_rho": None, "lr_used": None}
    elif full_batch and mp:
        state, elbo = mp_batch_solve(
            model, model.init_state(), xobs, aobs, sobs_tr, mesh,
            batch_size=args.batch_size, maxiter_cg=args.maxiter_cg, integrated_obs=True,
            semi_integrated_estimator=cfg.semi_integrated_estimator,
            semi_integrated_samps=cfg.num_semi_mc_samples, compute_elbo=True,
            mean_solver=mean_solver, mean_solver_maxiter=args.mean_solver_maxiter,
            mean_solver_tol=args.mean_solver_tol, timings=timings)
        report = {"elbo_trace": [float(elbo)], "steps": 0, "epoch_times": [],
                  "warmstart_s": 0.0, "natgrad_rho": None, "lr_used": None}
    elif full_batch and mesh is not None:
        state, elbo = dp_batch_solve(
            model, model.init_state(), xobs, aobs, sobs_tr, mesh,
            batch_size=args.batch_size, maxiter_cg=args.maxiter_cg, integrated_obs=True,
            semi_integrated_estimator=cfg.semi_integrated_estimator,
            semi_integrated_samps=cfg.num_semi_mc_samples, compute_elbo=True,
            timings=timings)
        report = {"elbo_trace": [float(elbo)], "steps": 0, "epoch_times": [],
                  "warmstart_s": 0.0, "natgrad_rho": None, "lr_used": None}
    elif full_batch:
        state, elbo = model.batch_solve(
            model.init_state(), xobs, aobs, sobs_tr, batch_size=args.batch_size,
            maxiter_cg=args.maxiter_cg, integrated_obs=True,
            semi_integrated_estimator=cfg.semi_integrated_estimator,
            semi_integrated_samps=cfg.num_semi_mc_samples, compute_elbo=True,
            mean_solver=args.mean_solver, mean_solver_maxiter=args.mean_solver_maxiter,
            mean_solver_tol=args.mean_solver_tol, timings=timings)
        report = {"elbo_trace": [float(elbo)], "steps": 0, "epoch_times": [],
                  "warmstart_s": 0.0, "natgrad_rho": None, "lr_used": None}
    elif mp:
        state, report = mp_svigp_fit(model, model.init_state(), xobs, aobs, sobs_tr, cfg,
                                     mesh, verbose=False, theta2_warmstart=True,
                                     natgrad_safe_lr="clamp", max_steps=args.max_steps)
    else:
        shard_kw = {}
        if mesh is not None:
            cfg = round_batch_to_mesh(cfg, mesh, len(xobs))
            shard_kw = {"data_shard_fn": make_dp_data_shard_fn(mesh)}
        state, report = svigp_fit(model, model.init_state(), xobs, aobs, sobs_tr, cfg,
                                  verbose=False, theta2_warmstart=True,
                                  natgrad_safe_lr="clamp", max_steps=args.max_steps,
                                  **shard_kw)
    fit_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if on_card else None

    t0 = time.perf_counter()
    ekw = dict(integrated_obs=True,
               semi_integrated_estimator="analytic" if analytic else "mc-biased",
               semi_integrated_samps=PREDICT_KSEMI_SAMPS)
    predict = mp_predict if mp else batch_predict
    where = (mesh,) if mp else ()
    emu, esig = predict(model, state, xtest, *where, batch_size=PREDICT_BATCH,
                        maxiter_cg=cfg.predict_maxiter_cg, **ekw)
    fmu, fsig = predict(model, state, xgrid, *where, batch_size=PREDICT_BATCH,
                        maxiter_cg=cfg.predict_maxiter_cg)
    if mp and not args.eval_only_state:
        state = mp_gather_state(state, mesh)
    emu, esig = emu.cpu().numpy(), esig.cpu().numpy()
    fmu, fsig = fmu.cpu().numpy(), fsig.cpu().numpy()
    predict_s = time.perf_counter() - t0

    trace = report["elbo_trace"]
    out = {
        "model_class": args.model_class,
        "fit_method": "eval-only" if args.eval_only_state else args.fit_method,
        "steps": report["steps"],
        "warmstart_s": report["warmstart_s"],
        "fit_s": fit_s,
        "step_ms": 1e3 * sum(report["epoch_times"]) / max(report["steps"], 1),
        "predict_s": predict_s,
        "natgrad_rho": report["natgrad_rho"],
        "lr_used": report["lr_used"],
        "first_elbo": trace[0],
        "last_elbo": trace[-1],
        "e_post_rmse": metrics.rmse(etest, emu),
        "e_rms": float(np.sqrt(np.mean(np.asarray(etest) ** 2))),
        "e_loglike": metrics.mean_loglike(etest, emu, esig),
        "sig2_init": sig2,
    }
    if full_batch:
        ms = MEAN_PCG_STATS
        out.update({f"fit_{k}_s": v for k, v in timings.items()})
        out["mean_pcg_iterations"] = ms["iterations"]
        out["mean_pcg_relres"] = ms["resnorm"] / ms["bnorm"]
        out["fit_peak_gb"] = None if peak is None else peak / 1e9
    if deposit_s is not None:
        out["deposit_s"] = deposit_s
    if fgrid is not None:
        out["latent_rmse"] = metrics.rmse(fgrid, fmu)
        out["latent_corr"] = metrics.correlation(fgrid, fmu)
    out["wall_s"] = time.perf_counter() - t_all
    if not writer:
        return out

    os.makedirs(args.output_dir, exist_ok=True)
    if not args.eval_only_state:
        checkpoint.save_pytree(os.path.join(args.output_dir, "state.npz"), state)
    _write_csv(os.path.join(args.output_dir, "metrics.csv"), ["metric", "value"],
               sorted(out.items()))
    _write_csv(os.path.join(args.output_dir, "elbo_trace.csv"), ["step", "elbo"],
               list(enumerate(trace)))
    lat = (f"; latent RMSE {out['latent_rmse']:.5f}, slice corr "
           f"{out['latent_corr']:.4f}" if fgrid is not None else "")
    if deposit_s is not None:
        lat += f" (truth: {args.deposit_method} deposition, {deposit_s:.2f} s)"
    stages = ", ".join(f"{k} {v:.3f}" for k, v in timings.items())
    pcg = (f", mean PCG {out['mean_pcg_iterations']} iterations to ||r||/||b_m|| "
           f"{out['mean_pcg_relres']:.3e}" if full_batch and out["mean_pcg_iterations"]
           else "")
    mem = f", peak {out['fit_peak_gb']:.3f} GB" if full_batch and on_card else ""
    fit = (f"full batch ({mean_solver}) in {fit_s:.2f} s ({stages}{pcg}{mem}), "
           f"ELBO {out['last_elbo']:.4f}" if full_batch else
           f"the state of {args.eval_only_state}" if args.eval_only_state else
           f"rho {out['natgrad_rho']:.1f}, lr used {out['lr_used']:.3g}; "
           f"{out['steps']} steps at {out['step_ms']:.1f} ms (warm start "
           f"{out['warmstart_s']:.2f} s), ELBO {out['first_elbo']:.4f} -> "
           f"{out['last_elbo']:.4f}")
    fam = (f"{args.model_class} (blocks {model.block_sizes}, {model.num_blocks} of "
           f"{model.block_size})" if model.family == "block" else args.model_class)
    print(f"device {args.device}: {fam}, grid {model.dims} -> embedded {model.edims}, {fit}; "
          f"e post-RMSE {out['e_post_rmse']:.5f} (rms(e_test) {out['e_rms']:.5f}){lat}; "
          f"predict {predict_s:.2f} s", flush=True)
    return out


if __name__ == "__main__":
    main()
