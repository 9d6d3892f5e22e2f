"""Experiment harness: fit, predict, evaluate and save one run.

Counterpart of `hipgp_tpu/experiments/harness.py` on one device:
`make_model` builds the model of a model class (the HIP-GP mean-field,
block-diagonal with ``block_sizes``, or full-rank with the 'standard'
parameterization, ziggy or cholesky whitening; or the dense unwhitened
SVGP over the mesh of the grids, as the JAX harness builds them),
`fit_predict_and_save` fits it by natural-gradient SVI or the closed-form
``batch_solve`` and `evaluate_and_save` predicts and writes the JAX
harness's artifacts under ``output_dir/name`` in its layout: ``state.npz``
(+ sidecar) and ``meta.json``, ``elbo_trace.npy`` and the hyperparameter
traces, ``predictions.npz``, ``errordf-summary.csv``,
``noise_reduction.csv``, ``coverage_table.csv``, ``fit_params.json``,
``time_report.csv`` and the figures of `viz.py` (``elbo.jpg``,
``f-zscore-histogram.pdf``, ``qq.pdf``, ``posterior-grid.jpg`` and
``comparison-grid.jpg`` with ``grid_shape``, the dust map's scatters).  The
CSVs are written with the ``csv`` module, column for column as the JAX
harness's pandas frames write them.  ``make_plots=None`` (the default)
draws the figures where matplotlib imports and otherwise prints
"figures skipped: matplotlib is not installed" and carries on (the card's
machine has no matplotlib); ``make_plots=True`` without it raises
ImportError.

``parallel='dp'`` fits data-parallel over ``mesh`` (default: every rank of
the world on 'dp'; a world of one process when none was started): natgrad
through `svigp_fit` with `parallel.round_batch_to_mesh` and
`parallel.make_dp_data_shard_fn`, full batch through
`parallel.dp_batch_solve`.  Every rank returns the same state and report;
only the coordinator (`multihost.on_coordinator`) writes the artifacts.
``parallel='mp'`` fits model-parallel (mean-field and block) over
``mesh`` (default: a (1, world) ('dp', 'grid') mesh), the model built with
``grid_shards`` from the mesh's grid axis: natgrad through
`parallel.mp_svigp_fit`, full batch through `parallel.mp_batch_solve` ('gram'
and 'factored' passed on, any other mean solver solved by 'cg', as the JAX
harness routes them), evaluation through `parallel.mp_predict`
(`evaluate_and_save`'s ``predict_fn``); every rank gathers the state whole
(`parallel.mp_gather_state`) and only the coordinator writes it.
``grid_shards`` pads the model's circulant embedding as the JAX harness
does.  ``eval_only_state`` (the JAX harness's crash recovery) restores a
saved state instead of fitting (`restore_eval_state`) and evaluates it on
any of these paths.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
import warnings
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..infer import FitConfig, batch_predict, svigp_fit
from ..kernels import kernel_from_name
from .. import viz
from ..models import HIPGP, SVGP
from ..utils import checkpoint as ckpt
from ..utils import metrics

__all__ = ["fit_predict_and_save", "make_model", "evaluate_and_save",
           "empirical_sig2_init", "init_parallel", "restore_eval_state"]


def make_model(model_class: str, kernel_name: str, xinduce_grids: Sequence,
               num_obs: int, sig2_init: float, ell_init: float,
               noise2_init: float = 1.0, init_Svar: float = 1.0,
               whitened_type: str = "ziggy", learn_kernel: bool = False,
               learn_noise: bool = False, jitter: float = 1e-3,
               block_sizes: Optional[Sequence[int]] = None,
               support_integrated_obs: bool = False,
               grid_shards: Optional[int] = None, dtype=torch.float32,
               device="cuda"):
    """The JAX harness's model factory: ``model_class`` 'mean-field',
    'block-diagonal[-*]' or 'block' (chunked by ``block_sizes``),
    'full-rank' (under the 'standard' parameterization, as the reference
    builds it: its natgrad fit raises ValueError, it fits by the closed
    form) or 'SVGP' (the dense unwhitened SVGP with the mesh of the grids as
    its inducing points).  ``grid_shards`` pads a HIP-GP's embedding
    (`HIPGP`)."""
    if model_class == "SVGP":
        grids = [torch.as_tensor(np.asarray(g)).to(dtype) for g in xinduce_grids]
        mesh = torch.meshgrid(*grids, indexing="ij")
        xinduce = torch.stack([m.reshape(-1) for m in mesh], dim=-1)
        return SVGP(kernel_from_name(kernel_name), xinduce, num_obs=num_obs,
                    whitened=False, sig2_init=sig2_init, ell_init=ell_init,
                    init_Svar=init_Svar, jitter=jitter,
                    support_integrated_obs=support_integrated_obs, dtype=dtype,
                    device=device)
    common = dict(num_obs=num_obs, whitened_type=whitened_type, sig2_init=sig2_init,
                  ell_init=ell_init, noise2_init=noise2_init, init_Svar=init_Svar,
                  learn_kernel=learn_kernel, learn_noise=learn_noise, jitter=jitter,
                  support_integrated_obs=support_integrated_obs,
                  grid_shards=grid_shards, dtype=dtype, device=device)
    kern = kernel_from_name(kernel_name)
    if model_class == "mean-field":
        return HIPGP(kern, xinduce_grids, family="mean-field", **common)
    if model_class.startswith("block-diagonal") or model_class == "block":
        return HIPGP(kern, xinduce_grids, family="block", block_sizes=block_sizes,
                     **common)
    if model_class == "full-rank":
        return HIPGP(kern, xinduce_grids, family="full-rank",
                     parameterization="standard", **common)
    raise ValueError(f"model_class={model_class!r}; choose mean-field | "
                     "block-diagonal | full-rank | SVGP")


def init_parallel(parallel: Optional[str], device="cuda"):
    """The world of a ``parallel`` run: (mesh, writer).  'dp' and 'mp' join
    torchrun's world (`multihost.initialize`; a world of one process, said
    so, without torchrun's environment) and return the mesh, every rank on
    'dp' or, for 'mp', JAX's default (1, world) ('dp', 'grid') mesh, and
    whether this rank is the coordinator, the one that writes; None returns
    (None, True)."""
    if parallel not in (None, "dp", "mp"):
        raise ValueError(f"parallel={parallel!r}; choose None | 'dp' | 'mp'")
    if parallel is None:
        return None, True
    import torch.distributed as dist

    from ..parallel import make_mesh, multihost

    multihost.initialize(device=device)
    if parallel == "mp":
        mesh = make_mesh(axis_names=("dp", "grid"), shape=(1, dist.get_world_size()))
    else:
        mesh = make_mesh()
    return mesh, multihost.on_coordinator()


def restore_eval_state(model, path: str, parallel: Optional[str] = None, mesh=None):
    """The state saved at ``path`` (by either package: a whole state, as
    every path writes it) with the dtypes and device of ``model``, for an
    evaluation without a fit.  Each leaf must have the model's shape, else
    ValueError names the file and both shapes.  Under ``parallel='mp'`` the
    whole state is cut into this rank's block of ``mesh``
    (`parallel.mp_shard_state`), the state a split fit returns."""
    like = model.init_state()
    state = ckpt.load_pytree(path, like)
    for f in dataclasses.fields(like):
        got, want = tuple(getattr(state, f.name).shape), tuple(getattr(like, f.name).shape)
        if got != want:
            raise ValueError(f"{path}: leaf {f.name} has shape {got}, the model's "
                             f"has {want}")
    if parallel == "mp":
        from ..parallel import mp_shard_state

        state = mp_shard_state(state, mesh)
    return state


def empirical_sig2_init(xobs: np.ndarray, yobs: np.ndarray) -> float:
    """Distance-slope regression init of the marginal variance, clamped to
    [1e-3, 1e2] var(y) (falling back to var(y) with a warning)."""
    dobs = np.sqrt(np.sum(np.asarray(xobs) ** 2, axis=-1))
    y = np.asarray(yobs).reshape(-1, 1)
    slope, *_ = np.linalg.lstsq(dobs[:, None], y, rcond=None)
    sig2 = float(slope[0, 0] ** 2)
    vy = float(np.var(np.asarray(yobs)))
    if not (1e-3 * vy <= sig2 <= 1e2 * vy):
        fallback = vy if vy > 0 else 1.0
        warnings.warn(
            f"empirical sig2 init {sig2:.3e} is degenerate relative to "
            f"var(y) = {vy:.3e}; falling back to var(y) = {fallback:.3e} — "
            "pass an explicit sig2_init to override", RuntimeWarning)
        return float(fallback)
    return sig2


def _predict_all(model, state, xtest, ftest, etest, xvalid, fvalid, evalid, xgrid, fgrid,
                 egrid, integrated, maxiter_cg, ksemi_method, ksemi_samps, batch_size,
                 predict_fn=None):
    """The predictions on valid/test/grid (latent and, with ``integrated``,
    integrated) and their seconds: (pdict, eval_times)."""
    pdict: Dict[str, np.ndarray] = {}
    times: Dict[str, float] = {}

    def _predict(x, integrated_obs=False):
        if predict_fn is not None:
            return predict_fn(x, integrated_obs=integrated_obs)
        kw = {}
        if integrated_obs:
            kw = dict(integrated_obs=True, semi_integrated_estimator=ksemi_method,
                      semi_integrated_samps=ksemi_samps)
        return batch_predict(model, state, x, batch_size=batch_size,
                             maxiter_cg=maxiter_cg, **kw)

    def run_predictions(tag, x, f_true, e_true):
        if x is None:
            return
        t0 = time.time()
        fmu, fsig = _predict(x)
        times[f"f{tag}_eval"] = time.time() - t0
        pdict[f"fmu_{tag}"] = fmu.cpu().numpy()
        pdict[f"fsig_{tag}"] = fsig.cpu().numpy()
        if f_true is not None:
            pdict[f"f{tag}"] = np.asarray(f_true).reshape(-1)
        if integrated:
            t0 = time.time()
            emu, esig = _predict(x, integrated_obs=True)
            times[f"e{tag}_eval"] = time.time() - t0
            pdict[f"emu_{tag}"] = emu.cpu().numpy()
            pdict[f"esig_{tag}"] = esig.cpu().numpy()
            if e_true is not None:
                pdict[f"e{tag}"] = np.asarray(e_true).reshape(-1)

    run_predictions("valid", xvalid, fvalid, evalid)
    run_predictions("test", xtest, ftest, etest)
    run_predictions("grid", xgrid, fgrid, egrid)
    return pdict, times


def evaluate_and_save(odir: str, model, state, *, xtest=None, ftest=None, etest=None,
                      xvalid=None, fvalid=None, evalid=None,
                      xgrid=None, fgrid=None, egrid=None,
                      do_integrated_predictions: bool = False,
                      predict_maxiter_cg: int = 50,
                      predict_ksemi_method: str = "analytic",
                      predict_ksemi_samps: int = 200, elbo_trace=None,
                      hyper_traces: Optional[Dict] = None,
                      data_noise_std: Optional[float] = None,
                      train_elbo: Optional[float] = None,
                      predict_batch_size: int = 4096,
                      make_plots: Optional[bool] = None, grid_shape=None,
                      grid_extent=None, write: bool = True, predict_fn=None):
    """Checkpoint, predict on valid/test/grid (latent and, with
    ``do_integrated_predictions``, integrated), write the metric CSVs and,
    with ``make_plots`` (None: where matplotlib imports), the JAX harness's
    figures.  ``write=False`` predicts and writes nothing (the ranks of a
    parallel run but its coordinator).  ``predict_fn(x, integrated_obs=...)
    -> (mu, sig)`` replaces `batch_predict` (the model-parallel run's
    `parallel.mp_predict`; ``state`` is then only written).  Returns
    (pdict, eval_times)."""
    pkw = dict(predict_fn=predict_fn)
    if not write:
        return _predict_all(model, state, xtest, ftest, etest, xvalid, fvalid, evalid,
                            xgrid, fgrid, egrid, do_integrated_predictions,
                            predict_maxiter_cg, predict_ksemi_method, predict_ksemi_samps,
                            predict_batch_size, **pkw)
    os.makedirs(odir, exist_ok=True)
    if make_plots is None:
        make_plots = viz.matplotlib_available()
        if not make_plots:
            print("figures skipped: matplotlib is not installed", flush=True)
    ckpt.save_checkpoint(odir, state)
    if elbo_trace is not None:
        np.save(os.path.join(odir, "elbo_trace.npy"), np.asarray(elbo_trace))
        if make_plots:
            viz.plot_elbo_trace(elbo_trace, os.path.join(odir, "elbo.jpg"))
    for nm, tr in (hyper_traces or {}).items():
        if tr:
            np.save(os.path.join(odir, f"{nm}_trace.npy"), np.asarray(tr))

    pdict, times = _predict_all(model, state, xtest, ftest, etest, xvalid, fvalid, evalid,
                                xgrid, fgrid, egrid, do_integrated_predictions,
                                predict_maxiter_cg, predict_ksemi_method,
                                predict_ksemi_samps, predict_batch_size, **pkw)
    ckpt.save_predictions(os.path.join(odir, "predictions.npz"), pdict)

    if "ftest" in pdict:
        df = metrics.error_frame({"model": pdict}, data_type="test")
        metrics.write_csv(os.path.join(odir, "errordf-summary.csv"), metrics.describe(df))
        integrated = do_integrated_predictions and "etest" in pdict
        if data_noise_std is not None:
            metrics.write_csv(
                os.path.join(odir, "noise_reduction.csv"),
                metrics.noise_comparison_frame(pdict, data_noise_std,
                                               integrated_obs=integrated,
                                               train_elbo=train_elbo,
                                               eval_valid="fvalid" in pdict))
        z = {"model": df["f zscore"]}
        if integrated:
            z["model e"] = df["e zscore"]
        metrics.write_csv(os.path.join(odir, "coverage_table.csv"),
                          metrics.coverage_table(z))
        if make_plots:
            viz.plot_zscore_histogram(z["model"],
                                      path=os.path.join(odir, "f-zscore-histogram.pdf"))
            viz.plot_qq(z, path=os.path.join(odir, "qq.pdf"))
    if (make_plots and do_integrated_predictions and xtest is not None
            and np.ndim(xtest) == 2 and np.shape(xtest)[1] == 3 and "etest" in pdict):
        # the dust map's 3-D and 2-D posterior scatters
        xt = np.asarray(xtest)
        viz.plot_domain_result(
            odir, {"xtest": xt, "etest": pdict["etest"], "emu_test": pdict["emu_test"],
                   "esig_test": pdict["esig_test"]},
            slice_center=float(np.median(xt[:, 2])),
            slice_halfwidth=0.05 * (np.ptp(xt[:, 2]) + 1e-12))
    if make_plots and "fmu_grid" in pdict and grid_shape is not None:
        extent = grid_extent or (0, 1, 0, 1)
        viz.plot_posterior_grid(pdict["fmu_grid"], pdict["fsig_grid"], grid_shape, extent,
                                path=os.path.join(odir, "posterior-grid.jpg"))
        if fgrid is not None:
            viz.plot_comparison(np.asarray(fgrid).reshape(grid_shape),
                                pdict["fmu_grid"].reshape(grid_shape), extent,
                                path=os.path.join(odir, "comparison-grid.jpg"))
    return pdict, times


def _time_rows(rows):
    """The rows of time_report.csv as one frame: columns in order of first
    appearance, empty where a row lacks one (pandas' list-of-dicts frame)."""
    cols = []
    for r in rows:
        cols += [k for k in r if k not in cols]
    return {c: [r.get(c, np.nan) for r in rows] for c in cols}


def fit_predict_and_save(name: str, xobs, yobs, sobs, xinduce_grids,
                         model_class: str = "mean-field", kernel: str = "SqExp",
                         sig2_init="empirical", ell_init: float = 0.05,
                         noise2_init: float = 1.0, init_Svar: float = 1.0,
                         whitened_type: str = "ziggy",
                         block_sizes: Optional[Sequence[int]] = None,
                         jitter: float = 1e-3, fit_method: str = "natgrad",
                         fit_config: Optional[FitConfig] = None,
                         batch_solve_bsz: int = -1, maxiter_cg: int = 10,
                         mean_solver: str = "dense", mean_solver_maxiter: int = 200,
                         mean_solver_tol: float = 1e-8, theta2_warmstart: bool = False,
                         natgrad_safe_lr: str = "warn",
                         xtest=None, etest=None, ftest=None,
                         xvalid=None, evalid=None, fvalid=None,
                         xgrid=None, egrid=None, fgrid=None,
                         grid_shape=None, grid_extent=None,
                         output_dir: str = "./model-output/", eval_epochs: int = 0,
                         eval_epoch_plots: bool = False,
                         parallel: Optional[str] = None, mesh=None,
                         grid_shards: Optional[int] = None,
                         dtype=torch.float32, eval_only_state: Optional[str] = None,
                         device="cuda", max_steps: Optional[int] = None):
    """Fit and evaluate one model, saving every artifact under
    ``output_dir/name`` (the JAX harness's single entry point, on one
    device).  ``fit_method`` 'natgrad' runs `svigp_fit` (with
    ``eval_epochs=k`` the full evaluation every k-th epoch into
    ``epoch_output/epoch_N/``), 'full-batch' the closed-form
    ``model.batch_solve`` with ``mean_solver`` ('dense', 'cg', 'gram',
    'factored' or 'matfree'; an SVGP takes its dense closed form);
    ``block_sizes`` chunks the block family (recorded in
    ``fit_params.json``); ``grid_shape`` and ``grid_extent`` lay out the
    grid predictions' figures, drawn as `evaluate_and_save` decides
    (``eval_epoch_plots`` for the per-epoch evaluations);
    ``max_steps`` (the port's) ends a natgrad fit after that many steps.
    ``parallel='dp'`` and ``'mp'`` fit over ``mesh`` (the module
    docstring); ``grid_shards`` pads the HIP-GP's embedding (under 'mp' the
    mesh's grid size).  ``eval_only_state`` names a saved state (either
    package's ``state.npz``) to evaluate instead of fitting: no fit runs,
    ``fit_params.json`` records the ``fit_method`` passed in, the report's
    ``elbo_trace`` is None and its ``epoch_elbos`` empty, and the time
    report's ``fitting`` is the restore's seconds.  Returns (model, state,
    report), the same on every rank (under 'mp' the whole state,
    gathered)."""
    if parallel == "mp" and not (model_class == "mean-field"
                                 or model_class.startswith("block")):
        raise ValueError("parallel='mp' supports the mean-field and block families")
    default_mesh, writer = init_parallel(parallel, device)
    if mesh is None:
        mesh = default_mesh
    if parallel == "mp":
        from ..parallel.mesh import axis_size

        grid_shards = axis_size(mesh, "grid")
    odir = os.path.join(output_dir, name)
    if writer:
        os.makedirs(odir, exist_ok=True)
    xobs = np.asarray(xobs)
    yobs = np.asarray(yobs).reshape(-1)
    sobs = None if sobs is None else np.asarray(sobs).reshape(-1)
    if sig2_init == "empirical":
        sig2_init = empirical_sig2_init(xobs, yobs)
    elif sig2_init == "marginal":
        nvar = 0.0 if sobs is None else float(np.mean(sobs ** 2))
        sig2_init = max(float(np.var(yobs)) - nvar, 1e-3)

    cfg = dataclasses.replace(fit_config or FitConfig(), maxiter_cg=maxiter_cg)
    integrated = cfg.integrated_obs
    # the analytic semi-integrated covariances exist only for SqExp
    if integrated and kernel != "SqExp" and cfg.semi_integrated_estimator == "analytic":
        cfg = dataclasses.replace(cfg, semi_integrated_estimator="mc-biased",
                                  predict_ksemi_method="mc-biased")
    model = make_model(model_class, kernel, xinduce_grids, num_obs=len(xobs),
                       sig2_init=float(sig2_init), ell_init=ell_init,
                       noise2_init=noise2_init, init_Svar=init_Svar,
                       whitened_type=whitened_type, learn_kernel=cfg.learn_kernel,
                       learn_noise=cfg.learn_noise, jitter=jitter,
                       block_sizes=block_sizes, support_integrated_obs=integrated,
                       grid_shards=grid_shards, dtype=dtype, device=device)
    state = model.init_state()

    if writer:
        mesh_shape = (None if mesh is None
                      else dict(zip(mesh.mesh_dim_names, map(int, mesh.shape))))
        with open(os.path.join(odir, "fit_params.json"), "w") as f:
            json.dump({"model_class": model_class, "kernel": kernel,
                       "sig2_init": float(sig2_init), "ell_init": float(ell_init),
                       "whitened_type": whitened_type, "fit_method": fit_method,
                       "parallel": parallel or "none", "mesh_shape": mesh_shape,
                       "block_sizes": None if block_sizes is None else list(block_sizes),
                       **{k: v for k, v in dataclasses.asdict(cfg).items()
                          if isinstance(v, (int, float, str, bool))}}, f, indent=2)

    eval_kw = dict(xtest=xtest, ftest=ftest, etest=etest, xvalid=xvalid,
                   fvalid=fvalid, evalid=evalid, xgrid=xgrid, fgrid=fgrid, egrid=egrid,
                   do_integrated_predictions=integrated,
                   predict_maxiter_cg=cfg.predict_maxiter_cg,
                   predict_ksemi_method=cfg.predict_ksemi_method,
                   predict_ksemi_samps=cfg.predict_ksemi_samps,
                   data_noise_std=None if sobs is None else float(np.mean(sobs)),
                   grid_shape=grid_shape, grid_extent=grid_extent)

    def for_eval(state_):
        """(the state to write, evaluate_and_save's predict_fn): under 'mp'
        the gathered state (every rank takes part) and `mp_predict` of the
        rank's block."""
        if parallel != "mp":
            return state_, None
        from ..parallel import mp_gather_state, mp_predict

        def predict_fn(x, integrated_obs=False):
            kw = {}
            if integrated_obs:
                kw = dict(integrated_obs=True,
                          semi_integrated_estimator=cfg.predict_ksemi_method,
                          semi_integrated_samps=cfg.predict_ksemi_samps)
            return mp_predict(model, state_, x, mesh, maxiter_cg=cfg.predict_maxiter_cg,
                              **kw)

        return mp_gather_state(state_, mesh), predict_fn

    epoch_eval_rows = []
    epoch_callback = None
    if eval_epochs and fit_method == "natgrad":
        every = int(eval_epochs)

        def epoch_callback(epoch, model_, state_, trace):
            if (epoch + 1) % every and epoch != cfg.epochs - 1:
                return
            t0 = time.time()
            st_w, predict_fn = for_eval(state_)
            _, etimes = evaluate_and_save(
                os.path.join(odir, "epoch_output", f"epoch_{epoch}"), model_, st_w,
                elbo_trace=trace, make_plots=eval_epoch_plots, write=writer,
                predict_fn=predict_fn, **eval_kw)
            epoch_eval_rows.append({"epoch": epoch, "eval_total": time.time() - t0,
                                    **etimes})

    t_start = time.time()
    if eval_only_state is not None:
        state = restore_eval_state(model, eval_only_state, parallel, mesh)
        report = {"elbo_trace": None, "epoch_elbos": []}
        train_elbo = None
    elif fit_method == "natgrad":
        fit_kw = dict(verbose=writer, theta2_warmstart=theta2_warmstart,
                      natgrad_safe_lr=natgrad_safe_lr, max_steps=max_steps,
                      epoch_callback=epoch_callback)
        if parallel == "mp":
            from ..parallel import mp_svigp_fit

            state, report = mp_svigp_fit(model, state, xobs, yobs, sobs, cfg, mesh, **fit_kw)
        else:
            if parallel == "dp":
                from ..parallel import make_dp_data_shard_fn, round_batch_to_mesh

                cfg = round_batch_to_mesh(cfg, mesh, len(xobs))
                fit_kw["data_shard_fn"] = make_dp_data_shard_fn(mesh)
            state, report = svigp_fit(model, state, xobs, yobs, sobs, cfg, **fit_kw)
        train_elbo = report["epoch_elbos"][-1] if report["epoch_elbos"] else None
    elif fit_method == "full-batch":
        flags = dict(batch_size=batch_solve_bsz, maxiter_cg=maxiter_cg,
                     integrated_obs=integrated,
                     semi_integrated_estimator=cfg.semi_integrated_estimator,
                     semi_integrated_samps=cfg.num_semi_mc_samples, compute_elbo=True)
        if parallel == "dp":
            from ..parallel import dp_batch_solve

            state, elbo = dp_batch_solve(model, state, xobs, yobs, sobs, mesh, **flags)
        elif parallel == "mp":
            from ..parallel import mp_batch_solve

            flags["batch_size"] = batch_solve_bsz if batch_solve_bsz > 0 else len(xobs)
            state, elbo = mp_batch_solve(
                model, state, xobs, yobs, sobs, mesh,
                mean_solver=mean_solver if mean_solver in ("gram", "factored") else "cg",
                mean_solver_maxiter=mean_solver_maxiter, mean_solver_tol=mean_solver_tol,
                **flags)
        else:
            state, elbo = model.batch_solve(
                state, xobs, yobs, sobs, mean_solver=mean_solver,
                mean_solver_maxiter=mean_solver_maxiter, mean_solver_tol=mean_solver_tol,
                **flags)
        train_elbo = float(elbo)
        report = {"elbo_trace": [train_elbo], "epoch_elbos": [train_elbo]}
        if writer:
            print(f"batch solve elbo = {train_elbo:.5f}", flush=True)
    else:
        raise ValueError(f"fit_method={fit_method!r}")
    fitting_time = time.time() - t_start

    state, predict_fn = for_eval(state)
    pdict, eval_times = evaluate_and_save(
        odir, model, state, predict_fn=predict_fn, elbo_trace=report.get("elbo_trace"),
        hyper_traces={"sig2": report.get("sig2_trace"), "ell": report.get("ell_trace"),
                      "noisesq": report.get("noise2_trace")},
        train_elbo=train_elbo, write=writer, **eval_kw)

    trow = {"fitting": fitting_time, **eval_times}
    eval_by_epoch = {r["epoch"]: r for r in epoch_eval_rows}
    rows = []
    for i, ft in enumerate(report.get("epoch_times") or []):
        row = {"epoch": i, "fitting": ft}
        row.update({k: v for k, v in eval_by_epoch.get(i, {}).items() if k != "epoch"})
        rows.append(row)
    rows.append({"epoch": "total", **trow})
    if writer:
        metrics.write_csv(os.path.join(odir, "time_report.csv"), _time_rows(rows))
    report["time_report"] = trow
    report["epoch_eval_rows"] = epoch_eval_rows
    report["pdict"] = pdict
    return model, state, report
