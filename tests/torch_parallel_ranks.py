"""Rank-side cases of the port's parallel tests.

`hipgp_tpu_torch.parallel.launch.run` starts the ranks of
tests/test_torch_parallel.py, tests/test_torch_multihost.py and
tests/test_torch_fft_sharded.py once per file and runs one function of this
module in each: every case of the file, on the CPU in float64 and one
intra-op thread a rank, its results returned as numpy for the parent to
hold against the JAX package.  The ranks import neither JAX nor the JAX
package nor tests/conftest.py, so this module imports only torch, numpy and
the port.
"""
import importlib
import os

import numpy as np
import torch

from hipgp_tpu_torch import convert
from hipgp_tpu_torch.kernels import Matern, SqExp

F64 = torch.float64


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def dp_setup(n=64, family="mean-field", whitened="cholesky", block_sizes=None):
    """tests/test_parallel.py's problem: n points in [0.05, 0.95]^2, a 6 x 6
    grid, SqExp at ell 0.2, noise 0.2 (numpy from seed 0)."""
    rng = np.random.default_rng(0)
    x = rng.uniform(0.05, 0.95, (n, 2))
    y = np.sin(4 * x[:, 0]) + 0.2 * rng.standard_normal(n)
    s = np.full(n, 0.2)
    grids = [np.linspace(0.0, 1.0, 6)] * 2
    return dict(x=x, y=y, s=s, grids=grids, family=family, whitened=whitened,
                block_sizes=block_sizes, n=n)


def dp_model(p):
    from hipgp_tpu_torch.models import HIPGP

    kw = {} if p["block_sizes"] is None else {"block_sizes": p["block_sizes"]}
    return HIPGP(SqExp(), p["grids"], num_obs=p["n"], family=p["family"],
                 whitened_type=p["whitened"], ell_init=0.2, noise2_init=0.04,
                 dtype=F64, device="cpu", **kw)


def svgp_setup(n=40, m=5, whitened=False, learn_kernel=False):
    """tests/test_torch_svgp.py's problem at n points: a dense SVGP on the
    mesh of an m x m grid, SqExp at ell 0.25, sig2 1.3, noise 0.2, fitted
    for 2 epochs of batch 16 (the last batch's 8 rows all on rank 0)."""
    rng = np.random.default_rng(0)
    x = rng.uniform(0.05, 0.95, (n, 2))
    y = np.sin(4 * x[:, 0]) + np.cos(3 * x[:, 1]) + 0.2 * rng.standard_normal(n)
    g = np.linspace(0.0, 1.0, m)
    xx, yy = np.meshgrid(g, g, indexing="ij")
    # a constant lr: optax rounds a scheduled one to float32 (ROADMAP C)
    cfg = dict(epochs=2, batch_size=16, lr=0.3, schedule_lr=False, kernel_lr=1e-2,
               learn_kernel=learn_kernel)
    return dict(x=x, y=y, s=np.full(n, 0.2), xinduce=np.column_stack([xx.ravel(), yy.ravel()]),
                n=n, whitened=whitened, cfg=cfg)


def svgp_model(p):
    from hipgp_tpu_torch.models import SVGP

    return SVGP(SqExp(), p["xinduce"], num_obs=p["n"], whitened=p["whitened"],
                sig2_init=1.3, ell_init=0.25, dtype=F64, device="cpu")


def _state(d):
    return convert.state_from_numpy(d, device="cpu")


def _fit_out(st, rep):
    out = {k: _np(getattr(st, k)) for k in convert.STATE_FIELDS}
    out.update(epoch_elbos=np.asarray(rep["epoch_elbos"]),
               rho=rep.get("natgrad_rho"), lr_used=rep.get("lr_used"))
    return out


def _driver_out(out):
    """(state theta1, ELBO trace) of a driver's result: the harness's
    (model, state, report) or run_domain's metrics."""
    if isinstance(out, dict):
        return (np.asarray([out["last_elbo"], out["e_post_rmse"]]),)
    _, st, rep = out
    return (_np(st.theta1), np.asarray(rep["elbo_trace"]))


def dp_cases(inputs, outdir):
    """Every case of tests/test_torch_parallel.py, on this rank."""
    torch.set_num_threads(1)
    import torch.distributed as dist

    from hipgp_tpu_torch.experiments import harness, run_synthetic
    from hipgp_tpu_torch.infer import FitConfig, ell_fit, make_optimizer, svigp_fit
    from hipgp_tpu_torch.parallel import (dp_batch_solve, dp_elbo_and_grads, dp_svigp_fit,
                                          make_dp_data_shard_fn, make_dp_train_step,
                                          make_mesh)
    from hipgp_tpu_torch.parallel.mesh import axis_size, shard_batch

    res, rank = {}, dist.get_rank()
    mesh = make_mesh()
    mesh2 = make_mesh(2, axis_names=("dp", "grid"), shape=(1, 2))
    res["mesh"] = (int(mesh.size()), tuple(mesh.mesh_dim_names),
                   tuple(mesh2.mesh_dim_names), axis_size(mesh2, "dp"),
                   axis_size(mesh2, "grid"))
    res["shard_batch"] = _np(shard_batch(mesh, torch.arange(12).reshape(3, 4), axis=1))

    for key, p in inputs["solve"].items():
        m = dp_model(p)
        st = dp_batch_solve(m, m.init_state(), torch.tensor(p["x"]), torch.tensor(p["y"]),
                            torch.tensor(p["s"]), mesh, maxiter_cg=p["maxiter_cg"])
        res[f"solve/{key}"] = (_np(st.theta1), _np(st.theta2))

    p = inputs["ell_fit"]
    m = dp_model(p)
    best, ell, ells, elbos = ell_fit(m, m.init_state(), p["x"], p["y"], p["s"],
                                     parallel="dp", mesh=mesh, verbose=False, **p["kw"])
    res["ell_fit"] = (ell, ells, elbos, _np(best.theta2))

    for key, p in inputs["grads"].items():
        m = dp_model(p)
        step = dp_elbo_and_grads(m, mesh, maxiter_cg=p["maxiter_cg"],
                                 compute_hyper_grads=p["hyper"])
        w = torch.ones(p["n"], dtype=F64)
        elbo, g = step(_state(p["state"]), torch.tensor(p["x"]), torch.tensor(p["y"]),
                       torch.tensor(p["s"]), w)
        res[f"grads/{key}"] = (float(elbo), {k: _np(getattr(g, k))
                                             for k in convert.STATE_FIELDS})

    p = inputs["train_step"]
    m = dp_model(p)
    cfg = FitConfig(lr=0.05, maxiter_cg=50)
    st = _state(p["state"])
    opt = make_optimizer(st, cfg)
    step = make_dp_train_step(m, cfg, opt, mesh)
    w = torch.ones(p["n"], dtype=F64)
    elbos = []
    for _ in range(10):
        st, opt, elbo = step(st, opt, torch.tensor(p["x"]), torch.tensor(p["y"]),
                             torch.tensor(p["s"]), w)
        elbos.append(float(elbo))
    res["train_step"] = elbos

    for key, p in inputs["fits"].items():
        m = dp_model(p)
        cfg = FitConfig(**p["cfg"])
        s = None if p["noise"] is None else p["s"]
        if p["route"] == "dp_svigp_fit":
            st, rep = dp_svigp_fit(m, _state(p["state"]), p["x"], p["y"], s, cfg, mesh,
                                   verbose=False)
        else:
            st, rep = svigp_fit(m, _state(p["state"]), p["x"], p["y"], s, cfg,
                                verbose=False, data_shard_fn=make_dp_data_shard_fn(mesh),
                                **p["kw"])
        res[f"fits/{key}"] = _fit_out(st, rep)

    for key, p in inputs["svgp_fits"].items():
        m = svgp_model(p)
        st, rep = svigp_fit(m, m.init_state(), p["x"], p["y"], p["s"], FitConfig(**p["cfg"]),
                            verbose=False, data_shard_fn=make_dp_data_shard_fn(mesh))
        res[f"svgp_fits/{key}"] = dict(
            {k: _np(getattr(st, k)) for k in ("theta1", "theta2", "log_sig2", "log_ell")},
            elbo_trace=np.asarray(rep["elbo_trace"]))

    p = inputs["harness"]
    for method in ("natgrad", "full-batch"):
        odir = os.path.join(outdir, f"harness-{method}-{rank}")
        _, st, rep = harness.fit_predict_and_save(
            name="dp", xobs=p["x"], yobs=p["y"], sobs=p["s"], xinduce_grids=p["grids"],
            whitened_type="cholesky", ell_init=0.2, noise2_init=0.04, sig2_init="marginal",
            fit_method=method, fit_config=FitConfig(**p["cfg"]), maxiter_cg=10,
            xtest=p["xt"], ftest=p["ft"], output_dir=odir, parallel="dp", dtype=F64,
            device="cpu")
        res[f"harness/{method}"] = dict(
            theta1=_np(st.theta1), epoch_elbos=np.asarray(rep["epoch_elbos"]),
            fmu=rep["pdict"]["fmu_test"], wrote=os.path.isdir(os.path.join(odir, "dp")))
    res["driver"] = run_synthetic.main(
        inputs["driver_argv"] + ["--parallel", "dp", "--output-dir",
                                 os.path.join(outdir, f"driver-{rank}")])
    res["driver_wrote"] = os.path.isdir(os.path.join(outdir, f"driver-{rank}"))
    for name, argv in inputs["drivers"].items():
        mod = importlib.import_module(f"hipgp_tpu_torch.experiments.{name}")
        odir = os.path.join(outdir, f"{name}-{rank}")
        out = mod.main(argv + ["--parallel", "dp", "--output-dir", odir])
        res[f"drivers/{name}"] = _driver_out(out) + (os.path.isdir(odir),)
    res["rank"] = rank
    return res


def multihost_cases(n_global):
    """tests/test_multihost.py's cluster, on this rank: the slices, the
    padded blocks, the barrier and the row-weighted solve of N = n_global
    rows split by `process_slice`."""
    torch.set_num_threads(1)
    from hipgp_tpu_torch.models import HIPGP
    from hipgp_tpu_torch.parallel import dp_batch_solve, multihost

    mesh = multihost.global_mesh(("dp",))
    sl = multihost.process_slice(n_global)
    rng = np.random.default_rng(0)
    x_all = rng.uniform(-1, 1, (n_global, 2))
    y_all = np.sin(3 * x_all[:, 0]) * np.cos(2 * x_all[:, 1])
    s_all = np.full(n_global, 0.1)
    xg = multihost.global_batch(mesh, x_all[sl], n_global=n_global)
    yg = multihost.global_batch(mesh, y_all[sl], n_global=n_global)
    sg = multihost.global_batch(mesh, s_all[sl], n_global=n_global, fill=1.0)
    wg = multihost.global_row_weights(mesh, n_global)
    grids = [np.linspace(-1.0, 1.0, 8)] * 2
    model = HIPGP(SqExp(), grids, num_obs=n_global, family="mean-field", ell_init=0.3,
                  noise2_init=0.01, dtype=F64, device="cpu")
    new, elbo = dp_batch_solve(model, model.init_state(), xg, yg, sg, mesh, maxiter_cg=50,
                               row_weights=wg, compute_elbo=True)
    return dict(slice=(sl.start, sl.stop), sync=multihost.sync_global(1.0),
                coordinator=multihost.on_coordinator(),
                x_shape=tuple(xg.shape), x_local=_np(xg.local), s_local=_np(sg.local),
                w_local=_np(wg.local), theta1=_np(new.theta1), theta2=_np(new.theta2),
                elbo=float(elbo))


def _kernel(name):
    return {"SqExp": SqExp(), "Mat52": Matern(2.5), "Mat32": Matern(1.5)}[name]


def _spec(c):
    from hipgp_tpu_torch.ops import make_spectrum

    grids = [torch.linspace(0.0, 1.0, m, dtype=F64) for m in c["dims"]]
    kern, params = _kernel(c["kernel"]), (c.get("sig2", 1.0), c["ell"])
    return make_spectrum(grids, lambda a, b: kern(a, b, params), jitter=1e-3,
                         multiple_of=c.get("multiple_of"))


def fft_sharded_cases(inputs):
    """Every case of tests/test_torch_fft_sharded.py, on this rank."""
    torch.set_num_threads(1)
    import torch.distributed as dist

    from hipgp_tpu_torch.ops import make_spectrum
    from hipgp_tpu_torch.parallel import (GridShardInfo, host_weights,
                                          local_spectrum_weights, local_whiten_diff,
                                          make_mesh, sharded_gram_solve, sharded_inv_matmul,
                                          sharded_matmul_by_K, weights_shard)
    from hipgp_tpu_torch.parallel.fft_sharded import _embed_full
    from hipgp_tpu_torch.parallel.mesh import all_gather

    mesh = make_mesh(axis_names=("grid",))
    group, rank, n = mesh.get_group("grid"), dist.get_rank(), dist.get_world_size()
    res = {}
    for key, c in inputs["solves"].items():
        spec = _spec(c)
        b = torch.tensor(c["b"])
        kw = {"matmul_max_len": c.get("max_len")}
        out = {"edims": spec.edims,
               "K": _np(sharded_matmul_by_K(spec, b, mesh, **kw))}
        if c.get("solves", True):
            it = dict(maxiter=c["maxiter"], tol=1e-12, **kw)
            out["inv"] = _np(sharded_inv_matmul(spec, b, mesh, **it))
            out["gram"] = _np(sharded_gram_solve(spec, b, mesh, **it))
        res[f"solves/{key}"] = out

    try:
        spec = _spec(inputs["bad"])
        sharded_gram_solve(spec, torch.ones((1, spec.M), dtype=F64), mesh)
        res["bad"] = None
    except ValueError as e:
        res["bad"] = str(e)

    for key, c in inputs["weights"].items():
        kern, params = _kernel(c["kernel"]), (1.3, c["ell"])
        kf = lambda a, b: kern(a, b, params)
        grids = [torch.linspace(0.0, 1.0, m, dtype=F64) for m in c["dims"]]
        spec = make_spectrum(grids, kf, jitter=1e-3, multiple_of=c["multiple_of"])
        info = GridShardInfo(spec, n)
        got = local_spectrum_weights(grids, kf, info, group, jitter=1e-3)
        want = weights_shard(host_weights(spec, info), info, rank)
        res[f"weights/{key}"] = (_np(got), _np(want))

    # the implicit gradient of the sharded whitening: d/d(b, log_sig2, log_ell)
    # of sum(r * kn) at a fixed number of iterations
    c = inputs["grad"]
    grids = [torch.linspace(0.0, 1.0, m, dtype=F64) for m in c["dims"]]
    log_sig2 = torch.tensor(np.log(c["sig2"]), dtype=F64, requires_grad=True)
    log_ell = torch.tensor(np.log(c["ell"]), dtype=F64, requires_grad=True)
    params = (torch.exp(log_sig2), torch.exp(log_ell))
    kf = lambda a, b: SqExp()(a, b, params)
    with torch.no_grad():
        spec0 = make_spectrum(grids, lambda a, b: SqExp()(a, b, (c["sig2"], c["ell"])),
                              jitter=1e-3)
    info = GridShardInfo(spec0, n)
    w_local = local_spectrum_weights(grids, kf, info, group, jitter=1e-3)
    b = torch.tensor(c["b"], requires_grad=True)
    cols = slice(rank * info.Mp_local, (rank + 1) * info.Mp_local)
    x_local = _embed_full(spec0, b)[:, cols]
    kn_local = local_whiten_diff(x_local, w_local, info, group, maxiter=c["maxiter"],
                                 tol=0.0)
    loss = torch.sum(torch.tensor(c["r"])[:, cols] * kn_local)
    g_b, g_s, g_l = torch.autograd.grad(loss, (b, log_sig2, log_ell))
    # every rank's share of the gradient, summed over the grid's blocks
    g = torch.cat([g_b.reshape(-1), g_s.reshape(1), g_l.reshape(1)])
    g = all_gather(g[None], group, axis=0).sum(0)
    res["grad"] = dict(kn=_np(all_gather(kn_local.detach(), group, axis=1)),
                       loss=float(sum(all_gather(loss.detach()[None], group))),
                       g_b=_np(g[:-2].reshape(g_b.shape)), g_log_sig2=float(g[-2]),
                       g_log_ell=float(g[-1]))
    res["rank"] = rank
    return res
