"""Rank-side cases of the port's parallel tests.

`hipgp_tpu_torch.parallel.launch.run` starts the ranks of
tests/test_torch_parallel.py, tests/test_torch_multihost.py,
tests/test_torch_fft_sharded.py, tests/test_torch_mp.py and
tests/test_torch_mp_train.py once per file and runs one function of this
module in each: every case of the file, on the CPU in float64 and one
intra-op thread a rank, its results returned as numpy for the parent to
hold against the JAX package.  The ranks import neither JAX nor the JAX
package nor tests/conftest.py, so this module imports only torch, numpy and
the port.
"""
import importlib
import os
import shutil

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

    from hipgp_tpu_torch.experiments import harness, run_domain, run_synthetic
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
    mp_mesh, mp_writer = harness.init_parallel("mp", "cpu")
    res["init_parallel_mp"] = (tuple(mp_mesh.mesh_dim_names),
                               tuple(int(v) for v in mp_mesh.shape), mp_writer)
    res["driver_mp"] = run_synthetic.main(
        inputs["driver_mp_argv"] + ["--parallel", "mp", "--output-dir",
                                 os.path.join(outdir, f"driver-mp-{rank}")])
    res["driver_mp_wrote"] = os.path.isdir(os.path.join(outdir, f"driver-mp-{rank}"))
    odir = os.path.join(outdir, f"run_domain-mp-{rank}")
    res["run_domain_mp"] = run_domain.main(inputs["drivers"]["run_domain"]
                                           + ["--parallel", "mp", "--mean-solver", "gram",
                                              "--output-dir", odir])
    res["run_domain_mp_wrote"] = os.path.isfile(os.path.join(odir, "state.npz"))
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


# ---------------------------------------------------------------------------
# the model-parallel HIP-GP (tests/test_torch_mp.py, tests/test_torch_mp_train.py)
# ---------------------------------------------------------------------------

MP_MESHES = ((2, 2), (1, 4))


def mp_data(N=300, seed=0, dim=2):
    """tests/test_mp.py's data: N points in [0.05, 0.95]^dim, a sin-cos
    surface, noise std in [0.05, 0.15] (numpy from ``seed``)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.05, 0.95, (N, dim))
    f = np.sin(3 * x[:, 0]) * np.cos(2 * x[:, -1])
    s = rng.uniform(0.05, 0.15, N)
    return x, f + s * rng.standard_normal(N), s


def mp_model_kw(N, ng, family="mean-field", m=11, dim=2, ell=0.15, block_sizes=None,
                integrated=False, f32=False, lo=0.0, **extra):
    """tests/test_mp.py's model (SqExp on an m^dim grid of [lo, 1]^dim, noise2
    0.01, ``grid_shards=ng``, float64) as keywords both packages' tests
    build from."""
    return dict(N=N, ng=ng, family=family, m=m, dim=dim, ell=ell, block_sizes=block_sizes,
                integrated=integrated, f32=f32, lo=lo, **extra)


def mp_model(p):
    from hipgp_tpu_torch.models import HIPGP

    kw = {} if p["block_sizes"] is None else {"block_sizes": p["block_sizes"]}
    for k in ("learn_noise",):
        if k in p:
            kw[k] = p[k]
    dt = torch.float32 if p["f32"] else F64
    grids = [np.linspace(p["lo"], 1.0, p["m"])] * p["dim"]
    return HIPGP(SqExp(), grids, num_obs=p["N"], family=p["family"], ell_init=p["ell"],
                 noise2_init=0.01, grid_shards=p["ng"],
                 support_integrated_obs=p["integrated"], dtype=dt, device="cpu", **kw)


def _meshes():
    from hipgp_tpu_torch.parallel import make_mesh

    return {shape: make_mesh(axis_names=("dp", "grid"), shape=shape) for shape in MP_MESHES}


def _t(a, p=None):
    if a is None:
        return None
    dt = torch.float32 if p is not None and p["f32"] else F64
    return torch.as_tensor(np.asarray(a)).to(dt)


def _whole(st, mesh):
    from hipgp_tpu_torch.parallel import mp_gather_state

    g = mp_gather_state(st, mesh)
    return {k: _np(getattr(g, k)) for k in convert.STATE_FIELDS}


def _recorded(fn):
    """(fn(), the messages of the RuntimeWarnings it raised)."""
    import warnings

    with warnings.catch_warnings(record=True) as ws:
        warnings.simplefilter("always")
        out = fn()
    return out, [str(w.message) for w in ws if issubclass(w.category, RuntimeWarning)]


def mp_cases(inputs):
    """Every case of tests/test_torch_mp.py, on this rank: mp_batch_solve
    (and mp_predict of its state), ell_fit(parallel='mp'), the GlobalBatch
    blocks of process_slice / global_batch, the raises."""
    torch.set_num_threads(1)
    import torch.distributed as dist

    from hipgp_tpu_torch.infer import ell_fit
    from hipgp_tpu_torch.parallel import mp_batch_solve, mp_predict, multihost

    meshes, res = _meshes(), {}
    from hipgp_tpu_torch.models import hipgp

    for key, c in inputs["solves"].items():
        p, mesh = c["model"], meshes[c["mesh"]]
        m = mp_model(p)
        x, y, s = (_t(c[k], p) for k in ("x", "y", "s"))
        st0 = m.init_state() if c.get("state") is None else _state(c["state"])
        # the float32 pre-check lifted: the exactness guard's fallback
        kappa_max = hipgp.FACTORED_F32_KAPPA_MAX
        hipgp.FACTORED_F32_KAPPA_MAX = c.get("kappa_max", kappa_max)
        try:
            out, warned = _recorded(lambda: mp_batch_solve(m, st0, x, y, s, mesh, **c["kw"]))
        finally:
            hipgp.FACTORED_F32_KAPPA_MAX = kappa_max
        st, elbo = out if c["kw"].get("compute_elbo") else (out, None)
        r = dict(_whole(st, mesh), elbo=None if elbo is None else float(elbo), warned=warned)
        if "predict" in c:
            mu, sig = mp_predict(m, st, _t(c["xq"], p), mesh, **c["predict"])
            r.update(mu=_np(mu), sig=_np(sig))
        res[f"solves/{key}"] = r

    for key, c in inputs.get("raises", {}).items():
        m = mp_model(c["model"])
        try:
            mp_batch_solve(m, m.init_state(), _t(c["x"]), _t(c["y"]), _t(c["s"]),
                           meshes[c["mesh"]])
            res[f"raises/{key}"] = None
        except ValueError as e:
            res[f"raises/{key}"] = str(e)

    if "ell_fit" not in inputs:
        return res
    c = inputs["ell_fit"]
    m = mp_model(c["model"])
    best, ell, ells, elbos = ell_fit(m, m.init_state(), c["x"], c["y"], c["s"], parallel="mp",
                                     mesh=meshes[c["mesh"]], **c["kw"])
    res["ell_fit"] = (ell, ells, elbos, _np(best.theta2))

    # the multi-host layout: each 'dp' position loads its rows (process_slice
    # over the mesh's dp axis), pads them to the common block (global_batch)
    c = inputs["multihost"]
    mesh = meshes[c["mesh"]]
    n = c["model"]["N"]
    sl = multihost.process_slice(n, mesh)
    xg, yg = (multihost.global_batch(mesh, c[k][sl], n_global=n) for k in ("x", "y"))
    sg = multihost.global_batch(mesh, c["s"][sl], n_global=n, fill=1.0)
    wg = multihost.global_row_weights(mesh, n)
    m = mp_model(c["model"])
    st, elbo = mp_batch_solve(m, m.init_state(), xg, yg, sg, mesh, row_weights=wg, **c["kw"])
    res["multihost"] = dict(_whole(st, mesh), elbo=float(elbo), slice=(sl.start, sl.stop),
                            n_global=xg.n_global, local_rows=int(xg.local.shape[0]),
                            pad_rows=int((wg.local == 0).sum()))
    res["rank"] = dist.get_rank()
    return res


def _fit_report(rep):
    return dict(epoch_elbos=np.asarray(rep["epoch_elbos"]), rho=rep.get("natgrad_rho"),
                lr_used=rep.get("lr_used"), steps=rep.get("steps"),
                ell_trace=np.asarray(rep.get("ell_trace") or []))


def mp_train_cases(inputs, outdir):
    """Every case of tests/test_torch_mp_train.py, on this rank: one
    natgrad step's ELBO and gradients (mp_elbo_and_grads), mp_svigp_fit's
    trajectories with mp_predict of their states, make_mp_kn_fn in 1-D,
    and a checkpointed fit resumed."""
    torch.set_num_threads(1)
    import torch.distributed as dist

    from hipgp_tpu_torch.infer import FitConfig
    from hipgp_tpu_torch.parallel import (make_mp_kn_fn, mp_elbo_and_grads, mp_predict,
                                          mp_svigp_fit)
    from hipgp_tpu_torch.parallel.mesh import all_gather, axis_group

    meshes, res = _meshes(), {}
    for key, c in inputs["grads"].items():
        p, mesh = c["model"], meshes[c.get("mesh", (2, 2))]
        m = mp_model(p)
        st = m.init_state() if c["state"] is None else _state(c["state"])
        gen = None if "seed" not in c else torch.Generator().manual_seed(c["seed"])
        elbo, g = mp_elbo_and_grads(m, st, _t(c["x"]), _t(c["y"]), _t(c["s"]), mesh=mesh,
                                    generator=gen, **c["kw"])
        res[f"grads/{key}"] = dict(_whole(g, mesh), elbo=float(elbo))

    for key, c in inputs["fits"].items():
        dist.barrier()   # a resumed fit reads what rank 0 wrote
        p, mesh = c["model"], meshes[c.get("mesh", (2, 2))]
        m = mp_model(p)
        kw = dict(c["kw"])
        if "checkpoint" in c:
            kw["checkpoint_dir"] = os.path.join(outdir, c["checkpoint"])
        st, rep = mp_svigp_fit(m, _state(c["state"]), c["x"], c["y"], c["s"],
                               FitConfig(**c["cfg"]), mesh, verbose=False, **kw)
        r = dict(_whole(st, mesh), **_fit_report(rep))
        if "predict" in c:
            mu, sig = mp_predict(m, st, _t(c["xq"]), mesh, **c["predict"])
            r.update(mu=_np(mu), sig=_np(sig))
        res[f"fits/{key}"] = r
        if "keep_checkpoint" in c:
            dist.barrier()
            if dist.get_rank() == 0:
                shutil.copytree(kw["checkpoint_dir"], os.path.join(outdir,
                                                                   c["keep_checkpoint"]))

    c = inputs["kn_fn"]
    mesh = meshes[c.get("mesh", (2, 2))]
    m = mp_model(c["model"])
    kn_fn = make_mp_kn_fn(m, mesh, **c["kw"])
    from hipgp_tpu_torch.parallel.dp import _rows
    from hipgp_tpu_torch.parallel.mesh import axis_index, axis_size

    x = _rows(_t(c["x"]), axis_size(mesh, "dp"), axis_index(mesh, "dp"))
    kn, knn = kn_fn(_state(c["state"]), x, None)
    kn = all_gather(all_gather(kn, axis_group(mesh, "grid"), axis=1), axis_group(mesh, "dp"),
                    axis=0)
    res["kn_fn"] = dict(kn=_np(kn), knn=_np(all_gather(knn, axis_group(mesh, "dp"))),
                        offset=kn_fn.offset, local_shape=tuple(x.shape))
    res["rank"] = dist.get_rank()
    return res
