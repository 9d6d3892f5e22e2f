"""Parity of the port's data parallelism with the JAX package.

The port runs one process per device: one world of two gloo ranks on the
CPU (`hipgp_tpu_torch.parallel.launch`) runs every case of this file once,
in float64 (`torch_parallel_ranks.dp_cases`, which imports neither JAX nor
the JAX package), and each test holds one case against the JAX package's
single-device functions (tests/test_parallel.py's problem: 64 points, a
6 x 6 grid), and where cheap against JAX's own ``dp_batch_solve`` on a
two-device mesh: ``dp_batch_solve`` for every family and whitening, with
uneven N, ``ell_fit(parallel='dp')``, ``dp_elbo_and_grads`` with the
hyper-gradients, ``make_dp_train_step``, ``dp_svigp_fit`` and
``svigp_fit(data_shard_fn=...)`` with the warm start, rho's clamp and
``learn_kernel``, and the dense SVGP's ``svigp_fit(data_shard_fn=...)``;
the harness's ``parallel='dp'`` and ``run_synthetic --parallel dp``
against the port's own single-process run.  Tolerances are
the JAX tests': 1e-8 on batch solves, 1e-7 on fits, 1e-6 on the ELBO curve.
"""
import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # one intra-op thread a process: the xdist workers share the cores

import torch_parallel_ranks as ranks
from hipgp_tpu import kernels as jkernels
from hipgp_tpu.infer import FitConfig as JFitConfig
from hipgp_tpu.infer import ell_fit as jell_fit
from hipgp_tpu.infer import svigp_fit as jsvigp_fit
from hipgp_tpu.models import HIPGP as JHIPGP
from hipgp_tpu.models import SVGP as JSVGP
from hipgp_tpu.parallel import dp_batch_solve as jdp_batch_solve
from hipgp_tpu.parallel import make_mesh as jmake_mesh
from hipgp_tpu_torch import convert
from hipgp_tpu_torch.experiments import harness, run_synthetic
from hipgp_tpu_torch.infer import FitConfig, svigp_fit
from hipgp_tpu_torch.parallel import launch

RANKS = 2
FAMILIES = [("mean-field", "cholesky"), ("mean-field", "ziggy"), ("full-rank", "cholesky"),
            ("full-rank", "ziggy"), ("block", "cholesky"), ("block", "ziggy")]
BLOCKS = {"cholesky": (3, 3), "ziggy": (5, 5)}
# the fits: (route, whitening, per-point noise, FitConfig, svigp_fit keywords)
FITS = {
    "dp_svigp_fit-noise": ("dp_svigp_fit", "cholesky", True,
                           dict(epochs=3, batch_size=32, lr=0.05, maxiter_cg=50,
                                schedule_lr=True), {}),
    "dp_svigp_fit-model-noise": ("dp_svigp_fit", "cholesky", False,
                                 dict(epochs=2, batch_size=32, lr=0.05, maxiter_cg=50), {}),
    "shard-warmstart-clamp": ("svigp_fit", "cholesky", True,
                              dict(epochs=2, batch_size=32, lr=1.0, maxiter_cg=50),
                              dict(theta2_warmstart=True, natgrad_safe_lr="clamp")),
    "shard-learn-kernel": ("svigp_fit", "cholesky", True,
                           dict(epochs=2, batch_size=32, lr=0.05, maxiter_cg=50,
                                learn_kernel=True, kernel_lr=1e-2), {}),
    "shard-learn-kernel-noise-ziggy": ("svigp_fit", "ziggy", False,
                                       dict(epochs=1, batch_size=32, lr=0.05, maxiter_cg=5,
                                            learn_kernel=True, learn_noise=True,
                                            kernel_lr=1e-2), {}),
}
# the dense SVGP's fits through svigp_fit(data_shard_fn=...): (whitened, learn_kernel)
SVGP_FITS = {"unwhitened": (False, False), "unwhitened-learn-kernel": (False, True),
             "whitened-learn-kernel": (True, True)}
# the other three drivers at small sizes (their default fits: the closed form)
DRIVERS = {
    "run_3droad": ["--device", "cpu", "--nobs", "400", "--num-inducing", "8", "--f64"],
    "run_ukhousing": ["--device", "cpu", "--nobs", "400", "--ntest", "80",
                      "--num-inducing-x", "10", "--num-inducing-y", "8", "--f64"],
    "run_domain": ["--device", "cpu", "--nobs", "300", "--ntest", "50", "--nx", "8",
                   "--nz", "4", "--f64"],
}
DRIVER_ARGV = ["--device", "cpu", "--nobs", "200", "--ntest", "40", "--num-inducing", "8",
               "--gridnum", "8", "--epochs", "1", "--batch-size", "32", "--f64"]
# 9 x 9 inducing points embed at 16 x 16 with or without the padding for two
# grid shards (8 x 8 at 15 x 15 unpadded): the single-process model is the
# model-parallel one
DRIVER_MP_ARGV = DRIVER_ARGV + ["--num-inducing", "9"]


def _jmodel(p):
    kw = {} if p["block_sizes"] is None else {"block_sizes": p["block_sizes"]}
    return JHIPGP(jkernels.SqExp(), [jnp.asarray(g) for g in p["grids"]], num_obs=p["n"],
                  family=p["family"], whitened_type=p["whitened"], ell_init=0.2,
                  noise2_init=0.04, dtype=jnp.float64, **kw)


def _jstate_np(p):
    js = _jmodel(p).init_state()
    return {k: np.asarray(getattr(js, k)) for k in convert.STATE_FIELDS}


def _jstate(p, d):
    return _jmodel(p).init_state().replace(**{k: jnp.asarray(v) for k, v in d.items()})


def _solve_setup(family, whitened):
    p = ranks.dp_setup(family=family, whitened=whitened,
                       block_sizes=BLOCKS[whitened] if family == "block" else None)
    return {**p, "maxiter_cg": 200}


def _fit_setup(key):
    route, wt, noise, cfg, kw = FITS[key]
    p = ranks.dp_setup(whitened=wt)
    return {**p, "route": route, "noise": True if noise else None, "cfg": cfg, "kw": kw,
            "state": _jstate_np(p)}


def _harness_setup():
    p = ranks.dp_setup()
    rng = np.random.default_rng(5)
    xt = rng.uniform(0.05, 0.95, (30, 2))
    return {**p, "xt": xt, "ft": np.sin(4 * xt[:, 0]),
            "cfg": dict(epochs=1, batch_size=32, lr=0.05)}


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    outdir = str(tmp_path_factory.mktemp("dp"))
    grads = {}
    for key, (wt, hyper, it) in {"cholesky": ("cholesky", False, 50),
                                 "ziggy-hyper": ("ziggy", True, 5)}.items():
        p = ranks.dp_setup(whitened=wt)
        grads[key] = {**p, "hyper": hyper, "maxiter_cg": it, "state": _jstate_np(p)}
    ts = ranks.dp_setup()
    inputs = {
        "solve": {f"{f}-{w}": _solve_setup(f, w) for f, w in FAMILIES},
        "ell_fit": {**ranks.dp_setup(whitened="ziggy"),
                    "kw": dict(ell_min=0.1, ell_max=0.3, ell_step_size=0.1,
                               batch_solve_bsz=8, maxiter_cg=200)},
        "grads": grads,
        "train_step": {**ts, "state": _jstate_np(ts)},
        "fits": {k: _fit_setup(k) for k in FITS},
        "svgp_fits": {k: ranks.svgp_setup(whitened=w, learn_kernel=lk)
                      for k, (w, lk) in SVGP_FITS.items()},
        "harness": _harness_setup(),
        "driver_argv": DRIVER_ARGV,
        "driver_mp_argv": DRIVER_MP_ARGV,
        "drivers": DRIVERS,
    }
    p = ranks.dp_setup(n=61)
    inputs["solve"]["uneven-61"] = {**p, "maxiter_cg": 10}
    out = launch.run(ranks.dp_cases, RANKS, args=(inputs, outdir), device="cpu",
                     timeout_s=300)
    return inputs, out, outdir


def _assert_equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_equal(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for u, v in zip(a, b):
            _assert_equal(u, v)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _same_on_every_rank(out, key):
    for r in out[1:]:
        _assert_equal(out[0][key], r[key])


def test_mesh_size_and_axis_names(cluster):
    _, out, _ = cluster
    assert out[0]["mesh"] == (RANKS, ("dp",), ("dp", "grid"), 1, RANKS)
    assert [r["rank"] for r in out] == list(range(RANKS))
    # shard_batch: each rank's block of the split axis, in rank order
    np.testing.assert_array_equal(np.concatenate([r["shard_batch"] for r in out], axis=1),
                                  np.arange(12).reshape(3, 4))


@pytest.mark.parametrize("family,whitened", FAMILIES)
def test_dp_batch_solve_matches_jax(cluster, family, whitened):
    inputs, out, _ = cluster
    key = f"{family}-{whitened}"
    p = inputs["solve"][key]
    t1, t2 = out[0][f"solve/{key}"]
    _same_on_every_rank(out, f"solve/{key}")
    jm = _jmodel(p)
    x, y, s = (jnp.asarray(p[k]) for k in "xys")
    # the same micro-batch (64 / 2 rows a rank) as the single-device solve,
    # so that the whitening PCG's early exits group the same rows
    want = jm.batch_solve(jm.init_state(), x, y, s, batch_size=p["n"] // RANKS,
                          maxiter_cg=200)
    np.testing.assert_allclose(t1, np.asarray(want.theta1), rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(t2, np.asarray(want.theta2), rtol=1e-8, atol=1e-10)
    # and JAX's own data-parallel solve on a mesh of as many devices
    jdp = jdp_batch_solve(jm, jm.init_state(), x, y, s, jmake_mesh(RANKS), maxiter_cg=200)
    np.testing.assert_allclose(t1, np.asarray(jdp.theta1), rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(t2, np.asarray(jdp.theta2), rtol=1e-8, atol=1e-10)


def test_dp_batch_solve_uneven_n(cluster):
    # 61 rows over two ranks: one pad row, masked
    inputs, out, _ = cluster
    p = inputs["solve"]["uneven-61"]
    jm = _jmodel(p)
    want = jm.batch_solve(jm.init_state(), *(jnp.asarray(p[k]) for k in "xys"))
    np.testing.assert_allclose(out[0]["solve/uneven-61"][0], np.asarray(want.theta1),
                               rtol=1e-8, atol=1e-10)


def test_ell_fit_dp_matches_jax(cluster):
    inputs, out, _ = cluster
    p = inputs["ell_fit"]
    jm = _jmodel(p)
    _, jell, jells, jelbos = jell_fit(jm, jm.init_state(), *(jnp.asarray(p[k]) for k in "xys"),
                                      verbose=False, **p["kw"])
    for r in out:
        ell, ells, elbos, _ = r["ell_fit"]
        assert ells == pytest.approx(jells, rel=1e-15)
        assert ell == jell
        np.testing.assert_allclose(elbos, jelbos, rtol=1e-6)
    _same_on_every_rank(out, "ell_fit")


@pytest.mark.parametrize("key", ["cholesky", "ziggy-hyper"])
def test_dp_elbo_and_grads_matches_jax(cluster, key):
    # ziggy-hyper: the hyper-gradients through the whitening at 5 PCG
    # iterations (no early exit, so the row split does not matter)
    inputs, out, _ = cluster
    p = inputs["grads"][key]
    jm = _jmodel(p)
    e, g = jm.elbo_and_grads(_jstate(p, p["state"]), *(jnp.asarray(p[k]) for k in "xys"),
                             maxiter_cg=p["maxiter_cg"], weights=jnp.ones(p["n"]),
                             compute_hyper_grads=p["hyper"])
    for r in out:
        elbo, grads = r[f"grads/{key}"]
        np.testing.assert_allclose(elbo, float(e), rtol=1e-9)
        for k in ("theta1", "theta2"):
            np.testing.assert_allclose(grads[k], np.asarray(getattr(g, k)), rtol=1e-8,
                                       atol=1e-10)
        for k in ("log_sig2", "log_ell", "log_noise2"):
            np.testing.assert_allclose(grads[k], np.asarray(getattr(g, k)), rtol=1e-8,
                                       atol=1e-12)
    if p["hyper"]:
        assert abs(float(out[0]["grads/ziggy-hyper"][1]["log_ell"])) > 0


def test_dp_train_step_improves(cluster):
    _, out, _ = cluster
    elbos = out[0]["train_step"]
    assert elbos[-1] > elbos[0]
    assert out[1]["train_step"] == elbos


@pytest.mark.parametrize("key", list(FITS))
def test_dp_fit_matches_jax_svigp_fit(cluster, key):
    inputs, out, _ = cluster
    p = inputs["fits"][key]
    jm = _jmodel(p)
    jst, jrep = jsvigp_fit(jm, _jstate(p, p["state"]), jnp.asarray(p["x"]),
                           jnp.asarray(p["y"]), None if p["noise"] is None
                           else jnp.asarray(p["s"]), JFitConfig(**p["cfg"]), verbose=False,
                           **p["kw"])
    got = out[0][f"fits/{key}"]
    _same_on_every_rank(out, f"fits/{key}")
    for k in ("theta1", "theta2"):
        want = np.asarray(getattr(jst, k))
        # entrywise, the entries near zero held to 1e-7 of the largest
        np.testing.assert_allclose(got[k], want, rtol=1e-7, atol=1e-7 * np.abs(want).max())
    np.testing.assert_allclose(got["epoch_elbos"], jrep["epoch_elbos"], rtol=1e-8)
    for k in ("log_sig2", "log_ell", "log_noise2"):
        np.testing.assert_allclose(got[k], np.asarray(getattr(jst, k)), rtol=1e-7, atol=1e-12)
    # the port's own single-process fit: the same rows in the same batches,
    # summed in two parts
    tst, trep = svigp_fit(ranks.dp_model(p), ranks._state(p["state"]), p["x"], p["y"],
                          None if p["noise"] is None else p["s"], FitConfig(**p["cfg"]),
                          verbose=False, **p["kw"])
    for k in convert.STATE_FIELDS:
        np.testing.assert_allclose(got[k], getattr(tst, k).numpy(), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(got["epoch_elbos"], trep["epoch_elbos"], rtol=1e-12)
    if p["kw"].get("natgrad_safe_lr") == "clamp":
        np.testing.assert_allclose(got["rho"], jrep["natgrad_rho"], rtol=1e-7)
        np.testing.assert_allclose(got["lr_used"], jrep["lr_used"], rtol=1e-7)
        assert got["lr_used"] < p["cfg"]["lr"]  # the clamp took hold
    if p["cfg"].get("learn_kernel"):
        assert got["log_ell"] != pytest.approx(np.log(0.2), abs=1e-8)


@pytest.mark.parametrize("key", list(SVGP_FITS))
def test_dp_svgp_fit_matches_jax_svigp_fit(cluster, key):
    # the SVGP's step sums its batch's rows over the ranks as the HIP-GP's
    # does: KL, the kernel prior and the prior precision once (the last
    # batch's rows are all on rank 0; rank 1 holds only pad rows)
    inputs, out, _ = cluster
    p = inputs["svgp_fits"][key]
    jm = JSVGP(jkernels.SqExp(), jnp.asarray(p["xinduce"]), num_obs=p["n"],
               whitened=p["whitened"], sig2_init=1.3, ell_init=0.25)
    jst, jrep = jsvigp_fit(jm, jm.init_state(), *(jnp.asarray(p[k]) for k in "xys"),
                           JFitConfig(**p["cfg"]), verbose=False)
    got = out[0][f"svgp_fits/{key}"]
    _same_on_every_rank(out, f"svgp_fits/{key}")
    for k in ("theta1", "theta2"):
        want = np.asarray(getattr(jst, k))
        np.testing.assert_allclose(got[k], want, rtol=1e-7, atol=1e-7 * np.abs(want).max())
    for k in ("log_sig2", "log_ell"):
        np.testing.assert_allclose(got[k], np.asarray(getattr(jst, k)), rtol=1e-7, atol=1e-12)
    np.testing.assert_allclose(got["elbo_trace"], jrep["elbo_trace"], rtol=1e-8)
    # the port's own single-process fit of the same batches
    tm = ranks.svgp_model(p)
    tst, trep = svigp_fit(tm, tm.init_state(), p["x"], p["y"], p["s"],
                          FitConfig(**p["cfg"]), verbose=False)
    for k in ("theta1", "theta2", "log_sig2", "log_ell"):
        np.testing.assert_allclose(got[k], getattr(tst, k).numpy(), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(got["elbo_trace"], trep["elbo_trace"], rtol=1e-12)
    if p["cfg"]["learn_kernel"]:
        assert got["log_ell"] != pytest.approx(np.log(0.25), abs=1e-8)


def _csv_rows(path):
    with open(path) as f:
        return list(csv.reader(f))


def _assert_same_csv(got_path, want_path):
    got, want = _csv_rows(got_path), _csv_rows(want_path)
    assert len(got) == len(want) and got[0] == want[0]
    for g, w in zip(got[1:], want[1:]):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            try:
                fa, fb = float(a), float(b)
            except ValueError:
                assert a == b
                continue
            np.testing.assert_allclose(fa, fb, rtol=1e-7, atol=1e-12)


@pytest.mark.parametrize("method", ["natgrad", "full-batch"])
def test_harness_dp_writes_the_single_process_csvs(cluster, tmp_path, method):
    inputs, out, outdir = cluster
    p = inputs["harness"]
    _, st, rep = harness.fit_predict_and_save(
        name="dp", xobs=p["x"], yobs=p["y"], sobs=p["s"], xinduce_grids=p["grids"],
        whitened_type="cholesky", ell_init=0.2, noise2_init=0.04, sig2_init="marginal",
        fit_method=method, fit_config=FitConfig(**p["cfg"]), maxiter_cg=10,
        xtest=p["xt"], ftest=p["ft"], output_dir=str(tmp_path), dtype=torch.float64,
        device="cpu")
    got = [r[f"harness/{method}"] for r in out]
    # only the coordinator writes (each rank was given a directory of its
    # own); every rank returns the same state and report
    assert [g["wrote"] for g in got] == [True] + [False] * (RANKS - 1)
    for g in got:
        np.testing.assert_allclose(g["theta1"], st.theta1.numpy(), rtol=1e-7, atol=1e-10)
        np.testing.assert_allclose(g["epoch_elbos"], rep["epoch_elbos"], rtol=1e-8)
        np.testing.assert_allclose(g["fmu"], rep["pdict"]["fmu_test"], rtol=1e-7, atol=1e-10)
    for name in ("errordf-summary.csv", "noise_reduction.csv", "coverage_table.csv"):
        _assert_same_csv(os.path.join(outdir, f"harness-{method}-0", "dp", name),
                         str(tmp_path / "dp" / name))
    import json
    with open(os.path.join(outdir, f"harness-{method}-0", "dp", "fit_params.json")) as f:
        params = json.load(f)
    assert params["parallel"] == "dp" and params["mesh_shape"] == {"dp": RANKS}


def test_run_synthetic_parallel_dp_matches_single_process(cluster, tmp_path):
    _, out, outdir = cluster
    want = run_synthetic.main(DRIVER_ARGV + ["--output-dir", str(tmp_path)])
    for r in out:
        got = r["driver"]
        for k in ("first_elbo", "last_elbo", "test_rmse", "test_loglike"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-7)
        assert got["steps"] == want["steps"]
    assert [r["driver_wrote"] for r in out] == [True] + [False] * (RANKS - 1)
    _assert_same_csv(os.path.join(outdir, "driver-0", "errordf-summary.csv"),
                     str(tmp_path / "errordf-summary.csv"))


@pytest.mark.parametrize("name", list(DRIVERS))
def test_drivers_parallel_dp_match_single_process(cluster, tmp_path, name):
    import importlib

    _, out, outdir = cluster
    want = ranks._driver_out(importlib.import_module(
        f"hipgp_tpu_torch.experiments.{name}").main(
            DRIVERS[name] + ["--output-dir", str(tmp_path)]))
    for r in out:
        *got, wrote = r[f"drivers/{name}"]
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=1e-7, atol=1e-7 * np.abs(w).max())
    # the rank-0 artifacts, and none from the other rank
    assert [r[f"drivers/{name}"][-1] for r in out] == [True] + [False] * (RANKS - 1)
    if name != "run_domain":
        c = f"{name[4:]}-mean-field/errordf-summary.csv"
        _assert_same_csv(os.path.join(outdir, f"{name}-0", c), str(tmp_path / c))
        return
    # run_domain's metrics.csv, its seconds aside
    got, want = (dict(_csv_rows(os.path.join(d, "metrics.csv"))[1:])
                 for d in (os.path.join(outdir, f"{name}-0"), str(tmp_path)))
    keys = ("first_elbo", "last_elbo", "e_post_rmse", "e_loglike", "latent_rmse",
            "latent_corr", "sig2_init")
    for k in keys:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-7, err_msg=k)


def test_parallel_mp_mesh_and_run_synthetic(cluster, tmp_path):
    # init_parallel('mp'): JAX's default (1, world) ('dp', 'grid') mesh, the
    # coordinator writes; run_synthetic --parallel mp at a cut size against
    # the single-process run of the same model (DRIVER_MP_ARGV)
    _, out, outdir = cluster
    assert [r["init_parallel_mp"] for r in out] == [
        (("dp", "grid"), (1, RANKS), r == 0) for r in range(RANKS)]
    want = run_synthetic.main(DRIVER_MP_ARGV + ["--output-dir", str(tmp_path)])
    for r in out:
        got = r["driver_mp"]
        assert got["steps"] == want["steps"]
        for k in ("first_elbo", "last_elbo", "test_rmse", "test_loglike"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)
    assert [r["driver_mp_wrote"] for r in out] == [True] + [False] * (RANKS - 1)
    _assert_same_csv(os.path.join(outdir, "driver-mp-0", "errordf-summary.csv"),
                     str(tmp_path / "errordf-summary.csv"))
    # run_domain --parallel mp: its own fit path ('gram' split, mp_predict),
    # the same metrics on every rank, the gathered state written by rank 0
    dom = [r["run_domain_mp"] for r in out]
    for k in ("last_elbo", "e_post_rmse", "latent_rmse"):
        assert np.isfinite(dom[0][k]) and all(d[k] == dom[0][k] for d in dom), k
    assert dom[0]["e_post_rmse"] < dom[0]["e_rms"]
    assert [r["run_domain_mp_wrote"] for r in out] == [True] + [False] * (RANKS - 1)
