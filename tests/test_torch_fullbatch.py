"""Parity of the port's closed-form full-batch fit with the JAX package.

``HIPGP.batch_solve`` ('dense', 'cg', 'gram') under both whitenings, the
cholesky ``compute_kn``, ``predict(var_clamp=...)``, ``spd_solve``, the
lengthscale search ``ell_fit``, the shuffled natgrad fit, the metric frames,
the checkpoint files, the harness and the experiments, against the JAX package on
the same float64 inputs (numpy from a seed) and the same JAX ``init_state``
carried across with ``convert.state_from_numpy``.  Everything runs on the
CPU, where both whitenings take their plain paths; grids of 12^2, 200
observations, batches of 16 (200 rows pad to 208: the last 8 are masked)
or 20.
"""
import csv
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
torch.set_num_threads(1)  # one intra-op thread a process: the xdist workers share the cores

from hipgp_tpu import kernels as jkernels
from hipgp_tpu.experiments import harness as jharness
from hipgp_tpu.infer import FitConfig as JFitConfig
from hipgp_tpu.infer import ell_fit as jell_fit
from hipgp_tpu.infer import predictive_variance_correction as jpvc
from hipgp_tpu.infer import svigp_fit as jsvigp_fit
from hipgp_tpu.models import HIPGP as JHIPGP
from hipgp_tpu.ops import spd_inverse as jspd_inverse
from hipgp_tpu.ops import spd_solve as jspd_solve
from hipgp_tpu.utils import checkpoint as jckpt
from hipgp_tpu.utils import metrics as jmetrics
from hipgp_tpu_torch import convert
from hipgp_tpu_torch import kernels as tkernels
from hipgp_tpu_torch.experiments import harness, run_domain, run_synthetic
from hipgp_tpu_torch.infer import (FitConfig, ell_fit, predictive_variance_correction,
                                   svigp_fit)
from hipgp_tpu_torch.models import HIPGP
from hipgp_tpu_torch.models.hipgp import MEAN_PCG_STATS
from hipgp_tpu_torch.ops import solve as tsolve
from hipgp_tpu_torch.ops import spd_inverse, spd_solve
from hipgp_tpu_torch.utils import checkpoint, metrics

N, M1, ELL = 200, 12, 0.2
GRIDS = [np.linspace(-1, 1, M1)] * 2
SOLVERS = ["dense", "cg", "gram"]
WHITENINGS = ["ziggy", "cholesky"]


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _rel(got, want):
    got, want = _np(got), _np(want)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    x = rng.uniform(-0.95, 0.95, (N, 2))
    f = np.sin(3 * x[:, 0]) * np.cos(2 * x[:, 1])
    s = rng.uniform(0.03, 0.08, N)
    y = f + s * rng.standard_normal(N)
    xt = rng.uniform(-0.9, 0.9, (60, 2))
    ft = np.sin(3 * xt[:, 0]) * np.cos(2 * xt[:, 1])
    return x, y, s, xt, ft


def _build(wt):
    jm = JHIPGP(jkernels.SqExp(), [jnp.asarray(g) for g in GRIDS], num_obs=N,
                whitened_type=wt, sig2_init=0.5, ell_init=ELL, noise2_init=0.01,
                init_Svar=1.0, dtype=jnp.float64)
    tm = HIPGP(tkernels.SqExp(), GRIDS, num_obs=N, whitened_type=wt, sig2_init=0.5,
               ell_init=ELL, noise2_init=0.01, init_Svar=1.0, dtype=torch.float64,
               device="cpu")
    js = jm.init_state(jax.random.PRNGKey(3))
    ts = convert.state_from_numpy(
        {k: np.asarray(getattr(js, k)) for k in convert.STATE_FIELDS}, device="cpu")
    return jm, tm, js, ts


@pytest.fixture(scope="module")
def pairs():
    # one model pair per whitening for the module: the JAX stage functions
    # are memoized on the model, so their compiles are paid once
    return {wt: _build(wt) for wt in WHITENINGS}


def _both_solves(pair, data, noise, batch_size, **kw):
    jm, tm, js, ts = pair
    x, y, s = data[:3]
    ns = s if noise else None
    jst, je = jm.batch_solve(js, jnp.asarray(x), jnp.asarray(y),
                             None if ns is None else jnp.asarray(ns),
                             batch_size=batch_size, compute_elbo=True, **kw)
    tst, te = tm.batch_solve(ts, x, y, ns, batch_size=batch_size, compute_elbo=True, **kw)
    return (jst, float(je)), (tst, float(te))


def _assert_state_elbo(j, t):
    # theta2 entrywise; theta1 in norm (its entries near zero carry the
    # unconverged mean PCG's rounding, ~1e-10 absolute)
    (jst, je), (tst, te) = j, t
    np.testing.assert_allclose(_np(tst.theta2), _np(jst.theta2), rtol=1e-9)
    assert _rel(tst.theta1, jst.theta1) <= 1e-5
    assert te == pytest.approx(je, rel=1e-8)


@pytest.mark.parametrize("whitened", WHITENINGS)
@pytest.mark.parametrize("solver", SOLVERS)
def test_batch_solve_matches_jax(pairs, data, solver, whitened):
    # heteroscedastic noise, 13 batches of 16, the last one padded with 8
    # masked rows, maxiter_cg 10 (truncated whitening in both), the mean
    # solvers at their defaults (200, 1e-8): the same algorithm on the same
    # float64 inputs, theta2 to rounding; theta1 of 'cg' and 'gram' follows
    # an unconverged mean PCG, 1e-5
    j, t = _both_solves(pairs[whitened], data, True, 16, maxiter_cg=10,
                        mean_solver=solver)
    _assert_state_elbo(j, t)


@pytest.mark.parametrize("solver", SOLVERS)
def test_batch_solve_without_noise_std_matches_jax(pairs, data, solver):
    # without noise_std the rows' precision is w exp(-log_noise2); 10
    # batches of 20, none padded
    j, t = _both_solves(pairs["ziggy"], data, False, 20, maxiter_cg=10,
                        mean_solver=solver)
    _assert_state_elbo(j, t)


def test_compute_kn_cholesky_matches_jax(pairs, data):
    jm, tm, js, ts = pairs["cholesky"]
    x = data[0][:40]
    jknm, _ = jm.make_grams(js, jnp.asarray(x))
    tknm, _ = tm.make_grams(ts, torch.as_tensor(x))
    assert tm.Mprime == tm.M == M1 * M1
    np.testing.assert_allclose(_np(tm.compute_kn(ts, tknm)), _np(jm.compute_kn(js, jknm)),
                               rtol=1e-10, atol=1e-13)
    # ziggy's tol reaches the PCG: a loose tol stops the solve early
    _, tm, _, ts = pairs["ziggy"]
    loose = tm.compute_kn(ts, tknm, maxiter_cg=50, tol=1e-2)
    assert _rel(loose, tsolve.whiten(tm.spectrum(ts), tknm, maxiter=50, tol=1e-2)) == 0
    assert _rel(loose, tm.compute_kn(ts, tknm, maxiter_cg=50)) > 1e-6


@pytest.mark.parametrize("whitened", WHITENINGS)
def test_predict_var_clamp_matches_jax(pairs, data, whitened):
    # a clamp that bites (0.05 > Knn - kn.kn at most points) and the default
    jm, tm, js, ts = pairs[whitened]
    xt = torch.as_tensor(data[3])
    jmu, jsig = jm.predict(js, jnp.asarray(data[3]), var_clamp=0.05)
    tmu, tsig = tm.predict(ts, xt, var_clamp=0.05)
    np.testing.assert_allclose(_np(tmu), _np(jmu), rtol=1e-10, atol=1e-13)
    np.testing.assert_allclose(_np(tsig), _np(jsig), rtol=1e-10)
    assert float(torch.min(tsig)) >= 0.05 ** 0.5
    # the default is the JAX default, 1e-5
    default = tm.predict(ts, xt)[1]
    assert _rel(default, tm.predict(ts, xt, var_clamp=1e-5)[1]) == 0
    assert _rel(default, tsig) > 1e-3


@pytest.mark.parametrize("whitened", WHITENINGS)
def test_gram_matches_dense_converged(pairs, data, whitened):
    # the port's counterpart of the JAX test_batch_solve_gram_mean_solver_
    # matches_dense: converged whitening and mean solve, the Woodbury
    # collapse gives the dense optimum
    _, tm, _, ts = pairs[whitened]
    x, y, s = data[:3]
    dense, e_dense = tm.batch_solve(ts, x, y, s, batch_size=20, maxiter_cg=300,
                                    compute_elbo=True)
    gram, e_gram = tm.batch_solve(ts, x, y, s, batch_size=20, maxiter_cg=300,
                                  mean_solver="gram", mean_solver_maxiter=800,
                                  mean_solver_tol=1e-14, compute_elbo=True)
    if whitened == "ziggy":   # the K + A PCG reports its run
        st = MEAN_PCG_STATS
        assert 0 < st["iterations"] <= 800 and st["resnorm"] <= 1e-9 * st["bnorm"]
    np.testing.assert_allclose(_np(gram.theta2), _np(dense.theta2), rtol=1e-9)
    np.testing.assert_allclose(_np(gram.theta1), _np(dense.theta1), rtol=1e-4, atol=1e-7)
    assert float(e_gram) == pytest.approx(float(e_dense), rel=1e-6)


def test_gram_through_the_kernel_a_structure(pairs, data, monkeypatch):
    # kernel A's gate opened on the CPU: the sweep's whitening runs the fused
    # self-dot PCG and R^T through kernel A's Functions (plain versions);
    # one whitening solve, the same state and ELBO as the generic route
    _, tm, _, ts = pairs["ziggy"]
    x, y, s = data[:3]
    kw = dict(batch_size=-1, maxiter_cg=10, mean_solver="gram", compute_elbo=True)
    generic, e_generic = tm.batch_solve(ts, x, y, s, **kw)
    monkeypatch.setattr(tsolve, "_mxu2d_solver_ok",
                        lambda spec, dtype, device: len(spec.dims) == 2)
    tsolve.PCG_STATS.update(solves=0, iterations=0)
    fused, e_fused = tm.batch_solve(ts, x, y, s, **kw)
    assert tsolve.PCG_STATS["solves"] == 1
    assert 0 < tsolve.PCG_STATS["iterations"] <= 10
    np.testing.assert_allclose(_np(fused.theta2), _np(generic.theta2), rtol=1e-9)
    np.testing.assert_allclose(_np(fused.theta1), _np(generic.theta1), rtol=1e-5)
    assert float(e_fused) == pytest.approx(float(e_generic), rel=1e-8)


@pytest.fixture(scope="module")
def gram_sums():
    # the 'gram' sweep's (A, b_m) on the 2-D protocol's data (the "medium"
    # surface, noise 0.01), 1000 rows in one batch, SqExp at ell 0.1 over a
    # 32^2 grid: {(Knm dtype, accumulator dtype): (A, b_m)}, and the float64
    # model's dense K (kappa(K + A) is about 6e6, as on the protocol's 64^2
    # grid at ell 0.05 and 2000 rows)
    from hipgp_tpu_torch.experiments.synthetic_data import make_two_dim_data
    from hipgp_tpu_torch.infer.fit import prepare_batches
    from hipgp_tpu_torch.models import hipgp as thipgp
    from hipgp_tpu_torch.ops import matmul_by_K

    d = make_two_dim_data(Nobs=1000, Ntest=10, noise_std=0.01, gridnum=64, seed=42)
    sig2 = run_synthetic.marginal_sig2(d["yobs"], d["sobs"])
    flags = dict(integrated_obs=False, semi_integrated_estimator="analytic",
                 semi_integrated_samps=10, generator=None)
    out = {}
    for dt in (torch.float64, torch.float32):
        m = run_synthetic.build_model("SqExp", 32, 1000, sig2, 0.1, 0.01, dtype=dt,
                                      device="cpu")
        st = m.init_state()
        as_t = lambda a: torch.as_tensor(a, dtype=dt)
        xb, yb, sb, w = prepare_batches(as_t(d["xobs"]), as_t(d["yobs"]),
                                        as_t(d["sobs"]), 1000)
        for acc in (torch.float64, torch.float32)[:1 + (dt == torch.float32)]:
            thipgp.GRAM_ACC_DTYPE, saved = acc, thipgp.GRAM_ACC_DTYPE
            try:
                # maxiter_cg=1: the kn of Lambda do not enter A or b_m
                _, A, bm = m._gram_sweep(st, m.spectrum(st), (xb, yb, w, sb), flags, 1)[:3]
            finally:
                thipgp.GRAM_ACC_DTYPE = saved
            out[(dt, acc)] = (A.double(), bm.double())
        if dt == torch.float64:
            K = matmul_by_K(m.spectrum(st), torch.eye(m.M, dtype=dt))
    return out, K


@pytest.mark.parametrize("acc,limit", [(torch.float64, 1e-4), (torch.float32, 5e-3)])
def test_gram_accumulates_in_float64(gram_sums, acc, limit):
    # why GRAM_ACC_DTYPE is float64: from float32 Knm, A and b_m summed in
    # float64 give the float64 mean z = (K + A)^{-1} b_m to within 1e-4
    # (the sums alone: both solved densely in float64), summed in float32
    # they miss it by more than 5e-3, so no mean solver could recover it
    from hipgp_tpu_torch.models.hipgp import GRAM_ACC_DTYPE

    sums, K = gram_sums
    z64 = torch.linalg.solve(K + sums[(torch.float64, torch.float64)][0],
                             sums[(torch.float64, torch.float64)][1])
    A, bm = sums[(torch.float32, acc)]
    err = _rel(torch.linalg.solve(K + A, bm), z64)
    if acc == GRAM_ACC_DTYPE:
        assert err <= limit
    else:
        assert err > limit


def test_ell_fit_matches_jax(pairs, data):
    jm, tm, js, ts = pairs["ziggy"]
    x, y, s = data[:3]
    # the mean PCG converged: at ell 0.3 its 200-iteration default stops on
    # an iterate whose ELBO carries rounding at 4e-7
    kw = dict(ell_min=0.1, ell_max=0.3, ell_step_size=0.1, batch_solve_bsz=20,
              maxiter_cg=10, verbose=False, mean_solver="gram",
              mean_solver_maxiter=2000, mean_solver_tol=1e-12)
    jbest, jell, jells, jelbos = jell_fit(jm, js, x, y, s, **kw)
    tbest, tell, tells, telbos = ell_fit(tm, ts, x, y, s, **kw)
    assert tells == pytest.approx(jells, rel=1e-15)
    np.testing.assert_allclose(telbos, jelbos, rtol=1e-8)
    assert tell == jell
    np.testing.assert_allclose(_np(tbest.theta2), _np(jbest.theta2), rtol=1e-9)
    assert float(torch.exp(tbest.log_ell)) == pytest.approx(tell, rel=1e-12)


def test_svigp_fit_shuffled_epoch_matches_jax(pairs, data):
    # one epoch of 4 natgrad steps over rows permuted by
    # np.random.default_rng(3), in both packages; a constant lr (optax rounds
    # a scheduled one to float32, see test_torch_hipgp)
    jm, tm, js, ts = pairs["ziggy"]
    x, y, s = data[:3]
    jcfg = JFitConfig(epochs=1, batch_size=50, lr=1e-2, maxiter_cg=10, shuffle=True,
                      seed=3, schedule_lr=False)
    tcfg = FitConfig(**{f.name: getattr(jcfg, f.name)
                        for f in dataclasses.fields(FitConfig)})
    jst, jrep = jsvigp_fit(jm, js, x, y, s, jcfg, verbose=False)
    tst, trep = svigp_fit(tm, ts, x, y, s, tcfg, verbose=False)
    np.testing.assert_allclose(trep["elbo_trace"], jrep["elbo_trace"], rtol=1e-8)
    for k in ("theta1", "theta2"):
        assert _rel(getattr(tst, k), getattr(jst, k)) <= 1e-8
    unshuffled, _ = svigp_fit(tm, ts, x, y, s, dataclasses.replace(tcfg, shuffle=False),
                              verbose=False)
    assert _rel(unshuffled.theta1, tst.theta1) > 1e-6


@pytest.mark.parametrize("error_on_nonfinite", [True, False])
def test_svigp_fit_nonfinite_epochs(pairs, data, error_on_nonfinite):
    # a NaN observation makes every epoch's ELBO NaN: raise, or grind on to
    # the last epoch as the reference does
    _, tm, _, ts = pairs["ziggy"]
    x, y, s = data[:3]
    y = y.copy()
    y[7] = np.nan
    cfg = FitConfig(epochs=2, batch_size=100, maxiter_cg=5,
                    error_on_nonfinite=error_on_nonfinite)
    if error_on_nonfinite:
        with pytest.raises(RuntimeError, match="non-finite"):
            svigp_fit(tm, ts, x, y, s, cfg, verbose=False)
    else:
        _, rep = svigp_fit(tm, ts, x, y, s, cfg, verbose=False)
        assert len(rep["epoch_elbos"]) == 2 and rep["steps"] == 4
        assert not np.isfinite(rep["epoch_elbos"]).any()


def test_predictive_variance_correction_matches_jax(pairs, data):
    jm, tm, js, ts = pairs["ziggy"]
    x, y, s = data[:3]
    want = jpvc(jm, js, x[:80], y[:80], s[:80], maxiter_cg=20)
    got = predictive_variance_correction(tm, ts, x[:80], y[:80], s[:80], maxiter_cg=20)
    assert got == pytest.approx(want, rel=1e-10)


def test_spd_solve_and_inverse_match_jax():
    rng = np.random.default_rng(4)
    G = rng.standard_normal((3, 9, 9))
    A = G @ np.swapaxes(G, -1, -2) + 9 * np.eye(9)
    b = rng.standard_normal((3, 9))
    B = rng.standard_normal((3, 9, 2))
    for got, want in ((spd_solve(torch.as_tensor(A), torch.as_tensor(b)),
                       jspd_solve(jnp.asarray(A), jnp.asarray(b))),
                      (spd_solve(torch.as_tensor(A), torch.as_tensor(B)),
                       jspd_solve(jnp.asarray(A), jnp.asarray(B))),
                      (spd_inverse(torch.as_tensor(A)), jspd_inverse(jnp.asarray(A)))):
        assert got.shape == want.shape
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-12, atol=1e-14)


def test_unported_options_raise(pairs, data):
    # the block and full-rank families and the standard parameterization
    # build (section A item 5 is ported); an unknown family,
    # parameterization or whitening raises ValueError, as in JAX
    blk = HIPGP(tkernels.SqExp(), GRIDS, num_obs=N, family="block", block_sizes=(4, 4),
                device="cpu")
    assert (blk.num_blocks, blk.block_size) == (36, 16)
    std = HIPGP(tkernels.SqExp(), GRIDS, num_obs=N, family="full-rank",
                parameterization="standard", device="cpu")
    assert std.init_state().theta2.shape == (std.Mprime, std.Mprime)
    for bad in (dict(family="diagonal"), dict(parameterization="natural"),
                dict(whitened_type="dense")):
        with pytest.raises(ValueError):
            HIPGP(tkernels.SqExp(), GRIDS, num_obs=N, device="cpu", **bad)
    _, tm, _, ts = pairs["ziggy"]
    x, y, s = data[:3]
    with pytest.raises(ValueError, match="mean_solver='nope'"):
        tm.batch_solve(ts, x, y, s, mean_solver="nope")


def _preds(seed, integrated, valid=False):
    rng = np.random.default_rng(seed)
    n = 40
    p = {"ftest": rng.standard_normal(n), "fmu_test": rng.standard_normal(n),
         "fsig_test": rng.uniform(0.2, 2.0, n)}
    if integrated:
        p.update(etest=rng.standard_normal(n), emu_test=rng.standard_normal(n),
                 esig_test=rng.uniform(0.2, 2.0, n))
    if valid:
        p.update(fvalid=rng.standard_normal(n), fmu_valid=rng.standard_normal(n),
                 fsig_valid=rng.uniform(0.2, 2.0, n))
    return p


def _csv_rows(path):
    with open(path) as f:
        return list(csv.reader(f))


def _assert_same_csv(got_path, want_path, rtol=1e-12, atol=1e-300):
    got, want = _csv_rows(got_path), _csv_rows(want_path)
    assert got[0] == want[0] and len(got) == len(want)
    for g, w in zip(got[1:], want[1:]):
        assert g[0] == w[0] or float(g[0]) == float(w[0])
        for a, b in zip(g[1:], w[1:]):
            assert (a == "") == (b == "")
            if a:
                assert float(a) == pytest.approx(float(b), rel=rtol, abs=atol)


def test_error_frame_and_describe_match_pandas(tmp_path):
    preds = {"a": _preds(0, True), "b": _preds(1, False)}
    got = metrics.error_frame(preds)
    want = jmetrics.error_frame(preds)
    assert list(got) == list(want.columns)
    for c in want.columns:
        if c == "model":
            assert list(got[c]) == list(want[c])
        else:
            np.testing.assert_allclose(got[c], want[c].to_numpy(np.float64), rtol=1e-14)
    metrics.write_csv(tmp_path / "got.csv", metrics.describe(got))
    want.describe().to_csv(tmp_path / "want.csv")
    _assert_same_csv(tmp_path / "got.csv", tmp_path / "want.csv")


@pytest.mark.parametrize("integrated,valid", [(False, False), (True, True)])
def test_noise_comparison_frame_matches_pandas(tmp_path, integrated, valid):
    p = _preds(2, integrated, valid)
    kw = dict(integrated_obs=integrated, train_elbo=-1.25, eval_valid=valid)
    metrics.write_csv(tmp_path / "got.csv", metrics.noise_comparison_frame(p, 0.3, **kw))
    jmetrics.noise_comparison_frame(p, 0.3, **kw).to_csv(tmp_path / "want.csv")
    _assert_same_csv(tmp_path / "got.csv", tmp_path / "want.csv")


def test_coverage_qq_and_histogram_match_jax(tmp_path):
    z = {"model": np.r_[np.random.default_rng(5).standard_normal(300), np.nan],
         "model e": np.random.default_rng(6).standard_normal(300) * 1.3}
    metrics.write_csv(tmp_path / "got.csv", metrics.coverage_table(z))
    jmetrics.coverage_table(z).to_csv(tmp_path / "want.csv")
    _assert_same_csv(tmp_path / "got.csv", tmp_path / "want.csv", rtol=1e-15)
    for got, want in zip(metrics.qq_data(z["model"]), jmetrics.qq_data(z["model"])):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(metrics.zscore_histogram_data(z["model e"], bins=12),
                         jmetrics.zscore_histogram_data(z["model e"], bins=12)):
        np.testing.assert_array_equal(got, want)


def test_checkpoint_from_jax_loads_in_the_port(pairs, tmp_path):
    jm, tm, js, ts = pairs["ziggy"]
    st = js.replace(theta1=js.theta1 * 1.5, log_ell=js.log_ell + 0.25)
    jckpt.save_checkpoint(str(tmp_path), st, step=7)
    got = checkpoint.load_pytree(str(tmp_path / "state.npz"), ts)
    for k in convert.STATE_FIELDS:
        np.testing.assert_array_equal(_np(getattr(got, k)), np.asarray(getattr(st, k)))
        assert getattr(got, k).dtype == torch.float64
    assert os.path.exists(tmp_path / "meta.json")


def test_checkpoint_from_the_port_loads_in_jax(pairs, tmp_path):
    jm, tm, js, ts = pairs["cholesky"]
    st = ts.replace(theta2=ts.theta2 * 0.75, log_noise2=ts.log_noise2 - 1.0)
    checkpoint.save_checkpoint(str(tmp_path), st, step=3)
    got = jckpt.load_pytree(str(tmp_path / "state.npz"), js)
    for k in convert.STATE_FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(got, k)), _np(getattr(st, k)))
    # the same files as the JAX package writes: leaves, sidecar and meta
    jckpt.save_checkpoint(str(tmp_path / "j"), got, step=3)
    for name in ("state.npz.treedef.json", "meta.json"):
        with open(tmp_path / name) as a, open(tmp_path / "j" / name) as b:
            assert a.read() == b.read()
    _, _, step = jckpt.restore_checkpoint(str(tmp_path), js)
    assert step == 3


def test_fit_predict_and_save_full_batch_matches_jax(data, tmp_path):
    # the same harness run in both packages: the closed-form 'gram' fit
    # (its mean PCG converged, so the predictions agree to rounding),
    # prediction of 60 test points, the metric CSVs column by column
    x, y, s, xt, ft = data
    kw = dict(name="run", xobs=x, yobs=y, sobs=s, xinduce_grids=GRIDS, kernel="SqExp",
              sig2_init="marginal", ell_init=ELL, noise2_init=0.01,
              fit_method="full-batch", fit_config=None, batch_solve_bsz=20,
              maxiter_cg=10, mean_solver="gram", mean_solver_maxiter=2000,
              mean_solver_tol=1e-12, xtest=xt, ftest=ft)
    jharness.fit_predict_and_save(output_dir=str(tmp_path / "jax"), dtype=jnp.float64,
                                  **kw)
    _, _, rep = harness.fit_predict_and_save(output_dir=str(tmp_path / "torch"),
                                             dtype=torch.float64, device="cpu", **kw)
    for name in ("errordf-summary.csv", "noise_reduction.csv", "coverage_table.csv"):
        _assert_same_csv(tmp_path / "torch" / "run" / name,
                         tmp_path / "jax" / "run" / name, rtol=1e-7, atol=1e-10)
    # the same files, the figures included (matplotlib imports here)
    assert sorted(os.listdir(tmp_path / "torch" / "run")) == sorted(
        os.listdir(tmp_path / "jax" / "run"))
    with open(tmp_path / "torch" / "run" / "time_report.csv") as f:
        assert next(csv.reader(f)) == list(pd.read_csv(
            tmp_path / "jax" / "run" / "time_report.csv").columns)
    assert rep["pdict"]["fmu_test"].shape == (60,)


def test_fit_predict_and_save_epoch_evaluations_match_jax(data, tmp_path, monkeypatch):
    # a natgrad harness run of two epochs with eval_epochs=1: the full
    # evaluation after each epoch into epoch_output/epoch_N/, in both
    # packages; then only_eval_last_epoch in the port keeps the last only.
    # The port's init_state draws theta1 as JAX's does, from PRNGKey(0)
    x, y, s, xt, ft = data
    init_state = HIPGP.init_state

    def jax_init_state(self, generator=None):
        st = init_state(self, generator)
        t1 = np.sqrt(2.0 / (self.Mprime + 1)) * np.asarray(
            jax.random.normal(jax.random.PRNGKey(0), (self.Mprime,), jnp.float64))
        return st.replace(theta1=torch.as_tensor(t1, dtype=self.dtype))

    monkeypatch.setattr(HIPGP, "init_state", jax_init_state)
    jcfg = JFitConfig(epochs=2, batch_size=50, lr=1e-2, maxiter_cg=10,
                      schedule_lr=False, predict_maxiter_cg=50)
    tcfg = FitConfig(**{f.name: getattr(jcfg, f.name)
                        for f in dataclasses.fields(FitConfig)})
    kw = dict(name="run", xobs=x, yobs=y, sobs=s, xinduce_grids=GRIDS, kernel="SqExp",
              sig2_init="marginal", ell_init=ELL, noise2_init=0.01,
              fit_method="natgrad", maxiter_cg=10, eval_epochs=1, xtest=xt, ftest=ft)
    jharness.fit_predict_and_save(output_dir=str(tmp_path / "jax"), dtype=jnp.float64,
                                  fit_config=jcfg, **kw)
    _, _, rep = harness.fit_predict_and_save(output_dir=str(tmp_path / "torch"),
                                             dtype=torch.float64, device="cpu",
                                             fit_config=tcfg, **kw)
    assert [r["epoch"] for r in rep["epoch_eval_rows"]] == [0, 1]
    for epoch in ("epoch_0", "epoch_1"):
        for name in ("errordf-summary.csv", "coverage_table.csv"):
            _assert_same_csv(tmp_path / "torch" / "run" / "epoch_output" / epoch / name,
                             tmp_path / "jax" / "run" / "epoch_output" / epoch / name,
                             rtol=1e-7, atol=1e-10)
    with open(tmp_path / "torch" / "run" / "time_report.csv") as f:
        assert next(csv.reader(f)) == list(pd.read_csv(
            tmp_path / "jax" / "run" / "time_report.csv").columns)
    _, _, rep = harness.fit_predict_and_save(
        output_dir=str(tmp_path / "last"), dtype=torch.float64, device="cpu",
        fit_config=dataclasses.replace(tcfg, only_eval_last_epoch=True), **kw)
    assert [r["epoch"] for r in rep["epoch_eval_rows"]] == [1]
    assert os.listdir(tmp_path / "last" / "run" / "epoch_output") == ["epoch_1"]


def test_run_domain_full_batch_default_on_cpu(tmp_path):
    # the JAX run_domain's defaults: --fit-method full-batch --mean-solver dense;
    # then the paper-scale grid's solver, 'matfree', on the same small grid
    out = run_domain.main(["--device", "cpu", "--nobs", "300", "--ntest", "40",
                           "--nx", "6", "--nz", "4", "--output-dir", str(tmp_path)])
    assert out["fit_method"] == "full-batch" and out["steps"] == 0
    assert np.isfinite(out["last_elbo"]) and np.isfinite(out["e_post_rmse"])
    assert out["e_post_rmse"] < out["e_rms"]
    mf = run_domain.main(["--device", "cpu", "--nobs", "300", "--ntest", "40",
                          "--nx", "6", "--nz", "4", "--mean-solver", "matfree",
                          "--output-dir", str(tmp_path / "matfree")])
    assert np.isfinite(mf["last_elbo"]) and mf["e_post_rmse"] < mf["e_rms"]
    assert 0 < mf["mean_pcg_iterations"] <= 200
    assert {"fit_sweep_s", "fit_mean_s", "fit_elbo_s"} <= set(mf)


def test_run_synthetic_full_batch_gram_on_cpu(tmp_path, capsys):
    out = run_synthetic.main(["--device", "cpu", "--nobs", "400", "--ntest", "80",
                              "--num-inducing", "12", "--gridnum", "8", "--f64",
                              "--fit-method", "full-batch", "--mean-solver", "gram",
                              "--ell-sweep", "0.2", "0.4", "0.2",
                              "--output-dir", str(tmp_path)])
    assert out["fit_method"] == "full-batch" and np.isfinite(out["last_elbo"])
    assert np.isfinite(out["test_rmse"])
    with open(tmp_path / "ell_sweep.csv") as f:
        rows = list(csv.reader(f))
    # np.arange(0.2, 0.4 + 0.2, 0.2) holds 0.2, 0.4 and 0.6000000000000001
    assert rows[0] == ["ell", "elbo"] and len(rows) == 4
    with open(tmp_path / "errordf-summary.csv") as f:
        assert next(csv.reader(f))[:2] == ["model", "post-rmse"]
    assert "ell sweep selected" in capsys.readouterr().out


def test_port_imports_no_pandas():
    # the card's machine has no pandas: every module of the port, the
    # harness and the metric frames included, and the chip script import
    # none (nor JAX, test_torch_ops.py::test_port_imports_no_jax)
    import subprocess
    import sys

    code = ("import importlib, pkgutil, sys, hipgp_tpu_torch;"
            "mods = [m.name for m in pkgutil.walk_packages("
            "hipgp_tpu_torch.__path__, 'hipgp_tpu_torch.')];"
            "[importlib.import_module(m) for m in mods];"
            "import chip_smoke;"
            "assert {'hipgp_tpu_torch.experiments.harness',"
            " 'hipgp_tpu_torch.utils.checkpoint'} <= set(mods), mods;"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('pandas', 'jax')];"
            "assert not bad, bad")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], cwd=repo, check=True, timeout=120)
