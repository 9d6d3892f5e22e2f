"""Parity of the port's line-integral observations with the JAX package.

The inter-domain cross-covariances, the integrated branch of the model, the
natural-gradient stability estimate and clamp, a warm-started integrated
natgrad fit, the section 5.5 experiment and a 3-D state round trip, all on the
CPU in float64.  Inputs are made with numpy from seeds and handed to both
packages; random draws (the Monte-Carlo offset, the init state) are passed
in explicitly.
"""
import csv
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # one intra-op thread a process: the xdist workers share the cores

from hipgp_tpu import kernels as jkernels
from hipgp_tpu.experiments import run_domain as jrun_domain
from hipgp_tpu.experiments.harness import empirical_sig2_init as jempirical_sig2_init
from hipgp_tpu.infer import FitConfig as JFitConfig
from hipgp_tpu.infer import svigp_fit as jsvigp_fit
from hipgp_tpu.infer.fit import natgrad_stability_rho as jrho
from hipgp_tpu.infer.fit import prepare_batches as jprepare_batches
from hipgp_tpu.kernels import interdomain as jinter
from hipgp_tpu.models import HIPGP as JHIPGP
from hipgp_tpu_torch import convert
from hipgp_tpu_torch import kernels as tkernels
from hipgp_tpu_torch.experiments import run_domain
from hipgp_tpu_torch.infer import FitConfig, batch_predict, svigp_fit
from hipgp_tpu_torch.infer.fit import natgrad_stability_rho, prepare_batches
from hipgp_tpu_torch.kernels import interdomain as tinter
from hipgp_tpu_torch.models import HIPGP

ELL = 0.2
SIG2 = 0.7


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _rel(got, want):
    got, want = _np(got), _np(want)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _points(seed, n, lo=-1.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, (n, 3))


def _params(ell=ELL):
    return ((torch.tensor(SIG2, dtype=torch.float64),
             torch.as_tensor(ell, dtype=torch.float64)),
            (jnp.asarray(SIG2), jnp.asarray(ell)))


@pytest.mark.parametrize("ell", [ELL, np.array([0.15, 0.25, 0.3])])
def test_k_semi_sqexp_matches_jax(ell):
    xp, xi = _points(0, 40), _points(1, 25)
    xi[0] = 0.0   # a ray of length zero: the a >= 1e-30 guard
    tp, jp = _params(ell)
    got = tinter.k_semi_sqexp(torch.as_tensor(xp), torch.as_tensor(xi), tp)
    want = jinter.k_semi_sqexp(jnp.asarray(xp), jnp.asarray(xi), jp)
    assert got.shape == (40, 25)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-10, atol=1e-14)


def test_k_semi_sqexp_matches_quadrature_oracle():
    xp, xi = _points(2, 15), _points(3, 10)
    tp, _ = _params()
    k = tkernels.SqExp()
    kernel_np = lambda a, b: k(torch.as_tensor(a), torch.as_tensor(b), tp).numpy()
    got = tinter.k_semi_sqexp(torch.as_tensor(xp), torch.as_tensor(xi), tp)
    want = tinter.k_semi_quad(kernel_np, xp, xi, order=200)
    np.testing.assert_allclose(_np(got), want, rtol=1e-8, atol=1e-12)


def test_quadrature_oracles_match_jax():
    k = tkernels.SqExp()
    tp, jp = _params()
    tk = lambda a, b: k(torch.as_tensor(a), torch.as_tensor(b), tp).numpy()
    jk = lambda a, b: np.asarray(jkernels.SqExp()(jnp.asarray(a), jnp.asarray(b), jp))
    xp, xi = _points(4, 6), _points(5, 7)
    np.testing.assert_allclose(tinter.k_semi_quad(tk, xp, xi, order=50),
                               jinter.k_semi_quad(jk, xp, xi, order=50), rtol=1e-12)
    np.testing.assert_allclose(tinter.k_doubly_diag_quad(tk, xi, order=40),
                               jinter.k_doubly_diag_quad(jk, xi, order=40), rtol=1e-12)


@pytest.mark.parametrize("name,npts", [("SqExp", 5), ("Mat32", 7)])
def test_k_semi_mc_matches_jax_with_the_same_offset(name, npts):
    xp, xi = _points(6, 30), _points(7, 12)
    tp, jp = _params()
    key = jax.random.PRNGKey(9)
    u = float(jax.random.uniform(key, (), dtype=jnp.float64) * (1.0 / npts))
    got = tinter.k_semi_mc(tkernels.kernel_from_name(name), torch.as_tensor(xp),
                           torch.as_tensor(xi), tp, npts=npts, u=u)
    want = jinter.k_semi_mc(key, jkernels.kernel_from_name(name), jnp.asarray(xp),
                            jnp.asarray(xi), jp, npts=npts)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-10, atol=1e-14)


def test_k_semi_mc_generator_draw():
    xp, xi = _points(8, 5), _points(9, 4)
    tp, _ = _params()
    k = tkernels.SqExp()
    a = tinter.k_semi_mc(k, torch.as_tensor(xp), torch.as_tensor(xi), tp,
                         generator=torch.Generator().manual_seed(3))
    b = tinter.k_semi_mc(k, torch.as_tensor(xp), torch.as_tensor(xi), tp,
                         generator=torch.Generator().manual_seed(3))
    assert torch.equal(a, b)
    # the estimate approaches the analytic form with many points per ray
    many = tinter.k_semi_mc(k, torch.as_tensor(xp), torch.as_tensor(xi), tp, npts=400,
                            generator=torch.Generator().manual_seed(3))
    assert _rel(many, tinter.k_semi_sqexp(torch.as_tensor(xp), torch.as_tensor(xi), tp)) < 1e-2


_INTERP = {}


def _interpolators():
    if not _INTERP:
        _INTERP["t"] = tinter.DoublyDiagInterpolator(tkernels.SqExp())
        _INTERP["j"] = jinter.DoublyDiagInterpolator(jkernels.SqExp())
    return _INTERP["t"], _INTERP["j"]


@pytest.mark.parametrize("ell", [ELL, np.array([0.15, 0.25, 0.3]), 0.05])
def test_doubly_diag_interpolator_matches_jax(ell):
    # the table, and calls inside it and beyond its last knot (distances up
    # to ~35 at ell 0.05: the last slope extrapolated)
    ti, ji = _interpolators()
    np.testing.assert_allclose(ti.knn, np.asarray(ji.knn), rtol=1e-10, atol=1e-14)
    x = _points(10, 50)
    x[0] = 0.0
    tp, jp = _params(ell)
    got = ti(torch.as_tensor(x), tp)
    want = ji(jnp.asarray(x), jp)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-10, atol=1e-14)


def test_doubly_diag_interpolator_matches_quadrature():
    ti, _ = _interpolators()
    tp, _ = _params()
    k = tkernels.SqExp()
    x = _points(11, 6, 0.3, 0.8)
    kernel_np = lambda a, b: k(torch.as_tensor(a), torch.as_tensor(b), tp).numpy()
    want = tinter.k_doubly_diag_quad(kernel_np, x, order=100)
    np.testing.assert_allclose(_np(ti(torch.as_tensor(x), tp)), want, rtol=2e-2)


NX, NZ = 8, 4
NOBS = 192


@pytest.fixture(scope="module")
def domain():
    """The synthetic dust field, N = 192 observations + 40 test stars, and
    the same integrated mean-field model in both packages (8 x 8 x 4 grid,
    float64), with the JAX init state carried into the port."""
    x, a, e, sobs, rho = run_domain.make_synthetic_domain_data(NOBS + 40, 0.1)
    lo, hi = x.min(axis=0), x.max(axis=0)
    grids = [np.linspace(lo[0], hi[0], NX), np.linspace(lo[1], hi[1], NX),
             np.linspace(lo[2], hi[2], NZ)]
    sig2 = run_domain.empirical_sig2_init(x[:NOBS], a[:NOBS])
    common = dict(num_obs=NOBS, sig2_init=sig2, ell_init=ELL, noise2_init=1.0,
                  init_Svar=1.0, jitter=1e-3, support_integrated_obs=True)
    jm = JHIPGP(jkernels.SqExp(), [jnp.asarray(g) for g in grids], dtype=jnp.float64,
                **common)
    tm = HIPGP(tkernels.SqExp(), grids, dtype=torch.float64, device="cpu", **common)
    jstate = jm.init_state(jax.random.PRNGKey(3))
    tstate = convert.state_from_numpy(
        {k: np.asarray(getattr(jstate, k)) for k in convert.STATE_FIELDS}, device="cpu")
    return dict(x=x[:NOBS], a=a[:NOBS], s=sobs[:NOBS], xt=x[NOBS:], et=e[NOBS:],
                jm=jm, tm=tm, jstate=jstate, tstate=tstate, sig2=sig2)


def test_domain_data_and_sig2_match_jax(domain):
    jx, ja, je, js, _ = jrun_domain.make_synthetic_domain_data(NOBS + 40, 0.1)
    tx, ta, te, ts, _ = run_domain.make_synthetic_domain_data(NOBS + 40, 0.1)
    for t, j in ((tx, jx), (ta, ja), (te, je), (ts, js)):
        np.testing.assert_array_equal(t, j)
    assert domain["sig2"] == jempirical_sig2_init(domain["x"], domain["a"])
    rng = np.random.default_rng(0)
    # a large offset with little spread: the slope's square is far above
    # var(y), so the init falls back to var(y)
    flat = 5.0 + 1e-3 * rng.standard_normal(100)
    with pytest.warns(RuntimeWarning):
        got = run_domain.empirical_sig2_init(rng.uniform(-1, 1, (100, 3)), flat)
    assert got == pytest.approx(float(np.var(flat)))


def test_make_grams_integrated_matches_jax(domain):
    x = domain["x"][:50]
    tk, tdiag = domain["tm"].make_grams(domain["tstate"], torch.as_tensor(x),
                                        integrated_obs=True)
    jk, jdiag = domain["jm"].make_grams(domain["jstate"], jnp.asarray(x),
                                        integrated_obs=True)
    assert tk.shape == (50, NX * NX * NZ)
    np.testing.assert_allclose(_np(tk), np.asarray(jk), rtol=1e-10, atol=1e-14)
    np.testing.assert_allclose(_np(tdiag), np.asarray(jdiag), rtol=1e-10)
    # point observations are unchanged
    tk0, _ = domain["tm"].make_grams(domain["tstate"], torch.as_tensor(x))
    jk0, _ = domain["jm"].make_grams(domain["jstate"], jnp.asarray(x))
    np.testing.assert_allclose(_np(tk0), np.asarray(jk0), rtol=1e-12, atol=1e-15)


def test_make_grams_refuses_what_jax_refuses(domain):
    x = torch.as_tensor(domain["x"][:5])
    st = domain["tstate"]
    with pytest.raises(ValueError, match="closed form"):
        HIPGP(tkernels.Matern(1.5), [np.linspace(0, 1, 4)] * 3, num_obs=5,
              support_integrated_obs=True, dtype=torch.float64,
              device="cpu").make_grams(st, x, integrated_obs=True)
    with pytest.raises(ValueError, match="unknown estimator"):
        domain["tm"].make_grams(st, x, integrated_obs=True,
                                semi_integrated_estimator="quad")
    plain = HIPGP(tkernels.SqExp(), [np.linspace(0, 1, 4)] * 3, num_obs=5,
                  dtype=torch.float64, device="cpu")
    with pytest.raises(ValueError, match="support_integrated_obs"):
        plain.make_grams(st, x, integrated_obs=True)
    # the Monte-Carlo estimator takes its draws from the generator
    k1, d1 = domain["tm"].make_grams(st, x, True, "mc-biased", 10,
                                     torch.Generator().manual_seed(1))
    k2, _ = domain["tm"].make_grams(st, x, True, "mc-biased", 10,
                                    torch.Generator().manual_seed(1))
    assert torch.equal(k1, k2) and k1.shape == (5, NX * NX * NZ)


def test_integrated_elbo_and_predict_match_jax(domain):
    # the integrated Knn_diag reaches the ELBO's trace term and the
    # predictive variance: <= 1e-8 (10 and 50 PCG iterations in both)
    x, a, s = domain["x"][:64], domain["a"][:64], domain["s"][:64]
    te = domain["tm"].elbo(domain["tstate"], torch.as_tensor(x), torch.as_tensor(a),
                           torch.as_tensor(s), maxiter_cg=10, integrated_obs=True)
    je = domain["jm"].elbo(domain["jstate"], jnp.asarray(x), jnp.asarray(a),
                           jnp.asarray(s), maxiter_cg=10, integrated_obs=True)
    assert abs(float(te) - float(je)) <= 1e-8 * abs(float(je))
    pe = domain["tm"].elbo(domain["tstate"], torch.as_tensor(x), torch.as_tensor(a),
                           torch.as_tensor(s), maxiter_cg=10)
    assert abs(float(pe) - float(te)) > 1e-6 * abs(float(te))
    tmu, tsig = domain["tm"].predict(domain["tstate"], torch.as_tensor(domain["xt"]),
                                     integrated_obs=True)
    jmu, jsig = domain["jm"].predict(domain["jstate"], jnp.asarray(domain["xt"]),
                                     integrated_obs=True)
    assert _rel(tmu, jmu) <= 1e-8 and _rel(tsig, jsig) <= 1e-8
    bmu, bsig = batch_predict(domain["tm"], domain["tstate"], domain["xt"], batch_size=16,
                              integrated_obs=True)
    assert _rel(bmu, tmu) <= 1e-12 and _rel(bsig, tsig) <= 1e-12


def test_natgrad_stability_rho_matches_jax(domain):
    x, s = domain["x"][:64], domain["s"][:64]
    tm, jm = domain["tm"], domain["jm"]
    tK, _ = tm.make_grams(domain["tstate"], torch.as_tensor(x), integrated_obs=True)
    jK, _ = jm.make_grams(domain["jstate"], jnp.asarray(x), integrated_obs=True)
    tkn = tm.compute_kn(domain["tstate"], tK, maxiter_cg=10)
    jkn = jm.compute_kn(domain["jstate"], jK, maxiter_cg=10)
    ivar = 1.0 / s ** 2
    got = natgrad_stability_rho(tkn, torch.as_tensor(ivar), domain["tstate"], tm, 3.0)
    want = jrho(jkn, jnp.asarray(ivar), domain["jstate"], jm, 3.0)
    assert got > 1.0
    assert abs(got - want) <= 1e-8 * want


def _fits(domain, lr):
    tcfg = FitConfig(epochs=1, batch_size=64, maxiter_cg=10, lr=lr, schedule_lr=False,
                     integrated_obs=True)
    jcfg = JFitConfig(epochs=1, batch_size=64, maxiter_cg=10, lr=lr, schedule_lr=False,
                      integrated_obs=True)
    tst, trep = svigp_fit(domain["tm"], domain["tstate"], domain["x"], domain["a"],
                          domain["s"], tcfg, verbose=False, theta2_warmstart=True,
                          natgrad_safe_lr="clamp")
    jst, jrep = jsvigp_fit(domain["jm"], domain["jstate"], jnp.asarray(domain["x"]),
                           jnp.asarray(domain["a"]), jnp.asarray(domain["s"]), jcfg,
                           verbose=False, theta2_warmstart=True, natgrad_safe_lr="clamp")
    return tst, trep, jst, jrep


_FITS = {}


@pytest.mark.parametrize("lr", [1e-2, 5.0])
def test_warmstarted_integrated_natgrad_steps_match_jax(domain, lr):
    # three warm-started integrated natgrad steps (N = 192, batch 64) from
    # the same state: rho, the lr used (clamped to 1/rho when lr > 1/rho)
    # and the state <= 1e-8
    if lr not in _FITS:
        _FITS[lr] = _fits(domain, lr)
    tst, trep, jst, jrep = _FITS[lr]
    assert trep["steps"] == 3
    assert abs(trep["natgrad_rho"] - jrep["natgrad_rho"]) <= 1e-8 * jrep["natgrad_rho"]
    assert trep["lr_used"] == pytest.approx(jrep["lr_used"], rel=1e-8)
    assert trep["lr_used"] == pytest.approx(min(lr, 1.0 / trep["natgrad_rho"]), rel=1e-12)
    for f in ("theta1", "theta2"):
        assert _rel(getattr(tst, f), getattr(jst, f)) <= 1e-8
    np.testing.assert_allclose(trep["elbo_trace"], np.asarray(jrep["elbo_trace"]),
                               rtol=1e-8)


def test_safe_lr_warns_and_refuses(domain):
    cfg = FitConfig(epochs=1, batch_size=64, maxiter_cg=5, lr=5.0, integrated_obs=True)
    with pytest.warns(UserWarning, match="stability limit"):
        _, rep = svigp_fit(domain["tm"], domain["tstate"], domain["x"], domain["a"],
                           domain["s"], cfg, verbose=False, theta2_warmstart=True,
                           max_steps=1)
    assert rep["lr_used"] == 5.0
    with pytest.raises(ValueError, match="natgrad_safe_lr"):
        svigp_fit(domain["tm"], domain["tstate"], domain["x"], domain["a"], domain["s"],
                  cfg, verbose=False, theta2_warmstart=True, natgrad_safe_lr="maybe")
    _, rep = svigp_fit(domain["tm"], domain["tstate"], domain["x"], domain["a"],
                       domain["s"], cfg, verbose=False, natgrad_safe_lr="clamp",
                       max_steps=1)
    assert rep["natgrad_rho"] is None and rep["lr_used"] == 5.0


def test_prepared_batches_match_jax(domain):
    t = prepare_batches(torch.as_tensor(domain["x"]), torch.as_tensor(domain["a"]),
                        torch.as_tensor(domain["s"]), 64)
    j = jprepare_batches(jnp.asarray(domain["x"]), jnp.asarray(domain["a"]),
                         jnp.asarray(domain["s"]), 64)
    for a, b in zip(t, j):
        np.testing.assert_array_equal(_np(a), np.asarray(b))


def test_state_roundtrip_3d(domain):
    st = domain["tstate"]
    assert st.theta1.shape == (domain["tm"].Mprime,)
    back = convert.state_from_numpy(convert.state_to_numpy(st), device="cpu")
    for f in convert.STATE_FIELDS:
        assert torch.equal(getattr(back, f), getattr(st, f))
    f32 = convert.state_from_numpy(convert.state_to_numpy(st), dtype=torch.float32,
                                   device="cpu")
    assert f32.theta2.dtype == torch.float32
    # the JAX state and the port's agree field by field
    for f in convert.STATE_FIELDS:
        np.testing.assert_array_equal(convert.state_to_numpy(st)[f],
                                      np.asarray(getattr(domain["jstate"], f)))


def test_run_domain_reads_a_data_file(tmp_path):
    # the reference's whitespace-separated table with named columns; the
    # gaia dataset takes e as observed with e_err + 0.1 as its noise
    x, a, e, sobs, _ = run_domain.make_synthetic_domain_data(250, 0.1)
    path = tmp_path / "stars.dat"
    np.savetxt(path, np.column_stack([x, e, sobs]), header="x y z e e_err", comments="")
    got = run_domain.load_domain_data(str(path))
    np.testing.assert_allclose(got[0], x, rtol=1e-15)
    np.testing.assert_allclose(got[1], e, rtol=1e-15)
    np.testing.assert_allclose(got[2], sobs, rtol=1e-15)
    assert got[3] is None
    prob = run_domain.domain_problem(0, 50, 0.1, 8, 4, data_path=str(path), dataset="gaia")
    assert prob["xobs"].shape == (200, 3) and prob["fgrid"] is None
    np.testing.assert_allclose(np.sort(prob["aobs"]), np.sort(e[np.isin(e, prob["aobs"])]))
    out = run_domain.main(["--device", "cpu", "--data-path", str(path), "--dataset", "gaia",
                           "--ntest", "50", "--nx", "8", "--nz", "4", "--max-steps", "2",
                           "--fit-method", "natgrad", "--output-dir", str(tmp_path / "out")])
    assert out["steps"] == 2 and "latent_rmse" not in out
    assert np.isfinite(out["e_post_rmse"])


def test_run_domain_main_runs_on_cpu(tmp_path, capsys):
    out = run_domain.main(["--device", "cpu", "--nobs", "300", "--nx", "8", "--nz", "4",
                           "--max-steps", "3", "--fit-method", "natgrad",
                           "--output-dir", str(tmp_path)])
    assert out["steps"] == 3
    assert np.isfinite(out["e_post_rmse"]) and np.isfinite(out["latent_corr"])
    assert out["lr_used"] == pytest.approx(min(1e-2, 1.0 / out["natgrad_rho"]))
    with open(tmp_path / "metrics.csv") as f:
        rows = dict(csv.reader(f))
    assert float(rows["e_post_rmse"]) == pytest.approx(out["e_post_rmse"])
    with open(tmp_path / "elbo_trace.csv") as f:
        assert len(list(csv.reader(f))) == 4
    assert "e post-RMSE" in capsys.readouterr().out
    # the closed form's 'factored' solver on the same grid (kappa 29 there:
    # no fallback): its stages, and the state it writes
    fb = run_domain.main(["--fit-method", "full-batch", "--mean-solver", "factored",
                          "--device", "cpu", "--nobs", "300", "--nx", "8", "--nz", "4",
                          "--output-dir", str(tmp_path / "fb")])
    assert np.isfinite(fb["last_elbo"]) and fb["e_post_rmse"] < fb["e_rms"]
    assert {"fit_sweep_s", "fit_factor_s", "fit_g_s", "fit_mean_s", "fit_elbo_s"} <= set(fb)
    assert (tmp_path / "fb" / "state.npz").exists()
