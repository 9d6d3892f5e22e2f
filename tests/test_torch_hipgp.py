"""Parity of the PyTorch port's model, fit and prediction with the JAX package.

Both packages get the same float64 data (the synthetic 2-D surface, made with
numpy from a seed) and the same starting state: a JAX ``init_state`` carried
into the port with ``convert.state_from_numpy``.  Everything runs on the CPU,
where the JAX whitening takes its generic PCG path and the port its plain
path; the two agree to float64 rounding of truncated PCG solves.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hipgp_tpu import kernels as jkernels
from hipgp_tpu.infer import FitConfig as JFitConfig
from hipgp_tpu.infer import batch_predict as jbatch_predict
from hipgp_tpu.infer import svigp_fit as jsvigp_fit
from hipgp_tpu.infer.fit import prepare_batches as jprepare_batches
from hipgp_tpu.models import HIPGP as JHIPGP
from hipgp_tpu.utils import stats as jstats
from hipgp_tpu_torch import convert
from hipgp_tpu_torch import kernels as tkernels
from hipgp_tpu_torch.experiments import run_synthetic
from hipgp_tpu_torch.experiments.synthetic_data import make_two_dim_data
from hipgp_tpu_torch.infer import FitConfig, batch_predict, svigp_fit
from hipgp_tpu_torch.infer.fit import make_optimizer, prepare_batches
from hipgp_tpu_torch.models import HIPGPState
from hipgp_tpu_torch.utils import metrics, stats

NOISE = 0.01


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else np.array(a)


def _rel(got, want):
    got, want = _np(got), _np(want)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _pair(num_inducing, num_obs, sig2, ell=0.05):
    """The same mean-field model in both packages (float64, CPU), built as
    the JAX harness builds it, and the JAX init state in both."""
    grids = [np.linspace(-1, 1, num_inducing)] * 2
    jm = JHIPGP(jkernels.SqExp(), [jnp.asarray(g) for g in grids],
                num_obs=num_obs, sig2_init=sig2, ell_init=ell,
                noise2_init=NOISE ** 2, init_Svar=1.0, jitter=1e-3,
                dtype=jnp.float64)
    tm = run_synthetic.build_model("SqExp", num_inducing, num_obs, sig2, ell,
                                   NOISE, dtype=torch.float64, device="cpu")
    jstate = jm.init_state(jax.random.PRNGKey(3))
    tstate = convert.state_from_numpy(
        {k: np.asarray(getattr(jstate, k)) for k in convert.STATE_FIELDS},
        device="cpu")
    return jm, tm, jstate, tstate


@pytest.fixture(scope="module")
def data():
    return make_two_dim_data(Nobs=2000, Ntest=300, noise_std=NOISE, gridnum=32,
                             seed=42)


def _config(jcfg):
    # the port's FitConfig holds the JAX fields the natgrad fit reads
    return FitConfig(**{f.name: getattr(jcfg, f.name)
                        for f in dataclasses.fields(FitConfig)})


def _state_rel(tstate, jstate, field):
    return _rel(getattr(tstate, field), getattr(jstate, field))


@pytest.mark.parametrize("name", ["SqExp", "Mat12", "Mat32", "Mat52", "Gneiting"])
def test_kernels_match_jax(name):
    # closed forms evaluated the same way: float64 rounding
    rng = np.random.default_rng(0)
    x, y = rng.uniform(-1, 1, (7, 2)), rng.uniform(-1, 1, (5, 2))
    ell = np.array([0.3, 0.5]) if name == "SqExp" else np.float64(0.4)
    jk, tk = jkernels.kernel_from_name(name), tkernels.kernel_from_name(name)
    want = jk(jnp.asarray(x), jnp.asarray(y), (1.7, jnp.asarray(ell)))
    got = tk(torch.as_tensor(x), torch.as_tensor(y),
             (torch.tensor(1.7, dtype=torch.float64),
              torch.tensor(ell, dtype=torch.float64)))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-13, atol=1e-15)
    np.testing.assert_allclose(
        _np(tk.diag(torch.as_tensor(x), (torch.tensor(1.7, dtype=torch.float64), 0.4))),
        _np(jk.diag(jnp.asarray(x), (1.7, 0.4))), rtol=1e-15)


def test_diag_kl_matches_jax():
    rng = np.random.default_rng(1)
    m, S = rng.standard_normal(50), rng.uniform(0.1, 2.0, 50)
    np.testing.assert_allclose(
        float(stats.diag_kl_to_standard(torch.as_tensor(m), torch.as_tensor(S))),
        float(jstats.diag_kl_to_standard(jnp.asarray(m), jnp.asarray(S))),
        rtol=1e-14)


def test_convert_roundtrip():
    rng = np.random.default_rng(2)
    d = {k: rng.standard_normal(5) if k.startswith("theta") else np.float64(rng.random())
         for k in convert.STATE_FIELDS}
    st = convert.state_from_numpy(d, device="cpu")
    assert isinstance(st, HIPGPState)
    back = convert.state_to_numpy(st)
    for k in convert.STATE_FIELDS:
        np.testing.assert_array_equal(back[k], d[k])
    with pytest.raises(KeyError):
        convert.state_from_numpy({"theta1": d["theta1"]}, device="cpu")


def test_prepare_batches_matches_jax(data):
    x, y, s = data["xobs"][:700], data["yobs"][:700], data["sobs"][:700]
    got = prepare_batches(torch.as_tensor(x), torch.as_tensor(y),
                          torch.as_tensor(s), 256)
    want = jprepare_batches(jnp.asarray(x), jnp.asarray(y), jnp.asarray(s), 256)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), _np(w))


def test_lr_schedule_matches_optax():
    # optax evaluates the schedule in float32 at the optimizer's int32 step
    # count (even under x64), the port in double: the f32 rounding of 0.99
    # compounds to ~1e-8 relative per step, under 1e-6 over one epoch here
    import optax

    cfg = FitConfig(lr=1e-2, step_decay=0.99)
    sched = optax.exponential_decay(init_value=1e-2, transition_steps=1,
                                    decay_rate=0.99)
    opt = make_optimizer(cfg)
    for k in range(0, 80, 7):
        np.testing.assert_allclose(opt.lr * opt.decay ** k,
                                   float(sched(jnp.asarray(k, jnp.int32))),
                                   rtol=1e-6)


def test_elbo_and_grads_match_jax(data):
    # one minibatch ELBO and natural gradient from the same state; the
    # kn solve is 10 PCG iterations in both, so float64 rounding (<= 1e-8)
    sig2 = run_synthetic.marginal_sig2(data["yobs"], data["sobs"])
    jm, tm, jstate, tstate = _pair(16, 2000, sig2)
    x, y, s = data["xobs"][:96], data["yobs"][:96], data["sobs"][:96]
    w = np.ones(96)
    w[-10:] = 0.0
    je, jg = jm.elbo_and_grads(jstate, jnp.asarray(x), jnp.asarray(y),
                               jnp.asarray(s), maxiter_cg=10,
                               weights=jnp.asarray(w))
    te, tg = tm.elbo_and_grads(tstate, torch.as_tensor(x), torch.as_tensor(y),
                               torch.as_tensor(s), maxiter_cg=10,
                               weights=torch.as_tensor(w))
    assert abs(float(te) - float(je)) <= 1e-8 * abs(float(je))
    assert _state_rel(tg, jg, "theta1") <= 1e-8
    assert _state_rel(tg, jg, "theta2") <= 1e-8
    # the plain ELBO agrees with the ELBO of elbo_and_grads
    e2 = tm.elbo(tstate, torch.as_tensor(x), torch.as_tensor(y),
                 torch.as_tensor(s), maxiter_cg=10, weights=torch.as_tensor(w))
    assert abs(float(e2) - float(te)) <= 1e-12 * abs(float(te))


@pytest.mark.parametrize("warmstart", [False, True])
def test_natgrad_state_after_three_steps_matches_jax(data, warmstart):
    # three natgrad steps of svigp_fit (one epoch of three batches, the
    # last one padded and masked), from the same state: <= 1e-8.  A constant
    # lr, because optax rounds a scheduled lr to float32 (see the schedule
    # test above), which alone moves theta by ~2e-8 relative per step
    sig2 = run_synthetic.marginal_sig2(data["yobs"], data["sobs"])
    jm, tm, jstate, tstate = _pair(16, 600, sig2)
    x, y, s = data["xobs"][:600], data["yobs"][:600], data["sobs"][:600]
    jcfg = JFitConfig(epochs=1, batch_size=256, maxiter_cg=10, schedule_lr=False)
    cfg = _config(jcfg)
    jst, jrep = jsvigp_fit(jm, jstate, x, y, s, jcfg, verbose=False,
                           theta2_warmstart=warmstart, natgrad_safe_lr="off")
    tst, trep = svigp_fit(tm, tstate, x, y, s, cfg, verbose=False,
                          theta2_warmstart=warmstart)
    assert trep["steps"] == len(jrep["elbo_trace"]) == 3
    for f in ("theta1", "theta2"):
        assert _state_rel(tst, jst, f) <= 1e-8
    np.testing.assert_allclose(trep["elbo_trace"], jrep["elbo_trace"], rtol=1e-8)


def test_predict_matches_jax(data):
    # posterior mean and std at test points after a short fit, predicted
    # in chunks with 50 PCG iterations: <= 1e-8
    sig2 = run_synthetic.marginal_sig2(data["yobs"], data["sobs"])
    jm, tm, jstate, tstate = _pair(16, 2000, sig2)
    jstate = jstate.replace(theta1=jstate.theta1 * 50.0, theta2=jstate.theta2 * 3.0)
    tstate = tstate.replace(theta1=tstate.theta1 * 50.0, theta2=tstate.theta2 * 3.0)
    xt = data["xtest"][:250]
    jmu, jsig = jbatch_predict(jm, jstate, jnp.asarray(xt), batch_size=100,
                               maxiter_cg=50)
    mu, sig = batch_predict(tm, tstate, xt, batch_size=100, maxiter_cg=50)
    assert mu.shape == sig.shape == (250,)
    assert _rel(mu, jmu) <= 1e-8
    assert _rel(sig, jsig) <= 1e-8
    # chunking does not change the answer
    mu1, sig1 = tm.predict(tstate, torch.as_tensor(xt), maxiter_cg=50)
    assert _rel(mu1, mu) <= 1e-12 and _rel(sig1, sig) <= 1e-12


def test_end_to_end_fit_matches_jax_protocol(data):
    # the protocol at N = 2000, M = 16^2, 2 epochs (16 steps): the JAX
    # protocol's model, fit and chunked prediction against the port's on the
    # same data and start; ELBO trace and test RMSE within 1e-6 relative
    # (the scheduled lr is float32 in optax and double here, see above)
    sig2 = run_synthetic.marginal_sig2(data["yobs"], data["sobs"])
    jm, tm, jstate, tstate = _pair(16, 2000, sig2)
    jcfg = JFitConfig(epochs=2, batch_size=256, maxiter_cg=10)
    cfg = _config(jcfg)
    args = (data["xobs"], data["yobs"], data["sobs"])
    jst, jrep = jsvigp_fit(jm, jstate, *args, jcfg, verbose=False)
    tst, trep = svigp_fit(tm, tstate, *args, cfg, verbose=False)
    assert len(trep["elbo_trace"]) == len(jrep["elbo_trace"]) == 16
    np.testing.assert_allclose(trep["elbo_trace"], jrep["elbo_trace"], rtol=1e-6)
    jmu, jsig = jbatch_predict(jm, jst, jnp.asarray(data["xtest"]),
                               batch_size=4096, maxiter_cg=50)
    mu, sig = batch_predict(tm, tst, data["xtest"], batch_size=4096, maxiter_cg=50)
    jr = metrics.rmse(data["ftest"], _np(jmu))
    tr = metrics.rmse(data["ftest"], mu.numpy())
    assert abs(tr - jr) <= 1e-6 * jr
    assert abs(metrics.mean_loglike(data["ftest"], mu.numpy(), sig.numpy())
               - metrics.mean_loglike(data["ftest"], _np(jmu), _np(jsig))) <= 1e-6


def test_metrics_match_error_frame():
    from hipgp_tpu.utils.metrics import error_frame

    rng = np.random.default_rng(9)
    f, mu, sig = rng.standard_normal(40), rng.standard_normal(40), rng.uniform(0.5, 2, 40)
    df = error_frame({"m": {"ftest": f, "fmu_test": mu, "fsig_test": sig}})
    np.testing.assert_allclose(metrics.rmse(f, mu), np.sqrt(df["f mse"].mean()),
                               rtol=1e-14)
    np.testing.assert_allclose(metrics.mean_loglike(f, mu, sig),
                               df["f loglike"].mean(), rtol=1e-14)


def test_run_synthetic_main_runs_on_cpu(capsys):
    out = run_synthetic.main(["--device", "cpu", "--nobs", "600", "--ntest", "100",
                              "--num-inducing", "12", "--epochs", "1", "--steps", "2",
                              "--f64", "--theta2-warmstart"])
    assert out["steps"] == 2
    assert np.isfinite(out["test_rmse"]) and np.isfinite(out["last_elbo"])
    assert "test RMSE" in capsys.readouterr().out
