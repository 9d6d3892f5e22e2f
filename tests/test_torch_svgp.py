"""The dense SVGP baseline of the PyTorch port (hipgp_tpu_torch.models.svgp)
against the JAX package, and the fit loop, optimizer, checkpoints and
conversion driving it.

Both sides get the same float64 inputs, made with numpy from a seed, on the
CPU (the JAX side in float64 by tests/conftest.py); the Monte-Carlo
estimator's offset is drawn once from a JAX key and passed to the port.
Small sizes: a 6 x 6 inducing grid of [0, 1]^2 and 40 observations.  Each
tolerance is stated where it is asserted.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # one intra-op thread a process: the xdist workers share the cores

from hipgp_tpu.infer import FitConfig as JFitConfig
from hipgp_tpu.infer import batch_predict as jbatch_predict
from hipgp_tpu.infer import svigp_fit as jsvigp_fit
from hipgp_tpu.infer.fit import make_optimizer as jmake_optimizer
from hipgp_tpu.kernels import SqExp as JSqExp
from hipgp_tpu.models import SVGP as JSVGP
from hipgp_tpu.models.svgp import SVGPState as JState
from hipgp_tpu.utils import checkpoint as jckpt
from hipgp_tpu.utils import stats as jstats
from hipgp_tpu_torch import convert
from hipgp_tpu_torch.infer import FitConfig, batch_predict, svigp_fit
from hipgp_tpu_torch.infer.fit import make_optimizer
from hipgp_tpu_torch.kernels import SqExp
from hipgp_tpu_torch.models import HIPGP, SVGP, SVGPState
from hipgp_tpu_torch.utils import checkpoint, stats

N, M1 = 40, 6
FIELDS = ("theta1", "theta2", "log_sig2", "log_ell")


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _rel(got, want):
    got, want = _np(got), _np(want)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-300))


def _data(n=N, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.05, 0.95, (n, 2))
    y = np.sin(4 * x[:, 0]) + np.cos(3 * x[:, 1]) + 0.2 * rng.standard_normal(n)
    return x, y, np.full(n, 0.2)


def _xinduce(m=M1):
    g = np.linspace(0.0, 1.0, m)
    xx, yy = np.meshgrid(g, g, indexing="ij")
    return np.column_stack([xx.ravel(), yy.ravel()])


def _pair(whitened, integrated=False, num_obs=N, ell=0.25, jitter=1e-3):
    kw = dict(num_obs=num_obs, whitened=whitened, sig2_init=1.3, ell_init=ell,
              jitter=jitter, support_integrated_obs=integrated)
    return (JSVGP(JSqExp(), jnp.asarray(_xinduce()), **kw),
            SVGP(SqExp(), _xinduce(), dtype=torch.float64, device="cpu", **kw))


def _state(seed=3, M=M1 * M1):
    # a state away from the init: theta1 random, -2 theta2 = A A^T / M + I
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((M, M))
    d = dict(theta1=rng.standard_normal(M), theta2=-0.5 * (A @ A.T / M + np.eye(M)),
             log_sig2=np.array(0.2), log_ell=np.array(np.log(0.3)))
    return (JState(**{k: jnp.asarray(v) for k, v in d.items()}),
            convert.state_from_numpy(d, device="cpu", cls=SVGPState))


def _jt(*arrs):
    return [jnp.asarray(a) for a in arrs] + [torch.as_tensor(a) for a in arrs]


def _assert_state(tst, jst, tol):
    for f in FIELDS:
        assert _rel(getattr(tst, f), getattr(jst, f)) <= tol, (f, _rel(getattr(tst, f),
                                                                     getattr(jst, f)))


# ---------------------------------------------------------------------------
# stats
# ---------------------------------------------------------------------------

def test_kl_mvn_and_gamma_helpers_match_jax():
    # KL between two dense Gaussians and the four gamma helpers: 1e-12
    rng = np.random.default_rng(1)
    k = 7
    A, B = rng.standard_normal((k, k)), rng.standard_normal((k, k))
    S0, S1 = A @ A.T + np.eye(k), B @ B.T + 0.5 * np.eye(k)
    m0, m1 = rng.standard_normal(k), rng.standard_normal(k)
    want = float(jstats.kl_mvn(*(jnp.asarray(a) for a in (m0, S0, m1, S1))))
    got = float(stats.kl_mvn(*(torch.as_tensor(a) for a in (m0, S0, m1, S1))))
    assert got == pytest.approx(want, rel=1e-12)
    x = np.array([0.3, 1.7, 4.0])
    a, b = 2.5, 1.5
    for fn in ("gamma_lnpdf", "gamma_lnpdf_lnx"):
        np.testing.assert_allclose(getattr(stats, fn)(torch.as_tensor(x), a, b).numpy(),
                                   np.asarray(getattr(jstats, fn)(jnp.asarray(x), a, b)),
                                   rtol=1e-12)
    assert stats.gamma_moments(a, b) == pytest.approx(jstats.gamma_moments(a, b), rel=1e-12)
    assert stats.gamma_params(0.1, 0.025 ** 2) == pytest.approx(
        jstats.gamma_params(0.1, 0.025 ** 2), rel=1e-12)


# ---------------------------------------------------------------------------
# the model's methods against JAX (1e-9 relative, float64)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("whitened", [True, False])
def test_elbo_matches_jax(whitened):
    jm, tm = _pair(whitened)
    jst, tst = _state()
    x, y, s = _data()
    jx, jy, js, tx, ty, ts = _jt(x, y, s)
    assert float(tm.elbo(tst, tx, ty, ts)) == pytest.approx(
        float(jm.elbo(jst, jx, jy, js)), rel=1e-9)
    w = (np.arange(N) < 31).astype(float)   # a padded batch's 0/1 weights
    assert float(tm.elbo(tst, tx, ty, ts, weights=torch.as_tensor(w))) == pytest.approx(
        float(jm.elbo(jst, jx, jy, js, weights=jnp.asarray(w))), rel=1e-9)
    # the standard parameters, the grams and kn on the way
    for got, want in zip(tm.standard_params(tst), jm.standard_params(jst)):
        assert _rel(got, want) <= 1e-9
    Knm_t, _ = tm.make_grams(tst, tx)
    Knm_j, _ = jm.make_grams(jst, jx)
    assert _rel(tm.make_kn(tst, Knm_t), jm.make_kn(jst, Knm_j)) <= 1e-9
    assert float(tm.kernel_param_prior(tst)) == pytest.approx(
        float(jm.kernel_param_prior(jst)), rel=1e-12)


@pytest.mark.parametrize("estimator", ["analytic", "mc-biased"])
@pytest.mark.parametrize("whitened", [True, False])
def test_integrated_elbo_and_grads_match_jax(whitened, estimator):
    # line-integral observations (rays from the origin to x): the analytic
    # semi-integrated covariances, or the Monte-Carlo ones with JAX's offset
    # passed to the port
    jm, tm = _pair(whitened, integrated=True)
    jst, tst = _state()
    x, y, s = _data()
    jx, jy, js, tx, ty, ts = _jt(x, y, s)
    key = jax.random.PRNGKey(5)
    npts = 7
    u = float(jax.random.uniform(key, (), dtype=jnp.float64) / npts)
    kw = dict(integrated_obs=True, semi_integrated_estimator=estimator,
              semi_integrated_samps=npts)
    je, jg = jm.elbo_and_grads(jst, jx, jy, js, key=key, compute_kernel_grads=True, **kw)
    te, tg = tm.elbo_and_grads(tst, tx, ty, ts, u=u, compute_kernel_grads=True, **kw)
    assert float(te) == pytest.approx(float(je), rel=1e-9)
    _assert_state(tg, jg, 1e-9)
    assert float(tm.elbo(tst, tx, ty, ts, u=u, **kw)) == pytest.approx(
        float(jm.elbo(jst, jx, jy, js, key=key, **kw)), rel=1e-9)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("kernel_grads", [False, True])
@pytest.mark.parametrize("whitened", [True, False])
def test_elbo_and_grads_match_jax(whitened, kernel_grads, weighted):
    # every leaf of the natural gradient and, with compute_kernel_grads, the
    # hyper-gradients (with kernel_param_prior / N) and that ELBO: 1e-9
    jm, tm = _pair(whitened)
    jst, tst = _state()
    x, y, s = _data()
    jx, jy, js, tx, ty, ts = _jt(x, y, s)
    w = (np.arange(N) < 29).astype(float) if weighted else None
    je, jg = jm.elbo_and_grads(jst, jx, jy, js, compute_kernel_grads=kernel_grads,
                               weights=None if w is None else jnp.asarray(w))
    te, tg = tm.elbo_and_grads(tst, tx, ty, ts, compute_hyper_grads=kernel_grads,
                               weights=None if w is None else torch.as_tensor(w))
    assert float(te) == pytest.approx(float(je), rel=1e-9)
    for f in ("theta1", "theta2"):
        assert _rel(getattr(tg, f), getattr(jg, f)) <= 1e-9, f
    for f in ("log_sig2", "log_ell"):
        want = float(getattr(jg, f))
        assert float(getattr(tg, f)) == pytest.approx(want, rel=1e-9, abs=1e-300), f
        assert (want != 0.0) == kernel_grads
    assert not tg.theta1.requires_grad and not te.requires_grad


def test_noise_std_none_raises():
    _, tm = _pair(True)
    _, tst = _state()
    x, y, _ = _data()
    with pytest.raises(ValueError, match="learnable noise parameter"):
        tm.elbo_and_grads(tst, torch.as_tensor(x), torch.as_tensor(y), None)


@pytest.mark.parametrize("whitened", [True, False])
def test_batch_solve_and_predict_match_jax(whitened):
    jm, tm = _pair(whitened)
    x, y, s = _data()
    jx, jy, js, tx, ty, ts = _jt(x, y, s)
    jst, je = jm.batch_solve(jm.init_state(), jx, jy, js, compute_elbo=True)
    tst, te = tm.batch_solve(tm.init_state(), x, y, s, compute_elbo=True)
    _assert_state(tst, jst, 1e-9)
    assert float(te) == pytest.approx(float(je), rel=1e-9)
    xt = np.random.default_rng(9).uniform(0, 1, (25, 2))
    for clamp in (0.0, 1e-3):
        jmu, jsig = jm.predict(jst, jnp.asarray(xt), var_clamp=clamp)
        tmu, tsig = tm.predict(tst, torch.as_tensor(xt), var_clamp=clamp)
        assert _rel(tmu, jmu) <= 1e-9 and _rel(tsig, jsig) <= 1e-9
    assert not hasattr(tm.batch_solve(tm.init_state(), x, y, s), "__len__")


# ---------------------------------------------------------------------------
# the port alone
# ---------------------------------------------------------------------------

def test_natgrad_step_hits_batch_solve():
    # one natural-gradient step of lr 1 on all the data lands on the
    # closed form (the JAX package's test_svgp_natgrad_step_hits_batch_solve)
    _, tm = _pair(True)
    x, y, s = (torch.as_tensor(a) for a in _data())
    st = tm.init_state()
    _, g = tm.elbo_and_grads(st, x, y, s)
    stepped = st.replace(theta1=st.theta1 - g.theta1, theta2=st.theta2 - g.theta2)
    solved = tm.batch_solve(st, x, y, s)
    assert _rel(stepped.theta1, solved.theta1) <= 1e-9
    assert _rel(stepped.theta2, solved.theta2) <= 1e-9


def test_matches_hipgp_fullrank_cholesky():
    # the whitened SVGP and the full-rank HIP-GP with the cholesky whitening
    # are the same posterior by two code paths
    x, y, s = (torch.as_tensor(a) for a in _data())
    grids = [np.linspace(0.0, 1.0, 7)] * 2
    hip = HIPGP(SqExp(), grids, num_obs=N, family="full-rank", whitened_type="cholesky",
                ell_init=0.25, jitter=1e-5, dtype=torch.float64, device="cpu")
    svgp = SVGP(SqExp(), hip.xinduce, num_obs=N, whitened=True, ell_init=0.25,
                jitter=1e-5, device="cpu")
    assert svgp.dtype == torch.float64
    sh = hip.batch_solve(hip.init_state(), x, y, s)
    ss = svgp.batch_solve(svgp.init_state(), x, y, s)
    with torch.no_grad():
        mh, sgh = hip.predict(sh, x)
    ms, sgs = svgp.predict(ss, x)
    assert _rel(ms, mh) <= 1e-6


def test_whitened_and_unwhitened_predict_alike():
    _, tw = _pair(True, jitter=1e-5)
    _, tu = _pair(False, jitter=1e-5)
    x, y, s = (torch.as_tensor(a) for a in _data())
    pw = tw.predict(tw.batch_solve(tw.init_state(), x, y, s), x)
    pu = tu.predict(tu.batch_solve(tu.init_state(), x, y, s), x)
    assert _rel(pw[0], pu[0]) <= 1e-5 and _rel(pw[1], pu[1]) <= 1e-4


# ---------------------------------------------------------------------------
# the fit loop, prediction, optimizer, checkpoints, conversion
# ---------------------------------------------------------------------------

def _cfgs(**kw):
    # a constant lr: optax rounds a scheduled one to float32 (ROADMAP C)
    jcfg = JFitConfig(**{"epochs": 2, "batch_size": 16, "lr": 0.3, "schedule_lr": False,
                         "kernel_lr": 1e-2, **kw})
    return jcfg, FitConfig(**{f.name: getattr(jcfg, f.name)
                              for f in dataclasses.fields(FitConfig)})


@pytest.mark.parametrize("learn", [False, True])
def test_svigp_fit_matches_jax(learn):
    # 2 epochs of 3 steps (the last batch padded and masked) with and
    # without learn_kernel: state, hypers and ELBO trace within 1e-8
    jm, tm = _pair(False)
    x, y, s = _data()
    jcfg, cfg = _cfgs(learn_kernel=learn)
    jst, jrep = jsvigp_fit(jm, jm.init_state(), *_jt(x, y, s)[:3], jcfg, verbose=False)
    tst, trep = svigp_fit(tm, tm.init_state(), x, y, s, cfg, verbose=False)
    np.testing.assert_allclose(trep["elbo_trace"], jrep["elbo_trace"], rtol=1e-8)
    _assert_state(tst, jst, 1e-8)
    moved = float(tst.log_ell) != float(tm.init_state().log_ell)
    assert moved == learn
    if learn:
        np.testing.assert_allclose(trep["ell_trace"], jrep["ell_trace"], rtol=1e-8)
    assert trep["natgrad_rho"] is None and trep["steps"] == 6
    # batch_predict (SVGP chunks are not clamped to a memory budget)
    xt = np.random.default_rng(4).uniform(0, 1, (23, 2))
    jmu, jsig = jbatch_predict(jm, jst, jnp.asarray(xt), batch_size=10)
    tmu, tsig = batch_predict(tm, tst, xt, batch_size=10)
    assert _rel(tmu, jmu) <= 1e-8 and _rel(tsig, jsig) <= 1e-8


def test_warmstart_is_skipped_for_an_svgp():
    # theta2_warmstart needs a HIP-GP's Lambda: a no-op on an SVGP, as in JAX
    jm, tm = _pair(True)
    x, y, s = _data()
    jcfg, cfg = _cfgs(epochs=1)
    jst, _ = jsvigp_fit(jm, jm.init_state(), *_jt(x, y, s)[:3], jcfg, verbose=False,
                        theta2_warmstart=True)
    tst, rep = svigp_fit(tm, tm.init_state(), x, y, s, cfg, verbose=False,
                         theta2_warmstart=True)
    _assert_state(tst, jst, 1e-8)
    assert rep["warmstart_s"] < 1.0


@pytest.mark.parametrize("learn", [False, True])
def test_optimizer_leaves_and_treedef_match_optax(learn):
    # an SVGPState has no log_noise2 leaf: Adam's count and the two hypers'
    # moments, then the schedule's count
    jst, tst = _state()
    jcfg, cfg = _cfgs(schedule_lr=True, learn_kernel=learn)
    jopt = jmake_optimizer(jst, jcfg)
    jos = jopt.init(jst)
    topt = make_optimizer(tst, cfg)
    rng = np.random.default_rng(2)
    for step in range(3):
        jleaves, jtree = jax.tree.flatten(jos)
        tleaves = topt.leaves(tst)
        assert len(tleaves) == len(jleaves) == (5 if learn else 0) + 1
        for t, j in zip(tleaves, jleaves):
            assert tuple(t.shape) == np.shape(j) and t.numpy().dtype == np.asarray(j).dtype
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-12)
        g = {f: rng.standard_normal(np.shape(getattr(jst, f))) for f in FIELDS}
        upd, jos = jopt.update(JState(**{k: jnp.asarray(v) for k, v in g.items()}), jos, jst)
        jst = jax.tree.map(lambda a, b: a + b, jst, upd)
        tst = topt.step(tst, SVGPState(**{k: torch.as_tensor(v) for k, v in g.items()}))
    assert topt.treedef(tst) == str(jax.tree.flatten(jos)[1])
    _assert_state(tst, jst, 1e-6)   # optax's float32 schedule moves theta by ~1e-8


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_crosses_packages(writer, tmp_path):
    # a checkpoint (state and a learn-kernel optimizer) written by either
    # package restores in the other, exactly
    jst, tst = _state()
    jcfg, cfg = _cfgs(learn_kernel=True)
    jopt = jmake_optimizer(jst, jcfg)
    jos = jopt.init(jst)
    topt = make_optimizer(tst, cfg)
    if writer == "jax":
        jckpt.save_checkpoint(str(tmp_path), jst, jos, step=4)
        got, opt, step = checkpoint.restore_checkpoint(str(tmp_path), tst, topt)
        assert step == 4 and opt is topt and opt.count == 0
        _assert_state(got, jst, 0.0)
    else:
        checkpoint.save_checkpoint(str(tmp_path), tst, topt, step=4)
        got, gos, step = jckpt.restore_checkpoint(str(tmp_path), jst, jos)
        assert step == 4
        assert len(jax.tree.flatten(gos)[0]) == len(topt.leaves(tst))
        _assert_state(tst, got, 0.0)


def test_convert_carries_an_svgp_state_both_ways():
    jst, _ = _state()
    d = {f: np.asarray(getattr(jst, f)) for f in FIELDS}
    tst = convert.state_from_numpy(d, device="cpu", cls=SVGPState)
    assert isinstance(tst, SVGPState)
    back = convert.state_to_numpy(tst)
    assert set(back) == set(FIELDS)
    for f in FIELDS:
        np.testing.assert_array_equal(back[f], d[f])
    again = JState(**{k: jnp.asarray(v) for k, v in back.items()})
    _assert_state(tst, again, 0.0)
    with pytest.raises(KeyError):
        convert.state_from_numpy({"theta1": d["theta1"]}, device="cpu", cls=SVGPState)
    with pytest.raises(KeyError):   # a HIP-GP state by default: log_noise2 is missing
        convert.state_from_numpy(d, device="cpu")
