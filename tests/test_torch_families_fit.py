"""Parity of the port's block-diagonal and full-rank families and the
'standard' parameterization with the JAX package: the methods, the fit and
the experiment scripts.

The family-shaped methods (``standard_params``, ``compute_knSkn``,
``kl_to_prior``, ``get_lam``, ``elbo``, ``elbo_and_grads`` with
hyper-gradients, ``predict``, ``get_inducing_S``), a block natgrad epoch with
the theta2 warm start and the step-size estimate, the port's copy of the JAX
test that the natural gradient vanishes at the closed-form optimum,
``batch_predict``'s chunk for the block family, 'factored''s jitter keyed on
the factor's dtype, the experiment scripts and the JAX package's positional parameters
of ``svigp_fit``, ``save_checkpoint`` and ``make_optimizer``; against the
JAX package on the same float64 inputs, on the CPU, with the setup of
`tests/test_torch_families.py`.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # one intra-op thread a process: the xdist workers share the cores

from hipgp_tpu import kernels as jkernels
from hipgp_tpu.infer import FitConfig as JFitConfig
from hipgp_tpu.infer import svigp_fit as jsvigp_fit
from hipgp_tpu.models import HIPGP as JHIPGP
from hipgp_tpu_torch import convert
from hipgp_tpu_torch import kernels as tkernels
from hipgp_tpu_torch.experiments import run_domain, run_synthetic
from hipgp_tpu_torch.experiments.harness import fit_predict_and_save
from hipgp_tpu_torch.infer import FitConfig, batch_predict, svigp_fit
from hipgp_tpu_torch.infer import fit as tfit
from hipgp_tpu_torch.models import HIPGP
from hipgp_tpu_torch.models.hipgp import FACTORED_STATS

N = 200
GRIDS = [np.linspace(-1, 1, 12)] * 2
FAMILIES = ["block", "full-rank"]
PARAMS = ["expectation-family", "standard"]


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _rel(got, want):
    # relative distance in norm (0 where both are 0)
    got, want = _np(got), _np(want)
    diff = np.linalg.norm(got - want)
    return 0.0 if diff == 0 else float(diff / np.linalg.norm(want))


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    x = rng.uniform(-0.95, 0.95, (N, 2))
    f = np.sin(3 * x[:, 0]) * np.cos(2 * x[:, 1])
    s = rng.uniform(0.03, 0.08, N)
    y = f + s * rng.standard_normal(N)
    xt = rng.uniform(-0.9, 0.9, (60, 2))
    return x, y, s, xt


def _kw(family, param, wt, n=N):
    kw = dict(num_obs=n, family=family, whitened_type=wt, parameterization=param,
              sig2_init=0.5, ell_init=0.2, noise2_init=0.01, init_Svar=1.0)
    if family == "block":
        kw["block_sizes"] = (4, 4)
    return kw


def _to_torch(js):
    return convert.state_from_numpy(
        {k: np.asarray(getattr(js, k)) for k in convert.STATE_FIELDS}, device="cpu")


@pytest.fixture(scope="module")
def pairs():
    # model pairs built on first use and kept for the module: the JAX stage
    # functions are memoized on the model, so their compiles are paid once
    cache = {}

    def get(family, param="expectation-family", wt="ziggy"):
        key = (family, param, wt)
        if key not in cache:
            kw = _kw(family, param, wt)
            jm = JHIPGP(jkernels.SqExp(), [jnp.asarray(g) for g in GRIDS],
                        dtype=jnp.float64, **kw)
            tm = HIPGP(tkernels.SqExp(), GRIDS, dtype=torch.float64, device="cpu", **kw)
            js = jm.init_state(jax.random.PRNGKey(3))
            cache[key] = (jm, tm, js, _to_torch(js))
        return cache[key]

    return get


def _spd(rng, *shape, scale=1.0):
    # batched SPD matrices: I + scale * G G^T / n
    n = shape[-1]
    G = rng.standard_normal(shape)
    return np.eye(n) + scale * G @ np.swapaxes(G, -1, -2) / n


def _random_state(tm, param, seed=5):
    # a state with dense, well-conditioned blocks (or S) from a seed, in the
    # stored parameterization: theta2 = -Lambda/2, or S = Lambda^{-1}
    rng = np.random.default_rng(seed)
    shape = ((tm.num_blocks, tm.block_size) if tm.family == "block" else (tm.Mprime,))
    lam = _spd(rng, *shape, shape[-1], scale=3.0)
    theta2 = np.linalg.inv(lam) if param == "standard" else -0.5 * lam
    return dict(theta1=0.3 * rng.standard_normal(tm.Mprime), theta2=theta2,
                log_sig2=np.log(0.5), log_ell=np.log(0.2), log_noise2=np.log(0.01))


@pytest.mark.parametrize("wt", ["ziggy", "cholesky"])
@pytest.mark.parametrize("param", PARAMS)
@pytest.mark.parametrize("family", FAMILIES)
def test_family_methods_match_jax(pairs, data, family, param, wt):
    # on a state with dense blocks (or a dense S), 40 rows of which 8 are
    # masked: standard_params, compute_knSkn, kl_to_prior, get_lam (bscale,
    # with and without the identity), elbo, predict, and under the
    # expectation family elbo_and_grads with the hyper-gradients; <= 1e-8
    jm, tm, _, _ = pairs(family, param, wt)
    d = _random_state(tm, param)
    js = jm.init_state().replace(**{k: jnp.asarray(v) for k, v in d.items()})
    ts = _to_torch(js)
    x, y, s, xt = data
    x, y, s = x[:40], y[:40], s[:40]
    w = np.r_[np.ones(32), np.zeros(8)]
    kn = np.random.default_rng(1).standard_normal((7, tm.Mprime))
    ivar = np.random.default_rng(2).uniform(0.5, 2.0, 7)
    args = (jnp.asarray(x), jnp.asarray(y), jnp.asarray(s))
    targs = tuple(torch.as_tensor(a) for a in (x, y, s))
    expectation = param == "expectation-family"

    def everything(m, st, kn, ivar, xt, args, w):
        # the same calls in both packages; the JAX side in one jit (its
        # eager whitening solve would compile op by op)
        qm, qS = m.standard_params(st)
        out = dict(qm=qm, qS=qS, knSkn=m.compute_knSkn(kn, qS), kl=m.kl_to_prior(qm, qS),
                   lam=m.get_lam(ivar, kn, bscale=1.7, add_identity=False),
                   lamI=m.get_lam(ivar, kn, bscale=1.7, add_identity=True))
        out["mu"], out["sig"] = m.predict(st, xt, maxiter_cg=50)
        if expectation:
            out["elbo"], g = m.elbo_and_grads(st, *args, maxiter_cg=10, weights=w,
                                              compute_hyper_grads=True)
            out.update({f"grad {k}": getattr(g, k) for k in convert.STATE_FIELDS})
        else:
            out["elbo"] = m.elbo(st, *args, maxiter_cg=10, weights=w)
        return out

    want = jax.jit(lambda st: everything(jm, st, jnp.asarray(kn), jnp.asarray(ivar),
                                         jnp.asarray(xt), args, jnp.asarray(w)))(js)
    got = everything(tm, ts, torch.as_tensor(kn), torch.as_tensor(ivar),
                     torch.as_tensor(xt), targs, torch.as_tensor(w))
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        tol = 1e-12 if k.startswith("lam") else 1e-10 if k in ("qm", "qS", "knSkn", "kl") \
            else 1e-8
        assert _rel(got[k], want[k]) <= tol, k


def test_get_inducing_S_matches_jax(pairs):
    # R S R^T of a dense full-rank S, and the mean-field model refuses
    jm, tm, _, _ = pairs("full-rank", "standard")
    d = _random_state(tm, "standard")
    js = jm.init_state().replace(**{k: jnp.asarray(v) for k, v in d.items()})
    got, want = tm.get_inducing_S(_to_torch(js)), jm.get_inducing_S(js)
    assert got.shape == want.shape == (tm.M, tm.M)
    assert _rel(got, want) <= 1e-12
    _, mf, _, ts = pairs("block")
    with pytest.raises(ValueError, match="full-rank"):
        mf.get_inducing_S(ts)


@pytest.mark.parametrize("family", ["mean-field", "block", "full-rank"])
def test_natgrad_vanishes_at_batch_solve_optimum(family):
    # the port's copy of the JAX test of the same name: the natural
    # gradient is zero at the closed-form optimum (cholesky whitening, 60
    # points on an 8^2 grid, blocks of 4 x 4)
    rng = np.random.default_rng(0)
    x = rng.uniform(0.05, 0.95, (60, 2))
    y = np.sin(4 * x[:, 0]) * np.cos(3 * x[:, 1]) + 0.1 * rng.standard_normal(60)
    x, y, s = torch.as_tensor(x), torch.as_tensor(y), torch.full((60,), 0.1,
                                                                 dtype=torch.float64)
    kw = {"block_sizes": (4, 4)} if family == "block" else {}
    model = HIPGP(tkernels.SqExp(), [np.linspace(0.0, 1.0, 8)] * 2, num_obs=60,
                  family=family, whitened_type="cholesky", ell_init=0.2, sig2_init=1.0,
                  noise2_init=0.01, dtype=torch.float64, device="cpu", **kw)
    solved = model.batch_solve(model.init_state(), x, y, s)
    _, g = model.elbo_and_grads(solved, x, y, s)
    assert float(torch.max(torch.abs(g.theta1))) < 1e-8
    assert float(torch.max(torch.abs(g.theta2))) < 1e-8


def test_block_svigp_fit_epoch_matches_jax(pairs, data):
    # one epoch of 7 natgrad steps (batch 32, the last padded) after the
    # theta2 warm start, with the step-size estimate rho on the first
    # batch; a constant lr (optax rounds a scheduled one to float32)
    jm, tm, js, ts = pairs("block")
    x, y, s, _ = data
    jcfg = JFitConfig(epochs=1, batch_size=32, lr=1e-2, maxiter_cg=10, schedule_lr=False)
    cfg = FitConfig(epochs=1, batch_size=32, lr=1e-2, maxiter_cg=10, schedule_lr=False)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        jst, jrep = jsvigp_fit(jm, js, jnp.asarray(x), jnp.asarray(y), jnp.asarray(s),
                               jcfg, verbose=False, theta2_warmstart=True)
        tst, trep = svigp_fit(tm, ts, x, y, s, cfg, verbose=False, theta2_warmstart=True)
    assert trep["natgrad_rho"] == pytest.approx(jrep["natgrad_rho"], rel=1e-8)
    assert trep["natgrad_rho"] > 1.0
    np.testing.assert_allclose(trep["elbo_trace"], jrep["elbo_trace"], rtol=1e-8)
    for k in ("theta1", "theta2"):
        assert _rel(getattr(tst, k), getattr(jst, k)) <= 1e-8


def test_batch_predict_chunk_counts_the_block_gather(pairs, data, monkeypatch):
    # the budget counts the block family's block-ordered copy of kn beside
    # kn (as JAX's batch_predict does), with the dtype's item size: half the
    # mean-field chunk
    _, tm, _, ts = pairs("block")
    xt = data[3]
    M = tm.Mprime
    monkeypatch.setattr(tfit, "PREDICT_CHUNK_BUDGET_BYTES", 8 * M * 20)
    sizes = []
    predict = tm.predict
    monkeypatch.setattr(tm, "predict",
                        lambda st, xb, **k: sizes.append(len(xb)) or predict(st, xb, **k))
    mu, _ = batch_predict(tm, ts, xt, batch_size=100, maxiter_cg=5)
    assert sizes == [10] * 6 and mu.shape == (60,)
    want, _ = predict(ts, torch.as_tensor(xt), maxiter_cg=5)
    assert _rel(mu, want) <= 1e-12


def test_factored_explicit_jitter_reproduces_jax_float32(data):
    # 'factored''s default jitter follows the factor's dtype (float64 here:
    # 1e-10 mean(diag A), where JAX's float32 model takes 1e-4); an explicit
    # factor_jitter=1e-4 gives JAX's float32 result, to float32 rounding
    # amplified by the unconverged mean PCG (ell 0.12: kappa 18, inside the
    # float32 trust region, no fallback in either package)
    x, y, s, _ = data
    kw = dict(_kw("mean-field", "expectation-family", "ziggy"), ell_init=0.12)
    jm = JHIPGP(jkernels.SqExp(), [jnp.asarray(g, jnp.float32) for g in GRIDS],
                dtype=jnp.float32, **kw)
    tm = HIPGP(tkernels.SqExp(), GRIDS, dtype=torch.float32, device="cpu", **kw)
    js = jm.init_state(jax.random.PRNGKey(3))
    ts = convert.state_from_numpy({k: np.asarray(getattr(js, k))
                                   for k in convert.STATE_FIELDS}, device="cpu")
    skw = dict(batch_size=16, maxiter_cg=10, compute_elbo=True, mean_solver="factored")
    f32 = lambda a: jnp.asarray(a, jnp.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        jst, je = jm.batch_solve(js, f32(x), f32(y), f32(s), **skw)
        tst, te = tm.batch_solve(ts, x, y, s, factor_jitter=1e-4, **skw)
        mean_diag = FACTORED_STATS["jitter"] / 1e-4
        assert _rel(tst.theta2, jst.theta2) <= 1e-5
        assert _rel(tst.theta1, jst.theta1) <= 2e-4
        assert float(te) == pytest.approx(float(je), rel=1e-4)
        dst, _ = tm.batch_solve(ts, x, y, s, **skw)
    assert FACTORED_STATS["jitter"] == pytest.approx(1e-10 * mean_diag, rel=1e-6)
    assert _rel(dst.theta2, tst.theta2) > 5e-5


def test_experiment_scripts_run_the_families(tmp_path, data):
    # the harness, run_domain and run_synthetic on the CPU at cut sizes: run_domain's
    # block 2 x 2 x 2 'matfree' fit on a 12 x 12 x 6 grid, run_synthetic's
    # three families' closed forms at 12^2; the harness's full-rank is
    # 'standard', so its natgrad fit raises
    out = run_domain.main(["--device", "cpu", "--f64", "--nobs", "300", "--ntest", "40",
                           "--nx", "12", "--nz", "6", "--model-class", "block-diagonal",
                           "--mean-solver", "matfree", "--output-dir", str(tmp_path / "d")])
    assert out["model_class"] == "block-diagonal" and np.isfinite(out["last_elbo"])
    assert out["e_post_rmse"] < out["e_rms"]
    outs = run_synthetic.main(["--device", "cpu", "--f64", "--nobs", "300", "--ntest", "60",
                               "--num-inducing", "12", "--ell", "0.2", "--gridnum", "8",
                               "--xblock-size", "4", "--fit-method", "full-batch",
                               "--mean-solver", "gram", "--models", "mean-field",
                               "block-diagonal", "full-rank",
                               "--output-dir", str(tmp_path / "s")])
    # the three families share the optimal mean (the same test RMSE); each
    # richer covariance family bounds the evidence at least as tightly
    # (Fischer's inequality: the same tr(Lambda S), a larger log det S)
    mf, bl, fr = (o["last_elbo"] for o in outs)
    assert np.isfinite([mf, bl, fr]).all() and mf <= bl <= fr
    for o in outs[1:]:
        assert o["test_rmse"] == pytest.approx(outs[0]["test_rmse"], rel=1e-4)
    x, y, s, _ = data
    with pytest.raises(ValueError, match="expectation-family"):
        fit_predict_and_save("fr", x, y, s, GRIDS, model_class="full-rank",
                             fit_config=FitConfig(epochs=1, batch_size=50),
                             output_dir=str(tmp_path / "h"), dtype=torch.float64,
                             device="cpu")


SIGNATURES = {"svigp_fit": 8, "save_checkpoint": 5, "make_optimizer": 2}


@pytest.mark.parametrize("name", list(SIGNATURES))
def test_positional_parameters_match_jax(name, pairs, data, tmp_path):
    # the positional parameters the port has are the JAX package's, in its
    # order (a callback passed by position is the epoch callback, not
    # verbose); the port's later parameters of svigp_fit are keyword-only
    import inspect

    from hipgp_tpu.infer import fit as jfit
    from hipgp_tpu.utils import checkpoint as jckpt
    from hipgp_tpu_torch.utils import checkpoint

    mods = {"svigp_fit": (tfit, jfit), "save_checkpoint": (checkpoint, jckpt),
            "make_optimizer": (tfit, jfit)}[name]
    port, ref = (list(inspect.signature(getattr(m, name)).parameters.values())
                 for m in mods)
    positional = [p.name for p in port if p.kind == p.POSITIONAL_OR_KEYWORD]
    assert len(positional) == SIGNATURES[name]
    assert positional == [p.name for p in ref][:SIGNATURES[name]]
    if name == "svigp_fit":
        assert all(p.kind == p.KEYWORD_ONLY for p in port[SIGNATURES[name]:])
        _, tm, _, ts = pairs("block")
        x, y, s, _ = data
        seen = []
        svigp_fit(tm, ts, x, y, s, FitConfig(epochs=2, batch_size=100, maxiter_cg=5),
                  lambda epoch, *rest: seen.append(epoch), False)
        assert seen == [0, 1]
    if name == "save_checkpoint":
        # the third positional parameter is the optimizer state: the fit's
        # optimizer, saved in the JAX package's form (its one leaf here, the
        # schedule's count) and restored by restore_checkpoint
        _, _, _, ts = pairs("block")
        opt = tfit.make_optimizer(ts, FitConfig())
        opt.count = 5
        checkpoint.save_checkpoint(str(tmp_path), ts, opt, 3)
        assert (tmp_path / "opt_state.npz").exists()
        fresh = tfit.make_optimizer(ts, FitConfig())
        st, got, step = checkpoint.restore_checkpoint(str(tmp_path), ts, fresh)
        assert step == 3 and got is fresh and fresh.count == 5
        assert torch.equal(st.theta2, ts.theta2)
