"""The derivative-observation covariances (hipgp_tpu_torch.kernels.derivatives)
and the 1-D derivative-observation GP (hipgp_tpu_torch.models.derivative_gp)
of the PyTorch port against the JAX package.

Both sides get the same float64 inputs, made with numpy from a seed, on the
CPU.  Small sizes: 30 function and 8 derivative observations, M = 32
inducing points ('ziggy' embeds them in 64).  Each tolerance is stated where
it is asserted: the closed forms 1e-12; the solves, both whitenings at the
same maxiter and tol, 1e-8; the ELBO's gradient in (sig2, ell) 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # one intra-op thread a process: the xdist workers share the cores

from hipgp_tpu.kernels import derivatives as jder
from hipgp_tpu.models import derivative_gp as jdg
from hipgp_tpu_torch.kernels import derivatives as tder
from hipgp_tpu_torch.models import derivative_gp as tdg

SIG2, ELL, NOISE, DNOISE = 1.1, 0.3, 0.05, 0.2
KW = dict(maxiter=60, tol=1e-10)


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _rel(got, want):
    got, want = _np(got), _np(want)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _data(seed=0, nl=30, npr=8):
    rng = np.random.default_rng(seed)
    f = lambda t: np.sin(3 * t) * np.exp(-0.2 * t)
    fp = lambda t: (3 * np.cos(3 * t) - 0.2 * np.sin(3 * t)) * np.exp(-0.2 * t)
    x = np.sort(rng.uniform(0, 2, nl))
    xp = np.sort(rng.uniform(0, 2, npr))
    y = f(x) + NOISE * rng.standard_normal(nl)
    yp = fp(xp) + DNOISE * rng.standard_normal(npr)
    return dict(x=x, y=y, xp=xp, yp=yp, u=np.linspace(-0.1, 2.1, 32),
                xt=np.linspace(0.1, 1.9, 25))


def _jit(fn, **kw):
    # the JAX side under one jax.jit (op-by-op it compiles every primitive)
    return jax.jit(lambda *a: fn(*a, **kw))


def _both(d):
    return ({k: jnp.asarray(v) for k, v in d.items()},
            {k: torch.as_tensor(v) for k, v in d.items()})


# ---------------------------------------------------------------------------
# kernels.derivatives
# ---------------------------------------------------------------------------

def test_closed_forms_match_jax():
    rng = np.random.default_rng(2)
    x, y = rng.uniform(-1, 1, 9), rng.uniform(-1, 1, 7)
    for name in ("sqexp_k", "sqexp_kprime", "sqexp_kprime_double"):
        got = getattr(tder, name)(torch.as_tensor(x), torch.as_tensor(y), SIG2, ELL)
        want = getattr(jder, name)(jnp.asarray(x), jnp.asarray(y), SIG2, ELL)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-14)
    for name in ("sqexp_k_diag", "sqexp_kprime_double_diag"):
        got = getattr(tder, name)(torch.as_tensor(x), SIG2, ELL)
        np.testing.assert_allclose(got.numpy(), np.asarray(
            getattr(jder, name)(jnp.asarray(x), SIG2, ELL)), rtol=1e-12)


def _scalar_kernels(lib):
    exp, sqrt = (jnp.exp, jnp.sqrt) if lib == "jax" else (torch.exp, torch.sqrt)

    def sqexp(a, b, p):
        return p[0] * exp(-0.5 * (a - b) ** 2 / p[1] ** 2)

    def mat52(a, b, p):   # away from a == b, where |a - b| has no derivative
        r = sqrt((a - b) ** 2) / p[1]
        return p[0] * (1 + 5 ** 0.5 * r + 5.0 / 3.0 * r ** 2) * exp(-(5 ** 0.5) * r)

    return {"sqexp": sqexp, "mat52": mat52}


@pytest.mark.parametrize("kernel", ["sqexp", "mat52"])
def test_generic_derivative_covariances_match_jax(kernel):
    # torch.func grad/vmap against jax.grad/vmap on a scalar kernel, and for
    # SqExp against the closed forms
    rng = np.random.default_rng(3)
    x, y = rng.uniform(0, 1, 6), rng.uniform(1.2, 2, 5)
    params = (SIG2, ELL)
    jk, tk = _scalar_kernels("jax")[kernel], _scalar_kernels("torch")[kernel]
    for fn in ("grad_cross_cov", "grad_grad_cov"):
        got = getattr(tder, fn)(tk, torch.as_tensor(x), torch.as_tensor(y), params)
        want = getattr(jder, fn)(jk, jnp.asarray(x), jnp.asarray(y), params)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-14)
    if kernel == "sqexp":
        np.testing.assert_allclose(
            tder.grad_cross_cov(tk, torch.as_tensor(x), torch.as_tensor(y), params).numpy(),
            tder.sqexp_kprime(torch.as_tensor(x), torch.as_tensor(y), SIG2, ELL).numpy(),
            rtol=1e-12)
        np.testing.assert_allclose(
            tder.grad_grad_cov(tk, torch.as_tensor(x), torch.as_tensor(y), params).numpy(),
            tder.sqexp_kprime_double(torch.as_tensor(x), torch.as_tensor(y), SIG2,
                                     ELL).numpy(), rtol=1e-12)


# ---------------------------------------------------------------------------
# models.derivative_gp
# ---------------------------------------------------------------------------

def test_exact_and_dense_predictions_match_jax():
    j, t = _both(_data())
    for use in ("both", "prime", "latent"):
        xp, yp = (None, None) if use == "latent" else ("xp", "yp")
        xl, yl = (None, None) if use == "prime" else ("x", "y")
        ga = lambda d, k: None if k is None else d[k]
        want = _jit(jdg.exact_gp_prediction)(j["xt"], ga(j, xp), ga(j, yp), ga(j, xl), ga(j, yl),
                                       SIG2, ELL, DNOISE, NOISE)
        got = tdg.exact_gp_prediction(t["xt"], ga(t, xp), ga(t, yp), ga(t, xl), ga(t, yl),
                                      SIG2, ELL, DNOISE, NOISE)
        for g, w in zip(got, want):
            assert _rel(g, w) <= 1e-8, use
    for g, w in zip(tdg.derivative_prediction(t["xp"], t["yp"], t["xt"], SIG2, ELL),
                    _jit(jdg.derivative_prediction)(j["xp"], j["yp"], j["xt"], SIG2, ELL)):
        assert _rel(g, w) <= 1e-8
    for g, w in zip(tdg.latent_from_derivative_prediction(t["x"], t["y"], t["xp"], SIG2, ELL),
                    _jit(jdg.latent_from_derivative_prediction)(j["x"], j["y"], j["xp"], SIG2, ELL)):
        assert _rel(g, w) <= 1e-8


@pytest.mark.parametrize("whitened_type", ["ziggy", "cholesky"])
def test_batch_solve_posterior_and_elbo_match_jax(whitened_type):
    j, t = _both(_data())
    kw = dict(whitened_type=whitened_type, **KW)
    jm, jS = _jit(jdg.svgp_batch_solve, **kw)(j["u"], j["xp"], j["yp"], j["x"], j["y"],
                                              SIG2, ELL, DNOISE, NOISE)
    tm, tS = tdg.svgp_batch_solve(t["u"], t["xp"], t["yp"], t["x"], t["y"], SIG2, ELL,
                                  DNOISE, NOISE, **kw)
    assert tm.shape == jm.shape == ((64,) if whitened_type == "ziggy" else (32,))
    assert _rel(tm, jm) <= 1e-8 and _rel(tS, jS) <= 1e-8
    for domain in ("latent", "prime"):
        for g, w in zip(tdg.posterior_prediction(t["xt"], t["u"], tm, tS, SIG2, ELL,
                                                 domain=domain, **kw),
                        _jit(jdg.posterior_prediction, domain=domain, **kw)(
                            j["xt"], j["u"], jm, jS, SIG2, ELL)):
            assert _rel(g, w) <= 1e-8, domain
    with pytest.raises(ValueError, match="domain"):
        tdg.posterior_prediction(t["xt"], t["u"], tm, tS, SIG2, ELL, domain="both", **kw)
    want = float(_jit(jdg.compute_elbo, **kw)(j["u"], jm, jS, j["xp"], j["yp"], j["x"],
                                              j["y"], SIG2, ELL, DNOISE, NOISE))
    got = float(tdg.compute_elbo(t["u"], tm, tS, t["xp"], t["yp"], t["x"], t["y"], SIG2,
                                 ELL, DNOISE, NOISE, **kw))
    assert got == pytest.approx(want, rel=1e-8)
    # the derivative branch's prior diagonal is sig2/ell^2 (JAX's fix)
    an = tdg._an(tm, tS, torch.full((8,), SIG2 / ELL ** 2, dtype=torch.float64),
                 torch.zeros(8, tm.shape[0], dtype=torch.float64), t["yp"], DNOISE)
    np.testing.assert_allclose(an.numpy(), np.asarray(jdg._an(
        jm, jS, jnp.full((8,), SIG2 / ELL ** 2), jnp.zeros((8, jm.shape[0])), j["yp"],
        DNOISE)), rtol=1e-12)


@pytest.mark.parametrize("whitened_type", ["ziggy", "cholesky"])
def test_elbo_gradient_in_the_hypers_matches_jax(whitened_type):
    # run_derivative_1d's loss: -ELBO of the closed-form q, differentiated in
    # (log sig2, log ell) through the solve and the whitening (the port's
    # implicit-gradient whiten under 'ziggy')
    j, t = _both(_data())
    kw = dict(whitened_type=whitened_type, **KW)

    def jloss(p):
        sig2, ell = jnp.exp(p[0]), jnp.exp(p[1])
        m, S = jdg.svgp_batch_solve(j["u"], j["xp"], j["yp"], j["x"], j["y"], sig2, ell,
                                    DNOISE, NOISE, **kw)
        return -jdg.compute_elbo(j["u"], m, S, j["xp"], j["yp"], j["x"], j["y"], sig2, ell,
                                 DNOISE, NOISE, **kw)

    p0 = np.array([np.log(SIG2), np.log(ELL)])
    jl, jg = jax.jit(jax.value_and_grad(jloss))(jnp.asarray(p0))
    p = torch.as_tensor(p0).requires_grad_()
    sig2, ell = torch.exp(p[0]), torch.exp(p[1])
    m, S = tdg.svgp_batch_solve(t["u"], t["xp"], t["yp"], t["x"], t["y"], sig2, ell,
                                DNOISE, NOISE, **kw)
    tl = -tdg.compute_elbo(t["u"], m, S, t["xp"], t["yp"], t["x"], t["y"], sig2, ell,
                           DNOISE, NOISE, **kw)
    (tg,) = torch.autograd.grad(tl, p)
    assert float(tl) == pytest.approx(float(jl), rel=1e-8)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-6)
