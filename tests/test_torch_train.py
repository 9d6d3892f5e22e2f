"""Parity of the port's training path with the JAX package: the gradients.

Kernel A's backward, kernel B-8 (`ops/pallas_transform.py`) and its
backward, kernel B-7 (the two-diagonal radix middle), the implicit gradient
of `inv_matmul`/`whiten` in the right-hand side and the hyperparameters,
`elbo_and_grads(compute_hyper_grads=True)`, Adam on the hyperparameters and
a learn-kernel, learn-noise `svigp_fit` epoch.  Both sides get the same
float64 inputs, made with numpy from a seed, on the CPU: the JAX Pallas
kernels run in interpret mode, its solves through the generic `pcg`; the
port's wrappers take their plain PyTorch versions through the same autograd
Functions that launch the kernels on the card.  Each tolerance is stated
where it is asserted.
"""
import dataclasses

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
from hipgp_tpu.ops import bttb as jbttb
from hipgp_tpu.ops import mxu2d as jmxu2d
from hipgp_tpu.ops import pallas_transform as jpt
from hipgp_tpu.ops import radix_fft as jrf
from hipgp_tpu.ops import solve as jsolve
from hipgp_tpu_torch import convert
from hipgp_tpu_torch import kernels as tkernels
from hipgp_tpu_torch.experiments import run_synthetic
from hipgp_tpu_torch.experiments.synthetic_data import make_two_dim_data
from hipgp_tpu_torch.infer import FitConfig, svigp_fit
from hipgp_tpu_torch.infer.fit import HyperAdam, make_optimizer, zero_frozen
from hipgp_tpu_torch.models import HIPGP, HIPGPState
from hipgp_tpu_torch.ops import bttb as tbttb
from hipgp_tpu_torch.ops import mxu2d as tmxu2d
from hipgp_tpu_torch.ops import pallas_transform as tpt
from hipgp_tpu_torch.ops import radix_fft as trf
from hipgp_tpu_torch.ops import solve as tsolve

NOISE = 0.01


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else np.array(a)


def _rel(got, want):
    got, want = _np(got), _np(want)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _t(a):
    return torch.as_tensor(np.array(a))


# ---------------------------------------------------------------------------
# kernel A's backward and B-8
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["out_expanded", "in_expanded", "cropped"])
def test_sandwich_vjp_matches_jax(mode):
    # R^T's crops (cropped in, expanded out), its pullback's (expanded in,
    # cropped out) and the PCG's: the port's autograd Function (plain
    # version on the CPU) against jax.vjp of the custom-VJP kernel in
    # interpret mode.  The same contractions in another order: <= 1e-10
    dims, ell = (12, 9), 0.07
    grids = [np.linspace(0.0, 1.0, m) for m in dims]
    js = jbttb.make_spectrum([jnp.asarray(g) for g in grids],
                             lambda a, b: jkernels.SqExp()(a, b, (1.0, ell)), jitter=1e-3)
    w = np.sqrt(_np(jbttb._full_weights(js.eigs, js.edims[-1])))
    in_exp, out_exp = mode == "in_expanded", mode == "out_expanded"
    rng = np.random.default_rng(1)
    x = rng.standard_normal((5,) + tuple(js.edims if in_exp else js.dims))
    g = rng.standard_normal((5,) + tuple(js.edims if out_exp else js.dims))
    kw = dict(in_expanded=in_exp, out_expanded=out_exp)
    jy, vjp = jax.vjp(lambda a, b: jmxu2d.sandwich_apply(a, b, js.dims, js.edims,
                                                         interpret=True, **kw),
                      jnp.asarray(x), jnp.asarray(w))
    jgx, jgw = vjp(jnp.asarray(g))
    tx, tw = _t(x).requires_grad_(), _t(w).requires_grad_()
    ty = tmxu2d.sandwich_apply(tx, tw, js.dims, js.edims, **kw)
    gx, gw = torch.autograd.grad(ty, (tx, tw), _t(g))
    assert ty.shape == jy.shape and gx.shape == x.shape and gw.shape == w.shape
    assert _rel(ty, jy) <= 1e-10
    assert _rel(gx, jgx) <= 1e-10
    assert _rel(gw, jgw) <= 1e-10


def test_sandwich_pullback_is_the_swapped_sandwich():
    # gx of the R^T sandwich equals the forward sandwich with the crops
    # swapped, bit for bit on the CPU: it is the same plain call
    dims, edims = (7, 6), (12, 10)
    rng = np.random.default_rng(2)
    w = _t(rng.uniform(0.5, 1.5, edims))
    x = _t(rng.standard_normal((3,) + dims)).requires_grad_()
    g = _t(rng.standard_normal((3,) + edims))
    y = tmxu2d.sandwich_apply(x, w, dims, edims, out_expanded=True)
    (gx,) = torch.autograd.grad(y, x, g)
    want = tmxu2d.sandwich_apply(g, w, dims, edims, in_expanded=True)
    assert torch.equal(gx, want)


def _pt_setup(rng, B=4, L0=16, L1=12):
    # the inputs of the JAX package's own tests/test_pallas_transform.py
    x = rng.standard_normal((B, L0, L1))
    Q0 = np.asarray(jbttb._real_fourier_basis(L0, jnp.float64))
    Q1 = np.asarray(jbttb._real_fourier_basis(L1, jnp.float64))
    w = np.abs(rng.standard_normal((L0, L1))) + 0.1
    return x, Q0, Q1, w


def test_circulant_apply_2d_matches_jax():
    # B-8's plain version and its VJP (gx, gw) against the Pallas kernel in
    # interpret mode with its custom VJP: float64 rounding of the same four
    # contractions in another order, <= 1e-10
    rng = np.random.default_rng(0)
    x, Q0, Q1, w = _pt_setup(rng)
    g = rng.standard_normal(x.shape)
    jy, vjp = jax.vjp(lambda a, b: jpt.circulant_apply_2d(a, jnp.asarray(Q0),
                                                          jnp.asarray(Q1), b, True),
                      jnp.asarray(x), jnp.asarray(w))
    jgx, jgw = vjp(jnp.asarray(g))
    tx, tw = _t(x).requires_grad_(), _t(w).requires_grad_()
    before = dict(tpt.LAUNCHES)
    ty = tpt.circulant_apply_2d(tx, _t(Q0), _t(Q1), tw)
    gx, gw = torch.autograd.grad(ty, (tx, tw), _t(g))
    assert tpt.LAUNCHES == before   # the plain version launches nothing
    assert _rel(ty, jy) <= 1e-10
    assert _rel(gx, jgx) <= 1e-10
    assert _rel(gw, jgw) <= 1e-10
    # the tables get no gradient, as the JAX VJP's zeros
    q0 = _t(Q0).requires_grad_()
    y = tpt.circulant_apply_2d(_t(x), q0, _t(Q1), _t(w))
    assert y.grad_fn is not None
    assert torch.autograd.grad(y.sum(), q0, allow_unused=True)[0] is None


def test_circulant_apply_2d_checks_shapes():
    x, Q0, Q1, w = (_t(a) for a in _pt_setup(np.random.default_rng(3)))
    with pytest.raises(ValueError):
        tpt.circulant_apply_2d(x[0], Q0, Q1, w)
    with pytest.raises(ValueError):
        tpt.circulant_apply_2d(x, Q1, Q0, w)
    with pytest.raises(ValueError):
        tpt.circulant_apply_2d(x, Q0, Q1, w.T)


@pytest.mark.parametrize("op", ["matmul_by_K", "matmul_by_RT", "matmul_by_Cinv"])
def test_matvecs_through_b8_match_jax(monkeypatch, op):
    # the 2-D matvecs routed through circulant_apply_2d (the B-8 gate opened
    # on the CPU, so its plain version runs through its Function) against
    # JAX's einsum chain: <= 1e-10
    dims, ell = (14, 11), 0.06
    grids = [np.linspace(-1.0, 1.0, m) for m in dims]
    js = jbttb.make_spectrum([jnp.asarray(g) for g in grids],
                             lambda a, b: jkernels.SqExp()(a, b, (1.0, ell)), jitter=1e-3)
    ts = tbttb.make_spectrum([_t(g) for g in grids],
                             lambda a, b: tkernels.SqExp()(a, b, (1.0, ell)), jitter=1e-3)
    v = np.random.default_rng(4).standard_normal((3, ts.M))
    monkeypatch.setattr(tbttb, "_pallas_transform_ok", lambda spec, v: len(spec.dims) == 2)
    calls = []
    real = tpt.circulant_apply_2d
    monkeypatch.setattr(tpt, "circulant_apply_2d",
                        lambda *a: calls.append(1) or real(*a))
    got = getattr(tbttb, op)(ts, _t(v))
    want = getattr(jbttb, op)(js, jnp.asarray(v))
    assert calls == [1]
    assert _rel(got, want) <= 1e-10


def test_pallas_transform_gate():
    # B-8 only where USE_PALLAS_TRANSFORM is set, on 2-D float32 CUDA
    # tensors with every embedded axis <= PALLAS_MAX_LEN
    from types import SimpleNamespace

    spec2 = tbttb.BTTBSpectrum(column=None, eigs=None, dims=(125, 125), edims=(250, 250))
    spec_big = tbttb.BTTBSpectrum(column=None, eigs=None, dims=(300, 8), edims=(600, 16))
    spec3 = tbttb.BTTBSpectrum(column=None, eigs=None, dims=(8, 8, 8), edims=(16, 16, 16))
    cuda32 = SimpleNamespace(device=torch.device("cuda"), dtype=torch.float32)
    cuda64 = SimpleNamespace(device=torch.device("cuda"), dtype=torch.float64)
    cpu32 = SimpleNamespace(device=torch.device("cpu"), dtype=torch.float32)
    saved = tbttb.USE_PALLAS_TRANSFORM
    try:
        tbttb.USE_PALLAS_TRANSFORM = True
        assert tbttb._pallas_transform_ok(spec2, cuda32)
        assert not tbttb._pallas_transform_ok(spec2, cuda64)
        assert not tbttb._pallas_transform_ok(spec2, cpu32)
        assert not tbttb._pallas_transform_ok(spec_big, cuda32)
        assert not tbttb._pallas_transform_ok(spec3, cuda32)
        tbttb.USE_PALLAS_TRANSFORM = False
        assert not tbttb._pallas_transform_ok(spec2, cuda32)
    finally:
        tbttb.USE_PALLAS_TRANSFORM = saved


def test_mxu2d_pcg_gate_follows_the_flag(monkeypatch):
    spec = tbttb.BTTBSpectrum(column=None, eigs=None, dims=(125, 125), edims=(250, 250))
    cuda = torch.device("cuda")
    assert tsolve._mxu2d_solver_ok(spec, torch.float32, cuda)
    monkeypatch.setattr(tbttb, "USE_MXU2D_PCG", False)
    assert not tsolve._mxu2d_solver_ok(spec, torch.float32, cuda)


# ---------------------------------------------------------------------------
# B-7, the two-diagonal middle
# ---------------------------------------------------------------------------

def _even_spectrum(L, rng):
    d = 0.5 + rng.random(L)
    return 0.5 * (d + np.concatenate([d[:1], d[1:][::-1]]))


def test_dual_apply_matches_jax():
    # fused_circulant_apply_cropped_dual at the plan and crops of the JAX
    # package's own dual test (L = 8192, rows = L/2 over the row multiple):
    # the port's plain stages (B-7's plain version in the middle) against
    # JAX's interpret-mode dual kernel, <= 1e-10; and against two single
    # cropped applies of the port, <= 1e-12 (the same arithmetic per chain)
    L = 8192
    rng = np.random.default_rng(4)
    rows = (L // 2) // jrf.row_multiple(L)
    M = rows * jrf.row_multiple(L)
    xr, xi = rng.standard_normal((2, M)), rng.standard_normal((2, M))
    dA, dB = _even_spectrum(L, rng) / L, _even_spectrum(L, rng) / L
    jplan = jrf.make_plan(L, jnp.float64)
    want = jrf.fused_circulant_apply_cropped_dual(
        jnp.asarray(xr), jnp.asarray(xi), jrf.permute_weights(jnp.asarray(dA), jplan),
        jrf.permute_weights(jnp.asarray(dB), jplan), jplan, rows, rows)
    plan = trf.make_plan(L, torch.float64, "cpu")
    pA, pB = trf.permute_weights(_t(dA), plan), trf.permute_weights(_t(dB), plan)
    before = dict(trf.LAUNCHES)
    got = trf.fused_circulant_apply_cropped_dual(_t(xr), _t(xi), pA, pB, plan, rows, rows)
    assert trf.LAUNCHES == before
    for (gr, gi), (wr, wi) in zip(got, want):
        assert _rel(gr, wr) <= 1e-10 and _rel(gi, wi) <= 1e-10
    for (gr, gi), d in zip(got, (pA, pB)):
        sr, si = trf.fused_circulant_apply_cropped(_t(xr), _t(xi), d, plan, rows, rows)
        assert _rel(gr, sr) <= 1e-12 and _rel(gi, si) <= 1e-12


def test_middle_dual_plain_is_two_middles():
    # the plain B-7 equals two plain B-4 calls on the same planes, <= 1e-13
    L = 8192
    plan = trf.make_plan(L, torch.float64, "cpu")
    rng = np.random.default_rng(5)
    shape = (3, plan.A, plan.B, plan.C)
    yr, yi = _t(rng.standard_normal(shape)), _t(rng.standard_normal(shape))
    dA = trf.permute_weights(_t(_even_spectrum(L, rng) / L), plan)
    dB = trf.permute_weights(_t(_even_spectrum(L, rng) / L), plan)
    zAr, zAi, zBr, zBi = trf.middle_dual(yr, yi, dA, dB, plan)
    for (zr, zi), d in (((zAr, zAi), dA), ((zBr, zBi), dB)):
        wr, wi = trf.middle_plain(yr, yi, d, plan)
        assert _rel(zr, wr) <= 1e-13 and _rel(zi, wi) <= 1e-13
    with pytest.raises(ValueError):
        trf.middle_dual(yr, yi, dA, dB[:-1], plan)


# ---------------------------------------------------------------------------
# the implicit gradient of the whitening
# ---------------------------------------------------------------------------

def _whiten_grads_jax(dims, ell, sig2, b, c, **kw):
    grids = [jnp.asarray(np.linspace(-1.0, 1.0, m)) for m in dims]

    def loss(ls, le, rhs):
        p = (jnp.exp(ls), jnp.exp(le))
        spec = jbttb.make_spectrum(grids, lambda x, y: jkernels.SqExp()(x, y, p),
                                   jitter=1e-3)
        return jnp.sum(jsolve.whiten(spec, rhs, **kw) * c)

    return jax.value_and_grad(loss, argnums=(0, 1, 2))(
        jnp.log(sig2), jnp.log(ell), jnp.asarray(b))


def _whiten_grads_torch(dims, ell, sig2, b, c, **kw):
    grids = [_t(np.linspace(-1.0, 1.0, m)) for m in dims]
    ls = torch.tensor(np.log(sig2), dtype=torch.float64, requires_grad=True)
    le = torch.tensor(np.log(ell), dtype=torch.float64, requires_grad=True)
    rhs = _t(b).requires_grad_()
    p = (torch.exp(ls), torch.exp(le))
    spec = tbttb.make_spectrum(grids, lambda x, y: tkernels.SqExp()(x, y, p),
                               jitter=1e-3)
    assert float(spec.eigs.detach().min()) > 10 * tbttb.DEFAULT_EIG_FLOOR   # none clamped
    loss = torch.sum(tsolve.whiten(spec, rhs, **kw) * _t(c))
    return loss, torch.autograd.grad(loss, (ls, le, rhs))


def _kernel_path_routes(monkeypatch, route):
    """Open a card path's gate on the CPU: 'mxu2d' runs the fused PCG and
    kernel A's Function (plain versions); 'b8' turns USE_MXU2D_PCG off and
    sends every 2-D apply through B-8's Function, as with
    USE_PALLAS_TRANSFORM on the card."""
    if route == "mxu2d":
        monkeypatch.setattr(tsolve, "_mxu2d_solver_ok",
                            lambda spec, dtype, device: len(spec.dims) == 2)
    elif route == "b8":
        monkeypatch.setattr(tbttb, "USE_MXU2D_PCG", False)
        monkeypatch.setattr(tbttb, "_pallas_transform_ok",
                            lambda spec, v: len(spec.dims) == 2)


@pytest.mark.parametrize("route", ["plain", "mxu2d", "b8"])
@pytest.mark.parametrize("solve", ["converged", "fixed10"])
def test_whiten_gradients_match_jax(monkeypatch, route, solve):
    # d/d(rhs, log_sig2, log_ell) of sum(whiten(spec(theta), rhs) * c) on a
    # 14 x 11 grid at ell 0.08 (no clamped eigenvalue).  Converged (maxiter
    # 200, tol 1e-10): the implicit gradient is the true one, <= 1e-6
    # relative as asked of it (it lands near 1e-10).  At 10 fixed
    # iterations both differentiate the same truncated solve the same way:
    # float64 rounding, <= 1e-8
    dims, ell, sig2 = (14, 11), 0.08, 0.7
    rng = np.random.default_rng(6)
    M = dims[0] * dims[1]
    b = rng.standard_normal((5, M))
    c = rng.standard_normal((5, int(np.prod(tbttb.embedded_dims(dims)))))
    kw = (dict(maxiter=200, tol=1e-10) if solve == "converged"
          else dict(maxiter=10, tol=0.0, fixed_iters=True))
    tol = 1e-6 if solve == "converged" else 1e-8
    _kernel_path_routes(monkeypatch, route)
    jl, jg = _whiten_grads_jax(dims, ell, sig2, b, c, **kw)
    tl, tg = _whiten_grads_torch(dims, ell, sig2, b, c, **kw)
    assert abs(float(tl) - float(jl)) <= tol * abs(float(jl))
    for got, want in zip(tg, jg):
        assert _rel(got, want) <= tol


def test_inv_matmul_gradient_matches_finite_differences():
    # the converged implicit gradient in log_ell against a central
    # difference of the converged solve (step 1e-5: truncation ~1e-10,
    # rounding ~1e-11 of an O(1) loss), <= 1e-6 relative
    dims, sig2 = (10, 9), 0.9
    grids = [_t(np.linspace(-1.0, 1.0, m)) for m in dims]
    rng = np.random.default_rng(7)
    b = _t(rng.standard_normal((3, 90)))
    c = _t(rng.standard_normal((3, 90)))

    def loss(le):
        p = (torch.tensor(sig2, dtype=torch.float64), torch.exp(le))
        spec = tbttb.make_spectrum(grids, lambda x, y: tkernels.SqExp()(x, y, p),
                                   jitter=1e-3)
        return torch.sum(tsolve.inv_matmul(spec, b, maxiter=300, tol=1e-12) * c)

    le = torch.tensor(np.log(0.1), dtype=torch.float64, requires_grad=True)
    (g,) = torch.autograd.grad(loss(le), le)
    h = 1e-5
    with torch.no_grad():
        fd = (loss(le + h) - loss(le - h)) / (2 * h)
    assert abs(float(g) - float(fd)) <= 1e-6 * abs(float(fd))


def _specs_1d():
    g = np.linspace(0.0, 1.0, 700)
    js = jbttb.make_spectrum([jnp.asarray(g)],
                             lambda a, b: jkernels.SqExp()(a, b, (1.0, 0.01)), jitter=1e-3)
    ts = tbttb.make_spectrum([_t(g)], lambda a, b: tkernels.SqExp()(a, b, (1.0, 0.01)),
                             jitter=1e-3)
    return js, ts


def test_whiten_1d_gradients_match_jax():
    # the plain 1-D path (torch.fft above MATMUL_DFT_MAX_LEN) is
    # differentiable too: d/d rhs of a 10-iteration whitening, <= 1e-8
    js, ts = _specs_1d()
    rng = np.random.default_rng(9)
    b = rng.standard_normal((3, ts.M))
    c = rng.standard_normal((3, ts.Mprime))
    kw = dict(maxiter=10, tol=0.0, fixed_iters=True)
    jg = jax.grad(lambda r: jnp.sum(jsolve.whiten(js, r, **kw) * c))(jnp.asarray(b))
    rhs = _t(b).requires_grad_()
    (tg,) = torch.autograd.grad(torch.sum(tsolve.whiten(ts, rhs, **kw) * _t(c)), rhs)
    assert _rel(tg, jg) <= 1e-8


# ---------------------------------------------------------------------------
# the model and the fit
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def data():
    return make_two_dim_data(Nobs=600, Ntest=100, noise_std=NOISE, gridnum=32, seed=42)


def _pair(num_inducing, num_obs, sig2, ell=0.08, learn=False):
    grids = [np.linspace(-1, 1, num_inducing)] * 2
    jm = JHIPGP(jkernels.SqExp(), [jnp.asarray(g) for g in grids], num_obs=num_obs,
                sig2_init=sig2, ell_init=ell, noise2_init=NOISE ** 2, init_Svar=1.0,
                jitter=1e-3, learn_kernel=learn, learn_noise=learn, dtype=jnp.float64)
    tm = HIPGP(tkernels.SqExp(), grids, num_obs=num_obs, sig2_init=sig2, ell_init=ell,
               noise2_init=NOISE ** 2, init_Svar=1.0, jitter=1e-3, learn_kernel=learn,
               learn_noise=learn, dtype=torch.float64, device="cpu")
    jstate = jm.init_state(jax.random.PRNGKey(3))
    # a state away from the prior, so every term of the bound moves
    jstate = jstate.replace(theta1=jstate.theta1 * 40.0, theta2=jstate.theta2 * 2.0)
    tstate = convert.state_from_numpy(
        {k: np.asarray(getattr(jstate, k)) for k in convert.STATE_FIELDS}, device="cpu")
    return jm, tm, jstate, tstate


@pytest.mark.parametrize("route", ["plain", "mxu2d"])
@pytest.mark.parametrize("noise", ["per-point", "learned"])
def test_elbo_and_hyper_grads_match_jax(monkeypatch, data, route, noise):
    # one minibatch (96 rows, 10 masked) at M = 16^2, ell 0.08 (no clamped
    # eigenvalue), 10 PCG iterations in both, compute_hyper_grads=True: the
    # ELBO, the natural gradient and -d elbo / d(log_sig2, log_ell,
    # log_noise2), float64 rounding of the same truncated solves, <= 1e-8.
    # With per-point noise the bound does not read log_noise2: its gradient
    # is 0 in both
    sig2 = run_synthetic.marginal_sig2(data["yobs"], data["sobs"])
    jm, tm, jstate, tstate = _pair(16, 600, sig2)
    x, y = data["xobs"][:96], data["yobs"][:96]
    s = data["sobs"][:96] if noise == "per-point" else None
    w = np.ones(96)
    w[-10:] = 0.0
    _kernel_path_routes(monkeypatch, route)
    je, jg = jm.elbo_and_grads(jstate, jnp.asarray(x), jnp.asarray(y),
                               None if s is None else jnp.asarray(s), maxiter_cg=10,
                               weights=jnp.asarray(w), compute_hyper_grads=True)
    te, tg = tm.elbo_and_grads(tstate, _t(x), _t(y), None if s is None else _t(s),
                               maxiter_cg=10, weights=_t(w), compute_hyper_grads=True)
    assert abs(float(te) - float(je)) <= 1e-8 * abs(float(je))
    for f in ("theta1", "theta2"):
        assert _rel(getattr(tg, f), getattr(jg, f)) <= 1e-8
    for f in ("log_sig2", "log_ell", "log_noise2"):
        got, want = float(getattr(tg, f)), float(getattr(jg, f))
        if noise == "per-point" and f == "log_noise2":
            assert got == want == 0.0
        else:
            assert want != 0.0 and abs(got - want) <= 1e-8 * abs(want), (f, got, want)
    # without compute_hyper_grads the same ELBO and zero hyper entries
    e2, g2 = tm.elbo_and_grads(tstate, _t(x), _t(y), None if s is None else _t(s),
                               maxiter_cg=10, weights=_t(w))
    assert abs(float(e2) - float(te)) <= 1e-12 * abs(float(te))
    assert all(float(getattr(g2, f)) == 0.0 for f in ("log_sig2", "log_ell", "log_noise2"))
    assert _rel(g2.theta1, tg.theta1) <= 1e-12


def test_hyper_adam_matches_optax():
    # five Adam steps at kernel_lr on the three log-hyperparameters, random
    # gradients: the update maths of optax.adam, <= 1e-12
    import optax

    rng = np.random.default_rng(10)
    start = {"log_sig2": 0.3, "log_ell": np.log(0.05), "log_noise2": np.log(1e-4)}
    opt = optax.adam(1e-3)
    jp = {k: jnp.asarray(v) for k, v in start.items()}
    jstate = opt.init(jp)
    st = HIPGPState(theta1=torch.zeros(3, dtype=torch.float64),
                    theta2=-torch.ones(3, dtype=torch.float64),
                    **{k: torch.tensor(v, dtype=torch.float64) for k, v in start.items()})
    adam = HyperAdam(1e-3)
    for _ in range(5):
        g = {k: rng.standard_normal() * 10 ** rng.uniform(-3, 1) for k in start}
        upd, jstate = opt.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        st = adam.step(st, st.replace(**{k: torch.tensor(v, dtype=torch.float64)
                                         for k, v in g.items()}))
    for k in start:
        assert abs(float(getattr(st, k)) - float(jp[k])) <= 1e-12 * abs(float(jp[k]))
    assert torch.equal(st.theta1, torch.zeros(3, dtype=torch.float64))


def test_fit_optimizer_and_zero_frozen():
    # the multi_transform: theta SGD always, Adam only when a hyper is
    # learned; the gradients of what is not learned are zeroed
    g = HIPGPState(theta1=torch.ones(2), theta2=torch.ones(2), log_sig2=torch.tensor(1.0),
                   log_ell=torch.tensor(2.0), log_noise2=torch.tensor(3.0))
    st = HIPGPState(theta1=torch.zeros(2), theta2=-torch.ones(2),
                    log_sig2=torch.tensor(0.0), log_ell=torch.tensor(0.0),
                    log_noise2=torch.tensor(0.0))
    assert make_optimizer(st, FitConfig()).hyper is None
    fixed = make_optimizer(st, FitConfig(lr=0.5)).step(st, g)
    assert torch.equal(fixed.theta1, -0.5 * torch.ones(2))
    assert float(fixed.log_sig2) == float(fixed.log_ell) == float(fixed.log_noise2) == 0.0
    cfg = FitConfig(learn_kernel=True)
    z = zero_frozen(cfg, g)
    assert (float(z.log_sig2), float(z.log_ell), float(z.log_noise2)) == (1.0, 2.0, 0.0)
    z = zero_frozen(FitConfig(learn_noise=True), g)
    assert (float(z.log_sig2), float(z.log_ell), float(z.log_noise2)) == (0.0, 0.0, 3.0)
    moved = make_optimizer(st, cfg).step(st, zero_frozen(cfg, g))
    # Adam's first step moves a learned entry by kernel_lr * sign(g)
    assert abs(float(moved.log_ell) + 1e-3) <= 1e-9 and float(moved.log_noise2) == 0.0
    # FitConfig's new fields are the JAX package's, with its defaults
    for f in ("learn_kernel", "learn_noise", "kernel_lr"):
        assert getattr(FitConfig(), f) == getattr(JFitConfig(), f)


def test_learn_kernel_and_noise_fit_matches_jax(data):
    # one epoch of svigp_fit with learn_kernel and learn_noise (M = 16^2,
    # N = 512, batch 128: four steps, natgrad + Adam at kernel_lr 1e-2 so
    # the hypers move visibly) after the theta2 warm start, from the same
    # state: hypers, theta and the ELBO trace within 1e-8 relative (float64
    # rounding of truncated solves; a constant natgrad lr, because optax
    # rounds a scheduled lr to float32)
    sig2 = run_synthetic.marginal_sig2(data["yobs"], data["sobs"])
    jm, tm, jstate, tstate = _pair(16, 512, sig2, learn=True)
    x, y, s = data["xobs"][:512], data["yobs"][:512], data["sobs"][:512]
    jcfg = JFitConfig(epochs=1, batch_size=128, maxiter_cg=10, schedule_lr=False,
                      learn_kernel=True, learn_noise=True, kernel_lr=1e-2)
    cfg = FitConfig(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(FitConfig)})
    jst, jrep = jsvigp_fit(jm, jstate, x, y, s, jcfg, verbose=False,
                           theta2_warmstart=True, natgrad_safe_lr="off")
    tst, trep = svigp_fit(tm, tstate, x, y, s, cfg, verbose=False,
                          theta2_warmstart=True, natgrad_safe_lr="off")
    assert trep["steps"] == len(jrep["elbo_trace"]) == 4
    np.testing.assert_allclose(trep["elbo_trace"], jrep["elbo_trace"], rtol=1e-8)
    for f in ("theta1", "theta2"):
        assert _rel(getattr(tst, f), getattr(jst, f)) <= 1e-8
    for f in ("log_sig2", "log_ell", "log_noise2"):
        got, want = float(getattr(tst, f)), float(getattr(jst, f))
        assert abs(got - want) <= 1e-8 * abs(want), (f, got, want)
        assert got != float(getattr(tstate, f))   # the hypers moved
    for k in ("sig2_trace", "ell_trace", "noise2_trace"):
        np.testing.assert_allclose(trep[k], jrep[k], rtol=1e-8)
