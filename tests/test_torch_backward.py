"""Parity of the port's backwards on the 1-D long axis and the 3-D dust map
with the JAX package: the radix apply's VJP (its d-cotangent through
`radix_fft.middle_wgrad`, the plain version of ``radix_middle_wgrad``), the
VJP of kernel B-5 (`mxu2d.sandwich_apply_wp`) and of the 3-D sandwich built
on it, the implicit gradients of `whiten` and `inv_matmul` through the 1-D
planes path and the 3-D kernel path, and `HIPGP.elbo_and_grads` with
``compute_hyper_grads`` on both.

Both sides get the same float64 inputs, made with numpy from a seed, on the
CPU.  The JAX side differentiates its custom VJPs (the Pallas kernels in
interpret mode) or, for the solves, its CPU route (the generic PCG over the
FFT or einsum applies), under `jax.jit` (one compile per case).  The port's card paths are opened on the CPU by
monkeypatching their gates, so the same autograd Functions that launch the
kernels on the card run with the plain versions.  Each tolerance is stated
where it is asserted.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # one intra-op thread a process: the xdist workers share the cores

from hipgp_tpu import kernels as jkernels
from hipgp_tpu.models import HIPGP as JHIPGP
from hipgp_tpu.ops import bttb as jbttb
from hipgp_tpu.ops import mxu2d as jmxu2d
from hipgp_tpu.ops import mxu3d as jmxu3d
from hipgp_tpu.ops import radix_fft as jrf
from hipgp_tpu.ops import solve as jsolve
from hipgp_tpu_torch import convert
from hipgp_tpu_torch import kernels as tkernels
from hipgp_tpu_torch.experiments import run_domain
from hipgp_tpu_torch.models import HIPGP
from hipgp_tpu_torch.ops import bttb as tbttb
from hipgp_tpu_torch.ops import mxu2d as tmxu2d
from hipgp_tpu_torch.ops import mxu3d as tmxu3d
from hipgp_tpu_torch.ops import radix_fft as trf
from hipgp_tpu_torch.ops import solve as tsolve

L1D = 8192          # the radix plan (A, B, C) = (8, 8, 128)


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _rel(got, want):
    got, want = _np(got), _np(want)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _t(a, grad=False):
    t = torch.as_tensor(np.array(a))
    return t.requires_grad_() if grad else t


def _even_spectrum(L, rng):
    d = 0.5 + rng.random(L)
    return 0.5 * (d + np.concatenate([d[:1], d[1:][::-1]]))


# ---------------------------------------------------------------------------
# the radix apply's VJP and B-4's weight cotangent
# ---------------------------------------------------------------------------

# (in_rows, out_rows) as fractions of A: the uncropped apply
# (tests/test_radix_fft.py:46), R^T's crop (:121), the PCG's crop at a
# boundary that is not a power of two, and R^T's pullback
CROPS = [("A", "A"), ("A/2", "A"), ("A/2+1", "A/2+1"), ("A", "A/2")]


@pytest.mark.parametrize("crop", CROPS, ids=["-".join(c) for c in CROPS])
def test_radix_apply_vjp_matches_jax(crop):
    # d/d(xr, xi, d_perm) of sum(yr * cr + yi * ci) through the port's
    # radix Function (gx: the apply with the crops swapped; gd: two stage-1
    # forwards and middle_wgrad) against jax.grad of the JAX custom VJP at
    # L = 8192, float64: <= 1e-10
    jp, tp = jrf.make_plan(L1D, jnp.float64), trf.make_plan(L1D, torch.float64)
    rows = {"A": tp.A, "A/2": tp.A // 2, "A/2+1": tp.A // 2 + 1}
    in_rows, out_rows = rows[crop[0]], rows[crop[1]]
    BC = trf.row_multiple(L1D)
    rng = np.random.default_rng(in_rows * 10 + out_rows)
    V = 3
    x = rng.standard_normal((2, V, in_rows * BC))
    c = rng.standard_normal((2, V, out_rows * BC))
    d = _even_spectrum(L1D, rng)

    def jloss(xr, xi, dp):
        yr, yi = jrf.fused_circulant_apply_cropped(xr, xi, dp, jp, in_rows, out_rows)
        return jnp.sum(yr * c[0] + yi * c[1])

    jg = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(
        jnp.asarray(x[0]), jnp.asarray(x[1]), jrf.permute_weights(jnp.asarray(d), jp))
    xr, xi = _t(x[0], True), _t(x[1], True)
    dp = trf.permute_weights(_t(d), tp).requires_grad_()
    yr, yi = trf.fused_circulant_apply_cropped(xr, xi, dp, tp, in_rows, out_rows)
    tg = torch.autograd.grad(torch.sum(yr * _t(c[0]) + yi * _t(c[1])), (xr, xi, dp))
    for got, want in zip(tg, jg):
        assert got.shape == want.shape
        assert _rel(got, want) <= 1e-10


@pytest.mark.parametrize("L,rows", [(8192, 5), (32768, 8)])
def test_middle_wgrad_plain_matches_jax_forward_stages(L, rows):
    # B-4's weight cotangent from two stage-1 outputs against the JAX
    # bwd's sum over v of fx * fg + fxi * fgi (`_forward_stages`), x at a
    # crop and g uncropped, float64: <= 1e-12
    jp, tp = jrf.make_plan(L, jnp.float64), trf.make_plan(L, torch.float64)
    A, B, C = tp.A, tp.B, tp.C
    rng = np.random.default_rng(L + rows)
    V = 3
    x = rng.standard_normal((2, V, rows * B * C))
    g = rng.standard_normal((2, V, L))
    fxr, fxi = jrf._forward_stages(jnp.asarray(x[0]), jnp.asarray(x[1]), jp,
                                   jax.lax.Precision.HIGHEST, rows)
    fgr, fgi = jrf._forward_stages(jnp.asarray(g[0]), jnp.asarray(g[1]), jp,
                                   jax.lax.Precision.HIGHEST)
    want = jnp.sum(fxr * fgr + fxi * fgi, axis=0)
    sx = trf.stage1(_t(x[0]).view(V, rows, B * C), _t(x[1]).view(V, rows, B * C), tp, A,
                    inverse=False)
    sg = trf.stage1(_t(g[0]).view(V, A, B * C), _t(g[1]).view(V, A, B * C), tp, A,
                    inverse=False)
    got = trf.middle_wgrad(*(s.view(V, A, B, C) for s in sx + sg), tp)
    assert got.shape == (A, B, C)
    assert _rel(got, want) <= 1e-12
    with pytest.raises(ValueError):
        trf.middle_wgrad(*(s.view(V, A, B, C) for s in sx), sg[0].view(V, A, B, C)[:1],
                         sg[1].view(V, A, B, C), tp)


@pytest.mark.parametrize("V,A,sms,want", [(128, 128, 132, 1), (4, 128, 132, 1),
                                          (1, 128, 132, 1), (16, 8, 132, 8),
                                          (128, 8, 132, 8), (3, 2048, 132, 1),
                                          (3, 8, 132, 3), (128, 16, 132, 4),
                                          (128, 64, 132, 1), (40, 32, 114, 1)])
def test_wgrad_splits_cover_the_card(V, A, sms, want):
    # the two-CTA clusters per ka of radix_middle_wgrad: the sms / 2
    # clusters of one wave shared among the A values of ka, at least one,
    # at most one per plane
    assert trf.wgrad_splits(V, A, sms) == want


# ---------------------------------------------------------------------------
# kernel B-5's VJP and the 3-D sandwich
# ---------------------------------------------------------------------------

WP_DIMS, WP_EDIMS, WP_W = (7, 9), (12, 16), 3


@pytest.mark.parametrize("mode", ["cropped", "out_expanded", "in_expanded"])
def test_wp_vjp_matches_jax(mode):
    # d/d(x, w) of sum(sandwich_apply_wp(x, w) * c) through B-5's Function
    # (gx: the sandwich with the crops swapped; gw: the per-plane analysis
    # product summed over b) against jax.grad of the JAX custom VJP (its
    # Pallas kernel in interpret mode), W = 3 planes of (7, 9) in (12, 16),
    # float64: <= 1e-10
    in_exp, out_exp = mode == "in_expanded", mode == "out_expanded"
    i_shape = WP_EDIMS if in_exp else WP_DIMS
    o_shape = WP_EDIMS if out_exp else WP_DIMS
    rng = np.random.default_rng(len(mode))
    x = rng.standard_normal((4, WP_W) + i_shape)
    c = rng.standard_normal((4, WP_W) + o_shape)
    w = rng.uniform(0.2, 2.0, (WP_W,) + WP_EDIMS)

    def jloss(x, w):
        y = jmxu2d.sandwich_apply_wp(x, w, WP_DIMS, WP_EDIMS, in_expanded=in_exp,
                                     out_expanded=out_exp, interpret=True)
        return jnp.sum(y * c)

    jg = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jnp.asarray(x), jnp.asarray(w))
    tx, tw = _t(x, True), _t(w, True)
    y = tmxu2d.sandwich_apply_wp(tx, tw, WP_DIMS, WP_EDIMS, in_expanded=in_exp,
                                 out_expanded=out_exp)
    tg = torch.autograd.grad(torch.sum(y * _t(c)), (tx, tw))
    for got, want in zip(tg, jg):
        assert got.shape == want.shape
        assert _rel(got, want) <= 1e-10


def _spec_pair(dims, ell=0.07):
    grids = [np.linspace(-1.0, 1.0, m) for m in dims]
    tk = lambda a, b: 0.5 * torch.exp(
        -0.5 * torch.sum(((a[:, None, :] - b[None, :, :]) / ell) ** 2, -1))
    jk = lambda a, b: 0.5 * jnp.exp(
        -0.5 * jnp.sum(((a[:, None, :] - b[None, :, :]) / ell) ** 2, -1))
    return (tbttb.make_spectrum([torch.as_tensor(g) for g in grids], tk, jitter=1e-3),
            jbttb.make_spectrum([jnp.asarray(g) for g in grids], jk, jitter=1e-3))


@pytest.mark.parametrize("out_expanded", [False, True])
def test_sandwich_3d_vjp_matches_jax(out_expanded):
    # d/d(x, w) of sum(sandwich_apply_3d(x, w) * c), cropped and with the
    # R^T's expanded output (tests/test_mxu3d.py:77, :106), on the (5, 6, 4)
    # grid's spectrum: autograd through the outer products and B-5's
    # Function against the JAX package's, float64: <= 1e-10
    ts, js = _spec_pair((5, 6, 4))
    dims, edims = ts.dims, ts.edims
    w = _np(tbttb._full_weights(ts.eigs, edims[-1]))
    if out_expanded:
        w = np.sqrt(w)
    rng = np.random.default_rng(int(out_expanded))
    x = rng.standard_normal((2,) + dims)
    c = rng.standard_normal((2,) + (edims if out_expanded else dims))

    def jloss(x, w):
        return jnp.sum(jmxu3d.sandwich_apply_3d(x, w, dims, edims, out_expanded=out_expanded,
                                                interpret=True) * c)

    jg = jax.jit(jax.grad(jloss, argnums=(0, 1)))(jnp.asarray(x), jnp.asarray(w))
    tx, tw = _t(x, True), _t(w, True)
    y = tmxu3d.sandwich_apply_3d(tx, tw, dims, edims, out_expanded=out_expanded)
    tg = torch.autograd.grad(torch.sum(y * _t(c)), (tx, tw))
    for got, want in zip(tg, jg):
        assert _rel(got, want) <= 1e-10


# ---------------------------------------------------------------------------
# the implicit gradients through the 1-D planes path and the 3-D kernel path
# ---------------------------------------------------------------------------

def _open_route(monkeypatch, route):
    """Open a card path's gates on the CPU: 'planes' runs the 1-D packed
    planes PCG and R^T and sends every 1-D apply through the radix Function;
    'mxu3d' runs the 3-D fused PCG and the R^T through B-5's Function."""
    if route == "planes":
        monkeypatch.setattr(tsolve, "_planes_solver_ok",
                            lambda spec, dtype, device: len(spec.dims) == 1)
        monkeypatch.setattr(tbttb, "_radix_apply_ok",
                            lambda spec, dtype, device: len(spec.dims) == 1
                            and trf.radix_supported(spec.edims[0]))
    else:
        monkeypatch.setattr(tsolve, "_mxu3d_solver_ok",
                            lambda spec, dtype, device: len(spec.dims) == 3)


# 1-D: 4000 points on [-1, 1] embed at L = 8192, 4 rows of the radix plan's
# 1024; 3-D: (16, 10, 12) embeds at (30, 18, 22), permuted to (10, 12, 16)
ROUTE_GRID = {"planes": ((4000,), 0.01), "mxu3d": ((16, 10, 12), 0.1)}


def _solve_grads(fn, dims, ell, sig2, b, c, jax_side, **kw):
    """(loss, d loss / d(log_sig2, log_ell, rhs)) of sum(fn(spec(theta),
    rhs) * c) with an SqExp spectrum, in JAX or in the port."""
    grids = [np.linspace(-1.0, 1.0, m) for m in dims]
    if jax_side:
        def loss(ls, le, rhs):
            p = (jnp.exp(ls), jnp.exp(le))
            spec = jbttb.make_spectrum([jnp.asarray(g) for g in grids],
                                       lambda x, y: jkernels.SqExp()(x, y, p), jitter=1e-3)
            return jnp.sum(getattr(jsolve, fn)(spec, rhs, **kw) * c)

        return jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2)))(
            jnp.log(sig2), jnp.log(ell), jnp.asarray(b))
    ls = torch.tensor(np.log(sig2), dtype=torch.float64, requires_grad=True)
    le = torch.tensor(np.log(ell), dtype=torch.float64, requires_grad=True)
    rhs = _t(b, True)
    p = (torch.exp(ls), torch.exp(le))
    spec = tbttb.make_spectrum([_t(g) for g in grids],
                               lambda x, y: tkernels.SqExp()(x, y, p), jitter=1e-3)
    assert float(spec.eigs.detach().min()) > 10 * tbttb.DEFAULT_EIG_FLOOR  # none clamped
    loss = torch.sum(getattr(tsolve, fn)(spec, rhs, **kw) * _t(c))
    return loss, torch.autograd.grad(loss, (ls, le, rhs))


@pytest.mark.parametrize("route", ["planes", "mxu3d"])
@pytest.mark.parametrize("fn", ["whiten", "inv_matmul"])
@pytest.mark.parametrize("solve", ["converged", "fixed10"])
def test_solve_gradients_on_the_kernel_routes_match_jax(monkeypatch, route, fn, solve):
    # d/d(rhs, log_sig2, log_ell) of sum(fn(spec(theta), rhs) * c) with the
    # card path's gates open (its PCG, its R^T through the radix or B-5
    # Function, the dK term through the radix Function on the 1-D route)
    # against JAX's CPU route.  Converged (maxiter 200, tol 1e-10): the
    # implicit gradient is the true one, <= 1e-6.  At 10 fixed iterations
    # both differentiate the same truncated solve: float64 rounding, <= 1e-8
    dims, ell = ROUTE_GRID[route]
    sig2 = 0.7
    rng = np.random.default_rng(len(route) + len(fn))
    M = int(np.prod(dims))
    Mout = int(np.prod(tbttb.embedded_dims(dims))) if fn == "whiten" else M
    b = rng.standard_normal((5, M))
    c = rng.standard_normal((5, Mout))
    kw = (dict(maxiter=200, tol=1e-10) if solve == "converged"
          else dict(maxiter=10, tol=0.0, fixed_iters=True))
    tol = 1e-6 if solve == "converged" else 1e-8
    jl, jg = _solve_grads(fn, dims, ell, sig2, b, c, True, **kw)
    _open_route(monkeypatch, route)
    launches = dict(trf.LAUNCHES)
    tsolve.PCG_STATS.update(solves=0, iterations=0)
    tl, tg = _solve_grads(fn, dims, ell, sig2, b, c, False, **kw)
    # the forward and the backward solve both ran the fused PCG; the CPU
    # launches nothing
    assert tsolve.PCG_STATS["solves"] == 2 and trf.LAUNCHES == launches
    assert abs(float(tl.detach()) - float(jl)) <= tol * abs(float(jl))
    for got, want in zip(tg, jg):
        assert _rel(got, want) <= tol


def test_solver_internal_applies_raise_with_a_gradient():
    # the fused self-dot applies of the PCG (kernel A's, kernel B-6's and the
    # radix self-dot apply) have no backward, as in JAX: a required gradient
    # raises and names the differentiable entry points; without one they run
    ts, _ = _spec_pair((6, 5))
    w = tbttb._full_weights(ts.eigs, ts.edims[-1])
    x = _t(np.ones((2,) + ts.dims), True)
    with pytest.raises(NotImplementedError, match="solver-internal.*inv_matmul / whiten"):
        tmxu2d.sandwich_apply_selfdot(x, w, ts.dims, ts.edims)
    with torch.no_grad():
        assert tmxu2d.sandwich_apply_selfdot(x, w, ts.dims, ts.edims)[0].shape == x.shape
    dims, edims = (8, 16, 16), (16, 32, 32)
    w3 = torch.ones(edims, dtype=torch.float64, requires_grad=True)
    x3 = _t(np.ones((1,) + dims))
    with pytest.raises(NotImplementedError, match="kernel B-6.*solver-internal"):
        tmxu3d.sandwich_apply_wp3(x3, w3, dims, edims, selfdot=True)
    tp = trf.make_plan(L1D, torch.float64)
    xr = _t(np.ones((1, 4 * trf.row_multiple(L1D))), True)
    dp = torch.ones((tp.A, tp.B, tp.C), dtype=torch.float64)
    with pytest.raises(NotImplementedError, match="self-dot radix apply"):
        trf.fused_circulant_apply_cropped_selfdot(xr, xr, dp, tp, 4, 4)


# ---------------------------------------------------------------------------
# the model: elbo_and_grads with compute_hyper_grads on both routes
# ---------------------------------------------------------------------------

def _model_pair(route):
    """The same mean-field model in both packages, float64, with a state
    away from the prior, and one minibatch: a 1-D grid of 4000 points on
    [0, 1] (SqExp, ell 0.01) with 96 noisy point observations of a sine, or
    the dust map's integrated model on a 16 x 16 x 8 grid (SqExp, ell 0.1)
    with 96 line-integral observations."""
    rng = np.random.default_rng(5)
    if route == "planes":
        grids = [np.linspace(0.0, 1.0, 4000)]
        x = rng.uniform(0.0, 1.0, (96, 1))
        y = np.sin(12.0 * x[:, 0]) + 0.1 * rng.standard_normal(96)
        common = dict(num_obs=96, sig2_init=0.8, ell_init=0.01, noise2_init=0.01,
                      init_Svar=1.0, jitter=1e-3)
    else:
        xa, a, _, _, _ = run_domain.make_synthetic_domain_data(96, 0.1)
        lo, hi = xa.min(axis=0), xa.max(axis=0)
        grids = [np.linspace(lo[k], hi[k], n) for k, n in enumerate((16, 16, 8))]
        x, y = xa, a
        sig2 = run_domain.empirical_sig2_init(x, y)
        common = dict(num_obs=96, sig2_init=sig2, ell_init=0.1, noise2_init=0.01,
                      init_Svar=1.0, jitter=1e-3, support_integrated_obs=True)
    jm = JHIPGP(jkernels.SqExp(), [jnp.asarray(g) for g in grids], dtype=jnp.float64,
                **common)
    tm = HIPGP(tkernels.SqExp(), grids, dtype=torch.float64, device="cpu", **common)
    jstate = jm.init_state(jax.random.PRNGKey(3))
    jstate = jstate.replace(theta1=jstate.theta1 * 40.0, theta2=jstate.theta2 * 2.0)
    tstate = convert.state_from_numpy(
        {k: np.asarray(getattr(jstate, k)) for k in convert.STATE_FIELDS}, device="cpu")
    return jm, tm, jstate, tstate, x, y


@pytest.mark.parametrize("route", ["planes", "mxu3d"])
def test_elbo_and_hyper_grads_on_the_kernel_routes_match_jax(monkeypatch, route):
    # one minibatch of 96 rows with the learned noise, 10 PCG iterations in
    # both, compute_hyper_grads=True: the ELBO, the natural gradient and
    # -d elbo / d(log_sig2, log_ell, log_noise2) with the card path's gates
    # open against JAX's CPU route, float64 rounding of the same truncated
    # solves: <= 1e-8
    jm, tm, jstate, tstate, x, y = _model_pair(route)
    kw = dict(maxiter_cg=10, integrated_obs=route == "mxu3d")
    je, jg = jax.jit(lambda st, x, y: jm.elbo_and_grads(st, x, y, None,
                                                        compute_hyper_grads=True, **kw))(
        jstate, jnp.asarray(x), jnp.asarray(y))
    _open_route(monkeypatch, route)
    tsolve.PCG_STATS.update(solves=0, iterations=0)
    te, tg = tm.elbo_and_grads(tstate, _t(x), _t(y), None, compute_hyper_grads=True, **kw)
    assert tsolve.PCG_STATS["solves"] == 2 and tsolve.PCG_STATS["iterations"] <= 20
    assert abs(float(te) - float(je)) <= 1e-8 * abs(float(je))
    for f in ("theta1", "theta2"):
        assert _rel(getattr(tg, f), getattr(jg, f)) <= 1e-8
    for f in ("log_sig2", "log_ell", "log_noise2"):
        got, want = float(getattr(tg, f)), float(getattr(jg, f))
        assert want != 0.0 and abs(got - want) <= 1e-8 * abs(want), (f, got, want)
