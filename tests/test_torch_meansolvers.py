"""Parity of the port's 'factored' and 'matfree' mean solvers with the JAX package.

``HIPGP.batch_solve(mean_solver='factored')`` (Lambda and the ELBO from the
Cholesky factor of the data Gram A, M whitening solves; the kappa pre-check,
the trace and bracket guards, the warned fallback to 'gram', the relative
jitter and its escalation) and ``mean_solver='matfree'`` (the data-Gram
matvec re-swept every PCG iteration, stopping on the relative residual),
against the JAX package on the same float64 inputs (numpy from a seed) and
the same JAX ``init_state`` carried across with ``convert.state_from_numpy``;
the setup is the JAX package's `tests/test_factored_solve.py` (400 points,
a 9^2 grid, SqExp at ell 0.12).  Everything runs on the CPU, where the
whitening takes its plain path; the kernel paths' structure is checked by
opening their CUDA gates with monkeypatch.  Then the float32 guards, the
float32 factored-vs-'gram' comparison inside the trust region and the two
drivers.
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # one intra-op thread a process: the xdist workers share the cores

from hipgp_tpu import kernels as jkernels
from hipgp_tpu.models import HIPGP as JHIPGP
from hipgp_tpu_torch import convert
from hipgp_tpu_torch import kernels as tkernels
from hipgp_tpu_torch.experiments import run_domain, run_synthetic
from hipgp_tpu_torch.models import HIPGP
from hipgp_tpu_torch.models import hipgp as thipgp
from hipgp_tpu_torch.models.hipgp import FACTORED_STATS, MEAN_PCG_STATS
from hipgp_tpu_torch.ops import solve as tsolve

N = 400
GRIDS = [np.linspace(0.0, 1.0, 9)] * 2
FACTORED = dict(mean_solver="factored", mean_solver_maxiter=400, factor_jitter=1e-12)
CONVERGED = dict(mean_solver_maxiter=800, mean_solver_tol=1e-14)


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _rel(got, want):
    got, want = _np(got), _np(want)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    x = rng.uniform(0.05, 0.95, (N, 2))
    return x, rng.standard_normal(N), rng.uniform(0.1, 0.3, N)


def _build(wt="ziggy", integrated=False):
    kw = dict(num_obs=N, whitened_type=wt, ell_init=0.2 if integrated else 0.12,
              noise2_init=0.04, support_integrated_obs=integrated)
    jm = JHIPGP(jkernels.SqExp(), [jnp.asarray(g) for g in GRIDS], dtype=jnp.float64, **kw)
    tm = HIPGP(tkernels.SqExp(), GRIDS, dtype=torch.float64, device="cpu", **kw)
    js = jm.init_state()
    ts = convert.state_from_numpy(
        {k: np.asarray(getattr(js, k)) for k in convert.STATE_FIELDS}, device="cpu")
    return jm, tm, js, ts


@pytest.fixture(scope="module")
def pairs():
    # one model pair per configuration for the module: the JAX stage
    # functions are memoized on the model, so their compiles are paid once
    return {"ziggy": _build(), "cholesky": _build("cholesky"),
            "integrated": _build(integrated=True)}


def _both(pair, data, noise=True, **kw):
    jm, tm, js, ts = pair
    x, y, s = data
    ns = s if noise else None
    jst, je = jm.batch_solve(js, jnp.asarray(x), jnp.asarray(y),
                             None if ns is None else jnp.asarray(ns), compute_elbo=True,
                             **kw)
    tst, te = tm.batch_solve(ts, x, y, ns, compute_elbo=True, **kw)
    return (jst, float(je)), (tst, float(te))


def _assert_close(got, want, theta2, theta1, elbo):
    # theta2 entrywise; theta1 in norm (its entries near zero carry the mean
    # PCG's rounding)
    (gst, ge), (wst, we) = got, want
    np.testing.assert_allclose(_np(gst.theta2), _np(wst.theta2), rtol=theta2)
    assert _rel(gst.theta1, wst.theta1) <= theta1
    assert ge == pytest.approx(we, rel=elbo)


# ---------------------------------------------------------------------------
# 'factored' against the JAX package
# ---------------------------------------------------------------------------

FACTORED_CASES = {
    # (pair, noise_std given, batch_size, extra keywords)
    "ziggy": ("ziggy", True, 128, {}),
    "cholesky": ("cholesky", True, 128, {}),
    "homoscedastic": ("ziggy", False, 128, {}),
    # the line integrals' data Gram is singular to rounding (kappa ~ 1e304):
    # at factor_jitter 1e-12 LAPACK's and XLA's factors of the same A differ
    # by 5e-7 (forward error), and the whitening truncated at 10 iterations
    # is not linear in its right-hand side, so Lambda follows the factor; at
    # 1e-6 the shifted A is conditioned well enough to compare the rest
    "integrated": ("integrated", True, 128, {"integrated_obs": True,
                                             "factor_jitter": 1e-6}),
    "uneven-batches": ("ziggy", True, 96, {}),
    "default-jitter": ("ziggy", True, 128, {"factor_jitter": None}),
}


@pytest.mark.parametrize("case", list(FACTORED_CASES))
def test_factored_matches_jax(pairs, data, case):
    # the same algorithm on the same float64 inputs: the stats sweep, A's
    # factor at the same jitter, the factor's whitening at maxiter_cg 10
    # (truncated in both), the mean PCG at 400 iterations; state and ELBO
    # to 1e-8 relative
    name, noise, bsz, extra = FACTORED_CASES[case]
    kw = {**FACTORED, **extra}
    j, t = _both(pairs[name], data, noise, batch_size=bsz, maxiter_cg=10, **kw)
    _assert_close(t, j, theta2=1e-8, theta1=1e-8, elbo=1e-8)
    assert np.isfinite(FACTORED_STATS["bracket"])
    assert FACTORED_STATS["trKinvA"] <= 1.2 * FACTORED_STATS["sKnn"]
    if extra.get("factor_jitter", 1e-12) is None:   # the float64 default, 1e-10
        assert FACTORED_STATS["jitter"] == pytest.approx(
            1e-10 * float(np.mean(np.diag(_np(_gram_A(pairs[name], data))))), rel=1e-12)


def _gram_A(pair, data):
    _, tm, _, ts = pair
    x, y, s = data
    as_t = lambda a: torch.as_tensor(a, dtype=torch.float64)
    batches = thipgp.prepare_batches(as_t(x), as_t(y), as_t(s), 128)
    xb, yb, sb, w = batches
    flags = dict(integrated_obs=False, semi_integrated_estimator="analytic",
                 semi_integrated_samps=10, generator=None)
    return tm._gram_sweep(ts, tm.spectrum(ts), (xb, yb, w, sb), flags, 0, kn=False)[1]


@pytest.mark.parametrize("whitened", ["ziggy", "cholesky"])
def test_factored_matches_dense_converged(pairs, data, whitened):
    # the port's counterpart of the JAX test_factored_matches_dense_all_
    # families (mean-field): converged whitening, the same family optimum and
    # ELBO as the reference-semantics 'dense' solve
    _, tm, _, ts = pairs[whitened]
    x, y, s = data
    kw = dict(batch_size=128, maxiter_cg=200, compute_elbo=True)
    dense = tm.batch_solve(ts, x, y, s, mean_solver="dense", **kw)
    fact = tm.batch_solve(ts, x, y, s, **FACTORED, **kw)
    rtol = 1e-8 if whitened == "cholesky" else 1e-6
    for name in ("theta1", "theta2"):
        a, b = _np(getattr(dense[0], name)), _np(getattr(fact[0], name))
        assert np.max(np.abs(a - b)) / np.max(np.abs(a)) < rtol
    assert abs(float(dense[1]) - float(fact[1])) < rtol * max(1.0, abs(float(dense[1])))


# ---------------------------------------------------------------------------
# the guards, the fallback and the jitter
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def f32_clamped():
    # the JAX test_factored_inconsistency_fallback_f32 setup: float32, SqExp
    # at ell = 2.5 grid spacings on a 32^2 grid, a heavily clamped spectrum
    rng = np.random.default_rng(3)
    n = 1024
    x = rng.uniform(0.05, 0.95, (n, 2)).astype(np.float32)
    y = rng.standard_normal(n).astype(np.float32)
    s = np.full((n,), 0.1, np.float32)
    m = HIPGP(tkernels.SqExp(), [np.linspace(0.0, 1.0, 32)] * 2, num_obs=n,
              ell_init=0.08, noise2_init=0.01, dtype=torch.float32, device="cpu")
    st = m.init_state()
    kw = dict(batch_size=512, maxiter_cg=30, compute_elbo=True)
    gram = m.batch_solve(st, x, y, s, mean_solver="gram", **kw)
    return m, st, (x, y, s), kw, gram


@pytest.mark.parametrize("guard", ["kappa", "trace"])
def test_factored_f32_guard_falls_back_to_gram(f32_clamped, monkeypatch, guard):
    # the pre-check fires first (kappa > 1e3); with the trust region lifted
    # (as an accuracy study lifts it) the trace guard catches the broken
    # factor-column solves instead.  Either way: a RuntimeWarning, and the
    # state and ELBO of 'gram' run on the same inputs; the failed attempt's
    # stages are kept under 'factored_<stage>'.  The factor at the JAX
    # package's float32 jitter, 1e-4 mean(diag A), as in the JAX test: at the
    # port's default for its float64 factor (1e-10) the trace here stays
    # under the guard (1.02e5 against sum ivar Knn 1.024e5) and the raw
    # factored theta2 is within 7e-3 of 'gram''s
    m, st, (x, y, s), kw, (g_st, g_e) = f32_clamped
    kw = dict(kw, factor_jitter=1e-4)
    if guard == "trace":
        monkeypatch.setattr(thipgp, "FACTORED_F32_KAPPA_MAX", float("inf"))
    timings = {}
    with pytest.warns(RuntimeWarning, match="exactness check"):
        f_st, f_e = m.batch_solve(st, x, y, s, mean_solver="factored", timings=timings,
                                  **kw)
    assert FACTORED_STATS["kappa"] > thipgp.FACTORED_F32_KAPPA_MAX or guard == "trace"
    if guard == "kappa":
        assert set(timings) == {"sweep", "mean", "elbo"}
        assert np.isnan(FACTORED_STATS["trKinvA"])
    else:
        assert FACTORED_STATS["trKinvA"] > 1.2 * FACTORED_STATS["sKnn"]
        assert set(timings) == {"factored_sweep", "factored_factor", "factored_g",
                                "sweep", "mean", "elbo"}
    np.testing.assert_allclose(_np(f_st.theta2), _np(g_st.theta2), rtol=1e-6)
    np.testing.assert_allclose(_np(f_st.theta1), _np(g_st.theta1), rtol=1e-5, atol=1e-7)
    assert float(f_e) == pytest.approx(float(g_e), rel=1e-6)
    # without the guards the raw factored output comes back, and it is not
    # 'gram''s
    if guard == "trace":
        monkeypatch.setattr(thipgp, "FACTORED_GUARDS", False)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            raw, _ = m.batch_solve(st, x, y, s, mean_solver="factored", **kw)
        assert _rel(raw.theta2, g_st.theta2) > 1e-2


def test_factored_jitter_escalates(pairs, data, monkeypatch):
    # a factorisation that fails twice: the jitter is raised x100 twice, and
    # the solve equals one asked for that jitter outright
    _, tm, _, ts = pairs["ziggy"]
    x, y, s = data
    kw = dict(batch_size=128, maxiter_cg=10, compute_elbo=True, mean_solver="factored")
    chol, calls = torch.linalg.cholesky_ex, []

    def failing(a, **k):
        calls.append(1)
        L, info = chol(a, **k)
        return (L, torch.ones_like(info)) if len(calls) <= 2 else (L, info)

    monkeypatch.setattr(torch.linalg, "cholesky_ex", failing)
    st, e = tm.batch_solve(ts, x, y, s, factor_jitter=1e-12, **kw)
    eps = FACTORED_STATS["jitter"]
    monkeypatch.setattr(torch.linalg, "cholesky_ex", chol)
    want, we = tm.batch_solve(ts, x, y, s, factor_jitter=1e-8, **kw)
    assert len(calls) == 3
    assert eps == pytest.approx(FACTORED_STATS["jitter"], rel=1e-12)
    np.testing.assert_allclose(_np(st.theta2), _np(want.theta2), rtol=1e-10)
    assert float(e) == pytest.approx(float(we), rel=1e-10)


def test_factored_jitter_exhausted_raises(pairs, data):
    # a jitter that keeps A + eps I indefinite at every rung: four escalations,
    # then FloatingPointError, in both packages
    jm, tm, js, ts = pairs["ziggy"]
    x, y, s = data
    kw = dict(batch_size=128, maxiter_cg=10, mean_solver="factored", factor_jitter=-10.0)
    with pytest.raises(FloatingPointError, match="stayed non-finite up to jitter"):
        tm.batch_solve(ts, x, y, s, **kw)
    with pytest.raises(FloatingPointError, match="stayed non-finite up to jitter"):
        jm.batch_solve(js, jnp.asarray(x), jnp.asarray(y), jnp.asarray(s), **kw)


# ---------------------------------------------------------------------------
# 'matfree'
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("noise", [True, False])
def test_matfree_matches_jax(pairs, data, noise):
    # the JAX drivers' mean settings (200 iterations, tol 1e-8 on the
    # relative residual): the same host-driven PCG, the same state and ELBO
    j, t = _both(pairs["ziggy"], data, noise, batch_size=128, maxiter_cg=10,
                 mean_solver="matfree")
    _assert_close(t, j, theta2=1e-9, theta1=1e-6, elbo=1e-8)
    st = MEAN_PCG_STATS
    assert 0 < st["iterations"] <= 200
    assert st["iterations"] == 200 or st["resnorm"] <= 1e-8 * st["bnorm"]


def test_matfree_matches_gram_converged(pairs, data):
    # the JAX test_batch_solve_matfree_matches_gram: at converged mean
    # tolerance 'matfree' is 'gram', in both packages
    jm, tm, js, ts = pairs["ziggy"]
    x, y, s = data
    kw = dict(batch_size=16, maxiter_cg=300, compute_elbo=True, **CONVERGED)
    j, t = _both(pairs["ziggy"], data, batch_size=16, maxiter_cg=300,
                 mean_solver="matfree", **CONVERGED)
    st = dict(MEAN_PCG_STATS)
    gram = tm.batch_solve(ts, x, y, s, mean_solver="gram", **kw)
    gram = (gram[0], float(gram[1]))
    _assert_close(t, gram, theta2=1e-9, theta1=1e-4, elbo=1e-6)
    _assert_close(t, j, theta2=1e-9, theta1=1e-4, elbo=1e-6)
    assert st["iterations"] < 800 and st["resnorm"] <= 1e-14 * st["bnorm"]


def test_matfree_stops_on_the_relative_residual(pairs, data):
    # ||r|| <= tol ||b_m|| (not ||r|| <= tol, as 'gram''s and 'factored''s
    # mean PCG): the iteration it stops at is the first that meets it
    _, tm, _, ts = pairs["ziggy"]
    x, y, s = data
    kw = dict(batch_size=128, maxiter_cg=10, mean_solver="matfree", mean_solver_tol=1e-3)
    tm.batch_solve(ts, x, y, s, **kw)
    st = dict(MEAN_PCG_STATS)
    assert st["resnorm"] <= 1e-3 * st["bnorm"] and st["bnorm"] > 1.0
    tm.batch_solve(ts, x, y, s, mean_solver_maxiter=st["iterations"] - 1, **kw)
    assert MEAN_PCG_STATS["resnorm"] > 1e-3 * st["bnorm"]


def test_matfree_replays_the_monte_carlo_draws(pairs, data):
    # the Monte-Carlo estimator: every re-sweep of the A matvec rebuilds Knm
    # from the draws of the first sweep, so at converged mean tolerance
    # 'matfree' is 'gram' from the same generator, which ends in the same
    # state
    _, tm, _, ts = pairs["integrated"]
    x, y, s = data
    kw = dict(batch_size=128, maxiter_cg=100, compute_elbo=True, integrated_obs=True,
              semi_integrated_estimator="mc-biased", semi_integrated_samps=7, **CONVERGED)
    out = {}
    for solver in ("gram", "matfree"):
        gen = torch.Generator().manual_seed(5)
        st, e = tm.batch_solve(ts, x, y, s, mean_solver=solver, generator=gen, **kw)
        out[solver] = ((st, float(e)), gen.get_state())
    _assert_close(out["matfree"][0], out["gram"][0], theta2=1e-9, theta1=1e-4, elbo=1e-6)
    assert torch.equal(out["matfree"][1], out["gram"][1])


def test_matfree_requires_ziggy(pairs, data):
    jm, tm, js, ts = pairs["cholesky"]
    x, y, s = data
    with pytest.raises(ValueError, match="matfree"):
        tm.batch_solve(ts, x, y, s, batch_size=16, mean_solver="matfree")
    with pytest.raises(ValueError, match="matfree"):
        jm.batch_solve(js, jnp.asarray(x), jnp.asarray(y), jnp.asarray(s), batch_size=16,
                       mean_solver="matfree")


def test_matfree_allocates_no_m_by_m_tensor(pairs, data):
    # every tensor an op creates during the solve, recorded by a dispatch
    # mode: 'gram' makes its M x M data Gram, 'matfree' nothing M x M
    from torch.utils._python_dispatch import TorchDispatchMode

    class Shapes(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(t, torch.Tensor):
                    self.seen.add(tuple(t.shape))
            return out

    _, tm, _, ts = pairs["ziggy"]
    x, y, s = data
    M = tm.M
    for solver in ("gram", "matfree"):
        with Shapes() as rec:
            tm.batch_solve(ts, x, y, s, batch_size=64, maxiter_cg=5, mean_solver=solver,
                           mean_solver_maxiter=5, compute_elbo=True)
        square = [sh for sh in rec.seen if len(sh) >= 2 and sh[-2:] == (M, M)]
        assert bool(square) == (solver == "gram"), (solver, square)


# ---------------------------------------------------------------------------
# the kernel paths' structure, their CUDA gates opened on the CPU
# ---------------------------------------------------------------------------

def test_factored_through_the_kernel_a_structure(pairs, data, monkeypatch):
    # kernel A's gate opened: the factor's rows are whitened by the fused
    # self-dot PCG and R^T through kernel A's Functions (plain versions), in
    # chunks of 32 rows (81 = 3 chunks, the last padded with 15 zero rows);
    # the sweep whitens nothing.  The same state and ELBO as the generic
    # route in one chunk
    _, tm, _, ts = pairs["ziggy"]
    x, y, s = data
    kw = dict(batch_size=128, maxiter_cg=10, compute_elbo=True, **FACTORED)
    generic, e_generic = tm.batch_solve(ts, x, y, s, **kw)
    monkeypatch.setattr(tsolve, "_mxu2d_solver_ok",
                        lambda spec, dtype, device: len(spec.dims) == 2)
    monkeypatch.setattr(thipgp, "FACTOR_CHUNK", 32)
    tsolve.PCG_STATS.update(solves=0, iterations=0)
    fused, e_fused = tm.batch_solve(ts, x, y, s, **kw)
    assert tsolve.PCG_STATS["solves"] == 3
    assert 0 < tsolve.PCG_STATS["iterations"] <= 30
    np.testing.assert_allclose(_np(fused.theta2), _np(generic.theta2), rtol=1e-9)
    assert _rel(fused.theta1, generic.theta1) <= 1e-8
    assert float(e_fused) == pytest.approx(float(e_generic), rel=1e-9)


def test_matfree_through_the_kernel_a_structure(pairs, data, monkeypatch):
    # the sweep's four batches through kernel A's Functions: four whitening
    # solves; the mean PCG and its A re-sweeps launch nothing
    _, tm, _, ts = pairs["ziggy"]
    x, y, s = data
    kw = dict(batch_size=128, maxiter_cg=10, compute_elbo=True, mean_solver="matfree")
    generic, e_generic = tm.batch_solve(ts, x, y, s, **kw)
    monkeypatch.setattr(tsolve, "_mxu2d_solver_ok",
                        lambda spec, dtype, device: len(spec.dims) == 2)
    tsolve.PCG_STATS.update(solves=0, iterations=0)
    fused, e_fused = tm.batch_solve(ts, x, y, s, **kw)
    assert tsolve.PCG_STATS["solves"] == 4
    np.testing.assert_allclose(_np(fused.theta2), _np(generic.theta2), rtol=1e-9)
    assert _rel(fused.theta1, generic.theta1) <= 1e-6
    assert float(e_fused) == pytest.approx(float(e_generic), rel=1e-9)


def test_matfree_through_the_3d_kernel_structure(monkeypatch):
    # the dust map's structure at 8 x 8 x 4: line-integral rows, the 3-D
    # solver's gate opened (the outer products and B-5 / B-6 Functions in
    # their plain versions), 3 batches of 40 -> 3 whitening solves; against
    # the JAX 'matfree' on the same state
    x, a, _, sobs, _ = run_domain.make_synthetic_domain_data(120, 0.1, seed=2)
    lo, hi = x.min(0), x.max(0)
    grids = [np.linspace(lo[0], hi[0], 8), np.linspace(lo[1], hi[1], 8),
             np.linspace(lo[2], hi[2], 4)]
    kw = dict(num_obs=len(x), ell_init=0.3, noise2_init=1.0, init_Svar=1.0,
              support_integrated_obs=True)
    jm = JHIPGP(jkernels.SqExp(), [jnp.asarray(g) for g in grids], dtype=jnp.float64, **kw)
    tm = HIPGP(tkernels.SqExp(), grids, dtype=torch.float64, device="cpu", **kw)
    js = jm.init_state()
    ts = convert.state_from_numpy(
        {k: np.asarray(getattr(js, k)) for k in convert.STATE_FIELDS}, device="cpu")
    skw = dict(batch_size=40, maxiter_cg=10, integrated_obs=True, compute_elbo=True,
               mean_solver="matfree")
    jst, je = jm.batch_solve(js, jnp.asarray(x), jnp.asarray(a), jnp.asarray(sobs), **skw)
    monkeypatch.setattr(tsolve, "_mxu3d_solver_ok",
                        lambda spec, dtype, device: len(spec.dims) == 3)
    tsolve.PCG_STATS.update(solves=0, iterations=0)
    tst, te = tm.batch_solve(ts, x, a, sobs, **skw)
    assert tsolve.PCG_STATS["solves"] == 3
    _assert_close((tst, float(te)), (jst, float(je)), theta2=1e-9, theta1=1e-6, elbo=1e-8)


# ---------------------------------------------------------------------------
# float32 inside the trust region, and the drivers
# ---------------------------------------------------------------------------

def test_factored_f32_matches_gram_inside_the_trust_region():
    # [full-batch-factored]'s comparison at a small size: the 2-D protocol's
    # data (1 000 rows), SqExp at ell 0.05 on a 16^2 grid, float32 (kappa well
    # under 1e3: no fallback), both whitenings converged (maxiter_cg 200) and
    # both mean PCGs converged: theta2 max-relative and the ELBO within 1e-2
    from hipgp_tpu_torch.experiments.synthetic_data import make_two_dim_data

    d = make_two_dim_data(Nobs=1000, Ntest=10, noise_std=0.01, gridnum=8, seed=42)
    m = run_synthetic.build_model("SqExp", 16, 1000, run_synthetic.marginal_sig2(
        d["yobs"], d["sobs"]), 0.05, 0.01, dtype=torch.float32, device="cpu")
    st = m.init_state()
    kw = dict(batch_size=-1, maxiter_cg=200, mean_solver_maxiter=4000,
              mean_solver_tol=1e-10, compute_elbo=True)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        f_st, f_e = m.batch_solve(st, d["xobs"], d["yobs"], d["sobs"],
                                  mean_solver="factored", **kw)
    assert FACTORED_STATS["kappa"] <= thipgp.FACTORED_F32_KAPPA_MAX
    g_st, g_e = m.batch_solve(st, d["xobs"], d["yobs"], d["sobs"], mean_solver="gram", **kw)
    t2 = float(torch.max(torch.abs(f_st.theta2 - g_st.theta2)) / torch.max(torch.abs(g_st.theta2)))
    assert t2 <= 1e-2
    assert abs(float(f_e) - float(g_e)) <= 1e-2 * abs(float(g_e))


def test_run_domain_factored_on_cpu(tmp_path):
    # the section 5.5 driver with the factored closed form on a grid whose A
    # fits: the stage seconds and the mean PCG come back, the state goes to
    # state.npz; --eval-only-state restores it and predicts the same
    argv = ["--device", "cpu", "--nobs", "300", "--ntest", "40", "--nx", "6", "--nz", "4"]
    out = run_domain.main(argv + ["--mean-solver", "factored", "--output-dir", str(tmp_path)])
    assert out["fit_method"] == "full-batch" and np.isfinite(out["last_elbo"])
    assert out["e_post_rmse"] < out["e_rms"]
    assert {"fit_sweep_s", "fit_factor_s", "fit_g_s", "fit_mean_s", "fit_elbo_s"} <= set(out)
    assert out["mean_pcg_iterations"] > 0 and np.isfinite(out["mean_pcg_relres"])
    again = run_domain.main(argv + ["--eval-only-state", str(tmp_path / "state.npz"),
                                    "--output-dir", str(tmp_path / "eval")])
    assert again["fit_method"] == "eval-only"
    assert again["e_post_rmse"] == pytest.approx(out["e_post_rmse"], rel=1e-12)
    assert again["latent_corr"] == pytest.approx(out["latent_corr"], rel=1e-12)


def test_run_synthetic_full_batch_factored_on_cpu(tmp_path):
    # the 2-D driver's factored closed form in float32 (kappa under 1e3 on a
    # 12^2 grid: no fallback) predicts as its 'gram' does: the same Woodbury
    # mean; the ELBOs differ only where the whitening's truncation enters
    argv = ["--device", "cpu", "--nobs", "400", "--ntest", "80", "--num-inducing", "12",
            "--gridnum", "8", "--fit-method", "full-batch"]
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        out = run_synthetic.main(argv + ["--mean-solver", "factored",
                                         "--output-dir", str(tmp_path / "f")])
    gram = run_synthetic.main(argv + ["--mean-solver", "gram",
                                      "--output-dir", str(tmp_path / "g")])
    assert out["fit_method"] == "full-batch" and np.isfinite(out["last_elbo"])
    assert out["test_rmse"] == pytest.approx(gram["test_rmse"], rel=1e-4)
    assert out["last_elbo"] == pytest.approx(gram["last_elbo"], rel=1e-3)
