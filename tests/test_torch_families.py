"""Parity of the port's block-diagonal and full-rank families and the
'standard' parameterization with the JAX package: the block index tables
and ``batch_solve``.

``utils/blocks.py`` against the JAX package's (the raise too), the
'standard' natgrad ``ValueError``, NaN from a non-positive-definite block
(XLA's semantics), and ``batch_solve`` with every mean solver the JAX
package runs for each family in both parameterizations (the full-rank
family's routing of 'cg', 'gram' and 'matfree' through the 'dense'
accumulation, and the 3-D block 'matfree' on line integrals), against the
JAX package on the same float64 inputs (numpy from a seed), the states
carried across with ``convert.state_from_numpy``.  Everything runs on the
CPU, where the whitening takes its plain path; 12^2 grids (embedded 24^2,
blocks of 4 x 4), 200 observations in batches of 16 (the last one padded and
masked).  The family methods, the fit, the experiment scripts and the signatures are
`tests/test_torch_families_fit.py`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # one intra-op thread a process: the xdist workers share the cores

from hipgp_tpu import kernels as jkernels
from hipgp_tpu.models import HIPGP as JHIPGP
from hipgp_tpu.ops import spd_inverse as jspd_inverse
from hipgp_tpu.utils import blocks as jblocks
from hipgp_tpu_torch import convert
from hipgp_tpu_torch import kernels as tkernels
from hipgp_tpu_torch.experiments import run_domain
from hipgp_tpu_torch.models import HIPGP
from hipgp_tpu_torch.ops import spd_inverse
from hipgp_tpu_torch.utils import blocks

N = 200
GRIDS = [np.linspace(-1, 1, 12)] * 2
FAMILIES = ["block", "full-rank"]
PARAMS = ["expectation-family", "standard"]
SOLVERS = ["dense", "cg", "gram", "factored", "matfree"]


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


# ---------------------------------------------------------------------------
# utils/blocks.py
# ---------------------------------------------------------------------------

BLOCK_SHAPES = {"2d": ((24, 24), (4, 4)), "3d": ((24, 24, 10), (2, 2, 2)),
                "1d": ((6,), (3,)), "uneven": ((4, 6), (2, 3))}


@pytest.mark.parametrize("case", list(BLOCK_SHAPES) + ["indivisible"])
def test_block_indices_match_jax(case):
    if case == "indivisible":
        # a chunk that does not divide its dimension raises in both packages
        for mod in (blocks, jblocks):
            with pytest.raises(ValueError, match="not divisible"):
                mod.block_indices((24, 24), (5, 4))
            with pytest.raises(ValueError, match="not divisible"):
                mod.interleaved_block_indices((24, 10), 4)
        return
    dims, chunks = BLOCK_SHAPES[case]
    idx, inv = blocks.block_indices(dims, chunks)
    jidx, jinv = jblocks.block_indices(dims, chunks)
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_array_equal(inv, jinv)
    v = np.random.default_rng(0).standard_normal((3, int(np.prod(dims))))
    vb = blocks.to_blocks(torch.as_tensor(v), torch.as_tensor(idx))
    np.testing.assert_array_equal(_np(vb), np.asarray(jblocks.to_blocks(
        jnp.asarray(v), jnp.asarray(jidx))))
    np.testing.assert_array_equal(_np(blocks.from_blocks(vb, torch.as_tensor(inv))), v)
    np.testing.assert_array_equal(blocks.interleaved_block_indices(dims, 2),
                                  jblocks.interleaved_block_indices(dims, 2))


# ---------------------------------------------------------------------------
# the family-shaped methods
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family", ["mean-field", "block", "full-rank"])
def test_standard_natgrad_raises(pairs, data, family):
    # the natural-gradient step needs the expectation family, in both packages
    x, y, s, _ = data
    kw = _kw(family, "standard", "cholesky")
    jm = JHIPGP(jkernels.SqExp(), [jnp.asarray(g) for g in GRIDS], dtype=jnp.float64, **kw)
    tm = HIPGP(tkernels.SqExp(), GRIDS, dtype=torch.float64, device="cpu", **kw)
    with pytest.raises(ValueError, match="expectation-family"):
        jm.elbo_and_grads(jm.init_state(), jnp.asarray(x), jnp.asarray(y), jnp.asarray(s))
    with pytest.raises(ValueError, match="expectation-family"):
        tm.elbo_and_grads(tm.init_state(), x, y, s)


def test_non_pd_block_gives_nan(pairs):
    # a transiently indefinite -2 theta2 block: NaN in that block's S (and in
    # the block KL), the other blocks exact, as XLA's Cholesky; no exception
    rng = np.random.default_rng(7)
    A = _spd(rng, 3, 5, 5)
    A[1] = A[1] - 3.0 * np.eye(5)
    got, want = _np(spd_inverse(torch.as_tensor(A))), np.asarray(jspd_inverse(jnp.asarray(A)))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[1]).all() and not np.isnan(got[[0, 2]]).any()
    np.testing.assert_allclose(got[[0, 2]], want[[0, 2]], rtol=1e-12)
    _, tm, _, _ = pairs("block")
    d = _random_state(tm, "expectation-family")
    d["theta2"][4] = 2.0 * np.eye(tm.block_size)
    qm, qS = tm.standard_params(convert.state_from_numpy(d, device="cpu"))
    assert torch.isnan(qS[4]).all() and not torch.isnan(qS[torch.arange(36) != 4]).any()
    assert torch.isnan(tm.kl_to_prior(qm, qS))


# ---------------------------------------------------------------------------
# batch_solve
# ---------------------------------------------------------------------------

# the full-rank family solves no mean: 'cg', 'gram' and 'matfree' run the
# generic accumulation of 'dense' in both packages (JAX batch_solve's
# routing), which test_full_rank_solvers_share_the_accumulation pins
BATCH_CASES = [(f, p, "ziggy", sol) for p in PARAMS
               for f, sols in (("block", SOLVERS), ("full-rank", ("dense", "factored")))
               for sol in sols]
# the cholesky whitening's own branches: 'factored''s triangular g-stage,
# the dense (K + A) mean and the full-rank L^{-T} qm of its ELBO
BATCH_CASES += [(f, p, "cholesky", "factored") for f in FAMILIES for p in PARAMS]


@pytest.mark.parametrize("family,param,wt,solver", BATCH_CASES)
def test_batch_solve_matches_jax(pairs, data, family, param, wt, solver):
    # heteroscedastic noise, 13 batches of 16 (the last padded with 8 masked
    # rows), maxiter_cg 10 (truncated whitening in both), the mean solvers at
    # their defaults: theta2 and the ELBO to 1e-8; theta1 behind the block
    # family's unconverged mean PCG ('cg', 'gram', 'factored', 'matfree') to
    # 1e-5, as test_torch_fullbatch holds the mean-field 'cg' and 'gram',
    # else 1e-8
    jm, tm, js, ts = pairs(family, param, wt)
    x, y, s, _ = data
    kw = dict(batch_size=16, maxiter_cg=10, compute_elbo=True, mean_solver=solver)
    if solver == "factored":
        kw["factor_jitter"] = 1e-12
    jst, je = jm.batch_solve(js, jnp.asarray(x), jnp.asarray(y), jnp.asarray(s), **kw)
    tst, te = tm.batch_solve(ts, x, y, s, **kw)
    assert tst.theta2.shape == jst.theta2.shape
    t2 = 1e-8 if solver == "factored" else 1e-12
    assert _rel(tst.theta2, jst.theta2) <= t2
    pcg_mean = family == "block" and solver != "dense"
    assert _rel(tst.theta1, jst.theta1) <= (1e-5 if pcg_mean else 1e-8)
    assert float(te) == pytest.approx(float(je), rel=1e-8)


@pytest.mark.parametrize("param", PARAMS)
def test_full_rank_solvers_share_the_accumulation(pairs, data, param):
    # 'cg', 'gram' and 'matfree' of the full-rank family are its 'dense'
    # accumulation (theta1 = b, or m = S b), bit for bit, as JAX routes them
    _, tm, _, ts = pairs("full-rank", param)
    x, y, s, _ = data
    kw = dict(batch_size=16, maxiter_cg=10, compute_elbo=True)
    dst, de = tm.batch_solve(ts, x, y, s, mean_solver="dense", **kw)
    for solver in ("cg", "gram", "matfree"):
        timings = {}
        st, e = tm.batch_solve(ts, x, y, s, mean_solver=solver, timings=timings, **kw)
        assert torch.equal(st.theta1, dst.theta1) and torch.equal(st.theta2, dst.theta2)
        assert float(e) == float(de) and set(timings) == {"sweep", "mean", "elbo"}


def test_block_matfree_3d_integrated_matches_jax():
    # the dust map's block family at 10 x 10 x 4 (embedded (18, 18, 6),
    # blocks 2 x 2 x 2: 243 of 8): 80 line integrals in 2 batches of 40,
    # the analytic semi-integrated estimator, 'matfree' against JAX with its
    # mean PCG converged (unconverged, the iterate follows the rounding)
    x, a, _, sobs, _ = run_domain.make_synthetic_domain_data(80, 0.1, seed=2)
    lo, hi = x.min(0), x.max(0)
    grids = [np.linspace(lo[0], hi[0], 10), np.linspace(lo[1], hi[1], 10),
             np.linspace(lo[2], hi[2], 4)]
    kw = dict(num_obs=len(x), family="block", block_sizes=(2, 2, 2), ell_init=0.3,
              noise2_init=1.0, init_Svar=1.0, support_integrated_obs=True)
    jm = JHIPGP(jkernels.SqExp(), [jnp.asarray(g) for g in grids], dtype=jnp.float64, **kw)
    tm = HIPGP(tkernels.SqExp(), grids, dtype=torch.float64, device="cpu", **kw)
    assert (tm.num_blocks, tm.block_size) == (243, 8)
    js = jm.init_state()
    skw = dict(batch_size=40, maxiter_cg=10, integrated_obs=True, compute_elbo=True,
               mean_solver="matfree", mean_solver_maxiter=800, mean_solver_tol=1e-11)
    jst, je = jm.batch_solve(js, jnp.asarray(x), jnp.asarray(a), jnp.asarray(sobs), **skw)
    tst, te = tm.batch_solve(_to_torch(js), x, a, sobs, **skw)
    assert _rel(tst.theta2, jst.theta2) <= 1e-12
    assert _rel(tst.theta1, jst.theta1) <= 1e-8
    assert float(te) == pytest.approx(float(je), rel=1e-8)
