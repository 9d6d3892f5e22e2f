"""Parity of the port's model-parallel closed form with the JAX package.

One world of four gloo ranks on the CPU (`hipgp_tpu_torch.parallel.launch`)
runs every case of this file once, in float64, on ('dp', 'grid') meshes of
shape (2, 2) and (1, 4) (`torch_parallel_ranks.mp_cases`, which imports
neither JAX nor the JAX package); each test holds one case against the JAX
package, mirroring tests/test_mp.py and the model-parallel half of
tests/test_multihost.py: ``mp_batch_solve`` with 'cg', 'gram' and
'factored' (mean-field and block, 2-D and 1-D, analytic line integrals,
the float32 fallbacks to 'gram', the split spectrum against the whole one)
and ``mp_predict`` against the JAX package's single-device ``batch_solve``
and ``predict`` on the same ``grid_shards``-padded model, one case also
against JAX's own ``mp_batch_solve`` on a (2, 2) mesh of its CPU devices;
the harness's ``eval_only_state`` under 'mp' against its single-process
run, and a mismatched file; ``ell_fit(parallel='mp')``; the blocks of
``process_slice`` /
``global_batch`` over the mesh's 'dp' axis; the raises.  Tolerances are
tests/test_mp.py's or tighter, each stated where it is used.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
torch.set_num_threads(1)  # one intra-op thread a process: the xdist workers share the cores

import torch_parallel_ranks as ranks
from hipgp_tpu.utils import checkpoint as jckpt
from hipgp_tpu.infer import ell_fit as jell_fit
from hipgp_tpu.kernels import SqExp as JSqExp
from hipgp_tpu.models import HIPGP as JHIPGP
from hipgp_tpu.ops.bttb import embedded_dims
from hipgp_tpu.parallel import mp_batch_solve as jmp_batch_solve
from hipgp_tpu.parallel import mp_shard_state as jmp_shard_state
from hipgp_tpu.parallel.fft_sharded import shard_multiples
from hipgp_tpu_torch.parallel import launch

RANKS = 4
CG = dict(batch_size=100, maxiter_cg=50, mean_solver_maxiter=300, mean_solver_tol=1e-12)
# 'gram': the (K + A) PCG at 400 iterations on both sides (tests/test_mp.py
# runs 2000 and takes theta1 to 2e-4 / 1e-3 all the same; the split PCG
# costs ~6 gloo collectives an iteration); 'factored': 2000, converged, as
# tests/test_mp.py, for its limits of 1e-5 / 1e-6 on theta1
GRAM = dict(batch_size=100, maxiter_cg=50, mean_solver="gram", mean_solver_maxiter=400,
            mean_solver_tol=1e-12)
FACTORED = dict(batch_size=100, maxiter_cg=50, mean_solver="factored",
                mean_solver_maxiter=2000, mean_solver_tol=1e-12, factor_jitter=1e-12)


def _e0(ng, m=11):
    return embedded_dims((m, m), shard_multiples((m, m), ng))[0]


def _integrated_data():
    rng = np.random.default_rng(3)
    N = 150
    return (rng.uniform(0.1, 0.95, (N, 2)), rng.standard_normal(N), rng.uniform(0.1, 0.2, N))


def _f32_data():
    rng = np.random.default_rng(3)
    N = 256
    return (rng.uniform(0.05, 0.95, (N, 2)).astype(np.float32),
            rng.standard_normal(N).astype(np.float32), np.full((N,), 0.1, np.float32))


def _case(model, mesh, data, kw, **extra):
    x, y, s = data
    return dict(model=model, mesh=mesh, x=x, y=y, s=s, kw=kw, **extra)


def _solve_cases():
    d300, d400, d200 = ranks.mp_data(), ranks.mp_data(N=400), ranks.mp_data(N=200, dim=1)
    xq = ranks.mp_data(N=123, seed=5)[0]
    di, d32 = _integrated_data(), _f32_data()
    kw = ranks.mp_model_kw
    one_d = dict(m=40, dim=1, ell=0.08)
    f32 = kw(256, 2, m=17, ell=2.5 / 16, f32=True)
    # 'gram' mean at 50 iterations: the fallback and 'gram' run the same ones
    f32_kw = dict(batch_size=128, maxiter_cg=30, mean_solver_maxiter=50)
    return {
        "cg-2x2": _case(kw(300, 2), (2, 2), d300, dict(CG, compute_elbo=True), xq=xq,
                        predict=dict(batch_size=64, maxiter_cg=50)),
        "cg-2x2-sharded": _case(kw(300, 2), (2, 2), d300,
                                dict(CG, compute_elbo=True, spectrum_mode="sharded"), xq=xq,
                                predict=dict(batch_size=64, maxiter_cg=50,
                                             spectrum_mode="sharded")),
        "cg-1x4": _case(kw(300, 4), (1, 4), d300, dict(CG, compute_elbo=True)),
        "1d-cg": _case(kw(200, 2, **one_d), (2, 2), d200,
                       dict(CG, batch_size=64, maxiter_cg=60)),
        "integrated": _case(kw(150, 2, m=9, ell=0.2, integrated=True), (2, 2), di,
                            dict(CG, batch_size=50, integrated_obs=True), xq=di[0][:40],
                            predict=dict(maxiter_cg=50, integrated_obs=True)),
        "block-cg-2x2": _case(kw(300, 2, family="block", block_sizes=(_e0(2) // 2, 4)),
                              (2, 2), d300, dict(CG, compute_elbo=True), xq=xq,
                              predict=dict(batch_size=64, maxiter_cg=50)),
        "block-cg-1x4": _case(kw(300, 4, family="block", block_sizes=(_e0(4) // 4, 4)),
                              (1, 4), d300, dict(CG, compute_elbo=True)),
        "block-1d": _case(kw(200, 2, family="block", block_sizes=(4,), **one_d), (2, 2),
                          d200, dict(CG, batch_size=64, maxiter_cg=60)),
        "gram-mean-field": _case(kw(300, 2), (2, 2), d300, dict(GRAM, compute_elbo=True)),
        "gram-block": _case(kw(300, 2, family="block", block_sizes=(5, 4)), (2, 2), d300,
                            dict(GRAM, compute_elbo=True)),
        "gram-1d": _case(kw(200, 2, **one_d), (2, 2), d200,
                         dict(GRAM, batch_size=64, maxiter_cg=60, mean_solver_maxiter=300)),
        "gram-integrated": _case(kw(150, 2, m=9, ell=0.2, integrated=True), (2, 2), di,
                                 dict(GRAM, batch_size=50, integrated_obs=True,
                                      mean_solver_maxiter=300)),
        "factored-2x2": _case(kw(400, 2), (2, 2), d400, dict(FACTORED, compute_elbo=True)),
        # all of A's factor rows on one 'dp' position, whitened as one chunk as
        # in the single-device solve: the PCG's early exits group the same rows
        "factored-block": _case(kw(400, 4, family="block", block_sizes=(_e0(4) // 4, 4)),
                                (1, 4), d400, dict(FACTORED, compute_elbo=True)),
        # float32 at ell 2.5 grid spacings (JAX's test_mp_factored_guard_falls_back
        # at 17 points a side: edims 32, kappa 3.9e4, and with the pre-check
        # lifted and JAX's float32 jitter the factor rows' PCG breaks the
        # trace guard, as at JAX's 33)
        "f32-factored": _case(f32, (2, 2), d32, dict(f32_kw, mean_solver="factored")),
        "f32-gram": _case(f32, (2, 2), d32, dict(f32_kw, mean_solver="gram")),
        "f32-factored-sharded": _case(f32, (2, 2), d32, dict(f32_kw, mean_solver="factored",
                                                             spectrum_mode="sharded")),
        "f32-gram-sharded": _case(f32, (2, 2), d32, dict(f32_kw, mean_solver="gram",
                                                         spectrum_mode="sharded")),
        # the pre-check lifted and JAX's float32 jitter: the trace guard fires
        "f32-factored-guard": _case(f32, (2, 2), d32,
                                    dict(f32_kw, mean_solver="factored", factor_jitter=1e-4),
                                    kappa_max=float("inf")),
    }


def _eval_only_case(outdir):
    """The harness's evaluation of a saved state under 'mp': a whole state
    of the padded 11 x 11 model, away from the prior, saved by the JAX
    package, and a file of a 9 x 9 model's state, saved by the port, which
    must not load."""
    from hipgp_tpu_torch import convert
    from hipgp_tpu_torch.utils import checkpoint as tckpt

    model = ranks.mp_model_kw(300, 2)
    js = _jmodel(model).init_state(jax.random.PRNGKey(4))
    path = os.path.join(outdir, "eval-state.npz")
    jckpt.save_pytree(path, js.replace(theta1=js.theta1 * 30.0, theta2=js.theta2 * 2.0))
    bad = os.path.join(outdir, "eval-state-9.npz")
    tckpt.save_pytree(bad, ranks.mp_model(ranks.mp_model_kw(300, 2, m=9)).init_state())
    x, y, s = ranks.mp_data()
    xq = ranks.mp_data(N=64, seed=5)[0]
    return dict(model=model, mesh=(2, 2), x=x, y=y, s=s, xq=xq,
                fq=np.sin(3 * xq[:, 0]) * np.cos(2 * xq[:, 1]), path=path, bad_path=bad)


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    outdir = str(tmp_path_factory.mktemp("mp"))
    x, y, s = ranks.mp_data(N=40)
    d300 = ranks.mp_data()
    n = 241
    rng = np.random.default_rng(0)
    xm = rng.uniform(-1, 1, (n, 2))
    ym = np.sin(3 * xm[:, 0]) * np.cos(2 * xm[:, 1])
    inputs = {
        "solves": _solve_cases(),
        "raises": {
            # nb = 100 splits four ways, but rows_per = 5 is not a multiple of 2
            "misaligned": dict(model=ranks.mp_model_kw(40, 4, family="block",
                                                       block_sizes=(2, 2)),
                               mesh=(1, 4), x=x, y=y, s=s),
            "full-rank": dict(model=ranks.mp_model_kw(40, 2, family="full-rank", m=6),
                              mesh=(2, 2), x=x, y=y, s=s),
        },
        # up to two grid spacings: at ell 0.3 (three) the spectrum is clamped
        # (kappa 5e7) and 50 iterations of any two whitening PCGs whose sums
        # run in different orders differ by ~1e-1 (tests/test_mp.py sweeps to
        # 0.3 and takes 2e-2 on the curve there)
        "ell_fit": dict(model=ranks.mp_model_kw(300, 2), mesh=(2, 2),
                        x=d300[0], y=d300[1], s=d300[2],
                        kw=dict(ell_min=0.1, ell_max=0.2, ell_step_size=0.05,
                                batch_solve_bsz=100, maxiter_cg=50, verbose=False,
                                mean_solver="gram")),
        "multihost": dict(model=ranks.mp_model_kw(n, 2, m=9, ell=0.3, lo=-1.0), mesh=(2, 2),
                          x=xm, y=ym, s=np.full(n, 0.1),
                          kw=dict(CG, batch_size=64, compute_elbo=True, mean_solver="cg")),
        "eval_only": _eval_only_case(outdir),
    }
    return inputs, launch.run(ranks.mp_cases, RANKS, args=(inputs, outdir), device="cpu",
                              timeout_s=600)


def _jmodel(p):
    kw = {} if p["block_sizes"] is None else {"block_sizes": p["block_sizes"]}
    dt = jnp.float32 if p["f32"] else jnp.float64
    grids = [jnp.linspace(p["lo"], 1.0, p["m"], dtype=dt)] * p["dim"]
    return JHIPGP(JSqExp(), grids, num_obs=p["N"], family=p["family"], ell_init=p["ell"],
                  noise2_init=0.01, grid_shards=p["ng"],
                  support_integrated_obs=p["integrated"], dtype=dt, **kw)


def _jdata(c):
    dt = jnp.float32 if c["model"]["f32"] else jnp.float64
    return tuple(jnp.asarray(c[k], dt) for k in ("x", "y", "s"))


_JSOLVES = {}


def _jsolve(c):
    """The JAX single-device batch_solve of a case: (model, state, elbo),
    computed once a case."""
    if id(c) not in _JSOLVES:
        jm = _jmodel(c["model"])
        kw = {k: v for k, v in c["kw"].items() if k not in ("spectrum_mode",)}
        kw.setdefault("mean_solver", "cg")
        out = jm.batch_solve(jm.init_state(), *_jdata(c), **kw)
        _JSOLVES[id(c)] = (jm,) + (out if kw.get("compute_elbo") else (out, None))
    return _JSOLVES[id(c)]


def _same_on_every_rank(out, key):
    for r in out[1:]:
        for k, v in out[0][key].items():
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(r[key][k], v, err_msg=f"{key} {k}")


# tests/test_mp.py's: theta1 comes out of a ~1e4-conditioned truncated CG
# mean solve, which the split reduction order moves at ~1e-5 relative
CG_TOL = dict(theta1=dict(rtol=2e-4, atol=1e-6), theta2=dict(rtol=1e-7, atol=1e-9),
              elbo=1e-6)


# tests/test_mp.py's for the block family: the off-diagonal block entries
# pass near zero, and the truncated whitening's early exits (the rows a
# micro-batch groups differ) enter Lambda at ~1e-8 absolute
BLOCK_TOL = dict(theta1=dict(rtol=2e-4, atol=1e-5), theta2=dict(rtol=1e-6, atol=1e-6),
                 elbo=1e-6)


def _assert_state(got, want, tol, elbo=None, want_elbo=None):
    np.testing.assert_allclose(got["theta1"], np.asarray(want.theta1), **tol["theta1"])
    np.testing.assert_allclose(got["theta2"], np.asarray(want.theta2), **tol["theta2"])
    if want_elbo is not None:
        np.testing.assert_allclose(got["elbo"], float(want_elbo), rtol=tol["elbo"])


@pytest.mark.parametrize("key", ["cg-2x2", "cg-1x4", "block-cg-2x2", "block-cg-1x4"])
def test_mp_batch_solve_matches_jax(cluster, key):
    inputs, out = cluster
    c = inputs["solves"][key]
    _same_on_every_rank(out, f"solves/{key}")
    got = out[0][f"solves/{key}"]
    jm, want, want_elbo = _jsolve(c)
    assert got["theta2"].shape == np.asarray(want.theta2).shape
    tol = BLOCK_TOL if key.startswith("block") else CG_TOL
    _assert_state(got, want, tol, got["elbo"], want_elbo)


def test_mp_batch_solve_matches_jax_mp_batch_solve(cluster):
    # JAX's own model-parallel solve on a (2, 2) mesh of its CPU devices
    from jax.sharding import Mesh

    inputs, out = cluster
    c = inputs["solves"]["cg-2x2"]
    jm = _jmodel(c["model"])
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("dp", "grid"))
    want, want_elbo = jmp_batch_solve(jm, jmp_shard_state(jm.init_state(), mesh), *_jdata(c),
                                      mesh, **c["kw"])
    _assert_state(out[0]["solves/cg-2x2"], want, CG_TOL, None, want_elbo)


@pytest.mark.parametrize("key", ["cg-2x2", "block-cg-2x2", "integrated"])
def test_mp_predict_matches_jax(cluster, key):
    inputs, out = cluster
    c = inputs["solves"][key]
    got = out[0][f"solves/{key}"]
    _same_on_every_rank(out, f"solves/{key}")
    jm, want, _ = _jsolve(c)
    flags = {k: v for k, v in c["predict"].items() if k != "batch_size"}
    mu, sig = jm.predict(want, jnp.asarray(c["xq"]), **flags)
    # tests/test_mp.py: rtol 1e-6, atol 1e-9, and atol 1e-7 on the near-zero
    # means of the integrated rows
    np.testing.assert_allclose(got["mu"], np.asarray(mu), rtol=1e-6,
                               atol=1e-7 if key == "integrated" else 1e-9)
    np.testing.assert_allclose(got["sig"], np.asarray(sig), rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("key", ["1d-cg", "block-1d", "integrated"])
def test_mp_1d_and_integrated_match_jax(cluster, key):
    # the 1-D grid through the four-step split FFT (its rank blocks are runs
    # of the flat index), and analytic semi-integrated cross-covariances
    inputs, out = cluster
    c = inputs["solves"][key]
    jm, want, _ = _jsolve(c)
    _assert_state(out[0][f"solves/{key}"], want,
                  BLOCK_TOL if key.startswith("block") else CG_TOL)


@pytest.mark.parametrize("key", ["gram-mean-field", "gram-block", "gram-1d", "gram-integrated"])
def test_mp_gram_matches_jax(cluster, key):
    # the Woodbury mean with A summed over 'dp' and K applied grid-split, no
    # kn stack; the port sums A, b_m and the ELBO scalars in float64 (here
    # the model's dtype as well)
    inputs, out = cluster
    c = inputs["solves"][key]
    jm, want, want_elbo = _jsolve(c)
    got = out[0][f"solves/{key}"]
    # tests/test_mp.py's gram limits: theta1 2e-4 / 1e-3, theta2 1e-6 / 1e-6,
    # the ELBO 1e-6; here theta2 1e-7 / 1e-8 and the ELBO 1e-7
    np.testing.assert_allclose(got["theta1"], np.asarray(want.theta1), rtol=2e-4, atol=1e-3)
    np.testing.assert_allclose(got["theta2"], np.asarray(want.theta2), rtol=1e-7, atol=1e-8)
    if want_elbo is not None:
        np.testing.assert_allclose(got["elbo"], float(want_elbo), rtol=1e-7)


@pytest.mark.parametrize("key", ["factored-2x2", "factored-block"])
def test_mp_factored_matches_jax(cluster, key):
    # A's Cholesky factor's rows split over 'dp', each chunk whitened
    # grid-split, Lambda summed over 'dp'; converged mean (tests/test_mp.py:
    # theta1 1e-5, theta2 1e-7, ELBO 1e-6)
    inputs, out = cluster
    c = inputs["solves"][key]
    assert out[0][f"solves/{key}"]["warned"] == []
    jm, want, want_elbo = _jsolve(c)
    got = out[0][f"solves/{key}"]
    np.testing.assert_allclose(got["theta1"], np.asarray(want.theta1), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(got["theta2"], np.asarray(want.theta2), rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(got["elbo"], float(want_elbo), rtol=1e-7)


@pytest.mark.parametrize("mode", ["host", "sharded"])
def test_mp_factored_float32_falls_back_to_gram(cluster, mode):
    # the float32 pre-check on the spectrum's dynamic range, by the whole
    # spectrum ('host') or the blocks' extrema ('sharded'), declines with
    # JAX's RuntimeWarning and runs 'gram': the same state as 'gram' itself
    _, out = cluster
    sfx = "" if mode == "host" else "-sharded"
    f, g = out[0][f"solves/f32-factored{sfx}"], out[0][f"solves/f32-gram{sfx}"]
    assert len(f["warned"]) == 1 and "falling back" in f["warned"][0]
    assert "declined" in f["warned"][0]
    assert g["warned"] == []
    np.testing.assert_array_equal(f["theta1"], g["theta1"])
    np.testing.assert_array_equal(f["theta2"], g["theta2"])


def test_mp_factored_exactness_guard_falls_back_to_gram(cluster):
    # the pre-check lifted and JAX's float32 jitter 1e-4: tr(K^-1 A) exceeds
    # 1.2 sum ivar Knn, decided from all-reduced values on every rank, the
    # warning, and 'gram''s state on every rank
    _, out = cluster
    for r in out:
        f = r["solves/f32-factored-guard"]
        assert len(f["warned"]) == 1 and "exactness check" in f["warned"][0]
        np.testing.assert_array_equal(f["theta2"], r["solves/f32-gram"]["theta2"])
        np.testing.assert_array_equal(f["theta1"], r["solves/f32-gram"]["theta1"])


def test_mp_sharded_spectrum_matches_host(cluster):
    # tests/test_mp.py's limits: theta1 5e-6 (the two spectra differ at the
    # last float64 bit, which the truncated solves amplify), theta2 1e-7,
    # the ELBO 1e-7, predictions 1e-6
    _, out = cluster
    h, s = out[0]["solves/cg-2x2"], out[0]["solves/cg-2x2-sharded"]
    np.testing.assert_allclose(s["theta1"], h["theta1"], rtol=5e-6, atol=1e-6)
    np.testing.assert_allclose(s["theta2"], h["theta2"], rtol=1e-7)
    np.testing.assert_allclose(s["elbo"], h["elbo"], rtol=1e-7)
    np.testing.assert_allclose(s["mu"], h["mu"], rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(s["sig"], h["sig"], rtol=1e-6)


@pytest.mark.parametrize("key,match", [("misaligned", "per-shard row count"),
                                       ("full-rank", "mean-field")])
def test_mp_raises(cluster, key, match):
    # JAX's messages (tests/test_mp.py matches the same words), on every rank
    _, out = cluster
    for r in out:
        assert r[f"raises/{key}"] is not None and match in r[f"raises/{key}"]


def test_ell_fit_mp_matches_jax(cluster):
    # the grid-split sweep picks JAX's single-device argmax, and the curve
    # agrees to 1e-5 (the mean PCG at its default 200 iterations)
    inputs, out = cluster
    c = inputs["ell_fit"]
    jm = _jmodel(c["model"])
    _, jell, jells, jelbos = jell_fit(jm, jm.init_state(), *_jdata(c), **c["kw"])
    ell, ells, elbos, theta2 = out[0]["ell_fit"]
    assert ells == pytest.approx(jells, rel=1e-15)
    assert ell == jell
    np.testing.assert_allclose(elbos, jelbos, rtol=1e-5)
    for r in out[1:]:
        assert r["ell_fit"][2] == elbos
    assert theta2.shape == (jm.Mprime,)


def test_multihost_blocks_mp_batch_solve_matches_jax(cluster):
    # tests/test_multihost.py's model-parallel case: each 'dp' position
    # loads its own rows (process_slice over the mesh's 'dp' axis, the
    # grid ranks of a position the same rows), pads them to the common
    # block, and the solve matches the single-process one
    inputs, out = cluster
    c = inputs["multihost"]
    n = c["model"]["N"]
    per = -(-n // 2)
    for r in out:
        mh = r["multihost"]
        dp = r["rank"] // 2
        assert mh["slice"] == (dp * per, min((dp + 1) * per, n))
        assert mh["n_global"] == 2 * per and mh["local_rows"] == per
        assert mh["pad_rows"] == (2 * per - n if dp == 1 else 0)
    jm = _jmodel(c["model"])
    want, want_elbo = jm.batch_solve(jm.init_state(), *_jdata(c), **c["kw"])
    got = out[0]["multihost"]
    np.testing.assert_allclose(got["theta1"], np.asarray(want.theta1), rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(got["theta2"], np.asarray(want.theta2), rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(got["elbo"], float(want_elbo), rtol=1e-6)


def test_harness_mp_eval_only_matches_single_process(cluster, tmp_path):
    # fit_predict_and_save(parallel='mp', eval_only_state=) on a (2, 2)
    # mesh: each rank cuts its block of the JAX-saved whole state, predicts
    # through mp_predict and returns the whole state, bit for bit the file's;
    # the single-process harness on the same padded model predicts the same
    # within 1e-6; only the coordinator writes
    from hipgp_tpu_torch import convert
    from hipgp_tpu_torch.experiments import harness

    inputs, out = cluster
    c = inputs["eval_only"]
    p = c["model"]
    _, _, rep = harness.fit_predict_and_save(
        name="mp", xobs=c["x"], yobs=c["y"], sobs=c["s"],
        xinduce_grids=[np.linspace(p["lo"], 1.0, p["m"])] * p["dim"], ell_init=p["ell"],
        noise2_init=0.01, sig2_init="marginal", fit_method="natgrad", xtest=c["xq"],
        ftest=c["fq"], grid_shards=p["ng"], dtype=torch.float64, device="cpu",
        output_dir=str(tmp_path), eval_only_state=c["path"])
    saved = np.load(c["path"])
    for r in out:
        got = r["eval_only"]
        for i, k in enumerate(convert.STATE_FIELDS):
            np.testing.assert_array_equal(got[k], saved[f"arr_{i}"], err_msg=k)
        np.testing.assert_allclose(got["fmu"], rep["pdict"]["fmu_test"], rtol=1e-6, atol=1e-12)
        np.testing.assert_allclose(got["fsig"], rep["pdict"]["fsig_test"], rtol=1e-6)
    assert [r["eval_only"]["wrote"] for r in out] == [True] + [False] * (RANKS - 1)


def test_harness_mp_eval_only_rejects_a_mismatched_file(cluster):
    # a 9 x 9 model's state for the padded 11 x 11 model raises on every
    # rank, naming the file and both shapes, before anything is evaluated
    inputs, out = cluster
    c = inputs["eval_only"]
    for r in out:
        msg = r["eval_only_bad"]
        assert msg is not None and c["bad_path"] in msg
        assert "theta1" in msg and "(256,)" in msg and "(400,)" in msg, msg
